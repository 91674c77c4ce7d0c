"""``levenshtein_roofline``: the Levenshtein kernels' share of their
roofline over the traced jobs, in percent: the least time the card could
take for the work those jobs need (the larger of the operations over
the INT32 rate and the bytes over the HBM rate, counted from the cell's
own pairs by the yardstick) over the device time of every kernel whose
name holds ``levenshtein``."""

from linkbench import yardstick


def read(run):
    if run.trace is None or not run.work:
        return None
    device = sum(s for name, s in run.trace.device_seconds.items() if "levenshtein" in name)
    if device <= 0:
        return None
    bound = sum(yardstick.bound_seconds(ops, nbytes) for ops, nbytes in run.work.values())
    return 100.0 * bound * run.traced_jobs / device
