"""``kernel_device_s``: device seconds a job in the hand-written string
kernels (every kernel whose name holds ``jaro_winkler`` or
``levenshtein``), from the profiler's trace of the traced jobs."""

KERNELS = ("jaro_winkler", "levenshtein")


def read(run):
    if run.trace is None or not run.traced_jobs:
        return None
    total = sum(s for name, s in run.trace.device_seconds.items()
                if any(k in name for k in KERNELS))
    return total / run.traced_jobs if total > 0 else None
