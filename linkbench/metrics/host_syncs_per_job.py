"""``host_syncs_per_job``: the program's ``host_syncs`` counter a job, each
a wait of the host for the card (a synchronise, a blocking read or upload,
a copy's event)."""

from linkbench.metrics._program import counter


def read(run):
    return counter(run, "host_syncs")
