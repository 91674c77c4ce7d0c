"""``blocking_s``: seconds a job in the linker's ``blocking`` stage."""

from linkbench.metrics._stage import mean_stage


def read(run):
    return mean_stage(run, "blocking")
