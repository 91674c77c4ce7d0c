"""``pairgen_plan_s``: seconds a job in the linker's ``pairgen_plan`` stage."""

from linkbench.metrics._stage import mean_stage


def read(run):
    return mean_stage(run, "pairgen_plan")
