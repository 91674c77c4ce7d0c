"""``pattern_pass_s``: seconds a job in the linker's ``gammas_patterns`` stage."""

from linkbench.metrics._stage import mean_stage


def read(run):
    return mean_stage(run, "gammas_patterns")
