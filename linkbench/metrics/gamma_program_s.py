"""``gamma_program_s``: seconds a job in the linker's ``gamma_program`` stage."""

from linkbench.metrics._stage import mean_stage


def read(run):
    return mean_stage(run, "gamma_program")
