"""Shared by the stage readers: a linker stage's seconds a job."""


def mean_stage(run, stage: str):
    """The mean over the window's jobs of ``stage_seconds[stage]`` (each
    stage is synchronised with the card before its clock stops), or None
    where a job has no such stage."""
    values = [job.stages.get(stage) for job in run.jobs]
    if not values or any(v is None for v in values):
        return None
    return sum(values) / len(values)
