"""Shared by the program-span and program-counter readers: each of the
window's jobs matched to its linker's run scope in
``splink_tpu_torch.utils.profiling``, whose stage spans last exactly the
stage seconds the job recorded (both come from the same timer)."""

from statistics import median


def _profiling():
    try:
        from splink_tpu_torch.utils import profiling
    except ImportError:
        return None
    if not all(hasattr(profiling, f) for f in ("run_ids", "run_spans", "run_counters")):
        return None  # a program without run-scope spans and counters
    return profiling


def job_scopes(run):
    """[(spans, counters)] of each of the window's jobs, or None where the
    program keeps no spans or a job has no matching run scope."""
    profiling = _profiling()
    if profiling is None or not run.jobs:
        return None
    scopes = {}
    for rid in profiling.run_ids():
        spans = profiling.run_spans(rid)
        stages = {sp["name"]: sp["dur_s"] for sp in spans if sp["kind"] == "stage"}
        scopes[tuple(sorted(stages.items()))] = (spans, profiling.run_counters(rid))
    out = [scopes.get(tuple(sorted(job.stages.items()))) for job in run.jobs]
    return None if any(s is None for s in out) else out


def under(spans, name: str, stage: str) -> list:
    """The spans called ``name`` beneath a stage span called ``stage``."""
    by_id = {sp["span_id"]: sp for sp in spans}

    def in_stage(sp):
        parent = by_id.get(sp["parent_id"])
        while parent is not None:
            if parent["kind"] == "stage":
                return parent["name"] == stage
            parent = by_id.get(parent["parent_id"])
        return False

    return [sp for sp in spans if sp["name"] == name and in_stage(sp)]


def mean_over_jobs(run, per_job):
    """The mean over the window's jobs of ``per_job(spans, counters)``, or
    None where a job gives None."""
    scopes = job_scopes(run)
    if scopes is None:
        return None
    values = [per_job(spans, counters) for spans, counters in scopes]
    if any(v is None for v in values):
        return None
    return sum(values) / len(values)


def span_seconds(run, name: str, stage: str):
    """Seconds a job in the spans called ``name`` beneath stage ``stage``."""
    def per_job(spans, _counters):
        found = under(spans, name, stage)
        return sum(sp["dur_s"] for sp in found) if found else None

    return mean_over_jobs(run, per_job)


def counter(run, name: str, scale: float = 1.0):
    """Counter ``name`` a job (0 where the job counted none), times ``scale``."""
    return mean_over_jobs(run, lambda _spans, counters: counters.get(name, 0) * scale)


def median_ms(spans: list):
    return 1e3 * median(sp["dur_s"] for sp in spans) if spans else None
