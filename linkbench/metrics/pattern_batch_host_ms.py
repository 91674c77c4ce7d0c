"""``pattern_batch_host_ms``: the host's milliseconds to issue one batch of
the virtual pattern pass (the median of a job's ``pattern_batch`` spans,
whose device work runs on after them), averaged over the window's jobs."""

from linkbench.metrics._program import mean_over_jobs, median_ms, under


def read(run):
    return mean_over_jobs(
        run, lambda spans, _c: median_ms(under(spans, "pattern_batch", "gammas_patterns")))
