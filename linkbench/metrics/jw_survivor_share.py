"""``jw_survivor_share``: the percent of the masked Jaro-Winkler columns'
pairs that pass the two-phase filter to the kernel (the program's
``jw_survivors`` over ``jw_pairs``, both columns together), averaged over
the window's jobs."""

from linkbench.metrics._program import mean_over_jobs


def _share(_spans, counters):
    pairs = counters.get("jw_pairs", 0)
    return 100.0 * counters.get("jw_survivors", 0) / pairs if pairs else None


def read(run):
    return mean_over_jobs(run, _share)
