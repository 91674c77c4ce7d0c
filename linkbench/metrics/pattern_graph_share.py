"""``pattern_graph_share``: the percent of the virtual pattern pass's
batches that ran as a replay of a CUDA graph (the program's
``pattern_graph_replays`` over its ``pattern_batches``), averaged over the
window's jobs; nothing where the program counts no batches."""

from linkbench.metrics._program import mean_over_jobs


def _share(_spans, counters):
    batches = counters.get("pattern_batches")
    return 100.0 * counters.get("pattern_graph_replays", 0) / batches if batches else None


def read(run):
    return mean_over_jobs(run, _share)
