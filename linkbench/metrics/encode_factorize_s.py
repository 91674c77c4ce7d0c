"""``encode_factorize_s``: seconds a job in the ``factorize`` spans of every
column of the ``encode`` stage (pandas' factorize of the column)."""

from linkbench.metrics._program import span_seconds


def read(run):
    return span_seconds(run, "factorize", "encode")
