"""``gamma_program_upload_s``: seconds a job in the ``upload`` span of the
``gamma_program`` stage, the packed table's copy to the card."""

from linkbench.metrics._program import span_seconds


def read(run):
    return span_seconds(run, "upload", "gamma_program")
