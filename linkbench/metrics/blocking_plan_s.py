"""``blocking_plan_s``: seconds a job in the ``plan`` span of the device
blocking tier (key codes on the host, the segmented sort on the card, the
units), within the ``blocking`` stage."""

from linkbench.metrics._program import span_seconds


def read(run):
    return span_seconds(run, "plan", "blocking")
