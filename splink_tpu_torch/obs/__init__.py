"""Serving observability: the port's copies of splink_tpu/obs's stdlib
modules that the serving tier builds (``events``, ``flight``,
``reqtrace``, ``slo``, ``kernelwatch``) and ``metrics``, the counterpart
of the reference's compile monitor that counts the port's kernel-library
builds. The rest of splink_tpu/obs (run telemetry, exposition, drift,
quality profiles) is ROADMAP.md Queue 1 item 11."""
