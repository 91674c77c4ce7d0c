"""Serving observability: the port's copies of splink_tpu/obs's stdlib
modules that the serving tier builds, and ``metrics``, the counterpart of
the reference's compile monitor that counts the port's kernel-library
builds and AOT sidecar restores.

  * :mod:`.events`      the ambient event channel and JSONL sink;
  * :mod:`.flight`      the bounded post-mortem ring of each service;
  * :mod:`.reqtrace`    request-level tracing through the serving tier;
  * :mod:`.slo`         rolling SLO hit and burn rates;
  * :mod:`.kernelwatch` execute-latency regression alerts and histograms;
  * :mod:`.exposition`  the Prometheus text format and its HTTP endpoint;
  * :mod:`.tracer`      spans and the Chrome trace-event conversion;
  * :mod:`.fleet`       metric federation across replicas and incident
                        bundles.

Not ported yet (ROADMAP.md Queue 1 item 11): run telemetry
(``runtime``), the drift monitor, quality profiles and the ``obs`` CLI.
"""

from .events import EventSink, publish, read_events
from .exposition import ExpositionServer, HistogramSample, Sample, process_samples
from .flight import FlightRecorder
from .kernelwatch import KernelWatch
from .metrics import compile_stats, compile_totals
from .reqtrace import PHASES, PhaseProfile, RequestTrace, ServeTracer
from .slo import SLOTracker
from .tracer import Tracer, chrome_trace_from_events

__all__ = [
    "EventSink",
    "publish",
    "read_events",
    "compile_totals",
    "compile_stats",
    "Tracer",
    "chrome_trace_from_events",
    "PHASES",
    "PhaseProfile",
    "RequestTrace",
    "ServeTracer",
    "SLOTracker",
    "ExpositionServer",
    "Sample",
    "HistogramSample",
    "process_samples",
    "FlightRecorder",
    "KernelWatch",
]
