"""Observability: the port of splink_tpu/obs.

One machine-readable JSONL record per run describing where the time and
device memory went, how EM converged, which blocks dominated and which
resilience events fired; the serving tier's request tracing, SLOs, flight
recorder, exposition and fleet federation; and the quality observatory
(training-reference profiles, serve-time drift sketches and monitors).

  * :mod:`.events`      the ambient event channel and JSONL sink;
  * :mod:`.tracer`      run -> stage -> EM-iteration spans and the Chrome
                        trace-event conversion;
  * :mod:`.metrics`     counters/gauges/histograms, the kernel-library
                        build counters (the port's only compiles) and
                        device memory snapshots;
  * :mod:`.runtime`     :class:`RunContext`, the per-linker object wiring
                        the three together (``telemetry_dir``);
  * :mod:`.reqtrace`    request-level tracing through the serving tier;
  * :mod:`.slo`         rolling SLO hit and burn rates;
  * :mod:`.exposition`  the Prometheus text format and its HTTP endpoint;
  * :mod:`.flight`      the bounded post-mortem ring of each service;
  * :mod:`.quality`     training-reference quality profiles and offline EM
                        identifiability diagnostics (``quality_profile``);
  * :mod:`.drift`       serve-time device drift sketches, PSI /
                        Jensen-Shannon scoring and two-window drift alerts;
  * :mod:`.kernelwatch` execute-latency regression alerts and histograms;
  * :mod:`.fleet`       metric federation across replicas and incident
                        bundles;
  * :mod:`.cli`         ``python -m splink_tpu_torch.obs
                        summarize|export-trace|attribute|drift|bench-report|
                        serve-dash|fleet-dash``.

The reference's JIT compile monitor has no counterpart: the port compiles
nothing per shape (``metrics`` counts its library builds instead).
"""

from .drift import DriftMonitor, js_divergence, psi
from .events import EventSink, publish, read_events
from .exposition import ExpositionServer, HistogramSample, Sample, process_samples
from .flight import FlightRecorder
from .kernelwatch import KernelWatch
from .metrics import MetricsRegistry, compile_stats, compile_totals
from .quality import QualityProfile, em_diagnostics
from .reqtrace import PHASES, PhaseProfile, RequestTrace, ServeTracer
from .runtime import RunContext
from .slo import SLOTracker
from .tracer import Tracer, chrome_trace_from_events

__all__ = [
    "EventSink",
    "publish",
    "read_events",
    "MetricsRegistry",
    "compile_totals",
    "compile_stats",
    "RunContext",
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
    "QualityProfile",
    "em_diagnostics",
    "DriftMonitor",
    "psi",
    "js_divergence",
]
