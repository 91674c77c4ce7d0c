"""RunContext: the per-linker telemetry object; the port of
splink_tpu/obs/runtime.py.

One RunContext per ``Splink`` instance, created from the settings. When the
``telemetry_dir`` key is empty the context is *disabled*: every method is a
single attribute check and returns immediately, no sink exists, and EM
installs no per-update hook. When enabled it owns:

  * an :class:`~.events.EventSink` writing
    ``<telemetry_dir>/run_<run_id>.jsonl`` (registered as an ambient sink
    so resilience events land in the same file);
  * a :class:`~.tracer.Tracer` for run/stage/EM-iteration spans;
  * a :class:`~.metrics.MetricsRegistry` snapshotted into the record at
    the end of each public linker call.

The record's event types and field names are the reference's, so either
package's ``obs summarize`` reads the other's record. A stage span's
``compile_count`` / ``compile_s`` carry the port's kernel-library builds
(``obs.metrics``), its only compiles.

Every emitting method is wrapped to never raise: a telemetry bug must not
take down the run it observes.
"""

from __future__ import annotations

import functools
import logging
import os
import time
import uuid
import weakref
from contextlib import contextmanager

from .events import EventSink, register_ambient
from .metrics import MetricsRegistry, compile_totals, device_memory_snapshot
from .tracer import Tracer

logger = logging.getLogger("splink_tpu_torch")

#: the identity tags every event carries; the port runs one process
HOST_TAGS = {"process_index": 0, "process_count": 1}


def _never_raise(fn):
    """Telemetry emission must never break the run it observes."""

    @functools.wraps(fn)
    def wrapper(self, *args, **kwargs):
        try:
            return fn(self, *args, **kwargs)
        except Exception as e:  # noqa: BLE001 - observability is best-effort
            logger.warning("telemetry %s failed: %s", fn.__name__, e)
            return None

    return wrapper


class RunContext:
    """Telemetry scope for one linker run (see module docstring)."""

    def __init__(
        self,
        run_id: str | None = None,
        sink: EventSink | None = None,
        memory_snapshots: bool = True,
        config_hash: str = "",
    ):
        self.run_id = run_id or uuid.uuid4().hex[:12]
        self.sink = sink
        self.memory_snapshots = memory_snapshots
        self.tracer = Tracer()
        self.metrics = MetricsRegistry()
        # per-stage execute-time EWMAs and windows (obs/kernelwatch.py),
        # alerting off (offline stages have no steady state to anchor on);
        # the snapshot lands in the record at finish() as ``kernel_watch``
        from .kernelwatch import KernelWatch

        self.kernelwatch = KernelWatch(window_s=300.0, alert_ratio=0.0)
        self._t0 = time.monotonic()
        # EM stream state: parent span and previous params for the host-side
        # max-movement computation
        self._em_parent: int | None = None
        self._em_prev = None
        self._em_last_mono: float | None = None
        if sink is not None:
            register_ambient(sink)
            sink.emit("run_start", config_hash=config_hash)
            # the ambient registry holds a strong reference to the sink: a
            # dropped linker must stop receiving later runs' events, and its
            # file handle must not outlive it. close() is idempotent.
            self._finalizer = weakref.finalize(self, sink.close)

    @property
    def enabled(self) -> bool:
        return self.sink is not None

    @classmethod
    def from_settings(cls, settings: dict) -> "RunContext":
        """Build the run's context from (completed or partial) settings;
        disabled unless ``telemetry_dir`` is set."""
        run_id = uuid.uuid4().hex[:12]
        tdir = settings.get("telemetry_dir") or ""
        sink = None
        if tdir:
            try:
                path = os.path.join(os.path.expanduser(tdir), f"run_{run_id}.jsonl")
                sink = EventSink(path, run_id, HOST_TAGS)
            except Exception as e:  # noqa: BLE001 - telemetry must not block init
                logger.warning("telemetry disabled (sink init failed): %s", e)
                sink = None
        return cls(
            run_id=run_id,
            sink=sink,
            memory_snapshots=bool(settings.get("telemetry_memory", True)),
        )

    # -- stage spans (driven by utils.profiling.StageTimer) ---------------

    @_never_raise
    def stage_enter(self, stage: str):
        if not self.enabled:
            return None
        sid = self.tracer.begin(stage, kind="stage")
        return (sid, compile_totals())

    @_never_raise
    def stage_exit(self, token, stage: str, elapsed: float, failed: bool = False):
        if not self.enabled or token is None:
            return
        sid, (c0_count, c0_secs) = token
        c1_count, c1_secs = compile_totals()
        compile_s = max(c1_secs - c0_secs, 0.0)
        span = self.tracer.end(
            sid,
            compile_count=c1_count - c0_count,
            compile_s=compile_s,
            execute_s=max(elapsed - compile_s, 0.0),
            failed=failed,
        )
        self.sink.emit("span", **span)
        self.metrics.observe(f"stage_s.{stage}", elapsed)
        self.metrics.count("compile_count", c1_count - c0_count)
        self.metrics.count("compile_s", compile_s)
        self.metrics.count("execute_s", max(elapsed - compile_s, 0.0))
        self.kernelwatch.observe(stage, max(elapsed - compile_s, 0.0))
        if self.memory_snapshots:
            devices = device_memory_snapshot()
            if devices:
                self.sink.emit("memory", stage=stage, devices=devices)
                peak = max(d.get("peak_bytes_in_use") or 0 for d in devices)
                if peak:
                    self.metrics.gauge("peak_bytes_in_use", peak)

    @contextmanager
    def span(self, name: str, **attrs):
        """Standalone span context (callers outside a StageTimer)."""
        token = self.stage_enter(name)
        t0 = time.perf_counter()
        try:
            yield
        except BaseException:
            self.stage_exit(token, name, time.perf_counter() - t0, failed=True)
            raise
        self.stage_exit(token, name, time.perf_counter() - t0)

    # -- EM convergence stream --------------------------------------------

    @_never_raise
    def em_begin(self, mode: str, lam0, m0, u0, start_iteration: int = 0):
        if not self.enabled:
            return
        import numpy as np

        self._em_parent = self.tracer.current_id()
        self._em_prev = (np.asarray(m0, float), np.asarray(u0, float))
        self._em_last_mono = time.monotonic()
        self.sink.emit(
            "em_start", mode=mode, lam=float(lam0),
            start_iteration=int(start_iteration),
        )

    @_never_raise
    def em_update(self, it, lam, m, u, ll=None, converged=False):
        """One completed EM update (the per-update hook of ``run_em``, or
        the streamed EM's per-pass call). Emits an iteration span
        (bounded by the hook's arrivals) plus the convergence record:
        lambda, log-likelihood (under the pre-update params) and ``delta``,
        the max absolute m/u parameter movement recomputed on the host."""
        if not self.enabled:
            return
        import math

        import numpy as np

        now = time.monotonic()
        it = int(it)
        m = np.asarray(m, float)
        u = np.asarray(u, float)
        delta = None
        if self._em_prev is not None and self._em_prev[0].shape == m.shape:
            delta = float(
                max(
                    np.max(np.abs(m - self._em_prev[0])),
                    np.max(np.abs(u - self._em_prev[1])),
                )
            )
        ll_val = None
        if ll is not None:
            ll_f = float(ll)
            ll_val = ll_f if math.isfinite(ll_f) else None
        t0 = self._em_last_mono if self._em_last_mono is not None else now
        span = self.tracer.emit_closed(
            f"em_iteration_{it}", "em_iteration", t0, now,
            parent=self._em_parent, iteration=it,
        )
        self.sink.emit("span", **span)
        self.sink.emit(
            "em_iteration",
            iteration=it,
            lam=float(lam),
            ll=ll_val,
            delta=delta,
            converged=bool(converged),
        )
        self.metrics.count("em_updates")
        self.metrics.gauge("em_lam", float(lam))
        if delta is not None:
            self.metrics.gauge("em_delta", delta)
        self._em_prev = (m, u)
        self._em_last_mono = now

    # -- structured one-off events ----------------------------------------

    @_never_raise
    def emit_event(self, type: str, **fields) -> None:
        """Emit one typed event into this run's record (no-op when
        disabled); ``em_diagnostics`` rides this."""
        if self.enabled:
            self.sink.emit(type, **fields)

    # -- metrics convenience (no-ops when disabled) ------------------------

    def count(self, name: str, n: float = 1) -> None:
        if self.enabled:
            self.metrics.count(name, n)

    def gauge(self, name: str, value: float) -> None:
        if self.enabled:
            self.metrics.gauge(name, value)

    def observe(self, name: str, value: float) -> None:
        if self.enabled:
            self.metrics.observe(name, value)

    def record(self, name: str, payload) -> None:
        if self.enabled:
            self.metrics.record(name, payload)

    # -- run completion ----------------------------------------------------

    @_never_raise
    def finish(self):
        """Emit the metrics snapshot and a run span. Called at the end of
        each public linker entry point; safe to call repeatedly (readers
        take the LAST metrics/run events). The sink stays open: later calls
        on the same linker append to the same record."""
        if not self.enabled:
            return
        if self.kernelwatch.phases():
            self.metrics.record("kernel_watch", self.kernelwatch.snapshot())
        self.sink.emit("metrics", **self.metrics.snapshot())
        span = self.tracer.emit_closed(
            "run", "run", self._t0, time.monotonic(), parent=None
        )
        self.sink.emit("span", **span)

    def close(self) -> None:
        """Close the sink now (unregisters it from the ambient publisher).
        Otherwise happens when the context is collected."""
        if self.sink is not None:
            self.sink.close()
