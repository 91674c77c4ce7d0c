"""Micro-batching front-end: single queries in, coalesced device batches out.

The port of splink_tpu/serve/service.py. ``submit`` enqueues a record and
returns a future; a worker thread coalesces everything queued within
``deadline_ms`` of the FIRST waiting record (or until a full largest query
bucket accumulates) into one engine dispatch, and each future resolves
with its record's matches. The worker launches on the engine's device,
named explicitly (the engine enters it around every dispatch), never on
whatever device the thread happens to hold.

Resilience is graduated (serve/admission.py, serve/health.py):

* **Admission control**: the bounded queue SHEDS when ``queue_depth``
  records wait; a request with its own ``deadline_ms`` is rejected at
  admission when the estimated queue wait (EWMA batch-time model) cannot
  meet it, and a queued request whose deadline lapses is shed at the
  batcher, never scored late.
* **Brown-out**: under pressure (queue past ``brownout_fill``, or health
  already degraded) batches run the engine's brown-out tier (reduced
  top-k over the cheapest candidate bucket), tagged ``degraded=True``.
* **Circuit breaker**: ``serve_breaker_threshold`` consecutive batch
  failures open it; requests fail fast as shed (``breaker_open``) until
  a post-cooldown batch or the watchdog's engine probe succeeds.
* **Watchdog**: a supervisor thread that sheds a dead worker's orphaned
  futures, restarts the worker, runs breaker recovery probes and drives
  the health state machine from live signals (queue fill, shed rate,
  recent p95, kernel-library builds while serving, breaker state).

Nothing raises on the submit path and no exception escapes to a caller
through a future; every degradation goes through ``warn_degraded`` and the
ambient ``obs.events`` channel. Per-request latency feeds a bounded
reservoir (:meth:`latency_summary`); sampled requests carry a trace
(``obs.reqtrace``), every request feeds the SLO tracker (``obs.slo``), a
flight recorder keeps recent span trees (``obs.flight``) and the kernel
watch alerts on execute-latency regressions (``obs.kernelwatch``). A
non-zero ``obs_exposition_port`` serves :meth:`prometheus_samples` in the
Prometheus text format (``obs.exposition``).

Across processes (serve/wire.py, serve/remote.py, serve/router.py): a
:class:`QueryResult` crosses the wire as :meth:`QueryResult.to_payload`,
JSON whose floats round-trip exactly, so a remote answer equals the local
one bit for bit; ``submit(trace=)`` takes a router's or wire server's
trace context; :meth:`fleet_stats` is the mergeable export that
``obs.fleet`` federates.

Drift (obs/drift.py): over an engine that sketches (``quality_profile``
on and a profiled index) a :class:`~..obs.drift.DriftMonitor` drains the
engine's accumulator between batches and at close, publishes
``drift_window`` reports and ``drift_alert``/``drift_clear`` transitions (an
alert dumps the flight recorder), and :meth:`drift_snapshot` reports it
(``reference: False`` with the reason for a service without one). With a
``telemetry`` ``RunContext`` each batch is a ``serve_batch`` span and the
latency summary lands in its run record; the index's ``telemetry_dir``
receives the flight recorder's dumps.
"""

from __future__ import annotations

import logging
import threading
import time
from collections import deque
from concurrent.futures import Future, InvalidStateError
from concurrent.futures import TimeoutError as FuturesTimeout
from dataclasses import dataclass, field

import numpy as np

from ..analysis import lockwatch
from ..resilience.faults import active_plan
from ..utils.logging_utils import warn_degraded
from .admission import CircuitBreaker, WaitEstimator, brownout_active
from .health import HealthMonitor

logger = logging.getLogger("splink_tpu_torch")

_LATENCY_RESERVOIR = 65536  # newest-N latency samples kept for percentiles
_RECENT_WINDOW = 512  # newest-N samples for the health monitor's p95


@dataclass
class QueryResult:
    """One query's outcome.

    ``shed`` requests carry a machine-readable ``reason``: ``queue_full``
    / ``deadline`` / ``timeout`` / ``breaker_open`` / ``batch_error`` /
    ``worker_restart`` / ``closed``. ``degraded`` marks a brown-out answer.
    ``approx`` marks an answer found through the approximate tier's
    fallback (the query's exact keys hit no bucket)."""

    matches: list = field(default_factory=list)  # [(ref_uid, probability)]
    n_candidates: int = 0
    shed: bool = False
    latency_ms: float | None = None
    degraded: bool = False
    approx: bool = False
    reason: str | None = None
    # server-side split, stamped on every delivered result: time this
    # request waited in the queue vs the engine wall it shared with its
    # batch (queue_ms + execute_ms = the server's share of a wire RTT)
    queue_ms: float | None = None
    execute_ms: float | None = None

    # -- wire round trip (serve/wire.py envelope "result" field) ---------
    # JSON float serialisation is exact (repr round-trips every double), so
    # a result that crosses the wire equals the local one bit for bit.

    def to_payload(self) -> dict:
        return {
            "matches": [[uid, p] for uid, p in self.matches],
            "n_candidates": int(self.n_candidates),
            "shed": bool(self.shed),
            "latency_ms": self.latency_ms,
            "degraded": bool(self.degraded),
            "approx": bool(self.approx),
            "reason": self.reason,
            "queue_ms": self.queue_ms,
            "execute_ms": self.execute_ms,
        }

    @classmethod
    def from_payload(cls, payload: dict) -> "QueryResult":
        return cls(
            matches=[(m[0], m[1]) for m in (payload.get("matches") or [])],
            n_candidates=int(payload.get("n_candidates") or 0),
            shed=bool(payload.get("shed")),
            latency_ms=payload.get("latency_ms"),
            degraded=bool(payload.get("degraded")),
            approx=bool(payload.get("approx")),
            reason=payload.get("reason"),
            queue_ms=payload.get("queue_ms"),
            execute_ms=payload.get("execute_ms"),
        )


class LinkageService:
    """Micro-batching query front-end over a :class:`~.engine.QueryEngine`
    (module docstring)."""

    #: routers check this before forwarding a trace context (duck-typed
    #: replicas without it keep the plain submit signature)
    accepts_trace = True

    #: every attempt this service resolves closes its span tree exactly
    #: once: the contract the wire tier's span piggyback gates the result
    #: reply on (serve/wire.py ``_SpanJoin``)
    closes_traces = True

    def __init__(
        self,
        engine,
        *,
        queue_depth: int | None = None,
        deadline_ms: float | None = None,
        autostart: bool = True,
        telemetry=None,
        name: str = "serve",
        breaker_threshold: int | None = None,
        breaker_cooldown_s: float = 1.0,
        brownout_fill: float = 0.5,
        watchdog_interval_s: float = 0.1,
        compile_stall_s: float = 0.25,
        probe_queries: int | None = None,
        health_monitor: HealthMonitor | None = None,
        trace_sample_rate: float | None = None,
        slo_objective: float = 0.999,
        flight_records: int | None = None,
        exposition_port: int | None = None,
        perf_alert_ratio: float | None = None,
        perf_window_s: float | None = None,
    ):
        settings = engine.index.settings
        self.engine = engine
        self.name = name
        self.queue_depth = int(
            queue_depth
            if queue_depth is not None
            else settings.get("serve_queue_depth", 1024) or 1024
        )
        self.deadline_ms = float(
            deadline_ms
            if deadline_ms is not None
            else settings.get("serve_deadline_ms", 5.0)
        )
        self.breaker = CircuitBreaker(
            threshold=int(
                breaker_threshold
                if breaker_threshold is not None
                else settings.get("serve_breaker_threshold", 3) or 3
            ),
            cooldown_s=breaker_cooldown_s,
        )
        self.brownout_fill = float(brownout_fill)
        self.brownout_enabled = engine.brownout_top_k > 0
        self.watchdog_interval_s = float(watchdog_interval_s)
        self.compile_stall_s = float(compile_stall_s)
        self._probe_queries = int(
            probe_queries
            if probe_queries is not None
            else settings.get("serve_probe_queries", 16) or 0
        )
        self._settings = settings
        self._obs = telemetry
        self._lock = lockwatch.new_lock("LinkageService._lock")
        self._nonempty = threading.Condition(self._lock)
        # (record, future, t_enqueue, deadline, trace): trace is None for
        # unsampled requests
        self._queue: deque = deque()
        self._inflight: list = []  # entries popped by the worker, unresolved
        self._probe_buffer: list = []  # records accumulating toward capture
        self._latencies: deque = deque(maxlen=_LATENCY_RESERVOIR)
        self._recent_lat: deque = deque(maxlen=_RECENT_WINDOW)
        self._admission = WaitEstimator()
        self._health = health_monitor or HealthMonitor(name=name)
        self._shed_count = 0
        self._served = 0
        self._batches = 0
        self._timeouts = 0
        self._degraded_served = 0
        self._brownout_episodes = 0
        self._worker_crashes = 0
        self._brownout_active = False
        self._take_fill = 0.0
        self._swap_in_progress = False
        self._t_start = time.monotonic()
        self._stop = False
        self._summary_recorded = False
        self._thread: threading.Thread | None = None
        self._watchdog: threading.Thread | None = None
        self._watchdog_stop = threading.Event()
        # health-window marks, shared by the watchdog and health() calls
        self._signals_lock = lockwatch.new_lock("LinkageService._signals_lock")
        self._hw_served = 0
        self._hw_shed = 0
        self._stall_accum = 0.0
        self._last_health_eval = float("-inf")
        from ..obs.metrics import compile_totals

        self._last_compile_s = compile_totals()[1]
        from ..obs.events import register_ambient
        from ..obs.flight import FlightRecorder
        from ..obs.reqtrace import ServeTracer
        from ..obs.slo import SLOTracker

        rate = float(
            trace_sample_rate
            if trace_sample_rate is not None
            else settings.get("serve_trace_sample_rate", 0.0) or 0.0
        )
        n_flight = int(
            flight_records
            if flight_records is not None
            else settings.get("obs_flight_records", 256) or 0
        )
        self._flight = FlightRecorder(
            n_flight, dump_dir=(settings.get("telemetry_dir") or None), name=name
        )
        if self._flight.enabled:
            register_ambient(self._flight)
        self._tracer = ServeTracer(rate, service=name, flight=self._flight)
        self._slo = SLOTracker(objective=slo_objective)
        # the drift observatory: present only when the engine sketches
        self._drift_alert_active = False
        self._drift = self._make_drift_monitor()
        # kernel performance watch: rolling-window execute-latency
        # regression alerts over the batch wall and the PhaseProfile splits
        self._perf_alert_active = False
        self._last_perf_window = float("-inf")
        self._last_perf_eval = float("-inf")
        ratio = float(
            perf_alert_ratio
            if perf_alert_ratio is not None
            else settings.get("perf_alert_ratio", 3.0) or 0.0
        )
        self._kwatch = None
        if ratio > 0:
            from ..obs.kernelwatch import KernelWatch

            self._kwatch = KernelWatch(
                window_s=float(
                    perf_window_s
                    if perf_window_s is not None
                    else settings.get("perf_window_s", 30.0) or 30.0
                ),
                alert_ratio=ratio,
            )
        self._exposition = None
        port = int(
            exposition_port
            if exposition_port is not None
            else settings.get("obs_exposition_port", 0) or 0
        )
        if port:
            try:
                from ..obs.exposition import ExpositionServer

                self._exposition = ExpositionServer(port)
                self._exposition.add_source(name, self.prometheus_samples)
                self._exposition.start()
                logger.info("serve metrics exposition on %s", self._exposition.url)
            except Exception as e:  # noqa: BLE001 - obs must not block serving
                logger.warning("metrics exposition failed to start: %s", e)
                self._exposition = None
        if autostart:
            self.start()

    # -- lifecycle ------------------------------------------------------

    def start(self) -> "LinkageService":
        """Start (or restart after :meth:`close`) the worker + watchdog."""
        with self._nonempty:
            if self._thread is None:
                self._stop = False
                self._thread = threading.Thread(
                    target=self._worker, name="splink-serve", daemon=True
                )
                self._summary_recorded = False  # a reopen records again
                self._thread.start()
        if self._watchdog is None or not self._watchdog.is_alive():
            self._watchdog_stop = threading.Event()
            self._watchdog = threading.Thread(
                target=self._watchdog_loop, name="splink-serve-watchdog", daemon=True
            )
            self._watchdog.start()
        return self

    def close(self, drain: bool = True) -> None:
        """Stop the worker and watchdog. With ``drain`` (default) queued
        requests are served first; otherwise they resolve shed. Idempotent:
        a second close is a no-op and never hangs a future."""
        self._watchdog_stop.set()
        watchdog = self._watchdog
        if watchdog is not None and watchdog is not threading.current_thread():
            watchdog.join(timeout=10)
        self._watchdog = None
        to_shed: list = []
        with self._nonempty:
            self._stop = True
            if not drain:
                while self._queue:
                    to_shed.append(self._queue.popleft())
            self._nonempty.notify_all()
        for entry in to_shed:
            self._resolve_shed(entry[1], "closed", entry[4])
        with self._lock:
            worker = self._thread
            self._thread = None
        if worker is not None:
            worker.join(timeout=30)
        # a submit racing the shutdown can enqueue after the worker's last
        # batch, and a worker that died mid-batch leaves in-flight entries:
        # resolve all stragglers shed so no future hangs
        with self._nonempty:
            stragglers = list(self._queue) + self._inflight
            self._queue.clear()
            self._inflight = []
        for entry in stragglers:
            self._resolve_shed(entry[1], "closed", entry[4])
        # final drift drain: the tail window must not stay in the device
        # accumulator (short-lived services still report their drift)
        self._drift_tick(force=True)
        # once per lifetime: close() is idempotent and must not record the
        # latency summary twice (the check-and-set is atomic)
        with self._lock:
            record_summary = self._obs is not None and not self._summary_recorded
            self._summary_recorded = True
        if record_summary:
            self._obs.record("serve_latency", self.latency_summary())
        if self._exposition is not None:
            self._exposition.close()
            self._exposition = None
        self._flight.close()  # unregister; the ring stays dump-able

    def __enter__(self) -> "LinkageService":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.close()

    # -- submission -----------------------------------------------------

    def submit(self, record: dict, deadline_ms: float | None = None,
               trace=None) -> Future:
        """Enqueue one query record; never raises. Sheds immediately
        (future resolves ``shed=True`` + degradation event) when the
        service is closed, the bounded queue is full, or ``deadline_ms`` is
        given and the estimated queue wait already exceeds it. A queued
        request's ``deadline_ms`` also rides into the batcher: lapsed
        requests are shed at dispatch, never scored late.

        ``trace`` is an inbound :class:`~..obs.reqtrace.RequestTrace` (a
        router's attempt context, or one a wire server carried across);
        without one, the service's own sampler decides. The trace closes
        exactly once, wherever this request's future resolves."""
        fut: Future = Future()
        if trace is None:
            trace = self._tracer.maybe_start()
        reason = None
        with self._nonempty:
            if self._stop and self._thread is None:
                reason = "closed"
                reason_text = "service is closed; submissions resolve shed"
            elif len(self._queue) >= self.queue_depth:
                reason = "queue_full"
                reason_text = (
                    f"bounded queue full ({self.queue_depth} waiting); "
                    "shedding instead of growing without bound"
                )
            elif deadline_ms is not None:
                est = self._admission.estimate_wait_ms(
                    len(self._queue),
                    self.engine.policy.max_batch,
                    self.deadline_ms,
                    inflight_batches=1 if self._inflight else 0,
                )
                if est > deadline_ms:
                    reason = "deadline"
                    reason_text = (
                        f"estimated queue wait {est:.1f}ms exceeds the "
                        f"request deadline {deadline_ms:.1f}ms; rejected at "
                        "admission instead of timing out in the queue"
                    )
            if reason is not None:
                self._shed_count += 1
                shed_total = self._shed_count
            else:
                deadline = (
                    None if deadline_ms is None
                    else time.monotonic() + deadline_ms / 1000.0
                )
                if trace is not None:
                    trace.mark("admit")
                self._queue.append((record, fut, time.monotonic(), deadline, trace))
                self._nonempty.notify()
                return fut
        # outside the lock: resolving the future runs done-callbacks, and
        # warn_degraded publishes and warns
        fut.set_result(QueryResult(shed=True, reason=reason))
        self._slo.observe(False)
        self._tracer.close(trace, "shed", reason=reason)
        warn_degraded(
            "serve_admission" if reason == "deadline" else "serve_queue",
            "shed", reason_text, shed_total=shed_total,
        )
        return fut

    def query(self, record: dict, timeout: float | None = None,
              deadline_ms: float | None = None) -> QueryResult:
        """Submit one record and wait for its result. A ``timeout`` that
        expires CANCELS the request: it leaves the queue, counts shed
        (reason ``timeout``) and the degradation event fires, unless its
        real result won the race, which is returned."""
        fut = self.submit(record, deadline_ms=deadline_ms)
        try:
            return fut.result(timeout=timeout)
        except FuturesTimeout:
            return self._cancel_timed_out(fut, timeout)

    def _cancel_timed_out(self, fut: Future, timeout) -> QueryResult:
        trace = None
        with self._nonempty:
            for i, entry in enumerate(self._queue):
                if entry[1] is fut:
                    trace = entry[4]
                    del self._queue[i]
                    break
            else:
                for entry in self._inflight:
                    if entry[1] is fut:
                        trace = entry[4]
                        break
        res = QueryResult(shed=True, reason="timeout")
        won = False
        if not fut.done():
            try:
                fut.set_result(res)
                won = True
            except InvalidStateError:  # the worker resolved it first
                pass
        if not won:
            return fut.result(timeout=0)
        with self._lock:
            self._shed_count += 1
            self._timeouts += 1
        self._slo.observe(False)
        self._tracer.close(trace, "shed", reason="timeout")
        warn_degraded(
            "serve_timeout", "shed",
            f"request result not ready within its {timeout}s timeout; "
            "cancelled (dequeued) and counted shed",
            timeout_s=timeout,
        )
        return res

    # -- worker ---------------------------------------------------------

    def _worker(self) -> None:
        try:
            while True:
                # fault site OUTSIDE the batch try-block: a raise here kills
                # the worker thread, which the watchdog recovers from
                with self._lock:
                    batch_no = self._batches
                active_plan(self._settings).fire("serve_worker", batch=batch_no)
                batch = self._take_batch()
                if batch is None:
                    return
                self._serve_batch(batch)
                # drift drains ride BETWEEN batches (one bounded device read
                # per drain cadence, never inside a dispatch)
                self._drift_tick()
                self._perf_tick()
        except Exception:  # noqa: BLE001 - a dying worker must not spam stderr
            logger.exception(
                "serve worker thread died; the watchdog will shed its "
                "orphaned requests and restart it"
            )

    def _take_batch(self):
        """Block until work exists, then coalesce until the deadline (from
        the FIRST waiting record) or a full largest bucket. The taken
        entries are tracked as in-flight so a worker death cannot orphan
        them past the watchdog."""
        max_batch = self.engine.policy.max_batch
        with self._nonempty:
            while not self._queue:
                if self._stop:
                    return None
                self._nonempty.wait(timeout=0.1)
            t_form = time.monotonic()
            deadline = self._queue[0][2] + self.deadline_ms / 1000.0
            while len(self._queue) < max_batch and not self._stop:
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    break
                self._nonempty.wait(timeout=remaining)
            # pressure is measured BEFORE the take: a large batch drains the
            # queue, which must not hide the pressure it is the evidence of
            self._take_fill = len(self._queue) / self.queue_depth
            take = min(len(self._queue), max_batch)
            batch = [self._queue.popleft() for _ in range(take)]
            self._inflight = batch
            t_pop = time.monotonic()
            for entry in batch:
                tr = entry[4]
                if tr is not None:
                    tr.marks["form"] = t_form
                    tr.marks["pop"] = t_pop
            return batch

    def _clear_inflight(self) -> None:
        with self._lock:
            self._inflight = []

    def _resolve_shed(self, fut: Future, reason: str, trace=None) -> bool:
        """Resolve one future shed (if still unresolved), count it, feed
        the SLO tracker and close the request's span tree."""
        if fut.done():
            return False
        try:
            fut.set_result(QueryResult(shed=True, reason=reason))
        except InvalidStateError:  # lost a resolution race
            return False
        with self._lock:
            self._shed_count += 1
        self._slo.observe(False)
        self._tracer.close(trace, "shed", reason=reason)
        return True

    def _serve_batch(self, batch) -> None:
        import pandas as pd

        now = time.monotonic()
        live, expired = [], 0
        for entry in batch:
            fut = entry[1]
            if fut.done():  # cancelled on timeout; already counted
                continue
            dl = entry[3]
            if dl is not None and now > dl:
                self._resolve_shed(fut, "deadline", entry[4])
                expired += 1
                continue
            live.append(entry)
        if expired:
            warn_degraded(
                "serve_deadline", "shed",
                f"{expired} request(s) exceeded their deadline waiting in "
                "the queue; shed at dispatch instead of scored late",
                expired=expired,
            )
        if not live:
            self._clear_inflight()
            return
        if self.breaker.should_fail_fast():
            for entry in live:
                self._resolve_shed(entry[1], "breaker_open", entry[4])
            warn_degraded(
                "serve_breaker", "shed",
                f"circuit breaker open ({self.breaker.threshold} "
                "consecutive batch failures); failing fast until a "
                "recovery probe succeeds",
                requests=len(live),
            )
            self._clear_inflight()
            return
        with self._lock:
            q_fill = self._take_fill
            batch_no = self._batches
            swap_overlapped = self._swap_in_progress
        degraded = brownout_active(
            q_fill, self._health.state,
            enabled=self.brownout_enabled, fill_threshold=self.brownout_fill,
        )
        self._note_brownout(degraded, q_fill)
        records = [e[0] for e in live]
        futures = [e[1] for e in live]
        t_enq = [e[2] for e in live]
        traces = [e[4] for e in live]
        # one batch-level phase profile when a request is traced or the
        # kernel watch wants the execute split
        profile = None
        if any(tr is not None for tr in traces) or self._kwatch is not None:
            from ..obs.reqtrace import PhaseProfile

            profile = PhaseProfile()
        t_dispatch = time.monotonic()
        t0 = time.perf_counter()
        try:
            active_plan(self._settings).fire("serve_batch", batch=batch_no)
            df = pd.DataFrame.from_records(records)
            if self._obs is not None:
                with self._obs.span("serve_batch", batch=len(live), degraded=degraded):
                    results = self._score(df, degraded, profile)
            else:
                results = self._score(df, degraded, profile)
        except Exception as e:  # noqa: BLE001 - one bad batch must not kill the loop
            logger.exception("serve batch failed; shedding %d request(s)", len(live))
            opened = self.breaker.on_failure()
            for entry in live:
                self._resolve_shed(entry[1], "batch_error", entry[4])
            warn_degraded(
                "serve_batch", "shed",
                f"batch scoring failed ({type(e).__name__}: {e}); "
                f"{len(live)} request(s) resolved shed, no exception "
                "escapes to callers",
                requests=len(live),
            )
            if opened:
                warn_degraded(
                    "serve_engine", "breaker_open",
                    f"{self.breaker.threshold} consecutive batch failures; "
                    "failing fast while probes test recovery",
                    cooldown_s=self.breaker.cooldown_s, replica=self.name,
                )
            self._clear_inflight()
            return
        batch_ms = (time.perf_counter() - t0) * 1000.0
        with self._lock:
            swap_overlapped = swap_overlapped or self._swap_in_progress
        if profile is not None and swap_overlapped:
            # a concurrent swap's warmup may build libraries outside the
            # dispatch lock: not this batch's
            profile.compile_s = 0.0
        if self.breaker.on_success():
            from ..obs.events import publish

            publish("breaker", state="closed", reason="probe batch succeeded")
            logger.info("serve circuit breaker closed: probe batch succeeded")
        self._admission.observe(batch_ms)
        if self._kwatch is not None and not degraded:
            # batches that built a library are warmup, not steady state
            if profile is None or profile.compile_s <= 0.0:
                self._kwatch.observe("batch", batch_ms / 1000.0)
                if profile is not None:
                    self._kwatch.observe("execute", profile.execute_s)
                    self._kwatch.observe("transfer", profile.transfer_s)
        now = time.monotonic()
        generation = self.engine.generation
        for tr in traces:
            if tr is not None:
                tr.marks["engine_out"] = now
        # deliver first, count after: a request cancelled mid-score was
        # already counted shed
        delivered = []
        for i, fut in enumerate(futures):
            res = results[i]
            res.degraded = degraded
            res.latency_ms = (now - t_enq[i]) * 1000.0
            res.queue_ms = (t_dispatch - t_enq[i]) * 1000.0
            res.execute_ms = batch_ms
            if fut.done():
                continue
            try:
                fut.set_result(res)
            except InvalidStateError:  # timed out in the same instant
                continue
            delivered.append(res)
            self._slo.observe(True)
            self._tracer.close(
                traces[i], "delivered", profile=profile, batch=len(live),
                degraded=degraded, generation=generation,
            )
            if self._obs is not None:
                self._obs.observe("serve_latency_ms", res.latency_ms)
        with self._lock:
            self._batches += 1
            first_batch = self._batches == 1
            self._served += len(delivered)
            if degraded:
                self._degraded_served += len(delivered)
            for res in delivered:
                self._latencies.append(res.latency_ms)
                self._recent_lat.append(res.latency_ms)
        if first_batch:
            # re-baseline build-stall detection at first traffic: builds
            # before serving are not a stall
            from ..obs.metrics import compile_totals

            with self._signals_lock:
                self._last_compile_s = compile_totals()[1]
                self._stall_accum = 0.0
        self._clear_inflight()
        if self._probe_queries and not degraded and self.engine.probe_count == 0:
            # seed the hot-swap parity probe set from live traffic, once
            # the probe budget is met (capture re-scores it as one batch)
            need = self._probe_queries - len(self._probe_buffer)
            if need > 0:
                self._probe_buffer.extend(records[:need])
            if len(self._probe_buffer) >= self._probe_queries:
                try:
                    self.engine.capture_probes(
                        pd.DataFrame.from_records(self._probe_buffer)
                    )
                except Exception as e:  # noqa: BLE001 - probes must not break serving
                    logger.debug("probe capture failed: %s", e)
                self._probe_buffer = []

    def _note_brownout(self, active: bool, q_fill: float) -> None:
        with self._lock:
            if active == self._brownout_active:
                return
            self._brownout_active = active
            if active:
                self._brownout_episodes += 1
        from ..obs.events import publish

        if active:
            warn_degraded(
                "serve_brownout", "active",
                f"pressure (queue {q_fill:.0%} full, health "
                f"{self._health.state}); serving budgeted top-"
                f"{self.engine.brownout_top_k} answers instead of shedding",
                queue_fill=round(q_fill, 3),
            )
        else:
            publish("brownout_end", queue_fill=round(q_fill, 3))
            logger.info("serve brown-out ended (queue %.0f%% full)", q_fill * 100)

    def _score(self, df, degraded: bool = False, profile=None) -> list[QueryResult]:
        approx_out: list = []
        top_p, top_rows, top_valid, n_cand = self.engine.query_arrays(
            df, degraded=degraded, profile=profile, approx_out=approx_out
        )
        approx_used = approx_out[0]
        uids = self.engine.index.unique_id
        out = []
        for i in range(len(df)):
            matches = [
                (uids[top_rows[i, r]], float(top_p[i, r]))
                for r in range(top_p.shape[1])
                if top_valid[i, r]
            ]
            out.append(QueryResult(matches=matches, n_candidates=int(n_cand[i]),
                                   approx=bool(approx_used[i])))
        return out

    # -- watchdog -------------------------------------------------------

    def _watchdog_loop(self) -> None:
        while not self._watchdog_stop.wait(self.watchdog_interval_s):
            try:
                self._watchdog_tick()
            except Exception as e:  # noqa: BLE001 - the supervisor must survive
                logger.warning("serve watchdog tick failed: %s", e)

    def _watchdog_tick(self) -> None:
        from ..obs.events import publish

        # 1. dead-worker recovery: shed orphans, restart, emit events
        orphans = None
        with self._nonempty:
            t = self._thread
            if t is not None and not t.is_alive() and not self._stop:
                orphans = self._inflight + list(self._queue)
                self._inflight = []
                self._queue.clear()
                self._worker_crashes += 1
                crashes = self._worker_crashes
                self._thread = threading.Thread(
                    target=self._worker, name="splink-serve", daemon=True
                )
                self._thread.start()
        if orphans is not None:
            n = sum(
                self._resolve_shed(entry[1], "worker_restart", entry[4])
                for entry in orphans
            )
            publish("serve_worker_restart", orphaned=n, crashes=crashes,
                    replica=self.name)
            warn_degraded(
                "serve_worker", "restarted",
                f"worker thread died; {n} orphaned request(s) resolved "
                "shed and the worker was restarted",
                orphaned=n, crashes=crashes,
            )
        # 2. breaker recovery probe when traffic has stopped
        if self.breaker.probe_due():
            with self._lock:
                idle = not self._queue and not self._inflight
            if idle:
                try:
                    self.engine.probe()
                except Exception as e:  # noqa: BLE001 - a failed probe re-opens
                    self.breaker.on_failure()
                    logger.warning("breaker recovery probe failed: %s", e)
                else:
                    if self.breaker.on_success():
                        publish("breaker", state="closed",
                                reason="watchdog probe succeeded")
                        logger.info(
                            "serve circuit breaker closed: watchdog probe succeeded"
                        )
        # 3. health evaluation from live signals
        self._maybe_evaluate_health()
        # 4. drift windows advance even when traffic stops (an idle
        # service still ages out its rolling drift windows), and the
        # perf-alert state machine ages out of alerting the same way
        self._drift_tick()
        self._perf_tick()

    # -- kernel performance watch ----------------------------------------

    # -- drift observatory ----------------------------------------------

    def _make_drift_monitor(self):
        sketch = getattr(self.engine, "sketch", None)
        if sketch is None:
            return None
        from ..obs.drift import DriftMonitor

        s = self._settings
        profile = self.engine.index.profile
        # the served-score distribution and the profile's must describe
        # the SAME scoring (both TF-adjusted or both not) — either
        # mismatch (TF engine over a pre-fold unadjusted profile, OR a
        # tf_adjust=False engine over an adjusted profile) would alert on
        # the adjustment delta itself. Re-anchor the score channel dark
        # with a reason instead; the fold-invariant gamma channels stay.
        score_reference = bool(
            getattr(self.engine, "tf_active", False)
        ) == bool(getattr(profile, "tf_adjusted", False))
        return DriftMonitor(
            profile,
            window_s=float(s.get("drift_window_s", 60.0) or 60.0),
            alert_psi=float(s.get("drift_alert_psi", 0.25) or 0.0),
            score_reference=score_reference,
        )

    def _drift_tick(self, force: bool = False) -> None:
        """Drain the engine's drift accumulator when a window bucket is
        due, score the rolling windows and drive the two-window alert
        state machine. Never raises into the worker/watchdog."""
        drift = self._drift
        if drift is None:
            return
        try:
            if not force and not self.engine.drift_drain_due(
                drift.drain_cadence_s
            ):
                return
            window = self.engine.drain_drift()
            if window is None:
                return
            drift.observe(window)
            from ..obs.events import publish

            short = drift.window_drift(drift.window_s)
            if short is not None:
                publish(
                    "drift_window",
                    replica=self.name,
                    window_s=short["window_s"],
                    queries=short["queries"],
                    pairs=short["pairs"],
                    served_pairs=short["served_pairs"],
                    match_yield=short["match_yield"],
                    max_psi=short["max_psi"],
                    channels={
                        ch: v.get("psi")
                        for ch, v in short["channels"].items()
                    },
                    oov_rate=short["oov_rate"],
                    exact_miss_rate=short["exact_miss_rate"],
                    approx_rate=short["approx_rate"],
                )
            self._evaluate_drift_alerts(drift, short=short)
        except Exception as e:  # noqa: BLE001 - obs must not break serving
            logger.warning("drift tick failed: %s", e)

    def _evaluate_drift_alerts(self, drift, short=None) -> None:
        """Alert transitions: entering publishes one ``drift_alert``
        event (which also triggers a flight-recorder dump — the incident
        artifact for "the answers changed"); leaving publishes
        ``drift_clear``. Level-triggered state, edge-triggered events."""
        from ..obs.events import publish

        fired = drift.alerts(short=short)
        if fired and not self._drift_alert_active:
            self._drift_alert_active = True
            publish("drift_alert", replica=self.name, alerts=fired)
            logger.warning(
                "serve drift alert: %s exceed PSI %.3g over both the "
                "%.0fs and %.0fs windows — the served distribution has "
                "moved off the training reference (retrain trigger)",
                ", ".join(a["channel"] for a in fired),
                drift.alert_psi, drift.window_s, drift.long_window_s,
            )
        elif not fired and self._drift_alert_active:
            self._drift_alert_active = False
            publish("drift_clear", replica=self.name)
            logger.info("serve drift alert cleared (replica %s)", self.name)

    def drift_snapshot(self) -> dict:
        """The drift observatory's live report: per-channel PSI/JS over
        the short and long rolling windows vs the training-reference
        profile, serve-side OOV/approx/null rates, fired alerts. A
        profile-less index (or quality_profile off) reports
        ``reference: False`` with the reason — it never raises."""
        from ..obs.drift import no_reference_snapshot

        if self._drift is None:
            if getattr(self.engine.index, "profile", None) is None:
                return no_reference_snapshot()
            return no_reference_snapshot(
                "drift sketching disabled (quality_profile off)"
            )
        snap = self._drift.snapshot()
        snap["alert_active"] = self._drift_alert_active
        return snap

    def _perf_tick(self) -> None:
        """Advance the perf-regression alert state machine (edge-triggered
        ``perf_alert``/``perf_clear`` events) and publish the periodic
        ``perf_window`` report; rate-limited, never raises."""
        kw = self._kwatch
        if kw is None:
            return
        now = time.monotonic()
        if now - self._last_perf_eval < min(1.0, kw.window_s / 8.0):
            return
        self._last_perf_eval = now
        try:
            from ..obs.events import publish

            snap = kw.snapshot()
            fired = snap["alerts"]
            if fired and not self._perf_alert_active:
                self._perf_alert_active = True
                publish("perf_alert", replica=self.name, alerts=fired, snapshot=snap)
                logger.warning(
                    "serve perf alert: %s p95 regressed past %.3gx the "
                    "post-warmup anchor over both the %.0fs and %.0fs "
                    "windows — the serving kernels got slower",
                    ", ".join(a["phase"] for a in fired),
                    kw.alert_ratio, kw.window_s, kw.long_window_s,
                )
            elif not fired and self._perf_alert_active:
                self._perf_alert_active = False
                publish("perf_clear", replica=self.name)
                logger.info("serve perf alert cleared (replica %s)", self.name)
            now = time.monotonic()
            if now - self._last_perf_window >= kw.window_s / 2.0:
                phases = {
                    name: {
                        "anchor_ms": st["anchor_ms"],
                        "ewma_ms": st["ewma_ms"],
                        "p95_ms": st["short"]["p95_ms"],
                        "n": st["short"]["n"],
                    }
                    for name, st in snap["phases"].items()
                    if st is not None
                }
                if any(p["n"] for p in phases.values()):
                    self._last_perf_window = now
                    publish("perf_window", replica=self.name, window_s=kw.window_s,
                            phases=phases, alert_active=self._perf_alert_active)
        except Exception as e:  # noqa: BLE001 - obs must not break serving
            logger.warning("perf tick failed: %s", e)

    def perf_snapshot(self) -> dict:
        """The kernel watch's live report; ``enabled: False`` with the
        reason when the watch is off (``perf_alert_ratio`` 0)."""
        if self._kwatch is None:
            return {
                "enabled": False,
                "reason": "kernel watch disabled (perf_alert_ratio 0)",
                "alerts": [],
            }
        snap = self._kwatch.snapshot()
        snap["enabled"] = True
        snap["alert_active"] = self._perf_alert_active
        return snap

    # -- health ---------------------------------------------------------

    def _health_signals(self) -> dict:
        from ..obs.metrics import compile_totals

        with self._lock:
            served, shed = self._served, self._shed_count
            q_fill = len(self._queue) / self.queue_depth if self.queue_depth else 0.0
            worker = self._thread
            alive = worker is not None and worker.is_alive()
            brownout = self._brownout_active
            recent = list(self._recent_lat)
            swapping = self._swap_in_progress
        _, c_secs = compile_totals()
        # kernel-library builds while serving accumulate across windows
        # (a build-free window clears it), read-updated atomically
        with self._signals_lock:
            d_served = served - self._hw_served
            d_shed = shed - self._hw_shed
            self._hw_served, self._hw_shed = served, shed
            delta_c = c_secs - self._last_compile_s
            self._last_compile_s = c_secs
            if swapping or delta_c <= 0:
                self._stall_accum = 0.0
            else:
                self._stall_accum += delta_c
            stall = self._stall_accum > self.compile_stall_s
        total = d_served + d_shed
        shed_rate = (d_shed / total) if total else 0.0
        p95 = (
            float(np.percentile(np.asarray(recent, np.float64), 95)) if recent else None
        )
        return {
            "worker_alive": alive,
            "breaker": self.breaker.state,
            "queue_fill": round(q_fill, 4),
            "shed_rate": round(shed_rate, 4),
            "p95_ms": p95,
            "compile_stall": stall,
            "brownout": brownout,
        }

    def _maybe_evaluate_health(self) -> None:
        """Advance the health state machine at most once per watchdog
        interval (the recovery hysteresis is calibrated to that cadence)."""
        now = time.monotonic()
        with self._signals_lock:
            if now - self._last_health_eval < self.watchdog_interval_s:
                return
            self._last_health_eval = now
        self._health.evaluate(self._health_signals())

    def health(self) -> dict:
        """The replica's live health: advances the state machine
        (rate-limited to the watchdog cadence) and returns its snapshot
        plus breaker and engine context."""
        self._maybe_evaluate_health()
        snap = self._health.snapshot()
        snap["breaker"] = self.breaker.snapshot()
        snap["generation"] = self.engine.generation
        with self._lock:
            snap["worker_crashes"] = self._worker_crashes
            snap["brownout_episodes"] = self._brownout_episodes
        return snap

    @property
    def health_state(self) -> str:
        """Current state WITHOUT re-evaluating."""
        return self._health.state

    # -- index hot-swap -------------------------------------------------

    def swap_index(self, source, *, refresh_probes: bool = False) -> dict:
        """Hot-swap the engine's index (:meth:`~.engine.QueryEngine.swap_index`)
        while this service keeps serving the old one; the swap's own
        library builds are excluded from the build-stall signal, and the
        drift monitor and kernel watch re-anchor on post-swap traffic."""
        from ..obs.metrics import compile_totals

        with self._lock:
            self._swap_in_progress = True
        try:
            stats = self.engine.swap_index(source, refresh_probes=refresh_probes)
        finally:
            with self._lock:
                self._swap_in_progress = False
            with self._signals_lock:
                self._last_compile_s = compile_totals()[1]
                self._stall_accum = 0.0
        # the committed index may carry another (or no) reference profile:
        # old windows describe the old reference and must not score
        # against the new one
        self._drift = self._make_drift_monitor()
        self._drift_alert_active = False
        if self._kwatch is not None:
            from ..obs.kernelwatch import KernelWatch

            self._kwatch = KernelWatch(
                window_s=self._kwatch.window_s, alert_ratio=self._kwatch.alert_ratio
            )
            self._perf_alert_active = False
        return stats

    # -- reporting ------------------------------------------------------

    def latency_summary(self) -> dict:
        """p50/p95/p99 request latency (ms), counts, throughput and the
        resilience counters over the service's lifetime."""
        with self._lock:
            lats = np.asarray(self._latencies, np.float64)
            served = self._served
            shed = self._shed_count
            batches = self._batches
            degraded_served = self._degraded_served
            timeouts = self._timeouts
            brownout_episodes = self._brownout_episodes
            worker_crashes = self._worker_crashes
        elapsed = max(time.monotonic() - self._t_start, 1e-9)
        out = {
            "served": served,
            "shed": shed,
            "batches": batches,
            "queries_per_sec": served / elapsed,
            "degraded_served": degraded_served,
            "timeouts": timeouts,
            "brownout_episodes": brownout_episodes,
            "worker_crashes": worker_crashes,
            "breaker_state": self.breaker.state,
            "breaker_opened_total": self.breaker.opened_total,
            "health": self._health.state,
            "index_generation": self.engine.generation,
        }
        if len(lats):
            p50, p95, p99 = np.percentile(lats, [50, 95, 99])
            out.update(p50_ms=float(p50), p95_ms=float(p95), p99_ms=float(p99),
                       mean_ms=float(lats.mean()))
        if self._tracer.enabled:
            out["traces"] = self._tracer.snapshot()
        return out

    def phase_summary(self) -> dict:
        """p50/p99 per phase (ms) over the recent delivered traces; empty
        when tracing is off (``serve_trace_sample_rate`` 0)."""
        return self._tracer.phase_summary()

    def slo_snapshot(self) -> dict:
        """Rolling hit rate + multi-window burn rates: delivered = good,
        shed = bad."""
        return self._slo.snapshot()

    def fleet_stats(self) -> dict:
        """Mergeable, JSON-serialisable stats export for metric federation
        (:mod:`..obs.fleet`; served over the wire as the ``stats``
        envelope): counters add, the kernel watch's log2-bucket histograms
        add element-wise with an exact ``sum`` and the SLO tracker's
        time-bucketed ring adds per bucket index, and the ``drift``
        aggregates (present when the engine sketches) are integer count
        tensors, so a merge of N hosts' exports equals the single-tracker
        view of the union of their observations bit for bit."""
        with self._lock:
            counters = {
                "served": self._served,
                "shed": self._shed_count,
                "batches": self._batches,
                "timeouts": self._timeouts,
                "degraded_served": self._degraded_served,
                "worker_crashes": self._worker_crashes,
                "brownout_episodes": self._brownout_episodes,
            }
        out = {
            "replica": self.name,
            "t_mono": time.monotonic(),
            "health": self._health.state,
            "breaker_state": self.breaker.state,
            "index_generation": self.engine.generation,
            "counters": counters,
            "slo": self._slo.export(),
        }
        kw = self._kwatch
        if kw is not None:
            from ..obs.kernelwatch import HIST_EDGES

            phases = {}
            for phase in kw.phases():
                hist = kw.histogram(phase)
                if hist is None:
                    continue
                counts, _edges, total, n = hist
                if n:
                    phases[phase] = {
                        "counts": [int(c) for c in counts],
                        "sum": float(total),
                        "n": int(n),
                    }
            out["perf"] = {"edges": list(HIST_EDGES), "phases": phases}
        drift = self._drift
        if drift is not None:
            try:
                out["drift"] = drift.export_aggregate()
            except Exception as e:  # noqa: BLE001 - federation must not break serving
                logger.warning("drift export failed: %s", e)
        return out

    @property
    def flight_recorder(self):
        return self._flight

    def prometheus_samples(self) -> list:
        """The service's metric families for the text-exposition endpoint
        (:mod:`..obs.exposition`), the reference's families. Reads the same
        locked snapshots the JSON endpoints use; safe from the scrape
        thread."""
        from ..obs.exposition import Sample, process_samples
        from .health import health_rank

        replica = {"replica": self.name}
        summary = self.latency_summary()
        with self._lock:
            queue_len = len(self._queue)
        out = [
            Sample("splink_serve_served_total", summary["served"], replica,
                   "counter", "Requests delivered with matches"),
            Sample("splink_serve_shed_total", summary["shed"], replica,
                   "counter", "Requests shed (all machine-readable reasons)"),
            Sample("splink_serve_batches_total", summary["batches"], replica,
                   "counter", "Engine batches dispatched"),
            Sample("splink_serve_timeouts_total", summary["timeouts"],
                   replica, "counter", "query(timeout=) cancellations"),
            Sample("splink_serve_worker_crashes_total",
                   summary["worker_crashes"], replica, "counter",
                   "Worker deaths recovered by the watchdog"),
            Sample("splink_serve_brownout_episodes_total",
                   summary["brownout_episodes"], replica, "counter",
                   "Brown-out episodes entered"),
            Sample("splink_serve_queries_per_sec",
                   summary["queries_per_sec"], replica, "gauge",
                   "Lifetime served throughput"),
            Sample("splink_serve_queue_fill",
                   (queue_len / self.queue_depth) if self.queue_depth else 0.0,
                   replica, "gauge", "Bounded-queue occupancy 0..1"),
            Sample("splink_serve_health_rank",
                   health_rank(self._health.state), replica, "gauge",
                   "0 healthy / 1 degraded / 2 broken"),
            Sample("splink_serve_breaker_open",
                   1.0 if self.breaker.state == "open" else 0.0, replica,
                   "gauge", "Circuit breaker open"),
            Sample("splink_serve_index_generation",
                   summary["index_generation"], replica, "gauge",
                   "Committed hot-swaps"),
        ]
        for q in ("p50_ms", "p95_ms", "p99_ms"):
            if q in summary:
                out.append(Sample(
                    "splink_serve_latency_ms", summary[q],
                    {**replica, "quantile": q[:-3]}, "gauge",
                    "Request latency quantiles (ms)",
                ))
        for phase, stats in self.phase_summary().items():
            # "wall" totals the real phases: keep it out of the phase label
            # so a sum over the label does not count it twice
            metric = ("splink_serve_trace_wall_ms" if phase == "wall"
                      else "splink_serve_phase_ms")
            for q in ("p50_ms", "p99_ms"):
                labels = {**replica, "quantile": q[:-3]}
                if phase != "wall":
                    labels["phase"] = phase
                out.append(Sample(
                    metric, stats[q], labels, "gauge",
                    "Traced wall latency (ms)" if phase == "wall"
                    else "Tail-latency attribution per phase (ms)",
                ))
        slo = self._slo.snapshot()
        out.append(Sample("splink_serve_slo_objective", slo["objective"],
                          replica, "gauge", "Delivery objective"))
        for window, stats in slo["windows"].items():
            labels = {**replica, "window_s": window}
            if stats["hit_rate"] is not None:
                out.append(Sample(
                    "splink_serve_slo_hit_rate", stats["hit_rate"], labels,
                    "gauge", "Rolling delivered/total per window",
                ))
            out.append(Sample(
                "splink_serve_slo_burn_rate", stats["burn_rate"], labels,
                "gauge", "Error-budget burn rate per window",
            ))
        if self._tracer.enabled:
            trace = self._tracer.snapshot()
            out.append(Sample(
                "splink_serve_traces_sampled_total", trace["sampled"],
                replica, "counter", "Requests sampled for tracing",
            ))
            for outcome, n in trace["outcomes"].items():
                out.append(Sample(
                    "splink_serve_traces_closed_total", n,
                    {**replica, "outcome": outcome}, "counter",
                    "Closed span trees by outcome",
                ))
        out.extend(self._drift_samples(replica))
        out.extend(self._perf_samples(replica))
        out.extend(process_samples())
        return out

    def _perf_samples(self, replica: dict) -> list:
        """Kernel-watch series: watch presence, the alert gauge, per-phase
        anchor/EWMA/window-p95 gauges and the per-phase execute-time
        distribution as a native Prometheus histogram with an exact
        ``_sum``."""
        from ..obs.exposition import HistogramSample, Sample

        kw = self._kwatch
        out = [Sample(
            "splink_serve_perf_watch", 1.0 if kw is not None else 0.0, replica,
            "gauge", "KernelWatch execute-latency regression monitor enabled",
        )]
        if kw is None:
            return out
        out.append(Sample(
            "splink_serve_perf_alert", 1.0 if self._perf_alert_active else 0.0,
            replica, "gauge", "Two-window execute-latency regression alert firing",
        ))
        for phase in kw.phases():
            st = kw.phase_stats(phase)
            if st is None:
                continue
            labels = {**replica, "phase": phase}
            if st["anchor_ms"] is not None:
                out.append(Sample(
                    "splink_serve_perf_anchor_ms", st["anchor_ms"], labels,
                    "gauge", "Post-warmup steady-state anchor (ms)",
                ))
            if st["ewma_ms"] is not None:
                out.append(Sample(
                    "splink_serve_perf_ewma_ms", st["ewma_ms"], labels,
                    "gauge", "Smoothed execute-time trend (ms)",
                ))
            for window in ("short", "long"):
                p95 = st[window]["p95_ms"]
                if p95 is not None:
                    out.append(Sample(
                        "splink_serve_perf_p95_ms", p95,
                        {**labels, "window": window}, "gauge",
                        "Rolling-window p95 execute time (ms)",
                    ))
            hist = kw.histogram(phase)
            if hist is not None:
                # n can exceed sum(counts): past-last-edge observations live
                # only in the +Inf bucket the renderer appends
                counts, edges, total, n = hist
                if n:
                    cum = 0
                    buckets = []
                    for c, e in zip(counts, edges):
                        cum += c
                        buckets.append((e, cum))
                    out.append(HistogramSample(
                        name="splink_serve_phase_seconds", buckets=buckets,
                        sum=total, count=n, labels=labels,
                        help="Per-phase execute-time distribution "
                             "(seconds; exact sum)",
                    ))
        return out

    def _drift_samples(self, replica: dict) -> list:
        """Drift-observatory series: reference presence, per-channel PSI
        over the short window, serve-side rates, the alert gauge and the
        served-score distribution as a NATIVE Prometheus histogram
        (``_bucket``/``_sum``/``_count`` with cumulative ``le`` bounds)."""
        from ..obs.exposition import Sample, histogram_from_counts

        drift = self.drift_snapshot()
        out = [Sample(
            "splink_serve_drift_reference",
            1.0 if drift.get("reference") else 0.0, replica, "gauge",
            "Training-reference quality profile present and sketching on",
        )]
        if not drift.get("reference"):
            return out
        out.append(Sample(
            "splink_serve_drift_alert",
            1.0 if drift.get("alerts") else 0.0, replica, "gauge",
            "Two-window PSI drift alert firing",
        ))
        short = drift.get("short") or {}
        for channel, v in sorted((short.get("channels") or {}).items()):
            if v.get("psi") is not None:
                out.append(Sample(
                    "splink_serve_drift_psi", v["psi"],
                    {**replica, "channel": channel}, "gauge",
                    "PSI of the rolling short window vs the training "
                    "reference, per channel",
                ))
        for key, metric in (
            ("oov_rate", "splink_serve_drift_oov_rate"),
            ("exact_miss_rate", "splink_serve_drift_exact_miss_rate"),
            ("approx_rate", "splink_serve_drift_approx_rate"),
        ):
            if short.get(key) is not None:
                out.append(Sample(
                    metric, short[key], replica, "gauge",
                    "Serve-side rate over the short drift window",
                ))
        if short.get("match_yield") is not None:
            out.append(Sample(
                "splink_serve_drift_match_yield", short["match_yield"],
                replica, "gauge",
                "Matched top-k pairs / served top-k pairs over the short "
                "drift window (collapse = catastrophic upstream drift)",
            ))
        monitor = self._drift
        if monitor is not None and monitor.profile is not None:
            counts = monitor.score_window_counts(monitor.window_s)
            if counts is not None and counts.sum() > 0:
                bins = monitor.profile.bins
                edges = [(i + 1) / bins for i in range(bins)]
                out.append(histogram_from_counts(
                    "splink_serve_drift_score", counts, edges, replica,
                    "Served match-probability distribution over the short "
                    "drift window (sum approximated from bin midpoints)",
                ))
        return out
