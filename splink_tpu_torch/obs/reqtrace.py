"""The port's copy of splink_tpu/obs/reqtrace.py.

Request-level distributed tracing for the serving tier (obs v2).

The serve path is a relay: ``ReplicaRouter.submit`` -> (hedged / failover
attempts) -> ``LinkageService`` bounded queue -> batch coalescer ->
``QueryEngine`` bucketed dispatch -> delivery. Latency reservoirs and
health transitions instrument each station in aggregate, but nothing there
follows ONE request through all of them — when p99 spikes, nothing says
which phase ate the budget. This module is that thread: a trace context
``(trace_id, attempt)`` minted at the first submit, carried through every
hedge/failover attempt, marked at each phase boundary, and closed exactly
once per attempt when its future resolves (delivered / shed / discarded).

The phase partition (the attribution contract):

    admission    submit() entry -> enqueued (host bookkeeping, admission
                 control, deadline estimation)
    queue_wait   enqueued -> the worker began forming this request's batch
    coalesce     batch formation start -> batch popped (the deadline window
                 the micro-batcher holds the batch open for)
    dispatch     batch popped -> engine returned, minus the measured
                 compile/execute/transfer splits (host prep: DataFrame
                 build, encode, padding, async kernel dispatch)
    compile      kernel-library build seconds during the engine call
                 (obs.metrics delta; ZERO once the kernels are built)
    execute      device compute wait (``torch.cuda.synchronize`` on the
                 engine's device — splitting the engine's single
                 existing fetch rendezvous, NOT adding a new sync point)
    transfer     the D2H fetch of the result arrays
    deliver      engine returned -> this request's future resolved

Boundaries are clamped monotone, so the phases TELESCOPE: they sum to the
measured wall latency exactly by construction (the smoke's 5% tolerance
covers only the gap between a request's close timestamp and the service's
batch-level latency stamp). Every per-request cost is host-side
timestamping — the traced kernels are the untraced ones and the hot path
gains no host sync.

Sampling (``serve_trace_sample_rate``): 0 disables (one float compare per
submit), 1.0 traces everything, intermediate rates take every round(1/rate)-th
request deterministically — reproducible overhead, no RNG on the hot path.

Hedging correctness: every attempt of one logical request shares a
:class:`TraceRoot`; delivery CLAIMS the root under its lock, so a hedged
request whose both attempts serve yields exactly one ``delivered`` span
tree — the loser closes as ``discarded`` (and a loser the second replica
shed closes as ``shed`` with its machine-readable reason). Closed trees are
emitted as ``request_trace`` events through the ambient publisher (and into
the service's flight recorder ring), with a ``never-raise`` guard: tracing
must not take down the request it observes.
"""

from __future__ import annotations

import itertools
import logging
import os
import threading
import time
from collections import deque
from dataclasses import dataclass, field

logger = logging.getLogger("splink_tpu_torch")

# Trace ids are <process-random prefix>-<counter>: unique across processes
# (the prefix is 8 random hex chars drawn once) and ~40x cheaper to mint
# than uuid4, which pays an os.urandom syscall per request — measured at
# 40us of the close path's budget on the bench tier.
_TRACE_PREFIX = os.urandom(4).hex()
_TRACE_COUNTER = itertools.count(1)

#: The attribution partition, in timeline order.
PHASES = (
    "admission",
    "queue_wait",
    "coalesce",
    "dispatch",
    "compile",
    "execute",
    "transfer",
    "deliver",
)

#: Terminal outcomes a span tree closes with.
OUTCOMES = ("delivered", "shed", "discarded")


@dataclass
class PhaseProfile:
    """Batch-level engine splits, filled by ``QueryEngine.query_arrays``
    when a traced request is in the batch (accumulated across the batch's
    bucketed chunks). Every request in the batch waited through all of it,
    so the batch values ARE each request's wall-clock attribution."""

    compile_s: float = 0.0
    execute_s: float = 0.0
    transfer_s: float = 0.0


class TraceRoot:
    """Shared state of one logical request across its hedge/failover
    attempts: the trace id plus the first-delivery claim."""

    __slots__ = ("trace_id", "_lock", "_delivered")

    def __init__(self, trace_id: str | None = None):
        self.trace_id = (
            trace_id or f"{_TRACE_PREFIX}-{next(_TRACE_COUNTER):x}"
        )
        self._lock = threading.Lock()
        self._delivered = False

    def claim_delivery(self) -> bool:
        """True exactly once per root — the attempt that delivers first.
        Later deliveries (a hedge race where both replicas served) close
        ``discarded`` so the trace never double-counts."""
        with self._lock:
            if self._delivered:
                return False
            self._delivered = True
            return True


@dataclass
class RequestTrace:
    """One attempt's trace context: boundary marks on the monotonic clock.

    ``marks`` is written by exactly one thread at a time (submit thread,
    then the worker that owns the batch), and read only at close."""

    root: TraceRoot
    attempt: int = 0
    hedge: bool = False
    t_submit: float = field(default_factory=time.monotonic)
    marks: dict = field(default_factory=dict)
    _closed: bool = False
    #: optional hook invoked with the emitted event dict when this
    #: attempt's span tree closes. The wire tier uses it to piggyback the
    #: span on the result envelope (fleet stitching): the service resolves
    #: the future FIRST and closes the trace immediately after on the same
    #: worker thread, so the response waits microseconds for the span
    #: instead of the span missing the response. Never raises outward.
    on_close: object = field(default=None, repr=False)

    @property
    def trace_id(self) -> str:
        return self.root.trace_id

    @property
    def request_id(self) -> str:
        return f"{self.root.trace_id}.{self.attempt}"

    def mark(self, name: str) -> None:
        self.marks[name] = time.monotonic()

    def child(self, attempt: int, hedge: bool = False) -> "RequestTrace":
        """A new attempt context sharing this trace's root (the router's
        failover/hedge dispatches)."""
        return RequestTrace(root=self.root, attempt=attempt, hedge=hedge)

    def phase_durations(
        self, t_end: float, profile: PhaseProfile | None = None
    ) -> tuple[dict, float]:
        """(phases seconds, wall seconds) — the telescoping partition of
        [t_submit, t_end] described in the module docstring. Marks are
        clamped monotone so the sum equals the wall exactly; the engine
        window splits into dispatch/compile/execute/transfer using the
        batch profile (compile+execute+transfer are rescaled into the
        window if measurement jitter overshoots it, keeping the sum
        exact)."""
        m = self.marks
        t = self.t_submit
        out: dict[str, float] = {}

        def seg(phase: str, mark: str) -> None:
            nonlocal t
            if mark in m:
                nxt = m[mark] if m[mark] > t else t
                out[phase] = nxt - t
                t = nxt

        seg("admission", "admit")
        seg("queue_wait", "form")
        seg("coalesce", "pop")
        if "engine_out" in m:
            nxt = m["engine_out"] if m["engine_out"] > t else t
            window = nxt - t
            t = nxt
            c = max(profile.compile_s, 0.0) if profile else 0.0
            e = max(profile.execute_s, 0.0) if profile else 0.0
            tr = max(profile.transfer_s, 0.0) if profile else 0.0
            measured = c + e + tr
            if measured > window > 0.0:
                scale = window / measured
                c, e, tr = c * scale, e * scale, tr * scale
            elif measured > window:  # window == 0 (clock granularity)
                c = e = tr = 0.0
            out["dispatch"] = window - (c + e + tr)
            out["compile"] = c
            out["execute"] = e
            out["transfer"] = tr
        out["deliver"] = max(t_end - t, 0.0)
        return out, max(t_end - self.t_submit, 0.0)


class ServeTracer:
    """Mints, samples and closes request traces for one serving component.

    One per :class:`~..serve.service.LinkageService` (which closes every
    attempt it resolves) and one per :class:`~..serve.router.ReplicaRouter`
    (which only mints roots — the replica that resolves an attempt closes
    it through its own tracer, so flight/phase attribution lands on the
    replica that did the work)."""

    def __init__(
        self,
        sample_rate: float = 0.0,
        *,
        service: str = "serve",
        flight=None,
        reservoir: int = 4096,
    ):
        self.sample_rate = max(float(sample_rate or 0.0), 0.0)
        self.service = service
        self.flight = flight
        self._lock = threading.Lock()
        self._seq = 0
        self._stride = (
            max(int(round(1.0 / self.sample_rate)), 1)
            if 0.0 < self.sample_rate < 1.0
            else 1
        )
        self.sampled = 0
        self.outcomes: dict[str, int] = {}
        # recent delivered phase breakdowns (seconds) for phase_summary()
        self._phases: deque = deque(maxlen=reservoir)

    @property
    def enabled(self) -> bool:
        return self.sample_rate > 0.0

    def maybe_start(self) -> RequestTrace | None:
        """Mint a trace for this request, or None when it falls outside
        the sampling stride. The disabled path is one float compare."""
        if self.sample_rate <= 0.0:
            return None
        with self._lock:
            self._seq += 1
            if self.sample_rate < 1.0 and self._seq % self._stride:
                return None
            self.sampled += 1
        return RequestTrace(root=TraceRoot())

    def close(
        self,
        trace: RequestTrace | None,
        outcome: str,
        reason: str | None = None,
        profile: PhaseProfile | None = None,
        **attrs,
    ) -> dict | None:
        """Close one attempt's span tree and emit it (``request_trace``
        event + flight ring). ``outcome="delivered"`` claims the shared
        root — a lost claim (hedge race) demotes to ``discarded``. Never
        raises; returns the emitted event dict (tests), or None."""
        if trace is None:
            return None
        try:
            return self._close(trace, outcome, reason, profile, attrs)
        except Exception as e:  # noqa: BLE001 - tracing must never break serving
            logger.warning("request trace close failed: %s", e)
            return None

    def _close(self, trace, outcome, reason, profile, attrs) -> dict | None:
        if trace._closed:  # resolution races are settled by the Future;
            return None  # this is only a defensive second line
        trace._closed = True
        t_end = time.monotonic()
        if outcome == "delivered" and not trace.root.claim_delivery():
            outcome = "discarded"
        phases, wall = trace.phase_durations(t_end, profile)
        with self._lock:
            self.outcomes[outcome] = self.outcomes.get(outcome, 0) + 1
            if outcome == "delivered":
                self._phases.append((phases, wall))
        event = {
            "trace_id": trace.trace_id,
            "request_id": trace.request_id,
            "attempt": trace.attempt,
            "hedge": trace.hedge,
            "service": self.service,
            "outcome": outcome,
            "reason": reason,
            "t0": trace.t_submit,
            "wall_ms": round(wall * 1e3, 4),
            "phases_ms": {
                k: round(v * 1e3, 4) for k, v in phases.items()
            },
            **attrs,
        }
        from .events import publish

        publish("request_trace", **event)
        if self.flight is not None:
            self.flight.note_trace(dict(event, type="request_trace"))
        cb = trace.on_close
        if cb is not None:
            try:
                cb(event)
            except Exception as e:  # noqa: BLE001 - a span consumer must not break close
                logger.warning("trace on_close hook failed: %s", e)
        return event

    def phase_summary(self) -> dict:
        """p50/p99 milliseconds per phase (plus wall) over the recent
        delivered-trace reservoir — the fields bench.py's serve mode emits
        and the Prometheus endpoint exposes."""
        with self._lock:
            snap = list(self._phases)
        if not snap:
            return {}
        out: dict[str, dict] = {}
        series: dict[str, list[float]] = {"wall": []}
        for phases, wall in snap:
            series["wall"].append(wall)
            for name, v in phases.items():
                series.setdefault(name, []).append(v)
        for name, vals in series.items():
            vals.sort()
            out[name] = {
                "p50_ms": round(_quantile(vals, 0.50) * 1e3, 4),
                "p99_ms": round(_quantile(vals, 0.99) * 1e3, 4),
                "n": len(vals),
            }
        return out

    def snapshot(self) -> dict:
        with self._lock:
            return {
                "sample_rate": self.sample_rate,
                "sampled": self.sampled,
                "outcomes": dict(self.outcomes),
            }


def _quantile(sorted_vals: list[float], q: float) -> float:
    """Nearest-rank quantile over an already-sorted list (stdlib-only —
    the obs package never imports numpy or torch at module scope)."""
    if not sorted_vals:
        return 0.0
    idx = min(int(q * len(sorted_vals)), len(sorted_vals) - 1)
    return sorted_vals[idx]
