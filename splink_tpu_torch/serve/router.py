"""The port's copy of splink_tpu/serve/router.py.

Replica routing: health-aware dispatch, failover, hedged requests.

One :class:`~.service.LinkageService` is one replica. Production traffic
wants N of them — separate worker threads today, separate hosts once the
front-end speaks a wire protocol — and a front-end that (1) routes each
request to the healthiest replica, (2) fails over when a replica sheds or
breaks, and (3) optionally HEDGES: re-dispatches a slow request to a
second replica after a delay, first result wins. Hedging is the classic
tail-latency cut (Dean & Barroso, "The Tail at Scale"): a p95-derived
delay means ~5% of requests cost a duplicate dispatch and the p99 stops
being hostage to one stalled replica.

Routing order ranks replicas by their health state (healthy < degraded <
broken — :mod:`.health`) and round-robins within a rank, so load spreads
across healthy replicas and a broken replica is only ever tried as the
last resort. Failover is result-driven: any shed result (closed, breaker
open, queue full, worker restart...) forwards the request to the next
replica in the order; the requester sees ONE future that resolves with
the first non-shed result, or — only when every replica shed — the last
shed result. Exceptions never propagate through the returned future (the
same contract the service makes).

The router is duck-typed over its replicas: anything with ``submit(record,
deadline_ms=) -> Future[QueryResult]``, ``health_state`` and
``latency_summary()`` routes — the unit tests drive it with fakes, and a
future multi-host front-end can wrap RPC stubs in the same shape.
"""

from __future__ import annotations

import logging
import threading
import time
from typing import Protocol, runtime_checkable

from ..analysis import lockwatch

from .health import health_rank

logger = logging.getLogger("splink_tpu_torch")

_DEFAULT_HEDGE_FLOOR_MS = 20.0


@runtime_checkable
class Replica(Protocol):
    """The replica duck-type, pinned.

    Three implementations ride this shape and must not drift apart:
    :class:`~.service.LinkageService` (in-process),
    :class:`~.remote.RemoteReplica` (another host over the wire tier),
    and the test fakes the router's unit suite drives failover with —
    ``tests/test_torch_router.py`` asserts conformance for all three.

    The contract behind the signatures:

    * ``submit`` NEVER raises and the returned future ALWAYS resolves —
      with a :class:`~.service.QueryResult`, shed results carrying a
      machine-readable ``reason``. (The router treats a raising replica
      as a shed, but that is a mercy, not a licence.)
    * ``health_state`` is a cheap property (``healthy`` / ``degraded`` /
      ``broken``) read on every routing decision — no locks held long,
      no I/O.
    * ``latency_summary()`` reports at least ``p95_ms`` once it has
      samples (the hedger's trigger delay keys on it).

    Two optional members extend the shape without breaking it: a
    truthy class attribute ``accepts_trace`` admits the router-minted
    ``trace=`` keyword on submit, and ``close()`` lets
    :meth:`ReplicaRouter.close` tear the replica down.
    """

    def submit(self, record: dict, deadline_ms: float | None = None):
        """-> Future[QueryResult]; never raises, always resolves."""
        ...  # pragma: no cover - Protocol signature

    @property
    def health_state(self) -> str:
        ...  # pragma: no cover - Protocol signature

    def latency_summary(self) -> dict:
        ...  # pragma: no cover - Protocol signature


class ReplicaRouter:
    """Health-aware front-end over N replica services (module docstring).

    ``hedge_ms`` — ``None``: read ``serve_hedge_ms`` from the first
    replica's settings (0 disables); a number: fixed hedge delay in ms;
    ``"p95"``: derive per request from the primary replica's measured p95
    (floor ``_DEFAULT_HEDGE_FLOOR_MS`` while the reservoir is cold).
    """

    def __init__(self, replicas, *, hedge_ms=None, telemetry=None,
                 trace_sample_rate=None, incident_reporter=None):
        from ..obs.reqtrace import ServeTracer

        self._replicas = list(replicas)
        if not self._replicas:
            raise ValueError("ReplicaRouter needs at least one replica")
        first = self._replicas[0]
        settings = getattr(
            getattr(getattr(first, "engine", None), "index", None),
            "settings",
            {},
        ) or {}
        if hedge_ms is None:
            hedge_ms = settings.get("serve_hedge_ms", 0) or 0
        self.hedge_ms = hedge_ms
        # Request tracing (obs v2): the router MINTS the trace context —
        # one trace_id per logical request, one attempt per replica
        # dispatch (primary / failover / hedge) — and each replica closes
        # the attempts it resolves through its own tracer, so phase
        # attribution lands on the replica that did the work. The shared
        # TraceRoot guarantees exactly one `delivered` span tree per
        # request even when a hedge race serves it twice.
        if trace_sample_rate is None:
            trace_sample_rate = settings.get("serve_trace_sample_rate", 0.0)
        self._tracer = ServeTracer(trace_sample_rate or 0.0, service="router")
        self._obs = telemetry
        # optional FleetIncidentReporter (obs/fleet.py): the router feeds
        # it hedge dispatches so a hedge STORM — every primary slow at
        # once — triggers a correlated incident bundle
        self._incident = incident_reporter
        self._lock = lockwatch.new_lock("ReplicaRouter._lock")
        self._rr = 0
        self.dispatched = 0
        self.hedges = 0
        self.hedge_wins = 0
        self.failovers = 0

    def _bump(self, counter: str) -> None:
        """Increment a router counter under the lock: counters are hit
        from timer threads and replica done-callback threads, and ``+=``
        is not atomic."""
        with self._lock:
            setattr(self, counter, getattr(self, counter) + 1)

    # -- routing order --------------------------------------------------

    def _ordered(self) -> list:
        """Replicas ranked healthy < degraded < broken, round-robin within
        a rank (the rotation point advances per request)."""
        with self._lock:
            start = self._rr
            self._rr += 1
        n = len(self._replicas)
        rotated = [self._replicas[(start + i) % n] for i in range(n)]
        return sorted(
            rotated,
            key=lambda svc: health_rank(getattr(svc, "health_state", "broken")),
        )

    def _hedge_delay_ms(self, primary) -> float | None:
        if not self.hedge_ms or len(self._replicas) < 2:
            return None
        if self.hedge_ms == "p95":
            try:
                p95 = primary.latency_summary().get("p95_ms")
            except Exception:  # noqa: BLE001 - a fake replica may not report
                p95 = None
            return max(float(p95 or 0.0), _DEFAULT_HEDGE_FLOOR_MS)
        return float(self.hedge_ms)

    # -- request path ---------------------------------------------------

    def submit(self, record: dict, deadline_ms: float | None = None):
        """Dispatch one record; returns a Future[QueryResult] that never
        raises: first non-shed replica result wins, shed results fail
        over, the hedge timer (when enabled) races a second replica."""
        order = self._ordered()
        call = _HedgedCall(
            self, order, record, deadline_ms, self._hedge_delay_ms(order[0]),
            trace=self._tracer.maybe_start(),
        )
        call.start()
        return call.out

    def query(
        self,
        record: dict,
        timeout: float | None = None,
        deadline_ms: float | None = None,
    ):
        """Submit and wait. On timeout the caller gets a shed result; the
        per-replica timeout bookkeeping lives in each service."""
        from .service import QueryResult

        fut = self.submit(record, deadline_ms=deadline_ms)
        try:
            return fut.result(timeout=timeout)
        except Exception:  # noqa: BLE001 - the router future never raises by contract
            return QueryResult(shed=True, reason="timeout")

    # -- introspection / lifecycle --------------------------------------

    def health(self) -> dict:
        """Per-replica health snapshots plus the router's own counters."""
        replicas = []
        for svc in self._replicas:
            try:
                replicas.append(svc.health())
            except Exception as e:  # noqa: BLE001 - a dead replica still reports
                replicas.append({"state": "broken", "error": str(e)})
        return {
            "replicas": replicas,
            "dispatched": self.dispatched,
            "hedges": self.hedges,
            "hedge_wins": self.hedge_wins,
            "failovers": self.failovers,
        }

    def close(self) -> None:
        """Close every replica that exposes ``close()`` (convenience for
        single-process deployments that own their replicas)."""
        for svc in self._replicas:
            close = getattr(svc, "close", None)
            if close is not None:
                close()


class _HedgedCall:
    """One routed request: sequential failover over the ranked replicas,
    plus at most one time-triggered hedge dispatch. Thread-safe; the
    ``out`` future resolves exactly once."""

    def __init__(self, router, order, record, deadline_ms, hedge_delay_ms,
                 trace=None):
        from concurrent.futures import Future

        self.router = router
        self.order = order
        self.record = record
        self.deadline_ms = deadline_ms
        self.hedge_delay_ms = hedge_delay_ms
        self.trace = trace  # shared-root context; one child per attempt
        self.out: Future = Future()
        self._lock = lockwatch.new_lock("_HedgedCall._lock")
        self._next = 0
        self._inflight = 0
        self._hedge_idx = None  # the exact attempt index the hedge dispatched
        self._last_shed = None
        # the resolution claim: flipped exactly once, under _lock, by the
        # attempt that wins the right to resolve ``out`` — set_result
        # itself then runs OUTSIDE the lock (done-callbacks are foreign
        # code and must not execute under it)
        self._resolved = False
        self._timer: threading.Timer | None = None
        self._t0 = time.monotonic()

    def start(self) -> None:
        self._dispatch_next()
        timer = None
        with self._lock:
            # arm under the lock: the first attempt may resolve on another
            # thread before we get here, and ITS cancel must see the timer
            if (
                self.hedge_delay_ms is not None
                and not self._resolved
                and self._next < len(self.order)
            ):
                timer = threading.Timer(
                    self.hedge_delay_ms / 1000.0, self._hedge
                )
                timer.daemon = True
                self._timer = timer
        if timer is not None:
            timer.start()

    def _dispatch_next(self, hedge: bool = False) -> int | None:
        """Dispatch to the next replica in the order; returns its attempt
        index, or None when exhausted / already resolved. ``hedge`` tags
        the attempt as THE hedge dispatch before its callback can run, so
        the win accounting cannot race a synchronously resolving
        replica."""
        with self._lock:
            if self._resolved or self._next >= len(self.order):
                return None
            idx = self._next
            self._next += 1
            self._inflight += 1
            if hedge:
                self._hedge_idx = idx
            svc = self.order[idx]
        self.router._bump("dispatched")
        # trace propagation is duck-typed like the replicas themselves:
        # only a replica that declares `accepts_trace` (LinkageService, or
        # a future RPC stub that forwards the context) receives the
        # attempt; fakes and plain replicas keep the plain signature
        att = None
        if self.trace is not None and getattr(svc, "accepts_trace", False):
            att = self.trace.child(attempt=idx, hedge=hedge)
        try:
            if att is not None:
                fut = svc.submit(
                    self.record, deadline_ms=self.deadline_ms, trace=att
                )
            else:
                fut = svc.submit(self.record, deadline_ms=self.deadline_ms)
        except Exception as e:  # noqa: BLE001 - a throwing replica is a shed
            logger.warning("replica submit failed, failing over: %s", e)
            self.router._tracer.close(att, "shed", reason="submit_error")
            self._finish_attempt(idx, None)
            return idx
        fut.add_done_callback(lambda f, i=idx: self._on_done(i, f))
        return idx

    def _hedge(self) -> None:
        if self.out.done():
            return
        if self._dispatch_next(hedge=True) is not None:
            self.router._bump("hedges")
            reporter = self.router._incident
            if reporter is not None:
                # outside every lock: note_hedge may trigger a bundle
                # thread and must not serialize the hedge timer
                reporter.note_hedge()

    def _on_done(self, idx: int, fut) -> None:
        try:
            res = fut.result()
        except Exception as e:  # noqa: BLE001 - replica futures should not raise
            logger.warning("replica future raised (treated as shed): %s", e)
            res = None
        self._finish_attempt(idx, res)

    def _finish_attempt(self, idx: int, res) -> None:
        # Decide under the lock, act after releasing it: the winner claims
        # `_resolved` inside the critical section, then resolves `out`
        # (whose done-callbacks may grab the router's counter lock or run
        # user code) and cancels the timer with no lock held.
        win = hedge_won = False
        timer = None
        with self._lock:
            self._inflight -= 1
            if self._resolved:
                return
            if res is not None and not res.shed:
                self._resolved = True
                win = True
                hedge_won = idx == self._hedge_idx  # the hedge itself won
                timer = self._timer
            else:
                if res is not None:
                    self._last_shed = res
                exhausted = self._next >= len(self.order)
                settle = exhausted and self._inflight == 0
        if win:
            self.out.set_result(res)
            if timer is not None:
                timer.cancel()
            if hedge_won:
                self.router._bump("hedge_wins")
            return
        if not exhausted:
            self.router._bump("failovers")
            if self._dispatch_next() is None:
                with self._lock:
                    settle = self._inflight == 0 and not self._resolved
        if not settle:
            return
        from .service import QueryResult

        with self._lock:
            if self._resolved:  # lost the settle race to a late winner
                return
            self._resolved = True
            last = self._last_shed or QueryResult(shed=True, reason="no_replica")
            timer = self._timer
        self.out.set_result(last)
        if timer is not None:
            timer.cancel()
