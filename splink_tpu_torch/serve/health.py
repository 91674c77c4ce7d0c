"""Per-replica serving health: a hysteretic state machine over obs signals.

The port's copy of splink_tpu/serve/health.py.

A replica is more than "up or down". Between those poles sits the state
every production incident actually lives in: the queue is filling, sheds
are climbing, p95 is drifting, a compile stall just ate half a second of
the latency budget. This module folds those signals — all of them already
measured by the service/obs layers, nothing new is instrumented — into ONE
discrete state per replica:

    healthy ──► degraded ──► broken
       ▲            ▲            │
       └────────────┴────────────┘  (recovery, hysteretic)

Transitions DOWN (toward broken) are immediate: a dead worker or an open
circuit breaker must be routed around on the very next request.
Transitions UP require ``recover_ticks`` consecutive evaluations at the
better level — hysteresis, so a replica oscillating around a threshold
does not flap the router. Recovery climbs one level per satisfied streak
(broken → degraded → healthy), mirroring how operators actually re-admit
a replica: first let it take degraded-tier traffic, then full traffic.

Every transition publishes a structured ``health`` event through the
ambient obs channel (:func:`..obs.events.publish`), so the JSONL record of
a chaotic run reads as a timeline: fault → degradation → health drop →
recovery. :meth:`LinkageService.health` (service.py) is the live endpoint
over this monitor; :class:`..serve.router.ReplicaRouter` routes on it.
"""

from __future__ import annotations

import threading
import time

from ..analysis import lockwatch

HEALTHY = "healthy"
DEGRADED = "degraded"
BROKEN = "broken"

_RANK = {HEALTHY: 0, DEGRADED: 1, BROKEN: 2}
_STATES = (HEALTHY, DEGRADED, BROKEN)


class HealthMonitor:
    """One replica's health state machine (module docstring).

    ``evaluate(signals)`` classifies one snapshot of the replica's signals
    and advances the state machine; it is cheap (pure host Python) and is
    driven by the service watchdog tick plus on-demand ``health()`` calls.

    Signals (all optional; missing keys read as their benign value):

    ``worker_alive``   bool — the micro-batching worker thread is running
    ``breaker``        "closed" | "open" | "half_open"
    ``queue_fill``     0..1 — bounded-queue occupancy
    ``shed_rate``      0..1 — sheds / (sheds + served) over the window
    ``p95_ms``         recent-window p95 latency (None = no samples)
    ``compile_stall``  bool — steady-state compile time observed (the
                       zero-recompile contract broke, or an unwarmed
                       shape slipped through)
    ``brownout``       bool — the service is in the brown-out tier.
                       Informational only (kept in the snapshot, NOT
                       classified): brown-out is an OUTPUT of pressure,
                       and since degraded health is itself a brown-out
                       trigger, classifying it would make the degraded
                       state self-sustaining after the pressure clears.
    """

    def __init__(
        self,
        *,
        name: str = "replica",
        degraded_queue_fill: float = 0.5,
        degraded_shed_rate: float = 0.02,
        broken_shed_rate: float = 0.5,
        degraded_p95_ms: float | None = None,
        recover_ticks: int = 3,
    ):
        self.name = name
        self.degraded_queue_fill = float(degraded_queue_fill)
        self.degraded_shed_rate = float(degraded_shed_rate)
        self.broken_shed_rate = float(broken_shed_rate)
        self.degraded_p95_ms = degraded_p95_ms
        self.recover_ticks = int(recover_ticks)
        self._lock = lockwatch.new_lock("HealthMonitor._lock")
        self._state = HEALTHY
        self._since = time.monotonic()
        self._better_streak = 0
        self._transitions = 0
        self._last_signals: dict = {}
        self._last_reasons: list[str] = []

    # -- classification --------------------------------------------------

    def classify(self, signals: dict) -> tuple[str, list[str]]:
        """(level, reasons) for one signals snapshot, ignoring hysteresis."""
        reasons: list[str] = []
        if not signals.get("worker_alive", True):
            reasons.append("worker thread dead")
        if signals.get("breaker") == "open":
            reasons.append("circuit breaker open")
        shed_rate = float(signals.get("shed_rate") or 0.0)
        if shed_rate >= self.broken_shed_rate:
            reasons.append(
                f"shed rate {shed_rate:.2f} >= {self.broken_shed_rate:.2f}"
            )
        if reasons:
            return BROKEN, reasons
        if signals.get("breaker") == "half_open":
            reasons.append("circuit breaker probing recovery")
        if shed_rate > self.degraded_shed_rate:
            reasons.append(
                f"shed rate {shed_rate:.2f} > {self.degraded_shed_rate:.2f}"
            )
        fill = float(signals.get("queue_fill") or 0.0)
        if fill >= self.degraded_queue_fill:
            reasons.append(
                f"queue {fill:.0%} full >= {self.degraded_queue_fill:.0%}"
            )
        if signals.get("compile_stall"):
            reasons.append("steady-state compile stall")
        p95 = signals.get("p95_ms")
        if (
            self.degraded_p95_ms is not None
            and isinstance(p95, (int, float))
            and p95 > self.degraded_p95_ms
        ):
            reasons.append(
                f"p95 {p95:.1f}ms > {self.degraded_p95_ms:.1f}ms"
            )
        if reasons:
            return DEGRADED, reasons
        return HEALTHY, reasons

    # -- state machine ---------------------------------------------------

    def evaluate(self, signals: dict) -> str:
        """Advance the state machine with one snapshot; returns the state.

        Worse observations transition immediately; better ones must hold
        for ``recover_ticks`` consecutive evaluations and then improve the
        state ONE level (hysteretic recovery, module docstring)."""
        level, reasons = self.classify(signals)
        with self._lock:
            self._last_signals = dict(signals)
            self._last_reasons = reasons
            old = self._state
            if _RANK[level] > _RANK[old]:
                new = level
                self._better_streak = 0
            elif _RANK[level] < _RANK[old]:
                self._better_streak += 1
                if self._better_streak >= self.recover_ticks:
                    new = _STATES[_RANK[old] - 1]
                    self._better_streak = 0
                else:
                    new = old
            else:
                self._better_streak = 0
                new = old
            if new != old:
                self._state = new
                self._since = time.monotonic()
                self._transitions += 1
        if new != old:
            from ..obs.events import publish

            publish(
                "health",
                replica=self.name,
                **{"from": old, "to": new},
                reasons=reasons,
                signals={
                    k: v for k, v in signals.items() if not callable(v)
                },
            )
        return new

    @property
    def state(self) -> str:
        with self._lock:
            return self._state

    def snapshot(self) -> dict:
        """JSON-ready view: state, time in state, last signals/reasons."""
        with self._lock:
            return {
                "replica": self.name,
                "state": self._state,
                "since_s": round(time.monotonic() - self._since, 3),
                "transitions": self._transitions,
                "reasons": list(self._last_reasons),
                "signals": dict(self._last_signals),
            }


def health_rank(state: str) -> int:
    """healthy=0 < degraded=1 < broken=2 (router ordering key)."""
    return _RANK.get(state, _RANK[BROKEN])


def worse(a: str, b: str) -> str:
    """The sicker of two states (max by rank; unknown reads as broken).

    The wire tier folds two views into one replica state with it: the
    remote's piggybacked self-assessment and the local link view — a
    healthy host behind a dead link is still unreachable, and a reachable
    host that reports degraded must not be promoted by the link being
    fine (:class:`~.remote.RemoteReplica.health_state`)."""
    return a if health_rank(a) >= health_rank(b) else b
