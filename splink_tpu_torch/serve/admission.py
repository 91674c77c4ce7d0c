"""Admission control for the serving tier: deadlines, brown-out, breaker.

The port's copy of splink_tpu/serve/admission.py. A bounded queue alone
is binary — a bounded queue that sheds when
full. Production overload is rarely binary: the queue is *filling*, batch
service time is *drifting*, and requests carry their own latency budgets.
This module adds the three graduated mechanisms the service threads
through its submit/dispatch path:

* :class:`WaitEstimator` — an EWMA model of batch service time that turns
  "how many requests are ahead of me" into an estimated queue wait, so a
  request whose deadline cannot be met is rejected AT ADMISSION (cheap,
  immediate, honest) instead of timing out after consuming queue space.
* Brown-out (:func:`brownout_active`) — the tier between full service and
  shedding. Under pressure the service keeps answering, but through the
  engine's budgeted brown-out kernel: a reduced candidate capacity and a
  smaller top-k (Progressive-Blocking-style "serve the best candidates a
  budget allows" — Pan et al.), with results tagged ``degraded=True``.
* :class:`CircuitBreaker` — after N consecutive engine batch failures the
  breaker OPENS and requests fail fast as shed (no queue time wasted on a
  broken engine) while probes test recovery: the first batch after the
  cooldown — or the watchdog's synthetic engine probe when there is no
  traffic — runs half-open, and its outcome closes or re-opens the
  breaker.

Everything here is host-side bookkeeping on the request path; nothing
touches the device.
"""

from __future__ import annotations

import math
import threading
import time

from ..analysis import lockwatch

BREAKER_CLOSED = "closed"
BREAKER_OPEN = "open"
BREAKER_HALF_OPEN = "half_open"


class CircuitBreaker:
    """Consecutive-failure circuit breaker around the engine dispatch.

    ``threshold`` consecutive failures open the breaker; while open,
    :meth:`should_fail_fast` is True until ``cooldown_s`` has elapsed, at
    which point the next caller runs HALF-OPEN (one probe in flight) and
    its ``on_success``/``on_failure`` closes or re-opens the breaker.
    Thread-safe: the worker, the watchdog probe and ``health()`` all read
    it."""

    def __init__(
        self, threshold: int = 3, cooldown_s: float = 1.0, name: str = ""
    ):
        if threshold < 1:
            raise ValueError("breaker threshold must be >= 1")
        self.threshold = int(threshold)
        self.cooldown_s = float(cooldown_s)
        # which breaker this is (the wire tier runs one per remote next
        # to the engine's own; snapshots must say whose state they are)
        self.name = str(name)
        self._lock = lockwatch.new_lock("CircuitBreaker._lock")
        self._state = BREAKER_CLOSED
        self._failures = 0
        self._opened_at = 0.0
        self.opened_total = 0

    @property
    def state(self) -> str:
        with self._lock:
            return self._state

    def should_fail_fast(self) -> bool:
        """True while open and cooling down. After the cooldown the caller
        is admitted as the half-open probe (returns False exactly once per
        cooldown window; a failed probe restarts the window)."""
        with self._lock:
            if self._state == BREAKER_CLOSED:
                return False
            if self._state == BREAKER_OPEN:
                if time.monotonic() - self._opened_at >= self.cooldown_s:
                    self._state = BREAKER_HALF_OPEN
                    return False
                return True
            return False  # half-open: the probe (and its coalesced batch)

    def probe_due(self) -> bool:
        """True when open with the cooldown elapsed — the watchdog uses
        this to run a synthetic probe when no traffic is arriving."""
        with self._lock:
            return (
                self._state == BREAKER_OPEN
                and time.monotonic() - self._opened_at >= self.cooldown_s
            )

    def on_success(self) -> bool:
        """Record a successful dispatch; returns True when this CLOSED a
        previously open/half-open breaker (caller emits the event)."""
        with self._lock:
            recovered = self._state != BREAKER_CLOSED
            self._state = BREAKER_CLOSED
            self._failures = 0
            return recovered

    def on_failure(self) -> bool:
        """Record a failed dispatch; returns True when this OPENED the
        breaker (threshold reached, or a half-open probe failed)."""
        with self._lock:
            self._failures += 1
            if self._state == BREAKER_HALF_OPEN or (
                self._state == BREAKER_CLOSED
                and self._failures >= self.threshold
            ):
                self._state = BREAKER_OPEN
                self._opened_at = time.monotonic()
                self.opened_total += 1
                return True
            if self._state == BREAKER_OPEN:
                self._opened_at = time.monotonic()
            return False

    def snapshot(self) -> dict:
        with self._lock:
            return {
                **({"name": self.name} if self.name else {}),
                "state": self._state,
                "consecutive_failures": self._failures,
                "opened_total": self.opened_total,
                "threshold": self.threshold,
                "cooldown_s": self.cooldown_s,
            }


class WaitEstimator:
    """EWMA batch-service-time model -> estimated queue wait.

    ``observe(ms)`` feeds each served batch's wall time; ``estimate_wait_ms``
    answers "if I enqueue now behind ``queued`` requests, how long until
    MY batch completes": the coalescing deadline (the batcher always waits
    it out under load) plus one EWMA batch time per full batch ahead of —
    and including — this request. Batch size is deliberately not part of
    the model: bucketed dispatch pads every batch to a shape-menu bucket,
    so cost per batch is dominated by the bucket, not the occupancy.
    Before any observation the prior is deliberately modest (one
    coalescing window); admission must not reject the first requests of a
    cold service on a made-up number."""

    def __init__(self, alpha: float = 0.3, prior_ms: float = 0.0):
        self.alpha = float(alpha)
        self._lock = lockwatch.new_lock("WaitEstimator._lock")
        self._batch_ms = float(prior_ms)
        self._observed = prior_ms > 0

    def observe(self, batch_ms: float) -> None:
        with self._lock:
            if not self._observed:
                self._batch_ms = float(batch_ms)
                self._observed = True
            else:
                self._batch_ms += self.alpha * (batch_ms - self._batch_ms)

    @property
    def batch_ms(self) -> float:
        with self._lock:
            return self._batch_ms

    def estimate_wait_ms(
        self, queued: int, max_batch: int, coalesce_ms: float,
        inflight_batches: int = 0,
    ) -> float:
        """``inflight_batches`` counts batches already dispatched but not
        yet finished — a request admitted behind one waits it out before
        its own queue position even starts moving."""
        batches = math.ceil((queued + 1) / max(max_batch, 1))
        return coalesce_ms + (batches + inflight_batches) * self.batch_ms


def brownout_active(
    queue_fill: float, health_state: str, *, enabled: bool,
    fill_threshold: float = 0.5,
) -> bool:
    """The brown-out tier engages when enabled AND pressure is visible:
    the queue is past ``fill_threshold`` or the replica's health has
    already left ``healthy``. (Broken replicas still brown-out rather
    than upgrade: the breaker/shed paths decide what broken means.)"""
    if not enabled:
        return False
    if queue_fill >= fill_threshold:
        return True
    from .health import HEALTHY

    return health_state != HEALTHY
