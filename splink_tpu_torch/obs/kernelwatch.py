"""KernelWatch: serve-time execute-latency regression monitor.

The port's copy of splink_tpu/obs/kernelwatch.py.

The runtime half of the performance observatory
(:mod:`..analysis.perf_audit` is the CI half): the audit catches a kernel
that got slower *before* it ships; this watches the kernels that already
shipped. It rides signals the serving tier ALREADY collects — the
per-batch wall the micro-batcher times anyway, and the
compile/execute/transfer splits the engine's :class:`~.reqtrace.PhaseProfile`
carves out of its single existing fetch rendezvous — so watching adds
**zero host syncs** to the hot path and zero device work; everything here
is host-side arithmetic on numbers that already existed.

Per phase (``batch`` / ``execute`` / ``transfer`` at serve time; stage
names on the offline path, fed by :class:`~.runtime.RunContext`):

* a **post-warmup anchor**: the first :data:`ANCHOR_SKIP` observations are
  discarded (cold caches, first-touch allocation), the median of the next
  :data:`ANCHOR_SAMPLES` becomes the phase's steady-state reference — the
  number "fast" meant when this process warmed up;
* a rolling **short window** (``perf_window_s``) and **long window** (5x)
  of raw observations, p95-summarised — the
  :class:`~.drift.DriftMonitor` two-window shape: the long window proves a
  regression matters, the short one proves it is still happening;
* an **EWMA** (the smoothed trend line the dashboards plot) and a
  log-spaced **histogram** (the native Prometheus ``_bucket`` series the
  exposition endpoint renders).

An alert fires for a phase when BOTH windows' p95 exceed
``perf_alert_ratio`` x the anchor with at least :data:`MIN_SHORT_SAMPLES`
/ :data:`MIN_LONG_SAMPLES` observations, AND the short window's MEDIAN
crosses the same threshold — the perf-audit layer's median-of-K noise
guard transplanted to the runtime tier: a kernel that got slower is
slower on *every* dispatch, so the median moves with the p95, while the
heavy-tailed scheduler jitter of a loaded host moves the p95 alone (a
2-core CI container shows clean-traffic p95 at 4-6x a single-digit-ms
anchor with the median parked AT the anchor). A single slow batch
cannot trip it, and an idle service ages out of alerting instead of
latching. The
owning service publishes edge-triggered ``perf_alert`` / ``perf_clear``
events (the alert event carries the window snapshot and dumps the flight
recorder) and periodic ``perf_window`` reports.

Pure stdlib, no numpy or torch — the obs-package convention for hot-path
adjacent code.
"""

from __future__ import annotations

import threading
import time
from collections import deque

from ..analysis import lockwatch

from .reqtrace import _quantile

#: cold observations discarded per phase before the anchor forms (first
#: dispatches pay allocator first-touch and cache warmup)
ANCHOR_SKIP = 3

#: observations whose median becomes the post-warmup anchor
ANCHOR_SAMPLES = 16

#: long window = LONG_WINDOW_FACTOR * perf_window_s (the drift-monitor
#: two-window shape)
LONG_WINDOW_FACTOR = 5

#: minimum observations in each window before a phase may alert (p95 over
#: a handful of batches is shot noise, not a regression)
MIN_SHORT_SAMPLES = 8
MIN_LONG_SAMPLES = 16

#: ring bound per phase — windows are time-pruned, this caps a pathological
#: burst (64k batches inside one long window)
MAX_SAMPLES = 65536

#: log2-spaced histogram bucket upper edges (seconds): 0.25ms .. ~8s,
#: rendered as the native Prometheus histogram by the exposition endpoint
HIST_EDGES = tuple(0.00025 * (2 ** i) for i in range(16))


class _PhaseSeries:
    """One phase's rolling state (lock owned by the parent watch)."""

    __slots__ = (
        "ring", "seen", "warm", "anchor", "ewma", "hist", "hist_sum",
        "hist_n", "total",
    )

    def __init__(self):
        self.ring: deque = deque(maxlen=MAX_SAMPLES)  # (t, seconds)
        self.seen = 0  # total observations (incl. skipped warmup)
        self.warm: list = []  # anchor candidates
        self.anchor: float | None = None  # seconds
        self.ewma: float | None = None
        self.hist = [0] * len(HIST_EDGES)
        self.hist_sum = 0.0
        self.hist_n = 0
        self.total = 0  # post-warmup observations


class KernelWatch:
    """Rolling-window execute-latency regression monitor (module
    docstring). ``alert_ratio <= 0`` disables alerting — observations,
    EWMAs and histograms still accumulate (the offline per-stage use).
    The clock is injectable so the window math is unit-testable without
    sleeping."""

    def __init__(
        self,
        *,
        window_s: float = 30.0,
        alert_ratio: float = 3.0,
        long_factor: int = LONG_WINDOW_FACTOR,
        ewma_alpha: float = 0.2,
        clock=time.monotonic,
    ):
        self.window_s = float(window_s)
        self.alert_ratio = float(alert_ratio or 0.0)
        self.long_window_s = self.window_s * long_factor
        self.ewma_alpha = float(ewma_alpha)
        self._clock = clock
        self._lock = lockwatch.new_lock("KernelWatch._lock")
        self._phases: dict[str, _PhaseSeries] = {}

    # -- feed ------------------------------------------------------------

    def observe(self, phase: str, seconds: float) -> None:
        """Fold one measured duration into the phase's windows. Host-side
        arithmetic only; never raises on non-finite input (dropped)."""
        try:
            v = float(seconds)
        except (TypeError, ValueError):
            return
        if not (v >= 0.0) or v != v:  # negative or NaN
            return
        now = self._clock()
        with self._lock:
            s = self._phases.setdefault(phase, _PhaseSeries())
            s.seen += 1
            if s.anchor is None:
                if s.seen <= ANCHOR_SKIP:
                    return  # cold sample: not anchor, not window
                s.warm.append(v)
                if len(s.warm) >= ANCHOR_SAMPLES:
                    s.warm.sort()
                    s.anchor = s.warm[len(s.warm) // 2]
                    s.warm = []
                # pre-anchor samples still enter the windows/ewma/hist:
                # the anchor only gates ALERTING, not measurement
            s.total += 1
            s.ring.append((now, v))
            horizon = now - self.long_window_s
            while s.ring and s.ring[0][0] < horizon:
                s.ring.popleft()
            s.ewma = (
                v
                if s.ewma is None
                else s.ewma + self.ewma_alpha * (v - s.ewma)
            )
            s.hist_sum += v
            s.hist_n += 1
            for i, edge in enumerate(HIST_EDGES):
                if v <= edge:
                    s.hist[i] += 1
                    break
            # past the last edge: counted in n/sum only — the exposition's
            # +Inf bucket is where it belongs (clamping it into the last
            # finite bucket would claim a 20s batch ran under 8.192s)

    # -- windows ---------------------------------------------------------

    def _window_values(self, s: _PhaseSeries, window_s: float) -> list:
        first = self._clock() - window_s
        return [v for (t, v) in s.ring if t >= first]

    def phases(self) -> list[str]:
        with self._lock:
            return sorted(self._phases)

    def phase_stats(self, phase: str) -> dict | None:
        """One phase's rolling view (ms): anchor, EWMA, short/long window
        p95 + counts. None for an unknown phase."""
        with self._lock:
            s = self._phases.get(phase)
            if s is None:
                return None
            short = self._window_values(s, self.window_s)
            long_ = self._window_values(s, self.long_window_s)
            anchor, ewma, total = s.anchor, s.ewma, s.total
        short.sort()
        long_.sort()
        return {
            "anchor_ms": _ms(anchor),
            "ewma_ms": _ms(ewma),
            "observations": total,
            "short": {
                "n": len(short),
                "p50_ms": _ms(_quantile(short, 0.50)) if short else None,
                "p95_ms": _ms(_p95(short)),
            },
            "long": {
                "n": len(long_),
                "p50_ms": _ms(_quantile(long_, 0.50)) if long_ else None,
                "p95_ms": _ms(_p95(long_)),
            },
        }

    def histogram(self, phase: str):
        """(counts, upper_edges_seconds, sum_seconds, n) for the phase's
        log-bucket histogram, or None for an unknown phase. ``n`` can
        exceed ``sum(counts)``: observations past the last edge belong to
        the exposition's +Inf bucket only."""
        with self._lock:
            s = self._phases.get(phase)
            if s is None:
                return None
            return list(s.hist), list(HIST_EDGES), s.hist_sum, s.hist_n

    # -- alerting --------------------------------------------------------

    def alerts(self, stats: dict | None = None) -> list[dict]:
        """Fired two-window regression alerts: a phase alerts when both
        the short AND long windows' p95 exceed ``alert_ratio`` x its
        post-warmup anchor with enough observations on both sides, AND
        the short window's median crosses the threshold too (the
        sustained-regression confirmation — module docstring). Empty
        when disabled, unanchored, or idle. Callers already holding
        :meth:`snapshot`'s per-phase stats pass them in to skip the
        re-aggregation."""
        if self.alert_ratio <= 0:
            return []
        if stats is None:
            stats = {p: self.phase_stats(p) for p in self.phases()}
        fired = []
        for phase, st in sorted(stats.items()):
            if not st or st["anchor_ms"] is None:
                continue
            anchor = st["anchor_ms"]
            if anchor <= 0:
                continue  # a zero-cost anchor has no meaningful ratio
            s_p95, l_p95 = st["short"]["p95_ms"], st["long"]["p95_ms"]
            s_p50 = st["short"]["p50_ms"]
            if (
                s_p95 is not None
                and l_p95 is not None
                and s_p50 is not None
                and st["short"]["n"] >= MIN_SHORT_SAMPLES
                and st["long"]["n"] >= MIN_LONG_SAMPLES
                and s_p95 >= self.alert_ratio * anchor
                and l_p95 >= self.alert_ratio * anchor
                and s_p50 >= self.alert_ratio * anchor
            ):
                fired.append(
                    {
                        "phase": phase,
                        "anchor_ms": anchor,
                        "short_p50_ms": s_p50,
                        "short_p95_ms": s_p95,
                        "long_p95_ms": l_p95,
                        "ratio": round(s_p95 / anchor, 3),
                        "threshold": self.alert_ratio,
                        "window_s": self.window_s,
                        "long_window_s": self.long_window_s,
                    }
                )
        return fired

    def snapshot(self) -> dict:
        """JSON-ready view: per-phase rolling stats + fired alerts (the
        payload the ``perf_alert`` flight dump carries)."""
        stats = {p: self.phase_stats(p) for p in self.phases()}
        return {
            "window_s": self.window_s,
            "long_window_s": self.long_window_s,
            "alert_ratio": self.alert_ratio,
            "phases": stats,
            "alerts": self.alerts(stats),
        }


def _p95(sorted_vals: list) -> float | None:
    """Nearest-rank p95 with the single largest sample excluded from rank
    eligibility: on a small window plain nearest-rank p95 IS the maximum,
    so one scheduler hiccup would read as a sustained regression — with
    the top sample ineligible, at least two observations must sit past
    the threshold before the p95 can cross it."""
    if not sorted_vals:
        return None
    n = len(sorted_vals)
    if n == 1:
        return sorted_vals[0]
    return sorted_vals[max(min(int(0.95 * n), n - 2), 0)]


def _ms(v):
    return None if v is None else round(v * 1e3, 4)
