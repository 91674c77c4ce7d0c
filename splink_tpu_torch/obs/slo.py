"""SLO layer: rolling deadline-hit-rate objectives + multi-window burn rate.

The port's copy of splink_tpu/obs/slo.py.

A latency reservoir answers "how fast were we"; an SLO answers "are we
keeping the promise, and how fast are we spending the error budget". The
serving tier's promise is delivery: a submitted request either resolves
with matches (good) or is shed / times out (bad — every shed reason counts
against the budget, because the caller did not get an answer). The
:class:`SLOTracker` folds that stream into:

* a **rolling hit rate** per window (good / total over the trailing W
  seconds), and
* the **burn rate** per window — ``(bad/total) / (1 - objective)`` — the
  standard SRE multi-window measure: burn rate 1.0 spends exactly the
  error budget over the objective period; 14.4 over a 5-minute window is
  the classic "page now" threshold.

Implementation is a time-bucketed ring (1-second buckets by default,
bounded by the longest window), pure stdlib, O(1) per observation and
O(buckets) per query — cheap enough to sit on the delivery path of every
request, sampled or not. The clock is injectable so the burn-rate math is
unit-testable without sleeping.

Surfaced through :meth:`LinkageService.slo_snapshot`, the Prometheus
exposition endpoint (``splink_serve_slo_*`` series) and ``obs serve-dash``.
"""

from __future__ import annotations

import math
import threading
import time
from collections import deque

from ..analysis import lockwatch

#: (long_window_s, short_window_s, burn_threshold) pairs for the classic
#: two-window alert: fire only when BOTH windows burn past the threshold
#: (the long window proves it matters, the short one proves it is still
#: happening). Values follow the SRE-workbook 99.9% ladder, scaled to the
#: windows this tracker keeps by default.
DEFAULT_ALERT_PAIRS = (
    (300.0, 60.0, 14.4),  # fast burn: page
    (1800.0, 300.0, 6.0),  # slow burn: ticket
)


class SLOTracker:
    """Rolling good/bad counts -> hit rate and burn rate per window."""

    def __init__(
        self,
        objective: float = 0.999,
        windows: tuple = (60.0, 300.0, 1800.0),
        bucket_s: float = 1.0,
        clock=time.monotonic,
    ):
        if not 0.0 < objective < 1.0:
            raise ValueError(f"objective must be in (0, 1), got {objective}")
        self.objective = float(objective)
        self.windows = tuple(float(w) for w in windows)
        if not self.windows:
            raise ValueError("SLOTracker needs at least one window")
        self.bucket_s = float(bucket_s)
        self._clock = clock
        self._lock = lockwatch.new_lock("SLOTracker._lock")
        # ring of [bucket_index, good, bad], ascending bucket index
        self._buckets: deque = deque()
        self._max_buckets = (
            int(math.ceil(max(self.windows) / self.bucket_s)) + 1
        )
        self.total_good = 0
        self.total_bad = 0

    def observe(self, ok: bool, n: int = 1) -> None:
        """Record ``n`` delivered (ok) or shed (not ok) requests."""
        idx = int(self._clock() / self.bucket_s)
        with self._lock:
            if self._buckets and self._buckets[-1][0] == idx:
                slot = self._buckets[-1]
            else:
                slot = [idx, 0, 0]
                self._buckets.append(slot)
                while (
                    len(self._buckets) > 1
                    and self._buckets[0][0] <= idx - self._max_buckets
                ):
                    self._buckets.popleft()
            if ok:
                slot[1] += n
                self.total_good += n
            else:
                slot[2] += n
                self.total_bad += n

    def _window_counts(self, window_s: float) -> tuple[int, int]:
        """(good, bad) over the trailing ``window_s`` seconds."""
        now_idx = int(self._clock() / self.bucket_s)
        first = now_idx - int(math.ceil(window_s / self.bucket_s)) + 1
        good = bad = 0
        with self._lock:
            for idx, g, b in self._buckets:
                if idx >= first:
                    good += g
                    bad += b
        return good, bad

    def hit_rate(self, window_s: float) -> float | None:
        """Good / total over the window, or None with no samples (an idle
        service is not in violation)."""
        good, bad = self._window_counts(window_s)
        total = good + bad
        return (good / total) if total else None

    def burn_rate(self, window_s: float) -> float:
        """Error-budget spend rate over the window: 1.0 = spending exactly
        the budget, >1 = overspending. 0.0 with no samples."""
        good, bad = self._window_counts(window_s)
        total = good + bad
        if not total:
            return 0.0
        return (bad / total) / (1.0 - self.objective)

    def alerts(self, pairs=DEFAULT_ALERT_PAIRS) -> list[dict]:
        """Fired multi-window alerts: both the long and the short window
        must burn past the pair's threshold (module docstring)."""
        fired = []
        for long_w, short_w, threshold in pairs:
            b_long = self.burn_rate(long_w)
            b_short = self.burn_rate(short_w)
            if b_long >= threshold and b_short >= threshold:
                fired.append(
                    {
                        "long_window_s": long_w,
                        "short_window_s": short_w,
                        "threshold": threshold,
                        "long_burn": round(b_long, 3),
                        "short_burn": round(b_short, 3),
                    }
                )
        return fired

    def snapshot(self) -> dict:
        """JSON-ready view: objective, lifetime totals, per-window hit and
        burn rates, fired alerts."""
        windows = {}
        for w in self.windows:
            good, bad = self._window_counts(w)
            total = good + bad
            windows[str(int(w))] = {
                "total": total,
                "bad": bad,
                "hit_rate": round(good / total, 6) if total else None,
                "burn_rate": round(
                    (bad / total) / (1.0 - self.objective), 4
                )
                if total
                else 0.0,
            }
        # totals under the lock: observe() bumps both concurrently and a
        # scrape mid-bump must not report a torn good/bad pair
        with self._lock:
            total_good = self.total_good
            total_bad = self.total_bad
        return {
            "objective": self.objective,
            "error_budget": round(1.0 - self.objective, 6),
            "total_good": total_good,
            "total_bad": total_bad,
            "windows": windows,
            "alerts": self.alerts(),
        }

    def export(self) -> dict:
        """JSON-serialisable bucket-ring export for metric federation
        (obs/fleet.py): the raw ``[bucket_index, good, bad]`` ring plus
        the tracker's shape. Buckets are integer counts keyed by absolute
        bucket index, so N hosts' exports merge by per-index addition into
        exactly the ring one tracker over the union of observations would
        hold (:func:`merge_exports`) — provided the hosts share a clock
        domain, which federation's per-connection offset estimate
        corrects for at bucket granularity."""
        with self._lock:
            buckets = [list(b) for b in self._buckets]
            total_good = self.total_good
            total_bad = self.total_bad
        return {
            "objective": self.objective,
            "bucket_s": self.bucket_s,
            "windows": list(self.windows),
            "buckets": buckets,
            "total_good": total_good,
            "total_bad": total_bad,
        }


def merge_exports(exports: list[dict]) -> dict | None:
    """Merge N :meth:`SLOTracker.export` payloads (deterministic input
    order) into one federated view: buckets add per index, totals add,
    and the per-window hit/burn rates are recomputed over the merged ring
    relative to its newest bucket. Exports with mismatched ``bucket_s``
    merge on the first export's bucket size (indices are absolute, so a
    mismatch only coarsens attribution, never double-counts). Returns
    None for an empty input."""
    exports = [e for e in exports if e]
    if not exports:
        return None
    objective = float(exports[0].get("objective") or 0.999)
    bucket_s = float(exports[0].get("bucket_s") or 1.0)
    windows = exports[0].get("windows") or [60.0, 300.0, 1800.0]
    merged: dict[int, list[int]] = {}
    total_good = total_bad = 0
    for e in exports:
        total_good += int(e.get("total_good") or 0)
        total_bad += int(e.get("total_bad") or 0)
        for idx, good, bad in e.get("buckets") or []:
            slot = merged.setdefault(int(idx), [0, 0])
            slot[0] += int(good)
            slot[1] += int(bad)
    now_idx = max(merged) if merged else 0
    out_windows = {}
    for w in windows:
        first = now_idx - int(math.ceil(float(w) / bucket_s)) + 1
        good = sum(g for idx, (g, _) in merged.items() if idx >= first)
        bad = sum(b for idx, (_, b) in merged.items() if idx >= first)
        total = good + bad
        out_windows[str(int(w))] = {
            "total": total,
            "bad": bad,
            "hit_rate": round(good / total, 6) if total else None,
            "burn_rate": round((bad / total) / (1.0 - objective), 4)
            if total
            else 0.0,
        }
    return {
        "objective": objective,
        "bucket_s": bucket_s,
        "hosts": len(exports),
        "total_good": total_good,
        "total_bad": total_bad,
        "windows": out_windows,
    }
