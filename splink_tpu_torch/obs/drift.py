"""Serve-time drift sketches and PSI / Jensen-Shannon drift scoring: the
port of splink_tpu/obs/drift.py.

A :class:`~.quality.QualityProfile` (captured at ``build_index``) records
the training distribution. At serve time every full-service batch folds a
small device-side sketch onto the engine's top-k outputs, still on the
card:

  * :func:`make_sketch_fn` re-reads the winning (query, reference) rows
    (the per-pair gamma levels never left the fused scoring path, and Q x k
    pairs is small next to the Q x capacity it scored), recomputes their
    gamma levels through the shared ``gammas._spec_gamma`` (on a card: the
    dense Jaro-Winkler and Levenshtein CUDA kernels, eager ops for the
    other kinds) and adds their level and score counts into a device int64
    accumulator (``quality.sentinel_histogram``, one ``torch.histc``);
  * nothing is read back: the served batch gains no device-to-host sync.
    The sketch launches on the stream that scored the batch, after it, so
    the query upload and top-k tensors it reads are still live and in
    order;
  * host-side rates that never touch the device (bucket-miss/OOV queries,
    null keys, approx-fallback and brown-out serves, per-column query null
    counts) accumulate beside it from the already-encoded ``QueryBatch``.

The accumulator **drains** between batches (the service worker, or the
watchdog when idle, at ~window/4 cadence) into a time-bucketed ring, and
:class:`DriftMonitor` scores rolling windows against the reference
profile: **PSI** per channel (one per comparison column's gamma-level
distribution, one for the score histogram; < 0.1 stable, 0.1-0.25 moderate
shift, > 0.25 action), **Jensen-Shannon divergence** per channel (base 2,
in [0, 1]), and **two-window alerts**: a PSI alert fires only when the
short window (``drift_window_s``) and the long window (5x) both exceed
``drift_alert_psi``, and a ``match_yield`` collapse alert fires when the
short window's matched yield drops :data:`YIELD_COLLAPSE_FACTOR` x below
the long window's. Alert transitions publish ``drift_alert`` events and
trigger a flight-recorder dump.

Both sides condition on the match population (pairs with match
probability >= ``quality.MATCH_PROBABILITY``): serving returns top-k
matches, and comparing them with the all-pairs training distribution
(mostly non-matches) would read as drift on a clean stream.
"""

from __future__ import annotations

import logging
import time
from collections import deque

from ..analysis import lockwatch

import numpy as np

logger = logging.getLogger("splink_tpu_torch")

#: long window = LONG_WINDOW_FACTOR * drift_window_s (two-window alerts)
LONG_WINDOW_FACTOR = 5

#: proportion floor for PSI/JS smoothing (a bin empty on one side must not
#: produce an infinite statistic)
PSI_EPS = 1e-4
# identity floor under the log/log2 in psi()/js_divergence(): the eps
# smoothing keeps every ratio >> tiny, so this never changes a value —
# it pins the statistics finite even if a caller passes eps=0
_LOG_TINY = float(np.finfo(np.float64).tiny)

#: drains per short window (the ring's bucket cadence)
DRAINS_PER_WINDOW = 4

#: the match-yield collapse alert: fires when the short window's matched
#: yield (matched top-k pairs / served top-k pairs) drops below the long
#: window's yield divided by this factor. The catch-all for catastrophic
#: upstream drift: when served queries stop producing matches at all, the
#: match-conditioned PSI channels go DARK (nothing to histogram) — the
#: collapse of the yield itself is then the drift signal.
YIELD_COLLAPSE_FACTOR = 4.0

#: minimum served top-k pairs in the long window before a yield-collapse
#: alert may fire (a near-idle service must not alert on noise)
YIELD_MIN_SERVED = 64

#: minimum matched pairs in the short window before a PSI channel may
#: alert. PSI over a handful of pairs is sampling noise, not drift: a
#: reference-mass level that a small clean sample simply failed to draw
#: contributes ~|p|*ln(p/eps) all by itself, so a near-idle service
#: would alert on its own shot noise. Windows are still SCORED below the
#: floor (snapshot/exposition show the PSI); only alerting is gated —
#: the match_yield collapse alert keeps its own YIELD_MIN_SERVED floor.
PSI_MIN_PAIRS = 256


def make_sketch_fn(layout: dict, comparison_columns, bins: int):
    """The device sketch update:
    ``(acc, packed_q, packed_ref, top_rows, top_valid, top_p) -> acc``.

    Recomputes the gamma levels of the top-k winners through the SAME
    shared ``_spec_gamma`` comparison bodies the scoring used (two row
    reads: the padded query matrix repeated k-wide, one reference gather
    of the winning rows) and adds per-column gamma-level counts plus the
    score histogram into the flat int64 accumulator. Layout: C blocks of
    W = max(num_levels) + 1 gamma bins (bin 0 = null), then ``bins``
    MATCHED score bins, then ``bins`` ALL-SERVED score bins. The gamma
    blocks and the first score block count only slots that are valid AND
    matched (match probability >= ``quality.MATCH_PROBABILITY``); the
    trailing score block counts every valid slot. Every other index goes
    to the sentinel ``size``, one bin past the end, which is not counted:
    padding rows (``top_valid`` false) never reach a histogram, and no
    index is out of range (on CUDA an out-of-range scatter is a
    device-side assert, so nothing is clamped). Nothing is read back to
    the host."""
    import torch

    from ..gammas import PairContext, _spec_gamma
    from .quality import MATCH_PROBABILITY, sentinel_histogram

    cols = tuple(comparison_columns)
    levels = tuple(int(c["num_levels"]) for c in cols)
    n_cols = len(cols)
    width = max(levels) + 1
    size = n_cols * width + 2 * bins

    def sketch_update(acc, packed_q, packed_ref, top_rows, top_valid, top_p):
        k = top_rows.shape[1]
        rows_l = packed_q.repeat_interleave(k, dim=0)
        rows_r = packed_ref.index_select(0, top_rows.reshape(-1).to(torch.int64))
        ctx = PairContext(layout, rows_l, rows_r)
        p = top_p.reshape(-1)
        valid = top_valid.reshape(-1)
        # Python scalars throughout, never a device tensor made from one: a
        # synchronous host-to-device copy would stall the served batch
        matched = valid & (p >= MATCH_PROBABILITY)
        sentinel = torch.full(p.shape, size, dtype=torch.int64, device=p.device)
        parts = []
        for c, col in enumerate(cols):
            g = _spec_gamma(col, ctx, False)  # (Q*k,) int8 in [-1, L-1]
            idx = g.to(torch.int64) + (1 + c * width)
            parts.append(torch.where(matched, idx, sentinel))
        sbin = torch.clamp((p * bins).to(torch.int32), 0, bins - 1).to(torch.int64)
        sbin = sbin + n_cols * width
        parts.append(torch.where(matched, sbin, sentinel))
        parts.append(torch.where(valid, sbin + bins, sentinel))
        return acc + sentinel_histogram(torch.cat(parts), size)

    return sketch_update


class WindowSketch:
    """One drained accumulator window: device histograms + host counters."""

    __slots__ = ("t", "gamma", "score", "score_all", "counters")

    def __init__(self, t: float, gamma: np.ndarray, score: np.ndarray,
                 counters: dict, score_all: np.ndarray | None = None):
        self.t = float(t)
        self.gamma = gamma  # (C, W) int64, matched top-k winners
        self.score = score  # (bins,) int64, matched top-k winners
        # (bins,) int64, EVERY valid top-k slot (the yield denominator +
        # the served-score distribution the exposition histogram renders)
        self.score_all = (
            score_all if score_all is not None else np.zeros_like(score)
        )
        self.counters = counters


class ServeSketch:
    """The engine-side half: a device-resident accumulator updated per
    full-service batch (zero host syncs) plus host counters, drained into
    :class:`WindowSketch` windows off the hot path.

    Owned by the :class:`~..serve.engine.QueryEngine`; all update/drain
    calls run under the engine's swap lock (the engine guarantees it)."""

    def __init__(self, index, profile):
        self.index = index
        self.profile = profile
        settings = index.settings
        cols = tuple(settings["comparison_columns"])
        self.columns = list(profile.columns)
        self.num_levels = list(profile.num_levels)
        self.bins = profile.bins
        self.width = max(self.num_levels) + 1
        self.size = len(cols) * self.width + 2 * self.bins
        self._fn = None  # the sketch update, made at first use
        self._acc = None  # device int64 accumulator
        self._layout = index.layout
        self._cols = cols
        self._lock = lockwatch.new_lock("ServeSketch._lock")  # host counters only
        self._counters = self._zero_counters()
        self._last_drain = time.monotonic()

    def _zero_counters(self) -> dict:
        return {
            "queries": 0,
            "oov": 0,  # no candidates from ANY gather unit (served empty)
            "exact_miss": 0,  # exact blocking keys hit no bucket
            "approx_served": 0,  # served via the LSH fallback bucket path
            "degraded": 0,  # brown-out batches (excluded from histograms)
            "nulls": np.zeros(len(self.columns), np.int64),
        }

    # -- device side -----------------------------------------------------

    def _kernel(self):
        if self._fn is None:
            self._fn = make_sketch_fn(self._layout, self._cols, self.bins)
        return self._fn

    def _accumulator(self):
        if self._acc is None:
            import torch

            self._acc = torch.zeros(self.size, dtype=torch.int64,
                                    device=self.index.device)
        return self._acc

    def update(self, packed_q, packed_ref, top_rows, top_valid, top_p) -> None:
        """Fold one dispatched batch's device outputs into the
        accumulator. Asynchronous: nothing is read back, the served batch
        gains no sync point."""
        self._acc = self._kernel()(
            self._accumulator(), packed_q, packed_ref,
            top_rows, top_valid, top_p,
        )

    def warm(self, q_pad: int, k: int) -> None:
        """Run the sketch once at one query bucket's shape on an
        all-invalid dummy batch (every index goes to the sentinel, so the
        accumulator is unchanged): the kernels it launches are loaded
        before traffic."""
        import torch

        dev = self.index.device_state()
        device = self.index.device
        self._acc = self._kernel()(
            self._accumulator(),
            torch.zeros((q_pad, self.index.n_lanes), dtype=torch.int32, device=device),
            dev["packed"],
            torch.zeros((q_pad, k), dtype=torch.int32, device=device),
            torch.zeros((q_pad, k), dtype=torch.bool, device=device),
            torch.zeros((q_pad, k), dtype=dev["params"].m.dtype, device=device),
        )

    # -- host side -------------------------------------------------------

    def note_batch(self, df, batch, n_rules: int) -> None:
        """Host counters from an already-encoded query batch (no device
        work): OOV/exact-miss/approx rates plus per-column query null
        counts for the profile's comparison columns."""
        import pandas as pd

        with self._lock:
            c = self._counters
            c["queries"] += batch.n
            qb = batch.qbuckets
            c["oov"] += int((qb < 0).all(axis=0).sum())
            c["exact_miss"] += int((qb[:n_rules] < 0).all(axis=0).sum())
            if batch.approx_used is not None:
                c["approx_served"] += int(batch.approx_used.sum())
            for i, name in enumerate(self.columns):
                if name in df.columns:
                    c["nulls"][i] += int(pd.isna(df[name]).sum())

    def note_degraded(self, n: int) -> None:
        with self._lock:
            self._counters["degraded"] += int(n)

    # -- drain -----------------------------------------------------------

    def drain_due(self, cadence_s: float) -> bool:
        return time.monotonic() - self._last_drain >= cadence_s

    def drain(self) -> WindowSketch:
        """Fetch + reset the accumulator and counters into one window.
        The ONLY device fetch the sketch ever performs — called between
        batches / from the watchdog, never inside a dispatch."""
        now = time.monotonic()
        self._last_drain = now
        flat = (
            self._acc.cpu().numpy().astype(np.int64)
            if self._acc is not None
            else np.zeros(self.size, np.int64)
        )
        self._acc = None  # re-zeroed lazily on the next update
        n_cols = len(self.columns)
        gamma = flat[: n_cols * self.width].reshape(n_cols, self.width)
        score = flat[n_cols * self.width : n_cols * self.width + self.bins]
        score_all = flat[n_cols * self.width + self.bins :]
        with self._lock:
            counters = self._counters
            self._counters = self._zero_counters()
        counters = dict(counters)
        counters["nulls"] = counters["nulls"].copy()
        return WindowSketch(now, gamma, score, counters, score_all)


# ---------------------------------------------------------------------------
# Drift statistics
# ---------------------------------------------------------------------------


def _proportions(counts: np.ndarray, eps: float = PSI_EPS) -> np.ndarray | None:
    counts = np.asarray(counts, np.float64)
    total = counts.sum()
    if total <= 0:
        return None
    p = counts / total
    p = np.maximum(p, eps)
    return p / p.sum()


def psi(expected, observed, eps: float = PSI_EPS) -> float | None:
    """Population stability index between two count vectors; None when
    either side is empty. sum((q - p) * ln(q / p)) over eps-smoothed
    proportions (p = expected/reference, q = observed)."""
    p = _proportions(expected, eps)
    q = _proportions(observed, eps)
    if p is None or q is None:
        return None
    # _proportions floors every cell at eps, so the ratio is strictly
    # positive and the tiny-floor below is the identity — it only exists
    # to keep the log finite if the smoothing is ever disabled (eps=0)
    return float(
        np.sum(
            (q - p)
            * np.log(np.maximum(q, _LOG_TINY) / np.maximum(p, _LOG_TINY))
        )
    )


def js_divergence(expected, observed, eps: float = PSI_EPS) -> float | None:
    """Jensen-Shannon divergence (base 2, in [0, 1]) between two count
    vectors; None when either side is empty."""
    p = _proportions(expected, eps)
    q = _proportions(observed, eps)
    if p is None or q is None:
        return None
    m = 0.5 * (p + q)
    # same identity floor as psi(): strictly positive ratios after the
    # eps smoothing, finite even with smoothing disabled
    kl_pm = np.sum(
        p * np.log2(np.maximum(p, _LOG_TINY) / np.maximum(m, _LOG_TINY))
    )
    kl_qm = np.sum(
        q * np.log2(np.maximum(q, _LOG_TINY) / np.maximum(m, _LOG_TINY))
    )
    return float(0.5 * kl_pm + 0.5 * kl_qm)


class DriftMonitor:
    """Rolling drift windows scored against a training-reference profile.

    Holds the time-bucketed ring of drained :class:`WindowSketch` windows
    (bounded by the long window) and computes per-channel PSI / JS over
    the trailing short (``drift_window_s``) and long (5x) windows. The
    clock is injectable so the two-window alert math is unit-testable
    without sleeping. ``profile=None`` is a first-class state: every
    snapshot reports ``reference: False`` with the reason instead of
    raising (legacy profile-less indexes keep serving)."""

    def __init__(
        self,
        profile,
        *,
        window_s: float = 60.0,
        alert_psi: float = 0.25,
        long_factor: int = LONG_WINDOW_FACTOR,
        clock=time.monotonic,
        score_reference: bool = True,
    ):
        self.profile = profile
        # False = the profile's score histograms are NOT comparable to the
        # served score distribution (a TF-adjusted engine over a legacy
        # profile captured from UNADJUSTED scores): the score channel
        # reports psi None with a reason instead of firing a spurious
        # drift alert the moment adjusted traffic lands — the swap
        # re-anchor discipline the KernelWatch fix established in the
        # perf observatory. Gamma channels are fold-invariant, they stay.
        self.score_reference = bool(score_reference)
        self.window_s = float(window_s)
        self.alert_psi = float(alert_psi)
        self.long_window_s = self.window_s * long_factor
        self._clock = clock
        self._lock = lockwatch.new_lock("DriftMonitor._lock")
        self._ring: deque = deque()
        self.windows_observed = 0

    @property
    def drain_cadence_s(self) -> float:
        return max(self.window_s / DRAINS_PER_WINDOW, 0.05)

    def observe(self, window: WindowSketch) -> None:
        """Fold one drained window into the ring (stamped with the
        monitor's clock so injected clocks govern windowing)."""
        window.t = self._clock()
        with self._lock:
            self._ring.append(window)
            self.windows_observed += 1
            horizon = window.t - self.long_window_s
            while self._ring and self._ring[0].t < horizon:
                self._ring.popleft()

    def _windows_observed_snapshot(self) -> int:
        with self._lock:
            return self.windows_observed

    def _aggregate(self, window_s: float):
        """Summed histograms + counters over the trailing window."""
        if self.profile is None:
            return None
        first = self._clock() - window_s
        n_cols = len(self.profile.columns)
        gamma = np.zeros((n_cols, self.profile.gamma_hist.shape[1]), np.int64)
        score = np.zeros(self.profile.bins, np.int64)
        score_all = np.zeros(self.profile.bins, np.int64)
        counters = {"queries": 0, "oov": 0, "exact_miss": 0,
                    "approx_served": 0, "degraded": 0,
                    "nulls": np.zeros(n_cols, np.int64)}
        with self._lock:
            snap = list(self._ring)
        for w in snap:
            if w.t < first:
                continue
            if w.gamma.shape == gamma.shape:
                gamma += w.gamma
            if w.score.shape == score.shape:
                score += w.score
            if w.score_all.shape == score_all.shape:
                score_all += w.score_all
            for k in ("queries", "oov", "exact_miss", "approx_served",
                      "degraded"):
                counters[k] += int(w.counters.get(k, 0))
            nulls = w.counters.get("nulls")
            if nulls is not None and len(nulls) == n_cols:
                counters["nulls"] += nulls
        return gamma, score, score_all, counters

    def window_drift(self, window_s: float) -> dict | None:
        """Per-channel drift over the trailing ``window_s`` seconds, or
        None without a reference profile. Channels with no observations
        report ``psi: None`` (an idle service is not drifting)."""
        agg = self._aggregate(window_s)
        if agg is None:
            return None
        gamma, score, score_all, counters = agg
        prof = self.profile
        # the sketch kernel counts match-conditioned top-k winners, so the
        # comparison side is the profile's matched twins (like with like);
        # a profile with zero matched training pairs yields psi None on
        # every channel — drift scoring goes dark rather than comparing
        # against an empty reference
        channels = {}
        for c, name in enumerate(prof.columns):
            w = prof.num_levels[c] + 1
            ref = prof.gamma_counts_matched(c)
            channels[f"gamma:{name}"] = {
                "psi": _round(psi(ref, gamma[c, :w])),
                "js": _round(js_divergence(ref, gamma[c, :w])),
            }
        if self.score_reference:
            channels["score"] = {
                "psi": _round(psi(prof.score_hist_matched, score)),
                "js": _round(js_divergence(prof.score_hist_matched, score)),
            }
        else:
            channels["score"] = {
                "psi": None,
                "js": None,
                "reason": "reference_scores_unadjusted",
            }
        psis = [v["psi"] for v in channels.values() if v["psi"] is not None]
        queries = counters["queries"]
        null_rates = {}
        for c, name in enumerate(prof.columns):
            if queries:
                null_rates[name] = round(
                    float(counters["nulls"][c]) / queries, 6
                )
        served = int(score_all.sum())
        matched = int(score.sum())
        return {
            "window_s": window_s,
            "channels": channels,
            "max_psi": _round(max(psis)) if psis else None,
            "pairs": matched,
            "served_pairs": served,
            "match_yield": _rate(matched, served),
            "queries": queries,
            "oov_rate": _rate(counters["oov"], queries),
            "exact_miss_rate": _rate(counters["exact_miss"], queries),
            "approx_rate": _rate(counters["approx_served"], queries),
            "degraded": counters["degraded"],
            "null_rates": null_rates,
        }

    def score_window_counts(self, window_s: float) -> np.ndarray | None:
        """The (bins,) score histogram of EVERY served top-k slot over the
        trailing window (not just the matched winners) — the native
        Prometheus histogram series the exposition endpoint renders. None
        without a reference profile."""
        agg = self._aggregate(window_s)
        if agg is None:
            return None
        return agg[2]

    def export_aggregate(self, window_s: float | None = None) -> dict | None:
        """JSON-serialisable trailing-window aggregate for metric
        federation (obs/fleet.py): the summed gamma/score count tensors
        and serve-side counters. Everything is an integer count, so N
        hosts' exports merge by plain addition into exactly the aggregate
        a single monitor over the union of traffic would report."""
        agg = self._aggregate(window_s if window_s is not None else self.window_s)
        if agg is None:
            return None
        gamma, score, score_all, counters = agg
        return {
            "window_s": float(window_s if window_s is not None else self.window_s),
            "gamma": gamma.tolist(),
            "score": score.tolist(),
            "score_all": score_all.tolist(),
            "counters": {
                **{k: int(v) for k, v in counters.items() if k != "nulls"},
                "nulls": counters["nulls"].tolist(),
            },
        }

    def alerts(self, short: dict | None = None,
               long_: dict | None = None) -> list[dict]:
        """Fired two-window drift alerts. A PSI channel alerts only when
        its PSI exceeds the threshold over BOTH the short and the long
        window; the ``match_yield`` channel alerts when the short
        window's matched yield collapses below the long window's by
        :data:`YIELD_COLLAPSE_FACTOR` — the catch-all for drift so severe
        the match population (and with it every PSI channel) goes dark.
        PSI channels additionally require :data:`PSI_MIN_PAIRS` matched
        pairs in both windows (small-sample PSI is shot noise). Empty
        with no reference, no threshold, or no traffic. Callers that
        already hold both windows' :meth:`window_drift` dicts pass them
        in to skip the ring re-aggregation (one scrape otherwise pays
        the full (C, W)-histogram sum per call)."""
        if self.profile is None or self.alert_psi <= 0:
            return []
        if short is None:
            short = self.window_drift(self.window_s)
        if long_ is None:
            long_ = self.window_drift(self.long_window_s)
        if not short or not long_:
            return []
        fired = []
        # PSI evidence floor: both windows must hold enough matched pairs
        # for the statistic to mean drift rather than shot noise (the
        # long window always spans the short one, but a swap-reset ring
        # can briefly hold less history than the short window claims)
        psi_eligible = (
            short.get("pairs", 0) >= PSI_MIN_PAIRS
            and long_.get("pairs", 0) >= PSI_MIN_PAIRS
        )
        for channel, sv in short["channels"].items() if psi_eligible else ():
            lv = long_["channels"].get(channel, {})
            s_psi, l_psi = sv.get("psi"), lv.get("psi")
            if (
                s_psi is not None
                and l_psi is not None
                and s_psi >= self.alert_psi
                and l_psi >= self.alert_psi
            ):
                fired.append(
                    {
                        "channel": channel,
                        "short_psi": s_psi,
                        "long_psi": l_psi,
                        "threshold": self.alert_psi,
                        "window_s": self.window_s,
                        "long_window_s": self.long_window_s,
                    }
                )
        s_yield, l_yield = short.get("match_yield"), long_.get("match_yield")
        if s_yield is None and short.get("queries", 0) > 0:
            # the short window served NOTHING despite traffic (e.g. every
            # query went OOV): the yield did not merely collapse, it
            # vanished — score it as zero so the collapse rule can fire
            s_yield = 0.0
        if (
            s_yield is not None
            and l_yield is not None
            and long_.get("served_pairs", 0) >= YIELD_MIN_SERVED
            and l_yield > 0
            and s_yield < l_yield / YIELD_COLLAPSE_FACTOR
        ):
            fired.append(
                {
                    "channel": "match_yield",
                    "short_yield": s_yield,
                    "long_yield": l_yield,
                    "threshold": YIELD_COLLAPSE_FACTOR,
                    "window_s": self.window_s,
                    "long_window_s": self.long_window_s,
                }
            )
        return fired

    def snapshot(self) -> dict:
        """JSON-ready view: reference presence, both windows' channel
        drift, fired alerts."""
        if self.profile is None:
            return {
                "reference": False,
                "reason": "no reference profile",
                "alerts": [],
            }
        short = self.window_drift(self.window_s)
        long_ = self.window_drift(self.long_window_s)
        return {
            "reference": True,
            "columns": list(self.profile.columns),
            "reference_pairs": self.profile.n_pairs,
            "reference_matched_pairs": self.profile.n_matched_pairs,
            "alert_psi": self.alert_psi,
            "windows_observed": self._windows_observed_snapshot(),
            "short": short,
            "long": long_,
            "alerts": self.alerts(short, long_),
        }


def _round(v, nd: int = 5):
    return None if v is None else round(float(v), nd)


def _rate(n: int, total: int):
    return round(n / total, 6) if total else None


def no_reference_snapshot(reason: str = "no reference profile") -> dict:
    """The drift report for a service whose index carries no profile (or
    whose sketching is disabled): legacy indexes load and serve unchanged
    and drift reporting states why it is dark instead of crashing."""
    return {"reference": False, "reason": reason, "alerts": []}
