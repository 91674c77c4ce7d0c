"""Training-reference quality profiles and offline EM diagnostics: the port
of splink_tpu/obs/quality.py.

The Fellegi-Sunter parameters frozen into a :class:`~..serve.index.
LinkageIndex` estimate a *training-time* distribution, and the m/u
probabilities are per-comparison interpretable quantities, so drift in the
comparison-level mix a deployed model sees is diagnosable once the
training distribution is recorded. ``build_index`` records it:

  * **per-comparison gamma-level histograms**: for every comparison
    column, how often each agreement level (and the null pseudo-level
    gamma = -1) occurred across the training pairs;
  * **match-probability histogram** over ``drift_sketch_bins`` equal bins
    of [0, 1];
  * **per-column null rates and vocabulary mass** (the share of non-null
    rows covered by the 16 most frequent tokens).

The histograms come from :func:`make_profile_fn`, tensor ops on the
linker's device over chunks of at most ``_PROFILE_CHUNK`` training pairs
(:func:`sentinel_histogram`, a ``torch.histc`` that skips out-of-range
indices as the reference's dropping scatter does), each chunk flushed to
host int64. Under the
pattern-id regime the (small) pattern matrix is histogrammed on the host
with the pattern counts as weights, as in the reference.

The profile persists as arrays inside the ``LinkageIndex`` artifact (the
reference's layout and names, so either package loads the other's); the
serve tier (:mod:`.drift`) compares rolling windows of served traffic
against it with PSI / Jensen-Shannon scores.

The second half is offline: :func:`em_diagnostics` inspects a trained
model for identifiability problems (levels with ~zero support, levels
where m ~= u) plus the per-iteration trajectories, rendered by
``python -m splink_tpu_torch.obs summarize``.
"""

from __future__ import annotations

import logging
import math

import numpy as np

logger = logging.getLogger("splink_tpu_torch")

#: tokens counted into the "top mass" vocabulary-concentration statistic
VOCAB_TOP_K = 16

#: |log2(m/u)| below this marks a level as uninformative (m within ~10% of
#: u — the level shifts the posterior by less than a tenth of a bit)
UNINFORMATIVE_LOG2_BF = math.log2(1.1)

#: a level whose training support is below this fraction of the pair count
#: (or zero) is flagged unidentifiable
LOW_SUPPORT_FRACTION = 1e-6

#: the match-population conditioning threshold shared by the profile
#: kernel and the serve sketch kernel. Serving returns top-k MATCHES, so
#: comparing served pairs against the all-pairs training distribution
#: (dominated by non-matches) bakes in a huge selection bias; both sides
#: therefore also histogram the pairs with match probability >= this, and
#: drift scores compare the match-conditioned pair (like with like).
MATCH_PROBABILITY = 0.5

_PROFILE_CHUNK = 1 << 20  # pairs per device profile-kernel dispatch


class QualityProfile:
    """The training-reference distribution captured at index build.

    ``gamma_hist`` is (C, W) int64 with W = max(num_levels) + 1: row c bin
    0 counts gamma = -1 (null), bin 1 + l counts level l; bins past a
    column's own num_levels + 1 are always zero. ``score_hist`` is
    (bins,) int64 over equal bins of [0, 1] (p == 1.0 lands in the last
    bin). The ``*_matched`` twins hold the same histograms restricted to
    pairs with match probability >= :data:`MATCH_PROBABILITY` — the
    population serve-time top-k answers are drawn from, and therefore the
    side drift scores compare against."""

    def __init__(
        self,
        *,
        columns: list[str],
        num_levels: list[int],
        gamma_hist: np.ndarray,
        score_hist: np.ndarray,
        gamma_hist_matched: np.ndarray,
        score_hist_matched: np.ndarray,
        null_rates: dict,
        vocab_mass: dict,
        n_pairs: int,
        n_rows: int,
        tf_adjusted: bool = False,
    ):
        self.columns = list(columns)
        self.num_levels = [int(v) for v in num_levels]
        self.gamma_hist = np.asarray(gamma_hist, np.int64)
        self.score_hist = np.asarray(score_hist, np.int64)
        self.gamma_hist_matched = np.asarray(gamma_hist_matched, np.int64)
        self.score_hist_matched = np.asarray(score_hist_matched, np.int64)
        self.null_rates = dict(null_rates)
        self.vocab_mass = dict(vocab_mass)
        self.n_pairs = int(n_pairs)
        self.n_rows = int(n_rows)
        # whether the score histograms were captured from TF-ADJUSTED
        # match probabilities (the serve-time score distribution of a TF
        # model). False on legacy artifacts: a TF-serving engine over
        # such a profile must NOT score-drift-compare adjusted traffic
        # against an unadjusted reference (obs/drift.DriftMonitor goes
        # dark on the score channel with a reason instead).
        self.tf_adjusted = bool(tf_adjusted)

    @property
    def bins(self) -> int:
        return int(self.score_hist.shape[0])

    @property
    def n_matched_pairs(self) -> int:
        """Training pairs above the match-conditioning threshold — the
        reference mass the serve drift channels compare against (zero
        means drift scoring has no reference population and goes dark)."""
        return int(self.score_hist_matched.sum())

    def gamma_counts(self, c: int) -> np.ndarray:
        """Column c's (num_levels + 1,) counts: [null, level 0, ...]."""
        return self.gamma_hist[c, : self.num_levels[c] + 1]

    def gamma_counts_matched(self, c: int) -> np.ndarray:
        """Column c's counts over the match-conditioned pairs."""
        return self.gamma_hist_matched[c, : self.num_levels[c] + 1]

    # -- persistence (arrays ride the LinkageIndex npz payload, so the
    #    artifact's arrays_sha256 fingerprint covers them; meta carries
    #    the JSON-able rest) ---------------------------------------------

    def to_meta(self) -> dict:
        return {
            "columns": self.columns,
            "num_levels": self.num_levels,
            "bins": self.bins,
            "null_rates": {k: float(v) for k, v in self.null_rates.items()},
            "vocab_mass": self.vocab_mass,
            "n_pairs": self.n_pairs,
            "n_rows": self.n_rows,
            "tf_adjusted": self.tf_adjusted,
        }

    @classmethod
    def from_meta(
        cls,
        meta: dict,
        gamma_hist,
        score_hist,
        gamma_hist_matched=None,
        score_hist_matched=None,
    ) -> "QualityProfile":
        gamma_hist = np.asarray(gamma_hist, np.int64)
        score_hist = np.asarray(score_hist, np.int64)
        if gamma_hist_matched is None:
            # artifact predates the match-conditioned twins: drift scoring
            # has no reference population for its channels and goes dark
            # (psi None), but the profile still loads and reports
            gamma_hist_matched = np.zeros_like(gamma_hist)
        if score_hist_matched is None:
            score_hist_matched = np.zeros_like(score_hist)
        return cls(
            columns=list(meta["columns"]),
            num_levels=list(meta["num_levels"]),
            gamma_hist=gamma_hist,
            score_hist=score_hist,
            gamma_hist_matched=gamma_hist_matched,
            score_hist_matched=score_hist_matched,
            null_rates=dict(meta.get("null_rates") or {}),
            vocab_mass=dict(meta.get("vocab_mass") or {}),
            n_pairs=int(meta.get("n_pairs") or 0),
            n_rows=int(meta.get("n_rows") or 0),
            # absent on artifacts built before the TF fold = unadjusted
            tf_adjusted=bool(meta.get("tf_adjusted", False)),
        )

    def summary(self) -> dict:
        """The JSON-able ``quality_profile`` telemetry event payload."""
        return {
            "columns": self.columns,
            "num_levels": self.num_levels,
            "bins": self.bins,
            "n_pairs": self.n_pairs,
            "n_matched_pairs": self.n_matched_pairs,
            "n_rows": self.n_rows,
            "null_rates": {k: round(float(v), 6)
                           for k, v in self.null_rates.items()},
            "vocab_mass": self.vocab_mass,
            "tf_adjusted": self.tf_adjusted,
        }


def make_profile_fn(num_levels: tuple, bins: int):
    """The training-profile function: ``(G, params) -> hist``, a flat int64
    tensor on G's device of TWO half-blocks, each C blocks of W = max(L) + 1
    gamma bins followed by ``bins`` score bins: the first half counts every
    pair, the second only the pairs whose match probability reaches
    :data:`MATCH_PROBABILITY` (the serve sketch applies the same
    conditioning). Gamma = -1 (null) lands in a column's bin 0; the score
    is the shared ``match_probability`` expression (the port's scoring,
    sub-normals flushed), binned as the reference does: ``(p * bins)``
    truncated to int32 in p's dtype, clipped to [0, bins - 1].

    One :func:`sentinel_histogram` counts every scatter index at once. An
    index the reference's scatter would drop (a non-matched pair's
    matched-half slot, the sentinel ``size``, or anything outside the
    histogram) is not counted. The caller keeps each call to at most
    ``_PROFILE_CHUNK`` pairs, as the reference's int32 protocol does."""
    import torch

    from ..models.fellegi_sunter import match_probability

    levels = tuple(int(v) for v in num_levels)
    n_cols = len(levels)
    width = max(levels) + 1
    half = n_cols * width + bins
    size = 2 * half

    def profile(G, params):
        p = match_probability(G, params)
        # a Python scalar, not a device tensor: no host-to-device copy (0.5
        # is exact in every float type)
        matched = p >= MATCH_PROBABILITY
        sbin = torch.clamp((p * bins).to(torch.int32), 0, bins - 1).to(torch.int64)
        sbin = sbin + n_cols * width
        offs = torch.arange(n_cols, dtype=torch.int64, device=G.device) * width + 1
        g = G.to(torch.int64) + offs  # (n, C)
        idx = torch.cat([g, sbin[:, None]], dim=1)  # (n, C + 1)
        sentinel = torch.full_like(idx, size)
        idx_m = torch.where(matched[:, None], idx + half, sentinel)
        flat = torch.cat([idx.reshape(-1), idx_m.reshape(-1)])
        return sentinel_histogram(flat, size)

    return profile


def sentinel_histogram(idx, size: int):
    """int64 counts of the integer indices in [0, size) on ``idx``'s
    device; any other index is not counted (the reference's
    ``.at[idx].add(1, mode="drop")``: never clamped into a real bin, never
    an out-of-range scatter, which on CUDA is a device-side assert).

    ``torch.histc`` over [0, size) with one bin per index, after every
    other index is set to -1, which histc skips (a value equal to ``size``
    would fall in its last bin). Its float32 counts are exact below 2^24
    per bin, more than one call holds (a profile chunk is 2^20 pairs).
    ``torch.bincount`` would read the largest index back to the host to
    size its output: a device-to-host sync per call."""
    import torch

    idx = torch.where((idx >= 0) & (idx < size), idx, -1)
    return torch.histc(idx.to(torch.float32), bins=size, min=0, max=size).to(torch.int64)


def _column_table_stats(table, settings) -> tuple[dict, dict]:
    """(null_rates, vocab_mass) over the encoded reference table for the
    comparison input columns (host-side; one pass per column)."""
    from ..gammas import _comparison_input_column

    null_rates: dict = {}
    vocab_mass: dict = {}
    n = max(table.n_rows, 1)
    seen: set = set()
    for col in settings["comparison_columns"]:
        name = _comparison_input_column(col)
        if name is None or name in seen:
            continue
        seen.add(name)
        if name in table.strings:
            sc = table.strings[name]
            null_rates[name] = float(sc.null_mask.mean()) if table.n_rows else 0.0
            tids = sc.token_ids[sc.token_ids >= 0]
            if len(tids):
                counts = np.bincount(tids, minlength=max(sc.n_tokens, 1))
                top = np.sort(counts)[::-1][:VOCAB_TOP_K]
                vocab_mass[name] = {
                    "n_tokens": int(sc.n_tokens),
                    "top_mass": round(float(top.sum() / counts.sum()), 6),
                }
        elif name in table.numerics:
            nc = table.numerics[name]
            null_rates[name] = float(nc.null_mask.mean()) if table.n_rows else 0.0
    return null_rates, vocab_mass


def capture_profile(linker, table=None) -> QualityProfile | None:
    """Capture the training-reference profile from a trained linker, on
    the linker's device.

    Uses whichever training gammas the linker still holds: the resident
    gamma matrix (its device copy when one is kept, else the host matrix
    uploaded chunk by chunk, through :func:`make_profile_fn` in chunks of
    ``_PROFILE_CHUNK`` pairs) or the pattern matrix and counts of the
    pattern-id regime (weighted host histograms). With the TF fold active
    the score histograms come from TF-ADJUSTED scores, per pair on the
    host, as in the reference. Returns None when the linker holds no
    training gammas (untrained, or released); the caller decides whether
    that is a warning."""
    import torch

    from ..models.fellegi_sunter import match_probability
    from ..settings import comparison_column_name

    settings = linker.settings
    bins = int(settings.get("drift_sketch_bins", 16) or 16)
    cols = settings["comparison_columns"]
    names = [comparison_column_name(c) for c in cols]
    levels = [int(c["num_levels"]) for c in cols]
    width = max(levels) + 1
    n_cols = len(cols)

    G = getattr(linker, "_G", None)
    G_dev = getattr(linker, "_G_dev", None) if G is not None else None
    counts = None
    if G is None:
        pat_counts = getattr(linker, "_pattern_counts", None)
        program = getattr(linker, "_pattern_program", None)
        if pat_counts is not None and program is not None:
            G = program.patterns_matrix()
            counts = np.asarray(pat_counts, np.int64)
    if G is None or len(G) == 0:
        return None

    tf_ctx = linker._tf_fold_ctx()
    params = linker._em_init()
    device = params.m.device

    gamma_hist = np.zeros((n_cols, width), np.int64)
    score_hist = np.zeros(bins, np.int64)
    gamma_hist_m = np.zeros((n_cols, width), np.int64)
    score_hist_m = np.zeros(bins, np.int64)
    if tf_ctx is not None and counts is None:
        pairs = getattr(linker, "_pairs", None)
        if pairs is None or pairs.n_pairs != len(G):
            # the gammas no longer align with a pair index (so no token
            # ids): capture unadjusted rather than fabricate a fold
            logger.warning(
                "TF fold active but the gamma matrix has no aligned pair "
                "index; profile score histograms are UNADJUSTED"
            )
            tf_ctx = None

    def chunk_tensor(s, e):
        if G_dev is not None:
            return G_dev[s:e]
        return torch.from_numpy(np.ascontiguousarray(G[s:e])).to(device)

    if tf_ctx is not None:
        # per-PAIR capture: the fold delta belongs to the pair's tokens,
        # not to its gamma pattern
        def _pair_chunks():
            if counts is not None:
                PM2, _p, _pm, _pu, z_lut = linker._pattern_score_luts()
                for il, ir, Pk in linker._iter_pattern_triples():
                    yield PM2[Pk], z_lut[Pk], il, ir
            else:
                from ..em import score_pairs_with_logits

                pr = linker._pairs
                for s in range(0, len(G), _PROFILE_CHUNK):
                    e = min(s + _PROFILE_CHUNK, len(G))
                    z = score_pairs_with_logits(chunk_tensor(s, e), params)[1]
                    yield G[s:e], z.cpu().numpy(), pr.idx_l[s:e], pr.idx_r[s:e]

        n_pairs = 0
        for Gc, z, il, ir in _pair_chunks():
            p = linker._tf_fold_pairs(z, il, ir, tf_ctx)
            matched = p >= MATCH_PROBABILITY
            sbin = np.clip((p * bins).astype(np.int64), 0, bins - 1)
            Gc = np.asarray(Gc)
            for c in range(n_cols):
                g = np.clip(Gc[:, c].astype(np.int64) + 1, 0, width - 1)
                gamma_hist[c] += np.bincount(g, minlength=width)[:width]
                gamma_hist_m[c] += np.bincount(g[matched], minlength=width)[:width]
            score_hist += np.bincount(sbin, minlength=bins)[:bins]
            score_hist_m += np.bincount(sbin[matched], minlength=bins)[:bins]
            n_pairs += len(p)
    elif counts is not None:
        # pattern regime: weighted host histograms over the pattern matrix
        seen = counts > 0
        Gp = np.asarray(G)[seen]
        w = counts[seen]
        p = match_probability(
            torch.from_numpy(np.ascontiguousarray(Gp)).to(device), params
        ).cpu().numpy()
        matched = p >= MATCH_PROBABILITY
        sbin = np.clip((p * bins).astype(np.int64), 0, bins - 1)
        for c in range(n_cols):
            g = np.clip(Gp[:, c].astype(np.int64) + 1, 0, width - 1)
            gamma_hist[c] += np.bincount(g, weights=w, minlength=width).astype(np.int64)[:width]
            gamma_hist_m[c] += np.bincount(
                g[matched], weights=w[matched], minlength=width
            ).astype(np.int64)[:width]
        score_hist += np.bincount(sbin, weights=w, minlength=bins).astype(np.int64)[:bins]
        score_hist_m += np.bincount(
            sbin[matched], weights=w[matched], minlength=bins
        ).astype(np.int64)[:bins]
        n_pairs = int(counts.sum())
    else:
        half = n_cols * width + bins
        fn = make_profile_fn(tuple(levels), bins)
        for s in range(0, len(G), _PROFILE_CHUNK):
            chunk = fn(chunk_tensor(s, s + _PROFILE_CHUNK), params).cpu().numpy()
            gamma_hist += chunk[: n_cols * width].reshape(n_cols, width)
            score_hist += chunk[n_cols * width : half]
            gamma_hist_m += chunk[half : half + n_cols * width].reshape(n_cols, width)
            score_hist_m += chunk[half + n_cols * width :]
        n_pairs = int(len(G))

    if table is None:
        table = linker._ensure_encoded()
    null_rates, vocab_mass = _column_table_stats(table, settings)
    return QualityProfile(
        columns=names,
        num_levels=levels,
        gamma_hist=gamma_hist,
        score_hist=score_hist,
        gamma_hist_matched=gamma_hist_m,
        score_hist_matched=score_hist_m,
        null_rates=null_rates,
        vocab_mass=vocab_mass,
        n_pairs=n_pairs,
        n_rows=int(table.n_rows),
        tf_adjusted=tf_ctx is not None,
    )


# ---------------------------------------------------------------------------
# Offline EM diagnostics
# ---------------------------------------------------------------------------


def em_diagnostics(
    params,
    gamma_hist: dict | None = None,
    max_trajectory: int = 30,
) -> dict:
    """Identifiability diagnostics over a trained :class:`~..params.Params`.

    Per comparison column and level: the final m/u probabilities, the
    log2 Bayes factor, the training support (from ``gamma_hist`` — the
    per-column level-count dict ``linker._gamma_histograms`` produces —
    when available) and a warnings list:

      * ``~zero support`` — the level occurred in (essentially) no
        training pair, so its m/u are the renormalised prior, not an
        estimate: scoring a serve-time pair at that level applies an
        arbitrary weight.
      * ``m~=u`` — the level barely moves the posterior
        (|log2(m/u)| < ~0.14); it adds variance without signal, usually a
        threshold that splits no real mass.

    ``trajectory`` carries the per-iteration lambda plus per-column
    max |delta m| / |delta u| from the Params iteration history (and the
    full per-level m/u paths when the model is small enough to keep the
    event compact). The caller publishes the result as an
    ``em_diagnostics`` telemetry event and logs the warnings."""
    settings = params.settings
    from ..settings import comparison_column_name

    lam, m, u, mask = params.to_arrays(dtype=np.float64)
    cols = settings["comparison_columns"]
    history = _params_history_arrays(params)
    n_pairs = None
    if gamma_hist:
        totals = [sum(v) for v in gamma_hist.values() if v]
        n_pairs = max(totals) if totals else None
    out_cols = []
    all_warnings = []
    for c, col in enumerate(cols):
        name = comparison_column_name(col)
        n_levels = int(col["num_levels"])
        support = None
        if gamma_hist and name in gamma_hist:
            # histogram layout: [null, level 0, ..., level L-1]
            support = [int(v) for v in gamma_hist[name][1 : n_levels + 1]]
        warnings_c = []
        log2_bf = []
        for lv in range(n_levels):
            mv, uv = float(m[c, lv]), float(u[c, lv])
            bf = (
                math.log2(mv / uv)
                if mv > 0 and uv > 0
                else (math.inf if mv > uv else -math.inf if uv > mv else 0.0)
            )
            log2_bf.append(round(bf, 4) if math.isfinite(bf) else None)
            if support is not None:
                thresh = max((n_pairs or 0) * LOW_SUPPORT_FRACTION, 0.0)
                if support[lv] <= thresh:
                    warnings_c.append(
                        f"level {lv}: ~zero training support "
                        f"({support[lv]} pair(s)) — m/u at this level are "
                        "the prior, not an estimate"
                    )
                    continue  # m~=u on an unsupported level is redundant
            if math.isfinite(bf) and abs(bf) < UNINFORMATIVE_LOG2_BF:
                warnings_c.append(
                    f"level {lv}: m~=u (m={mv:.4g}, u={uv:.4g}, "
                    f"{2**bf:.3f}x) — the level is uninformative"
                )
        all_warnings.extend(f"{name}: {w}" for w in warnings_c)
        out_cols.append(
            {
                "name": name,
                "num_levels": n_levels,
                "m": [round(float(m[c, lv]), 6) for lv in range(n_levels)],
                "u": [round(float(u[c, lv]), 6) for lv in range(n_levels)],
                "log2_bf": log2_bf,
                "support": support,
                "warnings": warnings_c,
            }
        )
    diag = {
        "columns": out_cols,
        "n_iterations": len(history["lam"]),
        "lam": round(float(lam), 6),
        "warnings": all_warnings,
    }
    diag["trajectory"] = _trajectory_payload(history, cols, max_trajectory)
    return diag


def _params_history_arrays(params) -> dict:
    """lam + per-column m/u per archived iteration, newest last. The
    Params history stores the params BEFORE each update (reference
    layout), so appending the current params yields the full path."""
    states = list(params.param_history) + [params.params]
    lam = [float(s.get("λ", 0.0)) for s in states]
    per_iter_mu = []
    for s in states:
        cols_mu = []
        for entry in s.get("π", {}).values():
            nl = int(entry["num_levels"])
            cols_mu.append(
                (
                    [entry["prob_dist_match"][f"level_{lv}"]["probability"]
                     for lv in range(nl)],
                    [entry["prob_dist_non_match"][f"level_{lv}"]["probability"]
                     for lv in range(nl)],
                )
            )
        per_iter_mu.append(cols_mu)
    return {"lam": lam, "mu": per_iter_mu}


def _trajectory_payload(history, cols, max_trajectory: int) -> dict:
    """Compact per-iteration trajectory: lambda path + per-column max
    parameter movement; full per-level m/u paths only when small (the
    event must stay a few KB). Long runs subsample to ``max_trajectory``
    evenly spaced iterations, endpoints kept."""
    lam = history["lam"]
    mu = history["mu"]
    n_states = len(lam)
    idx = list(range(n_states))
    subsampled = n_states > max_trajectory + 1
    if subsampled:
        step = (n_states - 1) / max_trajectory
        idx = sorted({0, n_states - 1}
                     | {int(round(i * step)) for i in range(max_trajectory)})
    moves_m, moves_u = [], []
    for i in range(1, n_states):
        dm = du = 0.0
        for (m0, u0), (m1, u1) in zip(mu[i - 1], mu[i]):
            if len(m0) == len(m1):
                dm = max(dm, max(abs(a - b) for a, b in zip(m0, m1)))
                du = max(du, max(abs(a - b) for a, b in zip(u0, u1)))
        moves_m.append(round(dm, 8))
        moves_u.append(round(du, 8))
    payload = {
        "lam": [round(lam[i], 6) for i in idx],
        "iterations": idx,
        "max_move_m": moves_m[-max_trajectory:],
        "max_move_u": moves_u[-max_trajectory:],
        "subsampled": subsampled,
    }
    n_values = sum(len(m0) for m0, _ in mu[0]) if mu else 0
    if n_states * n_values * 2 <= 4096:
        payload["m"] = [
            [[round(v, 6) for v in m0] for m0, _ in mu[i]] for i in idx
        ]
        payload["u"] = [
            [[round(v, 6) for v in u0] for _, u0 in mu[i]] for i in idx
        ]
    return payload
