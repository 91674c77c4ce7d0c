"""Term-frequency adjustment of match scores: splink_tpu's term_frequencies
on PyTorch.

Two adjustments, as in the reference:

  * the ex-post aggregation (``make_adjustment_for_term_frequencies``): for
    each flagged column, pairs that AGREE on a token get a token-specific
    lambda (the mean match probability among agreeing pairs),
    Bayes-combined with (1 - lambda); disagreeing or null pairs are
    neutral (0.5); ``tf_adjusted_match_prob`` Bayes-combines the match
    probability with every column's adjustment. Over a frame aligned with
    the linker's pairs the per-token sums run on a device
    (``compute_token_adjustment_device``, ``index_add_`` over the encoded
    table's token ids); any other frame takes the host groupby
    (``compute_token_adjustment``), the reference's API for arbitrary
    frames.
  * the u-probability fold (``make_tf_fold_fn``): for a flagged column
    whose two sides agree on token t, the top level's u is replaced by the
    token's relative frequency, ``sigmoid(z + sum_c delta_c)`` with
    ``delta_c = log u_c[top] - log tf(t)`` summed left to right in spec
    order onto the fold logit ``z``. The linker puts it in the scored
    frame's ``tf_match_probability`` column.

Precision. The device aggregation runs in float64 on every device: it is
the reference's float64 path (splink_tpu takes float64 whenever x64 is on,
as on the CPU, and float32 only on the TPU, which has no float64). The
token counts are sums of ones below 2^53 and so exact in any order. On
CUDA, ``index_add_`` adds with atomics, so the order of each token's sum
of probabilities changes from run to run; the sums, the lambda table and
the per-pair adjustment agree with the CPU's to about 1e-12 relative, not
bit for bit. Every division divides by a tensor on the device (on CUDA,
PyTorch divides by a Python float as a reciprocal multiply).

``bayes_combine`` and ``tf_log_table`` are numpy float64 on the host: the
log table is the data that both packages gather from, so given equal
``log u`` the fold's pre-sigmoid sum is bit-identical to the reference's.
"""

from __future__ import annotations

import logging
import warnings

import numpy as np
import torch

from ._device import resolve_device
from .check_types import check_types
from .models.fellegi_sunter import _safe_log, flush_subnormal
from .params import Params

# Device aggregations by device type ("cuda", "cpu"): each call of
# compute_token_adjustment_device over a non-empty pair set adds one.
device_aggregations: dict[str, int] = {}


def bayes_combine(probs: list[np.ndarray]) -> np.ndarray:
    """prod(p) / (prod(p) + prod(1-p)) — the reference's sql_gen_bayes_string
    (splink/term_frequencies.py:21-46)."""
    num = np.ones_like(np.asarray(probs[0], dtype=np.float64))
    den = np.ones_like(num)
    for p in probs:
        p = np.asarray(p, dtype=np.float64)
        num = num * p
        den = den * (1.0 - p)
    # contradictory evidence (some p exactly 1 AND some p exactly 0, or
    # underflow of both products) drives num and den both to 0; 0.5 is
    # the no-information posterior, matching the disagreeing-pair
    # convention below. On every other input the guarded division is
    # bit-identical to num / (num + den).
    tot = num + den
    return np.where(
        tot > 0, num / np.maximum(tot, np.finfo(np.float64).tiny), 0.5
    )


def compute_token_adjustment(values_l, values_r, match_probability, base_lambda):
    """Per-pair adjustment for one column, by a host groupby over the raw
    values.

    Returns (adj, lookup) where adj is 0.5 for pairs that disagree or are
    null, else the token's Bayes-adjusted lambda; lookup maps token value ->
    adjusted lambda (for diagnostics).
    """
    import pandas as pd

    values_l = np.asarray(values_l, dtype=object)
    values_r = np.asarray(values_r, dtype=object)
    p = np.asarray(match_probability, dtype=np.float64)

    sl, sr = pd.Series(values_l), pd.Series(values_r)
    agree = (
        sl.notna() & sr.notna() & (sl == sr).fillna(False)
    ).to_numpy(dtype=bool)
    adj = np.full(len(p), 0.5)
    if not agree.any():
        return adj, {}

    s = pd.Series(p[agree])
    keys = pd.Series(values_l[agree])
    adj_lambda = s.groupby(keys, sort=False).mean()
    # Bayes-combine each token lambda with (1 - base lambda)
    # (splink/term_frequencies.py:60)
    adjusted = bayes_combine(
        [adj_lambda.to_numpy(), np.full(len(adj_lambda), 1.0 - base_lambda)]
    )
    lookup = dict(zip(adj_lambda.index, adjusted))
    adj[agree] = keys.map(lookup).to_numpy(dtype=np.float64)
    return adj, lookup


def term_frequency_columns(settings: dict):
    """Ordered, deduplicated raw columns to TF-adjust: the col_name of every
    flagged comparison, and for a flagged custom/case_sql multi-column
    comparison each of its custom_columns_used (the reference's selection at
    splink/term_frequencies.py:130-134 keys on col_name; per-used-column
    adjustment is splink_tpu's extension of its per-column formula)."""
    out: dict[str, None] = {}
    for c in settings["comparison_columns"]:
        if not c.get("term_frequency_adjustments"):
            continue
        if "col_name" in c:
            out.setdefault(c["col_name"])
        else:
            used = tuple(c.get("custom_columns_used", ()))
            if used:
                _warn_custom_tf_once(used)
            for used_col in used:
                out.setdefault(used_col)
    return out.keys()


_custom_tf_warned = False


def _warn_custom_tf_once(used: tuple) -> None:
    """The reference does not support TF adjustment on custom comparisons
    (its selection keys on col_name, splink/term_frequencies.py:130-134);
    splink_tpu extends the per-column formula to each custom_columns_used.
    Announce the extension once."""
    global _custom_tf_warned
    if _custom_tf_warned:
        return
    _custom_tf_warned = True
    logging.getLogger("splink_tpu_torch").warning(
        "term_frequency_adjustments on a custom comparison applies "
        "per-used-column adjustments to %s — an extension beyond the "
        "reference, which skipped custom comparisons (see docs/api.md).",
        list(used),
    )


def _next_pow2(n: int) -> int:
    return 1 << max(int(n) - 1, 0).bit_length()


# Pairs per step of the device aggregation: bounds device memory at any
# pair count, like pair_batch_size does for gammas and scoring.
TF_DEVICE_CHUNK = 1 << 24


def _on(a, device, dtype=None) -> torch.Tensor:
    """A numpy array or tensor as a tensor on ``device``."""
    if isinstance(a, np.ndarray) and not a.flags.writeable:
        a = a.copy()  # torch wraps only writeable numpy memory
    return torch.as_tensor(a).to(device=device, dtype=dtype)


def token_stats(tid_l, tid_r, p, sums, counts):
    """One chunk's step of the device aggregation, in place: each agreeing
    pair adds its probability to its token's bucket of ``sums`` and a one
    to ``counts`` (``index_add_``); disagreeing and null pairs go to the
    last bucket. Returns (sums, counts)."""
    agree = (tid_l == tid_r) & (tid_l >= 0)
    seg = torch.where(agree, tid_l.long(), sums.shape[0] - 1)
    af = agree.to(sums.dtype)
    sums.index_add_(0, seg, p * af)
    counts.index_add_(0, seg, af)
    return sums, counts


def token_gather(tid_l, tid_r, adjusted):
    """Each pair's adjustment: its token's entry of ``adjusted`` where the
    pair agrees, 0.5 (no adjustment) elsewhere."""
    agree = (tid_l == tid_r) & (tid_l >= 0)
    got = adjusted[torch.clamp(tid_l.long(), 0, adjusted.shape[0] - 1)]
    return torch.where(agree, got, 0.5)


def compute_token_adjustment_device(
    tid_l, tid_r, match_probability, base_lambda, n_tokens: int, device=None
):
    """Per-column adjustment over factorised token ids, on ``device``
    (``cuda`` unless the caller names another).

    Same formulas as compute_token_adjustment: per chunk of TF_DEVICE_CHUNK
    pairs, each agreeing pair adds its probability and a one to its
    token's bucket (``index_add_``); disagreeing and null pairs go to the
    last of ``next_pow2(n_tokens + 1)`` buckets. The lambda table is the
    guarded Bayes combination of each token's mean with (1 - base lambda),
    gathered back per pair with 0.5 where the pair disagrees. ``tid_l``,
    ``tid_r`` (int32 token ids, -1 null) and ``match_probability`` may be
    numpy arrays or tensors on any device. Returns numpy float64
    (adj, tok_lambda, counts): the per-pair adjustment, and per token id
    the lambda and the number of agreeing pairs.
    """
    device = resolve_device(device)
    dtype = torch.float64
    num_segments = _next_pow2(n_tokens + 1)
    n = len(tid_l)
    if n == 0:
        z = np.zeros(num_segments)
        return np.zeros(0, np.float64), z, z
    chunk = min(TF_DEVICE_CHUNK, n)
    sums = torch.zeros(num_segments, dtype=dtype, device=device)
    counts = torch.zeros(num_segments, dtype=dtype, device=device)
    for s in range(0, n, chunk):
        cl, cr = _on(tid_l[s:s + chunk], device), _on(tid_r[s:s + chunk], device)
        p = _on(match_probability[s:s + chunk], device, dtype)
        token_stats(cl, cr, p, sums, counts)

    one = torch.ones((), dtype=dtype, device=device)
    base = torch.tensor(base_lambda, dtype=dtype, device=device)
    tok_lambda = sums / torch.maximum(counts, one)
    # Bayes-combine each token lambda with (1 - base lambda)
    # (splink/term_frequencies.py:60)
    num = tok_lambda * (one - base)
    den = (one - tok_lambda) * base
    # tok_lambda and base_lambda both exactly 0 (or both exactly 1) zero
    # both terms; 0.5 is the no-adjustment value the gather pads with.
    # Everywhere else the guarded division is bit-identical.
    tot = num + den
    tiny = torch.tensor(torch.finfo(dtype).tiny, dtype=dtype, device=device)
    half = torch.tensor(0.5, dtype=dtype, device=device)
    adjusted = torch.where(tot > 0, num / torch.maximum(tot, tiny), half)

    adj = np.empty(n, np.float64)
    for s in range(0, n, chunk):
        cl, cr = _on(tid_l[s:s + chunk], device), _on(tid_r[s:s + chunk], device)
        adj[s:s + chunk] = token_gather(cl, cr, adjusted).cpu().numpy()
    device_aggregations[device.type] = device_aggregations.get(device.type, 0) + 1
    return adj, tok_lambda.cpu().numpy(), counts.cpu().numpy()


# ---------------------------------------------------------------------------
# The u-probability fold
#
# For a TF-flagged comparison whose two sides AGREE on a token t, the
# average u-probability of the comparison's top (exact-agreement) level is
# replaced by the token's own relative frequency tf(t) = count(t) / N. In
# log space that is one per-pair delta per TF column,
#
#     delta_c = [tid_l == tid_r >= 0] * (log u_c[L_c - 1] - log tf(t))
#
# folded into the fold logit: p_tf = sigmoid(fold_logit + sum_c delta_c).
# splink_tpu runs the same expression (same table values, same
# accumulation order) in its serve kernels and its offline fold; serving
# will share ``tf_fold_logit`` here, which must therefore not fork.
# ---------------------------------------------------------------------------


def tf_fold_spec(settings: dict) -> tuple:
    """((gamma_index, col_name, top_level), ...) for every comparison the
    u-probability fold can serve: TF-flagged, plain ``col_name`` form (a
    custom multi-column comparison has no single token column to fold; it
    keeps the ex-post path and is announced by
    :func:`_warn_custom_tf_once`). ``top_level`` is the comparison's
    exact-agreement gamma level ``num_levels - 1``."""
    out = []
    for ci, c in enumerate(settings["comparison_columns"]):
        if not c.get("term_frequency_adjustments"):
            continue
        if "col_name" not in c:
            used = tuple(c.get("custom_columns_used", ()))
            if used:
                _warn_custom_tf_once(used)
            continue
        out.append((ci, c["col_name"], int(c["num_levels"]) - 1))
    return tuple(out)


def tf_log_table(counts: np.ndarray) -> np.ndarray:
    """(n_tokens,) float64 ``log(count / total)`` relative-frequency table
    for one TF column, computed once on the host in numpy (the same values
    as splink_tpu's, whose fold gathers from this table too). Zero counts
    (never observed tokens) floor at one occurrence."""
    counts = np.asarray(counts, np.float64)
    total = max(float(counts.sum()), 1.0)
    return np.log(np.maximum(counts, 1.0) / total)


def tf_fold_delta(tid_l, tid_r, log_tf, log_u_top):
    """The per-column fold delta: ``log_u_top - log_tf[tid]`` where the two
    token ids agree and are not null, exactly 0 elsewhere."""
    agree = (tid_l == tid_r) & (tid_l >= 0)
    idx = torch.clamp(tid_l.long(), 0, log_tf.shape[0] - 1)
    zero = torch.zeros((), dtype=log_tf.dtype, device=log_tf.device)
    return torch.where(agree, log_u_top - log_tf[idx], zero)


def tf_fold_logit(spec: tuple, z, log_u, tids_l, tids_r, log_tfs):
    """``z + sum_c delta_c``, the deltas summed left to right in spec
    order: the pre-sigmoid TF-adjusted evidence. ``log_u`` is the (C, L)
    table ``_safe_log(u)``; per spec column one token-id pair and one log
    table in z's dtype."""
    tf_sum = torch.zeros(z.shape, dtype=z.dtype, device=z.device)
    for t, (ci, _name, top) in enumerate(spec):
        tf_sum = tf_sum + tf_fold_delta(tids_l[t], tids_r[t], log_tfs[t], log_u[ci, top])
    return z + tf_sum


def make_tf_fold_fn(spec: tuple):
    """The offline fold: ``fn(z, u, tid_l.., tid_r.., log_tf..) -> p_tf``
    where ``z`` is :func:`..models.fellegi_sunter.fold_logit` for the
    pairs, ``u`` the (C, L) u-probability table in z's dtype, and per spec
    column one (n,) token-id pair plus its :func:`tf_log_table` values in
    z's dtype, all on one device."""
    n_tf = len(spec)

    def fold(z, u, *arrs):
        return flush_subnormal(torch.sigmoid(tf_fold_logit(
            spec, z, _safe_log(u), arrs[:n_tf], arrs[n_tf:2 * n_tf], arrs[2 * n_tf:]
        )))

    return fold


@check_types
def make_adjustment_for_term_frequencies(
    df_e,
    params: Params,
    settings: dict,
    retain_adjustment_columns: bool = False,
    pair_token_ids: dict | None = None,
    device=None,
):
    """Add ``tf_adjusted_match_prob`` to a scored comparisons frame.

    pair_token_ids (optional, supplied by the linker): maps column name ->
    (tid_l, tid_r, n_tokens), token ids aligned with df_e's rows (numpy
    arrays or tensors); those columns aggregate on ``device`` (``cuda``
    unless the caller names another) instead of by a host groupby.
    """
    tf_cols = list(term_frequency_columns(settings))
    if not tf_cols:
        warnings.warn(
            "No term frequency adjustment columns are specified in your "
            "settings object. Returning original df"
        )
        return df_e

    df = df_e.copy()
    base_lambda = params.params["λ"]
    adj_arrays = []
    for col in tf_cols:
        if pair_token_ids is not None and col in pair_token_ids:
            tid_l, tid_r, n_tokens = pair_token_ids[col]
            adj, _, _ = compute_token_adjustment_device(
                tid_l,
                tid_r,
                df["match_probability"].to_numpy(),
                base_lambda,
                n_tokens,
                device=device,
            )
        else:
            adj, _ = compute_token_adjustment(
                df[f"{col}_l"].to_numpy(dtype=object),
                df[f"{col}_r"].to_numpy(dtype=object),
                df["match_probability"].to_numpy(),
                base_lambda,
            )
        df[f"{col}_adj"] = adj
        adj_arrays.append(adj)

    df["tf_adjusted_match_prob"] = bayes_combine(
        [df["match_probability"].to_numpy()] + adj_arrays
    )
    if not retain_adjustment_columns:
        df = df.drop(columns=[f"{c}_adj" for c in tf_cols])

    # Column order: tf_adjusted_match_prob leads, as in the reference
    # (splink/term_frequencies.py:108-115).
    lead = ["tf_adjusted_match_prob", "match_probability"]
    rest = [c for c in df.columns if c not in lead]
    return df[lead + rest]
