"""Fellegi-Sunter model mathematics on torch tensors.

The torch counterpart of splink_tpu/models/fellegi_sunter.py, function for
function and in the same order of float operations, so the port can be held
to the reference: the E-step's naive-Bayes match probability in log space,
the M-step's sufficient statistics, and gamma = -1 (null) contributing
probability 1 to numerator and denominator and nothing to a column's M-step
normaliser.

Shapes: G is (n_pairs, n_cols) int8 with entries in {-1, 0, .., L_c - 1};
m/u are (n_cols, max_levels); weights is (n_pairs,) with 0 marking padding.
No gradient is involved anywhere: EM is not trained by autograd.
"""

from __future__ import annotations

from typing import NamedTuple

import torch


class FSParams(NamedTuple):
    """Fellegi-Sunter parameters as tensors on one device."""

    lam: torch.Tensor  # scalar: prior P(match)
    m: torch.Tensor  # (C, L): P(gamma = level | match)
    u: torch.Tensor  # (C, L): P(gamma = level | non-match)


class SufficientStats(NamedTuple):
    """Accumulable EM sufficient statistics."""

    m_num: torch.Tensor  # (C, L): sum of p over rows with gamma_c = level
    u_num: torch.Tensor  # (C, L): sum of 1-p over rows with gamma_c = level
    m_den: torch.Tensor  # (C,): sum of p over rows with gamma_c != -1
    u_den: torch.Tensor  # (C,): sum of 1-p over rows with gamma_c != -1
    sum_p: torch.Tensor  # scalar: sum of p over all rows
    n_rows: torch.Tensor  # scalar: number of (real) rows

    def __add__(self, other: "SufficientStats") -> "SufficientStats":
        return SufficientStats(*(a + b for a, b in zip(self, other)))


def _safe_log(x):
    return torch.log(torch.clamp(x, min=torch.finfo(x.dtype).tiny))


def _select_levels(G, table):
    """(n, C) table[c, G[n, c]] as a masked sum over the level axis, like
    the reference (entries where G = -1 come out as 0)."""
    zero = torch.zeros((), dtype=table.dtype, device=table.device)
    out = torch.zeros(G.shape, dtype=table.dtype, device=table.device)
    for lv in range(table.shape[1]):
        out = out + torch.where(G == lv, table[None, :, lv], zero)
    return out


def gamma_log_probs(G, probs):
    """(n, C) log prob of each row's gamma level under `probs`; 0 where null."""
    lp = _select_levels(G, _safe_log(probs))
    return torch.where(G >= 0, lp, torch.zeros((), dtype=lp.dtype, device=lp.device))


def _sum_columns(x):
    """(n, C) -> (n,) summed left to right over the columns: the order the
    reference's XLA reduction takes on the CPU, so that given the same log
    tables the match logit is bit-identical (torch.sum may reassociate)."""
    acc = x[:, 0]
    for c in range(1, x.shape[1]):
        acc = acc + x[:, c]
    return acc


def log_bayes_factor(G, params: FSParams):
    """(n,) summed per-column log(m/u) evidence."""
    return _sum_columns(gamma_log_probs(G, params.m) - gamma_log_probs(G, params.u))


def _prior_logit(lam):
    return _safe_log(lam) - _safe_log(1.0 - lam)


def match_logit(G, params: FSParams):
    """(n,) pre-sigmoid match evidence: logit(lambda) + log Bayes factor."""
    return _prior_logit(params.lam) + log_bayes_factor(G, params)


def match_probability(G, params: FSParams):
    """E-step: P(match | gamma vector) = sigmoid(logit(lambda) + log BF)."""
    return torch.sigmoid(match_logit(G, params))


def fold_logit(G, params: FSParams):
    """:func:`match_logit` with the log Bayes factor accumulated column by
    column, left to right, per-column masked level lookups included — the
    exact expression tree of splink_tpu's ``fold_logit``
    (models/fellegi_sunter.py:114-148), which term-frequency parity anchors
    on. Given the same log tables it is bit-identical to the reference."""
    log_m = _safe_log(params.m)
    log_u = _safe_log(params.u)
    zero = torch.zeros((), dtype=log_m.dtype, device=log_m.device)
    log_bf = torch.zeros(G.shape[0], dtype=log_m.dtype, device=log_m.device)
    for ci in range(G.shape[1]):
        g = G[:, ci]
        lp_m = torch.zeros(g.shape, dtype=log_m.dtype, device=log_m.device)
        lp_u = torch.zeros(g.shape, dtype=log_u.dtype, device=log_u.device)
        for lv in range(log_m.shape[1]):
            hit = g == lv
            lp_m = lp_m + torch.where(hit, log_m[ci, lv], zero)
            lp_u = lp_u + torch.where(hit, log_u[ci, lv], zero)
        valid = g >= 0
        log_bf = log_bf + (
            torch.where(valid, lp_m, zero) - torch.where(valid, lp_u, zero)
        )
    return _prior_logit(params.lam) + log_bf


def gamma_prob_lookup(G, probs):
    """(n, C) probability of the observed gamma under `probs`, 1.0 where null
    (the reference's per-column prob_gamma_* columns)."""
    p = _select_levels(G, probs)
    return torch.where(G >= 0, p, torch.ones((), dtype=p.dtype, device=p.device))


def log_likelihood(G, params: FSParams, weights=None):
    """Sum over rows of ln(lam * prod m + (1-lam) * prod u), log-space safe."""
    log_m = _sum_columns(gamma_log_probs(G, params.m))
    log_u = _sum_columns(gamma_log_probs(G, params.u))
    ll_rows = torch.logaddexp(
        _safe_log(params.lam) + log_m, _safe_log(1.0 - params.lam) + log_u
    )
    if weights is not None:
        ll_rows = ll_rows * weights
    return torch.sum(ll_rows)


def level_design(G, max_levels: int, dtype):
    """(n, C*L + C) matrix of the M-step's indicator columns: one per
    (column, level) with G == level, then one per column with G != -1.
    G is fixed for a whole EM run, so the run builds this once and each
    update contracts it against the match weights in one matrix product."""
    levels = torch.arange(max_levels, dtype=G.dtype, device=G.device)
    onehot = (G[:, :, None] == levels[None, None, :]).reshape(G.shape[0], -1)
    return torch.cat([onehot, G >= 0], dim=1).to(dtype)


def sufficient_stats(
    G, p_match, max_levels: int, weights=None, design=None
) -> SufficientStats:
    """M-step sufficient statistics from a batch of pairs.

    The reference's one-hot einsums become one product of the indicator
    matrix (:func:`level_design`, passed in by EM so it is built once)
    with the two weight columns p and 1-p. The product runs in the working
    float type: TF32 is switched off around it."""
    dtype = p_match.dtype
    C = G.shape[1]
    if weights is None:
        weights = torch.ones(p_match.shape, dtype=dtype, device=p_match.device)
    pm = p_match * weights
    pu = (1.0 - p_match) * weights
    if design is None:
        design = level_design(G, max_levels, dtype)
    with full_precision_matmul():
        sums = design.T @ torch.stack([pm, pu], dim=1)  # (C*L + C, 2)
    cl = C * max_levels
    return SufficientStats(
        m_num=sums[:cl, 0].reshape(C, max_levels),
        u_num=sums[:cl, 1].reshape(C, max_levels),
        m_den=sums[cl:, 0],
        u_den=sums[cl:, 1],
        sum_p=torch.sum(pm),
        n_rows=torch.sum(weights),
    )


class full_precision_matmul:
    """Context manager: float32 matrix products in full float32 (TF32 off),
    restoring the caller's setting afterwards."""

    def __enter__(self):
        self._saved = torch.backends.cuda.matmul.allow_tf32
        torch.backends.cuda.matmul.allow_tf32 = False

    def __exit__(self, *exc):
        torch.backends.cuda.matmul.allow_tf32 = self._saved


def update_params(stats: SufficientStats) -> FSParams:
    """M-step parameter update. Levels never observed get probability
    exactly 0, reproducing the reference's zero-fill for unseen levels."""
    eps = torch.finfo(stats.m_num.dtype).tiny
    new_m = stats.m_num / torch.clamp(stats.m_den, min=eps)[:, None]
    new_u = stats.u_num / torch.clamp(stats.u_den, min=eps)[:, None]
    new_lam = stats.sum_p / torch.clamp(stats.n_rows, min=eps)
    return FSParams(lam=new_lam, m=new_m, u=new_u)


def em_step(G, params: FSParams, max_levels: int, weights=None, design=None):
    """One E+M step. Returns (new_params, max_pi_delta)."""
    p = match_probability(G, params)
    new = update_params(sufficient_stats(G, p, max_levels, weights, design))
    delta = torch.maximum(
        torch.max(torch.abs(new.m - params.m)),
        torch.max(torch.abs(new.u - params.u)),
    )
    return new, delta
