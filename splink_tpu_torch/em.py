"""EM training loop with the parameters resident on the device.

The counterpart of splink_tpu/em.py (``run_em``, ``EMResult``,
``trimmed_trajectory``, ``score_pairs*``). The reference compiles the whole
loop into one ``lax.while_loop``; PyTorch runs eagerly, so here it is a
Python loop whose tensors stay on the device, with ONE host read per update
(the convergence flag) and the histories copied back once at the end. The
history layout is the reference's: index i holds the parameters before
update i+1, so index 0 is the initial state.

Checkpointed EM (``run_em_checkpointed``) and ``EMNumericsError`` are not
ported yet (ROADMAP.md, 'checkpointing').
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from .models.fellegi_sunter import (
    FSParams,
    fold_logit,
    gamma_prob_lookup,
    level_design,
    log_likelihood,
    match_probability,
    sufficient_stats,
    update_params,
)


class EMResult(NamedTuple):
    params: FSParams  # final parameters (tensors on the device)
    n_updates: int  # number of M-step updates performed
    converged: bool  # stopped because delta < tol
    lam_history: np.ndarray  # (max_iter + 1,), entry 0 = initial
    m_history: np.ndarray  # (max_iter + 1, C, L)
    u_history: np.ndarray  # (max_iter + 1, C, L)
    ll_history: np.ndarray  # (max_iter + 1,) ll under params i (nan if not computed)


def run_em(
    G,
    init: FSParams,
    *,
    max_iterations: int,
    max_levels: int,
    em_convergence,
    weights=None,
    compute_ll: bool = False,
) -> EMResult:
    """Run EM to convergence on the device ``G`` lives on.

    Convergence matches the reference: the largest absolute change across
    all pi probabilities (lambda excluded) must drop below
    ``em_convergence``, compared in the working float type."""
    C, L = init.m.shape
    dtype = init.m.dtype
    dev = init.m.device
    n_hist = max_iterations + 1
    lam_h = torch.full((n_hist,), float("nan"), dtype=dtype, device=dev)
    m_h = torch.zeros((n_hist, C, L), dtype=dtype, device=dev)
    u_h = torch.zeros((n_hist, C, L), dtype=dtype, device=dev)
    ll_h = torch.full((n_hist,), float("nan"), dtype=dtype, device=dev)
    lam_h[0], m_h[0], u_h[0] = init.lam, init.m, init.u
    tol = torch.tensor(em_convergence, dtype=dtype, device=dev)

    params = init
    it = 0
    converged = False
    if max_iterations > 0:
        design = level_design(G, max_levels, dtype)
    while it < max_iterations and not converged:
        p = match_probability(G, params)
        new = update_params(
            sufficient_stats(G, p, max_levels, weights, design)
        )
        delta = torch.maximum(
            torch.max(torch.abs(new.m - params.m)),
            torch.max(torch.abs(new.u - params.u)),
        )
        if compute_ll:
            # ll under the PRE-update params, archived at the pre-update
            # index (the reference computes it in the E-step)
            ll_h[it] = log_likelihood(G, params, weights)
        it += 1
        lam_h[it], m_h[it], u_h[it] = new.lam, new.m, new.u
        params = new
        converged = bool(delta < tol)  # the one host read per update
    if compute_ll:
        ll_h[it] = log_likelihood(G, params, weights)
    return EMResult(
        params=params,
        n_updates=it,
        converged=converged,
        lam_history=lam_h.cpu().numpy(),
        m_history=m_h.cpu().numpy(),
        u_history=u_h.cpu().numpy(),
        ll_history=ll_h.cpu().numpy(),
    )


def trimmed_trajectory(result: EMResult) -> dict:
    """Host-side convergence record of one EM run: the per-iteration log
    likelihood (entry 0 = the initial parameters; None where not
    computed) plus update count and convergence flag."""
    n = int(result.n_updates)
    ll = np.asarray(result.ll_history)[: n + 1]
    return {
        "n_updates": n,
        "converged": bool(result.converged),
        "ll": [None if np.isnan(v) else round(float(v), 4) for v in ll],
    }


def score_pairs(G, params: FSParams):
    """Final E-step scoring: match probability for every pair."""
    return match_probability(G, params)


def score_pairs_with_intermediates(G, params: FSParams):
    """Scoring plus the per-column m/u lookup probabilities the reference
    retains as prob_gamma_<col>_match / _non_match columns."""
    return (
        match_probability(G, params),
        gamma_prob_lookup(G, params.m),
        gamma_prob_lookup(G, params.u),
    )


def score_pairs_with_logits(G, params: FSParams):
    """(p, fold_logit): ``p`` stays the canonical ``match_probability``; the
    logit carries the left-to-right accumulation order."""
    return match_probability(G, params), fold_logit(G, params)


def score_pairs_with_intermediates_logits(G, params: FSParams):
    """score_pairs_with_intermediates plus the fold logit."""
    return (*score_pairs_with_intermediates(G, params), fold_logit(G, params))
