"""EM training loop with the parameters resident on the device.

The counterpart of splink_tpu/em.py (``run_em``, ``EMResult``,
``trimmed_trajectory``, ``score_pairs*``). The reference compiles the whole
loop into one ``lax.while_loop``; PyTorch runs eagerly, so here it is a
Python loop whose tensors stay on the device, with ONE host read per update
(the convergence flag) and the histories copied back once at the end. The
history layout is the reference's: index i holds the parameters before
update i+1, so index 0 is the initial state.

``run_em_checkpointed`` is the reference's checkpointed EM: the same loop,
with a host hook after every update that guards against non-finite values
(``EMNumericsError``) and writes an atomic checkpoint every
``checkpoint_every`` updates. The reference needs an ``io_callback``
inside its compiled ``while_loop`` for that; here the loop is Python, so
the hook is a plain call.
"""

from __future__ import annotations

import logging
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

logger = logging.getLogger("splink_tpu_torch")


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
    on_update=None,
) -> EMResult:
    """Run EM to convergence on the device ``G`` lives on.

    Convergence matches the reference: the largest absolute change across
    all pi probabilities (lambda excluded) must drop below
    ``em_convergence``, compared in the working float type.

    ``on_update(it, new_params, ll_pre, converged)`` runs after each update
    and before its values enter the histories (``ll_pre``: the log
    likelihood under the pre-update parameters, None without compute_ll).
    It reads and never writes, so the trajectory is the same with or
    without it; an exception it raises ends the run."""
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
        ll_pre = None
        if compute_ll:
            # ll under the PRE-update params, archived at the pre-update
            # index (the reference computes it in the E-step)
            ll_pre = log_likelihood(G, params, weights)
        converged = bool(delta < tol)  # the one host read per update
        if on_update is not None:
            on_update(it + 1, new, ll_pre, converged)
        if compute_ll:
            ll_h[it] = ll_pre
        it += 1
        lam_h[it], m_h[it], u_h[it] = new.lam, new.m, new.u
        params = new
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


class EMNumericsError(RuntimeError):
    """A non-finite value entered the EM trajectory.

    Raised by :func:`run_em_checkpointed`'s per-update hook the moment an
    update delivers NaN/Inf in lambda, m, u or the log likelihood — before
    the poisoned values reach the histories or a checkpoint, so everything
    persisted stays finite. Carries the first poisoned iteration, which
    fields were non-finite, the last finite iteration, and (when the run
    checkpoints) the directory plus the last boundary iteration already on
    disk — the state a caller restarts from."""

    def __init__(
        self,
        message: str,
        *,
        iteration: int,
        fields: list,
        last_good_iteration: int,
        checkpoint_dir=None,
        last_checkpoint_iteration=None,
    ):
        super().__init__(message)
        self.iteration = iteration
        self.fields = fields
        self.last_good_iteration = last_good_iteration
        self.checkpoint_dir = checkpoint_dir
        self.last_checkpoint_iteration = last_checkpoint_iteration


def run_em_checkpointed(
    G,
    init: FSParams,
    *,
    max_iterations: int,
    max_levels: int,
    em_convergence,
    weights=None,
    compute_ll: bool = False,
    checkpoint_dir=None,
    state_hash: str = "",
    checkpoint_every: int = 5,
    resume: bool = False,
    resume_checkpoint=None,
    fault_plan=None,
    on_segment=None,
) -> EMResult:
    """:func:`run_em` with an atomic checkpoint every ``checkpoint_every``
    updates (splink_tpu em.run_em_checkpointed).

    The per-update computation IS ``run_em``'s (the hook only reads), so
    the trajectory is bit-identical to an uninterrupted ``run_em``. Per
    update the hook first checks that lambda, m, u (and the log likelihood
    with ``compute_ll``) are finite, raising :class:`EMNumericsError`
    otherwise; then it records the update in the host histories. At each
    boundary (iteration divisible by K, convergence, or the last update)
    it writes the checkpoint, fires the ``segment`` fault site and calls
    ``on_segment(done, histories, converged)``. An interrupted run resumes
    (``resume=True``) from its last boundary.

    Histories are host numpy arrays in run_em's layout (index i = params
    before update i+1; ll index i = log likelihood under params i)."""
    from .resilience.checkpoint import EMCheckpoint, load_checkpoint, save_checkpoint

    if resume and checkpoint_dir is None:
        raise ValueError(
            "resume=True requires checkpoint_dir — silently training from "
            "scratch is exactly the surprise a resume caller cannot afford."
        )
    dev, dtype = init.m.device, init.m.dtype
    m0 = init.m.cpu().numpy()
    C, L = m0.shape
    np_dtype = m0.dtype
    n_hist = max_iterations + 1
    lam_h = np.full((n_hist,), np.nan, np_dtype)
    m_h = np.zeros((n_hist, C, L), np_dtype)
    u_h = np.zeros((n_hist, C, L), np_dtype)
    ll_h = np.full((n_hist,), np.nan, np_dtype)
    lam_h[0] = init.lam.cpu().numpy()
    m_h[0] = m0
    u_h[0] = init.u.cpu().numpy()

    def to_params(lam, m, u):
        t = lambda a: torch.as_tensor(np.asarray(a, np_dtype), dtype=dtype, device=dev)  # noqa: E731
        return FSParams(lam=t(lam), m=t(m), u=t(u))

    done = 0
    converged = False
    params = init
    if resume:
        ckpt = (resume_checkpoint if resume_checkpoint is not None
                else load_checkpoint(checkpoint_dir, expect_hash=state_hash or None))
        if ckpt is not None:
            h = ckpt.history_arrays()
            done = min(ckpt.iteration, max_iterations)
            lam_h[: done + 1] = h["lam"][: done + 1].astype(np_dtype)
            m_h[: done + 1] = h["m"][: done + 1].astype(np_dtype)
            u_h[: done + 1] = h["u"][: done + 1].astype(np_dtype)
            if compute_ll and h["ll"] is not None:
                n_ll = min(len(h["ll"]), done + 1)
                ll_h[:n_ll] = h["ll"][:n_ll].astype(np_dtype)
            if ckpt.iteration > max_iterations:
                # the iteration cap was lowered below the checkpoint: the
                # truncated trajectory's own params (history index done)
                params = to_params(lam_h[done], m_h[done], u_h[done])
                converged = False
            else:
                params = to_params(*ckpt.params_arrays())
                converged = ckpt.converged

    # the numerics guard reports the newest boundary already on disk as the
    # restart point, so _save records what it persisted
    last_saved = {"iteration": None}

    def _save(iteration, conv):
        if checkpoint_dir is None:
            return
        save_checkpoint(
            checkpoint_dir,
            EMCheckpoint(
                state_hash=state_hash,
                iteration=iteration,
                lam=float(lam_h[iteration]),
                m=m_h[iteration].tolist(),
                u=u_h[iteration].tolist(),
                histories={
                    "lam": lam_h[: iteration + 1].tolist(),
                    "m": m_h[: iteration + 1].tolist(),
                    "u": u_h[: iteration + 1].tolist(),
                    # not-yet-computed entries (the boundary's own ll comes
                    # one update later) persist as null, never a filler
                    "ll": (
                        [None if np.isnan(v) else float(v) for v in ll_h[: iteration + 1]]
                        if compute_ll else None
                    ),
                },
                converged=conv,
                process_count=1,
                dtype=np_dtype.name,
            ),
        )
        last_saved["iteration"] = int(iteration)

    checkpoint_every = max(int(checkpoint_every), 1)
    start = done
    remaining = max_iterations - done
    hook_needed = (checkpoint_dir is not None or on_segment is not None
                   or (fault_plan is not None and bool(fault_plan)))

    def hook(it_rel, new, ll_pre, conv):
        it = start + int(it_rel)
        lam, m, u = (t.cpu().numpy() for t in new)
        ll = float(ll_pre) if ll_pre is not None else float("nan")
        bad = [name for name, v in (("lam", lam), ("m", m), ("u", u))
               if not np.isfinite(v).all()]
        if compute_ll and not np.isfinite(ll):
            bad.append("ll")
        if bad:
            info = dict(
                iteration=it, fields=bad, last_good_iteration=it - 1,
                checkpoint_dir=str(checkpoint_dir) if checkpoint_dir is not None else None,
                last_checkpoint_iteration=last_saved["iteration"],
            )
            logger.warning("em_numerics: %s", info)
            where = (f"; last checkpoint at iteration {last_saved['iteration']} in "
                     f"{checkpoint_dir}" if last_saved["iteration"] is not None else "")
            raise EMNumericsError(
                f"non-finite EM update at iteration {it} ({', '.join(bad)}); last "
                f"finite iteration {it - 1}{where}",
                **info,
            )
        lam_h[it], m_h[it], u_h[it] = lam, m, u
        if compute_ll:
            ll_h[it - 1] = ll
        if conv or it == max_iterations or it % checkpoint_every == 0:
            # durability first: an injected kill at this boundary must find
            # the boundary's own update already on disk
            _save(it, conv)
            if fault_plan is not None:
                fault_plan.fire("segment", iter=it)
            if on_segment is not None:
                on_segment(it, {"lam": lam_h, "m": m_h, "u": u_h, "ll": ll_h}, conv)

    if remaining > 0 and not converged:
        result = run_em(
            G, params, max_iterations=remaining, max_levels=max_levels,
            em_convergence=em_convergence, weights=weights, compute_ll=compute_ll,
            on_update=hook if hook_needed else None,
        )
        n_rel = int(result.n_updates)
        # the hook already wrote these indices; the merge rewrites them with
        # the same values and is what the hook-free path relies on
        lam_h[start + 1 : start + n_rel + 1] = result.lam_history[1 : n_rel + 1]
        m_h[start + 1 : start + n_rel + 1] = result.m_history[1 : n_rel + 1]
        u_h[start + 1 : start + n_rel + 1] = result.u_history[1 : n_rel + 1]
        if compute_ll:
            ll_h[start : start + n_rel + 1] = result.ll_history[: n_rel + 1]
        params = result.params
        done = start + n_rel
        converged = bool(result.converged)
        if checkpoint_dir is not None:
            # the last in-loop save could not include the final log
            # likelihood (computed after the loop); re-save so that a resume
            # of a finished run reproduces the uninterrupted run's Params
            _save(done, converged)

    return EMResult(
        params=params,
        n_updates=done,
        converged=converged,
        lam_history=lam_h,
        m_history=m_h,
        u_history=u_h,
        ll_history=ll_h,
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
