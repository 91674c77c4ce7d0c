"""Streaming EM: sufficient statistics accumulated across micro-batches.

The single-device form of splink_tpu/parallel/streaming.py. For pair sets
past ``max_resident_pairs`` whose settings cannot use the pattern-id
pipeline (a custom comparison, or a pattern space past MAX_PATTERNS),
gamma batches go to the device one at a time, the per-batch
``SufficientStats`` accumulate there, and the parameters update once per
pass over the data. A transient failure anywhere in a pass restarts the
whole pass (resilience.retry), so a retried run is bit-identical to an
undisturbed one.
"""

from __future__ import annotations

from typing import Callable, Iterable

import numpy as np
import torch

from ..models.fellegi_sunter import (
    FSParams,
    SufficientStats,
    log_likelihood,
    match_probability,
    sufficient_stats,
    update_params,
)


def _zero_stats(C: int, L: int, dtype, device) -> SufficientStats:
    z = lambda *shape: torch.zeros(shape, dtype=dtype, device=device)  # noqa: E731
    return SufficientStats(z(C, L), z(C, L), z(C), z(C), z(), z())


def _to_device(a, device, dtype=None):
    if isinstance(a, torch.Tensor):
        return a.to(device=device, dtype=dtype)
    return torch.from_numpy(np.ascontiguousarray(a)).to(device=device, dtype=dtype)


def _batch_stats(G, params: FSParams, max_levels: int, weights=None, compute_ll=False):
    """One batch's sufficient statistics and, with ``compute_ll``, its log
    likelihood (else None): the per-batch program of a streamed pass."""
    p = match_probability(G, params)
    stats = sufficient_stats(G, p, max_levels, weights)
    return stats, (log_likelihood(G, params, weights) if compute_ll else None)


def run_em_streamed(
    batch_iter_factory: Callable[[], Iterable],
    init: FSParams,
    *,
    max_iterations: int,
    max_levels: int,
    em_convergence: float,
    compute_ll: bool = False,
    on_iteration=None,
    start_iteration: int = 0,
    retry_policy=None,
    fault_plan=None,
    telemetry=None,
):
    """EM over a re-iterable stream of gamma batches on ``init``'s device.

    Args:
        batch_iter_factory: zero-arg callable returning an iterable of
            either ``G`` arrays or ``(G, weights)`` tuples, each (b, C)
            int8 (host arrays or tensors). Called once per EM iteration.
        init: starting parameters.
        on_iteration: optional callback(iteration, FSParams, ll, converged)
            run after each update (where resilience.EMCheckpointer plugs
            in); ``converged`` is True on the update that met
            em_convergence.
        start_iteration: resume support — the number of updates ``init``
            already embodies; iteration indices continue from here and at
            most ``max_iterations - start_iteration`` further updates run.
        retry_policy: optional resilience.RetryPolicy; a transient failure
            restarts the WHOLE pass (partial statistics are never reused).
        fault_plan: optional resilience.FaultPlan consulted at the
            ``batch_fetch`` (per batch) and ``em_iteration`` (per update)
            sites; None resolves the process's active plan.
        telemetry: optional ``obs.runtime.RunContext``: one EM convergence
            record per pass (from the host values the pass already read)
            and the ``em_stream_passes`` counter.

    Returns (params, histories, n_updates, converged) mirroring run_em.
    """
    from ..resilience import faults as _faults
    from ..resilience.retry import retry_call

    if fault_plan is None:
        fault_plan = _faults.active_plan()

    params = init
    C, L = init.m.shape
    dtype, device = init.m.dtype, init.m.device
    lam_hist = [float(init.lam)]
    m_hist = [init.m.cpu().numpy()]
    u_hist = [init.u.cpu().numpy()]
    ll_hist = []
    converged = False
    it = start_iteration

    def one_pass(it, params):
        """One full pass over the stream: (accumulated stats, ll parts)."""
        acc = _zero_stats(C, L, dtype, device)
        # per-batch log likelihoods stay on the device and sum at the end
        # of the pass (one host read per pass)
        ll_parts = []
        for bi, batch in enumerate(batch_iter_factory()):
            fault_plan.fire("batch_fetch", iter=it, batch=bi)
            G, w = batch if isinstance(batch, tuple) else (batch, None)
            G = _to_device(G, device)
            if w is not None:
                w = _to_device(w, device, dtype)
            stats, ll = _batch_stats(G, params, max_levels, w, compute_ll)
            acc = acc + stats
            if compute_ll:
                ll_parts.append(ll)
        return acc, ll_parts

    for it in range(start_iteration + 1, max_iterations + 1):
        if retry_policy is not None:
            acc, ll_parts = retry_call(
                lambda: one_pass(it, params), policy=retry_policy, label=f"EM pass {it}"
            )
        else:
            acc, ll_parts = one_pass(it, params)
        new = update_params(acc)
        delta = torch.maximum(
            torch.max(torch.abs(new.m - params.m)),
            torch.max(torch.abs(new.u - params.u)),
        )
        params = new
        # the one host read per pass: the convergence decision and the
        # histories need these scalars
        ll_total = float(torch.sum(torch.stack(ll_parts))) if ll_parts else 0.0
        lam_hist.append(float(params.lam))
        m_hist.append(params.m.cpu().numpy())
        u_hist.append(params.u.cpu().numpy())
        if compute_ll:
            ll_hist.append(ll_total)
        converged_now = bool(delta < em_convergence)
        if telemetry is not None:
            telemetry.em_update(it, lam_hist[-1], m_hist[-1], u_hist[-1],
                                ll_total if compute_ll else None, converged_now)
            telemetry.count("em_stream_passes")
        if on_iteration is not None:
            on_iteration(it, params, ll_total if compute_ll else None, converged_now)
        # after on_iteration, so that a checkpoint hook persists this update
        # before an injected process death (the kill-and-resume contract)
        fault_plan.fire("em_iteration", iter=it)
        if converged_now:
            converged = True
            break

    histories = {
        "lam": np.asarray(lam_hist),
        "m": np.stack(m_hist),
        "u": np.stack(u_hist),
        "ll": np.asarray(ll_hist) if compute_ll else None,
    }
    return params, histories, it, converged


def score_stream(batch_iter, params: FSParams):
    """Yield match probabilities (host arrays) for each gamma batch in the
    stream, on ``params``' device."""
    from ..em import score_pairs

    device = params.m.device
    for batch in batch_iter:
        G = batch[0] if isinstance(batch, tuple) else batch
        yield score_pairs(_to_device(G, device), params).cpu().numpy()
