"""Fellegi-Sunter EM, plain, on a weighted table of gamma patterns.

E-step: for a pattern g, P(g | match) is the product over its non-null
columns of m[c, g_c] (u for non-matches) and p = lambda P_m / (lambda P_m
+ (1 - lambda) P_u). M-step: m[c, l] is the p-weighted share of level l
among the pairs whose column c is not null, u likewise with 1 - p, and
lambda the p-weighted share of all pairs. EM stops after the update whose
largest absolute change of any m or u falls below ``em_convergence``, or
after ``max_iterations`` updates. The trajectory starts from the
settings' priors.
"""

from __future__ import annotations

import numpy as np
import torch


def priors(settings: dict):
    """(lambda, m (C, L), u (C, L)) of the settings, normalised, as float64
    arrays; levels past a column's count are 0."""
    cols = settings["comparison_columns"]
    width = max(int(c["num_levels"]) for c in cols)
    m = np.zeros((len(cols), width))
    u = np.zeros((len(cols), width))
    for i, c in enumerate(cols):
        lv = int(c["num_levels"])
        m[i, :lv] = np.asarray(c["m_probabilities"], np.float64) / sum(c["m_probabilities"])
        u[i, :lv] = np.asarray(c["u_probabilities"], np.float64) / sum(c["u_probabilities"])
    return float(settings["proportion_of_matches"]), m, u


def run_em(patterns: np.ndarray, weights: np.ndarray, settings: dict,
           dtype=torch.float64):
    """EM over ``patterns`` (P, C) int levels weighted by ``weights`` (P,),
    in ``dtype`` on the CPU. Returns the trajectory: a list of (lambda, m,
    u) float64 arrays, the priors first, one entry per update after."""
    lam0, m0, u0 = priors(settings)
    G = torch.from_numpy(np.asarray(patterns, np.int64))
    w = torch.from_numpy(np.asarray(weights, np.float64)).to(dtype)
    n_cols, width = m0.shape
    lam = torch.tensor(lam0, dtype=torch.float64).to(dtype)
    m = torch.from_numpy(m0).to(dtype)
    u = torch.from_numpy(u0).to(dtype)
    tol = torch.tensor(float(settings["em_convergence"]), dtype=dtype)
    one = torch.ones((), dtype=dtype)
    zero = torch.zeros((), dtype=dtype)
    valid = G >= 0
    safe = torch.clamp(G, min=0)
    cols = torch.arange(n_cols)[None, :]
    onehot = torch.stack([(G == lv) for lv in range(width)], dim=2).to(dtype)  # (P, C, L)
    trajectory = [_arrays(lam, m, u)]
    for _ in range(int(settings["max_iterations"])):
        pm = torch.where(valid, m[cols, safe], one).prod(dim=1)
        pu = torch.where(valid, u[cols, safe], one).prod(dim=1)
        num = lam * pm
        den = num + (one - lam) * pu
        p = torch.where(den > 0, num / torch.where(den > 0, den, one), zero)
        wp, wq = w * p, w * (one - p)
        m_num = (onehot * wp[:, None, None]).sum(dim=0)
        u_num = (onehot * wq[:, None, None]).sum(dim=0)
        m_den = (valid.to(dtype) * wp[:, None]).sum(dim=0)
        u_den = (valid.to(dtype) * wq[:, None]).sum(dim=0)
        new_m = torch.where(m_den[:, None] > 0, m_num / torch.where(m_den > 0, m_den, one)[:, None],
                            zero)
        new_u = torch.where(u_den[:, None] > 0, u_num / torch.where(u_den > 0, u_den, one)[:, None],
                            zero)
        new_lam = wp.sum() / w.sum()
        delta = torch.maximum((new_m - m).abs().max(), (new_u - u).abs().max())
        lam, m, u = new_lam, new_m, new_u
        trajectory.append(_arrays(lam, m, u))
        if bool(delta < tol):
            break
    return trajectory


def _arrays(lam, m, u):
    return (float(lam.to(torch.float64)), m.to(torch.float64).numpy().copy(),
            u.to(torch.float64).numpy().copy())


def program_trajectory(params, settings: dict):
    """The trajectory of a fitted ``Params`` (its history, then its current
    values) as (lambda, m, u) float64 arrays in the layout of ``priors``:
    read from the parameters' dictionaries, level by level."""
    cols = settings["comparison_columns"]
    width = max(int(c["num_levels"]) for c in cols)
    out = []
    for state in list(params.param_history) + [params.params]:
        m = np.zeros((len(cols), width))
        u = np.zeros((len(cols), width))
        for i, c in enumerate(cols):
            entry = state["π"][f"gamma_{c['col_name']}"]
            for lv in range(int(c["num_levels"])):
                m[i, lv] = entry["prob_dist_match"][f"level_{lv}"]["probability"]
                u[i, lv] = entry["prob_dist_non_match"][f"level_{lv}"]["probability"]
        out.append((float(state["λ"]), m, u))
    return out


def _leaves(lam, m, u):
    """lambda, then each column's m vector and u vector."""
    return [np.array([lam])] + [row for row in m] + [row for row in u]


def trajectory_gap(got, want) -> float:
    """The worst leaf's gap over the updates both trajectories reached: for
    each leaf (lambda, one column's m, one column's u), the largest
    absolute difference of its entries over the larger of the reference
    leaf's norm and the median leaf's norm. (A probability far below its
    leaf's scale, such as u of a level that non-matches all but never take,
    is held to that scale and not to its own size: float32 arithmetic keeps
    (1 - p) only to about 6e-8 of 1.)"""
    worst = 0.0
    for g, w in zip(got, want):
        gl, wl = _leaves(*g), _leaves(*w)
        norms = np.array([np.linalg.norm(x) for x in wl])
        scale = np.maximum(norms, np.median(norms))
        for a, b, sc in zip(gl, wl, scale):
            worst = max(worst, float(np.abs(a - b).max() / sc))
    return worst


def worst_leaf(got, want):
    """(update, leaf, gap) of the largest gap, for reports: leaf 0 is
    lambda, 1..C the columns' m, C+1..2C their u."""
    best = (0, 0, 0.0)
    for k, (g, w) in enumerate(zip(got, want)):
        gl, wl = _leaves(*g), _leaves(*w)
        norms = np.array([np.linalg.norm(x) for x in wl])
        scale = np.maximum(norms, np.median(norms))
        for i, (a, b, sc) in enumerate(zip(gl, wl, scale)):
            gap = float(np.abs(a - b).max() / sc)
            if gap > best[2]:
                best = (k, i, gap)
    return best
