"""Similarity -> discrete gamma-level bucketing (splink_tpu/ops/gamma.py).

The level is the count of thresholds passed; null inputs map to gamma = -1.
Every threshold compare runs in the similarity's own float type: the
reference compares an f32 score with a Python float under JAX's weak typing,
i.e. against the threshold rounded to f32, and a pair whose score sits
exactly at a threshold would change level if the compare were widened.
"""

from __future__ import annotations

import torch

GAMMA_DTYPE = torch.int8


def _threshold(t, like):
    return torch.tensor(t, dtype=like.dtype, device=like.device)


def bucket_similarity(sim, thresholds, null_mask):
    """Levels from a similarity with *descending* thresholds:
    gamma = #{i : sim > thresholds[i]}."""
    gamma = torch.zeros(sim.shape, dtype=GAMMA_DTYPE, device=sim.device)
    for t in thresholds:
        gamma = gamma + (sim > _threshold(t, sim)).to(GAMMA_DTYPE)
    return apply_null(gamma, null_mask)


def bucket_difference(diff, thresholds, null_mask):
    """Levels from a difference with *ascending* thresholds:
    gamma = #{i : diff < thresholds[i]}."""
    gamma = torch.zeros(diff.shape, dtype=GAMMA_DTYPE, device=diff.device)
    for t in thresholds:
        gamma = gamma + (diff < _threshold(t, diff)).to(GAMMA_DTYPE)
    return apply_null(gamma, null_mask)


def bucket_difference_le(diff, thresholds, null_mask, equal, top_level):
    """Levenshtein-style levels: exact equality takes the top level, then
    ascending ``<=`` thresholds fill the middle levels."""
    gamma = torch.zeros(diff.shape, dtype=GAMMA_DTYPE, device=diff.device)
    for t in thresholds:
        gamma = gamma + (diff <= _threshold(t, diff)).to(GAMMA_DTYPE)
    top = torch.tensor(top_level, dtype=GAMMA_DTYPE, device=diff.device)
    gamma = torch.where(equal, top, gamma)
    return apply_null(gamma, null_mask)


def apply_null(gamma, null_mask):
    """gamma = -1 wherever either side of the comparison is null."""
    if null_mask is None:
        return gamma
    return torch.where(
        null_mask, torch.tensor(-1, dtype=GAMMA_DTYPE, device=gamma.device), gamma
    )
