"""Numeric comparison kernels (splink_tpu/ops/numeric.py): absolute and
relative difference, with the reference's strict ``<`` thresholds."""

from __future__ import annotations

import torch


def abs_difference(a, b):
    return torch.abs(a - b)


def relative_difference(a, b):
    """|a - b| / |max(a, b)|; a zero denominator yields +inf (SQL division by
    zero is NULL, so no ``< t`` branch fires)."""
    denom = torch.abs(torch.maximum(a, b))
    diff = torch.abs(a - b)
    inf = torch.tensor(float("inf"), dtype=diff.dtype, device=diff.device)
    return torch.where(denom > 0, diff / denom, inf)
