"""NL005 good twin: tolerance comparisons; integer reductions."""

import torch


def converged(delta, scores, tol):
    near_zero = torch.abs(torch.sum(scores)) <= tol
    return near_zero & (torch.abs(delta - 1.5) <= tol)


def no_hits(mask):
    # integer-pinned count: exact equality is well-defined
    return torch.sum(mask, dtype=torch.int32) == 0


def no_agreements(g):
    return (g == 2).sum() == 0
