"""NL005 bad twin: exact float equality in device code."""

import torch


def converged(delta, scores):
    exact_zero = torch.sum(scores) == 0.0
    return exact_zero & (delta != 1.5)


def saturated(p):
    return p.sigmoid() == 1


def converged_waived(scores):
    return torch.sum(scores) == 0.0  # numlint: disable=NL005 (the twin's suppressed copy)
