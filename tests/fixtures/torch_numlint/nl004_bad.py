"""NL004 bad twin: linear-space probability products in device code."""

import torch


def joint_prob(p):
    # a few dozen small factors underflow f32
    return torch.prod(p, dim=-1)


def running_prob(p):
    return p.cumprod(dim=-1)


def joint_prob_waived(p):
    return torch.prod(p, dim=-1)  # numlint: disable=NL004 (the twin's suppressed copy)
