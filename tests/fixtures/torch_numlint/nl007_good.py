"""NL007 good twin: clamp into [eps, 1 - eps] before the round-trip."""

import torch

EPS = 1e-7


def recovered_logit(p):
    q = torch.clamp(p, EPS, 1.0 - EPS)
    return torch.log(q / (1.0 - q))


def recovered_logit_direct(p):
    return torch.logit(p, eps=EPS)
