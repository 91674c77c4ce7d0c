"""NL004 good twin: log-space accumulation; integer counting products."""

import torch


def joint_log_prob(p):
    return torch.sum(torch.log(torch.clamp(p, min=torch.finfo(p.dtype).tiny)), dim=-1)


def positional_weights(n):
    # counting product on a pinned integer dtype: no underflow class
    return torch.cumprod(n, dim=-1, dtype=torch.int32)


def prefix_run(s1, s2):
    # an integer prefix run: the product of 0/1 agreement flags
    return torch.cumprod((s1 == s2).to(torch.int64), dim=1)
