"""NL001 good twin: the operand is floored before the log."""

import torch

EPS = 1e-12


def log_table(m):
    return torch.log(torch.clamp(m, min=torch.finfo(m.dtype).tiny))


def log_table_method(m):
    return (m + EPS).log2()


def log_uniform(hk):
    # the floor survives the conversion to float64
    u = (hk.to(torch.float32) + 0.5) * 2.0 ** -32
    return torch.log(u.to(torch.float64))
