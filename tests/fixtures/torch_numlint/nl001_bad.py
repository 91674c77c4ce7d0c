"""NL001 bad twin: raw log on possibly-zero probability tables."""

import torch


def log_table(m):
    # m has zero-filled levels (EM never observed them): log(0) = -inf
    return torch.log(m)


def log_table_method(m):
    return m.log2()


def log_table_waived(m):
    return torch.log10(m)  # numlint: disable=NL001 (the twin's suppressed copy)
