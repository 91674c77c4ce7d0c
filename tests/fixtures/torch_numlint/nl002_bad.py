"""NL002 bad twin: exp of an unbounded log-space quantity in device code."""

import torch


def linear_weights(log_w):
    # log-Bayes sums grow with column count; exp overflows f32 at ~88.7
    return torch.exp(log_w)


def linear_weights_method(log_w):
    return (log_w * 2).exp()


def linear_weights_waived(log_w):
    return torch.exp(log_w)  # numlint: disable=NL002 (the twin's suppressed copy)
