"""NL002 good twin: max-shift or clamp before leaving log space."""

import torch


def linear_weights(log_w):
    return torch.exp(log_w - torch.max(log_w))


def linear_weights_method(log_w):
    return log_w.clamp(max=80.0).exp()
