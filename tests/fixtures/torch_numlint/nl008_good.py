"""NL008 good twin: width-tracking constants from torch.finfo."""

import torch


def smoothed(x):
    return x + torch.finfo(x.dtype).tiny


def capped(x):
    return x.clamp(max=torch.finfo(x.dtype).max)
