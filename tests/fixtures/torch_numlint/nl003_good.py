"""NL003 good twin: floored or branch-guarded denominators."""

import torch


def match_rate(weights):
    total = torch.clamp(torch.sum(weights), min=1.0)
    return weights / total


def match_share(weights):
    return weights / weights.sum(dim=0).clamp_min(1e-12)


def bayes_posterior(num, den):
    tot = num + den
    if tot <= 0:
        return torch.full_like(num, 0.5)
    return num / tot
