"""NL003 bad twin: divisions by unguarded count/probability sums."""

import torch


def match_rate(weights):
    total = torch.sum(weights)
    # an all-zero/empty batch zeroes the denominator
    return weights / total


def match_share(weights):
    return weights / weights.sum(dim=0)


def bayes_posterior(num, den):
    return num / (num + den)  # numlint: disable=NL003 (the twin's suppressed copy)
