"""NL007 bad twin: unclamped sigmoid->logit round-trips."""

import torch


def recovered_logit(p):
    # p saturates to exactly 1.0 in f32 beyond ~17 logits of evidence
    return torch.log(p / (1.0 - p))


def recovered_logit_direct(p):
    return torch.logit(p)


def recovered_logit_waived(p):
    return torch.log(p / (1.0 - p))  # numlint: disable=NL007 (the twin's suppressed copy)
