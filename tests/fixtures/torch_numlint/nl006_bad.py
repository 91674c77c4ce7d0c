"""NL006 bad twin: reduce-tree reduction inside a fold-order-contracted
scoring path."""

import torch

from splink_tpu_torch.models.fellegi_sunter import fold_logit


def tf_adjusted_logit(G, params, tf_deltas):
    base = fold_logit(G, params)
    # torch.sum's reduce tree diverges from the running accumulator in the
    # last ulp past ~2 columns
    return base + torch.sum(tf_deltas, dim=-1)


def tf_adjusted_logit_method(G, params, tf_deltas):
    return fold_logit(G, params) + tf_deltas.sum(dim=-1)


def tf_adjusted_logit_waived(G, params, tf_deltas):
    base = fold_logit(G, params)
    return base + torch.sum(tf_deltas, dim=-1)  # numlint: disable=NL006 (the twin's suppressed copy)
