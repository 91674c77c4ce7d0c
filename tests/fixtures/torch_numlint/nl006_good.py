"""NL006 good twin: column-by-column accumulation in fold_logit's order;
an integer count is exact in any order."""

from splink_tpu_torch.models.fellegi_sunter import fold_logit


def tf_adjusted_logit(G, params, tf_deltas):
    base = fold_logit(G, params)
    for ci in range(tf_deltas.shape[1]):
        base = base + tf_deltas[:, ci]
    return base


def fold_mismatches(G, params, want):
    return (fold_logit(G, params) != want).sum()
