from .fellegi_sunter import (
    FSParams,
    SufficientStats,
    em_step,
    fold_logit,
    gamma_prob_lookup,
    log_bayes_factor,
    log_likelihood,
    match_logit,
    match_probability,
    sufficient_stats,
    update_params,
)

__all__ = [
    "FSParams",
    "SufficientStats",
    "em_step",
    "fold_logit",
    "gamma_prob_lookup",
    "log_bayes_factor",
    "log_likelihood",
    "match_logit",
    "match_probability",
    "sufficient_stats",
    "update_params",
]
