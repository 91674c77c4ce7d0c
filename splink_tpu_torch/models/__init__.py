from .fellegi_sunter import (  # noqa: F401
    FSParams,
    SufficientStats,
    em_step,
    fold_logit,
    match_logit,
    match_probability,
)
