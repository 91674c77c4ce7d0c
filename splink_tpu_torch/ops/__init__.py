"""Comparison ops on torch tensors. ``strings_cuda`` (the hand-written
kernels' wrappers) imports nothing CUDA-specific until a kernel is called."""

from . import gamma, jw_bound, numeric, phonetic, qgram, strings
from .phonetic import double_metaphone, double_metaphone_primary
from .qgram import qgram_cosine_distance, qgram_jaccard, qgram_tokenise
from .strings import exact_equal, jaro_winkler, levenshtein, levenshtein_ratio

__all__ = [
    "gamma",
    "jw_bound",
    "numeric",
    "phonetic",
    "qgram",
    "strings",
    "double_metaphone",
    "double_metaphone_primary",
    "qgram_cosine_distance",
    "qgram_jaccard",
    "qgram_tokenise",
    "exact_equal",
    "jaro_winkler",
    "levenshtein",
    "levenshtein_ratio",
]
