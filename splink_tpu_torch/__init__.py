"""splink_tpu_torch: splink_tpu's Fellegi-Sunter record linkage on PyTorch.

A port of the JAX package ``splink_tpu`` (which stays the reference) to
PyTorch and CUDA for an NVIDIA H100. It imports neither jax nor anything of
splink_tpu; model JSON files are interchangeable between the two packages.

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``;
without a CUDA device and without that argument they raise. The two string
kernels of the reference's TPU path (Jaro-Winkler, Levenshtein) are
hand-written CUDA (csrc/jaro_winkler.cu, csrc/levenshtein.cu, sharing
csrc/common.cuh), built with nvcc at first use; the host work of encoding
and blocking runs splink_tpu's C++ library (native/src/host_kernels.cpp),
built with g++ at first use. Every comparison kind of splink_tpu runs
here: the q-gram and charset similarities (``ops.qgram``), double
metaphone (``ops.phonetic``), hand-written SQL CASE expressions
(``case_compiler``) and functions registered with
``register_comparison``. Term-frequency adjustment lives in
``term_frequencies`` (and ``Splink.make_term_frequency_adjustments``), the
intuition report in ``intuition``; like splink_tpu, the package exports
neither module's names.
"""

__version__ = "0.1.0"

from . import ops, parallel
from ._device import resolve_device
from .em import EMResult, run_em, score_pairs, score_pairs_with_intermediates
from .gammas import register_comparison
from .linker import Splink, load_from_json
from .models.fellegi_sunter import FSParams, SufficientStats
from .params import (
    Params,
    fsparams_from_numpy,
    fsparams_to_numpy,
    load_params_from_dict,
    load_params_from_json,
)
from .settings import complete_settings_dict
from .validate import validate_settings

__all__ = [
    "__version__",
    "ops",
    "parallel",
    "EMResult",
    "FSParams",
    "Params",
    "Splink",
    "SufficientStats",
    "complete_settings_dict",
    "fsparams_from_numpy",
    "fsparams_to_numpy",
    "load_from_json",
    "load_params_from_dict",
    "load_params_from_json",
    "register_comparison",
    "resolve_device",
    "run_em",
    "score_pairs",
    "score_pairs_with_intermediates",
    "validate_settings",
]
