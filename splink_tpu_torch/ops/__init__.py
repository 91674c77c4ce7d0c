"""Comparison ops on torch tensors. ``strings_cuda`` (the hand-written
kernels' wrappers) imports nothing CUDA-specific until a kernel is called."""

from . import gamma, jw_bound, numeric, phonetic, qgram, strings  # noqa: F401
