"""The yardstick: the card's peaks and the work a kernel needs.

Peaks of one NVIDIA H100 SXM (NVIDIA's data sheet): 3.35 TB/s of HBM.
The data sheet gives no integer rate: 67 TFLOP/s of FP32 outside the
tensor cores counts an FMA as two operations on 128 FP32 lanes a
multiprocessor, and Hopper has 64 INT32 lanes a multiprocessor, so the
INT32 rate is taken as a quarter of the FP32 flop rate (assumed, not
published).
"""

from __future__ import annotations

import torch

HBM_BYTES_PER_S = 3.35e12
INT32_OPS_PER_S = 67e12 / 4  # assumed: see the module docstring


def padded_width(longest: int, max_string_length: int) -> int:
    """The width of a string column as the kernels receive it: the longest
    value rounded up to 8, capped by max_string_length rounded up to 8."""
    pad = lambda v: -(-max(int(v), 1) // 8) * 8  # noqa: E731
    return min(pad(longest), pad(max_string_length))


def levenshtein_ops(l1, l2, char_bytes: int) -> int:
    """The word operations Levenshtein needs on pairs of lengths ``l1``,
    ``l2`` (tensors), per pair with both sides non-empty: the shorter string
    (lt) steps through the longer (lp) in ceil(lp / 32) words, 15 bit-vector
    operations a word and step, plus the match words built the cheaper of
    two ways: compares at every step (ceil(lp / 4) for one-byte characters,
    lp for 32-bit codepoints) or a match table built once (one bit a pattern
    character, and for bytes 256 x ceil(lp / 32) words zeroed) and read once
    a word and step."""
    lt = torch.minimum(l1, l2).to(torch.int64)
    lp = torch.maximum(l1, l2).to(torch.int64)
    words = (lp + 31) // 32
    compares = lt * ((lp + 3) // 4 if char_bytes == 1 else lp)
    table = lp + lt * words + (256 * words if char_bytes == 1 else 0)
    ops = 15 * lt * words + torch.minimum(compares, table)
    return int(torch.where(lt > 0, ops, 0).sum())


def levenshtein_bytes(n_pairs: int, width: int, char_bytes: int) -> int:
    """Bytes a launch over ``n_pairs`` pairs must move: both (width,)
    character rows and both int32 lengths read once, one 4-byte distance
    written."""
    return n_pairs * (2 * width * char_bytes + 2 * 4) + 4 * n_pairs


def bound_seconds(ops: int, nbytes: int) -> float:
    """The least time the card could take for this work."""
    return max(ops / INT32_OPS_PER_S, nbytes / HBM_BYTES_PER_S)
