"""Host-side helpers that splink_tpu runs in its g++ library.

Only the numpy forms are here; the native library itself is a later item
(ROADMAP.md, 'native host library'). The self/cross join expansions live in
blocking.py's numpy paths.
"""

from __future__ import annotations

import numpy as np


def encode_fixed_width(data: np.ndarray, offsets: np.ndarray, width: int):
    """(flat uint8 buffer, int64 offsets) -> ((n, width) uint8, (n,) int32):
    row i holds ``data[offsets[i]:offsets[i+1]]`` truncated to ``width``."""
    n = len(offsets) - 1
    lens = np.minimum(np.diff(offsets), width).astype(np.int64)
    out_bytes = np.zeros((n, width), np.uint8)
    rows = np.repeat(np.arange(n, dtype=np.int64), lens)
    cols = np.arange(len(rows), dtype=np.int64) - np.repeat(
        np.cumsum(lens) - lens, lens
    )
    out_bytes[rows, cols] = data[np.repeat(offsets[:-1], lens) + cols]
    return out_bytes, lens.astype(np.int32)
