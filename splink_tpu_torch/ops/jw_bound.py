"""Cheap Jaro-Winkler upper bound for two-phase gamma scoring.

The counterpart of splink_tpu/ops/jw_bound.py; its docstring has the full
construction. In short: matched chars are bounded by the sum over 32 hashed
character classes of min(count_1, count_2) (4-bit counts packed 8 to a
word, SWAR min-sum), transpositions by 0, and the Winkler prefix by the
first four characters stored exactly; a 4-char prefix match is an
unconditional survivor (bound 2.0).

``jw_bound_row_aux`` is host numpy, as in the reference. ``jw_upper_bound``
runs on torch tensors. The packed lanes arrive as int32 (the bit patterns of
the reference's uint32 lanes), and torch has only limited uint32 support,
so the word arithmetic widens each lane to int64 holding the unsigned value
and masks explicitly after every subtraction and shift.
"""

from __future__ import annotations

import numpy as np
import torch

N_CLASSES = 32
NIBBLE_CAP = 7
OVERFLOW_BIT = np.uint32(1 << 31)

# survivor = ub >= lowest_threshold - MARGIN: absorbs f32 rounding between
# the bound arithmetic and the exact kernel's. Extra survivors get the exact
# kernel, so the margin can only add work, never change results.
BOUND_MARGIN = 1e-6

_U32 = 0xFFFFFFFF


def jw_bound_row_aux(bytes_, lengths, token_ids):
    """Host-side per-row aux for the device bound: (counts (n, 4) uint32,
    prefix (n, 1) uint32). Computed once per unique token id and gathered
    back; null rows (token -1) keep zeros — null pairs never consult the
    bound."""
    n, w = bytes_.shape
    out_cnt = np.zeros((n, 4), np.uint32)
    out_pref = np.zeros((n, 1), np.uint32)
    valid = token_ids >= 0
    if not valid.any():
        return out_cnt, out_pref
    toks = token_ids[valid]
    uniq, first_idx = np.unique(toks, return_index=True)
    reps = np.flatnonzero(valid)[first_idx]
    B = bytes_[reps].astype(np.uint32)
    L = np.minimum(lengths[reps].astype(np.int64), w)
    V = len(reps)

    pos_valid = np.arange(w)[None, :] < L[:, None]
    cls = (B & (N_CLASSES - 1)).astype(np.int64)
    flat = (np.arange(V)[:, None] * N_CLASSES + cls)[pos_valid]
    counts = np.bincount(flat, minlength=V * N_CLASSES).reshape(V, N_CLASSES)
    ovf = (counts > NIBBLE_CAP).any(axis=1)
    counts = np.minimum(counts, NIBBLE_CAP).astype(np.uint32)
    lanes = np.zeros((V, 4), np.uint32)
    for lane in range(4):
        for k in range(8):
            lanes[:, lane] |= counts[:, lane * 8 + k] << np.uint32(4 * k)

    pref = np.zeros(V, np.uint32)
    for k in range(min(4, w)):
        ch = np.where(k < L, B[:, k] & 0xFF, 0).astype(np.uint32)
        pref |= ch << np.uint32(8 * k)
    pref |= np.where(ovf, OVERFLOW_BIT, np.uint32(0))

    pos = np.searchsorted(uniq, toks)
    rows = np.flatnonzero(valid)
    out_cnt[rows] = lanes[pos]
    out_pref[rows, 0] = pref[pos]
    return out_cnt, out_pref


def _u32(x):
    """An int32 (or already widened) word as its unsigned value in int64."""
    return x.to(torch.int64) & _U32


def _nibble_min_sum(x, y):
    """sum over 8 nibbles of min(x_nib, y_nib), SWAR, on widened words.
    Requires nibbles <= 7 (bit 3 of each nibble is the borrow guard)."""
    H = 0x88888888
    F = 0x0F0F0F0F
    t = ((x | H) - y) & _U32  # per nibble: x + 8 - y; bit 3 set iff x >= y
    mask = (((t & H) >> 3) * 15) & _U32  # 0xF per nibble where x >= y
    mn = ((y & mask) | (x & ~mask)) & _U32
    s = (mn & F) + ((mn >> 4) & F)
    s = (s + (s >> 8)) & _U32
    return ((s + (s >> 16)) & 0xFF).to(torch.int32)


def jw_upper_bound(cnt1, pref1, cnt2, pref2, l1, l2,
                   prefix_scale=0.1, boost_threshold=0.7):
    """(b,) float32 >= the exact jaro_winkler of each pair; 2.0 where the
    bound cannot exclude (4-char prefix match). Inputs: the packed aux
    lanes of both sides ((b, 4) counts, (b,) prefix lane, int32 bit
    patterns or widened) and int32 lengths."""
    f32 = torch.float32
    dev = l1.device
    l1 = l1.to(torch.int32)
    l2 = l2.to(torch.int32)
    c1, c2 = _u32(cnt1), _u32(cnt2)
    p1, p2 = _u32(pref1), _u32(pref2)
    m = _nibble_min_sum(c1[:, 0], c2[:, 0])
    for lane in range(1, 4):
        m = m + _nibble_min_sum(c1[:, lane], c2[:, lane])
    la = torch.minimum(l1, l2)
    lb = torch.maximum(l1, l2)
    ovf = ((p1 | p2) & int(OVERFLOW_BIT)) != 0
    m_ub = torch.where(ovf, la, torch.minimum(m, la)).to(f32)
    one = torch.ones((), dtype=f32, device=dev)
    zero = torch.zeros((), dtype=f32, device=dev)
    l1f = torch.maximum(l1.to(f32), one)
    l2f = torch.maximum(l2.to(f32), one)
    three = torch.tensor(3.0, dtype=f32, device=dev)  # a true division on CUDA too
    jaro_ub = torch.where(m_ub > 0, (m_ub / l1f + m_ub / l2f + 1.0) / three, zero)
    d = (p1 ^ p2) & 0x7FFFFFFF
    # nested prefix flags: c1 implies c0 etc., so the run length is a sum
    p4 = (
        (((d & 0xFF) == 0) & (la > 0)).to(torch.int32)
        + (((d & 0xFFFF) == 0) & (la > 1)).to(torch.int32)
        + (((d & 0xFFFFFF) == 0) & (la > 2)).to(torch.int32)
        + ((d == 0) & (la > 3)).to(torch.int32)
    )
    scale = torch.minimum(
        torch.tensor(prefix_scale, dtype=f32, device=dev),
        1.0 / torch.maximum(lb.to(f32), one),
    )
    boosted = jaro_ub + p4.to(f32) * scale * (1.0 - jaro_ub)
    ub = torch.where(
        jaro_ub < torch.tensor(boost_threshold, dtype=f32, device=dev),
        jaro_ub, boosted,
    )
    return torch.where(p4 >= 4, torch.tensor(2.0, dtype=f32, device=dev), ub)
