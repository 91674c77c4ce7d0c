"""Batched string similarities: plain PyTorch versions and the dispatchers.

The plain versions are the torch counterparts of splink_tpu/ops/strings.py's
vmapped forms, written out over a batch axis:

  * Jaro-Winkler with the jar (commons-text) semantics of the reference:
    the shorter string iterated over the longer, greedy first-eligible
    matching in a window of max(maxlen // 2 - 1, 0), integer-halved
    transpositions, uncapped prefix scaled by min(0.1, 1/maxlen), boost
    only at jaro >= 0.7, 0 when nothing matches. Widths <= 32 run the
    packed-bitmask greedy pass of ``jaro_winkler_bitmask_single``, wider
    columns the boolean one of ``jaro_winkler_single``; both feed the same
    transposition count, and the float expression is evaluated in the
    reference's order;
  * Levenshtein as the reference's row DP whose insertion chain is a
    prefix-min, and the ratio distance / mean length.

The dispatchers ``jaro_winkler``, ``levenshtein`` and ``levenshtein_ratio``
launch the hand-written CUDA kernels (ops/strings_cuda.py) for tensors on a
CUDA device and take the plain versions only for tensors on the CPU.
"""

from __future__ import annotations

import torch

# The plain Jaro-Winkler builds (B, L, L) intermediates: chunks of the batch
# hold at most this many B * L * L elements (2^18 rows at L = 32), so the
# plain versions can check the kernels on the card at any width
_PLAIN_ELEMENTS = 1 << 28


def _chunked(fn, *arrays):
    n, L = arrays[0].shape
    rows = max(1, _PLAIN_ELEMENTS // max(L * L, 1))
    if n <= rows:
        return fn(*arrays)
    return torch.cat([fn(*(a[s : s + rows] for a in arrays)) for s in range(0, n, rows)])


def _three(device, dtype=torch.float32):
    """3.0 as a ``dtype`` tensor on ``device``. Dividing by it, not by the
    Python float, keeps a true division on CUDA: PyTorch turns division by
    a CPU scalar into multiplication by its reciprocal there, which rounds
    differently from the reference's (and the kernel's) division."""
    return torch.tensor(3.0, dtype=dtype, device=device)


def _chars(s):
    """Character codes as int64 (uint8 bytes or uint32/int32 codepoints)."""
    return s.to(torch.int64)


def _greedy_bitmask(a, b, la, lb, window, idx):
    """Greedy first-eligible matching with one uint32-sized word per pair
    (width <= 32), as ``jaro_winkler_bitmask_single``. Returns the (B, L)
    matched masks of a and b."""
    eq = a[:, :, None] == b[:, None, :]
    pow2 = torch.ones((), dtype=torch.int64, device=a.device) << idx
    valid_b = idx[None, :] < lb[:, None]
    E = torch.sum(torch.where(eq & valid_b[:, None, :], pow2, 0), dim=2)

    def upto(k):  # bits [0, k) set; k in [0, 32] (int64: 1 << 32 is exact)
        return torch.bitwise_left_shift(torch.ones_like(k), torch.clamp(k, max=32)) - 1

    w = window[:, None]
    win_mask = upto(idx[None, :] + w + 1) & ~upto(torch.clamp(idx[None, :] - w, min=0))
    masks = torch.where(idx[None, :] < la[:, None], E & win_mask, 0)
    used = torch.zeros(a.shape[0], dtype=torch.int64, device=a.device)
    matched_a = torch.zeros(a.shape, dtype=torch.bool, device=a.device)
    for i in range(a.shape[1]):
        avail = masks[:, i] & ~used
        first = avail & -avail  # lowest set bit
        used = used | first
        matched_a[:, i] = first != 0
    used_b = ((used[:, None] >> idx[None, :]) & 1) == 1
    return matched_a, used_b, eq


def _greedy_vector(a, b, la, lb, window, idx):
    """The same greedy pass with (L,) boolean vectors per step, as
    ``jaro_winkler_single`` (any width)."""
    eq = a[:, :, None] == b[:, None, :]
    valid_b = idx[None, :] < lb[:, None]
    used_b = torch.zeros(a.shape, dtype=torch.bool, device=a.device)
    matched_a = torch.zeros(a.shape, dtype=torch.bool, device=a.device)
    for i in range(a.shape[1]):
        cand = (
            eq[:, i, :]
            & ((idx[None, :] - i).abs() <= window[:, None])
            & valid_b
            & ~used_b
            & (i < la)[:, None]
        )
        first = cand & (torch.cumsum(cand.to(torch.int32), dim=1) == 1)
        used_b = used_b | first
        matched_a[:, i] = first.any(dim=1)
    return matched_a, used_b, eq


def _jaro_winkler_plain(s1, s2, l1, l2, prefix_scale, boost_threshold, dtype):
    dev = s1.device
    L = s1.shape[1]
    idx = torch.arange(L, dtype=torch.int64, device=dev)
    s1, s2 = _chars(s1), _chars(s2)
    l1 = l1.to(torch.int64)
    l2 = l2.to(torch.int64)
    swap = (l1 > l2)[:, None]
    a = torch.where(swap, s2, s1)
    b = torch.where(swap, s1, s2)
    la = torch.minimum(l1, l2)
    lb = torch.maximum(l1, l2)
    window = torch.clamp(lb // 2 - 1, min=0)

    greedy = _greedy_bitmask if L <= 32 else _greedy_vector
    matched_a, used_b, eq = greedy(a, b, la, lb, window, idx)
    m = matched_a.sum(dim=1)
    # k-th matched char of a against k-th matched char of b
    rank1 = torch.cumsum(matched_a.to(torch.int64), dim=1) - 1
    rank2 = torch.cumsum(used_b.to(torch.int64), dim=1) - 1
    aligned = (
        (rank1[:, :, None] == rank2[:, None, :])
        & matched_a[:, :, None]
        & used_b[:, None, :]
    )
    mismatched = torch.sum(aligned & ~eq, dim=(1, 2))

    mf = m.to(dtype)
    t = (mismatched // 2).to(dtype)  # Java integer division
    zero = torch.zeros((), dtype=dtype, device=dev)
    jaro = torch.where(
        m > 0, (mf / l1.to(dtype) + mf / l2.to(dtype) + (mf - t) / mf) / _three(dev, dtype), zero
    )
    run = torch.cumprod(((s1 == s2) & (idx[None, :] < la[:, None])).to(torch.int64), dim=1)
    ell = run.sum(dim=1).to(dtype)  # NOT capped (jar)
    scale = torch.minimum(
        torch.tensor(prefix_scale, dtype=dtype, device=dev),
        1.0 / torch.clamp(lb.to(dtype), min=1.0),
    )
    boosted = jaro + ell * scale * (1.0 - jaro)
    below = jaro < torch.tensor(boost_threshold, dtype=dtype, device=dev)
    return torch.where(below, jaro, boosted)


def jaro_winkler_plain(s1, s2, l1, l2, prefix_scale=0.1, boost_threshold=0.7, mask=None,
                       dtype=torch.float32):
    """Batched Jaro-Winkler, plain PyTorch: s1, s2 (B, L) character codes,
    l1, l2 (B,) lengths -> (B,) float32. Any width and device. With a (B,)
    bool ``mask``, where(mask, jw, 0), as the masked kernel launch.
    ``dtype=torch.float64`` evaluates the same expression in float64 (the
    numerics audit's float64 arm; the kernel computes in float32 only)."""
    sim = _chunked(
        lambda a, b, c, d: _jaro_winkler_plain(a, b, c, d, prefix_scale, boost_threshold,
                                               dtype),
        s1, s2, l1, l2,
    )
    if mask is None:
        return sim
    return torch.where(mask, sim, torch.zeros((), dtype=sim.dtype, device=sim.device))


def _levenshtein_plain(s1, s2, l1, l2):
    L = s1.shape[1]
    dev = s1.device
    s1, s2 = _chars(s1), _chars(s2)
    l1 = l1.to(torch.int64)
    idx = torch.arange(L + 1, dtype=torch.int32, device=dev)
    row = idx.expand(s1.shape[0], L + 1)
    for i in range(L):
        cost = (s2 != s1[:, i : i + 1]).to(torch.int32)
        substitute = row[:, :-1] + cost
        delete = row[:, 1:] + 1
        first = torch.full((s1.shape[0], 1), i + 1, dtype=torch.int32, device=dev)
        t = torch.cat([first, torch.minimum(substitute, delete)], dim=1)
        new_row = idx + torch.cummin(t - idx, dim=1).values
        row = torch.where((i < l1)[:, None], new_row, row)
    return row.gather(1, l2.to(torch.int64)[:, None])[:, 0]


def levenshtein_plain(s1, s2, l1, l2):
    """Batched Levenshtein distance, plain PyTorch: (B,) int32."""
    return _chunked(_levenshtein_plain, s1, s2, l1, l2)


def ratio_from_distance(d, l1, l2, dtype=torch.float32):
    """levenshtein / mean length (the reference's similarity metric), 0 where
    both strings are empty; float32 (or ``dtype``), in the reference's
    order."""
    denom = (l1.to(dtype) + l2.to(dtype)) / 2.0
    return torch.where(
        denom > 0, d.to(dtype) / denom, torch.zeros((), dtype=dtype, device=d.device)
    )


def levenshtein_ratio_plain(s1, s2, l1, l2):
    return ratio_from_distance(levenshtein_plain(s1, s2, l1, l2), l1, l2)


def jaro_winkler(s1, s2, l1, l2, prefix_scale=0.1, boost_threshold=0.7, mask=None):
    """Batched Jaro-Winkler, where(mask, jw, 0) when a (B,) bool ``mask`` is
    given: the CUDA kernel for tensors on a CUDA device, the plain version
    for tensors on the CPU."""
    if s1.is_cuda:
        from .strings_cuda import jaro_winkler_cuda

        return jaro_winkler_cuda(s1, s2, l1, l2, prefix_scale, boost_threshold, mask)
    return jaro_winkler_plain(s1, s2, l1, l2, prefix_scale, boost_threshold, mask)


def levenshtein(s1, s2, l1, l2):
    """Batched Levenshtein distance, (B,) int32: the CUDA kernel for tensors
    on a CUDA device, the plain version for tensors on the CPU."""
    if s1.is_cuda:
        from .strings_cuda import levenshtein_cuda

        return levenshtein_cuda(s1, s2, l1, l2)
    return levenshtein_plain(s1, s2, l1, l2)


def levenshtein_ratio(s1, s2, l1, l2):
    """levenshtein / mean length, batched, with kernel dispatch."""
    return ratio_from_distance(levenshtein(s1, s2, l1, l2), l1, l2)
