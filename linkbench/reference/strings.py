"""Plain string similarities for the reference: Jaro-Winkler and
Levenshtein over batches of pairs, in plain PyTorch, on any device.

Jaro-Winkler follows the jar (commons-text) definition that the reference
package states: the shorter string is walked over the longer; each of its
characters takes the first unused equal character of the longer string
inside a window of max(longer // 2 - 1, 0) positions; t is half the number
of matched characters that differ when both strings' matches are read in
order (integer halving); jaro = (m / l1 + m / l2 + (m - t) / m) / 3 and 0
without matches; the common prefix is not capped and is scaled by
min(0.1, 1 / longer); the boost applies only at jaro >= 0.7. The float
expression is evaluated in ``dtype`` in that order, with true divisions.

Levenshtein is the dynamic programme row by row; within a row the left
moves are a running minimum of (cell - column) (``torch.cummin``).
"""

from __future__ import annotations

import torch


def _f(value, dtype, device):
    return torch.tensor(value, dtype=dtype, device=device)


def jaro_winkler(s1, s2, l1, l2, dtype=torch.float32):
    """(B,) similarities of the (B, W) character rows ``s1``, ``s2`` with
    lengths ``l1``, ``l2`` (characters past a length are ignored)."""
    dev = s1.device
    n, width = s1.shape
    l1 = l1.to(torch.int64)
    l2 = l2.to(torch.int64)
    swap = (l1 > l2)[:, None]
    a = torch.where(swap, s2, s1)  # the shorter (s1 on a tie)
    b = torch.where(swap, s1, s2)
    la = torch.minimum(l1, l2)
    lb = torch.maximum(l1, l2)
    window = torch.clamp(lb // 2 - 1, min=0)
    pos = torch.arange(width, device=dev)
    in_b = pos[None, :] < lb[:, None]
    used = torch.zeros((n, width), dtype=torch.bool, device=dev)
    hit_a = torch.zeros((n, width), dtype=torch.bool, device=dev)
    steps = int(la.max()) if n else 0
    for i in range(steps):
        ok = ((b == a[:, i:i + 1]) & in_b & ~used
              & ((pos[None, :] - i).abs() <= window[:, None]) & (i < la)[:, None])
        found = ok.any(dim=1)
        first = torch.argmax(ok.to(torch.int8), dim=1)  # the lowest true position
        used[torch.arange(n, device=dev), first] |= found
        hit_a[:, i] = found
    m = hit_a.sum(dim=1)
    # the k-th matched character of a against the k-th of b
    big = width + 1
    order_a = torch.argsort(torch.where(hit_a, pos[None, :], big + pos[None, :]), dim=1)
    order_b = torch.argsort(torch.where(used, pos[None, :], big + pos[None, :]), dim=1)
    ca = torch.gather(a, 1, order_a)
    cb = torch.gather(b, 1, order_b)
    differ = (ca != cb) & (pos[None, :] < m[:, None])
    t = differ.sum(dim=1) // 2
    mf = m.to(dtype)
    three = _f(3.0, dtype, dev)
    zero = _f(0.0, dtype, dev)
    safe_m = torch.where(m > 0, mf, _f(1.0, dtype, dev))
    jaro = torch.where(
        m > 0,
        (mf / l1.to(dtype) + mf / l2.to(dtype) + (mf - t.to(dtype)) / safe_m) / three,
        zero,
    )
    same = (s1 == s2) & (pos[None, :] < la[:, None])
    prefix = torch.cumprod(same.to(torch.int64), dim=1).sum(dim=1).to(dtype)
    scale = torch.minimum(_f(0.1, dtype, dev),
                          _f(1.0, dtype, dev) / torch.clamp(lb.to(dtype), min=1.0))
    boosted = jaro + prefix * scale * (_f(1.0, dtype, dev) - jaro)
    return torch.where(jaro < _f(0.7, dtype, dev), jaro, boosted)


def levenshtein(s1, s2, l1, l2):
    """(B,) int32 edit distances of the (B, W) character rows."""
    dev = s1.device
    n, width = s1.shape
    col = torch.arange(width + 1, dtype=torch.int32, device=dev)
    row = col.expand(n, width + 1).contiguous()  # distances from the empty prefix
    l1 = l1.to(torch.int64)
    steps = int(l1.max()) if n else 0
    for i in range(steps):
        cost = (s2 != s1[:, i:i + 1]).to(torch.int32)
        step = torch.minimum(row[:, :-1] + cost, row[:, 1:] + 1)
        head = torch.full((n, 1), i + 1, dtype=torch.int32, device=dev)
        cand = torch.cat([head, step], dim=1)
        new = torch.cummin(cand - col, dim=1).values + col
        row = torch.where((i < l1)[:, None], new, row)
    return row.gather(1, l2.to(torch.int64)[:, None])[:, 0]


def bigram_profiles(chars, lengths, alphabet):
    """(V, K * K) int16 counts of each row's bigrams over ``alphabet`` (a
    (256,) or larger lookup from character code to 0..K-1)."""
    k = int(alphabet.max()) + 1
    ids = alphabet[chars.to(torch.int64)]
    pos = torch.arange(chars.shape[1] - 1, device=chars.device)
    valid = pos[None, :] + 1 < lengths[:, None]
    grams = ids[:, :-1] * k + ids[:, 1:]
    out = torch.zeros((chars.shape[0], k * k), dtype=torch.int16, device=chars.device)
    out.scatter_add_(1, torch.where(valid, grams, 0), valid.to(torch.int16))
    return out


def distance_lower_bound(p1, p2, l1, l2):
    """A lower bound of the edit distance from the strings' bigram profiles
    and lengths: each edit leaves intact all but at most two of a string's
    l - 1 bigrams, so k edits leave at least max(l1, l2) - 1 - 2k bigrams
    common to both (as multisets); and k >= |l1 - l2|."""
    common = torch.minimum(p1, p2).sum(dim=1, dtype=torch.int64)
    longer = torch.maximum(l1, l2).to(torch.int64)
    by_grams = torch.div(torch.clamp(longer - 1 - common, min=0) + 1, 2, rounding_mode="floor")
    return torch.maximum(by_grams, (l1.to(torch.int64) - l2.to(torch.int64)).abs())
