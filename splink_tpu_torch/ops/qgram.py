"""Q-gram and character-set similarities (Jaccard, cosine) as batched tensor ops.

The torch counterpart of splink_tpu/ops/qgram.py, whose device functions
are ``jnp`` programs vmapped over pairs; here each is written out over a
batch axis as plain PyTorch ops on (B, L) character tensors. Two Jaccard
functions with different contracts, as in the reference:

  * charset_jaccard — the reference jar's JaccardSimilarity, bit-exact:
    Jaccard over the sets of distinct CHARACTERS, rounded half-up to two
    decimals (``jaccard_sim(...)`` in a CASE expression);
  * qgram_jaccard — exact |A ∩ B| / |A ∪ B| over the sets of distinct
    q-grams (the native 'qgram_jaccard' comparison kind).

Cosine distance is 1 - cos of the q-gram count vectors; a string shorter
than q has no grams, and a side without grams gives distance 1.

Each q-gram window is packed into exact integer codes (8 bits a character
for uint8 columns, 21 for codepoint columns, as many int64 words as q
needs), so word-wise equality IS gram equality, and set and multiset
intersections are masked (B, windows, windows) equality reductions. The
``_masked`` forms take each row's distinct-gram mask, distinct count and
squared norm from the packed table (computed once per distinct value on the
host by ``qgram_row_aux`` / ``charset_row_aux``, copied from splink_tpu) and
build only the cross matrix. Every count is an exact integer; the float
expressions keep the reference's order, and every division divides by a
tensor (PyTorch turns division by a Python float into a reciprocal
multiply on CUDA).
"""

from __future__ import annotations

import numpy as np
import torch

_SPACE = ord(" ")


def _f32(value, device):
    return torch.tensor(value, dtype=torch.float32, device=device)


def _gram_codes(s, length, q: int):
    """Exact codes of every q-gram window of a (B, L) character tensor.

    Returns (words, valid): a list of (B, n_windows) int64 tensors, each
    window's characters packed at 8 bits a character (uint8) or 21 bits
    (codepoints, < 2^21), at most 63 bits a word, and the (B, n_windows)
    mask of windows that lie within each row's length. Window t covers
    characters t .. t + q - 1, clamped to the last column as in the
    reference (such windows are never valid)."""
    bpc = 8 if s.dtype == torch.uint8 else 21
    per_word = 63 // bpc
    L = s.shape[1]
    n_windows = max(L - q + 1, 1)
    t = torch.arange(n_windows, device=s.device)
    chars = s.to(torch.int64)
    words = []
    for w0 in range(0, q, per_word):
        word = torch.zeros((s.shape[0], n_windows), dtype=torch.int64, device=s.device)
        for k in range(w0, min(q, w0 + per_word)):
            col = chars[:, torch.clamp(t + k, max=L - 1)]
            word = word | (col << ((k - w0) * bpc))
        words.append(word)
    valid = t[None, :] < torch.clamp(length.to(torch.int64) - q + 1, min=0)[:, None]
    return words, valid


def _eq(wa, wb, va, vb):
    """(B, na, nb) gram equality of two code lists, masked by validity."""
    eq = va[:, :, None] & vb[:, None, :]
    for a, b in zip(wa, wb):
        eq = eq & (a[:, :, None] == b[:, None, :])
    return eq


def _firsts(eq_self, valid):
    """Windows that are valid and the first occurrence of their gram."""
    n = valid.shape[1]
    idx = torch.arange(n, device=valid.device)
    earlier = idx[None, :] < idx[:, None]  # [t, t'] iff t' comes before t
    return valid & ~(eq_self & earlier).any(dim=2)


def _ratio(inter, union):
    """inter / union in float32, 0 where the union is empty."""
    f32 = torch.float32
    safe = torch.clamp(union, min=1).to(f32)
    return torch.where(union > 0, inter.to(f32) / safe, _f32(0.0, inter.device))


def qgram_jaccard(s1, s2, l1, l2, q: int = 2):
    """Exact set Jaccard of each pair's distinct q-grams, (B,) float32."""
    w1, v1 = _gram_codes(s1, l1, q)
    w2, v2 = _gram_codes(s2, l2, q)
    first1 = _firsts(_eq(w1, w1, v1, v1), v1)
    first2 = _firsts(_eq(w2, w2, v2, v2), v2)
    inter = (first1 & _eq(w1, w2, v1, v2).any(dim=2)).sum(dim=1, dtype=torch.int32)
    n1 = first1.sum(dim=1, dtype=torch.int32)
    n2 = first2.sum(dim=1, dtype=torch.int32)
    return _ratio(inter, n1 + n2 - inter)


def _cosine(x12, x11, x22):
    """1 - x12 / sqrt(x11 * x22) in the reference's order; 1 where a side
    has no grams."""
    dev = x12.device
    sim = torch.where(
        (x11 > 0) & (x22 > 0), x12 / torch.sqrt(x11 * x22), _f32(0.0, dev)
    )
    return _f32(1.0, dev) - sim


def qgram_cosine_distance(s1, s2, l1, l2, q: int = 2):
    """Exact cosine distance between each pair's q-gram count vectors,
    (B,) float32. Counts are integers, so the f32 sums are exact."""
    f32 = torch.float32
    w1, v1 = _gram_codes(s1, l1, q)
    w2, v2 = _gram_codes(s2, l2, q)
    x12 = _eq(w1, w2, v1, v2).sum(dim=(1, 2)).to(f32)  # = Σ_g cnt1(g)·cnt2(g)
    x11 = _eq(w1, w1, v1, v1).sum(dim=(1, 2)).to(f32)  # = Σ_g cnt1(g)^2
    x22 = _eq(w2, w2, v2, v2).sum(dim=(1, 2)).to(f32)
    return _cosine(x12, x11, x22)


def _mask_bits(m, n: int):
    """(B, n) bool: bit t of the packed (B, lanes) int32 mask, False past
    the lanes' 32 * lanes bits."""
    idx = torch.arange(n, device=m.device)
    lane = torch.clamp(idx // 32, max=m.shape[1] - 1)
    bits = ((m[:, lane] >> (idx % 32)) & 1) == 1
    return bits & (idx < m.shape[1] * 32)


def qgram_jaccard_masked(s1, s2, l1, l2, m1, n1, n2, q: int = 2):
    """qgram_jaccard with the left side's distinct-gram mask ``m1`` (B,
    lanes) and both distinct counts taken from the packed table: only the
    cross-equality matrix is built per pair. Bit-identical results."""
    w1, v1 = _gram_codes(s1, l1, q)
    w2, v2 = _gram_codes(s2, l2, q)
    first1 = _mask_bits(m1, v1.shape[1])
    inter = (first1 & _eq(w1, w2, v1, v2).any(dim=2)).sum(dim=1, dtype=torch.int32)
    return _ratio(inter, n1 + n2 - inter)


def qgram_cosine_masked(s1, s2, l1, l2, x11, x22, q: int = 2):
    """qgram_cosine_distance with each side's squared norm (float32) taken
    from the packed table."""
    w1, v1 = _gram_codes(s1, l1, q)
    w2, v2 = _gram_codes(s2, l2, q)
    x12 = _eq(w1, w2, v1, v2).sum(dim=(1, 2)).to(torch.float32)
    return _cosine(x12, x11, x22)


def _charset_value(inter_ns, da, db, space_a, space_b, l1, l2, q):
    """The jar's rounding of the charset Jaccard, in integer form:
    floor((200·i + u) / (2·u)) / 100, exact in f32 for any union < ~65k;
    0 when either side is empty. With ``q`` the tokenised strings also
    hold a space when longer than q."""
    f32 = torch.float32
    dev = inter_ns.device
    if q is not None:
        space_a = space_a | (l1 > q)
        space_b = space_b | (l2 > q)
    inter = inter_ns + (space_a & space_b).to(torch.int32)
    union = torch.clamp(
        da + db + space_a.to(torch.int32) + space_b.to(torch.int32) - inter, min=1
    )
    num = (200 * inter + union).to(f32)
    rounded = torch.floor(num / (2 * union).to(f32)) / _f32(100.0, dev)
    return torch.where((l1 == 0) | (l2 == 0), _f32(0.0, dev), rounded)


def charset_jaccard(s1, s2, l1, l2, q: int | None = None):
    """The reference jar's JaccardSimilarity, bit-exact (see
    splink_tpu/ops/qgram.py:charset_jaccard_single): distinct-character
    Jaccard rounded half-up to two decimals, (B,) float32. s1 and s2 have
    one width."""
    L = s1.shape[1]
    idx = torch.arange(L, device=s1.device)
    va = idx[None, :] < l1[:, None]
    vb = idx[None, :] < l2[:, None]
    earlier = idx[None, :] < idx[:, None]

    def firsts(s, v):
        seen = ((s[:, None, :] == s[:, :, None]) & v[:, None, :] & earlier).any(dim=2)
        return v & ~seen

    fa, fb = firsts(s1, va), firsts(s2, vb)
    nsa, nsb = s1 != _SPACE, s2 != _SPACE
    present_in_b = ((s1[:, :, None] == s2[:, None, :]) & vb[:, None, :]).any(dim=2)
    i32 = torch.int32
    inter_ns = (fa & nsa & present_in_b).sum(dim=1, dtype=i32)
    da = (fa & nsa).sum(dim=1, dtype=i32)
    db = (fb & nsb).sum(dim=1, dtype=i32)
    space_a = ((s1 == _SPACE) & va).any(dim=1)
    space_b = ((s2 == _SPACE) & vb).any(dim=1)
    return _charset_value(inter_ns, da, db, space_a, space_b, l1, l2, q)


def charset_jaccard_masked(s1, s2, l1, l2, m1, da1, sp1, da2, sp2, q: int | None = None):
    """charset_jaccard with each side's first-occurrence-and-non-space mask
    (left only), distinct non-space count and has-space flag taken from the
    packed table: only the cross character matrix is built per pair.
    Bit-identical results; s1 may be wider than the mask was built at."""
    fns = _mask_bits(m1, s1.shape[1])
    vb = torch.arange(s2.shape[1], device=s2.device)[None, :] < l2[:, None]
    present_in_b = ((s1[:, :, None] == s2[:, None, :]) & vb[:, None, :]).any(dim=2)
    inter_ns = (fns & present_in_b).sum(dim=1, dtype=torch.int32)
    return _charset_value(inter_ns, da1, da2, sp1 > 0, sp2 > 0, l1, l2, q)


# ---------------------------------------------------------------------------
# Host-side per-row auxiliaries, copied from splink_tpu/ops/qgram.py (numpy)
# ---------------------------------------------------------------------------


def _per_unique_aux(bytes_, lengths, token_ids, n_bits, kernel, scalar_dtypes):
    """Shared scaffolding for per-row aux computed ONCE PER UNIQUE token:
    dedup rows by token id, run ``kernel(B, L) -> (bits, *scalars)`` over
    chunks of unique representatives (bits: (v, n_bits) bool), pack bits
    into uint32 lanes, and scatter results back to all rows. Null rows
    (token -1) get all-zero aux."""
    n = bytes_.shape[0]
    n_lanes = (n_bits + 31) // 32
    mask = np.zeros((n, n_lanes), np.uint32)
    scalars = [np.zeros(n, dt) for dt in scalar_dtypes]
    valid_rows = token_ids >= 0
    if not valid_rows.any():
        return (mask, *scalars)
    toks = token_ids[valid_rows]
    uniq, first_idx = np.unique(toks, return_index=True)
    reps = np.flatnonzero(valid_rows)[first_idx]  # one row per unique value
    V = len(reps)
    umask = np.zeros((V, n_lanes), np.uint32)
    uscal = [np.zeros(V, dt) for dt in scalar_dtypes]
    chunk = max(1, 32_000_000 // max(n_bits * n_bits, 1))
    for s in range(0, V, chunk):
        r = reps[s : s + chunk]
        bits, *vals = kernel(bytes_[r], lengths[r])
        for j in range(n_lanes):
            bs = bits[:, j * 32 : (j + 1) * 32]
            shifts = np.arange(bs.shape[1], dtype=np.uint32)
            umask[s : s + chunk, j] = (
                bs.astype(np.uint32) << shifts[None, :]
            ).sum(axis=1, dtype=np.uint32)
        for k, v in enumerate(vals):
            uscal[k][s : s + chunk] = v
    pos = np.searchsorted(uniq, toks)
    mask[valid_rows] = umask[pos]
    for k in range(len(scalars)):
        scalars[k][valid_rows] = uscal[k][pos]
    return (mask, *scalars)


def qgram_row_aux(bytes_, lengths, token_ids, q: int):
    """Host-side per-row q-gram auxiliaries for the masked functions.

    Returns ``(first_mask, count, sumsq)``:

      * first_mask — (n, ceil(n_windows/32)) uint32; bit t set iff window t
        is valid and is the first occurrence of its gram in the string
      * count     — (n,) int32 number of distinct grams (popcount of mask)
      * sumsq     — (n,) float32 squared L2 norm of the gram count vector

    Computed once per unique token id (_per_unique_aux).
    """
    w = bytes_.shape[1]
    nw = max(w - q + 1, 1)
    t_idx = np.arange(nw)
    earlier = t_idx[None, :] < t_idx[:, None]  # [t, t'] iff t' before t

    def kernel(B, L):
        v = t_idx[None, :] < np.maximum(L.astype(np.int64) - q + 1, 0)[:, None]
        eq = np.ones((len(B), nw, nw), bool)
        for k in range(q):
            col = B[:, np.minimum(t_idx + k, w - 1)]
            eq &= col[:, :, None] == col[:, None, :]
        eq &= v[:, :, None] & v[:, None, :]
        first = v & ~(eq & earlier[None]).any(axis=2)
        return first, first.sum(axis=1), eq.sum(axis=(1, 2))

    return _per_unique_aux(
        bytes_, lengths, token_ids, nw, kernel, (np.int32, np.float32)
    )


def charset_row_aux(bytes_, lengths, token_ids):
    """Host-side per-row auxiliaries for charset_jaccard_masked: the
    first-occurrence-AND-non-space character bitmask, the non-space
    distinct-char count, and a has-space flag, computed once per unique
    token value (_per_unique_aux). The tokeniser q adjustment stays per
    pair: it needs only lengths, so ONE aux per column serves every q."""
    w = bytes_.shape[1]
    t_idx = np.arange(w)
    earlier = t_idx[None, :] < t_idx[:, None]
    sp_code = ord(" ")

    def kernel(B, L):
        v = t_idx[None, :] < L.astype(np.int64)[:, None]
        eq = (B[:, :, None] == B[:, None, :]) & v[:, :, None] & v[:, None, :]
        first = v & ~(eq & earlier[None]).any(axis=2)
        fns = first & (B != sp_code)
        return fns, fns.sum(axis=1), ((B == sp_code) & v).any(axis=1)

    return _per_unique_aux(
        bytes_, lengths, token_ids, w, kernel, (np.int32, np.int32)
    )


def qgram_tokenise(value: str, q: int) -> list[str]:
    """Host-side q-gram tokeniser (the displayable analogue of the jar's
    QgramTokeniser UDFs)."""
    if value is None:
        return []
    return [value[i : i + q] for i in range(max(len(value) - q + 1, 0))]
