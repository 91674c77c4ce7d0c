"""Minhash signatures over q-gram sets, as functions on tensors.

The port of splink_tpu/approx/minhash.py. Each record's q-gram SET (over
the approximate columns, union across columns with a per-column salt so
``"ab"`` in *name* and ``"ab"`` in *city* are distinct members) is sketched
into ``bands * rows_per_band`` minhash values, and each band's rows fold
into one 32-bit band key. Two records share band ``b``'s key with
probability ``J^rows_per_band``, ``J`` their q-gram Jaccard, so across
the bands the candidate probability is the S-curve ``1 - (1 - J^r)^b``.

The reference's device programs here (``make_minhash_fn``,
``make_gram_df_fn``) are ``jnp`` programs that XLA compiles; they port as
plain PyTorch functions on tensors on an explicit device, bit for bit:

  * grams are the injective packed codes of the port's
    :func:`..ops.qgram._gram_codes`, re-sliced into the reference's 32-bit
    code words (:func:`_words32`), so the gram identity hash sees the
    reference's words;
  * every hash is wraparound uint32 arithmetic computed in int64 and
    masked to 32 bits after each step; products go through
    :func:`_mul32`, which splits the multiplier into 16-bit halves so that
    no product passes 2^63 (torch implements neither ``>>`` nor ``min``
    for ``torch.uint32`` on the CPU);
  * the no-signature sentinel ``0xFFFFFFFF`` stays the largest value in
    every min.

Hash parameters derive from a fixed seed (:data:`APPROX_SEED`), so the same
corpus gives the same band keys in every process and in both packages.
Unweighted keys, the document-frequency table and the IDF weights are
bit-identical to the reference's. The weighted sampler races
``-log(u) / w`` across grams. XLA's float32 ``log`` is not correctly
rounded, and neither are PyTorch's on the CPU or CUDA's, each in its own
way; the port takes the log in float64 and rounds once, so the card and
the CPU give the same keys, and a lane can differ from the reference's
only where two grams' race values lie within an ulp.
"""

from __future__ import annotations

import numpy as np
import torch

from .._device import resolve_device
from ..ops.qgram import _gram_codes

# Fixed seed for the universal-hash parameters: band keys must be
# deterministic across processes (index build vs query side, run vs rerun).
APPROX_SEED = 0x0A99B10C

# Records per signature chunk: bounds the transient (chunk, n_windows,
# n_hashes) int64 intermediates to a few hundred MB.
SIG_CHUNK = 1 << 13

# Hashed gram document-frequency sketch: grams histogram into
# 2^DF_TABLE_BITS buckets by the top bits of their salted fold hash.
DF_TABLE_BITS = 16
DF_TABLE_SIZE = 1 << DF_TABLE_BITS

# IDF floor: even the most common gram keeps a positive sampling weight.
IDF_MIN = np.float32(0.05)

_U32 = np.uint32
_NO_SIG = np.uint32(0xFFFFFFFF)
_M32 = 0xFFFFFFFF
_NO_SIG_I = 0xFFFFFFFF


def _mul32(x, c):
    """``x * c mod 2^32`` for int64 tensors ``x`` in [0, 2^32) and ``c``
    (an int or an int64 tensor) in [0, 2^32): the multiplier splits into
    16-bit halves, so each partial product stays below 2^48."""
    lo = c & 0xFFFF
    hi = c >> 16
    return (x * lo + (((x * hi) & 0xFFFF) << 16)) & _M32


def _words32(words, bpc: int, q: int):
    """The reference's uint32 code words of each gram, from the port's
    packed int64 words: the 32-bit slices of the gram's concatenated
    ``bpc``-bit characters (``words[i]`` holds characters
    ``i * (63 // bpc)`` on at ``bpc`` bits each). Each is an int64 tensor
    in [0, 2^32)."""
    bits_per_word = (63 // bpc) * bpc
    out = []
    for w in range(-(-(q * bpc) // 32)):
        acc = None
        for i, word in enumerate(words):
            shift = i * bits_per_word - 32 * w  # word i's bit 0 in slice w
            if shift >= 32 or shift <= -bits_per_word:
                continue
            if shift >= 0:
                part = (word & ((1 << (32 - shift)) - 1)) << shift
            else:
                part = (word >> -shift) & _M32
            acc = part if acc is None else acc | part
        out.append(acc)
    return out


def _fold_gram_hash(words32, salt):
    """Salted uint32 fold of a gram's 32-bit code words: the one gram
    identity hash shared by the minhash sampler, the DF table and the
    weighted verifier (their IDF lookups address the same buckets)."""
    h = None
    for w in words32:
        h = _mul32((salt if h is None else h) ^ w, 0x9E3779B1)
        h = h ^ (h >> 15)
    return h


def _gram_hashes(s, length, q: int, salt: int):
    """(h, valid): each gram window's salted fold hash, (B, n_windows)
    int64 in [0, 2^32), and the mask of windows inside each row's length."""
    words, valid = _gram_codes(s, length, q)
    bpc = 8 if s.dtype == torch.uint8 else 21
    return _fold_gram_hash(_words32(words, bpc, q), salt), valid


def hash_params(n_hashes: int) -> tuple[np.ndarray, np.ndarray]:
    """Deterministic per-hash multiply/add parameters: ``a`` odd (a bijection
    over Z_2^32), ``b`` arbitrary. Seeded by :data:`APPROX_SEED` only."""
    rng = np.random.default_rng(APPROX_SEED)
    a = rng.integers(0, 1 << 32, size=n_hashes, dtype=np.uint64).astype(_U32) | _U32(1)
    b = rng.integers(0, 1 << 32, size=n_hashes, dtype=np.uint64).astype(_U32)
    return a, b


def column_salts(n_cols: int) -> np.ndarray:
    """Deterministic per-column salts: the same gram in different columns
    must be a different set member (column identity is part of the key)."""
    rng = np.random.default_rng(APPROX_SEED ^ 0x5A17)
    return rng.integers(1, 1 << 32, size=n_cols, dtype=np.uint64).astype(_U32)


def _upload_chars(bytes_: np.ndarray, device):
    """A column's (n, width) characters on ``device``: uint8 stays uint8;
    codepoints (< 2^21) go as int32."""
    if bytes_.dtype != np.uint8:
        bytes_ = bytes_.astype(np.int32)
    return torch.from_numpy(np.ascontiguousarray(bytes_)).to(device)


def _upload(a: np.ndarray, device, dtype=None):
    return torch.from_numpy(np.ascontiguousarray(a)).to(device=device, dtype=dtype)


def _neg_log_f32(hk):
    """``-log(u)`` in float32 for the race's uniform ``u = (float32(hk) +
    0.5) * 2^-32``, ``u`` formed as the reference forms it. The log is
    taken in float64 and rounded once to float32 (the correctly rounded
    value), so the card and the CPU race on the same bits; the
    reference's float32 log can sit an ulp away from it."""
    u = (hk.to(torch.float32) + 0.5) * 2.0 ** -32
    return (-torch.log(u.to(torch.float64))).to(torch.float32)


def minhash_signatures(cols, lens, q: int, a, b, salts, idf=None):
    """The signature program for one chunk of records.

    ``cols`` / ``lens`` are per column the (B, width) characters and (B,)
    lengths on one device; ``a`` / ``b`` the (n_hashes,) int64 hash
    parameters, ``salts`` a list of ints, ``idf`` the (DF_TABLE_SIZE,)
    float32 weights or None. Returns ``(sig (B, n_hashes) int64 in
    [0, 2^32), has (B,) bool)``.

    Per record, every valid gram of every column folds to its salted hash
    ``h``; each hash function ``k`` maps it through ``h * a_k + b_k`` and a
    murmur-style finalisation, and the lane takes the min over ALL
    columns' grams. ``has`` is False when no column has a valid window
    (null or shorter-than-q values): such a record never joins. With
    ``idf`` each gram draws the race value ``-log(u) / w``, ``u`` from its
    per-hash value and ``w`` its IDF weight (gathered at the top
    :data:`DF_TABLE_BITS` bits of ``h``), and the lane carries the
    winning gram's ``h`` (ties to the smaller ``h``, then to the earlier
    column), so two records agree on a lane with probability equal to
    their IDF-weighted Jaccard."""
    dev = a.device
    n = cols[0].shape[0]
    n_hashes = a.shape[0]
    no_sig = torch.tensor(_NO_SIG_I, dtype=torch.int64, device=dev)
    sig = torch.full((n, n_hashes), _NO_SIG_I, dtype=torch.int64, device=dev)
    if idf is not None:
        inf = torch.tensor(float("inf"), dtype=torch.float32, device=dev)
        best_e = torch.full((n, n_hashes), float("inf"), dtype=torch.float32, device=dev)
    has = torch.zeros(n, dtype=torch.bool, device=dev)
    for c in range(len(cols)):
        h, valid = _gram_hashes(cols[c], lens[c], q, int(salts[c]))
        hk = (_mul32(h[:, :, None], a) + b) & _M32
        hk = hk ^ (hk >> 13)
        hk = _mul32(hk, 0x85EBCA6B)
        hk = hk ^ (hk >> 16)
        v3 = valid[:, :, None]
        if idf is None:
            sig = torch.minimum(sig, torch.where(v3, hk, no_sig).amin(dim=1))
        else:
            w = idf[h >> (32 - DF_TABLE_BITS)]
            e = torch.where(v3, _neg_log_f32(hk) / w[:, :, None], inf)
            col_min = e.amin(dim=1)
            col_id = torch.where((e == col_min[:, None, :]) & v3, h[:, :, None],
                                 no_sig).amin(dim=1)
            take = (col_min < best_e) | ((col_min == best_e) & (col_id < sig))
            best_e = torch.where(take, col_min, best_e)
            sig = torch.where(take, col_id, sig)
        has = has | valid.any(dim=1)
    return sig, has


def band_keys(sig, bands: int, rows_per_band: int):
    """(B, bands) int64 band keys in [0, 2^32): each band's signature lanes
    FNV-fold with the band index as a salt."""
    bk = sig.reshape(sig.shape[0], bands, rows_per_band)
    key = torch.full((sig.shape[0], bands), 0x811C9DC5, dtype=torch.int64, device=sig.device)
    for r in range(rows_per_band):
        key = _mul32(key ^ bk[:, :, r], 0x01000193)
    key = key ^ (key >> 16)
    salt = (np.arange(bands, dtype=np.uint64) * np.uint64(0x9E3779B1)) & np.uint64(_M32)
    return key ^ _upload(salt.astype(np.int64), sig.device)


def gram_df_table(columns: list[tuple[np.ndarray, np.ndarray]], q: int,
                  chunk: int = SIG_CHUNK, device=None) -> tuple[np.ndarray, int]:
    """(DF_TABLE_SIZE,) int64 hashed gram occurrence counts over the corpus
    plus the record count: every valid gram of every column adds one at
    the top :data:`DF_TABLE_BITS` bits of its fold hash (the address the
    weighted sampler and the weighted verifier read their IDF from).
    Counted on ``device`` (``cuda`` unless named) with one ``bincount`` a
    column and chunk."""
    if not columns:
        raise ValueError("gram DF table needs at least one column")
    device = resolve_device(device)
    n = len(columns[0][1])
    salts = column_salts(len(columns))
    acc = torch.zeros(DF_TABLE_SIZE + 1, dtype=torch.int64, device=device)
    for s in range(0, n, chunk):
        e = min(s + chunk, n)
        for c, (bytes_, lengths) in enumerate(columns):
            h, valid = _gram_hashes(_upload_chars(bytes_[s:e], device),
                                    _upload(lengths[s:e], device), q, int(salts[c]))
            slots = torch.where(valid, h >> (32 - DF_TABLE_BITS), DF_TABLE_SIZE)
            acc += torch.bincount(slots.reshape(-1), minlength=DF_TABLE_SIZE + 1)
    return acc[:DF_TABLE_SIZE].cpu().numpy(), n


def idf_weights(df_counts: np.ndarray, n_records: int) -> np.ndarray:
    """(DF_TABLE_SIZE,) float32 IDF weights from the hashed DF sketch:
    ``max(log((n + 1) / (df + 1)), IDF_MIN)``, computed once on the host
    so index build and serve-side query signatures gather identical
    weights."""
    df = np.asarray(df_counts, np.float64)
    w = np.log((float(n_records) + 1.0) / (df + 1.0))
    return np.maximum(w, float(IDF_MIN)).astype(np.float32)


def band_key_arrays(
    columns: list[tuple[np.ndarray, np.ndarray]],
    q: int,
    bands: int,
    rows_per_band: int,
    chunk: int = SIG_CHUNK,
    idf: np.ndarray | None = None,
    device=None,
) -> tuple[np.ndarray, np.ndarray]:
    """LSH band keys for every record, computed on ``device`` (``cuda``
    unless named) in chunks of ``chunk`` records.

    ``columns`` is a list of ``(bytes_, lengths)`` pairs, the encoded
    fixed-width form of each approximate column (null rows carry length
    0). ``idf`` (the :func:`idf_weights` table) selects the weighted
    sampler; index build and query side pass the same table.

    Returns ``(keys (n, bands) uint32, has_sig (n,) bool)``."""
    if not columns:
        raise ValueError("minhash needs at least one column")
    device = resolve_device(device)
    n = len(columns[0][1])
    a, b = hash_params(bands * rows_per_band)
    a_t = _upload(a.astype(np.int64), device)
    b_t = _upload(b.astype(np.int64), device)
    salts = column_salts(len(columns))
    idf_t = None if idf is None else _upload(np.asarray(idf, np.float32), device)
    keys = np.empty((n, bands), _U32)
    has = np.empty(n, bool)
    for s in range(0, n, chunk):
        e = min(s + chunk, n)
        cols = [_upload_chars(bytes_[s:e], device) for bytes_, _ in columns]
        lens = [_upload(lengths[s:e], device) for _, lengths in columns]
        sig, h = minhash_signatures(cols, lens, q, a_t, b_t, salts, idf_t)
        keys[s:e] = band_keys(sig, bands, rows_per_band).cpu().numpy().astype(_U32)
        has[s:e] = h.cpu().numpy()
    return keys, has


def factorise_band_codes(
    keys: np.ndarray, has_sig: np.ndarray
) -> tuple[np.ndarray, list[np.ndarray]]:
    """Factorise per-band uint32 keys into dense int32 codes for the
    segmented-sort join: ``(codes (bands, n) int32, uniq_keys per band)``.
    Code ``-1`` marks records without a signature (never join). The unique
    key arrays are ascending, so code order == ascending band-key order —
    the property the serve bucket dictionaries rely on."""
    n, bands = keys.shape
    codes = np.full((bands, n), -1, np.int32)
    uniqs: list[np.ndarray] = []
    valid = np.flatnonzero(has_sig)
    for b in range(bands):
        if len(valid):
            uniq, inv = np.unique(keys[valid, b], return_inverse=True)
            codes[b, valid] = inv.astype(np.int32)
        else:
            uniq = np.zeros(0, _U32)
        uniqs.append(uniq)
    return codes, uniqs
