"""splink_tpu_torch's string kernels past one 32-bit word, on CPU.

The CUDA kernels cannot run here, so this file holds what surrounds them
to the JAX reference: a pure-Python emulation of the Levenshtein kernel's
step (the uint8 SWAR match mask and the multi-word Myers/Hyyro advance on
32-bit words, horizontal delta carried from word to word, the shorter
string as the text) equals ``levenshtein_vmapped`` exactly at widths 40 to
264; an emulation of the lane-group form (one 32-row word a lane, the
words skewed along the anti-diagonal with the delta handed from lane to
lane, the uint8 match mask from bit planes) equals it at widths 257 to
1024 and on edge cases; the variant chooser maps each width to the
intended word count; and CPU linker runs on columns of
``max_string_length`` 64 and 300 whose values run past one word (past 256
characters at 300) give the reference's gamma matrix bit for bit.
"""

import copy

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# tier-1 runs several pytest workers on the cores; one intra-op thread each
# keeps them from oversubscribing the CPU
torch.set_num_threads(1)
pd = pytest.importorskip("pandas")

import splink_tpu  # noqa: E402
import splink_tpu_torch  # noqa: E402
from splink_tpu.ops import strings as ref_strings  # noqa: E402
from splink_tpu_torch.ops import strings_cuda  # noqa: E402

M32 = 0xFFFFFFFF


def _pairs(seed, n, width, dtype, alphabet=6):
    """Seeded correlated pairs (copies with edits and shifts), lengths 0..width."""
    rng = np.random.default_rng(seed)
    l1 = rng.integers(0, width + 1, n)
    l2 = np.where(rng.random(n) < 0.5, np.clip(l1 + rng.integers(-3, 4, n), 0, width),
                  rng.integers(0, width + 1, n))
    base = 0x4E00 if dtype == np.uint32 else ord("a")
    s1 = rng.integers(0, alphabet, (n, width)) + base
    s2 = np.where(rng.random((n, width)) < 0.2, rng.integers(0, alphabet, (n, width)) + base, s1)
    shift = rng.random(n) < 0.3
    s2[shift] = np.roll(s2[shift], 1, axis=1)
    pos = np.arange(width)[None, :]
    s1 = np.where(pos < l1[:, None], s1, 0).astype(dtype)
    s2 = np.where(pos < l2[:, None], s2, 0).astype(dtype)
    return s1, s2, l1.astype(np.int32), l2.astype(np.int32)


def _eq4(packed, c):
    """csrc/levenshtein.cu:eq4: zero-byte test of packed ^ (c * 0x01010101),
    flags gathered by one 32-bit multiply."""
    y = packed ^ ((c * 0x01010101) & M32)
    t = (((y & 0x7F7F7F7F) + 0x7F7F7F7F) & M32) | y
    z = ~t & 0x80808080
    return ((z * 0x00204081) & M32) >> 28


def _advance_bits(pv, mv, eq, hpos, hneg):
    """csrc/levenshtein.cu:advance_bits on 32-bit words (Python ints, or
    numpy uint64 arrays elementwise); the delta entering the top row and
    the one leaving bit 31 as bits (+1, -1)."""
    xv = eq | mv
    eq = eq | hneg
    xh = ((((eq & pv) + pv) & M32) ^ pv) | eq
    ph = (mv | ~(xh | pv)) & M32
    mh = pv & xh
    opos, oneg = ph >> 31, mh >> 31
    ph = ((ph << 1) & M32) | hpos
    mh = ((mh << 1) & M32) | hneg
    return (mh | ~(xv | ph)) & M32, ph & xv, opos, oneg


def _advance(pv, mv, eq, hin):
    """csrc/levenshtein.cu:advance on 32-bit words; the delta leaving bit 31."""
    pv, mv, opos, oneg = _advance_bits(pv, mv, eq, int(hin > 0), int(hin < 0))
    return pv, mv, opos - oneg


def _kernel_distance(a, b, la, lb, span, wide):
    """One pair through the kernel's algorithm, word by word. ``span`` is
    the longest pattern of the pair's warp: the kernel compares and
    advances every word up to it, whatever this pair's own length, and
    reads the distance off the vertical deltas of the pattern's rows."""
    text, pat, lt, lp = (b, a, lb, la) if la > lb else (a, b, la, lb)
    # past its length the kernel's row holds whatever the tile holds there;
    # matches in those rows must not reach row lp
    n_words = max((span + 31) // 32, 1)
    fill = int(text[0]) if lt else 0
    pat = [int(x) for x in pat[:lp]] + [fill] * (32 * n_words - lp)
    packed = [int.from_bytes(bytes(pat[4 * k: 4 * k + 4]), "little")
              for k in range(8 * n_words)] if not wide else None
    pv, mv = [M32] * n_words, [0] * n_words
    # groups of four characters compared per word: those the span reaches
    # in a one-word column, all eight past it
    groups = (span + 3) // 4 if n_words == 1 else 8
    for c in (int(x) for x in text[:lt]):
        h = 1
        for w in range(n_words):
            if wide:
                eq = sum(1 << k for k in range(4 * groups) if pat[32 * w + k] == c)
            else:
                eq = sum(_eq4(packed[8 * w + k], c) << (4 * k) for k in range(groups))
            pv[w], mv[w], h = _advance(pv[w], mv[w], eq, h)
    score = lt
    for w in range(n_words):
        rows = (1 << max(min(lp - 32 * w, 32), 0)) - 1
        score += bin(pv[w] & rows).count("1") - bin(mv[w] & rows).count("1")
    return score


@pytest.mark.parametrize("width", [8, 40, 64, 128, 256, 264])
@pytest.mark.parametrize("dtype", [np.uint8, np.uint32])
def test_multiword_myers_emulation_equals_row_dp(width, dtype):
    s1, s2, l1, l2 = _pairs(width + (7 if dtype == np.uint32 else 0), 120, width, dtype)
    want = np.asarray(ref_strings.levenshtein_vmapped(s1, s2, l1, l2))
    # groups of pairs share their longest pattern as the span, as a warp does
    # (the kernel orders a block's pairs by text length first)
    order = np.argsort(np.minimum(l1, l2), kind="stable")
    span = np.empty_like(l1)
    span[order] = np.maximum(l1, l2)[order].reshape(-1, 8).max(axis=1).repeat(8)
    got = [_kernel_distance(s1[i], s2[i], int(l1[i]), int(l2[i]), int(span[i]),
                            dtype == np.uint32) for i in range(len(l1))]
    np.testing.assert_array_equal(np.array(got, np.int32), want)


def _prmt_sign(x, sel):
    """csrc/levenshtein.cu:byte_sign, PTX prmt.b32 in its default mode with
    b = 0: per result byte j, source byte sel[j] & 7, its sign replicated
    over the byte where bit 3 of sel[j] is set (on arrays)."""
    x = np.asarray(x, np.uint64)
    out = np.zeros_like(x)
    for j in range(4):
        nib = (sel >> (4 * j)) & 0xF
        src = nib & 7
        byte = (x >> np.uint64(8 * src)) & np.uint64(0xFF) if src < 4 else np.zeros_like(x)
        if nib & 8:
            byte = np.where(byte & np.uint64(0x80), np.uint64(0xFF), np.uint64(0))
        out |= byte << np.uint64(8 * j)
    return out


def _planes(pk):
    """csrc/levenshtein.cu:Planes: the 8 words of four uint8 characters in
    ``pk[..., q]`` to 8 bit planes (bit j of plane k: bit k of character
    j), each byte's bit gathered with eq4's multiply."""
    planes = np.zeros(pk.shape, np.uint64)
    for k in range(8):
        for q in range(8):
            z = ((pk[..., q] << np.uint64(7 - k)) & np.uint64(M32)) & np.uint64(0x80808080)
            planes[..., k] |= (((z * np.uint64(0x00204081)) & np.uint64(M32)) >> np.uint64(28)) \
                << np.uint64(4 * q)
    return planes


def _planes_eq(planes, c):
    """Planes::eq: the match mask of character ``c`` (broadcast against
    ``planes[..., k]``): the AND of plane k or its complement by bit k of
    c, the selectors made by two multiplies and sign-replicating permutes."""
    hi = (c * np.uint64(0x08040201)) & np.uint64(M32)
    lo = (c * np.uint64(0x80402010)) & np.uint64(M32)
    m = np.full(np.broadcast(c, planes[..., 0]).shape, M32, np.uint64)
    for k, x, sel in ((7, hi, 0x8888), (6, hi, 0x9999), (5, hi, 0xAAAA), (4, hi, 0xBBBB),
                      (3, lo, 0x8888), (2, lo, 0x9999), (1, lo, 0xAAAA), (0, lo, 0xBBBB)):
        m &= ~(planes[..., k] ^ _prmt_sign(x, sel)) & np.uint64(M32)
    return m


def _group_distances(s1, s2, l1, l2, wide):
    """The lane-group form on a batch: G = ceil(width / 32) lanes a pair,
    floor(32 / G) pairs a warp after the block's counting sort by text
    length, lane l holding pattern rows [32l, 32l + 32) and their deltas.
    At step t lane l advances over text column t - l with the delta that
    lane l - 1 handed on at step t - 1 (lane 0: +1), and keeps its words
    outside columns 0..lt - 1; every pair of a warp runs the warp's
    longest lt + ceil(lp / 32) - 1 steps; lanes past the pattern's words
    run on whatever their rows hold; the group sums each lane's rows below
    lp. Vectorised over (pairs, lanes) on uint64 masked to 32 bits."""
    n, width = s1.shape
    G = -(-width // 32)
    swap = l1 > l2
    lt, lp = np.where(swap, l2, l1).astype(np.int64), np.where(swap, l1, l2).astype(np.int64)
    text = np.where(swap[:, None], s2, s1).astype(np.uint64)
    pat = np.where(swap[:, None], s1, s2).astype(np.uint64)
    # the kernel's rows past lp hold whatever the tile holds: fill them with
    # the text's first character, so that every such row matches
    pos = np.arange(32 * G)[None, :]
    padded = np.zeros((n, 32 * G), np.uint64)
    padded[:, :width] = pat
    padded = np.where(pos < lp[:, None], padded, text[:, :1]).reshape(n, G, 32)
    if wide:
        match = lambda c: (  # noqa: E731
            (padded == c[..., None]).astype(np.uint64) << np.arange(32, dtype=np.uint64)
        ).sum(axis=2)
    else:
        pk = (padded.reshape(n, G, 8, 4) << (8 * np.arange(4, dtype=np.uint64))).sum(axis=3)
        planes = _planes(pk)
        match = lambda c: _planes_eq(planes, c)  # noqa: E731
    need = np.where(lt > 0, lt + (lp + 31) // 32 - 1, 0)
    per_warp = 32 // G
    order = np.argsort(lt, kind="stable")
    n_warps = -(-n // per_warp)
    warp_need = np.zeros(n_warps * per_warp, np.int64)
    warp_need[:n] = need[order]
    steps = np.empty(n, np.int64)
    steps[order] = warp_need.reshape(n_warps, per_warp).max(axis=1).repeat(per_warp)[:n]

    lanes = np.arange(G)[None, :]
    pv = np.full((n, G), M32, np.uint64)
    mv = np.zeros((n, G), np.uint64)
    carry_pos = np.zeros((n, G), np.uint64)
    carry_neg = np.zeros((n, G), np.uint64)
    carry_c = np.zeros((n, G), np.uint64)
    text_pad = np.concatenate([text, np.zeros((n, 32 * G + width), np.uint64)], axis=1)
    for t in range(int(steps.max()) if n else 0):
        i = t - lanes
        active = (i >= 0) & (i < lt[:, None]) & (t < steps[:, None])
        if wide:  # each lane reads its own column's character
            c = np.where(active, np.take_along_axis(text_pad, np.clip(i, 0, None), axis=1), 0)
        else:  # lane 0 reads it, the others take it from lane l - 1
            first = np.where(t < lt, text_pad[:, t], 0).astype(np.uint64)
            c = np.where(lanes == 0, first[:, None], carry_c).astype(np.uint64)
        hpos = np.where(lanes == 0, np.uint64(1), carry_pos)
        hneg = np.where(lanes == 0, np.uint64(0), carry_neg)
        npv, nmv, opos, oneg = _advance_bits(pv, mv, match(c), hpos, hneg)
        pv, mv = np.where(active, npv, pv), np.where(active, nmv, mv)
        # __shfl_up_sync by one: lane l gets lane l - 1's (lane 0 its own)
        carry_pos[:, 1:], carry_neg[:, 1:], carry_c[:, 1:] = opos[:, :-1], oneg[:, :-1], c[:, :-1]
    rows = np.clip(lp[:, None] - 32 * lanes, 0, 32)
    own = np.where(rows >= 32, M32, (1 << rows) - 1).astype(np.uint64)
    popc = np.vectorize(lambda x: bin(int(x)).count("1"), otypes=[np.int64])
    score = popc(pv & own) - popc(mv & own)
    d = 1
    while d < G:  # __shfl_down_sync tree within the group
        shifted = np.zeros_like(score)
        shifted[:, :-d] = score[:, d:]
        score = score + np.where(lanes + d < G, shifted, 0)
        d *= 2
    return (lt + score[:, 0]).astype(np.int32)


_GROUP_CASES = [(w, d) for w in (257, 264, 288, 300, 320) for d in (np.uint8, np.uint32)]
_GROUP_CASES += [(512, np.uint8), (512, np.uint32), (1024, np.uint8), (1024, np.uint32)]


@pytest.mark.parametrize("width,dtype", _GROUP_CASES)
def test_lane_group_emulation_equals_row_dp(width, dtype):
    n = 12 if width <= 320 else 4  # the emulation's steps grow with the width
    s1, s2, l1, l2 = _pairs(width + (3 if dtype == np.uint32 else 0), n, width, dtype)
    want = np.asarray(ref_strings.levenshtein_vmapped(s1, s2, l1, l2))
    np.testing.assert_array_equal(_group_distances(s1, s2, l1, l2, dtype == np.uint32), want)


@pytest.mark.parametrize("width", [320, 1024])
@pytest.mark.parametrize("dtype", [np.uint8, np.uint32])
def test_lane_group_emulation_edge_cases(width, dtype):
    """Empty strings, identical strings, lengths on a lane's word boundary
    (32k and 32k +- 1) and one side at the full width."""
    lens = [0, 1, 31, 32, 33, 63, 64, 65, 255, 256, 257, width - 1, width]
    rng = np.random.default_rng(width)
    pairs = [(0, 0), (0, width), (width, 0), (width, width)]
    pairs += [(a, a) for a in lens[1:]]  # identical
    pairs += [(a, b) for a, b in zip(lens, lens[1:])]
    pairs += [(a, width) for a in lens[1:6]]
    n = len(pairs)
    l1 = np.array([a for a, _ in pairs], np.int32)
    l2 = np.array([b for _, b in pairs], np.int32)
    base = 0x4E00 if dtype == np.uint32 else ord("a")
    s1 = rng.integers(0, 4, (n, width)) + base
    s2 = s1.copy()
    edit = rng.random((n, width)) < 0.05
    s2[edit] = rng.integers(0, 4, int(edit.sum())) + base
    s2[: n // 2] = s1[: n // 2]  # the first half identical up to their lengths
    pos = np.arange(width)[None, :]
    s1 = np.where(pos < l1[:, None], s1, 0).astype(dtype)
    s2 = np.where(pos < l2[:, None], s2, 0).astype(dtype)
    want = np.asarray(ref_strings.levenshtein_vmapped(s1, s2, l1, l2))
    assert (want[[p for p, (a, b) in enumerate(pairs) if a == b == 0]] == 0).all()
    np.testing.assert_array_equal(_group_distances(s1, s2, l1, l2, dtype == np.uint32), want)


def test_bit_planes_equal_eq4():
    """The lane-group form's bit-plane match mask against eq4's, for every
    character, on words of random bytes and of 0x00, 0x7F, 0x80, 0xFF."""
    rng = np.random.default_rng(11)
    specials = np.array([0x00, 0x01, 0x7F, 0x80, 0x81, 0xFE, 0xFF], np.uint8)
    chars = np.concatenate([rng.integers(0, 256, (40, 32)), rng.choice(specials, (40, 32))])
    pk = (chars.reshape(-1, 8, 4).astype(np.uint64)
          << (8 * np.arange(4, dtype=np.uint64))).sum(axis=2)
    planes = _planes(pk)
    for c in range(256):
        got = _planes_eq(planes, np.uint64(c))
        want = [sum(_eq4(int(w), c) << (4 * q) for q, w in enumerate(row)) for row in pk]
        np.testing.assert_array_equal(got, np.array(want, np.uint64))


def test_eq4_flags_every_byte():
    """The SWAR compare against every character and every byte pattern of
    a few words, including 0x00, 0x7F, 0x80 and 0xFF bytes."""
    rng = np.random.default_rng(3)
    specials = np.array([0x00, 0x01, 0x7F, 0x80, 0x81, 0xFE, 0xFF], np.uint8)
    words = np.concatenate([rng.integers(0, 256, (200, 4)), rng.choice(specials, (200, 4))])
    for row in words:
        packed = int.from_bytes(bytes(int(x) for x in row), "little")
        for c in range(256):
            want = sum(1 << k for k in range(4) if row[k] == c)
            assert _eq4(packed, c) == want


# Levenshtein has fixed-W variants up to 8 words, Jaro-Winkler W = 1 and 2;
# past them both take the lane-group form (-G, G lanes a pair) up to width
# 1024 and the generic form past it
_VARIANTS = [("levenshtein", w, n) for w, n in
             [(8, 1), (32, 1), (33, 2), (64, 2), (65, 4), (128, 4), (200, 8), (256, 8),
              (264, -9), (1000, -32), (257, -9), (320, -10), (1024, -32), (1025, 0),
              (4000, 0)]]
_VARIANTS += [("jaro_winkler", w, n) for w, n in
              [(8, 1), (32, 1), (33, 2), (64, 2), (65, -3), (256, -8), (264, -9), (96, -3),
               (128, -4), (1000, -32), (1024, -32), (1025, 0), (4000, 0)]]


@pytest.mark.parametrize("kernel,width,words", _VARIANTS)
@pytest.mark.parametrize("dtype", [torch.uint8, torch.int32, torch.uint32])
def test_kernel_variant_by_width(kernel, width, words, dtype):
    kind, got = strings_cuda.kernel_variant(kernel, width, dtype)
    assert got == words
    assert kind == ("u8" if dtype == torch.uint8 else "u32")


@pytest.mark.parametrize("kernel,kind,words,key", [
    ("jaro_winkler", "u8", 1, "jaro_winkler/u8/w1"),
    ("jaro_winkler", "u32", 0, "jaro_winkler/u32/w0"),
    ("jaro_winkler", "u8", -3, "jaro_winkler/u8/g3"),
    ("jaro_winkler", "u32", -32, "jaro_winkler/u32/g32"),
    ("levenshtein", "u8", 8, "levenshtein/u8/w8"),
    ("levenshtein", "u8", -10, "levenshtein/u8/g10"),
])
def test_variant_name(kernel, kind, words, key):
    assert strings_cuda.variant_name(kernel, kind, words) == key


def test_kernel_variant_refuses_other_dtypes():
    with pytest.raises(ValueError, match="dtype"):
        strings_cuda.kernel_variant("levenshtein", 16, torch.int64)
    with pytest.raises(ValueError, match="width"):
        strings_cuda.kernel_variant("jaro_winkler", 0, torch.uint8)


LETTERS = np.array(list("abcdefghijklmnopqrstuvwxyz "))


def _addresses(n, seed):
    """People with long free-text columns: ``address`` (20-60 characters)
    and ``employer`` (10-50), ~10% planted duplicates with one-character
    edits, ~2% nulls, blocked on ``blk``."""
    rng = np.random.default_rng(seed)

    def pool(k, lo, hi):
        return np.array(["".join(rng.choice(LETTERS[:-1], 1)) +
                         "".join(rng.choice(LETTERS, rng.integers(lo, hi + 1) - 1))
                         for _ in range(k)], dtype=object)

    n_dup = n // 10
    n_base = n - n_dup
    cols = {"address": pool(n // 4, 20, 60), "employer": pool(n // 8, 10, 50)}
    df = {k: v[rng.integers(0, len(v), n_base)] for k, v in cols.items()}
    df["blk"] = rng.integers(0, max(n // 40, 1), n_base)
    src = rng.integers(0, n_base, n_dup)
    for k in df:
        df[k] = np.concatenate([df[k], df[k][src]])
    for r in range(n_base, n):
        k = ("address", "employer")[rng.integers(0, 2)]
        s = df[k][r]
        i = int(rng.integers(0, len(s)))
        df[k][r] = s[:i] + str(rng.choice(LETTERS[:-1])) + s[i + 1:]
    for k in ("address", "employer"):
        df[k] = df[k].astype(object)
        df[k][rng.random(n) < 0.02] = None
    df["unique_id"] = np.arange(n)
    return pd.DataFrame(df)


def test_linker_gammas_at_width_64_equal_reference():
    """Columns of max_string_length 64 with values past 32 characters: the
    port's CPU run and splink_tpu give the same pairs and gamma matrix."""
    df = _addresses(1200, seed=5)
    assert df["address"].dropna().str.len().max() > 32
    s = {
        "link_type": "dedupe_only",
        "blocking_rules": ["l.blk = r.blk"],
        "max_iterations": 3,
        "comparison_columns": [
            {"col_name": "address", "num_levels": 3, "max_string_length": 64,
             "comparison": {"kind": "jaro_winkler", "thresholds": [0.94, 0.88]}},
            {"col_name": "employer", "num_levels": 3, "max_string_length": 64,
             "comparison": {"kind": "levenshtein", "thresholds": [0.3]}},
        ],
    }
    ref = splink_tpu.Splink(copy.deepcopy(s), df=df).get_scored_comparisons()
    got = splink_tpu_torch.Splink(copy.deepcopy(s), df=df, device="cpu").get_scored_comparisons()
    ref = ref.sort_values(["unique_id_l", "unique_id_r"]).reset_index(drop=True)
    got = got.sort_values(["unique_id_l", "unique_id_r"]).reset_index(drop=True)
    assert len(got) > 5_000
    np.testing.assert_array_equal(got["unique_id_l"], ref["unique_id_l"])
    np.testing.assert_array_equal(got["unique_id_r"], ref["unique_id_r"])
    for c in ("gamma_address", "gamma_employer"):
        np.testing.assert_array_equal(got[c].to_numpy(), ref[c].to_numpy(), c)
        assert len(np.unique(got[c])) >= 3  # every level is reached


def test_linker_gammas_at_width_300_equal_reference():
    """A levenshtein column of max_string_length 300 (the lane-group form's
    width on the card) whose values run 150-300 characters, with exact and
    one-typo duplicates: the port's CPU run and splink_tpu give the same
    pairs and gamma matrix."""
    rng = np.random.default_rng(17)
    n_base, n_dup = 130, 20
    base = np.array(["".join(rng.choice(LETTERS[:-1], 1)) +
                     "".join(rng.choice(LETTERS, rng.integers(149, 300)))
                     for _ in range(n_base)], dtype=object)
    src = rng.integers(0, n_base, n_dup)
    dup = []
    for r, s in enumerate(base[src]):  # every other duplicate exact
        i = int(rng.integers(0, len(s)))
        dup.append(s if r % 2 else s[:i] + str(rng.choice(LETTERS[:-1])) + s[i + 1:])
    desc = np.concatenate([base, np.array(dup, dtype=object)])
    desc[rng.random(len(desc)) < 0.02] = None
    blk = np.concatenate([rng.integers(0, 5, n_base), np.zeros(n_dup, np.int64)])
    blk[n_base:] = blk[src]
    df = pd.DataFrame({"unique_id": np.arange(len(desc)), "description": desc, "blk": blk})
    assert df["description"].dropna().str.len().max() > 256
    s = {
        "link_type": "dedupe_only",
        "blocking_rules": ["l.blk = r.blk"],
        "max_iterations": 3,
        "comparison_columns": [
            {"col_name": "description", "num_levels": 3, "max_string_length": 300,
             "comparison": {"kind": "levenshtein", "thresholds": [0.3]}},
        ],
    }
    ref = splink_tpu.Splink(copy.deepcopy(s), df=df).get_scored_comparisons()
    got = splink_tpu_torch.Splink(copy.deepcopy(s), df=df, device="cpu").get_scored_comparisons()
    ref = ref.sort_values(["unique_id_l", "unique_id_r"]).reset_index(drop=True)
    got = got.sort_values(["unique_id_l", "unique_id_r"]).reset_index(drop=True)
    assert len(got) > 1_500
    np.testing.assert_array_equal(got["unique_id_l"], ref["unique_id_l"])
    np.testing.assert_array_equal(got["unique_id_r"], ref["unique_id_r"])
    g = got["gamma_description"].to_numpy()
    np.testing.assert_array_equal(g, ref["gamma_description"].to_numpy())
    assert set(np.unique(g)) >= {0, 1, 2}  # every level is reached, nulls aside
