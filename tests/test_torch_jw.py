"""splink_tpu_torch's Jaro-Winkler kernel arithmetic and masked form, on CPU.

The CUDA kernel cannot run here, so this file holds its algorithm to the
JAX reference bit for bit: a pure-Python emulation of the fixed-width
kernel (csrc/jaro_winkler.cu:jw_pair) on the staged tiles of a block (the
longer string packed four bytes to a word and compared with the SWAR
match mask, the 64-bit window mask, the lowest-bit claim, the __ffs walk
of the two matched sets for the transpositions, the word-wise common
prefix, and the f32 expression in the kernel's order) equals
``splink_tpu.ops.strings.jaro_winkler`` at every width 1 to 32 (W = 1) and
at widths 33 to 64 (W = 2, 64-bit sets), uint8 and 32-bit codepoints, on
seeded pairs with characters left past their lengths, and on the edge
cases. A second emulation holds the lane-group form (csrc/jaro_winkler.cu:
jaro_winkler_group_kernel, columns wider than 64) to the reference the same
way: a block's survivors compacted and staged, ordered by the shorter
length, G = ceil(width / 32) lanes a pair, each lane's word of the longer
string, of ``used`` and of ``matched``, the window cut to the lane's word,
the group's lowest-lane claim, the rank compaction of the transpositions
and the per-lane common prefix, at widths 65 to 1000, dense and masked.
The masked plain version equals where(mask, jw, 0) and the Pallas kernel
(interpret mode) on the rows the mask keeps.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# tier-1 runs several pytest workers on the cores; one intra-op thread each
# keeps them from oversubscribing the CPU
torch.set_num_threads(1)

from splink_tpu.ops import strings as ref_strings  # noqa: E402
from splink_tpu.ops.strings_pallas import jaro_winkler_pallas  # noqa: E402
from splink_tpu_torch.ops import strings  # noqa: E402

M32 = 0xFFFFFFFF
M64 = (1 << 64) - 1
F32 = np.float32


def _eq4(packed, c):
    """csrc/common.cuh:eq4: zero-byte test of packed ^ (c * 0x01010101),
    flags gathered by one 32-bit multiply."""
    y = packed ^ ((c * 0x01010101) & M32)
    t = (((y & 0x7F7F7F7F) + 0x7F7F7F7F) & M32) | y
    z = ~t & 0x80808080
    return ((z * 0x00204081) & M32) >> 28


def _ffs(x):
    return (x & -x).bit_length()  # 1-based, 0 for 0, as __ffs


def _window(i, lb, words=1):
    """The kernel's window mask, cut to the positions below lb: 2w + 1 bits
    shifted left by i and right by w in 64 bits (W = 1), or shifted by
    i - w one way or the other (W = 2)."""
    w = max(lb // 2 - 1, 0)
    band = (1 << (2 * w + 1)) - 1
    if words == 1:
        return (((band << i) & M64) >> w) & ((1 << lb) - 1) & M32
    placed = band << (i - w) if i >= w else band >> (w - i)
    return placed & M64 & ((1 << lb) - 1)


def _load_word(tile, off):
    return int.from_bytes(bytes(tile[off: off + 4]), "little")


def _jw_value(m, mismatched, ell, l1, l2, lb):
    """csrc/jaro_winkler.cu:jw_value in float32, in its order."""
    jaro = F32(0.0)
    if m > 0:
        mf = F32(m)
        t = F32(mismatched // 2)
        jaro = ((mf / F32(l1) + mf / F32(l2)) + (mf - t) / mf) / F32(3.0)
    scale = min(F32(0.1), F32(1.0) / max(F32(lb), F32(1.0)))
    boosted = jaro + (F32(ell) * scale) * (F32(1.0) - jaro)
    return jaro if jaro < F32(0.7) else boosted


def _kernel_jw(t1, t2, off, l1, l2, width, span, wide):
    """One staged pair through the kernel's algorithm. t1, t2 are the
    block's tiles (every row of s1, of s2, back to back, with slack), the
    pair's rows start at ``off``; ``span`` is the longest longer-length
    of the pair's warp, which sets the groups of four compared."""
    swap = l1 > l2
    la = min(max(l2 if swap else l1, 0), width)
    lb = min(max(l1 if swap else l2, 0), width)
    ta, tb = (t2, t1) if swap else (t1, t2)
    words = 1 if width <= 32 else 2
    mask = (1 << 32 * words) - 1
    # every group of four of the words but the last; of the last, those
    # the span reaches (at least one)
    last = min(max(max(span - 32 * (words - 1) + 3, 0) >> 2, 1), 8)
    groups = [8] * (words - 1) + [last]
    if wide:
        pat = [tb[off + k] if k < span else 0 for k in range(32 * words)]
    else:
        pat = [_load_word(tb, off + 4 * k) if 4 * k < span else 0 for k in range(8 * words)]
    used = matched = 0
    for i in range(la):
        x = ta[off + i]
        if wide:
            match = sum(1 << (32 * w + k) for w in range(words) for k in range(4 * groups[w])
                        if pat[32 * w + k] == x)
        else:
            match = sum(_eq4(pat[8 * w + k], x) << (32 * w + 4 * k)
                        for w in range(words) for k in range(groups[w]))
        elig = match & _window(i, lb, words) & ~used & mask
        first = elig & (-elig & mask)
        used |= first
        matched |= (first != 0) << i
    m = bin(matched).count("1")
    mismatched, ra, rb = 0, matched, used
    while ra:
        mismatched += ta[off + _ffs(ra) - 1] != tb[off + _ffs(rb) - 1]
        ra &= ra - 1
        rb &= rb - 1
    ell = la
    if wide:
        ell = next((k for k in range(la) if t1[off + k] != t2[off + k]), la)
    else:
        for k in range(0, la, 4):
            x = _load_word(t1, off + k) ^ _load_word(t2, off + k)
            if x:
                ell = min(la, k + ((_ffs(x) - 1) >> 3))
                break
    return _jw_value(m, mismatched, ell, l1, l2, lb)


def _kernel_block(s1, s2, l1, l2, wide, warp=8):
    """A block of pairs through the emulation: rows staged back to back,
    pairs ordered by their shorter length, ``warp`` consecutive pairs
    sharing their longest longer-length as the span."""
    n, width = s1.shape
    t1 = [int(c) for c in s1.reshape(-1)] + [0] * 16
    t2 = [int(c) for c in s2.reshape(-1)] + [0] * 16
    lb = np.clip(np.maximum(l1, l2), 0, width)
    order = np.argsort(np.clip(np.minimum(l1, l2), 0, width), kind="stable")
    pad = (-n) % warp
    span = np.empty(n, np.int64)
    span[order] = np.concatenate([lb[order], np.zeros(pad, lb.dtype)]).reshape(
        -1, warp).max(axis=1).repeat(warp)[:n]
    return np.array([_kernel_jw(t1, t2, p * width, int(l1[p]), int(l2[p]), width,
                                int(span[p]), wide) for p in range(n)], np.float32)


def _random_pairs(rng, n, width, wide, alphabet=5):
    """Correlated pairs (copies with edits, shifts, equal strings) whose
    rows keep random characters past their lengths."""
    base = 0x4E00 if wide else ord("a")
    s1 = rng.integers(0, alphabet, (n, width)) + base
    s2 = np.where(rng.random((n, width)) < 0.25, rng.integers(0, alphabet, (n, width)) + base, s1)
    shift = rng.random(n) < 0.3
    s2[shift] = np.roll(s2[shift], int(rng.integers(1, 3)), axis=1)
    l1 = rng.integers(0, width + 1, n)
    l2 = np.where(rng.random(n) < 0.5, np.clip(l1 + rng.integers(-2, 3, n), 0, width),
                  rng.integers(0, width + 1, n))
    dtype = np.uint32 if wide else np.uint8
    return s1.astype(dtype), s2.astype(dtype), l1.astype(np.int32), l2.astype(np.int32)


def _reference(s1, s2, l1, l2, to=32):
    """splink_tpu's Jaro-Winkler on the rows padded to width ``to`` (its
    answer reads no character past a length), as (n,) float32."""
    pad = lambda s: np.pad(s, ((0, 0), (0, to - s.shape[1])))  # noqa: E731
    return np.asarray(ref_strings.jaro_winkler(pad(s1), pad(s2), l1, l2, 0.1, 0.7))


PAIRS_PER_WIDTH = 48


@pytest.fixture(scope="module", params=[False, True], ids=["u8", "u32"])
def random_by_width(request):
    """Per width 1..32, seeded pairs and the reference's answers (one
    reference call for all widths)."""
    wide = request.param
    rng = np.random.default_rng(20261017 + wide)
    cases = {w: _random_pairs(rng, PAIRS_PER_WIDTH, w, wide) for w in range(1, 33)}
    want = _reference(
        np.concatenate([np.pad(c[0], ((0, 0), (0, 32 - w))) for w, c in cases.items()]),
        np.concatenate([np.pad(c[1], ((0, 0), (0, 32 - w))) for w, c in cases.items()]),
        np.concatenate([c[2] for c in cases.values()]),
        np.concatenate([c[3] for c in cases.values()]),
    ).reshape(32, PAIRS_PER_WIDTH)
    return wide, cases, {w: want[w - 1] for w in cases}


@pytest.mark.parametrize("width", range(1, 33))
def test_kernel_emulation_equals_reference(random_by_width, width):
    wide, cases, want = random_by_width
    got = _kernel_block(*cases[width], wide)
    np.testing.assert_array_equal(got, want[width])
    assert (got > 0).any()


TWO_WORD_WIDTHS = (33, 36, 40, 47, 48, 56, 63, 64)


@pytest.fixture(scope="module", params=[False, True], ids=["u8", "u32"])
def random_two_words(request):
    """Per width of the W = 2 form, seeded pairs and the reference's answers
    (one reference call at width 64)."""
    wide = request.param
    rng = np.random.default_rng(20261018 + wide)
    cases = {w: _random_pairs(rng, 24, w, wide) for w in TWO_WORD_WIDTHS}
    pad = lambda a, w: np.pad(a, ((0, 0), (0, 64 - w)))  # noqa: E731
    want = _reference(
        np.concatenate([pad(c[0], w) for w, c in cases.items()]),
        np.concatenate([pad(c[1], w) for w, c in cases.items()]),
        np.concatenate([c[2] for c in cases.values()]),
        np.concatenate([c[3] for c in cases.values()]), to=64,
    ).reshape(len(cases), 24)
    return wide, cases, dict(zip(cases, want))


@pytest.mark.parametrize("width", TWO_WORD_WIDTHS)
def test_two_word_emulation_equals_reference(random_two_words, width):
    wide, cases, want = random_two_words
    got = _kernel_block(*cases[width], wide)
    np.testing.assert_array_equal(got, want[width])
    assert (got > 0).any()


def _encode(words, width, wide):
    s = np.zeros((len(words), width), np.uint32 if wide else np.uint8)
    for r, w in enumerate(words):
        codes = [ord(c) + (0x4E00 - ord("a") if wide else 0) for c in w]
        s[r, : len(codes)] = codes
    return s, np.array([len(w) for w in words], np.int32)


EDGE_CASES = {
    "empty": [("", ""), ("", "abc"), ("abc", ""), ("", "a")],
    "window_zero": [("a", "a"), ("ab", "ba"), ("abc", "bca"), ("ab", "abc"), ("abc", "cab"),
                    ("a", "b"), ("aa", "a")],
    "equal_32": [("abcdefghijklmnopqrstuvwxyzabcdef",) * 2, ("a" * 32,) * 2,
                 ("ab" * 16, "ba" * 16), ("a" * 32, "a" * 31 + "b")],
    "equal_64": [("abcdefghijklmnopqrstuvwxyz" * 2 + "abcdefghijkl",) * 2, ("a" * 64,) * 2,
                 ("ab" * 32, "ba" * 32), ("a" * 64, "a" * 63 + "b"), ("a" * 33, "a" * 64)],
    "repeated": [("aaaaaaaa", "aaaa"), ("abababab", "babababa"), ("aabbaabb", "bbaabbaa"),
                 ("abcabcabcabc", "cbacbacba"), ("aaaaaaaaaaaaaaaab", "baaaaaaaaaaaaaaaa")],
    "hand": [("martha", "marhta"), ("dixon", "dicksonx"), ("jellyfish", "smellyfish"),
             ("crate", "trace"), ("dwayne", "duane"), ("abcdefghijklmnop", "ponmlkjihgfedcba")],
}


@pytest.mark.parametrize("case", sorted(EDGE_CASES))
@pytest.mark.parametrize("wide", [False, True], ids=["u8", "u32"])
def test_kernel_emulation_edge_cases(case, wide):
    pairs = EDGE_CASES[case]
    # one word exactly, a width not a multiple of 4, two words
    for width in (32, 17, 64):
        kept = [(x, y) for x, y in pairs if max(len(x), len(y)) <= width]
        if not kept:
            continue
        s1, l1 = _encode([x for x, _ in kept], width, wide)
        s2, l2 = _encode([y for _, y in kept], width, wide)
        got = _kernel_block(s1, s2, l1, l2, wide)
        want = _reference(s1, s2, l1, l2, to=max(width, 32))
        np.testing.assert_array_equal(got, want, f"{case} width {width}")


@pytest.mark.parametrize("words", [1, 2])
def test_window_mask_covers_every_position(words):
    """The window mask equals the reference's [i - w, i + w] cut to [0, lb)
    for every i < lb <= 32 W: the window of 0 (lb <= 3) and a window
    reaching the last bit included."""
    for lb in range(0, 32 * words + 1):
        w = max(lb // 2 - 1, 0)
        for i in range(lb):
            want = sum(1 << j for j in range(max(i - w, 0), min(i + w + 1, lb)))
            assert _window(i, lb, words) == want, (i, lb)


def _pairs_for_mask(seed, n, width):
    rng = np.random.default_rng(seed)
    s1, s2, l1, l2 = _random_pairs(rng, n, width, False, alphabet=6)
    return s1, s2, l1, l2


@pytest.fixture(scope="module")
def masked_inputs():
    """One lane tile of the Pallas interpreter and its answers."""
    s1, s2, l1, l2 = _pairs_for_mask(11, 512, 12)
    pallas = np.asarray(jaro_winkler_pallas(s1, s2, l1, l2, 0.1, 0.7, interpret=True))
    return (s1, s2, l1, l2), pallas


@pytest.mark.parametrize("density", [0.0, 0.002, 0.5, 1.0])
def test_masked_plain_equals_where_and_pallas(masked_inputs, density):
    (s1, s2, l1, l2), pallas = masked_inputs
    rng = np.random.default_rng(int(density * 1000))
    keep = rng.random(len(l1)) < density
    if density == 0.002:
        keep[[3, 300]] = True  # at least a survivor or two
    args = tuple(torch.from_numpy(a) for a in (s1, s2, l1, l2))
    mask = torch.from_numpy(keep)
    got = strings.jaro_winkler_plain(*args, mask=mask)
    full = strings.jaro_winkler_plain(*args)
    assert got.dtype == torch.float32
    assert torch.equal(got, torch.where(mask, full, torch.zeros(())))
    # the dispatcher takes the plain version for CPU tensors
    assert torch.equal(strings.jaro_winkler(*args, 0.1, 0.7, mask), got)
    # the reference holds its Pallas kernel to its vmapped form within 1e-5
    # (tests/test_strings_pallas.py); the same tolerance here
    np.testing.assert_allclose(got.numpy()[keep], pallas[keep], rtol=0, atol=1e-5)
    assert (got.numpy()[~keep] == 0).all()


# --------------------------------------------------------------------------
# The lane-group form (columns wider than 64)
# --------------------------------------------------------------------------

GROUP_TILE_BYTES = 32 * 1024  # csrc/jaro_winkler.cu:kGroupTiles


def _group_shape(width, wide):
    """csrc/jaro_winkler.cu:launch_group: lanes a pair, pairs a warp, pairs a
    block (256 threads, halved while the staged rows pass 32 KB)."""
    lanes = -(-width // 32)
    groups = 32 // lanes
    rowbytes = width * (4 if wide else 1)
    threads = 256
    while threads > 32 and 2 * (threads // 32) * groups * rowbytes > GROUP_TILE_BYTES:
        threads //= 2
    return lanes, groups, threads // 32 * groups


def _eq4_lanes(pk, c):
    """_eq4 on every packed word of every lane at once: (lanes, 8) -> the
    lanes' 32-bit match words (csrc/common.cuh:Pattern::eq<8>)."""
    y = pk ^ np.uint64((c * 0x01010101) & M32)
    t = (((y & np.uint64(0x7F7F7F7F)) + np.uint64(0x7F7F7F7F)) & np.uint64(M32)) | y
    z = ~t & np.uint64(0x80808080)
    flags = ((z * np.uint64(0x00204081)) & np.uint64(M32)) >> np.uint64(28)
    return (flags << (np.uint64(4) * np.arange(8, dtype=np.uint64))).sum(axis=1)


def _bits_below(n):
    """csrc/jaro_winkler.cu:bits_below per lane: positions 0 .. n - 1 of a
    word, n clamped to [0, 32]."""
    return (np.uint64(1) << np.clip(n, 0, 32).astype(np.uint64)) - np.uint64(1)


def _lowest_bits(x):
    return [b for b in range(32) if x >> b & 1]


def _group_pair(t1, t2, off, l1, l2, width, steps, wide, lanes):
    """One staged pair through the lane-group form. t1, t2 are the block's
    tiles (lists of characters: bytes for uint8, codepoints otherwise), the
    pair's rows start at element ``off``; ``steps`` is the longest shorter
    length of the pair's warp, which the greedy loop runs to. Writes the
    longer string's matched characters over its row in the tile, as the
    kernel does."""
    swap = l1 > l2
    la = min(max(l2 if swap else l1, 0), width)
    lb = min(max(l1 if swap else l2, 0), width)
    ta, tb = (t2, t1) if swap else (t1, t2)
    window = max(lb // 2 - 1, 0)
    lo = 32 * np.arange(lanes, dtype=np.int64)
    span = np.clip(lb - lo, 0, 32)
    # each lane's 32 positions of the longer string, zero past its span
    if wide:
        ch = np.array([[tb[off + lo[l] + k] if k < span[l] else 0 for k in range(32)]
                       for l in range(lanes)], np.uint64)
    else:
        pk = np.array([[_load_word(tb, off + lo[l] + 4 * k) if 4 * k < span[l] else 0
                        for k in range(8)] for l in range(lanes)], np.uint64)
    used = np.zeros(lanes, np.uint64)
    matched = np.zeros(lanes, np.uint64)
    bit_of = np.uint64(1) << np.arange(32, dtype=np.uint64)
    for i in range(steps):
        x = ta[off + i]
        win = _bits_below(np.minimum(i + window + 1, lb) - lo) & ~_bits_below(i - window - lo)
        if wide:
            match = ((ch == np.uint64(x)) * bit_of).sum(axis=1).astype(np.uint64)
        else:
            match = _eq4_lanes(pk, x)
        elig = match & win & ~used & np.uint64(M32) if i < la else np.zeros(lanes, np.uint64)
        claim = np.flatnonzero(elig)  # the group's ballot
        if claim.size:
            w = claim[0]  # the lowest lane claims its lowest eligible position
            e = int(elig[w])
            used[w] |= np.uint64(e & -e)
            matched[i >> 5] |= np.uint64(1 << (i & 31))
    ca = [bin(int(v)).count("1") for v in matched]
    cb = [bin(int(v)).count("1") for v in used]
    ia, ib = np.cumsum(ca), np.cumsum(cb)
    m = int(ia[-1])
    # common prefix: each lane's first difference below la, the lowest lane's
    own = np.clip(la - lo, 0, 32)
    diff = [32] * lanes
    for l in range(lanes):
        if wide:
            diff[l] = next((j for j in range(own[l])
                            if t1[off + lo[l] + j] != t2[off + lo[l] + j]), 32)
        else:
            for q in range(8):
                if 4 * q < own[l] and diff[l] == 32:
                    x = (_load_word(t1, off + lo[l] + 4 * q)
                         ^ _load_word(t2, off + lo[l] + 4 * q))
                    if x:
                        diff[l] = 4 * q + ((_ffs(x) - 1) >> 3)
    differs = [l for l in range(lanes) if diff[l] < own[l]]
    ell = min(la, 32 * differs[0] + diff[differs[0]]) if differs else la
    # transpositions: b's matched characters in rank order over b's row,
    # from the lanes' registers; then a's against them, rank by rank
    for l in range(lanes):
        r = int(ib[l]) - cb[l]
        for j in _lowest_bits(int(used[l])):
            tb[off + r] = int(ch[l, j]) if wide else (int(pk[l, j >> 2]) >> (8 * (j & 3))) & 0xFF
            r += 1
    mismatched = 0
    for l in range(lanes):
        r = int(ia[l]) - ca[l]
        for j in _lowest_bits(int(matched[l])):
            mismatched += ta[off + lo[l] + j] != tb[off + r]
            r += 1
    return _jw_value(m, mismatched, ell, l1, l2, lb)


def _group_block(s1, s2, l1, l2, wide, mask=None):
    """Pairs through the lane-group form, block by block as the kernel cuts
    them: each block's survivors (every row when dense) staged back to back,
    ordered by their shorter length, ``groups`` consecutive pairs sharing a
    warp and so its longest shorter length as their step count. Rows the
    mask drops read 0."""
    n, width = s1.shape
    lanes, groups, per_block = _group_shape(width, wide)
    out = np.full(n, np.nan, np.float32)
    for first in range(0, n, per_block):
        rows = range(first, min(first + per_block, n))
        keep = [r for r in rows if mask is None or mask[r]]
        for r in rows:
            if mask is not None and not mask[r]:
                out[r] = 0.0
        if not keep:
            continue
        t1 = [int(c) for r in keep for c in s1[r]] + [0] * 64
        t2 = [int(c) for r in keep for c in s2[r]] + [0] * 64
        la = [min(max(min(int(l1[r]), int(l2[r])), 0), width) for r in keep]
        order = np.argsort(la, kind="stable")
        for w in range(0, len(keep), groups):
            slots = order[w:w + groups]
            steps = max(la[s] for s in slots)
            for s in slots:
                r = keep[s]
                out[r] = _group_pair(t1, t2, s * width, int(l1[r]), int(l2[r]), width, steps,
                                     wide, lanes)
    assert not np.isnan(out).any()
    return out


GROUP_WIDTHS = (65, 96, 127, 128, 129, 256, 300, 1000)
GROUP_PAIRS = 16


@pytest.fixture(scope="module", params=[False, True], ids=["u8", "u32"])
def random_group_widths(request):
    """Per width of the lane-group form, seeded pairs and the reference's
    answers (one reference call at width 1000)."""
    wide = request.param
    rng = np.random.default_rng(20261019 + wide)
    cases = {w: _random_pairs(rng, GROUP_PAIRS, w, wide) for w in GROUP_WIDTHS}
    to = max(GROUP_WIDTHS)
    pad = lambda a, w: np.pad(a, ((0, 0), (0, to - w)))  # noqa: E731
    want = _reference(
        np.concatenate([pad(c[0], w) for w, c in cases.items()]),
        np.concatenate([pad(c[1], w) for w, c in cases.items()]),
        np.concatenate([c[2] for c in cases.values()]),
        np.concatenate([c[3] for c in cases.values()]), to=to,
    ).reshape(len(cases), GROUP_PAIRS)
    return wide, cases, dict(zip(cases, want))


@pytest.mark.parametrize("width", GROUP_WIDTHS)
def test_group_emulation_equals_reference(random_group_widths, width):
    wide, cases, want = random_group_widths
    got = _group_block(*cases[width], wide)
    np.testing.assert_array_equal(got, want[width])
    assert (got > 0).any()


def _boundary_pairs():
    """Pairs whose windows start or end on a lane's word boundary: at lb =
    66 the window is 32, so a[0] reaches b[32] (lane 1's first position) and
    a[64] reaches back to b[32] but not b[31]; at lb = 130 (window 64), a[0]
    reaches b[64] and a[96] reaches back to b[32]; matches on either side of
    a boundary and transpositions across lanes."""
    return [
        ("b" + "a" * 65, "c" * 32 + "b" + "c" * 33),
        ("c" * 64 + "zc", "c" * 31 + "zz" + "c" * 33),
        ("c" * 64 + "zc", "c" * 31 + "yz" + "c" * 33),
        ("q" + "a" * 129, "c" * 64 + "q" + "c" * 65),
        ("q" + "a" * 129, "c" * 65 + "q" + "c" * 64),
        ("c" * 96 + "w" + "c" * 33, "d" * 32 + "w" + "d" * 97),
        ("c" * 96 + "w" + "c" * 33, "d" * 31 + "w" + "d" * 98),
        ("ab" * 40, "ba" * 40),
        ("abcd" * 33, "bcda" * 33),
        ("xyz" * 43 + "x", "zyx" * 43 + "z"),
    ]


GROUP_EDGE_CASES = {
    "empty": [("", ""), ("", "abc" * 30), ("abc" * 30, ""), ("", "a")],
    "identical": [("abcdefghijklmnopqrstuvwxyz" * 4,) * 2, ("a" * 128,) * 2,
                  ("a" * 97,) * 2, ("ab" * 64, "ab" * 64), ("a" * 97, "a" * 128)],
    "boundaries": _boundary_pairs(),
    "hand": [("martha", "marhta"), ("dixon", "dicksonx"), ("jellyfish", "smellyfish"),
             ("crate", "trace"), ("a" * 65, "a" * 64 + "b"), ("a" * 100 + "b", "b" + "a" * 100)],
}


@pytest.mark.parametrize("case", sorted(GROUP_EDGE_CASES))
@pytest.mark.parametrize("wide", [False, True], ids=["u8", "u32"])
def test_group_emulation_edge_cases(case, wide):
    pairs = GROUP_EDGE_CASES[case]
    for width in (65, 96, 128, 136, 300):
        kept = [(x, y) for x, y in pairs if max(len(x), len(y)) <= width]
        if not kept:
            continue
        s1, l1 = _encode([x for x, _ in kept], width, wide)
        s2, l2 = _encode([y for _, y in kept], width, wide)
        got = _group_block(s1, s2, l1, l2, wide)
        want = _reference(s1, s2, l1, l2, to=width)
        np.testing.assert_array_equal(got, want, f"{case} width {width}")


def test_group_boundaries_reach_the_lane_edges():
    """The boundary pairs really match across a lane's first or last
    position: each pair with a planted match scores above zero, and the
    pairs one position outside their window score zero."""
    s1, l1 = _encode([x for x, _ in _boundary_pairs()], 136, False)
    s2, l2 = _encode([y for _, y in _boundary_pairs()], 136, False)
    got = _group_block(s1, s2, l1, l2, False)
    assert got[0] > 0 and got[3] > 0 and got[5] > 0  # the window's edge, inside
    assert got[4] == 0 and got[6] == 0  # one position outside


@pytest.fixture(scope="module")
def masked_group_inputs():
    """Two blocks and more of width 96 (u8) and 300 (u32) pairs, and the
    reference's answers."""
    rng = np.random.default_rng(23)
    out = {}
    for width, wide, n in ((96, False, 200), (300, True, 40)):
        s1, s2, l1, l2 = _random_pairs(rng, n, width, wide, alphabet=6)
        out[width] = ((s1, s2, l1, l2), wide, _reference(s1, s2, l1, l2, to=width))
    return out


@pytest.mark.parametrize("density", [0.0, 0.002, 0.5, 1.0])
@pytest.mark.parametrize("width", [96, 300])
def test_group_emulation_masked(masked_group_inputs, density, width):
    (s1, s2, l1, l2), wide, want = masked_group_inputs[width]
    rng = np.random.default_rng(int(density * 1000) + width)
    keep = rng.random(len(l1)) < density
    if density == 0.002:
        keep[[1, len(l1) - 3]] = True  # a survivor or two, in different blocks
    got = _group_block(s1, s2, l1, l2, wide, mask=keep)
    np.testing.assert_array_equal(got, np.where(keep, want, np.float32(0)))
    # and the masked plain version of the port, which the CPU runs
    args = tuple(torch.from_numpy(a) for a in (s1, s2, l1, l2))
    plain = strings.jaro_winkler_plain(*args, mask=torch.from_numpy(keep))
    np.testing.assert_array_equal(plain.numpy(), got)
