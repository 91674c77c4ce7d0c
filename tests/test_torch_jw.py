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
cases. The masked plain version equals where(mask, jw, 0) and the Pallas
kernel (interpret mode) on the rows the mask keeps.
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
