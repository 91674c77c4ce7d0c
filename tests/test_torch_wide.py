"""splink_tpu_torch's string kernels past one 32-bit word, on CPU.

The CUDA kernels cannot run here, so this file holds what surrounds them
to the JAX reference: a pure-Python emulation of the Levenshtein kernel's
step (the uint8 SWAR match mask and the multi-word Myers/Hyyro advance on
32-bit words, horizontal delta carried from word to word, the shorter
string as the text) equals ``levenshtein_vmapped`` exactly at widths 40 to
264; the variant chooser maps each width to the intended word count; and a
CPU linker run on columns of ``max_string_length`` 64 whose values run past
32 characters gives the reference's gamma matrix bit for bit.
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


def _advance(pv, mv, eq, hin):
    """csrc/levenshtein.cu:advance on 32-bit words; the delta leaving bit 31."""
    hneg = 1 if hin < 0 else 0
    xv = eq | mv
    eq |= hneg
    xh = ((((eq & pv) + pv) & M32) ^ pv) | eq
    ph = (mv | ~(xh | pv)) & M32
    mh = pv & xh
    hout = (ph >> 31) - (mh >> 31)
    ph = ((ph << 1) & M32) | (1 if hin > 0 else 0)
    mh = ((mh << 1) & M32) | hneg
    return (mh | ~(xv | ph)) & M32, ph & xv, hout


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


# Levenshtein has fixed-W variants up to 8 words; Jaro-Winkler W = 1 and 2,
# its lane-group form (-G, G lanes a pair) up to width 1024 and its generic
# form past it
_VARIANTS = [("levenshtein", w, n) for w, n in
             [(8, 1), (32, 1), (33, 2), (64, 2), (65, 4), (128, 4), (200, 8), (256, 8),
              (264, 0), (1000, 0)]]
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
