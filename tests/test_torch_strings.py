"""Plain PyTorch string similarities of splink_tpu_torch against splink_tpu.

The plain versions are what the CUDA kernels are held against on the card
(chip_smoke.py), so here they are held against the JAX reference on the
CPU: Jaro-Winkler bit for bit (``assert_array_equal``) with
``jaro_winkler_vmapped`` at widths 8/24/32 (bitmask form) and 40 to 264
(vector form), uint8 and wide uint32; the jar golden vectors at the
tolerance of tests/test_jar_similarity.py; Levenshtein exactly equal to
``levenshtein_vmapped`` at the same widths and to the Pallas kernel in
interpret mode.
"""

import json
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# tier-1 runs several pytest workers on the cores; one intra-op thread each
# keeps them from oversubscribing the CPU
torch.set_num_threads(1)

from splink_tpu.ops import strings as ref_strings  # noqa: E402
from splink_tpu.ops.strings_pallas import levenshtein_pallas  # noqa: E402
from splink_tpu_torch.data import encode_string_column  # noqa: E402
from splink_tpu_torch.ops import strings  # noqa: E402

VEC_PATH = os.path.join(os.path.dirname(__file__), "data", "jar_similarity_vectors.json")


def _pairs(seed, n, width, dtype, alphabet=6):
    """Seeded (s1, s2, l1, l2) with correlated strings (copies, one-char
    edits, shifts) so the greedy matching and transpositions get exercised."""
    rng = np.random.default_rng(seed)
    l1 = rng.integers(0, width + 1, n)
    l2 = rng.integers(0, width + 1, n)
    base = 0x4E00 if dtype == np.uint32 else ord("a")  # CJK codepoints when wide
    s1 = rng.integers(0, alphabet, (n, width)) + base
    s2 = np.where(rng.random((n, width)) < 0.3, rng.integers(0, alphabet, (n, width)) + base, s1)
    shift = rng.random(n) < 0.3
    s2[shift] = np.roll(s2[shift], 1, axis=1)
    pos = np.arange(width)[None, :]
    s1 = np.where(pos < l1[:, None], s1, 0).astype(dtype)
    s2 = np.where(pos < l2[:, None], s2, 0).astype(dtype)
    return s1, s2, l1.astype(np.int32), l2.astype(np.int32)


def _t(a):
    # torch carries the wide encoding as int32 codepoints
    return torch.from_numpy(a.astype(np.int32) if a.dtype == np.uint32 else a)


# widths past one 32-bit word: the kernels' multi-word and generic variants
WIDE = [(w, d) for w in (40, 64, 128, 256, 264) for d in (np.uint8, np.uint32)]


def _n_pairs(width):
    return 2000 if width <= 40 else 300  # the widest cases take a few hundred


@pytest.mark.parametrize(
    "width,dtype",
    [(8, np.uint8), (24, np.uint8), (32, np.uint8), (24, np.uint32), (32, np.uint32)] + WIDE,
)
def test_jaro_winkler_bit_identical_to_vmapped(width, dtype):
    s1, s2, l1, l2 = _pairs(width, _n_pairs(width), width, dtype)
    want = np.asarray(ref_strings.jaro_winkler_vmapped(s1, s2, l1, l2, 0.1, 0.7))
    got = strings.jaro_winkler(_t(s1), _t(s2), _t(l1), _t(l2), 0.1, 0.7).numpy()
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got, want)


def test_jaro_winkler_matches_jar_golden_vectors():
    with open(VEC_PATH) as fh:
        vectors = json.load(fh)
    a = encode_string_column([v["a"] for v in vectors], width=32)
    b = encode_string_column([v["b"] for v in vectors], width=32)
    w = max(a.bytes_.shape[1], b.bytes_.shape[1])
    pad = lambda x: np.pad(x, ((0, 0), (0, w - x.shape[1])))  # noqa: E731
    ours = strings.jaro_winkler(
        _t(pad(a.bytes_)), _t(pad(b.bytes_)), _t(a.lengths), _t(b.lengths), 0.1, 0.7
    ).numpy().astype(np.float64)
    jar = np.array([v["jw"] for v in vectors])
    assert np.abs(ours - jar).max() < 2e-6
    for t in (0.94, 0.88, 0.7):
        off_boundary = np.abs(jar - t) > 4e-6
        assert not (off_boundary & ((ours > t) != (jar > t))).any()


@pytest.mark.parametrize(
    "width,dtype", [(8, np.uint8), (24, np.uint8), (32, np.uint8), (24, np.uint32)] + WIDE
)
def test_levenshtein_equal_to_vmapped(width, dtype):
    s1, s2, l1, l2 = _pairs(100 + width, _n_pairs(width), width, dtype)
    want = np.asarray(ref_strings.levenshtein_vmapped(s1, s2, l1, l2))
    got = strings.levenshtein(_t(s1), _t(s2), _t(l1), _t(l2)).numpy()
    assert got.dtype == np.int32
    np.testing.assert_array_equal(got, want)


def test_levenshtein_equal_to_pallas_interpret():
    s1, s2, l1, l2 = _pairs(7, 512, 12, np.uint8)  # one lane tile of the interpreter
    want = np.asarray(levenshtein_pallas(s1, s2, l1, l2, interpret=True))
    got = strings.levenshtein(_t(s1), _t(s2), _t(l1), _t(l2)).numpy()
    np.testing.assert_array_equal(got, want.astype(np.int32))


@pytest.mark.parametrize("width", [8, 24])
def test_levenshtein_ratio_equal(width):
    s1, s2, l1, l2 = _pairs(200 + width, 2000, width, np.uint8)
    want = np.asarray(ref_strings.levenshtein_ratio_vmapped(s1, s2, l1, l2))
    got = strings.levenshtein_ratio(_t(s1), _t(s2), _t(l1), _t(l2)).numpy()
    np.testing.assert_array_equal(got, want)


def test_edge_cases():
    """The reference kernel tests' hand cases (tests/test_strings_pallas.py)."""
    from conftest import py_jaro_winkler

    cases = [("martha", "marhta"), ("dixon", "dicksonx"), ("jellyfish", "smellyfish"),
             ("", ""), ("", "abc"), ("abc", ""), ("a", "a"), ("ab", "ba"),
             ("abcdefgh", "abcdefgh"), ("crate", "trace"), ("dwayne", "duane"),
             ("aaaaaaaa", "aaaa"), ("kitten", "sitting"), ("flaw", "lawn")]
    enc = lambda ss: encode_string_column(ss, width=16)  # noqa: E731
    a, b = enc([x for x, _ in cases]), enc([y for _, y in cases])
    w = max(a.bytes_.shape[1], b.bytes_.shape[1])
    pad = lambda x: _t(np.pad(x, ((0, 0), (0, w - x.shape[1]))))  # noqa: E731
    args = (pad(a.bytes_), pad(b.bytes_), _t(a.lengths), _t(b.lengths))
    jw = strings.jaro_winkler(*args).numpy()
    np.testing.assert_allclose(jw, [py_jaro_winkler(x, y) for x, y in cases], atol=1e-6)
    lev = strings.levenshtein(*args).numpy()
    assert lev[3:6].tolist() == [0, 3, 3]
    assert lev[-2:].tolist() == [3, 2]


def test_cuda_wrapper_checks_inputs():
    """The CUDA wrappers refuse CPU tensors (they never fall back) and the
    dispatch of a CPU tensor goes to the plain version."""
    from splink_tpu_torch.ops import strings_cuda

    ln = torch.zeros(4, dtype=torch.int32)
    for s in (torch.zeros((4, 8), dtype=torch.uint8), torch.zeros((4, 264), dtype=torch.uint8),
              torch.zeros((4, 264), dtype=torch.int32)):
        with pytest.raises(ValueError, match="CUDA tensor"):
            strings_cuda.jaro_winkler_cuda(s, s, ln, ln)
        with pytest.raises(ValueError, match="CUDA tensor"):
            strings_cuda.levenshtein_cuda(s, s, ln, ln)
        before = dict(strings_cuda.launches), dict(strings_cuda.variant_launches)
        strings.jaro_winkler(s, s, ln, ln)
        strings.levenshtein(s, s, ln, ln)
        assert (strings_cuda.launches, strings_cuda.variant_launches) == before
