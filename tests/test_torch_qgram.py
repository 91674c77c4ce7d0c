"""The q-gram and charset functions of splink_tpu_torch against splink_tpu's.

The same seeded strings, encoded by splink_tpu, go through
splink_tpu.ops.qgram (jnp, vmapped over pairs, on the CPU) and
splink_tpu_torch.ops.qgram (plain tensor ops over the batch). Tolerance:
none — q-gram Jaccard, cosine distance and charset Jaccard are
bit-identical (``np.testing.assert_array_equal`` on float32), for q in
{2, 3, 4} (and 6 on codepoints), on uint8 and wide-unicode columns, in the
self-contained and the masked (per-row aux) forms, and across a mask of more
than 32 windows. The per-row aux, copied from splink_tpu, must be equal
array for array. The jar's golden vectors pass as splink_tpu's own test
holds them (tests/test_jar_similarity.py): charset Jaccard exact except at
exact .005 ties (± 0.01), cosine within 2e-6 on word inputs.
"""

import json
import os
import re

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# tier-1 runs several pytest workers on the cores; one intra-op thread each
# keeps them from oversubscribing the CPU
torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402

from splink_tpu.data import encode_string_column  # noqa: E402
from splink_tpu.ops import qgram as ref_qgram  # noqa: E402
from splink_tpu_torch.ops import qgram  # noqa: E402

VEC_PATH = os.path.join(os.path.dirname(__file__), "data", "jar_similarity_vectors.json")
with open(VEC_PATH) as fh:
    VECTORS = json.load(fh)

ASCII_POOL = ["", "a", "ab", "aab", "abab", "aaaa", "abcabcabc", "bbbbbbbb", "abba",
              "baab", "bob smith", "bobsmith", "  lead", "ab ba", "aaaa  bbbb",
              "the quick brown fox", None]
WIDE_POOL = ["αβγαβ", "βγαβγ", "ααα", "αβ", "日本語語語", "日本語ですから", "日本語ですので",
             "héllo", "hallo", "zoë", "", None]


def _strings(seed, pool, alphabet, n, width):
    rng = np.random.default_rng(seed)
    pool = list(pool) + ["".join(rng.choice(list(alphabet), rng.integers(1, width + 1)))
                         for _ in range(60)]
    return (rng.choice(np.array(pool, object), n), rng.choice(np.array(pool, object), n))


def _encode(left, right, width):
    """Both sides encoded by splink_tpu and padded to one width: numpy
    chars (uint8 or uint32), lengths and the columns (for the aux)."""
    ca = encode_string_column(left, width=width)
    cb = encode_string_column(right, width=width)
    w = max(ca.bytes_.shape[1], cb.bytes_.shape[1])
    pad = lambda a: np.pad(a, ((0, 0), (0, w - a.shape[1])))  # noqa: E731
    return pad(ca.bytes_), pad(cb.bytes_), ca, cb


def _t(a):
    """numpy -> torch on the CPU; uint32 codepoints as the port's int32."""
    a = np.ascontiguousarray(a)
    if a.dtype == np.uint32:
        a = a.view(np.int32)
    return torch.from_numpy(a)


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


CASES = [("u8", q) for q in (2, 3, 4)] + [("wide", q) for q in (2, 3, 4, 6)]


@pytest.fixture(scope="module", params=[c for c in CASES], ids=[f"{k}-q{q}" for k, q in CASES])
def encoded(request):
    kind, q = request.param
    if kind == "u8":
        left, right = _strings(7 + q, ASCII_POOL, "abc ", 300, 20)
    else:
        left, right = _strings(11 + q, WIDE_POOL, "αβγ日本", 300, 12)
    s1, s2, ca, cb = _encode(left, right, 24)
    assert (s1.dtype == np.uint8) == (kind == "u8")
    return q, s1, s2, ca, cb


def test_qgram_functions_bit_identical(encoded):
    q, s1, s2, ca, cb = encoded
    ref_args = [jnp.asarray(a) for a in (s1, s2, ca.lengths, cb.lengths)]
    args = [_t(a) for a in (s1, s2, ca.lengths, cb.lengths)]
    for name in ("qgram_jaccard", "qgram_cosine_distance"):
        want = _np(getattr(ref_qgram, name)(*ref_args, q))
        got = _np(getattr(qgram, name)(*args, q))
        assert got.dtype == want.dtype == np.float32, name
        np.testing.assert_array_equal(got, want, err_msg=name)


def test_masked_qgram_functions_bit_identical(encoded):
    q, s1, s2, ca, cb = encoded
    aux_a = ref_qgram.qgram_row_aux(ca.bytes_, ca.lengths, ca.token_ids, q)
    aux_b = ref_qgram.qgram_row_aux(cb.bytes_, cb.lengths, cb.token_ids, q)
    for got, want in zip(qgram.qgram_row_aux(ca.bytes_, ca.lengths, ca.token_ids, q), aux_a):
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)
    (ma, na, xa), (_, nb, xb) = aux_a, aux_b
    ref = [jnp.asarray(a) for a in (s1, s2, ca.lengths, cb.lengths)]
    port = [_t(a) for a in (s1, s2, ca.lengths, cb.lengths)]
    want_j = _np(ref_qgram.qgram_jaccard_masked(
        *ref, jnp.asarray(ma), jnp.asarray(na), jnp.asarray(nb), q))
    got_j = _np(qgram.qgram_jaccard_masked(*port, _t(ma), _t(na), _t(nb), q))
    np.testing.assert_array_equal(got_j, want_j)
    np.testing.assert_array_equal(got_j, _np(qgram.qgram_jaccard(*port, q)))
    want_c = _np(ref_qgram.qgram_cosine_masked(*ref, jnp.asarray(xa), jnp.asarray(xb), q))
    got_c = _np(qgram.qgram_cosine_masked(*port, _t(xa), _t(xb), q))
    np.testing.assert_array_equal(got_c, want_c)
    np.testing.assert_array_equal(got_c, _np(qgram.qgram_cosine_distance(*port, q)))


@pytest.mark.parametrize("q", [None, 2, 3])
@pytest.mark.parametrize("kind", ["u8", "wide"])
def test_charset_jaccard_bit_identical(kind, q):
    if kind == "u8":
        left, right = _strings(23, ASCII_POOL, "abc ", 300, 14)
    else:
        left, right = _strings(29, WIDE_POOL, "αβ γ", 300, 10)
    s1, s2, ca, cb = _encode(left, right, 24)
    ref = [jnp.asarray(a) for a in (s1, s2, ca.lengths, cb.lengths)]
    port = [_t(a) for a in (s1, s2, ca.lengths, cb.lengths)]
    want = _np(ref_qgram.charset_jaccard(*ref, q))
    np.testing.assert_array_equal(_np(qgram.charset_jaccard(*port, q)), want)
    aux_a = ref_qgram.charset_row_aux(ca.bytes_, ca.lengths, ca.token_ids)
    for got, w in zip(qgram.charset_row_aux(ca.bytes_, ca.lengths, ca.token_ids), aux_a):
        assert got.dtype == w.dtype
        np.testing.assert_array_equal(got, w)
    (ma, da, sa) = aux_a
    _, db, sb = ref_qgram.charset_row_aux(cb.bytes_, cb.lengths, cb.token_ids)
    want_m = _np(ref_qgram.charset_jaccard_masked(
        *ref, *(jnp.asarray(a) for a in (ma, da, sa, db, sb)), q))
    got_m = _np(qgram.charset_jaccard_masked(*port, *(_t(a) for a in (ma, da, sa, db, sb)), q))
    np.testing.assert_array_equal(got_m, want_m)
    np.testing.assert_array_equal(got_m, want)


def test_multi_lane_mask_over_32_windows():
    """Width 48, q = 2: 47 windows, two mask lanes; the bit read across the
    lane boundary (and bit 31, the int32 sign bit) must match."""
    rng = np.random.default_rng(5)
    strings = ["".join(rng.choice(list("abc"), rng.integers(30, 48))) for _ in range(60)]
    strings += ["", "a" * 47, "ab" * 23, None, "abcdefghijklmnopqrstuvwxyzABCDEFGHIJKLMNOPQRSTUV"]
    col = encode_string_column(np.array(strings, object), width=48)
    q = 2
    assert col.width - q + 1 > 32
    mask, count, sumsq = ref_qgram.qgram_row_aux(col.bytes_, col.lengths, col.token_ids, q)
    assert mask.shape[1] == 2 and (mask[:, 0] >> 31).any()
    il, ir = rng.integers(0, len(strings), 200), rng.integers(0, len(strings), 200)
    s, ln = col.bytes_, col.lengths
    ref = [jnp.asarray(a) for a in (s[il], s[ir], ln[il], ln[ir])]
    port = [_t(a) for a in (s[il], s[ir], ln[il], ln[ir])]
    want = _np(ref_qgram.qgram_jaccard_masked(
        *ref, jnp.asarray(mask[il]), jnp.asarray(count[il]), jnp.asarray(count[ir]), q))
    got = _np(qgram.qgram_jaccard_masked(*port, _t(mask[il]), _t(count[il]), _t(count[ir]), q))
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, _np(qgram.qgram_jaccard(*port, q)))
    np.testing.assert_array_equal(
        _np(qgram.qgram_cosine_masked(*port, _t(sumsq[il]), _t(sumsq[ir]), q)),
        _np(ref_qgram.qgram_cosine_distance(*ref, q)))
    cm, cc, cs = qgram.charset_row_aux(col.bytes_, col.lengths, col.token_ids)
    np.testing.assert_array_equal(
        _np(qgram.charset_jaccard_masked(*port, _t(cm[il]), _t(cc[il]), _t(cs[il]),
                                         _t(cc[ir]), _t(cs[ir]), 2)),
        _np(ref_qgram.charset_jaccard(*ref, 2)))


def test_qgram_tokenise_equal():
    for v in ("", "a", "abc", "日本語です", None):
        for q in (2, 3):
            assert qgram.qgram_tokenise(v, q) == ref_qgram.qgram_tokenise(v, q)


# ----------------------------------------------------------------------
# The jar's golden vectors (tests/data/jar_similarity_vectors.json)
# ----------------------------------------------------------------------


def _golden_pairs():
    a = encode_string_column([v["a"] for v in VECTORS], width=32)
    b = encode_string_column([v["b"] for v in VECTORS], width=32)
    w = max(a.bytes_.shape[1], b.bytes_.shape[1])
    pad = lambda x: np.pad(x, ((0, 0), (0, w - x.shape[1])))  # noqa: E731
    return pad(a.bytes_), pad(b.bytes_), a.lengths, b.lengths


def _charset_iu(a, b, q):
    sa, sb = set(a), set(b)
    if q is not None:
        sa = sa | {" "} if len(a) > q else sa
        sb = sb | {" "} if len(b) > q else sb
    return len(sa & sb), max(len(sa | sb), 1)


@pytest.mark.parametrize("q,field", [(None, "jaccard"), (2, "jaccard_q2")])
def test_charset_jaccard_matches_jar_golden_vectors(q, field):
    s1, s2, l1, l2 = _golden_pairs()
    got = _np(qgram.charset_jaccard(_t(s1), _t(s2), _t(l1), _t(l2), q))
    want = _np(ref_qgram.charset_jaccard(*(jnp.asarray(a) for a in (s1, s2, l1, l2)), q))
    np.testing.assert_array_equal(got, want)
    jar = np.array([v[field] for v in VECTORS])
    for k, v in enumerate(VECTORS):
        i, u = _charset_iu(v["a"], v["b"], q)
        tol = 0.0101 if (200 * i) % (2 * u) == u else 1e-6
        assert abs(float(got[k]) - jar[k]) < tol, (v, float(got[k]), jar[k])


def test_qgram_cosine_matches_jar_golden_vectors_on_word_inputs():
    s1, s2, l1, l2 = _golden_pairs()
    idx = np.array([i for i, v in enumerate(VECTORS)
                    if v["cosine_q2"] is not None
                    and re.fullmatch(r"\w+", v["a"], re.ASCII)
                    and re.fullmatch(r"\w+", v["b"], re.ASCII)
                    and len(v["a"]) >= 2 and len(v["b"]) >= 2])
    assert len(idx) > 300
    got = _np(qgram.qgram_cosine_distance(_t(s1[idx]), _t(s2[idx]), _t(l1[idx]),
                                          _t(l2[idx]), 2))
    jar = np.array([VECTORS[i]["cosine_q2"] for i in idx])
    assert np.abs(got.astype(np.float64) - jar).max() < 2e-6
