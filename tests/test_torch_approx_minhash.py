"""The minhash signatures of splink_tpu_torch.approx against splink_tpu's.

Seeded numpy columns (ascii and 32-bit codepoint characters, null rows of
length 0, values shorter than q) go through both packages' host functions;
the reference runs its jitted programs on JAX's CPU backend, the port its
tensor functions on the CPU. Held bit for bit: the unweighted band keys
and ``has_sig`` for q from 1 to 8 and several bands x rows, the hashed
gram document-frequency table, ``idf_weights``, ``factorise_band_codes``
and ``_null_oversize_buckets``, and the 32-bit helpers on their own.

The weighted keys race ``-log(u) / w`` across grams, and XLA's float32 log
is not the correctly rounded one the port takes (in float64, rounded
once), differing in the last ulp for some inputs. They are compared
lane by lane (one row per band, so a band key is a bijection of its lane);
every lane that parts is named and shown to have been decided by two race
values within 2 float32 ulp of each other.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from splink_tpu.approx import lsh as ref_lsh  # noqa: E402
from splink_tpu.approx import minhash as ref_mh  # noqa: E402

from splink_tpu_torch.approx import lsh, minhash  # noqa: E402


def _column(rng, n, width, wide):
    """(bytes, lengths): lengths 0..width (0 is a null row), a small
    alphabet so grams repeat across rows; codepoint columns mix ascii and
    characters up to U+10FFFF."""
    if wide:
        b = rng.integers(0, 0x110000, (n, width)).astype(np.uint32)
        b[:, ::2] = rng.integers(97, 100, (n, (width + 1) // 2))
    else:
        b = rng.integers(97, 101, (n, width)).astype(np.uint8)
    lengths = rng.integers(0, width + 1, n).astype(np.int32)
    lengths[rng.random(n) < 0.1] = 0
    for r in range(n):
        b[r, lengths[r]:] = 0
    return b, lengths


def _columns(seed, n=200):
    rng = np.random.default_rng(seed)
    return [_column(rng, n, 12, False), _column(rng, n, 9, True), _column(rng, n, 3, False)]


@pytest.mark.parametrize("q", range(1, 9))
def test_unweighted_band_keys_bit_identical(q):
    columns = _columns(q)
    for bands, rows in ((4, 1), (8, 2), (3, 3)):
        rk, rh = ref_mh.band_key_arrays(columns, q, bands, rows)
        pk, ph = minhash.band_key_arrays(columns, q, bands, rows, chunk=64, device="cpu")
        assert pk.dtype == rk.dtype == np.uint32
        np.testing.assert_array_equal(pk, rk)
        np.testing.assert_array_equal(ph, rh)
        # null and shorter-than-q rows in every column have no signature
        short = np.all([lens < q for _, lens in columns], axis=0)
        np.testing.assert_array_equal(ph, ~short)


def test_fold_hash_and_words_match_the_reference():
    """The gram words re-sliced to the reference's 32-bit words, their fold
    hash, and the 16-bit-half multiply, against the reference's uint32
    programs and Python's big integers."""
    import jax.numpy as jnp
    from splink_tpu.ops.qgram import _gram_codes as ref_codes

    from splink_tpu_torch.ops.qgram import _gram_codes

    rng = np.random.default_rng(0)
    x = rng.integers(0, 1 << 32, 1000, dtype=np.uint64)
    c = rng.integers(0, 1 << 32, 1000, dtype=np.uint64)
    got = minhash._mul32(torch.from_numpy(x.astype(np.int64)), torch.from_numpy(c.astype(np.int64)))
    assert got.tolist() == [(int(a) * int(b)) & 0xFFFFFFFF for a, b in zip(x, c)]
    for wide in (False, True):
        b, lens = _column(rng, 50, 11, wide)
        for q in range(1, 9):
            ref_words, _ = zip(*[ref_codes(jnp.asarray(b[r]), int(lens[r]), q) for r in range(50)])
            words, _ = _gram_codes(minhash._upload_chars(b, "cpu"), torch.from_numpy(lens), q)
            w32 = minhash._words32(words, 21 if wide else 8, q)
            want = np.stack([np.asarray(w) for w in ref_words])  # (50, windows, n_words)
            got = np.stack([w.numpy() for w in w32], axis=-1)
            np.testing.assert_array_equal(got, want.astype(np.int64))
            salt = 0x1234ABCD
            ref_h = np.stack([np.asarray(ref_mh._fold_gram_hash(jnp.asarray(w), jnp.uint32(salt)))
                              for w in ref_words])
            np.testing.assert_array_equal(minhash._fold_gram_hash(w32, salt).numpy(),
                                          ref_h.astype(np.int64))


@pytest.mark.parametrize("q", [1, 2, 3, 5, 8])
def test_df_table_and_idf_bit_identical(q):
    columns = _columns(10 + q, n=300)
    rc, rn = ref_mh.gram_df_table(columns, q)
    pc, pn = minhash.gram_df_table(columns, q, chunk=128, device="cpu")
    assert pc.dtype == np.int64 and pn == rn
    np.testing.assert_array_equal(pc, rc)
    assert pc.sum() > 0
    ri, pi = ref_mh.idf_weights(rc, rn), minhash.idf_weights(pc, pn)
    assert pi.dtype == np.float32
    np.testing.assert_array_equal(pi, ri)


def test_factorise_and_oversize_buckets_match_the_reference(monkeypatch):
    rng = np.random.default_rng(5)
    keys = rng.integers(0, 40, (500, 6)).astype(np.uint32)
    keys[:, 2] = 7  # one band of a single huge bucket
    has = rng.random(500) < 0.9
    rc, ru = ref_mh.factorise_band_codes(keys, has)
    pc, pu = minhash.factorise_band_codes(keys, has)
    np.testing.assert_array_equal(pc, rc)
    assert len(pu) == len(ru) and all(np.array_equal(a, b) for a, b in zip(pu, ru))
    no_sig = minhash.factorise_band_codes(keys, np.zeros(500, bool))
    assert (no_sig[0] == -1).all() and all(len(u) == 0 for u in no_sig[1])
    monkeypatch.setattr(ref_lsh, "MAX_BUCKET_ROWS", 14)
    monkeypatch.setattr(lsh, "MAX_BUCKET_ROWS", 14)
    r_codes, p_codes = rc.copy(), pc.copy()
    dropped = lsh._null_oversize_buckets(p_codes)
    assert dropped == ref_lsh._null_oversize_buckets(r_codes) and dropped > 1
    np.testing.assert_array_equal(p_codes, r_codes)


def _lane_sig(keys, lane_salts):
    """Invert the one-row band fold: the signature lane behind each key."""
    inv = pow(0x01000193, -1, 1 << 32)
    k = keys.astype(np.uint64) ^ lane_salts[None, :]
    k = k ^ (k >> np.uint64(16))
    return (((k * np.uint64(inv)) & np.uint64(0xFFFFFFFF)) ^ np.uint64(0x811C9DC5))


def _race_values(columns, q, row, lane, idf):
    """{gram hash: its float32 race value} for one record and lane, from
    the port's own functions (the reference's differ in the last ulp)."""
    a, b = minhash.hash_params(32)
    salts = minhash.column_salts(len(columns))
    out = {}
    for c, (bytes_, lengths) in enumerate(columns):
        h, valid = minhash._gram_hashes(minhash._upload_chars(bytes_[row:row + 1], "cpu"),
                                        torch.from_numpy(lengths[row:row + 1]), q, int(salts[c]))
        hk = (minhash._mul32(h, int(a[lane])) + int(b[lane])) & 0xFFFFFFFF
        hk = hk ^ (hk >> 13)
        hk = minhash._mul32(hk, 0x85EBCA6B)
        hk = hk ^ (hk >> 16)
        e = (minhash._neg_log_f32(hk) / torch.from_numpy(idf)[h >> 16]).numpy()[0]
        for hv, ev, ok in zip(h.numpy()[0], e, valid.numpy()[0]):
            if ok:
                out[int(hv)] = min(out.get(int(hv), np.inf), ev)
    return out


@pytest.mark.parametrize("q", [2, 3])
def test_weighted_keys_equal_except_near_ties(q):
    columns = _columns(20 + q, n=300)
    idf = ref_mh.idf_weights(*ref_mh.gram_df_table(columns, q))
    rk, rh = ref_mh.band_key_arrays(columns, q, 32, 1, idf=idf)
    pk, ph = minhash.band_key_arrays(columns, q, 32, 1, idf=idf, device="cpu")
    np.testing.assert_array_equal(ph, rh)
    salts = (np.arange(32, dtype=np.uint64) * np.uint64(0x9E3779B1)) & np.uint64(0xFFFFFFFF)
    r_sig, p_sig = _lane_sig(rk, salts), _lane_sig(pk, salts)
    # the inversion is right: a lane's signature is its race's winner
    for row in np.flatnonzero(ph)[:6]:
        for lane in (0, 9, 31):
            race = _race_values(columns, q, row, lane, idf)
            assert int(p_sig[row, lane]) == min(race, key=lambda h: (race[h], h))
    parted = np.argwhere(r_sig != p_sig)
    assert len(parted) <= 0.01 * rk.size
    for row, lane in parted:
        race = _race_values(columns, q, row, lane, idf)
        er, ep = race[int(r_sig[row, lane])], race[int(p_sig[row, lane])]
        ulp = np.spacing(np.float32(max(er, ep)))
        assert abs(float(er) - float(ep)) <= 2 * ulp, (row, lane, er, ep)
    # the weighted sampler samples differently from the unweighted one
    uk, _ = minhash.band_key_arrays(columns, q, 32, 1, device="cpu")
    assert not np.array_equal(uk, pk)
