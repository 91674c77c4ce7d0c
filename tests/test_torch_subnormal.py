"""Sub-normal results are 0 in splink_tpu_torch, as in splink_tpu.

The reference's XLA programs run with flush-to-zero: a match probability or
an M-step quotient below the smallest normal number (``finfo.tiny``) is 0
there, in float32 and in float64, where PyTorch keeps the sub-normal. The
port flushes such results at every place the reference's program does
(``models.fellegi_sunter.flush_subnormal``). The frames here are built to
reach that band: five exact columns whose disagreement level has a tiny m,
set so that a pair that disagrees everywhere has a logit of -88.0 in float32
(sigmoid 6e-39, below FLT_MIN 1.18e-38) and -709.1 in float64 (sigmoid
1e-308, below DBL_MIN 2.2e-308). torch.sigmoid is sub-normal only in a
narrow band below the normal range, where exp(-x) has not overflowed
yet: (-88.7, -87.3) in float32, (-709.78, -708.4) in float64.

Held to the reference: the offline ``match_probability`` and
``tf_match_probability`` (0 exactly where the reference gives 0, elsewhere
within the port's 4-ulp bound in float32 and 1e-12 relative in float64);
EM's lambda, m and u after three updates from those parameters (zeros
equal; values within 1e-4 relative in float32, where the two packages' EM
trajectories part by ~1e-5 through XLA's long f32 sums, and 1e-9 in
float64); the M-step's update on its own, bit for bit; and the served
top-k (rows equal, probabilities under the offline bounds, served equal to
the port's offline frame bit for bit).
"""

import json
import warnings

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)
pd = pytest.importorskip("pandas")

import splink_tpu  # noqa: E402
import splink_tpu_torch  # noqa: E402

COLS = [f"c{k}" for k in range(5)]
# dtype -> (the logit of a pair that disagrees on every column,
# proportion_of_matches, the band of logits whose torch.sigmoid is
# sub-normal)
CASES = {
    "float32": (-88.0, 0.01, (-88.7, -87.4)),
    "float64": (-709.1, 1e-8, (-709.7, -708.5)),
}
U0 = 0.999  # u at the disagreement level
K = 64  # above the largest block: every offline pair is served


def frame(n=200, seed=3):
    rng = np.random.default_rng(seed)
    vals = np.array([f"v{i}" for i in range(6)] + [None], object)
    cols = {c: vals[rng.integers(0, len(vals), n)] for c in COLS}
    return pd.DataFrame({"unique_id": np.arange(n), "blk": rng.integers(0, 8, n), **cols})


def _m0(dtype):
    """m at the disagreement level that puts the all-disagree logit at its
    target: prior + 5 log(m0 / u0) = target."""
    target, lam, _ = CASES[dtype]
    prior = np.log(lam) - np.log1p(-lam)
    return float(U0 * np.exp((target - prior) / len(COLS)))


def settings(dtype, max_iterations=0):
    _, lam, _ = CASES[dtype]
    m0 = _m0(dtype)
    return {
        "link_type": "dedupe_only",
        "blocking_rules": ["l.blk = r.blk"],
        "proportion_of_matches": lam,
        "float64": dtype == "float64",
        "max_iterations": max_iterations,
        "comparison_columns": [
            {"col_name": c, "num_levels": 2, "comparison": {"kind": "exact"},
             "m_probabilities": [m0, 1 - m0], "u_probabilities": [U0, 1 - U0],
             "term_frequency_adjustments": c == "c0"}
            for c in COLS
        ],
    }


def _close(a, b, dtype):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    if dtype == "float32":
        ulp = np.spacing(np.maximum(np.abs(a), np.abs(b)).astype(np.float32))
        return np.abs(a - b) <= 4 * ulp.astype(np.float64)
    return np.abs(a - b) <= 1e-12 * np.maximum(np.abs(a), np.abs(b))


def _scored(dtype):
    s = settings(dtype)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        ref = splink_tpu.Splink(json.loads(json.dumps(s)), df=frame())
        port = splink_tpu_torch.Splink(json.loads(json.dumps(s)), df=frame(), device="cpu")
        r = ref.manually_apply_fellegi_sunter_weights()
        p = port.manually_apply_fellegi_sunter_weights()
    key = ["unique_id_l", "unique_id_r"]
    return (r.sort_values(key).reset_index(drop=True),
            p.sort_values(key).reset_index(drop=True), port)


def _logits(df_e, dtype):
    """The pairs' logits in float64 from their gamma columns."""
    _, lam, _ = CASES[dtype]
    m0 = _m0(dtype)
    z = np.full(len(df_e), np.log(lam) - np.log1p(-lam))
    for c in COLS:
        g = df_e[f"gamma_{c}"].to_numpy()
        z += np.where(g == 0, np.log(m0 / U0), np.where(g == 1, np.log((1 - m0) / (1 - U0)), 0))
    return z


@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_offline_probabilities_flush_as_the_reference(dtype):
    ref, port, _ = _scored(dtype)
    lo, hi = CASES[dtype][2]
    z = _logits(ref, dtype)
    in_band = (z > lo) & (z < hi)
    # the frame reaches the band where torch.sigmoid alone is sub-normal
    assert in_band.sum() > 100
    tiny = np.finfo(dtype).tiny
    raw = torch.sigmoid(torch.tensor(z[in_band], dtype=getattr(torch, dtype))).numpy()
    assert ((raw > 0) & (raw < tiny)).all()
    np.testing.assert_array_equal(ref["unique_id_l"], port["unique_id_l"])
    np.testing.assert_array_equal(ref["unique_id_r"], port["unique_id_r"])
    for col in ("match_probability", "tf_match_probability"):
        a, b = ref[col].to_numpy(), port[col].to_numpy()
        assert a.dtype == b.dtype == np.dtype(dtype)
        assert (a[in_band] == 0).all(), col
        np.testing.assert_array_equal(a == 0, b == 0, col)
        assert not ((b > 0) & (b < tiny)).any(), col
        assert _close(a, b, dtype).all(), col


@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_em_m_and_u_flush_as_the_reference(dtype):
    s = settings(dtype, max_iterations=3)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        ref = splink_tpu.Splink(json.loads(json.dumps(s)), df=frame())
        port = splink_tpu_torch.Splink(json.loads(json.dumps(s)), df=frame(), device="cpu")
        ref.estimate_parameters()
        port.estimate_parameters()
    rl, rm, ru, _ = ref.params.to_arrays(dtype=np.float64)
    pl, pm, pu, _ = port.params.to_arrays(dtype=np.float64)
    tiny = np.finfo(dtype).tiny
    for a, b in ((rm, pm), (ru, pu), (np.float64(rl), np.float64(pl))):
        np.testing.assert_array_equal(a == 0, b == 0)
        assert not ((np.abs(b) > 0) & (np.abs(b) < tiny)).any()
        np.testing.assert_allclose(b, a, rtol=1e-4 if dtype == "float32" else 1e-9, atol=0)


@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_m_step_quotient_flushes_as_the_reference(dtype):
    """update_params on statistics whose quotients fall below tiny: the
    reference's M-step gives 0 there, and so does the port's."""
    from splink_tpu.models import fellegi_sunter as ref_fs

    from splink_tpu_torch.models import fellegi_sunter as fs

    tiny = float(np.finfo(dtype).tiny)
    m_num = np.array([[tiny * 4, 1.0, 0.0], [tiny * 64, tiny, 2.0]], dtype)
    u_num = np.array([[1.0, tiny * 2, 3.0], [0.5, 0.25, tiny * 8]], dtype)
    m_den = np.array([1e6, 16.0], dtype)
    u_den = np.array([4.0, 1e9], dtype)
    sum_p, n_rows = np.array(tiny * 1e3, dtype), np.array(1e12, dtype)
    ref = ref_fs.update_params(ref_fs.SufficientStats(m_num, u_num, m_den, u_den, sum_p, n_rows))
    got = fs.update_params(fs.SufficientStats(*(torch.from_numpy(np.asarray(a)) for a in (
        m_num, u_num, m_den, u_den, sum_p, n_rows))))
    for a, b in zip(ref, got):
        a, b = np.asarray(a), b.numpy()
        assert (a == 0).any() or a.ndim == 0
        np.testing.assert_array_equal(a, b)


@pytest.fixture(scope="module")
def indexes(tmp_path_factory):
    """dtype -> (port's scored frame, reference index, port index), both
    packages' indexes built from the same parameters over the same frame."""
    out = {}
    for dtype in CASES:
        s = settings(dtype)
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            ref = splink_tpu.Splink(json.loads(json.dumps(s)), df=frame())
            port = splink_tpu_torch.Splink(json.loads(json.dumps(s)), df=frame(), device="cpu")
            df_e = port.manually_apply_fellegi_sunter_weights()
            out[dtype] = (df_e, ref.export_index(), port.export_index())
    return out


@pytest.mark.parametrize("tf", [True, False])
@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_served_top_k_flushes_as_the_reference(indexes, dtype, tf):
    from splink_tpu.serve import BucketPolicy as RefPolicy
    from splink_tpu.serve import QueryEngine as RefEngine

    from splink_tpu_torch.serve import BucketPolicy, QueryEngine

    df_e, ref_index, port_index = indexes[dtype]
    q = frame()
    rp, rr, rv, rn = RefEngine(ref_index, top_k=K, policy=RefPolicy((256,), (64,)),
                               tf_adjust=tf).query_arrays(q)
    gp, gr, gv, gn = QueryEngine(port_index, top_k=K, policy=BucketPolicy((256,), (64,)),
                                 tf_adjust=tf).query_arrays(q)
    assert np.array_equal(rv, gv) and np.array_equal(rn, gn)
    assert (rp[rv] == 0).sum() > 100
    np.testing.assert_array_equal(rp[rv] == 0, gp[gv] == 0)
    assert _close(rp[rv], gp[gv], dtype).all()
    # zero-tied candidates keep their slot order in both: equal top-k rows
    np.testing.assert_array_equal(rr[rv], gr[gv])
    # served equals the port's offline frame bit for bit
    col = "tf_match_probability" if tf else "match_probability"
    offline = {(a, b): p for a, b, p in zip(df_e["unique_id_l"], df_e["unique_id_r"], df_e[col])}
    for qi, r in zip(*np.nonzero(gv)):
        m = int(port_index.unique_id[gr[qi, r]])
        if m != qi:
            assert offline[(min(qi, m), max(qi, m))] == gp[qi, r]
