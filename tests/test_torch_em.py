"""Fellegi-Sunter math and EM of splink_tpu_torch against splink_tpu.

The oracles of tests/test_em.py (hand-calculated step, null exclusion,
multi-iteration numpy EM, known-DGP recovery, padding weights,
max_iterations = 0, the convergence threshold) run through the port, and
every EM run is held against the JAX ``run_em`` on the same inputs: equal
update counts, parameters within 1e-12 at f64 and within 1e-5 of the f64
trajectory at f32 (``_both`` has the details: XLA's and PyTorch's log
differ in the last ulp and the M-step sums pairs in another order).

``fold_logit`` must be bit-identical and ``match_probability`` within 4 ulp
at f32 given the same log tables: for a sizeable share of f32 inputs (and a
few f64 ones) XLA's ``log`` and PyTorch's differ in the last ulp, so those
tests draw their
probabilities from values whose logs agree in both — what they pin is the
order of the float operations, which is the port's to get right.
"""

import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")
# tier-1 runs several pytest workers on the cores; one intra-op thread each
# keeps them from oversubscribing the CPU
torch.set_num_threads(1)

from splink_tpu.em import run_em as ref_run_em  # noqa: E402
from splink_tpu.models import fellegi_sunter as ref_fs  # noqa: E402
from splink_tpu_torch import em  # noqa: E402
from splink_tpu_torch.models import fellegi_sunter as fs  # noqa: E402
from splink_tpu_torch.params import fsparams_from_numpy, fsparams_to_numpy  # noqa: E402

from test_em import _pack, numpy_em_step  # noqa: E402


def _ref_em(G, lam, m, u, dtype, weights, **kw):
    as_j = lambda a: jnp.asarray(np.asarray(a, dtype))  # noqa: E731
    return ref_run_em(
        jnp.asarray(G), ref_fs.FSParams(as_j(lam), as_j(m), as_j(u)),
        weights=None if weights is None else as_j(weights), **kw,
    )


def _both(G, lam, m, u, dtype, weights=None, **kw):
    """Run JAX and torch EM on the same inputs; assert they agree.

    f64: equal update counts, parameters within 1e-12 of the reference.
    f32: equal update counts with the reference's f32 run, and parameters
    within 1e-5 of the reference's f64 run over as many updates, and no
    further from it than the reference's own f32 run. That run is the
    less accurate one (XLA sums the pairs in f32 in one long chain; it
    misses the f64 trajectory by more than 1e-5 in
    test_multi_iteration_matches_oracle and test_known_dgp_parameter_recovery),
    so it is no yardstick at 1e-5."""
    ref = _ref_em(G, lam, m, u, dtype, weights, **kw)
    as_t = lambda a: torch.from_numpy(np.asarray(a, dtype))  # noqa: E731
    got = em.run_em(
        torch.from_numpy(G),
        fsparams_from_numpy(np.asarray(lam, dtype), as_t(m), as_t(u), device="cpu"),
        weights=None if weights is None else as_t(weights), **kw,
    )
    assert got.n_updates == int(ref.n_updates)
    assert got.converged == bool(ref.converged)
    lam_g, m_g, u_g = fsparams_to_numpy(got.params)
    assert lam_g.dtype == dtype
    want, tol = ref, 1e-12
    if dtype == np.float32:
        f64_kw = dict(kw, max_iterations=got.n_updates, em_convergence=0.0)
        want, tol = _ref_em(G, lam, m, u, np.float64, weights, **f64_kw), 1e-5
        err = lambda a, b: np.abs(np.asarray(a, np.float64) - np.asarray(b)).max()  # noqa: E731
        for field in ("lam", "m", "u"):
            exact = getattr(want.params, field)
            assert err(getattr(got.params, field).numpy(), exact) <= max(
                err(getattr(ref.params, field), exact), 1e-6
            ), field
    np.testing.assert_allclose(lam_g, np.asarray(want.params.lam), rtol=0, atol=tol)
    np.testing.assert_allclose(m_g, np.asarray(want.params.m), rtol=0, atol=tol)
    np.testing.assert_allclose(u_g, np.asarray(want.params.u), rtol=0, atol=tol)
    if kw.get("compute_ll"):
        n = got.n_updates
        np.testing.assert_allclose(
            got.ll_history[: n + 1], np.asarray(want.ll_history)[: n + 1],
            rtol=1e-9 if dtype == np.float64 else 1e-5,
        )
    return got


DTYPES = pytest.mark.parametrize("dtype", [np.float64, np.float32], ids=["f64", "f32"])


@DTYPES
def test_single_step_matches_hand_calculation(dtype):
    G = np.array([[1, 1], [1, 0], [0, 1], [0, 0], [-1, 1]], np.int8)
    m = [np.array([0.1, 0.9]), np.array([0.2, 0.8])]
    u = [np.array([0.8, 0.2]), np.array([0.7, 0.3])]
    params = fsparams_from_numpy(0.5, _pack(m, 2).astype(dtype), _pack(u, 2).astype(dtype),
                                 device="cpu")
    p = fs.match_probability(torch.from_numpy(G), params).numpy()
    rel = 1e-12 if dtype == np.float64 else 1e-6
    assert p[0] == pytest.approx(0.72 / 0.78, rel=rel)
    assert p[4] == pytest.approx(0.4 / 0.55, rel=rel)
    p_oracle, new_lam, new_m, new_u = numpy_em_step(G, 0.5, m, u)
    np.testing.assert_allclose(p, p_oracle, rtol=rel)
    new = fs.update_params(fs.sufficient_stats(torch.from_numpy(G), torch.from_numpy(p_oracle.astype(dtype)), 2))
    assert float(new.lam) == pytest.approx(new_lam, rel=rel)
    np.testing.assert_allclose(new.m.numpy(), _pack(new_m, 2), rtol=rel * 100)
    np.testing.assert_allclose(new.u.numpy(), _pack(new_u, 2), rtol=rel * 100)
    _both(G, 0.5, _pack(m, 2), _pack(u, 2), dtype, max_iterations=1, max_levels=2,
          em_convergence=1e-300)


def test_null_exclusion_from_normaliser():
    G = np.array([[1, -1], [0, 1], [1, 0]], np.int8)
    m = [np.array([0.2, 0.8]), np.array([0.4, 0.6])]
    u = [np.array([0.9, 0.1]), np.array([0.6, 0.4])]
    p_oracle, _, new_m, new_u = numpy_em_step(G, 0.3, m, u)
    params = fsparams_from_numpy(0.3, _pack(m, 2), _pack(u, 2), device="cpu")
    p = fs.match_probability(torch.from_numpy(G), params)
    new = fs.update_params(fs.sufficient_stats(torch.from_numpy(G), p, 2))
    np.testing.assert_allclose(new.m.numpy(), _pack(new_m, 2), rtol=1e-10)
    np.testing.assert_allclose(new.u.numpy(), _pack(new_u, 2), rtol=1e-10)
    assert float(new.lam) == pytest.approx(float(p.sum()) / 3, rel=1e-12)


@DTYPES
def test_multi_iteration_matches_oracle(dtype):
    rng = np.random.default_rng(7)
    n = 5000
    G = np.stack(
        [rng.integers(0, 2, n), rng.integers(0, 3, n), rng.integers(0, 2, n)], axis=1
    ).astype(np.int8)
    G[rng.random(n) < 0.1, 0] = -1
    m = [np.array([0.3, 0.7]), np.array([0.2, 0.3, 0.5]), np.array([0.4, 0.6])]
    u = [np.array([0.7, 0.3]), np.array([0.5, 0.3, 0.2]), np.array([0.6, 0.4])]
    lam_o, m_o, u_o = 0.3, [d.copy() for d in m], [d.copy() for d in u]
    for _ in range(5):
        _, lam_o, m_o, u_o = numpy_em_step(G, lam_o, m_o, u_o)
    res = _both(G, 0.3, _pack(m, 3), _pack(u, 3), dtype, max_iterations=5,
                max_levels=3, em_convergence=1e-300)
    assert res.n_updates == 5
    atol = 1e-9 if dtype == np.float64 else 1e-5
    assert float(res.params.lam) == pytest.approx(lam_o, abs=atol)
    np.testing.assert_allclose(res.params.m.numpy(), _pack(m_o, 3), atol=atol)
    np.testing.assert_allclose(res.params.u.numpy(), _pack(u_o, 3), atol=atol)
    assert res.lam_history[0] == pytest.approx(0.3)


@DTYPES
def test_known_dgp_parameter_recovery(dtype):
    rng = np.random.default_rng(0)
    lam_true = 0.25
    m = np.array([[0.1, 0.9, 0.0], [0.2, 0.1, 0.7], [0.05, 0.95, 0.0], [0.3, 0.7, 0.0]])
    u = np.array([[0.8, 0.2, 0.0], [0.7, 0.2, 0.1], [0.9, 0.1, 0.0], [0.8, 0.2, 0.0]])
    n = 100_000
    is_match = rng.random(n) < lam_true
    G = np.zeros((n, 4), np.int8)
    for c in range(4):
        probs = np.where(is_match[:, None], m[c], u[c])
        G[:, c] = (rng.random(n)[:, None] > probs.cumsum(1)).sum(1)
    m0 = np.array([[0.4, 0.6, 0], [0.2, 0.3, 0.5], [0.4, 0.6, 0], [0.4, 0.6, 0]])
    u0 = np.array([[0.6, 0.4, 0], [0.5, 0.3, 0.2], [0.6, 0.4, 0], [0.6, 0.4, 0]])
    # f32: a threshold clear of the reference's f32 summation noise, which
    # makes its per-update deltas jitter near 1e-4
    res = _both(G, 0.5, m0, u0, dtype, max_iterations=60, max_levels=3,
                em_convergence=1e-6 if dtype == np.float64 else 2e-3, compute_ll=True)
    assert res.converged and res.n_updates < 60
    tol = 0.01 if dtype == np.float64 else 0.02  # 15 updates at f32
    assert abs(float(res.params.lam) - lam_true) < tol
    assert np.abs(res.params.m.numpy() - m).max() < tol
    assert np.abs(res.params.u.numpy() - u).max() < tol
    ll = res.ll_history[: res.n_updates + 1]
    assert np.all(np.diff(ll) > -1e-2)


def test_padding_weights_do_not_affect_results():
    rng = np.random.default_rng(3)
    n = 1000
    G = rng.integers(0, 2, (n, 2)).astype(np.int8)
    m0 = np.array([[0.3, 0.7], [0.2, 0.8]])
    u0 = np.array([[0.7, 0.3], [0.8, 0.2]])
    plain = _both(G, 0.3, m0, u0, np.float64, max_iterations=4, max_levels=2, em_convergence=0.0)
    G_pad = np.concatenate([G, np.full((536, 2), 1, np.int8)])
    w = np.concatenate([np.ones(n), np.zeros(536)])
    pad = _both(G_pad, 0.3, m0, u0, np.float64, weights=w, max_iterations=4,
                max_levels=2, em_convergence=0.0)
    assert float(pad.params.lam) == pytest.approx(float(plain.params.lam), rel=1e-12)
    np.testing.assert_allclose(pad.params.m.numpy(), plain.params.m.numpy(), rtol=1e-12)


def test_zero_max_iterations_scores_without_em():
    G = np.array([[1, 1], [0, 0]], np.int8)
    m = np.array([[0.1, 0.9], [0.2, 0.8]])
    u = np.array([[0.8, 0.2], [0.7, 0.3]])
    res = _both(G, 0.5, m, u, np.float64, max_iterations=0, max_levels=2, em_convergence=1e-4)
    assert res.n_updates == 0
    p = em.score_pairs(torch.from_numpy(G), res.params).numpy()
    assert p[0] == pytest.approx(0.72 / 0.78)


def test_score_intermediates_null_gives_one():
    G = torch.tensor([[-1, 1]], dtype=torch.int8)
    params = fsparams_from_numpy(0.5, [[0.1, 0.9], [0.2, 0.8]], [[0.8, 0.2], [0.7, 0.3]],
                                 device="cpu")
    p, pm, pu = em.score_pairs_with_intermediates(G, params)
    assert float(pm[0, 0]) == 1.0 and float(pu[0, 0]) == 1.0
    assert float(pm[0, 1]) == pytest.approx(0.8)


def test_em_convergence_threshold_honoured():
    import pandas as pd

    from splink_tpu import Splink as RefSplink
    from splink_tpu_torch import Splink

    rng = np.random.default_rng(6)
    n = 300
    df = pd.DataFrame({
        "unique_id": np.arange(n),
        "name": rng.choice([f"n{i}" for i in range(30)], n),
        "city": rng.choice(["x", "y"], n),
    })
    base = {
        "link_type": "dedupe_only",
        "blocking_rules": ["l.city = r.city"],
        "comparison_columns": [{"col_name": "name", "comparison": {"kind": "exact"}}],
        "max_iterations": 30,
    }
    hist = {}
    for conv in (0.01, 1e-12):
        loose = Splink({**base, "em_convergence": conv}, df=df, device="cpu")
        loose.get_scored_comparisons()
        ref = RefSplink({**base, "em_convergence": conv}, df=df)
        ref.get_scored_comparisons()
        hist[conv] = len(loose.params.param_history)
        assert hist[conv] == len(ref.params.param_history)
    assert hist[0.01] < hist[1e-12]


# ----------------------------------------------------------------------
# Float-order pins: fold_logit bit-identical, match_probability <= 4 ulp
# ----------------------------------------------------------------------


def _log_agreeing_pool(rng, dtype, k=20000):
    cand = rng.random(k).astype(dtype)
    same = lambda x: np.asarray(jnp.log(jnp.asarray(x))) == torch.log(torch.from_numpy(x)).numpy()  # noqa: E731
    return cand[same(cand) & same(1 - cand)]


def _params_pair(rng, dtype, C=5, L=3):
    pool = _log_agreeing_pool(rng, dtype)
    m, u = rng.choice(pool, (C, L)), rng.choice(pool, (C, L))
    lam = rng.choice(pool[pool < 0.3])
    ref = ref_fs.FSParams(jnp.asarray(lam), jnp.asarray(m), jnp.asarray(u))
    return ref, fsparams_from_numpy(lam, m, u, device="cpu")


@DTYPES
def test_fold_logit_bit_identical(dtype):
    rng = np.random.default_rng(31)
    G = rng.integers(-1, 3, (50_000, 5)).astype(np.int8)
    ref_p, got_p = _params_pair(rng, dtype)
    want = np.asarray(ref_fs.fold_logit(jnp.asarray(G), ref_p))
    got = fs.fold_logit(torch.from_numpy(G), got_p).numpy()
    assert got.dtype == want.dtype == dtype
    np.testing.assert_array_equal(got, want)
    # and the logit match_probability takes the sigmoid of
    np.testing.assert_array_equal(
        fs.match_logit(torch.from_numpy(G), got_p).numpy(),
        np.asarray(ref_fs.match_logit(jnp.asarray(G), ref_p)),
    )


def test_match_probability_within_4_ulp_f32():
    rng = np.random.default_rng(32)
    G = rng.integers(-1, 3, (50_000, 5)).astype(np.int8)
    ref_p, got_p = _params_pair(rng, np.float32)
    want = np.asarray(ref_fs.match_probability(jnp.asarray(G), ref_p))
    got = fs.match_probability(torch.from_numpy(G), got_p).numpy()
    ulps = np.abs(got.view(np.int32).astype(np.int64) - want.view(np.int32).astype(np.int64))
    assert ulps.max() <= 4


def test_em_step_matches_reference():
    rng = np.random.default_rng(33)
    G = rng.integers(-1, 3, (20_000, 4)).astype(np.int8)
    m = rng.random((4, 3))
    u = rng.random((4, 3))
    new_r, delta_r = ref_fs.em_step(
        jnp.asarray(G), ref_fs.FSParams(jnp.asarray(0.2), jnp.asarray(m), jnp.asarray(u)), 3
    )
    new_g, delta_g = fs.em_step(torch.from_numpy(G),
                                fsparams_from_numpy(0.2, m, u, device="cpu"), 3)
    np.testing.assert_allclose(new_g.m.numpy(), np.asarray(new_r.m), rtol=0, atol=1e-12)
    np.testing.assert_allclose(new_g.u.numpy(), np.asarray(new_r.u), rtol=0, atol=1e-12)
    assert float(delta_g) == pytest.approx(float(delta_r), abs=1e-12)


def test_fsparams_numpy_roundtrip():
    lam, m, u = np.float32(0.1), np.ones((2, 3), np.float32) / 3, np.ones((2, 3), np.float32) / 3
    p = fsparams_from_numpy(lam, m, u, device="cpu")
    assert p.m.dtype == torch.float32
    back = fsparams_to_numpy(p)
    np.testing.assert_array_equal(back[1], m)
    p64 = fsparams_from_numpy(lam, m, u, dtype=torch.float64, device="cpu")
    assert p64.u.dtype == torch.float64
