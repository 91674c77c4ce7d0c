"""splink_tpu_torch's one-axis ``data`` mesh against splink_tpu's, on the
same seeded inputs: the port's counterpart of tests/test_sharding.py.

The reference runs on its 8-device CPU mesh (the forced host devices of
tests/conftest.py); the port's CPU mesh puts every shard on the one CPU
device, with the visible count 8. Held: the mesh settings' rules and
messages; shard_pairs' padding semantics on 2-, 4- and 8-way meshes; sharded
EM, resident and streamed, against the port's unsharded EM and the
reference's sharded EM (float64, rtol 1e-12; padding moves no bit); the
facade under ``{"data": 8}`` and ``{"data": 1}`` against the unsharded
facade and the reference's sharded one (params and ``match_probability``
rtol 1e-12); the mesh pattern passes (materialised and virtual) array for
array against the reference's mesh passes; sharded emission (pairs, bins,
manifests and digests) against the reference's; and the kernel launcher
entering the inputs' CUDA device.
"""

import copy
import json
import os
import warnings

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)
pd = pytest.importorskip("pandas")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import splink_tpu  # noqa: E402
import splink_tpu_torch  # noqa: E402
from splink_tpu import blocking_device as ref_bd  # noqa: E402
from splink_tpu import em as ref_em  # noqa: E402
from splink_tpu import pairgen as ref_pairgen  # noqa: E402
from splink_tpu import spill as ref_spill  # noqa: E402
from splink_tpu.data import encode_table as ref_encode  # noqa: E402
from splink_tpu.gammas import GammaProgram as RefGammaProgram  # noqa: E402
from splink_tpu.models.fellegi_sunter import FSParams as RefFSParams  # noqa: E402
from splink_tpu.parallel import make_mesh as ref_make_mesh  # noqa: E402
from splink_tpu.parallel import run_em_streamed as ref_run_em_streamed  # noqa: E402
from splink_tpu.parallel import shard_pairs as ref_shard_pairs  # noqa: E402
from splink_tpu.settings import complete_settings_dict as ref_complete  # noqa: E402
from splink_tpu_torch import blocking_device, pairgen  # noqa: E402
from splink_tpu_torch.blocking import block_using_rules  # noqa: E402
from splink_tpu_torch.data import encode_table  # noqa: E402
from splink_tpu_torch.em import run_em  # noqa: E402
from splink_tpu_torch.gammas import GammaProgram  # noqa: E402
from splink_tpu_torch.models.fellegi_sunter import FSParams  # noqa: E402
from splink_tpu_torch.ops import strings_cuda  # noqa: E402
from splink_tpu_torch.parallel import (  # noqa: E402
    make_mesh,
    mesh_from_settings,
    run_em_streamed,
    shard_pairs,
)
from splink_tpu_torch.parallel.mesh import CPU_VISIBLE_DEVICES, pair_sharding  # noqa: E402
from splink_tpu_torch.parallel.streaming import _batch_stats  # noqa: E402
from splink_tpu_torch.settings import complete_settings_dict  # noqa: E402
from splink_tpu_torch.spill import MANIFEST_NAME, PairSpillStore  # noqa: E402

RTOL = 1e-12


def _mesh(n=None):
    return make_mesh(n, device="cpu")


def _dgp(n, seed=0):
    """The reference test's data: three 2-level columns from a known
    lambda/m/u, and a slightly asymmetric start."""
    rng = np.random.default_rng(seed)
    m = np.array([[0.1, 0.9], [0.2, 0.8], [0.3, 0.7]])
    u = np.array([[0.85, 0.15], [0.7, 0.3], [0.6, 0.4]])
    is_match = rng.random(n) < 0.3
    G = np.zeros((n, 3), np.int8)
    for c in range(3):
        probs = np.where(is_match[:, None], m[c], u[c])
        G[:, c] = (rng.random(n)[:, None] > probs.cumsum(1)).sum(1)
    return G, (0.5, np.tile([0.4, 0.6], (3, 1)), np.tile([0.6, 0.4], (3, 1)))


def _port_params(lam, m, u):
    return FSParams(torch.tensor(lam, dtype=torch.float64), torch.tensor(m), torch.tensor(u))


def _ref_params(lam, m, u):
    return RefFSParams(lam=jnp.asarray(lam, jnp.float64), m=jnp.asarray(m), u=jnp.asarray(u))


def _close(have, want, rtol=RTOL):
    np.testing.assert_allclose(np.asarray(have, np.float64), np.asarray(want, np.float64),
                               rtol=rtol, atol=0)


# --------------------------------------------------------------------------
# The mesh settings
# --------------------------------------------------------------------------


def test_cpu_mesh_has_the_reference_tiers_device_count():
    assert len(jax.devices()) == CPU_VISIBLE_DEVICES == 8
    assert _mesh().size == 8 and set(_mesh().devices) == {torch.device("cpu")}


def test_mesh_from_settings():
    assert mesh_from_settings({"mesh": {}}, "cpu") is None
    assert mesh_from_settings({}, "cpu") is None
    assert mesh_from_settings({"mesh": {"data": 8}}, "cpu").size == 8
    # {"data": 1} is a REAL one-device mesh, not the empty dict's unsharded path
    one = mesh_from_settings({"mesh": {"data": 1}}, "cpu")
    assert one is not None and one.size == 1
    # equal settings give equal (hashable) meshes, so per-mesh caches share
    assert hash(one) == hash(mesh_from_settings({"mesh": {"data": 1}}, "cpu"))


@pytest.mark.parametrize("bad", [
    {"mesh": {"model": 2}},
    {"mesh": {"data": 0}},
    {"mesh": {"data": -3}},
    {"mesh": {"data": "eight"}},
    {"mesh": {"data": True}},
    {"mesh": {"data": 9}},  # more than the 8 visible devices
], ids=lambda b: repr(b["mesh"]))
def test_mesh_from_settings_error_reports_supported_form(bad):
    from splink_tpu.parallel import mesh_from_settings as ref_mesh_from_settings

    with pytest.raises(ValueError, match="supported form") as ours:
        mesh_from_settings(bad, "cpu")
    with pytest.raises(ValueError, match="supported form") as theirs:
        ref_mesh_from_settings(bad)
    # the reference's message, with jax's device count read as the port's
    assert str(ours.value).split(";")[0] == str(theirs.value).split(";")[0]


def test_cuda_mesh_needs_a_card():
    if torch.cuda.is_available():
        pytest.skip("this case is the CPU build's: a card is present")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        mesh_from_settings({"mesh": {"data": 1}})


# --------------------------------------------------------------------------
# Padding and sharded EM
# --------------------------------------------------------------------------


@pytest.mark.parametrize("ndev", [2, 4, 8])
def test_shard_pairs_padding_semantics(ndev):
    """Uneven n_pairs over 2/4/8-way meshes: padding rows are gamma -1 with
    weight 0, contribute EXACTLY nothing (no output bit moves when their
    content changes), an all-padding batch gives zero statistics, and the
    sharded aggregate and EM equal the unsharded ones within rtol 1e-12."""
    rng = np.random.default_rng(31)
    n = 10_007  # never a multiple of 2/4/8
    G = rng.integers(-1, 3, size=(n, 3)).astype(np.int8)
    lam, m, u = 0.3, np.tile([0.2, 0.5, 0.3], (3, 1)), np.tile([0.5, 0.3, 0.2], (3, 1))
    params = _port_params(lam, m, u)
    mesh = _mesh(ndev)
    G_dev, w = shard_pairs(mesh, G)
    n_pad = G_dev.shape[0]
    assert n_pad % ndev == 0 and n_pad >= n and len(G_dev.shards) == ndev
    G_host = torch.cat(G_dev.shards).numpy()
    np.testing.assert_array_equal(G_host[:n], G)
    assert (G_host[n:] == -1).all()
    w_host = torch.cat(w.shards).numpy()
    assert w_host.dtype == np.float32
    assert (w_host[:n] == 1.0).all() and (w_host[n:] == 0.0).all()
    # the reference pads the same way
    rG, rw = ref_shard_pairs(ref_make_mesh(ndev), G)
    np.testing.assert_array_equal(np.asarray(rG), G_host)
    np.testing.assert_array_equal(np.asarray(rw), w_host)

    wf = w.to(torch.float64)

    def stats_of(Gs, ws):
        parts = [_batch_stats(g, params, 3, wk, True) for g, wk in zip(Gs.shards, ws.shards)]
        return parts

    base = stats_of(G_dev, wf)
    for fill in (0, 1, 2):
        alt = pair_sharding(mesh, np.concatenate([G, np.full((n_pad - n, 3), fill, np.int8)]))
        for (s1, l1), (s2, l2) in zip(base, stats_of(alt, wf)):
            for a, b in zip(s1, s2):
                assert torch.equal(a, b)
            assert torch.equal(l1, l2)
    zero = pair_sharding(mesh, np.zeros(n_pad, np.float64))
    for s, _ in stats_of(G_dev, zero):
        for leaf in s:
            assert not leaf.any()

    from splink_tpu_torch.parallel.mesh import reduce_shards

    total = reduce_shards([s for s, _ in base])
    ref_stats, ref_ll = _batch_stats(torch.from_numpy(G), params, 3, None, True)
    for a, b in zip(total, ref_stats):
        _close(a, b)
    _close(reduce_shards([ll for _, ll in base]), ref_ll)

    one = run_em(torch.from_numpy(G), params, max_iterations=6, max_levels=3,
                 em_convergence=0.0)
    sharded = run_em(G_dev, params, max_iterations=6, max_levels=3, em_convergence=0.0,
                     weights=wf)
    for a, b in zip(sharded.params, one.params):
        _close(a, b)


def test_sharded_em_matches_single_device_and_reference():
    """run_em over a sharded odd-sized G (8 shards, padding) equals the
    unsharded run and the reference's sharded run_em, histories included."""
    G, init = _dgp(20_000)
    G_odd = G[:-3]
    one = run_em(torch.from_numpy(G_odd), _port_params(*init), max_iterations=10,
                 max_levels=2, em_convergence=0.0, compute_ll=True)
    G_dev, w = shard_pairs(_mesh(), G_odd)
    sharded = run_em(G_dev, _port_params(*init), max_iterations=10, max_levels=2,
                     em_convergence=0.0, weights=w.to(torch.float64), compute_ll=True)
    rG, rw = ref_shard_pairs(ref_make_mesh(), G_odd)
    ref = ref_em.run_em(rG, _ref_params(*init), max_iterations=10, max_levels=2,
                        em_convergence=0.0, weights=rw.astype(jnp.float64), compute_ll=True)
    for have, want in ((sharded, one), (sharded, ref)):
        for a, b in zip(have.params, want.params):
            _close(a, b)
        for h in ("lam_history", "m_history", "u_history", "ll_history"):
            _close(getattr(have, h), getattr(want, h))


def test_streamed_em_sharded_batches():
    """run_em_streamed with a mesh (ragged 1000-pair batches over 8 shards,
    each padded) equals the unsharded stream, the resident run and the
    reference's sharded stream."""
    G, init = _dgp(8_192)
    mesh = _mesh()

    def batches():
        for s in range(0, len(G), 1000):
            yield G[s:s + 1000]

    got, hist, n_up, _ = run_em_streamed(batches, _port_params(*init), max_iterations=5,
                                         max_levels=2, em_convergence=0.0, mesh=mesh,
                                         compute_ll=True)
    plain, phist, _, _ = run_em_streamed(batches, _port_params(*init), max_iterations=5,
                                         max_levels=2, em_convergence=0.0, compute_ll=True)
    resident = run_em(torch.from_numpy(G), _port_params(*init), max_iterations=5,
                      max_levels=2, em_convergence=0.0)
    ref, rhist, _, _ = ref_run_em_streamed(batches, _ref_params(*init), max_iterations=5,
                                           max_levels=2, em_convergence=0.0,
                                           mesh=ref_make_mesh(), compute_ll=True)
    assert n_up == 5
    for want in (plain, resident.params, ref):
        for a, b in zip(got, want):
            _close(a, b)
    _close(hist["ll"], phist["ll"])
    _close(hist["ll"], rhist["ll"])


@pytest.mark.parametrize("with_weights", [False, True])
def test_streamed_em_sharded_user_weights(with_weights):
    """(G, weights) batches under a mesh: the user weights pad alongside G
    (padding weight 0) and the run equals the unsharded weighted stream."""
    G, init = _dgp(3_001, seed=5)
    wts = np.random.default_rng(9).integers(1, 4, len(G)).astype(np.float64)

    def batches():
        for s in range(0, len(G), 700):
            yield (G[s:s + 700], wts[s:s + 700]) if with_weights else G[s:s + 700]

    kw = dict(max_iterations=4, max_levels=2, em_convergence=0.0, compute_ll=True)
    got, ghist, _, _ = run_em_streamed(batches, _port_params(*init), mesh=_mesh(3), **kw)
    want, whist, _, _ = run_em_streamed(batches, _port_params(*init), **kw)
    for a, b in zip(got, want):
        _close(a, b)
    _close(ghist["ll"], whist["ll"])


# --------------------------------------------------------------------------
# The facade
# --------------------------------------------------------------------------


def _facade_frame(n=100, seed=4):
    rng = np.random.default_rng(seed)
    return pd.DataFrame({
        "unique_id": range(n),
        "name": rng.choice(["ann", "bob", "cat", "dan"], n),
        "dob": rng.choice(["x", "y", "z"], n),
    })


FACADE = {
    "link_type": "dedupe_only",
    "comparison_columns": [
        {"col_name": "name", "comparison": {"kind": "exact"}},
        {"col_name": "dob", "comparison": {"kind": "exact"}},
    ],
    "blocking_rules": ["l.dob = r.dob"],
    "max_iterations": 5,
    "float64": True,
}


def _facade(pkg, settings, df, **kw):
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        linker = pkg.Splink(copy.deepcopy(settings), df=df, **kw)
        return linker, linker.get_scored_comparisons()


def _assert_facade_close(a, b, rtol=RTOL):
    """Equal pair sets; lambda, m, u and match_probability within rtol."""
    (la, fa), (lb, fb) = a, b
    key = ["unique_id_l", "unique_id_r"]
    fa = fa.sort_values(key).reset_index(drop=True)
    fb = fb.sort_values(key).reset_index(drop=True)
    assert len(fa) == len(fb) > 0
    np.testing.assert_array_equal(fa[key].to_numpy(), fb[key].to_numpy())
    _close(fa.match_probability, fb.match_probability, rtol)
    for x, y in zip(la.params.to_arrays(dtype=np.float64)[:3],
                    lb.params.to_arrays(dtype=np.float64)[:3]):
        _close(x, y, rtol)


@pytest.mark.parametrize("n", [8, 1])
def test_linker_mesh_matches_unsharded_and_reference(n):
    """The facade under {"data": n} (the resident regime: gammas unsharded,
    EM over shard_pairs) equals the unsharded facade and the reference's
    sharded facade in float64."""
    df = _facade_frame()
    meshed = _facade(splink_tpu_torch, {**FACADE, "mesh": {"data": n}}, df, device="cpu")
    plain = _facade(splink_tpu_torch, FACADE, df, device="cpu")
    ref = _facade(splink_tpu, {**FACADE, "mesh": {"data": n}}, df)
    _assert_facade_close(meshed, plain)
    _assert_facade_close(meshed, ref)


def test_mesh_linker_with_case_sql_matches_single_device():
    rng = np.random.default_rng(9)
    n = 240
    df = pd.DataFrame({"unique_id": np.arange(n),
                       "name": rng.choice(["ann", "bob", "cat", "dan", "eve"], n),
                       "city": rng.choice(["x", "y"], n)})
    s = {
        "link_type": "dedupe_only",
        "blocking_rules": ["l.city = r.city"],
        "comparison_columns": [{
            "col_name": "name", "num_levels": 2,
            "case_expression": "case when name_l is null or name_r is null then -1 "
                               "when lower(name_l) = lower(name_r) then 1 else 0 end",
        }],
        "max_iterations": 5,
        "float64": True,
    }
    single = _facade(splink_tpu_torch, s, df, device="cpu")[1]
    meshed = _facade(splink_tpu_torch, {**s, "mesh": {"data": 8}}, df, device="cpu")[1]
    ref = _facade(splink_tpu, {**s, "mesh": {"data": 8}}, df)[1]
    key = ["unique_id_l", "unique_id_r"]
    for other in (single, ref):
        m = meshed.merge(other, on=key, suffixes=("_a", "_b"))
        assert len(m) == len(meshed) == len(other)
        _close(m.match_probability_a, m.match_probability_b)


def _pattern_frame(n=900, seed=53):
    rng = np.random.default_rng(seed)
    return pd.DataFrame({
        "unique_id": np.arange(n),
        "name": rng.choice(["ann", "bob", "cat", "dan", None], n),
        "dob": rng.choice([f"d{k}" for k in range(10)], n),
        "city": rng.choice(["x", "y", "z"], n),
    })


PATTERN_JOB = {
    "link_type": "dedupe_only",
    "comparison_columns": [{"col_name": "name", "num_levels": 3},
                           {"col_name": "city", "num_levels": 2}],
    "blocking_rules": ["l.dob = r.dob"],
    "max_resident_pairs": 1024,
    "max_iterations": 6,
    "float64": True,
}


@pytest.mark.parametrize("dpg", ["off", "on"])
def test_linker_mesh_pattern_pipeline_e2e(dpg):
    """Past max_resident_pairs, materialised (PatternStream) and virtual
    pattern passes under {"data": 8}: equal pairs and probabilities to the
    unsharded run (the passes give the same ids and counts) and the
    reference's sharded run."""
    df = _pattern_frame()
    s = {**PATTERN_JOB, "device_pair_generation": dpg}
    meshed = _facade(splink_tpu_torch, {**s, "mesh": {"data": 8}}, df, device="cpu")
    plain = _facade(splink_tpu_torch, s, df, device="cpu")
    ref = _facade(splink_tpu, {**s, "mesh": {"data": 8}}, df)
    assert len(meshed[1]) > 2000
    assert meshed[0].device_pair_generation_active == (dpg == "on")
    _assert_facade_close(meshed, plain)
    _assert_facade_close(meshed, ref)


# --------------------------------------------------------------------------
# The mesh pattern passes, array for array
# --------------------------------------------------------------------------


def _pattern_inputs(cols=("name",), rules=("l.dob = r.dob",), n=500, seed=51):
    rng = np.random.default_rng(seed)
    df = pd.DataFrame({
        "unique_id": np.arange(n),
        "name": rng.choice(["ann", "bob", "cat", "anne", "bobby", None], n),
        "dob": rng.choice([f"d{k}" for k in range(8)], n),
        "city": rng.choice(["x", "y", "xy"], n),
    })
    raw = {"link_type": "dedupe_only",
           "comparison_columns": [{"col_name": c, "num_levels": 3} for c in cols],
           "blocking_rules": list(rules)}
    s, sr = complete_settings_dict(copy.deepcopy(raw)), ref_complete(copy.deepcopy(raw))
    return df, s, sr


@pytest.mark.parametrize("n_dev", [1, 3, 8])
def test_materialised_pattern_pass_mesh_parity(n_dev):
    """compute_pattern_ids with a mesh: the unsharded pass's ids and counts,
    and the reference's mesh pass's, array for array (batch 4096, so the
    mesh pads the batch when 3 does not divide it)."""
    df, s, sr = _pattern_inputs(cols=("name", "city"))
    t, tr = encode_table(df, s), ref_encode(df, sr)
    pairs = block_using_rules(s, t, device="cpu")
    prog = GammaProgram(s, t, device="cpu")
    p1, c1 = prog.compute_pattern_ids(pairs.idx_l, pairs.idx_r, 4096)
    p2, c2 = prog.compute_pattern_ids(pairs.idx_l, pairs.idx_r, 4096, mesh=_mesh(n_dev))
    rprog = RefGammaProgram(sr, tr)
    rp, rc = rprog.compute_pattern_ids(pairs.idx_l, pairs.idx_r, 4096,
                                       mesh=ref_make_mesh(n_dev))
    assert len(p2) > 4096
    for ids, counts in ((p1, c1), (rp, rc)):
        np.testing.assert_array_equal(p2, ids)
        np.testing.assert_array_equal(c2, counts)


@pytest.mark.parametrize("n_dev", [1, 3, 8])
def test_virtual_pattern_pass_mesh_parity(n_dev):
    """compute_virtual_pattern_ids with a mesh (two rules: the earlier
    rule's mask; duplicate positions masked): ids and counts equal the
    reference's mesh pass and the port's unsharded pass."""
    df, s, sr = _pattern_inputs(cols=("name", "city"), rules=("l.dob = r.dob", "l.city = r.city"),
                                n=400)
    t, tr = encode_table(df, s), ref_encode(df, sr)
    plan = pairgen.build_virtual_plan(s, t)
    rplan = ref_pairgen.build_virtual_plan(sr, tr)
    prog = GammaProgram(s, t, device="cpu")
    rprog = RefGammaProgram(sr, tr)
    got = pairgen.compute_virtual_pattern_ids(prog, plan, 1000, mesh=_mesh(n_dev))
    plain = pairgen.compute_virtual_pattern_ids(prog, plan, 1000)
    ref = ref_pairgen.compute_virtual_pattern_ids(rprog, rplan, 1000, mesh=ref_make_mesh(n_dev))
    assert got[2] > 0 and len(got[0]) > 1000
    for want in (plain, ref):
        np.testing.assert_array_equal(got[0], want[0])
        np.testing.assert_array_equal(got[1], want[1])
        assert got[2] == want[2]
    hist_only = pairgen.compute_virtual_pattern_ids(prog, plan, 1000, mesh=_mesh(n_dev),
                                                    return_ids=False)
    assert hist_only[0] is None
    np.testing.assert_array_equal(hist_only[1], got[1])


# --------------------------------------------------------------------------
# Sharded emission
# --------------------------------------------------------------------------

_NAMES = ["john", "mary", "jones", "smith", None, "lee", "ann"]

EMIT_RULESETS = [
    ["l.first_name = r.first_name", "l.surname = r.surname"],
    ["l.first_name = r.surname"],
    ["l.surname = r.surname and l.amount <= r.amount", "l.first_name = r.first_name"],
]


def _emit_inputs(rules, n=150, seed=3):
    r = np.random.default_rng(seed)
    df = pd.DataFrame({
        "unique_id": np.arange(n),
        "first_name": r.choice(_NAMES, n),
        "surname": r.choice(_NAMES, n),
        "amount": r.choice([1.0, 2.5, 3.0, np.nan], n),
    })
    raw = {"link_type": "dedupe_only",
           "comparison_columns": [{"col_name": "first_name"}, {"col_name": "surname"},
                                  {"col_name": "amount", "data_type": "numeric"}],
           "blocking_rules": list(rules)}
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        s, sr = complete_settings_dict(copy.deepcopy(raw)), ref_complete(copy.deepcopy(raw))
    t, tr = encode_table(df, s), ref_encode(df, sr)
    return blocking_device.build_device_plan(s, t, device="cpu"), ref_bd.build_device_plan(sr, tr)


def _pairs_of(chunks):
    return [(r, i.tolist(), j.tolist()) for r, i, j in chunks]


@pytest.mark.parametrize("rules", EMIT_RULESETS)
def test_iter_device_pairs_mesh_equals_unsharded_and_reference(rules):
    """iter_device_pairs with a 3-way mesh (chunks of 64, shard pieces of
    22): the unsharded chunks, and the reference's mesh chunks, in order."""
    plan, rplan = _emit_inputs(rules)
    got = _pairs_of(blocking_device.iter_device_pairs(plan, 64, mesh=_mesh(3)))
    assert got == _pairs_of(blocking_device.iter_device_pairs(plan, 66))
    assert got == _pairs_of(ref_bd.iter_device_pairs(rplan, 64, mesh=ref_make_mesh(3)))


def _bins(d):
    return tuple(open(os.path.join(d, name), "rb").read() for name in ("idx_l.bin", "idx_r.bin"))


@pytest.mark.parametrize("rules", EMIT_RULESETS)
def test_sharded_emission_mesh_is_byte_identical_to_reference(rules, tmp_path):
    """emit_pairs_sharded under an 8-way mesh (3 shards, chunks of 64):
    the reference's mesh emission's bins and manifest, byte for byte
    (every mesh chunk carries a digest), and the unsharded emission's
    bins."""
    plan, rplan = _emit_inputs(rules)
    got = PairSpillStore.attach(str(tmp_path / "port"), np.int32, {})
    with got:
        blocking_device.emit_pairs_sharded(plan, got, 64, n_shards=3, mesh=_mesh())
    got.finalize()
    want = ref_spill.PairSpillStore.attach(str(tmp_path / "ref"), np.int32, {})
    with want:
        ref_bd.emit_pairs_sharded(rplan, want, 64, n_shards=3, mesh=ref_make_mesh())
    want.finalize()
    plain = PairSpillStore.attach(str(tmp_path / "plain"), np.int32, {})
    with plain:
        blocking_device.emit_pairs_sharded(plan, plain, 64, n_shards=3)
    plain.finalize()
    assert _bins(got.directory) == _bins(want.directory) == _bins(plain.directory)
    m1 = json.load(open(os.path.join(got.directory, MANIFEST_NAME)))
    m2 = json.load(open(os.path.join(want.directory, MANIFEST_NAME)))
    assert m1 == m2
    assert all(seg["digest"] is not None for seg in m1["segments"])


@pytest.mark.parametrize("p_cnt", [2, 3])
def test_shard_filter_partitions_the_store(p_cnt, tmp_path):
    """shard_filter=(p, P): each process's store holds its own shards'
    segments, the union of the P stores is the whole store's segment set
    (same bytes per segment), and the reference partitions alike."""
    plan, rplan = _emit_inputs(EMIT_RULESETS[0])
    whole = PairSpillStore.attach(str(tmp_path / "whole"), np.int32, {})
    with whole:
        blocking_device.emit_pairs_sharded(plan, whole, 64, n_shards=4)
    whole.finalize()
    want = {(s.rule, s.shard, s.seq): s.sha256 for s in whole.segments}
    got = {}
    for p in range(p_cnt):
        store = PairSpillStore.attach(str(tmp_path / f"proc{p}"), np.int32, {})
        with store:
            blocking_device.emit_pairs_sharded(plan, store, 64, n_shards=4,
                                               shard_filter=(p, p_cnt))
        store.finalize()
        ref = ref_spill.PairSpillStore.attach(str(tmp_path / f"ref{p}"), np.int32, {})
        with ref:
            ref_bd.emit_pairs_sharded(rplan, ref, 64, n_shards=4, shard_filter=(p, p_cnt))
        ref.finalize()
        assert _bins(store.directory) == _bins(ref.directory)
        for s in store.segments:
            assert s.shard % p_cnt == p
            got[(s.rule, s.shard, s.seq)] = s.sha256
    assert got == want


def test_spill_block_rules_mesh_shards_by_mesh_size(tmp_path):
    """Without emit_shard_chunks a build_spill_dir job under {"data": 8}
    splits each rule into 8 shards, as the reference does, and records one
    process of one."""
    df = _pattern_frame(300)
    s = {**PATTERN_JOB, "mesh": {"data": 8}, "device_pair_generation": "off",
         "build_spill_dir": str(tmp_path / "build")}
    linker, frame = _facade(splink_tpu_torch, s, df, device="cpu")
    store = linker._pairs.spill_store
    assert store.meta["n_shards"] == 8
    assert (store.meta["process_index"], store.meta["process_count"]) == (0, 1)
    ref_linker, ref_frame = _facade(splink_tpu, {**s, "build_spill_dir": str(tmp_path / "ref")},
                                    df)
    assert ref_linker._pairs.spill_store.meta["n_shards"] == 8
    assert _bins(store.directory) == _bins(ref_linker._pairs.spill_store.directory)
    _assert_facade_close((linker, frame), (ref_linker, ref_frame))


# --------------------------------------------------------------------------
# The launch device
# --------------------------------------------------------------------------


class _FakeCuda:
    """A stand-in for a CUDA tensor on another card than the current one:
    only what ``strings_cuda._launch`` reads of its inputs."""

    def __init__(self, device, shape=(4, 8)):
        self.device = torch.device(device)
        self.shape = shape

    def data_ptr(self):
        return 0

    def element_size(self):
        return 1


def test_kernel_launch_enters_the_inputs_device(monkeypatch):
    """The ctypes launcher runs on the CUDA runtime's CURRENT device, so
    _launch must make the inputs' device current around it: a shard on
    cuda:1 while cuda:0 is current would otherwise launch on the wrong
    card with a foreign stream. The launcher sees cuda:1 current and that
    device's stream; cuda:0 is current again afterwards."""
    current = {"device": 0}
    seen = {}

    class device_ctx:
        def __init__(self, dev):
            self.idx = torch.device(dev).index

        def __enter__(self):
            self.prev, current["device"] = current["device"], self.idx

        def __exit__(self, *exc):
            current["device"] = self.prev

    class Stream:
        def __init__(self, dev):
            self.cuda_stream = 1000 + torch.device(dev).index

    def launcher(*args):
        seen["current"] = current["device"]
        seen["stream"] = args[-1]
        return 0

    monkeypatch.setattr(strings_cuda.torch.cuda, "device", device_ctx)
    monkeypatch.setattr(strings_cuda.torch.cuda, "current_stream", Stream)
    monkeypatch.setattr(strings_cuda, "_check", lambda *a: ("u8", 1))
    monkeypatch.setattr(strings_cuda, "_load", lambda name: launcher)
    monkeypatch.setattr(strings_cuda, "launches", dict(strings_cuda.launches))
    monkeypatch.setattr(strings_cuda, "variant_launches", {})
    monkeypatch.setattr(strings_cuda, "capture", None)
    before = strings_cuda.launches["levenshtein"]
    s = _FakeCuda("cuda:1")
    strings_cuda._launch("levenshtein", _FakeCuda("cuda:1"), s, s, s, s)
    assert seen == {"current": 1, "stream": 1001}
    assert current["device"] == 0
    assert strings_cuda.launches["levenshtein"] == before + 1
    assert strings_cuda.variant_launches == {"levenshtein/u8/w1": 1}
