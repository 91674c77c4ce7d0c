"""Term-frequency adjustment of splink_tpu_torch against splink_tpu, on CPU.

Tolerances:
  * ``bayes_combine``, ``tf_fold_spec``, ``tf_log_table`` and the host
    groupby are the same numpy/pandas code: bit-identical;
  * the device aggregation (float64 on both sides; the reference runs it
    with x64, as tests/conftest.py sets): token counts equal, lambda table
    and per-pair adjustment within 1e-12 relative (the sums accumulate in
    another order);
  * the fold: given the same ``log u`` the pre-sigmoid sum is
    bit-identical, and ``tf_match_probability`` is within 4 ulp at float32
    (XLA's and PyTorch's sigmoid differ in the last ulp, as for
    ``match_probability`` in tests/test_torch_em.py);
  * end to end with the same parameters on both sides:
    ``tf_match_probability`` within 4 ulp, ``tf_adjusted_match_prob`` and
    ``<col>_adj`` within 1e-6 relative at float32 and 1e-12 at float64.
"""

import ast
import copy
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
from splink_tpu import term_frequencies as ref_tf  # noqa: E402
from splink_tpu.models import fellegi_sunter as ref_fs  # noqa: E402
from splink_tpu.params import Params as RefParams  # noqa: E402
from splink_tpu_torch import term_frequencies as tf  # noqa: E402
from splink_tpu_torch.models import fellegi_sunter as fs  # noqa: E402
from splink_tpu_torch.params import Params  # noqa: E402

from test_torch_linker import people, settings  # noqa: E402

DTYPES = pytest.mark.parametrize("dtype", [np.float32, np.float64])


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.max(np.abs(got - want) / np.maximum(np.abs(want), 1e-300), initial=0.0))


def _ulps32(got, want):
    got = np.asarray(got, np.float32).view(np.int32).astype(np.int64)
    want = np.asarray(want, np.float32).view(np.int32).astype(np.int64)
    return int(np.abs(got - want).max(initial=0))


# ----------------------------------------------------------------------
# Host half: bit-identical
# ----------------------------------------------------------------------


def test_bayes_combine_bit_identical(rng):
    probs = [rng.random(5000) for _ in range(3)]
    probs[0][:4] = [0.0, 1.0, 0.5, 1e-300]
    probs[1][:4] = [1.0, 0.0, 0.5, 1e-300]
    got = tf.bayes_combine(probs)
    np.testing.assert_array_equal(got, ref_tf.bayes_combine(probs))
    assert got[0] == got[1] == 0.5


def test_host_groupby_bit_identical():
    values_l = np.array(["smith", "smith", "zorro", "smith", None], dtype=object)
    values_r = np.array(["smith", "smith", "zorro", "jones", "x"], dtype=object)
    p = np.array([0.2, 0.4, 0.9, 0.99, 0.5])
    got, got_lookup = tf.compute_token_adjustment(values_l, values_r, p, 0.3)
    want, want_lookup = ref_tf.compute_token_adjustment(values_l, values_r, p, 0.3)
    np.testing.assert_array_equal(got, want)
    assert got_lookup == want_lookup


def test_fold_spec_and_log_table_bit_identical(rng):
    s = splink_tpu_torch.complete_settings_dict(settings())
    for c in (0, 1, 4):
        s["comparison_columns"][c]["term_frequency_adjustments"] = True
    assert tf.tf_fold_spec(s) == ref_tf.tf_fold_spec(s) == (
        (0, "first_name", 2), (1, "surname", 2), (4, "postcode", 1))
    assert list(tf.term_frequency_columns(s)) == list(ref_tf.term_frequency_columns(s))
    counts = rng.integers(0, 50, 1000)
    counts[:3] = 0
    np.testing.assert_array_equal(tf.tf_log_table(counts), ref_tf.tf_log_table(counts))
    np.testing.assert_array_equal(tf.tf_log_table(np.zeros(4)), ref_tf.tf_log_table(np.zeros(4)))


def test_make_adjustment_end_to_end_bit_identical():
    spec = {
        "link_type": "dedupe_only",
        "proportion_of_matches": 0.3,
        "comparison_columns": [{"col_name": "name", "term_frequency_adjustments": True}],
        "blocking_rules": ["l.name = r.name"],
    }
    df_e = pd.DataFrame({
        "match_probability": [0.8, 0.6, 0.9, 0.2],
        "name_l": ["ann", "ann", "bo", "ann"],
        "name_r": ["ann", "ann", "bo", "cat"],
    })
    for keep in (False, True):
        got = tf.make_adjustment_for_term_frequencies(
            df_e, Params(copy.deepcopy(spec)), Params(copy.deepcopy(spec)).settings,
            retain_adjustment_columns=keep)
        ref_params = RefParams(copy.deepcopy(spec))
        want = ref_tf.make_adjustment_for_term_frequencies(
            df_e, ref_params, ref_params.settings, retain_adjustment_columns=keep)
        assert list(got.columns) == list(want.columns)
        assert got.columns[0] == "tf_adjusted_match_prob"
        pd.testing.assert_frame_equal(got, want, check_exact=True)


def test_no_tf_columns_warns_and_passes_through():
    params = Params({"link_type": "dedupe_only", "comparison_columns": [{"col_name": "name"}],
                     "blocking_rules": ["l.name = r.name"]})
    df_e = pd.DataFrame({"match_probability": [0.5]})
    with pytest.warns(UserWarning, match="No term frequency"):
        out = tf.make_adjustment_for_term_frequencies(df_e, params, params.settings)
    assert out is df_e


# ----------------------------------------------------------------------
# Device aggregation: counts equal, the rest within 1e-12 relative
# ----------------------------------------------------------------------


def _token_case(seed, n, n_tokens, agree_share):
    rng = np.random.default_rng(seed)
    tid_l = rng.integers(-1, n_tokens, n).astype(np.int32)  # -1 = null
    tid_r = np.where(rng.random(n) < agree_share, tid_l,
                     rng.integers(-1, n_tokens, n)).astype(np.int32)
    return tid_l, tid_r, rng.random(n)


@pytest.mark.parametrize("case", [(11, 20_000, 37, 0.5), (13, 10_001, 13, 0.4)],
                         ids=["skewed", "ragged"])
@pytest.mark.parametrize("chunk", [None, 4096])
def test_device_aggregation_matches_reference(monkeypatch, case, chunk):
    tid_l, tid_r, p = _token_case(*case[:3], case[3])
    n_tokens = case[2]
    if chunk:
        monkeypatch.setattr(tf, "TF_DEVICE_CHUNK", chunk)
        monkeypatch.setattr(ref_tf, "TF_DEVICE_CHUNK", chunk)
    before = tf.device_aggregations.get("cpu", 0)
    adj, lam, cnt = tf.compute_token_adjustment_device(
        tid_l, tid_r, p, 0.27, n_tokens, device="cpu")
    assert tf.device_aggregations["cpu"] == before + 1
    assert jax.config.jax_enable_x64  # the reference's float64 path
    r_adj, r_lam, r_cnt = ref_tf.compute_token_adjustment_device(tid_l, tid_r, p, 0.27, n_tokens)
    assert adj.dtype == lam.dtype == cnt.dtype == np.float64
    np.testing.assert_array_equal(cnt, r_cnt)
    assert _rel(lam, r_lam) <= 1e-12
    assert _rel(adj, r_adj) <= 1e-12
    agree = (tid_l == tid_r) & (tid_l >= 0)
    assert (adj[~agree] == 0.5).all()
    # and the port's host groupby over the same tokens
    vocab = np.array([f"tok{i}" for i in range(n_tokens)], dtype=object)
    values_l = np.where(tid_l >= 0, vocab[np.maximum(tid_l, 0)], None)
    values_r = np.where(tid_r >= 0, vocab[np.maximum(tid_r, 0)], None)
    host, _ = tf.compute_token_adjustment(values_l, values_r, p, 0.27)
    np.testing.assert_allclose(adj, host, rtol=1e-9, atol=1e-12)


def test_device_aggregation_takes_tensors_and_empty_input():
    tid_l, tid_r, p = _token_case(5, 3000, 9, 0.6)
    want = tf.compute_token_adjustment_device(tid_l, tid_r, p, 0.4, 9, device="cpu")
    got = tf.compute_token_adjustment_device(
        torch.from_numpy(tid_l), torch.from_numpy(tid_r), p.astype(np.float32), 0.4, 9,
        device="cpu")
    np.testing.assert_array_equal(got[2], want[2])
    assert _rel(got[0], want[0]) <= 1e-6  # float32 probabilities in
    adj, lam, cnt = tf.compute_token_adjustment_device(
        tid_l[:0], tid_r[:0], p[:0], 0.4, 9, device="cpu")
    assert adj.shape == (0,) and lam.shape == cnt.shape == (16,)


# ----------------------------------------------------------------------
# The fold
# ----------------------------------------------------------------------


def _log_agreeing(rng, dtype, k=20000):
    """Values whose log, and the log of one minus them, XLA and PyTorch
    compute alike in ``dtype`` (float32-representable, so that both
    dtypes see the same parameters)."""
    cand = rng.random(k).astype(np.float32).astype(dtype)

    def same(x):
        return np.asarray(jnp.log(jnp.asarray(x))) == torch.log(torch.from_numpy(x)).numpy()

    keep = same(cand) & same(1 - cand)
    if dtype == np.float64:  # also alike in float32
        c32 = cand.astype(np.float32)
        keep &= same(c32) & same(1 - c32)
    return cand[keep]


def _fold_inputs(rng, dtype, n=50_000, C=5, L=3, n_tokens=40):
    spec = ((0, "a", 2), (3, "b", 1), (1, "c", 2))
    G = rng.integers(-1, L, (n, C)).astype(np.int8)
    pool = _log_agreeing(rng, dtype)
    lam, m, u = rng.choice(pool[pool < 0.3]), rng.choice(pool, (C, L)), rng.choice(pool, (C, L))
    tids_l = [rng.integers(-1, n_tokens, n).astype(np.int32) for _ in spec]
    tids_r = [np.where(rng.random(n) < 0.5, t, rng.integers(-1, n_tokens, n)).astype(np.int32)
              for t in tids_l]
    logs = [tf.tf_log_table(rng.integers(0, 30, n_tokens)).astype(dtype) for _ in spec]
    return spec, G, lam, m, u, tids_l, tids_r, logs


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_fold_pre_sigmoid_sum_bit_identical(rng, dtype):
    """Given the same log u, z + sum of deltas (summed left to right in spec
    order) is bit-identical to the reference's tf_fold_delta chain."""
    spec, G, lam, m, u, tids_l, tids_r, logs = _fold_inputs(rng, dtype)
    log_u = np.log(np.maximum(u, np.finfo(dtype).tiny))  # one table for both sides
    z = fs.fold_logit(torch.from_numpy(G), splink_tpu_torch.fsparams_from_numpy(
        lam, m, u, device="cpu")).numpy()
    got = tf.tf_fold_logit(
        spec, torch.from_numpy(z), torch.from_numpy(log_u),
        [torch.from_numpy(t) for t in tids_l], [torch.from_numpy(t) for t in tids_r],
        [torch.from_numpy(t) for t in logs]).numpy()
    tf_sum = jnp.zeros(z.shape, z.dtype)
    for t, (ci, _name, top) in enumerate(spec):
        tf_sum = tf_sum + ref_tf.tf_fold_delta(
            jnp.asarray(tids_l[t]), jnp.asarray(tids_r[t]), jnp.asarray(logs[t]),
            jnp.asarray(log_u)[ci, top], z.dtype)
    want = np.asarray(jnp.asarray(z) + tf_sum)
    assert got.dtype == want.dtype == dtype
    np.testing.assert_array_equal(got, want)
    for t, (ci, _name, top) in enumerate(spec):
        np.testing.assert_array_equal(
            tf.tf_fold_delta(torch.from_numpy(tids_l[t]), torch.from_numpy(tids_r[t]),
                             torch.from_numpy(logs[t]), torch.from_numpy(log_u)[ci, top]).numpy(),
            np.asarray(ref_tf.tf_fold_delta(
                jnp.asarray(tids_l[t]), jnp.asarray(tids_r[t]), jnp.asarray(logs[t]),
                jnp.asarray(log_u)[ci, top], z.dtype)))


def test_fold_probability_within_4_ulp_f32(rng):
    spec, G, lam, m, u, tids_l, tids_r, logs = _fold_inputs(rng, np.float32)
    ref_p = ref_fs.FSParams(jnp.asarray(lam), jnp.asarray(m), jnp.asarray(u))
    got_p = splink_tpu_torch.fsparams_from_numpy(lam, m, u, device="cpu")
    z_ref = ref_fs.fold_logit(jnp.asarray(G), ref_p)
    z_got = fs.fold_logit(torch.from_numpy(G), got_p)
    np.testing.assert_array_equal(z_got.numpy(), np.asarray(z_ref))
    want = np.asarray(ref_tf.make_tf_fold_fn(spec)(
        z_ref, jnp.asarray(u), *map(jnp.asarray, tids_l + tids_r + logs)))
    got = tf.make_tf_fold_fn(spec)(
        z_got, got_p.u, *map(torch.from_numpy, tids_l + tids_r + logs)).numpy()
    assert got.dtype == np.float32
    assert _ulps32(got, want) <= 4


# ----------------------------------------------------------------------
# End to end through the linkers
# ----------------------------------------------------------------------


def _tf_settings(link_type="dedupe_only", **extra):
    s = settings(link_type, **extra)
    for c in (0, 1):
        s["comparison_columns"][c]["term_frequency_adjustments"] = True
    return s


def _frames(link_type):
    df = people(1500, seed=5)
    if link_type == "dedupe_only":
        return {"df": df}
    return {"df_l": df.iloc[0::2], "df_r": df.iloc[1::2]}


def _fixed_params(linker, lam, m, u):
    """Install the same parameters in a linker of either package."""
    linker.params.update_from_arrays(lam, m, u)
    return linker


@pytest.mark.parametrize("link_type", ["dedupe_only", "link_only"])
@DTYPES
def test_tf_end_to_end_same_parameters(rng, link_type, dtype):
    pool = _log_agreeing(rng, dtype)
    lam, m, u = rng.choice(pool[pool < 0.3]), rng.choice(pool, (5, 3)), rng.choice(pool, (5, 3))
    s = _tf_settings(link_type, float64=dtype == np.float64)
    frames = _frames(link_type)
    ref = _fixed_params(splink_tpu.Splink(copy.deepcopy(s), **frames), lam, m, u)
    got = _fixed_params(splink_tpu_torch.Splink(copy.deepcopy(s), **frames, device="cpu"),
                        lam, m, u)
    want_e = ref.manually_apply_fellegi_sunter_weights()
    got_e = got.manually_apply_fellegi_sunter_weights()
    assert list(got_e.columns) == list(want_e.columns)
    assert list(got_e.columns)[:2] == ["match_probability", "tf_match_probability"]
    assert len(got_e) > 1000
    for c in ("unique_id_l", "unique_id_r", "gamma_first_name", "gamma_surname"):
        np.testing.assert_array_equal(got_e[c].to_numpy(), want_e[c].to_numpy())
    for c in ("match_probability", "tf_match_probability"):
        g, w = got_e[c].to_numpy(), want_e[c].to_numpy()
        assert g.dtype == w.dtype == dtype
        if dtype == np.float32:
            assert _ulps32(g, w) <= 4, c
        else:
            assert _rel(g, w) <= 1e-12, c
    want_a = ref.make_term_frequency_adjustments(want_e)
    got_a = got.make_term_frequency_adjustments(got_e)
    assert list(got_a.columns) == list(want_a.columns)
    assert list(got_a.columns)[:3] == ["tf_adjusted_match_prob", "match_probability",
                                       "tf_match_probability"]
    tol = 1e-6 if dtype == np.float32 else 1e-12
    for c in ("tf_adjusted_match_prob", "first_name_adj", "surname_adj"):
        assert got_a[c].dtype == np.float64
        assert _rel(got_a[c], want_a[c]) <= tol, c
    # the adjusted probability is the Bayes combination of the columns
    assert (tf.bayes_combine([got_e["match_probability"], got_a["first_name_adj"],
                              got_a["surname_adj"]]) == got_a["tf_adjusted_match_prob"]).all()


def test_linker_tf_integration():
    """The reference's own integration case (tests/test_term_frequencies.py):
    a common and a rare surname, EM, then the ex-post adjustment."""
    rng = np.random.default_rng(0)
    names = ["smith"] * 30 + ["zorro"] * 2
    df = pd.DataFrame({"unique_id": range(len(names)), "name": names,
                       "dob": rng.choice(["a", "b"], len(names))})
    s = {
        "link_type": "dedupe_only",
        "comparison_columns": [
            {"col_name": "name", "term_frequency_adjustments": True,
             "comparison": {"kind": "exact"}},
            {"col_name": "dob", "comparison": {"kind": "exact"}},
        ],
        "blocking_rules": [],
        "max_iterations": 3,
    }
    outs = []
    for pkg, kw in ((splink_tpu, {}), (splink_tpu_torch, {"device": "cpu"})):
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            linker = pkg.Splink(copy.deepcopy(s), df=df, **kw)
            df_e = linker.get_scored_comparisons()
            outs.append((linker, linker.make_term_frequency_adjustments(df_e)))
    (_, want), (linker, out) = outs
    assert list(out.columns) == list(want.columns)
    np.testing.assert_array_equal(out["gamma_name"], want["gamma_name"])
    np.testing.assert_allclose(out["match_probability"], want["match_probability"], atol=1e-5)
    np.testing.assert_allclose(out["tf_adjusted_match_prob"], want["tf_adjusted_match_prob"],
                               atol=1e-5)
    np.testing.assert_allclose(
        out.tf_adjusted_match_prob,
        tf.bayes_combine([out.match_probability.to_numpy(), out.name_adj.to_numpy()]),
        rtol=1e-9)
    assert (out[out.name_l != out.name_r].name_adj == 0.5).all()
    lam = linker.params.params["λ"]
    smith = out[(out.name_l == "smith") & (out.name_r == "smith")]
    adj_lambda = smith.match_probability.mean()
    want_adj = (adj_lambda * (1 - lam)) / (adj_lambda * (1 - lam) + (1 - adj_lambda) * lam)
    np.testing.assert_allclose(smith.name_adj.to_numpy(), want_adj, rtol=1e-6)


@DTYPES
def test_trained_tf_parity(dtype):
    """EM-trained runs of both packages: the linker file's tolerances
    (equal gammas, probabilities within 1e-5: the EM trajectories differ
    in the last ulps)."""
    s = _tf_settings(float64=dtype == np.float64)
    df = people(1500, seed=5)
    ref = splink_tpu.Splink(copy.deepcopy(s), df=df)
    got = splink_tpu_torch.Splink(copy.deepcopy(s), df=df, device="cpu")
    want = ref.make_term_frequency_adjustments(ref.get_scored_comparisons())
    out = got.make_term_frequency_adjustments(got.get_scored_comparisons())
    assert list(out.columns) == list(want.columns)
    assert list(out.dtypes) == list(want.dtypes)
    np.testing.assert_array_equal(out["unique_id_l"], want["unique_id_l"])
    np.testing.assert_array_equal(out["unique_id_r"], want["unique_id_r"])
    for c in ("match_probability", "tf_match_probability", "tf_adjusted_match_prob",
              "first_name_adj", "surname_adj"):
        np.testing.assert_allclose(out[c], want[c], rtol=0, atol=1e-5, err_msg=c)
    assert {"tf_fold", "tf_adjust"} <= set(got.stage_seconds)


def test_misaligned_frame_takes_host_groupby():
    rng = np.random.default_rng(5)
    names = np.array(["smith", "jones", "patel", "kim", "lee"], dtype=object)
    df = pd.DataFrame({
        "unique_id": np.arange(300),
        "name": names[rng.integers(0, len(names), 300)],
        "city": np.array(["a", "b", "c"], dtype=object)[rng.integers(0, 3, 300)],
    })
    s = {
        "link_type": "dedupe_only",
        "comparison_columns": [
            {"col_name": "name", "comparison": {"kind": "exact"},
             "term_frequency_adjustments": True},
            {"col_name": "city", "comparison": {"kind": "exact"}},
        ],
        "blocking_rules": ["l.city = r.city"],
        "max_iterations": 3,
    }
    linker = splink_tpu_torch.Splink(copy.deepcopy(s), df=df, device="cpu")
    df_e = linker.get_scored_comparisons()
    assert linker._df_e_aligned_with_pairs(df_e)
    before = tf.device_aggregations.get("cpu", 0)
    out_fast = linker.make_term_frequency_adjustments(df_e)
    assert tf.device_aggregations["cpu"] == before + 1
    shuffled = df_e.sample(frac=1.0, random_state=0)
    assert not linker._df_e_aligned_with_pairs(shuffled)
    out_slow = linker.make_term_frequency_adjustments(shuffled).sort_index()
    assert tf.device_aggregations["cpu"] == before + 1  # the host groupby
    np.testing.assert_allclose(out_fast.tf_adjusted_match_prob.to_numpy(),
                               out_slow.tf_adjusted_match_prob.to_numpy(), rtol=1e-9)
    ref = splink_tpu.Splink(copy.deepcopy(s), df=df)
    want = ref.make_term_frequency_adjustments(
        ref.get_scored_comparisons().sample(frac=1.0, random_state=0)).sort_index()
    np.testing.assert_allclose(out_slow.tf_adjusted_match_prob.to_numpy(),
                               want.tf_adjusted_match_prob.to_numpy(), atol=1e-5)


def test_serve_tf_adjust_off_drops_fold_column():
    s = _tf_settings(serve_tf_adjust=False, max_iterations=1)
    df = people(600, seed=7)
    got = splink_tpu_torch.Splink(copy.deepcopy(s), df=df, device="cpu").get_scored_comparisons()
    want = splink_tpu.Splink(copy.deepcopy(s), df=df).get_scored_comparisons()
    assert "tf_match_probability" not in got.columns
    assert list(got.columns) == list(want.columns)


def test_module_imports_no_jax():
    path = tf.__file__
    with open(path) as fh:
        tree = ast.parse(fh.read())
    roots = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            roots |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            roots.add((node.module or "").split(".")[0])
    assert not roots & {"jax", "jaxlib", "splink_tpu"}, roots
    assert os.path.basename(os.path.dirname(path)) == "splink_tpu_torch"
