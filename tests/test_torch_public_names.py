"""Public names of splink_tpu that splink_tpu_torch gained to match it, each
held to the reference on the same seeded inputs on the CPU.

``VirtualPlan.rule_offsets`` on the same plans; ``ServeRule.n_buckets`` and
``QueryBatch.unique_id`` on indexes each package builds over one frame;
``AotStore.names`` against the committed menu of a sidecar the port writes
on the CPU (the reference's menu names XLA executables, the port's its
libraries, so each is held to its own menu); ``SufficientStats.zeros`` at
float32 and float64, with ``device=None`` meaning the card; the batched
``exact_equal`` and ``jaro_winkler_batch``; and the exported names and
constants: ``__version__``, ``analysis.rule``, the ``ops``, ``models`` and
``utils`` exports, the fault-site groups, ``TIME_KEYS`` and
``NUM_EXCLUDED``.
"""

import copy
import json
import os
import warnings

import numpy as np
import pytest

torch = pytest.importorskip("torch")
pd = pytest.importorskip("pandas")

import jax.numpy as jnp  # noqa: E402

import splink_tpu  # noqa: E402
import splink_tpu_torch  # noqa: E402


def _people(n=160, seed=5):
    rng = np.random.default_rng(seed)
    return pd.DataFrame({
        "unique_id": np.arange(100, 100 + n),
        "first_name": rng.choice(["ann", "bob", "cat", "dan", None], n),
        "surname": rng.choice(["smith", "jones", "zorn", "brown"], n),
        "city": rng.choice([f"c{k}" for k in range(7)], n),
        "dob": rng.choice([f"d{k}" for k in range(20)], n),
    })


SETTINGS = {
    "link_type": "dedupe_only",
    "comparison_columns": [
        {"col_name": "first_name", "num_levels": 3},
        {"col_name": "surname", "num_levels": 2, "comparison": {"kind": "exact"}},
    ],
    "blocking_rules": ["l.dob = r.dob", "l.surname = r.surname and l.city = r.city",
                       "l.city = r.city"],
    "max_iterations": 3,
}


@pytest.mark.parametrize("rules, chunk", [
    (["l.city = r.city"], 2048),
    (["l.dob = r.dob", "l.city = r.city", "l.first_name = r.first_name"], 16),
    (["l.city = r.city and l.dob != r.dob", "l.dob = r.dob"], 4),
])
def test_rule_offsets_equal_the_reference(rules, chunk):
    from splink_tpu import data as ref_data
    from splink_tpu import pairgen as ref_pairgen
    from splink_tpu.settings import complete_settings_dict as ref_complete
    from splink_tpu_torch import data, pairgen
    from splink_tpu_torch.settings import complete_settings_dict

    raw = dict(copy.deepcopy(SETTINGS), blocking_rules=rules)
    df = _people(240, 7)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        s, rs = complete_settings_dict(copy.deepcopy(raw)), ref_complete(copy.deepcopy(raw))
        plan = pairgen.build_virtual_plan(s, data.encode_table(df, s), chunk=chunk)
        ref = ref_pairgen.build_virtual_plan(rs, ref_data.encode_table(df, rs), chunk=chunk)
    got, want = plan.rule_offsets(), ref.rule_offsets()
    assert got.dtype == want.dtype == np.int64
    assert got.shape == (len(rules) + 1,)
    assert np.array_equal(got, want)
    assert got[-1] == plan.n_candidates


@pytest.fixture(scope="module")
def indexes():
    """(reference index, port index, query frame): each package's index
    over one seeded frame at the settings' starting parameters."""
    from splink_tpu.serve import build_index as ref_build
    from splink_tpu_torch.serve import build_index

    df = _people()
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        ref = ref_build(splink_tpu.Splink(copy.deepcopy(SETTINGS), df=df))
        port = build_index(splink_tpu_torch.Splink(copy.deepcopy(SETTINGS), df=df,
                                                   device="cpu"))
    return ref, port, df


def test_n_buckets_equal_the_reference(indexes):
    ref, port, _ = indexes
    assert len(port.rules) == len(ref.rules) == 3
    for rr, pr in zip(ref.rules, port.rules):
        assert pr.rule == rr.rule
        assert pr.n_buckets == rr.n_buckets == len(pr.starts)


def test_query_batch_unique_id_equals_the_reference(indexes):
    ref, port, df = indexes
    queries = df.iloc[::7].reset_index(drop=True)
    got = port.encode_queries(queries).unique_id
    assert np.array_equal(got, ref.encode_queries(queries).unique_id)
    assert np.array_equal(got, queries["unique_id"].to_numpy())
    # without the id column, positional ids, as in the reference
    bare = queries.drop(columns=["unique_id"])
    assert np.array_equal(port.encode_queries(bare).unique_id,
                          ref.encode_queries(bare).unique_id)


def test_aot_store_names_are_its_menu(tmp_path):
    from splink_tpu_torch.serve import BucketPolicy, QueryEngine, load_index
    from splink_tpu_torch.serve.aot import MENU_NAME, AotStore

    df = _people(120, 11)
    linker = splink_tpu_torch.Splink(copy.deepcopy(SETTINGS), df=df, device="cpu")
    index_dir = str(tmp_path / "idx")
    linker.export_index(index_dir)
    aot_dir = str(tmp_path / "aot")
    engine = QueryEngine(load_index(index_dir, device="cpu"), top_k=4,
                         policy=BucketPolicy((16,), (64,)), aot_dir=aot_dir)
    engine.warmup()
    engine.save_aot()
    with open(os.path.join(aot_dir, MENU_NAME), encoding="utf-8") as fh:
        menu = json.load(fh)
    store = AotStore(aot_dir)
    assert store.names == []  # nothing before validate accepts the store
    assert store.validate(engine._aot_binding(), device="cpu")
    assert store.names == sorted(menu["libraries"]) == ["host"]


@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_sufficient_stats_zeros_equal_the_reference(dtype):
    from splink_tpu.models.fellegi_sunter import SufficientStats as RefStats
    from splink_tpu_torch.models.fellegi_sunter import SufficientStats

    got = SufficientStats.zeros(4, 3, getattr(torch, dtype), device="cpu")
    want = RefStats.zeros(4, 3, getattr(jnp, dtype))
    assert got._fields == want._fields
    for g, w in zip(got, want):
        w = np.asarray(w)
        assert g.device.type == "cpu" and str(g.dtype) == f"torch.{w.dtype}"
        assert tuple(g.shape) == w.shape
        assert np.array_equal(g.numpy(), w)


def test_sufficient_stats_zeros_default_to_the_card():
    from splink_tpu_torch.models.fellegi_sunter import SufficientStats

    if torch.cuda.is_available():
        assert SufficientStats.zeros(2, 2).m_num.device.type == "cuda"
        return
    with pytest.raises(RuntimeError, match="device='cpu'"):
        SufficientStats.zeros(2, 2)


def _padded(seed, n=64, width=12):
    rng = np.random.default_rng(seed)
    words = ["martha", "marhta", "dwayne", "duane", "dixon", "dicksonx", "", "a"]
    a = rng.choice(words, n)
    b = np.where(rng.random(n) < 0.4, a, rng.choice(words, n))

    def pack(values):
        s = np.zeros((n, width), np.uint8)
        for i, v in enumerate(values):
            s[i, :len(v)] = np.frombuffer(v.encode(), np.uint8)
        return s, np.array([len(v) for v in values], np.int32)

    return (*pack(a), *pack(b))


def test_exact_equal_and_jaro_winkler_batch_equal_the_reference():
    from splink_tpu.ops import strings as ref_strings
    from splink_tpu_torch.ops import strings

    s1, l1, s2, l2 = _padded(3)
    t = [torch.from_numpy(x) for x in (s1, s2, l1, l2)]
    want = np.asarray(ref_strings.exact_equal(*(jnp.asarray(x) for x in (s1, s2, l1, l2))))
    got = strings.exact_equal(*t)
    assert got.dtype == torch.bool and np.array_equal(got.numpy(), want)
    assert got.any() and not got.all()
    assert torch.equal(splink_tpu_torch.ops.exact_equal(*t), got)
    jw = strings.jaro_winkler_batch(*t)
    assert torch.equal(jw, strings.jaro_winkler(*t))
    ref_jw = np.asarray(ref_strings.jaro_winkler_batch(*(jnp.asarray(x) for x in (s1, s2, l1, l2))))
    assert np.array_equal(jw.numpy(), ref_jw)


def test_exported_names_match_the_reference():
    import splink_tpu.analysis as ref_analysis
    import splink_tpu.models as ref_models
    import splink_tpu.ops as ref_ops
    import splink_tpu.utils as ref_utils
    import splink_tpu_torch.analysis as analysis
    import splink_tpu_torch.models as models
    import splink_tpu_torch.utils as utils
    from splink_tpu_torch.analysis import rules, shard_audit

    assert splink_tpu_torch.__version__ == splink_tpu.__version__ == "0.1.0"
    assert {"__version__", "ops", "parallel"} <= set(splink_tpu_torch.__all__)
    assert splink_tpu_torch.ops.levenshtein is splink_tpu_torch.ops.strings.levenshtein
    assert analysis.rule is rules.rule
    # the package's update_baselines is the shard audit's, as in the reference
    assert analysis.update_baselines is shard_audit.update_baselines
    assert ref_analysis.update_baselines.__module__ == "splink_tpu.analysis.shard_audit"
    assert set(ref_models.__all__) <= set(models.__all__)
    assert set(ref_utils.__all__) == set(utils.__all__)
    singles = {"jaro_winkler_single", "levenshtein_single"}
    assert set(ref_ops.__all__) - singles <= set(splink_tpu_torch.ops.__all__)
    for name in models.__all__:
        assert getattr(models, name) is getattr(models.fellegi_sunter, name)


def test_constants_equal_the_reference():
    from splink_tpu.analysis import num_audit as ref_num
    from splink_tpu.analysis import perf_audit as ref_perf
    from splink_tpu.resilience import faults as ref_faults
    from splink_tpu_torch.analysis import num_audit, perf_audit
    from splink_tpu_torch.resilience import faults

    assert faults.SERVE_SITES == ref_faults.SERVE_SITES
    assert faults.BUILD_SITES == ref_faults.BUILD_SITES
    assert faults.WIRE_SITES == ref_faults.WIRE_SITES
    assert set(faults.SERVE_SITES + faults.BUILD_SITES + faults.WIRE_SITES) <= set(faults.SITES)
    assert perf_audit.TIME_KEYS == ref_perf.TIME_KEYS
    assert num_audit.NUM_EXCLUDED == ref_num.NUM_EXCLUDED == {}
