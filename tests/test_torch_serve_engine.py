"""The query engine of splink_tpu_torch (serve/engine.py) against splink_tpu's.

In float32 and float64, fused and unfused, with the TF fold on and off and
in the brown-out tier, against the reference's QueryEngine (jit on the CPU)
over the artifact the reference saved: top-k rows, ``top_valid`` and
``n_candidates`` are equal, except among candidates whose reference scores
lie within the tolerance of each other; probabilities are within 4 ulp at
float32 and within 1e-12 relative at float64. The same holds for unseen
and null values, chunking past the largest query bucket and capacity
truncation with its degradation warning. The programs alone: the row-wise
top-k's tie order and the candidate gather equal the reference's. The
port's own parity (fused against unfused, serve against offline) is
tests/test_torch_serve_parity.py.
"""

import json
import warnings

import numpy as np
import pytest

torch = pytest.importorskip("torch")
pd = pytest.importorskip("pandas")

K = 64  # above the largest block: every offline pair is served
POLICY = ((128,), (64,))


def people_df(n=160, seed=11):
    rng = np.random.default_rng(seed)
    firsts = np.array(["amelia", "amelie", "oliver", "olivia", "isla", "george",
                       "ava", "noah", "emily", "émile", None], object)
    lasts = np.array(["smith"] * 6 + ["jones", "taylor", "zorn", "brown", None], object)
    cities = np.array(["london", "londen", "leeds", "luton", "lincoln", None], object)
    return pd.DataFrame({
        "unique_id": np.arange(n),
        "first_name": firsts[rng.integers(0, len(firsts), n)],
        "surname": lasts[rng.integers(0, len(lasts), n)],
        "city": cities[rng.integers(0, len(cities), n)],
        "dob": [f"19{rng.integers(40, 60)}" for _ in range(n)],
        "age": rng.integers(20, 30, n).astype(float),
    })


def engine_settings(**over):
    s = {
        "link_type": "dedupe_only",
        "comparison_columns": [
            {"col_name": "first_name", "num_levels": 3,
             "term_frequency_adjustments": True},
            {"col_name": "surname", "num_levels": 2,
             "comparison": {"kind": "exact"}, "term_frequency_adjustments": True},
            {"col_name": "city", "num_levels": 3,
             "comparison": {"kind": "levenshtein", "thresholds": [0.3, 0.6]}},
            {"col_name": "age", "num_levels": 3, "data_type": "numeric",
             "comparison": {"kind": "numeric_abs", "thresholds": [0.5, 3.0]}},
        ],
        "blocking_rules": ["l.dob = r.dob",
                           "l.surname = r.surname and substr(l.city,1,2) = substr(r.city,1,2)"],
        "max_iterations": 4,
    }
    s.update(over)
    return s


def queries():
    """120 reference rows (one query bucket: one compile per reference
    engine) with every third first name given a one-letter typo, an
    unseen value, nulls and a record that hits no bucket."""
    q = people_df().head(120)
    q["unique_id"] = q["unique_id"] + 1000
    names = q["first_name"].to_numpy(object)
    q["first_name"] = [v[:-1] + "x" if isinstance(v, str) and i % 3 == 0 else v
                       for i, v in enumerate(names)]
    q.loc[1, "surname"] = "zzyzx"
    q.loc[2, ["first_name", "age"]] = None
    q.loc[3, ["dob", "surname"]] = None
    return q


@pytest.fixture(scope="module")
def model_json(tmp_path_factory):
    import splink_tpu

    d = tmp_path_factory.mktemp("model")
    linker = splink_tpu.Splink(engine_settings(), df=people_df())
    linker.estimate_parameters()
    out = {"float32": str(d / "float32.json"), "float64": str(d / "float64.json")}
    linker.save_model_as_json(out["float32"])
    with open(out["float32"]) as fh:
        model = json.load(fh)
    model["settings"]["float64"] = True
    with open(out["float64"], "w") as fh:
        json.dump(model, fh)
    return out


@pytest.fixture(scope="module")
def artifacts(model_json, tmp_path_factory):
    """dtype -> (reference in-memory index, the port's load of the artifact
    the reference saved)."""
    import splink_tpu

    from splink_tpu_torch.serve import load_index

    d = tmp_path_factory.mktemp("idx")
    out = {}
    for dtype, path in model_json.items():
        ref = splink_tpu.load_from_json(path, df=people_df())
        index = ref.export_index(d / dtype)
        out[dtype] = (index, load_index(d / dtype, device="cpu"))
    return out


_REF_ENGINES: dict = {}


def ref_engine(artifacts, dtype, tf=True, policy=POLICY, top_k=K, brownout=0):
    """The reference's engine, cached per configuration (each compiles)."""
    from splink_tpu.serve import BucketPolicy, QueryEngine

    key = (dtype, tf, policy, top_k, brownout)
    if key not in _REF_ENGINES:
        _REF_ENGINES[key] = QueryEngine(
            artifacts[dtype][0], top_k=top_k, policy=BucketPolicy(*policy),
            tf_adjust=tf, brownout_top_k=brownout,
        )
    return _REF_ENGINES[key]


def port_engine(index, tf=True, policy=POLICY, top_k=K, brownout=0, fused=None):
    from splink_tpu_torch.serve import BucketPolicy, QueryEngine

    return QueryEngine(index, top_k=top_k, policy=BucketPolicy(*policy),
                       tf_adjust=tf, brownout_top_k=brownout, fused=fused)


def _close(a, b, dtype):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    if dtype == "float32":
        ulp = np.spacing(np.maximum(np.abs(a), np.abs(b)).astype(np.float32))
        return np.abs(a - b) <= 4 * ulp.astype(np.float64)
    return np.abs(a - b) <= 1e-12 * np.maximum(np.abs(a), np.abs(b))


def assert_matches_reference(ref, got, dtype):
    """Equal top_valid and n_candidates; probabilities within tolerance;
    equal rows except within runs of near-tied reference scores, where the
    runs' row sets are equal (a run reaching rank k-1 may continue past k,
    so its set is not checked)."""
    rp, rr, rv, rn = ref
    gp, gr, gv, gn = got
    assert gp.dtype == rp.dtype and gr.dtype == rr.dtype
    assert np.array_equal(rn, gn)
    assert np.array_equal(rv, gv)
    assert _close(rp[rv], gp[gv], dtype).all()
    k = rp.shape[1]
    for q in np.flatnonzero((rr != gr).any(axis=1)):
        r = 0
        while r < k:
            e = r + 1
            while e < k and rv[q, e] and _close(rp[q, e], rp[q, r], dtype):
                e += 1
            if e < k or not rv[q, k - 1]:
                assert set(rr[q, r:e][rv[q, r:e]]) == set(gr[q, r:e][gv[q, r:e]]), (q, r)
            r = e


@pytest.mark.parametrize("tf", [True, False])
@pytest.mark.parametrize("fused", [True, False])
@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_engine_matches_reference(artifacts, dtype, fused, tf):
    q = queries()
    ref = ref_engine(artifacts, dtype, tf).query_arrays(q)
    eng = port_engine(artifacts[dtype][1], tf, fused=fused)
    assert eng.tf_active == tf
    got = eng.query_arrays(q)
    assert_matches_reference(ref, got, dtype)


def test_unseen_and_null_query_values(artifacts):
    q = pd.DataFrame({
        "unique_id": [0, 1, 2],
        "first_name": ["zzyzx", None, "amelia"],
        "surname": ["smith", None, "unheard"],
        "city": ["london", None, "nowhere"],
        "dob": ["1945", None, "2030"],
        "age": [25.0, None, 21.0],
    })
    eng = port_engine(artifacts["float32"][1])
    got = eng.query_arrays(q)
    top_p, _, top_valid, n_cand = got
    assert n_cand[0] > 0 and top_valid[0].any()
    assert n_cand[1] == 0 and not top_valid[1].any() and (top_p[1] == -1).all()
    assert n_cand[2] == 0 and not top_valid[2].any()
    assert_matches_reference(ref_engine(artifacts, "float32").query_arrays(q), got, "float32")


def test_chunking_past_the_largest_query_bucket(artifacts):
    """40 queries through a 16-query bucket: three chunks whose rows equal
    the per-chunk results and the reference's."""
    policy = ((16,), (64,))
    eng = port_engine(artifacts["float32"][1], policy=policy)
    q = queries().head(40)
    whole = eng.query_arrays(q)
    head = eng.query_arrays(q.head(16))
    for a, b in zip(whole, head):
        assert np.array_equal(a[:16], b)
    assert eng.warmed_shapes == {(16, 64)}
    ref = ref_engine(artifacts, "float32", policy=policy).query_arrays(q)
    assert_matches_reference(ref, whole, "float32")


def test_capacity_truncation_warns_and_matches_reference(artifacts):
    from splink_tpu_torch.utils.logging_utils import DegradationWarning

    policy = ((128,), (4, 8))
    q = queries()
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        ref = ref_engine(artifacts, "float32", policy=policy, top_k=4).query_arrays(q)
    eng = port_engine(artifacts["float32"][1], policy=policy, top_k=4)
    with pytest.warns(DegradationWarning, match="truncated"):
        got = eng.query_arrays(q)
    assert (got[3] == 8).any(), "some block must fill the largest bucket"
    assert_matches_reference(ref, got, "float32")


@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_brownout_matches_reference(artifacts, dtype):
    q = queries()
    ref = ref_engine(artifacts, dtype, brownout=2)
    eng = port_engine(artifacts[dtype][1], brownout=2)
    assert eng.brownout_capacity == ref.brownout_capacity == 64
    got = eng.query_arrays(q, degraded=True)
    assert got[0].shape == (len(q), 2)
    assert_matches_reference(ref.query_arrays(q, degraded=True), got, dtype)
    assert eng.warmed_brownout_shapes == {(128, 64)}


def test_brownout_budget_validated(artifacts):
    index = artifacts["float32"][1]
    with pytest.raises(ValueError, match="serve_brownout_top_k"):
        port_engine(index, top_k=4, brownout=8)
    with pytest.raises(ValueError, match="serve_top_k"):
        port_engine(index, top_k=128)
    with pytest.raises(RuntimeError, match="disabled"):
        port_engine(index).query_arrays(queries().head(3), degraded=True)


@pytest.mark.parametrize("k", [1, 5, 16])
def test_top_k_tie_order_matches_reference(k):
    """Descending with ties by ascending slot, taken slots masked -2:
    values and indices equal the reference's, ties and the -1 invalid /
    -2 re-pick sentinels included."""
    import jax.numpy as jnp
    from splink_tpu.serve.engine import _top_k_rowwise as ref_topk

    from splink_tpu_torch.serve.engine import _top_k_rowwise

    rng = np.random.default_rng(k)
    scores = rng.choice(np.array([0.0, 0.25, 0.5, 1.0, -1.0], np.float32), (40, 24))
    scores[:5] = -1.0  # rows with no valid candidate
    want_v, want_i = ref_topk(jnp.asarray(scores), k)
    got_v, got_i = _top_k_rowwise(torch.from_numpy(scores), k)
    assert np.array_equal(np.asarray(want_v), got_v.numpy())
    assert np.array_equal(np.asarray(want_i), got_i.numpy())


def test_candidate_gather_matches_reference():
    """Three rules, one of them the all-null dummy CSR, buckets -1 and
    repeated rows across rules: candidates, validity and counts equal the
    reference's, slot for slot."""
    import jax.numpy as jnp
    from splink_tpu.serve.engine import make_candidate_gather_fn

    from splink_tpu_torch.serve.engine import candidate_gather

    rng = np.random.default_rng(3)
    n = 50
    units = []
    for n_buckets in (6, 9):
        row_bucket = rng.integers(-1, n_buckets, n).astype(np.int32)
        rows = np.flatnonzero(row_bucket >= 0)
        rows = rows[np.argsort(row_bucket[rows], kind="stable")].astype(np.int32)
        sizes = np.bincount(row_bucket[row_bucket >= 0], minlength=n_buckets).astype(np.int32)
        starts = (np.cumsum(sizes) - sizes).astype(np.int32)
        units.append((starts, sizes, rows, row_bucket))
    units.append((np.zeros(1, np.int32), np.zeros(1, np.int32), np.zeros(1, np.int32),
                  np.full(n, -1, np.int32)))
    qb = np.stack([rng.integers(-1, 6, 16), rng.integers(-1, 9, 16),
                   np.full(16, -1)]).astype(np.int32)
    for capacity in (8,):
        want = make_candidate_gather_fn(3, capacity)(
            jnp.asarray(qb), *[tuple(jnp.asarray(u[i]) for u in units) for i in range(4)])
        got = candidate_gather(
            torch.from_numpy(qb),
            *[tuple(torch.from_numpy(u[i].astype(np.int64)) for u in units) for i in range(4)],
            capacity)
        for w, g in zip(want, got):
            assert np.array_equal(np.asarray(w), g.numpy())


