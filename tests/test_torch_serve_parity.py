"""The serving engine of splink_tpu_torch held to its own offline scores.

On the CPU, in float32 and float64, with the TF fold on and off: the fused
path equals the unfused oracle bit for bit, and every served probability
equals the port's offline ``match_probability`` (or
``tf_match_probability``) for the same pair bit for bit, covering every
offline pair (the engine's top-k exceeds the largest block). Also: blocks
with fewer valid candidates than k, warmup over the whole menu with no
kernel-library build after it, padding hygiene against garbage upload
buffers, the query frame, a legacy TF artifact without token ids,
``swap_index`` with probes and its rollbacks, and the options not ported.
"""

import copy
import logging
import shutil
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
def trained():
    """dtype -> (df_e, index) of a port linker trained on the CPU: the
    oracle of the serve-equals-offline checks."""
    import splink_tpu_torch

    out = {}
    for dtype in ("float32", "float64"):
        linker = splink_tpu_torch.Splink(
            engine_settings(float64=dtype == "float64"), df=people_df(), device="cpu")
        df_e = linker.get_scored_comparisons()
        out[dtype] = (df_e, linker.export_index())
    return out


def port_engine(index, tf=True, policy=POLICY, top_k=K, brownout=0, fused=None):
    from splink_tpu_torch.serve import BucketPolicy, QueryEngine

    return QueryEngine(index, top_k=top_k, policy=BucketPolicy(*policy),
                       tf_adjust=tf, brownout_top_k=brownout, fused=fused)


def assert_serve_equals_offline(df, df_e, index, out, col):
    """Every served (query, match) probability equals the offline frame's
    for the same pair bit for bit, and every offline pair is served."""
    top_p, top_rows, top_valid, _ = out
    offline = {(a, b): p for a, b, p in zip(df_e["unique_id_l"], df_e["unique_id_r"], df_e[col])}
    served = set()
    for q in range(len(df)):
        for r in np.flatnonzero(top_valid[q]):
            m = int(index.unique_id[top_rows[q, r]])
            if m == q:
                continue
            key = (min(q, m), max(q, m))
            assert offline[key] == top_p[q, r], key
            served.add(key)
    assert served == set(offline)


@pytest.mark.parametrize("tf", [True, False])
@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_fused_equals_unfused_bit_for_bit(trained, dtype, tf):
    index = trained[dtype][1]
    q = queries()
    a = port_engine(index, tf, fused=True).query_arrays(q)
    b = port_engine(index, tf, fused=False).query_arrays(q)
    for x, y in zip(a, b):
        assert x.dtype == y.dtype and np.array_equal(x, y)


@pytest.mark.parametrize("tf", [True, False])
@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_serve_equals_offline_bit_for_bit(trained, dtype, tf):
    df_e, index = trained[dtype]
    df = people_df()
    eng = port_engine(index, tf)
    out = eng.query_arrays(df)
    assert out[0].dtype == np.dtype(dtype)
    col = "tf_match_probability" if tf else "match_probability"
    assert_serve_equals_offline(df, df_e, index, out, col)


def test_short_candidate_rows_never_emit_sentinel_matches(trained):
    eng = port_engine(trained["float32"][1])
    top_p, top_rows, top_valid, n_cand = eng.query_arrays(queries())
    for q in range(len(top_p)):
        assert int(top_valid[q].sum()) == min(int(n_cand[q]), K)
        assert (top_p[q][top_valid[q]] >= 0).all()
        rows = top_rows[q][top_valid[q]]
        assert len(np.unique(rows)) == len(rows)


def test_warmup_runs_every_shape_and_builds_nothing(trained):
    from splink_tpu_torch.obs.metrics import compile_requests

    eng = port_engine(trained["float32"][1], policy=((8, 32), (64, 128)), brownout=2)
    stats = eng.warmup()
    assert stats["combinations"] == 4 + 2
    assert eng.warmed_shapes == {(8, 64), (8, 128), (32, 64), (32, 128)}
    assert eng.warmed_brownout_shapes == {(8, 64), (32, 64)}
    c0 = compile_requests()
    eng.query_arrays(queries().head(3))
    eng.query_arrays(queries().head(70))
    eng.query_arrays(queries().head(5), degraded=True)
    eng.probe()
    assert compile_requests() == c0


def test_padding_rows_never_reach_a_score(trained):
    """Garbage in the padding of the upload buffers (rows past n, their
    buckets) is zeroed on the device: a batch scores as if padded clean."""
    from splink_tpu_torch.serve.engine import encode_query

    packed = torch.full((8, 5), 7, dtype=torch.int32)
    qb = torch.full((2, 8), 3, dtype=torch.int32)
    encode_query(packed, qb, 3)
    assert (packed[3:] == 0).all() and (packed[:3] == 7).all()
    assert (qb[:, 3:] == -1).all() and (qb[:, :3] == 3).all()
    eng = port_engine(trained["float32"][1])
    clean = eng.query_arrays(queries().head(5))
    real_empty = np.empty

    def dirty(shape, dtype=float, **kw):
        out = real_empty(shape, dtype, **kw)
        out.fill(np.iinfo(dtype).max if np.dtype(dtype).kind in "iu" else 0)
        return out

    np.empty = dirty
    try:
        again = eng.query_arrays(queries().head(5))
    finally:
        np.empty = real_empty
    for a, b in zip(clean, again):
        assert np.array_equal(a, b)


def test_query_frame(trained):
    index = trained["float32"][1]
    q = queries().head(10)
    out = port_engine(index).query(q)
    assert list(out.columns) == ["unique_id_q", "unique_id_m", "rank",
                                 "match_probability", "n_candidates"]
    p, rows, valid, _ = port_engine(index).query_arrays(q)
    assert len(out) == int(valid.sum())
    assert set(out["unique_id_q"]) <= set(q["unique_id"])


def test_legacy_tf_index_without_tids_serves_unadjusted(trained, caplog):
    df_e, index = trained["float32"]
    stripped = copy.copy(index)
    stripped.tf_tids = {}
    stripped._tf_device = None
    stripped._device_state = None
    stripped._content_fp = None
    with caplog.at_level(logging.WARNING, logger="splink_tpu_torch"):
        eng = port_engine(stripped)
    assert not eng.tf_active
    assert any("UNADJUSTED" in r.message for r in caplog.records)
    assert_serve_equals_offline(people_df(), df_e, index, eng.query_arrays(people_df()),
                                "match_probability")


def test_swap_index_probes_commit_and_rollbacks(tmp_path, monkeypatch):
    import splink_tpu_torch
    from splink_tpu_torch.resilience import faults
    from splink_tpu_torch.serve import IndexSwapError, build_index
    from splink_tpu_torch.utils.logging_utils import DegradationWarning

    linker = splink_tpu_torch.Splink(engine_settings(), df=people_df(), device="cpu")
    linker.estimate_parameters()
    eng = port_engine(linker.export_index(), policy=((16,), (64,)))
    eng.warmup()
    q = queries().head(20)
    assert eng.capture_probes(q.head(6)) == 6
    before = eng.query_arrays(q)

    path2 = tmp_path / "idx2"
    linker.export_index(path2)
    stats = eng.swap_index(path2)
    assert stats["generation"] == 1 and stats["probes_checked"] == 6
    assert eng.index.device.type == "cpu"
    after = eng.query_arrays(q)
    for a, b in zip(before, after):
        assert np.array_equal(a, b)

    bad = tmp_path / "idx_bad"
    shutil.copytree(path2, bad)
    for p in bad.iterdir():
        if p.suffix == ".npz":
            payload = bytearray(p.read_bytes())
            payload[len(payload) // 2] ^= 0xFF
            p.write_bytes(bytes(payload))
    with pytest.warns(DegradationWarning, match="rolled_back|load"):
        with pytest.raises(IndexSwapError, match="load"):
            eng.swap_index(bad)
    assert eng.generation == 1

    faults.reset_plans()
    monkeypatch.setenv(faults.ENV_VAR, "swap_validate@")
    try:
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            with pytest.raises(IndexSwapError, match="injected"):
                eng.swap_index(path2)
    finally:
        monkeypatch.delenv(faults.ENV_VAR)
        faults.reset_plans()
    assert eng.generation == 1

    other = build_index(splink_tpu_torch.Splink(
        engine_settings(), df=people_df().head(50), device="cpu"))
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        with pytest.raises(IndexSwapError, match="parity"):
            eng.swap_index(other)
        assert eng.generation == 1
        stats = eng.swap_index(other, refresh_probes=True)
    assert stats["generation"] == 2 and eng.index.n_rows == 50
    assert eng.query_arrays(q)[2].any()


def test_unported_engine_options_raise(trained, tmp_path):
    from splink_tpu_torch.serve import QueryEngine

    index = trained["float32"][1]
    # the AOT sidecar is ported (Queue 1 item 13): aot_dir is accepted and
    # save_aot asks for a warm engine first
    assert QueryEngine(index, aot_dir=tmp_path)._aot_dir == str(tmp_path)
    with pytest.raises(RuntimeError, match="warmup"):
        port_engine(index).save_aot(tmp_path)
    # the drift sketch is ported: sketch=True over a profile-less index
    # serves unchanged, with no sketch (the reference's behaviour)
    assert QueryEngine(index, sketch=True).sketch is None
