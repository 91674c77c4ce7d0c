"""The approximate tier's serving fallback in splink_tpu_torch, on the CPU.

A model trained by splink_tpu on the clean half of the typo corpus (the
reference's tests/test_approx_blocking.py construction) is loaded from its
JSON by both packages, and each exports an index with ``approx_blocking``.
The garbled twins (every blocking key corrupted) are the fallback
queries: their exact keys hit no bucket, so they resolve their minhash
band keys instead. Held to the reference: the indexes (band CSRs,
dictionaries, IDF table and content fingerprint equal), the encoded
query batches (buckets and ``approx_used``), and the served answers (rows,
validity, candidate counts and ``approx`` flags equal; probabilities
within 4 float32 ulp, XLA's and PyTorch's log differing in the last ulp).
Held to the port's own offline tier: every served probability equals the
offline ``match_probability`` of the same pair bit for bit. Also the
artifact round trip and its cross-loading in both directions, the service's
``approx`` flag, an exact-only index without an approximate row, and the
TF-weighted tier sharing its IDF table between build and query.
"""

import copy
import json
import warnings

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)
pd = pytest.importorskip("pandas")

import splink_tpu  # noqa: E402
import splink_tpu_torch  # noqa: E402

N = 40
POLICY = ((64,), (64, 256))


def _corrupt(value: str, rng) -> str:
    k = int(rng.integers(0, len(value)))
    return value[:k] + "#" + value[k + 1:]


def typo_corpus(n=N, seed=7):
    rng = np.random.default_rng(seed)
    firsts = ["amelia", "oliver", "isla", "george", "ava", "noah", "emily"]
    lasts = ["smith", "jones", "taylor", "brown", "wilson", "evans"]
    base = pd.DataFrame({
        "unique_id": range(n),
        "first_name": [f"{rng.choice(firsts)}{k:02d}" for k in range(n)],
        "surname": [f"{rng.choice(lasts)}{k:02d}" for k in range(n)],
    })
    twins = base.copy()
    twins["unique_id"] = twins["unique_id"] + n
    crng = np.random.default_rng(seed + 1)
    twins["first_name"] = [_corrupt(v, crng) for v in twins["first_name"]]
    twins["surname"] = [_corrupt(v, crng) for v in twins["surname"]]
    return base, twins


def serve_settings(**over):
    s = {
        "link_type": "dedupe_only",
        "comparison_columns": [
            {"col_name": "first_name", "num_levels": 3},
            {"col_name": "surname", "num_levels": 2, "comparison": {"kind": "exact"}},
        ],
        "blocking_rules": ["l.first_name = r.first_name", "l.surname = r.surname"],
        "max_iterations": 3,
        "approx_blocking": True,
    }
    s.update(over)
    return s


def _setup(tmp_path_factory, **over):
    """(base, twins, model path, reference index, port index)."""
    base, twins = typo_corpus()
    d = tmp_path_factory.mktemp("model")
    path = str(d / "model.json")
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        trained = splink_tpu.Splink(serve_settings(**over), df=base)
        trained.get_scored_comparisons()
        trained.save_model_as_json(path)
        ref = splink_tpu.load_from_json(path, df=base)
        port = splink_tpu_torch.load_from_json(path, df=base, device="cpu")
        return base, twins, path, ref.export_index(), port.export_index()


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    return _setup(tmp_path_factory)


@pytest.fixture(scope="module")
def engines(setup):
    """(reference engine, port engine), each warmed."""
    from splink_tpu.serve import BucketPolicy as RefPolicy
    from splink_tpu.serve import QueryEngine as RefEngine

    from splink_tpu_torch.serve import BucketPolicy, QueryEngine

    _, _, _, ref_index, port_index = setup
    ref = RefEngine(ref_index, top_k=8, policy=RefPolicy(*POLICY))
    port = QueryEngine(port_index, top_k=8, policy=BucketPolicy(*POLICY))
    ref.warmup()
    port.warmup()
    return ref, port


def _close(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    ulp = np.spacing(np.maximum(np.abs(a), np.abs(b)).astype(np.float32))
    return np.abs(a - b) <= 4 * ulp.astype(np.float64)


def _assert_same_approx(a, b):
    assert a.approx.cols == b.approx.cols and a.approx.col_meta == b.approx.col_meta
    assert (a.approx.q, a.approx.bands, a.approx.rows_per_band) == (
        b.approx.q, b.approx.bands, b.approx.rows_per_band)
    assert (a.approx.idf is None) == (b.approx.idf is None)
    if a.approx.idf is not None:
        np.testing.assert_array_equal(np.asarray(a.approx.idf), np.asarray(b.approx.idf))
    for ba, bb in zip(a.approx.band_index, b.approx.band_index, strict=True):
        assert ba.bucket_of == bb.bucket_of
        for name in ("rows_sorted", "starts", "sizes", "row_bucket"):
            x, y = np.asarray(getattr(ba, name)), np.asarray(getattr(bb, name))
            assert x.dtype == y.dtype == np.int32, name
            np.testing.assert_array_equal(x, y, name)
    assert a.content_fingerprint() == b.content_fingerprint()


def test_index_equals_reference(setup):
    _, _, _, ref_index, port_index = setup
    assert port_index.approx is not None and port_index.approx.bands == 16
    assert port_index.approx.idf is None
    _assert_same_approx(ref_index, port_index)
    assert len(port_index.gather_units) == len(port_index.rules) + 16


def test_device_csr_equals_host_csr(setup, tmp_path):
    """device_blocking "on" builds the band CSRs through the device bucket
    CSR: the same arrays, the same fingerprint."""
    base, _, path, _, port_index = setup
    linker = splink_tpu_torch.load_from_json(path, df=base, device="cpu")
    linker.settings["device_blocking"] = "on"
    on = linker.export_index()
    _assert_same_approx(port_index, on)


def test_encode_queries_equal_reference(setup):
    base, twins, _, ref_index, port_index = setup
    q = pd.concat([base.head(8), twins], ignore_index=True)
    rb, pb = ref_index.encode_queries(q), port_index.encode_queries(q)
    np.testing.assert_array_equal(pb.qbuckets, rb.qbuckets)
    np.testing.assert_array_equal(pb.approx_used, rb.approx_used)
    assert pb.qbuckets.shape[0] == len(port_index.rules) + 16
    assert not pb.approx_used[:8].any() and pb.approx_used[8:].mean() > 0.9


def test_fallback_tagged_and_served_as_the_reference(setup, engines):
    base, twins, _, _, port_index = setup
    ref, port = engines
    res = port.query(twins)
    assert len(res) > 0 and "approx" in res.columns and res["approx"].all()
    found = {int(r["unique_id_q"]) - N for _, r in res.iterrows()
             if int(r["unique_id_m"]) == int(r["unique_id_q"]) - N}
    assert len(found) >= 0.95 * len(twins)
    assert not port.query(base.head(8))["approx"].any()
    want, got = [], []
    rp, rr, rv, rn = ref.query_arrays(twins, approx_out=want)
    gp, gr, gv, gn = port.query_arrays(twins, approx_out=got)
    np.testing.assert_array_equal(got[0], want[0])
    assert np.array_equal(rv, gv) and np.array_equal(rn, gn)
    np.testing.assert_array_equal(gr[gv], rr[rv])
    assert _close(rp[rv], gp[gv]).all()


def test_service_result_carries_the_approx_flag(setup, engines):
    from splink_tpu_torch.serve import LinkageService

    base, twins, _, _, _ = setup
    _, port = engines
    with LinkageService(port, deadline_ms=5.0) as svc:
        garbled = [svc.query(r, timeout=60) for r in twins.head(4).to_dict(orient="records")]
        clean = [svc.query(r, timeout=60) for r in base.head(4).to_dict(orient="records")]
    assert not any(r.shed for r in garbled + clean)
    assert all(r.approx and r.matches for r in garbled)
    assert not any(r.approx for r in clean)


def test_served_equals_offline_bit_for_bit(setup, engines):
    """The fallback's scores equal the port's offline scoring of the same
    pairs: a linker over base + twins with the trained parameters, whose
    approximate tier produces those pairs."""
    base, twins, path, _, port_index = setup
    _, port = engines
    combined = pd.concat([base, twins], ignore_index=True)
    oracle = splink_tpu_torch.load_from_json(path, df=combined, device="cpu")
    oracle.settings["approx_pair_budget"] = 100_000
    df_e = oracle.manually_apply_fellegi_sunter_weights()
    offline = {(int(a), int(b)): p for a, b, p in zip(
        df_e["unique_id_l"], df_e["unique_id_r"], df_e["match_probability"])}
    top_p, top_rows, top_valid, _ = port.query_arrays(twins)
    checked = 0
    for q in range(len(twins)):
        for r in np.flatnonzero(top_valid[q]):
            key = (int(port_index.unique_id[top_rows[q, r]]), q + N)
            if key in offline:
                assert offline[key] == top_p[q, r], key
                checked += 1
    assert checked >= len(twins)


def test_artifact_round_trip_and_cross_load(setup, engines, tmp_path):
    from splink_tpu.serve import load_index as ref_load

    from splink_tpu_torch.serve import BucketPolicy, QueryEngine, load_index

    _, twins, _, ref_index, port_index = setup
    _, port = engines
    port_index.save(tmp_path / "port")
    ref_index.save(tmp_path / "ref")
    again = load_index(tmp_path / "port", device="cpu")
    from_ref = load_index(tmp_path / "ref", device="cpu")
    ref_from_port = ref_load(tmp_path / "port")
    for other in (again, from_ref, ref_from_port):
        _assert_same_approx(port_index, other)
        b1, b2 = port_index.encode_queries(twins), other.encode_queries(twins)
        np.testing.assert_array_equal(b1.qbuckets, b2.qbuckets)
        np.testing.assert_array_equal(b1.approx_used, b2.approx_used)
    want = port.query_arrays(twins)
    got = QueryEngine(again, top_k=8, policy=BucketPolicy(*POLICY)).query_arrays(twins)
    for a, b in zip(want, got):
        assert a.dtype == b.dtype and np.array_equal(a, b)


def test_exact_only_index_has_no_approx_row(setup):
    from splink_tpu_torch.serve import BucketPolicy, QueryEngine

    base, twins, path, _, _ = setup
    plain = splink_tpu_torch.load_from_json(path, df=base, device="cpu")
    plain.settings["approx_blocking"] = False
    idx = plain.export_index()
    assert idx.approx is None
    batch = idx.encode_queries(twins.head(4))
    assert batch.qbuckets.shape[0] == len(idx.rules) and batch.approx_used is None
    res = QueryEngine(idx, top_k=8, policy=BucketPolicy(*POLICY)).query(base.head(4))
    assert "approx" not in res.columns


def test_weighted_tier_shares_its_idf(tmp_path_factory, tmp_path):
    """A TF-weighted index carries the IDF table of its corpus (equal to the
    reference's), round-trips it, and garbled queries recover their twins
    through the weighted fallback."""
    from splink_tpu_torch.approx.lsh import ApproxConfig, column_arrays
    from splink_tpu_torch.approx.minhash import gram_df_table, idf_weights
    from splink_tpu_torch.serve import BucketPolicy, QueryEngine, load_index

    base, twins, path, ref_index, port_index = _setup(
        tmp_path_factory, approx_tf_weighting=True, approx_threshold=0.2)
    assert port_index.approx.idf is not None
    _assert_same_approx(ref_index, port_index)
    linker = splink_tpu_torch.load_from_json(path, df=base, device="cpu")
    table = linker._ensure_encoded()
    cfg = ApproxConfig.from_settings(linker.settings, table)
    idf = idf_weights(*gram_df_table(column_arrays(table, cfg.cols), cfg.q, device="cpu"))
    np.testing.assert_array_equal(port_index.approx.idf, idf)
    port_index.save(tmp_path)
    loaded = load_index(tmp_path, device="cpu")
    np.testing.assert_array_equal(loaded.approx.idf, idf)
    assert loaded.content_fingerprint() == port_index.content_fingerprint()
    res = QueryEngine(loaded, top_k=8, policy=BucketPolicy(*POLICY)).query(twins)
    assert res["approx"].any()
    recovered = sum(((res["unique_id_q"] == uid) & (res["unique_id_m"] == uid - N)).any()
                    for uid in twins["unique_id"])
    assert recovered / len(twins) >= 0.9
    # the query side gathers the index's weights: a different table gives
    # other band keys
    from splink_tpu_torch.data import encode_table

    qtable = encode_table(twins, loaded.settings)
    rows = np.arange(len(twins))
    keys_w, _ = loaded._query_band_keys(qtable, rows)
    loaded.approx = copy.copy(loaded.approx)
    loaded.approx.idf = np.ones_like(idf)
    keys_flat, _ = loaded._query_band_keys(qtable, rows)
    assert not np.array_equal(keys_w, keys_flat)


def test_cli_build_reports_the_bands(setup, tmp_path):
    import contextlib
    import io

    from splink_tpu_torch.serve.__main__ import main as serve_main

    base, _, path, _, _ = setup
    base.to_csv(tmp_path / "ref.csv", index=False)
    with contextlib.redirect_stdout(io.StringIO()) as buf:
        assert serve_main(["build", "--model", path, "--data", str(tmp_path / "ref.csv"),
                           "--out", str(tmp_path / "idx"), "--device", "cpu"]) == 0
    out = json.loads(buf.getvalue().splitlines()[0])
    assert out["n_approx_bands"] == 16 and out["n_rules"] == 2
