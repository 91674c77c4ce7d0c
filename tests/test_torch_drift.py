"""The quality observatory of splink_tpu_torch (obs/quality.py, obs/drift.py)
held to splink_tpu's.

The oracle is splink_tpu's tests/test_drift.py, run here against the port
on the CPU (its four audit-registry tests belong to the analysis layer,
which the port does not carry). On top of it, the two packages side by
side on the same numpy-seeded inputs:

  * ``make_profile_fn`` and ``make_sketch_fn`` bit for bit against the
    reference's on the same gamma matrix and probabilities (the profile's
    probabilities are handed to both; the sketch takes them as input);
  * ``capture_profile`` and the engine's ``ServeSketch`` end to end against
    the reference for one model JSON and frame: equal wherever the two
    packages' probabilities fall in the same bin, and the probabilities
    agree within 4 ulp at float32 (tests/test_torch_em.py), so a pair
    within 4 ulp of a bin edge or of 0.5 may land one bin apart; such pairs
    are counted and bound the difference;
  * a profiled artifact written by either package loads in the other with
    equal profile arrays.
"""

import json

import numpy as np
import pandas as pd
import pytest

torch = pytest.importorskip("torch")

import splink_tpu  # noqa: E402
import splink_tpu_torch  # noqa: E402
from splink_tpu_torch.obs.cli import drift_events_report, summarize_events  # noqa: E402
from splink_tpu_torch.obs.drift import (  # noqa: E402
    DriftMonitor,
    WindowSketch,
    js_divergence,
    make_sketch_fn,
    no_reference_snapshot,
    psi,
)
from splink_tpu_torch.obs.events import register_ambient, unregister_ambient  # noqa: E402
from splink_tpu_torch.obs.exposition import (  # noqa: E402
    Sample,
    histogram_from_counts,
    render_samples,
)
from splink_tpu_torch.obs.flight import FlightRecorder  # noqa: E402
from splink_tpu_torch.obs.quality import (  # noqa: E402
    MATCH_PROBABILITY,
    QualityProfile,
    capture_profile,
    em_diagnostics,
    make_profile_fn,
)
from splink_tpu_torch.serve import (  # noqa: E402
    BucketPolicy,
    IndexMismatchError,
    LinkageService,
    QueryEngine,
    load_index,
)

POLICY = BucketPolicy((16, 64), (64, 256))


def twin_df(n_base=200, seed=11):
    """Base records plus one noisy duplicate each (the reference test's
    corpus): the duplicate keeps dob and surname, mutates first_name 10%
    of the time and city 30% of the time, so the matched population
    carries variance in the city channel."""
    rng = np.random.default_rng(seed)
    firsts = ["amelia", "oliver", "isla", "george", "ava", "noah", "emily",
              "jack", "poppy", "harry"]
    lasts = ["smith", "jones", "taylor", "brown", "wilson", "evans"]
    cities = ["london", "leeds", "york", "bath"]
    rows = []
    uid = 0
    for _ in range(n_base):
        fn = str(rng.choice(firsts))
        sn = str(rng.choice(lasts))
        dob = f"19{rng.integers(40, 99)}"
        city = str(rng.choice(cities))
        rows.append((uid, fn, sn, dob, city))
        uid += 1
        fn2 = fn if rng.random() < 0.9 else fn[:-1] + "x"
        city2 = city if rng.random() < 0.7 else str(rng.choice(cities))
        rows.append((uid, fn2, sn, dob, city2))
        uid += 1
    return pd.DataFrame(rows, columns=["unique_id", "first_name", "surname", "dob", "city"])


def drift_settings(**over):
    s = {
        "link_type": "dedupe_only",
        "comparison_columns": [
            {"col_name": "first_name", "num_levels": 3},
            {"col_name": "surname", "num_levels": 2, "comparison": {"kind": "exact"}},
            {"col_name": "city", "num_levels": 2, "comparison": {"kind": "exact"}},
        ],
        "blocking_rules": ["l.dob = r.dob"],
        "max_iterations": 10,
        "quality_profile": True,
        "drift_window_s": 0.5,
        "drift_alert_psi": 0.25,
    }
    s.update(over)
    return s


@pytest.fixture(scope="module")
def trained():
    df = twin_df()
    linker = splink_tpu_torch.Splink(drift_settings(), df=df, device="cpu")
    linker.get_scored_comparisons()
    index = linker.export_index()
    return df, linker, index


@pytest.fixture(scope="module")
def engine(trained):
    _, _, index = trained
    eng = QueryEngine(index, top_k=8, policy=POLICY)
    eng.warmup()
    return eng


@pytest.fixture(scope="module")
def model_json(tmp_path_factory):
    """A model trained by splink_tpu on the twin corpus, for both packages."""
    d = tmp_path_factory.mktemp("drift_model")
    linker = splink_tpu.Splink(drift_settings(), df=twin_df())
    linker.estimate_parameters()
    path = str(d / "model.json")
    linker.save_model_as_json(path)
    return path


@pytest.fixture(scope="module")
def both(model_json):
    """(ref linker, port linker) from one model JSON and frame, each scored
    with those parameters (no EM), and each package's profiled index."""
    df = twin_df()
    ref = splink_tpu.load_from_json(model_json, df=df)
    port = splink_tpu_torch.load_from_json(model_json, df=df, device="cpu")
    ref_out = ref.manually_apply_fellegi_sunter_weights()
    port_out = port.manually_apply_fellegi_sunter_weights()
    return ref, port, ref_out, port_out, ref.export_index(), port.export_index()


class _Capture:
    def __init__(self):
        self.events = []

    def emit(self, type, **fields):
        self.events.append({"type": type, **fields})

    def of(self, type):
        return [e for e in self.events if e["type"] == type]


@pytest.fixture()
def capture():
    cap = _Capture()
    register_ambient(cap)
    yield cap
    unregister_ambient(cap)


def _queries(df, n=64, state=3):
    return df.sample(n, random_state=state).drop(columns=["unique_id"]).reset_index(drop=True)


def _drive(engine, mon, df, n_batches, mutate=None, seed=7, step=1.0, clock=None):
    """Run query batches through the engine, draining one sketch window
    into the monitor per batch (the injected clock advances ``step``)."""
    rng = np.random.default_rng(seed)
    for i in range(n_batches):
        q = _queries(df, state=int(rng.integers(1 << 30)))
        if mutate is not None:
            mutate(q, i)
        engine.query(q)
        if clock is not None:
            clock[0] += step
        mon.observe(engine.drain_drift())


def _edge_pairs(p_a, p_b, bins):
    """Pairs whose score bin or matched flag differ between two
    probability vectors (the near-tie allowance)."""
    def key(p):
        return (np.clip((p * bins).astype(np.int64), 0, bins - 1), p >= MATCH_PROBABILITY)

    ba, ma = key(p_a)
    bb, mb = key(p_b)
    return int(((ba != bb) | (ma != mb)).sum())


# ---------------------------------------------------------------------------
# PSI / JS math
# ---------------------------------------------------------------------------


def test_psi_js_math():
    a = np.array([50, 30, 20])
    assert psi(a, a * 7) == pytest.approx(0.0, abs=1e-12)
    assert js_divergence(a, a * 3) == pytest.approx(0.0, abs=1e-12)
    b = np.array([20, 30, 50])
    d = psi(a, b)
    assert d is not None and d > 0
    assert psi(b, a) == pytest.approx(d)
    j = js_divergence(a, b)
    assert j is not None and 0 < j < 1
    assert js_divergence(a, b) == pytest.approx(js_divergence(b, a))
    c = np.array([0, 0, 100])
    e = np.array([100, 0, 0])
    assert np.isfinite(psi(c, e))
    assert js_divergence(c, e) == pytest.approx(1.0, abs=0.05)
    assert psi(np.zeros(3), b) is None
    assert psi(b, np.zeros(3)) is None
    assert js_divergence(np.zeros(3), np.zeros(3)) is None
    # the same statistics as the reference's, to the last bit
    from splink_tpu.obs import drift as ref_drift

    rng = np.random.default_rng(4)
    for _ in range(20):
        x, y = rng.integers(0, 50, 6), rng.integers(0, 50, 6)
        assert psi(x, y) == ref_drift.psi(x, y)
        assert js_divergence(x, y) == ref_drift.js_divergence(x, y)


# ---------------------------------------------------------------------------
# two-window alert state machine (synthetic windows, injected clock)
# ---------------------------------------------------------------------------


def _profile_2col(bins=8):
    gamma = np.array([[10, 60, 30, 0], [5, 45, 50, 0]], np.int64)
    score = np.linspace(10, 80, bins).astype(np.int64)
    return QualityProfile(
        columns=["a", "b"], num_levels=[3, 3], gamma_hist=gamma * 4,
        score_hist=score * 4, gamma_hist_matched=gamma, score_hist_matched=score,
        null_rates={"a": 0.1}, vocab_mass={}, n_pairs=int(gamma[0].sum()) * 4,
        n_rows=50,
    )


def _window(t, gamma, score, queries=10, score_all=None, **counters):
    c = {"queries": queries, "oov": 0, "exact_miss": 0, "approx_served": 0,
         "degraded": 0, "nulls": np.zeros(2, np.int64)}
    c.update(counters)
    return WindowSketch(t, np.asarray(gamma, np.int64), np.asarray(score, np.int64), c,
                        None if score_all is None else np.asarray(score_all, np.int64))


def test_two_window_alert_needs_both_windows():
    prof = _profile_2col()
    clock = [0.0]
    mon = DriftMonitor(prof, window_s=4.0, alert_psi=0.25, clock=lambda: clock[0])
    ref_g, ref_s = prof.gamma_hist_matched, prof.score_hist_matched
    drift_g = ref_g[:, ::-1].copy()
    for _ in range(16):
        clock[0] += 1.0
        mon.observe(_window(0, ref_g, ref_s, score_all=ref_s))
    assert mon.alerts() == []
    for _ in range(2):
        clock[0] += 1.0
        mon.observe(_window(0, drift_g, ref_s, score_all=ref_s))
    short = mon.window_drift(mon.window_s)
    assert short["channels"]["gamma:a"]["psi"] > 0.25
    assert mon.alerts() == [], "short-only drift must not alert"
    for _ in range(18):
        clock[0] += 1.0
        mon.observe(_window(0, drift_g, ref_s, score_all=ref_s))
    fired = mon.alerts()
    assert {a["channel"] for a in fired} >= {"gamma:a", "gamma:b"}
    a = fired[0]
    assert a["short_psi"] >= 0.25 and a["long_psi"] >= 0.25
    assert a["window_s"] == 4.0 and a["long_window_s"] == 20.0
    clock[0] += 100.0
    mon.observe(_window(0, np.zeros_like(ref_g), np.zeros_like(ref_s)))
    assert mon.alerts() == []


def test_yield_collapse_alert_catches_dark_psi():
    prof = _profile_2col()
    clock = [0.0]
    mon = DriftMonitor(prof, window_s=4.0, alert_psi=0.25, clock=lambda: clock[0])
    ref_g, ref_s = prof.gamma_hist_matched, prof.score_hist_matched
    zero_g, zero_s = np.zeros_like(ref_g), np.zeros_like(ref_s)
    for _ in range(16):
        clock[0] += 1.0
        mon.observe(_window(0, ref_g, ref_s, score_all=ref_s))
    for _ in range(5):
        clock[0] += 1.0
        mon.observe(_window(0, zero_g, zero_s, score_all=ref_s))
    short = mon.window_drift(mon.window_s)
    assert short["channels"]["gamma:a"]["psi"] is None
    assert short["match_yield"] == 0.0
    fired = mon.alerts()
    assert [a["channel"] for a in fired] == ["match_yield"]
    assert fired[0]["short_yield"] == 0.0 and fired[0]["long_yield"] > 0
    mon2 = DriftMonitor(prof, window_s=4.0, alert_psi=0.25, clock=lambda: clock[0])
    for _ in range(16):
        clock[0] += 1.0
        mon2.observe(_window(0, ref_g, ref_s, score_all=ref_s))
    for _ in range(5):
        clock[0] += 1.0
        mon2.observe(_window(0, zero_g, zero_s, score_all=zero_s, queries=20, oov=20))
    assert [a["channel"] for a in mon2.alerts()] == ["match_yield"]


def test_no_reference_states_are_first_class():
    mon = DriftMonitor(None)
    snap = mon.snapshot()
    assert snap["reference"] is False and "no reference profile" in snap["reason"]
    assert mon.alerts() == [] and mon.window_drift(60.0) is None
    assert no_reference_snapshot("because")["reason"] == "because"
    from splink_tpu.obs.drift import no_reference_snapshot as ref_nrs

    for reason in ("no reference profile", "drift sketching disabled (quality_profile off)"):
        assert no_reference_snapshot(reason) == ref_nrs(reason)
    prof = _profile_2col()
    legacy = QualityProfile.from_meta(prof.to_meta(), prof.gamma_hist, prof.score_hist)
    assert legacy.n_matched_pairs == 0
    clock = [0.0]
    mon2 = DriftMonitor(legacy, window_s=4.0, clock=lambda: clock[0])
    clock[0] += 1.0
    mon2.observe(_window(0, prof.gamma_hist_matched, prof.score_hist_matched,
                         score_all=prof.score_hist_matched))
    short = mon2.window_drift(4.0)
    assert all(v["psi"] is None for v in short["channels"].values())
    assert mon2.alerts() == []


# ---------------------------------------------------------------------------
# training-reference profile
# ---------------------------------------------------------------------------


def test_profile_captured_with_matched_twins(trained):
    _, linker, index = trained
    prof = index.profile
    assert prof is not None
    assert prof.columns == ["first_name", "surname", "city"]
    for c in range(3):
        assert int(prof.gamma_hist[c].sum()) == prof.n_pairs
    assert int(prof.score_hist.sum()) == prof.n_pairs
    assert 0 < prof.n_matched_pairs < prof.n_pairs
    for c in range(3):
        assert int(prof.gamma_hist_matched[c].sum()) == prof.n_matched_pairs
        assert (prof.gamma_hist_matched[c] <= prof.gamma_hist[c]).all()
    city = prof.gamma_counts_matched(2)
    assert city[1] > 0 and city[2] > 0
    assert set(prof.null_rates) >= {"first_name", "surname", "city"}
    assert prof.vocab_mass["first_name"]["n_tokens"] >= 10
    assert prof.n_rows == 400


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_profile_kernel_matches_host_oracle(dtype):
    """The port's profile function equals a straight numpy recount (both
    halves), and the reference's profile function bit for bit given the
    same G and p (the reference's p is handed to the port)."""
    import jax.numpy as jnp

    from splink_tpu.models.fellegi_sunter import FSParams
    from splink_tpu.models.fellegi_sunter import match_probability as ref_mp
    from splink_tpu.obs.quality import make_profile_fn as ref_make
    from splink_tpu_torch.models import fellegi_sunter as port_fs
    from splink_tpu_torch.params import fsparams_from_numpy

    rng = np.random.default_rng(5)
    G = rng.integers(-1, 3, size=(500, 2)).astype(np.int8)
    lam = dtype(0.3)
    m = np.array([[0.1, 0.2, 0.7], [0.2, 0.3, 0.5]], dtype)
    u = np.array([[0.7, 0.2, 0.1], [0.5, 0.3, 0.2]], dtype)
    params = fsparams_from_numpy(lam, m, u, device="cpu")
    bins = 8
    out = make_profile_fn((3, 3), bins)(torch.from_numpy(G), params).numpy()
    width, n_cols = 4, 2
    half = n_cols * width + bins
    p = port_fs.match_probability(torch.from_numpy(G), params).numpy()
    matched = p >= MATCH_PROBABILITY
    sbin = np.clip((p * bins).astype(np.int32), 0, bins - 1)
    for c in range(n_cols):
        g = G[:, c].astype(np.int64) + 1
        np.testing.assert_array_equal(out[c * width:(c + 1) * width],
                                      np.bincount(g, minlength=width))
        np.testing.assert_array_equal(out[half + c * width:half + (c + 1) * width],
                                      np.bincount(g[matched], minlength=width))
    np.testing.assert_array_equal(out[n_cols * width:half], np.bincount(sbin, minlength=bins))
    np.testing.assert_array_equal(out[half + n_cols * width:],
                                  np.bincount(sbin[matched], minlength=bins))
    # against the reference, p handed over: bit for bit
    ref_params = FSParams(lam=jnp.asarray(lam), m=jnp.asarray(m), u=jnp.asarray(u))
    want = np.asarray(ref_make((3, 3), bins)(jnp.asarray(G), ref_params))
    p_ref = np.asarray(ref_mp(jnp.asarray(G), ref_params))
    orig = port_fs.match_probability
    port_fs.match_probability = lambda G_, params_: torch.from_numpy(p_ref.copy())
    try:
        got = make_profile_fn((3, 3), bins)(torch.from_numpy(G), params).numpy()
    finally:
        port_fs.match_probability = orig
    np.testing.assert_array_equal(got, want.astype(np.int64))


def test_profile_fn_drops_out_of_range_indices():
    """A gamma outside the histogram is dropped, never clamped into the
    last bin (the reference's mode="drop"), and never an out-of-range
    scatter."""
    from splink_tpu_torch.params import fsparams_from_numpy

    params = fsparams_from_numpy(np.float32(0.3), np.full((1, 2), 0.5, np.float32),
                                 np.full((1, 2), 0.5, np.float32), device="cpu")
    G = torch.tensor([[0], [1], [-1], [40], [-7]], dtype=torch.int8)
    out = make_profile_fn((2,), 4)(G, params).numpy()
    size = 2 * (3 + 4)
    assert out.shape == (size,)
    # the column block counts the three in-range pairs; 40 and -7 land
    # outside the whole histogram (-7 + 1 < 0; 40 + 1 past size) and drop
    assert out[:3].tolist() == [1, 1, 1]
    assert int(out[3:7].sum()) == 5  # every pair has a score bin


def test_sentinel_histogram_counts_only_indices_in_range():
    from splink_tpu_torch.obs.quality import sentinel_histogram

    idx = torch.tensor([0, 0, 3, 4, 5, -1, 9, 2**40], dtype=torch.int64)
    assert sentinel_histogram(idx, 5).tolist() == [2, 0, 0, 1, 1]
    assert sentinel_histogram(idx[:0], 3).tolist() == [0, 0, 0]


def test_profileless_build_when_quality_profile_off():
    df = twin_df(n_base=30)
    linker = splink_tpu_torch.Splink(drift_settings(quality_profile=False, max_iterations=2),
                                     df=df, device="cpu")
    linker.get_scored_comparisons()
    index = linker.export_index()
    assert index.profile is None
    eng = QueryEngine(index, top_k=4, policy=BucketPolicy((16,), (64,)))
    assert eng.sketch is None
    assert eng.drain_drift() is None and not eng.drift_drain_due(0.0)


def test_capture_profile_matches_reference(both):
    """capture_profile of both packages from one model JSON and frame:
    equal gamma histograms wherever the pairs' score bins agree; every
    difference is bounded by the pairs within the near-tie allowance."""
    ref, port, ref_out, port_out, ref_index, port_index = both
    rp, pp = ref_index.profile, port_index.profile
    assert rp.columns == pp.columns and rp.num_levels == pp.num_levels
    assert rp.n_pairs == pp.n_pairs == len(port_out)
    assert rp.null_rates == pp.null_rates and rp.vocab_mass == pp.vocab_mass
    np.testing.assert_array_equal(rp.gamma_hist, pp.gamma_hist)
    near = _edge_pairs(ref_out["match_probability"].to_numpy(),
                       port_out["match_probability"].to_numpy(), rp.bins)
    for a, b in ((rp.score_hist, pp.score_hist),
                 (rp.gamma_hist_matched, pp.gamma_hist_matched),
                 (rp.score_hist_matched, pp.score_hist_matched)):
        assert int(np.abs(a - b).sum()) <= 2 * near, (a, b, near)
    # the capture equals a host recount from the port's own G and p
    p = port_out["match_probability"].to_numpy()
    sbin = np.clip((p * rp.bins).astype(np.int64), 0, rp.bins - 1)
    np.testing.assert_array_equal(pp.score_hist, np.bincount(sbin, minlength=rp.bins))
    matched = p >= MATCH_PROBABILITY
    np.testing.assert_array_equal(pp.score_hist_matched,
                                  np.bincount(sbin[matched], minlength=rp.bins))
    # the resident device copy and the host matrix give the same capture
    port._G_dev = torch.from_numpy(port._G)
    try:
        again = capture_profile(port)
    finally:
        port._G_dev = None
    np.testing.assert_array_equal(again.gamma_hist_matched, pp.gamma_hist_matched)


def test_capture_profile_pattern_regime_matches_resident(model_json):
    """Past max_resident_pairs the pattern regime's weighted host
    histograms equal the resident capture of the same pairs."""
    df = twin_df()
    res = splink_tpu_torch.load_from_json(model_json, df=df, device="cpu")
    res.manually_apply_fellegi_sunter_weights()
    pat = splink_tpu_torch.load_from_json(model_json, df=df, device="cpu")
    pat.settings.update(max_resident_pairs=1024, device_pair_generation="off")
    pat.manually_apply_fellegi_sunter_weights()
    assert pat._G is None and pat._pattern_counts is not None
    a, b = capture_profile(res), capture_profile(pat)
    for name in ("gamma_hist", "score_hist", "gamma_hist_matched", "score_hist_matched"):
        np.testing.assert_array_equal(getattr(a, name), getattr(b, name))
    assert a.n_pairs == b.n_pairs


# ---------------------------------------------------------------------------
# LinkageIndex persistence
# ---------------------------------------------------------------------------


def test_profiled_index_round_trip_fingerprint_covered(tmp_path, trained):
    _, linker, index = trained
    path = tmp_path / "idx"
    linker.export_index(path)
    index2 = load_index(path, device="cpu")
    prof, prof2 = index.profile, index2.profile
    assert prof2 is not None
    for name in ("gamma_hist", "score_hist", "gamma_hist_matched", "score_hist_matched"):
        np.testing.assert_array_equal(getattr(prof, name), getattr(prof2, name))
    assert prof2.to_meta() == prof.to_meta()
    (npz_path,) = path.glob("*.npz")
    blob = bytearray(npz_path.read_bytes())
    blob[len(blob) // 2] ^= 0xFF
    npz_path.write_bytes(bytes(blob))
    with pytest.raises(IndexMismatchError):
        load_index(path, device="cpu")


@pytest.mark.parametrize("writer", ["splink_tpu", "splink_tpu_torch"])
def test_profiled_artifact_loads_in_both_packages(both, tmp_path, writer):
    """A profiled artifact written by either package loads in the other
    with equal profile arrays and meta, and equal content fingerprints."""
    _, _, _, _, ref_index, port_index = both
    src = ref_index if writer == "splink_tpu" else port_index
    path = tmp_path / writer
    src.save(path)
    ref_loaded = splink_tpu.serve.load_index(path)
    port_loaded = load_index(path, device="cpu")
    for loaded in (ref_loaded, port_loaded):
        for name in ("gamma_hist", "score_hist", "gamma_hist_matched", "score_hist_matched"):
            np.testing.assert_array_equal(getattr(loaded.profile, name),
                                          getattr(src.profile, name))
        assert loaded.profile.to_meta() == src.profile.to_meta()
    assert ref_loaded.content_fingerprint() == port_loaded.content_fingerprint()


def test_legacy_profileless_index_loads_and_serves(tmp_path, trained):
    df, linker, index = trained
    path = tmp_path / "idx"
    linker.export_index(path)
    legacy = load_index(path, device="cpu")
    legacy.profile = None
    legacy_dir = tmp_path / "legacy"
    legacy.save(legacy_dir)
    index3 = load_index(legacy_dir, device="cpu")
    assert index3.profile is None
    meta = json.loads((legacy_dir / "linkage_index.json").read_text())
    assert meta["profile"] is None
    eng = QueryEngine(index3, top_k=8, policy=POLICY)
    assert eng.sketch is None
    eng.warmup()
    q = _queries(df, n=16)
    base = QueryEngine(index, top_k=8, policy=POLICY)
    base.warmup()
    for x, y in zip(base.query_arrays(q), eng.query_arrays(q)):
        assert np.array_equal(x, y)
    svc = LinkageService(eng, deadline_ms=2.0, flight_records=0)
    try:
        snap = svc.drift_snapshot()
        assert snap == {"reference": False, "reason": "no reference profile", "alerts": []}
    finally:
        svc.close()
    # a profiled index with quality_profile off reports the other reason
    off = QueryEngine(index, top_k=8, policy=POLICY, sketch=False)
    svc = LinkageService(off, deadline_ms=2.0, flight_records=0, autostart=False)
    assert svc.drift_snapshot()["reason"] == "drift sketching disabled (quality_profile off)"


# ---------------------------------------------------------------------------
# serve-time sketch
# ---------------------------------------------------------------------------


def test_sketch_parity_with_returned_results(trained, engine):
    df, _, index = trained
    engine.drain_drift()
    res = engine.query(_queries(df))
    w = engine.drain_drift()
    prof = index.profile
    p = res["match_probability"].to_numpy()
    bins = prof.bins
    sbin = np.clip((p.astype(np.float32) * bins).astype(np.int64), 0, bins - 1)
    np.testing.assert_array_equal(w.score_all, np.bincount(sbin, minlength=bins))
    matched = p.astype(np.float32) >= MATCH_PROBABILITY
    np.testing.assert_array_equal(w.score, np.bincount(sbin[matched], minlength=bins))
    n_matched = int(matched.sum())
    assert n_matched > 0
    for c in range(len(prof.columns)):
        assert int(w.gamma[c].sum()) == n_matched
    w2 = engine.drain_drift()
    assert int(w2.gamma.sum()) == 0 and int(w2.score_all.sum()) == 0


def test_sketch_gamma_counts_equal_host_oracle(trained, engine):
    """The drained gamma counts equal the returned top-k's gamma levels
    recomputed through the shared ``_spec_gamma`` on the host rows,
    counted on the host (matched winners only)."""
    from splink_tpu_torch.gammas import PairContext, _spec_gamma

    df, _, index = trained
    engine.drain_drift()
    q = _queries(df, n=40, state=9)
    top_p, top_rows, top_valid, _ = engine.query_arrays(q)
    w = engine.drain_drift()
    qi, ki = np.nonzero(top_valid & (top_p >= MATCH_PROBABILITY))
    assert len(qi)
    rows_q = index.encode_queries(q).packed[qi]
    rows_r = index.packed[top_rows[qi, ki]]
    ctx = PairContext(index.layout, torch.from_numpy(rows_q.view(np.int32)),
                      torch.from_numpy(rows_r.view(np.int32)))
    width = max(index.profile.num_levels) + 1
    for c, col in enumerate(index.settings["comparison_columns"]):
        g = _spec_gamma(col, ctx, False).numpy().astype(np.int64) + 1
        np.testing.assert_array_equal(w.gamma[c], np.bincount(g, minlength=width))


def test_sketch_fn_matches_reference(both):
    """make_sketch_fn of both packages on the same packed rows, top-k rows,
    valid flags and probabilities: equal accumulators, bit for bit."""
    import jax.numpy as jnp

    from splink_tpu.obs.drift import make_sketch_fn as ref_make

    _, _, _, _, ref_index, port_index = both
    df = twin_df()
    q = _queries(df, n=24, state=5)
    qp = port_index.encode_queries(q).packed
    np.testing.assert_array_equal(qp, ref_index.encode_queries(q).packed)
    np.testing.assert_array_equal(port_index.packed, ref_index.packed)
    rng = np.random.default_rng(8)
    k, bins = 6, port_index.profile.bins
    top_rows = rng.integers(0, port_index.n_rows, (len(q), k)).astype(np.int32)
    top_valid = rng.random((len(q), k)) < 0.8
    top_p = rng.random((len(q), k)).astype(np.float32)
    top_p[:, 0] = 0.5  # the matched edge
    top_p[:, 1] = 1.0  # the last score bin
    cols = port_index.settings["comparison_columns"]
    size = len(cols) * 4 + 2 * bins
    want = np.asarray(ref_make(ref_index.layout, tuple(ref_index.settings["comparison_columns"]),
                               bins)(jnp.zeros(size, jnp.int32), jnp.asarray(qp),
                                     jnp.asarray(ref_index.packed), jnp.asarray(top_rows),
                                     jnp.asarray(top_valid), jnp.asarray(top_p)))
    got = make_sketch_fn(port_index.layout, cols, bins)(
        torch.zeros(size, dtype=torch.int64), torch.from_numpy(qp.view(np.int32)),
        torch.from_numpy(port_index.packed.view(np.int32)), torch.from_numpy(top_rows),
        torch.from_numpy(top_valid), torch.from_numpy(top_p)).numpy()
    np.testing.assert_array_equal(got, want.astype(np.int64))
    assert int(got.sum()) > 0


def test_serve_sketch_matches_reference_end_to_end(both):
    """One query batch through both packages' sketching engines over the
    same model and frame: equal answers' sketches, within the near-tie
    allowance on the probabilities."""
    from splink_tpu.serve import BucketPolicy as RefPolicy
    from splink_tpu.serve import QueryEngine as RefEngine

    _, _, _, _, ref_index, port_index = both
    q = _queries(twin_df(), n=48, state=12)
    ref_eng = RefEngine(ref_index, top_k=8, policy=RefPolicy((64,), (64,)))
    port_eng = QueryEngine(port_index, top_k=8, policy=BucketPolicy((64,), (64,)))
    assert ref_eng.sketch is not None and port_eng.sketch is not None
    rp = ref_eng.query_arrays(q)
    pp = port_eng.query_arrays(q)
    np.testing.assert_array_equal(rp[1], pp[1])
    np.testing.assert_array_equal(rp[2], pp[2])
    rw, pw = ref_eng.drain_drift(), port_eng.drain_drift()
    valid = pp[2]
    near = _edge_pairs(rp[0][valid], pp[0][valid], port_index.profile.bins)
    for name in ("gamma", "score", "score_all"):
        a, b = getattr(rw, name), getattr(pw, name)
        assert a.shape == b.shape
        assert int(np.abs(a - b).sum()) <= 2 * near * len(port_index.profile.columns), name
    assert rw.counters["queries"] == pw.counters["queries"] == 48
    for key in ("oov", "exact_miss", "approx_served", "degraded"):
        assert rw.counters[key] == pw.counters[key], key
    np.testing.assert_array_equal(rw.counters["nulls"], pw.counters["nulls"])


def test_sketch_counts_oov_and_null_queries(trained, engine):
    df, _, index = trained
    engine.drain_drift()
    q = _queries(df, n=16)
    q.loc[q.index[:4], "city"] = None
    q.loc[q.index[:2], "dob"] = "2099"
    engine.query(q)
    w = engine.drain_drift()
    assert w.counters["queries"] == 16
    assert w.counters["oov"] >= 2
    assert w.counters["exact_miss"] >= 2
    assert w.counters["nulls"][index.profile.columns.index("city")] == 4


def test_sketch_steady_state_builds_nothing(trained, engine):
    """Sketching adds no kernel-library build after warmup (the port's
    counterpart of the reference's zero-recompile gate) and no change to
    the answers."""
    from splink_tpu_torch.obs.metrics import compile_requests

    df, _, index = trained
    engine.query(_queries(df, n=8))
    engine.query(_queries(df, n=40))
    engine.drain_drift()
    before = compile_requests()
    q = _queries(df, n=40, state=6)
    on = engine.query_arrays(q)
    engine.drain_drift()
    assert compile_requests() == before
    off = QueryEngine(index, top_k=8, policy=POLICY, sketch=False)
    assert off.sketch is None
    for a, b in zip(on, off.query_arrays(q)):
        np.testing.assert_array_equal(a, b)


def test_sketch_warm_covers_every_bucket(trained):
    from splink_tpu_torch.obs.metrics import compile_requests

    _, _, index = trained
    eng = QueryEngine(index, top_k=8, policy=BucketPolicy((16,), (64, 256)))
    assert eng.sketch is not None
    eng.warmup()
    w = eng.drain_drift()
    assert int(w.gamma.sum()) == 0 and int(w.score_all.sum()) == 0, \
        "dummy warm dispatches must not count"
    before = compile_requests()
    eng.query(_queries(twin_df(n_base=20), n=8, state=2))
    assert compile_requests() == before
    w = eng.drain_drift()
    assert w.counters["queries"] == 8 and int(w.score_all.sum()) > 0


def test_brownout_batches_count_degraded_not_histograms(trained):
    _, _, index = trained
    eng = QueryEngine(index, top_k=8, policy=POLICY, brownout_top_k=2)
    eng.query_arrays(_queries(trained[0], n=10), degraded=True)
    w = eng.drain_drift()
    assert w.counters["degraded"] == 10 and w.counters["queries"] == 0
    assert int(w.score_all.sum()) == 0


# ---------------------------------------------------------------------------
# end-to-end drift scoring against live serve traffic
# ---------------------------------------------------------------------------


def test_clean_stream_stays_below_threshold(trained, engine):
    df, _, index = trained
    engine.drain_drift()
    clock = [0.0]
    mon = DriftMonitor(index.profile, window_s=10.0, alert_psi=0.25, clock=lambda: clock[0])
    _drive(engine, mon, df, 12, clock=clock)
    snap = mon.snapshot()
    assert snap["reference"] is True
    assert snap["short"]["max_psi"] < 0.25
    assert snap["alerts"] == []
    assert snap["short"]["match_yield"] > 0.1


def test_city_drift_fires_psi_alert(trained, engine):
    df, _, index = trained
    engine.drain_drift()
    clock = [0.0]
    mon = DriftMonitor(index.profile, window_s=10.0, alert_psi=0.25, clock=lambda: clock[0])
    _drive(engine, mon, df, 12, clock=clock, mutate=lambda q, i: q.__setitem__("city", None))
    snap = mon.snapshot()
    ch = snap["short"]["channels"]
    assert ch["gamma:city"]["psi"] > 2.5
    assert ch["gamma:first_name"]["psi"] < 0.25
    assert "gamma:city" in {a["channel"] for a in snap["alerts"]}
    assert snap["short"]["null_rates"]["city"] == 1.0


def test_catastrophic_drift_fires_yield_collapse(trained, engine):
    df, _, index = trained
    engine.drain_drift()
    clock = [0.0]
    mon = DriftMonitor(index.profile, window_s=4.0, alert_psi=0.25, clock=lambda: clock[0])

    def garble(q, i):
        if i >= 14:
            q["first_name"] = "zz" + q["first_name"].str.slice(2)
            q["surname"] = "qq" + q["surname"].str.slice(2)

    _drive(engine, mon, df, 20, clock=clock, mutate=garble)
    snap = mon.snapshot()
    assert [a["channel"] for a in snap["alerts"]] == ["match_yield"]
    assert snap["short"]["match_yield"] == 0.0
    assert snap["long"]["match_yield"] > 0.2


# ---------------------------------------------------------------------------
# service wiring
# ---------------------------------------------------------------------------


def _service(engine, **over):
    kw = dict(deadline_ms=2.0, watchdog_interval_s=0.02, flight_records=0)
    kw.update(over)
    return LinkageService(engine, **kw)


def test_service_publishes_drift_windows_and_snapshot(trained, engine, capture):
    df, _, _ = trained
    engine.drain_drift()
    svc = _service(engine)
    try:
        for rec in df.head(24).to_dict(orient="records"):
            rec.pop("unique_id")
            svc.query(rec, timeout=10.0)
        svc._drift_tick(force=True)
        snap = svc.drift_snapshot()
        assert snap["reference"] is True
        assert snap["alert_active"] is False
        assert snap["windows_observed"] >= 1
        stats = svc.fleet_stats()
        assert stats["drift"]["counters"]["queries"] >= 1
    finally:
        svc.close()
    windows = capture.of("drift_window")
    assert windows
    ev = windows[-1]
    assert ev["queries"] >= 1 and "max_psi" in ev and "match_yield" in ev
    by_name = {s.name for s in svc.prometheus_samples()
               if s.name.startswith("splink_serve_drift")}
    assert "splink_serve_drift_reference" in by_name
    assert "splink_serve_drift_alert" in by_name


def test_service_alert_edges_publish_and_dump_flight(trained, engine, capture, tmp_path):
    df, _, index = trained
    engine.drain_drift()
    svc = _service(engine)
    rec = FlightRecorder(16, dump_dir=str(tmp_path), name=svc.name)
    register_ambient(rec)
    try:
        clock = [0.0]
        mon = DriftMonitor(index.profile, window_s=4.0, alert_psi=0.25, clock=lambda: clock[0])
        svc._drift = mon
        _drive(engine, mon, df, 16, clock=clock)
        svc._evaluate_drift_alerts(mon)
        assert capture.of("drift_alert") == []
        _drive(engine, mon, df, 5, clock=clock, mutate=lambda q, i: (
            q.__setitem__("first_name", "zz" + q["first_name"].str.slice(2)),
            q.__setitem__("surname", "qq" + q["surname"].str.slice(2)),
        ))
        svc._evaluate_drift_alerts(mon)
        svc._evaluate_drift_alerts(mon)
        alerts = capture.of("drift_alert")
        assert len(alerts) == 1
        assert alerts[0]["replica"] == svc.name
        assert svc.drift_snapshot()["alert_active"] is True
        assert len(rec.dumps) == 1
        dumped = [json.loads(line) for line in open(rec.dumps[0], encoding="utf-8")]
        assert any(e.get("type") == "drift_alert" for e in dumped)
        clock[0] += 200.0
        mon.observe(engine.drain_drift())
        svc._evaluate_drift_alerts(mon)
        assert len(capture.of("drift_clear")) == 1
        assert svc.drift_snapshot()["alert_active"] is False
    finally:
        unregister_ambient(rec)
        rec.close()
        svc.close()


def test_service_telemetry_dir_receives_the_alert_dump(trained, tmp_path):
    """With telemetry_dir in the index's settings, the service's own flight
    recorder dumps there when a drift alert fires."""
    df, _, index = trained
    index.settings["telemetry_dir"] = str(tmp_path)
    try:
        eng = QueryEngine(index, top_k=8, policy=POLICY)
        svc = _service(eng, flight_records=64, autostart=False)
    finally:
        index.settings["telemetry_dir"] = None
    try:
        clock = [0.0]
        mon = DriftMonitor(index.profile, window_s=4.0, alert_psi=0.25, clock=lambda: clock[0])
        svc._drift = mon
        _drive(eng, mon, df, 5, clock=clock, mutate=lambda q, i: q.__setitem__("city", None))
        svc._evaluate_drift_alerts(mon)
        assert svc.drift_snapshot()["alert_active"] is True
        dumps = list(tmp_path.glob("*.jsonl"))
        assert len(dumps) == 1
    finally:
        svc.close()


def test_swap_rebinds_drift_monitor(trained, tmp_path):
    df, linker, index = trained
    eng = QueryEngine(index, top_k=8, policy=BucketPolicy((16,), (64, 256)))
    eng.warmup()
    svc = _service(engine=eng)
    try:
        for rec in df.head(4).to_dict(orient="records"):
            rec.pop("unique_id")
            svc.query(rec, timeout=10.0)
        svc._drift_tick(force=True)
        old_mon = svc._drift
        assert old_mon is not None and old_mon.windows_observed >= 1
        path = tmp_path / "swap_idx"
        linker.export_index(path)
        svc.swap_index(str(path), refresh_probes=True)
        assert svc._drift is not old_mon
        assert svc._drift.windows_observed == 0
        assert svc.drift_snapshot()["reference"] is True
        assert eng.sketch is not None and eng.sketch.index is eng.index
    finally:
        svc.close()


# ---------------------------------------------------------------------------
# Prometheus exposition
# ---------------------------------------------------------------------------


def test_histogram_from_counts_math():
    h = histogram_from_counts("demo_hist", [2, 0, 3], [0.25, 0.5, 1.0], {"r": "a"}, "demo")
    assert h.buckets == [(0.25, 2.0), (0.5, 2.0), (1.0, 5.0)]
    assert h.count == 5.0
    assert h.sum == pytest.approx(2 * 0.125 + 3 * 0.75)


def test_render_samples_histogram_scrape_format():
    out = render_samples([
        Sample("demo_gauge", 1.5, {}, "gauge", "a gauge"),
        histogram_from_counts("demo_hist", [2, 0, 3], [0.25, 0.5, 1.0], {"replica": "a"},
                              "a histogram"),
    ])
    lines = out.splitlines()
    assert "# TYPE demo_hist histogram" in lines
    assert 'demo_hist_bucket{le="1",replica="a"} 5' in lines
    assert 'demo_hist_bucket{le="+Inf",replica="a"} 5' in lines
    assert 'demo_hist_count{replica="a"} 5' in lines
    assert "demo_gauge 1.5" in lines
    assert out.count("# TYPE demo_hist") == 1


def test_service_exposes_drift_score_histogram(trained, engine):
    df, _, _ = trained
    engine.drain_drift()
    svc = _service(engine)
    try:
        for rec in df.head(12).to_dict(orient="records"):
            rec.pop("unique_id")
            svc.query(rec, timeout=10.0)
        svc._drift_tick(force=True)
        text = render_samples(svc.prometheus_samples())
    finally:
        svc.close()
    assert "# TYPE splink_serve_drift_score histogram" in text
    assert 'splink_serve_drift_score_bucket{le="+Inf"' in text
    assert "splink_serve_drift_psi{" in text
    assert "splink_serve_drift_match_yield{" in text


# ---------------------------------------------------------------------------
# CLI renderers: torn-record tolerance
# ---------------------------------------------------------------------------


_TORN_EVENTS = [
    {"type": "quality_profile"},
    {"type": "quality_profile", "columns": ["a"], "n_pairs": 10, "n_rows": 5, "bins": 4,
     "null_rates": {"a": None}},
    {"type": "drift_window", "replica": "r0"},
    {"type": "drift_window", "replica": "r0", "window_s": 5, "queries": 7, "pairs": 3,
     "max_psi": 0.5, "channels": {"gamma:a": 0.5, "score": None}, "oov_rate": None,
     "match_yield": None},
    {"type": "drift_alert"},
    {"type": "drift_alert", "replica": "r0", "alerts": [{}]},
    {"type": "drift_alert", "replica": "r0",
     "alerts": [{"channel": "gamma:a", "short_psi": 0.6, "long_psi": 0.5,
                 "threshold": 0.25, "window_s": 5, "long_window_s": 25}]},
    {"type": "drift_alert", "replica": "r0",
     "alerts": [{"channel": "match_yield", "short_yield": 0.0, "long_yield": 0.8,
                 "threshold": 4.0}]},
    {"type": "drift_clear", "replica": "r0"},
    {"type": "em_diagnostics"},
    {"type": "em_diagnostics", "lam": None, "columns": [
        {"name": "a", "num_levels": 2, "m": [0.5], "u": None, "log2_bf": [None, 1.0],
         "support": None, "warnings": ["w"]}], "warnings": ["a: w"]},
]


def test_summarize_renders_torn_drift_records():
    out = summarize_events(list(_TORN_EVENTS))
    assert "quality profile" in out
    assert "drift:" in out
    assert "ALERT gamma:a" in out
    assert "ALERT match_yield" in out and "yield 0.0/0.8" in out
    assert "alert cleared" in out
    assert "EM diagnostics" in out


def test_drift_report_renders_torn_records():
    out = drift_events_report(list(_TORN_EVENTS))
    assert "reference profile: 1 column(s)" in out
    assert "replica r0" in out
    assert "gamma:a" in out
    assert "ALERT match_yield" in out
    assert "cleared" in out
    assert "no drift events" in drift_events_report([])


def test_drift_report_on_real_service_record(trained, engine, capture):
    df, _, _ = trained
    engine.drain_drift()
    svc = _service(engine)
    try:
        for rec in df.head(12).to_dict(orient="records"):
            rec.pop("unique_id")
            svc.query(rec, timeout=10.0)
        svc._drift_tick(force=True)
    finally:
        svc.close()
    events = [{"type": "quality_profile", **trained[2].profile.summary()}] + capture.events
    out = drift_events_report(events)
    assert "reference profile: 3 column(s)" in out
    assert "window report(s)" in out
    # the reference's renderer reads the port's events the same way
    from splink_tpu.obs.cli import drift_events_report as ref_report

    assert ref_report(json.loads(json.dumps(events, default=str))) == out


# ---------------------------------------------------------------------------
# EM identifiability diagnostics
# ---------------------------------------------------------------------------


def test_em_diagnostics_structure_and_warnings(trained):
    _, linker, _ = trained
    hist = {"first_name": [10, 500, 0, 300], "surname": [5, 400, 405], "city": [5, 400, 405]}
    diag = em_diagnostics(linker.params, hist)
    assert [c["name"] for c in diag["columns"]] == ["first_name", "surname", "city"]
    first = diag["columns"][0]
    assert first["support"] == [500, 0, 300]
    assert any("~zero training support" in w for w in first["warnings"])
    assert len(first["m"]) == 3 and len(first["log2_bf"]) == 3
    traj = diag["trajectory"]
    assert len(traj["lam"]) == diag["n_iterations"]
    assert len(traj["max_move_m"]) == diag["n_iterations"] - 1
    assert "m" in traj and len(traj["m"][0]) == 3
    diag2 = em_diagnostics(linker.params, None)
    assert all("support" not in w for w in diag2["warnings"])
    # the reference's diagnostics of the same Params and support agree
    from splink_tpu.obs.quality import em_diagnostics as ref_diag

    assert ref_diag(linker.params, hist) == diag


def test_em_diagnostics_flags_uninformative_levels():
    df = twin_df(n_base=20)
    linker = splink_tpu_torch.Splink(drift_settings(max_iterations=0, quality_profile=False),
                                     df=df, device="cpu")
    linker.estimate_parameters()
    p = linker.params
    entry = p.params["π"]["gamma_surname"]
    entry["prob_dist_match"]["level_1"]["probability"] = 0.5
    entry["prob_dist_non_match"]["level_1"]["probability"] = 0.5
    diag = em_diagnostics(p)
    sur = [c for c in diag["columns"] if c["name"] == "surname"][0]
    assert any("m~=u" in w for w in sur["warnings"])
    assert any("uninformative" in w for w in diag["warnings"])


def test_telemetry_record_carries_quality_events(tmp_path):
    from splink_tpu_torch.obs.events import read_events

    df = twin_df(n_base=40)
    linker = splink_tpu_torch.Splink(drift_settings(max_iterations=3, telemetry_dir=str(tmp_path)),
                                     df=df, device="cpu")
    linker.get_scored_comparisons()
    linker.export_index()
    linker.close_telemetry()
    (record,) = tmp_path.glob("*.jsonl")
    events = list(read_events(record))
    diags = [e for e in events if e.get("type") == "em_diagnostics"]
    assert diags
    d = diags[-1]
    assert d["columns"][0]["support"] is not None
    assert "trajectory" in d and "run" in d
    assert d["run"]["n_updates"] >= 1
    profs = [e for e in events if e.get("type") == "quality_profile"]
    assert profs and profs[-1]["n_pairs"] > 0
    assert profs[-1]["n_matched_pairs"] > 0
    out = summarize_events(events)
    assert "EM diagnostics" in out and "quality profile" in out
