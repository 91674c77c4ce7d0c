"""The micro-batching service of splink_tpu_torch (serve/service.py).

The oracles are splink_tpu's tests/test_serve.py (micro-batching, overload
shedding, submit after close) and tests/test_serve_resilience.py (the
breaker, the wait estimator, the health state machine and its endpoint,
timeouts, lifecycle races, the watchdog, deadlines, brown-out, hot-swap
through the service and probe capture), run here on the CPU over an index
of the port. Every test holds the service's contract: no future hangs and
no exception escapes through a future. Served scores equal the port's
offline scores bit for bit.
"""

import os
import threading
import time
import warnings

import numpy as np
import pytest

torch = pytest.importorskip("torch")
pd = pytest.importorskip("pandas")

from splink_tpu_torch.obs import events  # noqa: E402
from splink_tpu_torch.resilience import faults  # noqa: E402
from splink_tpu_torch.serve import (  # noqa: E402
    BROKEN,
    DEGRADED,
    HEALTHY,
    BucketPolicy,
    CircuitBreaker,
    HealthMonitor,
    LinkageService,
    QueryEngine,
    QueryResult,
    WaitEstimator,
)
from splink_tpu_torch.utils.logging_utils import DegradationWarning  # noqa: E402

WAIT = 30  # "never hangs" budget per future


def people_df(n=80, seed=13):
    rng = np.random.default_rng(seed)
    firsts = ["amelia", "oliver", "isla", "george", "ava", "noah", "emily"]
    lasts = ["smith", "jones", "taylor", "brown", "wilson", "evans"]
    return pd.DataFrame({
        "unique_id": range(n),
        "first_name": [str(rng.choice(firsts)) for _ in range(n)],
        "surname": [str(rng.choice(lasts)) for _ in range(n)],
        "dob": [f"19{rng.integers(40, 99)}" for _ in range(n)],
    })


def service_settings(**over):
    s = {
        "link_type": "dedupe_only",
        "comparison_columns": [
            {"col_name": "first_name", "num_levels": 3},
            {"col_name": "surname", "num_levels": 2, "comparison": {"kind": "exact"}},
        ],
        "blocking_rules": ["l.dob = r.dob", "l.surname = r.surname"],
        "max_iterations": 3,
        "serve_top_k": 16,
        "serve_brownout_top_k": 2,
        "serve_breaker_threshold": 2,
        "serve_probe_queries": 4,
    }
    s.update(over)
    return s


@pytest.fixture(scope="module")
def trained():
    """(df, linker, df_e, index): a port linker trained on the CPU."""
    import splink_tpu_torch

    df = people_df()
    linker = splink_tpu_torch.Splink(service_settings(), df=df, device="cpu")
    df_e = linker.get_scored_comparisons()
    return df, linker, df_e, linker.export_index()


@pytest.fixture(scope="module")
def engine(trained):
    eng = QueryEngine(trained[3], policy=BucketPolicy((16,), (64, 256)))
    eng.warmup()
    return eng


@pytest.fixture()
def clean_faults(monkeypatch):
    faults.reset_plans()
    monkeypatch.delenv(faults.ENV_VAR, raising=False)
    yield monkeypatch
    faults.reset_plans()


class _Sink:
    def __init__(self):
        self.captured = []

    def emit(self, etype, **fields):  # a fault event carries a "kind" field
        self.captured.append((etype, fields))


def _service(engine, **over):
    kw = dict(deadline_ms=2.0, watchdog_interval_s=0.02, breaker_cooldown_s=0.2)
    kw.update(over)
    return LinkageService(engine, **kw)


# -- the admission primitives and the health state machine (copied) -------


def test_circuit_breaker_state_machine():
    b = CircuitBreaker(threshold=2, cooldown_s=0.05)
    assert b.state == "closed" and not b.should_fail_fast()
    assert not b.on_failure()
    assert b.on_failure()
    assert b.state == "open" and b.should_fail_fast()
    time.sleep(0.06)
    assert b.probe_due()
    assert not b.should_fail_fast() and b.state == "half_open"
    assert b.on_failure() and b.should_fail_fast()
    time.sleep(0.06)
    assert not b.should_fail_fast()
    assert b.on_success() and b.state == "closed" and b.opened_total == 2
    with pytest.raises(ValueError, match="threshold"):
        CircuitBreaker(threshold=0)


def test_wait_estimator_ewma_and_estimate():
    w = WaitEstimator()
    assert w.estimate_wait_ms(0, 16, 5.0) == 5.0
    w.observe(40.0)
    assert w.estimate_wait_ms(31, 16, 5.0) == pytest.approx(5.0 + 2 * 40.0)
    w.observe(80.0)
    assert 40.0 < w.batch_ms < 80.0


def _signals(**over):
    s = {"worker_alive": True, "breaker": "closed", "queue_fill": 0.0,
         "shed_rate": 0.0, "p95_ms": 5.0, "compile_stall": False, "brownout": False}
    s.update(over)
    return s


@pytest.mark.parametrize("over,level", [
    ({}, HEALTHY), ({"brownout": True}, HEALTHY),
    ({"worker_alive": False}, BROKEN), ({"breaker": "open"}, BROKEN),
    ({"shed_rate": 0.9}, BROKEN), ({"breaker": "half_open"}, DEGRADED),
    ({"shed_rate": 0.1}, DEGRADED), ({"queue_fill": 0.8}, DEGRADED),
    ({"compile_stall": True}, DEGRADED),
])
def test_health_classification_levels(over, level):
    assert HealthMonitor().classify(_signals(**over))[0] == level


def test_health_hysteresis_and_transition_event():
    sink = _Sink()
    events.register_ambient(sink)
    try:
        m = HealthMonitor(name="r7", recover_ticks=2)
        assert m.evaluate(_signals()) == HEALTHY
        assert m.evaluate(_signals(worker_alive=False)) == BROKEN
        assert m.evaluate(_signals()) == BROKEN
        assert m.evaluate(_signals()) == DEGRADED
        assert m.evaluate(_signals()) == DEGRADED
        assert m.evaluate(_signals()) == HEALTHY
    finally:
        events.unregister_ambient(sink)
    assert m.snapshot()["transitions"] == 3
    health = [f for k, f in sink.captured if k == "health"]
    assert health[0]["replica"] == "r7" and health[0]["to"] == BROKEN


# -- the service ------------------------------------------------------------


def test_service_micro_batching_end_to_end(trained, engine):
    df, _, df_e, _ = trained
    offline = {(a, b): p for a, b, p in
               zip(df_e["unique_id_l"], df_e["unique_id_r"], df_e["match_probability"])}
    records = df.head(30).to_dict(orient="records")
    with LinkageService(engine, deadline_ms=20.0, queue_depth=64) as svc:
        futures = [svc.submit(r) for r in records]
        results = [f.result(timeout=WAIT) for f in futures]
        summary = svc.latency_summary()
        slo = svc.slo_snapshot()
    assert all(not r.shed and r.queue_ms is not None for r in results)
    assert summary["served"] == 30 and summary["shed"] == 0
    assert summary["batches"] >= 2  # 30 records, 16 a batch
    assert summary["p50_ms"] > 0 and summary["p99_ms"] >= summary["p50_ms"]
    assert slo["objective"] == 0.999
    checked = 0
    for rec, res in zip(records, results):
        for uid, p in res.matches:
            if uid == rec["unique_id"]:
                continue
            key = (min(rec["unique_id"], uid), max(rec["unique_id"], uid))
            assert np.float32(offline[key]) == np.float32(p)
            checked += 1
    assert checked > 30


def test_overload_sheds_with_degradation_event(trained, engine):
    sink = _Sink()
    events.register_ambient(sink)
    try:
        svc = LinkageService(engine, queue_depth=2, deadline_ms=50.0, autostart=False)
        record = trained[0].iloc[0].to_dict()
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            futures = [svc.submit(dict(record)) for _ in range(5)]
        shed = [f for f in futures if f.done() and f.result().shed]
        assert len(shed) == 3
        assert len([w for w in caught if issubclass(w.category, DegradationWarning)]) == 3
        assert any(k == "degradation" for k, _ in sink.captured)
        svc.start()
        for f in futures:
            if f not in shed:
                res = f.result(timeout=WAIT)
                assert not res.shed and res.n_candidates >= 1
        svc.close()
    finally:
        events.unregister_ambient(sink)


def test_submit_after_close_sheds_not_hangs(trained, engine):
    svc = LinkageService(engine, deadline_ms=1.0)
    svc.close()
    with pytest.warns(DegradationWarning, match="closed"):
        fut = svc.submit(trained[0].iloc[0].to_dict())
    assert fut.result(timeout=5).shed


def test_query_timeout_cancels_and_sheds(engine, trained, clean_faults):
    df = trained[0]
    clean_faults.setenv(faults.ENV_VAR, "serve_batch@times=1:kind=slow:delay_ms=400")
    svc = _service(engine, autostart=False)
    filler = [svc.submit(r) for r in df.head(6).to_dict(orient="records")]
    svc.start()
    with pytest.warns(DegradationWarning, match="timeout"):
        res = svc.query(df.iloc[10].to_dict(), timeout=0.1)
    assert res.shed and res.reason == "timeout"
    for f in filler:
        assert not f.result(timeout=WAIT).shed
    with svc._nonempty:
        assert not svc._queue
    assert svc.latency_summary()["timeouts"] == 1
    assert not svc.query(df.iloc[11].to_dict(), timeout=WAIT).shed
    svc.close()


def test_submit_racing_close_never_hangs(engine, trained):
    record = trained[0].iloc[0].to_dict()
    futures: list = []
    flock = threading.Lock()
    stop = threading.Event()
    svc = _service(engine)

    def pound():
        while not stop.is_set():
            fut = svc.submit(dict(record))
            with flock:
                futures.append(fut)

    threads = [threading.Thread(target=pound) for _ in range(4)]
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", DegradationWarning)
        for t in threads:
            t.start()
        time.sleep(0.1)
        svc.close()
        stop.set()
        for t in threads:
            t.join(timeout=10)
    with flock:
        snapshot = list(futures)
    assert snapshot
    for f in snapshot:
        assert isinstance(f.result(timeout=WAIT), QueryResult)


def test_double_close_and_start_after_close(engine, trained):
    df = trained[0]
    svc = _service(engine)
    assert not svc.query(df.iloc[0].to_dict(), timeout=WAIT).shed
    svc.close()
    svc.close()
    with pytest.warns(DegradationWarning, match="closed"):
        res = svc.submit(df.iloc[1].to_dict()).result(timeout=WAIT)
    assert res.shed and res.reason == "closed"
    svc.start()
    assert not svc.query(df.iloc[2].to_dict(), timeout=WAIT).shed
    svc.close()


def test_worker_crash_watchdog_recovers(engine, trained, clean_faults):
    df = trained[0]
    sink = _Sink()
    events.register_ambient(sink)
    clean_faults.setenv(faults.ENV_VAR, "serve_worker@batch=0")
    try:
        svc = _service(engine, autostart=False)
        futures = [svc.submit(r) for r in df.head(8).to_dict(orient="records")]
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            svc.start()
            results = [f.result(timeout=WAIT) for f in futures]
            assert all(r.shed and r.reason == "worker_restart" for r in results)
            assert not svc.query(df.iloc[0].to_dict(), timeout=WAIT).shed
        assert svc.latency_summary()["worker_crashes"] == 1
        svc.close()
    finally:
        events.unregister_ambient(sink)
    kinds = {k for k, _ in sink.captured}
    assert "fault" in kinds and "serve_worker_restart" in kinds


def test_breaker_opens_fails_fast_recovers(engine, trained, clean_faults):
    records = trained[0].head(6).to_dict(orient="records")
    clean_faults.setenv(faults.ENV_VAR, "serve_batch@times=2")
    svc = _service(engine, autostart=False)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        storm1 = [svc.submit(dict(r)) for r in records]
        svc.start()
        storm1 = [f.result(timeout=WAIT) for f in storm1]
        storm2 = [svc.submit(dict(r)).result(timeout=WAIT) for r in records[:1]]
        assert all(r.shed and r.reason in ("batch_error", "breaker_open")
                   for r in storm1 + storm2)
        assert svc.breaker.state == "open"
        fast = svc.submit(dict(records[0])).result(timeout=WAIT)
        assert fast.shed and fast.reason == "breaker_open"
        deadline = time.monotonic() + 10
        while svc.breaker.state != "closed" and time.monotonic() < deadline:
            time.sleep(0.02)  # the watchdog probe closes it post-cooldown
        assert svc.breaker.state == "closed"
        assert not svc.query(dict(records[0]), timeout=WAIT).shed
    assert svc.latency_summary()["breaker_opened_total"] == 1
    svc.close()


def test_deadline_rejected_at_admission_and_at_dispatch(engine, trained):
    df = trained[0]
    svc = _service(engine, autostart=False)
    svc._admission.observe(50.0)  # prime the wait model: 50ms/batch
    ok = svc.submit(df.iloc[0].to_dict(), deadline_ms=1000.0)
    with pytest.warns(DegradationWarning, match="deadline"):
        rejected = svc.submit(df.iloc[1].to_dict(), deadline_ms=10.0)
    res = rejected.result(timeout=WAIT)
    assert res.shed and res.reason == "deadline"
    lapsing = svc.submit(df.iloc[2].to_dict(), deadline_ms=60.0)
    time.sleep(0.08)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        svc.start()
        assert not ok.result(timeout=WAIT).shed
        lapsed = lapsing.result(timeout=WAIT)
    assert lapsed.shed and lapsed.reason == "deadline"
    svc.close()


def test_brownout_serves_degraded_without_builds(engine, trained):
    from splink_tpu_torch.obs.metrics import compile_requests

    svc = _service(engine, autostart=False, queue_depth=16)
    futures = [svc.submit(r) for r in trained[0].head(12).to_dict(orient="records")]
    c0 = compile_requests()
    with pytest.warns(DegradationWarning, match="brown"):
        svc.start()
        results = [f.result(timeout=WAIT) for f in futures]
    assert compile_requests() == c0
    assert all(not r.shed and r.degraded for r in results)
    assert all(len(r.matches) <= engine.brownout_top_k for r in results)
    summary = svc.latency_summary()
    assert summary["brownout_episodes"] == 1 and summary["degraded_served"] == 12
    svc.close()


def test_health_endpoint_degrades_and_recovers(engine, trained):
    monitor = HealthMonitor(name="t", recover_ticks=2)
    svc = _service(engine, autostart=False, queue_depth=4, health_monitor=monitor)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        futures = [svc.submit(r) for r in trained[0].head(10).to_dict(orient="records")]
        assert svc.health()["state"] == BROKEN
        svc.start()
        for f in futures:
            f.result(timeout=WAIT)
        deadline = time.monotonic() + WAIT
        while svc.health_state != HEALTHY and time.monotonic() < deadline:
            time.sleep(0.01)
    assert svc.health_state == HEALTHY
    assert monitor.snapshot()["transitions"] == 3
    time.sleep(0.05)
    snap = svc.health()
    assert snap["state"] == HEALTHY and snap["breaker"]["state"] == "closed"
    assert snap["generation"] == 0
    svc.close()
    time.sleep(0.05)
    assert svc.health()["state"] == BROKEN


def test_service_auto_captures_probes_and_swaps(trained, tmp_path):
    df, linker, _, index = trained
    eng = QueryEngine(index, policy=BucketPolicy((16,), (64, 256)))
    eng.warmup()
    svc = _service(eng, probe_queries=4, autostart=False)
    futures = [svc.submit(r) for r in df.head(6).to_dict(orient="records")]
    svc.start()
    for f in futures:
        assert not f.result(timeout=WAIT).shed
    deadline = time.monotonic() + WAIT
    while eng.probe_count == 0 and time.monotonic() < deadline:
        time.sleep(0.01)
    assert eng.probe_count == 4
    linker.export_index(tmp_path / "idx")
    stats = svc.swap_index(tmp_path / "idx")
    assert stats["generation"] == 1 and stats["probes_checked"] == 4
    assert not svc.query(df.iloc[0].to_dict(), timeout=WAIT).shed
    assert svc.latency_summary()["index_generation"] == 1
    svc.close()


def test_traced_requests_split_their_phases(engine, trained):
    svc = _service(engine, trace_sample_rate=1.0, deadline_ms=5.0)
    for r in trained[0].head(5).to_dict(orient="records"):
        assert not svc.query(r, timeout=WAIT).shed
    phases = svc.phase_summary()
    assert {"queue_wait", "execute", "transfer"} <= set(phases)
    assert svc.latency_summary()["traces"]["sampled"] == 5
    assert svc.perf_snapshot()["enabled"]
    assert len(svc.flight_recorder.snapshot()) > 0
    svc.close()


def test_unported_service_options_raise(engine, tmp_path):
    # a non-zero exposition port serves the Prometheus text (ported with
    # obs/exposition.py); a free port is found first
    import socket
    import urllib.request

    with socket.socket() as probe:
        probe.bind(("127.0.0.1", 0))
        port = probe.getsockname()[1]
    served = LinkageService(engine, exposition_port=port, autostart=False)
    try:
        with urllib.request.urlopen(f"http://127.0.0.1:{port}/metrics", timeout=5) as r:
            assert "splink_serve_served_total" in r.read().decode()
    finally:
        served.close()
    # the drift monitor is ported: a service over a profile-less index
    # reports the reference's no-reference snapshot instead of raising
    svc = LinkageService(engine, autostart=False)
    assert svc.drift_snapshot() == {"reference": False,
                                    "reason": "no reference profile", "alerts": []}
    assert "drift" not in svc.fleet_stats()
    # telemetry_dir is accepted: it is where the flight recorder dumps
    engine.index.settings["telemetry_dir"] = str(tmp_path)
    try:
        svc = LinkageService(engine, autostart=False)
        path = svc.flight_recorder.dump("manual")
        assert path is not None and os.path.dirname(path) == str(tmp_path)
    finally:
        engine.index.settings["telemetry_dir"] = None
