"""splink_tpu_torch.analysis.lockwatch, the dynamic half of threadlint:
the counterpart of the lockwatch half of tests/test_threadlint.py.

Disabled, the factory returns plain ``threading`` primitives; enabled, the
watched locks record nested edges, detect an inversion once (and publish
it), take no self-edge on RLock re-entry, carry a ``threading.Condition``,
union with static edges and dump the graph artifact. The same scripted
acquisitions through splink_tpu's lockwatch and the port's give equal
observed graphs and inversions. The SLOTracker and FlightRecorder hammers
run on the port's classes, and a small storm drives the serving fleet on
the CPU under watched locks: the reference thread smoke's 160-row corpus,
two engine -> service -> wire server stacks, a RemoteReplica over each, a
hedged router, injected connection drops and pollers, with zero
inversions and an acyclic union with the static graph.
"""

import json
import sys
import threading
import time

import numpy as np
import pytest

pytest.importorskip("torch")

from splink_tpu_torch.analysis import lockwatch  # noqa: E402
from splink_tpu_torch.analysis.threadlint import run_thread_audit  # noqa: E402

WAVE_TIMEOUT_S = 60


@pytest.fixture
def watch(monkeypatch):
    monkeypatch.setenv(lockwatch.ENV_VAR, "1")
    monkeypatch.delenv(lockwatch.JITTER_ENV_VAR, raising=False)
    lockwatch.reset()
    yield
    lockwatch.reset()


def test_disabled_returns_plain_primitives(monkeypatch):
    monkeypatch.delenv(lockwatch.ENV_VAR, raising=False)
    assert type(lockwatch.new_lock("X.l")) is type(threading.Lock())
    assert type(lockwatch.new_rlock("X.r")) is type(threading.RLock())
    for off in ("0", "false", "off", ""):
        monkeypatch.setenv(lockwatch.ENV_VAR, off)
        assert type(lockwatch.new_lock("X.l")) is type(threading.Lock())


def test_watched_lock_records_nested_edges(watch):
    a = lockwatch.new_lock("A.lock")
    b = lockwatch.new_lock("B.lock")
    with a:
        with b:
            pass
    graph = lockwatch.observed_graph()
    assert {"A.lock", "B.lock"} <= set(graph["nodes"])
    assert any(e["from"] == "A.lock" and e["to"] == "B.lock" and e["count"] == 1
               for e in graph["edges"])
    assert lockwatch.cycles() == []


def test_inversion_detected_once_and_published(watch):
    from splink_tpu_torch.obs.events import register_ambient, unregister_ambient

    seen = []

    class Sink:
        def emit(self, etype, **fields):
            if etype == "lock_inversion":
                seen.append(fields)

    sink = Sink()
    register_ambient(sink)
    try:
        a = lockwatch.new_lock("A.lock")
        b = lockwatch.new_lock("B.lock")
        for _ in range(2):  # the second round adds no new edge
            with a:
                with b:
                    pass
            with b:
                with a:  # closes the cycle: an inversion
                    pass
        inv = lockwatch.inversions()
        assert len(inv) == 1
        assert set(inv[0]["cycle"]) >= {"A.lock", "B.lock"}
        assert inv[0]["edge"] == ["B.lock", "A.lock"]
        assert any({"A.lock", "B.lock"} <= set(c) for c in lockwatch.cycles())
        deadline = time.monotonic() + 10
        while not seen and time.monotonic() < deadline:
            time.sleep(0.01)
        assert len(seen) == 1 and seen[0]["edge"] == ["B.lock", "A.lock"]
    finally:
        unregister_ambient(sink)


def test_rlock_reentry_records_no_self_edge(watch):
    r = lockwatch.new_rlock("R.lock")
    with r:
        with r:  # depth, not a new acquisition
            pass
    graph = lockwatch.observed_graph()
    assert graph["nodes"] == ["R.lock"]
    assert all(e["from"] != e["to"] for e in graph["edges"])
    assert lockwatch.inversions() == []


def test_condition_over_watched_lock(watch):
    lk = lockwatch.new_lock("C.lock")
    cond = threading.Condition(lk)
    hits = []

    def waiter():
        with cond:
            while not hits:
                cond.wait(timeout=5.0)

    t = threading.Thread(target=waiter, daemon=True)
    t.start()
    time.sleep(0.05)
    with cond:
        hits.append(1)
        cond.notify_all()
    t.join(timeout=5.0)
    assert not t.is_alive()
    assert not lk.locked()


def test_union_cycles_with_static_edges(watch):
    a = lockwatch.new_lock("A.lock")
    b = lockwatch.new_lock("B.lock")
    with a:
        with b:
            pass
    # observed A->B alone is acyclic; a static B->A edge closes it
    assert lockwatch.cycles() == []
    union = lockwatch.cycles(extra_edges=[{"from": "B.lock", "to": "A.lock", "site": "static"}])
    assert any({"A.lock", "B.lock"} <= set(c) for c in union)


def test_dump_graph_artifact(watch, tmp_path):
    a = lockwatch.new_lock("A.lock")
    b = lockwatch.new_lock("B.lock")
    with a:
        with b:
            pass
    with b:
        with a:
            pass
    out = tmp_path / "lock_order_graph.json"
    assert lockwatch.dump_graph(str(out)) == str(out)
    payload = json.loads(out.read_text())
    assert payload["inversions"] and payload["union_cycles"]
    assert payload["nodes"] == ["A.lock", "B.lock"]


def _script(lw):
    """The same acquisitions through either package's lockwatch: nested
    locks, an RLock re-entered, a lock taken from a second thread, and one
    inversion."""
    a, b, c = lw.new_lock("S.a"), lw.new_lock("S.b"), lw.new_lock("S.c")
    r = lw.new_rlock("S.r")
    with a:
        with b:
            with c:
                pass
    with r:
        with r:
            with a:
                pass

    def other():
        with b:
            with c:
                pass

    t = threading.Thread(target=other, name="script-other")
    t.start()
    t.join()
    with c:
        with a:  # c -> a closes a -> b -> c
            pass
    return lw.observed_graph(), lw.inversions()


def test_observed_graph_equals_the_reference(monkeypatch):
    from splink_tpu.analysis import lockwatch as ref

    monkeypatch.setenv(lockwatch.ENV_VAR, "1")
    monkeypatch.delenv(lockwatch.JITTER_ENV_VAR, raising=False)
    ref.reset()
    lockwatch.reset()
    try:
        want = _script(ref)
        got = _script(lockwatch)
    finally:
        ref.reset()
        lockwatch.reset()
    assert got == want
    graph, inversions = got
    assert len(graph["edges"]) == 4 and len(inversions) == 1
    assert inversions[0]["edge"] == ["S.c", "S.a"]


# -- snapshot-vs-writer hammers on the port's classes -------------------


def test_slo_tracker_snapshot_hammer():
    from splink_tpu_torch.obs.slo import SLOTracker

    slo = SLOTracker()
    n_threads, per_thread = 8, 500
    torn = []
    stop = threading.Event()

    def writer():
        for i in range(per_thread):
            slo.observe(i % 3 != 0)

    def reader():
        while not stop.is_set():
            snap = slo.snapshot()
            # good and bad are bumped under one lock: a torn pair would let
            # the total drift from the sum of its parts
            if snap["total_good"] + snap["total_bad"] > n_threads * per_thread:
                torn.append(snap)
            slo.alerts()
            slo.export()

    readers = [threading.Thread(target=reader, daemon=True) for _ in range(2)]
    writers = [threading.Thread(target=writer) for _ in range(n_threads)]
    for t in readers + writers:
        t.start()
    for t in writers:
        t.join(timeout=30.0)
    stop.set()
    for t in readers:
        t.join(timeout=5.0)
    assert not torn
    snap = slo.snapshot()
    assert snap["total_good"] + snap["total_bad"] == n_threads * per_thread


def test_flight_recorder_dump_hammer(tmp_path):
    from splink_tpu_torch.obs.flight import FlightRecorder

    rec = FlightRecorder(capacity=64, dump_dir=str(tmp_path), name="hammer",
                         min_dump_interval_s=0.0)
    try:
        n_threads, per_thread = 6, 200
        errors = []

        def writer(k):
            try:
                for i in range(per_thread):
                    rec.emit("health", replica="hammer", seq=i, src=k)
            except Exception as e:  # noqa: BLE001 - the hammer asserts no raise
                errors.append(e)

        def dumper():
            try:
                for _ in range(20):
                    rec.dump("hammer_trigger")
                    rec.snapshot()
            except Exception as e:  # noqa: BLE001
                errors.append(e)

        threads = ([threading.Thread(target=writer, args=(k,)) for k in range(n_threads)]
                   + [threading.Thread(target=dumper) for _ in range(2)])
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=30.0)
        assert not errors
        assert rec.dumps
        # every dump written mid-storm must be parseable JSONL
        for path in rec.dumps:
            with open(path, encoding="utf-8") as fh:
                for line in fh:
                    json.loads(line)
    finally:
        rec.close()


# -- a small storm of the serving fleet on the CPU -----------------------


def _settings():
    return {
        "link_type": "dedupe_only",
        "comparison_columns": [
            {"col_name": "first_name", "num_levels": 3},
            {"col_name": "surname", "num_levels": 2, "comparison": {"kind": "exact"}},
        ],
        "blocking_rules": ["l.dob = r.dob", "l.surname = r.surname"],
        "max_iterations": 4,
        "serve_top_k": 32,
        "serve_query_buckets": [16, 64],
        "serve_candidate_buckets": [64, 256],
        "serve_probe_queries": 8,
        "serve_queue_depth": 512,
    }


def _corpus(n=160, seed=11):
    import pandas as pd

    rng = np.random.default_rng(seed)
    firsts = ["amelia", "oliver", "isla", "george", "ava", "noah", "emily"]
    lasts = ["smith", "jones", "taylor", "brown", "wilson", "evans"]
    return pd.DataFrame({
        "unique_id": range(n),
        "first_name": [str(rng.choice(firsts)) for _ in range(n)],
        "surname": [str(rng.choice(lasts)) for _ in range(n)],
        "dob": [f"19{rng.integers(40, 99)}" for _ in range(n)],
    })


def test_fleet_storm_on_the_cpu_under_watched_locks(tmp_path, monkeypatch):
    import warnings

    import splink_tpu_torch
    from splink_tpu_torch.analysis.threadlint import graph_cycles
    from splink_tpu_torch.obs.metrics import compile_requests
    from splink_tpu_torch.resilience import faults
    from splink_tpu_torch.resilience.retry import RetryPolicy
    from splink_tpu_torch.serve import (
        LinkageService,
        QueryEngine,
        RemoteReplica,
        ReplicaRouter,
        WireServer,
        load_index,
    )

    t_start = time.monotonic()
    findings, _, static_graph = run_thread_audit()
    assert not findings and graph_cycles(static_graph) == []
    monkeypatch.setenv(lockwatch.ENV_VAR, "1")
    monkeypatch.setenv(lockwatch.JITTER_ENV_VAR, "50")
    monkeypatch.delenv(faults.ENV_VAR, raising=False)
    faults.reset_plans()
    lockwatch.reset()
    warnings.simplefilter("ignore")

    df = _corpus()
    linker = splink_tpu_torch.Splink(_settings(), df=df, device="cpu")
    linker.estimate_parameters()
    idx_path = str(tmp_path / "idx")
    linker.export_index(idx_path)

    def stack(name):
        engine = QueryEngine(load_index(idx_path, device="cpu"))
        engine.warmup()
        svc = LinkageService(engine, deadline_ms=None, name=name)
        return engine, svc, WireServer(svc, name=name).start()

    def remote(server):
        return RemoteReplica(server.address, pool_size=2,
                             retry_policy=RetryPolicy(base_delay=0.05, max_delay=0.5),
                             breaker_threshold=4, breaker_cooldown_s=0.2,
                             connect_timeout_ms=500.0,
                             request_timeout_ms=WAVE_TIMEOUT_S * 1000.0)

    eng_a, svc_a, server_a = stack("host-a")
    _, svc_b, server_b = stack("host-b")
    rep_a, rep_b = remote(server_a), remote(server_b)
    router = ReplicaRouter([rep_a, rep_b], hedge_ms=30.0)
    targets = (rep_a, rep_b, router, server_a, server_b, svc_a, svc_b)
    records = df.head(120).to_dict(orient="records")
    # the watched locks are the fleet's: the engine's swap lock among them
    assert isinstance(eng_a._swap_lock, lockwatch._WatchedLock)
    old_interval = sys.getswitchinterval()
    try:
        warm = [router.submit(dict(r)) for r in records[:20]]
        assert all(not f.result(timeout=WAVE_TIMEOUT_S).shed for f in warm)
        want = {r["unique_id"]: svc_a.query(dict(r), timeout=WAVE_TIMEOUT_S).matches
                for r in records}
        builds = compile_requests()

        faults.reset_plans()
        monkeypatch.setenv(faults.ENV_VAR, "wire_request@kind=net_drop:times=3")
        sys.setswitchinterval(1e-5)
        errors, results = [], []
        res_lock = threading.Lock()
        stop = threading.Event()
        n_direct = 200

        def storm_router(k):
            try:
                futs = [(r["unique_id"], router.submit(dict(r))) for r in records]
                out = [(u, f.result(timeout=WAVE_TIMEOUT_S)) for u, f in futs]
                with res_lock:
                    results.extend(out)
            except Exception as e:  # noqa: BLE001 - the gate is "no exception escapes"
                errors.append(("router", k, e))

        def storm_direct():
            try:
                futs = [svc_a.submit(dict(records[i % len(records)])) for i in range(n_direct)]
                for f in futs:
                    f.result(timeout=WAVE_TIMEOUT_S)
            except Exception as e:  # noqa: BLE001
                errors.append(("direct", 0, e))

        def poller():
            try:
                while not stop.is_set():
                    svc_a.health()
                    svc_b.latency_summary()
                    svc_a.prometheus_samples()
                    server_a.stats()
                    rep_b.latency_summary()
                    router.health()
                    time.sleep(0.002)
            except Exception as e:  # noqa: BLE001
                errors.append(("poller", 0, e))

        before = svc_a.latency_summary()
        threads = ([threading.Thread(target=storm_router, args=(k,)) for k in range(3)]
                   + [threading.Thread(target=storm_direct)]
                   + [threading.Thread(target=poller, daemon=True) for _ in range(2)])
        for t in threads:
            t.start()
        for t in threads:
            if not t.daemon:
                t.join(timeout=WAVE_TIMEOUT_S)
                assert not t.is_alive(), "storm thread hung: deadlock"
        stop.set()
        sys.setswitchinterval(old_interval)
        monkeypatch.delenv(faults.ENV_VAR)
        faults.reset_plans()

        assert not errors, errors
        assert len(results) == 3 * len(records)
        served = [(u, r) for u, r in results if not r.shed]
        assert served
        assert all(r.reason for _, r in results if r.shed)
        assert all(r.matches == want[u] for u, r in served if not r.degraded)
        after = svc_a.latency_summary()
        assert (after["served"] - before["served"]) + (after["shed"] - before["shed"]) >= n_direct
        health = router.health()
        assert health["dispatched"] >= 3 * len(records)
        assert health["hedge_wins"] <= health["hedges"] <= health["dispatched"]
        assert lockwatch.inversions() == []
        assert lockwatch.cycles(extra_edges=static_graph["edges"]) == []
        observed = lockwatch.observed_graph()
        assert {"QueryEngine._swap_lock", "LinkageService._lock",
                "ReplicaRouter._lock"} <= set(observed["nodes"])
        settle = [router.submit(dict(r)) for r in records[:30]]
        assert all(not f.result(timeout=WAVE_TIMEOUT_S).shed for f in settle)
        assert compile_requests() == builds
    finally:
        sys.setswitchinterval(old_interval)
        for target in targets:
            target.close()
        faults.reset_plans()
        lockwatch.reset()
    assert time.monotonic() - t_start < 60.0
