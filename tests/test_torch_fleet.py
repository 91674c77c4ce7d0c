"""Fleet observability in splink_tpu_torch: wire v2 negotiation, cross-host
trace stitching, metric federation (obs/fleet.py) and incident bundles.

The oracle is splink_tpu's tests/test_fleet.py, run over the port on
loopback sockets with duck-typed services: the payload round trip,
``server_ms`` and the latency split, the clock offset, ``submit_many``
parity and its shed taxonomy, stitched traces, the merges (bit-exact
union), the aggregator over the wire and incident bundles. Left out: its
``summarize`` and ``attribute`` rendering tests and the fleet dashboard
lines, which wait for the port of ``obs/cli.py``. The port's locks are not
watched, so its bundles carry no lock graph.

Against the reference: ``merge_histograms``, ``merge_exports``,
``merge_drift``, ``merge_fleet_stats`` and ``chrome_trace_from_events`` give
equal outputs in both packages on the same seeded exports. Over real
services: a port LinkageService's ``fleet_stats`` crosses the wire whole
and a FleetAggregator over two of them merges bit for bit.
"""

from __future__ import annotations

import json
import os
import random
import threading
import time
from concurrent.futures import Future

import numpy as np
import pytest

torch = pytest.importorskip("torch")
pd = pytest.importorskip("pandas")

from splink_tpu_torch.obs.events import (  # noqa: E402
    publish,
    register_ambient,
    unregister_ambient,
)
from splink_tpu_torch.obs.exposition import render_samples  # noqa: E402
from splink_tpu_torch.obs.fleet import (  # noqa: E402
    FleetAggregator,
    FleetIncidentReporter,
    merge_drift,
    merge_fleet_stats,
    merge_histograms,
)
from splink_tpu_torch.obs.flight import TRANSITION_TYPES, FlightRecorder  # noqa: E402
from splink_tpu_torch.obs.kernelwatch import HIST_EDGES, KernelWatch  # noqa: E402
from splink_tpu_torch.obs.reqtrace import RequestTrace, ServeTracer, TraceRoot  # noqa: E402
from splink_tpu_torch.obs.slo import SLOTracker, merge_exports  # noqa: E402
from splink_tpu_torch.obs.tracer import chrome_trace_from_events  # noqa: E402
from splink_tpu_torch.serve.remote import RemoteReplica  # noqa: E402
from splink_tpu_torch.serve.service import QueryResult  # noqa: E402
from splink_tpu_torch.serve.wire import WireServer  # noqa: E402

WAIT = 10  # bounded future timeout; failures show up as shed reasons


# -- fixtures ------------------------------------------------------------


class _Capture:
    """In-memory ambient sink (duck-typed EventSink) for event assertions."""

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


class TracingService:
    """Replica duck-type that mirrors LinkageService's span contract:
    resolve the future FIRST, then close the trace on the same worker
    thread — the ordering the wire tier's ``_SpanJoin`` piggyback
    depends on. Echoes the record's ``unique_id`` into the match so
    batching-parity tests can check ordering."""

    accepts_trace = True
    closes_traces = True
    health_state = "healthy"

    def __init__(self, name="tracesvc", delay=0.0, shed_reason=None,
                 flight=None):
        self.name = name
        self.delay = delay
        self.shed_reason = shed_reason
        self.tracer = ServeTracer(1.0, service=name)
        self.flight_recorder = flight
        self.submitted = 0
        self._lock = threading.Lock()

    def submit(self, record, deadline_ms=None, trace=None):
        with self._lock:
            self.submitted += 1
        fut: Future = Future()

        def run():
            if self.delay:
                time.sleep(self.delay)
            if trace is not None:
                for m in ("admit", "form", "pop", "engine_out"):
                    trace.mark(m)
            if self.shed_reason:
                res = QueryResult(shed=True, reason=self.shed_reason)
            else:
                res = QueryResult(
                    matches=[(str(record.get("unique_id", "m")), 0.9)],
                    n_candidates=1,
                    latency_ms=self.delay * 1e3,
                    queue_ms=0.05,
                    execute_ms=0.21,
                )
            fut.set_result(res)
            if trace is not None:
                self.tracer.close(
                    trace, "shed" if res.shed else "delivered",
                    reason=res.reason,
                )

        threading.Thread(target=run, daemon=True).start()
        return fut

    def health(self):
        return {"replica": self.name, "state": self.health_state}

    def latency_summary(self):
        return {"replica": self.name, "served": self.submitted}

    def fleet_stats(self):
        with self._lock:
            served = self.submitted
        return {
            "replica": self.name,
            "t_mono": time.monotonic(),
            "health": self.health_state,
            "breaker_state": "closed",
            "index_generation": 1,
            "counters": {"served": served, "shed": 0},
        }


def _server(svc, **kw):
    return WireServer(svc, host="127.0.0.1", port=0, **kw).start()


def _remote(server, **over):
    kw = dict(
        pool_size=1,
        request_timeout_ms=WAIT * 1000.0,
        breaker_cooldown_s=0.1,
    )
    kw.update(over)
    return RemoteReplica(f"127.0.0.1:{server.port}", **kw)


def _remote_events(cap, remote):
    return [
        e for e in cap.of("request_trace")
        if e.get("service") == remote.name
    ]


# -- wire v2 envelope fields + latency split (satellite 1) ---------------


def test_query_result_payload_roundtrips_queue_execute_split():
    res = QueryResult(
        matches=[("a", 0.5)], n_candidates=3, latency_ms=1.25,
        queue_ms=0.125, execute_ms=2.5,
    )
    back = QueryResult.from_payload(res.to_payload())
    assert back.queue_ms == 0.125
    assert back.execute_ms == 2.5


def test_v2_result_carries_server_ms_and_splits_latency():
    svc = TracingService(delay=0.01)
    server = _server(svc)
    remote = _remote(server)
    try:
        assert remote.peer_version == 2
        for i in range(6):
            res = remote.submit({"unique_id": f"q{i}"}).result(timeout=WAIT)
            assert not res.shed
        summary = remote.latency_summary()
        # server/network sub-dicts only exist when server_ms rode the
        # envelope — i.e. the v2 path actually ran
        assert summary["server"]["n"] == 6
        assert summary["network"]["n"] == 6
        # the fake sleeps 10ms inside the server, so the server share
        # dominates and the network share is loopback-small
        assert summary["server"]["p50_ms"] >= 5.0
        assert summary["network"]["p50_ms"] < summary["server"]["p50_ms"]
        phases = remote.wire_phases()
        # the netwatch skips ANCHOR_SKIP cold samples per phase; 6
        # requests leave at least 3 counted observations per hop
        for hop in ("serialize", "network", "deserialize",
                    "server_queue", "server_execute"):
            assert phases[hop]["observations"] >= 3, hop
        names = {s.name for s in remote.prometheus_samples()}
        assert "splink_remote_server_p95_ms" in names
        assert "splink_remote_network_p95_ms" in names
    finally:
        remote.close()
        server.close()


def test_clock_offset_estimated_on_handshake():
    svc = TracingService()
    server = _server(svc)
    remote = _remote(server)
    try:
        with remote._lock:
            conn = remote._conns[0]
        # same machine, same monotonic clock: the midpoint estimate must
        # land within the handshake's own round trip of zero
        assert conn.offset_s is not None
        assert abs(conn.offset_s) < 0.25
        assert conn.offset_rtt_s < 0.25
    finally:
        remote.close()
        server.close()


# -- client-side envelope batching (satellite 2) -------------------------


def test_submit_many_parity_with_per_record_submit():
    svc = TracingService()
    server = _server(svc)
    remote = _remote(server)
    try:
        records = [{"unique_id": f"r{i}"} for i in range(8)]
        batched = [
            f.result(timeout=WAIT) for f in remote.submit_many(records)
        ]
        single = [
            remote.submit(r).result(timeout=WAIT) for r in records
        ]
        assert [r.to_payload() for r in batched] == [
            r.to_payload() for r in single
        ]
        # positional: result i echoes record i's unique_id
        for i, res in enumerate(batched):
            assert res.matches[0][0] == f"r{i}"
    finally:
        remote.close()
        server.close()


def test_submit_many_empty_is_empty():
    remote = RemoteReplica("127.0.0.1:1", eager_connect=False)
    try:
        assert remote.submit_many([]) == []
    finally:
        remote.close()


def test_submit_many_shed_taxonomy():
    svc = TracingService()
    server = _server(svc)
    recs = [{"unique_id": "a"}, {"unique_id": "b"}]

    # deadline already lapsed
    remote = _remote(server)
    try:
        out = [f.result(timeout=WAIT)
               for f in remote.submit_many(recs, deadline_ms=0)]
        assert [r.reason for r in out] == ["deadline", "deadline"]

        # breaker open fails fast
        for _ in range(remote.breaker.threshold):
            remote.breaker.on_failure()
        out = [f.result(timeout=WAIT) for f in remote.submit_many(recs)]
        assert [r.reason for r in out] == ["breaker_open", "breaker_open"]
    finally:
        remote.close()

    # closed replica
    out = [f.result(timeout=WAIT) for f in remote.submit_many(recs)]
    assert [r.reason for r in out] == ["closed", "closed"]
    server.close()

    # unreachable host (server gone, no pooled connection)
    dead = RemoteReplica(
        f"127.0.0.1:{server.port}", eager_connect=False,
        connect_timeout_ms=200, breaker_threshold=100,
    )
    try:
        out = [f.result(timeout=WAIT) for f in dead.submit_many(recs)]
        assert [r.reason for r in out] == [
            "remote_unreachable", "remote_unreachable",
        ]
    finally:
        dead.close()


def test_submit_many_v1_peer_falls_back_to_per_record():
    svc = TracingService()
    server = _server(svc, protocol_version=1)
    remote = _remote(server)
    try:
        assert remote.peer_version == 1
        records = [{"unique_id": f"v{i}"} for i in range(3)]
        out = [
            f.result(timeout=WAIT) for f in remote.submit_many(records)
        ]
        assert [r.matches[0][0] for r in out] == ["v0", "v1", "v2"]
        assert remote.latency_summary()["served"] == 3
    finally:
        remote.close()
        server.close()


# -- cross-host trace stitching (tentpole a, satellite 3) ----------------


def test_stitched_trace_grafts_and_telescopes(capture):
    svc = TracingService(delay=0.02)
    server = _server(svc)
    remote = _remote(server)
    try:
        trace = RequestTrace(root=TraceRoot())
        res = remote.submit(
            {"unique_id": "s1"}, trace=trace
        ).result(timeout=WAIT)
        assert not res.shed
        deadline = time.monotonic() + WAIT
        while not _remote_events(capture, remote):
            assert time.monotonic() < deadline
            time.sleep(0.01)
        ev = _remote_events(capture, remote)[0]
        assert ev["outcome"] == "delivered"
        rs = ev["remote_span"]
        assert rs["service"] == svc.name
        assert rs["outcome"] == "delivered"
        # the graft rebased t0 onto the client clock and kept the raw
        # remote stamp for audit
        assert "t0_remote" in rs
        assert isinstance(ev.get("clock_offset_s"), float)
        # telescoping: the offset-corrected remote interval nests inside
        # the client attempt's wall (loopback offsets are sub-ms; 100ms
        # of tolerance covers thread-scheduling jitter only)
        client_t0 = float(ev["t0"])
        client_t1 = client_t0 + float(ev["wall_ms"]) / 1e3
        remote_t0 = float(rs["t0"])
        remote_t1 = remote_t0 + float(rs["wall_ms"]) / 1e3
        assert remote_t0 >= client_t0 - 0.1
        assert remote_t1 <= client_t1 + 0.1
        # both trees telescope internally: phases sum to the wall
        for tree in (ev, rs):
            total = sum((tree.get("phases_ms") or {}).values())
            assert total == pytest.approx(tree["wall_ms"], abs=0.05)
        # the wire decomposition covers every hop
        wire = ev["wire_ms"]
        for hop in ("serialize", "network", "server", "deserialize",
                    "server_queue", "server_execute"):
            assert hop in wire, hop
        assert wire["server"] >= 15.0  # the 20ms server-side sleep
    finally:
        remote.close()
        server.close()


def test_stitching_off_keeps_flat_close(capture):
    svc = TracingService()
    server = _server(svc)
    remote = _remote(server, settings={"fleet_stitching": False})
    try:
        trace = RequestTrace(root=TraceRoot())
        res = remote.submit({"unique_id": "f"}, trace=trace).result(
            timeout=WAIT
        )
        assert not res.shed
        deadline = time.monotonic() + WAIT
        while not _remote_events(capture, remote):
            assert time.monotonic() < deadline
            time.sleep(0.01)
        ev = _remote_events(capture, remote)[0]
        assert ev["outcome"] == "delivered"
        assert "remote_span" not in ev
    finally:
        remote.close()
        server.close()


def test_v1_peer_degrades_to_flat_behaviour(capture):
    svc = TracingService()
    server = _server(svc, protocol_version=1)
    remote = _remote(server)
    try:
        assert remote.peer_version == 1
        trace = RequestTrace(root=TraceRoot())
        res = remote.submit({"unique_id": "v"}, trace=trace).result(
            timeout=WAIT
        )
        assert not res.shed
        deadline = time.monotonic() + WAIT
        while not _remote_events(capture, remote):
            assert time.monotonic() < deadline
            time.sleep(0.01)
        ev = _remote_events(capture, remote)[0]
        assert ev["outcome"] == "delivered"
        assert "remote_span" not in ev  # no span on v1 envelopes
        assert "server" not in remote.latency_summary()  # no server_ms
        assert remote.fetch_stats() is None  # v2-only RPC declined
        assert remote.pull_flight() is None
    finally:
        remote.close()
        server.close()


def test_hedge_race_exactly_one_delivered_stitched_tree(capture):
    fast = TracingService(name="svc-fast", delay=0.0)
    slow = TracingService(name="svc-slow", delay=0.3)
    server_a = _server(fast)
    server_b = _server(slow)
    remote_a = _remote(server_a)
    remote_b = _remote(server_b)
    try:
        root = TraceRoot()
        trace_a = RequestTrace(root=root, attempt=0)
        trace_b = trace_a.child(attempt=1, hedge=True)
        fut_b = remote_b.submit({"unique_id": "h"}, trace=trace_b)
        fut_a = remote_a.submit({"unique_id": "h"}, trace=trace_a)
        assert not fut_a.result(timeout=WAIT).shed
        assert not fut_b.result(timeout=WAIT).shed
        deadline = time.monotonic() + WAIT
        while (
            len(_remote_events(capture, remote_a))
            + len(_remote_events(capture, remote_b)) < 2
        ):
            assert time.monotonic() < deadline
            time.sleep(0.01)
        closes = (
            _remote_events(capture, remote_a)
            + _remote_events(capture, remote_b)
        )
        outcomes = sorted(e["outcome"] for e in closes)
        # the shared TraceRoot claim: the fast attempt delivers, the
        # hedge demotes to discarded — exactly one stitched delivery
        assert outcomes == ["delivered", "discarded"]
        winner = next(e for e in closes if e["outcome"] == "delivered")
        assert winner["service"] == remote_a.name
        assert winner["remote_span"]["service"] == "svc-fast"
    finally:
        remote_a.close()
        remote_b.close()
        server_a.close()
        server_b.close()


def test_net_alert_fires_and_clears_on_edges(capture, monkeypatch):
    remote = RemoteReplica(
        "127.0.0.1:1", eager_connect=False,
        settings={"fleet_net_alert_ratio": 2.0},
    )
    try:
        fired = [{"phase": "network", "ratio": 4.2}]
        monkeypatch.setattr(remote._netwatch, "alerts", lambda: fired)
        remote._net_tick()
        assert len(capture.of("fleet_net_alert")) == 1
        # level-triggered state: still firing -> no second event
        remote._last_net_eval = float("-inf")
        remote._net_tick()
        assert len(capture.of("fleet_net_alert")) == 1
        # regression clears -> one clear event on the falling edge
        monkeypatch.setattr(remote._netwatch, "alerts", lambda: [])
        remote._last_net_eval = float("-inf")
        remote._net_tick()
        assert len(capture.of("fleet_net_clear")) == 1
    finally:
        remote.close()


# -- metric federation: merge algebra (tentpole b) -----------------------


def test_merge_histograms_equals_union_bit_exact():
    w_a, w_b, w_u = KernelWatch(), KernelWatch(), KernelWatch()
    # each watch drops its first ANCHOR_SKIP cold samples — give every
    # watch the same warmup so the counted observations are the union
    warm = [1.0, 1.0, 1.0]
    # dyadic values: float addition is exact, so "bit-exact" is literal
    vals_a = [0.000244140625, 0.5, 0.25, 8.0]
    vals_b = [0.001953125, 0.125, 2.0]
    for v in warm:
        w_a.observe("execute", v)
        w_b.observe("execute", v)
        w_u.observe("execute", v)
    for v in vals_a:
        w_a.observe("execute", v)
        w_u.observe("execute", v)
    for v in vals_b:
        w_b.observe("execute", v)
        w_u.observe("execute", v)

    def export(w):
        counts, _edges, total, n = w.histogram("execute")
        return {"counts": [int(c) for c in counts],
                "sum": float(total), "n": int(n)}

    merged = merge_histograms([export(w_a), export(w_b)])
    union = export(w_u)
    assert merged["counts"] == union["counts"]
    assert merged["n"] == union["n"]
    assert merged["sum"] == union["sum"]  # bit-exact, not approx


def test_merge_histograms_empty_and_width_mismatch():
    assert merge_histograms([]) is None
    assert merge_histograms([{"counts": [], "sum": 0.0, "n": 0}]) is None
    merged = merge_histograms([
        {"counts": [1, 2], "sum": 0.5, "n": 3},
        {"counts": [0, 1, 4], "sum": 1.25, "n": 5},
    ])
    assert merged == {"counts": [1, 3, 4], "sum": 1.75, "n": 8}


def test_merge_slo_exports_equals_union():
    t = [1000.0]
    clock = lambda: t[0]  # noqa: E731 - test clock
    a = SLOTracker(clock=clock)
    b = SLOTracker(clock=clock)
    u = SLOTracker(clock=clock)
    for i in range(40):
        t[0] = 1000.0 + i * 0.5
        tracker = a if i % 2 == 0 else b
        ok = i % 7 != 0
        tracker.observe(ok)
        u.observe(ok)
    merged = merge_exports([a.export(), b.export()])
    solo = merge_exports([u.export()])
    assert merged["total_good"] == solo["total_good"] == u.total_good
    assert merged["total_bad"] == solo["total_bad"] == u.total_bad
    assert merged["windows"] == solo["windows"]
    assert merged["hosts"] == 2


def test_merge_drift_adds_tensors():
    a = {
        "window_s": 300.0,
        "gamma": [[1, 2, 3], [0, 4, 0]],
        "counters": {"queries": 10, "oov": 2, "nulls": [1, 0]},
    }
    b = {
        "window_s": 300.0,
        "gamma": [[2, 0, 1], [5, 1, 1]],
        "counters": {"queries": 7, "approx": 3, "nulls": [0, 2]},
    }
    merged = merge_drift([a, b])
    assert merged["gamma"] == [[3, 2, 4], [5, 5, 1]]
    assert merged["counters"]["queries"] == 17
    assert merged["counters"]["oov"] == 2
    assert merged["counters"]["approx"] == 3
    assert merged["counters"]["nulls"] == [1, 2]
    assert merged["hosts"] == 2
    assert merge_drift([None, {}]) is None


def test_merge_fleet_stats_preserves_host_identity():
    def snap(name, served, health):
        return {
            "replica": name,
            "health": health,
            "breaker_state": "closed",
            "index_generation": 4,
            "counters": {"served": served, "shed": 1},
            "slo": {
                "objective": 0.999, "bucket_s": 1.0, "windows": [60.0],
                "buckets": [[100, served, 1]],
                "total_good": served, "total_bad": 1,
            },
            "perf": {
                "edges": list(HIST_EDGES),
                "phases": {
                    "execute": {"counts": [served], "sum": 0.5, "n": served}
                },
            },
        }

    merged = merge_fleet_stats([
        snap("a", 10, "healthy"), snap("b", 4, "degraded"),
    ])
    assert merged["counters"] == {"served": 14, "shed": 2}
    assert [h["replica"] for h in merged["hosts"]] == ["a", "b"]
    assert [h["health"] for h in merged["hosts"]] == [
        "healthy", "degraded",
    ]
    assert merged["slo"]["total_good"] == 14
    assert merged["perf"]["phases"]["execute"]["n"] == 14
    assert merge_fleet_stats([]) is None


# -- FleetAggregator -----------------------------------------------------


class _StubRemote:
    def __init__(self, name, stats):
        self.name = name
        self._stats = stats
        self.pulls = 0

    def fetch_stats(self):
        self.pulls += 1
        return self._stats


def test_aggregator_scrapes_merges_and_rate_limits(capture):
    t = [0.0]
    local = TracingService(name="local")
    local.submitted = 5
    good = _StubRemote("r-good", {
        "replica": "r-good", "health": "healthy",
        "counters": {"served": 7},
    })
    dead = _StubRemote("r-dead", None)
    agg = FleetAggregator(
        local=local, remotes=[good, dead],
        min_scrape_interval_s=1.0, clock=lambda: t[0],
    )
    merged = agg.scrape()
    assert merged["counters"]["served"] == 12
    assert len(merged["hosts"]) == 2
    ev = capture.of("fleet_scrape")[-1]
    assert ev["hosts"] == 2
    assert ev["unreachable"] == ["r-dead"]
    # inside the rate-limit window the cached merge answers
    t[0] = 0.5
    assert agg.scrape() is merged
    assert good.pulls == 1
    # force bypasses; a new window re-pulls
    agg.scrape(force=True)
    assert good.pulls == 2
    assert len(agg.raw_snapshots()) == 2
    assert agg.snapshot()["counters"]["served"] == 12


def test_aggregator_prometheus_endpoint_renders():
    local = TracingService(name="local")
    local.submitted = 3
    agg = FleetAggregator(local=local, min_scrape_interval_s=0.0)
    # seed a mergeable histogram through a raw snapshot merge
    snap = local.fleet_stats()
    snap["perf"] = {
        "edges": list(HIST_EDGES),
        "phases": {"execute": {"counts": [2, 1], "sum": 0.75, "n": 3}},
    }
    local.fleet_stats = lambda: snap  # type: ignore[method-assign]
    text = render_samples(agg.prometheus_samples())
    assert "splink_fleet_hosts 1" in text
    assert "splink_fleet_served_total 3" in text
    assert 'splink_fleet_host_health_rank{replica="local"} 0' in text
    assert "splink_fleet_phase_seconds_count" in text
    assert 'splink_fleet_phase_seconds_sum{phase="execute"} 0.75' in text


def test_aggregator_federates_over_the_wire():
    svc_a = TracingService(name="host-a")
    svc_b = TracingService(name="host-b")
    server_a = _server(svc_a)
    server_b = _server(svc_b)
    remote_a = _remote(server_a)
    remote_b = _remote(server_b)
    try:
        for i in range(4):
            assert not remote_a.submit(
                {"unique_id": f"a{i}"}
            ).result(timeout=WAIT).shed
        for i in range(2):
            assert not remote_b.submit(
                {"unique_id": f"b{i}"}
            ).result(timeout=WAIT).shed
        agg = FleetAggregator(remotes=[remote_a, remote_b])
        merged = agg.scrape(force=True)
        # federation totals equal the per-host sums bit-exactly: the
        # counters are integers pulled over the stats envelope
        raw = agg.raw_snapshots()
        assert len(raw) == 2
        assert merged["counters"]["served"] == sum(
            s["counters"]["served"] for s in raw
        )
        assert merged["counters"]["served"] == 6
        assert {h["replica"] for h in merged["hosts"]} == {
            "host-a", "host-b",
        }
    finally:
        remote_a.close()
        remote_b.close()
        server_a.close()
        server_b.close()


# -- correlated incident bundles (tentpole c) ----------------------------


def _flight_with_record(tmp_path, name):
    fr = FlightRecorder(capacity=32, dump_dir=str(tmp_path), name=name)
    fr.emit("degradation", **{"from": "healthy", "to": "degraded",
                              "replica": name})
    return fr


def test_incident_bundle_contents(tmp_path, capture):
    local_fr = _flight_with_record(tmp_path / "lf", "router")
    remote_fr = _flight_with_record(tmp_path / "rf", "host-a")
    svc = TracingService(name="host-a", flight=remote_fr)
    server = _server(svc)
    remote = _remote(server)
    reporter = FleetIncidentReporter(
        local_flight=local_fr,
        remotes=[remote],
        bundle_dir=str(tmp_path / "bundles"),
    )
    try:
        publish("request_trace", trace_id="t1", request_id="t1.0",
                outcome="delivered", wall_ms=1.0)
        path = reporter.build_now("manual", note="test")
        assert path is not None
        files = set(os.listdir(path))
        assert "manifest.json" in files
        assert "flight_local.jsonl" in files
        assert "stitched_traces.jsonl" in files
        assert "lock_graph.json" not in files  # the port's locks are not watched
        remote_files = [f for f in files if f.startswith("flight_remote")]
        assert len(remote_files) == 1  # the pulled host-a ring
        with open(os.path.join(path, remote_files[0])) as fh:
            lines = [json.loads(l) for l in fh if l.strip()]
        assert lines[0]["type"] == "flight_header"
        assert lines[0]["service"] == "host-a"
        assert any(r.get("type") == "degradation" for r in lines[1:])
        with open(os.path.join(path, "manifest.json")) as fh:
            manifest = json.load(fh)
        assert manifest["trigger"] == "manual"
        assert manifest["unreachable"] == []
        assert set(manifest["files"]) == files - {"manifest.json"}
        ev = capture.of("incident_bundle")[-1]
        assert ev["trigger"] == "manual"
        assert ev["path"] == path
    finally:
        reporter.close()
        remote.close()
        server.close()
        local_fr.close()
        remote_fr.close()


def test_incident_bundle_marks_unreachable_remote(tmp_path):
    dead = RemoteReplica(
        "127.0.0.1:1", eager_connect=False, connect_timeout_ms=100,
        name="remote:gone",
    )
    reporter = FleetIncidentReporter(
        remotes=[dead], bundle_dir=str(tmp_path),
    )
    try:
        path = reporter.build_now("manual")
        with open(os.path.join(path, "manifest.json")) as fh:
            manifest = json.load(fh)
        assert manifest["unreachable"] == ["remote:gone"]
        assert not any(
            f.startswith("flight_remote") for f in manifest["files"]
        )
    finally:
        reporter.close()
        dead.close()


def test_incident_reporter_reads_fleet_settings(tmp_path):
    reporter = FleetIncidentReporter(
        settings={
            "fleet_bundle_dir": str(tmp_path / "bundles"),
            "fleet_incident_interval_s": 7.5,
        },
    )
    try:
        assert reporter.bundle_dir == str(tmp_path / "bundles")
        assert reporter.interval_s == 7.5
    finally:
        reporter.close()
    # explicit arguments always beat the settings defaults
    reporter = FleetIncidentReporter(
        bundle_dir=str(tmp_path / "explicit"),
        interval_s=1.0,
        settings={
            "fleet_bundle_dir": str(tmp_path / "bundles"),
            "fleet_incident_interval_s": 7.5,
        },
    )
    try:
        assert reporter.bundle_dir == str(tmp_path / "explicit")
        assert reporter.interval_s == 1.0
    finally:
        reporter.close()


def _wait_bundles(reporter, n, timeout=10.0):
    deadline = time.monotonic() + timeout
    while len(reporter.bundles) < n:
        if time.monotonic() > deadline:
            return False
        time.sleep(0.02)
    return True


def test_breaker_open_triggers_and_rate_limits(tmp_path):
    reporter = FleetIncidentReporter(
        bundle_dir=str(tmp_path), interval_s=3600.0,
    )
    try:
        publish("degradation", **{"from": "closed", "to": "breaker_open",
                                  "replica": "host-a"})
        assert _wait_bundles(reporter, 1)
        assert "incident_breaker_open_" in reporter.bundles[0]
        # a storm inside the interval produces ONE artifact
        publish("degradation", **{"from": "closed", "to": "breaker_open",
                                  "replica": "host-b"})
        time.sleep(0.2)
        assert len(reporter.bundles) == 1
    finally:
        reporter.close()


def test_partition_burst_and_hedge_storm_trigger(tmp_path):
    t = [0.0]
    reporter = FleetIncidentReporter(
        bundle_dir=str(tmp_path), interval_s=0.0,
        partition_burst=3, hedge_storm=5, burst_window_s=10.0,
        clock=lambda: t[0],
    )
    try:
        for _ in range(2):
            reporter.emit("wire_shed", reason="connection_lost",
                          replica="host-a", n=1)
        assert not _wait_bundles(reporter, 1, timeout=0.3)
        reporter.emit("wire_shed", reason="remote_unreachable",
                      replica="host-a", n=1)
        assert _wait_bundles(reporter, 1)
        assert "incident_partition_" in reporter.bundles[0]
        # hedge storm: the router's note_hedge hook
        t[0] = 100.0  # outside the shed burst window
        for _ in range(5):
            reporter.note_hedge()
        assert _wait_bundles(reporter, 2)
        assert "incident_hedge_storm_" in reporter.bundles[1]
        # non-partition shed reasons never count toward the burst
        t[0] = 200.0
        for _ in range(10):
            reporter.emit("wire_shed", reason="deadline",
                          replica="host-a", n=1)
        time.sleep(0.1)
        assert len(reporter.bundles) == 2
    finally:
        reporter.close()


def test_router_wires_note_hedge():
    from splink_tpu_torch.serve.router import ReplicaRouter

    class _Counting:
        def __init__(self):
            self.hedges = 0

        def note_hedge(self):
            self.hedges += 1

    counting = _Counting()
    slow = TracingService(name="slow", delay=0.5)
    router = ReplicaRouter(
        [slow, TracingService(name="fast")],
        hedge_ms=10.0, incident_reporter=counting,
    )
    res = router.submit({"unique_id": "h"}).result(timeout=WAIT)
    assert not res.shed
    assert counting.hedges >= 1


# -- registration + rendering (satellite 4) ------------------------------


def test_fleet_event_kinds_registered_with_flight_recorder():
    for kind in ("fleet_scrape", "fleet_net_alert", "fleet_net_clear",
                 "incident_bundle"):
        assert kind in TRANSITION_TYPES, kind


def test_chrome_trace_renders_stitched_remote_row():
    ev = {
        "type": "request_trace", "trace_id": "t", "request_id": "t.0",
        "attempt": 0, "hedge": False, "service": "remote:a",
        "outcome": "delivered", "t0": 10.0, "wall_ms": 3.0,
        "phases_ms": {"admission": 1.0, "deliver": 2.0},
        "clock_offset_s": 0.0002, "wire_ms": {"network": 0.4},
        "remote_span": {
            "request_id": "t.0", "service": "host-a", "t0": 10.001,
            "t0_remote": 812.44, "wall_ms": 2.0,
            "phases_ms": {"queue_wait": 0.5, "execute": 1.5},
        },
    }
    trace = chrome_trace_from_events([ev])
    remote_slices = [
        e for e in trace["traceEvents"] if e.get("cat") == "remote"
    ]
    assert len(remote_slices) == 2
    assert remote_slices[0]["tid"] == 4
    assert remote_slices[0]["args"]["remote_service"] == "host-a"
    assert any(
        e.get("ph") == "M" and e.get("args", {}).get("name")
        == "remote (stitched)"
        for e in trace["traceEvents"]
    )
    # the remote row starts at the grafted (offset-corrected) t0
    assert remote_slices[0]["ts"] == pytest.approx(10.001 * 1e6)


# -- against the reference ------------------------------------------------


def _seeded_hist(rng, width):
    counts = [int(c) for c in rng.integers(0, 50, width)]
    return {"counts": counts, "sum": float(rng.random() * 10), "n": int(sum(counts))}


def _seeded_slo_export(rng, t0):
    t = [t0]
    tracker = SLOTracker(clock=lambda: t[0])
    for i in range(int(rng.integers(20, 80))):
        t[0] = t0 + i * float(rng.random())
        tracker.observe(bool(rng.random() < 0.9))
    return tracker.export()


def _seeded_snapshot(rng, name):
    phases = {p: _seeded_hist(rng, len(HIST_EDGES))
              for p in ("batch", "execute", "transfer") if rng.random() < 0.8}
    return {
        "replica": name,
        "t_mono": float(rng.random()),
        "health": str(rng.choice(["healthy", "degraded", "broken"])),
        "breaker_state": "closed",
        "index_generation": int(rng.integers(0, 3)),
        "counters": {k: int(rng.integers(0, 1000)) for k in
                     ("served", "shed", "batches", "timeouts", "degraded_served",
                      "worker_crashes", "brownout_episodes")},
        "slo": _seeded_slo_export(rng, 1000.0),
        "perf": {"edges": list(HIST_EDGES), "phases": phases},
    }


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_merges_equal_reference(seed):
    """The same seeded exports through both packages' merge functions."""
    from splink_tpu.obs import fleet as ref_fleet
    from splink_tpu.obs import slo as ref_slo

    rng = np.random.default_rng(seed)
    hists = [_seeded_hist(rng, int(rng.integers(1, 17))) for _ in range(4)]
    assert merge_histograms(hists) == ref_fleet.merge_histograms(hists)
    slos = [_seeded_slo_export(rng, 1000.0 + 3 * i) for i in range(3)]
    assert merge_exports(slos) == ref_slo.merge_exports(slos)
    drifts = [{"window_s": 300.0,
               "gamma": [[int(v) for v in row] for row in rng.integers(0, 9, (3, 4))],
               "counters": {"queries": int(rng.integers(0, 99)),
                            "nulls": [int(v) for v in rng.integers(0, 5, 3)]}}
              for _ in range(3)]
    assert merge_drift(drifts) == ref_fleet.merge_drift(drifts)
    snaps = [_seeded_snapshot(rng, f"host-{i}") for i in range(3)]
    assert merge_fleet_stats(snaps) == ref_fleet.merge_fleet_stats(snaps)


def test_chrome_trace_equal_reference():
    from splink_tpu.obs.tracer import chrome_trace_from_events as ref_chrome

    rng = random.Random(5)
    evs = []
    for i in range(20):
        evs.append({
            "type": rng.choice(["request_trace", "span", "fault", "retry"]),
            "trace_id": f"t{i}", "request_id": f"t{i}.0", "outcome": "delivered",
            "t0": rng.random() * 10, "wall_ms": rng.random() * 5,
            "phases_ms": {"queue_wait": rng.random(), "execute": rng.random()},
            "name": f"s{i}", "kind": rng.choice(["run", "stage", "request"]),
            "dur_s": rng.random(), "mono": rng.random(), "process_index": i % 2,
        })
    assert chrome_trace_from_events(evs) == ref_chrome(evs)


# -- over real port services ------------------------------------------------


@pytest.fixture(scope="module")
def engine():
    import splink_tpu_torch
    from splink_tpu_torch.serve import BucketPolicy, QueryEngine

    rng = np.random.default_rng(13)
    n = 80
    df = pd.DataFrame({
        "unique_id": range(n),
        "first_name": [str(rng.choice(["amelia", "oliver", "isla", "george"]))
                       for _ in range(n)],
        "surname": [str(rng.choice(["smith", "jones", "taylor"])) for _ in range(n)],
        "dob": [f"19{rng.integers(40, 99)}" for _ in range(n)],
    })
    settings = {
        "link_type": "dedupe_only",
        "comparison_columns": [
            {"col_name": "first_name", "num_levels": 3},
            {"col_name": "surname", "num_levels": 2, "comparison": {"kind": "exact"}},
        ],
        "blocking_rules": ["l.dob = r.dob", "l.surname = r.surname"],
        "max_iterations": 3,
    }
    linker = splink_tpu_torch.Splink(settings, df=df, device="cpu")
    linker.estimate_parameters()
    eng = QueryEngine(linker.export_index(), policy=BucketPolicy((16,), (64, 256)))
    eng.warmup()
    return eng, df.to_dict(orient="records")


def test_service_fleet_stats_cross_the_wire_whole(engine):
    from splink_tpu_torch.serve import LinkageService

    eng, records = engine
    svc = LinkageService(eng, deadline_ms=None, name="host-x")
    server = _server(svc)
    remote = _remote(server)
    try:
        for r in records[:12]:
            assert not remote.submit(dict(r)).result(timeout=WAIT).shed
        local = svc.fleet_stats()
        pulled = remote.fetch_stats()
        assert "drift" not in local
        for key in ("replica", "health", "breaker_state", "index_generation",
                    "counters", "perf"):
            assert pulled[key] == local[key], key
        assert pulled["counters"]["served"] == 12
        assert set(pulled["perf"]["phases"]) >= {"batch"}
    finally:
        remote.close()
        server.close()
        svc.close()


def test_aggregator_over_two_real_services_merges_bit_exact(engine):
    from splink_tpu_torch.serve import LinkageService

    eng, records = engine
    svcs = [LinkageService(eng, deadline_ms=None, name=f"host-{c}") for c in "ab"]
    servers = [_server(s) for s in svcs]
    remotes = [_remote(s) for s in servers]
    try:
        for i, r in enumerate(records[:30]):
            assert not remotes[i % 2].submit(dict(r)).result(timeout=WAIT).shed
        agg = FleetAggregator(remotes=remotes)
        merged = agg.scrape(force=True)
        raw = agg.raw_snapshots()
        for key, value in merged["counters"].items():
            assert value == sum(s["counters"][key] for s in raw), key
        assert merged["counters"]["served"] == 30
        for phase, h in merged["perf"]["phases"].items():
            parts = [s["perf"]["phases"][phase] for s in raw
                     if phase in s["perf"]["phases"]]
            assert h["n"] == sum(p["n"] for p in parts)
            total = 0.0
            for p in parts:
                total += p["sum"]
            assert h["sum"] == total  # the left-to-right fold, bit for bit
            width = max(len(p["counts"]) for p in parts)
            assert h["counts"] == [sum(p["counts"][i] for p in parts
                                       if i < len(p["counts"])) for i in range(width)]
        text = render_samples(agg.prometheus_samples())
        assert "splink_fleet_hosts 2" in text
        for name in ("host-a", "host-b"):
            assert f'replica="{name}"' in text
    finally:
        for r in remotes:
            r.close()
        for s in servers:
            s.close()
        for s in svcs:
            s.close()
