"""The wire tier of splink_tpu_torch (serve/wire.py, serve/remote.py)
against splink_tpu's.

Frames across packages: for seeded envelopes both packages' ``encode_frame``
give equal bytes and each package's ``read_frame`` decodes the other's.
The reference's framing and link tests (tests/test_wire.py), run over the
port: encode/read round trip, the hostile length prefix, torn frames,
corrupt payloads, version mismatch, interleaved submits on one connection,
in-flight sheds on connection loss, deadlines, the per-remote breaker,
reconnect, partition and heal, the net fault kinds, the connection cap.
Every wait is bounded (socket timeouts, ``Future.result(timeout=)``). Its
two ``summarize_events`` tests wait for the port of ``obs/cli.py``.

Parity: remote answers equal the same queries served locally, bit for bit,
at float32 and float64. Interop in both directions on one artifact: the
port's RemoteReplica against a splink_tpu WireServer, and splink_tpu's
RemoteReplica against the port's WireServer; each remote answer equals the
answer of the service it reached bit for bit, and the two packages' answers
have equal ids and candidate counts and probabilities within 4 ulp at
float32.
"""

import random
import socket
import struct
import threading
import time
from concurrent.futures import Future

import numpy as np
import pytest

torch = pytest.importorskip("torch")
pd = pytest.importorskip("pandas")

from splink_tpu_torch.obs import events  # noqa: E402
from splink_tpu_torch.resilience import faults  # noqa: E402
from splink_tpu_torch.resilience.retry import RetryPolicy  # noqa: E402
from splink_tpu_torch.serve import (  # noqa: E402
    BucketPolicy,
    LinkageService,
    QueryEngine,
    QueryResult,
    RemoteReplica,
    ReplicaRouter,
    WireServer,
)
from splink_tpu_torch.serve.wire import (  # noqa: E402
    WIRE_VERSION,
    CorruptFrame,
    FrameTooLarge,
    TornFrame,
    encode_frame,
    read_frame,
)

WAIT = 10  # "never hangs" budget per future and per socket read

FAST_RETRY = RetryPolicy(base_delay=0.02, max_delay=0.1)


def _pair():
    """A socketpair whose reads time out instead of hanging."""
    a, b = socket.socketpair()
    a.settimeout(WAIT)
    b.settimeout(WAIT)
    return a, b


# ---------------------------------------------------------------------------
# Frames across packages
# ---------------------------------------------------------------------------


def _seeded_envelopes(seed=7, n=40):
    rng = random.Random(seed)
    np_rng = np.random.default_rng(seed)
    kinds = ["query", "result", "health", "latency", "stats", "error", "flight_pull"]
    out = []
    for i in range(n):
        env = {"v": rng.choice([1, 2]), "kind": rng.choice(kinds), "id": i}
        if env["kind"] == "query":
            env["record"] = {
                "unique_id": int(np_rng.integers(0, 1 << 40)),
                "first_name": "".join(rng.choice("abcdéxyz") for _ in range(7)),
                "dob": rng.choice([None, "1987", 1987]),
                "age": float(np_rng.normal()),
            }
            env["deadline_ms"] = rng.choice([None, 1.8, 250])
            if rng.random() < 0.5:
                env["trace"] = {"trace_id": f"{rng.getrandbits(64):016x}",
                                "attempt": rng.randrange(3), "hedge": rng.random() < 0.5}
        elif env["kind"] == "result":
            env["result"] = {
                "matches": [[int(u), float(p)] for u, p in zip(
                    np_rng.integers(0, 1000, 5), np_rng.random(5))],
                "n_candidates": int(np_rng.integers(0, 99)),
                "shed": False, "latency_ms": float(np_rng.random()),
                "degraded": False, "approx": rng.random() < 0.2, "reason": None,
                "queue_ms": float(np_rng.random()), "execute_ms": np.float32(0.5),
            }
            env["server_ms"] = float(np_rng.random())
            env["health"] = rng.choice(["healthy", "degraded"])
        elif env["kind"] == "error":
            env.update(reason="bad_frame", detail="x" * rng.randrange(50))
        out.append(env)
    out.append({"v": 2, "kind": "result", "id": 99, "results": [
        {"matches": [], "shed": True, "reason": "deadline",
         "latency_ms": float("nan")}]})
    return out


def test_frames_byte_equal_across_packages():
    from splink_tpu.serve import wire as ref_wire

    for env in _seeded_envelopes():
        assert encode_frame(env) == ref_wire.encode_frame(env), env


def test_each_package_reads_the_others_frames():
    from splink_tpu.serve import wire as ref_wire

    for env in _seeded_envelopes(seed=11):
        a, b = _pair()
        try:
            a.sendall(ref_wire.encode_frame(env))
            a.sendall(encode_frame(env))
            mine = read_frame(b)  # the reference's frame
            theirs = ref_wire.read_frame(b)  # the port's frame
            assert mine == theirs
            assert mine["id"] == env["id"] and mine["kind"] == env["kind"]
        finally:
            a.close()
            b.close()


def test_frame_caps_and_versions_equal_across_packages():
    from splink_tpu.serve import wire as ref_wire
    from splink_tpu_torch.serve import wire as port_wire

    for name in ("WIRE_VERSION", "SUPPORTED_VERSIONS", "DEFAULT_MAX_FRAME_BYTES",
                 "DEFAULT_MAX_CONNECTIONS"):
        assert getattr(port_wire, name) == getattr(ref_wire, name), name
    with pytest.raises(FrameTooLarge):
        encode_frame({"blob": "x" * 1000}, max_bytes=64)
    with pytest.raises(ref_wire.FrameTooLarge):
        ref_wire.encode_frame({"blob": "x" * 1000}, max_bytes=64)


# ---------------------------------------------------------------------------
# Frame layer (no server)
# ---------------------------------------------------------------------------


def test_frame_roundtrip_over_socketpair():
    a, b = _pair()
    try:
        env = {"v": WIRE_VERSION, "kind": "query", "id": 7,
               "record": {"first_name": "amelia", "n": 3}}
        a.sendall(encode_frame(env))
        assert read_frame(b) == env
        # numpy payloads sanitise to Python types on encode
        a.sendall(encode_frame({"p": np.float32(0.25), "u": np.int64(9)}))
        got = read_frame(b)
        assert got == {"p": 0.25, "u": 9}
        assert isinstance(got["u"], int)
    finally:
        a.close()
        b.close()


def test_frame_clean_eof_returns_none():
    a, b = _pair()
    a.close()
    try:
        assert read_frame(b) is None
    finally:
        b.close()


def test_oversized_outbound_frame_raises_before_write():
    with pytest.raises(FrameTooLarge):
        encode_frame({"blob": "x" * 1000}, max_bytes=64)


def test_hostile_length_prefix_rejected_without_payload_read():
    """A prefix declaring 2 GiB is rejected after the 4-byte header: the
    reader raises without a single payload recv (nothing was sent, so a
    read attempt would block — completing instantly proves the bound)."""
    a, b = _pair()
    try:
        a.sendall(struct.pack(">I", 2**31))
        b.settimeout(2.0)  # a payload read would hit this and fail
        t0 = time.monotonic()
        with pytest.raises(FrameTooLarge):
            read_frame(b, max_bytes=1024)
        assert time.monotonic() - t0 < 1.0
    finally:
        a.close()
        b.close()


def test_torn_frame_raises():
    a, b = _pair()
    try:
        frame = encode_frame({"v": WIRE_VERSION, "kind": "query", "id": 1})
        a.sendall(frame[: len(frame) // 2])
        a.close()
        with pytest.raises(TornFrame):
            read_frame(b)
    finally:
        b.close()


def test_corrupt_payload_raises_corrupt_frame():
    a, b = _pair()
    try:
        payload = b"not json at all"
        a.sendall(struct.pack(">I", len(payload)) + payload)
        with pytest.raises(CorruptFrame):
            read_frame(b)
        # a JSON scalar is intact framing but not an envelope
        payload = b"42"
        a.sendall(struct.pack(">I", len(payload)) + payload)
        with pytest.raises(CorruptFrame):
            read_frame(b)
    finally:
        a.close()
        b.close()


# ---------------------------------------------------------------------------
# Server + client over a fake replica (no jax)
# ---------------------------------------------------------------------------


class FakeService:
    """Replica-shaped fake: resolves each submit on its own timer thread
    so responses complete out of order when delays say so."""

    name = "fake"
    accepts_trace = False

    def __init__(self, health_state="healthy"):
        self.health_state = health_state
        self.submissions = 0

    def submit(self, record, deadline_ms=None):
        self.submissions += 1
        fut = Future()
        delay = float(record.get("delay") or 0.0)
        res = QueryResult(
            matches=[(record.get("tag", "u"), 0.5)], n_candidates=1
        )
        if record.get("shed_reason"):
            res = QueryResult(shed=True, reason=record["shed_reason"])
        if delay:
            t = threading.Timer(delay, fut.set_result, [res])
            t.daemon = True
            t.start()
        else:
            fut.set_result(res)
        return fut

    def health(self):
        return {"state": self.health_state, "replica": self.name}

    def latency_summary(self):
        return {"p95_ms": 1.0}


@pytest.fixture()
def fake_server():
    svc = FakeService()
    server = WireServer(svc).start()
    yield svc, server
    server.close()


def _remote(server, **over):
    kw = dict(pool_size=1, retry_policy=FAST_RETRY,
              breaker_cooldown_s=0.1, request_timeout_ms=5_000.0)
    kw.update(over)
    return RemoteReplica(("127.0.0.1", server.port), **kw)


@pytest.fixture()
def clean_faults(monkeypatch):
    faults.reset_plans()
    monkeypatch.delenv(faults.ENV_VAR, raising=False)
    yield monkeypatch
    faults.reset_plans()


def test_remote_submit_roundtrip(fake_server):
    _, server = fake_server
    rep = _remote(server)
    try:
        res = rep.submit({"tag": "r1"}).result(timeout=WAIT)
        assert not res.shed and res.matches == [("r1", 0.5)]
        assert res.n_candidates == 1
    finally:
        rep.close()


def test_remote_propagates_server_side_shed_reason(fake_server):
    _, server = fake_server
    rep = _remote(server)
    try:
        res = rep.submit({"shed_reason": "queue_full"}).result(timeout=WAIT)
        assert res.shed and res.reason == "queue_full"
    finally:
        rep.close()


def test_concurrent_submits_interleave_on_one_connection(fake_server):
    """A slow request must not convoy fast ones behind it on the same
    connection: responses demultiplex by id, out of order."""
    _, server = fake_server
    rep = _remote(server, pool_size=1)
    try:
        f_slow = rep.submit({"delay": 0.5, "tag": "slow"})
        fasts = [rep.submit({"tag": f"fast{i}"}) for i in range(8)]
        t0 = time.monotonic()
        for i, f in enumerate(fasts):
            res = f.result(timeout=WAIT)
            assert not res.shed and res.matches == [(f"fast{i}", 0.5)]
        assert time.monotonic() - t0 < 0.4  # did not wait for the slow one
        res = f_slow.result(timeout=WAIT)
        assert not res.shed and res.matches == [("slow", 0.5)]
    finally:
        rep.close()


def test_version_mismatch_rejected_without_poisoning_connection(fake_server):
    """A wrong-version envelope gets an error reply; the connection keeps
    serving correctly-versioned requests interleaved behind it."""
    _, server = fake_server
    sock = socket.create_connection(("127.0.0.1", server.port), timeout=5)
    try:
        sock.sendall(encode_frame({"v": 99, "kind": "query", "id": 1,
                                   "record": {}}))
        env = read_frame(sock)
        assert env["kind"] == "error" and env["reason"] == "version_mismatch"
        assert env["id"] == 1
        sock.sendall(encode_frame({"v": WIRE_VERSION, "kind": "query",
                                   "id": 2, "record": {"tag": "ok"}}))
        env = read_frame(sock)
        assert env["kind"] == "result" and env["id"] == 2
        assert env["result"]["matches"] == [["ok", 0.5]]
    finally:
        sock.close()


def test_corrupt_payload_rejected_without_poisoning_connection(fake_server):
    _, server = fake_server
    sock = socket.create_connection(("127.0.0.1", server.port), timeout=5)
    try:
        payload = b"{torn json"
        sock.sendall(struct.pack(">I", len(payload)) + payload)
        env = read_frame(sock)
        assert env["kind"] == "error" and env["reason"] == "bad_frame"
        sock.sendall(encode_frame({"v": WIRE_VERSION, "kind": "query",
                                   "id": 3, "record": {"tag": "ok"}}))
        env = read_frame(sock)
        assert env["kind"] == "result" and env["id"] == 3
    finally:
        sock.close()


def test_hostile_prefix_gets_error_envelope_then_close(fake_server):
    """Server-side bounded read: a 1 GiB length prefix is answered with a
    frame_too_large error envelope and the connection closes — without
    the server ever reading (or allocating) the declared payload."""
    _, server = fake_server
    sock = socket.create_connection(("127.0.0.1", server.port), timeout=5)
    try:
        sock.sendall(struct.pack(">I", 2**30))
        env = read_frame(sock)
        assert env["kind"] == "error" and env["reason"] == "frame_too_large"
        assert read_frame(sock) is None  # server closed the stream
    finally:
        sock.close()


def test_health_piggybacked_on_every_response(fake_server):
    svc, server = fake_server
    rep = _remote(server)
    try:
        assert rep.submit({}).result(timeout=WAIT).shed is False
        assert rep.health_state == "healthy"
        svc.health_state = "degraded"
        assert rep.submit({}).result(timeout=WAIT).shed is False
        # the router's next ranking read sees the demotion, no watchdog
        # cadence involved
        assert rep.health_state == "degraded"
    finally:
        rep.close()


def test_kill_mid_request_sheds_inflight_machine_readably(fake_server):
    _, server = fake_server
    rep = _remote(server)
    try:
        fut = rep.submit({"delay": 10.0})
        time.sleep(0.1)
        server.kill()
        res = fut.result(timeout=WAIT)  # no hang
        assert res.shed and res.reason == "connection_lost"
    finally:
        rep.close()


def test_expired_deadline_sheds_before_dialing(fake_server):
    _, server = fake_server
    rep = _remote(server)
    try:
        res = rep.submit({}, deadline_ms=0).result(timeout=WAIT)
        assert res.shed and res.reason == "deadline"
    finally:
        rep.close()


def test_deadline_swept_clientside_when_server_stalls(fake_server):
    """A request whose deadline lapses in flight resolves shed client-
    side — the far side being wedged cannot hang the router."""
    _, server = fake_server
    rep = _remote(server)
    try:
        res = rep.submit({"delay": 5.0}, deadline_ms=80).result(timeout=WAIT)
        assert res.shed and res.reason == "deadline"
    finally:
        rep.close()


def test_request_timeout_bounds_deadline_less_requests(fake_server):
    _, server = fake_server
    rep = _remote(server, request_timeout_ms=100.0)
    try:
        res = rep.submit({"delay": 5.0}).result(timeout=WAIT)
        assert res.shed and res.reason == "timeout"
    finally:
        rep.close()


def test_breaker_opens_fails_fast_and_recovers(fake_server):
    svc, server = fake_server
    port = server.port
    rep = _remote(server, breaker_threshold=2, breaker_cooldown_s=0.1,
                  connect_timeout_ms=100.0)
    try:
        assert rep.submit({}).result(timeout=WAIT).shed is False
        server.kill()
        time.sleep(0.05)
        reasons = {rep.submit({}).result(timeout=WAIT).reason
                   for _ in range(6)}
        assert "breaker_open" in reasons
        assert reasons <= {"connection_lost", "remote_unreachable",
                           "breaker_open"}
        assert rep.health_state == "broken"
        # restart on the same port: the reconnector's handshake closes
        # the breaker and traffic resumes
        server2 = WireServer(svc, port=port).start()
        try:
            deadline = time.monotonic() + WAIT
            while time.monotonic() < deadline:
                if not rep.submit({}).result(timeout=WAIT).shed:
                    break
                time.sleep(0.05)
            else:
                pytest.fail("remote never recovered after server restart")
            assert rep.breaker.state == "closed"
            assert rep.reconnects >= 1
        finally:
            server2.close()
    finally:
        rep.close()


def test_partition_heals_and_publishes_events(fake_server):
    _, server = fake_server
    rep = _remote(server)
    captured = []

    class _Sink:
        def emit(self, kind, **fields):
            captured.append((kind, fields))

    sink = _Sink()
    events.register_ambient(sink)
    try:
        assert rep.submit({}).result(timeout=WAIT).shed is False
        # one request parked on the connection, so that the partition
        # drops a connection with a request in flight (a wire_shed event)
        parked = rep.submit({"delay": 5.0})
        server.partition(0.3)
        assert parked.result(timeout=WAIT).reason == "connection_lost"
        res = rep.submit({}).result(timeout=WAIT)
        assert res.shed and res.reason in (
            "connection_lost", "remote_unreachable", "breaker_open"
        )
        deadline = time.monotonic() + WAIT
        while time.monotonic() < deadline:
            if not rep.submit({}).result(timeout=WAIT).shed:
                break
            time.sleep(0.05)
        else:
            pytest.fail("remote never recovered after partition heal")
    finally:
        events.unregister_ambient(sink)
        rep.close()
    kinds = {k for k, _ in captured}
    assert "wire_partition_heal" in kinds
    assert "wire_reconnect" in kinds
    sheds = [f for k, f in captured if k == "wire_shed"]
    assert sheds and all(f.get("reason") for f in sheds)


def test_net_fault_kinds_parse_and_fire(clean_faults):
    plan = faults.FaultPlan.from_spec(
        "wire_response@kind=net_torn_frame,"
        "wire_accept@kind=net_partition:delay_ms=120"
    )
    with pytest.raises(faults.InjectedFault) as e:
        plan.fire("wire_response", request=1)
    assert e.value.kind == "net_torn_frame"
    with pytest.raises(faults.InjectedFault) as e:
        plan.fire("wire_accept", conn=1)
    assert e.value.kind == "net_partition" and e.value.delay_ms == 120
    # net_delay stalls and continues, like slow
    plan = faults.FaultPlan.from_spec("wire_request@kind=net_delay:delay_ms=60")
    t0 = time.monotonic()
    plan.fire("wire_request", request=1)
    assert time.monotonic() - t0 >= 0.05


def test_injected_torn_response_sheds_then_connection_recovers(
    fake_server, clean_faults
):
    """net_torn_frame on the response path: the client detects the torn
    frame, sheds the in-flight request, reconnects and serves again —
    the torn frame never poisons protocol state."""
    _, server = fake_server
    rep = _remote(server)
    try:
        clean_faults.setenv(
            faults.ENV_VAR, "wire_response@kind=net_torn_frame"
        )
        res = rep.submit({}).result(timeout=WAIT)
        assert res.shed and res.reason == "connection_lost"
        clean_faults.delenv(faults.ENV_VAR)
        faults.reset_plans()
        deadline = time.monotonic() + WAIT
        while time.monotonic() < deadline:
            if not rep.submit({}).result(timeout=WAIT).shed:
                break
            time.sleep(0.05)
        else:
            pytest.fail("remote never recovered after torn frame")
    finally:
        rep.close()


def test_closed_remote_sheds_closed(fake_server):
    _, server = fake_server
    rep = _remote(server)
    rep.close()
    res = rep.submit({}).result(timeout=WAIT)
    assert res.shed and res.reason == "closed"
    rep.close()  # idempotent


def test_router_fails_over_from_killed_remote_to_live_remote():
    svc_a, svc_b = FakeService(), FakeService()
    server_a = WireServer(svc_a).start()
    server_b = WireServer(svc_b).start()
    rep_a = _remote(server_a)
    rep_b = _remote(server_b)
    try:
        router = ReplicaRouter([rep_a, rep_b], hedge_ms=0)
        assert not router.query({"tag": "warm"}, timeout=WAIT).shed
        fut = rep_a.submit({"delay": 10.0})  # park one in flight
        server_a.kill()
        assert fut.result(timeout=WAIT).shed  # sheds, frees the router
        res = router.query({"tag": "after"}, timeout=WAIT)
        assert not res.shed and res.matches == [("after", 0.5)]
    finally:
        rep_a.close()
        rep_b.close()
        server_a.kill()
        server_b.close()


def test_remote_latency_summary_feeds_hedger(fake_server):
    _, server = fake_server
    rep = _remote(server)
    try:
        for _ in range(5):
            assert not rep.submit({}).result(timeout=WAIT).shed
        summary = rep.latency_summary()
        assert summary["p95_ms"] > 0
        assert summary["served"] == 5
    finally:
        rep.close()


# ---------------------------------------------------------------------------
# flight transitions
# ---------------------------------------------------------------------------


def test_wire_reconnect_is_a_flight_transition():
    from splink_tpu_torch.obs.flight import TRANSITION_TYPES, FlightRecorder

    assert "wire_reconnect" in TRANSITION_TYPES
    rec = FlightRecorder(8)
    rec.emit("wire_reconnect", replica="r", attempts=1, downtime_s=0.1)
    assert any(
        r.get("type") == "wire_reconnect" for r in rec.snapshot()
    )


# ---------------------------------------------------------------------------
# Parity and interop: real engines
# ---------------------------------------------------------------------------


def people_df(n=80, seed=11):
    rng = np.random.default_rng(seed)
    firsts = ["amelia", "oliver", "isla", "george", "ava", "noah", "emily"]
    lasts = ["smith", "jones", "taylor", "brown", "wilson", "evans"]
    return pd.DataFrame({
        "unique_id": range(n),
        "first_name": [str(rng.choice(firsts)) for _ in range(n)],
        "surname": [str(rng.choice(lasts)) for _ in range(n)],
        "dob": [f"19{rng.integers(40, 99)}" for _ in range(n)],
    })


def wire_settings(**over):
    s = {
        "link_type": "dedupe_only",
        "comparison_columns": [
            {"col_name": "first_name", "num_levels": 3},
            {"col_name": "surname", "num_levels": 2, "comparison": {"kind": "exact"}},
        ],
        "blocking_rules": ["l.dob = r.dob", "l.surname = r.surname"],
        "max_iterations": 4,
    }
    s.update(over)
    return s


@pytest.fixture(scope="module")
def artifact(tmp_path_factory):
    """dtype -> (frame, directory of the index the port exported)."""
    import splink_tpu_torch

    out = {}
    for dtype in ("float32", "float64"):
        df = people_df()
        linker = splink_tpu_torch.Splink(
            wire_settings(float64=dtype == "float64"), df=df, device="cpu")
        linker.estimate_parameters()
        d = str(tmp_path_factory.mktemp(f"wire_{dtype}"))
        linker.export_index(d)
        out[dtype] = (df, d)
    return out


def _port_service(index_dir):
    from splink_tpu_torch.serve import load_index

    engine = QueryEngine(load_index(index_dir, device="cpu"),
                         policy=BucketPolicy((16,), (64, 256)))
    engine.warmup()
    return LinkageService(engine, deadline_ms=None)


def _records(df, n=40):
    return df.to_dict(orient="records")[:n]


def _assert_bit_equal(local, remote):
    assert sum(1 for r in local if not r.shed) == len(local)
    for lo, re in zip(local, remote):
        assert not re.shed, re.reason
        assert [str(u) for u, _ in lo.matches] == [str(u) for u, _ in re.matches]
        assert [p for _, p in lo.matches] == [p for _, p in re.matches]  # bitwise
        assert lo.n_candidates == re.n_candidates
        assert lo.approx == re.approx


def _close32(a, b):
    a, b = float(a), float(b)
    ulp = float(np.spacing(np.float32(max(abs(a), abs(b)))))
    return abs(a - b) <= 4 * ulp


def _assert_cross_package(ref, port):
    """Equal candidate counts and ids; probabilities within 4 ulp at
    float32; within a run of near-tied probabilities the ids may come in
    another order, so runs compare as sets."""
    for a, b in zip(ref, port):
        assert not a.shed and not b.shed
        assert a.n_candidates == b.n_candidates
        assert len(a.matches) == len(b.matches)
        for (_, pa), (_, pb) in zip(a.matches, b.matches):
            assert _close32(pa, pb), (pa, pb)
        r = 0
        while r < len(a.matches):
            e = r + 1
            while e < len(a.matches) and _close32(a.matches[e][1], a.matches[r][1]):
                e += 1
            if e < len(a.matches) or len(a.matches) < 8:
                assert ({str(u) for u, _ in a.matches[r:e]}
                        == {str(u) for u, _ in b.matches[r:e]}), (r, e)
            r = e


@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_remote_answers_bit_identical_to_local(artifact, dtype):
    """Every (query, match, probability) served over the wire equals the
    locally served one exactly: same matches, same order, same bits."""
    df, index_dir = artifact[dtype]
    svc = _port_service(index_dir)
    server = WireServer(svc).start()
    rep = _remote(server, pool_size=2)
    try:
        records = _records(df)
        local = [svc.query(dict(r), timeout=WAIT) for r in records]
        remote = [f.result(timeout=WAIT) for f in [rep.submit(dict(r)) for r in records]]
        _assert_bit_equal(local, remote)
        batched = rep.submit_many([dict(r) for r in records])
        _assert_bit_equal(local, [f.result(timeout=WAIT) for f in batched])
        if dtype == "float64":
            assert any(p != float(np.float32(p)) for r in remote for _, p in r.matches)
    finally:
        rep.close()
        server.close()
        svc.close()


@pytest.fixture(scope="module")
def interop(artifact):
    """(records, port service, reference service) over the float32 index
    the port exported, each package serving its own load of it."""
    from splink_tpu.serve import BucketPolicy as RefPolicy
    from splink_tpu.serve import LinkageService as RefService
    from splink_tpu.serve import QueryEngine as RefEngine
    from splink_tpu.serve import load_index as ref_load

    df, index_dir = artifact["float32"]
    port_svc = _port_service(index_dir)
    ref_engine = RefEngine(ref_load(index_dir), policy=RefPolicy((16,), (64, 256)))
    ref_engine.warmup()
    ref_svc = RefService(ref_engine, deadline_ms=None)
    yield _records(df), port_svc, ref_svc
    port_svc.close()
    ref_svc.close()


def test_port_remote_against_reference_server(interop):
    from splink_tpu.serve import WireServer as RefWireServer

    records, port_svc, ref_svc = interop
    server = RefWireServer(ref_svc).start()
    rep = RemoteReplica(("127.0.0.1", server.port), pool_size=2,
                        retry_policy=FAST_RETRY, request_timeout_ms=5_000.0)
    try:
        ref_local = [ref_svc.query(dict(r), timeout=WAIT) for r in records]
        remote = [f.result(timeout=WAIT) for f in [rep.submit(dict(r)) for r in records]]
        _assert_bit_equal(ref_local, remote)
        port_local = [port_svc.query(dict(r), timeout=WAIT) for r in records]
        _assert_cross_package(remote, port_local)
        many = rep.submit_many([dict(r) for r in records])
        _assert_bit_equal(ref_local, [f.result(timeout=WAIT) for f in many])
        assert rep.fetch_stats()["counters"]["served"] >= len(records)
    finally:
        rep.close()
        server.close()


def test_reference_remote_against_port_server(interop):
    from splink_tpu.resilience.retry import RetryPolicy as RefRetry
    from splink_tpu.serve import RemoteReplica as RefRemote

    records, port_svc, ref_svc = interop
    server = WireServer(port_svc).start()
    rep = RefRemote(("127.0.0.1", server.port), pool_size=2,
                    retry_policy=RefRetry(base_delay=0.02, max_delay=0.1),
                    request_timeout_ms=5_000.0)
    try:
        port_local = [port_svc.query(dict(r), timeout=WAIT) for r in records]
        remote = [f.result(timeout=WAIT) for f in [rep.submit(dict(r)) for r in records]]
        _assert_bit_equal(port_local, remote)
        ref_local = [ref_svc.query(dict(r), timeout=WAIT) for r in records]
        _assert_cross_package(ref_local, remote)
        many = rep.submit_many([dict(r) for r in records])
        _assert_bit_equal(port_local, [f.result(timeout=WAIT) for f in many])
        assert rep.fetch_stats()["counters"]["served"] >= len(records)
    finally:
        rep.close()
        server.close()

# ---------------------------------------------------------------------------
# Connection cap (wire_max_connections)
# ---------------------------------------------------------------------------


def _handshake(sock, req_id=0):
    """One health exchange: proves the server fully registered the
    connection (the accept loop admits sequentially)."""
    sock.sendall(encode_frame(
        {"v": WIRE_VERSION, "kind": "health", "id": req_id}))
    env = read_frame(sock)
    assert env is not None and env.get("v") == WIRE_VERSION
    return env


def test_connection_cap_sheds_with_error_frame():
    """The (cap+1)-th connection is answered with ONE machine-readable
    `server_overloaded` error envelope and closed — an explicit shed a
    client can distinguish from a partition or a crash."""
    svc = FakeService()
    server = WireServer(svc, max_connections=2).start()
    socks = []
    try:
        for _ in range(2):
            s = socket.create_connection(("127.0.0.1", server.port),
                                         timeout=WAIT)
            _handshake(s)
            socks.append(s)
        over = socket.create_connection(("127.0.0.1", server.port),
                                        timeout=WAIT)
        socks.append(over)
        over.settimeout(WAIT)
        env = read_frame(over)
        assert env == {
            "v": WIRE_VERSION, "kind": "error", "id": None,
            "reason": "server_overloaded", "health": "healthy",
        }
        assert read_frame(over) is None  # then EOF: the socket is closed
        deadline = time.monotonic() + WAIT
        while server.stats()["overloaded_total"] < 1:
            assert time.monotonic() < deadline
            time.sleep(0.01)
        stats = server.stats()
        assert stats["overloaded_total"] == 1
        assert stats["max_connections"] == 2
        assert stats["connections_active"] == 2  # the refused conn never joined
        # the refusal rides the Prometheus exposition too
        samples = {s.name: s.value for s in server.prometheus_samples()}
        assert samples["splink_wire_overloaded_total"] == 1
        # a slot freed by a disconnect re-admits the next dial
        socks[0].close()
        deadline = time.monotonic() + WAIT
        while server.stats()["connections_active"] >= 2:
            assert time.monotonic() < deadline
            time.sleep(0.01)
        again = socket.create_connection(("127.0.0.1", server.port),
                                         timeout=WAIT)
        socks.append(again)
        _handshake(again)
    finally:
        for s in socks:
            try:
                s.close()
            except OSError:
                pass
        server.close()


def test_remote_replica_sheds_past_the_cap():
    """A RemoteReplica dialing a full server fails its liveness handshake
    on the error envelope (no half-dead pooled socket) and submits shed
    machine-readably instead of hanging."""
    svc = FakeService()
    server = WireServer(svc, max_connections=1).start()
    holder = None
    rep = None
    try:
        holder = socket.create_connection(("127.0.0.1", server.port),
                                          timeout=WAIT)
        _handshake(holder)
        rep = _remote(server, eager_connect=False)
        res = rep.submit({"tag": "over"}).result(timeout=WAIT)
        assert res.shed and res.reason == "remote_unreachable"
        assert server.stats()["overloaded_total"] >= 1
        # the slot frees -> the same replica recovers on a later submit
        holder.close()
        holder = None
        deadline = time.monotonic() + WAIT
        while time.monotonic() < deadline:
            res = rep.submit({"tag": "retry"}).result(timeout=WAIT)
            if not res.shed:
                break
            time.sleep(0.05)
        assert not res.shed and res.matches == [("retry", 0.5)]
    finally:
        if rep is not None:
            rep.close()
        if holder is not None:
            holder.close()
        server.close()
