"""The replica router of splink_tpu_torch (serve/router.py).

The oracle is splink_tpu's tests/test_serve_resilience.py (its router
tests and the Replica protocol conformance), run over the port: routing
around a broken replica, failover on a shed, every replica shed, hedging a
slow primary, hedging off, the p95-derived hedge delay, and conformance of
the port's LinkageService, RemoteReplica and a fake to the Replica
protocol. Against the reference: both packages' routers over the same
fakes give the same answers and counters. Over real services: a router
over two port services fails over from a closed one, and a traced router
request closes exactly one delivered span tree. Every wait is bounded.
"""

import threading
import time
from concurrent.futures import Future

import numpy as np
import pytest

torch = pytest.importorskip("torch")
pd = pytest.importorskip("pandas")

from splink_tpu_torch.obs import events  # noqa: E402
from splink_tpu_torch.serve import (  # noqa: E402
    BROKEN,
    DEGRADED,
    HEALTHY,
    BucketPolicy,
    LinkageService,
    QueryEngine,
    QueryResult,
    RemoteReplica,
    Replica,
    ReplicaRouter,
    WireServer,
)

WAIT = 10  # "never hangs" budget per future


class FakeReplica:
    """Duck-typed replica: resolves with a result naming itself, after an
    optional delay, or sheds."""

    result_type = QueryResult

    def __init__(self, name, state=HEALTHY, delay_s=0.0, shed_reason=None):
        self.name = name
        self.state = state
        self.delay_s = delay_s
        self.shed_reason = shed_reason
        self.submissions = 0

    @property
    def health_state(self):
        return self.state

    def health(self):
        return {"state": self.state, "replica": self.name}

    def latency_summary(self):
        return {"p95_ms": 10.0}

    def _result(self):
        if self.shed_reason:
            return self.result_type(shed=True, reason=self.shed_reason)
        return self.result_type(matches=[(self.name, 1.0)], n_candidates=1)

    def submit(self, record, deadline_ms=None):
        self.submissions += 1
        fut = Future()
        if self.delay_s:
            t = threading.Timer(self.delay_s, fut.set_result, [self._result()])
            t.daemon = True
            t.start()
        else:
            fut.set_result(self._result())
        return fut


def test_router_routes_around_broken_replica():
    a = FakeReplica("a", state=BROKEN)
    b = FakeReplica("b")
    router = ReplicaRouter([a, b], hedge_ms=0)
    for _ in range(4):
        res = router.query({"x": 1}, timeout=WAIT)
        assert res.matches[0][0] == "b"
    assert a.submissions == 0  # healthy replica absorbs all traffic


def test_router_fails_over_on_shed():
    a = FakeReplica("a", shed_reason="closed")
    b = FakeReplica("b", state=DEGRADED)  # ranked after a, still tried
    router = ReplicaRouter([a, b], hedge_ms=0)
    res = router.query({"x": 1}, timeout=WAIT)
    assert not res.shed and res.matches[0][0] == "b"
    assert router.failovers == 1


def test_router_all_shed_resolves_shed():
    a = FakeReplica("a", shed_reason="queue_full")
    b = FakeReplica("b", shed_reason="breaker_open")
    router = ReplicaRouter([a, b], hedge_ms=0)
    res = router.query({"x": 1}, timeout=WAIT)
    assert res.shed and res.reason in ("queue_full", "breaker_open")
    assert a.submissions == 1 and b.submissions == 1


def test_router_hedges_slow_primary():
    a = FakeReplica("a", delay_s=0.8)
    b = FakeReplica("b", delay_s=0.0)
    router = ReplicaRouter([a, b], hedge_ms=40)
    router._rr = 0  # pin the rotation so the slow replica is primary
    t0 = time.monotonic()
    res = router.query({"x": 1}, timeout=WAIT)
    elapsed = time.monotonic() - t0
    assert res.matches[0][0] == "b"
    assert elapsed < 0.6, "hedge must beat the slow primary"
    assert router.hedges == 1 and router.hedge_wins == 1


def test_router_hedge_disabled_waits_for_primary():
    a = FakeReplica("a", delay_s=0.15)
    b = FakeReplica("b")
    router = ReplicaRouter([a, b], hedge_ms=0)
    router._rr = 0
    res = router.query({"x": 1}, timeout=WAIT)
    assert res.matches[0][0] == "a"
    assert router.hedges == 0 and b.submissions == 0


def test_router_p95_derived_hedge_delay():
    a = FakeReplica("a")
    router = ReplicaRouter([a, FakeReplica("b")], hedge_ms="p95")
    # p95 10ms -> floored to the default 20ms
    assert router._hedge_delay_ms(a) == 20.0
    assert ReplicaRouter([a], hedge_ms=50)._hedge_delay_ms(a) is None


def test_router_empty_raises():
    with pytest.raises(ValueError, match="at least one replica"):
        ReplicaRouter([])


@pytest.mark.parametrize("scenario", [
    [("a", BROKEN, None), ("b", HEALTHY, None)],
    [("a", HEALTHY, "closed"), ("b", DEGRADED, None)],
    [("a", HEALTHY, "queue_full"), ("b", HEALTHY, "breaker_open")],
    [("a", DEGRADED, None), ("b", HEALTHY, None), ("c", BROKEN, "deadline")],
])
def test_router_matches_reference_router(scenario):
    """The same fakes behind both packages' routers: the same answers, the
    same submissions per replica and the same counters."""
    from splink_tpu.serve import QueryResult as RefResult
    from splink_tpu.serve import ReplicaRouter as RefRouter

    class RefFake(FakeReplica):
        result_type = RefResult

    outcomes = []
    for router_cls, fake_cls in ((ReplicaRouter, FakeReplica), (RefRouter, RefFake)):
        fakes = [fake_cls(n, state=s, shed_reason=r) for n, s, r in scenario]
        router = router_cls(fakes, hedge_ms=0)
        answers = []
        for i in range(6):
            res = router.query({"x": i}, timeout=WAIT)
            answers.append((res.shed, res.reason, list(res.matches)))
        outcomes.append((answers, [f.submissions for f in fakes],
                         router.dispatched, router.failovers, router.hedges))
    assert outcomes[0] == outcomes[1]


# ---------------------------------------------------------------------------
# Over real services
# ---------------------------------------------------------------------------


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


@pytest.fixture(scope="module")
def engine():
    import splink_tpu_torch

    settings = {
        "link_type": "dedupe_only",
        "comparison_columns": [
            {"col_name": "first_name", "num_levels": 3},
            {"col_name": "surname", "num_levels": 2, "comparison": {"kind": "exact"}},
        ],
        "blocking_rules": ["l.dob = r.dob", "l.surname = r.surname"],
        "max_iterations": 3,
        "serve_top_k": 16,
    }
    linker = splink_tpu_torch.Splink(settings, df=people_df(), device="cpu")
    linker.estimate_parameters()
    eng = QueryEngine(linker.export_index(), policy=BucketPolicy((16,), (64, 256)))
    eng.warmup()
    return eng


def _service(engine, **over):
    kw = dict(deadline_ms=2.0, watchdog_interval_s=0.02, breaker_cooldown_s=0.2)
    kw.update(over)
    return LinkageService(engine, **kw)


RECORD = {"first_name": "amelia", "surname": "smith", "dob": "1970"}


def test_replica_protocol_conformance(engine):
    """The local service, the wire client and a fake satisfy the Replica
    protocol structurally and behaviourally."""
    svc = _service(engine, deadline_ms=None)
    server = WireServer(svc).start()
    remote = RemoteReplica(("127.0.0.1", server.port), pool_size=1)
    fake = FakeReplica("fake")
    try:
        for rep in (svc, remote, fake):
            assert isinstance(rep, Replica), type(rep).__name__
            res = rep.submit(dict(RECORD), deadline_ms=None).result(timeout=WAIT)
            assert isinstance(res, QueryResult)
            assert not res.shed, (type(rep).__name__, res.reason)
            assert rep.health_state in (HEALTHY, DEGRADED, BROKEN)
            assert "p95_ms" in rep.latency_summary()
        assert not isinstance(object(), Replica)
    finally:
        remote.close()
        server.close()
        svc.close()


def test_router_fails_over_from_closed_service(engine):
    a = _service(engine, deadline_ms=None, name="a")
    b = _service(engine, deadline_ms=None, name="b")
    try:
        router = ReplicaRouter([a, b], hedge_ms=0)
        expect = b.query(dict(RECORD), timeout=WAIT)
        a.close()
        for _ in range(4):
            res = router.query(dict(RECORD), timeout=WAIT)
            assert not res.shed and res.matches == expect.matches
        assert router.failovers >= 1
    finally:
        a.close()
        b.close()


def test_traced_router_request_closes_one_delivered_tree(engine):
    closed = []

    class _Sink:
        def emit(self, etype, **fields):
            if etype == "request_trace":
                closed.append(fields)

    sink = _Sink()
    events.register_ambient(sink)
    svc = _service(engine, deadline_ms=None, name="traced")
    try:
        router = ReplicaRouter([svc], hedge_ms=0, trace_sample_rate=1.0)
        res = router.query(dict(RECORD), timeout=WAIT)
        assert not res.shed
        deadline = time.monotonic() + WAIT
        while not closed and time.monotonic() < deadline:
            time.sleep(0.01)
        delivered = [e for e in closed if e.get("outcome") == "delivered"]
        assert len(delivered) == 1 and delivered[0]["service"] == "traced"
    finally:
        events.unregister_ambient(sink)
        svc.close()
