"""The program's spans and counters (utils/profiling.py's run scopes, on
``obs.tracer.Tracer``), on the CPU.

Every linker run scope records, in memory and always, the spans beneath
its stages on ``time.time_ns`` (the clock of ``torch.profiler``'s events)
and a dict of counters. Held here: the clock against the profiler's own
events, a profile_dir trace with the program spans beside the ops, the
span tree of a small virtual-regime job and of a device-tier blocking
job, the counting helpers (through a stand-in for a CUDA tensor: on the
CPU they count nothing), the bound on a scope's spans, and that the
telemetry record (``telemetry_dir``) carries none of it.
"""

import json
import os

import numpy as np
import pandas as pd
import pytest

torch = pytest.importorskip("torch")

from splink_tpu_torch import Splink  # noqa: E402
from splink_tpu_torch import blocking_device, gammas  # noqa: E402
from splink_tpu_torch.obs.tracer import Tracer  # noqa: E402
from splink_tpu_torch.utils import profiling  # noqa: E402


def _people(n=600, seed=0):
    rng = np.random.default_rng(seed)
    first = ["anna", "anne", "annie", "bob", "bobby", "carl", "carla", "dora"]
    last = ["smith", "smyth", "jones", "johns", "brown", "braun"]
    return pd.DataFrame({
        "unique_id": np.arange(n),
        "first_name": rng.choice(first, n),
        "surname": rng.choice(last, n),
        "city": rng.choice(["x", "y", "z", "w"], n),
        "dob": rng.choice([f"d{k}" for k in range(12)], n),
    })


def _settings(**over):
    s = {
        "link_type": "dedupe_only",
        "comparison_columns": [
            {"col_name": "first_name", "num_levels": 3,
             "comparison": {"kind": "jaro_winkler", "thresholds": [0.94, 0.88]}},
            {"col_name": "surname", "num_levels": 3,
             "comparison": {"kind": "jaro_winkler", "thresholds": [0.94, 0.88]}},
            {"col_name": "dob", "num_levels": 2, "comparison": {"kind": "exact"}},
        ],
        "blocking_rules": ["l.city = r.city", "l.dob = r.dob"],
        "max_iterations": 3,
        "pair_batch_size": 4096,
    }
    s.update(over)
    return s


def _by_id(spans):
    return {sp["span_id"]: sp for sp in spans}


def _stage_of(sp, by_id):
    p = by_id.get(sp["parent_id"])
    while p is not None and p["kind"] != "stage":
        p = by_id.get(p["parent_id"])
    return p


@pytest.fixture(scope="module")
def virtual_job():
    lk = Splink(_settings(device_pair_generation="on", max_resident_pairs=1024),
                df=_people(), device="cpu")
    lk.estimate_parameters()
    return lk, profiling.run_spans(lk.run_id), profiling.run_counters(lk.run_id)


# ----------------------------------------------------------------------
# The clock
# ----------------------------------------------------------------------


def test_span_contains_the_profilers_op():
    from torch.profiler import ProfilerActivity, profile

    run = profiling.begin_run("tracing-clock")
    try:
        a, b = torch.ones(96, 96), torch.ones(96, 96)
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            with profiling.span("around"):
                torch.mm(a, b)
        (sp,) = [s for s in profiling.run_spans(run) if s["name"] == "around"]
        (ev,) = [e for e in prof.profiler.kineto_results.events() if e.name() == "aten::mm"]
        assert isinstance(sp["t0"], int) and isinstance(sp["t1"], int)
        assert sp["t0"] <= ev.start_ns() <= ev.end_ns() <= sp["t1"]
        assert sp["run"] == run and sp["parent_id"] is None
    finally:
        profiling.discard_run(run)


def test_profile_dir_trace_holds_the_program_spans(tmp_path):
    """The gammas_patterns stage's Chrome trace carries its program spans as
    complete events on the trace's time base: the stage span spans the
    recorded ops, and each pattern_batch span holds the histogram op that
    batch issued."""
    lk = Splink(_settings(device_pair_generation="on", max_resident_pairs=1024,
                          profile_dir=str(tmp_path)), df=_people(seed=1), device="cpu")
    try:
        lk.estimate_parameters()
    finally:
        profiling.set_trace_dir(None)
    (path,) = [os.path.join(r, f) for r, _d, fs in os.walk(tmp_path / "gammas_patterns")
               for f in fs]
    with open(path) as fh:
        events = json.load(fh)["traceEvents"]
    program = [e for e in events if e.get("cat") == "program"]
    ops = [e for e in events if e.get("ph") == "X" and e.get("cat") == "cpu_op"]
    (stage,) = [e for e in program if e["name"] == "gammas_patterns"]
    batches = [e for e in program if e["name"] == "pattern_batch"]
    assert batches and all(e["args"]["run"] == lk.run_id for e in program)
    first = min(e["ts"] for e in ops)
    last = max(e["ts"] + e["dur"] for e in ops if e["name"].startswith("aten::"))
    assert stage["ts"] <= first and last <= stage["ts"] + stage["dur"]
    hists = [e for e in ops if e["name"] == "aten::bincount"]
    inside = [sum(b["ts"] <= h["ts"] and h["ts"] + h["dur"] <= b["ts"] + b["dur"]
                  for h in hists) for b in batches]
    assert inside == [1] * len(batches)


# ----------------------------------------------------------------------
# The span tree
# ----------------------------------------------------------------------


def test_one_stage_span_per_stage_second(virtual_job):
    lk, spans, _ = virtual_job
    stages = [sp for sp in spans if sp["kind"] == "stage"]
    assert sorted(sp["name"] for sp in stages) == sorted(lk.stage_seconds)
    for sp in stages:
        assert sp["dur_s"] == lk.stage_seconds[sp["name"]]
        assert sp["run"] == lk.run_id


def test_children_lie_inside_their_parents(virtual_job):
    _, spans, _ = virtual_job
    by_id = _by_id(spans)
    children = [sp for sp in spans if sp["parent_id"] is not None]
    assert len(children) > 10
    for sp in children:
        parent = by_id[sp["parent_id"]]
        assert parent["t0"] <= sp["t0"] <= sp["t1"] <= parent["t1"], (sp["name"], parent["name"])


def test_encode_and_gamma_program_children(virtual_job):
    _, spans, _ = virtual_job
    by_id = _by_id(spans)
    columns = [sp for sp in spans if sp["name"] == "column"]
    assert {sp["attrs"]["column"] for sp in columns} >= {"first_name", "surname", "dob"}
    for sp in columns:
        assert by_id[sp["parent_id"]]["name"] == "encode"
        kids = sorted(c["name"] for c in spans if c["parent_id"] == sp["span_id"])
        assert kids == ["factorize", "gather", "pack"]
    program = {c["name"] for c in spans
               if by_id.get(c["parent_id"], {}).get("name") == "gamma_program"}
    assert program == {"pack", "upload"}


def test_one_pattern_batch_span_per_batch(virtual_job):
    lk, spans, counters = virtual_job
    by_id = _by_id(spans)
    batches = [sp for sp in spans if sp["name"] == "pattern_batch"]
    assert len(batches) > 1
    assert all(_stage_of(sp, by_id)["name"] == "gammas_patterns" for sp in batches)
    assert sum(sp["attrs"]["positions"] for sp in batches) == lk._virtual.n_candidates
    (readback,) = [sp for sp in spans if sp["name"] == "pass_readback"]
    assert _stage_of(readback, by_id)["name"] == "gammas_patterns"
    assert readback["counts"]["jw_survivors"] == counters["jw_survivors"]


def test_survivors_count_the_masked_columns(virtual_job):
    lk, _, counters = virtual_job
    n = lk._virtual.n_candidates
    assert counters["jw_pairs"] == 2 * n
    assert counters["jw_pairs.first_name"] == counters["jw_pairs.surname"] == n
    assert 0 < counters["jw_survivors"] <= counters["jw_pairs"]
    assert counters["jw_survivors"] == (counters["jw_survivors.first_name"]
                                        + counters["jw_survivors.surname"])


def test_survivors_agree_across_regimes():
    """The resident GammaStream counts the same survivors a virtual pass
    does over the same pairs, read back with the stream's last batches."""
    df = _people(seed=2)
    s = _settings(blocking_rules=["l.city = r.city"])  # no masked positions
    virtual = Splink(dict(s, device_pair_generation="on", max_resident_pairs=1024), df=df,
                     device="cpu")
    virtual.estimate_parameters()
    resident = Splink(s, df=df, device="cpu")
    resident.estimate_parameters()
    assert "gammas" in resident.stage_seconds
    a, b = (profiling.run_counters(lk.run_id) for lk in (virtual, resident))
    assert a["jw_pairs"] == b["jw_pairs"] == 2 * resident._pairs.n_pairs
    assert a["jw_survivors"] == b["jw_survivors"] > 0
    spans = profiling.run_spans(resident.run_id)
    (finish,) = [sp for sp in spans if sp["name"] == "finish"]
    assert _stage_of(finish, _by_id(spans))["name"] == "gammas"


def test_masked_and_compacted_forms_count_alike(monkeypatch):
    """The card's masked form (its plain stand-in here) and the CPU's
    compacted form add the same survivors to the pass's slots."""
    df = _people(seed=5)
    s = _settings(device_pair_generation="on", max_resident_pairs=1024)
    got = {}
    for form in ("compacted", "masked"):
        monkeypatch.setattr(gammas, "_survivor_levels",
                            getattr(gammas, f"_survivor_levels_{form}"))
        lk = Splink(s, df=df, device="cpu")
        lk.estimate_parameters()
        got[form] = profiling.run_counters(lk.run_id)
    assert got["masked"]["jw_survivors"] == got["compacted"]["jw_survivors"] > 0
    assert got["masked"]["jw_pairs"] == got["compacted"]["jw_pairs"]


def test_device_blocking_spans_fill_last_run():
    """The device tier (on the CPU with device_blocking "on"): plan, emit
    (the emission's pairs span, each consumer call a consume span in it)
    and finish beneath the blocking stage; last_run's seconds are theirs."""
    lk = Splink(_settings(device_blocking="on"), df=_people(seed=3), device="cpu")
    lk.estimate_parameters()
    spans = profiling.run_spans(lk.run_id)
    by_id = _by_id(spans)
    named = {}
    for sp in spans:
        parent = by_id.get(sp["parent_id"], {}).get("name")
        if parent != "gammas":  # the GammaStream's own finish
            named.setdefault(sp["name"], []).append(sp)
    for part in ("plan", "emit", "finish"):
        (sp,) = named[part]
        assert by_id[sp["parent_id"]]["name"] == "blocking"
    (pairs,) = named["pairs"]
    assert by_id[pairs["parent_id"]]["name"] == "emit"
    consume = named["consume"]
    assert consume and all(sp["parent_id"] == pairs["span_id"] for sp in consume)
    assert sum(sp["attrs"]["pairs"] for sp in consume) == lk._pairs.n_pairs
    run = blocking_device.last_run
    assert run["plan_s"] == named["plan"][0]["dur_s"]
    assert run["emit_s"] == named["emit"][0]["dur_s"]
    assert run["finish_s"] == named["finish"][0]["dur_s"]
    assert run["chunks"] == pairs["attrs"]["chunks"] == len(consume)


# ----------------------------------------------------------------------
# The counters
# ----------------------------------------------------------------------


class _OnCard:
    """Stands in for a CUDA tensor of ``n`` elements of ``size`` bytes."""

    is_cuda = True

    def __init__(self, n, size):
        self._n, self._size = n, size

    def numel(self):
        return self._n

    def element_size(self):
        return self._size


def test_counting_helpers_on_a_card_tensor():
    run = profiling.begin_run("tracing-counters")
    try:
        with profiling.span("outer") as outer:
            profiling.note_h2d(_OnCard(10, 8), _OnCard(3, 4))
            with profiling.span("inner") as inner:
                profiling.note_d2h(_OnCard(5, 2))
                profiling.note_d2h(_OnCard(7, 1), wait=False)
                profiling.note_reads(_OnCard(100, 4), 2)
                profiling.note_sync(torch.device("cuda"))
            profiling.note_h2d(_OnCard(1, 4), pinned=True)
        assert profiling.run_counters(run) == {
            "h2d_copies": 3, "h2d_bytes": 96, "h2d_pageable_bytes": 92,
            "d2h_copies": 4, "d2h_bytes": 25, "host_syncs": 6,
        }
        assert outer["counts"] == {"h2d_copies": 3, "h2d_bytes": 96,
                                   "h2d_pageable_bytes": 92, "host_syncs": 2}
        assert inner["counts"] == {"d2h_copies": 4, "d2h_bytes": 25, "host_syncs": 4}
    finally:
        profiling.discard_run(run)


def test_counting_helpers_count_nothing_on_the_cpu(virtual_job):
    run = profiling.begin_run("tracing-cpu")
    try:
        t = torch.ones(4)
        profiling.note_h2d(t)
        profiling.note_d2h(t)
        profiling.note_reads(t, 2)
        profiling.note_sync(torch.device("cpu"))
        assert profiling.run_counters(run) == {}
    finally:
        profiling.discard_run(run)
    _, _, counters = virtual_job
    for name in ("host_syncs", "h2d_copies", "h2d_bytes", "h2d_pageable_bytes",
                 "d2h_copies", "d2h_bytes"):
        assert name not in counters


# ----------------------------------------------------------------------
# Bounds, scopes and the telemetry record
# ----------------------------------------------------------------------


def test_spans_past_the_cap_are_dropped_and_counted():
    tracer = Tracer(max_spans=3)
    for k in range(5):
        with tracer.span(f"s{k}"):
            pass
    assert [sp["name"] for sp in tracer.completed] == ["s0", "s1", "s2"]
    assert tracer.dropped == 2


def test_ending_a_span_not_open_leaves_the_stack():
    tracer = Tracer()
    outer = tracer.begin("outer")
    inner = tracer.begin("inner")
    tracer.end(outer)  # drops the dangling inner span with it
    again = tracer.begin("again")
    tracer.end(inner)  # no longer open: "again" stays open
    assert tracer.current_id() == again
    assert [sp["name"] for sp in tracer.completed] == ["outer"]


def test_run_ids_in_order_and_scopes_evicted_together():
    ids = [profiling.begin_run(f"tracing-order-{k}") for k in range(3)]
    try:
        assert profiling.run_ids()[-3:] == ids
        profiling.discard_run(ids[0])
        assert ids[0] not in profiling.run_ids()
        assert profiling.run_spans(ids[0]) == [] and profiling.run_counters(ids[0]) == {}
        for k in range(profiling._MAX_RETAINED_RUNS + 2):
            profiling.begin_run(f"tracing-evict-{k}")
        assert len(profiling.run_ids()) == profiling._MAX_RETAINED_RUNS
        assert set(profiling._TRACERS) <= set(profiling._TIMINGS)
    finally:
        for rid in list(profiling.run_ids()):
            if rid.startswith("tracing-"):
                profiling.discard_run(rid)


def test_telemetry_record_carries_no_program_spans(tmp_path):
    lk = Splink(_settings(telemetry_dir=str(tmp_path)), df=_people(seed=4), device="cpu")
    lk.estimate_parameters()
    (path,) = tmp_path.glob("run_*.jsonl")
    spans = [e for e in map(json.loads, path.read_text().splitlines()) if e["type"] == "span"]
    assert {e["name"] for e in spans if e["kind"] == "stage"} == set(lk.stage_seconds)
    assert {e["kind"] for e in spans} <= {"stage", "run", "em_iteration"}
    assert not any("counts" in e or "run" in e for e in spans)
    # while the run scope holds them
    assert {"column", "factorize"} <= {sp["name"] for sp in profiling.run_spans(lk.run_id)}
