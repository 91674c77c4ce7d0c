"""Run telemetry of splink_tpu_torch (obs/runtime.py, obs/metrics.py and the
linker, EM, streaming and resilience wiring) held to splink_tpu's.

The oracle is splink_tpu's tests/test_telemetry.py, run here against the
port on the CPU (its trace-audit test belongs to the analysis layer, which
the port does not carry; its compile-monitor test becomes the registry plus
the port's kernel-library build counters). On top of it: the EM trajectory
is bit-identical with telemetry on and off in every EM path (resident,
checkpointed, stepped with a save_state_fn, streamed), each update's
record equals the installed history, and both packages write the same
event types and field names for the same run.
"""

import gc
import glob
import json
import os

import numpy as np
import pandas as pd
import pytest

torch = pytest.importorskip("torch")

import splink_tpu  # noqa: E402
import splink_tpu_torch  # noqa: E402
from splink_tpu_torch import Splink  # noqa: E402
from splink_tpu_torch.obs.cli import main as obs_cli  # noqa: E402
from splink_tpu_torch.obs.events import read_events  # noqa: E402
from splink_tpu_torch.ops.gamma import apply_null  # noqa: E402
from splink_tpu_torch.utils.logging_utils import DegradationWarning  # noqa: E402


def people_df(n=200, seed=0):
    rng = np.random.default_rng(seed)
    return pd.DataFrame({
        "unique_id": np.arange(n),
        "name": rng.choice(["ann", "bob", "cat", "dan"], n),
        "city": rng.choice(["x", "y", "z"], n),
    })


def settings(**over):
    s = {
        "link_type": "dedupe_only",
        "comparison_columns": [
            {"col_name": "name", "num_levels": 2, "comparison": {"kind": "exact"}}
        ],
        "blocking_rules": ["l.city = r.city"],
        "max_iterations": 6,
    }
    s.update(over)
    return s


def port(s, df):
    return Splink(s, df=df, device="cpu")


def run_events(linker):
    """The telemetry events this linker wrote."""
    return read_events(linker._obs.sink.path)


def test_e2e_record_has_spans_metrics_em_and_resilience(tmp_path):
    from splink_tpu_torch.resilience.faults import reset_plans

    reset_plans()
    linker = port(settings(telemetry_dir=str(tmp_path), fault_plan="resident_em@kind=oom"),
                  people_df())
    with pytest.warns(DegradationWarning):
        df_e = linker.get_scored_comparisons(compute_ll=True)
    assert len(df_e)
    events = run_events(linker)
    types = {e["type"] for e in events}
    assert {"run_start", "span", "em_iteration", "em_start", "metrics"} <= types
    assert "fault" in types and "degradation" in types
    assert {e["run_id"] for e in events} == {linker.run_id}
    spans = [e for e in events if e["type"] == "span"]
    assert {"run", "stage", "em_iteration"} <= {e["kind"] for e in spans}
    stage_names = {e["name"] for e in spans if e["kind"] == "stage"}
    assert {"encode", "blocking", "em_streamed"} <= stage_names
    for e in spans:
        assert e["t1"] >= e["t0"] and e["dur_s"] >= 0
    iters = [e for e in events if e["type"] == "em_iteration"]
    assert [e["iteration"] for e in iters] == list(range(1, len(iters) + 1))
    assert all(0 <= e["lam"] <= 1 for e in iters)
    assert all(e["delta"] is not None for e in iters)
    assert any(e["ll"] is not None for e in iters)
    assert iters[-1]["converged"] is True
    snap = [e for e in events if e["type"] == "metrics"][-1]
    c = snap["counters"]
    assert c["rows_encoded"] == 200
    assert c["pairs_blocked"] == len(df_e)
    assert c["pairs_scored_output"] == len(df_e)
    assert c["em_updates"] == len(iters)
    # the compile split carries the port's library builds (none here)
    assert c["compile_count"] >= 0 and c["compile_s"] >= 0
    assert sum(gh for gh in snap["records"]["gamma_histogram"]["name"]) == len(df_e)
    blocks = snap["records"]["largest_blocks"]
    assert blocks[0]["rule"] == "l.city = r.city"
    assert blocks[0]["n_groups"] == 3
    assert sum(blocks[0]["top_group_rows"]) == 200
    assert all(e["process_index"] == 0 and e["process_count"] == 1 for e in events)
    path = linker._obs.sink.path
    assert obs_cli(["summarize", path]) == 0
    out = str(tmp_path / "trace.json")
    assert obs_cli(["export-trace", path, "-o", out]) == 0
    trace = json.load(open(out))
    names = {e["name"] for e in trace["traceEvents"] if e.get("ph") == "X"}
    assert {"run", "encode", "blocking", "em_streamed"} <= names


def _history(linker):
    return [json.dumps(h, sort_keys=True) for h in linker.params.param_history]


@pytest.mark.parametrize("path", ["resident", "checkpointed", "stepped", "streamed", "patterns"])
def test_em_trajectory_bit_identical_with_telemetry(tmp_path, path):
    """The convergence stream must not perturb the dataflow: parameter
    history and scores are bit-identical with telemetry on vs off, and each
    update's record equals the installed history."""
    df = people_df(seed=3)
    over = {}
    if path == "streamed":
        over = dict(max_resident_pairs=1024)
    if path == "patterns":
        over = dict(max_resident_pairs=1024, device_pair_generation="off")
    a = port(settings(**over), df)
    b = port(settings(telemetry_dir=str(tmp_path / "tel"), **over), df)
    for linker, k in ((a, "a"), (b, "b")):
        if path == "checkpointed":
            linker.estimate_parameters(compute_ll=True, checkpoint_dir=str(tmp_path / k))
        elif path == "stepped":
            linker.save_state_fn = lambda params, s: None
            linker.estimate_parameters(compute_ll=True)
        else:
            linker.estimate_parameters(compute_ll=True)
    assert _history(a) == _history(b)
    assert a.params.params == b.params.params
    out_a = a.manually_apply_fellegi_sunter_weights()
    out_b = b.manually_apply_fellegi_sunter_weights()
    np.testing.assert_array_equal(out_a.match_probability.to_numpy(),
                                  out_b.match_probability.to_numpy())
    iters = [e for e in run_events(b) if e["type"] == "em_iteration"]
    assert len(iters) == len(b.params.param_history)
    states = b.params.param_history[1:] + [b.params.params]
    for e, st in zip(iters, states):
        assert e["lam"] == float(np.float32(st["λ"])) or e["lam"] == st["λ"]
    assert iters[-1]["lam"] == pytest.approx(float(b.params.params["λ"]), rel=1e-6)


def test_em_updates_equal_run_em_history():
    """run_em(telemetry=) streams one record per update equal to the
    result's history, and the result equals a run without telemetry bit for
    bit (float32 and float64)."""
    from splink_tpu_torch.em import run_em
    from splink_tpu_torch.params import fsparams_from_numpy

    class Rec:
        def __init__(self):
            self.calls = []

        def em_update(self, it, lam, m, u, ll=None, converged=False):
            self.calls.append((it, lam, np.array(m), np.array(u), ll, converged))

    rng = np.random.default_rng(2)
    G = torch.from_numpy(rng.integers(-1, 3, (4000, 3)).astype(np.int8))
    for dt in (np.float32, np.float64):
        init = fsparams_from_numpy(dt(0.2), rng.random((3, 3)).astype(dt),
                                   rng.random((3, 3)).astype(dt), device="cpu")
        kw = dict(max_iterations=8, max_levels=3, em_convergence=1e-6, compute_ll=True)
        plain = run_em(G, init, **kw)
        rec = Rec()
        tel = run_em(G, init, telemetry=rec, **kw)
        for name in ("lam_history", "m_history", "u_history", "ll_history"):
            np.testing.assert_array_equal(getattr(plain, name), getattr(tel, name))
        assert len(rec.calls) == tel.n_updates
        for it, lam, m, u, ll, conv in rec.calls:
            assert lam == float(tel.lam_history[it])
            np.testing.assert_array_equal(m, tel.m_history[it])
            np.testing.assert_array_equal(u, tel.u_history[it])
            assert ll == float(tel.ll_history[it - 1])
        assert rec.calls[-1][5] == bool(tel.converged)


def test_disabled_telemetry_writes_nothing(tmp_path):
    from splink_tpu_torch.obs import events as ev

    before = list(ev._AMBIENT)
    linker = port(settings(), people_df())
    assert linker._obs.enabled is False
    assert linker._obs.sink is None
    linker.get_scored_comparisons()
    assert list(ev._AMBIENT) == before
    assert not glob.glob(str(tmp_path / "*.jsonl"))


def test_disabled_telemetry_installs_no_em_hook(monkeypatch):
    """The zero-cost rule: with telemetry off the resident EM runs with no
    per-update hook (so no extra host reads)."""
    from splink_tpu_torch import em as em_mod
    from splink_tpu_torch import linker as linker_mod

    seen = []
    orig = em_mod.run_em

    def spy(*a, **kw):
        seen.append((kw.get("on_update"), kw.get("telemetry")))
        return orig(*a, **kw)

    monkeypatch.setattr(linker_mod, "run_em", spy)
    port(settings(), people_df()).estimate_parameters()
    assert seen and all(h is None and t is None for h, t in seen)


def test_checkpoint_events_in_record(tmp_path):
    ckpt = tmp_path / "ckpt"
    tel = tmp_path / "tel"
    linker = port(settings(telemetry_dir=str(tel)), people_df(seed=5))
    linker.estimate_parameters(checkpoint_dir=str(ckpt))
    events = run_events(linker)
    ckpts = [e for e in events if e["type"] == "checkpoint"]
    assert ckpts
    assert ckpts[-1]["converged"] is True
    assert os.path.exists(ckpts[-1]["path"])
    assert any(e["type"] == "em_iteration" for e in events)


def _tel_name_exact(ctx, col_settings):
    pc = ctx.col("name")
    return apply_null((pc.tok_l == pc.tok_r).to(torch.int8), pc.null)


splink_tpu_torch.register_comparison("tel_name_exact", _tel_name_exact)


def streamed_settings(**over):
    """Settings in the streamed-EM regime: a custom comparison rules out
    the pattern pipeline, and the max_resident_pairs floor pushes the gamma
    matrix out of the resident path."""
    s = settings(max_resident_pairs=1024, **over)
    s["comparison_columns"] = list(s["comparison_columns"]) + [{
        "custom_name": "name_custom",
        "custom_columns_used": ["name"],
        "num_levels": 2,
        "comparison": {"kind": "custom", "fn": "tel_name_exact"},
    }]
    return s


def test_streamed_em_emits_convergence_records(tmp_path):
    linker = port(streamed_settings(telemetry_dir=str(tmp_path)), people_df(seed=7))
    linker.get_scored_comparisons()
    events = run_events(linker)
    assert any(e["type"] == "em_start" and e["mode"] == "streamed" for e in events)
    assert any(e["type"] == "em_iteration" for e in events)
    snap = [e for e in events if e["type"] == "metrics"][-1]
    assert snap["counters"]["em_stream_passes"] >= 1


def test_retry_events_published(tmp_path):
    from splink_tpu_torch.resilience.faults import reset_plans

    reset_plans()
    linker = port(streamed_settings(telemetry_dir=str(tmp_path),
                                    fault_plan="batch_fetch@iter=1:batch=0"),
                  people_df(seed=9))
    linker.get_scored_comparisons()
    events = run_events(linker)
    faults = [e for e in events if e["type"] == "fault"]
    retries = [e for e in events if e["type"] == "retry"]
    assert faults and faults[0]["site"] == "batch_fetch"
    assert retries and retries[0]["attempt"] == 1


def test_em_numerics_event_published(tmp_path):
    """A non-finite update publishes the reference's em_numerics event
    before EMNumericsError is raised."""
    from splink_tpu_torch.em import EMNumericsError, run_em_checkpointed
    from splink_tpu_torch.obs.events import publish  # noqa: F401
    from splink_tpu_torch.obs.runtime import RunContext
    from splink_tpu_torch.params import fsparams_from_numpy

    ctx = RunContext.from_settings({"telemetry_dir": str(tmp_path)})
    try:
        G = torch.from_numpy(np.zeros((10, 1), np.int8))
        m = np.array([[np.nan, 0.5]], np.float64)
        init = fsparams_from_numpy(0.5, m, m.copy(), device="cpu")
        with pytest.raises(EMNumericsError):
            run_em_checkpointed(G, init, max_iterations=3, max_levels=2,
                                em_convergence=1e-6, telemetry=ctx)
        ev = [e for e in read_events(ctx.sink.path) if e["type"] == "em_numerics"]
        assert ev and ev[0]["iteration"] == 1 and "m" in ev[0]["fields"]
        assert not [e for e in read_events(ctx.sink.path) if e["type"] == "em_iteration"]
    finally:
        ctx.close()


def test_dropped_linker_stops_receiving_ambient_events(tmp_path):
    from splink_tpu_torch.obs import events as ev
    from splink_tpu_torch.obs.events import publish

    a = port(settings(telemetry_dir=str(tmp_path / "a")), people_df())
    path_a = a._obs.sink.path
    assert a._obs.sink in ev._AMBIENT
    del a
    gc.collect()
    publish("retry", label="late", attempt=1)
    assert all(e["type"] != "retry" for e in read_events(path_a))
    b = port(settings(telemetry_dir=str(tmp_path / "b")), people_df())
    path_b = b._obs.sink.path
    b.close_telemetry()
    assert b._obs.sink not in ev._AMBIENT
    publish("retry", label="late2", attempt=1)
    assert all(e["type"] != "retry" for e in read_events(path_b))


def test_summarize_handles_null_numeric_fields(tmp_path):
    from splink_tpu_torch.obs.events import EventSink

    p = tmp_path / "run_div.jsonl"
    sink = EventSink(p, "div")
    sink.emit("em_iteration", iteration=1, lam=float("nan"), ll=None, delta=None,
              converged=False)
    sink.emit("em_iteration", iteration=None, lam=0.5, converged=False)
    sink.close()
    assert obs_cli(["summarize", str(p)]) == 0


def test_summarize_renders_numerics_events(tmp_path):
    from splink_tpu_torch.obs.cli import summarize_events
    from splink_tpu_torch.obs.events import EventSink

    p = tmp_path / "run_num.jsonl"
    sink = EventSink(p, "num")
    sink.emit("num_audit", kernels=31, tier="cpu", findings=0, worst_ulp=24.0)
    sink.emit("em_numerics", iteration=3, fields=["lam", "m"], last_good_iteration=2,
              checkpoint_dir="/tmp/ckpt", last_checkpoint_iteration=2)
    sink.close()
    out = summarize_events(read_events(p))
    assert "numerics: 1 audit(s), 1 EM halt(s)" in out
    assert "31 kernel(s) on tier cpu" in out
    assert "EM HALT at iteration 3" in out
    assert "non-finite: lam, m" in out
    assert "last finite iteration 2" in out
    assert "checkpoint @2 in /tmp/ckpt" in out
    assert obs_cli(["summarize", str(p)]) == 0


def test_summarize_tolerates_torn_numerics_events(tmp_path):
    from splink_tpu_torch.obs.cli import summarize_events
    from splink_tpu_torch.obs.events import EventSink

    p = tmp_path / "run_torn.jsonl"
    sink = EventSink(p, "torn")
    sink.emit("num_audit")
    sink.emit("em_numerics")
    sink.close()
    out = summarize_events(read_events(p))
    assert "numerics: 1 audit(s), 1 EM halt(s)" in out
    assert "0 kernel(s)" in out
    assert "EM HALT at iteration 0" in out
    assert obs_cli(["summarize", str(p)]) == 0


def test_numerics_events_are_flight_transitions():
    from splink_tpu_torch.obs.flight import TRANSITION_TYPES, FlightRecorder

    assert "em_numerics" in TRANSITION_TYPES
    assert "num_audit" in TRANSITION_TYPES
    rec = FlightRecorder(capacity=8, name="svc")
    try:
        rec.emit("em_numerics", iteration=1, fields=["lam"])
        rec.emit("num_audit", kernels=31, findings=0)
        kinds = [r.get("type") for r in rec.snapshot()]
        assert "em_numerics" in kinds and "num_audit" in kinds
    finally:
        rec.close()


def test_block_stats_bound_matches_estimator():
    from splink_tpu_torch.blocking import block_size_stats, estimate_pair_upper_bound
    from splink_tpu_torch.data import encode_table
    from splink_tpu_torch.settings import complete_settings_dict

    s = complete_settings_dict(settings())
    table = encode_table(people_df(), s)
    stats = block_size_stats(s, table, None)
    assert sum(e["pair_bound"] for e in stats) == estimate_pair_upper_bound(s, table, None)


def test_em_iteration_spans_parented_to_stage(tmp_path):
    linker = port(settings(telemetry_dir=str(tmp_path)), people_df())
    linker.get_scored_comparisons()
    spans = [e for e in run_events(linker) if e["type"] == "span"]
    [em_stage] = [e for e in spans if e["kind"] == "stage" and e["name"] == "em"]
    iter_spans = [e for e in spans if e["kind"] == "em_iteration"]
    assert iter_spans
    assert all(e["parent_id"] == em_stage["span_id"] for e in iter_spans)


def test_sink_failure_disables_not_raises(tmp_path):
    linker = port(settings(telemetry_dir=str(tmp_path)), people_df())
    linker._obs.sink._f.close()
    df_e = linker.get_scored_comparisons()
    assert len(df_e)
    assert linker._obs.sink._failed is True


def test_summarize_empty_and_corrupt_lines(tmp_path):
    p = tmp_path / "run_x.jsonl"
    p.write_text('{"v":1,"run_id":"x","type":"run_start","ts":1,"mono":1}\n{"torn')
    assert len(read_events(p)) == 1
    assert obs_cli(["summarize", str(p)]) == 0
    empty = tmp_path / "empty.jsonl"
    empty.write_text("")
    assert obs_cli(["summarize", str(empty)]) == 0


def test_chrome_trace_from_events_structure():
    from splink_tpu_torch.obs.tracer import chrome_trace_from_events

    events = [
        {"type": "span", "kind": "stage", "name": "em", "t0": 1.0, "t1": 2.5,
         "dur_s": 1.5, "attrs": {"compile_s": 0.5}, "process_index": 0},
        {"type": "em_iteration", "iteration": 1, "lam": 0.3, "mono": 2.0,
         "process_index": 0},
    ]
    trace = chrome_trace_from_events(events)
    slices = [e for e in trace["traceEvents"] if e.get("ph") == "X"]
    instants = [e for e in trace["traceEvents"] if e.get("ph") == "i"]
    assert slices[0]["name"] == "em" and slices[0]["dur"] == pytest.approx(1.5e6)
    assert slices[0]["ts"] == pytest.approx(1.0e6)
    assert instants and instants[0]["args"]["iteration"] == 1


def test_metrics_registry_and_build_counters():
    """The registry, and the port's build counters in place of the
    reference's JIT compile monitor: a build moves compile_totals and the
    stage split; an AOT restore does not."""
    from splink_tpu.obs.metrics import MetricsRegistry as RefRegistry
    from splink_tpu_torch.obs.metrics import (
        MetricsRegistry,
        compile_requests,
        compile_stats,
        compile_totals,
        note_aot_restore,
        note_build,
    )

    r, ref = MetricsRegistry(), RefRegistry()
    for reg in (r, ref):
        reg.count("a")
        reg.count("a", 2)
        reg.gauge("g", 7.5)
        reg.observe("h", 1.0)
        reg.observe("h", 3.0)
        reg.record("blob", {"x": [1, 2]})
    snap = r.snapshot()
    assert snap == ref.snapshot()
    assert snap["counters"]["a"] == 3
    assert snap["histograms"]["h"] == {"count": 2, "sum": 4.0, "min": 1.0, "max": 3.0,
                                       "mean": 2.0}
    c0, s0 = compile_totals()
    before = compile_stats()
    note_build(0.25)
    c1, s1 = compile_totals()
    assert c1 == c0 + 1 and s1 == pytest.approx(s0 + 0.25)
    assert compile_requests() == c1
    note_aot_restore(3)
    after = compile_stats()
    assert after["aot_restores"] == before["aot_restores"] + 3
    assert after["compiles"] == after["requests"] == c1
    assert compile_totals()[0] == c1


def test_stage_span_carries_library_builds(tmp_path, monkeypatch):
    """A library build inside a stage lands in its span's compile split,
    under the reference's keys."""
    from splink_tpu_torch.obs import metrics

    linker = port(settings(telemetry_dir=str(tmp_path)), people_df())
    real = linker._ensure_encoded

    def encode_with_build():
        metrics.note_build(0.5)
        return real()

    monkeypatch.setattr(linker, "_ensure_encoded", encode_with_build)
    with linker._timed("gamma_program"):
        linker._ensure_encoded()
    spans = [e for e in run_events(linker) if e["type"] == "span"
             and e["name"] == "gamma_program"]
    assert spans[-1]["attrs"]["compile_count"] == 1
    assert spans[-1]["attrs"]["compile_s"] == pytest.approx(0.5)


def test_device_memory_snapshot_is_empty_on_cpu():
    from splink_tpu_torch.obs.metrics import device_memory_snapshot

    if torch.cuda.is_available():  # pragma: no cover - the CPU test tier
        pytest.skip("a CUDA device is present")
    assert device_memory_snapshot() == []


def test_event_sanitisation(tmp_path):
    from splink_tpu_torch.obs.events import EventSink

    sink = EventSink(tmp_path / "s.jsonl", "r1")
    sink.emit("x", a=np.float32(1.5), b=np.arange(3), c=float("nan"), d=np.bool_(True),
              e={"k": np.int64(7)})
    sink.close()
    [ev] = read_events(tmp_path / "s.jsonl")
    assert ev["a"] == 1.5 and ev["b"] == [0, 1, 2] and ev["c"] is None


def test_record_schema_matches_reference(tmp_path):
    """The same run through both packages writes the same event types, and
    every event type the same field names, so either package's CLI reads
    the other's record."""
    df = people_df(seed=4)
    ref = splink_tpu.Splink(settings(telemetry_dir=str(tmp_path / "ref")), df=df)
    ref.get_scored_comparisons(compute_ll=True)
    ref.close_telemetry()
    mine = port(settings(telemetry_dir=str(tmp_path / "port")), df)
    mine.get_scored_comparisons(compute_ll=True)
    mine.close_telemetry()
    (rp,) = glob.glob(str(tmp_path / "ref" / "*.jsonl"))
    (pp,) = glob.glob(str(tmp_path / "port" / "*.jsonl"))

    def shape(path):
        out = {}
        for e in read_events(path):
            key = (e["type"], e.get("kind"))
            out.setdefault(key, set()).update(e)
        return out

    want, got = shape(rp), shape(pp)
    assert set(got) == set(want)
    for key in want:
        assert got[key] == want[key], key
    snap_r = [e for e in read_events(rp) if e["type"] == "metrics"][-1]
    snap_p = [e for e in read_events(pp) if e["type"] == "metrics"][-1]
    assert set(snap_p["counters"]) == set(snap_r["counters"])
    assert set(snap_p["records"]) == set(snap_r["records"])
    for k in ("rows_encoded", "pairs_blocked", "pairs_gamma_scored", "pairs_scored_output"):
        assert snap_p["counters"][k] == snap_r["counters"][k], k
    assert snap_p["records"]["gamma_histogram"] == snap_r["records"]["gamma_histogram"]
    assert snap_p["records"]["largest_blocks"] == snap_r["records"]["largest_blocks"]


def _ref_tel_name_exact(ctx, col_settings):
    import jax.numpy as jnp
    from splink_tpu.ops.gamma import apply_null as ref_apply_null

    pc = ctx.col("name")
    return ref_apply_null((pc.tok_l == pc.tok_r).astype(jnp.int8), pc.null)


splink_tpu.register_comparison("tel_name_exact", _ref_tel_name_exact)


def _diagnostic_frame(n=400, seed=12):
    """A frame whose fit draws both identifiability warnings: ``noise``
    is unrelated to matching (m ~= u), and ``age``'s middle level needs an
    absolute difference in (0.5, 1.0] that integer ages never give (~zero
    support)."""
    rng = np.random.default_rng(seed)
    base = people_df(n, seed)
    base["noise"] = rng.choice(["p", "q"], n)
    base["age"] = rng.integers(20, 23, n).astype(float)
    return base


def _diagnostic_settings(path):
    if path == "streamed":  # the custom comparison rules patterns out
        s = streamed_settings(float64=True, max_iterations=8)
    else:
        s = settings(float64=True, max_iterations=8)
    s["comparison_columns"] = list(s["comparison_columns"]) + [
        {"col_name": "noise", "num_levels": 2, "comparison": {"kind": "exact"}},
        {"col_name": "age", "num_levels": 3, "data_type": "numeric",
         "comparison": {"kind": "numeric_abs", "thresholds": [1.0, 0.5]}},
    ]
    if path == "patterns":
        s.update(max_resident_pairs=1024, device_pair_generation="off")
    return s


@pytest.mark.parametrize("path", ["resident", "patterns", "streamed"])
def test_em_identifiability_warnings_logged_as_the_reference(path, caplog):
    """Every fit logs the reference's "EM identifiability: ..." warnings,
    with telemetry off: the same set of messages on the same frame (float64,
    where the two packages' EM agree far below the messages' 4 digits)."""
    import logging

    df = _diagnostic_frame()
    s = _diagnostic_settings(path)
    logs = {}
    for name, make in (("splink_tpu", lambda: splink_tpu.Splink(json.loads(json.dumps(s)),
                                                                df=df)),
                       ("splink_tpu_torch", lambda: port(json.loads(json.dumps(s)), df))):
        caplog.clear()
        with caplog.at_level(logging.WARNING, logger=name):
            linker = make()
            linker.estimate_parameters()
        logs[name] = sorted(r.getMessage() for r in caplog.records
                            if r.name == name and r.getMessage().startswith("EM identifiability"))
        if name == "splink_tpu_torch":
            assert linker._obs.enabled is False
            assert linker._use_pattern_pipeline() == (path == "patterns")
    # a streamed fit with telemetry off counts no level support (as in the
    # reference), so only its m~=u warnings can fire
    if path != "streamed":
        assert any("~zero training support" in m for m in logs["splink_tpu_torch"])
    assert any("m~=u" in m for m in logs["splink_tpu_torch"])
    assert logs["splink_tpu_torch"] == logs["splink_tpu"]
