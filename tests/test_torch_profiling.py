"""Stage timings and the profiler trace hook of splink_tpu_torch
(utils/profiling.py, the linker's ``profile_dir``).

The oracle is the StageTimer, ``profile_dir`` and per-run scoping tests of
splink_tpu's tests/test_observability.py, run here against the port on the
CPU with ``torch.profiler`` in place of ``jax.profiler``: each traced stage
writes one Chrome trace (JSON) under ``<profile_dir>/<stage>``. Also: the
linker's ``stage_seconds`` equals the run scope's timings, and a trace
records the stage's own torch ops.
"""

import json
import os

import numpy as np
import pandas as pd
import pytest

torch = pytest.importorskip("torch")

from splink_tpu_torch import Splink  # noqa: E402
from splink_tpu_torch.utils import profiling  # noqa: E402
from splink_tpu_torch.utils.profiling import (  # noqa: E402
    StageTimer,
    reset_timings,
    set_trace_dir,
    stage_timings,
)


def _tiny_df(n=60, seed=0):
    rng = np.random.default_rng(seed)
    return pd.DataFrame({
        "unique_id": np.arange(n),
        "name": rng.choice(["a", "b", "c"], n),
        "city": rng.choice(["x", "y"], n),
    })


def _tiny_settings(**over):
    s = {
        "link_type": "dedupe_only",
        "comparison_columns": [{"col_name": "name", "comparison": {"kind": "exact"}}],
        "blocking_rules": ["l.city = r.city"],
        "max_iterations": 2,
    }
    s.update(over)
    return s


def _files(root):
    return [os.path.join(r, f) for r, _d, files in os.walk(root) for f in files]


def test_stage_timings_recorded_through_pipeline():
    reset_timings()
    linker = Splink(_tiny_settings(max_iterations=3), df=_tiny_df(120, 11), device="cpu")
    linker.get_scored_comparisons()
    t = stage_timings()
    for stage in ("encode", "blocking", "gammas", "em"):
        assert stage in t and t[stage][0] >= 0, (stage, t.keys())
        # the linker's own record is the scope's last timing of the stage
        assert linker.stage_seconds[stage] == t[stage][-1]


def test_stage_timer_trace_hook_writes_profile(tmp_path):
    """StageTimer(trace_dir=...) wraps the stage in torch.profiler and
    leaves a Chrome trace behind that records the stage's own ops."""
    trace_dir = str(tmp_path / "trace")
    with StageTimer("traced_stage", trace_dir=trace_dir):
        torch.mm(torch.ones(32, 32), torch.ones(32, 32))
    produced = _files(trace_dir)
    assert len(produced) == 1 and produced[0].endswith(".json"), produced
    with open(produced[0]) as fh:
        trace = json.load(fh)
    names = {e.get("name") for e in trace["traceEvents"]}
    assert "aten::mm" in names
    assert "traced_stage" in stage_timings()
    assert not profiling._TRACE_ACTIVE


def test_profile_dir_captures_traces(tmp_path):
    """settings["profile_dir"] -> each device-heavy stage writes one trace
    under <profile_dir>/<stage>; other stages write none."""
    rng = np.random.default_rng(0)
    df = pd.DataFrame({
        "unique_id": range(200),
        "name": rng.choice(["ann", "bob", "cat"], 200),
        "dob": rng.choice([f"d{k}" for k in range(10)], 200),
    })
    s = {
        "link_type": "dedupe_only",
        "comparison_columns": [{"col_name": "name", "num_levels": 2}],
        "blocking_rules": ["l.dob = r.dob"],
        "max_iterations": 2,
        "profile_dir": str(tmp_path),
    }
    try:
        Splink(s, df=df, device="cpu").get_scored_comparisons()
        found = _files(tmp_path)
        assert found, "no trace files captured"
        stages = {os.path.basename(os.path.dirname(f)) for f in found}
        assert stages == {"gammas", "em"}
        for f in found:
            with open(f) as fh:
                assert json.load(fh)["traceEvents"]
    finally:
        set_trace_dir(None)


def test_timings_scoped_per_linker_run():
    a = Splink(_tiny_settings(), df=_tiny_df(seed=1), device="cpu")
    a.get_scored_comparisons()
    t_a = stage_timings(run=a.run_id)
    assert "em" in t_a and len(t_a["em"]) == 1
    b = Splink(_tiny_settings(), df=_tiny_df(seed=2), device="cpu")
    assert stage_timings() == {}
    b.get_scored_comparisons()
    assert len(stage_timings(run=b.run_id)["em"]) == 1
    assert stage_timings(run=a.run_id) == t_a
    a2 = Splink(_tiny_settings(), df=_tiny_df(seed=3), device="cpu")
    b2 = Splink(_tiny_settings(), df=_tiny_df(seed=4), device="cpu")
    b2.get_scored_comparisons()
    a2.get_scored_comparisons()
    assert len(stage_timings(run=a2.run_id)["em"]) == 1
    assert len(stage_timings(run=b2.run_id)["em"]) == 1


def test_later_linker_does_not_clear_earlier_trace_dir(tmp_path):
    a = Splink(_tiny_settings(profile_dir=str(tmp_path)), df=_tiny_df(seed=5), device="cpu")
    Splink(_tiny_settings(), df=_tiny_df(seed=6), device="cpu")  # no profile_dir
    a.get_scored_comparisons()
    assert _files(tmp_path), "later linker clobbered the first linker's profile_dir"


def test_stage_timer_does_not_nest_profiler_traces(tmp_path):
    """A second torch.profiler cannot start inside a running one: an inner
    StageTimer with a trace dir skips tracing while an outer trace is
    active, and traces again once it is released."""
    with StageTimer("outer", trace_dir=str(tmp_path / "outer")) as outer:
        assert outer._trace is not None and profiling._TRACE_ACTIVE
        with StageTimer("inner", trace_dir=str(tmp_path / "inner")) as inner:
            assert inner._trace is None
        assert profiling._TRACE_ACTIVE
    assert not profiling._TRACE_ACTIVE
    assert not os.path.exists(tmp_path / "inner")
    with StageTimer("after", trace_dir=str(tmp_path / "after")) as after:
        assert after._trace is not None
    assert not profiling._TRACE_ACTIVE
    assert len(_files(tmp_path / "outer")) == len(_files(tmp_path / "after")) == 1


def test_stage_timer_trace_active_exception_safety(tmp_path):
    """The profiler stops and the flag clears when the stage body raises,
    and the flag clears even when the profiler's own stop raises."""
    with pytest.raises(RuntimeError, match="boom"):
        with StageTimer("failing", trace_dir=str(tmp_path / "t1")):
            torch.ones(4).sum()
            raise RuntimeError("boom")
    assert not profiling._TRACE_ACTIVE
    assert len(_files(tmp_path / "t1")) == 1  # the failed stage's trace
    # and a new profiler starts: the failed one really stopped
    with StageTimer("next", trace_dir=str(tmp_path / "t2")) as nxt:
        assert nxt._trace is not None

    class _ExplodingTrace:
        def __exit__(self, *exc):
            raise OSError("profiler write failed")

    timer = StageTimer("bad_exit", trace_dir=str(tmp_path / "t3"))
    with pytest.raises(OSError, match="profiler write failed"):
        with timer:
            assert timer._trace is not None
            real, timer._trace = timer._trace, _ExplodingTrace()
            real.__exit__(None, None, None)  # stop the real one first
    assert not profiling._TRACE_ACTIVE
    assert "bad_exit" in stage_timings()


def test_stage_timer_sync_runs_before_the_clock_stops():
    """The linker's device synchronise runs inside the stage's time, and
    not when the stage raised."""
    calls = []
    with StageTimer("synced", sync=lambda: calls.append(1)):
        pass
    assert calls == [1]
    with pytest.raises(ValueError):
        with StageTimer("synced", sync=lambda: calls.append(2)):
            raise ValueError
    assert calls == [1]
    assert len(stage_timings()["synced"]) == 2
