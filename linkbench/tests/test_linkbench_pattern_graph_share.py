"""``pattern_graph_share``, the share of the virtual pattern pass's batches
that replayed a CUDA graph, from a small ``--trace 1`` run of each cell on
the CPU (the harness's look for a card is skipped, as in the control tests)
and from the counters of a card's job put in by hand.

What the CPU cannot show: no batch replays a graph there, so the metric
reads 0 wherever the pass runs."""

import json
import time
from pathlib import Path

import pytest

from linkbench import harness
from test_linkbench_reference import SMALL

REPO = Path(__file__).resolve().parents[2]
BENCH = json.loads((REPO / "BENCHMARK.json").read_text())
NAME = "pattern_graph_share"


@pytest.fixture(scope="module", params=list(SMALL))
def traced(request):
    cell = request.param
    rows, small = SMALL[cell]
    r = harness.run_cell(cell, 2**31 + 29, 0.1, True, time.perf_counter(), device="cpu",
                         rows=rows, overrides=small, log=lambda *a, **k: None)
    return cell, r


def _view(monkeypatch, counters):
    from splink_tpu_torch.utils import profiling

    stages = {"encode": 0.5, "gammas_patterns": 1.5}
    spans = [{"name": k, "kind": "stage", "dur_s": v} for k, v in stages.items()]
    monkeypatch.setattr(profiling, "run_ids", lambda: ["job"])
    monkeypatch.setattr(profiling, "run_spans", lambda rid: spans)
    monkeypatch.setattr(profiling, "run_counters", lambda rid: counters)
    return harness.RunView(jobs=[harness.Job(2.0, 2.0, stages, {}, {}, [])], window_s=2.0,
                           pairs_per_job=1, setup_s=1.0, peak_bytes=None)


def test_reported_where_the_cells_list_it(traced):
    """0% in the cells that list it (the CPU replays no graph), absent in
    the others, whose jobs run no virtual pass."""
    cell, r = traced
    assert r["correct"] and r["failed"] == 0
    (entry,) = [m for m in BENCH["per_layer"] if m["name"] == NAME]
    if cell in entry["workloads"]:
        assert r["metrics"][NAME]["value"] == 0
    else:
        assert NAME not in r["metrics"]


def test_replays_over_batches(monkeypatch):
    counters = {"pattern_batches": 305, "pattern_graph_captures": 2,
                "pattern_graph_replays": 302}
    read = harness.metric_reader(NAME)
    assert read(_view(monkeypatch, counters)) == pytest.approx(100 * 302 / 305)
    del counters["pattern_graph_replays"]
    assert read(_view(monkeypatch, counters)) == 0


def test_nothing_without_batches_or_scopes(monkeypatch):
    """No batches counted (the resident regime, or the parent of the
    change, which has no such counter) and no run scopes at all both give
    no reading and raise nothing."""
    read = harness.metric_reader(NAME)
    assert read(_view(monkeypatch, {"host_syncs": 3})) is None
    from splink_tpu_torch.utils import profiling

    monkeypatch.delattr(profiling, "run_spans")
    view = harness.RunView(jobs=[harness.Job(1.0, 1.0, {"encode": 0.1}, {}, {}, [])],
                           window_s=1.0, pairs_per_job=1, setup_s=1.0, peak_bytes=None)
    assert read(view) is None
