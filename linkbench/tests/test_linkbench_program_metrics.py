"""The per-layer metrics that read the program's spans and counters, from a
small ``--trace 1`` run of each cell on the CPU (the harness's look for a
card is skipped, as in the control tests).

What the CPU cannot show: nothing is copied to or waited for on a card, so
``host_syncs_per_job`` and ``pageable_h2d_mib`` read 0 here (on the card
they count every upload, read and synchronise); and the device blocking
tier runs on the CPU only when asked for, so the resident run sets
``device_blocking: "on"`` to give ``blocking_plan_s`` something to read
(left to the cell's "auto", the CPU takes the host join and the metric is
absent). On the card the check is the same: ``blocking_plan_s`` at most
``blocking_s``."""

import json
import math
import time
from pathlib import Path

import pytest

from linkbench import harness
from test_linkbench_reference import SMALL

REPO = Path(__file__).resolve().parents[2]
BENCH = json.loads((REPO / "BENCHMARK.json").read_text())
NEW = ("pattern_batch_host_ms", "gamma_program_upload_s", "encode_factorize_s",
       "blocking_plan_s", "host_syncs_per_job", "pageable_h2d_mib", "jw_survivor_share")
EXTRA = {"people_train_resident": {"device_blocking": "on"}}


@pytest.fixture(scope="module", params=list(SMALL))
def traced(request):
    cell = request.param
    rows, small = SMALL[cell]
    r = harness.run_cell(cell, 2**31 + 17, 0.1, True, time.perf_counter(), device="cpu",
                         rows=rows, overrides={**small, **EXTRA.get(cell, {})},
                         log=lambda *a, **k: None)
    return cell, r


def test_new_metrics_where_their_cells_list_them(traced):
    cell, r = traced
    assert r["correct"] and r["failed"] == 0
    listed = {m["name"] for m in BENCH["per_layer"] if cell in m.get("workloads", [])}
    want = listed & set(NEW)
    assert want and want <= set(r["metrics"]), (cell, sorted(r["metrics"]))
    assert not set(NEW) - listed & set(r["metrics"])


def test_new_metrics_finite_and_not_negative(traced):
    _, r = traced
    for name in NEW:
        if name in r["metrics"]:
            value = r["metrics"][name]["value"]
            assert math.isfinite(value) and value >= 0, (name, value)
    # the CPU copies nothing to a card
    assert r["metrics"]["host_syncs_per_job"]["value"] == 0
    assert r["metrics"]["pageable_h2d_mib"]["value"] == 0
    assert 0 < r["metrics"]["jw_survivor_share"]["value"] < 100


def test_spans_consistent_with_the_stages(traced):
    cell, r = traced
    m = {k: v["value"] for k, v in r["metrics"].items()}
    assert m["gamma_program_upload_s"] <= m["gamma_program_s"]
    assert m["encode_factorize_s"] <= m["encode_s"]
    if cell == "people_train_resident":
        assert m["blocking_plan_s"] <= m["blocking_s"]
    else:
        assert 0 < m["pattern_batch_host_ms"] <= 1e3 * m["pattern_pass_s"]


def test_readers_return_nothing_without_the_programs_scopes(monkeypatch):
    """A program without run-scope spans (the parent of this change) gives
    no reading and raises nothing."""
    from splink_tpu_torch.utils import profiling

    monkeypatch.delattr(profiling, "run_spans")
    view = harness.RunView(jobs=[harness.Job(1.0, 1.0, {"encode": 0.1}, {}, {}, [])],
                           window_s=1.0, pairs_per_job=1, setup_s=1.0, peak_bytes=None)
    assert all(harness.metric_reader(name)(view) is None for name in NEW)
