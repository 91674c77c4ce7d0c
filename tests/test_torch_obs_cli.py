"""The ``obs`` CLI of splink_tpu_torch (obs/cli.py, ``python -m
splink_tpu_torch.obs``).

The oracles are splink_tpu's CLI tests that needed the CLI: from
tests/test_wire.py ``test_summarize_renders_wire_events`` and
``test_summarize_tolerates_torn_wire_records``; from tests/test_fleet.py
``test_summarize_renders_fleet_section_torn_tolerant``,
``test_attribute_renders_wire_decomposition`` and the
``parse_prometheus_text`` / ``render_fleet_dash`` half of
``test_aggregator_prometheus_endpoint_renders``. Then the cross test: the
reference's renderers read a run record the port wrote, and the port's
read one the reference wrote, with the same sections; and the module entry
point runs in a child process.
"""

import glob
import json
import os
import subprocess
import sys
import time

import numpy as np
import pandas as pd
import pytest

torch = pytest.importorskip("torch")

import splink_tpu  # noqa: E402
import splink_tpu_torch  # noqa: E402
from splink_tpu.obs import cli as ref_cli  # noqa: E402
from splink_tpu_torch.obs import cli  # noqa: E402
from splink_tpu_torch.obs.events import read_events  # noqa: E402
from splink_tpu_torch.obs.exposition import render_samples  # noqa: E402
from splink_tpu_torch.obs.fleet import FleetAggregator  # noqa: E402
from splink_tpu_torch.obs.kernelwatch import HIST_EDGES  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_summarize_renders_wire_events():
    evs = [
        {"type": "wire_connect", "mono": 1.0, "server": "wire:serve",
         "peer": "127.0.0.1:5", "conn": 1},
        {"type": "wire_shed", "mono": 2.0, "replica": "remote:h:1",
         "reason": "connection_lost", "n": 3},
        {"type": "wire_reconnect", "mono": 3.0, "replica": "remote:h:1",
         "attempts": 4, "downtime_s": 1.25},
        {"type": "wire_partition_heal", "mono": 4.0, "server": "wire:serve",
         "duration_s": 0.5, "dropped": 2},
    ]
    out = cli.summarize_events(evs)
    assert ("wire tier: 1 connect(s), 0 disconnect(s), 1 reconnect(s), "
            "1 shed burst(s), 1 partition heal(s)") in out
    assert "shed remote:h:1: 3 x connection_lost" in out
    assert "reconnect remote:h:1: 4 attempt(s), 1.25s down" in out
    assert "partition heal wire:serve: 0.5s, 2 connection(s) dropped" in out


def test_summarize_tolerates_torn_wire_records():
    evs = [
        {"type": "wire_shed", "mono": 1.0},
        {"type": "wire_reconnect", "mono": 2.0},
        {"type": "wire_partition_heal", "mono": 3.0},
    ]
    out = cli.summarize_events(evs)
    assert "wire tier" in out
    assert "shed ?: 0 x ?" in out
    assert "reconnect ?: 0 attempt(s), 0s down" in out


def test_summarize_renders_fleet_section_torn_tolerant():
    events = [
        {"type": "fleet_scrape"},
        {"type": "incident_bundle"},
        {"type": "fleet_net_alert", "alerts": [{}]},
        {"type": "fleet_scrape", "hosts": 2, "unreachable": ["r-b"], "served": 41},
        {"type": "fleet_net_alert", "replica": "remote:a",
         "alerts": [{"short_p95_ms": 9.0, "long_p95_ms": 3.0, "anchor_ms": 2.0,
                     "ratio": 4.5}]},
        {"type": "fleet_net_clear", "replica": "remote:a"},
        {"type": "incident_bundle", "trigger": "partition", "path": "/tmp/incident_x",
         "files": ["manifest.json"], "unreachable": []},
        {"type": "request_trace", "outcome": "delivered", "wall_ms": 2.0,
         "remote_span": {"t0": 1.0, "wall_ms": 1.0}, "clock_offset_s": 0.0001,
         "wire_ms": {"serialize": 0.1, "network": 0.5, "server": 1.2,
                     "deserialize": 0.1}},
    ]
    out = cli.summarize_events(events)
    assert "federation scrape" in out
    assert "NET ALERT" in out
    assert "net alert cleared" in out
    assert "BUNDLE [partition]" in out
    assert "unreachable: r-b" in out
    assert "stitched" in out


def test_attribute_renders_wire_decomposition():
    phases = {"admission": 0.1, "queue_wait": 0.2, "coalesce": 0.1, "dispatch": 0.3,
              "compile": 0.0, "execute": 0.8, "transfer": 0.1, "deliver": 0.4}
    events = [
        {"type": "request_trace", "outcome": "delivered", "wall_ms": 2.0,
         "phases_ms": phases, "remote_span": {"t0": 1.0},
         "wire_ms": {"serialize": 0.11, "network": 0.52, "server_queue": 0.21,
                     "server_execute": 0.83, "deserialize": 0.07}}
        for _ in range(3)
    ]
    out = cli.attribute_events(events)
    assert "wire decomposition over 3 stitched remote attempt(s)" in out
    for hop in ("serialize", "network", "server_queue", "server_execute", "deserialize"):
        assert hop in out


class _StubService:
    """The fleet_stats half of a service: what FleetAggregator reads."""

    def __init__(self, name, served):
        self.name = name
        self.served = served

    def fleet_stats(self):
        return {
            "replica": self.name,
            "t_mono": time.monotonic(),
            "health": "healthy",
            "breaker_state": "closed",
            "index_generation": 1,
            "counters": {"served": self.served, "shed": 0},
            "perf": {"edges": list(HIST_EDGES),
                     "phases": {"execute": {"counts": [2, 1], "sum": 0.75, "n": 3}}},
        }


def test_fleet_dash_parses_the_aggregator_endpoint():
    agg = FleetAggregator(local=_StubService("local", 3), min_scrape_interval_s=0.0)
    text = render_samples(agg.prometheus_samples())
    rows = cli.parse_prometheus_text(text)
    assert ("splink_fleet_hosts", {}, 1.0) in rows
    dash = cli.render_fleet_dash(rows)
    assert "federated hosts: 1" in dash
    assert "served=3" in dash
    assert "execute" in dash
    # the reference's parser and dashboard read the port's endpoint alike
    assert ref_cli.parse_prometheus_text(text) == rows
    assert ref_cli.render_fleet_dash(rows).splitlines()[1:] == dash.splitlines()[1:]


def _people(n=200, seed=0):
    rng = np.random.default_rng(seed)
    return pd.DataFrame({
        "unique_id": np.arange(n),
        "name": rng.choice(["ann", "bob", "cat", "dan"], n),
        "city": rng.choice(["x", "y", "z"], n),
    })


def _settings(tdir):
    return {
        "link_type": "dedupe_only",
        "comparison_columns": [
            {"col_name": "name", "num_levels": 2, "comparison": {"kind": "exact"}}
        ],
        "blocking_rules": ["l.city = r.city"],
        "max_iterations": 6,
        "telemetry_dir": str(tdir),
    }


@pytest.fixture(scope="module")
def records(tmp_path_factory):
    """One run record written by each package for the same job."""
    d = tmp_path_factory.mktemp("records")
    df = _people(seed=2)
    ref = splink_tpu.Splink(_settings(d / "ref"), df=df)
    ref.get_scored_comparisons(compute_ll=True)
    ref.close_telemetry()
    port = splink_tpu_torch.Splink(_settings(d / "port"), df=df, device="cpu")
    port.get_scored_comparisons(compute_ll=True)
    port.close_telemetry()
    (rp,) = glob.glob(str(d / "ref" / "*.jsonl"))
    (pp,) = glob.glob(str(d / "port" / "*.jsonl"))
    return rp, pp


def _sections(text):
    """The report's section heads: the first word of each blank-line
    separated block (the values, and the port's extra stage rows, differ;
    the sections do not)."""
    return [block.split()[0] for block in text.split("\n\n") if block.strip()]


@pytest.mark.parametrize("renderer", ["summarize_events", "drift_events_report",
                                      "attribute_events"])
def test_each_cli_reads_the_other_packages_record(records, renderer):
    rp, pp = records
    for path in (rp, pp):
        events = read_events(path)
        mine = getattr(cli, renderer)(events)
        theirs = getattr(ref_cli, renderer)(events)
        assert mine == theirs
    a = getattr(cli, renderer)(read_events(rp))
    b = getattr(cli, renderer)(read_events(pp))
    assert _sections(a) == _sections(b)


def test_summarize_sections_of_a_port_record(records):
    _, pp = records
    out = cli.summarize_events(read_events(pp))
    for section in ("stage", "EM:", "EM diagnostics", "metrics (final snapshot):"):
        assert section in out
    for stage in ("encode", "blocking", "gammas", "em", "score", "assemble"):
        assert f"\n{stage} " in out


def test_export_trace_of_a_port_record(records, tmp_path):
    _, pp = records
    out = tmp_path / "trace.json"
    assert cli.main(["export-trace", pp, "-o", str(out)]) == 0
    names = {e["name"] for e in json.load(open(out))["traceEvents"] if e.get("ph") == "X"}
    assert {"run", "encode", "blocking", "em"} <= names
    ref_out = tmp_path / "ref_trace.json"
    assert ref_cli.main(["export-trace", pp, "-o", str(ref_out)]) == 0
    assert json.load(open(ref_out)) == json.load(open(out))


def test_module_entry_point_runs(records):
    """``python -m splink_tpu_torch.obs summarize <record>`` in a child."""
    _, pp = records
    env = dict(os.environ, PYTHONPATH=REPO + os.pathsep + os.environ.get("PYTHONPATH", ""))
    proc = subprocess.run([sys.executable, "-m", "splink_tpu_torch.obs", "summarize", pp],
                          capture_output=True, text=True, timeout=240, env=env, cwd=REPO)
    assert proc.returncode == 0, proc.stderr
    assert "EM:" in proc.stdout and "\nencode " in proc.stdout
