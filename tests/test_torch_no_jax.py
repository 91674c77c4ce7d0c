"""splink_tpu_torch runs with jax and splink_tpu made unimportable.

A subprocess installs a ``sys.meta_path`` finder that refuses ``jax``,
``jaxlib`` and ``splink_tpu`` (and their submodules), imports every module
of splink_tpu_torch (the CASE compiler, the q-gram and phonetic ops and the
kernels' wrappers included), then drives the linker on the CPU through
every comparison kind: dmetaphone, qgram_jaccard, qgram_cosine,
numeric_abs, a hand-written CASE for the general compiler, a registered
custom comparison, and a dmetaphone blocking key. The run must succeed and
leave no refused module loaded. It then drives the regimes past
max_resident_pairs (max_resident_pairs 1024): the pattern regime through
device pair generation, and a checkpointed estimate_parameters in the
streamed regime (the custom comparison rules patterns out). Last, the
device sort-join tier (``device_blocking: "on"``) and ``build_spill_dir``
with the spill-fed streamed EM. Then serving: ``export_index``, a saved and
loaded artifact, a warmed QueryEngine, a LinkageService answering
submitted records (the obs copies it builds included), and ``python -m
splink_tpu_torch.serve`` (``--help``, ``build`` and ``query`` on the CPU),
and the serving fleet: a saved and restored AOT sidecar, a WireServer, a
RemoteReplica behind a ReplicaRouter and a FleetAggregator's exposition.
Then the approximate tier (``approx_blocking`` with TF weighting) in
training and in an index's serving fallback. Last, observability: a run
with ``telemetry_dir`` and ``profile_dir``, a profiled index (saved and
loaded) under a sketching engine and a service's drift snapshot, and
``python -m splink_tpu_torch.obs summarize`` of the run's record. Last, the
measured analysis layers: ``python -m splink_tpu_torch.analysis --audit
--num-audit --device cpu --kernels em_step,jaro_winkler``.
"""

import os
import subprocess
import sys

import pytest

pytest.importorskip("torch")
pytest.importorskip("pandas")

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

CODE = r'''
import importlib, pkgutil, sys

BLOCKED = ("jax", "jaxlib", "splink_tpu")


class Refuse:
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in BLOCKED:
            raise ImportError(f"{name} is blocked in this test")
        return None


sys.meta_path.insert(0, Refuse())

import numpy as np
import pandas as pd
import torch

import splink_tpu_torch

names = [m.name for m in pkgutil.walk_packages(splink_tpu_torch.__path__, "splink_tpu_torch.")]
for name in names:
    importlib.import_module(name)
for want in ("case_compiler", "ops.qgram", "ops.phonetic", "ops.strings_cuda", "native",
             "pairgen", "parallel.streaming", "resilience.checkpoint", "resilience.faults",
             "resilience.retry", "utils.logging_utils", "blocking_device", "spill",
             "serve", "serve.index", "serve.engine", "serve.service", "serve.bucketing",
             "serve.admission", "serve.health", "serve.__main__", "analysis.lockwatch",
             "obs.events", "obs.flight", "obs.reqtrace", "obs.slo", "obs.kernelwatch",
             "obs.metrics", "approx", "approx.minhash", "approx.lsh", "serve.aot",
             "serve.router", "serve.wire", "serve.remote", "obs.fleet", "obs.exposition",
             "obs.tracer", "utils.envfp", "obs.runtime", "obs.quality", "obs.drift",
             "obs.cli", "obs.__main__", "utils.profiling", "analysis.findings",
             "analysis.trace_audit", "analysis.perf_audit", "analysis.num_audit",
             "analysis.__main__"):
    assert f"splink_tpu_torch.{want}" in names, want


def custom(ctx, col_settings):
    pc = ctx.col("surname")
    return torch.where(pc.null, -1, (pc.len_l == pc.len_r).to(torch.int8))


splink_tpu_torch.register_comparison("same_length", custom)
rng = np.random.default_rng(0)
pool = np.array(["smith", "smyth", "jones", "johns", "martha", "marhta", None], object)
n = 300
df = pd.DataFrame({"unique_id": np.arange(n),
                   "first_name": pool[rng.integers(0, len(pool), n)],
                   "surname": pool[rng.integers(0, len(pool), n)],
                   "city": pool[rng.integers(0, len(pool), n)],
                   "postcode": pool[rng.integers(0, len(pool), n)],
                   "dob": rng.integers(0, 5, n).astype(float),
                   "blk": rng.integers(0, 10, n)})
case = ("CASE WHEN city_l IS NULL OR city_r IS NULL THEN -1 WHEN city_l = city_r THEN 3 "
        "WHEN jaro_winkler_sim(city_l, city_r) > 0.92 THEN 2 "
        "WHEN levenshtein(substr(city_l,1,4), substr(city_r,1,4)) <= 1 OR "
        "jaccard_sim(Q3gramTokeniser(city_l), Q3gramTokeniser(city_r)) > 0.6 THEN 1 ELSE 0 END")
settings = {
    "link_type": "dedupe_only",
    "blocking_rules": ["l.blk = r.blk", "dmetaphone(l.surname) = dmetaphone(r.surname)"],
    "comparison_columns": [
        {"col_name": "first_name", "num_levels": 3, "comparison": {"kind": "dmetaphone"}},
        {"col_name": "surname", "num_levels": 3,
         "comparison": {"kind": "qgram_jaccard", "q": 2, "thresholds": [0.7, 0.4]}},
        {"col_name": "postcode", "num_levels": 2,
         "comparison": {"kind": "qgram_cosine", "q": 3, "thresholds": [0.5]}},
        {"col_name": "dob", "data_type": "numeric", "num_levels": 2,
         "comparison": {"kind": "numeric_abs", "thresholds": [1.0]}},
        {"col_name": "city", "num_levels": 4, "case_expression": case},
        {"custom_name": "surname_len", "custom_columns_used": ["surname"], "num_levels": 2,
         "comparison": {"kind": "custom", "fn": "same_length"}},
    ],
}
linker = splink_tpu_torch.Splink(settings, df=df, device="cpu")
out = linker.get_scored_comparisons()
kinds = [c["comparison"]["kind"] for c in linker.settings["comparison_columns"]]
assert kinds == ["dmetaphone", "qgram_jaccard", "qgram_cosine", "numeric_abs", "case_sql",
                 "custom"], kinds
p = out["match_probability"].to_numpy()
assert len(out) > 1000 and np.isfinite(p).all() and (p >= 0).all() and (p <= 1).all()
for c in ("first_name", "surname", "postcode", "city"):
    assert len(np.unique(out[f"gamma_{c}"])) > 2, c
# the pattern regime: device pair generation past max_resident_pairs
pattern = dict(settings, max_resident_pairs=1024,
               comparison_columns=settings["comparison_columns"][:5])
plinker = splink_tpu_torch.Splink(pattern, df=df, device="cpu")
pout = plinker.get_scored_comparisons()
assert plinker.device_pair_generation_active and len(pout) > 1000
# a checkpointed estimate_parameters in the streamed regime
import os, tempfile
from splink_tpu_torch.resilience import load_checkpoint

ckpt = tempfile.mkdtemp()
slinker = splink_tpu_torch.Splink(dict(settings, max_resident_pairs=1024, max_iterations=4),
                                  df=df, device="cpu")
slinker.estimate_parameters(checkpoint_dir=ckpt)
assert not slinker._use_pattern_pipeline()
assert load_checkpoint(ckpt).iteration == len(slinker.params.param_history)
# the device sort-join tier, and the durable store feeding the spill-fed
# streamed EM (the custom comparison rules patterns out)
from splink_tpu_torch import blocking

before = blocking.tiers["device"]
dlinker = splink_tpu_torch.Splink(dict(settings, device_blocking="on"), df=df, device="cpu")
dout = dlinker.get_scored_comparisons()
assert blocking.tiers["device"] == before + 1 and len(dout) == len(out)
spill = tempfile.mkdtemp()
plinker = splink_tpu_torch.Splink(dict(settings, max_resident_pairs=1024, max_iterations=4,
                                       build_spill_dir=spill), df=df, device="cpu")
plinker.estimate_parameters()
assert plinker._pairs.spill_store.completed and "em_streamed" in plinker.stage_seconds
# serving: export, save, load, a warmed engine and the service
import contextlib, io, runpy
from splink_tpu_torch.serve import BucketPolicy, LinkageService, QueryEngine, load_index
from splink_tpu_torch.serve.__main__ import main as serve_main

d = tempfile.mkdtemp()
linker.export_index(os.path.join(d, "idx"))
engine = QueryEngine(load_index(os.path.join(d, "idx"), device="cpu"), top_k=8,
                     policy=BucketPolicy((16,), (64, 512)))
assert engine.warmup()["combinations"] == 2
top_p, top_rows, top_valid, n_cand = engine.query_arrays(df.head(20))
assert top_valid.any() and (n_cand > 0).any()
with LinkageService(engine, deadline_ms=5.0) as svc:
    res = [svc.query(r, timeout=60) for r in df.head(5).to_dict(orient="records")]
assert not any(r.shed for r in res) and any(r.matches for r in res)
assert svc.latency_summary()["served"] == 5
# the serving fleet: the AOT sidecar, the wire tier, the router, federation
from splink_tpu_torch.obs.exposition import render_samples
from splink_tpu_torch.obs.fleet import FleetAggregator
from splink_tpu_torch.serve import RemoteReplica, ReplicaRouter, WireServer

assert engine.save_aot(os.path.join(d, "aot")).endswith("aot_menu.json")
aot_engine = QueryEngine(load_index(os.path.join(d, "idx"), device="cpu"), top_k=8,
                         policy=BucketPolicy((16,), (64, 512)), aot_dir=os.path.join(d, "aot"))
assert aot_engine.warmup()["compiles"] == 0 and aot_engine._aot_ready_store() is not None
with LinkageService(engine, deadline_ms=5.0, name="fleet-a") as fsvc:
    server = WireServer(fsvc).start()
    remote = RemoteReplica(server.address, pool_size=1)
    router = ReplicaRouter([remote, fsvc], hedge_ms=0)
    recs = df.head(5).to_dict(orient="records")
    got = [router.query(dict(r), timeout=60) for r in recs]
    assert [g.matches for g in got] == [fsvc.query(dict(r), timeout=60).matches for r in recs]
    text = render_samples(FleetAggregator(remotes=[remote]).prometheus_samples())
    assert "splink_fleet_hosts 1" in text
    remote.close()
    server.close()
# the CLI: build from a saved model, then query
linker.save_model_as_json(os.path.join(d, "model.json"))
df.to_csv(os.path.join(d, "ref.csv"), index=False)
with contextlib.redirect_stdout(io.StringIO()) as buf:
    assert serve_main(["build", "--model", os.path.join(d, "model.json"), "--data",
                       os.path.join(d, "ref.csv"), "--out", os.path.join(d, "cli"),
                       "--device", "cpu"]) == 0
    assert serve_main(["query", "--index", os.path.join(d, "cli"), "--data",
                       os.path.join(d, "ref.csv"), "--k", "3", "--device", "cpu"]) == 0
lines = buf.getvalue().splitlines()
assert '"built"' in lines[0] and len(lines) > 20, lines[:3]
sys.argv = ["splink_tpu_torch.serve", "--help"]
with contextlib.redirect_stdout(io.StringIO()) as buf:
    try:
        runpy.run_module("splink_tpu_torch.serve", run_name="__main__")
    except SystemExit as e:
        assert e.code == 0, e.code
assert "build" in buf.getvalue() and "bench" in buf.getvalue()
# the approximate tier: training with it, and an index serving garbled
# queries through its fallback
approx = dict(settings, approx_blocking=True, approx_threshold=0.2, approx_pair_budget=2000,
              approx_tf_weighting=True, comparison_columns=settings["comparison_columns"][:4],
              blocking_rules=["l.blk = r.blk"])
alinker = splink_tpu_torch.Splink(approx, df=df, device="cpu")
aout = alinker.get_scored_comparisons()
assert len(aout) > 1000 and np.isfinite(aout["match_probability"]).all()
aengine = QueryEngine(alinker.export_index(), top_k=8, policy=BucketPolicy((16,), (512,)))
garbled = df.head(10).assign(blk=-1)
assert aengine.query(garbled)["approx"].any()
# observability: telemetry and profiler traces, a profiled index under a
# sketching engine, the drift snapshot, and the obs CLI on the record
import glob
from splink_tpu_torch.obs.events import read_events

tel, prof = tempfile.mkdtemp(), tempfile.mkdtemp()
olinker = splink_tpu_torch.Splink(dict(settings, telemetry_dir=tel, profile_dir=prof,
                                       quality_profile=True, max_iterations=3),
                                  df=df, device="cpu")
olinker.get_scored_comparisons()
oindex = olinker.export_index(os.path.join(d, "profiled"))
olinker.close_telemetry()
types = {e["type"] for e in read_events(olinker._obs.sink.path)}
assert {"span", "em_iteration", "metrics", "em_diagnostics", "quality_profile"} <= types, types
assert glob.glob(os.path.join(prof, "em", "*.json"))
loaded = load_index(os.path.join(d, "profiled"), device="cpu")
assert loaded.profile is not None and loaded.profile.n_pairs == oindex.profile.n_pairs
sengine = QueryEngine(loaded, top_k=8, policy=BucketPolicy((16,), (64, 512)))
assert sengine.sketch is not None
sengine.warmup()
sengine.query(df.head(12))
window = sengine.drain_drift()
assert window.counters["queries"] == 12 and window.score_all.sum() > 0
with LinkageService(sengine, deadline_ms=5.0) as dsvc:
    dsvc.query(df.head(1).to_dict(orient="records")[0], timeout=60)
    dsvc._drift_tick(force=True)
    assert dsvc.drift_snapshot()["reference"] is True
sys.argv = ["splink_tpu_torch.obs", "summarize", olinker._obs.sink.path]
with contextlib.redirect_stdout(io.StringIO()) as buf:
    try:
        runpy.run_module("splink_tpu_torch.obs", run_name="__main__")
    except SystemExit as e:
        assert e.code == 0, e.code
assert "EM:" in buf.getvalue() and "EM diagnostics" in buf.getvalue(), buf.getvalue()
# the measured analysis layers: the trace and num audits through the CLI
sys.argv = ["splink_tpu_torch.analysis", "--audit", "--num-audit", "--device", "cpu",
            "--kernels", "em_step,jaro_winkler"]
with contextlib.redirect_stdout(io.StringIO()) as buf:
    try:
        runpy.run_module("splink_tpu_torch.analysis", run_name="__main__")
    except SystemExit as e:
        assert e.code == 0, (e.code, buf.getvalue())
assert "0 finding(s)" in buf.getvalue() and "2 kernel(s) audited" in buf.getvalue(), \
    buf.getvalue()
bad = sorted(m for m in sys.modules if m.split(".")[0] in BLOCKED)
assert not bad, bad
print("ok", len(names), len(out))
'''


def test_port_imports_and_runs_every_kind_without_jax():
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = ROOT
    res = subprocess.run([sys.executable, "-c", CODE], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stdout + res.stderr
    assert res.stdout.startswith("ok "), res.stdout
