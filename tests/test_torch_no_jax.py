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
with the spill-fed streamed EM.
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
             "resilience.retry", "utils.logging_utils", "blocking_device", "spill"):
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
