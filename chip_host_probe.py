#!/usr/bin/env python3
"""Does the perf audit's host probe move with the registry's launch-bound
programs? Measures both on one NVIDIA GPU, in turns.

    python3 chip_host_probe.py TREE [TREE ...]

Each TREE is a directory that holds a splink_tpu_torch package (a checkout,
or a ``git archive`` of one unpacked); each is measured in a fresh child
process, in the order given, twice: once as the process starts, and once
after a ``torch.profiler`` session that traced the card (chip_smoke.py
traces the card three times before its ``analysis`` phase). Each turn
reports ``perf_audit.host_probe_ms`` and, for the cells of
:data:`CELLS`, the median of 5 best-of-5 execute walls (ms) as the perf
audit's re-measure takes them, then the same probe again.

Give each tree twice, in turns (A, B, B, A), to read the spread. Prints
the card's name and power limit as nvidia-smi gives them, then one JSON
line per turn. Imports nothing of JAX or splink_tpu; exits non-zero
without a CUDA device.
"""

from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys

#: perf cells (``kernel@label`` of the ``cuda`` plan) that the turns time
CELLS = (
    "em_step@reg", "em_step@x32", "em_step@x8192", "gamma_batch@reg", "gamma_batch@x16",
    "serve_drift_sketch@reg", "serve_score_topk@x64", "serve_score_topk_brownout@reg",
    "serve_score_fused@reg", "pattern_kernel@x4096",
)


def turn(state: str) -> dict:
    """One turn in this process: the probe, the cells, the probe again."""
    import torch

    from splink_tpu_torch.analysis import perf_audit as pa

    dev = torch.device("cuda")
    pa._prepare(dev)
    if state == "after_profiler":
        from torch.profiler import ProfilerActivity, profile

        x = torch.zeros(16, dtype=torch.float32, device=dev)
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]):
            for _ in range(256):
                x.add_(1.0)
            torch.cuda.synchronize()
    plan = {f"{c.kernel}@{c.label}": c for c in pa.perf_plan(tier="cuda")}
    probe_before = pa.host_probe_ms(dev)
    cells = {}
    for name in CELLS:
        _, (fn, args, kwargs) = pa._cell(plan[name], dev)
        clock = pa._Clock(dev)
        cells[name] = statistics.median(
            pa._execute_best_of(clock, fn, args, kwargs, 5) for _ in range(5))
    return {"tree": os.getcwd(), "state": state, "probe_ms": [probe_before, pa.host_probe_ms(dev)],
            "cells_ms": cells}


def main(trees: list[str]) -> int:
    import torch

    if not torch.cuda.is_available() or not trees:
        print("chip_host_probe: needs a CUDA device and at least one tree", file=sys.stderr)
        return 2
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip(), flush=True)
    rc = 0
    for tree in trees:
        for state in ("fresh", "after_profiler"):
            child = subprocess.run(
                [sys.executable, os.path.abspath(__file__), "--turn", state],
                cwd=os.path.abspath(tree), capture_output=True, text=True,
                env=dict(os.environ, PYTHONPATH=os.path.abspath(tree)),
            )
            if child.returncode:
                print(child.stderr[-2000:], file=sys.stderr)
                rc = 1
                continue
            print(child.stdout.strip().splitlines()[-1], flush=True)
    return rc


if __name__ == "__main__":
    if sys.argv[1:2] == ["--turn"]:
        print(json.dumps(turn(sys.argv[2])))
        sys.exit(0)
    sys.exit(main(sys.argv[1:]))
