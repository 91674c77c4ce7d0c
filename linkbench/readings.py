"""The readings that the comparison's limits are set from; not part of a
benchmark run.

    python3 -m linkbench.readings --workload <cell> --seeds <n> ... [--control <n> ...]

For each of ``--seeds``: the cell's input from the seed, one whole job of
the program at the cell's size through the window's own entry, and the
numbers that compare it with the reference (the lower readings). For each
of ``--control``: the control, which is the reference put in the
program's place and computed one precision below the configuration's
(bfloat16 for its float32 similarities and EM), compared in the same way
(the upper readings). One JSON line a seed and kind.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np
import torch

from . import harness
from .reference import check
from .reference import em as ref_em

CONTROL_DTYPE = torch.bfloat16


def control_numbers(cell, df, settings, device, ref, ref_traj) -> dict:
    """The numbers of the control against the reference ``ref``."""
    ctrl = check.reference_pass(df, settings, device, dtype=CONTROL_DTYPE,
                                keep_pairs=ref.keys is not None)
    traj = check.em_trajectory(ctrl.hist, ctrl.levels, settings, dtype=CONTROL_DTYPE)
    out = check.em_numbers(traj, ref_traj)
    if ref.keys is not None:
        out.update(check.pair_numbers(ctrl.keys, ctrl.gammas, ref))
    else:
        out["pairs_gap"] = abs(int(ctrl.hist.sum()) - ref.total)
        out["pattern_gap"] = int(np.abs(ctrl.hist - ref.hist).sum())
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="*", default=[])
    ap.add_argument("--control", type=int, nargs="*", default=[])
    ap.add_argument("--program-float64", action="store_true")
    args = ap.parse_args(argv)
    device = "cuda"
    if not torch.cuda.is_available():
        print("no CUDA card", file=sys.stderr)
        return 3
    cell = harness.load_cell(args.workload)
    settings = cell.settings
    keep = cell.workload.get("keep_pairs", False)
    for seed in dict.fromkeys(args.seeds + args.control):
        t0 = time.perf_counter()
        df = harness.make_frame(cell, seed)
        n_pairs = harness.pair_count(df, settings)
        lines = []
        if seed in args.seeds:
            run_settings = {**settings, "float64": True} if args.program_float64 else settings
            job = harness.run_job(run_settings, df, device, cell.traffic["entry"],
                                  keep_pairs=keep)
            faults = harness.job_faults(job, cell, settings, n_pairs, on_card=True)
            job_s = job.seconds
        torch.cuda.empty_cache()
        ref = check.reference_pass(df, settings, device, keep_pairs=keep)
        ref_traj = check.em_trajectory(ref.hist, ref.levels, settings)
        if seed in args.seeds:
            numbers = harness.check_numbers([job], job if keep else None, ref, ref_traj, len(df))
            lines.append({"kind": "program_float64" if args.program_float64 else "program",
                          "faults": faults, "job_s": job_s,
                          "em_updates": len(job.trajectory) - 1,
                          "worst_leaf": ref_em.worst_leaf(job.trajectory, ref_traj), **numbers})
            del job
        if seed in args.control:
            lines.append({"kind": "control", **control_numbers(cell, df, settings, device,
                                                                ref, ref_traj)})
        for line in lines:
            print(json.dumps({"workload": args.workload, "seed": seed, "pairs": ref.total,
                              "ref_em_updates": len(ref_traj) - 1,
                              "seconds": time.perf_counter() - t0, **line}), flush=True)
        del ref
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
