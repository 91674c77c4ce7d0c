#!/usr/bin/env python3
"""Compare checkouts of splink_tpu_torch on one NVIDIA GPU, in turns.

    python3 chip_ab.py TREE [TREE ...]

Each TREE is a directory that holds a splink_tpu_torch package (a checkout,
or a ``git archive`` of one unpacked). The trees are measured one after the
other in this process, in the order given, on the same inputs:

  * the dense Jaro-Winkler kernel on 2,000,000 seeded pairs of width 24
    (uint8): device ms with a cold L2 and call ms, as chip_smoke.py times
    them, and its output, which must be equal in every tree;
  * the whole two-phase Jaro-Winkler step of one column (bound, survivors,
    kernel, levels) on the first pair batch of chip_smoke.py's main path
    (1,000,000 seeded rows): median host ms from the call to a
    synchronize, and its levels, which must be equal in every tree;
  * the main path's training (``Splink(...).estimate_parameters()`` on the
    same rows: encode, blocking, gammas, EM, no output frame): wall
    seconds and ``stage_seconds``, and the fitted lambda, which must be
    equal in every tree.

Give each tree twice, in turns (A, B, B, A), to read
the spread. Prints the card's name and power limit as nvidia-smi gives
them, then one JSON line per turn. Imports nothing of JAX or splink_tpu;
exits non-zero without a CUDA device.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time


HERE = os.path.dirname(os.path.abspath(__file__))


def load_tree(tree: str):
    """splink_tpu_torch's gammas and strings_cuda modules from ``tree``,
    after dropping any copy of the package imported before."""
    for name in list(sys.modules):
        if name == "splink_tpu_torch" or name.startswith("splink_tpu_torch."):
            del sys.modules[name]
    root = os.path.abspath(tree)
    sys.path.insert(0, root)
    try:
        from splink_tpu_torch import gammas
        from splink_tpu_torch.ops import strings_cuda
    finally:
        sys.path.remove(root)
    if not gammas.__file__.startswith(root + os.sep):
        raise RuntimeError(f"splink_tpu_torch came from {gammas.__file__}, not {root}")
    return gammas, strings_cuda


def main(trees: list[str]) -> int:
    import torch

    if not torch.cuda.is_available() or not trees:
        print("chip_ab: needs a CUDA device and at least one tree", file=sys.stderr)
        return 2
    sys.path.insert(0, HERE)
    import chip_smoke as cs

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip(), flush=True)

    # the main path's pairs, from the first tree (encode and blocking are
    # the same code in every tree)
    load_tree(trees[0])
    import splink_tpu_torch

    df, _ = cs.make_people(cs.N_ROWS, cs.SEED)
    linker = splink_tpu_torch.Splink(json.loads(json.dumps(cs.SETTINGS)), df=df)
    linker._ensure_pairs()
    col = next(c for c in cs.SETTINGS["comparison_columns"]
               if c["comparison"]["kind"] == "jaro_winkler")
    thresholds = tuple(col["comparison"]["thresholds"])

    first = {}
    for tree in trees:
        gammas, strings_cuda = load_tree(tree)
        strings_cuda.build()
        gen = torch.Generator(device="cuda").manual_seed(cs.SEED)
        args = cs.random_pairs(torch, cs.KERNEL_CHECK_PAIRS, 24, False, gen)
        jw = strings_cuda.jaro_winkler_cuda(*args)
        pc, aux = cs.first_batch(torch, gammas, linker, col["col_name"])
        step_ms, lvl = cs.two_phase_step_ms(torch, gammas, pc, aux, thresholds)
        if not first:
            first.update(jw=jw, lvl=lvl)
        elif not (torch.equal(jw, first["jw"]) and torch.equal(lvl, first["lvl"])):
            raise AssertionError(f"{tree}: Jaro-Winkler output or levels differ from {trees[0]}")
        mod = sys.modules["splink_tpu_torch"]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        trained = mod.Splink(json.loads(json.dumps(cs.SETTINGS)), df=df)
        trained.estimate_parameters()
        torch.cuda.synchronize()
        train_s = time.perf_counter() - t0
        lam = trained.params.params["λ"]
        if "lam" not in first:
            first["lam"] = lam
        elif lam != first["lam"]:
            raise AssertionError(f"{tree}: fitted lambda {lam} differs from {first['lam']}")
        print(json.dumps({
            "tree": tree,
            "train": {"wall_s": train_s, "stage_s": trained.stage_seconds, "lambda": lam},
            "jw_dense_2M_w24": {
                "ms": cs.cuda_ms(torch, lambda: strings_cuda.jaro_winkler_cuda(*args)),
                "call_ms": cs.cuda_ms(torch, lambda: strings_cuda.jaro_winkler_cuda(*args),
                                      device_only=False)},
            "two_phase_step": {"column": col["col_name"], "pairs": int(pc.len_l.shape[0]),
                               "host_ms_to_synchronize": step_ms},
            "kernel_launches": dict(strings_cuda.variant_launches),
        }), flush=True)
        del pc, aux, args, jw, trained
    print(json.dumps({"ok": True, "device": torch.cuda.get_device_name(0),
                      "trees": trees}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
