"""Run one cell of the benchmark once, on the card this process starts on.

    python3 -m linkbench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Set-up builds the cell's input from the seed and runs one whole job; the
window then runs whole training jobs back to back until ``--seconds`` have
passed (the job in flight at the close runs to its end and counts). The
comparison with the plain reference follows the window. The last line of
standard output is the result (JSON); the last lines of standard error
are the numbers compared, each beside its limit.

Exits non-zero without a result when there is no CUDA card (or fewer than
the cell asks for), when the system under test cannot be imported, or
when JAX or the JAX package was loaded.
"""

from __future__ import annotations

import os
import time


def _process_start() -> float:
    """The host clock (``time.perf_counter``) at this process's start."""
    now = time.perf_counter()
    try:
        with open("/proc/self/stat") as fh:
            start_ticks = int(fh.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as fh:
            uptime = float(fh.read().split()[0])
        return now - max(0.0, uptime - start_ticks / os.sysconf("SC_CLK_TCK"))
    except (OSError, ValueError, IndexError):
        return now


T_START = _process_start()

import argparse  # noqa: E402
import json  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402


def _card_line() -> str | None:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=30)
        return out.stdout.strip() or None
    except (OSError, subprocess.SubprocessError):
        return None


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    from linkbench import harness

    cell = harness.load_cell(args.workload)
    import torch

    chips = int(cell.entry["chips"])
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"no CUDA card, or fewer than the {chips} the cell asks for", file=sys.stderr)
        return 3
    try:
        import splink_tpu_torch  # noqa: F401
    except ImportError as e:
        print(f"the system under test is not importable: {e}", file=sys.stderr)
        return 4
    result = harness.run_cell(args.workload, args.seed, args.seconds, bool(args.trace),
                              T_START)
    from splink_tpu_torch.analysis.perf_audit import host_probe_ms

    print(json.dumps({"host_probe_ms": host_probe_ms("cuda"), "card": _card_line()}),
          flush=True)
    bad = harness.forbidden_modules()
    if bad:
        print(f"modules of JAX or the JAX package were loaded: {bad}", file=sys.stderr)
        return 5
    print(json.dumps(result), flush=True)
    for key, c in result["checks"].items():
        print(f"check {key}: {c['value']} (limit {c['limit']})", file=sys.stderr)
    print(f"correct: {result['correct']} (jobs {result['attempted']}, failed "
          f"{result['failed']})", file=sys.stderr, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
