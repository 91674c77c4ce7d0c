"""perf_audit: measured per-kernel runtime/memory baselines.

The port of splink_tpu/analysis/perf_audit.py. Every kernel in the
registry (trace_audit.py) runs on its fixed-seed example inputs at one to
three shapes, and its measured metrics are compared against committed
per-``(tier, kernel, shape)`` baselines (``perf_baselines.json`` beside
this module):

  PA-TIME   ``compile_ms``, the first call's wall in the process for this
            (kernel, shape) — there is no compiler, but the first call
            pays what the reference's compile did once: the allocator's
            first touch and, on the card, loading the kernel library (the
            ``nvcc`` build is not in it: the audit builds the libraries
            before it measures, and they are cached under ``build/``); and
            ``execute_ms``, the best of N calls (on the card timed with
            CUDA events after a synchronise). One-sided bands: only slower
            fires; ``execute_ms`` must still exceed its band on the median
            of K re-measurements. ``compile_ms`` cannot be measured twice
            in one process, so its band is gated on its one reading, past
            a generous floor.
  PA-MEM    ``argument_bytes`` and ``output_bytes``, the bytes of the
            call's array arguments and outputs (deterministic, tight band),
            and on the card ``temp_bytes`` (the peak allocation above the
            arguments that the outputs do not keep) and
            ``peak_device_bytes`` (the ``max_memory_allocated`` delta over
            the call), both null on the CPU, as the reference records
            them; gated only when both sides recorded them.
  PA-BASE   the kernel/shape has no committed baseline for this tier.
  PA-ERROR  the kernel failed to run at a perf shape.

Baselines are keyed by tier, ``cpu`` or ``cuda`` (:func:`current_tier`,
from the device the audit runs on): CPU numbers predict nothing about the
card, and the audit only gates against the tier it runs on. Each tier's
block names its device (on the card, ``nvidia-smi``'s name and power
limit).

Shapes: every kernel runs at its registered shape (``reg``); kernels in
:data:`PERF_SCALES` also at tiled batch sizes (``x4``...), the batch-axis
arrays tiled and tables and parameters untouched. The registered shapes
are tiny, so on the card they measure launch latency: the ``cuda`` tier
adds, per kernel in :data:`CUDA_SCALES`, one scale that reaches the main
path's batch.

Refreshing a tier's baselines (new kernel, accepted perf change)::

    python -m splink_tpu_torch.analysis --update-perf-baselines --device cpu
"""

from __future__ import annotations

import json
import os
import statistics
import time
from dataclasses import dataclass

from .findings import Finding

BASELINES_PATH = os.path.join(os.path.dirname(__file__), "perf_baselines.json")
REFRESH = "python -m splink_tpu_torch.analysis --update-perf-baselines --device <tier>"

#: best-of-N execute repeats per measurement (min = the least-noise sample)
DEFAULT_BEST_OF = 5

#: noise-floor guard: an execute time over its band is re-measured this
#: many times and must regress on the MEDIAN before PA-TIME fires
DEFAULT_REMEASURE = 5

#: one-sided tolerance bands (relative) + absolute floors (the reference's)
EXECUTE_RTOL = 1.0  # fire past 2x the committed execute wall
EXECUTE_ATOL_MS = 1.0
COMPILE_RTOL = 1.0
COMPILE_ATOL_MS = 500.0
MEM_RTOL = 0.25  # deterministic bytes
DEVICE_MEM_RTOL = 0.5  # measured peak device delta (runtime, loose)

MEM_KEYS = ("argument_bytes", "output_bytes", "temp_bytes")

#: kernels measured at scaled batch shapes beyond the registered one (the
#: reference's table): name -> (base batch length of the registered
#: example inputs, scale factors). Only arrays whose LEADING axis equals
#: the base length tile.
PERF_SCALES: dict[str, tuple[int, tuple[int, ...]]] = {
    "em_step": (128, (8, 32)),
    "streamed_pass": (128, (8, 32)),
    "score_pairs": (128, (8, 32)),
    "gamma_batch": (256, (4, 16)),
    "pattern_kernel": (256, (4, 16)),
    "jaro_winkler": (64, (4, 16)),
    "levenshtein": (64, (4,)),
    "tf_adjustment": (512, (4,)),
    "tf_gather": (512, (4,)),
    "serve_score_topk": (16, (4,)),
    "serve_score_fused": (16, (4, 16)),
    "approx_minhash": (16, (4,)),
    "approx_verify": (32, (4,)),
    "quality_profile": (128, (8,)),
    "serve_drift_sketch": (16, (4,)),
}

#: the ``cuda`` tier's one extra scale per kernel, reaching the main
#: path's batch: 1,048,576 EM rows and scored pairs (x8192 of 128), the
#: gamma program's 1,048,576-pair batch (x4096 of 256), 1,048,576 string
#: pairs (x16384 of 64), and the served batch of 1,024 queries (x64 of 16)
CUDA_SCALES: dict[str, int] = {
    "em_step": 8192,
    "streamed_pass": 8192,
    "score_pairs": 8192,
    "gamma_batch": 4096,
    "pattern_kernel": 4096,
    "jaro_winkler": 16384,
    "levenshtein": 16384,
    "quality_profile": 8192,
    "serve_score_topk": 64,
    "serve_score_fused": 64,
    "serve_drift_sketch": 64,
}

#: registry kernels excluded from the perf tier, with the reason rendered
#: by ``--list-perf-kernels`` (the reference's exclusions)
PERF_EXCLUDED: dict[str, str] = {
    "em_step_checkpointed": "em_step's loop plus a per-update host hook; "
    "em_step measures the same loop",
    "em_step_telemetry": "em_step's loop plus a per-update host hook; "
    "em_step measures the same loop",
}


@dataclass
class PerfShape:
    """One measured (kernel, shape) cell."""

    kernel: str
    label: str  # "reg" or "x<factor>"
    factor: int  # 1 for the registered shape


def _factors(name: str, tier: str) -> list[int]:
    factors = list(PERF_SCALES.get(name, (0, ()))[1])
    if tier == "cuda" and name in CUDA_SCALES:
        factors.append(CUDA_SCALES[name])
    return factors


def perf_plan(names=None, tier: str = "cpu") -> list[PerfShape]:
    """The measurement plan over the registry for ``tier``: every
    non-excluded kernel at its registered shape, plus its scales. Builds
    no inputs and touches no device."""
    from .trace_audit import REGISTRY, _ensure_default_registry

    _ensure_default_registry()
    if names:
        unknown = [n for n in names if n not in REGISTRY]
        if unknown:
            raise KeyError(f"unknown kernel(s): {', '.join(unknown)}")
        kernels = list(names)
    else:
        kernels = [n for n in sorted(REGISTRY) if n not in PERF_EXCLUDED]
    plan: list[PerfShape] = []
    for name in kernels:
        plan.append(PerfShape(name, "reg", 1))
        for f in _factors(name, tier):
            plan.append(PerfShape(name, f"x{f}", f))
    return plan


def format_plan(plan: list[PerfShape]) -> str:
    """The ``--list-perf-kernels`` listing: kernels, shapes, exclusions."""
    by_kernel: dict[str, list[str]] = {}
    for cell in plan:
        by_kernel.setdefault(cell.kernel, []).append(cell.label)
    lines = [
        f"{len(by_kernel)} kernel(s), {len(plan)} measured shape(s) "
        f"[tier-keyed baselines: {os.path.basename(BASELINES_PATH)}]"
    ]
    for name, labels in by_kernel.items():
        extra = f"  (cuda adds x{CUDA_SCALES[name]})" if name in CUDA_SCALES else ""
        lines.append(f"  {name:<28}{' '.join(labels)}{extra}")
    for name, reason in sorted(PERF_EXCLUDED.items()):
        lines.append(f"  {name:<28}(excluded: {reason})")
    return "\n".join(lines)


# ---------------------------------------------------------------------------
# Input scaling
# ---------------------------------------------------------------------------


def _tile_leaf(leaf, factor: int, base_n: int):
    import numpy as np
    import torch

    if not isinstance(leaf, (torch.Tensor, np.ndarray)) or not leaf.ndim:
        return leaf
    if leaf.shape[0] != base_n:
        return leaf
    reps = (factor,) + (1,) * (leaf.ndim - 1)
    if isinstance(leaf, torch.Tensor):
        return leaf.repeat(*reps)
    return np.tile(leaf, reps)


def _scaled_args(name: str, args, kwargs, factor: int):
    """Tile the batch-axis arrays of one kernel's example inputs."""
    from .trace_audit import map_leaves

    if factor == 1:
        return args, kwargs
    base_n = PERF_SCALES[name][0]
    return map_leaves((args, kwargs), lambda leaf: _tile_leaf(leaf, factor, base_n))


# ---------------------------------------------------------------------------
# Measurement
# ---------------------------------------------------------------------------


def current_tier(device=None) -> str:
    """The baseline tier key: ``cuda`` or ``cpu``, the type of the device
    the audit runs on (``cuda`` unless named)."""
    from .trace_audit import _resolve

    return _resolve(device).type


def _array_bytes(tree) -> float:
    import numpy as np
    import torch

    from .trace_audit import leaves

    total = 0
    for leaf in leaves(tree):
        if isinstance(leaf, torch.Tensor):
            total += leaf.numel() * leaf.element_size()
        elif isinstance(leaf, np.ndarray):
            total += leaf.nbytes
    return float(total)


def _cell(cell: PerfShape, dev):
    """(fn, args, kwargs) of one plan cell, memoised on the spec."""
    from .trace_audit import REGISTRY

    spec = REGISTRY[cell.kernel]
    key = ("perf_args", cell.factor, str(dev))
    if key not in spec.cache:
        fn, args, kwargs = spec.built(dev)
        args, kwargs = _scaled_args(cell.kernel, args, kwargs, cell.factor)
        spec.cache[key] = (fn, args, kwargs)
    return spec, spec.cache[key]


class _Clock:
    """Wall of one call: CUDA events around it on the card (after a
    synchronise), the host clock on the CPU."""

    def __init__(self, dev):
        import torch

        self.cuda = dev.type == "cuda"
        self.torch = torch

    def ms(self, fn, args, kwargs) -> tuple[float, object]:
        torch = self.torch
        if not self.cuda:
            t0 = time.perf_counter()
            out = fn(*args, **kwargs)
            return (time.perf_counter() - t0) * 1e3, out
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        out = fn(*args, **kwargs)
        end.record()
        end.synchronize()
        return float(start.elapsed_time(end)), out


def _execute_best_of(clock, fn, args, kwargs, best_of: int) -> float:
    """Best-of-N execute wall (ms); one unmeasured warm-up call first."""
    clock.ms(fn, args, kwargs)
    return min(clock.ms(fn, args, kwargs)[0] for _ in range(max(best_of, 1)))


def _prepare(dev) -> None:
    """Build the hand-kernel libraries before anything is timed (a no-op
    once they are on disk)."""
    if dev.type == "cuda":
        from ..ops import strings_cuda

        strings_cuda.build()


def measure_cell(cell: PerfShape, best_of: int = DEFAULT_BEST_OF, device=None) -> dict:
    """The committed-baseline record for one (kernel, shape)."""
    from .trace_audit import _resolve

    dev = _resolve(device)
    _prepare(dev)
    spec, (fn, args, kwargs) = _cell(cell, dev)
    clock = _Clock(dev)
    torch = clock.torch
    first_key = ("first_call_ms", cell.factor, str(dev))
    mem0 = None
    if clock.cuda:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        mem0 = torch.cuda.memory_allocated(dev)
    ms, out = clock.ms(fn, args, kwargs)
    peak = kept = None
    if clock.cuda:
        peak = torch.cuda.max_memory_allocated(dev) - mem0
        kept = torch.cuda.memory_allocated(dev) - mem0
    spec.cache.setdefault(first_key, ms)
    record: dict = {
        "compile_ms": round(spec.cache[first_key], 4),
        "argument_bytes": _array_bytes((args, kwargs)),
        "output_bytes": _array_bytes(out),
        "temp_bytes": None if peak is None else float(max(peak - kept, 0)),
        "peak_device_bytes": None if peak is None else int(max(peak, 0)),
    }
    del out
    record["execute_ms"] = round(_execute_best_of(clock, fn, args, kwargs, best_of), 4)
    return record


def _remeasure_execute(cell: PerfShape, k: int, best_of: int, dev) -> float:
    """Median of K fresh best-of-N execute measurements (the PA-TIME noise
    guard)."""
    _, (fn, args, kwargs) = _cell(cell, dev)
    clock = _Clock(dev)
    return statistics.median(
        _execute_best_of(clock, fn, args, kwargs, best_of) for _ in range(max(k, 1))
    )


# ---------------------------------------------------------------------------
# Audit
# ---------------------------------------------------------------------------


def _over_band(want: float, got: float, rtol: float, atol: float) -> bool:
    """One-sided: fires only when the measurement regressed past BOTH the
    relative band and the absolute floor."""
    return got > want * (1.0 + rtol) and got - want > atol


def _drift_msg(metric: str, want: float, got: float, rtol: float) -> str:
    rel = (got - want) / max(abs(want), 1e-12)
    return (
        f"{metric}: baseline {want:.3f}, measured {got:.3f} "
        f"(+{rel * 100:.0f}% > +{rtol * 100:.0f}% tolerance)"
    )


def audit_cell(
    cell: PerfShape,
    baseline: dict | None,
    *,
    best_of: int = DEFAULT_BEST_OF,
    remeasure: int = DEFAULT_REMEASURE,
    device=None,
    measured: dict | None = None,
) -> list[Finding]:
    """Measure one (kernel, shape) (unless ``measured`` is given) and
    compare against its committed baseline with the PA-* bands."""
    from .trace_audit import _resolve

    findings: list[Finding] = []
    where = f"{cell.kernel}@{cell.label}"

    def fail(check: str, message: str, hint: str = "") -> None:
        findings.append(
            Finding(rule=check, path=where, line=0, message=message, hint=hint)
        )

    dev = _resolve(device)
    if measured is None:
        try:
            measured = measure_cell(cell, best_of=best_of, device=dev)
        except Exception as e:  # noqa: BLE001 - any perf-shape failure is a finding
            fail(
                "PA-ERROR",
                f"kernel failed to run at the perf shape: {type(e).__name__}: {e}",
            )
            return findings
    if baseline is None:
        fail(
            "PA-BASE",
            "no committed perf baseline for this (tier, kernel, shape)",
            f"generate one with `{REFRESH}` and commit perf_baselines.json",
        )
        return findings

    refresh = f"if the change is intended, refresh with `{REFRESH}`"
    for metric, rtol, atol, remeasure_fn in (
        ("execute_ms", EXECUTE_RTOL, EXECUTE_ATOL_MS,
         lambda: _remeasure_execute(cell, remeasure, best_of, dev)),
        ("compile_ms", COMPILE_RTOL, COMPILE_ATOL_MS, None),
    ):
        want = baseline.get(metric)
        got = measured.get(metric)
        if want is None or got is None:
            continue
        if _over_band(float(want), float(got), rtol, atol):
            if remeasure_fn is None:
                fail("PA-TIME", _drift_msg(metric, float(want), float(got), rtol),
                     "a measured first-call regression on this kernel; " + refresh)
                continue
            median = remeasure_fn()
            if _over_band(float(want), float(median), rtol, atol):
                fail(
                    "PA-TIME",
                    _drift_msg(metric, float(want), float(median), rtol)
                    + f" [median of {remeasure} re-runs; first "
                    f"measurement {float(got):.3f}]",
                    "a measured runtime regression on this kernel; " + refresh,
                )
    for metric in MEM_KEYS:
        want = baseline.get(metric)
        got = measured.get(metric)
        if want is None or got is None:
            continue
        if _over_band(float(want), float(got), MEM_RTOL, 0.0):
            fail(
                "PA-MEM",
                _drift_msg(metric, float(want), float(got), MEM_RTOL),
                "the call's memory footprint grew; " + refresh,
            )
    want = baseline.get("peak_device_bytes")
    got = measured.get("peak_device_bytes")
    if want is not None and got is not None and float(want) > 0:
        if _over_band(float(want), float(got), DEVICE_MEM_RTOL, 0.0):
            fail(
                "PA-MEM",
                _drift_msg("peak_device_bytes", float(want), float(got), DEVICE_MEM_RTOL),
                "the measured device high-water mark grew; " + refresh,
            )
    return findings


# ---------------------------------------------------------------------------
# The audit over the plan, and the baseline files
# ---------------------------------------------------------------------------


def load_baselines(path: str | None = None) -> dict:
    path = path or BASELINES_PATH
    if not os.path.exists(path):
        return {}
    with open(path, encoding="utf-8") as fh:
        return json.load(fh)


def run_perf_audit(
    names=None,
    baselines: dict | None = None,
    *,
    best_of: int = DEFAULT_BEST_OF,
    remeasure: int = DEFAULT_REMEASURE,
    device=None,
    measured_out: dict | None = None,
) -> tuple[list[Finding], int]:
    """Audit the given kernels (default: the full plan) on ``device``
    against the committed baselines for its tier. Returns (findings,
    number of measured shapes); ``measured_out``, when given, receives
    each cell's record under ``"<kernel>@<label>"``."""
    tier = current_tier(device)
    plan = perf_plan(names, tier)
    if baselines is None:
        baselines = load_baselines()
    per_kernel = baselines.get("tiers", {}).get(tier, {}).get("kernels", {})
    findings: list[Finding] = []
    for cell in plan:
        base = per_kernel.get(cell.kernel, {}).get(cell.label)
        measured = None
        try:
            measured = measure_cell(cell, best_of=best_of, device=device)
        except Exception as e:  # noqa: BLE001 - surfaced as PA-ERROR
            findings.append(Finding(
                rule="PA-ERROR", path=f"{cell.kernel}@{cell.label}", line=0,
                message=f"kernel failed to run at the perf shape: {type(e).__name__}: {e}",
            ))
            continue
        if measured_out is not None:
            measured_out[f"{cell.kernel}@{cell.label}"] = measured
        findings.extend(audit_cell(cell, base, best_of=best_of, remeasure=remeasure,
                                   device=device, measured=measured))
    return findings, len(plan)


def device_meta(device=None) -> dict:
    """What a tier's block says about the device it was measured on: the
    card's name and ``nvidia-smi``'s name and power limit, or the CPU."""
    import platform
    import subprocess

    import torch

    from .trace_audit import _resolve

    dev = _resolve(device)
    meta = {"torch": torch.__version__}
    if dev.type == "cuda":
        meta["device"] = torch.cuda.get_device_name(dev)
        meta["nvidia_smi"] = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, check=True,
        ).stdout.strip().splitlines()[0]
    else:
        meta["device"] = f"cpu ({platform.machine()}, {os.cpu_count()} cores)"
    return meta


def update_baselines(
    names=None,
    path: str | None = None,
    *,
    best_of: int = DEFAULT_BEST_OF,
    device=None,
) -> dict:
    """Re-measure the perf plan and write the baseline file's block for
    the tier of ``device`` (other tiers' blocks are preserved). A full
    refresh (no names) rebuilds this tier's block from the plan alone; a
    named refresh merges. Returns the new baselines dict."""
    tier = current_tier(device)
    plan = perf_plan(names, tier)
    path = path or BASELINES_PATH
    existing = load_baselines(path)
    tiers = dict(existing.get("tiers", {}))
    kernels: dict[str, dict] = (
        {k: dict(v) for k, v in tiers.get(tier, {}).get("kernels", {}).items()}
        if names
        else {}
    )
    for cell in plan:
        kernels.setdefault(cell.kernel, {})[cell.label] = measure_cell(
            cell, best_of=best_of, device=device
        )
    tiers[tier] = {
        "_meta": device_meta(device),
        "kernels": {
            k: {s: kernels[k][s] for s in sorted(kernels[k])}
            for k in sorted(kernels)
        },
    }
    new = {
        "_meta": {
            "best_of": best_of,
            "refresh": REFRESH,
            "bands": {
                "execute_ms": f"+{EXECUTE_RTOL * 100:.0f}% "
                f"(floor {EXECUTE_ATOL_MS}ms, median-of-{DEFAULT_REMEASURE} guard)",
                "compile_ms": f"+{COMPILE_RTOL * 100:.0f}% (floor {COMPILE_ATOL_MS}ms)",
                "memory_bytes": f"+{MEM_RTOL * 100:.0f}%",
            },
        },
        "tiers": {t: tiers[t] for t in sorted(tiers)},
    }
    with open(path, "w", encoding="utf-8") as fh:
        json.dump(new, fh, indent=2, sort_keys=True)
        fh.write("\n")
    return new
