"""The measured analysis layers of splink_tpu_torch, and the lock factory.

The port of splink_tpu/analysis's measured half, one finding model:

  * :mod:`.trace_audit` — the kernel registry (the reference's 29 names,
    fixed-seed example inputs) and the op-level audit: each kernel runs
    twice under a dispatch recorder, held to the dtype allowlist, the
    host-sync allowlist, the host-data budget and a deterministic op
    sequence.
  * :mod:`.perf_audit` — compile (first call) and execute wall plus memory
    for each (tier, kernel, shape), gated one-sided against
    ``perf_baselines.json``.
  * :mod:`.num_audit` — NaN/Inf corners, the float32-against-float64 ulp
    budget per kernel and tier (``num_baselines.json``), monotonicity and
    the pinned fold order.

Each runs on ``cuda`` unless a device is named (``device="cpu"``), and keys
its baselines by tier (``cpu``, ``cuda``). :mod:`.lockwatch` is the lock
factory of the serve and obs modules. The static layers (the lint engine
and its rules, numlint, threadlint with the full lockwatch) and the shard
audit are not ported yet.

CLI: ``python -m splink_tpu_torch.analysis --audit --num-audit
[--perf-audit] [--device cpu] [--json]``.
"""

from .findings import Finding, Report
from .num_audit import num_plan, run_num_audit
from .perf_audit import current_tier, perf_plan, run_perf_audit, update_baselines
from .trace_audit import REGISTRY, KernelSpec, audit_kernel, register_kernel, run_audit

__all__ = [
    "Finding",
    "Report",
    "KernelSpec",
    "REGISTRY",
    "register_kernel",
    "audit_kernel",
    "run_audit",
    "perf_plan",
    "run_perf_audit",
    "update_baselines",
    "current_tier",
    "num_plan",
    "run_num_audit",
]
