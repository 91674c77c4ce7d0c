"""The analysis layers of splink_tpu_torch, and the lock factory.

The port of splink_tpu/analysis, one finding model:

  * :mod:`.torchlint` and :mod:`.rules` — the AST lint pass (the
    reference's jaxlint) with its PyTorch rules: host calls and syncs in
    device code, unpinned dtypes, float64 leaks, import-time device work,
    and the multi-process hazards.
  * :mod:`.trace_audit` — the kernel registry (the reference's 29 names,
    fixed-seed example inputs) and the op-level audit: each kernel runs
    twice under a dispatch recorder, held to the dtype allowlist, the
    host-sync allowlist, the host-data budget and a deterministic op
    sequence.
  * :mod:`.shard_audit` — the sharded kernels (the reference's 19 names)
    on an 8-shard audit mesh: shard placement, the collective budget, the
    padding weights and the per-shard costs against
    ``shard_baselines.json``.
  * :mod:`.perf_audit` — compile (first call) and execute wall plus memory
    for each (tier, kernel, shape), gated one-sided against
    ``perf_baselines.json``.
  * :mod:`.num_audit` — NaN/Inf corners, the float32-against-float64 ulp
    budget per kernel and tier (``num_baselines.json``), monotonicity and
    the pinned fold order.
  * :mod:`.numlint` — the static half of numerics: raw logs on
    possibly-zero operands, unshifted exps, unguarded divisions,
    linear-space probability products, float equality in device code,
    fold-order-breaking reductions, unclamped logit round trips and
    out-of-f32-range literals, with ``# numlint: disable=RULE``.
  * :mod:`.threadlint` — the concurrency audit of the registered serve and
    obs classes (mixed-guard access, blocking calls and callback escapes
    under locks, lock-order cycles, thread lifecycle), with
    ``# threadlint: disable=RULE``; its dynamic half is :mod:`.lockwatch`,
    the lock factory of the serve and obs modules, whose watched locks
    (``SPLINK_TPU_LOCKWATCH=1``) record the observed acquisition order.

Each measured audit runs on ``cuda`` unless a device is named
(``device="cpu"``), and keys its baselines by tier (``cpu``, ``cuda``).

CLI: ``python -m splink_tpu_torch.analysis [paths...] --audit --shard-audit
--num-audit --thread-audit [--perf-audit] [--device cpu] [--json]``.
"""

from .findings import Finding, Report
from .num_audit import num_plan, run_num_audit
from .numlint import NL_RULES, numlint_paths, numlint_source
from .perf_audit import current_tier, perf_plan, run_perf_audit
from .rules import RULES, rule
from .shard_audit import (
    SHARD_REGISTRY,
    ShardKernelSpec,
    audit_shard_kernel,
    register_shard_kernel,
    run_shard_audit,
    update_baselines,
)
from .threadlint import (
    THREAD_REGISTRY,
    TL_RULES,
    audit_source,
    build_lock_graph,
    graph_cycles,
    run_thread_audit,
)
from .torchlint import ModuleLint, lint_paths, lint_source
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
    "RULES",
    "rule",
    "ModuleLint",
    "lint_source",
    "lint_paths",
    "SHARD_REGISTRY",
    "ShardKernelSpec",
    "register_shard_kernel",
    "audit_shard_kernel",
    "run_shard_audit",
    "THREAD_REGISTRY",
    "TL_RULES",
    "audit_source",
    "build_lock_graph",
    "graph_cycles",
    "run_thread_audit",
    "NL_RULES",
    "numlint_source",
    "numlint_paths",
]
