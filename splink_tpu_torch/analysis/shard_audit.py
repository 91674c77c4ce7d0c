"""shard_audit: the partition audit of the sharded kernels.

The port of splink_tpu/analysis/shard_audit.py. The reference lowers every
registered kernel under a forced 8-device host mesh and reads the compiled
SPMD program. PyTorch has no HLO and no GSPMD: the port's sharded code is
explicit per-shard work over :class:`~..parallel.mesh.Sharded` values with
one shard-order sum, :func:`~..parallel.mesh.reduce_shards`, for the
reference's ``psum``. So each kernel RUNS on the audit mesh under a
dispatch recorder that tags every input piece with its shard index (each
op's outputs inherit the union of its inputs' tags), and the run is held
to the reference's invariants:

  SA-SPEC   every input and output leaf whose leading axis is the pair axis
            is a ``Sharded`` split into the mesh's pieces, piece k on shard
            k's device; every other tensor is replicated. A pair-axis tensor
            handed in whole (the reference's widened PartitionSpec) is a
            finding: every shard would read, and process, the full batch.
            A kernel that names no mesh in either package runs each shard
            alone, and the concatenation of its per-shard outputs (the
            shard-order sum, for a histogram) must equal the unsharded
            call: integer and boolean outputs bit for bit, floating-point
            ones within :data:`FLOAT_ULP` float32 ulp.
  SA-COLL   an exact per-kernel collective budget, of two kinds:
            ``reduce`` counts :func:`~..parallel.mesh.reduce_shards` calls
            (its counter ``mesh.reductions``); ``gather`` counts dispatched
            ops, outside a reduction, whose tensor inputs come from more
            than one shard. A gather is always a finding (the reference's
            forbidden ``all-gather`` / ``all-to-all``); reductions must be
            declared and match the committed budget exactly, so a deleted
            or duplicated one fails as budget drift.
  SA-PAD    kernels that consume ``shard_pairs`` padding weights are built
            from ``n_pairs - 3`` real rows, so the last shard holds padding;
            the padding rows of every pair-axis input are then set to real
            rows' values, their weights left at 0, and every output must
            stay bit-equal (the reference proves the same through jaxpr
            dataflow: padded rows cannot reach an output).
  SA-COST   per shard, the argument, output and temporary bytes (summed
            from the recorded ops' output tensors), the count of dispatched
            ops and, on ``cuda``, the peak of ``max_memory_allocated`` over
            the call, held against ``shard_baselines.json`` within
            :data:`DEFAULT_COST_RTOL`, one block per tier (``cpu``,
            ``cuda``) as the perf and num audits keep theirs.
  SA-ERROR  a build function or call that raises.

The audit mesh (:func:`audit_mesh`) is ``size`` shards on the one resolved
device: on the CPU the reference test tier's 8 forced host devices, on a
card 8 shards on that card. The audit checks the partition logic, not the
interconnect, so the reference's SA-ENV ("the mesh needs 8 devices") has
no case here.

Refreshing a tier's baselines (new kernel, accepted cost change)::

    python -m splink_tpu_torch.analysis --shard-audit --update-baselines --device <tier>

Registering a kernel::

    @register_shard_kernel("my_kernel_sharded", n_pairs=1024,
                           allow_collectives=("reduce",), pad_weights_argnum=2)
    def _build(device):
        mesh = audit_mesh(device=device)
        ...pair-axis inputs through shard_pairs / pair_sharding, the rest plain...
        return fn, args, {}

A build function may return a fourth element, ``(whole_fn, whole_args)``: the
unsharded call the concatenated per-shard outputs must equal.
"""

from __future__ import annotations

import json
import os
import weakref
from dataclasses import dataclass, field
from typing import Callable

from .findings import Finding
from .perf_audit import current_tier, device_meta

DEFAULT_MESH_SIZE = 8
DEFAULT_COST_RTOL = 0.25
# the bound on a floating-point output of a per-shard kernel against its
# unsharded call, in float32 ulp (integer and boolean outputs are exact)
FLOAT_ULP = 4

BASELINES_PATH = os.path.join(os.path.dirname(__file__), "shard_baselines.json")
REFRESH = ("python -m splink_tpu_torch.analysis --shard-audit --update-baselines "
           "--device <tier>")

COLLECTIVE_KINDS = ("reduce", "gather")

_COST_KEYS = (
    "ops",
    "argument_size_in_bytes",
    "output_size_in_bytes",
    "temp_size_in_bytes",
    "peak_bytes",
)


@dataclass
class ShardKernelSpec:
    name: str
    build: Callable  # (device) -> (fn, args, kwargs[, (whole_fn, whole_args)])
    n_pairs: int  # pair-axis length of the example inputs (SA-SPEC key)
    allow_collectives: tuple = ()
    pad_weights_argnum: int | None = None  # positional arg carrying weights
    cost_rtol: float = DEFAULT_COST_RTOL
    mesh_size: int = DEFAULT_MESH_SIZE
    origin: str = ""  # file of the registering build function
    # per-device memo of the build and of the measured call: audits are
    # idempotent reads, so repeating one must not re-pay the build
    cache: dict = field(default_factory=dict)

    @property
    def location(self) -> str:
        """``file:kernel`` anchor findings render with."""
        return f"{self.origin}:{self.name}" if self.origin else self.name


SHARD_REGISTRY: dict[str, ShardKernelSpec] = {}


def register_shard_kernel(
    name: str,
    *,
    n_pairs: int,
    allow_collectives=(),
    pad_weights_argnum: int | None = None,
    cost_rtol: float = DEFAULT_COST_RTOL,
    mesh_size: int = DEFAULT_MESH_SIZE,
    registry: dict | None = None,
):
    """Declare one sharded kernel for auditing; the decorated build function takes
    the device, runs lazily and returns ``(fn, example_args,
    example_kwargs)`` with the pair-axis arguments sharded on the audit
    mesh. ``registry`` overrides the global one (fixture corpora register
    into their own dict)."""
    reg = SHARD_REGISTRY if registry is None else registry
    unknown = [k for k in allow_collectives if k not in COLLECTIVE_KINDS]
    if unknown or "gather" in allow_collectives:
        raise ValueError(
            f"shard kernel {name!r}: only 'reduce' may be declared "
            f"(got {list(allow_collectives)}); a gather is always a finding")

    def deco(build: Callable) -> Callable:
        if name in reg:
            raise ValueError(f"duplicate shard kernel name {name!r}")
        code = getattr(build, "__code__", None)
        origin = ""
        if code is not None:
            path = code.co_filename
            root = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
            for base in (os.getcwd(), root):
                rel = os.path.relpath(path, base)
                if not rel.startswith(".."):
                    path = rel
                    break
            origin = path
        reg[name] = ShardKernelSpec(
            name=name,
            build=build,
            n_pairs=n_pairs,
            allow_collectives=tuple(allow_collectives),
            pad_weights_argnum=pad_weights_argnum,
            cost_rtol=cost_rtol,
            mesh_size=mesh_size,
            origin=origin,
        )
        return build

    return deco


def _resolve(device):
    import torch

    from .._device import resolve_device

    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def audit_mesh(size: int = DEFAULT_MESH_SIZE, device=None):
    """The mesh the shard build functions place their example arguments on: ``size``
    shards on the one resolved device (``cuda`` unless named)."""
    from ..parallel.mesh import Mesh

    return Mesh((_resolve(device),) * size)


# ---------------------------------------------------------------------------
# Trees of Sharded values
# ---------------------------------------------------------------------------


def _spec_leaves(tree) -> list:
    """Tensor, numpy and ``Sharded`` leaves of a nested structure (a
    ``Sharded`` is one leaf), in order; dicts by sorted key."""
    import numpy as np
    import torch

    from ..parallel.mesh import Sharded

    if isinstance(tree, (Sharded, torch.Tensor, np.ndarray)):
        return [tree]
    if isinstance(tree, dict):
        return [v for k in sorted(tree) for v in _spec_leaves(tree[k])]
    if isinstance(tree, (tuple, list)):
        return [v for e in tree for v in _spec_leaves(e)]
    return []


def _map_sharded(tree, fn):
    """``tree`` with each ``Sharded`` leaf mapped through ``fn``."""
    from ..parallel.mesh import Sharded

    if isinstance(tree, Sharded):
        return fn(tree)
    if isinstance(tree, tuple):
        mapped = [_map_sharded(e, fn) for e in tree]
        return type(tree)(*mapped) if hasattr(tree, "_fields") else tuple(mapped)
    if isinstance(tree, list):
        return [_map_sharded(e, fn) for e in tree]
    if isinstance(tree, dict):
        return {k: _map_sharded(v, fn) for k, v in tree.items()}
    return tree


def _host(leaf):
    """One output leaf as a numpy array (a ``Sharded`` concatenated)."""
    import numpy as np
    import torch

    from ..parallel.mesh import Sharded

    if isinstance(leaf, Sharded):
        return np.concatenate([s.detach().cpu().numpy() for s in leaf.shards])
    if isinstance(leaf, torch.Tensor):
        return leaf.detach().cpu().numpy()
    return np.asarray(leaf)


def _out_values(out) -> list:
    """Every output leaf as numpy, numbers included (EM's counts)."""
    import numpy as np

    from ..parallel.mesh import Sharded

    if isinstance(out, (bool, int, float)):
        return [np.asarray(out)]
    if isinstance(out, Sharded) or not isinstance(out, (tuple, list, dict)):
        return [_host(out)] if _spec_leaves(out) else []
    if isinstance(out, dict):
        return [v for k in sorted(out) for v in _out_values(out[k])]
    return [v for e in out for v in _out_values(e)]


def per_shard(mesh, fn):
    """fn over each shard alone, for the kernels that name no mesh: shard
    k gets piece k of every ``Sharded`` argument and the other arguments as
    they are; each output leaf comes back as a ``Sharded`` of the pieces."""
    def run(*args):
        return _stack([fn(*_map_sharded(args, lambda s, k=k: s.shards[k]))
                       for k in range(mesh.size)])

    return run


def _stack(outs):
    """Per-shard output trees -> one tree whose leaves are ``Sharded``."""
    from ..parallel.mesh import Sharded

    first = outs[0]
    if isinstance(first, tuple):
        mapped = [_stack([o[i] for o in outs]) for i in range(len(first))]
        return type(first)(*mapped) if hasattr(first, "_fields") else tuple(mapped)
    return Sharded(tuple(outs))


# ---------------------------------------------------------------------------
# The recorder: shard provenance of every dispatched op
# ---------------------------------------------------------------------------


class _ShardRecord:
    """What one call dispatched, by shard."""

    def __init__(self, mesh_size: int):
        self.mesh_size = mesh_size
        self._tags: dict = {}  # id -> (weakref, frozenset of shard indices)
        self.ops: list[tuple] = []  # (op, shard | None, output bytes, output refs)
        self.gathers: list[tuple] = []  # (op, shards)
        self.reductions = 0
        self.launches: dict = {}  # strings_cuda variant -> launches in the call
        self.peak_bytes: int | None = None

    def tag(self, t, shards: frozenset) -> None:
        self._tags[id(t)] = (weakref.ref(t), shards)

    def tags_of(self, t) -> frozenset:
        entry = self._tags.get(id(t))
        if entry is None or entry[0]() is not t:
            return frozenset()
        return entry[1]


def _recorder(record: _ShardRecord):
    import torch
    from torch.utils._python_dispatch import TorchDispatchMode

    from ..parallel import mesh as mesh_mod
    from .trace_audit import leaves

    class Recorder(TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            kwargs = kwargs or {}
            out = func(*args, **kwargs)
            ins = [t for t in leaves((list(args), kwargs)) if isinstance(t, torch.Tensor)]
            tags = frozenset().union(*(record.tags_of(t) for t in ins))
            if mesh_mod.reducing:
                tags = frozenset()  # the reduction's sum is replicated
            elif len(tags) > 1:
                record.gathers.append((str(func), tags))
            outs = [t for t in leaves(out) if isinstance(t, torch.Tensor)]
            for t in outs:
                record.tag(t, tags)
            shard = next(iter(tags)) if len(tags) == 1 else None
            record.ops.append((str(func), shard,
                               sum(t.numel() * t.element_size() for t in outs),
                               [weakref.ref(t) for t in outs]))
            return out

    return Recorder()


def _run_recorded(fn, args, kwargs, mesh_size: int, dev) -> tuple:
    """(output, record) of one call under the shard recorder. Every input
    piece of a ``Sharded`` argument is tagged with its shard index."""
    import torch

    from ..parallel import mesh as mesh_mod
    from ..parallel.mesh import Sharded
    from .trace_audit import _launch_counts

    record = _ShardRecord(mesh_size)
    for leaf in _spec_leaves((args, kwargs)):
        if isinstance(leaf, Sharded):
            for k, piece in enumerate(leaf.shards):
                record.tag(piece, frozenset({k}))
    on_card = dev.type == "cuda"
    if on_card:
        torch.cuda.synchronize(dev)
        torch.cuda.reset_peak_memory_stats(dev)
        base = torch.cuda.memory_allocated(dev)
    launches = _launch_counts()
    reductions = mesh_mod.reductions
    with _recorder(record):
        out = fn(*args, **kwargs)
    if on_card:
        torch.cuda.synchronize(dev)
        record.peak_bytes = torch.cuda.max_memory_allocated(dev) - base
    record.reductions = mesh_mod.reductions - reductions
    after = _launch_counts()
    record.launches = {k: after[k] - launches.get(k, 0) for k in sorted(after)
                       if after[k] - launches.get(k, 0)}
    return out, record


def _tensor_bytes(t) -> int:
    return t.numel() * t.element_size()


def _leaf_bytes_by_shard(tree, mesh_size: int) -> int:
    """The largest shard's bytes of a tree: piece k of every ``Sharded``,
    plus every other tensor once (replicated on each shard)."""
    import torch

    from ..parallel.mesh import Sharded

    per = [0] * mesh_size
    seen: set = set()
    for leaf in _spec_leaves(tree):
        if isinstance(leaf, Sharded):
            for k, piece in enumerate(leaf.shards[:mesh_size]):
                per[k] += _tensor_bytes(piece)
        elif isinstance(leaf, torch.Tensor) and id(leaf) not in seen:
            seen.add(id(leaf))
            per = [p + _tensor_bytes(leaf) for p in per]
    return max(per)


def _costs(record: _ShardRecord, args, kwargs, out) -> dict:
    """The SA-COST record of one call, per shard (the largest shard's):
    ops with one shard's provenance count on that shard, the rest (the
    reductions, the replicated parameter work) on shard 0, the mesh's
    first device, where the reductions land."""
    import torch

    from ..parallel.mesh import Sharded

    n = record.mesh_size
    final = set()
    for leaf in _spec_leaves(out):
        for t in (leaf.shards if isinstance(leaf, Sharded) else (leaf,)):
            if isinstance(t, torch.Tensor):
                final.add(id(t))
    ops = [0] * n
    temp = [0] * n
    for _op, shard, nbytes, refs in record.ops:
        k = 0 if shard is None else shard
        ops[k] += 1
        if not any(r() is not None and id(r()) in final for r in refs):
            temp[k] += nbytes
    costs = {
        "ops": float(max(ops)),
        "argument_size_in_bytes": float(_leaf_bytes_by_shard((args, kwargs), n)),
        "output_size_in_bytes": float(_leaf_bytes_by_shard(out, n)),
        "temp_size_in_bytes": float(max(temp)),
    }
    if record.peak_bytes is not None:
        costs["peak_bytes"] = float(record.peak_bytes)
    return costs


def _collective_counts(record: _ShardRecord) -> dict[str, int]:
    counts = {}
    if record.reductions:
        counts["reduce"] = record.reductions
    if record.gathers:
        counts["gather"] = len(record.gathers)
    return counts


def _built(spec: ShardKernelSpec, dev):
    """(fn, args, kwargs, whole) of one spec on ``dev``, memoised."""
    key = ("built", str(dev))
    if key not in spec.cache:
        out = spec.build(dev)
        fn, args, kwargs = out[:3]
        spec.cache[key] = (fn, args, kwargs, out[3] if len(out) > 3 else None)
    return spec.cache[key]


def _measured(spec: ShardKernelSpec, dev):
    """(output, record) of the recorded call on ``dev``, memoised. One
    unrecorded call runs first, so lazy set-up (the mesh kernels' cached
    replicas, the hand kernels' first build) stays out of the record."""
    key = ("record", str(dev))
    if key not in spec.cache:
        fn, args, kwargs, _ = _built(spec, dev)
        fn(*args, **kwargs)
        spec.cache[key] = _run_recorded(fn, args, kwargs, spec.mesh_size, dev)
    return spec.cache[key]


def measure_shard_kernel(spec: ShardKernelSpec, device=None) -> dict:
    """The committed-baseline record of one kernel on ``device``: exact
    collective counts plus the per-shard costs."""
    dev = _resolve(device)
    fn, args, kwargs, _ = _built(spec, dev)
    out, record = _measured(spec, dev)
    rec = {"collectives": _collective_counts(record)}
    rec.update(_costs(record, args, kwargs, out))
    return rec


# ---------------------------------------------------------------------------
# Invariants
# ---------------------------------------------------------------------------


def _check_spec(spec, mesh, fail, role: str, tree) -> None:
    import torch

    from ..parallel.mesh import Sharded

    for idx, leaf in enumerate(_spec_leaves(tree)):
        if isinstance(leaf, Sharded):
            shape = tuple(leaf.shape)
            if shape[0] != spec.n_pairs:
                fail("SA-SPEC",
                     f"{role} {idx} {shape} is sharded but is not a pair-axis array — "
                     "parameters/tables/accumulators replicate in this design",
                     "pass it whole (replicated) to every shard")
                continue
            sizes = {s.shape[0] for s in leaf.shards}
            devices = tuple(s.device for s in leaf.shards)
            if len(leaf.shards) != mesh.size or len(sizes) != 1 or devices != mesh.devices:
                fail("SA-SPEC",
                     f"{role} {idx} {shape} is split into {len(leaf.shards)} piece(s) of "
                     f"{sorted(sizes)} rows on {sorted({str(d) for d in devices})}, not the "
                     f"mesh's {mesh.size} equal pieces on their shards' devices",
                     "shard it with mesh.pair_sharding (shard_pairs does this for you)")
        elif isinstance(leaf, torch.Tensor) and leaf.dim() and leaf.shape[0] == spec.n_pairs:
            fail("SA-SPEC",
                 f"{role} {idx} {tuple(leaf.shape)} has the pair axis leading but is "
                 f"not sharded over '{mesh.axis_name}' — every shard reads (and "
                 "processes) the whole array",
                 "shard it with mesh.pair_sharding (shard_pairs does this for you)")


def _ulp_close(a, b) -> bool:
    import numpy as np

    if a.shape != b.shape or a.dtype != b.dtype:
        return False
    if not np.issubdtype(a.dtype, np.floating):
        return np.array_equal(a, b)
    if not np.array_equal(np.isnan(a), np.isnan(b)):
        return False
    a, b = np.nan_to_num(a.astype(np.float64)), np.nan_to_num(b.astype(np.float64))
    ulp = np.spacing(np.maximum(np.abs(a), np.abs(b)).astype(np.float32)).astype(np.float64)
    return bool(np.all(np.abs(a - b) <= FLOAT_ULP * ulp))


def _bit_equal(a, b) -> bool:
    return a.shape == b.shape and a.dtype == b.dtype and a.tobytes() == b.tobytes()


def _perturbed(spec, mesh, args, kwargs):
    """``(args, kwargs)`` with the padding rows (weight 0) of every
    pair-axis input set to real rows' values, or a message when the
    example inputs hold no padding."""
    import numpy as np

    from ..parallel.mesh import Sharded, pair_sharding

    w = args[spec.pad_weights_argnum] if spec.pad_weights_argnum < len(args) else None
    if not isinstance(w, Sharded):
        return None, f"arg {spec.pad_weights_argnum} is not a sharded weights array"
    pad = _host(w) == 0
    if not pad.any() or pad.all():
        return None, ("the example weights hold no padding row: build the inputs "
                      f"through shard_pairs from fewer than {spec.n_pairs} real rows")
    real = np.flatnonzero(~pad)
    src = real[np.arange(int(pad.sum())) % len(real)]

    def perturb(s: Sharded):
        if s is w or s.shape[0] != spec.n_pairs:
            return s
        full = _host(s).copy()
        full[pad] = full[src]
        return pair_sharding(mesh, full).to(s.shards[0].dtype)

    return (_map_sharded(tuple(args), perturb), _map_sharded(dict(kwargs), perturb)), None


def audit_shard_kernel(spec: ShardKernelSpec, baseline: dict | None,
                       device=None) -> list[Finding]:
    """Run one registered kernel on the audit mesh and check the SA-*
    invariants against its committed baseline."""
    findings: list[Finding] = []

    def fail(check: str, message: str, hint: str = "") -> None:
        findings.append(Finding(rule=check, path=spec.location, line=0,
                                message=message, hint=hint))

    try:
        dev = _resolve(device)
        mesh = audit_mesh(spec.mesh_size, dev)
        fn, args, kwargs, whole = _built(spec, dev)
        out, record = _measured(spec, dev)
    except Exception as e:  # noqa: BLE001 - any build or run failure is a finding
        fail("SA-ERROR", f"kernel failed to build/run on the mesh: {type(e).__name__}: {e}")
        return findings

    # SA-SPEC: the placement of every input and output leaf
    _check_spec(spec, mesh, fail, "input", (args, kwargs))
    _check_spec(spec, mesh, fail, "output", out)
    if whole is not None:
        try:
            wfn, wargs = whole
            want = _out_values(wfn(*wargs))
        except Exception as e:  # noqa: BLE001
            fail("SA-ERROR", f"the unsharded call failed: {type(e).__name__}: {e}")
            want = None
        got = _out_values(out)
        if want is not None and (len(want) != len(got) or not all(
                _ulp_close(g, w) for g, w in zip(got, want))):
            bad = [i for i, (g, w) in enumerate(zip(got, want)) if not _ulp_close(g, w)]
            fail("SA-SPEC",
                 f"the per-shard outputs differ from the unsharded call (output(s) "
                 f"{bad or 'count'}; integers bit for bit, floats within {FLOAT_ULP} ulp)",
                 "a shard reads rows outside its piece, or the pieces are assembled "
                 "out of order")

    # SA-COLL: gathers always fail; declared reductions match the budget
    counts = _collective_counts(record)
    for kind, n in sorted(counts.items()):
        if kind not in spec.allow_collectives:
            detail = ""
            if kind == "gather":
                ops = sorted({op for op, _ in record.gathers})[:4]
                detail = f" ({', '.join(ops)})"
            fail("SA-COLL",
                 f"{n}x {kind} in the sharded call{detail} but the kernel's collective "
                 f"allowlist is {list(spec.allow_collectives)}",
                 "an op combined several shards' data; keep the work shard-local and "
                 "sum through mesh.reduce_shards, declared on the kernel")
    if baseline is not None:
        budget = baseline.get("collectives", {})
        for kind in sorted(set(budget) | set(counts)):
            if kind not in spec.allow_collectives:
                continue  # unallowed kinds already reported above
            want, got = int(budget.get(kind, 0)), int(counts.get(kind, 0))
            if want != got:
                fail("SA-COLL",
                     f"collective budget drift: expected {want}x {kind} (committed "
                     f"baseline), found {got}x",
                     "a reduction was deleted/duplicated; if intentional, refresh "
                     f"with `{REFRESH}`")

    # SA-PAD: padding rows cannot move an output
    if spec.pad_weights_argnum is not None:
        pargs, why = _perturbed(spec, mesh, args, kwargs)
        if why is not None:
            fail("SA-PAD", why)
        else:
            try:
                moved = _out_values(fn(*pargs[0], **pargs[1]))
                ref = _out_values(out)
                unreached = [i for i, (a, b) in enumerate(zip(ref, moved))
                             if not _bit_equal(a, b)]
            except Exception as e:  # noqa: BLE001
                fail("SA-ERROR", f"SA-PAD call failed: {type(e).__name__}: {e}")
                unreached = []
            if unreached:
                fail("SA-PAD",
                     f"setting the padding rows (weight 0) of the pair-axis inputs to "
                     f"real rows' values changed output(s) {unreached}: the padding "
                     f"weights (arg {spec.pad_weights_argnum}) do not reach them, so "
                     "padded rows from shard_pairs would contribute to the M-step sums",
                     "thread the weights through every reduction "
                     "(sufficient_stats(..., weights=w))")

    # SA-COST: measured costs against the committed baseline
    measured = _costs(record, args, kwargs, out)
    if baseline is None:
        fail("SA-COST", "no committed cost baseline for this kernel",
             f"generate one with `{REFRESH}` and commit shard_baselines.json")
    else:
        for key in _COST_KEYS:
            if key not in baseline or key not in measured:
                continue
            want, got = float(baseline[key]), float(measured[key])
            if want == 0.0 and got == 0.0:
                continue
            rel = abs(got - want) / max(abs(want), 1.0)
            if rel > spec.cost_rtol:
                sign = "+" if got >= want else "-"
                fail("SA-COST",
                     f"{key}: baseline {want:.0f}, measured {got:.0f} ({sign}"
                     f"{rel * 100:.1f}% > ±{spec.cost_rtol * 100:.0f}% tolerance)",
                     "a cost/memory regression on the sharded path; if the change is "
                     f"intended, refresh with `{REFRESH}`")
    return findings


# ---------------------------------------------------------------------------
# Driver + baselines
# ---------------------------------------------------------------------------


def load_baselines(path: str = BASELINES_PATH) -> dict:
    if not os.path.exists(path):
        return {}
    with open(path, encoding="utf-8") as fh:
        return json.load(fh)


def _tier_kernels(baselines: dict, tier: str) -> dict:
    """The per-kernel records of ``tier`` in a baseline file, or of a bare
    ``{"kernels": ...}`` dict."""
    if "tiers" in baselines:
        return baselines["tiers"].get(tier, {}).get("kernels", {})
    return baselines.get("kernels", baselines)


def _specs(names, reg) -> list:
    if names:
        unknown = [n for n in names if n not in reg]
        if unknown:
            raise KeyError(f"unknown shard kernel(s): {', '.join(unknown)}")
        return [reg[n] for n in names]
    return [reg[n] for n in sorted(reg)]


def run_shard_audit(names=None, baselines: dict | None = None,
                    registry: dict | None = None, device=None
                    ) -> tuple[list[Finding], int]:
    """Audit the given shard kernels (default: all registered) on
    ``device`` (``cuda`` unless named) against its tier's baselines.
    Returns (findings, kernel count)."""
    reg = SHARD_REGISTRY if registry is None else registry
    if registry is None:
        _ensure_default_registry()
    specs = _specs(names, reg)
    if baselines is None:
        baselines = load_baselines()
    per_kernel = _tier_kernels(baselines, current_tier(device))
    findings: list[Finding] = []
    for spec in specs:
        findings.extend(audit_shard_kernel(spec, per_kernel.get(spec.name), device))
    return findings, len(specs)


def update_baselines(names=None, path: str = BASELINES_PATH, device=None) -> dict:
    """Re-measure every (or the named) registered kernel on ``device`` and
    write that tier's block of the baseline file (other tiers are kept). A
    full refresh rebuilds the tier's block from the registry alone, so
    renamed or removed kernels are pruned; a named refresh merges. Returns
    the new baselines dict."""
    _ensure_default_registry()
    specs = _specs(names, SHARD_REGISTRY)
    tier = current_tier(device)
    existing = load_baselines(path)
    tiers = dict(existing.get("tiers", {}))
    kernels = dict(tiers.get(tier, {}).get("kernels", {})) if names else {}
    for spec in specs:
        kernels[spec.name] = measure_shard_kernel(spec, device)
    tiers[tier] = {"_meta": device_meta(device),
                   "kernels": {k: kernels[k] for k in sorted(kernels)}}
    new = {
        "_meta": {"mesh_shards": DEFAULT_MESH_SIZE, "refresh": REFRESH,
                  "cost_rtol": DEFAULT_COST_RTOL},
        "tiers": {t: tiers[t] for t in sorted(tiers)},
    }
    with open(path, "w", encoding="utf-8") as fh:
        json.dump(new, fh, indent=2, sort_keys=True)
        fh.write("\n")
    return new


# ---------------------------------------------------------------------------
# Default registry: the sharded hot path, the reference's 19 names
# ---------------------------------------------------------------------------

_defaults_registered = False


def _ensure_default_registry() -> None:
    global _defaults_registered
    if _defaults_registered:
        return
    _defaults_registered = True
    _register_defaults()


def _register_defaults() -> None:
    import numpy as np

    from .trace_audit import shared_fs_arrays, shared_fs_inputs, shared_gamma_program

    imax = np.int32(np.iinfo(np.int32).max)

    def sharded_fs(device, n_pairs: int, n_real: int | None = None):
        """(mesh, G, params, w): the shared FS example gammas tiled to
        ``n_real`` rows (default ``n_pairs``) and padded to ``n_pairs``
        through shard_pairs; the parameters plain (replicated)."""
        from ..parallel.mesh import shard_pairs

        mesh = audit_mesh(device=device)
        G_small = shared_fs_arrays()[0]
        n_real = n_pairs if n_real is None else n_real
        reps = -(-n_real // G_small.shape[0])
        G, w = shard_pairs(mesh, np.tile(G_small, (reps, 1))[:n_real])
        return mesh, G, shared_fs_inputs(str(device))[1], w

    # The full EM loop over pair-sharded gammas and padding weights: per
    # update one statistics reduction and one log-likelihood reduction,
    # and one more for the final log likelihood.
    @register_shard_kernel("em_step_sharded", n_pairs=1024, allow_collectives=("reduce",),
                           pad_weights_argnum=2)
    def _build_em_step_sharded(device):
        from ..em import run_em

        _, G, params, w = sharded_fs(device, 1024, 1021)
        fn = lambda G, p, w, tol: run_em(  # noqa: E731
            G, p, max_iterations=4, max_levels=3, em_convergence=tol, weights=w,
            compute_ll=True,
        )
        return fn, (G, params, w, float(np.float32(1e-4))), {}

    # One E+M sufficient-statistics pass: THE statistics reduction.
    @register_shard_kernel("em_stats_sharded", n_pairs=1024, allow_collectives=("reduce",),
                           pad_weights_argnum=2)
    def _build_em_stats_sharded(device):
        from ..em import _replicate, shard_stats

        _, G, params, w = sharded_fs(device, 1024, 1021)
        fn = lambda G, p, w: shard_stats(G.shards, w.shards, _replicate(p, G.shards), 3)  # noqa: E731
        return fn, (G, params, w), {}

    # The streamed pass's sharded batch (stats + log likelihood): two
    # reductions.
    @register_shard_kernel("streamed_pass_sharded", n_pairs=1024,
                           allow_collectives=("reduce",), pad_weights_argnum=2)
    def _build_streamed_pass_sharded(device):
        import torch

        from ..parallel.streaming import _shard_batch_stats

        _, G, params, w = sharded_fs(device, 1024, 1021)
        fn = lambda G, p, w: _shard_batch_stats(G, w, p, 3, torch.float32, True)  # noqa: E731
        return fn, (G, params, w), {}

    # Scoring is embarrassingly parallel over pairs: zero collectives, the
    # scores come back pair-sharded.
    @register_shard_kernel("score_pairs_sharded", n_pairs=1024)
    def _build_score_pairs_sharded(device):
        from ..em import _replicate, score_pairs
        from ..parallel.mesh import Sharded

        _, G, params, _ = sharded_fs(device, 1024)

        def fn(G, p):
            return Sharded(tuple(score_pairs(g, q) for g, q in zip(G.shards, _replicate(p, G.shards))))

        return fn, (G, params), {}

    # The exact gamma body per shard (the mesh pattern passes' body: dense
    # Jaro-Winkler), the packed table replicated, zero collectives.
    @register_shard_kernel("gamma_batch_sharded", n_pairs=256)
    def _build_gamma_batch_sharded(device):
        from ..parallel.mesh import Sharded, pair_sharding, replicated

        mesh = audit_mesh(device=device)
        program = shared_gamma_program(str(device))

        def fn(packed, il, ir):
            return Sharded(tuple(program._gammas(packed[k], a, b, False)
                                 for k, (a, b) in enumerate(zip(il.shards, ir.shards))))

        il = pair_sharding(mesh, np.zeros(256, np.int32))
        ir = pair_sharding(mesh, np.ones(256, np.int32))
        return fn, (replicated(mesh, program._packed), il, ir), {}

    # The materialised pattern kernel on the mesh: per-shard ids (the
    # exact body), ONE histogram reduction into the replicated accumulator
    # (positions at or past ``valid`` counted in the sentinel bin).
    @register_shard_kernel("pattern_kernel_sharded", n_pairs=256,
                           allow_collectives=("reduce",))
    def _build_pattern_kernel_sharded(device):
        import torch

        from ..gammas import shard_histogram
        from ..parallel.mesh import Sharded, pair_sharding

        mesh = audit_mesh(device=device)
        program = shared_gamma_program(str(device))
        mfn = program._pattern_batch_for_mesh(mesh)
        per = 256 // mesh.size

        def fn(il, ir, valid, acc):
            pids, counted = [], []
            for k, (a, b) in enumerate(zip(il.shards, ir.shards)):
                pid = mfn(k, a, b)
                pos = torch.arange(k * per, (k + 1) * per, dtype=torch.int64, device=pid.device)
                pids.append(program.narrow_ids(pid))
                counted.append(torch.where(pos >= valid, program.n_patterns, pid))
            return Sharded(tuple(pids)), acc + shard_histogram(counted, program.n_patterns)

        il = pair_sharding(mesh, np.zeros(256, np.int32))
        ir = pair_sharding(mesh, np.ones(256, np.int32))
        acc = torch.zeros(program.n_patterns + 1, dtype=torch.int64, device=mesh.devices[0])
        return fn, (il, ir, 200, acc), {}

    def _plan_units(n_pairs: int):
        """(ua, la, pc) of triangle units of 3 rows (3 pairs each) and 2
        rows (1 pair) over an order's first rows: exactly ``n_pairs``
        positions, so every shard decodes in-range positions."""
        n3, rest = divmod(n_pairs, 3)
        lens = np.array([3] * n3 + [2] * rest, np.int32)
        units = np.zeros(len(lens), np.int32)
        per_unit = lens * (lens - 1) // 2
        pc = np.concatenate([[0], np.cumsum(per_unit)]).astype(np.int64)
        return units, lens, pc

    # The virtual pair index decode + score on the mesh: sharded positions,
    # the plan replicated, one histogram reduction.
    @register_shard_kernel("virtual_pattern_kernel_sharded", n_pairs=128,
                           allow_collectives=("reduce",))
    def _build_virtual_pattern_sharded(device):
        import torch

        from ..gammas import shard_histogram
        from ..pairgen import RulePlan, VirtualPlan, make_virtual_pattern_fn
        from ..parallel.mesh import Sharded, pair_sharding

        mesh = audit_mesh(device=device)
        program = shared_gamma_program(str(device))
        bs = 128
        order = np.arange(6, dtype=np.int32)
        units, lens, pc = _plan_units(bs)
        plan = VirtualPlan(
            rules=[RulePlan(order=order, ua=units, la=lens, ub=units, lb=lens, pc=pc)],
            codes=np.zeros((1, 6), np.int32), uid_codes=None, n_candidates=int(pc[-1]),
        )
        vfn = make_virtual_pattern_fn(program, plan, 0, mesh)

        def fn(pos, acc):
            parts = [vfn(q, k) for k, q in enumerate(pos.shards)]
            return (Sharded(tuple(program.narrow_ids(p) for p in parts)),
                    acc + shard_histogram(parts, program.n_patterns))

        pos = pair_sharding(mesh, np.arange(bs, dtype=np.int64))
        acc = torch.zeros(program.n_patterns + 1, dtype=torch.int64, device=mesh.devices[0])
        return fn, (pos, acc), {}

    # ----- the kernels that name no mesh: each shard runs alone -----------

    def _serve(device, fused: bool, tf: bool):
        import torch

        from ..parallel.mesh import pair_sharding
        from ..serve.engine import score_fused, score_topk

        mesh = audit_mesh(device=device)
        program = shared_gamma_program(str(device))
        _, params = shared_fs_inputs(str(device))
        cols = program.settings["comparison_columns"]
        n_ref = program._packed.shape[0]
        rng = np.random.default_rng(0)
        packed_q = program._packed.cpu().numpy()[rng.integers(0, n_ref, size=64)]
        cand = rng.integers(0, n_ref, size=(64, 8)).astype(np.int32)
        valid = rng.integers(0, 2, size=(64, 8)).astype(bool)
        dev = mesh.devices[0]
        up = lambda a: torch.from_numpy(a).to(dev)  # noqa: E731
        if not tf:
            score = score_fused if fused else score_topk

            def one(pq, pr, c, v, p):
                return score(program._layout, cols, 4, pq, pr, c, v, p)

            args = (packed_q, cand, valid)
            sharded = tuple(pair_sharding(mesh, a) for a in args)
            return (per_shard(mesh, one),
                    (sharded[0], program._packed, sharded[1], sharded[2], params), {},
                    (one, (up(packed_q), program._packed, up(cand), up(valid), params)))
        spec = ((1, "city", 1),)

        def one_tf(pq, pr, c, v, p, tf_q, tf_tid, tf_log):
            return score_fused(program._layout, cols, 4, pq, pr, c, v, p,
                               spec, tf_q, tf_tid, tf_log)

        tf_q = rng.integers(0, 4, size=64).astype(np.int32)
        tf_tid = rng.integers(0, 4, size=n_ref).astype(np.int32)
        tf_log = np.full(4, -1.0, np.float32)
        tail = ((up(tf_tid),), (up(tf_log),))
        return (per_shard(mesh, one_tf),
                (pair_sharding(mesh, packed_q), program._packed, pair_sharding(mesh, cand),
                 pair_sharding(mesh, valid), params, (pair_sharding(mesh, tf_q),), *tail), {},
                (one_tf, (up(packed_q), program._packed, up(cand), up(valid), params,
                          (up(tf_q),), *tail)))

    # Online scoring sharded over the QUERY axis: the reference table and
    # parameters replicate, each shard scores and ranks its own queries;
    # ZERO collectives.
    @register_shard_kernel("serve_score_topk_sharded", n_pairs=64)
    def _build_serve_score_sharded(device):
        return _serve(device, False, False)

    @register_shard_kernel("serve_score_fused_sharded", n_pairs=64)
    def _build_serve_score_fused_sharded(device):
        return _serve(device, True, False)

    # The TF-fold variant: query token ids shard with the queries, the
    # reference token ids and log frequencies replicate.
    @register_shard_kernel("serve_score_fused_tf_sharded", n_pairs=64)
    def _build_serve_score_fused_tf_sharded(device):
        return _serve(device, True, True)

    # The device-blocking emission's decode and masks over the pair-
    # POSITION axis (blocking_device.decode_shard, the mesh emission's
    # per-shard body): the plan replicates, ZERO collectives (the host
    # compacts each shard's survivors).
    @register_shard_kernel("block_pair_decode_sharded", n_pairs=64)
    def _build_block_pair_decode_sharded(device):
        from ..blocking_device import DeviceBlockPlan, DeviceRule, decode_shard
        from ..parallel.mesh import Sharded, pair_sharding

        mesh = audit_mesh(device=device)
        order = np.arange(8, dtype=np.int32)
        units, lens, pc = _plan_units(64)
        zeros = np.zeros((1, 8), np.int32)
        plan = DeviceBlockPlan(
            rules=[DeviceRule("l.k = r.k", order, units, lens, units, lens, pc, True),
                   DeviceRule("l.k2 = r.k2", order, units, lens, units, lens, pc, True)],
            codes_l=np.concatenate([zeros, zeros]), codes_r=np.concatenate([zeros, zeros]),
            ranks=np.arange(8, dtype=np.int32), uid_codes=np.zeros(8, np.int32),
            device=mesh.devices[0],
        )

        def fn(pos):
            parts = [decode_shard(plan, 1, q) for q in pos.shards]
            return tuple(Sharded(tuple(p[i] for p in parts)) for i in range(3))

        return fn, (pair_sharding(mesh, np.arange(64, dtype=np.int64)),), {}

    # The spill emission's transfer digest over the pair-position axis:
    # each shard mixes its own lanes, ONE reduction sums the digests.
    @register_shard_kernel("spill_chunk_digest_sharded", n_pairs=64,
                           allow_collectives=("reduce",))
    def _build_spill_chunk_digest_sharded(device):
        from ..blocking_device import chunk_digest
        from ..parallel.mesh import pair_sharding, reduce_shards

        mesh = audit_mesh(device=device)
        rng = np.random.default_rng(0)
        i = rng.integers(0, 64, size=64).astype(np.int32)
        j = rng.integers(0, 64, size=64).astype(np.int32)
        keep = rng.integers(0, 2, size=64).astype(bool)

        def fn(i, j, keep):
            return reduce_shards([chunk_digest(a, b, c)
                                  for a, b, c in zip(i.shards, j.shards, keep.shards)])

        return fn, tuple(pair_sharding(mesh, a) for a in (i, j, keep)), {}

    def _minhash(device, weighted: bool):
        import torch

        from ..approx.minhash import (
            DF_TABLE_SIZE,
            band_keys,
            column_salts,
            hash_params,
            minhash_signatures,
        )
        from ..parallel.mesh import pair_sharding

        mesh = audit_mesh(device=device)
        dev = mesh.devices[0]
        rng = np.random.default_rng(0)
        bytes_ = rng.integers(97, 123, size=(64, 12)).astype(np.uint8)
        lens = np.full(64, 8, np.int32)
        a, b = hash_params(8)
        rep = [torch.from_numpy(a.astype(np.int64)).to(dev),
               torch.from_numpy(b.astype(np.int64)).to(dev), column_salts(1)]
        if weighted:
            rep.append(torch.ones(DF_TABLE_SIZE, dtype=torch.float32, device=dev))

        def one(chars, lens, a, b, salts, idf=None):
            sig, has = minhash_signatures([chars], [lens], 2, a, b, salts, idf)
            return band_keys(sig, 4, 2), has

        whole = (one, (torch.from_numpy(bytes_).to(dev), torch.from_numpy(lens).to(dev), *rep))
        return (per_shard(mesh, one),
                (pair_sharding(mesh, bytes_), pair_sharding(mesh, lens), *rep), {}, whole)

    # Approximate-blocking signatures sharded over the RECORD axis: the
    # hash parameters replicate, ZERO collectives.
    @register_shard_kernel("approx_minhash_sharded", n_pairs=64)
    def _build_approx_minhash_sharded(device):
        return _minhash(device, False)

    # The TF-weighted sampler: the IDF table replicates beside them.
    @register_shard_kernel("approx_minhash_weighted_sharded", n_pairs=64)
    def _build_approx_minhash_weighted_sharded(device):
        return _minhash(device, True)

    def _verify(device, weighted: bool):
        import torch

        from ..approx.lsh import verify_pairs
        from ..approx.minhash import DF_TABLE_SIZE
        from ..parallel.mesh import pair_sharding

        mesh = audit_mesh(device=device)
        dev = mesh.devices[0]
        rng = np.random.default_rng(0)
        i = rng.integers(0, 16, size=64).astype(np.int32)
        j = rng.integers(0, 16, size=64).astype(np.int32)
        up = lambda a: torch.from_numpy(a).to(dev)  # noqa: E731
        rep = [up(rng.integers(-1, 4, size=(4, 16)).astype(np.int32)),
               up(rng.integers(97, 123, size=(16, 12)).astype(np.uint8)),
               up(np.full(16, 8, np.int32)), up(np.zeros((16, 1), np.int32)),
               up(np.full(16, 7, np.int32))]
        if weighted:
            rep.append(torch.ones(DF_TABLE_SIZE, dtype=torch.float32, device=dev))

        def one(i, j, band_codes, chars, lens, mask, count, idf=None):
            return verify_pairs(i, j, band_codes, [(chars, lens, mask, count)], 2, True, idf)

        return (per_shard(mesh, one), (pair_sharding(mesh, i), pair_sharding(mesh, j), *rep),
                {}, (one, (up(i), up(j), *rep)))

    # Approximate-blocking verification over the candidate-PAIR axis: the
    # band codes and the byte tables replicate, ZERO collectives.
    @register_shard_kernel("approx_verify_sharded", n_pairs=64)
    def _build_approx_verify_sharded(device):
        return _verify(device, False)

    @register_shard_kernel("approx_verify_weighted_sharded", n_pairs=64)
    def _build_approx_verify_weighted_sharded(device):
        return _verify(device, True)

    # String similarity is per pair: zero collectives, output sharded; the
    # hand kernel on the card, its plain version on the CPU.
    @register_shard_kernel("jaro_winkler_sharded", n_pairs=64)
    def _build_jw_sharded(device):
        from ..ops import strings
        from ..parallel.mesh import Sharded, pair_sharding

        mesh = audit_mesh(device=device)
        rng = np.random.default_rng(0)
        s = pair_sharding(mesh, rng.integers(97, 123, size=(64, 24)).astype(np.uint8))
        ln = pair_sharding(mesh, np.full(64, 8, np.int32))

        def fn(s1, s2, l1, l2, p, bt):
            return Sharded(tuple(strings.jaro_winkler(*piece, p, bt)
                                 for piece in zip(s1.shards, s2.shards, l1.shards, l2.shards)))

        return fn, (s, s, ln, ln, float(np.float32(0.1)), float(np.float32(0.7))), {}

    # The quality profile over pair-sharded training gammas: each shard's
    # histogram, ONE reduction (the shard-order sum equals the unsharded
    # profile).
    @register_shard_kernel("quality_profile_sharded", n_pairs=1024,
                           allow_collectives=("reduce",))
    def _build_quality_profile_sharded(device):
        import torch

        from ..em import _replicate
        from ..obs.quality import make_profile_fn
        from ..parallel.mesh import reduce_shards

        _, G, params, _ = sharded_fs(device, 1024)
        profile = make_profile_fn((3, 3, 3), bins=8)

        def fn(G, p):
            return reduce_shards([profile(g, q) for g, q in zip(G.shards, _replicate(p, G.shards))])

        return fn, (G, params), {}, (profile, (torch.cat(G.shards), params))

    # The serve-time drift sketch over query-sharded top-k outputs: each
    # shard's counts, ONE reduction added to the replicated accumulator.
    @register_shard_kernel("serve_drift_sketch_sharded", n_pairs=64,
                           allow_collectives=("reduce",))
    def _build_serve_drift_sketch_sharded(device):
        import torch

        from ..obs.drift import make_sketch_fn
        from ..parallel.mesh import pair_sharding, reduce_shards

        mesh = audit_mesh(device=device)
        dev = mesh.devices[0]
        program = shared_gamma_program(str(device))
        cols = program.settings["comparison_columns"]
        bins = 8
        width = max(int(c["num_levels"]) for c in cols) + 1
        size = len(cols) * width + 2 * bins
        sketch = make_sketch_fn(program._layout, cols, bins)
        n_ref = program._packed.shape[0]
        rng = np.random.default_rng(0)
        packed_q = program._packed.cpu().numpy()[rng.integers(0, n_ref, size=64)]
        top_rows = rng.integers(0, n_ref, size=(64, 4)).astype(np.int32)
        top_valid = rng.integers(0, 2, size=(64, 4)).astype(bool)
        top_p = rng.random((64, 4)).astype(np.float32)
        acc = torch.zeros(size, dtype=torch.int64, device=dev)

        def fn(acc, packed_q, packed_ref, top_rows, top_valid, top_p):
            return acc + reduce_shards([
                sketch(torch.zeros_like(acc), *piece[:1], packed_ref, *piece[1:])
                for piece in zip(packed_q.shards, top_rows.shards, top_valid.shards,
                                 top_p.shards)])

        arrays = (packed_q, top_rows, top_valid, top_p)
        sh = [pair_sharding(mesh, a) for a in arrays]
        wh = [torch.from_numpy(a).to(dev) for a in arrays]
        return (fn, (acc, sh[0], program._packed, *sh[1:]), {},
                (sketch, (acc, wh[0], program._packed, *wh[1:])))
