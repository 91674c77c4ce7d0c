"""trace_audit: the kernel registry and the op-level audit of each kernel.

The port of splink_tpu/analysis/trace_audit.py. The reference traces every
registered kernel to a jaxpr and checks what the compiler will run; PyTorch
runs eagerly, so here each kernel RUNS twice on its fixed-seed example
inputs under a ``TorchDispatchMode`` that records every aten op (its name,
its non-tensor arguments, and its outputs' dtypes and shapes), and the
record is held to four invariants under the reference's rule ids:

  TA-CONST     no tensor larger than the spec's ``const_budget_bytes`` is
               made from host data inside the call (``aten.lift_fresh``:
               ``torch.tensor``/``from_numpy``/``as_tensor``), nor copied
               from the host to the card: on the card that is an upload
               on every call, the eager counterpart of the reference's
               constant serialised into every compile request.
  TA-DTYPE     every op's output dtype lies in the spec's allowed set.
               The port widens on purpose in a few places (int64 sort keys
               and indices, float64 ``index_add_`` sums, int64/float64
               position decodes): such a spec allowlists the dtype with
               its reason beside it. The 0-d tensors PyTorch wraps Python
               scalars in (``aten.scalar_tensor``) are exempt, as the
               reference exempts weak-typed scalars.
  TA-CALLBACK  the host-synchronisation allowlist (the reference's
               callback allowlist: a host round trip in the hot path).
               A sync is an op that reads a device value on the host
               (``_local_scalar_dense``, ``nonzero``, ``masked_select``,
               ``unique``, ``bincount``, ...), a copy from the card to
               the host, or a copy from host memory onto the card (it
               waits for the stream). The spec declares how many one call
               may make in ``allow_syncs`` (counted on the card; the CPU
               tier sees only the ops that sync there, never the copies,
               so its count is at most the card's). On the card the count
               is cross-checked against ``torch.cuda.set_sync_debug_mode``:
               the audit takes the larger of the two.
  TA-HASH      the two recorded op sequences are identical. The hand
               kernels launch through ctypes, which the dispatch mode never
               sees, so each call's ``strings_cuda.variant_launches`` delta
               is folded into its record.
  TA-ERROR     the kernel failed to build or run.

Registering a kernel::

    @register_kernel("my_kernel", allow_syncs=1)
    def _build_my_kernel(device):
        fn = ...            # callable to run
        args = (...)        # example inputs, tensors on ``device``
        return fn, args, {}

A builder may return a fourth element: the numpy arrays it made, in the
reference builder's argument order, where its binding to the port's
counterpart differs from the reference's (the registry parity test holds
them to the reference's arrays). Builders run lazily, once per device.
"""

from __future__ import annotations

import functools
import hashlib
import warnings
import weakref
from dataclasses import dataclass, field
from typing import Callable

from .findings import Finding

# dtypes a production kernel may hold (the reference's set)
DEFAULT_ALLOWED_DTYPES = frozenset(
    {"float32", "int32", "int8", "int16", "uint8", "uint16", "uint32", "bool"}
)

# aten ops that read a device value back to the host: each is one sync on
# the card (they sync on no other device, but the op is recorded on every
# device, so the CPU tier counts them too)
SYNC_OPS = frozenset(
    {
        "_local_scalar_dense",
        "nonzero",
        "masked_select",
        "_unique",
        "_unique2",
        "unique_dim",
        "unique_consecutive",
        "unique_dim_consecutive",
        "bincount",
        "equal",
        "is_nonzero",
    }
)

DEFAULT_CONST_BUDGET = 1 << 16  # 64 KiB per tensor made from host data


def _dtype_name(dtype) -> str:
    return str(dtype).replace("torch.", "")


@dataclass
class KernelSpec:
    name: str
    build: Callable  # (device) -> (fn, args, kwargs[, reference-order inputs])
    allow_dtypes: frozenset = DEFAULT_ALLOWED_DTYPES
    # host syncs one call may make: an int for every tier, or a dict by
    # tier ("cpu", "cuda"): the tiers run different forms in places (the
    # CPU compacts the Jaro-Winkler survivors with nonzero, the card
    # launches one masked kernel), and the CPU never sees a copy
    allow_syncs: int | dict = 0
    const_budget_bytes: int = DEFAULT_CONST_BUDGET
    # NA-ULP's float64 arm where the kernel computes only in float32 (the
    # hand kernels): the same signature, evaluated in float64
    f64_fn: Callable | None = None
    # per-spec memo of the build result (per device) and the audit's last
    # record; audits are idempotent reads, so re-running one must not
    # re-pay the builder
    cache: dict = field(default_factory=dict)

    def _build(self, device):
        dev = _resolve(device)
        key = ("build", str(dev))
        if key not in self.cache:
            out = self.build(dev)
            fn, args, kwargs = out[:3]
            inputs = out[3] if len(out) > 3 else _numpy_leaves(args)
            self.cache[key] = ((fn, args, kwargs), tuple(inputs))
        return self.cache[key]

    def syncs_allowed(self, tier: str) -> int:
        if isinstance(self.allow_syncs, dict):
            return int(self.allow_syncs.get(tier, 0))
        return int(self.allow_syncs)

    def built(self, device=None):
        """``(fn, args, kwargs)`` on ``device`` (``cuda`` unless named),
        memoised."""
        return self._build(device)[0]

    def inputs(self, device=None) -> tuple:
        """The numpy arrays the builder made, in the reference builder's
        argument order, as they were before any call."""
        return self._build(device)[1]


REGISTRY: dict[str, KernelSpec] = {}


def register_kernel(
    name: str,
    *,
    allow_dtypes=None,
    allow_syncs: int | dict = 0,
    const_budget_bytes: int = DEFAULT_CONST_BUDGET,
    f64_fn: Callable | None = None,
):
    """Declare one kernel for auditing; the decorated builder takes the
    device and returns ``(fn, example_args, example_kwargs)``; it runs
    lazily."""

    def deco(build: Callable) -> Callable:
        if name in REGISTRY:
            raise ValueError(f"duplicate kernel name {name!r}")
        REGISTRY[name] = KernelSpec(
            name=name,
            build=build,
            allow_dtypes=(
                DEFAULT_ALLOWED_DTYPES
                if allow_dtypes is None
                else frozenset(allow_dtypes)
            ),
            allow_syncs=allow_syncs,
            const_budget_bytes=const_budget_bytes,
            f64_fn=f64_fn,
        )
        return build

    return deco


def _resolve(device):
    from .._device import resolve_device

    return resolve_device(device)


# ---------------------------------------------------------------------------
# Pytree helpers shared by the three measured layers
# ---------------------------------------------------------------------------


def leaves(x) -> list:
    """Array and number leaves of a nested structure of tuples (named
    tuples included), lists and dicts (by sorted key); None is skipped."""
    import numpy as np
    import torch

    if isinstance(x, (torch.Tensor, np.ndarray, np.generic, bool, int, float)):
        return [x]
    if isinstance(x, dict):
        return [v for k in sorted(x) for v in leaves(x[k])]
    if isinstance(x, (tuple, list)):
        return [v for e in x for v in leaves(e)]
    return []


def map_leaves(x, fn):
    """``x`` with each tensor and numpy leaf mapped through ``fn``; named
    tuples keep their type."""
    import numpy as np
    import torch

    if isinstance(x, (torch.Tensor, np.ndarray)):
        return fn(x)
    if isinstance(x, tuple):
        mapped = [map_leaves(e, fn) for e in x]
        return type(x)(*mapped) if hasattr(x, "_fields") else tuple(mapped)
    if isinstance(x, list):
        return [map_leaves(e, fn) for e in x]
    if isinstance(x, dict):
        return {k: map_leaves(v, fn) for k, v in x.items()}
    return x


def to_numpy(x):
    """One leaf as a numpy array (tensors copied to the host)."""
    import numpy as np
    import torch

    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def _numpy_leaves(args) -> list:
    return [to_numpy(a).copy() for a in leaves(args)]


def _on(device):
    """numpy array -> tensor on ``device`` (the builders' binding)."""
    import numpy as np
    import torch

    def up(a, dtype=None):
        a = np.array(a, copy=True, order="C")  # 0-d stays 0-d
        return torch.from_numpy(a).to(device=device, dtype=dtype)

    return up


# ---------------------------------------------------------------------------
# The recorder
# ---------------------------------------------------------------------------


def _describe(value):
    """A hashable, address-free description of one non-tensor argument."""
    import torch

    if isinstance(value, torch.Tensor):
        return "T"
    if isinstance(value, (list, tuple)):
        return tuple(_describe(v) for v in value)
    if isinstance(value, (bool, int, float, str, type(None))):
        return value
    return str(value)


class _Record:
    """What one call dispatched: the op sequence, the syncs among them and
    the tensors made from host data or uploaded from it."""

    def __init__(self):
        self.ops: list[tuple] = []
        self.syncs: list[str] = []
        self.sync_sites: list[str] = []  # "file:line" of the code that synced
        self.uploads: list[tuple] = []  # (op, shape, dtype, nbytes)
        self.dtypes: dict[str, set] = {}  # dtype name -> ops that made it
        self.observed_syncs: int | None = None  # set_sync_debug_mode's count
        self._host_born: dict = {}  # id -> weakref of tensors made from host data

    def host_born(self, t) -> bool:
        ref = self._host_born.get(id(t))
        return ref is not None and ref() is t

    def sync(self, op: str) -> None:
        self.syncs.append(op)
        self.sync_sites.append(_caller_site())

    def digest(self) -> str:
        text = repr(self.ops).encode()
        return hashlib.sha256(text).hexdigest()


def _caller_site() -> str:
    """``path:line`` of the innermost frame of the package outside this
    module (the line that made a sync)."""
    import os
    import traceback

    pkg = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    for frame in reversed(traceback.extract_stack()):
        path = os.path.abspath(frame.filename)
        if path.startswith(pkg) and not path.startswith(os.path.dirname(__file__)):
            return f"{os.path.relpath(path, os.path.dirname(pkg))}:{frame.lineno}"
    return "?"


def _recorder(record: _Record, on_card: bool):
    import torch
    from torch.utils._python_dispatch import TorchDispatchMode

    class Recorder(TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            kwargs = kwargs or {}
            out = func(*args, **kwargs)
            name = func.overloadpacket.__name__
            full = str(func)
            outs = [t for t in leaves(out) if isinstance(t, torch.Tensor)]
            record.ops.append((
                full,
                _describe(list(args)),
                _describe(kwargs.get("dtype")),
                tuple((_dtype_name(t.dtype), tuple(t.shape)) for t in outs),
            ))
            if name not in ("scalar_tensor", "_local_scalar_dense"):
                for t in outs:
                    record.dtypes.setdefault(_dtype_name(t.dtype), set()).add(full)
            src = next((a for a in args if isinstance(a, torch.Tensor)), None)
            crossing = (
                name in ("_to_copy", "copy_", "_copy_from")
                and src is not None
                and outs
                and _crosses(args, outs[0], name)
            )
            if name in SYNC_OPS:
                # a read of a host tensor (a Python number round-tripped
                # through torch.tensor) waits for nothing
                if src is not None and (src.device.type != "cpu" or not (
                        on_card or record.host_born(src))):
                    record.sync(full)
            elif crossing:
                record.sync(full)
                host_src = (args[1] if name == "copy_" else src).device.type == "cpu"
                if host_src:
                    t = outs[0]
                    record.uploads.append(
                        (full, tuple(t.shape), _dtype_name(t.dtype),
                         t.numel() * t.element_size()))
            if name == "lift_fresh":
                for t in outs:
                    record._host_born[id(t)] = weakref.ref(t)
                    record.uploads.append(
                        (full, tuple(t.shape), _dtype_name(t.dtype),
                         t.numel() * t.element_size()))
                    if t.device.type != "cpu":
                        record.sync(full)  # torch.tensor(..., device=card)
            return out

    return Recorder()


def _crosses(args, out, name) -> bool:
    """A copy between the host and a device (either way)."""
    if name == "copy_":
        dst, src = args[0], args[1]
        return dst.device.type != src.device.type
    return args[0].device.type != out.device.type


def _launch_counts() -> dict:
    from ..ops import strings_cuda

    return dict(strings_cuda.variant_launches)


def run_recorded(fn, args, kwargs, *, on_card: bool = False):
    """(output, record) of one call of ``fn`` under the recorder. With
    ``on_card`` (the kernel's device is a card: tensors on the host are
    then host data, never device values) the call also runs under
    ``torch.cuda.set_sync_debug_mode("warn")`` and the record carries the
    number of synchronising CUDA operations it reported."""
    import torch

    record = _Record()
    before = _launch_counts()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        if on_card:
            torch.cuda.set_sync_debug_mode("warn")
        try:
            with _recorder(record, on_card):
                out = fn(*args, **kwargs)
        finally:
            if on_card:
                torch.cuda.set_sync_debug_mode("default")
    if on_card:
        record.observed_syncs = sum(1 for w in caught if "synchroniz" in str(w.message))
        torch.cuda.synchronize()
    after = _launch_counts()
    for key in sorted(after):
        delta = after[key] - before.get(key, 0)
        if delta:
            record.ops.append(("strings_cuda." + key, (), None, ((str(delta), ()),)))
    return out, record


def sync_count(record: _Record) -> int:
    """The syncs one call made: the recorded ones, or on the card the
    sync-debug count where that is larger."""
    return max(len(record.syncs), record.observed_syncs or 0)


def audit_kernel(spec: KernelSpec, device=None) -> list[Finding]:
    """Run one registered kernel twice under the recorder and check the
    four invariants. The record of the first call is kept in
    ``spec.cache["record", device]``."""
    findings: list[Finding] = []

    def fail(check: str, message: str, hint: str = "") -> None:
        findings.append(
            Finding(rule=check, path=spec.name, line=0, message=message, hint=hint)
        )

    try:
        dev = _resolve(device)
        fn, args, kwargs = spec.built(dev)
        on_card = dev.type == "cuda"
        _, rec1 = run_recorded(fn, args, kwargs, on_card=on_card)
        _, rec2 = run_recorded(fn, args, kwargs, on_card=on_card)
    except Exception as e:  # noqa: BLE001 - any run failure is a finding
        fail("TA-ERROR", f"kernel failed to run: {type(e).__name__}: {e}")
        return findings
    spec.cache[("record", str(dev))] = rec1

    # (a) tensors made from host data inside the call
    for op, shape, dtype, nbytes in rec1.uploads:
        if nbytes > spec.const_budget_bytes:
            fail(
                "TA-CONST",
                f"{op} makes a {shape} {dtype} tensor ({nbytes} bytes) from host "
                f"data inside the call, past the {spec.const_budget_bytes}-byte "
                "budget",
                "keep the array resident on the device and pass it as an "
                "argument (it is uploaded on every call)",
            )

    # (b) dtype widths
    for name, ops in sorted(rec1.dtypes.items()):
        if name not in spec.allow_dtypes:
            shown = ", ".join(sorted(ops)[:6])
            fail(
                "TA-DTYPE",
                f"dtype {name} appears in the recorded ops ({shown}) but is not "
                f"in the kernel's allowed set {sorted(spec.allow_dtypes)}",
                "pin the constructor/accumulator dtype or allowlist it for "
                "this kernel with the reason",
            )

    # (c) host syncs against the declared allowance
    n_sync = sync_count(rec1)
    allowed = spec.syncs_allowed(dev.type)
    if n_sync > allowed:
        seen = ", ".join(sorted(set(rec1.syncs))[:6]) or "none recorded"
        observed = (
            f"; set_sync_debug_mode reported {rec1.observed_syncs}"
            if rec1.observed_syncs is not None
            else ""
        )
        fail(
            "TA-CALLBACK",
            f"{n_sync} host synchronisation(s) in one call, {allowed} "
            f"declared on {dev.type} (recorded: {len(rec1.syncs)}: {seen}{observed})",
            "declare them in the kernel's allow_syncs, or remove the host "
            "round-trip",
        )

    # (d) determinism of the op sequence
    h1, h2 = rec1.digest(), rec2.digest()
    if h1 != h2:
        fail(
            "TA-HASH",
            f"two calls recorded different op sequences ({h1[:12]} vs {h2[:12]}; "
            f"{len(rec1.ops)} vs {len(rec2.ops)} ops)",
            "remove call-to-call nondeterminism (unordered dict/set "
            "iteration, state cached by the first call) from the kernel",
        )
    return findings


def run_audit(names=None, device=None) -> tuple[list[Finding], int]:
    """Audit the given kernels (default: all) on ``device`` (``cuda``
    unless named). Returns (findings, count)."""
    _ensure_default_registry()
    if names:
        unknown = [n for n in names if n not in REGISTRY]
        if unknown:
            raise KeyError(f"unknown kernel(s): {', '.join(unknown)}")
        specs = [REGISTRY[n] for n in names]
    else:
        specs = [REGISTRY[n] for n in sorted(REGISTRY)]
    dev = _resolve(device)
    findings: list[Finding] = []
    for spec in specs:
        findings.extend(audit_kernel(spec, dev))
    return findings, len(specs)


# ---------------------------------------------------------------------------
# Shared example-input builders, memoised per device (the reference's seeds,
# shapes and values)
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def shared_fs_arrays():
    """The numpy (G, lam, m, u) of the EM-family kernels."""
    import numpy as np

    rng = np.random.default_rng(0)
    G = rng.integers(-1, 3, size=(128, 3)).astype(np.int8)
    lam = np.float32(0.3)
    m = np.full((3, 3), 1.0 / 3, np.float32)
    u = np.full((3, 3), 1.0 / 3, np.float32)
    return G, lam, m, u


@functools.lru_cache(maxsize=None)
def shared_fs_inputs(device: str):
    """(G, params) example inputs for the EM-family kernels on ``device``."""
    import numpy as np
    import torch

    from ..models.fellegi_sunter import FSParams

    G, lam, m, u = shared_fs_arrays()
    up = _on(torch.device(device))
    params = FSParams(lam=up(np.asarray(lam)), m=up(m), u=up(u))
    return up(G), params


@functools.lru_cache(maxsize=None)
def shared_gamma_program(device: str):
    """One GammaProgram for the gamma-family specs on ``device`` (builders
    use it read-only)."""
    import pandas as pd
    import torch

    from ..data import encode_table
    from ..gammas import GammaProgram
    from ..settings import complete_settings_dict

    df = pd.DataFrame(
        {
            "unique_id": range(6),
            "name": ["martha", "marhta", "mx", None, "anna", "bob"],
            "city": ["x", "y", "x", "y", None, "x"],
            "amount": [1.0, 1.01, 5.0, None, 2.0, 3.0],
        }
    )
    settings = complete_settings_dict(
        {
            "link_type": "dedupe_only",
            "comparison_columns": [
                {"col_name": "name", "num_levels": 3},
                {
                    "col_name": "city",
                    "num_levels": 2,
                    "comparison": {"kind": "exact"},
                },
                {
                    "col_name": "amount",
                    "data_type": "numeric",
                    "num_levels": 3,
                    "comparison": {
                        "kind": "numeric_perc",
                        "thresholds": [0.01, 0.2],
                    },
                },
            ],
            "blocking_rules": ["l.unique_id = r.unique_id"],
        }
    )
    table = encode_table(df, settings)
    return GammaProgram(settings, table, float_dtype=torch.float32,
                        device=torch.device(device))


def _packed_u32(program):
    """The program's packed table as the reference's uint32 view."""
    import numpy as np

    return program._packed.cpu().numpy().view(np.uint32)


# ---------------------------------------------------------------------------
# Default registry: the pipeline's hot kernels, the reference's 29 names
# ---------------------------------------------------------------------------


_defaults_registered = False


def _ensure_default_registry() -> None:
    global _defaults_registered
    if _defaults_registered:
        return
    _defaults_registered = True

    import numpy as np

    imax = np.int32(np.iinfo(np.int32).max)

    def fs(device):
        return shared_fs_inputs(str(device))

    def gp(device):
        return shared_gamma_program(str(device))

    def tol():
        # the reference's float32 tolerance, as the Python float the port's
        # EM takes (a 0-d tensor would be read back on every update)
        return float(np.float32(1e-4))

    # Each builder makes the reference builder's numpy arrays (same seeds,
    # shapes and values) and binds them to the port's counterpart.

    # EM uploads its tolerance, reads one convergence flag per update and
    # copies its four histories to the host once, at the end
    @register_kernel("em_step", allow_syncs={"cpu": 2, "cuda": 7})
    def _build_em_step(device):
        from ..em import run_em

        G, params = fs(device)
        fn = lambda G, p, tol: run_em(  # noqa: E731
            G, p, max_iterations=4, max_levels=3, em_convergence=tol,
            compute_ll=True,
        )
        return fn, (G, params, tol()), {}

    # the checkpoint path: run_em's loop with the per-update host hook (the
    # numerics guard and the host histories read lam, m, u and the log
    # likelihood every update)
    @register_kernel("em_step_checkpointed", allow_syncs={"cpu": 4, "cuda": 18})
    def _build_em_step_hooked(device):
        from ..em import run_em_checkpointed

        G, params = fs(device)
        fn = lambda G, p, tol: run_em_checkpointed(  # noqa: E731
            G, p, max_iterations=4, max_levels=3, em_convergence=tol,
            compute_ll=True, on_segment=lambda *a: None,
        )
        return fn, (G, params, tol()), {}

    # telemetry-enabled EM: the same loop with the em_update hook
    # (em._with_telemetry), compute_ll off as in the reference's spec
    @register_kernel("em_step_telemetry", allow_syncs={"cpu": 2, "cuda": 13})
    def _build_em_step_telemetry(device):
        from ..em import run_em
        from ..obs.runtime import RunContext

        G, params = fs(device)
        ctx = RunContext(run_id="trace_audit", memory_snapshots=False)
        fn = lambda G, p, tol: run_em(  # noqa: E731
            G, p, max_iterations=4, max_levels=3, em_convergence=tol,
            compute_ll=False, telemetry=ctx,
        )
        return fn, (G, params, tol()), {}

    @register_kernel("streamed_pass")
    def _build_streamed_pass(device):
        from ..parallel.streaming import _batch_stats

        G, params = fs(device)
        fn = lambda G, p: _batch_stats(G, p, 3, None, True)  # noqa: E731
        return fn, (G, params), {}

    @register_kernel("score_pairs")
    def _build_score_pairs(device):
        from ..em import score_pairs

        G, params = fs(device)
        return score_pairs, (G, params), {}

    # The gamma program keeps its packed table resident on the device (an
    # attribute, uploaded once), so the table is not an argument here; the
    # reference passes it explicitly to keep it out of the compile request.
    # int64: torch's index dtype (gathers of the packed rows) and the plain
    # Jaro-Winkler's character codes. The CPU compacts the Jaro-Winkler
    # survivors (nonzero); the card runs one masked launch instead, but
    # uploads 7 scalars made from Python numbers per call (the JW bound's
    # four, the two-phase thresholds, the numeric comparison's: each waits
    # for the stream)
    _gamma_dtypes = DEFAULT_ALLOWED_DTYPES | {"int64"}

    @register_kernel("gamma_batch", allow_dtypes=_gamma_dtypes,
                     allow_syncs={"cpu": 1, "cuda": 7})
    def _build_gamma_batch(device):
        program = gp(device)
        up = _on(device)
        il = np.zeros(256, np.int32)
        ir = np.ones(256, np.int32)
        return (program.gamma_batch, (up(il), up(ir)), {},
                (_packed_u32(program), il, ir))

    # PatternStream's batch: gammas -> pattern ids, narrowed on the device,
    # and their int64 histogram added to ``acc`` with the positions at or
    # past ``valid`` counted in the sentinel bin (the ids themselves are
    # returned unmasked, as the reference's are). torch.bincount reads its
    # max back.
    @register_kernel("pattern_kernel", allow_dtypes=_gamma_dtypes,
                     allow_syncs={"cpu": 2, "cuda": 9})
    def _build_pattern_kernel(device):
        import torch

        from ..gammas import pattern_histogram

        program = gp(device)
        up = _on(device)
        il = np.zeros(256, np.int32)
        ir = np.ones(256, np.int32)
        acc = np.zeros(program.n_patterns + 1, np.int32)
        valid = np.int32(200)

        def fn(il, ir, valid, acc):
            pid = program.pattern_ids(program.gamma_batch(il, ir))
            pos = torch.arange(pid.shape[0], dtype=torch.int64, device=pid.device)
            counted = torch.where(pos >= valid, program.n_patterns, pid)
            return (program.narrow_ids(pid),
                    acc + pattern_histogram(counted, program.n_patterns + 1))

        return (fn, (up(il), up(ir), int(valid), up(acc, torch.int64)), {},
                (_packed_u32(program), il, ir, valid, acc))

    # the virtual pair index: rule-relative int64 positions decode through
    # the plan's cumulative pair table (float64 square root, int64 floor
    # division: the port's deliberate decode widths)
    @register_kernel("virtual_pattern_kernel", allow_dtypes=_gamma_dtypes | {"float64"},
                     allow_syncs={"cpu": 2, "cuda": 9})
    def _build_virtual_pattern(device):
        import torch

        from ..gammas import pattern_histogram
        from ..pairgen import RulePlan, VirtualPlan, make_virtual_pattern_fn

        program = gp(device)
        bs = 128
        pos = np.arange(bs, dtype=np.int32)
        order = np.arange(6, dtype=np.int32)
        units = np.zeros(4, np.int32)
        lens = np.full(4, 3, np.int32)
        meta = np.array([0, bs, 0, imax, imax, imax], np.int32)
        acc = np.zeros(program.n_patterns + 2, np.int32)
        prev_codes = np.zeros((1, 6), np.int32)
        uid_codes = np.zeros(6, np.int32)
        # The reference's meta row marks one unit live for the whole batch;
        # the port's plan carries the four units' true pair counts (each a
        # triangle of 3 rows: 3 pairs) and runs exactly those positions.
        per_unit = lens * (lens - 1) // 2
        pc = np.concatenate([[0], np.cumsum(per_unit)]).astype(np.int64)
        plan = VirtualPlan(
            rules=[RulePlan(order=order, ua=units, la=lens, ub=units, lb=lens, pc=pc)],
            codes=prev_codes, uid_codes=None, n_candidates=int(pc[-1]),
        )
        vfn = make_virtual_pattern_fn(program, plan, 0)

        def fn(q, acc):
            pid = vfn(q)
            return (program.narrow_ids(pid),
                    acc + pattern_histogram(pid, program.n_patterns + 1))

        q = torch.arange(int(pc[-1]), dtype=torch.int64, device=device)
        return (fn, (q, _on(device)(acc[: program.n_patterns + 1], torch.int64)), {},
                (pos, _packed_u32(program), order, units, lens, units, lens,
                 prev_codes, uid_codes, meta, acc))

    def _jw_f64(s1, s2, l1, l2, prefix_scale, boost_threshold):
        import torch

        from ..ops.strings import jaro_winkler_plain

        return jaro_winkler_plain(s1, s2, l1, l2, prefix_scale, boost_threshold,
                                  dtype=torch.float64)

    def _lev_f64(s1, s2, l1, l2):
        import torch

        from ..ops.strings import levenshtein_plain, ratio_from_distance

        return ratio_from_distance(levenshtein_plain(s1, s2, l1, l2), l1, l2,
                                   dtype=torch.float64)

    def _strings(device):
        rng = np.random.default_rng(0)
        s = rng.integers(97, 123, size=(64, 24)).astype(np.uint8)
        ln = np.full(64, 8, np.int32)
        up = _on(device)
        return s, ln, up(s), up(ln)

    # the hand kernel on the card (ops/strings_cuda.py), the plain version
    # on the CPU; the plain version also takes the CPU's int64 codes
    @register_kernel("jaro_winkler", allow_dtypes=DEFAULT_ALLOWED_DTYPES | {"int64"},
                     f64_fn=_jw_f64)
    def _build_jw(device):
        from ..ops import strings

        s, ln, s_t, ln_t = _strings(device)
        ps, bt = np.float32(0.1), np.float32(0.7)
        return (strings.jaro_winkler, (s_t, s_t, ln_t, ln_t, float(ps), float(bt)), {},
                (s, s, ln, ln, ps, bt))

    @register_kernel("levenshtein", allow_dtypes=DEFAULT_ALLOWED_DTYPES | {"int64"},
                     f64_fn=_lev_f64)
    def _build_lev(device):
        from ..ops import strings

        s, ln, s_t, ln_t = _strings(device)
        return strings.levenshtein_ratio, (s_t, s_t, ln_t, ln_t), {}

    # the device TF aggregation sums in float64 (index_add_ is atomic on the
    # card, and float64 keeps its sums exact to the host's), int64 indices
    _tf_dtypes = DEFAULT_ALLOWED_DTYPES | {"int64", "float64"}

    @register_kernel("tf_adjustment", allow_dtypes=_tf_dtypes)
    def _build_tf(device):
        import torch

        from ..term_frequencies import token_stats

        n_seg = 256
        tid = np.zeros(512, np.int32)
        p = np.zeros(512, np.float32)
        sums = np.zeros(n_seg, np.float32)
        counts = np.zeros(n_seg, np.float32)
        up = _on(device)
        f64 = torch.float64
        fn = lambda tl, tr, p, s, c: token_stats(tl, tr, p, s.clone(), c.clone())  # noqa: E731
        return (fn, (up(tid), up(tid), up(p, f64), up(sums, f64), up(counts, f64)), {},
                (tid, tid, p, sums, counts))

    @register_kernel("tf_gather", allow_dtypes=_tf_dtypes)
    def _build_tf_gather(device):
        import torch

        from ..term_frequencies import token_gather

        n_seg = 256
        tid = np.zeros(512, np.int32)
        adjusted = np.zeros(n_seg, np.float32)
        up = _on(device)
        return (token_gather, (up(tid), up(tid), up(adjusted, torch.float64)), {},
                (tid, tid, adjusted))

    # ----- online serving (serve/engine.py) -----
    # Packed rows are the port's int32 view of the reference's uint32 words.
    # int64: candidate slots, gathers and the top-k's indices. On the card
    # the scoring paths upload 4 scalars a call (the top-k's two constants,
    # the invalid slots' -1, the numeric comparison's), the sketch 1.
    _serve_dtypes = DEFAULT_ALLOWED_DTYPES | {"int64"}
    _score_syncs = {"cpu": 0, "cuda": 4}

    def _packed_q(program, n):
        return np.zeros((n, program._packed.shape[1]), np.uint32)

    def _i32(a):
        return a.view(np.int32)

    @register_kernel("serve_encode_query")
    def _build_serve_encode(device):
        from ..serve.engine import encode_query

        packed = np.zeros((32, 8), np.uint32)
        qb = np.zeros((2, 32), np.int32)
        up = _on(device)
        return (encode_query, (up(_i32(packed)), up(qb), 20), {},
                (packed, qb, np.int32(20)))

    @register_kernel("serve_candidate_gather", allow_dtypes=_serve_dtypes)
    def _build_serve_gather(device):
        from ..serve.engine import candidate_gather

        up = _on(device)
        qb = np.zeros((2, 32), np.int32)
        starts = tuple(np.zeros(4, np.int32) for _ in range(2))
        sizes = tuple(np.ones(4, np.int32) for _ in range(2))
        rows = tuple(np.zeros(8, np.int32) for _ in range(2))
        row_bucket = tuple(np.zeros(6, np.int32) for _ in range(2))
        fn = lambda qb, st, sz, rw, rb: candidate_gather(qb, st, sz, rw, rb, 16)  # noqa: E731
        t = lambda arrs: tuple(up(a) for a in arrs)  # noqa: E731
        return fn, (up(qb), t(starts), t(sizes), t(rows), t(row_bucket)), {}

    def _score(device, fused: bool, k: int, cap: int):
        from ..serve.engine import score_fused, score_topk

        program = gp(device)
        _, params = fs(device)
        score = score_fused if fused else score_topk
        cols = program.settings["comparison_columns"]
        fn = lambda pq, pr, c, v, p: score(program._layout, cols, k, pq, pr, c, v, p)  # noqa: E731
        packed_q = _packed_q(program, 16)
        cand = np.zeros((16, cap), np.int32)
        valid = np.zeros((16, cap), bool)
        up = _on(device)
        return (fn, (up(_i32(packed_q)), program._packed, up(cand), up(valid), params), {},
                (packed_q, _packed_u32(program), cand, valid, *shared_fs_arrays()[1:]))

    @register_kernel("serve_score_topk", allow_dtypes=_serve_dtypes, allow_syncs=_score_syncs)
    def _build_serve_score(device):
        return _score(device, False, 4, 8)

    # the fused gamma -> score -> top-k path (the engine default)
    @register_kernel("serve_score_fused", allow_dtypes=_serve_dtypes, allow_syncs=_score_syncs)
    def _build_serve_score_fused(device):
        return _score(device, True, 4, 8)

    # the TF-fold variant of the fused path (serve_tf_adjust)
    @register_kernel("serve_score_fused_tf", allow_dtypes=_serve_dtypes,
                     allow_syncs=_score_syncs)
    def _build_serve_score_fused_tf(device):
        from ..serve.engine import score_fused

        program = gp(device)
        _, params = fs(device)
        cols = program.settings["comparison_columns"]
        # fold the exact "city" comparison (index 1, 2 levels -> top 1)
        spec = ((1, "city", 1),)

        def fn(pq, pr, c, v, p, tf_q, tf_tid, tf_log):
            return score_fused(program._layout, cols, 4, pq, pr, c, v, p,
                               spec, tf_q, tf_tid, tf_log)

        packed_q = _packed_q(program, 16)
        cand = np.zeros((16, 8), np.int32)
        valid = np.zeros((16, 8), bool)
        n_ref = program._packed.shape[0]
        tf_q = np.zeros(16, np.int32)
        tf_tid = np.zeros(n_ref, np.int32)
        tf_log = np.full(4, -1.0, np.float32)
        up = _on(device)
        return (fn, (up(_i32(packed_q)), program._packed, up(cand), up(valid), params,
                     (up(tf_q),), (up(tf_tid),), (up(tf_log),)), {},
                (packed_q, _packed_u32(program), cand, valid, *shared_fs_arrays()[1:],
                 tf_q, tf_tid, tf_log))

    # ----- device-native blocking (blocking_device.py) -----
    # The port's plan builders take host arrays and return host arrays: the
    # sort key is int64 (key << 32 | side << 31 | rank), the segments are
    # found with nonzero, and on the card every upload and read-back syncs.
    _block_dtypes = DEFAULT_ALLOWED_DTYPES | {"int64"}

    @register_kernel("block_segment_sort", allow_dtypes=_block_dtypes,
                     allow_syncs={"cpu": 1, "cuda": 9})
    def _build_block_segment_sort(device):
        from ..blocking_device import segment_sort

        rng = np.random.default_rng(0)
        codes = rng.integers(-1, 5, size=32).astype(np.int32)
        side = (np.arange(32) % 2).astype(np.int32)
        rank = np.arange(32, dtype=np.int32)
        row = np.arange(32, dtype=np.int32)
        fn = lambda c, s, r, w: segment_sort(c, s, r, w, device)  # noqa: E731
        return fn, (codes, side, rank, row), {}

    @register_kernel("block_bucket_csr", allow_dtypes=_block_dtypes,
                     allow_syncs={"cpu": 1, "cuda": 6})
    def _build_block_bucket_csr(device):
        from ..blocking_device import build_bucket_csr

        rng = np.random.default_rng(0)
        codes = rng.integers(-1, 5, size=32).astype(np.int32)
        return (lambda c: build_bucket_csr(c, device)), (codes,), {}

    # one emission chunk of rule 1 of a two-rule plan: rank orientation,
    # duplicate uids and rule 0's key equality all mask, as in the
    # reference's spec; the card compacts on the device, the CPU on the host
    # (and reads the digest there); float64: the triangle decode's root
    @register_kernel("block_pair_emit", allow_dtypes=_block_dtypes | {"float64"},
                     allow_syncs={"cpu": 1, "cuda": 0})
    def _build_block_pair_emit(device):
        import torch

        from ..blocking_device import (
            DeviceBlockPlan,
            DeviceRule,
            _emission_context,
            _emit_chunk,
        )

        bs = 64
        pos = np.arange(bs, dtype=np.int32)
        order = np.arange(8, dtype=np.int32)
        units = np.zeros(4, np.int32)
        lens = np.full(4, 3, np.int32)
        ranks = np.arange(8, dtype=np.int32)
        prev_l = np.zeros((1, 8), np.int32)
        prev_r = np.zeros((1, 8), np.int32)
        uid = np.zeros(8, np.int32)
        meta = np.array([0, bs, 0, imax, imax, imax], np.int32)
        per_unit = lens * (lens - 1) // 2
        pc = np.concatenate([[0], np.cumsum(per_unit)]).astype(np.int64)
        prev_rule = DeviceRule("l.k = r.k", order, units, lens, units, lens, pc, True)
        rule = DeviceRule("l.k2 = r.k2", order, units, lens, units, lens, pc, True)
        plan = DeviceBlockPlan(
            rules=[prev_rule, rule],
            codes_l=np.concatenate([prev_l, prev_l]),
            codes_r=np.concatenate([prev_r, prev_r]),
            ranks=ranks, uid_codes=uid, device=device,
        )
        ctx = _emission_context(plan, bs)
        # the state the first emission of a run sets up (the plan's device
        # arrays, the compaction's lane positions), so both audited calls
        # record the steady-state chunk
        plan.on_device()
        ctx["pos"][bs] = torch.arange(bs, dtype=torch.int64, device=device)
        total = int(pc[-1])
        fn = lambda: _emit_chunk(plan, 1, ctx, bs, 0, total, True)  # noqa: E731
        return (fn, (), {},
                (pos, order, units, lens, units, lens, ranks, prev_l, prev_r, uid, meta))

    @register_kernel("spill_chunk_digest", allow_dtypes=_block_dtypes)
    def _build_spill_chunk_digest(device):
        from ..blocking_device import chunk_digest

        rng = np.random.default_rng(0)
        i = rng.integers(0, 64, size=64).astype(np.int32)
        j = rng.integers(0, 64, size=64).astype(np.int32)
        keep = rng.integers(0, 2, size=64).astype(bool)
        up = _on(device)
        return chunk_digest, (up(i), up(j), up(keep)), {}

    @register_kernel("spill_chunk_digest_compact", allow_dtypes=_block_dtypes)
    def _build_spill_chunk_digest_compact(device):
        from ..blocking_device import chunk_digest_compact

        rng = np.random.default_rng(0)
        i_ext = np.concatenate([rng.integers(0, 64, size=64), [37]]).astype(np.int32)
        j = rng.integers(0, 64, size=64).astype(np.int32)
        pos = np.arange(64, dtype=np.int32)
        up = _on(device)
        return chunk_digest_compact, (up(i_ext), up(j), up(pos)), {}

    # ----- approximate blocking (approx/) -----
    # The port computes hashes as int64 tensor ops masked to 32 bits
    # (torch has no uint32 arithmetic), the race's log in float64 rounded
    # once to float32; the salts stay host integers. On the card the
    # signature uploads its no-signature constant and band salts (and the
    # weighted race its infinity), the verifier its 1/n_cols (and the
    # unweighted q-gram Jaccard one constant more).
    _approx_dtypes = DEFAULT_ALLOWED_DTYPES | {"int64"}

    def _minhash(device, weighted: bool):
        import torch

        from ..approx.minhash import (
            DF_TABLE_SIZE,
            band_keys,
            column_salts,
            hash_params,
            minhash_signatures,
        )

        rng = np.random.default_rng(0)
        bytes_ = rng.integers(97, 123, size=(16, 12)).astype(np.uint8)
        lens = np.full(16, 8, np.int32)
        a, b = hash_params(8)
        salts = column_salts(1)
        up = _on(device)
        i64 = torch.int64

        def fn(chars, lens, a, b, salts, idf=None):
            sig, has = minhash_signatures([chars], [lens], 2, a, b, salts, idf)
            return band_keys(sig, 4, 2), has

        args = [up(bytes_), up(lens), up(a.astype(np.int64), i64),
                up(b.astype(np.int64), i64), salts]
        inputs = [bytes_, lens, a, b, salts]
        if weighted:
            idf = np.ones(DF_TABLE_SIZE, np.float32)
            args.append(up(idf))
            inputs.append(idf)
        return fn, tuple(args), {}, tuple(inputs)

    @register_kernel("approx_minhash", allow_dtypes=_approx_dtypes,
                     allow_syncs={"cpu": 0, "cuda": 3})
    def _build_approx_minhash(device):
        return _minhash(device, False)

    # the TF-weighted sampler (approx_tf_weighting): one IDF gather a gram
    @register_kernel("approx_minhash_weighted", allow_dtypes=_approx_dtypes | {"float64"},
                     allow_syncs={"cpu": 0, "cuda": 3})
    def _build_approx_minhash_weighted(device):
        return _minhash(device, True)

    def _verify(device, weighted: bool):
        from ..approx.lsh import verify_pairs
        from ..approx.minhash import DF_TABLE_SIZE

        rng = np.random.default_rng(0)
        i = np.zeros(32, np.int32)
        j = np.ones(32, np.int32)
        band_codes = rng.integers(-1, 4, size=(4, 16)).astype(np.int32)
        bytes_ = rng.integers(97, 123, size=(16, 12)).astype(np.uint8)
        lens = np.full(16, 8, np.int32)
        mask = np.zeros((16, 1), np.uint32)
        count = np.full(16, 7, np.int32)
        up = _on(device)

        def fn(i, j, band_codes, chars, lens, mask, count, idf=None):
            return verify_pairs(i, j, band_codes, [(chars, lens, mask, count)], 2, True, idf)

        args = [up(i), up(j), up(band_codes), up(bytes_), up(lens), up(_i32(mask)), up(count)]
        inputs = [i, j, band_codes, bytes_, lens, mask, count]
        if weighted:
            idf = np.ones(DF_TABLE_SIZE, np.float32)
            args.append(up(idf))
            inputs.append(idf)
        return fn, tuple(args), {}, tuple(inputs)

    @register_kernel("approx_verify", allow_dtypes=_approx_dtypes,
                     allow_syncs={"cpu": 0, "cuda": 2})
    def _build_approx_verify(device):
        return _verify(device, False)

    # the TF-weighted Jaccard (approx_tf_weighting + threshold)
    @register_kernel("approx_verify_weighted", allow_dtypes=_approx_dtypes,
                     allow_syncs={"cpu": 0, "cuda": 1})
    def _build_approx_verify_weighted(device):
        return _verify(device, True)

    # the brown-out tier's budgeted twin (engine kind="brownout"): top 1
    # over a 4-slot candidate capacity
    @register_kernel("serve_score_topk_brownout", allow_dtypes=_serve_dtypes,
                     allow_syncs=_score_syncs)
    def _build_serve_score_brownout(device):
        return _score(device, False, 1, 4)

    # ----- linkage quality observatory (obs/quality.py, obs/drift.py) -----
    # Both count with quality.sentinel_histogram (torch.histc over an int64
    # index vector: no read back, which torch.bincount would need).
    @register_kernel("quality_profile", allow_dtypes=DEFAULT_ALLOWED_DTYPES | {"int64"})
    def _build_quality_profile(device):
        from ..obs.quality import make_profile_fn

        G, params = fs(device)
        return make_profile_fn((3, 3, 3), bins=8), (G, params), {}

    @register_kernel("serve_drift_sketch", allow_dtypes=_serve_dtypes,
                     allow_syncs={"cpu": 0, "cuda": 1})
    def _build_serve_drift_sketch(device):
        import torch

        from ..obs.drift import make_sketch_fn

        program = gp(device)
        cols = program.settings["comparison_columns"]
        bins = 8
        width = max(int(c["num_levels"]) for c in cols) + 1
        size = len(cols) * width + 2 * bins
        fn = make_sketch_fn(program._layout, cols, bins)
        acc = np.zeros(size, np.int32)
        packed_q = _packed_q(program, 16)
        top_rows = np.zeros((16, 4), np.int32)
        top_valid = np.zeros((16, 4), bool)
        top_p = np.zeros((16, 4), np.float32)
        up = _on(device)
        return (fn, (up(acc, torch.int64), up(_i32(packed_q)), program._packed,
                     up(top_rows), up(top_valid), up(top_p)), {},
                (acc, packed_q, _packed_u32(program), top_rows, top_valid, top_p))
