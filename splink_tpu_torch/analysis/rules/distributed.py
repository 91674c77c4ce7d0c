"""JL009-JL012: multi-process hazards the AST can see.

The port of splink_tpu/analysis/rules/distributed.py, over the port's
``torch.distributed`` code (``parallel/distributed.py``, the linker's
multi-process paths). Every process runs the same Python program, and the
collectives only work because every process reaches them in the same
order with the same shapes:

  JL009 — rank-dependent branching (``dist.get_rank()``,
          ``process_index()``) that reaches a collective (``dist.*``,
          ``all_sum_stats``, the resume checks) or a checkpoint write. A
          branch that diverges per process either deadlocks (some ranks
          enter the collective, some don't) or corrupts persisted state.
          The sanctioned single-writer checkpoint suppresses with its
          justification.
  JL010 — a generator or seed taken per host: a ``torch.Generator`` /
          ``torch.manual_seed`` / numpy RNG seeded from the rank, the pid
          or the clock alone gives every process an unrelated stream with
          no reproducibility story; fold the rank into the SHARED run seed
          (``seed + rank``, ``default_rng([seed, rank])``), which the rule
          recognises by the seed expression naming another value.
  JL011 — a scalar host sync (``float()`` / ``int()`` / ``.item()`` /
          ``.tolist()``) inside a host loop that also dispatches device
          work: one stall per iteration. The streamed EM keeps per-batch
          values on the card and reduces once per pass for this reason.
  JL012 — a mesh-axis string literal (``Mesh(devices, "data")``,
          ``axis_name="data"``) that bypasses ``parallel.mesh.DATA_AXIS``.
"""

from __future__ import annotations

import ast

from ..torchlint import _bound_names
from . import rule

# the port's own collective wrappers (every process must call them)
_COLLECTIVE_TAILS = {
    "all_sum_stats",
    "validate_resume_presence",
    "validate_resume_topology",
}
_CKPT_TAILS = {"save_checkpoint"}

_PROCESS_ID_TAILS = {"get_rank", "process_index", "get_node_local_rank"}

_RNG_CTORS = {
    "torch.manual_seed",
    "torch.cuda.manual_seed",
    "torch.cuda.manual_seed_all",
    "numpy.random.default_rng",
    "numpy.random.seed",
    "numpy.random.RandomState",
    "random.seed",
    "random.Random",
}
_PER_HOST_SEEDS = {
    "os.getpid",
    "time.time",
    "time.time_ns",
    "time.perf_counter",
    "uuid.uuid4",
    "uuid.uuid1",
}

_SYNC_BUILTINS = ("float", "int", "bool")
_SYNC_METHODS = ("item", "tolist")


def _tail(canon: str | None) -> str:
    return canon.rsplit(".", 1)[-1] if canon else ""


def _is_process_id(mod, call: ast.Call) -> bool:
    return _tail(mod.canonical(call.func)) in _PROCESS_ID_TAILS


def _mentions_process_id(mod, node: ast.expr) -> bool:
    return any(isinstance(n, ast.Call) and _is_process_id(mod, n) for n in ast.walk(node))


def _mentions_any_call(mod, node: ast.expr, canons: set) -> bool:
    return any(isinstance(n, ast.Call) and mod.canonical(n.func) in canons
               for n in ast.walk(node))


def _mentions_name(node: ast.expr, names: set) -> bool:
    return any(isinstance(n, ast.Name) and n.id in names for n in ast.walk(node))


class _DerivedNames:
    """Per-scope rank-derived name tracking.

    A name counts as rank-derived at a use site only when it was assigned
    from a rank-involving expression in the SAME function or one of its
    lexical ancestors (closures still resolve, an unrelated function
    reusing the name does not). Resolution runs to a fixpoint so
    ``is_writer = process_index() == 0; lead = is_writer and ...`` marks
    both names."""

    def __init__(self, mod):
        self.mod = mod
        self._assigns: dict = {}
        for node in ast.walk(mod.tree):
            if isinstance(node, (ast.Assign, ast.AugAssign, ast.AnnAssign)):
                self._assigns.setdefault(mod.enclosing_fn(node), []).append(node)
        self._cache: dict = {}

    def _chain(self, node: ast.AST) -> tuple:
        chain = []
        fn = self.mod.enclosing_fn(node)
        while fn is not None:
            chain.append(fn)
            fn = self.mod.enclosing_fn(fn)
        return (None, *reversed(chain))

    def at(self, node: ast.AST) -> set:
        """The derived-name set visible at ``node``."""
        chain = self._chain(node)
        if chain in self._cache:
            return self._cache[chain]
        stmts = [s for scope in chain for s in self._assigns.get(scope, [])]
        derived: set = set()
        for _ in range(8):
            added = False
            for stmt in stmts:
                value = stmt.value
                if value is None:
                    continue
                if not (_mentions_process_id(self.mod, value) or _mentions_name(value, derived)):
                    continue
                targets = stmt.targets if isinstance(stmt, ast.Assign) else [stmt.target]
                for t in targets:
                    for name in _bound_names(t):
                        if name not in derived:
                            derived.add(name)
                            added = True
            if not added:
                break
        self._cache[chain] = derived
        return derived


def _folds_shared(expr: ast.expr, per_host: set) -> bool:
    """Whether a seed expression names a value besides its per-host ones
    (the shared run seed it folds the rank into); callees do not count."""
    callee_names = set()
    for n in ast.walk(expr):
        if isinstance(n, ast.Call):
            callee_names |= {id(m) for m in ast.walk(n.func)}
    return any(isinstance(n, ast.Name) and id(n) not in callee_names and n.id not in per_host
               for n in ast.walk(expr))


def _stmt_block_after(mod, stmt: ast.stmt) -> list:
    """The statements following ``stmt`` in its enclosing block."""
    parent = mod.parents.get(stmt)
    if parent is None:
        return []
    for attr in ("body", "orelse", "finalbody"):
        block = getattr(parent, attr, None)
        if isinstance(block, list) and stmt in block:
            return block[block.index(stmt) + 1:]
    return []


def _exits_block(body: list) -> bool:
    return any(isinstance(s, (ast.Return, ast.Raise, ast.Continue, ast.Break)) for s in body)


@rule(
    "JL009",
    "rank-divergent reach of a collective or checkpoint write",
    "per-process branches around collectives deadlock; around writes, corrupt",
)
def check_process_divergence(mod):
    derived = _DerivedNames(mod)

    def divergent_test(node: ast.If) -> bool:
        return _mentions_process_id(mod, node.test) or _mentions_name(node.test, derived.at(node))

    def hazardous_calls(nodes):
        for stmt in nodes:
            for n in ast.walk(stmt):
                if not isinstance(n, ast.Call):
                    continue
                canon = mod.canonical(n.func) or ""
                tail = _tail(canon)
                if canon.startswith("torch.distributed.") and tail not in (
                        "get_rank", "get_world_size", "is_initialized", "is_available",
                        "get_backend"):
                    yield n, "collective"
                elif tail in _COLLECTIVE_TAILS:
                    yield n, "collective"
                elif tail in _CKPT_TAILS:
                    yield n, "checkpoint write"

    for node in ast.walk(mod.tree):
        if not isinstance(node, ast.If) or not divergent_test(node):
            continue
        # (a) the hazard sits inside the divergent branch
        reached = list(node.body) + list(node.orelse)
        # (b) guard-return form: `if not is_writer: return` diverges every
        # statement AFTER the if
        if _exits_block(node.body):
            reached += _stmt_block_after(mod, node)
        for call, kind in hazardous_calls(reached):
            tail = _tail(mod.canonical(call.func))
            yield mod.finding(
                "JL009", call,
                f"{kind} '{tail}' reached under rank-dependent control flow — "
                "processes diverge here in a multi-process run",
                "make every process execute the call (collectives), or document "
                "the single-writer design with a suppression",
            )


@rule(
    "JL010",
    "per-host generator or seed not folded from the shared seed",
    "rank/pid/clock seeds give irreproducible per-process streams",
)
def check_per_host_rng(mod):
    derived = _DerivedNames(mod)
    for node in ast.walk(mod.tree):
        if not isinstance(node, ast.Call):
            continue
        canon = mod.canonical(node.func)
        seeded = canon in _RNG_CTORS or (
            isinstance(node.func, ast.Attribute) and node.func.attr == "manual_seed")
        if not seeded:
            continue
        for expr in list(node.args) + [kw.value for kw in node.keywords]:
            per_host = derived.at(node)
            if (_mentions_any_call(mod, expr, _PER_HOST_SEEDS)
                    or _mentions_process_id(mod, expr)
                    or _mentions_name(expr, per_host)) and not _folds_shared(expr, per_host):
                yield mod.finding(
                    "JL010", node,
                    f"{canon or '.manual_seed'} seeded from a per-host value — every "
                    "process gets an unrelated stream",
                    "seed from the SHARED run seed and fold the rank in "
                    "(seed + rank, or numpy's SeedSequence(seed).spawn)",
                )
                break


@rule(
    "JL011",
    "scalar host sync inside a device-dispatching loop",
    "float()/.item() per dispatched batch serialises the card's queue",
)
def check_sync_in_dispatch_loop(mod):
    for info in mod.fns.values():
        if info.traced:
            continue  # syncs in device code are JL003's subject
        device_names = mod.assigned_names(info.node, set(), True)

        def is_device_expr(expr: ast.expr) -> bool:
            return mod.mentions_device(expr, device_names)

        for node in mod.own_nodes(info.node):
            if not isinstance(node, ast.Call):
                continue
            loop = mod.in_loop(node)
            if loop is None:
                continue
            # the loop must itself dispatch device work — a loop that only
            # reads back results is data egress, not a pipeline stall
            dispatches = any(
                isinstance(n, ast.Call) and mod.is_device_ns(mod.canonical(n.func))
                and n is not node
                for n in ast.walk(loop)
            )
            if not dispatches:
                continue
            synced = None
            if (isinstance(node.func, ast.Name) and node.func.id in _SYNC_BUILTINS
                    and node.func.id not in mod.aliases and node.args
                    and is_device_expr(node.args[0])):
                synced = f"{node.func.id}()"
            elif (isinstance(node.func, ast.Attribute) and node.func.attr in _SYNC_METHODS
                    and is_device_expr(node.func.value)):
                synced = f".{node.func.attr}()"
            if synced:
                yield mod.finding(
                    "JL011", node,
                    f"{synced} forces a device sync inside a loop that also dispatches "
                    f"device work ('{info.qualname}') — one stall per iteration",
                    "keep per-iteration values on the device and read them once per "
                    "pass (see run_em_streamed's log-likelihood handling)",
                )


@rule(
    "JL012",
    "mesh-axis string literal bypassing mesh.DATA_AXIS",
    "inline axis names desynchronise from the mesh definition on rename",
)
def check_axis_literals(mod):
    def str_consts(expr: ast.expr):
        if isinstance(expr, ast.Constant) and isinstance(expr.value, str):
            yield expr
        elif isinstance(expr, (ast.Tuple, ast.List)):
            for e in expr.elts:
                yield from str_consts(e)

    for node in ast.walk(mod.tree):
        if not isinstance(node, ast.Call):
            continue
        tail = _tail(mod.canonical(node.func) or "")
        literal_sites = []
        if tail in ("Mesh", "make_mesh") and len(node.args) >= 2:
            literal_sites.extend(str_consts(node.args[1]))
        for kw in node.keywords:
            if kw.arg in ("axis_name", "axis_names"):
                literal_sites.extend(str_consts(kw.value))
        for lit in literal_sites:
            yield mod.finding(
                "JL012", lit,
                f"mesh axis written as the literal {lit.value!r} in {tail}(...)",
                "import and use parallel.mesh.DATA_AXIS (one definition, every "
                "shard agrees)",
            )
