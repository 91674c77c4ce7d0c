"""threadlint: the concurrency audit of the serve and obs thread fleet.

The port of splink_tpu/analysis/threadlint.py. The other layers police
device code; the bugs that escape review in the serving tier are host-side
lock discipline: a deque iterated while ``health()`` reads it, a counter
bumped outside its lock, a swap-lock window, an exactly-once delivery
claim. This layer finds those.

The engine audits a registry of known-concurrent classes
(:data:`THREAD_REGISTRY`: the service, the router, the engine's swap path,
the wire tier, the breakers and the obs monitors). For each class it:

* discovers the lock attributes (``self._x = threading.Lock()`` /
  ``RLock()`` / ``Condition(...)`` / the :mod:`.lockwatch` factories);
  a ``Condition(self._lock)`` aliases its underlying lock;
* classifies every ``self._*`` access and call as lock-held or not, by
  walking each method with the set of held locks (``with self._lock:``
  blocks and sequential ``self._lock.acquire()`` / ``release()`` forms);
* builds the inter-class lock acquisition graph: nested ``with`` blocks,
  calls to same-class methods that acquire, and calls through attributes
  whose class is known (inferred from ``self.x = OtherClass(...)`` in
  ``__init__``, or declared by ``ClassSpec.attr_types``).

Rules (catalog in :data:`TL_RULES`):

  TL001  mixed-guard access: an attribute guarded at >=1 site is read or
         written without the lock elsewhere
  TL002  blocking call under a lock: socket ops, ``sleep``,
         ``Future.result``, ``join``, queue puts, and the explicit waits
         on the card (``torch.cuda.synchronize``, ``Event.synchronize``,
         ``Stream.synchronize``), where the reference has JAX's
         ``io_callback``
  TL003  callback/event escape under a lock: publishing an event,
         resolving a future (done-callbacks run synchronously) or calling
         a stored callable while holding a lock
  TL004  lock-order cycle across the acquisition graph (deadlock hazard;
         the graph is written as an artifact by ``--lock-graph``)
  TL005  thread lifecycle: a non-daemon thread without join-on-close
         ownership; ``Condition.wait`` outside a predicate loop

Suppressions follow torchlint's syntax with the ``threadlint`` prefix:
``# threadlint: disable=TL002 (reason)`` on the offending line or the line
above, ``# threadlint: disable-file=TL001`` (or ``all``) in the first 10
lines; ``# threadlint: holds=_lock`` on or above a ``def`` declares that
the caller holds the lock. Every suppression in the package carries its
reason.

The dynamic half is :mod:`.lockwatch`: opt-in instrumented locks that
record the OBSERVED acquisition order at run time; ``chip_smoke.py``'s
``thread`` phase asserts that the observed graph is acyclic and agrees
with the static one.
"""

from __future__ import annotations

import ast
import json
import os
import re
from dataclasses import dataclass

from .findings import Finding
from .torchlint import ModuleLint

#: Rule catalog: id -> (title, one-line doc). The CLI's ``--list-rules``,
#: the docs table and the fixture tests all enumerate this.
TL_RULES: dict[str, tuple[str, str]] = {
    "TL001": (
        "mixed-guard attribute access",
        "an attribute lock-guarded at >=1 site is read/written without "
        "the lock elsewhere: a torn read or lost update under threads",
    ),
    "TL002": (
        "blocking call under a lock",
        "socket ops, sleep, Future.result, Thread.join, queue puts or "
        "waits on the card while holding a lock convoy every other thread",
    ),
    "TL003": (
        "callback/event escape under a lock",
        "publishing an event, resolving a future or calling a stored "
        "callable under a lock runs foreign code that may re-enter it",
    ),
    "TL004": (
        "lock-order cycle",
        "two locks acquired in opposite orders on different code paths "
        "deadlock the moment both paths run concurrently",
    ),
    "TL005": (
        "thread lifecycle hazard",
        "a non-daemon thread nobody joins on close outlives its owner; "
        "Condition.wait outside a predicate loop misses spurious wakeups",
    ),
}

_SUPPRESS_RE = re.compile(r"#\s*threadlint:\s*disable=([A-Za-z0-9_,\s]+)")
_HOLDS_RE = re.compile(r"#\s*threadlint:\s*holds=([A-Za-z0-9_,\s]+)")
_SUPPRESS_FILE_RE = re.compile(
    r"#\s*threadlint:\s*disable-file=([A-Za-z0-9_,\s]+)"
)

#: Lock/condition constructors (canonical names; the lockwatch factories
#: are the instrumented drop-ins the serve tier actually uses).
_LOCK_CTORS = ("threading.Lock", "threading.RLock")
_COND_CTORS = ("threading.Condition",)
_WATCH_SUFFIXES = ("lockwatch.new_lock", "lockwatch.new_rlock")

#: Method names that block the calling thread (TL002). ``join`` only
#: counts thread-shaped (no args, or a timeout kwarg — str.join always
#: takes one positional); ``wait`` on a class's own Condition is exempt
#: when its underlying lock is the only one held (that IS the protocol).
#: ``synchronize`` is the host waiting for the card: ``torch.cuda``'s,
#: an ``Event``'s or a ``Stream``'s.
_BLOCKING_METHODS = frozenset(
    {
        "sleep",
        "result",
        "recv",
        "recv_into",
        "sendall",
        "send",
        "accept",
        "connect",
        "makefile",
        "put",
        "synchronize",
        "join",
        "wait",
    }
)

#: Future-resolution methods run done-callbacks synchronously on the
#: calling thread — foreign code under the caller's lock (TL003).
_ESCAPE_METHODS = frozenset(
    {"set_result", "set_exception", "add_done_callback"}
)

#: Stored-callable attrs exempt from TL003: injectable clocks are pure
#: reads by convention (every monitor takes ``clock=time.monotonic``).
_CALLABLE_ALLOW = frozenset({"clock"})

#: Mutating container methods: ``self._ring.append(...)`` mutates the
#: attribute's value even though the attribute itself is only read.
_MUTATORS = frozenset(
    {
        "append",
        "appendleft",
        "extend",
        "extendleft",
        "insert",
        "pop",
        "popleft",
        "remove",
        "clear",
        "add",
        "discard",
        "update",
        "setdefault",
        "rotate",
    }
)

_CLOSER_METHODS = ("close", "stop", "shutdown", "kill", "__exit__", "__del__")


@dataclass(frozen=True)
class ClassSpec:
    """One registry entry: a known-concurrent class to audit.

    ``path`` is repo-root-relative; ``attr_types`` declares attribute
    types the engine cannot infer (an attribute stored from a constructor
    parameter rather than constructed inline), so cross-class acquisition
    edges still resolve: ``(("router", "ReplicaRouter"),)``.
    """

    path: str
    cls: str
    attr_types: tuple[tuple[str, str], ...] = ()


#: The known-concurrent fleet. Registering a class is one line here (plus
#: ``attr_types`` for param-stored collaborators); the audit, the lock
#: graph, the tests and chip_smoke's analysis phase pick it up.
THREAD_REGISTRY: tuple[ClassSpec, ...] = (
    ClassSpec("splink_tpu_torch/serve/service.py", "LinkageService"),
    ClassSpec("splink_tpu_torch/serve/engine.py", "QueryEngine"),
    ClassSpec("splink_tpu_torch/serve/router.py", "ReplicaRouter"),
    ClassSpec(
        "splink_tpu_torch/serve/router.py",
        "_HedgedCall",
        attr_types=(("router", "ReplicaRouter"),),
    ),
    ClassSpec("splink_tpu_torch/serve/health.py", "HealthMonitor"),
    ClassSpec("splink_tpu_torch/serve/admission.py", "CircuitBreaker"),
    ClassSpec("splink_tpu_torch/serve/admission.py", "WaitEstimator"),
    ClassSpec("splink_tpu_torch/serve/wire.py", "WireServer"),
    ClassSpec("splink_tpu_torch/serve/wire.py", "_ServerConn"),
    ClassSpec("splink_tpu_torch/serve/remote.py", "RemoteReplica"),
    ClassSpec("splink_tpu_torch/serve/remote.py", "_RemoteConn"),
    ClassSpec("splink_tpu_torch/obs/kernelwatch.py", "KernelWatch"),
    ClassSpec("splink_tpu_torch/obs/drift.py", "DriftMonitor"),
    ClassSpec("splink_tpu_torch/obs/drift.py", "ServeSketch"),
    ClassSpec("splink_tpu_torch/obs/slo.py", "SLOTracker"),
    ClassSpec("splink_tpu_torch/obs/flight.py", "FlightRecorder"),
    ClassSpec("splink_tpu_torch/obs/events.py", "EventSink"),
    ClassSpec("splink_tpu_torch/obs/fleet.py", "FleetAggregator"),
    ClassSpec("splink_tpu_torch/obs/fleet.py", "FleetIncidentReporter"),
)


@dataclass
class _Access:
    attr: str
    write: bool
    mutate: bool
    held: tuple[str, ...]
    node: ast.AST
    method: str


@dataclass
class _CallSite:
    node: ast.Call
    held: tuple[str, ...]
    method: str


@dataclass
class _Spawn:
    node: ast.Call
    method: str
    daemon: bool


@dataclass
class _Edge:
    src: str  # "Class._lock"
    dst: str
    node: ast.AST
    path: str


class _ClassAudit:
    """Per-class lock discovery + held-lock classification of every
    access and call (module docstring). Pure AST; no imports executed."""

    def __init__(
        self, mod: ModuleLint, node: ast.ClassDef, attr_types: dict
    ):
        self.mod = mod
        self.node = node
        self.name = node.name
        self.attr_types = dict(attr_types)
        self.locks: dict[str, str] = {}  # attr -> "lock" | "rlock"
        self.conditions: dict[str, str] = {}  # attr -> underlying lock attr
        self.methods: dict[str, ast.AST] = {}
        self.param_stored: set[str] = set()  # attrs assigned from a ctor param
        self.accesses: list[_Access] = []
        self.calls: list[_CallSite] = []
        self.spawns: list[_Spawn] = []
        self.edges: list[_Edge] = []  # intra-class nested acquisitions
        self.cond_waits: list[tuple[ast.Call, str, tuple[str, ...], str]] = []
        self._collect_methods()
        self._discover_locks()
        self._discover_attr_types()
        for mname, fn in self.methods.items():
            self._scan_block(fn.body, self._declared_holds(fn), mname)

    # -- discovery -------------------------------------------------------

    def _collect_methods(self) -> None:
        for child in self.node.body:
            if isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef)):
                self.methods[child.name] = child

    def _self_attr(self, expr: ast.expr) -> str | None:
        if (
            isinstance(expr, ast.Attribute)
            and isinstance(expr.value, ast.Name)
            and expr.value.id == "self"
        ):
            return expr.attr
        return None

    def _discover_locks(self) -> None:
        for fn in self.methods.values():
            for stmt in ast.walk(fn):
                if not isinstance(stmt, ast.Assign):
                    continue
                if not isinstance(stmt.value, ast.Call):
                    continue
                canon = self.mod.canonical(stmt.value.func) or ""
                for target in stmt.targets:
                    attr = self._self_attr(target)
                    if attr is None:
                        continue
                    if canon in _LOCK_CTORS or canon.endswith(
                        _WATCH_SUFFIXES
                    ):
                        self.locks[attr] = (
                            "rlock" if canon.endswith("RLock") else "lock"
                        )
                    elif canon in _COND_CTORS:
                        under = attr
                        if stmt.value.args:
                            inner = self._self_attr(stmt.value.args[0])
                            if inner is not None:
                                under = inner
                        self.conditions[attr] = under
                        if under == attr:
                            # a Condition owning its lock IS a lock node
                            self.locks.setdefault(attr, "lock")

    def _discover_attr_types(self) -> None:
        """``self.x = OtherClass(...)`` in __init__ types the attribute
        for cross-class edge resolution; ``self.x = <ctor param>`` marks
        a stored callable candidate for TL003."""
        init = self.methods.get("__init__")
        if init is None:
            return
        params = {
            a.arg
            for a in (
                *init.args.posonlyargs,
                *init.args.args,
                *init.args.kwonlyargs,
            )
        }
        for stmt in ast.walk(init):
            if not isinstance(stmt, ast.Assign):
                continue
            for target in stmt.targets:
                attr = self._self_attr(target)
                if attr is None:
                    continue
                if isinstance(stmt.value, ast.Call):
                    canon = self.mod.canonical(stmt.value.func) or ""
                    leaf = canon.rsplit(".", 1)[-1]
                    if leaf and leaf[0].isupper():
                        self.attr_types.setdefault(attr, leaf)
                elif (
                    isinstance(stmt.value, ast.Name)
                    and stmt.value.id in params
                ):
                    self.param_stored.add(attr)

    # -- held-lock scan --------------------------------------------------

    def _declared_holds(self, fn) -> tuple[str, ...]:
        """``# threadlint: holds=_lock`` on (or above) a method's ``def``
        line declares the caller-holds-the-lock precondition — the
        REQUIRES annotation of Clang's thread-safety analysis. The body
        is then scanned with that lock held; the declaration is trusted
        the way suppressions are, so it carries the same justification
        duty."""
        held: list[str] = []
        for lineno in (fn.lineno, fn.lineno - 1):
            if 1 <= lineno <= len(self.mod.lines):
                m = _HOLDS_RE.search(self.mod.lines[lineno - 1])
                if m:
                    for name in m.group(1).split(","):
                        name = name.strip()
                        if name and name not in held:
                            held.append(name)
        return tuple(held)

    def _lock_of(self, expr: ast.expr) -> str | None:
        """The lock attr an expression acquires (conditions resolve to
        their underlying lock)."""
        attr = self._self_attr(expr)
        if attr is None:
            return None
        if attr in self.conditions:
            return self.conditions[attr]
        if attr in self.locks:
            return attr
        return None

    def _acquire_stmt(self, stmt: ast.stmt) -> tuple[str, ast.AST] | None:
        """``self._lock.acquire()`` as a statement (the try/finally
        form); returns (lock attr, node)."""
        if not isinstance(stmt, ast.Expr) or not isinstance(
            stmt.value, ast.Call
        ):
            return None
        fn = stmt.value.func
        if isinstance(fn, ast.Attribute) and fn.attr == "acquire":
            lock = self._lock_of(fn.value)
            if lock is not None:
                return lock, stmt
        return None

    def _release_stmt(self, stmt: ast.stmt) -> str | None:
        if not isinstance(stmt, ast.Expr) or not isinstance(
            stmt.value, ast.Call
        ):
            return None
        fn = stmt.value.func
        if isinstance(fn, ast.Attribute) and fn.attr == "release":
            return self._lock_of(fn.value)
        return None

    def _note_edge(self, held: tuple[str, ...], new: str, node) -> None:
        if held and held[-1] != new:
            self.edges.append(
                _Edge(
                    f"{self.name}.{held[-1]}",
                    f"{self.name}.{new}",
                    node,
                    self.mod.path,
                )
            )

    def _scan_block(self, stmts, held: tuple[str, ...], method: str) -> None:
        """Sequential scan: acquire()/release() statements extend/shrink
        the held set for the remainder of the block."""
        held = list(held)
        for stmt in stmts:
            acq = self._acquire_stmt(stmt)
            if acq is not None:
                lock, node = acq
                self._note_edge(tuple(held), lock, node)
                held.append(lock)
                continue
            rel = self._release_stmt(stmt)
            if rel is not None and rel in held:
                for i in range(len(held) - 1, -1, -1):
                    if held[i] == rel:
                        del held[i]
                        break
                continue
            self._scan_stmt(stmt, tuple(held), method)

    def _scan_stmt(self, stmt, held: tuple[str, ...], method: str) -> None:
        if isinstance(stmt, (ast.With, ast.AsyncWith)):
            inner = list(held)
            for item in stmt.items:
                lock = self._lock_of(item.context_expr)
                if lock is not None:
                    self._note_edge(tuple(inner), lock, item.context_expr)
                    inner.append(lock)
                else:
                    self._scan_expr(item.context_expr, tuple(inner), method)
            self._scan_block(stmt.body, tuple(inner), method)
        elif isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef)):
            # a nested function runs later, on some other thread, with no
            # lock inherited from its definition site
            self._scan_block(stmt.body, (), method)
        elif isinstance(stmt, ast.If):
            self._scan_expr(stmt.test, held, method)
            self._scan_block(stmt.body, held, method)
            self._scan_block(stmt.orelse, held, method)
        elif isinstance(stmt, (ast.For, ast.AsyncFor)):
            self._scan_expr(stmt.iter, held, method)
            self._scan_target(stmt.target, held, method)
            self._scan_block(stmt.body, held, method)
            self._scan_block(stmt.orelse, held, method)
        elif isinstance(stmt, ast.While):
            self._scan_expr(stmt.test, held, method)
            self._scan_block(stmt.body, held, method)
            self._scan_block(stmt.orelse, held, method)
        elif isinstance(stmt, ast.Try):
            self._scan_block(stmt.body, held, method)
            for handler in stmt.handlers:
                self._scan_block(handler.body, held, method)
            self._scan_block(stmt.orelse, held, method)
            self._scan_block(stmt.finalbody, held, method)
        elif isinstance(stmt, ast.Assign):
            self._scan_expr(stmt.value, held, method)
            for target in stmt.targets:
                self._scan_target(target, held, method)
        elif isinstance(stmt, ast.AugAssign):
            self._scan_expr(stmt.value, held, method)
            attr = self._self_attr(stmt.target)
            if attr is not None:
                self.accesses.append(
                    _Access(attr, True, True, held, stmt.target, method)
                )
            else:
                self._scan_target(stmt.target, held, method)
        elif isinstance(stmt, ast.AnnAssign):
            if stmt.value is not None:
                self._scan_expr(stmt.value, held, method)
            self._scan_target(stmt.target, held, method)
        elif isinstance(stmt, ast.Return):
            if stmt.value is not None:
                self._scan_expr(stmt.value, held, method)
        elif isinstance(stmt, ast.Expr):
            self._scan_expr(stmt.value, held, method)
        elif isinstance(stmt, (ast.Raise, ast.Assert, ast.Delete)):
            for child in ast.iter_child_nodes(stmt):
                if isinstance(child, ast.expr):
                    self._scan_expr(child, held, method)
        elif isinstance(stmt, ast.ClassDef):
            pass  # nested classes are out of scope
        else:
            for child in ast.iter_child_nodes(stmt):
                if isinstance(child, ast.expr):
                    self._scan_expr(child, held, method)

    def _scan_target(self, target, held, method) -> None:
        attr = self._self_attr(target)
        if attr is not None:
            self.accesses.append(
                _Access(attr, True, True, held, target, method)
            )
            return
        if isinstance(target, (ast.Tuple, ast.List)):
            for elt in target.elts:
                self._scan_target(elt, held, method)
        elif isinstance(target, ast.Subscript):
            # self._x[k] = v mutates the container behind the attribute
            attr = self._self_attr(target.value)
            if attr is not None:
                self.accesses.append(
                    _Access(attr, False, True, held, target.value, method)
                )
            else:
                self._scan_expr(target.value, held, method)
            self._scan_expr(target.slice, held, method)
        elif isinstance(target, ast.Starred):
            self._scan_target(target.value, held, method)
        elif isinstance(target, ast.Attribute):
            self._scan_expr(target.value, held, method)

    def _scan_expr(self, expr, held: tuple[str, ...], method: str) -> None:
        for node in ast.walk(expr):
            if isinstance(node, (ast.Lambda,)):
                continue  # runs later, lock-free (walk still visits body;
                # acceptable over-approximation is avoided below)
            if isinstance(node, ast.Call):
                self.calls.append(_CallSite(node, held, method))
                self._note_call(node, held, method)
            attr = (
                self._self_attr(node)
                if isinstance(node, ast.Attribute)
                else None
            )
            if attr is not None:
                mutate = False
                parent = self.mod.parents.get(node)
                if (
                    isinstance(parent, ast.Attribute)
                    and parent.attr in _MUTATORS
                ):
                    gp = self.mod.parents.get(parent)
                    if isinstance(gp, ast.Call) and gp.func is parent:
                        mutate = True
                self.accesses.append(
                    _Access(attr, False, mutate, held, node, method)
                )

    def _note_call(self, call: ast.Call, held, method) -> None:
        canon = self.mod.canonical(call.func) or ""
        if canon in ("threading.Thread", "threading.Timer"):
            daemon = any(
                kw.arg == "daemon"
                and isinstance(kw.value, ast.Constant)
                and kw.value.value is True
                for kw in call.keywords
            )
            self.spawns.append(_Spawn(call, method, daemon))
        fn = call.func
        if isinstance(fn, ast.Attribute) and fn.attr == "wait":
            attr = self._self_attr(fn.value)
            if attr is not None and attr in self.conditions:
                self.cond_waits.append((call, attr, held, method))

    # -- per-method acquisition sets (for cross-class edges) -------------

    def direct_acquires(self, method: str) -> set[str]:
        out: set[str] = set()
        fn = self.methods.get(method)
        if fn is None:
            return out
        for node in ast.walk(fn):
            if isinstance(node, (ast.With, ast.AsyncWith)):
                for item in node.items:
                    lock = self._lock_of(item.context_expr)
                    if lock is not None:
                        out.add(lock)
            elif isinstance(node, ast.Call):
                f = node.func
                if isinstance(f, ast.Attribute) and f.attr == "acquire":
                    lock = self._lock_of(f.value)
                    if lock is not None:
                        out.add(lock)
        return out

    def acquires_closure(self, method: str, _seen=None) -> set[str]:
        """Locks a method may acquire, following same-class calls one
        transitive closure deep (bounded by the method set)."""
        _seen = _seen if _seen is not None else set()
        if method in _seen:
            return set()
        _seen.add(method)
        out = self.direct_acquires(method)
        fn = self.methods.get(method)
        if fn is None:
            return out
        for node in ast.walk(fn):
            if isinstance(node, ast.Call) and isinstance(
                node.func, ast.Attribute
            ):
                attr = self._self_attr(node.func.value)
                if attr is None and self._self_attr(node.func) is not None:
                    # self.m(...) — func itself is the self attribute
                    attr = None
                callee = None
                if (
                    isinstance(node.func.value, ast.Name)
                    and node.func.value.id == "self"
                ):
                    callee = node.func.attr
                if callee and callee in self.methods:
                    out |= self.acquires_closure(callee, _seen)
        return out


# -- suppression -------------------------------------------------------


def _file_suppressions(lines: list[str]) -> frozenset[str]:
    ids: set[str] = set()
    for line in lines[:10]:
        m = _SUPPRESS_FILE_RE.search(line)
        if m:
            ids |= {s.strip() for s in m.group(1).split(",") if s.strip()}
    return frozenset(ids)


def _suppressed(
    lines: list[str], file_ids: frozenset[str], finding: Finding
) -> bool:
    if "all" in file_ids or finding.rule in file_ids:
        return True
    for lineno in (finding.line, finding.line - 1):
        if 1 <= lineno <= len(lines):
            m = _SUPPRESS_RE.search(lines[lineno - 1])
            if m:
                ids = {s.strip() for s in m.group(1).split(",")}
                if finding.rule in ids or "all" in ids:
                    return True
    return False


# -- rule checks -------------------------------------------------------


def _check_tl001(audit: _ClassAudit) -> list[Finding]:
    out: list[Finding] = []
    by_attr: dict[str, list[_Access]] = {}
    for acc in audit.accesses:
        if acc.method == "__init__":
            continue  # construction is single-threaded
        if acc.attr in audit.locks or acc.attr in audit.conditions:
            continue
        by_attr.setdefault(acc.attr, []).append(acc)
    # only attributes mutated outside __init__ are shared mutable state;
    # init-only config reads race nothing
    for attr, accs in sorted(by_attr.items()):
        if not any(a.mutate or a.write for a in accs):
            continue
        guarded = [a for a in accs if a.held]
        unguarded = [a for a in accs if not a.held]
        if not guarded or not unguarded:
            continue
        lock = guarded[0].held[-1]
        for a in unguarded:
            verb = "written" if a.write else "read"
            out.append(
                _finding(
                    audit,
                    "TL001",
                    a.node,
                    f"{audit.name}.{attr} is guarded by "
                    f"'{lock}' at {len(guarded)} site(s) but {verb} "
                    f"without a lock in {a.method}()",
                    f"snapshot it inside `with self.{lock}:` (or justify "
                    "with a threadlint suppression)",
                )
            )
    return out


def _check_tl002(audit: _ClassAudit) -> list[Finding]:
    out: list[Finding] = []
    for site in audit.calls:
        if not site.held:
            continue
        call = site.node
        canon = audit.mod.canonical(call.func) or ""
        name = None
        if canon in ("time.sleep", "torch.cuda.synchronize"):
            name = canon
        elif isinstance(call.func, ast.Attribute):
            attr = call.func.attr
            if attr in _BLOCKING_METHODS:
                if attr == "join":
                    # str.join takes exactly one positional and no timeout
                    thread_shaped = not call.args or any(
                        kw.arg == "timeout" for kw in call.keywords
                    )
                    if not thread_shaped:
                        continue
                if attr == "wait":
                    cond = audit._self_attr(call.func.value)
                    if cond is not None and cond in audit.conditions:
                        under = audit.conditions[cond]
                        if set(site.held) == {under}:
                            continue  # the canonical Condition protocol
                name = attr
        if name is None:
            continue
        out.append(
            _finding(
                audit,
                "TL002",
                call,
                f"blocking call {name}() while {audit.name} holds "
                f"'{site.held[-1]}' in {site.method}()",
                "move the blocking call outside the lock span (snapshot "
                "state under the lock, block after releasing it)",
            )
        )
    return out


def _check_tl003(audit: _ClassAudit) -> list[Finding]:
    out: list[Finding] = []
    for site in audit.calls:
        if not site.held:
            continue
        call = site.node
        canon = audit.mod.canonical(call.func) or ""
        what = None
        if canon.endswith(".publish") or canon == "publish":
            what = "event publish"
        elif isinstance(call.func, ast.Attribute):
            if call.func.attr in _ESCAPE_METHODS:
                what = f"future {call.func.attr}() (done-callbacks run here)"
            else:
                attr = audit._self_attr(call.func)
                if (
                    attr is not None
                    and attr in audit.param_stored
                    and attr not in audit.methods
                    and attr.lstrip("_") not in _CALLABLE_ALLOW
                ):
                    what = f"stored callable self.{attr}()"
        if what is None:
            continue
        out.append(
            _finding(
                audit,
                "TL003",
                call,
                f"{what} while {audit.name} holds "
                f"'{site.held[-1]}' in {site.method}(): foreign code "
                "under the lock can re-enter or deadlock it",
                "decide under the lock, call after releasing it",
            )
        )
    return out


def _check_tl005(audit: _ClassAudit) -> list[Finding]:
    out: list[Finding] = []
    closer_joins = False
    for name in _CLOSER_METHODS:
        fn = audit.methods.get(name)
        if fn is None:
            continue
        for node in ast.walk(fn):
            if (
                isinstance(node, ast.Call)
                and isinstance(node.func, ast.Attribute)
                and node.func.attr == "join"
                and (
                    not node.args
                    or any(kw.arg == "timeout" for kw in node.keywords)
                )
            ):
                closer_joins = True
    for spawn in audit.spawns:
        if spawn.daemon:
            continue
        # `t.daemon = True` before start() counts, wherever in the method
        fn = audit.methods.get(spawn.method)
        daemon_assigned = fn is not None and any(
            isinstance(n, ast.Assign)
            and any(
                isinstance(t, ast.Attribute) and t.attr == "daemon"
                for t in n.targets
            )
            and isinstance(n.value, ast.Constant)
            and n.value.value is True
            for n in ast.walk(fn)
        )
        if daemon_assigned or closer_joins:
            continue
        out.append(
            _finding(
                audit,
                "TL005",
                spawn.node,
                f"{audit.name}.{spawn.method}() spawns a non-daemon "
                "thread and no close()/stop()/shutdown() joins it",
                "pass daemon=True, or join the thread in the owner's "
                "close() path",
            )
        )
    for call, cond, held, method in audit.cond_waits:
        cur = audit.mod.parents.get(call)
        in_while = False
        while cur is not None and not isinstance(
            cur, (ast.FunctionDef, ast.AsyncFunctionDef)
        ):
            if isinstance(cur, ast.While):
                in_while = True
                break
            cur = audit.mod.parents.get(cur)
        if not in_while:
            out.append(
                _finding(
                    audit,
                    "TL005",
                    call,
                    f"{audit.name}.{method}() calls self.{cond}.wait() "
                    "outside a predicate loop: spurious wakeups and "
                    "missed notifies slip through",
                    "wrap the wait in `while not <predicate>:`",
                )
            )
    return out


def _finding(
    audit: _ClassAudit, rule: str, node: ast.AST, message: str, hint: str
) -> Finding:
    return Finding(
        rule=rule,
        path=audit.mod.path,
        line=getattr(node, "lineno", 0),
        col=getattr(node, "col_offset", 0),
        message=message,
        hint=hint,
    )


# -- the lock graph + TL004 --------------------------------------------


def _cross_class_edges(audits: list[_ClassAudit]) -> list[_Edge]:
    """Edges from held locks into locks acquired by the callee: same-class
    method calls and calls through typed attributes."""
    by_name = {a.name: a for a in audits}
    edges: list[_Edge] = []
    for audit in audits:
        for site in audit.calls:
            if not site.held:
                continue
            fn = site.node.func
            if not isinstance(fn, ast.Attribute):
                continue
            src = f"{audit.name}.{site.held[-1]}"
            # self.m(...) — same class
            if isinstance(fn.value, ast.Name) and fn.value.id == "self":
                callee = fn.attr
                if callee in audit.methods:
                    for lock in sorted(audit.acquires_closure(callee)):
                        dst = f"{audit.name}.{lock}"
                        if dst != src:
                            edges.append(
                                _Edge(src, dst, site.node, audit.mod.path)
                            )
                continue
            # self.attr.m(...) — typed collaborator
            attr = audit._self_attr(fn.value)
            if attr is None:
                continue
            target = by_name.get(audit.attr_types.get(attr, ""))
            if target is None:
                continue
            for lock in sorted(target.acquires_closure(fn.attr)):
                edges.append(
                    _Edge(
                        src,
                        f"{target.name}.{lock}",
                        site.node,
                        audit.mod.path,
                    )
                )
    return edges


def build_lock_graph(audits: list[_ClassAudit]) -> dict:
    """The static acquisition graph artifact: nodes are ``Class.lock``,
    edges carry one witness site each (JSON-ready)."""
    nodes = sorted(
        {
            f"{a.name}.{lock}"
            for a in audits
            for lock in a.locks
        }
    )
    seen: dict[tuple[str, str], dict] = {}
    all_edges = [e for a in audits for e in a.edges]
    all_edges += _cross_class_edges(audits)
    for e in all_edges:
        key = (e.src, e.dst)
        entry = seen.get(key)
        site = f"{e.path}:{getattr(e.node, 'lineno', 0)}"
        if entry is None:
            seen[key] = {"from": e.src, "to": e.dst, "site": site, "count": 1}
        else:
            entry["count"] += 1
    return {
        "nodes": nodes,
        "edges": sorted(
            seen.values(), key=lambda d: (d["from"], d["to"])
        ),
    }


def graph_cycles(graph: dict) -> list[list[str]]:
    """Simple cycles in an acquisition graph (Tarjan SCCs; any SCC with
    more than one node, or a self-edge, deadlocks two threads)."""
    adj: dict[str, list[str]] = {}
    for e in graph["edges"]:
        adj.setdefault(e["from"], []).append(e["to"])
    index: dict[str, int] = {}
    low: dict[str, int] = {}
    on_stack: set[str] = set()
    stack: list[str] = []
    counter = [0]
    cycles: list[list[str]] = []

    def strongconnect(v: str) -> None:
        index[v] = low[v] = counter[0]
        counter[0] += 1
        stack.append(v)
        on_stack.add(v)
        for w in adj.get(v, []):
            if w not in index:
                strongconnect(w)
                low[v] = min(low[v], low[w])
            elif w in on_stack:
                low[v] = min(low[v], index[w])
        if low[v] == index[v]:
            comp = []
            while True:
                w = stack.pop()
                on_stack.discard(w)
                comp.append(w)
                if w == v:
                    break
            if len(comp) > 1 or v in adj.get(v, []):
                cycles.append(sorted(comp))

    for v in sorted(set(adj) | {w for ws in adj.values() for w in ws}):
        if v not in index:
            strongconnect(v)
    return cycles


def _check_tl004(
    audits: list[_ClassAudit], graph: dict
) -> list[Finding]:
    out: list[Finding] = []
    edge_site = {
        (e["from"], e["to"]): e["site"] for e in graph["edges"]
    }
    for cycle in graph_cycles(graph):
        members = set(cycle)
        witness = next(
            (
                (a, b)
                for (a, b) in sorted(edge_site)
                if a in members and b in members
            ),
            None,
        )
        site = edge_site.get(witness, "?:0")
        path, _, line = site.rpartition(":")
        out.append(
            Finding(
                rule="TL004",
                path=path or site,
                line=int(line or 0),
                message=(
                    "lock-order cycle: "
                    + " <-> ".join(cycle)
                    + " are acquired in conflicting orders (deadlock "
                    "the moment both paths run concurrently)"
                ),
                hint="pick one global acquisition order and restructure "
                "the offending path to follow it",
            )
        )
    return out


# -- entry points ------------------------------------------------------


def _audit_module(
    path: str, source: str, wanted: list[ClassSpec] | None
) -> list[_ClassAudit]:
    mod = ModuleLint(path, source)
    specs = {s.cls: s for s in wanted} if wanted else None
    audits = []
    for node in ast.walk(mod.tree):
        if not isinstance(node, ast.ClassDef):
            continue
        if specs is not None and node.name not in specs:
            continue
        attr_types = (
            dict(specs[node.name].attr_types) if specs is not None else {}
        )
        audits.append(_ClassAudit(mod, node, attr_types))
    if specs is not None:
        missing = set(specs) - {a.name for a in audits}
        if missing:
            raise KeyError(
                f"registered class(es) not found in {path}: "
                f"{sorted(missing)}"
            )
    return audits


def _collect_findings(
    audits: list[_ClassAudit],
) -> tuple[list[Finding], dict]:
    findings: list[Finding] = []
    for audit in audits:
        raw = (
            _check_tl001(audit)
            + _check_tl002(audit)
            + _check_tl003(audit)
            + _check_tl005(audit)
        )
        file_ids = _file_suppressions(audit.mod.lines)
        findings.extend(
            f
            for f in raw
            if not _suppressed(audit.mod.lines, file_ids, f)
        )
    graph = build_lock_graph(audits)
    lines_by_path = {a.mod.path: a.mod.lines for a in audits}
    for f in _check_tl004(audits, graph):
        lines = lines_by_path.get(f.path, [])
        if not _suppressed(lines, _file_suppressions(lines), f):
            findings.append(f)
    return findings, graph


def audit_source(path: str, source: str) -> tuple[list[Finding], dict]:
    """Audit every class in one module (fixture/file mode); returns
    (unsuppressed findings, lock graph)."""
    return _collect_findings(_audit_module(path, source, None))


def repo_root() -> str:
    return os.path.dirname(
        os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    )


def run_thread_audit(
    classes: list[str] | None = None, root: str | None = None
) -> tuple[list[Finding], int, dict]:
    """Audit the registered fleet; returns (findings, classes audited,
    lock graph). ``classes`` filters by class name (KeyError on unknown
    names, matching the other layers' CLI contract)."""
    root = root or repo_root()
    specs = list(THREAD_REGISTRY)
    if classes:
        known = {s.cls for s in specs}
        unknown = set(classes) - known
        if unknown:
            raise KeyError(
                f"unknown thread-audit class(es): {sorted(unknown)}; "
                f"registered: {sorted(known)}"
            )
        specs = [s for s in specs if s.cls in classes]
    by_path: dict[str, list[ClassSpec]] = {}
    for spec in specs:
        by_path.setdefault(spec.path, []).append(spec)
    audits: list[_ClassAudit] = []
    for rel_path, wanted in sorted(by_path.items()):
        full = os.path.join(root, rel_path)
        with open(full, encoding="utf-8") as fh:
            source = fh.read()
        audits.extend(_audit_module(rel_path, source, wanted))
    findings, graph = _collect_findings(audits)
    return findings, len(audits), graph


def write_lock_graph(path: str, graph: dict) -> str:
    """Write the acquisition-graph artifact (plus its cycles, which must
    be empty on a healthy tree) as JSON."""
    payload = dict(graph, cycles=graph_cycles(graph))
    with open(path, "w", encoding="utf-8") as fh:
        json.dump(payload, fh, indent=2, sort_keys=True)
        fh.write("\n")
    return path
