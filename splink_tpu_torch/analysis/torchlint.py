"""torchlint: the AST lint pass over PyTorch hazard classes.

The port of splink_tpu/analysis/jaxlint.py. The hazards that break an
eager GPU pipeline are not syntax errors but silent performance and
correctness leaks: a ``float()`` that waits for the card inside a hot
loop, an unpinned ``torch.arange`` whose dtype follows the default, a
``torch.tensor(x, device=card)`` that copies host data on every call. Each
rule in :mod:`.rules` targets one such class and reports structured
:class:`~.findings.Finding` objects.

The engine builds one :class:`ModuleLint` per source file:

  * import-alias resolution, so ``torch.zeros`` / ``from torch import
    zeros`` / ``import numpy as np; np.sum`` all canonicalise to one
    dotted name;
  * device-context analysis. The reference's rules fire in traced
    functions (jit roots and their callees); PyTorch has no jit, so the
    roots are :data:`DEVICE_ROOTS`, the entry functions the trace audit's
    kernel registry drives (``trace_audit.py``), by module and qualname.
    From each root the engine propagates to its callees in the same module
    by name, as the reference does, and records which names hold device
    values: a root's parameters (those annotated as host types excluded),
    the parameters of an enclosing root, and locals assigned from ``torch.``
    expressions or from device names. Host code (settings, frames, I/O)
    stays outside that scope;
  * suppression handling: ``# torchlint: disable=JL003[,JL004]`` on the
    offending line or the line above (with the reason on the line),
    ``# torchlint: disable-file=JL001`` (or ``all``) in the file's first
    10 lines.

Rules stay out of the engine: they are plain functions registered in
:mod:`.rules` that read a ModuleLint and yield findings.
"""

from __future__ import annotations

import ast
import os
import re
from dataclasses import dataclass

from .findings import Finding, Report

_SUPPRESS_RE = re.compile(r"#\s*torchlint:\s*disable=([A-Za-z0-9_,\s]+)")
_SUPPRESS_FILE_RE = re.compile(r"#\s*torchlint:\s*disable-file=([A-Za-z0-9_,\s]+)")

# The device entry functions: what the trace audit's kernel registry
# (trace_audit._ensure_default_registry) runs, by module (relative to the
# package) and qualname. Their callees in the same module are device code
# too.
DEVICE_ROOTS: tuple[tuple[str, str], ...] = (
    ("em.py", "run_em"),
    ("em.py", "run_em_checkpointed"),
    ("em.py", "score_pairs"),
    ("parallel/streaming.py", "_batch_stats"),
    ("gammas.py", "GammaProgram.gamma_batch"),
    ("gammas.py", "GammaProgram.pattern_ids"),
    ("gammas.py", "GammaProgram.narrow_ids"),
    ("gammas.py", "pattern_histogram"),
    ("pairgen.py", "make_virtual_pattern_fn"),
    ("ops/strings.py", "jaro_winkler"),
    ("ops/strings.py", "levenshtein_ratio"),
    ("term_frequencies.py", "token_stats"),
    ("term_frequencies.py", "token_gather"),
    ("serve/engine.py", "encode_query"),
    ("serve/engine.py", "candidate_gather"),
    ("serve/engine.py", "score_topk"),
    ("serve/engine.py", "score_fused"),
    ("blocking_device.py", "segment_sort"),
    ("blocking_device.py", "build_bucket_csr"),
    ("blocking_device.py", "_emit_chunk"),
    ("blocking_device.py", "chunk_digest"),
    ("blocking_device.py", "chunk_digest_compact"),
    ("approx/minhash.py", "minhash_signatures"),
    ("approx/minhash.py", "band_keys"),
    ("approx/lsh.py", "verify_pairs"),
    ("obs/quality.py", "make_profile_fn"),
    ("obs/drift.py", "make_sketch_fn"),
)

_PACKAGE = "splink_tpu_torch"

# annotations that mark a root's parameter as host data or configuration
_HOST_ANNOTATIONS = {
    "int", "float", "bool", "str", "dict", "list", "tuple", "Callable", "np", "numpy",
    "ndarray",
}

# torch.* callables that return host objects, not device values
_HOST_TORCH = {
    "torch.device",
    "torch.finfo",
    "torch.iinfo",
    "torch.Size",
    "torch.get_default_dtype",
    "torch.is_tensor",
    "torch.is_floating_point",
    "torch.no_grad",
    "torch.inference_mode",
    "torch.Generator",
}

# builtins whose result is a host fact about their argument (no sync)
_HOST_BUILTINS = {"len", "isinstance", "type", "id", "callable"}

# attributes and methods of a tensor that are host facts (no sync)
_STATIC_ATTRS = {
    "shape", "dtype", "ndim", "size", "device", "is_cuda", "numel", "dim",
    "element_size", "stride", "layout", "is_floating_point",
}


@dataclass
class FnInfo:
    """Device-context facts about one function definition."""

    node: ast.AST
    qualname: str
    params: tuple[str, ...]
    static_params: frozenset[str] = frozenset()
    traced: bool = False  # body runs as device code (a root or its callee)
    params_traced: bool = False  # parameters are device values (a root)
    traced_names: frozenset[str] = frozenset()  # names holding device values


def _bound_names(target: ast.expr):
    """Names an assignment target actually (re)binds. ``words[w] = x``
    mutates ``words`` — ``w`` is an index read, not a binding."""
    if isinstance(target, ast.Name):
        yield target.id
    elif isinstance(target, (ast.Tuple, ast.List)):
        for elt in target.elts:
            yield from _bound_names(elt)
    elif isinstance(target, ast.Starred):
        yield from _bound_names(target.value)
    elif isinstance(target, (ast.Subscript, ast.Attribute)):
        yield from _bound_names(target.value)


def _host_annotation(ann: ast.expr | None) -> bool:
    """Whether a parameter annotation names only host types (``int``,
    ``int | None``, ``tuple[int, ...]``)."""
    if ann is None:
        return False
    names = {n.id for n in ast.walk(ann) if isinstance(n, ast.Name)}
    names |= {n.attr for n in ast.walk(ann) if isinstance(n, ast.Attribute)}
    names |= {n.value for n in ast.walk(ann)
              if isinstance(n, ast.Constant) and isinstance(n.value, str)}
    names.discard("None")
    return bool(names) and names <= _HOST_ANNOTATIONS


def package_module(path: str) -> str | None:
    """``path``'s module path relative to the package (``serve/engine.py``),
    or None outside it."""
    parts = os.path.normpath(os.path.abspath(path)).split(os.sep)
    if _PACKAGE not in parts:
        return None
    idx = len(parts) - 1 - parts[::-1].index(_PACKAGE)
    return "/".join(parts[idx + 1:])


def roots_for(path: str) -> tuple[str, ...]:
    """The :data:`DEVICE_ROOTS` qualnames of the module at ``path``."""
    module = package_module(path)
    return tuple(q for m, q in DEVICE_ROOTS if m == module)


class ModuleLint:
    """One parsed module plus the shared analyses every rule reads.
    ``roots``: the qualnames of its device entry functions (default: the
    module's :data:`DEVICE_ROOTS`)."""

    def __init__(self, path: str, source: str, roots=None):
        self.path = path
        self.source = source
        self.lines = source.splitlines()
        self.tree = ast.parse(source, filename=path)
        self.parents: dict[ast.AST, ast.AST] = {}
        for parent in ast.walk(self.tree):
            for child in ast.iter_child_nodes(parent):
                self.parents[child] = parent
        self.aliases = self._collect_aliases()
        self.fns: dict[ast.AST, FnInfo] = {}
        self._collect_functions()
        self.roots = tuple(roots_for(path) if roots is None else roots)
        self._mark_device_roots()
        self._propagate_traced()
        self._compute_traced_names()
        self.file_suppressed = self._file_suppressions()

    # -- imports / name canonicalisation ----------------------------------

    def _collect_aliases(self) -> dict[str, str]:
        aliases: dict[str, str] = {}
        for node in ast.walk(self.tree):
            if isinstance(node, ast.Import):
                for a in node.names:
                    aliases[a.asname or a.name.split(".")[0]] = (
                        a.name if a.asname else a.name.split(".")[0]
                    )
            elif isinstance(node, ast.ImportFrom) and node.module:
                for a in node.names:
                    aliases[a.asname or a.name] = f"{node.module}.{a.name}"
        return aliases

    def canonical(self, node: ast.expr) -> str | None:
        """Dotted canonical name of a Name/Attribute chain, alias-resolved
        (``np.sum`` -> ``numpy.sum``), or None for other shapes."""
        parts: list[str] = []
        while isinstance(node, ast.Attribute):
            parts.append(node.attr)
            node = node.value
        if not isinstance(node, ast.Name):
            return None
        head = self.aliases.get(node.id, node.id)
        return ".".join([head, *reversed(parts)])

    def is_device_ns(self, canon: str | None) -> bool:
        """Calls that dispatch work on (or make) device values: ``torch.*``
        but its host helpers and ``torch.cuda`` / ``torch.distributed``."""
        return bool(canon) and (
            canon.startswith("torch.")
            and canon not in _HOST_TORCH
            and not canon.startswith(("torch.cuda.", "torch.distributed.",
                                      "torch.utils.", "torch.backends."))
        )

    # -- function collection ----------------------------------------------

    def _collect_functions(self) -> None:
        def visit(node: ast.AST, prefix: str) -> None:
            for child in ast.iter_child_nodes(node):
                if isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef)):
                    qual = f"{prefix}{child.name}"
                    args = child.args
                    every = (*args.posonlyargs, *args.args, *args.kwonlyargs)
                    params = tuple(a.arg for a in every)
                    statics = frozenset(
                        a.arg for a in every
                        if a.arg in ("self", "cls") or _host_annotation(a.annotation)
                    )
                    self.fns[child] = FnInfo(child, qual, params, statics)
                    visit(child, f"{qual}.")
                elif isinstance(child, ast.ClassDef):
                    visit(child, f"{prefix}{child.name}.")
                else:
                    visit(child, prefix)

        visit(self.tree, "")

    def enclosing_fn(self, node: ast.AST) -> ast.AST | None:
        """Nearest enclosing FunctionDef, or None at module/class level."""
        cur = self.parents.get(node)
        while cur is not None:
            if isinstance(cur, (ast.FunctionDef, ast.AsyncFunctionDef)):
                return cur
            cur = self.parents.get(cur)
        return None

    def _fn_by_name(self) -> dict[str, list[FnInfo]]:
        by_name: dict[str, list[FnInfo]] = {}
        for info in self.fns.values():
            by_name.setdefault(info.node.name, []).append(info)
        return by_name

    # -- device-context analysis ------------------------------------------

    def _mark_device_roots(self) -> None:
        """The roots, and the functions a root returns (a factory's
        kernels): their parameters are device values."""
        wanted = set(self.roots)
        work = [info for info in self.fns.values() if info.qualname in wanted]
        while work:
            info = work.pop()
            info.traced = info.params_traced = True
            returned = {n.value.id for n in self.own_nodes(info.node)
                        if isinstance(n, ast.Return) and isinstance(n.value, ast.Name)}
            work += [inner for inner in self.fns.values()
                     if inner.node.name in returned and not inner.params_traced
                     and self.enclosing_fn(inner.node) is info.node]

    def _called_names(self, fn_node: ast.AST):
        """Simple/attribute callee names invoked inside a function body."""
        names: set[str] = set()
        for node in ast.walk(fn_node):
            if isinstance(node, ast.Call):
                if isinstance(node.func, ast.Name):
                    names.add(node.func.id)
                elif isinstance(node.func, ast.Attribute):
                    # only bare-receiver method calls (self.f(), ctx.f()) —
                    # a dotted module call resolves via canonical() instead
                    if isinstance(node.func.value, ast.Name):
                        recv = self.aliases.get(node.func.value.id, node.func.value.id)
                        if "." not in recv and recv not in ("torch", "numpy", "math"):
                            names.add(node.func.attr)
        return names

    def _propagate_traced(self) -> None:
        """Intra-module transitive closure: a function called (by name) from
        a device function is device code itself. Name-based and therefore
        approximate — rules that need certainty about *parameters* holding
        device values check ``params_traced``, which only roots get."""
        by_name = self._fn_by_name()
        work = [info for info in self.fns.values() if info.traced]
        while work:
            info = work.pop()
            for name in self._called_names(info.node):
                for callee in by_name.get(name, []):
                    if not callee.traced:
                        callee.traced = True
                        work.append(callee)

    def assigned_names(self, fn_node: ast.AST, seed: set, device_calls: bool) -> set:
        """Names assigned in ``fn_node``'s own body from an expression that
        mentions ``seed`` names (or, with ``device_calls``, a device
        call), to a fixpoint so chains (``a = torch.f(); b = a + 1``)
        resolve."""
        names = set(seed)
        stmts = [
            n for n in ast.walk(fn_node)
            if self.enclosing_fn(n) is fn_node
            and isinstance(n, (ast.Assign, ast.AugAssign, ast.AnnAssign))
        ]
        for _ in range(8):
            added = False
            for stmt in stmts:
                value = stmt.value
                if value is None or not self.mentions_device(value, names, device_calls):
                    continue
                targets = stmt.targets if isinstance(stmt, ast.Assign) else [stmt.target]
                for t in targets:
                    for n in _bound_names(t):
                        if n not in names:
                            names.add(n)
                            added = True
            if not added:
                break
        return names

    def _compute_traced_names(self) -> None:
        for info in self.fns.values():
            if not info.traced:
                continue
            names: set[str] = set()
            if info.params_traced:
                names |= set(info.params) - set(info.static_params)
            # params of an enclosing root are device values too (a kernel
            # closure over its factory's tensors)
            outer = self.enclosing_fn(info.node)
            while outer is not None:
                oinfo = self.fns.get(outer)
                if oinfo is not None and oinfo.params_traced:
                    names |= set(oinfo.params) - set(oinfo.static_params)
                outer = self.enclosing_fn(outer)
            info.traced_names = frozenset(self.assigned_names(info.node, names, True))

    def mentions_device(self, node: ast.expr, names, device_calls: bool = True) -> bool:
        """Whether an expression references a device name or (with
        ``device_calls``) calls into the device namespace. A reference
        through ``.shape`` / ``.dtype`` / ``.device`` / ``.numel()`` and the
        like does not count: those are host facts, so values derived from
        them are host scalars."""
        for n in ast.walk(node):
            if isinstance(n, ast.Name) and n.id in names:
                parent = self.parents.get(n)
                if isinstance(parent, ast.Attribute) and parent.attr in _STATIC_ATTRS:
                    continue
                if (isinstance(parent, ast.Call) and isinstance(parent.func, ast.Name)
                        and parent.func.id in _HOST_BUILTINS):
                    continue
                return True
            if device_calls and isinstance(n, ast.Call) and self.is_device_ns(
                    self.canonical(n.func)):
                return True
        return False

    # -- shared rule helpers ----------------------------------------------

    def f64_gated(self, node: ast.AST) -> bool:
        """Whether a node sits under a conditional that switches on the
        float64 mode (``if float64:``, ``torch.float64 if f64 else
        torch.float32``) — explicit float64 there is the deliberate float64
        tier, not a leak."""
        cur: ast.AST | None = node
        while cur is not None:
            test = None
            if isinstance(cur, (ast.If, ast.IfExp, ast.While)):
                test = cur.test
            if test is not None:
                src = ast.get_source_segment(self.source, test) or ""
                if re.search(r"x64|f64|float64", src):
                    return True
            cur = self.parents.get(cur)
        return False

    def in_loop(self, node: ast.AST) -> ast.AST | None:
        """Nearest enclosing for/while loop within the same function."""
        cur = self.parents.get(node)
        while cur is not None and not isinstance(cur, (ast.FunctionDef, ast.AsyncFunctionDef)):
            if isinstance(cur, (ast.For, ast.While)):
                return cur
            cur = self.parents.get(cur)
        return None

    def own_nodes(self, fn_node: ast.AST):
        """The nodes of a function's own body (nested functions excluded)."""
        for node in ast.walk(fn_node):
            if node is not fn_node and self.enclosing_fn(node) is fn_node:
                yield node

    def finding(self, rule: str, node: ast.AST, message: str, hint: str = "") -> Finding:
        return Finding(
            rule=rule,
            path=self.path,
            line=getattr(node, "lineno", 0),
            col=getattr(node, "col_offset", 0),
            message=message,
            hint=hint,
        )

    # -- suppressions ------------------------------------------------------

    def _file_suppressions(self) -> frozenset[str]:
        ids: set[str] = set()
        for line in self.lines[:10]:
            m = _SUPPRESS_FILE_RE.search(line)
            if m:
                ids |= {s.strip() for s in m.group(1).split(",") if s.strip()}
        return frozenset(ids)

    def suppressed(self, finding: Finding) -> bool:
        if "all" in self.file_suppressed or finding.rule in self.file_suppressed:
            return True
        for lineno in (finding.line, finding.line - 1):
            if 1 <= lineno <= len(self.lines):
                m = _SUPPRESS_RE.search(self.lines[lineno - 1])
                if m:
                    ids = {s.strip() for s in m.group(1).split(",")}
                    if finding.rule in ids or "all" in ids:
                        return True
        return False


def lint_source(path: str, source: str, rules=None, roots=None) -> list[Finding]:
    """Lint one module's source; returns unsuppressed findings. ``roots``:
    its device entry functions' qualnames (default: :data:`DEVICE_ROOTS`)."""
    from .rules import iter_rules

    checks = list(iter_rules(rules))
    try:
        mod = ModuleLint(path, source, roots)
    except SyntaxError as e:
        return [Finding(rule="JL000", path=path, line=e.lineno or 0,
                        message=f"syntax error: {e.msg}")]
    except ValueError as e:  # e.g. null bytes: unparseable, not a crash
        return [Finding(rule="JL000", path=path, line=0, message=str(e))]
    out: list[Finding] = []
    for _rule_id, check in checks:
        for f in check(mod):
            if not mod.suppressed(f):
                out.append(f)
    return out


def iter_python_files(paths):
    """Expand files/directories into .py files (skipping caches)."""
    for path in paths:
        if os.path.isfile(path):
            yield path
        elif os.path.isdir(path):
            for root, dirs, files in os.walk(path):
                dirs[:] = sorted(d for d in dirs if d not in ("__pycache__", ".git"))
                for name in sorted(files):
                    if name.endswith(".py"):
                        yield os.path.join(root, name)
        else:
            raise FileNotFoundError(path)


def lint_paths(paths, rules=None) -> Report:
    """Lint every .py file under the given paths into one Report."""
    from .rules import iter_rules

    list(iter_rules(rules))  # an unknown rule id fails before any file is read
    report = Report()
    for file_path in iter_python_files(paths):
        try:
            with open(file_path, encoding="utf-8") as fh:
                source = fh.read()
        except UnicodeDecodeError as e:
            report.extend([Finding(rule="JL000", path=file_path, line=0,
                                   message=f"not valid UTF-8: {e.reason}")])
            report.files_checked += 1
            continue
        report.extend(lint_source(file_path, source, rules))
        report.files_checked += 1
    return report
