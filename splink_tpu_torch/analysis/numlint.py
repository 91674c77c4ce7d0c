"""numlint: the AST lint pass over numerical-safety hazard classes (its
measured twin is :mod:`.num_audit`).

The port of splink_tpu/analysis/numlint.py. The pipeline is log-space
Fellegi-Sunter arithmetic: probabilities that legitimately reach exactly 0
and 1 (the M-step zero-fills unseen levels), log-Bayes-factor folds whose
accumulation ORDER is contractual (``torch.sum``'s reduce tree diverges
from ``fold_logit``'s running accumulator in the last ulp past ~2 columns),
and count denominators that are empty on adversarial batches. torchlint
catches PyTorch-mechanics hazards; nothing there catches ``torch.log(p)``
where ``p`` can be 0, or ``num / (num + den)`` where both products
underflow. Each NL rule targets one such numerics class:

  NL001  raw ``log``/``log2``/``log10`` on a possibly-zero operand
  NL002  ``exp``/``expm1`` of an unbounded log-space quantity (no max-shift)
  NL003  division without a denominator guard on a count/probability sum
  NL004  linear-space probability product (``prod``/``cumprod`` on floats)
  NL005  exact ``==``/``!=`` comparison against computed floats in device code
  NL006  reduce-tree reduction inside a fold-order-contracted scoring path
  NL007  unclamped sigmoid->logit round-trip (``log(p / (1 - p))``)
  NL008  float literal outside float32's normal range in device code

Each rule knows the ``torch.`` function (``torch.log(x)``), the tensor
method (``x.log()``) and the ``numpy.`` function the reference knows.
"Device code" is torchlint's device context (:data:`.torchlint.DEVICE_ROOTS`,
their same-module callees and the names that hold device values), where
the reference reads jit-traced code.

The engine reuses torchlint's :class:`~.torchlint.ModuleLint` and the
shared :class:`~.findings.Finding` model, but keeps its OWN rule catalog
and suppression prefix, so that a numerics waiver never silences a
PyTorch-mechanics rule on the same line:

  ``# numlint: disable=NL003 (reason)``  on the line or the line above
  ``# numlint: disable-file=NL001``      (or ``all``) in the first 10 lines

Guard recognition is syntactic and local: an operand counts as guarded
when it (or, for a bare name, any assignment to it in the same function)
contains a flooring call (``maximum`` / ``clamp`` / ``clamp_min`` / ``clip``
/ ``where`` / ``max``), adds a positive constant (``df + 1.0``,
``(hk + 0.5) * c``), or references an eps/tiny-named value
(``torch.finfo(dtype).tiny``); a value seen through a dtype conversion
(``u.to(torch.float64)``, ``x.double()``) keeps the guards of what it
converts. A denominator also counts as guarded when a conditional or early
return in the same function tests its name (``if not total: return
0.0``). A product or comparison over an integer dtype (``dtype=torch.int64``,
``x.to(torch.int64)``, ``x.long()``) is exact and exempt. Anything subtler
is a ``# numlint: disable=`` with its reason.
"""

from __future__ import annotations

import ast
import re

import numpy as np

from .findings import Finding, Report
from .torchlint import ModuleLint, _bound_names, iter_python_files

# ---------------------------------------------------------------------------
# Rule catalog (threadlint's idiom: id -> (title, doc); --list-rules prints it)
# ---------------------------------------------------------------------------

NL_RULES: dict[str, tuple[str, str]] = {
    "NL001": (
        "raw log on a possibly-zero operand",
        "torch.log/np.log (and log2/log10, and the tensor methods) of an "
        "unguarded operand: EM's M-step zero-fills unseen gamma levels, so "
        "probabilities here legitimately reach exactly 0 and log(0) = -inf "
        "poisons every downstream fold. Floor the operand (torch.clamp(x, "
        "min=torch.finfo(x.dtype).tiny)) or use models.fellegi_sunter._safe_log.",
    ),
    "NL002": (
        "unshifted exp of an unbounded log-space quantity",
        "torch.exp/expm1 of a device log-sum without a max-shift or clamp: "
        "log-Bayes factors grow linearly in column count, and exp "
        "overflows f32 at ~88.7. Subtract the max first (logsumexp "
        "shift), clamp, or stay in log space (torch.logaddexp).",
    ),
    "NL003": (
        "division without a denominator guard",
        "division by a count/probability accumulation (a sum() result or "
        "an a + b of computed terms) with no floor, no positive-constant "
        "offset and no branch testing it: empty buckets and all-null "
        "batches make these denominators exactly 0. Floor it "
        "(torch.clamp(den, min=eps) / max(den, 1)) or branch on it first.",
    ),
    "NL004": (
        "linear-space probability product",
        "torch.prod/cumprod over float probabilities in device code: "
        "products of per-column probabilities underflow f32 after a few "
        "dozen small factors (the reference engine needed a tiny-number "
        "regression test for exactly this). Accumulate _safe_log values "
        "and exponentiate once, or fold in log space.",
    ),
    "NL005": (
        "exact float equality in device code",
        "== / != against a float literal or a computed float inside a "
        "device function: values that differ across reduce orders or "
        "precisions in the last ulp make the comparison "
        "device-dependent. Compare with a tolerance (torch.abs(a - b) <= "
        "tol) or restructure on integer codes.",
    ),
    "NL006": (
        "reduce-tree reduction in a fold-order-contracted path",
        "torch.sum/prod/cumsum inside a function that participates in the "
        "fold_logit contract: torch.sum's reduction tree diverges from the "
        "fused kernel's left-to-right running accumulator in the last ulp "
        "past ~2 comparison columns, which silently breaks serve<->offline "
        "bit-parity. Accumulate column by column in fold_logit's order "
        "instead.",
    ),
    "NL007": (
        "unclamped sigmoid->logit round-trip",
        "logit(p) / log(p / (1 - p)) without clamping p away from 0 and "
        "1: match probabilities saturate to exactly 1.0 in f32 beyond "
        "~17 logits of evidence, and the round-trip returns +/-inf. "
        "Clamp into [eps, 1 - eps] first (torch.logit(p, eps=...)), or "
        "carry the logit itself (match_logit / fold_logit) instead of "
        "re-deriving it.",
    ),
    "NL008": (
        "float literal outside float32's normal range",
        "a literal float in device code whose magnitude exceeds f32's "
        "finite range (silently inf at f32) or sits below its smallest "
        "normal (silently flushed to 0/denormal): the kernels evaluate "
        "the same source at f32 on the card. Derive the constant from "
        "torch.finfo(dtype) instead.",
    ),
}

# ---------------------------------------------------------------------------
# Suppression grammar (numlint's own prefix)
# ---------------------------------------------------------------------------

_SUPPRESS_RE = re.compile(r"#\s*numlint:\s*disable=([A-Za-z0-9_,\s]+)")
_SUPPRESS_FILE_RE = re.compile(r"#\s*numlint:\s*disable-file=([A-Za-z0-9_,\s]+)")


def _file_suppressions(lines: list[str]) -> frozenset[str]:
    ids: set[str] = set()
    for line in lines[:10]:
        m = _SUPPRESS_FILE_RE.search(line)
        if m:
            ids |= {s.strip() for s in m.group(1).split(",") if s.strip()}
    return frozenset(ids)


def _suppressed(lines: list[str], file_ids: frozenset[str], f: Finding) -> bool:
    if "all" in file_ids or f.rule in file_ids:
        return True
    for lineno in (f.line, f.line - 1):
        if 1 <= lineno <= len(lines):
            m = _SUPPRESS_RE.search(lines[lineno - 1])
            if m:
                ids = {s.strip() for s in m.group(1).split(",")}
                if f.rule in ids or "all" in ids:
                    return True
    return False


# ---------------------------------------------------------------------------
# Callee recognition: the torch./numpy. function or the tensor method
# ---------------------------------------------------------------------------

_NAMESPACES = ("torch", "numpy")
_LOG_NAMES = {"log", "log2", "log10"}
_EXP_NAMES = {"exp", "expm1"}
_PROD_NAMES = {"prod", "cumprod"}
_ORDERED_REDUCE_NAMES = {"sum", "prod", "cumsum"}
_SUM_NAMES = {"sum"}

# flooring/branching callables that make a zero-capable operand safe
_GUARD_CALL_NAMES = {"maximum", "fmax", "clip", "where", "max", "clamp", "clamp_", "clamp_min",
                     "clamp_min_"}
# clamping callables that bound a log-space quantity before exp
_CLAMP_CALL_NAMES = {"maximum", "minimum", "clip", "max", "amax", "logsumexp", "clamp",
                     "clamp_", "clamp_max", "clamp_max_"}
_GUARD_NAME_RE = re.compile(r"(eps|tiny|smooth|_MIN\b|_min\b)", re.IGNORECASE)

# dtype conversions that keep the value (and so its guards)
_CONVERSIONS = {"to", "float", "double", "half", "bfloat16", "type"}
# tensor methods that convert to an integer (or boolean) dtype
_INT_METHODS = {"long", "int", "short", "byte", "char", "bool"}
# integer (and boolean) dtype names: torch.int64, np.uint32, torch.bool
_INT_DTYPES = ("int", "uint", "bool", "long", "short")

_FLOAT_PRODUCERS = {
    "log",
    "log2",
    "log10",
    "log1p",
    "exp",
    "expm1",
    "sigmoid",
    "logit",
    "sum",
    "mean",
    "prod",
    "divide",
    "true_divide",
    "sqrt",
    "dot",
    "einsum",
    "logaddexp",
}

_FOLD_CONTRACT_NAMES = ("fold_logit", "tf_fold")


def _receiver_is_module(mod: ModuleLint, expr: ast.expr) -> bool:
    """Whether an attribute chain starts at an imported name (``torch.x``,
    ``np.x``, ``math.x``): a function of a module, not a tensor method."""
    while isinstance(expr, ast.Attribute):
        expr = expr.value
    return isinstance(expr, ast.Name) and expr.id in mod.aliases


def _op(mod: ModuleLint, call: ast.Call, names: set[str]):
    """``(short name, operand)`` when ``call`` is ``torch.<name>(x)`` or
    ``numpy.<name>(x)`` for a name in ``names``, or the tensor method
    ``x.<name>(...)`` (a log method takes no positional argument:
    ``logger.log(level, msg)`` is not a log); else None."""
    func = call.func
    if not isinstance(func, ast.Attribute) or func.attr not in names:
        return None
    if _receiver_is_module(mod, func.value):
        canon = mod.canonical(func) or ""
        if canon.rsplit(".", 1)[0] not in _NAMESPACES:
            return None
        if call.args:
            return func.attr, call.args[0]
        kw = next((k.value for k in call.keywords if k.arg == "input"), None)
        return (func.attr, kw) if kw is not None else None
    if call.args and func.attr in _LOG_NAMES:
        return None
    return func.attr, func.value


def _call_name(mod: ModuleLint, call: ast.Call) -> str | None:
    """Last path component of the callee (alias-resolved when possible)."""
    canon = mod.canonical(call.func)
    if canon:
        return canon.rsplit(".", 1)[-1]
    if isinstance(call.func, ast.Attribute):
        return call.func.attr
    if isinstance(call.func, ast.Name):
        return call.func.id
    return None


def _unconverted(expr: ast.expr) -> ast.expr:
    """``expr`` with its dtype conversions peeled off: ``u.to(torch.float64)``
    and ``u.double()`` are ``u`` for guard recognition."""
    while (isinstance(expr, ast.Call) and isinstance(expr.func, ast.Attribute)
           and expr.func.attr in _CONVERSIONS):
        expr = expr.func.value
    return expr


def _int_dtype_src(mod: ModuleLint, node: ast.expr) -> bool:
    src = ast.get_source_segment(mod.source, node) or ""
    return "int" in src or "bool" in src


def _int_typed(mod: ModuleLint, fn: ast.AST | None, expr: ast.expr, _depth: int = 0) -> bool:
    """Whether an expression is an integer (or boolean) array by local
    syntax: a ``dtype=`` keyword or a positional dtype naming an integer
    type (``np.asarray(x, np.int64)``), a conversion to one
    (``x.to(torch.int64)``, ``x.long()``), a comparison, or a name whose
    assignments in the same function (``None`` aside) are all such."""
    if _depth > 4:
        return False
    if isinstance(expr, ast.Compare):
        return True
    if isinstance(expr, ast.Call):
        for kw in expr.keywords:
            if kw.arg == "dtype":
                return _int_dtype_src(mod, kw.value)
        func = expr.func
        if isinstance(func, ast.Attribute) and func.attr in _INT_METHODS and not expr.args:
            return True
        return any(isinstance(a, ast.Attribute) and a.attr.startswith(_INT_DTYPES)
                   for a in expr.args)
    if isinstance(expr, ast.Name):
        vals = [v for v in _assignments(mod, fn, expr.id)
                if not (isinstance(v, ast.Constant) and v.value is None)]
        return bool(vals) and all(_int_typed(mod, fn, v, _depth + 1) for v in vals)
    return False


def _positive_const(node: ast.expr) -> bool:
    """A positive numeric constant, possibly wrapped in one dtype
    constructor call (``np.float32(0.5)``)."""
    if isinstance(node, ast.Constant):
        return isinstance(node.value, (int, float)) and node.value > 0
    if isinstance(node, ast.Call) and len(node.args) == 1:
        return _positive_const(node.args[0])
    return False


def _contains_guard(mod: ModuleLint, expr: ast.expr) -> bool:
    """Whether an expression is floored away from zero: a guard call
    anywhere inside it, a ``+ positive-constant`` offset, an eps/tiny
    named value, or the expression being a positive constant itself."""
    if _positive_const(expr):
        return True
    for n in ast.walk(expr):
        if isinstance(n, ast.Call):
            name = _call_name(mod, n)
            if name in _GUARD_CALL_NAMES:
                return True
            if name and "safe" in name:
                return True
        if isinstance(n, ast.BinOp) and isinstance(n.op, ast.Add):
            if _positive_const(n.left) or _positive_const(n.right):
                return True
        if isinstance(n, ast.Name) and _GUARD_NAME_RE.search(n.id):
            return True
        if isinstance(n, ast.Attribute) and _GUARD_NAME_RE.search(n.attr):
            return True
    return False


def _assignments(mod: ModuleLint, fn: ast.AST | None, name: str):
    """Values assigned to ``name`` in the given function scope (or at
    module level when ``fn`` is None)."""
    scope = fn if fn is not None else mod.tree
    values: list[ast.expr] = []
    for n in ast.walk(scope):
        if fn is not None and mod.enclosing_fn(n) is not fn:
            continue
        if fn is None and mod.enclosing_fn(n) is not None:
            continue
        if isinstance(n, ast.Assign):
            targets = n.targets
        elif isinstance(n, (ast.AugAssign, ast.AnnAssign)) and n.value:
            targets = [n.target]
        else:
            continue
        for t in targets:
            if name in _bound_names(t):
                values.append(n.value)
                break
    return values


def _name_guarded(mod: ModuleLint, fn: ast.AST | None, name: str) -> bool:
    """A bare name counts as guarded when at least one local assignment to
    it is itself a guarded expression (flow-insensitive by design: the
    floor-then-use idiom assigns the floored value back to the name)."""
    return any(_contains_guard(mod, v) for v in _assignments(mod, fn, name))


def _guarded(mod: ModuleLint, fn: ast.AST | None, expr: ast.expr) -> bool:
    """An operand that is guarded itself, or through its conversions, or a
    bare name with a guarded assignment."""
    if _contains_guard(mod, expr):
        return True
    inner = _unconverted(expr)
    if inner is not expr and _contains_guard(mod, inner):
        return True
    return isinstance(inner, ast.Name) and _name_guarded(mod, fn, inner.id)


def _mentions_name(mod: ModuleLint, test: ast.expr, names: set[str]) -> bool:
    src = ast.get_source_segment(mod.source, test) or ""
    return any(re.search(rf"\b{re.escape(nm)}\b", src) for nm in names)


def _branch_guarded(mod: ModuleLint, node: ast.AST, fn: ast.AST | None, names: set[str]) -> bool:
    """Whether a conditional protects this use of the named values: an
    ancestor if/ternary/while testing one of them, or an early-return /
    raise / assert on one of them anywhere in the same function."""
    if not names:
        return False
    cur: ast.AST | None = node
    while cur is not None:
        if isinstance(cur, (ast.If, ast.IfExp, ast.While)):
            if _mentions_name(mod, cur.test, names):
                return True
        cur = mod.parents.get(cur)
    scope = fn if fn is not None else mod.tree
    for n in ast.walk(scope):
        if fn is not None and mod.enclosing_fn(n) is not fn:
            continue
        if isinstance(n, ast.Assert) and _mentions_name(mod, n.test, names):
            return True
        if isinstance(n, ast.If) and _mentions_name(mod, n.test, names):
            if any(isinstance(s, (ast.Return, ast.Raise, ast.Continue)) for s in n.body):
                return True
    return False


def _logit_ratio(arg: ast.expr) -> bool:
    """The ``p / (1 - p)`` shape inside a log call (NL007's territory)."""
    return (
        isinstance(arg, ast.BinOp)
        and isinstance(arg.op, ast.Div)
        and isinstance(arg.right, ast.BinOp)
        and isinstance(arg.right.op, ast.Sub)
        and isinstance(arg.right.left, ast.Constant)
        and arg.right.left.value == 1
    )


def _traced_info(mod: ModuleLint, node: ast.AST):
    """FnInfo of the nearest enclosing device function, else None."""
    fn = mod.enclosing_fn(node)
    while fn is not None:
        info = mod.fns.get(fn)
        if info is not None and info.traced:
            return info
        fn = mod.enclosing_fn(fn)
    return None


def _calls(mod: ModuleLint):
    for node in ast.walk(mod.tree):
        if isinstance(node, ast.Call):
            yield node


# ---------------------------------------------------------------------------
# Rules
# ---------------------------------------------------------------------------


def _check_nl001(mod: ModuleLint):
    for node in _calls(mod):
        hit = _op(mod, node, _LOG_NAMES)
        if hit is None:
            continue
        short, arg = hit
        if _logit_ratio(_unconverted(arg)):
            continue  # NL007 owns the logit round-trip shape
        if _guarded(mod, mod.enclosing_fn(node), arg):
            continue
        yield mod.finding(
            "NL001",
            node,
            f"raw {short}() on an unguarded operand: probabilities/counts "
            "here can legitimately reach exactly 0, and log(0) = -inf",
            hint="floor the operand (torch.clamp(x, min=torch.finfo(x.dtype).tiny)) "
            "or use models.fellegi_sunter._safe_log",
        )


def _check_nl002(mod: ModuleLint):
    for node in _calls(mod):
        hit = _op(mod, node, _EXP_NAMES)
        if hit is None:
            continue
        info = _traced_info(mod, node)
        if info is None:
            continue
        short, arg = hit
        if not mod.mentions_device(arg, set(info.traced_names)):
            continue
        clamped = any(
            isinstance(n, ast.Call) and _call_name(mod, n) in _CLAMP_CALL_NAMES
            for n in ast.walk(arg)
        )
        if clamped:
            continue
        yield mod.finding(
            "NL002",
            node,
            f"{short}() of an unbounded device log-space quantity: "
            "log-Bayes sums grow with column count and exp overflows "
            "f32 at ~88.7",
            hint="max-shift first (x - x.amax()), clamp, or stay in log "
            "space (torch.logaddexp / torch.logsumexp)",
        )


def _zero_capable(mod: ModuleLint, fn: ast.AST | None, den: ast.expr,
                  _seen: frozenset = frozenset()) -> str | None:
    """Why a denominator can be exactly zero, or None if it cannot be
    classified as zero-capable from local syntax."""
    den = _unconverted(den)
    if isinstance(den, ast.Call):
        hit = _op(mod, den, _SUM_NAMES)
        if hit is not None or (isinstance(den.func, ast.Name) and den.func.id == "sum"):
            # x.sum() where x itself was floored is fine
            operand = hit[1] if hit is not None else None
            if operand is not None and _guarded(mod, fn, operand):
                return None
            return "a sum over possibly-empty/zero terms"
        return None
    if isinstance(den, ast.BinOp) and isinstance(den.op, ast.Add):
        if not (isinstance(den.left, ast.Constant) or isinstance(den.right, ast.Constant)):
            return "an a + b of computed terms that can both be 0"
        return None
    if isinstance(den, ast.Name):
        vals = _assignments(mod, fn, den.id)
        if not vals or den.id in _seen:
            return None
        if _name_guarded(mod, fn, den.id):
            return None
        for v in vals:
            reason = _zero_capable(mod, fn, v, _seen | {den.id})
            if reason is not None:
                return reason
        return None
    return None


def _check_nl003(mod: ModuleLint):
    for node in ast.walk(mod.tree):
        if not isinstance(node, ast.BinOp) or not isinstance(node.op, ast.Div):
            continue
        den = node.right
        fn = mod.enclosing_fn(node)
        reason = _zero_capable(mod, fn, den)
        if reason is None:
            continue
        if _contains_guard(mod, den):
            continue
        names = {n.id for n in ast.walk(den) if isinstance(n, ast.Name)}
        if _branch_guarded(mod, node, fn, names):
            continue
        yield mod.finding(
            "NL003",
            node,
            f"division by {reason} with no guard: empty buckets / "
            "all-null batches make this denominator exactly 0",
            hint="floor it (torch.clamp(den, min=eps) on the device, "
            "max(den, 1) on host counts) or branch on it first",
        )


def _check_nl004(mod: ModuleLint):
    for node in _calls(mod):
        hit = _op(mod, node, _PROD_NAMES)
        if hit is None or _traced_info(mod, node) is None:
            continue
        fn = mod.enclosing_fn(node)
        short, arg = hit
        if _int_typed(mod, fn, node) or _int_typed(mod, fn, arg):
            continue  # a counting product is exact
        yield mod.finding(
            "NL004",
            node,
            f"{short}() over float values in device code: linear-space "
            "probability products underflow f32 after a few dozen "
            "small factors",
            hint="accumulate _safe_log values and exponentiate once "
            "(or pin an integer dtype if this is a counting product)",
        )


def _check_nl005(mod: ModuleLint):
    def floaty(e: ast.expr, fn) -> bool:
        if isinstance(e, ast.Constant) and isinstance(e.value, float):
            return True
        if isinstance(e, ast.Call):
            hit = _op(mod, e, _FLOAT_PRODUCERS)
            if hit is None:
                return False
            # an integer-pinned reduction, or one over integer values
            return not (_int_typed(mod, fn, e) or _int_typed(mod, fn, hit[1]))
        return False

    for node in ast.walk(mod.tree):
        if not isinstance(node, ast.Compare):
            continue
        if not any(isinstance(op, (ast.Eq, ast.NotEq)) for op in node.ops):
            continue
        if _traced_info(mod, node) is None:
            continue
        fn = mod.enclosing_fn(node)
        sides = [node.left, *node.comparators]
        if not any(floaty(s, fn) for s in sides):
            continue
        yield mod.finding(
            "NL005",
            node,
            "exact ==/!= against a computed float in device code: "
            "last-ulp differences across reduce orders/precisions make "
            "the comparison device-dependent",
            hint="compare with a tolerance (torch.abs(a - b) <= tol) or "
            "restructure on integer codes",
        )


def _check_nl006(mod: ModuleLint):
    for fn_node, info in mod.fns.items():
        in_contract = False
        for n in ast.walk(fn_node):
            ident = None
            if isinstance(n, ast.Name):
                ident = n.id
            elif isinstance(n, ast.Attribute):
                ident = n.attr
            if ident and any(k in ident for k in _FOLD_CONTRACT_NAMES):
                in_contract = True
                break
        if not in_contract:
            continue
        for n in ast.walk(fn_node):
            if mod.enclosing_fn(n) is not fn_node or not isinstance(n, ast.Call):
                continue
            hit = _op(mod, n, _ORDERED_REDUCE_NAMES)
            if hit is None or _int_typed(mod, fn_node, n) or _int_typed(mod, fn_node, hit[1]):
                continue  # an integer reduction is exact in any order
            yield mod.finding(
                "NL006",
                n,
                f"{hit[0]}() inside `{info.qualname}`, a path bound to "
                "fold_logit's left-to-right order: reduce trees diverge "
                "from the running accumulator in the last ulp past ~2 "
                "columns, silently breaking serve<->offline bit-parity",
                hint="accumulate column by column in fold_logit's order",
            )


def _check_nl007(mod: ModuleLint):
    for node in _calls(mod):
        arg: ast.expr | None = None
        hit = _op(mod, node, {"logit"})
        if hit is not None:
            if any(k.arg == "eps" for k in node.keywords) or len(node.args) > 1:
                continue  # torch.logit(p, eps) clamps p into [eps, 1 - eps]
            arg = hit[1]
        else:
            hit = _op(mod, node, _LOG_NAMES)
            if hit is not None and _logit_ratio(_unconverted(hit[1])):
                arg = hit[1]
        if arg is None:
            continue
        fn = mod.enclosing_fn(node)
        clamped = (
            _contains_guard(mod, arg)
            or any(
                isinstance(n, ast.Call)
                and _call_name(mod, n) in ("clip", "minimum", "clamp", "clamp_max")
                for n in ast.walk(arg)
            )
            or any(isinstance(n, ast.Name) and _name_guarded(mod, fn, n.id)
                   for n in ast.walk(arg))
        )
        if clamped:
            continue
        yield mod.finding(
            "NL007",
            node,
            "unclamped sigmoid->logit round-trip: match probabilities "
            "saturate to exactly 1.0 in f32 beyond ~17 logits of "
            "evidence, so log(p / (1 - p)) returns +/-inf",
            hint="clamp into [eps, 1 - eps] first (torch.logit(p, eps=...)), "
            "or carry match_logit/fold_logit instead of re-deriving the logit",
        )


_F32_MAX = float(np.finfo(np.float32).max)
_F32_TINY = float(np.finfo(np.float32).tiny)


def _check_nl008(mod: ModuleLint):
    for node in ast.walk(mod.tree):
        if not isinstance(node, ast.Constant) or not isinstance(node.value, float):
            continue
        v = abs(node.value)
        if v == 0.0 or _F32_TINY <= v <= _F32_MAX:
            continue
        if _traced_info(mod, node) is None:
            continue
        kind = "overflows to inf" if v > _F32_MAX else "flushes to 0/denormal"
        yield mod.finding(
            "NL008",
            node,
            f"float literal {node.value!r} {kind} at float32: the kernels "
            "evaluate this source at f32 on the card",
            hint="derive the constant from torch.finfo(dtype) "
            "(.tiny/.max/.eps) so it tracks the kernel's width",
        )


NL_CHECKS = {
    "NL001": _check_nl001,
    "NL002": _check_nl002,
    "NL003": _check_nl003,
    "NL004": _check_nl004,
    "NL005": _check_nl005,
    "NL006": _check_nl006,
    "NL007": _check_nl007,
    "NL008": _check_nl008,
}

# ---------------------------------------------------------------------------
# Runners (torchlint.lint_source / lint_paths' counterparts)
# ---------------------------------------------------------------------------


def numlint_source(path: str, source: str, rules=None, roots=None) -> list[Finding]:
    """Run the NL rules over one module's source; returns unsuppressed
    findings. ``roots``: its device entry functions' qualnames (default:
    :data:`.torchlint.DEVICE_ROOTS`). Unparseable sources return no
    findings here: torchlint reports them as JL000 in the same CLI run."""
    if rules is not None:
        for rid in rules:
            if rid not in NL_RULES:
                raise KeyError(rid)
    try:
        mod = ModuleLint(path, source, roots)
    except (SyntaxError, ValueError):
        return []
    file_ids = _file_suppressions(mod.lines)
    out: list[Finding] = []
    for rid, check in NL_CHECKS.items():
        if rules is not None and rid not in rules:
            continue
        for f in check(mod):
            if not _suppressed(mod.lines, file_ids, f):
                out.append(f)
    return out


def numlint_paths(paths, rules=None) -> Report:
    """Numlint every .py file under the given paths into one Report."""
    report = Report()
    for file_path in iter_python_files(paths):
        try:
            with open(file_path, encoding="utf-8") as fh:
                source = fh.read()
        except UnicodeDecodeError:
            # torchlint reports the JL000 for the same file in the same run
            report.files_checked += 1
            continue
        report.extend(numlint_source(file_path, source, rules))
        report.files_checked += 1
    return report
