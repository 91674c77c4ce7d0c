"""JL004 / JL005: dtype discipline.

JL004 — unpinned constructors. ``torch.zeros(n)`` follows
``torch.get_default_dtype()``, ``torch.arange(n)`` and ``torch.tensor(3)``
are int64, ``torch.from_numpy(np.zeros(n))`` is float64: a kernel whose
internal dtypes depend on ambient defaults, or on numpy's, moves twice the
bytes it meant to and gives a different program per configuration (the
reference's x64-dependent ``jnp.arange``). Constructors must pin
``dtype=`` (the ``*_like`` / ``new_*`` forms inherit an input's).

JL005 — explicit float64 in device code. float64 halves the card's
arithmetic rate and doubles every byte moved; the sanctioned uses are
gated on the float64 setting (recognised by the gate's condition naming
f64/float64) or carry a line suppression with the reason (the port's
float64 accumulators: ``index_add_`` is atomic on the card, so exact sums
need float64). Host numpy float64 (pandas interop) is out of scope.
"""

from __future__ import annotations

import ast

from . import rule

# constructors whose dtype follows torch's defaults: never pinned without
# dtype= (torch takes it by keyword only)
_CTORS_ALWAYS = {
    "torch.zeros",
    "torch.ones",
    "torch.empty",
    "torch.full",
    "torch.arange",
    "torch.linspace",
}
# constructors that inherit an array argument's dtype: unpinned only when
# fed a bare Python literal
_CTORS_LITERAL = {"torch.tensor", "torch.as_tensor"}
# numpy constructors (float64/int64 by default) -> positional args that,
# when present, include the dtype
_NP_CTORS = {
    "numpy.zeros": 2,
    "numpy.ones": 2,
    "numpy.empty": 2,
    "numpy.full": 3,
    "numpy.arange": 4,
    "numpy.linspace": 6,
}
_NP_LITERAL = {"numpy.array": 2, "numpy.asarray": 2}

_NUMERIC_ATTRS = {"math.nan", "math.inf", "math.pi", "numpy.nan", "numpy.inf", "numpy.pi"}

_F64_ATTRS = {"torch.float64", "torch.double", "torch.complex128"}
_NP_F64 = {"numpy.float64", "numpy.complex128"}


def _is_numeric_literal(mod, node: ast.expr) -> bool:
    """A bare Python number (or container of them) whose tensor dtype
    would be decided by torch's defaults rather than by data."""
    if isinstance(node, ast.Constant):
        return isinstance(node.value, (int, float)) and not isinstance(node.value, bool)
    if isinstance(node, ast.UnaryOp):
        return _is_numeric_literal(mod, node.operand)
    if isinstance(node, (ast.Tuple, ast.List)):
        return any(_is_numeric_literal(mod, e) for e in node.elts)
    if isinstance(node, ast.Call) and isinstance(node.func, ast.Name):
        return node.func.id in ("float", "int")
    if isinstance(node, (ast.Attribute, ast.Name)):
        return mod.canonical(node) in _NUMERIC_ATTRS
    return False


def _has_dtype(call: ast.Call, positional_cutoff: int = 99) -> bool:
    return any(kw.arg == "dtype" for kw in call.keywords) or len(call.args) >= positional_cutoff


def _unpinned_numpy(mod, node: ast.expr) -> str | None:
    """The numpy constructor of ``node`` when it leaves its dtype to numpy's
    default, else None."""
    if not isinstance(node, ast.Call):
        return None
    canon = mod.canonical(node.func)
    if canon in _NP_CTORS and not _has_dtype(node, _NP_CTORS[canon]):
        return canon
    if canon in _NP_LITERAL and not _has_dtype(node, _NP_LITERAL[canon]):
        if node.args and _is_numeric_literal(mod, node.args[0]):
            return canon
    return None


@rule(
    "JL004",
    "tensor constructor without a pinned dtype",
    "default dtypes follow torch's/numpy's defaults (float32/int64/float64); pin dtype=",
)
def check_unpinned_ctors(mod):
    for node in ast.walk(mod.tree):
        if not isinstance(node, ast.Call):
            continue
        canon = mod.canonical(node.func)
        if canon in _CTORS_ALWAYS:
            if not _has_dtype(node):
                yield mod.finding(
                    "JL004", node,
                    f"{canon} without an explicit dtype (torch's default: int64 for "
                    "integers, the default float type otherwise)",
                    "pass dtype= (e.g. torch.int32 / an input's .dtype)",
                )
        elif canon in _CTORS_LITERAL:
            if not _has_dtype(node) and node.args and _is_numeric_literal(mod, node.args[0]):
                yield mod.finding(
                    "JL004", node,
                    f"{canon} of a bare Python number without dtype (int64 or the "
                    "default float type)",
                    "pass dtype=",
                )
        elif canon == "torch.from_numpy" and node.args:
            inner = _unpinned_numpy(mod, node.args[0])
            if inner is not None:
                yield mod.finding(
                    "JL004", node,
                    f"torch.from_numpy of {inner} without a dtype (numpy's default: "
                    "float64 / int64)",
                    "pin the numpy array's dtype= (e.g. np.int32)",
                )


@rule(
    "JL005",
    "explicit float64 in device code",
    "float64 halves the card's rate and doubles its bytes; gate on the float64 setting",
)
def check_float64(mod):
    for info in mod.fns.values():
        if not info.traced:
            continue
        for node in mod.own_nodes(info.node):
            if isinstance(node, ast.Call) and isinstance(node.func, ast.Attribute) \
                    and node.func.attr == "double" and not node.args:
                if not mod.f64_gated(node):
                    yield mod.finding(
                        "JL005", node,
                        f".double() in device function '{info.qualname}' outside a "
                        "float64 gate",
                        "keep the input's dtype, or gate on the float64 setting",
                    )
                continue
            if not isinstance(node, (ast.Attribute, ast.Name)):
                continue
            canon = mod.canonical(node)
            parent = mod.parents.get(node)
            if canon in _F64_ATTRS:
                # comparing a dtype AGAINST float64 (a mode test) makes no data
                if isinstance(parent, ast.Compare) or mod.f64_gated(node):
                    continue
                yield mod.finding(
                    "JL005", node,
                    f"{canon} in device function '{info.qualname}' outside a float64 gate",
                    "derive the dtype from an input, or gate on the float64 setting",
                )
            elif canon in _NP_F64 and isinstance(parent, ast.Call) and mod.is_device_ns(
                    mod.canonical(parent.func)) and not mod.f64_gated(node):
                yield mod.finding(
                    "JL005", node,
                    f"{canon} passed into a torch call in device function "
                    f"'{info.qualname}' outside a float64 gate",
                    "use torch dtypes derived from inputs, or gate on float64",
                )
