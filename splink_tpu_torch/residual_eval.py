"""Safe, vectorised evaluator for residual blocking predicates.

`compat_sql.sql_predicate_to_python` translates the non-equality part of a
blocking rule into a small python expression over ``l``/``r`` column
namespaces. Rather than ``eval`` over object arrays, this module runs it
through a typed AST interpreter:

  * only a whitelisted node grammar is accepted (no ``eval``, no attribute
    access, no arbitrary calls) — the expression is config-derived, but it
    deserves an interpreter, not a prayer;
  * string columns compare through cached lexicographic *rank* arrays
    (float64, NaN for null; data.py ``string_ranks``), so =, <>,
    <, <= etc. run as numeric SIMD compares instead of per-element python
    object comparisons — order-isomorphic to the string comparison SQL would
    do. String literals map to a (possibly half-integer) virtual rank by
    binary search. Cross-column string compares (different vocabularies)
    fall back to object arrays with explicit null masks;
  * comparisons follow SQL three-valued logic: any null operand makes the
    atom UNKNOWN, and UNKNOWN propagates through AND/OR/NOT by Kleene rules,
    with rows kept only when the predicate is known-true. (This also fixes
    ``l.x <> r.x`` keeping null rows, which numpy's NaN != NaN would do.)
  * SQL scalar functions (substr, lower/upper, trim, concat / ``||``,
    coalesce/ifnull, length, left/right, reverse, dmetaphone, round, cast,
    ...) evaluate through derived_keys.PairEval — the SAME implementation
    that computes derived blocking join keys and the device residual
    compiler's precomputed operands, so one definition of each function's
    (null) semantics serves all three consumers.

The reference gets all of this from the SQL engine for free
(splink/blocking.py:141-158); here it is ~200 lines that run
at memory bandwidth on the host.
"""

from __future__ import annotations

import ast
from dataclasses import dataclass

import numpy as np

from .data import EncodedTable


class ResidualEvalError(ValueError):
    pass


@dataclass
class Kleene:
    """A vector of SQL booleans: value + unknown mask."""

    val: np.ndarray  # bool
    unk: np.ndarray  # bool

    def __and__(self, other: "Kleene") -> "Kleene":
        false_a = ~self.val & ~self.unk
        false_b = ~other.val & ~other.unk
        unk = (self.unk | other.unk) & ~false_a & ~false_b
        return Kleene(self.val & other.val & ~unk, unk)

    def __or__(self, other: "Kleene") -> "Kleene":
        true_a = self.val & ~self.unk
        true_b = other.val & ~other.unk
        unk = (self.unk | other.unk) & ~true_a & ~true_b
        return Kleene((self.val | other.val) & ~unk, unk)

    def __invert__(self) -> "Kleene":
        return Kleene(~self.val & ~self.unk, self.unk)

    @property
    def known_true(self) -> np.ndarray:
        return self.val & ~self.unk


class StrOperand:
    """A string column's pair-gathered values, compared by rank when possible."""

    def __init__(self, table: EncodedTable, col: str, rows: np.ndarray):
        self.table = table
        self.col = col
        self.rows = rows
        self._ranks = None
        self._values = None

    @property
    def ranks(self) -> np.ndarray:
        if self._ranks is None:
            ranks, _ = self.table.string_ranks(self.col)
            self._ranks = ranks[self.rows]
        return self._ranks

    @property
    def vocab(self) -> np.ndarray:
        return self.table.string_ranks(self.col)[1]

    @property
    def values(self) -> np.ndarray:
        if self._values is None:
            vals = np.array(self.table.column_values(self.col), dtype=object)
            self._values = vals[self.rows]
        return self._values

    @property
    def null(self) -> np.ndarray:
        return self.table.is_null(self.col)[self.rows]

    def literal_rank(self, s: str) -> float:
        """Rank of a string literal in this column's vocabulary; absent
        literals get the half-integer insertion rank, which orders correctly
        against every real rank and equals none of them."""
        pos = int(np.searchsorted(self.vocab, s))
        if pos < len(self.vocab) and self.vocab[pos] == s:
            return float(pos)
        return pos - 0.5


class RawOperand:
    """Passthrough (non-encoded) column: object arrays, explicit null mask."""

    def __init__(self, table: EncodedTable, col: str, rows: np.ndarray):
        self.table = table
        self.col = col
        self.rows = rows
        self._values = None

    @property
    def values(self) -> np.ndarray:
        if self._values is None:
            vals = np.array(self.table.column_values(self.col), dtype=object)
            self._values = vals[self.rows]
        return self._values

    @property
    def null(self) -> np.ndarray:
        return self.table.is_null(self.col)[self.rows]


class Materialized:
    """A computed string vector (the result of a SQL scalar function like
    substr/lower/concat, evaluated by derived_keys.PairEval): object values
    plus an explicit null mask. Compares like a raw column."""

    def __init__(self, values: np.ndarray, null: np.ndarray):
        self.values = values
        self.null = null


# Operands that carry (values, null) object vectors
_OBJECT_OPERANDS = (StrOperand, RawOperand, Materialized)


_CMP = {
    ast.Eq: np.equal,
    ast.NotEq: np.not_equal,
    ast.Lt: np.less,
    ast.LtE: np.less_equal,
    ast.Gt: np.greater,
    ast.GtE: np.greater_equal,
}

_ARITH = {
    ast.Add: np.add,
    ast.Sub: np.subtract,
    ast.Mult: np.multiply,
    ast.Div: np.divide,
    # fmod, not mod: SQL's % takes the dividend's sign (Spark: -7 % 3 = -1)
    ast.Mod: np.fmod,
    ast.Pow: np.power,
}


class _Evaluator:
    def __init__(self, table: EncodedTable, i: np.ndarray, j: np.ndarray):
        self.table = table
        self.namespaces = {"l": i, "r": j}
        self.n = len(i)

    # -- boolean level ---------------------------------------------------

    def bool_eval(self, node: ast.AST) -> Kleene:
        if isinstance(node, ast.BinOp) and isinstance(node.op, (ast.BitAnd, ast.BitOr)):
            a = self.bool_eval(node.left)
            b = self.bool_eval(node.right)
            return (a & b) if isinstance(node.op, ast.BitAnd) else (a | b)
        if isinstance(node, ast.UnaryOp) and isinstance(node.op, ast.Invert):
            return ~self.bool_eval(node.operand)
        if isinstance(node, ast.Compare):
            return self.compare(node)
        if isinstance(node, ast.Call):
            return self.isna_call(node)
        if isinstance(node, ast.Constant) and isinstance(node.value, bool):
            full = np.full(self.n, bool(node.value))
            return Kleene(full, np.zeros(self.n, bool))
        raise ResidualEvalError(
            f"Unsupported boolean construct in residual predicate: "
            f"{ast.dump(node)[:80]}"
        )

    def isna_call(self, node: ast.Call) -> Kleene:
        if not (isinstance(node.func, ast.Name) and node.func.id == "_isna"):
            raise ResidualEvalError(
                "Only _isna(...) may appear as a boolean call in a residual"
            )
        (arg,) = node.args
        operand = self.value_eval(arg)
        if isinstance(operand, _OBJECT_OPERANDS):
            null = operand.null
        elif isinstance(operand, np.ndarray):
            null = np.isnan(operand)
        else:
            raise ResidualEvalError("_isna of a literal is not meaningful")
        return Kleene(null.copy(), np.zeros(self.n, bool))

    # -- comparison level ------------------------------------------------

    def compare(self, node: ast.Compare) -> Kleene:
        operands = [node.left, *node.comparators]
        out: Kleene | None = None
        for op, ln, rn in zip(node.ops, operands, operands[1:]):
            if type(op) not in _CMP:
                raise ResidualEvalError(
                    f"Unsupported comparison operator {type(op).__name__}"
                )
            atom = self.compare_pair(_CMP[type(op)], ln, rn)
            out = atom if out is None else (out & atom)
        assert out is not None
        return out

    def compare_pair(self, ufunc, left_node, right_node) -> Kleene:
        lv = self.value_eval(left_node)
        rv = self.value_eval(right_node)

        # string column vs string column
        if isinstance(lv, StrOperand) and isinstance(rv, StrOperand):
            if lv.col == rv.col and lv.table is rv.table:
                return self._numeric_cmp(ufunc, lv.ranks, rv.ranks)
            # different vocabularies: object fallback with explicit nulls
            return self._object_cmp(ufunc, lv.values, lv.null, rv.values, rv.null)
        # string column vs string literal
        if isinstance(lv, StrOperand) and isinstance(rv, str):
            return self._numeric_cmp(ufunc, lv.ranks, lv.literal_rank(rv))
        if isinstance(rv, StrOperand) and isinstance(lv, str):
            return self._numeric_cmp(ufunc, rv.literal_rank(lv), rv.ranks)
        # raw / computed string operand involved: object comparison
        if isinstance(lv, (RawOperand, Materialized)) or isinstance(
            rv, (RawOperand, Materialized)
        ):
            lvals, lnull = self._raw_side(lv)
            rvals, rnull = self._raw_side(rv)
            return self._object_cmp(ufunc, lvals, lnull, rvals, rnull)
        # numeric vs numeric (arrays and/or scalars)
        if isinstance(lv, (np.ndarray, float, int)) and isinstance(
            rv, (np.ndarray, float, int)
        ):
            return self._numeric_cmp(ufunc, lv, rv)
        raise ResidualEvalError(
            f"Type mismatch in residual comparison: {type(lv).__name__} vs "
            f"{type(rv).__name__} (e.g. a numeric column against a string "
            "literal)"
        )

    def _object_cmp(self, ufunc, lvals, lnull, rvals, rnull) -> Kleene:
        """Elementwise object comparison restricted to rows where both sides
        are known — comparing None against a value would TypeError for
        ordering operators."""
        unk = lnull | rnull
        val = np.zeros(self.n, bool)
        known = ~unk
        if known.any():
            try:
                with np.errstate(invalid="ignore"):
                    val[known] = np.asarray(
                        ufunc(lvals[known], rvals[known]), dtype=bool
                    )
            except TypeError as e:
                # e.g. ordering a float column against a computed string —
                # surface a typed error instead of a raw numpy TypeError
                raise ResidualEvalError(
                    f"Incomparable operand types in residual comparison: {e}"
                ) from None
        return Kleene(val, unk)

    def _raw_side(self, v):
        if isinstance(v, _OBJECT_OPERANDS):
            return v.values, v.null
        arr = np.full(self.n, v, dtype=object)
        return arr, np.zeros(self.n, bool)

    def _numeric_cmp(self, ufunc, a, b) -> Kleene:
        with np.errstate(invalid="ignore"):
            val = ufunc(a, b)
        unk = np.zeros(self.n, bool)
        for side in (a, b):
            if isinstance(side, np.ndarray):
                unk |= np.isnan(side)
            elif isinstance(side, float) and np.isnan(side):
                unk |= True
        val = np.broadcast_to(np.asarray(val, bool), (self.n,)).copy()
        return Kleene(val & ~unk, unk)

    # -- value level -----------------------------------------------------

    def value_eval(self, node: ast.AST):
        if isinstance(node, ast.Subscript):
            return self.column(node)
        if isinstance(node, ast.Constant):
            if isinstance(node.value, (int, float, str)):
                return node.value
            raise ResidualEvalError(f"Unsupported literal {node.value!r}")
        if isinstance(node, ast.UnaryOp) and isinstance(node.op, ast.USub):
            v = self.value_eval(node.operand)
            if isinstance(v, (np.ndarray, int, float)):
                return -v
            raise ResidualEvalError("Unary minus on a non-numeric operand")
        if isinstance(node, ast.BinOp) and isinstance(node.op, ast.MatMult):
            # `@` is compat_sql's translation of SQL's `||` concat operator
            return self._derived(node)
        if isinstance(node, ast.BinOp) and type(node.op) in _ARITH:
            a = self._numeric_value(node.left)
            b = self._numeric_value(node.right)
            with np.errstate(invalid="ignore", divide="ignore"):
                return _ARITH[type(node.op)](a, b)
        if isinstance(node, ast.Call):
            return self.value_call(node)
        raise ResidualEvalError(
            f"Unsupported value construct: {ast.dump(node)[:80]}"
        )

    def value_call(self, node: ast.Call):
        if isinstance(node.func, ast.Name) and node.func.id == "abs":
            (arg,) = node.args
            return np.abs(self._numeric_value(arg))
        return self._derived(node)

    def _derived(self, node: ast.AST):
        """SQL scalar functions (substr/lower/upper/trim/concat/coalesce/
        length/left/right/reverse/dmetaphone/round/cast, plus ``@`` = SQL
        ``||``) evaluate through derived_keys.PairEval — ONE implementation
        of the function semantics shared with blocking join keys and the
        device residual compiler (pairgen._ResCompiler)."""
        from .derived_keys import DerivedKeyError, PairEval, pyast_to_keynode

        try:
            knode = pyast_to_keynode(node)
            kind, vals, null = PairEval(
                self.table, self.namespaces["l"], self.namespaces["r"]
            ).eval(knode)
        except DerivedKeyError as e:
            raise ResidualEvalError(str(e)) from None
        if kind == "num":
            out = vals.copy()
            out[null] = np.nan
            return out
        return Materialized(vals, null)

    def _numeric_value(self, node: ast.AST) -> np.ndarray | float | int:
        v = self.value_eval(node)
        if isinstance(v, (np.ndarray, int, float)):
            return v
        if isinstance(v, _OBJECT_OPERANDS):
            # SQL implicitly casts in numeric contexts (CAST(col AS DOUBLE));
            # unparseable values and nulls become NaN -> comparison unknown.
            import pandas as pd

            vals = pd.to_numeric(
                pd.Series(v.values), errors="coerce"
            ).to_numpy(dtype=np.float64, copy=True)
            vals[v.null] = np.nan
            return vals
        raise ResidualEvalError(
            f"Expected a numeric operand, got {type(v).__name__}"
        )

    def column(self, node: ast.Subscript):
        if not (
            isinstance(node.value, ast.Name)
            and node.value.id in self.namespaces
            and isinstance(node.slice, ast.Constant)
            and isinstance(node.slice.value, str)
        ):
            raise ResidualEvalError("Only l[\"col\"] / r[\"col\"] subscripts allowed")
        col = node.slice.value
        rows = self.namespaces[node.value.id]
        table = self.table
        if col in table.strings:
            return StrOperand(table, col, rows)
        if col in table.numerics:
            nc = table.numerics[col]
            vals = nc.values_f64[rows].copy()
            vals[nc.null_mask[rows]] = np.nan
            return vals
        if col in table.raw:
            return RawOperand(table, col, rows)
        raise ResidualEvalError(f"Unknown column {col!r} in residual predicate")


def evaluate_residual(
    table: EncodedTable, residual: str, i: np.ndarray, j: np.ndarray
) -> np.ndarray:
    """Boolean keep-mask for candidate pairs (i, j) under the translated
    residual predicate, with SQL null semantics (UNKNOWN rows dropped)."""
    try:
        tree = ast.parse(residual, mode="eval")
    except SyntaxError as e:  # pragma: no cover - translation produces valid py
        raise ResidualEvalError(f"Cannot parse residual: {residual!r}") from e
    result = _Evaluator(table, i, j).bool_eval(tree.body)
    return result.known_true
