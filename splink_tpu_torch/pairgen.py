"""Device-side candidate-pair generation: the virtual pair index.

The port of splink_tpu/pairgen.py (single device; every mesh branch is
left out). Pairs are DECODED ON THE DEVICE from per-rule group structure,
the sequential-rule dedup becomes a device mask, and the gamma/pattern
program consumes them in the same pass: per batch the host hands over a
start position and nothing else, and no pair index ever materialises on
the host.

Decomposition. Each rule's non-null key groups (rows sorted by uid rank
then grouped by key code — host blocking's layout, so orientation is free)
split into UNITS of at most ``CHUNK`` rows per side:

  * triangle  — all unordered pairs within one chunk;
  * rectangle — all cross pairs between two chunks (two chunks of one
    group, or a left x right chunk pair in link_only).

The reference bounds the unit extent so that its decode is exact in int32
and float32 (a triangle's discriminant below 2^24, a rectangle's offset
below 2^23). The card has int64 and float64, so here a position decodes in
int64 with a float64 square root and the same +-1 integer correction; the
decoded (i, j) equal the reference's position for position, and the unit
extents (and so the units, the positions and the batch boundaries) stay
the reference's.

Masking replaces dropping: a pair whose uid keys collide (duplicate-uid
inputs) or for which an EARLIER rule's predicate holds (the reference's
``AND NOT ifnull(prev, false)``) takes the sentinel pattern id
``n_patterns`` and falls out of the histogram; the output stream filters
the sentinel when it decodes chunks on the host. The gamma program still
runs on masked positions (so the masked Jaro-Winkler launch sees them too).

Supported: all three link types — link_and_dedupe self-joins the
concatenated table ordered by (source, uid), link_only tiles left x right
group rectangles. Residual (non-equality) predicates compile to device
masks mirroring residual_eval's SQL three-valued semantics: strings compare
via scaled int32 lexicographic ranks (null = -2), numerics as NaN-null
float64 (the card's float64 makes thresholds bit-identical to the host
path). Predicates the device cannot honour reject the plan, and the linker
falls back to host blocking.
"""

from __future__ import annotations

import ast
from dataclasses import dataclass, field

import numpy as np
import torch

from .blocking import _key_codes, _sort_groups, _split_join_keys, _uid_ranks
from .compat_sql import parse_blocking_rule
from .data import EncodedTable
from .gammas import _D2H_DEPTH, _Downloads, pattern_histogram

# Unit extent bound, the reference's (tests shrink it to force multi-chunk
# group splitting on tiny data).
CHUNK = 2048

# A single group may contribute at most this many units (the unit-order
# sort key packs (group, unit-seq) as group*2^20 + seq). k chunks give
# k(k+1)/2 units, so this caps a group at ~1448 chunks ~ 2.9M rows SHARING
# ONE KEY — effectively a constant blocking column; such inputs fall back
# to host blocking.
MAX_UNITS_PER_GROUP = (1 << 20) - 1


@dataclass
class RulePlan:
    """One rule's device-decodable join structure."""

    order: np.ndarray  # (n_valid,) int32 rows sorted by (key code, uid rank)
    ua: np.ndarray  # (U,) int32 unit a-side start into `order`
    la: np.ndarray  # (U,) int32 a-side extent (<= chunk)
    ub: np.ndarray  # (U,) int32 b-side start (== ua for triangles)
    lb: np.ndarray  # (U,) int32 b-side extent
    pc: np.ndarray  # (U+1,) int64 cumulative pair counts over units
    residual: str | None = None  # translated residual predicate source
    residual_fn: object = None  # compiled device closure (see _ResCompiler)

    @property
    def total(self) -> int:
        return int(self.pc[-1]) if len(self.pc) else 0


@dataclass
class VirtualPlan:
    rules: list[RulePlan]
    codes: np.ndarray  # (R, n) int32 per-rule key codes (device dedup mask)
    uid_codes: np.ndarray | None  # (n,) int32 when duplicate uids exist
    n_candidates: int  # sum of rule totals (mask not yet applied)
    res_ops: list[np.ndarray] = field(default_factory=list)  # residual operand arrays
    table: EncodedTable | None = None  # for the host-side residual oracle
    chunk: int = CHUNK  # unit extent the plan was built with
    # device copies of the plan's arrays, uploaded once per device
    _device_arrays: dict = field(default_factory=dict, repr=False)

    def on_device(self, device: torch.device) -> dict:
        """The plan's arrays on ``device`` (uploaded at first use): key
        codes, uid codes, residual operands and each rule's unit tables."""
        key = str(device)
        if key not in self._device_arrays:
            up = lambda a, dt=None: torch.from_numpy(np.ascontiguousarray(a)).to(  # noqa: E731
                device=device, dtype=dt)
            self._device_arrays[key] = {
                "codes": up(self.codes),
                "uid": None if self.uid_codes is None else up(self.uid_codes),
                "res_ops": tuple(up(a) for a in self.res_ops),
                "rules": [
                    {"order": up(rp.order, torch.int64),
                     "units": tuple(up(a, torch.int64) for a in (rp.ua, rp.la, rp.ub, rp.lb)),
                     "pc": up(rp.pc)}
                    for rp in self.rules
                ],
            }
        return self._device_arrays[key]


# --------------------------------------------------------------------------
# Residual predicates -> device closures
# --------------------------------------------------------------------------


class _ResUnsupported(Exception):
    """The residual needs something the device can't honour (object
    columns, cross-vocabulary string compares, string-to-number coercion);
    the plan falls back to host blocking."""


class _ResCompiler:
    """Compile a translated residual predicate (the same python-expression
    surface residual_eval interprets) into a closure fn(i, j, ops) ->
    (val, unk) over torch tensors with SQL three-valued semantics.

    Per-row operand arrays register once per column and upload once per
    run: string columns as scaled int32 ranks (2*rank; null -2 — literals
    bind to 2*pos, or the odd 2*pos-1 insertion rank so an absent literal
    orders correctly and equals nothing), numerics as NaN-null float64.
    """

    _CMPS = {
        ast.Eq: "eq", ast.NotEq: "ne", ast.Lt: "lt", ast.LtE: "le",
        ast.Gt: "gt", ast.GtE: "ge",
    }
    _ARITH = {
        ast.Add: "add", ast.Sub: "sub", ast.Mult: "mul", ast.Div: "div",
        ast.Mod: "mod", ast.Pow: "pow",
    }

    def __init__(self, table: EncodedTable, ops: list[np.ndarray],
                 op_index: dict, aux: dict):
        self.table = table
        self.ops = ops  # shared across rules; uploaded once
        self.op_index = op_index  # key -> position in ops
        self.aux = aux  # vocab arrays for literal binding (host-only)

    def _register(self, key, build) -> int:
        if key not in self.op_index:
            self.op_index[key] = len(self.ops)
            self.ops.append(build())
        return self.op_index[key]

    def _col_values_null(self, col):
        if isinstance(col, tuple) and col[0] == "expr":
            # a derived pseudo-column: a single-side SQL function
            # subexpression precomputed host-side (see _derived_value)
            from .derived_keys import key_values_object

            return key_values_object(self.table, col[1])
        vals = np.asarray(self.table.column_values(col), dtype=object)
        null = self.table.is_null(col)
        return vals, null

    def _vocab(self, col: str) -> np.ndarray:
        """Same-column / literal-binding vocabulary: ENCODED string columns
        use the table's string_ranks vocabulary (which str()-coerces,
        exactly what the host's StrOperand compares through); raw
        passthrough columns sort their raw object values (the host's
        RawOperand compares those elementwise)."""
        key = ("vocab", col)
        if key not in self.aux:
            if col in self.table.strings:
                self.aux[key] = self.table.string_ranks(col)[1]
            else:
                vals, null = self._col_values_null(col)
                try:
                    self.aux[key] = np.unique(vals[~null])
                except TypeError as e:  # mixed incomparable types
                    raise _ResUnsupported(f"unsortable column {col!r}") from e
        return self.aux[key]

    def _str_ranks_scaled(self, col: str) -> int:
        """Scaled rank array (2*rank; null -2), order-isomorphic to the
        host's same-column comparison for this column kind."""
        self._vocab(col)  # validate sortability before registering

        def build():
            if col in self.table.strings:
                ranks, _ = self.table.string_ranks(col)
                return np.where(
                    np.isnan(ranks), -2, 2 * np.nan_to_num(ranks)
                ).astype(np.int32)
            vocab = self._vocab(col)
            vals, null = self._col_values_null(col)
            out = np.full(len(vals), -2, np.int64)
            nn = ~null
            out[nn] = 2 * np.searchsorted(vocab, vals[nn])
            return out.astype(np.int32)

        return self._register(("str", col), build)

    def _joint_ranks_scaled(self, cola: str, colb: str) -> tuple[int, int]:
        """Two scaled-rank arrays over the UNION of raw-value
        vocabularies — the host compares cross-column operands by their
        raw object VALUES (StrOperand.values), so both sides rank over raw
        values here regardless of encoding. Keys are canonicalised so
        (a, b) and (b, a) share one array pair."""

        def raw_vocab(col):
            vals, null = self._col_values_null(col)
            try:
                return np.unique(vals[~null])
            except TypeError as e:
                raise _ResUnsupported(f"unsortable column {col!r}") from e

        # key=repr: plain column names (str) and derived pseudo-columns
        # (("expr", canon) tuples) are not mutually orderable
        c1, c2 = sorted((cola, colb), key=repr)
        union_key = ("joint_vocab", c1, c2)
        if union_key not in self.aux:
            try:
                self.aux[union_key] = np.unique(
                    np.concatenate([raw_vocab(c1), raw_vocab(c2)])
                )
            except TypeError as e:
                raise _ResUnsupported(
                    f"unsortable column pair {cola!r}/{colb!r}"
                ) from e
        union = self.aux[union_key]

        def build_for(col):
            def build():
                vals, null = self._col_values_null(col)
                out = np.full(len(vals), -2, np.int64)
                nn = ~null
                out[nn] = 2 * np.searchsorted(union, vals[nn])
                return out.astype(np.int32)

            return build

        ia = self._register(("joint", c1, c2, c1), build_for(c1))
        ib = self._register(("joint", c1, c2, c2), build_for(c2))
        return (ia, ib) if cola == c1 else (ib, ia)

    def _numeric_vals(self, col: str) -> int:
        def build():
            nc = self.table.numerics[col]
            vals = nc.values_f64.copy()
            vals[nc.null_mask] = np.nan
            return vals

        return self._register(("num", col), build)

    def _coerced_vals(self, col: str) -> int:
        """SQL numeric-context coercion of a string/raw column (the host's
        pd.to_numeric path) — computed host-side once, NaN for null or
        unparseable."""

        def build():
            import pandas as pd

            vals, null = self._col_values_null(col)
            out = pd.to_numeric(pd.Series(vals), errors="coerce").to_numpy(
                dtype=np.float64, copy=True
            )
            out[null] = np.nan
            return out

        return self._register(("coerce", col), build)

    def _literal_rank(self, col: str, lit) -> int:
        vocab = self._vocab(col)
        if len(vocab) and not isinstance(lit, type(vocab[0])):
            # comparing e.g. a number literal against a string column would
            # TypeError on the host too — reject rather than guess
            raise _ResUnsupported(
                f"literal {lit!r} vs column {col!r} type mismatch"
            )
        pos = int(np.searchsorted(vocab, lit))
        if pos < len(vocab) and vocab[pos] == lit:
            return 2 * pos
        return 2 * pos - 1  # odd: orders correctly, equals nothing

    # -- value level: returns ("str", col, op_idx, side) |
    #    ("num", fn(i,j,ops)->float array) | ("lit_s", s) | ("lit_n", x)
    def value(self, node):
        if isinstance(node, ast.Subscript):
            if not (
                isinstance(node.value, ast.Name)
                and node.value.id in ("l", "r")
                and isinstance(node.slice, ast.Constant)
                and isinstance(node.slice.value, str)
            ):
                raise _ResUnsupported("subscript shape")
            col = node.slice.value
            side = node.value.id
            if col in self.table.numerics:
                idx = self._numeric_vals(col)
                return ("num", self._gather_num(idx, side))
            if col in self.table.strings or col in self.table.raw:
                # encoded strings and raw passthrough columns both compare
                # via lexicographic ranks; the rank array registers LAZILY
                # at the use site (a column used only in cross-column
                # compares needs the joint arrays, not its own)
                return ("str", col, None, side)
            raise _ResUnsupported(f"unknown column {col!r}")
        if isinstance(node, ast.Constant):
            if isinstance(node.value, str):
                return ("lit_s", node.value)
            if isinstance(node.value, (int, float)) and not isinstance(
                node.value, bool
            ):
                return ("lit_n", float(node.value))
            raise _ResUnsupported(f"literal {node.value!r}")
        if isinstance(node, ast.UnaryOp) and isinstance(node.op, ast.USub):
            inner = self.value(node.operand)
            if inner[0] == "lit_n":
                return ("lit_n", -inner[1])
            if inner[0] == "num":
                f = inner[1]
                return ("num", lambda i, j, ops: -f(i, j, ops))
            raise _ResUnsupported("unary minus on non-numeric")
        if isinstance(node, ast.BinOp) and type(node.op) in self._ARITH:
            a = self._as_num(self.value(node.left))
            b = self._as_num(self.value(node.right))
            opname = self._ARITH[type(node.op)]

            def arith(i, j, ops, a=a, b=b, opname=opname):
                x, y = a(i, j, ops), b(i, j, ops)
                return {
                    "add": lambda: x + y,
                    "sub": lambda: x - y,
                    "mul": lambda: x * y,
                    "div": lambda: x / y,
                    # host parity: SQL % takes the dividend's sign
                    "mod": lambda: torch.fmod(x, y),
                    "pow": lambda: x**y,
                }[opname]()

            return ("num", arith)
        if isinstance(node, ast.BinOp) and isinstance(node.op, ast.MatMult):
            # `@` = compat_sql's translation of SQL's `||` concat operator
            return self._derived_value(node)
        if isinstance(node, ast.Call):
            if isinstance(node.func, ast.Name) and node.func.id == "abs":
                (arg,) = node.args
                f = self._as_num(self.value(arg))

                def absf(i, j, ops, f=f):
                    return torch.abs(f(i, j, ops))

                return ("num", absf)
            return self._derived_value(node)
        raise _ResUnsupported(f"value node {type(node).__name__}")

    def _derived_value(self, node):
        """Single-side SQL scalar function subexpressions (substr, lower,
        concat, coalesce, length, ..., and ``@`` = SQL ``||``) precompute
        host-side into a per-row derived operand via derived_keys — the
        SAME implementation of the function semantics the host residual
        interpreter and the blocking join keys use — then compare on
        device by rank like any column. Functions mixing both sides in one
        call (concat(l.a, r.b)) have no per-row precompute; those reject
        the plan (host fallback)."""
        from .derived_keys import (
            DerivedKeyError,
            canonical,
            evaluate_key,
            expr_sides,
            pyast_to_keynode,
            strip_side,
        )

        try:
            knode = pyast_to_keynode(node)
        except DerivedKeyError as e:
            raise _ResUnsupported(str(e)) from None
        sides = expr_sides(knode)
        if len(sides) != 1:
            raise _ResUnsupported("cross-side function subexpression")
        (side,) = sides
        canon = canonical(strip_side(knode))
        try:
            kind, vals, null = evaluate_key(self.table, canon)
        except DerivedKeyError as e:
            raise _ResUnsupported(str(e)) from None
        if kind == "num":

            def build(vals=vals, null=null):
                out = vals.copy()
                out[null] = np.nan
                return out

            idx = self._register(("dnum", canon), build)
            return ("num", self._gather_num(idx, side))
        return ("str", ("expr", canon), None, side)

    @staticmethod
    def _gather_num(idx: int, side: str):
        def g(i, j, ops):
            rows = i if side == "l" else j
            return ops[idx][rows]

        return g

    def _as_num(self, v):
        """Numeric closure from a value. String/raw columns coerce through
        the host's pd.to_numeric ONCE at plan build (the array uploads like
        any other operand), matching SQL's implicit CAST semantics."""
        if v[0] == "num":
            return v[1]
        if v[0] == "lit_n":
            x = v[1]

            def const(i, j, ops, x=x):
                # float64, as the host path: literal thresholds compare
                # bit for bit the same
                return torch.full(i.shape, x, dtype=torch.float64, device=i.device)

            return const
        if v[0] == "str":
            return self._gather_num(self._coerced_vals(v[1]), v[3])
        raise _ResUnsupported("non-numeric operand in numeric context")

    # -- comparisons -> (val, unk) closures
    def _cmp_apply(self, opname, x, y):
        return {
            "eq": lambda: x == y,
            "ne": lambda: x != y,
            "lt": lambda: x < y,
            "le": lambda: x <= y,
            "gt": lambda: x > y,
            "ge": lambda: x >= y,
        }[opname]()

    def compare_pair(self, opname, lv, rv):
        if lv[0] == "str" and rv[0] == "str":
            if lv[1] == rv[1]:
                li = ri = self._str_ranks_scaled(lv[1])
            else:
                # different vocabularies: re-rank both over the union
                li, ri = self._joint_ranks_scaled(lv[1], rv[1])
            ls, rs = lv[3], rv[3]

            def f(i, j, ops, li=li, ls=ls, ri=ri, rs=rs, opname=opname):
                a = ops[li][i if ls == "l" else j]
                b = ops[ri][i if rs == "l" else j]
                unk = (a < 0) | (b < 0)
                return self._cmp_apply(opname, a, b) & ~unk, unk

            return f
        if lv[0] == "str" and rv[0] == "lit_s":
            k = self._literal_rank(lv[1], rv[1])
            li, ls = self._str_ranks_scaled(lv[1]), lv[3]

            def f(i, j, ops, li=li, ls=ls, k=k, opname=opname):
                a = ops[li][i if ls == "l" else j]
                unk = a < 0
                return self._cmp_apply(opname, a, k) & ~unk, unk

            return f
        if rv[0] == "str" and lv[0] == "lit_s":
            k = self._literal_rank(rv[1], lv[1])
            ri, rs = self._str_ranks_scaled(rv[1]), rv[3]

            def f(i, j, ops, ri=ri, rs=rs, k=k, opname=opname):
                b = ops[ri][i if rs == "l" else j]
                unk = b < 0
                return self._cmp_apply(opname, k, b) & ~unk, unk

            return f
        # numeric comparison — a BARE string column here is a type
        # mismatch on the host (evaluate_residual raises; coercion only
        # happens inside arithmetic/abs contexts), so reject for parity
        if lv[0] == "str" or rv[0] == "str":
            raise _ResUnsupported(
                "string column in a numeric comparison (host type mismatch)"
            )
        a = self._as_num(lv)
        b = self._as_num(rv)

        def f(i, j, ops, a=a, b=b, opname=opname):
            x, y = a(i, j, ops), b(i, j, ops)
            unk = torch.isnan(x) | torch.isnan(y)
            return self._cmp_apply(opname, x, y) & ~unk, unk

        return f

    # -- boolean level (Kleene from residual_eval works on torch tensors
    # too: its operators are pure &, |, ~ algebra — ONE implementation of
    # the null logic shared between host and device)
    def boolean(self, node):
        from .residual_eval import Kleene

        if isinstance(node, ast.BinOp) and isinstance(
            node.op, (ast.BitAnd, ast.BitOr)
        ):
            a = self.boolean(node.left)
            b = self.boolean(node.right)
            is_and = isinstance(node.op, ast.BitAnd)

            def f(i, j, ops, a=a, b=b, is_and=is_and):
                ka = Kleene(*a(i, j, ops))
                kb = Kleene(*b(i, j, ops))
                out = (ka & kb) if is_and else (ka | kb)
                return out.val, out.unk

            return f
        if isinstance(node, ast.UnaryOp) and isinstance(node.op, ast.Invert):
            a = self.boolean(node.operand)

            def f(i, j, ops, a=a):
                out = ~Kleene(*a(i, j, ops))
                return out.val, out.unk

            return f
        if isinstance(node, ast.Compare):
            operands = [node.left, *node.comparators]
            parts = []
            for op, ln, rn in zip(node.ops, operands, operands[1:]):
                if type(op) not in self._CMPS:
                    raise _ResUnsupported("comparison operator")
                parts.append(
                    self.compare_pair(
                        self._CMPS[type(op)], self.value(ln), self.value(rn)
                    )
                )

            def f(i, j, ops, parts=parts):
                out = Kleene(*parts[0](i, j, ops))
                for p in parts[1:]:
                    out = out & Kleene(*p(i, j, ops))
                return out.val, out.unk

            return f
        if isinstance(node, ast.Call):
            if not (
                isinstance(node.func, ast.Name) and node.func.id == "_isna"
            ):
                raise _ResUnsupported("boolean call")
            (arg,) = node.args
            v = self.value(arg)
            if v[0] == "str":
                oi, side = self._str_ranks_scaled(v[1]), v[3]

                def f(i, j, ops, oi=oi, side=side):
                    a = ops[oi][i if side == "l" else j]
                    return a < 0, torch.zeros(a.shape, dtype=torch.bool, device=a.device)

                return f
            if v[0] == "num":
                g = v[1]

                def f(i, j, ops, g=g):
                    x = g(i, j, ops)
                    return torch.isnan(x), torch.zeros(x.shape, dtype=torch.bool, device=x.device)

                return f
            raise _ResUnsupported("_isna of a literal")
        if isinstance(node, ast.Constant) and isinstance(node.value, bool):
            b = bool(node.value)

            def f(i, j, ops, b=b):
                return (torch.full(i.shape, b, dtype=torch.bool, device=i.device),
                        torch.zeros(i.shape, dtype=torch.bool, device=i.device))

            return f
        raise _ResUnsupported(f"boolean node {type(node).__name__}")


def compile_residual_device(table, residual_src: str,
                            ops: list[np.ndarray], op_index: dict,
                            aux: dict):
    """-> fn(i, j, ops) -> (val, unk), or None when the predicate needs
    host-only machinery (the caller then rejects the whole plan)."""
    try:
        tree = ast.parse(residual_src, mode="eval")
    except SyntaxError:
        return None
    try:
        return _ResCompiler(table, ops, op_index, aux).boolean(tree.body)
    except _ResUnsupported:
        return None


def _split_extents(n: int, chunk: int) -> np.ndarray:
    """[chunk, chunk, ..., remainder] covering n."""
    k = -(-n // chunk)
    out = np.full(k, chunk, np.int64)
    if n % chunk:
        out[-1] = n % chunk
    return out


def _units_for_self_join(starts, sizes, chunk):
    """Triangle + rectangle units for within-group pairs, group by group.
    Returns None when a group would exceed MAX_UNITS_PER_GROUP."""
    if len(sizes):
        k_max = -(-int(sizes.max()) // chunk)
        if k_max * (k_max + 1) // 2 > MAX_UNITS_PER_GROUP:
            return None
    ua, la, ub, lb = [], [], [], []
    big = sizes > chunk
    # fast path: single-chunk groups (one triangle each)
    small = (~big) & (sizes >= 2)
    ua.append(starts[small])
    la.append(sizes[small])
    ub.append(starts[small])
    lb.append(sizes[small])
    key = [np.flatnonzero(small).astype(np.int64) * (1 << 20)]
    for gi in np.flatnonzero(big):
        s0, s = int(starts[gi]), int(sizes[gi])
        exts = _split_extents(s, chunk)
        offs = np.concatenate([[0], np.cumsum(exts)])[:-1] + s0
        k = len(exts)
        gua, gla, gub, glb = [], [], [], []
        for c in range(k):
            gua.append(offs[c])
            gla.append(exts[c])
            gub.append(offs[c])
            glb.append(exts[c])
            for c2 in range(c + 1, k):
                gua.append(offs[c])
                gla.append(exts[c])
                gub.append(offs[c2])
                glb.append(exts[c2])
        ua.append(np.asarray(gua, np.int64))
        la.append(np.asarray(gla, np.int64))
        ub.append(np.asarray(gub, np.int64))
        lb.append(np.asarray(glb, np.int64))
        key.append(
            gi * (1 << 20) + 1 + np.arange(len(gua), dtype=np.int64)
        )
    ua = np.concatenate(ua)
    la = np.concatenate(la)
    ub = np.concatenate(ub)
    lb = np.concatenate(lb)
    key = np.concatenate(key)
    # deterministic unit order: by (group, within-group unit sequence)
    o = np.argsort(key, kind="stable")
    return ua[o], la[o], ub[o], lb[o]


def _units_for_cross_join(ls, lz, rs, rz, chunk):
    """Rectangle units for left x right group pairs (link types).
    Returns None when a group would exceed MAX_UNITS_PER_GROUP."""
    if len(lz):
        per_group = (-(-lz // chunk)) * (-(-rz // chunk))
        if int(per_group.max()) > MAX_UNITS_PER_GROUP:
            return None
    ua, la, ub, lb = [], [], [], []
    both_small = (lz <= chunk) & (rz <= chunk)
    ua.append(ls[both_small])
    la.append(lz[both_small])
    ub.append(rs[both_small])
    lb.append(rz[both_small])
    key = [np.flatnonzero(both_small).astype(np.int64) * (1 << 20)]
    for gi in np.flatnonzero(~both_small):
        lex = _split_extents(int(lz[gi]), chunk)
        loff = np.concatenate([[0], np.cumsum(lex)])[:-1] + int(ls[gi])
        rex = _split_extents(int(rz[gi]), chunk)
        roff = np.concatenate([[0], np.cumsum(rex)])[:-1] + int(rs[gi])
        gua, gla, gub, glb = [], [], [], []
        for a in range(len(lex)):
            for b in range(len(rex)):
                gua.append(loff[a])
                gla.append(lex[a])
                gub.append(roff[b])
                glb.append(rex[b])
        ua.append(np.asarray(gua, np.int64))
        la.append(np.asarray(gla, np.int64))
        ub.append(np.asarray(gub, np.int64))
        lb.append(np.asarray(glb, np.int64))
        key.append(gi * (1 << 20) + 1 + np.arange(len(gua), dtype=np.int64))
    ua = np.concatenate(ua)
    la = np.concatenate(la)
    ub = np.concatenate(ub)
    lb = np.concatenate(lb)
    key = np.concatenate(key)
    o = np.argsort(key, kind="stable")
    return ua[o], la[o], ub[o], lb[o]


def _pair_counts(ua, la, ub, lb) -> np.ndarray:
    tri = ua == ub
    cnt = np.where(tri, la * (la - 1) // 2, la * lb).astype(np.int64)
    return np.concatenate([[0], np.cumsum(cnt)])


def _uid_mask_codes(table: EncodedTable, link_type: str) -> np.ndarray | None:
    """Dense int32 ordering-key codes for the device duplicate-uid mask, or
    None when the ordering keys are unique (the common case — then the
    strict rank ordering alone reproduces the reference's l.key < r.key).
    link_and_dedupe keys are (source, uid), the reference's `_source_table`
    tie-break (splink/blocking.py:139)."""
    _, keys_unique = _uid_ranks(table, link_type)
    if keys_unique:
        return None
    uid = np.asarray(table.unique_id)
    _, uid_codes = np.unique(uid, return_inverse=True)
    uid_codes = uid_codes.astype(np.int64)
    if link_type == "link_and_dedupe":
        uid_codes = uid_codes * 2 + np.asarray(table.source_table, np.int64)
        _, uid_codes = np.unique(uid_codes, return_inverse=True)
    return uid_codes.astype(np.int32)


def unit_decode(q, order, ua, la, ub, lb, pc):
    """Rule-relative int64 positions ``q`` -> (i, j) int64 row indices, on
    the device ``q`` lives on: the unit by a search of the cumulative pair
    table, then the triangle decode (float64 square root, +-1 integer
    correction) or the rectangle decode (int64 floor division). The ONE
    device implementation of the position decode; :func:`decode_positions`
    is its host mirror."""
    u = torch.searchsorted(pc, q, right=True) - 1
    t = q - pc[u]
    A, LA, Bs, LB = ua[u], la[u], ub[u], lb[u]
    tri = A == Bs
    two_l = (2 * LA - 1).to(torch.float64)
    disc = two_l**2 - 8 * t.to(torch.float64)
    a_t = torch.floor((two_l - torch.sqrt(torch.clamp(disc, min=0.0))) / 2).to(torch.int64)

    def off(a):
        return a * LA - torch.div(a * (a + 1), 2, rounding_mode="floor")

    a_t = torch.where(off(a_t + 1) <= t, a_t + 1, a_t)
    a_t = torch.where(off(a_t) > t, a_t - 1, a_t)
    b_t = t - off(a_t) + a_t + 1
    lb_safe = torch.clamp(LB, min=1)
    a_r = torch.div(t, lb_safe, rounding_mode="floor")
    b_r = t - a_r * lb_safe
    a = torch.where(tri, a_t, a_r)
    b = torch.where(tri, b_t, b_r)
    return order[A + a], order[Bs + b]


def build_virtual_plan(
    settings: dict, table: EncodedTable, n_left: int | None = None,
    chunk: int | None = None,
) -> VirtualPlan | None:
    """Build the device-decodable plan, or None when unsupported
    (cartesian fallback, a rule with no equality conjunction, a residual
    predicate the device compiler can't honour, or a degenerate
    near-constant blocking key — see MAX_UNITS_PER_GROUP)."""
    chunk = chunk or CHUNK
    link_type = settings["link_type"]
    rules = settings.get("blocking_rules") or []
    if not rules:
        return None
    parsed_cols = []
    residuals: list[tuple[str | None, object]] = []
    res_ops: list[np.ndarray] = []
    res_idx: dict = {}
    res_aux: dict = {}
    for rule in rules:
        eq_pairs, residual = parse_blocking_rule(rule)
        sym_cols, asym, residual = _split_join_keys(eq_pairs, residual)
        if not sym_cols:
            # no symmetric key to group on (a lone l.a = r.b, or no
            # equality at all): host blocking handles it
            return None
        if asym:
            # fold asymmetric equality keys into this rule's residual:
            # candidates still group by the symmetric keys and the device
            # mask enforces the cross-column equality via joint-vocabulary
            # ranks — host blocking meanwhile uses its shared-vocabulary
            # hash join (blocking._key_codes_asym); the pair sets match
            from .derived_keys import asym_residual_src

            term = asym_residual_src(asym)
            residual = f"({residual}) & {term}" if residual else term
        join_cols = sym_cols
        res_fn = None
        if residual is not None:
            res_fn = compile_residual_device(
                table, residual, res_ops, res_idx, res_aux
            )
            if res_fn is None:
                return None
        parsed_cols.append(join_cols)
        residuals.append((residual, res_fn))

    n = table.n_rows
    uid_codes = None
    if link_type in ("dedupe_only", "link_and_dedupe"):
        # link_and_dedupe is a self-join over the concatenated table with
        # (source, uid) as the ordering key; duplicate ordering keys mean
        # the strict l.key < r.key ordering drops equal-key pairs — dense
        # codes feed the device mask (None when keys are unique)
        ranks, _ = _uid_ranks(table, link_type)
        uid_codes = _uid_mask_codes(table, link_type)

    plans: list[RulePlan] = []
    codes_all = np.empty((len(rules), n), np.int32)
    for r, join_cols in enumerate(parsed_cols):
        codes = _key_codes(table, join_cols)
        codes_all[r] = codes.astype(np.int32)  # codes < n <= 2^31
        if link_type in ("dedupe_only", "link_and_dedupe"):
            rows = np.flatnonzero(codes >= 0).astype(np.int32)
            rows = rows[np.argsort(ranks[rows], kind="stable")]
            rows_sorted, _, starts, sizes = _sort_groups(codes, rows)
            units = _units_for_self_join(starts, sizes, chunk)
            if units is None:
                return None
            ua, la, ub, lb = units
        else:
            assert n_left is not None
            all_rows = np.arange(n, dtype=np.int32)
            lrows_in = all_rows[:n_left]
            rrows_in = all_rows[n_left:]
            lrows, lcodes, lstarts, lsizes = _sort_groups(
                codes, lrows_in[codes[lrows_in] >= 0]
            )
            rrows, rcodes, rstarts, rsizes = _sort_groups(
                codes, rrows_in[codes[rrows_in] >= 0]
            )
            common, li, ri = np.intersect1d(
                lcodes, rcodes, return_indices=True
            )
            # one order array: [left-sorted | right-sorted]; right unit
            # starts shift by len(lrows)
            rows_sorted = np.concatenate([lrows, rrows]).astype(np.int32)
            if len(common):
                units = _units_for_cross_join(
                    lstarts[li],
                    lsizes[li],
                    rstarts[ri] + len(lrows),
                    rsizes[ri],
                    chunk,
                )
                if units is None:
                    return None
                ua, la, ub, lb = units
            else:
                ua = la = ub = lb = np.zeros(0, np.int64)
        pc = _pair_counts(ua, la, ub, lb)
        plans.append(
            RulePlan(
                order=np.ascontiguousarray(rows_sorted, dtype=np.int32),
                ua=ua.astype(np.int32),
                la=la.astype(np.int32),
                ub=ub.astype(np.int32),
                lb=lb.astype(np.int32),
                pc=pc,
                residual=residuals[r][0],
                residual_fn=residuals[r][1],
            )
        )
    return VirtualPlan(
        rules=plans,
        codes=codes_all,
        uid_codes=uid_codes,
        n_candidates=sum(rp.total for rp in plans),
        res_ops=res_ops,
        table=table,
        chunk=chunk,
    )


# --------------------------------------------------------------------------
# Host-side decode (output streaming + test oracle)
# --------------------------------------------------------------------------


def decode_positions(plan: VirtualPlan, rule: int, q: np.ndarray,
                     compute_masked: bool = True):
    """(i, j, masked) for rule-relative pair positions q (int64, numpy).

    The host mirror of the device decode — used to rebuild (idx_l, idx_r)
    for output chunks and as the oracle the device pass is tested
    against. The streaming caller already filtered
    masked positions by the kernel's sentinel pattern id and passes
    ``compute_masked=False`` (masked comes back None) — re-running the
    residual predicates on the host per chunk would be pure waste.
    """
    rp = plan.rules[rule]
    u = np.searchsorted(rp.pc, q, side="right") - 1
    t = q - rp.pc[u]
    A, LA = rp.ua[u].astype(np.int64), rp.la[u].astype(np.int64)
    Bs, LB = rp.ub[u].astype(np.int64), rp.lb[u].astype(np.int64)
    tri = A == Bs
    with np.errstate(invalid="ignore"):
        disc = (2 * LA - 1).astype(np.float64) ** 2 - 8 * t.astype(np.float64)
        a_t = np.floor(
            ((2 * LA - 1) - np.sqrt(np.maximum(disc, 0.0))) / 2
        ).astype(np.int64)
    off = lambda a: a * LA - (a * (a + 1)) // 2  # noqa: E731
    a_t = np.where(off(a_t + 1) <= t, a_t + 1, a_t)
    a_t = np.where(off(a_t) > t, a_t - 1, a_t)
    b_t = t - off(a_t) + a_t + 1
    lb_safe = np.maximum(LB, 1)
    a_r = t // lb_safe
    b_r = t - a_r * lb_safe
    a = np.where(tri, a_t, a_r)
    b = np.where(tri, b_t, b_r)
    i = rp.order[(A + a).astype(np.int64)]
    j = rp.order[(Bs + b).astype(np.int64)]
    if not compute_masked:
        return i, j, None
    masked = np.zeros(len(q), bool)
    if plan.uid_codes is not None:
        masked |= plan.uid_codes[i] == plan.uid_codes[j]
    if rp.residual is not None:
        from .residual_eval import evaluate_residual

        masked |= ~evaluate_residual(plan.table, rp.residual, i, j)
    for prev in range(rule):
        cp = plan.codes[prev]
        holds = (cp[i] == cp[j]) & (cp[i] >= 0)
        prev_res = plan.rules[prev].residual
        if prev_res is not None and holds.any():
            from .residual_eval import evaluate_residual

            sub = np.flatnonzero(holds)
            keep = evaluate_residual(plan.table, prev_res, i[sub], j[sub])
            holds = holds.copy()
            holds[sub] = keep
        masked |= holds
    return i, j, masked


# --------------------------------------------------------------------------
# Device pass
# --------------------------------------------------------------------------


def make_virtual_pattern_fn(program, plan: VirtualPlan, rule: int):
    """fn(q) -> (b,) int32 pattern ids of the rule-relative positions
    ``q`` (an int64 tensor on the program's device): decode on the device,
    the mask (duplicate uid keys, the rule's own residual, every earlier
    rule's predicate), the gamma program on every position and the
    mixed-radix ids, masked positions carrying the sentinel
    ``n_patterns``."""
    arrs = plan.on_device(program.device)
    rp = plan.rules[rule]
    ra = arrs["rules"][rule]
    prev_res = [p.residual_fn for p in plan.rules[:rule]]
    codes, uid, res_ops = arrs["codes"], arrs["uid"], arrs["res_ops"]

    def fn(q):
        i, j = unit_decode(q, ra["order"], *ra["units"], ra["pc"])
        masked = torch.zeros(q.shape, dtype=torch.bool, device=q.device)
        if uid is not None:
            masked |= uid[i] == uid[j]
        if rp.residual_fn is not None:
            v, unk = rp.residual_fn(i, j, res_ops)
            masked |= ~(v & ~unk)
        for p, res in enumerate(prev_res):
            cp = codes[p]
            ci = cp[i]
            holds = (ci == cp[j]) & (ci >= 0)
            if res is not None:
                v, unk = res(i, j, res_ops)
                holds &= v & ~unk
            masked |= holds
        return program.pattern_ids(program.gamma_batch(i, j), masked)

    return fn


def _virtual_pass_iter(program, plan: VirtualPlan, batch_size: int,
                       want_ids: bool = True, counts_out=None):
    """Drive one device pass over the virtual pair stream, yielding
    ``(rule, rule_p0, out_pos, n_valid, pid_host)`` per batch, in order.

    Each rule runs in batches of ``min(batch_size, next power of two >=
    its total)`` positions (the reference's batch boundaries, so output
    chunks match it). With ``want_ids`` the ids (narrowed to uint16 on
    the device where they fit) copy to pinned host buffers on a side
    stream a few batches deep; without it ``pid_host`` is None and no
    per-pair bytes leave the device. The histogram accumulates on the
    device in int64 and is added to ``counts_out`` (int64, n_patterns;
    the caller owns it) once, at the end of the pass."""
    n_patterns = program.n_patterns
    counts = counts_out if counts_out is not None else np.zeros(n_patterns, np.int64)
    total = plan.n_candidates
    if total == 0:
        return
    batch_size = max(min(batch_size, total), 1)
    device = program.device
    acc = torch.zeros(n_patterns + 1, dtype=torch.int64, device=device)
    downloads = _Downloads(device, _D2H_DEPTH) if want_ids else None
    try:
        out_pos = 0
        for r, rp in enumerate(plan.rules):
            if rp.total == 0:
                continue
            # clamp the batch to this RULE's total (power-of-two bucket): a
            # small rule must not run a full pair_batch_size of positions
            rule_bs = min(batch_size, 1 << max(int(rp.total - 1).bit_length(), 6))
            fn = make_virtual_pattern_fn(program, plan, r)
            for p0 in range(0, rp.total, rule_bs):
                p1 = min(p0 + rule_bs, rp.total)
                q = torch.arange(p0, p1, dtype=torch.int64, device=device)
                pid = fn(q)
                acc += pattern_histogram(pid, n_patterns + 1)
                if want_ids:
                    downloads.submit(program.narrow_ids(pid), (r, p0, out_pos, p1 - p0))
                    for tag, arr in downloads.ready():
                        yield (*tag, arr)
                else:
                    yield r, p0, out_pos, p1 - p0, None
                out_pos += p1 - p0
        if want_ids:
            for tag, arr in downloads.drain():
                yield (*tag, arr)
        counts[:] += acc[:n_patterns].cpu().numpy()
    finally:
        # the consumer may abandon the generator mid-stream: drop the copies
        # still in flight
        if downloads is not None:
            downloads.clear()


def compute_virtual_pattern_ids(program, plan: VirtualPlan, batch_size: int,
                                return_ids: bool = True):
    """One device pass over the VIRTUAL pair stream: (pids, counts,
    n_real). pids carries the sentinel ``n_patterns`` for masked positions;
    counts excludes them; n_real = counts.sum(). With ``return_ids=False``
    the pass computes ONLY the histogram (EM needs nothing else) and pids
    comes back None."""
    program._require_patterns()
    counts = np.zeros(program.n_patterns, np.int64)
    pids = np.empty(plan.n_candidates, program.id_dtype) if return_ids else None
    for _, _, ps, n_valid, chunk in _virtual_pass_iter(
        program, plan, batch_size, want_ids=return_ids, counts_out=counts,
    ):
        if return_ids:
            pids[ps : ps + n_valid] = chunk
    return pids, counts, int(counts.sum())
