"""Derived blocking-key expressions: parse + host-vectorised evaluation.

The reference executes arbitrary SQL join predicates through Spark
(splink/blocking.py:141-158; the join runs as spark.sql at
:210), so ``substr(l.surname, 1, 3) = substr(r.surname, 1, 3)`` or a
``lower(concat(l.first_name, l.surname))`` key is routine splink usage.
splink_tpu keeps blocking host-side (blocking.py); this module makes
function-of-column join keys first-class: a ONE-SIDED scalar SQL expression
is parsed once, evaluated vectorised over all rows into a (values, null)
pair, and factorised into int key codes — from there a derived key is
indistinguishable from a plain column key. Hash joins, sequential-rule
dedup, the pair-count estimator and the device virtual pair index
(pairgen.py) all consume the same codes, so a derived-key rule rides the
same fast paths as ``l.surname = r.surname``.

Null semantics follow Spark SQL (what the reference's joins ran on): every
scalar function returns NULL on any NULL input — including ``concat``,
which in Spark is NULL if ANY argument is NULL — except ``coalesce`` /
``ifnull``, whose whole point is null replacement. A NULL key never joins
(SQL equality), which blocking.py enforces with code -1.

The same ASTs also back the device residual compiler (pairgen._ResCompiler):
a single-side function subexpression inside a residual predicate is
precomputed here into a per-row operand array and compared on device by
rank, mirroring how plain columns already work there.
"""

from __future__ import annotations

import re

import numpy as np

from .data import EncodedTable


class DerivedKeyError(ValueError):
    pass


# --------------------------------------------------------------------------
# Tokenizer / parser -> tuple ASTs
#   ("col", side_or_None, name)        column reference
#   ("lit", value)                     str | float | None (NULL)
#   ("func", name, [args])             lowercased function name
#   ("arith", op, a, b)                op in + - * / %
#   ("neg", a)
#   ("cast", a, type)                  type in {"string","int","double"}
# --------------------------------------------------------------------------

_TOKEN = re.compile(
    r"""\s*(?:
      (?P<num>\d+\.\d*(?:[eE][-+]?\d+)?|\.\d+(?:[eE][-+]?\d+)?|\d+(?:[eE][-+]?\d+)?)
    | (?P<str>'(?:[^']|'')*')
    | (?P<ident>[A-Za-z_]\w*)
    | (?P<op>\|\||[().,+\-*/%])
    )""",
    re.X,
)

# Functions the evaluator implements; value is the result kind family.
_STRING_FUNCS = {
    "substr", "substring", "lower", "upper", "trim", "ltrim", "rtrim",
    "concat", "coalesce", "ifnull", "nvl", "left", "right", "reverse",
    "dmetaphone", "dmetaphone_alt",
}
_NUMERIC_FUNCS = {"length", "char_length", "len", "abs", "round", "floor",
                  "ceil", "ceiling"}
KNOWN_FUNCS = _STRING_FUNCS | _NUMERIC_FUNCS

_CAST_TYPES = {
    "string": "string", "varchar": "string", "text": "string",
    "int": "int", "integer": "int", "bigint": "int", "long": "int",
    "double": "double", "float": "double", "real": "double",
    "numeric": "double", "decimal": "double",
}


def _tokenize(s: str) -> list[tuple[str, str]]:
    out, pos = [], 0
    while pos < len(s):
        m = _TOKEN.match(s, pos)
        if not m or m.end() == m.start():
            rest = s[pos:].strip()
            if not rest:
                break
            raise DerivedKeyError(f"Cannot tokenize key expression at {rest[:30]!r}")
        pos = m.end()
        for kind in ("num", "str", "ident", "op"):
            tok = m.group(kind)
            if tok is not None:
                out.append((kind, tok))
                break
    return out


class _Parser:
    def __init__(self, tokens: list[tuple[str, str]]):
        self.toks = tokens
        self.pos = 0

    def peek(self):
        return self.toks[self.pos] if self.pos < len(self.toks) else ("eof", "")

    def next(self):
        t = self.peek()
        self.pos += 1
        return t

    def expect(self, value: str):
        kind, tok = self.next()
        if tok.lower() != value:
            raise DerivedKeyError(f"Expected {value!r}, got {tok!r}")

    # expr := addsub ; '||' binds like '+'
    def expr(self):
        node = self.muldiv()
        while self.peek()[1] in ("+", "-", "||"):
            _, op = self.next()
            rhs = self.muldiv()
            if op == "||":
                node = ("func", "concat", [node, rhs])
            else:
                node = ("arith", op, node, rhs)
        return node

    def muldiv(self):
        node = self.unary()
        while self.peek()[1] in ("*", "/", "%"):
            _, op = self.next()
            node = ("arith", op, node, self.unary())
        return node

    def unary(self):
        if self.peek()[1] == "-":
            self.next()
            return ("neg", self.unary())
        return self.primary()

    def primary(self):
        kind, tok = self.next()
        if kind == "num":
            return ("lit", float(tok))
        if kind == "str":
            return ("lit", tok[1:-1].replace("''", "'"))
        if kind == "op" and tok == "(":
            node = self.expr()
            self.expect(")")
            return node
        if kind == "ident":
            low = tok.lower()
            if low == "null":
                return ("lit", None)
            if low == "cast":
                self.expect("(")
                arg = self.expr()
                kind2, as_tok = self.next()
                if as_tok.lower() != "as" or kind2 != "ident":
                    raise DerivedKeyError("cast expects CAST(expr AS type)")
                _, type_tok = self.next()
                ctype = _CAST_TYPES.get(type_tok.lower())
                if ctype is None:
                    raise DerivedKeyError(f"Unsupported cast type {type_tok!r}")
                self.expect(")")
                return ("cast", arg, ctype)
            if self.peek()[1] == "(":
                if low not in KNOWN_FUNCS:
                    raise DerivedKeyError(f"Unknown key function {tok!r}")
                self.next()
                args = []
                if self.peek()[1] != ")":
                    args.append(self.expr())
                    while self.peek()[1] == ",":
                        self.next()
                        args.append(self.expr())
                self.expect(")")
                return ("func", low, args)
            if self.peek()[1] == ".":
                if low not in ("l", "r"):
                    raise DerivedKeyError(
                        f"Only l./r. table aliases are recognised, got {tok!r}"
                    )
                self.next()
                kind2, col = self.next()
                if kind2 != "ident":
                    raise DerivedKeyError(f"Expected column name after {tok}.")
                return ("col", low, col)
            return ("col", None, tok)
        raise DerivedKeyError(f"Unexpected token {tok!r} in key expression")


def parse_key_expr(text: str):
    """Parse a scalar SQL key expression into a tuple AST. Raises
    DerivedKeyError for anything outside the supported surface."""
    p = _Parser(_tokenize(text))
    node = p.expr()
    if p.peek()[0] != "eof":
        raise DerivedKeyError(
            f"Trailing tokens in key expression: {p.peek()[1]!r}"
        )
    return node


def expr_sides(node) -> set[str]:
    """The set of table aliases ('l'/'r') referenced by column refs."""
    tag = node[0]
    if tag == "col":
        return {node[1]} if node[1] else set()
    if tag == "lit":
        return set()
    out: set[str] = set()
    if tag == "func":
        for a in node[2]:
            out |= expr_sides(a)
    elif tag == "arith":
        out |= expr_sides(node[2]) | expr_sides(node[3])
    elif tag in ("neg",):
        out |= expr_sides(node[1])
    elif tag == "cast":
        out |= expr_sides(node[1])
    return out


def strip_side(node):
    """Remove the l./r. alias from every column ref (one-sided canonical)."""
    tag = node[0]
    if tag == "col":
        return ("col", None, node[2])
    if tag == "lit":
        return node
    if tag == "func":
        return ("func", node[1], [strip_side(a) for a in node[2]])
    if tag == "arith":
        return ("arith", node[1], strip_side(node[2]), strip_side(node[3]))
    if tag == "neg":
        return ("neg", strip_side(node[1]))
    if tag == "cast":
        return ("cast", strip_side(node[1]), node[2])
    raise DerivedKeyError(f"Unknown node {tag!r}")


def canonical(node) -> str:
    """Deterministic rendering — the cache key, and the string blocking.py
    carries where a plain column name used to be. A bare column renders as
    just its name, so existing plain-column keys are unchanged."""
    tag = node[0]
    if tag == "col":
        return f"{node[1]}.{node[2]}" if node[1] else node[2]
    if tag == "lit":
        v = node[1]
        if v is None:
            return "null"
        if isinstance(v, str):
            return "'" + v.replace("'", "''") + "'"
        if isinstance(v, float) and v.is_integer():
            return str(int(v))
        return repr(v)
    if tag == "func":
        return f"{node[1]}({','.join(canonical(a) for a in node[2])})"
    if tag == "arith":
        return f"({canonical(node[2])}{node[1]}{canonical(node[3])})"
    if tag == "neg":
        return f"(-{canonical(node[1])})"
    if tag == "cast":
        return f"cast({canonical(node[1])} as {node[2]})"
    raise DerivedKeyError(f"Unknown node {tag!r}")


def is_plain_column(expr: str) -> bool:
    return re.fullmatch(r"\w+", expr) is not None


def with_side(node, side: str):
    """Attach an l./r. alias to every column ref (inverse of strip_side)."""
    tag = node[0]
    if tag == "col":
        return ("col", side, node[2])
    if tag == "lit":
        return node
    if tag == "func":
        return ("func", node[1], [with_side(a, side) for a in node[2]])
    if tag == "arith":
        return (
            "arith", node[1], with_side(node[2], side), with_side(node[3], side)
        )
    if tag == "neg":
        return ("neg", with_side(node[1], side))
    if tag == "cast":
        return ("cast", with_side(node[1], side), node[2])
    raise DerivedKeyError(f"Unknown node {tag!r}")


def to_python_src(node) -> str:
    """Render a SIDED key AST in the translated-residual python surface
    (l["col"] subscripts, cast(x, 't')) — the inverse of pyast_to_keynode,
    used to fold an asymmetric equality key back into a rule's residual for
    the device virtual-plan path."""
    tag = node[0]
    if tag == "col":
        if node[1] is None:
            raise DerivedKeyError("to_python_src needs sided column refs")
        return f'{node[1]}["{node[2]}"]'
    if tag == "lit":
        v = node[1]
        if v is None:
            return "None"
        if isinstance(v, str):
            return repr(v)
        if isinstance(v, float) and v.is_integer():
            return str(int(v))
        return repr(v)
    if tag == "func":
        return f"{node[1]}({', '.join(to_python_src(a) for a in node[2])})"
    if tag == "arith":
        return f"({to_python_src(node[2])} {node[1]} {to_python_src(node[3])})"
    if tag == "neg":
        return f"(-{to_python_src(node[1])})"
    if tag == "cast":
        return f"cast({to_python_src(node[1])}, '{node[2]}')"
    raise DerivedKeyError(f"Unknown node {tag!r}")


def asym_residual_src(asym_pairs) -> str:
    """The python-expression equality terms for asymmetric join keys —
    lets build_virtual_plan keep device pair generation for rules like
    ``l.city = r.city AND l.first_name = r.surname`` by enforcing the
    cross-column equality as a device mask
    while host blocking uses the faster shared-vocabulary hash join."""
    terms = []
    for lexpr, rexpr in asym_pairs:
        ln = with_side(parse_key_expr(lexpr), "l")
        rn = with_side(parse_key_expr(rexpr), "r")
        terms.append(f"({to_python_src(ln)} == {to_python_src(rn)})")
    return " & ".join(terms)


# --------------------------------------------------------------------------
# Evaluation: node -> (kind, values, null) over all rows of an EncodedTable
#   kind "str": values is an (n,) object array of str (None where null)
#   kind "num": values is an (n,) float64 array (NaN where null)
# --------------------------------------------------------------------------


_STR_UFUNC = np.frompyfunc(str, 1, 1)


def _coerce_str(values: np.ndarray, null: np.ndarray) -> np.ndarray:
    """Object array with every non-null value coerced through str() — SQL
    string functions on a non-string operand behave like an implicit cast
    (Spark casts; a raw int zip-code column must substr fine). No copy when
    everything is already str (the common case, detected by pandas' C
    dtype scan, not a python isinstance loop)."""
    import pandas as pd

    nn = ~null
    sub = values[nn]
    if len(sub) == 0 or pd.api.types.infer_dtype(sub, skipna=False) == "string":
        return values
    out = np.full(len(values), None, object)
    out[nn] = _STR_UFUNC(sub)
    return out


def _num_to_str(values: np.ndarray, null: np.ndarray) -> np.ndarray:
    """float64 -> object strings; integral floats render without the
    trailing .0 (Spark renders CAST(1 AS STRING) as '1'). Vectorised:
    pandas' astype(str) does the formatting in C for both branches."""
    import pandas as pd

    out = np.full(len(values), None, object)
    nn = ~null
    v = np.asarray(values, np.float64)[nn]
    with np.errstate(invalid="ignore"):
        ints = (v == np.trunc(v)) & (np.abs(v) < 2**53)
    sub = np.empty(len(v), object)
    if ints.any():
        sub[ints] = (
            pd.Series(v[ints].astype(np.int64)).astype(str).to_numpy(object)
        )
    if (~ints).any():
        sub[~ints] = pd.Series(v[~ints]).astype(str).to_numpy(object)
    out[nn] = sub
    return out


class _Eval:
    def __init__(self, table: EncodedTable):
        self.table = table
        self.n = table.n_rows

    def eval(self, node) -> tuple[str, np.ndarray, np.ndarray]:
        tag = node[0]
        if tag == "col":
            return self.column_node(node)
        if tag == "lit":
            return self.literal(node[1])
        if tag == "func":
            return self.func(node[1], node[2])
        if tag == "arith":
            return self.arith(node[1], node[2], node[3])
        if tag == "neg":
            k, v, nl = self.as_num(node[1])
            return ("num", -v, nl)
        if tag == "cast":
            return self.cast(node[1], node[2])
        raise DerivedKeyError(f"Unknown node {tag!r}")

    def column_node(self, node):
        return self.column(node[2])

    def column(self, name: str):
        t = self.table
        if name in t.numerics:
            nc = t.numerics[name]
            vals = nc.values_f64.copy()
            vals[nc.null_mask] = np.nan
            return ("num", vals, nc.null_mask.copy())
        if name in t.strings:
            col = t.strings[name]
            return ("str", col.values, col.null_mask)
        if name in t.raw:
            null = t.is_null(name)
            return ("str", np.asarray(t.raw[name], dtype=object), null)
        raise DerivedKeyError(f"Unknown column {name!r} in key expression")

    def literal(self, v):
        if v is None:
            return ("str", np.full(self.n, None, object), np.ones(self.n, bool))
        if isinstance(v, str):
            return ("str", np.full(self.n, v, object), np.zeros(self.n, bool))
        return (
            "num",
            np.full(self.n, float(v), np.float64),
            np.zeros(self.n, bool),
        )

    def as_num(self, node):
        k, v, nl = self.eval(node)
        if k == "num":
            return k, v, nl
        # SQL numeric-context coercion (pd.to_numeric, like residual_eval)
        import pandas as pd

        out = pd.to_numeric(pd.Series(v), errors="coerce").to_numpy(
            np.float64, copy=True
        )
        out[nl] = np.nan
        return ("num", out, nl | np.isnan(out))

    def as_str(self, node):
        """(object values coerced to str, null) — the implicit SQL cast."""
        k, v, nl = self.eval(node)
        if k == "str":
            return _coerce_str(v, nl), nl
        return _num_to_str(v, nl), nl

    def _str_series(self, node):
        """Pandas Series (None for null) for vectorised .str operations."""
        import pandas as pd

        v, nl = self.as_str(node)
        if nl.any():
            v = v.copy()
            v[nl] = None
        return pd.Series(v, dtype=object), nl

    @staticmethod
    def _from_series(series, null) -> tuple[str, np.ndarray, np.ndarray]:
        import pandas as pd

        out = series.to_numpy(dtype=object, copy=True)
        miss = pd.isna(series).to_numpy() | null
        out[miss] = None
        return ("str", out, miss)

    def arith(self, op, a, b):
        _, va, na = self.as_num(a)
        _, vb, nb = self.as_num(b)
        with np.errstate(invalid="ignore", divide="ignore"):
            # fmod, not mod: SQL's % takes the DIVIDEND's sign (-7 % 3 is
            # -1 in Spark), numpy's mod the divisor's
            out = {
                "+": np.add, "-": np.subtract, "*": np.multiply,
                "/": np.divide, "%": np.fmod,
            }[op](va, vb)
        null = na | nb | np.isnan(out)
        out = out.copy()
        out[null] = np.nan
        return ("num", out, null)

    def cast(self, node, ctype):
        if ctype == "string":
            v, nl = self.as_str(node)
            return ("str", v, nl)
        _, v, nl = self.as_num(node)
        if ctype == "int":
            out = np.trunc(v)
            out[nl] = np.nan
            return ("num", out, nl)
        return ("num", v, nl)

    # -- functions -------------------------------------------------------

    def func(self, name, args):
        if name in ("coalesce", "ifnull", "nvl"):
            return self.coalesce(args)
        if name == "concat":
            return self.concat(args)
        if name in ("length", "char_length", "len"):
            (a,) = self._argcheck(name, args, 1)
            s, nl = self._str_series(a)
            out = s.str.len().to_numpy(np.float64, na_value=np.nan)
            return ("num", out, nl.copy())
        if name in ("abs", "floor", "ceil", "ceiling"):
            (a,) = self._argcheck(name, args, 1)
            _, v, nl = self.as_num(a)
            fn = {"abs": np.abs, "floor": np.floor, "ceil": np.ceil,
                  "ceiling": np.ceil}[name]
            with np.errstate(invalid="ignore"):
                return ("num", fn(v), nl)
        if name == "round":
            if len(args) not in (1, 2):
                raise DerivedKeyError("round takes 1 or 2 arguments")
            _, v, nl = self.as_num(args[0])
            d = 0
            if len(args) == 2:
                d = self._const_int(args[1], "round digits")
            # Spark SQL round is HALF_UP (away from zero at .5), NOT
            # numpy's banker's rounding — round(2.5) must key to 3 like
            # the reference's joins did
            scale = 10.0 ** d
            with np.errstate(invalid="ignore"):
                out = np.copysign(
                    np.floor(np.abs(v) * scale + 0.5), v
                ) / scale
            return ("num", out, nl)
        if name in ("substr", "substring"):
            return self.substr(args)
        if name in ("left", "right"):
            (a, nnode) = self._argcheck(name, args, 2)
            k = self._const_int(nnode, f"{name} length")
            if k < 0:
                raise DerivedKeyError(f"{name} length must be >= 0")
            s, nl = self._str_series(a)
            if name == "left":
                s = s.str.slice(0, k)
            else:
                s = s.str.slice(-k) if k else s.str.slice(0, 0)
            return self._from_series(s, nl)
        if name in ("lower", "upper", "trim", "ltrim", "rtrim", "reverse"):
            (a,) = self._argcheck(name, args, 1)
            s, nl = self._str_series(a)
            s = {
                "lower": lambda: s.str.lower(),
                "upper": lambda: s.str.upper(),
                "trim": lambda: s.str.strip(),
                "ltrim": lambda: s.str.lstrip(),
                "rtrim": lambda: s.str.rstrip(),
                "reverse": lambda: s.str.slice(step=-1),
            }[name]()
            return self._from_series(s, nl)
        if name in ("dmetaphone", "dmetaphone_alt"):
            (a,) = self._argcheck(name, args, 1)
            v, nl = self.as_str(a)
            return self.phonetic(name, v, nl)
        raise DerivedKeyError(f"Unknown key function {name!r}")

    def phonetic(self, name, v, nl):
        """DoubleMetaphone per UNIQUE value (the encoding is the expensive
        one; names repeat heavily), same codes as the precomputed __dm_
        columns (splink_tpu/ops/phonetic.py — bit-exact vs the reference
        jar's commons-codec bytecode)."""
        from .ops.phonetic import double_metaphone

        import pandas as pd

        codes, uniques = pd.factorize(pd.Series(v), use_na_sentinel=True)
        pick = 0 if name == "dmetaphone" else 1
        enc = np.array(
            [double_metaphone(str(u))[pick] for u in uniques], dtype=object
        )
        out = np.empty(self.n, object)
        valid = codes >= 0
        out[valid] = enc[codes[valid]]
        out[~valid] = None
        null = nl | ~valid
        return ("str", out, null)

    def substr(self, args):
        """Spark substring semantics (what the reference's joins ran on):
        1-based positive start; start 0 behaves like start 1; a NEGATIVE
        start anchors the window at len+start, so characters before the
        string's beginning consume length — substring('abcde', -7, 3) is
        'a', substring('abcde', -2, 2) is 'de'."""
        if len(args) not in (2, 3):
            raise DerivedKeyError("substr takes 2 or 3 arguments")
        start = self._const_int(args[1], "substr start")
        length = None
        if len(args) == 3:
            length = self._const_int(args[2], "substr length")
            if length < 0:
                raise DerivedKeyError("substr length must be >= 0")
        s, nl = self._str_series(args[0])
        if start >= 0:
            lo = max(start - 1, 0)
            s = s.str.slice(lo, None if length is None else lo + length)
            return self._from_series(s, nl)
        if length is None:
            return self._from_series(s.str.slice(start), nl)
        # negative start + length: the window is [len+start, len+start+length)
        # clipped to the string. Python computes per unique VALUE (like
        # phonetic()): names repeat heavily, so the loop is O(vocab), not
        # O(rows)
        import pandas as pd

        codes, uniques = pd.factorize(s, use_na_sentinel=True)
        enc = np.array(
            [
                u[max(len(u) + start, 0) : max(len(u) + start + length, 0)]
                for u in uniques
            ],
            dtype=object,
        )
        out = np.full(self.n, None, object)
        valid = codes >= 0
        out[valid] = enc[codes[valid]]
        return ("str", out, nl | ~valid)

    def concat(self, args):
        if not args:
            raise DerivedKeyError("concat needs at least one argument")
        parts = [self._str_series(a) for a in args]
        null = np.zeros(self.n, bool)
        for _, nl in parts:
            null |= nl  # Spark: concat is NULL if ANY argument is NULL
        first, rest = parts[0][0], [p[0] for p in parts[1:]]
        if rest:
            # na_rep=None keeps any-null -> null
            s = first.str.cat(rest)
        else:
            s = first
        return self._from_series(s, null)

    def coalesce(self, args):
        if not args:
            raise DerivedKeyError("coalesce needs at least one argument")
        parts = [self.eval(a) for a in args]
        kinds = {k for k, _, _ in parts}
        if kinds == {"num"}:
            out = np.full(self.n, np.nan)
            null = np.ones(self.n, bool)
            for _, v, nl in parts:
                take = null & ~nl
                out[take] = v[take]
                null &= nl
            return ("num", out, null)
        # mixed/str: string result, numeric branches cast to string
        out = np.full(self.n, None, object)
        null = np.ones(self.n, bool)
        for k, v, nl in parts:
            sv = v if k == "str" else _num_to_str(v, nl)
            take = null & ~nl
            out[take] = sv[take]
            null &= nl
        return ("str", out, null)

    def _argcheck(self, name, args, n):
        if len(args) != n:
            raise DerivedKeyError(f"{name} takes exactly {n} argument(s)")
        return args

    def _const_int(self, node, what) -> int:
        if node[0] == "neg" and node[1][0] == "lit":
            node = ("lit", -node[1][1])
        if node[0] != "lit" or not isinstance(node[1], float):
            raise DerivedKeyError(f"{what} must be a constant integer")
        if node[1] != int(node[1]):
            raise DerivedKeyError(f"{what} must be a constant integer")
        return int(node[1])


def evaluate_key(
    table: EncodedTable, expr: str
) -> tuple[str, np.ndarray, np.ndarray]:
    """(kind, values, null) for a one-sided canonical key expression over
    all rows. kind 'str' -> object array; 'num' -> float64 (NaN null).
    Cached per (table, canonical expression) — blocking joins, the prior-
    rule dedup and the estimator reuse one evaluation."""
    cache = getattr(table, "_derived_key_cache", None)
    if cache is None:
        cache = table._derived_key_cache = {}
    if expr not in cache:
        node = parse_key_expr(expr)
        if expr_sides(node):
            raise DerivedKeyError(
                f"evaluate_key expects a side-stripped expression: {expr!r}"
            )
        cache[expr] = _Eval(table).eval(node)
    return cache[expr]


def clear_derived_key_cache(table: EncodedTable) -> None:
    if getattr(table, "_derived_key_cache", None):
        table._derived_key_cache = {}


def pyast_to_keynode(node):
    """Convert a (translated-residual) Python AST value subtree into a
    derived-key tuple AST — the bridge that lets the host residual
    interpreter (residual_eval.py) and the device residual compiler
    (pairgen._ResCompiler) evaluate SQL scalar functions through ONE
    implementation of the semantics (this module). MatMult (``@``) is the
    translation of SQL's ``||`` (compat_sql) and becomes concat. Raises
    DerivedKeyError on anything outside the surface."""
    import ast

    if isinstance(node, ast.Call):
        if not isinstance(node.func, ast.Name):
            raise DerivedKeyError("call shape")
        name = node.func.id.lower()
        if name == "cast":
            # compat_sql rewrites `cast(x AS t)` -> `cast(x, 't')`
            if len(node.args) != 2 or not (
                isinstance(node.args[1], ast.Constant)
                and isinstance(node.args[1].value, str)
            ):
                raise DerivedKeyError("cast shape")
            ctype = _CAST_TYPES.get(node.args[1].value.lower())
            if ctype is None:
                raise DerivedKeyError(
                    f"Unsupported cast type {node.args[1].value!r}"
                )
            return ("cast", pyast_to_keynode(node.args[0]), ctype)
        if name not in KNOWN_FUNCS:
            raise DerivedKeyError(f"Unknown function {name!r}")
        return ("func", name, [pyast_to_keynode(a) for a in node.args])
    if isinstance(node, ast.Subscript):
        if not (
            isinstance(node.value, ast.Name)
            and node.value.id in ("l", "r")
            and isinstance(node.slice, ast.Constant)
            and isinstance(node.slice.value, str)
        ):
            raise DerivedKeyError("subscript shape")
        return ("col", node.value.id, node.slice.value)
    if isinstance(node, ast.Constant):
        if node.value is None:
            return ("lit", None)
        if isinstance(node.value, str):
            return ("lit", node.value)
        if isinstance(node.value, (int, float)) and not isinstance(
            node.value, bool
        ):
            return ("lit", float(node.value))
        raise DerivedKeyError(f"literal {node.value!r}")
    if isinstance(node, ast.UnaryOp) and isinstance(node.op, ast.USub):
        return ("neg", pyast_to_keynode(node.operand))
    if isinstance(node, ast.BinOp):
        if isinstance(node.op, ast.MatMult):
            return (
                "func",
                "concat",
                [pyast_to_keynode(node.left), pyast_to_keynode(node.right)],
            )
        ops = {
            ast.Add: "+", ast.Sub: "-", ast.Mult: "*", ast.Div: "/",
            ast.Mod: "%",
        }
        if type(node.op) in ops:
            return (
                "arith",
                ops[type(node.op)],
                pyast_to_keynode(node.left),
                pyast_to_keynode(node.right),
            )
    raise DerivedKeyError(f"value node {type(node).__name__}")


class PairEval(_Eval):
    """Evaluate a two-sided key AST on pair-gathered rows: ``l`` columns
    read through the i index array, ``r`` columns through j. Shares every
    function implementation with the full-table evaluator, so a SQL
    function behaves identically as a blocking join key and inside a
    residual predicate."""

    def __init__(self, table: EncodedTable, i: np.ndarray, j: np.ndarray):
        self.table = table
        self.n = len(i)
        self.rows = {"l": i, "r": j}

    def column_node(self, node):
        _, side, name = node
        if side is None:
            raise DerivedKeyError(
                f"Pair evaluation needs an l./r. side on column {name!r}"
            )
        rows = self.rows[side]
        t = self.table
        if name in t.numerics:
            nc = t.numerics[name]
            vals = nc.values_f64[rows].copy()
            null = nc.null_mask[rows]
            vals[null] = np.nan
            return ("num", vals, null.copy())
        if name in t.strings:
            col = t.strings[name]
            return ("str", col.values[rows], col.null_mask[rows].copy())
        if name in t.raw:
            null = t.is_null(name)[rows]
            return ("str", np.asarray(t.raw[name], dtype=object)[rows], null)
        raise DerivedKeyError(f"Unknown column {name!r} in key expression")


def key_values_object(
    table: EncodedTable, expr: str
) -> tuple[np.ndarray, np.ndarray]:
    """(values-as-objects, null) — numeric results become float objects so
    joint factorisation across differently-typed sides is well-defined
    (a float object never equals a str object)."""
    kind, vals, null = evaluate_key(table, expr)
    if kind == "str":
        return vals, null
    out = vals.astype(object)
    out[null] = None
    return out, null
