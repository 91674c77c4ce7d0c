"""Translation of reference-splink SQL surface syntax into splink_tpu specs.

The reference configures comparisons with SQL CASE expressions
(splink/case_statements.py:62-277) and blocking with SQL join
predicates (splink/blocking.py:95-160). splink_tpu's native
configuration is declarative spec dicts, but for drop-in compatibility we
recognise the reference's generated CASE shapes and equality-join blocking
rules and translate them. Anything unrecognised raises with a pointer to the
native spec format.
"""

from __future__ import annotations

import re

_NUM = r"([0-9]*\.?[0-9]+(?:[eE][-+]?[0-9]+)?)"


class SqlTranslationError(ValueError):
    pass


def _normalise(expr: str) -> str:
    s = expr.replace("\n", " ").replace("\r", " ")
    s = re.sub(r"\s+", " ", s).strip()
    return s


def parse_case_expression(expr: str, num_levels: int) -> dict:
    """Translate a recognised SQL CASE expression into a comparison spec dict.

    Recognised families (the shapes the reference's generators emit):
      * strict equality          -> {"kind": "exact"}
      * jaro_winkler_sim(...) > t chains -> {"kind": "jaro_winkler", "thresholds": [...]}
      * levenshtein(...)/avg-len <= t chains (with equality top level)
                                 -> {"kind": "levenshtein", "thresholds": [...]}
      * abs(a - b) < t chains    -> {"kind": "numeric_abs", "thresholds": [...]}
      * abs(a - b)/abs(max) < t  -> {"kind": "numeric_perc", "thresholds": [...]}

    thresholds[0] always gates the top similarity level.
    """
    s = _normalise(expr).lower()

    if "jaro_winkler_sim" in s and "ifnull" in s:
        # The reference's name-inversion generator
        # (splink/case_statements.py:254-277): an OR-list of
        # jw(col_l, ifnull(other_r, ...)) terms at level 2.
        spec = _parse_name_inversion(s)
        if spec is not None:
            if num_levels != 4:
                raise SqlTranslationError(
                    "name-inversion case_expression emits gamma levels 0-3 "
                    f"but num_levels={num_levels}; set num_levels to 4: {expr!r}"
                )
            return spec

    if "jaro_winkler_sim" in s:
        pairs = re.findall(rf"jaro_winkler_sim\([^)]*\)\s*>\s*{_NUM}\s*then\s*(\d+)", s)
        if pairs:
            _check_generated_frame(expr, s)
            _check_level_coverage(expr, pairs, num_levels)
            by_level = sorted(pairs, key=lambda p: -int(p[1]))
            return {"kind": "jaro_winkler", "thresholds": [float(t) for t, _ in by_level]}

    if "levenshtein" in s:
        # Reference shape (splink/case_statements.py:117-141):
        # strict equality gates the TOP level, levenshtein-ratio thresholds
        # gate levels num_levels-2 .. 1.
        pairs = re.findall(rf"<=\s*{_NUM}\s*then\s*(\d+)", s)
        anchored = re.findall(
            rf"levenshtein\([^)]*\)\s*/[^<]*<=\s*{_NUM}\s*then\s*(\d+)", s
        )
        if pairs and len(anchored) != len(pairs):
            raise SqlTranslationError(
                "case_expression mixes levenshtein-ratio thresholds with "
                f"other <= conditions; not a generated shape: {expr!r}"
            )
        if pairs:
            _check_generated_frame(expr, s)
            levels = {int(lv) for _, lv in pairs}
            eq = re.search(r"when\s+(\w+)_l\s*=\s*\1_r\s+then\s+(\d+)", s)
            if (
                levels != set(range(1, num_levels - 1))
                or not eq
                or int(eq.group(2)) != num_levels - 1
            ):
                raise SqlTranslationError(
                    f"levenshtein case_expression gates levels {sorted(levels)} "
                    f"(equality level: {eq.group(2) if eq else 'missing'}) but "
                    f"num_levels={num_levels}; this CASE shape is not fully "
                    f"recognised: {expr!r}. Provide a native 'comparison' spec."
                )
            return {"kind": "levenshtein", "thresholds": [
                float(t) for t, _ in sorted(pairs, key=lambda p: -int(p[1]))
            ]}

    if re.search(r"abs\(", s) and "/" in s:
        # Every `< t then n` must be the generated relative-difference term
        # (abs(diff)/denominator < t); a mix of relative and absolute
        # thresholds is a hand-written CASE and must not be collapsed into a
        # single all-relative kernel.
        pairs = re.findall(rf"<\s*{_NUM}\s*then\s*(\d+)", s)
        anchored = re.findall(
            rf"abs\([^)]*\)\s*\)*\s*/[^<]*<\s*{_NUM}\s*then\s*(\d+)", s
        )
        if pairs and len(anchored) != len(pairs):
            raise SqlTranslationError(
                "case_expression mixes relative-difference thresholds with "
                f"other < conditions; not a generated shape: {expr!r}"
            )
        if pairs:
            _check_generated_frame(expr, s)
            _check_level_coverage(expr, pairs, num_levels)
            by_level = sorted(pairs, key=lambda p: -int(p[1]))
            return {"kind": "numeric_perc", "thresholds": [float(t) for t, _ in by_level]}

    if re.search(r"abs\(", s):
        pairs = re.findall(rf"<\s*{_NUM}\s*then\s*(\d+)", s)
        anchored = re.findall(
            rf"abs\([^)]*\)\s*\)*\s*<\s*{_NUM}\s*then\s*(\d+)", s
        )
        if pairs and len(anchored) != len(pairs):
            raise SqlTranslationError(
                "case_expression mixes abs-difference thresholds with other "
                f"< conditions; not a generated shape: {expr!r}"
            )
        if pairs:
            _check_generated_frame(expr, s)
            _check_level_coverage(expr, pairs, num_levels)
            by_level = sorted(pairs, key=lambda p: -int(p[1]))
            return {"kind": "numeric_abs", "thresholds": [float(t) for t, _ in by_level]}

    if "dmetaphone" in s:
        # DoubleMetaphone-UDF comparison shapes: phonetic equality at level 1,
        # optionally under strict equality at level 2. Full-shape match only —
        # extra branches/conjuncts route to the general CASE compiler.
        _NULLB = (
            r"(?:when\s+(?P<nb>\w+)_l\s+is\s+null\s+or\s+(?P=nb)_r\s+is\s+null\s+"
            r"then\s*-1\s+)?"
        )
        m3 = re.fullmatch(
            r"case\s+" + _NULLB +
            r"when\s+(?P<c>\w+)_l\s*=\s*(?P=c)_r\s+then\s+2\s+when\s+"
            r"dmetaphone\(\s*(?P=c)_l\s*\)\s*=\s*dmetaphone\(\s*(?P=c)_r\s*\)\s*"
            r"then\s+1\s+else\s+0\s+end",
            s,
        )
        if m3 and num_levels == 3 and m3.group("nb") == m3.group("c"):
            return {"kind": "dmetaphone"}
        m2 = re.fullmatch(
            r"case\s+" + _NULLB +
            r"when\s+dmetaphone\(\s*(?P<c>\w+)_l\s*\)\s*=\s*"
            r"dmetaphone\(\s*(?P=c)_r\s*\)\s*then\s+1\s+else\s+0\s+end",
            s,
        )
        if m2 and num_levels == 2 and m2.group("nb") == m2.group("c"):
            return {"kind": "dmetaphone"}
        raise SqlTranslationError(
            f"Unrecognised dmetaphone case_expression shape: {expr!r}. "
            'Provide a native spec {"comparison": {"kind": "dmetaphone"}} '
            "with num_levels 2 (phonetic equality) or 3 (exact, then phonetic), "
            "or rely on the general CASE compiler for hand-written variants."
        )

    # Strict-equality fast path: only the exact generated shape
    # (splink/case_statements.py:62-71) — null branch,
    # equality, else 0. Anything else (extra conditions, missing ELSE with
    # its SQL-NULL semantics) belongs to the general CASE compiler.
    m = re.fullmatch(
        r"case\s+when\s+(\w+)_l\s+is\s+null\s+or\s+\1_r\s+is\s+null\s+"
        r"then\s*-1\s+when\s+(\w+)_l\s*=\s*\2_r\s+then\s+1\s+"
        r"else\s+0\s+end",
        s,
    )
    if m and num_levels == 2 and m.group(1) == m.group(2):
        return {"kind": "exact"}

    raise SqlTranslationError(
        "Could not translate this case_expression into a splink_tpu comparison "
        f"spec: {expr!r}.\n"
        "Recognised CASE families (the shapes the reference's generators "
        "emit, splink/case_statements.py:62-277):\n"
        "  * strict equality                  -> kind 'exact'\n"
        "  * jaro_winkler_sim(...) > t chains -> kind 'jaro_winkler'\n"
        "  * levenshtein ratio <= t chains    -> kind 'levenshtein'\n"
        "  * abs(a - b) < t chains            -> kind 'numeric_abs'\n"
        "  * abs(a - b)/abs(max) < t chains   -> kind 'numeric_perc'\n"
        "  * dmetaphone equality (2/3 level)  -> kind 'dmetaphone'\n"
        "  * name-inversion jw + ifnull OR    -> kind 'name_inversion'\n"
        "Hand-written CASE expressions outside these shapes are compiled by "
        "the general CASE compiler (splink_tpu_torch/case_compiler.py) when "
        "used via settings; alternatively provide a native spec, e.g. "
        '{"comparison": {"kind": "jaro_winkler", "thresholds": [0.94, 0.88]}}, '
        "or implement the logic with splink_tpu_torch.register_comparison() and "
        '{"comparison": {"kind": "custom", "fn": ...}}.'
    )


def _check_generated_frame(expr: str, s: str) -> None:
    """The reference's generated CASE shapes all share one frame: a leading
    ``X_l is null or X_r is null then -1`` branch, no AND anywhere and no
    other OR. A hand-written CASE with extra conjuncts or without the null
    branch must NOT be collapsed onto a narrower native kernel — raising here
    routes it to the general CASE compiler, which executes it faithfully."""
    if re.search(r"\band\b", s):
        raise SqlTranslationError(
            "case_expression contains AND conjuncts, which the generated "
            f"shapes never do; not a generated shape: {expr!r}"
        )
    if len(re.findall(r"\bor\b", s)) != 1 or not re.search(
        r"when\s+(\w+)_l\s+is\s+null\s+or\s+\1_r\s+is\s+null\s+then\s*-1", s
    ):
        raise SqlTranslationError(
            "case_expression lacks the generated shapes' single "
            f"'X_l is null or X_r is null then -1' branch: {expr!r}"
        )


def _check_level_coverage(expr: str, pairs, num_levels: int) -> None:
    """Every level 1..num_levels-1 must be gated by an extracted threshold;
    a partial extraction means an unrecognised CASE shape and silent
    mistranslation, so raise instead."""
    levels = {int(lv) for _, lv in pairs}
    if levels != set(range(1, num_levels)):
        raise SqlTranslationError(
            f"case_expression gates levels {sorted(levels)} but num_levels="
            f"{num_levels} requires levels {list(range(1, num_levels))}; this "
            f"CASE shape is not fully recognised: {expr!r}. Provide a native "
            "'comparison' spec instead."
        )


def _parse_name_inversion(s: str) -> dict | None:
    main = re.search(rf"jaro_winkler_sim\((\w+)_l,\s*\1_r\)\s*>\s*{_NUM}\s*then\s*3", s)
    low = re.search(rf"jaro_winkler_sim\((\w+)_l,\s*\1_r\)\s*>\s*{_NUM}\s*then\s*1", s)
    others = re.findall(r"ifnull\((\w+)_r", s)
    if not (main and low and others):
        return None
    return {
        "kind": "name_inversion",
        "column": main.group(1),
        "other_columns": sorted(set(others)),
        "thresholds": [float(main.group(2)), float(low.group(2))],
    }


# --------------------------------------------------------------------------
# Blocking rules
# --------------------------------------------------------------------------

_EQ_TERM = re.compile(r"^\s*l\.(\w+)\s*=\s*r\.(\w+)\s*$")


def _split_single_eq(term: str) -> tuple[str, str] | None:
    """Split a term on its single top-level '=' (not <=, >=, !=, <>, ==),
    paren- and quote-aware. None when there is no clean single '='."""
    positions = []
    depth, i = 0, 0
    while i < len(term):
        ch = term[i]
        if ch == "'":
            end = term.find("'", i + 1)
            i = len(term) if end < 0 else end + 1
            continue
        if ch == "(":
            depth += 1
        elif ch == ")":
            depth -= 1
        elif ch == "=" and depth == 0:
            prev = term[i - 1] if i else ""
            nxt = term[i + 1] if i + 1 < len(term) else ""
            if prev not in "<>!=" and nxt != "=":
                positions.append(i)
        i += 1
    if len(positions) != 1:
        return None
    p = positions[0]
    return term[:p].strip(), term[p + 1 :].strip()


def _try_derived_eq(term: str) -> tuple[str, str] | None:
    """Recognise a function-of-column equality join term: ``EXPR_L = EXPR_R``
    where one side references only l.* columns and the other only r.*
    columns, both within the derived-key evaluator's function surface
    (splink_tpu/derived_keys.py). Returns the side-stripped canonical
    (left_key, right_key) — the reference runs such predicates as ordinary
    Spark joins (splink/blocking.py:141-158); here they
    become ordinary hash-join keys on precomputed derived columns."""
    from .derived_keys import (
        DerivedKeyError,
        canonical,
        expr_sides,
        parse_key_expr,
        strip_side,
    )

    parts = _split_single_eq(term)
    if parts is None:
        return None
    try:
        na, nb = parse_key_expr(parts[0]), parse_key_expr(parts[1])
    except DerivedKeyError:
        return None
    sa, sb = expr_sides(na), expr_sides(nb)
    if sa == {"l"} and sb == {"r"}:
        pass
    elif sa == {"r"} and sb == {"l"}:
        na, nb = nb, na
    else:
        return None
    return canonical(strip_side(na)), canonical(strip_side(nb))


def parse_blocking_rule(rule: str):
    """Parse a blocking rule into (equality_pairs, residual_predicate).

    equality_pairs: list of (left_key, right_key) from top-level AND-ed
    equality terms; these become hash-join keys (SQL inner-join equality
    semantics: rows with a null key never match). Each key is either a bare
    column name (``l.col = r.col``) or a side-stripped derived-key
    expression (``substr(l.surname,1,3) = substr(r.surname,1,3)`` ->
    ``substr(surname,1,3)`` on both sides) evaluated host-side by
    splink_tpu/derived_keys.py. Cross-column / cross-expression equalities
    (l.a = r.b) keep distinct left and right keys and hash-join over a
    shared vocabulary.

    residual_predicate: a compiled python expression (numpy semantics) for any
    remaining AND-ed terms, or None. Evaluated against dicts ``l``/``r`` of
    column arrays after the hash join.

    ``dmetaphone(l.col)`` terms resolve to the host-precomputed derived
    column ``__dm_col`` (splink_tpu/data.py), so phonetic blocking keys are
    ordinary hash-join keys.
    """
    s = _normalise(rule)
    s = re.sub(r"(?i)\bdmetaphone\(\s*(l|r)\.(\w+)\s*\)", r"\1.__dm_\2", s)
    if not s:
        raise SqlTranslationError("Empty blocking rule")
    # Split on top-level AND only — quote- and paren-aware, so literals like
    # 'rock and roll' or nested (a AND b) groups don't steer the split.
    terms = [t for t in (p.strip() for p in _split_top_level(s, "and")) if t]

    eq_pairs = []
    residual_terms = []
    for t in terms:
        m = _EQ_TERM.match(t)
        if m:
            eq_pairs.append((m.group(1), m.group(2)))
            continue
        derived = _try_derived_eq(t)
        if derived is not None:
            eq_pairs.append(derived)
        else:
            residual_terms.append(t)

    residual = None
    if residual_terms:
        residual = sql_predicate_to_python(" and ".join(f"({t})" for t in residual_terms))
    return eq_pairs, residual


def sql_predicate_to_python(pred: str) -> str:
    """Convert a simple SQL boolean predicate to a numpy-evaluable expression.

    Supports: l./r. column refs, = != <> < <= > >=, AND/OR/NOT, abs(),
    numeric and single-quoted string literals, IS [NOT] NULL via an ``_isna``
    helper. The returned source expects ``l`` and ``r`` dict-of-array
    namespaces.

    AND/OR/NOT become the numpy element-wise operators ``& | ~``, which bind
    *tighter* than comparisons in Python — so every comparison atom is
    parenthesised during translation to preserve SQL precedence.
    """
    s = _normalise(pred)
    # Substitute IS [NOT] NULL before parsing — its NOT must not be taken
    # as a boolean operator.
    s = re.sub(r"(?i)\bis\s+not\s+null\b", " __ISNOTNULL__", s)
    s = re.sub(r"(?i)\bis\s+null\b", " __ISNULL__", s)
    # Recursive descent over the boolean structure. Parens are only grouping
    # when they wrap a sub-expression containing top-level boolean operators;
    # otherwise they belong to the atom (function calls like abs(...),
    # parenthesised arithmetic) and must not be split apart.
    return _bool_expr(s)


def _split_top_level(s: str, word: str) -> list[str]:
    """Split s on the boolean keyword at paren depth 0, outside single-quoted
    string literals (case-insensitive) — a literal like 'rock and roll' or
    'Ft. (Worth' must not steer the parse."""
    parts, depth, last = [], 0, 0
    pat = re.compile(rf"(?i)\b{word}\b")
    pos = 0
    while pos < len(s):
        ch = s[pos]
        if ch == "'":
            end = s.find("'", pos + 1)
            pos = len(s) if end < 0 else end + 1
            continue
        if ch == "(":
            depth += 1
        elif ch == ")":
            depth -= 1
        elif depth == 0:
            m = pat.match(s, pos)
            if m and (pos == 0 or not s[pos - 1].isalnum()):
                parts.append(s[last:pos])
                last = m.end()
                pos = m.end()
                continue
        pos += 1
    parts.append(s[last:])
    return parts


def _bool_expr(s: str) -> str:
    s = s.strip()
    ors = _split_top_level(s, "or")
    if len(ors) > 1:
        return " | ".join(f"({_bool_expr(p)})" for p in ors)
    ands = _split_top_level(s, "and")
    if len(ands) > 1:
        return " & ".join(f"({_bool_expr(p)})" for p in ands)
    m = re.match(r"(?i)^\s*not\b(.*)$", s)
    if m:
        return f"~({_bool_expr(m.group(1))})"
    # fully-wrapped group whose parens match end-to-end -> recurse inside
    if s.startswith("(") and s.endswith(")") and _parens_match_whole(s):
        inner = s[1:-1]
        if (
            len(_split_top_level(inner, "or")) > 1
            or len(_split_top_level(inner, "and")) > 1
            or re.match(r"(?i)^\s*not\b", inner.strip())
            or (inner.strip().startswith("(") and _parens_match_whole(inner.strip()))
        ):
            return f"({_bool_expr(inner)})"
    return f"({_translate_atom(s)})"


def _parens_match_whole(s: str) -> bool:
    """True when s[0] == '(' pairs with s[-1] == ')' (quote-aware)."""
    depth = 0
    i = 0
    while i < len(s):
        ch = s[i]
        if ch == "'":
            end = s.find("'", i + 1)
            i = len(s) if end < 0 else end + 1
            continue
        if ch == "(":
            depth += 1
        elif ch == ")":
            depth -= 1
            if depth == 0:
                return i == len(s) - 1
        i += 1
    return False


def _rewrite_concat_and_cast(s: str) -> str:
    """Quote-aware lexical rewrites for the atom translation:
      * SQL's ``||`` string-concat operator becomes ``@`` (Python's MatMult
        — unused otherwise, so the residual evaluators can give it concat
        semantics WITHOUT conflating it with SQL's numeric ``+``, which on
        strings means add-after-cast, not concatenation);
      * ``cast(x AS t)`` becomes ``cast(x, 't')`` so the expression stays
        parseable Python (``as`` is a keyword)."""
    out, i = [], 0
    while i < len(s):
        ch = s[i]
        if ch == "'":
            end = s.find("'", i + 1)
            end = len(s) if end < 0 else end + 1
            out.append(s[i:end])
            i = end
            continue
        if s.startswith("||", i):
            out.append("@")
            i += 2
            continue
        m = re.match(r"(?i)\bas\s+(\w+)\s*\)", s[i:])
        if m and i and (s[i - 1].isspace()):
            out.append(f", '{m.group(1)}')")
            i += m.end()
            continue
        out.append(ch)
        i += 1
    return "".join(out)


def _translate_atom(atom: str) -> str:
    """Translate one comparison atom (no boolean operators) to Python."""
    s = _rewrite_concat_and_cast(atom)
    s = re.sub(r"\bl\.(\w+)", r'l["\1"]', s)
    s = re.sub(r"\br\.(\w+)", r'r["\1"]', s)
    s = re.sub(r"(?<![<>!=])=(?!=)", "==", s)
    s = s.replace("<>", "!=")
    s = re.sub(r'((?:l|r)\["\w+"\])\s*__ISNOTNULL__', r"~_isna(\1)", s)
    s = re.sub(r'((?:l|r)\["\w+"\])\s*__ISNULL__', r"_isna(\1)", s)
    return s.strip()
