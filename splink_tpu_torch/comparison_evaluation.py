"""Blocking diagnostics: predict skew / explosion before running.

Port of the reference's get_largest_blocks
(splink/comparison_evaluation.py:12-34): extract the columns
a blocking rule keys on, and report the most frequent key values — the blocks
that will dominate pair generation.
"""

from __future__ import annotations

import re


def blocking_rule_columns(blocking_rule: str) -> list[str]:
    """Every l.-side column the rule references, in order, deduplicated —
    robust to function-of-column keys (``substr(l.surname, 1, 3) = ...``)
    and cross-column equalities (``l.first_name = r.surname``), which the
    reference's split-on-space-or-'=' parse would mangle into pseudo-column
    names. For a derived key the diagnostic groups by the underlying raw
    column — a superset blocking of the derived key, so still the right
    skew probe."""
    seen: dict[str, None] = {}
    for m in re.finditer(r"\bl\.(\w+)", blocking_rule):
        seen.setdefault(m.group(1))
    return list(seen)


def get_largest_blocks(blocking_rule: str, df, limit: int = 5):
    """Top-``limit`` key values by row count for a rule's join columns.

    Args:
        blocking_rule: e.g. ``"l.first_name = r.first_name"``.
        df: the input pandas DataFrame.

    Returns a DataFrame of the key columns plus a ``count`` column,
    descending — block pair counts scale with count^2.
    """
    cols = blocking_rule_columns(blocking_rule)
    if not cols:
        raise ValueError(f"Could not find any l.column references in {blocking_rule!r}")
    sub = df[cols].dropna()
    counts = (
        sub.groupby(cols, sort=False)
        .size()
        .reset_index(name="count")
        .sort_values("count", ascending=False, kind="stable")
        .head(limit)
        .reset_index(drop=True)
    )
    return counts
