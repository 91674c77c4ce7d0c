"""Candidate pairs of a deduplication under a list of blocking rules,
plain: every unordered pair of rows that some rule joins, once, oriented
(lower unique_id, higher unique_id). A rule is a conjunction of equalities
``l.x = r.x and l.y = r.y ...``; a row with a null in any of its columns
takes no part in that rule."""

from __future__ import annotations

import itertools
import re

import numpy as np
import torch


def rule_columns(rule: str) -> list[str]:
    """The columns of a rule ``l.x = r.x [and l.y = r.y ...]``."""
    cols = []
    for part in re.split(r"\s+and\s+", rule.strip(), flags=re.IGNORECASE):
        m = re.fullmatch(r"\s*l\.(\w+)\s*=\s*r\.(\w+)\s*", part)
        if m is None or m.group(1) != m.group(2):
            raise ValueError(f"the reference blocks on equalities 'l.x = r.x' only, not {rule!r}")
        cols.append(m.group(1))
    return cols


def group_codes(df, cols) -> np.ndarray:
    """A code per row for the values of ``cols`` together; -1 where any is null."""
    import pandas as pd

    key = np.zeros(len(df), np.int64)
    null = np.zeros(len(df), bool)
    for c in dict.fromkeys(cols):
        codes, uniques = pd.factorize(df[c], use_na_sentinel=True)
        null |= codes < 0
        key = key * (len(uniques) + 1) + codes + 1
        key = np.unique(key, return_inverse=True)[1].astype(np.int64)
    return np.where(null, -1, key)


def _pairs_within(codes: np.ndarray) -> int:
    sizes = np.unique(codes[codes >= 0], return_counts=True)[1].astype(np.int64)
    return int((sizes * (sizes - 1) // 2).sum())


def pair_count(df, rules) -> int:
    """The pairs the union of ``rules`` gives, by inclusion and exclusion
    over the rules (the pairs joined by every rule of a subset are those
    equal on all of its columns)."""
    cols = [rule_columns(r) for r in rules]
    total = 0
    for k in range(1, len(rules) + 1):
        for subset in itertools.combinations(cols, k):
            both = [c for part in subset for c in part]
            total += (-1) ** (k + 1) * _pairs_within(group_codes(df, both))
    return total


def _block_keys(codes: np.ndarray, uid: np.ndarray, n: int, device):
    """left * n + right (row indices, lower uid left) of every pair of rows
    with equal non-negative ``codes``, as int64 tensors a group size."""
    rows = np.flatnonzero(codes >= 0)
    order = rows[np.lexsort((uid[rows], codes[rows]))]
    k = codes[order]
    starts = np.concatenate([[0], np.flatnonzero(np.diff(k)) + 1]).astype(np.int64)
    sizes = np.diff(np.concatenate([starts, [len(k)]])).astype(np.int64)
    order_t = torch.from_numpy(order.astype(np.int64)).to(device)
    for size in np.unique(sizes):
        if size < 2:
            continue
        i, j = torch.triu_indices(int(size), int(size), 1, device=device)
        st = torch.from_numpy(starts[sizes == size]).to(device)
        per = max(1, (1 << 24) // len(i))
        for s in range(0, len(st), per):
            base = st[s:s + per, None]
            yield (order_t[(base + i[None, :]).reshape(-1)] * n
                   + order_t[(base + j[None, :]).reshape(-1)])


class RulePairs:
    """The pairs of ``rules`` over ``df``: ``keys`` (left * n + right,
    sorted, each pair once) on ``device``; ``batches`` gives them as
    (left, right) row tensors."""

    def __init__(self, df, rules, uid: np.ndarray, device):
        self.n = len(df)
        parts = [key for rule in rules
                 for key in _block_keys(group_codes(df, rule_columns(rule)), uid, self.n, device)]
        keys = torch.cat(parts) if parts else torch.zeros(0, dtype=torch.int64, device=device)
        del parts
        self.keys = torch.unique(keys) if len(rules) > 1 else torch.sort(keys).values
        self.total = len(self.keys)

    def batches(self, max_pairs: int = 1 << 22):
        for s in range(0, self.total, max_pairs):
            k = self.keys[s:s + max_pairs]
            yield k // self.n, k % self.n
