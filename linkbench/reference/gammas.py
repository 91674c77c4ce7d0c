"""Comparison levels of candidate pairs, plain: the reference's reading of
each comparison kind of a configuration's settings, from the DataFrame
alone.

Levels: -1 where either side is null, else the count of thresholds passed.
``exact``: 1 where the two values are equal. ``jaro_winkler``: similarity
above each threshold (descending thresholds). ``levenshtein``: the top
level where the two values are equal, else distance / mean length at or
below each threshold. Similarities and ratios are compared in ``dtype``
with the threshold rounded to it.

Levenshtein distances are computed for the pairs that may fall under a
threshold; the others are proved above every threshold first by a lower
bound of the distance (lengths and bigram counts, ``strings``), with a
margin for rounding.
"""

from __future__ import annotations

import numpy as np
import torch

from . import strings

LEV_MARGIN = 0.02  # a ratio proved this far above the top threshold skips the DP
DP_BATCH = 1 << 16  # pairs per Levenshtein programme
JW_BATCH = 1 << 20


class StringColumn:
    """A string column by distinct value: characters (V, W), lengths (V,),
    and the row's value index (-1 for null), all on ``device``."""

    def __init__(self, values, device):
        import pandas as pd

        codes, uniques = pd.factorize(pd.Series(values, dtype=object), use_na_sentinel=True)
        uniques = [str(v) for v in uniques]
        lens = np.fromiter(map(len, uniques), np.int64, count=len(uniques))
        width = max(int(lens.max()) if len(lens) else 0, 1)
        if all(map(str.isascii, uniques)):
            flat = np.frombuffer("".join(uniques).encode("ascii"), np.uint8)
            chars = np.zeros((len(uniques), width), np.uint8)
        else:
            flat = np.frombuffer("".join(uniques).encode("utf-32-le"), np.int32)
            chars = np.zeros((len(uniques), width), np.int32)
        rows = np.repeat(np.arange(len(uniques)), lens)
        cols = np.arange(len(flat)) - np.repeat(np.cumsum(lens) - lens, lens)
        chars[rows, cols] = flat
        self.chars = torch.from_numpy(chars).to(device)
        self.lengths = torch.from_numpy(lens).to(device)
        self.code = torch.from_numpy(codes.astype(np.int64)).to(device)
        self.max_length = int(lens.max()) if len(lens) else 0
        self._profiles = None

    def profiles(self):
        """Bigram count profiles of the distinct values (built once)."""
        if self._profiles is None:
            present = torch.unique(self.chars.to(torch.int64))
            lookup = torch.zeros(int(present.max()) + 1, dtype=torch.int64,
                                 device=self.chars.device)
            lookup[present] = torch.arange(len(present), device=self.chars.device)
            self._profiles = strings.bigram_profiles(self.chars, self.lengths, lookup)
        return self._profiles


class Reference:
    """The levels of every comparison column of ``settings`` on ``df``."""

    def __init__(self, df, settings: dict, device):
        self.device = device
        self.columns = settings["comparison_columns"]
        self.data = {}
        for col in self.columns:
            if col.get("data_type") == "numeric":
                raise ValueError(f"no reference for numeric column {col['col_name']!r}")
            self.data[col["col_name"]] = StringColumn(df[col["col_name"]].to_numpy(), device)
        self.levels = [int(c["num_levels"]) for c in self.columns]

    def gammas(self, left, right, dtype=torch.float32):
        """(B, C) int8 levels of the pairs (left, right) of row indices."""
        out = [self._column(col, left, right, dtype) for col in self.columns]
        return torch.stack(out, dim=1).to(torch.int8)

    def _column(self, col, left, right, dtype):
        spec = col["comparison"]
        kind = spec["kind"]
        thresholds = list(spec.get("thresholds", ()))
        data = self.data[col["col_name"]]
        ca, cb = data.code[left], data.code[right]
        null = (ca < 0) | (cb < 0)
        if kind == "exact":
            level = (ca == cb).to(torch.int64)
        elif kind == "jaro_winkler":
            level = self._jaro_winkler(data, ca, cb, null, thresholds, dtype)
        elif kind == "levenshtein":
            level = self._levenshtein(data, ca, cb, null, thresholds, dtype)
            level = torch.where(ca == cb, int(col["num_levels"]) - 1, level)
        else:
            raise ValueError(f"no reference for comparison kind {kind!r}")
        return torch.where(null, -1, level)

    @staticmethod
    def _jaro_winkler(data, ca, cb, null, thresholds, dtype):
        level = torch.zeros(len(ca), dtype=torch.int64, device=ca.device)
        for s in range(0, len(ca), JW_BATCH):
            a = torch.clamp(ca[s:s + JW_BATCH], min=0)
            b = torch.clamp(cb[s:s + JW_BATCH], min=0)
            sim = strings.jaro_winkler(data.chars[a], data.chars[b], data.lengths[a],
                                       data.lengths[b], dtype)
            level[s:s + JW_BATCH] = sum((sim > _rounded(t, dtype)).to(torch.int64)
                                        for t in thresholds)
        return level

    @staticmethod
    def _levenshtein(data, ca, cb, null, thresholds, dtype):
        level = torch.zeros(len(ca), dtype=torch.int64, device=ca.device)
        a, b = torch.clamp(ca, min=0), torch.clamp(cb, min=0)
        la, lb = data.lengths[a], data.lengths[b]
        mean = (la + lb).to(torch.float64) / 2.0
        open_ = ~null & (ca != cb)
        top = max(_rounded(t, dtype) for t in thresholds)
        prof = data.profiles()
        bound = torch.zeros(len(ca), dtype=torch.int64, device=ca.device)
        for s in range(0, len(ca), JW_BATCH):
            sl = slice(s, s + JW_BATCH)
            bound[sl] = strings.distance_lower_bound(prof[a[sl]], prof[b[sl]], la[sl], lb[sl])
        need = open_ & (bound.to(torch.float64) <= (top * (1.0 + LEV_MARGIN)) * mean)
        rows = torch.nonzero(need).flatten()
        for s in range(0, len(rows), DP_BATCH):
            r = rows[s:s + DP_BATCH]
            d = strings.levenshtein(data.chars[a[r]], data.chars[b[r]], la[r], lb[r])
            half = (la[r].to(dtype) + lb[r].to(dtype)) / 2.0
            ratio = torch.where(half > 0, d.to(dtype) / half, torch.zeros((), dtype=dtype,
                                                                             device=d.device))
            level[r] = sum((ratio <= _rounded(t, dtype)).to(torch.int64) for t in thresholds)
        return level


def _rounded(t, dtype):
    """The threshold ``t`` rounded to ``dtype``, as a Python number."""
    return torch.tensor(t, dtype=dtype).item()


def pattern_keys(G: torch.Tensor, levels) -> torch.Tensor:
    """A key per gamma row: mixed radix over (level + 1) per column."""
    key = torch.zeros(G.shape[0], dtype=torch.int64, device=G.device)
    for c, lv in enumerate(levels):
        key = key * (lv + 1) + (G[:, c].to(torch.int64) + 1)
    return key


def n_keys(levels) -> int:
    return int(np.prod([lv + 1 for lv in levels]))
