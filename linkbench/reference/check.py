"""What the reference computes over a cell's input, and the numbers that
hold a job's outputs to it.

``reference_pass`` walks every candidate pair of the input once (the
union of the blocking rules), on the card in blocks of pairs, and keeps the histogram of the pairs' gamma
patterns, the pair count, the work the Levenshtein kernel needs (for the
roofline share) and, where asked, every pair with its levels. ``numbers``
compares a job's outputs with that:

* ``pairs_gap``: pairs in one pair set and not in the other (where the job
  keeps no pairs: the difference of the counts);
* ``pattern_gap``: the sum over gamma patterns of the difference of the
  pair counts;
* ``gamma_gap``: pairs of both sets whose levels differ in any column;
* ``em_gap``: the worst leaf's gap (lambda, a column's m, a column's u;
  ``em.trajectory_gap``) over the EM updates both reached and between the
  two fitted states, so that a run which stops early or late is far off.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np
import torch

from .. import yardstick
from . import em as ref_em
from .gammas import Reference, StringColumn, n_keys, pattern_keys
from .pairs import RulePairs


@dataclass
class RefOutput:
    total: int
    hist: np.ndarray  # (n_keys,) pairs per pattern key
    levels: list
    keys: torch.Tensor | None = None  # left * n + right of every pair, sorted
    gammas: torch.Tensor | None = None  # the levels in the order of ``keys``
    work: dict = field(default_factory=dict)  # column -> (ops, bytes) of one job


def reference_pass(df, settings: dict, device, dtype=torch.float32, keep_pairs=False,
                   count_work=False) -> RefOutput:
    ref = Reference(df, settings, device)
    uid = df[settings.get("unique_id_column_name", "unique_id")].to_numpy()
    pairs = RulePairs(df, settings["blocking_rules"], uid, device)
    hist = torch.zeros(n_keys(ref.levels), dtype=torch.int64, device=device)
    gammas = []
    lev_cols = [c for c in settings["comparison_columns"]
                if c["comparison"]["kind"] == "levenshtein"] if count_work else []
    ops = {c["col_name"]: 0 for c in lev_cols}
    for left, right in pairs.batches():
        G = ref.gammas(left, right, dtype)
        hist += torch.bincount(pattern_keys(G, ref.levels), minlength=len(hist))
        if keep_pairs:
            gammas.append(G)
        for c in lev_cols:
            col: StringColumn = ref.data[c["col_name"]]
            la = col.lengths[torch.clamp(col.code[left], min=0)] * (col.code[left] >= 0)
            lb = col.lengths[torch.clamp(col.code[right], min=0)] * (col.code[right] >= 0)
            ops[c["col_name"]] += yardstick.levenshtein_ops(la, lb, col.chars.element_size())
    out = RefOutput(total=pairs.total, hist=hist.cpu().numpy(), levels=ref.levels)
    for c in lev_cols:
        col = ref.data[c["col_name"]]
        width = yardstick.padded_width(col.max_length, c.get("max_string_length", 24))
        out.work[c["col_name"]] = (
            ops[c["col_name"]],
            yardstick.levenshtein_bytes(pairs.total, width, col.chars.element_size()))
    if keep_pairs:
        out.keys = pairs.keys
        out.gammas = torch.cat(gammas) if gammas else torch.zeros(
            (0, len(ref.levels)), dtype=torch.int8, device=device)
    return out


def decode_keys(keys: np.ndarray, levels) -> np.ndarray:
    """(P, C) levels of pattern keys (the inverse of ``pattern_keys``)."""
    out = np.empty((len(keys), len(levels)), np.int64)
    rest = np.asarray(keys, np.int64).copy()
    for c in range(len(levels) - 1, -1, -1):
        out[:, c] = rest % (levels[c] + 1) - 1
        rest //= levels[c] + 1
    return out


def em_trajectory(hist: np.ndarray, levels, settings: dict, dtype=torch.float64):
    seen = np.flatnonzero(hist)
    return ref_em.run_em(decode_keys(seen, levels), hist[seen], settings, dtype)


def program_hist(counts: np.ndarray, patterns: np.ndarray, levels) -> np.ndarray:
    """A job's pattern counts (over its own pattern matrix) as a histogram
    over the reference's pattern keys."""
    keys = pattern_keys(torch.from_numpy(np.asarray(patterns)), levels).numpy()
    out = np.zeros(n_keys(levels), np.int64)
    np.add.at(out, keys, np.asarray(counts, np.int64)[: len(keys)])
    return out


def pair_numbers(keys: torch.Tensor, gammas: torch.Tensor, ref: RefOutput) -> dict:
    """``pairs_gap`` and ``gamma_gap`` of a job's pairs (``keys``, any
    order) and their levels against the reference's."""
    keys, order = torch.sort(keys)
    gammas = gammas[order]
    rk = ref.keys
    dupes = len(keys) - len(torch.unique_consecutive(keys))
    if len(rk):
        idx = torch.clamp(torch.searchsorted(rk, keys), max=len(rk) - 1)
        found = rk[idx] == keys
    else:
        idx = torch.zeros_like(keys)
        found = torch.zeros(len(keys), dtype=torch.bool, device=keys.device)
    n_found = int(found.sum())
    pairs_gap = (len(keys) - n_found) + (len(rk) - (n_found - dupes)) + dupes
    differ = (gammas[found] != ref.gammas[idx[found]]).any(dim=1)
    return {"pairs_gap": int(pairs_gap), "gamma_gap": int(differ.sum())}


def em_numbers(trajectory, ref_trajectory) -> dict:
    """``em_gap`` over the updates both reached and between the two fitted
    states (so a run that stops early or late is far off), and the
    difference of the update counts (reported, not limited)."""
    gap = max(ref_em.trajectory_gap(trajectory, ref_trajectory),
              ref_em.trajectory_gap(trajectory[-1:], ref_trajectory[-1:]))
    return {"em_gap": gap, "em_updates_gap": abs(len(trajectory) - len(ref_trajectory))}
