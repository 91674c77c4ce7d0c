"""The plain reference: its string functions on hand cases and against a
brute-force dynamic programme, its lower bound of the edit distance, and
its agreement with the port on a small CPU job of each configuration."""

import time

import numpy as np
import pytest
import torch

from linkbench import harness
from linkbench.reference import strings

SMALL = {
    # cell: (rows, settings overrides that keep the cell's regime at this size)
    "people_train_virtual": (4000, {"max_resident_pairs": 1024, "pair_batch_size": 2048}),
    "people_train_resident": (4000, {"pair_batch_size": 2048}),
}


def _rows(words, width=None):
    width = width or max(1, max(len(w) for w in words))
    out = np.zeros((len(words), width), np.uint8)
    for i, w in enumerate(words):
        out[i, :len(w)] = np.frombuffer(w.encode(), np.uint8)
    return torch.from_numpy(out), torch.tensor([len(w) for w in words])


def _levenshtein_brute(a, b):
    row = list(range(len(b) + 1))
    for i, ca in enumerate(a, 1):
        prev, row[0] = row[0], i
        for j, cb in enumerate(b, 1):
            prev, row[j] = row[j], min(row[j] + 1, row[j - 1] + 1, prev + (ca != cb))
    return row[-1]


def test_jaro_winkler_hand_cases():
    cases = {("martha", "marhta"): 0.9611111, ("dixon", "dicksonx"): 0.8133333,
             ("dwayne", "duane"): 0.84, ("abc", "abc"): 1.0, ("abc", "xyz"): 0.0}
    left, ll = _rows([a for a, _ in cases], 8)
    right, lr = _rows([b for _, b in cases], 8)
    got = strings.jaro_winkler(left, right, ll, lr)
    assert np.allclose(got.numpy(), list(cases.values()), atol=1e-6)


def test_levenshtein_and_bound_against_brute_force():
    rng = np.random.default_rng(7)
    letters = "abc de"
    words = ["".join(rng.choice(list(letters), rng.integers(0, 40))) for _ in range(400)]
    a, la = _rows(words[:200], 40)
    b, lb = _rows(words[200:], 40)
    got = strings.levenshtein(a, b, la, lb)
    want = [_levenshtein_brute(x, y) for x, y in zip(words[:200], words[200:])]
    assert got.tolist() == want
    lookup = torch.zeros(256, dtype=torch.int64)
    lookup[torch.tensor([ord(c) for c in letters])] = torch.arange(len(letters))
    pa = strings.bigram_profiles(a, la, lookup)
    pb = strings.bigram_profiles(b, lb, lookup)
    bound = strings.distance_lower_bound(pa, pb, la, lb)
    assert (bound <= got.to(torch.int64)).all()
    assert (bound > 0).any()


@pytest.mark.parametrize("cell", list(SMALL))
def test_reference_agrees_with_the_port(cell):
    rows, overrides = SMALL[cell]
    r = harness.run_cell(cell, 2**31 + 7, 0.1, False, time.perf_counter(), device="cpu",
                         rows=rows, overrides=overrides, log=lambda *a, **k: None)
    assert r["failed"] == 0
    assert r["correct"], r["checks"]
    assert r["checks"]["pairs_gap"]["value"] == 0
    assert r["checks"]["em_gap"]["value"] < 1e-5
