"""The virtual pattern pass replayed as CUDA graphs, on a card.

On a card each rule of three batches or more runs its first full batch
eagerly, captures the second as a CUDA graph and replays it for every
later full batch (``pairgen._RuleBatches``). The replayed pass must equal
the eager pass of the same program, with the ids streamed and without:
the ids, the histogram, the survivor counts, the kernel launches by
variant and ``jw_pairs``; and it must make the host wait at most once (the
pass's one read) besides the ids' copies. Marked ``card``; skips without a
CUDA card. This file imports no JAX, so that it runs on the card:

    python -m pytest --noconftest -p no:cacheprovider -m card tests/test_torch_pattern_graph.py
"""

import numpy as np
import pandas as pd
import pytest
import torch

from splink_tpu_torch import _device, data, pairgen
from splink_tpu_torch.gammas import GammaProgram
from splink_tpu_torch.ops import strings_cuda
from splink_tpu_torch.settings import complete_settings_dict
from splink_tpu_torch.utils import profiling

BATCH = 1024


def _settings():
    return complete_settings_dict({
        "link_type": "dedupe_only",
        "blocking_rules": ["l.city = r.city", "l.dob = r.dob"],
        "comparison_columns": [
            {"col_name": "first_name", "num_levels": 3,
             "comparison": {"kind": "jaro_winkler", "thresholds": [0.94, 0.88]}},
            {"col_name": "surname", "num_levels": 3,
             "comparison": {"kind": "jaro_winkler", "thresholds": [0.94, 0.88]}},
            {"col_name": "street", "num_levels": 3,
             "comparison": {"kind": "levenshtein", "thresholds": [0.3]}},
            {"col_name": "dob", "num_levels": 2, "comparison": {"kind": "exact"}},
        ],
    })


def _frame(n=3000, seed=11):
    rng = np.random.default_rng(seed)
    letters = np.array(list("abcdefghijklmnop"))
    words = lambda k, lo, hi: np.array(  # noqa: E731
        ["".join(rng.choice(letters, rng.integers(lo, hi))) for _ in range(k)], dtype=object)
    first, last, street = words(60, 3, 9), words(80, 4, 11), words(300, 6, 15)
    pick = lambda pool: pool[rng.integers(0, len(pool), n)]  # noqa: E731
    return pd.DataFrame({
        "unique_id": np.arange(n), "first_name": pick(first), "surname": pick(last),
        "street": pick(street), "city": rng.choice([f"c{k}" for k in range(16)], n),
        "dob": rng.choice([f"d{k}" for k in range(40)], n),
    })


@pytest.fixture(scope="module")
def job():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    settings = _settings()
    table = data.encode_table(_frame(), settings)
    plan = pairgen.build_virtual_plan(settings, table, chunk=64)
    program = GammaProgram(settings, table, device="cuda")
    assert program.capturable and all(rp.total > 2 * BATCH for rp in plan.rules)
    return program, plan, dict(_device._CONSTANTS)


def _pass(program, plan, want_ids, graphs, monkeypatch):
    """(ids or None, counts, the run's counters, the variant launches, the
    batches' graph attributes) of one pass, with or without graphs."""
    if not graphs:
        monkeypatch.setattr(GammaProgram, "capturable", property(lambda self: False))
    strings_cuda.variant_launches.clear()
    run = profiling.begin_run(f"pattern-graph-{want_ids}-{graphs}")
    try:
        ids, counts, _ = pairgen.compute_virtual_pattern_ids(program, plan, BATCH,
                                                             return_ids=want_ids)
        modes = [sp["attrs"]["graph"] for sp in profiling.run_spans(run)
                 if sp["name"] == "pattern_batch"]
        return ids, counts, profiling.run_counters(run), dict(strings_cuda.variant_launches), modes
    finally:
        profiling.discard_run(run)
        monkeypatch.undo()


@pytest.mark.card
@pytest.mark.parametrize("want_ids", [True, False], ids=["ids", "histogram"])
def test_replayed_pass_equals_eager_pass(job, want_ids, monkeypatch):
    program, plan, constants = job
    _pass(program, plan, want_ids, True, monkeypatch)  # the plan's arrays on the card
    e_ids, e_counts, e_ctr, e_launch, e_modes = _pass(program, plan, want_ids, False,
                                                      monkeypatch)
    g_ids, g_counts, g_ctr, g_launch, g_modes = _pass(program, plan, want_ids, True,
                                                      monkeypatch)
    assert set(e_modes) == {"eager"}
    full = [rp.total // BATCH for rp in plan.rules]
    want_modes = []
    for rp, k in zip(plan.rules, full):
        tail = ["eager"] * (rp.total % BATCH > 0)
        want_modes += ["eager", "capture"] + ["replay"] * (k - 2) + tail
    assert g_modes == want_modes
    assert g_ctr["pattern_graph_captures"] == len(plan.rules)
    assert g_ctr["pattern_graph_replays"] == sum(k - 1 for k in full)
    assert g_ctr["pattern_batches"] == e_ctr["pattern_batches"] == len(g_modes)
    if want_ids:
        np.testing.assert_array_equal(g_ids, e_ids)
    else:
        assert g_ids is None and e_ids is None
    np.testing.assert_array_equal(g_counts, e_counts)
    assert g_launch == e_launch
    assert g_launch == {"jaro_winkler/u8/w1/masked": 2 * len(g_modes),
                        "levenshtein/u8/w1": len(g_modes)}
    for name in ("jw_pairs", "jw_pairs.first_name", "jw_pairs.surname", "jw_survivors",
                 "jw_survivors.first_name", "jw_survivors.surname"):
        assert g_ctr[name] == e_ctr[name], name
    assert g_ctr["jw_pairs"] == 2 * plan.n_candidates
    # the pass's one read, and one wait a batch for the ids' copies; the
    # program made its constants, and no batch uploads one
    assert g_ctr.get("host_syncs", 0) <= 1 + (len(g_modes) if want_ids else 0)
    assert "h2d_copies" not in g_ctr and "h2d_copies" not in e_ctr
    assert _device._CONSTANTS == constants
