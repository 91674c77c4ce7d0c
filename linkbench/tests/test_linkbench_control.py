"""The comparison fails what it has to fail: the control (the reference in
the program's place, one precision below the configuration's), a job on
another path than the cell's, and the faults a cell can have, each planted
underneath a whole run on the CPU (the harness's look for a card is
skipped; the one-chip cells have no exchange between chips to leave
out)."""

import time

import numpy as np
import pytest
import torch

from linkbench import harness, readings
from linkbench.reference import check
from test_linkbench_reference import SMALL


def _run(cell, overrides=None):
    rows, small = SMALL[cell]
    return harness.run_cell(cell, 2**31 + 11, 0.1, False, time.perf_counter(), device="cpu",
                            rows=rows, overrides={**small, **(overrides or {})},
                            log=lambda *a, **k: None)


@pytest.mark.parametrize("cell", list(SMALL))
def test_control_is_not_correct(cell):
    rows, small = SMALL[cell]
    c = harness.load_cell(cell)
    settings = {**c.settings, **small}
    df = harness.make_frame(c, 2**31 + 13, rows)
    keep = c.workload.get("keep_pairs", False)
    ref = check.reference_pass(df, settings, "cpu", keep_pairs=keep)
    traj = check.em_trajectory(ref.hist, ref.levels, settings)
    numbers = readings.control_numbers(c, df, settings, "cpu", ref, traj)
    correct, _ = harness.judge(numbers, c.workload["limits"])
    assert not correct, numbers


def test_another_regime_fails():
    # without the small max_resident_pairs the virtual cell's job stays resident
    r = _run("people_train_virtual", {"max_resident_pairs": 268435456})
    assert r["failed"] == r["attempted"] > 0
    assert not r["correct"]


def test_other_kernel_variants_fail():
    c = harness.load_cell("people_train_virtual")
    masked, lev = "jaro_winkler/u8/w1/masked", "levenshtein/u8/w1"
    job = harness.Job(seconds=1.0, cpu_seconds=1.0, stages={s: 0.1 for s in c.workload["stages"]},
                      variants={masked: 600, lev: 600, "levenshtein/u8/w0": 1},
                      tiers={"device": 0, "host": 0}, trajectory=[])
    assert harness.job_faults(job, c, c.settings, 300 << 20, on_card=True)
    job.variants = {masked: 600, lev: 600}
    assert not harness.job_faults(job, c, c.settings, 300 << 20, on_card=True)
    job.variants = {masked: 400, lev: 400}  # too few batches
    assert harness.job_faults(job, c, c.settings, 300 << 20, on_card=True)
    job.variants = {"jaro_winkler/u8/w1": 600, lev: 600}  # dense, not masked
    assert harness.job_faults(job, c, c.settings, 300 << 20, on_card=True)


def _unchanged_step(monkeypatch):
    from splink_tpu_torch import em

    seen = {}
    replicate = em._replicate

    def remember(params, shards):
        seen["params"] = params
        return replicate(params, shards)

    monkeypatch.setattr(em, "_replicate", remember)
    monkeypatch.setattr(em, "update_params", lambda stats: seen["params"])


def _half_batch(monkeypatch):
    from splink_tpu_torch import em

    stats = em.shard_stats

    def half(shards, w_shards, on_shards, max_levels, designs=None):
        def cut(xs):
            if xs is None:
                return None
            return type(xs)(None if x is None else x[: max(1, len(x) // 2)] for x in xs)

        return stats(cut(shards), cut(w_shards), on_shards, max_levels, cut(designs))

    monkeypatch.setattr(em, "shard_stats", half)


def _altered_answer(monkeypatch):
    from splink_tpu_torch import gammas

    spec = gammas._spec_gamma

    def alter(col_settings, ctx, two_phase):  # one level of each batch and column
        out = spec(col_settings, ctx, two_phase)
        if len(out) and int(out[0]) >= 0:
            out = out.clone()
            out[0] = (int(out[0]) + 1) % int(col_settings["num_levels"])
        return out

    monkeypatch.setattr(gammas, "_spec_gamma", alter)


FAULTS = {"unchanged_step": _unchanged_step, "half_batch": _half_batch,
          "altered_answer": _altered_answer}


@pytest.mark.parametrize("cell", list(SMALL))
@pytest.mark.parametrize("fault", list(FAULTS))
def test_planted_fault_is_not_correct(monkeypatch, cell, fault):
    FAULTS[fault](monkeypatch)
    r = _run(cell)
    assert not r["correct"], r["checks"]


def test_trajectory_gap_scale():
    m = np.array([[0.1, 0.2, 0.7]])
    u = np.array([[0.9, 0.1 - 1e-9, 1e-9]])
    a = [(0.3, m, u)]
    b = [(0.3, m, np.array([[0.9, 0.1, 0.0]]))]
    assert check.em_numbers(a, b)["em_gap"] < 1e-8
    assert check.em_numbers(a, [(0.3, m + 1e-3, u)])["em_gap"] > 1e-4
    assert torch.bfloat16 == readings.CONTROL_DTYPE
