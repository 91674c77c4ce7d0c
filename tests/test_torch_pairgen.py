"""splink_tpu_torch's virtual pair index (pairgen.py) against splink_tpu's.

Device pair generation decodes candidate pairs from per-rule unit tables
instead of materialising them. The port must build the SAME plan (unit
tables, key codes, uid codes), decode the same (i, j) at every position —
its int64/float64 device decode against the reference's host oracle and
its jitted int32/f32 kernel — mask the same positions, and give the same
pattern ids and histogram, exactly. The unmasked decoded pairs equal host
blocking's pair set for all three link types, residual rules, duplicate
uids and groups split into many units (``chunk`` 4, 16 and 2048, as in
tests/test_pairgen.py). In the linker, the virtual pattern pipeline scores
like the materialised one (1e-12) and like the reference (frames in row
order with dtypes, probabilities within 1e-5).
"""

import copy
import warnings

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)
pd = pytest.importorskip("pandas")

import jax.numpy as jnp  # noqa: E402

import splink_tpu  # noqa: E402
import splink_tpu.pairgen as ref_pairgen  # noqa: E402
import splink_tpu_torch  # noqa: E402
from splink_tpu import data as ref_data  # noqa: E402
from splink_tpu.gammas import GammaProgram as RefGammaProgram  # noqa: E402
from splink_tpu.settings import complete_settings_dict as ref_complete  # noqa: E402
from splink_tpu_torch import blocking, data, pairgen  # noqa: E402
from splink_tpu_torch.gammas import GammaProgram  # noqa: E402
from splink_tpu_torch.settings import complete_settings_dict  # noqa: E402


def _df(n, seed, uid=None):
    rng = np.random.default_rng(seed)
    return pd.DataFrame({
        "unique_id": uid if uid is not None else np.arange(n),
        "name": rng.choice(["ann", "bob", "cat", None], n),
        "city": rng.choice([f"c{k}" for k in range(max(n // 30, 2))], n),
        "dob": rng.choice([f"d{k}" for k in range(max(n // 8, 2))], n),
    })


def _raw(rules, link_type="dedupe_only"):
    return {"link_type": link_type, "blocking_rules": rules,
            "comparison_columns": [{"col_name": "name", "num_levels": 2},
                                   {"col_name": "dob", "num_levels": 2}]}


def _tables(raw, frames):
    """(port settings, port table, ref settings, ref table, n_left)."""
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        s, rs = complete_settings_dict(copy.deepcopy(raw)), ref_complete(copy.deepcopy(raw))
        if len(frames) == 1:
            return s, data.encode_table(frames[0], s), rs, ref_data.encode_table(frames[0], rs), None
        return (s, data.concat_tables(*frames, s), rs, ref_data.concat_tables(*frames, rs),
                len(frames[0]))


def _with_age(df, seed):
    rng = np.random.default_rng(seed)
    df["age"] = rng.integers(20, 60, len(df)).astype(float)
    df.loc[rng.random(len(df)) < 0.1, "age"] = np.nan
    return df


def _dup_uid_frames():
    return (_df(80, 9, uid=np.array([0, 1, 1, 2, 3, 3, 3, 4, 5, 6] * 8)),)


def _lad_dup_frames():
    df_l = pd.DataFrame({"unique_id": [1, 5, 5, 7, 9], "name": list("abcde"),
                         "city": ["x"] * 5, "dob": ["d"] * 5})
    df_r = pd.DataFrame({"unique_id": [5, 5, 7, 11], "name": list("fghi"),
                         "city": ["x"] * 4, "dob": ["d"] * 4})
    return df_l, df_r


def _split(df, at, shift=0):
    right = df.iloc[at:].copy()
    right["unique_id"] = right["unique_id"] - shift
    return df.iloc[:at].copy(), right


# id: (link type, rules, frames)
CASES = {
    "city": ("dedupe_only", ["l.city = r.city"], lambda: (_df(240, 7),)),
    "dob_city": ("dedupe_only", ["l.dob = r.dob", "l.city = r.city"], lambda: (_df(240, 7),)),
    "three_rules": ("dedupe_only", ["l.city = r.city", "l.dob = r.dob", "l.name = r.name"],
                    lambda: (_df(240, 7),)),
    "duplicate_uids": ("dedupe_only", ["l.city = r.city", "l.dob = r.dob"], _dup_uid_frames),
    "link_only": ("link_only", ["l.city = r.city", "l.dob = r.dob"],
                  lambda: _split(_df(200, 11), 120)),
    # overlapping uid spaces: the (source, uid) ordering and the equal-key drop
    "link_and_dedupe": ("link_and_dedupe", ["l.city = r.city", "l.dob = r.dob"],
                        lambda: _split(_df(180, 29), 100, shift=80)),
    "link_and_dedupe_dup_keys": ("link_and_dedupe", ["l.city = r.city"], _lad_dup_frames),
    # residuals: string inequality, numeric threshold, a residual on an
    # EARLIER rule (the prev-holds path), a literal, IS NOT NULL, ordering
    "res_ne": ("dedupe_only", ["l.city = r.city and l.dob != r.dob"],
               lambda: (_with_age(_df(220, 37), 37),)),
    "res_abs": ("dedupe_only", ["l.city = r.city and abs(l.age - r.age) < 5"],
                lambda: (_with_age(_df(220, 37), 37),)),
    "res_prev": ("dedupe_only", ["l.city = r.city and l.dob != r.dob", "l.dob = r.dob"],
                 lambda: (_with_age(_df(220, 37), 37),)),
    "res_literal": ("dedupe_only", ["l.city = r.city and l.name != 'ann'"],
                    lambda: (_with_age(_df(220, 37), 37),)),
    "res_not_null": ("dedupe_only", ["l.city = r.city and l.name is not null"],
                     lambda: (_with_age(_df(220, 37), 37),)),
    "res_order": ("dedupe_only", ["l.city = r.city and l.dob < r.dob"],
                  lambda: (_with_age(_df(220, 37), 37),)),
    "res_arith_mod": ("dedupe_only", ["l.dob = r.dob and (l.age + r.age) % 7 > 2.5"],
                      lambda: (_with_age(_df(220, 37), 37),)),
}

PLAN_CASES = [(case, chunk) for case in CASES for chunk in
              ((4, 16, 2048) if case in ("city", "dob_city", "three_rules") else (4, 2048))]


def _plans(case, chunk):
    link_type, rules, frames = CASES[case]
    s, t, rs, rt, n_left = _tables(_raw(rules, link_type), frames())
    plan = pairgen.build_virtual_plan(s, t, n_left, chunk=chunk)
    ref = ref_pairgen.build_virtual_plan(rs, rt, n_left, chunk=chunk)
    assert plan is not None and ref is not None
    return s, t, n_left, plan, ref


@pytest.mark.parametrize("case, chunk", PLAN_CASES, ids=[f"{c}-{k}" for c, k in PLAN_CASES])
def test_virtual_plan_and_decode_equal_reference(case, chunk):
    """The plan's arrays equal the reference's; at every position of every
    rule the host decode and the device decode give the reference's (i, j)
    and mask; the unmasked pairs are exactly host blocking's pair set."""
    s, t, n_left, plan, ref = _plans(case, chunk)
    assert plan.n_candidates == ref.n_candidates > 0
    np.testing.assert_array_equal(plan.codes, ref.codes)
    if ref.uid_codes is None:
        assert plan.uid_codes is None
    else:
        np.testing.assert_array_equal(plan.uid_codes, ref.uid_codes)
    arrs = plan.on_device(torch.device("cpu"))
    got_i, got_j = [], []
    for r, (rp, rr) in enumerate(zip(plan.rules, ref.rules)):
        for name in ("order", "ua", "la", "ub", "lb", "pc"):
            np.testing.assert_array_equal(getattr(rp, name), getattr(rr, name), name)
        if rp.total == 0:
            continue
        q = np.arange(rp.total, dtype=np.int64)
        i, j, masked = pairgen.decode_positions(plan, r, q)
        ri, rj, rmasked = ref_pairgen.decode_positions(ref, r, q)
        np.testing.assert_array_equal(i, ri)
        np.testing.assert_array_equal(j, rj)
        np.testing.assert_array_equal(masked, rmasked)
        ra = arrs["rules"][r]
        di, dj = pairgen.unit_decode(torch.from_numpy(q), ra["order"], *ra["units"], ra["pc"])
        np.testing.assert_array_equal(di.numpy(), ri)
        np.testing.assert_array_equal(dj.numpy(), rj)
        got_i.append(i[~masked])
        got_j.append(j[~masked])
    want = blocking.block_using_rules(s, t, n_left)
    gi, gj = np.concatenate(got_i), np.concatenate(got_j)
    assert len(gi) == want.n_pairs
    assert set(zip(gi.tolist(), gj.tolist())) == set(zip(want.idx_l.tolist(),
                                                         want.idx_r.tolist()))
    if CASES[case][0] == "link_only":
        assert (gi < n_left).all() and (gj >= n_left).all()


def test_unit_decode_equals_reference_kernel():
    """The port's int64/float64 decode against the reference's jitted
    int32/float32 kernel, batch by batch (batches that split units), at
    every position inside each batch's valid range."""
    _, _, _, plan, ref = _plans("dob_city", 8)
    arrs = plan.on_device(torch.device("cpu"))
    for r, rr in enumerate(ref.rules):
        units = [jnp.asarray(a) for a in (rr.order, rr.ua, rr.la, rr.ub, rr.lb)]
        ra = arrs["rules"][r]
        for p0, p1, meta in ref_pairgen._unit_batch_meta(rr.pc, rr.total, 128):
            pos = jnp.arange(128, dtype=jnp.int32)
            wi, wj, _ = ref_pairgen.unit_decode(pos, *units, jnp.asarray(meta),
                                                mesh_ladder=False)
            q = torch.arange(p0, p1, dtype=torch.int64)
            gi, gj = pairgen.unit_decode(q, ra["order"], *ra["units"], ra["pc"])
            np.testing.assert_array_equal(gi.numpy(), np.asarray(wi)[: p1 - p0])
            np.testing.assert_array_equal(gj.numpy(), np.asarray(wj)[: p1 - p0])


def _gamma_raw(rules, link_type="dedupe_only", **extra):
    raw = {"link_type": link_type, "blocking_rules": rules, "comparison_columns": [
        {"col_name": "name", "num_levels": 3,
         "comparison": {"kind": "jaro_winkler", "thresholds": [0.94, 0.88]}},
        {"col_name": "dob", "num_levels": 3,
         "comparison": {"kind": "levenshtein", "thresholds": [0.3]}},
        {"col_name": "city", "num_levels": 2, "comparison": {"kind": "exact"}}]}
    raw.update(extra)
    return raw


def _names_df(n, seed):
    rng = np.random.default_rng(seed)
    pool = np.array(["martha", "marhta", "dwayne", "duane", "dixon", "dicksonx", "ann",
                     "anne", None], dtype=object)
    return pd.DataFrame({"unique_id": np.arange(n), "name": pool[rng.integers(0, 9, n)],
                         "dob": pool[rng.integers(0, 9, n)],
                         "city": rng.choice([f"c{k}" for k in range(8)], n)})


@pytest.mark.parametrize("case", ["two_phase", "exact_jw", "duplicate_uids"])
def test_virtual_pattern_ids_equal_reference(case):
    """compute_virtual_pattern_ids of both packages: the per-position ids
    (sentinel included: residual, earlier-rule and duplicate-uid masks) and
    the histogram equal, exactly; and the port's ids of the unmasked
    positions equal its materialised pattern pass over the host-decoded
    pairs (the reference's own oracle)."""
    raw = _gamma_raw(["l.city = r.city and l.name != 'ann'", "l.dob = r.dob"],
                     two_phase_jw="off" if case == "exact_jw" else "on")
    df = _names_df(240, 3)
    if case == "duplicate_uids":
        df["unique_id"] = np.arange(240) // 3
    s, t, rs, rt, _ = _tables(raw, (df,))
    plan = pairgen.build_virtual_plan(s, t, chunk=8)
    ref = ref_pairgen.build_virtual_plan(rs, rt, chunk=8)
    program = GammaProgram(s, t, device="cpu")
    ref_program = RefGammaProgram(rs, rt)
    assert program.n_patterns == ref_program.n_patterns == 48
    pids, counts, n_real = pairgen.compute_virtual_pattern_ids(program, plan, 128)
    want_p, want_c, want_n = ref_pairgen.compute_virtual_pattern_ids(ref_program, ref, 128)
    assert pids.dtype == want_p.dtype == np.uint16
    np.testing.assert_array_equal(pids, want_p)
    np.testing.assert_array_equal(counts, want_c)
    assert n_real == want_n == int(counts.sum()) > 0
    ii, jj = [], []
    for r, rp in enumerate(plan.rules):
        i, j, masked = pairgen.decode_positions(plan, r, np.arange(rp.total, dtype=np.int64))
        ii.append(i[~masked])
        jj.append(j[~masked])
    mp, mc = program.compute_pattern_ids(np.concatenate(ii), np.concatenate(jj), 100)
    np.testing.assert_array_equal(mc, counts)
    np.testing.assert_array_equal(mp, pids[pids != program.n_patterns])
    # the histogram-only pass counts the same
    none, counts2, _ = pairgen.compute_virtual_pattern_ids(program, plan, 128, return_ids=False)
    assert none is None
    np.testing.assert_array_equal(counts2, counts)


def test_unsupported_shapes_fall_back():
    df = _df(40, 1)
    for rules in ([], ["l.dob != r.dob"]):
        s, t, rs, rt, _ = _tables(_raw(rules), (df,))
        assert pairgen.build_virtual_plan(s, t) is None
        assert ref_pairgen.build_virtual_plan(rs, rt) is None


def test_monster_group_falls_back(monkeypatch):
    """A group past MAX_UNITS_PER_GROUP rejects the plan in both packages,
    and the linker takes host blocking instead (with device pair
    generation on)."""
    monkeypatch.setattr(pairgen, "MAX_UNITS_PER_GROUP", 3)
    monkeypatch.setattr(ref_pairgen, "MAX_UNITS_PER_GROUP", 3)
    monkeypatch.setattr(pairgen, "CHUNK", 4)  # the linker's plan splits the group too
    df = pd.DataFrame({"unique_id": range(40), "name": ["x"] * 40, "key": ["same"] * 40})
    raw = {"link_type": "dedupe_only", "comparison_columns": [{"col_name": "name", "num_levels": 2}],
           "blocking_rules": ["l.key = r.key"], "max_iterations": 2,
           "max_resident_pairs": 1024, "device_pair_generation": "on"}
    s, t, rs, rt, _ = _tables(raw, (df,))
    assert pairgen.build_virtual_plan(s, t, chunk=4) is None
    assert ref_pairgen.build_virtual_plan(rs, rt, chunk=4) is None
    linker = splink_tpu_torch.Splink(copy.deepcopy(raw), df=df, device="cpu")
    out = linker.get_scored_comparisons()
    assert not linker.device_pair_generation_active
    assert len(out) == 40 * 39 // 2


def _linker_raw(**over):
    raw = {"link_type": "dedupe_only",
           "comparison_columns": [{"col_name": "name", "num_levels": 2},
                                  {"col_name": "dob", "num_levels": 2}],
           "blocking_rules": ["l.city = r.city", "l.dob = r.dob"], "max_iterations": 4}
    raw.update(over)
    return raw


def _frames_for(link_type, seed):
    df = _df(260, seed)
    if link_type == "dedupe_only":
        return {"df": df}
    left, right = _split(df, 150, shift=100 if link_type == "link_and_dedupe" else 0)
    return {"df_l": left, "df_r": right}


def _assert_same_frame(have, want, atol):
    assert list(have.columns) == list(want.columns)
    assert list(have.dtypes) == list(want.dtypes)
    for c in want.columns:
        if want[c].dtype.kind == "f":
            np.testing.assert_allclose(have[c], want[c], rtol=0, atol=atol, err_msg=c)
        else:
            assert have[c].equals(want[c]), c


@pytest.mark.parametrize("link_type", ["dedupe_only", "link_only", "link_and_dedupe"])
def test_linker_virtual_pipeline_matches_materialised_and_reference(link_type):
    """max_resident_pairs 1024 puts both runs in the pattern regime, so the
    only difference is virtual against materialised pairs: the same pairs
    and gammas, probabilities within 1e-12 (the reference's bound for this
    pair of regimes). The virtual run also equals the reference's virtual
    run in row order with dtypes (probabilities within 1e-5)."""
    frames = _frames_for(link_type, 17)
    raw = _linker_raw(link_type=link_type, max_resident_pairs=1024)
    on_linker = splink_tpu_torch.Splink(dict(raw, device_pair_generation="on"),
                                        device="cpu", **frames)
    on = on_linker.get_scored_comparisons()
    assert on_linker.device_pair_generation_active
    off_linker = splink_tpu_torch.Splink(dict(raw, device_pair_generation="off"),
                                         device="cpu", **frames)
    off = off_linker.get_scored_comparisons()
    assert not off_linker.device_pair_generation_active and off_linker._P is not None
    key = ["unique_id_l", "unique_id_r"] + (
        ["_source_table_l", "_source_table_r"] if link_type == "link_and_dedupe" else [])
    a = on.sort_values(key).reset_index(drop=True)
    b = off.sort_values(key).reset_index(drop=True)
    assert len(a) == len(b) > 1000
    np.testing.assert_array_equal(a[key].to_numpy(), b[key].to_numpy())
    for c in ("gamma_name", "gamma_dob"):
        np.testing.assert_array_equal(a[c], b[c])
    np.testing.assert_allclose(a["match_probability"], b["match_probability"], rtol=1e-12)
    ref = splink_tpu.Splink(dict(raw, device_pair_generation="on"), **frames)
    _assert_same_frame(on, ref.get_scored_comparisons(), 1e-5)
    np.testing.assert_array_equal(on_linker._pattern_counts, ref._pattern_counts)


def test_virtual_materialised_ids_stream_matches_recompute():
    """virtual_materialise_ids: the LUT-only stream from kept ids equals
    the recompute stream bit for bit; auto keeps ids exactly on the scoring
    path and releases them when the stream ends."""
    df = _df(240, 29)
    kw = dict(device_pair_generation="on", max_resident_pairs=1024)
    kept = splink_tpu_torch.Splink(_linker_raw(**kw), df=df, device="cpu")
    gen = kept.stream_scored_comparisons()
    chunks = [next(gen)]
    assert kept._P_virtual is not None and kept._P_virtual.dtype == np.uint16
    chunks.extend(gen)
    assert kept._P_virtual is None
    out_kept = pd.concat(chunks, ignore_index=True)
    off = splink_tpu_torch.Splink(_linker_raw(virtual_materialise_ids="off", **kw), df=df,
                                  device="cpu")
    out_off = off.get_scored_comparisons()
    assert off._P_virtual is None
    pd.testing.assert_frame_equal(out_kept, out_off)
    em_only = splink_tpu_torch.Splink(_linker_raw(**kw), df=df, device="cpu")
    em_only.estimate_parameters()
    assert em_only.device_pair_generation_active and em_only._P_virtual is None


def test_linker_virtual_auto_gate():
    """auto engages device pair generation only past max_resident_pairs, as
    in the reference."""
    df = _df(200, 23)
    small = splink_tpu_torch.Splink(_linker_raw(), df=df, device="cpu")
    small.get_scored_comparisons()
    assert small._virtual is None and small._G is not None
    big = splink_tpu_torch.Splink(_linker_raw(max_resident_pairs=1024), df=df, device="cpu")
    big.get_scored_comparisons()
    assert big._virtual is not None and big._pairs is None  # no host pair index
