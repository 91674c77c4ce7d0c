"""The approximate tier of splink_tpu_torch against splink_tpu's, on the CPU.

The reference's own typo corpus (tests/test_approx_blocking.py: records
with near-unique names and twins whose EVERY blocking key carries a '#'
corruption) goes through both packages. The reference runs its jitted
programs on JAX's CPU backend, the port its tensor functions on the CPU
(``device="cpu"``). Held equal, array for array and in order: the
verifier's collisions and similarities (2 and 3 columns, unweighted and
TF-weighted: every sum in the reference's order, and the mean as the
reference's multiply by the float32 reciprocal of the column count), the
candidates ``generate_approx_candidates`` returns with its stats, and the
pair arrays of ``block_using_rules`` for the three link types, the exact
host and device tiers composed, threshold, budget and oversize buckets.
End to end, ``get_scored_comparisons`` gives equal pairs and gammas and
probabilities within 1e-5 (the linker tests' bound: EM compounds the
last-ulp differences of XLA's and PyTorch's log and sigmoid).

Also, on the port alone: best-first emission under a budget, the bounded
prune, the ``blocking_approx`` event, the pair bound, the linker's
refusals (device pair generation, ``build_spill_dir``), and the emission
order of the device ranking against ``np.lexsort``.
"""

import copy
import dataclasses
import json
import warnings

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)
pd = pytest.importorskip("pandas")

from splink_tpu.approx import lsh as ref_lsh  # noqa: E402
from splink_tpu.blocking import block_using_rules as ref_block  # noqa: E402
from splink_tpu.blocking import estimate_pair_upper_bound as ref_bound  # noqa: E402
from splink_tpu.data import concat_tables as ref_concat  # noqa: E402
from splink_tpu.data import encode_table as ref_encode  # noqa: E402
from splink_tpu.settings import complete_settings_dict as ref_complete  # noqa: E402

from splink_tpu_torch.approx import lsh  # noqa: E402
from splink_tpu_torch.blocking import block_using_rules, estimate_pair_upper_bound  # noqa: E402
from splink_tpu_torch.data import concat_tables, encode_table  # noqa: E402
from splink_tpu_torch.settings import complete_settings_dict  # noqa: E402

N_BASE = 80


def _raw(**over):
    s = {
        "link_type": "dedupe_only",
        "comparison_columns": [{"col_name": "first_name"}, {"col_name": "surname"}],
        "blocking_rules": ["l.first_name = r.first_name", "l.surname = r.surname"],
        "approx_blocking": True,
    }
    s.update(over)
    return s


def _both(**over):
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        return complete_settings_dict(_raw(**over)), ref_complete(_raw(**over))


def _corrupt(value: str, rng) -> str:
    k = int(rng.integers(0, len(value)))
    return value[:k] + "#" + value[k + 1:]


def typo_corpus(n=N_BASE, seed=7):
    """n base records with near-unique keys + n twins with EVERY blocking
    key corrupted (the reference's corpus); a ``city`` column for the
    three-column cases. True matches are (k, k + n)."""
    rng = np.random.default_rng(seed)
    firsts = ["amelia", "oliver", "isla", "george", "ava", "noah", "emily"]
    lasts = ["smith", "jones", "taylor", "brown", "wilson", "evans"]
    cities = ["london", "leeds", "luton", "lincoln"]
    base = pd.DataFrame({
        "unique_id": range(n),
        "first_name": [f"{rng.choice(firsts)}{k:02d}" for k in range(n)],
        "surname": [f"{rng.choice(lasts)}{k:02d}" for k in range(n)],
        "city": [f"{rng.choice(cities)}{k % 7}" for k in range(n)],
    })
    twins = base.copy()
    twins["unique_id"] = twins["unique_id"] + n
    crng = np.random.default_rng(seed + 1)
    for c in ("first_name", "surname", "city"):
        twins[c] = [_corrupt(v, crng) for v in twins[c]]
    return pd.concat([base, twins], ignore_index=True), {(k, k + n) for k in range(n)}


def _tables(s, rs, df, link_type="dedupe_only", n_left=None):
    if link_type == "dedupe_only":
        return encode_table(df, s), ref_encode(df, rs)
    frames = (df.iloc[:n_left].reset_index(drop=True), df.iloc[n_left:].reset_index(drop=True))
    return concat_tables(*frames, s), ref_concat(*frames, rs)


def _pairs(p):
    return set(zip(p.idx_l.tolist(), p.idx_r.tolist()))


THREE = {
    "blocking_rules": ["l.first_name = r.first_name", "l.surname = r.surname",
                       "l.city = r.city"],
    "comparison_columns": [{"col_name": "first_name"}, {"col_name": "surname"},
                           {"col_name": "city"}],
}


@pytest.mark.parametrize("weighted", [False, True])
@pytest.mark.parametrize("rules", [None, THREE], ids=["2cols", "3cols"])
def test_verifier_matches_reference(rules, weighted):
    """Collisions and similarities of every candidate pair, bit for bit."""
    from splink_tpu.approx.minhash import gram_df_table, idf_weights

    from splink_tpu_torch.approx.minhash import _upload, _upload_chars

    over = {"approx_threshold": 0.2, "approx_tf_weighting": weighted, **(rules or {})}
    s, rs = _both(**over)
    df, _ = typo_corpus()
    t, rt = _tables(s, rs, df)
    cfg = lsh.ApproxConfig.from_settings(s, t)
    assert len(cfg.cols) == (3 if rules else 2)
    codes, _, _ = lsh.compute_band_codes(t, cfg, device="cpu")
    rng = np.random.default_rng(1)
    i = rng.integers(0, t.n_rows, 4000).astype(np.int32)
    j = rng.integers(0, t.n_rows, 4000).astype(np.int32)
    i[:80], j[:80] = np.arange(80), np.arange(80, 160)  # the twins
    i[80:160], j[80:160] = np.arange(80), np.arange(80)  # identical rows
    raux = ref_lsh._verify_aux(rt, cfg)
    idf = None
    if weighted:
        idf = idf_weights(*gram_df_table(ref_lsh.column_arrays(rt, cfg.cols), cfg.q))
    shapes = tuple((int(rt.strings[c].width), "ascii") for c in cfg.cols)
    fn = ref_lsh.make_verify_fn(cfg.q, cfg.bands, shapes, True, weighted=weighted)
    import jax.numpy as jnp

    args = [jnp.asarray(a) for col in raux for a in col] + (
        [jnp.asarray(idf)] if weighted else [])
    rc, rsim = (np.asarray(x) for x in fn(jnp.asarray(i), jnp.asarray(j), jnp.asarray(codes),
                                          *args))
    aux = [(_upload_chars(b, "cpu"), _upload(ln, "cpu"), _upload(m.view(np.int32), "cpu"),
            _upload(c, "cpu")) for b, ln, m, c in lsh._verify_aux(t, cfg)]
    pc, psim = lsh.verify_pairs(torch.from_numpy(i.astype(np.int64)),
                                torch.from_numpy(j.astype(np.int64)), torch.from_numpy(codes),
                                aux, cfg.q, True,
                                None if idf is None else torch.from_numpy(idf))
    np.testing.assert_array_equal(pc.numpy(), rc)
    assert psim.dtype == torch.float32
    np.testing.assert_array_equal(psim.numpy(), rsim)
    assert (rsim[80:160] == 1).all() and (rsim[:80] > 0).all()
    # the mean is the sum times the float32 reciprocal of the column
    # count, which for three columns is not always the true quotient: the
    # reference's form, which the port matches above
    if rules and not weighted:
        from splink_tpu_torch.ops.qgram import qgram_jaccard_masked

        ii, jj = torch.from_numpy(i.astype(np.int64)), torch.from_numpy(j.astype(np.int64))
        sums = sum(qgram_jaccard_masked(b[ii], b[jj], ln[ii], ln[jj], m[ii], c[ii], c[jj], cfg.q)
                   for b, ln, m, c in aux)
        assert ((sums / torch.tensor(3.0)).numpy() != rsim).any()


CANDIDATE_CASES = {
    "verified": dict(approx_threshold=0.2, approx_pair_budget=320),
    "unverified_budget": dict(approx_threshold=0.0, approx_pair_budget=40),
    "weighted": dict(approx_threshold=0.2, approx_tf_weighting=True),
    "three_columns": dict(approx_threshold=0.3, **THREE),
}


@pytest.mark.parametrize("case", sorted(CANDIDATE_CASES))
def test_generate_candidates_matches_reference(case):
    s, rs = _both(**CANDIDATE_CASES[case])
    df, _ = typo_corpus()
    t, rt = _tables(s, rs, df)
    r = ref_lsh.generate_approx_candidates(rs, rt)
    p = lsh.generate_approx_candidates(s, t, device="cpu")
    for a, b in zip(r[:4], p[:4]):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(b, a)
    stats = dict(p[4])
    assert set(stats.pop("seconds")) >= {"emit", "dedup", "verify", "prune"}
    assert stats == r[4]
    assert len(p[0]) > 0


BLOCK_CASES = {
    "dedupe_host": ("dedupe_only", dict(approx_threshold=0.2, approx_pair_budget=320,
                                        device_blocking="off")),
    "dedupe_device": ("dedupe_only", dict(approx_threshold=0.2, approx_pair_budget=320,
                                          device_blocking="on")),
    "dedupe_unverified": ("dedupe_only", dict(approx_pair_budget=100_000)),
    "dedupe_threshold_06": ("dedupe_only", dict(approx_threshold=0.6, approx_pair_budget=100_000)),
    "link_only": ("link_only", dict(approx_threshold=0.2, approx_pair_budget=1000)),
    "link_only_device": ("link_only", dict(approx_threshold=0.2, approx_pair_budget=1000,
                                           device_blocking="on")),
    "link_and_dedupe": ("link_and_dedupe", dict(approx_threshold=0.2, approx_pair_budget=500)),
    "weighted_device": ("dedupe_only", dict(approx_threshold=0.2, approx_tf_weighting=True,
                                            approx_pair_budget=100, device_blocking="on")),
}


@pytest.mark.parametrize("case", sorted(BLOCK_CASES))
def test_block_using_rules_matches_reference(case):
    """The pair arrays, exact pairs first and the approximate ones after
    them best first, equal the reference's in order."""
    link_type, over = BLOCK_CASES[case]
    s, rs = _both(link_type=link_type, **over)
    df, true = typo_corpus(40)
    n_left = None if link_type == "dedupe_only" else 40
    t, rt = _tables(s, rs, df, link_type, n_left)
    ref = ref_block(rs, rt, n_left=n_left)
    got = block_using_rules(s, t, n_left=n_left, device="cpu")
    assert got.idx_l.dtype == ref.idx_l.dtype
    np.testing.assert_array_equal(got.idx_l, ref.idx_l)
    np.testing.assert_array_equal(got.idx_r, ref.idx_r)
    pairs = _pairs(got)
    assert len(pairs) == got.n_pairs  # no pair twice across bands and tiers
    if over.get("approx_threshold", 0) <= 0.2:
        assert len(true & pairs) >= 0.9 * len(true)
    if link_type == "link_only":
        assert all(i < 40 <= j for i, j in pairs)


def test_exact_and_device_tiers_compose_equally():
    """The approximate tier appended to the host join and to the device
    tier gives one pair set; the exact pairs still ride."""
    df, _ = typo_corpus(40)
    extra = df.head(10).copy()
    extra["unique_id"] += 1000
    df = pd.concat([df, extra], ignore_index=True)
    out = {}
    for mode in ("off", "on"):
        s, _ = _both(device_blocking=mode, approx_threshold=0.2, approx_pair_budget=1000)
        out[mode] = _pairs(block_using_rules(s, encode_table(df, s), device="cpu"))
    assert out["on"] == out["off"]
    s, _ = _both(approx_blocking=False)
    assert _pairs(block_using_rules(s, encode_table(df, s), device="cpu")) <= out["on"]


def test_budget_prefix_and_bounded_prune(monkeypatch):
    """A smaller budget emits a prefix of a larger budget's emission; with
    verification calls of 16 pairs the held candidates prune many times,
    stay within ``budget + max(budget, 4 * VERIFY_CHUNK)``, and their top
    equals an unpruned run's."""
    df, _ = typo_corpus(60)
    s0, _ = _both(approx_blocking=False)
    n_exact = block_using_rules(s0, encode_table(df, s0), device="cpu").n_pairs
    emitted = {}
    for budget in (40, 10_000):
        s, _ = _both(approx_threshold=0.0, approx_pair_budget=budget)
        out = block_using_rules(s, encode_table(df, s), device="cpu")
        emitted[budget] = list(zip(out.idx_l[n_exact:].tolist(), out.idx_r[n_exact:].tolist()))
    assert len(emitted[40]) == 40
    assert emitted[40] == emitted[10_000][:40]
    s_big, _ = _both(approx_threshold=0.0, approx_pair_budget=1 << 24)
    t = encode_table(df, s_big)
    ib, jb, cb, smb, stats_big = lsh.generate_approx_candidates(s_big, t, device="cpu")
    monkeypatch.setattr(lsh, "VERIFY_CHUNK", 16)
    s, _ = _both(approx_threshold=0.0, approx_pair_budget=16)
    i, j, c, sm, stats = lsh.generate_approx_candidates(s, t, device="cpu")
    assert stats["seconds"]["prune"] > 0
    assert len(i) <= 16 + max(16, 4 * 16)
    assert stats["survivors"] == stats_big["survivors"] > 16 + 64
    top = np.lexsort((j, i, -c, -sm))[:16]
    top_b = np.lexsort((jb, ib, -cb, -smb))[:16]
    assert list(zip(i[top], j[top])) == list(zip(ib[top_b], jb[top_b]))


def test_prune_points_match_reference_with_small_budget(monkeypatch):
    """With verification calls of 16 pairs and a budget of 8, the held
    candidates prune many times, and the held arrays (the pruned order
    included) equal the reference's."""
    monkeypatch.setattr(lsh, "VERIFY_CHUNK", 16)
    monkeypatch.setattr(ref_lsh, "VERIFY_CHUNK", 16)
    s, rs = _both(approx_threshold=0.2, approx_pair_budget=8)
    df, _ = typo_corpus(60)
    t, rt = _tables(s, rs, df)
    r = ref_lsh.generate_approx_candidates(rs, rt)
    p = lsh.generate_approx_candidates(s, t, device="cpu")
    assert p[4]["seconds"]["prune"] > 0
    for a, b in zip(r[:4], p[:4]):
        np.testing.assert_array_equal(b, a)


def test_rank_order_equals_lexsort():
    rng = np.random.default_rng(3)
    n = 5000
    i = rng.integers(0, 300, n).astype(np.int32)
    j = rng.integers(0, 300, n).astype(np.int32)
    c = rng.integers(0, 4, n).astype(np.int32)
    sim = rng.choice(np.array([0.0, 0.25, 0.5, 1 / 3, 1.0], np.float32), n)
    got = lsh.rank_order(*(torch.from_numpy(a) for a in (i, j, c, sim))).numpy()
    np.testing.assert_array_equal(got, np.lexsort((j, i, -c, -sim)))


def test_oversize_bucket_does_not_suppress_later_bands(monkeypatch):
    """An oversize bucket's codes are nulled, so its pairs emit through a
    later healthy band. Oracle: the within-bucket pair union over the
    post-null codes, in numpy; and the reference's candidates."""
    monkeypatch.setattr(lsh, "MAX_BUCKET_ROWS", 6)
    monkeypatch.setattr(ref_lsh, "MAX_BUCKET_ROWS", 6)
    s, rs = _both(approx_threshold=0.0, approx_pair_budget=1 << 24)
    df, _ = typo_corpus(60)
    t, rt = _tables(s, rs, df)
    plan = lsh.build_approx_plan(s, t, device="cpu")
    assert plan.oversize_buckets > 0
    i, j, _c, _sim, stats = lsh.generate_approx_candidates(s, t, plan=plan)
    exp = set()
    bc = plan.band_codes
    for b in range(bc.shape[0]):
        codes = bc[b]
        for code in np.unique(codes[codes >= 0]):
            rows = np.flatnonzero(codes == code)
            exp |= {(int(rows[x]), int(rows[y]))
                    for x in range(len(rows)) for y in range(x + 1, len(rows))}
    assert set(zip(i.tolist(), j.tolist())) == exp
    assert stats["oversize_buckets_dropped"] == plan.oversize_buckets
    ref = ref_lsh.generate_approx_candidates(rs, rt)
    np.testing.assert_array_equal(i, ref[0])
    np.testing.assert_array_equal(j, ref[1])
    assert ref[4]["oversize_buckets_dropped"] == plan.oversize_buckets


def test_no_sketchable_column_skips_tier():
    df = pd.DataFrame({"unique_id": range(6), "amount": [1.0, 2.0, 1.0, 3.0, 2.0, 1.0]})
    s, _ = _both(comparison_columns=[{"col_name": "amount", "data_type": "numeric"}],
                 blocking_rules=["l.amount = r.amount"])
    t = encode_table(df, s)
    assert lsh.approx_columns(s, t) == []
    assert lsh.ApproxConfig.from_settings(s, t) is None
    assert lsh.build_approx_plan(s, t, device="cpu") is None
    assert block_using_rules(s, t, device="cpu").n_pairs == 4
    assert estimate_pair_upper_bound(s, t) == estimate_pair_upper_bound(
        s, t, include_approx=False)


def test_pair_bound_matches_reference():
    df, _ = typo_corpus(20)
    for budget in (123, 12345):
        s, rs = _both(approx_pair_budget=budget)
        t, rt = _tables(s, rs, df)
        exact = estimate_pair_upper_bound(s, t, include_approx=False)
        got = estimate_pair_upper_bound(s, t)
        assert got == ref_bound(rs, rt)
        assert got == exact + min(budget, len(df) * (len(df) - 1) // 2)
    s, rs = _both(link_type="link_only", approx_pair_budget=1 << 20)
    t, rt = _tables(s, rs, df, "link_only", 20)
    assert estimate_pair_upper_bound(s, t, 20) == ref_bound(rs, rt, 20)
    assert estimate_pair_upper_bound(s, t, 20) == estimate_pair_upper_bound(
        s, t, 20, include_approx=False) + 400


def test_blocking_approx_event_published():
    from splink_tpu_torch.obs.events import register_ambient, unregister_ambient

    class Capture:
        def __init__(self):
            self.events = []

        def emit(self, type, **fields):
            self.events.append({"type": type, **fields})

    cap = Capture()
    register_ambient(cap)
    try:
        s, _ = _both(approx_threshold=0.2, approx_pair_budget=500)
        df, _ = typo_corpus(40)
        block_using_rules(s, encode_table(df, s), device="cpu")
    finally:
        unregister_ambient(cap)
    evs = [e for e in cap.events if e["type"] == "blocking_approx"]
    assert len(evs) == 1
    ev = evs[0]
    assert ev["bands"] == s["approx_bands"] and ev["candidates"] > 0
    assert ev["survivors"] <= ev["candidates"] and ev["emitted"] <= 500
    assert 0.0 <= ev["budget_fill"] <= 1.0 and ev["verified"] is True
    assert "oversize_buckets_dropped" in ev
    assert lsh.last_run["emitted"] == ev["emitted"]
    assert set(lsh.last_run["seconds"]) >= {"signatures", "band_plan", "emit", "dedup",
                                            "verify", "ranking"}


def test_approx_path_raises_without_a_card(monkeypatch):
    """The tier runs on the card unless the caller names the CPU; without a
    card it raises instead of carrying on on the host."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    s, _ = _both(approx_threshold=0.2)
    df, _ = typo_corpus(20)
    t = encode_table(df, s)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        lsh.build_approx_plan(s, t)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        block_using_rules(dict(s, device_blocking="off"), t)


def _linker_settings(**over):
    s = {
        "link_type": "dedupe_only",
        "comparison_columns": [
            {"col_name": "first_name", "num_levels": 3},
            {"col_name": "surname", "num_levels": 2, "comparison": {"kind": "exact"}},
            {"col_name": "city", "num_levels": 3,
             "comparison": {"kind": "levenshtein", "thresholds": [0.3, 0.6]}},
        ],
        "blocking_rules": ["l.first_name = r.first_name", "l.surname = r.surname"],
        "max_iterations": 3,
        "approx_blocking": True,
        "approx_threshold": 0.2,
        "approx_pair_budget": 1000,
    }
    s.update(over)
    return s


@pytest.mark.parametrize("weighted", [False, True])
def test_linker_end_to_end_matches_reference(weighted):
    import splink_tpu
    import splink_tpu_torch

    df, true = typo_corpus(40)
    s = _linker_settings(approx_tf_weighting=weighted)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        ref = splink_tpu.Splink(json.loads(json.dumps(s)), df=df).get_scored_comparisons()
        got = splink_tpu_torch.Splink(json.loads(json.dumps(s)), df=df,
                                      device="cpu").get_scored_comparisons()
    key = ["unique_id_l", "unique_id_r"]
    ref, got = ref.sort_values(key).reset_index(drop=True), got.sort_values(key).reset_index(
        drop=True)
    assert set(ref.columns) == set(got.columns)
    for c in ref.columns:
        if c.startswith("gamma_") or c in key:
            np.testing.assert_array_equal(got[c].to_numpy(), ref[c].to_numpy(), c)
    np.testing.assert_allclose(got["match_probability"], ref["match_probability"],
                               rtol=0, atol=1e-5)
    scored = set(zip(got["unique_id_l"].astype(int), got["unique_id_r"].astype(int)))
    assert len(true & scored) >= 0.95 * len(true)


def test_linker_defers_device_pair_generation_and_spill_to_approx(tmp_path):
    """The virtual pair index and the spill emission write exact pairs
    only: with the approximate tier on, the linker blocks in memory (the
    spill case with a degradation warning) and keeps the approximate
    pairs."""
    import splink_tpu_torch
    from splink_tpu_torch.utils.logging_utils import DegradationWarning

    df, true = typo_corpus(30)
    linker = splink_tpu_torch.Splink(
        _linker_settings(device_pair_generation="on", max_iterations=2), df=df, device="cpu")
    df_e = linker.get_scored_comparisons()
    assert linker.device_pair_generation_active is False
    scored = set(zip(df_e["unique_id_l"].astype(int), df_e["unique_id_r"].astype(int)))
    assert len(true & scored) >= 0.95 * len(true)
    spill = splink_tpu_torch.Splink(
        _linker_settings(build_spill_dir=str(tmp_path / "spill"), max_iterations=2), df=df,
        device="cpu")
    with pytest.warns(DegradationWarning, match="approx_blocking"):
        df_s = spill.get_scored_comparisons()
    assert set(zip(df_s["unique_id_l"].astype(int), df_s["unique_id_r"].astype(int))) == scored
    assert not (tmp_path / "spill" / "pairs").exists()


def test_settings_are_the_reference_defaults():
    s, rs = _both()
    for k in ("approx_q", "approx_bands", "approx_rows_per_band", "approx_threshold",
              "approx_pair_budget", "approx_tf_weighting"):
        assert s[k] == rs[k], k
    t = encode_table(typo_corpus(10)[0], s)
    cfg = lsh.ApproxConfig.from_settings(s, t)
    ref = ref_lsh.ApproxConfig.from_settings(copy.deepcopy(rs), ref_encode(typo_corpus(10)[0], rs))
    assert dataclasses.asdict(cfg) == dataclasses.asdict(ref)
