"""The device sort-join tier of splink_tpu_torch against splink_tpu's.

The same frames and rules go through the port's device tier (on the CPU)
and through the reference's device tier on JAX's CPU backend, both with
``device_blocking: "on"``: the pair index arrays must be EQUAL, IN ORDER
(the segmented sort's order feeds the unit decode, so any difference in it
would reorder every pair). Both must also equal the port's host join as a
set. The rule sets and fixtures are the reference's own
(tests/test_blocking_device.py): equality conjunctions, sequential rules,
asymmetric keys, derived keys, residuals, all three link types, duplicate
uids, a null-only rule and the chunk caps None, 7 and 13. Also: the plan's
arrays against the reference's, a budget run's chunk shapes, the overlap
consumer's chunks, the card's compacted form (forced on the CPU), the
fallbacks, the "auto" gate and the serving bucket CSR.
"""

import warnings

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)
pd = pytest.importorskip("pandas")

from splink_tpu import blocking as ref_blocking  # noqa: E402
from splink_tpu import blocking_device as ref_bd  # noqa: E402
from splink_tpu.data import concat_tables as ref_concat  # noqa: E402
from splink_tpu.data import encode_table as ref_encode  # noqa: E402
from splink_tpu.settings import complete_settings_dict as ref_complete  # noqa: E402
from splink_tpu_torch import blocking, blocking_device  # noqa: E402
from splink_tpu_torch.data import concat_tables, encode_table  # noqa: E402
from splink_tpu_torch.settings import complete_settings_dict  # noqa: E402
from splink_tpu_torch.utils.logging_utils import DegradationWarning  # noqa: E402

# names deliberately OVERLAP across first_name/surname so asymmetric
# (name-swap) joins produce pairs
_NAMES = ["john", "mary", "jones", "smith", None, "lee", "ann"]


def _df(n, seed, dup_uids=False):
    r = np.random.default_rng(seed)
    uid = np.arange(n) // 2 if dup_uids else np.arange(n)
    return pd.DataFrame({
        "unique_id": uid,
        "first_name": r.choice(_NAMES, n),
        "surname": r.choice(_NAMES, n),
        "amount": r.choice([1.0, 2.5, 3.0, np.nan], n),
    })


def _raw_settings(rules, link_type="dedupe_only", **extra):
    s = {
        "link_type": link_type,
        "comparison_columns": [
            {"col_name": "first_name"},
            {"col_name": "surname"},
            {"col_name": "amount", "data_type": "numeric"},
        ],
        "blocking_rules": list(rules),
    }
    s.update(extra)
    return s


def _both_settings(rules, link_type="dedupe_only", **extra):
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        raw = _raw_settings(rules, link_type, **extra)
        return complete_settings_dict(dict(raw)), ref_complete(dict(raw))


def _tables(s, sr, link_type, frames):
    if link_type == "dedupe_only":
        return encode_table(frames[0], s), ref_encode(frames[0], sr)
    return concat_tables(*frames, s), ref_concat(*frames, sr)


def _with(s, **kw):
    out = dict(s)
    out.update(kw)
    return out


def _pairs(p):
    return set(zip(p.idx_l.tolist(), p.idx_r.tolist()))


def _check_parity(rules, link_type, frames, n_left=None, chunk=None):
    """Port device tier == reference device tier in order; == the port's
    host join as a set; returns the host set."""
    s, sr = _both_settings(rules, link_type)
    t, tr = _tables(s, sr, link_type, frames)
    extra = {"blocking_chunk_pairs": chunk} if chunk else {}
    before = dict(blocking.tiers)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        got = blocking.block_using_rules(_with(s, device_blocking="on", **extra), t, n_left,
                                         device="cpu")
        want = ref_blocking.block_using_rules(_with(sr, device_blocking="on", **extra), tr,
                                              n_left)
        host = blocking.block_using_rules(_with(s, device_blocking="off"), t, n_left,
                                          device="cpu")
    assert blocking.tiers["device"] == before["device"] + 1
    assert got.idx_l.dtype == want.idx_l.dtype == np.int32
    np.testing.assert_array_equal(got.idx_l, want.idx_l)
    np.testing.assert_array_equal(got.idx_r, want.idx_r)
    assert _pairs(got) == _pairs(host)
    assert len(got.idx_l) == len(_pairs(got))  # no pair twice
    return _pairs(host)


DEDUPE_RULESETS = [
    ["l.first_name = r.first_name"],
    ["l.first_name = r.first_name and l.surname = r.surname"],
    # sequential rules: rule 2 excludes every rule-1 pair (null-safe NOT)
    ["l.first_name = r.first_name", "l.surname = r.surname"],
    # asymmetric name-swap key over one table
    ["l.first_name = r.surname"],
    # asym + symmetric key in one rule, after a plain rule
    ["l.surname = r.surname", "l.first_name = r.surname and l.amount = r.amount"],
    # derived-key expression
    ["substr(l.surname,1,2) = substr(r.surname,1,2)"],
    # residual predicates (compiled to device masks)
    ["l.first_name = r.first_name and l.amount + 1 > r.amount"],
    ["l.surname = r.surname and l.amount <= r.amount", "l.first_name = r.first_name"],
]


@pytest.mark.parametrize("chunk", [None, 7])
@pytest.mark.parametrize("rules", DEDUPE_RULESETS)
def test_device_tier_follows_reference_dedupe(rules, chunk):
    host = _check_parity(rules, "dedupe_only", [_df(120, 3)], chunk=chunk)
    assert host, f"degenerate fixture: no pairs for {rules}"


@pytest.mark.parametrize("chunk", [None, 13])
@pytest.mark.parametrize("rules", [
    ["l.first_name = r.first_name"],
    ["l.first_name = r.surname"],  # asymmetric link key
    ["l.first_name = r.first_name", "l.surname = r.surname"],
])
def test_device_tier_follows_reference_link_only(rules, chunk):
    assert _check_parity(rules, "link_only", [_df(70, 5), _df(90, 6)], n_left=70, chunk=chunk)


@pytest.mark.parametrize("rules", [
    ["l.first_name = r.first_name", "l.surname = r.surname"],
    ["l.first_name = r.surname"],
])
def test_device_tier_follows_reference_link_and_dedupe(rules):
    assert _check_parity(rules, "link_and_dedupe", [_df(60, 7), _df(50, 8)], n_left=60,
                         chunk=11)


@pytest.mark.parametrize("link_type", ["dedupe_only", "link_and_dedupe"])
def test_device_tier_duplicate_uids(link_type):
    """Duplicate ordering keys: the strict l.key < r.key ordering drops
    equal-key pairs, and the device uid mask reproduces it."""
    rules = ["l.first_name = r.first_name", "l.first_name = r.surname"]
    if link_type == "dedupe_only":
        frames, n_left = [_df(100, 9, dup_uids=True)], None
    else:
        frames, n_left = [_df(50, 10, dup_uids=True), _df(60, 11, dup_uids=True)], 50
    assert _check_parity(rules, link_type, frames, n_left=n_left, chunk=17)


def test_device_tier_null_only_rule():
    """A rule whose key is null on every row joins nothing, on both tiers."""
    df = _df(30, 12)
    df["first_name"] = None
    assert _check_parity(["l.first_name = r.first_name"], "dedupe_only", [df]) == set()


def test_residual_on_its_threshold_matches_host_join():
    """A numeric residual evaluated exactly on its threshold: the port's
    residual compiler runs in float64 on every device, so the pairs on the
    boundary land as the host join's (and the reference's) do."""
    df = _df(150, 31)
    df["amount"] = np.random.default_rng(2).choice([0.1, 0.2, 0.3, 0.7, None], 150)
    rules = ["l.first_name = r.first_name and l.amount + 0.1 >= r.amount",
             "l.surname = r.surname and r.amount - l.amount <= 0.1"]
    s, sr = _both_settings(rules)
    t = encode_table(df, s)
    on = blocking.block_using_rules(_with(s, device_blocking="on"), t, device="cpu")
    off = blocking.block_using_rules(_with(s, device_blocking="off"), t, device="cpu")
    ref = ref_blocking.block_using_rules(_with(sr, device_blocking="off"), ref_encode(df, sr))
    assert _pairs(on) == _pairs(off) == _pairs(ref)
    # the boundary is exercised: some pair sits exactly on 0.1 apart
    a = t.numerics["amount"].values_f64
    assert any(np.isclose(a[j] - a[i], 0.1) for i, j in zip(on.idx_l, on.idx_r)
               if not (np.isnan(a[i]) or np.isnan(a[j])))


@pytest.mark.parametrize("case", ["dedupe_sym", "dedupe_asym_residual", "link_only"])
def test_plan_arrays_equal_reference(case):
    """The plan itself: every rule's sorted rows (up to the null segment),
    unit tables and pair counts, the per-rule codes, ranks and uid codes
    equal the reference's."""
    if case == "link_only":
        rules, link_type, frames, n_left = (["l.first_name = r.surname",
                                             "l.surname = r.surname"], "link_only",
                                            [_df(70, 5), _df(90, 6)], 70)
    elif case == "dedupe_asym_residual":
        rules, link_type, frames, n_left = (
            ["l.surname = r.surname", "l.first_name = r.surname and l.amount <= r.amount"],
            "dedupe_only", [_df(140, 4, dup_uids=True)], None)
    else:
        rules, link_type, frames, n_left = (["l.first_name = r.first_name"], "dedupe_only",
                                            [_df(5000, 6)], None)
    s, sr = _both_settings(rules, link_type)
    t, tr = _tables(s, sr, link_type, frames)
    got = blocking_device.build_device_plan(s, t, n_left, chunk=16, device="cpu")
    want = ref_bd.build_device_plan(sr, tr, n_left, chunk=16)
    assert got is not None and want is not None
    assert got.n_candidates == want.n_candidates > 0
    for name in ("codes_l", "codes_r", "ranks"):
        np.testing.assert_array_equal(getattr(got, name), getattr(want, name), err_msg=name)
    assert (got.uid_codes is None) == (want.uid_codes is None)
    if got.uid_codes is not None:
        np.testing.assert_array_equal(got.uid_codes, want.uid_codes)
    for r, (g, w) in enumerate(zip(got.rules, want.rules)):
        assert g.rank_filter == w.rank_filter and g.residual == w.residual
        # the non-null entries (the reference pads its entries to a power
        # of two with null keys; the port does not pad)
        cl, cr = got.codes_l[r], got.codes_r[r]
        if link_type == "link_only":
            n_valid = int((cl[:n_left] >= 0).sum() + (cr[n_left:] >= 0).sum())
        elif g.rank_filter:
            n_valid = int((cl >= 0).sum() + (cr >= 0).sum())
        else:
            n_valid = int((cl >= 0).sum())
        np.testing.assert_array_equal(g.order[:n_valid], w.order[:n_valid])
        for name in ("ua", "la", "ub", "lb", "pc"):
            np.testing.assert_array_equal(getattr(g, name), getattr(w, name), err_msg=name)


def test_segment_sort_orders_like_a_three_key_stable_sort():
    """The composite int64 key sorts as (key, side, rank) with a stable
    tie-break, null keys last; segment starts and side counts agree with a
    numpy construction."""
    rng = np.random.default_rng(0)
    m = 5000
    codes = rng.integers(-1, 40, m).astype(np.int32)
    codes[:3] = np.iinfo(np.int32).max - 1  # the largest key that fits
    side = rng.integers(0, 2, m).astype(np.int32)
    rank = rng.integers(0, (1 << 31) - 1, m).astype(np.int32)
    rank[10:20] = rank[0]  # ties resolve by entry order
    rows = rng.permutation(m).astype(np.int32)
    order, starts, lz, rz = blocking_device.segment_sort(codes, side, rank, rows,
                                                         torch.device("cpu"))
    key = np.where(codes < 0, np.iinfo(np.int32).max, codes)
    perm = np.lexsort((np.arange(m), rank, side, key))
    np.testing.assert_array_equal(order, rows[perm])
    ks = key[perm]
    n_valid = int((codes >= 0).sum())
    want_starts = np.flatnonzero(np.r_[True, ks[1:] != ks[:-1]])
    want_starts = want_starts[want_starts < n_valid]
    np.testing.assert_array_equal(starts, want_starts)
    for s0, a, b in zip(starts, lz, rz):
        seg = side[perm][s0 : s0 + a + b]
        assert (seg[:a] == 0).all() and (seg[a:] == 1).all()
        assert s0 + a + b == len(ks) or ks[s0 + a + b] != ks[s0]


def test_budget_capped_run_chunk_shapes():
    """An explicit pair budget streams chunks of at most the budget, uneven
    tails included, and the union equals the host set."""
    s, _ = _both_settings(["l.first_name = r.first_name", "l.surname = r.surname"])
    t = encode_table(_df(300, 13), s)
    plan = blocking_device.build_device_plan(s, t, device="cpu")
    assert plan is not None and plan.n_candidates > 64
    chunks = list(blocking_device.iter_device_pairs(plan, 64))
    assert len(chunks) > 2
    assert all(len(i) == len(j) <= 64 for _r, i, j in chunks)
    assert [r for r, _, _ in chunks] == sorted(r for r, _, _ in chunks)
    got = {(int(a), int(b)) for _r, i, j in chunks for a, b in zip(i, j)}
    assert got == _pairs(blocking.block_using_rules(_with(s, device_blocking="off"), t))


def test_pair_consumer_sees_every_chunk_in_order():
    """The overlap consumer sees every device chunk, in order, with the
    sink's dtype."""
    s, _ = _both_settings(["l.first_name = r.first_name"], device_blocking="on",
                          blocking_chunk_pairs=64)
    t = encode_table(_df(200, 17), s)
    seen = []
    pairs = blocking.block_using_rules(
        s, t, pair_consumer=lambda i, j: seen.append((i.copy(), j.copy())), device="cpu")
    assert len(seen) > 1 and all(i.dtype == np.int32 for i, _ in seen)
    np.testing.assert_array_equal(np.concatenate([i for i, _ in seen]), pairs.idx_l)
    np.testing.assert_array_equal(np.concatenate([j for _, j in seen]), pairs.idx_r)


@pytest.mark.parametrize("rules", [
    ["l.first_name = r.first_name"],  # no mask: the (2, n) stack
    ["l.first_name = r.first_name", "l.surname = r.surname"],
    ["l.first_name = r.surname and l.amount <= r.amount"],
])
def test_card_compacted_form_equals_host_compaction(rules, monkeypatch):
    """The card's form — survivors compacted by a cumsum and a scatter into
    one buffer carrying the count, copied through the pinned ring — forced
    on the CPU gives the arrays of the host compaction, chunk for chunk."""
    s, _ = _both_settings(rules)
    t = encode_table(_df(160, 21, dup_uids=True), s)
    plan = blocking_device.build_device_plan(s, t, device="cpu")
    want = list(blocking_device.iter_device_pairs(plan, 64))
    orig = blocking_device._emission_context

    def card_form(plan, batch_size, mesh=None):
        ctx = orig(plan, batch_size, mesh)
        ctx["compact_dev"] = True
        return ctx

    monkeypatch.setattr(blocking_device, "_emission_context", card_form)
    got = list(blocking_device.iter_device_pairs(plan, 64))
    assert len(got) == len(want) > 1
    for (r1, i1, j1), (r2, i2, j2) in zip(got, want):
        assert r1 == r2 and i1.dtype == np.int32
        np.testing.assert_array_equal(i1, i2)
        np.testing.assert_array_equal(j1, j2)


def test_unsupported_shapes_fall_back_with_their_reason():
    """A cartesian rule has no device plan: "on" logs the degradation with
    its reason and the host join serves the job."""
    s, _ = _both_settings(["l.amount < r.amount"])
    t = encode_table(_df(25, 18), s)
    assert blocking_device.build_device_plan(s, t, device="cpu") is None
    before = dict(blocking.tiers)
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        on = blocking.block_using_rules(_with(s, device_blocking="on"), t, device="cpu")
    msgs = [str(w.message) for w in caught if issubclass(w.category, DegradationWarning)]
    assert msgs and "cartesian" in msgs[0]
    assert blocking.tiers["host"] == before["host"] + 1
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        off = blocking.block_using_rules(_with(s, device_blocking="off"), t, device="cpu")
    np.testing.assert_array_equal(on.idx_l, off.idx_l)


def test_monster_group_falls_back(monkeypatch):
    from splink_tpu_torch import pairgen

    monkeypatch.setattr(pairgen, "MAX_UNITS_PER_GROUP", 2)
    s, _ = _both_settings(["l.first_name = r.first_name"])
    df = _df(120, 19)
    df["first_name"] = "same"  # one giant group
    t = encode_table(df, s)
    assert blocking_device.build_device_plan(s, t, chunk=4, device="cpu") is None


def test_auto_keeps_the_host_join_on_the_cpu(monkeypatch):
    """"auto" on the CPU keeps the host join whatever the pair bound (the
    reference's gate on its CPU backend): no plan is built."""
    monkeypatch.setattr(blocking_device, "AUTO_MIN_PAIRS", 1)

    def boom(*a, **k):
        raise AssertionError("plan built for an auto job on the CPU")

    monkeypatch.setattr(blocking_device, "_plan_or_reason", boom)
    s, _ = _both_settings(["l.first_name = r.first_name"])
    t = encode_table(_df(80, 20), s)
    before = dict(blocking.tiers)
    pairs = blocking.block_using_rules(s, t, device="cpu")
    assert pairs.n_pairs > 0 and blocking.tiers["host"] == before["host"] + 1


def test_auto_below_threshold_never_builds_a_plan(monkeypatch):
    """"auto" on the default device (cuda) weighs the exact rules' bound
    first: a tiny job takes the host join without building a plan or
    touching the device."""
    def boom(*a, **k):
        raise AssertionError("plan built for a tiny auto-mode job")

    monkeypatch.setattr(blocking_device, "_plan_or_reason", boom)
    s, _ = _both_settings(["l.first_name = r.first_name"])
    t = encode_table(_df(40, 20), s)
    assert blocking_device.device_block_rules(s, t, None, None, None, "auto") is None
    assert blocking.block_using_rules(s, t).n_pairs > 0


def test_on_emits_int32_and_composes_with_spill_dir(tmp_path):
    """"on" no longer raises; both tiers emit int32 indices, the spill_dir
    memmap included."""
    s, _ = _both_settings(["l.first_name = r.first_name"])
    t = encode_table(_df(80, 15), s)
    for mode in ("off", "on"):
        pairs = blocking.block_using_rules(_with(s, device_blocking=mode), t, device="cpu")
        assert pairs.idx_l.dtype == pairs.idx_r.dtype == np.int32, mode
        spilled = blocking.block_using_rules(
            _with(s, device_blocking=mode, spill_dir=str(tmp_path / mode)), t, device="cpu")
        assert spilled.spill_tmp is not None and spilled.idx_l.dtype == np.int32
        assert _pairs(spilled) == _pairs(pairs)


def test_bucket_csr_matches_host_and_reference():
    from splink_tpu_torch.blocking import _key_codes, _sort_groups

    s, sr = _both_settings(["l.first_name = r.first_name"])
    t = encode_table(_df(173, 21), s)  # not a power of two
    codes = _key_codes(t, ["first_name"])
    rows_sorted, starts, sizes, row_bucket = blocking_device.build_bucket_csr(codes, "cpu")
    rows = np.flatnonzero(codes >= 0).astype(np.int32)
    h_rows, _, h_starts, h_sizes = _sort_groups(codes, rows)
    np.testing.assert_array_equal(rows_sorted, h_rows)
    np.testing.assert_array_equal(starts, h_starts.astype(np.int32))
    np.testing.assert_array_equal(sizes, h_sizes.astype(np.int32))
    h_bucket = np.full(t.n_rows, -1, np.int32)
    h_bucket[h_rows] = np.repeat(np.arange(len(h_sizes), dtype=np.int32), h_sizes)
    np.testing.assert_array_equal(row_bucket, h_bucket)
    want = ref_bd.build_bucket_csr(codes)
    for g, w in zip((rows_sorted, starts, sizes, row_bucket), want):
        assert g.dtype == np.int32
        np.testing.assert_array_equal(g, np.asarray(w))
    assert blocking_device.build_bucket_csr(np.full(5, -1, np.int64), "cpu")[0].size == 0
