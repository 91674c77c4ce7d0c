"""The durable pair spill store of splink_tpu_torch (spill.py) and its
producer, the sharded emission of the device tier, against splink_tpu's.

Store mechanics are the reference's cases (tests/test_spill.py): commit and
reopen, a foreign job or dtype refused, a torn tail truncated, disk
corruption and missing bytes detected, appends after finalize refused, an
exception aborting the uncommitted tail. The transfer digests (both
layouts, row ids near 2^31 where the uint32 wrap matters) equal the host
mirror. Emission: a resumed store is byte-identical to an uninterrupted
one, the budget envelope is exact and stable across a resume, and the
port's sharded stores are byte-identical to the reference's, bins and
manifest, for every rule set; each package attaches the other's finished
store as complete. The linker's build_spill_dir path trains like
splink_tpu's, and its spill-fed streamed EM is bit-identical to the
port's streamed-G path over the same pair order.
"""

import copy
import json
import os
import warnings

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)
pd = pytest.importorskip("pandas")

import jax.numpy as jnp  # noqa: E402

import splink_tpu  # noqa: E402
import splink_tpu_torch  # noqa: E402
from splink_tpu import blocking_device as ref_bd  # noqa: E402
from splink_tpu import spill as ref_spill  # noqa: E402
from splink_tpu.data import concat_tables as ref_concat  # noqa: E402
from splink_tpu.data import encode_table as ref_encode  # noqa: E402
from splink_tpu.settings import complete_settings_dict as ref_complete  # noqa: E402
from splink_tpu_torch import blocking, blocking_device  # noqa: E402
from splink_tpu_torch.data import concat_tables, encode_table  # noqa: E402
from splink_tpu_torch.ops.gamma import apply_null  # noqa: E402
from splink_tpu_torch.settings import complete_settings_dict  # noqa: E402
from splink_tpu_torch.spill import (  # noqa: E402
    MANIFEST_NAME,
    PairSpillStore,
    SpillCorruptionError,
    SpillError,
    chunk_digest_host,
    iter_spill_gamma_batches,
)
from splink_tpu_torch.utils.logging_utils import DegradationWarning  # noqa: E402

_NAMES = ["john", "mary", "jones", "smith", None, "lee", "ann"]


def _df(n, seed):
    r = np.random.default_rng(seed)
    return pd.DataFrame({
        "unique_id": np.arange(n),
        "first_name": r.choice(_NAMES, n),
        "surname": r.choice(_NAMES, n),
        "amount": r.choice([1.0, 2.5, 3.0, np.nan], n),
    })


def _both_settings(rules, link_type="dedupe_only", **extra):
    raw = {"link_type": link_type,
           "comparison_columns": [{"col_name": "first_name"}, {"col_name": "surname"},
                                  {"col_name": "amount", "data_type": "numeric"}],
           "blocking_rules": list(rules), **extra}
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        return complete_settings_dict(copy.deepcopy(raw)), ref_complete(copy.deepcopy(raw))


def _plan(seed=3, n=200, rules=("l.first_name = r.first_name", "l.surname = r.surname")):
    s, _ = _both_settings(list(rules))
    t = encode_table(_df(n, seed), s)
    plan = blocking_device.build_device_plan(s, t, device="cpu")
    assert plan is not None
    return s, t, plan


def _bins(d):
    return tuple(open(os.path.join(d, name), "rb").read() for name in ("idx_l.bin", "idx_r.bin"))


# ----------------------------------------------------------------------
# Store mechanics
# ----------------------------------------------------------------------


def test_store_commit_reopen_and_pair_index(tmp_path):
    d = str(tmp_path / "pairs")
    store = PairSpillStore.attach(d, np.int32, {"job": "a"})
    store.write_segment(0, 0, 0, np.array([1, 2], np.int32), np.array([3, 4], np.int32))
    store.write_segment(0, 0, 1, np.array([5], np.int32), np.array([6], np.int32))
    store.finalize()
    back = PairSpillStore.attach(d, np.int32, {"job": "a"})
    assert back.completed and back.total_pairs == 3
    pi = back.as_pair_index()
    assert pi.idx_l.tolist() == [1, 2, 5] and pi.idx_r.tolist() == [3, 4, 6]
    assert pi.spill_store is back
    back.verify()
    # PairIndex.release closes the store's maps and leaves its files
    mm = pi.idx_l._mmap
    pi.release()
    assert mm.closed and os.path.exists(os.path.join(d, "idx_l.bin"))


def test_store_refuses_foreign_meta_and_dtype(tmp_path):
    d = str(tmp_path / "pairs")
    PairSpillStore.attach(d, np.int32, {"state_hash": "aaa"}).finalize()
    with pytest.raises(SpillError, match="different job"):
        PairSpillStore.attach(d, np.int32, {"state_hash": "bbb"})
    with pytest.raises(SpillError, match="int64"):
        PairSpillStore.attach(d, np.int64, {"state_hash": "aaa"})
    # extra bookkeeping merged by finalize() must not break re-attach
    PairSpillStore.attach(d, np.int32, {"state_hash": "aaa"})


def test_store_truncates_torn_tail_on_attach(tmp_path):
    d = str(tmp_path / "pairs")
    store = PairSpillStore.attach(d, np.int32, {})
    store.write_segment(0, 0, 0, np.arange(4, dtype=np.int32), np.arange(4, dtype=np.int32))
    store.close()
    for name in ("idx_l.bin", "idx_r.bin"):
        with open(os.path.join(d, name), "ab") as fh:
            fh.write(b"tornbytes")
    back = PairSpillStore.attach(d, np.int32, {})
    assert back.total_pairs == 4
    assert os.path.getsize(os.path.join(d, "idx_l.bin")) == 16
    seg = back.write_segment(0, 0, 1, np.array([9], np.int32), np.array([9], np.int32))
    assert seg.offset == 4


def test_store_detects_disk_corruption(tmp_path):
    d = str(tmp_path / "pairs")
    store = PairSpillStore.attach(d, np.int32, {})
    store.write_segment(0, 0, 0, np.arange(8, dtype=np.int32), np.arange(8, dtype=np.int32))
    store.finalize()
    with open(os.path.join(d, "idx_r.bin"), "r+b") as fh:
        fh.seek(4)
        fh.write(b"\xff\xff\xff\xff")
    with pytest.raises(SpillCorruptionError, match="sha256"):
        PairSpillStore.attach(d, np.int32, {}).verify()


def test_store_missing_bytes_is_corruption(tmp_path):
    d = str(tmp_path / "pairs")
    store = PairSpillStore.attach(d, np.int32, {})
    store.write_segment(0, 0, 0, np.arange(8, dtype=np.int32), np.arange(8, dtype=np.int32))
    store.close()
    with open(os.path.join(d, "idx_l.bin"), "r+b") as fh:
        fh.truncate(8)  # shorter than the committed watermark
    with pytest.raises(SpillCorruptionError, match="manifest commits"):
        PairSpillStore.attach(d, np.int32, {})


def test_store_refuses_append_after_finalize_and_duplicate_segment(tmp_path):
    d = str(tmp_path / "pairs")
    store = PairSpillStore.attach(d, np.int32, {})
    store.write_segment(0, 0, 0, np.array([1], np.int32), np.array([2], np.int32))
    with pytest.raises(SpillError, match="already committed"):
        store.write_segment(0, 0, 0, np.array([1], np.int32), np.array([2], np.int32))
    store.finalize()
    with pytest.raises(SpillError, match="finalized"):
        store.write_segment(0, 0, 1, np.array([1], np.int32), np.array([2], np.int32))


def test_store_context_manager_aborts_uncommitted(tmp_path):
    d = str(tmp_path / "pairs")
    store = PairSpillStore.attach(d, np.int32, {})
    with pytest.raises(RuntimeError):
        with store:
            store.write_segment(0, 0, 0, np.array([1], np.int32), np.array([2], np.int32))
            fl, _fr = store._open_files()
            fl.write(b"\x01\x02\x03\x04")
            fl.flush()
            raise RuntimeError("boom")
    assert os.path.getsize(os.path.join(d, "idx_l.bin")) == 4  # 1 committed pair
    assert PairSpillStore.attach(d, np.int32, {}).total_pairs == 1


# ----------------------------------------------------------------------
# Transfer digests
# ----------------------------------------------------------------------


@pytest.mark.parametrize("hi", [1000, (1 << 31) - 1])
def test_chunk_digest_equals_host_mirror_and_reference(hi):
    """The device digest over the kept lanes equals chunk_digest_host and
    the reference's jitted digest, with row ids up to 2^31 - 1 (where the
    uint32 products and the sum wrap)."""
    rng = np.random.default_rng(7)
    n = 4099
    i = rng.integers(max(hi - 5000, 0), hi, n, endpoint=True).astype(np.int32)
    j = rng.integers(max(hi - 5000, 0), hi, n, endpoint=True).astype(np.int32)
    keep = rng.integers(0, 2, n).astype(bool)
    got = int(blocking_device.chunk_digest(torch.from_numpy(i), torch.from_numpy(j),
                                           torch.from_numpy(keep)))
    assert got == chunk_digest_host(i[keep], j[keep]) == ref_spill.chunk_digest_host(
        i[keep], j[keep])
    want = int(np.asarray(ref_bd.make_chunk_digest_fn()(jnp.asarray(i), jnp.asarray(j),
                                                         jnp.asarray(keep))))
    assert got == want


def test_compact_digest_equals_host_mirror():
    """The compacted layout (survivors in the leading lanes, the count as
    i_ext's last lane, garbage past it) digests like the host mirror over
    the downloaded prefix."""
    rng = np.random.default_rng(9)
    bs, cnt = 64, 37
    i = rng.integers(-(1 << 31), (1 << 31) - 1, bs).astype(np.int32)  # garbage lanes
    j = rng.integers(-(1 << 31), (1 << 31) - 1, bs).astype(np.int32)
    i[:cnt] = rng.integers((1 << 31) - 100, (1 << 31) - 1, cnt)
    j[:cnt] = rng.integers(0, 500, cnt)
    i_ext = torch.from_numpy(np.concatenate([i, [cnt]]).astype(np.int32))
    got = int(blocking_device.chunk_digest_compact(i_ext, torch.from_numpy(j),
                                                   torch.arange(bs)))
    assert got == chunk_digest_host(i[:cnt], j[:cnt])


def test_digest_mismatch_raises(tmp_path):
    rng = np.random.default_rng(7)
    i = rng.integers(0, 1000, 257).astype(np.int32)
    j = rng.integers(0, 1000, 257).astype(np.int32)
    keep = rng.integers(0, 2, 257).astype(bool)
    dev = int(blocking_device.chunk_digest(torch.from_numpy(i), torch.from_numpy(j),
                                           torch.from_numpy(keep)))
    store = PairSpillStore.attach(str(tmp_path / "p"), np.int32, {})
    store.write_segment(0, 0, 0, i[keep], j[keep], digest=dev)
    with pytest.raises(SpillCorruptionError, match="transfer digest"):
        store.write_segment(0, 0, 1, i[~keep], j[~keep], digest=dev + 1)


# ----------------------------------------------------------------------
# Sharded emission: against the reference, resume, budget
# ----------------------------------------------------------------------

RULESETS = [
    ["l.first_name = r.first_name"],
    ["l.first_name = r.first_name and l.surname = r.surname"],
    ["l.first_name = r.first_name", "l.surname = r.surname"],
    ["l.first_name = r.surname"],
    ["l.surname = r.surname", "l.first_name = r.surname and l.amount = r.amount"],
    ["substr(l.surname,1,2) = substr(r.surname,1,2)"],
    ["l.first_name = r.first_name and l.amount + 1 > r.amount"],
    ["l.surname = r.surname and l.amount <= r.amount", "l.first_name = r.first_name"],
]


@pytest.mark.parametrize("rules", RULESETS)
def test_sharded_emission_is_byte_identical_to_reference(rules, tmp_path):
    """emit_pairs_sharded (3 shards, chunks of 64) writes the reference's
    bins and manifest segments byte for byte, digests included; the pair
    set is the port's single-stream device tier's and the host join's."""
    s, sr = _both_settings(rules)
    df = _df(120, 3)
    t, tr = encode_table(df, s), ref_encode(df, sr)
    plan = blocking_device.build_device_plan(s, t, device="cpu")
    rplan = ref_bd.build_device_plan(sr, tr)
    got = PairSpillStore.attach(str(tmp_path / "port"), np.int32, {})
    with got:
        blocking_device.emit_pairs_sharded(plan, got, 64, n_shards=3)
    got.finalize()
    want = ref_spill.PairSpillStore.attach(str(tmp_path / "ref"), np.int32, {})
    with want:
        ref_bd.emit_pairs_sharded(rplan, want, 64, n_shards=3)
    want.finalize()
    assert _bins(got.directory) == _bins(want.directory)
    m1 = json.load(open(os.path.join(got.directory, MANIFEST_NAME)))
    m2 = json.load(open(os.path.join(want.directory, MANIFEST_NAME)))
    assert m1 == m2
    pi = got.as_pair_index()
    single = [(int(a), int(b)) for _r, i, j in blocking_device.iter_device_pairs(plan, 64)
              for a, b in zip(i, j)]
    assert list(zip(pi.idx_l.tolist(), pi.idx_r.tolist())) == single
    host = blocking.block_using_rules({**s, "device_blocking": "off"}, t)
    assert set(single) == set(zip(host.idx_l.tolist(), host.idx_r.tolist()))


def test_card_form_writes_the_same_store(tmp_path, monkeypatch):
    """The card's compacted form (digest computed on the device over the
    compacted layout, carried in the buffer's last lane) writes the store
    the host compaction writes, digests included."""
    _s, _t, plan = _plan()
    a = PairSpillStore.attach(str(tmp_path / "host"), np.int32, {})
    with a:
        blocking_device.emit_pairs_sharded(plan, a, 128, n_shards=2)
    a.finalize()
    orig = blocking_device._emission_context

    def card_form(plan, batch_size, mesh=None):
        ctx = orig(plan, batch_size, mesh)
        ctx["compact_dev"] = True
        return ctx

    monkeypatch.setattr(blocking_device, "_emission_context", card_form)
    b = PairSpillStore.attach(str(tmp_path / "card"), np.int32, {})
    with b:
        blocking_device.emit_pairs_sharded(plan, b, 128, n_shards=2)
    b.finalize()
    assert _bins(a.directory) == _bins(b.directory)
    assert [x.to_json() for x in a.segments] == [x.to_json() for x in b.segments]
    assert any(x.digest is not None for x in b.segments)  # the second rule masks


def _dying(store, after):
    orig = store.write_segment
    count = [0]

    def dying(*a, **k):
        if count[0] >= after:
            raise RuntimeError("simulated death mid-build")
        count[0] += 1
        return orig(*a, **k)

    store.write_segment = dying
    return orig


def test_resumed_emission_is_byte_identical(tmp_path):
    """A driver that died after 4 commits, relaunched over the same store,
    skips the committed prefix and appends the uninterrupted run's bytes."""
    _s, _t, plan = _plan()
    full = PairSpillStore.attach(str(tmp_path / "full"), np.int32, {})
    with full:
        blocking_device.emit_pairs_sharded(plan, full, 128, n_shards=3)
    full.finalize()
    part = PairSpillStore.attach(str(tmp_path / "part"), np.int32, {})
    orig = _dying(part, 4)
    with pytest.raises(RuntimeError):
        with part:
            blocking_device.emit_pairs_sharded(plan, part, 128, n_shards=3)
    part.write_segment = orig
    resumed = PairSpillStore.attach(str(tmp_path / "part"), np.int32, {})
    with resumed:
        stats = blocking_device.emit_pairs_sharded(plan, resumed, 128, n_shards=3)
    resumed.finalize()
    assert stats["skipped"] == 4
    assert _bins(resumed.directory) == _bins(full.directory)
    assert [x.to_json() for x in resumed.segments] == [x.to_json() for x in full.segments]


def test_budget_envelope_exact_and_resume_stable(tmp_path):
    _s, _t, plan = _plan()
    store = PairSpillStore.attach(str(tmp_path / "b"), np.int32, {})
    with store:
        stats = blocking_device.emit_pairs_sharded(plan, store, 64, n_shards=2, budget=150)
    store.finalize()
    assert store.total_pairs == 150 and stats["exhausted"]
    manifest = json.load(open(os.path.join(store.directory, MANIFEST_NAME)))
    part = PairSpillStore.attach(str(tmp_path / "b2"), np.int32, {})
    orig = _dying(part, 1)
    with pytest.raises(RuntimeError):
        with part:
            blocking_device.emit_pairs_sharded(plan, part, 64, n_shards=2, budget=150)
    part.write_segment = orig
    resumed = PairSpillStore.attach(str(tmp_path / "b2"), np.int32, {})
    with resumed:
        blocking_device.emit_pairs_sharded(plan, resumed, 64, n_shards=2, budget=150)
    resumed.finalize()
    m2 = json.load(open(os.path.join(resumed.directory, MANIFEST_NAME)))
    assert m2["segments"] == manifest["segments"]
    assert resumed.total_pairs == 150


@pytest.mark.parametrize("link_type", ["dedupe_only", "link_only", "link_and_dedupe"])
def test_spill_block_rules_byte_identical_across_packages(link_type, tmp_path):
    """Both packages' spill_block_rules on the same settings and rows write
    identical bins and manifests (meta and state hash included), and each
    attaches the other's finished store as complete, returning the same
    pairs without emitting again."""
    rules = ["l.first_name = r.first_name", "l.first_name = r.surname"]
    s, sr = _both_settings(rules, link_type, emit_shard_chunks=3, blocking_chunk_pairs=64)
    if link_type == "dedupe_only":
        df = _df(150, 11)
        t, tr, n_left = encode_table(df, s), ref_encode(df, sr), None
    else:
        frames = (_df(70, 5), _df(80, 6))
        t, tr, n_left = concat_tables(*frames, s), ref_concat(*frames, sr), 70
    port = blocking_device.spill_block_rules(s, t, n_left, str(tmp_path / "port"),
                                             device="cpu")
    ref = ref_bd.spill_block_rules(sr, tr, n_left, str(tmp_path / "ref"))
    pd_, rd = (os.path.join(str(tmp_path / x), "pairs") for x in ("port", "ref"))
    assert _bins(pd_) == _bins(rd)
    assert json.load(open(os.path.join(pd_, MANIFEST_NAME))) == json.load(
        open(os.path.join(rd, MANIFEST_NAME)))
    assert len(port.spill_store.segments) > 3
    # each package attaches the other's finished store
    theirs = blocking_device.spill_block_rules(s, t, n_left, str(tmp_path / "ref"),
                                               device="cpu")
    ours = ref_bd.spill_block_rules(sr, tr, n_left, str(tmp_path / "port"))
    assert theirs.spill_store.completed and ours.spill_store.completed
    for a in (theirs, ours):
        np.testing.assert_array_equal(a.idx_l, port.idx_l)
        np.testing.assert_array_equal(a.idx_r, ref.idx_r)


def test_spill_block_rules_settings_shapes(tmp_path):
    """emit_shard_chunks resolves the shard count; a cartesian rule has no
    device plan, and the caller falls back."""
    s, _ = _both_settings(["l.first_name = r.first_name"], emit_shard_chunks=2,
                          blocking_chunk_pairs=256)
    t = encode_table(_df(120, 19), s)
    assert blocking_device.spill_block_rules(s, t, None, str(tmp_path / "ok"), device="cpu")
    m = json.load(open(os.path.join(str(tmp_path / "ok"), "pairs", MANIFEST_NAME)))
    assert m["meta"]["n_shards"] == 2 and {seg["shard"] for seg in m["segments"]} == {0, 1}
    s2, _ = _both_settings(["l.amount < r.amount"])
    t2 = encode_table(_df(25, 18).assign(amount=np.arange(25.0)), s2)
    assert blocking_device.spill_block_rules(s2, t2, None, str(tmp_path / "no"),
                                             device="cpu") is None


# ----------------------------------------------------------------------
# The spill-fed gamma stream and the linker
# ----------------------------------------------------------------------


def test_iter_spill_gamma_batches_equals_resident_gammas(tmp_path):
    from splink_tpu_torch.gammas import GammaProgram

    s, _ = _both_settings(["l.first_name = r.first_name"])
    t = encode_table(_df(150, 11), s)
    pi = blocking_device.spill_block_rules(s, t, None, str(tmp_path), device="cpu")
    program = GammaProgram(s, t, device="cpu")
    chunks = list(iter_spill_gamma_batches(pi.spill_store, program, batch_size=64))
    assert len(chunks) > 1
    G_full, _ = program.compute_with_device(np.asarray(pi.idx_l), np.asarray(pi.idx_r),
                                            batch_size=64)
    np.testing.assert_array_equal(np.concatenate(chunks), G_full)


def test_iter_spill_gamma_batches_refuses_unfinalized(tmp_path):
    from splink_tpu_torch.gammas import GammaProgram

    s, _ = _both_settings(["l.first_name = r.first_name"])
    t = encode_table(_df(40, 12), s)
    store = PairSpillStore.attach(str(tmp_path / "p"), np.int32, {})
    store.write_segment(0, 0, 0, np.array([0], np.int32), np.array([1], np.int32))
    with pytest.raises(SpillError, match="not finalized"):
        list(iter_spill_gamma_batches(store, GammaProgram(s, t, device="cpu"), 64))


LETTERS = np.array(list("abcdefghijklmnopqrstuvwxyz"))


def _people(n, seed):
    """The streaming tests' people frame: names from pools, ~10% planted
    duplicates with a one-character typo sharing their source's block."""
    rng = np.random.default_rng(seed)
    pool = lambda k, lo, hi: np.array(  # noqa: E731
        ["".join(rng.choice(LETTERS, rng.integers(lo, hi + 1))) for _ in range(k)], object)
    n_dup = n // 10
    n_base = n - n_dup
    cols = {"first_name": pool(max(n // 8, 20), 4, 9), "surname": pool(max(n // 3, 20), 4, 9),
            "city": pool(max(n // 20, 10), 5, 10)}
    df = {k: v[rng.integers(0, len(v), n_base)] for k, v in cols.items()}
    df["dob"] = rng.integers(0, 3000, n_base).astype(np.float64)
    df["blk"] = rng.integers(0, max(n // 40, 1), n_base)
    src = rng.integers(0, n_base, n_dup)
    for k in df:
        df[k] = np.concatenate([df[k], df[k][src]])
    for r in range(n_base, n):
        k = ("first_name", "surname", "city")[rng.integers(0, 3)]
        s = df[k][r]
        i = int(rng.integers(0, len(s)))
        df[k][r] = s[:i] + str(rng.choice(LETTERS)) + s[i + 1:]
    for k in ("first_name", "surname", "city", "dob"):
        df[k] = df[k].astype(object)
        df[k][rng.random(n) < 0.02] = None
    df["unique_id"] = np.arange(n)
    return pd.DataFrame(df)


def _linker_settings(**extra):
    s = {"link_type": "dedupe_only", "blocking_rules": ["l.blk = r.blk", "l.city = r.city"],
         "max_iterations": 8,
         "comparison_columns": [
             {"col_name": "first_name", "num_levels": 3,
              "comparison": {"kind": "jaro_winkler", "thresholds": [0.94, 0.88]}},
             {"col_name": "surname", "num_levels": 3,
              "comparison": {"kind": "jaro_winkler", "thresholds": [0.94, 0.88]}},
             {"col_name": "city", "num_levels": 3,
              "comparison": {"kind": "levenshtein", "thresholds": [0.3]}},
             {"col_name": "dob", "data_type": "numeric", "num_levels": 2,
              "comparison": {"kind": "numeric_abs", "thresholds": [1.0]}}]}
    s.update(extra)
    return s


def _custom_surname(ctx, col_settings):
    pc = ctx.col("surname")
    return apply_null((pc.tok_l == pc.tok_r).to(torch.int8), pc.null)


def _ref_custom_surname(ctx, col_settings):
    from splink_tpu.ops.gamma import apply_null as ref_apply_null

    pc = ctx.col("surname")
    return ref_apply_null((pc.tok_l == pc.tok_r).astype(jnp.int8), pc.null)


splink_tpu_torch.register_comparison("spill_surname_exact", _custom_surname)
splink_tpu.register_comparison("spill_surname_exact", _ref_custom_surname)


def _custom(s):
    s["comparison_columns"][3] = {"custom_name": "surname_exact",
                                  "custom_columns_used": ["surname"], "num_levels": 2,
                                  "comparison": {"kind": "custom", "fn": "spill_surname_exact"}}
    return s


@pytest.fixture(scope="module")
def frame():
    return _people(1500, seed=5)


@pytest.mark.parametrize("regime", ["pattern", "streamed_spill"])
def test_build_spill_dir_trains_like_the_reference(frame, regime, tmp_path):
    """build_spill_dir end to end against splink_tpu: the same store on
    disk, the same pairs, and lambda, m and u within 1e-5 (the tolerance of
    test_torch_streaming.py; float64 for the custom comparison's streamed
    EM, whose float32 sums drift between the packages). The pattern regime
    reads its pattern ids from the store's pairs; a custom comparison
    trains by the spill-fed streamed EM."""
    s = _linker_settings(max_resident_pairs=1024, device_pair_generation="off",
                         blocking_chunk_pairs=4096, emit_shard_chunks=2)
    if regime == "streamed_spill":
        s = _custom(s)
        s.update(float64=True, pair_batch_size=4096)
    ref = splink_tpu.Splink({**copy.deepcopy(s), "build_spill_dir": str(tmp_path / "ref")},
                            df=frame)
    ref.estimate_parameters()
    got = splink_tpu_torch.Splink({**copy.deepcopy(s), "build_spill_dir": str(tmp_path / "p")},
                                  df=frame, device="cpu")
    got.estimate_parameters()
    assert got._pairs.spill_store is not None and got._pairs.spill_store.completed
    assert _bins(str(tmp_path / "p" / "pairs")) == _bins(str(tmp_path / "ref" / "pairs"))
    if regime == "pattern":
        assert got._use_pattern_pipeline() and got._P is not None
        np.testing.assert_array_equal(got._pattern_counts, ref._pattern_counts)
    else:
        assert not got._use_pattern_pipeline() and "em_streamed" in got.stage_seconds
    assert len(got.params.param_history) == len(ref.params.param_history)
    for a, b in zip(ref.params.to_arrays()[:3], got.params.to_arrays()[:3]):
        np.testing.assert_allclose(b, a, rtol=0, atol=1e-5)


def test_spill_fed_em_is_bit_identical_to_streamed_g(frame, tmp_path):
    """The spill-fed streamed EM and the streamed-G path over the device
    tier's pair order cut the same batches, so lambda, m, u and their
    whole history are bit-identical; a relaunch over the finished store
    reuses it and trains the same again."""
    s = _custom(_linker_settings(max_resident_pairs=1024, pair_batch_size=4096,
                                 device_blocking="on"))
    spill = splink_tpu_torch.Splink({**copy.deepcopy(s), "build_spill_dir": str(tmp_path)},
                                    df=frame, device="cpu")
    spill.estimate_parameters()
    streamed = splink_tpu_torch.Splink(copy.deepcopy(s), df=frame, device="cpu")
    streamed.estimate_parameters()
    assert "em_streamed" in spill.stage_seconds and "em_streamed" in streamed.stage_seconds
    assert streamed._pairs.spill_store is None
    np.testing.assert_array_equal(spill._pairs.idx_l, streamed._pairs.idx_l)
    np.testing.assert_array_equal(spill._pairs.idx_r, streamed._pairs.idx_r)
    def state(lk):
        return json.dumps({"p": lk.params.params, "h": lk.params.param_history},
                          sort_keys=True)

    assert state(spill) == state(streamed)
    again = splink_tpu_torch.Splink({**copy.deepcopy(s), "build_spill_dir": str(tmp_path)},
                                    df=frame, device="cpu")
    again.estimate_parameters()
    assert state(again) == state(spill)


def test_build_spill_dir_falls_back_for_a_cartesian_rule(tmp_path):
    """A rule shape the device plan rejects: the linker logs the
    degradation and takes the ordinary host path; nothing is written."""
    df = _df(40, 2)
    s = {"link_type": "dedupe_only", "blocking_rules": ["l.amount < r.amount"],
         "comparison_columns": [{"col_name": "first_name"}, {"col_name": "surname"}],
         "max_iterations": 2, "build_spill_dir": str(tmp_path)}
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        lk = splink_tpu_torch.Splink(s, df=df, device="cpu")
        out = lk.get_scored_comparisons()
    assert any(issubclass(w.category, DegradationWarning) for w in caught)
    assert lk._pairs.spill_store is None and len(out) == lk._pairs.n_pairs > 0
    assert not os.path.exists(os.path.join(str(tmp_path), "pairs"))
