"""splink_tpu_torch's GammaStream / PatternStream and the linker's overlap
of blocking and scoring, against the sequential paths and splink_tpu.

Pair chunks stream into the gamma or pattern program WHILE blocking emits
them. Whatever the chunking, a stream's result equals
``compute_with_device`` / ``compute_pattern_ids`` over the concatenated
pairs bit for bit, and equals the reference's streams (gammas, pattern
ids and counts: discrete, so exact). The overlapped linker equals the
sequential block-then-score linker bit for bit in every regime (the
chunkings of tests/test_overlap_blocking.py), and the reference's linker
in float64 within 1e-9.
"""

import copy

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)
pd = pytest.importorskip("pandas")

import jax.numpy as jnp  # noqa: E402

import splink_tpu  # noqa: E402
from splink_tpu import gammas as ref_gammas  # noqa: E402
from splink_tpu.data import encode_table as ref_encode  # noqa: E402
from splink_tpu.settings import complete_settings_dict as ref_complete  # noqa: E402
import splink_tpu_torch  # noqa: E402
from splink_tpu_torch import gammas  # noqa: E402
from splink_tpu_torch.data import encode_table  # noqa: E402
from splink_tpu_torch.ops.gamma import apply_null  # noqa: E402
from splink_tpu_torch.settings import complete_settings_dict  # noqa: E402

CHUNKINGS = [[977, 1024, 3, 996], [3000], [1, 2999], [1, 1, 1, 2997], [0, 3000, 0]]


def _programs(n=500, seed=0):
    rng = np.random.default_rng(seed)
    df = pd.DataFrame({
        "unique_id": np.arange(n),
        "name": rng.choice(["ann", "anne", "bob", "bobby", "cat", "dan", None], n),
        "age": rng.integers(20, 60, n).astype(float),
    })
    raw = {"link_type": "dedupe_only", "blocking_rules": [], "comparison_columns": [
        {"col_name": "name", "num_levels": 3,
         "comparison": {"kind": "jaro_winkler", "thresholds": [0.94, 0.88]}},
        {"col_name": "age", "num_levels": 3, "data_type": "numeric"}]}
    import warnings

    with warnings.catch_warnings():
        warnings.simplefilter("ignore")  # no blocking rules: the cartesian warning
        s, rs = complete_settings_dict(copy.deepcopy(raw)), ref_complete(copy.deepcopy(raw))
    port = gammas.GammaProgram(s, encode_table(df, s), device="cpu")
    ref = ref_gammas.GammaProgram(rs, ref_encode(df, rs))
    return n, port, ref


def _random_pairs(n_rows, n_pairs, seed=1):
    rng = np.random.default_rng(seed)
    return (rng.integers(0, n_rows, n_pairs).astype(np.int32),
            rng.integers(0, n_rows, n_pairs).astype(np.int32))


def _feed(stream, il, ir, sizes):
    pos = 0
    for s in sizes:
        stream.feed(il[pos : pos + s], ir[pos : pos + s])
        pos += s
    assert pos == len(il)
    return stream.finish()


@pytest.mark.parametrize("chunks", CHUNKINGS, ids=str)
def test_gamma_stream_equals_compute_and_reference(chunks):
    n, program, ref = _programs()
    il, ir = _random_pairs(n, sum(chunks))
    want, _ = program.compute_with_device(il, ir, batch_size=256)
    got, dev = _feed(gammas.GammaStream(program, batch_size=256), il, ir, chunks)
    np.testing.assert_array_equal(got, want)
    assert dev is None  # keep_device_limit 0
    ref_got, _ = _feed(ref_gammas.GammaStream(ref, batch_size=256), il, ir, chunks)
    np.testing.assert_array_equal(got, ref_got)
    np.testing.assert_array_equal(program.compute(il, ir, 700), want)
    # the bounded working-set twin: blocks of batch_size that concatenate to
    # the same matrix
    blocks = list(program.iter_gamma_chunks(il, ir, 700))
    assert [len(b) for b in blocks] == [len(b) for b in ref.iter_gamma_chunks(il, ir, 700)]
    np.testing.assert_array_equal(np.concatenate(blocks) if blocks else want[:0], want)


@pytest.mark.parametrize("chunks", CHUNKINGS, ids=str)
def test_pattern_stream_equals_compute_and_reference(chunks):
    n, program, ref = _programs()
    il, ir = _random_pairs(n, sum(chunks))
    want_p, want_c = program.compute_pattern_ids(il, ir, batch_size=256)
    got_p, got_c = _feed(gammas.PatternStream(program, batch_size=256), il, ir, chunks)
    np.testing.assert_array_equal(got_p, want_p)
    np.testing.assert_array_equal(got_c, want_c)
    ref_p, ref_c = _feed(ref_gammas.PatternStream(ref, batch_size=256), il, ir, chunks)
    assert got_p.dtype == ref_p.dtype == np.uint16
    np.testing.assert_array_equal(got_p, ref_p)
    np.testing.assert_array_equal(got_c, ref_c)
    # the ids decode back to the gamma matrix through the pattern matrix
    np.testing.assert_array_equal(program.patterns_matrix()[got_p], program.compute(il, ir))
    np.testing.assert_array_equal(program.patterns_matrix(), ref.patterns_matrix())


def test_pattern_helpers_equal_reference():
    """Strides, pattern count, the uint16 predicate and the host-G
    histogram (pattern_counts_from_gammas) equal the reference's."""
    for levels in ([2, 3], [3, 3, 3, 2, 2], [4] * 6, [2] * 15):
        assert gammas.pattern_strides_for(levels) == ref_gammas.pattern_strides_for(levels)
        _, n = gammas.pattern_strides_for(levels)
        assert gammas.pattern_ids_fit_uint16(n) == ref_gammas.pattern_ids_fit_uint16(n)
    assert gammas.MAX_PATTERNS == ref_gammas.MAX_PATTERNS
    rng = np.random.default_rng(4)
    levels = [3, 2, 4]
    G = np.stack([rng.integers(-1, lv, 5000) for lv in levels], axis=1).astype(np.int8)
    got = gammas.pattern_counts_from_gammas(G, levels, batch_size=700, device="cpu")
    np.testing.assert_array_equal(got, ref_gammas.pattern_counts_from_gammas(G, levels, 700))


def test_gamma_stream_keeps_device_copy_within_limit():
    n, program, _ = _programs()
    il, ir = _random_pairs(n, 1000)
    host, dev = _feed(gammas.GammaStream(program, 256, keep_device_limit=2000), il, ir,
                      [600, 400])
    assert dev is not None
    np.testing.assert_array_equal(dev.numpy(), host)
    # past the limit the device copy goes, the host matrix stays whole
    host2, dev2 = _feed(gammas.GammaStream(program, 256, keep_device_limit=999), il, ir,
                        [600, 400])
    assert dev2 is None
    np.testing.assert_array_equal(host2, host)


def test_empty_streams():
    _, program, _ = _programs(n=50)
    host, dev = gammas.GammaStream(program, 64).finish()
    assert host.shape == (0, 2) and dev is None
    pids, counts = gammas.PatternStream(program, 64).finish()
    assert len(pids) == 0 and counts.shape == (program.n_patterns,) and counts.sum() == 0
    h, d = program.compute_with_device(np.zeros(0, np.int32), np.zeros(0, np.int32),
                                       keep_device=True)
    assert h.shape == (0, 2) and tuple(d.shape) == (0, 2)


def _scenario_df(n=400, seed=3):
    rng = np.random.default_rng(seed)
    return pd.DataFrame({"unique_id": np.arange(n),
                         "name": rng.choice(["ann", "bob", "cat", "dan", "eve"], n),
                         "city": rng.choice(["x", "y", "z"], n),
                         "age": rng.integers(20, 60, n).astype(float)})


def _settings(**over):
    s = {"link_type": "dedupe_only",
         "comparison_columns": [{"col_name": "name", "num_levels": 2},
                                {"col_name": "age", "num_levels": 3, "data_type": "numeric"}],
         "blocking_rules": ["l.city = r.city", "l.name = r.name"], "max_iterations": 4}
    s.update(over)
    return s


def _exact_name(ctx, col_settings):
    pc = ctx.col("name")
    return apply_null((pc.tok_l == pc.tok_r).to(torch.int8), pc.null)


def _ref_exact_name(ctx, col_settings):
    from splink_tpu.ops.gamma import apply_null as ref_apply_null

    pc = ctx.col("name")
    return ref_apply_null((pc.tok_l == pc.tok_r).astype(jnp.int8), pc.null)


splink_tpu_torch.register_comparison("overlap_exact_name", _exact_name)
splink_tpu.register_comparison("overlap_exact_name", _ref_exact_name)
_CUSTOM = [{"col_name": "name", "num_levels": 2,
            "comparison": {"kind": "custom", "fn": "overlap_exact_name"}},
           {"col_name": "age", "num_levels": 3, "data_type": "numeric"}]

# id: (settings changes, stream the overlap must feed)
REGIMES = {
    "resident": ({}, "GammaStream"),
    "pattern": ({"max_resident_pairs": 2048, "device_pair_generation": "off"}, "PatternStream"),
    "custom_resident": ({"comparison_columns": _CUSTOM, "blocking_rules": ["l.city = r.city"]},
                        "GammaStream"),
    # a custom comparison cannot use patterns: the streamed regime
    "custom_streamed": ({"comparison_columns": _CUSTOM, "blocking_rules": ["l.city = r.city"],
                         "max_resident_pairs": 2048}, "GammaStream"),
    "cartesian_spill": ({"blocking_rules": [], "spill_dir": True}, "GammaStream"),
}


@pytest.mark.parametrize("regime", list(REGIMES))
def test_linker_overlap_equals_sequential_and_reference(tmp_path, monkeypatch, regime):
    """The overlapped linker (blocking feeds the stream) equals the
    sequential one (overlap_blocking off) bit for bit, frame for frame in
    row order; and, in float64, the reference's frame in row order with
    dtypes (probabilities within 1e-9)."""
    change, stream_kind = REGIMES[regime]
    s = _settings(**change)
    if s.get("spill_dir"):
        s["spill_dir"] = str(tmp_path)
    df = _scenario_df(60 if regime == "cartesian_spill" else 400)
    fed = []
    for name in ("GammaStream", "PatternStream"):
        cls = getattr(gammas, name)
        monkeypatch.setattr(cls, "feed", lambda self, i, j, _f=cls.feed, _n=name: (
            fed.append(_n), _f(self, i, j))[1])
    a = splink_tpu_torch.Splink(copy.deepcopy(s), df=df, device="cpu").get_scored_comparisons()
    assert fed and set(fed) == {stream_kind}
    b = splink_tpu_torch.Splink(dict(copy.deepcopy(s), overlap_blocking=False), df=df,
                                device="cpu").get_scored_comparisons()
    pd.testing.assert_frame_equal(a, b, check_exact=True)
    # the reference in float64: this frame's age column is nearly
    # uninformative (m ~= u), and over the EM updates the float32 sums of
    # the two packages drift apart by ~1e-4 (ROADMAP.md Queue 3: the
    # reference's float32 EM is the less accurate one)
    s64 = dict(copy.deepcopy(s), float64=True)
    have = splink_tpu_torch.Splink(copy.deepcopy(s64), df=df, device="cpu").get_scored_comparisons()
    want = splink_tpu.Splink(copy.deepcopy(s64), df=df).get_scored_comparisons()
    assert list(have.columns) == list(want.columns)
    assert list(have.dtypes) == list(want.dtypes)
    for c in want.columns:
        if want[c].dtype.kind == "f":
            np.testing.assert_allclose(have[c], want[c], rtol=0, atol=1e-9, err_msg=c)
        else:
            assert have[c].equals(want[c]), c
