"""splink_tpu_torch's regimes past max_resident_pairs against splink_tpu's:
the pattern regime (virtual and materialised pairs), the streamed-G regime,
the streaming entry points, train-only estimation and the spill_dir sink.

Frames are compared with the reference's IN ROW ORDER, WITH DTYPES, as
test_torch_linker.py::test_path_parity_in_row_order does: ids, gammas and
retained values equal row for row, probabilities within 1e-5 (XLA's and
PyTorch's log/sigmoid differ in the last ulp and EM compounds that over its
updates). Within the port, each regime is held to the resident one with
the reference's own tolerances (tests/test_streaming_linker.py): the
pattern regime in float64 within rtol 1e-5 / atol 1e-7, the streamed-G
regime's lambda within 1e-5 and probabilities within rtol 1e-3 / atol 1e-5.
"""

import copy
import gc
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
from splink_tpu_torch import blocking, data  # noqa: E402
from splink_tpu_torch.ops.gamma import apply_null  # noqa: E402
from splink_tpu_torch.settings import complete_settings_dict  # noqa: E402

LETTERS = np.array(list("abcdefghijklmnopqrstuvwxyz"))


def _people(n, seed):
    """Names from pools, ~10% planted duplicates with a one-character typo
    sharing their source's block, ~2% nulls."""
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


def _settings(link_type="dedupe_only", **extra):
    s = {"link_type": link_type, "blocking_rules": ["l.blk = r.blk"], "max_iterations": 8,
         "comparison_columns": [
             {"col_name": "first_name", "num_levels": 3,
              "comparison": {"kind": "jaro_winkler", "thresholds": [0.94, 0.88]}},
             {"col_name": "surname", "num_levels": 3, "term_frequency_adjustments": True,
              "comparison": {"kind": "jaro_winkler", "thresholds": [0.94, 0.88]}},
             {"col_name": "city", "num_levels": 3,
              "comparison": {"kind": "levenshtein", "thresholds": [0.3]}},
             {"col_name": "dob", "data_type": "numeric", "num_levels": 2,
              "comparison": {"kind": "numeric_abs", "thresholds": [1.0]}}]}
    s.update(extra)
    return s


def _custom_first(ctx, col_settings):
    pc = ctx.col("first_name")
    return apply_null((pc.tok_l == pc.tok_r).to(torch.int8), pc.null)


def _ref_custom_first(ctx, col_settings):
    from splink_tpu.ops.gamma import apply_null as ref_apply_null

    pc = ctx.col("first_name")
    return ref_apply_null((pc.tok_l == pc.tok_r).astype(jnp.int8), pc.null)


splink_tpu_torch.register_comparison("streaming_first_exact", _custom_first)
splink_tpu.register_comparison("streaming_first_exact", _ref_custom_first)


def _custom(s):
    """A custom comparison: the settings cannot use patterns."""
    s["comparison_columns"][3] = {"custom_name": "first_exact",
                                  "custom_columns_used": ["first_name"], "num_levels": 2,
                                  "comparison": {"kind": "custom", "fn": "streaming_first_exact"}}
    return s


@pytest.fixture(scope="module")
def frame():
    return _people(1500, seed=5)


def _frames(df, link_type):
    if link_type == "dedupe_only":
        return {"df": df}
    return {"df_l": df.iloc[0::2], "df_r": df.iloc[1::2]}


def _both(s, frames, entry="get_scored_comparisons", **kwargs):
    """(reference linker, its result, port linker, its result)."""
    ref = splink_tpu.Splink(copy.deepcopy(s), **frames)
    got = splink_tpu_torch.Splink(copy.deepcopy(s), device="cpu", **frames)
    return ref, getattr(ref, entry)(**kwargs), got, getattr(got, entry)(**kwargs)


def _assert_row_order(have, want, atol=1e-5):
    assert list(have.columns) == list(want.columns)
    assert list(have.dtypes) == list(want.dtypes)
    assert len(have) == len(want)
    for c in want.columns:
        if want[c].dtype.kind == "f":
            np.testing.assert_allclose(have[c], want[c], rtol=0, atol=atol, err_msg=c)
        else:  # ids, gammas, retained values: equal, row for row
            assert have[c].reset_index(drop=True).equals(want[c].reset_index(drop=True)), c


# id: (settings changes, link type, the port's regime)
REGIMES = {
    "virtual": ({"max_resident_pairs": 1024}, "dedupe_only", "virtual"),
    "virtual_link_only": ({"max_resident_pairs": 1024}, "link_only", "virtual"),
    "virtual_link_and_dedupe": ({"max_resident_pairs": 1024}, "link_and_dedupe", "virtual"),
    "virtual_on_small_job": ({"device_pair_generation": "on"}, "dedupe_only", "virtual"),
    "materialised": ({"max_resident_pairs": 1024, "device_pair_generation": "off"},
                     "dedupe_only", "materialised"),
    "materialised_sequential": ({"max_resident_pairs": 1024, "device_pair_generation": "off",
                                 "overlap_blocking": False}, "dedupe_only", "materialised"),
    "intermediates": ({"max_resident_pairs": 1024,
                       "retain_intermediate_calculation_columns": True},
                      "dedupe_only", "virtual"),
    "streamed_g": (_custom, "dedupe_only", "streamed"),
}


@pytest.mark.parametrize("regime", list(REGIMES))
def test_regime_frames_follow_reference_in_row_order(frame, regime):
    change, link_type, kind = REGIMES[regime]
    s = _settings(link_type)
    s = change(s) if callable(change) else {**s, **change}
    if kind == "streamed":
        s.update(max_resident_pairs=1024, pair_batch_size=4096)
    ref, want, got, have = _both(s, _frames(frame, link_type))
    assert got.device_pair_generation_active is (kind == "virtual")
    assert got._use_pattern_pipeline() is (kind != "streamed")
    if kind == "materialised":
        assert got._P is not None and got._pairs.n_pairs > 1024
    if kind == "streamed":
        assert got.stage_seconds.get("em_streamed") is not None
    assert len(have) > 10_000
    _assert_row_order(have, want)
    assert len(got.params.param_history) == len(ref.params.param_history)
    if kind != "streamed":
        np.testing.assert_array_equal(got._pattern_counts, ref._pattern_counts)


def test_pattern_regime_matches_resident_float64(frame):
    """The pattern regime scores like the resident regime (float64: the
    pattern-EM == pair-EM identity is exact up to summation order)."""
    base = _settings(float64=True, retain_intermediate_calculation_columns=True,
                     max_iterations=6)
    resident = splink_tpu_torch.Splink(copy.deepcopy(base), df=frame, device="cpu")
    df_res = resident.get_scored_comparisons()
    assert not resident._use_pattern_pipeline()
    for dpg in ("on", "off"):
        patterned = splink_tpu_torch.Splink(
            {**copy.deepcopy(base), "max_resident_pairs": 1024, "device_pair_generation": dpg},
            df=frame, device="cpu")
        df_pat = patterned.get_scored_comparisons()
        assert patterned._use_pattern_pipeline()
        pd.testing.assert_frame_equal(df_res, df_pat, check_exact=False, rtol=1e-5, atol=1e-7)
        np.testing.assert_allclose(resident.params.params["λ"], patterned.params.params["λ"],
                                   rtol=1e-6)


def test_streamed_g_regime_matches_resident(frame):
    s = _custom(_settings())
    resident = splink_tpu_torch.Splink(copy.deepcopy(s), df=frame, device="cpu")
    df_res = resident.get_scored_comparisons()
    streamed = splink_tpu_torch.Splink({**copy.deepcopy(s), "max_resident_pairs": 1024,
                                        "pair_batch_size": 4096}, df=frame, device="cpu")
    df_str = streamed.get_scored_comparisons()
    assert not streamed._use_pattern_pipeline() and streamed._G_dev is None
    assert abs(resident.params.params["λ"] - streamed.params.params["λ"]) < 1e-5
    assert list(df_res["unique_id_l"]) == list(df_str["unique_id_l"])
    np.testing.assert_allclose(df_res["match_probability"], df_str["match_probability"],
                               rtol=1e-3, atol=1e-5)


@pytest.mark.parametrize("regime", ["virtual", "materialised", "resident", "streamed_g"])
def test_stream_scored_comparisons_chunks(frame, regime):
    """stream_scored_comparisons yields the reference's chunks, chunk for
    chunk in row order (pair_batch_size 4096), and they concatenate to
    get_scored_comparisons' frame."""
    s = _settings(pair_batch_size=4096, max_iterations=5)
    if regime == "virtual":
        s["max_resident_pairs"] = 1024
    elif regime == "materialised":
        s.update(max_resident_pairs=1024, device_pair_generation="off")
    elif regime == "streamed_g":
        # float64: over this frame's ~40 batches a pass the two packages'
        # float32 streamed sums drift apart by up to 2e-5 relative
        s = _custom(s)
        s.update(max_resident_pairs=1024, float64=True)
    ref = splink_tpu.Splink(copy.deepcopy(s), df=frame)
    got = splink_tpu_torch.Splink(copy.deepcopy(s), df=frame, device="cpu")
    want_chunks = list(ref.stream_scored_comparisons())
    have_chunks = list(got.stream_scored_comparisons())
    assert len(have_chunks) == len(want_chunks) > 2
    for h, w in zip(have_chunks, want_chunks):
        assert len(h) <= 4096
        _assert_row_order(h, w)
    whole = splink_tpu_torch.Splink(copy.deepcopy(s), df=frame,
                                    device="cpu").get_scored_comparisons()
    pd.testing.assert_frame_equal(pd.concat(have_chunks, ignore_index=True), whole)
    # a trained model streams again without EM, the same chunks
    again = list(got.stream_scored_comparisons_after_em())
    pd.testing.assert_frame_equal(pd.concat(again, ignore_index=True), whole)


@pytest.mark.parametrize("regime", ["virtual", "resident"])
def test_stream_tf_adjusted_comparisons(frame, regime):
    """The streaming TF adjustment follows the reference chunk for chunk (in
    the resident regime: one frame, make_term_frequency_adjustments')."""
    s = _settings(pair_batch_size=8192, max_iterations=5)
    if regime == "virtual":
        s["max_resident_pairs"] = 1024
    ref = splink_tpu.Splink(copy.deepcopy(s), df=frame)
    got = splink_tpu_torch.Splink(copy.deepcopy(s), df=frame, device="cpu")
    want = list(ref.stream_tf_adjusted_comparisons())
    have = list(got.stream_tf_adjusted_comparisons())
    assert len(have) == len(want) >= (2 if regime == "virtual" else 1)
    for h, w in zip(have, want):
        assert list(h.columns[:3]) == ["tf_adjusted_match_prob", "match_probability",
                                       "tf_match_probability"]
        _assert_row_order(h, w)
    assert got._P_virtual is None  # released with the stream


@pytest.mark.parametrize("regime", ["virtual", "materialised", "streamed_g"])
def test_estimate_parameters_train_only(frame, regime):
    """Train only: the same fitted parameters as the reference (1e-5) and
    as the port's get_scored_comparisons (bit for bit); under device pair
    generation no pair index and no per-candidate ids are kept."""
    s = _settings(max_resident_pairs=1024)
    if regime == "materialised":
        s["device_pair_generation"] = "off"
    elif regime == "streamed_g":
        s = _custom(s)
    ref = splink_tpu.Splink(copy.deepcopy(s), df=frame)
    ref.estimate_parameters()
    got = splink_tpu_torch.Splink(copy.deepcopy(s), df=frame, device="cpu")
    params = got.estimate_parameters()
    assert params is got.params
    for a, b in zip(ref.params.to_arrays()[:3], got.params.to_arrays()[:3]):
        np.testing.assert_allclose(b, a, rtol=0, atol=1e-5)
    full = splink_tpu_torch.Splink(copy.deepcopy(s), df=frame, device="cpu")
    full.get_scored_comparisons()
    assert got.params.params == full.params.params
    if regime == "virtual":
        assert got._pairs is None and got._P_virtual is None
        assert got.stage_seconds.keys() >= {"encode", "pairgen_plan", "gammas_patterns", "em"}


@pytest.mark.parametrize("weighted", [False, True])
def test_run_em_streamed_and_score_stream_follow_reference(weighted):
    """parallel/streaming.py against the reference's, in float64, over the
    same re-iterable batches (and weights): the same number of updates, the
    histories and the streamed scores within 1e-12 relative (XLA's and
    PyTorch's float64 log differ in the last ulp for a few inputs)."""
    from splink_tpu.models.fellegi_sunter import FSParams as RefFSParams
    from splink_tpu.parallel.streaming import run_em_streamed as ref_streamed
    from splink_tpu.parallel.streaming import score_stream as ref_score_stream

    from splink_tpu_torch.models.fellegi_sunter import FSParams
    from splink_tpu_torch.parallel import run_em_streamed, score_stream

    rng = np.random.default_rng(8)
    G = rng.integers(-1, 3, size=(5000, 3)).astype(np.int8)
    w = rng.integers(1, 4, 5000).astype(np.float64)
    lam, m = 0.2, np.array([[0.1, 0.2, 0.7], [0.2, 0.3, 0.5], [0.1, 0.1, 0.8]])
    u = m[:, ::-1].copy()

    def batches():
        for s in range(0, len(G), 700):
            yield (G[s : s + 700], w[s : s + 700]) if weighted else G[s : s + 700]

    kw = dict(max_iterations=6, max_levels=3, em_convergence=1e-10, compute_ll=True)
    got = run_em_streamed(batches, FSParams(*(torch.tensor(np.asarray(a)) for a in (lam, m, u))),
                          **kw)
    ref_init = RefFSParams(*(jnp.asarray(np.asarray(a)) for a in (lam, m, u)))
    want = ref_streamed(batches, ref_init, **kw)
    assert got[2] == want[2] and got[3] == want[3]
    for k in ("lam", "m", "u", "ll"):
        np.testing.assert_allclose(got[1][k], np.asarray(want[1][k]), rtol=1e-12, err_msg=k)
    for have, ref in zip(score_stream(batches(), got[0]), ref_score_stream(batches(), want[0])):
        np.testing.assert_allclose(have, np.asarray(ref), rtol=1e-12)


@pytest.mark.parametrize("dpg", ["on", "off"])
def test_zero_candidate_pairs_return_empty_frame(dpg):
    """Unique keys: no candidate pair. EM leaves the parameters as they
    are, and the frame is empty with the reference's columns and dtypes."""
    df = pd.DataFrame({"unique_id": range(8), "name": [f"u{k}" for k in range(8)],
                       "key": [f"k{k}" for k in range(8)]})
    s = {"link_type": "dedupe_only", "blocking_rules": ["l.key = r.key"], "max_iterations": 3,
         "comparison_columns": [{"col_name": "name", "num_levels": 2,
                                 "term_frequency_adjustments": True}],
         "device_pair_generation": dpg, "max_resident_pairs": 1024}
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        ref, want, got, have = _both(s, {"df": df})
        inf = splink_tpu_torch.Splink({**copy.deepcopy(s), "max_iterations": 0}, df=df,
                                      device="cpu").manually_apply_fellegi_sunter_weights()
    assert len(have) == len(want) == len(inf) == 0
    assert list(have.columns) == list(want.columns) == list(inf.columns)
    assert list(have.dtypes) == list(want.dtypes)
    assert got.params.params == ref.params.params


def test_spill_dir_linker_memmaps_and_release_input(tmp_path, frame):
    """spill_dir: the pair index is memmapped under it; the pattern regime
    over spilled pairs after release_input() gives the unspilled frame bit
    for bit; dropping the index reclaims the directory."""
    s = _settings(max_resident_pairs=1024, device_pair_generation="off")
    plain = splink_tpu_torch.Splink(copy.deepcopy(s), df=frame,
                                    device="cpu").get_scored_comparisons()
    linker = splink_tpu_torch.Splink({**copy.deepcopy(s), "spill_dir": str(tmp_path)},
                                     df=frame, device="cpu")
    linker.release_input()
    assert linker.df is None
    spilled = pd.concat(list(linker.stream_scored_comparisons()), ignore_index=True)
    pairs = linker._pairs
    assert isinstance(pairs.idx_l, np.memmap) and pairs.spill_tmp.startswith(str(tmp_path))
    pd.testing.assert_frame_equal(spilled, plain)
    spill = pairs.spill_tmp
    del linker, pairs
    gc.collect()
    assert not os.path.exists(spill)


def test_stale_spill_dirs_swept(tmp_path):
    """A dir whose owner pid is dead, or whose pid was recycled by another
    process (start time differs), is reclaimed; a live owner's and a dir
    with no pid file stay."""
    dead = tmp_path / "splink_pairs_dead"
    dead.mkdir()
    (dead / "owner.pid").write_text("999999999")  # no such pid
    alive = tmp_path / "splink_pairs_alive"
    alive.mkdir()
    (alive / "owner.pid").write_text(blocking._owner_token(os.getppid()))
    recycled = tmp_path / "splink_pairs_recycled"
    recycled.mkdir()
    start = blocking._proc_start_time(os.getppid())
    (recycled / "owner.pid").write_text(f"{os.getppid()} {start + 1}")
    foreign = tmp_path / "splink_pairs_nopid"
    foreign.mkdir()
    blocking._sweep_stale_spill_dirs(str(tmp_path))
    assert not dead.exists() and not recycled.exists()
    assert alive.exists() and foreign.exists()


def test_blocking_failure_reclaims_partial_spill(tmp_path, frame):
    """An error after the first rule has streamed pairs to disk closes the
    files and removes the partial directory (its owner is alive, so the
    sweep would rightly leave it)."""
    s = complete_settings_dict(_settings(spill_dir=str(tmp_path)))
    table = data.encode_table(frame, s)
    s["blocking_rules"] = ["l.blk = r.blk", "l.nonexistent = r.nonexistent"]
    with pytest.raises(KeyError):
        blocking.block_using_rules(s, table)
    assert [d for d in os.listdir(tmp_path) if d.startswith("splink_pairs_")] == []


@pytest.mark.parametrize("link_type", ["dedupe_only", "link_only", "link_and_dedupe"])
def test_cartesian_spill_chunks_match_resident(tmp_path, monkeypatch, link_type):
    """The cartesian fallback spills in chunks (7 pairs each here) that
    give exactly the in-RAM pair set, in order, and the consumer sees every
    chunk."""
    monkeypatch.setattr(blocking, "_CARTESIAN_CHUNK", 7)
    df = _people(40, 3)
    frames = _frames(df, link_type)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        s = complete_settings_dict(_settings(link_type, blocking_rules=[]))
    if link_type == "dedupe_only":
        table, n_left = data.encode_table(df, s), None
    else:
        table, n_left = data.concat_tables(frames["df_l"], frames["df_r"], s), len(frames["df_l"])
    want = blocking.block_using_rules(s, table, n_left)
    fed = []
    got = blocking.block_using_rules({**s, "spill_dir": str(tmp_path)}, table, n_left,
                                     pair_consumer=lambda i, j: fed.append(len(i)))
    assert isinstance(got.idx_l, np.memmap) and len(fed) > 3
    np.testing.assert_array_equal(got.idx_l, want.idx_l)
    np.testing.assert_array_equal(got.idx_r, want.idx_r)
    assert sum(fed) == want.n_pairs
    got.release()
