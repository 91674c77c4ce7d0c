"""End-to-end parity of splink_tpu_torch's linker with splink_tpu's, on CPU.

The same seeded frame goes through ``splink_tpu.Splink`` (the JAX
reference) and ``splink_tpu_torch.Splink(device="cpu")``: pair sets and
gamma columns must be equal, match probabilities within 1e-5 (XLA's and
PyTorch's log/sigmoid differ in the last ulp, and EM compounds that over its
updates), and the number of EM updates equal. Model JSON files must load in
either package. The isolation tests pin the port's import boundary and its
device rule.
"""

import ast
import copy
import os
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# tier-1 runs several pytest workers on the cores; one intra-op thread each
# keeps them from oversubscribing the CPU
torch.set_num_threads(1)
pd = pytest.importorskip("pandas")

import splink_tpu  # noqa: E402
import splink_tpu_torch  # noqa: E402

PKG_DIR = os.path.dirname(splink_tpu_torch.__file__)
ROOT = os.path.dirname(PKG_DIR)

LETTERS = np.array(list("abcdefghijklmnopqrstuvwxyz"))


def _pool(rng, k, lo, hi):
    return np.array(
        ["".join(rng.choice(LETTERS, rng.integers(lo, hi + 1))) for _ in range(k)],
        dtype=object,
    )


def _typo(rng, s):
    i = int(rng.integers(0, len(s)))
    c = str(rng.choice(LETTERS))
    op = rng.integers(0, 3)
    if op == 0:
        return s[:i] + c + s[i + 1:]
    if op == 1:
        return s[:i] + c + s[i:]
    return s[:i] + s[i + 1:] if len(s) > 1 else s + c


def people(n, seed):
    """Seeded people frame: names from pools, ~10% planted duplicates with
    a one-character typo sharing their source's block, ~2% nulls."""
    rng = np.random.default_rng(seed)
    n_dup = n // 10
    n_base = n - n_dup
    cols = {
        "first_name": _pool(rng, max(n // 8, 20), 4, 10),
        "surname": _pool(rng, max(n // 3, 20), 4, 10),
        "city": _pool(rng, max(n // 20, 10), 5, 12),
        "postcode": _pool(rng, max(n // 2, 20), 6, 6),
    }
    df = {k: v[rng.integers(0, len(v), n_base)] for k, v in cols.items()}
    df["dob"] = rng.integers(0, 3000, n_base).astype(np.float64)
    df["blk"] = rng.integers(0, max(n // 32, 1), n_base)
    src = rng.integers(0, n_base, n_dup)
    for k in df:
        df[k] = np.concatenate([df[k], df[k][src]])
    for r in range(n_base, n):
        k = ("first_name", "surname", "city")[rng.integers(0, 3)]
        df[k][r] = _typo(rng, df[k][r])
    for k in ("first_name", "surname", "city", "postcode", "dob"):
        null = rng.random(n) < 0.02
        df[k] = df[k].astype(object)
        df[k][null] = None
    df["unique_id"] = np.arange(n)
    df["dup_of"] = np.concatenate([np.full(n_base, -1), src])
    return pd.DataFrame(df)


def settings(link_type="dedupe_only", **extra):
    s = {
        "link_type": link_type,
        "blocking_rules": ["l.blk = r.blk"],
        "comparison_columns": [
            {"col_name": "first_name", "num_levels": 3,
             "comparison": {"kind": "jaro_winkler", "thresholds": [0.94, 0.88]}},
            {"col_name": "surname", "num_levels": 3,
             "comparison": {"kind": "jaro_winkler", "thresholds": [0.94, 0.88]}},
            {"col_name": "city", "num_levels": 3,
             "comparison": {"kind": "levenshtein", "thresholds": [0.3]}},
            {"col_name": "dob", "data_type": "numeric", "num_levels": 2,
             "comparison": {"kind": "numeric_abs", "thresholds": [1.0]}},
            {"col_name": "postcode", "num_levels": 2,
             "comparison": {"kind": "exact"}},
        ],
    }
    s.update(extra)
    return s


def _by_pair(df):
    return df.sort_values(["unique_id_l", "unique_id_r"]).reset_index(drop=True)


def _assert_frames_match(ref, got):
    ref, got = _by_pair(ref), _by_pair(got)
    assert set(ref.columns) == set(got.columns)
    np.testing.assert_array_equal(got["unique_id_l"], ref["unique_id_l"])
    np.testing.assert_array_equal(got["unique_id_r"], ref["unique_id_r"])
    for c in ref.columns:
        if c.startswith("gamma_"):
            np.testing.assert_array_equal(got[c].to_numpy(), ref[c].to_numpy(), c)
    np.testing.assert_allclose(
        got["match_probability"], ref["match_probability"], rtol=0, atol=1e-5
    )


@pytest.fixture(scope="module")
def dedupe_df():
    return people(2000, seed=11)


@pytest.mark.parametrize("float64", [False, True])
def test_dedupe_parity(dedupe_df, float64):
    s = settings(float64=float64)
    ref = splink_tpu.Splink(copy.deepcopy(s), df=dedupe_df)
    got = splink_tpu_torch.Splink(copy.deepcopy(s), df=dedupe_df, device="cpu")
    df_ref = ref.get_scored_comparisons()
    df_got = got.get_scored_comparisons()
    assert len(df_got) > 30_000
    _assert_frames_match(df_ref, df_got)
    assert len(got.params.param_history) == len(ref.params.param_history)
    if float64:
        assert df_got["match_probability"].dtype == np.float64


def test_link_only_parity():
    df = people(2000, seed=21)
    # alternate rows: planted duplicates and their sources fall on either side
    df_l, df_r = df.iloc[0::2], df.iloc[1::2]
    s = settings("link_only")
    ref = splink_tpu.Splink(copy.deepcopy(s), df_l=df_l, df_r=df_r)
    got = splink_tpu_torch.Splink(
        copy.deepcopy(s), df_l=df_l, df_r=df_r, device="cpu"
    )
    _assert_frames_match(ref.get_scored_comparisons(), got.get_scored_comparisons())
    assert len(got.params.param_history) == len(ref.params.param_history)


def test_planted_duplicates_score_high(dedupe_df):
    got = splink_tpu_torch.Splink(settings(), df=dedupe_df, device="cpu")
    df = got.get_scored_comparisons()
    dup_of = dedupe_df["dup_of"].to_numpy()
    planted = dup_of[df["unique_id_r"].to_numpy()] == df["unique_id_l"].to_numpy()
    p = df["match_probability"].to_numpy()
    assert planted.sum() > 50
    assert np.median(p[planted]) > 0.9
    assert np.median(p[planted]) > np.quantile(p[~planted], 0.99)


@pytest.mark.parametrize("direction", ["jax_to_torch", "torch_to_jax"])
def test_model_json_roundtrip_between_packages(tmp_path, dedupe_df, direction):
    path = str(tmp_path / "model.json")
    s = settings()
    if direction == "jax_to_torch":
        src = splink_tpu.Splink(copy.deepcopy(s), df=dedupe_df)
        want = src.get_scored_comparisons()
        src.save_model_as_json(path)
        dst = splink_tpu_torch.load_from_json(path, df=dedupe_df, device="cpu")
    else:
        src = splink_tpu_torch.Splink(copy.deepcopy(s), df=dedupe_df, device="cpu")
        want = src.get_scored_comparisons()
        src.save_model_as_json(path)
        dst = splink_tpu.load_from_json(path, df=dedupe_df)
    assert dst.params.params == src.params.params
    assert dst.params.param_history == src.params.param_history
    _assert_frames_match(want, dst.manually_apply_fellegi_sunter_weights())


def test_roundtrip_within_port_is_bit_identical(tmp_path, dedupe_df):
    path = str(tmp_path / "model.json")
    src = splink_tpu_torch.Splink(settings(), df=dedupe_df, device="cpu")
    want = src.get_scored_comparisons()
    src.save_model_as_json(path)
    again = splink_tpu_torch.load_from_json(path, df=dedupe_df, device="cpu")
    got = again.manually_apply_fellegi_sunter_weights()
    np.testing.assert_array_equal(
        got["match_probability"].to_numpy(), want["match_probability"].to_numpy()
    )


def _lev2(s):
    s["comparison_columns"][2] = {
        "col_name": "city", "num_levels": 4,
        "comparison": {"kind": "levenshtein", "thresholds": [0.2, 0.4]}}
    return s


def _perc(s):
    s["comparison_columns"][3] = {
        "col_name": "dob", "data_type": "numeric", "num_levels": 3,
        "comparison": {"kind": "numeric_perc", "thresholds": [0.0001, 0.05]}}
    return s


def _inversion(s):
    s["comparison_columns"].append({
        "custom_name": "inv", "custom_columns_used": ["first_name", "surname"],
        "num_levels": 4,
        "comparison": {"kind": "name_inversion", "column": "first_name",
                       "other_columns": ["surname"], "thresholds": [0.94, 0.88]}})
    return s


def _set_m_u(s):
    rng = np.random.default_rng(3)
    for col in s["comparison_columns"]:
        m, u = rng.random(col["num_levels"]), rng.random(col["num_levels"])
        col["m_probabilities"] = (m / m.sum()).tolist()
        col["u_probabilities"] = (u / u.sum()).tolist()
    return s


# id: (settings changes, entry point, keyword arguments, link type)
PATHS = {
    "link_and_dedupe": (None, "get_scored_comparisons", {}, "link_and_dedupe"),
    "retain_intermediate_calculation_columns": (
        {"retain_intermediate_calculation_columns": True}, "get_scored_comparisons", {}, None),
    "additional_columns_to_retain": (
        {"additional_columns_to_retain": ["blk", "dup_of"]}, "get_scored_comparisons", {}, None),
    "retain_matching_columns_false": (
        {"retain_matching_columns": False}, "get_scored_comparisons", {}, None),
    "manual_m_u": (_set_m_u, "manually_apply_fellegi_sunter_weights", {}, None),
    "save_state_fn": ({"max_iterations": 4}, "get_scored_comparisons", {}, None),
    "compute_ll": (None, "get_scored_comparisons", {"compute_ll": True}, None),
    "two_phase_jw_off": ({"two_phase_jw": "off"}, "get_scored_comparisons", {}, None),
    "max_iterations_0": ({"max_iterations": 0}, "get_scored_comparisons", {}, None),
    "levenshtein_2_thresholds": (_lev2, "get_scored_comparisons", {}, None),
    "numeric_perc": (_perc, "get_scored_comparisons", {}, None),
    "name_inversion": (_inversion, "get_scored_comparisons", {}, None),
    "non_ascii": (None, "get_scored_comparisons", {}, None),
}


@pytest.mark.parametrize("path", list(PATHS))
def test_path_parity_in_row_order(path):
    """Paths that the other tests do not pin end to end: both packages on
    the same frame give the same columns in the same order with the same
    dtypes, the same pairs in the same row order, equal gamma columns, and
    probabilities within 1e-5."""
    change, entry, kwargs, link_type = PATHS[path]
    s = settings(link_type or "dedupe_only")
    s = change(s) if callable(change) else {**s, **(change or {})}
    df = people(1500, seed=5)
    if path == "non_ascii":  # 32-bit codepoint columns
        df["first_name"] = df["first_name"].str.replace("a", "\u00e4").str.replace("e", "\u4e00")
        df["city"] = df["city"].str.replace("o", "\u00f8")
    frames = ({"df_l": df.iloc[0::2], "df_r": df.iloc[1::2]} if link_type else {"df": df})
    lams = {}
    out = {}
    for pkg, kw in ((splink_tpu, {}), (splink_tpu_torch, {"device": "cpu"})):
        seen = lams.setdefault(pkg.__name__, [])
        save = (lambda params, _s, seen=seen: seen.append(params.params["λ"])) \
            if path == "save_state_fn" else None
        linker = pkg.Splink(copy.deepcopy(s), **frames, save_state_fn=save, **kw)
        out[pkg.__name__] = (linker, getattr(linker, entry)(**kwargs))
    (ref, want), (got, have) = out["splink_tpu"], out["splink_tpu_torch"]
    assert len(have) > 10_000
    assert list(have.columns) == list(want.columns)
    assert list(have.dtypes) == list(want.dtypes)
    for c in want.columns:
        if want[c].dtype.kind == "f":
            np.testing.assert_allclose(have[c], want[c], rtol=0, atol=1e-5, err_msg=c)
        else:  # ids, gammas, retained values: equal, row for row
            assert have[c].equals(want[c]), c
    assert len(got.params.param_history) == len(ref.params.param_history)
    if path == "save_state_fn":
        assert len(lams["splink_tpu_torch"]) == len(lams["splink_tpu"]) > 1
        np.testing.assert_allclose(lams["splink_tpu_torch"], lams["splink_tpu"], atol=1e-5)
    if path == "compute_ll":
        assert got.params.log_likelihood_exists
        assert got.params.params["log_likelihood"] == pytest.approx(
            ref.params.params["log_likelihood"], rel=1e-6)


def test_no_candidate_pairs_parity():
    """A rule that pairs no rows: EM runs on the empty gamma matrix and the
    frame is empty with the reference's columns and dtypes (with a
    term-frequency column, its fold column too)."""
    s = settings(blocking_rules=["l.postcode = r.postcode AND l.first_name = r.surname"])
    s["comparison_columns"][0]["term_frequency_adjustments"] = True
    df = people(200, seed=1)
    ref = splink_tpu.Splink(copy.deepcopy(s), df=df)
    got = splink_tpu_torch.Splink(copy.deepcopy(s), df=df, device="cpu")
    want, have = ref.get_scored_comparisons(), got.get_scored_comparisons()
    assert len(have) == len(want) == 0
    assert list(have.columns) == list(want.columns)
    assert list(have.dtypes) == list(want.dtypes)
    assert "tf_match_probability" in have.columns
    assert got.params.params == ref.params.params
    adj = got.make_term_frequency_adjustments(have)
    assert list(adj.columns) == list(ref.make_term_frequency_adjustments(want).columns)


# ----------------------------------------------------------------------
# Isolation and the device rule
# ----------------------------------------------------------------------


def test_import_leaves_jax_and_reference_unloaded():
    code = (
        "import sys, splink_tpu_torch, splink_tpu_torch.linker, "
        "splink_tpu_torch.ops.strings_cuda, splink_tpu_torch.native, "
        "splink_tpu_torch.term_frequencies, splink_tpu_torch.intuition\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.') "
        "or m == 'splink_tpu' or m.startswith('splink_tpu.')]\n"
        "assert not bad, bad\n"
    )
    subprocess.run([sys.executable, "-c", code], cwd=ROOT, check=True)


def _package_sources():
    for dirpath, _, files in os.walk(PKG_DIR):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(dirpath, f)


def test_no_jax_or_reference_import_in_package():
    found = []
    for path in _package_sources():
        with open(path) as fh:
            tree = ast.parse(fh.read())
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module or ""]
            else:
                continue
            for name in names:
                root = name.split(".")[0]
                if root in ("jax", "jaxlib", "splink_tpu"):
                    found.append((os.path.relpath(path, ROOT), name))
    assert not found, found


def test_default_device_raises_without_cuda(monkeypatch, dedupe_df):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        splink_tpu_torch.Splink(settings(), df=dedupe_df)


@pytest.mark.parametrize("entry", ["fsparams_from_numpy", "GammaProgram"])
def test_entry_point_default_device_raises_without_cuda(monkeypatch, dedupe_df, entry):
    """The carrier of the reference's parameters and the gamma program
    follow the linker's device rule: cuda unless asked for the CPU."""
    from splink_tpu_torch import data, gammas

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    if entry == "fsparams_from_numpy":
        call = lambda **kw: splink_tpu_torch.fsparams_from_numpy(  # noqa: E731
            0.5, [[0.1, 0.9]], [[0.8, 0.2]], **kw)
    else:
        s = splink_tpu_torch.complete_settings_dict(settings())
        table = data.encode_table(dedupe_df, s)
        call = lambda **kw: gammas.GammaProgram(s, table, **kw)  # noqa: E731
    with pytest.raises(RuntimeError, match="device='cpu'"):
        call()
    assert call(device="cpu") is not None


@pytest.mark.parametrize(
    "override",
    [
        {"mesh": {"data": 2}},
    ],
    ids=lambda o: next(iter(o)),
)
def test_unported_settings_raise(dedupe_df, override):
    s = settings()
    s.update(override)
    with pytest.raises(NotImplementedError, match="ROADMAP.md"):
        splink_tpu_torch.Splink(s, df=dedupe_df, device="cpu").get_scored_comparisons()


@pytest.mark.parametrize(
    "override",
    [
        {"spill_dir": "spill"},
        {"checkpoint_dir": "ckpt"},
        {"device_pair_generation": "on"},
        {"max_resident_pairs": 1024},
        {"device_blocking": "on"},
        {"build_spill_dir": "spill"},
    ],
    ids=lambda o: next(iter(o)),
)
def test_formerly_unported_regime_settings_follow_reference(tmp_path, dedupe_df, override):
    """The settings that raised NotImplementedError before the regimes, the
    device sort-join tier and the durable pair store were ported
    (test_unported_settings_raise listed them): both packages now give the
    same frame, in row order with dtypes — ids and gammas equal,
    probabilities within 1e-5 (the tolerance of the other path tests)."""
    override = {k: str(tmp_path / v) if k.endswith("_dir") else v for k, v in override.items()}
    s = settings(max_iterations=6)
    s.update(override)
    want = splink_tpu.Splink(copy.deepcopy(s), df=dedupe_df).get_scored_comparisons()
    have = splink_tpu_torch.Splink(copy.deepcopy(s), df=dedupe_df,
                                   device="cpu").get_scored_comparisons()
    assert len(have) == len(want) > 30_000
    assert list(have.columns) == list(want.columns)
    assert list(have.dtypes) == list(want.dtypes)
    for c in want.columns:
        if want[c].dtype.kind == "f":
            np.testing.assert_allclose(have[c], want[c], rtol=0, atol=1e-5, err_msg=c)
        else:
            assert have[c].equals(want[c]), c
