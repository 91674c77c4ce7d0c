"""Every comparison kind through splink_tpu_torch's linker, against splink_tpu.

The settings hold the kinds this package ported last: ``dmetaphone`` (3
levels), ``qgram_jaccard`` (q 2, 3 levels), ``qgram_cosine`` (q 3, 2
levels), ``numeric_abs`` and a hand-written 4-level ``case_expression``
that compat_sql cannot translate (Jaro-Winkler, Levenshtein on substrings
and a tokenised charset Jaccard: the general CASE compiler). The same
seeded frame goes through ``splink_tpu.Splink`` and
``splink_tpu_torch.Splink(device="cpu")`` (float64 programs are held at the
gamma level: here for the q-gram kinds, in tests/test_torch_case_compiler.py
for CASE, where splink_tpu's jitted program can differ from its own
functions at exact ties). Tolerances, as in
tests/test_torch_linker.py: ids, gamma columns and retained values equal,
row for row, with the same columns and dtypes; float columns within 1e-5
(EM compounds the last-ulp differences of XLA's and PyTorch's log); with
parameters whose logs agree in both, ``match_logit`` bit-identical and
``match_probability`` within 4 ulp (float32). The q-gram kinds' int8 gamma
matrix is bit-identical at 2 and 3 levels and the packed table lane for
lane the same. Model JSON with these kinds moves between the packages.
"""

import copy

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# tier-1 runs several pytest workers on the cores; one intra-op thread each
# keeps them from oversubscribing the CPU
torch.set_num_threads(1)
pd = pytest.importorskip("pandas")

import jax.numpy as jnp  # noqa: E402
from test_torch_linker import people  # noqa: E402

import splink_tpu  # noqa: E402
import splink_tpu_torch  # noqa: E402
from splink_tpu import data as ref_data  # noqa: E402
from splink_tpu import gammas as ref_gammas  # noqa: E402
from splink_tpu.models import fellegi_sunter as ref_fs  # noqa: E402
from splink_tpu.settings import complete_settings_dict as ref_complete  # noqa: E402
from splink_tpu_torch import data, gammas  # noqa: E402
from splink_tpu_torch.compat_sql import SqlTranslationError  # noqa: E402
from splink_tpu_torch.models import fellegi_sunter as fs  # noqa: E402
from splink_tpu_torch.settings import complete_settings_dict  # noqa: E402

CITY_CASE = """CASE WHEN city_l IS NULL OR city_r IS NULL THEN -1
WHEN city_l = city_r THEN 3
WHEN jaro_winkler_sim(city_l, city_r) > 0.92 THEN 2
WHEN levenshtein(substr(city_l,1,4), substr(city_r,1,4)) <= 1
  OR jaccard_sim(Q3gramTokeniser(city_l), Q3gramTokeniser(city_r)) > 0.6 THEN 1
ELSE 0 END"""


def kinds_settings(link_type="dedupe_only", **extra):
    s = {
        "link_type": link_type,
        "blocking_rules": ["l.blk = r.blk"],
        "comparison_columns": [
            {"col_name": "first_name", "num_levels": 3, "comparison": {"kind": "dmetaphone"}},
            {"col_name": "surname", "num_levels": 3,
             "comparison": {"kind": "qgram_jaccard", "q": 2, "thresholds": [0.7, 0.4]}},
            {"col_name": "postcode", "num_levels": 2,
             "comparison": {"kind": "qgram_cosine", "q": 3, "thresholds": [0.5]}},
            {"col_name": "dob", "data_type": "numeric", "num_levels": 2,
             "comparison": {"kind": "numeric_abs", "thresholds": [1.0]}},
            {"col_name": "city", "num_levels": 4, "case_expression": CITY_CASE},
        ],
    }
    s.update(extra)
    return s


def _phonetic_blocking(s):
    s["blocking_rules"] = ["dmetaphone(l.surname) = dmetaphone(r.surname)", "l.blk = r.blk"]
    return s


# id: (settings change, link type)
PATHS = {
    "dedupe": (None, None),
    "link_only": (None, "link_only"),
    "link_and_dedupe_intermediate_columns": (
        {"retain_intermediate_calculation_columns": True}, "link_and_dedupe"),
    "dmetaphone_blocking_rule": (_phonetic_blocking, None),
}


def _assert_gammas_match(ref, got):
    """The two linkers' gamma matrices are equal, except where splink_tpu's
    jitted program departs from its own CASE evaluator run outside jit (XLA
    divides by a constant as a multiply by its reciprocal inside jit; see
    tests/test_torch_case_compiler.py): there the port must equal the
    evaluator."""
    from splink_tpu import case_compiler as ref_cc

    bad_rows, bad_cols = np.nonzero(got._G != ref._G)
    for c in np.unique(bad_cols):
        col = ref.settings["comparison_columns"][c]
        assert col["comparison"]["kind"] == "case_sql", col
        rows = bad_rows[bad_cols == c]
        f64 = ref.settings.get("float64")
        prog = ref_gammas.GammaProgram(ref.settings, ref._table,
                                       float_dtype=jnp.float64 if f64 else jnp.float32)
        il = jnp.asarray(ref._pairs.idx_l[rows])
        ir = jnp.asarray(ref._pairs.idx_r[rows])
        ctx = ref_gammas.PairContext(prog._layout, prog._packed[il], prog._packed[ir])
        eager = np.asarray(ref_cc.compile_case_expression(
            col["comparison"]["expr"], col["num_levels"])(ctx))
        np.testing.assert_array_equal(got._G[rows, c], eager)
        assert (eager != ref._G[rows, c]).all()


@pytest.mark.parametrize("path", list(PATHS))
def test_kinds_path_parity_in_row_order(path):
    change, link_type = PATHS[path]
    s = kinds_settings(link_type or "dedupe_only")
    s = change(s) if callable(change) else {**s, **(change or {})}
    df = people(1200, seed=7)
    frames = ({"df_l": df.iloc[0::2], "df_r": df.iloc[1::2]} if link_type else {"df": df})
    ref = splink_tpu.Splink(copy.deepcopy(s), **frames)
    got = splink_tpu_torch.Splink(copy.deepcopy(s), **frames, device="cpu")
    want, have = ref.get_scored_comparisons(), got.get_scored_comparisons()
    assert got.settings["comparison_columns"][4]["comparison"]["kind"] == "case_sql"
    assert len(have) > 5_000
    assert list(have.columns) == list(want.columns)
    assert list(have.dtypes) == list(want.dtypes)
    _assert_gammas_match(ref, got)
    for c in want.columns:
        if want[c].dtype.kind == "f":
            np.testing.assert_allclose(have[c], want[c], rtol=0, atol=1e-5, err_msg=c)
        elif not c.startswith("gamma_"):  # ids, retained values: equal, row for row
            assert have[c].equals(want[c]), c
    np.testing.assert_array_equal(  # the frame's gamma columns are the matrix's
        have[[f"gamma_{col['col_name']}" for col in s["comparison_columns"]]].to_numpy(),
        got._G)
    for col in s["comparison_columns"]:  # every column reaches more than one level
        name = col["col_name"]
        assert len(np.unique(have[f"gamma_{name}"])) > 2, name
    assert len(got.params.param_history) == len(ref.params.param_history)


def _same_log(x):
    x = np.asarray(x, np.float32)
    return np.asarray(jnp.log(jnp.asarray(x))) == torch.log(torch.from_numpy(x)).numpy()


def _agreeing(rng, k):
    """k random probabilities whose float32 values, as settings completion
    normalises them, have logs (and logs of one minus them) that XLA and
    PyTorch compute alike."""
    from splink_tpu_torch.settings import normalise_prob_list

    for _ in range(1000):
        p = rng.random(k).tolist()
        v = np.array(normalise_prob_list(p) if k > 1 else p, np.float32)
        if _same_log(v).all() and _same_log(1 - v).all():
            return p
    raise AssertionError("no parameters with agreeing logs drawn")


def _log_agreeing_settings(rng):
    """Kinds settings with set parameters and no EM, their logs alike in
    XLA and PyTorch."""
    s = kinds_settings(max_iterations=0, proportion_of_matches=_agreeing(rng, 1)[0] * 0.3)
    for col in s["comparison_columns"]:
        col["m_probabilities"] = _agreeing(rng, col["num_levels"])
        col["u_probabilities"] = _agreeing(rng, col["num_levels"])
    return s


def test_kinds_logit_bit_identical_and_probability_within_4_ulp():
    """The kinds path's own gamma matrix, scored with the same parameters
    (logs that agree in XLA and PyTorch): match_logit bit-identical, the
    frame's match_probability within 4 ulp."""
    s = _log_agreeing_settings(np.random.default_rng(41))
    df = people(800, seed=9)
    ref = splink_tpu.Splink(copy.deepcopy(s), df=df)
    got = splink_tpu_torch.Splink(copy.deepcopy(s), df=df, device="cpu")
    want, have = ref.manually_apply_fellegi_sunter_weights(), got.manually_apply_fellegi_sunter_weights()
    np.testing.assert_array_equal(got._G, ref._G)
    lam = np.float32(ref.params.params["λ"])
    m = np.zeros((5, 4), np.float32)
    u = np.zeros((5, 4), np.float32)
    for c, col in enumerate(ref.settings["comparison_columns"]):
        m[c, : col["num_levels"]] = col["m_probabilities"]
        u[c, : col["num_levels"]] = col["u_probabilities"]
    ref_p = ref_fs.FSParams(jnp.asarray(lam), jnp.asarray(m), jnp.asarray(u))
    got_p = splink_tpu_torch.fsparams_from_numpy(lam, m, u, device="cpu")
    np.testing.assert_array_equal(
        fs.match_logit(torch.from_numpy(got._G), got_p).numpy(),
        np.asarray(ref_fs.match_logit(jnp.asarray(ref._G), ref_p)))
    a = have["match_probability"].to_numpy()
    b = want["match_probability"].to_numpy()
    assert a.dtype == b.dtype == np.float32
    ulps = np.abs(a.view(np.int32).astype(np.int64) - b.view(np.int32).astype(np.int64))
    assert ulps.max() <= 4


QGRAM_COLUMNS = [
    {"col_name": "surname", "num_levels": 3,
     "comparison": {"kind": "qgram_jaccard", "thresholds": [0.7, 0.4]}},
    {"custom_name": "surname_cos", "custom_columns_used": ["surname"], "num_levels": 2,
     "comparison": {"kind": "qgram_cosine", "column": "surname", "thresholds": [0.5]}},
    {"col_name": "postcode", "num_levels": 2,
     "comparison": {"kind": "qgram_jaccard", "q": 3, "thresholds": [0.3]}},
    {"custom_name": "postcode_cos", "custom_columns_used": ["postcode"], "num_levels": 3,
     "comparison": {"kind": "qgram_cosine", "column": "postcode", "q": 3,
                    "thresholds": [0.6, 0.2]}},
    {"col_name": "first_name", "num_levels": 3,
     "comparison": {"kind": "jaro_winkler", "thresholds": [0.94, 0.88]}},
    {"col_name": "city", "num_levels": 2,
     "comparison": {"kind": "qgram_cosine", "q": 4, "thresholds": [0.5]}},
]


def _qgram_settings():
    return {"link_type": "dedupe_only", "blocking_rules": [],
            "comparison_columns": copy.deepcopy(QGRAM_COLUMNS)}


@pytest.fixture(scope="module")
def qgram_frame():
    df = people(400, seed=13)
    df["city"] = df["city"].str.replace("a", "ä")  # a wide-unicode column
    return df


def test_qgram_pack_table_lane_identical(qgram_frame):
    s = complete_settings_dict(_qgram_settings())
    s_ref = ref_complete(_qgram_settings())
    specs = gammas.qgram_specs_for(s)
    assert specs == ref_gammas.qgram_specs_for(s_ref)
    assert specs == (("surname", 2, True, True), ("postcode", 3, True, True),
                     ("city", 4, False, True))
    kw = dict(include=gammas.comparison_columns_used(s), qgram_specs=specs,
              jw_specs=gammas.jw_specs_for(s))
    got, layout = gammas.pack_table(data.encode_table(qgram_frame, s), **kw)
    want, ref_layout = ref_gammas.pack_table(ref_data.encode_table(qgram_frame, s_ref), **kw)
    assert got.dtype == want.dtype and np.array_equal(got, want)
    assert list(layout) == list(ref_layout)
    for k, f in ref_layout.items():
        assert {a: getattr(layout[k], a) for a in f.__slots__} == \
            {a: getattr(f, a) for a in f.__slots__}, k


@pytest.mark.parametrize("two_phase,float64", [("on", False), ("off", False), ("on", True)],
                         ids=["two_phase", "exact_jw", "float64"])
def test_qgram_gamma_matrix_bit_identical(qgram_frame, two_phase, float64):
    extra = {"two_phase_jw": two_phase, "float64": float64}
    s = complete_settings_dict({**_qgram_settings(), **extra})
    s_ref = ref_complete({**_qgram_settings(), **extra})
    rng = np.random.default_rng(17)
    il, ir = rng.integers(0, len(qgram_frame), 4000), rng.integers(0, len(qgram_frame), 4000)
    ir[:400] = il[:400]  # self pairs: similarity 1
    want = ref_gammas.GammaProgram(
        s_ref, ref_data.encode_table(qgram_frame, s_ref),
        float_dtype=jnp.float64 if float64 else jnp.float32).compute(il, ir, batch_size=1024)
    prog = gammas.GammaProgram(s, data.encode_table(qgram_frame, s), device="cpu",
                               float_dtype=torch.float64 if float64 else torch.float32)
    assert gammas._qgram_key("surname", 2) in prog._layout  # the masked forms engaged
    got = prog.compute(il, ir, batch_size=1024)
    assert got.dtype == want.dtype == np.int8
    np.testing.assert_array_equal(got, want)
    for c, col in enumerate(QGRAM_COLUMNS):
        assert set(np.unique(got[:, c])) == set(range(-1, col["num_levels"])), c


def test_unknown_kind_raises_value_error_as_reference():
    s = kinds_settings()
    s["comparison_columns"][0]["comparison"] = {"kind": "soundex"}
    df = people(200, seed=1)
    with pytest.raises(ValueError, match="soundex") as want:
        splink_tpu.Splink(copy.deepcopy(s), df=df).get_scored_comparisons()
    with pytest.raises(ValueError, match="soundex") as got:
        splink_tpu_torch.Splink(copy.deepcopy(s), df=df, device="cpu").get_scored_comparisons()
    assert type(got.value) is type(want.value)


@pytest.mark.parametrize("override", [
    {"kind": "qgram_jaccard"}, {"kind": "dmetaphone"},
    {"case": "CASE WHEN foo(first_name_l) > 1 THEN 1 ELSE 0 END"}],
    ids=["qgram_jaccard", "dmetaphone", "unsupported_case_function"])
def test_formerly_unported_kinds_follow_reference(override):
    """The settings that raised NotImplementedError before these kinds were
    ported: both packages now give the same frame, or the same error."""
    s = kinds_settings()
    col = s["comparison_columns"][0]
    col["num_levels"] = 2
    if "kind" in override:
        col["comparison"] = {"kind": override["kind"]}
    else:
        del col["comparison"]
        col["case_expression"] = override["case"]
        with pytest.raises(SqlTranslationError, match="Unsupported function 'foo'"):
            complete_settings_dict(copy.deepcopy(s))
        with pytest.raises(Exception, match="Unsupported function 'foo'"):
            ref_complete(copy.deepcopy(s))
        return
    df = people(600, seed=2)
    want = splink_tpu.Splink(copy.deepcopy(s), df=df).get_scored_comparisons()
    have = splink_tpu_torch.Splink(copy.deepcopy(s), df=df, device="cpu").get_scored_comparisons()
    assert list(have.columns) == list(want.columns)
    assert have["gamma_first_name"].equals(want["gamma_first_name"])
    np.testing.assert_allclose(have["match_probability"], want["match_probability"],
                               rtol=0, atol=1e-5)


@pytest.mark.parametrize("direction", ["jax_to_torch", "torch_to_jax"])
def test_kinds_model_json_moves_between_packages(tmp_path, direction):
    """A model saved with these kinds loads into the other package through
    load_from_json and scores the same gamma matrix and probabilities."""
    path = str(tmp_path / "model.json")
    df = people(800, seed=4)
    src_pkg, dst_pkg = ((splink_tpu, splink_tpu_torch) if direction == "jax_to_torch"
                        else (splink_tpu_torch, splink_tpu))
    kw = lambda pkg: {"device": "cpu"} if pkg is splink_tpu_torch else {}  # noqa: E731
    src = src_pkg.Splink(kinds_settings(), df=df, **kw(src_pkg))
    want = src.get_scored_comparisons()
    src.save_model_as_json(path)
    dst = dst_pkg.load_from_json(path, df=df, **kw(dst_pkg))
    assert dst.params.params == src.params.params
    have = dst.manually_apply_fellegi_sunter_weights()
    np.testing.assert_array_equal(dst._G, src._G)
    assert list(have.columns) == list(want.columns)
    np.testing.assert_allclose(have["match_probability"], want["match_probability"],
                               rtol=0, atol=1e-5)
