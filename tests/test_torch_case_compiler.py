"""The general CASE compiler of splink_tpu_torch against splink_tpu's.

Hand-written SQL ``case_expression``s that compat_sql does not fast-path
go through splink_tpu's case_compiler (jnp, inside its jitted gamma program,
on the CPU) and the port's (torch over the PairContext). The expressions
are taken from tests/test_case_compiler.py, tests/test_case_charset_masked.py
and tests/test_reference_golden.py and cover SQL nulls, a missing ELSE,
THEN/ELSE NULL, arithmetic with division (by zero too), comparisons with
literals, substr, concat, trim, lower/upper, ifnull/coalesce,
least/greatest, round/floor/ceil, jaro_winkler_sim, levenshtein,
jaccard_sim (plain columns: the masked charset form; tokenised; other
arguments: the self-contained form), cosine_distance (plain columns: the
masked form; otherwise self-contained), dmetaphone, cross-column and
wide-unicode strings. Tolerance: none — each expression's int8 gamma column
must EQUAL the reference's, in float32 and float64 programs; the packed
table must be lane for lane the same; the static analysis, the aux
requirements and the errors must agree.

One difference is the reference's own: inside jit, XLA on the CPU divides
by a constant as a multiply by its reciprocal (Jaro-Winkler's ``/ 3.0``,
charset Jaccard's ``/ 100.0``), so splink_tpu's jitted gamma program can
sit one ulp below its own eager functions — and the jar — and a compare
at an exact tie (a two-decimal Jaccard against a float64 literal) then
flips. The port divides truly, as the reference's functions are written.
Where the port's column differs from the jitted reference, the test
evaluates the reference's CASE evaluator eagerly on those pairs: the port
must equal it there, and the jitted program must be the one that differs.
"""

import copy
import warnings

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# tier-1 runs several pytest workers on the cores; one intra-op thread each
# keeps them from oversubscribing the CPU
torch.set_num_threads(1)
pd = pytest.importorskip("pandas")

import jax.numpy as jnp  # noqa: E402

from splink_tpu import case_compiler as ref_cc  # noqa: E402
from splink_tpu import data as ref_data  # noqa: E402
from splink_tpu import gammas as ref_gammas  # noqa: E402
from splink_tpu.compat_sql import SqlTranslationError as RefSqlError  # noqa: E402
from splink_tpu.settings import complete_settings_dict as ref_complete  # noqa: E402
from splink_tpu_torch import case_compiler, data, gammas  # noqa: E402
from splink_tpu_torch.compat_sql import SqlTranslationError  # noqa: E402
from splink_tpu_torch.settings import complete_settings_dict  # noqa: E402

# The reference fixture's surname CASE, verbatim (tests/test_reference_golden.py)
REFERENCE_SURNAME_CASE = """
            case
            when surname_l is null or surname_r is null then -1
            when surname_l = surname_r then 2
            when substr(surname_l,1, 3) =  substr(surname_r, 1, 3) then 1
            else 0
            end
            as gamma_surname
            """

# id: (levels, expression); string columns name, first, last, surname,
# wide (unicode); numeric age, amount
EXPRESSIONS = {
    "golden_surname_substr": (3, REFERENCE_SURNAME_CASE),
    "mixed_jw_lev_length": (3, """case
        when name_l is null or name_r is null then -1
        when name_l = name_r and length(name_l) > 4 then 2
        when jaro_winkler_sim(name_l, name_r) > 0.9
             or levenshtein(name_l, name_r) <= 2 then 1
        else 0 end"""),
    "arith_division_greatest": (3, """case
        when abs(age_l - age_r) / greatest(age_l, age_r) < 0.05 then 2
        when abs(age_l - age_r) < 5 then 1
        else 0 end"""),
    "division_by_zero": (2, """case
        when abs(amount_l - amount_r) / greatest(amount_l, amount_r) < 0.05
             and amount_l >= 0 then 1
        else 0 end"""),
    "literal_division_and_arith": (3, """case
        when (age_l + amount_r) / 3 > 20.5 then 2
        when age_l * 0.1 - age_r / 7 <= -1.25 then 1 else 0 end"""),
    "missing_else": (2, "case when name_l = name_r then 1 end"),
    "then_null_else_null": (2, """case
        when name_l is null or name_r is null then null
        when name_l = name_r then 1
        else null end"""),
    "cross_column_chars": (2, "case when first_l = last_r or last_l = first_r then 1 else 0 end"),
    "lower_upper_literal": (3, """case
        when lower(name_l) = 'martha' and upper(name_r) = 'MARTHA' then 2
        when lower(name_l) = lower(name_r) then 1
        else 0 end"""),
    "ifnull_empty": (2, "case when ifnull(name_l, '') = ifnull(name_r, '') then 1 else 0 end"),
    "coalesce_numeric": (2, "case when coalesce(age_l, 0) + coalesce(age_r, 0) > 50 "
                            "then 1 else 0 end"),
    "greatest_least_skip_nulls": (2, "case when greatest(age_l, amount_l) > 40 and "
                                     "least(age_r, amount_r) < 20 then 1 else 0 end"),
    "round_floor_ceil": (3, """case when round(age_l / 10) = round(age_r / 10) then 2
        when floor(amount_l) = ceil(amount_r) then 1 else 0 end"""),
    "not_is_not_null": (2, "case when not (name_l is null) and name_r is not null "
                           "and not name_l = name_r then 1 else 0 end"),
    "dmetaphone_extra_condition": (3, """case
        when name_l is null or name_r is null then -1
        when name_l = name_r then 2
        when dmetaphone(name_l) = dmetaphone(name_r) and length(name_r) > 3 then 1
        else 0 end"""),
    "nested_case_value": (3, """case
        when name_l = name_r then 2
        else case when levenshtein(name_l, name_r) <= 1 then 1 else 0 end
        end"""),
    "substr_mid_and_to_end": (3, """case
        when substr(name_l, 2, 3) = substr(name_r, 2, 3) then 2
        when substr(name_l, 3) = substr(name_r, 3) then 1 else 0 end"""),
    "substr_past_width_and_start_zero": (3, """case
        when substr(name_l, 90, 3) = substr(name_r, 90, 3) and name_l = name_r then 2
        when substr(name_l, 0, 3) = substr(name_r, 0, 3) then 1 else 0 end"""),
    "substr_literal_fold": (2, "case when substr(name_r, 1, 2) = substr('maZ', 1, 2) "
                               "then 1 else 0 end"),
    "levenshtein_substr": (2, "case when levenshtein(substr(name_l, 1, 4), "
                              "substr(name_r, 1, 4)) <= 1 then 1 else 0 end"),
    "concat_columns_literals": (3, """case
        when concat(first_l, '-', last_l) = concat(first_r, '-', last_r) then 2
        when jaro_winkler_sim(concat(first_l, last_l), concat(first_r, last_r)) > 0.85 then 1
        else 0 end"""),
    "concat_null_argument": (3, "case when concat(name_l, null) = concat(name_r, null) "
                                "then 2 when name_l = name_r then 1 else 0 end"),
    "trim_family": (3, """case when trim(name_l) = trim(name_r) then 2
        when ltrim(name_l) = rtrim(name_r) then 1 else 0 end"""),
    "jaccard_plain_and_tokenised": (3, """CASE
        WHEN surname_l IS NULL OR surname_r IS NULL THEN -1
        WHEN jaccard_sim(surname_l, surname_r) > 0.79 THEN 2
        WHEN jaccard_sim(Q3gramTokeniser(surname_l), Q3gramTokeniser(surname_r)) > 0.4 THEN 1
        ELSE 0
        END as gamma_surname"""),
    "jaccard_unmasked_arguments": (2, "case when jaccard_sim(lower(name_l), name_r) > 0.5 "
                                      "or jaccard_sim(name_l, 'martha') > 0.6 then 1 else 0 end"),
    "cosine_plain_columns": (2, """CASE
        WHEN surname_l IS NULL OR surname_r IS NULL THEN -1
        WHEN cosine_distance(surname_l, surname_r) < 0.3 THEN 1
        ELSE 0 END"""),
    "cosine_tokenised_and_derived": (3, """case
        when cosine_distance(Q3gramTokeniser(first_l), Q3gramTokeniser(first_r)) < 0.5 then 2
        when cosine_distance(lower(last_l), last_r) < 0.6 then 1 else 0 end"""),
    "wide_unicode": (3, """case when wide_l = 'zoë' and wide_r = 'zoë' then 2
        when jaro_winkler_sim(wide_l, name_r) > 0.6 or levenshtein(wide_l, wide_r) <= 1 then 1
        else 0 end"""),
    "kinds_path_city": (4, """CASE WHEN name_l IS NULL OR name_r IS NULL THEN -1
        WHEN name_l = name_r THEN 3
        WHEN jaro_winkler_sim(name_l, name_r) > 0.92 THEN 2
        WHEN levenshtein(substr(name_l,1,4), substr(name_r,1,4)) <= 1
          OR jaccard_sim(Q3gramTokeniser(name_l), Q3gramTokeniser(name_r)) > 0.6 THEN 1
        ELSE 0 END"""),
}

STRINGS = np.array(
    ["martha", "marhta", "MARTHA", "marta", "smith", "smyth", "smith jones", " smith ",
     "  lead", "ann", "anna", "annb", "jonathon", "johnathan", "", " ", None,
     "the quick brown fox", "ab ba", "banana", "ananab"], dtype=object)
WIDE = np.array(["zoë", "zoe", "josé", "jose", "łukasz", "lukasz", "日本語", None, ""],
                dtype=object)


def _frame(n=160, seed=17):
    rng = np.random.default_rng(seed)
    pick = lambda pool: pool[rng.integers(0, len(pool), n)]  # noqa: E731
    age = rng.integers(0, 80, n).astype(object)
    age[rng.random(n) < 0.08] = None
    amount = rng.choice(np.array([0.0, 0.5, 10.0, 10.4, 20.0, 33.3, 1e7 + 1, None], object), n)
    return pd.DataFrame({"unique_id": np.arange(n), "name": pick(STRINGS),
                         "first": pick(STRINGS), "last": pick(STRINGS),
                         "surname": pick(STRINGS), "wide": pick(WIDE),
                         "age": age, "amount": amount})


def _settings(**extra):
    cols = []
    for cid, (levels, expr) in EXPRESSIONS.items():
        used = sorted(ref_cc.analyse_case_expression(expr)["columns"])
        cols.append({"custom_name": cid, "custom_columns_used": used, "num_levels": levels,
                     "case_expression": expr})
    s = {"link_type": "dedupe_only", "blocking_rules": [], "comparison_columns": cols}
    s.update(extra)
    return s


def _complete(fn, s):
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        return fn(copy.deepcopy(s))


@pytest.fixture(scope="module", params=[False, True], ids=["f32", "f64"])
def gamma_pair(request):
    """(reference G, port G, completed settings, reference program, pairs)
    over 2,000 seeded pairs in batches of 512, in a float32 or float64
    program."""
    f64 = request.param
    df = _frame()
    rng = np.random.default_rng(3)
    il, ir = rng.integers(0, len(df), 2000), rng.integers(0, len(df), 2000)
    s_ref = _complete(ref_complete, _settings(float64=f64))
    s = _complete(complete_settings_dict, _settings(float64=f64))
    ref_prog = ref_gammas.GammaProgram(s_ref, ref_data.encode_table(df, s_ref),
                                       float_dtype=jnp.float64 if f64 else jnp.float32)
    want = ref_prog.compute(il, ir, batch_size=512)
    got = gammas.GammaProgram(s, data.encode_table(df, s), device="cpu",
                              float_dtype=torch.float64 if f64 else torch.float32
                              ).compute(il, ir, batch_size=512)
    return want, got, s, ref_prog, (il, ir)


def _reference_eager(ref_prog, cid, il, ir):
    """The reference's CASE evaluator on these pairs, outside jit."""
    levels, expr = EXPRESSIONS[cid]
    ctx = ref_gammas.PairContext(ref_prog._layout, ref_prog._packed[jnp.asarray(il)],
                                 ref_prog._packed[jnp.asarray(ir)])
    return np.asarray(ref_cc.compile_case_expression(expr, levels)(ctx))


@pytest.mark.parametrize("cid", list(EXPRESSIONS))
def test_case_gamma_equals_reference(gamma_pair, cid):
    want, got, s, ref_prog, (il, ir) = gamma_pair
    c = [col["custom_name"] for col in s["comparison_columns"]].index(cid)
    assert s["comparison_columns"][c]["comparison"]["kind"] == "case_sql"
    assert got.dtype == want.dtype == np.int8
    assert len(np.unique(got[:, c])) > 1, cid  # the data reaches more than one level
    bad = np.flatnonzero(got[:, c] != want[:, c])
    if bad.size:  # only where XLA's jit departs from the reference's own functions
        eager = _reference_eager(ref_prog, cid, il[bad], ir[bad])
        np.testing.assert_array_equal(got[bad, c], eager, err_msg=cid)
        assert (eager != want[bad, c]).all(), cid


def test_completed_settings_and_pack_table_equal_reference():
    df = _frame()
    s_ref = _complete(ref_complete, _settings())
    s = _complete(complete_settings_dict, _settings())
    assert s == s_ref
    assert gammas.qgram_specs_for(s) == ref_gammas.qgram_specs_for(s_ref)
    assert gammas.charset_specs_for(s) == ref_gammas.charset_specs_for(s_ref)
    assert gammas.comparison_columns_used(s) == ref_gammas.comparison_columns_used(s_ref)
    assert ("surname", 2, False, True) in gammas.qgram_specs_for(s)
    assert "surname" in gammas.charset_specs_for(s)
    kw = dict(include=gammas.comparison_columns_used(s), qgram_specs=gammas.qgram_specs_for(s),
              charset_specs=gammas.charset_specs_for(s))
    got, layout = gammas.pack_table(data.encode_table(df, s), **kw)
    want, ref_layout = ref_gammas.pack_table(ref_data.encode_table(df, s_ref), **kw)
    assert got.dtype == want.dtype and np.array_equal(got, want)
    assert list(layout) == list(ref_layout)
    for k, f in ref_layout.items():
        assert type(layout[k]).__name__ == type(f).__name__
        assert {a: getattr(layout[k], a) for a in f.__slots__} == \
            {a: getattr(f, a) for a in f.__slots__}, k


@pytest.mark.parametrize("cid", list(EXPRESSIONS))
def test_static_analysis_equals_reference(cid):
    levels, expr = EXPRESSIONS[cid]
    assert case_compiler.parse_sql_expression(expr) == ref_cc.parse_sql_expression(expr)
    assert case_compiler.analyse_case_expression(expr) == ref_cc.analyse_case_expression(expr)
    assert case_compiler.precompute_aux_requirements(expr) == \
        ref_cc.precompute_aux_requirements(expr)


@pytest.mark.parametrize("expr,levels", [
    ("case when regexp_like(name_l, 'x') then 1 else 0 end", 2),  # unsupported function
    ("case when name_l = name_r then 5 else 0 end", 3),  # level out of range
    ("case when name_l = name_r then 1.5 else 0 end", 2),  # non-integer level
    ("case when age_l = age_r then age_l else 0 end", 2),  # data-dependent outcome
    ("case when substr(name_l, length(name_l), 1) = 'x' then 1 else 0 end", 2),
    ("case when ;; then 1 end", 2),  # garbage
], ids=["unsupported", "out_of_range", "non_integer", "data_dependent", "dynamic_substr",
        "garbage"])
def test_compile_errors_equal_reference(expr, levels):
    with pytest.raises(RefSqlError) as want:
        ref_cc.compile_case_expression(expr, levels)
    with pytest.raises(SqlTranslationError) as got:
        case_compiler.compile_case_expression(expr, levels)
    assert str(got.value) == str(want.value)


def test_settings_error_names_both_translators():
    s = {"link_type": "dedupe_only", "blocking_rules": [], "comparison_columns": [
        {"col_name": "name", "num_levels": 2,
         "case_expression": "case when regexp_like(name_l, 'x') then 1 else 0 end"}]}
    with pytest.raises(SqlTranslationError, match="General CASE compiler"):
        complete_settings_dict(s)


def _ref_custom(ctx, col_settings):
    pc = ctx.col("name")
    lvl = jnp.where(pc.tok_l == pc.tok_r, 2, jnp.where(pc.len_l == pc.len_r, 1, 0))
    return jnp.where(pc.null, -1, lvl)


def _port_custom(ctx, col_settings):
    pc = ctx.col("name")
    lvl = torch.where(pc.tok_l == pc.tok_r, 2, torch.where(pc.len_l == pc.len_r, 1, 0))
    return torch.where(pc.null, -1, lvl)


def test_custom_comparison_equals_reference():
    """A custom fn registered identically in both packages (by
    ``register_comparison``, exported as in splink_tpu): the port's
    receives the port's PairContext and returns a torch tensor."""
    import splink_tpu
    import splink_tpu_torch

    splink_tpu.register_comparison("test_torch_len_or_token", _ref_custom)
    splink_tpu_torch.register_comparison("test_torch_len_or_token", _port_custom)
    df = _frame()
    cfg = {"link_type": "dedupe_only", "blocking_rules": [], "comparison_columns": [
        {"custom_name": "custom_name_cmp", "custom_columns_used": ["name"], "num_levels": 3,
         "comparison": {"kind": "custom", "fn": "test_torch_len_or_token"}},
        {"col_name": "surname", "num_levels": 2, "comparison": {"kind": "exact"}}]}
    s_ref, s = _complete(ref_complete, cfg), _complete(complete_settings_dict, cfg)
    assert gammas.comparison_columns_used(s) is None  # a custom fn may read any column
    rng = np.random.default_rng(4)
    il, ir = rng.integers(0, len(df), 1500), rng.integers(0, len(df), 1500)
    want = ref_gammas.GammaProgram(s_ref, ref_data.encode_table(df, s_ref)).compute(il, ir)
    got = gammas.GammaProgram(s, data.encode_table(df, s), device="cpu").compute(il, ir)
    np.testing.assert_array_equal(got, want)
    assert set(np.unique(got[:, 0])) == {-1, 0, 1, 2}
    cfg["comparison_columns"][0]["comparison"]["fn"] = "never_registered"
    with pytest.raises(ValueError, match="register_comparison"):
        gammas.GammaProgram(_complete(complete_settings_dict, cfg), data.encode_table(df, s),
                            device="cpu").compute(il, ir)
