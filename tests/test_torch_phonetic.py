"""Double metaphone in splink_tpu_torch against splink_tpu.

The port copies splink_tpu/ops/phonetic.py, so the jar's golden table
(tests/data/dmetaphone_vectors.json, 2,770 words) must pass exactly as in
tests/test_phonetic_vectors.py. The derived ``__dm_<col>`` columns, which
the port encodes once per distinct value, must equal splink_tpu's per-row
encoding array for array (chars, lengths, token ids, nulls, values; None
stays None, a non-null value with an empty code is not null) and sit in
``table.strings`` in the same order. The blocking keys ``dmetaphone()`` and
``dmetaphone_alt()`` must give the same pair index arrays, in order, and
the dmetaphone comparison kind the same int8 gamma matrix at 2 and 3
levels, the CASE shapes compat_sql fast-paths to it included. Tolerance:
none anywhere (exact equality).
"""

import copy
import json
import os
import warnings

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# tier-1 runs several pytest workers on the cores; one intra-op thread each
# keeps them from oversubscribing the CPU
torch.set_num_threads(1)
pd = pytest.importorskip("pandas")

from splink_tpu import blocking as ref_blocking  # noqa: E402
from splink_tpu import data as ref_data  # noqa: E402
from splink_tpu import gammas as ref_gammas  # noqa: E402
from splink_tpu.ops import phonetic as ref_phonetic  # noqa: E402
from splink_tpu.settings import complete_settings_dict as ref_complete  # noqa: E402
from splink_tpu_torch import blocking, data, gammas  # noqa: E402
from splink_tpu_torch.ops import phonetic  # noqa: E402
from splink_tpu_torch.settings import complete_settings_dict  # noqa: E402

VECTORS = os.path.join(os.path.dirname(__file__), "data", "dmetaphone_vectors.json")

NAMES = np.array(
    ["smith", "smyth", "schmidt", "jon", "john", "catherine", "katherine", "stewart",
     "stuart", "knight", "night", "thomas", "tomas", "123", "   ", "", None, float("nan"),
     "Ødegaard", "josé", "jose", "philip", "phillip", "meyer", "meier", "lee", "leigh"],
    dtype=object,
)


def _frame(n=240, seed=3):
    rng = np.random.default_rng(seed)
    pick = lambda: NAMES[rng.integers(0, len(NAMES), n)]  # noqa: E731
    city = pick()
    city[rng.random(n) < 0.05] = 12345  # a non-string value: its code is str(v)'s
    return pd.DataFrame({"unique_id": np.arange(n), "first_name": pick(), "surname": pick(),
                         "city": pd.Series(city, dtype=object)})


def _complete(fn, s):
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        return fn(copy.deepcopy(s))


def _settings(levels=3, rules=(), case=None):
    cols = [
        {"col_name": "first_name", "num_levels": levels, "comparison": {"kind": "dmetaphone"}},
        {"col_name": "surname", "num_levels": 2, "comparison": {"kind": "exact"}},
    ]
    if case is not None:
        cols[0] = {"col_name": "first_name", "num_levels": levels, "case_expression": case}
    return {"link_type": "dedupe_only", "blocking_rules": list(rules), "comparison_columns": cols}


def test_bit_exact_against_reference_jar_vectors():
    with open(VECTORS) as f:
        table = json.load(f)
    assert len(table) > 2500
    bad = {w: (got, tuple(want)) for w, want in table.items()
           if (got := phonetic.double_metaphone(w)) != tuple(want)}
    assert not bad, dict(list(bad.items())[:10])
    for w in list(table)[:200] + ["", "   ", "123", None]:
        assert phonetic.double_metaphone(w) == ref_phonetic.double_metaphone(w)
        assert phonetic.double_metaphone_primary(w) == ref_phonetic.double_metaphone_primary(w)


def test_canonical_examples():
    assert phonetic.double_metaphone("smith") == ("SM0", "XMT")
    assert phonetic.double_metaphone("schmidt") == ("XMT", "SMT")
    assert phonetic.double_metaphone(None) == ("", "")


def test_phonetic_columns_equal_reference():
    df = _frame()
    rules = ["dmetaphone(l.city) = dmetaphone(r.city)"]
    s_ref = _complete(ref_complete, _settings(rules=rules))
    s = _complete(complete_settings_dict, _settings(rules=rules))
    assert data._phonetic_columns_needed(s) == ref_data._phonetic_columns_needed(s_ref)
    want = ref_data.encode_table(df, s_ref)
    got = data.encode_table(df, s)
    assert list(got.strings) == list(want.strings)
    assert {"__dm_first_name", "__dm_city"} <= set(got.strings)
    for name, w in want.strings.items():
        g = got.strings[name]
        for field in ("bytes_", "lengths", "token_ids", "null_mask"):
            a, b = getattr(g, field), getattr(w, field)
            assert a.dtype == b.dtype and np.array_equal(a, b), (name, field)
        assert g.width == w.width
        assert list(g.values) == list(w.values), name
    dm = got.strings["__dm_first_name"]
    src = df["first_name"].to_numpy()
    empty_code = np.array([v in ("123", "   ", "") for v in src])
    assert empty_code.any() and not dm.null_mask[empty_code].any()  # '' is not null
    assert dm.null_mask[pd.isna(src)].all()


@pytest.mark.parametrize("rule", [
    "dmetaphone(l.surname) = dmetaphone(r.surname)",
    "dmetaphone_alt(l.first_name) = dmetaphone_alt(r.first_name)",
    "dmetaphone(l.first_name) = dmetaphone(r.surname) AND l.city = r.city",
    "l.surname = r.surname AND dmetaphone(l.first_name) <> dmetaphone_alt(r.first_name)",
])
def test_dmetaphone_blocking_pairs_equal_reference(rule):
    df = _frame(300, 8)
    s_ref = _complete(ref_complete, _settings(rules=[rule]))
    s = _complete(complete_settings_dict, _settings(rules=[rule]))
    want = ref_blocking.block_using_rules(s_ref, ref_data.encode_table(df, s_ref))
    got = blocking.block_using_rules(s, data.encode_table(df, s))
    assert got.n_pairs == want.n_pairs > 0
    np.testing.assert_array_equal(got.idx_l, want.idx_l)
    np.testing.assert_array_equal(got.idx_r, want.idx_r)


CASE_2 = ("case when first_name_l is null or first_name_r is null then -1 "
          "when dmetaphone(first_name_l) = dmetaphone(first_name_r) then 1 else 0 end")
CASE_3 = ("case when first_name_l is null or first_name_r is null then -1 "
          "when first_name_l = first_name_r then 2 "
          "when dmetaphone(first_name_l) = dmetaphone(first_name_r) then 1 else 0 end")


@pytest.mark.parametrize("levels,case", [(2, None), (3, None), (2, CASE_2), (3, CASE_3)],
                         ids=["2-levels", "3-levels", "2-levels-case", "3-levels-case"])
def test_dmetaphone_gamma_equals_reference(levels, case):
    df = _frame()
    s_ref = _complete(ref_complete, _settings(levels, case=case))
    s = _complete(complete_settings_dict, _settings(levels, case=case))
    assert s["comparison_columns"][0]["comparison"] == {"kind": "dmetaphone"}
    rng = np.random.default_rng(levels)
    il, ir = rng.integers(0, len(df), 3000), rng.integers(0, len(df), 3000)
    want = ref_gammas.GammaProgram(s_ref, ref_data.encode_table(df, s_ref)).compute(
        il, ir, batch_size=1024)
    got = gammas.GammaProgram(s, data.encode_table(df, s), device="cpu").compute(
        il, ir, batch_size=1024)
    assert got.dtype == want.dtype == np.int8
    np.testing.assert_array_equal(got, want)
    assert set(np.unique(got[:, 0])) == set(range(-1, levels))


def test_dmetaphone_levels_out_of_range_raise_as_reference():
    df = _frame(40)
    pairs = (np.zeros(4, np.int64), np.ones(4, np.int64))
    s_ref = _complete(ref_complete, _settings(4))
    with pytest.raises(ValueError, match="num_levels 2 or 3"):
        ref_gammas.GammaProgram(s_ref, ref_data.encode_table(df, s_ref)).compute(*pairs)
    s = _complete(complete_settings_dict, _settings(4))
    with pytest.raises(ValueError, match="num_levels 2 or 3"):
        gammas.GammaProgram(s, data.encode_table(df, s), device="cpu").compute(*pairs)
