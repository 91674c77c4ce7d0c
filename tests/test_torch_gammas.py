"""The int8 gamma matrix of splink_tpu_torch against splink_tpu's GammaProgram.

For every ported comparison kind (exact on strings and numbers,
jaro_winkler at 2-4 levels, levenshtein, numeric_abs, numeric_perc,
name_inversion), with nulls, empty strings and a wide-unicode column in the
data, the port's gamma matrix must EQUAL the reference's, with the two-phase
Jaro-Winkler on and off, and with its survivors scored either way: compacted
first (the CPU's form) or by one masked call over the whole batch (the
card's form, run here through the masked plain version). The two-phase
bound itself must equal the reference's, and the packed row table must be
lane-for-lane the same.
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

from splink_tpu import data as ref_data  # noqa: E402
from splink_tpu import gammas as ref_gammas  # noqa: E402
from splink_tpu.ops import jw_bound as ref_jw_bound  # noqa: E402
from splink_tpu.settings import complete_settings_dict as ref_complete  # noqa: E402
from splink_tpu_torch import data, gammas  # noqa: E402
from splink_tpu_torch.ops import jw_bound  # noqa: E402
from splink_tpu_torch.settings import complete_settings_dict  # noqa: E402

NAMES = np.array(
    ["amelia", "amelie", "oliver", "olivia", "isla", "george", "georgia", "ava",
     "eva", "noah", "nora", "", None, "martha", "marhta", "jonathon", "johnathan",
     "aaaaaaaaaaaa", "prefixtwelve", "prefixtwenty"],
    dtype=object,
)
WIDE = np.array(["zoë", "zoe", "josé", "jose", "łukasz", "lukasz", "ñandú", None, ""],
                dtype=object)


def _frame(n=300, seed=5):
    rng = np.random.default_rng(seed)
    pick = lambda pool: pool[rng.integers(0, len(pool), n)]  # noqa: E731
    num = rng.integers(0, 40, n).astype(object)
    num[rng.random(n) < 0.05] = None
    amt = (rng.random(n) * 100).round(2).astype(object)
    amt[rng.random(n) < 0.05] = None
    amt[rng.random(n) < 0.05] = 0.0
    return pd.DataFrame({
        "unique_id": np.arange(n),
        "first_name": pick(NAMES),
        "surname": pick(NAMES),
        "city": pick(NAMES),
        "wide": pick(WIDE),
        "dob": num,
        "amount": amt,
    })


COLUMNS = [
    {"col_name": "first_name", "num_levels": 3,
     "comparison": {"kind": "jaro_winkler", "thresholds": [0.94, 0.88]}},
    {"col_name": "surname", "num_levels": 4,
     "comparison": {"kind": "jaro_winkler", "thresholds": [0.94, 0.88, 0.7]}},
    {"col_name": "city", "num_levels": 3,
     "comparison": {"kind": "levenshtein", "thresholds": [0.3]}},
    {"col_name": "wide", "num_levels": 2,
     "comparison": {"kind": "jaro_winkler", "thresholds": [0.9]}},
    {"custom_name": "wide_lev", "custom_columns_used": ["wide"], "num_levels": 3,
     "comparison": {"kind": "levenshtein", "column": "wide", "thresholds": [0.5]}},
    {"custom_name": "fn_exact", "custom_columns_used": ["first_name"], "num_levels": 2,
     "comparison": {"kind": "exact", "column": "first_name"}},
    {"col_name": "dob", "data_type": "numeric", "num_levels": 2,
     "comparison": {"kind": "numeric_abs", "thresholds": [1.0]}},
    {"col_name": "amount", "data_type": "numeric", "num_levels": 3,
     "comparison": {"kind": "numeric_perc", "thresholds": [0.0001, 0.05]}},
    {"custom_name": "dob_exact", "custom_columns_used": ["dob"], "num_levels": 2,
     "data_type": "numeric", "comparison": {"kind": "exact", "column": "dob"}},
    {"custom_name": "inv", "custom_columns_used": ["first_name", "surname", "wide"],
     "num_levels": 4,
     "comparison": {"kind": "name_inversion", "column": "first_name",
                    "other_columns": ["surname", "wide"], "thresholds": [0.94, 0.88]}},
]


def _settings(**extra):
    s = {"link_type": "dedupe_only", "blocking_rules": [],
         "comparison_columns": copy.deepcopy(COLUMNS)}
    s.update(extra)
    return s


def _complete(fn, s):
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        return fn(s)


@pytest.fixture(scope="module")
def frame():
    return _frame()


@pytest.fixture(scope="module")
def pairs():
    rng = np.random.default_rng(9)
    return rng.integers(0, 300, 4000).astype(np.int32), rng.integers(0, 300, 4000).astype(np.int32)


def _reference_G(frame, pairs, **extra):
    s = _complete(ref_complete, _settings(**extra))
    table = ref_data.encode_table(frame, s)
    dtype = jnp.float64 if extra.get("float64") else jnp.float32
    return ref_gammas.GammaProgram(s, table, float_dtype=dtype).compute(*pairs, batch_size=1024)


def _port_G(frame, pairs, **extra):
    s = _complete(complete_settings_dict, _settings(**extra))
    table = data.encode_table(frame, s)
    dtype = torch.float64 if extra.get("float64") else torch.float32
    prog = gammas.GammaProgram(s, table, float_dtype=dtype, device="cpu")
    return prog, prog.compute(*pairs, batch_size=1024)


@pytest.fixture(params=["compacted", "masked"])
def survivors(request, monkeypatch):
    """Which form scores the two-phase survivors: the CPU runs the
    compacted one unless the masked one (the card's) is put in its place."""
    form = getattr(gammas, f"_survivor_levels_{request.param}")
    monkeypatch.setattr(gammas, "_survivor_levels", form)
    return request.param


@pytest.mark.parametrize("two_phase", ["on", "off"])
@pytest.mark.parametrize("float64", [False, True])
def test_gamma_matrix_equals_reference(frame, pairs, two_phase, float64, survivors):
    want = _reference_G(frame, pairs, two_phase_jw=two_phase, float64=float64)
    prog, got = _port_G(frame, pairs, two_phase_jw=two_phase, float64=float64)
    assert prog.two_phase == (two_phase == "on")
    assert got.dtype == np.int8 and got.shape == (4000, len(COLUMNS))
    for c, col in enumerate(COLUMNS):
        np.testing.assert_array_equal(got[:, c], want[:, c], err_msg=str(col))
    assert (got == -1).any() and (got == 3).any()  # nulls and top levels occur


def test_two_phase_equals_exact_within_port(frame, pairs, survivors):
    _, on = _port_G(frame, pairs, two_phase_jw="on")
    _, off = _port_G(frame, pairs, two_phase_jw="off")
    np.testing.assert_array_equal(on, off)


def test_all_survivor_batch(pairs, survivors):
    """Every pair survives the bound (shared 4-char prefixes): the
    survivors are all scored, where the reference needed its overflow-redo
    twin."""
    df = pd.DataFrame({"unique_id": np.arange(300),
                       "first_name": [f"prefix{i:04d}" for i in range(300)]})
    cols = [COLUMNS[0]]
    s = {"link_type": "dedupe_only", "blocking_rules": [], "comparison_columns": cols}
    rs = _complete(ref_complete, copy.deepcopy(s))
    want = ref_gammas.GammaProgram(rs, ref_data.encode_table(df, rs)).compute(*pairs, batch_size=4000)
    ps = _complete(complete_settings_dict, copy.deepcopy(s))
    got = gammas.GammaProgram(ps, data.encode_table(df, ps), device="cpu").compute(
        *pairs, batch_size=4000)
    np.testing.assert_array_equal(got, want)


def test_pack_table_matches_reference(frame):
    s = _complete(complete_settings_dict, _settings())
    rs = _complete(ref_complete, _settings())
    specs = gammas.jw_specs_for(s)
    assert specs == ref_gammas.jw_specs_for(rs)
    got, layout = gammas.pack_table(
        data.encode_table(frame, s), include=gammas.comparison_columns_used(s), jw_specs=specs
    )
    want, ref_layout = ref_gammas.pack_table(
        ref_data.encode_table(frame, rs), include=ref_gammas.comparison_columns_used(rs),
        jw_specs=specs,
    )
    np.testing.assert_array_equal(got, want)
    assert set(layout) == set(ref_layout)


def test_encoded_table_matches_reference(frame):
    s = _complete(complete_settings_dict, _settings())
    rs = _complete(ref_complete, _settings())
    got, want = data.encode_table(frame, s), ref_data.encode_table(frame, rs)
    for name, col in want.strings.items():
        for field in ("bytes_", "lengths", "token_ids", "null_mask"):
            np.testing.assert_array_equal(getattr(got.strings[name], field), getattr(col, field))
    for name, col in want.numerics.items():
        np.testing.assert_array_equal(got.numerics[name].values_f64, col.values_f64)
        np.testing.assert_array_equal(got.numerics[name].null_mask, col.null_mask)


def test_jw_upper_bound_equal():
    rng = np.random.default_rng(1234)
    words = [
        "a" * int(rng.integers(0, 13)) if rng.random() < 0.2
        else "".join(rng.choice(list("abcxyzpref"), rng.integers(0, 12)))
        for _ in range(500)
    ]
    col = data.encode_string_column(words, width=16)
    tok = np.arange(len(words))
    cnt, pref = jw_bound.jw_bound_row_aux(col.bytes_, col.lengths, tok)
    ref_cnt, ref_pref = ref_jw_bound.jw_bound_row_aux(col.bytes_, col.lengths, tok)
    np.testing.assert_array_equal(cnt, ref_cnt)
    np.testing.assert_array_equal(pref, ref_pref)
    il, ir = rng.integers(0, len(words), 5000), rng.integers(0, len(words), 5000)
    want = np.asarray(ref_jw_bound.jw_upper_bound(
        jnp.asarray(cnt[il]), jnp.asarray(pref[il, 0]), jnp.asarray(cnt[ir]),
        jnp.asarray(pref[ir, 0]), jnp.asarray(col.lengths[il]), jnp.asarray(col.lengths[ir]),
    ))
    as_i32 = lambda a: torch.from_numpy(np.ascontiguousarray(a).view(np.int32))  # noqa: E731
    got = jw_bound.jw_upper_bound(
        as_i32(cnt[il]), as_i32(pref[il, 0]), as_i32(cnt[ir]), as_i32(pref[ir, 0]),
        torch.from_numpy(col.lengths[il]), torch.from_numpy(col.lengths[ir]),
    ).numpy()
    np.testing.assert_array_equal(got, want)
    assert (got == 2.0).any() and (got < 0.7).any()
