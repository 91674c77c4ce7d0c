"""Encoding and host blocking of splink_tpu_torch against splink_tpu.

The port copies splink_tpu's host join and its ``spill_dir`` sink (the
device and approximate tiers have test files of their own), so on the same frame and
rules the pair index arrays must be EQUAL, in order, for all three link
types and every rule shape: equality conjunctions, derived keys,
cross-column keys, residual predicates, sequential-rule dedup and the
cartesian fallback.
"""

import copy
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
from splink_tpu.settings import complete_settings_dict as ref_complete  # noqa: E402
from splink_tpu_torch import blocking, data  # noqa: E402
from splink_tpu_torch.settings import complete_settings_dict  # noqa: E402

RULES = [
    ["l.city = r.city"],
    ["l.city = r.city AND l.surname = r.surname"],
    ["substr(l.surname, 1, 2) = substr(r.surname, 1, 2)"],
    ["l.surname = r.first_name"],
    ["l.city = r.city AND l.age < r.age"],
    ["l.city = r.city", "l.surname = r.surname", "l.age = r.age"],
    ["l.age >= r.age + 40"],
    [],
]


def _frame(n, seed):
    rng = np.random.default_rng(seed)
    names = np.array(["ann", "bob", "cy", "dee", "eve", "fay", None], dtype=object)
    cities = np.array(["x", "y", "z", None], dtype=object)
    return pd.DataFrame({
        "unique_id": rng.permutation(n) * 3 + 7,
        "first_name": names[rng.integers(0, len(names), n)],
        "surname": names[rng.integers(0, len(names), n)],
        "city": cities[rng.integers(0, len(cities), n)],
        "age": rng.integers(0, 60, n),
    })


def _settings(link_type, rules):
    return {
        "link_type": link_type,
        "blocking_rules": rules,
        "comparison_columns": [
            {"col_name": "first_name", "num_levels": 2, "comparison": {"kind": "exact"}},
            {"col_name": "surname", "num_levels": 2, "comparison": {"kind": "exact"}},
        ],
    }


def _run(pkg_data, pkg_blocking, complete, link_type, rules, frames):
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        s = complete(copy.deepcopy(_settings(link_type, rules)))
        if link_type == "dedupe_only":
            table, n_left = pkg_data.encode_table(frames[0], s), None
        else:
            table, n_left = pkg_data.concat_tables(frames[0], frames[1], s), len(frames[0])
        return pkg_blocking.block_using_rules(s, table, n_left)


@pytest.mark.parametrize("link_type", ["dedupe_only", "link_only", "link_and_dedupe"])
@pytest.mark.parametrize("rules", RULES, ids=lambda r: " | ".join(r) or "cartesian")
def test_pair_index_equals_reference(link_type, rules):
    frames = (_frame(120, 1),) if link_type == "dedupe_only" else (_frame(70, 2), _frame(60, 3))
    want = _run(ref_data, ref_blocking, ref_complete, link_type, rules, frames)
    got = _run(data, blocking, complete_settings_dict, link_type, rules, frames)
    assert got.n_pairs == want.n_pairs > 0
    np.testing.assert_array_equal(got.idx_l, want.idx_l)
    np.testing.assert_array_equal(got.idx_r, want.idx_r)


def test_spill_dir_raises(tmp_path):
    """spill_dir raised NotImplementedError until the spill sink was ported
    (hence the name); it now streams the pairs to memmaps, equal in order
    to the reference's and to the in-RAM index, and release() reclaims the
    directory."""
    s = complete_settings_dict(_settings("dedupe_only", ["l.city = r.city"]))
    s["spill_dir"] = str(tmp_path)
    frame = _frame(40, 4)
    got = blocking.block_using_rules(s, data.encode_table(frame, s))
    rs = ref_complete(copy.deepcopy(s))
    want = ref_blocking.block_using_rules(rs, ref_data.encode_table(frame, rs))
    assert isinstance(got.idx_l, np.memmap) and got.spill_tmp.startswith(str(tmp_path))
    assert got.n_pairs == want.n_pairs > 0
    np.testing.assert_array_equal(got.idx_l, want.idx_l)
    np.testing.assert_array_equal(got.idx_r, want.idx_r)
    spill = got.spill_tmp
    got.release()
    want.release()
    assert not os.path.exists(spill)
