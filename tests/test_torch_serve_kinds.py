"""Served answers of splink_tpu_torch against splink_tpu over every
comparison kind and every link type.

The serve parity tests elsewhere cover ``dedupe_only`` with Jaro-Winkler,
exact, Levenshtein and ``numeric_abs``. The drift sketch recomputes gammas
through every kind, so this file pins the rest on the CPU: ``dmetaphone``,
both q-gram kinds, a general CASE expression (Jaro-Winkler, Levenshtein of
substrings and q-gram Jaccard inside it) and ``numeric_abs``; ``link_only``
and ``link_and_dedupe``; a ``dmetaphone()`` blocking rule; float32 and
float64; fused and unfused scoring; indexes built by either package.

For one model JSON (trained by splink_tpu) and frame: the two packages'
index fingerprints are equal, the answers' candidate counts, valid masks
and rows are equal (within a run of near-tied scores the rows are equal as
a set), and every probability is within 4 ulp of the reference's in its
float type (XLA's log and PyTorch's differ in the last ulp:
tests/test_torch_em.py).
"""

import copy
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)
pd = pytest.importorskip("pandas")

from test_torch_kinds_linker import _phonetic_blocking, kinds_settings  # noqa: E402
from test_torch_linker import people  # noqa: E402

import splink_tpu  # noqa: E402
import splink_tpu_torch  # noqa: E402
from splink_tpu_torch.serve import BucketPolicy, QueryEngine, load_index  # noqa: E402

K = 8
POLICY = ((64,), (256,))

# id: (link type, settings change, float type, fused, who builds the
# port's index: "port" exports its own, "ref" loads the reference's save)
CASES = {
    "dedupe-f32-fused": ("dedupe_only", None, "float32", True, "port"),
    "dedupe-f32-unfused": ("dedupe_only", None, "float32", False, "ref"),
    "dedupe-f64-fused": ("dedupe_only", None, "float64", True, "ref"),
    "dedupe-f64-unfused": ("dedupe_only", None, "float64", False, "port"),
    "link_only-f32-fused": ("link_only", None, "float32", True, "ref"),
    "link_only-f64-unfused": ("link_only", None, "float64", False, "port"),
    "link_and_dedupe-f32-unfused": ("link_and_dedupe", None, "float32", False, "port"),
    "link_and_dedupe-f64-fused": ("link_and_dedupe", None, "float64", True, "ref"),
    "dmetaphone_rule-f32-fused": ("dedupe_only", _phonetic_blocking, "float32", True, "ref"),
    "dmetaphone_rule-f64-unfused": ("dedupe_only", _phonetic_blocking, "float64", False,
                                    "port"),
}


def _frames(link_type, df):
    if link_type == "dedupe_only":
        return {"df": df}
    return {"df_l": df.iloc[0::2].reset_index(drop=True),
            "df_r": df.iloc[1::2].reset_index(drop=True)}


def _queries(df):
    """60 rows of the frame (one query bucket) with one-letter typos in
    every third first name and surname, nulls, and a record whose keys hit
    no bucket."""
    q = df.sample(60, random_state=5).drop(columns=["dup_of"]).reset_index(drop=True)
    q["unique_id"] = q["unique_id"] + 10_000
    for col in ("first_name", "surname"):
        vals = q[col].to_numpy(object)
        q[col] = [v[:-1] + "q" if isinstance(v, str) and i % 3 == 0 else v
                  for i, v in enumerate(vals)]
    q.loc[1, ["city", "dob"]] = None
    q.loc[2, "postcode"] = None
    q.loc[3, ["blk", "surname"]] = [10_000, "zzzzzz"]
    return q


def _close(a, b):
    """Within 4 ulp of the larger magnitude, in the arrays' float type."""
    dt = a.dtype
    a64, b64 = a.astype(np.float64), b.astype(np.float64)
    ulp = np.spacing(np.maximum(np.abs(a), np.abs(b)).astype(dt)).astype(np.float64)
    return np.abs(a64 - b64) <= 4 * ulp


def _assert_answers_match(ref, got):
    rp, rr, rv, rn = ref
    gp, gr, gv, gn = got
    assert gp.dtype == rp.dtype and gr.dtype == rr.dtype
    assert np.array_equal(rn, gn)
    assert np.array_equal(rv, gv)
    assert _close(rp[rv], gp[gv]).all(), np.abs(rp[rv] - gp[gv]).max()
    k = rp.shape[1]
    for q in np.flatnonzero((rr != gr).any(axis=1)):
        r = 0
        while r < k:
            e = r + 1
            while e < k and rv[q, e] and _close(rp[q, e:e + 1], rp[q, r:r + 1])[0]:
                e += 1
            if e < k or not rv[q, k - 1]:
                assert set(rr[q, r:e][rv[q, r:e]]) == set(gr[q, r:e][gv[q, r:e]]), (q, r)
            r = e


@pytest.fixture(scope="module")
def corpus():
    return people(600, seed=7)


@pytest.mark.parametrize("case", list(CASES))
def test_served_kinds_match_reference(case, corpus, tmp_path):
    link_type, change, dtype, fused, index_from = CASES[case]
    s = kinds_settings(link_type, max_iterations=3)
    if callable(change):
        s = change(s)
    s["float64"] = dtype == "float64"
    frames = _frames(link_type, corpus)
    trainer = splink_tpu.Splink(copy.deepcopy(s), **frames)
    trainer.estimate_parameters()
    model = tmp_path / "model.json"
    trainer.save_model_as_json(model)
    with open(model) as fh:
        assert json.load(fh)["settings"]["float64"] == (dtype == "float64")

    ref = splink_tpu.load_from_json(model, **frames)
    ref_index = ref.export_index(tmp_path / "ref_idx")
    port = splink_tpu_torch.load_from_json(model, **frames, device="cpu")
    own = port.export_index()
    assert own.content_fingerprint() == ref_index.content_fingerprint()
    assert own.n_rows == ref_index.n_rows
    index = own if index_from == "port" else load_index(tmp_path / "ref_idx", device="cpu")
    assert index.content_fingerprint() == ref_index.content_fingerprint()

    from splink_tpu.serve import BucketPolicy as RefPolicy
    from splink_tpu.serve import QueryEngine as RefEngine

    q = _queries(corpus)
    want = RefEngine(ref_index, top_k=K, policy=RefPolicy(*POLICY),
                     fused=fused).query_arrays(q)
    got = QueryEngine(index, top_k=K, policy=BucketPolicy(*POLICY),
                      fused=fused).query_arrays(q)
    _assert_answers_match(want, got)
    n_cand, valid = got[3], got[2]
    assert (n_cand > 0).sum() >= 50 and n_cand[3] == 0
    assert valid.sum() >= 200
    # every kind reaches more than one level among the served pairs
    qi, ki = np.nonzero(valid)
    batch = index.encode_queries(q)
    from splink_tpu_torch.gammas import PairContext, _spec_gamma

    ctx = PairContext(index.layout, torch.from_numpy(batch.packed[qi].view(np.int32)),
                      torch.from_numpy(index.packed[got[1][qi, ki]].view(np.int32)))
    for col in index.settings["comparison_columns"]:
        assert len(np.unique(_spec_gamma(col, ctx, False).numpy())) > 1, col["col_name"]
