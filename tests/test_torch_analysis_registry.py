"""The port's kernel registry against splink_tpu's, kernel by kernel.

``splink_tpu_torch.analysis.trace_audit.REGISTRY`` must hold the
reference's 29 names. For every name, the numpy arrays the port's builder
made (``spec.inputs``: the reference builder's arguments, in its order)
equal the reference builder's, and the port's kernel, run on the CPU on
its bound inputs, agrees with the reference kernel called directly
(``spec.built()`` then ``fn(*args)``, under the suite's x64).

Discrete outputs are held bit for bit: levels, pattern ids, pairs,
digests, band keys, candidate rows, top-k rows and flags, histograms.
Floats are held to the bound the module's own ``tests/test_torch_*.py``
states, named per kernel below: EM parameters and histories within 1e-5
(test_torch_em.py), probabilities within 4 ulp (test_torch_em.py,
test_torch_serve_engine.py), Jaro-Winkler bit for bit
(test_torch_strings.py), the streamed pass's statistics within rtol 1e-5
(test_torch_streaming.py), the TF sums within 1e-12 (float64 on the port's
side, test_torch_term_frequencies.py) and the q-gram similarity bit for
bit (test_torch_approx_lsh.py).

Where the port binds the reference's arrays differently (its gamma program
keeps the packed table resident; its virtual pair index and emission take
rule-relative positions over a cumulative pair table, not a meta row), the
comparison says what it compares.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402

from splink_tpu.analysis import trace_audit as ref_ta  # noqa: E402
from splink_tpu_torch.analysis import trace_audit as ta  # noqa: E402

NAMES = (
    "approx_minhash", "approx_minhash_weighted", "approx_verify",
    "approx_verify_weighted", "block_bucket_csr", "block_pair_emit",
    "block_segment_sort", "em_step", "em_step_checkpointed", "em_step_telemetry",
    "gamma_batch", "jaro_winkler", "levenshtein", "pattern_kernel", "quality_profile",
    "score_pairs", "serve_candidate_gather", "serve_drift_sketch",
    "serve_encode_query", "serve_score_fused", "serve_score_fused_tf",
    "serve_score_topk", "serve_score_topk_brownout", "spill_chunk_digest",
    "spill_chunk_digest_compact", "streamed_pass", "tf_adjustment", "tf_gather",
    "virtual_pattern_kernel",
)


def _np(x):
    return ta.to_numpy(x)


def _ref(name):
    ref_ta._ensure_default_registry()
    fn, args, kwargs = ref_ta.REGISTRY[name].built()
    return fn, args, kwargs


def _port(name):
    ta._ensure_default_registry()
    return ta.REGISTRY[name]


def _equal(a, b):
    a, b = _np(a), _np(b)
    assert a.shape == b.shape, (a.shape, b.shape)
    np.testing.assert_array_equal(a.astype(np.int64) if a.dtype.kind in "iub" else a,
                                  b.astype(np.int64) if b.dtype.kind in "iub" else b)


def _close(a, b, atol, rtol=0.0):
    np.testing.assert_allclose(_np(a).astype(np.float64), _np(b).astype(np.float64),
                               rtol=rtol, atol=atol)


def _ulp4(a, b):
    a = _np(a).astype(np.float64)
    b = _np(b).astype(np.float64)
    ulp = np.spacing(np.maximum(np.abs(a), np.abs(b)).astype(np.float32)).astype(np.float64)
    assert (np.abs(a - b) <= 4 * ulp).all(), (a, b)


def test_registry_has_the_reference_names():
    ref_ta._ensure_default_registry()
    ta._ensure_default_registry()
    assert set(ta.REGISTRY) == set(ref_ta.REGISTRY) == set(NAMES)


@pytest.mark.parametrize("name", NAMES)
def test_inputs_equal_the_reference_builders(name):
    _, args, kwargs = _ref(name)
    want = [np.asarray(x) for x in jax.tree_util.tree_leaves((args, kwargs))]
    got = _port(name).inputs("cpu")
    assert len(got) == len(want), (len(got), len(want))
    for g, w in zip(got, want):
        g = np.asarray(g)
        assert g.shape == w.shape, (g.shape, w.shape)
        # scalars the port takes as Python numbers hold the reference's
        # float32 value exactly; arrays keep the reference's dtype
        np.testing.assert_array_equal(g.astype(w.dtype), w)
        if g.ndim:
            assert g.dtype == w.dtype, (g.dtype, w.dtype)


def _em(got, want):
    # test_torch_em.py: parameters within 1e-5 at float32, equal counts
    assert int(got.n_updates) == int(want.n_updates)
    assert bool(got.converged) == bool(want.converged)
    for g, w in zip(got.params, want.params):
        _close(g, w, 1e-5)
    n = int(want.n_updates) + 1
    for g, w in ((got.lam_history, want.lam_history), (got.m_history, want.m_history),
                 (got.u_history, want.u_history), (got.ll_history, want.ll_history)):
        g, w = _np(g)[:n], _np(w)[:n]
        np.testing.assert_array_equal(np.isnan(g), np.isnan(w))
        _close(np.nan_to_num(g), np.nan_to_num(w), 1e-5, 1e-5)


def _streamed(got, want):
    # test_torch_streaming.py: statistics within rtol 1e-5
    (gs, gll), (ws, wll) = got, want
    for g, w in zip(gs, ws):
        _close(g, w, 1e-6, 1e-5)
    _close(gll, wll, 1e-6, 1e-5)


def _pattern(got, want):
    pid, acc = got
    wpid, wacc = want
    # the reference appends its overflow flag as the last lane
    _equal(pid, _np(wpid)[:-1])
    assert int(_np(wpid)[-1]) == 0
    _equal(acc, wacc)


def _virtual(got, want):
    # the reference's meta row defines its decode on the live unit's 3
    # pairs only; the port's plan runs the four units' 12 pairs, the first
    # three of which are that unit's
    pid, _ = got
    wpid, _ = want
    _equal(_np(pid)[:3], _np(wpid)[:3])


def _segment_sort(got, want):
    order, starts, l_cnt, r_cnt = got
    row_s, seg_start, wl, wr, n_seg, n_valid = (_np(x) for x in want)
    live = seg_start[: int(n_seg)] < int(n_valid)
    _equal(order, row_s)
    _equal(starts, seg_start[: int(n_seg)][live])
    _equal(l_cnt, wl[: int(n_seg)][live])
    _equal(r_cnt, wr[: int(n_seg)][live])


def _bucket_csr(got, want):
    rows, starts, sizes, row_bucket = got
    row_s, wst, wsz, wrb, n_seg, n_valid = (_np(x) for x in want)
    live = wst[: int(n_seg)] < int(n_valid)
    _equal(rows, row_s[: int(n_valid)])
    _equal(starts, wst[: int(n_seg)][live])
    _equal(sizes, wsz[: int(n_seg)][live])
    _equal(row_bucket, wrb)


def _pair_emit(got, want):
    # the CPU compacts on the host: (i, j, digest) of the survivors; the
    # reference's first output carries its survivor count as its last lane
    tag, (i, j, _) = got
    assert tag == ("host",)
    wi, wj, _ = (_np(x) for x in want)
    count = int(wi[-1])
    _equal(i, wi[:count])
    _equal(j, wj[:count])


def _encode(got, want):
    _equal(_np(got[0]).view(np.uint32), want[0])
    _equal(got[1], want[1])


def _score(got, want):
    # test_torch_serve_engine.py: probabilities within 4 ulp, rows and
    # flags equal
    _ulp4(got[0], want[0])
    _equal(got[1], want[1])
    _equal(got[2], want[2])


def _verify(got, want):
    _equal(got[0], want[0])
    _equal(got[1], want[1])  # test_torch_approx_lsh.py: sim bit for bit


def _exact(got, want):
    for g, w in zip(ta.leaves(got), jax.tree_util.tree_leaves(want)):
        _equal(g, w)


COMPARE = {
    "em_step": _em,
    "em_step_checkpointed": _em,
    "em_step_telemetry": _em,
    "streamed_pass": _streamed,
    "score_pairs": lambda g, w: _ulp4(g, w),
    "gamma_batch": _exact,
    "pattern_kernel": _pattern,
    "virtual_pattern_kernel": _virtual,
    "jaro_winkler": _exact,  # test_torch_strings.py: bit for bit
    "levenshtein": _exact,
    # float64 sums on the port's side (test_torch_term_frequencies.py)
    "tf_adjustment": lambda g, w: [_close(a, b, 1e-12) for a, b in zip(g, w)],
    "tf_gather": lambda g, w: _close(g, w, 0.0),
    "serve_encode_query": _encode,
    "serve_candidate_gather": _exact,
    "serve_score_topk": _score,
    "serve_score_fused": _score,
    "serve_score_fused_tf": _score,
    "serve_score_topk_brownout": _score,
    "block_segment_sort": _segment_sort,
    "block_bucket_csr": _bucket_csr,
    "block_pair_emit": _pair_emit,
    "spill_chunk_digest": _exact,
    "spill_chunk_digest_compact": _exact,
    "approx_minhash": _exact,
    "approx_minhash_weighted": _exact,
    "approx_verify": _verify,
    "approx_verify_weighted": _verify,
    "quality_profile": _exact,
    "serve_drift_sketch": _exact,
}


@pytest.mark.parametrize("name", NAMES)
def test_outputs_agree_with_the_reference_kernels(name):
    fn, args, kwargs = _ref(name)
    want = fn(*args, **kwargs)
    pfn, pargs, pkwargs = _port(name).built("cpu")
    got = pfn(*pargs, **pkwargs)
    COMPARE[name](got, want)
