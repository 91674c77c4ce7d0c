"""splink_tpu_torch's resilience layer against splink_tpu's, on CPU.

The fault-plan grammar and the checkpoint file are shared: the same plan
string fires at the same coordinates in both packages, and a checkpoint
either package writes loads in the other. The retry classifier is the
port's own (PyTorch's errors, not XLA's status strings): an OOM is
transient, a CUDA launch error never is. The load-bearing assertions are
BIT-IDENTITY ones, as in tests/test_checkpoint_resume.py: a run with
checkpoints equals one without, and a run killed by a real SIGKILL
(injected through the fault plan) and resumed from its checkpoint equals an
uninterrupted run — final parameters and every history entry, compared as
JSON text. EMNumericsError must fire before a poisoned update reaches the
histories or a checkpoint, in both packages.
"""

import json
import os
import signal
import subprocess
import sys
import warnings

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)
pd = pytest.importorskip("pandas")

import jax.numpy as jnp  # noqa: E402

import splink_tpu  # noqa: E402
import splink_tpu.resilience as ref_res  # noqa: E402
import splink_tpu_torch  # noqa: E402
from splink_tpu.em import EMNumericsError as RefNumericsError  # noqa: E402
from splink_tpu.em import run_em_checkpointed as ref_run_em_checkpointed  # noqa: E402
from splink_tpu.models.fellegi_sunter import FSParams as RefFSParams  # noqa: E402
from splink_tpu.resilience.faults import reset_plans as ref_reset_plans  # noqa: E402
from splink_tpu_torch import resilience  # noqa: E402
from splink_tpu_torch.em import EMNumericsError, run_em, run_em_checkpointed  # noqa: E402
from splink_tpu_torch.models.fellegi_sunter import FSParams  # noqa: E402
from splink_tpu_torch.resilience.checkpoint import (  # noqa: E402
    CHECKPOINT_VERSION,
    CheckpointError,
    checkpoint_path,
)
from splink_tpu_torch.resilience.faults import InjectedFault, reset_plans  # noqa: E402
from splink_tpu_torch.utils.logging_utils import DegradationWarning  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True)
def _fresh_fault_plans():
    """Fault-plan budgets are per-process state in both packages."""
    reset_plans()
    ref_reset_plans()
    yield
    reset_plans()
    ref_reset_plans()


def _df(n=150, seed=0):
    rng = np.random.default_rng(seed)
    firsts = np.array(["amelia", "oliver", "isla", "george", "ava", "noah"])
    lasts = np.array(["smith", "jones", "taylor", "brown"])
    return pd.DataFrame({
        "unique_id": np.arange(n),
        "first_name": firsts[rng.integers(0, 6, n)],
        "surname": lasts[rng.integers(0, 4, n)],
        "city": [f"c{i % 4}" for i in range(n)],
    })


def _settings(**overrides):
    s = {
        "link_type": "dedupe_only",
        "blocking_rules": ["l.city = r.city"],
        "comparison_columns": [
            {"col_name": "first_name", "num_levels": 2, "comparison": {"kind": "exact"}},
            {"col_name": "surname", "num_levels": 2, "comparison": {"kind": "exact"}},
        ],
        "max_iterations": 8,
        # EM runs the whole budget: an early convergence would collapse the
        # interrupted, resumed and uninterrupted runs into a few updates
        "em_convergence": 1e-12,
    }
    s.update(overrides)
    return s


# kind "exact" as a CUSTOM comparison: a registered function disqualifies
# the pattern pipeline, so with max_resident_pairs below the pair count
# estimate_parameters takes the streamed driver (batch_fetch, em_iteration,
# EMCheckpointer)
_CUSTOM_EXACT = """
import torch
import splink_tpu_torch
from splink_tpu_torch.ops.gamma import apply_null

def _custom_exact_first(ctx, col_settings):
    pc = ctx.col("first_name")
    return apply_null((pc.tok_l == pc.tok_r).to(torch.int8), pc.null)

splink_tpu_torch.register_comparison("ckpt_exact_first", _custom_exact_first)
"""
exec(_CUSTOM_EXACT)


def _ref_custom_exact_first(ctx, col_settings):
    from splink_tpu.ops.gamma import apply_null as ref_apply_null

    pc = ctx.col("first_name")
    return ref_apply_null((pc.tok_l == pc.tok_r).astype(jnp.int8), pc.null)


splink_tpu.register_comparison("ckpt_exact_first", _ref_custom_exact_first)


def _settings_streamed(**overrides):
    first = {"col_name": "first_name", "num_levels": 2,
             "comparison": {"kind": "custom", "fn": "ckpt_exact_first"}}
    surname = {"col_name": "surname", "num_levels": 2, "comparison": {"kind": "exact"}}
    return _settings(comparison_columns=[first, surname], max_resident_pairs=1024,
                     pair_batch_size=1024, **overrides)


def _port(settings, df=None):
    return splink_tpu_torch.Splink(dict(settings), df=_df() if df is None else df,
                                   device="cpu")


def _state(linker):
    return json.dumps({"current": linker.params.params,
                       "history": linker.params.param_history}, sort_keys=True)


def _assert_bit_identical(a, b):
    """Final params AND the whole per-iteration history, exactly equal."""
    assert _state(a) == _state(b)


# ----------------------------------------------------------------------
# faults.py and retry.py
# ----------------------------------------------------------------------

@pytest.mark.parametrize("pkg", ["splink_tpu", "splink_tpu_torch"])
def test_fault_plan_grammar_and_budget(pkg):
    """One plan string, the same firing pattern in both packages: wrong
    site or coordinates do not fire, ``times`` bounds the budget, ``kind``
    rides on the raised fault."""
    faults = ref_res.faults if pkg == "splink_tpu" else resilience.faults
    plan = faults.FaultPlan.from_spec(
        "batch_fetch@iter=2:batch=3, em_iteration@iter=4:kind=oom:times=2")
    plan.fire("batch_fetch", iter=1, batch=3)
    plan.fire("segment", iter=2, batch=3)
    with pytest.raises(faults.InjectedFault) as e:
        plan.fire("batch_fetch", iter=2, batch=3)
    assert e.value.kind == "transient" and e.value.coords == {"iter": 2, "batch": 3}
    plan.fire("batch_fetch", iter=2, batch=3)  # budget spent
    for _ in range(2):
        with pytest.raises(faults.InjectedFault) as e:
            plan.fire("em_iteration", iter=4)
        assert e.value.kind == "oom"
    plan.fire("em_iteration", iter=4)
    with pytest.raises(ValueError, match="kind"):
        faults.FaultPlan.from_spec("batch_fetch@kind=meteor")
    empty = faults.FaultPlan.from_spec("")
    assert not empty
    empty.fire("anything", iter=0)


NET_PLANS = [
    "wire_response@kind=net_torn_frame",
    "wire_accept@kind=net_partition:delay_ms=500",
    "wire_request@request=3:kind=net_drop:times=2",
    "wire_request@kind=net_delay:delay_ms=40, wire_response@request=7:kind=net_drop",
    "wire_accept@conn=2:kind=net_drop, serve_batch@batch=1:kind=slow:delay_ms=10",
]


def _parsed(plan):
    return [(ev.site, ev.kind, ev.match, ev.times, ev.delay_ms) for ev in plan.events]


@pytest.mark.parametrize("spec", NET_PLANS)
def test_net_plans_parse_alike_in_both_packages(spec):
    """The network kinds and the wire sites: one plan string gives the same
    events (site, kind, coordinates, budget, delay) in both packages, and
    each fires the same way: a net_delay stalls and continues, the other
    net kinds raise with their kind and the partition's duration."""
    ref, port = ref_res.faults.FaultPlan.from_spec(spec), resilience.faults.FaultPlan.from_spec(spec)
    assert _parsed(ref) == _parsed(port)
    assert set(resilience.faults.WIRE_SITES) == set(ref_res.faults.WIRE_SITES)
    assert set(resilience.faults.WIRE_SITES) <= set(resilience.faults.SITES)
    for ev in list(port.events):
        coords = dict(ev.match) or {"request": 1}
        outcomes = []
        for faults, plan in ((ref_res.faults, ref), (resilience.faults, port)):
            try:
                plan.fire(ev.site, **coords)
                outcomes.append(None)
            except faults.InjectedFault as e:
                outcomes.append((e.kind, e.site, e.coords, e.delay_ms))
        assert outcomes[0] == outcomes[1]
        if ev.kind in ("net_delay", "slow"):
            assert outcomes[0] is None
        else:
            assert outcomes[0][0] == ev.kind


def test_active_plan_reads_env_then_settings(monkeypatch):
    monkeypatch.delenv("SPLINK_TPU_FAULTS", raising=False)
    assert resilience.active_plan({"fault_plan": "segment@iter=3"}).spec == "segment@iter=3"
    monkeypatch.setenv("SPLINK_TPU_FAULTS", "resident_em@kind=oom")
    assert resilience.active_plan({"fault_plan": "segment@iter=3"}).spec == "resident_em@kind=oom"
    assert resilience.active_plan({}) is resilience.active_plan(None)  # one live plan per spec


@pytest.mark.parametrize("exc, kind, oom", [
    (torch.cuda.OutOfMemoryError("CUDA out of memory. Tried to allocate 2.00 GiB"),
     "transient", True),
    (InjectedFault("resident_em", "oom", {}), "transient", True),
    (InjectedFault("batch_fetch", "transient", {}), "transient", False),
    (InjectedFault("em_iteration", "kill", {}), "deterministic", False),
    (RuntimeError("CUDA error: an illegal memory access was encountered\nCUDA kernel "
                  "errors might be asynchronously reported"), "deterministic", False),
    (RuntimeError("CUDA error: device-side assert triggered"), "deterministic", False),
    (ConnectionResetError("peer went away"), "transient", False),
    (TimeoutError("timed out"), "transient", False),
    (BrokenPipeError(), "transient", False),
    (RuntimeError("Connection reset by peer"), "transient", False),
    (ValueError("bad shape"), "deterministic", False),
    # XLA's status strings mean nothing to PyTorch
    (RuntimeError("RESOURCE_EXHAUSTED: out of HBM"), "deterministic", False),
], ids=lambda v: v if isinstance(v, str) else None)
def test_classify_error_and_is_oom(exc, kind, oom):
    assert resilience.classify_error(exc) == kind
    assert resilience.is_oom(exc) is oom


def test_retry_transient_then_success():
    calls, sleeps = [], []

    def flaky():
        calls.append(1)
        if len(calls) < 3:
            raise ConnectionResetError(f"drop {len(calls)}")
        return "ok"

    assert resilience.retry_call(flaky, policy=resilience.RetryPolicy(base_delay=0.1),
                                 sleep=sleeps.append) == "ok"
    assert len(calls) == 3 and sleeps == [0.1, 0.2]


def test_retry_never_retries_a_cuda_error():
    """A CUDA error leaves the context sticky: one attempt, propagated as is
    (a retry would hide a broken kernel)."""
    calls = []

    def broken():
        calls.append(1)
        raise RuntimeError("CUDA error: an illegal memory access was encountered")

    with pytest.raises(RuntimeError, match="illegal memory access"):
        resilience.retry_call(broken, sleep=lambda s: None)
    assert len(calls) == 1


@pytest.mark.parametrize("case", ["identical", "budget"])
def test_retry_gives_up(case):
    n = [0]

    def fail():
        n[0] += 1
        raise ConnectionResetError("same" if case == "identical" else f"drop {n[0]}")

    policy = resilience.RetryPolicy(max_retries=4)
    with pytest.raises(resilience.RetryError,
                       match="identical failures" if case == "identical" else "exhausted"):
        resilience.retry_call(fail, policy=policy, sleep=lambda s: None)
    assert n[0] == (3 if case == "identical" else 5)


# ----------------------------------------------------------------------
# checkpoint.py
# ----------------------------------------------------------------------

def _mk_ckpt(pkg=resilience, **over):
    kw = dict(state_hash="abc123", iteration=3, lam=0.25, m=[[0.9, 0.1]], u=[[0.2, 0.8]],
              histories={"lam": [0.2, 0.22, 0.24, 0.25], "m": [[[0.9, 0.1]]] * 4,
                         "u": [[[0.2, 0.8]]] * 4, "ll": None})
    kw.update(over)
    return pkg.EMCheckpoint(**kw)


@pytest.mark.parametrize("writer", ["splink_tpu", "splink_tpu_torch"])
def test_checkpoint_roundtrip_between_packages(tmp_path, writer):
    """Atomic write, exact float64 round trip, and the same file format in
    both packages: what one writes the other loads field for field."""
    w, r = (ref_res, resilience) if writer == "splink_tpu" else (resilience, ref_res)
    lam = 0.1 + 1e-17 * 3
    ck = _mk_ckpt(w, lam=lam, dtype="float64", m=[[1 / 3, 2 / 3]])
    path = w.save_checkpoint(tmp_path, ck)
    assert path == checkpoint_path(tmp_path)
    assert not [f for f in os.listdir(tmp_path) if f.endswith(".tmp")]
    got = r.load_checkpoint(tmp_path, expect_hash="abc123")
    assert got.lam == lam and got.m == [[1 / 3, 2 / 3]] and got.iteration == 3
    assert got.histories == ck.histories and got.dtype == "float64"
    lam_a, m_a, _ = got.params_arrays()
    assert lam_a.dtype == np.float64 and m_a[0, 0] == 1 / 3


def test_checkpoint_refusals(tmp_path):
    """Absent -> None; a hash or version mismatch is refused with
    CheckpointMismatchError; a corrupt file with CheckpointError."""
    assert resilience.load_checkpoint(tmp_path / "none") is None
    resilience.save_checkpoint(tmp_path, _mk_ckpt())
    with pytest.raises(resilience.CheckpointMismatchError, match="different job"):
        resilience.load_checkpoint(tmp_path, expect_hash="other")
    resilience.save_checkpoint(tmp_path, _mk_ckpt(version=CHECKPOINT_VERSION + 1))
    with pytest.raises(resilience.CheckpointMismatchError, match="version"):
        resilience.load_checkpoint(tmp_path)
    with open(checkpoint_path(tmp_path), "w") as f:
        f.write("{not json")
    with pytest.raises(CheckpointError, match="unreadable"):
        resilience.load_checkpoint(tmp_path)


def test_state_hash_binds_settings_and_rows():
    a = _port(_settings())
    assert a._em_state_hash() == _port(_settings(max_iterations=3))._em_state_hash()
    assert a._em_state_hash() != _port(_settings(em_convergence=1e-6))._em_state_hash()
    assert a._em_state_hash() != _port(_settings(), _df(140))._em_state_hash()


# ----------------------------------------------------------------------
# run_em_checkpointed and EMNumericsError
# ----------------------------------------------------------------------

def _em_inputs(seed=5, n=64):
    rng = np.random.default_rng(seed)
    G = rng.integers(-1, 3, size=(n, 3)).astype(np.int8)
    m = np.array([[0.1, 0.2, 0.7], [0.2, 0.3, 0.5], [0.1, 0.1, 0.8]], np.float32)
    u = np.array([[0.7, 0.2, 0.1], [0.6, 0.3, 0.1], [0.8, 0.1, 0.1]], np.float32)
    return G, np.float32(0.3), m, u


def _torch_params(lam, m, u):
    return FSParams(lam=torch.tensor(lam), m=torch.from_numpy(m), u=torch.from_numpy(u))


@pytest.mark.parametrize("compute_ll", [False, True])
def test_checkpointed_em_equals_run_em_bit_for_bit(tmp_path, compute_ll):
    """Same loop, a hook that only reads: every history array equal, and
    the checkpoint on disk holds the final update."""
    G, lam, m, u = _em_inputs()
    Gt = torch.from_numpy(G)
    kw = dict(max_iterations=12, max_levels=3, em_convergence=1e-9, compute_ll=compute_ll)
    want = run_em(Gt, _torch_params(lam, m, u), **kw)
    seen = []
    got = run_em_checkpointed(Gt, _torch_params(lam, m, u), checkpoint_dir=tmp_path,
                              state_hash="h", checkpoint_every=5,
                              on_segment=lambda done, h, c: seen.append(done), **kw)
    assert got.n_updates == want.n_updates == 12
    for name in ("lam_history", "m_history", "u_history", "ll_history"):
        np.testing.assert_array_equal(getattr(got, name), getattr(want, name), name)
    assert seen == [5, 10, 12]
    ck = resilience.load_checkpoint(tmp_path, expect_hash="h")
    assert ck.iteration == 12 and ck.lam == float(want.lam_history[12])


@pytest.mark.parametrize("pkg", ["splink_tpu", "splink_tpu_torch"])
def test_poisoned_update_raises_before_the_histories(tmp_path, pkg):
    """A NaN pair weight poisons update 1: EMNumericsError names iteration
    1, lam/m/u, last good iteration 0, and nothing poisoned was written —
    no checkpoint exists and the boundary hook never ran."""
    G, lam, m, u = _em_inputs()
    w = np.ones(len(G), np.float32)
    w[7] = np.nan
    seen = []
    kw = dict(max_iterations=4, max_levels=3, em_convergence=1e-4, compute_ll=True,
              checkpoint_dir=tmp_path, state_hash="h", checkpoint_every=1,
              on_segment=lambda *a: seen.append(a[0]))
    if pkg == "splink_tpu":
        init = RefFSParams(lam=jnp.asarray(lam), m=jnp.asarray(m), u=jnp.asarray(u))
        with pytest.raises(RefNumericsError) as e:
            ref_run_em_checkpointed(jnp.asarray(G), init, weights=jnp.asarray(w), **kw)
    else:
        with pytest.raises(EMNumericsError) as e:
            run_em_checkpointed(torch.from_numpy(G), _torch_params(lam, m, u),
                                weights=torch.from_numpy(w), **kw)
    err = e.value
    assert err.iteration == 1 and err.last_good_iteration == 0
    assert set(err.fields) >= {"lam", "m", "u"}
    assert err.last_checkpoint_iteration is None and seen == []
    assert not os.path.exists(checkpoint_path(tmp_path))


def test_late_poison_leaves_only_finite_state(tmp_path, monkeypatch):
    """An update that turns NaN at iteration 3: the histories the boundary
    hook saw and the checkpoint on disk stop at iteration 2, all finite, and
    the error names that checkpoint as the restart point."""
    from splink_tpu_torch import em as em_mod

    real = em_mod.update_params
    calls = [0]

    def poisoned(stats):
        calls[0] += 1
        new = real(stats)
        if calls[0] == 3:
            return new._replace(m=new.m * float("nan"))
        return new

    monkeypatch.setattr(em_mod, "update_params", poisoned)
    G, lam, m, u = _em_inputs()
    hist = {}

    def on_segment(done, h, conv):
        hist[done] = h["m"][: done + 1].copy()

    with pytest.raises(EMNumericsError) as e:
        run_em_checkpointed(torch.from_numpy(G), _torch_params(lam, m, u), max_iterations=6,
                            max_levels=3, em_convergence=1e-9, checkpoint_dir=tmp_path,
                            state_hash="h", checkpoint_every=2, on_segment=on_segment)
    assert e.value.iteration == 3 and e.value.fields == ["m"]
    assert e.value.last_checkpoint_iteration == 2
    assert list(hist) == [2] and np.isfinite(hist[2]).all()
    ck = resilience.load_checkpoint(tmp_path)
    assert ck.iteration == 2 and np.isfinite(np.asarray(ck.histories["m"])).all()


# ----------------------------------------------------------------------
# The linker: resume, refusals, retry, OOM fallback
# ----------------------------------------------------------------------

@pytest.mark.parametrize("regime", ["resident", "streamed"])
def test_resume_matches_uninterrupted(tmp_path, regime):
    """A 3-update run plus a resume to 8 equals a straight 8, bit for bit
    (the settings hash leaves out max_iterations)."""
    mk = _settings if regime == "resident" else _settings_streamed
    part = _port(mk(max_iterations=3))
    assert part._use_pattern_pipeline() is False
    part.estimate_parameters(checkpoint_dir=tmp_path)
    assert resilience.load_checkpoint(tmp_path).iteration == 3
    resumed = _port(mk())
    resumed.estimate_parameters(checkpoint_dir=tmp_path, resume=True)
    oracle = _port(mk())
    oracle.estimate_parameters()
    _assert_bit_identical(resumed, oracle)


@pytest.mark.parametrize("regime", ["resident", "streamed"])
def test_checkpointing_is_invisible(tmp_path, regime):
    mk = _settings if regime == "resident" else _settings_streamed
    with_ckpt = _port(mk(checkpoint_interval=3))
    with_ckpt.estimate_parameters(checkpoint_dir=tmp_path)
    plain = _port(mk())
    plain.estimate_parameters()
    _assert_bit_identical(with_ckpt, plain)
    assert resilience.load_checkpoint(tmp_path).iteration == 8


def test_streamed_em_follows_reference():
    """The streamed driver of both packages on the same frame: the same
    number of updates, lambda and m/u within 1e-5 (f32 sums in another
    order)."""
    ref = splink_tpu.Splink(_settings_streamed(), df=_df())
    ref.estimate_parameters()
    got = _port(_settings_streamed())
    got.estimate_parameters()
    assert len(got.params.param_history) == len(ref.params.param_history)
    want, have = ref.params.to_arrays(), got.params.to_arrays()
    for a, b in zip(want[:3], have[:3]):
        np.testing.assert_allclose(b, a, rtol=0, atol=1e-5)


def test_stale_checkpoint_and_resume_refusals(tmp_path):
    df = _df()
    _port(_settings(max_iterations=2), df).estimate_parameters(checkpoint_dir=tmp_path)
    other = _settings(comparison_columns=[
        {"col_name": "first_name", "num_levels": 2, "comparison": {"kind": "exact"}}])
    with pytest.raises(resilience.CheckpointMismatchError, match="different job"):
        _port(other, df).estimate_parameters(checkpoint_dir=tmp_path, resume=True)
    with pytest.raises(ValueError, match="checkpoint_dir"):
        _port(_settings(), df).estimate_parameters(resume=True)
    # a checkpoint of a run of two processes cannot resume here
    linker = _port(_settings(), df)
    resilience.save_checkpoint(tmp_path / "two", _mk_ckpt(
        state_hash=linker._em_state_hash(), process_count=2))
    with pytest.raises(RuntimeError, match="process"):
        linker.estimate_parameters(checkpoint_dir=tmp_path / "two", resume=True)


def test_resume_with_lowered_cap_returns_truncated_params(tmp_path):
    _port(_settings(max_iterations=6)).estimate_parameters(checkpoint_dir=tmp_path)
    lowered = _port(_settings(max_iterations=4))
    lowered.estimate_parameters(checkpoint_dir=tmp_path, resume=True)
    oracle = _port(_settings(max_iterations=4))
    oracle.estimate_parameters()
    _assert_bit_identical(lowered, oracle)


def test_resume_completed_run_keeps_true_log_likelihood(tmp_path):
    first = _port(_settings())
    first.estimate_parameters(compute_ll=True, checkpoint_dir=tmp_path)
    ll = first.params.params["log_likelihood"]
    assert np.isfinite(ll) and ll != 0.0
    again = _port(_settings())
    again.estimate_parameters(compute_ll=True, checkpoint_dir=tmp_path, resume=True)
    assert again.params.params["log_likelihood"] == ll


def test_transient_batch_fault_retried_bit_identical(monkeypatch):
    """A transient failure at batch 0 of pass 3 restarts the whole pass: the
    retried run equals an undisturbed one bit for bit."""
    from splink_tpu_torch.resilience import retry

    monkeypatch.setattr(retry.RetryPolicy, "base_delay", 0.01)
    flaky = _port(_settings_streamed(fault_plan="batch_fetch@iter=3:batch=0"))
    flaky.estimate_parameters()
    clean = _port(_settings_streamed())
    clean.estimate_parameters()
    _assert_bit_identical(flaky, clean)


def test_deterministic_stream_fault_aborts(monkeypatch):
    from splink_tpu_torch.resilience import retry

    monkeypatch.setattr(retry.RetryPolicy, "base_delay", 0.01)
    linker = _port(_settings_streamed(fault_plan="batch_fetch@iter=1:batch=0:times=99"))
    with pytest.raises(resilience.RetryError, match="identical failures"):
        linker.estimate_parameters()


@pytest.mark.parametrize("plan, checkpoint", [
    ("resident_em@kind=oom", False),
    # an OOM after boundaries replayed updates into the Params object: the
    # fallback restarts from the pre-attempt state (no update applied twice)
    ("segment@iter=4:kind=oom", True),
])
def test_resident_oom_degrades_to_streamed(tmp_path, plan, checkpoint):
    """An OOM entering (or during) resident EM takes the streamed regime on
    the same device with a DegradationWarning, bit-identical to the
    streamed driver run directly, and within 1e-5 of the resident run."""
    extra = {"checkpoint_interval": 2} if checkpoint else {}
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        degraded = _port(_settings(fault_plan=plan, **extra))
        degraded.estimate_parameters(checkpoint_dir=tmp_path if checkpoint else None)
    msgs = [str(w.message) for w in caught if issubclass(w.category, DegradationWarning)]
    assert msgs and "resident_em to streamed_em" in msgs[0], msgs
    streamed = _port(_settings())
    streamed._run_em_streamed(streamed._ensure_gammas(), False)
    _assert_bit_identical(degraded, streamed)
    resident = _port(_settings())
    resident.estimate_parameters()
    np.testing.assert_allclose(degraded.params.params["λ"], resident.params.params["λ"],
                               rtol=1e-5)


# ----------------------------------------------------------------------
# Kill and resume: a real SIGKILL through the fault plan, in a child
# ----------------------------------------------------------------------

_KILL_CHILD = _CUSTOM_EXACT + """
import json, sys
import pandas as pd
from splink_tpu_torch import Splink

df = pd.read_json(sys.argv[1], orient="split")
settings = json.load(open(sys.argv[2]))
Splink(settings, df=df, device="cpu").estimate_parameters(checkpoint_dir=sys.argv[3])
"""


def _run_kill_child(tmp_path, settings, df, fault_spec):
    df_json, settings_json = tmp_path / "df.json", tmp_path / "settings.json"
    ckpt_dir = tmp_path / "ckpt"
    df.to_json(df_json, orient="split")
    with open(settings_json, "w") as f:
        json.dump(settings, f)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = ROOT
    env["SPLINK_TPU_FAULTS"] = fault_spec
    proc = subprocess.run(
        [sys.executable, "-c", _KILL_CHILD, str(df_json), str(settings_json), str(ckpt_dir)],
        env=env, capture_output=True, timeout=240,
    )
    # the child died from the injected SIGKILL, not some other way
    assert proc.returncode == -signal.SIGKILL, (
        proc.returncode, proc.stderr.decode(errors="replace")[-2000:])
    assert os.path.exists(checkpoint_path(ckpt_dir)), "no durable checkpoint"
    return ckpt_dir


@pytest.mark.parametrize("case", ["streamed", "resident", "streamed_converging"])
def test_kill_and_resume_bit_identical(tmp_path, case):
    """Streamed EM killed after update 4 (the checkpoint hook runs before
    the em_iteration site), resident checkpointed EM killed at the boundary
    of update 5, and streamed EM killed AT its converging update (the
    checkpoint records the convergence, so the resume adds nothing): each
    resumes to the uninterrupted run's exact parameters and history."""
    df = _df()
    if case == "streamed":
        settings, spec, at = _settings_streamed(checkpoint_interval=1), "em_iteration@iter=4:kind=kill", 4
    elif case == "resident":
        settings, spec, at = _settings(checkpoint_interval=5), "segment@iter=5:kind=kill", 5
    else:
        # 0.05 is the loosest schema-valid em_convergence; on this frame the
        # streamed driver converges on update 4
        settings = _settings_streamed(checkpoint_interval=1, em_convergence=0.05)
        spec, at = "em_iteration@iter=4:kind=kill", 4
    ckpt_dir = _run_kill_child(tmp_path, settings, df, spec)
    ck = resilience.load_checkpoint(ckpt_dir)
    assert ck.iteration == at
    assert ck.converged is (case == "streamed_converging")
    resumed = _port(settings, df)
    resumed.estimate_parameters(checkpoint_dir=ckpt_dir, resume=True)
    oracle = _port(settings, df)
    oracle.estimate_parameters()
    _assert_bit_identical(resumed, oracle)
