"""The three measured analysis layers of splink_tpu_torch: their own cases.

The cases of tests/test_trace_audit.py, tests/test_perf_audit.py and
tests/test_num_audit.py, run through the port on the CPU: each invariant
catches a planted offender (a float64 leak, host data past the budget, an
undeclared sync, a nondeterministic op sequence, a kernel that raises, a
doctored time, a doctored memory figure, a missing baseline, ulp drift, a
NaN escape), the sanctioned patterns pass, and a baseline refresh keeps
the other tiers' blocks. Then a clean run of the trace and num audits over
the whole registry, and the committed baselines' shape.

Timing: no test gates a measured time against a committed file; the perf
cases measure fresh baselines into memory or ``tmp_path`` on one cheap
kernel, with the absolute noise floors monkeypatched where a finding must
fire.
"""

import copy
import json
import math
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from splink_tpu_torch.analysis import num_audit as na  # noqa: E402
from splink_tpu_torch.analysis import perf_audit as pa  # noqa: E402
from splink_tpu_torch.analysis import trace_audit as ta  # noqa: E402
from splink_tpu_torch.analysis.trace_audit import (  # noqa: E402
    DEFAULT_ALLOWED_DTYPES,
    REGISTRY,
    KernelSpec,
    audit_kernel,
    register_kernel,
)

CPU = "cpu"
ta._ensure_default_registry()


def _spec(build, **kw):
    return KernelSpec(name="probe", build=build, **kw)


def _rules(findings):
    return sorted({f.rule for f in findings})


# ---------------------------------------------------------------------------
# trace audit
# ---------------------------------------------------------------------------


def test_const_budget_catches_host_data_inside_the_call():
    big = np.zeros((64, 1024), np.float32)  # 256 KiB

    def build(device):
        return (lambda x: x + torch.from_numpy(big)), (torch.zeros((64, 1024)),), {}

    findings = audit_kernel(_spec(build, const_budget_bytes=1 << 16), CPU)
    assert _rules(findings) == ["TA-CONST"]
    assert "262144 bytes" in findings[0].message
    # the budget is the knob, not the check
    assert audit_kernel(_spec(build, const_budget_bytes=1 << 20), CPU) == []


def test_const_as_argument_passes():
    def build(device):
        big = torch.zeros((64, 1024))
        return (lambda table, x: x + table), (big, big), {}

    assert audit_kernel(_spec(build, const_budget_bytes=1 << 16), CPU) == []


def test_dtype_audit_catches_float64():
    def build(device):
        return (lambda x: x.to(torch.float64).sum()), (torch.zeros(8),), {}

    findings = audit_kernel(_spec(build), CPU)
    assert _rules(findings) == ["TA-DTYPE"]
    assert "float64" in findings[0].message


def test_dtype_allowlist_is_per_kernel():
    def build(device):
        return (lambda x: x.to(torch.float64).sum()), (torch.zeros(8),), {}

    allowed = DEFAULT_ALLOWED_DTYPES | {"float64"}
    assert audit_kernel(_spec(build, allow_dtypes=allowed), CPU) == []


def test_python_scalars_are_exempt():
    # the Python literal is wrapped as a 0-d tensor that adapts to the
    # float32 operand: not a leak
    def build(device):
        return (lambda x: torch.where(x > 0, x * 0.5, 0.25)), (torch.zeros(8),), {}

    assert audit_kernel(_spec(build), CPU) == []


def test_undeclared_sync_is_a_finding():
    def build(device):
        return (lambda x: x + float(x.sum())), (torch.zeros(8),), {}

    findings = audit_kernel(_spec(build), CPU)
    assert _rules(findings) == ["TA-CALLBACK"]
    assert "_local_scalar_dense" in findings[0].message
    # declared, per tier or for every tier, it passes
    assert audit_kernel(_spec(build, allow_syncs=1), CPU) == []
    assert audit_kernel(_spec(build, allow_syncs={"cpu": 1, "cuda": 1}), CPU) == []
    assert _rules(audit_kernel(_spec(build, allow_syncs={"cuda": 1}), CPU)) == ["TA-CALLBACK"]


def test_reading_host_data_is_not_a_sync():
    # a Python number round-tripped through a host tensor waits for no
    # device (ops/gamma.py's threshold rounding)
    def build(device):
        return (lambda x: x > torch.tensor(0.94, dtype=torch.float32).item()), \
            (torch.zeros(8),), {}

    spec = _spec(build)
    assert audit_kernel(spec, CPU) == []
    assert spec.cache[("record", "cpu")].syncs == []


def test_sync_sites_name_the_line():
    spec = REGISTRY["block_segment_sort"]
    assert audit_kernel(spec, CPU) == []
    rec = spec.cache[("record", "cpu")]
    assert rec.syncs == ["aten.nonzero.default"]
    assert rec.sync_sites[0].startswith("splink_tpu_torch/blocking_device.py:")


def test_hash_audit_catches_a_nondeterministic_op_sequence():
    import itertools

    counter = itertools.count()

    def build(device):
        # every other call takes another branch: the op sequence is not a
        # function of the inputs alone
        return (lambda x: x + 1 if next(counter) % 2 else x * 2), (torch.zeros(4),), {}

    assert "TA-HASH" in _rules(audit_kernel(_spec(build), CPU))


def test_hash_audit_sees_hand_kernel_launches(monkeypatch):
    # ctypes launches are invisible to the dispatch recorder: their counts
    # fold into the record, so a kernel launched on one call only differs
    from splink_tpu_torch.ops import strings_cuda

    monkeypatch.setattr(strings_cuda, "variant_launches", {})
    calls = {"n": 0}

    def fn(x):
        calls["n"] += 1
        if calls["n"] == 1:
            key = "jaro_winkler/u8/w1"
            strings_cuda.variant_launches[key] = strings_cuda.variant_launches.get(key, 0) + 1
        return x + 1

    spec = _spec(lambda device: (fn, (torch.zeros(4),), {}))
    findings = audit_kernel(spec, CPU)
    assert _rules(findings) == ["TA-HASH"]
    ops = [op[0] for op in spec.cache[("record", "cpu")].ops]
    assert "strings_cuda.jaro_winkler/u8/w1" in ops


def test_kernel_that_raises_is_a_finding_not_a_crash():
    def build(device):
        return (lambda x: undefined_name + x), (torch.zeros(1),), {}  # noqa: F821

    assert _rules(audit_kernel(_spec(build), CPU)) == ["TA-ERROR"]


def test_builder_cached_across_audits():
    calls = {"n": 0}

    def build(device):
        calls["n"] += 1
        return (lambda x: x * 2), (torch.zeros(4),), {}

    spec = _spec(build)
    assert audit_kernel(spec, CPU) == []
    assert audit_kernel(spec, CPU) == []
    assert calls["n"] == 1
    assert ("record", "cpu") in spec.cache


def test_duplicate_registration_rejected():
    @register_kernel("test_dup_kernel_xyz")
    def _build(device):
        return (lambda x: x), (torch.zeros(1),), {}

    try:
        with pytest.raises(ValueError):

            @register_kernel("test_dup_kernel_xyz")
            def _build2(device):
                return (lambda x: x), (torch.zeros(1),), {}
    finally:
        REGISTRY.pop("test_dup_kernel_xyz", None)


def test_default_device_is_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default resolves to it")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ta.run_audit(["score_pairs"])


# ---------------------------------------------------------------------------
# perf audit
# ---------------------------------------------------------------------------


def _measured_baselines(names, best_of=2):
    kernels = {}
    for cell in pa.perf_plan(names, CPU):
        kernels.setdefault(cell.kernel, {})[cell.label] = pa.measure_cell(
            cell, best_of=best_of, device=CPU)
    return {"tiers": {CPU: {"kernels": kernels}}}


@pytest.fixture(scope="module")
def tf_gather_baselines():
    """One cheap kernel (reg + x4) measured once for the module."""
    return _measured_baselines(["tf_gather"])


def test_perf_plan_covers_registry():
    plan = pa.perf_plan(tier=CPU)
    assert {c.kernel for c in plan} == set(REGISTRY) - set(pa.PERF_EXCLUDED)
    by_kernel = {}
    for c in plan:
        by_kernel.setdefault(c.kernel, []).append(c.label)
    for name, labels in by_kernel.items():
        assert labels == ["reg"] + [f"x{f}" for f in pa.PERF_SCALES.get(name, (0, ()))[1]]
    # the card adds one full-size scale per listed kernel
    cuda = {c.kernel: c.label for c in pa.perf_plan(tier="cuda")}
    for name, factor in pa.CUDA_SCALES.items():
        assert f"x{factor}" in [c.label for c in pa.perf_plan([name], "cuda")]
        assert name in cuda
    assert len(pa.perf_plan(tier="cuda")) == len(plan) + len(pa.CUDA_SCALES)
    with pytest.raises(KeyError):
        pa.perf_plan(["no_such_kernel"])


def test_scaled_inputs_tile_only_the_batch_axis():
    _, args, kwargs = REGISTRY["serve_score_fused"].built(CPU)
    packed_q, packed_ref, cand, valid, params = args
    s_args, _ = pa._scaled_args("serve_score_fused", args, kwargs, 4)
    assert s_args[0].shape[0] == packed_q.shape[0] * 4
    assert s_args[1].shape == packed_ref.shape  # the reference table: untouched
    assert s_args[2].shape[0] == cand.shape[0] * 4
    assert s_args[4].m.shape == params.m.shape
    assert s_args[2].dtype == cand.dtype
    same, _ = pa._scaled_args("serve_score_fused", args, kwargs, 1)
    assert same[0].shape == packed_q.shape


def test_measure_cell_records_all_metrics(tf_gather_baselines):
    rec = tf_gather_baselines["tiers"][CPU]["kernels"]["tf_gather"]["reg"]
    assert rec["compile_ms"] > 0
    assert rec["execute_ms"] > 0
    assert rec["argument_bytes"] == 512 * 4 * 2 + 256 * 8
    assert rec["output_bytes"] == 512 * 8
    # the CPU records no device memory: null by design
    assert rec["temp_bytes"] is None and rec["peak_device_bytes"] is None


def test_fresh_baseline_audits_clean(tf_gather_baselines):
    findings, n = pa.run_perf_audit(["tf_gather"], tf_gather_baselines, best_of=2,
                                    remeasure=2, device=CPU)
    assert n == 2  # reg + x4
    assert findings == []


def test_inflated_baseline_stays_clean_one_sided(tf_gather_baselines):
    inflated = copy.deepcopy(tf_gather_baselines)
    for shapes in inflated["tiers"][CPU]["kernels"].values():
        for rec in shapes.values():
            for key in ("compile_ms", "execute_ms", "argument_bytes", "output_bytes"):
                rec[key] = rec[key] * 100 + 1000
    findings, _ = pa.run_perf_audit(["tf_gather"], inflated, best_of=2, remeasure=2,
                                    device=CPU)
    assert findings == []


def test_doctored_time_baseline_fires_pa_time(tf_gather_baselines, monkeypatch):
    monkeypatch.setattr(pa, "EXECUTE_ATOL_MS", 0.0)
    doctored = copy.deepcopy(tf_gather_baselines)
    kern = doctored["tiers"][CPU]["kernels"]["tf_gather"]
    kern["reg"]["execute_ms"] = kern["reg"]["execute_ms"] / 1000.0
    findings, _ = pa.run_perf_audit(["tf_gather"], doctored, best_of=2, remeasure=2,
                                    device=CPU)
    time_findings = [f for f in findings if f.rule == "PA-TIME"]
    assert time_findings, findings
    assert "execute_ms" in time_findings[0].message
    assert "median of 2 re-runs" in time_findings[0].message
    assert time_findings[0].path == "tf_gather@reg"
    findings, _ = pa.run_perf_audit(["tf_gather"], tf_gather_baselines, best_of=2,
                                    remeasure=2, device=CPU)
    assert [f for f in findings if f.rule == "PA-TIME"] == []


def test_doctored_mem_baseline_fires_pa_mem(tf_gather_baselines):
    doctored = copy.deepcopy(tf_gather_baselines)
    kern = doctored["tiers"][CPU]["kernels"]["tf_gather"]
    kern["x4"]["argument_bytes"] = kern["x4"]["argument_bytes"] / 10.0
    findings, _ = pa.run_perf_audit(["tf_gather"], doctored, best_of=2, remeasure=2,
                                    device=CPU)
    mem = [f for f in findings if f.rule == "PA-MEM"]
    assert mem and "argument_bytes" in mem[0].message
    assert mem[0].path == "tf_gather@x4"
    # a doctored device figure gates only where both sides recorded one
    cell = pa.PerfShape("tf_gather", "reg", 1)
    base = dict(tf_gather_baselines["tiers"][CPU]["kernels"]["tf_gather"]["reg"])
    measured = dict(base, temp_bytes=4096.0, peak_device_bytes=8192)
    doctored_dev = dict(base, temp_bytes=1024.0, peak_device_bytes=1024)
    rules = [f.format() for f in pa.audit_cell(cell, doctored_dev, device=CPU,
                                               measured=measured)]
    assert any("temp_bytes" in r for r in rules)
    assert any("peak_device_bytes" in r for r in rules)
    assert pa.audit_cell(cell, base, device=CPU, measured=dict(base)) == []


def test_missing_baseline_fires_pa_base(tf_gather_baselines):
    findings, _ = pa.run_perf_audit(["tf_gather"], {"tiers": {}}, best_of=2, remeasure=2,
                                    device=CPU)
    assert {f.rule for f in findings} == {"PA-BASE"}
    assert len(findings) == 2
    other = {"tiers": {"cuda": copy.deepcopy(tf_gather_baselines["tiers"][CPU])}}
    findings, _ = pa.run_perf_audit(["tf_gather"], other, best_of=2, remeasure=2,
                                    device=CPU)
    assert {f.rule for f in findings} == {"PA-BASE"}


def test_kernel_that_raises_is_pa_error(monkeypatch):
    spec = KernelSpec(name="perf_raiser",
                      build=lambda device: ((lambda x: x.no_such_method()),
                                            (torch.zeros(2),), {}))
    monkeypatch.setitem(REGISTRY, "perf_raiser", spec)
    findings, n = pa.run_perf_audit(["perf_raiser"], {"tiers": {}}, device=CPU)
    assert n == 1 and _rules(findings) == ["PA-ERROR"]


def test_update_perf_baselines_keeps_other_tiers(tmp_path):
    path = tmp_path / "perf_baselines.json"
    path.write_text(json.dumps({
        "tiers": {"cuda": {"kernels": {"tf_gather": {"reg": {"execute_ms": 1.0}}}}},
    }))
    new = pa.update_baselines(["tf_gather"], str(path), best_of=2, device=CPU)
    assert new["tiers"]["cuda"] == {"kernels": {"tf_gather": {"reg": {"execute_ms": 1.0}}}}
    assert "tf_gather" in new["tiers"][CPU]["kernels"]
    on_disk = json.loads(path.read_text())
    assert on_disk["tiers"][CPU]["_meta"]["device"].startswith("cpu")
    findings, _ = pa.run_perf_audit(["tf_gather"], on_disk, best_of=2, remeasure=2,
                                    device=CPU)
    assert findings == []


def test_committed_perf_baselines_cover_both_tiers():
    """The committed file carries a cpu block over the cpu plan and a cuda
    block over the cuda plan, the latter naming the card and its power
    limit (measuring here would put container noise inside tier-1)."""
    baselines = pa.load_baselines()
    for tier in (CPU, "cuda"):
        block = baselines["tiers"][tier]
        for cell in pa.perf_plan(tier=tier):
            rec = block["kernels"].get(cell.kernel, {}).get(cell.label)
            assert rec is not None, f"missing committed cell {tier} {cell.kernel}@{cell.label}"
            assert rec["execute_ms"] > 0 and rec["compile_ms"] > 0
            assert (rec["peak_device_bytes"] is None) == (tier == CPU)
    meta = baselines["tiers"]["cuda"]["_meta"]
    assert "H100" in meta["device"] and " W" in meta["nvidia_smi"]


def test_excluded_kernels_documented():
    for name, reason in pa.PERF_EXCLUDED.items():
        assert name in REGISTRY and reason
    listing = pa.format_plan(pa.perf_plan())
    assert "em_step_checkpointed" in listing and "excluded" in listing


# ---------------------------------------------------------------------------
# num audit
# ---------------------------------------------------------------------------


def test_num_plan_covers_registry_and_model_checks():
    plan = na.num_plan()
    assert set(plan) == set(REGISTRY) | set(na.MODEL_CHECKS)
    with pytest.raises(KeyError):
        na.num_plan(["does_not_exist"])


def test_committed_num_baselines_cover_every_kernel_on_both_tiers():
    tiers = na.load_baselines()["tiers"]
    for tier in (CPU, "cuda"):
        budgets = tiers[tier]["kernels"]
        assert set(budgets) == set(REGISTRY), tier
        for name, cell in budgets.items():
            assert cell["ulp_budget"] >= 0, name
            assert cell["corners"][0] == "registered", name
        # the hand kernels' float64 arm is the plain version, and says so
        for name in ("jaro_winkler", "levenshtein"):
            assert "plain" in budgets[name]["f64_arm"]
    assert "H100" in tiers["cuda"]["_meta"]["device"]


def test_missing_budget_is_na_base():
    findings = na.audit_kernel_numerics(REGISTRY["tf_gather"], None, CPU)
    assert [f.rule for f in findings] == ["NA-BASE"]
    assert "num-baselines" in findings[0].hint


def test_ulp_drift_fails_with_a_diff_style_message():
    findings = na.audit_kernel_numerics(REGISTRY["tf_gather"], {"ulp_budget": -1.0}, CPU)
    rendered = "\n".join(f.format() for f in findings)
    assert "NA-ULP" in rendered
    assert "ulp: budget" in rendered and "measured" in rendered


def test_em_drift_is_measured_against_its_float64_run():
    # EM at float32 against float64 moves by tens of ulps (the reference's
    # CPU budget is 24): a budget below that trips NA-ULP
    measured = na._measure_ulp(REGISTRY["em_step"], CPU)
    assert 1 <= measured < 64
    findings = na.audit_kernel_numerics(REGISTRY["em_step"], {"ulp_budget": 0.0}, CPU)
    assert "NA-ULP" in _rules(findings)


class _NaNSpec:
    """A registry spec stand-in whose kernel leaks a NaN."""

    name = "nan_leaker"
    f64_fn = None

    def built(self, device=None):
        return (lambda x: torch.log(x - 1.0) - torch.log(x - 1.0)), (torch.ones(4),), {}


def test_nan_escape_is_na_fin():
    findings = na.audit_kernel_numerics(_NaNSpec(), {"ulp_budget": 1e9}, CPU)
    assert "NA-FIN" in _rules(findings)
    assert "registered" in next(f for f in findings if f.rule == "NA-FIN").message


def test_subnormal_probability_escape_is_na_fin(monkeypatch):
    # the denormal corner: a probability that leaves unflushed is a finding
    from splink_tpu_torch.models import fellegi_sunter as fs

    monkeypatch.setattr(fs, "flush_subnormal", lambda x: torch.full_like(x, 1e-40))
    findings = na.audit_kernel_numerics(REGISTRY["score_pairs"], {"ulp_budget": 1e9}, CPU)
    fin = [f for f in findings if f.rule == "NA-FIN"]
    assert fin and "denormal" in fin[0].message and "sub-normal" in fin[0].message


def test_mono_gate_is_falsifiable(monkeypatch):
    from splink_tpu_torch.models import fellegi_sunter as fs

    orig = fs.match_probability
    monkeypatch.setattr(fs, "match_probability", lambda G, p: 1.0 - orig(G, p))
    assert "NA-MONO" in _rules(na._check_monotone(CPU))


def test_ord_gate_is_falsifiable(monkeypatch):
    from splink_tpu_torch.models import fellegi_sunter as fs

    orig = fs.fold_logit
    monkeypatch.setattr(fs, "fold_logit", lambda G, p: orig(G, p) + 1e-4)
    findings = na._check_fold_order(CPU)
    assert [f.rule for f in findings] == ["NA-ORD"]
    assert "left-to-right" in findings[0].message


def test_corner_transforms_only_touch_their_leaves():
    assert na._corner_all_null((torch.ones(3),)) is None
    mutated = na._corner_all_null((torch.zeros((2, 3), dtype=torch.int8), torch.ones(3)))
    assert (mutated[0] == -1).all() and (mutated[1] == 1.0).all()
    assert na._corner_empty((torch.ones(3),)) is None
    assert not na._corner_empty((torch.ones(4, dtype=torch.bool),))[0].any()


def test_prob_extremes_hits_exact_zero_and_one():
    _, params = ta.shared_fs_inputs(CPU)
    (new,) = na._corner_prob_extremes((params,))
    assert float(new.lam) == 0.0
    assert (new.m[:, 0] == 1.0).all() and (new.m[:, 1:] == 0.0).all()
    assert (params.m == 1.0 / 3).all()  # the registered inputs are untouched


def test_update_num_baselines_keeps_other_tiers(tmp_path):
    path = os.path.join(str(tmp_path), "num_baselines.json")
    foreign = {"tiers": {"cuda": {"_meta": {"device": "a card"},
                                  "kernels": {"k": {"ulp_budget": 5.0}}}}}
    with open(path, "w") as fh:
        json.dump(foreign, fh)
    payload = na.update_baselines(names=["tf_gather"], path=path, device=CPU)
    with open(path) as fh:
        on_disk = json.load(fh)
    assert on_disk == payload
    assert on_disk["tiers"]["cuda"] == foreign["tiers"]["cuda"]
    cell = on_disk["tiers"][CPU]["kernels"]["tf_gather"]
    assert cell["ulp_budget"] == math.ceil(cell["ulp_budget"])


def test_em_history_padding_is_contract_not_finding():
    from splink_tpu_torch.em import run_em

    G, params = ta.shared_fs_inputs(CPU)
    out = run_em(G, params, max_iterations=2, max_levels=3, em_convergence=1e-4,
                 compute_ll=True)
    assert na._finite_em(out) == []
    ll = out.ll_history.copy()
    ll[0] = np.nan
    assert na._finite_em(out._replace(ll_history=ll))


def test_hand_kernels_float64_arm_is_the_plain_version():
    for name in ("jaro_winkler", "levenshtein"):
        spec = REGISTRY[name]
        _, args, kwargs = spec.built(CPU)
        out = spec.f64_fn(*args, **kwargs)
        assert out.dtype == torch.float64
        want = spec.built(CPU)[0](*args, **kwargs)
        np.testing.assert_array_equal(out.numpy().astype(np.float32), want.numpy())


# ---------------------------------------------------------------------------
# the whole registry, clean
# ---------------------------------------------------------------------------


def test_trace_audit_of_the_whole_registry_is_clean():
    findings, n = ta.run_audit(device=CPU)
    assert n == 29
    assert findings == [], "\n".join(f.format() for f in findings)


def test_num_audit_of_the_whole_registry_is_clean():
    findings, n = na.run_num_audit(device=CPU)
    assert n == 31
    assert findings == [], "\n".join(f.format() for f in findings)


def test_denormal_corner_agrees_with_the_reference():
    # the port's flush_subnormal stands in for XLA's flush-to-zero: in the
    # denormal corner the port's probabilities equal the reference's
    import jax.numpy as jnp

    from splink_tpu.em import score_pairs as ref_score_pairs
    from splink_tpu.models.fellegi_sunter import FSParams as RefParams

    fn, args, _ = REGISTRY["score_pairs"].built(CPU)
    G, params = na._corner_denormal(args)
    got = fn(G, params).numpy()
    sub = jnp.asarray(np.float32(1e-39))
    want = np.asarray(ref_score_pairs(
        jnp.asarray(G.numpy()),
        RefParams(lam=sub, m=jnp.full((3, 3), sub), u=jnp.full((3, 3), sub)),
    ))
    tiny = np.finfo(np.float32).tiny
    assert not ((np.abs(got) > 0) & (np.abs(got) < tiny)).any()
    np.testing.assert_array_equal(got, want)
