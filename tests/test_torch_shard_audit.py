"""splink_tpu_torch.analysis.shard_audit: the counterparts of
tests/test_shard_audit.py and of test_codebase_clean.py's shard-audit gate,
plus parity with splink_tpu's shard registry.

Each SA-* invariant catches its crafted offender (the bad fixtures below,
the port's counterparts of tests/fixtures/shard_audit/), the clean twins
pass, budget drift renders diff-style, and the registry machinery behaves.
The fixtures register into module-local registries, never the package's.
The package registry audits clean on the CPU against the committed ``cpu``
tier. Parity: the kernels with an empty collective budget are the
reference's; for four kernels the port's sharded outputs on the
reference's numpy inputs match the reference's on its 8 CPU devices
(discrete outputs bit for bit, floats within the ulp bound below).
"""

import json
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from splink_tpu_torch.analysis import shard_audit  # noqa: E402
from splink_tpu_torch.analysis.shard_audit import (  # noqa: E402
    SHARD_REGISTRY,
    ShardKernelSpec,
    audit_mesh,
    audit_shard_kernel,
    load_baselines,
    measure_shard_kernel,
    register_shard_kernel,
    run_shard_audit,
    update_baselines,
)
from splink_tpu_torch.parallel.mesh import (  # noqa: E402
    Sharded,
    pair_sharding,
    reduce_shards,
    shard_pairs,
)

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU = "cpu"
# the bounds on float outputs against the reference's 8-device run, in
# float32 ulp: elementwise outputs (scores, similarities) 4; sums over the
# pair axis 32 (sqrt(1024): the reference's per-device einsum and psum and
# the port's per-shard product and shard-order sum add the same 1,024
# non-negative terms in different orders)
FLOAT_ULP = 4
SUM_ULP = 32


def _rules(findings):
    return sorted({f.rule for f in findings})


def _rows(n, seed=0):
    return np.random.default_rng(seed).integers(0, 3, size=(n, 3)).astype(np.int8)


# ---------------------------------------------------------------------------
# fixture corpora: each bad kernel trips one SA-* invariant; the good ones
# are its clean twins
# ---------------------------------------------------------------------------

BAD: dict = {}
GOOD: dict = {}


# SA-SPEC: the "widened PartitionSpec" — a pair-axis array handed to the
# kernel whole, so every shard holds (and processes) the full batch
@register_shard_kernel("widened_pspec", n_pairs=512, registry=BAD)
def _build_widened_pspec(device):
    G = torch.zeros((512, 3), dtype=torch.int8, device=device)
    return (lambda G: G.to(torch.float32) * 2.0), (G,), {}


# SA-COLL: a reduction over the sharded pair axis in a kernel whose
# collective allowlist is empty
@register_shard_kernel("undeclared_collective", n_pairs=512, registry=BAD)
def _build_undeclared_collective(device):
    x = pair_sharding(audit_mesh(device=device), np.ones((512, 3), np.float32))
    return (lambda x: reduce_shards([s.sum(0) for s in x.shards])), (x,), {}


# SA-PAD: a stats-style kernel that accepts the shard_pairs padding weights
# but never threads them into its reduction — padded rows count
@register_shard_kernel("dropped_weights", n_pairs=512, allow_collectives=("reduce",),
                       pad_weights_argnum=1, registry=BAD)
def _build_dropped_weights(device):
    G, w = shard_pairs(audit_mesh(device=device), _rows(509))
    fn = lambda G, w: reduce_shards([g.to(torch.float32).sum(0) for g in G.shards])  # noqa: E731
    return fn, (G, w), {}


# SA-COLL: the gather — one op over every shard's rows at once
@register_shard_kernel("cross_shard_gather", n_pairs=512, registry=BAD)
def _build_cross_shard_gather(device):
    x = pair_sharding(audit_mesh(device=device), np.ones((512, 3), np.float32))
    return (lambda x: torch.cat(x.shards).sum(0)), (x,), {}


# the pair-axis array carries the pair sharding; an elementwise kernel:
# zero collectives, the output stays sharded
@register_shard_kernel("pair_sharded_map", n_pairs=512, registry=GOOD)
def _build_pair_sharded_map(device):
    G = pair_sharding(audit_mesh(device=device), _rows(512))
    return (lambda G: Sharded(tuple(g.to(torch.float32) * 2.0 for g in G.shards))), (G,), {}


# a cross-shard reduction with the reduce DECLARED and the padding weights
# threaded through it
@register_shard_kernel("weighted_reduce", n_pairs=512, allow_collectives=("reduce",),
                       pad_weights_argnum=1, registry=GOOD)
def _build_weighted_reduce(device):
    G, w = shard_pairs(audit_mesh(device=device), _rows(509))

    def fn(G, w):
        return reduce_shards([(g.to(torch.float32) * v[:, None]).sum(0)
                              for g, v in zip(G.shards, w.shards)])

    return fn, (G, w), {}


# replicated scalar/parameter inputs are fine — only pair-axis arrays shard
@register_shard_kernel("replicated_params_map", n_pairs=512, registry=GOOD)
def _build_replicated_params_map(device):
    x = pair_sharding(audit_mesh(device=device), np.ones(512, np.float32))
    scale = torch.tensor(3.0, dtype=torch.float32, device=device)
    return (lambda x, s: Sharded(tuple(p * s for p in x.shards))), (x, scale), {}


# ---------------------------------------------------------------------------
# bad corpus: every invariant falsified
# ---------------------------------------------------------------------------


def test_bad_corpus_trips_every_invariant():
    findings, audited = run_shard_audit(registry=BAD, baselines={}, device=CPU)
    assert audited == 4
    # SA-COST fires as missing-baseline (fixtures are never committed)
    assert set(_rules(findings)) >= {"SA-SPEC", "SA-COLL", "SA-PAD", "SA-COST"}


def test_widened_partition_spec_is_a_spec_finding():
    findings = audit_shard_kernel(BAD["widened_pspec"], baseline=None, device=CPU)
    spec_findings = [f for f in findings if f.rule == "SA-SPEC"]
    assert spec_findings, _rules(findings)
    # file:kernel:invariant shape
    line = spec_findings[0].format()
    assert "test_torch_shard_audit.py" in line and ":widened_pspec:" in line
    assert "SA-SPEC" in line and "not sharded" in line


def test_undeclared_collective_is_a_coll_finding():
    findings = audit_shard_kernel(BAD["undeclared_collective"], baseline=None, device=CPU)
    coll = [f for f in findings if f.rule == "SA-COLL"]
    assert coll and "1x reduce" in coll[0].message


def test_dropped_weights_is_a_pad_finding():
    findings = audit_shard_kernel(BAD["dropped_weights"], baseline=None, device=CPU)
    assert "SA-PAD" in _rules(findings)


def test_gather_is_always_a_coll_finding():
    findings = audit_shard_kernel(BAD["cross_shard_gather"], baseline=None, device=CPU)
    coll = [f for f in findings if f.rule == "SA-COLL"]
    assert coll and "gather" in coll[0].message and "aten.cat" in coll[0].message
    # and no kernel may declare one
    with pytest.raises(ValueError, match="gather is always a finding"):
        register_shard_kernel("x", n_pairs=8, allow_collectives=("gather",), registry={})


# ---------------------------------------------------------------------------
# good corpus: measure -> audit round-trips clean
# ---------------------------------------------------------------------------


def test_good_corpus_passes_with_measured_baselines():
    baselines = {"kernels": {name: measure_shard_kernel(spec, CPU)
                             for name, spec in GOOD.items()}}
    findings, audited = run_shard_audit(registry=GOOD, baselines=baselines, device=CPU)
    assert audited == 3
    assert findings == [], "\n".join(f.format() for f in findings)


# ---------------------------------------------------------------------------
# budget drift
# ---------------------------------------------------------------------------


def _good_spec_and_baseline(name="weighted_reduce"):
    spec = GOOD[name]
    return spec, measure_shard_kernel(spec, CPU)


def test_cost_drift_fails_with_diff_style_message():
    spec, baseline = _good_spec_and_baseline()
    drifted = dict(baseline)
    drifted["ops"] = float(baseline["ops"]) * 10 + 100
    findings = audit_shard_kernel(spec, drifted, device=CPU)
    cost = [f for f in findings if f.rule == "SA-COST"]
    assert cost, _rules(findings)
    msg = cost[0].message
    assert "ops: baseline" in msg and "measured" in msg and "%" in msg


def test_cost_within_tolerance_passes():
    spec, baseline = _good_spec_and_baseline()
    nudged = dict(baseline)
    nudged["temp_size_in_bytes"] = nudged["temp_size_in_bytes"] * 1.05  # inside 25%
    assert audit_shard_kernel(spec, nudged, device=CPU) == []


def test_deleted_psum_budget_drift_is_a_coll_finding():
    spec, baseline = _good_spec_and_baseline()
    drifted = dict(baseline)
    counts = dict(drifted.get("collectives", {}))
    counts["reduce"] = counts.get("reduce", 0) + 1  # one reduction gone
    drifted["collectives"] = counts
    findings = audit_shard_kernel(spec, drifted, device=CPU)
    coll = [f for f in findings if f.rule == "SA-COLL"]
    assert coll and "budget drift" in coll[0].message


def test_missing_baseline_is_a_cost_finding():
    spec, _ = _good_spec_and_baseline()
    findings = audit_shard_kernel(spec, baseline=None, device=CPU)
    assert _rules(findings) == ["SA-COST"]
    assert "--update-baselines" in findings[0].hint


def test_per_shard_outputs_must_equal_the_unsharded_call():
    # a per-shard kernel that reads the wrong piece: SA-SPEC against the
    # unsharded call it declares
    reg: dict = {}

    @register_shard_kernel("shifted", n_pairs=64, registry=reg)
    def _b(device):
        x_np = np.arange(64, dtype=np.float32)
        x = pair_sharding(audit_mesh(device=device), x_np)
        fn = lambda x: Sharded(tuple(x.shards[(k + 1) % 8] * 2 for k in range(8)))  # noqa: E731
        return fn, (x,), {}, ((lambda x: x * 2), (torch.from_numpy(x_np),))

    findings = audit_shard_kernel(reg["shifted"], baseline=None, device=CPU)
    assert any(f.rule == "SA-SPEC" and "unsharded call" in f.message for f in findings)


# ---------------------------------------------------------------------------
# registry + run machinery
# ---------------------------------------------------------------------------


def test_duplicate_registration_rejected():
    reg: dict = {}

    @register_shard_kernel("dup_probe", n_pairs=8, registry=reg)
    def _b(device):
        return (lambda x: x), (1.0,), {}

    with pytest.raises(ValueError):

        @register_shard_kernel("dup_probe", n_pairs=8, registry=reg)
        def _b2(device):
            return (lambda x: x), (1.0,), {}


def test_unknown_kernel_rejected():
    with pytest.raises(KeyError):
        run_shard_audit(["no_such_kernel"], baselines={}, device=CPU)


def test_build_failure_is_a_finding_not_a_crash():
    spec = ShardKernelSpec(
        name="broken", build=lambda d: (_ for _ in ()).throw(RuntimeError("x")), n_pairs=8,
    )
    findings = audit_shard_kernel(spec, baseline=None, device=CPU)
    assert "SA-ERROR" in _rules(findings)


def test_build_is_cached_on_the_spec():
    calls = {"n": 0}

    def build(device):
        calls["n"] += 1
        x = pair_sharding(audit_mesh(device=device), np.ones(64, np.float32))
        return (lambda x: Sharded(tuple(p * 2 for p in x.shards))), (x,), {}

    spec = ShardKernelSpec(name="cache_probe", build=build, n_pairs=64)
    baseline = measure_shard_kernel(spec, CPU)
    assert audit_shard_kernel(spec, baseline, device=CPU) == []
    assert audit_shard_kernel(spec, baseline, device=CPU) == []
    assert calls["n"] == 1  # built and run once across repeated audits


# ---------------------------------------------------------------------------
# the package registry and its committed baselines
# ---------------------------------------------------------------------------


def test_committed_baselines_cover_the_whole_registry():
    baselines = load_baselines()
    _, audited = run_shard_audit(["score_pairs_sharded"], device=CPU)
    assert audited == 1
    assert len(SHARD_REGISTRY) == 19
    for tier in ("cpu", "cuda"):
        names = set(baselines["tiers"][tier]["kernels"])
        assert names == set(SHARD_REGISTRY), (tier, sorted(names ^ set(SHARD_REGISTRY)))


def test_shard_registry_audits_clean():
    # every sharded kernel holds SA-SPEC/COLL/PAD and its committed
    # collective and cost budgets (the cpu tier of shard_baselines.json)
    findings, audited = run_shard_audit(device=CPU)
    assert audited == 19
    assert not findings, "\n" + "\n".join(f.format() for f in findings)


def test_budget_drift_fails_with_a_diff_style_message():
    # the SA-COST gate renders baseline-vs-measured, the SA-COLL gate the
    # missing reduction
    baseline = dict(load_baselines()["tiers"]["cpu"]["kernels"]["em_stats_sharded"])
    baseline["ops"] = float(baseline["ops"]) * 10
    counts = dict(baseline.get("collectives", {}))
    counts["reduce"] = counts.get("reduce", 0) + 2
    baseline["collectives"] = counts
    findings = audit_shard_kernel(SHARD_REGISTRY["em_stats_sharded"], baseline, device=CPU)
    rendered = "\n".join(f.format() for f in findings)
    assert "ops: baseline" in rendered and "measured" in rendered
    assert "budget drift" in rendered
    assert "em_stats_sharded" in rendered


def test_update_baselines_round_trip(tmp_path):
    path = str(tmp_path / "baselines.json")
    new = update_baselines(["em_stats_sharded"], path=path, device=CPU)
    with open(path) as fh:
        on_disk = json.load(fh)
    assert on_disk == new
    rec = on_disk["tiers"]["cpu"]["kernels"]["em_stats_sharded"]
    assert rec["collectives"] == {"reduce": 1}  # THE statistics reduction
    assert rec["ops"] > 0 and rec["temp_size_in_bytes"] > 0


def test_collective_free_kernels_are_the_references():
    # the kernels with an empty collective budget equal the reference's set
    # (its committed shard_baselines.json); the rest reduce
    with open(os.path.join(REPO_ROOT, "splink_tpu", "analysis", "shard_baselines.json")) as fh:
        ref = json.load(fh)["kernels"]
    ours = load_baselines()["tiers"]
    want = {k for k, v in ref.items() if not v.get("collectives")}
    for tier in ("cpu", "cuda"):
        got = {k for k, v in ours[tier]["kernels"].items() if not v["collectives"]}
        assert got == want, tier
        assert all(set(v["collectives"]) <= {"reduce"} for v in ours[tier]["kernels"].values())
    assert set(ref) == set(SHARD_REGISTRY)


# ---------------------------------------------------------------------------
# parity with the reference's sharded kernels on its 8 CPU devices
# ---------------------------------------------------------------------------


def _ulp_equal(got, want, bound=FLOAT_ULP):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    if not np.issubdtype(want.dtype, np.floating):
        np.testing.assert_array_equal(got.astype(np.int64), want.astype(np.int64))
        return
    ulp = np.spacing(np.abs(want).astype(np.float32)).astype(np.float64)
    diff = np.abs(got.astype(np.float64) - want.astype(np.float64))
    assert np.all(diff <= bound * ulp), float(np.max(diff / ulp))


def _host(x):
    if isinstance(x, Sharded):
        return np.concatenate([s.numpy() for s in x.shards])
    if isinstance(x, torch.Tensor):
        return x.numpy()
    return np.asarray(x)


def _reference(name):
    """(reference outputs as numpy leaves, reference inputs as numpy): the
    reference's build function jitted on its 8-device mesh at the production
    width, x64 off (its own audit's configuration)."""
    import jax

    from splink_tpu.analysis import shard_audit as ref_sa

    ref_sa._ensure_default_registry()
    with jax.enable_x64(False):
        fn, args, kwargs = ref_sa.SHARD_REGISTRY[name].build()
        jfn = fn if hasattr(fn, "lower") else jax.jit(fn)
        out = jfn(*args, **kwargs)
    return ([np.asarray(x) for x in jax.tree.leaves(out)],
            [np.asarray(x) for x in jax.tree.leaves(args)])


@pytest.mark.parametrize("name", ["em_stats_sharded", "score_pairs_sharded",
                                  "pattern_kernel_sharded", "jaro_winkler_sharded"])
def test_sharded_outputs_match_the_reference(name):
    from splink_tpu_torch.models.fellegi_sunter import FSParams

    shard_audit._ensure_default_registry()
    want, ref_in = _reference(name)
    mesh = audit_mesh(device=CPU)
    fn = shard_audit._built(SHARD_REGISTRY[name], torch.device(CPU))[0]
    t = torch.from_numpy
    if name in ("em_stats_sharded", "score_pairs_sharded"):
        G, lam, m, u = ref_in[:4]
        params = FSParams(t(lam.astype(np.float32)), t(m), t(u))
        args = [pair_sharding(mesh, G), params]
        if name == "em_stats_sharded":
            args.append(pair_sharding(mesh, ref_in[4]))
    elif name == "pattern_kernel_sharded":
        packed, il, ir, valid, acc = ref_in
        args = [pair_sharding(mesh, il), pair_sharding(mesh, ir), int(valid),
                t(acc.astype(np.int64))]
    else:
        s1, s2, l1, l2, p, bt = ref_in
        args = [pair_sharding(mesh, s1), pair_sharding(mesh, s2), pair_sharding(mesh, l1),
                pair_sharding(mesh, l2), float(p), float(bt)]
    out = fn(*args)
    got = [_host(x) for x in (out if isinstance(out, tuple) and not isinstance(out, Sharded)
                              else (out,))]
    assert len(got) == len(want)
    for g, w in zip(got, want):
        _ulp_equal(g, w, SUM_ULP if name == "em_stats_sharded" else FLOAT_ULP)
