"""num_audit: measured numerical-safety audit over the kernel registry.

The port of splink_tpu/analysis/num_audit.py. It runs every kernel in the
registry (trace_audit.py) on its fixed-seed inputs plus adversarial corner
batches, on the audit's device, and checks:

    check    what it asserts
    -------  ----------------------------------------------------------
    NA-FIN   no NaN/Inf escapes: every float output leaf is finite for
             the registered inputs AND for every applicable corner batch
             (all-null rows, exact-0/1 probabilities, empty candidate
             buckets, max-count TF tables, sub-normal parameters). In the
             ``denormal`` corner no probability leaves a kernel as a
             sub-normal number either: the port flushes them to 0 where
             they leave a function (``models.fellegi_sunter.
             flush_subnormal``), as the reference's flush-to-zero does.
    NA-ULP   float32-vs-float64 divergence stays within the committed
             per-kernel ulp budget for this tier: the kernel runs once
             as registered and once with its float tensor inputs upcast
             to float64 (for the hand kernels, which compute only in
             float32, the float64 arm is the spec's ``f64_fn``: the plain
             version in float64 on the same device); the largest
             elementwise divergence, in float32 ulps at the float64
             result's magnitude, must not exceed ``ulp_budget`` in
             analysis/num_baselines.json.
    NA-MONO  match_probability is monotone in each comparison column's
             log-Bayes-factor direction, for the summed and the
             fold_logit orders.
    NA-ORD   the fold order is pinned: fold_logit on the device must be
             BIT-IDENTICAL to a host numpy float32 fold that accumulates
             the per-column masked level lookups strictly left to right,
             fed the device's own log tables.
    NA-BASE  a registered kernel has no ulp budget for this tier.
    NA-ERROR a kernel or corner failed to run at all.

Corner batches apply only where the leaf they target exists (int8 gamma
matrices for ``all_null``, FSParams for ``prob_extremes``/``denormal``,
bool masks for ``empty``), plus the TF tables' own corners.

Budgets are keyed by tier (``cpu``, ``cuda``) and refreshed with

    python -m splink_tpu_torch.analysis --update-num-baselines --device <tier>

which rewrites ONLY that tier's block. The measurement is deterministic
(fixed-seed inputs, no timing), so budgets store the ceiling of the
measured divergence.
"""

from __future__ import annotations

import functools
import json
import math
import os

from .findings import Finding

BASELINES_PATH = os.path.join(os.path.dirname(__file__), "num_baselines.json")
REFRESH = "python -m splink_tpu_torch.analysis --update-num-baselines --device <tier>"

# Model-level plan entries (NA-MONO / NA-ORD) that audit the shared
# Fellegi-Sunter surface rather than one registered kernel.
MODEL_CHECKS = ("match_probability", "fold_logit")

# Registered kernels excluded from a specific check, with the reason.
# Empty, as in the reference: the table is where a kernel that cannot run
# at f64 would document itself instead of silently dropping out of the
# plan.
NUM_EXCLUDED: dict[str, str] = {}


def current_tier(device=None) -> str:
    from .perf_audit import current_tier as tier

    return tier(device)


def load_baselines(path: str | None = None) -> dict:
    path = path or BASELINES_PATH
    if not os.path.exists(path):
        return {}
    with open(path) as fh:
        return json.load(fh)


# ---------------------------------------------------------------------------
# corner library
# ---------------------------------------------------------------------------


def _map_args(args, leaf_fn, params_fn=None):
    """Rebuild an args tuple, mapping tensor leaves through ``leaf_fn`` and
    FSParams nodes through ``params_fn`` (FSParams is a tuple subclass, so
    it is intercepted before tuple recursion)."""
    import torch

    from ..models.fellegi_sunter import FSParams

    def rec(x):
        if isinstance(x, FSParams):
            return params_fn(x) if params_fn is not None else x
        if isinstance(x, tuple):
            return tuple(rec(e) for e in x)
        if isinstance(x, list):
            return [rec(e) for e in x]
        return leaf_fn(x) if isinstance(x, torch.Tensor) else x

    return tuple(rec(a) for a in args)


def _corner_all_null(args):
    """Every comparison null: int8 gamma matrices become all -1."""
    import torch

    hit = False

    def leaf(x):
        nonlocal hit
        if x.ndim and x.dtype == torch.int8:
            hit = True
            return torch.full_like(x, -1)
        return x

    new = _map_args(args, leaf)
    return new if hit else None


def _corner_prob_extremes(args):
    """Exact-0/1 probabilities: lambda = 0, m mass all on level 0, u mass
    all on the top level — every _safe_log sees a hard zero somewhere."""
    import torch

    from ..models.fellegi_sunter import FSParams

    seen = False

    def params(p):
        nonlocal seen
        seen = True
        m = torch.zeros_like(p.m)
        m[:, 0] = 1.0
        u = torch.zeros_like(p.u)
        u[:, -1] = 1.0
        return FSParams(lam=torch.zeros_like(p.lam), m=m, u=u)

    new = _map_args(args, lambda x: x, params)
    return new if seen else None


def _corner_denormal(args):
    """Sub-normal parameters: every probability cell sits below the
    float32 normal range, forcing _safe_log's tiny floor to do real work."""
    import torch

    from ..models.fellegi_sunter import FSParams

    seen = False

    def params(p):
        nonlocal seen
        seen = True
        return FSParams(
            lam=torch.full_like(p.lam, 1e-39),
            m=torch.full_like(p.m, 1e-39),
            u=torch.full_like(p.u, 1e-39),
        )

    new = _map_args(args, lambda x: x, params)
    return new if seen else None


def _corner_empty(args):
    """Empty buckets: every bool validity/keep mask goes all-False."""
    import torch

    hit = False

    def leaf(x):
        nonlocal hit
        if x.ndim and x.dtype == torch.bool:
            hit = True
            return torch.zeros_like(x)
        return x

    new = _map_args(args, leaf)
    return new if hit else None


# float32 holds integers exactly up to 2**24: the largest TF count table
# the float32 pipeline can represent without rounding
_F32_MAX_COUNT = 16777216.0


def _corner_tf_max_counts(args):
    """tf_adjustment at saturation: every pair matches, every token's
    count sits at float32's exact-integer ceiling with sums == counts."""
    import torch

    tid_a, tid_b, p, sums, counts = args
    return (
        tid_a,
        tid_b,
        torch.ones_like(p),
        torch.full_like(sums, _F32_MAX_COUNT),
        torch.full_like(counts, _F32_MAX_COUNT),
    )


def _corner_tf_max_adjust(args):
    """tf_gather with the adjustment table pinned at 1.0 everywhere."""
    import torch

    tid_a, tid_b, adjusted = args
    return (tid_a, tid_b, torch.ones_like(adjusted))


def _corner_tf_zero_log(args):
    """serve_score_fused_tf with max-count log tables: log(count/total)=0
    for every token, the table a degenerate single-token column builds."""
    import torch

    new = list(args)
    new[-1] = tuple(torch.zeros_like(t) for t in args[-1])
    return tuple(new)


GENERIC_CORNERS = (
    ("all_null", _corner_all_null),
    ("prob_extremes", _corner_prob_extremes),
    ("denormal", _corner_denormal),
    ("empty", _corner_empty),
)

SPECIAL_CORNERS = {
    "tf_adjustment": (("max_counts", _corner_tf_max_counts),),
    "tf_gather": (("max_adjust", _corner_tf_max_adjust),),
    "serve_score_fused_tf": (("max_count_table", _corner_tf_zero_log),),
}


# ---------------------------------------------------------------------------
# finite checks
# ---------------------------------------------------------------------------


def _float_leaves(out):
    import numpy as np

    from .trace_audit import leaves, to_numpy

    for i, leaf in enumerate(leaves(out)):
        arr = to_numpy(leaf)
        if np.issubdtype(arr.dtype, np.floating):
            yield i, arr


def _finite_leaves(out) -> list[str]:
    """Names of non-finite float leaves in an output structure."""
    import numpy as np

    return [f"leaf[{i}]:{arr.dtype}" for i, arr in _float_leaves(out)
            if not np.isfinite(arr).all()]


def _subnormal_leaves(out) -> list[str]:
    """Names of float leaves holding a sub-normal number."""
    import numpy as np

    bad = []
    for i, arr in _float_leaves(out):
        a = np.abs(arr[np.isfinite(arr)])
        if ((a > 0) & (a < np.finfo(arr.dtype).tiny)).any():
            bad.append(f"leaf[{i}]:{arr.dtype} sub-normal")
    return bad


def _finite_em(out, expect_ll: bool = True) -> list[str]:
    """EMResult checker: histories are NaN-padded beyond n_updates by
    contract, so only the populated prefix must be finite (ll_history only
    with compute_ll)."""
    import numpy as np

    from .trace_audit import to_numpy

    n = int(out.n_updates) + 1
    bad = []
    named = [
        ("params", out.params),
        ("lam_history", to_numpy(out.lam_history)[:n]),
        ("m_history", to_numpy(out.m_history)[:n]),
        ("u_history", to_numpy(out.u_history)[:n]),
    ]
    if expect_ll:
        named.append(("ll_history", to_numpy(out.ll_history)[:n]))
    for name, part in named:
        for frag in _finite_leaves(part):
            bad.append(f"{name}.{frag}")
    if np.isfinite(to_numpy(out.lam_history)[n:]).any():
        bad.append("lam_history: finite values past n_updates")
    return bad


_FIN_CHECKERS = {
    "em_step": _finite_em,
    "em_step_checkpointed": _finite_em,
    # the telemetry kernel registers with compute_ll=False: its ll_history
    # is all-NaN by contract
    "em_step_telemetry": functools.partial(_finite_em, expect_ll=False),
}

# outputs that are probabilities through match_probability's flush: in the
# denormal corner they must come out flushed, never sub-normal
_FLUSHED = ("score_pairs", "serve_score_topk", "serve_score_fused",
            "serve_score_fused_tf", "serve_score_topk_brownout")


# ---------------------------------------------------------------------------
# ulp divergence
# ---------------------------------------------------------------------------


def _upcast_args(args):
    """Float tensor leaves -> float64; everything else verbatim."""
    import torch

    def leaf(x):
        return x.to(torch.float64) if x.is_floating_point() else x

    return _map_args(args, leaf, lambda p: type(p)(*(leaf(v) for v in p)))


def _ulp_divergence(out32, out64) -> float:
    """Largest float32-vs-float64 output divergence, in float32 ulps at the
    float64 result's magnitude. Positions NaN in BOTH runs are contract;
    a NaN on one side only is infinite divergence."""
    import numpy as np

    from .trace_audit import leaves, to_numpy

    worst = 0.0
    for a, b in zip(leaves(out32), leaves(out64)):
        a = to_numpy(a)
        if not np.issubdtype(a.dtype, np.floating):
            continue
        a = a.astype(np.float64)
        b = to_numpy(b).astype(np.float64)
        nan_a, nan_b = np.isnan(a), np.isnan(b)
        if (nan_a != nan_b).any():
            return math.inf
        keep = ~nan_a
        a, b = a[keep], b[keep]
        if a.size == 0:
            continue
        with np.errstate(invalid="ignore", over="ignore"):
            ref = np.minimum(np.abs(b), float(np.finfo(np.float32).max))
            ref = np.maximum(ref, float(np.finfo(np.float32).tiny))
            ulp = np.spacing(ref.astype(np.float32)).astype(np.float64)
            diff = np.where(a == b, 0.0, np.abs(a - b))
            worst = max(worst, float(np.max(diff / ulp)))
    return worst


def _measure_ulp(spec, device=None) -> float:
    """Run a kernel as registered and in float64 and return the
    divergence. Deterministic: same seed inputs, no timing."""
    fn, args, kwargs = spec.built(device)
    out32 = fn(*args, **kwargs)
    fn64 = spec.f64_fn or fn
    out64 = fn64(*_upcast_args(args), **kwargs)
    return _ulp_divergence(out32, out64)


# ---------------------------------------------------------------------------
# model-level invariants: NA-MONO / NA-ORD
# ---------------------------------------------------------------------------


def _mono_params(device):
    """Asymmetric FSParams for the monotonicity/order checks: the shared
    audit params are uniform (every log-BF is 0), which would make both
    checks vacuous."""
    import torch

    from ..models.fellegi_sunter import FSParams

    f32 = torch.float32
    return FSParams(
        lam=torch.tensor(0.23, dtype=f32, device=device),
        m=torch.tensor(
            [[0.85, 0.10, 0.05], [0.70, 0.20, 0.10], [0.55, 0.30, 0.15]],
            dtype=f32, device=device,
        ),
        u=torch.tensor(
            [[0.05, 0.25, 0.70], [0.10, 0.30, 0.60], [0.20, 0.30, 0.50]],
            dtype=f32, device=device,
        ),
    )


def _check_monotone(device=None) -> list[Finding]:
    """NA-MONO: sweeping one column through its levels sorted by log(m/u)
    (null slotted at 0) must give non-decreasing match probability."""
    import numpy as np
    import torch

    from ..models import fellegi_sunter as fs
    from .trace_audit import _resolve

    dev = _resolve(device)
    findings = []
    params = _mono_params(dev)
    m = params.m.cpu().numpy().astype(np.float64)
    u = params.u.cpu().numpy().astype(np.float64)
    C, L = m.shape
    for ci in range(C):
        bf = {lv: math.log(m[ci, lv]) - math.log(u[ci, lv]) for lv in range(L)}
        bf[-1] = 0.0  # null contributes no evidence
        order = sorted(bf, key=bf.get)
        G = np.full((len(order), C), -1, np.int8)
        G[:, ci] = order
        G = torch.from_numpy(G).to(dev)
        for label, fn in (
            ("match_probability", lambda G: fs.match_probability(G, params)),
            ("sigmoid(fold_logit)", lambda G: torch.sigmoid(fs.fold_logit(G, params))),
        ):
            p = fn(G).cpu().numpy().astype(np.float64)
            if not (np.diff(p) >= 0).all():
                findings.append(
                    Finding(
                        rule="NA-MONO",
                        path="match_probability",
                        line=0,
                        message=(
                            f"{label} not monotone in column {ci}'s log-BF "
                            f"order {order}: probabilities "
                            + ", ".join(f"{v:.6g}" for v in p)
                        ),
                        hint="a probability that drops as evidence strengthens "
                        "means a fold or guard reordered the evidence",
                    )
                )
    return findings


def _check_fold_order(device=None) -> list[Finding]:
    """NA-ORD: fold_logit on the device must match a host numpy float32
    reference that accumulates the per-column masked level lookups
    strictly left to right, bit for bit. The reference consumes the
    DEVICE log tables as data, so it pins only the association order, not
    the device's log."""
    import numpy as np

    from ..models import fellegi_sunter as fs
    from .trace_audit import _resolve, shared_fs_inputs

    dev = _resolve(device)
    G, _ = shared_fs_inputs(str(dev))
    params = _mono_params(dev)
    device_out = fs.fold_logit(G, params).cpu().numpy()

    Gn = G.cpu().numpy()
    log_m = fs._safe_log(params.m).cpu().numpy()
    log_u = fs._safe_log(params.u).cpu().numpy()
    prior = (fs._safe_log(params.lam) - fs._safe_log(1.0 - params.lam)).cpu().numpy()
    zero = np.float32(0.0)
    log_bf = np.zeros(Gn.shape[0], np.float32)
    for ci in range(Gn.shape[1]):
        g = Gn[:, ci]
        lp_m = np.zeros(g.shape, np.float32)
        lp_u = np.zeros(g.shape, np.float32)
        for lv in range(log_m.shape[1]):
            hit = g == lv
            lp_m = lp_m + np.where(hit, log_m[ci, lv], zero)
            lp_u = lp_u + np.where(hit, log_u[ci, lv], zero)
        present = g >= 0
        log_bf = log_bf + (
            np.where(present, lp_m, zero) - np.where(present, lp_u, zero)
        )
    reference = (prior + log_bf).astype(np.float32)

    if not np.array_equal(device_out, reference):
        n_diff = int((device_out != reference).sum())
        worst = float(np.max(np.abs(device_out.astype(np.float64) - reference)))
        return [
            Finding(
                rule="NA-ORD",
                path="fold_logit",
                line=0,
                message=(
                    f"fold_logit differs from the left-to-right reference "
                    f"fold at {n_diff}/{device_out.size} rows (max abs diff "
                    f"{worst:.3e}) — the contracted fold order moved"
                ),
                hint="every TF-anchored path assumes fold_logit's column "
                "order; see docs/numerics notes before changing it",
            )
        ]
    return []


# ---------------------------------------------------------------------------
# plan / audit / refresh
# ---------------------------------------------------------------------------


def num_plan(names=None) -> list[str]:
    """Audit plan: every registered kernel plus the model-level checks.
    Unknown names raise KeyError."""
    from .trace_audit import REGISTRY, _ensure_default_registry

    _ensure_default_registry()
    known = list(REGISTRY) + list(MODEL_CHECKS)
    if names is None:
        return known
    for name in names:
        if name not in known:
            raise KeyError(name)
    return [n for n in known if n in set(names)]


def _kernel_corners(name, args):
    corners = []
    for cname, fn in GENERIC_CORNERS:
        mutated = fn(args)
        if mutated is not None:
            corners.append((cname, mutated))
    for cname, fn in SPECIAL_CORNERS.get(name, ()):
        corners.append((cname, fn(args)))
    return corners


def audit_kernel_numerics(spec, base: dict | None, device=None) -> list[Finding]:
    """All numeric checks for one registered kernel: NA-FIN over the
    registered inputs and every applicable corner, NA-ULP against the
    committed budget (NA-BASE when the budget is missing)."""
    findings: list[Finding] = []
    try:
        fn, args, kwargs = spec.built(device)
    except Exception as exc:  # noqa: BLE001 - surfaced as a finding
        return [Finding(rule="NA-ERROR", path=spec.name, line=0,
                        message=f"kernel failed to build: {exc!r}")]
    check_fin = _FIN_CHECKERS.get(spec.name, _finite_leaves)

    batches = [("registered", args)] + _kernel_corners(spec.name, args)
    for cname, batch in batches:
        try:
            out = fn(*batch, **kwargs)
        except Exception as exc:  # noqa: BLE001 - surfaced as a finding
            findings.append(
                Finding(
                    rule="NA-ERROR",
                    path=spec.name,
                    line=0,
                    message=f"corner '{cname}' failed to execute: {exc!r}",
                    hint="corner batches stay inside documented input "
                    "contracts; an execution failure is a kernel bug",
                )
            )
            continue
        bad = check_fin(out)
        if cname == "denormal" and spec.name in _FLUSHED:
            bad = bad + _subnormal_leaves(out[0] if isinstance(out, tuple) else out)
        if bad:
            findings.append(
                Finding(
                    rule="NA-FIN",
                    path=spec.name,
                    line=0,
                    message=(
                        f"non-finite output for corner '{cname}': "
                        + ", ".join(bad)
                    ),
                    hint="finite inputs must give finite outputs; guard the "
                    "log/division the corner exposed (_safe_log idiom), and "
                    "flush sub-normal probabilities (flush_subnormal)",
                )
            )

    if base is None or "ulp_budget" not in (base or {}):
        findings.append(
            Finding(
                rule="NA-BASE",
                path=spec.name,
                line=0,
                message=(
                    f"no ulp budget for kernel '{spec.name}' on tier "
                    f"'{current_tier(device)}'"
                ),
                hint=f"run `{REFRESH}` and commit analysis/num_baselines.json "
                "(num-baselines)",
            )
        )
        return findings

    budget = float(base["ulp_budget"])
    try:
        measured = _measure_ulp(spec, device)
    except Exception as exc:  # noqa: BLE001 - surfaced as a finding
        findings.append(
            Finding(
                rule="NA-ERROR",
                path=spec.name,
                line=0,
                message=f"float64 shadow run failed: {exc!r}",
                hint="kernels must run with float64 inputs; pin or gate the "
                "offending dtype",
            )
        )
        return findings
    if measured > budget:
        findings.append(
            Finding(
                rule="NA-ULP",
                path=spec.name,
                line=0,
                message=(
                    f"f32/f64 divergence grew: ulp: budget {budget:g}, "
                    f"measured {measured:g}"
                ),
                hint="a wider float32 error bar usually means a guard or "
                f"reduction moved; if intended, `{REFRESH}`",
            )
        )
    return findings


def run_num_audit(names=None, baselines: dict | None = None,
                  device=None) -> tuple[list[Finding], int]:
    """Audit the given kernels (default: the full plan, model checks
    included) on ``device`` against the committed ulp budgets for its
    tier. Returns (findings, number of kernels/model surfaces audited)."""
    from .trace_audit import REGISTRY

    plan = num_plan(names)
    if baselines is None:
        baselines = load_baselines()
    per_kernel = baselines.get("tiers", {}).get(current_tier(device), {}).get("kernels", {})

    findings: list[Finding] = []
    for name in plan:
        if name == "match_probability":
            findings.extend(_check_monotone(device))
        elif name == "fold_logit":
            findings.extend(_check_fold_order(device))
        else:
            findings.extend(
                audit_kernel_numerics(REGISTRY[name], per_kernel.get(name), device)
            )
    return findings, len(plan)


def update_baselines(names=None, path: str | None = None, device=None) -> dict:
    """Re-measure ulp budgets for the tier of ``device`` and rewrite its
    block (other tiers' budgets survive verbatim). A full refresh replaces
    the tier's kernel map; a named refresh merges into it."""
    from .perf_audit import device_meta
    from .trace_audit import REGISTRY

    plan = [n for n in num_plan(names) if n not in MODEL_CHECKS]
    tier = current_tier(device)
    path = path or BASELINES_PATH
    existing = load_baselines(path)
    tiers = dict(existing.get("tiers", {}))
    kernels = {} if names is None else dict(tiers.get(tier, {}).get("kernels", {}))

    for name in plan:
        spec = REGISTRY[name]
        _, args, _ = spec.built(device)
        measured = _measure_ulp(spec, device)
        cell = {
            "ulp_budget": float(math.ceil(measured)),
            "corners": ["registered"] + [c for c, _ in _kernel_corners(name, args)],
        }
        if spec.f64_fn is not None:
            cell["f64_arm"] = (
                "the plain PyTorch version in float64 on the same device "
                "(the kernel computes in float32 only)"
            )
        kernels[name] = cell

    tiers[tier] = {"_meta": device_meta(device), "kernels": kernels}
    payload = {
        "_meta": {
            "refresh": REFRESH,
            "semantics": (
                "ulp_budget = ceil(max f32-vs-f64 output divergence in f32 "
                "ulps) on this tier's registered inputs; exceeded -> NA-ULP"
            ),
        },
        "tiers": {t: tiers[t] for t in sorted(tiers)},
    }
    with open(path, "w") as fh:
        json.dump(payload, fh, indent=2, sort_keys=True)
        fh.write("\n")
    return payload
