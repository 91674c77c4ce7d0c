"""One run of one cell: set-up, the timed window of whole training jobs,
the optional trace, the comparison with the plain reference, and the
result line.

Everything about a cell is data found by name: its entry in
``BENCHMARK.json``, ``workloads/<cell>.json`` (configuration, traffic,
the stages and kernel variants each job must show, the limits of the
comparison), ``configs/<config>.json`` (settings, generator and its
record model), ``traffic/<traffic>.json`` (rows, entry),
``generators/<generator>.py`` and ``metrics/<metric>.py``, the last two
imported by name.
"""

from __future__ import annotations

import copy
import gc
import importlib
import json
import sys
import time
from dataclasses import dataclass, field
from pathlib import Path

import numpy as np

from . import tracing

ROOT = Path(__file__).resolve().parent
REPO = ROOT.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "splink_tpu")


def _json(path: Path) -> dict:
    with open(path) as fh:
        return json.load(fh)


@dataclass
class Cell:
    name: str
    entry: dict  # the cell's entry in BENCHMARK.json
    workload: dict
    config: dict
    traffic: dict
    per_layer: list  # metric entries of BENCHMARK.json this cell reports
    end_to_end: list

    @property
    def settings(self) -> dict:
        return copy.deepcopy(self.config["settings"])


def load_cell(name: str, bench_path: Path | None = None) -> Cell:
    bench = _json(bench_path or REPO / "BENCHMARK.json")
    entries = [w for w in bench["workloads"] if w["name"] == name]
    if not entries:
        raise KeyError(f"no cell {name!r} in BENCHMARK.json")
    entry = entries[0]
    workload = _json(ROOT / "workloads" / f"{name}.json")
    config = _json(ROOT / "configs" / f"{entry['config']}.json")
    traffic = _json(ROOT / "traffic" / f"{entry['traffic']}.json")
    # an entry without ``workloads`` is every cell's (a per-layer metric:
    # every cell's that reports the metric it moves), as the contract lets
    # a later entry leave the key out
    e2e = [m for m in bench["end_to_end"] if name in m.get("workloads", [name])]
    reported = {m["name"] for m in e2e}
    per_layer = [m for m in bench["per_layer"]
                 if name in m.get("workloads", [name] if m["moves"] in reported else [])]
    return Cell(name, entry, workload, config, traffic, per_layer, e2e)


def generator(cell: Cell):
    return importlib.import_module(f"linkbench.generators.{cell.config['generator']}")


def metric_reader(name: str):
    return importlib.import_module(f"linkbench.metrics.{name}").read


def make_frame(cell: Cell, seed: int, rows: int | None = None):
    rows = rows or int(cell.traffic["rows"])
    return generator(cell).generate(rows, seed, cell.config["records"])


def pair_count(df, settings: dict) -> int:
    from .reference.pairs import pair_count

    return pair_count(df, settings["blocking_rules"])


# ----------------------------------------------------------------------
# One job
# ----------------------------------------------------------------------


@dataclass
class Job:
    seconds: float
    cpu_seconds: float  # the process's CPU time over the job, every thread
    stages: dict
    variants: dict
    tiers: dict
    trajectory: list
    counts: np.ndarray | None = None  # pattern counts over ``patterns``
    patterns: np.ndarray | None = None
    pairs: tuple | None = None  # (left, right) row indices, kept for the check
    gammas: np.ndarray | None = None
    faults: list = field(default_factory=list)


def run_job(settings: dict, df, device, entry: str, keep_pairs: bool) -> Job:
    """One whole job through the public entry: Splink(settings,
    df=df).<entry>() (``estimate_parameters`` for a training job), its
    outputs read back afterwards."""
    import splink_tpu_torch
    from splink_tpu_torch import blocking
    from splink_tpu_torch.ops import strings_cuda

    from .reference.em import program_trajectory

    strings_cuda.variant_launches.clear()
    for k in blocking.tiers:
        blocking.tiers[k] = 0
    t0, c0 = time.perf_counter(), time.process_time()
    linker = splink_tpu_torch.Splink(copy.deepcopy(settings), df=df, device=device)
    getattr(linker, entry)()
    params = linker.params
    seconds = time.perf_counter() - t0
    job = Job(seconds=seconds, cpu_seconds=time.process_time() - c0,
              stages=dict(linker.stage_seconds),
              variants=dict(strings_cuda.variant_launches), tiers=dict(blocking.tiers),
              trajectory=program_trajectory(params, settings))
    if linker._pattern_counts is not None:
        job.counts = np.array(linker._pattern_counts)
        job.patterns = linker._pattern_program.patterns_matrix()
    if keep_pairs and linker._pairs is not None and linker._G is not None:
        job.pairs = (linker._pairs.idx_l, linker._pairs.idx_r)
        job.gammas = linker._G
    return job


def job_faults(job: Job, cell: Cell, settings: dict, n_pairs: int, on_card: bool) -> list:
    """Why a job did not take the cell's path: its stages, and on the card
    its kernel variants (on the CPU the plain versions run: no launch) and
    its blocking tier."""
    faults = []
    want = set(cell.workload["stages"])
    if set(job.stages) != want:
        faults.append(f"stages {sorted(job.stages)}, expected {sorted(want)}")
    per_batch = cell.workload["variants_per_batch"] if on_card else {}
    if set(job.variants) != set(per_batch):
        faults.append(f"kernel variants {job.variants}, expected {per_batch} a batch")
    elif per_batch:
        first = next(iter(per_batch))
        batches = job.variants[first] / per_batch[first]
        least = -(-n_pairs // int(settings["pair_batch_size"]))
        if (batches < least or any(job.variants[k] != per_batch[k] * batches
                                   for k in per_batch)):
            faults.append(f"kernel launches {job.variants}: not {per_batch} in each of at "
                          f"least {least} batches")
    tier = cell.workload.get("blocking_tier")
    if on_card and tier is not None:
        want_tiers = {k: int(k == tier) for k in job.tiers}
        if job.tiers != want_tiers:
            faults.append(f"blocking tiers {job.tiers}, expected {want_tiers}")
    return faults


# ----------------------------------------------------------------------
# The comparison
# ----------------------------------------------------------------------


def check_numbers(jobs: list, kept: Job | None, ref, ref_traj, n_rows: int) -> dict:
    """Every number the cell's limits name, worst over the jobs."""
    from .reference import check

    out = {}
    out["em_gap"] = max(check.em_numbers(j.trajectory, ref_traj)["em_gap"] for j in jobs)
    with_counts = [j for j in jobs if j.counts is not None]
    if with_counts:
        hists = [check.program_hist(j.counts, j.patterns, ref.levels) for j in with_counts]
        out["pairs_gap"] = max(abs(int(h.sum()) - ref.total) for h in hists)
        out["pattern_gap"] = max(int(np.abs(h - ref.hist).sum()) for h in hists)
    if kept is not None and kept.pairs is not None:
        import torch

        dev = ref.keys.device
        left = torch.from_numpy(np.asarray(kept.pairs[0], np.int64)).to(dev)
        right = torch.from_numpy(np.asarray(kept.pairs[1], np.int64)).to(dev)
        keys = left * n_rows + right
        gammas = torch.from_numpy(np.asarray(kept.gammas)).to(dev)
        out.update(check.pair_numbers(keys, gammas, ref))
    return out


def judge(numbers: dict, limits: dict) -> tuple[bool, dict]:
    """(correct, {name: {value, limit}}): each limited number at or below
    its limit; a number the run could not give fails."""
    checks, ok = {}, True
    for name, limit in limits.items():
        value = numbers.get(name)
        passed = value is not None and value <= limit
        ok = ok and passed
        checks[name] = {"value": value, "limit": limit}
    return ok, checks


# ----------------------------------------------------------------------
# The run
# ----------------------------------------------------------------------


@dataclass
class RunView:
    """What a metric's reader sees."""

    jobs: list  # the window's jobs, run untraced
    window_s: float  # from the window's start to the last job's end
    pairs_per_job: int
    setup_s: float
    peak_bytes: int | None
    trace: object | None = None  # tracing.Trace of a --trace 1 run's traced jobs
    traced_jobs: int = 0  # the jobs that trace covers
    work: dict = field(default_factory=dict)  # kernel column -> (ops, bytes) of one job


def forbidden_modules() -> list:
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def run_cell(name: str, seed: int, seconds: float, trace: bool, t_start: float,
             device: str = "cuda", rows: int | None = None, overrides: dict | None = None,
             log=print) -> dict:
    """One run of cell ``name``. ``t_start`` is the host clock
    (``time.perf_counter``) at the process's start. ``rows`` and
    ``overrides`` (settings) shrink the cell for tests on the CPU.

    The window runs untraced in every run, so the stages' seconds are the
    same measurement with and without ``trace``. With ``trace``, whole
    jobs then run under the profiler for a third of ``seconds`` (one at
    least) for the device's metrics."""
    import torch

    import splink_tpu_torch  # noqa: F401 - the system under test

    from .reference import check

    cell = load_cell(name)
    on_card = device == "cuda"
    settings = cell.settings
    settings.update(overrides or {})
    entry = cell.traffic["entry"]
    parts = {"imports_s": time.perf_counter() - t_start}
    df = make_frame(cell, seed, rows)
    n_pairs = pair_count(df, settings)
    parts["frame_s"] = time.perf_counter() - t_start - parts["imports_s"]
    sync = torch.cuda.synchronize if on_card else (lambda: None)

    # set-up: the kernels' libraries (built on a checkout's first run) and
    # one whole job at the cell's own shapes
    warm = run_job(settings, df, device, entry, keep_pairs=False)
    sync()
    gc.collect()
    setup_s = time.perf_counter() - t_start
    parts["warmup_job_s"] = setup_s - parts["imports_s"] - parts["frame_s"]
    parts["warmup_stages_s"] = warm.stages
    log(json.dumps({"setup_parts": parts}))

    keep = cell.workload.get("keep_pairs", False)
    rng = np.random.default_rng([seed, 0x11B])
    jobs, kept = [], None

    def run_until(limit_s: float) -> list:
        nonlocal kept
        done, t0 = [], time.perf_counter()
        while True:
            job = run_job(settings, df, device, entry, keep_pairs=keep)
            job.faults = job_faults(job, cell, settings, n_pairs, on_card)
            # one job kept, uniform over the run's jobs
            if keep and rng.random() * (len(jobs) + len(done) + 1) < 1.0:
                if kept is not None:
                    kept.pairs = kept.gammas = None
                kept = job
            else:
                job.pairs = job.gammas = None
            done.append(job)
            if time.perf_counter() - t0 >= limit_s:
                return done

    if on_card:
        torch.cuda.reset_peak_memory_stats()
    w0 = time.perf_counter()
    jobs = run_until(seconds)
    sync()
    window_s = time.perf_counter() - w0
    trace_summary, traced = None, []
    if trace:
        from torch.profiler import ProfilerActivity, profile

        stages = []
        with tracing.stage_spans(stages), profile(
                activities=[ProfilerActivity.CUDA if on_card else ProfilerActivity.CPU]) as prof:
            t0_ns = time.time_ns()
            traced = run_until(seconds / 3)
            sync()
            t1_ns = time.time_ns()
        trace_summary = tracing.summarize(prof, stages, t0_ns, t1_ns)
        del prof
    peak = int(torch.cuda.max_memory_allocated()) if on_card else None
    every = jobs + traced
    failed = sum(bool(j.faults) for j in every)
    for job in every:
        if job.faults:
            log(f"job failed its path check: {'; '.join(job.faults)}", file=sys.stderr)

    # the comparison, once the jobs have ended and the peak is read
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()
    r0 = time.perf_counter()
    ref = check.reference_pass(df, settings, device, keep_pairs=kept is not None,
                               count_work=trace)
    ref_traj = check.em_trajectory(ref.hist, ref.levels, settings)
    numbers = check_numbers(every, kept, ref, ref_traj, len(df))
    reference_s = time.perf_counter() - r0
    correct, checks = judge(numbers, cell.workload["limits"])
    correct = correct and failed == 0 and ref.total == n_pairs

    view = RunView(jobs=jobs, window_s=window_s, pairs_per_job=n_pairs, setup_s=setup_s,
                   peak_bytes=peak, trace=trace_summary, traced_jobs=len(traced),
                   work=ref.work)
    metrics = {}
    for m in cell.per_layer if trace else cell.end_to_end:
        value = metric_reader(m["name"])(view)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    dev_info = {"platform": "gpu" if on_card else "cpu",
                "kind": torch.cuda.get_device_name(0) if on_card else "cpu",
                "count": 1 if on_card else 0, "memory_peak_bytes": peak}
    result = {"correct": bool(correct), "attempted": len(every), "failed": failed,
              "metrics": metrics, "device": dev_info}
    if trace_summary is not None:
        dev_info["busy_s"] = trace_summary.busy_s
        dev_info["window_s"] = trace_summary.window_s
        result["breakdown"] = {"device_ops": tracing.top(trace_summary.device_seconds),
                               "idle_gaps": tracing.top(trace_summary.idle_by_stage)}
    result["window"] = {"jobs": len(jobs), "window_s": window_s, "pairs_per_job": n_pairs,
                        "job_s": [j.seconds for j in jobs],
                        "job_cpu_s": [j.cpu_seconds for j in jobs],
                        "job_stages_s": [{k: round(v, 4) for k, v in j.stages.items()}
                                         for j in jobs],
                        "traced_job_s": [j.seconds for j in traced],
                        "reference_s": reference_s}
    result["checks"] = checks
    return result
