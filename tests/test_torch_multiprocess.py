"""Two REAL processes over torch.distributed (Gloo, on the CPU) against
splink_tpu's single-process run: the port's counterparts of
tests/test_multiprocess_em.py and its workers (tests/dist_worker.py,
tests/dist_linker_worker.py), whose jax cannot run two processes here.

Each process joins the group over local TCP with
``initialize_multihost(..., backend="gloo")``, feeds its
``global_pair_slice`` and reduces each pass's statistics with
``all_sum_stats``. Both processes must end with EQUAL parameters, and the
trajectory must match splink_tpu's single-process run at the reference
tests' tolerances: rtol 1e-12 on the parameters, 1e-9 on the log
likelihood (the two slices sum in another order than one pass). The
facade case also writes its checkpoint from process 0 only, stamps each
process's telemetry with its rank, and resumes: every process must agree
on the checkpoint, and one that cannot see it fails both.

The workers are this file run as a script (``python
tests/test_torch_multiprocess.py <mode> <rank> <world> <port> <out> [dir]``);
they import nothing of JAX. Every launch has a wall limit and a free port
(taken again if a worker finds it in use), and every worker leaves the
process group (``shutdown_multihost``) before it exits.
"""

import json
import os
import socket
import subprocess
import sys

import numpy as np
import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKER_TIMEOUT_S = 120

N_STREAM = 5000


def _stream_data():
    """The streamed-EM worker's gamma table and initial parameters (the
    reference worker's, same seed)."""
    rng = np.random.default_rng(42)
    G = np.stack([rng.integers(-1, 3, size=N_STREAM), rng.integers(-1, 2, size=N_STREAM)],
                 axis=1).astype(np.int8)
    init = (0.3, np.array([[0.1, 0.2, 0.7], [0.2, 0.8, 0.0]]),
            np.array([[0.7, 0.2, 0.1], [0.75, 0.25, 0.0]]))
    return G, init


def _linker_frame():
    import pandas as pd

    rng = np.random.default_rng(7)  # identical data in every process
    n = 4000
    return pd.DataFrame({
        "unique_id": np.arange(n),
        "name": rng.choice(["ann", "bob", "cat", None], n),
        "city": rng.choice(["x", "y"], n),
        "dob": rng.choice([f"d{k}" for k in range(12)], n),
    })


def _linker_settings(**extra):
    return {
        "link_type": "dedupe_only",
        "comparison_columns": [
            {"col_name": "name", "num_levels": 3},
            {"col_name": "city", "num_levels": 2},
        ],
        "blocking_rules": ["l.dob = r.dob"],
        "max_resident_pairs": 1024,
        "device_pair_generation": "off",
        "overlap_blocking": False,  # G materialises for the slice path
        "max_iterations": 5,
        "float64": True,
        **extra,
    }


# --------------------------------------------------------------------------
# The workers (this file run as a script)
# --------------------------------------------------------------------------


def _worker(mode, rank, world, port, out, work_dir=None) -> int:
    import torch

    torch.set_num_threads(1)
    from splink_tpu_torch.parallel import distributed as dist

    dist.initialize_multihost(f"127.0.0.1:{port}", world, rank, backend="gloo")
    assert dist.process_count() == world and dist.process_index() == rank
    result = {"process_id": rank, "process_count": dist.process_count()}
    if mode == "stream":
        from splink_tpu_torch.params import fsparams_from_numpy
        from splink_tpu_torch.parallel.streaming import run_em_streamed

        G, (lam, m, u) = _stream_data()
        sl = dist.global_pair_slice(N_STREAM)

        def batches():
            for s in range(sl.start, sl.stop, 1024):
                yield G[s:min(s + 1024, sl.stop)]

        params, hist, n_it, _ = run_em_streamed(
            batches, fsparams_from_numpy(lam, m, u, "cpu", torch.float64),
            max_iterations=6, max_levels=3, em_convergence=0.0, compute_ll=True,
            stats_reduce=dist.all_sum_stats,
        )
        result.update(slice=[sl.start, sl.stop], lam=float(params.lam),
                      m=params.m.numpy().tolist(), u=params.u.numpy().tolist(),
                      lam_hist=hist["lam"].tolist(), ll_hist=hist["ll"].tolist())
    else:
        import splink_tpu_torch
        import splink_tpu_torch.gammas as gammas

        gammas.MAX_PATTERNS = 1  # the streamed-stats regime, as the reference's worker
        ckpt = os.path.join(work_dir, "ckpt" if mode != "resume_split" else f"ckpt{rank}")
        linker = splink_tpu_torch.Splink(
            _linker_settings(telemetry_dir=os.path.join(work_dir, "tel")),
            df=_linker_frame(), device="cpu")
        try:
            linker.estimate_parameters(checkpoint_dir=ckpt, resume=mode != "linker")
        except RuntimeError as e:
            result["error"] = str(e)
        linker.close_telemetry()
        result.update(n_pairs=int(linker._pairs.n_pairs),
                      lam=float(linker.params.params["λ"]),
                      history=[[float(h["λ"])] for h in linker.params.param_history])
    with open(out, "w") as fh:
        json.dump(result, fh)
    dist.shutdown_multihost()
    return 0


# --------------------------------------------------------------------------
# The tests
# --------------------------------------------------------------------------


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


# The rendezvous port is free when _free_port returns it, but another
# process on the host can take it before rank 0 binds it; a launch whose
# worker says so is repeated on a new port, at most this many times
PORT_ATTEMPTS = 3


def _launch(tmp_path, mode, world=2, work_dir=None):
    """Run ``world`` workers to their end; their results in rank order.
    A worker that fails or outlives its wall limit fails the test with its
    stderr, after every worker is stopped."""
    for _ in range(PORT_ATTEMPTS):
        errors = _run_workers(tmp_path, mode, world, work_dir)
        if not any("Address already in use" in e for e in errors):
            break
    assert not errors, "\n".join(errors)
    results = []
    for r in range(world):
        with open(tmp_path / f"{mode}{r}.json") as fh:
            results.append(json.load(fh))
    return results


def _run_workers(tmp_path, mode, world, work_dir):
    """One launch of the workers on a fresh port; the errors of those that
    failed or outlived their wall limit, after every worker is stopped."""
    port = _free_port()
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = ROOT
    outs = [str(tmp_path / f"{mode}{r}.json") for r in range(world)]
    procs = [
        subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), mode, str(r), str(world), str(port),
             outs[r], *([work_dir] if work_dir else [])],
            cwd=ROOT, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for r in range(world)
    ]
    errors = []
    try:
        for p in procs:
            try:
                _, err = p.communicate(timeout=WORKER_TIMEOUT_S)
            except subprocess.TimeoutExpired:
                errors.append(f"a worker outlived {WORKER_TIMEOUT_S} s")
                break
            if p.returncode != 0:
                errors.append(err[-3000:])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    return errors


def test_two_process_streamed_em_matches_single_process(tmp_path):
    import jax.numpy as jnp

    from splink_tpu.models.fellegi_sunter import FSParams
    from splink_tpu.parallel.streaming import run_em_streamed

    results = _launch(tmp_path, "stream")
    for i, r in enumerate(results):
        assert r["process_count"] == 2 and r["process_id"] == i
    s0, s1 = results[0]["slice"], results[1]["slice"]
    assert s0[0] == 0 and s0[1] == s1[0] and s1[1] == N_STREAM
    # every process updated from the global aggregate: equal parameters
    assert results[0]["lam"] == results[1]["lam"]
    assert results[0]["m"] == results[1]["m"] and results[0]["u"] == results[1]["u"]

    G, (lam, m, u) = _stream_data()
    init = FSParams(lam=jnp.float64(lam), m=jnp.asarray(m), u=jnp.asarray(u))

    def batches():
        for s in range(0, N_STREAM, 1024):
            yield G[s:s + 1024]

    params, hist, _, _ = run_em_streamed(batches, init, max_iterations=6, max_levels=3,
                                         em_convergence=0.0, compute_ll=True)
    np.testing.assert_allclose(results[0]["lam_hist"], np.asarray(hist["lam"]), rtol=1e-12)
    for r in results:  # the log likelihood is the GLOBAL one in every process
        np.testing.assert_allclose(r["ll_hist"], np.asarray(hist["ll"]), rtol=1e-9)
    np.testing.assert_allclose(results[0]["m"], np.asarray(params.m), rtol=1e-12)
    np.testing.assert_allclose(results[0]["u"], np.asarray(params.u), rtol=1e-12)


@pytest.fixture(scope="module")
def reference_linker_lambda():
    """splink_tpu's single-process run of the facade job in the forced
    streamed regime (the reference test's oracle)."""
    import splink_tpu
    import splink_tpu.gammas as ref_gammas

    saved = ref_gammas.MAX_PATTERNS
    ref_gammas.MAX_PATTERNS = 1
    try:
        linker = splink_tpu.Splink(_linker_settings(), df=_linker_frame())
        G = linker._ensure_gammas()
        linker._run_em(G, compute_ll=False)
    finally:
        ref_gammas.MAX_PATTERNS = saved
    return len(G), float(linker.params.params["λ"])


def test_two_process_linker_facade_matches_single_process(tmp_path, reference_linker_lambda):
    from splink_tpu_torch.obs.events import read_events
    from splink_tpu_torch.resilience.checkpoint import load_checkpoint

    n_pairs, want = reference_linker_lambda
    results = _launch(tmp_path, "linker", work_dir=str(tmp_path))
    assert [r["process_count"] for r in results] == [2, 2]
    assert all(r["n_pairs"] == n_pairs for r in results)
    # both processes converge to the SAME lambda (the global aggregate)
    assert results[0]["lam"] == results[1]["lam"]
    np.testing.assert_allclose(results[0]["lam"], want, rtol=1e-9)
    # one checkpoint, written by process 0, recording the topology
    ckpt = load_checkpoint(tmp_path / "ckpt")
    assert ckpt is not None and ckpt.process_count == 2
    assert ckpt.lam == results[0]["lam"]
    # every event names its process
    tel = tmp_path / "tel"
    ranks = set()
    for name in os.listdir(tel):
        events = read_events(str(tel / name))
        assert events and len({(e["process_index"], e["process_count"]) for e in events}) == 1
        ranks.add((events[0]["process_index"], events[0]["process_count"]))
    assert ranks == {(0, 2), (1, 2)}

    # a resume in both processes agrees on the checkpoint and finishes with
    # the same parameters
    resumed = _launch(tmp_path, "resume", work_dir=str(tmp_path))
    assert all("error" not in r for r in resumed), resumed
    assert [r["lam"] for r in resumed] == [results[0]["lam"]] * 2
    assert resumed[0]["history"] == results[0]["history"]

    # per-process checkpoint directories: process 1 finds none, so both
    # refuse instead of one resuming while the other trains fresh
    os.rename(tmp_path / "ckpt", tmp_path / "ckpt0")
    split = _launch(tmp_path, "resume_split", work_dir=str(tmp_path))
    for r in split:
        assert "disagree on checkpoint presence" in r["error"], r


if __name__ == "__main__":
    sys.exit(_worker(sys.argv[1], int(sys.argv[2]), int(sys.argv[3]), sys.argv[4],
                     sys.argv[5], *sys.argv[6:7]))
