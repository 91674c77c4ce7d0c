"""splink_tpu_torch.parallel.distributed against splink_tpu's: the port's
counterpart of tests/test_distributed.py, plus the resume-topology
refusals (tests/test_checkpoint_resume.py) with the reference's messages.

Without a process group the port is process 0 of 1: the slice is the whole
range, the reductions are identities, the tags say (0, 1) and the spill
store is the base directory. Under mocked topologies (process_count and
process_index monkeypatched in both packages) the slices partition the
pair axis exactly as the reference's do, and two simulated processes'
summed statistics give the single process's update (rtol 1e-12). Real
processes: tests/test_torch_multiprocess.py.
"""

import copy
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)
pd = pytest.importorskip("pandas")

import jax  # noqa: E402

import splink_tpu  # noqa: E402
import splink_tpu.parallel.distributed as ref_dist  # noqa: E402
import splink_tpu_torch  # noqa: E402
import splink_tpu_torch.parallel.distributed as dist  # noqa: E402
from splink_tpu.resilience.checkpoint import EMCheckpoint as RefEMCheckpoint  # noqa: E402
from splink_tpu.resilience.checkpoint import save_checkpoint as ref_save_checkpoint  # noqa: E402
from splink_tpu_torch.models.fellegi_sunter import (  # noqa: E402
    FSParams,
    match_probability,
    sufficient_stats,
    update_params,
)
from splink_tpu_torch.resilience.checkpoint import EMCheckpoint, save_checkpoint  # noqa: E402


def _topology(monkeypatch, n_procs, pid):
    """Both packages see process ``pid`` of ``n_procs``."""
    monkeypatch.setattr(dist, "process_count", lambda: n_procs)
    monkeypatch.setattr(dist, "process_index", lambda: pid)
    monkeypatch.setattr(jax, "process_count", lambda: n_procs)
    monkeypatch.setattr(jax, "process_index", lambda: pid)


def test_single_process_defaults():
    assert not dist.distributed_is_initialized()
    assert (dist.process_count(), dist.process_index()) == (1, 0)
    assert dist.global_pair_slice(1000) == slice(0, 1000)
    assert dist.global_pair_slice(0) == slice(0, 0)
    assert dist.host_tags() == ref_dist.host_tags() == {"process_index": 0, "process_count": 1}
    assert dist.spill_shard_dir("/x/build") == ref_dist.spill_shard_dir("/x/build") == "/x/build"
    stats = (torch.ones(3), torch.zeros(2))
    assert dist.all_sum_stats(stats) is stats
    assert dist.validate_resume_presence(True) is True
    assert dist.validate_resume_presence(False) is False
    dist.validate_resume_topology(1, "h", 3)


def test_initialize_multihost_single_process_is_noop(monkeypatch):
    # no coordinator, no torchrun environment: a logged no-op
    for k in ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT"):
        monkeypatch.delenv(k, raising=False)
    dist.initialize_multihost()
    assert not dist.distributed_is_initialized()


def test_initialize_multihost_explicit_misconfig_raises():
    # a malformed coordinator fails at once (no connection is attempted)
    with pytest.raises(RuntimeError, match="init_process_group failed for coordinator"):
        dist.initialize_multihost(coordinator_address="localhost:notaport",
                                  num_processes=2, process_id=0)
    assert not dist.distributed_is_initialized()


def test_shutdown_multihost_without_a_group_is_noop():
    dist.shutdown_multihost()
    assert not dist.distributed_is_initialized()


def test_shutdown_multihost_leaves_the_group():
    """A real one-process Gloo group over local TCP: up after
    initialize_multihost, gone after shutdown_multihost, and a second
    shutdown is a no-op."""
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    dist.initialize_multihost(f"127.0.0.1:{port}", 1, 0, backend="gloo")
    try:
        assert dist.distributed_is_initialized()
        assert (dist.process_count(), dist.process_index()) == (1, 0)
    finally:
        dist.shutdown_multihost()
    assert not dist.distributed_is_initialized()
    dist.shutdown_multihost()


@pytest.mark.parametrize("env, process_id, card", [
    ({"LOCAL_RANK": "3", "RANK": "7", "WORLD_SIZE": "8", "MASTER_ADDR": "h",
      "MASTER_PORT": "1"}, None, 3),   # torchrun: LOCAL_RANK names the card
    ({}, 5, 1),                         # explicit rank 5 of 4 cards: 5 % 4
])
def test_initialize_multihost_binds_the_rank_to_its_card(monkeypatch, env, process_id, card):
    # each rank computes on its own card: set_device runs before the group
    # is joined (4 visible cards, init_process_group stubbed)
    calls = []
    for k in ("LOCAL_RANK", "RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT"):
        monkeypatch.delenv(k, raising=False)
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    monkeypatch.setattr(torch.cuda, "set_device", lambda d: calls.append(("set_device", d)))
    monkeypatch.setattr(dist.dist, "init_process_group",
                        lambda **kw: calls.append(("init_process_group", kw.get("rank"))))
    if process_id is None:
        dist.initialize_multihost()
    else:
        dist.initialize_multihost(coordinator_address="localhost:1", num_processes=8,
                                  process_id=process_id)
    assert calls == [("set_device", card), ("init_process_group", process_id)]


@pytest.mark.parametrize("n_procs", [2, 3, 8])
@pytest.mark.parametrize("n_pairs", [0, 1, 7, 1000, 1001])
def test_slices_partition_the_pair_axis(monkeypatch, n_procs, n_pairs):
    """Across all processes the slices are disjoint, ordered, cover [0, n),
    balanced to within one batch, and equal the reference's."""
    slices = []
    for pid in range(n_procs):
        _topology(monkeypatch, n_procs, pid)
        s = dist.global_pair_slice(n_pairs)
        assert s == ref_dist.global_pair_slice(n_pairs)
        slices.append(s)
    covered = []
    for s in slices:
        assert 0 <= s.start <= s.stop <= n_pairs
        covered.extend(range(s.start, s.stop))
    assert covered == list(range(n_pairs))
    sizes = [s.stop - s.start for s in slices]
    assert max(sizes) <= -(-n_pairs // n_procs) if n_pairs else max(sizes) == 0


def test_multihost_streamed_em_equals_single_host(monkeypatch):
    """Two simulated processes: each computes the sufficient statistics of
    its global_pair_slice, the sums (what all_sum_stats forms) give the
    single process's update, and the reference's single update."""
    from splink_tpu.models import fellegi_sunter as ref_fs

    rng = np.random.default_rng(0)
    N, C = 10_000, 2
    G = rng.integers(-1, 3, size=(N, C)).astype(np.int8)
    lam, m, u = 0.4, np.tile([0.1, 0.2, 0.7], (C, 1)), np.tile([0.7, 0.2, 0.1], (C, 1))
    init = FSParams(torch.tensor(lam, dtype=torch.float64), torch.tensor(m), torch.tensor(u))

    def one_pass(Gs):
        Gt = torch.from_numpy(Gs)
        return sufficient_stats(Gt, match_probability(Gt, init), 3)

    single = update_params(one_pass(G))
    parts = []
    for pid in range(2):
        _topology(monkeypatch, 2, pid)
        parts.append(one_pass(G[dist.global_pair_slice(N)]))
    combined = update_params(parts[0] + parts[1])
    import jax.numpy as jnp

    rinit = ref_fs.FSParams(lam=jnp.asarray(lam), m=jnp.asarray(m), u=jnp.asarray(u))
    ref = ref_fs.update_params(ref_fs.sufficient_stats(
        jnp.asarray(G), ref_fs.match_probability(jnp.asarray(G), rinit), 3))
    for want in (single, ref):
        for a, b in zip(combined, want):
            np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=1e-12)


def test_multi_process_tags_and_spill_dirs(monkeypatch):
    monkeypatch.setattr(dist, "distributed_is_initialized", lambda: True)
    _topology(monkeypatch, 4, 3)
    assert dist.host_tags() == {"process_index": 3, "process_count": 4}
    assert dist.spill_shard_dir("/x/build") == os.path.join("/x/build", "proc3")
    monkeypatch.setattr(ref_dist, "distributed_is_initialized", lambda: True)
    assert dist.spill_shard_dir("/x/build") == ref_dist.spill_shard_dir("/x/build")


# --------------------------------------------------------------------------
# Resume topology
# --------------------------------------------------------------------------


def _df():
    rng = np.random.default_rng(0)
    n = 300
    return pd.DataFrame({
        "unique_id": np.arange(n),
        "first_name": rng.choice(["ann", "bob", "cat", "dan"], n),
        "surname": rng.choice(["x", "y", "z"], n),
    })


SETTINGS = {
    "link_type": "dedupe_only",
    "comparison_columns": [
        {"col_name": "first_name", "num_levels": 2, "comparison": {"kind": "exact"}},
        {"col_name": "surname", "num_levels": 2, "comparison": {"kind": "exact"}},
    ],
    "blocking_rules": [],
    "max_iterations": 3,
    "max_resident_pairs": 1024,
}


def _ckpt(cls, state_hash, process_count):
    return cls(state_hash=state_hash, iteration=2, lam=0.3,
               m=[[0.2, 0.8], [0.3, 0.7]], u=[[0.7, 0.3], [0.6, 0.4]],
               histories={"lam": [0.5, 0.4, 0.3], "m": [], "u": [], "ll": None},
               converged=False, process_count=process_count, dtype="float32")


@pytest.mark.parametrize("resident", [False, True])
def test_resume_topology_mismatch_rejected_with_reference_message(tmp_path, resident):
    """A checkpoint of a 2-process run cannot resume in one process (the
    global pair slices would not line up): both packages refuse it with
    the same message, in the streamed and the resident regime."""
    s = dict(SETTINGS, max_resident_pairs=1 << 20) if resident else dict(SETTINGS)
    df = _df()
    ours = splink_tpu_torch.Splink(copy.deepcopy(s), df=df, device="cpu")
    theirs = splink_tpu.Splink(copy.deepcopy(s), df=df)
    save_checkpoint(tmp_path / "port", _ckpt(EMCheckpoint, ours._em_state_hash(), 2))
    ref_save_checkpoint(tmp_path / "ref", _ckpt(RefEMCheckpoint, theirs._em_state_hash(), 2))
    with pytest.raises(RuntimeError, match="process") as a:
        ours.estimate_parameters(checkpoint_dir=tmp_path / "port", resume=True)
    with pytest.raises(RuntimeError, match="process") as b:
        theirs.estimate_parameters(checkpoint_dir=tmp_path / "ref", resume=True)
    assert str(a.value) == str(b.value)
    assert str(a.value).startswith("checkpoint was written by 2 process(es) but this run has 1")


def test_resume_checks_are_collective_in_every_regime(tmp_path, monkeypatch):
    """Every resume validates presence (a collective under several
    processes) even when no checkpoint exists yet, then trains fresh."""
    calls = []
    real = dist.validate_resume_presence

    def spy(found):
        calls.append(found)
        return real(found)

    monkeypatch.setattr(dist, "validate_resume_presence", spy)
    for extra in ({}, {"max_resident_pairs": 1 << 20}):
        linker = splink_tpu_torch.Splink({**SETTINGS, **extra}, df=_df(), device="cpu")
        linker.estimate_parameters(checkpoint_dir=tmp_path / str(len(calls)), resume=True)
    assert calls == [False, False]


@pytest.mark.parametrize("agree", [True, False])
def test_validate_resume_topology_rows(monkeypatch, agree):
    """Under several processes the hash digest and iteration rows of every
    process must agree (the gather is mocked with two processes' rows)."""
    monkeypatch.setattr(dist, "process_count", lambda: 2)
    h = "abc"
    digest = np.frombuffer(__import__("hashlib").sha256(h.encode()).digest()[:8], np.int64)[0]
    other = [digest, 4] if agree else [digest, 5]
    monkeypatch.setattr(dist, "_gather_host", lambda local: np.stack([local, np.array(other)]))
    if agree:
        dist.validate_resume_topology(2, h, 4)
    else:
        with pytest.raises(RuntimeError, match="disagree on the checkpoint being resumed"):
            dist.validate_resume_topology(2, h, 4)
    monkeypatch.setattr(dist, "_gather_host", lambda local: np.array([[1], [0]]))
    with pytest.raises(RuntimeError, match="disagree on checkpoint presence"):
        dist.validate_resume_presence(True)
