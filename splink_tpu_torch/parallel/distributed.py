"""Multi-process (multi-controller) initialisation and work partitioning.

The port of splink_tpu/parallel/distributed.py on ``torch.distributed``.
Every process runs the same program over the same global pair set, feeds
its own :func:`global_pair_slice` of it, and the per-pass EM sufficient
statistics are summed across processes (:func:`all_sum_stats`) so every
process updates from the global aggregate. The payload is a few KB per EM
pass.

The collective backend is PyTorch's default unless the caller names one:
NCCL for CUDA tensors, Gloo for CPU tensors. NCCL refuses two ranks on one
GPU, so processes that share a card pass ``backend="gloo"``; their CUDA
tensors then cross the collective through host memory. Every rendezvous
and collective is bounded by :data:`TIMEOUT`.
"""

from __future__ import annotations

import datetime
import hashlib
import logging
import os

import numpy as np
import torch
import torch.distributed as dist

from .mesh import _leaves, _rebuild

logger = logging.getLogger("splink_tpu_torch")

# The bound on the rendezvous and on every collective: a process that died
# or never joined fails its peers' calls instead of hanging them.
TIMEOUT = datetime.timedelta(minutes=5)

_TORCHRUN_ENV = ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT")


def distributed_is_initialized() -> bool:
    """Whether the process group is up."""
    return dist.is_available() and dist.is_initialized()


def process_count() -> int:
    """The number of controller processes (1 without a process group)."""
    return dist.get_world_size() if distributed_is_initialized() else 1


def process_index() -> int:
    """This process's rank (0 without a process group)."""
    return dist.get_rank() if distributed_is_initialized() else 0


def initialize_multihost(
    coordinator_address: str | None = None,
    num_processes: int | None = None,
    process_id: int | None = None,
    backend: str | None = None,
) -> None:
    """Initialise the process group.

    Explicit arguments rendezvous at ``tcp://<coordinator_address>``;
    without them the ``torchrun`` environment (RANK, WORLD_SIZE,
    MASTER_ADDR, MASTER_PORT) is used, and with neither this is a logged
    no-op (a single-process run). Explicit arguments that fail to connect
    raise: a misconfigured cluster must not silently degrade to one host.
    ``backend`` None is PyTorch's default (NCCL for CUDA tensors, Gloo for
    CPU tensors); ranks that share one GPU must pass ``"gloo"``. Where a
    card is present the process binds to its own first (:func:`_local_card`),
    so the default ``cuda`` device of every entry point is that card."""
    if distributed_is_initialized():
        return  # already initialised
    explicit = coordinator_address is not None
    if explicit:
        kwargs = dict(init_method=f"tcp://{coordinator_address}",
                      world_size=num_processes, rank=process_id)
    elif all(k in os.environ for k in _TORCHRUN_ENV):
        kwargs = dict(init_method="env://")
    else:
        logger.info("no multi-host environment detected (no coordinator address "
                    "and no %s in the environment); running single-process",
                    "/".join(_TORCHRUN_ENV))
        return
    if torch.cuda.is_available():
        torch.cuda.set_device(_local_card(process_id))
    try:
        dist.init_process_group(backend=backend, timeout=TIMEOUT, **kwargs)
    except (ValueError, RuntimeError) as e:
        if explicit:
            raise RuntimeError(
                f"torch.distributed.init_process_group failed for coordinator "
                f"{coordinator_address!r}: {e}"
            ) from e
        raise


def shutdown_multihost() -> None:
    """Leave the process group before the process exits: a barrier, so no
    process tears its side down while a peer still uses it, then
    ``destroy_process_group``. A no-op without a group. A process that
    exits with the group still up leaves Gloo's threads to the
    interpreter's teardown, which can abort it ("terminate called without
    an active exception") after its work is done."""
    if not distributed_is_initialized():
        return
    dist.barrier()
    dist.destroy_process_group()


def _local_card(process_id: int | None) -> int:
    """The card this process computes on: ``LOCAL_RANK`` where the launcher
    sets it (torchrun does), else the rank (``process_id``, or ``RANK``)
    modulo the visible cards. The reference's processes each get their own
    local devices from ``jax.distributed.initialize``; without this every
    rank would take the current device, ``cuda:0``, and NCCL refuses two
    ranks on one card. On one card every rank maps to ``cuda:0``."""
    if "LOCAL_RANK" in os.environ:
        return int(os.environ["LOCAL_RANK"])
    rank = process_id if process_id is not None else int(os.environ["RANK"])
    return rank % torch.cuda.device_count()


def _all_gather(flat: torch.Tensor) -> list[torch.Tensor]:
    """Every process's ``flat`` (one 1-D tensor), in rank order, on
    ``flat``'s device. Gloo carries CPU tensors only, so under it a CUDA
    tensor crosses through host memory."""
    via = flat
    if flat.is_cuda and dist.get_backend() == "gloo":
        via = flat.cpu()
    out = [torch.empty_like(via) for _ in range(dist.get_world_size())]
    dist.all_gather(out, via.contiguous())
    return [t.to(flat.device) for t in out]


def all_sum_stats(stats):
    """Sum a SufficientStats tuple (or any small tuple tree of tensors of
    one dtype) across controller processes: the multi-process counterpart
    of the mesh reduction. ONE all-gather of the packed leaves, then a sum
    over the processes in rank order, so every process holds bit-identical
    sums (a ring all-reduce's order is not rank order).

    Single-process: identity. Pass as ``run_em_streamed(...,
    stats_reduce=all_sum_stats)``."""
    if process_count() == 1:
        return stats
    leaves = _leaves(stats)
    flat = torch.cat([leaf.reshape(-1) for leaf in leaves])
    gathered = _all_gather(flat)
    total = gathered[0]
    for part in gathered[1:]:
        total = total + part
    pieces, pos = [], 0
    for leaf in leaves:
        pieces.append(total[pos:pos + leaf.numel()].reshape(leaf.shape))
        pos += leaf.numel()
    return _rebuild(stats, iter(pieces))


def _gather_host(local: np.ndarray) -> np.ndarray:
    """(process_count, *local.shape) int64: every process's ``local``."""
    return torch.stack(_all_gather(torch.from_numpy(np.ascontiguousarray(local)))).numpy()


def validate_resume_presence(found: bool) -> bool:
    """All processes must agree whether the checkpoint exists BEFORE any
    loader-only work happens: validate_resume_topology is a collective,
    and a resumed process also starts from a different iteration than a
    fresh one — either divergence deadlocks or corrupts the run. Mixed
    found-flags mean checkpoint_dir is per-host storage (only process 0
    writes); raise with that diagnosis instead of hanging. Every process
    must call this when resuming under multi-controller. Returns
    ``found`` unchanged for the single-process case and for agreement."""
    if process_count() == 1:
        return found
    gathered = _gather_host(np.array([1 if found else 0], np.int64)).ravel()
    if gathered.min() != gathered.max():
        raise RuntimeError(
            "processes disagree on checkpoint presence (found flags "
            f"{gathered.tolist()}): only process 0 writes checkpoints, so "
            "checkpoint_dir must be on storage shared by every controller "
            "process."
        )
    return found


def validate_resume_topology(
    checkpoint_process_count: int, state_hash: str, iteration: int
) -> None:
    """Gate a multi-controller checkpoint resume on topology agreement.

    A resumed run must (a) have the SAME process count the checkpoint was
    written under — global_pair_slice partitions by process count, so a
    different topology would stream different slices than the histories
    assume — and (b) agree ACROSS processes on which checkpoint it is
    resuming (same settings hash, same iteration). Disagreement raises
    before any training continues; the single-process case checks only (a).
    """
    if process_count() != checkpoint_process_count:
        raise RuntimeError(
            f"checkpoint was written by {checkpoint_process_count} "
            f"process(es) but this run has {process_count()}: the "
            "global pair slices would not line up. Resume with the same "
            "topology, or train fresh with resume=False."
        )
    if process_count() == 1:
        return
    digest = np.frombuffer(hashlib.sha256(state_hash.encode()).digest()[:8], np.int64)[0]
    local = np.array([digest, iteration], np.int64)
    gathered = _gather_host(local)
    if not (gathered == local[None, :]).all():
        raise RuntimeError(
            "processes disagree on the checkpoint being resumed "
            f"(hash-digest/iteration rows: {gathered.tolist()}); refusing "
            "to continue from inconsistent state."
        )


def host_tags() -> dict:
    """Per-process identity tags stamped on every telemetry event
    (``process_index`` / ``process_count``), so a multi-process run's
    merged records attribute each event to its process. A run without a
    process group IS process 0 of 1."""
    return {"process_index": process_index(), "process_count": process_count()}


def spill_shard_dir(base: str) -> str:
    """Per-process root for the durable spill write path: under
    multi-controller each process emits ITS shard subset of the pair
    stream into its own ``<base>/proc<k>`` store (single-writer manifests
    — the same discipline as the checkpoint writer), while a
    single-process run uses ``base`` directly so the common case has no
    extra directory level. ``base`` must be shared storage when the
    consuming EM later runs with a different controller layout."""
    if not distributed_is_initialized():
        return base
    return os.path.join(base, f"proc{process_index()}")


def global_pair_slice(n_pairs_global: int) -> slice:
    """The half-open range of global pair indices this process feeds.
    Processes stream disjoint slices; the stats reduction makes the union
    behave like one global aggregate."""
    per = -(-n_pairs_global // process_count())
    start = min(process_index() * per, n_pairs_global)
    return slice(start, min(start + per, n_pairs_global))
