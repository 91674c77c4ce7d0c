"""The device mesh: one ``data`` axis over the candidate-pair axis.

The port of splink_tpu/parallel/mesh.py. The pair axis shards over a 1-D
mesh of devices; the parameters are replicated. Where the reference's
compiled programs ``psum`` the per-device M-step statistics, the port sums
the per-shard statistics on the mesh's first device, in shard order
(:func:`reduce_shards`), so a sharded run is deterministic.

A sharded array is a :class:`Sharded`: the contiguous pieces of the padded
leading axis, piece k on shard k's device. On a CUDA device the mesh is
``cuda:0 .. cuda:N-1``; on the CPU every shard is the one CPU device, the
counterpart of the reference test tier's forced host devices.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import NamedTuple

import numpy as np
import torch

from .._device import resolve_device

DATA_AXIS = "data"

# The CPU's visible device count: the reference's test tier forces 8 host
# devices (tests/conftest.py), so a CPU mesh takes up to 8 shards and a
# larger one is refused as there.
CPU_VISIBLE_DEVICES = 8

# calls of reduce_shards so far, the port's collectives: the shard audit
# counts them over a call, as strings_cuda.launches counts kernel launches
reductions = 0
# above 0 while reduce_shards sums: the shard audit tells the reduction's
# cross-shard additions from a gather by it
reducing = 0


@dataclass(frozen=True)
class Mesh:
    """A 1-D mesh: the shards' devices, in shard order, and the axis name.
    Hashable, so per-mesh caches key on the value."""

    devices: tuple[torch.device, ...]
    axis_name: str = DATA_AXIS

    @property
    def size(self) -> int:
        return len(self.devices)


class Sharded(NamedTuple):
    """An array split along its leading axis over a mesh: ``shards[k]``
    lives on shard k's device."""

    shards: tuple[torch.Tensor, ...]

    @property
    def shape(self) -> tuple[int, ...]:
        return (sum(s.shape[0] for s in self.shards), *self.shards[0].shape[1:])

    def to(self, dtype) -> "Sharded":
        return Sharded(tuple(s.to(dtype) for s in self.shards))


def visible_devices(device=None) -> list[torch.device]:
    """The devices a mesh on ``device``'s type may use (``cuda`` unless
    named; raises without a card)."""
    dev = resolve_device(device)
    if dev.type == "cuda":
        return [torch.device("cuda", k) for k in range(torch.cuda.device_count())]
    return [dev] * CPU_VISIBLE_DEVICES


def make_mesh(n_devices: int | None = None, axis_name: str = DATA_AXIS,
              device=None) -> Mesh:
    """A 1-D mesh over the first ``n_devices`` visible devices (default:
    all)."""
    devices = visible_devices(device)
    if n_devices is not None:
        devices = devices[:n_devices]
    return Mesh(tuple(devices), axis_name)


def mesh_from_settings(settings: dict, device=None) -> Mesh | None:
    """The mesh the settings' ``mesh`` dict describes, or None.

    ``{"data": N}`` shards the pair axis over N devices. ``{"data": 1}`` is
    an EXPLICIT one-device mesh (the sharded code path with one shard), not
    the same as the empty dict or an absent key, which select the unsharded
    path."""
    spec = settings.get("mesh") or {}
    if not spec:
        return None
    supported = (
        f"the supported form is {{{DATA_AXIS!r}: N}} — a 1-D mesh over the "
        f"pair axis with 1 <= N <= the visible device count"
    )
    if list(spec.keys()) != [DATA_AXIS]:
        raise ValueError(f"unsupported mesh spec {spec!r}; {supported}")
    n = spec[DATA_AXIS]
    if isinstance(n, bool) or not isinstance(n, int) or n < 1:
        raise ValueError(f"unsupported mesh size {n!r} in {spec!r}; {supported}")
    available = len(visible_devices(device))
    if n > available:
        raise ValueError(
            f"mesh spec {spec!r} requests {n} devices but only {available} "
            f"are visible; {supported}"
        )
    return make_mesh(n, device=device)


def _as_tensor(a) -> torch.Tensor:
    if isinstance(a, torch.Tensor):
        return a
    return torch.from_numpy(np.ascontiguousarray(a))


def pair_sharding(mesh: Mesh, a) -> Sharded:
    """``a`` (leading axis a multiple of the mesh size) split into the
    mesh's contiguous pieces, piece k on shard k's device."""
    t = _as_tensor(a)
    per = t.shape[0] // mesh.size
    return Sharded(tuple(t[k * per:(k + 1) * per].to(dev)
                         for k, dev in enumerate(mesh.devices)))


def replicated(mesh: Mesh, a) -> tuple[torch.Tensor, ...]:
    """``a`` on every shard's device (one copy per distinct device)."""
    t = _as_tensor(a)
    copies: dict = {}
    return tuple(copies.setdefault(dev, t.to(dev)) for dev in mesh.devices)


def pad_to_multiple(n: int, multiple: int) -> int:
    return ((n + multiple - 1) // multiple) * multiple


def shard_pairs(mesh: Mesh, *arrays):
    """Pad the leading axis to a multiple of the mesh size and shard it.
    Returns (padded sharded arrays..., weights), weights float32 1.0 for
    real rows and 0.0 for padding: thread it into EM so that padding rows
    (gamma -1, or 0 for unsigned and float arrays) contribute nothing."""
    n = arrays[0].shape[0]
    n_dev = mesh.size
    n_pad = pad_to_multiple(max(n, n_dev), n_dev)
    out = []
    for a in arrays:
        a = np.asarray(a.cpu() if isinstance(a, torch.Tensor) else a)
        if n_pad != n:
            fill = -1 if np.issubdtype(a.dtype, np.signedinteger) else 0
            a = np.concatenate([a, np.full((n_pad - n,) + a.shape[1:], fill, a.dtype)])
        out.append(pair_sharding(mesh, a))
    weights = np.zeros(n_pad, np.float32)
    weights[:n] = 1.0
    out.append(pair_sharding(mesh, weights))
    return tuple(out)


def shard_ranges(mesh: Mesh, start: int, stop: int, padded: int) -> list[tuple[int, int]]:
    """The real rows [lo, hi) of each shard when ``padded`` rows from
    ``start`` split evenly over the mesh and only [start, stop) are real
    (a tail batch): shard k holds [start + k*per, start + (k+1)*per)."""
    per = padded // mesh.size
    return [(min(start + k * per, stop), min(start + (k + 1) * per, stop))
            for k in range(mesh.size)]


def _leaves(tree) -> list[torch.Tensor]:
    """The tensors of a tensor or a (Named)tuple tree, in order."""
    if isinstance(tree, torch.Tensor):
        return [tree]
    return [leaf for sub in tree for leaf in _leaves(sub)]


def _rebuild(tree, leaves):
    """``tree``'s structure over the tensors of the iterator ``leaves``."""
    if isinstance(tree, torch.Tensor):
        return next(leaves)
    vals = [_rebuild(sub, leaves) for sub in tree]
    return type(tree)(*vals) if hasattr(tree, "_fields") else type(tree)(vals)


def reduce_shards(parts):
    """The sum of per-shard values (a tensor or a tuple / NamedTuple of
    tensors) on the first part's device, added in shard order: the port's
    counterpart of the mesh ``psum``, with one fixed order so a run is
    deterministic."""
    global reductions, reducing
    reductions += 1
    reducing += 1
    try:
        sums = _leaves(parts[0])
        dev = sums[0].device
        for p in parts[1:]:
            sums = [a + b.to(dev) for a, b in zip(sums, _leaves(p))]
        return _rebuild(parts[0], iter(sums))
    finally:
        reducing -= 1
