"""Streamed EM (parallel/streaming.py), the one-axis ``data`` mesh over the
pair axis (parallel/mesh.py) and multi-process training over
``torch.distributed`` (parallel/distributed.py)."""

from .distributed import global_pair_slice, initialize_multihost  # noqa: F401
from .mesh import (  # noqa: F401
    DATA_AXIS,
    make_mesh,
    mesh_from_settings,
    pair_sharding,
    replicated,
    shard_pairs,
)
from .streaming import run_em_streamed, score_stream  # noqa: F401

__all__ = [
    "DATA_AXIS",
    "make_mesh",
    "mesh_from_settings",
    "pair_sharding",
    "replicated",
    "shard_pairs",
    "run_em_streamed",
    "score_stream",
    "initialize_multihost",
    "global_pair_slice",
]
