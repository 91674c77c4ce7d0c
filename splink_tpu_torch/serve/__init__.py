"""Online linkage serving on PyTorch: the frozen index artifact, the
shape-bucketed query engine and the micro-batching front-end (the port of
splink_tpu/serve).

    linker = Splink(settings, df=reference_df)
    linker.estimate_parameters()
    index = linker.export_index("index_dir")         # frozen artifact

    # in the serving process (on cuda unless device= names another)
    from splink_tpu_torch.serve import load_index, QueryEngine, LinkageService
    engine = QueryEngine(load_index("index_dir"))
    engine.warmup()
    with LinkageService(engine) as svc:
        result = svc.query({"first_name": "amelia", "surname": "smith",
                            "dob": "1987"})

Resilience: per-replica health states with hysteresis (:mod:`.health`),
deadline admission, brown-out and a circuit breaker (:mod:`.admission`,
threaded through the service), index hot-swap with parity probes and
rollback (:meth:`QueryEngine.swap_index`) and a watchdog that recovers
from worker-thread death. The artifact format is splink_tpu's: an index
either package saves loads in the other. ``python -m
splink_tpu_torch.serve`` is the CLI.

More than one serving process on a model:

  * :mod:`.aot`: ``QueryEngine(aot_dir=)`` / ``save_aot`` store the kernel
    libraries beside the index, so a fresh replica warms up without a
    compiler (``build --aot`` on the CLI);
  * :mod:`.wire` / :mod:`.remote`: ``WireServer(LinkageService(engine))``
    serves a replica over TCP and ``RemoteReplica("host:port")`` is its
    client, with answers equal to the local ones bit for bit; the frames
    are splink_tpu's, so either package talks to the other;
  * :mod:`.router`: ``ReplicaRouter([...])`` routes around a broken
    replica, fails over on a shed and hedges a slow primary;
  * ``obs.fleet``: ``FleetAggregator`` merges the replicas' ``fleet_stats``
    and ``FleetIncidentReporter`` writes incident bundles.
"""

from .admission import CircuitBreaker, WaitEstimator
from .aot import AotStore, AotStoreError
from .bucketing import BucketPolicy, bucket_for
from .engine import IndexSwapError, QueryEngine
from .health import BROKEN, DEGRADED, HEALTHY, HealthMonitor
from .index import (
    IndexMismatchError,
    LinkageIndex,
    QueryBatch,
    ServeIndexError,
    ServeRule,
    build_index,
    load_index,
)
from .remote import RemoteReplica
from .router import Replica, ReplicaRouter
from .service import LinkageService, QueryResult
from .wire import CorruptFrame, FrameTooLarge, TornFrame, WireError, WireServer

__all__ = [
    "AotStore",
    "AotStoreError",
    "BucketPolicy",
    "bucket_for",
    "QueryEngine",
    "IndexSwapError",
    "LinkageIndex",
    "QueryBatch",
    "ServeRule",
    "ServeIndexError",
    "IndexMismatchError",
    "build_index",
    "load_index",
    "LinkageService",
    "QueryResult",
    "Replica",
    "ReplicaRouter",
    "RemoteReplica",
    "WireServer",
    "WireError",
    "FrameTooLarge",
    "TornFrame",
    "CorruptFrame",
    "HealthMonitor",
    "HEALTHY",
    "DEGRADED",
    "BROKEN",
    "CircuitBreaker",
    "WaitEstimator",
]
