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

Not ported yet (ROADMAP.md Queue 1 item 13): the AOT executable sidecar
(``serve/aot.py``), the replica router (``router.py``) and the multi-host
wire tier (``wire.py``, ``remote.py``).
"""

from .admission import CircuitBreaker, WaitEstimator
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
from .service import LinkageService, QueryResult

__all__ = [
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
    "HealthMonitor",
    "HEALTHY",
    "DEGRADED",
    "BROKEN",
    "CircuitBreaker",
    "WaitEstimator",
]
