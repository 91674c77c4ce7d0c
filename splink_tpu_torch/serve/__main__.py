"""CLI: build, query and benchmark a serving index on the card.

    python -m splink_tpu_torch.serve build --model model.json --data ref.csv \
        --out index_dir [--aot]
    python -m splink_tpu_torch.serve query --index index_dir --data queries.csv
    python -m splink_tpu_torch.serve bench --index index_dir --data queries.csv

The port of ``python -m splink_tpu.serve``. ``build`` loads a model saved
with ``save_model_as_json`` (by either package), encodes the reference
data and writes the frozen artifact. ``query`` prints one JSON line per
(query, match). ``bench`` warms every bucket combination, then replays the
query file through a LinkageService and prints latency percentiles,
throughput and the kernel-library builds after warmup (which must be 0).
Every command runs on ``cuda`` unless ``--device`` names another device.
``build --aot`` warms an engine over the new index and saves its AOT
library sidecar to ``<out>/aot`` (serve/aot.py); ``query`` and ``bench``
restore from ``<index>/aot`` when it is there, so a fresh process builds
no library (a stale sidecar degrades to the ordinary build).
"""

from __future__ import annotations

import argparse
import json
import sys
import time


def _read_frame(path: str):
    import pandas as pd

    if path.endswith(".parquet"):
        return pd.read_parquet(path)
    return pd.read_csv(path)


def _aot_dir(index_dir: str) -> str | None:
    """The index's AOT sidecar directory when one is present."""
    import os

    d = os.path.join(index_dir, "aot")
    return d if os.path.isdir(d) else None


def _cmd_build(args) -> int:
    from ..linker import load_from_json

    df = _read_frame(args.data)
    linker = load_from_json(args.model, df=df, device=args.device)
    index = linker.export_index(args.out)
    aot = None
    if args.aot:
        import os

        from . import QueryEngine
        from .aot import libraries

        engine = QueryEngine(index, aot_dir=os.path.join(args.out, "aot"))
        warm = engine.warmup()
        engine.save_aot()
        aot = {"libraries": len(libraries(engine.device)), **warm}
    print(json.dumps({
        "built": args.out,
        "n_rows": index.n_rows,
        "n_rules": len(index.rules),
        "n_approx_bands": 0 if index.approx is None else index.approx.bands,
        "n_lanes": index.n_lanes,
        "dtype": index.dtype,
        **({"aot": aot} if aot else {}),
    }))
    return 0


def _cmd_query(args) -> int:
    from . import QueryEngine, load_index

    engine = QueryEngine(load_index(args.index, device=args.device), top_k=args.k or None,
                         aot_dir=_aot_dir(args.index))
    engine.warmup()
    out = engine.query(_read_frame(args.data))
    for rec in out.to_dict(orient="records"):
        print(json.dumps(rec, default=str))
    return 0


def _cmd_bench(args) -> int:
    import numpy as np

    from ..obs.metrics import compile_requests
    from . import LinkageService, QueryEngine, load_index

    if not args.data:
        print("bench: no --data given; provide a query file to benchmark against",
              file=sys.stderr)
        return 2
    index = load_index(args.index, device=args.device)
    engine = QueryEngine(index, top_k=args.k or None, aot_dir=_aot_dir(args.index))
    warm = engine.warmup()
    c_warm = compile_requests()
    svc = LinkageService(engine, deadline_ms=args.deadline_ms)
    records = _read_frame(args.data).to_dict(orient="records")
    rows = np.random.default_rng(0).integers(0, len(records), args.queries)
    t0 = time.perf_counter()
    futs = [svc.submit(records[int(r)]) for r in rows]
    for f in futs:
        f.result()
    wall = time.perf_counter() - t0
    svc.close()
    summary = svc.latency_summary()
    print(json.dumps({
        "metric": "serve_queries_per_sec",
        "value": round(args.queries / wall, 1),
        "unit": "queries/sec",
        "queries": args.queries,
        "warmup_combinations": warm["combinations"],
        "warmup_compiles": warm["compiles"],
        "warmup_aot_restored": warm["aot_restored"],
        "steady_state_compiles": compile_requests() - c_warm,
        **{k: round(v, 3) if isinstance(v, float) else v for k, v in summary.items()},
    }))
    return 0


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        prog="python -m splink_tpu_torch.serve",
        description="online linkage serving on PyTorch",
    )
    sub = parser.add_subparsers(dest="cmd", required=True)

    def common(p):
        p.add_argument("--device", default=None,
                       help="torch device (default cuda; cpu runs the plain versions)")

    b = sub.add_parser("build", help="freeze a trained model into an index")
    b.add_argument("--model", required=True, help="save_model_as_json output")
    b.add_argument("--data", required=True, help="reference csv/parquet")
    b.add_argument("--out", required=True, help="index output directory")
    b.add_argument("--aot", action="store_true",
                   help="also save the AOT library sidecar to <out>/aot")
    common(b)
    b.set_defaults(fn=_cmd_build)

    q = sub.add_parser("query", help="score query records against an index")
    q.add_argument("--index", required=True)
    q.add_argument("--data", required=True, help="query csv/parquet")
    q.add_argument("--k", type=int, default=0, help="top-k (settings default)")
    common(q)
    q.set_defaults(fn=_cmd_query)

    n = sub.add_parser("bench", help="steady-state latency/throughput bench")
    n.add_argument("--index", required=True)
    n.add_argument("--data", default="", help="query csv/parquet to replay")
    n.add_argument("--queries", type=int, default=1000)
    n.add_argument("--k", type=int, default=0)
    n.add_argument("--deadline-ms", type=float, default=2.0)
    common(n)
    n.set_defaults(fn=_cmd_bench)

    args = parser.parse_args(argv)
    try:
        return args.fn(args)
    except BrokenPipeError:  # piped into head etc.
        return 0


if __name__ == "__main__":
    sys.exit(main())
