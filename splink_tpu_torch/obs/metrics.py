"""The metrics registry, kernel-library build accounting and device memory
snapshots: the port of splink_tpu/obs/metrics.py.

:class:`MetricsRegistry` is the reference's (counters, gauges, histogram
summaries, structured records; plain host-side Python).

Build accounting is the port's counterpart of the reference's compile
monitor.

The reference counts XLA compiles through ``jax.monitoring`` events: one
per (query bucket, candidate bucket) shape, so a serve batch that meets an
unwarmed shape stalls on a compile. The port compiles nothing per shape.
Its only compiles are the builds of its two native libraries, once per
process and source hash: the CUDA string kernels (``ops.strings_cuda.build``,
nvcc) and the host library (``native.build``, g++). Each build that really
runs a compiler reports here; a library already on disk is no build. The
serving tier reads these totals where the reference reads its compile
counter: ``LinkageService``'s compile-stall health signal,
``PhaseProfile.compile_s`` and the zero-builds-after-warmup check. A
library written from the AOT sidecar (serve/aot.py) runs no compiler: it
counts apart, in ``aot_restores`` (:func:`note_aot_restore`), never as a
build.

:func:`device_memory_snapshot` reads the CUDA caching allocator's
statistics at stage boundaries; it reports nothing on the CPU.
"""

from __future__ import annotations

import logging
import math
import threading

logger = logging.getLogger("splink_tpu_torch")


class MetricsRegistry:
    """Counters, gauges, histogram summaries and structured records."""

    def __init__(self):
        self.counters: dict[str, float] = {}
        self.gauges: dict[str, float] = {}
        self.histograms: dict[str, dict] = {}
        self.records: dict[str, object] = {}

    def count(self, name: str, n: float = 1) -> None:
        self.counters[name] = self.counters.get(name, 0) + n

    def gauge(self, name: str, value: float) -> None:
        self.gauges[name] = value

    def observe(self, name: str, value: float) -> None:
        h = self.histograms.setdefault(
            name, {"count": 0, "sum": 0.0, "min": math.inf, "max": -math.inf}
        )
        h["count"] += 1
        h["sum"] += float(value)
        h["min"] = min(h["min"], float(value))
        h["max"] = max(h["max"], float(value))

    def record(self, name: str, payload) -> None:
        self.records[name] = payload

    def snapshot(self) -> dict:
        """One JSON-ready dict of everything recorded so far."""
        hists = {}
        for name, h in self.histograms.items():
            hists[name] = {
                "count": h["count"],
                "sum": h["sum"],
                "min": h["min"] if math.isfinite(h["min"]) else None,
                "max": h["max"] if math.isfinite(h["max"]) else None,
                "mean": (h["sum"] / h["count"]) if h["count"] else None,
            }
        return {
            "counters": dict(self.counters),
            "gauges": dict(self.gauges),
            "histograms": hists,
            "records": dict(self.records),
        }


_LOCK = threading.Lock()
_BUILDS = {"builds": 0, "seconds": 0.0, "aot_restores": 0}


def note_build(seconds: float) -> None:
    """Record one compiler run that built a library in ``seconds``."""
    with _LOCK:
        _BUILDS["builds"] += 1
        _BUILDS["seconds"] += float(seconds)


def compile_totals() -> tuple[int, float]:
    """(library builds, their total seconds) so far in this process."""
    with _LOCK:
        return _BUILDS["builds"], _BUILDS["seconds"]


def compile_requests() -> int:
    """Library builds so far in this process: the counter the
    zero-builds-after-warmup checks read."""
    with _LOCK:
        return _BUILDS["builds"]


def note_aot_restore(n: int = 1) -> None:
    """Record ``n`` libraries restored from an AOT sidecar (verified bytes
    written where the build looks for them; no compiler ran)."""
    with _LOCK:
        _BUILDS["aot_restores"] += int(n)


def compile_stats() -> dict:
    """The accounting split, under the reference's keys: ``requests`` and
    ``compiles`` (both the library builds: the port has no compile cache),
    ``aot_restores`` (libraries restored from a sidecar) and ``seconds``
    (the builds' total seconds)."""
    with _LOCK:
        return {
            "requests": _BUILDS["builds"],
            "compiles": _BUILDS["builds"],
            "aot_restores": _BUILDS["aot_restores"],
            "seconds": _BUILDS["seconds"],
        }


def device_memory_snapshot() -> list[dict]:
    """Per-card memory under the reference's keys: the caching
    allocator's current and peak allocated bytes (``bytes_in_use``,
    ``peak_bytes_in_use``) and the card's total memory (``bytes_limit``).
    Empty without a CUDA device; never raises (it runs at stage
    boundaries on the production path)."""
    try:
        import torch

        if not torch.cuda.is_available():
            return []
        out = []
        for d in range(torch.cuda.device_count()):
            stats = torch.cuda.memory_stats(d)
            out.append({
                "device": f"cuda:{d}",
                "bytes_in_use": stats.get("allocated_bytes.all.current"),
                "peak_bytes_in_use": stats.get("allocated_bytes.all.peak"),
                "bytes_limit": torch.cuda.mem_get_info(d)[1],
            })
        return out
    except Exception as e:  # noqa: BLE001 - telemetry must never kill a run
        logger.debug("device memory snapshot unavailable: %s", e)
        return []
