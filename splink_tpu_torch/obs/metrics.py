"""Kernel-library build accounting: the port's counterpart of the compile
monitor in splink_tpu/obs/metrics.py.

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

Plain host-side Python, stdlib only.
"""

from __future__ import annotations

import threading

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
