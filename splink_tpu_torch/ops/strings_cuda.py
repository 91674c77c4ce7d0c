"""Wrappers for the hand-written CUDA string kernels (csrc/strings.cu).

The counterpart of splink_tpu/ops/strings_pallas.py:

  * ``jaro_winkler_cuda`` replaces ``jaro_winkler_pallas``
    (strings_pallas.py:123) and must equal the plain version bit for bit;
  * ``levenshtein_cuda`` replaces ``levenshtein_pallas``
    (strings_pallas.py:225) and must equal it exactly.

Both kernels take one pair per thread. Per pair they read about 2L + 8
bytes and write 4, against O(L^2) integer work, so on an H100 they are
bound by the integer ALUs, not by HBM (the bound that chip_smoke.py
reports is the larger of the bytes over 3.35 TB/s and the integer
operations over the card's INT32 rate).

The library is compiled from the sources in this package by ``nvcc`` at
first use, into ``build/splink_tpu_torch/`` beside the package (override
with ``SPLINK_TPU_TORCH_BUILD_DIR``), keyed by a hash of the source. A
failed build raises; nothing falls back to the plain versions. The gate
mirrors ``pallas_supported``: a CUDA tensor, 2-D, width <= 32, uint8 or the
uint32 wide-unicode encoding (carried as uint32 or int32); a wider CUDA
column raises NotImplementedError.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading

import torch

MAX_CUDA_WIDTH = 32

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_SOURCE = os.path.join(_PKG_DIR, "csrc", "strings.cu")
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-O3", "-fmad=false", "-std=c++17",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
]

# Launch counts: each wrapper adds one where it launches its kernel, and
# nowhere else. chip_smoke.py zeroes them around the main path.
launches = {"jaro_winkler": 0, "levenshtein": 0}

# When set to a dict, each wrapper records clones of the arguments of its
# FIRST launch under its name (chip_smoke.py holds the kernels against the
# plain versions at exactly the shapes the main path gave them).
capture: dict | None = None

_lock = threading.Lock()
_lib = None
build_log = ""  # nvcc's output of the last build (ptxas register report)


def build_dir() -> str:
    return os.environ.get("SPLINK_TPU_TORCH_BUILD_DIR") or os.path.join(
        os.path.dirname(_PKG_DIR), "build", "splink_tpu_torch"
    )


def _nvcc() -> str:
    for cand in (
        shutil.which("nvcc"),
        os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc"),
    ):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError(
        "nvcc not found (PATH or $CUDA_HOME/bin): the CUDA string kernels "
        "are built from splink_tpu_torch/csrc at first use"
    )


def library_path() -> str:
    with open(_SOURCE, "rb") as fh:
        digest = hashlib.sha1(fh.read() + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return os.path.join(build_dir(), f"libsplink_strings-{digest[:12]}.so")


def build() -> str:
    """Compile csrc/strings.cu (if this source's library is not built yet)
    and return the library path. Raises with nvcc's output on failure."""
    global build_log
    path = library_path()
    if os.path.exists(path):
        return path
    os.makedirs(build_dir(), exist_ok=True)
    tmp = f"{path}.{os.getpid()}.tmp"
    proc = subprocess.run(
        [_nvcc(), *NVCC_FLAGS, "-o", tmp, _SOURCE],
        capture_output=True, text=True,
    )
    build_log = proc.stdout + proc.stderr
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed to build {_SOURCE}:\n{build_log}")
    os.replace(tmp, path)
    return path


def _load():
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(build())
            ptr = ctypes.c_void_p
            for name in ("splink_jaro_winkler_u8", "splink_jaro_winkler_u32"):
                fn = getattr(lib, name)
                fn.restype = ctypes.c_int
                fn.argtypes = [ptr, ptr, ptr, ptr, ctypes.c_int64, ctypes.c_int,
                               ctypes.c_float, ctypes.c_float, ptr, ptr]
            for name in ("splink_levenshtein_u8", "splink_levenshtein_u32"):
                fn = getattr(lib, name)
                fn.restype = ctypes.c_int
                fn.argtypes = [ptr, ptr, ptr, ptr, ctypes.c_int64, ctypes.c_int,
                               ptr, ptr]
            _lib = lib
        return _lib


def _check(s1, s2, l1, l2) -> str:
    """Validate a kernel call; returns the entry-point suffix (u8 | u32)."""
    for name, t in (("s1", s1), ("s2", s2), ("l1", l1), ("l2", l2)):
        if not t.is_cuda:
            raise ValueError(f"{name} must be a CUDA tensor, got {t.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if t.device != s1.device:
            raise ValueError("all inputs must be on one device")
    if s1.dim() != 2 or s2.shape != s1.shape:
        raise ValueError(f"s1, s2 must be equal (B, L) tensors, got "
                         f"{tuple(s1.shape)} and {tuple(s2.shape)}")
    if s1.dtype != s2.dtype:
        raise ValueError(f"s1, s2 dtypes differ: {s1.dtype} vs {s2.dtype}")
    if s1.shape[1] > MAX_CUDA_WIDTH:
        raise NotImplementedError(
            f"the CUDA string kernels take widths <= {MAX_CUDA_WIDTH}, got "
            f"{s1.shape[1]} (ROADMAP.md, 'kernel widths > 32 on CUDA')"
        )
    B = s1.shape[0]
    for name, t in (("l1", l1), ("l2", l2)):
        if t.dtype != torch.int32 or t.shape != (B,):
            raise ValueError(f"{name} must be ({B},) int32, got "
                             f"{tuple(t.shape)} {t.dtype}")
    if s1.dtype == torch.uint8:
        return "u8"
    if s1.dtype in (torch.int32, torch.uint32):
        return "u32"
    raise ValueError(f"unsupported character dtype {s1.dtype}")


def _launch(name, fn_name, out, s1, s2, l1, l2, *scalars):
    """Launch one kernel on the current stream into ``out``; counts it and
    raises if CUDA refused the launch."""
    kind = _check(s1, s2, l1, l2)
    fn = getattr(_load(), f"{fn_name}_{kind}")
    if not s1.shape[0]:
        return out
    if capture is not None and name not in capture:
        capture[name] = tuple(a.clone() for a in (s1, s2, l1, l2))
    err = fn(
        s1.data_ptr(), s2.data_ptr(), l1.data_ptr(), l2.data_ptr(),
        s1.shape[0], s1.shape[1], *scalars, out.data_ptr(),
        torch.cuda.current_stream(s1.device).cuda_stream,
    )
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {err}")
    launches[name] += 1
    return out


def jaro_winkler_cuda(s1, s2, l1, l2, prefix_scale=0.1, boost_threshold=0.7):
    """Batched Jaro-Winkler on the card: s1, s2 (B, L <= 32) uint8 or
    uint32/int32 codepoints, l1, l2 (B,) int32 -> (B,) float32. Replaces
    splink_tpu/ops/strings_pallas.py:jaro_winkler_pallas."""
    out = torch.empty(s1.shape[0], dtype=torch.float32, device=s1.device)
    return _launch("jaro_winkler", "splink_jaro_winkler", out, s1, s2, l1, l2,
                   prefix_scale, boost_threshold)


def levenshtein_cuda(s1, s2, l1, l2):
    """Batched Levenshtein distance on the card: (B,) int32. Replaces
    splink_tpu/ops/strings_pallas.py:levenshtein_pallas."""
    out = torch.empty(s1.shape[0], dtype=torch.int32, device=s1.device)
    return _launch("levenshtein", "splink_levenshtein", out, s1, s2, l1, l2)
