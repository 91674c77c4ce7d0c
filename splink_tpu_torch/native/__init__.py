"""The native host library: splink_tpu's g++ kernels for the host work of
encoding and blocking, bound with ctypes.

``src/host_kernels.cpp`` (a copy of splink_tpu/native/src/host_kernels.cpp)
is compiled by g++ at first use into ``build/splink_tpu_torch/`` beside the
package (``SPLINK_TPU_TORCH_BUILD_DIR`` overrides), as one library keyed by
a hash of the source and the flags. The build writes a temporary file and
renames it into place, so processes that build at the same moment each
finish with a whole library.

Every entry point runs the library. Unlike splink_tpu's loader there is no
fallback: a failed build raises with g++'s output, and a library file that
will not load (corrupt, or missing a symbol) is rebuilt once and then
raises. The numpy forms (``*_plain``) are the plain versions that the tests
and chip_smoke.py hold the library to, array for array, order and dtype
included.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time

import numpy as np

from ..obs.metrics import note_build
from ..ops.strings_cuda import build_dir

_SRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "src", "host_kernels.cpp")
# No -march=native: the library sits in a build directory that can be
# copied to another machine, and the key does not name the CPU.
CXX_FLAGS = ["-O3", "-fPIC", "-shared", "-std=c++17", "-Wall"]

# Calls of the library by entry point: each adds one where it calls into
# the library, and nowhere else. chip_smoke.py zeroes them around the main
# path.
calls = {"encode_fixed_width": 0, "self_join_pairs": 0, "cross_join_pairs": 0}

_lock = threading.Lock()
_lib: ctypes.CDLL | None = None

_i64p = ctypes.POINTER(ctypes.c_int64)
_u8p = ctypes.POINTER(ctypes.c_uint8)
_i32p = ctypes.POINTER(ctypes.c_int32)


def compiler() -> str:
    path = shutil.which("g++")
    if path is None:
        raise RuntimeError(
            "g++ not found on PATH: the native host library is built from "
            f"{_SRC} at first use"
        )
    return path


def library_path() -> str:
    h = hashlib.sha1(" ".join(CXX_FLAGS).encode())
    with open(_SRC, "rb") as fh:
        h.update(fh.read())
    return os.path.join(build_dir(), f"libsplink_host-{h.hexdigest()[:12]}.so")


def build_command(out: str) -> list[str]:
    return [compiler(), *CXX_FLAGS, "-o", out, _SRC]


def _compile(path: str) -> None:
    """Run g++ into ``path``; the build counts once in ``obs.metrics``."""
    os.makedirs(os.path.dirname(path), exist_ok=True)
    tmp = f"{path}.{os.getpid()}.{threading.get_ident()}.tmp"
    t0 = time.perf_counter()
    proc = subprocess.run(build_command(tmp), capture_output=True, text=True)
    if proc.returncode != 0:
        if os.path.exists(tmp):
            os.remove(tmp)
        raise RuntimeError(
            f"g++ failed to build {_SRC}:\n{proc.stdout}{proc.stderr}"
        )
    os.replace(tmp, path)
    note_build(time.perf_counter() - t0)


def build() -> str:
    """Compile the library unless it is built already; returns its path.
    Raises with g++'s output if the build fails."""
    path = library_path()
    if not os.path.exists(path):
        _compile(path)
    return path


def _bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Declare signatures; raises AttributeError if a symbol is missing."""
    lib.encode_fixed_width.restype = None
    lib.encode_fixed_width.argtypes = [
        _u8p, _i64p, ctypes.c_int64, ctypes.c_int64, _u8p, _i32p,
    ]
    lib.count_self_pairs.restype = ctypes.c_int64
    lib.count_self_pairs.argtypes = [_i64p, ctypes.c_int64]
    lib.emit_self_pairs.restype = None
    lib.emit_self_pairs.argtypes = [_i64p] * 3 + [ctypes.c_int64, _i64p, _i64p]
    lib.emit_self_pairs_i32.restype = None
    lib.emit_self_pairs_i32.argtypes = [
        _i32p, _i64p, _i64p, ctypes.c_int64, _i32p, _i32p,
    ]
    lib.count_cross_pairs.restype = ctypes.c_int64
    lib.count_cross_pairs.argtypes = [_i64p, _i64p, ctypes.c_int64]
    lib.emit_cross_pairs.restype = None
    lib.emit_cross_pairs.argtypes = [_i64p] * 6 + [ctypes.c_int64, _i64p, _i64p]
    lib.emit_cross_pairs_i32.restype = None
    lib.emit_cross_pairs_i32.argtypes = [
        _i32p, _i64p, _i64p, _i32p, _i64p, _i64p,
        ctypes.c_int64, _i32p, _i32p,
    ]
    return lib


def _load() -> ctypes.CDLL:
    global _lib
    with _lock:
        if _lib is None:
            path = build()
            try:
                _lib = _bind(ctypes.CDLL(path))
            except (OSError, AttributeError):
                # a corrupt or incomplete file under the source's key:
                # build it again once; a second failure raises
                _compile(path)
                try:
                    _lib = _bind(ctypes.CDLL(path))
                except (OSError, AttributeError) as e:
                    raise RuntimeError(
                        f"the native host library {path} does not load "
                        f"after a rebuild: {e}"
                    ) from e
        return _lib


def _ptr(a: np.ndarray, ctype):
    return a.ctypes.data_as(ctype)


def _ranges(counts: np.ndarray) -> np.ndarray:
    """Concatenated [0..c) ranges: _ranges([2,3]) -> [0,1,0,1,2]."""
    counts = counts.astype(np.int64)
    total = int(counts.sum())
    if total == 0:
        return np.zeros(0, np.int64)
    offsets = np.cumsum(counts) - counts  # output offset of each group
    return np.arange(total, dtype=np.int64) - np.repeat(offsets, counts)


def _check_groups(n_rows: int, starts: np.ndarray, sizes: np.ndarray) -> None:
    """The library reads rows[start, start + size) of every group: refuse
    groups that lie outside the rows."""
    if starts.shape != sizes.shape or starts.ndim != 1:
        raise ValueError("starts and sizes must be equal 1-D arrays")
    if len(sizes) and (
        sizes.min() < 0 or starts.min() < 0 or (starts + sizes).max() > n_rows
    ):
        raise ValueError(f"a group lies outside the {n_rows} rows")


def _pair_dtype(*rows: np.ndarray):
    """The library's index type: int32 when every row array is int32."""
    return np.int32 if all(r.dtype == np.int32 for r in rows) else np.int64


# ----------------------------------------------------------------------
# Fixed-width encoding
# ----------------------------------------------------------------------


def _check_encode(data: np.ndarray, offsets: np.ndarray, width: int):
    data = np.ascontiguousarray(data, np.uint8)
    offsets = np.ascontiguousarray(offsets, np.int64)
    if data.ndim != 1 or offsets.ndim != 1 or len(offsets) < 1:
        raise ValueError("data and offsets must be 1-D, offsets of length n + 1")
    if width < 0:
        raise ValueError(f"width must be >= 0, got {width}")
    if offsets[0] < 0 or offsets[-1] > len(data) or (np.diff(offsets) < 0).any():
        raise ValueError("offsets must rise from >= 0 to at most len(data)")
    return data, offsets


def encode_fixed_width(data: np.ndarray, offsets: np.ndarray, width: int):
    """(flat uint8 buffer, int64 offsets) -> ((n, width) uint8, (n,) int32):
    row i holds ``data[offsets[i]:offsets[i+1]]`` truncated to ``width`` and
    zero padded, in the library."""
    data, offsets = _check_encode(data, offsets, width)
    n = len(offsets) - 1
    out_bytes = np.empty((n, width), np.uint8)
    out_lens = np.empty(n, np.int32)
    lib = _load()
    lib.encode_fixed_width(
        _ptr(data, _u8p), _ptr(offsets, _i64p), n, width,
        _ptr(out_bytes, _u8p), _ptr(out_lens, _i32p),
    )
    calls["encode_fixed_width"] += 1
    return out_bytes, out_lens


def encode_fixed_width_plain(data: np.ndarray, offsets: np.ndarray, width: int):
    """The plain version of :func:`encode_fixed_width`, in numpy."""
    data, offsets = _check_encode(data, offsets, width)
    n = len(offsets) - 1
    lens = np.minimum(np.diff(offsets), width).astype(np.int64)
    out_bytes = np.zeros((n, width), np.uint8)
    rows = np.repeat(np.arange(n, dtype=np.int64), lens)
    cols = np.arange(len(rows), dtype=np.int64) - np.repeat(
        np.cumsum(lens) - lens, lens
    )
    out_bytes[rows, cols] = data[np.repeat(offsets[:-1], lens) + cols]
    return out_bytes, lens.astype(np.int32)


# ----------------------------------------------------------------------
# Pair emission
# ----------------------------------------------------------------------


def self_join_pairs(rows_sorted: np.ndarray, starts: np.ndarray, sizes: np.ndarray):
    """Every unordered within-group pair (rows[start + p], rows[start + q]),
    p < q, group by group with p major, in the library. int32 rows give
    int32 pairs (at billions of pairs the index buffers dominate host
    memory); any other row type gives int64 pairs."""
    starts = np.ascontiguousarray(starts, np.int64)
    sizes = np.ascontiguousarray(sizes, np.int64)
    _check_groups(len(rows_sorted), starts, sizes)
    lib = _load()
    total = lib.count_self_pairs(_ptr(sizes, _i64p), len(sizes))
    if _pair_dtype(rows_sorted) == np.int32:
        rows = np.ascontiguousarray(rows_sorted, np.int32)
        out_i = np.empty(total, np.int32)
        out_j = np.empty(total, np.int32)
        emit, p = lib.emit_self_pairs_i32, _i32p
    else:
        rows = np.ascontiguousarray(rows_sorted, np.int64)
        out_i = np.empty(total, np.int64)
        out_j = np.empty(total, np.int64)
        emit, p = lib.emit_self_pairs, _i64p
    emit(
        _ptr(rows, p), _ptr(starts, _i64p), _ptr(sizes, _i64p),
        len(sizes), _ptr(out_i, p), _ptr(out_j, p),
    )
    calls["self_join_pairs"] += 1
    return out_i, out_j


def self_join_pairs_plain(rows_sorted: np.ndarray, starts: np.ndarray, sizes: np.ndarray):
    """The plain version of :func:`self_join_pairs`, in numpy: position k
    of a group pairs with the (size - 1 - k) positions after it."""
    starts = np.asarray(starts, np.int64)
    sizes = np.asarray(sizes, np.int64)
    _check_groups(len(rows_sorted), starts, sizes)
    rows = rows_sorted.astype(_pair_dtype(rows_sorted), copy=False)
    pos_in_group = _ranges(sizes)
    members = np.repeat(starts, sizes) + pos_in_group
    rep = np.repeat(sizes, sizes) - pos_in_group - 1
    p = np.repeat(members, rep)
    q = p + 1 + _ranges(rep)
    return rows[p], rows[q]


def cross_join_pairs(l_rows, l_starts, l_sizes, r_rows, r_starts, r_sizes):
    """Every (left member, right member) pair of each matched key group,
    group by group with the left member major, in the library. int32 on
    both sides gives int32 pairs, anything else int64."""
    l_starts = np.ascontiguousarray(l_starts, np.int64)
    l_sizes = np.ascontiguousarray(l_sizes, np.int64)
    r_starts = np.ascontiguousarray(r_starts, np.int64)
    r_sizes = np.ascontiguousarray(r_sizes, np.int64)
    _check_groups(len(l_rows), l_starts, l_sizes)
    _check_groups(len(r_rows), r_starts, r_sizes)
    if len(l_sizes) != len(r_sizes):
        raise ValueError("left and right must describe the same groups")
    lib = _load()
    total = lib.count_cross_pairs(
        _ptr(l_sizes, _i64p), _ptr(r_sizes, _i64p), len(l_sizes)
    )
    dt = _pair_dtype(l_rows, r_rows)
    lr = np.ascontiguousarray(l_rows, dt)
    rr = np.ascontiguousarray(r_rows, dt)
    out_i = np.empty(total, dt)
    out_j = np.empty(total, dt)
    emit, p = (
        (lib.emit_cross_pairs_i32, _i32p) if dt == np.int32 else (lib.emit_cross_pairs, _i64p)
    )
    emit(
        _ptr(lr, p), _ptr(l_starts, _i64p), _ptr(l_sizes, _i64p),
        _ptr(rr, p), _ptr(r_starts, _i64p), _ptr(r_sizes, _i64p),
        len(l_sizes), _ptr(out_i, p), _ptr(out_j, p),
    )
    calls["cross_join_pairs"] += 1
    return out_i, out_j


def cross_join_pairs_plain(l_rows, l_starts, l_sizes, r_rows, r_starts, r_sizes):
    """The plain version of :func:`cross_join_pairs`, in numpy: pair t of
    a group is (left t // right size, right t % right size)."""
    ls, lz = np.asarray(l_starts, np.int64), np.asarray(l_sizes, np.int64)
    rs, rz = np.asarray(r_starts, np.int64), np.asarray(r_sizes, np.int64)
    _check_groups(len(l_rows), ls, lz)
    _check_groups(len(r_rows), rs, rz)
    if len(lz) != len(rz):
        raise ValueError("left and right must describe the same groups")
    dt = _pair_dtype(l_rows, r_rows)
    cnt = lz * rz
    gi = np.repeat(np.arange(len(cnt), dtype=np.int64), cnt)
    t = _ranges(cnt)
    a = t // rz[gi] + ls[gi]
    b = t % rz[gi] + rs[gi]
    return l_rows.astype(dt, copy=False)[a], r_rows.astype(dt, copy=False)[b]
