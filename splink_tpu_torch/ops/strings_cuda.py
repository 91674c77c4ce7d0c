"""Wrappers for the hand-written CUDA string kernels (csrc/*.cu).

The counterpart of splink_tpu/ops/strings_pallas.py:

  * ``jaro_winkler_cuda`` (csrc/jaro_winkler.cu) replaces
    ``jaro_winkler_pallas`` (strings_pallas.py:123) and must equal the plain
    version bit for bit; with ``mask`` it computes only the pairs where the
    mask is true and writes 0 elsewhere, in one launch over the batch;
  * ``levenshtein_cuda`` (csrc/levenshtein.cu) replaces
    ``levenshtein_pallas`` (strings_pallas.py:225) and must equal it
    exactly.

Every column width goes to a kernel: the kernel variant is the number of
32-bit words W that a pair's per-position sets need (``kernel_variant``).
Both kernels run a form with W fixed at compile time, one pair per thread,
on narrow columns (Levenshtein W = 1, 2, 4, 8 up to width 256,
Jaro-Winkler W = 1, 2 up to 64), then the lane-group form (variant -G: G =
ceil(width / 32) lanes of a warp share a pair, no scratch) up to width
1024, and the generic form (variant 0) past it: Jaro-Winkler's keeps its
sets in shared memory, Levenshtein's its deltas in per-pair scratch that
the wrapper allocates.
Per pair the kernels read about 2L + 8 bytes and write 4; chip_smoke.py
reports each one's time beside the larger of the bytes over 3.35 TB/s and
its integer operations over the card's INT32 rate.

Each source is compiled by ``nvcc`` at first use into its own library in
``build/splink_tpu_torch/`` beside the package (override with
``SPLINK_TPU_TORCH_BUILD_DIR``), all sources at once, keyed by a hash of
every file under csrc/ and the flags. A failed build raises; nothing falls
back to the plain versions. A wrapper takes CUDA tensors only: 2-D
characters, uint8 or 32-bit codepoints (uint32, or int32 as the encoder
carries them), (B,) int32 lengths and, for Jaro-Winkler, an optional (B,)
bool mask; anything else raises.
"""

from __future__ import annotations

import ctypes
import glob
import hashlib
import os
import shutil
import subprocess
import threading
import time

import torch

from ..obs.metrics import note_build

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_CSRC = os.path.join(_PKG_DIR, "csrc")
KERNELS = ("jaro_winkler", "levenshtein")  # one csrc/<name>.cu each
# Per kernel, the word counts compiled with W fixed; 0 names the generic form
VARIANT_WORDS = {"jaro_winkler": (1, 2), "levenshtein": (1, 2, 4, 8)}
# Per kernel, the most lanes of the lane-group form (variant -G, G lanes a
# pair) for columns past its fixed forms: 32, so up to width 1024; wider
# columns take the generic form
GROUP_LANES = {"jaro_winkler": 32, "levenshtein": 32}
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-O3", "-fmad=false", "-std=c++17",
    "-shared", "-Xcompiler", "-fPIC",
]

# Launch counts: each wrapper adds one where it launches its kernel, and
# nowhere else. chip_smoke.py zeroes them around the main path.
launches = {name: 0 for name in KERNELS}
# The same launches by variant, keyed "<kernel>/<u8|u32>/w<W>" (w0: generic)
# or "<kernel>/<u8|u32>/g<G>" (the lane-group form with G lanes a pair),
# with "/masked" appended for a masked Jaro-Winkler launch.
variant_launches: dict[str, int] = {}

# When set to a dict, each wrapper records clones of the tensor arguments
# of its FIRST launch under its name, and of each variant's first launch
# under the variant's key in ``variant_launches``, the mask last where there
# is one (chip_smoke.py holds the kernels against the plain versions at
# exactly the shapes the main path gave them).
capture: dict | None = None

_lock = threading.Lock()
_libs: dict[str, ctypes.CDLL] = {}


_KINDS = {torch.uint8: "u8", torch.int32: "u32", torch.uint32: "u32"}


def kernel_variant(kernel: str, width: int, dtype: torch.dtype) -> tuple[str, int]:
    """The character type and variant of ``kernel`` for a (B, width)
    column: ("u8" | "u32", W) with W the least of VARIANT_WORDS[kernel]
    such that 32 * W >= width (Levenshtein up to 256, Jaro-Winkler up to
    64); past the widest, -G for the lane-group form with G = ceil(width /
    32) lanes where the kernel has one with that many (GROUP_LANES: both
    up to width 1024), else 0 (generic). Raises on another dtype."""
    kind = _KINDS.get(dtype)
    if kind is None:
        raise ValueError(f"unsupported character dtype {dtype}")
    if width < 1:
        raise ValueError(f"width must be >= 1, got {width}")
    words = (width + 31) // 32
    for w in VARIANT_WORDS[kernel]:
        if w >= words:
            return kind, w
    if words <= GROUP_LANES.get(kernel, 0):
        return kind, -words
    return kind, 0


def variant_name(kernel: str, kind: str, words: int) -> str:
    """The key of a variant in ``variant_launches`` (without "/masked"):
    "<kernel>/<kind>/w<W>", or "<kernel>/<kind>/g<G>" for variant -G."""
    return f"{kernel}/{kind}/" + (f"g{-words}" if words < 0 else f"w{words}")


def build_dir() -> str:
    return os.environ.get("SPLINK_TPU_TORCH_BUILD_DIR") or os.path.join(
        os.path.dirname(_PKG_DIR), "build", "splink_tpu_torch"
    )


def cuda_tool(name: str) -> str:
    """Path of a CUDA toolkit program (nvcc, cuobjdump): PATH, then
    $CUDA_HOME/bin (default /usr/local/cuda)."""
    for cand in (
        shutil.which(name),
        os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", name),
    ):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError(
        f"{name} not found (PATH or $CUDA_HOME/bin): the CUDA string kernels "
        "are built from splink_tpu_torch/csrc at first use"
    )


def sources_digest() -> str:
    """Hash of every file under csrc/ (sources and headers) and the flags."""
    h = hashlib.sha1(" ".join(NVCC_FLAGS).encode())
    for path in sorted(glob.glob(os.path.join(_CSRC, "*"))):
        h.update(os.path.basename(path).encode())
        with open(path, "rb") as fh:
            h.update(fh.read())
    return h.hexdigest()[:12]


def library_path(name: str) -> str:
    return os.path.join(build_dir(), f"libsplink_{name}-{sources_digest()}.so")


def build() -> dict[str, str]:
    """Compile every csrc/<kernel>.cu whose library is not built yet, one
    nvcc per source, all started together; returns {kernel: library path}.
    A build that ran counts once in ``obs.metrics``. Raises with nvcc's
    output if any build fails."""
    paths = {name: library_path(name) for name in KERNELS}
    todo = {name: p for name, p in paths.items() if not os.path.exists(p)}
    if todo:
        t0 = time.perf_counter()
        os.makedirs(build_dir(), exist_ok=True)
        procs = {}
        for name, path in todo.items():
            src = os.path.join(_CSRC, f"{name}.cu")
            tmp = f"{path}.{os.getpid()}.tmp"
            procs[name] = (tmp, src, subprocess.Popen(
                [cuda_tool("nvcc"), *NVCC_FLAGS, "-o", tmp, src],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
            ))
        failed = []
        for name, (tmp, src, proc) in procs.items():
            log = proc.communicate()[0]
            if proc.returncode != 0:
                failed.append(f"nvcc failed to build {src}:\n{log}")
            else:
                os.replace(tmp, todo[name])
        if failed:
            raise RuntimeError("\n".join(failed))
        note_build(time.perf_counter() - t0)
    return paths


def _load(name: str):
    with _lock:
        if not _libs:
            ptr, i32, i64, f32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64, ctypes.c_float
            head = [ptr, ptr, ptr, ptr, i64, i32, i32, i32]
            for kernel, path in build().items():
                lib = ctypes.CDLL(path)
                fn = getattr(lib, f"splink_{kernel}")
                fn.restype = i32
                # jaro_winkler: prefix_scale, boost_threshold, mask, survivors;
                # levenshtein: scratch; then out, stream
                tail = [f32, f32, ptr, ptr] if kernel == "jaro_winkler" else [ptr]
                fn.argtypes = head + tail + [ptr, ptr]
                _libs[kernel] = fn
        return _libs[name]


def _check(kernel, s1, s2, l1, l2) -> tuple[str, int]:
    """Validate a call of ``kernel``; returns its ``kernel_variant``."""
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
    B = s1.shape[0]
    for name, t in (("l1", l1), ("l2", l2)):
        if t.dtype != torch.int32 or t.shape != (B,):
            raise ValueError(f"{name} must be ({B},) int32, got "
                             f"{tuple(t.shape)} {t.dtype}")
    return kernel_variant(kernel, s1.shape[1], s1.dtype)


def _launch(name, out, s1, s2, l1, l2, *scalars, mask=None, words=None, survivors=None):
    """Launch one kernel on the current stream into ``out``; counts it and
    raises if CUDA refused the launch. ``words`` overrides the variant
    (chip_smoke.py times other forms at a width that one covers: 0 the
    generic form, -G the lane-group form with G lanes a pair). A masked
    Jaro-Winkler launch adds its survivors to ``survivors``, an int64
    element on the inputs' device, when given."""
    kind, chosen = _check(name, s1, s2, l1, l2)
    words = chosen if words is None else words
    B, width = s1.shape
    if mask is not None and (mask.device != s1.device or mask.dtype != torch.bool
                             or mask.shape != (B,) or not mask.is_contiguous()):
        raise ValueError(f"mask must be a contiguous ({B},) bool tensor on {s1.device}, "
                         f"got {tuple(mask.shape)} {mask.dtype} on {mask.device}")
    if survivors is not None and (mask is None or survivors.device != s1.device
                                  or survivors.dtype != torch.int64 or survivors.numel() != 1):
        raise ValueError("survivors must be one int64 element on the inputs' device, "
                         "with a mask")
    fn = _load(name)
    if not B:
        return out
    key = variant_name(name, kind, words) + ("" if mask is None else "/masked")
    if capture is not None and (name not in capture or key not in capture):
        tensors = (s1, s2, l1, l2) if mask is None else (s1, s2, l1, l2, mask)
        tensors = tuple(a.clone() for a in tensors)
        capture.setdefault(name, tensors)
        capture.setdefault(key, tensors)
    if name == "jaro_winkler":
        extra = (*scalars, None if mask is None else mask.data_ptr(),
                 None if survivors is None else survivors.data_ptr())
    else:  # Levenshtein's generic form takes 2 * ceil(width / 32) words a pair
        scratch = None
        if words == 0:
            scratch = torch.empty(2 * -(-width // 32) * B, dtype=torch.int32, device=s1.device)
        extra = (None if scratch is None else scratch.data_ptr(),)
    # the launcher runs on the CUDA runtime's current device: make it the
    # inputs' (a mesh shard on cuda:1 while cuda:0 is current would launch
    # on the wrong device with a foreign stream)
    with torch.cuda.device(s1.device):
        err = fn(
            s1.data_ptr(), s2.data_ptr(), l1.data_ptr(), l2.data_ptr(), B, width,
            s1.element_size(), words, *extra, out.data_ptr(),
            torch.cuda.current_stream(s1.device).cuda_stream,
        )
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {err}")
    launches[name] += 1
    variant_launches[key] = variant_launches.get(key, 0) + 1
    return out


def jaro_winkler_cuda(s1, s2, l1, l2, prefix_scale=0.1, boost_threshold=0.7, mask=None,
                      survivors=None):
    """Batched Jaro-Winkler on the card: s1, s2 (B, L) uint8 or uint32/int32
    codepoints, any L, l1, l2 (B,) int32 -> (B,) float32; with a (B,) bool
    ``mask``, where(mask, jw, 0) from one launch that computes only the
    pairs the mask keeps, adding their count to ``survivors`` (an int64
    element on the card) when given. Replaces
    splink_tpu/ops/strings_pallas.py:jaro_winkler_pallas."""
    out = torch.empty(s1.shape[0], dtype=torch.float32, device=s1.device)
    return _launch("jaro_winkler", out, s1, s2, l1, l2, prefix_scale, boost_threshold,
                   mask=mask, survivors=survivors)


def levenshtein_cuda(s1, s2, l1, l2):
    """Batched Levenshtein distance on the card, any L: (B,) int32.
    Replaces splink_tpu/ops/strings_pallas.py:levenshtein_pallas."""
    out = torch.empty(s1.shape[0], dtype=torch.int32, device=s1.device)
    return _launch("levenshtein", out, s1, s2, l1, l2)
