"""Execution-environment fingerprints for the AOT library sidecar.

The port's counterpart of splink_tpu/utils/envfp.py. The reference binds
serialized XLA executables to jax/jaxlib, the backend and its target. The
port's only machine code built at run time is its libraries: the CUDA
string kernels (``ops.strings_cuda``, nvcc, ``sm_90a``) and the native host
library (``native``, g++). A library restored from the sidecar
(:mod:`..serve.aot`) is loaded with ``dlopen``, so it is bound to whatever
makes it unsafe to load somewhere else:

  * the host: the CPU's architecture and feature flags
    (:func:`cpu_target_fingerprint`, copied from the reference) and the
    native library's key (flags and source hash, its file name);
  * torch: ``torch.__version__`` and ``torch.version.cuda``;
  * on a CUDA device only: the device's name, its compute capability
    (``sm_90``), the CUDA version libcuda supports (``cuDriverGetVersion``) and the
    kernels' key (``strings_cuda.sources_digest()``, which hashes every
    file under csrc/ and ``NVCC_FLAGS``, with the flags themselves). On the
    CPU this half is absent, not a guess.

:func:`toolchain_fingerprint` records the compilers that built the
libraries (the release line of ``nvcc --version``, the first line of
``g++ --version``).
The sidecar stores it as provenance beside the environment and does not
compare it: a replica restoring from the sidecar has no compiler by
design, and a library that another compiler built from the same sources
loads just as safely where the keys above match.
"""

from __future__ import annotations

import hashlib
import platform
import shutil
import subprocess


def cpu_target_fingerprint() -> str:
    """Stable hex fingerprint of the host CPU's instruction-set surface:
    the architecture plus the feature flags the kernel reports (``flags``
    on x86, ``Features`` on ARM), order-normalised."""
    parts = [platform.machine() or "unknown"]
    flags = ""
    try:
        with open("/proc/cpuinfo", encoding="utf-8") as fh:
            for line in fh:
                key, _, val = line.partition(":")
                if key.strip().lower() in ("flags", "features"):
                    flags = " ".join(sorted(val.split()))
                    break
    except OSError:  # non-Linux: coarser, but still arch-bound
        flags = platform.processor() or ""
    parts.append(flags)
    return hashlib.sha256("|".join(parts).encode()).hexdigest()


def _libcuda_version() -> int | None:
    """The CUDA version that libcuda supports (e.g. 12080), from
    ``cuDriverGetVersion``; None when libcuda cannot be loaded."""
    import ctypes

    try:
        lib = ctypes.CDLL("libcuda.so.1")
    except OSError:
        return None
    out = ctypes.c_int(0)
    if lib.cuDriverGetVersion(ctypes.byref(out)) != 0:
        return None
    return int(out.value)


def environment_fingerprint(device=None) -> dict:
    """The load-binding identity of this process's libraries for an engine
    on ``device`` (a torch device or name; None = cpu): every key must
    match for a sidecar's libraries to be restored (module docstring)."""
    import os

    import torch

    from .. import native

    env = {
        "torch": torch.__version__,
        "torch_cuda": torch.version.cuda,
        "cpu_target": cpu_target_fingerprint(),
        "host_library": os.path.basename(native.library_path()),
        "host_flags": " ".join(native.CXX_FLAGS),
    }
    device = torch.device(device or "cpu")
    if device.type == "cuda":
        from ..ops import strings_cuda

        major, minor = torch.cuda.get_device_capability(device)
        env.update(
            device_name=torch.cuda.get_device_name(device),
            capability=f"sm_{major}{minor}",
            libcuda=_libcuda_version(),
            cuda_sources=strings_cuda.sources_digest(),
            nvcc_flags=" ".join(strings_cuda.NVCC_FLAGS),
        )
    return env


def _version_line(tool: str | None, marker: str) -> str | None:
    """The first line of ``tool --version`` that contains ``marker``; None
    when there is no such tool or line."""
    if tool is None:
        return None
    try:
        text = subprocess.run([tool, "--version"], capture_output=True, text=True,
                              timeout=30).stdout or ""
    except (OSError, subprocess.TimeoutExpired):
        return None
    return next((ln.strip() for ln in text.splitlines() if marker in ln), None)


def toolchain_fingerprint(device=None) -> dict:
    """The compilers this process would build with: ``gxx`` (the first line
    of ``g++ --version``) and, for a CUDA device, ``nvcc`` (the line of
    ``nvcc --version`` that names the release; its first line names no
    version). A compiler that cannot be found is None."""
    import torch

    out = {"gxx": _version_line(shutil.which("g++"), "g++")}
    if torch.device(device or "cpu").type == "cuda":
        from ..ops import strings_cuda

        try:
            nvcc = strings_cuda.cuda_tool("nvcc")
        except RuntimeError:
            nvcc = None
        out["nvcc"] = _version_line(nvcc, "release")
    return out
