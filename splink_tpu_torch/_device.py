"""The device rule of the entry points, and the 0-d constants shared on
each device."""

from __future__ import annotations

import torch

from .utils.profiling import note_h2d

# (device, dtype, value) -> the 0-d tensor of device_constant
_CONSTANTS: dict[tuple, torch.Tensor] = {}


def resolve_device(device) -> torch.device:
    """The device an entry point runs on: ``cuda`` unless the caller names
    another; raises when it is CUDA and no CUDA device exists."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "splink_tpu_torch runs on a CUDA device by default and none is "
            "available; pass device='cpu' to run on the CPU"
        )
    return dev


def device_constant(value, dtype: torch.dtype, device) -> torch.Tensor:
    """``value`` as a 0-d ``dtype`` tensor on ``device``, made once per
    device, dtype and value and shared by every later call: on a card each
    such tensor is an upload that makes the host wait for the stream, and a
    CUDA graph can capture no upload. Callers only read it."""
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        # the key of the card the tensor lands on: "cuda" is "cuda:<current>"
        dev = torch.device("cuda", torch.cuda.current_device())
    key = (dev, dtype, value)
    out = _CONSTANTS.get(key)
    if out is None:
        out = torch.tensor(value, dtype=dtype, device=dev)
        note_h2d(out)
        # two threads may both make it: every caller gets the one kept
        out = _CONSTANTS.setdefault(key, out)
    return out
