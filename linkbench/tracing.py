"""The benchmark's own tracing: a ``torch.profiler`` window over the timed
jobs that records the card's activity only (kernels, copies, sets), and
the linker's stages taken from its ``_timed`` spans on the host's clock.
Reduced to the device's busy time (the union of its activity intervals),
the device time of each kernel name, and the device's idle time split by
the stage the host was in."""

from __future__ import annotations

import contextlib
import time
from dataclasses import dataclass, field

OUTSIDE = "between stages"


@dataclass
class Trace:
    window_s: float
    busy_s: float
    device_seconds: dict = field(default_factory=dict)  # name -> seconds on the device
    idle_by_stage: dict = field(default_factory=dict)  # host stage -> idle device seconds


@contextlib.contextmanager
def stage_spans(spans: list):
    """Append (start_ns, end_ns, stage) to ``spans`` for every stage of
    ``splink_tpu_torch.linker.Splink`` (its ``_timed`` spans, which end
    after a device synchronise), on the clock of ``time.time_ns``."""
    from splink_tpu_torch.linker import Splink

    original = Splink._timed

    @contextlib.contextmanager
    def timed(self, stage):
        t0 = time.time_ns()
        try:
            with original(self, stage):
                yield
        finally:
            spans.append((t0, time.time_ns(), stage))

    Splink._timed = timed
    try:
        yield
    finally:
        Splink._timed = original


def _is_device_activity(ev) -> bool:
    if not str(ev.device_type()).endswith("CUDA"):
        return False
    kind = getattr(ev, "activity_type", None)
    kind = kind() if callable(kind) else kind
    if kind is not None:
        return str(kind) in ("kernel", "gpu_memcpy", "gpu_memset")
    marker = getattr(ev, "is_user_annotation", None)
    return not (marker() if callable(marker) else bool(marker))


def summarize(prof, stages: list, start_ns: int, end_ns: int) -> Trace:
    """The card's activity between ``start_ns`` and ``end_ns`` (epoch ns,
    the profiler's clock) in the profile ``prof``."""
    device = []
    for ev in prof.profiler.kineto_results.events():
        if _is_device_activity(ev):
            s = max(ev.start_ns(), start_ns)
            e = min(ev.start_ns() + ev.duration_ns(), end_ns)
            if e > s:
                device.append((s, e, ev.name()))
    seconds: dict[str, float] = {}
    for s, e, name in device:
        seconds[name] = seconds.get(name, 0.0) + (e - s) * 1e-9
    busy, gaps, cursor = 0, [], start_ns
    for s, e, _ in sorted(device):
        if s > cursor:
            gaps.append((cursor, s))
        if e > cursor:
            busy += e - max(s, cursor)
            cursor = e
    if end_ns > cursor:
        gaps.append((cursor, end_ns))
    return Trace(window_s=(end_ns - start_ns) * 1e-9, busy_s=busy * 1e-9,
                 device_seconds=seconds, idle_by_stage=idle_by_stage(gaps, stages))


def idle_by_stage(gaps, stages) -> dict:
    """Idle device seconds under each host stage (the linker's stages do
    not nest); what no stage covers is OUTSIDE."""
    import numpy as np

    g = np.array(gaps, np.int64).reshape(-1, 2)
    out: dict[str, float] = {}
    covered = 0
    for s, e, name in stages:
        part = np.clip(np.minimum(g[:, 1], e) - np.maximum(g[:, 0], s), 0, None).sum()
        out[name] = out.get(name, 0.0) + part * 1e-9
        covered += part
    rest = int((g[:, 1] - g[:, 0]).sum()) - covered
    if rest > 0:
        out[OUTSIDE] = rest * 1e-9
    return out


def top(items: dict, n: int = 10, width: int = 160):
    """The ``n`` largest entries as [name, seconds], names cut to ``width``
    characters (a kernel's template arguments can run to thousands)."""
    return [[k[:width], v] for k, v in sorted(items.items(), key=lambda kv: -kv[1])[:n]]
