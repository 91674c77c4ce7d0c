"""Per-stage wall-clock timing and the optional profiler trace hook: the port
of splink_tpu/utils/profiling.py.

Timings and profiler-trace targets are keyed by RUN, not process: each
linker registers its own run scope at construction (:func:`begin_run`), so
two linkers in one process neither interleave their stage timings nor
clobber each other's ``profile_dir``. ``stage_timings()`` returns the
CURRENT run's timings; pass ``run=`` to read a given linker's
(``Splink.run_id``). StageTimers made outside any run scope (ad-hoc
profiling, tests) land in a default scope.

The trace hook is ``torch.profiler``: with ``profile_dir`` set, each
device-heavy stage writes one Chrome trace (``<profile_dir>/<stage>/
trace_<pid>_<n>.json``, open in ui.perfetto.dev or chrome://tracing) of its
host ops and, on a card, its CUDA kernels.
"""

from __future__ import annotations

import contextlib
import itertools
import os
import time

# run key -> stage -> [seconds]; "" is the default (no-linker) scope
_DEFAULT_RUN = ""
_TIMINGS: dict[str, dict[str, list[float]]] = {_DEFAULT_RUN: {}}

# Per-run profiler target (from settings["profile_dir"]): device-heavy
# stages then write a trace under <dir>/<stage>.
_TRACE_DIRS: dict[str, str | None] = {_DEFAULT_RUN: None}
_CURRENT_RUN = _DEFAULT_RUN
_TRACED_STAGES = {"gammas", "gammas_patterns", "em", "em_streamed"}
# a second torch.profiler cannot start inside a running one: ONE
# process-wide flag regardless of run
_TRACE_ACTIVE = False
_TRACE_SEQ = itertools.count()

# Retained run scopes are bounded: a long-lived process constructing one
# linker per request must not grow _TIMINGS forever. The oldest scopes are
# evicted first past this cap; the default scope and the current run never
# are.
_MAX_RETAINED_RUNS = 64


def begin_run(run_id: str, trace_dir: str | None = None) -> str:
    """Open (and make current) a run scope with fresh timings. Called by
    the linker at construction; a later linker beginning its own run leaves
    this one's timings and trace dir untouched (until it ages past the
    ``_MAX_RETAINED_RUNS`` eviction window)."""
    global _CURRENT_RUN
    _TIMINGS[run_id] = {}
    _TRACE_DIRS[run_id] = trace_dir or None
    _CURRENT_RUN = run_id
    while len(_TIMINGS) > _MAX_RETAINED_RUNS + 1:  # +1: the default scope
        oldest = next(
            (k for k in _TIMINGS if k not in (_DEFAULT_RUN, _CURRENT_RUN)), None
        )
        if oldest is None:  # pragma: no cover - cap >= 1 prevents this
            break
        _TIMINGS.pop(oldest, None)
        _TRACE_DIRS.pop(oldest, None)
    return run_id


def discard_run(run_id: str) -> None:
    """Drop a run scope's recorded state (tests / long-lived processes)."""
    global _CURRENT_RUN
    if run_id == _DEFAULT_RUN:
        _TIMINGS[_DEFAULT_RUN] = {}
        _TRACE_DIRS[_DEFAULT_RUN] = None
        return
    _TIMINGS.pop(run_id, None)
    _TRACE_DIRS.pop(run_id, None)
    if _CURRENT_RUN == run_id:
        _CURRENT_RUN = _DEFAULT_RUN


def set_trace_dir(path: str | None) -> None:
    """Enable (or disable with None) profiler traces for the device-heavy
    stages of the CURRENT run scope."""
    _TRACE_DIRS[_CURRENT_RUN] = path or None


def _start_profiler(trace_dir: str):
    """A started ``torch.profiler.profile`` recording host ops and, where
    a card exists, CUDA kernels; its trace is written to ``trace_dir`` when
    it stops."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    os.makedirs(trace_dir, exist_ok=True)
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    prof = profile(activities=activities)
    prof.__enter__()
    return prof


def _stop_profiler(prof, trace_dir: str, exc) -> None:
    """Stop ``prof`` and export its Chrome trace into ``trace_dir``."""
    prof.__exit__(*exc)
    name = f"trace_{os.getpid()}_{next(_TRACE_SEQ)}.json"
    prof.export_chrome_trace(os.path.join(trace_dir, name))


class StageTimer(contextlib.AbstractContextManager):
    """Context manager recording wall time for a named pipeline stage.

    Usage::

        with StageTimer("blocking"):
            ...

    Args:
        stage: stage name the elapsed time is recorded under.
        trace_dir: write a profiler trace of the stage here (overrides the
            run's profile_dir resolution).
        run: run scope to record into (default: the current scope).
        telemetry: optional ``obs.runtime.RunContext``: the stage is also
            emitted as a telemetry span with a device-memory snapshot at
            the boundary.
        sync: optional zero-argument callable run before the clock stops
            (the linker passes a device synchronise, so a stage's seconds
            include the device work it queued).
    """

    def __init__(
        self,
        stage: str,
        trace_dir: str | None = None,
        run: str | None = None,
        telemetry=None,
        sync=None,
    ):
        self.stage = stage
        self.run = _CURRENT_RUN if run is None else run
        self.telemetry = telemetry
        self.sync = sync
        if trace_dir is None:
            run_dir = _TRACE_DIRS.get(self.run)
            if run_dir and stage in _TRACED_STAGES:
                trace_dir = os.path.join(run_dir, stage)
        self.trace_dir = trace_dir
        self._trace = None
        self._token = None

    def __enter__(self):
        global _TRACE_ACTIVE
        if self.trace_dir and not _TRACE_ACTIVE:
            # only mark active once the profiler really started: a failed
            # start must not leave the flag stuck True
            self._trace = _start_profiler(self.trace_dir)
            _TRACE_ACTIVE = True
        if self.telemetry is not None:
            self._token = self.telemetry.stage_enter(self.stage)
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        global _TRACE_ACTIVE
        try:
            if self.sync is not None and exc[0] is None:
                self.sync()
        finally:
            self.elapsed = time.perf_counter() - self._t0
            _TIMINGS.setdefault(self.run, {}).setdefault(self.stage, []).append(
                self.elapsed
            )
            try:
                if self._trace is not None:
                    prof, self._trace = self._trace, None
                    try:
                        _stop_profiler(prof, self.trace_dir, exc)
                    finally:
                        # a raising stop must still release the
                        # process-wide flag, or no later stage could trace
                        _TRACE_ACTIVE = False
            finally:
                if self.telemetry is not None:
                    self.telemetry.stage_exit(
                        self._token, self.stage, self.elapsed,
                        failed=exc[0] is not None,
                    )
        return False


def stage_timings(run: str | None = None) -> dict[str, list[float]]:
    """Recorded stage timings (stage -> list of seconds) for the current
    run scope, or for ``run`` when given."""
    key = _CURRENT_RUN if run is None else run
    return {k: list(v) for k, v in _TIMINGS.get(key, {}).items()}


def reset_timings(run: str | None = None) -> None:
    key = _CURRENT_RUN if run is None else run
    _TIMINGS[key] = {}
