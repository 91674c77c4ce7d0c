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
host ops and, on a card, its CUDA kernels, with the stage's program spans
beside them.

Every run scope also records, always and in memory, an
``obs.tracer.Tracer`` of program spans and a dict of counters. A span
holds its name, ``t0`` and ``t1`` as ``time.time_ns()`` integers (the
clock of ``torch.profiler``'s events), its parent, its run id and its
attributes; the stage spans are the StageTimers' own, their ``dur_s`` the
timer's ``elapsed``. :func:`span` opens one beneath the innermost open
span, in the run of the innermost open StageTimer (else the current run);
:func:`count` adds to that run's counters and to the innermost open span's
``counts``. The ``note_*`` helpers count the copies and host waits of a
CUDA tensor (and nothing on the CPU): ``host_syncs``, ``h2d_copies``,
``h2d_bytes``, ``h2d_pageable_bytes``, ``d2h_copies`` and ``d2h_bytes``.
Read them with :func:`run_ids`, :func:`run_spans` and :func:`run_counters`.
Inside :func:`held_counts` (a CUDA graph's capture, which runs nothing) a
thread's counts are gathered aside, and :func:`count_each` adds them at each
replay.
"""

from __future__ import annotations

import contextlib
import itertools
import json
import os
import threading
import time

from ..obs.tracer import Tracer

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

# Program spans a run scope keeps; past this many its tracer counts the
# rest in ``dropped`` (a long-lived linker must not grow without bound)
_MAX_SPANS_PER_RUN = 1 << 16

# run key -> its program spans and counters (always recording, in memory)
_TRACERS: dict[str, Tracer] = {}
_COUNTERS: dict[str, dict[str, int]] = {}
# the runs of the StageTimers open on each thread, innermost last
_ACTIVE = threading.local()
_COUNT_LOCK = threading.Lock()


def _new_tracer(run_id: str) -> Tracer:
    return Tracer(clock=time.time_ns, ticks_per_s=1e9, run_id=run_id,
                  max_spans=_MAX_SPANS_PER_RUN)


def _scope(run_id: str) -> tuple[Tracer, dict]:
    tracer = _TRACERS.get(run_id)
    if tracer is None:
        tracer = _TRACERS[run_id] = _new_tracer(run_id)
        _COUNTERS[run_id] = {}
    return tracer, _COUNTERS[run_id]


def _active_runs() -> list[str]:
    runs = getattr(_ACTIVE, "runs", None)
    if runs is None:
        runs = _ACTIVE.runs = []
    return runs


def _span_run() -> str:
    """The run a span or count belongs to: the innermost open StageTimer's
    on this thread, else the current run."""
    active = _active_runs()
    return active[-1] if active else _CURRENT_RUN


def begin_run(run_id: str, trace_dir: str | None = None) -> str:
    """Open (and make current) a run scope with fresh timings. Called by
    the linker at construction; a later linker beginning its own run leaves
    this one's timings and trace dir untouched (until it ages past the
    ``_MAX_RETAINED_RUNS`` eviction window)."""
    global _CURRENT_RUN
    _TIMINGS.pop(run_id, None)  # a reused id moves to the newest place
    _TIMINGS[run_id] = {}
    _TRACE_DIRS[run_id] = trace_dir or None
    _TRACERS[run_id] = _new_tracer(run_id)
    _COUNTERS[run_id] = {}
    _CURRENT_RUN = run_id
    while len(_TIMINGS) > _MAX_RETAINED_RUNS + 1:  # +1: the default scope
        oldest = next(
            (k for k in _TIMINGS if k not in (_DEFAULT_RUN, _CURRENT_RUN)), None
        )
        if oldest is None:  # pragma: no cover - cap >= 1 prevents this
            break
        _forget(oldest)
    return run_id


def _forget(run_id: str) -> None:
    for scope in (_TIMINGS, _TRACE_DIRS, _TRACERS, _COUNTERS):
        scope.pop(run_id, None)


def discard_run(run_id: str) -> None:
    """Drop a run scope's recorded state (tests / long-lived processes)."""
    global _CURRENT_RUN
    if run_id == _DEFAULT_RUN:
        _TIMINGS[_DEFAULT_RUN] = {}
        _TRACE_DIRS[_DEFAULT_RUN] = None
        _TRACERS.pop(_DEFAULT_RUN, None)
        _COUNTERS.pop(_DEFAULT_RUN, None)
        return
    _forget(run_id)
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


def _stop_profiler(prof, trace_dir: str, exc, spans=()) -> None:
    """Stop ``prof`` and export its Chrome trace into ``trace_dir``, with
    ``spans`` (program spans on ``time.time_ns``) added as complete events
    on the trace's own time base."""
    prof.__exit__(*exc)
    path = os.path.join(trace_dir, f"trace_{os.getpid()}_{next(_TRACE_SEQ)}.json")
    prof.export_chrome_trace(path)
    if spans:
        with open(path) as fh:
            trace = json.load(fh)
        trace["traceEvents"].extend(chrome_span_events(
            spans, int(trace.get("baseTimeNanoseconds", 0))))
        with open(path, "w") as fh:
            json.dump(trace, fh)


# the Chrome trace row of the program spans (pid: this process)
_SPAN_TID = "program spans"


def chrome_span_events(spans, base_ns: int = 0) -> list[dict]:
    """Program spans as Chrome trace complete ("X") events: ``ts`` is
    ``(t0 - base_ns) / 1000`` microseconds, the time base of
    ``torch.profiler``'s exported trace (its ``baseTimeNanoseconds``), so
    they line up with the trace's host ops and device rows."""
    pid = os.getpid()
    events = [{"name": "thread_name", "ph": "M", "pid": pid, "tid": _SPAN_TID,
               "args": {"name": _SPAN_TID}}]
    for sp in spans:
        args = dict(sp["attrs"], span_id=sp["span_id"], parent_id=sp["parent_id"],
                    run=sp.get("run"), **sp.get("counts", {}))
        events.append({"name": sp["name"], "cat": "program", "ph": "X",
                       "ts": (sp["t0"] - base_ns) / 1e3, "dur": (sp["t1"] - sp["t0"]) / 1e3,
                       "pid": pid, "tid": _SPAN_TID, "args": args})
    return events


def _subtree(spans: list[dict], root: dict) -> list[dict]:
    """``root`` and every span beneath it, in closing order."""
    ids = {root["span_id"]}
    for sp in reversed(spans):  # children close before their parent
        if sp["parent_id"] in ids:
            ids.add(sp["span_id"])
    return [sp for sp in spans if sp["span_id"] in ids]


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
        _active_runs().append(self.run)
        self._tracer = _scope(self.run)[0]
        self._span = self._tracer.begin(self.stage, kind="stage")
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
            stage_span = self._tracer.end(self._span, dur_s=self.elapsed,
                                          failed=exc[0] is not None)
            _active_runs().pop()
            try:
                if self._trace is not None:
                    prof, self._trace = self._trace, None
                    try:
                        _stop_profiler(prof, self.trace_dir, exc,
                                       _subtree(self._tracer.completed, stage_span))
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


# ----------------------------------------------------------------------
# Program spans and counters
# ----------------------------------------------------------------------


@contextlib.contextmanager
def span(name: str, **attrs):
    """A program span beneath the innermost open one (see the module
    docstring); yields the open span (its ``t0`` and its ``attrs``, which
    the body may add to)."""
    tracer = _scope(_span_run())[0]
    sid = tracer.begin(name, kind="span", **attrs)
    sp = tracer.current()
    try:
        yield sp
    finally:
        if tracer.end(sid) is not sp:  # closed already with an enclosing span
            sp["t1"] = time.time_ns()
            sp["dur_s"] = (sp["t1"] - sp["t0"]) * 1e-9


def count(name: str, n: int = 1) -> None:
    """Add ``n`` to counter ``name`` of the span's run and of the innermost
    open span."""
    _add(((name, n),))


def count_each(counts: dict) -> None:
    """Add each of ``counts`` (name -> n) as :func:`count` does."""
    _add(counts.items())


@contextlib.contextmanager
def held_counts():
    """Counts made on this thread inside the block go into the yielded dict
    (name -> n) instead of the run's counters and spans: a CUDA graph's
    capture runs nothing, and each replay counts them (:func:`count_each`)."""
    outer = getattr(_ACTIVE, "held", None)
    held = _ACTIVE.held = {}
    try:
        yield held
    finally:
        _ACTIVE.held = outer


def _add(items) -> None:
    held = getattr(_ACTIVE, "held", None)
    if held is not None:
        for name, n in items:
            held[name] = held.get(name, 0) + n
        return
    tracer, counters = _scope(_span_run())
    top = tracer.current()
    with _COUNT_LOCK:  # threads may count into one run (the default scope)
        counts = top.setdefault("counts", {}) if top is not None else None
        for name, n in items:
            counters[name] = counters.get(name, 0) + n
            if counts is not None:
                counts[name] = counts.get(name, 0) + n


def _nbytes(t) -> int:
    return t.numel() * t.element_size()


def note_sync(device) -> None:
    """One wait of the host for a CUDA device (``torch.cuda.synchronize``,
    an event's ``synchronize``); nothing for another device."""
    if getattr(device, "type", None) == "cuda":
        _add((("host_syncs", 1),))


def note_h2d(*tensors, pinned: bool = False) -> None:
    """Uploads that made each of ``tensors`` (on a CUDA device, not empty)
    from host memory: a copy each, its bytes and, from pageable memory, a
    host wait each (PyTorch's copy without ``non_blocking`` synchronises
    the stream)."""
    cuda = [t for t in tensors if t is not None and t.is_cuda and t.numel()]
    if cuda:
        nbytes = sum(_nbytes(t) for t in cuda)
        items = [("h2d_copies", len(cuda)), ("h2d_bytes", nbytes)]
        if not pinned:
            items += [("h2d_pageable_bytes", nbytes), ("host_syncs", len(cuda))]
        _add(items)


def note_d2h(*tensors, wait: bool = True) -> None:
    """Copies of each of ``tensors`` (on a CUDA device, not empty) to the
    host: a copy each, its bytes and, with ``wait`` (a ``.cpu()``,
    ``.item()`` or ``.tolist()``), a host wait each."""
    cuda = [t for t in tensors if t is not None and t.is_cuda and t.numel()]
    if cuda:
        items = [("d2h_copies", len(cuda)), ("d2h_bytes", sum(_nbytes(t) for t in cuda))]
        if wait:
            items.append(("host_syncs", len(cuda)))
        _add(items)


def note_reads(tensor, n: int) -> None:
    """``n`` reads of single values of ``tensor`` (on a CUDA device) that a
    PyTorch op makes back to the host on its own (``torch.bincount`` reads
    its input's least and greatest value, ``torch.nonzero`` its count): a
    copy and a host wait each."""
    if tensor.is_cuda and tensor.numel():
        _add((("d2h_copies", n), ("d2h_bytes", n * tensor.element_size()),
              ("host_syncs", n)))


def run_ids() -> list[str]:
    """The retained linker run ids, oldest first."""
    return [k for k in _TIMINGS if k != _DEFAULT_RUN]


def run_spans(run: str | None = None) -> list[dict]:
    """The closed program spans of the current run, or of ``run``, in
    closing order (copies)."""
    key = _CURRENT_RUN if run is None else run
    tracer = _TRACERS.get(key)
    if tracer is None:
        return []
    out = []
    for sp in tracer.completed:
        copy = dict(sp, attrs=dict(sp["attrs"]))
        if "counts" in sp:
            copy["counts"] = dict(sp["counts"])
        out.append(copy)
    return out


def run_counters(run: str | None = None) -> dict[str, int]:
    """The counters of the current run, or of ``run`` (a copy)."""
    key = _CURRENT_RUN if run is None else run
    return dict(_COUNTERS.get(key, {}))
