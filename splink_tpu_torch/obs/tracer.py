"""The port's copy of splink_tpu/obs/tracer.py.

Span tracer: nested run -> stage -> EM-iteration spans.

Spans carry a monotonic [t0, t1) interval, a kind, parent linkage and free
attributes, and are emitted to the run's event sink as ``type: "span"``
events when they close. :func:`chrome_trace_from_events` converts a run's
JSONL events into the Chrome trace-event format that ui.perfetto.dev and
chrome://tracing load directly.
"""

from __future__ import annotations

import time
from contextlib import contextmanager


class Tracer:
    """Open/close nested spans; completed spans are kept in order.

    The open-span stack is a plain list, not thread-local: the pipeline is
    one host thread, and the EM host-callback thread never opens stage
    spans (iteration spans record their parent explicitly — see
    ``RunContext.em_begin``).
    """

    def __init__(self, clock=time.monotonic):
        self._clock = clock
        self._next_id = 1
        self._stack: list[dict] = []
        self.completed: list[dict] = []

    def current_id(self) -> int | None:
        return self._stack[-1]["span_id"] if self._stack else None

    def begin(self, name: str, kind: str = "stage", parent: int | None = None, **attrs) -> int:
        span = {
            "span_id": self._next_id,
            "parent_id": parent if parent is not None else self.current_id(),
            "name": name,
            "kind": kind,
            "t0": self._clock(),
            "attrs": dict(attrs),
        }
        self._next_id += 1
        self._stack.append(span)
        return span["span_id"]

    def end(self, span_id: int, **attrs) -> dict:
        """Close ``span_id`` (and, defensively, anything opened after it
        that was left dangling by an exception) and return the span dict."""
        while self._stack:
            span = self._stack.pop()
            if span["span_id"] == span_id or not self._stack:
                break
        else:  # pragma: no cover - end() without begin()
            span = {"span_id": span_id, "parent_id": None, "name": "?",
                    "kind": "stage", "t0": self._clock(), "attrs": {}}
        span["t1"] = self._clock()
        span["dur_s"] = span["t1"] - span["t0"]
        span["attrs"].update(attrs)
        self.completed.append(span)
        return span

    def emit_closed(self, name: str, kind: str, t0: float, t1: float,
                    parent: int | None = None, **attrs) -> dict:
        """Record an already-timed interval as a span (used for EM
        iteration spans, whose boundaries are host-callback arrivals)."""
        span = {
            "span_id": self._next_id,
            "parent_id": parent,
            "name": name,
            "kind": kind,
            "t0": t0,
            "t1": t1,
            "dur_s": t1 - t0,
            "attrs": dict(attrs),
        }
        self._next_id += 1
        self.completed.append(span)
        return span

    @contextmanager
    def span(self, name: str, kind: str = "stage", **attrs):
        sid = self.begin(name, kind=kind, **attrs)
        try:
            yield sid
        finally:
            self.end(sid)


# Track rows in the chrome trace, one per span kind. Row 4 renders the
# grafted REMOTE half of stitched cross-host traces (obs/fleet.py): the
# far server's span tree, rebased onto this host's clock by the wire
# client's offset estimate, directly under the local attempt row.
_KIND_TID = {"run": 0, "stage": 1, "em_iteration": 2, "request": 3,
             "remote": 4}


def chrome_trace_from_events(events: list[dict]) -> dict:
    """Convert telemetry JSONL events to the Chrome trace-event JSON format.

    * ``span`` events -> complete ("X") slices, microsecond timestamps on
      the run's monotonic timebase, one pid per controller process and one
      tid row per span kind;
    * ``request_trace`` events (serve tier, obs v2) -> one slice per
      phase, laid out back-to-back from the request's submit time on the
      "requests" row, with the request envelope in the args — the per-
      request waterfall Perfetto renders directly;
    * ``em_iteration``/resilience/``memory`` events -> instant ("i")
      markers, so retries/faults/checkpoints show up on the timeline.

    Load the result at ui.perfetto.dev or chrome://tracing.
    """
    trace_events = []
    pids = set()
    for ev in events:
        pid = int(ev.get("process_index", 0) or 0)
        pids.add(pid)
        etype = ev.get("type")
        if etype == "request_trace":
            t = float(ev.get("t0", 0.0)) * 1e6
            envelope = {
                k: ev.get(k)
                for k in ("trace_id", "request_id", "attempt", "hedge",
                          "service", "outcome", "reason", "wall_ms")
            }
            for phase, dur_ms in (ev.get("phases_ms") or {}).items():
                dur = max(float(dur_ms or 0.0), 0.0) * 1e3
                trace_events.append(
                    {
                        "name": f"{phase} [{ev.get('request_id', '?')}]",
                        "cat": "request",
                        "ph": "X",
                        "ts": t,
                        "dur": dur,
                        "pid": pid,
                        "tid": _KIND_TID["request"],
                        "args": dict(envelope, phase=phase),
                    }
                )
                t += dur
            remote = ev.get("remote_span")
            if isinstance(remote, dict):
                # the stitched remote waterfall: offset-corrected t0 (the
                # wire client already rebased it), the server's own phase
                # partition back-to-back on the "remote" row
                rt = float(remote.get("t0", 0.0)) * 1e6
                renv = dict(
                    envelope,
                    remote_service=remote.get("service"),
                    clock_offset_s=ev.get("clock_offset_s"),
                    wire_ms=ev.get("wire_ms"),
                )
                for phase, dur_ms in (remote.get("phases_ms") or {}).items():
                    dur = max(float(dur_ms or 0.0), 0.0) * 1e3
                    trace_events.append(
                        {
                            "name": f"{phase} [{remote.get('request_id', '?')}"
                                    f"@{remote.get('service', 'remote')}]",
                            "cat": "remote",
                            "ph": "X",
                            "ts": rt,
                            "dur": dur,
                            "pid": pid,
                            "tid": _KIND_TID["remote"],
                            "args": dict(renv, phase=phase),
                        }
                    )
                    rt += dur
            continue
        if etype == "span":
            tid = _KIND_TID.get(ev.get("kind", "stage"), 1)
            trace_events.append(
                {
                    "name": ev.get("name", "?"),
                    "cat": ev.get("kind", "stage"),
                    "ph": "X",
                    "ts": float(ev.get("t0", 0.0)) * 1e6,
                    "dur": max(float(ev.get("dur_s", 0.0)), 0.0) * 1e6,
                    "pid": pid,
                    "tid": tid,
                    "args": ev.get("attrs") or {},
                }
            )
        elif etype in ("em_iteration", "retry", "fault", "checkpoint",
                       "degradation", "memory"):
            trace_events.append(
                {
                    "name": f"{etype}"
                    + (f" #{ev['iteration']}" if "iteration" in ev else ""),
                    "cat": etype,
                    "ph": "i",
                    "s": "p",
                    "ts": float(ev.get("mono", 0.0)) * 1e6,
                    "pid": pid,
                    "tid": _KIND_TID["em_iteration"],
                    "args": {
                        k: v
                        for k, v in ev.items()
                        if k not in ("v", "type", "ts", "mono")
                    },
                }
            )
    meta = [
        {"name": "process_name", "ph": "M", "pid": pid, "args": {"name": f"host {pid}"}}
        for pid in sorted(pids)
    ] + [
        {"name": "thread_name", "ph": "M", "pid": pid, "tid": tid,
         "args": {"name": row}}
        for pid in sorted(pids)
        for row, tid in (("run", 0), ("stages", 1), ("em / events", 2),
                         ("requests", 3), ("remote (stitched)", 4))
    ]
    return {"traceEvents": meta + trace_events, "displayTimeUnit": "ms"}
