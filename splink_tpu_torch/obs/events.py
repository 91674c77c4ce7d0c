"""JSONL event sink + the ambient publish hook.

The port's copy of splink_tpu/obs/events.py.

One event per line, append-only, flushed per event so a killed process (the
fault-injection SIGKILL included) loses at most the event being written.
Every event carries the envelope::

    {"v": 1, "run_id": ..., "type": ..., "ts": <unix s>, "mono": <monotonic s>,
     "process_index": ..., "process_count": ..., ...type-specific fields}

``mono`` is the span/ordering timebase (monotonic, immune to wall-clock
steps); ``ts`` is for humans. Values are sanitised before serialisation:
numpy scalars/arrays become Python numbers/lists and non-finite floats
become null — the file is always strict JSON.

The resilience stack (retry, fault injection, checkpoints, degradations)
publishes through the module-level :func:`publish`, which fans out to every
registered sink. With no sink registered it is one falsy check — the
production no-telemetry path stays zero-cost.
"""

from __future__ import annotations

import json
import logging
import math
import os
import threading
import time

from ..analysis import lockwatch

logger = logging.getLogger("splink_tpu_torch")

SCHEMA_VERSION = 1


def _sanitise(value):
    """JSON-safe copy: numpy -> Python, non-finite floats -> None."""
    if isinstance(value, dict):
        return {str(k): _sanitise(v) for k, v in value.items()}
    if isinstance(value, (list, tuple)):
        return [_sanitise(v) for v in value]
    if isinstance(value, bool) or value is None or isinstance(value, (str, int)):
        return value
    if isinstance(value, float):
        return value if math.isfinite(value) else None
    # numpy scalars and 0-d arrays expose item(); arrays expose tolist()
    item = getattr(value, "item", None)
    if item is not None and getattr(value, "ndim", 1) == 0:
        return _sanitise(item())
    tolist = getattr(value, "tolist", None)
    if tolist is not None:
        return _sanitise(tolist())
    return str(value)


class EventSink:
    """Thread-safe append-only JSONL writer for one run.

    Writes must never break the run they observe: the first failed write
    disables the sink with a single warning and every later emit is a no-op.
    """

    def __init__(self, path: str | os.PathLike, run_id: str, tags: dict | None = None):
        self.path = os.fspath(path)
        self.run_id = run_id
        self.tags = dict(tags or {})
        self._lock = lockwatch.new_lock("EventSink._lock")
        self._failed = False
        parent = os.path.dirname(self.path)
        if parent:
            os.makedirs(parent, exist_ok=True)
        self._f = open(self.path, "a", encoding="utf-8")

    def emit(self, type: str, **fields) -> None:
        if self._failed:
            return
        event = {
            "v": SCHEMA_VERSION,
            "run_id": self.run_id,
            "type": type,
            "ts": time.time(),
            "mono": time.monotonic(),
            **self.tags,
            **_sanitise(fields),
        }
        try:
            line = json.dumps(event)
            with self._lock:
                self._f.write(line + "\n")
                self._f.flush()
        except Exception as e:  # noqa: BLE001 - telemetry must never kill a run
            self._failed = True
            logger.warning(
                "telemetry sink %s disabled after write failure: %s", self.path, e
            )

    def close(self) -> None:
        unregister_ambient(self)
        try:
            self._f.close()
        except Exception:  # noqa: BLE001 - already closed / interpreter teardown
            pass
        self._failed = True


# ---------------------------------------------------------------------------
# Ambient publishing: resilience/degradation events originate in modules that
# know nothing about linkers or run contexts. Active sinks register here;
# publish() fans out to all of them (each event lands in every concurrently
# active run's record, tagged with that run's id — concurrent linkers in one
# process cannot tell whose retry it was, so both keep it).
# ---------------------------------------------------------------------------

_AMBIENT: list[EventSink] = []
_AMBIENT_LOCK = threading.Lock()


def register_ambient(sink: EventSink) -> None:
    with _AMBIENT_LOCK:
        if sink not in _AMBIENT:
            _AMBIENT.append(sink)


def unregister_ambient(sink: EventSink) -> None:
    with _AMBIENT_LOCK:
        if sink in _AMBIENT:
            _AMBIENT.remove(sink)


def publish(type: str, **fields) -> None:
    """Emit an event to every active sink; a no-op (one truthiness check)
    when telemetry is disabled."""
    if not _AMBIENT:
        return
    with _AMBIENT_LOCK:
        sinks = list(_AMBIENT)
    for sink in sinks:
        sink.emit(type, **fields)


def read_events(path: str | os.PathLike):
    """Parse a telemetry JSONL file into a list of event dicts. Corrupt
    lines (a torn tail from a killed process) are skipped, not fatal."""
    events = []
    with open(os.fspath(path), encoding="utf-8") as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            try:
                events.append(json.loads(line))
            except json.JSONDecodeError:
                continue
    return events
