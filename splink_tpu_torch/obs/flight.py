"""Crash flight recorder: a bounded ring of recent serve telemetry, dumped
atomically to JSONL when something breaks.

The port's copy of splink_tpu/obs/flight.py.

A JSONL sink records everything but needs ``telemetry_dir`` configured and
grows with the run; an incident needs the *last N things that happened*
regardless of configuration. The :class:`FlightRecorder` keeps a bounded
in-memory ring (``obs_flight_records`` settings key) of:

* recent **request span trees** (``request_trace`` events, fed directly by
  the service's :class:`~.reqtrace.ServeTracer`), and
* **state transitions** — health changes, breaker open/close, index swaps,
  worker restarts, degradations, injected faults — captured by registering
  as an ambient event sink (it implements the ``emit(type, **fields)``
  shape :func:`..obs.events.publish` fans out to).

On a trigger the ring is dumped atomically (temp file + fsync + rename,
the checkpoint writer's discipline) to ``<dump_dir>/flight_*.jsonl``:

* circuit breaker opening,
* watchdog worker restart,
* index-swap rollback,
* ``SIGUSR2`` (operator-requested snapshot of every live recorder),
* an explicit :meth:`dump` call.

Dumps are rate-limited per trigger (a breaker storm produces one artifact,
not hundreds) and the file is plain telemetry JSONL: ``read_events`` loads
it back. Everything here is host-side
stdlib and never raises into the serving path.
"""

from __future__ import annotations

import json
import logging
import os
import signal
import tempfile
import threading
import time
import weakref
from collections import deque

from ..analysis import lockwatch

from .events import _sanitise, unregister_ambient

logger = logging.getLogger("splink_tpu_torch")

#: Event types the ambient hook keeps in the ring (the serve incident
#: timeline). ``request_trace`` events arrive via :meth:`note_trace`
#: instead so they are recorded once, not per ambient fan-out.
TRANSITION_TYPES = (
    "health",
    "breaker",
    "index_swap",
    "serve_worker_restart",
    "brownout_end",
    "degradation",
    "fault",
    "retry",
    "drift_alert",
    "drift_clear",
    "perf_alert",
    "perf_clear",
    "perf_window",
    # a completed background reconnect is a link-state transition: the
    # incident ring must show when a remote came back, not just the
    # sheds while it was gone (serve/remote.py)
    "wire_reconnect",
    # concurrency audit events (analysis/lockwatch.py + thread-smoke): an
    # observed lock-order inversion is exactly the kind of one-in-a-
    # thousand incident the ring exists for, and the audit summary stamps
    # the timeline with what the fleet looked like when it was checked
    "lock_inversion",
    "thread_audit",
    # fleet observability (obs/fleet.py): federation sweeps, network-
    # phase regression edges on a remote link, and the pointer to a
    # written incident bundle all belong on the incident timeline
    "fleet_scrape",
    "fleet_net_alert",
    "fleet_net_clear",
    "incident_bundle",
    # numerics (analysis layer 6 + em.py trajectory guard): a NaN/Inf
    # halt of an EM run is a first-class incident, and the num-smoke
    # audit summary stamps the timeline like thread_audit does
    "em_numerics",
    "num_audit",
)

_RECORDERS: "weakref.WeakSet[FlightRecorder]" = weakref.WeakSet()
_SIGNAL_LOCK = threading.Lock()
_SIGNAL_INSTALLED = False


def default_dump_dir() -> str:
    return os.path.join(tempfile.gettempdir(), "splink_tpu_flight")


def install_flight_signal() -> bool:
    """Install the process-wide SIGUSR2 handler that dumps every live
    recorder. Idempotent; returns False where installation is impossible
    (non-main thread, platforms without SIGUSR2) — the recorder still
    works, only the signal trigger is unavailable."""
    global _SIGNAL_INSTALLED
    with _SIGNAL_LOCK:
        if _SIGNAL_INSTALLED:
            return True
        try:
            signal.signal(signal.SIGUSR2, _on_sigusr2)
        except (ValueError, AttributeError, OSError) as e:
            logger.debug("flight SIGUSR2 handler not installed: %s", e)
            return False
        _SIGNAL_INSTALLED = True
        return True


def _on_sigusr2(signum, frame):  # pragma: no cover - exercised via direct call
    dump_all("sigusr2")


def dump_all(trigger: str) -> list[str]:
    """Dump every live recorder (the SIGUSR2 path); returns written paths."""
    paths = []
    for rec in list(_RECORDERS):
        path = rec.dump(trigger)
        if path:
            paths.append(path)
    return paths


class FlightRecorder:
    """Bounded post-mortem ring + atomic dump (module docstring).

    ``capacity`` <= 0 disables the recorder entirely (every method is a
    cheap no-op). Registered as an ambient sink by the owning service;
    :meth:`close` unregisters it.
    """

    def __init__(
        self,
        capacity: int = 256,
        *,
        dump_dir: str | None = None,
        name: str = "serve",
        min_dump_interval_s: float = 1.0,
        clock=time.monotonic,
    ):
        self.capacity = int(capacity)
        self.name = name
        self.dump_dir = dump_dir or default_dump_dir()
        self.min_dump_interval_s = float(min_dump_interval_s)
        self._clock = clock
        self._lock = lockwatch.new_lock("FlightRecorder._lock")
        self._ring: deque = deque(maxlen=max(self.capacity, 1))
        self._last_dump: dict[str, float] = {}
        self._dump_seq = 0
        self.dumps: list[str] = []
        if self.enabled:
            _RECORDERS.add(self)
            install_flight_signal()

    @property
    def enabled(self) -> bool:
        return self.capacity > 0

    # -- ambient-sink interface (events.publish fans out to this) --------

    def emit(self, type: str, **fields) -> None:
        """Capture one published event; transitions enter the ring and
        trigger events dump it. Never raises."""
        if not self.enabled:
            return
        try:
            if type in TRANSITION_TYPES:
                entry = {
                    "type": type,
                    "ts": time.time(),
                    "mono": time.monotonic(),
                    **_sanitise(fields),
                }
                with self._lock:
                    self._ring.append(entry)
            trigger = self._classify_trigger(type, fields)
            if trigger:
                self.dump(trigger)
        except Exception as e:  # noqa: BLE001 - the recorder must never break serving
            logger.warning("flight recorder emit failed: %s", e)

    def note_trace(self, event: dict) -> None:
        """Append one closed request span tree (already sanitised by the
        tracer's event emission)."""
        if not self.enabled:
            return
        with self._lock:
            self._ring.append(dict(event, mono=time.monotonic()))

    def _classify_trigger(self, type: str, fields: dict) -> str | None:
        # The ambient channel is process-wide, so the RING captures every
        # replica's transitions (the whole-process timeline a post-mortem
        # wants) — but a DUMP fires only for incidents carrying this
        # recorder's replica name, or none at all (engine-level events
        # like swap rollback have no replica identity), so N replicas in
        # one process don't produce N artifacts for one replica's breaker.
        replica = fields.get("replica")
        if replica is not None and replica != self.name:
            return None
        if type == "serve_worker_restart":
            return "worker_restart"
        if type == "drift_alert":
            # the answers moved off the training reference: the ring
            # around that moment (which queries, which health state, any
            # swap that landed) is exactly the retraining post-mortem
            return "drift_alert"
        if type == "lock_inversion":
            # an observed acquisition-order inversion is a latent
            # deadlock: dump the ring NOW, while the traffic that drove
            # the two threads into opposite orders is still in it. The
            # event has no replica identity (locks are process-wide), so
            # every recorder in the process dumps — a deadlock candidate
            # is worth N artifacts.
            return "lock_inversion"
        if type == "perf_alert":
            # the serving kernels got slower: the event carries the
            # KernelWatch window snapshot, so the dump holds both the
            # regression numbers and the traffic around them (rate-
            # limited like breaker-open — a sustained regression produces
            # one artifact, not one per tick)
            return "perf_alert"
        if type == "degradation":
            to = fields.get("to")
            if to == "breaker_open":
                return "breaker_open"
            if fields.get("from") == "serve_index_swap" and to == "rolled_back":
                return "swap_rollback"
        return None

    # -- dumping ---------------------------------------------------------

    def snapshot(self) -> list[dict]:
        with self._lock:
            return list(self._ring)

    def dump(self, trigger: str, path: str | None = None) -> str | None:
        """Atomically write the ring (+ a header line) as JSONL; returns
        the path, or None when disabled / rate-limited / the write failed.
        Never raises."""
        if not self.enabled:
            return None
        try:
            now = self._clock()
            with self._lock:
                last = self._last_dump.get(trigger, float("-inf"))
                if now - last < self.min_dump_interval_s:
                    return None
                self._last_dump[trigger] = now
                entries = list(self._ring)
                self._dump_seq += 1
                seq = self._dump_seq
            if path is None:
                os.makedirs(self.dump_dir, exist_ok=True)
                path = os.path.join(
                    self.dump_dir,
                    f"flight_{self.name}_{trigger}_"
                    f"{os.getpid()}_{seq:04d}.jsonl",
                )
            header = {
                "type": "flight_header",
                "trigger": trigger,
                "service": self.name,
                "ts": time.time(),
                "mono": time.monotonic(),
                "records": len(entries),
                "capacity": self.capacity,
            }
            lines = [json.dumps(_sanitise(header))]
            lines.extend(json.dumps(_sanitise(e)) for e in entries)
            payload = ("\n".join(lines) + "\n").encode("utf-8")
            # the checkpoint writer's atomic discipline (lazy import: the
            # resilience package publishes back into obs at import time)
            from ..resilience.checkpoint import atomic_write_bytes

            atomic_write_bytes(path, payload)
            with self._lock:
                self.dumps.append(path)
            logger.warning(
                "flight recorder dumped %d record(s) to %s (trigger: %s)",
                len(entries), path, trigger,
            )
            return path
        except Exception as e:  # noqa: BLE001 - a failed dump must not break serving
            logger.warning("flight recorder dump failed: %s", e)
            return None

    def close(self) -> None:
        """Unregister from the ambient publisher and the signal registry;
        the ring stays readable (a closed service's recorder can still be
        dumped explicitly)."""
        unregister_ambient(self)
        _RECORDERS.discard(self)
