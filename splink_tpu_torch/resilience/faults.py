"""Deterministic fault injection for the EM execution stack.

The port's copy of splink_tpu/resilience/faults.py, keeping the plan
grammar, the ``SPLINK_TPU_FAULTS`` environment variable and the
``fault_plan`` settings key, so that one plan drives both packages. Every
recovery path (pass retry, checkpoint resume, OOM degradation) has a test
that fires it through these injection points.

Plan grammar (comma-separated events)::

    <site>@key=value[:key=value...]

    batch_fetch@iter=2:batch=3            transient stream error (default kind)
    batch_fetch@iter=1:batch=0:kind=oom   simulated device out-of-memory
    em_iteration@iter=4:kind=kill         SIGKILL own process at iteration 4
    resident_em@kind=oom                  device OOM entering the resident path
    segment@iter=10:kind=transient        error at a checkpointed-EM boundary
    emit_segment@seq=2:kind=kill          SIGKILL between a spill segment's
                                          bytes and its manifest commit
    wire_response@kind=net_torn_frame     cut one wire reply mid-frame
    wire_accept@kind=net_partition:delay_ms=500  drop + refuse conns 500ms

The sites this package fires (SITES): ``resident_em`` (entering resident
EM), ``segment`` (each checkpoint boundary of run_em_checkpointed),
``batch_fetch`` (each batch of a streamed EM pass), ``em_iteration``
(each streamed update, after its checkpoint) and, on the durable write
path, ``emit_segment`` (blocking_device.emit_pairs_sharded, after a spill
segment's bytes are appended and fsynced and before its manifest commit —
the widest window a kill can tear; coords rule, shard, seq) and
``build_chunk`` (the out-of-core serving-index build, serve/index.py,
between a packed chunk's bytes and its watermark commit; coord chunk).
The serving sites: ``serve_worker`` (the service's worker loop, outside
a batch: a raise there kills the worker thread, which the watchdog
restarts; coord batch), ``serve_batch`` (each batch dispatch; coord
batch), ``swap_load`` and ``swap_validate`` (index hot-swap; coord
generation). The wire sites (``WIRE_SITES``, fired by serve/wire.py):
``wire_accept`` (each accepted connection), ``wire_request`` (each
request frame read) and ``wire_response`` (each reply frame written).
Each event is published as a ``fault`` event on the ambient
channel of ``obs.events`` before it acts. ``iter`` /
``batch`` constrain when an event matches (omitted = any); ``times``
bounds how often it fires (default 1), so a retried pass sees the fault
once and then succeeds. The kill kind uses SIGKILL (no atexit, no finally
blocks); the slow kind sleeps ``delay_ms`` (default 250) and returns.

The ``net_*`` kinds model link failures rather than compute failures:

    net_drop        the connection dies abruptly at the site (the server
                    closes the socket with no reply; the client resolves
                    every in-flight future as a shed)
    net_delay       the link stalls delay_ms then continues, like kind=slow
    net_torn_frame  a frame is cut mid-write (the length prefix promises
                    more bytes than arrive); the reader rejects it without
                    poisoning the connection state
    net_partition   the host is unreachable for delay_ms: every live
                    connection drops and new connects are refused until
                    the partition heals
"""

from __future__ import annotations

import logging
import os
import signal
import time

logger = logging.getLogger("splink_tpu_torch")

ENV_VAR = "SPLINK_TPU_FAULTS"

_KINDS = (
    "transient", "oom", "kill", "slow",
    "net_drop", "net_delay", "net_torn_frame", "net_partition",
)

DEFAULT_SLOW_DELAY_MS = 250

SITES = (
    "resident_em", "segment", "batch_fetch", "em_iteration", "emit_segment",
    "build_chunk", "serve_worker", "serve_batch", "swap_load", "swap_validate",
    "wire_accept", "wire_request", "wire_response",
)

# The wire tier's injection points (module docstring).
WIRE_SITES = ("wire_accept", "wire_request", "wire_response")


class InjectedFault(RuntimeError):
    """A deliberately injected failure. ``retry.classify_error`` and
    ``retry.is_oom`` read its kind, so injected faults take the same
    recovery paths as real ones."""

    def __init__(self, site: str, kind: str, coords: dict,
                 delay_ms: int = DEFAULT_SLOW_DELAY_MS):
        self.site = site
        self.kind = kind
        self.coords = dict(coords)
        # net_partition reads delay_ms as the partition's duration: the
        # wire server takes it off the caught fault to schedule the heal
        self.delay_ms = delay_ms
        what = ("injected device out of memory" if kind == "oom"
                else f"injected {kind} failure")
        super().__init__(f"injected fault at {site} {coords}: {what}")


class _Event:
    __slots__ = ("site", "kind", "match", "times", "delay_ms")

    def __init__(self, site: str, kind: str, match: dict, times: int,
                 delay_ms: int = DEFAULT_SLOW_DELAY_MS):
        self.site = site
        self.kind = kind
        self.match = match  # {"iter": int, "batch": int, ...}
        self.times = times
        self.delay_ms = delay_ms

    def matches(self, site: str, coords: dict) -> bool:
        if self.times <= 0 or site != self.site:
            return False
        return all(coords.get(k) == v for k, v in self.match.items())


class FaultPlan:
    """A parsed, stateful fault plan. ``fire(site, **coords)`` is called at
    each injection point; matching events decrement their budget and then
    raise (or kill). An empty plan is a no-op."""

    def __init__(self, events: list[_Event] | None = None, spec: str = ""):
        self.events = events or []
        self.spec = spec

    def __bool__(self) -> bool:
        return bool(self.events)

    @classmethod
    def from_spec(cls, spec: str | None) -> "FaultPlan":
        spec = (spec or "").strip()
        if not spec:
            return cls()
        events = []
        for part in spec.split(","):
            part = part.strip()
            if not part:
                continue
            site, _, argstr = part.partition("@")
            kind, times, match = "transient", 1, {}
            delay_ms = DEFAULT_SLOW_DELAY_MS
            for kv in filter(None, argstr.split(":")):
                key, _, value = kv.partition("=")
                key = key.strip()
                if key == "kind":
                    if value not in _KINDS:
                        raise ValueError(
                            f"fault plan {part!r}: kind must be one of {_KINDS}"
                        )
                    kind = value
                elif key == "times":
                    times = int(value)
                elif key == "delay_ms":
                    delay_ms = int(value)
                else:
                    match[key] = int(value)
            events.append(_Event(site.strip(), kind, match, times, delay_ms))
        return cls(events, spec)

    def fire(self, site: str, **coords) -> None:
        """Raise/kill/stall if an event matches this (site, coords); else
        no-op."""
        if not self.events:
            return
        for ev in self.events:
            if ev.matches(site, coords):
                ev.times -= 1
                logger.warning("fault injection: %s at %s %s", ev.kind, site, coords)
                # published before a raise or kill, which no later code
                # could report
                from ..obs.events import publish

                publish("fault", site=site, kind=ev.kind, coords=dict(coords))
                if ev.kind in ("slow", "net_delay"):
                    time.sleep(ev.delay_ms / 1000.0)
                    continue  # a stall completes; later events may still fire
                if ev.kind == "kill":
                    os.kill(os.getpid(), signal.SIGKILL)
                raise InjectedFault(site, ev.kind, coords, ev.delay_ms)


# One live plan per spec string: event budgets (``times``) are shared by
# every hook in the process, or a once-only fault would re-fire at each
# injection site that consults the plan.
_PLAN_CACHE: dict[str, FaultPlan] = {}


def active_plan(settings: dict | None = None) -> FaultPlan:
    """The process's active fault plan: ``SPLINK_TPU_FAULTS`` first, else
    the ``fault_plan`` settings key, else an empty (no-op) plan."""
    spec = os.environ.get(ENV_VAR) or (settings or {}).get("fault_plan") or ""
    if spec not in _PLAN_CACHE:
        _PLAN_CACHE[spec] = FaultPlan.from_spec(spec)
    return _PLAN_CACHE[spec]


def reset_plans() -> None:
    """Forget fired-event state (tests only)."""
    _PLAN_CACHE.clear()
