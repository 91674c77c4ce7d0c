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

The sites this package fires (SITES): ``resident_em`` (entering resident
EM), ``segment`` (each checkpoint boundary of run_em_checkpointed),
``batch_fetch`` (each batch of a streamed EM pass) and ``em_iteration``
(each streamed update, after its checkpoint). ``iter`` / ``batch``
constrain when an event matches (omitted = any); ``times`` bounds how often
it fires (default 1), so a retried pass sees the fault once and then
succeeds. The kill kind uses SIGKILL (no atexit, no finally blocks); the
slow kind sleeps ``delay_ms`` (default 250) and returns.
"""

from __future__ import annotations

import logging
import os
import signal
import time

logger = logging.getLogger("splink_tpu_torch")

ENV_VAR = "SPLINK_TPU_FAULTS"

_KINDS = ("transient", "oom", "kill", "slow")

DEFAULT_SLOW_DELAY_MS = 250

SITES = ("resident_em", "segment", "batch_fetch", "em_iteration")


class InjectedFault(RuntimeError):
    """A deliberately injected failure. ``retry.classify_error`` and
    ``retry.is_oom`` read its kind, so injected faults take the same
    recovery paths as real ones."""

    def __init__(self, site: str, kind: str, coords: dict,
                 delay_ms: int = DEFAULT_SLOW_DELAY_MS):
        self.site = site
        self.kind = kind
        self.coords = dict(coords)
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
                if ev.kind == "slow":
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
