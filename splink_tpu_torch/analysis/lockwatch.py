"""lockwatch: the dynamic half of threadlint.

The port of splink_tpu/analysis/lockwatch.py. The serve and obs modules
create every lock through :func:`new_lock` / :func:`new_rlock` under a
``Class._attr`` name; with ``SPLINK_TPU_LOCKWATCH`` unset these return
plain ``threading`` primitives, at no cost and with no indirection. With
it set, each lock is wrapped to record the per-thread acquisition ORDER:
acquiring B while holding A adds the edge A -> B to a process-global
observed graph.

An edge that closes a cycle is a lock-order inversion, the dynamic twin of
static rule TL004, and is reported at once as a ``lock_inversion`` event
on the ambient sink (published from a fresh daemon thread, so that the
report never runs foreign code under the application locks it is
complaining about). ``chip_smoke.py``'s ``thread`` phase and
``tests/test_torch_lockwatch.py`` then assert that the observed graph is
acyclic AND that its union with the static graph from
:func:`.threadlint.build_lock_graph` stays acyclic: the runtime order must
agree with the declared one, not merely with itself.

``SPLINK_TPU_LOCKWATCH_JITTER_US=<n>`` adds a random 0..n microsecond
sleep before every acquisition, widening race windows the way a lowered
``sys.setswitchinterval`` does.
"""

from __future__ import annotations

import json
import os
import random
import threading
import time

ENV_VAR = "SPLINK_TPU_LOCKWATCH"
JITTER_ENV_VAR = "SPLINK_TPU_LOCKWATCH_JITTER_US"


def enabled() -> bool:
    """Is instrumentation on? Checked once per lock CREATION (not per
    acquire) so flipping the env var mid-process only affects new locks."""
    return os.environ.get(ENV_VAR, "").strip().lower() not in (
        "",
        "0",
        "false",
        "off",
    )


# Process-global observed state. _REG_LOCK is a plain lock (never watched,
# never published under) guarding the graph; the held-stack is per-thread.
_REG_LOCK = threading.Lock()
_EDGES: dict[tuple[str, str], dict] = {}
_NODES: set[str] = set()
_INVERSIONS: list[dict] = []
_local = threading.local()


def _held() -> list[str]:
    stack = getattr(_local, "held", None)
    if stack is None:
        stack = _local.held = []
    return stack


def _jitter_seconds() -> float:
    raw = os.environ.get(JITTER_ENV_VAR, "").strip()
    if not raw:
        return 0.0
    try:
        cap_us = int(raw)
    except ValueError:
        return 0.0
    if cap_us <= 0:
        return 0.0
    return random.uniform(0.0, cap_us) * 1e-6


def _find_path(src: str, dst: str) -> list[str] | None:
    """DFS path src -> dst over _EDGES; caller holds _REG_LOCK."""
    adj: dict[str, list[str]] = {}
    for a, b in _EDGES:
        adj.setdefault(a, []).append(b)
    stack = [(src, [src])]
    seen = {src}
    while stack:
        node, path = stack.pop()
        if node == dst:
            return path
        for nxt in adj.get(node, []):
            if nxt not in seen:
                seen.add(nxt)
                stack.append((nxt, path + [nxt]))
    return None


def _publish_inversion(inversion: dict) -> None:
    """Report on a fresh daemon thread: the acquiring thread holds real
    application locks right now, and the sink's own lock plus arbitrary
    subscriber code must not run under them (that would be TL003)."""

    def _report() -> None:
        try:
            from ..obs.events import publish

            publish(
                "lock_inversion",
                cycle=inversion["cycle"],
                edge=inversion["edge"],
                site=inversion["site"],
                thread=inversion["thread"],
            )
        except Exception:
            pass  # diagnostics must never take the serve path down

    threading.Thread(target=_report, daemon=True).start()


def _record_edge(src: str, dst: str) -> None:
    if src == dst:
        return
    site = _caller_site()
    inversion = None
    with _REG_LOCK:
        entry = _EDGES.get((src, dst))
        if entry is not None:
            entry["count"] += 1
            return
        # new edge: does dst already reach src? then src->dst closes a cycle
        back = _find_path(dst, src)
        _EDGES[(src, dst)] = {"count": 1, "site": site}
        if back is not None:
            cycle = back + [dst]  # dst -> ... -> src -> dst, rotated below
            inversion = {
                "cycle": sorted(set(cycle)),
                "edge": [src, dst],
                "site": site,
                "thread": threading.current_thread().name,
            }
            _INVERSIONS.append(inversion)
    if inversion is not None:
        _publish_inversion(inversion)


def _caller_site() -> str:
    """First stack frame outside this module — the acquisition site."""
    import sys

    frame = sys._getframe(1)
    here = __file__
    while frame is not None and frame.f_code.co_filename == here:
        frame = frame.f_back
    if frame is None:
        return "?:0"
    return f"{os.path.basename(frame.f_code.co_filename)}:{frame.f_lineno}"


class _WatchedLock:
    """Lock/RLock wrapper recording acquisition order. Implements the
    full acquire/release/context protocol plus ``_is_owned`` so
    ``threading.Condition(watched_lock)`` works unchanged (Condition
    falls back to acquire/release for its release-save dance and probes
    ``_is_owned`` for ownership checks)."""

    def __init__(self, name: str, reentrant: bool):
        self.name = name
        self._reentrant = reentrant
        self._inner = threading.RLock() if reentrant else threading.Lock()
        with _REG_LOCK:
            _NODES.add(name)

    def acquire(self, blocking: bool = True, timeout: float = -1):
        jitter = _jitter_seconds()
        if jitter:
            time.sleep(jitter)
        got = self._inner.acquire(blocking, timeout)
        if got:
            held = _held()
            if self._reentrant and self.name in held:
                held.append(self.name)  # re-entry: depth only, no edge
            else:
                if held:
                    _record_edge(held[-1], self.name)
                held.append(self.name)
        return got

    def release(self) -> None:
        # update the (thread-local) stack before the real release so the
        # accounting is consistent the instant another thread gets in
        held = _held()
        for i in range(len(held) - 1, -1, -1):
            if held[i] == self.name:
                del held[i]
                break
        self._inner.release()

    def __enter__(self):
        self.acquire()
        return self

    def __exit__(self, *exc):
        self.release()
        return False

    def locked(self) -> bool:
        inner = self._inner
        if hasattr(inner, "locked"):
            return inner.locked()
        if inner.acquire(False):
            inner.release()
            return False
        return True

    def _is_owned(self) -> bool:
        inner = self._inner
        if hasattr(inner, "_is_owned"):
            return inner._is_owned()
        if inner.acquire(False):
            inner.release()
            return False
        return True

    def __repr__(self) -> str:  # pragma: no cover - debug aid
        kind = "rlock" if self._reentrant else "lock"
        return f"<lockwatch {kind} {self.name!r}>"


def new_lock(name: str):
    """A ``threading.Lock`` (or its watched wrapper when instrumentation
    is on). ``name`` should be ``Class._attr`` to match the static graph."""
    return _WatchedLock(name, reentrant=False) if enabled() else threading.Lock()


def new_rlock(name: str):
    """A ``threading.RLock`` (or its watched wrapper)."""
    return _WatchedLock(name, reentrant=True) if enabled() else threading.RLock()


# -- inspection API (the smoke gate and tests) -------------------------


def reset() -> None:
    """Drop all observed edges, nodes, and inversions (test isolation)."""
    with _REG_LOCK:
        _EDGES.clear()
        _NODES.clear()
        _INVERSIONS.clear()


def observed_graph() -> dict:
    """The observed acquisition graph, same shape as the static artifact
    from :func:`..threadlint.build_lock_graph`."""
    with _REG_LOCK:
        nodes = sorted(_NODES)
        edges = [
            {"from": a, "to": b, "count": e["count"], "site": e["site"]}
            for (a, b), e in sorted(_EDGES.items())
        ]
    return {"nodes": nodes, "edges": edges}


def inversions() -> list[dict]:
    with _REG_LOCK:
        return [dict(v) for v in _INVERSIONS]


def cycles(extra_edges: list[dict] | None = None) -> list[list[str]]:
    """Cycles in the observed graph, optionally unioned with another
    graph's edges (pass the static graph's ``edges`` list to assert the
    runtime order is consistent with the declared one)."""
    from .threadlint import graph_cycles

    graph = observed_graph()
    if extra_edges:
        seen = {(e["from"], e["to"]) for e in graph["edges"]}
        for e in extra_edges:
            key = (e["from"], e["to"])
            if key not in seen:
                seen.add(key)
                graph["edges"].append(
                    {"from": e["from"], "to": e["to"], "count": 0,
                     "site": e.get("site", "static")}
                )
    return graph_cycles(graph)


def dump_graph(path: str, static_edges: list[dict] | None = None) -> str:
    """Write the observed graph (plus inversions and the union-cycle
    verdict) as JSON: the ``lock_order_graph.json`` artifact that goes
    beside a flight recorder dump."""
    payload = dict(
        observed_graph(),
        inversions=inversions(),
        union_cycles=cycles(static_edges),
    )
    with open(path, "w", encoding="utf-8") as fh:
        json.dump(payload, fh, indent=2, sort_keys=True)
        fh.write("\n")
    return path
