"""The lock factory of the serve and obs modules.

The port's copy of the factory half of splink_tpu/analysis/lockwatch.py:
every serve and obs lock is created through :func:`new_lock` /
:func:`new_rlock` under a ``Class._attr`` name, as in the reference. The
reference's instrumented (watched) locks belong to its concurrency audit,
which the port does not carry yet (ROADMAP Queue 1 item 12b-3), so these
return the plain ``threading`` primitives.
"""

from __future__ import annotations

import threading


def new_lock(name: str):
    """A ``threading.Lock``; ``name`` is ``Class._attr`` of its owner."""
    del name
    return threading.Lock()


def new_rlock(name: str):
    """A ``threading.RLock``; ``name`` is ``Class._attr`` of its owner."""
    del name
    return threading.RLock()
