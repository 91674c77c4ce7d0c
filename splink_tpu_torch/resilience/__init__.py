"""Fault tolerance for long EM runs: the port's copy of splink_tpu's
resilience package.

  * :mod:`checkpoint` — atomic on-disk EM snapshots (write-temp + fsync +
    rename), versioned and bound to a settings hash so stale checkpoints
    are rejected rather than silently loaded;
  * :mod:`retry` — bounded exponential backoff around a streamed EM pass,
    classifying PyTorch's failures (an OOM is transient, a CUDA launch
    error never is);
  * :mod:`faults` — deterministic fault injection (env/settings-driven),
    so every recovery path has a test that exercises it.

Degradation when a regime fails outright: resident EM -> streamed EM, on
the same device. Unlike the reference there is no last rung to the CPU
(no ``ensure_devices``): a run that asked for the card stays on it.
"""

from .checkpoint import (  # noqa: F401
    CheckpointError,
    CheckpointMismatchError,
    EMCheckpoint,
    EMCheckpointer,
    load_checkpoint,
    save_checkpoint,
    settings_state_hash,
)
from .faults import FaultPlan, InjectedFault, active_plan  # noqa: F401
from .retry import (  # noqa: F401
    RetryError,
    RetryPolicy,
    classify_error,
    is_oom,
    retry_call,
)

__all__ = [
    "CheckpointError",
    "CheckpointMismatchError",
    "EMCheckpoint",
    "EMCheckpointer",
    "load_checkpoint",
    "save_checkpoint",
    "settings_state_hash",
    "FaultPlan",
    "InjectedFault",
    "active_plan",
    "RetryError",
    "RetryPolicy",
    "classify_error",
    "is_oom",
    "retry_call",
]
