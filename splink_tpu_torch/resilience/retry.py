"""Retry with bounded exponential backoff, and failure classification.

The counterpart of splink_tpu/resilience/retry.py with PyTorch's own
failures classified instead of XLA's status strings:

  * ``torch.cuda.OutOfMemoryError`` is an OOM (``is_oom``): the resident
    EM path degrades to the streamed one on it, and a streamed pass is
    retried on it (the caching allocator refuses before any kernel runs,
    so the context is intact and memory may free as buffers drain);
  * a CUDA error raised from a kernel launch or a synchronisation is never
    transient: the CUDA context is sticky after it, and a retry would hide
    a broken kernel;
  * connection and timeout errors stay transient, as in the reference.

Everything else is deterministic and propagates at once. Three
consecutive byte-identical failures end the retry budget early, as in the
reference. There is no counterpart of the reference's ``ensure_devices``:
a missing or failed card never moves the run to the CPU.
"""

from __future__ import annotations

import logging
import time
from dataclasses import dataclass

import torch

logger = logging.getLogger("splink_tpu_torch")

# Connection phrasing the reference also treats as transient
TRANSIENT_MARKERS = ("Socket closed", "connection reset", "Connection reset",
                     "failed to connect")

# Text of the errors a CUDA launch or synchronisation raises; these leave
# the context unusable, so they are never retried
CUDA_ERROR_MARKERS = ("CUDA error", "CUDA kernel errors", "device-side assert",
                      "cudaError", "CUDA driver error")

TRANSIENT_TYPES = (ConnectionError, TimeoutError, BrokenPipeError)

_OOM_TYPES = tuple({getattr(torch, "OutOfMemoryError", torch.cuda.OutOfMemoryError),
                    torch.cuda.OutOfMemoryError})


class RetryError(RuntimeError):
    """Retry budget exhausted (the original failure rides as __cause__)."""


@dataclass
class RetryPolicy:
    """Bounded exponential backoff: delay_k = min(base * mult^k, max)."""

    max_retries: int = 4  # retries, i.e. up to 1 + max_retries attempts
    base_delay: float = 0.5
    max_delay: float = 30.0
    multiplier: float = 2.0
    max_identical_failures: int = 3

    def delay(self, attempt: int) -> float:
        return min(self.base_delay * self.multiplier**attempt, self.max_delay)


def _is_cuda_error(exc: BaseException) -> bool:
    accel = getattr(torch, "AcceleratorError", None)
    if accel is not None and isinstance(exc, accel):
        return True
    text = f"{type(exc).__name__}: {exc}"
    return any(m in text for m in CUDA_ERROR_MARKERS)


def is_oom(exc: BaseException) -> bool:
    """Whether an exception is a device out-of-memory condition, the
    trigger for resident -> streamed degradation (linker._run_em)."""
    from .faults import InjectedFault

    if isinstance(exc, InjectedFault):
        return exc.kind == "oom"
    return isinstance(exc, _OOM_TYPES)


def classify_error(exc: BaseException) -> str:
    """'transient' (worth retrying) or 'deterministic' (propagate now)."""
    from .faults import InjectedFault

    if isinstance(exc, InjectedFault):
        return "deterministic" if exc.kind == "kill" else "transient"
    if is_oom(exc):
        return "transient"
    if _is_cuda_error(exc):
        return "deterministic"
    if isinstance(exc, TRANSIENT_TYPES):
        return "transient"
    text = f"{type(exc).__name__}: {exc}"
    if any(m in text for m in TRANSIENT_MARKERS):
        return "transient"
    return "deterministic"


def retry_call(fn, *, policy: RetryPolicy | None = None, classify=classify_error,
               label: str = "", sleep=time.sleep, on_retry=None):
    """Call ``fn()`` with bounded-backoff retry on transient failures.

    Deterministic failures propagate immediately; so does the
    ``max_identical_failures``-th consecutive byte-identical failure
    (wrapped in RetryError so callers can tell budget exhaustion from the
    first occurrence). ``sleep`` is injectable so tests run at full speed.
    """
    policy = policy or RetryPolicy()
    last_repr = None
    identical = 0
    for attempt in range(policy.max_retries + 1):
        try:
            return fn()
        except Exception as e:  # noqa: BLE001 - classification decides
            kind = classify(e)
            this_repr = f"{type(e).__name__}: {e}"
            identical = identical + 1 if this_repr == last_repr else 1
            last_repr = this_repr
            if kind != "transient":
                raise
            if identical >= policy.max_identical_failures:
                raise RetryError(
                    f"{label or 'operation'}: {identical} consecutive "
                    f"identical failures, aborting as deterministic: {this_repr}"
                ) from e
            if attempt >= policy.max_retries:
                raise RetryError(
                    f"{label or 'operation'}: retry budget exhausted after "
                    f"{attempt + 1} attempts: {this_repr}"
                ) from e
            delay = policy.delay(attempt)
            logger.warning(
                "%s: transient failure (attempt %d/%d), retrying in %.1fs: %s",
                label or "operation", attempt + 1, policy.max_retries + 1,
                delay, this_repr,
            )
            from ..obs.events import publish

            publish("retry", label=label or "operation", attempt=attempt + 1,
                    max_attempts=policy.max_retries + 1, delay_s=delay,
                    error=this_repr[:300])
            if on_retry is not None:
                on_retry(attempt, e)
            sleep(delay)
    raise AssertionError("unreachable")  # pragma: no cover
