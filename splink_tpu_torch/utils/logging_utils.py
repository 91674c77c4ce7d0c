"""Structured degradation records: the port's copy of splink_tpu's
``warn_degraded`` (utils/logging_utils.py), publishing its ``degradation``
event through the ambient channel of ``obs.events``."""

from __future__ import annotations

import logging
import warnings

logger = logging.getLogger("splink_tpu_torch")


def format_stage_log(stage: str, **info) -> str:
    parts = ", ".join(f"{k}={v}" for k, v in info.items())
    return f"[{stage}] {parts}"


class DegradationWarning(UserWarning):
    """An execution path changed regime on the same device (resident EM ->
    streamed EM, device pair generation -> host blocking). The job still
    completes with the same results; the warning records why."""


def warn_degraded(from_mode: str, to_mode: str, reason: str, **info) -> None:
    """One parseable log line plus a DegradationWarning (so tests and
    callers can assert on it)."""
    line = format_stage_log(
        "degrade", **{"from": from_mode, "to": to_mode, "reason": reason}, **info
    )
    logger.warning("%s", line)
    from ..obs.events import publish

    publish(
        "degradation",
        **{"from": from_mode, "to": to_mode, "reason": reason},
        **info,
    )
    warnings.warn(
        f"execution degraded from {from_mode} to {to_mode}: {reason}",
        DegradationWarning,
        stacklevel=2,
    )
