"""Host-side utilities of splink_tpu_torch."""

from .logging_utils import format_stage_log
from .profiling import StageTimer, stage_timings

__all__ = ["format_stage_log", "StageTimer", "stage_timings"]
