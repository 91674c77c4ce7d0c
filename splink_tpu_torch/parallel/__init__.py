"""Streamed EM on one device (parallel/streaming.py). The mesh and
multi-controller halves of splink_tpu's parallel package are not ported yet
(ROADMAP.md, Queue 1 item 7)."""

from .streaming import run_em_streamed, score_stream  # noqa: F401

__all__ = ["run_em_streamed", "score_stream"]
