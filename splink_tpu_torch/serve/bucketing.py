"""Shape buckets: the fixed menu of batch shapes serving dispatches.

The port's copy of splink_tpu/serve/bucketing.py. The reference compiles one
XLA executable per input shape; the port compiles nothing per shape (its two
CUDA kernels are built once per process), but keeps the menu exactly: chunk
boundaries and candidate capacities decide which slots a query's candidates
take, and top-k breaks ties by slot, so the menu is part of the answer.
Serving quantises both dynamic axes to a small fixed menu of power-of-two
buckets:

  * the QUERY axis (how many records a micro-batch coalesced), and
  * the CANDIDATE axis (the padded per-query candidate capacity, driven by
    the largest blocking bucket the batch touches).

A batch pads up to the next bucket on each axis, so every dispatch takes one
of ``len(query_buckets) x len(candidate_buckets)`` shapes. The policy's
:meth:`warmup_combinations` enumerates them for the engine's warmup pass.

Buckets are configurable through the ``serve_query_buckets`` /
``serve_candidate_buckets`` settings keys (power-of-two, ascending). A
query batch larger than the largest query bucket splits into chunks; a
blocking block larger than the largest candidate bucket is truncated with
a structured degradation warning.
"""

from __future__ import annotations

from dataclasses import dataclass


def _validate_buckets(name: str, buckets) -> tuple[int, ...]:
    out = tuple(int(b) for b in buckets)
    if not out:
        raise ValueError(f"{name} must not be empty")
    for b in out:
        if b < 1 or (b & (b - 1)) != 0:
            raise ValueError(
                f"{name} entries must be powers of two >= 1, got {b}"
            )
    if list(out) != sorted(set(out)):
        raise ValueError(f"{name} must be strictly ascending, got {list(out)}")
    return out


def bucket_for(n: int, buckets: tuple[int, ...]) -> int | None:
    """The smallest bucket >= n, or None when n exceeds the largest."""
    for b in buckets:
        if n <= b:
            return b
    return None


@dataclass(frozen=True)
class BucketPolicy:
    """The serving shape menu (see module docstring)."""

    query_buckets: tuple[int, ...]
    candidate_buckets: tuple[int, ...]

    DEFAULT_QUERY_BUCKETS = (16, 128, 1024)
    DEFAULT_CANDIDATE_BUCKETS = (32, 256, 2048)

    @classmethod
    def from_settings(cls, settings: dict) -> "BucketPolicy":
        return cls(
            query_buckets=_validate_buckets(
                "serve_query_buckets",
                settings.get("serve_query_buckets")
                or cls.DEFAULT_QUERY_BUCKETS,
            ),
            candidate_buckets=_validate_buckets(
                "serve_candidate_buckets",
                settings.get("serve_candidate_buckets")
                or cls.DEFAULT_CANDIDATE_BUCKETS,
            ),
        )

    def __post_init__(self):
        _validate_buckets("serve_query_buckets", self.query_buckets)
        _validate_buckets("serve_candidate_buckets", self.candidate_buckets)

    @property
    def max_batch(self) -> int:
        """The largest query micro-batch one dispatch serves."""
        return self.query_buckets[-1]

    def query_bucket(self, n: int) -> int | None:
        return bucket_for(n, self.query_buckets)

    def candidate_bucket(self, n: int) -> int | None:
        return bucket_for(n, self.candidate_buckets)

    def iter_query_chunks(self, n: int):
        """Yield ``(q_pad, start, stop)`` chunks covering ``n`` queries:
        full largest-bucket chunks, then one bucketed tail."""
        start = 0
        biggest = self.query_buckets[-1]
        while n - start > biggest:
            yield biggest, start, start + biggest
            start += biggest
        if n - start > 0:
            yield self.query_bucket(n - start), start, n

    def warmup_combinations(self) -> list[tuple[int, int]]:
        """Every (query_bucket, candidate_bucket) shape the steady state
        can dispatch — the engine warmup runs each once."""
        return [
            (qb, cb)
            for qb in self.query_buckets
            for cb in self.candidate_buckets
        ]
