"""Out-of-core pair spill store: segment-committed, manifest-bound, resumable.

The port's copy of splink_tpu/spill.py. The version, the manifest name and
the bin format are the reference's, so either package attaches a store the
other wrote. It is the storage layer under the sharded emission driver
(blocking_device.emit_pairs_sharded), the ``build_spill_dir`` write path
for jobs whose pairs do not fit in host RAM:

  * pairs append to two flat binary files (``idx_l.bin`` / ``idx_r.bin``,
    the ``_PairSink`` memmap format), in fixed (rule, shard, sequence)
    segment order;
  * every segment commits through ``pair_manifest.json`` — written with the
    same atomic machinery as the EM checkpoints (temp file + fsync +
    os.replace + directory fsync, resilience/checkpoint.py), recording the
    segment's pair count, byte offset, rule/shard identity, a sha256 over
    its bytes and the device-side transfer digest where the emission
    computed one;
  * a killed build resumes from the last committed segment: ``attach``
    truncates any torn (uncommitted) tail off the bins and the driver skips
    committed segments, so the byte stream a resumed build produces is
    IDENTICAL to an uninterrupted run's;
  * the manifest binds to a state hash (settings + input fingerprint) and
    the emission-plan shape, so a stale store from a different job is
    refused, never silently extended.

The finished store memmaps as one ordinary :class:`~.blocking.PairIndex`
(downstream scoring is unchanged), and the streamed EM can consume the
manifest directly — segment by segment, gammas computed per chunk on the
device, nothing per-pair ever resident on the host
(linker._run_em_streamed_spill).
"""

from __future__ import annotations

import hashlib
import json
import logging
import os
from dataclasses import dataclass

import numpy as np

from .resilience.checkpoint import atomic_write_json, fsync_dir

logger = logging.getLogger("splink_tpu_torch")

SPILL_VERSION = 1
MANIFEST_NAME = "pair_manifest.json"
_BIN_NAMES = ("idx_l.bin", "idx_r.bin")

# FNV/murmur-style mixing constants shared by the device digest
# (blocking_device.chunk_digest) and the host mirror below — the two MUST
# agree lane for lane or every transfer check fails.
DIGEST_MUL = 2654435761  # Knuth multiplicative hash constant (2^32 / phi)
DIGEST_ADD = 2246822519  # xxhash PRIME32_2


class SpillError(RuntimeError):
    """Unusable spill store (wrong job, wrong version, unreadable)."""


class SpillCorruptionError(SpillError):
    """A committed segment's bytes no longer match its manifest record."""


def chunk_digest_host(i: np.ndarray, j: np.ndarray) -> int:
    """Order-independent uint32 digest over a pair chunk — the host mirror
    of the device digest (blocking_device.chunk_digest: sum of per-lane
    mixes, wraparound). Computed over the bytes actually written to disk,
    it closes the loop on the device-side value: a mismatch means the pairs
    were corrupted between device memory and the host buffer — BEFORE they
    poison a multi-hour build."""
    if len(i) == 0:
        return 0
    with np.errstate(over="ignore"):
        mixed = (i.astype(np.uint32) * np.uint32(DIGEST_MUL)) ^ (
            j.astype(np.uint32) + np.uint32(DIGEST_ADD)
        )
        mixed = mixed ^ (mixed >> np.uint32(15))
        return int(np.sum(mixed, dtype=np.uint32))


def _segment_sha(i: np.ndarray, j: np.ndarray) -> str:
    h = hashlib.sha256()
    h.update(np.ascontiguousarray(i).tobytes())
    h.update(np.ascontiguousarray(j).tobytes())
    return h.hexdigest()


@dataclass
class SpillSegment:
    """One committed emission segment (a contiguous pair range)."""

    rule: int
    shard: int
    seq: int
    offset: int  # element offset into the bins
    pairs: int
    sha256: str
    digest: int | None = None  # device-side transfer digest (uint32)

    def to_json(self) -> dict:
        d = {
            "rule": self.rule,
            "shard": self.shard,
            "seq": self.seq,
            "offset": self.offset,
            "pairs": self.pairs,
            "sha256": self.sha256,
        }
        if self.digest is not None:
            d["digest"] = self.digest
        return d

    @classmethod
    def from_json(cls, d: dict) -> "SpillSegment":
        return cls(
            rule=int(d["rule"]),
            shard=int(d["shard"]),
            seq=int(d["seq"]),
            offset=int(d["offset"]),
            pairs=int(d["pairs"]),
            sha256=d["sha256"],
            digest=d.get("digest"),
        )


class PairSpillStore:
    """A durable, resumable pair spill directory (module docstring).

    Unlike the transient ``_PairSink`` spill (deleted when its PairIndex is
    garbage-collected), a store is OWNED BY THE CALLER: it survives the
    process, is the unit of crash recovery, and is deleted only explicitly.
    Use as a context manager — an exception mid-emission truncates the
    uncommitted tail (segments on disk but not in the manifest) instead of
    leaving torn bytes for the next attach to re-discover.
    """

    def __init__(self, directory: str, idx_dtype, meta: dict,
                 segments: list[SpillSegment], completed: bool):
        self.directory = directory
        self.idx_dtype = np.dtype(idx_dtype)
        self.meta = meta
        self.segments = segments
        self.completed = completed
        self._done = {(s.rule, s.shard, s.seq): s for s in segments}
        self._files: list | None = None
        self._maps: list[np.ndarray] = []

    # ------------------------------------------------------------------
    # Construction / resume
    # ------------------------------------------------------------------

    @classmethod
    def attach(cls, directory: str | os.PathLike, idx_dtype,
               meta: dict | None = None) -> "PairSpillStore":
        """Open-or-create the store at ``directory``.

        With an existing manifest the store RESUMES: the manifest must bind
        to the same ``meta`` (state hash + plan shape — a store written for
        a different job/plan raises :class:`SpillError` rather than being
        silently extended), and any bytes past the last committed segment
        (a torn tail from a kill mid-segment) are truncated away so the
        next emitted segment lands exactly where an uninterrupted run would
        have put it.
        """
        directory = os.fspath(directory)
        os.makedirs(directory, exist_ok=True)
        manifest_path = os.path.join(directory, MANIFEST_NAME)
        idx_dtype = np.dtype(idx_dtype)
        if os.path.exists(manifest_path):
            try:
                with open(manifest_path, encoding="utf-8") as fh:
                    m = json.load(fh)
            except (OSError, json.JSONDecodeError) as e:
                raise SpillError(
                    f"unreadable spill manifest at {manifest_path}: {e}"
                ) from e
            if m.get("version") != SPILL_VERSION:
                raise SpillError(
                    f"spill store at {directory} has format version "
                    f"{m.get('version')!r}; this build reads {SPILL_VERSION}"
                )
            if np.dtype(m.get("dtype", "int32")) != idx_dtype:
                raise SpillError(
                    f"spill store at {directory} holds {m.get('dtype')!r} "
                    f"indices; this job needs {idx_dtype.name}"
                )
            if meta is not None:
                # compare only the caller's binding keys: finalize() may
                # have merged extra bookkeeping (e.g. exhausted) into the
                # stored meta, which must not break an idempotent re-attach
                stored = m.get("meta") or {}
                want = _jsonable_meta(meta)
                if any(stored.get(k) != v for k, v in want.items()):
                    raise SpillError(
                        f"spill store at {directory} was written for a "
                        "different job or emission plan (meta mismatch); "
                        "point build_spill_dir at a fresh directory or "
                        "delete it"
                    )
            segments = [SpillSegment.from_json(d) for d in m.get("segments", [])]
            store = cls(
                directory, idx_dtype, m.get("meta") or {}, segments,
                bool(m.get("completed")),
            )
            store._truncate_to_watermark()
            if segments:
                logger.info(
                    "spill store resumed at %s: %d committed segments, "
                    "%d pairs", directory, len(segments), store.total_pairs,
                )
            return store
        store = cls(directory, idx_dtype, _jsonable_meta(meta or {}), [], False)
        # fresh bins (a manifest-less directory holds nothing committed)
        for name in _BIN_NAMES:
            with open(os.path.join(directory, name), "wb"):
                pass
        store._write_manifest()
        return store

    def _truncate_to_watermark(self) -> None:
        want = self.total_pairs * self.idx_dtype.itemsize
        for name in _BIN_NAMES:
            path = os.path.join(self.directory, name)
            try:
                have = os.path.getsize(path)
            except OSError as e:
                raise SpillCorruptionError(
                    f"spill store at {self.directory} is missing {name}: {e}"
                ) from e
            if have < want:
                raise SpillCorruptionError(
                    f"spill bin {path} holds {have} bytes but the manifest "
                    f"commits {want}; the store is corrupt — delete it and "
                    "rebuild"
                )
            if have > want:
                logger.info(
                    "spill store %s: truncating %d torn bytes off %s "
                    "(uncommitted tail of an interrupted segment)",
                    self.directory, have - want, name,
                )
                with open(path, "r+b") as fh:
                    fh.truncate(want)
                    fh.flush()
                    os.fsync(fh.fileno())

    # ------------------------------------------------------------------
    # Introspection
    # ------------------------------------------------------------------

    @property
    def total_pairs(self) -> int:
        if not self.segments:
            return 0
        last = self.segments[-1]
        return last.offset + last.pairs

    def segment_done(self, rule: int, shard: int, seq: int) -> bool:
        return (rule, shard, seq) in self._done

    def segment_pairs(self, rule: int, shard: int, seq: int) -> int:
        return self._done[(rule, shard, seq)].pairs

    # ------------------------------------------------------------------
    # Writing
    # ------------------------------------------------------------------

    def _open_files(self):
        if self._files is None:
            self._files = [
                open(os.path.join(self.directory, name), "ab")
                for name in _BIN_NAMES
            ]
        return self._files

    def write_segment(self, rule: int, shard: int, seq: int,
                      i: np.ndarray, j: np.ndarray,
                      digest: int | None = None,
                      fault_hook=None) -> SpillSegment:
        """Append one segment and commit it to the manifest.

        Bytes land (flush + fsync) BEFORE the manifest rewrite — the
        manifest is the only commit point, so a crash anywhere in between
        leaves a torn tail the next attach truncates, never a committed
        segment without its bytes. ``fault_hook`` (a zero-arg callable)
        fires between the byte append and the manifest commit: it is the
        deterministic injection point the kill-and-resume tests aim at the
        widest vulnerable window.
        """
        if self.completed:
            raise SpillError(
                f"spill store at {self.directory} is finalized; refusing to "
                "append"
            )
        if self.segment_done(rule, shard, seq):
            raise SpillError(
                f"segment (rule={rule}, shard={shard}, seq={seq}) is "
                "already committed"
            )
        i = np.ascontiguousarray(i, dtype=self.idx_dtype)
        j = np.ascontiguousarray(j, dtype=self.idx_dtype)
        if len(i) != len(j):
            raise ValueError("idx_l / idx_r length mismatch")
        if digest is not None:
            host = chunk_digest_host(i, j)
            if host != int(digest) & 0xFFFFFFFF:
                raise SpillCorruptionError(
                    f"device transfer digest mismatch on segment (rule="
                    f"{rule}, shard={shard}, seq={seq}): device "
                    f"{int(digest) & 0xFFFFFFFF:#010x} vs host {host:#010x}"
                    " — the copy off the device corrupted the chunk"
                )
        fl, fr = self._open_files()
        i.tofile(fl)
        j.tofile(fr)
        for fh in (fl, fr):
            fh.flush()
            os.fsync(fh.fileno())
        seg = SpillSegment(
            rule=rule, shard=shard, seq=seq, offset=self.total_pairs,
            pairs=len(i), sha256=_segment_sha(i, j),
            digest=None if digest is None else int(digest) & 0xFFFFFFFF,
        )
        if fault_hook is not None:
            fault_hook()
        self.segments.append(seg)
        self._done[(seg.rule, seg.shard, seg.seq)] = seg
        self._write_manifest()
        return seg

    def abort_uncommitted(self) -> None:
        """Drop any appended-but-uncommitted bytes (exception mid-segment):
        close the append handles FIRST (Windows cannot truncate an open
        file through a second handle), then truncate to the committed
        watermark."""
        self._close_files()
        self._truncate_to_watermark()

    def finalize(self, **extra) -> None:
        """Mark the store complete (one more atomic manifest write). A
        consumer requiring a FINISHED pair set (the streamed EM, the index
        build) checks ``completed`` and refuses a half-emitted store."""
        self.completed = True
        self.meta = dict(self.meta)
        self.meta.update(_jsonable_meta(extra))
        self._write_manifest()
        self._close_files()

    def _write_manifest(self) -> None:
        atomic_write_json(
            os.path.join(self.directory, MANIFEST_NAME),
            {
                "version": SPILL_VERSION,
                "dtype": self.idx_dtype.name,
                "completed": self.completed,
                "meta": self.meta,
                "total_pairs": self.total_pairs,
                "segments": [s.to_json() for s in self.segments],
            },
        )
        fsync_dir(self.directory)

    def _close_files(self) -> None:
        if self._files is not None:
            for fh in self._files:
                try:
                    fh.close()
                except OSError:
                    pass
            self._files = None

    def __enter__(self) -> "PairSpillStore":
        return self

    def __exit__(self, exc_type, exc, tb) -> None:
        if exc_type is not None:
            self.abort_uncommitted()
        else:
            self._close_files()

    # ------------------------------------------------------------------
    # Reading
    # ------------------------------------------------------------------

    def _map(self, name: str) -> np.ndarray:
        n = self.total_pairs
        if n == 0:
            return np.zeros(0, self.idx_dtype)
        arr = np.memmap(
            os.path.join(self.directory, name),
            dtype=self.idx_dtype, mode="r", shape=(n,),
        )
        self._maps.append(arr)
        return arr

    def open_arrays(self) -> tuple[np.ndarray, np.ndarray]:
        """(idx_l, idx_r) read-only memmaps over the committed range.

        Memoised per committed length: the spill-fed EM calls this once
        per PASS (run_em_streamed re-invokes its batch factory every
        iteration), and re-mapping two multi-GB bins per iteration would
        accumulate hundreds of live mappings over a long training run."""
        cached = self._maps
        if len(cached) >= 2 and len(cached[-2]) == self.total_pairs:
            return cached[-2], cached[-1]
        return self._map(_BIN_NAMES[0]), self._map(_BIN_NAMES[1])

    def as_pair_index(self):
        """The committed pair set as an ordinary PairIndex (memmap-backed,
        NO deletion finalizer — the store is durable and caller-owned,
        unlike the transient ``_PairSink`` spill)."""
        from .blocking import PairIndex

        il, ir = self.open_arrays()
        out = PairIndex(il, ir)
        out.spill_store = self
        return out

    def iter_segments(self):
        """Yield ``(SpillSegment, idx_l, idx_r)`` per committed segment —
        the manifest-order stream the spill-fed EM and the verifier walk."""
        il, ir = self.open_arrays()
        for seg in self.segments:
            sl = slice(seg.offset, seg.offset + seg.pairs)
            yield seg, il[sl], ir[sl]

    def verify(self) -> None:
        """Recompute every committed segment's sha256 against the manifest;
        raises :class:`SpillCorruptionError` on the first mismatch. One
        sequential read of the bins — run it before trusting a store that
        crossed storage systems. Deliberately does NOT release the maps:
        open_arrays memoises them, so a PairIndex handed out earlier reads
        the same objects, and closing a map under a live numpy view does
        not fail — it makes the next access segfault."""
        for seg, i, j in self.iter_segments():
            got = _segment_sha(i, j)
            if got != seg.sha256:
                raise SpillCorruptionError(
                    f"segment (rule={seg.rule}, shard={seg.shard}, "
                    f"seq={seg.seq}) of {self.directory} fails its "
                    "manifest sha256 — the bins were corrupted on disk"
                )

    def release_maps(self) -> None:
        """Close every memmap handed out by this store (Windows-safe
        ordering: maps must be released BEFORE any unlink of the bins).

        EXPLICIT end-of-life only: mmap.close() succeeds even while numpy
        views are alive, and any later access through such a view is a
        hard crash — callers invoke this exactly when they are done with
        every array the store handed out (PairIndex.release, close)."""
        maps, self._maps = self._maps, []
        for arr in maps:
            mm = getattr(arr, "_mmap", None)
            if mm is not None:
                try:
                    mm.close()
                except (BufferError, OSError):
                    pass  # some mmap implementations do refuse live views

    def close(self) -> None:
        self._close_files()
        self.release_maps()


def _jsonable_meta(meta: dict) -> dict:
    """Round-trip ``meta`` through JSON so attach-time equality compares
    what the manifest actually stores (tuples become lists, numpy ints
    become ints)."""
    return json.loads(json.dumps(meta, sort_keys=True, default=_np_scalar))


def _np_scalar(v):
    if isinstance(v, (np.integer,)):
        return int(v)
    if isinstance(v, (np.floating,)):
        return float(v)
    raise TypeError(f"unserialisable meta value {v!r}")


def iter_spill_gamma_batches(store: PairSpillStore, program, batch_size: int,
                             pair_range: slice | None = None):
    """One pass of gamma micro-batches over a committed spill store — what
    ``run_em_streamed``'s batch factory calls every EM iteration.

    The pair index arrays stay memmapped; each ``batch_size`` slice is read
    once, its gamma block computed on the device
    (:meth:`~.gammas.GammaProgram.iter_gamma_chunks`) and yielded — the
    gamma matrix NEVER materialises on the host, which is the point: at
    billions of pairs even the int8 G is tens of GB. ``pair_range``
    restricts the pass to a global slice (multi-process runs pass
    ``distributed.global_pair_slice`` so each process streams only its own
    share of the manifest). Batch boundaries are identical to the
    materialised streamed path's, so the EM trajectory is bit-identical to
    a run that could afford the resident G.
    """
    if not store.completed:
        raise SpillError(
            f"spill store at {store.directory} is not finalized; refusing "
            "to train on a half-emitted pair set"
        )
    il, ir = store.open_arrays()
    lo, hi = 0, store.total_pairs
    if pair_range is not None:
        lo, hi = pair_range.start, pair_range.stop
    if hi <= lo:
        return
    yield from program.iter_gamma_chunks(il[lo:hi], ir[lo:hi], batch_size=batch_size)
