"""Atomic on-disk EM checkpoints: snapshot, validate, resume.

The port's copy of splink_tpu/resilience/checkpoint.py (the checkpoint
file format and the ``checkpoint`` event are the same).

The entire EM training state is tiny — lambda, the (C, L) m/u matrices,
their per-iteration histories and an iteration counter — so checkpointing
costs one small JSON write, yet turns a multi-hour run on preemptible
hardware into a sequence of resumable segments (the progressive-ER
principle: partial results survive interruption).

Durability contract:
  * writes are atomic: write to a temp file in the same directory, flush +
    fsync, then os.replace over the final name and fsync the directory —
    a reader never observes a torn checkpoint, and a crash mid-write
    leaves the previous checkpoint intact;
  * every checkpoint is versioned and bound to a ``state_hash`` of the
    settings that determine the EM computation (comparison spec, link
    type, convergence, priors). Loading with a different hash raises
    CheckpointMismatchError — a stale checkpoint is rejected, never
    silently trained on;
  * parameters round-trip losslessly: float32/float64 values pass through
    Python floats (exact for both widths), so a resumed trajectory is
    bit-identical to an uninterrupted one.
"""

from __future__ import annotations

import hashlib
import json
import logging
import os
import tempfile
from dataclasses import dataclass, field

import numpy as np

logger = logging.getLogger("splink_tpu_torch")

CHECKPOINT_VERSION = 1
CHECKPOINT_NAME = "em_checkpoint.json"

# The settings keys that determine the EM computation a checkpoint belongs
# to. Deliberately excluded: max_iterations (extending the cap is a
# legitimate reason to resume), execution knobs (batch sizes, meshes,
# cache dirs — same trajectory on any of them) and the checkpoint/fault
# keys themselves.
_HASH_KEYS = (
    "link_type",
    "comparison_columns",
    "blocking_rules",
    "em_convergence",
    "proportion_of_matches",
    "unique_id_column_name",
    "float64",
)


class CheckpointError(RuntimeError):
    """Unreadable/corrupt checkpoint."""


class CheckpointMismatchError(CheckpointError):
    """Checkpoint belongs to a different job (settings hash or format
    version disagree) — refusing to resume from it."""


def settings_state_hash(settings: dict, extra: dict | None = None) -> str:
    """Stable hash of the computation-defining settings (+ optional extra
    identity, e.g. process topology or input fingerprint)."""
    from ..params import _jsonable_settings

    payload = {k: settings.get(k) for k in _HASH_KEYS if k in settings}
    if extra:
        payload["__extra__"] = extra
    text = json.dumps(_jsonable_settings(payload), sort_keys=True)
    return hashlib.sha256(text.encode()).hexdigest()[:16]


@dataclass
class EMCheckpoint:
    """One EM training snapshot at an iteration boundary."""

    state_hash: str
    iteration: int  # completed parameter updates
    lam: float
    m: list  # (C, L) nested lists
    u: list
    histories: dict  # {"lam": [...], "m": [...], "u": [...], "ll": [...]|None}
    converged: bool = False
    process_count: int = 1
    stream_position: int = 0  # batches into the current pass (0 = boundary)
    dtype: str = "float32"
    version: int = CHECKPOINT_VERSION
    extra: dict = field(default_factory=dict)

    def params_arrays(self):
        """(lam, m, u) numpy arrays in the checkpoint's compute dtype."""
        dt = np.dtype(self.dtype)
        return (
            np.asarray(self.lam, dt),
            np.asarray(self.m, dt),
            np.asarray(self.u, dt),
        )

    def history_arrays(self):
        """Histories as numpy arrays (ll may be None; null entries —
        values the writer had not computed yet — come back as NaN)."""
        dt = np.dtype(self.dtype)
        h = self.histories
        ll = None
        if h.get("ll") is not None:
            ll = np.asarray(
                [np.nan if v is None else v for v in h["ll"]], dt
            )
        return {
            "lam": np.asarray(h["lam"], dt),
            "m": np.asarray(h["m"], dt),
            "u": np.asarray(h["u"], dt),
            "ll": ll,
        }


def checkpoint_path(directory: str | os.PathLike) -> str:
    return os.path.join(directory, CHECKPOINT_NAME)


def fsync_dir(directory: str | os.PathLike) -> None:
    """fsync a directory so a rename into it is durable. Best-effort: not
    every filesystem allows opening a directory for sync."""
    try:
        dfd = os.open(os.fspath(directory), os.O_RDONLY)
        try:
            os.fsync(dfd)
        finally:
            os.close(dfd)
    except OSError:  # pragma: no cover - not all filesystems allow it
        pass


def atomic_write_bytes(path: str | os.PathLike, data: bytes) -> str:
    """Atomically write ``data`` to ``path``: temp file in the same
    directory, flush + fsync, os.replace over the final name, fsync the
    directory. A reader never observes a torn file; a crash mid-write
    leaves any previous version intact."""
    path = os.fspath(path)
    directory = os.path.dirname(path) or "."
    fd, tmp = tempfile.mkstemp(
        prefix=os.path.basename(path) + ".", suffix=".tmp", dir=directory
    )
    try:
        with os.fdopen(fd, "wb") as f:
            f.write(data)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, path)
    except BaseException:
        try:
            os.unlink(tmp)
        except OSError:
            pass
        raise
    fsync_dir(directory)
    return path


def atomic_write_json(path: str | os.PathLike, payload: dict) -> str:
    """Atomic JSON write (see :func:`atomic_write_bytes`)."""
    return atomic_write_bytes(path, json.dumps(payload).encode())


def save_checkpoint(directory: str | os.PathLike, ckpt: EMCheckpoint) -> str:
    """Atomically persist a checkpoint; returns the final path."""
    directory = os.fspath(directory)
    os.makedirs(directory, exist_ok=True)
    final = checkpoint_path(directory)
    payload = {
        "version": ckpt.version,
        "state_hash": ckpt.state_hash,
        "iteration": int(ckpt.iteration),
        "converged": bool(ckpt.converged),
        "process_count": int(ckpt.process_count),
        "stream_position": int(ckpt.stream_position),
        "dtype": ckpt.dtype,
        "lam": float(ckpt.lam),
        "m": ckpt.m,
        "u": ckpt.u,
        "histories": ckpt.histories,
        "extra": ckpt.extra,
    }
    atomic_write_json(final, payload)
    logger.debug(
        "checkpoint saved: %s (iteration %d)", final, ckpt.iteration
    )
    from ..obs.events import publish

    publish("checkpoint", path=final, iteration=int(ckpt.iteration),
            converged=bool(ckpt.converged))
    return final


def load_checkpoint(
    directory: str | os.PathLike, expect_hash: str | None = None
) -> EMCheckpoint | None:
    """Load the checkpoint in ``directory``; None when absent.

    Raises CheckpointMismatchError when the format version or the settings
    hash disagrees with this job — the caller must not train from it —
    and CheckpointError when the file exists but cannot be parsed.
    """
    path = checkpoint_path(directory)
    if not os.path.exists(path):
        return None
    try:
        with open(path) as f:
            d = json.load(f)
    except (OSError, json.JSONDecodeError) as e:
        raise CheckpointError(f"unreadable checkpoint at {path}: {e}") from e
    version = d.get("version")
    if version != CHECKPOINT_VERSION:
        raise CheckpointMismatchError(
            f"checkpoint at {path} has format version {version!r}; this "
            f"build reads version {CHECKPOINT_VERSION}. Delete it (or train "
            "fresh with resume=False) to proceed."
        )
    if expect_hash is not None and d.get("state_hash") != expect_hash:
        raise CheckpointMismatchError(
            f"checkpoint at {path} was written for a different job "
            f"(settings hash {d.get('state_hash')!r}, this job "
            f"{expect_hash!r}). Refusing to resume from it: point "
            "checkpoint_dir at a fresh directory or delete the stale "
            "checkpoint."
        )
    return EMCheckpoint(
        state_hash=d["state_hash"],
        iteration=d["iteration"],
        lam=d["lam"],
        m=d["m"],
        u=d["u"],
        histories=d["histories"],
        converged=d["converged"],
        process_count=d.get("process_count", 1),
        stream_position=d.get("stream_position", 0),
        dtype=d.get("dtype", "float32"),
        version=version,
        extra=d.get("extra", {}),
    )


class EMCheckpointer:
    """Per-iteration checkpoint hook for the streamed EM driver.

    ``run_em_streamed`` exposes training progress through its
    ``on_iteration`` callback but keeps histories in its own locals, so
    this hook accumulates its own copies (lam/m/u/ll per iteration) and
    writes an atomic checkpoint every ``interval`` updates and on
    convergence. Under multi-controller runs only process 0 writes
    (``write=False`` elsewhere) while every process accumulates, keeping
    the hook cheap and the directory single-writer.
    """

    def __init__(
        self,
        directory: str | os.PathLike,
        state_hash: str,
        *,
        interval: int = 5,
        process_count: int = 1,
        write: bool = True,
        dtype: str = "float32",
    ):
        self.directory = os.fspath(directory)
        self.state_hash = state_hash
        self.interval = max(int(interval), 1)
        self.process_count = process_count
        self.write = write
        self.dtype = dtype
        self._lam: list = []
        self._m: list = []
        self._u: list = []
        self._ll: list = []
        self._have_ll = False
        self._iteration = 0
        self._converged = False

    def start(self, init_params, from_checkpoint: EMCheckpoint | None = None):
        """Seed histories: from a loaded checkpoint on resume, else from
        the initial parameters (history index 0 = pre-update state)."""
        if from_checkpoint is not None:
            h = from_checkpoint.histories
            self._lam = list(h["lam"])
            self._m = [np.asarray(x).tolist() for x in h["m"]]
            self._u = [np.asarray(x).tolist() for x in h["u"]]
            # fused-path checkpoints persist the boundary's own (not yet
            # computed) ll as a trailing null; appending the next streamed
            # ll after it would shift every later entry one iteration late
            ll = list(h["ll"]) if h.get("ll") else []
            while ll and ll[-1] is None:
                ll.pop()
            self._ll = ll
            self._have_ll = bool(ll)
            self._iteration = from_checkpoint.iteration
            self._converged = from_checkpoint.converged
            self.dtype = from_checkpoint.dtype
        else:
            self._lam = [float(init_params.lam)]
            self._m = [np.asarray(init_params.m).tolist()]
            self._u = [np.asarray(init_params.u).tolist()]
        return self

    def on_iteration(self, it: int, params, ll=None, converged: bool = False):
        """Record one completed update; write every ``interval`` updates."""
        self._iteration = it
        self._lam.append(float(params.lam))
        self._m.append(np.asarray(params.m).tolist())
        self._u.append(np.asarray(params.u).tolist())
        if ll is not None:
            self._ll.append(float(ll))
            self._have_ll = True
        self._converged = converged
        if converged or it % self.interval == 0:
            self.save()

    def finish(self, converged: bool) -> str | None:
        """Record the run's final convergence flag and write the last
        checkpoint (the streamed driver's post-loop call — the interval
        gating in on_iteration can miss the final update)."""
        self._converged = bool(converged)
        return self.save()

    def save(self) -> str | None:
        if not self.write:
            return None
        return save_checkpoint(
            self.directory,
            EMCheckpoint(
                state_hash=self.state_hash,
                iteration=self._iteration,
                lam=self._lam[-1],
                m=self._m[-1],
                u=self._u[-1],
                histories={
                    "lam": self._lam,
                    "m": self._m,
                    "u": self._u,
                    "ll": self._ll if self._have_ll else None,
                },
                converged=self._converged,
                process_count=self.process_count,
                dtype=self.dtype,
            ),
        )
