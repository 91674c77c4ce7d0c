"""AOT library sidecar: a replica's cold start without a compiler.

The port's counterpart of splink_tpu/serve/aot.py. The reference
serializes one XLA executable per (query bucket, candidate bucket) shape.
The port compiles nothing per shape: its only machine code built at run
time is its libraries, each built once per process and source hash,

  * ``libsplink_jaro_winkler-<digest>.so`` and
    ``libsplink_levenshtein-<digest>.so`` (``ops.strings_cuda.build``,
    nvcc; a CUDA engine only), and
  * ``libsplink_host-<digest>.so`` (``native.build``, g++; every engine,
    for the query encode).

So the port's sidecar stores those libraries as its blobs. After
:meth:`~.engine.QueryEngine.warmup`, ``save_aot`` writes them beside the
index artifact; a fresh process whose build directory is empty (and which
may have no compiler at all) restores them in ``warmup`` before its first
kernel launch and its first query encode, and every ``build()`` then finds
its library on disk and runs no compiler.

The layout and guarantees are the reference's:

  * blob files land first under names derived from their sha256, then
    ``aot_menu.json`` commits the set atomically (``version``,
    ``environment``, ``binding`` and per-blob ``sha256`` and ``bytes``),
    then superseded blobs are swept;
  * :meth:`AotStore.validate` checks the environment
    (:func:`..utils.envfp.environment_fingerprint`: torch, the CPU target,
    the libraries' keys and, on a card, its name, capability and libcuda)
    and the engine binding, and names every mismatched key in ONE
    ``serve_aot`` degradation event; a store that fails is not used and
    the libraries build from sources as in any cold start;
  * a blob is never loaded before its sha256 has been verified against the
    committed menu (``dlopen`` of unverified bytes is code execution, as
    the reference's pickle load is): :meth:`AotStore.restore` reads the
    bytes, checks them, and only then writes THOSE bytes where the build
    looks. A missing or corrupt blob emits one ``corrupt_blob`` event and
    leaves that one library to the ordinary build from its sources
    (``csrc/`` or ``native/src/``).

A process whose library is already loaded, or already on disk under its
key, has nothing to restore for it: restore never replaces a library.
"""

from __future__ import annotations

import hashlib
import json
import logging
import os

from ..resilience.checkpoint import atomic_write_bytes, atomic_write_json
from ..utils.logging_utils import warn_degraded

logger = logging.getLogger("splink_tpu_torch")

AOT_FORMAT_VERSION = 1
MENU_NAME = "aot_menu.json"
BLOB_PREFIX = "lib-"


class AotStoreError(RuntimeError):
    """Unreadable / unwritable AOT sidecar."""


def _blob_file(name: str, digest: str) -> str:
    return f"{BLOB_PREFIX}{name}-{digest[:16]}.so"


def libraries(device) -> dict[str, str]:
    """{name: path where the build looks} of the libraries an engine on
    ``device`` loads: ``host`` always, the CUDA kernels on a card."""
    import torch

    from .. import native

    out = {"host": native.library_path()}
    if torch.device(device).type == "cuda":
        from ..ops import strings_cuda

        out.update({k: strings_cuda.library_path(k) for k in strings_cuda.KERNELS})
    return out


def build_libraries(device) -> dict[str, str]:
    """Build (where not on disk already) every library of :func:`libraries`
    and return the same mapping: what ``save_aot`` stores."""
    import torch

    from .. import native

    native.build()
    if torch.device(device).type == "cuda":
        from ..ops import strings_cuda

        strings_cuda.build()
    return libraries(device)


def _loaded(name: str) -> bool:
    """Whether this process has loaded library ``name`` already."""
    if name == "host":
        from .. import native

        return native._lib is not None
    from ..ops import strings_cuda

    return name in strings_cuda._libs


class AotStore:
    """One AOT sidecar directory (read side; :meth:`write` produces it)."""

    def __init__(self, directory: str | os.PathLike):
        self.directory = os.fspath(directory)
        self._entries: dict[str, dict] | None = None

    # -- read -----------------------------------------------------------

    def validate(self, binding: dict, device=None) -> bool:
        """Load the menu and check it against ``binding`` (the engine
        identity) and the CURRENT environment for ``device``. False (with
        exactly one degradation event naming every mismatched key) means
        the store must not be used."""
        from ..utils.envfp import environment_fingerprint

        menu_path = os.path.join(self.directory, MENU_NAME)
        try:
            with open(menu_path, encoding="utf-8") as fh:
                menu = json.load(fh)
            if not isinstance(menu, dict):
                raise ValueError("the menu is not a JSON object")
        except FileNotFoundError:
            return False  # no sidecar: a plain cold start, not degraded
        except (OSError, ValueError) as e:
            warn_degraded(
                "serve_aot", "unreadable",
                f"AOT sidecar meta at {menu_path} is unreadable ({e}); "
                "building the libraries from sources",
            )
            return False
        mismatches = []
        if menu.get("version") != AOT_FORMAT_VERSION:
            mismatches.append(
                f"format version {menu.get('version')!r} != {AOT_FORMAT_VERSION}"
            )
        saved_env = menu.get("environment") or {}
        for key, want in environment_fingerprint(device).items():
            got = saved_env.get(key)
            if got != want:
                mismatches.append(f"environment.{key} {got!r} != current {want!r}")
        saved_binding = menu.get("binding") or {}
        for key, want in binding.items():
            got = saved_binding.get(key)
            if got != want:
                mismatches.append(f"binding.{key} {got!r} != {want!r}")
        if mismatches:
            warn_degraded(
                "serve_aot", "stale",
                "AOT sidecar invalidated (building from sources instead): "
                + "; ".join(mismatches),
                sidecar=self.directory,
            )
            return False
        self._entries = dict(menu.get("libraries") or {})
        return True

    @property
    def names(self) -> list[str]:
        """The menu's library names, sorted (empty before :meth:`validate`
        accepts the store)."""
        return sorted(self._entries or {})

    def restore(self, name: str, dest: str) -> bool:
        """Write library ``name``'s blob to ``dest`` once its sha256 matches
        the committed menu; True when it was written. False when the menu
        has no such entry or the blob is missing or corrupt (one
        degradation event each: the library then builds from sources)."""
        entry = (self._entries or {}).get(name)
        if entry is None:
            return False
        path = os.path.join(self.directory, entry["file"])
        try:
            with open(path, "rb") as fh:
                blob = fh.read()
        except OSError as e:
            warn_degraded(
                "serve_aot", "corrupt_blob",
                f"AOT library {name!r} unreadable at {path} ({e}); building "
                "it from sources",
            )
            return False
        if hashlib.sha256(blob).hexdigest() != entry.get("sha256"):
            warn_degraded(
                "serve_aot", "corrupt_blob",
                f"AOT library {name!r} at {path} does not match its committed "
                "fingerprint (torn write or tampering); building it from "
                "sources",
            )
            return False
        os.makedirs(os.path.dirname(dest), exist_ok=True)
        atomic_write_bytes(dest, blob)
        return True

    def restore_all(self, device) -> int:
        """Restore every library an engine on ``device`` loads that is
        neither loaded in this process nor on disk under its key; returns
        how many were written."""
        from ..obs.metrics import note_aot_restore

        restored = 0
        for name, dest in libraries(device).items():
            if _loaded(name) or os.path.exists(dest):
                continue
            if self.restore(name, dest):
                restored += 1
        if restored:
            note_aot_restore(restored)
            logger.info("AOT sidecar %s: %d librar%s restored", self.directory,
                        restored, "y" if restored == 1 else "ies")
        return restored

    # -- write ----------------------------------------------------------

    @classmethod
    def write(cls, directory: str | os.PathLike, binding: dict,
              library_paths: dict[str, str], device=None) -> str:
        """Persist ``library_paths`` (name -> built library) as a sidecar at
        ``directory``: blobs first under fingerprint-derived names, then
        the menu JSON as the atomic commit point, then a best-effort sweep
        of superseded blobs. Returns the menu path."""
        from ..utils.envfp import environment_fingerprint, toolchain_fingerprint

        directory = os.fspath(directory)
        os.makedirs(directory, exist_ok=True)
        entries: dict[str, dict] = {}
        keep: set[str] = set()
        for name in sorted(library_paths):
            with open(library_paths[name], "rb") as fh:
                blob = fh.read()
            digest = hashlib.sha256(blob).hexdigest()
            fname = _blob_file(name, digest)
            atomic_write_bytes(os.path.join(directory, fname), blob)
            entries[name] = {
                "file": fname,
                "sha256": digest,
                "bytes": len(blob),
                "library": os.path.basename(library_paths[name]),
            }
            keep.add(fname)
        menu = {
            "version": AOT_FORMAT_VERSION,
            "environment": environment_fingerprint(device),
            "toolchain": toolchain_fingerprint(device),
            "binding": binding,
            "libraries": entries,
        }
        path = atomic_write_json(os.path.join(directory, MENU_NAME), menu)
        try:  # post-commit sweep (a leftover costs disk, never correctness)
            for fname in os.listdir(directory):
                if fname.startswith(BLOB_PREFIX) and fname not in keep:
                    os.unlink(os.path.join(directory, fname))
        except OSError:  # pragma: no cover - sweep is best-effort
            pass
        logger.info(
            "AOT sidecar committed: %s (%d libraries, %d bytes)", directory,
            len(entries), sum(e["bytes"] for e in entries.values()),
        )
        return path
