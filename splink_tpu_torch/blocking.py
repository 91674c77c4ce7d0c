"""Candidate-pair generation (blocking) — host-side hash joins.

The reference implements blocking as Spark SQL inner joins, one per rule,
UNION ALLed with each rule ANDed against NOT(any previous rule)
(splink/blocking.py:95-160). Blocking stays on the host — it is an
irregular, data-dependent join — and produces *pair index arrays* into the
encoded table; the quadratic pair data itself never materialises on the host
beyond two int arrays, and device gathers do the rest.

This is the host join of splink_tpu/blocking.py, and the dispatch to its
device sort-join tier (blocking_device.py): ``device_blocking: "on"``
takes the device tier on any device, the CPU included; ``"auto"`` takes it
on the card once the exact rules' pair bound reaches
``blocking_device.AUTO_MIN_PAIRS`` and keeps the host join on the CPU; a
rule shape the device plan rejects falls back to the host join with a
logged reason. ``tiers`` counts which tier served each exact pass.
``approx_blocking`` appends the approximate tier (approx/) after the exact
rules, on the same device.

Pair-set semantics are preserved exactly:
  * equality-conjunction rules (``l.a = r.a AND l.b = r.b``) become hash
    joins on combined key codes; rows with a null key never match (SQL
    equality semantics),
  * function-of-column equalities (``substr(l.surname,1,3) =
    substr(r.surname,1,3)``, a dmetaphone key) hash-join on host-derived
    key columns (splink_tpu/derived_keys.py), and cross-column /
    cross-expression equalities (``l.a = r.b``) hash-join through per-side
    code arrays over a shared vocabulary — the reference ran all of these
    as ordinary Spark joins (splink/blocking.py:141-158),
  * each rule's pairs exclude pairs produced by ANY earlier rule. The
    reference expresses this as ``AND NOT ifnull(previous_rule, false)``
    (splink/blocking.py:59-68) and that is literally what
    runs here: earlier rules' predicates (join-key equality + residual) are
    evaluated on each new rule's candidates, with a null/UNKNOWN outcome
    counting as not-produced (the ifnull). No accumulated pair set is kept,
  * link types order/orient pairs like the reference
    (splink/blocking.py:133-139): dedupe_only keeps
    ``uid_l < uid_r``; link_only crosses the two tables with the left input
    on the l side; link_and_dedupe orders by (source_table, uid),
  * empty rules -> cartesian join (with the documented quadratic warning).

Rules that are not pure equality conjunctions keep their equality part as the
join key and evaluate the residual predicate on the joined candidates (or,
with no equality part at all, against cartesian chunks).
"""

from __future__ import annotations

import logging
import warnings
from dataclasses import dataclass

import numpy as np

from . import native
from .check_types import check_types
from .compat_sql import parse_blocking_rule
from .data import EncodedTable
from .native import _ranges

logger = logging.getLogger("splink_tpu_torch")

_CARTESIAN_CHUNK = 1 << 22

# Calls of block_using_rules by the tier that served them: "device" (the
# sort-join tier of blocking_device.py) or "host" (the joins below).
tiers = {"device": 0, "host": 0}


@dataclass
class PairIndex:
    """Candidate pairs as row indices into one EncodedTable.

    Indices are int32 whenever the table allows (n_rows < 2^31 — i.e.
    always, in practice): at billions of candidate pairs the narrow dtype
    halves both the resident footprint and the spill size. The int64 path
    survives behind the ``_idx_dtype`` size check only."""

    idx_l: np.ndarray  # (n_pairs,) int32 (int64 iff n_rows >= 2^31)
    idx_r: np.ndarray  # (n_pairs,) int32 (int64 iff n_rows >= 2^31)
    # When blocking streamed the pairs straight to disk (spill_dir set),
    # idx_l/idx_r are memmaps living in this directory; the linker adopts it
    # for lifetime management.
    spill_tmp: str | None = None
    # When the pairs came through the DURABLE spill store (build_spill_dir:
    # sharded emission with a resume manifest), this is the owning
    # spill.PairSpillStore — caller-owned, never auto-deleted, and what the
    # spill-fed streamed EM consumes directly.
    spill_store: object | None = None

    @property
    def n_pairs(self) -> int:
        return len(self.idx_l)

    def release(self) -> None:
        """Deterministically release the spill backing: close the memmaps
        FIRST, then reclaim the transient spill directory. The weakref
        finalizer does the same reclaim at GC time on POSIX, but Windows
        refuses to unlink a file with a live mapping — callers that need
        portable, immediate reclamation use this instead of relying on
        collection order. Idempotent; leaves a durable spill_store's files
        untouched (those are caller-owned)."""
        import shutil

        for name in ("idx_l", "idx_r"):
            arr = getattr(self, name)
            mm = getattr(arr, "_mmap", None)
            if mm is not None:
                setattr(self, name, np.zeros(0, arr.dtype))
                try:
                    mm.close()
                except (BufferError, OSError):
                    pass  # an external view still holds the map
        fin = self.__dict__.pop("_finalizer", None)
        if fin is not None:
            fin.detach()
        if self.spill_tmp is not None:
            shutil.rmtree(self.spill_tmp, ignore_errors=True)
            self.spill_tmp = None
        if self.spill_store is not None:
            self.spill_store.release_maps()


def _proc_start_time(pid: int) -> int | None:
    """The process's kernel start time (clock ticks since boot) from
    /proc/<pid>/stat, or None where /proc is unavailable. Distinguishes a
    live owner from an unrelated process that recycled its pid."""
    try:
        with open(f"/proc/{pid}/stat", "rb") as fh:
            data = fh.read().decode("ascii", "replace")
        # field 22 (starttime); the comm field can contain spaces/parens so
        # split after the LAST ')'
        return int(data.rsplit(")", 1)[1].split()[19])
    except (OSError, IndexError, ValueError):
        return None


def _owner_token(pid: int) -> str:
    start = _proc_start_time(pid)
    return f"{pid} {start}" if start is not None else str(pid)


def _sweep_stale_spill_dirs(spill_dir: str) -> None:
    """Reclaim splink_pairs_* dirs whose owning process is gone.

    The weakref finalizer on a spilled PairIndex never runs on
    SIGKILL/OOM-kill — the most likely death for a job big enough to spill —
    so each spill dir records its owner pid (plus the pid's kernel start
    time, so a recycled pid belonging to an unrelated live process doesn't
    pin a multi-GB orphan forever) and the next spilling run sweeps dirs
    whose owner is gone, BEFORE it starts writing its own pair set. Dirs
    without a pid file (mid-creation, or foreign) are left alone.
    """
    import os
    import shutil

    try:
        entries = os.listdir(spill_dir)
    except OSError:
        return
    for name in entries:
        if not name.startswith("splink_pairs_"):
            continue
        path = os.path.join(spill_dir, name)
        pid_file = os.path.join(path, "owner.pid")
        try:
            with open(pid_file) as fh:
                fields = fh.read().split()
            pid = int(fields[0])
            recorded_start = int(fields[1]) if len(fields) > 1 else None
        except (OSError, IndexError, ValueError):
            continue
        if pid == os.getpid():
            continue
        try:
            os.kill(pid, 0)  # signal 0: existence check only
        except ProcessLookupError:
            logger.info("reclaiming stale spill dir %s (pid %d dead)", path, pid)
            shutil.rmtree(path, ignore_errors=True)
            continue
        except OSError:
            pass  # e.g. EPERM: pid exists under another user — but
            # /proc/<pid>/stat is world-readable, so the start-time
            # comparison below still detects a recycled pid
        # pid is alive — but is it the same process that wrote the dir?
        current_start = _proc_start_time(pid)
        if (
            recorded_start is not None
            and current_start is not None
            and current_start != recorded_start
        ):
            logger.info(
                "reclaiming stale spill dir %s (pid %d recycled: start %d "
                "!= recorded %d)", path, pid, current_start, recorded_start,
            )
            shutil.rmtree(path, ignore_errors=True)


class _PairSink:
    """Accumulates per-rule pair chunks; either in RAM (concatenate at the
    end) or streamed to spill files as they are produced, so the pair set
    never exists twice in memory (chunks + concatenated copy).

    A context manager: an exception anywhere inside the ``with`` body
    aborts the sink — handles closed, the partial spill directory
    reclaimed — so segments written before a mid-emission failure are
    never left for the stale-dir sweep to (not) find: the owning process
    is still alive, which is exactly the case the pid-based sweep
    correctly refuses to touch."""

    def __enter__(self) -> "_PairSink":
        return self

    def __exit__(self, exc_type, exc, tb) -> None:
        if exc_type is not None:
            self.abort()

    def __init__(self, spill_dir: str | None, idx_dtype):
        self.idx_dtype = idx_dtype
        self.total = 0
        self.spill_tmp = None
        if spill_dir:
            import os
            import tempfile

            os.makedirs(spill_dir, exist_ok=True)
            # reclaim orphans before writing tens of GB next to them
            _sweep_stale_spill_dirs(spill_dir)
            self.spill_tmp = tempfile.mkdtemp(
                prefix="splink_pairs_", dir=spill_dir
            )
            with open(os.path.join(self.spill_tmp, "owner.pid"), "w") as fh:
                fh.write(_owner_token(os.getpid()))
            self._files = [
                open(os.path.join(self.spill_tmp, f"{name}.bin"), "wb")
                for name in ("idx_l", "idx_r")
            ]
        else:
            self._chunks_l: list[np.ndarray] = []
            self._chunks_r: list[np.ndarray] = []

    def append(self, i: np.ndarray, j: np.ndarray) -> None:
        i = i.astype(self.idx_dtype, copy=False)
        j = j.astype(self.idx_dtype, copy=False)
        self.total += len(i)
        if self.spill_tmp is not None:
            i.tofile(self._files[0])
            j.tofile(self._files[1])
        else:
            self._chunks_l.append(i)
            self._chunks_r.append(j)

    def abort(self) -> None:
        """Close handles and reclaim the partial spill dir after a failure
        mid-blocking — the owning process is still alive, so the stale-dir
        sweep would (correctly) not touch it."""
        if self.spill_tmp is None:
            return
        import shutil

        for fh in self._files:
            try:
                fh.close()
            except OSError:
                pass
        shutil.rmtree(self.spill_tmp, ignore_errors=True)
        self.spill_tmp = None

    def finish(self) -> PairIndex:
        if self.spill_tmp is None:
            if not self._chunks_l:  # chunked emission may sink nothing
                return PairIndex(
                    np.zeros(0, self.idx_dtype), np.zeros(0, self.idx_dtype)
                )
            if len(self._chunks_l) == 1:
                # np.concatenate on a one-element list still copies
                return PairIndex(self._chunks_l[0], self._chunks_r[0])
            return PairIndex(
                np.concatenate(self._chunks_l), np.concatenate(self._chunks_r)
            )
        import os
        import shutil
        import weakref

        for fh in self._files:
            fh.close()
        arrs = []
        for name in ("idx_l", "idx_r"):
            path = os.path.join(self.spill_tmp, f"{name}.bin")
            if self.total:
                arrs.append(
                    np.memmap(
                        path, dtype=self.idx_dtype, mode="r", shape=(self.total,)
                    )
                )
            else:
                arrs.append(np.empty(0, self.idx_dtype))
        out = PairIndex(arrs[0], arrs[1], spill_tmp=self.spill_tmp)
        # reclaim the files when the pair index goes away (unlink while the
        # memmaps are open is safe on POSIX; space frees on close). The
        # handle is kept so PairIndex.release() can close the maps first
        # and detach — the Windows-safe deterministic path.
        out._finalizer = weakref.finalize(out, shutil.rmtree, self.spill_tmp, True)
        return out


# ----------------------------------------------------------------------
# Small vectorised helpers
# ----------------------------------------------------------------------


def _key_codes(table: EncodedTable, cols: list[str]) -> np.ndarray:
    """Combined int64 key codes for a list of columns; -1 where any is null.

    Each entry is either a plain column name or a side-stripped derived-key
    expression (``substr(surname,1,3)``) evaluated host-side by
    splink_tpu/derived_keys.py — from here on a derived key is just codes.

    Cached per column tuple on the table instance (the `_uid_ranks`
    pattern): the overlap regime estimator and the blocking joins use the
    same keys, and refactorising billion-row columns twice would put
    minutes of duplicate work on the critical path."""
    cache = getattr(table, "_key_code_cache", None)
    if cache is None:
        cache = table._key_code_cache = {}
    key = tuple(cols)
    if key in cache:
        return cache[key]
    out = _key_codes_uncached(table, cols)
    cache[key] = out
    return out


def clear_key_code_cache(table: EncodedTable) -> None:
    """Drop the per-table key-code caches once their consumers (estimator,
    plan build, blocking joins) are done — at billions of rows each cached
    tuple is an 8-bytes-per-row array that must not outlive blocking."""
    if getattr(table, "_key_code_cache", None):
        table._key_code_cache = {}
    if getattr(table, "_asym_code_cache", None):
        table._asym_code_cache = {}
    from .derived_keys import clear_derived_key_cache

    clear_derived_key_cache(table)


def _pack_codes(combined: np.ndarray | None, codes: np.ndarray) -> np.ndarray:
    """Fold one more key's codes into the running combination, refactorising
    to keep codes < n_rows; -1 (null) anywhere makes the whole key null."""
    if combined is None:
        return codes.astype(np.int64)
    card = int(codes.max()) + 1 if len(codes) else 1
    null = (combined < 0) | (codes < 0)
    packed = combined * card + codes
    packed[null] = -1
    uniq, inv = np.unique(packed[~null], return_inverse=True)
    out = np.full(len(packed), -1, np.int64)
    out[~null] = inv
    return out


def _key_codes_uncached(table: EncodedTable, cols: list[str]) -> np.ndarray:
    combined: np.ndarray | None = None
    for col in cols:
        combined = _pack_codes(combined, _single_col_codes(table, col))
    assert combined is not None
    return combined


def _single_col_codes(table: EncodedTable, col: str) -> np.ndarray:
    if col in table.strings:
        return table.strings[col].token_ids.astype(np.int64)
    if col in table.numerics:
        nc = table.numerics[col]
        uniq, inv = np.unique(nc.values_f64[~nc.null_mask], return_inverse=True)
        out = np.full(table.n_rows, -1, np.int64)
        out[~nc.null_mask] = inv
        return out
    if col in table.raw:
        import pandas as pd

        codes, _ = pd.factorize(pd.Series(table.raw[col]))
        return codes.astype(np.int64)
    from .derived_keys import is_plain_column, key_values_object

    if is_plain_column(col):
        # a bare column name that is in no column family: unknown column
        raise KeyError(col)
    # derived-key expression: evaluate host-side, factorise
    import pandas as pd

    vals, null = key_values_object(table, col)
    codes, _ = pd.factorize(pd.Series(vals))
    codes = codes.astype(np.int64)
    codes[null] = -1
    return codes


def _key_codes_asym(
    table: EncodedTable,
    sym_cols: list[str],
    asym_pairs: list[tuple[str, str]],
) -> tuple[np.ndarray, np.ndarray]:
    """(codes_l, codes_r) for a rule whose equality terms include
    cross-column / cross-expression keys (``l.a = r.b``): each asymmetric
    key pair factorises BOTH sides over one shared vocabulary so equal
    values share a code across sides; symmetric keys contribute the same
    code array to both sides. Cached per (sym, asym) signature."""
    cache = getattr(table, "_asym_code_cache", None)
    if cache is None:
        cache = table._asym_code_cache = {}
    key = (tuple(sym_cols), tuple(asym_pairs))
    if key in cache:
        return cache[key]

    import pandas as pd

    from .derived_keys import key_values_object

    n = table.n_rows
    combined_l: np.ndarray | None = None
    combined_r: np.ndarray | None = None
    # every key folds through the PAIR packer (symmetric keys contribute the
    # same codes to both sides): refactorisation always runs over the union
    # of both sides, so the running combined codes stay comparable across
    # sides no matter how sym/asym keys interleave
    for col in sym_cols:
        codes = _single_col_codes(table, col)
        combined_l, combined_r = _pack_codes_pair(
            combined_l, codes, combined_r, codes
        )
    for lexpr, rexpr in asym_pairs:
        vl, nl_ = key_values_object(table, lexpr)
        vr, nr_ = key_values_object(table, rexpr)
        joint, _ = pd.factorize(pd.Series(np.concatenate([vl, vr])))
        joint = joint.astype(np.int64)
        cl, cr = joint[:n].copy(), joint[n:].copy()
        cl[nl_] = -1
        cr[nr_] = -1
        combined_l, combined_r = _pack_codes_pair(
            combined_l, cl, combined_r, cr
        )
    assert combined_l is not None and combined_r is not None
    cache[key] = (combined_l, combined_r)
    return cache[key]


def _pack_codes_pair(
    comb_l: np.ndarray | None,
    cl: np.ndarray,
    comb_r: np.ndarray | None,
    cr: np.ndarray,
) -> tuple[np.ndarray, np.ndarray]:
    """Fold one key's (cl, cr) codes into the running (combined_l,
    combined_r), refactorising over the UNION of both sides so codes stay
    comparable across sides. -1 (null) anywhere nulls the whole key."""
    if comb_l is None:
        return cl.astype(np.int64), cr.astype(np.int64)
    card = max(int(max(cl.max(initial=-1), cr.max(initial=-1))) + 1, 1)
    packed_all = []
    for comb, c in ((comb_l, cl), (comb_r, cr)):
        null = (comb < 0) | (c < 0)
        packed = comb * card + c
        packed[null] = -1
        packed_all.append(packed)
    both = np.concatenate(packed_all)
    valid = both >= 0
    uniq, inv = np.unique(both[valid], return_inverse=True)
    res = np.full(len(both), -1, np.int64)
    res[valid] = inv
    n = len(comb_l)
    return res[:n], res[n:]


def _sort_groups(codes: np.ndarray, rows: np.ndarray):
    """Sort rows by code; return (sorted_rows, unique_codes, starts, sizes)."""
    order = np.argsort(codes[rows], kind="stable")
    rows_sorted = rows[order]
    codes_sorted = codes[rows][order]
    if len(codes_sorted) == 0:
        return rows_sorted, codes_sorted[:0], np.zeros(0, np.int64), np.zeros(0, np.int64)
    boundary = np.r_[True, codes_sorted[1:] != codes_sorted[:-1]]
    starts = np.flatnonzero(boundary).astype(np.int64)
    sizes = np.diff(np.r_[starts, len(codes_sorted)]).astype(np.int64)
    return rows_sorted, codes_sorted[starts], starts, sizes


def _idx_dtype(n_rows: int):
    return np.int32 if n_rows < 2**31 else np.int64


def _iter_self_join_chunks(
    codes: np.ndarray, order: np.ndarray | None = None,
    chunk: int | None = None,
):
    """Yield (i, j) chunks of at most ~``chunk`` pairs for the within-group
    self-join, in :func:`_self_join`'s emission order.

    With ``order`` (per-row ranks), group members are pre-sorted by rank so
    each emitted pair already satisfies rank_i < rank_j — orientation comes
    out of the join for free instead of costing a full-size gather + where
    pass over billions of pairs. Emits int32 indices when the table allows.

    The expansion intermediates (``np.repeat`` over sizes, :func:`_ranges`)
    are built PER CHUNK, so peak host RAM is O(chunk) no matter how many
    pairs the rule produces — previously a budget/spill run still built the
    full-pair-count repeat arrays in one shot.
    """
    rows = np.flatnonzero(codes >= 0).astype(_idx_dtype(len(codes)))
    if order is not None:
        rows = rows[np.argsort(order[rows], kind="stable")]
    rows_sorted, _, starts, sizes = _sort_groups(codes, rows)
    counts = (sizes * (sizes - 1)) // 2
    cap = chunk if chunk else max(int(counts.sum()), 1)
    g, n_groups = 0, len(sizes)
    while g < n_groups:
        if counts[g] > cap:
            # giant group: split its triangle by a-rows so each slice
            # emits at most ~cap pairs; a single a-row wider than the cap
            # (near-constant key) further splits its contiguous b-range,
            # so the O(cap) bound holds for ANY group shape
            s0, s = int(starts[g]), int(sizes[g])
            rem = (s - 1) - np.arange(s - 1, dtype=np.int64)
            cum = np.cumsum(rem)
            k = 0
            while k < s - 1:
                if rem[k] > cap:
                    i_row = rows_sorted[s0 + k]
                    for b0 in range(k + 1, s, cap):
                        q = rows_sorted[s0 + b0 : s0 + min(b0 + cap, s)]
                        yield np.full(len(q), i_row, rows_sorted.dtype), q
                    k += 1
                    continue
                base = int(cum[k - 1]) if k else 0
                # last k2 with cum[k2-1] <= base + cap: the packed rows'
                # pairs stay within the cap (rows wider than the cap were
                # peeled off above)
                k2 = int(np.searchsorted(cum, base + cap, side="right"))
                k2 = min(max(k2, k + 1), s - 1)
                sub = np.arange(k, k2, dtype=np.int64)
                rep = (s - 1) - sub
                p = np.repeat(sub, rep) + s0
                q = p + 1 + _ranges(rep)
                yield rows_sorted[p], rows_sorted[q]
                k = k2
            g += 1
            continue
        # greedy span of whole groups with total pairs <= cap
        g2, tot = g, 0
        while g2 < n_groups and tot + counts[g2] <= cap:
            tot += counts[g2]
            g2 += 1
        g2 = max(g2, g + 1)
        yield native.self_join_pairs(rows_sorted, starts[g:g2], sizes[g:g2])
        g = g2


def _self_join(
    codes: np.ndarray, order: np.ndarray | None = None
) -> tuple[np.ndarray, np.ndarray]:
    """All unordered within-group pairs for non-null codes, in one array
    pair (see :func:`_iter_self_join_chunks` for the chunked form)."""
    out = list(_iter_self_join_chunks(codes, order))
    if not out:
        dt = _idx_dtype(len(codes))
        return np.zeros(0, dt), np.zeros(0, dt)
    if len(out) == 1:
        return out[0]
    return (
        np.concatenate([c[0] for c in out]),
        np.concatenate([c[1] for c in out]),
    )


def _iter_cross_join_chunks(
    codes_l: np.ndarray,
    left_rows: np.ndarray,
    right_rows: np.ndarray,
    codes_r: np.ndarray | None = None,
    chunk: int | None = None,
):
    """Yield (i, j) chunks of at most ~``chunk`` pairs for the cross join,
    in :func:`_cross_join`'s emission order. With ``codes_r`` the two sides
    read different code arrays (an asymmetric key like ``l.a = r.b`` — both
    factorised over one shared vocabulary by _key_codes_asym); otherwise
    one array serves both. Expansion intermediates are per chunk, like
    :func:`_iter_self_join_chunks`."""
    if codes_r is None:
        codes_r = codes_l
    lrows, lcodes, lstarts, lsizes = _sort_groups(
        codes_l, left_rows[codes_l[left_rows] >= 0]
    )
    rrows, rcodes, rstarts, rsizes = _sort_groups(
        codes_r, right_rows[codes_r[right_rows] >= 0]
    )
    # intersect group keys
    common, li, ri = np.intersect1d(lcodes, rcodes, return_indices=True)
    if len(common) == 0:
        return
    ls, lz = lstarts[li], lsizes[li]
    rs, rz = rstarts[ri], rsizes[ri]
    counts = lz * rz
    cap = chunk if chunk else max(int(counts.sum()), 1)
    g, n_groups = 0, len(common)
    while g < n_groups:
        if counts[g] > cap:
            # giant group: split its rectangle by l-rows; an r-side wider
            # than the cap further splits each l-row's contiguous r-range,
            # so the O(cap) bound holds for ANY group shape
            l0, lzg = int(ls[g]), int(lz[g])
            r0, rzg = int(rs[g]), int(rz[g])
            if rzg > cap:
                for a in range(lzg):
                    i_row = lrows[l0 + a]
                    for b0 in range(0, rzg, cap):
                        q = rrows[r0 + b0 : r0 + min(b0 + cap, rzg)]
                        yield np.full(len(q), i_row, lrows.dtype), q
                g += 1
                continue
            rows_per = max(cap // rzg, 1)
            right_span = np.arange(r0, r0 + rzg, dtype=np.int64)
            for a0 in range(0, lzg, rows_per):
                a1 = min(a0 + rows_per, lzg)
                p = np.repeat(
                    np.arange(a0, a1, dtype=np.int64) + l0, rzg
                )
                q = np.tile(right_span, a1 - a0)
                yield lrows[p], rrows[q]
            g += 1
            continue
        g2, tot = g, 0
        while g2 < n_groups and tot + counts[g2] <= cap:
            tot += counts[g2]
            g2 += 1
        g2 = max(g2, g + 1)
        span = slice(g, g2)
        yield native.cross_join_pairs(
            lrows, ls[span], lz[span], rrows, rs[span], rz[span]
        )
        g = g2


def _cross_join(
    codes_l: np.ndarray,
    left_rows: np.ndarray,
    right_rows: np.ndarray,
    codes_r: np.ndarray | None = None,
):
    """All cross pairs whose key codes match, in one array pair (see
    :func:`_iter_cross_join_chunks` for the chunked form)."""
    out = list(
        _iter_cross_join_chunks(codes_l, left_rows, right_rows, codes_r)
    )
    if not out:
        return np.zeros(0, np.int64), np.zeros(0, np.int64)
    if len(out) == 1:
        return out[0]
    return (
        np.concatenate([c[0] for c in out]),
        np.concatenate([c[1] for c in out]),
    )


# ----------------------------------------------------------------------
# Pair orientation / where-condition per link type
# ----------------------------------------------------------------------


def _uid_ranks(table: EncodedTable, link_type: str):
    """(ranks, keys_unique): int32 rank of each row in the reference's
    ordering — uid for dedupe_only, (source_table, uid) for link_and_dedupe —
    plus whether the ordering keys are unique (they almost always are, which
    lets orientation skip the drop-equal-key pass entirely). Rank comparisons
    replace per-pair gathers of arbitrary-dtype uid arrays: at billions of
    candidate pairs the int32 rank gather halves the transient footprint and
    avoids object-dtype comparisons for string uids. Cached per table."""
    cache = getattr(table, "_uid_rank_cache", None)
    if cache is None:
        cache = table._uid_rank_cache = {}
    if link_type not in cache:
        uid = np.asarray(table.unique_id)
        if link_type == "link_and_dedupe":
            order = np.lexsort((uid, table.source_table))
        else:
            order = np.argsort(uid, kind="stable")
        ranks = np.empty(len(uid), np.int32)
        ranks[order] = np.arange(len(uid), dtype=np.int32)
        sorted_uid = uid[order]
        if len(uid) < 2:
            keys_unique = True
        elif link_type == "link_and_dedupe":
            sorted_src = table.source_table[order]
            keys_unique = bool(
                (
                    (sorted_uid[1:] != sorted_uid[:-1])
                    | (sorted_src[1:] != sorted_src[:-1])
                ).all()
            )
        else:
            keys_unique = bool((sorted_uid[1:] != sorted_uid[:-1]).all())
        cache[link_type] = (ranks, keys_unique)
    return cache[link_type]


def _drop_equal_key_pairs(
    table: EncodedTable, link_type: str, i: np.ndarray, j: np.ndarray
):
    """Drop pairs whose ordering keys collide (duplicate uids in the input):
    the reference's strict l.uid < r.uid / (source, uid) ordering excludes
    them. Only reached when the input really contains duplicates."""
    uid = table.unique_id
    if link_type == "link_and_dedupe":
        st = table.source_table
        keep = ~((st[i] == st[j]) & (uid[i] == uid[j]))
    else:
        keep = uid[i] != uid[j]
    return i[keep], j[keep]


def _orient_pairs(table: EncodedTable, link_type: str, i: np.ndarray, j: np.ndarray):
    """Apply the reference's where-condition semantics to unordered pairs."""
    if link_type == "dedupe_only":
        ranks, uids_unique = _uid_ranks(table, link_type)
        ri, rj = ranks[i], ranks[j]
        if not uids_unique:
            # duplicated uids: drop equal-uid pairs (the reference's
            # l.uid < r.uid keeps them out)
            uid = table.unique_id
            keep = uid[i] != uid[j]
            i, j, ri, rj = i[keep], j[keep], ri[keep], rj[keep]
        swap = rj < ri
        return np.where(swap, j, i), np.where(swap, i, j)
    if link_type == "link_and_dedupe":
        ranks, combos_unique = _uid_ranks(table, link_type)
        ri, rj = ranks[i], ranks[j]
        if combos_unique:
            keep = ri != rj  # drops same-source same-uid self matches
        else:
            st = table.source_table
            uid = table.unique_id
            keep = ~((st[i] == st[j]) & (uid[i] == uid[j]))
        i, j, ri, rj = i[keep], j[keep], ri[keep], rj[keep]
        swap = rj < ri
        return np.where(swap, j, i), np.where(swap, i, j)
    return i, j  # link_only: orientation fixed by construction


# ----------------------------------------------------------------------
# Residual (non-equality) predicate evaluation
# ----------------------------------------------------------------------


def _eval_residual(table: EncodedTable, residual: str, i: np.ndarray, j: np.ndarray):
    """Evaluate a translated residual predicate on candidate pairs via the
    typed AST interpreter (splink_tpu/residual_eval.py): string columns
    compare through lexicographic rank arrays, comparisons follow SQL null
    semantics, and no ``eval`` is involved."""
    from .residual_eval import evaluate_residual

    mask = evaluate_residual(table, residual, i, j)
    return i[mask], j[mask]


# ----------------------------------------------------------------------
# Public entry points
# ----------------------------------------------------------------------


@check_types
def estimate_pair_upper_bound(
    settings: dict,
    table: EncodedTable,
    n_left: int | None = None,
    include_approx: bool = True,
) -> int:
    """Cheap O(n) upper bound on the candidate-pair count: per-rule join
    sizes from key-group histograms, ignoring sequential-rule dedup and
    residual filters (both only remove pairs). The linker uses it to pick
    the overlap consumer BEFORE blocking runs — resident-size jobs stream
    the gamma matrix (keeping it device-resident for EM), larger ones
    stream 3-byte pattern ids."""
    link_type = settings["link_type"]
    rules = settings.get("blocking_rules") or []
    n = table.n_rows
    if not rules:
        if link_type == "link_only":
            assert n_left is not None
            return n_left * (n - n_left)
        return n * (n - 1) // 2
    bound = sum(
        _rule_group_stats(link_type, table, rule, n_left)[1] for rule in rules
    )
    if include_approx and settings.get("approx_blocking"):
        # the approximate tier appends at most its pair budget, only when
        # it can run (no sketchable string column: it adds nothing) and
        # never more than the job's total possible pair count;
        # include_approx=False gives the exact rules' bound, which the
        # device-blocking "auto" gate weighs
        from .approx.lsh import DEFAULT_BUDGET, approx_columns

        if approx_columns(settings, table):
            budget = int(settings.get("approx_pair_budget") or DEFAULT_BUDGET)
            if link_type == "link_only" and n_left is not None:
                total = n_left * (n - n_left)
            else:
                total = n * (n - 1) // 2
            bound += min(budget, total)
    return bound


def _rule_group_stats(
    link_type: str, table: EncodedTable, rule: str, n_left: int | None
) -> tuple[np.ndarray | None, int]:
    """One rule's (key-group row histogram, upper-bound pair count) — the
    single definition behind :func:`estimate_pair_upper_bound` (which sums
    the bounds) and :func:`block_size_stats` (which reads the histogram).
    The histogram is None for a keyless (cartesian) rule; for link_only
    and asymmetric keys it is the combined l+r per-group row count."""
    eq_pairs, residual = parse_blocking_rule(rule)
    sym_cols, asym, residual = _split_join_keys(eq_pairs, residual)
    if not sym_cols and not asym:
        return None, table.n_rows * table.n_rows
    if asym:
        codes_l, codes_r = _key_codes_asym(table, sym_cols, asym)
    else:
        codes_l = codes_r = _key_codes(table, sym_cols)
    m = (
        int(max(codes_l.max(initial=-1), codes_r.max(initial=-1))) + 1
        if len(codes_l)
        else 0
    )
    if m <= 0:
        return np.zeros(0, np.int64), 0
    if link_type == "link_only":
        assert n_left is not None
        cl, cr = codes_l[:n_left], codes_r[n_left:]
        hl = np.bincount(cl[cl >= 0], minlength=m).astype(np.int64)
        hr = np.bincount(cr[cr >= 0], minlength=m).astype(np.int64)
        return hl + hr, int(hl @ hr)
    if asym:
        # self-join on an asymmetric key: l-side histogram against
        # r-side histogram over-counts by the rank filter and the
        # diagonal — it stays an upper bound, which is the contract
        hl = np.bincount(codes_l[codes_l >= 0], minlength=m).astype(np.int64)
        hr = np.bincount(codes_r[codes_r >= 0], minlength=m).astype(np.int64)
        return hl + hr, int(hl @ hr)
    valid = codes_l[codes_l >= 0]
    if not len(valid):
        return np.zeros(0, np.int64), 0
    cnt = np.bincount(valid, minlength=m).astype(np.int64)
    return cnt, int((cnt * (cnt - 1) // 2).sum())


def block_size_stats(
    settings: dict, table: EncodedTable, n_left: int | None = None, top: int = 5
) -> list[dict]:
    """Per-rule block-size telemetry from the same O(n) key-group
    histograms as :func:`estimate_pair_upper_bound` (the key-code cache
    makes the second walk nearly free). Skewed blocks are the central
    scalability risk of rule-based blocking (arxiv 1905.06167) and what
    progressive blocking manages dynamically (arxiv 2005.14326) — this is
    the machine-readable record of which blocks dominated a run, the
    replacement for eyeballing the Spark UI's task-skew view.

    Returns one dict per rule: number of non-null key groups, the
    ``top``-largest group row counts (descending), and that rule's
    upper-bound pair contribution.
    """
    link_type = settings["link_type"]
    rules = settings.get("blocking_rules") or []
    stats: list[dict] = []
    for rule in rules:
        entry = {"rule": rule, "n_groups": 0, "top_group_rows": [],
                 "pair_bound": 0}
        try:
            h, entry["pair_bound"] = _rule_group_stats(
                link_type, table, rule, n_left
            )
            if h is not None:
                nz = h[h > 0]
                entry["n_groups"] = int(len(nz))
                if len(nz):
                    largest = np.sort(nz)[::-1][:top]
                    entry["top_group_rows"] = [int(v) for v in largest]
        except Exception as e:  # noqa: BLE001 - telemetry is best-effort
            entry["error"] = f"{type(e).__name__}: {e}"[:200]
        stats.append(entry)
    return stats


def block_using_rules(
    settings: dict,
    table: EncodedTable,
    n_left: int | None = None,
    pair_consumer=None,
    device=None,
) -> PairIndex:
    """Generate candidate pairs for the given settings.

    Args:
        settings: completed settings dict.
        table: the encoded input table. For link_only / link_and_dedupe this
            is the vertical concatenation of both inputs (rows [0, n_left)
            from the left input).
        n_left: number of left-input rows (link types only).
        pair_consumer: optional callable(i, j) invoked with every pair chunk
            in emission order, right after it is sunk. The linker passes a
            device-scoring stream here, so that the device computes rule
            k's gammas or pattern ids while the host joins rule k+1,
            instead of a second sweep over the finished (possibly
            spilled) pair index.
        device: where the device tier runs (``cuda`` unless named; the
            linker passes its own). ``device_blocking`` "auto" keeps the
            host join when it is the CPU.

    With ``spill_dir`` set, the chunks stream to memmapped files in a fresh
    ``splink_pairs_*`` directory under it instead of being kept in RAM.
    """
    link_type = settings["link_type"]
    rules = settings.get("blocking_rules") or []
    if not rules:
        tiers["host"] += 1
        return cartesian_block(settings, table, n_left, pair_consumer)

    # Pair indices are stored int32 when the table allows (they always do —
    # int32 row indices cover 2^31 rows); at billions of candidate pairs this
    # halves the resident footprint of the pair set.
    idx_dtype = _idx_dtype(table.n_rows)
    all_rows = np.arange(table.n_rows, dtype=idx_dtype)

    # the approximate tier (approx/: minhash-LSH band joins, q-gram
    # verification, a pair budget) runs AFTER the exact rules when opted
    # in: it drops every pair an exact rule produced and appends its
    # best-first chunks to the same sink
    approx_on = bool(settings.get("approx_blocking"))
    with _PairSink(settings.get("spill_dir"), idx_dtype) as sink:
        # the device sort-join tier first; it returns None for the host join
        # (a rule shape its plan rejects, or an "auto" job it does not take)
        mode = settings.get("device_blocking", "auto")
        out = None
        if mode in ("auto", "on"):
            from .blocking_device import device_block_rules

            out = device_block_rules(settings, table, n_left, sink, pair_consumer, mode,
                                     device=device, finish=not approx_on)
        if out is not None:
            tiers["device"] += 1
        else:
            tiers["host"] += 1
            out = _block_rules_into(sink, rules, settings, table, link_type, all_rows,
                                    n_left, pair_consumer, finish=not approx_on)
        if not approx_on:
            return out
        from .approx import approx_block_into

        approx_block_into(settings, table, n_left, sink, pair_consumer, device=device)
        return sink.finish()


def _block_rules_into(
    sink, rules, settings, table, link_type, all_rows, n_left, pair_consumer=None,
    finish: bool = True,
) -> PairIndex | None:
    # Sequential-rule dedup by PREDICATE, the literal semantics of the
    # reference's ``AND NOT ifnull(previous_rule, false)``
    # (splink/blocking.py:59-68): a candidate of rule k is kept iff NO
    # earlier rule's predicate holds for it, so no accumulated pair set is
    # sorted or kept.
    prior_rules: list[tuple[np.ndarray | None, str | None]] = []
    # Per-rule pairs are generated and CONSUMED in bounded chunks: the
    # residual/dedup filters are elementwise, so running them chunk-wise is
    # semantics-preserving and keeps peak host RAM at O(chunk) — the
    # expansion intermediates (np.repeat / _ranges) no longer materialise
    # over a rule's full pair count when a budget or spill cap applies.
    chunk_cap = int(settings.get("blocking_chunk_pairs") or 0) or None
    if link_type == "link_only":
        assert n_left is not None
        left_rows, right_rows = all_rows[:n_left], all_rows[n_left:]
    for rule in rules:
        eq_pairs, residual = parse_blocking_rule(rule)
        sym_cols, asym, residual = _split_join_keys(eq_pairs, residual)

        rank_filter = False
        if asym:
            # asymmetric equality keys (l.a = r.b): hash join over the
            # shared-vocabulary code pair
            codes_l, codes_r = _key_codes_asym(table, sym_cols, asym)
            if link_type == "link_only":
                chunks = _iter_cross_join_chunks(
                    codes_l, left_rows, right_rows, codes_r, chunk_cap
                )
            else:
                # f(l) = g(r) was written with the l side first; the
                # reference's join enumerates ordered (l, r) pairs and its
                # where-condition keeps rank_l < rank_r — so cross-join the
                # table against itself and keep that orientation (no swap:
                # swapping would change which side each expression applies
                # to)
                chunks = _iter_cross_join_chunks(
                    codes_l, all_rows, all_rows, codes_r, chunk_cap
                )
                rank_filter = True
        elif sym_cols:
            codes_l = codes_r = _key_codes(table, sym_cols)
            if link_type == "link_only":
                # oriented by construction: left input on the l side
                chunks = _iter_cross_join_chunks(
                    codes_l, left_rows, right_rows, chunk=chunk_cap
                )
            else:
                # group members pre-sorted by uid rank -> pairs come out
                # already oriented; only duplicate-key inputs need the
                # drop-equal pass
                ranks, keys_unique = _uid_ranks(table, link_type)
                chunks = _iter_self_join_chunks(
                    codes_l, order=ranks, chunk=chunk_cap
                )
        else:
            codes_l = codes_r = None
            warnings.warn(
                f"Blocking rule {rule!r} has no equality condition; evaluating "
                "it against all row pairs (quadratic)."
            )
            chunks = (
                _iter_all_pairs_chunks(
                    table, link_type, n_left, chunk_cap or _CARTESIAN_CHUNK
                )
            )
        n_new = 0
        for i, j in chunks:
            if codes_l is None:
                i, j = _orient_pairs(table, link_type, i, j)
            elif rank_filter:
                ranks, keys_unique = _uid_ranks(table, link_type)
                keep = ranks[i] < ranks[j]
                i, j = i[keep], j[keep]
                if not keys_unique:
                    i, j = _drop_equal_key_pairs(table, link_type, i, j)
            elif sym_cols and link_type != "link_only" and not keys_unique:
                i, j = _drop_equal_key_pairs(table, link_type, i, j)
            if residual is not None:
                i, j = _eval_residual(table, residual, i, j)
            for prev_l, prev_r, prev_residual in prior_rules:
                holds = _rule_holds(
                    table, prev_l, prev_r, prev_residual, i, j
                )
                keep = ~holds
                i, j = i[keep], j[keep]
            n_new += len(i)
            sink.append(i, j)
            if pair_consumer is not None:
                pair_consumer(
                    i.astype(sink.idx_dtype, copy=False),
                    j.astype(sink.idx_dtype, copy=False),
                )
            del i, j

        prior_rules.append((codes_l, codes_r, residual))
        logger.debug("blocking rule %r -> %d new pairs", rule, n_new)

    return sink.finish() if finish else None


def _rule_holds(
    table: EncodedTable,
    codes_l: np.ndarray | None,
    codes_r: np.ndarray | None,
    residual: str | None,
    i: np.ndarray,
    j: np.ndarray,
) -> np.ndarray:
    """Whether an (earlier) rule's predicate holds for each candidate pair:
    combined join-key equality (null keys never match) AND the residual
    (UNKNOWN counts as not-holding — ifnull(..., false)). Candidates are
    already oriented with i on the l side, so an asymmetric earlier rule
    reads codes_l[i] against codes_r[j]."""
    if codes_l is not None:
        ci, cj = codes_l[i], codes_r[j]
        holds = (ci == cj) & (ci >= 0)
    else:
        holds = np.ones(len(i), bool)
    if residual is not None:
        sub = np.flatnonzero(holds)
        if len(sub):
            from .residual_eval import evaluate_residual

            holds[sub] = evaluate_residual(table, residual, i[sub], j[sub])
    return holds


def _split_join_keys(
    eq_pairs, residual: str | None
) -> tuple[list[str], list[tuple[str, str]], str | None]:
    """-> (sym_cols, asym_pairs, residual). Same-expression equalities
    (``l.x = r.x``, ``substr(l.x,1,3) = substr(r.x,1,3)``) become symmetric
    hash-join keys; cross-column / cross-expression equalities (``l.a =
    r.b`` — a name-swap block, say) keep distinct left/right keys and
    hash-join through a shared vocabulary (_key_codes_asym) instead of the
    round-3 behaviour of filtering them as residuals after a join on the
    remaining keys (quadratic when they were the ONLY equality)."""
    sym: list[str] = []
    asym: list[tuple[str, str]] = []
    for lc, rc in eq_pairs:
        if lc == rc:
            sym.append(lc)
        else:
            asym.append((lc, rc))
    return sym, asym, residual


def _all_pairs(table: EncodedTable, link_type: str, n_left: int | None):
    n = table.n_rows
    if link_type == "link_only":
        assert n_left is not None
        n_right = n - n_left
        i = np.repeat(np.arange(n_left, dtype=np.int64), n_right)
        j = np.tile(np.arange(n_left, n, dtype=np.int64), n_left)
        return i, j
    tri = np.triu_indices(n, k=1)
    return tri[0].astype(np.int64), tri[1].astype(np.int64)


def _iter_all_pairs_chunks(table: EncodedTable, link_type: str, n_left, chunk):
    """Yield the cartesian pair set in bounded-memory (i, j) chunks of at
    most ~``chunk`` pairs, in the same order _all_pairs produces."""
    n = table.n_rows
    if link_type == "link_only":
        assert n_left is not None
        n_right = n - n_left
        rows_per = max(1, chunk // max(n_right, 1))
        right = np.arange(n_left, n, dtype=np.int64)
        for a in range(0, n_left, rows_per):
            b = min(a + rows_per, n_left)
            i = np.repeat(np.arange(a, b, dtype=np.int64), n_right)
            j = np.tile(right, b - a)
            yield i, j
        return
    # dedupe-style upper triangle (i < j), emitted row-block by row-block
    a = 0
    while a < n - 1:
        b = a + 1
        total = n - 1 - a
        while b < n - 1 and total + (n - 1 - b) <= chunk:
            total += n - 1 - b
            b += 1
        counts = (n - 1) - np.arange(a, b, dtype=np.int64)
        i = np.repeat(np.arange(a, b, dtype=np.int64), counts)
        starts = np.repeat(np.arange(a, b, dtype=np.int64) + 1, counts)
        within = np.arange(len(i), dtype=np.int64) - np.repeat(
            np.cumsum(counts) - counts, counts
        )
        j = starts + within
        yield i, j
        a = b


def cartesian_block(
    settings: dict,
    table: EncodedTable,
    n_left: int | None = None,
    pair_consumer=None,
) -> PairIndex:
    """All pairwise comparisons (the fallback when no rules are given,
    splink/blocking.py:183-184, 219-318). With spill_dir the pair set is
    generated and streamed to disk in bounded-memory chunks."""
    link_type = settings["link_type"]
    spill_dir = settings.get("spill_dir")
    idx_dtype = _idx_dtype(table.n_rows)
    if not spill_dir:
        i, j = _all_pairs(table, link_type, n_left)
        i, j = _orient_pairs(table, link_type, i, j)
        i = i.astype(idx_dtype, copy=False)
        j = j.astype(idx_dtype, copy=False)
        if pair_consumer is not None:
            pair_consumer(i, j)
        return PairIndex(i, j)
    with _PairSink(spill_dir, idx_dtype) as sink:
        for i, j in _iter_all_pairs_chunks(table, link_type, n_left, _CARTESIAN_CHUNK):
            i, j = _orient_pairs(table, link_type, i, j)
            sink.append(i, j)
            if pair_consumer is not None:
                pair_consumer(i.astype(idx_dtype, copy=False), j.astype(idx_dtype, copy=False))
        return sink.finish()
