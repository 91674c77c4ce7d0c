"""LinkageIndex: the frozen, versioned serving artifact, on PyTorch.

The port of splink_tpu/serve/index.py. A trained ``Splink`` linker freezes
into a :class:`LinkageIndex`, a self-contained artifact that a query
service loads once and serves from for its whole lifetime. It holds

  * the encoded reference table as the packed uint32 row matrix the gamma
    functions gather from (``gammas.pack_table`` layout, without the
    two-phase Jaro-Winkler lanes), uploaded to the index's device once;
  * a per-blocking-rule hash-bucket index over the key codes blocking.py
    joins on (``_key_codes``): rows grouped by combined key code in CSR
    form (``rows_sorted``/``starts``/``sizes``), a per-row bucket id for
    sequential-rule dedup on the device, and the host-side key -> bucket
    dictionary a query record resolves through;
  * with ``approx_blocking``, the LSH fallback: one bucket CSR per
    minhash band over the approximate columns (the same band keys the
    offline tier joins on), a band key -> bucket dictionary per band, and
    the IDF table of the TF-weighted tier. A query whose exact keys hit no
    bucket resolves its band keys instead and is served from the union of
    its band buckets, tagged ``approx=True``;
  * the trained Fellegi-Sunter parameters;
  * the term-frequency tables (per-token counts) of every TF-flagged
    column with the per-row reference token ids of the fold columns, and
    the per-column vocabularies that bind query-side encoding to the
    reference factorisation.

The artifact format is the reference's, unchanged: ``np.savez_compressed``
arrays under a fingerprint-derived file name, then the meta JSON as the
atomic commit point; ``load_index`` checks the format version, the
settings hash and the arrays' sha256. An index either package saves loads
in the other, and for parameters loaded from one model JSON over one frame
``content_fingerprint`` and ``arrays_sha256`` are equal across packages.

Device rule: an index built from a linker lives on the linker's device;
``load_index(dir, device=None)`` puts it on ``cuda`` unless the caller
names another device, and raises when no CUDA device exists.

Serving restriction: blocking rules must be pure equality conjunctions
(``l.a = r.a AND substr(l.b,1,3) = substr(r.b,1,3)``: symmetric keys,
derived-key expressions included). Residual predicates and cross-column
equalities have no bucket structure to index; :func:`build_index` rejects
them rather than serving wrong candidates.

With ``quality_profile`` on, :func:`build_index` captures the
training-reference quality profile (obs/quality.py) on the linker's device;
``save`` writes its four ``profile_*`` arrays inside the fingerprinted
payload and ``load_index`` restores them. The profile stays outside
``content_fingerprint()``: it describes the training data, not an answer.
"""

from __future__ import annotations

import hashlib
import io
import json
import logging
import os
from dataclasses import dataclass, field

import numpy as np
import torch

from .._device import resolve_device
from ..blocking import _key_codes, _sort_groups, _split_join_keys, clear_key_code_cache
from ..compat_sql import parse_blocking_rule
from ..data import (
    EncodedNumericColumn,
    EncodedStringColumn,
    EncodedTable,
    encode_table,
)
from ..gammas import (
    charset_specs_for,
    comparison_columns_used,
    pack_table,
    qgram_specs_for,
)
from ..resilience.checkpoint import (
    atomic_write_bytes,
    atomic_write_json,
    fsync_dir,
    settings_state_hash,
)

logger = logging.getLogger("splink_tpu_torch")

INDEX_VERSION = 1
META_NAME = "linkage_index.json"
ARRAYS_STEM = "linkage_index"  # arrays live at <stem>-<sha16>.npz

BUILD_STATE_NAME = "build_state.json"
BUILD_STATE_VERSION = 1

# row chunk for hashing / streaming large arrays: big enough that per-chunk
# python overhead vanishes, small enough that the transient contiguous copy
# stays tens of MB
_HASH_CHUNK_ROWS = 1 << 18

# canonical-key-token separator (see _canon_token)
_KEY_SEP = "\x1f"



def _hash_update_array(h, arr: np.ndarray, chunk_rows: int = _HASH_CHUNK_ROWS):
    """h.update() over an array's bytes in row chunks: byte-identical to
    ``h.update(np.ascontiguousarray(arr).tobytes())`` without the
    full-size contiguous copy (the out-of-core build hands
    content_fingerprint a disk-backed packed matrix)."""
    if arr.ndim == 0 or len(arr) == 0:
        h.update(np.ascontiguousarray(arr).tobytes())
        return
    for s in range(0, len(arr), chunk_rows):
        h.update(np.ascontiguousarray(arr[s : s + chunk_rows]).tobytes())
    # drop the pages a memmapped source just faulted in: the hash walk is
    # one sequential pass and must not leave the whole file resident
    mm = getattr(arr, "_mmap", None)
    if mm is not None:
        try:
            import mmap as _mmap

            mm.madvise(_mmap.MADV_DONTNEED)
        except (AttributeError, ValueError, OSError):
            pass


class ServeIndexError(RuntimeError):
    """Unreadable / corrupt / mismatched serving index."""


class IndexMismatchError(ServeIndexError):
    """Index belongs to a different job (settings hash, format version or
    array fingerprint disagree): refusing to serve from it."""


def _canon_token(v) -> str | None:
    """Canonical string token for one blocking-key value, equality-isomorphic
    to the factorisation blocking.py keys on: strings compare by their
    ``str()`` form (token-id semantics), numbers by exact float value.
    None means null: a null key never joins (SQL equality)."""
    if v is None:
        return None
    if isinstance(v, (bool, np.bool_)):
        return f"b:{bool(v)}"
    if isinstance(v, (int, np.integer)):
        f = float(v)
        return f"n:{f!r}" if int(f) == int(v) else f"i:{int(v)}"
    if isinstance(v, (float, np.floating)):
        return f"n:{float(v)!r}"
    return f"s:{v}"


def _canonical_key_values(table: EncodedTable, col: str) -> np.ndarray:
    """(n_rows,) object array of canonical key values for one blocking-key
    column/expression; None where null. The single definition used at index
    build (reference side) and at query encode (query side), so the two
    sides cannot drift."""
    import pandas as pd

    n = table.n_rows
    out = np.empty(n, dtype=object)
    out[:] = None
    if col in table.strings:
        sc = table.strings[col]
        nz = np.flatnonzero(~sc.null_mask)
        out[nz] = [f"s:{sc.values[i]}" for i in nz]
        return out
    if col in table.numerics:
        nc = table.numerics[col]
        nz = np.flatnonzero(~nc.null_mask)
        # .tolist() yields PYTHON floats: numpy 2 reprs scalars as
        # "np.float64(x)", which would silently split every bucket key
        vals = nc.values_f64.tolist()
        out[nz] = [f"n:{vals[i]!r}" for i in nz]
        return out
    if col in table.raw:
        vals = table.raw[col]
        null = pd.isna(pd.Series(vals)).to_numpy()
        nz = np.flatnonzero(~null)
        out[nz] = [_canon_token(vals[i]) for i in nz]
        return out
    from ..derived_keys import is_plain_column, key_values_object

    if is_plain_column(col):
        raise KeyError(f"blocking key column {col!r} is not in the table")
    vals, null = key_values_object(table, col)
    nz = np.flatnonzero(~np.asarray(null))
    out[nz] = [_canon_token(vals[i]) for i in nz]
    return out


def _encode_value_chars(
    bytes_: np.ndarray, lengths: np.ndarray, row: int, value: str,
    width: int, kind: str,
) -> None:
    """Write one query value's chars into ``row`` of (bytes_, lengths)
    with the reference byte semantics: values truncate at the reference
    width; a non-ASCII char in an ascii column becomes 0xFF, which matches
    no reference byte."""
    chars = value[:width]
    lengths[row] = len(chars)
    for j, ch in enumerate(chars):
        cp = ord(ch)
        if kind == "ascii":
            bytes_[row, j] = cp if cp < 128 else 0xFF
        else:
            bytes_[row, j] = cp


def _encode_query_bytes(sc: EncodedStringColumn, width: int, kind: str, rows: np.ndarray):
    """(bytes, lengths) for the given ``rows`` of a query string column,
    pinned to the REFERENCE width and ascii/wide kind (the byte semantics
    of ``_encode_value_chars``), without the vocabulary work the minhash
    signatures do not need. Null rows keep length 0 (no grams)."""
    n = len(rows)
    bytes_ = np.zeros((n, width), np.uint8 if kind == "ascii" else np.uint32)
    lengths = np.zeros(n, np.int32)
    for k, i in enumerate(rows):
        if not sc.null_mask[i]:
            _encode_value_chars(bytes_, lengths, k, str(sc.values[i]), width, kind)
    return bytes_, lengths


def _rule_key_cols(rule: str) -> list[str]:
    """The symmetric equality key columns of one blocking rule, or raise
    for shapes serving cannot index (residuals, cross-column keys, keyless
    rules)."""
    eq_pairs, residual = parse_blocking_rule(rule)
    sym, asym, residual = _split_join_keys(eq_pairs, residual)
    if residual is not None:
        raise ValueError(
            f"blocking rule {rule!r} has a non-equality residual predicate; "
            "online serving indexes pure equality conjunctions only — move "
            "the filter into the comparison columns or drop it for serving"
        )
    if asym:
        raise ValueError(
            f"blocking rule {rule!r} joins across different columns/"
            "expressions (l.a = r.b); online serving indexes symmetric "
            "keys only"
        )
    if not sym:
        raise ValueError(
            f"blocking rule {rule!r} has no equality condition (cartesian); "
            "online serving requires at least one equality key"
        )
    return sym


@dataclass
class ServeRule:
    """One blocking rule's frozen hash-bucket index."""

    rule: str
    key_cols: list[str]
    rows_sorted: np.ndarray  # (n_valid,) int32: rows grouped by bucket
    starts: np.ndarray  # (n_buckets,) int32 CSR starts into rows_sorted
    sizes: np.ndarray  # (n_buckets,) int32 bucket sizes
    row_bucket: np.ndarray  # (n_rows,) int32 bucket of each row; -1 null key
    bucket_of: dict = field(default_factory=dict)  # canonical key -> bucket

    @property
    def n_buckets(self) -> int:
        return len(self.starts)

    def query_bucket(self, key_tokens: list) -> int:
        """Bucket index for one query's canonical key tokens; -1 when any
        key is null or the combination is absent from the reference."""
        if any(t is None for t in key_tokens):
            return -1
        return self.bucket_of.get(_KEY_SEP.join(key_tokens), -1)


@dataclass
class ApproxBand:
    """One LSH band's frozen bucket index: the CSR quartet of a
    :class:`ServeRule`, so the engine gathers a band's candidates exactly
    like a blocking rule's (the cross-band dedup IS the sequential-rule
    dedup mask)."""

    rows_sorted: np.ndarray  # (n_valid,) int32
    starts: np.ndarray  # (n_buckets,) int32
    sizes: np.ndarray  # (n_buckets,) int32
    row_bucket: np.ndarray  # (n_rows,) int32; -1 = no signature
    bucket_of: dict = field(default_factory=dict)  # int band key -> bucket


@dataclass
class ApproxServe:
    """The serve fallback: minhash-LSH band buckets over the approximate
    columns. A query whose EXACT keys hit no bucket resolves its band keys
    through ``bucket_of`` and is scored against the union of its band
    buckets; its results are tagged ``approx=True``."""

    cols: list[str]
    col_meta: dict  # name -> {"width": int, "kind": "ascii"|"wide"}
    q: int
    bands: int
    rows_per_band: int
    band_index: list[ApproxBand] = field(default_factory=list)
    # the TF-weighting IDF table (minhash.idf_weights): query-side
    # signatures draw from the weights the build drew from, so it rides in
    # the artifact; None = the unweighted tier
    idf: np.ndarray | None = None


@dataclass
class QueryBatch:
    """Host-side encoded query batch, ready for the engine.

    ``qbuckets`` covers the engine's whole gather menu: one row per exact
    blocking rule, then one row per LSH band (all -1 where the query
    resolved exactly). ``approx_used`` marks the queries served through the
    fallback; None when the index has no approximate tier."""

    packed: np.ndarray  # (n, n_lanes) uint32, same layout as the index
    qbuckets: np.ndarray  # (n_gather, n) int32; -1 = no candidates
    n: int
    unique_id: np.ndarray  # (n,) query ids (positional when absent)
    approx_used: np.ndarray | None = None  # (n,) bool
    # (n_tf_fold, n) int32 query token ids for the TF fold columns (the
    # reference-vocabulary ids _pin_string_column resolved: an unseen query
    # value takes a fresh id past the vocabulary, which never agrees with a
    # reference row); None when the index has no fold data
    tf_tids: np.ndarray | None = None


class LinkageIndex:
    """Frozen serving artifact for one trained linker (module docstring)."""

    def __init__(
        self,
        *,
        settings: dict,
        dtype: str,
        lam: float,
        m: np.ndarray,
        u: np.ndarray,
        packed: np.ndarray,
        layout: dict,
        string_cols: list[str],
        numeric_cols: list[str],
        string_meta: dict,
        rules: list[ServeRule],
        unique_id: np.ndarray,
        tf_tables: dict,
        state_hash: str,
        tf_tids: dict | None = None,
        approx: ApproxServe | None = None,
        profile=None,
        device=None,
    ):
        self.settings = settings
        self.dtype = dtype  # "float32" | "float64"
        self.lam = float(lam)
        self.m = np.asarray(m)
        self.u = np.asarray(u)
        self.packed = packed
        self.layout = layout
        self.string_cols = string_cols
        self.numeric_cols = numeric_cols
        self.string_meta = string_meta  # name -> {width, kind, vocab}
        self.rules = rules
        self.unique_id = unique_id
        self.tf_tables = tf_tables  # name -> (n_tokens,) int64 counts
        # name -> (n_rows,) int32 reference token ids for the TF fold
        # (term_frequencies.tf_fold_spec columns); empty on artifacts built
        # before the fold existed, which serve unadjusted (engine warns)
        self.tf_tids = dict(tf_tids or {})
        self.state_hash = state_hash
        self.approx = approx  # the LSH fallback (None = exact only)
        # the training-reference quality profile (obs/quality.py), None on
        # profile-less artifacts; not part of content_fingerprint(): it
        # describes the training data, not the answers served
        self.profile = profile
        self.device = resolve_device(device)
        if self.device.type == "cuda" and self.device.index is None:
            # named explicitly: a serving thread must not depend on its
            # current device
            self.device = torch.device("cuda", torch.cuda.current_device())
        self._device_state = None  # memoised device-resident tensors
        self._tf_device = None  # memoised TF-fold device tensors
        self._vocab_maps: dict | None = None
        self._content_fp: str | None = None

    # ------------------------------------------------------------------
    # Introspection
    # ------------------------------------------------------------------

    @property
    def n_rows(self) -> int:
        return len(self.unique_id)

    @property
    def n_lanes(self) -> int:
        return self.packed.shape[1]

    @property
    def float_dtype(self):
        return np.float64 if self.dtype == "float64" else np.float32

    @property
    def gather_units(self) -> list:
        """The engine's candidate-gather menu: the exact blocking rules, then
        the LSH bands (each carries the same CSR quartet)."""
        units = list(self.rules)
        if self.approx is not None:
            units.extend(self.approx.band_index)
        return units

    def tf_fold_columns(self) -> list:
        """The TF u-probability fold menu this index can serve:
        ``term_frequencies.tf_fold_spec`` entries whose column has BOTH a
        count table and per-row reference token ids in the artifact."""
        from ..term_frequencies import tf_fold_spec

        return [
            (ci, name, top)
            for ci, name, top in tf_fold_spec(self.settings)
            if name in self.tf_tables and name in self.tf_tids
        ]

    def tf_device_state(self):
        """Memoised TF-fold tensors on the index's device for
        :meth:`tf_fold_columns`, in spec order: ``tid`` (per column the
        (n_rows,) int32 reference token ids) and ``log`` (the
        :func:`~..term_frequencies.tf_log_table` values cast to the
        index's float type). Uploaded once, shared by every batch."""
        if self._tf_device is None:
            from ..term_frequencies import tf_log_table

            dt = self.float_dtype
            cols = self.tf_fold_columns()
            self._tf_device = {
                "tid": tuple(
                    torch.from_numpy(np.ascontiguousarray(self.tf_tids[name], np.int32))
                    .to(self.device)
                    for _, name, _t in cols
                ),
                "log": tuple(
                    torch.from_numpy(tf_log_table(self.tf_tables[name]).astype(dt))
                    .to(self.device)
                    for _, name, _t in cols
                ),
            }
        return self._tf_device

    def content_fingerprint(self) -> str:
        """sha256 over every array a served answer depends on (packed
        matrix, per-rule CSR, TF fold data, trained parameters, dtype,
        settings hash): the reference's expression, so equal artifacts have
        equal fingerprints across packages. Memoised."""
        if self._content_fp is None:
            h = hashlib.sha256()
            h.update(self.state_hash.encode())
            h.update(self.dtype.encode())
            _hash_update_array(h, self.packed)
            for r in self.rules:
                for a in (r.rows_sorted, r.starts, r.sizes, r.row_bucket):
                    _hash_update_array(h, a)
            if self.approx is not None:
                # the approximate config, IDF table and band CSRs; an
                # exact-only index hashes as before
                ap = self.approx
                h.update(f"approx:{ap.q}:{ap.bands}:{ap.rows_per_band}:"
                         f"{','.join(ap.cols)}".encode())
                if ap.idf is not None:
                    h.update(np.ascontiguousarray(ap.idf).tobytes())
                for band in ap.band_index:
                    for a in (band.rows_sorted, band.starts, band.sizes, band.row_bucket):
                        _hash_update_array(h, a)
            if self.tf_tids:
                for name in sorted(self.tf_tids):
                    h.update(f"tf:{name}".encode())
                    h.update(np.ascontiguousarray(self.tf_tids[name]).tobytes())
                    h.update(np.ascontiguousarray(self.tf_tables[name]).tobytes())
            h.update(np.float64(self.lam).tobytes())
            h.update(np.ascontiguousarray(self.m, np.float64).tobytes())
            h.update(np.ascontiguousarray(self.u, np.float64).tobytes())
            self._content_fp = h.hexdigest()
        return self._content_fp

    def candidate_counts(self, qbuckets: np.ndarray) -> np.ndarray:
        """(n,) int64 upper-bound candidate count per query (duplicates
        across rules and bands included: the capacity the engine pads to)."""
        total = np.zeros(qbuckets.shape[1], np.int64)
        for r, unit in enumerate(self.gather_units):
            qb = qbuckets[r]
            has = qb >= 0
            total[has] += unit.sizes[qb[has]]
        return total

    # ------------------------------------------------------------------
    # Device residency
    # ------------------------------------------------------------------

    def device_state(self):
        """Memoised tensors on the index's device: the packed reference
        matrix (int32 carrying the uint32 lanes' bits, as GammaProgram
        holds it), the bucket CSR arrays of every rule and LSH band (int64,
        torch's index type) and the trained FSParams in the index's float
        type. Uploaded once, shared by every query batch for the index's
        lifetime."""
        if self._device_state is None:
            from ..models.fellegi_sunter import FSParams

            dev = self.device
            dt = self.float_dtype
            units = self.gather_units

            def up(a):
                return torch.from_numpy(np.ascontiguousarray(a, np.int64)).to(dev)

            self._device_state = {
                "packed": torch.from_numpy(
                    np.ascontiguousarray(self.packed).view(np.int32)
                ).to(dev),
                "starts": tuple(up(r.starts) for r in units),
                "sizes": tuple(up(r.sizes) for r in units),
                "rows": tuple(up(r.rows_sorted) for r in units),
                "row_bucket": tuple(up(r.row_bucket) for r in units),
                "params": FSParams(
                    lam=torch.tensor(np.asarray(self.lam, dt), device=dev),
                    m=torch.from_numpy(self.m.astype(dt)).to(dev),
                    u=torch.from_numpy(self.u.astype(dt)).to(dev),
                ),
            }
        return self._device_state

    # ------------------------------------------------------------------
    # Query-side encoding
    # ------------------------------------------------------------------

    def encode_queries(self, df) -> QueryBatch:
        """Encode a query DataFrame into the index's packed layout.

        Query records encode against the REFERENCE vocabulary: a query
        string seen in the reference takes its reference token id; unseen
        values take fresh ids past the reference vocabulary; nulls stay
        null. Char/length/numeric encoding is pinned to the reference layout
        (width, ascii/wide kind, f32/f64 lanes), so the packed query matrix
        is gather-compatible with the resident reference matrix and gammas
        are bit-identical to the offline program on shared records. With
        the approximate tier, the queries whose exact keys all missed
        resolve their LSH band keys instead (signatures are computed for
        those rows only)."""
        settings = self.settings
        uid_col = settings["unique_id_column_name"]
        if uid_col not in df.columns:
            df = df.copy()
            df[uid_col] = np.arange(len(df))
        qtable = encode_table(df, settings)
        for name in self.string_cols:
            if name not in qtable.strings:
                raise ValueError(f"query data is missing encoded column {name!r}")
            qtable.strings[name] = self._pin_string_column(
                qtable.strings[name], self.string_meta[name]
            )
        # pack_table iterates insertion order; rebuild the dicts in the
        # exact order recorded at build so lanes line up byte for byte
        qtable.strings = {
            **{n: qtable.strings[n] for n in self.string_cols},
            **{n: c for n, c in qtable.strings.items() if n not in self.string_cols},
        }
        for name in self.numeric_cols:
            if name not in qtable.numerics:
                raise ValueError(f"query data is missing numeric column {name!r}")
        qtable.numerics = {
            **{n: qtable.numerics[n] for n in self.numeric_cols},
            **{n: c for n, c in qtable.numerics.items() if n not in self.numeric_cols},
        }
        packed_q, _ = pack_table(
            qtable,
            float64=self.dtype == "float64",
            include=comparison_columns_used(settings),
            qgram_specs=qgram_specs_for(settings),
            charset_specs=charset_specs_for(settings),
            jw_specs=(),
        )
        if packed_q.shape[1] != self.n_lanes:
            raise ServeIndexError(
                f"query packing produced {packed_q.shape[1]} lanes but the "
                f"index holds {self.n_lanes} — the settings or encoding "
                "drifted from the artifact"
            )
        n_rules = len(self.rules)
        qbuckets = np.full((len(self.gather_units), len(df)), -1, np.int32)
        for r, rule in enumerate(self.rules):
            tokens = [_canonical_key_values(qtable, col) for col in rule.key_cols]
            for q in range(len(df)):
                qbuckets[r, q] = rule.query_bucket([t[q] for t in tokens])
        approx_used = None
        if self.approx is not None:
            missed = ~(qbuckets[:n_rules] >= 0).any(axis=0)
            approx_used = np.zeros(len(df), bool)
            if missed.any():
                rows = np.flatnonzero(missed)
                keys, has_sig = self._query_band_keys(qtable, rows)
                for b, band in enumerate(self.approx.band_index):
                    row = qbuckets[n_rules + b]
                    for k, q in enumerate(rows):
                        if has_sig[k]:
                            row[q] = band.bucket_of.get(int(keys[k, b]), -1)
                approx_used = missed & (qbuckets[n_rules:] >= 0).any(axis=0)
        tf_tids = None
        fold_cols = self.tf_fold_columns()
        if fold_cols:
            tf_tids = np.stack(
                [qtable.strings[name].token_ids for _, name, _t in fold_cols]
            ).astype(np.int32)
        return QueryBatch(
            packed=packed_q,
            qbuckets=qbuckets,
            n=len(df),
            unique_id=np.asarray(df[uid_col].to_numpy()),
            approx_used=approx_used,
            tf_tids=tf_tids,
        )

    def _query_band_keys(self, qtable: EncodedTable, rows: np.ndarray):
        """(keys (len(rows), bands) uint32, has_sig (len(rows),) bool) for
        the given query rows, on the index's device: every approximate
        column re-encoded at the REFERENCE width and kind, so shared values
        have the index build's gram sets."""
        from ..approx.minhash import band_key_arrays

        ap = self.approx
        columns = []
        for name in ap.cols:
            sc = qtable.strings.get(name)
            if sc is None:
                raise ValueError(f"query data is missing approx column {name!r}")
            meta = ap.col_meta[name]
            columns.append(_encode_query_bytes(sc, int(meta["width"]), meta["kind"], rows))
        return band_key_arrays(columns, ap.q, ap.bands, ap.rows_per_band, idf=ap.idf,
                               device=self.device)

    def _pin_string_column(
        self, sc: EncodedStringColumn, meta: dict
    ) -> EncodedStringColumn:
        """Re-encode a query string column against the reference layout:
        reference width, reference ascii/wide kind, reference vocabulary
        token ids (unseen values get fresh ids past the vocabulary)."""
        width = int(meta["width"])
        kind = meta["kind"]
        vocab = self._vocab_map_for(meta)
        n = len(sc.token_ids)
        n_ref = len(meta["vocab"])
        token_ids = np.full(n, -1, np.int32)
        fresh: dict[str, int] = {}
        bytes_ = np.zeros((n, width), np.uint8 if kind == "ascii" else np.uint32)
        lengths = np.zeros(n, np.int32)
        for i in range(n):
            if sc.null_mask[i]:
                continue
            v = str(sc.values[i])
            tid = vocab.get(v)
            if tid is None:
                tid = fresh.get(v)
                if tid is None:
                    tid = fresh[v] = n_ref + len(fresh)
            token_ids[i] = tid
            _encode_value_chars(bytes_, lengths, i, v, width, kind)
        return EncodedStringColumn(
            bytes_=bytes_,
            lengths=lengths,
            token_ids=token_ids,
            null_mask=sc.null_mask,
            values=sc.values,
            width=width,
        )

    def _vocab_map_for(self, meta: dict) -> dict:
        key = id(meta)
        if self._vocab_maps is None:
            self._vocab_maps = {}
        vm = self._vocab_maps.get(key)
        if vm is None:
            vm = self._vocab_maps[key] = {v: i for i, v in enumerate(meta["vocab"])}
        return vm

    # ------------------------------------------------------------------
    # Persistence
    # ------------------------------------------------------------------

    def save(self, directory: str | os.PathLike) -> str:
        """Persist the artifact: arrays first (under a fingerprint-derived
        file name), then the meta JSON as the atomic commit point. Saving
        OVER an existing artifact is crash-safe: the new arrays land in a
        fresh file, so a crash before the meta commit leaves the previous
        meta pointing at the previous (intact) arrays; superseded arrays
        files are swept only after the commit. Returns the meta path."""
        directory = os.fspath(directory)
        os.makedirs(directory, exist_ok=True)
        arrays = {"packed": self.packed}
        for r, rule in enumerate(self.rules):
            arrays[f"rule{r}_rows"] = rule.rows_sorted
            arrays[f"rule{r}_starts"] = rule.starts
            arrays[f"rule{r}_sizes"] = rule.sizes
            arrays[f"rule{r}_row_bucket"] = rule.row_bucket
        if self.approx is not None:
            for b, band in enumerate(self.approx.band_index):
                arrays[f"approx{b}_rows"] = band.rows_sorted
                arrays[f"approx{b}_starts"] = band.starts
                arrays[f"approx{b}_sizes"] = band.sizes
                arrays[f"approx{b}_row_bucket"] = band.row_bucket
            if self.approx.idf is not None:
                arrays["approx_idf"] = self.approx.idf
        for name, counts in self.tf_tables.items():
            arrays[f"tf_{name}"] = counts
        for name, tids in self.tf_tids.items():
            arrays[f"tftid_{name}"] = tids
        if self.profile is not None:
            # inside the npz payload, so arrays_sha256 (the fingerprint
            # load_index verifies) covers the profile arrays too
            arrays["profile_gamma_hist"] = self.profile.gamma_hist
            arrays["profile_score_hist"] = self.profile.score_hist
            arrays["profile_gamma_hist_matched"] = self.profile.gamma_hist_matched
            arrays["profile_score_hist_matched"] = self.profile.score_hist_matched
        if self.unique_id.dtype != object:
            arrays["unique_id"] = self.unique_id
        if any(isinstance(a, np.memmap) for a in arrays.values()):
            # out-of-core artifact: the npz streams straight to a temp file
            # in the target directory, never the whole payload in RAM
            arrays_file, fingerprint = self._save_arrays_streaming(directory, arrays)
        else:
            buf = io.BytesIO()
            np.savez_compressed(buf, **arrays)
            payload = buf.getvalue()
            fingerprint = hashlib.sha256(payload).hexdigest()
            arrays_file = f"{ARRAYS_STEM}-{fingerprint[:16]}.npz"
            atomic_write_bytes(os.path.join(directory, arrays_file), payload)
        from ..params import _jsonable_settings

        meta = {
            "version": INDEX_VERSION,
            "state_hash": self.state_hash,
            "arrays_file": arrays_file,
            "arrays_sha256": fingerprint,
            "dtype": self.dtype,
            "settings": _jsonable_settings(self.settings),
            "lam": self.lam,
            "m": self.m.tolist(),
            "u": self.u.tolist(),
            "string_cols": self.string_cols,
            "numeric_cols": self.numeric_cols,
            "string_meta": self.string_meta,
            "rules": [
                {"rule": r.rule, "key_cols": r.key_cols, "bucket_of": r.bucket_of}
                for r in self.rules
            ],
            "tf_columns": sorted(self.tf_tables),
            "tf_tid_columns": sorted(self.tf_tids),
            "approx": (
                None
                if self.approx is None
                else {
                    "cols": list(self.approx.cols),
                    "col_meta": self.approx.col_meta,
                    "q": self.approx.q,
                    "bands": self.approx.bands,
                    "rows_per_band": self.approx.rows_per_band,
                    # JSON keys are strings; band keys are uint32 ints
                    "bucket_of": [
                        {str(k): v for k, v in band.bucket_of.items()}
                        for band in self.approx.band_index
                    ],
                }
            ),
            "profile": None if self.profile is None else self.profile.to_meta(),
            "n_rows": self.n_rows,
            "unique_id_json": (
                self.unique_id.tolist() if self.unique_id.dtype == object else None
            ),
        }
        path = atomic_write_json(os.path.join(directory, META_NAME), meta)
        # post-commit sweep of superseded arrays files (best-effort: a
        # leftover costs disk, never correctness — meta names its file)
        try:
            for name in os.listdir(directory):
                if (
                    name.startswith(ARRAYS_STEM)
                    and name.endswith(".npz")
                    and name != arrays_file
                ):
                    os.unlink(os.path.join(directory, name))
        except OSError:  # pragma: no cover - sweep is best-effort
            pass
        logger.info(
            "linkage index saved: %s (%d rows, %d rules, %d approx bands, %d lanes)",
            directory, self.n_rows, len(self.rules),
            0 if self.approx is None else self.approx.bands, self.n_lanes,
        )
        return path

    @staticmethod
    def _save_arrays_streaming(directory: str, arrays: dict):
        """Write the arrays npz without holding the payload in RAM: temp
        file in the target directory, fsync, chunked sha256 of the file
        bytes, then os.replace under the fingerprint-derived name. Returns
        (arrays_file, fingerprint)."""
        import tempfile

        fd, tmp = tempfile.mkstemp(prefix=ARRAYS_STEM + ".", suffix=".tmp", dir=directory)
        try:
            with os.fdopen(fd, "wb") as fh:
                np.savez_compressed(fh, **arrays)
                fh.flush()
                os.fsync(fh.fileno())
            h = hashlib.sha256()
            with open(tmp, "rb") as fh:
                while True:
                    block = fh.read(1 << 22)
                    if not block:
                        break
                    h.update(block)
            fingerprint = h.hexdigest()
            arrays_file = f"{ARRAYS_STEM}-{fingerprint[:16]}.npz"
            os.replace(tmp, os.path.join(directory, arrays_file))
        except BaseException:
            try:
                os.unlink(tmp)
            except OSError:
                pass
            raise
        fsync_dir(directory)
        return arrays_file, fingerprint


def load_index(directory: str | os.PathLike, device=None) -> LinkageIndex:
    """Load a saved index (written by either package) onto ``device``
    (``cuda`` unless named), verifying format version, settings-hash
    binding and the array-payload fingerprint: a torn or tampered artifact
    is rejected, never served."""
    device = resolve_device(device)
    directory = os.fspath(directory)
    meta_path = os.path.join(directory, META_NAME)
    try:
        with open(meta_path, encoding="utf-8") as fh:
            meta = json.load(fh)
    except (OSError, json.JSONDecodeError) as e:
        raise ServeIndexError(f"unreadable index meta at {meta_path}: {e}") from e
    if meta.get("version") != INDEX_VERSION:
        raise IndexMismatchError(
            f"index at {directory} has format version "
            f"{meta.get('version')!r}; this build reads {INDEX_VERSION}. "
            "Rebuild the index with build_index()."
        )
    arrays_name = meta.get("arrays_file")
    if not arrays_name or os.path.sep in arrays_name:
        raise ServeIndexError(f"index meta at {meta_path} names no valid arrays file")
    arrays_path = os.path.join(directory, arrays_name)
    try:
        with open(arrays_path, "rb") as fh:
            payload = fh.read()
    except OSError as e:
        raise ServeIndexError(f"unreadable index arrays at {arrays_path}: {e}") from e
    fingerprint = hashlib.sha256(payload).hexdigest()
    if fingerprint != meta.get("arrays_sha256"):
        raise IndexMismatchError(
            f"index arrays at {arrays_path} do not match the meta "
            "fingerprint (torn write or tampering); rebuild the index"
        )
    settings = meta["settings"]
    expect = settings_state_hash(
        settings, extra={"artifact": "linkage_index", "n_rows": meta["n_rows"]}
    )
    if expect != meta.get("state_hash"):
        raise IndexMismatchError(
            f"index at {directory} was written for a different job "
            f"(settings hash {meta.get('state_hash')!r}, recomputed "
            f"{expect!r}); rebuild the index"
        )
    npz = np.load(io.BytesIO(payload), allow_pickle=False)
    rules = [
        ServeRule(
            rule=rm["rule"],
            key_cols=list(rm["key_cols"]),
            rows_sorted=npz[f"rule{r}_rows"],
            starts=npz[f"rule{r}_starts"],
            sizes=npz[f"rule{r}_sizes"],
            row_bucket=npz[f"rule{r}_row_bucket"],
            bucket_of=dict(rm["bucket_of"]),
        )
        for r, rm in enumerate(meta["rules"])
    ]
    if meta.get("unique_id_json") is not None:
        unique_id = np.asarray(meta["unique_id_json"], dtype=object)
    else:
        unique_id = npz["unique_id"]
    tf_tables = {name: npz[f"tf_{name}"] for name in meta.get("tf_columns", [])}
    # legacy artifacts carry no per-row token ids ("tf_tid_columns"
    # absent): tf_tids stays empty and the index serves unadjusted
    tf_tids = {name: npz[f"tftid_{name}"] for name in meta.get("tf_tid_columns", [])}
    approx = None
    am = meta.get("approx")
    if am is not None:
        approx = ApproxServe(
            cols=list(am["cols"]),
            col_meta=dict(am["col_meta"]),
            q=int(am["q"]),
            bands=int(am["bands"]),
            rows_per_band=int(am["rows_per_band"]),
            idf=npz["approx_idf"] if "approx_idf" in npz.files else None,
            band_index=[
                ApproxBand(
                    rows_sorted=npz[f"approx{b}_rows"],
                    starts=npz[f"approx{b}_starts"],
                    sizes=npz[f"approx{b}_sizes"],
                    row_bucket=npz[f"approx{b}_row_bucket"],
                    bucket_of={int(k): v for k, v in bo.items()},
                )
                for b, bo in enumerate(am["bucket_of"])
            ],
        )
    profile = None
    pm = meta.get("profile")
    if pm is not None:
        from ..obs.quality import QualityProfile

        files = set(npz.files)
        profile = QualityProfile.from_meta(
            pm,
            npz["profile_gamma_hist"],
            npz["profile_score_hist"],
            npz["profile_gamma_hist_matched"]
            if "profile_gamma_hist_matched" in files else None,
            npz["profile_score_hist_matched"]
            if "profile_score_hist_matched" in files else None,
        )
    index = LinkageIndex(
        settings=settings,
        dtype=meta["dtype"],
        lam=meta["lam"],
        m=np.asarray(meta["m"]),
        u=np.asarray(meta["u"]),
        packed=npz["packed"],
        layout=None,  # rebuilt below
        string_cols=list(meta["string_cols"]),
        numeric_cols=list(meta["numeric_cols"]),
        string_meta=meta["string_meta"],
        rules=rules,
        unique_id=unique_id,
        tf_tables=tf_tables,
        state_hash=meta["state_hash"],
        tf_tids=tf_tids,
        approx=approx,
        profile=profile,
        device=device,
    )
    return _attach_rebuilt_layout(index)


def _string_vocab(sc: EncodedStringColumn) -> list[str]:
    """token id -> stringified value, the factorisation the reference
    encoding committed to (token ids factorise the str() forms)."""
    vocab: list[str | None] = [None] * sc.n_tokens
    uniq, first = np.unique(sc.token_ids, return_index=True)
    for tid, idx in zip(uniq, first):
        if tid >= 0:
            vocab[int(tid)] = str(sc.values[int(idx)])
    return [v if v is not None else "" for v in vocab]


def _pack_table_out_of_core(
    table: EncodedTable,
    float64: bool,
    include,
    qgram_specs,
    charset_specs,
    build_dir: str,
    chunk_rows: int,
    state_hash: str,
    fault_plan=None,
):
    """Row-chunked, resumable pack_table: (packed memmap, layout).

    pack_table's lane LAYOUT depends only on column metadata, so packing
    ``chunk_rows``-row windows (EncodedTable.slice_rows) produces exactly
    the corresponding rows of the full matrix; each chunk streams to
    ``<build_dir>/index_build/packed.bin`` with plain buffered writes and
    commits through an atomic ``build_state.json`` watermark. A killed
    build resumes at the last committed chunk; a state file from a
    different job or shape starts fresh. Returns a read-only memmap over
    the finished file, row for row what pack_table returns resident."""
    from ..resilience import faults as _faults

    if fault_plan is None:
        fault_plan = _faults.active_plan()
    out_dir = os.path.join(os.fspath(build_dir), "index_build")
    os.makedirs(out_dir, exist_ok=True)
    n = table.n_rows
    chunk_rows = max(int(chunk_rows), 1)

    def pack(window):
        return pack_table(
            window, float64=float64, include=include,
            qgram_specs=qgram_specs, charset_specs=charset_specs, jw_specs=(),
        )

    # layout and lane count from a one-row window (a zero-row one packs a
    # float64 value into one lane instead of two)
    probe, layout = pack(table.slice_rows(0, min(n, 1)))
    n_lanes = probe.shape[1]
    data_path = os.path.join(out_dir, "packed.bin")
    state_path = os.path.join(out_dir, BUILD_STATE_NAME)
    want_state = {
        "version": BUILD_STATE_VERSION,
        "state_hash": state_hash,
        "n_rows": int(n),
        "n_lanes": int(n_lanes),
        "chunk_rows": int(chunk_rows),
        "dtype": "float64" if float64 else "float32",
    }
    chunks_done = 0
    if os.path.exists(state_path) and os.path.exists(data_path):
        try:
            with open(state_path, encoding="utf-8") as fh:
                st = json.load(fh)
            if all(st.get(k) == v for k, v in want_state.items()):
                chunks_done = int(st.get("chunks_done", 0))
        except (OSError, json.JSONDecodeError, ValueError):
            chunks_done = 0
    n_chunks = -(-n // chunk_rows) if n else 0
    chunks_done = min(chunks_done, n_chunks)
    row_bytes = n_lanes * 4
    watermark = min(chunks_done * chunk_rows, n) * row_bytes
    if chunks_done:
        try:
            have = os.path.getsize(data_path)
        except OSError:
            have = -1
        if have < watermark:
            # data shorter than the committed watermark: truncate() would
            # zero-extend the missing prefix into all-zero rows, so start
            # fresh instead
            logger.warning(
                "out-of-core build state at %s commits %d bytes but "
                "packed.bin holds %d; discarding the stale watermark and "
                "rebuilding from chunk 0", out_dir, watermark, have,
            )
            chunks_done = 0
            watermark = 0
    if chunks_done:
        logger.info(
            "out-of-core index build resumed at %s: %d/%d packed chunks "
            "committed", out_dir, chunks_done, n_chunks,
        )
    with open(data_path, "r+b" if os.path.exists(data_path) else "w+b") as fh:
        fh.truncate(watermark)  # drop any torn uncommitted tail
        fh.seek(watermark)
        for k in range(chunks_done, n_chunks):
            s, e = k * chunk_rows, min((k + 1) * chunk_rows, n)
            arr, _ = pack(table.slice_rows(s, e))
            if arr.shape[1] != n_lanes:  # pragma: no cover - layout is static
                raise ServeIndexError(
                    f"chunk {k} packed {arr.shape[1]} lanes, layout probe "
                    f"said {n_lanes}"
                )
            np.ascontiguousarray(arr).tofile(fh)
            fh.flush()
            os.fsync(fh.fileno())
            # the injection point sits between the byte append and the
            # watermark commit: the widest window a kill can tear
            fault_plan.fire("build_chunk", chunk=k)
            atomic_write_json(state_path, {**want_state, "chunks_done": k + 1})
    if n == 0:
        return np.zeros((0, n_lanes), np.uint32), layout
    packed = np.memmap(data_path, dtype=np.uint32, mode="r", shape=(n, n_lanes))
    return packed, layout


def build_index(linker, *, clear_caches: bool = True) -> LinkageIndex:
    """Freeze a trained linker into a :class:`LinkageIndex` on the linker's
    device.

    Uses the linker's current parameters (after ``estimate_parameters`` or
    a loaded model) and its encoded input table as the reference corpus.
    ``clear_caches`` releases the per-table blocking key-code caches the
    bucket build warms, which the index does not need.
    """
    settings = linker.settings
    table = linker._ensure_encoded()
    if table.n_rows == 0:
        raise ValueError("cannot build a serving index over an empty table")
    rules_text = settings.get("blocking_rules") or []
    if not rules_text:
        raise ValueError(
            "online serving requires at least one blocking rule (a keyless "
            "cartesian scan per query does not serve at low latency)"
        )
    try:
        dtype_np = linker._np_float
        float64 = dtype_np == np.float64
        lam, m, u, _ = linker.params.to_arrays(dtype=dtype_np)

        include = comparison_columns_used(settings)
        build_dir = settings.get("build_spill_dir") or None
        if build_dir:
            # out-of-core: the packed matrix streams to disk chunk by chunk
            # (bounded working set, resumable) and rides in the index as a
            # read-only memmap. Per-process root under several processes
            # (the pairs path's discipline): P processes must not race
            # truncate and append on one packed.bin, so each writes its own
            # deterministic, fingerprint-identical copy
            from ..parallel.distributed import spill_shard_dir

            packed, layout = _pack_table_out_of_core(
                table,
                float64,
                include=include,
                qgram_specs=qgram_specs_for(settings),
                charset_specs=charset_specs_for(settings),
                build_dir=spill_shard_dir(build_dir),
                chunk_rows=int(settings.get("build_spill_chunk_rows") or 1048576),
                state_hash=settings_state_hash(
                    settings,
                    extra={"artifact": "index_build", "n_rows": int(table.n_rows)},
                ),
            )
        else:
            packed, layout = pack_table(
                table,
                float64=float64,
                include=include,
                qgram_specs=qgram_specs_for(settings),
                charset_specs=charset_specs_for(settings),
                jw_specs=(),
            )
        string_cols = [n for n in table.strings if include is None or n in include]
        numeric_cols = [n for n in table.numerics if include is None or n in include]
        string_meta = {}
        for name in string_cols:
            sc = table.strings[name]
            string_meta[name] = {
                "width": int(sc.width),
                "kind": "ascii" if sc.bytes_.dtype == np.uint8 else "wide",
                "vocab": _string_vocab(sc),
            }

        # the device CSR under the reference's rule: "on" anywhere, "auto"
        # on a card; "off" (or "auto" on the CPU) takes the host argsort
        blk_mode = settings.get("device_blocking", "auto")
        device_csr = blk_mode == "on" or (
            blk_mode != "off" and linker.device.type == "cuda"
        )
        rules = [
            _build_serve_rule(
                table, rule, device=linker.device if device_csr else None
            )
            for rule in rules_text
        ]
        approx = None
        if settings.get("approx_blocking"):
            approx = _build_approx_serve(
                table, settings, linker.device, linker.device if device_csr else None)

        # the training-reference quality profile (obs/quality.py): the drift
        # observatory's baseline, captured from whichever training gammas
        # the linker still holds and published as a quality_profile event
        profile = None
        if settings.get("quality_profile"):
            from ..obs.events import publish
            from ..obs.quality import capture_profile

            profile = capture_profile(linker, table)
            if profile is None:
                import warnings

                warnings.warn(
                    "quality_profile is on but the linker holds no "
                    "training gammas (train with estimate_parameters / "
                    "get_scored_comparisons in this process before "
                    "export_index); the index ships WITHOUT a reference "
                    "profile and serve-time drift reporting will be dark."
                )
            else:
                publish("quality_profile", **profile.summary())
                linker._obs.record("quality_profile", profile.summary())

        from ..term_frequencies import term_frequency_columns, tf_fold_spec

        tf_tables = {}
        for name in term_frequency_columns(settings):
            sc = table.strings.get(name)
            if sc is not None and sc.n_tokens:
                tids = sc.token_ids
                tf_tables[name] = np.bincount(
                    tids[tids >= 0], minlength=sc.n_tokens
                ).astype(np.int64)
        # per-row reference token ids for the serve-time u-probability fold
        tf_tids = {
            name: table.strings[name].token_ids.astype(np.int32)
            for _ci, name, _top in tf_fold_spec(settings)
            if name in tf_tables
        }

        state_hash = settings_state_hash(
            settings,
            extra={"artifact": "linkage_index", "n_rows": int(table.n_rows)},
        )
        return LinkageIndex(
            settings=settings,
            dtype=np.dtype(dtype_np).name,
            lam=float(lam),
            m=np.asarray(m, np.float64),
            u=np.asarray(u, np.float64),
            packed=packed,
            layout=layout,
            string_cols=string_cols,
            numeric_cols=numeric_cols,
            string_meta=string_meta,
            rules=rules,
            unique_id=np.asarray(table.unique_id),
            tf_tables=tf_tables,
            state_hash=state_hash,
            tf_tids=tf_tids,
            approx=approx,
            profile=profile,
            device=linker.device,
        )
    finally:
        if clear_caches:
            clear_key_code_cache(table)


def _bucket_csr(codes: np.ndarray, device=None):
    """The bucket CSR over key codes: (rows_sorted, starts, sizes,
    row_bucket) int32 arrays, rows grouped by ascending code, row_bucket
    -1 for null codes. With a ``device`` it is built there
    (``blocking_device.build_bucket_csr``, equal to the host construction);
    with None, or codes past int32, by the host argsort. When every code is
    null: a 1-element dummy CSR (one empty bucket) so that device gathers
    stay in bounds; no query resolves it."""
    n = len(codes)
    csr = None
    if device is not None and n:
        from ..blocking_device import build_bucket_csr

        csr = build_bucket_csr(codes, device=device)
    if csr is None:
        rows = np.flatnonzero(codes >= 0).astype(np.int32)
        rows_sorted, _uniq, starts, sizes = _sort_groups(codes, rows)
        row_bucket = np.full(n, -1, np.int32)
        row_bucket[rows_sorted] = np.repeat(np.arange(len(starts), dtype=np.int32), sizes)
        csr = rows_sorted, starts, sizes, row_bucket
    rows_sorted, starts, sizes, row_bucket = csr
    if len(starts) == 0:
        return (np.zeros(1, np.int32), np.zeros(1, np.int32), np.zeros(1, np.int32),
                np.full(n, -1, np.int32))
    return (rows_sorted.astype(np.int32), starts.astype(np.int32), sizes.astype(np.int32),
            row_bucket)


def _build_serve_rule(table: EncodedTable, rule: str, device=None) -> ServeRule:
    """One rule's frozen bucket index from the key codes blocking joins on.
    With a ``device`` the bucket CSR (rows_sorted/starts/sizes/row_bucket)
    is built there (``blocking_device.build_bucket_csr``, equal to the host
    construction); with None, or codes past int32, by the host argsort. The
    host keeps the O(buckets) representative-token dict loop either way."""
    key_cols = _rule_key_cols(rule)
    rows_sorted, starts, sizes, row_bucket = _bucket_csr(_key_codes(table, key_cols), device)
    if len(starts) == 1 and sizes[0] == 0:  # every key null: the dummy CSR
        return ServeRule(rule=rule, key_cols=key_cols, rows_sorted=rows_sorted,
                         starts=starts, sizes=sizes, row_bucket=row_bucket)
    # host-side key -> bucket dictionary from one representative row per
    # bucket, via the same canonicalisation queries resolve through
    reps = rows_sorted[starts]
    col_tokens = [_canonical_key_values(table, c) for c in key_cols]
    bucket_of: dict[str, int] = {}
    for b, rep in enumerate(reps):
        tokens = [t[rep] for t in col_tokens]
        if any(tok is None for tok in tokens):  # pragma: no cover - codes>=0
            continue
        key = _KEY_SEP.join(tokens)
        if key in bucket_of:
            raise ValueError(
                f"blocking rule {rule!r}: two key groups canonicalise to "
                f"the same serving key {key!r}; this key type cannot be "
                "indexed for online serving"
            )
        bucket_of[key] = b
    return ServeRule(
        rule=rule,
        key_cols=key_cols,
        rows_sorted=rows_sorted,
        starts=starts,
        sizes=sizes,
        row_bucket=row_bucket,
        bucket_of=bucket_of,
    )


def _build_approx_serve(table: EncodedTable, settings: dict, device, csr_device=None):
    """The index's LSH fallback: band-key bucket CSRs over the approximate
    columns (the offline tier's band keys, computed on ``device``), or None
    when no approximate column exists; the CSRs are built on ``csr_device``
    (:func:`_bucket_csr`). A bucket wider than ``lsh.MAX_BUCKET_ROWS`` stays in its
    CSR (the cross-band dedup reads row_bucket) but is left out of the
    dictionary, so a query never resolves it: the contract the offline
    tier keeps by nulling such buckets."""
    from ..approx.lsh import MAX_BUCKET_ROWS, ApproxConfig, compute_band_codes

    cfg = ApproxConfig.from_settings(settings, table)
    if cfg is None:
        return None
    band_codes, uniq_keys, idf = compute_band_codes(table, cfg, device=device)
    col_meta = {
        name: {"width": int(table.strings[name].width),
               "kind": "ascii" if table.strings[name].bytes_.dtype == np.uint8 else "wide"}
        for name in cfg.cols
    }
    bands = []
    for b in range(cfg.bands):
        rows_sorted, starts, sizes, row_bucket = _bucket_csr(band_codes[b], csr_device)
        # the codes factorise the band keys (every code 0..K-1 present), so
        # bucket k holds code k, in ascending band-key order; an empty
        # band's dummy bucket has no key
        bucket_of = {int(uniq_keys[b][k]): int(k) for k in range(len(uniq_keys[b]))
                     if sizes[k] <= MAX_BUCKET_ROWS}
        bands.append(ApproxBand(rows_sorted=rows_sorted, starts=starts, sizes=sizes,
                                row_bucket=row_bucket, bucket_of=bucket_of))
    return ApproxServe(cols=list(cfg.cols), col_meta=col_meta, q=cfg.q, bands=cfg.bands,
                       rows_per_band=cfg.rows_per_band, band_index=bands, idf=idf)


def _layout_rebuild_table(index: LinkageIndex) -> EncodedTable:
    """A one-row EncodedTable (one null row) with the index's column
    structure, enough for pack_table to reproduce the lane layout. The
    reference rebuilds from zero rows, where pack_table counts one lane
    for a float64 value instead of two, so the reference cannot load a
    float64 index with a numeric column; one row can."""
    table = EncodedTable(n_rows=1, unique_id=np.zeros(1, np.int64))
    for name in index.string_cols:
        meta = index.string_meta[name]
        w = int(meta["width"])
        dt = np.uint8 if meta["kind"] == "ascii" else np.uint32
        table.strings[name] = EncodedStringColumn(
            bytes_=np.zeros((1, w), dt),
            lengths=np.zeros(1, np.int32),
            token_ids=np.full(1, -1, np.int32),
            null_mask=np.ones(1, bool),
            values=np.full(1, None, object),
            width=w,
        )
    for name in index.numeric_cols:
        table.numerics[name] = EncodedNumericColumn(
            values_f64=np.zeros(1, np.float64),
            null_mask=np.ones(1, bool),
            values=np.full(1, None, object),
        )
    return table


def _attach_rebuilt_layout(index: LinkageIndex) -> LinkageIndex:
    """Rebuild a loaded index's lane layout from its column structure;
    raises when it does not match the stored packed matrix."""
    settings = index.settings
    probe, layout = pack_table(
        _layout_rebuild_table(index),
        float64=index.dtype == "float64",
        include=comparison_columns_used(settings),
        qgram_specs=qgram_specs_for(settings),
        charset_specs=charset_specs_for(settings),
        jw_specs=(),
    )
    if probe.shape[1] != index.n_lanes:
        raise IndexMismatchError(
            f"rebuilt layout has {probe.shape[1]} lanes but the stored "
            f"packed matrix has {index.n_lanes}; the artifact does not "
            "match this build's packing"
        )
    index.layout = layout
    return index
