"""Columnar data encoding: pandas/dict input -> device-ready arrays.

The reference keeps data as Spark DataFrames and pushes strings through JVM
UDFs per row. This package instead encodes every compared column ONCE,
host-side, into fixed-width device arrays:

  * string columns  -> (n, width) uint8 codepoint arrays + int32 lengths,
                       plus factorised int32 token ids (for exact comparison
                       and term-frequency adjustment) and a bool null mask
  * numeric columns -> float64 values + bool null mask

Candidate pairs are then just int32 index arrays into these columns; gathers
happen on device, so the host never materialises the quadratic pair table.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from .utils.profiling import span

DEFAULT_STRING_WIDTH = 24


def _pad_width(n: int, multiple: int = 8) -> int:
    return max(((n + multiple - 1) // multiple) * multiple, multiple)


@dataclass
class EncodedStringColumn:
    bytes_: np.ndarray  # (n, width) uint8, zero padded
    lengths: np.ndarray  # (n,) int32 byte lengths (post truncation)
    token_ids: np.ndarray  # (n,) int32 factorised codes, -1 for null
    null_mask: np.ndarray  # (n,) bool
    values: np.ndarray  # (n,) object: original strings (None for null)
    width: int

    @property
    def n_tokens(self) -> int:
        return int(self.token_ids.max()) + 1 if len(self.token_ids) else 0


@dataclass
class EncodedNumericColumn:
    values_f64: np.ndarray  # (n,) float64, 0 where null
    null_mask: np.ndarray  # (n,) bool
    values: np.ndarray  # (n,) object: original values (None for null)


@dataclass
class EncodedTable:
    """All encoded columns for one (possibly concatenated) input table."""

    n_rows: int
    unique_id: np.ndarray  # (n,) original ids (any comparable dtype)
    strings: dict[str, EncodedStringColumn] = field(default_factory=dict)
    numerics: dict[str, EncodedNumericColumn] = field(default_factory=dict)
    raw: dict[str, np.ndarray] = field(default_factory=dict)  # passthrough cols
    source_table: np.ndarray | None = None  # (n,) int8 0/1 for link_and_dedupe

    def column_values(self, name: str) -> np.ndarray:
        if name in self.strings:
            return self.strings[name].values
        if name in self.numerics:
            return self.numerics[name].values
        return self.raw[name]

    def is_null(self, name: str) -> np.ndarray:
        if name in self.strings:
            return self.strings[name].null_mask
        if name in self.numerics:
            return self.numerics[name].null_mask
        # raw passthrough columns keep pandas' NaN for missing values — a
        # bare `is None` check would let NaN through as a "known" value
        import pandas as pd

        return pd.isna(pd.Series(self.raw[name])).to_numpy()

    def string_ranks(self, name: str) -> tuple[np.ndarray, np.ndarray]:
        """(ranks, sorted_vocab) for a string column: ranks is (n,) float64 —
        the value's index in the lexicographically sorted vocabulary, NaN for
        null. Rank comparisons are then order-isomorphic to string
        comparisons, so residual blocking predicates evaluate on numeric
        arrays instead of object arrays. Cached per column."""
        cache = getattr(self, "_rank_cache", None)
        if cache is None:
            cache = self._rank_cache = {}
        if name not in cache:
            col = self.strings[name]
            null = col.null_mask
            vals = np.array(
                ["" if v is None else str(v) for v in col.values], dtype=object
            )
            vocab, inv = np.unique(vals[~null], return_inverse=True)
            ranks = np.full(len(vals), np.nan)
            ranks[~null] = inv.astype(np.float64)
            cache[name] = (ranks, vocab)
        return cache[name]

    def slice_rows(self, start: int, stop: int) -> "EncodedTable":
        """A shallow row-window view [start, stop) of every encoded column.

        Column-level metadata (widths, ascii/wide kinds, token-id
        vocabularies) is row-independent, so packing a window through
        ``gammas.pack_table`` yields exactly the corresponding rows of the
        full table's packed matrix — the property the out-of-core index
        build relies on to stream the reference matrix to disk chunk by
        chunk with an O(chunk) working set instead of materialising all
        ``n_rows x n_lanes`` at once. Slices are numpy views: no column
        data is copied."""
        sl = slice(start, stop)
        out = EncodedTable(
            n_rows=len(self.unique_id[sl]),
            unique_id=self.unique_id[sl],
            source_table=(
                None if self.source_table is None else self.source_table[sl]
            ),
        )
        for name, sc in self.strings.items():
            out.strings[name] = EncodedStringColumn(
                bytes_=sc.bytes_[sl],
                lengths=sc.lengths[sl],
                token_ids=sc.token_ids[sl],
                null_mask=sc.null_mask[sl],
                values=sc.values[sl],
                width=sc.width,
            )
        for name, nc in self.numerics.items():
            out.numerics[name] = EncodedNumericColumn(
                values_f64=nc.values_f64[sl],
                null_mask=nc.null_mask[sl],
                values=nc.values[sl],
            )
        for name, vals in self.raw.items():
            out.raw[name] = vals[sl]
        return out


def _to_object_array(values) -> np.ndarray:
    import pandas as pd

    s = pd.Series(values)
    out = s.to_numpy(dtype=object, copy=True)
    out[pd.isna(s).to_numpy()] = None
    return out


def _is_string_dtype(dtype) -> bool:
    """True only for GENUINE string dtypes (pandas StringDtype or an arrow
    string/large_string) — NOT object, which may hold anything and must go
    through the stringify-per-row path (pd.api.types.is_string_dtype is
    deliberately avoided: it answers True for object)."""
    import pandas as pd

    if isinstance(dtype, pd.StringDtype):
        return True
    arrow_dtype = getattr(pd, "ArrowDtype", None)
    if arrow_dtype is not None and isinstance(dtype, arrow_dtype):
        try:
            import pyarrow as pa

            t = dtype.pyarrow_dtype
            return pa.types.is_string(t) or pa.types.is_large_string(t)
        except Exception:  # noqa: BLE001 - absent/odd pyarrow: slow path
            return False
    return False


def encode_string_column(values, width: int = DEFAULT_STRING_WIDTH) -> EncodedStringColumn:
    """Encode a string column into fixed-width codepoint arrays + token ids.

    ASCII-only columns use uint8; columns with any non-ASCII value use uint32
    Unicode codepoints so lengths and equality are *character*-level, matching
    the reference's JVM string functions. Values longer than ``width``
    contribute only their first ``width`` characters to similarity kernels;
    token ids still distinguish full values, so exact comparison and TF
    adjustment are unaffected by truncation.
    """
    # Factorise FIRST, char-encode the UNIQUES ONLY, then gather per-row
    # arrays by code: every python-level string pass shrinks from n rows
    # to V distinct values, and for true string dtypes (arrow-backed or
    # pandas StringDtype) pd.factorize runs natively with no object
    # conversion at all. At 10M rows this is the difference between the
    # encode being a quarter of the <60s BASELINE budget and a footnote.
    # Token semantics are unchanged: ids factorise the STRINGIFIED values
    # (distinct str() forms), so mixed-type object columns (123 vs "123"
    # vs 123.0, unhashable cells) stringify per row first, exactly as
    # before — only genuinely-string columns skip that pass.
    with span("factorize"):
        raw_codes, uobj, obj = _factorize(values)
    n = len(raw_codes)
    null_mask = raw_codes < 0
    token_ids = raw_codes  # -1 for null; ids = distinct str() forms

    with span("pack"):
        ubytes, ulengths, width = _pack_uniques(uobj, width)

    with span("gather"):
        safe_codes = np.where(null_mask, 0, raw_codes)
        if len(ubytes):
            bytes_ = ubytes[safe_codes]
            lengths = ulengths[safe_codes]
            if null_mask.any():
                bytes_[null_mask] = 0
                lengths = np.where(null_mask, 0, lengths).astype(np.int32)
        else:  # no uniques: every row is null (or n == 0)
            bytes_ = np.zeros((n, width), np.uint8)
            lengths = np.zeros(n, np.int32)

        if obj is None:  # string-dtype fast path: originals ARE the uniques
            obj = np.empty(n, dtype=object)
            if not null_mask.all():
                nz = ~null_mask
                obj[nz] = uobj[raw_codes[nz]]
    return EncodedStringColumn(
        bytes_=bytes_,
        lengths=lengths,
        token_ids=token_ids,
        null_mask=null_mask,
        values=obj,
        width=width,
    )


def _factorize(values):
    """(int32 codes with -1 for null, object uniques, the original-value
    object array or None where the uniques are the originals) of a string
    column: natively for a string dtype, else over the stringified
    values."""
    import pandas as pd

    ser = values if isinstance(values, pd.Series) else pd.Series(values)
    obj = None  # original-value object array; None until needed
    if _is_string_dtype(ser.dtype):
        raw_codes, raw_uniques = pd.factorize(ser, use_na_sentinel=True)
        uobj = np.asarray(raw_uniques, dtype=object)
    else:
        obj = _to_object_array(values)
        if all(isinstance(v, str) or v is None for v in obj):
            raw_codes, raw_uniques = pd.factorize(
                pd.Series(obj, dtype=object), use_na_sentinel=True
            )
        else:
            strs_obj = np.array(
                [None if v is None else str(v) for v in obj], dtype=object
            )
            raw_codes, raw_uniques = pd.factorize(
                pd.Series(strs_obj, dtype=object), use_na_sentinel=True
            )
        uobj = np.asarray(raw_uniques, dtype=object)
    return raw_codes.astype(np.int32), uobj, obj


def _pack_uniques(uobj, width: int):
    """(chars, lengths, width) of the distinct values: uint8 from the native
    packer where every value is ASCII, else uint32 codepoints."""
    ustrs = [str(v) for v in uobj]
    ulens = np.fromiter(map(len, ustrs), np.int64, count=len(ustrs))
    # Width = observed max length rounded up to 8, capped by the configured
    # budget — short name columns then pad to 8 chars instead of 24, which
    # directly scales the O(width^2) similarity-kernel cost.
    max_len = max(int(ulens.max()) if len(ulens) else 0, 1)
    width = min(_pad_width(max_len), _pad_width(width))
    ascii_only = all(map(str.isascii, ustrs))  # C-level, short-circuits
    if ascii_only:
        # flat buffer + offsets, packed by the native host library
        from . import native

        flat = np.frombuffer("".join(ustrs).encode("ascii"), dtype=np.uint8)
        offsets = np.zeros(len(ustrs) + 1, np.int64)
        np.cumsum(ulens, out=offsets[1:])
        ubytes, ulengths = native.encode_fixed_width(flat, offsets, width)
    else:
        ubytes = np.zeros((len(ustrs), width), dtype=np.uint32)
        ulengths = np.zeros(len(ustrs), dtype=np.int32)
        for i, v in enumerate(ustrs):
            if not v:
                continue
            chars = v[:width]
            ubytes[i, : len(chars)] = np.array(
                [ord(c) for c in chars], dtype=np.uint32
            )
            ulengths[i] = len(chars)
    return ubytes, ulengths, width


def encode_numeric_column(values) -> EncodedNumericColumn:
    import pandas as pd

    obj = _to_object_array(values)
    null_mask = np.array([v is None for v in obj], dtype=bool)
    s = pd.to_numeric(pd.Series(values), errors="coerce")
    # copy=True: the default can return a read-only pandas-backed view
    f = np.array(s.fillna(0.0).to_numpy(np.float64))
    # Rows to_numeric refused but float() accepts (e.g. the string 'nan')
    # keep their float value; anything neither parses is a real error.
    for i in np.flatnonzero(s.isna().to_numpy() & ~null_mask):
        try:
            v = float(obj[i])
        except (TypeError, ValueError):
            raise ValueError(
                f"numeric column contains unparseable value {obj[i]!r} at row {i}"
            ) from None
        f[i] = v
    return EncodedNumericColumn(values_f64=f, null_mask=null_mask, values=obj)


def _columns_needed(settings: dict) -> tuple[dict[str, str], list[str]]:
    """-> ({column_name: data_type}, passthrough_columns)."""
    import re

    typed: dict[str, str] = {}
    for col in settings["comparison_columns"]:
        if "col_name" in col:
            typed[col["col_name"]] = col.get("data_type", "string")
        # usage-inferred types from a compiled CASE expression take
        # precedence over the blanket string default for custom columns
        for extra, typ in col.get("comparison", {}).get("column_types", {}).items():
            typed.setdefault(extra, typ)
        for extra in col.get("custom_columns_used", []):
            typed.setdefault(extra, "string")
        for extra in col.get("comparison", {}).get("other_columns", []):
            typed.setdefault(extra, "string")
    passthrough = [
        c for c in settings.get("additional_columns_to_retain", []) if c not in typed
    ]
    # Columns referenced only by blocking rules (join keys / predicates)
    for rule in settings.get("blocking_rules") or []:
        for ref in re.findall(r"\b[lr]\.(\w+)", rule):
            if ref not in typed and ref not in passthrough:
                passthrough.append(ref)
    return typed, passthrough


def _phonetic_columns_needed(settings: dict) -> set[str]:
    """Columns whose double-metaphone encoding is compared or blocked on,
    via the 'dmetaphone' comparison kind or ``dmetaphone(l.col)`` blocking
    terms (the reference's DoubleMetaphone-UDF use cases,
    tests/test_spark.py:48)."""
    import re

    need: set[str] = set()
    for col in settings["comparison_columns"]:
        spec = col.get("comparison") or {}
        need.update(spec.get("phonetic_columns", []))
        if spec.get("kind") == "dmetaphone":
            name = (
                col.get("col_name")
                or spec.get("column")
                or (col.get("custom_columns_used") or [None])[0]
            )
            if name:
                need.add(name)
    for rule in settings.get("blocking_rules") or []:
        for ref in re.findall(r"(?i)\bdmetaphone\(\s*[lr]\.(\w+)\s*\)", rule):
            need.add(ref)
    return need


def phonetic_column_name(col: str) -> str:
    return f"__dm_{col}"


def encode_table(df, settings: dict, source_table: np.ndarray | None = None) -> EncodedTable:
    """Encode the columns of a pandas DataFrame needed by ``settings``."""
    uid_col = settings["unique_id_column_name"]
    if uid_col not in df.columns:
        raise ValueError(f"Input data is missing unique id column {uid_col!r}")

    typed, passthrough = _columns_needed(settings)
    widths = {
        col.get("col_name"): col.get("max_string_length", DEFAULT_STRING_WIDTH)
        for col in settings["comparison_columns"]
    }

    table = EncodedTable(
        n_rows=len(df),
        unique_id=df[uid_col].to_numpy(),
        source_table=source_table,
    )
    for name, dtype in typed.items():
        if name not in df.columns:
            raise ValueError(f"Input data is missing comparison column {name!r}")
        with span("column", column=name):
            if dtype == "numeric":
                table.numerics[name] = encode_numeric_column(df[name])
            else:
                table.strings[name] = encode_string_column(
                    df[name], widths.get(name, DEFAULT_STRING_WIDTH)
                )
    for name in passthrough:
        if name not in df.columns:
            raise ValueError(f"Input data is missing retained column {name!r}")
        table.raw[name] = df[name].to_numpy()

    # Derived phonetic columns: double-metaphone codes computed on the host,
    # then compared on device as ordinary token ids.
    for name in _phonetic_columns_needed(settings):
        if name not in df.columns:
            raise ValueError(f"Input data is missing phonetic column {name!r}")
        table.strings[phonetic_column_name(name)] = encode_string_column(
            double_metaphone_codes(df[name])
        )
    return table


def double_metaphone_codes(values) -> list:
    """The primary double-metaphone code of each row's ``str(v)``, None for
    a null row: splink_tpu's per-row codes, encoded once per distinct value
    and mapped back to the rows."""
    import pandas as pd

    from .ops.phonetic import double_metaphone_primary

    src = _to_object_array(values)
    strs = pd.Series([None if v is None else str(v) for v in src], dtype=object)
    codes, uniques = pd.factorize(strs, use_na_sentinel=True)
    enc = np.array([double_metaphone_primary(u) for u in uniques] + [None], dtype=object)
    return enc[codes].tolist()  # code -1 (null) takes the trailing None


def concat_tables(df_l, df_r, settings: dict) -> EncodedTable:
    """Vertically concatenate two inputs with a _source_table tag (0 = left,
    1 = right), the link-type preparation step
    (splink/blocking.py:70-93). Encodes the combined frame so
    token ids share one vocabulary across both inputs."""
    import pandas as pd

    combined = pd.concat([df_l, df_r], ignore_index=True)
    source = np.concatenate(
        [np.zeros(len(df_l), np.int8), np.ones(len(df_r), np.int8)]
    )
    return encode_table(combined, settings, source_table=source)
