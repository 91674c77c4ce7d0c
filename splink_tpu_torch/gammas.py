"""Comparison-vector (gamma) computation: settings spec -> int8 gamma matrix.

The torch counterpart of splink_tpu/gammas.py. Encoded columns are packed
host-side into ONE (n_rows, n_lanes) 32-bit matrix (chars, lengths, token
ids, bitcast numerics and the two-phase Jaro-Winkler bound lanes side by
side) and moved to the device once; each pair batch then costs two row
gathers, and fields are unpacked on the device with dtype views and
shifts.

Ported comparison kinds: exact, jaro_winkler (two-phase and exact),
levenshtein, numeric_abs, numeric_perc and name_inversion. qgram_*,
dmetaphone, case_sql and custom raise NotImplementedError, as do the
pattern-id pipeline, GammaStream and PatternStream (ROADMAP.md).

Two-phase Jaro-Winkler: the reference reserves a fixed survivor capacity
per batch and redoes an overflowing batch with the exact body, because XLA
needs static shapes. Here the kernel runs on exactly the survivors. On the
card that is one masked launch over the whole batch (the kernel reads the
survivor mask and writes 0 elsewhere), so nothing waits on the host and no
rows are gathered or scattered; on the CPU the survivors are compacted
with ``torch.nonzero`` and the plain version runs on those rows. The gamma
matrix is bit-identical to both of the reference's bodies either way.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ._device import resolve_device
from .data import EncodedTable
from .ops import jw_bound
from .ops import numeric as numeric_ops
from .ops import strings as string_ops
from .ops.gamma import (
    GAMMA_DTYPE,
    apply_null,
    bucket_difference,
    bucket_difference_le,
    bucket_similarity,
)

DEFAULT_PAIR_BATCH = 1 << 20

PORTED_KINDS = (
    "exact", "jaro_winkler", "levenshtein", "numeric_abs", "numeric_perc",
    "name_inversion",
)


@dataclass
class PairColumn:
    """Both sides of one column for a batch of pairs (device tensors)."""

    chars_l: torch.Tensor | None = None  # (b, width) uint8 / int32 codepoints
    chars_r: torch.Tensor | None = None
    len_l: torch.Tensor | None = None  # (b,) int32
    len_r: torch.Tensor | None = None
    tok_l: torch.Tensor | None = None  # (b,) int32 (-1 null)
    tok_r: torch.Tensor | None = None
    num_l: torch.Tensor | None = None  # (b,) float
    num_r: torch.Tensor | None = None
    null: torch.Tensor | None = None  # (b,) bool: either side null
    null_l: torch.Tensor | None = None
    null_r: torch.Tensor | None = None


class _StringField:
    __slots__ = ("kind", "width", "chars", "len_lane", "tok_lane")

    def __init__(self, kind, width, chars, len_lane, tok_lane):
        self.kind = kind  # "ascii" (4 chars/lane) | "wide" (1 codepoint/lane)
        self.width = width
        self.chars = chars  # lane slice
        self.len_lane = len_lane
        self.tok_lane = tok_lane


class _NumericField:
    __slots__ = ("val", "f64", "null_lane", "null_bit")

    def __init__(self, val, f64, null_lane, null_bit):
        self.val = val  # lane slice (1 lane f32, 2 lanes f64)
        self.f64 = f64
        self.null_lane = null_lane
        self.null_bit = null_bit


class _JwBoundField:
    __slots__ = ("counts", "pref_lane")

    def __init__(self, counts, pref_lane):
        self.counts = counts  # lane slice, 4 lanes
        self.pref_lane = pref_lane


def _jw_key(name: str) -> str:
    return f"\x00jwbound:{name}"


def _comparison_input_column(col_settings: dict) -> str | None:
    """The encoded column a comparison column reads: ``col_name``, else the
    comparison spec's ``column``, else the first ``custom_columns_used``."""
    spec = col_settings.get("comparison") or {}
    name = col_settings.get("col_name") or spec.get("column")
    if name is None:
        name = (col_settings.get("custom_columns_used") or [None])[0]
    return name


def check_kinds_ported(settings: dict) -> None:
    for c in settings["comparison_columns"]:
        kind = (c.get("comparison") or {}).get("kind")
        if kind not in PORTED_KINDS:
            item = {
                "qgram_jaccard": "qgram and dmetaphone kinds",
                "qgram_cosine": "qgram and dmetaphone kinds",
                "dmetaphone": "qgram and dmetaphone kinds",
                "case_sql": "case_compiler",
            }.get(kind, "custom comparison kernels")
            raise NotImplementedError(
                f"comparison kind {kind!r} is not ported to splink_tpu_torch "
                f"yet (ROADMAP.md, {item!r}); ported kinds: {PORTED_KINDS}"
            )


def jw_specs_for(settings: dict) -> tuple[str, ...]:
    """Columns whose JW-bound aux lanes ride in the packed table: every
    thresholded jaro_winkler comparison's input column."""
    cols: dict[str, None] = {}
    for c in settings["comparison_columns"]:
        spec = c.get("comparison") or {}
        if spec.get("kind") == "jaro_winkler" and spec.get("thresholds"):
            name = _comparison_input_column(c)
            if name:
                cols.setdefault(name)
    return tuple(cols)


def comparison_columns_used(settings: dict) -> set[str]:
    """Encoded-column names the gamma program reads."""
    used: set[str] = set()
    for col in settings["comparison_columns"]:
        spec = col.get("comparison") or {}
        name = _comparison_input_column(col)
        if name:
            used.add(name)
        used.update(spec.get("other_columns", []))
    return used


def pack_table(table: EncodedTable, float64: bool = False, include=None,
               jw_specs=()):
    """Pack encoded columns into one (n_rows, n_lanes) uint32 matrix, lane
    for lane the layout of splink_tpu's ``pack_table``: per string column
    its chars (width/4 lanes ASCII, width lanes wide), a length lane and a
    token-id lane; the JW-bound aux lanes; numeric values (one f32 or two
    f64 lanes) with their null bits packed 32 per lane at the end.

    Returns (packed uint32 ndarray, {name: field layout})."""
    n = table.n_rows
    lanes: list[np.ndarray] = []
    layout: dict[str, object] = {}
    cursor = 0

    def add(arr: np.ndarray) -> slice:
        nonlocal cursor
        k = arr.size // n if n else (arr.shape[1] if arr.ndim > 1 else 1)
        lanes.append(np.ascontiguousarray(arr).reshape(n, k))
        s = slice(cursor, cursor + k)
        cursor += k
        return s

    for name, sc in table.strings.items():
        if include is not None and name not in include:
            continue
        if sc.bytes_.dtype == np.uint8:
            w = sc.width
            padded = np.zeros((n, -(-w // 4) * 4), np.uint8)
            padded[:, :w] = sc.bytes_
            chars = add(padded.view(np.uint32))
            kind = "ascii"
        else:
            chars = add(sc.bytes_.astype(np.uint32))
            kind = "wide"
        len_lane = add(sc.lengths.astype(np.int32).view(np.uint32)).start
        tok_lane = add(sc.token_ids.astype(np.int32).view(np.uint32)).start
        layout[name] = _StringField(kind, sc.width, chars, len_lane, tok_lane)

    for jname in jw_specs:
        sc = table.strings.get(jname)
        if sc is None or (include is not None and jname not in include):
            continue
        cnt, pref = jw_bound.jw_bound_row_aux(sc.bytes_, sc.lengths, sc.token_ids)
        layout[_jw_key(jname)] = _JwBoundField(add(cnt), add(pref).start)

    num_names = [c for c in table.numerics if include is None or c in include]
    null_words = np.zeros((n, max(1, (len(num_names) + 31) // 32)), np.uint32)
    num_fields = {}
    for i, name in enumerate(num_names):
        nc = table.numerics[name]
        if float64:
            vals = np.ascontiguousarray(nc.values_f64).view(np.uint32)
        else:
            vals = nc.values_f64.astype(np.float32).view(np.uint32)
        num_fields[name] = add(vals)
        null_words[:, i // 32] |= nc.null_mask.astype(np.uint32) << (i % 32)
    if num_names:
        null_slice = add(null_words)
        for i, name in enumerate(num_names):
            layout[name] = _NumericField(
                num_fields[name], float64, null_slice.start + i // 32, i % 32
            )

    if not lanes:
        return np.zeros((n, 1), np.uint32), layout
    return np.concatenate(lanes, axis=1), layout


class PairContext:
    """Per-column unpack context over the two gathered row blocks (int32
    tensors carrying the packed lanes' bit patterns)."""

    def __init__(self, layout: dict, rows_l, rows_r):
        self._layout = layout
        self._rows_l = rows_l
        self._rows_r = rows_r

    def _string_side(self, f: _StringField, rows):
        lanes = rows[:, f.chars].contiguous()
        if f.kind == "ascii":
            # the lanes' little-endian bytes, as numpy's .view(np.uint32)
            # packed them
            chars = lanes.view(torch.uint8)[:, : f.width].contiguous()
        else:
            chars = lanes
        return chars, rows[:, f.len_lane].contiguous(), rows[:, f.tok_lane]

    def _numeric_side(self, f: _NumericField, rows):
        lanes = rows[:, f.val].contiguous()
        val = lanes.view(torch.float64 if f.f64 else torch.float32)[:, 0]
        null = ((rows[:, f.null_lane] >> f.null_bit) & 1) == 1
        return val, null

    def jw_aux(self, name: str):
        """Per-side JW-bound aux ((counts, prefix) each side), or None."""
        f = self._layout.get(_jw_key(name))
        if f is None:
            return None
        return tuple(
            (rows[:, f.counts], rows[:, f.pref_lane])
            for rows in (self._rows_l, self._rows_r)
        )

    def col(self, name: str) -> PairColumn:
        f = self._layout[name]
        out = PairColumn()
        if isinstance(f, _StringField):
            out.chars_l, out.len_l, out.tok_l = self._string_side(f, self._rows_l)
            out.chars_r, out.len_r, out.tok_r = self._string_side(f, self._rows_r)
            out.null_l = out.tok_l < 0
            out.null_r = out.tok_r < 0
        else:
            out.num_l, out.null_l = self._numeric_side(f, self._rows_l)
            out.num_r, out.null_r = self._numeric_side(f, self._rows_r)
        out.null = out.null_l | out.null_r
        return out


def _align_chars(a, b):
    """Zero-pad two (b, w) char tensors to one width and one dtype (columns
    may be encoded at different widths, ASCII or wide)."""
    width = max(a.shape[1], b.shape[1])
    if a.dtype != b.dtype:
        a, b = a.to(torch.int32), b.to(torch.int32)
    pad = lambda x: torch.nn.functional.pad(x, (0, width - x.shape[1]))  # noqa: E731
    return pad(a).contiguous(), pad(b).contiguous()


def _survivor_levels_masked(pc: PairColumn, surv, thresholds):
    """Levels of the survivors, 0 elsewhere, from one masked Jaro-Winkler
    launch over the whole batch (the card's form)."""
    sim = string_ops.jaro_winkler(
        pc.chars_l, pc.chars_r, pc.len_l, pc.len_r, 0.1, 0.7, mask=surv
    )
    return torch.where(surv, bucket_similarity(sim, thresholds, None), 0)


def _survivor_levels_compacted(pc: PairColumn, surv, thresholds):
    """The same levels with the survivors compacted first (the CPU's form:
    the plain version then runs on those rows only)."""
    pos = torch.nonzero(surv).squeeze(1)
    sim = string_ops.jaro_winkler(
        pc.chars_l[pos], pc.chars_r[pos], pc.len_l[pos], pc.len_r[pos], 0.1, 0.7
    )
    lvl = torch.zeros(surv.shape, dtype=GAMMA_DTYPE, device=surv.device)
    lvl[pos] = bucket_similarity(sim, thresholds, None)
    return lvl


def _survivor_levels(pc: PairColumn, surv, thresholds):
    if surv.is_cuda:
        return _survivor_levels_masked(pc, surv, thresholds)
    return _survivor_levels_compacted(pc, surv, thresholds)


def _jw_two_phase(pc: PairColumn, aux, thresholds):
    """Two-phase Jaro-Winkler gamma (splink_tpu gammas._jw_two_phase): the
    sound upper bound excludes pairs below the lowest threshold, token-equal
    pairs take their level without a kernel, and the exact kernel runs on
    the survivors only."""
    (cl, pl), (cr, pr) = aux
    ub = jw_bound.jw_upper_bound(cl, pl, cr, pr, pc.len_l, pc.len_r, 0.1, 0.7)
    lowest = torch.tensor(
        min(thresholds) - jw_bound.BOUND_MARGIN, dtype=ub.dtype, device=ub.device
    )
    # bucket_similarity is strict (sim > t): a token-equal pair's level is
    # the count of thresholds strictly below 1.0
    equal_level = sum(1 for t in thresholds if 1.0 > t)
    equal = (pc.tok_l == pc.tok_r) & (pc.len_l > 0)
    surv = (ub >= lowest) & ~equal & ~pc.null
    lvl = torch.where(
        equal,
        torch.tensor(equal_level, dtype=GAMMA_DTYPE, device=ub.device),
        _survivor_levels(pc, surv, thresholds),
    )
    return apply_null(lvl, pc.null)


def _spec_gamma(col_settings: dict, ctx: PairContext, two_phase: bool):
    """One comparison column's gamma levels for a pair batch."""
    spec = col_settings["comparison"]
    kind = spec["kind"]
    levels = col_settings["num_levels"]
    pc = ctx.col(_comparison_input_column(col_settings))
    thresholds = tuple(spec.get("thresholds", ()))

    if kind == "exact":
        eq = pc.tok_l == pc.tok_r if pc.tok_l is not None else pc.num_l == pc.num_r
        return apply_null(eq.to(GAMMA_DTYPE), pc.null)

    if kind == "jaro_winkler":
        aux = ctx.jw_aux(_comparison_input_column(col_settings)) if thresholds else None
        if aux is not None and two_phase:
            return _jw_two_phase(pc, aux, thresholds)
        sim = string_ops.jaro_winkler(
            pc.chars_l, pc.chars_r, pc.len_l, pc.len_r, 0.1, 0.7
        )
        return bucket_similarity(sim, thresholds, pc.null)

    if kind == "levenshtein":
        ratio = string_ops.levenshtein_ratio(
            pc.chars_l, pc.chars_r, pc.len_l, pc.len_r
        )
        equal = pc.tok_l == pc.tok_r
        return bucket_difference_le(ratio, thresholds, pc.null, equal, levels - 1)

    if kind == "numeric_abs":
        diff = numeric_ops.abs_difference(pc.num_l, pc.num_r)
        return bucket_difference(diff, thresholds, pc.null)

    if kind == "numeric_perc":
        diff = numeric_ops.relative_difference(pc.num_l, pc.num_r)
        return bucket_difference(diff, thresholds, pc.null)

    if kind == "name_inversion":
        # 4-level cross-column comparison handling inverted name fields
        # (splink/case_statements.py:248-277): 3 jw(col) > t1; 2 jw(col_l,
        # other_r) > t1 for any other column; 1 jw(col) > t2; null -> -1.
        if not thresholds:
            thresholds = (0.94, 0.88)
        t1 = torch.tensor(thresholds[0], dtype=torch.float32, device=pc.len_l.device)
        t2 = torch.tensor(thresholds[1], dtype=torch.float32, device=pc.len_l.device)
        sim_self = string_ops.jaro_winkler(
            pc.chars_l, pc.chars_r, pc.len_l, pc.len_r, 0.1, 0.7
        )
        inverted = torch.zeros(sim_self.shape, dtype=torch.bool, device=sim_self.device)
        for other in spec.get("other_columns", []):
            oc = ctx.col(other)
            a, b = _align_chars(pc.chars_l, oc.chars_r)
            sim_o = string_ops.jaro_winkler(a, b, pc.len_l, oc.len_r, 0.1, 0.7)
            inverted = inverted | ((sim_o > t1) & ~oc.null_r)
        i8 = lambda v: torch.tensor(v, dtype=GAMMA_DTYPE, device=sim_self.device)  # noqa: E731
        gamma = torch.where(
            sim_self > t1, i8(3),
            torch.where(inverted, i8(2), torch.where(sim_self > t2, i8(1), i8(0))),
        )
        return apply_null(gamma, pc.null)

    raise ValueError(f"Unknown comparison kind {kind!r}")


class GammaProgram:
    """Gamma computation bound to one encoded table on one device: ``cuda``
    unless ``device`` names another; raises when that is CUDA and no CUDA
    device exists."""

    def __init__(self, settings: dict, table: EncodedTable,
                 float_dtype=torch.float32, device=None):
        check_kinds_ported(settings)
        self.settings = settings
        self.device = resolve_device(device)
        self.n_cols = len(settings["comparison_columns"])
        self.two_phase = settings.get("two_phase_jw", "on") != "off" and bool(
            jw_specs_for(settings)
        )
        packed, layout = pack_table(
            table,
            float64=float_dtype == torch.float64,
            include=comparison_columns_used(settings),
            jw_specs=jw_specs_for(settings) if self.two_phase else (),
        )
        self._packed = torch.from_numpy(packed.view(np.int32)).to(self.device)
        self._layout = layout
        self._cols = settings["comparison_columns"]

    def gamma_batch(self, idx_l, idx_r) -> torch.Tensor:
        """(b, n_cols) int8 gammas for index tensors on the program's device."""
        ctx = PairContext(
            self._layout,
            self._packed.index_select(0, idx_l),
            self._packed.index_select(0, idx_r),
        )
        return torch.stack(
            [_spec_gamma(c, ctx, self.two_phase) for c in self._cols], dim=1
        )

    def compute_with_device(self, idx_l, idx_r,
                            batch_size: int = DEFAULT_PAIR_BATCH,
                            keep_device: bool = False):
        """(host int8 gamma matrix, device gamma matrix | None), computed in
        ``batch_size`` batches to bound device memory."""
        n = len(idx_l)
        batches = []
        for s in range(0, n, batch_size):
            to_dev = lambda a: torch.from_numpy(  # noqa: E731
                np.asarray(a[s : s + batch_size], np.int64)
            ).to(self.device)
            batches.append(self.gamma_batch(to_dev(idx_l), to_dev(idx_r)))
        dev = (
            torch.cat(batches)
            if batches
            else torch.zeros((0, self.n_cols), dtype=GAMMA_DTYPE, device=self.device)
        )
        host = dev.cpu().numpy()
        return host, (dev if keep_device else None)

    def compute(self, idx_l, idx_r, batch_size: int = DEFAULT_PAIR_BATCH):
        return self.compute_with_device(idx_l, idx_r, batch_size)[0]
