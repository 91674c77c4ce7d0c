"""Comparison-vector (gamma) computation: settings spec -> int8 gamma matrix.

The torch counterpart of splink_tpu/gammas.py. Encoded columns are packed
host-side into ONE (n_rows, n_lanes) 32-bit matrix (chars, lengths, token
ids, bitcast numerics and the two-phase Jaro-Winkler bound lanes side by
side) and moved to the device once; each pair batch then costs two row
gathers, and fields are unpacked on the device with dtype views and
shifts.

Every comparison kind of splink_tpu is here: exact, jaro_winkler
(two-phase and exact), levenshtein, numeric_abs, numeric_perc,
name_inversion, dmetaphone (token equality on the host-computed ``__dm_``
column), qgram_jaccard and qgram_cosine (ops/qgram.py, with each row's
q-gram aux lanes packed beside its characters), case_sql (a hand-written
SQL CASE expression compiled by case_compiler.py) and custom (a function
registered with ``register_comparison``).

The pattern-id pipeline: a gamma vector mixed-radix-encodes into one
pattern id (strides over levels_c + 1), the complete sufficient statistic
of a pair. One device pass yields the per-pair ids (uint16 where every id
and the mask sentinel fit) and their histogram, which is EM's input; scoring
afterwards is a host LUT gather. ``GammaStream`` and ``PatternStream`` run
the gamma and pattern passes on pair chunks as blocking emits them. The
histogram counts in int64 on the device (``torch.bincount``), so the
reference's int32 accumulator and its periodic flush have no counterpart;
the counts are the same integers.

Two-phase Jaro-Winkler: the reference reserves a fixed survivor capacity
per batch and redoes an overflowing batch with the exact body, because XLA
needs static shapes. Here the kernel runs on exactly the survivors. On the
card that is one masked launch over the whole batch (the kernel reads the
survivor mask and writes 0 elsewhere), so nothing waits on the host and no
rows are gathered or scattered; on the CPU the survivors are compacted
with ``torch.nonzero`` and the plain version runs on those rows. The gamma
matrix is bit-identical to both of the reference's bodies either way.
With no survivor capacity there is nothing to overflow, so the reference's
overflow flag and its exact-twin redo of a batch have no counterpart here.
A pass may count the filter's survivors (:class:`SurvivorCounts`): the
masked kernel adds them up on the device as it runs, and the pass reads
them back with a read it makes anyway.
"""

from __future__ import annotations

from collections import deque
from dataclasses import dataclass

import numpy as np
import torch

from ._device import device_constant, resolve_device
from .data import EncodedTable, phonetic_column_name
from .ops import jw_bound
from .ops import numeric as numeric_ops
from .ops import qgram as qgram_ops
from .ops import strings as string_ops
from .ops.gamma import (
    GAMMA_DTYPE,
    apply_null,
    bucket_difference,
    bucket_difference_le,
    bucket_similarity,
)
from .utils.profiling import count, note_d2h, note_h2d, note_reads, note_sync, span

DEFAULT_PAIR_BATCH = 1 << 20

# Largest dense gamma-pattern space the pattern-id pipeline handles; beyond
# this the linker streams sufficient statistics instead.
MAX_PATTERNS = 1 << 22

# The comparison kinds whose batch body on a card uploads nothing and reads
# nothing back (the two-phase Jaro-Winkler's constants are made with the
# program): the others upload 0-d constants per batch (numeric_perc,
# dmetaphone, name_inversion, the q-gram kinds, case_sql) or run the caller's
# code (custom)
CAPTURABLE_KINDS = frozenset({"exact", "jaro_winkler", "levenshtein", "numeric_abs"})

# Registry for custom comparisons: name -> callable(ctx, col_settings) -> gamma
_CUSTOM_COMPARISONS: dict[str, callable] = {}


def register_comparison(name: str, fn) -> None:
    """Register a custom comparison.

    ``fn(ctx, col_settings) -> (b,) integer gamma tensor`` where ctx is a
    :class:`PairContext` over the batch's pairs on the program's device;
    settings select it with ``{"kind": "custom", "fn": name}``. The port's
    counterpart of splink_tpu.register_comparison: the function receives
    this package's PairContext and returns a torch tensor."""
    _CUSTOM_COMPARISONS[name] = fn


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


class _QgramField:
    """Lanes of one column's q-gram aux (qgram_ops.qgram_row_aux): the
    distinct-gram first-occurrence mask and distinct count (jaccard), the
    squared count norm (cosine); None for a component no kind reads."""

    __slots__ = ("mask", "count_lane", "sq_lane")

    def __init__(self, mask, count_lane, sq_lane):
        self.mask = mask  # lane slice, ceil(n_windows / 32) lanes
        self.count_lane = count_lane
        self.sq_lane = sq_lane


class _CharsetField:
    """Lanes of one column's charset aux (qgram_ops.charset_row_aux) for
    the CASE compiler's jaccard_sim: first-occurrence-and-non-space mask,
    non-space distinct count, has-space flag."""

    __slots__ = ("mask", "count_lane", "space_lane")

    def __init__(self, mask, count_lane, space_lane):
        self.mask = mask
        self.count_lane = count_lane
        self.space_lane = space_lane


def _jw_key(name: str) -> str:
    return f"\x00jwbound:{name}"


def _qgram_key(name: str, q: int) -> str:
    return f"\x00qgram:{name}:{q}"


def _charset_key(name: str) -> str:
    return f"\x00charset:{name}"


def _comparison_input_column(col_settings: dict) -> str | None:
    """The encoded column a comparison column reads: ``col_name``, else the
    comparison spec's ``column``, else the first ``custom_columns_used``."""
    spec = col_settings.get("comparison") or {}
    name = col_settings.get("col_name") or spec.get("column")
    if name is None:
        name = (col_settings.get("custom_columns_used") or [None])[0]
    return name


def qgram_specs_for(settings: dict) -> tuple[tuple[str, int, bool, bool], ...]:
    """(column, q, want_jaccard_aux, want_cosine_aux) for each q-gram aux
    field to pack, as splink_tpu's: one per native qgram_jaccard /
    qgram_cosine column and q, packing only the components its kinds read;
    CASE cosine_distance calls whose arguments are all plain column
    references add the sumsq lanes."""
    flags: dict[tuple[str, int], list[bool]] = {}
    for c in settings["comparison_columns"]:
        spec = c.get("comparison") or {}
        kind = spec.get("kind")
        if kind in ("qgram_jaccard", "qgram_cosine"):
            name = _comparison_input_column(c)
            if name:
                f = flags.setdefault((name, int(spec.get("q", 2))), [False, False])
                f[0] |= kind == "qgram_jaccard"
                f[1] |= kind == "qgram_cosine"
        elif kind == "case_sql":
            from .case_compiler import precompute_aux_requirements

            _, cos = precompute_aux_requirements(spec["expr"])
            for name, q in cos:
                f = flags.setdefault((name, q), [False, False])
                f[1] = True
    return tuple((n, q, f[0], f[1]) for (n, q), f in flags.items())


def charset_specs_for(settings: dict) -> tuple[str, ...]:
    """Columns whose charset aux rides in the packed table: plain column
    references in CASE jaccard_sim calls."""
    cols: dict[str, None] = {}
    for c in settings["comparison_columns"]:
        spec = c.get("comparison") or {}
        if spec.get("kind") == "case_sql":
            from .case_compiler import precompute_aux_requirements

            charset, _ = precompute_aux_requirements(spec["expr"])
            for name in sorted(charset):
                cols.setdefault(name)
    return tuple(cols)


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


def comparison_columns_used(settings: dict) -> set[str] | None:
    """Encoded-column names the gamma program reads, or None for all of
    them (a custom comparison may read any column)."""
    used: set[str] = set()
    for col in settings["comparison_columns"]:
        spec = col.get("comparison") or {}
        kind = spec.get("kind")
        if kind == "custom":
            return None
        name = _comparison_input_column(col)
        if name:
            used.add(name)
            if kind == "dmetaphone":
                used.add(phonetic_column_name(name))
        used.update(spec.get("other_columns", []))
        used.update(spec.get("columns_used", []))
        used.update(phonetic_column_name(c) for c in spec.get("phonetic_columns", []))
    return used


def pack_table(table: EncodedTable, float64: bool = False, include=None,
               qgram_specs=(), charset_specs=(), jw_specs=()):
    """Pack encoded columns into one (n_rows, n_lanes) uint32 matrix, lane
    for lane the layout of splink_tpu's ``pack_table``: per string column
    its chars (width/4 lanes ASCII, width lanes wide), a length lane and a
    token-id lane; the q-gram, charset and JW-bound aux lanes; numeric
    values (one f32 or two f64 lanes) with their null bits packed 32 per
    lane at the end.

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

    for qname, q, want_jac, want_cos in qgram_specs:
        sc = table.strings.get(qname)
        if sc is None or (include is not None and qname not in include):
            continue
        mask, count, sumsq = qgram_ops.qgram_row_aux(sc.bytes_, sc.lengths, sc.token_ids, q)
        layout[_qgram_key(qname, q)] = _QgramField(
            add(mask) if want_jac else None,
            add(count.view(np.uint32)).start if want_jac else None,
            add(sumsq.view(np.uint32)).start if want_cos else None,
        )

    for cname in charset_specs:
        sc = table.strings.get(cname)
        if sc is None or (include is not None and cname not in include):
            continue
        mask, count, space = qgram_ops.charset_row_aux(sc.bytes_, sc.lengths, sc.token_ids)
        layout[_charset_key(cname)] = _CharsetField(
            add(mask), add(count.view(np.uint32)).start, add(space.view(np.uint32)).start
        )

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

    def __init__(self, layout: dict, rows_l, rows_r, survivors=None):
        self._layout = layout
        self._rows_l = rows_l
        self._rows_r = rows_r
        self.survivors = survivors  # SurvivorCounts of a counting pass, or None

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

    def qgram_aux(self, name: str, q: int):
        """Per-side q-gram aux (mask (b, lanes) int32, distinct count (b,)
        int32, squared norm (b,) float32), None for a component not packed;
        None when the table carries no aux for this column and q."""
        f = self._layout.get(_qgram_key(name, q))
        if f is None:
            return None

        def side(rows):
            return (
                None if f.mask is None else rows[:, f.mask].contiguous(),
                None if f.count_lane is None else rows[:, f.count_lane].contiguous(),
                None if f.sq_lane is None
                else rows[:, f.sq_lane].contiguous().view(torch.float32),
            )

        return side(self._rows_l), side(self._rows_r)

    def charset_aux(self, name: str):
        """Per-side charset aux (mask (b, lanes), non-space distinct count,
        has-space flag; int32), or None when the table carries none for
        this column."""
        f = self._layout.get(_charset_key(name))
        if f is None:
            return None
        return tuple(
            (rows[:, f.mask].contiguous(), rows[:, f.count_lane].contiguous(),
             rows[:, f.space_lane].contiguous())
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


def _pad_chars(chars, width: int):
    """Zero-pad a (b, w) char tensor to (b, width), contiguous; codepoints
    other than uint8 become int32 (the packed table's codepoint type)."""
    out = chars if chars.dtype in (torch.uint8, torch.int32) else chars.to(torch.int32)
    if out.shape[1] < width:
        out = torch.nn.functional.pad(out, (0, width - out.shape[1]))
    return out.contiguous()


def _align_chars(a, b):
    """Zero-pad two (b, w) char tensors to one width and one dtype (columns
    may be encoded at different widths, ASCII or wide)."""
    width = max(a.shape[1], b.shape[1])
    if a.dtype != b.dtype:
        a, b = a.to(torch.int32), b.to(torch.int32)
    return _pad_chars(a, width), _pad_chars(b, width)


def _survivor_levels_masked(pc: PairColumn, surv, thresholds, slot=None):
    """Levels of the survivors, 0 elsewhere, from one masked Jaro-Winkler
    launch over the whole batch (the card's form), which adds the survivors
    to ``slot`` (an int64 element, or None)."""
    sim = string_ops.jaro_winkler(
        pc.chars_l, pc.chars_r, pc.len_l, pc.len_r, 0.1, 0.7, mask=surv, survivors=slot
    )
    return torch.where(surv, bucket_similarity(sim, thresholds, None), 0)


def _survivor_levels_compacted(pc: PairColumn, surv, thresholds, slot=None):
    """The same levels with the survivors compacted first (the CPU's form:
    the plain version then runs on those rows only)."""
    pos = torch.nonzero(surv).squeeze(1)
    if slot is not None:
        slot += pos.numel()
    sim = string_ops.jaro_winkler(
        pc.chars_l[pos], pc.chars_r[pos], pc.len_l[pos], pc.len_r[pos], 0.1, 0.7
    )
    lvl = torch.zeros(surv.shape, dtype=GAMMA_DTYPE, device=surv.device)
    lvl[pos] = bucket_similarity(sim, thresholds, None)
    return lvl


def _survivor_levels(pc: PairColumn, surv, thresholds, slot=None):
    if surv.is_cuda:
        return _survivor_levels_masked(pc, surv, thresholds, slot)
    return _survivor_levels_compacted(pc, surv, thresholds, slot)


def _two_phase_constants(thresholds, device):
    """(lowest, level) of a two-phase column, 0-d and shared
    (``device_constant``): the float32 survivor threshold (the lowest
    threshold less the bound's margin) and the int8 level of a token-equal
    pair, the count of thresholds strictly below 1.0 (bucket_similarity is
    strict, sim > t)."""
    return (device_constant(min(thresholds) - jw_bound.BOUND_MARGIN, torch.float32, device),
            device_constant(sum(1 for t in thresholds if 1.0 > t), GAMMA_DTYPE, device))


def _jw_two_phase(pc: PairColumn, aux, thresholds, survivors=None, column: str = ""):
    """Two-phase Jaro-Winkler gamma (splink_tpu gammas._jw_two_phase): the
    sound upper bound excludes pairs below the lowest threshold, token-equal
    pairs take their level without a kernel, and the exact kernel runs on
    the survivors only. ``survivors`` (a :class:`SurvivorCounts`) counts
    them for ``column``."""
    (cl, pl), (cr, pr) = aux
    ub = jw_bound.jw_upper_bound(cl, pl, cr, pr, pc.len_l, pc.len_r, 0.1, 0.7)
    lowest, level = _two_phase_constants(thresholds, ub.device)
    equal = (pc.tok_l == pc.tok_r) & (pc.len_l > 0)
    surv = (ub >= lowest) & ~equal & ~pc.null
    slot = survivors.slot(column, surv.numel()) if survivors is not None else None
    lvl = torch.where(equal, level, _survivor_levels(pc, surv, thresholds, slot))
    return apply_null(lvl, pc.null)


def _spec_gamma(col_settings: dict, ctx: PairContext, two_phase: bool):
    """One comparison column's gamma levels for a pair batch."""
    spec = col_settings["comparison"]
    kind = spec["kind"]
    levels = col_settings["num_levels"]
    name = _comparison_input_column(col_settings)

    if kind == "custom":
        fn = _CUSTOM_COMPARISONS.get(spec.get("fn", ""))
        if fn is None:
            raise ValueError(
                f"comparison kind 'custom' requires a registered fn; got "
                f"{spec.get('fn')!r}. Use splink_tpu_torch.register_comparison()."
            )
        return fn(ctx, col_settings).to(GAMMA_DTYPE)

    if kind == "case_sql":
        from .case_compiler import compile_case_expression

        return compile_case_expression(spec["expr"], levels)(ctx)

    pc = ctx.col(name)
    thresholds = tuple(spec.get("thresholds", ()))

    if kind == "exact":
        eq = pc.tok_l == pc.tok_r if pc.tok_l is not None else pc.num_l == pc.num_r
        return apply_null(eq.to(GAMMA_DTYPE), pc.null)

    if kind == "dmetaphone":
        # token equality on the host-computed double-metaphone column:
        # 2 levels phonetic equality; 3 levels exact match above it
        if levels not in (2, 3):
            raise ValueError(
                f"dmetaphone comparison supports num_levels 2 or 3, got {levels}"
            )
        dm = ctx.col(phonetic_column_name(name))
        phon_eq = dm.tok_l == dm.tok_r
        if levels >= 3:
            # torchlint: disable=JL003 (0-d level constants: counted in gamma_batch's cuda allow_syncs)
            i8 = lambda v: torch.tensor(v, dtype=GAMMA_DTYPE, device=phon_eq.device)  # noqa: E731
            gamma = torch.where(pc.tok_l == pc.tok_r, i8(2),
                                torch.where(phon_eq, i8(1), i8(0)))
        else:
            gamma = phon_eq.to(GAMMA_DTYPE)
        return apply_null(gamma, pc.null)

    if kind == "jaro_winkler":
        aux = ctx.jw_aux(name) if thresholds else None
        if aux is not None and two_phase:
            return _jw_two_phase(pc, aux, thresholds, ctx.survivors, name)
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

    if kind == "qgram_jaccard":
        q = int(spec.get("q", 2))
        aux = ctx.qgram_aux(name, q)
        if aux is not None and aux[0][0] is not None:
            (m_l, n_l, _), (_, n_r, _) = aux
            sim = qgram_ops.qgram_jaccard_masked(
                pc.chars_l, pc.chars_r, pc.len_l, pc.len_r, m_l, n_l, n_r, q
            )
        else:
            sim = qgram_ops.qgram_jaccard(pc.chars_l, pc.chars_r, pc.len_l, pc.len_r, q)
        return bucket_similarity(sim, thresholds, pc.null)

    if kind == "qgram_cosine":
        q = int(spec.get("q", 2))
        aux = ctx.qgram_aux(name, q)
        if aux is not None and aux[0][2] is not None:
            (_, _, x11), (_, _, x22) = aux
            dist = qgram_ops.qgram_cosine_masked(
                pc.chars_l, pc.chars_r, pc.len_l, pc.len_r, x11, x22, q
            )
        else:
            dist = qgram_ops.qgram_cosine_distance(
                pc.chars_l, pc.chars_r, pc.len_l, pc.len_r, q
            )
        sim = 1.0 - dist
        return bucket_similarity(sim, thresholds, pc.null)

    if kind == "name_inversion":
        # 4-level cross-column comparison handling inverted name fields
        # (splink/case_statements.py:248-277): 3 jw(col) > t1; 2 jw(col_l,
        # other_r) > t1 for any other column; 1 jw(col) > t2; null -> -1.
        if not thresholds:
            thresholds = (0.94, 0.88)
        # torchlint: disable=JL003 (0-d thresholds: counted in gamma_batch's cuda allow_syncs)
        t1 = torch.tensor(thresholds[0], dtype=torch.float32, device=pc.len_l.device)
        t2 = torch.tensor(thresholds[1], dtype=torch.float32, device=pc.len_l.device)  # torchlint: disable=JL003 (a 0-d threshold: counted in gamma_batch's cuda allow_syncs)
        sim_self = string_ops.jaro_winkler(
            pc.chars_l, pc.chars_r, pc.len_l, pc.len_r, 0.1, 0.7
        )
        inverted = torch.zeros(sim_self.shape, dtype=torch.bool, device=sim_self.device)
        for other in spec.get("other_columns", []):
            oc = ctx.col(other)
            a, b = _align_chars(pc.chars_l, oc.chars_r)
            sim_o = string_ops.jaro_winkler(a, b, pc.len_l, oc.len_r, 0.1, 0.7)
            inverted = inverted | ((sim_o > t1) & ~oc.null_r)
        # torchlint: disable=JL003 (0-d level constants: counted in gamma_batch's cuda allow_syncs)
        i8 = lambda v: torch.tensor(v, dtype=GAMMA_DTYPE, device=sim_self.device)  # noqa: E731
        gamma = torch.where(
            sim_self > t1, i8(3),
            torch.where(inverted, i8(2), torch.where(sim_self > t2, i8(1), i8(0))),
        )
        return apply_null(gamma, pc.null)

    raise ValueError(f"Unknown comparison kind {kind!r}")


def pattern_histogram(ids: torch.Tensor, length: int) -> torch.Tensor:
    """(length,) int64 counts of the int ids, each in [0, length): the
    histogram of every pattern pass (the reference's ``int32_histogram``,
    whose int32 accumulator must flush; int64 counts need no flush)."""
    # on CUDA, bincount reads the ids' least and greatest value back first
    note_reads(ids, 2)
    return torch.bincount(ids, minlength=length)


def shard_histogram(parts: list, n_patterns: int) -> torch.Tensor:
    """(n_patterns + 1,) int64: the histograms of the per-shard id tensors
    summed in shard order, on the first shard's device (the mesh pattern
    passes' one reduction)."""
    from .parallel.mesh import reduce_shards

    return reduce_shards([pattern_histogram(p, n_patterns + 1) for p in parts])


def gather_shard_ids(parts: list, n_patterns: int, device) -> tuple:
    """(ids, (n_patterns + 1,) histogram) on ``device`` of a mesh batch's
    per-shard id tensors: the ids in shard order, the shards' histograms
    summed in shard order (:func:`shard_histogram`)."""
    hist = shard_histogram(parts, n_patterns)
    pid = parts[0].to(device) if len(parts) == 1 else torch.cat([p.to(device) for p in parts])
    return pid, hist.to(device)


def pattern_ids_fit_uint16(n_patterns: int) -> bool:
    """True when every pattern id AND the mask sentinel (== n_patterns)
    fit uint16: the one predicate deciding both the device-side narrowing
    before a copy to the host and the host array's dtype."""
    return n_patterns + 1 <= (1 << 16)


def pattern_strides_for(level_counts: list[int]) -> tuple[list[int], int]:
    """Mixed-radix strides and total pattern count for gamma vectors with
    the given per-column level counts (digit c = gamma_c + 1)."""
    strides, n_patterns = [], 1
    for lc in level_counts:
        strides.append(n_patterns)
        n_patterns *= int(lc) + 1
    return strides, n_patterns


def patterns_matrix_for(level_counts: list[int]) -> np.ndarray:
    """(n_patterns, C) int8 gamma vectors in mixed-radix pattern-id order."""
    strides, n_patterns = pattern_strides_for(level_counts)
    ids = np.arange(n_patterns, dtype=np.int64)
    out = np.empty((n_patterns, len(level_counts)), np.int8)
    for c, lc in enumerate(level_counts):
        out[:, c] = ((ids // strides[c]) % (int(lc) + 1)).astype(np.int8) - 1
    return out


def _pattern_ids(G: torch.Tensor, strides: torch.Tensor) -> torch.Tensor:
    """(b,) int32 pattern ids of a (b, C) gamma batch."""
    return ((G.to(torch.int32) + 1) * strides[None, :]).sum(dim=1, dtype=torch.int32)


# Device-to-host copies in flight before the host waits for the oldest: a
# batch's copy is then long done when it is read, so the host never stalls
# on the device between two batches
_D2H_DEPTH = 3


class _Downloads:
    """Device-to-host copies in flight, read back in submission order. On a
    CUDA device each tensor is copied with ``non_blocking=True``, on a side
    stream that first waits for the compute stream, into one of a ring of
    ``depth + 1`` pinned staging buffers (pinned memory is allocated once,
    not per batch); the host synchronises on the copy's event before it
    copies the values out. On the CPU a tensor is its own host array."""

    def __init__(self, device: torch.device, depth: int = _D2H_DEPTH):
        self.depth = depth
        self.device = device
        self._queue: deque = deque()
        self._free: list[torch.Tensor] = []  # pinned uint8 staging buffers
        self._stream = torch.cuda.Stream(device) if device.type == "cuda" else None

    def submit(self, tensor: torch.Tensor, tag=None) -> None:
        if self._stream is None:
            self._queue.append((tag, tensor, None, None))
            return
        nbytes = tensor.numel() * tensor.element_size()
        # by position: list.remove would compare tensors element-wise
        fit = next((k for k, b in enumerate(self._free) if b.numel() >= nbytes), None)
        if fit is not None:
            buf = self._free.pop(fit)
        else:
            buf = torch.empty(max(nbytes, 1), dtype=torch.uint8, pin_memory=True)
        host = buf[:nbytes].view(tensor.dtype).view(tensor.shape)
        note_d2h(tensor, wait=False)
        self._stream.wait_stream(torch.cuda.current_stream(self.device))
        with torch.cuda.stream(self._stream):
            host.copy_(tensor, non_blocking=True)
            done = torch.cuda.Event()
            done.record(self._stream)
        tensor.record_stream(self._stream)
        self._queue.append((tag, host, done, buf))

    def _pop(self):
        tag, host, done, buf = self._queue.popleft()
        if done is None:
            return tag, host.numpy()
        note_sync(self.device)
        done.synchronize()
        out = host.numpy().copy()
        self._free.append(buf)
        return tag, out

    def ready(self):
        """Yield (tag, host array) for the copies beyond ``depth``."""
        while len(self._queue) > self.depth:
            yield self._pop()

    def drain(self):
        """Yield (tag, host array) for every copy still in flight."""
        while self._queue:
            yield self._pop()

    def clear(self) -> None:
        self._queue.clear()


class SurvivorCounts:
    """The two-phase Jaro-Winkler filter's inputs and survivors, counted for
    each masked column a pass computes. The survivors add up on the device
    in ``slots`` (int64, one a column of ``columns``, zero at the start):
    the masked kernel adds each block's survivors to its column's slot, so
    counting launches nothing (the CPU's forms add the count they have).
    The inputs, the batch sizes, count on the host (``jw_pairs``);
    :meth:`settle` takes the slots' values from a read the pass makes
    anyway (``jw_survivors``)."""

    def __init__(self, columns: list[str], slots: torch.Tensor):
        self.columns = columns
        self.slots = slots

    def slot(self, column: str, pairs: int) -> torch.Tensor:
        """The slot of ``column``, whose batch of ``pairs`` enters the
        filter."""
        count("jw_pairs", pairs)
        count(f"jw_pairs.{column}", pairs)
        k = self.columns.index(column)
        return self.slots[k : k + 1]

    def settle(self, values) -> None:
        """Count the survivors from the host values of ``slots``."""
        taken = [int(n) for n in np.ravel(values)]
        for column, n in zip(self.columns, taken):
            count(f"jw_survivors.{column}", n)
        count("jw_survivors", sum(taken))


def _index_tensor(a, device) -> torch.Tensor:
    """Host pair indices as an int64 tensor on ``device``."""
    out = torch.from_numpy(np.asarray(a, np.int64)).to(device)
    note_h2d(out)
    return out


class GammaProgram:
    """Gamma computation bound to one encoded table on one device: ``cuda``
    unless ``device`` names another; raises when that is CUDA and no CUDA
    device exists."""

    def __init__(self, settings: dict, table: EncodedTable,
                 float_dtype=torch.float32, device=None):
        self.settings = settings
        self.device = resolve_device(device)
        self.n_cols = len(settings["comparison_columns"])
        self.two_phase = settings.get("two_phase_jw", "on") != "off" and bool(
            jw_specs_for(settings)
        )
        with span("pack"):
            packed, layout = pack_table(
                table,
                float64=float_dtype == torch.float64,
                include=comparison_columns_used(settings),
                qgram_specs=qgram_specs_for(settings),
                charset_specs=charset_specs_for(settings),
                jw_specs=jw_specs_for(settings) if self.two_phase else (),
            )
        self._layout = layout
        self._cols = settings["comparison_columns"]
        self.level_counts = [int(c["num_levels"]) for c in self._cols]
        strides, self.n_patterns = pattern_strides_for(self.level_counts)
        self._pattern_strides = strides
        with span("upload", bytes=packed.nbytes):
            self._packed = torch.from_numpy(packed.view(np.int32)).to(self.device)
            self._strides_dev = (
                torch.tensor(strides, dtype=torch.int32, device=self.device)
                if self.n_patterns <= MAX_PATTERNS else None
            )
            note_h2d(self._packed, self._strides_dev)
            # the two-phase columns' constants, made here once so that no
            # batch uploads one
            for _, thresholds in self._two_phase_columns():
                jw_bound.bound_constants(self.device)
                _two_phase_constants(thresholds, self.device)
        self._mesh_kernels: dict = {}
        # the SurvivorCounts of the pass running now, when it counts them
        self.survivors: SurvivorCounts | None = None

    def gamma_batch(self, idx_l, idx_r) -> torch.Tensor:
        """(b, n_cols) int8 gammas for index tensors on the program's device."""
        return self._gammas(self._packed, idx_l, idx_r, self.two_phase)

    def _gammas(self, packed, idx_l, idx_r, two_phase: bool) -> torch.Tensor:
        """The gamma body over ``packed`` (the table on the indices'
        device); ``two_phase`` False is the exact body, dense Jaro-Winkler
        over every pair."""
        ctx = PairContext(
            self._layout, packed.index_select(0, idx_l), packed.index_select(0, idx_r),
            survivors=self.survivors if two_phase else None,
        )
        return torch.stack([_spec_gamma(c, ctx, two_phase) for c in self._cols], dim=1)

    def _two_phase_columns(self) -> list[tuple[str, tuple]]:
        """(column, thresholds) of each column whose Jaro-Winkler runs
        two-phase in :meth:`gamma_batch`, in the order a batch takes them."""
        if not self.two_phase:
            return []
        out = []
        for c in self._cols:
            spec = c["comparison"]
            name = _comparison_input_column(c)
            if (spec["kind"] == "jaro_winkler" and spec.get("thresholds")
                    and _jw_key(name) in self._layout):
                out.append((name, tuple(spec["thresholds"])))
        return out

    def masked_jw_columns(self) -> list[str]:
        """The columns whose Jaro-Winkler runs two-phase in
        :meth:`gamma_batch`, in the order a batch takes them."""
        return [name for name, _ in self._two_phase_columns()]

    @property
    def capturable(self) -> bool:
        """True when a batch of :meth:`gamma_batch` on a card makes the host
        wait for nothing (no upload, no read back), so that a CUDA graph can
        capture it: every comparison is of a kind in
        :data:`CAPTURABLE_KINDS`."""
        return all(c["comparison"]["kind"] in CAPTURABLE_KINDS for c in self._cols)

    def _pattern_batch_for_mesh(self, mesh):
        """The per-shard pattern kernel of a mesh pass: fn(k, il, ir,
        masked=None) -> the int32 pattern ids of shard k's pairs (index
        tensors on its device), the sentinel ``n_patterns`` where
        ``masked`` holds. Mesh kernels compose the EXACT gamma body:
        two-phase survivor compaction is a single-device optimisation in
        the reference (a prefix sum along the sharded pair axis), so every
        shard runs the dense Jaro-Winkler. Cached per Mesh value, with the
        table and strides replicated on the mesh."""
        from .parallel.mesh import replicated

        cache = self._mesh_kernels
        if mesh not in cache:
            self._require_patterns()
            packed = replicated(mesh, self._packed)
            strides = replicated(mesh, self._strides_dev)

            def fn(k, il, ir, masked=None):
                pid = _pattern_ids(self._gammas(packed[k], il, ir, False), strides[k])
                if masked is None:
                    return pid
                return torch.where(masked, torch.full_like(pid, self.n_patterns), pid)

            cache[mesh] = fn
        return cache[mesh]

    def _mesh_pattern_context(self, mesh, batch_size: int):
        """run_batch(bl, br) -> (ids, histogram) on the program's device for
        one host batch of at most ``batch_size`` (a mesh multiple) pairs:
        shard k takes the k-th of the batch's equal pieces, as far as the
        batch's real pairs reach (:func:`gather_shard_ids`)."""
        from .parallel.mesh import shard_ranges

        fn = self._pattern_batch_for_mesh(mesh)

        def run_batch(bl, br):
            parts = [fn(k, _index_tensor(bl[lo:hi], mesh.devices[k]),
                        _index_tensor(br[lo:hi], mesh.devices[k]))
                     for k, (lo, hi) in enumerate(shard_ranges(mesh, 0, len(bl), batch_size))
                     if hi > lo]
            return gather_shard_ids(parts, self.n_patterns, self.device)

        return run_batch

    def _to_device(self, a) -> torch.Tensor:
        return _index_tensor(a, self.device)

    # ------------------------------------------------------------------
    # The pattern-id pipeline
    # ------------------------------------------------------------------

    def _require_patterns(self) -> None:
        if self._strides_dev is None:
            raise ValueError(
                f"pattern space {self.n_patterns} exceeds MAX_PATTERNS "
                f"({MAX_PATTERNS}); use the gamma-matrix paths"
            )

    @property
    def id_dtype(self):
        """Host dtype of pattern ids (the sentinel included)."""
        return np.uint16 if pattern_ids_fit_uint16(self.n_patterns) else np.int32

    def pattern_ids(self, G: torch.Tensor, masked=None) -> torch.Tensor:
        """(b,) int32 pattern ids of a device gamma batch; positions where
        ``masked`` holds take the sentinel ``n_patterns``."""
        pid = _pattern_ids(G, self._strides_dev)
        if masked is not None:
            pid = torch.where(masked, torch.full_like(pid, self.n_patterns), pid)
        return pid

    def narrow_ids(self, pid: torch.Tensor) -> torch.Tensor:
        """The ids in the host dtype, narrowed ON the device (half the bytes
        of the copy where they fit uint16)."""
        return pid.to(torch.uint16) if self.id_dtype == np.uint16 else pid

    def patterns_matrix(self) -> np.ndarray:
        """(n_patterns, n_cols) int8: the gamma row each pattern id decodes
        to."""
        return patterns_matrix_for(self.level_counts)

    def compute_pattern_ids(self, idx_l, idx_r, batch_size: int = DEFAULT_PAIR_BATCH,
                            mesh=None):
        """One pass over the pair set: (pattern_ids, counts). pattern_ids is
        (n,) uint16 when the pattern space allows (int32 otherwise); counts
        is the (n_patterns,) int64 histogram. With ``mesh`` each batch
        shards over the mesh's data axis (:meth:`_pattern_batch_for_mesh`):
        the same ids and counts, per-device work divided by the mesh
        size."""
        self._require_patterns()
        stream = PatternStream(self, batch_size, mesh=mesh)
        for s in range(0, len(idx_l), max(batch_size, 1)):
            stream.feed(np.asarray(idx_l[s : s + batch_size]),
                        np.asarray(idx_r[s : s + batch_size]))
        return stream.finish()

    # ------------------------------------------------------------------
    # The gamma matrix
    # ------------------------------------------------------------------

    def _iter_gamma_batches(self, idx_l, idx_r, batch_size: int):
        """The one batched gamma loop, yielding ``(host_rows, device_G)``
        per ``batch_size`` batch in order; copies to the host overlap the
        next batches' device work. Shared by :meth:`compute_with_device`
        and :meth:`iter_gamma_chunks`, so their blocks are identical."""
        n = len(idx_l)
        batch_size = max(min(batch_size, n), 1)
        downloads = _Downloads(self.device)
        for start in range(0, n, batch_size):
            stop = min(start + batch_size, n)
            G = self.gamma_batch(self._to_device(idx_l[start:stop]),
                                 self._to_device(idx_r[start:stop]))
            downloads.submit(G, G)
            for dev, host in downloads.ready():
                yield host, dev
        for dev, host in downloads.drain():
            yield host, dev

    def iter_gamma_chunks(self, idx_l, idx_r, batch_size: int = DEFAULT_PAIR_BATCH):
        """Yield host gamma blocks of ``batch_size`` pairs: the bounded
        working-set twin of :meth:`compute_with_device` for consumers that
        must never hold the whole matrix (``idx_l`` / ``idx_r`` may be
        memmaps)."""
        for host, _ in self._iter_gamma_batches(idx_l, idx_r, batch_size):
            yield host

    def compute_with_device(self, idx_l, idx_r,
                            batch_size: int = DEFAULT_PAIR_BATCH,
                            keep_device: bool = False):
        """(host int8 gamma matrix, device gamma matrix | None), computed in
        ``batch_size`` batches to bound device memory."""
        n = len(idx_l)
        host = np.empty((n, self.n_cols), np.int8)
        kept = []
        pos = 0
        for rows, dev in self._iter_gamma_batches(idx_l, idx_r, batch_size):
            host[pos : pos + len(rows)] = rows
            pos += len(rows)
            if keep_device:
                kept.append(dev)
        dev = None
        if keep_device:
            dev = (torch.cat(kept) if kept else
                   torch.zeros((0, self.n_cols), dtype=GAMMA_DTYPE, device=self.device))
        return host, dev

    def compute(self, idx_l, idx_r, batch_size: int = DEFAULT_PAIR_BATCH):
        return self.compute_with_device(idx_l, idx_r, batch_size)[0]


class _StreamBatcher:
    """Re-batches arbitrary-size (idx_l, idx_r) chunks into fixed
    ``batch_size`` device batches (the same boundaries as one pass over the
    concatenated pair order, so results equal the non-streamed paths').
    Subclasses implement _emit(bl, br)."""

    def __init__(self, batch_size: int):
        self.batch_size = max(int(batch_size), 1)
        self.total = 0
        self._buf_l: np.ndarray | None = None
        self._buf_r: np.ndarray | None = None
        self._fill = 0

    def feed(self, i: np.ndarray, j: np.ndarray) -> None:
        b = self.batch_size
        self.total += len(i)
        pos = 0
        if self._fill:
            take = min(b - self._fill, len(i))
            self._buf_l[self._fill : self._fill + take] = i[:take]
            self._buf_r[self._fill : self._fill + take] = j[:take]
            self._fill += take
            pos = take
            if self._fill == b:
                self._emit(self._buf_l.copy(), self._buf_r.copy())
                self._fill = 0
        # full batches straight from the chunk (no buffering copy)
        while len(i) - pos >= b:
            self._emit(i[pos : pos + b], j[pos : pos + b])
            pos += b
        rest = len(i) - pos
        if rest:
            if self._buf_l is None:
                self._buf_l = np.empty(b, i.dtype)
                self._buf_r = np.empty(b, j.dtype)
            self._buf_l[self._fill : self._fill + rest] = i[pos:]
            self._buf_r[self._fill : self._fill + rest] = j[pos:]
            self._fill += rest

    def _flush_tail(self) -> None:
        if self._fill:
            self._emit(self._buf_l[: self._fill].copy(), self._buf_r[: self._fill].copy())
            self._fill = 0

    @staticmethod
    def _drain_parts(parts: list[np.ndarray], out: np.ndarray) -> None:
        """Fill a preallocated output from the buffered parts, releasing
        each as it is copied (peak host RAM: output + one batch)."""
        pos = 0
        parts.reverse()
        while parts:
            part = parts.pop()
            out[pos : pos + len(part)] = part
            pos += len(part)
        assert pos == len(out)


class GammaStream(_StreamBatcher):
    """Incremental gamma computation: feed pair chunks as blocking emits
    them; device batches run while the host joins the next rule. finish()
    returns (host G, device G | None) as GammaProgram.compute_with_device
    would for the concatenated pairs.

    ``keep_device_limit`` bounds the device memory held by kept batches:
    once the pairs fed exceed it the device copies are dropped (the run is
    headed for a regime that uploads per batch anyway)."""

    def __init__(self, program: GammaProgram, batch_size: int, keep_device_limit: int = 0):
        super().__init__(batch_size)
        self.program = program
        self.keep_limit = keep_device_limit
        self._downloads = _Downloads(program.device)
        self._out_parts: list[np.ndarray] = []
        self._device_batches: list | None = [] if keep_device_limit > 0 else None
        # the masked columns' survivors, read back with the last batches
        self._survivors = None
        masked = program.masked_jw_columns()
        if masked:
            slots = torch.zeros(len(masked), dtype=torch.int64, device=program.device)
            self._survivors = program.survivors = SurvivorCounts(masked, slots)

    def _read(self, pairs) -> None:
        for dev, host in pairs:
            if dev is None:  # the survivor counts
                self._survivors.settle(host)
                continue
            self._out_parts.append(host)
            if self._device_batches is not None:
                self._device_batches.append(dev)

    def _emit(self, bl, br):
        p = self.program
        G = p.gamma_batch(p._to_device(bl), p._to_device(br))
        if self._device_batches is not None and self.total > self.keep_limit:
            self._device_batches = None  # too big: free the device copies
        self._downloads.submit(G, G)
        self._read(self._downloads.ready())

    def finish(self):
        with span("finish", pairs=self.total):
            return self._finish()

    def _finish(self):
        self._flush_tail()
        if self._survivors is not None:
            # the counts join the drain, whose copies the host waits for
            # anyway; the program stops counting
            if self.program.survivors is self._survivors:
                self.program.survivors = None
            self._downloads.submit(self._survivors.slots, None)
        self._read(self._downloads.drain())
        self._survivors = None
        host = np.empty((self.total, self.program.n_cols), np.int8)
        parts, self._out_parts = self._out_parts, []
        self._drain_parts(parts, host)
        dev = None
        if self._device_batches is not None and self.total <= self.keep_limit:
            batches = self._device_batches
            dev = (torch.cat(batches) if batches else torch.zeros(
                (0, self.program.n_cols), dtype=GAMMA_DTYPE, device=self.program.device))
        return host, dev


class PatternStream(_StreamBatcher):
    """Incremental pattern-id pipeline: feed pair chunks, finish() returns
    (pattern_ids, counts) as compute_pattern_ids would. The gamma matrix
    never materialises, and the device pass runs WHILE blocking still
    does instead of as a second sweep over the pair index. With ``mesh``
    the batch size pads to a mesh multiple and each batch shards over the
    mesh (GammaProgram._mesh_pattern_context)."""

    def __init__(self, program: GammaProgram, batch_size: int, mesh=None):
        program._require_patterns()
        self._run_batch = None
        if mesh is not None:
            from .parallel.mesh import pad_to_multiple

            batch_size = pad_to_multiple(batch_size, mesh.size)
            self._run_batch = program._mesh_pattern_context(mesh, batch_size)
        super().__init__(batch_size)
        self.program = program
        self.id_dtype = program.id_dtype
        self._parts: list[np.ndarray] = []
        self._downloads = _Downloads(program.device)
        self._counts = torch.zeros(program.n_patterns + 1, dtype=torch.int64,
                                   device=program.device)

    def _emit(self, bl, br):
        p = self.program
        if self._run_batch is not None:
            pid, hist = self._run_batch(bl, br)
            self._counts += hist
        else:
            pid = p.pattern_ids(p.gamma_batch(p._to_device(bl), p._to_device(br)))
            self._counts += pattern_histogram(pid, p.n_patterns + 1)
        self._downloads.submit(p.narrow_ids(pid))
        self._parts.extend(host for _, host in self._downloads.ready())

    def finish(self):
        self._flush_tail()
        self._parts.extend(host for _, host in self._downloads.drain())
        pids = np.empty(self.total, self.id_dtype)
        parts, self._parts = self._parts, []
        self._drain_parts(parts, pids)
        counts = self._counts[:-1]
        note_d2h(counts)
        return pids, counts.cpu().numpy()


def pattern_counts_from_gammas(G: np.ndarray, level_counts: list[int],
                               batch_size: int = DEFAULT_PAIR_BATCH,
                               device=None) -> np.ndarray:
    """(n_patterns,) int64 pattern counts of a host gamma matrix, batched
    through ``device`` (``cuda`` unless named)."""
    device = resolve_device(device)
    strides, n_patterns = pattern_strides_for(level_counts)
    strides_dev = torch.tensor(strides, dtype=torch.int32, device=device)
    total = torch.zeros(n_patterns, dtype=torch.int64, device=device)
    for s in range(0, len(G), max(batch_size, 1)):
        Gb = torch.from_numpy(np.ascontiguousarray(G[s : s + batch_size])).to(device)
        total += pattern_histogram(_pattern_ids(Gb, strides_dev), n_patterns)
    return total.cpu().numpy()
