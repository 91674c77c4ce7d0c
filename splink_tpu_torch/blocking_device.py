"""Device-native blocking: the sort-join tier on the card.

The port of splink_tpu/blocking_device.py for one device (its mesh
branches, ``shard_filter`` and the multi-controller spill store are left to
multi-GPU). The host join in blocking.py stays the fallback and the parity
oracle; on every shape the plan accepts, this tier emits the reference
device tier's pairs array for array — the same order, not only the same
set:

  1. segmented sort — one stable ``torch.sort`` of the composite int64 key
     ``key << 32 | side << 31 | rank`` (null keys remapped to int32 max)
     carrying row ids: the reference's ``lax.sort`` over (key, side, rank)
     with ``num_keys=3``. Equal keys become contiguous segments, group
     members arrive sorted by uid rank (orientation comes out of the join
     for free) and the two sides of a link / asymmetric join interleave as
     (code, side) runs;
  2. segment detection from the sorted boundaries (``nonzero``, a cumsum of
     the side flags); the trailing null segment is dropped, and only the
     O(segments) table and the sorted rows cross to the host;
  3. the host splits segments into pairgen's bounded triangle/rectangle
     units, and each chunk of rule-relative positions decodes on the device
     (``pairgen.unit_decode``) into (i, j) rows, masked by the asymmetric
     rule's rank orientation, duplicate uids, the rule's own residual and
     every earlier rule's predicate (the reference's ``AND NOT
     ifnull(prev, false)``);
  4. survivors compact on the card with a cumsum and a scatter into a fixed
     buffer that carries the count (and, for the spill store, the transfer
     digest) in its last lanes, and copy off the card through the pinned
     ring of ``gammas._Downloads`` so that chunk k's copy overlaps chunk
     k+1's decode; on the CPU the host compacts, as the reference does on
     its CPU backend. Both give the same arrays.

Chunk boundaries are the reference's: each rule runs in batches of
``min(batch, next power of two >= its total)`` positions, after the
int32-safe clamp. The durable write path (``build_spill_dir``) drives the
same emission through :func:`emit_pairs_sharded` into a
:class:`~.spill.PairSpillStore`, resumable segment by segment.
"""

from __future__ import annotations

import logging
import os
import time
from collections import deque
from dataclasses import dataclass, field

import numpy as np
import torch

from ._device import resolve_device
from .blocking import (
    _idx_dtype,
    _key_codes,
    _key_codes_asym,
    _split_join_keys,
    _uid_ranks,
    estimate_pair_upper_bound,
)
from .compat_sql import parse_blocking_rule
from .data import EncodedTable
from .gammas import _D2H_DEPTH, _Downloads
from .pairgen import (
    CHUNK,
    _pair_counts,
    _uid_mask_codes,
    _units_for_cross_join,
    _units_for_self_join,
    compile_residual_device,
    unit_decode,
)
from .spill import DIGEST_ADD, DIGEST_MUL
from .utils.logging_utils import format_stage_log

logger = logging.getLogger("splink_tpu_torch")

# Default emission chunk (pairs per device batch) when the settings carry no
# blocking_chunk_pairs; also the schema default. Bounds the transient device
# footprint of one chunk and the host RAM of one downloaded chunk.
DEFAULT_CHUNK_PAIRS = 1 << 22

# "auto" engages the device tier on the card once the exact rules' pair
# bound reaches this; below it the host join finishes in milliseconds.
AUTO_MIN_PAIRS = 1 << 21

_IMAX = np.iinfo(np.int32).max
_U32 = 0xFFFFFFFF

# The last run of device_block_rules: where its time went (host seconds,
# synchronised with the device at each part's end) and what it emitted.
last_run: dict = {}


def _pow2(n: int) -> int:
    """Smallest power of two >= max(n, 1): the reference's per-rule batch
    bucketing, kept so that chunk boundaries are the reference's."""
    return 1 << max(int(n) - 1, 0).bit_length()


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


# --------------------------------------------------------------------------
# The segmented sort
# --------------------------------------------------------------------------


def segment_sort(codes: np.ndarray, side: np.ndarray, rank: np.ndarray,
                 rows: np.ndarray, device: torch.device):
    """Stable sort of the entries by (key, side, rank) carrying their rows,
    and the live segments of equal keys: ``(order, starts, l_cnt, r_cnt)``
    — ``order`` the (m,) int32 rows in sorted order, the rest (segments,)
    int64 host arrays (segment start into ``order``, side-0 and side-1
    entry counts). Null keys (code < 0) sort last as int32 max and their
    segment is dropped."""
    codes_t = torch.from_numpy(np.ascontiguousarray(codes, np.int32)).to(device)
    key = torch.where(codes_t < 0, _IMAX, codes_t).to(torch.int64)
    side_t = torch.from_numpy(np.ascontiguousarray(side, np.int64)).to(device)
    rank_t = torch.from_numpy(np.ascontiguousarray(rank, np.int64)).to(device)
    comp = (key << 32) | (side_t << 31) | rank_t
    comp_s, perm = torch.sort(comp, stable=True)
    rows_t = torch.from_numpy(np.ascontiguousarray(rows, np.int32)).to(device)
    order = rows_t[perm]
    m = comp_s.numel()
    key_s = comp_s >> 32
    side_s = (comp_s >> 31) & 1
    edges = torch.nonzero(key_s[1:] != key_s[:-1]).flatten() + 1
    zero = torch.zeros(1, dtype=torch.int64, device=device)
    starts = torch.cat([zero, edges])
    ends = torch.cat([edges, torch.full((1,), m, dtype=torch.int64, device=device)])
    left = torch.cat([zero, torch.cumsum(side_s == 0, 0)])
    l_cnt = left[ends] - left[starts]
    r_cnt = (ends - starts) - l_cnt
    n_valid = int((codes >= 0).sum())
    starts, l_cnt, r_cnt = (a.cpu().numpy() for a in (starts, l_cnt, r_cnt))
    live = starts < n_valid  # drop the trailing null segment
    return order.cpu().numpy(), starts[live], l_cnt[live], r_cnt[live]


# --------------------------------------------------------------------------
# Plan build (host: key codes -> device sort -> bounded units)
# --------------------------------------------------------------------------


@dataclass
class DeviceRule:
    """One rule's device join structure."""

    rule: str
    order: np.ndarray  # (M,) int32 sorted entry rows
    ua: np.ndarray  # (U,) int32 unit a-side start into `order`
    la: np.ndarray  # (U,) int32 a-side extent (<= chunk)
    ub: np.ndarray  # (U,) int32 b-side start (== ua for triangles)
    lb: np.ndarray  # (U,) int32 b-side extent
    pc: np.ndarray  # (U+1,) int64 cumulative pair counts
    rank_filter: bool  # asymmetric self-join: keep rank[i] < rank[j]
    residual: str | None = None
    residual_fn: object = None

    @property
    def total(self) -> int:
        return int(self.pc[-1]) if len(self.pc) else 0


@dataclass
class DeviceBlockPlan:
    rules: list[DeviceRule]
    codes_l: np.ndarray  # (R, n) int32 per-rule l-side codes (dedup mask)
    codes_r: np.ndarray  # (R, n) int32 r-side codes (== l row when symmetric)
    ranks: np.ndarray  # (n,) int32 uid ranks (zeros for link_only)
    uid_codes: np.ndarray | None  # (n,) int32 when duplicate uids exist
    device: torch.device
    res_ops: list[np.ndarray] = field(default_factory=list)
    chunk: int = CHUNK  # unit extent bound (the reference's)
    # device copies of the plan's arrays, uploaded at the first emission
    _device_arrays: dict | None = field(default=None, repr=False)

    @property
    def n_candidates(self) -> int:
        return sum(rp.total for rp in self.rules)

    def on_device(self) -> dict:
        if self._device_arrays is None:
            def up(a, dt=None):
                return torch.from_numpy(np.ascontiguousarray(a)).to(device=self.device, dtype=dt)

            self._device_arrays = {
                "ranks": up(self.ranks),
                "codes_l": up(self.codes_l),
                "codes_r": up(self.codes_r),
                "uid": None if self.uid_codes is None else up(self.uid_codes),
                "res_ops": tuple(up(a) for a in self.res_ops),
                "rules": [
                    {"order": up(rp.order, torch.int64),
                     "units": tuple(up(a, torch.int64) for a in (rp.ua, rp.la, rp.ub, rp.lb)),
                     "pc": up(rp.pc)}
                    for rp in self.rules
                ],
            }
        return self._device_arrays


def _plan_or_reason(settings: dict, table: EncodedTable, n_left: int | None,
                    chunk: int | None, device: torch.device):
    """(plan, None), or (None, why the host join must serve the job)."""
    chunk = chunk or CHUNK
    link_type = settings["link_type"]
    rules = settings.get("blocking_rules") or []
    if not rules:
        return None, "no blocking rules (cartesian join)"
    if table.n_rows == 0:
        return None, "an empty table"
    n = table.n_rows
    if link_type == "link_only":
        assert n_left is not None
        ranks = np.zeros(n, np.int32)  # orientation fixed by construction
        uid_codes = None
    else:
        ranks, _ = _uid_ranks(table, link_type)
        uid_codes = _uid_mask_codes(table, link_type)

    res_ops: list[np.ndarray] = []
    res_idx: dict = {}
    res_aux: dict = {}
    parsed = []
    for rule in rules:
        eq_pairs, residual = parse_blocking_rule(rule)
        sym, asym, residual = _split_join_keys(eq_pairs, residual)
        if not sym and not asym:
            return None, f"rule {rule!r} has no equality key (cartesian)"
        if asym:
            codes_l, codes_r = _key_codes_asym(table, sym, asym)
        else:
            codes_l = codes_r = _key_codes(table, sym)
        if len(codes_l) and (int(codes_l.max()) >= _IMAX or int(codes_r.max()) >= _IMAX):
            return None, f"rule {rule!r} has key codes >= 2^31 - 1"
        res_fn = None
        if residual is not None:
            res_fn = compile_residual_device(table, residual, res_ops, res_idx, res_aux)
            if res_fn is None:
                return None, f"rule {rule!r} has a residual the device cannot evaluate"
        parsed.append((codes_l, codes_r, bool(asym), residual, res_fn))

    all_rows = np.arange(n, dtype=np.int32)
    plans: list[DeviceRule] = []
    codes_l_all = np.empty((len(rules), n), np.int32)
    codes_r_all = np.empty((len(rules), n), np.int32)
    for r, (codes_l, codes_r, is_asym, residual, res_fn) in enumerate(parsed):
        codes_l_all[r] = codes_l.astype(np.int32)
        codes_r_all[r] = codes_r.astype(np.int32)
        rank_filter = False
        if link_type == "link_only":
            # left input rows read the l-side codes, right rows the r-side;
            # rectangles by construction keep the left input on the l side
            ent_codes = np.concatenate([codes_l_all[r][:n_left], codes_r_all[r][n_left:]])
            ent_side = np.zeros(n, np.int32)
            ent_side[n_left:] = 1
            ent_rank = np.zeros(n, np.int32)
            ent_rows = all_rows
            triangle = False
        elif is_asym:
            # f(l) = g(r) over one table: every row enters once per side;
            # the reference's cross join of the table against itself with
            # its l.key < r.key condition becomes the rank filter mask
            ent_codes = np.concatenate([codes_l_all[r], codes_r_all[r]])
            ent_side = np.concatenate([np.zeros(n, np.int32), np.ones(n, np.int32)])
            ent_rank = np.concatenate([ranks, ranks]).astype(np.int32)
            ent_rows = np.concatenate([all_rows, all_rows])
            triangle = False
            rank_filter = True
        else:
            # symmetric self-join: rank is the sort's third key, so the
            # triangle decode's a < b IS rank_i < rank_j
            ent_codes = codes_l_all[r]
            ent_side = np.zeros(n, np.int32)
            ent_rank = ranks.astype(np.int32)
            ent_rows = all_rows
            triangle = True
        order, starts, lz, rz = segment_sort(ent_codes, ent_side, ent_rank, ent_rows, device)
        if triangle:
            units = _units_for_self_join(starts, lz, chunk)
        else:
            both = (lz > 0) & (rz > 0)
            units = _units_for_cross_join(starts[both], lz[both], starts[both] + lz[both],
                                          rz[both], chunk)
        if units is None:
            return None, f"rule {rules[r]!r} has a near-constant key (a monster group)"
        ua, la, ub, lb = units
        plans.append(DeviceRule(
            rule=rules[r], order=order,
            ua=ua.astype(np.int32), la=la.astype(np.int32),
            ub=ub.astype(np.int32), lb=lb.astype(np.int32),
            pc=_pair_counts(ua, la, ub, lb), rank_filter=rank_filter,
            residual=residual, residual_fn=res_fn,
        ))
    return DeviceBlockPlan(
        rules=plans, codes_l=codes_l_all, codes_r=codes_r_all,
        ranks=np.ascontiguousarray(ranks, dtype=np.int32), uid_codes=uid_codes,
        device=device, res_ops=res_ops, chunk=chunk,
    ), None


def build_device_plan(settings: dict, table: EncodedTable, n_left: int | None = None,
                      chunk: int | None = None, device=None) -> DeviceBlockPlan | None:
    """Build the device join plan on ``device`` (``cuda`` unless named), or
    None when a rule needs the host join (cartesian, an uncompilable
    residual, key codes >= 2^31 - 1, or a near-constant key exceeding the
    per-group unit cap). An error raised while the plan builds propagates."""
    return _plan_or_reason(settings, table, n_left, chunk, resolve_device(device))[0]


# --------------------------------------------------------------------------
# Chunked emission
# --------------------------------------------------------------------------


def chunk_digest(i: torch.Tensor, j: torch.Tensor, keep: torch.Tensor) -> torch.Tensor:
    """The transfer-integrity digest of one emitted chunk, on its device:
    the wraparound uint32 sum of a per-lane multiplicative mix of (i, j)
    over the kept lanes (a scalar int64 tensor in [0, 2^32)). Row ids are
    non-negative int32, so each product fits int64 before its mask; a sum
    of <= 2^31 lanes of < 2^32 cannot overflow. Equal to
    :func:`~.spill.chunk_digest_host` over the kept pairs."""
    ii = i.to(torch.int64)
    jj = j.to(torch.int64)
    mixed = ((ii * DIGEST_MUL) & _U32) ^ ((jj + DIGEST_ADD) & _U32)
    mixed = mixed ^ (mixed >> 15)
    return torch.where(keep, mixed, 0).sum() & _U32


def chunk_digest_compact(i_ext: torch.Tensor, j: torch.Tensor,
                         pos: torch.Tensor) -> torch.Tensor:
    """:func:`chunk_digest` over the compacted layout: ``i_ext`` carries the
    survivor count as its last lane and ``pos < count`` selects exactly the
    survivor lanes (the lanes past the count are never read as pairs)."""
    b = i_ext.numel() - 1
    return chunk_digest(i_ext[:b], j[:b], pos[:b] < i_ext[b])


def _emission_context(plan: DeviceBlockPlan, batch_size: int) -> dict:
    """What both emission drivers share: the int32-safe batch clamp (the
    reference's, so chunk boundaries are its boundaries), the device
    arrays, and where survivors compact (on the card; on the CPU the host
    compacts, as the reference does on its CPU backend)."""
    safe = (1 << 31) - 1 - plan.chunk * plan.chunk
    return {
        "batch_size": min(max(int(batch_size), 64), safe),
        "compact_dev": plan.device.type == "cuda",
        "arrs": plan.on_device(),
        "pos": {},
    }


def _rule_batch(ctx: dict, rp: DeviceRule) -> int:
    """A rule's chunk: clamped to the next power of two >= its total, so a
    small rule does not pad to a multi-M batch."""
    return min(ctx["batch_size"], _pow2(max(rp.total, 64)))


def _keep_mask(plan: DeviceBlockPlan, r: int, arrs: dict, i, j):
    """The keep mask of decoded pairs (None when the rule masks nothing):
    the asymmetric rule's rank orientation, duplicate uids, the rule's own
    residual, and every earlier rule's predicate (key equality on its l/r
    codes AND its residual, UNKNOWN counting as not-produced)."""
    rp = plan.rules[r]
    keep = None

    def both(a, b):
        return b if a is None else a & b

    if rp.rank_filter:
        ranks = arrs["ranks"]
        keep = both(keep, ranks[i] < ranks[j])
    if arrs["uid"] is not None:
        uid = arrs["uid"]
        keep = both(keep, uid[i] != uid[j])
    if rp.residual_fn is not None:
        v, unk = rp.residual_fn(i, j, arrs["res_ops"])
        keep = both(keep, v & ~unk)
    for p in range(r):
        ci = arrs["codes_l"][p][i]
        holds = (ci == arrs["codes_r"][p][j]) & (ci >= 0)
        prev_res = plan.rules[p].residual_fn
        if prev_res is not None:
            v, unk = prev_res(i, j, arrs["res_ops"])
            holds = holds & v & ~unk
        keep = both(keep, ~holds)
    return keep


def _emit_chunk(plan: DeviceBlockPlan, r: int, ctx: dict, bs: int, p0: int, p1: int,
                digest: bool):
    """Decode and mask the rule-relative positions [p0, p1) of rule ``r``.

    On the card: (tag, device tensor) to copy off — a (2, n) stack of (i, j)
    when the rule masks nothing, else one int32 buffer
    ``[i (bs) | count | j (bs) | digest]`` with the survivors compacted to
    the leading lanes by a cumsum and a scatter (masked lanes write the
    count's and the digest's lanes, which are then overwritten). On the
    CPU: (tag, (i, j, digest | None)) host arrays, compacted on the host."""
    arrs = ctx["arrs"]
    ra = arrs["rules"][r]
    device = plan.device
    q = torch.arange(p0, p1, dtype=torch.int64, device=device)
    i, j = unit_decode(q, ra["order"], *ra["units"], ra["pc"])
    keep = _keep_mask(plan, r, arrs, i, j)
    i32, j32 = i.to(torch.int32), j.to(torch.int32)
    if not ctx["compact_dev"]:
        ih, jh = i32.numpy(), j32.numpy()
        if keep is None:
            return ("host",), (ih, jh, None)
        dig = int(chunk_digest(i, j, keep)) if digest else None
        kh = keep.numpy()
        if kh.all():
            return ("host",), (ih, jh, dig)
        return ("host",), (ih[kh], jh[kh], dig)
    if keep is None:
        return ("plain",), torch.stack([i32, j32])
    kcum = torch.cumsum(keep, 0)
    dest = torch.where(keep, kcum - 1, bs)
    buf = torch.empty(2 * bs + 2, dtype=torch.int32, device=device)
    buf.scatter_(0, dest, i32)
    buf.scatter_(0, dest + (bs + 1), j32)
    buf[bs : bs + 1] = kcum[-1:]
    if digest:
        pos = ctx["pos"].get(bs)
        if pos is None:
            pos = ctx["pos"][bs] = torch.arange(bs, dtype=torch.int64, device=device)
        d = chunk_digest_compact(buf[: bs + 1], buf[bs + 1 : 2 * bs + 1], pos)
        buf[2 * bs + 1 : 2 * bs + 2] = torch.where(d >= 1 << 31, d - (1 << 32), d)
    return ("packed", bs, digest), buf


def _unpack(tag, host: np.ndarray):
    """(i, j, digest | None) host arrays from a chunk's copy. Slices keeping
    under half the buffer are copied, so a sink does not hold a whole chunk
    buffer for a sliver of survivors."""
    if tag[0] == "plain":
        return host[0], host[1], None
    bs, digest = tag[1], tag[2]
    cnt = int(host[bs])
    i, j = host[:cnt], host[bs + 1 : bs + 1 + cnt]
    if 2 * cnt < bs:
        i, j = i.copy(), j.copy()
    return i, j, (int(host[2 * bs + 1]) & _U32) if digest else None


class _Chunks:
    """Emitted chunks in flight, read back in submission order: compacted
    on the device (the card), each chunk's buffer copies off through the
    pinned ring a few chunks deep; compacted on the host (the CPU), a chunk
    is its host arrays already."""

    def __init__(self, device: torch.device, compact_dev: bool):
        self._downloads = _Downloads(device, _D2H_DEPTH) if compact_dev else None
        self._host: deque = deque()

    def submit(self, key, tag, out) -> None:
        if self._downloads is None:
            self._host.append((key, out))
        else:
            self._downloads.submit(out, (key, tag))

    def _read(self, pairs):
        for (key, tag), host in pairs:
            yield key, _unpack(tag, host)

    def ready(self):
        if self._downloads is None:
            while self._host:
                yield self._host.popleft()
        else:
            yield from self._read(self._downloads.ready())

    def drain(self):
        if self._downloads is None:
            yield from self.ready()
        else:
            yield from self._read(self._downloads.drain())

    def clear(self) -> None:
        self._host.clear()
        if self._downloads is not None:
            self._downloads.clear()


def iter_device_pairs(plan: DeviceBlockPlan, batch_size: int):
    """Drive the emission over every rule, yielding ``(rule_index, i, j)``
    host int32 chunks of at most ``batch_size`` pairs in rule order (the
    order the host sink sees), each rule in chunks of
    ``min(batch_size, next power of two >= its total)`` positions. On the
    card a chunk's copy off the device overlaps the next chunks' decode.
    Ends with one logger line of the emission's counts and rate and one
    ambient ``blocking_device`` event with the reference's fields (the
    copy ring's occupancy is not sampled: those two fields are null)."""
    from .obs.events import publish

    if plan.n_candidates == 0:
        return
    ctx = _emission_context(plan, batch_size)
    chunks = _Chunks(plan.device, ctx["compact_dev"])
    stats = {"chunks": 0, "submitted": 0, "pairs": 0, "candidates": 0,
             "fill_sum": 0.0, "completed": False}
    per_rule: dict[int, list] = {}
    t0 = time.perf_counter()

    def account(rr, i):
        stats["chunks"] += 1
        stats["pairs"] += len(i)
        pr = per_rule.setdefault(rr, [0, 0])
        pr[0] += 1
        pr[1] += len(i)

    try:
        for r, rp in enumerate(plan.rules):
            if rp.total == 0:
                continue
            bs = _rule_batch(ctx, rp)
            for p0 in range(0, rp.total, bs):
                p1 = min(p0 + bs, rp.total)
                tag, out = _emit_chunk(plan, r, ctx, bs, p0, p1, digest=False)
                chunks.submit(r, tag, out)
                stats["candidates"] += p1 - p0
                stats["submitted"] += 1
                stats["fill_sum"] += (p1 - p0) / ctx["batch_size"]
                for rr, (i, j, _) in chunks.ready():
                    account(rr, i)
                    yield rr, i, j
        for rr, (i, j, _) in chunks.drain():
            account(rr, i)
            yield rr, i, j
        stats["completed"] = True
    finally:
        # the consumer may abandon the generator mid-stream
        chunks.clear()
        elapsed = max(time.perf_counter() - t0, 1e-9)
        fields = dict(
            rules=len(plan.rules), chunks=stats["chunks"], pairs=stats["pairs"],
            candidates=stats["candidates"], elapsed_s=round(elapsed, 4),
            pairs_per_sec=round(stats["pairs"] / elapsed),
            chunk_budget=ctx["batch_size"],
        )
        logger.info("%s", format_stage_log("blocking_device", **fields,
                                           device=str(plan.device)))
        try:
            publish(
                "blocking_device", **fields,
                mean_chunk_fill=round(stats["fill_sum"] / (stats["submitted"] or 1), 4),
                d2h_occupancy_mean=None, d2h_occupancy_max=None,
                d2h_depth=_D2H_DEPTH, completed=stats["completed"],
                per_rule=[{"rule": plan.rules[r].rule, "chunks": c, "pairs": p}
                          for r, (c, p) in sorted(per_rule.items())],
            )
        except Exception as e:  # noqa: BLE001 - telemetry must never break emission
            logger.debug("blocking_device telemetry publish failed: %s", e)


def device_block_rules(settings: dict, table: EncodedTable, n_left: int | None, sink,
                       pair_consumer=None, mode: str = "auto", device=None,
                       finish: bool = True):
    """The device tier of :func:`blocking.block_using_rules`: build the
    plan, stream the chunked emission into the caller's sink, and return
    the finished PairIndex — or None for the host join: a rule shape the
    plan rejects (logged with its reason as a degradation), or an "auto"
    job on the CPU or below ``AUTO_MIN_PAIRS``. ``finish=False`` leaves
    the sink open (the approximate tier appends to it) and returns the
    sink. An error raised while the plan builds or the pairs emit
    propagates."""
    from .utils.logging_utils import warn_degraded

    if mode == "auto":
        if device is not None and torch.device(device).type == "cpu":
            return None
        # the exact rules' bound weighs the tier against its join size
        if estimate_pair_upper_bound(settings, table, n_left, include_approx=False) \
                < AUTO_MIN_PAIRS:
            return None
    device = resolve_device(device)
    t0 = time.perf_counter()
    plan, reason = _plan_or_reason(settings, table, n_left, None, device)
    _sync(device)
    plan_s = time.perf_counter() - t0
    if plan is None:
        warn_degraded("device_blocking", "host_blocking", reason, device=str(device))
        return None
    batch = int(settings.get("blocking_chunk_pairs") or DEFAULT_CHUNK_PAIRS)
    logger.info("device blocking: %d candidate positions, %d rules",
                plan.n_candidates, len(plan.rules))
    t0 = time.perf_counter()
    n_chunks = 0
    for _r, i, j in iter_device_pairs(plan, batch):
        sink.append(i, j)
        n_chunks += 1
        if pair_consumer is not None:
            pair_consumer(i.astype(sink.idx_dtype, copy=False),
                          j.astype(sink.idx_dtype, copy=False))
    _sync(device)
    emit_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    out = sink.finish() if finish else sink
    last_run.clear()
    last_run.update(plan_s=plan_s, emit_s=emit_s, finish_s=time.perf_counter() - t0,
                    chunks=n_chunks, pairs=out.n_pairs if finish else None,
                    candidates=plan.n_candidates, rules=len(plan.rules), device=str(device))
    return out


# --------------------------------------------------------------------------
# Sharded, resumable emission into the durable spill store
# --------------------------------------------------------------------------


def _shard_unit_ranges(pc: np.ndarray, n_shards: int) -> list[tuple[int, int]]:
    """Partition a rule's units into ``n_shards`` contiguous [lo, hi) index
    ranges balanced by CUMULATIVE PAIR COUNT (unit pair sizes vary by
    orders of magnitude, so a unit-count split would leave one shard
    holding every large rectangle). Contiguity makes a shard's positions a
    simple offset range of the rule's positions."""
    n_units = len(pc) - 1
    total = int(pc[-1])
    if n_units <= 0 or total == 0:
        return [(0, 0)] * n_shards
    cuts = [int(np.searchsorted(pc, (total * k) // n_shards, side="left"))
            for k in range(n_shards + 1)]
    cuts[0], cuts[-1] = 0, n_units
    # monotone repair: searchsorted on a heavily skewed pc can cross
    for k in range(1, n_shards + 1):
        cuts[k] = min(max(cuts[k], cuts[k - 1]), n_units)
    return [(cuts[k], cuts[k + 1]) for k in range(n_shards)]


def emit_pairs_sharded(plan: DeviceBlockPlan, store, batch_size: int, n_shards: int = 1,
                       budget: int | None = None, fault_plan=None) -> dict:
    """Drive the sharded, resumable emission of ``plan`` into a
    :class:`~.spill.PairSpillStore`.

    Each rule's units partition into ``n_shards`` contiguous
    pair-count-balanced ranges (:func:`_shard_unit_ranges`); every (rule,
    shard) streams chunks of the rule's batch through the same emission as
    :func:`iter_device_pairs`, each chunk committing as one manifest
    segment with its transfer digest (computed on the device over the
    compacted layout, re-derived on the host by ``write_segment``).

    Determinism is the resumability contract: segments enumerate in fixed
    (rule, shard, seq) order with deterministic contents, so a driver
    relaunched over a half-built store SKIPS the committed prefix (nothing
    runs for it) and appends byte-identical segments from there.
    ``budget`` caps the total pairs across rules and shards, the last
    segment truncating exactly at the envelope; under a budget chunks drain
    one by one, so the stop decision depends only on committed counts and a
    resumed run commits the same segments. The fault site ``emit_segment``
    fires between a segment's byte append and its manifest commit.

    Returns a stats dict (segments, skipped, pairs, exhausted) and
    publishes it as one ambient ``blocking_spill`` event. The caller
    finalizes the store."""
    from .obs.events import publish
    from .resilience import faults as _faults

    if fault_plan is None:
        fault_plan = _faults.active_plan()
    ctx = _emission_context(plan, batch_size)
    chunks = _Chunks(plan.device, ctx["compact_dev"])
    stats = {"segments": 0, "skipped": 0, "pairs": 0, "exhausted": False}
    # a resumed store already carries pairs toward the budget envelope
    emitted = sum(s.pairs for s in store.segments)
    t0 = time.perf_counter()

    def commit(key, chunk):
        nonlocal emitted
        r, s, k = key
        i, j, dig = chunk
        if budget is not None and emitted + len(i) > budget:
            keep = max(budget - emitted, 0)
            i, j, dig = i[:keep], j[:keep], None
            stats["exhausted"] = True
        emitted += len(i)
        stats["pairs"] += len(i)
        stats["segments"] += 1
        store.write_segment(
            r, s, k, i, j, digest=dig,
            fault_hook=lambda: fault_plan.fire("emit_segment", rule=r, shard=s, seq=k),
        )

    try:
        for r, rp in enumerate(plan.rules):
            if rp.total == 0:
                continue
            bs = _rule_batch(ctx, rp)
            for s_idx, (lo, hi) in enumerate(_shard_unit_ranges(rp.pc, n_shards)):
                if hi <= lo:
                    continue
                base, end = int(rp.pc[lo]), int(rp.pc[hi])
                for k, p0 in enumerate(range(base, end, bs)):
                    if store.segment_done(r, s_idx, k):
                        stats["skipped"] += 1
                        continue
                    if budget is not None:
                        for key, chunk in chunks.drain():
                            commit(key, chunk)
                        if emitted >= budget:
                            stats["exhausted"] = True
                            raise StopIteration
                    tag, out = _emit_chunk(plan, r, ctx, bs, p0, min(p0 + bs, end), digest=True)
                    chunks.submit((r, s_idx, k), tag, out)
                    for key, chunk in chunks.ready():
                        commit(key, chunk)
        for key, chunk in chunks.drain():
            commit(key, chunk)
    except StopIteration:
        for key, chunk in chunks.drain():
            commit(key, chunk)
    finally:
        chunks.clear()
        elapsed = max(time.perf_counter() - t0, 1e-9)
        fields = dict(
            rules=len(plan.rules), shards=n_shards, segments=stats["segments"],
            skipped=stats["skipped"], pairs=stats["pairs"],
            pairs_per_sec=round(stats["pairs"] / elapsed), chunk_budget=ctx["batch_size"],
            budget=budget, exhausted=stats["exhausted"], elapsed_s=round(elapsed, 4))
        logger.info("%s", format_stage_log("blocking_spill", **fields))
        try:
            publish("blocking_spill", **fields)
        except Exception as e:  # noqa: BLE001 - telemetry must never break emission
            logger.debug("blocking_spill telemetry publish failed: %s", e)
    return stats


def spill_block_rules(settings: dict, table: EncodedTable, n_left: int | None,
                      build_dir: str, budget: int | None = None, device=None):
    """The build_spill_dir write path: sharded resumable emission into
    ``<build_dir>/pairs``, returning a durable store-backed PairIndex — or
    None when the job's rule shapes need the host join (the caller falls
    back to the ordinary, non-resumable path with its own warning).

    A store already finalized for this exact job returns at once (the
    idempotent restart a relaunch loop needs); a half-built one resumes
    from its last committed segment. One process: the store is
    ``build_dir`` itself (no per-process subdirectory)."""
    from .resilience.checkpoint import settings_state_hash
    from .spill import PairSpillStore

    device = resolve_device(device)
    plan, reason = _plan_or_reason(settings, table, n_left, None, device)
    if plan is None:
        logger.info("spill emission: no device plan (%s)", reason)
        return None
    n_shards = int(settings.get("emit_shard_chunks") or 0) or 1
    batch = int(settings.get("blocking_chunk_pairs") or DEFAULT_CHUNK_PAIRS)
    meta = {
        "state_hash": settings_state_hash(
            settings, extra={"artifact": "pair_spill", "n_rows": int(table.n_rows)}),
        "n_shards": n_shards,
        "chunk_pairs": batch,
        "budget": budget,
        "process_index": 0,
        "process_count": 1,
        "rule_totals": [int(rp.total) for rp in plan.rules],
    }
    store = PairSpillStore.attach(os.path.join(build_dir, "pairs"),
                                  _idx_dtype(table.n_rows), meta)
    if store.completed:
        logger.info("spill store at %s already finalized (%d pairs); reusing",
                    store.directory, store.total_pairs)
        return store.as_pair_index()
    with store:
        stats = emit_pairs_sharded(plan, store, batch, n_shards=n_shards, budget=budget)
    store.finalize(exhausted=stats["exhausted"])
    logger.info("spill emission: %d pairs in %d segments (%d resumed) at %s",
                store.total_pairs, len(store.segments), stats["skipped"], store.directory)
    return store.as_pair_index()


# --------------------------------------------------------------------------
# The serving index's bucket CSR
# --------------------------------------------------------------------------


def build_bucket_csr(codes: np.ndarray, device=None):
    """The serving index's bucket CSR over one rule's key codes, built on
    ``device`` (``cuda`` unless named): (rows_sorted, starts, sizes,
    row_bucket) int32 arrays equal to the host ``_sort_groups`` + scatter
    construction (a stable sort keeps rows ascending within a bucket;
    buckets by ascending key code; row_bucket -1 for null-key rows), or
    None when the codes do not fit int32 (the caller builds on the host)."""
    n = len(codes)
    if n == 0 or int(codes.max(initial=0)) >= _IMAX:
        return None
    device = resolve_device(device)
    codes_t = torch.from_numpy(np.ascontiguousarray(codes, np.int32)).to(device)
    key = torch.where(codes_t < 0, _IMAX, codes_t)
    key_s, row_s = torch.sort(key, stable=True)
    n_valid = int((codes >= 0).sum())
    boundary = torch.ones(n, dtype=torch.int64, device=device)
    boundary[1:] = key_s[1:] != key_s[:-1]
    seg_of = torch.cumsum(boundary, 0) - 1
    starts = torch.nonzero(boundary).flatten()
    sizes = torch.diff(starts, append=torch.full((1,), n, dtype=torch.int64, device=device))
    row_bucket = torch.full((n,), -1, dtype=torch.int32, device=device)
    row_bucket[row_s[:n_valid]] = seg_of[:n_valid].to(torch.int32)
    starts, sizes = starts.cpu().numpy(), sizes.cpu().numpy()
    live = starts < n_valid  # drop the trailing null segment
    return (row_s[:n_valid].to(torch.int32).cpu().numpy(),
            starts[live].astype(np.int32), sizes[live].astype(np.int32),
            row_bucket.cpu().numpy())
