"""LSH-bucket candidate generation, q-gram verification, progressive budget.

The port of splink_tpu/approx/lsh.py: the approximate tier of
:func:`..blocking.block_using_rules`, on one device.

  1. **signatures** — :mod:`.minhash` band keys over the approximate
     columns, factorised to dense int32 codes per band;
  2. **candidates** — each band is a symmetric hash join on its band codes
     through the device sort-join tier (``blocking_device.segment_sort``,
     pairgen's bounded triangle/rectangle units and
     ``iter_device_pairs``): band ``b`` carries bands ``0..b-1`` as its
     sequential-dedup predecessors, so every colliding pair is emitted
     once, by its first colliding band. Pairs an EXACT rule produced are
     dropped on the host per chunk (``blocking._rule_holds``: key equality
     and residual, UNKNOWN counting as not produced);
  3. **verification** — :func:`verify_pairs` counts each pair's band
     collisions and, when ``approx_threshold > 0``, the mean q-gram
     Jaccard over the approximate columns (``ops.qgram.qgram_jaccard_masked``;
     with ``approx_tf_weighting`` the IDF-weighted form); pairs below the
     threshold are dropped on the device;
  4. **progressive emission** — survivors rank by (verified Jaccard
     descending, collisions descending, i, j), a total order, and stream
     into the sink best first up to ``approx_pair_budget``.

The candidates held before the final ranking are pruned to the running
top-``budget`` on the device whenever they pass ~2x the budget (the top-B
of a superset contains the final top-B, so pruning never changes what is
emitted). Every float operation keeps the reference's association; the
reference's jitted verifier divides the Jaccard sum by the column count as
a multiply by its float32 reciprocal, so the port does the same.

Unlike the reference, a failure of this tier propagates: it is not logged
and replaced with zero approximate pairs.
"""

from __future__ import annotations

import logging
import time
from dataclasses import dataclass, field

import numpy as np
import torch

from .._device import resolve_device
from ..blocking import (
    _key_codes,
    _key_codes_asym,
    _rule_holds,
    _split_join_keys,
    _uid_ranks,
)
from ..compat_sql import parse_blocking_rule
from ..data import EncodedTable
from ..pairgen import (
    CHUNK,
    _pair_counts,
    _uid_mask_codes,
    _units_for_cross_join,
    _units_for_self_join,
)
from .minhash import (
    DF_TABLE_BITS,
    _fold_gram_hash,
    _upload,
    _upload_chars,
    _words32,
    band_key_arrays,
    column_salts,
    factorise_band_codes,
)

logger = logging.getLogger("splink_tpu_torch")

# Schema defaults (the schema is the source of truth; these are the
# in-code fallbacks for partially-completed dicts).
DEFAULT_Q = 2
DEFAULT_BANDS = 16
DEFAULT_ROWS_PER_BAND = 2
DEFAULT_BUDGET = 1 << 22

# An LSH bucket larger than this is a degenerate band key (near-constant
# signature): the plan drops the bucket and the ``blocking_approx`` event
# counts it.
MAX_BUCKET_ROWS = 4096

# Pairs per verification call: the reference's chunk on the CPU, so that
# the pruning points (and with them the held arrays) are the reference's;
# larger on the card, where a call of 8,192 pairs is bound by its launches.
# The emitted pairs are the same whatever the chunk.
VERIFY_CHUNK = 1 << 13
VERIFY_CHUNK_CUDA = 1 << 20

# The last approx_block_into run: its stats and where its time went
# (host seconds; each part ends in a read of device results).
last_run: dict = {}


def _null_oversize_buckets(band_codes: np.ndarray) -> int:
    """Null (-1) every row of every LSH bucket wider than
    :data:`MAX_BUCKET_ROWS`, IN PLACE, returning the dropped-bucket count.

    Nulling the codes, rather than dropping the bucket from its band's
    emission units, keeps the cross-band sequential dedup honest: band b's
    pairs are masked when an EARLIER band's codes collide, so a bucket
    removed from band 0's emission while keeping its codes would suppress
    the same pair in every later band too. With the codes nulled the pair
    emits through its first healthy band, and the serve fallback (whose
    dictionaries never resolve an oversize bucket) agrees with the offline
    tier about which pairs exist."""
    dropped = 0
    for b in range(band_codes.shape[0]):
        codes = band_codes[b]
        valid = codes >= 0
        if not valid.any():
            continue
        sizes = np.bincount(codes[valid])
        big = np.flatnonzero(sizes > MAX_BUCKET_ROWS)
        if len(big):
            dropped += len(big)
            codes[np.isin(codes, big)] = -1
    return dropped


# --------------------------------------------------------------------------
# Configuration
# --------------------------------------------------------------------------


def approx_columns(settings: dict, table: EncodedTable) -> list[str]:
    """The string columns the approximate tier sketches, in deterministic
    order: the plain string columns named by the blocking rules' equality
    keys (both sides of an asymmetric key), falling back to the string
    comparison columns when no blocking key is a plain string column.
    Empty means the tier is unavailable for this job."""
    cols: list[str] = []

    def add(name: str) -> None:
        if name in table.strings and name not in cols:
            cols.append(name)

    for rule in settings.get("blocking_rules") or []:
        try:
            eq_pairs, residual = parse_blocking_rule(rule)
        except Exception:  # noqa: BLE001 - unparseable rule: no columns
            continue
        sym, asym, _ = _split_join_keys(eq_pairs, residual)
        for c in sym:
            add(c)
        for lc, rc in asym:
            add(lc)
            add(rc)
    if not cols:
        for c in settings.get("comparison_columns") or []:
            name = c.get("custom_name") or c.get("col_name")
            if name:
                add(name)
    return cols


@dataclass(frozen=True)
class ApproxConfig:
    cols: tuple[str, ...]
    q: int
    bands: int
    rows_per_band: int
    threshold: float
    budget: int
    # the TF-weighted tier (approx_tf_weighting): IDF-weighted minhash
    # sampling and TF-weighted Jaccard verification and ranking
    tf_weighting: bool = False

    @classmethod
    def from_settings(cls, settings: dict, table: EncodedTable) -> "ApproxConfig | None":
        """None when the tier is off or no sketchable column exists."""
        if not settings.get("approx_blocking"):
            return None
        cols = approx_columns(settings, table)
        if not cols:
            logger.warning(
                "approx_blocking is on but no blocking key or comparison "
                "column is an encoded string column; the approximate tier "
                "is skipped"
            )
            return None
        q = int(settings.get("approx_q") or DEFAULT_Q)
        if not 1 <= q <= 8:
            raise ValueError(f"approx_q={q} must be in [1, 8]")
        bands = int(settings.get("approx_bands") or DEFAULT_BANDS)
        rpb = int(settings.get("approx_rows_per_band") or DEFAULT_ROWS_PER_BAND)
        if bands < 1 or rpb < 1:
            raise ValueError("approx_bands and approx_rows_per_band must be >= 1")
        thr = float(settings.get("approx_threshold") or 0.0)
        if not 0.0 <= thr <= 1.0:
            raise ValueError(f"approx_threshold={thr} must be in [0, 1]")
        budget = int(settings.get("approx_pair_budget") or DEFAULT_BUDGET)
        if budget < 1:
            raise ValueError("approx_pair_budget must be >= 1")
        return cls(
            cols=tuple(cols), q=q, bands=bands, rows_per_band=rpb,
            threshold=thr, budget=budget,
            tf_weighting=bool(settings.get("approx_tf_weighting")),
        )


def column_arrays(table: EncodedTable, cols) -> list[tuple[np.ndarray, np.ndarray]]:
    """(bytes, lengths) per approximate column, null rows forced to length
    0 so that a null value contributes no grams."""
    out = []
    for name in cols:
        sc = table.strings[name]
        lengths = np.where(sc.null_mask, 0, sc.lengths).astype(np.int32)
        out.append((sc.bytes_, lengths))
    return out


# --------------------------------------------------------------------------
# Verification and ranking
# --------------------------------------------------------------------------


def _wjac(s1, s2, l1, l2, m1, m2, salt: int, idf, q: int):
    """TF-weighted Jaccard of each pair's distinct q-grams, (B,) float32:
    ``sum_{A∩B} idf(g) / sum_{A∪B} idf(g)``, the weights gathered at each
    gram's fold hash (the IDF table the weighted sampler draws from), each
    side's distinct grams from its first-occurrence mask."""
    # left-to-right sums over the windows: the reference's order
    from ..models.fellegi_sunter import _sum_columns
    from ..ops.qgram import _eq, _gram_codes, _mask_bits

    w1, v1 = _gram_codes(s1, l1, q)
    w2, v2 = _gram_codes(s2, l2, q)
    bpc = 8 if s1.dtype == torch.uint8 else 21
    g1 = idf[_fold_gram_hash(_words32(w1, bpc, q), salt) >> (32 - DF_TABLE_BITS)]
    g2 = idf[_fold_gram_hash(_words32(w2, bpc, q), salt) >> (32 - DF_TABLE_BITS)]
    first1 = _mask_bits(m1, v1.shape[1])
    first2 = _mask_bits(m2, v2.shape[1])
    zero = torch.zeros((), dtype=torch.float32, device=s1.device)
    inter = _sum_columns(torch.where(first1 & _eq(w1, w2, v1, v2).any(dim=2), g1, zero))
    u1 = _sum_columns(torch.where(first1, g1, zero))
    u2 = _sum_columns(torch.where(first2, g2, zero))
    union = u1 + u2 - inter
    safe = torch.where(union > 0, union, torch.ones((), dtype=union.dtype, device=union.device))
    return torch.where(union > 0, inter / safe, zero)


def verify_pairs(i, j, band_codes, aux, q: int, with_jaccard: bool, idf=None):
    """The per-pair estimator: ``(collisions (n,) int32, sim (n,) float32)``.

    ``i`` / ``j`` are (n,) int64 row tensors, ``band_codes`` the (bands,
    n_rows) int32 code matrix (code -1 never collides) and ``aux`` per
    approximate column its (characters, lengths, first-gram mask as int32
    lanes, distinct count) on the same device. The similarity is the mean
    over the columns of the exact q-gram Jaccard (a column null on either
    side contributes 0), or with ``idf`` of the TF-weighted Jaccard; all
    zero without ``with_jaccard``."""
    from ..ops.qgram import qgram_jaccard_masked

    dev = i.device
    coll = torch.zeros(i.shape[0], dtype=torch.int32, device=dev)
    for b in range(band_codes.shape[0]):
        cb = band_codes[b]
        ci = cb[i]
        coll = coll + ((ci == cb[j]) & (ci >= 0)).to(torch.int32)
    sims = torch.zeros(i.shape[0], dtype=torch.float32, device=dev)
    if not with_jaccard:
        return coll, sims
    salts = column_salts(len(aux))
    for c, (chars, lens, mask, cnt) in enumerate(aux):
        if idf is not None:
            jac = _wjac(chars[i], chars[j], lens[i], lens[j], mask[i], mask[j],
                        int(salts[c]), idf, q)
        else:
            jac = qgram_jaccard_masked(chars[i], chars[j], lens[i], lens[j], mask[i],
                                       cnt[i], cnt[j], q)
        sims = sims + jac
    # torchlint: disable=JL003 (a 0-d constant: counted in approx_verify's cuda allow_syncs)
    inv = torch.tensor(np.float32(1.0) / np.float32(len(aux)), device=dev)
    return coll, sims * inv


def rank_order(i, j, coll, sim):
    """The emission order as a permutation tensor: (sim descending, coll
    descending, i, j), equal to ``np.lexsort((j, i, -coll, -sim))``. Two
    stable sorts: by (i, j), then by (sim, coll) descending. ``sim`` is
    non-negative, so its float32 bits order as its values."""
    ij = i.to(torch.int64) * (1 << 31) + j.to(torch.int64)
    first = torch.sort(ij, stable=True).indices
    key = (sim.contiguous().view(torch.int32).to(torch.int64) << 32) | coll.to(torch.int64)
    second = torch.sort(-key[first], stable=True).indices
    return first[second]


def _verify_aux(table: EncodedTable, cfg: ApproxConfig):
    """Per column (bytes, lengths, first_mask, distinct_count) numpy arrays
    for :func:`verify_pairs` (``qgram_row_aux`` runs once per unique token
    per column)."""
    from ..ops.qgram import qgram_row_aux

    out = []
    for name, (bytes_, lengths) in zip(cfg.cols, column_arrays(table, cfg.cols)):
        token_ids = np.where(lengths > 0, table.strings[name].token_ids, -1).astype(np.int32)
        mask, count, _sumsq = qgram_row_aux(bytes_, lengths, token_ids, cfg.q)
        out.append((bytes_, lengths, mask, count))
    return out


# --------------------------------------------------------------------------
# Plan build (band codes -> device join plans, one per band)
# --------------------------------------------------------------------------


@dataclass
class ApproxPlan:
    """Everything the candidate generator needs, band joins included."""

    config: ApproxConfig
    band_codes: np.ndarray  # (bands, n) int32, -1 = no signature
    device_plan: object  # blocking_device.DeviceBlockPlan over the bands
    oversize_buckets: int  # degenerate LSH buckets dropped from the join
    band_uniq_keys: list = field(default_factory=list)  # per-band uint32 keys
    idf: np.ndarray | None = None  # the TF-weighting IDF table
    seconds: dict = field(default_factory=dict)  # where the build's time went

    @property
    def n_candidates(self) -> int:
        return self.device_plan.n_candidates


def compute_band_codes(table: EncodedTable, cfg: ApproxConfig, idf: np.ndarray | None = None,
                       device=None, seconds: dict | None = None):
    """(bands, n_rows) int32 band codes, the per-band ascending unique key
    arrays (the serve bucket dictionaries key on them) and the IDF table
    when TF weighting is on (built from the corpus's hashed gram DF table
    unless the caller supplies one), computed on ``device``. ``seconds``,
    when a dict, receives the DF table's, the signatures' and the
    factorisation's host seconds."""
    from .minhash import gram_df_table, idf_weights

    device = resolve_device(device)
    seconds = {} if seconds is None else seconds
    columns = column_arrays(table, cfg.cols)
    t0 = time.perf_counter()
    if cfg.tf_weighting and idf is None:
        df_counts, n_records = gram_df_table(columns, cfg.q, device=device)
        idf = idf_weights(df_counts, n_records)
    t1 = time.perf_counter()
    keys, has = band_key_arrays(columns, cfg.q, cfg.bands, cfg.rows_per_band,
                                idf=idf if cfg.tf_weighting else None, device=device)
    t2 = time.perf_counter()
    codes, uniqs = factorise_band_codes(keys, has)
    seconds.update(df_table=t1 - t0, signatures=t2 - t1, factorise=time.perf_counter() - t2)
    return codes, uniqs, idf if cfg.tf_weighting else None


def build_approx_plan(settings: dict, table: EncodedTable, n_left: int | None = None,
                      chunk: int | None = None, device=None) -> ApproxPlan | None:
    """Build the per-band device join plans on ``device`` (``cuda`` unless
    named), or None when the tier is off or unavailable: the reference's
    symmetric and link_only branches of the device plan with band codes as
    the join keys. Oversize LSH buckets (> :data:`MAX_BUCKET_ROWS` rows)
    are dropped and counted."""
    from ..blocking_device import DeviceBlockPlan, DeviceRule, segment_sort

    cfg = ApproxConfig.from_settings(settings, table)
    if cfg is None or table.n_rows == 0:
        return None
    device = resolve_device(device)
    chunk = chunk or CHUNK
    link_type = settings["link_type"]
    n = table.n_rows
    seconds: dict = {}
    band_codes, uniq_keys, idf = compute_band_codes(table, cfg, device=device, seconds=seconds)
    t0 = time.perf_counter()
    oversize = _null_oversize_buckets(band_codes)

    if link_type == "link_only":
        assert n_left is not None
        ranks = np.zeros(n, np.int32)
        uid_codes = None
        side = np.zeros(n, np.int32)
        side[n_left:] = 1
    else:
        ranks, _ = _uid_ranks(table, link_type)
        uid_codes = _uid_mask_codes(table, link_type)
        side = np.zeros(n, np.int32)
    # link_only: left and right rows meet as rectangles; otherwise the uid
    # rank is the sort's third key, so the triangle decode's a < b IS
    # rank_i < rank_j
    ent_rank = np.zeros(n, np.int32) if link_type == "link_only" else ranks.astype(np.int32)
    all_rows = np.arange(n, dtype=np.int32)
    rules = []
    for b in range(cfg.bands):
        order, starts, lz, rz = segment_sort(band_codes[b], side, ent_rank, all_rows, device)
        if link_type == "link_only":
            both = (lz > 0) & (rz > 0)
            units = _units_for_cross_join(starts[both], lz[both], starts[both] + lz[both],
                                          rz[both], chunk)
        else:
            units = _units_for_self_join(starts, lz, chunk)
        if units is None:  # pragma: no cover - MAX_BUCKET_ROWS forbids it
            return None
        ua, la, ub, lb = units
        rules.append(DeviceRule(
            rule=f"approx:band{b}", order=np.ascontiguousarray(order, dtype=np.int32),
            ua=ua.astype(np.int32), la=la.astype(np.int32),
            ub=ub.astype(np.int32), lb=lb.astype(np.int32),
            pc=_pair_counts(ua, la, ub, lb), rank_filter=False,
        ))
    device_plan = DeviceBlockPlan(
        rules=rules, codes_l=band_codes, codes_r=band_codes,
        ranks=np.ascontiguousarray(ranks, dtype=np.int32), uid_codes=uid_codes,
        device=device, res_ops=[], chunk=chunk,
    )
    seconds["band_plan"] = time.perf_counter() - t0
    return ApproxPlan(config=cfg, band_codes=band_codes, device_plan=device_plan,
                      oversize_buckets=oversize, band_uniq_keys=uniq_keys, idf=idf,
                      seconds=seconds)


# --------------------------------------------------------------------------
# Candidate generation + exact-rule dedup + verification
# --------------------------------------------------------------------------


def _exact_rule_predicates(settings: dict, table: EncodedTable):
    """[(codes_l, codes_r, residual)] for every exact blocking rule: the
    predicates the approximate candidates are deduplicated against
    (``blocking._rule_holds`` semantics, the reference's ``AND NOT
    ifnull(previous_rule, false)``)."""
    out = []
    for rule in settings.get("blocking_rules") or []:
        eq_pairs, residual = parse_blocking_rule(rule)
        sym, asym, residual = _split_join_keys(eq_pairs, residual)
        if not sym and not asym:
            out.append((None, None, residual))
        elif asym:
            cl, cr = _key_codes_asym(table, sym, asym)
            out.append((cl, cr, residual))
        else:
            c = _key_codes(table, sym)
            out.append((c, c, residual))
    return out


def generate_approx_candidates(settings: dict, table: EncodedTable, n_left: int | None = None,
                               plan: ApproxPlan | None = None, device=None):
    """The top LSH candidate pairs with their ranking estimates.

    Returns ``(i, j, collisions, sim, stats)`` host arrays (``sim`` is
    all-zero when ``approx_threshold == 0``, verification off) with the
    exact tier's overlap removed and the threshold filter applied, or None
    when the tier is unavailable. The held candidates are pruned on the
    device to the running top-``approx_pair_budget`` under the emission
    ranking whenever they pass ``budget + max(budget, 4 * VERIFY_CHUNK)``,
    so the arrays hold O(budget) pairs and the pruning never changes what
    :func:`approx_block_into` emits; ``stats["survivors"]`` counts every
    threshold survivor. ``stats["seconds"]`` holds the host seconds of the
    candidate emission, the exact-rule dedup, the verification and the
    pruning. The plan is built on ``device`` (``cuda`` unless named) when
    none is given."""
    from ..blocking_device import iter_device_pairs

    if plan is None:
        plan = build_approx_plan(settings, table, n_left, device=device)
    if plan is None:
        return None
    device = plan.device_plan.device
    cfg = plan.config
    with_jaccard = cfg.threshold > 0.0
    preds = _exact_rule_predicates(settings, table)
    weighted = bool(cfg.tf_weighting and with_jaccard and plan.idf is not None)
    verify_chunk = VERIFY_CHUNK_CUDA if device.type == "cuda" else VERIFY_CHUNK
    bc_dev = _upload(plan.band_codes, device)
    aux = []
    idf_dev = None
    if with_jaccard:
        for bytes_, lengths, mask, count in _verify_aux(table, cfg):
            aux.append((_upload_chars(bytes_, device), _upload(lengths, device),
                        _upload(mask.view(np.int32), device), _upload(count, device)))
        if weighted:
            idf_dev = _upload(np.asarray(plan.idf, np.float32), device)
    thr = torch.tensor(np.float32(cfg.threshold), device=device)

    chunk_cap = int(settings.get("blocking_chunk_pairs") or 0) or (1 << 22)
    # the budget shapes nothing in the plan, so it is read from the
    # CALLER's settings: a reused plan composes with another budget
    budget = int(settings.get("approx_pair_budget") or cfg.budget)
    prune_cap = budget + max(budget, 4 * VERIFY_CHUNK)
    held: list[tuple] = []
    n_held = 0
    raw = survivors = overlap_removed = 0
    sec = {"emit": 0.0, "dedup": 0.0, "verify": 0.0, "prune": 0.0, "verify_calls": 0}

    def concat():
        if not held:
            return None
        return tuple(torch.cat([h[k] for h in held]) for k in range(4))

    def prune():
        nonlocal n_held
        i, j, c, s = concat()
        keep = rank_order(i, j, c, s)[:budget]
        held[:] = [(i[keep], j[keep], c[keep], s[keep])]
        n_held = int(keep.shape[0])

    pairs = iter_device_pairs(plan.device_plan, chunk_cap)
    while True:
        t0 = time.perf_counter()
        nxt = next(pairs, None)
        t1 = time.perf_counter()
        sec["emit"] += t1 - t0
        if nxt is None:
            break
        _r, ci, cj = nxt
        raw += len(ci)
        keep = np.ones(len(ci), bool)
        for cl, cr, residual in preds:
            keep &= ~_rule_holds(table, cl, cr, residual, ci, cj)
        kept = int(np.count_nonzero(keep))
        overlap_removed += len(ci) - kept
        if kept < len(ci):
            ci, cj = ci[keep], cj[keep]
        t2 = time.perf_counter()
        sec["dedup"] += t2 - t1
        for s in range(0, len(ci), verify_chunk):
            it = _upload(ci[s:s + verify_chunk], device, torch.int64)
            jt = _upload(cj[s:s + verify_chunk], device, torch.int64)
            coll, sim = verify_pairs(it, jt, bc_dev, aux, cfg.q, with_jaccard, idf_dev)
            sec["verify_calls"] += 1
            if with_jaccard:
                ok = torch.nonzero(sim >= thr).flatten()
                it, jt, coll, sim = it[ok], jt[ok], coll[ok], sim[ok]
            n = int(it.shape[0])
            survivors += n
            if not n:
                continue
            held.append((it.to(torch.int32), jt.to(torch.int32), coll, sim))
            n_held += n
            if n_held > prune_cap:
                t3 = time.perf_counter()
                prune()
                sec["prune"] += time.perf_counter() - t3
        sec["verify"] += time.perf_counter() - t2
    sec["verify"] -= sec["prune"]
    out = concat()
    if out is None:
        z = np.zeros(0, np.int32)
        i, j, coll, sim = z, z.copy(), z.copy(), np.zeros(0, np.float32)
    else:
        i, j, coll, sim = (t.cpu().numpy() for t in out)
    stats = {
        "bands": cfg.bands,
        "rows_per_band": cfg.rows_per_band,
        "q": cfg.q,
        "cols": list(cfg.cols),
        "candidates": raw,
        "exact_overlap_removed": int(overlap_removed),
        "verified": with_jaccard,
        "tf_weighted": weighted,
        "survivors": survivors,
        "oversize_buckets_dropped": plan.oversize_buckets,
        "seconds": sec,
    }
    return i, j, coll, sim, stats


def approx_block_into(settings: dict, table: EncodedTable, n_left: int | None, sink,
                      pair_consumer=None, device=None) -> int:
    """Run the approximate tier into the caller's sink AFTER the exact
    rules, on ``device`` (``cuda`` unless named): rank the candidates best
    first and emit budget-ordered chunks up to ``approx_pair_budget``.
    Returns the number of pairs emitted (0 when the tier is unavailable).
    An error propagates."""
    from ..obs.events import publish

    t0 = time.perf_counter()
    plan = build_approx_plan(settings, table, n_left, device=device)
    if plan is None:
        return 0
    t1 = time.perf_counter()
    i, j, coll, sim, stats = generate_approx_candidates(settings, table, n_left, plan=plan)
    t2 = time.perf_counter()
    budget = int(settings.get("approx_pair_budget") or DEFAULT_BUDGET)
    # verified Jaccard first (all zero without verification), collisions
    # second, (i, j) last
    order = rank_order(*(torch.from_numpy(a) for a in (i, j, coll, sim)))[:budget].numpy()
    t3 = time.perf_counter()
    emitted = len(order)
    chunk_cap = int(settings.get("blocking_chunk_pairs") or 0) or (1 << 22)
    for s in range(0, emitted, chunk_cap):
        sel = order[s : s + chunk_cap]
        ei = i[sel].astype(sink.idx_dtype, copy=False)
        ej = j[sel].astype(sink.idx_dtype, copy=False)
        sink.append(ei, ej)
        if pair_consumer is not None:
            pair_consumer(ei, ej)
    stats["seconds"].update(plan.seconds, plan_total=t1 - t0, candidates_total=t2 - t1,
                            ranking=t3 - t2, emit_to_sink=time.perf_counter() - t3)
    fill = round(emitted / budget, 4) if budget else 0.0
    publish("blocking_approx", **stats, budget=budget, emitted=emitted, budget_fill=fill)
    last_run.clear()
    last_run.update(stats, budget=budget, emitted=emitted, budget_fill=fill,
                    device=str(plan.device_plan.device))
    logger.info("approximate blocking: %d candidate(s), %d emitted under budget %d",
                stats["candidates"], emitted, budget)
    return emitted
