"""Shape-bucketed query engine over a :class:`LinkageIndex`, on PyTorch.

The port of splink_tpu/serve/engine.py. The reference composes one jitted
XLA program per (query-bucket, candidate-bucket) shape from three parts;
here each part is a plain function on tensors on the index's device,
under the reference's name, so it can be timed and checked alone:

  encode_query       padding hygiene on the uploaded query buffers: rows
                     past the batch's real length are zeroed and their rule
                     buckets forced to -1 on the device, so the host can
                     upload uninitialised buffers and stale bytes never
                     reach a kernel or a score.
  candidate_gather   device hash-bucket lookup: each query's per-rule
                     (and, with the approximate tier, per-LSH-band)
                     bucket id dereferences the index's CSR
                     (starts/sizes/rows_sorted) into a padded (Q, C)
                     candidate matrix; positions are clamped into the
                     rule's rows before every read (an index out of range
                     is a device-side assert on CUDA, not a clip), and a
                     candidate an earlier rule already produced is masked
                     (sequential-rule dedup).
  score_topk /       the two packed-row reads (query side a broadcast,
  score_fused        reference side one gather), the comparison columns
                     through the shared ``gammas._spec_gamma`` (the dense
                     CUDA Jaro-Winkler and Levenshtein kernels on the
                     card), log-space Fellegi-Sunter scoring and a
                     row-wise top-k of k max/mask passes. ``score_topk`` is
                     the unfused oracle (the gamma matrix, then
                     ``match_probability`` or ``fold_logit``);
                     ``score_fused`` folds each column into a running log
                     Bayes factor and is the default.

The association of every float operation is the offline one: ``log_bf``
accumulates left to right over the columns, then ``prior_logit + log_bf``
(+ the TF deltas through ``term_frequencies.tf_fold_logit``). So on one
device and in one float type served probabilities equal the port's
offline ``match_probability`` (and ``tf_match_probability``) bit for bit,
and the fused and unfused paths equal each other.

Each batch dispatches its device work without a host read and fetches its
four result arrays once at the end. The port compiles nothing per shape:
the bucket menu is kept because chunk boundaries and candidate capacities
decide which slots a query's candidates take, and top-k breaks ties by
slot. ``warmup`` runs every shape once, which builds the kernel libraries
if they are not built yet; after it no batch builds anything
(``obs.metrics`` counts the builds).

``aot_dir=`` names the engine's AOT sidecar (serve/aot.py): ``save_aot``
stores the kernel libraries there after ``warmup``, and a fresh engine
restores them in ``warmup`` (or at its first query), before its first
kernel launch or query encode, so that it builds nothing. The sidecar is
bound to the environment and to :meth:`QueryEngine._aot_binding`, the
reference's keys: a sidecar saved under one bucket menu, top-k or scoring
path does not serve another.

``sketch=`` (default: the ``quality_profile`` setting) turns on the
serve-time drift sketch (obs/drift.py) over an index that carries a quality
profile: after each full-service batch the top-k winners' gamma levels are
recomputed and counted into a device accumulator on the same stream, with
no host read; ``drain_drift`` reads it between batches.
"""

from __future__ import annotations

import contextlib
import logging
import os
import time

import numpy as np
import torch

from ..analysis import lockwatch
from ..utils.logging_utils import warn_degraded

logger = logging.getLogger("splink_tpu_torch")


class IndexSwapError(RuntimeError):
    """A hot-swap candidate index failed to load or validate; the swap was
    rolled back and the previous index is still serving."""


# ---------------------------------------------------------------------------
# The three programs, as functions on tensors
# ---------------------------------------------------------------------------


def encode_query(packed_q, qbuckets, valid: int):
    """In place on the device: zero the packed rows past ``valid`` and set
    their buckets to -1. Returns (packed_q, qbuckets)."""
    packed_q[valid:] = 0
    qbuckets[:, valid:] = -1
    return packed_q, qbuckets


def candidate_gather(qbuckets, starts, sizes, rows, row_bucket, capacity: int):
    """(cand (Q, C) int64, valid (Q, C) bool, n_cand (Q,) int32).

    Per query, rule r's bucket fills slots [offset_r, offset_r + size_r),
    offset_r the running sum of the earlier rules' bucket sizes: the
    emission order of offline blocking. A candidate whose row lies in an
    EARLIER rule's bucket for this query is masked invalid. ``qbuckets`` is
    (n_rules, Q) int32; the CSR arrays are per-rule int64 tensors. The
    approximate tier's LSH bands follow the rules as more "rules" with the
    same dedup: a band's candidate an earlier band (or rule) produced is
    masked."""
    q_n = qbuckets.shape[1]
    dev = qbuckets.device
    slot = torch.arange(capacity, dtype=torch.int64, device=dev)[None, :]
    cand = torch.zeros((q_n, capacity), dtype=torch.int64, device=dev)
    valid = torch.zeros((q_n, capacity), dtype=torch.bool, device=dev)
    offset = torch.zeros((q_n, 1), dtype=torch.int64, device=dev)
    zero = torch.zeros((), dtype=torch.int64, device=dev)
    qbs = [qbuckets[r].to(torch.int64)[:, None] for r in range(len(starts))]
    for r in range(len(starts)):
        qb = qbs[r]  # (Q, 1)
        has = qb >= 0
        qb0 = torch.where(has, qb, zero)
        cnt = torch.where(has, sizes[r][qb0], zero)  # (Q, 1)
        local = slot - offset  # (Q, C)
        in_r = (local >= 0) & (local < cnt)
        limit = max(rows[r].shape[0] - 1, 0)
        pos = torch.clamp(starts[r][qb0] + local, 0, limit)
        cand_r = rows[r][pos]
        dup = torch.zeros(in_r.shape, dtype=torch.bool, device=dev)
        for j in range(r):
            dup = dup | ((qbs[j] >= 0) & (row_bucket[j][cand_r] == qbs[j]))
        cand = torch.where(in_r, cand_r, cand)
        valid = valid | (in_r & ~dup)
        offset = offset + cnt
    n_cand = valid.sum(dim=1, dtype=torch.int32)
    return cand, valid, n_cand


def _top_k_rowwise(scores, k: int):
    """(Q, C) -> ((Q, k) values, (Q, k) int64 indices): descending, ties by
    ascending index (the first index attaining the max), from k max/mask
    passes as in the reference. A taken slot is masked with -2."""
    c = scores.shape[1]
    col = torch.arange(c, dtype=torch.int64, device=scores.device)[None, :]
    # torchlint: disable=JL003 (the top-k's device constants: counted in serve_score_*'s cuda allow_syncs)
    big = torch.tensor(c, dtype=torch.int64, device=scores.device)
    taken = torch.tensor(-2.0, dtype=scores.dtype, device=scores.device)  # torchlint: disable=JL003 (the top-k's mask constant: counted in serve_score_*'s cuda allow_syncs)
    masked = scores
    vals, idxs = [], []
    for _ in range(k):
        m = masked.max(dim=1, keepdim=True).values  # (Q, 1)
        i = torch.where(masked == m, col, big).min(dim=1).values
        i = torch.clamp(i, max=c - 1)
        vals.append(m[:, 0])
        idxs.append(i)
        masked = torch.where(col == i[:, None], taken, masked)
    return torch.stack(vals, dim=1), torch.stack(idxs, dim=1)


def _finish_topk(p, cand, valid, k: int):
    """Shared tail of both scoring paths: invalid slots score -1, the
    row-wise top-k, and the winning slots mapped back to reference rows
    (int32). A row with fewer than k valid candidates re-picks slot 0 at
    the -2 mask once its real entries are exhausted; ``top_p > -0.5``
    keeps such re-picks from reading slot 0's valid flag."""
    q_n, capacity = cand.shape
    # torchlint: disable=JL003 (the invalid slots' -1: counted in serve_score_*'s cuda allow_syncs)
    neg = torch.tensor(-1.0, dtype=p.dtype, device=p.device)
    scores = torch.where(valid.reshape(-1), p, neg).reshape(q_n, capacity)
    top_p, top_i = _top_k_rowwise(scores, k)
    top_rows = torch.take_along_dim(cand, top_i, dim=1).to(torch.int32)
    top_valid = torch.take_along_dim(valid, top_i, dim=1) & (top_p > -0.5)
    return top_p, top_rows, top_valid


def _pair_rows(packed_q, packed_ref, cand):
    """The (Q*C, lanes) query rows (each query repeated C times) and the
    gathered reference rows of the candidates, with the flat candidates."""
    q_n, capacity = cand.shape
    rows_l = packed_q[:, None, :].expand(q_n, capacity, packed_q.shape[1])
    rows_l = rows_l.reshape(q_n * capacity, packed_q.shape[1])
    rflat = cand.reshape(-1)
    return rows_l, packed_ref.index_select(0, rflat), rflat


def _tf_logit(tf_spec, z, log_u, tf_q, tf_tid, tf_log, capacity, rflat):
    """``z`` plus the TF deltas of the pairs, through the offline
    ``tf_fold_logit`` (the same expression and accumulation order)."""
    from ..term_frequencies import tf_fold_logit

    tids_l = [t.repeat_interleave(capacity) for t in tf_q]
    tids_r = [t.index_select(0, rflat) for t in tf_tid]
    return tf_fold_logit(tf_spec, z, log_u, tids_l, tids_r, tf_log)


def score_topk(layout, comparison_columns, k: int, packed_q, packed_ref, cand,
               valid, params, tf_spec=(), tf_q=(), tf_tid=(), tf_log=()):
    """The UNFUSED scoring path, kept as the oracle of :func:`score_fused`:
    the full (Q*C, n_cols) gamma matrix, then ``match_probability`` (or
    ``fold_logit`` + the TF fold), then the top-k. Returns (top_p,
    top_rows, top_valid)."""
    from ..gammas import PairContext, _spec_gamma
    from ..models.fellegi_sunter import (
        _safe_log,
        flush_subnormal,
        fold_logit,
        match_probability,
    )

    rows_l, rows_r, rflat = _pair_rows(packed_q, packed_ref, cand)
    ctx = PairContext(layout, rows_l, rows_r)
    G = torch.stack([_spec_gamma(c, ctx, False) for c in comparison_columns], dim=1)
    if not tf_spec:
        p = match_probability(G, params)
    else:
        z = _tf_logit(tf_spec, fold_logit(G, params), _safe_log(params.u),
                      tf_q, tf_tid, tf_log, cand.shape[1], rflat)
        p = flush_subnormal(torch.sigmoid(z))
    return _finish_topk(p, cand, valid, k)


def score_fused(layout, comparison_columns, k: int, packed_q, packed_ref, cand,
                valid, params, tf_spec=(), tf_q=(), tf_tid=(), tf_log=()):
    """The fused path (the default): each column's gamma levels fold into a
    running log Bayes factor as they are computed, without the gamma
    matrix. Per column every step is the unfused expression (the same
    ``_safe_log`` tables, the same per-level compare-and-mask in level
    order, the same null masking); across columns the accumulation is the
    left-to-right fold of ``fold_logit``. Returns (top_p, top_rows,
    top_valid), equal bit for bit to :func:`score_topk`."""
    from ..gammas import PairContext, _spec_gamma
    from ..models.fellegi_sunter import _prior_logit, _safe_log, flush_subnormal

    rows_l, rows_r, rflat = _pair_rows(packed_q, packed_ref, cand)
    ctx = PairContext(layout, rows_l, rows_r)
    log_m = _safe_log(params.m)
    log_u = _safe_log(params.u)
    dt, dev = log_m.dtype, log_m.device
    zero = torch.zeros((), dtype=dt, device=dev)
    log_bf = torch.zeros(rows_l.shape[0], dtype=dt, device=dev)
    for ci, c in enumerate(comparison_columns):
        g = _spec_gamma(c, ctx, False)
        lp_m = torch.zeros(g.shape, dtype=dt, device=dev)
        lp_u = torch.zeros(g.shape, dtype=dt, device=dev)
        for lv in range(log_m.shape[1]):
            hit = g == lv
            lp_m = lp_m + torch.where(hit, log_m[ci, lv], zero)
            lp_u = lp_u + torch.where(hit, log_u[ci, lv], zero)
        present = g >= 0
        log_bf = log_bf + (
            torch.where(present, lp_m, zero) - torch.where(present, lp_u, zero)
        )
    z = _prior_logit(params.lam) + log_bf
    if tf_spec:
        z = _tf_logit(tf_spec, z, log_u, tf_q, tf_tid, tf_log, cand.shape[1], rflat)
    return _finish_topk(flush_subnormal(torch.sigmoid(z)), cand, valid, k)


# ---------------------------------------------------------------------------
# Engine
# ---------------------------------------------------------------------------


class QueryEngine:
    """Low-latency query interface over a resident :class:`LinkageIndex`,
    on the index's device. One engine owns one index's device residency;
    run :meth:`warmup` before taking traffic."""

    def __init__(self, index, *, top_k: int | None = None, policy=None,
                 brownout_top_k: int | None = None, fused: bool | None = None,
                 aot_dir=None, sketch: bool | None = None,
                 tf_adjust: bool | None = None):
        from .bucketing import BucketPolicy, bucket_for

        self.index = index
        self.device = index.device
        settings = index.settings
        # fused scoring is the default; the unfused path is the oracle
        self.fused = bool(settings.get("serve_fused", True) if fused is None else fused)
        # the TF u-probability fold: on whenever the index carries fold
        # data (serve_tf_adjust gate); tf_adjust= overrides the gate but
        # never conjures a fold for an index without the data
        self._tf_override = tf_adjust  # forwarded across swap_index
        want_tf = bool(
            settings.get("serve_tf_adjust", True) if tf_adjust is None else tf_adjust
        )
        self.tf_spec = tuple(index.tf_fold_columns()) if want_tf else ()
        if want_tf and not self.tf_spec and index.tf_tables:
            logger.warning(
                "index carries TF count tables but no per-row token ids "
                "(artifact built before the TF fold); serving UNADJUSTED "
                "scores — re-export the index to enable serve-time TF "
                "adjustment"
            )
        self.top_k = int(
            top_k if top_k is not None else settings.get("serve_top_k", 5) or 5
        )
        self.policy = policy or BucketPolicy.from_settings(settings)
        if self.top_k > self.policy.candidate_buckets[-1]:
            raise ValueError(
                f"serve_top_k={self.top_k} exceeds the largest candidate "
                f"bucket ({self.policy.candidate_buckets[-1]}); widen "
                "serve_candidate_buckets — top-k cannot exceed the padded "
                "candidate capacity"
            )
        # brown-out tier: a smaller top-k over the smallest candidate
        # bucket that covers it, served under pressure instead of shedding
        self.brownout_top_k = int(
            brownout_top_k
            if brownout_top_k is not None
            else settings.get("serve_brownout_top_k", 0) or 0
        )
        if self.brownout_top_k < 0 or self.brownout_top_k > self.top_k:
            raise ValueError(
                f"serve_brownout_top_k={self.brownout_top_k} must be in "
                f"[0, serve_top_k={self.top_k}] — the brown-out tier serves "
                "a REDUCED budget"
            )
        self.brownout_capacity = (
            bucket_for(self.brownout_top_k, self.policy.candidate_buckets)
            if self.brownout_top_k
            else None
        )
        # the serve-time drift sketch (obs/drift.py): needs the
        # quality_profile gate (``sketch=`` overrides it, as ``fused=`` does)
        # AND a profiled index; a profile-less index serves unchanged
        self.sketch = None
        self._sketch_override = sketch  # forwarded across swap_index
        want_sketch = (
            bool(settings.get("quality_profile")) if sketch is None else bool(sketch)
        )
        if want_sketch and index.profile is not None:
            from ..obs.drift import ServeSketch

            self.sketch = ServeSketch(index, index.profile)
        self._warmed: set[tuple[int, int]] = set()
        self._warmed_brownout: set[tuple[int, int]] = set()
        # serializes batch dispatch against index hot-swap: a dispatch in
        # flight finishes on the index it started on, and the swap flip is
        # atomic with respect to the next dispatch
        self._swap_lock = lockwatch.new_rlock("QueryEngine._swap_lock")
        # serializes swap_index against itself (the dispatch lock stays free
        # during a swap's long validation)
        self._swap_mutex = lockwatch.new_lock("QueryEngine._swap_mutex")
        self._probes = None  # (query df, recorded answer arrays)
        self._generation = 0
        # the AOT library sidecar (serve/aot.py): restored once, before the
        # first kernel launch or query encode; save_aot() writes it
        self._aot_dir = os.fspath(aot_dir) if aot_dir else None
        self._aot_store = None  # memoised validated AotStore (or False)
        self._aot_checked = False

    # -- AOT library sidecar --------------------------------------------

    # threadlint: holds=_swap_lock (warmup/query/save_aot enter locked)
    def _aot_binding(self) -> dict:
        """The strict-invalidation identity a sidecar is bound to, the
        reference's keys (serve/aot.py adds the environment half)."""
        index = self.index
        return {
            "index_state_hash": index.state_hash,
            "index_fingerprint": index.content_fingerprint(),
            "dtype": index.dtype,
            "n_rules": len(index.rules),
            "n_approx_bands": 0 if index.approx is None else index.approx.bands,
            "top_k": self.top_k,
            "brownout_top_k": self.brownout_top_k,
            "query_buckets": list(self.policy.query_buckets),
            "candidate_buckets": list(self.policy.candidate_buckets),
            "fused": self.fused,
            "sketch": self.sketch is not None,
            "tf": bool(self.tf_spec),
        }

    # threadlint: holds=_swap_lock (warmup/query/save_aot enter locked)
    def _aot_ready_store(self):
        """The validated sidecar store, memoised; None when no sidecar is
        configured, present or valid (each invalidation emits one
        ``serve_aot`` degradation event; the libraries then build from
        sources)."""
        if self._aot_store is None:
            self._aot_store = False
            if self._aot_dir is not None:
                from .aot import AotStore

                store = AotStore(self._aot_dir)
                if store.validate(self._aot_binding(), self.device):
                    self._aot_store = store
        return self._aot_store or None

    # threadlint: holds=_swap_lock (warmup/query enter locked)
    def _aot_restore(self) -> int:
        """Restore the sidecar's libraries once, before anything loads
        them; a library already loaded or on disk is left as it is.
        Returns how many were written."""
        if self._aot_checked:
            return 0
        self._aot_checked = True
        store = self._aot_ready_store()
        return 0 if store is None else store.restore_all(self.device)

    def restore_aot(self) -> int:
        """Restore the sidecar's libraries now (``warmup`` and the first
        query do it otherwise); returns how many were written. Idempotent:
        a second call, or a library already loaded or on disk, writes
        nothing."""
        with self._swap_lock:
            return self._aot_restore()

    def save_aot(self, directory=None) -> str:
        """Store the kernel libraries this engine loads (the host library,
        and the CUDA kernels on a card) as an AOT sidecar at ``directory``
        (default: the engine's ``aot_dir``), bound to the index
        fingerprint, settings hash, shape menu and environment. Call after
        :meth:`warmup`. Returns the sidecar's menu path."""
        from .aot import AotStore, build_libraries

        with self._swap_lock:
            directory = directory or self._aot_dir
            if not directory:
                raise ValueError(
                    "no sidecar directory: pass save_aot(directory) or "
                    "construct the engine with aot_dir="
                )
            if not self._warmed:
                raise RuntimeError(
                    "nothing to save: run warmup() first so the engine has "
                    "loaded its kernel libraries"
                )
            return AotStore.write(directory, self._aot_binding(),
                                  build_libraries(self.device), self.device)

    # -- dispatch -------------------------------------------------------

    def _on_device(self):
        """The engine's device as the calling thread's current CUDA device
        (a service worker thread starts on device 0 whatever the engine's
        device is); a no-op on the CPU."""
        # threadlint: disable=TL001 (write-once: set in __init__, a swap keeps it)
        if self.device.type == "cuda":
            return torch.cuda.device(self.device)  # threadlint: disable=TL001 (write-once)
        return contextlib.nullcontext()

    # threadlint: holds=_swap_lock
    def _dispatch(self, k: int, capacity: int, packed_q, qbuckets, n: int,
                  tf_q=()):
        """encode_query -> candidate_gather -> score on the device; returns
        the four result tensors on the device, nothing fetched."""
        index = self.index
        dev = index.device_state()
        packed_q, qbuckets = encode_query(packed_q, qbuckets, n)
        cand, cvalid, n_cand = candidate_gather(
            qbuckets, dev["starts"], dev["sizes"], dev["rows"], dev["row_bucket"],
            capacity,
        )
        tf_args = ()
        if self.tf_spec:
            tf_dev = index.tf_device_state()
            tf_args = (self.tf_spec, tf_q, tf_dev["tid"], tf_dev["log"])
        score = score_fused if self.fused else score_topk
        top_p, top_rows, top_valid = score(
            index.layout, index.settings["comparison_columns"], k,
            packed_q, dev["packed"], cand, cvalid, dev["params"], *tf_args,
        )
        return top_p, top_rows, top_valid, n_cand

    def _upload(self, arr: np.ndarray):
        return torch.from_numpy(arr).to(self.device)  # threadlint: disable=TL001 (write-once)

    # -- query paths ----------------------------------------------------

    def encode(self, df):
        """Host-side query encode (see LinkageIndex.encode_queries)."""
        with self._swap_lock:
            return self.index.encode_queries(df)

    def query_arrays(self, df, *, degraded: bool = False, profile=None,
                     approx_out: list | None = None):
        """Score a query DataFrame; returns ``(top_p, top_rows, top_valid,
        n_candidates)`` numpy arrays of shape (n, k) / (n,). ``top_rows``
        are reference ROW indices; map through ``index.unique_id`` for ids
        (``query`` does).

        ``approx_out``, when a list, receives one (n,) bool array marking
        the queries served through the approximate tier's fallback (their
        exact keys hit no bucket; their candidates come from LSH band
        buckets). How a pair is scored does not depend on it.

        ``degraded=True`` runs the brown-out tier: top-k ``brownout_top_k``
        over candidates truncated to ``brownout_capacity``.

        ``profile`` (an :class:`~..obs.reqtrace.PhaseProfile`) accumulates
        the batch's build/execute/transfer split: a synchronize on the
        engine's device splits the batch's single result fetch, adding no
        host read to the device work."""
        with self._swap_lock, self._on_device():
            self._aot_restore()
            k = self.brownout_top_k if degraded else self.top_k
            if degraded and not k:
                raise RuntimeError(
                    "brown-out tier is disabled (serve_brownout_top_k=0)"
                )
            batch = self.encode(df)
            if self.sketch is not None:
                # host-side sketch counters from the encoded batch (no device
                # work); brown-out batches only count as degraded (their
                # reduced top-k would skew the histograms)
                if degraded:
                    self.sketch.note_degraded(batch.n)
                else:
                    self.sketch.note_batch(df, batch, len(self.index.rules))
            if approx_out is not None:
                approx_out.append(batch.approx_used if batch.approx_used is not None
                                  else np.zeros(batch.n, bool))
            out_p = np.full((batch.n, k), -1.0, self.index.float_dtype)
            out_rows = np.zeros((batch.n, k), np.int32)
            out_valid = np.zeros((batch.n, k), bool)
            out_ncand = np.zeros(batch.n, np.int64)
            for q_pad, start, stop in self.policy.iter_query_chunks(batch.n):
                p, r, v, nc = self._run_chunk(
                    batch, start, stop, q_pad, degraded=degraded, profile=profile,
                )
                out_p[start:stop] = p[: stop - start]
                out_rows[start:stop] = r[: stop - start]
                out_valid[start:stop] = v[: stop - start]
                out_ncand[start:stop] = nc[: stop - start]
            return out_p, out_rows, out_valid, out_ncand

    # threadlint: holds=_swap_lock (only query_arrays calls this, locked)
    def _run_chunk(self, batch, start: int, stop: int, q_pad: int, *,
                   degraded: bool = False, profile=None):
        """One bucketed dispatch: pad the chunk to ``q_pad`` queries and its
        candidate axis to a policy bucket, run the three programs, fetch
        once."""
        index = self.index
        n = stop - start
        qb = batch.qbuckets[:, start:stop]
        if degraded:
            # brown-out: the candidate budget IS the truncation
            capacity = self.brownout_capacity
            k = self.brownout_top_k
        else:
            counts = index.candidate_counts(qb)
            need = max(int(counts.max(initial=0)), self.top_k, 1)
            capacity = self.policy.candidate_bucket(need)
            if capacity is None:
                capacity = self.policy.candidate_buckets[-1]
                warn_degraded(
                    "serve_candidates",
                    "truncated",
                    f"largest candidate block needs {need} slots but the "
                    f"largest candidate bucket is {capacity}; blocks are "
                    "truncated to the bucket (top-k over the truncated set)",
                    queries=n,
                )
            k = self.top_k
        if profile is not None:
            from ..obs.metrics import compile_totals

            c0 = compile_totals()[1]
        # uninitialised padding: encode_query zeroes it on the device
        packed_pad = np.empty((q_pad, index.n_lanes), np.uint32)
        packed_pad[:n] = batch.packed[start:stop]
        qb_pad = np.empty((len(index.gather_units), q_pad), np.int32)
        qb_pad[:, :n] = qb
        tf_q = ()
        if self.tf_spec:
            # padding rows carry token id -1 (never agrees): the fold is
            # inert on them
            bufs = np.full((len(self.tf_spec), q_pad), -1, np.int32)
            bufs[:, :n] = batch.tf_tids[:, start:stop]
            tf_q = tuple(self._upload(b) for b in bufs)
        packed_dev = self._upload(packed_pad.view(np.int32))
        outs = self._dispatch(k, capacity, packed_dev, self._upload(qb_pad), n, tf_q)
        if self.sketch is not None and not degraded:
            # fold the batch into the drift accumulator, queued on the same
            # stream after the scoring it reads: nothing is read back
            top_p, top_rows, top_valid, _ = outs
            self.sketch.update(packed_dev, index.device_state()["packed"],
                               top_rows, top_valid, top_p)
        (self._warmed_brownout if degraded else self._warmed).add((q_pad, capacity))
        if profile is None:
            return tuple(t.cpu().numpy() for t in outs)
        profile.compile_s += max(compile_totals()[1] - c0, 0.0)
        t0 = time.perf_counter()
        if self.device.type == "cuda":
            # threadlint: disable=TL002 (a profiled batch times the card inside its lock span)
            torch.cuda.synchronize(self.device)
        t1 = time.perf_counter()
        profile.execute_s += t1 - t0
        out = tuple(t.cpu().numpy() for t in outs)
        profile.transfer_s += time.perf_counter() - t1
        return out

    def query(self, df):
        """Score a query DataFrame; returns a tidy DataFrame with one row
        per (query, match): query id, matched reference id, rank, match
        probability, the query's candidate count and, when the index
        carries the approximate tier, an ``approx`` flag marking matches
        found through its fallback."""
        import pandas as pd

        approx_out: list = []
        # one lock span across scoring AND the uid mapping: a hot-swap
        # committing between them would map rows scored on the old index
        # through the new index's unique_id column
        with self._swap_lock:
            top_p, top_rows, top_valid, n_cand = self.query_arrays(df, approx_out=approx_out)
            ref_uid = self.index.unique_id
            q_idx, rank = np.nonzero(top_valid)
            uid_col = self.index.settings["unique_id_column_name"]
            query_uid = (
                df[uid_col].to_numpy() if uid_col in df.columns else np.arange(len(df))
            )
            out = {
                f"{uid_col}_q": query_uid[q_idx],
                f"{uid_col}_m": ref_uid[top_rows[q_idx, rank]],
                "rank": rank.astype(np.int64),
                "match_probability": top_p[q_idx, rank],
                "n_candidates": n_cand[q_idx],
            }
            if self.index.approx is not None:
                out["approx"] = approx_out[0][q_idx]
            return pd.DataFrame(out)

    # -- warmup ---------------------------------------------------------

    def warmup(self) -> dict:
        """Run every (query-bucket, candidate-bucket) combination once, and
        the brown-out tier's (query-bucket, ``brownout_capacity``) shapes
        when it is enabled, on a batch whose rows are all padding (so
        every slot is invalid, yet every program and kernel launches at the
        shape). With a valid AOT sidecar its libraries are restored first;
        then the first run builds whatever library is still missing; after
        warmup no batch builds anything. Returns ``combinations``,
        ``compiles`` (library builds during warmup), ``compile_s`` (their
        seconds) and ``aot_restored`` (libraries restored from the
        sidecar)."""
        from ..obs.metrics import compile_stats

        with self._swap_lock:
            s0 = compile_stats()
            self._aot_restore()
        combos = self.policy.warmup_combinations()
        for q_pad, capacity in combos:
            self._warm_one(q_pad, capacity)
        brownout_combos = []
        if self.brownout_top_k:
            brownout_combos = [
                (qb, self.brownout_capacity) for qb in self.policy.query_buckets
            ]
            for q_pad, capacity in brownout_combos:
                self._warm_one(q_pad, capacity, degraded=True)
        # the drift sketch once per query bucket, on an all-invalid batch
        with self._swap_lock, self._on_device():
            if self.sketch is not None:
                for q_pad in self.policy.query_buckets:
                    self.sketch.warm(q_pad, self.top_k)
        s1 = compile_stats()
        return {
            "combinations": len(combos) + len(brownout_combos),
            "compiles": s1["compiles"] - s0["compiles"],
            "compile_s": s1["seconds"] - s0["seconds"],
            "aot_restored": s1["aot_restores"] - s0["aot_restores"],
        }

    def _warm_one(self, q_pad: int, capacity: int, degraded: bool = False) -> None:
        with self._swap_lock, self._on_device():
            index = self.index
            k = self.brownout_top_k if degraded else self.top_k
            packed = self._upload(np.zeros((q_pad, index.n_lanes), np.int32))
            qb = self._upload(np.full((len(index.gather_units), q_pad), -1, np.int32))
            tf_q = tuple(
                self._upload(np.full(q_pad, -1, np.int32)) for _ in self.tf_spec
            )
            outs = self._dispatch(k, capacity, packed, qb, 0, tf_q)
            outs[0].cpu()  # execute fully
            (self._warmed_brownout if degraded else self._warmed).add((q_pad, capacity))

    @property
    def warmed_shapes(self) -> set:
        """The (query_bucket, candidate_bucket) combinations run so far
        (full-service tier; the brown-out tier's are in
        ``warmed_brownout_shapes``)."""
        with self._swap_lock:
            return set(self._warmed)

    @property
    def warmed_brownout_shapes(self) -> set:
        with self._swap_lock:
            return set(self._warmed_brownout)

    def probe(self) -> None:
        """Run the smallest shape end to end (programs, device and result
        fetch): the watchdog's circuit-breaker recovery probe."""
        self._warm_one(self.policy.query_buckets[0], self.policy.candidate_buckets[0])

    @property
    def generation(self) -> int:
        """How many hot-swaps this engine has committed."""
        with self._swap_lock:
            return self._generation

    @property
    def tf_active(self) -> bool:
        """Whether this engine folds the term-frequency u-probability
        adjustment into its served scores."""
        with self._swap_lock:
            return bool(self.tf_spec)

    # -- drift sketch drain ---------------------------------------------

    def drift_drain_due(self, cadence_s: float) -> bool:
        """Whether the drift accumulator is due a drain: no lock and no
        device work, a cheap poll for the service worker and watchdog. The
        swap lock is held for whole batches, and the watchdog must not
        stall on one; ``sketch`` only changes at a hot-swap, and racing one
        at worst answers for the outgoing sketch (corrected next poll)."""
        # threadlint: disable=TL001 (atomic reference read, see docstring)
        return self.sketch is not None and self.sketch.drain_due(cadence_s)

    def drain_drift(self):
        """Read and reset the drift accumulator into one window sketch
        (:class:`~..obs.drift.WindowSketch`), or None when sketching is
        off. The sketch's ONLY device read, made between batches by the
        service worker or by the watchdog when idle, never inside a
        dispatch."""
        with self._swap_lock, self._on_device():
            if self.sketch is None:
                return None
            return self.sketch.drain()

    # -- parity probes & index hot-swap ---------------------------------

    def capture_probes(self, df) -> int:
        """Record ``df`` and this engine's CURRENT answers for it as the
        parity probe set: :meth:`swap_index` replays these queries on a
        candidate index and requires bit-identical answers before
        committing. Returns the number of probes stored."""
        df = df.reset_index(drop=True).copy()
        with self._swap_lock:
            answers = self.query_arrays(df)
            self._probes = (df, answers)
        return len(df)

    @property
    def probe_count(self) -> int:
        """Stat-only accessor, deliberately lock-free: ``_probes`` is an
        atomically assigned tuple and the swap lock can be held for a whole
        batch, so a health poll must not stall on it. A read racing a
        capture or a swap returns the count of the old or of the new probe
        set, both truthful answers."""
        probes = self._probes  # threadlint: disable=TL001 (see docstring)
        return 0 if probes is None else len(probes[0])

    def swap_index(self, source, *, refresh_probes: bool = False) -> dict:
        """Hot-swap to a new :class:`LinkageIndex` with validation and
        rollback:

        1. load the candidate (a directory, loaded onto this engine's
           device with ``load_index``'s checks, or an in-memory index);
        2. build and warm a pending engine over it before the flip;
        3. replay the stored parity probes against the recorded answers;
           any difference (``refresh_probes=False``) fails the swap;
        4. flip index and warm state under the swap lock: a dispatch in
           flight finishes on the old index, the next runs on the new.

        Any failure before the flip emits a ``serve_index_swap``
        degradation and raises :class:`IndexSwapError` with the old index
        still serving. ``refresh_probes=True`` re-records the probe
        answers on the new index instead of comparing them."""
        with self._swap_mutex:
            return self._swap_index_serialized(source, refresh_probes)

    def _swap_index_serialized(self, source, refresh_probes: bool) -> dict:
        from ..obs.events import publish
        from ..resilience.faults import active_plan
        from .index import LinkageIndex, load_index

        t0 = time.perf_counter()
        with self._swap_lock:
            plan = active_plan(self.index.settings)
            generation = self._generation + 1
        try:
            plan.fire("swap_load", generation=generation)
            if isinstance(source, LinkageIndex):
                new_index = source
            else:
                # threadlint: disable=TL001 (write-once: a swap keeps the device)
                new_index = load_index(source, device=self.device)
        except Exception as e:  # noqa: BLE001 - every load failure rolls back
            warn_degraded(
                "serve_index_swap", "rolled_back",
                f"candidate index failed to load: {e}", generation=generation,
            )
            raise IndexSwapError(
                f"index swap rolled back (old index still serving): "
                f"candidate failed to load: {e}"
            ) from e
        probes_checked = 0
        new_probes = None
        with self._swap_lock:
            probes = self._probes  # snapshot: validation runs on THIS set
        try:
            pending = QueryEngine(
                new_index,
                top_k=self.top_k,
                policy=self.policy,
                brownout_top_k=self.brownout_top_k,
                fused=self.fused,
                sketch=self._sketch_override,
                tf_adjust=self._tf_override,
            )
            # threadlint: disable=TL001 (write-once: a swap keeps the engine's device)
            if pending.device != self.device:
                raise ValueError(f"candidate index is on {pending.device}, not on the "
                                 "engine's device")
            warm = pending.warmup()
            plan.fire("swap_validate", generation=generation)
            if probes is not None:
                probe_df, expected = probes
                got = pending.query_arrays(probe_df)
                if not refresh_probes:
                    _check_probe_parity(expected, got)
                    probes_checked = len(probe_df)
                new_probes = (probe_df, got)
        except Exception as e:  # noqa: BLE001 - every validation failure rolls back
            warn_degraded(
                "serve_index_swap", "rolled_back",
                f"candidate index failed validation: {e}", generation=generation,
            )
            raise IndexSwapError(
                f"index swap rolled back (old index still serving): {e}"
            ) from e
        with self._swap_lock:
            self.index = pending.index
            self.tf_spec = pending.tf_spec
            # the drift sketch binds to the new index's profile and device
            self.sketch = pending.sketch
            self._warmed = pending._warmed
            self._warmed_brownout = pending._warmed_brownout
            if new_probes is not None:
                self._probes = new_probes
            elif self._probes is not probes:
                # a capture landed DURING validation: its answers describe
                # the outgoing index, so drop them
                self._probes = None
            self._generation = generation
            n_rows = self.index.n_rows
        stats = {
            "generation": generation,
            "n_rows": n_rows,
            "warmup_combinations": warm["combinations"],
            "warmup_compiles": warm["compiles"],
            "probes_checked": probes_checked,
            "elapsed_s": round(time.perf_counter() - t0, 3),
        }
        publish("index_swap", **stats)
        logger.info(
            "serving index hot-swapped: generation %d, %d rows, "
            "%d probe(s) parity-checked, %.3fs",
            generation, n_rows, probes_checked, stats["elapsed_s"],
        )
        return stats


def _check_probe_parity(expected, got) -> None:
    """Raise with a diff summary unless the candidate engine's probe answers
    are BIT-identical to the recorded ones (same dtypes, shapes, values)."""
    names = ("top_p", "top_rows", "top_valid", "n_candidates")
    for name, e, g in zip(names, expected, got):
        if e.dtype != g.dtype or e.shape != g.shape:
            raise ValueError(
                f"probe parity failed on {name}: recorded "
                f"{e.shape}/{e.dtype} vs candidate {g.shape}/{g.dtype}"
            )
        if not np.array_equal(e, g):
            bad = int(np.sum(e != g))
            raise ValueError(
                f"probe parity failed on {name}: {bad}/{e.size} entries "
                "differ from the recorded answers (bit-identity required; "
                "pass refresh_probes=True for an intentional content change)"
            )
