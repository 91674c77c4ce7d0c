"""User-facing linker: splink_tpu's ``Splink`` on PyTorch.

Same API shape as splink_tpu/linker.py — ``Splink(settings, df=... |
df_l=..., df_r=...)``, ``get_scored_comparisons()``,
``estimate_parameters(checkpoint_dir=, resume=)``,
``manually_apply_fellegi_sunter_weights()``, the streaming entry points
(``stream_scored_comparisons``, ``stream_scored_comparisons_after_em``,
``stream_tf_adjusted_comparisons``), ``make_term_frequency_adjustments()``,
``save_model_as_json()``, ``export_index()`` (the serving artifact,
serve/) and module-level ``load_from_json`` — plus a ``device`` argument.

The regimes are the reference's, chosen the same way:

  * resident (pairs <= ``max_resident_pairs``): host blocking (the native
    host library) feeds a GammaStream while it runs, the int8 gamma matrix
    stays on the device, and EM runs on it in one ``run_em`` call;
  * pattern (pairs above it, pattern-capable settings): with
    ``device_pair_generation`` "auto" (a pair-count bound past the cap) or
    "on", the virtual pair index (pairgen.py) decodes candidate pairs on
    the device and one pass histograms their mixed-radix pattern ids;
    otherwise host blocking feeds a PatternStream. EM runs on the weighted
    pattern matrix; scoring is a host LUT gather streamed in chunks;
  * streamed (pairs above it, settings that cannot use patterns — a custom
    comparison, or a pattern space past MAX_PATTERNS): EM streams gamma
    micro-batches to the device, with checkpoint, resume and retry
    (parallel/streaming.py).

``checkpoint_dir`` makes EM durable in the resident and streamed regimes
(resilience/), and a device OOM in resident EM degrades to the streamed
regime on the same device. ``spill_dir`` streams the host pair index to
memmaps. ``build_spill_dir`` writes the pairs through the device tier's
sharded emission into a durable, resumable store (spill.py); past
``max_resident_pairs`` settings that cannot use patterns then train by
streaming gamma batches read from the store. ``approx_blocking`` adds the
approximate tier (approx/) after the exact rules, on the linker's device;
it needs materialised blocking, so it turns device pair generation off and
refuses ``build_spill_dir`` (blocking in memory with a degradation
warning), as the reference does.

Device rule: with no ``device`` the linker runs on ``cuda`` and raises when
no CUDA device exists; it never carries on quietly on the CPU. Pass
``device="cpu"`` to run the plain PyTorch versions on the CPU. Settings
that need a module not ported yet raise NotImplementedError naming its
ROADMAP.md item.

Observability (obs/, utils/profiling.py), as in the reference: every stage
runs under a ``StageTimer`` of this linker's run scope (``run_id``), which
also feeds ``stage_seconds``; ``telemetry_dir`` writes the run's JSONL
record (stage spans with device-memory snapshots, one EM record per update,
counters, gamma histograms, resilience events); ``profile_dir`` writes a
``torch.profiler`` trace of each device-heavy stage; every fit logs the EM
identifiability warnings (``obs.quality.em_diagnostics``).
"""

from __future__ import annotations

import contextlib
import copy
import logging
import os
import warnings
from typing import Callable

import numpy as np
import torch

from ._device import resolve_device
from .blocking import PairIndex, block_using_rules, estimate_pair_upper_bound
from .check_types import check_types
from .data import EncodedTable, concat_tables, encode_table
from .em import (
    run_em,
    run_em_checkpointed,
    score_pairs,
    score_pairs_with_intermediates,
    score_pairs_with_intermediates_logits,
    score_pairs_with_logits,
)
from .gammas import GammaProgram
from .obs.runtime import RunContext
from .params import Params, fsparams_from_numpy, load_params_from_json
from .settings import comparison_column_name, complete_settings_dict
from .term_frequencies import (
    make_adjustment_for_term_frequencies,
    make_tf_fold_fn,
    term_frequency_columns,
    tf_fold_spec,
    tf_log_table,
)
from .utils.profiling import StageTimer, begin_run

logger = logging.getLogger("splink_tpu_torch")

# Host RAM caps (candidate counts) for keeping the virtual pass's
# per-candidate pattern ids for a later score stream: 2^32 uint16 ids =
# 8.6 GB, 2^31 int32 ids = 8.6 GB. Above these the stream recomputes ids
# chunk-wise instead (virtual_materialise_ids="on" overrides).
_MAX_RESIDENT_IDS_U16 = 1 << 32
_MAX_RESIDENT_IDS_I32 = 1 << 31

try:  # pandas is required for the linker facade (not for the kernels)
    import pandas as pd
except ImportError:  # pragma: no cover
    pd = None


def _not_ported(what: str, item: str):
    return NotImplementedError(
        f"{what} needs {item} (ROADMAP.md), which splink_tpu_torch does not "
        "port yet"
    )


def _check_ported_settings(settings: dict) -> None:
    """Raise for every setting that needs a module not ported yet."""
    for key, item in (
        ("mesh", "multi-GPU, Queue 1 item 7"),
    ):
        if settings.get(key):
            raise _not_ported(f"a non-empty {key!r}", item)


def _gamma_histograms(settings, G, weights=None, chunk: int = 1 << 22,
                      G_dev=None) -> dict:
    """Per-comparison-column gamma-level histogram (telemetry record):
    column name -> [count at level -1 (null), level 0, ..., level L-1].
    ``G`` is either the per-pair gamma matrix or, with ``weights`` (the
    pattern-count vector), the pattern matrix. Chunked so the int64
    temporaries stay O(chunk). ``G_dev``, the resident device copy of
    ``G``, counts on its device instead (one read of each column's counts),
    so a resident job does not pay a host pass over its pairs."""
    cols = settings["comparison_columns"]
    if G_dev is not None:
        out = {}
        for c, col in enumerate(cols):
            levels = int(col["num_levels"])
            g = torch.clamp(G_dev[:, c].to(torch.int64) + 1, 0, levels)
            counts = torch.bincount(g, minlength=levels + 1)[: levels + 1]
            out[comparison_column_name(col)] = [int(v) for v in counts.cpu()]
        return out
    acc = [np.zeros(int(col["num_levels"]) + 1, np.float64) for col in cols]
    for s in range(0, len(G), chunk):
        Gc = G[s : s + chunk]
        w = weights[s : s + chunk] if weights is not None else None
        for c, col in enumerate(cols):
            levels = int(col["num_levels"])
            g = np.asarray(Gc[:, c], np.int64) + 1  # -1 (null) -> bin 0
            acc[c] += np.bincount(
                np.clip(g, 0, levels), weights=w, minlength=levels + 1
            )[: levels + 1]
    return {
        comparison_column_name(col): [int(v) for v in acc[c]]
        for c, col in enumerate(cols)
    }


class Splink:
    @check_types
    def __init__(
        self,
        settings: dict,
        df=None,
        df_l=None,
        df_r=None,
        save_state_fn: Callable = None,
        device=None,
    ):
        """Probabilistic data linker on PyTorch.

        Args:
            settings: splink settings dictionary (the splink_tpu schema).
            df: the single input DataFrame when link_type == dedupe_only.
            df_l, df_r: the two inputs for link_only / link_and_dedupe.
            save_state_fn: callable(params, settings) run after every EM
                iteration.
            device: torch device; default ``cuda`` (raises without one).
        """
        self.device = resolve_device(device)
        self.settings = complete_settings_dict(settings)
        _check_ported_settings(self.settings)
        self.params = Params(self.settings, complete=False)
        self.df = df
        self.df_l = df_l
        self.df_r = df_r
        self._n_left_released: int | None = None
        self.save_state_fn = save_state_fn
        self._check_args()
        # the run's observability scope: stage timings and the profiler
        # target keyed by this run's id; telemetry live iff telemetry_dir
        # is set (disabled, EM installs no per-update hook)
        self._obs = RunContext.from_settings(self.settings)
        begin_run(self._obs.run_id, self.settings.get("profile_dir") or None)
        self._table: EncodedTable | None = None
        self._pairs: PairIndex | None = None
        self._G: np.ndarray | None = None
        self._G_dev = None  # device copy of the gamma matrix (resident regime)
        self._P: np.ndarray | None = None  # per-pair pattern ids (materialised)
        self._pattern_counts: np.ndarray | None = None
        self._pattern_program: GammaProgram | None = None
        self._virtual = None  # pairgen.VirtualPlan (device pair generation)
        self._virtual_checked = False
        # per-candidate pattern ids from the virtual pass (sentinel kept),
        # kept when a score stream is known to follow (_virtual_ids_policy)
        self._P_virtual: np.ndarray | None = None
        self._virtual_want_ids = False
        self._pair_bound: int | None = None  # estimate_pair_upper_bound memo
        self._spill_tmp: str | None = None
        self._last_em_result = None
        self._tf_fold_cache = None
        # checkpoint/resume state of the current estimate_parameters call
        # (argument overrides; the settings keys are the fallback)
        self._ckpt_dir_arg: str | None = None
        self._ckpt_resume = False
        # stage name -> wall seconds of this linker's last run of it
        # (synchronised with the device at the stage's end)
        self.stage_seconds: dict[str, float] = {}

    @property
    def _float_dtype(self):
        return torch.float64 if self.settings["float64"] else torch.float32

    @property
    def _np_float(self):
        return np.float64 if self.settings["float64"] else np.float32

    def _check_args(self):
        link_type = self.settings["link_type"]
        is_df = lambda x: pd is not None and isinstance(x, pd.DataFrame)  # noqa: E731
        if link_type == "dedupe_only":
            if not (is_df(self.df) and self.df_l is None and self.df_r is None):
                raise ValueError(
                    "For link_type = 'dedupe_only', pass a single DataFrame via "
                    "df=; omit df_l and df_r. e.g. Splink(settings, df=my_df)"
                )
        elif not (is_df(self.df_l) and is_df(self.df_r) and self.df is None):
            raise ValueError(
                f"For link_type = '{link_type}', pass two DataFrames via "
                "df_l= and df_r=; omit df. "
                "e.g. Splink(settings, df_l=first, df_r=second)"
            )

    @property
    def run_id(self) -> str:
        """This linker's telemetry and profiling run id (the key for
        ``utils.profiling.stage_timings(run=...)`` and the suffix of the
        run's telemetry file name)."""
        return self._obs.run_id

    def _sync_device(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    @contextlib.contextmanager
    def _timed(self, stage: str):
        """A StageTimer of this linker's run scope: records the stage's wall
        seconds, the device's work included, in ``stage_seconds`` and the
        run's timings, writes its profiler trace under ``profile_dir`` and,
        with telemetry, emits its span and a device-memory snapshot."""
        timer = StageTimer(stage, run=self._obs.run_id, telemetry=self._obs,
                           sync=self._sync_device)
        with timer:
            yield
        self.stage_seconds[stage] = timer.elapsed

    @property
    def _n_left(self) -> int | None:
        if self.settings["link_type"] == "dedupe_only":
            return None
        if self.df_l is not None:
            return len(self.df_l)
        return self._n_left_released

    def release_input(self) -> None:
        """Encode the input frame(s), then drop the linker's references to
        them so the raw pandas data can be garbage-collected by the caller.
        Everything downstream reads the encoded table built here."""
        self._ensure_encoded()
        if self.df_l is not None:
            self._n_left_released = len(self.df_l)
        self.df = None
        self.df_l = None
        self.df_r = None

    # ------------------------------------------------------------------
    # Checkpointing
    # ------------------------------------------------------------------

    def _checkpoint_config(self):
        """(checkpoint_dir | None, resume, interval): the argument to
        estimate_parameters wins, else the settings keys."""
        ckpt_dir = self._ckpt_dir_arg or self.settings.get("checkpoint_dir") or None
        return (
            ckpt_dir,
            self._ckpt_resume,
            int(self.settings.get("checkpoint_interval", 5) or 5),
        )

    def _load_validated_checkpoint(self, ckpt_dir, state_hash, resume):
        """Hash-checked load of the checkpoint to resume from, or None.
        Resume with no checkpoint on disk yet is the normal first launch of
        a relaunch loop, so it warns and trains fresh. A checkpoint written
        by a run of several processes is refused: this package runs one."""
        if not resume:
            return None
        from .resilience.checkpoint import load_checkpoint

        ckpt = load_checkpoint(ckpt_dir, expect_hash=state_hash)
        if ckpt is None:
            logger.warning(
                "resume=True but no checkpoint exists in %s yet; training "
                "from scratch (first launch of a relaunch loop?)", ckpt_dir,
            )
            return None
        if int(ckpt.process_count) != 1:
            raise RuntimeError(
                f"checkpoint in {ckpt_dir} was written by a run of "
                f"{ckpt.process_count} processes; splink_tpu_torch resumes "
                "single-process runs only (multi-GPU is ROADMAP.md Queue 1 "
                "item 7)"
            )
        return ckpt

    def _em_state_hash(self) -> str:
        from .resilience.checkpoint import settings_state_hash

        # bind the checkpoint to the input data as well as the settings: the
        # encoded row count is a cheap fingerprint of the frame
        table = self._ensure_encoded()
        return settings_state_hash(self.settings, extra={"n_rows": int(table.n_rows)})

    # ------------------------------------------------------------------
    # Pipeline stages
    # ------------------------------------------------------------------

    def _ensure_encoded(self) -> EncodedTable:
        if self._table is None:
            with self._timed("encode"):
                if self.settings["link_type"] == "dedupe_only":
                    self._table = encode_table(self.df, self.settings)
                else:
                    self._table = concat_tables(self.df_l, self.df_r, self.settings)
            self._obs.count("rows_encoded", int(self._table.n_rows))
        return self._table

    def _ensure_pairs(self) -> PairIndex:
        if self._pairs is None:
            table = self._ensure_encoded()
            build_dir = self.settings.get("build_spill_dir") or None
            if build_dir and self.settings.get("approx_blocking"):
                # the spill emission writes EXACT-rule pairs only; where the
                # approximate tier can run, taking it would drop every
                # approximate pair, so the job blocks in memory instead
                from .approx.lsh import approx_columns

                if approx_columns(self.settings, table):
                    from .utils.logging_utils import warn_degraded

                    warn_degraded(
                        "spill_blocking", "host_blocking",
                        "approx_blocking needs materialised blocking (the "
                        "spill emission has no approximate tier)",
                    )
                    build_dir = None
            if build_dir:
                # The durable write path: sharded, manifest-committed,
                # resumable emission into the caller-owned spill store.
                # Overlap scoring is off here: a resumed build skips
                # committed segments, so no per-chunk consumer can be fed
                # consistently; EM reads the store afterwards instead.
                from .blocking import clear_key_code_cache
                from .blocking_device import spill_block_rules

                with self._timed("blocking"):
                    pairs = spill_block_rules(self.settings, table, self._n_left, build_dir,
                                              device=self.device)
                if pairs is not None:
                    self._pairs = pairs
                    logger.info("blocking produced %d candidate pairs (spill store)",
                                pairs.n_pairs)
                    self._obs.count("pairs_blocked", int(pairs.n_pairs))
                    clear_key_code_cache(table)
                    return self._pairs
                from .utils.logging_utils import warn_degraded

                warn_degraded("spill_blocking", "host_blocking",
                              "rule shapes unsupported by the device emission plan")
            stream = self._overlap_stream(table)
            with self._timed("blocking"):
                self._pairs = block_using_rules(
                    self.settings, table, self._n_left,
                    pair_consumer=stream.feed if stream is not None else None,
                    device=self.device,
                )
            logger.info("blocking produced %d candidate pairs", self._pairs.n_pairs)
            self._obs.count("pairs_blocked", int(self._pairs.n_pairs))
            if self._obs.enabled:
                # block-size skew rides the still-warm key-code cache,
                # cleared just below
                from .blocking import block_size_stats

                self._obs.record("largest_blocks",
                                 block_size_stats(self.settings, table, self._n_left))
            self._maybe_spill_pairs()
            if stream is not None:
                self._finish_overlap(stream)
            from .blocking import clear_key_code_cache

            clear_key_code_cache(table)
        return self._pairs

    def _overlap_stream(self, table: EncodedTable):
        """The device consumer fed DURING blocking: the device computes rule
        k's gammas or pattern ids while the host joins rule k+1, and the
        second sweep over the (possibly spilled) pair index disappears.

        The regime is chosen BEFORE blocking from the O(n) pair-count
        bound: resident-size jobs stream the gamma matrix and keep it on
        the device for EM; larger jobs with pattern-capable settings stream
        pattern ids. Everything else takes GammaStream."""
        if not self.settings.get("overlap_blocking", True):
            return None
        from .gammas import GammaStream, PatternStream

        program = self._gamma_program()
        max_resident = int(self.settings["max_resident_pairs"])
        bound = self._estimate_pair_bound(table)
        # clamp the device batch to the job bound, so that a small job does
        # not run a whole pair_batch_size
        batch = int(self.settings["pair_batch_size"])
        batch = max(min(batch, -(-max(bound, 1) // 8) * 8), 1024)
        if bound > max_resident and self._pattern_capable():
            self._pattern_program = program
            return PatternStream(program, batch)
        return GammaStream(program, batch, keep_device_limit=max_resident)

    def _finish_overlap(self, stream) -> None:
        from .gammas import PatternStream

        if isinstance(stream, PatternStream):
            with self._timed("gammas_patterns"):
                self._P, self._pattern_counts = stream.finish()
        else:
            with self._timed("gammas"):
                self._G, self._G_dev = stream.finish()

    def _maybe_spill_pairs(self) -> None:
        """Note the spill directory blocking wrote the pairs to (spill_dir
        set): the PairIndex owns its lifetime through a weakref finalizer,
        and stale directories of dead owners were swept before any bytes
        were written."""
        if self._pairs.spill_tmp is not None:
            self._spill_tmp = self._pairs.spill_tmp
            logger.info("pair index spilled to %s", self._spill_tmp)

    def _ensure_gammas(self) -> np.ndarray:
        if self._G is None:
            pairs = self._ensure_pairs()  # the overlap may set _G or _P here
            if self._G is not None:
                return self._G
            if self._P is not None:
                # the overlap streamed pattern ids but the run ended small
                # enough for the resident regime: decode the gamma matrix
                # from the pattern LUT (the pattern id IS the gamma vector)
                with self._timed("gammas"):
                    self._G = self._pattern_program.patterns_matrix()[self._P]
                return self._G
            keep = pairs.n_pairs <= int(self.settings["max_resident_pairs"])
            program = self._gamma_program()
            with self._timed("gammas"):
                self._G, self._G_dev = program.compute_with_device(
                    pairs.idx_l, pairs.idx_r,
                    batch_size=int(self.settings["pair_batch_size"]),
                    keep_device=keep,
                )
        return self._G

    def _gamma_program(self) -> GammaProgram:
        """A GammaProgram over the encoded table on this linker's device;
        its build (packing the table's columns and aux lanes on the host,
        one upload) is the ``gamma_program`` stage."""
        table = self._ensure_encoded()
        with self._timed("gamma_program"):
            return GammaProgram(self.settings, table, float_dtype=self._float_dtype,
                                device=self.device)

    def _gamma_tensor(self, G: np.ndarray):
        if self._G_dev is not None and G is self._G:
            return self._G_dev
        return torch.from_numpy(np.ascontiguousarray(G)).to(self.device)

    # ------------------------------------------------------------------
    # The pattern regime and device pair generation
    # ------------------------------------------------------------------

    def _pattern_capable(self) -> bool:
        """Bounded pattern space and no custom comparison (a registered
        function could emit gammas outside [-1, num_levels-1], which would
        alias pattern ids)."""
        from .gammas import MAX_PATTERNS, pattern_strides_for

        for c in self.settings["comparison_columns"]:
            if (c.get("comparison") or {}).get("kind") == "custom":
                return False
        level_counts = [int(c["num_levels"]) for c in self.settings["comparison_columns"]]
        _, n_patterns = pattern_strides_for(level_counts)
        return n_patterns <= MAX_PATTERNS

    @property
    def device_pair_generation_active(self) -> bool:
        """Whether this run used (or will use) the virtual pair index:
        pairs decoded on the device with no host materialisation."""
        return self._virtual_plan() is not None

    def _estimate_pair_bound(self, table: EncodedTable) -> int:
        if self._pair_bound is None:
            self._pair_bound = estimate_pair_upper_bound(self.settings, table, self._n_left)
        return self._pair_bound

    def _virtual_plan(self):
        """The device-pair-generation plan, or None. Checked once: the plan
        build does the per-rule key and sort work host blocking would do
        anyway, so a rejected plan costs nothing extra overall."""
        if self._virtual_checked:
            return self._virtual
        self._virtual_checked = True
        mode = self.settings.get("device_pair_generation", "auto")
        if mode == "off" or not self._pattern_capable():
            return None
        if self.settings.get("approx_blocking"):
            # the virtual pair index enumerates EXACT-rule pairs only; the
            # approximate tier emits through materialised blocking, so the
            # virtual path would drop every approximate pair. With no
            # sketchable string column the tier adds nothing and the
            # virtual path loses nothing.
            from .approx.lsh import approx_columns

            if approx_columns(self.settings, self._ensure_encoded()):
                logger.info(
                    "device pair generation disabled: approx_blocking "
                    "needs materialised blocking (the virtual pair index "
                    "has no approximate tier)"
                )
                return None
        from .pairgen import build_virtual_plan

        table = self._ensure_encoded()
        if mode == "auto":
            # small jobs: the resident and overlap paths are already right
            bound = self._estimate_pair_bound(table)
            if bound <= int(self.settings["max_resident_pairs"]):
                return None
        with self._timed("pairgen_plan"):
            self._virtual = build_virtual_plan(self.settings, table, self._n_left)
        if self._virtual is None:
            logger.info(
                "device pair generation: no virtual plan for these blocking "
                "rules (cartesian, no equality key, a residual the device "
                "cannot evaluate, or a near-constant key); host blocking "
                "produces the pairs on %s instead", self.device,
            )
            return None
        # the key-code cache fed the estimator and the plan; the plan keeps
        # its own int32 copies
        from .blocking import clear_key_code_cache

        clear_key_code_cache(table)
        logger.info("device pair generation: %d candidate positions, %d rules",
                    self._virtual.n_candidates, len(self._virtual.rules))
        return self._virtual

    def _use_pattern_pipeline(self) -> bool:
        """Whether the pattern-id pipeline applies: device pair generation
        active, or a materialised pair set past max_resident_pairs with
        pattern-capable settings."""
        if self._virtual_plan() is not None:
            return True
        if not self._pattern_capable():
            return False
        return self._ensure_pairs().n_pairs > int(self.settings["max_resident_pairs"])

    def _ensure_pattern_program(self) -> GammaProgram:
        """The pattern-capable GammaProgram, built lazily (scoring-only
        consumers need the program and not the histogram pass)."""
        if self._pattern_program is None:
            self._pattern_program = self._gamma_program()
        return self._pattern_program

    def _virtual_ids_policy(self) -> bool:
        """Whether the virtual pattern pass also keeps the per-candidate ids:
        one pass (ids and histogram together) beats two (histogram for EM,
        then ids again in the score stream) whenever a score stream follows
        and the ids fit half the host RAM free now. EM-only jobs keep the
        histogram-only pass, which copies no per-pair bytes off the
        device."""
        mode = self.settings.get("virtual_materialise_ids", "auto")
        if mode == "on":
            return True
        if mode == "off" or not self._virtual_want_ids:
            return False
        n = self._virtual.n_candidates
        from .gammas import pattern_ids_fit_uint16

        small = pattern_ids_fit_uint16(self._ensure_pattern_program().n_patterns)
        if n > (_MAX_RESIDENT_IDS_U16 if small else _MAX_RESIDENT_IDS_I32):
            return False
        try:
            avail = os.sysconf("SC_AVPHYS_PAGES") * os.sysconf("SC_PAGE_SIZE")
        except (ValueError, OSError, AttributeError):
            return True  # no probe on this platform; the cap still bounds
        return n * (2 if small else 4) <= avail // 2

    def _ensure_pattern_ids(self):
        """(pattern_ids, counts, program): ONE device pass over the pair
        index computing gammas, pattern ids and their histogram. The gamma
        matrix never materialises."""
        if self._P is None:
            if self._virtual_plan() is not None:
                if self._pattern_counts is not None:
                    return None, self._pattern_counts, self._pattern_program
                from .pairgen import compute_virtual_pattern_ids

                self._ensure_pattern_program()
                with self._timed("gammas_patterns"):
                    want_ids = self._virtual_ids_policy()
                    pids, self._pattern_counts, n_real = compute_virtual_pattern_ids(
                        self._pattern_program, self._virtual,
                        int(self.settings["pair_batch_size"]), return_ids=want_ids,
                    )
                    if want_ids:
                        self._P_virtual = pids
                logger.info("device pair generation scored %d pairs (%d candidate "
                            "positions)", n_real, self._virtual.n_candidates)
                return None, self._pattern_counts, self._pattern_program
            pairs = self._ensure_pairs()
            if self._P is not None:  # the overlap PatternStream computed them
                return self._P, self._pattern_counts, self._pattern_program
            self._pattern_program = self._gamma_program()
            with self._timed("gammas_patterns"):
                self._P, self._pattern_counts = self._pattern_program.compute_pattern_ids(
                    pairs.idx_l, pairs.idx_r,
                    batch_size=int(self.settings["pair_batch_size"]),
                )
        return self._P, self._pattern_counts, self._pattern_program

    def _pattern_score_luts(self):
        """Per-pattern lookup tables (host): match probability, the
        per-column prob_m/prob_u when intermediates are retained, and the
        fold logit when the TF fold is active (its delta belongs to the
        pair's tokens, not to its pattern, so it is added per pair)."""
        PM = self._ensure_pattern_program().patterns_matrix()
        p, pm, pu, z = self._score_batched(PM, want_z=self._tf_fold_ctx() is not None)
        return PM, p, pm, pu, z

    def _stream_pattern_chunks(self):
        """Yield scored frames from the pattern-id pipeline: one LUT gather
        and one frame per (il, ir, pattern ids) chunk of
        _iter_pattern_triples."""
        PM, p_lut, pm_lut, pu_lut, z_lut = self._pattern_score_luts()
        for il, ir, Pk in self._iter_pattern_triples():
            yield self._scored_frame(
                PM[Pk], il, ir, p_lut[Pk],
                pm_lut[Pk] if pm_lut is not None else None,
                pu_lut[Pk] if pu_lut is not None else None,
                z_lut[Pk] if z_lut is not None else None,
            )

    def _iter_pattern_triples(self):
        """Yield (idx_l, idx_r, pattern_ids) per chunk across the pattern
        regimes — virtual with stored ids (host only), virtual recompute (a
        device pass), materialised pairs — with masked sentinels already
        filtered. The one definition of the pattern pair stream."""
        batch = int(self.settings["pair_batch_size"])
        if self._virtual_plan() is not None:
            from .pairgen import _virtual_pass_iter, decode_positions

            plan = self._virtual
            program = self._ensure_pattern_program()
            sentinel = program.n_patterns

            def decode(Pc, r, p0):
                keep = Pc != sentinel
                if not keep.any():
                    return None
                qs = p0 + np.flatnonzero(keep).astype(np.int64)
                il, ir, _ = decode_positions(plan, r, qs, compute_masked=False)
                return il, ir, Pc[keep]

            P = self._P_virtual  # local: immune to a concurrent release
            if P is not None:
                out_base = 0
                for r, rp in enumerate(plan.rules):
                    for p0 in range(0, rp.total, batch):
                        p1 = min(p0 + batch, rp.total)
                        t = decode(P[out_base + p0 : out_base + p1].astype(np.int32), r, p0)
                        if t is not None:
                            yield t
                    out_base += rp.total
                return
            for r, p0, _, _n, chunk in _virtual_pass_iter(program, plan, batch):
                t = decode(chunk.astype(np.int32), r, p0)
                if t is not None:
                    yield t
            return
        P, _, _ = self._ensure_pattern_ids()
        pairs = self._ensure_pairs()
        for s in range(0, len(P), batch):
            rows = slice(s, min(s + batch, len(P)))
            yield pairs.idx_l[rows], pairs.idx_r[rows], P[rows].astype(np.int32)

    def _run_em_patterns(self, compute_ll: bool) -> None:
        _, counts, program = self._ensure_pattern_ids()
        if int(counts.sum()) == 0:
            warnings.warn(
                "No candidate pairs to estimate from (blocking produced "
                "nothing); parameters are unchanged."
            )
            return
        patterns = program.patterns_matrix()
        seen = counts > 0
        logger.info("pattern-compressed EM: %d pairs -> %d distinct gamma patterns",
                    int(counts.sum()), int(seen.sum()))
        self._obs.count("pairs_gamma_scored", int(counts.sum()))
        self._obs.gauge("gamma_patterns_distinct", int(seen.sum()))
        self._last_em_result = None
        # cheap here (the pattern matrix is small); feeds telemetry and the
        # EM diagnostics' level-support evidence
        hist = _gamma_histograms(self.settings, patterns, weights=counts)
        if self._obs.enabled:
            self._obs.record("gamma_histogram", hist)
        self._run_em_resident_weighted(patterns[seen], counts[seen], compute_ll)
        self._emit_em_diagnostics(hist)

    def stream_tf_adjusted_comparisons(self, compute_ll: bool = False):
        """Streaming term-frequency adjustment, for outputs too large for one
        frame: EM, then TWO passes over the scored pattern stream — pass 1
        aggregates each flagged column's per-token mean match probability,
        pass 2 yields scored chunks with ``<col>_adj`` columns and
        ``tf_adjusted_match_prob``. In the resident regime it yields the
        one-frame ``make_term_frequency_adjustments`` result."""
        from .term_frequencies import bayes_combine

        tf_cols = list(term_frequency_columns(self.settings))
        if not self._use_pattern_pipeline():
            df_e = self.get_scored_comparisons(compute_ll)
            yield self.make_term_frequency_adjustments(df_e)
            return
        if not tf_cols:
            warnings.warn(
                "No term frequency adjustment columns are specified in "
                "your settings object. Streaming unadjusted comparisons."
            )
            yield from self.stream_scored_comparisons(compute_ll)
            return
        self._virtual_want_ids = True
        # the try spans everything from EM (which may keep multi-GB
        # per-candidate ids) onward, so that no exit path leaks the ids
        try:
            self._run_em_patterns(compute_ll)
            table = self._ensure_encoded()
            cols: dict[str, tuple[np.ndarray, int]] = {}
            for name in tf_cols:
                sc = table.strings.get(name)
                if sc is not None:
                    cols[name] = (sc.token_ids, sc.n_tokens)
                    continue
                nc = table.numerics.get(name)
                if nc is not None:
                    # numeric TF column: token = distinct value; null -> -1
                    codes, uniq = pd.factorize(nc.values_f64)
                    codes = codes.astype(np.int32)
                    codes[nc.null_mask] = -1
                    cols[name] = (codes, len(uniq))
                    continue
                warnings.warn(
                    f"term-frequency column {name!r} is not an encoded "
                    "column; skipped in the streaming TF pass."
                )
            PM, p_lut, pm_lut, pu_lut, z_lut = self._pattern_score_luts()
            base_lambda = float(self.params.params["λ"])
            sums = {n: np.zeros(nt + 1) for n, (_, nt) in cols.items()}
            counts = {n: np.zeros(nt + 1) for n, (_, nt) in cols.items()}
            for il, ir, Pk in self._iter_pattern_triples():
                p = p_lut[Pk]
                for name, (tid, _nt) in cols.items():
                    tl = tid[il]
                    agree = (tl == tid[ir]) & (tl >= 0)
                    np.add.at(sums[name], tl[agree], p[agree])
                    np.add.at(counts[name], tl[agree], 1.0)
            adjusted = {}
            for name in cols:
                lam_t = sums[name] / np.maximum(counts[name], 1.0)
                adjusted[name] = bayes_combine([lam_t, np.full(len(lam_t), 1.0 - base_lambda)])
            for il, ir, Pk in self._iter_pattern_triples():
                df = self._scored_frame(
                    PM[Pk], il, ir, p_lut[Pk],
                    pm_lut[Pk] if pm_lut is not None else None,
                    pu_lut[Pk] if pu_lut is not None else None,
                    z_lut[Pk] if z_lut is not None else None,
                )
                adj_arrays = []
                for name, (tid, _nt) in cols.items():
                    tl = tid[il]
                    agree = (tl == tid[ir]) & (tl >= 0)
                    adj = np.where(agree, adjusted[name][np.where(agree, tl, 0)], 0.5)
                    df[f"{name}_adj"] = adj
                    adj_arrays.append(adj)
                df["tf_adjusted_match_prob"] = bayes_combine(
                    [df["match_probability"].to_numpy()] + adj_arrays
                )
                lead = ["tf_adjusted_match_prob", "match_probability"]
                rest = [c for c in df.columns if c not in lead]
                yield df[lead + rest]
        finally:
            self._P_virtual = None
            self._obs.finish()

    # ------------------------------------------------------------------
    # Public API
    # ------------------------------------------------------------------

    def _concat_chunks(self, chunks):
        """Concatenate streamed chunks; zero chunks (no candidates, or every
        position masked) is a valid empty result."""
        chunks = list(chunks)
        if not chunks:
            return self._empty_df_e()
        return pd.concat(chunks, ignore_index=True)

    def _empty_df_e(self):
        n_cols = len(self.settings["comparison_columns"])
        zero = np.zeros(0)
        zero_cols = np.zeros((0, n_cols))
        return self._scored_frame(
            np.zeros((0, n_cols), np.int8), np.zeros(0, np.int64), np.zeros(0, np.int64),
            zero, zero_cols, zero_cols, None,
        )

    def manually_apply_fellegi_sunter_weights(self):
        """Score using the m/u values in the settings (or a loaded model),
        without running EM."""
        if self._use_pattern_pipeline():
            df_e = self._concat_chunks(self._stream_pattern_chunks())
        else:
            df_e = self._build_df_e(self._ensure_gammas())
            self._G_dev = None  # release the device copy once scoring is done
        self._obs.count("pairs_scored_output", len(df_e))
        self._obs.finish()
        return df_e

    def estimate_parameters(
        self,
        compute_ll: bool = False,
        *,
        checkpoint_dir: str | os.PathLike | None = None,
        resume: bool = False,
    ) -> Params:
        """Train only: blocking (or device pair generation), gammas and EM,
        returning the fitted Params and producing no per-pair output.

        Args:
            compute_ll: archive the log likelihood per iteration.
            checkpoint_dir: snapshot EM state here every
                ``checkpoint_interval`` updates (atomic, versioned, bound to
                a settings hash). Overrides the ``checkpoint_dir`` settings
                key.
            resume: continue from the checkpoint in ``checkpoint_dir``
                instead of training from the settings priors. A checkpoint
                written for different settings or data is rejected with
                CheckpointMismatchError.
        """
        self._ckpt_dir_arg = os.fspath(checkpoint_dir) if checkpoint_dir else None
        self._ckpt_resume = bool(resume)
        if self._ckpt_resume and self._checkpoint_config()[0] is None:
            self._ckpt_resume = False
            raise ValueError(
                "resume=True requires a checkpoint directory: pass "
                "checkpoint_dir= or set the checkpoint_dir settings key."
            )
        try:
            if self._use_pattern_pipeline():
                self._run_em_patterns(compute_ll)
            elif (self._ensure_pairs().spill_store is not None
                  and self._pairs.n_pairs > int(self.settings["max_resident_pairs"])):
                # spill-store-backed pairs past the resident cap: EM reads
                # the store directly, gammas per chunk on the device
                self._run_em_streamed_spill(self._pairs, compute_ll)
            else:
                self._run_em(self._ensure_gammas(), compute_ll)
                self._G_dev = None
        finally:
            self._ckpt_dir_arg = None
            self._ckpt_resume = False
            self._obs.finish()
        return self.params

    def get_scored_comparisons(self, compute_ll: bool = False):
        """Estimate parameters by EM and return the scored comparisons.

        Past ``max_resident_pairs`` the pipeline is the pattern-id regime:
        one device pass turns each pair's gamma vector into a pattern id
        and histograms them, EM runs on the weighted pattern matrix, and
        scoring is a host LUT gather."""
        if self._use_pattern_pipeline():
            # scoring follows EM, so the virtual pass may keep its ids
            self._virtual_want_ids = True
            self._run_em_patterns(compute_ll)
            df_e = self._concat_chunks(self._stream_pattern_chunks())
            self._P_virtual = None
        else:
            G = self._ensure_gammas()
            self._run_em(G, compute_ll)
            df_e = self._build_df_e(G)
            self._G_dev = None
        self._obs.count("pairs_scored_output", len(df_e))
        self._obs.finish()
        return df_e

    def _em_init(self):
        lam, m, u, _ = self.params.to_arrays()
        return fsparams_from_numpy(lam, m, u, self.device, self._float_dtype)

    def _run_em(self, G: np.ndarray, compute_ll: bool) -> None:
        """Dispatch EM to the resident or streamed regime by pair count. A
        device OOM in resident EM degrades to the streamed regime on the
        same device (the same update math over uploaded batches) with a
        DegradationWarning."""
        from .resilience import active_plan, is_oom
        from .utils.logging_utils import warn_degraded

        self._obs.count("pairs_gamma_scored", len(G))
        self._last_em_result = None
        # the gamma histogram doubles as the EM diagnostics' level-support
        # evidence; cheap in the resident regime, skipped for a streamed
        # job with telemetry off (diagnostics then omit support counts)
        hist = None
        if self._obs.enabled or len(G) <= int(self.settings["max_resident_pairs"]):
            G_dev = self._G_dev if self._G_dev is not None and G is self._G else None
            hist = _gamma_histograms(self.settings, G, G_dev=G_dev)
            if self._obs.enabled:
                self._obs.record("gamma_histogram", hist)
        if len(G) > int(self.settings["max_resident_pairs"]):
            self._run_em_streamed(G, compute_ll)
            self._emit_em_diagnostics(hist)
            return
        # the resident attempt may replay completed updates into
        # self.params (checkpoint boundaries, save_state_fn) before it OOMs;
        # the fallback restarts from the PRE-attempt state
        params_snapshot = copy.deepcopy(self.params)
        try:
            active_plan(self.settings).fire("resident_em", pairs=len(G))
            self._run_em_fused(self._gamma_tensor(G), None, compute_ll)
        except Exception as e:  # noqa: BLE001 - is_oom() decides
            if not is_oom(e):
                raise
            self.params = params_snapshot
            self._G_dev = None  # the streamed regime uploads per batch
            warn_degraded("resident_em", "streamed_em", f"{type(e).__name__}: {e}",
                          pairs=len(G), device=str(self.device))
            self._run_em_streamed(G, compute_ll)
        self._emit_em_diagnostics(hist)

    def _run_em_fused(self, G_dev, weights, compute_ll: bool) -> None:
        """Resident EM: the whole run in one run_em call, one update per
        call when a save_state_fn must run between iterations, or
        run_em_checkpointed with a checkpoint directory."""
        init = self._em_init()
        max_iterations = int(self.settings["max_iterations"])
        em_kwargs = dict(
            max_levels=self.params.max_levels,
            em_convergence=self.settings["em_convergence"],
            weights=weights,
            compute_ll=compute_ll,
        )
        ckpt_dir, resume, interval = self._checkpoint_config()
        tel = self._obs if self._obs.enabled else None
        with self._timed("em"):
            # inside the stage span, so em_begin takes it as the parent of
            # every em_iteration span
            if tel is not None:
                tel.em_begin("fused", *(t.cpu().numpy() for t in init))
            if ckpt_dir is not None:
                converged = self._run_em_fused_checkpointed(
                    G_dev, init, max_iterations, em_kwargs, ckpt_dir, resume,
                    interval, compute_ll,
                )
            elif self.save_state_fn is None:
                result = run_em(G_dev, init, max_iterations=max_iterations,
                                telemetry=tel, **em_kwargs)
                self._replay_history(result, compute_ll)
                converged = result.converged
            else:
                converged = False
                params = init
                for k in range(max_iterations):
                    result = run_em(G_dev, params, max_iterations=1, **em_kwargs)
                    params = result.params
                    self._replay_history(result, compute_ll)
                    if tel is not None:
                        tel.em_update(
                            k + 1, float(result.lam_history[1]), result.m_history[1],
                            result.u_history[1],
                            float(result.ll_history[0]) if compute_ll else None,
                            bool(result.converged),
                        )
                    self.save_state_fn(self.params, self.settings)
                    if result.converged:
                        converged = True
                        break
        if converged:
            logger.info("EM algorithm has converged")

    def _run_em_fused_checkpointed(self, G_dev, init, max_iterations, em_kwargs,
                                   ckpt_dir, resume, interval, compute_ll) -> bool:
        """Checkpointed resident EM (em.run_em_checkpointed): the same
        trajectory, an atomic checkpoint every ``interval`` updates, and the
        history replayed into the Params object at each boundary (where
        save_state_fn then runs); a resumed run replays the checkpoint's
        history first."""
        from .resilience import active_plan

        state_hash = self._em_state_hash()
        ckpt = self._load_validated_checkpoint(ckpt_dir, state_hash, resume)
        replayed = 0

        def replay(done, hist):
            nonlocal replayed
            self._replay_em_history(hist["lam"], hist["m"], hist["u"], hist["ll"],
                                    replayed, done, compute_ll)
            replayed = done

        def on_segment(done, hist, _converged):
            replay(done, hist)
            if self.save_state_fn is not None:
                self.save_state_fn(self.params, self.settings)

        result = run_em_checkpointed(
            G_dev, init, max_iterations=max_iterations, checkpoint_dir=ckpt_dir,
            state_hash=state_hash, checkpoint_every=interval, resume=resume,
            resume_checkpoint=ckpt, fault_plan=active_plan(self.settings),
            on_segment=on_segment,
            telemetry=self._obs if self._obs.enabled else None, **em_kwargs,
        )
        # a resume that was already complete runs no segment: catch up from
        # the result's (checkpoint-restored) histories
        n_updates = int(result.n_updates)
        replay(n_updates, {"lam": result.lam_history, "m": result.m_history,
                           "u": result.u_history, "ll": result.ll_history})
        if compute_ll and not np.isnan(result.ll_history[n_updates]):
            self.params.params["log_likelihood"] = float(result.ll_history[n_updates])
            self.params.log_likelihood_exists = True
        return bool(result.converged)

    def _run_em_resident_weighted(self, G_pat: np.ndarray, weights: np.ndarray,
                                  compute_ll: bool) -> None:
        """Resident EM on a weighted pattern matrix (counts as weights)."""
        self._run_em_fused(
            torch.from_numpy(np.ascontiguousarray(G_pat)).to(self.device),
            torch.from_numpy(weights.astype(self._np_float)).to(self.device),
            compute_ll,
        )

    def _run_em_streamed(self, G: np.ndarray, compute_ll: bool) -> None:
        """Streaming EM over host gamma micro-batches of pair_batch_size
        (the reference's _run_em_streamed_stats; with one device there is
        no slice of the pairs to pick). Reached only when the pattern-id
        pipeline declined the job (custom comparisons, or a pattern space
        past MAX_PATTERNS) or after a resident OOM."""
        batch = int(self.settings["pair_batch_size"])

        def batches():
            for s in range(0, len(G), batch):
                yield G[s : s + batch]

        self._run_em_streamed_driver(batches, compute_ll)

    def _run_em_streamed_spill(self, pairs: PairIndex, compute_ll: bool) -> None:
        """Manifest-fed streamed EM: the spill store IS the pair stream.
        Each pass walks the store's committed memmaps in pair_batch_size
        slices and computes each slice's gamma block on the device
        (spill.iter_spill_gamma_batches); the gamma matrix never
        materialises on the host. The batch boundaries are the streamed-G
        path's over the same pair order, so the trajectory is bit-identical
        to it."""
        from .spill import iter_spill_gamma_batches

        store = pairs.spill_store
        program = self._gamma_program()
        batch = int(self.settings["pair_batch_size"])

        def batches():
            return iter_spill_gamma_batches(store, program, batch)

        self._obs.count("pairs_gamma_scored", int(store.total_pairs))
        self._last_em_result = None
        logger.info("spill-fed streamed EM over %d pairs (%d manifest segments)",
                    store.total_pairs, len(store.segments))
        self._run_em_streamed_driver(batches, compute_ll)
        self._emit_em_diagnostics(None)

    def _run_em_streamed_driver(self, batches, compute_ll: bool) -> None:
        """The streamed EM driver: checkpoint and resume plumbing, retry,
        the fault sites, and run_em_streamed over any re-iterable batch
        factory."""
        from .parallel.streaming import run_em_streamed
        from .resilience import RetryPolicy, active_plan
        from .resilience.checkpoint import EMCheckpointer

        init = self._em_init()
        ckpt_dir, resume, interval = self._checkpoint_config()
        start_iteration = 0
        checkpointer = None
        if ckpt_dir is not None:
            state_hash = self._em_state_hash()
            ckpt = self._load_validated_checkpoint(ckpt_dir, state_hash, resume)
            if ckpt is not None:
                lam_r, m_r, u_r = ckpt.params_arrays()
                init = fsparams_from_numpy(lam_r, m_r, u_r, self.device, self._float_dtype)
                start_iteration = min(ckpt.iteration, int(self.settings["max_iterations"]))
                # replay the pre-interruption history so the final state is
                # indistinguishable from an uninterrupted run's
                h = ckpt.history_arrays()
                self._replay_em_history(h["lam"], h["m"], h["u"], h["ll"],
                                        0, start_iteration, compute_ll)
            checkpointer = EMCheckpointer(
                ckpt_dir, state_hash, interval=interval, process_count=1,
                write=True, dtype=np.dtype(self._np_float).name,
            ).start(init, from_checkpoint=ckpt)
            if ckpt is not None and ckpt.converged:
                logger.info("checkpoint at iteration %d is already converged; "
                            "nothing to resume", ckpt.iteration)
                return

        def on_iteration(it, params, ll, converged_now=False):
            if compute_ll and ll is not None:
                self.params.params["log_likelihood"] = float(ll)
                self.params.log_likelihood_exists = True
            self.params.update_from_arrays(
                float(params.lam), params.m.cpu().numpy(), params.u.cpu().numpy()
            )
            # checkpoint BEFORE save_state_fn and the em_iteration fault
            # site: an injected kill at iteration N finds update N durable
            if checkpointer is not None:
                checkpointer.on_iteration(it, params, ll, converged=converged_now)
            if self.save_state_fn is not None:
                self.save_state_fn(self.params, self.settings)

        tel = self._obs if self._obs.enabled else None
        with self._timed("em_streamed"):
            # inside the stage span, so em_begin takes it as the parent of
            # every em_iteration span
            if tel is not None:
                tel.em_begin("streamed", *(t.cpu().numpy() for t in init),
                             start_iteration=start_iteration)
            _, _, _, converged = run_em_streamed(
                batches, init,
                max_iterations=int(self.settings["max_iterations"]),
                max_levels=self.params.max_levels,
                em_convergence=self.settings["em_convergence"],
                compute_ll=compute_ll,
                on_iteration=on_iteration,
                start_iteration=start_iteration,
                retry_policy=RetryPolicy(),
                fault_plan=active_plan(self.settings),
                telemetry=tel,
            )
        if checkpointer is not None:
            checkpointer.finish(converged)
        if converged:
            logger.info("EM algorithm has converged")

    def stream_scored_comparisons(self, compute_ll: bool = False):
        """Streaming variant of get_scored_comparisons for outputs too large
        for one frame: runs EM, then yields scored frames of
        ``pair_batch_size`` pairs."""
        if self._use_pattern_pipeline():
            self._virtual_want_ids = True
            self._run_em_patterns(compute_ll)
            try:
                yield from self._stream_pattern_chunks()
            finally:
                # release the (possibly multi-GB) ids on exhaustion AND on an
                # abandoned generator; a re-stream recomputes them
                self._P_virtual = None
                self._obs.finish()
            return
        G = self._ensure_gammas()
        self._run_em(G, compute_ll)
        yield from self.stream_scored_comparisons_after_em()
        self._obs.finish()

    def stream_scored_comparisons_after_em(self):
        """Yield scored frames using the current parameters (EM, or a
        loaded model, already applied); see stream_scored_comparisons."""
        if self._use_pattern_pipeline():
            yield from self._stream_pattern_chunks()
            return
        G = self._ensure_gammas()
        batch = int(self.settings["pair_batch_size"])
        for s in range(0, len(G), batch):
            yield self._build_df_e(G, slice(s, min(s + batch, len(G))))

    def _replay_em_history(self, lam_h, m_h, u_h, ll_h, from_k: int, to_k: int,
                           compute_ll: bool) -> None:
        """Apply history updates ``from_k+1 .. to_k`` to the Params object
        (per update: archive the pre-update log likelihood at index k-1,
        then update_from_arrays) — the one replay loop behind result
        installation, checkpoint-boundary replay and resume (history index
        i = params before update i+1; ll index i = log likelihood under
        params i, NaN = not computed)."""
        for k in range(from_k + 1, to_k + 1):
            if compute_ll and ll_h is not None and not np.isnan(ll_h[k - 1]):
                self.params.params["log_likelihood"] = float(ll_h[k - 1])
                self.params.log_likelihood_exists = True
            self.params.update_from_arrays(float(lam_h[k]), np.asarray(m_h[k]),
                                           np.asarray(u_h[k]))

    def _emit_em_diagnostics(self, gamma_hist: dict | None) -> None:
        """Offline EM diagnostics (obs/quality.em_diagnostics): the final
        m/u/Bayes-factor table with identifiability warnings (levels with
        ~zero training support, levels where m ~= u), logged as warnings on
        every fit and emitted as one ``em_diagnostics`` telemetry event.
        Never raises into the run."""
        try:
            from .em import trimmed_trajectory
            from .obs.quality import em_diagnostics

            diag = em_diagnostics(self.params, gamma_hist)
            if self._last_em_result is not None:
                # the per-iteration log likelihood the Params history
                # cannot reconstruct
                diag["run"] = trimmed_trajectory(self._last_em_result)
            for w in diag["warnings"]:
                logger.warning("EM identifiability: %s", w)
            self._obs.emit_event("em_diagnostics", **diag)
        except Exception as e:  # noqa: BLE001 - diagnostics are best-effort
            logger.warning("EM diagnostics failed: %s", e)

    def close_telemetry(self) -> None:
        """End this linker's telemetry record now: closes the JSONL sink
        and unregisters it from the ambient (resilience-event) publisher.
        Happens when the linker is collected; a no-op when telemetry is
        off or already closed."""
        self._obs.close()

    def _replay_history(self, result, compute_ll: bool) -> None:
        """Install a run_em result's history into the Params object."""
        self._last_em_result = result
        n = int(result.n_updates)
        ll = result.ll_history
        self._replay_em_history(result.lam_history, result.m_history, result.u_history,
                                ll, 0, n, compute_ll)
        if compute_ll and not np.isnan(ll[n]):
            self.params.params["log_likelihood"] = float(ll[n])
            self.params.log_likelihood_exists = True

    @check_types
    def save_model_as_json(self, path: str | os.PathLike, overwrite: bool = False):
        self.params.save_params_to_json_file(path, overwrite=overwrite)

    def export_index(self, path: str | os.PathLike | None = None):
        """Freeze this linker into an online-serving artifact
        (:class:`splink_tpu_torch.serve.LinkageIndex`) on the linker's
        device: the encoded input table as the packed reference matrix, a
        per-blocking-rule hash-bucket index, the CURRENT parameters (train
        first, or load a model) and the term-frequency tables. With
        ``path`` the artifact is also saved (atomic, versioned, hash-bound;
        splink_tpu's format); either way the index is returned, ready for
        ``splink_tpu_torch.serve.QueryEngine``. The ``export_index`` stage
        times it."""
        from .serve.index import build_index

        with self._timed("export_index"):
            index = build_index(self)
            if path is not None:
                index.save(path)
        return index

    # ------------------------------------------------------------------
    # Output assembly
    # ------------------------------------------------------------------

    def _score_batched(self, G: np.ndarray, want_z: bool = False):
        """Match probabilities (and, when retained, the per-column m/u
        lookups; with ``want_z``, the fold logits that the TF fold adds its
        deltas to) in pair_batch_size batches on the device. Returns host
        arrays (p, prob_m, prob_u, z), None for what was not asked for."""
        params = self._em_init()
        # the resident device copy when scoring exactly that matrix; else
        # each batch uploads on its own
        G_dev = self._G_dev if self._G_dev is not None and G is self._G else None
        want_inter = bool(self.settings["retain_intermediate_calculation_columns"])
        batch = int(self.settings["pair_batch_size"])
        out = []
        for s in range(0, max(len(G), 1), batch):  # one empty batch for no pairs
            Gb = G_dev[s : s + batch] if G_dev is not None else self._gamma_tensor(G[s : s + batch])
            if want_inter and want_z:
                res = score_pairs_with_intermediates_logits(Gb, params)
            elif want_inter:
                res = score_pairs_with_intermediates(Gb, params)
            elif want_z:
                res = score_pairs_with_logits(Gb, params)
            else:
                res = (score_pairs(Gb, params),)
            out.append(res)
        cols = [torch.cat(parts).cpu().numpy() for parts in zip(*out)]
        p = cols[0]
        prob_m, prob_u = (cols[1], cols[2]) if want_inter else (None, None)
        # the logit rides last in every variant that computes it
        return p, prob_m, prob_u, cols[-1] if want_z else None

    # ------------------------------------------------------------------
    # Term frequencies
    # ------------------------------------------------------------------

    def _tf_fold_ctx(self):
        """The TF u-probability fold's context, memoised: ``(spec, tids,
        log_tables)`` — term_frequencies.tf_fold_spec entries restricted to
        the encoded string columns, each column's (n_rows,) int32 token ids
        and its float64 log relative-frequency table. None when
        ``serve_tf_adjust`` is off or no flagged comparison has a token
        column; scored frames then carry no ``tf_match_probability``."""
        if self._tf_fold_cache is None:
            self._tf_fold_cache = False
            if self.settings.get("serve_tf_adjust", True):
                table = self._ensure_encoded()
                spec, tids, logs = [], [], []
                for ci, name, top in tf_fold_spec(self.settings):
                    sc = table.strings.get(name)
                    if sc is None or not sc.n_tokens:
                        continue
                    tid = sc.token_ids
                    counts = np.bincount(tid[tid >= 0], minlength=sc.n_tokens)
                    spec.append((ci, name, top))
                    tids.append(tid.astype(np.int32))
                    logs.append(tf_log_table(counts))
                if spec:
                    self._tf_fold_cache = (tuple(spec), tids, logs)
        return self._tf_fold_cache or None

    def _tf_fold_pairs(self, z: np.ndarray, il, ir, ctx) -> np.ndarray:
        """TF-adjusted match probabilities of the pairs (il, ir) from their
        fold logits ``z``, in pair_batch_size batches on the device: each
        column's token ids go to the device once and are gathered there
        with each batch's pair index."""
        spec, tids, logs = ctx
        fold = make_tf_fold_fn(spec)
        u_dev = self._em_init().u
        np_dtype = self._np_float
        logs_dev = [torch.from_numpy(t.astype(np_dtype)).to(self.device) for t in logs]
        tids_dev = [torch.from_numpy(t).to(self.device) for t in tids]
        n = len(z)
        batch = int(self.settings["pair_batch_size"])
        out = np.empty(n, np_dtype)
        for s in range(0, n, batch):
            e = min(s + batch, n)
            idx = [torch.from_numpy(np.ascontiguousarray(a[s:e], dtype=np.int64)).to(self.device)
                   for a in (il, ir)]
            args = [t.index_select(0, idx[0]) for t in tids_dev]
            args += [t.index_select(0, idx[1]) for t in tids_dev]
            zb = torch.from_numpy(z[s:e]).to(self.device)
            out[s:e] = fold(zb, u_dev, *args, *logs_dev).cpu().numpy()
        return out

    def make_term_frequency_adjustments(self, df_e):
        """Ex-post term-frequency adjustment of scored comparisons
        (splink/__init__.py:147-163): adds ``tf_adjusted_match_prob`` and a
        ``<col>_adj`` column per flagged column.

        When df_e still corresponds row for row to this linker's pair index,
        the per-token aggregation runs on this linker's device over the
        encoded table's token ids, gathered there with the pair index; any
        other frame takes the host groupby over its values."""
        with self._timed("tf_adjust"):
            pair_token_ids = None
            if self._pairs is not None and self._df_e_aligned_with_pairs(df_e):
                table = self._ensure_encoded()
                pair_token_ids = {}
                idx = None
                for name in term_frequency_columns(self.settings):
                    if name not in table.strings:
                        continue
                    if idx is None:
                        idx = [torch.from_numpy(a).to(self.device)
                               for a in (self._pairs.idx_l, self._pairs.idx_r)]
                    sc = table.strings[name]
                    tid = torch.from_numpy(sc.token_ids).to(self.device)
                    pair_token_ids[name] = (
                        tid.index_select(0, idx[0]), tid.index_select(0, idx[1]),
                        sc.n_tokens,
                    )
            return make_adjustment_for_term_frequencies(
                df_e,
                self.params,
                self.settings,
                retain_adjustment_columns=True,
                pair_token_ids=pair_token_ids,
                device=self.device,
            )

    def _df_e_aligned_with_pairs(self, df_e) -> bool:
        """Whether df_e still corresponds row for row to the pair index (the
        device aggregation needs this; a sorted or filtered frame takes the
        host groupby)."""
        n = self._pairs.n_pairs
        if len(df_e) != n or not df_e.index.equals(pd.RangeIndex(n)):
            return False
        uid = self.settings["unique_id_column_name"]
        cols = (f"{uid}_l", f"{uid}_r")
        if not all(c in df_e.columns for c in cols):
            return False
        table = self._ensure_encoded()
        # Full-column comparison: a sampled check could miss a small
        # permutation and misattribute probabilities to token ids.
        for c, idx in zip(cols, (self._pairs.idx_l, self._pairs.idx_r)):
            want = np.asarray(table.unique_id[idx])
            if not np.array_equal(df_e[c].to_numpy(), want):
                return False
        return True

    def _build_df_e(self, G: np.ndarray, rows: slice | None = None):
        """The scored comparisons DataFrame in the reference's column layout
        (splink/expectation_step.py:128-165); ``rows`` restricts it to a
        slice of the pair set (streaming)."""
        pairs = self._ensure_pairs()
        il, ir = pairs.idx_l, pairs.idx_r
        if rows is not None:
            G, il, ir = G[rows], il[rows], ir[rows]
        ctx = self._tf_fold_ctx()
        with self._timed("score"):
            p, prob_m, prob_u, z = self._score_batched(G, want_z=ctx is not None)
        tf_p = None
        if ctx is not None:
            with self._timed("tf_fold"):
                tf_p = self._tf_fold_pairs(z, il, ir, ctx)
        with self._timed("assemble"):
            df = self._assemble_df_e(G, il, ir, p, prob_m, prob_u, tf_p)
        return df

    def _scored_frame(self, G, il, ir, p, prob_m, prob_u, z):
        """A frame from host arrays aligned with (il, ir), the TF fold's
        probabilities computed from the fold logits ``z`` when the fold is
        active (zeros of the float type when there are none)."""
        tf_p = None
        ctx = self._tf_fold_ctx()
        if ctx is not None:
            tf_p = (self._tf_fold_pairs(z, il, ir, ctx) if z is not None and len(p)
                    else np.zeros(len(p), self._np_float))
        return self._assemble_df_e(G, il, ir, p, prob_m, prob_u, tf_p)

    def _assemble_df_e(self, G, il, ir, p, prob_m, prob_u, tf_p=None):
        """The frame's columns in the reference's order; ``tf_p``, the TF
        fold's probabilities, goes directly after match_probability."""
        table = self._ensure_encoded()
        settings = self.settings
        uid = settings["unique_id_column_name"]
        cols: dict[str, np.ndarray] = {"match_probability": p}
        if tf_p is not None:
            cols["tf_match_probability"] = tf_p

        def add_lr(name, values):
            cols.setdefault(f"{name}_l", values[il])
            cols.setdefault(f"{name}_r", values[ir])

        add_lr(uid, table.unique_id)
        for c, col in enumerate(settings["comparison_columns"]):
            name = comparison_column_name(col)
            if settings["retain_matching_columns"] or col["term_frequency_adjustments"]:
                if "col_name" in col:
                    add_lr(name, table.column_values(name))
                else:
                    for used in col["custom_columns_used"]:
                        add_lr(used, table.column_values(used))
            cols[f"gamma_{name}"] = G[:, c].astype(np.int64)
            if settings["retain_intermediate_calculation_columns"]:
                cols[f"prob_gamma_{name}_non_match"] = prob_u[:, c]
                cols[f"prob_gamma_{name}_match"] = prob_m[:, c]

        if settings["link_type"] == "link_and_dedupe":
            src = np.array(["left", "right"], dtype=object)[table.source_table]
            add_lr("_source_table", src)
        for extra in settings["additional_columns_to_retain"]:
            add_lr(extra, table.column_values(extra))
        return pd.DataFrame(cols)


@check_types
def load_from_json(
    path: str | os.PathLike,
    df=None,
    df_l=None,
    df_r=None,
    save_state_fn: Callable = None,
    device=None,
):
    """Load a model saved with save_model_as_json (by this package or by
    splink_tpu) and return a ready linker."""
    params = load_params_from_json(path)
    linker = Splink(
        params.settings, df=df, df_l=df_l, df_r=df_r,
        save_state_fn=save_state_fn, device=device,
    )
    linker.params = params
    return linker
