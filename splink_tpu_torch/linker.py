"""User-facing linker: splink_tpu's ``Splink`` on PyTorch, resident regime.

Same API shape as splink_tpu/linker.py — ``Splink(settings, df=... |
df_l=..., df_r=...)``, ``get_scored_comparisons()``,
``estimate_parameters()``, ``manually_apply_fellegi_sunter_weights()``,
``save_model_as_json()`` and module-level ``load_from_json`` — plus a
``device`` argument, and ``make_term_frequency_adjustments()``. The
pipeline: host encode and host hash-join blocking (the native host library)
-> gamma matrix on the device (hand-written CUDA string kernels on a GPU) ->
EM with the gamma matrix resident on the device -> batched scoring into the
reference's output frame, with the term-frequency u-probability fold
(``tf_match_probability``) when a comparison is flagged.

Device rule: with no ``device`` the linker runs on ``cuda`` and raises when
no CUDA device exists; it never carries on quietly on the CPU. Pass
``device="cpu"`` to run the plain PyTorch versions on the CPU.

Only the resident regime is ported. Settings that would send splink_tpu
down another path raise NotImplementedError naming the ROADMAP.md item
instead of running something else.
"""

from __future__ import annotations

import contextlib
import logging
import os
import time
from typing import Callable

import numpy as np
import torch

from ._device import resolve_device
from .blocking import PairIndex, block_using_rules, estimate_pair_upper_bound
from .check_types import check_types
from .data import EncodedTable, concat_tables, encode_table
from .em import (
    run_em,
    score_pairs,
    score_pairs_with_intermediates,
    score_pairs_with_intermediates_logits,
    score_pairs_with_logits,
)
from .gammas import GammaProgram
from .params import Params, fsparams_from_numpy, load_params_from_json
from .settings import comparison_column_name, complete_settings_dict
from .term_frequencies import (
    make_adjustment_for_term_frequencies,
    make_tf_fold_fn,
    term_frequency_columns,
    tf_fold_spec,
    tf_log_table,
)

logger = logging.getLogger("splink_tpu_torch")

try:  # pandas is required for the linker facade (not for the kernels)
    import pandas as pd
except ImportError:  # pragma: no cover
    pd = None


def _not_ported(what: str, item: str):
    return NotImplementedError(
        f"{what} routes splink_tpu away from the resident regime, which is "
        f"all splink_tpu_torch ports so far (ROADMAP.md, {item!r})"
    )


def _check_resident_settings(settings: dict) -> None:
    """Raise for every setting that would take splink_tpu off the resident
    train-and-score path."""
    for key, item in (
        ("mesh", "multi-GPU"),
        ("spill_dir", "overlap / pattern / streamed / spill regimes"),
        ("build_spill_dir", "overlap / pattern / streamed / spill regimes"),
        ("checkpoint_dir", "checkpointing and EMNumericsError"),
        ("telemetry_dir", "observability"),
    ):
        if settings.get(key):
            raise _not_ported(f"a non-empty {key!r}", item)
    if settings.get("device_pair_generation") == "on":
        raise _not_ported("device_pair_generation: 'on'",
                          "overlap / pattern / streamed / spill regimes")


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
        _check_resident_settings(self.settings)
        self.params = Params(self.settings, complete=False)
        self.df = df
        self.df_l = df_l
        self.df_r = df_r
        self.save_state_fn = save_state_fn
        self._check_args()
        self._table: EncodedTable | None = None
        self._pairs: PairIndex | None = None
        self._G: np.ndarray | None = None
        self._G_dev = None  # device copy of the gamma matrix
        self._last_em_result = None
        self._tf_fold_cache = None
        # stage name -> wall seconds of this linker's last run of it
        # (synchronised with the device at the stage's end)
        self.stage_seconds: dict[str, float] = {}

    @property
    def _float_dtype(self):
        return torch.float64 if self.settings["float64"] else torch.float32

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

    @contextlib.contextmanager
    def _timed(self, stage: str):
        """Record the stage's wall seconds, the device's work included."""
        t0 = time.perf_counter()
        yield
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self.stage_seconds[stage] = time.perf_counter() - t0

    @property
    def _n_left(self) -> int | None:
        if self.settings["link_type"] == "dedupe_only":
            return None
        return len(self.df_l)

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
        return self._table

    def _ensure_pairs(self) -> PairIndex:
        if self._pairs is None:
            table = self._ensure_encoded()
            max_resident = int(self.settings["max_resident_pairs"])
            if self.settings.get("device_pair_generation", "auto") == "auto" and (
                estimate_pair_upper_bound(self.settings, table, self._n_left)
                > max_resident
            ):
                raise _not_ported(
                    "a pair-count bound above max_resident_pairs (device pair "
                    "generation)", "overlap / pattern / streamed / spill regimes",
                )
            with self._timed("blocking"):
                self._pairs = block_using_rules(self.settings, table, self._n_left)
            logger.info("blocking produced %d candidate pairs", self._pairs.n_pairs)
            if self._pairs.n_pairs > max_resident:
                raise _not_ported(
                    f"{self._pairs.n_pairs} candidate pairs (more than "
                    "max_resident_pairs)",
                    "overlap / pattern / streamed / spill regimes",
                )
            from .blocking import clear_key_code_cache

            clear_key_code_cache(table)
        return self._pairs

    def _ensure_gammas(self) -> np.ndarray:
        if self._G is None:
            table = self._ensure_encoded()
            pairs = self._ensure_pairs()
            with self._timed("gammas"):
                program = GammaProgram(
                    self.settings, table, float_dtype=self._float_dtype,
                    device=self.device,
                )
                self._G, self._G_dev = program.compute_with_device(
                    pairs.idx_l, pairs.idx_r,
                    batch_size=int(self.settings["pair_batch_size"]),
                    keep_device=True,
                )
        return self._G

    def _gamma_tensor(self, G: np.ndarray):
        if self._G_dev is not None and G is self._G:
            return self._G_dev
        return torch.from_numpy(G).to(self.device)

    # ------------------------------------------------------------------
    # Public API
    # ------------------------------------------------------------------

    def manually_apply_fellegi_sunter_weights(self):
        """Score using the m/u values in the settings (or a loaded model),
        without running EM."""
        df_e = self._build_df_e(self._ensure_gammas())
        self._G_dev = None  # release the device copy once scoring is done
        return df_e

    def estimate_parameters(self, compute_ll: bool = False) -> Params:
        """Train only: blocking, gammas and EM, returning the fitted Params
        and producing no per-pair output."""
        self._run_em(self._ensure_gammas(), compute_ll)
        self._G_dev = None
        return self.params

    def get_scored_comparisons(self, compute_ll: bool = False):
        """Estimate parameters by EM and return the scored comparisons."""
        G = self._ensure_gammas()
        self._run_em(G, compute_ll)
        df_e = self._build_df_e(G)
        self._G_dev = None
        return df_e

    def _em_init(self):
        lam, m, u, _ = self.params.to_arrays()
        return fsparams_from_numpy(lam, m, u, self.device, self._float_dtype)

    def _run_em(self, G: np.ndarray, compute_ll: bool) -> None:
        """Resident EM: the whole run in one run_em call, or one update per
        call when a save_state_fn must run between iterations."""
        G_dev = self._gamma_tensor(G)
        em_kwargs = dict(
            max_levels=self.params.max_levels,
            em_convergence=self.settings["em_convergence"],
            compute_ll=compute_ll,
        )
        max_iterations = int(self.settings["max_iterations"])
        with self._timed("em"):
            if self.save_state_fn is None:
                result = run_em(
                    G_dev, self._em_init(), max_iterations=max_iterations, **em_kwargs
                )
                self._replay_history(result, compute_ll)
                converged = result.converged
            else:
                converged = False
                params = self._em_init()
                for _ in range(max_iterations):
                    result = run_em(G_dev, params, max_iterations=1, **em_kwargs)
                    params = result.params
                    self._replay_history(result, compute_ll)
                    self.save_state_fn(self.params, self.settings)
                    if result.converged:
                        converged = True
                        break
        if converged:
            logger.info("EM algorithm has converged")

    def _replay_history(self, result, compute_ll: bool) -> None:
        """Install a run_em result's history into the Params object (history
        index i = params before update i+1; ll index i = log likelihood
        under params i, NaN = not computed)."""
        self._last_em_result = result
        n = int(result.n_updates)
        ll = result.ll_history
        for k in range(1, n + 1):
            if compute_ll and not np.isnan(ll[k - 1]):
                self.params.params["log_likelihood"] = float(ll[k - 1])
                self.params.log_likelihood_exists = True
            self.params.update_from_arrays(
                float(result.lam_history[k]), result.m_history[k], result.u_history[k]
            )
        if compute_ll and not np.isnan(ll[n]):
            self.params.params["log_likelihood"] = float(ll[n])
            self.params.log_likelihood_exists = True

    @check_types
    def save_model_as_json(self, path: str | os.PathLike, overwrite: bool = False):
        self.params.save_params_to_json_file(path, overwrite=overwrite)

    # ------------------------------------------------------------------
    # Output assembly
    # ------------------------------------------------------------------

    def _score_batched(self, G: np.ndarray, want_z: bool = False):
        """Match probabilities (and, when retained, the per-column m/u
        lookups; with ``want_z``, the fold logits that the TF fold adds its
        deltas to) in pair_batch_size batches on the device. Returns host
        arrays (p, prob_m, prob_u, z), None for what was not asked for."""
        lam, m, u, _ = self.params.to_arrays()
        params = fsparams_from_numpy(lam, m, u, self.device, self._float_dtype)
        G_dev = self._gamma_tensor(G)
        want_inter = bool(self.settings["retain_intermediate_calculation_columns"])
        batch = int(self.settings["pair_batch_size"])
        out = []
        for s in range(0, max(len(G), 1), batch):  # one empty batch for no pairs
            Gb = G_dev[s : s + batch]
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
        lam, m, u, _ = self.params.to_arrays()
        u_dev = fsparams_from_numpy(lam, m, u, self.device, self._float_dtype).u
        np_dtype = np.float64 if self.settings["float64"] else np.float32
        logs_dev = [torch.from_numpy(t.astype(np_dtype)).to(self.device) for t in logs]
        tids_dev = [torch.from_numpy(t).to(self.device) for t in tids]
        n = len(z)
        batch = int(self.settings["pair_batch_size"])
        out = np.empty(n, np_dtype)
        for s in range(0, n, batch):
            e = min(s + batch, n)
            idx = [torch.from_numpy(np.ascontiguousarray(a[s:e])).to(self.device)
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

    def _build_df_e(self, G: np.ndarray):
        """The scored comparisons DataFrame in the reference's column layout
        (splink/expectation_step.py:128-165)."""
        pairs = self._ensure_pairs()
        ctx = self._tf_fold_ctx()
        with self._timed("score"):
            p, prob_m, prob_u, z = self._score_batched(G, want_z=ctx is not None)
        tf_p = None
        if ctx is not None:
            with self._timed("tf_fold"):
                tf_p = self._tf_fold_pairs(z, pairs.idx_l, pairs.idx_r, ctx)
        with self._timed("assemble"):
            df = self._assemble_df_e(G, pairs.idx_l, pairs.idx_r, p, prob_m, prob_u, tf_p)
        return df

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
