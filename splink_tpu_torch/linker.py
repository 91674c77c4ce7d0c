"""User-facing linker: splink_tpu's ``Splink`` on PyTorch, resident regime.

Same API shape as splink_tpu/linker.py — ``Splink(settings, df=... |
df_l=..., df_r=...)``, ``get_scored_comparisons()``,
``estimate_parameters()``, ``manually_apply_fellegi_sunter_weights()``,
``save_model_as_json()`` and module-level ``load_from_json`` — plus a
``device`` argument. The pipeline: host encode -> host hash-join blocking ->
gamma matrix on the device (hand-written CUDA string kernels on a GPU) ->
EM with the gamma matrix resident on the device -> batched scoring into the
reference's output frame.

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
from .em import run_em, score_pairs, score_pairs_with_intermediates
from .gammas import GammaProgram, check_kinds_ported
from .params import Params, fsparams_from_numpy, load_params_from_json
from .settings import comparison_column_name, complete_settings_dict

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
    if any(c.get("term_frequency_adjustments") for c in settings["comparison_columns"]):
        raise _not_ported("term_frequency_adjustments", "term frequencies")
    check_kinds_ported(settings)


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

    def _score_batched(self, G: np.ndarray):
        """Match probabilities (and, when retained, the per-column m/u
        lookups) in pair_batch_size batches on the device."""
        lam, m, u, _ = self.params.to_arrays()
        params = fsparams_from_numpy(lam, m, u, self.device, self._float_dtype)
        G_dev = self._gamma_tensor(G)
        want_inter = bool(self.settings["retain_intermediate_calculation_columns"])
        batch = int(self.settings["pair_batch_size"])
        out = []
        for s in range(0, len(G), batch):
            Gb = G_dev[s : s + batch]
            res = (
                score_pairs_with_intermediates(Gb, params)
                if want_inter
                else (score_pairs(Gb, params),)
            )
            out.append(res)
        if not out:
            empty = torch.zeros((0, G.shape[1]), dtype=self._float_dtype).numpy()
            return empty[:, 0], empty, empty
        cols = [torch.cat(parts).cpu().numpy() for parts in zip(*out)]
        p = cols[0]
        return (p, cols[1], cols[2]) if want_inter else (p, None, None)

    def _build_df_e(self, G: np.ndarray):
        """The scored comparisons DataFrame in the reference's column layout
        (splink/expectation_step.py:128-165)."""
        pairs = self._ensure_pairs()
        with self._timed("score"):
            p, prob_m, prob_u = self._score_batched(G)
        with self._timed("assemble"):
            df = self._assemble_df_e(G, pairs.idx_l, pairs.idx_r, p, prob_m, prob_u)
        return df

    def _assemble_df_e(self, G, il, ir, p, prob_m, prob_u):
        table = self._ensure_encoded()
        settings = self.settings
        uid = settings["unique_id_column_name"]
        cols: dict[str, np.ndarray] = {"match_probability": p}

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
