"""Model parameter state for the Fellegi-Sunter model.

Keeps the exact serialised layout of the reference implementation
(splink/params.py:34-336): a ``λ`` scalar plus a ``π`` nested
dict with per-column, per-level match/non-match probabilities, a per-iteration
history, and JSON persistence as ``{current_params, historical_params,
settings}`` so models saved by either implementation can be loaded by the
other. On top of that it provides lossless conversion to/from dense
``(n_cols, max_levels)`` arrays, which is the form the EM loop works
with (params stay on device across iterations; this object is only touched at
the host boundary).
"""

from __future__ import annotations

import copy
import json
import logging
import os

import numpy as np

from . import charts
from .settings import complete_settings_dict, comparison_column_name

logger = logging.getLogger("splink_tpu_torch")


class Params:
    """Current model parameters plus the values from every previous iteration."""

    def __init__(self, settings: dict, complete: bool = True):
        self.param_history: list[dict] = []
        self.iteration = 1
        self.settings = complete_settings_dict(settings) if complete else settings
        self.params = {"λ": self.settings["proportion_of_matches"], "π": {}}
        self.log_likelihood_exists = False
        # Optional dict in the same layout as self.params holding the true
        # data-generating parameters (for charts on synthetic data).
        self.real_params = None
        self._generate_param_dict()

    # ------------------------------------------------------------------
    # Construction
    # ------------------------------------------------------------------

    def _generate_param_dict(self) -> None:
        for col_dict in self.settings["comparison_columns"]:
            col_name = comparison_column_name(col_dict)
            key = f"gamma_{col_name}"
            num_levels = col_dict["num_levels"]

            entry = {
                "gamma_index": col_dict["gamma_index"],
                "desc": f"Comparison of {col_name}",
                "column_name": col_name,
            }
            if "custom_name" in col_dict:
                entry["custom_comparison"] = True
                entry["custom_columns_used"] = col_dict["custom_columns_used"]
            else:
                entry["custom_comparison"] = False
            entry["num_levels"] = num_levels

            m = _normalised(col_dict["m_probabilities"])
            u = _normalised(col_dict["u_probabilities"])
            entry["prob_dist_match"] = {
                f"level_{lv}": {"value": lv, "probability": m[lv]}
                for lv in range(num_levels)
            }
            entry["prob_dist_non_match"] = {
                f"level_{lv}": {"value": lv, "probability": u[lv]}
                for lv in range(num_levels)
            }
            self.params["π"][key] = entry

    # ------------------------------------------------------------------
    # Introspection
    # ------------------------------------------------------------------

    @property
    def _gamma_cols(self):
        return list(self.params["π"].keys())

    def describe_gammas(self) -> dict:
        return {k: v["desc"] for k, v in self.params["π"].items()}

    @property
    def max_levels(self) -> int:
        return max(v["num_levels"] for v in self.params["π"].values())

    # ------------------------------------------------------------------
    # Array <-> dict conversion (the device-facing view)
    # ------------------------------------------------------------------

    def to_arrays(self, dtype=np.float64):
        """Return (lam, m, u, level_mask).

        m/u have shape (n_cols, max_levels); rows are padded with zeros past a
        column's num_levels, and level_mask marks the valid entries.
        """
        cols = self._gamma_cols
        n_cols, max_levels = len(cols), self.max_levels
        m = np.zeros((n_cols, max_levels), dtype=dtype)
        u = np.zeros((n_cols, max_levels), dtype=dtype)
        mask = np.zeros((n_cols, max_levels), dtype=bool)
        for c, key in enumerate(cols):
            entry = self.params["π"][key]
            for lv in range(entry["num_levels"]):
                m[c, lv] = entry["prob_dist_match"][f"level_{lv}"]["probability"]
                u[c, lv] = entry["prob_dist_non_match"][f"level_{lv}"]["probability"]
                mask[c, lv] = True
        return np.asarray(self.params["λ"], dtype=dtype), m, u, mask

    def update_from_arrays(self, lam, m, u) -> None:
        """One EM update: archive current params then install the new values.

        Matches the reference's update cycle (save -> reset -> populate with
        zero-fill for unseen levels -> increment iteration,
        splink/params.py:248-285). Unseen levels arrive here
        as exact zeros from the M-step, which reproduces the reference's
        zero-fill behaviour; gamma = -1 pseudo-levels are excluded upstream.
        """
        self._save_params_to_iteration_history()
        self.params["λ"] = float(lam)
        m = np.asarray(m)
        u = np.asarray(u)
        for c, key in enumerate(self._gamma_cols):
            entry = self.params["π"][key]
            for lv in range(entry["num_levels"]):
                entry["prob_dist_match"][f"level_{lv}"]["probability"] = float(m[c, lv])
                entry["prob_dist_non_match"][f"level_{lv}"]["probability"] = float(u[c, lv])
        self.iteration += 1

    def _save_params_to_iteration_history(self) -> None:
        self.param_history.append(copy.deepcopy(self.params))
        if "log_likelihood" in self.params:
            self.log_likelihood_exists = True

    # ------------------------------------------------------------------
    # Convergence
    # ------------------------------------------------------------------

    def is_converged(self) -> bool:
        """Max absolute change in any π probability below em_convergence.

        Like the reference (splink/params.py:316-336) this
        inspects the π probabilities only; λ is tracked in history but does
        not gate convergence.
        """
        threshold = self.settings["em_convergence"]
        new = _pi_probabilities(self.params)
        old = _pi_probabilities(self.param_history[-1])
        biggest_change, biggest_key = 0.0, ""
        for k, v in new.items():
            change = abs(v - old[k])
            if change > biggest_change:
                biggest_change, biggest_key = change, k
        logger.info(
            "The maximum change in parameters was %s for key %s",
            biggest_change,
            biggest_key,
        )
        return biggest_change < threshold

    # ------------------------------------------------------------------
    # Persistence
    # ------------------------------------------------------------------

    def _to_dict(self) -> dict:
        return {
            "current_params": self.params,
            "historical_params": self.param_history,
            "settings": _jsonable_settings(self.settings),
        }

    def save_params_to_json_file(self, path=None, overwrite=False) -> None:
        if not path:
            raise ValueError("Must provide a path to write to")
        if os.path.isfile(path) and not overwrite:
            raise ValueError(
                f"The path {path} already exists. Please provide a different path."
            )
        with open(path, "w") as f:
            json.dump(self._to_dict(), f, indent=4)

    # ------------------------------------------------------------------
    # History views (chart data)
    # ------------------------------------------------------------------

    @staticmethod
    def _convert_params_dict_to_dataframe(params, iteration_num=None) -> list[dict]:
        rows = []
        for gamma_str, gamma_dict in params["π"].items():
            for match_flag, dist in (
                (1, "prob_dist_match"),
                (0, "prob_dist_non_match"),
            ):
                for level_str, level_dict in gamma_dict[dist].items():
                    row = {}
                    if iteration_num is not None:
                        row["iteration"] = iteration_num
                    row.update(
                        gamma=gamma_str,
                        match=match_flag,
                        value_of_gamma=level_str,
                        probability=level_dict["probability"],
                        value=level_dict["value"],
                        column=gamma_dict["column_name"],
                    )
                    rows.append(row)
        return rows

    def _convert_params_dict_to_normalised_adjustment_data(self) -> list[dict]:
        rows = []
        for gamma_str, entry in self.params["π"].items():
            for lv in range(entry["num_levels"]):
                level = f"level_{lv}"
                m = entry["prob_dist_match"][level]["probability"]
                u = entry["prob_dist_non_match"][level]["probability"]
                row = {"level": level, "col_name": entry["column_name"], "m": m, "u": u}
                if (m or 0) + (u or 0) > 0:
                    row["adjustment"] = m / (m + u)
                    row["normalised_adjustment"] = row["adjustment"] - 0.5
                else:
                    row["adjustment"] = None
                    row["normalised_adjustment"] = None
                rows.append(row)
        return rows

    def _iteration_history_df_gammas(self) -> list[dict]:
        rows = []
        it = -1
        for it, historical in enumerate(self.param_history):
            rows.extend(self._convert_params_dict_to_dataframe(historical, it))
        rows.extend(self._convert_params_dict_to_dataframe(self.params, it + 1))
        return rows

    def _iteration_history_df_lambdas(self) -> list[dict]:
        rows = [
            {"λ": h["λ"], "iteration": it} for it, h in enumerate(self.param_history)
        ]
        rows.append({"λ": self.params["λ"], "iteration": len(self.param_history)})
        return rows

    def _iteration_history_df_log_likelihood(self) -> list[dict]:
        rows = [
            {"log_likelihood": h.get("log_likelihood"), "iteration": it}
            for it, h in enumerate(self.param_history)
        ]
        rows.append(
            {
                "log_likelihood": self.params.get("log_likelihood"),
                "iteration": len(self.param_history),
            }
        )
        return rows

    # ------------------------------------------------------------------
    # Charts
    # ------------------------------------------------------------------

    def pi_iteration_chart(self):  # pragma: no cover - presentational
        data = self._iteration_history_df_gammas()
        if self.real_params:
            data.extend(
                self._convert_params_dict_to_dataframe(self.real_params, "real_param")
            )
        return charts.try_altair(charts.with_data(charts.pi_iteration_chart_def, data))

    def lambda_iteration_chart(self):  # pragma: no cover - presentational
        data = self._iteration_history_df_lambdas()
        if self.real_params:
            data.append({"λ": self.real_params["λ"], "iteration": "real_param"})
        return charts.try_altair(
            charts.with_data(charts.lambda_iteration_chart_def, data)
        )

    def ll_iteration_chart(self):  # pragma: no cover - presentational
        if not self.log_likelihood_exists:
            raise RuntimeError(
                "Log likelihood not calculated. Pass compute_ll=True to iterate()."
            )
        data = self._iteration_history_df_log_likelihood()
        return charts.try_altair(charts.with_data(charts.ll_iteration_chart_def, data))

    def probability_distribution_chart(self):  # pragma: no cover - presentational
        data = self._convert_params_dict_to_dataframe(self.params)
        return charts.try_altair(
            charts.with_data(charts.probability_distribution_chart_def, data)
        )

    def adjustment_factor_chart(self):  # pragma: no cover - presentational
        data = self._convert_params_dict_to_normalised_adjustment_data()
        return charts.try_altair(
            charts.with_data(charts.adjustment_weight_chart_def, data)
        )

    def all_charts_write_html_file(self, filename="splink_charts.html", overwrite=False):
        specs = [
            charts.with_data(
                charts.probability_distribution_chart_def,
                self._convert_params_dict_to_dataframe(self.params),
            ),
            charts.with_data(
                charts.adjustment_weight_chart_def,
                self._convert_params_dict_to_normalised_adjustment_data(),
            ),
            charts.with_data(
                charts.lambda_iteration_chart_def, self._iteration_history_df_lambdas()
            ),
            charts.with_data(
                charts.pi_iteration_chart_def, self._iteration_history_df_gammas()
            ),
        ]
        if self.log_likelihood_exists:
            specs.append(
                charts.with_data(
                    charts.ll_iteration_chart_def,
                    self._iteration_history_df_log_likelihood(),
                )
            )
        charts.write_html_file(filename, specs, overwrite=overwrite)

    # ------------------------------------------------------------------
    # Text rendering
    # ------------------------------------------------------------------

    def _print_m_u_probs(self):  # pragma: no cover - presentational
        for key, entry in self.params["π"].items():
            m = [v["probability"] for v in entry["prob_dist_match"].values()]
            u = [v["probability"] for v in entry["prob_dist_non_match"].values()]
            print(key)
            print(f'"m_probabilities": {m},')
            print(f'"u_probabilities": {u}')

    def __repr__(self):
        p = self.params
        lines = [f"λ (proportion of matches) = {p['λ']}"]
        for gamma_str, entry in p["π"].items():
            lines.append("------------------------------------")
            lines.append(f"{gamma_str}: {entry['desc']}")
            for label, dist in (
                ("matches", "prob_dist_match"),
                ("non-matches", "prob_dist_non_match"),
            ):
                lines.append(f"Probability distribution of gamma values amongst {label}:")
                n = entry["num_levels"]
                for lv in range(n):
                    prob = entry[dist][f"level_{lv}"]["probability"]
                    prob_str = f"{prob:4f}" if prob else "None"
                    note = ""
                    if lv == 0:
                        note = " (lowest similarity)"
                    elif lv == n - 1:
                        note = " (highest similarity)"
                    lines.append(f"    value {lv}: {prob_str}{note}")
        return "\n".join(lines)


# ----------------------------------------------------------------------
# Module-level helpers
# ----------------------------------------------------------------------


def _normalised(probs):
    s = sum(probs)
    if s <= 0:
        # an all-zero distribution (every level zero-filled) carries no
        # information; renormalise to uniform rather than dividing by 0
        return [1.0 / len(probs)] * len(probs)
    return [p / s for p in probs]


def _pi_probabilities(params: dict) -> dict:
    """Flatten π into {col/dist/level: probability}."""
    out = {}
    for gamma_str, entry in params["π"].items():
        for dist in ("prob_dist_match", "prob_dist_non_match"):
            for level_str, level_dict in entry[dist].items():
                out[f"{gamma_str}.{dist}.{level_str}"] = level_dict["probability"]
    return out


def _jsonable_settings(settings: dict) -> dict:
    """Strip non-serialisable values (e.g. custom comparison callables)."""

    def default(o):
        return f"<<non-serialisable: {type(o).__name__}>>"

    return json.loads(json.dumps(settings, default=default))


def load_params_from_dict(param_dict: dict) -> Params:
    expected = {"current_params", "settings", "historical_params"}
    if set(param_dict.keys()) != expected:
        raise ValueError("Your saved params seem to be corrupted")
    p = Params(settings=param_dict["settings"])
    p.params = param_dict["current_params"]
    p.param_history = param_dict["historical_params"]
    p.iteration = len(p.param_history) + 1
    p.log_likelihood_exists = any(
        "log_likelihood" in h for h in p.param_history
    ) or "log_likelihood" in p.params
    return p


def load_params_from_json(path: str) -> Params:
    with open(path) as f:
        return load_params_from_dict(json.load(f))


def fsparams_from_numpy(lam, m, u, device=None, dtype=None):
    """Host arrays (e.g. splink_tpu's FSParams read back as numpy, or
    :meth:`Params.to_arrays`) -> this package's FSParams tensors on
    ``device``: ``cuda`` unless the caller names another; raises when that
    is CUDA and no CUDA device exists."""
    import torch

    from ._device import resolve_device
    from .models.fellegi_sunter import FSParams

    device = resolve_device(device)

    if dtype is None:
        dtype = torch.float64 if np.asarray(m).dtype == np.float64 else torch.float32

    def t(a):
        return torch.as_tensor(np.asarray(a), dtype=dtype, device=device)

    return FSParams(lam=t(lam), m=t(m), u=t(u))


def fsparams_to_numpy(params):
    """This package's FSParams -> (lam, m, u) numpy arrays, the form
    splink_tpu's FSParams is built from."""
    return tuple(np.asarray(x.detach().cpu().numpy()) for x in params)
