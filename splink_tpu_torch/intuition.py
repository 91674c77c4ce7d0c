"""Single-pair explainability: the sequential-Bayes intuition report, a copy
of splink_tpu/intuition.py.

Same narrative as the reference (splink/intuition.py:32-92):
start from the prior lambda, apply each column's adjustment factor
m/(m+u) in turn, and report the updated belief after every step, ending at
the final match probability. Requires the prob_gamma_* columns, i.e.
retain_intermediate_calculation_columns = true.
"""

from __future__ import annotations

from . import charts
from .params import Params

_INITIAL = """
Initial probability of match (prior) = λ = {lam}
"""

_COL = """
Comparison of {col_name}.  Values are:
{col_name}_l: {value_l}
{col_name}_r: {value_r}
Comparison has {num_levels} levels
𝛾 for this comparison = {gamma_col_name} = {gamma_value}
Amongst matches, P(𝛾 = {gamma_value}) = {prob_m}
Amongst non matches, P(𝛾 = {gamma_value}) = {prob_nm}
Adjustment factor = m/(m + u) = {adj}
New probability of match (updated belief): {updated_belief}
"""

_END = """
Final probability of match = {final}
"""


def _row_get(row_dict, key):
    try:
        return row_dict[key]
    except (KeyError, IndexError) as e:
        raise KeyError(
            f"Row is missing column {key!r}. The intuition report needs the "
            "intermediate probability columns: set "
            "retain_intermediate_calculation_columns (and "
            "retain_matching_columns) to true in your settings."
        ) from e


def intuition_report(row_dict, params: Params) -> str:
    """Text explanation of how one row's match probability was computed.

    Args:
        row_dict: mapping (dict / pandas Series) for one scored comparison.
        params: the trained Params object.
    """
    pi = params.params["π"]
    lam = params.params["λ"]
    report = _INITIAL.format(lam=lam)
    current_p = lam

    for gk, col_params in pi.items():
        col_name = col_params["column_name"]
        if col_params.get("custom_comparison"):
            used = col_params.get("custom_columns_used", [])
            value_l = ", ".join(str(_row_get(row_dict, c + "_l")) for c in used)
            value_r = ", ".join(str(_row_get(row_dict, c + "_r")) for c in used)
        else:
            value_l = _row_get(row_dict, col_name + "_l")
            value_r = _row_get(row_dict, col_name + "_r")

        prob_m = float(_row_get(row_dict, f"prob_{gk}_match"))
        prob_nm = float(_row_get(row_dict, f"prob_{gk}_non_match"))
        # zero-filled levels (EM never observed this gamma value) zero
        # both probabilities: no evidence either way -> neutral 0.5, and
        # the belief update keeps the prior unchanged
        den = prob_m + prob_nm
        adj = prob_m / den if den > 0 else 0.5
        a = adj * current_p
        b = (1 - adj) * (1 - current_p)
        tot = a + b
        current_p = a / tot if tot > 0 else current_p

        report += _COL.format(
            col_name=col_name,
            value_l=value_l,
            value_r=value_r,
            num_levels=col_params["num_levels"],
            gamma_col_name=gk,
            gamma_value=_row_get(row_dict, gk),
            prob_m=prob_m,
            prob_nm=prob_nm,
            adj=adj,
            updated_belief=current_p,
        )

    report += _END.format(final=current_p)
    return report


def _get_adjustment_factors(row_dict, params: Params) -> list[dict]:
    out = []
    for gk, col_params in params.params["π"].items():
        prob_m = float(_row_get(row_dict, f"prob_{gk}_match"))
        prob_nm = float(_row_get(row_dict, f"prob_{gk}_non_match"))
        # zero-filled levels carry no evidence: neutral 0.5 adjustment
        den = prob_m + prob_nm
        adj = prob_m / den if den > 0 else 0.5
        out.append(
            {
                "gamma": gk,
                "col_name": col_params["column_name"],
                "value": adj,
                "normalised": adj - 0.5,
            }
        )
    return out


def adjustment_factor_chart(row_dict, params: Params):
    """Waterfall-style chart of per-column adjustment factors for one row."""
    return charts.try_altair(
        charts.with_data(
            charts.adjustment_factor_chart_def, _get_adjustment_factors(row_dict, params)
        )
    )
