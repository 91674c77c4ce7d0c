"""Vega-Lite chart specs for model diagnostics.

Covers the same five diagnostic views the reference ships
(splink/chart_definitions.py): m/u probability distributions,
adjustment factors, lambda history, pi history and log-likelihood history,
plus the per-row adjustment (waterfall-style) chart used by the intuition
report. Specs here are authored for this package; data row formats match the
reference so downstream tooling can consume either.
"""

from __future__ import annotations

import json
import os


def _base(title: str, mark: str, encoding: dict, extra: dict | None = None) -> dict:
    spec = {
        "$schema": "https://vega.github.io/schema/vega-lite/v3.json",
        "title": title,
        "mark": mark,
        "data": {"values": []},
        "encoding": encoding,
    }
    if extra:
        spec.update(extra)
    return spec


probability_distribution_chart_def = _base(
    "Probability distribution of comparison vector values, m=match, u=non-match",
    "bar",
    {
        "x": {"type": "quantitative", "field": "probability"},
        "y": {"type": "nominal", "field": "value_of_gamma", "sort": "descending"},
        "color": {"type": "nominal", "field": "match"},
        "row": {"type": "nominal", "field": "column"},
        "column": {"type": "nominal", "field": "match"},
        "tooltip": [
            {"type": "nominal", "field": "column"},
            {"type": "quantitative", "field": "probability"},
            {"type": "ordinal", "field": "value"},
        ],
    },
    {"resolve": {"scale": {"y": "independent"}}, "height": 100},
)

lambda_iteration_chart_def = _base(
    "Lambda (estimated proportion of matches) by iteration",
    "bar",
    {
        "x": {"type": "ordinal", "field": "iteration"},
        "y": {"type": "quantitative", "field": "λ", "scale": {"domain": [0, 1]}},
        "tooltip": [
            {"type": "quantitative", "field": "λ"},
            {"type": "ordinal", "field": "iteration"},
        ],
    },
)

ll_iteration_chart_def = _base(
    "Log likelihood by iteration",
    "bar",
    {
        "x": {"type": "ordinal", "field": "iteration"},
        "y": {"type": "quantitative", "field": "log_likelihood"},
        "tooltip": [
            {"type": "quantitative", "field": "log_likelihood"},
            {"type": "ordinal", "field": "iteration"},
        ],
    },
)

pi_iteration_chart_def = _base(
    "Estimated m and u probabilities by iteration",
    "bar",
    {
        "x": {"type": "quantitative", "field": "probability"},
        "y": {"type": "nominal", "field": "iteration", "sort": "descending"},
        "color": {"type": "nominal", "field": "match"},
        "row": {"type": "nominal", "field": "value_of_gamma"},
        "column": {"type": "nominal", "field": "column"},
        "tooltip": [
            {"type": "nominal", "field": "column"},
            {"type": "nominal", "field": "value_of_gamma"},
            {"type": "quantitative", "field": "probability"},
            {"type": "ordinal", "field": "iteration"},
        ],
    },
    {"height": 120},
)

adjustment_weight_chart_def = _base(
    "Influence of comparison vector values on match probability",
    "bar",
    {
        "x": {"type": "nominal", "field": "col_name"},
        "y": {
            "type": "quantitative",
            "field": "normalised_adjustment",
            "scale": {"domain": [-0.5, 0.5]},
            "axis": {"title": "match weight (adjustment - 0.5)"},
        },
        "color": {
            "type": "quantitative",
            "field": "normalised_adjustment",
            "scale": {"domain": [-0.5, 0.5], "scheme": "redyellowgreen"},
        },
        "row": {"type": "nominal", "field": "level"},
        "tooltip": [
            {"type": "nominal", "field": "col_name"},
            {"type": "nominal", "field": "level"},
            {"type": "quantitative", "field": "m"},
            {"type": "quantitative", "field": "u"},
            {"type": "quantitative", "field": "adjustment"},
        ],
    },
    {"height": 80},
)

adjustment_factor_chart_def = _base(
    "Per-column adjustment factors for this record comparison",
    "bar",
    {
        "x": {
            "type": "quantitative",
            "field": "normalised",
            "scale": {"domain": [-0.5, 0.5]},
            "axis": {"title": "adjustment factor - 0.5"},
        },
        "y": {"type": "nominal", "field": "col_name"},
        "color": {
            "type": "quantitative",
            "field": "normalised",
            "scale": {"domain": [-0.5, 0.5], "scheme": "redyellowgreen"},
        },
        "tooltip": [
            {"type": "nominal", "field": "col_name"},
            {"type": "quantitative", "field": "value"},
        ],
    },
)

_MULTI_CHART_PAGE = """<!DOCTYPE html>
<html>
<head>
  <script src="https://cdn.jsdelivr.net/npm/vega@{vega_version}"></script>
  <script src="https://cdn.jsdelivr.net/npm/vega-lite@{vegalite_version}"></script>
  <script src="https://cdn.jsdelivr.net/npm/vega-embed@{vegaembed_version}"></script>
</head>
<body>
{divs}
<script>
{embeds}
</script>
</body>
</html>
"""


def render_charts_html(specs_with_data: list[dict],
                       vega_version="5", vegalite_version="3.3.0",
                       vegaembed_version="4") -> str:
    """Render a standalone HTML page embedding every chart spec given."""
    divs, embeds = [], []
    for i, spec in enumerate(specs_with_data):
        divs.append(f'<div id="chart_{i}"></div>')
        embeds.append(
            f"vegaEmbed('#chart_{i}', {json.dumps(spec)}).catch(console.error);"
        )
    return _MULTI_CHART_PAGE.format(
        vega_version=vega_version,
        vegalite_version=vegalite_version,
        vegaembed_version=vegaembed_version,
        divs="\n".join(divs),
        embeds="\n".join(embeds),
    )


def with_data(spec: dict, rows: list[dict]) -> dict:
    out = json.loads(json.dumps(spec))
    out["data"]["values"] = rows
    return out


def try_altair(spec: dict):
    """Return an altair Chart if altair is importable, else the raw spec dict."""
    try:  # pragma: no cover - altair not in the base image
        import altair as alt

        return alt.Chart.from_dict(spec)
    except Exception:
        return spec


def write_html_file(path: str, specs_with_data: list[dict], overwrite: bool = False):
    if os.path.isfile(path) and not overwrite:
        raise ValueError(f"The path {path} already exists. Please provide a different path.")
    with open(path, "w") as f:
        f.write(render_charts_html(specs_with_data))
