"""The intuition report of splink_tpu_torch against splink_tpu's: the same
scored row and parameters give the same text and the same chart."""

import copy

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)
pytest.importorskip("pandas")

import splink_tpu  # noqa: E402
from splink_tpu import intuition as ref_intuition  # noqa: E402
from splink_tpu_torch import intuition  # noqa: E402
from splink_tpu_torch.params import load_params_from_dict  # noqa: E402

from test_torch_linker import people, settings  # noqa: E402


@pytest.fixture(scope="module")
def scored():
    """The reference's scored frame with its intermediate columns, its
    parameters, and the same parameters loaded into the port."""
    s = settings(retain_intermediate_calculation_columns=True,
                 retain_matching_columns=True)
    linker = splink_tpu.Splink(copy.deepcopy(s), df=people(1500, seed=5))
    df_e = linker.get_scored_comparisons()
    port_params = load_params_from_dict(copy.deepcopy(linker.params._to_dict()))
    return df_e, linker.params, port_params


@pytest.mark.parametrize("row", [0, 17, "planted", "null"])
def test_intuition_report_same_text(scored, row):
    df_e, ref_params, port_params = scored
    if row == "planted":
        row = int(np.argmax(df_e["match_probability"].to_numpy()))
    elif row == "null":
        row = int(np.flatnonzero((df_e.filter(like="gamma_") == -1).any(axis=1).to_numpy())[0])
    row_dict = df_e.iloc[row].to_dict()
    text = intuition.intuition_report(row_dict, port_params)
    assert text == ref_intuition.intuition_report(row_dict, ref_params)
    assert "Final probability of match" in text
    final = float(text.strip().rsplit("=", 1)[1])
    assert final == pytest.approx(row_dict["match_probability"], abs=1e-5)


def test_adjustment_factor_chart_same_dict(scored):
    df_e, ref_params, port_params = scored
    row_dict = df_e.iloc[3].to_dict()
    got = intuition.adjustment_factor_chart(row_dict, port_params)
    assert got == ref_intuition.adjustment_factor_chart(row_dict, ref_params)
    assert len(got["data"]["values"]) == 5


def test_missing_intermediate_columns_raise(scored):
    df_e, _, port_params = scored
    row_dict = df_e.iloc[0].drop(labels=["prob_gamma_surname_match"]).to_dict()
    with pytest.raises(KeyError, match="retain_intermediate_calculation_columns"):
        intuition.intuition_report(row_dict, port_params)
