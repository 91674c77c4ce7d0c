"""The per-audit kernel lists of ``python -m splink_tpu_torch.analysis``:
``--audit-kernels``, ``--shard-kernels``, ``--perf-kernels`` and
``--num-kernels``, the reference CLI's flags.

Each implies its audit and narrows only that audit; ``--kernels`` stays the
list of every requested audit without one of its own. The routes are cheap:
the perf plan is listed without measuring, the trace, shard and num audits
take one registered program on the CPU, and the perf audit's own run is
replaced by a recorder. An unknown name exits 2 and names itself, as the
reference's CLI does.
"""

import json

import pytest

pytest.importorskip("torch")

from splink_tpu_torch.analysis import perf_audit  # noqa: E402
from splink_tpu_torch.analysis.__main__ import main  # noqa: E402


def _json_run(capsys, args):
    rc = main([*args, "--device", "cpu", "--json"])
    return rc, json.loads(capsys.readouterr().out)


def test_perf_kernels_narrow_the_listed_plan(capsys):
    assert main(["--list-perf-kernels", "--perf-kernels", "jaro_winkler"]) == 0
    out = capsys.readouterr().out
    assert out.startswith("1 kernel(s)")
    assert out.splitlines()[1].split()[0] == "jaro_winkler"
    # the audit's own list wins over --kernels
    assert main(["--list-perf-kernels", "--kernels", "em_step",
                 "--perf-kernels", "jaro_winkler"]) == 0
    assert capsys.readouterr().out == out


@pytest.mark.parametrize("flag, kernel, counter", [
    ("--audit-kernels", "em_step", "kernels_audited"),
    ("--num-kernels", "tf_gather", "num_kernels_audited"),
    ("--shard-kernels", "score_pairs_sharded", "shard_kernels_audited"),
])
def test_each_flag_implies_and_narrows_its_audit(capsys, flag, kernel, counter):
    rc, report = _json_run(capsys, [flag, kernel])
    assert rc == 0, report
    assert report["clean"] and report[counter] == 1
    others = {"kernels_audited", "num_kernels_audited", "shard_kernels_audited",
              "perf_shapes_audited"} - {counter}
    assert all(report.get(k, 0) == 0 for k in others), report


def test_perf_kernels_imply_the_perf_audit(capsys, monkeypatch):
    calls = []

    def recorder(names=None, **kwargs):
        calls.append((names, kwargs.get("device")))
        return [], len(perf_audit.perf_plan(names))

    monkeypatch.setattr(perf_audit, "run_perf_audit", recorder)
    rc, report = _json_run(capsys, ["--perf-kernels", "jaro_winkler"])
    assert rc == 0 and calls == [(["jaro_winkler"], "cpu")]
    assert report["perf_shapes_audited"] == len(perf_audit.perf_plan(["jaro_winkler"]))
    assert report.get("kernels_audited", 0) == 0


def test_kernels_fills_the_audits_without_their_own_list(capsys):
    rc, report = _json_run(capsys, ["--audit", "--kernels", "em_step,tf_gather",
                                    "--num-kernels", "tf_gather"])
    assert rc == 0, report
    assert report["kernels_audited"] == 2 and report["num_kernels_audited"] == 1


@pytest.mark.parametrize("args", [
    ["--audit-kernels", "no_such_kernel"],
    ["--shard-kernels", "no_such_kernel"],
    ["--perf-kernels", "no_such_kernel"],
    ["--num-kernels", "no_such_kernel"],
    ["--list-perf-kernels", "--perf-kernels", "no_such_kernel"],
])
def test_unknown_kernel_exits_2(capsys, args):
    assert main([*args, "--device", "cpu"]) == 2
    err = capsys.readouterr().err
    assert "error:" in err and "no_such_kernel" in err
