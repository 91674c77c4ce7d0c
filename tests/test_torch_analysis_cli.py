"""``python -m splink_tpu_torch.analysis``: its exit codes, in subprocesses.

0 clean: the trace and num audits over the whole registry on the CPU (the
acceptance gate, as the README runs it), a lint of a clean file, the shard
audit of one kernel, the thread audit of the registry, and an ``NL`` rule
filter that leaves a file's numlint finding out. 1 findings: the num audit
against a budget file doctored to zero for one kernel. 2 usage: no audit
asked for, an unknown kernel, rule, shard kernel or thread class.
"""

import json
import os
import subprocess
import sys

import pytest

pytest.importorskip("torch")

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _run(args, timeout=240):
    return subprocess.run(
        [sys.executable, "-m", "splink_tpu_torch.analysis", *args],
        cwd=ROOT, capture_output=True, text=True, timeout=timeout,
    )


def test_trace_and_num_audits_of_the_registry_exit_clean_on_the_cpu():
    proc = _run(["--audit", "--num-audit", "--device", "cpu", "--json"])
    assert proc.returncode == 0, proc.stdout + proc.stderr
    report = json.loads(proc.stdout)
    assert report["clean"] and report["kernels_audited"] == 29
    assert report["num_kernels_audited"] == 31


def test_findings_exit_1(tmp_path):
    # the committed budgets with tf_gather's ulp budget doctored below any
    # measurement: the run reports NA-ULP and exits 1
    from splink_tpu_torch.analysis import num_audit

    doctored = num_audit.load_baselines()
    doctored["tiers"]["cpu"]["kernels"]["tf_gather"]["ulp_budget"] = -1.0
    path = tmp_path / "num_baselines.json"
    path.write_text(json.dumps(doctored))
    code = (
        "import sys; from splink_tpu_torch.analysis import num_audit, __main__ as m; "
        f"num_audit.BASELINES_PATH = {str(path)!r}; "
        "sys.exit(m.main(['--num-audit', '--device', 'cpu', '--kernels', 'tf_gather']))"
    )
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                          text=True, timeout=240)
    assert proc.returncode == 1, proc.stdout + proc.stderr
    assert "NA-ULP" in proc.stdout and "tf_gather" in proc.stdout


USAGE_CASES = [
    ([], "give at least one of"),
    (["--audit", "--device", "cpu", "--kernels", "no_such_kernel"], "no_such_kernel"),
    (["--thread-classes", "NoSuchClass"], "NoSuchClass"),
    (["splink_tpu_torch", "--rules", "JL999"], "JL999"),
    (["--shard-audit", "--device", "cpu", "--kernels", "no_such_shard"], "no_such_shard"),
]


@pytest.fixture(scope="module")
def usage_runs():
    """Every usage case through ``main`` in ONE child process (each child
    pays torch's import): {case index: (exit code, stderr)}."""
    code = (
        "import contextlib, io, json, sys\n"
        "from splink_tpu_torch.analysis.__main__ import main\n"
        f"cases = {[c for c, _ in USAGE_CASES]!r}\n"
        "out = {}\n"
        "for i, args in enumerate(cases):\n"
        "    err = io.StringIO()\n"
        "    with contextlib.redirect_stderr(err):\n"
        "        try:\n"
        "            rc = main(args)\n"
        "        except SystemExit as e:\n"
        "            rc = e.code\n"
        "    out[i] = (rc, err.getvalue())\n"
        "print(json.dumps(out))\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                          text=True, timeout=240)
    assert proc.returncode == 0, proc.stderr
    return {int(k): v for k, v in json.loads(proc.stdout).items()}


@pytest.mark.parametrize("case", range(len(USAGE_CASES)))
def test_usage_errors_exit_2(usage_runs, case):
    rc, err = usage_runs[case]
    assert rc == 2, err
    assert USAGE_CASES[case][1] in err


def test_lint_of_a_clean_file_exits_0(tmp_path):
    path = tmp_path / "clean.py"
    path.write_text("import torch\n\n\ndef f(n):\n"
                    "    return torch.arange(n, dtype=torch.int32)\n")
    proc = _run([str(path), "--json"])
    assert proc.returncode == 0, proc.stdout + proc.stderr
    report = json.loads(proc.stdout)
    assert report["clean"] and report["files_checked"] == 1


def test_shard_audit_of_one_kernel_exits_0():
    proc = _run(["--shard-audit", "--device", "cpu", "--kernels", "score_pairs_sharded",
                 "--json"])
    assert proc.returncode == 0, proc.stdout + proc.stderr
    report = json.loads(proc.stdout)
    assert report["clean"] and report["shard_kernels_audited"] == 1


def test_list_perf_kernels():
    proc = _run(["--list-perf-kernels"])
    assert proc.returncode == 0, proc.stderr
    assert "perf_baselines.json" in proc.stdout
    assert "jaro_winkler" in proc.stdout and "cuda adds x16384" in proc.stdout


def test_thread_audit_of_the_registry_exits_0():
    proc = _run(["--thread-audit", "--json"])
    assert proc.returncode == 0, proc.stdout + proc.stderr
    report = json.loads(proc.stdout)
    assert report["clean"] and report["thread_classes_audited"] == 19


def test_nl_rule_filter_picks_numlint_rules(tmp_path):
    # one NL001 hazard: an NL-only list naming another rule runs neither
    # torchlint nor NL001 (exit 0); naming NL001 finds it (exit 1)
    path = tmp_path / "raw_log.py"
    path.write_text("import torch\n\n\ndef f(m):\n    return torch.log(m)\n")
    proc = _run([str(path), "--rules", "NL002", "--json"])
    assert proc.returncode == 0, proc.stdout + proc.stderr
    proc = _run([str(path), "--rules", "JL004,NL001", "--json"])
    assert proc.returncode == 1, proc.stdout + proc.stderr
    assert {f["rule"] for f in json.loads(proc.stdout)["findings"]} == {"NL001"}
