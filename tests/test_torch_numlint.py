"""splink_tpu_torch.analysis.numlint: the counterpart of tests/test_numlint.py.

The fixtures under ``tests/fixtures/torch_numlint/`` are the torch twins of
splink_tpu's 16 (``tests/fixtures/numlint/``): for each rule a bad twin
with the hazard (as a ``torch.`` function and as a tensor method) plus a
suppressed copy, and a good twin with the same intent written safely. Each
bad twin fires exactly its rule in the port, as the reference's jnp twin
does in the reference; each good twin is silent. The device-code rules
(NL002, NL004, NL005, NL008) are told their twins' device functions, as
the package's modules are told theirs by ``torchlint.DEVICE_ROOTS``. Then
the guard, branch and suppression cases, the torch forms the reference
cannot see (a guard through ``.to()``, an integer ``cumprod``, a
``torch.logit`` with ``eps``), the package linting clean, and the CLI.
"""

import ast
import json
import os
import re

import pytest

pytest.importorskip("torch")

from splink_tpu_torch.analysis import NL_RULES, numlint_paths, numlint_source  # noqa: E402
from splink_tpu_torch.analysis.__main__ import main  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
FIXTURES = os.path.join(HERE, "fixtures", "torch_numlint")
REF_FIXTURES = os.path.join(HERE, "fixtures", "numlint")
PACKAGE = os.path.join(os.path.dirname(HERE), "splink_tpu_torch")
RULE_IDS = sorted(NL_RULES)
DEVICE_RULES = {"NL002", "NL004", "NL005", "NL008"}


def _fixture(rule_id: str, kind: str) -> str:
    return os.path.join(FIXTURES, f"{rule_id.lower()}_{kind}.py")


def _lint_fixture(rule_id: str, kind: str):
    path = _fixture(rule_id, kind)
    with open(path, encoding="utf-8") as fh:
        src = fh.read()
    roots = ()
    if rule_id in DEVICE_RULES:
        roots = tuple(n.name for n in ast.parse(src).body if isinstance(n, ast.FunctionDef))
    return numlint_source(path, src, roots=roots), src


def test_catalog_equals_the_reference():
    from splink_tpu.analysis.numlint import NL_RULES as REF

    assert RULE_IDS == sorted(REF) == [f"NL{i:03d}" for i in range(1, 9)]
    for title, doc in NL_RULES.values():
        assert title and doc


@pytest.mark.parametrize("rule_id", RULE_IDS)
def test_rule_fires_on_bad_twin_only(rule_id):
    findings, src = _lint_fixture(rule_id, "bad")
    own = [f for f in findings if f.rule == rule_id]
    assert len(own) >= 2, f"{rule_id}: {[f.format() for f in findings]}"
    suppressed = {i + 1 for i, line in enumerate(src.splitlines()) if "numlint: disable" in line}
    assert suppressed, f"the {rule_id} bad twin must hold a suppressed copy"
    assert not suppressed & {f.line for f in own}
    good, _ = _lint_fixture(rule_id, "good")
    assert not good, "; ".join(f.format() for f in good)


@pytest.mark.parametrize("rule_id", RULE_IDS)
def test_bad_twin_fires_no_foreign_rules_as_in_the_reference(rule_id):
    from splink_tpu.analysis.numlint import numlint_source as ref_numlint

    findings, _ = _lint_fixture(rule_id, "bad")
    assert {f.rule for f in findings} == {rule_id}
    ref_path = os.path.join(REF_FIXTURES, f"{rule_id.lower()}_bad.py")
    with open(ref_path, encoding="utf-8") as fh:
        assert {f.rule for f in ref_numlint(ref_path, fh.read())} == {rule_id}


def test_device_rules_need_device_code():
    # outside device code the device-only rules stay silent, as the
    # reference's do outside jit
    for rule_id in sorted(DEVICE_RULES):
        path = _fixture(rule_id, "bad")
        with open(path, encoding="utf-8") as fh:
            assert numlint_source(path, fh.read(), roots=()) == []


def test_name_dataflow_guard_recognised():
    # a guard applied at assignment time (not inside the log argument)
    source = (
        "import torch\n\n\n"
        "def f(x):\n"
        "    y = torch.clamp(x, min=torch.finfo(x.dtype).tiny)\n"
        "    return torch.log(y) + y.log()\n"
    )
    assert numlint_source("x.py", source) == []


def test_branch_guard_recognised():
    source = (
        "import torch\n\n\n"
        "def rate(good, total):\n"
        "    tot = torch.sum(total)\n"
        "    if tot <= 0:\n"
        "        return 0.0\n"
        "    return torch.sum(good) / tot\n"
    )
    assert numlint_source("x.py", source) == []


def test_guard_through_a_conversion_is_seen():
    # the race log of approx/minhash.py: u is floored by ``+ 0.5`` and seen
    # through a float64 conversion
    source = (
        "import torch\n\n\n"
        "def neg_log(hk):\n"
        "    u = (hk.to(torch.float32) + 0.5) * 2.0 ** -32\n"
        "    return (-torch.log(u.to(torch.float64))).to(torch.float32)\n"
    )
    assert numlint_source("x.py", source, roots=("neg_log",)) == []
    bare = source.replace(" + 0.5", "")
    assert [f.rule for f in numlint_source("x.py", bare, roots=("neg_log",))] == ["NL001"]


def test_integer_cumprod_is_silent():
    # the prefix run of ops/strings.py: a product of 0/1 flags in int64
    source = (
        "import torch\n\n\n"
        "def prefix(s1, s2, la, idx):\n"
        "    return torch.cumprod(((s1 == s2) & (idx[None, :] < la[:, None]))"
        ".to(torch.int64), dim=1)\n"
    )
    assert numlint_source("x.py", source, roots=("prefix",)) == []
    floats = source.replace("torch.int64", "torch.float32")
    assert [f.rule for f in numlint_source("x.py", floats, roots=("prefix",))] == ["NL004"]


def test_logger_log_is_not_a_log():
    source = (
        "import logging\n\nlogger = logging.getLogger(__name__)\n\n\n"
        "def f(p):\n"
        "    logger.log(logging.INFO, 'p=%s', p)\n"
    )
    assert numlint_source("x.py", source) == []


def test_file_level_suppression():
    source = "# numlint: disable-file=NL001\nimport torch\n\n\ndef f(x):\n    return torch.log(x)\n"
    assert numlint_source("x.py", source) == []
    assert numlint_source("x.py", source.split("\n", 1)[1])


def test_suppression_on_preceding_line():
    source = ("import torch\n\n\ndef f(x):\n"
              "    # numlint: disable=NL001 (test)\n    return torch.log(x)\n")
    assert numlint_source("x.py", source) == []


def test_unknown_rule_id_rejected():
    with pytest.raises(KeyError):
        numlint_paths([FIXTURES], rules=["NL999"])


def test_syntax_errors_left_to_torchlint(tmp_path):
    p = tmp_path / "broken.py"
    p.write_text("def f(:\n")
    report = numlint_paths([str(p)])
    assert report.files_checked == 1 and report.findings == []


def test_package_is_numlint_clean():
    report = numlint_paths([PACKAGE])
    assert report.files_checked >= 80
    assert report.clean, "\n" + "\n".join(f.format() for f in report.sorted())


def test_package_suppressions_carry_their_reason():
    ids = r"#\s*numlint:\s*disable=(?:NL\d{3}|all)(?:\s*,\s*(?:NL\d{3}|all))*"
    bare = []
    for root, _, files in os.walk(PACKAGE):
        for name in files:
            if name.endswith(".py"):
                with open(os.path.join(root, name), encoding="utf-8") as fh:
                    for i, line in enumerate(fh, 1):
                        m = re.search(ids, line)
                        if m and not re.match(r"\s*\(\S", line[m.end():]):
                            bare.append(f"{name}:{i}")
    assert not bare, bare


def test_cli_json_mode_on_bad_fixture(capsys):
    rc = main([_fixture("NL001", "bad"), "--json"])
    out = json.loads(capsys.readouterr().out)
    assert rc == 1 and out["clean"] is False and out["files_checked"] == 1
    assert {f["rule"] for f in out["findings"]} == {"NL001"}
    assert set(out["findings"][0]) >= {"rule", "path", "line", "message", "hint"}


def test_cli_exit_zero_on_clean_path(capsys):
    assert main([_fixture("NL001", "good")]) == 0
    assert "0 finding(s)" in capsys.readouterr().out


def test_cli_rule_filter_splits_engines(capsys):
    # an NL-only --rules list runs no torchlint rule and restricts numlint
    assert main([_fixture("NL001", "bad"), "--rules", "NL002"]) == 0
    # a JL-only list runs no numlint rule on the same fixture
    assert main([_fixture("NL001", "bad"), "--rules", "JL005"]) == 0
    capsys.readouterr()


def test_cli_mixed_rule_filter(capsys):
    rc = main([_fixture("NL001", "bad"), "--rules", "JL005,NL001"])
    assert rc == 1 and "NL001" in capsys.readouterr().out


def test_cli_list_rules_includes_nl_and_tl(capsys):
    assert main(["--list-rules"]) == 0
    out = capsys.readouterr().out
    for rule_id in [*RULE_IDS, "TL001", "TL005", "JL001"]:
        assert rule_id in out
