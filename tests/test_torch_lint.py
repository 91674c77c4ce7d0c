"""splink_tpu_torch.analysis.torchlint and its rules: the counterparts of
tests/test_jaxlint.py and of test_codebase_clean.py's lint gate.

Every kept rule fires on its bad twin, stays silent on the good twin and
on the bad twin's suppressed line; the suppression syntax; the CLI modes;
the package lints clean with every suppression's reason on its line; and
:data:`DEVICE_ROOTS` covers every kernel the trace audit's registry runs.
The twins are source strings below, written to ``tmp_path``. The rules
that read device code (JL001, JL003, JL005) are told the twin's device
entry function, ``step``, as the package's modules are told theirs by
``DEVICE_ROOTS``.
"""

import importlib
import json
import os
import re

import pytest

pytest.importorskip("torch")

from splink_tpu_torch.analysis import RULES, lint_paths, lint_source  # noqa: E402
from splink_tpu_torch.analysis.__main__ import main  # noqa: E402
from splink_tpu_torch.analysis.torchlint import DEVICE_ROOTS, ModuleLint  # noqa: E402

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PACKAGE = os.path.join(REPO_ROOT, "splink_tpu_torch")
RULE_IDS = sorted(RULES)
ROOTS = ("step",)

TWINS = {
    "JL001": (
        '''
import math

import numpy as np
import torch


def step(x):
    y = torch.exp(x)
    total = np.sum(y)
    mean = np.mean(y * 2)
    other = math.fsum(y)  # torchlint: disable=JL001 (the twin's suppressed copy)
    return total, mean, other
''',
        '''
import numpy as np
import torch


def step(x):
    y = torch.exp(x)
    n = np.prod(x.shape)  # a host fact, not a device value
    return torch.sum(y), n
''',
    ),
    "JL003": (
        '''
import numpy as np
import torch


def step(x, n: int):
    y = x * 2
    v = float(y.sum())
    w = y.item()
    h = np.asarray(y)
    c = torch.tensor([1.0, 2.0], dtype=torch.float32, device=x.device)
    z = y.cpu()  # torchlint: disable=JL003 (the twin's suppressed copy)
    return v, w, h, c, z
''',
        '''
import torch


def step(x, n: int):
    y = x * 2
    k = int(n)
    m = int(x.shape[0])
    c = torch.full((2,), 1.0, dtype=torch.float32, device=x.device)
    return y.sum(), k, m, c, len(x)


def host_report(t):
    return float(t.sum())  # host code: not a device function
''',
    ),
    "JL004": (
        '''
import numpy as np
import torch


def build(n):
    a = torch.zeros(8)
    b = torch.arange(n)
    c = torch.from_numpy(np.zeros(4))
    d = torch.tensor(3)
    e = torch.full((2,), 0.5)  # torchlint: disable=JL004 (the twin's suppressed copy)
    return a, b, c, d, e
''',
        '''
import numpy as np
import torch


def build(n, x):
    a = torch.zeros(8, dtype=torch.float32)
    b = torch.arange(n, dtype=torch.int32)
    c = torch.from_numpy(np.zeros(4, np.float32))
    d = torch.tensor(3, dtype=torch.int32)
    e = torch.zeros_like(x)
    f = torch.tensor(np.ones(3, np.int32))
    return a, b, c, d, e, f
''',
    ),
    "JL005": (
        '''
import torch


def step(x):
    y = x.to(torch.float64)
    z = x.double()
    w = x.to(torch.double)  # torchlint: disable=JL005 (the twin's suppressed copy)
    return y, z, w
''',
        '''
import numpy as np
import torch


def step(x, float64: bool):
    dtype = torch.float64 if float64 else torch.float32
    if x.dtype == torch.float64:
        x = x.to(torch.float32)
    return x.to(dtype)


def host_frame(values):
    return np.asarray(values, np.float64)  # host code: out of scope
''',
    ),
    "JL006": (
        '''
import torch

BUF = torch.zeros(4, dtype=torch.float32, device="cuda")
torch.cuda.synchronize()
N = torch.cuda.device_count()  # torchlint: disable=JL006 (the twin's suppressed copy)
''',
        '''
import torch

CPU_BUF = torch.zeros(4, dtype=torch.float32, device="cpu")


def buffer():
    torch.cuda.synchronize()
    return torch.zeros(4, dtype=torch.float32, device="cuda")
''',
    ),
    "JL009": (
        '''
import torch.distributed as dist

from splink_tpu_torch.parallel.distributed import all_sum_stats, process_index
from splink_tpu_torch.resilience.checkpoint import save_checkpoint


def reduce(stats):
    if dist.get_rank() == 0:
        stats = all_sum_stats(stats)
    return stats


def save(ckpt_dir, state):
    is_writer = process_index() == 0
    if not is_writer:
        return
    save_checkpoint(ckpt_dir, state)


def barrier_on_lead():
    if process_index() == 0:
        dist.barrier()  # torchlint: disable=JL009 (the twin's suppressed copy)
''',
        '''
import logging

import torch.distributed as dist

from splink_tpu_torch.parallel.distributed import all_sum_stats, process_index

logger = logging.getLogger(__name__)


def reduce(stats):
    stats = all_sum_stats(stats)
    if process_index() == 0:
        logger.info("reduced")  # per-process logging only
    dist.barrier()
    return stats
''',
    ),
    "JL010": (
        '''
import os
import time

import numpy as np
import torch
import torch.distributed as dist


def seeds():
    torch.manual_seed(dist.get_rank())
    rng = np.random.default_rng(os.getpid())
    g = torch.Generator()
    g.manual_seed(int(time.time()))  # torchlint: disable=JL010 (the twin's suppressed copy)
    return rng, g
''',
        '''
import numpy as np
import torch
import torch.distributed as dist


def seeds(seed: int):
    torch.manual_seed(seed)
    rank = dist.get_rank()
    rng = np.random.default_rng([seed, rank])
    g = torch.Generator()
    g.manual_seed(seed + rank)
    return rng, g
''',
    ),
    "JL011": (
        '''
import torch


def drive(batches):
    total = 0.0
    for b in batches:
        x = torch.as_tensor(b, dtype=torch.float32)
        s = x.sum()
        total += float(s)
        rows = x.tolist()
        last = s.item()  # torchlint: disable=JL011 (the twin's suppressed copy)
    return total, rows, last
''',
        '''
import torch


def drive(batches):
    total = torch.zeros((), dtype=torch.float32)
    for b in batches:
        x = torch.as_tensor(b, dtype=torch.float32)
        total = total + x.sum()
    return float(total)  # one read, after the loop
''',
    ),
    "JL012": (
        '''
from splink_tpu_torch.parallel.mesh import Mesh, make_mesh


def meshes(devices):
    a = Mesh(devices, "data")
    b = make_mesh(4, axis_name="data")
    c = make_mesh(2, "data")  # torchlint: disable=JL012 (the twin's suppressed copy)
    return a, b, c
''',
        '''
from splink_tpu_torch.parallel.mesh import DATA_AXIS, Mesh, make_mesh


def meshes(devices):
    return Mesh(devices, DATA_AXIS), make_mesh(4, axis_name=DATA_AXIS)
''',
    ),
}


def _write(tmp_path, name, source):
    path = tmp_path / name
    path.write_text(source)
    return str(path)


def _lint_file(path):
    with open(path) as fh:
        return lint_source(path, fh.read(), roots=ROOTS)


def test_rule_catalog_complete():
    # the kept hazard classes, each with title + doc for the CLI; JL002,
    # JL007 and JL008 have no counterpart and their ids are not reused
    assert RULE_IDS == ["JL001", "JL003", "JL004", "JL005", "JL006",
                        "JL009", "JL010", "JL011", "JL012"]
    assert set(TWINS) == set(RULE_IDS)
    for spec in RULES.values():
        assert spec.title and spec.doc


@pytest.mark.parametrize("rule_id", RULE_IDS)
def test_rule_fires_on_bad_twin_only(tmp_path, rule_id):
    bad_src, good_src = TWINS[rule_id]
    bad = _write(tmp_path, f"{rule_id.lower()}_bad.py", bad_src)
    good = _write(tmp_path, f"{rule_id.lower()}_good.py", good_src)

    bad_findings = [f for f in _lint_file(bad) if f.rule == rule_id]
    assert bad_findings, f"{rule_id} did not fire on its bad twin"
    assert len({f.line for f in bad_findings}) >= 2, bad_findings

    # the suppressed copy inside the bad twin stays silent
    suppressed = {i + 1 for i, line in enumerate(bad_src.splitlines())
                  if "torchlint: disable" in line}
    assert suppressed, "the bad twin must contain a suppressed violation"
    # ...and only because of the suppression
    bare = re.sub(r"#\s*torchlint:.*", "", bad_src)
    unsuppressed = lint_source(bad, bare, roots=ROOTS)
    assert suppressed <= {f.line for f in unsuppressed if f.rule == rule_id}
    hit = suppressed & {f.line for f in bad_findings}
    assert not hit, f"{rule_id} fired on suppressed line(s) {sorted(hit)}"

    good_findings = _lint_file(good)
    assert not good_findings, "; ".join(f.format() for f in good_findings)


def test_bad_twins_fail_the_gate(tmp_path):
    # falsifiability: the bad twins together trip every kept rule
    fired = set()
    for rule_id, (bad_src, _) in TWINS.items():
        fired |= {f.rule for f in lint_source(
            _write(tmp_path, f"{rule_id}.py", bad_src), bad_src, roots=ROOTS)}
    assert fired >= set(RULE_IDS)


def test_jl009_derived_names_are_scope_local():
    # a name derived from the rank in one function must not poison an
    # unrelated function reusing the same name
    source = (
        "import torch.distributed as dist\n"
        "from splink_tpu_torch.parallel.distributed import all_sum_stats\n"
        "\n"
        "\n"
        "def a():\n"
        "    lead = dist.get_rank() == 0\n"
        "    return lead\n"
        "\n"
        "\n"
        "def b(cfg, x):\n"
        "    lead = cfg.is_primary\n"
        "    if lead:\n"
        "        return all_sum_stats(x)\n"
        "    return x\n"
    )
    assert lint_source("x.py", source) == []


def test_jl009_closure_derived_name_still_fires():
    # ...but a closure reading the OUTER function's derived name (the em.py
    # single-writer shape) is still caught
    source = (
        "from splink_tpu_torch.parallel.distributed import process_index\n"
        "from splink_tpu_torch.resilience.checkpoint import save_checkpoint\n"
        "\n"
        "\n"
        "def outer(ckpt_dir, state):\n"
        "    is_writer = process_index() == 0\n"
        "\n"
        "    def save():\n"
        "        if not is_writer:\n"
        "            return\n"
        "        save_checkpoint(ckpt_dir, state)\n"
        "\n"
        "    return save\n"
    )
    assert [f.rule for f in lint_source("x.py", source)] == ["JL009"]


def test_file_level_suppression():
    source = (
        "# torchlint: disable-file=JL004\n"
        "import torch\n"
        "\n"
        "\n"
        "def build():\n"
        "    return torch.arange(8)\n"
    )
    assert lint_source("x.py", source) == []
    # without the pragma the same source is a finding
    assert lint_source("x.py", source.split("\n", 1)[1])


def test_suppression_on_preceding_line():
    source = (
        "import torch\n"
        "\n"
        "\n"
        "def build():\n"
        "    # torchlint: disable=JL004 (a test of the syntax)\n"
        "    return torch.arange(8)\n"
    )
    assert lint_source("x.py", source) == []
    # the reference's prefix does not suppress the port's rules
    assert lint_source("x.py", source.replace("torchlint:", "jaxlint:"))


def test_unknown_rule_id_rejected(tmp_path):
    with pytest.raises(KeyError):
        lint_paths([str(tmp_path)], rules=["JL999"])
    with pytest.raises(KeyError):  # JL002 has no counterpart in the port
        lint_paths([str(tmp_path)], rules=["JL002"])


def test_syntax_error_is_a_finding(tmp_path):
    p = tmp_path / "broken.py"
    p.write_text("def f(:\n")
    report = lint_paths([str(p)])
    assert [f.rule for f in report.findings] == ["JL000"]


def test_unparseable_files_are_findings_not_crashes(tmp_path):
    # the gate must report, not abort, on files ast/utf-8 cannot take
    (tmp_path / "nullbyte.py").write_bytes(b"x = 1\x00\n")
    (tmp_path / "latin1.py").write_bytes("s = 'caf\xe9'\n".encode("latin-1"))
    report = lint_paths([str(tmp_path)])
    assert report.files_checked == 2
    assert sorted(f.rule for f in report.findings) == ["JL000", "JL000"]


def test_cli_json_mode_on_bad_twin(tmp_path, capsys):
    bad = _write(tmp_path, "jl004_bad.py", TWINS["JL004"][0])
    rc = main([bad, "--json"])
    out = json.loads(capsys.readouterr().out)
    assert rc == 1
    assert out["clean"] is False
    assert out["files_checked"] == 1
    assert {f["rule"] for f in out["findings"]} == {"JL004"}
    assert set(out["findings"][0]) >= {"rule", "path", "line", "message", "hint"}


def test_cli_exit_zero_on_clean_path(tmp_path, capsys):
    rc = main([_write(tmp_path, "jl004_good.py", TWINS["JL004"][1])])
    assert rc == 0
    assert "0 finding(s)" in capsys.readouterr().out


def test_cli_rule_filter(tmp_path, capsys):
    # restricting to JL006 silences the JL004 findings in the bad twin
    rc = main([_write(tmp_path, "jl004_bad.py", TWINS["JL004"][0]), "--rules", "JL006"])
    assert rc == 0
    capsys.readouterr()


def test_cli_list_rules(capsys):
    assert main(["--list-rules"]) == 0
    out = capsys.readouterr().out
    for rule_id in RULE_IDS:
        assert rule_id in out


def test_cli_usage_error_without_paths(capsys):
    assert main([]) == 2
    capsys.readouterr()


# ---------------------------------------------------------------------------
# the package itself
# ---------------------------------------------------------------------------


def test_package_lints_clean():
    report = lint_paths([PACKAGE])
    assert report.files_checked > 40  # the whole package, not a subdir
    assert report.clean, "\n" + "\n".join(f.format() for f in report.sorted())


def test_every_suppression_carries_its_reason():
    # each line suppression names its rule and gives its reason on the
    # line; no module silences a rule file-wide
    seen = 0
    for root, _dirs, files in os.walk(PACKAGE):
        for name in files:
            # the engine and its rules document the syntax
            if not name.endswith(".py") or root.endswith(os.path.join("analysis", "rules")) \
                    or name == "torchlint.py":
                continue
            with open(os.path.join(root, name)) as fh:
                for line in fh:
                    if "torchlint:" not in line or "torchlint: disable" not in line:
                        continue
                    assert "disable-file" not in line, (name, line)
                    m = re.search(r"torchlint: disable=(JL\d{3}(?:,JL\d{3})*) \((.+)\)", line)
                    assert m and len(m.group(2)) > 8, (name, line)
                    seen += 1
    assert seen > 0


# The trace-audit kernel -> the device entry function it drives, by module
# (relative to the package) and qualname.
KERNEL_ENTRIES = {
    "em_step": ("em.py", "run_em"),
    "em_step_checkpointed": ("em.py", "run_em_checkpointed"),
    "em_step_telemetry": ("em.py", "run_em"),
    "streamed_pass": ("parallel/streaming.py", "_batch_stats"),
    "score_pairs": ("em.py", "score_pairs"),
    "gamma_batch": ("gammas.py", "GammaProgram.gamma_batch"),
    "pattern_kernel": ("gammas.py", "GammaProgram.pattern_ids"),
    "virtual_pattern_kernel": ("pairgen.py", "make_virtual_pattern_fn"),
    "jaro_winkler": ("ops/strings.py", "jaro_winkler"),
    "levenshtein": ("ops/strings.py", "levenshtein_ratio"),
    "tf_adjustment": ("term_frequencies.py", "token_stats"),
    "tf_gather": ("term_frequencies.py", "token_gather"),
    "serve_encode_query": ("serve/engine.py", "encode_query"),
    "serve_candidate_gather": ("serve/engine.py", "candidate_gather"),
    "serve_score_topk": ("serve/engine.py", "score_topk"),
    "serve_score_fused": ("serve/engine.py", "score_fused"),
    "serve_score_fused_tf": ("serve/engine.py", "score_fused"),
    "serve_score_topk_brownout": ("serve/engine.py", "score_topk"),
    "block_segment_sort": ("blocking_device.py", "segment_sort"),
    "block_bucket_csr": ("blocking_device.py", "build_bucket_csr"),
    "block_pair_emit": ("blocking_device.py", "_emit_chunk"),
    "spill_chunk_digest": ("blocking_device.py", "chunk_digest"),
    "spill_chunk_digest_compact": ("blocking_device.py", "chunk_digest_compact"),
    "approx_minhash": ("approx/minhash.py", "minhash_signatures"),
    "approx_minhash_weighted": ("approx/minhash.py", "minhash_signatures"),
    "approx_verify": ("approx/lsh.py", "verify_pairs"),
    "approx_verify_weighted": ("approx/lsh.py", "verify_pairs"),
    "quality_profile": ("obs/quality.py", "make_profile_fn"),
    "serve_drift_sketch": ("obs/drift.py", "make_sketch_fn"),
}


def test_device_roots_cover_the_trace_audit_registry():
    from splink_tpu_torch.analysis.trace_audit import REGISTRY, _ensure_default_registry

    _ensure_default_registry()
    assert set(KERNEL_ENTRIES) == set(REGISTRY)
    roots = set(DEVICE_ROOTS)
    for kernel, entry in KERNEL_ENTRIES.items():
        assert entry in roots, (kernel, entry)
    # every root names a real function, and the engine marks it device code
    # in its module
    for module, qualname in DEVICE_ROOTS:
        obj = importlib.import_module("splink_tpu_torch." + module[:-3].replace("/", "."))
        for part in qualname.split("."):
            obj = getattr(obj, part)
        assert callable(obj), (module, qualname)
        path = os.path.join(PACKAGE, module)
        with open(path) as fh:
            mod = ModuleLint(path, fh.read())
        assert any(i.qualname == qualname and i.params_traced for i in mod.fns.values())
    # the host side of a module stays out of the device scope
    path = os.path.join(PACKAGE, "em.py")
    with open(path) as fh:
        mod = ModuleLint(path, fh.read())
    traced = {i.qualname for i in mod.fns.values() if i.traced}
    assert "run_em" in traced and "trimmed_trajectory" not in traced
