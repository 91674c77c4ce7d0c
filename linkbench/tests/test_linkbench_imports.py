"""The harness loads nothing of JAX or the JAX package: top-level module
names are compared whole, so the port (``splink_tpu_torch``) passes and
the JAX package (``splink_tpu``) does not."""

import subprocess
import sys
from pathlib import Path

from linkbench import harness

REPO = Path(__file__).resolve().parents[2]


def test_forbidden_compares_whole_top_level_names(monkeypatch):
    for name in ("splink_tpu_torch", "splink_tpu_torch.ops", "jaxtyping", "flaxen"):
        monkeypatch.setitem(sys.modules, name, sys.modules["sys"])
    assert not (set(harness.forbidden_modules()) & {"splink_tpu_torch", "jaxtyping", "flaxen"})
    monkeypatch.setitem(sys.modules, "splink_tpu.linker", sys.modules["sys"])
    assert "splink_tpu" in harness.forbidden_modules()


def test_a_run_imports_no_jax():
    code = ("import sys; import linkbench.run, linkbench.harness, linkbench.readings, "
            "linkbench.tracing, linkbench.reference.check; import splink_tpu_torch; "
            "from linkbench import harness; "
            "[harness.metric_reader(m['name']) for m in harness.load_cell("
            "'people_train_resident').per_layer]; "
            "print(','.join(harness.forbidden_modules()))")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                         text=True, check=True)
    assert out.stdout.strip() == ""


def test_reference_imports_nothing_of_the_program():
    for path in (REPO / "linkbench" / "reference").glob("*.py"):
        text = path.read_text()
        for name in ("splink_tpu", "jax"):
            assert f"import {name}" not in text and f"from {name}" not in text, path


def test_no_result_without_the_program(tmp_path):
    """In a directory holding only BENCHMARK.json and the benchmark's files
    the run exits non-zero and prints no result."""
    import shutil

    shutil.copy(REPO / "BENCHMARK.json", tmp_path)
    shutil.copytree(REPO / "linkbench", tmp_path / "linkbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    out = subprocess.run([sys.executable, "-m", "linkbench.run", "--workload",
                          "people_train_virtual", "--seed", "1", "--seconds", "1"],
                         cwd=tmp_path, capture_output=True, text=True)
    assert out.returncode != 0
    assert '"correct"' not in out.stdout
