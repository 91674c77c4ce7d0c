"""Tests of the benchmark harness: run them with
``python -m pytest linkbench/tests`` from the repository's root. Tests
that need a CUDA card carry the ``card`` marker and skip without one."""

import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[2]))


def pytest_configure(config):
    config.addinivalue_line("markers", "card: needs a CUDA card; skips without one")
