"""splink_tpu_torch.analysis.threadlint: the counterpart of the static half
of tests/test_threadlint.py.

The rule fixtures under ``tests/fixtures/threadlint/`` (pure ``threading``
code) give the same ``(rule, line)`` findings under the port's
``audit_source`` as under splink_tpu's; every bad twin fires exactly its
rule, every good twin is silent. The suppression and ``holds=`` machinery,
TL002's waits on the card, the lock graph and its artifact, the port's
registry (19 classes, clean and acyclic) and the KeyError on an unknown
class. The engine's TL001 repair: a swap keeps ``engine.device``.
"""

import json
import os

import pytest

pytest.importorskip("torch")

from splink_tpu_torch.analysis.threadlint import (  # noqa: E402
    THREAD_REGISTRY,
    TL_RULES,
    audit_source,
    graph_cycles,
    run_thread_audit,
    write_lock_graph,
)

FIXTURES = os.path.join(os.path.dirname(__file__), "fixtures", "threadlint")
FIXTURE_FILES = sorted(f for f in os.listdir(FIXTURES) if f.endswith(".py"))


def _fixture(name: str):
    path = os.path.join(FIXTURES, name)
    with open(path, encoding="utf-8") as fh:
        return path, fh.read()


def _rule_lines(findings):
    return sorted((f.rule, f.line) for f in findings)


# -- fixture twins ------------------------------------------------------


@pytest.mark.parametrize("name", FIXTURE_FILES)
def test_fixture_findings_equal_the_reference(name):
    from splink_tpu.analysis import threadlint as ref

    path, src = _fixture(name)
    got, got_graph = audit_source(path, src)
    want, want_graph = ref.audit_source(path, src)
    assert _rule_lines(got) == _rule_lines(want)
    assert got_graph == want_graph


def test_catalog_equals_the_reference():
    from splink_tpu.analysis import threadlint as ref

    assert sorted(TL_RULES) == sorted(ref.TL_RULES) == [f"TL00{i}" for i in range(1, 6)]
    for rule_id, (title, doc) in TL_RULES.items():
        assert title == ref.TL_RULES[rule_id][0] and doc


@pytest.mark.parametrize("rule", sorted(TL_RULES))
def test_bad_twin_fires_exactly_its_rule(rule):
    path, src = _fixture(f"{rule.lower()}_bad.py")
    findings, _ = audit_source(path, src)
    assert findings, f"{rule} bad twin produced no findings"
    assert {f.rule for f in findings} == {rule}


@pytest.mark.parametrize("rule", sorted(TL_RULES))
def test_good_twin_is_silent(rule):
    path, src = _fixture(f"{rule.lower()}_good.py")
    findings, _ = audit_source(path, src)
    assert findings == [], [f.format() for f in findings]


def test_suppressed_copy_is_silenced_not_the_original():
    # tl001_bad.py carries the same hazard twice: once bare, once with a
    # disable comment; exactly one finding survives
    path, src = _fixture("tl001_bad.py")
    findings, _ = audit_source(path, src)
    assert len(findings) == 1
    assert "disable" not in src.splitlines()[findings[0].line - 1]


# -- suppression machinery ---------------------------------------------

_MIXED = """\
import threading


class Mixed:
    def __init__(self):
        self._lock = threading.Lock()
        self._n = 0

    def a(self):
        with self._lock:
            self._n += 1

    def b(self):
        self._n += 1
"""


def test_suppress_line_above():
    src = _MIXED.replace(
        "    def b(self):\n        self._n += 1\n",
        "    def b(self):\n        # threadlint: disable=TL001 (test)\n        self._n += 1\n",
    )
    assert audit_source("x.py", src)[0] == []


@pytest.mark.parametrize("directive", ["TL001", "all"])
def test_suppress_file_level(directive):
    src = f"# threadlint: disable-file={directive}\n" + _MIXED
    assert audit_source("x.py", src)[0] == []


def test_wrong_rule_suppression_does_not_silence():
    src = _MIXED.replace(
        "    def b(self):\n        self._n += 1\n",
        "    def b(self):\n        self._n += 1  # threadlint: disable=TL002 (wrong rule)\n",
    )
    assert [f.rule for f in audit_source("x.py", src)[0]] == ["TL001"]


def test_holds_annotation_seeds_the_held_set():
    src = """\
import threading


class Helper:
    def __init__(self):
        self._lock = threading.Lock()
        self._n = 0

    def outer(self):
        with self._lock:
            self._n += 1
            self._locked_bump()

    # threadlint: holds=_lock
    def _locked_bump(self):
        self._n += 1
"""
    assert audit_source("x.py", src)[0] == []
    # without the annotation the same shape fires TL001
    bare = src.replace("    # threadlint: holds=_lock\n", "")
    assert [f.rule for f in audit_source("x.py", bare)[0]] == ["TL001"]


_CARD_WAITS = """\
import threading

import torch

from splink_tpu_torch.analysis import lockwatch


class Waiter:
    def __init__(self):
        self._lock = lockwatch.new_rlock("Waiter._lock")
        self.event = torch.cuda.Event()
        self.stream = torch.cuda.Stream()

    def all_waits(self):
        with self._lock:
            torch.cuda.synchronize()
            self.event.synchronize()
            self.stream.synchronize()

    def outside(self):
        torch.cuda.synchronize()
        with self._lock:
            pass
"""


def test_tl002_fires_on_the_waits_on_the_card():
    findings, graph = audit_source("x.py", _CARD_WAITS)
    assert _rule_lines(findings) == [("TL002", 16), ("TL002", 17), ("TL002", 18)]
    assert "torch.cuda.synchronize()" in findings[0].message
    assert graph["nodes"] == ["Waiter._lock"]


# -- lock graph ---------------------------------------------------------


def test_fixture_cycle_shows_in_graph_and_tl004():
    path, src = _fixture("tl004_bad.py")
    findings, graph = audit_source(path, src)
    assert [f.rule for f in findings] == ["TL004"]
    assert {"Tangled._a", "Tangled._b"} <= set(graph["nodes"])
    assert any({"Tangled._a", "Tangled._b"} <= set(c) for c in graph_cycles(graph))


def test_write_lock_graph_artifact(tmp_path):
    _, src = _fixture("tl004_bad.py")
    _, graph = audit_source("tl004_bad.py", src)
    out = tmp_path / "lock_order_graph.json"
    assert write_lock_graph(str(out), graph) == str(out)
    payload = json.loads(out.read_text())
    assert payload["nodes"] and payload["edges"]
    assert payload["cycles"], "the seeded cycle must land in the artifact"


# -- the registered fleet ----------------------------------------------


def test_registry_is_the_reference_registry_on_the_port():
    from splink_tpu.analysis import threadlint as ref

    assert len(THREAD_REGISTRY) == len(ref.THREAD_REGISTRY) == 19
    for spec, want in zip(THREAD_REGISTRY, ref.THREAD_REGISTRY):
        assert spec.cls == want.cls and spec.attr_types == want.attr_types
        assert spec.path == want.path.replace("splink_tpu/", "splink_tpu_torch/", 1)


def test_registry_audits_clean_and_acyclic():
    findings, audited, graph = run_thread_audit()
    assert audited == len(THREAD_REGISTRY) == 19
    assert not findings, "\n" + "\n".join(f.format() for f in findings)
    assert graph_cycles(graph) == []
    assert {"QueryEngine._swap_lock", "LinkageService._lock", "ReplicaRouter._lock"} <= set(
        graph["nodes"])


def test_unknown_class_raises_keyerror():
    with pytest.raises(KeyError, match="NoSuchClass"):
        run_thread_audit(classes=["NoSuchClass"])


def test_class_filter_narrows_the_audit():
    findings, audited, _ = run_thread_audit(classes=["SLOTracker", "QueryEngine"])
    assert audited == 2 and not findings


def test_root_points_the_audit_at_another_tree(tmp_path):
    # the registry's paths are read relative to ``root``: a copy of the
    # engine without probe_count's written reason fires TL001 there
    src_path = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                            "splink_tpu_torch", "serve", "engine.py")
    with open(src_path, encoding="utf-8") as fh:
        src = fh.read()
    reason = "  # threadlint: disable=TL001 (see docstring)"
    assert src.count("probes = self._probes" + reason) == 1
    dst = tmp_path / "splink_tpu_torch" / "serve"
    dst.mkdir(parents=True)
    (dst / "engine.py").write_text(src.replace("probes = self._probes" + reason,
                                               "probes = self._probes"))
    findings, audited, _ = run_thread_audit(classes=["QueryEngine"], root=str(tmp_path))
    assert audited == 1
    assert [f.rule for f in findings] == ["TL001"]
    assert "QueryEngine._probes" in findings[0].message


# -- the engine's repair: the device is write-once ----------------------


def test_swap_keeps_the_engine_device(tmp_path):
    import warnings

    import splink_tpu_torch
    from splink_tpu_torch.serve import QueryEngine, load_index

    settings = {
        "link_type": "dedupe_only",
        "comparison_columns": [
            {"col_name": "first_name", "num_levels": 3},
            {"col_name": "surname", "num_levels": 2, "comparison": {"kind": "exact"}},
        ],
        "blocking_rules": ["l.surname = r.surname"],
        "max_iterations": 3,
        "serve_query_buckets": [16],
        "serve_candidate_buckets": [64],
    }
    import pandas as pd

    df = pd.DataFrame({
        "unique_id": range(40),
        "first_name": [["ann", "anne", "bob", "rob"][i % 4] for i in range(40)],
        "surname": [["lee", "li", "ng"][i % 3] for i in range(40)],
    })
    linker = splink_tpu_torch.Splink(settings, df=df, device="cpu")
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        linker.estimate_parameters()
    linker.export_index(tmp_path / "idx")
    engine = QueryEngine(load_index(tmp_path / "idx", device="cpu"))
    engine.warmup()
    device = engine.device
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        stats = engine.swap_index(tmp_path / "idx")
    assert stats["generation"] == 1
    assert engine.device is device and engine.index.device == device
