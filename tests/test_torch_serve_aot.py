"""The AOT library sidecar of splink_tpu_torch (serve/aot.py) against the
reference's contract (splink_tpu's tests/test_serve_aot.py).

The port's sidecar stores its kernel libraries, not XLA executables; on the
CPU the engine loads one, the native host library. The invalidation matrix
is the reference's: a missing sidecar is a plain cold start, and the
settings hash, the index fingerprint, the bucket menu, the fused flag, an
unreadable menu and the port's own environment keys (torch version, CPU
target) each reject the whole store with one ``serve_aot`` degradation
event, after which the engine answers as before. The binding holds the
reference's keys and values for the same artifact. In child processes with
an empty build directory: with no g++ reachable, the host library comes
from the sidecar (0 builds, answers equal to the parent's); a corrupt blob
gives exactly one ``corrupt_blob`` event and a build from sources; a
splink_tpu sidecar is refused with one event naming the mismatched keys,
and no blob of it is read.
"""

import json
import os
import subprocess
import sys
import warnings

import numpy as np
import pytest

torch = pytest.importorskip("torch")
pd = pytest.importorskip("pandas")

from splink_tpu_torch.obs import events  # noqa: E402
from splink_tpu_torch.serve import BucketPolicy, QueryEngine, load_index  # noqa: E402
from splink_tpu_torch.serve.aot import MENU_NAME, AotStore  # noqa: E402
from splink_tpu_torch.utils.logging_utils import DegradationWarning  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
POLICY = BucketPolicy((16,), (64, 128))
CHILD_TIMEOUT_S = 240


def people_df(n=120, seed=11):
    rng = np.random.default_rng(seed)
    firsts = ["amelia", "oliver", "isla", "george", "ava", "noah", "emily"]
    lasts = ["smith", "jones", "taylor", "brown", "wilson", "evans"]
    return pd.DataFrame({
        "unique_id": range(n),
        "first_name": [str(rng.choice(firsts)) for _ in range(n)],
        "surname": [str(rng.choice(lasts)) for _ in range(n)],
        "dob": [f"19{rng.integers(40, 99)}" for _ in range(n)],
    })


def serve_settings(**over):
    s = {
        "link_type": "dedupe_only",
        "comparison_columns": [
            {"col_name": "first_name", "num_levels": 3},
            {"col_name": "surname", "num_levels": 2, "comparison": {"kind": "exact"}},
        ],
        "blocking_rules": ["l.dob = r.dob", "l.surname = r.surname"],
        "max_iterations": 4,
    }
    s.update(over)
    return s


@pytest.fixture(scope="module")
def saved(tmp_path_factory):
    """(df, index_dir, aot_dir, answers): a port index exported on the CPU,
    its committed sidecar and the warm engine's answers for the frame."""
    import splink_tpu_torch

    df = people_df()
    linker = splink_tpu_torch.Splink(serve_settings(), df=df, device="cpu")
    linker.get_scored_comparisons()
    work = tmp_path_factory.mktemp("aot_index")
    index_dir = str(work / "idx")
    linker.export_index(index_dir)
    df.to_parquet(str(work / "queries.parquet"))
    aot_dir = os.path.join(index_dir, "aot")
    engine = _fresh_engine(index_dir, aot_dir)
    engine.warmup()
    engine.save_aot()
    return df, index_dir, aot_dir, engine.query_arrays(df)


def _fresh_engine(index_dir, aot_dir, **over):
    kw = dict(top_k=8, policy=POLICY, aot_dir=aot_dir)
    kw.update(over)
    return QueryEngine(load_index(index_dir, device="cpu"), **kw)


def _assert_equal_answers(expected, got):
    for name, e, g in zip(("p", "rows", "valid", "ncand"), expected, got):
        assert e.dtype == g.dtype and e.shape == g.shape, name
        assert np.array_equal(e, g), name


class _Sink:
    def __init__(self):
        self.degradations = []

    def emit(self, etype, **fields):
        if etype == "degradation" and fields.get("from") == "serve_aot":
            self.degradations.append(fields)


@pytest.fixture()
def sink():
    s = _Sink()
    events.register_ambient(s)
    yield s
    events.unregister_ambient(s)


def _edit_menu(aot_dir, mutate):
    path = os.path.join(aot_dir, MENU_NAME)
    with open(path, encoding="utf-8") as fh:
        menu = json.load(fh)
    mutate(menu)
    with open(path, "w", encoding="utf-8") as fh:
        json.dump(menu, fh)


@pytest.fixture()
def restore_menu(saved):
    path = os.path.join(saved[2], MENU_NAME)
    original = open(path, encoding="utf-8").read()
    yield
    with open(path, "w", encoding="utf-8") as fh:
        fh.write(original)


# ---------------------------------------------------------------------------
# The sidecar as written, and the binding against the reference
# ---------------------------------------------------------------------------


def test_sidecar_layout(saved):
    """Blobs under sha256-derived names, the menu committed with version,
    environment, binding and per-blob sha256 and bytes; on the CPU the one
    library is the host library and the CUDA half of the environment is
    absent."""
    _, _, aot_dir, _ = saved
    menu = json.load(open(os.path.join(aot_dir, MENU_NAME), encoding="utf-8"))
    assert menu["version"] == 1
    assert set(menu["libraries"]) == {"host"}
    entry = menu["libraries"]["host"]
    blob = open(os.path.join(aot_dir, entry["file"]), "rb").read()
    import hashlib

    assert entry["sha256"] == hashlib.sha256(blob).hexdigest()
    assert entry["bytes"] == len(blob)
    assert entry["file"] == f"lib-host-{entry['sha256'][:16]}.so"
    assert entry["library"].startswith("libsplink_host-")
    env = menu["environment"]
    assert env["torch"] == torch.__version__
    assert "cpu_target" in env and "host_library" in env
    assert "device_name" not in env and "capability" not in env
    assert "gxx" in menu["toolchain"]
    assert menu["binding"]["query_buckets"] == [16]
    assert menu["binding"]["candidate_buckets"] == [64, 128]


def test_save_sweeps_superseded_blobs(saved, tmp_path):
    """A blob the new menu does not name is swept after the commit."""
    df, index_dir, _, _ = saved
    out = tmp_path / "aot"
    out.mkdir()
    (out / "lib-host-0000000000000000.so").write_bytes(b"stale")
    eng = _fresh_engine(index_dir, str(out))
    eng.warmup()
    eng.save_aot()
    files = sorted(os.listdir(out))
    menu = json.load(open(out / MENU_NAME, encoding="utf-8"))
    assert files == sorted([MENU_NAME, menu["libraries"]["host"]["file"]])


def test_binding_equals_reference(saved):
    """For the same artifact and engine options, the port binds its sidecar
    to the reference's keys with the reference's values."""
    from splink_tpu.serve import BucketPolicy as RefPolicy
    from splink_tpu.serve import QueryEngine as RefEngine
    from splink_tpu.serve import load_index as ref_load

    _, index_dir, _, _ = saved
    for over in ({}, {"fused": False}, {"top_k": 4, "brownout_top_k": 2}):
        port = _fresh_engine(index_dir, None, **over)
        ref = RefEngine(ref_load(index_dir), policy=RefPolicy((16,), (64, 128)),
                        **dict({"top_k": 8}, **over))
        assert port._aot_binding() == ref._aot_binding()


def test_missing_sidecar_is_a_plain_cold_start(saved, tmp_path, sink):
    df, index_dir, _, answers = saved
    with warnings.catch_warnings():
        warnings.simplefilter("error", DegradationWarning)
        eng = _fresh_engine(index_dir, str(tmp_path / "nowhere"))
        warm = eng.warmup()
    assert warm["aot_restored"] == 0 and warm["compiles"] == 0
    assert sink.degradations == []
    _assert_equal_answers(answers, eng.query_arrays(df))


def test_loaded_library_is_not_replaced(saved, monkeypatch):
    """In a process that has its libraries loaded (and on disk) a valid
    sidecar has nothing to restore: no blob is read, nothing is counted."""
    df, index_dir, aot_dir, answers = saved
    reads = []
    monkeypatch.setattr(AotStore, "restore", lambda self, *a: reads.append(a))
    eng = _fresh_engine(index_dir, aot_dir)
    warm = eng.warmup()
    assert warm["aot_restored"] == 0 and warm["compiles"] == 0
    assert eng._aot_ready_store() is not None and reads == []
    _assert_equal_answers(answers, eng.query_arrays(df))


# ---------------------------------------------------------------------------
# Invalidation matrix: one serve_aot event, the engine serves as before
# ---------------------------------------------------------------------------


def _assert_rejected(saved, sink, match, **over):
    df, index_dir, aot_dir, answers = saved
    eng = _fresh_engine(index_dir, aot_dir, **over)
    with pytest.warns(DegradationWarning, match=match):
        warm = eng.warmup()
    assert warm["aot_restored"] == 0 and warm["compiles"] == 0
    assert len(sink.degradations) == 1, sink.degradations
    assert eng._aot_ready_store() is None
    got = eng.query_arrays(df)
    if not over:
        _assert_equal_answers(answers, got)
    return sink.degradations[0]


@pytest.mark.parametrize("key,value", [
    ("torch", "0.0.1"),
    ("cpu_target", "deadbeef"),
    ("host_library", "libsplink_host-000000000000.so"),
])
def test_environment_mismatch_invalidates_store(saved, sink, restore_menu, key, value):
    """A library built for another torch, another CPU or from other
    sources is machine code of unknown provenance: the store is rejected."""
    _edit_menu(saved[2], lambda m: m["environment"].__setitem__(key, value))
    ev = _assert_rejected(saved, sink, f"environment.{key}")
    assert ev["to"] == "stale"


@pytest.mark.parametrize("key,value", [
    ("index_state_hash", "0000000000000000"),
    ("index_fingerprint", "ff00"),
])
def test_binding_mismatch_invalidates_store(saved, sink, restore_menu, key, value):
    _edit_menu(saved[2], lambda m: m["binding"].__setitem__(key, value))
    _assert_rejected(saved, sink, key)


def test_stale_bucket_policy_invalidates_store(saved, sink):
    """A sidecar saved under one bucket menu does not serve another."""
    df, index_dir, _, answers = saved
    _assert_rejected(saved, sink, "candidate_buckets",
                     policy=BucketPolicy((16,), (64, 128, 256)))
    eng = _fresh_engine(index_dir, None, policy=BucketPolicy((16,), (64, 128, 256)))
    _assert_equal_answers(answers, eng.query_arrays(df))


def test_fused_flag_mismatch_invalidates_store(saved, sink):
    df, _, _, answers = saved
    _assert_rejected(saved, sink, "fused", fused=False)


def test_unreadable_menu_degrades(saved, sink, restore_menu):
    with open(os.path.join(saved[2], MENU_NAME), "w", encoding="utf-8") as fh:
        fh.write("{not json")
    ev = _assert_rejected(saved, sink, "unreadable")
    assert ev["to"] == "unreadable"


def test_every_mismatch_in_one_event(saved, sink, restore_menu):
    """Several mismatched keys are named together in ONE event."""
    def mutate(m):
        m["environment"]["torch"] = "0.0.1"
        m["binding"]["top_k"] = 99
        m["version"] = 7

    _edit_menu(saved[2], mutate)
    ev = _assert_rejected(saved, sink, "environment.torch")
    for key in ("format version", "environment.torch", "binding.top_k"):
        assert key in ev["reason"]


def test_save_requires_warm_engine(saved, tmp_path):
    _, index_dir, _, _ = saved
    eng = QueryEngine(load_index(index_dir, device="cpu"), top_k=8, policy=POLICY)
    with pytest.raises(RuntimeError, match="warmup"):
        eng.save_aot(str(tmp_path / "aot"))
    with pytest.raises(ValueError, match="sidecar"):
        eng.save_aot()


# ---------------------------------------------------------------------------
# Restore in a child process with an empty build directory
# ---------------------------------------------------------------------------

_CHILD = r"""
import json, sys, warnings
sys.path.insert(0, {repo!r})
import numpy as np, pandas as pd
from splink_tpu_torch.obs import events
from splink_tpu_torch.obs.metrics import compile_stats
from splink_tpu_torch.serve import BucketPolicy, QueryEngine, load_index

work, index_dir, aot_dir = sys.argv[1], sys.argv[2], sys.argv[3]


class Sink:
    def __init__(self):
        self.events = []

    def emit(self, etype, **fields):
        if etype == "degradation":
            self.events.append(fields)


sink = Sink()
events.register_ambient(sink)
df = pd.read_parquet(work + "/queries.parquet")
eng = QueryEngine(load_index(index_dir, device="cpu"), top_k=8,
                  policy=BucketPolicy((16,), (64, 128)), aot_dir=aot_dir)
with warnings.catch_warnings():
    warnings.simplefilter("ignore")
    warm = eng.warmup()
    p, r, v, nc = eng.query_arrays(df)
np.savez(work + "/child.npz", p=p, r=r, v=v, nc=nc)
print(json.dumps({{"warm": warm, "stats": compile_stats(), "events": sink.events}},
                 default=str))
"""


def _run_child(saved, tmp_path, aot_dir, *, compilers: bool):
    df, index_dir, _, _ = saved
    work = os.path.dirname(index_dir)
    script = tmp_path / "child.py"
    script.write_text(_CHILD.format(repo=REPO))
    build = tmp_path / "build"
    build.mkdir()
    env = dict(os.environ, SPLINK_TPU_TORCH_BUILD_DIR=str(build))
    if not compilers:
        empty = tmp_path / "nobin"
        empty.mkdir()
        env.update(PATH=str(empty), CUDA_HOME=str(empty))
    out = subprocess.run(
        [sys.executable, str(script), work, index_dir, aot_dir],
        env=env, capture_output=True, text=True, timeout=CHILD_TIMEOUT_S,
    )
    assert out.returncode == 0, out.stderr[-3000:]
    report = json.loads(out.stdout.strip().splitlines()[-1])
    got = np.load(os.path.join(work, "child.npz"))
    return report, tuple(got[k] for k in ("p", "r", "v", "nc")), sorted(os.listdir(build))


def test_child_restores_host_library_without_a_compiler(saved, tmp_path):
    """No g++ on PATH and an empty build directory: the host library comes
    from the sidecar, the child builds nothing and answers as the parent."""
    _, _, aot_dir, answers = saved
    report, got, built = _run_child(saved, tmp_path, aot_dir, compilers=False)
    assert report["warm"]["aot_restored"] == 1, report
    assert report["stats"]["compiles"] == 0 and report["stats"]["aot_restores"] == 1
    assert report["events"] == []
    assert len(built) == 1 and built[0].startswith("libsplink_host-")
    _assert_equal_answers(answers, got)


def test_child_without_sidecar_or_compiler_fails(saved, tmp_path):
    """The control: the same child with no sidecar needs g++ and fails."""
    with pytest.raises(AssertionError, match="g\\+\\+ not found"):
        _run_child(saved, tmp_path, str(tmp_path / "nowhere"), compilers=False)


def test_corrupt_blob_gives_one_event_and_a_build(saved, tmp_path):
    """One flipped byte: exactly one corrupt_blob event, the library builds
    from sources, the answers are unchanged."""
    import shutil

    _, _, aot_dir, answers = saved
    bad = tmp_path / "aot_bad"
    shutil.copytree(aot_dir, bad)
    menu = json.load(open(bad / MENU_NAME, encoding="utf-8"))
    victim = bad / menu["libraries"]["host"]["file"]
    blob = bytearray(victim.read_bytes())
    blob[len(blob) // 2] ^= 0x01
    victim.write_bytes(bytes(blob))
    report, got, built = _run_child(saved, tmp_path, str(bad), compilers=True)
    assert [e["to"] for e in report["events"]] == ["corrupt_blob"], report
    assert report["warm"]["aot_restored"] == 0
    assert report["stats"]["compiles"] == 1
    _assert_equal_answers(answers, got)


def test_reference_sidecar_is_refused(saved, tmp_path):
    """A sidecar splink_tpu wrote for the same artifact: one serve_aot
    event naming the mismatched keys, no blob read, the library built from
    sources, answers unchanged."""
    from splink_tpu.serve import BucketPolicy as RefPolicy
    from splink_tpu.serve import QueryEngine as RefEngine
    from splink_tpu.serve import load_index as ref_load

    _, index_dir, _, answers = saved
    ref_aot = str(tmp_path / "ref_aot")
    ref = RefEngine(ref_load(index_dir), top_k=8, policy=RefPolicy((16,), (64, 128)),
                    aot_dir=ref_aot)
    ref.warmup()
    ref.save_aot()
    assert any(f.startswith("exec-") for f in os.listdir(ref_aot))
    report, got, built = _run_child(saved, tmp_path, ref_aot, compilers=True)
    assert len(report["events"]) == 1, report
    ev = report["events"][0]
    assert ev["from"] == "serve_aot" and ev["to"] == "stale"
    for key in ("environment.torch", "environment.cpu_target",
                "environment.host_library"):
        assert key in ev["reason"]
    assert "binding." not in ev["reason"]  # the same artifact, the same menu
    assert report["warm"]["aot_restored"] == 0
    assert report["stats"]["compiles"] == 1
    _assert_equal_answers(answers, got)


def test_cli_build_aot_then_query_without_a_compiler(saved, tmp_path, capsys):
    """``build --aot`` commits <out>/aot; ``query`` in a fresh process with
    no g++ and an empty build directory restores it and answers as the
    in-process engine does."""
    import splink_tpu_torch
    from splink_tpu_torch.serve.__main__ import main

    df, _, _, _ = saved
    linker = splink_tpu_torch.Splink(serve_settings(), df=df, device="cpu")
    linker.estimate_parameters()
    model = tmp_path / "model.json"
    linker.save_model_as_json(str(model))
    ref_csv = tmp_path / "ref.parquet"
    df.to_parquet(str(ref_csv))
    out_dir = tmp_path / "idx"
    assert main(["build", "--model", str(model), "--data", str(ref_csv),
                 "--out", str(out_dir), "--aot", "--device", "cpu"]) == 0
    built = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert built["aot"]["libraries"] == 1
    assert os.path.exists(out_dir / "aot" / MENU_NAME)
    queries = tmp_path / "q.parquet"
    df.head(12).to_parquet(str(queries))
    assert main(["query", "--index", str(out_dir), "--data", str(queries),
                 "--device", "cpu"]) == 0
    local = capsys.readouterr().out.strip().splitlines()
    empty = tmp_path / "nobin"
    empty.mkdir()
    build = tmp_path / "build"
    env = dict(os.environ, SPLINK_TPU_TORCH_BUILD_DIR=str(build), PATH=str(empty),
               PYTHONPATH=REPO + os.pathsep + os.environ.get("PYTHONPATH", ""))
    out = subprocess.run(
        [sys.executable, "-m", "splink_tpu_torch.serve", "query", "--index",
         str(out_dir), "--data", str(queries), "--device", "cpu"],
        env=env, capture_output=True, text=True, timeout=CHILD_TIMEOUT_S,
    )
    assert out.returncode == 0, out.stderr[-3000:]
    assert out.stdout.strip().splitlines() == local
    assert [f.startswith("libsplink_host-") for f in os.listdir(build)] == [True]
