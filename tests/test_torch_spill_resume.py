"""Kill-and-resume of splink_tpu_torch's durable pair store (build_spill_dir).

A REAL SIGKILL (fault-plan kind=kill: no atexit, no finally blocks) lands
at ``emit_segment`` — after a segment's bytes are appended and fsynced,
before its manifest commit, the widest window a kill can tear — in a child
process that trains a job through ``build_spill_dir``. A fresh child
resumes over the same directory: both bins and the manifest's segment list
(offsets, counts, sha256, digests) must be byte-identical to an
uninterrupted build's, and the fitted parameters equal. The mesh-sharded
cases are the reference's (tests/test_spill_resume.py, driven by
tests/spill_build_worker.py): its job under ``{"data": 1}`` killed at
``emit_segment`` and under ``{"data": 8}`` killed at ``build_chunk`` in the
out-of-core index build; the resumed build's index fingerprint must be
bit-identical to an uninterrupted one's. The child is this file run as a
script (``python tests/test_torch_spill_resume.py <out.json> <build_dir>
[mesh_n]``); it imports nothing of JAX.
"""

import hashlib
import json
import os
import signal
import subprocess
import sys

import pytest

pytest.importorskip("torch")
pytest.importorskip("pandas")

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _child(out_path: str, build_dir: str) -> int:
    """Train a fixture job through build_spill_dir on the CPU and write what
    the parent compares: the bins' sha256, the manifest's segments, the
    pair count and the fitted parameters."""
    import numpy as np
    import pandas as pd
    import torch

    import splink_tpu_torch

    torch.set_num_threads(1)
    rng = np.random.default_rng(42)
    n = 2500
    firsts = np.array(["amelia", "oliver", "isla", "george", "ava", "noah"])
    lasts = np.array(["smith", "jones", "taylor", "brown", "wilson"])
    df = pd.DataFrame({
        "unique_id": np.arange(n),
        "first_name": firsts[rng.integers(0, 6, n)],
        "surname": lasts[rng.integers(0, 5, n)],
        "city": [f"c{i % 4}" for i in range(n)],
    })
    settings = {
        "link_type": "dedupe_only",
        "blocking_rules": ["l.city = r.city", "l.surname = r.surname"],
        "comparison_columns": [
            {"col_name": "first_name", "num_levels": 2, "comparison": {"kind": "exact"}},
            {"col_name": "surname", "num_levels": 2, "comparison": {"kind": "exact"}},
        ],
        "max_iterations": 3,
        "build_spill_dir": build_dir,
        "emit_shard_chunks": 4,
        "blocking_chunk_pairs": 65536,
        "device_pair_generation": "off",  # materialise through the store
        "max_resident_pairs": 65536,  # the pattern regime reads the store
    }
    linker = splink_tpu_torch.Splink(settings, df=df, device="cpu")
    linker.estimate_parameters()
    store = linker._pairs.spill_store
    pairs_dir = os.path.join(build_dir, "pairs")
    with open(os.path.join(pairs_dir, "pair_manifest.json")) as fh:
        manifest = json.load(fh)
    bins = {}
    for name in ("idx_l.bin", "idx_r.bin"):
        with open(os.path.join(pairs_dir, name), "rb") as fh:
            bins[name] = hashlib.sha256(fh.read()).hexdigest()
    with open(out_path, "w") as fh:
        json.dump({"bins": bins, "segments": manifest["segments"],
                   "n_pairs": int(linker._pairs.n_pairs), "completed": store.completed,
                   "params": linker.params.params}, fh)
    return 0


def _mesh_child(out_path: str, build_dir: str, mesh_n: int) -> int:
    """The reference worker's job (tests/spill_build_worker.py) on the CPU
    under ``{"data": mesh_n}``: emission into build_spill_dir, EM, and the
    out-of-core index build; writes the index fingerprint."""
    import numpy as np
    import pandas as pd
    import torch

    import splink_tpu_torch

    torch.set_num_threads(1)
    rng = np.random.default_rng(42)
    n = 2500  # > 2x build_spill_chunk_rows: the packed build commits chunk 1
    firsts = np.array(["amelia", "oliver", "isla", "george", "ava", "noah"])
    lasts = np.array(["smith", "jones", "taylor", "brown", "wilson"])
    df = pd.DataFrame({
        "unique_id": np.arange(n),
        "first_name": firsts[rng.integers(0, 6, n)],
        "surname": lasts[rng.integers(0, 5, n)],
        "city": [f"c{i % 4}" for i in range(n)],
    })
    settings = {
        "link_type": "dedupe_only",
        "blocking_rules": ["l.city = r.city", "l.surname = r.surname"],
        "comparison_columns": [
            {"col_name": "first_name", "num_levels": 2, "comparison": {"kind": "exact"}},
            {"col_name": "surname", "num_levels": 2, "comparison": {"kind": "exact"}},
        ],
        "max_iterations": 3,
        "build_spill_dir": build_dir,
        "build_spill_chunk_rows": 1024,
        "emit_shard_chunks": 4,
        "blocking_chunk_pairs": 65536,
        "device_pair_generation": "off",  # materialise through the store
        "mesh": {"data": mesh_n},
    }
    linker = splink_tpu_torch.Splink(settings, df=df, device="cpu")
    linker.estimate_parameters()
    index = linker.export_index()
    with open(out_path, "w") as fh:
        json.dump({"fingerprint": index.content_fingerprint(),
                   "n_pairs": int(linker._pairs.n_pairs),
                   "segments": len(linker._pairs.spill_store.segments)}, fh)
    return 0


def _run(tmp_path, tag, faults=None, build=None, mesh_n=None):
    out = str(tmp_path / f"{tag}.json")
    build = build or str(tmp_path / f"build_{tag}")
    env = {k: v for k, v in os.environ.items() if k not in ("SPLINK_TPU_FAULTS", "PYTHONPATH")}
    env["PYTHONPATH"] = ROOT
    if faults:
        env["SPLINK_TPU_FAULTS"] = faults
    args = [out, build] + ([str(mesh_n)] if mesh_n is not None else [])
    proc = subprocess.run([sys.executable, os.path.abspath(__file__), *args], cwd=ROOT,
                          env=env, capture_output=True, text=True, timeout=600)
    return proc, out, build


@pytest.fixture(scope="module")
def uninterrupted(tmp_path_factory):
    """The uninterrupted build's result, shared by the cases."""
    ref, ref_out, _ = _run(tmp_path_factory.mktemp("ref"), "ref")
    assert ref.returncode == 0, ref.stderr[-2000:]
    with open(ref_out) as fh:
        return json.load(fh)


@pytest.mark.parametrize("fault", [
    # the third segment of rule 0's first shard
    "emit_segment@rule=0:shard=0:seq=2:kind=kill",
    # the first segment of the second rule
    "emit_segment@rule=1:seq=0:kind=kill",
])
def test_killed_build_resumes_byte_identical(tmp_path, fault, uninterrupted):
    want = uninterrupted
    assert want["completed"] and len(want["segments"]) > 4

    killed, killed_out, build = _run(tmp_path, "killed", faults=fault)
    assert killed.returncode == -signal.SIGKILL, (killed.returncode, killed.stderr[-2000:])
    assert not os.path.exists(killed_out)
    with open(os.path.join(build, "pairs", "pair_manifest.json")) as fh:
        partial = json.load(fh)
    assert not partial["completed"] and 0 < len(partial["segments"]) < len(want["segments"])
    # the killed segment's bytes landed past the committed watermark
    committed = partial["segments"][-1]["offset"] + partial["segments"][-1]["pairs"]
    assert os.path.getsize(os.path.join(build, "pairs", "idx_l.bin")) > 4 * committed

    resumed, res_out, _ = _run(tmp_path, "resumed", build=build)
    assert resumed.returncode == 0, resumed.stderr[-2000:]
    with open(res_out) as fh:
        got = json.load(fh)
    assert got["bins"] == want["bins"]
    assert got["segments"] == want["segments"]
    assert got["n_pairs"] == want["n_pairs"] and got["completed"]
    assert got["params"] == want["params"]


@pytest.mark.parametrize("mesh_n,fault", [
    # between a spill segment's byte append and its manifest commit, on the
    # explicit one-device mesh
    (1, "emit_segment@seq=2:kind=kill"),
    # between an out-of-core packed chunk's append and its watermark commit,
    # with the emission sharded 8 wide
    (8, "build_chunk@chunk=1:kind=kill"),
])
def test_killed_mesh_build_resumes_bit_identical(tmp_path, mesh_n, fault):
    ref, ref_out, _ = _run(tmp_path, f"ref-{mesh_n}", mesh_n=mesh_n)
    assert ref.returncode == 0, ref.stderr[-2000:]
    with open(ref_out) as fh:
        want = json.load(fh)
    killed, _, build = _run(tmp_path, f"killed-{mesh_n}", faults=fault, mesh_n=mesh_n)
    assert killed.returncode == -signal.SIGKILL, (killed.returncode, killed.stderr[-2000:])
    assert os.path.isdir(build)
    resumed, res_out, _ = _run(tmp_path, f"resumed-{mesh_n}", build=build, mesh_n=mesh_n)
    assert resumed.returncode == 0, resumed.stderr[-2000:]
    with open(res_out) as fh:
        got = json.load(fh)
    assert got["fingerprint"] == want["fingerprint"], (
        "resumed build fingerprint diverged from the uninterrupted run")
    assert got["n_pairs"] == want["n_pairs"] and got["segments"] == want["segments"] > 0


if __name__ == "__main__":
    if len(sys.argv) > 3:
        sys.exit(_mesh_child(sys.argv[1], sys.argv[2], int(sys.argv[3])))
    sys.exit(_child(sys.argv[1], sys.argv[2]))
