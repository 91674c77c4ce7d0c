"""The serving index of splink_tpu_torch (serve/index.py) against splink_tpu's.

Both packages load one model JSON (trained by splink_tpu) over one frame
and export an index: the packed matrix, every rule's CSR arrays,
``string_meta``, the TF tables and token ids, ``content_fingerprint``, the
saved meta and its ``arrays_sha256`` are equal, and each package loads the
other's artifact. Torn and tampered artifacts are rejected and saving over
an index is crash-safe. The device-CSR build equals the host one; the
out-of-core build (``build_spill_dir``) equals the in-core one, and a build
killed at ``build_chunk`` in a child process (this file run as a script)
and resumed is bit-identical. Options not ported raise NotImplementedError
naming their ROADMAP.md item.
"""

import hashlib
import json
import os
import shutil
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")
pd = pytest.importorskip("pandas")

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def people_df(n=160, seed=11):
    rng = np.random.default_rng(seed)
    firsts = np.array(["amelia", "oliver", "isla", "george", "ava", "noah",
                       "emily", "émile", None], object)
    lasts = np.array(["smith"] * 6 + ["jones", "taylor", "zorn", "brown", None], object)
    cities = np.array(["london", "leeds", "luton", "lincoln", None], object)
    return pd.DataFrame({
        "unique_id": np.arange(n),
        "first_name": firsts[rng.integers(0, len(firsts), n)],
        "surname": lasts[rng.integers(0, len(lasts), n)],
        "city": cities[rng.integers(0, len(cities), n)],
        "dob": [f"19{rng.integers(40, 60)}" for _ in range(n)],
        "age": rng.integers(20, 30, n).astype(float),
    })


def index_settings(**over):
    s = {
        "link_type": "dedupe_only",
        "comparison_columns": [
            {"col_name": "first_name", "num_levels": 3,
             "term_frequency_adjustments": True},
            {"col_name": "surname", "num_levels": 2,
             "comparison": {"kind": "exact"}, "term_frequency_adjustments": True},
            {"col_name": "city", "num_levels": 3,
             "comparison": {"kind": "levenshtein", "thresholds": [0.3, 0.6]}},
            {"col_name": "age", "num_levels": 3, "data_type": "numeric",
             "comparison": {"kind": "numeric_abs", "thresholds": [0.5, 3.0]}},
        ],
        "blocking_rules": ["l.dob = r.dob",
                           "l.surname = r.surname and substr(l.city,1,2) = substr(r.city,1,2)"],
        "max_iterations": 4,
    }
    s.update(over)
    return s


@pytest.fixture(scope="module")
def model_json(tmp_path_factory):
    """A model trained by splink_tpu, saved once for the module, and the
    same parameters with ``float64`` on."""
    import splink_tpu

    d = tmp_path_factory.mktemp("model")
    linker = splink_tpu.Splink(index_settings(), df=people_df())
    linker.estimate_parameters()
    out = {"float32": str(d / "float32.json"), "float64": str(d / "float64.json")}
    linker.save_model_as_json(out["float32"])
    with open(out["float32"]) as fh:
        model = json.load(fh)
    model["settings"]["float64"] = True
    with open(out["float64"], "w") as fh:
        json.dump(model, fh)
    return out


def _both(model_json, dtype, df=None, **over):
    import splink_tpu
    import splink_tpu_torch

    df = people_df() if df is None else df
    path = model_json[dtype]
    ref = splink_tpu.load_from_json(path, df=df)
    port = splink_tpu_torch.load_from_json(path, df=df, device="cpu")
    for linker in (ref, port):
        linker.settings.update(over)
    return ref, port


def _meta(path):
    with open(os.path.join(path, "linkage_index.json")) as fh:
        return json.load(fh)


def _assert_same_index(a, b):
    assert np.array_equal(np.asarray(a.packed), np.asarray(b.packed))
    assert a.packed.dtype == b.packed.dtype == np.uint32
    assert len(a.rules) == len(b.rules)
    for ra, rb in zip(a.rules, b.rules):
        assert ra.rule == rb.rule and ra.key_cols == rb.key_cols
        assert ra.bucket_of == rb.bucket_of
        for name in ("rows_sorted", "starts", "sizes", "row_bucket"):
            x, y = np.asarray(getattr(ra, name)), np.asarray(getattr(rb, name))
            assert x.dtype == y.dtype == np.int32, name
            assert np.array_equal(x, y), name
    assert a.string_cols == b.string_cols and a.numeric_cols == b.numeric_cols
    assert a.string_meta == b.string_meta
    assert sorted(a.tf_tables) == sorted(b.tf_tables)
    for name in a.tf_tables:
        assert np.array_equal(a.tf_tables[name], b.tf_tables[name])
        assert np.array_equal(a.tf_tids[name], b.tf_tids[name])
    assert a.dtype == b.dtype and a.lam == b.lam
    assert np.array_equal(a.m, b.m) and np.array_equal(a.u, b.u)
    assert np.array_equal(np.asarray(a.unique_id), np.asarray(b.unique_id))
    assert a.state_hash == b.state_hash
    assert a.content_fingerprint() == b.content_fingerprint()


@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_index_equal_across_packages(model_json, dtype, tmp_path):
    ref, port = _both(model_json, dtype)
    a = ref.export_index(tmp_path / "ref")
    b = port.export_index(tmp_path / "port")
    _assert_same_index(a, b)
    assert b.tf_tids, "the TF fold columns ride in the artifact"
    ma, mb = _meta(tmp_path / "ref"), _meta(tmp_path / "port")
    assert ma == mb  # arrays_sha256, state hash, vocabularies, settings
    assert "export_index" in port.stage_seconds


@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_each_package_loads_the_others_artifact(model_json, dtype, tmp_path):
    from splink_tpu.serve import load_index as ref_load

    from splink_tpu_torch.serve import load_index

    ref, port = _both(model_json, dtype)
    a = ref.export_index(tmp_path / "ref")
    b = port.export_index(tmp_path / "port")
    from_ref = load_index(tmp_path / "ref", device="cpu")
    _assert_same_index(a, from_ref)
    assert from_ref.layout.keys() == b.layout.keys()
    if dtype == "float32":
        _assert_same_index(ref_load(tmp_path / "port"), b)
    else:
        # the reference rebuilds the lane layout from zero rows, where a
        # float64 numeric column counts one lane, not two: it refuses a
        # float64 index with a numeric column, its own as well as the port's
        from splink_tpu.serve import IndexMismatchError

        for d in ("ref", "port"):
            with pytest.raises(IndexMismatchError, match="lanes"):
                ref_load(tmp_path / d)


def test_encode_queries_equal_across_packages(model_json):
    """Unseen values take fresh ids past the vocabulary, nulls stay null,
    wide characters keep their codepoints: the packed query rows, buckets
    and TF token ids equal the reference's."""
    ref, port = _both(model_json, "float32")
    a, b = ref.export_index(), port.export_index()
    q = people_df(40, seed=5)
    q.loc[0, "first_name"] = "zzyzx"
    q.loc[1, ["first_name", "surname", "dob"]] = None
    q.loc[2, "city"] = "łódź"
    q.loc[3, "age"] = None
    qa, qb = a.encode_queries(q), b.encode_queries(q)
    assert np.array_equal(qa.packed, qb.packed)
    assert np.array_equal(qa.qbuckets, qb.qbuckets)
    assert np.array_equal(qa.tf_tids, qb.tf_tids)
    assert qb.tf_tids[0, 0] >= len(b.string_meta["first_name"]["vocab"])
    assert qb.tf_tids[0, 1] == -1 and (qb.qbuckets[:, 1] == -1).all()


def test_torn_and_tampered_artifacts_rejected(model_json, tmp_path):
    from splink_tpu_torch.serve import (
        IndexMismatchError,
        ServeIndexError,
        load_index,
    )

    _, port = _both(model_json, "float32")
    path = tmp_path / "idx"
    port.export_index(path)
    meta = _meta(path)

    def variant(name, edit_meta=None, edit_arrays=None):
        d = tmp_path / name
        shutil.copytree(path, d)
        if edit_meta is not None:
            m = json.loads((d / "linkage_index.json").read_text())
            edit_meta(m)
            (d / "linkage_index.json").write_text(json.dumps(m))
        if edit_arrays is not None:
            p = d / meta["arrays_file"]
            p.write_bytes(edit_arrays(p.read_bytes()))
        return d

    def flip(payload):
        b = bytearray(payload)
        b[len(b) // 2] ^= 0xFF
        return bytes(b)

    cases = [
        (variant("rows", edit_meta=lambda m: m.update(n_rows=m["n_rows"] + 1)),
         IndexMismatchError),
        (variant("version", edit_meta=lambda m: m.update(version=99)), IndexMismatchError),
        (variant("flip", edit_arrays=flip), IndexMismatchError),
        (variant("torn", edit_arrays=lambda p: p[: len(p) // 2]), IndexMismatchError),
        (variant("name", edit_meta=lambda m: m.update(arrays_file="../x.npz")),
         ServeIndexError),
    ]
    gone = variant("gone")
    os.unlink(gone / meta["arrays_file"])
    cases.append((gone, ServeIndexError))
    cut = variant("cut")
    (cut / "linkage_index.json").write_text(
        (path / "linkage_index.json").read_text()[:40])
    cases.append((cut, ServeIndexError))
    for d, err in cases:
        with pytest.raises(err):
            load_index(d, device="cpu")
    load_index(path, device="cpu")  # the original still loads


def test_save_over_existing_index_is_crash_safe(model_json, tmp_path):
    from splink_tpu_torch.serve import load_index

    _, port = _both(model_json, "float32")
    path = tmp_path / "idx"
    port.export_index(path)
    meta1 = _meta(path)
    # the crash window: new arrays written, meta not yet committed
    (path / "linkage_index-deadbeefdeadbeef.npz").write_bytes(b"garbage")
    assert load_index(path, device="cpu").n_rows == meta1["n_rows"]
    port.export_index(path)
    leftovers = [p.name for p in path.iterdir() if p.suffix == ".npz"]
    assert leftovers == [_meta(path)["arrays_file"]]
    load_index(path, device="cpu")


@pytest.mark.parametrize("rule", [
    "l.dob = r.dob",
    "l.surname = r.surname and substr(l.city,1,2) = substr(r.city,1,2)",
    "l.first_name = r.first_name and l.age = r.age",
])
def test_device_csr_equals_host_csr(model_json, rule):
    """The bucket CSR built by the device tier (here on the CPU device)
    equals the host argsort's, array for array, and the reference's."""
    from splink_tpu.serve.index import _build_serve_rule as ref_rule

    from splink_tpu_torch.serve.index import _build_serve_rule

    ref, port = _both(model_json, "float32")
    table = port._ensure_encoded()
    on = _build_serve_rule(table, rule, device="cpu")
    off = _build_serve_rule(table, rule, device=None)
    want = ref_rule(ref._ensure_encoded(), rule, device=False)
    for r in (on, want):
        for name in ("rows_sorted", "starts", "sizes", "row_bucket"):
            x, y = getattr(off, name), np.asarray(getattr(r, name))
            assert x.dtype == y.dtype and np.array_equal(x, y), name
        assert off.bucket_of == r.bucket_of


def test_device_blocking_setting_keeps_the_fingerprint(model_json):
    _, port = _both(model_json, "float32")
    fps = set()
    for mode in ("on", "off", "auto"):
        port.settings["device_blocking"] = mode
        fps.add(port.export_index().content_fingerprint())
    assert len(fps) == 1


def test_all_null_rule_takes_the_dummy_csr(model_json):
    from splink_tpu_torch.serve.index import _build_serve_rule

    _, port = _both(model_json, "float32")
    df = people_df()
    df["nothing"] = None
    table = port._ensure_encoded()
    table.raw["nothing"] = df["nothing"].to_numpy(object)
    r = _build_serve_rule(table, "l.nothing = r.nothing", device="cpu")
    assert r.bucket_of == {} and len(r.rows_sorted) == 1
    assert (r.row_bucket == -1).all()


@pytest.mark.parametrize("chunk_rows", [1, 37, 1 << 20])
def test_out_of_core_build_equals_in_core(model_json, tmp_path, chunk_rows):
    from splink_tpu_torch.serve import load_index

    _, port = _both(model_json, "float32")
    in_core = port.export_index()
    port.settings.update(build_spill_dir=str(tmp_path / "build"),
                         build_spill_chunk_rows=chunk_rows)
    ooc = port.export_index(tmp_path / "idx")
    assert isinstance(ooc.packed, np.memmap)
    assert np.array_equal(np.asarray(ooc.packed), in_core.packed)
    assert ooc.content_fingerprint() == in_core.content_fingerprint()
    loaded = load_index(tmp_path / "idx", device="cpu")
    assert loaded.content_fingerprint() == in_core.content_fingerprint()
    # a second build over the finished state reuses every chunk
    again = port.export_index()
    assert again.content_fingerprint() == in_core.content_fingerprint()


def test_out_of_core_build_discards_a_short_file(model_json, tmp_path):
    _, port = _both(model_json, "float32")
    in_core = port.export_index()
    build = tmp_path / "build"
    port.settings.update(build_spill_dir=str(build), build_spill_chunk_rows=16)
    port.export_index()
    data = build / "index_build" / "packed.bin"
    data.write_bytes(data.read_bytes()[:100])  # shorter than the watermark
    assert port.export_index().content_fingerprint() == in_core.content_fingerprint()


def _child(out_path: str, build_dir: str, model_path: str) -> int:
    """Export an index through build_spill_dir on the CPU (the fault plan
    comes from the environment) and write its fingerprint and the packed
    file's sha256."""
    import logging

    import splink_tpu_torch

    logging.basicConfig(level=logging.INFO)  # the resume line goes to stderr
    torch.set_num_threads(1)
    linker = splink_tpu_torch.load_from_json(model_path, df=people_df(), device="cpu")
    linker.settings.update(build_spill_dir=build_dir, build_spill_chunk_rows=16)
    index = linker.export_index()
    with open(os.path.join(build_dir, "index_build", "packed.bin"), "rb") as fh:
        digest = hashlib.sha256(fh.read()).hexdigest()
    with open(out_path, "w") as fh:
        json.dump({"fp": index.content_fingerprint(), "packed": digest}, fh)
    return 0


def _run_child(out, build, model, plan=""):
    env = dict(os.environ, SPLINK_TPU_FAULTS=plan,
               PYTHONPATH=ROOT + os.pathsep + os.environ.get("PYTHONPATH", ""))
    return subprocess.run(
        [sys.executable, os.path.abspath(__file__), str(out), str(build), model],
        env=env, capture_output=True, text=True, timeout=300,
    )


def test_killed_out_of_core_build_resumes_bit_identical(model_json, tmp_path):
    model = model_json["float32"]
    _, port = _both(model_json, "float32")
    in_core = port.export_index()
    killed = _run_child(tmp_path / "b.json", tmp_path / "b", model,
                        "build_chunk@chunk=4:kind=kill")
    assert killed.returncode == -9, killed.stderr
    state = json.loads((tmp_path / "b" / "index_build" / "build_state.json").read_text())
    assert state["chunks_done"] == 4
    resumed = _run_child(tmp_path / "b.json", tmp_path / "b", model)
    assert resumed.returncode == 0, resumed.stderr
    assert "resumed" in resumed.stderr
    b = json.loads((tmp_path / "b.json").read_text())
    assert b == {"fp": in_core.content_fingerprint(),
                 "packed": hashlib.sha256(in_core.packed.tobytes()).hexdigest()}


def test_unported_index_options_raise(model_json, tmp_path):
    """``quality_profile`` is ported (it raised before): a linker holding no
    training gammas builds a profile-less index with the reference's
    warning; a scored one captures the profile, which ``save`` writes and
    ``load_index`` restores array for array, outside the content
    fingerprint."""
    from splink_tpu_torch.serve import load_index

    _, port = _both(model_json, "float32")
    port.settings["quality_profile"] = True
    with pytest.warns(UserWarning, match="no training gammas"):
        assert port.export_index().profile is None
    port.manually_apply_fellegi_sunter_weights()
    path = tmp_path / "idx"
    index = port.export_index(path)
    assert index.profile is not None
    assert index.profile.n_pairs == len(port._G)
    assert _meta(path)["profile"]["n_pairs"] == len(port._G)
    loaded = load_index(path, device="cpu")
    for name in ("gamma_hist", "score_hist", "gamma_hist_matched", "score_hist_matched"):
        np.testing.assert_array_equal(getattr(loaded.profile, name),
                                      getattr(index.profile, name))
    assert loaded.profile.to_meta() == index.profile.to_meta()
    fp = index.content_fingerprint()
    assert loaded.content_fingerprint() == fp
    index.profile, index._content_fp = None, None
    assert index.content_fingerprint() == fp


def test_unsupported_blocking_rules_rejected(model_json):
    from splink_tpu_torch.serve import build_index

    _, port = _both(model_json, "float32")
    for rule, match in (
        ("l.dob = r.dob and l.unique_id + 1 < r.unique_id", "residual"),
        ("l.dob = r.surname", "across different columns"),
    ):
        port.settings["blocking_rules"] = [rule]
        with pytest.raises(ValueError, match=match):
            build_index(port)
    port.settings["blocking_rules"] = []
    with pytest.raises(ValueError, match="blocking rule"):
        build_index(port)


def test_key_code_cache_released_after_build(model_json):
    from splink_tpu_torch.serve import build_index

    _, port = _both(model_json, "float32")
    table = port._ensure_encoded()
    for _ in range(2):
        build_index(port)
        assert not getattr(table, "_key_code_cache", None)


def test_load_index_runs_on_cuda_unless_told(model_json, tmp_path):
    """With no device an index loads onto cuda, and raises without one."""
    from splink_tpu_torch.serve import load_index

    _, port = _both(model_json, "float32")
    port.export_index(tmp_path / "idx")
    if torch.cuda.is_available():
        assert load_index(tmp_path / "idx").device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="CUDA"):
            load_index(tmp_path / "idx")
    index = load_index(tmp_path / "idx", device="cpu")
    state = index.device_state()
    assert state["packed"].device.type == "cpu"
    assert state["packed"].dtype == torch.int32
    assert np.array_equal(state["packed"].numpy().view(np.uint32), index.packed)


if __name__ == "__main__":
    sys.exit(_child(*sys.argv[1:4]))
