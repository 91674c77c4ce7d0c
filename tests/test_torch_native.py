"""The native host library of splink_tpu_torch against its numpy plain
versions and against splink_tpu.

Every native function must equal its plain version array for array, in
order and dtype (the port's parity tests compare frames row for row, so
the emission order is part of the contract), and equal splink_tpu's
output on the fixtures of tests/test_native.py. The library builds into
the build directory at first use; a corrupt library file is rebuilt, and a
failed build raises: nothing falls back to numpy.
"""

import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from splink_tpu import blocking as ref_blocking  # noqa: E402
from splink_tpu import native as ref_native  # noqa: E402
from splink_tpu_torch import blocking, native  # noqa: E402
from splink_tpu_torch.ops import strings_cuda  # noqa: E402

WORDS = ["", "a", "john", "verylongvaluehere", "x" * 40]
IDX_DTYPES = [np.int32, np.int64]


def _flat(strs):
    flat = np.frombuffer("".join(strs).encode(), dtype=np.uint8)
    offsets = np.zeros(len(strs) + 1, np.int64)
    np.cumsum([len(s) for s in strs], out=offsets[1:])
    return flat, offsets


def _assert_same(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype, (g.dtype, w.dtype)
        np.testing.assert_array_equal(g, w)


def _groups(rng, n, n_codes, dtype):
    codes = rng.integers(-1, n_codes, n).astype(np.int64)
    rows = np.flatnonzero(codes >= 0).astype(dtype)
    rows_sorted, _, starts, sizes = blocking._sort_groups(codes, rows)
    return codes, rows_sorted, starts, sizes


@pytest.mark.parametrize("width", [1, 8, 16, 64])
def test_encode_fixed_width_equals_plain_and_reference(rng, width):
    strs = [WORDS[i] for i in rng.integers(0, len(WORDS), 200)]
    flat, offsets = _flat(strs)
    got = native.encode_fixed_width(flat, offsets, width)
    _assert_same(got, native.encode_fixed_width_plain(flat, offsets, width))
    _assert_same(got, ref_native.encode_fixed_width(flat, offsets, width))
    assert got[0].shape == (len(strs), width) and got[1].dtype == np.int32


def test_encode_fixed_width_rejects_bad_offsets():
    flat, offsets = _flat(["ab", "cd"])
    with pytest.raises(ValueError, match="offsets"):
        native.encode_fixed_width(flat, offsets + 1, 4)
    with pytest.raises(ValueError, match="offsets"):
        native.encode_fixed_width(flat, offsets[::-1].copy(), 4)


@pytest.mark.parametrize("dtype", IDX_DTYPES)
def test_self_join_equals_plain_in_order(rng, dtype):
    codes, rows_sorted, starts, sizes = _groups(rng, 500, 20, dtype)
    calls = native.calls["self_join_pairs"]
    got = native.self_join_pairs(rows_sorted, starts, sizes)
    assert native.calls["self_join_pairs"] == calls + 1
    _assert_same(got, native.self_join_pairs_plain(rows_sorted, starts, sizes))
    assert got[0].dtype == dtype
    # the counts: every group's triangle, and the library's own count
    want_n = int((sizes * (sizes - 1) // 2).sum())
    assert len(got[0]) == want_n
    assert native._load().count_self_pairs(
        native._ptr(np.ascontiguousarray(sizes, np.int64), native._i64p), len(sizes)
    ) == want_n
    # a span of groups that does not start at row 0
    _assert_same(native.self_join_pairs(rows_sorted, starts[5:9], sizes[5:9]),
                 native.self_join_pairs_plain(rows_sorted, starts[5:9], sizes[5:9]))


@pytest.mark.parametrize("dtype", IDX_DTYPES)
def test_self_join_equals_reference_native(rng, dtype):
    _, rows_sorted, starts, sizes = _groups(rng, 500, 20, dtype)
    want = ref_native.self_join_pairs(rows_sorted, starts, sizes)
    if want is None:
        pytest.skip("splink_tpu's native library is not built (no toolchain)")
    _assert_same(native.self_join_pairs(rows_sorted, starts, sizes), want)


@pytest.mark.parametrize("dtype", IDX_DTYPES)
def test_cross_join_equals_plain_and_reference(rng, dtype):
    codes = rng.integers(-1, 10, 300).astype(np.int64)
    left = np.arange(0, 150, dtype=dtype)
    right = np.arange(150, 300, dtype=dtype)
    lrows, lcodes, lstarts, lsizes = blocking._sort_groups(codes, left[codes[left] >= 0])
    rrows, rcodes, rstarts, rsizes = blocking._sort_groups(codes, right[codes[right] >= 0])
    _, li, ri = np.intersect1d(lcodes, rcodes, return_indices=True)
    args = (lrows, lstarts[li], lsizes[li], rrows, rstarts[ri], rsizes[ri])
    got = native.cross_join_pairs(*args)
    _assert_same(got, native.cross_join_pairs_plain(*args))
    assert got[0].dtype == dtype
    want_n = int((lsizes[li] * rsizes[ri]).sum())
    assert len(got[0]) == want_n
    # brute-force pair set, and splink_tpu's join in the same order
    want = {(int(a), int(b)) for a in left for b in right
            if codes[a] >= 0 and codes[a] == codes[b]}
    assert set(zip(got[0].tolist(), got[1].tolist())) == want
    ref = ref_blocking._cross_join(codes, left, right)
    np.testing.assert_array_equal(got[0], ref[0])
    np.testing.assert_array_equal(got[1], ref[1])


@pytest.mark.parametrize("chunk", [None, 1, 7, 50, 400])
@pytest.mark.parametrize("dtype", IDX_DTYPES)
def test_chunked_joins_equal_reference_chunk_for_chunk(rng, chunk, dtype):
    """Spans cut at the per-chunk cap (giant groups split by rows, wide
    rows by their b-range) emit the same arrays, in the same order, as
    splink_tpu's chunked joins."""
    codes = np.concatenate([rng.integers(-1, 6, 300), np.full(60, 9)]).astype(np.int64)
    rows = np.arange(len(codes))
    order = rng.permutation(len(codes)).astype(np.int32)
    got = list(blocking._iter_self_join_chunks(codes, order=order, chunk=chunk))
    want = list(ref_blocking._iter_self_join_chunks(codes, order=order, chunk=chunk))
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g[0], w[0])
        np.testing.assert_array_equal(g[1], w[1])
    left, right = rows[:150].astype(dtype), rows[150:].astype(dtype)
    got = list(blocking._iter_cross_join_chunks(codes, left, right, chunk=chunk))
    want = list(ref_blocking._iter_cross_join_chunks(codes, left, right, chunk=chunk))
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g[0], w[0])
        np.testing.assert_array_equal(g[1], w[1])


def test_library_builds_into_build_dir():
    path = native.library_path()
    assert os.path.dirname(path) == strings_cuda.build_dir()
    assert not path.startswith(os.path.dirname(native.__file__))
    assert os.path.exists(native.build())
    cmd = native.build_command("out.so")
    assert os.path.basename(cmd[0]) == "g++" and cmd[-1].endswith("host_kernels.cpp")


@pytest.fixture
def fresh_build(monkeypatch, tmp_path):
    """The library built anew into a temporary build directory."""
    monkeypatch.setenv("SPLINK_TPU_TORCH_BUILD_DIR", str(tmp_path))
    monkeypatch.setattr(native, "_lib", None)
    return tmp_path


def test_corrupt_library_is_rebuilt(fresh_build):
    path = native.build()
    assert path.startswith(str(fresh_build))
    with open(path, "wb") as fh:
        fh.write(b"not a shared object")
    flat, offsets = _flat(["ab", "abc"])
    got = native.encode_fixed_width(flat, offsets, 4)
    _assert_same(got, native.encode_fixed_width_plain(flat, offsets, 4))
    with open(path, "rb") as fh:
        assert fh.read(4) == b"\x7fELF"


def test_failed_build_raises(fresh_build, monkeypatch):
    monkeypatch.setattr(native, "CXX_FLAGS", [*native.CXX_FLAGS, "--no-such-flag"])
    flat, offsets = _flat(["ab"])
    with pytest.raises(RuntimeError, match="g\\+\\+ failed"):
        native.encode_fixed_width(flat, offsets, 4)
    assert not os.path.exists(native.library_path())
    assert not [f for f in os.listdir(fresh_build) if f.endswith(".tmp")]


def test_missing_compiler_raises(fresh_build, monkeypatch):
    monkeypatch.setattr(native.shutil, "which", lambda name: None)
    with pytest.raises(RuntimeError, match="g\\+\\+ not found"):
        native.self_join_pairs(np.arange(3), np.array([0]), np.array([3]))
