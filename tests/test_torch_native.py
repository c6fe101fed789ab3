"""reductive_tpu_torch.native against reductive_tpu.native: the same files,
written by the JAX package's ``write_fvecs`` (and numpy for bvecs/ivecs),
read by both readers; every read, batch and error equal; ``pack_u4`` bytes
equal to the JAX package's and to ``ops.pack_u4_codes``; the library built at
first use into a hashed file name, by processes racing on an empty build
directory."""

import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

from reductive_tpu import native as jnative
from reductive_tpu_torch import native as tnative
from reductive_tpu_torch.ops import pack_u4_codes

ROOT = pathlib.Path(__file__).resolve().parent.parent


def _write_vecs(path, data):
    """A bvecs (uint8) or ivecs (int32) file: per row int32 dim, then the row."""
    n, dim = data.shape
    with open(path, "wb") as f:
        for row in data:
            f.write(np.int32(dim).tobytes())
            f.write(row.tobytes())


def make_file(tmp_path, kind, n=1003, dim=12, seed=0):
    rng = np.random.default_rng(seed)
    path = str(tmp_path / f"data.{kind}")
    if kind == "fvecs":
        data = rng.standard_normal((n, dim)).astype(np.float32)
        jnative.write_fvecs(path, data)
    elif kind == "bvecs":
        data = rng.integers(0, 256, (n, dim)).astype(np.uint8)
        _write_vecs(path, data)
    else:
        data = rng.integers(-(2**20), 2**20, (n, dim)).astype(np.int32)
        _write_vecs(path, data)
    return path, data.astype(np.float32)


def both(path, **kw):
    return tnative.VecsReader(path, **kw), jnative.VecsReader(path, **kw)


@pytest.fixture
def memmap_path(monkeypatch):
    """The port's readers and packing on the numpy path, as without g++."""
    monkeypatch.setattr(tnative, "_lib", None)
    monkeypatch.setattr(tnative, "_failed", True)


def test_native_builds_lazily_into_a_hashed_name():
    assert tnative.NATIVE_AVAILABLE
    path = tnative._library_path()
    assert path.parent == ROOT / "reductive_tpu_torch" / "_build"
    assert path.name.startswith("libvecio_") and path.exists()
    code = ("import sys, reductive_tpu_torch, reductive_tpu_torch.native as n\n"
            "assert n._lib is None and not n._failed\n")
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True,
                         timeout=120)
    assert res.returncode == 0, res.stderr


def test_two_processes_build_into_an_empty_directory_at_once(tmp_path):
    code = (
        "import sys, pathlib\n"
        "import reductive_tpu_torch.native as n\n"
        "n._BUILD = pathlib.Path(sys.argv[1])\n"
        "assert n.NATIVE_AVAILABLE\n"
        "print(n._library_path().name)\n"
    )
    build = tmp_path / "build"
    procs = [subprocess.Popen([sys.executable, "-c", code, str(build)], cwd=ROOT,
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
             for _ in range(2)]
    outs = [p.communicate(timeout=300) for p in procs]
    assert all(p.returncode == 0 for p in procs), [err for _, err in outs]
    names = {out.strip() for out, _ in outs}
    assert len(names) == 1
    assert sorted(q.name for q in build.iterdir()) == sorted(names)  # no temporary left


@pytest.mark.parametrize("kind", ["fvecs", "bvecs", "ivecs"])
def test_reader_reads_as_the_jax_packages(tmp_path, kind):
    path, data = make_file(tmp_path, kind)
    t, j = both(path)
    with t, j:
        assert (len(t), t.dim, t.kind) == (len(j), j.dim, j.kind) == (1003, 12, kind)
        np.testing.assert_array_equal(t.read(0, 1003), data)
        for start, count in ((0, 0), (37, 5), (1000, 3), (0, 1003)):
            np.testing.assert_array_equal(t.read(start, count), j.read(start, count))
        idx = np.array([5, 1002, 0, 5, 77])
        np.testing.assert_array_equal(t.read_rows(idx), j.read_rows(idx))
        np.testing.assert_array_equal(t.read_rows(idx), data[idx])


@pytest.mark.parametrize("start,stop", [(0, None), (10, 950), (999, None), (0, 5000)])
def test_batches_and_prefetch_as_the_jax_packages(tmp_path, start, stop):
    path, data = make_file(tmp_path, "fvecs")
    t, j = both(path)
    with t, j:
        want = [(off, b.copy()) for off, b in j.batches(128, start, stop)]
        end = data.shape[0] if stop is None else min(stop, data.shape[0])
        assert [off for off, _ in want] == list(range(start, end, 128))
        for got in (
            list(t.batches(128, start, stop)),
            list(t.prefetch_batches(128, start, stop)),
            list(t.prefetch_batches(128, start, stop, depth=2)),
            [(off, b.copy()) for off, b in t.prefetch_batches(128, start, stop, copy=False)],
            [(off, b.copy()) for off, b in t.prefetch_batches(128, start, stop, depth=2,
                                                                copy=False)],
        ):
            assert [off for off, _ in got] == [off for off, _ in want]
            for (_, a), (_, b) in zip(got, want):
                np.testing.assert_array_equal(a, b)
        if want:
            np.testing.assert_array_equal(np.concatenate([b for _, b in want]), data[start:end])


def test_errors_as_the_jax_packages(tmp_path):
    path, _ = make_file(tmp_path, "fvecs", n=10, dim=4)
    for mod in (tnative, jnative):
        with mod.VecsReader(path) as r:
            with pytest.raises(IndexError, match="out of bounds"):
                r.read(8, 3)
            with pytest.raises(IndexError, match="out of bounds"):
                r.read(-1, 1)
            with pytest.raises(IndexError, match="out of bounds for 10 rows"):
                r.read_rows([0, 10])
            with pytest.raises(ValueError, match="depth >= 2"):
                list(r.prefetch_batches(4, copy=False, depth=1))
        with pytest.raises(ValueError, match="unknown dataset kind 'xvecs'"):
            mod.VecsReader(path, kind="xvecs")
    truncated = tmp_path / "cut.fvecs"
    truncated.write_bytes(pathlib.Path(path).read_bytes()[:-3])
    for mod in (tnative, jnative):
        with pytest.raises(OSError):
            mod.VecsReader(str(truncated))
    with pytest.raises(ValueError, match="too small"):
        tnative.unpack_u4(np.zeros(2, np.uint8), 5)


@pytest.mark.parametrize("kind", ["fvecs", "bvecs"])
def test_memmap_path_reads_as_the_native_one(tmp_path, kind, memmap_path):
    path, data = make_file(tmp_path, kind)
    assert not tnative.NATIVE_AVAILABLE
    with tnative.VecsReader(path) as t, jnative.VecsReader(path) as j:
        assert t._handle is None and t._mm is not None
        np.testing.assert_array_equal(t.read(3, 500), j.read(3, 500))
        np.testing.assert_array_equal(t.read_rows([9, 2, 1002]), data[[9, 2, 1002]])
        got = [(off, b) for off, b in t.prefetch_batches(300, 5, copy=False)]
        assert [off for off, _ in got] == [5, 305, 605, 905]
        np.testing.assert_array_equal(np.concatenate([b for _, b in got]), data[5:])
    truncated = tmp_path / f"cut.{kind}"
    truncated.write_bytes(pathlib.Path(path).read_bytes()[:-1])
    with pytest.raises(OSError, match="truncated"):
        tnative.VecsReader(str(truncated))


def test_write_fvecs_appends_round_trip_through_both_readers(tmp_path):
    rng = np.random.default_rng(3)
    a = rng.standard_normal((70, 9)).astype(np.float32)
    b = rng.standard_normal((33, 9)).astype(np.float32)
    path = str(tmp_path / "x.fvecs")
    tnative.write_fvecs(path, a)
    tnative.write_fvecs(path, torch.from_numpy(b), append=True)
    jpath = str(tmp_path / "y.fvecs")
    jnative.write_fvecs(jpath, a)
    jnative.write_fvecs(jpath, b, append=True)
    assert pathlib.Path(path).read_bytes() == pathlib.Path(jpath).read_bytes()
    for mod in (tnative, jnative):
        with mod.VecsReader(path) as r:
            np.testing.assert_array_equal(r.read(0, 103), np.concatenate([a, b]))


@pytest.mark.parametrize("n", [0, 1, 10, 11, 4097])
def test_pack_u4_bytes_equal_the_jax_packages_and_ops_packing(n):
    codes = np.random.default_rng(n).integers(0, 16, n).astype(np.uint8)
    packed = tnative.pack_u4(codes)
    np.testing.assert_array_equal(packed, jnative.pack_u4(codes))
    assert packed.shape == ((n + 1) // 2,)
    if n % 2 == 0:
        ops_packed = pack_u4_codes(torch.from_numpy(codes.reshape(1, n) if n else codes[None]))
        np.testing.assert_array_equal(packed, ops_packed.numpy().ravel())
    if n % 2:  # the odd tail: the high nibble zero
        assert packed[-1] >> 4 == 0 and packed[-1] == codes[-1]
    np.testing.assert_array_equal(tnative.unpack_u4(packed, n), codes)
    np.testing.assert_array_equal(tnative.unpack_u4(packed, n), jnative.unpack_u4(packed, n))


def test_pack_u4_numpy_path_equals_the_native_one(memmap_path):
    codes = np.random.default_rng(7).integers(0, 16, 1001).astype(np.uint8)
    np.testing.assert_array_equal(tnative.pack_u4(codes), jnative.pack_u4(codes))
    np.testing.assert_array_equal(tnative.unpack_u4(jnative.pack_u4(codes), 1001), codes)
