"""reductive_tpu_torch.data against reductive_tpu.data: the same corpus,
written by the JAX package's ``write_fvecs``, encoded by both streaming
pipelines (codes equal, uint8 and int32, with a projection, a tail batch and
start/stop); the resumable encode interrupted and resumed, idempotent,
restarted on a stale fingerprint, and resumed across the two packages (the
fingerprints equal); and SyntheticReader's reader protocol."""

import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from reductive_tpu import Pq as JPq
from reductive_tpu import data as jdata
from reductive_tpu.native import VecsReader as JReader
from reductive_tpu.native import write_fvecs
from reductive_tpu_torch import Pq, SyntheticReader
from reductive_tpu_torch import data as tdata
from reductive_tpu_torch.native import VecsReader
from torch_port_util import make_pq_data, orthonormal


def corpus(tmp_path, n=1000, m=4, k=16, ds=4, seed=0):
    cb, x = make_pq_data(seed, n, m, k, ds)
    path = str(tmp_path / "corpus.fvecs")
    write_fvecs(path, x)
    return cb, x, path


def models(cb, projection=None):
    t = Pq(codebooks=torch.from_numpy(cb),
           projection=None if projection is None else torch.from_numpy(projection))
    j = JPq(codebooks=jnp.asarray(cb), projection=None if projection is None else jnp.asarray(projection))
    return t, j


class Interrupted(RuntimeError):
    pass


class FailingReader:
    """A reader over the same file whose ``batches`` raises after ``after``
    batches: a job killed mid-stream."""

    def __init__(self, reader, after):
        self.reader, self.after = reader, after
        self.n, self.dim, self.path = reader.n, reader.dim, reader.path

    def batches(self, batch_size, start=0, stop=None):
        for i, item in enumerate(self.reader.batches(batch_size, start, stop)):
            if i == self.after:
                raise Interrupted("killed")
            yield item


@pytest.mark.parametrize("dtype", [torch.uint8, torch.int32])
@pytest.mark.parametrize("rotated", [False, True])
@pytest.mark.parametrize("start,stop,batch", [(0, None, 300), (7, 911, 128), (0, None, 1000)])
def test_stream_encode_equals_the_jax_packages(tmp_path, dtype, rotated, start, stop, batch):
    cb, x, path = corpus(tmp_path)
    tpq, jpq = models(cb, orthonormal(1, 16) if rotated else None)
    with VecsReader(path) as r, JReader(path) as jr:
        got = tdata.stream_encode(tpq, r, batch_size=batch, dtype=dtype, start=start, stop=stop)
        want = jdata.stream_encode(jpq, jr, batch_size=batch, dtype=np.dtype(str(dtype)[6:]),
                                   use_kernel=False, start=start, stop=stop)
    assert got.dtype == want.dtype == np.dtype(str(dtype)[6:])
    np.testing.assert_array_equal(got, want)
    end = x.shape[0] if stop is None else stop
    np.testing.assert_array_equal(got, tpq.quantize_batch(torch.from_numpy(x[start:end]),
                                                          dtype=dtype).numpy())


def test_stream_encode_batches_order_tail_and_in_flight(tmp_path):
    cb, x, _ = corpus(tmp_path, n=700)
    tpq, jpq = models(cb)
    batches = [(off, x[off:off + 256]) for off in range(0, 700, 256)]
    for in_flight in (0, 1, 2, 5):
        got = list(tdata.stream_encode_batches(tpq, iter(batches), batch_size=256,
                                               max_in_flight=in_flight))
        want = list(jdata.stream_encode_batches(jpq, iter(batches), batch_size=256,
                                                use_kernel=False, max_in_flight=in_flight))
        assert [off for off, _ in got] == [off for off, _ in want] == [0, 256, 512]
        assert [c.shape for _, c in got] == [(256, 4), (256, 4), (188, 4)]
        for (_, a), (_, b) in zip(got, want):
            np.testing.assert_array_equal(a, b)


def test_stream_encode_bf16_transfer(tmp_path):
    """The host rounds to bf16 (nearest even, as ml_dtypes does for the JAX
    package); the plain path then encodes the rounded rows, as the JAX
    package's einsum fallback does."""
    cb, x, path = corpus(tmp_path)
    tpq, jpq = models(cb)
    with VecsReader(path) as r, JReader(path) as jr:
        got = tdata.stream_encode(tpq, r, batch_size=300, transfer_dtype=torch.bfloat16)
        want = jdata.stream_encode(jpq, jr, batch_size=300, use_kernel=False,
                                   transfer_dtype=jnp.bfloat16)
    np.testing.assert_array_equal(got, want)
    rounded = torch.from_numpy(x).to(torch.bfloat16).to(torch.float32)
    np.testing.assert_array_equal(got, tpq.quantize_batch(rounded).numpy())


@pytest.mark.parametrize("rotated", [False, True])
def test_model_fingerprint_equals_the_jax_packages(tmp_path, rotated):
    cb, x, path = corpus(tmp_path, n=4000)  # past 8 KB: the interior windows too
    tpq, jpq = models(cb, orthonormal(2, 16) if rotated else None)
    with VecsReader(path) as r, JReader(path) as jr:
        for dtype, jdtype in ((torch.uint8, np.uint8), (torch.int32, np.int32)):
            assert (tdata._model_fingerprint(tpq, r, 512, dtype)
                    == jdata._model_fingerprint(jpq, jr, 512, jdtype))
        assert (tdata._model_fingerprint(tpq, r, 512, torch.uint8)
                != tdata._model_fingerprint(tpq, r, 256, torch.uint8))


def test_resumable_interrupted_then_resumed_equals_uninterrupted(tmp_path):
    cb, x, path = corpus(tmp_path, n=1000)
    tpq, _ = models(cb)
    full_path, out = str(tmp_path / "full.u8"), str(tmp_path / "codes.u8")
    with VecsReader(path) as r:
        full = np.array(tdata.stream_encode_resumable(tpq, r, full_path, batch_size=96))
        with pytest.raises(Interrupted):
            tdata.stream_encode_resumable(tpq, FailingReader(r, 5), out, batch_size=96,
                                          flush_every=2)
        # 5 batches read, 3 drained (2 stay in flight), progress at every 2nd.
        state = json.load(open(out + ".progress.json"))
        assert state["completed_rows"] == 2 * 96 and state["dtype"] == "uint8"
        resumed = np.array(tdata.stream_encode_resumable(tpq, r, out, batch_size=96))
        np.testing.assert_array_equal(resumed, full)
        np.testing.assert_array_equal(full, tpq.quantize_batch(torch.from_numpy(x)).numpy())
        assert json.load(open(out + ".progress.json"))["completed_rows"] == 1000

        # Idempotent: a third call encodes nothing (a reader that fails at
        # once would raise if it were read).
        again = tdata.stream_encode_resumable(tpq, FailingReader(r, 0), out, batch_size=96)
        assert isinstance(again, np.memmap) and again.mode == "r"
        np.testing.assert_array_equal(np.array(again), full)


def test_resumable_restarts_on_a_stale_fingerprint(tmp_path):
    cb, x, path = corpus(tmp_path, n=600)
    tpq, _ = models(cb)
    other, _ = models(cb + 1.0)
    out = str(tmp_path / "codes.u8")
    with VecsReader(path) as r:
        with pytest.raises(Interrupted):
            tdata.stream_encode_resumable(other, FailingReader(r, 3), out, batch_size=100,
                                          flush_every=1)
        assert json.load(open(out + ".progress.json"))["completed_rows"] == 100
        got = np.array(tdata.stream_encode_resumable(tpq, r, out, batch_size=100))
    np.testing.assert_array_equal(got, tpq.quantize_batch(torch.from_numpy(x)).numpy())
    # An unreadable sidecar restarts too.
    with open(out + ".progress.json", "w") as f:
        f.write("{not json")
    with VecsReader(path) as r:
        np.testing.assert_array_equal(
            np.array(tdata.stream_encode_resumable(tpq, r, out, batch_size=100)), got)


def test_a_sidecar_written_by_the_jax_package_resumes_in_the_port(tmp_path):
    cb, x, path = corpus(tmp_path, n=800)
    tpq, jpq = models(cb)
    out = str(tmp_path / "codes.u8")
    with JReader(path) as jr:
        with pytest.raises(Interrupted):
            jdata.stream_encode_resumable(jpq, FailingReader(jr, 4), out, batch_size=128,
                                          use_kernel=False, flush_every=2)
    before = os.path.getmtime(out)
    with VecsReader(path) as r:
        codes = np.array(tdata.stream_encode_resumable(tpq, FailingReader(r, 5), out,
                                                       batch_size=128))
    assert os.path.getmtime(out) >= before
    np.testing.assert_array_equal(codes, tpq.quantize_batch(torch.from_numpy(x)).numpy())


# -- SyntheticReader: the reader protocol, as tests/test_synthetic_reader.py --


def test_synthetic_rows_are_pure_functions_of_index():
    r = SyntheticReader(100, 8, seed=3, device="cpu")
    a = r.read(10, 5)
    assert a.shape == (5, 8) and a.dtype == torch.float32 and a.device.type == "cpu"
    assert torch.equal(a, r.read_rows(np.array([10, 11, 12, 13, 14])))
    assert torch.equal(r.read_rows(np.array([14, 10, 12])), a[[4, 0, 2]])
    assert torch.equal(r.read_rows(torch.tensor([99])), r.read(99, 1))
    assert torch.equal(SyntheticReader(100, 8, seed=3, device="cpu").read(10, 5), a)
    assert not torch.equal(SyntheticReader(100, 8, seed=4, device="cpu").read(10, 5), a)
    assert r.path is None and (r.n, r.dim) == (100, 8)


def test_synthetic_batches_match_read_and_handle_tail():
    r = SyntheticReader(70, 6, seed=1, device="cpu")
    got = list(r.batches(32))
    assert [off for off, _ in got] == [0, 32, 64]
    assert [b.shape[0] for _, b in got] == [32, 32, 6]
    full = torch.cat([b for _, b in got])
    assert torch.equal(full, r.read(0, 70))
    win = torch.cat([b for _, b in r.batches(32, start=10, stop=50)])
    assert torch.equal(win, full[10:50])


def test_synthetic_distribution_is_clustered():
    r = SyntheticReader(4096, 16, seed=0, n_centers=8, center_scale=4.0, device="cpu")
    x = r.read(0, 4096)
    assert bool(torch.isfinite(x).all())
    assert float(x.var()) > 2.0
    noise = x - r._centers[torch.cdist(x, r._centers).argmin(1)]
    assert abs(float(noise.std()) - 1.0) < 0.05  # unit noise around the nearest centre
    assert len(torch.unique(torch.cdist(x, r._centers).argmin(1))) == 8


def test_stream_encode_and_fingerprint_from_a_virtual_corpus(tmp_path):
    r1 = SyntheticReader(600, 16, seed=2, device="cpu")
    cb, _ = make_pq_data(5, 1, 4, 16, 4)
    tpq, _ = models(cb)
    codes = tdata.stream_encode(tpq, r1, batch_size=256)
    np.testing.assert_array_equal(codes, tpq.quantize_batch(r1.read(0, 600)).numpy())
    out = str(tmp_path / "codes.u8")
    c1 = np.array(tdata.stream_encode_resumable(tpq, r1, out, batch_size=256))
    r2 = SyntheticReader(600, 16, seed=3, device="cpu")
    c2 = np.array(tdata.stream_encode_resumable(tpq, r2, out, batch_size=256))
    np.testing.assert_array_equal(c2, tpq.quantize_batch(r2.read(0, 600)).numpy())
    assert not np.array_equal(c1, c2)


def test_synthetic_reader_needs_a_gpu_unless_asked_for_the_cpu():
    if torch.cuda.is_available():
        pytest.skip("this check is for a machine without a CUDA device")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        SyntheticReader(10, 4)
