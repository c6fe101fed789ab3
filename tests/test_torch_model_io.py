"""The slice as a whole: codebooks made with numpy -> ``from_jax_params`` ->
quantize -> reconstruct -> search, against the JAX ``Pq`` on the same arrays
(CPU), the preallocated-output entries, and artifacts crossing between the
two packages."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from reductive_tpu import io as jio
from reductive_tpu.ops import pq_encode as j_pq_encode
from reductive_tpu.pq.model import Pq as JPq
from reductive_tpu.search import search as j_search
from reductive_tpu_torch import IvfPq, Pq, convert
from reductive_tpu_torch import io as tio
from reductive_tpu_torch.pq import (
    quantize_batch_into, quantize_vector_into, reconstruct_batch_into, reconstruct_into,
)
from reductive_tpu_torch.search import search

from torch_port_util import assert_codes_near_optimal, j, make_pq_data, orthonormal, t

SHAPE = (800, 4, 16, 8)  # n, m, k, ds


def _models(projection, seed=81, shape=SHAPE):
    n, m, k, ds = shape
    cb, x = make_pq_data(seed, n, m, k, ds)
    proj = orthonormal(seed + 1, m * ds) if projection else None
    jpq = JPq(codebooks=j(cb), projection=None if proj is None else j(proj))
    tpq = convert.from_jax_params(
        np.asarray(jpq.codebooks), None if proj is None else np.asarray(jpq.projection),
        device="cpu")
    return jpq, tpq, cb, proj, x


@pytest.mark.parametrize("projection", [False, True])
def test_slice_round_trip_matches_jax(projection):
    jpq, tpq, cb, proj, x = _models(projection)
    xr = x if proj is None else x @ proj  # what the encoder sees, for distance checks

    jcodes = np.asarray(jpq.quantize_batch(j(x)))
    tcodes = tpq.quantize_batch(t(x))
    assert tcodes.dtype == torch.uint8
    assert_codes_near_optimal(cb, xr, tcodes.numpy(), jcodes, min_equal=0.999, rel_tol=1e-5)

    # The JAX model's kernel methods take no interpret argument; call its
    # kernel directly on the rotated input, as the model would.
    jx = j(x) if proj is None else jnp.dot(j(x), j(proj), precision="highest")
    jk = np.asarray(j_pq_encode(jpq.codebooks, jx, compute_dtype=jnp.float32, interpret=True))
    tk = tpq.quantize_batch(t(x), method="kernel-f32")
    assert_codes_near_optimal(cb, xr, tk.numpy(), jk, min_equal=0.999, rel_tol=2.0 ** -13)
    tb = tpq.quantize_batch(t(x), method="kernel")
    assert_codes_near_optimal(cb, xr, tb.numpy(), jcodes, min_equal=0.99, rel_tol=2.0 ** -7)

    # Decode the same codes in both packages.
    jrec = np.asarray(jpq.reconstruct_batch(j(jcodes)))
    for method in ("auto", "gather", "onehot", "kernel"):
        trec = tpq.reconstruct_batch(t(jcodes), method=method)
        if proj is None:
            np.testing.assert_array_equal(trec.numpy(), jrec)  # bit-equal
        else:  # one more f32 product, summed in another order
            np.testing.assert_allclose(trec.numpy(), jrec, rtol=1e-5, atol=1e-5)
    fast = tpq.reconstruct_batch(t(jcodes), method="kernel-fast")
    int8 = tpq.reconstruct_batch(t(jcodes), method="kernel-int8")
    np.testing.assert_allclose(fast.numpy(), jrec, rtol=2e-2, atol=2e-2)
    np.testing.assert_allclose(int8.numpy(), jrec, rtol=5e-2, atol=5e-2)

    # Search over the same codes.
    jd, ji = j_search(jpq, j(x[:8]), j(jcodes), 5)
    td, ti = search(tpq, t(x[:8]), t(jcodes), 5)
    np.testing.assert_allclose(td.numpy(), np.asarray(jd), rtol=1e-5, atol=1e-4)
    np.testing.assert_array_equal(ti[:, 0].numpy(), np.asarray(ji)[:, 0])


@pytest.mark.parametrize("projection", [False, True])
def test_single_vector_entries_match_jax(projection):
    jpq, tpq, _, _, x = _models(projection)
    code = tpq.quantize_vector(t(x[3]))
    np.testing.assert_array_equal(code.numpy(), np.asarray(jpq.quantize_vector(j(x[3]))))
    rec = tpq.reconstruct(code)
    np.testing.assert_allclose(
        rec.numpy(), np.asarray(jpq.reconstruct(j(code.numpy()))), rtol=1e-5, atol=1e-6)


def test_accessors_and_validation_match_jax():
    jpq, tpq, cb, _, _ = _models(True)
    for name in ("n_subquantizers", "n_quantizer_centroids", "quantized_len", "reconstructed_len"):
        assert getattr(tpq, name) == getattr(jpq, name)
    assert tpq.subquantizers is tpq.codebooks

    def message(fn):
        with pytest.raises(ValueError) as err:
            fn()
        return str(err.value)

    bad = [
        (lambda: JPq(codebooks=jnp.zeros((2, 3))), lambda: Pq(codebooks=torch.zeros((2, 3)))),
        (lambda: JPq(codebooks=jnp.zeros((0, 3, 4))), lambda: Pq(codebooks=torch.zeros((0, 3, 4)))),
        (lambda: JPq(codebooks=j(cb), projection=jnp.zeros((5, 5))),
         lambda: Pq(codebooks=t(cb), projection=torch.zeros((5, 5)))),
        (lambda: jpq.quantize_batch(jnp.zeros((2, 32)), method="nope"),
         lambda: tpq.quantize_batch(torch.zeros((2, 32)), method="nope")),
        (lambda: jpq.reconstruct_batch(jnp.zeros((2, 4), jnp.uint8), method="nope"),
         lambda: tpq.reconstruct_batch(torch.zeros((2, 4), dtype=torch.uint8), method="nope")),
    ]
    for jax_call, torch_call in bad:
        assert message(torch_call) == message(jax_call)


@pytest.mark.parametrize("projection", [False, True])
@pytest.mark.parametrize("method", ["exact", "kernel", "kernel-f32"])
def test_quantize_batch_into_writes_out(method, projection):
    _, tpq, _, _, x = _models(projection)
    for dtype in (torch.uint8, torch.int32, torch.int16):
        out = torch.full((x.shape[0], 4), 99, dtype=dtype)
        ret = quantize_batch_into(tpq, t(x), out, method=method)
        assert ret is out
        want = tpq.quantize_batch(t(x), dtype=dtype, method=method)
        np.testing.assert_array_equal(out.numpy(), want.numpy())
    with pytest.raises(ValueError, match="out has shape"):
        quantize_batch_into(tpq, t(x), torch.zeros((3, 4), dtype=torch.uint8))


@pytest.mark.parametrize("projection", [False, True])
@pytest.mark.parametrize("method", ["auto", "gather", "kernel", "kernel-fast", "kernel-int8"])
def test_reconstruct_batch_into_writes_out(method, projection):
    _, tpq, _, _, x = _models(projection)
    codes = tpq.quantize_batch(t(x))
    out = torch.full((x.shape[0], 32), float("nan"))
    ret = reconstruct_batch_into(tpq, codes, out, method=method)
    assert ret is out
    np.testing.assert_array_equal(out.numpy(), tpq.reconstruct_batch(codes, method=method).numpy())
    with pytest.raises(ValueError, match="out has shape"):
        reconstruct_batch_into(tpq, codes, torch.zeros((3, 32)))


def test_vector_into_entries_write_out():
    _, tpq, _, _, x = _models(True)
    code_out = torch.zeros(4, dtype=torch.int32)
    assert quantize_vector_into(tpq, t(x[0]), code_out) is code_out
    np.testing.assert_array_equal(
        code_out.numpy(), tpq.quantize_vector(t(x[0]), dtype=torch.int32).numpy())
    rec_out = torch.zeros(32)
    assert reconstruct_into(tpq, code_out, rec_out) is rec_out
    np.testing.assert_array_equal(rec_out.numpy(), tpq.reconstruct(code_out).numpy())
    with pytest.raises(ValueError, match="out has shape"):
        quantize_vector_into(tpq, t(x[0]), torch.zeros(5, dtype=torch.int32))
    with pytest.raises(ValueError, match="out has shape"):
        reconstruct_into(tpq, code_out, torch.zeros(31))


@pytest.mark.parametrize("projection", [False, True])
def test_artifacts_cross_both_ways(tmp_path, projection):
    jpq, tpq, cb, proj, _ = _models(projection)
    # Saved by the port, loaded by the JAX package.
    tio.save(tmp_path / "from_torch.npz", tpq)
    back = jio.load(tmp_path / "from_torch.npz")
    np.testing.assert_array_equal(np.asarray(back.codebooks), cb)
    # Saved by the JAX package, loaded by the port.
    jio.save(tmp_path / "from_jax.npz", jpq)
    loaded = tio.load(tmp_path / "from_jax.npz", device="cpu")
    np.testing.assert_array_equal(loaded.codebooks.numpy(), cb)
    if projection:
        np.testing.assert_array_equal(np.asarray(back.projection), proj)
        np.testing.assert_array_equal(loaded.projection.numpy(), proj)
    else:
        assert back.projection is None and loaded.projection is None
    # Both files hold the same keys and values.
    with np.load(tmp_path / "from_torch.npz") as a, np.load(tmp_path / "from_jax.npz") as b:
        assert sorted(a.files) == sorted(b.files)
        for key in a.files:
            np.testing.assert_array_equal(a[key], b[key])
    cbs, prj = convert.to_numpy(loaded)
    np.testing.assert_array_equal(cbs, cb)
    assert (prj is None) == (proj is None)


def test_io_rejects_what_it_does_not_hold(tmp_path):
    np.savez(tmp_path / "other.npz", a=np.zeros(3))
    with pytest.raises(ValueError, match="not a reductive-tpu quantizer artifact"):
        tio.load(tmp_path / "other.npz", device="cpu")
    np.savez(tmp_path / "new.npz", format=np.array("reductive-tpu-pq"), version=np.array(2),
             codebooks=np.zeros((1, 2, 4), np.float32))
    with pytest.raises(ValueError, match="newer than supported"):
        tio.load(tmp_path / "new.npz", device="cpu")
    # A minimal IVF-PQ artifact (one cell, one empty slot) loads as an index.
    np.savez(tmp_path / "ivf.npz", format=np.array("reductive-tpu-ivfpq"), version=np.array(1),
             codebooks=np.zeros((1, 2, 4), np.float32),
             coarse_centroids=np.zeros((1, 4), np.float32),
             cell_codes=np.zeros((1, 1, 1), np.uint8), cell_ids=np.full((1, 1), -1, np.int32),
             cell_norms=np.zeros((1, 1), np.float32))
    index = tio.load(tmp_path / "ivf.npz", device="cpu")
    assert isinstance(index, IvfPq) and index.n_cells == 1 and index.capacity == 1
    assert not index.packed and index.dropped_ids.size == 0
    with pytest.raises(TypeError, match="Pq or an IvfPq"):
        tio.save(tmp_path / "x.npz", object())
