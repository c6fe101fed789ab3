"""reductive_tpu_torch.pq.primitives against reductive_tpu.pq.primitives on
the same float32 inputs (CPU)."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from reductive_tpu.pq import primitives as jprim
from reductive_tpu_torch.pq import primitives as tprim

from torch_port_util import assert_codes_near_optimal, j, make_pq_data, t

SHAPES = [(300, 2, 7, 4), (1000, 4, 16, 8), (513, 16, 256, 8)]


@pytest.mark.parametrize("n,m,k,ds", SHAPES)
def test_quantize_batch_matches_jax(n, m, k, ds):
    cb, x = make_pq_data(n + m, n, m, k, ds)
    want = np.asarray(jprim.quantize_batch(j(cb), j(x), dtype=jnp.int32))
    got = tprim.quantize_batch(t(cb), t(x), dtype=torch.int32)
    assert got.dtype == torch.int32 and tuple(got.shape) == (n, m)
    # Equal, or for each differing code the two distances within 1e-6
    # relative (f32 summation order on a near-tie).
    assert_codes_near_optimal(cb, x, got.numpy(), want, min_equal=0.999, rel_tol=1e-6)


def test_quantize_batch_ties_take_first_index():
    # Centroids 1 and 3 are copies of centroid 0 / 2: exact ties.
    cb = np.array([[[1.0, 0.0], [1.0, 0.0], [0.0, 1.0], [0.0, 1.0]]], dtype=np.float32)
    x = np.array([[1.0, 0.1], [0.1, 1.0], [0.5, 0.5]], dtype=np.float32)
    want = np.asarray(jprim.quantize_batch(j(cb), j(x), dtype=jnp.int32))
    got = tprim.quantize_batch(t(cb), t(x), dtype=torch.int32).numpy()
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got[:, 0], [0, 2, 0])


@pytest.mark.parametrize("method", ["auto", "gather", "onehot"])
@pytest.mark.parametrize("n,m,k,ds", SHAPES)
def test_reconstruct_batch_bit_equal(n, m, k, ds, method):
    cb, _ = make_pq_data(3, n, m, k, ds)
    codes = np.random.default_rng(4).integers(0, k, (n, m)).astype(np.uint8)
    want = np.asarray(jprim.reconstruct_batch(j(cb), j(codes), method="gather"))
    got = tprim.reconstruct_batch(t(cb), t(codes), method=method)
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), want)


def test_single_vector_entries():
    cb, x = make_pq_data(5, 4, 4, 16, 8)
    code = tprim.quantize(t(cb), t(x[0]), dtype=torch.int16)
    np.testing.assert_array_equal(
        code.numpy(), np.asarray(jprim.quantize(j(cb), j(x[0]), dtype=jnp.int16)))
    rec = tprim.reconstruct(t(cb), code)
    np.testing.assert_array_equal(
        rec.numpy(), np.asarray(jprim.reconstruct(j(cb), j(code.numpy()))))
    assert tprim.reconstructed_len(t(cb)) == jprim.reconstructed_len(j(cb)) == 32


@pytest.mark.parametrize(
    "tdtype,jdtype",
    [(torch.uint8, jnp.uint8), (torch.int16, jnp.int16), (torch.int32, jnp.int32),
     (torch.int64, jnp.int64), (torch.uint16, jnp.uint16), (torch.uint32, jnp.uint32)],
)
def test_code_dtypes(tdtype, jdtype):
    cb, x = make_pq_data(6, 64, 2, 16, 4)
    got = tprim.quantize_batch(t(cb), t(x), dtype=tdtype)
    assert got.dtype == tdtype
    want = np.asarray(jprim.quantize_batch(j(cb), j(x), dtype=jdtype))
    np.testing.assert_array_equal(got.to(torch.int64).numpy(), want.astype(np.int64))


def test_code_dtype_errors():
    cb = np.zeros((1, 257, 4), dtype=np.float32)
    x = np.zeros((3, 4), dtype=np.float32)
    with pytest.raises(OverflowError) as jerr:
        jprim.quantize_batch(j(cb), j(x), dtype=jnp.uint8)
    with pytest.raises(OverflowError) as terr:
        tprim.quantize_batch(t(cb), t(x), dtype=torch.uint8)
    assert str(terr.value) == str(jerr.value)
    assert tprim.quantize_batch(t(cb), t(x), dtype=torch.int16).dtype == torch.int16
    with pytest.raises(TypeError, match="must be an integer type"):
        tprim.quantize_batch(t(cb), t(x), dtype=torch.float32)
    with pytest.raises(TypeError, match="must be an integer type"):
        jprim.quantize_batch(j(cb), j(x), dtype=jnp.float32)


def _message(fn):
    with pytest.raises(ValueError) as err:
        fn()
    return str(err.value)


def test_shape_errors_have_the_same_messages():
    cb, x = make_pq_data(7, 5, 2, 4, 4)
    codes = np.zeros((5, 3), dtype=np.uint8)
    pairs = [
        (lambda: jprim.quantize_batch(j(cb), j(x[:, :6])),
         lambda: tprim.quantize_batch(t(cb), t(x[:, :6]))),
        (lambda: jprim.reconstruct_batch(j(cb), j(codes)),
         lambda: tprim.reconstruct_batch(t(cb), t(codes))),
        (lambda: jprim.quantize(j(cb), j(x)), lambda: tprim.quantize(t(cb), t(x))),
        (lambda: jprim.reconstruct(j(cb), j(codes)), lambda: tprim.reconstruct(t(cb), t(codes))),
        (lambda: jprim.reconstruct_batch(j(cb), j(codes[:, :2]), method="nope"),
         lambda: tprim.reconstruct_batch(t(cb), t(codes[:, :2]), method="nope")),
    ]
    for jax_call, torch_call in pairs:
        assert _message(torch_call) == _message(jax_call)
