"""reductive_tpu_torch.ops.assign against the JAX package's encode kernel
(Pallas interpreter) and against the exact path, on the CPU.

The CUDA kernel cannot run here: on CPU tensors the wrapper takes its plain
version, which is what these tests hold against JAX.  ``chip_smoke.py``
holds the kernel against the plain version on the card.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from reductive_tpu.ops import assign_nearest as j_assign_nearest
from reductive_tpu.ops import pq_encode as j_pq_encode
from reductive_tpu_torch.ops import assign_nearest, pq_encode, pq_encode_reference
from reductive_tpu_torch.pq import primitives as tprim

from torch_port_util import assert_codes_near_optimal, j, make_pq_data, t

# (n, m, k, ds); 1003 is no multiple of any tile.
SHAPES = [(512, 2, 7, 4), (1003, 4, 16, 8), (600, 16, 256, 8)]


@pytest.mark.parametrize("n,m,k,ds", SHAPES)
def test_pq_encode_f32_matches_jax_and_exact(n, m, k, ds):
    cb, x = make_pq_data(11 + n, n, m, k, ds)
    got = pq_encode(t(cb), t(x), dtype=torch.int32, compute_dtype=torch.float32).numpy()
    jax_codes = np.asarray(j_pq_encode(
        j(cb), j(x), dtype=jnp.int32, compute_dtype=jnp.float32, interpret=True))
    exact = tprim.quantize_batch(t(cb), t(x), dtype=torch.int32).numpy()
    # The JAX kernel carries 2^-17 split error and 2^-15 key coarsening, so
    # a near-tie may go either way: 99.9% equal, the rest within 2^-13.
    assert_codes_near_optimal(cb, x, got, jax_codes, min_equal=0.999, rel_tol=2.0 ** -13)
    assert_codes_near_optimal(cb, x, got, exact, min_equal=0.999, rel_tol=2.0 ** -13)


# The Pallas interpreter runs the bf16 mode on the CPU only where XLA's CPU
# backend has a bf16 x bf16 -> f32 product for the shape: wide score matrices.
BF16_SHAPES = [(1003, 4, 256, 8), (600, 16, 256, 8), (333, 4, 256, 8)]


@pytest.mark.parametrize("n,m,k,ds", BF16_SHAPES)
def test_pq_encode_bf16_matches_jax(n, m, k, ds):
    cb, x = make_pq_data(23 + n, n, m, k, ds)
    got = pq_encode(t(cb), t(x), dtype=torch.int32).numpy()  # bfloat16 is the default
    jax_codes = np.asarray(j_pq_encode(j(cb), j(x), dtype=jnp.int32, interpret=True))
    # bf16 products: 99% equal, the rest within 2^-7 of the best f32 distance.
    assert_codes_near_optimal(cb, x, got, jax_codes, min_equal=0.99, rel_tol=2.0 ** -7)


def test_pq_encode_bf16_rounds_inputs_not_norms():
    # One centroid wins only if |c|^2 comes from the unrounded codebook:
    # 1 + 2^-9 rounds to 1 in bfloat16.
    c = np.float32(1.0 + 2.0 ** -9)
    cb = np.full((1, 256, 4), 100.0, dtype=np.float32)  # 254 far centroids fill k
    cb[0, 0] = [c, 0.0, 0.0, 0.0]
    cb[0, 1] = [1.0, 0.0, 0.0, 0.0]
    x = np.array([[1.0, 0.0, 0.0, 0.0]], dtype=np.float32)
    got = pq_encode(t(cb), t(x), dtype=torch.int32).numpy()
    want = np.asarray(j_pq_encode(j(cb), j(x), dtype=jnp.int32, interpret=True))
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, [[1]])


def test_pq_encode_ties_take_first_index():
    cb = np.tile(np.array([[0.5, -1.0, 2.0, 0.25]], dtype=np.float32), (1, 5, 1))
    x = np.random.default_rng(0).standard_normal((9, 4), dtype=np.float32)
    for cd in (torch.float32, torch.bfloat16):
        got = pq_encode(t(cb), t(x), dtype=torch.int32, compute_dtype=cd)
        assert int(got.abs().max()) == 0


@pytest.mark.parametrize("compute", ["f32", "bf16"])
def test_assign_nearest_matches_jax(compute):
    rng = np.random.default_rng(31)
    centroids = rng.standard_normal((256, 8), dtype=np.float32)
    x = rng.standard_normal((700, 8), dtype=np.float32)
    tcd, jcd, min_equal, tol = {
        "f32": (torch.float32, jnp.float32, 0.999, 2.0 ** -13),
        "bf16": (torch.bfloat16, jnp.bfloat16, 0.99, 2.0 ** -7),
    }[compute]
    got = assign_nearest(t(centroids), t(x), compute_dtype=tcd)
    assert got.dtype == torch.int32 and tuple(got.shape) == (700,)
    want = np.asarray(j_assign_nearest(j(centroids), j(x), compute_dtype=jcd, interpret=True))
    assert_codes_near_optimal(
        centroids[None], x, got.numpy()[:, None], want[:, None], min_equal, tol)


@pytest.mark.parametrize("dtype", [torch.uint8, torch.int16, torch.int64, torch.uint16])
def test_pq_encode_dtypes_and_out(dtype):
    cb, x = make_pq_data(41, 100, 4, 16, 8)
    want = pq_encode_reference(t(cb), t(x), dtype=torch.int32, compute_dtype=torch.float32)
    got = pq_encode(t(cb), t(x), dtype=dtype, compute_dtype=torch.float32)
    assert got.dtype == dtype
    np.testing.assert_array_equal(got.to(torch.int64).numpy(), want.to(torch.int64).numpy())
    out = torch.zeros((100, 4), dtype=dtype)
    ret = pq_encode(t(cb), t(x), dtype=dtype, compute_dtype=torch.float32, out=out)
    assert ret is out
    np.testing.assert_array_equal(out.to(torch.int64).numpy(), want.to(torch.int64).numpy())


def test_pq_encode_errors():
    cb, x = make_pq_data(43, 10, 2, 4, 4)
    with pytest.raises(ValueError) as jerr:
        j_pq_encode(j(cb), j(x[:, :6]), interpret=True)
    with pytest.raises(ValueError) as terr:
        pq_encode(t(cb), t(x[:, :6]))
    assert str(terr.value) == str(jerr.value)
    with pytest.raises(OverflowError):
        pq_encode(torch.zeros((1, 257, 4)), torch.zeros((2, 4)), dtype=torch.uint8)
    with pytest.raises(TypeError):
        pq_encode(t(cb), t(x).double())
    with pytest.raises(ValueError, match="compute_dtype"):
        pq_encode(t(cb), t(x), compute_dtype=torch.float16)
    with pytest.raises(ValueError, match="out must be"):
        pq_encode(t(cb), t(x), out=torch.zeros((10, 3), dtype=torch.uint8))
