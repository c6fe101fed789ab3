"""reductive_tpu_torch.ops.adc against the JAX package's ADC kernels (Pallas
interpreter), on the CPU."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from reductive_tpu.ops.adc import adc_scores_kernel as j_adc_scores_kernel
from reductive_tpu.pq.model import Pq as JPq
from reductive_tpu.search import adc_tables as j_adc_tables
from reductive_tpu_torch import Pq
from reductive_tpu_torch.ops import (
    adc_scores_kernel, adc_scores_reference, max_query_batch, pack_u4_codes,
)
from reductive_tpu_torch.ops.adc import quantize_tables_int8, query_tile
from reductive_tpu_torch.search import adc_tables

from torch_port_util import j, make_pq_data, t

# (n, m, k, ds, nq)
SHAPES = [(700, 4, 16, 8, 7), (1001, 16, 256, 8, 5), (300, 2, 7, 4, 3)]


def _setup(n, m, k, ds, nq, metric):
    cb, x = make_pq_data(61 + n, n + nq, m, k, ds)
    codes = np.random.default_rng(n).integers(0, k, (n, m)).astype(np.uint8)
    jt = j_adc_tables(JPq(codebooks=j(cb)), j(x[:nq]), metric=metric)
    tt = adc_tables(Pq.from_numpy(cb, device="cpu"), t(x[:nq]), metric=metric)
    return codes, jt, tt


@pytest.mark.parametrize("metric", ["l2", "dot"])
@pytest.mark.parametrize("n,m,k,ds,nq", SHAPES)
def test_adc_tables_match_jax(n, m, k, ds, nq, metric):
    _, jt, tt = _setup(n, m, k, ds, nq, metric)
    assert tuple(tt.shape) == (nq, m, k) and tt.dtype == torch.float32
    np.testing.assert_allclose(tt.numpy(), np.asarray(jt), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("metric", ["l2", "dot"])
@pytest.mark.parametrize("splits", [1, 2, 3])
@pytest.mark.parametrize("n,m,k,ds,nq", SHAPES)
def test_adc_scores_kernel_matches_jax(n, m, k, ds, nq, splits, metric):
    codes, jt, _ = _setup(n, m, k, ds, nq, metric)
    # Same tables into both, so that only the scorer is compared.
    want = np.asarray(j_adc_scores_kernel(jt, j(codes), splits=splits, interpret=True))
    got = adc_scores_kernel(t(np.asarray(jt)), t(codes), splits=splits)
    assert tuple(got.shape) == (nq, n) and got.dtype == torch.float32
    # Summation order over m * splits terms differs.
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5 * np.abs(want).max())


@jax.jit
def _jax_adc_quantizer(tables):
    """The quantizer of ``reductive_tpu.ops.adc.adc_scores_kernel`` (its lines
    for ``splits="int8"``), compiled as it is there, without the padding of
    k and the transposition that only its matrix layout needs."""
    m = tables.shape[1]
    t_min = jnp.min(tables, axis=2, keepdims=True)
    t_max = jnp.max(tables, axis=2, keepdims=True)
    scale = jnp.maximum(jnp.max((t_max - t_min)[:, :, 0], axis=1) / 255.0, 1e-30)
    q = jnp.round((tables - t_min) / scale[:, None, None]) - 128.0
    t8 = jnp.clip(q, -128, 127).astype(jnp.int8)
    offset = jnp.sum(t_min[:, :, 0], axis=1) + 128.0 * m * scale
    return t8, scale, offset


@pytest.mark.parametrize("metric", ["l2", "dot"])
@pytest.mark.parametrize("n,m,k,ds,nq", SHAPES)
def test_adc_scores_int8_matches_jax(n, m, k, ds, nq, metric):
    codes, jt, _ = _setup(n, m, k, ds, nq, metric)
    tables = t(np.asarray(jt))
    t8, scale, offset = quantize_tables_int8(tables)
    jt8, jscale, joffset = map(np.asarray, _jax_adc_quantizer(jt))
    np.testing.assert_array_equal(t8.numpy(), jt8)
    np.testing.assert_array_equal(scale.numpy(), jscale)
    np.testing.assert_array_equal(offset.numpy(), joffset)
    want = np.asarray(j_adc_scores_kernel(jt, j(codes), splits="int8", interpret=True))
    got = adc_scores_kernel(tables, t(codes), splits="int8").numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5 * np.abs(want).max())


# (n, m, k, ds, nq) with k <= 16 and even m: the JAX tests' shape, m = 2, and
# m no multiple of 8 with ragged k.
PACKED_SHAPES = [(500, 8, 16, 4, 5), (301, 2, 16, 8, 3), (257, 6, 7, 4, 4)]


@pytest.mark.parametrize("splits", [1, 2, 3, "int8"])
@pytest.mark.parametrize("n,m,k,ds,nq", PACKED_SHAPES)
def test_adc_scores_packed_matches_jax_and_the_unpacked_scores(n, m, k, ds, nq, splits):
    codes, jt, _ = _setup(n, m, k, ds, nq, "l2")
    tables = t(np.asarray(jt))
    packed = pack_u4_codes(t(codes))
    got = adc_scores_kernel(tables, packed, splits=splits, packed=True)
    # Bit-equal to the port's unpacked scores (the same sum in the same order).
    np.testing.assert_array_equal(
        got.numpy(), adc_scores_kernel(tables, t(codes), splits=splits).numpy())
    np.testing.assert_array_equal(
        got.numpy(), adc_scores_reference(tables, packed, splits=splits, packed=True).numpy())
    want = np.asarray(j_adc_scores_kernel(jt, j(packed.numpy()), splits=splits, packed=True,
                                          interpret=True))
    # The tolerance of the unpacked comparison: summation order differs.
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5 * np.abs(want).max())


@pytest.mark.parametrize("dtype", [np.int16, np.int32, np.int64])
def test_adc_packed_code_dtypes(dtype):
    codes, jt, _ = _setup(100, 4, 16, 8, 3, "l2")
    tables = t(np.asarray(jt))
    packed = pack_u4_codes(t(codes))
    want = adc_scores_kernel(tables, packed, splits=3, packed=True)
    got = adc_scores_kernel(tables, t(packed.numpy().astype(dtype)), splits=3, packed=True)
    np.testing.assert_array_equal(got.numpy(), want.numpy())


@pytest.mark.parametrize("dtype", [np.uint8, np.int16, np.int32, np.int64])
def test_adc_code_dtypes(dtype):
    codes, jt, _ = _setup(200, 4, 16, 8, 3, "l2")
    tables = t(np.asarray(jt))
    want = adc_scores_reference(tables, t(codes), splits=3)
    got = adc_scores_kernel(tables, t(codes.astype(dtype)), splits=3)
    np.testing.assert_array_equal(got.numpy(), want.numpy())


def test_query_tiling_by_shared_memory():
    # One query's f32 tables: m*k*4 bytes; a block has 227 KB.
    assert query_tile(16, 256) == 8          # 16 KB a query
    assert query_tile(24, 256) == 8          # 24 KB a query: 8 make 192 KB
    assert query_tile(64, 256) == 2          # 64 KB a query
    assert query_tile(24, 65536) == 0        # 6 MB: no tiling
    assert query_tile(64, 256, "int8") == 8  # 16 KB a query in int8: 16 queries make 256 KB
    assert max_query_batch(24, 256) == 65535 * 8
    assert max_query_batch(24, 65536) == 0
    # Where 32 copies of every entry fit (128*m*k bytes), the f32 kernel holds
    # 32 queries a block; so does the int8 kernel where 128 bytes of copies of
    # every entry fit (ops.adc.adc_int8_plan).
    assert query_tile(16, 16) == 32 and query_tile(113, 16) == 32
    assert query_tile(114, 16) == 16         # 7.1 KB a query: 32 copies do not fit, 16 queries do
    assert query_tile(16, 16, "int8") == 32
    assert max_query_batch(16, 16) == 65535 * 32


def test_adc_errors():
    codes, jt, _ = _setup(50, 4, 16, 8, 3, "l2")
    tables = t(np.asarray(jt))
    with pytest.raises(ValueError) as jerr:
        j_adc_scores_kernel(jt, j(codes[:, :3]), interpret=True)
    with pytest.raises(ValueError) as terr:
        adc_scores_kernel(tables, t(codes[:, :3]))
    assert str(terr.value) == str(jerr.value)
    # Packed codes: the JAX package's checks and messages.
    bad_packed = [
        (jt, codes),                                              # (n, m), not (n, m/2)
        (jt[:, :3], codes[:, :1]),                                # odd m
        (jnp.concatenate([jt, jt], axis=2), codes[:, :2]),        # k = 32
    ]
    for jtab, codes_p in bad_packed:
        with pytest.raises(ValueError) as jerr:
            j_adc_scores_kernel(jtab, j(codes_p), packed=True, interpret=True)
        for fn in (adc_scores_kernel, adc_scores_reference):
            with pytest.raises(ValueError) as terr:
                fn(t(np.asarray(jtab)), t(codes_p), packed=True)
            assert str(terr.value) == str(jerr.value)
    np.testing.assert_array_equal(
        adc_scores_kernel(tables, pack_u4_codes(t(codes)), packed=True).numpy(),
        adc_scores_kernel(tables, t(codes)).numpy())
    with pytest.raises(ValueError, match="splits"):
        adc_scores_kernel(tables, t(codes), splits=5)
    with pytest.raises(TypeError):
        adc_scores_kernel(tables, t(codes).float())
