"""reductive_tpu_torch.ops.decode against the JAX package's decode kernels
(Pallas interpreter), on the CPU.  Every output element of the JAX kernel is
one nonzero product, so the port's gather from the effective codebook must
be bit-equal to it for every ``splits``."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from reductive_tpu.ops.decode import pq_decode as j_pq_decode
from reductive_tpu.ops.decode import split_bf16 as j_split_bf16
from reductive_tpu.pq import primitives as jprim
from reductive_tpu_torch.ops import (
    pack_u4_codes, pq_decode, pq_decode_reference, split_bf16, unpack_u4_codes,
)
from reductive_tpu_torch.ops.decode import effective_codebook, quantize_codebook_int8
from reductive_tpu_torch.pq import primitives as tprim

from torch_port_util import j, make_pq_data, t

SHAPES = [(500, 4, 7, 4), (1001, 16, 256, 8), (300, 2, 16, 8)]


@jax.jit
def _jax_decode_quantizer(cb):
    """The quantizer of ``reductive_tpu.ops.decode.pq_decode`` (its lines for
    ``splits="int8"``) on the ``(m, k, ds)`` layout, compiled as it is there:
    a column of the block-diagonal matrix is one ``(j, t)`` pair."""
    scale = jnp.max(jnp.abs(cb), axis=1) / 127.0
    return scale, jnp.round(cb / jnp.maximum(scale, 1e-30)[:, None, :]).astype(jnp.int8)


def _codes(n, m, k, dtype=np.uint8):
    return np.random.default_rng(n + m + k).integers(0, k, (n, m)).astype(dtype)


@pytest.mark.parametrize("splits", [1, 2, 3])
@pytest.mark.parametrize("n,m,k,ds", SHAPES)
def test_pq_decode_bit_equal_to_jax(n, m, k, ds, splits):
    cb, _ = make_pq_data(51, n, m, k, ds)
    codes = _codes(n, m, k)
    want = np.asarray(j_pq_decode(j(cb), j(codes), splits=splits, interpret=True))
    got = pq_decode(t(cb), t(codes), splits=splits)
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), want)
    if splits == 3:
        np.testing.assert_array_equal(
            got.numpy(), tprim.reconstruct_batch(t(cb), t(codes), method="gather").numpy())
        np.testing.assert_array_equal(
            got.numpy(), np.asarray(jprim.reconstruct_batch(j(cb), j(codes), method="gather")))


@pytest.mark.parametrize("n,m,k,ds", SHAPES)
def test_pq_decode_int8_matches_jax(n, m, k, ds):
    cb, _ = make_pq_data(53, n, m, k, ds)
    codes = _codes(n, m, k)
    want = np.asarray(j_pq_decode(j(cb), j(codes), splits="int8", interpret=True))
    got = pq_decode(t(cb), t(codes), splits="int8").numpy()
    # Within 1 ulp: XLA may contract acc * scale + offset into one rounding.
    ulp = np.spacing(np.abs(want).astype(np.float32))
    assert np.all(np.abs(got - want) <= ulp)
    # The quantized matrix and the scales equal the JAX quantizer's exactly.
    w8, scale = quantize_codebook_int8(t(cb))
    jscale, jw8 = map(np.asarray, _jax_decode_quantizer(j(cb)))
    np.testing.assert_array_equal(scale.numpy(), jscale.reshape(-1))
    np.testing.assert_array_equal(w8.numpy(), jw8)
    # And dequantizing by hand reproduces the decode.
    sub = np.arange(m)[None, :]
    by_hand = w8.numpy()[sub, codes].astype(np.float32).reshape(n, m * ds) * scale.numpy()[None]
    np.testing.assert_array_equal(got, by_hand)


# (n, m, k, ds) with k <= 16 and even m: m = 2, m no multiple of 8, ragged k.
PACKED_SHAPES = [(500, 8, 16, 4), (301, 2, 16, 8), (257, 6, 7, 4)]


@pytest.mark.parametrize("splits", [1, 2, 3, "int8"])
@pytest.mark.parametrize("n,m,k,ds", PACKED_SHAPES)
def test_pq_decode_packed_matches_jax_and_the_unpacked_decode(n, m, k, ds, splits):
    cb, _ = make_pq_data(52, n, m, k, ds)
    codes = _codes(n, m, k)
    packed = pack_u4_codes(t(codes))
    got = pq_decode(t(cb), packed, splits=splits, packed=True)
    # Bit-equal to the port's unpacked decode and to the plain version.
    np.testing.assert_array_equal(got.numpy(), pq_decode(t(cb), t(codes), splits=splits).numpy())
    np.testing.assert_array_equal(
        got.numpy(), pq_decode_reference(t(cb), packed, splits=splits, packed=True).numpy())
    np.testing.assert_array_equal(unpack_u4_codes(packed).numpy(), codes)
    want = np.asarray(j_pq_decode(j(cb), j(packed.numpy()), splits=splits, packed=True,
                                  interpret=True))
    if splits == "int8":  # within 1 ulp, as the unpacked int8 decode
        assert np.all(np.abs(got.numpy() - want) <= np.spacing(np.abs(want).astype(np.float32)))
    else:  # every element is one nonzero product: bit-equal
        np.testing.assert_array_equal(got.numpy(), want)


def test_pq_decode_packed_code_dtypes_and_out():
    cb, _ = make_pq_data(54, 40, 4, 16, 8)
    packed = pack_u4_codes(t(_codes(40, 4, 16)))
    want = pq_decode(t(cb), packed, packed=True)
    for dtype in (torch.int16, torch.int32, torch.int64):
        np.testing.assert_array_equal(
            pq_decode(t(cb), packed.to(dtype), packed=True).numpy(), want.numpy())
    out = torch.zeros((40, 32))
    assert pq_decode(t(cb), packed, packed=True, out=out) is out
    np.testing.assert_array_equal(out.numpy(), want.numpy())


@pytest.mark.parametrize("splits", [1, 2, 3])
def test_split_bf16_equals_jax(splits):
    W = np.random.default_rng(55).standard_normal((33, 20), dtype=np.float32) * 100
    want = np.asarray(j_split_bf16(j(W), splits).astype(jnp.float32))
    got = split_bf16(t(W), splits)
    assert got.dtype == torch.bfloat16 and tuple(got.shape) == (splits, 33, 20)
    np.testing.assert_array_equal(got.to(torch.float32).numpy(), want)
    if splits == 3:
        np.testing.assert_array_equal(effective_codebook(t(W), 3).numpy(), W)


@pytest.mark.parametrize("dtype", [np.uint8, np.int16, np.int32, np.int64])
def test_pq_decode_code_dtypes_and_out(dtype):
    cb, _ = make_pq_data(57, 64, 4, 16, 8)
    codes = _codes(64, 4, 16, dtype)
    want = pq_decode_reference(t(cb), t(codes.astype(np.uint8)), splits=3)
    got = pq_decode(t(cb), t(codes), splits=3)
    np.testing.assert_array_equal(got.numpy(), want.numpy())
    out = torch.zeros((64, 32))
    assert pq_decode(t(cb), t(codes), splits=1, out=out) is out
    np.testing.assert_array_equal(out.numpy(), pq_decode_reference(t(cb), t(codes), splits=1).numpy())


def test_pq_decode_errors():
    cb, _ = make_pq_data(59, 8, 4, 16, 8)
    codes = _codes(8, 3, 16)
    with pytest.raises(ValueError) as jerr:
        j_pq_decode(j(cb), j(codes), interpret=True)
    with pytest.raises(ValueError) as terr:
        pq_decode(t(cb), t(codes))
    assert str(terr.value) == str(jerr.value)
    good = _codes(8, 4, 16)
    # Packed codes: the JAX package's checks and messages.
    bad_packed = [
        (cb, good),                                   # (n, m) where (n, m/2) is expected
        (cb[:3], _codes(8, 1, 16)),                   # odd m
        (np.repeat(cb, 2, axis=1), _codes(8, 2, 16)),  # k = 32
    ]
    for cbs, codes_p in bad_packed:
        with pytest.raises(ValueError) as jerr:
            j_pq_decode(j(cbs), j(codes_p), packed=True, interpret=True)
        for fn in (pq_decode, pq_decode_reference):
            with pytest.raises(ValueError) as terr:
                fn(t(cbs), t(codes_p), packed=True)
            assert str(terr.value) == str(jerr.value)
    np.testing.assert_array_equal(
        pq_decode(t(cb), pack_u4_codes(t(good)), packed=True).numpy(),
        pq_decode(t(cb), t(good)).numpy())
    with pytest.raises(ValueError, match="splits"):
        pq_decode(t(cb), t(good), splits=4)
    with pytest.raises(TypeError):
        pq_decode(t(cb), t(good).float())
    with pytest.raises(ValueError, match="out must be"):
        pq_decode(t(cb), t(good), out=torch.zeros((8, 31)))
