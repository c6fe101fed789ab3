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
from reductive_tpu_torch.ops import decode
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


# -- any width: more widths, code types and views against the JAX kernels ----------

# (n, m, k, ds, code dtype, packed): ds 1, 3, 5, 10 (widths not a multiple of 4,
# the row-tile kernels' on the card), k = 300 with int32 codes, packed at ds 3;
# n of one row, below one tile and no multiple of a tile.
ANY_WIDTH = [
    (417, 20, 16, 1, np.uint8, False), (300, 7, 16, 3, np.uint8, False),
    (1, 4, 128, 5, np.uint8, False), (1001, 2, 128, 10, np.uint8, False),
    (250, 3, 300, 5, np.int32, False), (129, 6, 16, 3, np.uint8, True),
]


@pytest.mark.parametrize("splits", [1, 2, 3, "int8"])
@pytest.mark.parametrize("n,m,k,ds,dtype,packed", ANY_WIDTH)
def test_pq_decode_at_more_widths_matches_jax(n, m, k, ds, dtype, packed, splits):
    cb, _ = make_pq_data(60 + ds, n, m, k, ds)
    codes = _codes(n, m, k, dtype)
    jcodes = codes
    if packed:
        codes = pack_u4_codes(t(codes)).numpy()
        jcodes = codes
    got = pq_decode(t(cb), t(codes), splits=splits, packed=packed).numpy()
    want = np.asarray(j_pq_decode(j(cb), j(jcodes), splits=splits, packed=packed, interpret=True))
    if splits == "int8":  # within 1 ulp: XLA may contract acc * scale + offset
        assert np.all(np.abs(got - want) <= np.spacing(np.abs(want).astype(np.float32)))
    else:  # every element is one nonzero product: bit-equal
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("packed", [False, True])
@pytest.mark.parametrize("start", [1, 3, 16])
def test_pq_decode_of_codes_that_start_mid_tensor_matches_jax(start, packed):
    n, m, k, ds = 300, 10, 16, 3
    cb, _ = make_pq_data(61, n, m, k, ds)
    codes = t(_codes(n + start, m, k))
    if packed:
        codes = pack_u4_codes(codes)
    part = codes[start:]
    assert part.is_contiguous() and part.storage_offset() > 0
    got = pq_decode(t(cb), part, packed=packed).numpy()
    want = np.asarray(j_pq_decode(j(cb), j(part.numpy()), packed=packed, interpret=True))
    np.testing.assert_array_equal(got, want)
    out = torch.full((n * m * ds + 1,), -1.0)[1:].view(n, m * ds)  # an out off 16 bytes
    assert pq_decode(t(cb), part, packed=packed, out=out) is out
    np.testing.assert_array_equal(out.numpy(), want)


# -- the table regimes and the tables of the row-tile kernels ------------------------


@pytest.mark.parametrize("code_bytes,packed", [(1, False), (4, False), (1, True)])
@pytest.mark.parametrize("int8", [False, True])
def test_the_decode_tile_plan_is_a_pure_function_of_the_shape(int8, code_bytes, packed):
    for m in (2, 4, 10, 30, 100, 150, 300, 2048):
        for ds in (1, 2, 3, 5, 10, 30, 301):
            for k in (7, 16, 128, 256, 4096):
                if packed and k > 16:
                    continue
                rows, group = decode.decode_tile_plan(m, k, ds, code_bytes, packed, int8)
                row_bytes = m // 2 if packed else m * code_bytes
                smem = decode.decode_tile_smem(m, k, ds, row_bytes, int8, rows, group)
                # A multiple of 16, or fewer where 16 rows' codes exceed the tile's bytes.
                assert rows >= 1 and (rows % 16 == 0 or 16 * row_bytes > decode._TILE_CODE_BYTES)
                assert rows * row_bytes <= max(decode._TILE_CODE_BYTES, row_bytes)
                assert 0 <= group <= m
                assert rows * m * ds < 1 << 30
                if group > 0:  # the staged regimes hold the budget of their table type
                    assert smem <= decode._TILE_SHARED_BYTES[int8]
                    # The whole table exactly where it fits beside its codes tile.
                    assert (group == m) == (decode.decode_tile_smem(
                        m, k, ds, row_bytes, int8, decode._tile_rows(m * ds, row_bytes), m)
                        <= decode._TILE_SHARED_BYTES[int8])
                else:  # not even one subquantizer's entries fit
                    assert ds * k * (1 if int8 else 4) > decode._TILE_SHARED_BYTES[int8] // 2
                assert smem <= 232448  # what the C entry accepts
    # The shapes the port's records name: the gate width stages its whole
    # table (10 KB f32, 2.5 KB int8); at d=300, k=256 the f32 table (307 KB)
    # is staged a group of subquantizers a block, and so is the int8 one
    # (78 KB) within int8's budget of 64 KB.
    assert decode.decode_tile_plan(10, 128, 2, 1, False, int8) == (416, 10)
    assert 0 < decode.decode_tile_plan(150, 256, 2, 1, False, int8)[1] < 150
    assert 0 < decode.decode_tile_plan(30, 256, 10, 1, False, int8)[1] < 30
    assert decode.decode_tile_plan(1, 4096, 301, 1, False, False)[1] == 0


def _bf16_bits(v):
    """f32 -> bfloat16 to nearest, ties to even, on the bits (NaN kept NaN)."""
    u = v.astype(np.float32).view(np.uint32).astype(np.uint64)
    r = ((u + 0x7FFF + ((u >> 16) & 1)) >> 16 << 16).astype(np.uint32).view(np.float32)
    return np.where(np.isnan(v), np.float32(np.nan), r).astype(np.float32)


def _adversarial(seed, size, finite=False):
    """f32 values of every kind: random bit patterns (subnormals, huge and tiny
    values, inf and NaN unless ``finite``), +-0, +-FLT_MAX, the extreme
    subnormals, bf16 rounding ties that go down, up, and up into inf."""
    bits = np.random.default_rng(seed).integers(0, 1 << 32, size, dtype=np.uint64).astype(np.uint32)
    bits[:12] = [0, 0x80000000, 0x7F7FFFFF, 0xFF7FFFFF, 0x007FFFFF, 1, 0x80000001, 0x3F808000,
                 0x3F818000, 0xBF808000, 0x7F7F8000, 0x00008000]
    v = bits.view(np.float32)
    return np.where(np.isfinite(v), v, np.float32(0)) if finite else v


def _same_bits(a, b):
    a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
    return bool(np.all((a.view(np.uint32) == b.view(np.uint32)) | (np.isnan(a) & np.isnan(b))))


@pytest.mark.parametrize("splits", [1, 2, 3])
def test_the_effective_codebook_against_a_bit_oracle(splits):
    # What csrc/decode.cu's table launch computes (rounding to bf16 nearest
    # even, the residual and the sum in f32 one operation at a time), in
    # numpy, against the plain version and the JAX package's parts; near
    # +-FLT_MAX the first part rounds to inf and the sum is NaN on both sides.
    v = _adversarial(splits, 30000).reshape(10, 1000, 3)
    with np.errstate(invalid="ignore", over="ignore"):
        residual = v
        part = _bf16_bits(residual)
        total = part
        for _ in range(1, splits):
            residual = (residual - part).astype(np.float32)
            part = _bf16_bits(residual)
            total = (total + part).astype(np.float32)
    assert _same_bits(effective_codebook(t(v), splits).numpy(), total)
    jparts = np.asarray(j_split_bf16(j(v), splits).astype(jnp.float32))
    jtotal = jparts[0]
    with np.errstate(invalid="ignore"):
        for p in jparts[1:]:
            jtotal = (jtotal + p).astype(np.float32)
    # XLA's CPU backend flushes subnormals to zero: the JAX package is held
    # where no part or residual is subnormal.
    normal = ~(np.abs(v) < np.float32(2.0 ** -100))
    assert _same_bits(jtotal[normal], total[normal])
    if splits == 3:  # three parts hold every normal value below the top (-0 as +0)
        held = normal & np.isfinite(v) & (np.abs(v) < np.float32(3.3e38))
        np.testing.assert_array_equal(total[held], v[held])


def test_the_int8_quantizer_against_a_value_oracle():
    v = _adversarial(7, 20000, finite=True).reshape(4, 1000, 5)
    v[1, :, 2] = 0.0  # a column of zeros: scale 0, divided by 1e-30
    v[2] *= np.float32(1e-38)  # subnormals
    w8, scale = quantize_codebook_int8(t(v))
    want_scale = (np.abs(v).max(axis=1) * (np.float32(1) / np.float32(127))).astype(np.float32)
    with np.errstate(invalid="ignore", over="ignore"):
        want_w8 = np.rint(v / np.maximum(want_scale, np.float32(1e-30))[:, None, :])
    np.testing.assert_array_equal(scale.numpy(), want_scale.reshape(-1))
    np.testing.assert_array_equal(w8.numpy(), want_w8.astype(np.int8))
    jscale, jw8 = map(np.asarray, _jax_decode_quantizer(j(v)))
    np.testing.assert_array_equal(jscale.reshape(-1), want_scale.reshape(-1))
    np.testing.assert_array_equal(jw8, want_w8.astype(np.int8))
