"""reductive_tpu_torch.ops.packing against reductive_tpu.ops.packing and the
native host-side ``pack_u4`` (CPU): the same bytes, so packed codes are plain
``uint8`` arrays that cross between the two packages, and a k=16 quantizer
with its packed codes goes through both packages' decode and search."""

import numpy as np
import pytest
import torch

from reductive_tpu import io as jio
from reductive_tpu import native
from reductive_tpu.ops import pack_u4_codes as j_pack_u4_codes
from reductive_tpu.ops import pq_decode as j_pq_decode
from reductive_tpu.ops import unpack_u4_codes as j_unpack_u4_codes
from reductive_tpu.pq.model import Pq as JPq
from reductive_tpu_torch import convert
from reductive_tpu_torch import io as tio
from reductive_tpu_torch.ops import pack_u4_codes, pq_decode, unpack_u4_codes
from reductive_tpu_torch.ops.packing import check_packed

from torch_port_util import j, make_pq_data, t


def _codes(seed, n, m, k=16):
    return np.random.default_rng(seed).integers(0, k, size=(n, m)).astype(np.uint8)


@pytest.mark.parametrize("n,m", [(37, 8), (1, 2), (100, 16), (5, 24), (64, 6)])
def test_pack_bytes_equal_jax_and_native(n, m):
    codes = _codes(n + m, n, m)
    packed = pack_u4_codes(t(codes))
    assert packed.dtype == torch.uint8 and tuple(packed.shape) == (n, m // 2)
    np.testing.assert_array_equal(packed.numpy(), np.asarray(j_pack_u4_codes(j(codes))))
    # The native packer flattens; a row of even m fills whole bytes.
    np.testing.assert_array_equal(packed.numpy().ravel(), native.pack_u4(codes))
    np.testing.assert_array_equal(unpack_u4_codes(packed).numpy(), codes)
    np.testing.assert_array_equal(
        unpack_u4_codes(packed).numpy(), np.asarray(j_unpack_u4_codes(j(packed.numpy()))))


@pytest.mark.parametrize("dtype", [torch.uint8, torch.int32, torch.int64])
def test_pack_takes_any_integer_code_dtype(dtype):
    codes = _codes(3, 20, 4)
    packed = pack_u4_codes(t(codes).to(dtype))
    assert packed.dtype == torch.uint8
    np.testing.assert_array_equal(packed.numpy(), np.asarray(j_pack_u4_codes(j(codes))))
    assert unpack_u4_codes(packed.to(torch.int32)).dtype == torch.uint8


def test_low_nibble_holds_the_even_code():
    packed = pack_u4_codes(torch.tensor([[1, 2, 15, 0]]))
    np.testing.assert_array_equal(packed.numpy(), [[0x21, 0x0F]])


def test_pack_errors_match_jax():
    codes = _codes(5, 9, 7)
    with pytest.raises(ValueError) as jerr:
        j_pack_u4_codes(j(codes))
    with pytest.raises(ValueError) as terr:
        pack_u4_codes(t(codes))
    assert str(terr.value) == str(jerr.value)


def test_check_packed_messages():
    good = torch.zeros((4, 3), dtype=torch.uint8)
    check_packed(6, 16, good)
    with pytest.raises(ValueError, match="packed u4 codes require even m, got 7"):
        check_packed(7, 16, good)
    with pytest.raises(ValueError, match="packed u4 codes require k <= 16, got 17"):
        check_packed(6, 17, good)
    with pytest.raises(ValueError, match=r"packed codes have shape \(4, 3\), expected \(n, 4\)"):
        check_packed(8, 16, good)


def test_k16_quantizer_and_packed_codes_cross_both_ways(tmp_path):
    n, m, k, ds = 300, 8, 16, 4
    cb, x = make_pq_data(91, n, m, k, ds)
    jpq = JPq(codebooks=j(cb))
    tpq = convert.from_jax_params(np.asarray(jpq.codebooks), device="cpu")
    # Packed by the port, decoded by the JAX package's packed kernel.
    codes = tpq.quantize_batch(t(x))
    packed = pack_u4_codes(codes)
    jrec = np.asarray(j_pq_decode(jpq.codebooks, j(packed.numpy()), packed=True, interpret=True))
    np.testing.assert_array_equal(jrec, tpq.reconstruct_batch(codes).numpy())
    # Packed by the JAX package, decoded by the port.
    jpacked = np.asarray(j_pack_u4_codes(jpq.quantize_batch(j(x))))
    assert jpacked.dtype == np.uint8
    trec = pq_decode(tpq.codebooks, t(jpacked), packed=True)
    np.testing.assert_array_equal(
        trec.numpy(), np.asarray(jpq.reconstruct_batch(j_unpack_u4_codes(j(jpacked)))))
    # The k=16 artifact crosses as any other, and the packed codes beside it
    # as a plain uint8 array.
    tio.save(tmp_path / "pq4.npz", tpq)
    np.save(tmp_path / "codes.u4.npy", packed.numpy())
    back = jio.load(tmp_path / "pq4.npz")
    np.testing.assert_array_equal(np.asarray(back.codebooks), cb)
    loaded = np.load(tmp_path / "codes.u4.npy")
    np.testing.assert_array_equal(
        np.asarray(j_unpack_u4_codes(j(loaded))), codes.numpy())
    cbs, prj = convert.to_numpy(tio.load(tmp_path / "pq4.npz", device="cpu"))
    np.testing.assert_array_equal(cbs, cb)
    assert prj is None
