"""The CUDA kernels against their plain PyTorch versions, on a GPU.

These tests need an NVIDIA GPU and ``nvcc``; elsewhere they skip.  Run them
on the card with

    python -m pytest tests/test_torch_cuda_kernels.py -q --noconftest

They cover the corners ``chip_smoke.py`` does not drive: k above one
centroid tile, k that is no power of two, every ds the encode kernel takes,
int32 codes, a number of subquantizers that is no multiple of four, and
tables so large that fewer than eight queries share a block.
"""

import pytest
import torch

from reductive_tpu_torch import ops

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.device("cuda")


def _data(dev, n, m, k, ds, seed=0):
    gen = torch.Generator(device=dev).manual_seed(seed)
    cb = torch.randn((m, k, ds), generator=gen, device=dev)
    x = torch.randn((n, m * ds), generator=gen, device=dev)
    return cb, x


@pytest.mark.parametrize("compute_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize(
    "n,m,k,ds", [(1000, 3, 7, 4), (4097, 16, 256, 8), (777, 2, 1000, 16), (513, 5, 300, 32)]
)
def test_encode_kernel_equals_plain(dev, n, m, k, ds, compute_dtype):
    cb, x = _data(dev, n, m, k, ds)
    got = ops.pq_encode(cb, x, dtype=torch.int32, compute_dtype=compute_dtype)
    want = ops.pq_encode_reference(cb, x, dtype=torch.int32, compute_dtype=compute_dtype)
    # f32 summation order may flip a near-tie: at most one code in a thousand.
    assert int((got != want).sum()) <= got.numel() // 1000
    narrow = ops.pq_encode(cb, x, dtype=torch.int16, compute_dtype=compute_dtype)
    assert narrow.dtype == torch.int16 and torch.equal(narrow.to(torch.int32), got)
    if k <= 256:
        u8 = ops.pq_encode(cb, x, compute_dtype=compute_dtype)
        assert u8.dtype == torch.uint8 and torch.equal(u8.to(torch.int32), got)


@pytest.mark.parametrize("splits", [1, 2, 3, "int8"])
@pytest.mark.parametrize("code_dtype", [torch.uint8, torch.int32, torch.int64])
@pytest.mark.parametrize("n,m,k,ds", [(1000, 3, 7, 4), (4097, 16, 256, 8), (513, 24, 256, 32)])
def test_decode_kernel_equals_plain(dev, n, m, k, ds, code_dtype, splits):
    cb, _ = _data(dev, n, m, k, ds)
    codes = torch.randint(0, k, (n, m), device=dev).to(code_dtype)
    got = ops.pq_decode(cb, codes, splits=splits)
    assert torch.equal(got, ops.pq_decode_reference(cb, codes, splits=splits))
    out = torch.empty_like(got)
    assert ops.pq_decode(cb, codes, splits=splits, out=out) is out and torch.equal(out, got)


@pytest.mark.parametrize("splits", [1, 2, 3, "int8"])
@pytest.mark.parametrize("code_dtype", [torch.uint8, torch.int32])
@pytest.mark.parametrize(
    "n,m,k,nq", [(1000, 3, 7, 5), (4097, 16, 256, 16), (2000, 24, 256, 130), (999, 64, 256, 9),
                 (999, 200, 256, 3)]
)
def test_adc_kernel_equals_plain(dev, n, m, k, nq, code_dtype, splits):
    gen = torch.Generator(device=dev).manual_seed(1)
    tables = torch.randn((nq, m, k), generator=gen, device=dev) * 10
    codes = torch.randint(0, k, (n, m), device=dev).to(code_dtype)
    got = ops.adc_scores_kernel(tables, codes, splits=splits)
    want = ops.adc_scores_reference(tables, codes, splits=splits)
    # Both add the m entries in the order j = 0..m-1.
    assert torch.equal(got, want)


def test_kernels_refuse_what_they_do_not_take(dev):
    cb, x = _data(dev, 10, 2, 4, 5)
    with pytest.raises(ValueError, match="encode kernel takes"):
        ops.pq_encode(cb, x)
    with pytest.raises(ValueError, match="decode kernel takes"):
        ops.pq_decode(cb, torch.zeros((10, 2), dtype=torch.uint8, device=dev))
    with pytest.raises(ValueError, match="no shared-memory tiling"):
        ops.adc_scores_kernel(torch.zeros((1, 1, 70000), device=dev),
                              torch.zeros((4, 1), dtype=torch.int32, device=dev))
