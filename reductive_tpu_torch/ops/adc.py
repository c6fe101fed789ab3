"""ADC scoring, lookup tables x codes -> scores: CUDA kernels and plain versions.

``score[q, i] = sum_j T_s[q, j, codes[i, j]]``, returned ``(nq, n)`` f32.
Counterpart of ``reductive_tpu.ops.adc.adc_scores_kernel`` (TPU kernels
``_adc_kernel`` and, for ``splits="int8"``, ``_decode_kernel_int8``); the
kernels are in ``csrc/adc.cu``.

``T_s`` is the table rounded to a sum of ``splits`` bfloat16 parts (3: the
table itself; 2 and 1: rounded), prepared once by the wrapper.  The JAX
kernel sums over ``j`` inside each part and then over the parts; here the sum
over ``j`` is taken once, in the order ``j = 0..m-1``.  The difference is f32
association, a few ulps of the score.  ``splits="int8"`` is the 8-bit table
mode: one scale per query, per-table minima folded into an additive offset,
int32 sum, ``score = float(sum) * scale[q] + offset[q]``.

``packed=True`` takes packed-u4 codes (``(n, m/2)`` bytes from
:func:`reductive_tpu_torch.ops.packing.pack_u4_codes`; ``k <= 16``, even
``m``): the kernel takes both nibbles of each byte, low then high, so the
sum keeps its order and the scores are bit-equal to the unpacked kernel's on
the unpacked codes, at half the code bytes read and held.
"""

from __future__ import annotations

import numpy as np
import torch
from torch import Tensor

from . import _build
from .decode import effective_codebook
from .packing import check_packed, unpack_u4_codes

__all__ = [
    "adc_scores_kernel", "adc_scores_reference", "quantize_tables_int8",
    "max_query_batch", "query_tile",
]

# Shared memory one block may use on Hopper (232,448 bytes of the SM's 256 KB).
_SMEM_BYTES = 227 * 1024
_GRID_Y_MAX = 65535
_RECIP_255 = float(np.float32(1.0) / np.float32(255.0))


def query_tile(m: int, k: int, splits=2) -> int:
    """Queries whose tables one block holds in shared memory: the largest of
    8, 4, 2, 1 that fits (``m*k`` entries a query, 4 bytes each, 1 for
    ``"int8"``).  0 when not even one query's tables fit."""
    itemsize = 1 if splits == "int8" else 4
    for qt in (8, 4, 2, 1):
        if qt * m * k * itemsize <= _SMEM_BYTES:
            return qt
    return 0


def max_query_batch(m: int, k: int, splits=2) -> int:
    """Largest query batch one call of the kernel takes.  The kernel tiles
    the queries itself (:func:`query_tile` a block, over the grid's second
    axis), so this is the grid's extent, not a memory fit: 65535 tiles.
    ``search`` batches above it, so any ``nq`` works."""
    return _GRID_Y_MAX * query_tile(m, k, splits)


def quantize_tables_int8(tables: Tensor) -> tuple[Tensor, Tensor, Tensor]:
    """Affine per-query int8 quantizer of the ADC tables.  One scale per
    query (the widest ``max - min`` of its ``m`` tables over 255); each
    table's minimum is subtracted, which shifts every score of the query by
    a constant that the offset adds back: ``offset = sum_j min_j + 128*m*scale``
    (the ``-128`` shift centres the range on int8).  Rounding is half to
    even.  The division by 255 is a multiplication by the f32 reciprocal, as
    XLA compiles the JAX package's ``/ 255.0``; the division by the scale is
    a division.  Returns ``(T8 (nq, m, k) int8, scale (nq,), offset (nq,))``."""
    m = tables.shape[1]
    t_min = tables.amin(dim=2, keepdim=True)  # (nq, m, 1)
    t_max = tables.amax(dim=2, keepdim=True)
    scale = torch.clamp((t_max - t_min)[:, :, 0].amax(dim=1) * _RECIP_255, min=1e-30)  # (nq,)
    q = torch.round((tables - t_min) / scale[:, None, None]) - 128.0
    t8 = torch.clamp(q, -128, 127).to(torch.int8)
    min_sum = t_min[:, 0, 0]
    for j in range(1, m):  # in order, so that the offset does not depend on the device
        min_sum = min_sum + t_min[:, j, 0]
    offset = min_sum + 128.0 * m * scale
    return t8.contiguous(), scale.contiguous(), offset.contiguous()


def _check(tables: Tensor, codes: Tensor, packed: bool) -> None:
    if tables.ndim != 3:
        raise ValueError(f"tables must be (nq, m, k), got {tuple(tables.shape)}")
    _, m, k = tables.shape
    if packed:
        check_packed(m, k, codes)
    elif codes.ndim != 2 or codes.shape[1] != m:
        raise ValueError(f"codes have shape {tuple(codes.shape)}, expected (n, {m})")
    if codes.dtype.is_floating_point or codes.dtype == torch.bool:
        raise TypeError(f"codes must be of an integer dtype, got {codes.dtype}")
    if tables.device != codes.device:
        raise ValueError(f"tables on {tables.device}, codes on {codes.device}")


def _lookup_sum(table: Tensor, codes: Tensor) -> Tensor:
    """``sum_j table[:, j, codes[:, j]]`` added in the order ``j = 0..m-1``."""
    idx = codes.to(torch.int64)
    acc = table[:, 0, idx[:, 0]]
    for j in range(1, table.shape[1]):
        acc = acc + table[:, j, idx[:, j]]
    return acc


def adc_scores_reference(
    tables: Tensor, codes: Tensor, *, splits: int | str = 2, packed: bool = False
) -> Tensor:
    """Plain PyTorch version of :func:`adc_scores_kernel`: the same
    arithmetic, in the same order, in tensor operations.  Packed codes are
    unpacked first."""
    _check(tables, codes, packed)
    if packed:
        codes = unpack_u4_codes(codes)
    tables = tables.to(torch.float32)
    if splits == "int8":
        t8, scale, offset = quantize_tables_int8(tables)
        acc = _lookup_sum(t8.to(torch.int32), codes)
        return acc.to(torch.float32) * scale[:, None] + offset[:, None]
    return _lookup_sum(effective_codebook(tables, splits), codes)


def adc_scores_kernel(
    tables: Tensor, codes: Tensor, *, splits: int | str = 2, packed: bool = False
) -> Tensor:
    """ADC scores for every (query, database vector) pair.

    ``tables`` is ``(nq, m, k)`` from :func:`reductive_tpu_torch.search.adc_tables`,
    ``codes`` is ``(n, m)``, or ``(n, m/2)`` packed-u4 bytes with
    ``packed=True``; returns ``(nq, n)`` f32.  ``splits=3`` carries
    no table error, ``splits=2`` (default) about 2^-18 relative,
    ``splits=1`` about 2^-9, ``splits="int8"`` is the 8-bit table mode.
    CUDA tensors go through the kernel, which takes any ``nq`` up to
    :func:`max_query_batch` and raises when one query's tables outgrow
    shared memory; CPU tensors through :func:`adc_scores_reference`.
    """
    _check(tables, codes, packed)
    if not codes.is_cuda:
        return adc_scores_reference(tables, codes, splits=splits, packed=packed)

    nq, m, k = tables.shape
    n = codes.shape[0]
    qt = query_tile(m, k, splits)
    if qt == 0:
        raise ValueError(
            f"no shared-memory tiling for m={m}, k={k}, splits={splits}: one query's tables "
            "exceed a block's shared memory; use the einsum scorer "
            "(reductive_tpu_torch.search.adc_scores)"
        )
    if nq > _GRID_Y_MAX * qt:
        raise ValueError(f"nq={nq} exceeds max_query_batch={_GRID_Y_MAX * qt}; batch the queries")
    if nq == 0:
        raise ValueError("tables hold no query")
    tables = tables.to(torch.float32)
    if codes.dtype != torch.uint8:
        codes = codes.to(torch.uint8 if packed else torch.int32)
    codes = codes.contiguous()
    suffix = "_u4" if packed else ""
    out = torch.empty((nq, n), dtype=torch.float32, device=codes.device)
    props = torch.cuda.get_device_properties(codes.device)
    row_blocks = max(1, min(-(-n // 1024), props.multi_processor_count))
    with torch.cuda.device(codes.device):
        stream = torch.cuda.current_stream().cuda_stream
        if splits == "int8":
            t8, scale, offset = quantize_tables_int8(tables)
            _build.launch(
                "rt_adc_int8", "adc_int8" + suffix,
                t8.data_ptr(), scale.data_ptr(), offset.data_ptr(), codes.data_ptr(),
                codes.element_size(), int(packed), out.data_ptr(), n, nq, m, k, qt, row_blocks, stream,
            )
        else:
            table = effective_codebook(tables, splits)
            _build.launch(
                "rt_adc", "adc" + suffix,
                table.data_ptr(), codes.data_ptr(), codes.element_size(), int(packed),
                out.data_ptr(),
                n, nq, m, k, qt, row_blocks, stream,
            )
    return out
