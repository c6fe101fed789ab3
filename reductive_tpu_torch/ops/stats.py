"""Fused assign + statistics (one pass of Lloyd's): CUDA kernel and plain
version.

For ``x`` ``(n, d)`` and codebooks ``(m, k, ds)``: the nearest-centroid
assignment of :mod:`reductive_tpu_torch.ops.assign` (first index on ties),
then per-centroid sums ``(m, k, ds)`` of the rows assigned to each centroid
and their counts ``(m, k)``, both float32.  Counterpart of
``reductive_tpu.ops.stats.pq_assign_stats`` (TPU kernel ``_stats_kernel``);
the kernel is ``csrc/stats.cu``.

``compute_dtype`` means what it means for the encode: ``torch.float32``
assigns in real fp32 and sums the unrounded ``x``; ``torch.bfloat16``
assigns with ``x`` and ``2c`` rounded to bfloat16 and sums the **rounded**
``x`` in f32 (one rounded copy of ``x`` feeds both halves, as in the
reference).  Counts are exact integers in both modes.

The kernel uses no float atomics: every sum is taken in an order fixed by
the shapes, so two launches on the same inputs give the same bits.  The
kernel and the plain version agree on the counts except where f32 summation
order flips a near-tie, and on the sums up to f32 summation order.
"""

from __future__ import annotations

import torch
from torch import Tensor

from ..pq.primitives import nearest_centroids
from . import _build
from .assign import _KERNEL_DS, _KERNEL_MAX_K, _prepare

__all__ = ["pq_assign_stats", "pq_assign_stats_reference"]

# Rows the plain version takes at a time.
_REFERENCE_CHUNK = 1 << 16
# The kernel's grid is P blocks per subquantizer; P comes from the shapes
# alone (never from the card), so that the order of every sum, and with it
# the result's bits, is the same wherever the kernel runs.
_TARGET_BLOCKS = 1056
_MAX_PARTIAL_ELEMS = 1 << 26  # 256 MB of float32 scratch
_MIN_ROWS_PER_TILE = 256  # the fewest rows a block assigns at a time (f32 mode, ds = 32)


def pq_assign_stats_reference(
    codebooks: Tensor, x: Tensor, *, compute_dtype: torch.dtype = torch.float32
) -> tuple[Tensor, Tensor]:
    """Plain PyTorch version of :func:`pq_assign_stats`: the encode's plain
    version for the codes, then ``index_add_`` of ``x`` (of the
    bfloat16-rounded ``x`` in bf16 mode) and a ``bincount``, in chunks of
    rows so that nothing of size ``(n, m, k)`` exists."""
    cb2, c_sqn = _prepare(codebooks, x, torch.int32, compute_dtype)
    m, k, ds = codebooks.shape
    cell0 = torch.arange(m, device=x.device)[None, :] * k
    sums = torch.zeros((m * k, ds), dtype=torch.float32, device=x.device)
    counts = torch.zeros((m * k,), dtype=torch.int64, device=x.device)
    for i in range(0, x.shape[0], _REFERENCE_CHUNK):
        xc = x[i:i + _REFERENCE_CHUNK]
        if compute_dtype == torch.bfloat16:
            xc = xc.to(torch.bfloat16).to(torch.float32)
        xs = xc.reshape(xc.shape[0], m, ds)
        cells = (nearest_centroids(cb2, c_sqn, xs) + cell0).reshape(-1)
        sums.index_add_(0, cells, xs.reshape(-1, ds))
        counts += torch.bincount(cells, minlength=m * k)
    return sums.reshape(m, k, ds), counts.reshape(m, k).to(torch.float32)


def _blocks_per_subquantizer(n: int, m: int, k: int, ds: int) -> int:
    tiles = -(-n // _MIN_ROWS_PER_TILE)  # a block without a tile only writes zeros
    by_fill = -(-_TARGET_BLOCKS // m)
    by_scratch = _MAX_PARTIAL_ELEMS // (m * k * (ds + 1))
    return max(1, min(tiles, by_fill, by_scratch))


def pq_assign_stats(
    codebooks: Tensor, x: Tensor, *, compute_dtype: torch.dtype = torch.float32
) -> tuple[Tensor, Tensor]:
    """Per-centroid sums ``(m, k, ds)`` and counts ``(m, k)`` (float32) of
    the ``(n, d)`` rows of ``x`` under nearest-centroid assignment, in one
    pass over ``x``.

    CUDA tensors go through the kernel (``ds`` in 4, 8, 16, 32 and
    ``k <= 65536``; anything else raises a ``ValueError``: the trainers take
    ``use_kernel=False`` for such shapes); CPU tensors through
    :func:`pq_assign_stats_reference`.
    """
    if not x.is_cuda:
        return pq_assign_stats_reference(codebooks, x, compute_dtype=compute_dtype)

    cb2, c_sqn = _prepare(codebooks, x, torch.int32, compute_dtype)
    n = x.shape[0]
    m, k, ds = codebooks.shape
    if ds not in _KERNEL_DS or k > _KERNEL_MAX_K:
        raise ValueError(
            f"the assign+statistics kernel takes ds in {_KERNEL_DS} and k <= {_KERNEL_MAX_K}; "
            f"got m={m}, k={k}, ds={ds} (pass use_kernel=False to the trainer for the plain "
            f"tensor route)"
        )
    sums = torch.empty((m, k, ds), dtype=torch.float32, device=x.device)
    counts = torch.empty((m, k), dtype=torch.float32, device=x.device)
    if n == 0:
        return sums.zero_(), counts.zero_()
    x = x.contiguous()
    bf16 = compute_dtype == torch.bfloat16
    blocks = _blocks_per_subquantizer(n, m, k, ds)
    partial = torch.empty((blocks, m, k, ds + 1), dtype=torch.float32, device=x.device)
    with torch.cuda.device(x.device):
        _build.launch(
            "rt_assign_stats", "stats_bf16" if bf16 else "stats_f32",
            x.data_ptr(), cb2.data_ptr(), c_sqn.data_ptr(), partial.data_ptr(),
            sums.data_ptr(), counts.data_ptr(), n, m, k, ds, int(bf16), blocks,
            torch.cuda.current_stream().cuda_stream,
        )
    return sums, counts
