"""PQ encode / nearest-centroid assignment: CUDA kernel and plain version.

For every row and subquantizer: ``argmin_c (|c|^2 - 2 c.x_j)``, the first
index on ties.  Counterpart of ``reductive_tpu.ops.assign.pq_encode`` (TPU
kernel ``_encode_kernel``); the kernel is ``csrc/encode.cu``.

Two modes, chosen by ``compute_dtype``:

* ``torch.float32``: real fp32 multiply-adds, in the association the exact
  path (:func:`reductive_tpu_torch.pq.primitives.quantize_batch`) uses.  The
  JAX package's three-pass bf16 split stands in for fp32 that its matrix unit
  lacks and is not carried over.
* ``torch.bfloat16`` (default): ``x`` and ``2c`` each rounded to bfloat16
  (nearest even), products and sums in f32, ``|c|^2`` in f32 from the
  unrounded codebook.  The kernel runs this mode on the tensor cores and
  starts each sum at ``-|c|^2`` (it maximizes ``2c.x - |c|^2``), which is
  the same number up to f32 rounding.

The minimum is the true ``(distance, index)`` minimum; the JAX kernel's
packed sortable key, which coarsens ties, is not part of the contract.  The
kernel and the plain version agree except where f32 summation order flips a
near-tie.
"""

from __future__ import annotations

import torch
from torch import Tensor

from ..pq.primitives import check_code_dtype, nearest_centroids
from . import _build

__all__ = ["pq_encode", "pq_encode_reference", "assign_nearest"]

_KERNEL_DS = (4, 8, 16, 32)
_KERNEL_MAX_K = 65536


def _prepare(codebooks: Tensor, x: Tensor, dtype, compute_dtype):
    check_code_dtype(codebooks, dtype)
    if compute_dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"compute_dtype must be torch.float32 or torch.bfloat16, got {compute_dtype}")
    m, k, ds = codebooks.shape
    if x.ndim != 2 or x.shape[1] != m * ds:
        raise ValueError(
            f"Quantizer and vector length mismatch: input has {x.shape[-1]} columns, "
            f"quantizer reconstructs {m * ds}"
        )
    if codebooks.dtype != torch.float32 or x.dtype != torch.float32:
        raise TypeError(
            f"pq_encode takes float32 codebooks and vectors, got {codebooks.dtype} and {x.dtype}"
        )
    if codebooks.device != x.device:
        raise ValueError(f"codebooks on {codebooks.device}, x on {x.device}")
    c_sqn = torch.einsum("mkd,mkd->mk", codebooks, codebooks)
    cb2 = codebooks + codebooks
    if compute_dtype == torch.bfloat16:
        cb2 = cb2.to(torch.bfloat16).to(torch.float32)
    return cb2.contiguous(), c_sqn.contiguous()


def pq_encode_reference(
    codebooks: Tensor, x: Tensor, *, dtype: torch.dtype = torch.uint8,
    compute_dtype: torch.dtype = torch.bfloat16,
) -> Tensor:
    """Plain PyTorch version of :func:`pq_encode`: the same arithmetic in
    tensor operations, on whatever device the tensors lie."""
    cb2, c_sqn = _prepare(codebooks, x, dtype, compute_dtype)
    if compute_dtype == torch.bfloat16:
        x = x.to(torch.bfloat16).to(torch.float32)
    m, _, ds = codebooks.shape
    return nearest_centroids(cb2, c_sqn, x.reshape(x.shape[0], m, ds)).to(dtype)


def pq_encode(
    codebooks: Tensor, x: Tensor, *, dtype: torch.dtype = torch.uint8,
    compute_dtype: torch.dtype = torch.bfloat16, out: Tensor | None = None,
) -> Tensor:
    """Encode ``(n, d)`` vectors to ``(n, m)`` codes of ``dtype``.

    CUDA tensors go through the kernel (``ds`` in 4, 8, 16, 32 and
    ``k <= 65536``; anything else raises); CPU tensors through
    :func:`pq_encode_reference`.  The kernel writes ``uint8`` or ``int32``
    codes; other integer dtypes are cast from ``int32`` at the end.  ``out``,
    an ``(n, m)`` tensor of ``dtype`` on the same device, receives the codes
    and is returned.
    """
    cb2, c_sqn = _prepare(codebooks, x, dtype, compute_dtype)
    n = x.shape[0]
    m, k, ds = codebooks.shape
    if out is not None and (out.shape != (n, m) or out.dtype != dtype or out.device != x.device):
        raise ValueError(
            f"out must be a {(n, m)} tensor of {dtype} on {x.device}, "
            f"got {tuple(out.shape)} of {out.dtype} on {out.device}"
        )
    if not x.is_cuda:
        codes = pq_encode_reference(codebooks, x, dtype=dtype, compute_dtype=compute_dtype)
        return codes if out is None else out.copy_(codes)

    if ds not in _KERNEL_DS or k > _KERNEL_MAX_K:
        raise ValueError(
            f"the encode kernel takes ds in {_KERNEL_DS} and k <= {_KERNEL_MAX_K}; "
            f"got m={m}, k={k}, ds={ds} (use reductive_tpu_torch.pq.primitives.quantize_batch)"
        )
    x = x.contiguous()
    direct = dtype in (torch.uint8, torch.int32)
    if direct and out is not None and out.is_contiguous():
        raw = out
    else:
        raw = torch.empty((n, m), dtype=dtype if direct else torch.int32, device=x.device)
    bf16 = compute_dtype == torch.bfloat16
    with torch.cuda.device(x.device):
        _build.launch(
            "rt_encode", "encode_bf16" if bf16 else "encode_f32",
            x.data_ptr(), cb2.data_ptr(), c_sqn.data_ptr(), raw.data_ptr(),
            n, m, k, ds, int(bf16), int(raw.dtype == torch.uint8),
            torch.cuda.current_stream().cuda_stream,
        )
    if out is None:
        return raw if direct else raw.to(dtype)
    return out if raw is out else out.copy_(raw)


def assign_nearest(
    centroids: Tensor, x: Tensor, *, compute_dtype: torch.dtype = torch.bfloat16
) -> Tensor:
    """Nearest-centroid assignment (the k-means assign step): PQ encode with
    a single subquantizer.  Returns ``(n,)`` int32."""
    return pq_encode(centroids[None, :, :], x, dtype=torch.int32, compute_dtype=compute_dtype)[:, 0]
