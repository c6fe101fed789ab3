"""PQ decode, codes -> reconstructions: CUDA kernels and plain versions.

``out[i, j*ds:(j+1)*ds] = C_s[j, codes[i, j], :]``.  Counterpart of
``reductive_tpu.ops.decode.pq_decode`` (TPU kernels ``_decode_kernel`` and
``_decode_kernel_int8``); the kernels are in ``csrc/decode.cu``.

The JAX package restates decode as a multihot matrix product against the
codebook split into ``splits`` bfloat16 parts, because gathers are slow on
its device.  Every output element receives exactly one nonzero product, so
that product form equals a gather from the *effective* codebook
``C_s = p_0 + p_1 + ...`` (the parts added in f32, in order).  The wrapper
prepares ``C_s`` once and the kernel gathers from it: bit-equal to the
matrix-product form for every ``splits``.  ``splits=3`` reproduces the f32
codebook bit for bit, ``splits=1`` is the codebook rounded to bfloat16, and
``"int8"`` is the weight-only int8 mode (symmetric per-column quantizer).

``packed=True`` takes packed-u4 codes (``(n, m/2)`` bytes from
:func:`reductive_tpu_torch.ops.packing.pack_u4_codes`; ``k <= 16``, even
``m``).  The kernels read the bytes and take the nibbles apart themselves,
against the same tables in their natural order, so the result is bit-equal
to the unpacked decode of the unpacked codes.
"""

from __future__ import annotations

import numpy as np
import torch
from torch import Tensor

from . import _build
from .packing import check_packed, unpack_u4_codes

__all__ = [
    "pq_decode", "pq_decode_reference", "split_bf16", "effective_codebook",
    "quantize_codebook_int8",
]

_RECIP_127 = float(np.float32(1.0) / np.float32(127.0))


def split_bf16(W: Tensor, splits: int) -> Tensor:
    """Split an f32 tensor into ``splits`` stacked bfloat16 parts whose f32
    sum reconstructs it (exactly for ``splits=3``): each part is the running
    residual rounded to nearest even."""
    parts = []
    residual = W.to(torch.float32)
    for _ in range(splits):
        p = residual.to(torch.bfloat16)
        parts.append(p)
        residual = residual - p.to(torch.float32)
    return torch.stack(parts)


def effective_codebook(W: Tensor, splits: int) -> Tensor:
    """The f32 tensor a ``splits``-part product form reads its entries from:
    the bfloat16 parts of :func:`split_bf16` added in f32, first to last."""
    if splits not in (1, 2, 3):
        raise ValueError(f"splits must be 1, 2, 3 or 'int8', got {splits!r}")
    parts = split_bf16(W, splits).to(torch.float32)
    total = parts[0]
    for p in parts[1:]:
        total = total + p
    return total.contiguous()


def quantize_codebook_int8(codebooks: Tensor) -> tuple[Tensor, Tensor]:
    """Symmetric per-output-column int8 quantizer of the decode path:
    ``scale[j*ds + t] = max_c |C[j, c, t]| / 127`` and
    ``W8 = round(C / max(scale, 1e-30))`` (half to even).  Returns
    ``(W8 (m, k, ds) int8, scale (m*ds,) f32)``.

    The division by 127 is a multiplication by the f32 reciprocal: that is
    what XLA compiles the JAX package's ``/ 127.0`` to, and doing the same
    keeps the scales (and so the int8 matrix) equal to its bit for bit."""
    m, _, ds = codebooks.shape
    cb = codebooks.to(torch.float32)
    scale = cb.abs().amax(dim=1) * _RECIP_127  # (m, ds)
    w8 = torch.round(cb / torch.clamp(scale, min=1e-30)[:, None, :]).to(torch.int8)
    return w8.contiguous(), scale.reshape(m * ds).contiguous()


def _check(codebooks: Tensor, codes: Tensor, packed: bool) -> None:
    m, k, _ = codebooks.shape
    if packed:
        check_packed(m, k, codes)
    elif codes.ndim != 2 or codes.shape[1] != m:
        raise ValueError(
            f"Quantization length does not match number of subquantizers: "
            f"{tuple(codes.shape)} vs m={m}"
        )
    if codes.dtype.is_floating_point or codes.dtype == torch.bool:
        raise TypeError(f"codes must be of an integer dtype, got {codes.dtype}")
    if codebooks.device != codes.device:
        raise ValueError(f"codebooks on {codebooks.device}, codes on {codes.device}")


def _gather(table: Tensor, codes: Tensor) -> Tensor:
    m = table.shape[0]
    sub = torch.arange(m, device=table.device)
    return table[sub[None, :], codes.to(torch.int64)]  # (n, m, ds)


def pq_decode_reference(
    codebooks: Tensor, codes: Tensor, *, splits: int | str = 3, packed: bool = False
) -> Tensor:
    """Plain PyTorch version of :func:`pq_decode`: the same arithmetic in
    tensor operations, on whatever device the tensors lie.  Packed codes are
    unpacked first."""
    _check(codebooks, codes, packed)
    if packed:
        codes = unpack_u4_codes(codes)
    m, _, ds = codebooks.shape
    n = codes.shape[0]
    if splits == "int8":
        w8, scale = quantize_codebook_int8(codebooks)
        out = _gather(w8, codes).to(torch.float32).reshape(n, m * ds) * scale[None, :]
    else:
        out = _gather(effective_codebook(codebooks, splits), codes).reshape(n, m * ds)
    return out.to(codebooks.dtype)


def pq_decode(
    codebooks: Tensor, codes: Tensor, *, splits: int | str = 3, packed: bool = False,
    out: Tensor | None = None,
) -> Tensor:
    """Decode ``(n, m)`` codes (``(n, m/2)`` packed-u4 bytes with
    ``packed=True``) to ``(n, d)`` reconstructions.

    ``splits=3`` (default) is bit-exact against the f32 gather; ``splits=1``
    rounds the codebook to bfloat16; ``splits=2`` lies between;
    ``splits="int8"`` is the weight-only int8 mode.  CUDA tensors go through
    the kernel (f32 codebooks, ``ds`` a multiple of 4; anything else raises);
    CPU tensors through :func:`pq_decode_reference`.  ``out``, an ``(n, d)``
    f32 tensor on the same device, receives the result and is returned.
    """
    _check(codebooks, codes, packed)
    m, k, ds = codebooks.shape
    n = codes.shape[0]
    if out is not None and (
        out.shape != (n, m * ds) or out.dtype != codebooks.dtype or out.device != codes.device
    ):
        raise ValueError(
            f"out must be a {(n, m * ds)} tensor of {codebooks.dtype} on {codes.device}, "
            f"got {tuple(out.shape)} of {out.dtype} on {out.device}"
        )
    if not codes.is_cuda:
        res = pq_decode_reference(codebooks, codes, splits=splits, packed=packed)
        return res if out is None else out.copy_(res)

    if codebooks.dtype != torch.float32 or ds % 4 != 0:
        raise ValueError(
            f"the decode kernel takes float32 codebooks with ds a multiple of 4; got "
            f"{codebooks.dtype}, ds={ds} (use reductive_tpu_torch.pq.primitives.reconstruct_batch)"
        )
    if codes.dtype != torch.uint8:
        codes = codes.to(torch.uint8 if packed else torch.int32)
    codes = codes.contiguous()
    suffix = "_u4" if packed else ""
    raw = out if out is not None and out.is_contiguous() else torch.empty(
        (n, m * ds), dtype=torch.float32, device=codes.device
    )
    with torch.cuda.device(codes.device):
        stream = torch.cuda.current_stream().cuda_stream
        if splits == "int8":
            w8, scale = quantize_codebook_int8(codebooks)
            _build.launch(
                "rt_decode_int8", "decode_int8" + suffix,
                codes.data_ptr(), codes.element_size(), int(packed), w8.data_ptr(), scale.data_ptr(),
                raw.data_ptr(), n, m, k, ds, stream,
            )
        else:
            table = effective_codebook(codebooks, splits)
            _build.launch(
                "rt_decode", "decode" + suffix,
                codes.data_ptr(), codes.element_size(), int(packed), table.data_ptr(),
                raw.data_ptr(), n, m, k, ds, stream,
            )
    if out is None or raw is out:
        return raw
    return out.copy_(raw)
