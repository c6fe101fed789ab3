"""PQ decode, codes -> reconstructions: CUDA kernels and plain versions.

``out[i, j*ds:(j+1)*ds] = C_s[j, codes[i, j], :]``.  Counterpart of
``reductive_tpu.ops.decode.pq_decode`` (TPU kernels ``_decode_kernel`` and
``_decode_kernel_int8``); the kernels are in ``csrc/decode.cu``.

The JAX package restates decode as a multihot matrix product against the
codebook split into ``splits`` bfloat16 parts, because gathers are slow on
its device.  Every output element receives exactly one nonzero product, so
that product form equals a gather from the *effective* codebook
``C_s = p_0 + p_1 + ...`` (the parts added in f32, in order).  The wrapper
builds ``C_s`` once a call (one launch on the card, :func:`decode_table`) and
the kernel gathers from it: bit-equal to the
matrix-product form for every ``splits``.  ``splits=3`` reproduces every
normal f32 value of the codebook (not subnormals, and near +-FLT_MAX the first
part rounds to inf and the entry becomes NaN, in the JAX package as here),
``splits=1`` is the codebook rounded to bfloat16, and ``"int8"`` is the
weight-only int8 mode (symmetric per-column quantizer).

At a ``ds`` that is not a multiple of 4 the kernels gather row tiles
(:func:`decode_tile_plan`): a tile's output is one contiguous run written 16
bytes a thread, with the table in shared memory where it fits, else a group of
subquantizers a block, else read from L2.  Any contiguous ``out`` is taken: at
a multiple of 4 one off 16 bytes is written through an aligned buffer.

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
    "quantize_codebook_int8", "decode_table", "decode_tile_plan", "decode_group_plan",
    "decode_tile_smem",
    "launch_decode",
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


# The row-tile kernels (ds not a multiple of 4): a tile aims at this many
# output floats and stages at most this many bytes of codes; a block's shared
# memory (the table or a group's part of it, and the codes tile) stays within
# the budget of its table's type.  On an H100 int8 tables run faster as more,
# smaller blocks (at d=300, k=256, ds=2 a group of 75 subquantizers, 50 KB,
# 1.24 ms against 1.51 for the whole 78 KB table: tools/time_decode_kernels.py),
# f32 tables as fewer, wider groups.
_TILE_FLOATS = 8192
_TILE_CODE_BYTES = 16384
_TILE_SHARED_BYTES = {False: 100 * 1024, True: 64 * 1024}  # by int8


def _align16(b: int) -> int:
    return (b + 15) // 16 * 16


def _tile_rows(width: int, row_bytes: int) -> int:
    rows = -(-_TILE_FLOATS // width)
    rows = -(-rows // 16) * 16
    cap = max(1, _TILE_CODE_BYTES // row_bytes)
    return min(rows, cap // 16 * 16 if cap >= 16 else cap)


def decode_tile_smem(m: int, k: int, ds: int, row_bytes: int, int8: bool, rows: int,
                     group: int) -> int:
    """Bytes of shared memory a block of the row-tile kernels takes (the C
    entry's ``tile_smem``): the codes of ``rows`` rows, and the whole table
    (``group == m``; int8 scales first), a group's part of it with its column
    map (``0 < group < m``), or nothing of it (``group == 0``)."""
    codes = rows * row_bytes
    elt = 1 if int8 else 4
    if group == 0:
        return codes
    if group >= m:
        return codes + (_align16(4 * m * ds) if int8 else 0) + _align16(elt * m * k * ds)
    width = group * ds
    return codes + _align16(4 * width * (3 if int8 else 2)) + _align16(elt * width * k)


def decode_tile_plan(m: int, k: int, ds: int, code_bytes: int, packed: bool,
                     int8: bool) -> tuple[int, int]:
    """``(rows, group)`` of the row-tile kernels of ``csrc/decode.cu`` (any
    ``ds`` not a multiple of 4): rows a tile (a multiple of 16 near
    ``_TILE_FLOATS`` floats of output, fewer where ``_TILE_CODE_BYTES`` would
    not hold their codes), and the subquantizers whose table a block stages in
    shared memory: ``m`` where the whole table fits ``_TILE_SHARED_BYTES``
    beside the codes tile (``decode_tile_kernel``), else as many as fit
    (``decode_group_kernel``, :func:`decode_group_plan`), else 0 (the table is
    read from L2).  ``code_bytes``: 1 (uint8 or packed) or 4 (int32).  The C
    entry takes both as it is given them."""
    row_bytes = m // 2 if packed else m * code_bytes
    rows = _tile_rows(m * ds, row_bytes)
    if decode_tile_smem(m, k, ds, row_bytes, int8, rows, m) <= _TILE_SHARED_BYTES[int8]:
        return rows, m
    return decode_group_plan(m, k, ds, row_bytes, int8)


def decode_group_plan(m: int, k: int, ds: int, row_bytes: int, int8: bool) -> tuple[int, int]:
    """``(rows, group)`` of ``decode_group_kernel``: as many subquantizers a
    block as ``_TILE_SHARED_BYTES`` holds (with a codes tile), spread
    evenly over the groups; ``group`` 0 where not even one fits."""
    budget = _TILE_SHARED_BYTES[int8]

    def fits(g):
        return decode_tile_smem(m, k, ds, row_bytes, int8, _tile_rows(g * ds, row_bytes),
                                g) <= budget

    # The table's share of the budget, then down to what fits with its codes.
    group = min(m - 1, budget // (ds * k * (1 if int8 else 4)))
    while group >= 1 and not fits(group):
        group -= 1
    if group < 1:
        return _tile_rows(m * ds, row_bytes), 0
    group = -(-m // -(-m // group))  # the same width for every group
    return _tile_rows(group * ds, row_bytes), group


def _check_splits(splits) -> None:
    if splits != "int8" and splits not in (1, 2, 3):
        raise ValueError(f"splits must be 1, 2, 3 or 'int8', got {splits!r}")


def decode_table(codebooks: Tensor, splits: int | str = 3) -> tuple[Tensor, ...]:
    """The table the decode kernels gather from: ``(C_s,)`` of
    :func:`effective_codebook` for ``splits`` 1, 2, 3, ``(W8, scale)`` of
    :func:`quantize_codebook_int8` for ``"int8"``.  On the card one launch
    builds it (``rt_decode_prepare``), bit for bit the plain version, which CPU
    tensors take."""
    _check_splits(splits)
    cb = codebooks.to(torch.float32).contiguous()
    if not cb.is_cuda:
        if splits == "int8":
            return quantize_codebook_int8(cb)
        return (effective_codebook(cb, splits),)
    m, k, ds = cb.shape
    with torch.cuda.device(cb.device):
        stream = torch.cuda.current_stream().cuda_stream
        if splits == "int8":
            w8 = torch.empty((m, k, ds), dtype=torch.int8, device=cb.device)
            scale = torch.empty((m * ds,), dtype=torch.float32, device=cb.device)
            _build.launch("rt_decode_prepare", None, cb.data_ptr(), 0, None, w8.data_ptr(),
                          scale.data_ptr(), m, k, ds, stream)
            return w8, scale
        table = torch.empty_like(cb)
        _build.launch("rt_decode_prepare", None, cb.data_ptr(), splits, table.data_ptr(), None,
                      None, m, k, ds, stream)
        return (table,)


def launch_decode(table: tuple[Tensor, ...], codes: Tensor, out: Tensor, *,
                  packed: bool = False, plan: tuple[int, int] | None = None) -> None:
    """One launch of the decode kernel into ``out`` (``(n, d)`` f32,
    contiguous; on 16 bytes where ``ds`` is a multiple of 4) from a table of
    :func:`decode_table` and ``(n, m)`` uint8 or int32 codes (``(n, m/2)``
    bytes packed), all on the card.  ``plan`` replaces
    :func:`decode_tile_plan`'s ``(rows, group)``.  Counted under ``decode`` /
    ``decode_int8``, ``_u4`` for packed codes, ``_scalar`` at a ``ds`` not a
    multiple of 4."""
    m, k, ds = table[0].shape
    n = codes.shape[0]
    int8 = len(table) == 2
    suffix = ("_u4" if packed else "") + ("" if ds % 4 == 0 else "_scalar")
    if plan is None:
        plan = decode_tile_plan(m, k, ds, codes.element_size(), packed, int8)
    rows, group = plan
    with torch.cuda.device(codes.device):
        stream = torch.cuda.current_stream().cuda_stream
        if int8:
            w8, scale = table
            _build.launch(
                "rt_decode_int8", "decode_int8" + suffix,
                codes.data_ptr(), codes.element_size(), int(packed), w8.data_ptr(),
                scale.data_ptr(), out.data_ptr(), n, m, k, ds, rows, group, stream,
            )
        else:
            _build.launch(
                "rt_decode", "decode" + suffix,
                codes.data_ptr(), codes.element_size(), int(packed), table[0].data_ptr(),
                out.data_ptr(), n, m, k, ds, rows, group, stream,
            )


def pq_decode(
    codebooks: Tensor, codes: Tensor, *, splits: int | str = 3, packed: bool = False,
    out: Tensor | None = None,
) -> Tensor:
    """Decode ``(n, m)`` codes (``(n, m/2)`` packed-u4 bytes with
    ``packed=True``) to ``(n, d)`` reconstructions.

    ``splits=3`` (default) is bit-exact against the f32 gather; ``splits=1``
    rounds the codebook to bfloat16; ``splits=2`` lies between;
    ``splits="int8"`` is the weight-only int8 mode.  CUDA tensors go through
    the kernel (f32 codebooks, any ``ds``: 16 bytes a thread where ``ds`` is
    a multiple of 4, the row-tile kernel otherwise; another dtype raises),
    after one launch that builds the table (:func:`decode_table`); CPU
    tensors through :func:`pq_decode_reference`.  ``out``, an ``(n, d)`` f32
    tensor on the same device, receives the result and is returned; the
    kernels write into it directly where it is contiguous (and, where ``ds``
    is a multiple of 4, on 16 bytes), else through a buffer.
    """
    _check(codebooks, codes, packed)
    _check_splits(splits)
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

    if codebooks.dtype != torch.float32:
        raise ValueError(
            f"the decode kernel takes float32 codebooks; got {codebooks.dtype} "
            f"(use reductive_tpu_torch.pq.primitives.reconstruct_batch)"
        )
    if codes.dtype != torch.uint8:
        codes = codes.to(torch.uint8 if packed else torch.int32)
    codes = codes.contiguous()
    direct = out is not None and out.is_contiguous() and (
        ds % 4 != 0 or out.data_ptr() % 16 == 0
    )
    raw = out if direct else torch.empty((n, m * ds), dtype=torch.float32, device=codes.device)
    launch_decode(decode_table(codebooks, splits), codes, raw, packed=packed)
    if out is None or raw is out:
        return raw
    return out.copy_(raw)
