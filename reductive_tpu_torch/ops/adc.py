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

The f32 kernel's launch plan is :func:`adc_plan`, a function of the shapes:
lanes over queries; each table entry stored once for each row of a load's
phase where 32 copies of the tables fit, or else once, with each lane lagging
its rows' codes by its row's place in the phase (both: no bank conflicts);
and a persistent grid that fills each block's tables once.  The int8
kernel's is :func:`adc_int8_plan`: one byte an entry, so up to 32 queries a
block, copies where 128 bytes of them fit (no bank conflicts), else each
entry once.  On the card the tables are built by one launch each:
:func:`adc_table_int8`, and for the f32 kernel
:func:`reductive_tpu_torch.ops.decode.decode_table`; :func:`adc_launcher`
launches either kernel on them.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import numpy as np
import torch
from torch import Tensor

from . import _build
from .decode import decode_table, effective_codebook
from .packing import check_packed, unpack_u4_codes

__all__ = [
    "adc_scores_kernel", "adc_scores_reference", "quantize_tables_int8", "adc_table_int8",
    "max_query_batch", "query_tile", "AdcPlan", "adc_plan", "adc_int8_plan", "adc_launcher",
]

# Shared memory one block may use on Hopper (232,448 bytes of the SM's 256 KB).
_SMEM_BYTES = 227 * 1024
# Shared memory of one SM, and what the system keeps of it for each block.
_SM_SMEM_BYTES = 228 * 1024
_BLOCK_RESERVED_BYTES = 1024
_GRID_Y_MAX = 65535
_RECIP_255 = float(np.float32(1.0) / np.float32(255.0))
# The f32 kernel (csrc/adc.cu adc_f32_kernel): at most two blocks an SM (its
# __launch_bounds__), a block's rows start on a multiple of 64, at most 32
# queries a block.
_F32_MAX_BLOCKS_PER_SM = 2
_F32_ROW_ALIGN = 64
_F32_MAX_QUERIES = 32
_H100_SMS = 132
# The int8 kernel (csrc/adc.cu adc_i8_kernel): one byte an entry, 128 bytes of
# copies an entry where they fit (one for each row of a load's phase), at
# least 4 and at most 32 queries a block where it can (1 and 2 only where 4
# queries' tables do not fit), 256 bytes of scales and offsets after the tables.
_I8_COPY_BYTES = 128
_I8_MIN_QUERIES = 4
_I8_TAIL_BYTES = 256


class AdcPlan(NamedTuple):
    """How an ADC kernel is launched (:func:`adc_plan`, :func:`adc_int8_plan`)."""

    queries: int          # QT: queries whose tables a block holds
    replicas: int         # copies of each entry: 1, or one for each row of a load's phase
    skew: bool            # f32: lanes lag their rows' codes (no bank conflicts at R = 1)
    rows_per_load: int    # rows one warp load serves: 32 // (lanes a row)
    query_tiles: int      # the grid's second axis
    blocks: int           # blocks per query tile, each over one range of rows
    rows_per_block: int
    threads: int          # a block's: 1,024 at one block an SM, else 512
    smem_bytes: int
    blocks_per_sm: int


def _pow2_at_least(x: int) -> int:
    return 1 << max(0, (x - 1).bit_length())


@functools.lru_cache(maxsize=256)
def adc_plan(n: int, nq: int, m: int, k: int, packed: bool = False, *,
             sms: int = _H100_SMS) -> AdcPlan:
    """The launch plan of the f32 ADC kernel (``csrc/adc.cu``
    ``adc_f32_kernel``) for ``nq`` queries over ``n`` rows of ``m`` codes
    below ``k`` (``packed``: two u4 codes a byte, ``k <= 16``, even ``m``).

    Where 32 copies of the tables' floats fit a block (``128*m*k`` bytes:
    every ``k <= 16`` up to m = 113), a block holds ``QT`` = the least power
    of two that covers ``nq`` (at most 32) queries, each entry stored
    ``32 // QT`` times, one copy for each row of a load's phase: no bank
    conflicts.  Elsewhere each entry is stored once and ``QT`` is the largest
    power of two up to that cover whose tables fit; at ``QT`` = 8 or 16 with
    ``m % 4 == 0`` (uint8 codes, unpacked) the lanes lag their rows' codes by
    their row's place in a phase (``skew``), which makes those lookups free
    of conflicts too.  Blocks: as many as are resident at once (two of 512
    threads an SM where their shared memory allows, else one of 1,024),
    shared among the query tiles, each over a range of rows that is a multiple
    of 64 (none empty).  ``sms`` is the card's multiprocessors; no score
    depends on the plan.  Raises ``ValueError`` when one query's tables
    outgrow a block."""
    if packed and (k > 16 or m % 2):
        raise ValueError(f"packed codes need k <= 16 and an even m, got m={m}, k={k}")
    if nq <= 0 or m <= 0 or k <= 0 or n < 0:
        raise ValueError(f"no ADC plan for n={n}, nq={nq}, m={m}, k={k}")
    entry = m * k * 4  # bytes of one query's tables
    if entry > _SMEM_BYTES:
        raise ValueError(
            f"no shared-memory tiling for m={m}, k={k}: one query's tables exceed a block's "
            "shared memory; use the einsum scorer (reductive_tpu_torch.search.adc_scores)"
        )
    cover = min(_F32_MAX_QUERIES, _pow2_at_least(nq))
    if _F32_MAX_QUERIES * entry <= _SMEM_BYTES:
        qt, replicas = cover, _F32_MAX_QUERIES // cover
    else:
        qt, replicas = cover, 1
        while qt * entry > _SMEM_BYTES:
            qt //= 2
    skew = replicas == 1 and qt in (8, 16) and m % 4 == 0 and not packed
    return _grid_plan(n, nq, qt, replicas, skew, 32 // (qt // min(qt, 4)),
                      replicas * qt * entry, sms)


def _grid_plan(n: int, nq: int, qt: int, replicas: int, skew: bool, rows_per_load: int,
               smem: int, sms: int) -> AdcPlan:
    """The persistent grid both ADC kernels take: as many blocks as are
    resident at once (two of 512 threads an SM where their shared memory
    allows, else one of 1,024), shared among the query tiles, each over a
    range of rows that is a multiple of 64 (none empty)."""
    per_sm = max(1, min(_F32_MAX_BLOCKS_PER_SM,
                        _SM_SMEM_BYTES // (smem + _BLOCK_RESERVED_BYTES)))
    tiles = -(-nq // qt)
    blocks = max(1, min(sms * per_sm // tiles, -(-n // _F32_ROW_ALIGN)))
    per_block = -(-n // blocks)
    rows = max(_F32_ROW_ALIGN, -(-per_block // _F32_ROW_ALIGN) * _F32_ROW_ALIGN)
    blocks = max(1, -(-n // rows))
    threads = 1024 if per_sm == 1 else 512
    return AdcPlan(qt, replicas, skew, rows_per_load, tiles, blocks, rows, threads, smem, per_sm)


def _int8_smem(qt: int, replicas: int, m: int, k: int) -> int:
    """Shared memory of the int8 kernel (the C entry's ``i8_smem``): the
    tables, QT bytes an entry and ``replicas`` copies, on 16 bytes, then the
    scales and offsets."""
    return -(-(replicas * qt * m * k) // 16) * 16 + _I8_TAIL_BYTES


@functools.lru_cache(maxsize=256)
def adc_int8_plan(n: int, nq: int, m: int, k: int, packed: bool = False, *,
                  sms: int = _H100_SMS) -> AdcPlan:
    """The launch plan of the int8 ADC kernel (``csrc/adc.cu``
    ``adc_i8_kernel``) for ``nq`` queries over ``n`` rows of ``m`` codes below
    ``k`` (``packed``: two u4 codes a byte, ``k <= 16``, even ``m``).

    A block holds ``QT`` = the least power of two that covers ``nq``, at least
    4 and at most 32, queries' tables, one byte an entry.  Where
    ``128*m*k`` bytes fit (every ``k <= 16`` up to m = 113) each entry is
    stored ``128 // QT`` times, one copy for each row of a load's phase: no
    bank conflicts.  Elsewhere (k = 256) each entry is stored once, laid out
    ``[j][c][q]``, and QT is the largest power of two up to that cover whose
    tables fit (down to 1); the rows of a phase then land where their codes
    put them (a conflict-free skewed walk measured slower on an H100:
    ``PERF.md``).  The grid is :func:`adc_plan`'s.  ``sms`` is the
    card's multiprocessors; no score depends on the plan.  Raises
    ``ValueError`` when one query's tables outgrow a block."""
    if packed and (k > 16 or m % 2):
        raise ValueError(f"packed codes need k <= 16 and an even m, got m={m}, k={k}")
    if nq <= 0 or m <= 0 or k <= 0 or n < 0:
        raise ValueError(f"no ADC plan for n={n}, nq={nq}, m={m}, k={k}")
    if _int8_smem(1, 1, m, k) > _SMEM_BYTES:
        raise ValueError(
            f"no shared-memory tiling for m={m}, k={k}, splits=int8: one query's tables exceed "
            "a block's shared memory; use the einsum scorer (reductive_tpu_torch.search.adc_scores)"
        )
    cover = min(_F32_MAX_QUERIES, max(_I8_MIN_QUERIES, _pow2_at_least(nq)))
    qt, replicas = cover, _I8_COPY_BYTES // cover
    if _int8_smem(qt, replicas, m, k) > _SMEM_BYTES:
        replicas = 1
        while _int8_smem(qt, 1, m, k) > _SMEM_BYTES:
            qt //= 2
    lanes = max(1, qt // 16)
    return _grid_plan(n, nq, qt, replicas, False, 32 // lanes,
                      _int8_smem(qt, replicas, m, k), sms)


def query_tile(m: int, k: int, splits=2) -> int:
    """Queries whose tables one block holds in shared memory, at most: for
    f32 tables :func:`adc_plan`'s ``queries`` for a large batch (32 where
    every entry's 32 copies fit, else the largest power of two whose tables
    fit: 8 at m=16, k=256, 16 KB a query); for ``"int8"``
    :func:`adc_int8_plan`'s for a large batch (1 byte an entry: 32 at m=16,
    k=256 and at k=16).  0 when not even one query's tables fit."""
    if splits == "int8":
        if _int8_smem(1, 1, m, k) > _SMEM_BYTES:
            return 0
        return adc_int8_plan(1, _F32_MAX_QUERIES, m, k).queries
    if m * k * 4 > _SMEM_BYTES:
        return 0
    return adc_plan(1, _F32_MAX_QUERIES, m, k).queries


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


def adc_table_int8(tables: Tensor) -> tuple[Tensor, Tensor, Tensor]:
    """The int8 tables the int8 ADC kernel reads: ``(T8, scale, offset)`` of
    :func:`quantize_tables_int8`.  On the card one launch builds them
    (``rt_adc_prepare_int8``, a block a query), bit for bit the plain
    version, which CPU tensors take."""
    if tables.ndim != 3:
        raise ValueError(f"tables must be (nq, m, k), got {tuple(tables.shape)}")
    tables = tables.to(torch.float32).contiguous()
    if not tables.is_cuda:
        return quantize_tables_int8(tables)
    nq, m, k = tables.shape
    t8 = torch.empty((nq, m, k), dtype=torch.int8, device=tables.device)
    scale = torch.empty((nq,), dtype=torch.float32, device=tables.device)
    offset = torch.empty((nq,), dtype=torch.float32, device=tables.device)
    if nq:
        with torch.cuda.device(tables.device):
            _build.launch("rt_adc_prepare_int8", None, tables.data_ptr(), t8.data_ptr(),
                          scale.data_ptr(), offset.data_ptr(), nq, m, k,
                          torch.cuda.current_stream().cuda_stream)
    return t8, scale, offset


@functools.lru_cache(maxsize=None)
def _sms(device: torch.device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


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
    if splits != "int8" and splits not in (1, 2, 3):
        raise ValueError(f"splits must be 1, 2, 3 or 'int8', got {splits!r}")
    if nq == 0:
        raise ValueError("tables hold no query")
    sms = _sms(codes.device)
    int8 = splits == "int8"
    plan = (adc_int8_plan if int8 else adc_plan)(n, nq, m, k, packed, sms=sms)
    if plan.query_tiles > _GRID_Y_MAX:
        raise ValueError(f"nq={nq} exceeds max_query_batch={_GRID_Y_MAX * plan.queries}; "
                         "batch the queries")
    if codes.dtype != torch.uint8:
        codes = codes.to(torch.uint8 if packed else torch.int32)
    codes = codes.contiguous()
    out = torch.empty((nq, n), dtype=torch.float32, device=codes.device)
    if int8:
        table = adc_table_int8(tables)
    else:
        table = (decode_table(tables.reshape(nq, m * k, 1), splits)[0].view(nq, m, k),)
    with torch.cuda.device(codes.device):
        adc_launcher(table, codes, out, packed=packed, plan=plan)()
    return out


def adc_launcher(table: tuple[Tensor, ...], codes: Tensor, out: Tensor, *, packed: bool = False,
                 plan: AdcPlan | None = None, counted: bool = True, lib=None):
    """A callable that launches an ADC kernel once each time it is called,
    into ``out`` (``(nq, n)`` f32) from ``(n, m)`` uint8 or int32 codes
    (``(n, m/2)`` bytes packed), all contiguous on one card: the f32 kernel
    (``rt_adc``) from ``table = (T,)``, ``T`` the ``(nq, m, k)`` f32 table,
    or the int8 kernel (``rt_adc_i8``) from ``table = (t8, scale, offset)``
    of :func:`adc_table_int8`.  Its arguments, and the current stream, are
    bound here.  ``plan`` replaces :func:`adc_plan`'s or
    :func:`adc_int8_plan`'s.  Counted under ``adc`` / ``adc_int8`` (``_u4``
    packed) unless ``counted`` is false.  ``lib``: a ``ctypes`` library
    built from a variant of ``csrc/adc.cu`` (a timing tool's), whose entry is
    called in place of the package's and not counted.  A call raises when
    the entry does not launch."""
    int8 = len(table) == 3
    nq, m, k = table[0].shape
    n = codes.shape[0]
    if plan is None:
        plan = (adc_int8_plan if int8 else adc_plan)(n, nq, m, k, packed, sms=_sms(codes.device))
    entry = "rt_adc_i8" if int8 else "rt_adc"
    with torch.cuda.device(codes.device):
        stream = torch.cuda.current_stream().cuda_stream
    args = (*(t.data_ptr() for t in table), codes.data_ptr(), codes.element_size(), int(packed),
            out.data_ptr(), n, nq, m, k, plan.queries, plan.replicas,
            *(() if int8 else (int(plan.skew),)), plan.blocks, plan.rows_per_block,
            plan.threads, plan.smem_bytes, stream)
    counter = ("adc_int8" if int8 else "adc") + ("_u4" if packed else "") if counted else None
    if lib is not None:
        fn = getattr(lib, entry)
        fn.argtypes = list(_build._ENTRIES[entry][1])

    def call() -> None:
        if lib is None:
            _build.launch(entry, counter, *args)
        elif (rc := fn(*args)) != 0:
            raise RuntimeError(f"{entry} of {lib} failed to launch (returned {rc})")
    call.tensors = (*table, codes, out)  # alive as long as the callable
    return call
