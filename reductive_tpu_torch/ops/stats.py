"""Fused assign + statistics (one pass of Lloyd's): CUDA kernel and plain
version.

For ``x`` ``(n, d)`` and codebooks ``(m, k, ds)``: the nearest-centroid
assignment of :mod:`reductive_tpu_torch.ops.assign` (first index on ties),
then per-centroid sums ``(m, k, ds)`` of the rows assigned to each centroid
and their counts ``(m, k)``, both float32.  Counterpart of
``reductive_tpu.ops.stats.pq_assign_stats`` (TPU kernel ``_stats_kernel``);
the kernel is ``csrc/stats.cu``.

``compute_dtype`` means what it means for the encode: ``torch.float32``
assigns at fp32 accuracy (the kernel: a 3xTF32 split product, each cross term
within ``2^-19 |2c| |x|`` of the real one at ``ds = 8``; the plain version:
fp32 tensor operations) and sums the unrounded ``x``; ``torch.bfloat16``
assigns with ``x`` and ``2c`` rounded to bfloat16 and sums the **rounded**
``x`` in f32 (one rounded copy of ``x`` feeds both halves, as in the
reference).  Counts are exact integers in both modes.

At every ``ds`` up to 32 the kernel is the narrow one (``csrc/stats.cu``: a
tile's rows accumulated as they are assigned; at a ``ds`` outside 4, 8, 16,
32 the instance of ``ops.assign.padded_ds(ds)``, rows and centroids padded
with zeros, counters ``*_pad``); above, the wide route: the deep kernel of
``csrc/assign_deep.cuh`` (the wide encode's, bit for bit) writes its codes,
then the statistics of those codes, :func:`cell_stats`'s kernels in the same
C call (counters ``*_wide`` and ``cell_stats``): a stable radix sort of each
subquantizer's rows by code, each cell cut into chunks of
:func:`cell_chunk_rows` sorted rows, one warp a chunk adding its rows in row
order, then each cell's chunks in order.  Neither uses float
atomics: every sum is taken in an order fixed by the shapes (and, on the
wide route, the codes), so two launches on the same inputs give the same
bits.  The plain version and the verified wrapper's corrections add by a
one-hot product (:func:`reductive_tpu_torch.linalg.one_hot_sums`), in an
order fixed by the shapes too.  The
kernel and the plain version agree on the counts except where rounding
(summation order, the split) flips a near-tie, and on the sums up to f32
summation order.

:func:`pq_assign_stats_verified` removes that exception: its cell
memberships are those of
:func:`reductive_tpu_torch.pq.primitives.quantize_batch` (counts equal to the
exact path's, sums equal up to f32 accumulation order).  Counterpart of
``reductive_tpu.ops.stats.pq_assign_stats_verified`` (TPU kernel
``_stats_verify_kernel``): the f32 kernel also writes its codes and the row
flags of :mod:`reductive_tpu_torch.ops.assign`; flagged rows are encoded
again by the exact path, and a row whose code changed is moved from its old
cell to its new one.

The f32 kernel takes its cross terms as a 3xTF32 split product on the tensor
cores (``csrc/assign_tile.cuh``, or ``csrc/assign_deep.cuh`` on the wide
route), the routine the f32 encode runs too at the same ``ds``, so its codes
are the encode's bit for bit and its flag limit is the one that
:mod:`reductive_tpu_torch.ops.assign` derives for the route
(:data:`STATS_ROUTE`, ``"tf32x3"``, at 4, 8, 16, 32; ``"tf32x3_pad"`` at 17
to 24; ``"tf32x3_wide"`` at every other ``ds``, ``ops.assign.f32_route``);
the plain version flags with the same limit.
"""

from __future__ import annotations

import torch
from torch import Tensor

from ..linalg import one_hot_sums
from ..pq.primitives import nearest_centroids, quantize_batch
from . import _build
from .assign import (
    _ROUTE_CODES, F32_ROUTE, VERIFY_RHO, _blocks_per_subquantizer, _check_k, _counter, _prepare,
    _route_operands, bf16_tile_plan, flagged_rows, padded_ds, pq_encode_verify_reference,
    verify_scale,
)

__all__ = [
    "pq_assign_stats", "pq_assign_stats_reference",
    "cell_stats", "cell_stats_reference", "cell_chunk_rows", "cell_chunks",
    "pq_assign_stats_verified", "pq_assign_stats_verify_reference", "pq_assign_stats_verify_flags",
    "STATS_ROUTE", "stats_from_codes", "move_between_cells", "exact_stats_chunked",
]

# How the narrow f32 kernel evaluates its products: names the flag limit of
# the verified mode (see verify_scale).  One routine with the f32 encode.
STATS_ROUTE = F32_ROUTE
# Rows the plain version takes at a time.
_REFERENCE_CHUNK = 1 << 16


def pq_assign_stats_reference(
    codebooks: Tensor, x: Tensor, *, compute_dtype: torch.dtype = torch.float32
) -> tuple[Tensor, Tensor]:
    """Plain PyTorch version of :func:`pq_assign_stats`: the encode's plain
    version for the codes, then a one-hot product of ``x`` (of the
    bfloat16-rounded ``x`` in bf16 mode) and a ``bincount``, in chunks of
    rows so that nothing of size ``(n, m, k)`` exists."""
    cb2, c_sqn = _prepare(codebooks, x, torch.int32, compute_dtype)
    m, k, ds = codebooks.shape
    cell0 = torch.arange(m, device=x.device)[None, :] * k
    sums = torch.zeros((m, k, ds), dtype=torch.float32, device=x.device)
    counts = torch.zeros((m * k,), dtype=torch.int64, device=x.device)
    for i in range(0, x.shape[0], _REFERENCE_CHUNK):
        xc = x[i:i + _REFERENCE_CHUNK]
        if compute_dtype == torch.bfloat16:
            xc = xc.to(torch.bfloat16).to(torch.float32)
        xs = xc.reshape(xc.shape[0], m, ds)
        codes = nearest_centroids(cb2, c_sqn, xs)
        sums += one_hot_sums(codes, xs, k)[0]
        counts += torch.bincount((codes + cell0).reshape(-1), minlength=m * k)
    return sums, counts.reshape(m, k).to(torch.float32)


def _launch_stats(codebooks: Tensor, x: Tensor, compute_dtype, verify=None):
    """One launch of the kernel on CUDA tensors.  ``verify`` is ``None`` or
    ``(escale, rho)``; with it the result also holds the codes ``(n, m)``
    int32 (a transposed view: the kernel writes them ``(m, n)``, whole
    sectors at a time) and the row flags ``(n,)`` int32."""
    cb2, c_sqn = _prepare(codebooks, x, torch.int32, compute_dtype)
    n = x.shape[0]
    m, k, ds = codebooks.shape
    _check_k(m, k, ds, "assign+statistics",
             "pass use_kernel=False to the trainer for the plain tensor route")
    dev = x.device
    sums = torch.empty((m, k, ds), dtype=torch.float32, device=dev)
    counts = torch.empty((m, k), dtype=torch.float32, device=dev)
    codes = flags = None
    x = x.contiguous()
    cb2, c_sqn, route = _route_operands(cb2, c_sqn, x, compute_dtype)
    if verify is not None or route != "narrow":
        codes = torch.empty((m, n), dtype=torch.int32, device=dev).T
    if verify is not None:
        flags = torch.zeros((n,), dtype=torch.int32, device=dev)
    if n == 0:
        return sums.zero_(), counts.zero_(), codes, flags
    if route != "narrow":
        _launch_wide(cb2, c_sqn, x, codes, sums, counts, compute_dtype, verify, flags, route)
        return sums, counts, (codes if verify is not None else None), flags
    dsp = padded_ds(ds)
    plan = bf16_tile_plan(n, m, k, ds) if verify is None and compute_dtype == torch.bfloat16 else None
    blocks = _blocks_per_subquantizer(n, m, k, dsp) if plan is None else plan.blocks
    partial = torch.empty((blocks, m, k, dsp + 1), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        if plan is not None:
            _build.launch(
                "rt_assign_stats_bf16", _counter("stats_bf16", route, ds, x),
                x.data_ptr(), cb2.data_ptr(), c_sqn.data_ptr(), partial.data_ptr(),
                sums.data_ptr(), counts.data_ptr(), n, m, k, ds, plan.rows, plan.blocks,
                plan.smem_bytes, stream,
            )
        elif verify is None:
            _build.launch(
                "rt_assign_stats", _counter("stats_f32", route, ds, x),
                x.data_ptr(), cb2.data_ptr(), c_sqn.data_ptr(), partial.data_ptr(),
                sums.data_ptr(), counts.data_ptr(), n, m, k, ds, blocks, stream,
            )
        else:
            escale, rho = verify
            escale = escale.contiguous()
            _build.launch(
                "rt_assign_stats_verify", _counter("stats_verify", route, ds, x),
                x.data_ptr(), cb2.data_ptr(), c_sqn.data_ptr(), partial.data_ptr(),
                sums.data_ptr(), counts.data_ptr(), escale.data_ptr(), float(rho),
                codes.data_ptr(), flags.data_ptr(), n, m, k, ds, blocks, stream,
            )
    return sums, counts, codes, flags


def _launch_wide(cb2, c_sqn, x, codes, sums, counts, compute_dtype, verify, flags, route) -> None:
    """The wide route (``route`` ``"deep"``, from
    ``ops.assign.assign_route``, with ``cb2`` and ``c_sqn`` converted for
    the deep kernel; ``"shallow"`` where a caller forces it): one C entry
    launches the assignment (``csrc/assign_wide.cuh`` ``launch``) and the
    statistics of its codes (:func:`cell_stats`'s kernels), into ``codes``
    (an ``(n, m)`` view of an ``(m, n)`` tensor), ``sums`` and ``counts``;
    both kernels' counts grow."""
    n = codes.shape[0]
    m, k, ds = sums.shape
    words = _build.query("rt_assign_stats_wide_scratch", n, m, k, ds)
    scratch = torch.empty((words,), dtype=torch.int32, device=x.device)
    if verify is None:
        mode, name = (1, "stats_bf16") if compute_dtype == torch.bfloat16 else (0, "stats_f32")
        escale, rho = None, 0.0
    else:
        (escale, rho), mode, name = verify, 2, "stats_verify"
        escale = escale.contiguous()
    with torch.cuda.device(x.device):
        _build.launch(
            "rt_assign_stats_wide", (_counter(name, route, ds, x), "cell_stats"),
            x.data_ptr(), cb2.data_ptr(), c_sqn.data_ptr(), codes.data_ptr(),
            None if escale is None else escale.data_ptr(), float(rho),
            None if flags is None else flags.data_ptr(), scratch.data_ptr(),
            sums.data_ptr(), counts.data_ptr(), n, m, k, ds, mode, _ROUTE_CODES[route],
            torch.cuda.current_stream().cuda_stream,
        )


def pq_assign_stats(
    codebooks: Tensor, x: Tensor, *, compute_dtype: torch.dtype = torch.float32
) -> tuple[Tensor, Tensor]:
    """Per-centroid sums ``(m, k, ds)`` and counts ``(m, k)`` (float32) of
    the ``(n, d)`` rows of ``x`` under nearest-centroid assignment, in one
    pass over ``x``.

    CUDA tensors go through the kernel (any ``ds``, ``k <= 65536``; a larger
    ``k`` raises a ``ValueError``: the trainers take ``use_kernel=False`` for
    it) that ``ops.assign.assign_route`` names, the narrow one at every ``ds``
    up to 32 and the wide route above; CPU tensors through
    :func:`pq_assign_stats_reference`.
    """
    if not x.is_cuda:
        return pq_assign_stats_reference(codebooks, x, compute_dtype=compute_dtype)
    sums, counts, _, _ = _launch_stats(codebooks, x, compute_dtype)
    return sums, counts


# -- the wide route's statistics from the codes ------------------------------------


def cell_chunk_rows(ds: int) -> int:
    """Sorted rows a work item of :func:`cell_stats` adds (``R``): the largest
    power of two with ``R * ds <= 16384``, within [32, 256]; a function of
    ``ds`` alone (``csrc/stats.cu`` ``cells::chunk_rows``)."""
    r = 1
    while r < 256 and 2 * r * ds <= 16384:
        r *= 2
    return max(r, 32)


def cell_chunks(counts: Tensor, rows: int) -> tuple[Tensor, Tensor, Tensor, Tensor]:
    """The work items of :func:`cell_stats` from the cells' counts ``(C,)``
    (int64, cells in sorted order): each cell's segment of the sorted rows
    cut into chunks of ``rows`` (the last one shorter).  Returns
    ``chunk_start`` ``(C + 1,)``, the exclusive scan of ``ceil(count /
    rows)`` (cell ``c``'s chunks are ``chunk_start[c] ..
    chunk_start[c + 1]``), and for each chunk its cell, its first sorted
    position and its length, ``(Q,)`` each."""
    counts = counts.to(torch.int64)
    dev = counts.device
    first_row = torch.cumsum(counts, 0) - counts
    per_cell = (counts + rows - 1) // rows
    chunk_start = torch.zeros((counts.shape[0] + 1,), dtype=torch.int64, device=dev)
    torch.cumsum(per_cell, 0, out=chunk_start[1:])
    cell = torch.repeat_interleave(torch.arange(counts.shape[0], device=dev), per_cell)
    s = torch.arange(cell.shape[0], device=dev) - chunk_start[cell]
    first = first_row[cell] + s * rows
    return chunk_start, cell, first, torch.clamp(counts[cell] - s * rows, max=rows)


def cell_stats_reference(
    codes: Tensor, x: Tensor, k: int, *, round_bf16: bool = False
) -> tuple[Tensor, Tensor]:
    """Plain PyTorch version of :func:`cell_stats`, in the kernel's order of
    addition: a stable sort of each subquantizer's rows by code; each cell's
    rows cut into chunks (:func:`cell_chunks`, :func:`cell_chunk_rows`);
    per column, each chunk's rows added in row order from zero (``R`` steps
    of one gather and one add over all chunks), then each cell's chunks in
    chunk order from zero.  The kernel equals it bit for bit."""
    n, m = codes.shape
    ds = x.shape[1] // m
    dev = x.device
    keys = (codes.T.to(torch.int64) + torch.arange(m, device=dev)[:, None] * k).reshape(-1)
    rows = torch.argsort(keys, stable=True) % n
    counts = torch.bincount(keys, minlength=m * k)
    r = cell_chunk_rows(ds)
    chunk_start, cell, first, length = cell_chunks(counts, r)
    xs = x.to(torch.float32)
    if round_bf16:
        xs = xs.to(torch.bfloat16).to(torch.float32)
    xs = xs.reshape(n, m, ds)
    j = cell // k
    partial = torch.zeros((cell.shape[0], ds), dtype=torch.float32, device=dev)
    for step in range(r):
        live = (step < length)[:, None]
        at = torch.clamp(first + step, max=max(n * m - 1, 0))
        partial = torch.where(live, partial + xs[rows[at], j], partial)
    sums = torch.zeros((m * k, ds), dtype=torch.float32, device=dev)
    per_cell = chunk_start[1:] - chunk_start[:-1]
    for step in range(int(per_cell.max()) if per_cell.numel() else 0):
        live = (step < per_cell)[:, None]
        at = torch.clamp(chunk_start[:-1] + step, max=max(cell.shape[0] - 1, 0))
        sums = torch.where(live, sums + partial[at], sums)
    return sums.reshape(m, k, ds), counts.reshape(m, k).to(torch.float32)


def cell_stats(codes: Tensor, x: Tensor, k: int, *, round_bf16: bool = False) -> tuple[Tensor, Tensor]:
    """Sums ``(m, k, ds)`` and counts ``(m, k)`` (float32) of the rows of
    ``x`` ``(n, m*ds)`` f32 in the cells their ``codes`` ``(n, m)`` name
    (each in ``[0, k)``): the accumulation half of the wide route's
    statistics, which :func:`pq_assign_stats` runs after its assignment.
    ``round_bf16``: the sums are of the bfloat16-rounded ``x``, in f32.

    CUDA tensors go through the kernels of ``csrc/stats.cu`` (``cells``:
    radix sort by code, chunk sums, chunk partials added per cell; no float
    atomics, so two launches give the same bits, and the bits of
    :func:`cell_stats_reference`; ``k <= 65536``); CPU tensors through
    :func:`cell_stats_reference`.  ``codes`` given as the transposed view of
    an ``(m, n)`` tensor (the verify kernel's) is read without a copy."""
    if not x.is_cuda:
        return cell_stats_reference(codes, x, k, round_bf16=round_bf16)
    n, m = codes.shape
    if x.dtype != torch.float32 or x.dim() != 2 or x.shape[0] != n or x.shape[1] % m:
        raise ValueError(f"cell_stats: x {tuple(x.shape)} {x.dtype} does not fit codes {(n, m)}")
    if not 1 <= k <= 65536:
        raise ValueError(f"cell_stats: k = {k} is outside 1 .. 65536")
    ds = x.shape[1] // m
    dev = x.device
    sums = torch.empty((m, k, ds), dtype=torch.float32, device=dev)
    counts = torch.empty((m, k), dtype=torch.float32, device=dev)
    if n == 0:
        return sums.zero_(), counts.zero_()
    codes_mn = codes.T.to(torch.int32).contiguous()
    x = x.contiguous()
    words = _build.query("rt_cell_stats_scratch", n, m, k, ds)
    scratch = torch.empty((words,), dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        _build.launch(
            "rt_cell_stats", "cell_stats", codes_mn.data_ptr(), x.data_ptr(), scratch.data_ptr(),
            sums.data_ptr(), counts.data_ptr(), n, m, k, ds, int(round_bf16),
            torch.cuda.current_stream().cuda_stream,
        )
    return sums, counts


# -- the verified mode -----------------------------------------------------------


def stats_from_codes(codes: Tensor, x: Tensor, k: int) -> tuple[Tensor, Tensor]:
    """Sums ``(m, k, ds)`` and counts ``(m, k)`` (float32) of the rows of
    ``x`` ``(n, m*ds)`` f32 in the cells their ``codes`` ``(n, m)`` name: a
    one-hot product (:func:`~reductive_tpu_torch.linalg.one_hot_sums`, the
    same bits on every run) and ``bincount``."""
    n, m = codes.shape
    ds = x.shape[1] // m
    cells = (codes.to(torch.int64) + torch.arange(m, device=x.device)[None, :] * k).reshape(-1)
    sums = one_hot_sums(codes, x.reshape(n, m, ds).to(torch.float32), k)[0]
    counts = torch.bincount(cells, minlength=m * k).to(torch.float32)
    return sums, counts.reshape(m, k)


def exact_stats_chunked(codebooks: Tensor, x: Tensor, chunk: int = 16384) -> tuple[Tensor, Tensor]:
    """Statistics under the exact path's assignment, in ``chunk``-row slices
    (each coded as the whole batch codes it): what
    :func:`pq_assign_stats_verified` computes when too many rows are flagged.
    Right at any flag rate."""
    m, k, ds = codebooks.shape
    sums = torch.zeros((m, k, ds), dtype=torch.float32, device=x.device)
    counts = torch.zeros((m, k), dtype=torch.float32, device=x.device)
    for i in range(0, x.shape[0], chunk):
        xc = x[i:i + chunk]
        codes = quantize_batch(codebooks, xc, dtype=torch.int32, batch=x.shape[0])
        s2, c2 = stats_from_codes(codes, xc, k)
        sums += s2
        counts += c2
    return sums, counts


def move_between_cells(
    sums: Tensor, counts: Tensor, x: Tensor, old: Tensor, new: Tensor
) -> tuple[Tensor, Tensor]:
    """Move rows from the cells ``old`` names to the cells ``new`` names, in
    place: for every (row, j) with ``new != old`` the subvector ``x_j`` leaves
    ``sums[j, old]`` and enters ``sums[j, new]``, and the counts follow.
    ``x`` is ``(f, m*ds)`` f32, ``old`` and ``new`` ``(f, m)``.  Entries that
    did not change add zeros, so no second wait for the device is needed to
    find them.  The moves are the JAX package's one-hot difference
    (``one_hot(new) - one_hot(old)`` times the change, into an ``einsum``),
    so the result has the same bits on every run."""
    m, k, ds = sums.shape
    changed = (new != old).to(torch.float32)  # (f, m)
    dsums, dcounts = one_hot_sums(new, x.reshape(-1, m, ds).to(torch.float32), k,
                                  minus=old, weight=changed)
    sums += dsums
    counts += dcounts
    return sums, counts


def pq_assign_stats_verify_reference(
    codebooks: Tensor, x: Tensor, *, escale: Tensor | None = None, rho: float = VERIFY_RHO,
) -> tuple[Tensor, Tensor, Tensor, Tensor]:
    """Plain PyTorch version of the verify kernel: ``(sums, counts, codes
    (n, m) int32, flags (n,) int32)``, the codes and flags of
    :func:`~reductive_tpu_torch.ops.assign.pq_encode_verify_reference` and the
    statistics of those codes.  ``escale`` defaults to the kernel's,
    ``verify_scale(codebooks)`` (the route of the kernels at this ``ds``)."""
    if escale is None:
        escale = verify_scale(codebooks)
    codes, flags = pq_encode_verify_reference(
        codebooks, x, dtype=torch.int32, escale=escale, rho=rho
    )
    sums, counts = stats_from_codes(codes, x, codebooks.shape[1])
    return sums, counts, codes, flags


def pq_assign_stats_verify_flags(
    codebooks: Tensor, x: Tensor, *, escale: Tensor | None = None, rho: float = VERIFY_RHO,
) -> tuple[Tensor, Tensor, Tensor, Tensor]:
    """The first stage of :func:`pq_assign_stats_verified`: ``(sums, counts,
    codes, flags)`` from the verify kernel (CUDA tensors) or from
    :func:`pq_assign_stats_verify_reference` (CPU tensors)."""
    if not x.is_cuda:
        return pq_assign_stats_verify_reference(codebooks, x, escale=escale, rho=rho)
    if escale is None:
        escale = verify_scale(codebooks)
    return _launch_stats(codebooks, x, torch.float32, verify=(escale, rho))


def pq_assign_stats_verified(
    codebooks: Tensor, x: Tensor, *, cap_frac: float = 1 / 16
) -> tuple[Tensor, Tensor]:
    """Statistics whose cell memberships equal the exact path's
    (:func:`~reductive_tpu_torch.pq.primitives.quantize_batch`, first-index
    tie-breaks included): the counts are the exact path's, the sums equal
    its sums up to f32 accumulation order.

    The verify kernel computes the statistics, its codes and the flags of
    every row where rounding could have changed an argmin.  Only the flagged
    rows' codes are read (a gather from the kernel's ``(m, n)`` layout;
    nothing of size ``(n, m)`` is transposed).  The flagged rows
    (``torch.nonzero``: the host waits for the device) are encoded again by
    the exact path; the rows among them whose code changed (a second
    ``nonzero``, so that the one-hot product below takes those rows only,
    a few in a thousand of the flagged ones on Gaussian data) are moved: for
    each (row, j) whose code changed ``+x_j`` and ``+1`` into its new cell,
    ``-x_j`` and ``-1`` into its old one.  Above ``cap2`` flagged rows
    (:func:`~reductive_tpu_torch.ops.assign.verify_caps` with chunks of
    ``min(16384, max(256, n))`` rows, as the JAX package takes them), the
    whole pass is :func:`exact_stats_chunked` instead.  ``x`` of another
    dtype is cast to f32 first.  Composes with the chunked trainers through
    ``compute_dtype="verified"``.

    CUDA tensors go through the kernel (any ``ds``, ``k <= 65536``; a larger
    ``k`` raises a ``ValueError``); CPU tensors through
    :func:`pq_assign_stats_verify_reference`.
    """
    x = x.to(torch.float32)
    sums, counts, codes, flags = pq_assign_stats_verify_flags(codebooks, x)
    idx = flagged_rows(flags, cap_frac, min(16384, max(256, x.shape[0])), "stats")
    if idx is None:
        return exact_stats_chunked(codebooks, x)
    if idx.shape[0]:
        xf = x[idx]
        new = quantize_batch(codebooks, xf, dtype=torch.int32, batch=x.shape[0])
        old = codes[idx]
        moved = torch.nonzero((new != old).any(dim=1))[:, 0]
        if moved.shape[0]:
            move_between_cells(sums, counts, xf[moved], old[moved], new[moved])
    return sums, counts
