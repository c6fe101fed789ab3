"""IVF-PQ: inverted-file search with residual product quantization.

Counterpart of ``reductive_tpu.ivf``.  A **coarse quantizer** buckets the
corpus by nearest coarse centroid; each row is PQ-encoded as the
**residual** against its cell's centroid (Jégou et al., 2011, §V), and a
query scores only the ``nprobe`` nearest cells.

* **Dense cells.**  Every cell is a fixed-capacity block of one ``(C, L, m)``
  code tensor plus ``(C, L)`` ids (``-1`` = empty slot, masked when scored)
  and ``(C, L)`` norms ``||centroid + rec||^2``, so a probe is a gather of
  whole blocks.
* **Build** (:func:`build_ivf`).  Host placement: pass 1 takes each row's
  nearest coarse cells on the card and moves the candidate matrix to the
  host once; the host places rows into cells; pass 2 residual-encodes on the
  card and moves codes and norms to the host once; the host scatters them
  into the cells, which go back to the device.  Device placement
  (:func:`_build_ivf_device`): the placement, the encode and the cells stay
  on the card, and only a bounded build's overflow rows are placed apart
  (:func:`_respill_device`).
* **Updates.**  :func:`ivf_add` puts new rows in free slots (a fast path on
  the card when every row fits its nearest cell) and :func:`ivf_remove`
  frees slots by id; the cells keep their shapes.
* **Search** (:func:`ivf_search`) scores by the IVFADC decomposition
  ``||q - c - rec||^2 = ||q||^2 + g - 2 q.c - 2 q.rec`` (Jégou et al.,
  2011, Eq. 13) with ``g`` from the build.  With the kernels
  (``use_kernel=None`` on CUDA tensors) it scores the union of the probed
  cells once against every query by the ADC kernel
  (:func:`reductive_tpu_torch.ops.adc_scores_kernel`) over ``-q.rec``
  tables; where one query's tables do not fit a block's shared memory it
  decodes the probed candidates instead (the decode kernel), and says so at
  INFO level.  Without the kernels (CPU tensors) it decodes by a gather.

A corpus larger than the card is given as a reader
(:class:`reductive_tpu_torch.native.VecsReader`, or anything with
``n``/``dim``/``read``): :func:`train_ivf_pq` reads a sorted sample of its
rows, :func:`build_ivf` reads it in the chunks and batches it would slice a
tensor in (:class:`_ReaderRows`), so the cells equal those of a build from
the same rows given as a tensor, and ``refine_with`` reads the candidate rows
only.

Random draws take a ``torch.Generator`` on the instances' device where the
JAX package takes a key.  :func:`ivf_search_sharded` shards the cells over
the ranks of a device mesh (one process a card) and merges the ranks'
results.
"""

from __future__ import annotations

import dataclasses
import logging
import time
from typing import Optional, Tuple

import numpy as np
import torch
from torch import Tensor

from . import kmeans, linalg, ops
from ._device import check_generator
from .ops.adc import max_query_batch, query_tile
from .pq import primitives
from .pq.model import Pq, _on_device
from .search import (
    _check_metric, _is_reader, _merge_ranks, _reader_rows, _refine, _smallest, adc_tables,
)
from .utils.profiling import count, span

logger = logging.getLogger("reductive_tpu")

__all__ = [
    "IvfPq", "train_ivf_pq", "build_ivf", "ivf_add", "ivf_remove", "ivf_search",
    "ivf_search_sharded",
]

# Bytes of transient (nq, probes, L, d) f32 reconstruction one step of the
# decode probe may hold: it takes the probes in chunks, and the cell rows too
# when one probe alone exceeds it.  Module-level so that tests can shrink it.
_PROBE_RECON_BUDGET = 1 << 30
# Bytes of transient (nq, cells * L) f32 scores one chunk of the ADC-table
# probe may hold.  Module-level so that tests can shrink it.
_PROBE_LUT_BUDGET = 1 << 28

@dataclasses.dataclass
class IvfPq:
    """An IVF-PQ index: coarse centroids, the residual quantizer and the
    dense cells, as tensors on one device (a dataclass, as :class:`Pq` is).

    ``cell_codes[c, l]`` is the PQ code of the ``l``-th row stored in cell
    ``c`` (encoded from the residual ``x - coarse_centroids[c]``),
    ``cell_ids[c, l]`` its corpus row (int32, ``-1`` for an empty slot) and
    ``cell_norms[c, l]`` the f32 ``||centroid + rec||^2``.  ``dropped_ids``
    is build metadata, not a tensor: the corpus ids :func:`build_ivf` and
    later :func:`ivf_add` calls dropped under ``on_overflow="drop"``, empty
    otherwise.
    """

    coarse_centroids: Tensor  # (C, d)
    pq: Pq                    # residual quantizer, codebooks (m, k, ds)
    cell_codes: Tensor        # (C, L, m), or (C, L, m/2) packed
    cell_ids: Tensor          # (C, L) int32, -1 = empty
    cell_norms: Tensor        # (C, L) f32
    dropped_ids: np.ndarray = dataclasses.field(
        default_factory=lambda: np.empty(0, np.int64), repr=False
    )

    def __post_init__(self) -> None:
        C = self.coarse_centroids.shape[0]
        if (self.cell_codes.ndim != 3 or tuple(self.cell_ids.shape) != (C, self.cell_codes.shape[1])
                or self.cell_norms.shape != self.cell_ids.shape):
            raise ValueError(
                f"cells do not match {C} coarse centroids: codes {tuple(self.cell_codes.shape)}, "
                f"ids {tuple(self.cell_ids.shape)}, norms {tuple(self.cell_norms.shape)}"
            )

    @property
    def n_cells(self) -> int:
        return self.coarse_centroids.shape[0]

    @property
    def capacity(self) -> int:
        return self.cell_codes.shape[1]

    @property
    def packed(self) -> bool:
        """True when the cell codes are two u4 codes a byte (``build_ivf(
        packed=True)``, k <= 16): ``(C, L, m/2)`` bytes in the
        :func:`reductive_tpu_torch.ops.pack_u4_codes` layout.  Inferred from
        the shape."""
        return self.cell_codes.shape[2] != self.pq.quantized_len


class _ReaderRows:
    """A reader seen as an ``(n, d)`` float32 tensor on ``device``, for the
    build's indexing: ``rows[a:b]`` reads a range; ``rows[idx]`` (an int
    tensor, ascending where the build takes it so) reads the rows it names,
    a range where they are one (a pass-2 batch with no row dropped), the
    covering range where it is at most twice as long, else row by row.  Each
    read is copied to ``device``."""

    def __init__(self, reader, device: torch.device):
        self.reader = reader
        self.device = device
        self.shape = (reader.n, reader.dim)
        self.is_cuda = device.type == "cuda"

    def _put(self, rows) -> Tensor:
        return torch.as_tensor(rows).to(self.device, torch.float32)

    def __getitem__(self, key) -> Tensor:
        if isinstance(key, slice):
            start, stop, _ = key.indices(self.shape[0])
            return self._put(self.reader.read(start, max(0, stop - start)))
        idx = key.cpu().numpy().astype(np.int64).reshape(-1)
        if not idx.size:
            return torch.empty((0, self.shape[1]), device=self.device)
        if bool(np.all(np.diff(idx) > 0)) and idx[-1] - idx[0] < 2 * idx.size:
            block = self._put(self.reader.read(int(idx[0]), int(idx[-1] - idx[0] + 1)))
            if idx[-1] - idx[0] + 1 == idx.size:
                return block
            return block[torch.from_numpy(idx - idx[0]).to(self.device)]
        return self._put(_reader_rows(self.reader, idx))


# ---------------------------------------------------------------------------
# Training
# ---------------------------------------------------------------------------


def train_ivf_pq(
    generator: torch.Generator,
    instances,
    n_cells: int,
    n_subquantizers: int,
    n_subquantizer_bits: int,
    *,
    coarse_iterations: int = 10,
    pq_iterations: int = 10,
    train_sample: Optional[int] = 262_144,
    chunk: int = 32768,
    use_kernel: Optional[bool] = None,
    residual_quantizer: str = "pq",
    coarse_metric: str = "l2",
) -> Tuple[Tensor, Pq]:
    """Train the two quantization stages: ``n_cells`` coarse k-means
    centroids, and a PQ over the **residuals** ``x - centroid[assign(x)]``.
    Returns ``(coarse (C, d), pq)``.

    ``train_sample`` caps the rows both stages train on (a quarter-million
    rows train 4,096 cells well); the full corpus is only touched by
    :func:`build_ivf`.  The coarse stage is seeded by k-means++ and runs the
    chunked Lloyd's driver (:func:`_coarse_stage`); the residual stage runs
    :func:`~reductive_tpu_torch.pq.train.train_pq_chunked`, or with
    ``residual_quantizer="gaussian_opq"`` the closed-form OPQ rotation and
    then that (:func:`_residual_stage`).  ``coarse_metric="spherical"``
    re-normalizes the centroids to the unit sphere after every Lloyd's
    update (spherical k-means, for ``ivf_search(metric="dot")`` on an
    L2-normalized corpus; an empty cell stays the zero vector).

    ``generator`` lives on the instances' device.  It is drawn from in this
    order: the ``train_sample`` rows
    (:func:`~reductive_tpu_torch.kmeans.random_distinct_indices`, only when
    the corpus has more rows), the k-means++ seeds, then the residual
    quantizer's initial codebooks.  ``use_kernel=None`` means the CUDA
    kernels when the instances lie on a GPU.

    ``instances`` may be a reader for a corpus larger than the card: then
    training runs on the generator's device, over ``min(train_sample or
    262,144, n - 1)`` distinct rows drawn first from the generator, read in
    ascending order (as the JAX package samples a reader; only the sample
    occupies device memory).
    """
    if coarse_metric not in ("l2", "spherical"):
        raise ValueError(f'unknown coarse_metric {coarse_metric!r} (use "l2" or "spherical")')
    if residual_quantizer not in ("pq", "gaussian_opq"):
        raise ValueError(
            f'unknown residual_quantizer {residual_quantizer!r} (use "pq" or "gaussian_opq")'
        )
    if _is_reader(instances):
        n = instances.n
        cap = min(train_sample or 262_144, n - 1)
        idx = np.sort(kmeans.random_distinct_indices(generator, n, cap).cpu().numpy())
        x_train = torch.as_tensor(_reader_rows(instances, idx)).to(generator.device, torch.float32)
    else:
        check_generator(generator, instances.device)
        n = instances.shape[0]
        x_train = instances
        if train_sample is not None and n > train_sample:
            x_train = instances[kmeans.random_distinct_indices(generator, n, train_sample)]
    if use_kernel is None:
        use_kernel = x_train.is_cuda
    logger.info(
        "IVF-PQ training: %d coarse cells (%d iters) + residual PQ m=%d k=%d",
        n_cells, coarse_iterations, n_subquantizers, 2 ** n_subquantizer_bits,
    )
    # k-means++ seeding: random seeds leave dead or merged cells, and the
    # dense cells' capacity (so the probe cost) follows the largest cell.
    init = kmeans.KMeansPlusPlusCentroids()(generator, x_train, n_cells)
    coarse = _coarse_stage(x_train, init, coarse_iterations, coarse_metric=coarse_metric,
                           chunk=chunk, use_kernel=use_kernel)
    pq = _residual_stage(generator, x_train, coarse, n_subquantizers, n_subquantizer_bits,
                         pq_iterations, residual_quantizer=residual_quantizer, chunk=chunk,
                         use_kernel=use_kernel)
    return coarse, pq


def _coarse_stage(
    x: Tensor, init: Tensor, iterations: int, *, coarse_metric: str = "l2",
    chunk: int = 32768, use_kernel: bool = False,
) -> Tensor:
    """The coarse centroids after ``iterations`` Lloyd's steps from
    ``init`` (the chunked driver: the fused statistics kernel with
    ``use_kernel``).  ``"spherical"`` normalizes ``init`` and every update to
    unit norm (Dhillon & Modha, 2001); zero rows stay zero."""
    if coarse_metric == "l2":
        coarse, _ = kmeans.kmeans_with_centroids_chunked(
            x, init, iterations, chunk=chunk, use_kernel=use_kernel)
        return coarse
    coarse = init / torch.linalg.vector_norm(init, dim=1, keepdim=True).clamp_min(1e-30)
    for _ in range(iterations):
        coarse, _ = kmeans.kmeans_with_centroids_chunked(
            x, coarse, 1, chunk=chunk, use_kernel=use_kernel)
        norm = torch.linalg.vector_norm(coarse, dim=1, keepdim=True)
        coarse = torch.where(norm > 0, coarse / norm.clamp_min(1e-30), coarse)
    return coarse


def _residual_stage(
    generator: torch.Generator, x: Tensor, coarse: Tensor, n_subquantizers: int,
    n_subquantizer_bits: int, iterations: int, *, residual_quantizer: str = "pq",
    chunk: int = 32768, use_kernel: bool = False, initial_model: Optional[Pq] = None,
) -> Pq:
    """The residual quantizer trained on ``x - coarse[nearest]``.
    ``initial_model`` (``"pq"`` only) starts from given codebooks, as
    ``train_pq_chunked`` takes them."""
    from .pq.opq import train_gaussian_opq_chunked
    from .pq.train import train_pq_chunked

    residuals = x - coarse[_assign_coarse(coarse, x, use_kernel).long()]
    if residual_quantizer == "pq":
        return train_pq_chunked(generator, residuals, n_subquantizers, n_subquantizer_bits,
                                iterations, chunk=chunk, use_kernel=use_kernel,
                                initial_model=initial_model)
    if initial_model is not None:
        raise ValueError('initial_model is taken with residual_quantizer="pq" only')
    return train_gaussian_opq_chunked(generator, residuals, n_subquantizers,
                                      n_subquantizer_bits, iterations, chunk=chunk,
                                      use_kernel=use_kernel)


def _assign_coarse(coarse: Tensor, x: Tensor, use_kernel: bool) -> Tensor:
    """Nearest coarse cell of each row, int32.  With the kernel:
    :func:`reductive_tpu_torch.ops.assign_nearest` (bf16 products, as the
    JAX package's TPU path).  Without: the f32 distances in chunks of rows
    whose ``(rows, C)`` block stays about 256 MB."""
    if use_kernel:
        return ops.assign_nearest(coarse, x)
    n = x.shape[0]
    b = max(8192, (1 << 26) // max(1, coarse.shape[0]))
    if n <= b:
        return kmeans.cluster_assignments(coarse, x)
    out = torch.empty((n,), dtype=torch.int32, device=x.device)
    for off in range(0, n, b):
        out[off:off + b] = _coarse_topk(x[off:off + b], coarse, 1)[:, 0]
    return out


def _coarse_topk(xb: Tensor, coarse: Tensor, A: int) -> Tensor:
    """Indices ``(rows, A)`` of the ``A`` nearest coarse centroids of each
    row, nearest first and the lowest index among equal distances, as
    ``jax.lax.top_k`` orders them; ``A == 1`` is the argmin (int32)."""
    d2 = linalg.squared_euclidean_distance(xb, coarse)
    if A == 1:
        return torch.argmin(d2, dim=1).to(torch.int32)[:, None]
    return _smallest(d2, None, A)[1]


# ---------------------------------------------------------------------------
# Build
# ---------------------------------------------------------------------------


def _greedy_place(
    cands: np.ndarray, C: int, L: int, fill: Optional[np.ndarray] = None
) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """First-come greedy placement of each row into the first of its
    candidate cells (``cands`` ``(n, A)``, in preference order) with free
    space, rows in corpus order.  Returns ``(cell, slot, fill)`` per row,
    ``-1`` where no candidate had space; ``fill`` (occupancy per cell,
    updated in place where passed) lets a later pass continue where an
    earlier one stopped.  One stable grouping pass per candidate rank."""
    n, A = cands.shape
    cell = np.full(n, -1, np.int64)
    slot = np.full(n, -1, np.int64)
    if fill is None:
        fill = np.zeros(C, np.int64)
    for r in range(A):
        unplaced = np.flatnonzero(cell < 0)
        if len(unplaced) == 0:
            break
        cand_r = cands[unplaced, r]
        order = np.argsort(cand_r, kind="stable")  # corpus order within a cell
        grouped = cand_r[order]
        group_start = np.concatenate([[0], np.flatnonzero(np.diff(grouped)) + 1])
        starts_of = np.zeros(len(grouped), np.int64)
        starts_of[group_start] = group_start
        np.maximum.accumulate(starts_of, out=starts_of)
        rank_in_group = np.arange(len(grouped)) - starts_of
        accept = rank_in_group < L - fill[grouped]
        rows = unplaced[order[accept]]
        cell[rows] = grouped[accept]
        slot[rows] = fill[grouped[accept]] + rank_in_group[accept]
        fill += np.bincount(grouped[accept], minlength=C)
    return cell, slot, fill


def _spill_place(
    remaining: np.ndarray, coarse: Tensor, fetch_rows, C: int, L: int, fill: np.ndarray,
    cell_of: np.ndarray, slot_of: np.ndarray,
) -> None:
    """Places each row of ``remaining`` (rows that fit none of their
    candidate cells) in the nearest cell *anywhere* with free space.  Ranks
    only the cells that still have space; rows whose ranked cells fill up
    meanwhile retry against the smaller set, and every pass places at least
    the earliest row, so it ends.  Updates ``fill``, ``cell_of`` and
    ``slot_of``."""
    while len(remaining):
        space_cells = np.flatnonzero(fill < L)
        sub = coarse[torch.from_numpy(space_cells).to(coarse.device)]
        a_sp = int(min(len(space_cells), 16))
        bf = max(8192, (1 << 26) // max(1, len(space_cells)))
        csp = np.empty((len(remaining), a_sp), np.int64)
        for off in range(0, len(remaining), bf):
            rows = remaining[off:off + bf]
            csp[off:off + bf] = _coarse_topk(fetch_rows(rows), sub, a_sp).cpu().numpy()
        cell_sp, slot_sp, fill = _greedy_place(space_cells[csp], C, L, fill)
        ok = cell_sp >= 0
        cell_of[remaining[ok]] = cell_sp[ok]
        slot_of[remaining[ok]] = slot_sp[ok]
        remaining = remaining[~ok]


def _residual_encode_batch(
    coarse: Tensor, pq: Pq, xb: Tensor, cc: Tensor, use_kernel: bool, out_dtype: torch.dtype,
) -> Tuple[Tensor, Tensor]:
    """Codes of the residuals of ``xb`` against the centroids ``cc`` names,
    and the f32 norms ``g = ||centroid + rec||^2``, on the device of the
    rows.  With the kernel: :func:`reductive_tpu_torch.ops.pq_encode` (bf16
    products, as the JAX package's TPU path) after the projection; without:
    ``pq.quantize_batch``."""
    c = coarse[cc]
    rb = xb - c
    if use_kernel:
        if pq.projection is not None:
            rb = torch.matmul(rb, pq.projection)
        codes = ops.pq_encode(pq.codebooks, rb, dtype=out_dtype)
    else:
        codes = pq.quantize_batch(rb, dtype=out_dtype)
    full = c + pq.reconstruct_batch(codes)
    return codes, torch.einsum("nd,nd->n", full, full)


def _encode_rows(
    coarse: Tensor, pq: Pq, instances: Tensor, rows: Optional[Tensor], cells: Tensor, *,
    batch: int, use_kernel: bool, dtype: torch.dtype, packed: bool,
) -> Tuple[Tensor, Tensor]:
    """Stored codes (two u4 codes a byte where ``packed``) and norms of
    ``instances[rows]`` (every row where None) against the centroids
    ``cells`` names, ``batch`` rows at a time by
    :func:`_residual_encode_batch`, on the cells' device."""
    n, m = cells.shape[0], pq.quantized_len
    codes = torch.empty((n, m // 2 if packed else m), dtype=dtype, device=cells.device)
    norms = torch.empty((n,), dtype=torch.float32, device=cells.device)
    for off in range(0, n, batch):
        xb = instances[off:off + batch] if rows is None else instances[rows[off:off + batch]]
        codes_b, norms_b = _residual_encode_batch(coarse, pq, xb, cells[off:off + batch],
                                                  use_kernel, dtype)
        codes[off:off + batch] = ops.pack_u4_codes(codes_b) if packed else codes_b
        norms[off:off + batch] = norms_b
    return codes, norms


def _mark(stage: str, t0: float, dev: Optional[torch.device] = None) -> float:
    """Logs a build pass's seconds at INFO.  A pass of the host build ends
    where the host waits for the card (a transfer); a stage of the device
    build names its device, which is synchronised first.  Either way the
    clock covers the pass's device work."""
    if dev is not None and dev.type == "cuda":
        torch.cuda.synchronize(dev)
    t = time.perf_counter()
    logger.info("IVF build pass %s: %.6f s", stage, t - t0)
    return t


def _pass1_rows(batch: int, C: int) -> int:
    """Rows a pass-1 chunk takes: ``batch``, fewer where the ``(rows, C)``
    f32 distances would pass 1 GB, never under 8,192."""
    return max(8192, min(batch, (1 << 28) // max(1, C)))


def _assign_block(instances: Tensor, coarse: Tensor, batch: int) -> Tensor:
    """The nearest coarse cell of every row, ``(n,)`` int32 on the rows'
    device, by :func:`_coarse_topk` in the host build's pass-1 chunks
    (:func:`_pass1_rows`).  On the card a product's rounding may follow its
    row count, so the same chunks give the same argmins, and the two builds
    at ``capacity=None`` the same cells."""
    n = instances.shape[0]
    b1 = _pass1_rows(batch, coarse.shape[0])
    out = torch.empty((n,), dtype=torch.int32, device=instances.device)
    for off in range(0, n, b1):
        out[off:off + b1] = _coarse_topk(instances[off:off + b1], coarse, 1)[:, 0]
    return out


def _respill_device(
    positions: Tensor, coarse: Tensor, fetch_rows, C: int, L: int, fill: Tensor, rounds: int = 64,
) -> Tuple[Tensor, Tensor, Tensor]:
    """Places the rows ``positions`` names (``fetch_rows`` takes positions
    and gives their rows) each in the nearest cell with space, on the rows'
    device.  Returns ``(cell, slot, remaining)``: ``(P,)`` int32 aligned
    with ``positions`` (``-1`` where unplaced), and the positions left
    unplaced, for :func:`_spill_place`.  ``fill`` (``(C,)`` int32 cell
    occupancy on the same device) is updated in place.

    The loop state (``fill``, placed cell, placed slot) keeps fixed shapes
    on the device; the host reads one scalar a round, the rows left.

    1. One pass caches each row's ``T`` nearest cells (``T`` at most 16,
       the cache about 1 GB at most).
    2. Each round a row targets its first cached cell with space.  A stable
       sort groups the rows by target, so each cell's free slots go to its
       rows in position order (the host greedy's priority); the others try
       again next round against the new occupancy.
    3. A round that places nothing redraws the candidates of the rows left
       among the cells that still have space, at most 8 times in
       ``rounds``.  The caller has checked that the free slots suffice, so
       each redraw places rows.
    """
    dev = coarse.device
    P = positions.shape[0]
    pc = torch.full((P,), -1, dtype=torch.int32, device=dev)
    ps = torch.full((P,), -1, dtype=torch.int32, device=dev)
    if not P:
        return pc, ps, positions
    T = int(min(C, max(4, (1 << 28) // P), 16))

    def draw(idx: Tensor, cells: Optional[Tensor]) -> Tensor:
        """The ``T`` nearest cells of the rows at ``positions[idx]`` among
        ``cells`` (all where None), padded with the sentinel ``C``."""
        pos = positions[idx]
        sub = coarse if cells is None else coarse[cells]
        t = min(T, sub.shape[0])
        b2 = max(4096, (1 << 26) // max(1, sub.shape[0]))
        cand = torch.cat([_coarse_topk(fetch_rows(pos[off:off + b2]), sub, t)
                          for off in range(0, pos.shape[0], b2)])
        if cells is not None:
            cand = cells[cand]
        if t < T:
            cand = torch.cat([cand, cand.new_full((pos.shape[0], T - t), C)], dim=1)
        return cand.to(torch.int32)

    cand = draw(torch.arange(P, device=dev), None)
    iota = torch.arange(P, dtype=torch.int32, device=dev)
    sentinel = fill.new_zeros(1)  # free space of the cell C: none
    prev_left, redraws, n_left, n_rounds = P + 1, 0, P, 0
    for _ in range(rounds):
        free = torch.cat([L - fill, sentinel])
        ok = free[cand] > 0
        has = ok.any(dim=1) & (pc < 0)
        first = ok.to(torch.int32).argmax(dim=1, keepdim=True)
        tgt = torch.where(has, cand.gather(1, first)[:, 0], C)
        by_tgt, order = torch.sort(tgt, stable=True)  # the rows left without a target sort last
        counts = torch.bincount(tgt, minlength=C + 1)[:C]
        starts = (torch.cumsum(counts, 0) - counts).to(torch.int32)
        rank = torch.empty_like(tgt)
        rank[order] = iota - starts[by_tgt.clamp(max=C - 1)]
        accept = has & (rank < free[tgt])
        slot = fill[tgt.clamp(max=C - 1)] + rank
        pc = torch.where(accept, tgt, pc)
        ps = torch.where(accept, slot, ps)
        fill += torch.bincount(torch.where(accept, tgt, C), minlength=C + 1)[:C].to(fill.dtype)
        n_rounds += 1
        n_left = int((pc < 0).sum())
        if n_left == 0:
            break
        if n_left == prev_left:  # every cached candidate is full: redraw
            space = torch.nonzero(fill < L)[:, 0]
            if space.numel() == 0 or redraws >= 8:
                break
            idx_left = torch.nonzero(pc < 0)[:, 0]
            cand[idx_left] = draw(idx_left, space)
            redraws += 1
            prev_left = P + 1
        else:
            prev_left = n_left
    logger.info("IVF respill: %d of %d rows placed on the device in %d rounds (%d redraws), "
                "%d left to the host spill", P - n_left, P, n_rounds, redraws, n_left)
    remaining = positions[torch.nonzero(pc < 0)[:, 0]] if n_left else positions[:0]
    return pc, ps, remaining


def _scatter_updates(
    cell_codes: Tensor, cell_ids: Tensor, cell_norms: Tensor, cc: Tensor, ss: Tensor,
    codes: Tensor, ids: Tensor, norms: Tensor, *, donate: bool = False,
) -> Tuple[Tensor, Tensor, Tensor]:
    """Writes rows into slots ``(cc, ss)`` of the three cell tensors and
    returns them.  By default copy-on-write: the given tensors are cloned
    first and stay as they were.  ``donate=True`` updates the given tensors
    in place, and so every index that shares them (where the JAX package
    invalidates a donated buffer, these are overwritten)."""
    if not donate:
        cell_codes, cell_ids, cell_norms = cell_codes.clone(), cell_ids.clone(), cell_norms.clone()
    cell_codes[cc, ss] = codes
    cell_ids[cc, ss] = ids.to(cell_ids.dtype)
    cell_norms[cc, ss] = norms.to(cell_norms.dtype)
    return cell_codes, cell_ids, cell_norms


def _build_ivf_device(
    coarse: Tensor, pq: Pq, instances: Tensor, *, capacity, on_overflow: str, dtype: torch.dtype,
    batch: int, use_kernel: bool, packed: bool,
) -> IvfPq:
    """The build with the placement, the encode and the cells on the
    instances' device (:func:`build_ivf` ``placement="device"``); the host
    reads a few scalars, and, under a bounded capacity, the overflow.

    1. Pass 1 (:func:`_assign_block`) takes each row's nearest cell.
    2. A stable sort groups the rows by cell, and ``rank = pos -
       starts[cell]`` numbers each row within its cell in corpus order, the
       host greedy's slot numbering: at ``capacity=None`` the cells equal
       the host build's bit for bit.
    3. ``slot_to_row`` (``(C * L,)``) comes by gathers: slot ``(c, l)``
       holds the ``l``-th row of cell ``c``, ``-1`` past its count.
    4. Pass 2 encodes every row against its nearest cell in corpus order,
       in the host build's ``batch`` chunks (:func:`_encode_rows`), into codes and
       ``(n,)`` norms; the cells are three gathers through ``slot_to_row``.

    Under a bounded capacity the rows ranked past ``L`` in their nearest
    cell (the overflow, ascending by corpus row) are dropped
    (``on_overflow="drop"``) or placed by :func:`_respill_device` in the
    nearest cell with space, the rows it leaves by :func:`_spill_place`,
    then re-encoded against that cell and written into the fresh cells in
    place.  Unlike the host build there is no tier of ``overflow_candidates``
    cells: a row within capacity always sits in its nearest cell.  Each
    stage's seconds are logged at INFO (``"IVF build pass ..."``: assign,
    placement, encode, gather, spill)."""
    dev = instances.device
    n = instances.shape[0]
    C = coarse.shape[0]

    t0 = time.perf_counter()
    assign = _assign_block(instances, coarse, batch)
    t0 = _mark("assign", t0, dev)

    counts = torch.bincount(assign, minlength=C)
    if capacity is None:
        L = int(counts.max())
    elif capacity == "auto":
        L = int(np.ceil(1.25 * n / C))
    else:
        L = int(capacity)
    starts = (torch.cumsum(counts, 0) - counts).to(torch.int32)
    by_cell, order = torch.sort(assign, stable=True)
    order = order.to(torch.int32)
    rank = torch.arange(n, dtype=torch.int32, device=dev) - starts[by_cell]
    cap_counts = counts.clamp(max=L)
    n_over = n - int(cap_counts.sum())
    over_rows = None
    if n_over:
        if on_overflow == "error":
            raise ValueError(
                f"IVF build: {n_over} rows exceed their nearest cell's capacity {L}; raise "
                f'capacity/n_cells, or use on_overflow="spill"'
            )
        if on_overflow == "spill" and C * L - (n - n_over) < n_over:
            raise ValueError(
                f"IVF build: total capacity C*L = {C * L} < n = {n}; "
                f"no spill placement exists — raise capacity"
            )
        over_rows = torch.sort(order[rank >= L]).values  # ascending by corpus row
    flat = torch.arange(C * L, dtype=torch.int32, device=dev)
    flat_c, flat_l = flat // L, flat % L
    occupied = flat_l < cap_counts[flat_c]
    src = (starts[flat_c] + flat_l).clamp(max=n - 1)
    slot_to_row = torch.where(occupied, order[src], -1)
    del by_cell, order, rank, starts, flat, flat_c, flat_l, src
    t0 = _mark("placement", t0, dev)

    enc = dict(batch=batch, use_kernel=use_kernel, dtype=dtype, packed=packed)
    codes_all, norms_all = _encode_rows(coarse, pq, instances, None, assign, **enc)
    del assign
    t0 = _mark("encode", t0, dev)

    rows = slot_to_row.clamp(min=0)
    cell_codes = codes_all[rows].masked_fill_(~occupied[:, None], 0).reshape(C, L, -1)
    cell_norms = norms_all[rows].masked_fill_(~occupied, 0.0).reshape(C, L)
    index = IvfPq(coarse_centroids=coarse, pq=pq, cell_codes=cell_codes,
                  cell_ids=slot_to_row.reshape(C, L), cell_norms=cell_norms)
    del codes_all, norms_all, rows, occupied
    t0 = _mark("gather", t0, dev)

    if n_over and on_overflow == "drop":
        index.dropped_ids = over_rows.cpu().numpy().astype(np.int64)
        logger.warning(
            "IVF build: %d rows exceeded their nearest cell's capacity %d and were dropped "
            "(ids on index.dropped_ids)", n_over, L,
        )
    elif n_over:
        fill = cap_counts.to(torch.int32)
        pc, ps, left = _respill_device(torch.arange(n_over, device=dev), coarse,
                                       lambda p: instances[over_rows[p]], C, L, fill)
        if left.numel():
            left_np, over_np = left.cpu().numpy(), over_rows.cpu().numpy()
            cell_of = np.full(n_over, -1, np.int64)
            slot_of = np.full(n_over, -1, np.int64)
            _spill_place(left_np, coarse, lambda p: instances[torch.from_numpy(over_np[p]).to(dev)],
                         C, L, fill.cpu().numpy().astype(np.int64), cell_of, slot_of)
            pc[left] = torch.from_numpy(cell_of[left_np]).to(dev, torch.int32)
            ps[left] = torch.from_numpy(slot_of[left_np]).to(dev, torch.int32)
        codes, norms = _encode_rows(coarse, pq, instances, over_rows, pc, **enc)
        _scatter_updates(index.cell_codes, index.cell_ids, index.cell_norms, pc, ps, codes,
                         over_rows, norms, donate=True)
        _mark("spill", t0, dev)
        logger.info("IVF build (device): %d rows spilled to the nearest cell with free space",
                    n_over)
    logger.info(
        "IVF build (device): %d rows -> %d cells, capacity %d (util %.0f%%)",
        n, C, L, 100.0 * (n - len(index.dropped_ids)) / (C * L),
    )
    return index


def build_ivf(
    coarse: Tensor,
    pq: Pq,
    instances,
    *,
    capacity=None,
    overflow_candidates: int = 4,
    on_overflow: str = "spill",
    dtype: torch.dtype = torch.uint8,
    batch: int = 262_144,
    use_kernel: Optional[bool] = None,
    packed: bool = False,
    placement: str = "auto",
) -> IvfPq:
    """Assign, residual-encode and scatter the ``(n, d)`` corpus into dense
    cells on the instances' device.

    Pass 1 takes each row's nearest coarse cells (``batch`` rows at a time,
    fewer where the ``(rows, C)`` distance block would pass 1 GB) into one
    candidate matrix on the card, moved to the host in one transfer (int16
    when ``C <= 32767``).  The host places the rows.  Pass 2 residual-encodes
    the placed rows against their storage cell on the card
    (:func:`_residual_encode_batch`), moves codes and norms to the host in
    one transfer each, and the host scatters them into the cells.  Each
    pass's seconds are logged at INFO (``"IVF build pass ..."``).

    ``capacity`` sets the cell size ``L``, and with it memory and probe cost:

    * ``None``: ``L`` = the largest cell; nothing moves or drops.
    * ``"auto"``: ``L = ceil(1.25 * n / C)``; a row that overflows its nearest
      cell goes to the first of its ``overflow_candidates`` nearest cells with
      space, encoded against that centroid.
    * an int: that ``L``, with the same overflow placement.

    ``on_overflow`` decides the rows that fit none of those cells:
    ``"spill"`` (default) places each in the nearest cell anywhere with
    space (``ValueError`` only when ``C * L < n``), ``"error"`` raises, and
    ``"drop"`` warns and records their ids on ``index.dropped_ids``.

    ``packed=True`` (``k <= 16``, even ``m``, ``dtype=torch.uint8``) stores
    two u4 codes a byte; search scores such cells bit for bit as the
    unpacked ones.  ``use_kernel=None`` means the encode kernel when the
    instances lie on a GPU.

    ``instances`` may be a reader for a corpus larger than the card (see
    :class:`_ReaderRows`): the build then runs on the coarse centroids'
    device and reads pass 1's chunks and pass 2's batches where it would
    slice a tensor, and the overflow rows by index, so its cells equal, bit
    for bit, the build from the same rows as a tensor.

    ``placement`` says where the cells are made:

    * ``"host"``: the path above.
    * ``"device"``: :func:`_build_ivf_device`, the placement, encode and
      cells on the instances' device; only a bounded build's overflow rows
      are placed apart.  At ``capacity=None`` its cells equal the host
      path's bit for bit.  Under a bounded capacity a row within capacity
      always sits in its nearest cell, and an overflow row goes to the
      nearest cell with space (no tier of ``overflow_candidates`` cells).
    * ``"auto"`` (default): ``"device"`` when the instances lie on a GPU
      and ``capacity is None`` (the JAX package takes it so on a TPU),
      ``"host"`` otherwise.
    """
    if placement not in ("auto", "host", "device"):
        raise ValueError(f'placement must be "auto", "host", or "device", got {placement!r}')
    if on_overflow not in ("spill", "error", "drop"):
        raise ValueError(f'on_overflow must be "spill", "error", or "drop", got {on_overflow!r}')
    if _is_reader(instances):
        instances = _ReaderRows(instances, coarse.device)
    if use_kernel is None:
        use_kernel = instances.is_cuda
    n = instances.shape[0]
    C = coarse.shape[0]
    m = pq.quantized_len
    if packed:
        if pq.n_quantizer_centroids > 16:
            raise ValueError(
                f"packed=True requires 4-bit codes (k <= 16), got k={pq.n_quantizer_centroids}"
            )
        if m % 2 != 0:
            raise ValueError(f"packed=True requires even m, got {m}")
        if dtype != torch.uint8:
            raise ValueError("packed=True requires dtype=uint8")
    if placement == "auto":
        placement = "device" if instances.is_cuda and capacity is None else "host"
    if placement == "device":
        return _build_ivf_device(coarse, pq, instances, capacity=capacity, on_overflow=on_overflow,
                                 dtype=dtype, batch=batch, use_kernel=use_kernel, packed=packed)
    dev = instances.device

    def fetch_rows(rows: np.ndarray) -> Tensor:
        return instances[torch.from_numpy(rows).to(dev)]

    bounded = capacity is not None
    A = min(overflow_candidates, C) if bounded else 1

    # Pass 1: the A nearest cells of every row, held on the card and moved
    # to the host in one transfer.
    t0 = time.perf_counter()
    b1 = _pass1_rows(batch, C)
    cands_dev = torch.empty((n, A), dtype=torch.int16 if C <= 32767 else torch.int32, device=dev)
    for off in range(0, n, b1):
        cands_dev[off:off + b1] = _coarse_topk(instances[off:off + b1], coarse, A)
    cands = cands_dev.cpu().numpy()
    del cands_dev
    t0 = _mark("candidates", t0)

    counts0 = np.bincount(cands[:, 0], minlength=C)
    if capacity is None:
        L = int(counts0.max())
    elif capacity == "auto":
        L = int(np.ceil(1.25 * n / C))
    else:
        L = int(capacity)

    cell_of, slot_of, fill = _greedy_place(cands, C, L)
    overflowed = np.flatnonzero(cell_of < 0)
    dropped_ids = np.empty(0, np.int64)
    if len(overflowed):
        if on_overflow == "error":
            raise ValueError(
                f"IVF build: {len(overflowed)} rows fit none of their {A} "
                f"candidate cells at capacity {L}; raise capacity/n_cells, "
                f'or use on_overflow="spill"'
            )
        if on_overflow == "spill":
            if C * L - int((cell_of >= 0).sum()) < len(overflowed):
                raise ValueError(
                    f"IVF build: total capacity C*L = {C * L} < n = {n}; "
                    f"no spill placement exists — raise capacity"
                )
            _spill_place(overflowed, coarse, fetch_rows, C, L, fill, cell_of, slot_of)
            logger.info("IVF build: %d rows spilled to the nearest cell with free space",
                        len(overflowed))
        else:  # "drop"
            dropped_ids = overflowed.astype(np.int64)
            logger.warning(
                "IVF build: %d rows fit none of their %d candidate cells at capacity %d and "
                "were dropped (ids on index.dropped_ids); raise capacity or n_cells",
                len(overflowed), A, L,
            )
    placed = cell_of >= 0
    moved = int((cell_of[placed] != cands[placed, 0]).sum())
    del cands
    t0 = _mark("placement", t0)

    # Pass 2: residual codes and norms of the placed rows on the card, moved
    # to the host in one transfer each.
    placed_rows = np.flatnonzero(placed)
    cc_all, slots_all = cell_of[placed_rows], slot_of[placed_rows]
    codes_dev, norms_dev = _encode_rows(
        coarse, pq, instances, torch.from_numpy(placed_rows).to(dev),
        torch.from_numpy(cc_all).to(dev), batch=batch, use_kernel=use_kernel, dtype=dtype,
        packed=packed)
    codes_all = codes_dev.cpu().numpy()
    norms_all = norms_dev.cpu().numpy()
    del codes_dev, norms_dev
    t0 = _mark("encode", t0)

    cell_codes = np.zeros((C, L, codes_all.shape[1]), dtype=codes_all.dtype)
    cell_ids = np.full((C, L), -1, dtype=np.int32)
    cell_norms = np.zeros((C, L), np.float32)
    cell_codes[cc_all, slots_all] = codes_all
    cell_ids[cc_all, slots_all] = placed_rows
    cell_norms[cc_all, slots_all] = norms_all
    index = IvfPq(
        coarse_centroids=coarse, pq=pq, cell_codes=torch.from_numpy(cell_codes).to(dev),
        cell_ids=torch.from_numpy(cell_ids).to(dev), cell_norms=torch.from_numpy(cell_norms).to(dev),
        dropped_ids=dropped_ids,
    )
    _mark("scatter", t0)
    logger.info(
        "IVF build: %d rows -> %d cells, capacity %d (mean %.0f, util %.0f%%, %d rows in "
        "secondary cells)",
        n, C, L, counts0.mean(), 100.0 * (n - len(dropped_ids)) / (C * L), moved,
    )
    return index


# ---------------------------------------------------------------------------
# Updates
# ---------------------------------------------------------------------------


def _add_fast_gate(cell_ids: Tensor, assign: Tensor, L: int) -> Tuple[Tensor, Tensor]:
    """The placement of an add batch in which every row fits a free slot of
    its nearest cell (``assign``), on the cells' device.  Returns
    ``(overflow, slot)``: ``overflow`` (a 0-d bool tensor, the one value the
    host reads) is true when some cell has fewer free slots than rows, and
    ``slot[r]`` is row ``r``'s slot, the ``rank(r)``-th free slot of its
    cell in ascending order (ranks in batch order within a cell, as
    :func:`_assign_free_slots` numbers them)."""
    C = cell_ids.shape[0]
    n_new = assign.shape[0]
    occupied = cell_ids >= 0
    counts = torch.bincount(assign, minlength=C)
    overflow = (counts > L - occupied.sum(dim=1)).any()
    by_cell, order = torch.sort(assign, stable=True)
    starts = torch.cumsum(counts, 0) - counts
    rank = torch.empty((n_new,), dtype=torch.int64, device=assign.device)
    rank[order] = torch.arange(n_new, device=assign.device) - starts[by_cell]
    # A stable sort of the occupancy puts each cell's free slots first, in
    # ascending order.
    free_order = torch.sort(occupied.to(torch.int32), dim=1, stable=True).indices
    return overflow, free_order[assign, rank.clamp(max=L - 1)].to(torch.int32)


def _assign_free_slots(cell_of: np.ndarray, slot_of: np.ndarray, cell_ids: Tensor) -> np.ndarray:
    """The real free slots of rows :func:`_greedy_place` placed, whose
    slots ``fill + rank`` assume that each cell is filled from slot 0, as
    it is after a build but not after :func:`ivf_remove` leaves holes.  The
    rows of each cell, in ``slot_of`` order, take its free slots in
    ascending order; the occupancy is read on the cells' device, only in
    the cells touched."""
    out = np.full_like(slot_of, -1)
    placed = np.flatnonzero(cell_of >= 0)
    if not len(placed):
        return out
    rows = placed[np.lexsort((slot_of[placed], cell_of[placed]))]
    cells = cell_of[rows]
    touched, tinv = np.unique(cells, return_inverse=True)
    run_start = np.searchsorted(cells, touched)  # cells is sorted: each run's first row
    ranks = np.arange(len(rows)) - run_start[tinv]
    dev = cell_ids.device
    occ = cell_ids[torch.from_numpy(touched).to(dev)] >= 0
    free_order = torch.sort(occ.to(torch.int32), dim=1, stable=True).indices
    slots = free_order[torch.from_numpy(tinv).to(dev), torch.from_numpy(ranks).to(dev)]
    out[rows] = slots.cpu().numpy()
    return out


def _host_ids(ids) -> np.ndarray:
    """Ids given as a tensor (on any device) or an array, as int64 numpy."""
    if isinstance(ids, Tensor):
        ids = ids.cpu().numpy()
    return np.asarray(ids, dtype=np.int64)


def ivf_add(
    index: IvfPq,
    instances: Tensor,
    ids=None,
    *,
    overflow_candidates: int = 4,
    on_overflow: str = "spill",
    batch: int = 262_144,
    use_kernel: Optional[bool] = None,
    donate: bool = False,
) -> IvfPq:
    """Adds the ``(n_new, d)`` rows ``instances`` (a tensor on the index's
    device) to the index and returns the new index; by default the input
    index stays as it was.

    A new row goes to a free slot of its nearest coarse cell, else of the
    first of its ``overflow_candidates`` nearest cells with one; under
    ``on_overflow="spill"`` (default) a row that fits none of them goes to
    the nearest cell anywhere with space, ``"error"`` raises and ``"drop"``
    warns and adds its id to ``dropped_ids`` (which carries the input
    index's).  Slots :func:`ivf_remove` freed are taken again.  The
    quantizers are not retrained: when the cells fill up (``ValueError``:
    total free capacity), rebuild with :func:`build_ivf` at a larger
    capacity.

    ``ids`` (int64 array or tensor) are the corpus ids of the new rows;
    the default is ``max(live ids) + 1 + arange(n_new)``.  They must be
    non-negative (``-1`` marks an empty slot), below 2^31 (the cells hold
    int32), distinct, and none may be live in the index.

    When every row fits a free slot of its nearest cell (the fast path,
    logged at INFO as ``"IVF add (device fast path)"``) the placement
    (:func:`_add_fast_gate`), encode and writes stay on the device, and the
    host reads one flag; otherwise the host places the rows as
    :func:`build_ivf` does and :func:`_assign_free_slots` maps them to real
    free slots.  The encode takes ``batch`` rows at a time
    (:func:`_residual_encode_batch`; packed indexes through
    :func:`reductive_tpu_torch.ops.pack_u4_codes`).

    By default the cells are copied before the write (one copy of the cell
    tensors on the device).  ``donate=True`` writes into the input index's
    cell tensors in place, and so into every index that shares them: the
    index :func:`ivf_remove` returns shares ``cell_codes`` and
    ``cell_norms`` with its input, so a donated add to it overwrites the
    codes and norms of the index before the remove as well, which then no
    longer match its ids.  Use it where only the newest index is kept.
    """
    if _is_reader(instances):
        raise TypeError(
            "ivf_add takes a device/host array; for reader-scale corpora rebuild with "
            "build_ivf(reader)"
        )
    if on_overflow not in ("spill", "error", "drop"):
        raise ValueError(f'on_overflow must be "spill", "error", or "drop", got {on_overflow!r}')
    dev = index.cell_ids.device
    if not isinstance(instances, Tensor):
        raise ValueError(f"instances must be a tensor on the index's device ({dev}), got "
                         f"{type(instances).__name__}")
    if instances.device != dev:
        raise ValueError(f"instances lie on {instances.device}, the index on {dev}: move them there")
    if use_kernel is None:
        use_kernel = instances.is_cuda
    n_new = instances.shape[0]
    coarse, pq = index.coarse_centroids, index.pq
    C, L = index.n_cells, index.capacity

    if ids is None:
        start = max(int(index.cell_ids.max()) + 1, 0)  # -1 (no live slot) starts at 0
        ids = start + np.arange(n_new, dtype=np.int64)
        if ids[-1] >= 2 ** 31:
            raise ValueError(
                f"auto-assigned ids would exceed int32 (next id {start}, {n_new} new rows); "
                f"pass explicit ids"
            )
    else:
        ids = _host_ids(ids)
        if ids.shape != (n_new,):
            raise ValueError(f"ids has shape {ids.shape}, expected ({n_new},)")
        if ids.min(initial=0) < 0:
            raise ValueError("ids must be non-negative (-1 marks empty slots)")
        if ids.max(initial=0) >= 2 ** 31:
            # A wrapped id would be stored negative (empty) or alias a live one.
            raise ValueError(
                f"ids must fit int32 (max allowed {2 ** 31 - 1}, got {int(ids.max())})")
        if len(np.unique(ids)) != n_new:
            raise ValueError("duplicate ids in the batch")
        clash = torch.isin(torch.from_numpy(ids.astype(np.int32)).to(dev),
                           index.cell_ids.ravel()).cpu().numpy()
        if clash.any():
            raise ValueError(
                f"{int(clash.sum())} ids already live in the index "
                f"(first: {np.sort(ids[clash])[:5].tolist()}); ivf_remove them first"
            )
    ids_dev = torch.from_numpy(ids.astype(np.int32)).to(dev)
    enc = dict(batch=batch, use_kernel=use_kernel, dtype=index.cell_codes.dtype,
               packed=index.packed)

    assign = _assign_block(instances, coarse, batch)
    overflow, slot = _add_fast_gate(index.cell_ids, assign, L)
    if not bool(overflow):
        codes, norms = _encode_rows(coarse, pq, instances, None, assign, **enc)
        cell_codes, cell_ids, cell_norms = _scatter_updates(
            index.cell_codes, index.cell_ids, index.cell_norms, assign, slot, codes, ids_dev, norms,
            donate=donate)
        logger.info("IVF add (device fast path): %d rows placed", n_new)
        return IvfPq(coarse_centroids=coarse, pq=pq, cell_codes=cell_codes, cell_ids=cell_ids,
                     cell_norms=cell_norms, dropped_ids=index.dropped_ids)
    del assign, slot

    fill = (index.cell_ids >= 0).sum(dim=1).cpu().numpy().astype(np.int64)
    free_total = int(C * L - fill.sum())
    if free_total < n_new and on_overflow != "drop":
        raise ValueError(
            f"IVF add: total free capacity {free_total} < {n_new} new rows; rebuild with "
            f"build_ivf at a larger capacity"
        )

    def fetch_rows(rows: np.ndarray) -> Tensor:
        return instances[torch.from_numpy(rows).to(dev)]

    A, b1 = min(overflow_candidates, C), _pass1_rows(batch, C)
    cands = torch.cat([_coarse_topk(instances[off:off + b1], coarse, A)
                       for off in range(0, n_new, b1)]).cpu().numpy().astype(np.int64)
    cell_of, slot_of, fill = _greedy_place(cands, C, L, fill)
    overflowed = np.flatnonzero(cell_of < 0)
    dropped_ids = np.empty(0, np.int64)
    if len(overflowed):
        if on_overflow == "error":
            raise ValueError(
                f"IVF add: {len(overflowed)} rows fit none of their {A} candidate cells at "
                f'capacity {L}; raise capacity or use on_overflow="spill"'
            )
        if on_overflow == "spill":
            _spill_place(overflowed, coarse, fetch_rows, C, L, fill, cell_of, slot_of)
        else:  # "drop"
            dropped_ids = ids[overflowed]
            logger.warning("IVF add: %d rows dropped (ids on index.dropped_ids)", len(overflowed))
    slot_of = _assign_free_slots(cell_of, slot_of, index.cell_ids)

    placed = np.flatnonzero(cell_of >= 0)
    cell_codes, cell_ids, cell_norms = index.cell_codes, index.cell_ids, index.cell_norms
    if len(placed):
        placed_dev = torch.from_numpy(placed).to(dev)
        cells = torch.from_numpy(cell_of[placed]).to(dev, torch.int32)
        codes, norms = _encode_rows(coarse, pq, instances, placed_dev, cells, **enc)
        cell_codes, cell_ids, cell_norms = _scatter_updates(
            cell_codes, cell_ids, cell_norms, cells,
            torch.from_numpy(slot_of[placed]).to(dev, torch.int32), codes, ids_dev[placed_dev],
            norms, donate=donate)
    logger.info("IVF add: %d rows placed (%d dropped)", len(placed), len(dropped_ids))
    return IvfPq(coarse_centroids=coarse, pq=pq, cell_codes=cell_codes, cell_ids=cell_ids,
                 cell_norms=cell_norms,
                 dropped_ids=np.concatenate([index.dropped_ids, dropped_ids]))


def ivf_remove(index: IvfPq, ids) -> IvfPq:
    """Removes the rows of the given corpus ids (array or tensor) and
    returns the new index: their slots become empty (``-1``, masked when
    scored) for :func:`ivf_add` to take again, and the cells keep their
    shapes.  Ids not in the index are ignored, so a remove can be repeated;
    ids outside ``[0, 2^31)`` cannot be in it and are dropped before the
    int32 cast.  The match runs on the index's device.

    Only ``cell_ids`` is new: the result shares ``cell_codes`` and
    ``cell_norms`` with the input, so an ``ivf_add(..., donate=True)`` on
    either index writes into both (see :func:`ivf_add`)."""
    ids = np.unique(_host_ids(ids).ravel())
    ids = ids[(ids >= 0) & (ids < 2 ** 31)]
    cell_ids = index.cell_ids
    kill = torch.isin(cell_ids, torch.from_numpy(ids.astype(np.int32)).to(cell_ids.device))
    kill &= cell_ids >= 0
    if logger.isEnabledFor(logging.INFO):  # the count waits for the device
        logger.info("IVF remove: %d of %d requested ids removed", int(kill.sum()), len(ids))
    return IvfPq(coarse_centroids=index.coarse_centroids, pq=index.pq,
                 cell_codes=index.cell_codes, cell_ids=cell_ids.masked_fill(kill, -1),
                 cell_norms=index.cell_norms, dropped_ids=index.dropped_ids)


# ---------------------------------------------------------------------------
# Search
# ---------------------------------------------------------------------------


def _coarse_scores(queries: Tensor, coarse: Tensor, metric: str) -> Tuple[Tensor, Tensor, Tensor]:
    """``(qc, score_c, q_sqn)``: the ``(nq, C)`` products ``q.c``, the
    cells' probe scores (larger is nearer: ``q.c`` for ``"dot"``, the
    negated squared distance for ``"l2"``) and ``|q|^2`` (None for
    ``"dot"``)."""
    qc = torch.matmul(queries, coarse.T)
    if metric == "dot":
        return qc, qc, None
    q_sqn = torch.sum(queries * queries, dim=1)
    c_sqn = torch.sum(coarse * coarse, dim=1)
    return qc, -(q_sqn[:, None] + c_sqn[None, :] - 2.0 * qc), q_sqn


def _probe_and_score_lut(
    queries: Tensor, coarse: Tensor, cell_codes: Tensor, cell_ids: Tensor, cell_norms: Tensor,
    pq: Pq, nprobe: int, top_k: int, splits, metric: str = "l2",
    scored: Optional[Tuple[Tensor, Tensor, Optional[Tensor]]] = None,
) -> Tuple[Tensor, Tensor]:
    """The ADC-table probe: the final ``(dists, ids)``, ``(nq, top_k)``.

    The union of the probed cells is scored once against every query by
    :func:`reductive_tpu_torch.ops.adc_scores_kernel` over ``-q.rec``
    tables (``q.rec = sum_j T[q, j, code_j]``; the orthonormal projection
    keeps inner products), in chunks of cells whose ``(nq, cells * L)``
    scores stay under ``_PROBE_LUT_BUDGET``; each query masks the cells it
    did not probe and the empty slots, and a running top-k keeps the best,
    ties in (cell, slot) order.  Queries that probe the same cell share its
    rows.  ``splits`` sets the tables' precision (2: about 2^-18
    relative).  ``scored``: :func:`_coarse_scores` of these cells where the
    caller has them (:func:`ivf_search_sharded`).

    Spans: ``ivf.probe`` (the cells' scores, the probe and the union),
    ``ivf.tables``, and for each chunk ``ivf.adc`` (the kernel),
    ``ivf.mask`` (the scores assembled, the cells not probed masked) and
    ``ivf.select`` (the chunk's top-k merged with the best-so-far).
    Counters: ``ivf.slots_scored``, the (query, slot) pairs scored, and
    ``ivf.slots_probed``, those of each query's own probed cells."""
    C, L, mb = cell_codes.shape
    m = pq.quantized_len
    nq = queries.shape[0]
    with span("ivf.probe"):
        qc, score_c, q_sqn = scored or _coarse_scores(queries, coarse, metric)
        probe = _smallest(-score_c, None, nprobe)[1]  # (nq, nprobe)
        cells_u = torch.unique(probe)                 # ascending
    U = cells_u.shape[0]
    count("ivf.slots_probed", nq * nprobe * L)
    with span("ivf.tables"):
        tables = adc_tables(pq, queries, metric="dot")  # (nq, m, k): -q.rec
    cc = max(1, min(U, _PROBE_LUT_BUDGET // (4 * max(nq, 1) * L)))
    K = min(top_k, U * L)
    best_d = best_i = None
    for c0 in range(0, U, cc):
        cu = cells_u[c0:c0 + cc]
        n_c = cu.shape[0]
        count("ivf.slots_scored", nq * n_c * L)
        with span("ivf.adc"):
            raw = ops.adc_scores_kernel(tables, cell_codes[cu].reshape(n_c * L, mb),
                                        splits=splits, packed=mb != m).reshape(nq, n_c, L)
        with span("ivf.mask"):
            ids_c = cell_ids[cu].reshape(n_c * L)
            qc_c = qc[:, cu][:, :, None]
            if metric == "dot":
                sc = raw - qc_c
            else:
                sc = (q_sqn[:, None, None] + cell_norms[cu].reshape(1, n_c, L) + 2.0 * raw
                      - 2.0 * qc_c)
            probed = (probe[:, :, None] == cu[None, None, :]).any(dim=1)  # (nq, n_c)
            mask = probed[:, :, None] & (ids_c.reshape(1, n_c, L) >= 0)
            sc = torch.where(mask, sc, torch.full_like(sc, float("inf"))).reshape(nq, n_c * L)
        with span("ivf.select"):
            d, pos = _smallest(sc, None, min(K, n_c * L))
            i = ids_c[pos]
            if best_d is not None:
                d, i = _smallest(torch.cat([best_d, d], dim=1), torch.cat([best_i, i], dim=1),
                                 K)
        best_d, best_i = d, i
    ids = torch.where(torch.isfinite(best_d), best_i, torch.full_like(best_i, -1))
    return _pad(best_d, ids, top_k)


def _probe_and_score(
    queries: Tensor, coarse: Tensor, cell_codes: Tensor, cell_ids: Tensor, cell_norms: Tensor,
    pq: Pq, nprobe: int, use_kernel: bool, splits, metric: str = "l2",
    scored: Optional[Tuple[Tensor, Tensor, Optional[Tensor]]] = None,
) -> Tuple[Tensor, Tensor]:
    """The decode probe: flattened ``(scores, ids)``, ``(nq, nprobe * L)``,
    of the ``nprobe`` best cells of every query (empty slots at ``+inf`` /
    ``-1``).  ``metric="dot"`` probes the largest ``q.c`` and scores
    ``-(q.c + q.rec)``; ``scored`` as for :func:`_probe_and_score_lut`.

    The probed candidates are decoded (with the kernel:
    :func:`reductive_tpu_torch.ops.pq_decode` at ``splits``; without: a
    gather; packed cells unpacked first, exactly) and dotted with the
    (rotated) queries, the probes in chunks so that the ``(nq, probes, L,
    d)`` reconstruction stays under ``_PROBE_RECON_BUDGET``, and the cell
    rows too when one probe alone exceeds it.

    Spans ``ivf.probe`` and ``ivf.mask`` as in :func:`_probe_and_score_lut`;
    both counters add the pairs of the probed cells, all that is scored."""
    cb = pq.codebooks
    m, _, ds = cb.shape
    d = m * ds
    nq = queries.shape[0]
    L, mb = cell_codes.shape[1], cell_codes.shape[2]
    with span("ivf.probe"):
        qc, score_c, q_sqn = scored or _coarse_scores(queries, coarse, metric)
        probe = _smallest(-score_c, None, nprobe)[1]  # (nq, nprobe)
    count("ivf.slots_probed", nq * nprobe * L)
    count("ivf.slots_scored", nq * nprobe * L)
    qc_g = torch.gather(qc, 1, probe)
    codes_g = cell_codes[probe]                   # (nq, nprobe, L, mb)
    ids_g = cell_ids[probe]
    norms_g = cell_norms[probe]
    qr = torch.matmul(queries, pq.projection) if pq.projection is not None else queries

    def qdot(codes_chunk: Tensor) -> Tensor:  # (nq, pc, lc, mb) -> (nq, pc, lc)
        pc, lc = codes_chunk.shape[1], codes_chunk.shape[2]
        flat = codes_chunk.reshape(nq * pc * lc, mb)
        if mb != m:  # packed cells: the unpack is exact
            flat = ops.unpack_u4_codes(flat)
        if use_kernel:
            rec = ops.pq_decode(cb, flat, splits=splits)
        else:
            rec = primitives.reconstruct_batch(cb, flat, method="gather")
        return torch.bmm(rec.reshape(nq, pc * lc, d), qr[:, :, None]).reshape(nq, pc, lc)

    budget = _PROBE_RECON_BUDGET
    if nq * L * d * 4 <= budget:
        pc = max(1, min(nprobe, budget // max(1, nq * L * d * 4)))
        dot = torch.cat([qdot(codes_g[:, p0:p0 + pc]) for p0 in range(0, nprobe, pc)], dim=1)
    else:
        lc = max(1, budget // max(1, nq * d * 4))
        dot = torch.stack([
            torch.cat([qdot(codes_g[:, p, None, l0:l0 + lc]) for l0 in range(0, L, lc)], dim=2)[:, 0]
            for p in range(nprobe)
        ], dim=1)

    with span("ivf.mask"):
        if metric == "dot":
            scores = -(qc_g[:, :, None] + dot)
        else:
            scores = q_sqn[:, None, None] + norms_g - 2.0 * qc_g[:, :, None] - 2.0 * dot
        scores = torch.where(ids_g >= 0, scores, torch.full_like(scores, float("inf")))
    return scores.reshape(nq, -1), ids_g.reshape(nq, -1)


def _pad(dists: Tensor, ids: Tensor, top_k: int) -> Tuple[Tensor, Tensor]:
    """Pads ``(nq, kk)`` results to ``top_k`` columns with ``+inf`` / ``-1``."""
    pad = top_k - dists.shape[1]
    if pad <= 0:
        return dists, ids
    nq = dists.shape[0]
    return (torch.cat([dists, dists.new_full((nq, pad), float("inf"))], dim=1),
            torch.cat([ids, ids.new_full((nq, pad), -1)], dim=1))


def _padded_topk(flat_scores: Tensor, flat_ids: Tensor, top_k: int) -> Tuple[Tensor, Tensor]:
    """Top-``top_k`` by ascending score, ties by position, padded with
    ``+inf`` / ``-1`` when fewer candidates exist."""
    dists, ids = _smallest(flat_scores, flat_ids, min(top_k, flat_scores.shape[1]))
    return _pad(dists, ids, top_k)


def _ivf_search_once(
    index: IvfPq, queries: Tensor, top_k: int, nprobe: int, use_kernel: bool, splits, metric: str,
    scored: Optional[Tuple[Tensor, Tensor, Optional[Tensor]]] = None,
) -> Tuple[Tensor, Tensor]:
    """One probe route, chosen before any launch: with the kernels, the
    ADC-table probe, unless one query's tables do not fit a block's shared
    memory, and then the decode probe (its top-k the span ``ivf.select``);
    without, the decode probe."""
    pq = index.pq
    m, k = pq.n_subquantizers, pq.n_quantizer_centroids
    args = (index.coarse_centroids, index.cell_codes, index.cell_ids, index.cell_norms, pq, nprobe)
    if use_kernel and query_tile(m, k, splits) > 0:
        qb = max_query_batch(m, k, splits)
        parts = [_probe_and_score_lut(
            queries[i:i + qb], *args, top_k, splits, metric,
            scored=None if scored is None else tuple(
                None if t is None else t[i:i + qb] for t in scored))
            for i in range(0, queries.shape[0], qb)]
        return torch.cat([p[0] for p in parts]), torch.cat([p[1] for p in parts])
    if use_kernel:
        logger.info("IVF search: one query's ADC tables (m=%d, k=%d, splits=%r) do not fit a "
                    "block's shared memory; scoring by the decode probe", m, k, splits)
    flat = _probe_and_score(queries, *args, use_kernel, splits, metric, scored=scored)
    with span("ivf.select"):
        return _padded_topk(*flat, top_k)


def ivf_search(
    index: IvfPq,
    queries: Tensor,
    top_k: int = 10,
    *,
    nprobe: int = 8,
    use_kernel: Optional[bool] = None,
    splits=2,
    refine_with=None,
    refine_factor: int = 4,
    metric: str = "l2",
) -> Tuple[Tensor, Tensor]:
    """Top-``top_k`` approximate neighbours of each query, scanning only its
    ``nprobe`` nearest coarse cells.  Returns ``(distances, ids)`` of shape
    ``(nq, top_k)``: f32 approximate squared distances, ascending, and int64
    corpus rows; fewer than ``top_k`` candidates pad with ``-1`` /
    ``+inf``.

    ``use_kernel=None`` means the kernels when the index lies on a GPU: the
    ADC-table probe (:func:`_probe_and_score_lut`, the ADC kernel over the
    union of the probed cells, tables at ``splits`` precision: 1, 2, 3 or
    ``"int8"``), or, where one query's tables do not fit a block's shared
    memory, the decode probe with the decode kernel at ``splits``.  Without
    the kernels the decode probe decodes by a gather (f32 exact).

    ``metric="dot"`` ranks by maximum inner product: cells are probed by
    largest ``q.c`` and the returned "distances" are negated inner products.
    ``refine_with`` (the original ``(n, d)`` vectors, or a reader for a
    corpus larger than the card, of which only the candidate rows are read)
    re-scores the best ``top_k * refine_factor`` candidates exactly and
    keeps ``top_k``, as :func:`reductive_tpu_torch.search.search` does.

    Under a ``torch.profiler`` session the call records the span
    ``ivf.search`` around the probe's spans and counters and the refine
    (:mod:`reductive_tpu_torch.utils.profiling`).
    """
    _check_metric(metric)
    if top_k <= 0:
        raise ValueError("top_k must be >= 1")
    if not 1 <= nprobe <= index.n_cells:
        raise ValueError(f"nprobe must be in 1..{index.n_cells} (the index's cells), got {nprobe}")
    if use_kernel is None:
        use_kernel = index.cell_codes.is_cuda
    if refine_with is not None and refine_factor < 1:
        raise ValueError("refine_factor must be >= 1")
    with span("ivf.search"):
        if refine_with is not None:
            _, cand = _ivf_search_once(index, queries, top_k * refine_factor, nprobe, use_kernel,
                                       splits, metric)
            return _refine(queries, refine_with, cand.to(torch.int64), top_k, metric)
        dists, ids = _ivf_search_once(index, queries, top_k, nprobe, use_kernel, splits, metric)
        return dists.to(torch.float32), ids.to(torch.int64)


def ivf_search_sharded(
    index: IvfPq,
    queries: Tensor,
    top_k: int = 10,
    *,
    nprobe: int = 8,
    mesh,
    cell_axis: str = "data",
    use_kernel: Optional[bool] = None,
    splits=2,
    metric: str = "l2",
) -> Tuple[Tensor, Tensor]:
    """IVF search over cells sharded over the ranks of ``cell_axis`` of
    ``mesh`` (:func:`reductive_tpu_torch.parallel.make_mesh`), one process
    a rank, each making the same call with the whole ``index``.

    Rank ``r`` of ``R`` moves cells ``[r C'/R, (r+1) C'/R)`` to its device,
    ``C'`` being the cell count rounded up to a multiple of ``R`` with empty
    cells (ids ``-1``), which no probe prefers to a real cell; it probes the
    ``nprobe`` nearest of its own cells for every query by
    :func:`ivf_search`'s route, and the ranks' ``(nq, top_k)`` results are
    gathered in rank order and the best ``top_k`` kept.  A cell among a
    query's ``nprobe`` nearest of all is among the nearest of its own rank
    (fewer than ``nprobe`` cells are nearer anywhere), so the probed cells
    are a superset of :func:`ivf_search`'s at the same ``nprobe``, and the
    result is at least as good; with every cell probed it is
    :func:`ivf_search`'s bit for bit (each query's cell products are taken
    against all the cells at once, as there).  ``metric="dot"`` reads
    "nearest" as the largest inner product.  ``cell_ids`` are corpus rows,
    so the merged ids are too.  Returns ``(distances, ids)`` on the rank's
    device, f32 and int64.
    """
    from .parallel.mesh import axis_group, mesh_device

    _check_metric(metric)
    group, size, rank = axis_group(mesh, cell_axis)
    C = index.n_cells
    per = -(-C // size)
    if nprobe > per:
        raise ValueError(f"nprobe={nprobe} exceeds the per-shard cell count {per}")
    dev = mesh_device(mesh)
    if use_kernel is None:
        use_kernel = dev.type == "cuda"
    lo, hi = min(rank * per, C), min((rank + 1) * per, C)
    pad = per - (hi - lo)

    def cells(t: Tensor, fill) -> Tensor:
        local = t[lo:hi].to(dev)
        return torch.cat([local, local.new_full((pad,) + tuple(t.shape[1:]), fill)])

    local = IvfPq(
        coarse_centroids=cells(index.coarse_centroids, 0.0), pq=_on_device(index.pq, dev),
        cell_codes=cells(index.cell_codes, 0), cell_ids=cells(index.cell_ids, -1),
        cell_norms=cells(index.cell_norms, 0.0),
    )
    queries = queries.to(dev)
    qc, score_c, q_sqn = _coarse_scores(queries, index.coarse_centroids.to(dev), metric)
    nq = queries.shape[0]
    scored = (
        torch.cat([qc[:, lo:hi], qc.new_zeros((nq, pad))], dim=1),
        torch.cat([score_c[:, lo:hi], score_c.new_full((nq, pad), -float("inf"))], dim=1),
        q_sqn,
    )
    dists, ids = _ivf_search_once(local, queries, top_k, nprobe, use_kernel, splits, metric,
                                  scored=scored)
    return _merge_ranks(group, dists.to(torch.float32), ids.to(torch.int64), top_k)
