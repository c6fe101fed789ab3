"""Sharded k-means and PQ training and encode over a device mesh.

Counterpart of ``reductive_tpu.parallel.sharded``.  JAX runs one SPMD
program over a ``Mesh``: each entry takes the global array and lays it out
over the devices.  Here there is one process a rank (a card), and every
rank makes the same call with the same global arguments; each entry

* moves only this rank's rows to its device: rank ``r`` of ``R`` on the
  ``data`` axis takes rows ``[r n/R, (r+1) n/R)`` (``n`` must divide
  evenly, as in the JAX package);
* sums the centroid statistics (per-centroid sums and counts, and the sums
  of squares) over the axis's process group by one all-reduce an
  iteration, where JAX ``psum``s them: the update that follows runs on
  every rank alike, so every rank returns the same model, as JAX returns a
  replicated one;
* gathers encoded rows over the group, where JAX returns them sharded: the
  codes come back whole, in corpus order, on every rank.

On a GPU each rank's statistics, encode and decode go through the port's
kernels, as the single-card entries do (``use_kernel=None``); at one rank
every trainer gives the bits of its single-card counterpart.  Random draws
take a ``torch.Generator`` on the rank's device where JAX takes a key; every
rank passes one with the same seed and so makes the same draws.  The
initial centroids are drawn from the global matrix (or, streamed, from the
whole reader), as the single-card trainers draw them.

JAX's ``_local_stats`` + ``psum`` building block is the ``group=`` keyword
of :func:`reductive_tpu_torch.pq.train.lloyd_iteration_chunked`,
:func:`reductive_tpu_torch.kmeans.lloyd_iteration_batched` and
``pq.opq._opq_iteration_chunked``; ``_finish_update`` is
:func:`reductive_tpu_torch.pq.train.centroids_from_stats`.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch
from torch import Tensor
from torch.distributed.device_mesh import DeviceMesh

from .._collectives import all_gather_rows, all_reduce, broadcast_first
from .._device import check_generator
from ..data import _np_dtype, _reader_batches, stream_encode_batches
from ..errors import check_quantizer_invariants
from ..linalg import row_covariance
from ..pq.model import Pq, _on_device
from ..pq.opq import _opq_iteration_chunked, projection_from_covariance
from ..pq.streamed import _init_streamed_codebooks, _new_stats, _stats_step, _stream_pass
from ..pq.train import (
    _check_compute_dtype,
    _streamed_sumsq,
    centroids_from_stats,
    init_codebooks_random,
    lloyd_iteration_chunked,
    losses_from_stats,
    train_pq_subspace_with_centroids,
)
from .mesh import axis_group, mesh_device

__all__ = [
    "sharded_kmeans",
    "sharded_pq_train_step",
    "train_pq_sharded",
    "train_pq_chunked_sharded",
    "train_opq_chunked_sharded",
    "train_pq_streamed_sharded",
    "encode_sharded",
    "stream_encode_sharded",
]


def _shard(n: int, size: int, index: int) -> Tuple[int, int]:
    """This rank's rows ``[lo, hi)`` of ``n``."""
    if n % size != 0:
        raise ValueError(f"n={n} must divide evenly over data axis ({size} shards)")
    per = n // size
    return index * per, (index + 1) * per


def _local_rows(x, size: int, index: int, device: torch.device) -> Tensor:
    """This rank's rows of the global matrix ``x`` (a tensor anywhere, or a
    host array, which is not copied whole) on ``device``."""
    x = torch.as_tensor(x)
    lo, hi = _shard(x.shape[0], size, index)
    return x[lo:hi].to(device)


def _keep_better(best, cb: Tensor, loss: Tensor):
    """Per subquantizer the attempt of least loss; ties keep the earlier."""
    if best is None:
        return cb, loss
    better = loss < best[1]
    return torch.where(better[:, None, None], cb, best[0]), torch.minimum(best[1], loss)


# ---------------------------------------------------------------------------
# Explicit building blocks
# ---------------------------------------------------------------------------


def sharded_kmeans_iteration(
    x_local: Tensor, centroids: Tensor, data_axis: str = "data", *, mesh: DeviceMesh,
    sumsq: Optional[Tensor] = None, chunk: int = 32768, use_kernel: Optional[bool] = None,
) -> Tuple[Tensor, Tensor]:
    """One data-parallel Lloyd's iteration.  ``x_local`` is this rank's
    ``(n_local, d)`` shard (equal on every rank), ``centroids`` the same
    ``(k, d)`` on every rank; ``sumsq`` the global ``sum |x|^2`` as a
    ``(1,)`` tensor, taken (and all-reduced) here when not given.  Returns
    the new centroids and the loss, the same on every rank: the squared
    error of the new centroids at the assignments made from the old ones
    over the global ``n * d`` (from the sufficient statistics, see
    ``pq/train.py``).  The statistics go through the fused kernel on a GPU
    (``use_kernel=None``).  ``mesh=`` takes the place of the axis names
    JAX's ``shard_map`` binds."""
    group, _, _ = axis_group(mesh, data_axis)
    if use_kernel is None:
        use_kernel = x_local.is_cuda
    if sumsq is None:
        (sumsq,) = all_reduce(group, _streamed_sumsq(x_local, 1, chunk=chunk))
    cb, losses = lloyd_iteration_chunked(
        x_local, centroids[None], sumsq, chunk=chunk, use_kernel=use_kernel, group=group,
    )
    return cb[0], losses[0]


def sharded_kmeans(
    mesh: DeviceMesh,
    x,
    centroids,
    n_iterations: int,
    data_axis: str = "data",
    *,
    chunk: int = 32768,
    use_kernel: Optional[bool] = None,
) -> Tuple[Tensor, Tensor]:
    """Data-parallel Lloyd's from given initial centroids: ``x`` (the global
    ``(n, d)`` matrix, ``n`` divisible by the axis size) sharded by rows over
    ``data_axis``, ``centroids`` the same on every rank.  Returns
    ``(centroids, loss)`` on every rank.  At one rank the bits of
    :func:`reductive_tpu_torch.kmeans.kmeans_with_centroids_chunked`; over
    several, the sums differ from one pass over all rows only in the
    grouping of their f32 additions."""
    if n_iterations <= 0:
        raise ValueError("The number of iterations must be >= 1")
    group, size, index = axis_group(mesh, data_axis)
    dev = mesh_device(mesh)
    x_local = _local_rows(x, size, index, dev)
    centroids = torch.as_tensor(centroids).to(dev)
    if centroids.shape[1] != x_local.shape[1]:
        raise ValueError(
            f"Centroid and instance lengths differ: {centroids.shape[1]} != {x_local.shape[1]}"
        )
    (sumsq,) = all_reduce(group, _streamed_sumsq(x_local, 1, chunk=chunk))
    loss = None
    for _ in range(n_iterations):
        centroids, loss = sharded_kmeans_iteration(
            x_local, centroids, data_axis, mesh=mesh, sumsq=sumsq, chunk=chunk,
            use_kernel=use_kernel,
        )
    return centroids, loss


def sharded_pq_train_step(
    xs: Tensor, codebooks: Tensor, data_axis: str = "data", model_axis: str = "model", *,
    mesh: DeviceMesh,
) -> Tuple[Tensor, Tensor]:
    """One PQ training step over a 2-D (data x model) mesh.  ``xs`` is this
    rank's ``(n_local, m_local, ds)`` block: instances split over
    ``data_axis``, subquantizers over ``model_axis``; ``codebooks`` this
    rank's ``(m_local, k, ds)`` block.  Per subquantizer: assign (the fused
    statistics kernel on a GPU), sum the statistics over ``data_axis``,
    update.  Nothing crosses ``model_axis`` but the loss: the returned
    codebooks are this rank's block, the loss the global mean squared error
    over all ``n * m * ds`` elements.

    JAX calls this inside ``shard_map``, where the axis names are bound;
    here the groups come from ``mesh=``, the one argument JAX does not
    take."""
    data_group, _, _ = axis_group(mesh, data_axis)
    model_group, model_size, _ = axis_group(mesh, model_axis)
    n_local, m_local, ds = xs.shape
    x2 = xs.reshape(n_local, m_local * ds)
    (sumsq,) = all_reduce(data_group, _streamed_sumsq(x2, m_local, chunk=32768))
    new_codebooks, losses = lloyd_iteration_chunked(
        x2, codebooks, sumsq, use_kernel=xs.is_cuda, group=data_group,
    )
    (total,) = all_reduce(model_group, losses.sum())
    return new_codebooks, total / (m_local * model_size)


# ---------------------------------------------------------------------------
# Corpus-scale data-parallel training
# ---------------------------------------------------------------------------


def train_pq_chunked_sharded(
    generator: torch.Generator,
    instances,
    n_subquantizers: int,
    n_subquantizer_bits: int,
    n_iterations: int,
    n_attempts: int = 1,
    *,
    mesh: DeviceMesh,
    data_axis: str = "data",
    chunk: int = 32768,
    use_kernel: Optional[bool] = None,
    compute_dtype=torch.float32,
    projection: Optional[Tensor] = None,
) -> Pq:
    """Corpus-scale data-parallel PQ training: each rank sweeps its rows of
    ``instances`` with the fused assign+statistics kernel
    (:func:`reductive_tpu_torch.pq.train.assign_stats_streamed`, ``chunk``
    as in :func:`~reductive_tpu_torch.pq.train.train_pq_chunked`), the
    ``(m, k, ds)`` sums and ``(m, k)`` counts are all-reduced (147,456 bytes
    an iteration at d=128, m=16, k=256, whatever ``n``), and the update and
    loss run on every rank.  At one rank the result is ``train_pq_chunked``'s
    bit for bit; over several it differs only by the grouping of the f32
    partial sums.

    ``projection`` (orthonormal ``(d, d)``) rotates chunks on the fly and
    the returned model carries it: the sharded Gaussian OPQ
    (``create_projection_matrix`` + this).  ``generator`` lives on the
    rank's device; ``n`` must divide evenly over the ``data_axis`` size.
    """
    x = torch.as_tensor(instances)
    n, d = x.shape
    check_quantizer_invariants(
        n_subquantizers, n_subquantizer_bits, n_iterations, n_attempts, n, d
    )
    _check_compute_dtype(compute_dtype)
    m, k = n_subquantizers, 2 ** n_subquantizer_bits
    ds = d // m
    group, size, index = axis_group(mesh, data_axis)
    dev = mesh_device(mesh)
    x_local = _local_rows(x, size, index, dev)
    check_generator(generator, dev)
    if use_kernel is None:
        use_kernel = dev.type == "cuda"
    if projection is not None:
        projection = projection.to(dev)
    (sumsq,) = all_reduce(group, _streamed_sumsq(x_local, m, chunk=chunk, projection=projection))

    best = None
    for _ in range(n_attempts):
        cb = init_codebooks_random(x, generator, k, ds, projection)
        loss = None
        for _ in range(n_iterations):
            cb, loss = lloyd_iteration_chunked(
                x_local, cb, sumsq, chunk=chunk, use_kernel=use_kernel,
                compute_dtype=compute_dtype, projection=projection, group=group,
            )
        best = _keep_better(best, cb, loss)
    return Pq(codebooks=best[0], projection=projection)


def train_opq_chunked_sharded(
    generator: torch.Generator,
    instances,
    n_subquantizers: int,
    n_subquantizer_bits: int,
    n_iterations: int,
    n_attempts: int = 1,
    *,
    mesh: DeviceMesh,
    data_axis: str = "data",
    chunk: int = 32768,
    use_kernel: Optional[bool] = None,
    compute_dtype=torch.float32,
) -> Pq:
    """Data-parallel corpus-scale OPQ: per alternation each rank adds its
    centroid statistics and its ``(d, d)`` Procrustes cross matrix to the
    others' (two all-reduces), and the update and the SVD run on every
    rank.  The initial projection comes from the covariance of all the rows
    (the column sums and products all-reduced).  The eigendecomposition's
    and each SVD's result are those of the group's first rank on every rank
    (a broadcast), so the ranks cannot drift apart by a bit.  ``n_attempts``
    is ignored, as in the reference.  At one rank the result is
    :func:`~reductive_tpu_torch.pq.opq.train_opq_chunked`'s bit for bit."""
    x = torch.as_tensor(instances)
    n, d = x.shape
    check_quantizer_invariants(
        n_subquantizers, n_subquantizer_bits, n_iterations, 1, n, d
    )
    _check_compute_dtype(compute_dtype)
    k = 2 ** n_subquantizer_bits
    ds = d // n_subquantizers
    group, size, index = axis_group(mesh, data_axis)
    dev = mesh_device(mesh)
    x_local = _local_rows(x, size, index, dev)
    check_generator(generator, dev)
    if use_kernel is None:
        use_kernel = dev.type == "cuda"
    projection = broadcast_first(
        group, projection_from_covariance(row_covariance(x_local, group), n_subquantizers))
    codebooks = init_codebooks_random(x, generator, k, ds, projection)
    for _ in range(n_iterations):
        projection, codebooks, _ = _opq_iteration_chunked(
            x_local, projection, codebooks, chunk=chunk, use_kernel=use_kernel,
            compute_dtype=compute_dtype, group=group,
        )
    return Pq(codebooks=codebooks, projection=projection)


# ---------------------------------------------------------------------------
# Corpora on disk over several ranks
# ---------------------------------------------------------------------------


def train_pq_streamed_sharded(
    generator: torch.Generator,
    reader,
    n_subquantizers: int,
    n_subquantizer_bits: int,
    n_iterations: int,
    n_attempts: int = 1,
    *,
    mesh: DeviceMesh,
    data_axis: str = "data",
    batch_size: int = 1 << 18,
    use_kernel: Optional[bool] = None,
    compute_dtype=torch.float32,
    projection: Optional[Tensor] = None,
    transfer_dtype=None,
    start: int = 0,
    stop: Optional[int] = None,
) -> Pq:
    """Streamed PQ training of a corpus on disk, sharded by rows over the
    ranks of ``data_axis``: each rank re-reads only its ``n/R`` rows of
    ``[start, stop)`` per Lloyd's iteration through its own ``reader`` (each
    process opens the file itself), folds every batch, the tail too, into
    its statistics with the kernel
    (:func:`reductive_tpu_torch.pq.train_pq_streamed`'s step), and the
    statistics are all-reduced once an iteration.  The initial centroids
    take ``train_pq_streamed``'s draws over the whole range, so at one rank
    the result is its bit for bit.  ``projection`` rotates batches on the
    fly; ``transfer_dtype=torch.bfloat16`` halves the bytes each rank copies
    to its card.  The rows must divide evenly over ``data_axis``.
    """
    _check_compute_dtype(compute_dtype)
    group, size, index = axis_group(mesh, data_axis)
    dev = mesh_device(mesh)
    if use_kernel is None:
        use_kernel = dev.type == "cuda"
    stop = reader.n if stop is None else min(stop, reader.n)
    n, d = stop - start, reader.dim
    check_quantizer_invariants(
        n_subquantizers, n_subquantizer_bits, n_iterations, n_attempts, n, d
    )
    m, k = n_subquantizers, 2 ** n_subquantizer_bits
    ds = d // m
    lo, hi = _shard(n, size, index)
    check_generator(generator, dev)
    if projection is not None:
        projection = projection.to(dev)

    def one_pass(cb: Tensor):
        def step(acc, xb):
            return _stats_step(acc, cb, projection, xb, use_kernel=use_kernel,
                               compute_dtype=compute_dtype)

        acc = _stream_pass(reader, batch_size, start + lo, start + hi, transfer_dtype, dev, step,
                           _new_stats(m, k, ds, dev))
        return all_reduce(group, *acc)

    best = None
    for _ in range(n_attempts):
        cb = _init_streamed_codebooks(generator, reader, m, k, ds, projection, start, stop, dev)
        loss = None
        for _ in range(n_iterations):
            sums, counts, sumsq = one_pass(cb)
            cb = centroids_from_stats(sums, counts, cb.dtype)
            loss = losses_from_stats(sums, counts, sumsq, n * ds)
        best = _keep_better(best, cb, loss)
    return Pq(codebooks=best[0], projection=projection)


def _encode_dtype(device: torch.device) -> torch.dtype:
    """The encode kernel's products, as the JAX package picks them: bf16 on
    the accelerator, f32 on the CPU."""
    return torch.bfloat16 if device.type == "cuda" else torch.float32


def stream_encode_sharded(
    pq: Pq,
    reader,
    *,
    mesh: DeviceMesh,
    data_axis: str = "data",
    batch_size: int = 1 << 18,
    dtype=torch.uint8,
    use_kernel: Optional[bool] = None,
    transfer_dtype=None,
) -> np.ndarray:
    """Streamed encode of a corpus on disk, sharded by rows: each rank
    streams its ``n/R`` rows of ``reader`` through the encode (the kernel on
    a GPU: ``use_kernel=None``), with no collective until the codes are
    gathered, and every rank returns the whole ``(n, m)`` host code matrix
    in corpus order.  Each row is encoded on its own, so the codes are bit
    for bit those of :func:`reductive_tpu_torch.data.stream_encode` at the
    same ``use_kernel`` and products (bf16 on a GPU, f32 on the CPU), at
    any number of ranks.  ``n`` must divide evenly over ``data_axis``."""
    group, size, index = axis_group(mesh, data_axis)
    dev = mesh_device(mesh)
    lo, hi = _shard(reader.n, size, index)
    pq = _on_device(pq, dev)
    out = np.empty((hi - lo, pq.quantized_len), dtype=_np_dtype(dtype))
    batches = _reader_batches(reader, batch_size, lo, hi, copy=dev.type != "cuda")
    for off, codes in stream_encode_batches(
        pq, batches, batch_size=batch_size, dtype=dtype, use_kernel=use_kernel,
        transfer_dtype=transfer_dtype, compute_dtype=_encode_dtype(dev),
    ):
        out[off - lo:off - lo + codes.shape[0]] = codes
    gathered = all_gather_rows(group, torch.from_numpy(out).to(dev))
    return gathered.reshape(reader.n, -1).cpu().numpy()


def train_pq_sharded(
    generator: torch.Generator,
    instances,
    n_subquantizers: int,
    n_subquantizer_bits: int,
    n_iterations: int,
    n_attempts: int = 1,
    *,
    mesh: DeviceMesh,
    data_axis: str = "data",
) -> Pq:
    """Data-parallel :func:`reductive_tpu_torch.pq.train.train_pq`: each
    rank runs the in-memory batched Lloyd's step on its rows (its ``(m,
    n_local, k)`` distances), the sums, counts and squared errors are
    all-reduced, and the update runs on every rank.  The generator's draws
    are ``train_pq``'s, from the global matrix, so at one rank the codebooks
    are its bit for bit, and over several they differ only by the grouping
    of the f32 partial sums."""
    x = torch.as_tensor(instances)
    n, d = x.shape
    check_quantizer_invariants(
        n_subquantizers, n_subquantizer_bits, n_iterations, n_attempts, n, d
    )
    k = 2 ** n_subquantizer_bits
    ds = d // n_subquantizers
    group, size, index = axis_group(mesh, data_axis)
    dev = mesh_device(mesh)
    x_local = _local_rows(x, size, index, dev)
    check_generator(generator, dev)
    initial = torch.stack(
        [init_codebooks_random(x, generator, k, ds) for _ in range(n_attempts)]
    )
    codebooks, _ = train_pq_subspace_with_centroids(
        x_local.reshape(-1, n_subquantizers, ds), initial, n_iterations, group=group,
    )
    return Pq(codebooks=codebooks, projection=None)


def encode_sharded(
    pq: Pq,
    x,
    *,
    mesh: DeviceMesh,
    data_axis: str = "data",
    dtype=torch.uint8,
    use_kernel: Optional[bool] = None,
) -> Tensor:
    """Distributed batch encode: each rank encodes its rows of ``x`` (``n``
    divisible by the axis size), with no collective until the codes are
    gathered; every rank returns the whole ``(n, m)`` code matrix on its
    device.  ``use_kernel=None`` means the encode kernel on a GPU (bf16
    products, as the JAX package's kernel route on the accelerator; f32 on
    the CPU) and the exact f32 path on the CPU.  The JAX package's default
    is its exact XLA program (``use_kernel=False``); here ``None`` follows
    the port's convention.  Each row is encoded on its own, so the codes
    equal the single-card ``pq.quantize_batch`` / ``pq_encode`` at the same
    route bit for bit."""
    group, size, index = axis_group(mesh, data_axis)
    dev = mesh_device(mesh)
    x_local = _local_rows(x, size, index, dev)
    pq = _on_device(pq, dev)
    if use_kernel is None:
        use_kernel = dev.type == "cuda"
    if use_kernel:
        from ..ops.assign import pq_encode

        if pq.projection is not None:
            x_local = torch.matmul(x_local, pq.projection)
        codes = pq_encode(pq.codebooks, x_local, dtype=dtype, compute_dtype=_encode_dtype(dev))
    else:
        codes = pq.quantize_batch(x_local, dtype=dtype)
    gathered = all_gather_rows(group, codes)
    return gathered.reshape(-1, codes.shape[1])
