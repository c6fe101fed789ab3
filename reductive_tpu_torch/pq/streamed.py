"""Host-streamed training: corpora larger than device memory.

Counterpart of ``reductive_tpu.pq.streamed``.  The chunked trainers
(:func:`reductive_tpu_torch.pq.train.train_pq_chunked`,
:func:`reductive_tpu_torch.pq.opq.train_opq_chunked`) stream *within*
device memory: the corpus is a resident tensor.  BASELINE.json's config #5
(100M 768-d vectors, ~307 GB f32) fits on no card, so these trainers
re-stream the corpus **from disk** through the native reader every Lloyd's
iteration:

* the only state on the device is the ``(m, k, ds)`` codebooks and the f32
  sufficient statistics (sums, counts, sums of squares: a few MB), and the
  batches in flight;
* each disk batch flows host read -> pinned host memory (cast there to
  ``transfer_dtype``) -> copy to the device -> one statistics launch
  (:func:`reductive_tpu_torch.data._device_batches`): the reader's producer
  thread reads batch ``i+1`` while the device reduces batch ``i``, and every
  batch, the tail too, goes through the kernel, so a pass launches the
  statistics kernel ``ceil(n / batch_size)`` times;
* Lloyd's update and loss come from the one-pass sufficient-statistics
  identity (see ``pq/train.py``), so one read of the corpus per iteration
  suffices.  OPQ needs two (statistics, then the Procrustes cross matrix
  against the *updated* codebooks: the reference quantizes after the
  k-means step, ``src/pq/opq.rs:161-189``).

Initial centroids take the same draws as the chunked trainer
(:func:`reductive_tpu_torch.pq.train.init_codebooks_random`: one
``random_distinct_indices(generator, n, k)`` per subquantizer, in order),
then fetch exactly those rows from the reader, so at matched generators and
``batch_size == chunk`` :func:`train_pq_streamed` reproduces
``train_pq_chunked`` bit for bit: the same batch boundaries, the same
statistics call on each, the same order of addition (on the kernel route
``chunk`` must then be at least ``train.KERNEL_CHUNK_MIN``).

``transfer_dtype=torch.bfloat16`` halves the bytes on the wire; assignments
are computed from the cast values (the bf16 kernels round to them anyway),
statistics still accumulate in f32.  ``device=None`` means ``cuda``;
``use_kernel=None`` means the kernels when that device is a GPU.
"""

from __future__ import annotations

import logging
from typing import Optional, Tuple

import torch
from torch import Tensor

from .._device import check_generator, resolve_device
from ..data import _device_batches, _reader_batches
from ..errors import check_quantizer_invariants
from ..kmeans import random_distinct_indices
from . import primitives
from .model import Pq
from .train import (
    _check_checkpointing,
    _check_compute_dtype,
    _chunk_stats,
    centroids_from_stats,
    is_verified,
    losses_from_stats,
)

logger = logging.getLogger("reductive_tpu")

__all__ = [
    "train_pq_streamed",
    "train_opq_streamed",
    "train_gaussian_opq_streamed",
    "streamed_covariance",
]


def _batch_stats(codebooks: Tensor, x: Tensor, use_kernel: bool, compute_dtype):
    """(sums, counts) of one device batch: the statistics kernel (its
    verified form in ``"verified"`` mode), or the plain route of the chunked
    trainer.  Nothing falls back."""
    if use_kernel:
        from ..ops.stats import pq_assign_stats, pq_assign_stats_verified

        if is_verified(compute_dtype):
            return pq_assign_stats_verified(codebooks, x)
        return pq_assign_stats(codebooks, x, compute_dtype=compute_dtype)
    return _chunk_stats(codebooks, x, compute_dtype)


def _stats_step(acc, codebooks, projection, xb, *, use_kernel, compute_dtype):
    """Accumulate one batch into (sums, counts, sumsq); the projection (if
    any) rotates the batch on the device so the rotated corpus never
    exists.  The sums of squares are taken as ``train._streamed_sumsq``
    takes them."""
    sums, counts, sumsq = acc
    m, k, ds = codebooks.shape
    x = xb.to(codebooks.dtype)
    if projection is not None:
        x = torch.matmul(x, projection)
    s2, c2 = _batch_stats(codebooks, x, use_kernel, compute_dtype)
    sq2 = torch.sum(x.reshape(-1, m, ds).to(torch.float32) ** 2, dim=(0, 2))
    return sums + s2, counts + c2, sumsq + sq2


def _cross_step(M, codebooks, projection, xb, *, use_kernel, compute_dtype):
    """Accumulate one batch of the OPQ Procrustes cross matrix
    ``M += x^T reconstruct(encode(x R))`` (``src/pq/opq.rs:178-187``), as
    ``opq._opq_iteration_chunked`` does for a chunk: with ``use_kernel`` the
    encode and decode kernels (decode exact in the f32 and verified modes)."""
    x = xb.to(codebooks.dtype)
    rx = torch.matmul(x, projection)
    if use_kernel:
        from ..ops.assign import pq_encode, pq_encode_verified
        from ..ops.decode import pq_decode

        if is_verified(compute_dtype):
            codes = pq_encode_verified(codebooks, rx, dtype=torch.int32)
        else:
            codes = pq_encode(codebooks, rx, dtype=torch.int32, compute_dtype=compute_dtype)
        exact = is_verified(compute_dtype) or compute_dtype == torch.float32
        rec = pq_decode(codebooks, codes, splits=3 if exact else 1)
    else:
        codes = primitives.quantize_batch(codebooks, rx, dtype=torch.int32)
        rec = primitives.reconstruct_batch(codebooks, codes, method="gather")
    return M + torch.matmul(x.T, rec)


def _cov_step(acc, xb):
    """Accumulate (sum x, x^T x, n) for the streamed covariance."""
    s1, s2, cnt = acc
    x = xb.to(torch.float32)
    return s1 + torch.sum(x, dim=0), s2 + torch.matmul(x.T, x), cnt + x.shape[0]


def _stream_pass(reader, batch_size, start, stop, transfer_dtype, device, step, acc):
    """One full pass over the reader, ``acc = step(acc, xb)`` for each batch
    on ``device``, in corpus order.  Every batch, the tail too, takes the
    same step."""
    batches = _reader_batches(reader, batch_size, start, stop, copy=device.type != "cuda")
    for _, xb in _device_batches(batches, device, transfer_dtype):
        acc = step(acc, xb)
    return acc


def streamed_covariance(
    reader, *, batch_size: int = 1 << 18, start: int = 0,
    stop: Optional[int] = None, transfer_dtype=None, device=None,
) -> Tensor:
    """Covariance ``(d, d)`` of an on-disk corpus in one streamed pass, on
    ``device`` (``None`` means ``cuda``).

    Moment form ``(x^T x - n mu mu^T) / (n - 1)`` accumulated in f32:
    within float tolerance of the reference's two-pass centered form
    (``src/linalg.rs:17-45``) for data that is not far from the origin
    (embedding corpora are roughly centered; the OPQ eigenbasis is
    insensitive to ~1e-5 covariance perturbations)."""
    dev = resolve_device(device)
    stop = reader.n if stop is None else min(stop, reader.n)
    d = reader.dim
    acc = (
        torch.zeros((d,), dtype=torch.float32, device=dev),
        torch.zeros((d, d), dtype=torch.float32, device=dev),
        0,
    )
    s1, s2, cnt = _stream_pass(reader, batch_size, start, stop, transfer_dtype, dev,
                               _cov_step, acc)
    mean = s1 / cnt
    return (s2 - cnt * torch.outer(mean, mean)) / (cnt - 1.0)


def _init_streamed_codebooks(
    generator: torch.Generator, reader, m: int, k: int, ds: int,
    projection: Optional[Tensor], start: int, stop: int, device: torch.device,
) -> Tensor:
    """Initial ``(m, k, ds)`` codebooks: the draws of
    ``train.init_codebooks_random`` (one ``random_distinct_indices`` per
    subquantizer, in order, on the generator's device), with the drawn rows
    read from the reader (``read_rows(idx + start)``) instead of gathered
    from device memory, and rotated by the same ``(k, d) x (d, d)`` product
    on the device."""
    n = stop - start
    out = []
    for j in range(m):
        idx = random_distinct_indices(generator, n, k).cpu().numpy() + start
        rows = reader.read_rows(idx) if hasattr(reader, "read_rows") else torch.cat(
            [torch.as_tensor(reader.read(int(i), 1)) for i in idx])
        rows = torch.as_tensor(rows).to(device, torch.float32)
        if projection is not None:
            rows = torch.matmul(rows, projection)
        out.append(rows[:, j * ds:(j + 1) * ds])
    return torch.stack(out)


def _new_stats(m: int, k: int, ds: int, device) -> Tuple[Tensor, Tensor, Tensor]:
    return (
        torch.zeros((m, k, ds), dtype=torch.float32, device=device),
        torch.zeros((m, k), dtype=torch.float32, device=device),
        torch.zeros((m,), dtype=torch.float32, device=device),
    )


def _save_checkpoint(path: str, codebooks: Tensor, projection: Optional[Tensor]) -> None:
    from .. import io as _io_mod

    _io_mod.save(path, Pq(codebooks=codebooks, projection=projection))


def train_pq_streamed(
    generator: torch.Generator,
    reader,
    n_subquantizers: int,
    n_subquantizer_bits: int,
    n_iterations: int,
    n_attempts: int = 1,
    *,
    batch_size: int = 1 << 18,
    use_kernel: Optional[bool] = None,
    compute_dtype=torch.float32,
    projection: Optional[Tensor] = None,
    transfer_dtype=None,
    start: int = 0,
    stop: Optional[int] = None,
    checkpoint_every: Optional[int] = None,
    checkpoint_path: Optional[str] = None,
    initial_model: Optional[Pq] = None,
    device=None,
) -> Pq:
    """PQ training over an on-disk corpus larger than device memory: every
    Lloyd's iteration re-streams ``reader`` (a
    :class:`reductive_tpu_torch.native.VecsReader`, or anything with
    ``n``/``dim``/``read``/``batches``) through the fused assign+statistics
    kernel in ``batch_size``-row batches, on ``device`` (``None`` means
    ``cuda``; ``generator`` must live there).

    Same semantics and hyperparameters as :func:`train_pq_chunked`
    (reference: ``TrainPq for Pq``, ``src/pq/pq.rs:196-250``): at a matched
    generator and ``batch_size == chunk`` the result is bit-identical to
    the in-memory chunked trainer (see the module docstring).
    ``projection`` rotates batches on the fly (how
    :func:`train_gaussian_opq_streamed` composes).  With
    ``checkpoint_every=e`` and ``checkpoint_path`` the state is written
    atomically every ``e`` iterations; ``initial_model`` resumes from it
    (``n_attempts`` must then be 1).
    """
    _check_compute_dtype(compute_dtype)
    _check_checkpointing(checkpoint_every, checkpoint_path)
    dev = resolve_device(device)
    if use_kernel is None:
        use_kernel = dev.type == "cuda"
    stop = reader.n if stop is None else min(stop, reader.n)
    n = stop - start
    d = reader.dim
    check_quantizer_invariants(
        n_subquantizers, n_subquantizer_bits, n_iterations, n_attempts, n, d
    )
    m, k = n_subquantizers, 2 ** n_subquantizer_bits
    ds = d // m
    if initial_model is not None:
        if n_attempts != 1:
            raise ValueError(
                "initial_model resume requires n_attempts=1 (the saved "
                "state is a single attempt's codebooks)"
            )
        if tuple(initial_model.codebooks.shape) != (m, k, ds):
            raise ValueError(
                f"initial_model codebooks have shape "
                f"{tuple(initial_model.codebooks.shape)}, expected {(m, k, ds)}"
            )
    else:
        check_generator(generator, dev)
    logger.info(
        "Training %d PQ subquantizers streamed from disk (k=%d, %d rows, "
        "%d iterations, %d attempts, batch=%d)",
        m, k, n, n_iterations, n_attempts, batch_size,
    )
    log_it = logger.isEnabledFor(logging.INFO)

    def one_pass(cb: Tensor):
        def step(acc, xb):
            return _stats_step(acc, cb, projection, xb, use_kernel=use_kernel,
                               compute_dtype=compute_dtype)

        return _stream_pass(reader, batch_size, start, stop, transfer_dtype, dev, step,
                            _new_stats(m, k, ds, dev))

    best_cb, best_loss = None, None
    for attempt in range(n_attempts):
        cb = (
            initial_model.codebooks
            if initial_model is not None
            else _init_streamed_codebooks(generator, reader, m, k, ds, projection, start, stop,
                                          dev)
        )
        loss = torch.full((m,), float("inf"), dtype=torch.float32, device=dev)
        for it in range(n_iterations):
            sums, counts, sumsq = one_pass(cb)
            cb = centroids_from_stats(sums, counts, cb.dtype)
            loss = losses_from_stats(sums, counts, sumsq, n * ds)
            if log_it:
                logger.info("Streamed Lloyd's iteration %d: mean subquantizer loss %.6f",
                            it, float(loss.mean()))
            if checkpoint_every is not None and (it + 1) % checkpoint_every == 0:
                _save_checkpoint(checkpoint_path, cb, projection)
                logger.info(
                    "Checkpointed streamed PQ state (attempt %d, %d/%d iterations) to %s",
                    attempt, it + 1, n_iterations, checkpoint_path,
                )
        if best_cb is None:
            best_cb, best_loss = cb, loss
        else:
            better = loss < best_loss  # strict: ties keep the earlier attempt
            best_cb = torch.where(better[:, None, None], cb, best_cb)
            best_loss = torch.minimum(best_loss, loss)
    return Pq(codebooks=best_cb, projection=projection)


def train_gaussian_opq_streamed(
    generator: torch.Generator,
    reader,
    n_subquantizers: int,
    n_subquantizer_bits: int,
    n_iterations: int,
    n_attempts: int = 1,
    *,
    batch_size: int = 1 << 18,
    use_kernel: Optional[bool] = None,
    compute_dtype=torch.float32,
    transfer_dtype=None,
    start: int = 0,
    stop: Optional[int] = None,
    checkpoint_every: Optional[int] = None,
    checkpoint_path: Optional[str] = None,
    initial_model: Optional[Pq] = None,
    device=None,
) -> Pq:
    """Closed-form OPQ over an on-disk corpus (reference:
    ``src/pq/gaussian_opq.rs:27-69``): one streamed covariance pass builds
    the PCA-bucketed projection, then :func:`train_pq_streamed` trains on
    batches rotated on the fly.  Total disk reads: ``1 + n_iterations``
    passes (the covariance pass is skipped when ``initial_model`` carries a
    projection)."""
    from .opq import projection_from_covariance

    if initial_model is not None and initial_model.projection is not None:
        projection = initial_model.projection
    else:
        cov = streamed_covariance(
            reader, batch_size=batch_size, start=start, stop=stop,
            transfer_dtype=transfer_dtype, device=device,
        )
        projection = projection_from_covariance(cov, n_subquantizers)
    return train_pq_streamed(
        generator, reader, n_subquantizers, n_subquantizer_bits, n_iterations,
        n_attempts, batch_size=batch_size, use_kernel=use_kernel,
        compute_dtype=compute_dtype, projection=projection,
        transfer_dtype=transfer_dtype, start=start, stop=stop,
        checkpoint_every=checkpoint_every, checkpoint_path=checkpoint_path,
        initial_model=initial_model, device=device,
    )


def train_opq_streamed(
    generator: torch.Generator,
    reader,
    n_subquantizers: int,
    n_subquantizer_bits: int,
    n_iterations: int,
    n_attempts: int = 1,  # ignored, as in the reference (src/pq/opq.rs:50)
    *,
    batch_size: int = 1 << 18,
    use_kernel: Optional[bool] = None,
    compute_dtype=torch.float32,
    transfer_dtype=None,
    start: int = 0,
    stop: Optional[int] = None,
    checkpoint_every: Optional[int] = None,
    checkpoint_path: Optional[str] = None,
    initial_model: Optional[Pq] = None,
    device=None,
) -> Pq:
    """Non-parametric OPQ over an on-disk corpus (reference:
    ``TrainPq for Opq``, ``src/pq/opq.rs:40-100``): alternates one
    streamed k-means step with a streamed Procrustes projection update.

    Per alternation the corpus is read twice: once for the centroid
    statistics of the rotated data, once for the cross matrix
    ``M = X^T reconstruct(encode(X R))`` under the *updated* codebooks (the
    reference quantizes after the k-means step,
    ``src/pq/opq.rs:161-189``), so a full run costs ``1 + 2 * n_iterations``
    disk passes (the 1: the covariance pass).  The projection update is
    ``U V^T`` from the SVD of ``M``
    (:func:`reductive_tpu_torch.pq.opq._procrustes`), as
    ``train_opq_chunked`` takes it.
    """
    from .opq import _procrustes, projection_from_covariance

    _check_compute_dtype(compute_dtype)
    _check_checkpointing(checkpoint_every, checkpoint_path)
    dev = resolve_device(device)
    if use_kernel is None:
        use_kernel = dev.type == "cuda"
    stop = reader.n if stop is None else min(stop, reader.n)
    n = stop - start
    d = reader.dim
    check_quantizer_invariants(
        n_subquantizers, n_subquantizer_bits, n_iterations, 1, n, d
    )
    m, k = n_subquantizers, 2 ** n_subquantizer_bits
    ds = d // m

    if initial_model is not None:
        projection = initial_model.projection
        cb = initial_model.codebooks
        if projection is None or tuple(cb.shape) != (m, k, ds):
            raise ValueError("initial_model must carry a projection and "
                             f"(m, k, ds) = {(m, k, ds)} codebooks")
    else:
        check_generator(generator, dev)
        cov = streamed_covariance(
            reader, batch_size=batch_size, start=start, stop=stop,
            transfer_dtype=transfer_dtype, device=dev,
        )
        projection = projection_from_covariance(cov, m)
        cb = _init_streamed_codebooks(generator, reader, m, k, ds, projection, start, stop, dev)

    def stream(fn, acc, codebooks):
        def step(a, xb):
            return fn(a, codebooks, projection, xb, use_kernel=use_kernel,
                      compute_dtype=compute_dtype)

        return _stream_pass(reader, batch_size, start, stop, transfer_dtype, dev, step, acc)

    log_it = logger.isEnabledFor(logging.INFO)
    for it in range(n_iterations):
        sums, counts, sumsq = stream(_stats_step, _new_stats(m, k, ds, dev), cb)
        cb = centroids_from_stats(sums, counts, cb.dtype)
        if log_it:
            loss = losses_from_stats(sums, counts, sumsq, n * ds)
            logger.info("Streamed OPQ iteration %d: mean subquantizer loss %.6f",
                        it, float(loss.mean()))
        M = stream(_cross_step, torch.zeros((d, d), dtype=torch.float32, device=dev), cb)
        projection = _procrustes(M.to(cb.dtype))
        if checkpoint_every is not None and (it + 1) % checkpoint_every == 0:
            _save_checkpoint(checkpoint_path, cb, projection)
            logger.info(
                "Checkpointed streamed OPQ state (%d/%d iterations) to %s",
                it + 1, n_iterations, checkpoint_path,
            )
    return Pq(codebooks=cb, projection=projection)
