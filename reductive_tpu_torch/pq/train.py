"""Plain product-quantizer training: k-means over the subquantizer axis.

Counterpart of ``reductive_tpu.pq.train``.  Two families:

* the in-memory trainer (:func:`train_pq`) runs all ``m`` subquantizers of
  an attempt as one batched Lloyd's step
  (:func:`reductive_tpu_torch.kmeans.lloyd_iteration_batched`), which holds
  the ``(m, n, k)`` distance tensor, and loops over the attempts;
* the chunked trainer (:func:`train_pq_chunked`) never holds anything of
  size ``n * k``: each Lloyd's iteration is one pass of the fused
  assign+statistics kernel (:func:`reductive_tpu_torch.ops.pq_assign_stats`)
  over the instances, and assignment, update and loss all come from the
  per-centroid sums ``S`` and counts ``c``.  With ``c'_j = S_j / n_j``,

      sse = sum_i |x_i - c'_{a_i}|^2 = sumsq - sum_{j nonempty} |S_j|^2 / n_j

  so no second pass is needed for the loss.  Empty clusters become the zero
  vector and contribute nothing.

Random draws take a ``torch.Generator`` that lives on the device of the
instances.  Loops over iterations are Python loops; they wait for the device
only to log (when the ``reductive_tpu`` logger is at INFO) or to write a
checkpoint.
"""

from __future__ import annotations

import logging
from typing import Optional

import torch
from torch import Tensor

from .._device import check_generator, instances_on
from ..errors import check_quantizer_invariants
from ..kmeans import _means, lloyd_iteration_batched, random_distinct_indices
from . import primitives
from .model import Pq

logger = logging.getLogger("reductive_tpu")

__all__ = [
    "train_pq",
    "train_pq_chunked",
    "train_pq_subspace",
    "train_pq_subspace_with_centroids",
    "assign_stats_streamed",
    "lloyd_iteration_chunked",
    "centroids_from_stats",
    "losses_from_stats",
    "explained_from_stats",
    "init_codebooks_random",
    "is_verified",
]


def is_verified(compute_dtype) -> bool:
    """Whether ``compute_dtype`` names the verified mode (the string
    ``"verified"``: cell memberships equal to the exact path's)."""
    return isinstance(compute_dtype, str) and compute_dtype == "verified"


def _check_compute_dtype(compute_dtype) -> None:
    if is_verified(compute_dtype):
        return
    if compute_dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(
            "compute_dtype must be torch.float32, torch.bfloat16 or \"verified\", "
            f"got {compute_dtype}"
        )


def _check_checkpointing(checkpoint_every, checkpoint_path) -> None:
    if checkpoint_every is not None:
        if checkpoint_path is None:
            raise ValueError("checkpoint_every requires checkpoint_path")
        if checkpoint_every <= 0:
            raise ValueError("checkpoint_every must be >= 1")


def init_codebooks_random(
    x: Tensor, generator: torch.Generator, k: int, ds: int,
    projection: Optional[Tensor] = None,
) -> Tensor:
    """``(m, k, ds)`` initial codebooks, ``m = d // ds``: ``k`` distinct
    random instances per subquantizer, column-sliced.  With a ``projection``
    only the ``k`` drawn rows are rotated, so the rotated corpus is never
    materialized.  ``generator`` must live on the device of ``x``."""
    n, d = x.shape
    out = []
    for j in range(d // ds):
        rows = x[random_distinct_indices(generator, n, k)]
        if projection is not None:
            rows = torch.matmul(rows, projection)
        out.append(rows[:, j * ds:(j + 1) * ds])
    return torch.stack(out)


def _best_of_attempts(codebooks: Tensor, losses: Tensor) -> tuple[Tensor, Tensor]:
    """Keep the minimum-loss attempt per subquantizer; ties keep the first
    attempt (``torch.argmin`` returns the first minimum).  ``codebooks`` is
    ``(a, m, k, ds)``, ``losses`` ``(a, m)``."""
    best = torch.argmin(losses, dim=0)  # (m,)
    sub = torch.arange(losses.shape[1], device=losses.device)
    return codebooks[best, sub], losses[best, sub]


def train_pq_subspace_with_centroids(
    xs: Tensor, initial: Tensor, n_iterations: int
) -> tuple[Tensor, Tensor]:
    """Train all subquantizers from explicitly supplied initial centroids.

    ``xs`` is ``(n, m, ds)`` instance data; ``initial`` is
    ``(n_attempts, m, k, ds)``, one full set per (attempt, subquantizer).
    Runs ``n_iterations`` batched Lloyd's steps per attempt and keeps the
    best attempt per subquantizer.  Returns ``(m, k, ds)`` codebooks and
    ``(m,)`` losses."""
    if n_iterations <= 0:
        raise ValueError("The number of iterations must be >= 1")
    xs_m = xs.transpose(0, 1).contiguous()  # (m, n, ds)
    codebooks, losses = [], []
    for cb in initial:
        loss = None
        for _ in range(n_iterations):
            cb, loss = lloyd_iteration_batched(xs_m, cb)
        codebooks.append(cb)
        losses.append(loss)
    return _best_of_attempts(torch.stack(codebooks), torch.stack(losses))


def train_pq_subspace(
    generator: torch.Generator, xs: Tensor, k: int, n_iterations: int, n_attempts: int
) -> tuple[Tensor, Tensor]:
    """Raw ``(m, k, ds)`` codebooks and per-subquantizer losses for
    pre-reshaped ``(n, m, ds)`` data: ``k`` distinct random instances per
    (attempt, subquantizer) as initial centroids, then
    :func:`train_pq_subspace_with_centroids`.  Used by the OPQ trainers,
    which manage projection and validation themselves.  ``generator`` must
    live on the device of ``xs``."""
    n, m, ds = xs.shape
    check_generator(generator, xs.device)
    x2 = xs.reshape(n, m * ds)
    initial = torch.stack(
        [init_codebooks_random(x2, generator, k, ds) for _ in range(n_attempts)]
    )
    return train_pq_subspace_with_centroids(xs, initial, n_iterations)


def train_pq(
    generator: torch.Generator,
    instances,
    n_subquantizers: int,
    n_subquantizer_bits: int,
    n_iterations: int,
    n_attempts: int = 1,
    *,
    device=None,
) -> Pq:
    """Train a plain product quantizer.

    Each of the ``n_subquantizers`` subquantizers gets
    ``2**n_subquantizer_bits`` centroids, trained with ``n_iterations``
    Lloyd's iterations; each is trained ``n_attempts`` times and the
    minimum-loss attempt is kept.  Raises a
    :class:`~reductive_tpu_torch.errors.ReductiveError` subclass on invalid
    hyperparameters.

    ``instances`` is a tensor (training runs where it lies) or a host array,
    which is put on ``device`` (``None`` means ``cuda``).  ``generator`` must
    live on that device.
    """
    instances = instances_on(instances, device)
    n, d = instances.shape
    check_quantizer_invariants(
        n_subquantizers, n_subquantizer_bits, n_iterations, n_attempts, n, d
    )
    k = 2 ** n_subquantizer_bits
    ds = d // n_subquantizers
    logger.info(
        "Training %d PQ subquantizers (k=%d, %d iterations, %d attempts)",
        n_subquantizers, k, n_iterations, n_attempts,
    )
    xs = instances.reshape(n, n_subquantizers, ds)
    codebooks, losses = train_pq_subspace(generator, xs, k, n_iterations, n_attempts)
    if logger.isEnabledFor(logging.INFO):
        logger.info("Per-subquantizer losses: %s", [round(float(l), 6) for l in losses])
    return Pq(codebooks=codebooks, projection=None)


# ---------------------------------------------------------------------------
# Chunked (large-n) training
# ---------------------------------------------------------------------------


def _chunk_stats(codebooks: Tensor, xc: Tensor, compute_dtype) -> tuple[Tensor, Tensor]:
    """Per-centroid instance sums ``(m, k, ds)`` and counts ``(m, k)`` for
    one ``(c, d)`` chunk, in plain tensor code (the ``use_kernel=False``
    route): codes from the exact f32 path, then a one-hot product of the
    subvectors (rounded to bfloat16 first in bf16 mode; unrounded in the f32
    and verified modes; accumulation and counts are f32 either way), the
    same bits on every run."""
    from ..ops.stats import stats_from_codes

    codes = primitives.quantize_batch(codebooks, xc, dtype=torch.int32)
    xs = xc.to(torch.float32)
    if compute_dtype == torch.bfloat16:
        xs = xs.to(torch.bfloat16).to(torch.float32)
    return stats_from_codes(codes, xs, codebooks.shape[1])


def centroids_from_stats(sums: Tensor, counts: Tensor, dtype: torch.dtype) -> Tensor:
    """Count-guarded centroid update from (sums, counts) statistics; empty
    clusters become the zero vector.  Shared by the chunked and OPQ trainers
    so the formula lives in one place."""
    return _means(sums, counts, dtype)


def explained_from_stats(sums: Tensor, counts: Tensor) -> Tensor:
    """Per-subquantizer explained sum of squares ``sum_k |S_jk|^2 / n_jk``
    over nonempty centroids, ``(m,)``."""
    s_norms = torch.sum(sums * sums, dim=-1)
    return torch.sum(
        torch.where(counts > 0, s_norms / counts.clamp_min(1.0), torch.zeros_like(s_norms)),
        dim=-1,
    )


def losses_from_stats(sums: Tensor, counts: Tensor, sumsq: Tensor, n_elems: int) -> Tensor:
    """Per-subquantizer Lloyd's loss from sufficient statistics:
    ``sse_j = sumsq_j - sum_k |S_jk|^2 / n_jk`` over nonempty centroids,
    normalized by the element count.  All f32: the difference cancels when
    the loss is small beside ``sumsq``."""
    return (sumsq.to(torch.float32) - explained_from_stats(sums, counts)) / float(n_elems)


def assign_stats_streamed(
    x: Tensor,
    codebooks: Tensor,
    *,
    chunk: int = 32768,
    use_kernel: bool = True,
    compute_dtype=torch.float32,
    projection: Optional[Tensor] = None,
) -> tuple[Tensor, Tensor]:
    """Per-centroid f32 sums ``(m, k, ds)`` and counts ``(m, k)`` under
    nearest-centroid assignment, never materializing anything O(n * k).

    With ``use_kernel`` and no projection this is one call of
    :func:`reductive_tpu_torch.ops.pq_assign_stats` over all of ``x``
    (of :func:`reductive_tpu_torch.ops.pq_assign_stats_verified` with
    ``compute_dtype="verified"``).  With
    a ``projection``, ``chunk``-row slices are rotated on the fly and go
    through the kernel one by one, so the rotated corpus is never
    materialized.  Without ``use_kernel`` the slices go through
    :func:`_chunk_stats`.  A ``k`` the kernel does not take raises; nothing
    falls back."""
    _check_compute_dtype(compute_dtype)
    if use_kernel:
        from ..ops.stats import pq_assign_stats, pq_assign_stats_verified

        def kernel_stats(xc: Tensor) -> tuple[Tensor, Tensor]:
            if is_verified(compute_dtype):
                return pq_assign_stats_verified(codebooks, xc)
            return pq_assign_stats(codebooks, xc, compute_dtype=compute_dtype)

        if projection is None:
            return kernel_stats(x)

    m, k, ds = codebooks.shape
    sums = torch.zeros((m, k, ds), dtype=torch.float32, device=x.device)
    counts = torch.zeros((m, k), dtype=torch.float32, device=x.device)
    for i in range(0, x.shape[0], chunk):
        xc = x[i:i + chunk]
        if projection is not None:
            xc = torch.matmul(xc, projection)
        if use_kernel:
            s2, c2 = kernel_stats(xc)
        else:
            s2, c2 = _chunk_stats(codebooks, xc, compute_dtype)
        sums += s2
        counts += c2
    return sums, counts


def lloyd_iteration_chunked(
    x: Tensor,
    codebooks: Tensor,
    sumsq: Tensor,
    *,
    chunk: int = 32768,
    use_kernel: bool = True,
    compute_dtype=torch.float32,
    projection: Optional[Tensor] = None,
) -> tuple[Tensor, Tensor]:
    """One Lloyd's step over all ``m`` subquantizers without the
    ``(m, n, k)`` distance tensor.

    ``sumsq`` is the per-subquantizer ``sum |x|^2`` vector ``(m,)`` of the
    (rotated, if ``projection`` is given) data, constant across iterations.
    Returns the updated ``(m, k, ds)`` codebooks and per-subquantizer f32
    losses ``(m,)`` normalized by ``n * ds``.

    ``use_kernel`` selects the fused kernel (on a CPU tensor, its plain
    version) or the plain tensor route.  ``compute_dtype``:
    ``torch.float32`` reproduces the in-memory iteration to float tolerance;
    ``torch.bfloat16`` assigns with bfloat16-rounded inputs and sums the
    rounded instances (counts stay exact); ``"verified"`` has the exact
    path's cell memberships.
    """
    n = x.shape[0]
    ds = codebooks.shape[2]
    sums, counts = assign_stats_streamed(
        x, codebooks, chunk=chunk, use_kernel=use_kernel,
        compute_dtype=compute_dtype, projection=projection,
    )
    new_codebooks = centroids_from_stats(sums, counts, codebooks.dtype)
    losses = losses_from_stats(sums, counts, sumsq, n * ds)
    return new_codebooks, losses


def _streamed_sumsq(
    x: Tensor, m: int, *, chunk: int, projection: Optional[Tensor] = None
) -> Tensor:
    """Per-subquantizer ``sum |x|^2`` ``(m,)`` in f32, taken in chunks and
    rotating on the fly when a projection is given."""
    ds = x.shape[1] // m
    total = torch.zeros((m,), dtype=torch.float32, device=x.device)
    for i in range(0, x.shape[0], chunk):
        xc = x[i:i + chunk]
        if projection is not None:
            xc = torch.matmul(xc, projection)
        total += torch.sum(xc.reshape(-1, m, ds).to(torch.float32) ** 2, dim=(0, 2))
    return total


def train_pq_chunked(
    generator: torch.Generator,
    instances,
    n_subquantizers: int,
    n_subquantizer_bits: int,
    n_iterations: int,
    n_attempts: int = 1,
    *,
    chunk: int = 32768,
    use_kernel: Optional[bool] = None,
    compute_dtype=torch.float32,
    projection: Optional[Tensor] = None,
    checkpoint_every: Optional[int] = None,
    checkpoint_path: Optional[str] = None,
    initial_model: Optional[Pq] = None,
    device=None,
) -> Pq:
    """Large-corpus PQ training: same semantics as :func:`train_pq`, but
    every Lloyd's iteration is one pass of the fused assign+statistics
    kernel over the instances, so training scales to any ``n`` that fits in
    device memory as raw data.

    With ``projection`` (an orthonormal ``(d, d)`` rotation), chunks are
    rotated on the fly and the returned model carries the projection (this
    is how ``train_gaussian_opq_chunked`` composes).  Attempts run one after
    the other; per subquantizer the minimum-loss attempt is kept, ties
    keeping the earlier one.

    ``use_kernel=None`` means the CUDA kernel when the instances lie on a
    GPU, at any ``ds``, and the plain tensor route on the CPU.  On a GPU only
    ``k > 65536`` raises a ``ValueError``; pass ``use_kernel=False`` for it.
    ``compute_dtype="verified"`` runs every iteration through
    :func:`reductive_tpu_torch.ops.pq_assign_stats_verified`: the cells each
    row joins are those of the exact f32 path, whatever the kernel's rounding.

    With ``checkpoint_every=e`` and ``checkpoint_path``, the current
    attempt's state is written atomically as an
    :mod:`reductive_tpu_torch.io` artifact every ``e`` iterations; a killed
    job restarts via ``initial_model=io.load(path)``, which runs
    ``n_iterations`` more from the saved codebooks (``n_attempts`` must then
    be 1).

    ``instances`` is a tensor (training runs where it lies) or a host array,
    which is put on ``device`` (``None`` means ``cuda``).  ``generator`` must
    live on that device.
    """
    _check_compute_dtype(compute_dtype)
    _check_checkpointing(checkpoint_every, checkpoint_path)
    instances = instances_on(instances, device)
    if use_kernel is None:
        use_kernel = instances.is_cuda
    n, d = instances.shape
    check_quantizer_invariants(
        n_subquantizers, n_subquantizer_bits, n_iterations, n_attempts, n, d
    )
    m = n_subquantizers
    k = 2 ** n_subquantizer_bits
    ds = d // m
    logger.info(
        "Training %d PQ subquantizers chunked (k=%d, %d iterations, "
        "%d attempts, chunk=%d)",
        m, k, n_iterations, n_attempts, chunk,
    )
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
        check_generator(generator, instances.device)

    sumsq = _streamed_sumsq(instances, m, chunk=chunk, projection=projection)
    log_it = logger.isEnabledFor(logging.INFO)

    best_cb, best_loss = None, None
    for attempt in range(n_attempts):
        cb = (
            initial_model.codebooks
            if initial_model is not None
            else init_codebooks_random(instances, generator, k, ds, projection)
        )
        loss = torch.full((m,), float("inf"), dtype=torch.float32, device=instances.device)
        for done in range(1, n_iterations + 1):
            cb, loss = lloyd_iteration_chunked(
                instances, cb, sumsq, chunk=chunk, use_kernel=use_kernel,
                compute_dtype=compute_dtype, projection=projection,
            )
            if log_it:
                logger.info(
                    "Lloyd's iteration %d: mean subquantizer loss %.6f",
                    done - 1, float(loss.mean()),
                )
            if checkpoint_every is not None and (
                done % checkpoint_every == 0 or done == n_iterations
            ):
                from .. import io as _io_mod

                _io_mod.save(checkpoint_path, Pq(codebooks=cb, projection=projection))
                logger.info(
                    "Checkpointed PQ state (attempt %d, %d/%d iterations) to %s",
                    attempt, done, n_iterations, checkpoint_path,
                )
        if best_cb is None:
            best_cb, best_loss = cb, loss
        else:
            better = loss < best_loss  # strict: ties keep the earlier attempt
            best_cb = torch.where(better[:, None, None], cb, best_cb)
            best_loss = torch.minimum(best_loss, loss)
    return Pq(codebooks=best_cb, projection=projection)
