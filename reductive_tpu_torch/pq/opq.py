"""Optimized product quantization (Ge et al., 2013): learned rotations.

Counterpart of ``reductive_tpu.pq.opq``.  OPQ learns an orthonormal
``(d, d)`` projection that balances variance across the ``m``
subquantizers, alternating between codebook refinement and a Procrustes
update of the rotation.

The eigendecomposition and the SVD run where the data lies
(``torch.linalg.eigh`` / ``torch.linalg.svd``); only the ``d`` eigenvalues
come to the host, for the greedy bucketing.  The Procrustes step is
``R = U V^T`` from ``svd(X^T X_hat)``.  For a rank-deficient cross matrix
(structural when ``m * k < d``) the completion of the null directions is the
SVD's choice; ``R`` is orthonormal either way.  Eigenvectors are defined up
to sign, so a projection made here and one made by another eigensolver
agree up to the sign of each column.
"""

from __future__ import annotations

import logging
from typing import List, Optional

import numpy as np
import torch
from torch import Tensor

from .._device import check_generator, instances_on
from ..errors import check_quantizer_invariants
from ..kmeans import lloyd_iteration_batched
from ..linalg import covariance
from . import primitives
from .model import Pq
from .train import (
    _check_checkpointing,
    _check_compute_dtype,
    _streamed_sumsq,
    assign_stats_streamed,
    centroids_from_stats,
    explained_from_stats,
    init_codebooks_random,
    is_verified,
    train_pq_chunked,
    train_pq_subspace,
)

logger = logging.getLogger("reductive_tpu")

__all__ = [
    "bucket_eigenvalues",
    "create_projection_matrix",
    "projection_from_covariance",
    "train_opq",
    "train_opq_chunked",
    "train_gaussian_opq",
    "train_gaussian_opq_chunked",
]


def bucket_eigenvalues(eigenvalues: np.ndarray, n_buckets: int) -> List[List[int]]:
    """Distribute eigenvalue indices over ``n_buckets`` so the product of
    eigenvalues (total variance) is balanced across buckets.

    Host-side greedy algorithm: sort ascending, then repeatedly take the
    largest remaining eigenvalue and place it in the non-full bucket with
    the smallest log-space product (ties to the first bucket).  Each bucket
    holds exactly ``len(eigenvalues) / n_buckets`` entries.
    """
    eigenvalues = np.asarray(eigenvalues)
    if n_buckets <= 0:
        raise ValueError("Cannot distribute eigenvalues over zero buckets.")
    if len(eigenvalues) < n_buckets:
        raise ValueError("At least one eigenvalue is required per bucket")
    if len(eigenvalues) % n_buckets != 0:
        raise ValueError(
            "The number of eigenvalues should be a multiple of the number of buckets."
        )

    order = list(np.argsort(eigenvalues, kind="stable"))
    eps = np.finfo(eigenvalues.dtype if eigenvalues.dtype.kind == "f" else np.float64).eps
    if eigenvalues[order[0]] < -eps:
        raise ValueError("Bucketing is only supported for positive eigenvalues.")

    # Log-space products to avoid over/underflow; shift so all values are
    # non-negative, making (0, 1] and [1, inf) eigenvalues comparable.
    logs = np.log(eigenvalues.astype(np.float64) + eps)
    logs -= logs.min()

    max_assignments = len(eigenvalues) // n_buckets
    assignments: List[List[int]] = [[] for _ in range(n_buckets)]
    products = [0.0] * n_buckets

    while order:
        idx = int(order.pop())  # largest remaining
        bucket = min(
            (b for b in range(n_buckets) if len(assignments[b]) < max_assignments),
            key=lambda b: products[b],
        )
        assignments[bucket].append(idx)
        products[bucket] += logs[idx]

    return assignments


def create_projection_matrix(instances: Tensor, n_subquantizers: int) -> Tensor:
    """PCA-bucketed initial projection: eigendecompose the covariance
    matrix, balance the principal directions over the subquantizers by
    eigenvalue bucketing, and assemble the permuted eigenvectors as
    columns."""
    logger.info(
        "Creating projection matrix (%d instances, %d dimensions, %d subquantizers)",
        instances.shape[0], instances.shape[1], n_subquantizers,
    )
    return projection_from_covariance(covariance(instances, 0), n_subquantizers)


def projection_from_covariance(cov: Tensor, n_subquantizers: int) -> Tensor:
    """The eigendecompose-and-bucket half of :func:`create_projection_matrix`
    for callers that already hold the covariance matrix."""
    eigen_values, eigen_vectors = torch.linalg.eigh(cov)
    buckets = bucket_eigenvalues(eigen_values.cpu().numpy(), n_subquantizers)
    permutation = torch.tensor(
        [idx for bucket in buckets for idx in bucket], dtype=torch.int64, device=cov.device
    )
    return eigen_vectors[:, permutation].contiguous()


def _procrustes(cross: Tensor) -> Tensor:
    """The orthonormal ``R`` that maximizes ``tr(R^T M)``: ``U V^T`` from
    ``svd(M)`` (Ge et al., 2013, Eq. 7)."""
    u, _, vh = torch.linalg.svd(cross)
    return torch.matmul(u, vh)


def _alternate(
    x: Tensor, projection: Tensor, codebooks: Tensor, n_iterations: int
) -> tuple[Tensor, Tensor]:
    """The OPQ alternating minimization.  Each iteration:

    1. rotate all instances by the current projection;
    2. one Lloyd's iteration per subquantizer (batched over ``m``);
    3. quantize -> reconstruct roundtrip in the rotated space;
    4. Procrustes update from ``X^T X_hat``.
    """
    m, _, ds = codebooks.shape
    n = x.shape[0]
    log_it = logger.isEnabledFor(logging.INFO)
    for i in range(n_iterations):
        rx = torch.matmul(x, projection)
        rxs = rx.reshape(n, m, ds).transpose(0, 1).contiguous()  # (m, n, ds)
        codebooks, losses = lloyd_iteration_batched(rxs, codebooks)
        if log_it:
            logger.info("OPQ iteration %d: loss %.6f", i, float(losses.mean()))
        codes = primitives.quantize_batch(codebooks, rx, dtype=torch.int32)
        reconstructed = primitives.reconstruct_batch(codebooks, codes)
        projection = _procrustes(torch.matmul(x.T, reconstructed))
    return projection, codebooks


def train_opq(
    generator: torch.Generator,
    instances,
    n_subquantizers: int,
    n_subquantizer_bits: int,
    n_iterations: int,
    n_attempts: int = 1,
    *,
    device=None,
) -> Pq:
    """Train an optimized product quantizer.  Training always uses a single
    attempt: ``n_attempts`` is accepted for API parity and has no effect.

    ``instances`` is a tensor (training runs where it lies) or a host array,
    which is put on ``device`` (``None`` means ``cuda``).  ``generator`` must
    live on that device.
    """
    instances = instances_on(instances, device)
    check_generator(generator, instances.device)
    n, d = instances.shape
    check_quantizer_invariants(
        n_subquantizers, n_subquantizer_bits, n_iterations, 1, n, d
    )
    k = 2 ** n_subquantizer_bits
    ds = d // n_subquantizers

    projection = create_projection_matrix(instances, n_subquantizers)
    # Initial centroids: k distinct random instances per subquantizer slice
    # of the rotated data.
    codebooks = init_codebooks_random(instances, generator, k, ds, projection)
    logger.info(
        "Running %d OPQ iterations (subquantizer update + Procrustes "
        "projection update per iteration)",
        n_iterations,
    )
    projection, codebooks = _alternate(instances, projection, codebooks, n_iterations)
    return Pq(codebooks=codebooks, projection=projection)


def _opq_iteration_chunked(
    x: Tensor, projection: Tensor, codebooks: Tensor, *,
    chunk: int, use_kernel: bool, compute_dtype,
) -> tuple[Tensor, Tensor, Tensor]:
    """One OPQ alternation at corpus scale, in ``chunk``-row slices, without
    the rotated corpus, the ``(m, n, k)`` distance tensor or the
    reconstruction ever existing in full:

    1. per-centroid sums and counts of the rotated data through the fused
       assign+statistics kernel (chunks rotated on the fly), then the
       codebook update;
    2. codes under the **updated** codebooks and the Procrustes cross matrix
       ``M = X^T X_hat``, accumulated per chunk as
       ``x_chunk^T @ decode(codebooks, codes)``: with ``use_kernel`` the
       encode and decode kernels (decode bit-exact in f32 mode, one
       bfloat16 part in bf16 mode);
    3. ``R = U V^T`` from ``svd(M)``.

    The rotation and ``M`` are float32 products in every mode.
    ``compute_dtype="verified"`` is an exact mode: the statistics and the
    codes of step 2 are those of the exact f32 path (the verified kernels),
    the decode is bit-exact.  Returns the
    new projection, the new codebooks and the explained sum of squares
    (``sse = sum |x|^2 - explained``).
    """
    m, k, ds = codebooks.shape
    d = x.shape[1]
    verified = is_verified(compute_dtype)
    exact = verified or compute_dtype == torch.float32

    sums, counts = assign_stats_streamed(
        x, codebooks, chunk=chunk, use_kernel=use_kernel,
        compute_dtype=compute_dtype, projection=projection,
    )
    new_codebooks = centroids_from_stats(sums, counts, x.dtype)

    if use_kernel:
        from ..ops.assign import pq_encode, pq_encode_verified
        from ..ops.decode import pq_decode

    cross = torch.zeros((d, d), dtype=torch.float32, device=x.device)
    for i in range(0, x.shape[0], chunk):
        xc = x[i:i + chunk]
        rxc = torch.matmul(xc, projection)
        if use_kernel:
            if verified:
                codes = pq_encode_verified(new_codebooks, rxc, dtype=torch.int32)
            else:
                codes = pq_encode(
                    new_codebooks, rxc, dtype=torch.int32, compute_dtype=compute_dtype
                )
            rec = pq_decode(new_codebooks, codes, splits=3 if exact else 1)
        else:
            codes = primitives.quantize_batch(new_codebooks, rxc, dtype=torch.int32)
            rec = primitives.reconstruct_batch(new_codebooks, codes, method="gather")
        cross += torch.matmul(xc.T, rec)

    return _procrustes(cross.to(x.dtype)), new_codebooks, explained_from_stats(sums, counts).sum()


def train_opq_chunked(
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
    checkpoint_every: Optional[int] = None,
    checkpoint_path: Optional[str] = None,
    initial_model: Optional[Pq] = None,
    device=None,
) -> Pq:
    """Corpus-scale OPQ: the same alternating minimization as
    :func:`train_opq` (``n_attempts`` ignored) with every pass over the data
    taken in ``chunk``-row slices.

    ``use_kernel=None`` means the CUDA kernels (assign+statistics, encode,
    decode) when the instances lie on a GPU, at any ``ds``, and the plain
    tensor route on the CPU.  On a GPU only ``k > 65536`` raises a
    ``ValueError``; pass ``use_kernel=False`` for it.
    ``compute_dtype="verified"`` takes the verified statistics and encode
    (cell memberships and codes equal to the exact f32 path's); each of them
    waits for the device once per chunk.

    With ``checkpoint_every=e`` and ``checkpoint_path``, the
    ``(projection, codebooks)`` state is written atomically as an
    :mod:`reductive_tpu_torch.io` artifact every ``e`` alternations; a
    killed job restarts via ``initial_model=io.load(path)`` (skipping the
    projection and codebook initialisation).

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
        n_subquantizers, n_subquantizer_bits, n_iterations, 1, n, d
    )
    k = 2 ** n_subquantizer_bits
    ds = d // n_subquantizers

    if initial_model is not None:
        if initial_model.projection is None:
            raise ValueError("initial_model must carry a projection")
        if tuple(initial_model.codebooks.shape) != (n_subquantizers, k, ds):
            raise ValueError(
                f"initial_model codebooks have shape "
                f"{tuple(initial_model.codebooks.shape)}, expected {(n_subquantizers, k, ds)}"
            )
        projection, codebooks = initial_model.projection, initial_model.codebooks
    else:
        check_generator(generator, instances.device)
        projection = create_projection_matrix(instances, n_subquantizers)
        codebooks = init_codebooks_random(instances, generator, k, ds, projection)

    logger.info(
        "Running %d chunked OPQ iterations (fused-stats subquantizer "
        "update + chunked Procrustes accumulation per iteration)",
        n_iterations,
    )
    # The total sum of squares does not change under an orthonormal rotation:
    # taken once, for the per-iteration loss line.
    log_it = logger.isEnabledFor(logging.INFO)
    total_sumsq = _streamed_sumsq(instances, 1, chunk=chunk)[0] if log_it else None

    for done in range(1, n_iterations + 1):
        projection, codebooks, explained = _opq_iteration_chunked(
            instances, projection, codebooks, chunk=chunk, use_kernel=use_kernel,
            compute_dtype=compute_dtype,
        )
        if log_it:
            logger.info(
                "OPQ iteration %d: loss %.6f", done - 1,
                float((total_sumsq - explained) / float(n * d)),
            )
        if checkpoint_every is not None and (
            done % checkpoint_every == 0 or done == n_iterations
        ):
            from .. import io as _io_mod

            _io_mod.save(checkpoint_path, Pq(codebooks=codebooks, projection=projection))
            logger.info(
                "Checkpointed OPQ state after %d/%d alternations to %s",
                done, n_iterations, checkpoint_path,
            )
    return Pq(codebooks=codebooks, projection=projection)


def train_gaussian_opq_chunked(
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
    device=None,
) -> Pq:
    """Corpus-scale GaussianOpq: the closed-form rotation once, then
    :func:`~reductive_tpu_torch.pq.train.train_pq_chunked` with the
    projection applied chunk by chunk, so peak memory stays at one copy of
    the input.  Arguments as for ``train_pq_chunked``."""
    _check_compute_dtype(compute_dtype)
    instances = instances_on(instances, device)
    n, d = instances.shape
    check_quantizer_invariants(
        n_subquantizers, n_subquantizer_bits, n_iterations, n_attempts, n, d
    )
    projection = create_projection_matrix(instances, n_subquantizers)
    return train_pq_chunked(
        generator, instances, n_subquantizers, n_subquantizer_bits, n_iterations,
        n_attempts, chunk=chunk, use_kernel=use_kernel,
        compute_dtype=compute_dtype, projection=projection,
    )


def train_gaussian_opq(
    generator: torch.Generator,
    instances,
    n_subquantizers: int,
    n_subquantizer_bits: int,
    n_iterations: int,
    n_attempts: int = 1,
    *,
    device=None,
) -> Pq:
    """Train a Gaussian OPQ: compute the closed-form PCA-bucketed rotation
    once, rotate the data, then run plain PQ training on the rotated
    instances.  Assumes roughly Gaussian-distributed variables; much cheaper
    than the full alternating OPQ.  Arguments as for
    :func:`~reductive_tpu_torch.pq.train.train_pq`."""
    instances = instances_on(instances, device)
    n, d = instances.shape
    check_quantizer_invariants(
        n_subquantizers, n_subquantizer_bits, n_iterations, n_attempts, n, d
    )
    k = 2 ** n_subquantizer_bits
    ds = d // n_subquantizers

    projection = create_projection_matrix(instances, n_subquantizers)
    rx = torch.matmul(instances, projection)
    codebooks, _ = train_pq_subspace(
        generator, rx.reshape(n, n_subquantizers, ds), k, n_iterations, n_attempts
    )
    return Pq(codebooks=codebooks, projection=projection)
