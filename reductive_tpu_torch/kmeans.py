"""K-means clustering in plain tensor code.

Counterpart of ``reductive_tpu.kmeans``:

* **assign**: pairwise squared distances via the norm expansion (one matrix
  product) followed by an argmin; ties break to the first index.
* **update**: per-centroid sums by a one-hot product (an order of addition
  fixed by the shapes, on the card too) and counts by ``bincount``, then a
  count-guarded divide.  A cluster with no assigned
  instance becomes the **zero vector**.
* **iterate**: Python loops.  The fixed-count loop never waits for the
  device; the convergence loop reads one loss per iteration.

The per-iteration loss is the MSE between the instances and their assigned
centroids **after** the centroid update, normalized by ``n * d``, the number
of scalar elements.

Random draws take a ``torch.Generator`` where the JAX package takes a key.
The generator must live on the device of the data; the streams differ from
JAX's, so only distributions are comparable across the two packages.
"""

from __future__ import annotations

import dataclasses
import logging
from typing import Callable, Optional, Tuple, Union

import torch
from torch import Tensor

from ._device import check_generator, instances_on
from .linalg import one_hot_sums, squared_euclidean_distance

logger = logging.getLogger("reductive_tpu")

__all__ = [
    "RandomInstanceCentroids",
    "KMeansPlusPlusCentroids",
    "NIterations",
    "LossConvergence",
    "random_distinct_indices",
    "cluster_assignment",
    "cluster_assignments",
    "update_centroids",
    "mean_squared_error",
    "kmeans_iteration",
    "lloyd_iteration_batched",
    "kmeans_with_centroids",
    "kmeans_with_centroids_chunked",
    "kmeans",
]


# ---------------------------------------------------------------------------
# Initial centroid selection
# ---------------------------------------------------------------------------


def random_distinct_indices(generator: torch.Generator, n: int, k: int) -> Tensor:
    """``k`` distinct uniform indices in ``[0, n)`` (int64, on the
    generator's device), in first-draw order.

    Small ``n`` takes the head of a permutation.  For ``n > 16k`` that would
    cost O(n) per draw, so ``4k`` uniform draws are deduplicated in
    first-occurrence order instead (a stable sort groups equal values with
    the earliest draw first).  Fewer than ``k`` distinct values among ``4k``
    draws at ``n > 16k`` is astronomically unlikely; slots it would leave
    open keep the identity indices ``0..k``.
    """
    dev = generator.device
    if n <= 16 * k:
        return torch.randperm(n, generator=generator, device=dev)[:k]
    c = 4 * k
    cand = torch.randint(0, n, (c,), generator=generator, device=dev)
    sorted_vals, perm = torch.sort(cand, stable=True)
    is_first_sorted = torch.ones((c,), dtype=torch.bool, device=dev)
    is_first_sorted[1:] = sorted_vals[1:] != sorted_vals[:-1]
    first = torch.zeros((c,), dtype=torch.bool, device=dev)
    first[perm] = is_first_sorted
    distinct = cand[first][:k]
    out = torch.arange(k, dtype=cand.dtype, device=dev)
    out[: distinct.shape[0]] = distinct
    return out


def _check_k(n: int, k: int) -> None:
    if k <= 0:
        raise ValueError("Cannot pick 0 random centroids")
    if k >= n:
        raise ValueError(
            f"Cannot pick more centroids than instances: {n} instances, {k} centroids"
        )


@dataclasses.dataclass(frozen=True)
class RandomInstanceCentroids:
    """Pick ``k`` distinct random instances as the initial centroids.
    ``generator`` must live on the device of ``x``."""

    def __call__(self, generator: torch.Generator, x: Tensor, k: int) -> Tensor:
        _check_k(x.shape[0], k)
        if x.ndim != 2 or x.shape[1] == 0:
            raise ValueError("Cannot pick centroids from zero-length instances")
        check_generator(generator, x.device)
        return x[random_distinct_indices(generator, x.shape[0], k)]


@dataclasses.dataclass(frozen=True)
class KMeansPlusPlusCentroids:
    """k-means++ (Arthur & Vassilvitskii, 2007) D²-weighted seeding.

    Successive centroids are sampled with probability proportional to the
    squared distance to the nearest centroid chosen so far.  ``batch > 1``
    switches to round-based sampling (the k-means|| idea, Bahmani et al.,
    2012): each round draws ``batch`` distinct candidates from the current
    D² distribution at once, then updates the distances with one
    ``(n, batch)`` distance block.  Candidates within a round do not see
    each other's updates.  The default picks ``batch`` so that there are at
    most 256 rounds, and stays exactly sequential for small ``k``.

    A round samples without replacement by the Gumbel top-k rule (the
    ``batch`` largest of ``log w + Gumbel noise``), which is the sequential
    weighted draw without replacement and has no limit on ``n``.
    ``generator`` must live on the device of ``x``.
    """

    def __call__(
        self, generator: torch.Generator, x: Tensor, k: int, batch: Optional[int] = None
    ) -> Tensor:
        n, d = x.shape
        _check_k(n, k)
        check_generator(generator, x.device)
        if batch is None:
            batch = max(1, -(-(k - 1) // 256))
        rounds = -(-(k - 1) // batch)
        first_idx = torch.randint(0, n, (1,), generator=generator, device=x.device)
        chosen = [x[first_idx]]
        min_d2 = squared_euclidean_distance(x, x[first_idx])[:, 0]
        for _ in range(rounds):
            weights = min_d2.clamp_min(0.0)
            # Degenerate case (all points identical): fall back to uniform.
            if not bool(weights.sum() > 0):
                weights = torch.ones_like(weights)
            uniform = torch.rand((n,), generator=generator, device=x.device)
            keys = torch.log(weights) - torch.log(-torch.log(uniform))
            # Distinct within a round: a duplicate centroid would stay a dead
            # cell through Lloyd's.
            new = x[torch.topk(keys, batch).indices]
            chosen.append(new)
            min_d2 = torch.minimum(min_d2, squared_euclidean_distance(x, new).min(dim=1).values)
        return torch.cat(chosen)[:k]


# ---------------------------------------------------------------------------
# Stop conditions
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class NIterations:
    """Stop after exactly ``n`` iterations."""

    n: int


@dataclasses.dataclass(frozen=True)
class LossConvergence:
    """Stop when the relative loss improvement of an iteration drops to
    ``rel_tol`` or below, or after ``max_iterations``.

    The first comparison is made after the second iteration, when two losses
    exist.  (The JAX package compares after the first, against an infinite
    previous loss, which never counts as an improvement: its loop ends after
    one iteration.  See ROADMAP.md, queue 3.)"""

    max_iterations: int
    rel_tol: float = 1e-6


StopCondition = Union[NIterations, LossConvergence]


# ---------------------------------------------------------------------------
# Core steps
# ---------------------------------------------------------------------------


def cluster_assignment(centroids: Tensor, instance: Tensor) -> Tensor:
    """Index of the nearest centroid for one instance (int32 scalar).  Ties
    break to the first index."""
    return torch.argmin(squared_euclidean_distance(instance, centroids)).to(torch.int32)


def cluster_assignments(centroids: Tensor, instances: Tensor) -> Tensor:
    """Nearest-centroid index for each row of ``instances`` (int32): one
    ``(n, d) x (d, k)`` product plus a row argmin; ties break to the first
    index."""
    dists = squared_euclidean_distance(instances, centroids)
    return torch.argmin(dists, dim=1).to(torch.int32)


def _means(sums: Tensor, counts: Tensor, dtype: torch.dtype) -> Tensor:
    """Count-guarded divide: empty clusters become the zero vector."""
    safe = counts.clamp_min(1.0)
    means = torch.where((counts > 0)[..., None], sums / safe[..., None], torch.zeros_like(sums))
    return means.to(dtype)


def update_centroids(x: Tensor, assignments: Tensor, k: int) -> Tensor:
    """Mean of the instances assigned to each centroid.  Clusters with no
    assigned instances become the **zero vector**."""
    idx = assignments.to(torch.int64)
    sums = one_hot_sums(idx[:, None], x[:, None, :], k)[0][0]
    counts = torch.bincount(idx, minlength=k).to(x.dtype)
    return _means(sums, counts, x.dtype)


def mean_squared_error(centroids: Tensor, x: Tensor, assignments: Tensor) -> Tensor:
    """MSE between instances and their assigned centroids, normalized by the
    total element count ``n * d`` (the number of scalars, not of rows)."""
    err = centroids[assignments.to(torch.int64)] - x
    return torch.sum(err * err) / x.numel()


def lloyd_iteration_batched(xs: Tensor, codebooks: Tensor) -> Tuple[Tensor, Tensor]:
    """One Lloyd's step for ``m`` independent clusterings at once:
    ``xs`` is ``(m, n, ds)``, ``codebooks`` ``(m, k, ds)``.  Returns the new
    ``(m, k, ds)`` codebooks and the ``(m,)`` losses, each the MSE of its
    instances against the **updated** centroids under the assignments
    computed from the old ones, normalized by ``n * ds``.

    The batch axis takes the place of the JAX package's ``vmap`` over
    subquantizers.  The ``(m, n, k)`` distance tensor is materialized.
    """
    m, n, ds = xs.shape
    k = codebooks.shape[1]
    if k == 0:
        raise ValueError("Cannot cluster instances with zero centroids.")
    x_sqn = torch.einsum("mnd,mnd->mn", xs, xs)
    c_sqn = torch.einsum("mkd,mkd->mk", codebooks, codebooks)
    dp = torch.bmm(xs, codebooks.transpose(1, 2))
    dists = x_sqn[:, :, None] + c_sqn[:, None, :] - (dp + dp)
    codes = torch.argmin(dists, dim=2)  # (m, n)
    del dists, dp
    cells = (codes + torch.arange(m, device=xs.device)[:, None] * k).reshape(-1)
    flat = xs.reshape(m * n, ds)
    sums = one_hot_sums(codes.T, xs.transpose(0, 1), k)[0].reshape(m * k, ds)
    counts = torch.bincount(cells, minlength=m * k).to(xs.dtype)
    new = _means(sums, counts, xs.dtype)
    err = new[cells] - flat
    losses = torch.sum((err * err).reshape(m, n * ds), dim=1) / (n * ds)
    return new.reshape(m, k, ds), losses


def kmeans_iteration(
    x: Tensor, centroids: Tensor, instance_axis: int = 0
) -> Tuple[Tensor, Tensor]:
    """One Lloyd's step: assign -> update -> loss.  Returns the new
    centroids and the MSE of the instances against the **updated** centroids
    under the assignments computed from the old centroids.
    ``instance_axis`` selects rows (0) or columns (1) as instances;
    centroids are always rows."""
    x = _instances_as_rows(x, instance_axis)
    new, losses = lloyd_iteration_batched(x[None], centroids[None])
    return new[0], losses[0]


def _instances_as_rows(x: Tensor, instance_axis: int) -> Tensor:
    if instance_axis == 1:
        return x.T
    if instance_axis != 0:
        raise ValueError(f"instance_axis must be 0 or 1, got {instance_axis}")
    return x


def _check_centroids(x: Tensor, centroids: Tensor) -> None:
    if centroids.shape[0] == 0:
        raise ValueError("Cannot cluster instances with zero centroids.")
    if centroids.shape[1] != x.shape[1]:
        raise ValueError(
            f"Centroid and instance lengths differ: {centroids.shape[1]} != {x.shape[1]}"
        )


def kmeans_with_centroids(
    x: Tensor,
    centroids: Tensor,
    stop: Union[StopCondition, int],
    instance_axis: int = 0,
) -> Tuple[Tensor, Tensor]:
    """Run Lloyd's iterations from the given initial centroids.

    ``stop`` may be an int (shorthand for :class:`NIterations`), an
    :class:`NIterations`, or a :class:`LossConvergence`.  Returns
    ``(centroids, final_loss)``; the loss is a 0-dim tensor.
    """
    x = _instances_as_rows(x, instance_axis).contiguous()
    if isinstance(stop, int):
        stop = NIterations(stop)
    _check_centroids(x, centroids)
    loss = torch.full((), float("inf"), dtype=x.dtype, device=x.device)

    if isinstance(stop, NIterations):
        if stop.n <= 0:
            raise ValueError("The number of iterations must be >= 1")
        for _ in range(stop.n):
            centroids, loss = kmeans_iteration(x, centroids)
        return centroids, loss

    if isinstance(stop, LossConvergence):
        prev = float("inf")
        for i in range(stop.max_iterations):
            centroids, loss = kmeans_iteration(x, centroids)
            now = float(loss)
            if i >= 1 and not (prev - now) > stop.rel_tol * max(prev, 1e-30):
                break
            prev = now
        return centroids, loss

    raise TypeError(f"Unsupported stop condition: {stop!r}")


def kmeans_with_centroids_chunked(
    x: Tensor,
    centroids: Tensor,
    n_iterations: int,
    *,
    chunk: int = 32768,
    use_kernel: Optional[bool] = None,
    compute_dtype=torch.float32,
) -> Tuple[Tensor, Tensor]:
    """Corpus-scale Lloyd's from given initial centroids without the
    ``(n, k)`` distance matrix: the single-quantizer (``m = 1``, ``ds = d``)
    view of the fused assign+statistics machinery of
    :mod:`reductive_tpu_torch.pq.train`.  Same semantics as
    :func:`kmeans_with_centroids` with :class:`NIterations`.
    ``compute_dtype`` is ``torch.float32``, ``torch.bfloat16`` or
    ``"verified"`` (cell memberships equal to the exact path's).

    ``use_kernel=None`` means the CUDA kernel when ``x`` lies on a GPU (at
    any ``d``: ``d`` in 4, 8, 16, 32 takes the narrow kernel, every other
    ``d`` the wide route) and the plain tensor route on the CPU.
    """
    from .pq.train import _check_compute_dtype, _streamed_sumsq, lloyd_iteration_chunked

    _check_compute_dtype(compute_dtype)
    if use_kernel is None:
        use_kernel = x.is_cuda
    _check_centroids(x, centroids)
    if n_iterations <= 0:
        raise ValueError("The number of iterations must be >= 1")
    sumsq = _streamed_sumsq(x, 1, chunk=chunk)
    loss = torch.full((), float("inf"), dtype=torch.float32, device=x.device)
    for _ in range(n_iterations):
        cb, losses = lloyd_iteration_chunked(
            x, centroids[None], sumsq, chunk=chunk, use_kernel=use_kernel,
            compute_dtype=compute_dtype,
        )
        centroids, loss = cb[0], losses[0]
    return centroids, loss


def kmeans(
    generator: torch.Generator,
    x,
    k: int,
    stop: Union[StopCondition, int],
    init: Callable[[torch.Generator, Tensor, int], Tensor] = RandomInstanceCentroids(),
    instance_axis: int = 0,
    device=None,
) -> Tuple[Tensor, Tensor]:
    """Full k-means: initial centroid selection followed by Lloyd's
    iterations.

    ``x`` is a tensor (the run happens where it lies) or a host array, which
    is put on ``device`` (``None`` means ``cuda``).  ``generator`` must live
    on that device.  ``instance_axis`` selects whether instances are rows
    (0) or columns (1) of ``x``; centroids are always returned as rows.
    """
    x = _instances_as_rows(instances_on(x, device), instance_axis)
    n = x.shape[0]
    if k == 0 or k > n:
        raise ValueError("k cannot be larger than the number of data points or zero")
    centroids = init(generator, x, k)
    return kmeans_with_centroids(x, centroids, stop)
