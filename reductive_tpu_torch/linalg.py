"""Linear-algebra utilities: pairwise distances and covariance.

Counterpart of ``reductive_tpu.linalg``.  Squared Euclidean distances go
through the norm expansion

    ``|u - v|^2 = |u|^2 + |v|^2 - 2 u.v``

so that the heavy lifting is one matrix product.  Products are real float32
(``torch.backends.cuda.matmul.allow_tf32`` stays ``False``).  Functions run
where their tensors are.
"""

from __future__ import annotations

import torch
from torch import Tensor

from ._collectives import all_reduce, group_size
from ._precision import check_precision

__all__ = [
    "squared_euclidean_distance",
    "euclidean_distance",
    "covariance",
    "one_hot_sums",
]

# one_hot_sums takes rows in chunks that keep the one-hot block below this
# many elements (256 MB of float32).
_ONE_HOT_ELEMS = 1 << 26


def one_hot_sums(
    cells: Tensor, xs: Tensor, k: int, *, minus: Tensor | None = None,
    weight: Tensor | None = None,
) -> tuple[Tensor, Tensor]:
    """Per-cell sums ``(m, k, ds)`` of the rows of ``xs`` ``(n, m, ds)`` in
    the cells ``cells`` ``(n, m)`` names, and the per-cell sums ``(m, k)`` of
    the one-hot weights, as the JAX package's one-hot product: per chunk of
    rows, ``H^T @ xs`` for each ``j`` with ``H = one_hot(cells)`` (less
    ``one_hot(minus)`` where given, times ``weight`` ``(n, m)`` where given),
    chunk after chunk.  Every sum is taken in an order fixed by the shapes,
    on the CPU as on the card, where ``index_add_`` adds with float atomics
    in an order that changes from run to run.  ``H`` is written by a scatter
    and, with ``minus``, a scatter-add that meets each entry once, so it too
    is the same on every run."""
    n, m, ds = xs.shape
    dtype = xs.dtype
    sums = torch.zeros((m, k, ds), dtype=dtype, device=xs.device)
    counts = torch.zeros((m, k), dtype=dtype, device=xs.device)
    step = max(1, _ONE_HOT_ELEMS // (m * k))
    for i in range(0, n, step):
        at = cells[i:i + step, :, None].to(torch.int64)
        w = torch.ones(at.shape, dtype=dtype, device=xs.device) if weight is None \
            else weight[i:i + step, :, None].to(dtype)
        hot = torch.zeros((at.shape[0], m, k), dtype=dtype, device=xs.device).scatter_(2, at, w)
        if minus is not None:
            hot.scatter_add_(2, minus[i:i + step, :, None].to(torch.int64), -w)
        sums += torch.einsum("nmk,nmd->mkd", hot, xs[i:i + step])
        counts += hot.sum(dim=0)
    return sums, counts


def squared_euclidean_distance(u: Tensor, v: Tensor, *, precision="highest") -> Tensor:
    """Squared Euclidean distance(s) between ``u`` and ``v``.

    * ``(d,) x (d,)``  -> scalar.
    * ``(d,) x (k, d)`` -> ``(k,)`` distances from ``u`` to each row of ``v``.
    * ``(n, d) x (k, d)`` -> ``(n, k)`` with entry ``(i, j)`` the distance
      between row ``i`` of ``u`` and row ``j`` of ``v``.

    The result is not clamped at zero, so tiny negative values can appear
    for near-identical inputs.  ``precision`` takes ``"highest"`` only (the
    JAX package's keyword; the products here are float32).
    """
    check_precision(precision)
    if u.ndim == 1 and v.ndim == 1:
        if u.shape[0] != v.shape[0]:
            raise ValueError(
                "Cannot compute (squared) euclidean distance of vectors with "
                f"different lengths: {u.shape[0]} != {v.shape[0]}"
            )
        dp = torch.dot(u, v)
        return torch.dot(u, u) + torch.dot(v, v) - (dp + dp)
    if u.ndim == 1 and v.ndim == 2:
        if u.shape[0] != v.shape[1]:
            raise ValueError(
                "Cannot compute (squared) euclidean distance when the number of "
                f"vector components ({u.shape[0]}) and matrix columns ({v.shape[1]}) differ."
            )
        u_sqn = torch.dot(u, u)
        v_sqn = torch.einsum("kd,kd->k", v, v)
        dp = torch.mv(v, u)
        return u_sqn + v_sqn - (dp + dp)
    if u.ndim == 2 and v.ndim == 2:
        if u.shape[1] != v.shape[1]:
            raise ValueError(
                "Cannot compute (squared) euclidean distance of matrices with "
                f"different numbers of columns: {u.shape[1]} != {v.shape[1]}"
            )
        u_sqn = torch.einsum("nd,nd->n", u, u)
        v_sqn = torch.einsum("kd,kd->k", v, v)
        dp = torch.matmul(u, v.T)
        return u_sqn[:, None] + v_sqn[None, :] - (dp + dp)
    raise ValueError(
        f"Unsupported operand ranks for squared_euclidean_distance: {u.ndim} and {v.ndim}"
    )


def euclidean_distance(u: Tensor, v: Tensor, *, precision="highest") -> Tensor:
    """Euclidean distance(s): the square root of
    :func:`squared_euclidean_distance`, with the same shape rules."""
    return torch.sqrt(squared_euclidean_distance(u, v, precision=precision))


def covariance(x: Tensor, observation_axis: int = 0, *, precision="highest") -> Tensor:
    """Covariance matrix of ``x`` with observations along ``observation_axis``.

    For an ``n x m`` matrix with ``n`` observations along axis 0, returns the
    ``m x m`` matrix ``C`` with ``C[i, j]`` the covariance between variables
    ``i`` and ``j``: mean-centered, normalized by ``n - 1``.  ``precision``
    takes ``"highest"`` only.
    """
    check_precision(precision)
    if x.ndim != 2:
        raise ValueError(f"covariance expects a rank-2 array, got rank {x.ndim}")
    if observation_axis not in (0, 1):
        raise ValueError(f"observation_axis must be 0 or 1, got {observation_axis}")
    if x.shape[observation_axis] == 0:
        raise ValueError("Cannot compute a covariance from zero observations")
    return row_covariance(x if observation_axis == 0 else x.T)


def row_covariance(x: Tensor, group=None) -> Tensor:
    """Covariance of the rows of ``x`` (observations along axis 0): the
    mean is the column sums over ``n``, then ``centered^T (centered / (n -
    1))``.  With ``group`` (a process group whose ranks each hold ``n_local``
    rows), ``x`` is this rank's shard: the column sums and the products are
    summed over the group, so every rank gets the covariance of all the rows
    (and at one rank the bits of the single-process call)."""
    n = x.shape[0] * group_size(group)
    (col_sums,) = all_reduce(group, torch.sum(x, dim=0, keepdim=True))
    centered = x - col_sums / n
    (cov,) = all_reduce(group, torch.matmul(centered.T, centered / float(n - 1)))
    return cov
