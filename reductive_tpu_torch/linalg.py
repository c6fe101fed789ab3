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

__all__ = [
    "squared_euclidean_distance",
    "euclidean_distance",
    "covariance",
]


def squared_euclidean_distance(u: Tensor, v: Tensor) -> Tensor:
    """Squared Euclidean distance(s) between ``u`` and ``v``.

    * ``(d,) x (d,)``  -> scalar.
    * ``(d,) x (k, d)`` -> ``(k,)`` distances from ``u`` to each row of ``v``.
    * ``(n, d) x (k, d)`` -> ``(n, k)`` with entry ``(i, j)`` the distance
      between row ``i`` of ``u`` and row ``j`` of ``v``.

    The result is not clamped at zero, so tiny negative values can appear
    for near-identical inputs.
    """
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


def euclidean_distance(u: Tensor, v: Tensor) -> Tensor:
    """Euclidean distance(s): the square root of
    :func:`squared_euclidean_distance`, with the same shape rules."""
    return torch.sqrt(squared_euclidean_distance(u, v))


def covariance(x: Tensor, observation_axis: int = 0) -> Tensor:
    """Covariance matrix of ``x`` with observations along ``observation_axis``.

    For an ``n x m`` matrix with ``n`` observations along axis 0, returns the
    ``m x m`` matrix ``C`` with ``C[i, j]`` the covariance between variables
    ``i`` and ``j``: mean-centered, normalized by ``n - 1``.
    """
    if x.ndim != 2:
        raise ValueError(f"covariance expects a rank-2 array, got rank {x.ndim}")
    if observation_axis not in (0, 1):
        raise ValueError(f"observation_axis must be 0 or 1, got {observation_axis}")
    n_obs = x.shape[observation_axis]
    if n_obs == 0:
        raise ValueError("Cannot compute a covariance from zero observations")

    centered = x - torch.mean(x, dim=observation_axis, keepdim=True)
    normalization = float(n_obs - 1)
    if observation_axis == 0:
        return torch.matmul(centered.T, centered / normalization)
    return torch.matmul(centered, centered.T / normalization)
