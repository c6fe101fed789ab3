"""Carrying a quantizer's weights, or an IVF-PQ index, between the JAX
package and this one.

Both packages keep the same arrays in the same layout: ``(m, k, ds)``
codebooks and an optional ``(d, d)`` projection; for an index also the
``(C, d)`` coarse centroids, the ``(C, L, m)`` (or packed ``(C, L, m/2)``)
cell codes, the ``(C, L)`` int32 cell ids and f32 cell norms, and the ids the
build dropped.  The caller turns the JAX side into numpy
(``np.asarray(pq.codebooks)``); this module imports no JAX.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

import torch

from ._device import resolve_device
from .ivf import IvfPq
from .pq.model import Pq

__all__ = ["from_jax_params", "to_numpy", "ivf_from_jax_params", "ivf_to_numpy"]


def from_jax_params(
    codebooks: np.ndarray, projection: Optional[np.ndarray] = None, device=None
) -> Pq:
    """A :class:`Pq` on ``device`` from the arrays of a ``reductive_tpu.Pq``.
    ``None`` means ``cuda`` and raises where there is none."""
    return Pq.from_numpy(np.asarray(codebooks), None if projection is None
                         else np.asarray(projection), device=device)


def to_numpy(pq: Pq) -> tuple[np.ndarray, Optional[np.ndarray]]:
    """``(codebooks, projection)`` as host arrays, ready for
    ``reductive_tpu.Pq(codebooks=jnp.asarray(...), projection=...)``."""
    return (
        pq.codebooks.detach().cpu().numpy(),
        None if pq.projection is None else pq.projection.detach().cpu().numpy(),
    )


def ivf_from_jax_params(
    coarse: np.ndarray, codebooks: np.ndarray, projection: Optional[np.ndarray],
    cell_codes: np.ndarray, cell_ids: np.ndarray, cell_norms: np.ndarray,
    dropped_ids: Optional[np.ndarray] = None, device=None,
) -> IvfPq:
    """An :class:`IvfPq` on ``device`` from the arrays of a
    ``reductive_tpu.ivf.IvfPq`` (its ``dropped_ids`` where given).  ``None``
    means ``cuda`` and raises where there is none."""
    dev = resolve_device(device)
    return IvfPq(
        coarse_centroids=torch.tensor(np.asarray(coarse), device=dev),
        pq=from_jax_params(codebooks, projection, device=dev),
        cell_codes=torch.tensor(np.asarray(cell_codes), device=dev),
        cell_ids=torch.tensor(np.asarray(cell_ids), device=dev),
        cell_norms=torch.tensor(np.asarray(cell_norms), device=dev),
        dropped_ids=np.empty(0, np.int64) if dropped_ids is None
        else np.asarray(dropped_ids, np.int64),
    )


def ivf_to_numpy(index: IvfPq) -> tuple:
    """``(coarse, codebooks, projection, cell_codes, cell_ids, cell_norms,
    dropped_ids)`` as host arrays, in the order
    :func:`ivf_from_jax_params` takes them, ready for
    ``reductive_tpu.ivf.IvfPq(...)`` (``projection`` may be None)."""
    codebooks, projection = to_numpy(index.pq)
    return (
        index.coarse_centroids.detach().cpu().numpy(), codebooks, projection,
        index.cell_codes.detach().cpu().numpy(), index.cell_ids.detach().cpu().numpy(),
        index.cell_norms.detach().cpu().numpy(), np.asarray(index.dropped_ids, np.int64),
    )
