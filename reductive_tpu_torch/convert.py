"""Carrying a quantizer's weights between the JAX package and this one.

Both packages keep the same two arrays in the same layout: ``(m, k, ds)``
codebooks and an optional ``(d, d)`` projection.  The caller turns the JAX
side into numpy (``np.asarray(pq.codebooks)``); this module imports no JAX.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from .pq.model import Pq

__all__ = ["from_jax_params", "to_numpy"]


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
