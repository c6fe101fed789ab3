"""Artifact persistence for quantizers and IVF-PQ indexes.

A single ``.npz`` holding a format tag, a version, the codebooks and the
optional projection, and for an IVF-PQ index also the coarse centroids, the
cells (codes, ids, norms) and the ids the build dropped: the same keys and
values as ``reductive_tpu.io`` writes, so a file saved by either package
loads in the other.
"""

from __future__ import annotations

import io as _io
import os
from typing import Union

import numpy as np

import torch

from ._device import resolve_device
from .ivf import IvfPq
from .pq.model import Pq

__all__ = ["save", "load"]

_FORMAT = "reductive-tpu-pq"
_FORMAT_IVF = "reductive-tpu-ivfpq"
_VERSION = 1


def _atomic_savez(path, arrays) -> None:
    # Write via a buffer so a crash mid-write cannot leave a torn file,
    # then atomically replace.
    buf = _io.BytesIO()
    np.savez(buf, **arrays)
    tmp = f"{os.fspath(path)}.tmp"
    with open(tmp, "wb") as f:
        f.write(buf.getvalue())
    os.replace(tmp, os.fspath(path))


def _host(t) -> np.ndarray:
    return t.detach().cpu().numpy()


def save(path: Union[str, os.PathLike], pq: Union[Pq, IvfPq]) -> None:
    """Write a quantizer (:class:`Pq`) or an IVF-PQ index (:class:`IvfPq`)
    to ``path`` as a ``.npz`` artifact."""
    if isinstance(pq, IvfPq):
        index = pq
        arrays = {
            "format": np.array(_FORMAT_IVF),
            "version": np.array(_VERSION),
            "coarse_centroids": _host(index.coarse_centroids),
            "codebooks": _host(index.pq.codebooks),
            "cell_codes": _host(index.cell_codes),
            "cell_ids": _host(index.cell_ids),
            "cell_norms": _host(index.cell_norms),
        }
        if index.pq.projection is not None:
            arrays["projection"] = _host(index.pq.projection)
        # Rows dropped under on_overflow="drop", so that a reloaded index
        # still reports that it is incomplete.
        if index.dropped_ids.size:
            arrays["dropped_ids"] = np.asarray(index.dropped_ids, np.int64)
        _atomic_savez(path, arrays)
        return
    if not isinstance(pq, Pq):
        raise TypeError(f"save takes a Pq or an IvfPq, got {type(pq).__name__}")
    arrays = {
        "format": np.array(_FORMAT),
        "version": np.array(_VERSION),
        "codebooks": _host(pq.codebooks),
    }
    if pq.projection is not None:
        arrays["projection"] = _host(pq.projection)
    _atomic_savez(path, arrays)


def load(path: Union[str, os.PathLike], device=None) -> Union[Pq, IvfPq]:
    """Load an artifact written by :func:`save` (of this package or of
    ``reductive_tpu``) onto ``device``; ``None`` means ``cuda`` and raises
    where there is none.  A quantizer artifact gives a :class:`Pq` (which
    passes the constructor's validation), an IVF-PQ index artifact an
    :class:`IvfPq` with its ``dropped_ids``."""
    with np.load(os.fspath(path), allow_pickle=False) as data:
        fmt = str(data["format"]) if "format" in data else ""
        if fmt not in (_FORMAT, _FORMAT_IVF):
            raise ValueError(f"{path!r} is not a reductive-tpu quantizer artifact")
        version = int(data["version"])
        if version > _VERSION:
            raise ValueError(
                f"artifact version {version} is newer than supported {_VERSION}"
            )
        codebooks = data["codebooks"]
        projection = data["projection"] if "projection" in data.files else None
        pq = Pq.from_numpy(codebooks, projection, device=device)
        if fmt == _FORMAT:
            return pq
        dev = resolve_device(device)
        return IvfPq(
            coarse_centroids=torch.tensor(data["coarse_centroids"], device=dev),
            pq=pq,
            cell_codes=torch.tensor(data["cell_codes"], device=dev),
            cell_ids=torch.tensor(data["cell_ids"], device=dev),
            cell_norms=torch.tensor(data["cell_norms"], device=dev),
            dropped_ids=(np.asarray(data["dropped_ids"], np.int64) if "dropped_ids" in data.files
                         else np.empty(0, np.int64)),
        )
