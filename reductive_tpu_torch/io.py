"""Codebook artifact persistence.

A single ``.npz`` holding the codebooks, the optional projection, a format
tag and a version: the same keys and values as ``reductive_tpu.io`` writes,
so a file saved by either package loads in the other.
"""

from __future__ import annotations

import io as _io
import os
from typing import Union

import numpy as np

from .pq.model import Pq

__all__ = ["save", "load"]

_FORMAT = "reductive-tpu-pq"
_FORMAT_IVF = "reductive-tpu-ivfpq"
_VERSION = 1

_IVF_MSG = (
    "IVF-PQ index artifacts ('reductive-tpu-ivfpq') are not ported yet: "
    "see ROADMAP.md, 'ivf.py' under 'Modules to port'"
)


def _atomic_savez(path, arrays) -> None:
    # Write via a buffer so a crash mid-write cannot leave a torn file,
    # then atomically replace.
    buf = _io.BytesIO()
    np.savez(buf, **arrays)
    tmp = f"{os.fspath(path)}.tmp"
    with open(tmp, "wb") as f:
        f.write(buf.getvalue())
    os.replace(tmp, os.fspath(path))


def save(path: Union[str, os.PathLike], pq: Pq) -> None:
    """Write a quantizer to ``path`` as a ``.npz`` artifact."""
    if not isinstance(pq, Pq):
        raise NotImplementedError(_IVF_MSG)
    arrays = {
        "format": np.array(_FORMAT),
        "version": np.array(_VERSION),
        "codebooks": pq.codebooks.detach().cpu().numpy(),
    }
    if pq.projection is not None:
        arrays["projection"] = pq.projection.detach().cpu().numpy()
    _atomic_savez(path, arrays)


def load(path: Union[str, os.PathLike], device=None) -> Pq:
    """Load a quantizer artifact written by :func:`save` (of this package or
    of ``reductive_tpu``) onto ``device``; ``None`` means ``cuda`` and raises
    where there is none.  The restored ``Pq`` passes the constructor's
    validation.  An IVF-PQ index artifact raises ``NotImplementedError``."""
    with np.load(os.fspath(path), allow_pickle=False) as data:
        fmt = str(data["format"]) if "format" in data else ""
        if fmt not in (_FORMAT, _FORMAT_IVF):
            raise ValueError(f"{path!r} is not a reductive-tpu quantizer artifact")
        version = int(data["version"])
        if version > _VERSION:
            raise ValueError(
                f"artifact version {version} is newer than supported {_VERSION}"
            )
        if fmt == _FORMAT_IVF:
            raise NotImplementedError(_IVF_MSG)
        codebooks = data["codebooks"]
        projection = data["projection"] if "projection" in data.files else None
    return Pq.from_numpy(codebooks, projection, device=device)
