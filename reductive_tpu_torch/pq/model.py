"""The product-quantizer model: codebooks and an optional projection.

Counterpart of ``reductive_tpu.pq.model``.  The model state is exactly an
``(m, k, ds)`` codebook tensor and an optional orthonormal ``(d, d)``
projection applied before slicing:

* ``quantize_batch``: optionally project by ``R``, then encode.
* ``reconstruct_batch``: decode, then optionally project back by ``R^T``.

All matrix products are float32 (``torch.backends.cuda.matmul.allow_tf32``
stays ``False``; the package never turns it on).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch
from torch import Tensor

from .._device import resolve_device
from .._precision import check_precision
from . import primitives

__all__ = [
    "Pq", "quantize_batch_into", "reconstruct_batch_into",
    "quantize_vector_into", "reconstruct_into",
]

_ENCODE_KERNEL_DTYPES = {"kernel": torch.bfloat16, "kernel-f32": torch.float32}
_DECODE_KERNEL_SPLITS = {"kernel": 3, "kernel-fast": 1, "kernel-int8": "int8"}


@dataclasses.dataclass
class Pq:
    """Product quantizer (Jégou et al., 2011): ``m`` subquantizers of ``k``
    centroids each over ``ds``-dimensional subvectors, with an optional
    learned orthonormal projection applied before slicing.

    A dataclass of two tensors, not an ``nn.Module``: the model has nothing
    that autograd trains and no submodules, every function of the package
    takes the tensors themselves, and a dataclass mirrors the JAX package's
    registered dataclass field for field.
    """

    codebooks: Tensor
    projection: Optional[Tensor] = None

    def __post_init__(self) -> None:
        if self.codebooks.ndim != 3:
            raise ValueError(
                f"codebooks must have shape (m, k, ds), got {tuple(self.codebooks.shape)}"
            )
        if self.codebooks.numel() == 0:
            raise ValueError("Attempted to construct a product quantizer without quantizers.")
        d = primitives.reconstructed_len(self.codebooks)
        if self.projection is not None:
            if tuple(self.projection.shape) != (d, d):
                raise ValueError(
                    f"Incorrect projection matrix shape, was: {tuple(self.projection.shape)}, "
                    f"should be [{d}, {d}]"
                )
            if self.projection.device != self.codebooks.device:
                raise ValueError(
                    f"codebooks on {self.codebooks.device}, projection on {self.projection.device}"
                )

    @classmethod
    def from_numpy(cls, codebooks: np.ndarray, projection: Optional[np.ndarray] = None,
                   device=None) -> "Pq":
        """Build a quantizer from host arrays on ``device`` (``None`` means
        ``cuda``, and raises where there is none)."""
        dev = resolve_device(device)
        return cls(
            codebooks=torch.tensor(np.asarray(codebooks), device=dev),
            projection=None if projection is None
            else torch.tensor(np.asarray(projection), device=dev),
        )

    # -- shape accessors

    @property
    def n_subquantizers(self) -> int:
        return self.codebooks.shape[0]

    @property
    def n_quantizer_centroids(self) -> int:
        """Number of centroids per subquantizer (``k``)."""
        return self.codebooks.shape[1]

    @property
    def quantized_len(self) -> int:
        """Length of a quantized vector: one code per subquantizer."""
        return self.codebooks.shape[0]

    @property
    def reconstructed_len(self) -> int:
        """Length of a reconstructed vector (``m * ds``)."""
        return primitives.reconstructed_len(self.codebooks)

    @property
    def subquantizers(self) -> Tensor:
        """The ``(m, k, ds)`` codebook tensor."""
        return self.codebooks

    # -- encode

    def quantize_batch(
        self, x: Tensor, dtype: torch.dtype = torch.uint8, *, precision="highest",
        method: str = "exact", out: Optional[Tensor] = None,
    ) -> Tensor:
        """Encode ``(n, d)`` vectors to ``(n, m)`` codes of ``dtype``.

        ``method="exact"`` (default) is the f32 einsum path;
        ``method="kernel"`` is the fused encode
        (:func:`reductive_tpu_torch.ops.assign.pq_encode`) with bfloat16
        products, which flips a small share of near-tie codes;
        ``method="kernel-f32"`` is the same kernel at fp32 accuracy (a 3xTF32
        split product on the tensor cores, the assignment the f32 training
        kernel makes too), which flips fewer still.  ``out`` receives the codes
        where given.  ``precision`` takes ``"highest"`` only (the JAX
        package's keyword; :mod:`reductive_tpu_torch._precision`).
        """
        check_precision(precision)
        if self.projection is not None:
            x = torch.matmul(x, self.projection)
        if method in _ENCODE_KERNEL_DTYPES:
            from ..ops.assign import pq_encode

            return pq_encode(
                self.codebooks, x, dtype=dtype,
                compute_dtype=_ENCODE_KERNEL_DTYPES[method], out=out,
            )
        if method != "exact":
            raise ValueError(f"unknown quantize method {method!r}")
        codes = primitives.quantize_batch(self.codebooks, x, dtype=dtype, precision=precision)
        return codes if out is None else out.copy_(codes)

    def quantize_vector(
        self, x: Tensor, dtype: torch.dtype = torch.uint8, *, precision="highest"
    ) -> Tensor:
        """Encode a single ``(d,)`` vector to ``(m,)`` codes."""
        check_precision(precision)
        if self.projection is not None:
            x = torch.matmul(x, self.projection)
        return primitives.quantize(self.codebooks, x, dtype=dtype, precision=precision)

    # -- decode

    def reconstruct_batch(
        self, codes: Tensor, *, precision="highest", method: str = "auto",
        out: Optional[Tensor] = None,
    ) -> Tensor:
        """Decode ``(n, m)`` codes to approximate ``(n, d)`` vectors.

        ``method`` is ``auto`` / ``onehot`` / ``gather`` (plain tensor code,
        all bit-identical) or one of the fused-kernel routes: ``"kernel"``
        (bit-exact), ``"kernel-fast"`` (codebook rounded to bfloat16) and
        ``"kernel-int8"`` (weight-only int8).  ``out`` receives the result
        where given.  ``precision`` takes ``"highest"`` only.
        """
        check_precision(precision)
        if method in _DECODE_KERNEL_SPLITS:
            from ..ops.decode import pq_decode

            direct = out if self.projection is None else None
            rec = pq_decode(self.codebooks, codes, splits=_DECODE_KERNEL_SPLITS[method], out=direct)
        else:
            rec = primitives.reconstruct_batch(self.codebooks, codes, method=method)
        if self.projection is not None:
            if out is not None:
                return torch.matmul(rec, self.projection.T, out=out)
            return torch.matmul(rec, self.projection.T)
        if out is None or rec is out:
            return rec
        return out.copy_(rec)

    def reconstruct(self, code: Tensor, *, precision="highest") -> Tensor:
        """Decode a single ``(m,)`` code row to a ``(d,)`` vector."""
        check_precision(precision)
        rec = primitives.reconstruct(self.codebooks, code)
        if self.projection is not None:
            rec = torch.matmul(rec, self.projection.T)
        return rec


def _on_device(pq: Pq, device: torch.device) -> Pq:
    """``pq`` with its tensors on ``device`` (the same tensors where they lie
    there already)."""
    return Pq(codebooks=pq.codebooks.to(device),
              projection=None if pq.projection is None else pq.projection.to(device))


# ---------------------------------------------------------------------------
# Preallocated-output serving entries.  A serving loop reuses one output
# buffer instead of allocating per call.  The JAX package gets that by
# donating ``out`` to the jitted program; here ``out`` is simply written
# into (the kernels write straight into it where dtype and layout allow)
# and returned, and stays valid for the caller.
# ---------------------------------------------------------------------------


def _check_out(out: Tensor, shape: tuple) -> None:
    if tuple(out.shape) != shape:
        raise ValueError(f"out has shape {tuple(out.shape)}, expected {shape}")


def quantize_batch_into(pq: Pq, x: Tensor, out: Tensor, *, method: str = "exact") -> Tensor:
    """Encode ``(n, d)`` vectors into ``out``, an ``(n, m)`` tensor of the
    desired code dtype on the same device.  Returns ``out``.  Takes the
    place of buffer donation in the JAX package."""
    _check_out(out, (x.shape[0], pq.quantized_len))
    return pq.quantize_batch(x, dtype=out.dtype, method=method, out=out)


def reconstruct_batch_into(pq: Pq, codes: Tensor, out: Tensor, *, method: str = "auto") -> Tensor:
    """Decode ``(n, m)`` codes into ``out``, an ``(n, d)`` f32 tensor on the
    same device.  Returns ``out``.  Takes the place of buffer donation in
    the JAX package."""
    _check_out(out, (codes.shape[0], pq.reconstructed_len))
    return pq.reconstruct_batch(codes, method=method, out=out)


def quantize_vector_into(pq: Pq, x: Tensor, out: Tensor) -> Tensor:
    """Encode ONE ``(d,)`` vector into ``out``, an ``(m,)`` tensor of the
    desired code dtype.  Returns ``out``."""
    _check_out(out, (pq.quantized_len,))
    return out.copy_(pq.quantize_vector(x, dtype=out.dtype))


def reconstruct_into(pq: Pq, code: Tensor, out: Tensor) -> Tensor:
    """Decode ONE ``(m,)`` code row into ``out``, a ``(d,)`` f32 tensor.
    Returns ``out``."""
    _check_out(out, (pq.reconstructed_len,))
    return out.copy_(pq.reconstruct(code))
