"""Quantization primitives: encode and reconstruct against a codebook tensor.

The exact float32 paths of the library, in plain tensor code (counterpart of
``reductive_tpu.pq.primitives``).  Codebooks are ``(m, k, ds)`` =
(subquantizers, centroids per subquantizer, subvector length).  The
hand-written kernels live in :mod:`reductive_tpu_torch.ops`.
"""

from __future__ import annotations

import torch
from torch import Tensor

from .._precision import check_precision

__all__ = [
    "reconstructed_len",
    "check_code_dtype",
    "quantize_batch",
    "quantize",
    "reconstruct_batch",
    "reconstruct",
]

# quantize_batch walks the rows in chunks so that the (rows, m, k) distance
# tensor stays below this many elements (256 MB of float32), of about a
# sixteenth of the batch but at least this many rows: a verified wrapper pads
# the few rows it codes again to one chunk of its batch, so the chunk follows
# the batch's size rather than only the bound.
_DIST_ELEMS = 1 << 26
_MIN_CHUNK_ROWS = 2048


def reconstructed_len(codebooks: Tensor) -> int:
    """Length of a reconstructed vector: ``m * ds``."""
    return codebooks.shape[0] * codebooks.shape[2]


def check_code_dtype(codebooks: Tensor, dtype: torch.dtype) -> None:
    """Reject code dtypes too narrow to hold ``k - 1``: ``TypeError`` for a
    dtype that is not an integer type, ``OverflowError`` when ``k - 1``
    exceeds its maximum."""
    name = str(dtype).removeprefix("torch.")
    if not isinstance(dtype, torch.dtype) or dtype.is_floating_point or dtype.is_complex \
            or dtype == torch.bool:
        raise TypeError(f"Quantized code dtype must be an integer type, got {name}")
    k = codebooks.shape[1]
    if k - 1 > torch.iinfo(dtype).max:
        raise OverflowError(
            f"Cannot store centroids in quantizer index type: k={k} exceeds {name}"
        )


def nearest_centroids(cb2: Tensor, c_sqn: Tensor, xs: Tensor, batch: int | None = None) -> Tensor:
    """``argmin_c (c_sqn[j, c] - cb2[j, c] . xs[i, j])`` as int64 ``(n, m)``,
    the first index on ties (``torch.argmin`` returns the first minimum).
    ``cb2`` holds the doubled centroids ``2c``, ``xs`` is ``(n, m, ds)``.

    Rows are taken in chunks of ``min(batch, s, max(2048, batch / 16))``
    rows, ``s`` the rows whose distance tensor stays within ``_DIST_ELEMS``,
    a shorter last chunk padded with zeros: every row's products are taken in
    a product of that one shape.  A product's rounding may depend on its shape (on the card the
    library chooses its algorithm by it, and near-ties at a wide ``ds`` then
    fall either way), so ``batch`` (default ``n``) lets a subset of a batch's
    rows be coded exactly as the whole batch codes them."""
    n, m, ds = xs.shape
    k = cb2.shape[1]
    batch = n if batch is None else batch
    rows = max(1, min(batch, _DIST_ELEMS // (m * k), max(_MIN_CHUNK_ROWS, -(-batch // 16))))
    out = torch.empty((n, m), dtype=torch.int64, device=xs.device)
    for i in range(0, n, rows):
        xc = xs[i:i + rows]
        if xc.shape[0] < rows:
            xc = torch.cat([xc, xc.new_zeros((rows - xc.shape[0], m, ds))])
        cross2 = torch.einsum("nmd,mkd->nmk", xc, cb2)
        out[i:i + rows] = torch.argmin(c_sqn[None] - cross2, dim=2)[:min(rows, n - i)]
    return out


def quantize_batch(
    codebooks: Tensor, x: Tensor, dtype: torch.dtype = torch.uint8, *, precision="highest",
    batch: int | None = None,
) -> Tensor:
    """Encode ``(n, m * ds)`` vectors to ``(n, m)`` centroid indices of
    ``dtype``, in float32 (``allow_tf32`` stays off).  Argmin ties break to
    the first index.

    ``|x|^2`` does not affect the argmin, so the distance is
    ``|c|^2 - (c.x + c.x)``; doubling the centroids before the product gives
    the same bits (a scaling by two is exact).  ``batch``: code these rows as
    a batch of that many rows codes them (see :func:`nearest_centroids`); the
    verified wrappers pass their batch's size when they code its flagged rows.
    ``precision`` takes ``"highest"`` only (the JAX package's keyword).
    """
    check_precision(precision)
    check_code_dtype(codebooks, dtype)
    m, k, ds = codebooks.shape
    if x.ndim != 2 or x.shape[1] != m * ds:
        raise ValueError(
            f"Quantizer and vector length mismatch: input has {x.shape[-1]} columns, "
            f"quantizer reconstructs {m * ds}"
        )
    c_sqn = torch.einsum("mkd,mkd->mk", codebooks, codebooks)
    xs = x.reshape(x.shape[0], m, ds)
    return nearest_centroids(codebooks + codebooks, c_sqn, xs, batch).to(dtype)


def quantize(
    codebooks: Tensor, x: Tensor, dtype: torch.dtype = torch.uint8, *, precision="highest"
) -> Tensor:
    """Encode a single vector."""
    if x.ndim != 1:
        raise ValueError(f"quantize expects a rank-1 vector, got rank {x.ndim}")
    return quantize_batch(codebooks, x[None, :], dtype=dtype, precision=precision)[0]


def reconstruct_batch(codebooks: Tensor, codes: Tensor, *, method: str = "auto") -> Tensor:
    """Decode ``(n, m)`` code rows to ``(n, m * ds)`` vectors.

    Two bit-identical implementations: ``"gather"`` indexes the codebook,
    ``"onehot"`` multiplies a one-hot matrix with it (each output element
    receives one nonzero product, so float32 reproduces the entry exactly).
    ``"auto"`` is the gather: a GPU gathers well, so the reason the JAX
    package prefers the one-hot form on its device does not carry over.
    """
    m, k, ds = codebooks.shape
    if codes.ndim != 2 or codes.shape[1] != m:
        raise ValueError(
            f"Quantization length does not match number of subquantizers: "
            f"{tuple(codes.shape)} vs m={m}"
        )
    if method == "auto":
        method = "gather"
    idx = codes.to(torch.int64)
    if method == "onehot":
        onehot = torch.nn.functional.one_hot(idx, k).to(codebooks.dtype)  # (n, m, k)
        out = torch.einsum("nmk,mkd->nmd", onehot, codebooks)
        return out.reshape(codes.shape[0], m * ds)
    if method == "gather":
        sub = torch.arange(m, device=codebooks.device)
        return codebooks[sub[None, :], idx].reshape(codes.shape[0], m * ds)
    raise ValueError(f"unknown reconstruct method {method!r}")


def reconstruct(codebooks: Tensor, code: Tensor) -> Tensor:
    """Decode a single code row."""
    if code.ndim != 1:
        raise ValueError(f"reconstruct expects a rank-1 code vector, got rank {code.ndim}")
    return reconstruct_batch(codebooks, code[None, :])[0]
