"""reductive_tpu_torch: the PyTorch / CUDA port of ``reductive_tpu``.

The product-quantization engine on an NVIDIA Hopper GPU: train a quantizer
(k-means, PQ, OPQ, Gaussian OPQ, in memory and at corpus scale), encode
vectors to codes, decode codes back, and answer queries by ADC search over
the encoded corpus, exhaustively or through an IVF-PQ index (``ivf``).  Plain tensor code is PyTorch; the hot loops are CUDA
kernels written for ``sm_90a`` under ``csrc/``, compiled at first use, each
beside a plain PyTorch version of the same function.

The package imports ``torch`` and ``numpy`` only.  Functions that take
tensors run where their tensors are; everything that creates state from
host data takes ``device=None``, and ``None`` means ``cuda``.

Top-level surface::

    from reductive_tpu_torch import (
        Pq, train_pq, train_opq, train_gaussian_opq,
        kmeans, linalg, search, io, convert, ops, errors,
        ivf, IvfPq,
    )
"""

from . import convert, errors, io, ivf, kmeans, linalg, ops, pq, search
from .ivf import IvfPq
from .pq import (
    GaussianOpq,
    Opq,
    Pq,
    PqTrainer,
    bucket_eigenvalues,
    create_projection_matrix,
    train_gaussian_opq,
    train_gaussian_opq_chunked,
    train_opq,
    train_opq_chunked,
    train_pq,
    train_pq_chunked,
)

__version__ = "0.9.0"

__all__ = [
    "Pq",
    "IvfPq",
    "PqTrainer",
    "Opq",
    "GaussianOpq",
    "train_pq",
    "train_pq_chunked",
    "train_opq",
    "train_opq_chunked",
    "train_gaussian_opq",
    "train_gaussian_opq_chunked",
    "bucket_eigenvalues",
    "create_projection_matrix",
    "convert",
    "errors",
    "io",
    "ivf",
    "kmeans",
    "linalg",
    "ops",
    "pq",
    "search",
]
