"""reductive_tpu_torch: the PyTorch / CUDA port of ``reductive_tpu``.

The product-quantization engine on an NVIDIA Hopper GPU: train a quantizer
(k-means, PQ, OPQ, Gaussian OPQ, in memory and at corpus scale), encode
vectors to codes, decode codes back, and answer queries by ADC search over
the encoded corpus, exhaustively or through an IVF-PQ index (``ivf``).
Corpora larger than the card stay on disk: ``native.VecsReader`` reads
fvecs/bvecs/ivecs files, the streamed trainers (``train_*_streamed``) and
the streaming encode (``stream_encode``, ``stream_encode_resumable``) re-read
them batch by batch, and ``ivf`` and ``search`` take a reader in place of a
tensor.  ``conformance`` replays the reference's RNG streams.  ``parallel``
scales out over several cards, one process a card in one
``torch.distributed`` group: sharded k-means, PQ and OPQ training (in
memory and streamed from disk) and encode, and ``search.search_sharded`` /
``ivf.ivf_search_sharded`` over a sharded corpus or index;
``utils.profiling`` traces and times.  ``examples`` holds the two user
programs (``python -m reductive_tpu_torch.examples.pipeline``, ``.serving``),
the whole lifecycle end to end.  Plain tensor
code is PyTorch; the hot loops are CUDA kernels written for ``sm_90a`` under
``csrc/``, compiled at first use, each beside a plain PyTorch version of the
same function; ``native/vecio.cpp`` is compiled by ``g++`` at first use.

The package imports ``torch`` and ``numpy`` only.  Functions that take
tensors run where their tensors are; everything that creates state from
host data takes ``device=None``, and ``None`` means ``cuda``.

Top-level surface::

    from reductive_tpu_torch import (
        Pq, train_pq, train_opq, train_gaussian_opq,
        kmeans, linalg, search, io, convert, ops, errors,
        ivf, IvfPq, native, data, conformance, SyntheticReader,
        stream_encode, stream_encode_resumable, train_pq_streamed,
        train_opq_streamed, train_gaussian_opq_streamed, parallel, utils,
    )
"""

from . import (
    conformance, convert, data, errors, io, ivf, kmeans, linalg, native, ops, parallel, pq,
    search, utils,
)
from .data import SyntheticReader, stream_encode, stream_encode_resumable
from .ivf import IvfPq
from .pq import (
    GaussianOpq,
    Opq,
    Pq,
    PqTrainer,
    bucket_eigenvalues,
    create_projection_matrix,
    streamed_covariance,
    train_gaussian_opq,
    train_gaussian_opq_chunked,
    train_gaussian_opq_streamed,
    train_opq,
    train_opq_chunked,
    train_opq_streamed,
    train_pq,
    train_pq_chunked,
    train_pq_streamed,
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
    "train_pq_streamed",
    "train_opq_streamed",
    "train_gaussian_opq_streamed",
    "streamed_covariance",
    "stream_encode",
    "stream_encode_resumable",
    "SyntheticReader",
    "bucket_eigenvalues",
    "create_projection_matrix",
    "conformance",
    "convert",
    "data",
    "errors",
    "io",
    "ivf",
    "kmeans",
    "linalg",
    "native",
    "ops",
    "parallel",
    "pq",
    "search",
    "utils",
]
