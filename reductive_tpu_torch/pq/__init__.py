"""Product quantization: the model, the primitives and the trainers.

* :class:`~reductive_tpu_torch.pq.model.Pq`: the quantizer (codebooks +
  optional projection) with ``quantize_*`` / ``reconstruct*`` methods.
* :mod:`~reductive_tpu_torch.pq.primitives`: encode/decode against a
  codebook tensor.
* :func:`~reductive_tpu_torch.pq.train.train_pq` and
  :func:`~reductive_tpu_torch.pq.train.train_pq_chunked`: plain PQ training,
  in memory and at corpus scale.
* :func:`~reductive_tpu_torch.pq.opq.train_opq`,
  :func:`~reductive_tpu_torch.pq.opq.train_gaussian_opq` and their chunked
  forms: PQ with a learned or closed-form rotation.
* :func:`~reductive_tpu_torch.pq.streamed.train_pq_streamed`,
  :func:`~reductive_tpu_torch.pq.streamed.train_opq_streamed`,
  :func:`~reductive_tpu_torch.pq.streamed.train_gaussian_opq_streamed` and
  :func:`~reductive_tpu_torch.pq.streamed.streamed_covariance`: the same
  trainers over a corpus on disk, re-read through a reader every pass.
* :class:`~reductive_tpu_torch.pq.traits.PqTrainer`, ``Opq``,
  ``GaussianOpq``: the reference's trait-style surface.
"""

from . import primitives
from .model import (
    Pq,
    quantize_batch_into,
    quantize_vector_into,
    reconstruct_batch_into,
    reconstruct_into,
)
from .opq import (
    bucket_eigenvalues,
    create_projection_matrix,
    train_gaussian_opq,
    train_gaussian_opq_chunked,
    train_opq,
    train_opq_chunked,
)
from .streamed import (
    streamed_covariance,
    train_gaussian_opq_streamed,
    train_opq_streamed,
    train_pq_streamed,
)
from .train import train_pq, train_pq_chunked
from .traits import GaussianOpq, Opq, PqTrainer, entropy_generator

__all__ = [
    "Pq",
    "quantize_batch_into",
    "quantize_vector_into",
    "reconstruct_batch_into",
    "reconstruct_into",
    "PqTrainer",
    "Opq",
    "GaussianOpq",
    "entropy_generator",
    "primitives",
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
    "bucket_eigenvalues",
    "create_projection_matrix",
]
