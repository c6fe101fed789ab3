"""Product quantization: the model and the raw encode/decode primitives.

* :class:`~reductive_tpu_torch.pq.model.Pq`: the quantizer (codebooks +
  optional projection) with ``quantize_*`` / ``reconstruct*`` methods.
* :mod:`~reductive_tpu_torch.pq.primitives`: encode/decode against a
  codebook tensor.
"""

from . import primitives
from .model import (
    Pq,
    quantize_batch_into,
    quantize_vector_into,
    reconstruct_batch_into,
    reconstruct_into,
)

__all__ = [
    "Pq",
    "quantize_batch_into",
    "quantize_vector_into",
    "reconstruct_batch_into",
    "reconstruct_into",
    "primitives",
]
