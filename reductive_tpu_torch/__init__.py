"""reductive_tpu_torch: the PyTorch / CUDA port of ``reductive_tpu``.

The serving path of the product-quantization engine on an NVIDIA Hopper
GPU: encode vectors to codes, decode codes back, and answer queries by ADC
search over the encoded corpus.  Plain tensor code is PyTorch; the hot loops
are CUDA kernels written for ``sm_90a`` under ``csrc/``, compiled at first
use, each beside a plain PyTorch version of the same function.

The package imports ``torch`` and ``numpy`` only.  Functions that take
tensors run where their tensors are; everything that creates state takes
``device=None``, and ``None`` means ``cuda``.

Top-level surface::

    from reductive_tpu_torch import Pq, search, io, convert, ops, errors
"""

from . import convert, errors, io, ops, pq, search
from .pq import Pq

__version__ = "0.9.0"

__all__ = ["Pq", "convert", "errors", "io", "ops", "pq", "search"]
