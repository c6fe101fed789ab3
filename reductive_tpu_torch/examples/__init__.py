"""The port's two user programs, the counterparts of the JAX package's
``examples/``:

* :mod:`.pipeline`: train -> persist -> stream-encode -> search, with the
  IVF, on-disk and virtual-corpus lifecycles as options;
* :mod:`.serving`: an IVF-PQ index serving L2 and MIPS queries with an exact
  refine, updated in place, and the exhaustive scan sharded over the ranks
  of a process group.

Run on the card (``--device cpu`` runs them on the CPU, through the kernels'
plain versions)::

    python -m reductive_tpu_torch.examples.pipeline --n 200000 --ivf 256 --disk
    python -m reductive_tpu_torch.examples.serving --n 100000 --cells 256
    torchrun --nproc-per-node=8 -m reductive_tpu_torch.examples.serving

Each numbered step is a function on tensors; ``main(argv)`` chains them,
prints what the JAX programs print and returns every number it printed.
"""

from __future__ import annotations

import time

import torch

__all__ = ["clock", "device_name"]


def clock(dev: torch.device) -> float:
    """``time.perf_counter()`` once the work queued on ``dev`` is done."""
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    return time.perf_counter()


def device_name(dev: torch.device) -> str:
    """The card's name (``torch.cuda.get_device_name``), or ``"cpu"``."""
    return torch.cuda.get_device_name(dev) if dev.type == "cuda" else dev.type
