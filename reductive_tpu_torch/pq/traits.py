"""Trait-style training surface mirroring the reference's ``TrainPq``.

Counterpart of ``reductive_tpu.pq.traits``: ``train_pq(...)`` seeds a
generator **from entropy** while ``train_pq_using(..., generator)`` takes
the caller's; ``Opq`` and ``GaussianOpq`` are train-only marker types that
produce a ``Pq``::

    from reductive_tpu_torch.pq import Opq, PqTrainer, GaussianOpq

    pq = PqTrainer.train_pq(10, 7, 10, 1, instances)              # entropy seed
    pq = Opq.train_pq_using(10, 7, 10, 1, instances, generator)   # explicit generator
    pq = GaussianOpq.train_pq(10, 7, 10, 1, instances)

The argument order is the reference's:
``(n_subquantizers, n_subquantizer_bits, n_iterations, n_attempts,
instances[, generator])``.  ``instances`` is a tensor, and training runs
where it lies; the generator must live on the same device.
"""

from __future__ import annotations

import os

import torch
from torch import Tensor

from .model import Pq
from .opq import train_gaussian_opq, train_opq
from .train import train_pq

__all__ = ["PqTrainer", "Opq", "GaussianOpq", "entropy_generator"]


def entropy_generator(device) -> torch.Generator:
    """A generator on ``device`` seeded from OS entropy (the counterpart of
    ``reductive_tpu.pq.traits.entropy_key``)."""
    generator = torch.Generator(device=device)
    generator.manual_seed(int.from_bytes(os.urandom(8), "little") >> 1)
    return generator


def _trait(train_fn):
    class _Trainer:
        @staticmethod
        def train_pq(
            n_subquantizers: int,
            n_subquantizer_bits: int,
            n_iterations: int,
            n_attempts: int,
            instances: Tensor,
        ) -> Pq:
            """Entropy-seeded training."""
            return train_fn(
                entropy_generator(instances.device), instances, n_subquantizers,
                n_subquantizer_bits, n_iterations, n_attempts,
            )

        @staticmethod
        def train_pq_using(
            n_subquantizers: int,
            n_subquantizer_bits: int,
            n_iterations: int,
            n_attempts: int,
            instances: Tensor,
            generator: torch.Generator,
        ) -> Pq:
            """Training with a caller-supplied generator."""
            return train_fn(
                generator, instances, n_subquantizers,
                n_subquantizer_bits, n_iterations, n_attempts,
            )

    return _Trainer


class PqTrainer(_trait(train_pq)):
    """``TrainPq for Pq``."""


class Opq(_trait(train_opq)):
    """Train-only marker type for non-parametric OPQ; ``n_attempts`` is
    ignored as in the reference."""


class GaussianOpq(_trait(train_gaussian_opq)):
    """Train-only marker type for closed-form OPQ."""
