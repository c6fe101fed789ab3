"""Validation errors for quantizer training hyperparameters.

Mirrors the semantics of the reference's error enum (reference:
``src/error.rs:6-41``) and the invariant checks performed before training
(``src/pq/pq.rs:63-100``).  Unlike the reference — where these are enum
variants returned through ``Result`` — this package raises Python
exceptions, all deriving from :class:`ReductiveError` so callers can catch
the whole family.  Validation happens on the host, from shapes alone.

The package keeps its own copy of these classes (same names, same
messages as ``reductive_tpu.errors``) so that it imports without JAX.
"""

from __future__ import annotations

import math

__all__ = [
    "ReductiveError",
    "IncorrectNAttempts",
    "IncorrectNIterations",
    "IncorrectNSubquantizerBits",
    "IncorrectNumberSubquantizers",
    "NSubquantizersOutsideRange",
    "check_quantizer_invariants",
]


class ReductiveError(ValueError):
    """Base class for all quantizer-training validation errors."""


class IncorrectNAttempts(ReductiveError):
    """Raised when the number of training attempts is zero."""

    def __init__(self) -> None:
        super().__init__("The number of quantization attempts per iteration must be >= 1")


class IncorrectNIterations(ReductiveError):
    """Raised when the number of k-means iterations is zero."""

    def __init__(self) -> None:
        super().__init__("The number of quantization iterations must be >= 1")


class IncorrectNSubquantizerBits(ReductiveError):
    """Raised when the per-subquantizer bit width is out of range.

    The number of centroids per subquantizer is ``2**bits``; with fewer
    training instances than centroids some clusters could never receive a
    point, so ``bits`` must satisfy ``1 <= bits <= floor(log2(n_instances))``
    (reference: ``src/pq/pq.rs:77-82``).
    """

    def __init__(self, max_subquantizer_bits: int) -> None:
        self.max_subquantizer_bits = max_subquantizer_bits
        super().__init__(
            f"The number of subquantizer bits must be between 1 and {max_subquantizer_bits}"
        )


class IncorrectNumberSubquantizers(ReductiveError):
    """Raised when the vector length is not divisible by the subquantizer count."""

    def __init__(self, n_subquantizers: int, n_columns: int) -> None:
        self.n_subquantizers = n_subquantizers
        self.n_columns = n_columns
        super().__init__(
            f"The number of columns ({n_columns}) is not exactly dividable by "
            f"the number of subquantizers ({n_subquantizers})"
        )


class NSubquantizersOutsideRange(ReductiveError):
    """Raised when the subquantizer count is zero or exceeds the vector length."""

    def __init__(self, n_subquantizers: int, max_subquantizers: int) -> None:
        self.n_subquantizers = n_subquantizers
        self.max_subquantizers = max_subquantizers
        super().__init__(
            f"The number of subquantizers must be between 1 and {max_subquantizers}, "
            f"was {n_subquantizers}"
        )


def check_quantizer_invariants(
    n_subquantizers: int,
    n_subquantizer_bits: int,
    n_iterations: int,
    n_attempts: int,
    n_instances: int,
    n_columns: int,
) -> None:
    """Validate training hyperparameters against the dataset shape.

    Performs the same checks, in the same order, as the reference's
    ``check_quantizer_invariants`` (``src/pq/pq.rs:63-100``):

    1. ``1 <= n_subquantizers <= n_columns``
    2. ``1 <= n_subquantizer_bits <= floor(log2(n_instances))``
    3. ``n_columns % n_subquantizers == 0``
    4. ``n_iterations >= 1``
    5. ``n_attempts >= 1``
    """
    if n_subquantizers == 0 or n_subquantizers > n_columns:
        raise NSubquantizersOutsideRange(n_subquantizers, n_columns)

    max_subquantizer_bits = int(math.log2(n_instances)) if n_instances > 0 else 0
    if n_subquantizer_bits == 0 or n_subquantizer_bits > max_subquantizer_bits:
        raise IncorrectNSubquantizerBits(max_subquantizer_bits)

    if n_columns % n_subquantizers != 0:
        raise IncorrectNumberSubquantizers(n_subquantizers, n_columns)

    if n_iterations == 0:
        raise IncorrectNIterations()

    if n_attempts == 0:
        raise IncorrectNAttempts()
