"""The ``precision=`` keyword the JAX package's entry points take.

There it picks the passes of a TPU matrix product.  Here every product is
float32 (``torch.backends.cuda.matmul.allow_tf32`` stays ``False``), which is
what ``"highest"`` asks for, so that is the one value taken: a call written
for the JAX package runs unchanged, and a request for less precision is
refused rather than served at full precision.
"""

from __future__ import annotations

__all__ = ["check_precision"]


def check_precision(precision) -> None:
    """Accept ``"highest"``; raise ``ValueError`` naming any other value."""
    if not (isinstance(precision, str) and precision == "highest"):
        raise ValueError(
            f"precision={precision!r} is not supported: this package computes these "
            'products in float32 only, which is precision="highest"'
        )
