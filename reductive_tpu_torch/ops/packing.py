"""4-bit code packing on tensors.

4-bit codes (``k <= 16``) halve the code matrix: two codes a byte.  The byte
layout is that of the reference's host-side ``pack_u4``: the even-index code
in the low nibble, the odd-index code in the high nibble, so packed codes
are plain ``uint8`` arrays that cross between the two packages and to the
native artifact format as they are.  Counterpart of
``reductive_tpu.ops.packing``.

These are elementwise tensor operations; the decode and ADC kernels read the
*packed* matrix directly and take the nibbles apart themselves
(``packed=True`` of :func:`reductive_tpu_torch.ops.decode.pq_decode` and
:func:`reductive_tpu_torch.ops.adc.adc_scores_kernel`).
"""

from __future__ import annotations

import torch
from torch import Tensor

__all__ = ["pack_u4_codes", "unpack_u4_codes", "check_packed"]


def pack_u4_codes(codes: Tensor) -> Tensor:
    """Pack an ``(n, m)`` code matrix (values < 16, ``m`` even) into
    ``(n, m/2)`` bytes: code ``2j`` in the low nibble, ``2j+1`` in the high
    nibble of byte ``j``."""
    _, m = codes.shape
    if m % 2 != 0:
        raise ValueError(f"packed u4 codes require even m, got {m}")
    c = codes.to(torch.uint8)
    return c[:, 0::2] | (c[:, 1::2] << 4)


def unpack_u4_codes(packed: Tensor) -> Tensor:
    """Inverse of :func:`pack_u4_codes`: ``(n, m/2)`` bytes back to the
    ``(n, m)`` code matrix (``uint8``)."""
    p = packed.to(torch.uint8)
    return torch.stack([p & 0xF, p >> 4], dim=2).reshape(p.shape[0], -1)


def check_packed(m: int, k: int, codes: Tensor) -> None:
    """The conditions a packed code matrix must meet against ``m``
    subquantizers of ``k`` centroids, with the reference's messages."""
    if m % 2 != 0:
        raise ValueError(f"packed u4 codes require even m, got {m}")
    if k > 16:
        raise ValueError(f"packed u4 codes require k <= 16, got {k}")
    if codes.ndim != 2 or codes.shape[1] != m // 2:
        raise ValueError(
            f"packed codes have shape {tuple(codes.shape)}, expected (n, {m // 2})"
        )
