"""The collectives of the sharded entries, over a ``torch.distributed``
process group: NCCL between cards, gloo on the CPU (gloo takes CUDA tensors
too).  ``group=None`` is the single-process case: every function returns its
input, so that one code path serves the single-process trainers and their
sharded forms.  The counterparts of XLA's ``psum`` and ``all_gather``."""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.distributed as dist
from torch import Tensor

__all__ = ["group_size", "all_reduce", "all_gather_rows", "broadcast_first"]


def group_size(group: Optional[dist.ProcessGroup]) -> int:
    return 1 if group is None else dist.get_world_size(group)


def all_reduce(group: Optional[dist.ProcessGroup], *tensors: Tensor) -> Tuple[Tensor, ...]:
    """Each tensor summed over the ranks of ``group``, by one collective
    over their concatenation (they share a dtype): the same result on every
    rank.  Returns new tensors; the inputs are left as they were."""
    if group is None:
        return tensors
    flat = torch.cat([t.reshape(-1) for t in tensors])
    dist.all_reduce(flat, group=group)
    out, at = [], 0
    for t in tensors:
        out.append(flat[at:at + t.numel()].view(t.shape))
        at += t.numel()
    return tuple(out)


def all_gather_rows(group: Optional[dist.ProcessGroup], t: Tensor) -> Tensor:
    """Every rank's ``t`` (the same shape on each) stacked along a new first
    axis in rank order: ``(size, *t.shape)``.  Any dtype (``t`` of at least
    one axis): the bytes are gathered, so code dtypes that a backend does
    not reduce, such as ``uint16``, travel as they are."""
    if group is None:
        return t[None]
    t = t.contiguous()
    raw = t.view(torch.uint8)
    parts = [torch.empty_like(raw) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, raw, group=group)
    return torch.stack(parts).view(t.dtype).view((len(parts), *t.shape))


def broadcast_first(group: Optional[dist.ProcessGroup], t: Tensor) -> Tensor:
    """``t`` as the group's first rank holds it, on every rank (in place):
    for results that each rank computes itself but that must not differ by
    a bit, such as an eigendecomposition or an SVD."""
    if group is not None:
        dist.broadcast(t, src=dist.get_global_rank(group, 0), group=group)
    return t
