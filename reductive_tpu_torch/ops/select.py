"""Exact selection of the ``k`` smallest entries of long f32 rows: a CUDA
kernel and its plain version.

The order is :func:`reductive_tpu_torch.search._smallest`'s, the JAX
package's ``top_k`` rule: ascending by score and, among equal scores, by
position (``-0.0`` ties with ``+0.0``; NaN ranks above ``+inf``).  With a
prior ``(vals, ids)`` list the result is the ``k`` smallest of the prior
entries and the row's, ranked by (score, id) with the row's ids ``offset +
column``: the streamed search's merge of its best-so-far with a chunk, in the
same launches.  The kernel (``csrc/select.cu``) reads the scores once: each
``(row, slice)`` block keeps its ``kp`` best keys (``kp`` the power of two at
or above ``k``), then one block a row merges the slices' lists and the prior
one.  :func:`select_plan` chooses the slices from the shapes.
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Optional, Tuple

import torch
from torch import Tensor

from ..utils.profiling import span
from . import _build

__all__ = ["MAX_K", "SelectPlan", "select_plan", "select_smallest_kernel",
           "select_smallest_reference"]

# The largest k the kernel takes, and its limit on ids: the all-ones key marks
# an empty slot, so ids (offset + column) stay below 2^32 - 1.
MAX_K = 1024
ID_LIMIT = (1 << 32) - 1
_THREADS = 256
_RESIDENT = 4       # pass-1 blocks an SM holds (csrc/select.cu's launch bounds)
_MIN_SLICE = 4096   # columns a slice, at least
_MAX_SLICES = 64    # pass 2 merges a row's slices one after another
_BUF_KEYS = 2048    # pass 1's candidate buffer, 8-byte keys
_RING_BYTES = 4 * _THREADS * 16  # pass 1's copies in flight: four iterations of 16 bytes a thread
# The plain version finds the ties at the k-th place block by block.
_TIE_BLOCK = 256


class SelectPlan(NamedTuple):
    """A launch of both passes: ``slices`` blocks of ``_THREADS`` a row in
    pass 1, one a row in pass 2; lists of ``kp`` keys; shared memory of each
    pass in bytes."""
    slices: int
    kp: int
    pass_smem: int
    merge_smem: int


def _pow2_at_least(x: int) -> int:
    return 1 << max(0, (x - 1).bit_length())


def select_plan(nq: int, n: int, k: int, sms: int = 132) -> SelectPlan:
    """The kernel's plan for ``nq`` rows of ``n`` columns at ``k``: as many
    slices as one wave of ``_RESIDENT`` blocks on each of ``sms`` SMs holds,
    at most ``_MAX_SLICES`` and at least ``_MIN_SLICE`` columns each.  Every
    block of a wave streams at the same rate; more slices add the candidates
    each block takes before its threshold is tight, and a tail (``PERF.md``
    has the sweep on an H100)."""
    if not 1 <= k <= MAX_K:
        raise ValueError(f"k must be in [1, {MAX_K}], got {k}")
    kp = _pow2_at_least(k)
    slices = max(1, min(_RESIDENT * sms // max(nq, 1), _MAX_SLICES, n // _MIN_SLICE))
    return SelectPlan(slices=slices, kp=kp, pass_smem=_RING_BYTES + (_BUF_KEYS + kp) * 8,
                      merge_smem=kp * 2 * 12)


@functools.lru_cache(maxsize=None)
def _sms(device: torch.device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


def _check(scores: Tensor, k: int, prior, offset: int) -> None:
    if scores.ndim != 2 or scores.dtype != torch.float32:
        raise ValueError(f"scores must be (nq, n) float32, got {tuple(scores.shape)} {scores.dtype}")
    nq, n = scores.shape
    if not 1 <= k <= MAX_K:
        raise ValueError(f"k must be in [1, {MAX_K}], got {k}")
    if offset < 0 or offset + n > ID_LIMIT:
        raise ValueError(f"ids offset + column must lie in [0, 2^32 - 1): offset {offset}, n {n}")
    if k > n:
        raise ValueError(f"k={k} exceeds the row length {n}")
    if prior is None:
        return
    vals, ids = prior
    if vals.shape != (nq, k) or ids.shape != (nq, k):
        raise ValueError(f"the prior list must be ({nq}, {k}), got {tuple(vals.shape)}, "
                         f"{tuple(ids.shape)}")
    if vals.dtype != torch.float32 or ids.dtype != torch.int64:
        raise ValueError(f"the prior list must be float32 and int64, got {vals.dtype}, {ids.dtype}")
    if vals.device != scores.device or ids.device != scores.device:
        raise ValueError("the prior list is on another device than the scores")


def select_smallest_reference(
    scores: Tensor, k: int, *, prior: Optional[Tuple[Tensor, Tensor]] = None, offset: int = 0,
) -> Tuple[Tensor, Tensor]:
    """Plain PyTorch version of :func:`select_smallest_kernel`:
    :func:`_smallest_long` of the row (``torch.topk`` and the tie repair),
    ids ``offset + position``, then, with a prior list, the stable sort of
    the prior and the row's result concatenated in that order."""
    _check(scores, k, prior, offset)
    vals, pos = _smallest_long(scores, k)
    ids = pos + offset
    if prior is None:
        return vals, ids
    vals, order = torch.sort(torch.cat([prior[0], vals], dim=1), dim=1, stable=True)
    return vals[:, :k], torch.gather(torch.cat([prior[1], ids], dim=1), 1, order[:, :k])


def _smallest_long(scores: Tensor, k: int) -> Tuple[Tensor, Tensor]:
    """``search._smallest`` of long rows off the kernel's route.
    ``torch.topk`` gives the k-th smallest score ``thr`` and every score
    below it; which of the scores equal to ``thr`` it keeps is its own
    choice.  The ``need`` of them that
    belong to the result are the first ones by position.  They lie in the
    first ``need`` blocks of ``_TIE_BLOCK`` columns that hold a tie, so among
    the first ``2k - 1`` blocks whose minimum is at most ``thr`` (at most
    ``k - 1`` more hold a score below it): those blocks are gathered and a
    running count over their ties keeps the first ``need``.  One pass over
    the scores (the blocks' minima) besides ``torch.topk``.  A block whose
    minimum is NaN is gathered too; a row where fewer than ``k`` are found
    (NaN blocks in the way, or a NaN ``thr``) keeps ``torch.topk``'s
    choice."""
    nq, n = scores.shape
    dev = scores.device
    b = _TIE_BLOCK
    vals, sel = torch.topk(scores, k, dim=1, largest=False)
    thr = vals[:, k - 1:]
    below = vals < thr
    need = k - below.sum(dim=1, keepdim=True)
    with span("select.repair"):
        main = n // b * b
        low = scores[:, :main].view(nq, main // b, b).amin(dim=2)
        if main < n:
            low = torch.cat([low, scores[:, main:].amin(dim=1, keepdim=True)], dim=1)
        nb = low.shape[1]
        blocks = torch.arange(nb, device=dev).masked_fill(low > thr, nb)
        first = torch.topk(blocks, min(2 * k - 1, nb), dim=1, largest=False).values
        # Positions of those blocks' columns; a missing block (nb) lies past n.
        at = (first[:, :, None] * b + torch.arange(b, device=dev)).reshape(nq, -1)
        tied = (torch.gather(scores, 1, at.clamp(max=n - 1)) == thr) & (at < n)
        take = tied & (torch.cumsum(tied, dim=1, dtype=torch.int32) <= need)
        keys = torch.cat([sel.masked_fill(~below, n), at.masked_fill(~take, n)], dim=1)
        pos = torch.topk(keys, k, dim=1, largest=False).values  # the k kept, by position
        pos = torch.where((pos < n).all(dim=1, keepdim=True), pos, torch.sort(sel, dim=1).values)
        vals, order = torch.sort(torch.gather(scores, 1, pos), dim=1, stable=True)
        return vals, torch.gather(pos, 1, order)


def select_smallest_kernel(
    scores: Tensor, k: int, *, prior: Optional[Tuple[Tensor, Tensor]] = None, offset: int = 0,
) -> Tuple[Tensor, Tensor]:
    """The ``k`` smallest entries of each row of ``scores`` (``(nq, n)``
    f32), ascending, ties by position, as ``(vals (nq, k) f32, ids (nq, k)
    int64)``; ids are ``offset + column``.  With ``prior``, an ``(nq, k)``
    f32 / int64 list with ids in ``[0, 2^32 - 1)``, the ``k`` smallest of it
    and the row by (score, id).  CUDA tensors go through the kernel (one
    launch of each pass, counted under ``select`` and ``select_merge``), CPU
    tensors through :func:`select_smallest_reference`.  ``k`` is at most
    :data:`MAX_K` and ``n``, and ``offset + n`` at most ``2^32 - 1``."""
    _check(scores, k, prior, offset)
    if not scores.is_cuda:
        return select_smallest_reference(scores, k, prior=prior, offset=offset)
    scores = scores.contiguous()
    nq, n = scores.shape
    plan = select_plan(nq, n, k, _sms(scores.device))
    dev = scores.device
    cand_keys = torch.empty((nq, plan.slices, plan.kp), dtype=torch.int64, device=dev)
    cand_vals = torch.empty((nq, plan.slices, plan.kp), dtype=torch.int32, device=dev)
    vals = torch.empty((nq, k), dtype=torch.float32, device=dev)
    ids = torch.empty((nq, k), dtype=torch.int64, device=dev)
    if prior is not None:
        prior = (prior[0].contiguous(), prior[1].contiguous())
    with torch.cuda.device(dev):
        _build.launch(
            "rt_select", ("select", "select_merge"), scores.data_ptr(), nq, n,
            k, plan.kp, plan.slices, offset, cand_keys.data_ptr(), cand_vals.data_ptr(),
            None if prior is None else prior[0].data_ptr(),
            None if prior is None else prior[1].data_ptr(), vals.data_ptr(), ids.data_ptr(),
            plan.pass_smem, plan.merge_smem, torch.cuda.current_stream().cuda_stream)
    return vals, ids
