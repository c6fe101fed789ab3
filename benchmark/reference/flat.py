"""Exhaustive ADC search in plain PyTorch.

A query's distance to a code is ``sum_j |q_j - c_j(code_j)|^2`` of the
query rotated by the quantizer's projection, taken from float64 tables.
"""

from __future__ import annotations

import torch
from torch import Tensor

from . import vq


def tables(q_rot: Tensor, codebooks: Tensor, qblock: int = 64) -> Tensor:
    """``(nq, m, k)`` float64 ``|q_j - c_jk|^2``, by the difference."""
    m, k, ds = codebooks.shape
    cb = codebooks.double()
    q = q_rot.double().reshape(q_rot.shape[0], m, ds)
    out = torch.empty((q.shape[0], m, k), dtype=torch.float64, device=q.device)
    for a in range(0, q.shape[0], qblock):
        out[a:a + qblock] = vq.sq_norms(q[a:a + qblock, :, None, :] - cb[None])
    return out


def lookup(t: Tensor, codes: Tensor) -> Tensor:
    """``(nq, n)`` sums over ``j`` of ``t[q, j, codes[i, j]]``, in ``t``'s type."""
    idx = codes.long()
    acc = t[:, 0, idx[:, 0]]
    for j in range(1, t.shape[1]):
        acc = acc + t[:, j, idx[:, j]]
    return acc


def search(t64: Tensor, codes: Tensor, top_k: int, margin: int = 64,
           block: int = 1 << 17) -> Tensor:
    """``(nq, top_k)`` float64 distances, ascending, of each query's
    ``top_k`` nearest codes over the whole corpus: candidates by float32
    sums of the float64 tables rounded once, then their float64 sums."""
    t32 = t64.float()
    keep = top_k + margin
    cand = None
    for a in range(0, codes.shape[0], block):
        s = lookup(t32, codes[a:a + block])
        kk = min(keep, s.shape[1])
        v, i = torch.topk(s, kk, dim=1, largest=False)
        i = i + a
        if cand is not None:
            v = torch.cat([cand[0], v], dim=1)
            i = torch.cat([cand[1], i], dim=1)
            v, j = torch.topk(v, min(keep, v.shape[1]), dim=1, largest=False)
            i = torch.gather(i, 1, j)
        cand = (v, i)
    exact = dist_of(t64, codes, cand[1])
    return torch.sort(exact, dim=1).values[:, :top_k]


def dist_of(t64: Tensor, codes: Tensor, ids: Tensor) -> Tensor:
    """float64 distances of the codes ``ids`` (``(nq, r)``) names; ``+inf``
    for an id outside the corpus or a code that names no centroid."""
    n, m = codes.shape
    k = t64.shape[2]
    ok = (ids >= 0) & (ids < n)
    c = codes[ids.clamp(0, n - 1).long()].long()  # (nq, r, m)
    ok &= (c < k).all(dim=2)
    c = c.clamp(0, k - 1)
    q = torch.arange(t64.shape[0], device=ids.device)[:, None, None]
    j = torch.arange(m, device=ids.device)[None, None, :]
    d = t64[q, j, c].sum(dim=2)
    return torch.where(ok, d, torch.full_like(d, float("inf")))
