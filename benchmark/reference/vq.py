"""Vector quantization in plain PyTorch at float64: nearest centres, decoding,
the gap of a chosen code, centroid shifts, and the lower-precision encode
that serves as a control.

Nothing here imports the program or takes anything it made but the outputs
being judged and the trained centres they refer to.  Every product is
float64, or float32 with TF32 off (:func:`exact_matmul`).
"""

from __future__ import annotations

import contextlib

import torch
from torch import Tensor


@contextlib.contextmanager
def exact_matmul():
    """TF32 off for float32 products while the reference runs; the flags
    are restored after."""
    saved = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved


def sq_norms(x: Tensor) -> Tensor:
    return (x * x).sum(-1)


def nearest(x: Tensor, centres: Tensor, block: int = 65536) -> tuple[Tensor, Tensor]:
    """Index (int64) and squared distance (float64) of each row's nearest
    centre, the lowest index among equal distances."""
    c = centres.double()
    cn = sq_norms(c)
    idx = torch.empty(x.shape[0], dtype=torch.int64, device=x.device)
    dist = torch.empty(x.shape[0], dtype=torch.float64, device=x.device)
    for a in range(0, x.shape[0], block):
        xb = x[a:a + block].double()
        d = sq_norms(xb)[:, None] + cn[None, :] - 2.0 * (xb @ c.T)
        dist[a:a + block], idx[a:a + block] = d.clamp_min_(0.0).min(dim=1)
    return idx, dist


def sq_dist_to(x: Tensor, centres: Tensor, idx: Tensor, block: int = 1 << 20) -> Tensor:
    """``||x_i - centres[idx_i]||^2`` in float64, by the difference."""
    out = torch.empty(x.shape[0], dtype=torch.float64, device=x.device)
    c = centres.double()
    for a in range(0, x.shape[0], block):
        out[a:a + block] = sq_norms(x[a:a + block].double() - c[idx[a:a + block]])
    return out


def decode(codebooks: Tensor, codes: Tensor) -> Tensor:
    """``(..., m * ds)`` float64 reconstruction of ``(..., m)`` codes."""
    m, k, ds = codebooks.shape
    cb = codebooks.double()
    flat = codes.reshape(-1, m).long().clamp(0, k - 1)  # code_gap judges the codes themselves
    rec = cb[torch.arange(m, device=codes.device)[None, :], flat]  # (N, m, ds)
    return rec.reshape(*codes.shape[:-1], m * ds)


def subspace_dists(codebooks: Tensor, r: Tensor) -> tuple[Tensor, Tensor]:
    """``(N, m, k)`` float64 squared distances of each subvector of ``r`` to
    every centroid of its subquantizer, and ``(N, m)`` subvector norms."""
    m, _, ds = codebooks.shape
    cb = codebooks.double()
    rs = r.double().reshape(r.shape[0], m, ds)
    rn = sq_norms(rs)
    d = rn[:, :, None] + sq_norms(cb)[None] - 2.0 * torch.einsum("nmd,mkd->nmk", rs, cb)
    return d.clamp_min_(0.0), rn


def code_gap(codebooks: Tensor, r: Tensor, codes: Tensor, block: int = 65536) -> float:
    """The widest gap by which a chosen centroid lies farther from its
    subvector than the nearest one, as a share of ``|r_j|^2 + |c|^2`` (the
    size of the terms a product compares): 0 for an exact encode, ``inf``
    for a code that names no centroid."""
    worst = 0.0
    k = codebooks.shape[1]
    cn = sq_norms(codebooks.double())
    for a in range(0, r.shape[0], block):
        d, rn = subspace_dists(codebooks, r[a:a + block])
        best, arg = d.min(dim=2)
        c = codes[a:a + block].long()
        chosen = d.gather(2, c.clamp(0, k - 1)[:, :, None])[:, :, 0]
        scale = rn + cn.gather(1, arg.T).T
        gap = (chosen - best) / scale.clamp_min(1e-30)
        gap = torch.where((c >= 0) & (c < k), gap, torch.full_like(gap, float("inf")))
        if gap.numel():
            worst = max(worst, float(gap.max()))
    return worst


def encode_bf16(codebooks: Tensor, x: Tensor, block: int = 1 << 16) -> Tensor:
    """Codes by the arithmetic the configurations state for the kernel
    encode: ``x`` (float32) and ``2c`` rounded to bfloat16, their products
    summed exactly (float64), subtracted from the float32 ``|c|^2``; the
    lowest index among equal distances."""
    m, k, ds = codebooks.shape
    cb = codebooks.float()
    cn = torch.einsum("mkd,mkd->mk", cb, cb).double()
    cb2 = (cb + cb).to(torch.bfloat16).double()
    out = torch.empty((x.shape[0], m), dtype=torch.int64, device=x.device)
    for a in range(0, x.shape[0], block):
        xs = x[a:a + block].float().to(torch.bfloat16).double().reshape(-1, m, ds)
        out[a:a + block] = (cn[None] - torch.einsum("nmd,mkd->nmk", xs, cb2)).argmin(dim=2)
    return out


def code_mismatch(codebooks: Tensor, x: Tensor, codes: Tensor) -> tuple[int, int]:
    """Codes that differ from :func:`encode_bf16`'s of the same float32 rows,
    and how many were compared."""
    return int((encode_bf16(codebooks, x) != codes.long()).sum()), codes.numel()


def encode_lowp(codebooks: Tensor, x: Tensor, dtype: torch.dtype,
                block: int = 1 << 18) -> Tensor:
    """Codes chosen by products of ``x`` and ``2c`` rounded to ``dtype``
    (a float8 type for the control of a bfloat16 encode), f32 sums, the
    f32 centroid norms: the arithmetic of a bfloat16 encode at the next
    lower precision."""
    m, k, ds = codebooks.shape
    cb = codebooks.float()
    cn = sq_norms(cb)
    cb2 = (cb + cb).to(dtype).float()
    out = torch.empty((x.shape[0], m), dtype=torch.uint8, device=x.device)
    with exact_matmul():
        for a in range(0, x.shape[0], block):
            xs = x[a:a + block].float().to(dtype).float().reshape(-1, m, ds)
            d = cn[None] - torch.einsum("nmd,mkd->nmk", xs, cb2)
            out[a:a + block] = d.argmin(dim=2).to(torch.uint8)
    return out


def centroid_shift(x: Tensor, centres: Tensor, idx: Tensor, block: int = 1 << 20) -> float:
    """Median, over centres with two rows or more, of the distance from
    each centre to the mean of the rows assigned to it, as a share of the
    rows' root-mean-square distance to it: near 0 at a fixed point of
    Lloyd's iteration."""
    C, d = centres.shape
    sums = torch.zeros((C, d), dtype=torch.float64, device=x.device)
    ss = torch.zeros(C, dtype=torch.float64, device=x.device)
    c = centres.double()
    for a in range(0, x.shape[0], block):
        xb, ib = x[a:a + block].double(), idx[a:a + block]
        sums.index_add_(0, ib, xb)
        ss.index_add_(0, ib, sq_norms(xb - c[ib]))
    counts = torch.bincount(idx, minlength=C).double()
    keep = counts >= 2
    shift = torch.sqrt(sq_norms(sums[keep] / counts[keep, None] - c[keep]))
    rms = torch.sqrt(ss[keep] / counts[keep]).clamp_min(1e-30)
    return float(torch.median(shift / rms))

