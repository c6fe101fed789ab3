"""IVF-PQ in plain PyTorch at float64: the checks of an index's cells against
the corpus, and the search of a query's nearest probed cells.

The cells (``(C, L, m)`` codes, ``(C, L)`` ids with ``-1`` for an empty
slot, ``(C, L)`` norms) and the trained centres are what is judged; the
reference works out again from the corpus where each row belongs, its
residual code, its norm, and each query's probe and distances.
"""

from __future__ import annotations

import torch
from torch import Tensor

from . import vq


def slot_of_id(cell_ids: Tensor, n: int) -> Tensor:
    """``(n,)`` flat slot of each corpus row, ``-1`` where none holds it
    (a row held twice keeps one of its slots: the count is checked apart)."""
    ids = cell_ids.reshape(-1).long()
    occ = (ids >= 0) & (ids < n)
    slot = torch.full((n,), -1, dtype=torch.int64, device=ids.device)
    slot[ids[occ]] = torch.nonzero(occ)[:, 0]
    return slot


def check_index(x: Tensor, coarse: Tensor, codebooks: Tensor, cell_codes: Tensor,
                cell_ids: Tensor, cell_norms: Tensor, block: int = 65536) -> tuple[dict, Tensor]:
    """The numbers an index is judged by, and each row's nearest cell.

    * ``ids_lost``: corpus rows held by no slot or by more than one, plus
      ids out of range (0 when every row is stored exactly once);
    * ``place_gap``: over rows whose nearest cell has a free slot, the
      widest gap by which the cell that holds the row lies farther than the
      nearest, as a share of ``|x|^2`` (rounding only: such a row belongs in
      its nearest cell);
    * ``code_gap``: :func:`vq.code_gap` of every row's stored code on its
      residual against the cell that holds it;
    * ``norm_err``: the widest ``|g - |c + rec|^2| / |c + rec|^2`` of the
      stored norms."""
    C, L, m = cell_codes.shape
    n = x.shape[0]
    ids = cell_ids.reshape(-1).long()
    occ = ids >= 0
    held = ids[occ]
    in_range = (held < n).sum()
    counts = torch.bincount(held[held < n], minlength=n)
    ids_lost = int((counts != 1).sum() + (held.numel() - in_range))

    slot = slot_of_id(cell_ids, n)
    stored = torch.where(slot >= 0, slot // L, torch.zeros_like(slot))
    near, d_near = vq.nearest(x, coarse, block)
    fill = occ.reshape(C, L).sum(dim=1)
    free = (fill[near] < L) & (slot >= 0)
    d_stored = vq.sq_dist_to(x, coarse, stored)
    gap = (d_stored - d_near) / vq.sq_norms(x.double()).clamp_min(1e-30)
    place_gap = float(gap[free].max()) if bool(free.any()) else 0.0

    flat_codes = cell_codes.reshape(C * L, m)
    flat_norms = cell_norms.reshape(C * L)
    c64 = coarse.double()
    code_worst = norm_worst = 0.0
    rows = torch.nonzero(slot >= 0)[:, 0]
    for a in range(0, rows.shape[0], block):
        r = rows[a:a + block]
        s = slot[r]
        cell = s // L
        resid = x[r].double() - c64[cell]
        codes = flat_codes[s]
        code_worst = max(code_worst, vq.code_gap(codebooks, resid, codes, block))
        full = c64[cell] + vq.decode(codebooks, codes)
        g = vq.sq_norms(full)
        err = (flat_norms[s].double() - g).abs() / g.clamp_min(1e-30)
        norm_worst = max(norm_worst, float(err.max()))
    return ({"ids_lost": ids_lost, "place_gap": place_gap, "code_gap": code_worst,
             "norm_err": norm_worst}, near)


def probe(q: Tensor, coarse: Tensor, nprobe: int) -> Tensor:
    """``(nq, nprobe)`` nearest cells of each query by float64 distances,
    nearest first, the lowest index among equal distances."""
    q, c = q.double(), coarse.double()
    d = vq.sq_norms(q)[:, None] + vq.sq_norms(c)[None, :] - 2.0 * (q @ c.T)
    return torch.sort(d, dim=1, stable=True).indices[:, :nprobe]


def search(q: Tensor, coarse: Tensor, codebooks: Tensor, cell_codes: Tensor, cell_ids: Tensor,
           nprobe: int, top_k: int, qblock: int = 8) -> Tensor:
    """``(nq, top_k)`` float64 squared distances, ascending, of each query's
    ``top_k`` nearest stored rows (``|q - c - rec|^2``) among the cells
    :func:`probe` gives it; ``+inf`` past the rows those cells hold."""
    L = cell_codes.shape[1]
    c64 = coarse.double()
    cells = probe(q, coarse, nprobe)
    out = torch.full((q.shape[0], top_k), float("inf"), dtype=torch.float64, device=q.device)
    for a in range(0, q.shape[0], qblock):
        p = cells[a:a + qblock]
        full = vq.decode(codebooks, cell_codes[p]) + c64[p][:, :, None, :]  # (b, P, L, d)
        d = vq.sq_norms(q[a:a + qblock].double()[:, None, None, :] - full)
        d = torch.where(cell_ids[p] >= 0, d, torch.full_like(d, float("inf")))
        kk = min(top_k, nprobe * L)
        out[a:a + qblock, :kk] = torch.topk(d.reshape(d.shape[0], -1), kk, dim=1,
                                            largest=False).values
    return out


def dist_of(q: Tensor, coarse: Tensor, codebooks: Tensor, cell_codes: Tensor, slot: Tensor,
            ids: Tensor) -> Tensor:
    """``|q - c - rec|^2`` (float64) of the rows ``ids`` (``(nq, top_k)``)
    as the cells hold them; ``+inf`` for ``-1`` or a row no slot holds."""
    C, L, m = cell_codes.shape
    ok = (ids >= 0) & (ids < slot.shape[0])
    s = slot[ids.clamp(0, slot.shape[0] - 1).long()]
    ok &= s >= 0
    s = s.clamp_min(0)
    full = coarse.double()[s // L] + vq.decode(codebooks, cell_codes.reshape(C * L, m)[s])
    d = vq.sq_norms(q.double()[:, None, :] - full)
    return torch.where(ok, d, torch.full_like(d, float("inf")))


def recode(cell_codes: Tensor, cell_ids: Tensor, coarse: Tensor, codebooks: Tensor, x: Tensor,
           dtype: torch.dtype, block: int = 1 << 20) -> None:
    """Writes into ``cell_codes`` every stored row's residual code by
    :func:`vq.encode_lowp` at ``dtype``: the reference's encode in the
    program's place, one precision lower (a control)."""
    C, L, m = cell_codes.shape
    flat = cell_codes.view(C * L, m)
    ids = cell_ids.reshape(-1)
    slots = torch.nonzero(ids >= 0)[:, 0]
    for a in range(0, slots.shape[0], block):
        s = slots[a:a + block]
        resid = x[ids[s].long()] - coarse[s // L]
        flat[s] = vq.encode_lowp(codebooks, resid, dtype)


def training_shifts(x: Tensor, coarse: Tensor, codebooks: Tensor, near: Tensor,
                    rows: Tensor) -> dict:
    """How far one more Lloyd's step at float64 would move the trained
    state: ``coarse_shift``, :func:`vq.centroid_shift` of the coarse centres
    over the whole corpus (``near``: each row's nearest cell), and
    ``codebook_shift``, the median over subspaces of the same for the
    codebooks over the residuals of the corpus rows ``rows``."""
    resid = x[rows].double() - coarse.double()[near[rows]]
    m, k, ds = codebooks.shape
    shifts = []
    for j in range(m):
        sub = resid[:, j * ds:(j + 1) * ds]
        idx, _ = vq.nearest(sub, codebooks[j])
        shifts.append(vq.centroid_shift(sub, codebooks[j], idx))
    return {"coarse_shift": vq.centroid_shift(x, coarse, near),
            "codebook_shift": float(torch.tensor(shifts).median())}
