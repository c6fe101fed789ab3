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

from . import answers, vq


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
    return torch.sort(cell_dists(q, coarse), dim=1, stable=True).indices[:, :nprobe]


def cell_dists(q: Tensor, coarse: Tensor) -> Tensor:
    """``(nq, C)`` float64 squared distances of the queries to the cells'
    centres, by the program's formula ``|q|^2 + |c|^2 - 2 q.c``."""
    q, c = q.double(), coarse.double()
    return vq.sq_norms(q)[:, None] + vq.sq_norms(c)[None, :] - 2.0 * (q @ c.T)


def probe_eps(q: Tensor, coarse: Tensor) -> Tensor:
    """``(nq,)`` float64 bound ``eps_q`` on how far the program's probe
    score of any cell, and :func:`cell_dists`' distance, lie from the exact
    squared distance.

    The program (``ivf._coarse_scores``) scores a cell ``c`` by
    ``-(|q|^2 + |c|^2 - 2 q.c)`` in float32: ``q.c`` by a matrix product,
    each norm by a sum of ``d`` rounded squares, then one rounded addition
    and one rounded subtraction (the factor 2 and the sign are exact).  With
    the unit roundoff ``u`` (``2^-24``) and ``gamma_n = n u / (1 - n u)``,
    a sum of ``d`` rounded products in any order is off by at most
    ``gamma_d`` times the sum of the products' magnitudes, so each of the
    ``3d`` terms ``q_i^2``, ``c_i^2`` and ``-2 q_i c_i`` carries a relative
    error of at most ``gamma_{d+2}`` (its product, at most ``d - 1`` partial
    sums, then the two combining steps).  The terms' magnitudes add up to
    ``|q|^2 + |c|^2 + 2 sum |q_i c_i| <= (|q| + |c|)^2``, so

        |score + D| <= gamma_{d+2} (|q| + |c|)^2,

    ``D`` the exact distance.  :func:`cell_dists` evaluates the same formula
    from the same float32 values at float64 (``u = 2^-53``): its own bound
    is added.  ``eps_q`` takes the largest centre norm, so that it holds for
    every cell of the query."""
    d = q.shape[1]

    def gamma(u):
        return (d + 2) * u / (1 - (d + 2) * u)

    c_norm = vq.sq_norms(coarse.double()).max().sqrt()
    return (gamma(2.0 ** -24) + gamma(2.0 ** -53)) * (vq.sq_norms(q.double()).sqrt() + c_norm) ** 2


def probe_kinds(q: Tensor, coarse: Tensor, nprobe: int) -> tuple[Tensor, Tensor]:
    """``(must, edge)``, ``(nq, C)`` masks of the cells that every valid
    probe of ``nprobe`` cells holds, and of those that a valid probe may
    hold or not.

    With ``t`` a query's ``nprobe``-th distance and ``eps`` its
    :func:`probe_eps`, a *must* cell lies nearer than ``t - 2 eps``: the
    program scores it above every cell at ``t`` or farther, and fewer than
    ``nprobe`` cells lie nearer than ``t``, so it is probed.  An *edge* cell
    lies within ``2 eps`` of ``t`` (the ``nprobe``-th cell is one).  The
    rest lie farther than ``t + 2 eps``: the ``nprobe`` cells at ``t`` or
    nearer all score above each of them, so no valid probe holds one."""
    d = cell_dists(q, coarse)
    t = torch.sort(d, dim=1).values[:, nprobe - 1:nprobe]
    eps = 2.0 * probe_eps(q, coarse)[:, None]
    return d < t - eps, (d - t).abs() <= eps


def search(q: Tensor, coarse: Tensor, codebooks: Tensor, cell_codes: Tensor, cell_ids: Tensor,
           nprobe: int, top_k: int, qblock: int = 8) -> Tensor:
    """``(nq, top_k)`` float64 squared distances, ascending, of each query's
    ``top_k`` nearest stored rows (``|q - c - rec|^2``) among the cells
    :func:`probe` gives it; ``+inf`` past the rows those cells hold."""
    return search_cells(q, coarse, codebooks, cell_codes, cell_ids, probe(q, coarse, nprobe),
                        top_k, qblock)


def search_cells(q: Tensor, coarse: Tensor, codebooks: Tensor, cell_codes: Tensor,
                 cell_ids: Tensor, cells: Tensor, top_k: int, qblock: int = 8) -> Tensor:
    """As :func:`search`, among the cells ``cells`` (``(nq, P)``, ``-1``
    for none) of each query."""
    L = cell_codes.shape[1]
    c64 = coarse.double()
    out = torch.full((q.shape[0], top_k), float("inf"), dtype=torch.float64, device=q.device)
    for a in range(0, q.shape[0], qblock):
        p = cells[a:a + qblock]
        pc = p.clamp_min(0)
        full = vq.decode(codebooks, cell_codes[pc]) + c64[pc][:, :, None, :]  # (b, P, L, d)
        d = vq.sq_norms(q[a:a + qblock].double()[:, None, None, :] - full)
        held = (cell_ids[pc] >= 0) & (p >= 0)[:, :, None]
        d = torch.where(held, d, torch.full_like(d, float("inf")))
        kk = min(top_k, p.shape[1] * L)
        out[a:a + qblock, :kk] = torch.topk(d.reshape(d.shape[0], -1), kk, dim=1,
                                            largest=False).values
    return out


def search_numbers(q: Tensor, coarse: Tensor, codebooks: Tensor, cell_codes: Tensor,
                   cell_ids: Tensor, n: int, nprobe: int, top_k: int, d_prog: Tensor,
                   ids_prog: Tensor) -> tuple[dict, dict]:
    """The numbers a search's answers over an ``n``-row corpus are judged
    by, and notes that judge nothing: of the queries, how many have a cell
    at the probe's edge besides the ``nprobe``-th (:func:`probe_kinds`), and
    ``rank_gap`` over those and over the others.

    ``dist_err``, ``rank_gap`` and ``dup_ids`` are
    :func:`answers.answer_numbers`' against :func:`search`, but for the
    queries with edge cells: the program may probe any of those, so there
    the reference's distances are its ``top_k`` over the must cells and the
    edge cells that hold a row the program named.  Every valid probe holds
    those cells, so the program's ``r``-th distance is no larger than the
    reference's ``r``-th over them.  Over the same queries ``probe_miss``
    counts the rows named that lie in neither a must nor an edge cell, and
    the answers whose rows come from more than ``nprobe`` cells."""
    L = cell_codes.shape[1]
    d_ref = search(q, coarse, codebooks, cell_codes, cell_ids, nprobe, top_k)
    slot = slot_of_id(cell_ids, n)
    d_of = dist_of(q, coarse, codebooks, cell_codes, slot, ids_prog)
    must, edge = probe_kinds(q, coarse, nprobe)
    tied = edge.sum(dim=1) > 1
    probe_miss = 0
    if bool(tied.any()):
        ids = ids_prog[tied].long()
        ok = (ids >= 0) & (ids < n)
        s = torch.where(ok, slot[ids.clamp(0, n - 1)], torch.full_like(ids, -1))
        cell = torch.where(s >= 0, s // L, s)  # -1: no row, or a row no slot holds
        held = cell >= 0
        rows = torch.arange(cell.shape[0], device=q.device)[:, None].expand_as(cell)
        must_t, edge_t = must[tied], edge[tied]
        named = torch.zeros_like(edge_t)  # the cells that hold a row named
        named[rows[held], cell[held]] = True
        allowed = held & (must_t | edge_t)[rows, cell.clamp_min(0)]
        probe_miss = int(((ids >= 0) & ~allowed).sum() + (named.sum(dim=1) > nprobe).sum())
        keep = must_t | (edge_t & named)
        width = max(1, int(keep.sum(dim=1).max()))
        order = torch.sort(keep.to(torch.int8), dim=1, descending=True, stable=True).indices
        order = order[:, :width]
        cells = torch.where(torch.gather(keep, 1, order), order, torch.full_like(order, -1))
        d_ref[tied] = search_cells(q[tied], coarse, codebooks, cell_codes, cell_ids, cells, top_k)
    scale = vq.sq_norms(q.double())
    numbers = answers.answer_numbers(d_prog, ids_prog, d_ref, d_of, scale)
    numbers["probe_miss"] = probe_miss
    notes = {"queries": q.shape[0], "edge_queries": int(tied.sum())}
    for name, part in (("edge", tied), ("others", ~tied)):
        if bool(part.any()):
            notes[f"rank_gap.{name}"] = answers.answer_numbers(
                d_prog[part], ids_prog[part], d_ref[part], d_of[part], scale[part])["rank_gap"]
    return numbers, notes


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
