"""The numbers a search's answers are judged by, from the program's answers
and the reference's float64 distances."""

from __future__ import annotations

import torch
from torch import Tensor


def answer_numbers(d_prog: Tensor, ids_prog: Tensor, d_ref: Tensor, d_ref_of_prog: Tensor,
                   scale: Tensor) -> dict:
    """The numbers a search's answers are judged by, each query's errors as
    a share of ``scale`` (its ``|q|^2``):

    * ``dist_err``: the widest gap between a distance the program returned
      and the reference's distance of the row it named;
    * ``rank_gap``: the widest gap by which the row the program put at rank
      ``r`` lies farther, by the reference, than the reference's ``r``-th
      nearest (``inf`` where the program names fewer rows than exist);
    * ``dup_ids``: rows named twice in one answer."""
    d_prog = d_prog.double().to(d_ref.device)
    ids_prog = ids_prog.to(d_ref.device)
    s = scale.double()[:, None].clamp_min(1e-30)
    both_inf = torch.isinf(d_ref_of_prog) & torch.isinf(d_prog)
    err = torch.where(both_inf, torch.zeros_like(d_prog), (d_prog - d_ref_of_prog).abs() / s)
    gap = torch.where(torch.isinf(d_ref) & torch.isinf(d_ref_of_prog),
                      torch.zeros_like(d_ref), (d_ref_of_prog - d_ref) / s)
    srt = torch.sort(ids_prog, dim=1).values
    dup = ((srt[:, 1:] == srt[:, :-1]) & (srt[:, 1:] >= 0)).sum()
    return {"dist_err": float(torch.nan_to_num(err, nan=float("inf")).max()),
            "rank_gap": float(torch.nan_to_num(gap, nan=float("inf")).max()),
            "dup_ids": int(dup)}
