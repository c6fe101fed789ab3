"""Serving-side lifecycle: index -> search (L2 + MIPS) -> update -> scale out.

The counterpart of the JAX package's ``examples/serving.py``; the
training-side lifecycle is :mod:`reductive_tpu_torch.examples.pipeline`.
What a query-serving process does, each numbered step a function:

1. :func:`make_sphere_corpus`: a corpus on the unit sphere (the cosine
   regime, where dot = cos) and queries that are corpus rows;
2. :func:`build_index`: an IVF-PQ index (a real deployment loads it with
   :func:`reductive_tpu_torch.io.load`);
3. :func:`serve_l2`: L2 queries, IVF shortlist + exact refine;
4. :func:`serve_mips`: cosine / MIPS queries over the same index
   (``metric="dot"``);
5. :func:`update`: live updates, ``ivf_remove`` then ``ivf_add``;
6. :func:`sharded_scan`: the exhaustive scan sharded over the ranks of the
   process group (``search_sharded``), when one card's scan rate is not
   enough.

The process joins a process group at the start
(:func:`~reductive_tpu_torch.parallel.initialize_distributed`): alone, a
one-rank group; under ``torchrun --nproc-per-node=N`` one rank a card, every
rank running every step and rank 0 printing.

Run: python -m reductive_tpu_torch.examples.serving [--n 100000] [--cells 256]
     torchrun --nproc-per-node=8 -m reductive_tpu_torch.examples.serving
(``--device cpu`` runs it on the CPU, the group over gloo.)
"""

from __future__ import annotations

import argparse

import numpy as np
import torch
import torch.distributed as dist

from reductive_tpu_torch import parallel, train_pq_chunked
from reductive_tpu_torch._device import resolve_device
from reductive_tpu_torch.examples import clock, device_name
from reductive_tpu_torch.ivf import build_ivf, ivf_add, ivf_remove, ivf_search, train_ivf_pq
from reductive_tpu_torch.search import search, search_sharded

__all__ = [
    "make_sphere_corpus", "unit_rows", "build_index", "serve_l2", "serve_mips", "update",
    "sharded_scan", "main",
]

# The JAX program's seeds, one generator a step.
SEED_CORPUS, SEED_INDEX, SEED_NEW, SEED_FLAT = 0, 1, 2, 3
TOP_K = 10
NPROBE = 8
UPDATE_ROWS = 1000    # rows retired, and new rows added
FLAT_ITERATIONS = 8   # Lloyd's iterations of the flat PQ the sharded scan searches


def unit_rows(n: int, d: int, dev: torch.device, seed: int) -> torch.Tensor:
    """``n`` standard normal rows of ``d`` floats on ``dev``, each scaled to
    unit length."""
    x = torch.randn((n, d), generator=torch.Generator(device=dev).manual_seed(seed), device=dev)
    return x / torch.linalg.vector_norm(x, dim=1, keepdim=True)


def make_sphere_corpus(n: int, d: int, n_queries: int, dev: torch.device):
    """Step 1: ``(x, queries, query_rows)``: ``n`` unit rows, and as queries
    the rows ``0, n // n_queries, ...`` (``query_rows``), each its own
    nearest neighbour."""
    x = unit_rows(n, d, dev, SEED_CORPUS)
    query_rows = np.arange(0, n, n // n_queries)[:n_queries]
    return x, x[torch.from_numpy(query_rows).to(dev)], query_rows


def build_index(x: torch.Tensor, n_cells: int, m: int, bits: int):
    """Step 2: ``train_ivf_pq`` and ``build_ivf(capacity="auto")`` over ``x``
    where it lies."""
    gen = torch.Generator(device=x.device).manual_seed(SEED_INDEX)
    coarse, rpq = train_ivf_pq(gen, x, n_cells, m, bits)
    return build_ivf(coarse, rpq, x, capacity="auto")


def serve_l2(index, x: torch.Tensor, queries: torch.Tensor, query_rows: np.ndarray) -> dict:
    """Step 3: the IVF shortlist refined by exact L2 distances to ``x``;
    ``self_hit`` is the share of queries whose first id is their own row."""
    dev = queries.device
    t0 = clock(dev)
    dists, ids = ivf_search(index, queries, top_k=TOP_K, nprobe=NPROBE, refine_with=x)
    seconds = clock(dev) - t0
    self_hit = float(np.mean(ids[:, 0].cpu().numpy() == query_rows))
    return {"dists": dists, "ids": ids, "seconds": seconds, "self_hit": self_hit}


def serve_mips(index, x: torch.Tensor, queries: torch.Tensor, ids_l2: torch.Tensor) -> dict:
    """Step 4: the same index and refine by inner product; ``agreement`` is
    the share of queries whose first id is L2's (on the sphere the two
    orders are one)."""
    dev = queries.device
    t0 = clock(dev)
    dists, ids = ivf_search(index, queries, top_k=TOP_K, nprobe=NPROBE, metric="dot",
                            refine_with=x)
    seconds = clock(dev) - t0
    agreement = float(torch.mean((ids[:, 0] == ids_l2[:, 0]).to(torch.float32)))
    return {"dists": dists, "ids": ids, "seconds": seconds, "agreement": agreement}


def update(index, x_new: torch.Tensor, first_new_id: int) -> dict:
    """Step 5: ids ``0 .. UPDATE_ROWS - 1`` retired, then the rows ``x_new``
    added (their ids ``first_new_id`` onwards, past every live id); the
    first four new rows are searched, and ``retrievable`` is the share
    found first as a new id."""
    dev = x_new.device
    t0 = clock(dev)
    index = ivf_remove(index, np.arange(UPDATE_ROWS))
    index = ivf_add(index, x_new)
    seconds = clock(dev) - t0
    dists, ids = ivf_search(index, x_new[:4], top_k=3, nprobe=NPROBE)
    return {"index": index, "seconds": seconds, "live": int((index.cell_ids >= 0).sum()),
            "dists": dists, "ids": ids,
            "retrievable": float(torch.mean((ids[:, 0] >= first_new_id).to(torch.float32)))}


def sharded_scan(x: torch.Tensor, queries: torch.Tensor, m: int, bits: int) -> dict:
    """Step 6: a flat PQ trained on the full rows (the IVF residual
    quantizer spans the residuals and would mis-scale them), the corpus
    encoded, and the exhaustive MIPS scan over a 1-D mesh of every rank of
    the process group (``search_sharded``; each rank makes this call) beside
    the single-process ``search``; ``agreement`` is the mean share of ids
    the two have in common."""
    dev = x.device
    gen = torch.Generator(device=dev).manual_seed(SEED_FLAT)
    flat_pq = train_pq_chunked(gen, x, m, bits, FLAT_ITERATIONS)
    codes = flat_pq.quantize_batch(x, method="kernel" if dev.type == "cuda" else "exact")
    mesh = parallel.make_mesh(devices=dev.type)
    t0 = clock(dev)
    _, ids_sharded = search_sharded(flat_pq, queries, codes, top_k=TOP_K, mesh=mesh, metric="dot")
    t1 = clock(dev)
    _, ids_single = search(flat_pq, queries, codes, top_k=TOP_K, metric="dot")
    t2 = clock(dev)
    a, b = ids_sharded.cpu().numpy(), ids_single.cpu().numpy()
    agreement = float(np.mean([len(set(r) & set(s)) / TOP_K for r, s in zip(a, b)]))
    return {"ids_sharded": ids_sharded, "ids_single": ids_single, "agreement": agreement,
            "ranks": dist.get_world_size(), "sharded_s": t1 - t0, "single_s": t2 - t1}


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--n", type=int, default=100_000)
    ap.add_argument("--d", type=int, default=128)
    ap.add_argument("--m", type=int, default=16)
    ap.add_argument("--bits", type=int, default=8)
    ap.add_argument("--cells", type=int, default=256)
    ap.add_argument("--queries", type=int, default=16)
    ap.add_argument("--device", default=None,
                    help="where to run (default: cuda; 'cpu' runs the kernels' plain versions)")
    return ap.parse_args(argv)


def main(argv=None) -> dict:
    """Run the serving lifecycle with the command line ``argv`` on every
    rank; rank 0 prints.  A process group this call set up is torn down at
    its end.  Returns every number printed, and each step's seconds under
    ``"seconds"``."""
    args = parse_args(argv)
    dev = resolve_device(args.device)
    had_group = dist.is_initialized()
    parallel.initialize_distributed(**({"backend": "gloo"} if dev.type == "cpu" else {}))
    try:
        if dev.type == "cuda" and dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
        return _serve(args, dev, print if dist.get_rank() == 0 else lambda *a, **k: None)
    finally:
        if not had_group:
            dist.destroy_process_group()


def _serve(args: argparse.Namespace, dev: torch.device, say) -> dict:
    out = {"device": device_name(dev), "n": args.n, "d": args.d, "m": args.m, "bits": args.bits,
           "cells": args.cells, "seconds": {}}
    seconds = out["seconds"]
    say(f"device: {out['device']}")

    # 1. corpus on the unit sphere
    t0 = clock(dev)
    x, queries, query_rows = make_sphere_corpus(args.n, args.d, args.queries, dev)
    seconds["make_sphere_corpus"] = clock(dev) - t0

    # 2. the index
    t0 = clock(dev)
    index = build_index(x, args.cells, args.m, args.bits)
    seconds["build_index"] = clock(dev) - t0
    out["capacity"] = index.capacity
    say(f"index: {args.cells} cells, capacity {index.capacity}, "
        f"built in {seconds['build_index']:.1f}s")

    # 3. L2 serving: IVF shortlist + exact refine
    t0 = clock(dev)
    l2 = serve_l2(index, x, queries, query_rows)
    seconds["serve_l2"] = clock(dev) - t0
    out.update(l2_ms=1e3 * l2["seconds"], self_hit=l2["self_hit"])
    say(f"L2 IVF+refine: {out['l2_ms']:.1f} ms (top-1 self-hit {l2['self_hit']:.2f})")

    # 4. the same index serves cosine / MIPS queries
    t0 = clock(dev)
    mips = serve_mips(index, x, queries, l2["ids"])
    seconds["serve_mips"] = clock(dev) - t0
    out.update(mips_ms=1e3 * mips["seconds"], mips_agreement=mips["agreement"])
    say(f"MIPS IVF+refine: {out['mips_ms']:.1f} ms "
        f"(agrees with L2 top-1 on the sphere: {mips['agreement']:.2f})")

    # 5. live updates: retire the first rows, add as many new ones
    t0 = clock(dev)
    upd = update(index, unit_rows(UPDATE_ROWS, args.d, dev, SEED_NEW), args.n)
    seconds["update"] = clock(dev) - t0
    out.update(update_ms=1e3 * upd["seconds"], live=upd["live"], retrievable=upd["retrievable"])
    say(f"update: -{UPDATE_ROWS}/+{UPDATE_ROWS} rows in {out['update_ms']:.1f} ms "
        f"({upd['live']} live)")
    say(f"update: new rows retrievable: {upd['retrievable']:.2f}")
    del index, upd

    # 6. scale-out: the exhaustive scan sharded over the ranks
    t0 = clock(dev)
    scan = sharded_scan(x, queries, args.m, args.bits)
    seconds["sharded_scan"] = clock(dev) - t0
    out.update(ranks=scan["ranks"], sharded_ms=1e3 * scan["sharded_s"],
               single_ms=1e3 * scan["single_s"], sharded_agreement=scan["agreement"])
    say(f"sharded exhaustive scan over {scan['ranks']} ranks: {out['sharded_ms']:.1f} ms, "
        f"agreement with single-device: {scan['agreement']:.2f}")
    return out


if __name__ == "__main__":
    main()
