"""End-to-end pipeline: train -> persist -> stream-encode -> search.

The counterpart of the JAX package's ``examples/pipeline.py``: the whole
life of one quantizer on one card, each numbered step a function:

1. :func:`write_corpus`: an fvecs corpus on disk (a stand-in for
   SIFT/Deep1B-style data);
2. :func:`train_quantizer`: PQ or OPQ at corpus scale by the chunked
   trainers (nothing of size n x k is ever made), with a recovery checkpoint;
3. :func:`persist_and_reload`: the artifact saved and loaded onto the card;
4. :func:`encode_from_disk`: the corpus stream-encoded from disk (the native
   reader's prefetch, pinned copies and the encode kernel overlapping);
5. :func:`search_planted`: top-k queries by ADC over the codes, 4-bit codes
   packed two a byte;
6. :func:`ivf_lifecycle` (``--ivf N``): an IVF-PQ index beside the
   exhaustive search;
7. :func:`disk_lifecycle` (``--disk``): training, the IVF build and the
   exact refine from the reader, the corpus never on the card;
8. :func:`virtual_lifecycle` (``--virtual``): the same streaming paths over a
   corpus made on the card (:class:`~reductive_tpu_torch.SyntheticReader`).

Run:  python -m reductive_tpu_torch.examples.pipeline [--n 200000] [--d 128] [--opq]
(``--device cpu`` runs it on the CPU through the kernels' plain versions.)
"""

from __future__ import annotations

import argparse
import os
import tempfile

import numpy as np
import torch

from reductive_tpu_torch import (
    SyntheticReader, io, stream_encode, train_opq_chunked, train_pq_chunked, train_pq_streamed,
)
from reductive_tpu_torch._device import resolve_device
from reductive_tpu_torch.examples import clock, device_name
from reductive_tpu_torch.ivf import build_ivf, ivf_search, train_ivf_pq
from reductive_tpu_torch.native import VecsReader, write_fvecs
from reductive_tpu_torch.ops.packing import pack_u4_codes
from reductive_tpu_torch.search import search

__all__ = [
    "write_corpus", "train_quantizer", "persist_and_reload", "encode_from_disk",
    "search_planted", "ivf_lifecycle", "disk_lifecycle", "virtual_lifecycle", "recall", "main",
]

# The JAX program's seeds, one generator a step.
SEED_TRAIN, SEED_IVF, SEED_DISK, SEED_DISK_IVF, SEED_VIRTUAL = 42, 7, 9, 10, 11
BATCH = 1 << 15       # rows a streamed batch
MSE_ROWS = 10_000     # rows the reconstruction error is taken on
TOP_K = 10
NPROBE = 8


def compute_dtype(dev: torch.device) -> torch.dtype:
    """The trainers' products: bf16 on the card, f32 on the CPU."""
    return torch.bfloat16 if dev.type == "cuda" else torch.float32


def generator(dev: torch.device, seed: int) -> torch.Generator:
    return torch.Generator(device=dev).manual_seed(seed)


def recall(planted: np.ndarray, ids: torch.Tensor) -> float:
    """The share of queries whose planted row is among their ids."""
    ids = ids.cpu().numpy()
    return float(np.mean([p in row for p, row in zip(planted, ids)]))


def write_corpus(path: str, n: int, d: int, rng: np.random.Generator) -> np.ndarray:
    """Step 1: ``n`` standard normal rows of ``d`` floats from ``rng``,
    written to ``path`` as fvecs (the JAX program's bytes at the same
    ``rng``); returns them."""
    data = rng.standard_normal((n, d)).astype(np.float32)
    write_fvecs(path, data)
    return data


def train_quantizer(
    x: torch.Tensor, m: int, bits: int, iters: int, checkpoint_path: str, *, opq: bool = False,
):
    """Step 2: ``train_opq_chunked`` or ``train_pq_chunked`` over ``x``
    where it lies (the kernels on the card), checkpointing every
    ``max(2, iters // 3)`` iterations to ``checkpoint_path``: a killed run
    resumes from it through ``initial_model=``."""
    dev = x.device
    train = train_opq_chunked if opq else train_pq_chunked
    return train(
        generator(dev, SEED_TRAIN), x, m, bits, iters, compute_dtype=compute_dtype(dev),
        checkpoint_every=max(2, iters // 3), checkpoint_path=checkpoint_path,
    )


def persist_and_reload(pq, path: str, device):
    """Step 3: the artifact saved to ``path`` and loaded onto ``device``."""
    io.save(path, pq)
    return io.load(path, device=device)


def encode_from_disk(pq, corpus_path: str, sample: torch.Tensor) -> dict:
    """Step 4: ``stream_encode`` of the fvecs file (host codes), its
    seconds, and the reconstruction MSE of ``sample`` (rows on ``pq``'s
    device)."""
    dev = pq.codebooks.device
    t0 = clock(dev)
    with VecsReader(corpus_path) as reader:
        codes = stream_encode(pq, reader, batch_size=BATCH)
    seconds = clock(dev) - t0
    rec = pq.reconstruct_batch(pq.quantize_batch(sample))
    return {"codes": codes, "seconds": seconds, "mse": float(torch.mean((sample - rec) ** 2))}


def search_planted(pq, data: np.ndarray, codes: np.ndarray, rng: np.random.Generator,
                   n_queries: int) -> dict:
    """Step 5: queries that are corpus rows drawn from ``rng`` plus 0.1
    noise, so each has one planted near neighbour (isotropic data has no
    others in 128-d), searched by ADC over ``codes`` moved to ``pq``'s
    device; 4-bit codes at an even ``m`` are packed two a byte first (half
    the bytes, the same scores)."""
    dev = pq.codebooks.device
    planted = rng.integers(0, data.shape[0], size=n_queries)
    noisy = data[planted] + 0.1 * rng.standard_normal((n_queries, data.shape[1])).astype(np.float32)
    queries = torch.from_numpy(noisy).to(dev)
    codes_t = torch.from_numpy(codes).to(dev)
    packed = pq.n_quantizer_centroids <= 16 and pq.n_subquantizers % 2 == 0
    if packed:
        codes_t = pack_u4_codes(codes_t)
    t0 = clock(dev)
    _, ids = search(pq, queries, codes_t, top_k=TOP_K, method="kernel" if packed else "auto",
                    packed=packed)
    seconds = clock(dev) - t0
    return {"queries": queries, "planted": planted, "ids": ids, "packed": packed,
            "code_bytes": codes_t.nbytes, "seconds": seconds}


def ivf_lifecycle(x: torch.Tensor, queries: torch.Tensor, n_cells: int, m: int, bits: int) -> dict:
    """Step 6: an IVF-PQ index over ``x`` (``n_cells`` coarse cells, a
    residual PQ, ``capacity="auto"``) and its search at nprobe 8."""
    dev = x.device
    t0 = clock(dev)
    coarse, rpq = train_ivf_pq(generator(dev, SEED_IVF), x, n_cells, m, bits)
    index = build_ivf(coarse, rpq, x, capacity="auto")
    t1 = clock(dev)
    _, ids = ivf_search(index, queries, top_k=TOP_K, nprobe=NPROBE)
    return {"index": index, "ids": ids, "build_s": t1 - t0, "search_s": clock(dev) - t1}


def disk_lifecycle(corpus_path: str, queries: torch.Tensor, sample: torch.Tensor, m: int,
                   bits: int, iters: int, n_cells: int) -> dict:
    """Step 7: the path for corpora larger than the card: a PQ trained by
    re-reading the file every iteration (bf16 on the wire on the card), an
    IVF index trained on a sample of it and built from the reader, and the
    exact refine reading only the candidate rows."""
    dev = queries.device
    wire = torch.bfloat16 if dev.type == "cuda" else None
    with VecsReader(corpus_path) as reader:
        t0 = clock(dev)
        spq = train_pq_streamed(
            generator(dev, SEED_DISK), reader, m, bits, max(2, iters // 2), batch_size=BATCH,
            transfer_dtype=wire, device=dev,
        )
        rec = spq.reconstruct_batch(spq.quantize_batch(sample))
        mse = float(torch.mean((sample - rec) ** 2))
        train_s = clock(dev) - t0
        coarse, rpq = train_ivf_pq(generator(dev, SEED_DISK_IVF), reader, n_cells, m, bits,
                                   train_sample=min(reader.n - 1, 1 << 17))
        t0 = clock(dev)
        index = build_ivf(coarse, rpq, reader, capacity="auto")
        build_s = clock(dev) - t0
        _, ids = ivf_search(index, queries, top_k=TOP_K, nprobe=NPROBE, refine_with=reader)
    return {"index": index, "ids": ids, "mse": mse, "train_s": train_s, "build_s": build_s}


def virtual_lifecycle(n: int, d: int, m: int, bits: int, iters: int,
                      rng: np.random.Generator, n_queries: int, dev: torch.device) -> dict:
    """Step 8: a corpus that is never written anywhere, each row a function
    of its index made on ``dev``: streamed training, an encode batch by
    batch (the codes stay on the device), and a search refined against the
    corpus itself, with queries that are rows drawn from ``rng`` plus 0.1
    noise."""
    vr = SyntheticReader(n, d, seed=1, device=dev)
    t0 = clock(dev)
    vpq = train_pq_streamed(
        generator(dev, SEED_VIRTUAL), vr, m, bits, max(2, iters // 2), batch_size=BATCH,
        compute_dtype=compute_dtype(dev), device=dev,
    )
    t1 = clock(dev)
    method = "kernel" if dev.type == "cuda" else "exact"
    vcodes = torch.cat([vpq.quantize_batch(b, method=method) for _, b in vr.batches(BATCH)])
    t2 = clock(dev)
    planted = rng.integers(0, n, size=n_queries)
    noise = torch.from_numpy(rng.standard_normal((n_queries, d)).astype(np.float32)).to(dev)
    _, ids = search(vpq, vr.read_rows(planted) + 0.1 * noise, vcodes, top_k=TOP_K, refine_with=vr)
    return {"ids": ids, "planted": planted, "train_s": t1 - t0, "encode_s": t2 - t1}


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--n", type=int, default=200_000)
    ap.add_argument("--d", type=int, default=128)
    ap.add_argument("--m", type=int, default=16)
    ap.add_argument("--bits", type=int, default=8)
    ap.add_argument("--iters", type=int, default=10)
    ap.add_argument("--opq", action="store_true", help="train OPQ instead of PQ")
    ap.add_argument("--ivf", type=int, default=0, metavar="N_CELLS",
                    help="also build an IVF-PQ index with N_CELLS coarse "
                         "cells and compare against the exhaustive search")
    ap.add_argument("--queries", type=int, default=16)
    ap.add_argument("--disk", action="store_true",
                    help="also run the fully disk-resident lifecycle "
                         "(streamed training, IVF build from the reader, "
                         "exact refine from the reader): the path for corpora "
                         "larger than the card")
    ap.add_argument("--virtual", action="store_true",
                    help="also run the lifecycle over a virtual corpus made "
                         "on the device (SyntheticReader): streamed train, "
                         "encode, search, exact refine, no disk or host link")
    ap.add_argument("--device", default=None,
                    help="where to run (default: cuda; 'cpu' runs the kernels' plain versions)")
    return ap.parse_args(argv)


def main(argv=None) -> dict:
    """Run the pipeline with the command line ``argv``; the corpus and the
    artifacts go to a temporary directory, removed at the end.  Returns
    every recall, time and size printed, and each step's seconds under
    ``"seconds"``."""
    args = parse_args(argv)
    dev = resolve_device(args.device)
    name = "OPQ" if args.opq else "PQ"
    out = {"device": device_name(dev), "n": args.n, "d": args.d, "m": args.m, "bits": args.bits,
           "iters": args.iters, "quantizer": name, "seconds": {}}
    seconds = out["seconds"]
    print(f"device: {out['device']}")

    with tempfile.TemporaryDirectory() as td:
        # 1. corpus on disk
        corpus_path = os.path.join(td, "corpus.fvecs")
        rng = np.random.default_rng(0)
        t0 = clock(dev)
        data = write_corpus(corpus_path, args.n, args.d, rng)
        seconds["write_corpus"] = clock(dev) - t0
        out["corpus_bytes"] = data.nbytes

        # 2. corpus-scale training (the fused assignment and statistics
        # kernel on the card), checkpointed every few iterations
        ckpt = os.path.join(td, "train_ckpt.npz")
        x = torch.from_numpy(data).to(dev)
        t0 = clock(dev)
        pq = train_quantizer(x, args.m, args.bits, args.iters, ckpt, opq=args.opq)
        seconds["train_quantizer"] = clock(dev) - t0
        print(f"trained {name} m={args.m} k={2**args.bits} in "
              f"{seconds['train_quantizer']:.1f}s; "
              f"recovery checkpoint at {os.path.basename(ckpt)}")

        # 3. persist + reload the codebook artifact
        t0 = clock(dev)
        pq = persist_and_reload(pq, os.path.join(td, "model.npz"), dev)
        seconds["persist_and_reload"] = clock(dev) - t0

        # 4. stream-encode the corpus from disk (native prefetch + kernel)
        sample = x[:MSE_ROWS].clone()
        t0 = clock(dev)
        enc = encode_from_disk(pq, corpus_path, sample)
        seconds["encode_from_disk"] = clock(dev) - t0
        codes = enc["codes"]
        out.update(encode_s=enc["seconds"], encode_rows_per_s=args.n / enc["seconds"],
                   code_bytes=codes.nbytes, mse=enc["mse"])
        print(f"encoded {args.n} vectors in {enc['seconds']:.2f}s "
              f"({out['encode_rows_per_s']/1e6:.1f}M vec/s end-to-end incl IO)")
        print(f"compression: {data.nbytes/1e6:.0f} MB -> {codes.nbytes/1e6:.1f} MB")
        print(f"reconstruction MSE (unit-variance data): {enc['mse']:.4f}")

        # 5. ADC top-k search over the compressed corpus
        t0 = clock(dev)
        found = search_planted(pq, data, codes, rng, args.queries)
        seconds["search_planted"] = clock(dev) - t0
        queries, planted = found["queries"], found["planted"]
        out.update(packed=found["packed"], searched_code_bytes=found["code_bytes"],
                   search_ms=1e3 * found["seconds"], recall=recall(planted, found["ids"]))
        if found["packed"]:
            print(f"packed u4 codes: {codes.nbytes/1e6:.1f} MB -> "
                  f"{found['code_bytes']/1e6:.1f} MB")
        print(f"searched {args.queries} queries x {args.n} vectors in {out['search_ms']:.0f} ms")
        print(f"recall@10 of the planted nearest neighbor: {out['recall']:.2f}")

        # 6. IVF-PQ: the scan pruned to nprobe cells of residual codes
        if args.ivf:
            t0 = clock(dev)
            ivf = ivf_lifecycle(x, queries, args.ivf, args.m, args.bits)
            seconds["ivf_lifecycle"] = clock(dev) - t0
            out["ivf"] = {"cells": args.ivf, "capacity": ivf["index"].capacity,
                          "build_s": ivf["build_s"], "search_ms": 1e3 * ivf["search_s"],
                          "recall": recall(planted, ivf["ids"])}
            print(f"built IVF index ({args.ivf} cells, capacity {ivf['index'].capacity}) "
                  f"in {ivf['build_s']:.1f}s")
            print(f"IVF search (nprobe={NPROBE}) in {out['ivf']['search_ms']:.0f} ms")
            print(f"IVF recall@10 of the planted neighbor: {out['ivf']['recall']:.2f}")
        del x

        # 7. the disk-resident lifecycle: training re-reads the file each
        # iteration, the IVF build reads it twice, the refine only the
        # candidate rows; the corpus is never on the card
        if args.disk:
            t0 = clock(dev)
            disk = disk_lifecycle(corpus_path, queries, sample, args.m, args.bits, args.iters,
                                  args.ivf or 64)
            seconds["disk_lifecycle"] = clock(dev) - t0
            out["disk"] = {"train_s": disk["train_s"], "mse": disk["mse"],
                           "build_s": disk["build_s"],
                           "dropped": len(disk["index"].dropped_ids),
                           "recall": recall(planted, disk["ids"])}
            print(f"disk: streamed PQ training in {disk['train_s']:.1f}s "
                  f"(roundtrip MSE {disk['mse']:.4f})")
            print(f"disk: IVF build from reader in {disk['build_s']:.1f}s "
                  f"(dropped={out['disk']['dropped']})")
            print(f"disk: IVF + disk-refine recall@10: {out['disk']['recall']:.2f}")

    # 8. the wire-free lifecycle over a virtual corpus made on the device
    if args.virtual:
        t0 = clock(dev)
        virt = virtual_lifecycle(args.n, args.d, args.m, args.bits, args.iters, rng,
                                 args.queries, dev)
        seconds["virtual_lifecycle"] = clock(dev) - t0
        out["virtual"] = {"train_s": virt["train_s"], "encode_s": virt["encode_s"],
                          "recall": recall(virt["planted"], virt["ids"])}
        print(f"virtual: streamed PQ training in {virt['train_s']:.1f}s")
        print(f"virtual: encoded {args.n} rows on device in {virt['encode_s']:.1f}s "
              f"(codes stay in device memory)")
        print(f"virtual: search + exact-refine recall@10: {out['virtual']['recall']:.2f}")
    return out


if __name__ == "__main__":
    main()
