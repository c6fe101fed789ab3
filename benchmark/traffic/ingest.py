"""Ingest: ``Pq.quantize_batch(batch, method="kernel")`` of the
configuration's OPQ quantizer (trained in set-up on a sample) over batches
of the resident corpus, one after another, each waited for.

Parameters: ``batch`` rows; the batches start at evenly spaced rows that
cover the corpus, walked in order and wrapping around; ``warmup_batches``,
``check_samples`` (batches whose codes the reference checks).  Controls:
``"fp8"``, the reference's encode with float8 (e4m3) products in place of
the program, where the configuration states bfloat16; ``"tf32"``, the
program's projection in TF32 where it states float32 with TF32 off.
"""

from __future__ import annotations

import math

import torch

from benchmark import deployments, roofline
from benchmark.reference import vq


def setup(ctx):
    deployments.prepare(ctx)
    deployments.apply_control(ctx, ("fp8", "tf32"))
    x = deployments.corpus(ctx)
    ctx.mark("corpus")
    pq = deployments.opq_train(ctx, x)
    ctx.mark("train")
    n, b = x.shape[0], ctx.params["batch"]
    count = max(1, math.ceil(n / b))
    starts = [0] if count == 1 else [round(j * (n - b) / (count - 1)) for j in range(count)]
    return {"ctx": ctx, "x": x, "pq": pq, "starts": starts}


def step(state, i):
    ctx, x, pq = state["ctx"], state["x"], state["pq"]
    s = state["starts"][i % len(state["starts"])]
    batch = x[s:s + ctx.params["batch"]]
    if ctx.control == "fp8":
        with vq.exact_matmul():
            codes = vq.encode_lowp(pq.codebooks, batch @ pq.projection, torch.float8_e4m3fn)
    else:
        codes = pq.quantize_batch(batch, method="kernel")
    if codes.is_cuda:
        torch.cuda.synchronize(codes.device)
    return s, codes


def warmup(state):
    for i in range(state["ctx"].params["warmup_batches"]):
        step(state, i)


def end_to_end(state, steps, elapsed, latencies):
    return {"ingest_rows_per_s": steps * state["ctx"].params["batch"] / elapsed}


def work(state, steps):
    """The encode work of ``steps`` batches (the projected rows read, the
    codes written, the codebook once a batch)."""
    pq = state["pq"]
    m, k, ds = pq.codebooks.shape
    nbytes, nops = roofline.encode_work(state["ctx"].params["batch"], m * ds, m, k)
    return {"encode_bytes": steps * nbytes, "encode_ops": steps * nops}


def check(state, sampled):
    """The sampled batches' codes: against the nearest centroids of their
    rows projected at float64 (``code_gap``), and against the stated
    arithmetic on the rows projected at float32, TF32 off, as the batch was
    (``code_mismatch``, a share of the codes)."""
    x, pq, b = state["x"], state["pq"], state["ctx"].params["batch"]
    proj = pq.projection.double()
    gap, differ, total = 0.0, 0, 0
    with vq.exact_matmul():
        for s, codes in (out for _, out in sampled):
            rows32 = x[s:s + b] @ pq.projection
            d, n = vq.code_mismatch(pq.codebooks, rows32, codes)
            differ, total = differ + d, total + n
            del rows32
            for a in range(0, codes.shape[0], 1 << 18):
                rows = x[s + a:s + min(b, a + (1 << 18))].double() @ proj
                gap = max(gap, vq.code_gap(pq.codebooks, rows, codes[a:a + (1 << 18)]))
    return [("code_gap", gap), ("code_mismatch", differ / max(total, 1))]
