"""Standing up an IVF-PQ index, one job after another: ``ivf.train_ivf_pq``
then ``ivf.build_ivf`` over the resident corpus, each job's draws from a
stream of its own, each waited for.  In the traced run each job's two stages
are timed apart (a wait for the card between them): spans ``train`` and
``place``.

Parameters: ``check_samples`` (jobs whose index the reference checks),
``check_rows`` (rows whose residuals check the codebooks).  The warm-up is
one whole job.  Controls: ``"fp8"``, each index's codes replaced by the
reference's encode with float8 (e4m3) products, where the configuration
states bfloat16; ``"tf32"``, the program's float32 products in TF32.  Fault
``"frozen"``: Lloyd's steps that return their state unchanged, planted in
the program (the coarse stage keeps its k-means++ seeds, the residual
quantizer its initial codebooks; ``deployments.apply_control``).
"""

from __future__ import annotations

import time

import torch

from benchmark import data, deployments
from benchmark.reference import ivf as ref_ivf, vq


def setup(ctx):
    deployments.prepare(ctx)
    deployments.apply_control(ctx, ("fp8", "tf32", "frozen"))
    x = deployments.corpus(ctx)
    ctx.mark("corpus")
    return {"ctx": ctx, "x": x}


def _sync(x):
    if x.is_cuda:
        torch.cuda.synchronize(x.device)


def _job(state, tag):
    ctx, x = state["ctx"], state["x"]
    t0 = time.perf_counter()
    coarse, pq = deployments.ivf_train(ctx, x, tag)
    if ctx.trace:
        _sync(x)
        t1 = time.perf_counter()
        ctx.span("train", t1 - t0)
    index = deployments.ivf_build(ctx, x, coarse, pq)
    if ctx.control == "fp8":
        ref_ivf.recode(index.cell_codes, index.cell_ids, index.coarse_centroids,
                       index.pq.codebooks, x, torch.float8_e4m3fn)
    _sync(x)
    if ctx.trace:
        ctx.span("place", time.perf_counter() - t1)
    return index


def step(state, i):
    return _job(state, f"job{i}")


def warmup(state):
    _job(state, "warmup")


def end_to_end(state, steps, elapsed, latencies):
    return {"build_s": elapsed / steps}


def work(state, steps):
    return {}


def check(state, sampled):
    """Each sampled job's index against the corpus (the worst of each
    number over them), and its training by the shift one more Lloyd's step
    at float64 would give: the coarse centres over the whole corpus, the
    codebooks over the residuals of a sample of rows."""
    ctx, x = state["ctx"], state["x"]
    gen = data.generator(ctx.device, ctx.seed, "check_rows")
    rows = data.distinct_rows(gen, x.shape[0], min(ctx.params["check_rows"], x.shape[0]))
    worst = {}
    with vq.exact_matmul():
        for _, index in sampled:
            coarse, cb = index.coarse_centroids, index.pq.codebooks
            numbers, near = ref_ivf.check_index(x, coarse, cb, index.cell_codes, index.cell_ids,
                                                index.cell_norms)
            numbers.update(ref_ivf.training_shifts(x, coarse, cb, near, rows))
            for name, value in numbers.items():
                worst[name] = max(worst.get(name, value), value)
    return list(worst.items())
