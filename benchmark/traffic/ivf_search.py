"""IVF-PQ search in a closed loop: ``ivf.ivf_search`` over an index built in
set-up (``train_ivf_pq``, then ``build_ivf``), one request after another,
by the ADC-table probe (``use_kernel=True``: the kernels on the card, their
plain versions on the CPU).

Parameters: ``batch`` queries a request, ``nprobe``, ``top_k``,
``warmup_requests``, ``check_samples`` (requests whose answers the reference
checks), ``check_rows`` (rows whose residuals check the codebooks) and,
optionally, ``deployment_seed``: the corpus, the queries and the index are
then drawn from it, the same for every run, and the run's seed only orders
the requests and draws what is checked; without it the run's seed draws
everything.  The query set is cut into ``batch``-query requests, wrapping,
sent in an order drawn from the run's seed, pass after pass.  A request's
work follows the union of its queries' cells, which crosses the probe's
chunks of cells at some requests and not at others; so with a
``deployment_seed`` every seed gets the same requests, in another order.

Controls: ``"splits1"``, the port's own table path one precision lower
(bfloat16 tables, ``splits=1``) where the configuration states
``splits=2``; ``"fp8"``, the index's codes replaced by the reference's
encode with float8 (e4m3) products where it states bfloat16; ``"tf32"``,
the program's float32 products in TF32.  Fault ``"frozen"``: training's
Lloyd's steps return their state unchanged (``deployments.apply_control``).
"""

from __future__ import annotations

import dataclasses
import sys

import torch

from benchmark import closed_loop, data, deployments, roofline
from benchmark.reference import ivf as ref_ivf, vq


def setup(ctx):
    deployments.prepare(ctx)
    deployments.apply_control(ctx, ("splits1", "fp8", "tf32", "frozen"))
    cfg, p = ctx.config, ctx.params
    deployment = dataclasses.replace(ctx, seed=p.get("deployment_seed", ctx.seed))
    x = deployments.corpus(deployment)
    q = deployments.queries(deployment, x)
    ctx.mark("corpus")
    coarse, pq = deployments.ivf_train(deployment, x)
    ctx.mark("train")
    index = deployments.ivf_build(deployment, x, coarse, pq)
    ctx.mark("build")
    if ctx.control == "fp8":
        ref_ivf.recode(index.cell_codes, index.cell_ids, coarse, pq.codebooks, x,
                       torch.float8_e4m3fn)
    splits = 1 if ctx.control == "splits1" else cfg["table_splits"]
    n_requests = -(-q.shape[0] // p["batch"])
    order = torch.randperm(n_requests, generator=data.generator("cpu", ctx.seed, "order"))
    return {"ctx": ctx, "x": x, "q": q, "ring": closed_loop.query_ring(q, p["batch"]),
            "index": index, "splits": splits, "order": order.tolist()}


def _queries(state, i):
    p, order = state["ctx"].params, state["order"]
    return closed_loop.request(state["ring"], state["q"].shape[0], p["batch"],
                               order[i % len(order)])


def step(state, i):
    from reductive_tpu_torch import ivf

    p = state["ctx"].params
    d, ids = ivf.ivf_search(state["index"], _queries(state, i), p["top_k"], nprobe=p["nprobe"],
                            use_kernel=True, splits=state["splits"])
    return d.cpu(), ids.cpu()


def warmup(state):
    for i in range(state["ctx"].params["warmup_requests"]):
        step(state, i)


def end_to_end(state, steps, elapsed, latencies):
    return closed_loop.search_metrics(steps, state["ctx"].params["batch"], elapsed, latencies)


def work(state, steps):
    """The ADC work of the requests ``0 .. steps - 1`` from their queries:
    each query probes its ``nprobe`` nearest cells (float32 products here,
    the benchmark's own), and a request needs the stored rows of the union
    of its queries' cells read once and every (query, row) pair of a
    query's own cells scored."""
    p = state["ctx"].params
    index = state["index"]
    b, nprobe = p["batch"], p["nprobe"]
    m, k = index.pq.n_subquantizers, index.pq.n_quantizer_centroids
    coarse = index.coarse_centroids
    held = (index.cell_ids >= 0).sum(dim=1).to(torch.int64)
    nbytes = nops = 0
    per = 128
    for r0 in range(0, steps, per):
        reqs = range(r0, min(steps, r0 + per))
        q = torch.cat([_queries(state, i) for i in reqs])
        d = vq.sq_norms(coarse)[None, :] - 2.0 * (q @ coarse.T)
        cells = torch.topk(d, nprobe, dim=1, largest=False).indices.reshape(len(reqs), b * nprobe)
        mark = torch.zeros((len(reqs), coarse.shape[0]), dtype=torch.bool, device=q.device)
        mark.scatter_(1, cells, True)
        union_rows = (mark.to(torch.int64) * held[None, :]).sum(dim=1)
        pairs = held[cells].sum(dim=1)
        for u, pr in zip(union_rows.tolist(), pairs.tolist()):
            wb, wo = roofline.adc_ivf_work(u, pr, b, m, k, p["top_k"])
            nbytes += wb
            nops += wo
    return {"adc_bytes": nbytes, "adc_ops": nops}


def check(state, sampled):
    """The index from set-up against the corpus, its training by the shift
    one more Lloyd's step at float64 would give, then the sampled requests'
    answers against the reference's search of the same cells, where a
    query's probe may take any cell within the float32 score's rounding of
    its ``nprobe``-th (``reference/ivf.search_numbers``).  How many sampled
    queries have such cells, and ``rank_gap`` over them and over the
    others, is a line of standard error; it judges nothing."""
    ctx = state["ctx"]
    p = ctx.params
    index, x = state["index"], state["x"]
    cb, coarse = index.pq.codebooks, index.coarse_centroids
    gen = data.generator(ctx.device, ctx.seed, "check_rows")
    rows = data.distinct_rows(gen, x.shape[0], min(p["check_rows"], x.shape[0]))
    with vq.exact_matmul():
        numbers, near = ref_ivf.check_index(x, coarse, cb, index.cell_codes, index.cell_ids,
                                            index.cell_norms)
        numbers.update(ref_ivf.training_shifts(x, coarse, cb, near, rows))
        del near
        q = torch.cat([_queries(state, i) for i, _ in sampled])
        d_prog = torch.cat([out[0] for _, out in sampled]).to(q.device)
        ids_prog = torch.cat([out[1] for _, out in sampled]).to(q.device)
        answered, notes = ref_ivf.search_numbers(q, coarse, cb, index.cell_codes, index.cell_ids,
                                                 x.shape[0], p["nprobe"], p["top_k"], d_prog,
                                                 ids_prog)
    numbers.update(answered)
    print("probe edge: " + ", ".join(f"{k} {v!r}" for k, v in notes.items()), file=sys.stderr)
    return list(numbers.items())
