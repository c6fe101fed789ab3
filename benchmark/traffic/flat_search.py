"""Exhaustive PQ search in a closed loop: ``search.search`` over the codes of
the whole corpus, made in set-up by the configuration's quantizer (OPQ
trained on a sample, then ``Pq.quantize_batch(method="kernel")``), one
request after another, by the ADC kernel (``method="kernel"``: its plain
version on the CPU).

Parameters: ``batch`` queries a request, ``top_k``, ``warmup_requests``,
``check_samples`` (requests whose answers the reference checks),
``check_rows`` (rows whose codes it checks).  Controls: ``"splits1"``, the
port's own table path one precision lower (bfloat16 tables, ``splits=1``)
where the configuration states ``splits=2``; ``"fp8"``, the corpus encoded
by the reference with float8 (e4m3) products where it states bfloat16;
``"tf32"``, the program's float32 products in TF32.
"""

from __future__ import annotations

import torch

from benchmark import closed_loop, data, deployments, roofline
from benchmark.reference import answers, flat as ref_flat, vq


def setup(ctx):
    deployments.prepare(ctx)
    deployments.apply_control(ctx, ("splits1", "fp8", "tf32"))
    cfg, p = ctx.config, ctx.params
    x = deployments.corpus(ctx)
    q = deployments.queries(ctx, x)
    ctx.mark("corpus")
    pq = deployments.opq_train(ctx, x)
    ctx.mark("train")
    if ctx.control == "fp8":
        codes = torch.empty((x.shape[0], pq.quantized_len), dtype=torch.uint8, device=x.device)
        for off in range(0, x.shape[0], cfg["encode_batch"]):
            with vq.exact_matmul():
                rows = x[off:off + cfg["encode_batch"]] @ pq.projection
            codes[off:off + cfg["encode_batch"]] = vq.encode_lowp(pq.codebooks, rows,
                                                                  torch.float8_e4m3fn)
    else:
        codes = deployments.encode_all(ctx, pq, x)
    ctx.mark("encode")
    rows = data.distinct_rows(data.generator(ctx.device, ctx.seed, "check_rows"), x.shape[0],
                              min(p["check_rows"], x.shape[0]))
    kept = x[rows].clone()
    del x
    splits = 1 if ctx.control == "splits1" else cfg["table_splits"]
    return {"ctx": ctx, "q": q, "ring": closed_loop.query_ring(q, p["batch"]), "pq": pq,
            "codes": codes, "rows": rows, "kept": kept, "splits": splits}


def _queries(state, i):
    p = state["ctx"].params
    return closed_loop.request(state["ring"], state["q"].shape[0], p["batch"], i)


def step(state, i):
    from reductive_tpu_torch import search

    p = state["ctx"].params
    d, ids = search.search(state["pq"], _queries(state, i), state["codes"], p["top_k"],
                           method="kernel", splits=state["splits"])
    return d.cpu(), ids.cpu()


def warmup(state):
    for i in range(state["ctx"].params["warmup_requests"]):
        step(state, i)


def end_to_end(state, steps, elapsed, latencies):
    return closed_loop.search_metrics(steps, state["ctx"].params["batch"], elapsed, latencies)


def work(state, steps):
    """The ADC work of ``steps`` requests: every code, the tables and the
    answers, and every (query, row) pair scored."""
    p = state["ctx"].params
    pq = state["pq"]
    nbytes, nops = roofline.adc_flat_work(state["codes"].shape[0], p["batch"], pq.n_subquantizers,
                                          pq.n_quantizer_centroids, p["top_k"])
    return {"adc_bytes": steps * nbytes, "adc_ops": steps * nops}


def check(state, sampled):
    """The codes of a sample of rows (``code_gap`` at float64,
    ``code_mismatch`` against the stated arithmetic), then the sampled
    requests' answers against the reference's exhaustive search."""
    p = state["ctx"].params
    pq, codes = state["pq"], state["codes"]
    proj = pq.projection.double()
    kept, held = state.pop("kept"), codes[state["rows"]]
    with vq.exact_matmul():
        numbers = {"code_gap": vq.code_gap(pq.codebooks, kept.double() @ proj, held)}
        differ, total = vq.code_mismatch(pq.codebooks, kept @ pq.projection, held)
        numbers["code_mismatch"] = differ / max(total, 1)
        del kept
        q = torch.cat([_queries(state, i) for i, _ in sampled])
        d_prog = torch.cat([out[0] for _, out in sampled]).to(q.device)
        ids_prog = torch.cat([out[1] for _, out in sampled]).to(q.device)
        q_rot = q.double() @ proj
        t64 = ref_flat.tables(q_rot, pq.codebooks)
        d_ref = ref_flat.search(t64, codes, p["top_k"])
        d_of = ref_flat.dist_of(t64, codes, ids_prog)
        numbers.update(answers.answer_numbers(d_prog, ids_prog, d_ref, d_of,
                                              vq.sq_norms(q_rot)))
    return list(numbers.items())
