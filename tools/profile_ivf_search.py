"""Where an IVF-PQ query's time goes, on one GPU.

    python3 tools/profile_ivf_search.py [--n 10000000] [--cells 4096] [--iterations 4]

Builds the index of ``chip_smoke.py``'s ivf phase (benches/ivf10m.py's
shape: clustered rows of d=128 made on the card, a residual PQ of m=16 at 8
bits, ``build_ivf(capacity="auto")``) and prints the card's name and power
limit, then one JSON line for each route and nprobe (8 and 32), 16 queries:

* ``ms``: the whole call, CUDA-event median of 5 after a warm-up: the
  kernel route (``ivf_search``, the ADC-table probe), the decode probe with
  the decode kernel, the plain route (``use_kernel=False``);
* ``stages_ms``: each stage of the probe alone, from the same inputs (CUDA
  events, median of 5): the coarse product and probe selection, then for the
  ADC-table probe the union of the probed cells, the tables, the gather of
  the union's cells, the ADC kernel, the masking and the top-k; for the
  decode probe the gather of the probed cells, the decode, the dot with the
  queries, the scores and the top-k;
* ``profile``: ``torch.profiler`` over 20 calls: the kernels' device time
  summed (``busy_ms``, a call), the window's host time a call
  (``wall_ms``), the idle share ``1 - busy / wall``, kernel launches a call
  and the kernels with the most device time; "not measured" where the
  profiler saw no device time.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import chip_smoke  # noqa: E402  (the ivf phase's corpus and timing)
from reductive_tpu_torch import ivf, ops  # noqa: E402
from reductive_tpu_torch.search import _smallest, adc_tables  # noqa: E402

TOP_K = 10


def lut_stages(index, q, nprobe):
    """The ADC-table probe's stages, each timed alone on its inputs."""
    coarse, codes, ids, norms, pq = (index.coarse_centroids, index.cell_codes, index.cell_ids,
                                     index.cell_norms, index.pq)
    L, mb = codes.shape[1], codes.shape[2]
    nq = q.shape[0]
    qc, score_c, q_sqn = ivf._coarse_scores(q, coarse, "l2")
    probe = _smallest(-score_c, None, nprobe)[1]
    cu = torch.unique(probe)
    tables = adc_tables(pq, q, metric="dot")
    codes_c = codes[cu].reshape(-1, mb)
    ids_c = ids[cu].reshape(-1)
    raw = ops.adc_scores_kernel(tables, codes_c, splits=2).reshape(nq, -1, L)

    def mask():
        sc = q_sqn[:, None, None] + norms[cu].reshape(1, -1, L) + 2.0 * raw - 2.0 * qc[:, cu][:, :, None]
        probed = (probe[:, :, None] == cu[None, None, :]).any(dim=1)
        m = probed[:, :, None] & (ids_c.reshape(1, -1, L) >= 0)
        return torch.where(m, sc, torch.full_like(sc, float("inf"))).reshape(nq, -1)

    sc = mask()
    t = chip_smoke.time_ms
    return {
        "coarse": t(lambda: _smallest(-ivf._coarse_scores(q, coarse, "l2")[1], None, nprobe)),
        "union": t(lambda: torch.unique(probe)),
        "tables": t(lambda: adc_tables(pq, q, metric="dot")),
        "gather": t(lambda: (codes[cu].reshape(-1, mb), ids[cu], norms[cu])),
        "adc": t(lambda: ops.adc_scores_kernel(tables, codes_c, splits=2)),
        "mask": t(mask),
        "topk": t(lambda: ids_c[_smallest(sc, None, TOP_K)[1]]),
        "rows": codes_c.shape[0],
    }


def decode_stages(index, q, nprobe):
    """The decode probe's stages, each timed alone on its inputs."""
    coarse, codes, ids, norms, pq = (index.coarse_centroids, index.cell_codes, index.cell_ids,
                                     index.cell_norms, index.pq)
    cb = pq.codebooks
    nq, d = q.shape
    qc, score_c, q_sqn = ivf._coarse_scores(q, coarse, "l2")
    probe = _smallest(-score_c, None, nprobe)[1]
    qc_g = torch.gather(qc, 1, probe)
    codes_g, ids_g, norms_g = codes[probe], ids[probe], norms[probe]
    flat = codes_g.reshape(-1, codes.shape[2])
    rec = ops.pq_decode(cb, flat, splits=2)
    dot = torch.bmm(rec.reshape(nq, -1, d), q[:, :, None]).reshape(nq, nprobe, -1)

    def scores():
        s = q_sqn[:, None, None] + norms_g - 2.0 * qc_g[:, :, None] - 2.0 * dot
        return torch.where(ids_g >= 0, s, torch.full_like(s, float("inf"))).reshape(nq, -1)

    sc = scores()
    t = chip_smoke.time_ms
    return {
        "coarse": t(lambda: _smallest(-ivf._coarse_scores(q, coarse, "l2")[1], None, nprobe)),
        "gather": t(lambda: (codes[probe], ids[probe], norms[probe])),
        "decode": t(lambda: ops.pq_decode(cb, flat, splits=2)),
        "dot": t(lambda: torch.bmm(rec.reshape(nq, -1, d), q[:, :, None])),
        "scores": t(scores),
        "topk": t(lambda: ivf._padded_topk(sc, ids_g.reshape(nq, -1), TOP_K)),
        "rows": flat.shape[0],
    }


def profiled(fn, calls=20):
    """Device time and launches a call, and the idle share, over ``calls``."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    kernels = []
    for e in prof.key_averages():
        us = getattr(e, "self_device_time_total", None)
        if us is None:
            us = getattr(e, "self_cuda_time_total", 0)
        if e.device_type == torch.autograd.DeviceType.CUDA and us > 0:
            kernels.append((e.key, us, e.count))
    if not kernels:
        return "not measured"
    busy = sum(us for _, us, _ in kernels) / 1e3 / calls
    wall_ms = wall * 1e3 / calls
    kernels.sort(key=lambda k: -k[1])
    return {"busy_ms": busy, "wall_ms": wall_ms, "idle_share": 1 - busy / wall_ms,
            "launches": sum(c for _, _, c in kernels) / calls,
            "top": [{"kernel": k[:80], "ms": us / 1e3 / calls} for k, us, _ in kernels[:8]]}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--n", type=int, default=chip_smoke.IVF_N)
    ap.add_argument("--cells", type=int, default=chip_smoke.IVF_C)
    ap.add_argument("--iterations", type=int, default=chip_smoke.IVF_ITERATIONS)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("profile_ivf_search: needs a CUDA device", file=sys.stderr)
        return 1
    print(chip_smoke.smi(), flush=True)
    ops.build_all()
    gen = torch.Generator(device="cuda").manual_seed(chip_smoke.SEED)
    d = chip_smoke.IVF_D
    x = chip_smoke.clustered_corpus(gen, args.n, d, args.cells)
    q = x[::args.n // 16][:16] + 0.05 * torch.randn((16, d), generator=gen, device="cuda")
    coarse, rpq = ivf.train_ivf_pq(gen, x, args.cells, chip_smoke.IVF_M, chip_smoke.IVF_BITS,
                                   coarse_iterations=args.iterations,
                                   pq_iterations=args.iterations)
    index = ivf.build_ivf(coarse, rpq, x, capacity="auto")
    del x
    torch.cuda.empty_cache()
    args_ = (index.coarse_centroids, index.cell_codes, index.cell_ids, index.cell_norms, rpq)
    for nprobe in (8, 32):
        routes = {
            "kernel_route": (lambda: ivf.ivf_search(index, q, TOP_K, nprobe=nprobe),
                             lambda: lut_stages(index, q, nprobe)),
            "decode_probe": (lambda: ivf._padded_topk(
                *ivf._probe_and_score(q, *args_, nprobe, True, 2), TOP_K),
                lambda: decode_stages(index, q, nprobe)),
            "plain_route": (lambda: ivf.ivf_search(index, q, TOP_K, nprobe=nprobe,
                                                   use_kernel=False), None),
        }
        for name, (call, stages) in routes.items():
            line = {"route": name, "nprobe": nprobe, "n": args.n, "cells": args.cells,
                    "capacity": index.capacity, "ms": chip_smoke.time_ms(call)}
            if stages is not None:
                line["stages_ms"] = stages()
            line["profile"] = profiled(call)
            print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
