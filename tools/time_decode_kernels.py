"""Times of the decode kernels and of search's top-k selection of
``reductive_tpu_torch`` on one GPU.

    python3 tools/time_decode_kernels.py [--against DIR] [--plans]

Prints the card's name and power limit, then one JSON line per measurement
(CUDA-event medians of five after a warm-up, milliseconds):

* ``pq_decode`` (``splits=3`` and ``"int8"``) through the wrapper and its C
  entry alone (the table built outside the timed call), beside
  ``F.embedding`` over the same table (dequantized once for int8) and the
  byte bound (codes and codebook read once, output written once, at 3.35
  TB/s), at every
  ds not a multiple of 4 that the row-tile kernel takes: the reference's
  quality-gate width d=20 (ds 1, 2, 5, 10; k=128) over 4,000,000 rows and
  300-d embeddings (ds 1, 2, 3, 5, 10; k=256) over 2^21 rows; and ``decode``
  at the flagship width (d=128, m=16, k=256, ds=8) over 4,000,000 rows; at
  the row-tile widths also the C entry in each table regime that can hold the
  shape (``regime_ms``: the whole table staged, a group of subquantizers a
  block, the table read from L2; ``plan``: what ``decode_tile_plan`` chose);
* search at the flagship width over 4,000,000 codes: 16 and 128 queries on
  the host clock (each call synchronised), the selection ``_smallest`` alone
  on a 16-query score matrix, and whether the ids of a search over a corpus
  whose k-th place is always tied (every code held by about 1,000 rows)
  equal a stable sort's (``tie_ids_equal_stable_sort``).

With ``--plans`` it times instead, in this checkout alone, the C entry of the
row-tile kernels at d=300, k=256 over 2^21 rows (m=150 and 30) over a grid of plans
(rows a tile by subquantizers a block: the whole table, groups, L2), each plan
twice: how much the time depends on the plan.

With ``--against DIR`` (another checkout of the repository, for example the
parent commit unpacked by ``git archive``) every measurement is also taken
there, in the order other, this, this, other, each in a process of its own
that imports the package of its checkout, so that two versions are compared
on one card in one run.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
PEAK_BYTES = 3.35e12
# (n, m, k, ds)
DECODE_SHAPES = (
    [(4_000_000, 20 // ds, 128, ds) for ds in (1, 2, 5, 10)]
    + [(1 << 21, 300 // ds, 256, ds) for ds in (1, 2, 3, 5, 10)]
    + [(4_000_000, 16, 256, 8)]
)
SEARCH_SHAPE = (4_000_000, 16, 256, 8)


def emit(**fields) -> None:
    print(json.dumps(fields), flush=True)


def time_ms(fn, reps: int = 5) -> float:
    import torch

    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def host_ms(fn, reps: int = 20) -> float:
    import torch

    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def alone(codebooks, codes, splits, out):
    """The C entry alone, on a table built outside the call, in this
    checkout's interface (the parent's decode has no ``launch_decode``: its
    C entry takes the table ``effective_codebook`` or
    ``quantize_codebook_int8`` gives)."""
    import torch
    from reductive_tpu_torch.ops import _build
    from reductive_tpu_torch.ops import decode

    if hasattr(decode, "launch_decode"):
        table = decode.decode_table(codebooks, splits)
        return lambda: decode.launch_decode(table, codes, out)
    m, k, ds = codebooks.shape
    n = codes.shape[0]
    suffix = "" if ds % 4 == 0 else "_scalar"
    stream = torch.cuda.current_stream().cuda_stream
    if splits == "int8":
        w8, scale = decode.quantize_codebook_int8(codebooks)
        return lambda: _build.launch("rt_decode_int8", "decode_int8" + suffix, codes.data_ptr(),
                                     codes.element_size(), 0, w8.data_ptr(), scale.data_ptr(),
                                     out.data_ptr(), n, m, k, ds, stream)
    table = decode.effective_codebook(codebooks, splits)
    return lambda: _build.launch("rt_decode", "decode" + suffix, codes.data_ptr(),
                                 codes.element_size(), 0, table.data_ptr(), out.data_ptr(), n, m,
                                 k, ds, stream)


def regimes(codebooks, codes, splits, out, want):
    """This checkout's row-tile kernels in each table regime that holds the
    shape (the whole table staged, a group of subquantizers a block, the table
    read from L2): ``{"regime_ms": {...}, "plan": ..., "regimes_bit_equal": ...}``,
    empty at a ds that is a multiple of 4 or in a checkout without them."""
    import torch
    from reductive_tpu_torch.ops import decode

    m, k, ds = codebooks.shape
    if ds % 4 == 0 or not hasattr(decode, "decode_group_plan"):
        return {}
    int8 = splits == "int8"
    table = decode.decode_table(codebooks, splits)
    row_bytes = m * codes.element_size()
    plan = decode.decode_tile_plan(m, k, ds, codes.element_size(), False, int8)
    whole_rows = decode._tile_rows(m * ds, row_bytes)
    rows, group = decode.decode_group_plan(m, k, ds, row_bytes, int8)
    plans = {"l2": (whole_rows, 0), "group": (rows, group if group < m else -(-m // 2))}
    if decode.decode_tile_smem(m, k, ds, row_bytes, int8, whole_rows, m) <= 200 * 1024:
        plans["whole"] = (whole_rows, m)
    times, same = {}, True
    for name, p in plans.items():
        def call():
            decode.launch_decode(table, codes, out, plan=p)
        call()
        same = same and bool(torch.equal(out, want))
        times[name] = time_ms(call)
    return {"plan": list(plan), "regime_ms": times, "regimes_bit_equal": same}


def decode_worker(label: str) -> None:
    import torch
    from reductive_tpu_torch import ops
    from reductive_tpu_torch.ops.decode import effective_codebook, quantize_codebook_int8

    gen = torch.Generator(device="cuda").manual_seed(0)
    for n, m, k, ds in DECODE_SHAPES:
        cb = torch.randn((m, k, ds), generator=gen, device="cuda")
        codes = torch.randint(0, k, (n, m), generator=gen, device="cuda", dtype=torch.uint8)
        out = torch.empty((n, m * ds), device="cuda")
        idx = codes.to(torch.int64) + torch.arange(m, device="cuda")[None, :] * k
        nbytes = n * m + 4 * m * k * ds + 4 * n * m * ds  # codes, codebook, output once each
        for splits in (3, "int8"):
            if splits == "int8":
                w8, scale = quantize_codebook_int8(cb)
                table = (w8.to(torch.float32) * scale.reshape(m, 1, ds)).reshape(m * k, ds)
            else:
                table = effective_codebook(cb, 3).reshape(m * k, ds)
            want = ops.pq_decode_reference(cb, codes, splits=splits)
            ok = bool(torch.equal(ops.pq_decode(cb, codes, splits=splits), want))
            emit(checkout=label, shape=f"n={n} d={m * ds} m={m} k={k} ds={ds}", splits=str(splits),
                 bit_equal=ok,
                 ms=time_ms(lambda: ops.pq_decode(cb, codes, splits=splits, out=out)),
                 kernel_ms=time_ms(alone(cb, codes, splits, out)),
                 library_ms=time_ms(lambda: torch.nn.functional.embedding(idx, table)),
                 bound_ms=nbytes / PEAK_BYTES * 1e3, **regimes(cb, codes, splits, out, want))
            del want
        del cb, codes, out, idx, table
        torch.cuda.empty_cache()


def search_worker(label: str) -> None:
    import torch
    from reductive_tpu_torch import Pq, ops
    from reductive_tpu_torch import search as tsearch

    n, m, k, ds = SEARCH_SHAPE
    gen = torch.Generator(device="cuda").manual_seed(1)
    pq = Pq(codebooks=torch.randn((m, k, ds), generator=gen, device="cuda"))
    codes = torch.randint(0, k, (n, m), generator=gen, device="cuda", dtype=torch.uint8)
    q = torch.randn((128, m * ds), generator=gen, device="cuda")
    scores = ops.adc_scores_kernel(tsearch.adc_tables(pq, q[:16]), codes, splits=2)
    # A corpus of 4,000 distinct codes, each held by about 1,000 rows.
    tied = codes[:4000][torch.randint(0, 4000, (n,), generator=gen, device="cuda")]
    tie_scores = ops.adc_scores_kernel(tsearch.adc_tables(pq, q[:16]), tied, splits=2)
    want = torch.sort(tie_scores, dim=1, stable=True).indices[:, :10]
    _, ids = tsearch.search(pq, q[:16], tied, 10)
    _, ids_streamed = tsearch.search(pq, q[:16], tied, 10, stream_chunk=1 << 19)
    emit(checkout=label, shape=f"n={n} d={m * ds} m={m} k={k} top_k=10",
         search_16q_ms=host_ms(lambda: tsearch.search(pq, q[:16], codes, 10)),
         search_128q_ms=host_ms(lambda: tsearch.search(pq, q, codes, 10)),
         smallest_16q_ms=time_ms(lambda: tsearch._smallest(scores, None, 10)),
         topk_16q_ms=time_ms(lambda: torch.topk(scores, 10, dim=1, largest=False)),
         tie_ids_equal_stable_sort=bool(torch.equal(ids, want)),
         tie_ids_equal_stable_sort_streamed=bool(torch.equal(ids_streamed, want)),
         tie_rows_differing=int((ids != want).any(dim=1).sum()))


def plans_worker() -> None:
    """Each plan of a grid at the two d=300 shapes, twice, through the C entry."""
    import torch
    from reductive_tpu_torch.ops import decode

    gen = torch.Generator(device="cuda").manual_seed(0)
    for n, m, k, ds in [s for s in DECODE_SHAPES if s[3] in (2, 10) and s[2] == 256]:
        cb = torch.randn((m, k, ds), generator=gen, device="cuda")
        codes = torch.randint(0, k, (n, m), generator=gen, device="cuda", dtype=torch.uint8)
        out = torch.empty((n, m * ds), device="cuda")
        for splits in (3, "int8"):
            table = decode.decode_table(cb, splits)
            want = decode.pq_decode_reference(cb, codes, splits=splits)
            times = {}
            for rows in (16, 48, 96, 192):
                for group in sorted({m, m // 2, m // 4, m // 5, m // 8, 0}):
                    smem = decode.decode_tile_smem(m, k, ds, m, splits == "int8", rows, group)
                    if smem > 200 * 1024:
                        continue

                    def call():
                        decode.launch_decode(table, codes, out, plan=(rows, group))
                    call()
                    if not torch.equal(out, want):
                        raise SystemExit(f"plan {(rows, group)} is not bit-equal")
                    times[f"{rows}x{group}"] = [time_ms(call), time_ms(call)]
            emit(shape=f"n={n} d={m * ds} m={m} k={k} ds={ds}", splits=str(splits),
                 plan=list(decode.decode_tile_plan(m, k, ds, 1, False, splits == "int8")),
                 plan_ms=times)
            del want
        del cb, codes, out
        torch.cuda.empty_cache()


def worker(label: str) -> None:
    """Times this checkout (the package is imported from the current
    directory)."""
    sys.path.insert(0, str(Path.cwd()))
    from reductive_tpu_torch.ops import _build

    for name in ("decode", "adc"):
        _build.library(name)
    decode_worker(label)
    search_worker(label)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--against", type=Path, help="another checkout to time in turn with this one")
    ap.add_argument("--plans", action="store_true",
                    help="time the row-tile kernels over a grid of plans instead")
    ap.add_argument("--worker", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.worker:
        worker(args.worker)
        return 0
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True).stdout.strip(), flush=True)
    if args.plans:
        sys.path.insert(0, str(ROOT))
        plans_worker()
        return 0
    me = [sys.executable, str(Path(__file__).resolve())]
    turns = [("this", ROOT)]
    if args.against:
        other = args.against.resolve()
        turns = [("other", other), ("this", ROOT), ("this", ROOT), ("other", other)]
    for label, cwd in turns:
        subprocess.run([*me, "--worker", label], cwd=cwd, check=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
