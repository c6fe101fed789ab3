"""Times of ``reductive_tpu_torch``'s assignment at the widths other than 4, 8,
16 and 32 on one GPU: the deep kernel above ds = 32, the narrow kernels'
padded instances below.

    python3 tools/time_wide_kernels.py [--against DIR]

Prints the card's name and power limit, then one JSON line per measurement
(CUDA-event medians of three after a warm-up, milliseconds):

* the f32, bf16 and verify encode kernels and the f32, bf16 and verified
  statistics at the shapes of ``chip_smoke.py``'s wide phase: k-means at
  d=128, k=4,096 over 2^20 rows, at d=768, k=16,384 over 2^19 rows and at
  d=50, k=4,096 over 2^20 rows (GloVe-50; m = 1, the deep kernel,
  ``csrc/assign_deep.cuh``, its rows by TMA, and by cp.async at d=50), d=20,
  m=10, k=128 (ds=2) over 4,000,000 rows, and d=300, k=256 over 2^21 rows at
  m = 150 (ds = 2) and 30 (ds = 10) (the narrow kernels' padded instances)
  and at m = 6, 4 and 2 (ds = 50, 75 and 150: the deep kernel); above ds = 32
  also whether the shallow kernel (``csrc/assign_wide.cuh``, forced by
  patching ``ops.assign.assign_route``) gives the same codes and flags;
* builds with a part compiled out (made in a temporary copy of ``csrc/``,
  never in the package), timed through the C entry: ``csrc/encode.cu``'s
  deep kernel at the two IVF shapes, d300_m6 and GloVe-50 without the
  products, without the TMA loads (the producer still arrives on the
  barriers), without the reading and conversion of the rows in registers,
  without the selection, and with one row tile a block instead of the
  persistent grid; ``csrc/stats.cu``'s ``assign_stats_wide`` at d300_m6
  without the segment sums, and without the radix sort and the segment sums.
  Such a build's results are wrong by design; only its time is read, and the
  differences are those parts' shares (they overlap).

With ``--against DIR`` (another checkout of the repository, for example the
parent commit unpacked by ``git archive``) the first group is also timed
there, in the order other, this, this, other, each in a process of its own
that imports the package of its checkout, so that two versions are compared
on one card in one run.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import statistics
import subprocess
import sys
import tempfile
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
SHAPES = [(1 << 20, 1, 4096, 128), (1 << 19, 1, 16384, 768), (1 << 20, 1, 4096, 50),
          (4_000_000, 10, 128, 2), (1 << 21, 150, 256, 2), (1 << 21, 30, 256, 10),
          (1 << 21, 6, 256, 50), (1 << 21, 4, 256, 75), (1 << 21, 2, 256, 150)]
ABLATED_SHAPES = [SHAPES[i] for i in (0, 1, 2, 6)]
STATS_SHAPES = [SHAPES[6]]

H = "assign_deep.cuh"
_TMA = ("          tma_load(stage, &wmap, full + st, c0, n0, j);\n"
        "          if constexpr (!BF16) tma_load(stage + S_::kColBox, &wmap, full + st, c0, n0, m + j);\n"
        "          if constexpr (kTma) {\n"
        "#pragma unroll\n"
        "            for (int b = 0; b < S_::kRowBoxes; ++b)\n"
        "              tma_load(rows + b * R_::kRowBox, &xmap, full + st, (off + j * ds + c0 + 32 * b) & ~3,\n"
        "                       (int)row0);\n"
        "          }\n")
_SUMS = ("  segment_sums_kernel<<<(unsigned)C, kThreads, 0, s>>>(x, rows[(passes - 1) & 1], start, sums,\n"
         "                                                       counts, m, k, ds, mode == 1);\n")
# name -> (source, [(file under csrc, text that must occur exactly once, its replacement)])
ABLATIONS = {
    "whole": ("encode", []),
    "no_products": ("encode", [
        (H, "    for (int ks = 0; ks < 4; ++ks) mma_bf16_n256(",
         "    for (int ks = 0; ks < 4 * (c == 0x7fffffff); ++ks) mma_bf16_n256("),
        (H, "    for (int ks = 0; ks < 4; ++ks) mma_tf32_n128(acc, f.a[1][ks], dh + 2 * ks, ks > 0);",
         "    for (int ks = 0; ks < 4 * (c == 0x7fffffff); ++ks) mma_tf32_n128(acc, f.a[1][ks], dh + 2 * ks, ks > 0);"),
        (H, "    for (int ks = 0; ks < 4; ++ks) mma_tf32_n128(acc, f.a[0][ks], dl + 2 * ks, 1);",
         "    for (int ks = 0; ks < 4 * (c == 0x7fffffff); ++ks) mma_tf32_n128(acc, f.a[0][ks], dl + 2 * ks, 1);"),
        (H, "    for (int ks = 0; ks < 4; ++ks) mma_tf32_n128(acc, f.a[0][ks], dh + 2 * ks, 1);",
         "    for (int ks = 0; ks < 4 * (c == 0x7fffffff); ++ks) mma_tf32_n128(acc, f.a[0][ks], dh + 2 * ks, 1);"),
    ]),
    "no_tma_loads": ("encode", [
        (H, "          bar_expect(full + st, kTma ? R_::kStage : S_::kColBoxes * S_::kColBox);\n",
         "          bar_arrive(full + st);\n"),
        (H, _TMA, ""),
    ]),
    "no_row_conversion": ("encode", [
        (H, "        f.a[0][ks][h] = pack_bf16(MASK ? masked(lo, at, lim) : lo);\n"
            "        f.a[0][ks][2 + h] = pack_bf16(MASK ? masked(hi, at + 8, lim) : hi);",
         "        f.a[0][ks][h] = 0x3f803f80u + (uint32_t)(box - stage) + r;\n"
         "        f.a[0][ks][2 + h] = 0x3f803f80u + (uint32_t)at;"),
        (H, "        float v = row_value<ROWS>(rows, rbase + 8 * (i & 1), sh + col);\n"
            "        if constexpr (MASK) v = masked(v, col, lim);",
         "        const float v = 1.0f + (float)(rbase + i);\n"
         "        f.a[0][ks][i] = __float_as_uint(v);\n"
         "        f.a[1][ks][i] = 0u;\n"
         "        continue;"),
    ]),
    "no_select": ("encode", [
        (H, "    pick.take(0, nn.x - p[4 * i + 0], nn.y - p[4 * i + 1], n0 + 8 * i);\n"
            "    pick.take(1, nn.x - p[4 * i + 2], nn.y - p[4 * i + 3], n0 + 8 * i);",
         "    if (p[4 * i] + p[4 * i + 1] + p[4 * i + 2] + p[4 * i + 3] + nn.x + nn.y == 1.2345f)\n"
         "      pick.take(0, 0.f, 0.f, 0);"),
    ]),
    "one_tile_a_block": ("encode", [
        (H, "  if ((err = tile_blocks(kern, R_::kBytes, m, (n + kRows - 1) / kRows, P)) != cudaSuccess) return err;\n",
         "  if ((err = tile_blocks(kern, R_::kBytes, m, (n + kRows - 1) / kRows, P)) != cudaSuccess) return err;\n"
         "  P = (n + kRows - 1) / kRows;\n"),
    ]),
    "stats_whole": ("stats", []),
    "stats_no_sums": ("stats", [("stats.cu", _SUMS, "")]),
    "stats_no_sort_sums": ("stats", [
        ("stats.cu", _SUMS, ""),
        ("stats.cu", "  for (int p = 0; p < passes; ++p) {\n", "  for (int p = 0; p < 0 * passes; ++p) {\n"),
    ]),
}


def emit(**fields) -> None:
    print(json.dumps(fields), flush=True)


def time_ms(fn, reps: int = 3) -> float:
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


def make(n, m, k, ds):
    import torch

    gen = torch.Generator(device="cuda").manual_seed(0)
    x = torch.randn((n, m * ds), generator=gen, device="cuda")
    cb = torch.randn((m, k, ds), generator=gen, device="cuda")
    return cb, x


def worker(label: str) -> None:
    """Times this checkout's wide kernels (the package is imported from the
    current directory), and above ds = 32 holds them to the shallow kernel."""
    sys.path.insert(0, str(Path.cwd()))
    import torch
    from reductive_tpu_torch import ops
    from reductive_tpu_torch.ops import assign
    from reductive_tpu_torch.ops.assign import pq_encode_verify_flags
    from reductive_tpu_torch.ops.stats import pq_assign_stats_verify_flags

    ops.build_all()
    f32, bf16, i32 = torch.float32, torch.bfloat16, torch.int32
    for n, m, k, ds in SHAPES:
        cb, x = make(n, m, k, ds)
        ops.reset_launch_counts()
        fields = dict(
            encode_f32=time_ms(lambda: ops.pq_encode(cb, x, dtype=i32, compute_dtype=f32)),
            encode_bf16=time_ms(lambda: ops.pq_encode(cb, x, dtype=i32, compute_dtype=bf16)),
            encode_verify_kernel=time_ms(lambda: pq_encode_verify_flags(cb, x, dtype=i32)),
            stats_f32=time_ms(lambda: ops.pq_assign_stats(cb, x)),
            stats_bf16=time_ms(lambda: ops.pq_assign_stats(cb, x, compute_dtype=bf16)),
            stats_verify_kernel=time_ms(lambda: pq_assign_stats_verify_flags(cb, x)),
            flag_rate=float(pq_encode_verify_flags(cb, x, dtype=i32)[1].float().mean()),
            kernels=sorted(ops.launch_counts()))
        if ds > 32:  # the same codes and flags from the shallow kernel, forced
            def codes():
                return (ops.pq_encode(cb, x, dtype=i32, compute_dtype=f32),
                        ops.pq_encode(cb, x, dtype=i32, compute_dtype=bf16),
                        *pq_encode_verify_flags(cb, x, dtype=i32))
            mine = codes()
            route = assign.assign_route
            assign.assign_route = lambda ds, aligned: "shallow"
            try:
                theirs = codes()
            finally:
                assign.assign_route = route
            fields["differ_from_shallow"] = dict(zip(
                ("encode_f32", "encode_bf16", "verify_codes", "verify_flags"),
                (int((a != b).sum()) for a, b in zip(mine, theirs))))
            del mine, theirs
        emit(checkout=label, shape=f"n={n} d={m * ds} m={m} k={k} ds={ds}", **fields)
        del cb, x
        torch.cuda.empty_cache()


def ablated() -> None:
    sys.path.insert(0, str(ROOT))
    import torch
    from reductive_tpu_torch.ops import _build
    from reductive_tpu_torch.ops.assign import _prepare, deep_operands

    csrc = ROOT / "reductive_tpu_torch" / "csrc"
    with tempfile.TemporaryDirectory() as tmp:
        procs = {}
        for name, (source, swaps) in ABLATIONS.items():
            work = Path(tmp) / name
            work.mkdir()
            for src in list(csrc.glob("*.cu")) + list(csrc.glob("*.cuh")):
                text = src.read_text()
                for file, old, new in swaps:
                    if src.name == file:
                        if text.count(old) != 1:
                            raise SystemExit(f"{name}: the text to replace is not in {file} exactly once")
                        text = text.replace(old, new)
                (work / src.name).write_text(text)
            procs[name] = subprocess.Popen([_build._nvcc(), *_build._NVCC_FLAGS, "-I", str(work), "-o",
                                            str(work / f"lib{source}.so"), str(work / f"{source}.cu")])
        for name, proc in procs.items():
            if proc.wait() != 0:
                raise SystemExit(f"{name}: nvcc failed for {ABLATIONS[name][0]}.cu")

        def entry(name, fn_name):
            fn = getattr(ctypes.CDLL(str(Path(tmp) / name / f"lib{ABLATIONS[name][0]}.so")), fn_name)
            fn.argtypes = list(_build._ENTRIES[fn_name][1])
            fn.restype = _build._ENTRIES[fn_name][2] if len(_build._ENTRIES[fn_name]) > 2 else ctypes.c_int

            def call(*args):
                rc = fn(*args)
                if rc != 0:
                    raise SystemExit(f"{name}: {fn_name} returned {rc}")
            return call

        stream = torch.cuda.current_stream().cuda_stream
        encode_builds = [name for name, (source, _) in ABLATIONS.items() if source == "encode"]
        encode = {name: entry(name, "rt_encode") for name in encode_builds}
        for n, m, k, ds in ABLATED_SHAPES:
            cb, x = make(n, m, k, ds)
            codes = torch.empty((n, m), dtype=torch.int32, device="cuda")
            for bf16 in (0, 1):
                cd = torch.bfloat16 if bf16 else torch.float32
                w, norms = deep_operands(*_prepare(cb, x, torch.int32, cd), cd)
                args = (x.data_ptr(), w.data_ptr(), norms.data_ptr(), codes.data_ptr(),
                        n, m, k, ds, bf16, 0, 1, stream)
                times = {name: time_ms(lambda: encode[name](*args)) for name in encode_builds}
                emit(shape=f"n={n} d={m * ds} m={m} k={k} ds={ds}",
                     kernel="encode_bf16_wide" if bf16 else "encode_f32_wide", ablated_ms=times)
                del w, norms
            del cb, x, codes
            torch.cuda.empty_cache()
        stats_builds = [name for name, (source, _) in ABLATIONS.items() if source == "stats"]
        stats = {name: entry(name, "rt_assign_stats_wide") for name in stats_builds}
        for n, m, k, ds in STATS_SHAPES:
            cb, x = make(n, m, k, ds)
            words = _build.query("rt_assign_stats_wide_scratch", n, m, k)
            scratch = torch.empty((words,), dtype=torch.int32, device="cuda")
            codes = torch.empty((m, n), dtype=torch.int32, device="cuda")
            sums = torch.empty((m, k, ds), device="cuda")
            counts = torch.empty((m, k), device="cuda")
            for mode in (0, 1):
                cd = torch.bfloat16 if mode else torch.float32
                w, norms = deep_operands(*_prepare(cb, x, torch.int32, cd), cd)
                args = (x.data_ptr(), w.data_ptr(), norms.data_ptr(), codes.data_ptr(), None, 0.0,
                        None, scratch.data_ptr(), sums.data_ptr(), counts.data_ptr(), n, m, k, ds,
                        mode, 1, stream)
                times = {name: time_ms(lambda: stats[name](*args)) for name in stats_builds}
                emit(shape=f"n={n} d={m * ds} m={m} k={k} ds={ds}",
                     kernel="stats_bf16_wide" if mode else "stats_f32_wide", ablated_ms=times)
                del w, norms
            del cb, x, scratch, codes, sums, counts
            torch.cuda.empty_cache()


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--against", type=Path, help="another checkout to time in turn with this one")
    ap.add_argument("--worker", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.worker:
        worker(args.worker)
        return 0
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True).stdout.strip(), flush=True)
    me = [sys.executable, str(Path(__file__).resolve())]
    turns = [("this", ROOT)]
    if args.against:
        other = args.against.resolve()
        turns = [("other", other), ("this", ROOT), ("this", ROOT), ("other", other)]
    for label, cwd in turns:
        subprocess.run([*me, "--worker", label], cwd=cwd, check=True)
    ablated()
    return 0


if __name__ == "__main__":
    sys.exit(main())
