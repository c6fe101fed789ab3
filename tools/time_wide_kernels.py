"""Times of ``reductive_tpu_torch``'s assignment at the widths other than 4, 8,
16 and 32 on one GPU: the wide route above ds = 32, the narrow kernels'
padded instances below.

    python3 tools/time_wide_kernels.py [--against DIR]

Prints the card's name and power limit, then one JSON line per measurement
(CUDA-event medians of three after a warm-up, milliseconds):

* the f32, bf16 and verify encode kernels and the f32, bf16 and verified
  statistics at the shapes of ``chip_smoke.py``'s wide phase: k-means at
  d=128, k=4,096 over 2^20 rows and at d=768, k=16,384 over 2^19 rows
  (m = 1; the deep kernel, ``csrc/assign_deep.cuh``), d=20, m=10, k=128
  (ds=2) over 4,000,000 rows, and d=300, k=256 over 2^21 rows at m = 150
  (ds = 2) and 30 (ds = 10) (the narrow kernels' padded instances; the
  shallow kernel before them) and at m = 6 (ds = 50: the shallow kernel);
* builds of ``csrc/encode.cu`` with a part of the deep kernel compiled out
  (made in a temporary copy of ``csrc/``, never in the package), timed
  through the C entry at the two deep shapes: without the products, without
  the TMA loads (the producer still arrives on the barriers), without the
  reading and conversion of the rows in registers, without the selection.
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
SHAPES = [(1 << 20, 1, 4096, 128), (1 << 19, 1, 16384, 768), (4_000_000, 10, 128, 2),
          (1 << 21, 150, 256, 2), (1 << 21, 30, 256, 10), (1 << 21, 6, 256, 50)]
ABLATED_SHAPES = SHAPES[:2]

H = "assign_deep.cuh"
_TMA = ("        for (int b = 0; b < S_::kRowBoxes; ++b)\n"
        "          tma_load(stage + b * kRowBox, &xmap, full + st, c0 + 32 * b, j, (int)row0);\n"
        "        unsigned char* w = stage + S_::kRowBoxes * kRowBox;\n"
        "        tma_load(w, &wmap, full + st, c0, n0, j);\n"
        "        if constexpr (!BF16) tma_load(w + S_::kColBox, &wmap, full + st, c0, n0, m + j);\n")
# name -> [(file under csrc, text that must occur exactly once, its replacement)]
ABLATIONS = {
    "whole": [],
    "no_products": [
        (H, "    for (int ks = 0; ks < 4; ++ks) mma_bf16_n256(",
         "    for (int ks = 0; ks < 4 * (c == 0x7fffffff); ++ks) mma_bf16_n256("),
        (H, "    for (int ks = 0; ks < 4; ++ks) mma_tf32_n128(acc, f.a[1][ks], dh + 2 * ks, ks > 0);",
         "    for (int ks = 0; ks < 4 * (c == 0x7fffffff); ++ks) mma_tf32_n128(acc, f.a[1][ks], dh + 2 * ks, ks > 0);"),
        (H, "    for (int ks = 0; ks < 4; ++ks) mma_tf32_n128(acc, f.a[0][ks], dl + 2 * ks, 1);",
         "    for (int ks = 0; ks < 4 * (c == 0x7fffffff); ++ks) mma_tf32_n128(acc, f.a[0][ks], dl + 2 * ks, 1);"),
        (H, "    for (int ks = 0; ks < 4; ++ks) mma_tf32_n128(acc, f.a[0][ks], dh + 2 * ks, 1);",
         "    for (int ks = 0; ks < 4 * (c == 0x7fffffff); ++ks) mma_tf32_n128(acc, f.a[0][ks], dh + 2 * ks, 1);"),
    ],
    "no_tma_loads": [
        (H, "        bar_expect(full + st, S_::kStage);\n", "        bar_arrive(full + st);\n"),
        (H, "#pragma unroll\n" + _TMA, ""),
    ],
    "no_row_conversion": [
        (H, "        f.a[0][ks][h] = pack_bf16(*reinterpret_cast<const float2*>(box + swizzled(r, col)));\n"
            "        f.a[0][ks][2 + h] = pack_bf16(*reinterpret_cast<const float2*>(box + swizzled(r, col + 8)));",
         "        f.a[0][ks][h] = 0x3f803f80u + (uint32_t)(box - stage) + r;\n"
         "        f.a[0][ks][2 + h] = 0x3f803f80u + (uint32_t)col;"),
        (H, "        const float v = *reinterpret_cast<const float*>(\n"
            "            stage + swizzled(rbase + 8 * (i & 1), 8 * ks + t + 4 * (i >> 1)));",
         "        const float v = 1.0f + (float)(rbase + i);\n"
         "        f.a[0][ks][i] = __float_as_uint(v);\n"
         "        f.a[1][ks][i] = 0u;\n"
         "        continue;"),
    ],
    "no_select": [
        (H, "    pick.take(0, nn.x - p[4 * i + 0], nn.y - p[4 * i + 1], n0 + 8 * i);\n"
            "    pick.take(1, nn.x - p[4 * i + 2], nn.y - p[4 * i + 3], n0 + 8 * i);",
         "    if (p[4 * i] + p[4 * i + 1] + p[4 * i + 2] + p[4 * i + 3] + nn.x + nn.y == 1.2345f)\n"
         "      pick.take(0, 0.f, 0.f, 0);"),
    ],
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
    current directory)."""
    sys.path.insert(0, str(Path.cwd()))
    import torch
    from reductive_tpu_torch import ops
    from reductive_tpu_torch.ops.assign import pq_encode_verify_flags
    from reductive_tpu_torch.ops.stats import pq_assign_stats_verify_flags

    ops.build_all()
    f32, bf16, i32 = torch.float32, torch.bfloat16, torch.int32
    for n, m, k, ds in SHAPES:
        cb, x = make(n, m, k, ds)
        ops.reset_launch_counts()
        emit(checkout=label, shape=f"n={n} d={m * ds} m={m} k={k} ds={ds}",
             encode_f32=time_ms(lambda: ops.pq_encode(cb, x, dtype=i32, compute_dtype=f32)),
             encode_bf16=time_ms(lambda: ops.pq_encode(cb, x, dtype=i32, compute_dtype=bf16)),
             encode_verify_kernel=time_ms(lambda: pq_encode_verify_flags(cb, x, dtype=i32)),
             stats_f32=time_ms(lambda: ops.pq_assign_stats(cb, x)),
             stats_bf16=time_ms(lambda: ops.pq_assign_stats(cb, x, compute_dtype=bf16)),
             stats_verify_kernel=time_ms(lambda: pq_assign_stats_verify_flags(cb, x)),
             flag_rate=float(pq_encode_verify_flags(cb, x, dtype=i32)[1].float().mean()),
             kernels=sorted(ops.launch_counts()))
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
        for name, swaps in ABLATIONS.items():
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
                                            str(work / "libencode.so"), str(work / "encode.cu")])
        for name, proc in procs.items():
            if proc.wait() != 0:
                raise SystemExit(f"{name}: nvcc failed for encode.cu")
        stream = torch.cuda.current_stream().cuda_stream
        for n, m, k, ds in ABLATED_SHAPES:
            cb, x = make(n, m, k, ds)
            codes = torch.empty((n, m), dtype=torch.int32, device="cuda")
            for bf16 in (0, 1):
                cd = torch.bfloat16 if bf16 else torch.float32
                w, norms = deep_operands(*_prepare(cb, x, torch.int32, cd), cd)
                times = {}
                for name in ABLATIONS:
                    fn = ctypes.CDLL(str(Path(tmp) / name / "libencode.so")).rt_encode
                    fn.argtypes = list(_build._ENTRIES["rt_encode"][1])
                    fn.restype = ctypes.c_int
                    args = (x.data_ptr(), w.data_ptr(), norms.data_ptr(), codes.data_ptr(),
                            n, m, k, ds, bf16, 0, 1, stream)

                    def call():
                        rc = fn(*args)
                        if rc != 0:
                            raise SystemExit(f"{name}: rt_encode returned {rc}")

                    times[name] = time_ms(call)
                emit(shape=f"n={n} d={m * ds} m={m} k={k} ds={ds}",
                     kernel="encode_bf16_wide" if bf16 else "encode_f32_wide", ablated_ms=times)
                del w, norms
            del cb, x, codes
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
