"""Times of the wide route of ``reductive_tpu_torch`` (every subvector width
outside 4, 8, 16, 32) on one GPU.

    python3 tools/time_wide_kernels.py

Prints the card's name and power limit, then one JSON line per measurement
(CUDA-event medians of three after a warm-up, milliseconds):

* the f32, bf16 and verify encode kernels and the f32 statistics at the
  shapes of ``chip_smoke.py``'s wide phase: k-means at d=128, k=4,096 over
  2^20 rows and at d=768, k=16,384 over 2^19 rows (m = 1), and d=20, m=10,
  k=128 (ds=2) over 4,000,000 rows;
* builds of ``csrc/encode.cu`` with a part of ``csrc/assign_wide.cuh``
  compiled out (made in a temporary copy of ``csrc/``, never in the
  package), timed through the C entry at the first and last shape: without
  the products, without the split into the operand buffers, without the
  copies from global memory, without the proxy fence, without the
  selection.  Such a build's results are wrong by design; only its time is
  read, and the differences are those parts' shares (they overlap).
"""

from __future__ import annotations

import ctypes
import json
import statistics
import subprocess
import sys
import tempfile
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
SHAPES = [(1 << 20, 1, 4096, 128), (1 << 19, 1, 16384, 768), (4_000_000, 10, 128, 2)]
ABLATED_SHAPES = [SHAPES[0], SHAPES[2]]

H = "assign_wide.cuh"
# name -> [(file under csrc, text that must occur exactly once, its replacement)]
ABLATIONS = {
    "whole": [],
    "no_products": [(H, "    assign_tile::wgmma_fence();\n    if constexpr (BF16) {",
                     "    assign_tile::wgmma_fence();\n    if (s == 0x7fffffff) {\n    } else if constexpr (BF16) {")],
    "no_split_stores": [(H, "      store(s + 1, rows_move, false);\n",
                         "      if (s == 0x7fffffff) store(s + 1, rows_move, false);\n")],
    "no_copies": [(H, "    if (s + kStages - 1 < steps) load(s + kStages - 1, rows_move);\n", "")],
    "no_fence": [(H, '    asm volatile("fence.proxy.async.shared::cta;\\n" ::: "memory");\n  };',
                  "  };")],
    "no_select": [(H, "        pick.take(0, nn.x - p[4 * i + 0], nn.y - p[4 * i + 1], n0 + 8 * i);\n"
                      "        pick.take(1, nn.x - p[4 * i + 2], nn.y - p[4 * i + 3], n0 + 8 * i);",
                   "        if (p[4 * i] + p[4 * i + 1] + p[4 * i + 2] + p[4 * i + 3] + nn.x + nn.y == 1.2345f)\n"
                   "          pick.take(0, 0.f, 0.f, 0);")],
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


def whole() -> None:
    import torch
    from reductive_tpu_torch import ops
    from reductive_tpu_torch.ops.assign import pq_encode_verify_flags

    f32, bf16, i32 = torch.float32, torch.bfloat16, torch.int32
    for n, m, k, ds in SHAPES:
        cb, x = make(n, m, k, ds)
        emit(shape=f"n={n} d={m * ds} m={m} k={k} ds={ds}",
             encode_f32_wide=time_ms(lambda: ops.pq_encode(cb, x, dtype=i32, compute_dtype=f32)),
             encode_bf16_wide=time_ms(lambda: ops.pq_encode(cb, x, dtype=i32, compute_dtype=bf16)),
             encode_verify_wide_kernel=time_ms(lambda: pq_encode_verify_flags(cb, x, dtype=i32)),
             stats_f32_wide=time_ms(lambda: ops.pq_assign_stats(cb, x)))
        del cb, x
        torch.cuda.empty_cache()


def ablated() -> None:
    import torch
    from reductive_tpu_torch.ops import _build
    from reductive_tpu_torch.ops.assign import _prepare

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
                cb2, c_sqn = _prepare(cb, x, torch.int32, torch.bfloat16 if bf16 else torch.float32)
                times = {}
                for name in ABLATIONS:
                    fn = ctypes.CDLL(str(Path(tmp) / name / "libencode.so")).rt_encode
                    fn.argtypes = list(_build._ENTRIES["rt_encode"][1])
                    fn.restype = ctypes.c_int
                    args = (x.data_ptr(), cb2.data_ptr(), c_sqn.data_ptr(), codes.data_ptr(),
                            n, m, k, ds, bf16, 0, stream)

                    def call():
                        rc = fn(*args)
                        if rc != 0:
                            raise SystemExit(f"{name}: rt_encode returned {rc}")

                    times[name] = time_ms(call)
                emit(shape=f"n={n} d={m * ds} m={m} k={k} ds={ds}",
                     kernel="encode_bf16_wide" if bf16 else "encode_f32_wide", ablated_ms=times)
            del cb, x, codes
            torch.cuda.empty_cache()


def main() -> int:
    sys.path.insert(0, str(ROOT))
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True).stdout.strip(), flush=True)
    whole()
    ablated()
    return 0


if __name__ == "__main__":
    sys.exit(main())
