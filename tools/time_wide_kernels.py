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
  persistent grid; ``csrc/stats.cu``'s ``assign_stats_wide`` at every wide
  statistics shape without the chunk sums (the accumulation's sums of the
  rows and of the chunks), without the radix sort and the chunk sums, and
  with twice and half the rows a warp of the chunk kernel has in flight.
  Such a build's results are wrong by design; only its time is read, and the
  differences are those parts' shares (they overlap).  The text each build
  replaces must occur exactly once in its file, or the tool stops;
* the accumulation from the codes alone (``rt_cell_stats``) at every wide
  statistics shape, on the f32 and on the bf16 assignment's codes, with its
  byte bound and the largest cell's share of the rows; with ``--against``
  also the other checkout's accumulation on the same codes (its
  ``rt_assign_stats_wide`` built with the assignment compiled out), in the
  order other, this, this, other.

With ``--against DIR`` (another checkout of the repository, for example the
parent commit unpacked by ``git archive``) the first group is also timed
there, in the order other, this, this, other, each in a process of its own
that imports the package of its checkout, so that two versions are compared
on one card in one run.
"""

from __future__ import annotations

import argparse
import ctypes
import importlib.util
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
STATS_SHAPES = [shape for shape in SHAPES if shape[3] > 32]  # the wide route's

H = "assign_deep.cuh"
_TMA = ("          tma_load(stage, &wmap, full + st, c0, n0, j);\n"
        "          if constexpr (!BF16) tma_load(stage + S_::kColBox, &wmap, full + st, c0, n0, m + j);\n"
        "          if constexpr (kTma) {\n"
        "#pragma unroll\n"
        "            for (int b = 0; b < S_::kRowBoxes; ++b)\n"
        "              tma_load(rows + b * R_::kRowBox, &xmap, full + st, (off + j * ds + c0 + 32 * b) & ~3,\n"
        "                       (int)row0);\n"
        "          }\n")
# The accumulation's sums (csrc/stats.cu cells::cell_stats): the chunk sums
# and the chunks' partials added per cell.
_SUMS = [("stats.cu", "  switch (V) {\n", "  if (V == 0x7fffffff) switch (V) {\n"),
         ("stats.cu", "  cell_sums_kernel<<<", "  if (total < 0) cell_sums_kernel<<<")]
_SORT = ("stats.cu", "  for (int pass = 0; pass < l.passes; ++pass) {\n",
         "  for (int pass = 0; pass < 0 * l.passes; ++pass) {\n")
# The chunk kernel's rows in flight a warp (U, by column vectors a lane L).
_U = "  constexpr int U = L == 1 ? 8 : (L == 2 ? 4 : (L == 3 ? 3 : 2));\n"
# Another checkout's wide statistics with the assignment compiled out: its
# accumulation alone, on codes given.
_NO_ASSIGN = ("stats.cu",
              "  cudaError_t err = assign_wide::launch(x, cb2, csqn, {codes, 1, n, 0}, mode == 1, mode == 2,\n"
              "                                        escale, rho, flags, n, m, k, ds, deep, s);\n",
              "  cudaError_t err = cudaSuccess;\n")
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
    "stats_no_sums": ("stats", _SUMS),
    "stats_no_sort_sums": ("stats", [*_SUMS, _SORT]),
    "stats_twice_the_rows_in_flight": ("stats", [
        ("stats.cu", _U, "  constexpr int U = L == 1 ? 16 : (L == 2 ? 8 : (L == 3 ? 5 : 4));\n")]),
    "stats_half_the_rows_in_flight": ("stats", [
        ("stats.cu", _U, "  constexpr int U = L == 1 ? 4 : (L == 2 ? 2 : (L == 3 ? 2 : 1));\n")]),
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


def _entries(checkout: Path) -> dict:
    """The C entries' signatures as ``checkout``'s ``ops/_build.py`` declares
    them (a file of the standard library's imports only)."""
    spec = importlib.util.spec_from_file_location(
        "_other_build", checkout / "reductive_tpu_torch" / "ops" / "_build.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module._ENTRIES


def ablated(other: Path | None) -> None:
    sys.path.insert(0, str(ROOT))
    import torch
    from reductive_tpu_torch import ops
    from reductive_tpu_torch.ops import _build
    from reductive_tpu_torch.ops.assign import _prepare, deep_operands

    builds = {name: (source, swaps, ROOT) for name, (source, swaps) in ABLATIONS.items()}
    if other is not None:
        builds["other_accumulation"] = ("stats", [_NO_ASSIGN], other)
    with tempfile.TemporaryDirectory() as tmp:
        procs = {}
        for name, (source, swaps, checkout) in builds.items():
            work = Path(tmp) / name
            work.mkdir()
            csrc = checkout / "reductive_tpu_torch" / "csrc"
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
                raise SystemExit(f"{name}: nvcc failed for {builds[name][0]}.cu")

        def entry(name, fn_name, entries=_build._ENTRIES, check=True):
            fn = getattr(ctypes.CDLL(str(Path(tmp) / name / f"lib{builds[name][0]}.so")), fn_name)
            fn.argtypes = list(entries[fn_name][1])
            fn.restype = entries[fn_name][2] if len(entries[fn_name]) > 2 else ctypes.c_int

            def call(*args):
                rc = fn(*args)
                if check and rc != 0:
                    raise SystemExit(f"{name}: {fn_name} returned {rc}")
                return rc
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
        if other is not None:
            theirs = _entries(other)
            their_stage = entry("other_accumulation", "rt_assign_stats_wide", theirs)
            their_words = entry("other_accumulation", "rt_assign_stats_wide_scratch", theirs, False)
        for n, m, k, ds in STATS_SHAPES:
            shape = f"n={n} d={m * ds} m={m} k={k} ds={ds}"
            cb, x = make(n, m, k, ds)
            scratch = torch.empty((_build.query("rt_assign_stats_wide_scratch", n, m, k, ds),),
                                  dtype=torch.int32, device="cuda")
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
                emit(shape=shape, kernel="stats_bf16_wide" if mode else "stats_f32_wide",
                     ablated_ms=times)
                del w, norms
                # The accumulation alone on this assignment's codes: this checkout's
                # C entry, and with --against the other's, in turns.
                mine = ops.pq_encode(cb, x, dtype=torch.int32, compute_dtype=cd).T.contiguous()
                alone = {"this": lambda: _build.launch(
                    "rt_cell_stats", None, mine.data_ptr(), x.data_ptr(), scratch.data_ptr(),
                    sums.data_ptr(), counts.data_ptr(), n, m, k, ds, mode, stream)}
                if other is not None:
                    arity = len(theirs["rt_assign_stats_wide_scratch"][1])  # (n, m, k[, ds])
                    other_scratch = torch.empty((their_words(*(n, m, k, ds)[:arity]),),
                                                dtype=torch.int32, device="cuda")
                    alone["other"] = lambda: their_stage(
                        x.data_ptr(), None, None, mine.data_ptr(), None, 0.0, None,
                        other_scratch.data_ptr(), sums.data_ptr(), counts.data_ptr(), n, m, k, ds,
                        mode, 1, stream)
                turns = ("other", "this", "this", "other") if other is not None else ("this", "this")
                stage = {label: [] for label in alone}
                for label in turns:
                    stage[label].append(time_ms(alone[label]))
                share = float(torch.stack([torch.bincount(row, minlength=k) for row in mine]).max()) / n
                emit(shape=shape, kernel="cell_stats", codes="bf16" if mode else "f32",
                     accumulation_ms=stage, largest_cell_share=share,
                     bound_ms=(4 * n * m + 4 * n * m * ds + 4 * m * k * (ds + 1)) / 3.35e9)
                del mine, alone
                if other is not None:
                    del other_scratch
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
    ablated(args.against.resolve() if args.against else None)
    return 0


if __name__ == "__main__":
    sys.exit(main())
