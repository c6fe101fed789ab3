"""Times of the assign+statistics and f32 encode kernels of
``reductive_tpu_torch`` on one GPU.

    python3 tools/time_stats_kernels.py [--against DIR] [--n ROWS]

Prints one JSON line per measurement (CUDA-event medians after a warm-up,
milliseconds) and, first, the card's name and power limit:

* ``stats_f32``, ``stats_bf16`` and ``stats_verify`` (kernel alone and whole
  wrapper), ``encode_f32`` and ``encode_bf16`` (uint8 and int32 codes) and
  ``encode_verify`` (kernel alone and whole wrapper) at the flagship width
  d=128, m=16, k=256, ds=8 over ``--n`` rows (4,000,000), and at the shapes
  ``chip_smoke.py``'s kernels phase compares; at the flagship shape also the
  C entries of ``encode_bf16`` and ``stats_bf16`` alone, the operands
  prepared outside (``*_kernel``);
* a sweep over k and over ds, whose slope in k is the assignment (products and
  selection) and whose intercept is loads, staging and, for the statistics,
  accumulation;
* builds of ``csrc/stats.cu`` and ``csrc/encode.cu`` with a part compiled out
  (made in a temporary copy of ``csrc/``, never in the package), timed
  through the C entries of both modes at the flagship shape and at the
  reference's quality-gate width (d=20, m=10, k=128, ds=2: the padded
  instance of ds = 4) over the same rows: without the
  accumulation, without the encode's code writes, with the selection cut to
  its running minimum, with one of the split's three products, with one
  block on an SM and with smaller tiles at ds = 8 and at ds <= 4 (f32); without the selection, with
  the selection cut to its running minimum, without the row copies after a
  block's first two tiles and without the products (bf16).  The differences
  are those parts' shares.

With ``--against DIR`` (another checkout of the repository, for example the
parent commit unpacked by ``git archive``) the timings of the first two groups
are also taken there, in the order other, this, this, other (the sweep once
each), each in a process of its own, so that two versions are compared on one
card in one run.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import statistics
import subprocess
import sys
import tempfile
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent

FLAGSHIP = (16, 256, 8)
GATE = (10, 128, 2)  # (m, k, ds) of the reference's quality gate, d = 20
# (n, m, k, ds): the flagship shape comes first and takes --n.
COMPARED_SHAPES = [(None, *FLAGSHIP), (65_536, *FLAGSHIP), (50_001, *FLAGSHIP), (65_536, 24, 256, 32)]
SWEEP_SHAPES = [(None, 16, k, 8) for k in (8, 64, 128, 1024)] + [
    (None, 32, 256, 4), (None, 8, 256, 16), (None, 4, 256, 32)]


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


def make(n, m, k, ds):
    import torch

    gen = torch.Generator(device="cuda").manual_seed(0)
    cb = torch.randn((m, k, ds), generator=gen, device="cuda")
    x = torch.randn((n, m * ds), generator=gen, device="cuda")
    return cb, x


def worker(label: str, n_rows: int, sweep: bool) -> None:
    """Times this checkout's kernels (the package is imported from the
    current directory)."""
    sys.path.insert(0, str(Path.cwd()))
    import torch
    from reductive_tpu_torch import ops
    from reductive_tpu_torch.ops.assign import pq_encode_verify_flags
    from reductive_tpu_torch.ops.stats import pq_assign_stats_verify_flags

    ops.build_all()
    for n, m, k, ds in COMPARED_SHAPES + (SWEEP_SHAPES if sweep else []):
        n = n_rows if n is None else n
        cb, x = make(n, m, k, ds)
        shape = f"n={n} d={m * ds} m={m} k={k} ds={ds}"
        f32, i32 = torch.float32, torch.int32
        code = torch.uint8 if k <= 256 else i32
        bf16 = torch.bfloat16
        alone = bf16_entries(cb, x) if (n, m, k, ds) == (n_rows, *FLAGSHIP) else {}
        emit(checkout=label, shape=shape, **alone,
             stats_f32=time_ms(lambda: ops.pq_assign_stats(cb, x, compute_dtype=f32)),
             stats_bf16=time_ms(lambda: ops.pq_assign_stats(cb, x, compute_dtype=bf16)),
             encode_bf16=time_ms(lambda: ops.pq_encode(cb, x, dtype=code, compute_dtype=bf16)),
             encode_bf16_int32=time_ms(lambda: ops.pq_encode(cb, x, dtype=i32, compute_dtype=bf16)),
             stats_verify_kernel=time_ms(lambda: pq_assign_stats_verify_flags(cb, x)),
             stats_verified=time_ms(lambda: ops.pq_assign_stats_verified(cb, x)),
             flag_rate=float(pq_assign_stats_verify_flags(cb, x)[3].float().mean()),
             encode_f32=time_ms(lambda: ops.pq_encode(cb, x, dtype=code, compute_dtype=f32)),
             encode_f32_int32=time_ms(lambda: ops.pq_encode(cb, x, dtype=i32, compute_dtype=f32)),
             encode_verify_kernel=time_ms(lambda: pq_encode_verify_flags(cb, x, dtype=code)),
             encode_verified=time_ms(lambda: ops.pq_encode_verified(cb, x, dtype=code)),
             encode_flag_rate=float(pq_encode_verify_flags(cb, x, dtype=code)[1].float().mean()))
        del cb, x
        torch.cuda.empty_cache()


def bf16_entries(cb, x):
    """Milliseconds of the bf16 encode (uint8 codes) and statistics C entries
    alone, operands prepared outside, in this checkout: through the entries
    that take ``bf16_tile_plan``'s plan where the package has it, else
    through ``rt_encode`` / ``rt_assign_stats`` with their bf16 flag."""
    import torch
    from reductive_tpu_torch.ops import _build, assign
    from reductive_tpu_torch.ops.assign import _prepare
    from reductive_tpu_torch.ops.stats import _blocks_per_subquantizer  # in either checkout

    n = x.shape[0]
    m, k, ds = cb.shape
    cb2, c_sqn = _prepare(cb, x, torch.int32, torch.bfloat16)
    blocks = _blocks_per_subquantizer(n, m, k, ds)
    if hasattr(assign, "bf16_tile_plan"):
        sms = torch.cuda.get_device_properties(0).multi_processor_count
        enc, st = assign.bf16_tile_plan(n, m, k, ds, sms=sms), assign.bf16_tile_plan(n, m, k, ds)
        blocks = st.blocks
    partial = torch.empty((blocks, m, k, ds + 1), device="cuda")
    sums, counts = torch.empty((m, k, ds), device="cuda"), torch.empty((m, k), device="cuda")
    codes = torch.empty((n, m), dtype=torch.uint8, device="cuda")
    stream = torch.cuda.current_stream().cuda_stream
    ptrs = (x.data_ptr(), cb2.data_ptr(), c_sqn.data_ptr())
    if hasattr(assign, "bf16_tile_plan"):
        encode = ("rt_encode_bf16", *ptrs, codes.data_ptr(), n, m, k, ds, 1, enc.rows, enc.blocks,
                  enc.smem_bytes, stream)
        stats = ("rt_assign_stats_bf16", *ptrs, partial.data_ptr(), sums.data_ptr(),
                 counts.data_ptr(), n, m, k, ds, st.rows, st.blocks, st.smem_bytes, stream)
    else:
        encode = ("rt_encode", *ptrs, codes.data_ptr(), n, m, k, ds, 1, 1, 0, stream)
        stats = ("rt_assign_stats", *ptrs, partial.data_ptr(), sums.data_ptr(), counts.data_ptr(),
                 n, m, k, ds, 1, blocks, stream)
    return {"encode_bf16_kernel": time_ms(lambda: _build.launch(encode[0], None, *encode[1:])),
            "stats_bf16_kernel": time_ms(lambda: _build.launch(stats[0], None, *stats[1:]))}


# name -> [(file under csrc, text that must occur at least once, its
# replacement for every occurrence)]
ABLATIONS = {
    "whole": [],
    # The encode assigns and flags but writes no code.
    "no_code_writes": [
        ("encode.cu", "        codes[row * m + j] = (OutT)s_code[e];\n",
         "        if (s_code[e] == 0x7fffffff) codes[row * m + j] = (OutT)0;  // keeps the codes live\n"),
    ],
    "no_accumulation": [
        ("stats.cu", "    accumulate_tile<DS, kTile>(s_x, s_code, scratch, one, slot, acc, cnt);\n",
         "    if (s_code[threadIdx.x % kTile] == 0x7fffffff) acc[0] += 1.0f;  // keeps the codes live\n"),
        ("stats.cu", "    accumulate_tile<DS, kTile>(s_x, sm.s_code, scratch, one, slot, acc, cnt);\n",
         "    if (sm.s_code[threadIdx.x % kTile] == 0x7fffffff) acc[0] += 1.0f;\n"),
    ],
    # f32 mode only: as many registers as the compiler likes, so one block on an SM.
    "one_block_per_sm": [
        ("assign_tile.cuh", "constexpr int kMinBlocks = DS <= 8 ? 2 : 1;", "constexpr int kMinBlocks = 1;"),
    ],
    # The encode's grid: one wave of resident blocks in place of four.
    "encode_one_wave": [
        ("encode.cu", "constexpr int kWaves = 4;", "constexpr int kWaves = 1;"),
    ],
    # f32 mode only: tiles of 256 rows in place of 512 at ds = 8.
    "two_subtiles_per_warpgroup": [
        ("assign_tile.cuh", "constexpr int kSubtiles = DS <= 4 ? 8 : DS <= 8 ? 4 : 32 / DS;",
         "constexpr int kSubtiles = DS <= 4 ? 8 : DS < 8 ? 4 : (DS == 8 ? 2 : 32 / DS);"),
    ],
    # f32 mode only: tiles of 512 rows in place of 1,024 at ds <= 4 (the gate's
    # padded instance), where the counting sort's fixed work a tile is shared
    # by half the rows.
    "four_subtiles_at_ds4": [
        ("assign_tile.cuh", "constexpr int kSubtiles = DS <= 4 ? 8 : DS <= 8 ? 4 : 32 / DS;",
         "constexpr int kSubtiles = DS <= 8 ? 4 : 32 / DS;"),
    ],
    # f32 mode only: the running minimum stays, the compare and the three selects go.
    "selection_is_min_only": [
        ("assign_tile.cuh",
         "    if (lo < best[h]) {\n      best[h] = lo;\n      keep[h] = d0;\n      base[h] = col0;\n    }\n",
         "    best[h] = fminf(best[h], lo);\n"),
    ],
    # bf16 mode: of each quarter's scores only those of its first 8-column group
    # are selected.
    "bf16_no_selection": [
        ("assign_tile.cuh",
         "    if (8 * i < cols) {  // the same for every thread\n",
         "    if (i == 0 && 8 * i < cols) {\n"),
    ],
    # bf16 mode: a block copies the rows of its first two tiles only and then
    # assigns those again (both buffers hold real rows; no global loads).
    "bf16_no_row_copies": [
        (src, "    if (tile + P < n_tiles)\n      assign_tile::copy_rows<DS, kTile, kThreads, PAD>"
              "(x, n, m, j, tile + P,\n" + " " * 55 + "sm.s_x2",
         "    if (tile == p && tile + P < n_tiles)\n      assign_tile::copy_rows<DS, kTile, kThreads, PAD>"
         "(x, n, m, j, tile + P,\n" + " " * 55 + "sm.s_x2")
        for src in ("encode.cu", "stats.cu")
    ],
    # bf16 mode: the accumulators are zeroed where the products would fill them.
    "bf16_no_products": [
        ("assign_tile.cuh",
         "    wgmma_m64n64k16_bf16_rs(\n"
         "        d, a[ks], b_descriptor(reinterpret_cast<const uint32_t*>(s_c + ks * kCentroidTile * 32), quarter),\n"
         "        ks > 0);\n",
         "    for (int z = 0; z < 32; ++z) asm volatile(\"mov.b32 %0, 0;\" : \"=f\"(d[z]));\n"),
    ],
    # bf16 mode: the running minimum stays, the compare and the three updates go.
    "bf16_selection_is_min_only": [
        ("assign_tile.cuh",
         "    asm(\"{\\n.reg .pred p;\\nsetp.lt.f32 p, %3, %0;\\n\"\n"
         "        \"@p fma.rn.f32 %0, %3, 0f3F800000, 0f00000000;\\n\"\n"
         "        \"@p fma.rn.f32 %1, %4, 0f3F800000, 0f00000000;\\n\"\n"
         "        \"@p add.rn.f32 %2, %5, %6;\\n}\\n\"\n"
         "        : \"+f\"(best[h]), \"+f\"(keep[h]), \"+f\"(base[h])\n"
         "        : \"f\"(lo), \"f\"(d0), \"f\"(col), \"f\"(off));\n",
         "    best[h] = fminf(best[h], lo);\n"),
    ],
    # f32 mode only: x_hi.w_hi alone, without the two small products of the split.
    "one_product_of_three": [
        ("assign_tile.cuh",
         "    wgmma_m64n64k8_tf32(d, al[ks], b_descriptor(s_hi + ks * kStep, quarter), ks > 0);\n"
         "#pragma unroll\n"
         "  for (int ks = 0; ks < KS; ++ks)\n"
         "    wgmma_m64n64k8_tf32(d, ah[ks], b_descriptor(s_lo + ks * kStep, quarter), 1);\n"
         "#pragma unroll\n"
         "  for (int ks = 0; ks < KS; ++ks)\n"
         "    wgmma_m64n64k8_tf32(d, ah[ks], b_descriptor(s_hi + ks * kStep, quarter), 1);\n",
         "    wgmma_m64n64k8_tf32(d, ah[ks], b_descriptor(s_hi + ks * kStep, quarter), ks > 0);\n"),
    ],
}


def operands(n_rows: int, m: int, k: int, ds: int) -> dict:
    """What the C entries take at one shape, prepared outside the timed calls."""
    import torch
    from reductive_tpu_torch.ops.assign import (
        _blocks_per_subquantizer, _prepare, bf16_tile_plan, padded_ds,
    )

    cb, x = make(n_rows, m, k, ds)
    dsp = padded_ds(ds)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    op = {"x": x, "cb2": _prepare(cb, x, torch.int32, torch.float32)[0],
          "cb2_bf16": _prepare(cb, x, torch.int32, torch.bfloat16)[0],
          "c_sqn": _prepare(cb, x, torch.int32, torch.float32)[1],
          "blocks": _blocks_per_subquantizer(n_rows, m, k, dsp),
          "enc_plan": bf16_tile_plan(n_rows, m, k, ds, sms=sms),
          "stats_plan": bf16_tile_plan(n_rows, m, k, ds),
          "sums": torch.empty((m, k, ds), device="cuda"), "counts": torch.empty((m, k), device="cuda"),
          "codes": torch.empty((n_rows, m), dtype=torch.uint8, device="cuda")}
    op["partial"] = torch.empty((max(op["blocks"], op["stats_plan"].blocks), m, k, dsp + 1),
                                device="cuda")
    return op


def ablated(n_rows: int) -> None:
    """Builds of stats.cu (and of encode.cu where the part is in it or in the
    shared header) with a part compiled out, timed through the C entries at
    the flagship shape and at the gate width.  The results of such a build
    are wrong by design; only its time is read."""
    sys.path.insert(0, str(ROOT))
    import torch
    from reductive_tpu_torch.ops import _build

    shapes = {shape: operands(n_rows, *shape) for shape in (FLAGSHIP, GATE)}
    stream = torch.cuda.current_stream().cuda_stream
    csrc = ROOT / "reductive_tpu_torch" / "csrc"
    with tempfile.TemporaryDirectory() as tmp:
        builds = {}  # name -> (copy of csrc, sources built there)
        for name, swaps in ABLATIONS.items():
            work = Path(tmp) / name
            work.mkdir()
            for src in list(csrc.glob("*.cu")) + list(csrc.glob("*.cuh")):
                text = src.read_text()
                for file, old, new in swaps:
                    if src.name == file:
                        if old not in text:
                            raise SystemExit(f"{name}: the text to replace is not in {file}")
                        text = text.replace(old, new)
                (work / src.name).write_text(text)
            touched = {file for file, _, _ in swaps}
            builds[name] = (work, ["stats"] + (
                ["encode"] if not touched or touched & {"encode.cu", "assign_tile.cuh"} else []))
        # Every build at once, as many compilers at a time as the host has cores.
        jobs = [(name, work, src) for name, (work, sources) in builds.items() for src in sources]
        running = []
        while jobs or running:
            while jobs and len(running) < (os.cpu_count() or 4):
                name, work, src = jobs.pop(0)
                running.append((name, src, subprocess.Popen(
                    [_build._nvcc(), *_build._NVCC_FLAGS, "-I", str(work), "-o",
                     str(work / f"lib{src}.so"), str(work / f"{src}.cu")],
                    stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
            name, src, proc = running.pop(0)
            out, _ = proc.communicate()
            for line in out.splitlines():  # ptxas warnings, such as wgmma serialised
                print(f"{name} {src}.cu: {line}", flush=True)
            if proc.returncode != 0:
                raise SystemExit(f"{name}: nvcc failed for {src}.cu")
        for name, (work, sources) in builds.items():
            libs = {src: ctypes.CDLL(str(work / f"lib{src}.so")) for src in sources}

            def entry_fn(entry):
                fn = getattr(libs[_build._ENTRIES[entry][0]], entry)
                fn.argtypes = list(_build._ENTRIES[entry][1])
                return fn

            for (m, k, ds), op in shapes.items():
                x, cb2, cb2_bf16, c_sqn = op["x"], op["cb2"], op["cb2_bf16"], op["c_sqn"]
                enc_plan, stats_plan = op["enc_plan"], op["stats_plan"]
                stats_out = (op["partial"].data_ptr(), op["sums"].data_ptr(), op["counts"].data_ptr(),
                             n_rows, m, k, ds)
                calls = [
                    ("stats_f32", "rt_assign_stats", (x.data_ptr(), cb2.data_ptr(), c_sqn.data_ptr(),
                                                      *stats_out, op["blocks"], stream)),
                    ("stats_bf16", "rt_assign_stats_bf16",
                     (x.data_ptr(), cb2_bf16.data_ptr(), c_sqn.data_ptr(), *stats_out,
                      stats_plan.rows, stats_plan.blocks, stats_plan.smem_bytes, stream)),
                ]
                if "encode" in sources:
                    codes = op["codes"].data_ptr()
                    calls += [
                        ("encode_f32", "rt_encode", (x.data_ptr(), cb2.data_ptr(), c_sqn.data_ptr(),
                                                     codes, n_rows, m, k, ds, 0, 1, 0, stream)),
                        ("encode_bf16", "rt_encode_bf16",
                         (x.data_ptr(), cb2_bf16.data_ptr(), c_sqn.data_ptr(), codes, n_rows, m, k,
                          ds, 1, enc_plan.rows, enc_plan.blocks, enc_plan.smem_bytes, stream)),
                    ]
                for mode, entry, args in calls:
                    fn = entry_fn(entry)
                    fn.restype = ctypes.c_int

                    def call():
                        rc = fn(*args)
                        if rc != 0:
                            raise SystemExit(f"{name}: {entry} returned {rc}")

                    emit(build=name, kernel=mode, shape=f"n={n_rows} d={m * ds} m={m} k={k} ds={ds}",
                         ms=time_ms(call))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--against", type=Path, help="another checkout to time in turn with this one")
    ap.add_argument("--n", type=int, default=4_000_000, help="rows at the flagship shape")
    ap.add_argument("--worker", help=argparse.SUPPRESS)
    ap.add_argument("--sweep", action="store_true", help=argparse.SUPPRESS)
    ap.add_argument("--ablated", action="store_true", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.worker:
        worker(args.worker, args.n, args.sweep)
        return 0
    if args.ablated:
        ablated(args.n)
        return 0
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True).stdout.strip(), flush=True)
    me = [sys.executable, str(Path(__file__).resolve()), "--n", str(args.n)]
    turns = [("this", ROOT, True)]
    if args.against:
        other = args.against.resolve()
        turns = [("other", other, True), ("this", ROOT, True), ("this", ROOT, False),
                 ("other", other, False)]
    for label, cwd, sweep in turns:
        subprocess.run([*me, "--worker", label, *(["--sweep"] if sweep else [])], cwd=cwd, check=True)
    subprocess.run([*me, "--ablated"], check=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
