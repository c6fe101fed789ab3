"""Times of the ADC kernels of ``reductive_tpu_torch`` on one GPU.

    python3 tools/time_adc_kernels.py [--against DIR] [--plans] [--split]

Prints the card's name and power limit, then one JSON line per measurement
(CUDA-event medians of five after a warm-up, milliseconds):

* ``adc`` and ``adc_int8`` (k=256, uint8 codes) and ``adc_u4`` and
  ``adc_int8_u4`` (k=16, packed codes) through the wrapper (``ms``) and
  through their C entry alone, the tables prepared outside the call
  (``kernel_ms``; int8: ``rt_adc_i8`` under ``adc_int8_plan``, or a parent
  checkout's ``rt_adc_int8``), the tables' preparation alone (``prep_ms``),
  beside ``F.embedding_bag`` over the same tables
  (dequantized once for int8; ``library_ms``), the byte bound (tables and
  codes read once, scores written once, at 3.35 TB/s; ``bound_ms``) and the
  floor of conflict-free lookups (one table entry a lookup, 4 bytes for f32
  and 1 for int8, 128 bytes a cycle on each SM at the card's largest SM
  clock; ``lookup_floor_ms``), at the
  flagship width d=128, m=16 with 16 queries over 4,000,000 rows, at 128
  queries over 524,288 rows (the chunk ``search`` streams 128 queries in) and
  at d=768, m=24 with 16 queries over 4,000,000 rows; every kernel's scores are
  held to the plain version's bits (``bit_equal``; int8: ``max_abs_err``);
* ``search`` at the flagship width over 4,000,000 codes, 16 and 128 queries,
  on the host clock (each call synchronised).

With ``--against DIR`` (another checkout of the repository, for example the
parent commit unpacked by ``git archive``) every measurement is also taken
there, in the order other, this, this, other, each in a process of its own
that imports the package of its checkout, so that two versions are compared
on one card in one run.

With ``--plans`` it also times, in this checkout, the f32 and the int8 C
entries at the three shapes (k=256) under the plan ``adc_plan`` /
``adc_int8_plan`` gives, the f32 one without its skewed walk, and each
with 512 threads a block, each held to the plain version's bits: what each
choice of the plan is worth.

With ``--split`` it also builds ``csrc/adc.cu`` of this checkout, and of
``--against`` where given, with a part compiled out (in a temporary copy,
never in the package): every lookup of a row at one code (no bank
conflicts, no dependence on the codes), no table fill, no score stores, every
code tested against k; and times the f32 and the int8 C entries of each build
at the first two shapes (k=256) and at the flagship width with k=16 packed.
The differences from the whole build are those parts' shares; the results of
such a build are wrong by design and only its time is read.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
PEAK_BYTES = 3.35e12
SMEM_BYTES_PER_CYCLE = 128  # one 128-byte wavefront a cycle on each SM
# (label, n, nq, m, ds)
SHAPES = [("flagship_16q", 4_000_000, 16, 16, 8), ("chunk_128q", 524_288, 128, 16, 8),
          ("d768_16q", 4_000_000, 16, 24, 32)]
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


def max_sm_clock_hz() -> float:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader,nounits"],
        check=True, capture_output=True, text=True).stdout.strip().splitlines()[0]
    return float(out) * 1e6


def legacy_entry(lib):
    """The f32 C entry of a checkout from before ``adc_plan``: (tables, codes,
    code_bytes, packed, out, n, nq, m, k, qt, row_blocks, stream)."""
    fn = lib.rt_adc
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
                   ctypes.c_longlong, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                   ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def f32_call(lib, adc_mod, table, codes, packed, out, sms, plan=None):
    """A callable that launches the f32 C entry of the library ``lib`` once on
    prepared operands, with ``plan`` or the plan the wrapper of ``adc_mod``
    would give it: through ``adc_mod.adc_launcher``, or in a checkout from
    before it with that checkout's arguments (``adc_plan``'s, or before
    ``adc_plan`` ``legacy_entry``'s)."""
    import torch

    if hasattr(adc_mod, "adc_launcher"):
        return adc_mod.adc_launcher((table,), codes, out, packed=packed, plan=plan,
                                    counted=False, lib=lib)
    nq, m, k = table.shape
    n = codes.shape[0]
    stream = torch.cuda.current_stream().cuda_stream
    ptrs = (table.data_ptr(), codes.data_ptr(), codes.element_size(), int(packed), out.data_ptr())
    if hasattr(adc_mod, "adc_plan"):
        fn = lib.rt_adc
        p = plan or adc_mod.adc_plan(n, nq, m, k, packed, sms=sms)
        args = (*ptrs, n, nq, m, k, p.queries, p.replicas, int(p.skew), p.blocks,
                p.rows_per_block, p.threads, p.smem_bytes, stream)
    else:
        fn = legacy_entry(lib)
        args = (*ptrs, n, nq, m, k, adc_mod.query_tile(m, k, 2), max(1, min(-(-n // 1024), sms)),
                stream)

    def call():
        rc = fn(*args)
        if rc != 0:
            raise SystemExit(f"rt_adc returned {rc}")
    return call


def legacy_int8_entry(lib):
    """The int8 C entry of a checkout from before ``adc_int8_plan``: (t8, scale,
    offset, codes, code_bytes, packed, out, n, nq, m, k, qt, row_blocks, stream)."""
    fn = lib.rt_adc_int8
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
                                           ctypes.c_longlong] + [ctypes.c_int] * 5 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def int8_call(lib, adc_mod, prepared, codes, packed, out, sms, plan=None):
    """A callable that launches the int8 C entry of the library ``lib`` once
    on prepared tables ``(t8, scale, offset)``: ``rt_adc_i8`` through
    ``adc_mod.adc_launcher`` under ``plan`` or ``adc_int8_plan``'s, or,
    where ``adc_mod`` has no ``adc_launcher``, a parent checkout's
    ``rt_adc_int8``."""
    import torch

    if hasattr(adc_mod, "adc_launcher"):
        return adc_mod.adc_launcher(prepared, codes, out, packed=packed, plan=plan,
                                    counted=False, lib=lib)
    t8, scale, offset = prepared
    nq, m, k = t8.shape
    n = codes.shape[0]
    fn = legacy_int8_entry(lib)
    args = (t8.data_ptr(), scale.data_ptr(), offset.data_ptr(), codes.data_ptr(),
            codes.element_size(), int(packed), out.data_ptr(), n, nq, m, k,
            adc_mod.query_tile(m, k, "int8"), max(1, min(-(-n // 1024), sms)),
            torch.cuda.current_stream().cuda_stream)

    def call():
        rc = fn(*args)
        if rc != 0:
            raise SystemExit(f"rt_adc_int8 returned {rc}")
    return call


def make(n, nq, m, k, ds, seed):
    import torch
    from reductive_tpu_torch import Pq
    from reductive_tpu_torch.ops import pack_u4_codes
    from reductive_tpu_torch.search import adc_tables

    gen = torch.Generator(device="cuda").manual_seed(seed)
    pq = Pq(codebooks=torch.randn((m, k, ds), generator=gen, device="cuda"))
    q = torch.randn((nq, m * ds), generator=gen, device="cuda")
    codes = torch.randint(0, k, (n, m), generator=gen, device="cuda", dtype=torch.uint8)
    tables = adc_tables(pq, q)
    packed = pack_u4_codes(codes) if k <= 16 else None
    return tables, codes, packed


def adc_worker(label: str) -> None:
    import torch
    from reductive_tpu_torch import ops
    from reductive_tpu_torch.ops import _build
    from reductive_tpu_torch.ops import adc as adc_mod
    from reductive_tpu_torch.ops.decode import decode_table, effective_codebook

    sms = torch.cuda.get_device_properties(0).multi_processor_count
    clock = max_sm_clock_hz()
    lib = _build.library("adc")
    for shape, n, nq, m, ds in SHAPES:
        for k in (256, 16):
            tables, codes, packed = make(n, nq, m, k, ds, seed=n + nq + m + k)
            given = packed if k <= 16 else codes
            suffix = "_u4" if k <= 16 else ""
            idx = codes.to(torch.int64) + torch.arange(m, device="cuda")[None, :] * k
            out = torch.empty((nq, n), device="cuda")
            code_bytes = n * m // 2 if k <= 16 else n * m
            for splits in (2, "int8"):
                name = ("adc_int8" if splits == "int8" else "adc") + suffix
                kw = {"splits": splits, "packed": k <= 16}
                got = ops.adc_scores_kernel(tables, given, **kw)
                want = ops.adc_scores_reference(tables, given, **kw)
                check = {"bit_equal": bool(torch.equal(got.view(torch.int32), want.view(torch.int32))),
                         "max_abs_err": float((got - want).abs().max())}
                del got, want
                if splits == "int8":
                    prepare = getattr(adc_mod, "adc_table_int8", adc_mod.quantize_tables_int8)
                    t8, scale, offset = prepared = prepare(tables)
                    deq = t8.to(torch.float32) * scale[:, None, None] + (offset / m)[:, None, None]
                    lib_table = deq.reshape(nq, m * k).T.contiguous()
                    alone = int8_call(lib, adc_mod, prepared, given, k <= 16, out, sms)
                    entry_bytes = 1
                else:
                    prepare = lambda t: effective_codebook(t, 2)  # noqa: E731
                    if hasattr(adc_mod, "adc_table_int8"):  # the f32 table by decode's launch
                        prepare = lambda t: decode_table(t.reshape(nq, m * k, 1), 2)[0]  # noqa: E731
                    table = prepare(tables).view(nq, m, k)
                    lib_table = table.reshape(nq, m * k).T.contiguous()
                    alone = f32_call(lib, adc_mod, table, given, k <= 16, out, sms)
                    entry_bytes = 4
                nbytes = entry_bytes * nq * m * k + code_bytes + 4 * nq * n
                emit(checkout=label, kernel=name, shape=f"{shape}: n={n} nq={nq} m={m} k={k}",
                     **check,
                     ms=time_ms(lambda: ops.adc_scores_kernel(tables, given, **kw)),
                     kernel_ms=time_ms(alone), prep_ms=time_ms(lambda: prepare(tables)),
                     library_ms=time_ms(lambda: torch.nn.functional.embedding_bag(
                         idx, lib_table, mode="sum")),
                     bound_ms=nbytes / PEAK_BYTES * 1e3,
                     lookup_floor_ms=entry_bytes * nq * n * m / (
                         sms * SMEM_BYTES_PER_CYCLE * clock) * 1e3,
                     **({"plan": list(adc_mod.adc_plan(n, nq, m, k, k <= 16, sms=sms))}
                        if splits == 2 and hasattr(adc_mod, "adc_plan") else {}),
                     **({"plan": list(adc_mod.adc_int8_plan(n, nq, m, k, k <= 16, sms=sms))}
                        if splits == "int8" and hasattr(adc_mod, "adc_int8_plan") else {}))
            del tables, codes, packed, idx, out
            torch.cuda.empty_cache()


def search_worker(label: str) -> None:
    import torch
    from reductive_tpu_torch import Pq
    from reductive_tpu_torch import search as tsearch

    n, m, k, ds = SEARCH_SHAPE
    gen = torch.Generator(device="cuda").manual_seed(1)
    pq = Pq(codebooks=torch.randn((m, k, ds), generator=gen, device="cuda"))
    codes = torch.randint(0, k, (n, m), generator=gen, device="cuda", dtype=torch.uint8)
    q = torch.randn((128, m * ds), generator=gen, device="cuda")
    emit(checkout=label, shape=f"n={n} d={m * ds} m={m} k={k} top_k=10",
         search_16q_ms=host_ms(lambda: tsearch.search(pq, q[:16], codes, 10)),
         search_128q_ms=host_ms(lambda: tsearch.search(pq, q, codes, 10)))


def plans_worker() -> None:
    """The f32 and int8 C entries at each shape (k=256) under variants of
    their plans."""
    sys.path.insert(0, str(ROOT))
    import torch
    from reductive_tpu_torch import ops
    from reductive_tpu_torch.ops import _build
    from reductive_tpu_torch.ops import adc as adc_mod
    from reductive_tpu_torch.ops.decode import effective_codebook

    sms = torch.cuda.get_device_properties(0).multi_processor_count
    lib = _build.library("adc")
    for shape, n, nq, m, ds in SHAPES:
        tables, codes, _ = make(n, nq, m, 256, ds, seed=n + nq + m + 256)
        table = effective_codebook(tables, 2)
        want = ops.adc_scores_reference(tables, codes, splits=2)
        out = torch.empty((nq, n), device="cuda")
        plan = adc_mod.adc_plan(n, nq, m, 256, sms=sms)
        variants = {"plan": plan, "no_skew": plan._replace(skew=False),
                    "threads_512": plan._replace(threads=512),
                    "no_skew_threads_512": plan._replace(skew=False, threads=512)}
        times = {}
        for name, variant in variants.items():
            call = f32_call(lib, adc_mod, table, codes, False, out, sms, plan=variant)
            call()
            torch.cuda.synchronize()
            if not torch.equal(out.view(torch.int32), want.view(torch.int32)):
                raise SystemExit(f"{shape} {name}: scores differ from the plain version")
            times[name] = [time_ms(call), time_ms(call)]
        emit(shape=f"{shape}: n={n} nq={nq} m={m} k=256", plan=list(plan), kernel_ms=times)
        prepared = adc_mod.adc_table_int8(tables)
        want8 = ops.adc_scores_reference(tables, codes, splits="int8")
        plan8 = adc_mod.adc_int8_plan(n, nq, m, 256, sms=sms)
        variants = {"plan": plan8, "threads_512": plan8._replace(threads=512)}
        times = {}
        for name, variant in variants.items():
            call = int8_call(lib, adc_mod, prepared, codes, False, out, sms, plan=variant)
            call()
            torch.cuda.synchronize()
            if not torch.equal(out.view(torch.int32), want8.view(torch.int32)):
                raise SystemExit(f"{shape} int8 {name}: scores differ from the plain version")
            times[name] = [time_ms(call), time_ms(call)]
        emit(shape=f"{shape}: n={n} nq={nq} m={m} k=256", kernel="adc_int8", plan=list(plan8),
             kernel_ms=times)
        del tables, codes, table, want, want8, prepared, out
        torch.cuda.empty_cache()


def worker(label: str) -> None:
    """Times this checkout (the package is imported from the current
    directory)."""
    sys.path.insert(0, str(Path.cwd()))
    adc_worker(label)
    search_worker(label)


# name -> [(text that must occur in csrc/adc.cu, its replacement)]; each
# build applies the pairs whose text its checkout's source holds: at least one
# in this checkout; the other checkout's build is left out where none is.
SPLITS = {
    "whole": [],
    # Every lane of a phase reads one entry of a line: (j, 0) of the f32 kernel
    # (its u-th row (j, u), so that the rows' loads stay apart); code 0 of the
    # int8 kernel (one address a phase).
    "no_conflicts": [
        ("        const TabT* p = s_t + (j * k + (int)c) * QT;\n",
         "        const TabT* p = s_t + (j * k + (int)(c & 0u)) * QT;\n"),
        ("        const Vec t = *reinterpret_cast<const Vec*>(s_lane + (j * k + (int)c) * (R * QT));\n",
         "        const Vec t = *reinterpret_cast<const Vec*>(s_lane + (j * k + u) * (R * QT));\n"),
        ("s_lane + (int)c * c_stride + (m + b) * QT", "s_lane + (m + b) * QT"),
        ("s_lane + (int)c * c_stride + (j0 + b) * QT", "s_lane + (j0 + b) * QT"),
        ("add_entry<V>(s_lane + (j * k + (int)c) * (R * QT), acc);",
         "add_entry<V>(s_lane + (j * k + (int)(c & 0u)) * (R * QT), acc);"),
    ],
    "no_fill": [
        ("e < QT * mk; e += kThreads", "e < 0; e += kThreads"),
        ("e < mk * CPE; e += threads", "e < 0; e += threads"),
        ("e < k * CPE; e += threads", "e < 0; e += threads"),
        ("idx < total; idx += groups", "idx < 0; idx += groups"),
    ],
    # Every code is tested against k, as it must be below k = 256 (16 packed).
    "test_codes": [("    if (k >= 256)\n      walk_skewed", "    if (k >= 4096)\n      walk_skewed"),
                   ("if (k >= (PACKED ? 16 : 256)) {", "if (k >= 4096) {")],
    # The sums stay live: a store only where a score is one given value.
    "no_stores": [
        ("        out[(long long)(q0 + q) * n + row] = v;\n",
         "        if (v == 1.25e-38f) out[(long long)(q0 + q) * n + row] = v;\n"),
        ("        if (qa + t < nq) out[(long long)(qa + t) * n + row] = acc[u][t];\n",
         "        if (qa + t < nq && acc[u][t] == 1.25e-38f) out[(long long)(qa + t) * n + row] = acc[u][t];\n"),
        ("        if (qa + t < nq) out[(long long)(qa + t) * n + prev_row[u]] = prev[u][t];\n",
         "        if (qa + t < nq && prev[u][t] == 1.25e-38f) out[(long long)(qa + t) * n + prev_row[u]] = prev[u][t];\n"),
        ("        if (last)\n          *o = __fadd_rn(",
         "        if (last && sum == 77777)\n          *o = __fadd_rn("),
    ],
}


def split(against: Path | None) -> None:
    """Builds of csrc/adc.cu with a part compiled out, in this checkout and in
    ``against``, timed through the f32 and the int8 C entries."""
    sys.path.insert(0, str(ROOT))
    import torch
    from reductive_tpu_torch.ops import _build
    from reductive_tpu_torch.ops import adc as adc_mod
    from reductive_tpu_torch.ops.decode import effective_codebook

    sms = torch.cuda.get_device_properties(0).multi_processor_count
    checkouts = [("this", ROOT)] + ([("other", against.resolve())] if against else [])
    # Which C entries the other checkout has: the f32 one under adc_plan's
    # plan (since adc_plan) and the int8 one under adc_int8_plan's, with the
    # arguments adc_launcher gives them.
    other_ops = (against.resolve() / "reductive_tpu_torch" / "ops" / "adc.py").read_text() \
        if against else ""
    other_f32_plan = "def adc_plan" in other_ops
    other_int8_plan = "def adc_launcher" in other_ops
    with tempfile.TemporaryDirectory() as tmp:
        jobs = []
        for label, root in checkouts:
            text = (root / "reductive_tpu_torch" / "csrc" / "adc.cu").read_text()
            for name, swaps in SPLITS.items():
                src, applied = text, 0
                for old, new in swaps:
                    if old in src:
                        src, applied = src.replace(old, new), applied + 1
                if swaps and not applied:
                    if label == "this":
                        raise SystemExit(f"{name}: none of its texts is in csrc/adc.cu")
                    continue  # a part the other checkout's kernel does not have
                work = Path(tmp) / f"{label}_{name}"
                work.mkdir()
                (work / "adc.cu").write_text(src)
                proc = subprocess.Popen(
                    [_build._nvcc(), *_build._NVCC_FLAGS, "-o", str(work / "libadc.so"),
                     str(work / "adc.cu")], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                    text=True)
                jobs.append((label, name, work, proc))
        libs = {}
        for label, name, work, proc in jobs:  # all compilers run at once
            out, _ = proc.communicate()
            if proc.returncode != 0:
                raise SystemExit(f"{label} {name}: nvcc failed:\n{out}")
            libs[(label, name)] = ctypes.CDLL(str(work / "libadc.so"))

        cases = [(s, n, nq, m, ds, k) for s, n, nq, m, ds in SHAPES[:2] for k in (256,)]
        cases.append(("flagship_16q", 4_000_000, 16, 16, 8, 16))
        for shape, n, nq, m, ds, k in cases:
            tables, codes, packed = make(n, nq, m, k, ds, seed=n + nq + m + k)
            table = effective_codebook(tables, 2)
            prepared = adc_mod.adc_table_int8(tables)
            given = packed if k <= 16 else codes
            out = torch.empty((nq, n), device="cuda")
            suffix = "_u4" if k <= 16 else ""
            for (label, name), lib in libs.items():
                # The other checkout's entries through this checkout's
                # launcher where they take its arguments, else as before.
                f32_mod = adc_mod if label == "this" or other_f32_plan else _Legacy
                int8_mod = adc_mod if label == "this" or other_int8_plan else _Legacy
                calls = {"adc": f32_call(lib, f32_mod, table, given, k <= 16, out, sms),
                         "adc_int8": int8_call(lib, int8_mod, prepared, given, k <= 16, out, sms)}
                for kernel, call in calls.items():
                    emit(split=name, checkout=label, kernel=kernel + suffix,
                         shape=f"{shape}: n={n} nq={nq} m={m} k={k}", kernel_ms=time_ms(call))
            del tables, codes, packed, table, prepared, out
            torch.cuda.empty_cache()


class _Legacy:
    """The query tile of a checkout from before ``adc_plan`` (f32) and
    ``adc_int8_plan`` (int8): the largest of 8, 4, 2, 1 whose tables fit
    227 KB."""

    @staticmethod
    def query_tile(m, k, splits):
        entry = 1 if splits == "int8" else 4
        return next((qt for qt in (8, 4, 2, 1) if qt * m * k * entry <= 227 * 1024), 0)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--against", type=Path, help="another checkout to time in turn with this one")
    ap.add_argument("--split", action="store_true",
                    help="also time builds with a part of the kernels compiled out")
    ap.add_argument("--plans", action="store_true",
                    help="also time the f32 and int8 C entries under variants of their plans")
    ap.add_argument("--worker", help=argparse.SUPPRESS)
    ap.add_argument("--split-worker", action="store_true", help=argparse.SUPPRESS)
    ap.add_argument("--plans-worker", action="store_true", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.worker:
        worker(args.worker)
        return 0
    if args.plans_worker:
        plans_worker()
        return 0
    if args.split_worker:
        split(args.against)
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
    if args.plans:
        subprocess.run([*me, "--plans-worker"], check=True)
    if args.split:
        subprocess.run([*me, "--split-worker",
                        *(["--against", str(args.against)] if args.against else [])], check=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
