"""Smoke run of the PyTorch / CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the CUDA kernels of ``reductive_tpu_torch`` from the sources in this
checkout, holds each against its plain PyTorch version on the card, then
drives the serving path (encode -> decode -> ADC search) at the flagship
width d=128, m=16, k=256, ds=8 over a corpus of 4,000,000 rows, and checks
what comes out.  Every phase prints one JSON line.  The run fails (non-zero
exit, no result line) without a CUDA device, when a kernel does not build,
does not launch or disagrees, or when the serving path did not go through
every kernel.  The last line of a good run is
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.

Times are CUDA-event medians after a warm-up.  ``bound_ms`` is the least time
the card could take: the larger of bytes moved (each input read once, each
output written once) over the memory rate and operations over the peak rate
for their type, from NVIDIA's H100 SXM data sheet.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time

import torch

from reductive_tpu_torch import Pq, ops
from reductive_tpu_torch.pq import primitives
from reductive_tpu_torch.search import adc_tables, search

SEED = 0
M, K, DS = 16, 256, 8           # flagship width
D = M * DS
N_CORPUS = 4_000_000
N_KERNELS = 65_536
N_RAGGED = 50_001
N_PREFIX = 262_144
TOP_K = 10

# H100 SXM peaks (dense): bytes/s of HBM, operations/s by type.
PEAK_BYTES = 3.35e12
PEAK_OPS = {"f32": 67e12, "bf16": 989e12, "int8": 1979e12}

KERNELS = {
    "encode_f32": ("reductive_tpu_torch/csrc/encode.cu", "reductive_tpu/ops/assign.py:138"),
    "encode_bf16": ("reductive_tpu_torch/csrc/encode.cu", "reductive_tpu/ops/assign.py:138"),
    "decode": ("reductive_tpu_torch/csrc/decode.cu", "reductive_tpu/ops/decode.py:166"),
    "decode_int8": ("reductive_tpu_torch/csrc/decode.cu", "reductive_tpu/ops/decode.py:180"),
    "adc": ("reductive_tpu_torch/csrc/adc.cu", "reductive_tpu/ops/adc.py:59"),
    "adc_int8": ("reductive_tpu_torch/csrc/adc.cu", "reductive_tpu/ops/decode.py:180"),
}


class SmokeFailure(RuntimeError):
    pass


def emit(phase: str, **fields) -> None:
    print(json.dumps({"phase": phase, **fields}), flush=True)


def require(cond: bool, what: str) -> None:
    if not cond:
        raise SmokeFailure(what)


def time_ms(fn, reps: int = 5) -> float:
    fn()  # warm-up
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def bound(nbytes: float, nops: float, op_type: str) -> tuple[float, str]:
    t_bytes = nbytes / PEAK_BYTES * 1e3
    t_ops = nops / PEAK_OPS[op_type] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def smi() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True,
    ).stdout.strip().splitlines()[0]


# -- comparisons of a kernel with its plain version -------------------------


def chosen_dist(codebooks, x, codes):
    """Squared distance (f64) of each row's subvector to its chosen centroid."""
    m, _, ds = codebooks.shape
    xs = x.reshape(x.shape[0], m, ds).double()
    return (xs - primitives.reconstruct_batch(codebooks, codes).reshape(xs.shape).double()) \
        .pow(2).sum(dim=2)


def compare_encode(codebooks, x, compute_dtype):
    """Kernel against plain version.  Codes may differ only where f32
    summation order flips a near-tie: at least 99.9% (f32) or 99% (bf16)
    equal, and every differing code's centroid within 2^-13 (f32) or 2^-7
    (bf16) relative of the other's distance."""
    got = ops.pq_encode(codebooks, x, dtype=torch.int32, compute_dtype=compute_dtype)
    want = ops.pq_encode_reference(codebooks, x, dtype=torch.int32, compute_dtype=compute_dtype)
    torch.cuda.synchronize()
    require(got.shape == want.shape and got.dtype == want.dtype, "encode: shape or dtype")
    differ = got != want
    n_mismatch = int(differ.sum())
    dg, dw = chosen_dist(codebooks, x, got), chosen_dist(codebooks, x, want)
    max_abs = float((dg - dw).abs().max())
    rel = float(((dg - dw).abs() / dw.clamp_min(1e-30))[differ].max()) if n_mismatch else 0.0
    f32 = compute_dtype == torch.float32
    require(n_mismatch <= got.numel() * (1e-3 if f32 else 1e-2),
            f"encode {compute_dtype}: {n_mismatch} of {got.numel()} codes differ")
    require(rel <= (2.0 ** -13 if f32 else 2.0 ** -7),
            f"encode {compute_dtype}: a differing code is {rel} relative off")
    return {"n_mismatch": n_mismatch, "max_rel_gap": rel, "max_abs_err": max_abs}


def compare_decode(codebooks, codes, splits):
    """Kernel against plain version: bit-equal for splits 1, 2, 3 (a gather
    from the same table), and for "int8" too (one rounded multiply)."""
    got = ops.pq_decode(codebooks, codes, splits=splits)
    want = ops.pq_decode_reference(codebooks, codes, splits=splits)
    torch.cuda.synchronize()
    require(got.shape == want.shape, "decode: shape")
    n_mismatch = int((got != want).sum())
    require(n_mismatch == 0, f"decode splits={splits}: {n_mismatch} elements differ")
    return {"n_mismatch": n_mismatch, "max_abs_err": float((got - want).abs().max())}


def compare_adc(tables, codes, splits):
    """Kernel against plain version, rtol 1e-5 with atol 1e-5 * max|score|
    (both add the m entries in the order j = 0..m-1, so 0 is expected)."""
    got = ops.adc_scores_kernel(tables, codes, splits=splits)
    want = ops.adc_scores_reference(tables, codes, splits=splits)
    torch.cuda.synchronize()
    require(got.shape == want.shape, "adc: shape")
    err = (got - want).abs()
    tol = 1e-5 * want.abs() + 1e-5 * float(want.abs().max())
    n_mismatch = int((err > tol).sum())
    require(n_mismatch == 0, f"adc splits={splits}: {n_mismatch} scores beyond tolerance")
    return {"n_mismatch": n_mismatch, "max_abs_err": float(err.max())}


def phase_kernels(pq, corpus, gen):
    """Each kernel against its plain version at n = 65,536 and one ragged n,
    at the flagship width and, for ADC / decode / encode, at d=768, m=24."""
    dev = corpus.device
    rows = []
    for n in (N_KERNELS, N_RAGGED):
        x = corpus[:n]
        codes = pq.quantize_batch(x, method="kernel-f32")
        tables = adc_tables(pq, corpus[:16])
        for name, res in (
            ("encode_f32", compare_encode(pq.codebooks, x, torch.float32)),
            ("encode_bf16", compare_encode(pq.codebooks, x, torch.bfloat16)),
            ("decode_splits1", compare_decode(pq.codebooks, codes, 1)),
            ("decode_splits3", compare_decode(pq.codebooks, codes, 3)),
            ("decode_int8", compare_decode(pq.codebooks, codes, "int8")),
            ("adc_splits2", compare_adc(tables, codes, 2)),
            ("adc_int8", compare_adc(tables, codes, "int8")),
        ):
            rows.append({"kernel": name, "shape": f"n={n} d={D} m={M} k={K}", **res})

    m2, k2, ds2 = 24, 256, 32
    cb2 = torch.randn((m2, k2, ds2), generator=gen, device=dev)
    pq2 = Pq(codebooks=cb2)
    x2 = torch.randn((N_KERNELS, m2 * ds2), generator=gen, device=dev)
    codes2 = pq2.quantize_batch(x2, method="kernel-f32")
    shape2 = f"n={N_KERNELS} d={m2 * ds2} m={m2} k={k2}"
    rows.append({"kernel": "encode_f32", "shape": shape2,
                 **compare_encode(cb2, x2, torch.float32)})
    rows.append({"kernel": "decode_splits3", "shape": shape2, **compare_decode(cb2, codes2, 3)})
    for nq in (16, 128):
        tables2 = adc_tables(pq2, x2[:nq])
        for splits in (2, "int8"):
            res = compare_adc(tables2, codes2, splits)
            ms = time_ms(lambda: ops.adc_scores_kernel(tables2, codes2, splits=splits))
            plain_ms = time_ms(lambda: ops.adc_scores_reference(tables2, codes2, splits=splits), 3)
            rows.append({"kernel": "adc_int8" if splits == "int8" else "adc_splits2",
                         "shape": f"{shape2} nq={nq}", **res,
                         "kernel_ms": ms, "plain_ms": plain_ms})
    emit("kernels", compared=rows)


# -- the serving path ----------------------------------------------------------


def timed(fn):
    """Result and seconds (host clock, synchronised) of the second of two
    calls: the first pays one-time costs such as loading PyTorch's kernels."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def phase_serve(pq, corpus):
    n = corpus.shape[0]
    q16, q128 = corpus[:16], corpus[1000:1128]
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()

    codes_bf16, t_enc_bf16 = timed(lambda: pq.quantize_batch(corpus, method="kernel"))
    codes, t_enc_f32 = timed(lambda: pq.quantize_batch(corpus, method="kernel-f32"))
    rec, t_dec = timed(lambda: pq.reconstruct_batch(codes, method="kernel"))
    rec_fast, t_dec_fast = timed(lambda: pq.reconstruct_batch(codes, method="kernel-fast"))
    rec_int8, t_dec_int8 = timed(lambda: pq.reconstruct_batch(codes, method="kernel-int8"))
    (d16, i16), t_s16 = timed(lambda: search(pq, q16, codes, TOP_K))
    (d128, i128), t_s128 = timed(lambda: search(pq, q128, codes, TOP_K))
    (d8, i8), t_s8 = timed(lambda: search(pq, q16, codes, TOP_K, method="kernel", splits="int8"))
    (dr, ir), t_ref = timed(lambda: search(pq, q16, codes, TOP_K, refine_with=corpus))

    launches = ops.launch_counts()
    peak = torch.cuda.max_memory_allocated()
    for name in KERNELS:
        require(launches.get(name, 0) > 0, f"serve: kernel {name} was never launched")
    # method="auto" resolved to the kernel, and 128 queries streamed by the
    # 64M-element rule: one launch per chunk of 64M // 128 rows; the 16-query
    # searches (plain and the candidates of the refine) are dense, one launch each.
    chunks_128 = -(-n // min(1 << 20, max(1 << 16, (64 << 20) // 128)))
    require(128 * n > (64 << 20) >= 16 * n and launches["adc"] == 2 * (chunks_128 + 2),
            f"serve: {launches['adc']} ADC launches, expected {2 * (chunks_128 + 2)}")

    # What came out.
    require(codes.shape == (n, M) and codes.dtype == torch.uint8, "serve: codes shape/dtype")
    require(rec.shape == (n, D) and rec.dtype == torch.float32, "serve: rec shape/dtype")
    require(bool(torch.equal(rec, primitives.reconstruct_batch(pq.codebooks, codes))),
            "serve: kernel decode is not bit-equal to the gather")
    mse = float((rec - corpus).pow(2).mean())
    mse_fast = float((rec_fast - corpus).pow(2).mean())
    mse_int8 = float((rec_int8 - corpus).pow(2).mean())
    require(all(map(lambda v: v == v and v < 1.0, (mse, mse_fast, mse_int8))),
            f"serve: reconstruction error {mse} {mse_fast} {mse_int8}")
    del rec, rec_fast, rec_int8

    exact = primitives.quantize_batch(pq.codebooks, corpus[:N_PREFIX])
    agree_f32 = float((codes[:N_PREFIX] == exact).float().mean())
    agree_bf16 = float((codes_bf16[:N_PREFIX] == exact).float().mean())
    require(agree_f32 >= 0.999, f"serve: kernel-f32 agrees with exact on {agree_f32}")
    require(agree_bf16 >= 0.99, f"serve: kernel (bf16) agrees with exact on {agree_bf16}")

    for d, i, nq in ((d16, i16, 16), (d128, i128, 128), (d8, i8, 16), (dr, ir, 16)):
        require(d.shape == (nq, TOP_K) and i.shape == (nq, TOP_K), "serve: search shape")
        require(bool(torch.isfinite(d).all()), "serve: search distances not finite")
        require(bool((d[:, 1:] >= d[:, :-1]).all()), "serve: search distances not ascending")
        require(bool(((i >= 0) & (i < n)).all()), "serve: search index out of range")
    require(bool((ir[:, 0] == torch.arange(16, device=ir.device)).all()) and float(dr[:, 0].max()) == 0.0,
            "serve: with refine_with, a query did not find itself at rank 0")

    # The kernel scorer (splits=2: tables carry ~2^-18 relative rounding)
    # against the plain f32 scorer on a prefix: distances to rtol 1e-4, and the
    # same neighbours wherever neighbouring scores differ by more than that.
    prefix = codes[:N_PREFIX]
    overlaps = {}
    for q in (q16, q128):
        dk, ik = search(pq, q, prefix, TOP_K)
        de, ie = search(pq, q, prefix, TOP_K + 1, method="einsum")
        require(bool(torch.allclose(dk, de[:, :TOP_K], rtol=1e-4, atol=0.0)),
                "serve: kernel and einsum search distances differ")
        row_ok = ((de[:, 1:] - de[:, :-1]) > 2e-4 * de[:, 1:]).all(dim=1)
        require(bool((ik[row_ok] == ie[row_ok, :TOP_K]).all()),
                "serve: kernel and einsum search disagree on well-separated neighbours")
        overlaps[q.shape[0]] = float((ik == ie[:, :TOP_K]).float().mean())

    # Where a dense 16-query search spends its time.
    tables = adc_tables(pq, q16)
    scores = ops.adc_scores_kernel(tables, codes)
    breakdown = {
        "adc_tables_ms": time_ms(lambda: adc_tables(pq, q16)),
        "adc_kernel_ms": time_ms(lambda: ops.adc_scores_kernel(tables, codes)),
        "torch_topk_ms": time_ms(lambda: torch.topk(scores, TOP_K, dim=1, largest=False)),
    }
    del scores

    emit(
        "serve", n=n, d=D, m=M, k=K, top_k=TOP_K, search_16q_breakdown=breakdown,
        encode_bf16_rows_per_s=n / t_enc_bf16, encode_f32_rows_per_s=n / t_enc_f32,
        decode_rows_per_s=n / t_dec, decode_fast_rows_per_s=n / t_dec_fast,
        decode_int8_rows_per_s=n / t_dec_int8,
        search_16q_pairs_per_s=16 * n / t_s16, search_16q_s=t_s16,
        search_128q_pairs_per_s=128 * n / t_s128, search_128q_s=t_s128,
        search_16q_int8_pairs_per_s=16 * n / t_s8, search_16q_refine_s=t_ref,
        agree_f32_with_exact=agree_f32, agree_bf16_with_exact=agree_bf16,
        mse=mse, mse_fast=mse_fast, mse_int8=mse_int8,
        index_agreement_with_einsum=overlaps,
        peak_memory_bytes=peak, launches=launches,
    )
    return codes, launches


def kernel_table(pq, corpus, codes, launches):
    """Each kernel at the shape the serving path gives it (n = 4,000,000 rows;
    ADC with 16 queries, the dense search): time, plain version's time, one
    library call's time, and the bound."""
    cb = pq.codebooks
    n = corpus.shape[0]
    nq = 16
    tables = adc_tables(pq, corpus[:nq])
    idx_flat = codes.to(torch.int64) + torch.arange(M, device=codes.device)[None, :] * K
    cb_bytes = 4 * M * K * DS

    def library_encode():
        c_sqn = torch.einsum("mkd,mkd->mk", cb, cb)
        out = torch.empty((n, M), dtype=torch.int64, device=corpus.device)
        for i in range(0, n, N_KERNELS):
            xs = corpus[i:i + N_KERNELS].reshape(-1, M, DS)
            out[i:i + N_KERNELS] = (c_sqn[None] - 2.0 * torch.einsum("nmd,mkd->nmk", xs, cb)).argmin(dim=2)
        return out

    def library_decode():
        return torch.nn.functional.embedding(idx_flat, cb.reshape(M * K, DS))

    tables_t = tables.reshape(nq, M * K).T.contiguous()

    def library_adc():
        return torch.nn.functional.embedding_bag(idx_flat, tables_t, mode="sum")

    f32, bf16 = torch.float32, torch.bfloat16
    enc_bytes = 4 * n * D + cb_bytes + n * M
    enc_ops = 2 * n * M * K * DS
    adc_bytes = 4 * nq * M * K + n * M + 4 * nq * n
    specs = [
        ("encode_f32", lambda: ops.pq_encode(cb, corpus, compute_dtype=f32),
         lambda: ops.pq_encode_reference(cb, corpus, compute_dtype=f32), library_encode,
         lambda: compare_encode(cb, corpus, f32), bound(enc_bytes, enc_ops, "f32")),
        ("encode_bf16", lambda: ops.pq_encode(cb, corpus, compute_dtype=bf16),
         lambda: ops.pq_encode_reference(cb, corpus, compute_dtype=bf16), None,
         lambda: compare_encode(cb, corpus, bf16), bound(enc_bytes, enc_ops, "bf16")),
        ("decode", lambda: ops.pq_decode(cb, codes, splits=3),
         lambda: ops.pq_decode_reference(cb, codes, splits=3), library_decode,
         lambda: compare_decode(cb, codes, 3), bound(n * M + cb_bytes + 4 * n * D, 0, "f32")),
        ("decode_int8", lambda: ops.pq_decode(cb, codes, splits="int8"),
         lambda: ops.pq_decode_reference(cb, codes, splits="int8"), None,
         lambda: compare_decode(cb, codes, "int8"),
         bound(n * M + cb_bytes + 4 * n * D, n * D, "f32")),
        ("adc", lambda: ops.adc_scores_kernel(tables, codes, splits=2),
         lambda: ops.adc_scores_reference(tables, codes, splits=2), library_adc,
         lambda: compare_adc(tables, codes, 2), bound(adc_bytes, nq * n * M, "f32")),
        ("adc_int8", lambda: ops.adc_scores_kernel(tables, codes, splits="int8"),
         lambda: ops.adc_scores_reference(tables, codes, splits="int8"), None,
         lambda: compare_adc(tables, codes, "int8"), bound(adc_bytes, nq * n * M, "int8")),
    ]
    rows = []
    for name, kernel, plain, library, compare, (bound_ms, bound_by) in specs:
        res = compare()
        source, replaces = KERNELS[name]
        rows.append({
            "name": name, "route": "cuda", "source": source, "replaces": replaces,
            "launches": launches[name], "max_abs_err": res["max_abs_err"],
            "n_mismatch": res["n_mismatch"],
            "ms": time_ms(kernel), "plain_ms": time_ms(plain, 3),
            "bound_ms": bound_ms, "bound_by": bound_by,
            "library_ms": None if library is None else time_ms(library, 3),
            "shape": f"n={n} d={D} m={M} k={K}" + (f" nq={nq}" if name.startswith("adc") else ""),
        })
        torch.cuda.empty_cache()
    return rows


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this run needs a CUDA device",
              file=sys.stderr)
        return 1
    card = smi()
    allow_tf32 = torch.backends.cuda.matmul.allow_tf32
    emit("device", nvidia_smi=card, torch=torch.__version__, cuda=torch.version.cuda,
         allow_tf32=allow_tf32, name=torch.cuda.get_device_name(0))
    require(allow_tf32 is False, "torch.backends.cuda.matmul.allow_tf32 must be False")

    t0 = time.perf_counter()
    ptxas = ops.build_all(verbose=True)
    emit("build", seconds=time.perf_counter() - t0, sources=list(ptxas),
         spills=[ln.strip() for out in ptxas.values() for ln in out.splitlines()
                 if "spill" in ln and "0 bytes spill stores, 0 bytes spill loads" not in ln])

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(SEED)
    pq = Pq(codebooks=torch.randn((M, K, DS), generator=gen, device=dev))
    corpus = torch.randn((N_CORPUS, D), generator=gen, device=dev)

    phase_kernels(pq, corpus, gen)
    codes, launches = phase_serve(pq, corpus)
    rows = kernel_table(pq, corpus, codes, launches)
    torch.cuda.synchronize()

    print(json.dumps({"kernels": rows}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
