"""Smoke run of the PyTorch / CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the CUDA kernels of ``reductive_tpu_torch`` from the sources in this
checkout, holds each against its plain PyTorch version on the card, then
drives the serving path (encode -> decode -> ADC search), the training path
(k-means, PQ and OPQ trainers), the exact path (the verified encode,
statistics and trainers against the f32 einsum path) and the packed path
(4-bit codes, two a byte, through decode and search) at the flagship width
d=128, m=16, ds=8 (k=256; k=16 for the packed path) over a corpus of
4,000,000 rows, and checks what comes out.  The wide phase drives every
other subvector width: k-means at IVF's coarse shapes (d=128, k=4,096 over
2^20 rows; d=768, k=16,384 over 2^19 rows; m = 1, ds = d: the deep kernel),
GloVe-50's coarse stage (d=50, k=4,096 over 2^20 rows, m = 1: the deep
kernel, its rows by cp.async), a quantizer at the reference's quality-gate
width (d=20, m=10, k=128, ds=2: the narrow kernels' padded instances) over
the corpus's first 20 columns and one at d=300, m=6, k=256 (ds=50: the deep
kernel, its rows by TMA) over 2^21 rows, after a probe of the tensor cores'
accumulation that the verify bound rests on; it fails if any path launched
the shallow wide kernel, which no route takes.  It also times the any-width
decode kernels and the padded encode and statistics kernels at d=300, k=256
(m = 150 and 30), and the deep ones at m = 4 and 2 (ds = 75 and 150), over
2^21 rows, and holds the wide statistics' accumulation from the codes
(``cell_stats``) bit for bit to its plain version on the assignment's f32 and
bf16 codes at every deep shape.  The serving phase also searches
a corpus whose k-th place is always tied and holds the ids to a stable sort's.
Every phase prints one JSON line.  The run fails (non-zero exit, no result
line) without a CUDA device, when a kernel does not build, does not launch
or disagrees, or when a path did not go through its kernels.  The last line
of a good run is
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.

Times are CUDA-event medians after a warm-up.  ``bound_ms`` is the least time
the card could take: the larger of bytes moved (each input read once, each
output written once) over the memory rate and operations over the peak rate
for their type, from NVIDIA's H100 SXM data sheet.  For the f32 and verified
encode and statistics kernels it is the least over the routes that meet
their contract: three passes of the product in TF32 on the tensor cores
(``bound_route``); the fp32 pipes' figure stands beside it as
``bound_ms_fp32_pipes``.  The f32 encode and statistics kernels run one
assignment routine, and so do the bf16 ones: the kernels phase holds their
codes, counts and flags equal bit for bit on the whole corpus
(``shared_assignment``).
"""

from __future__ import annotations

import collections
import json
import logging
import os
import statistics
import subprocess
import sys
import tempfile
import time

import torch

from reductive_tpu_torch import Pq, io, kmeans, ops, train_opq_chunked, train_pq, train_pq_chunked
from reductive_tpu_torch.ops import _build
from reductive_tpu_torch.ops.adc import quantize_tables_int8
from reductive_tpu_torch.ops.assign import (
    VERIFY_ENCODE_CHUNK, _prepare, bf16_tile_plan, pq_encode_verify_flags, reset_verify_tiers,
    assign_route, deep_producer, verify_caps, verify_scale, verify_tiers,
)
from reductive_tpu_torch.ops.decode import decode_table, launch_decode, quantize_codebook_int8
from reductive_tpu_torch.ops.probe import probe_wgmma_tf32
from reductive_tpu_torch.ops.stats import (
    cell_stats, cell_stats_reference, pq_assign_stats_verify_flags, stats_from_codes,
)
from reductive_tpu_torch.pq import primitives
from reductive_tpu_torch.pq.opq import create_projection_matrix
from reductive_tpu_torch.pq.train import init_codebooks_random
from reductive_tpu_torch import search as search_module
from reductive_tpu_torch.search import adc_tables, search

SEED = 0
M, K, DS = 16, 256, 8           # flagship width
D = M * DS
N_CORPUS = 4_000_000
N_KERNELS = 65_536
N_RAGGED = 50_001
N_PREFIX = 262_144
N_IN_MEMORY = 65_536            # rows the in-memory trainers take
BITS = 8                        # K = 2**BITS
K4 = 16                         # centroids of the packed (4-bit) path
TOP_K = 10

# H100 SXM peaks (dense): bytes/s of HBM, operations/s by type.
PEAK_BYTES = 3.35e12
PEAK_OPS = {"f32": 67e12, "tf32": 495e12, "bf16": 989e12, "int8": 1979e12}
# What the kernels took at the flagship shape before their redesign for this
# card (PERF.md: the f32 and verified statistics kernels before the
# tensor-core assignment, the f32 and verified encode before it took the same
# routine, the bf16 encode and statistics before they took its bf16 mode;
# NVIDIA H100 80GB HBM3 at 700 W).
BEFORE_MS = {"stats_f32": 13.04, "stats_bf16": 6.02, "stats_verify": 17.37,
             "stats_verify_kernel": 16.86, "encode_f32": 8.70, "encode_bf16": 5.29,
             "encode_verify": 12.72, "encode_verify_kernel": 11.29, "adc": 0.698,
             "adc_u4": 0.557}

KERNELS = {
    "encode_f32": ("reductive_tpu_torch/csrc/encode.cu", "reductive_tpu/ops/assign.py:138"),
    "encode_bf16": ("reductive_tpu_torch/csrc/encode.cu", "reductive_tpu/ops/assign.py:138"),
    "decode": ("reductive_tpu_torch/csrc/decode.cu", "reductive_tpu/ops/decode.py:166"),
    "decode_int8": ("reductive_tpu_torch/csrc/decode.cu", "reductive_tpu/ops/decode.py:180"),
    "adc": ("reductive_tpu_torch/csrc/adc.cu", "reductive_tpu/ops/adc.py:59"),
    "adc_int8": ("reductive_tpu_torch/csrc/adc.cu", "reductive_tpu/ops/decode.py:180"),
    "stats_f32": ("reductive_tpu_torch/csrc/stats.cu", "reductive_tpu/ops/stats.py:50"),
    "stats_bf16": ("reductive_tpu_torch/csrc/stats.cu", "reductive_tpu/ops/stats.py:50"),
    "encode_verify": ("reductive_tpu_torch/csrc/encode.cu", "reductive_tpu/ops/assign.py:298"),
    "stats_verify": ("reductive_tpu_torch/csrc/stats.cu", "reductive_tpu/ops/stats.py:272"),
    "decode_u4": ("reductive_tpu_torch/csrc/decode.cu", "reductive_tpu/ops/decode.py:166"),
    "decode_int8_u4": ("reductive_tpu_torch/csrc/decode.cu", "reductive_tpu/ops/decode.py:180"),
    "adc_u4": ("reductive_tpu_torch/csrc/adc.cu", "reductive_tpu/ops/adc.py:59"),
    "adc_int8_u4": ("reductive_tpu_torch/csrc/adc.cu", "reductive_tpu/ops/decode.py:180"),
    "encode_f32_wide": ("reductive_tpu_torch/csrc/assign_deep.cuh", "reductive_tpu/ops/assign.py:138"),
    "encode_bf16_wide": ("reductive_tpu_torch/csrc/assign_deep.cuh", "reductive_tpu/ops/assign.py:138"),
    "encode_verify_wide": ("reductive_tpu_torch/csrc/assign_deep.cuh",
                           "reductive_tpu/ops/assign.py:298"),
    "stats_f32_wide": ("reductive_tpu_torch/csrc/stats.cu", "reductive_tpu/ops/stats.py:50"),
    "stats_bf16_wide": ("reductive_tpu_torch/csrc/stats.cu", "reductive_tpu/ops/stats.py:50"),
    "stats_verify_wide": ("reductive_tpu_torch/csrc/stats.cu", "reductive_tpu/ops/stats.py:272"),
    "decode_scalar": ("reductive_tpu_torch/csrc/decode.cu", "reductive_tpu/ops/decode.py:166"),
    "decode_int8_scalar": ("reductive_tpu_torch/csrc/decode.cu", "reductive_tpu/ops/decode.py:180"),
    "encode_f32_pad": ("reductive_tpu_torch/csrc/encode.cu", "reductive_tpu/ops/assign.py:138"),
    "encode_bf16_pad": ("reductive_tpu_torch/csrc/encode.cu", "reductive_tpu/ops/assign.py:138"),
    "encode_verify_pad": ("reductive_tpu_torch/csrc/encode.cu", "reductive_tpu/ops/assign.py:298"),
    "stats_f32_pad": ("reductive_tpu_torch/csrc/stats.cu", "reductive_tpu/ops/stats.py:50"),
    "stats_bf16_pad": ("reductive_tpu_torch/csrc/stats.cu", "reductive_tpu/ops/stats.py:50"),
    "stats_verify_pad": ("reductive_tpu_torch/csrc/stats.cu", "reductive_tpu/ops/stats.py:272"),
    "cell_stats": ("reductive_tpu_torch/csrc/stats.cu", "reductive_tpu/ops/stats.py:50"),
}
SERVE_KERNELS = ("encode_f32", "encode_bf16", "decode", "decode_int8", "adc", "adc_int8")
PACKED_KERNELS = ("decode_u4", "decode_int8_u4", "adc_u4", "adc_int8_u4")
# cell_stats: the accumulation from the codes, which every wide statistics
# launch runs in its C entry after the assignment.
WIDE_KERNELS = tuple(name for name in KERNELS
                     if name.endswith(("_wide", "_scalar", "_pad")) or name == "cell_stats")
# The wide phase's shapes: IVF's coarse stage in benches/ivf10m.py (d=128,
# 4,096 cells, over 2^20 rows) and benches/ivf100m.py (d=768, 16,384 cells,
# its 2^19-row training sample); the reference's quality-gate width, d=20,
# m=10, k=128 (ds=2), over the corpus's first 20 columns; 300-d vectors
# (fastText, word2vec and GloVe publish 300-d ones) at m=6, k=256 (ds=50,
# not a multiple of 4), over 2^21 rows; GloVe's 50-d vectors in the coarse
# stage of benches/ivf10m.py (4,096 cells over 2^20 rows; a row of 50 floats
# is not a multiple of 16 bytes: the deep kernel's cp.async rows).
IVF10M = (1 << 20, 128, 4096)
IVF100M = (1 << 19, 768, 16384)
GLOVE50 = (1 << 20, 50, 4096)
GATE_M, GATE_BITS = 10, 7
N_D300 = 1 << 21                # rows of the wide phase's 300-d shapes
D300_M = 6                      # ds = 50
D300_TIMED_DEEP_M = (4, 2)      # ds = 75 and 150, timed only


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


def compare_encode(codebooks, x, compute_dtype, scale_gap=False):
    """Kernel against plain version.  Codes may differ only where rounding
    (the f32 kernel's split product, f32 summation order) flips a near-tie:
    at least 99.9% (f32) or 99% (bf16) equal, and every differing code's
    centroid within 2^-13 (f32) or 2^-7 (bf16) relative of the other's
    distance; with ``scale_gap``, relative of ``|x_j| max|2c_j| + max|c_j|^2``,
    the scale of the products' rounding (at ds = 2 a distance is far
    smaller)."""
    got = ops.pq_encode(codebooks, x, dtype=torch.int32, compute_dtype=compute_dtype)
    want = ops.pq_encode_reference(codebooks, x, dtype=torch.int32, compute_dtype=compute_dtype)
    torch.cuda.synchronize()
    require(got.shape == want.shape and got.dtype == want.dtype, "encode: shape or dtype")
    differ = got != want
    n_mismatch = int(differ.sum())
    dg, dw = chosen_dist(codebooks, x, got), chosen_dist(codebooks, x, want)
    max_abs = float((dg - dw).abs().max())
    if scale_gap:
        m, _, ds = codebooks.shape
        cn = codebooks.double().pow(2).sum(dim=2).sqrt().amax(dim=1)
        xn = x.reshape(-1, m, ds).double().pow(2).sum(dim=2).sqrt()
        denom = 2 * xn * cn[None] + cn[None] ** 2
    else:
        denom = dw.clamp_min(1e-30)
    rel = float(((dg - dw).abs() / denom)[differ].max()) if n_mismatch else 0.0
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


def bits_differ(got, want) -> int:
    """Scores whose f32 bit patterns differ."""
    return int((got.view(torch.int32) != want.view(torch.int32)).sum())


def compare_adc(tables, codes, splits):
    """Kernel against plain version: for splits 1 to 3 bit for bit (both add
    the m entries in the order j = 0..m-1); for ``"int8"`` rtol 1e-5 with atol
    1e-5 * max|score|, the scores that differ in any bit counted beside."""
    got = ops.adc_scores_kernel(tables, codes, splits=splits)
    want = ops.adc_scores_reference(tables, codes, splits=splits)
    torch.cuda.synchronize()
    require(got.shape == want.shape, "adc: shape")
    err = (got - want).abs()
    n_bits = bits_differ(got, want)
    if splits == "int8":
        tol = 1e-5 * want.abs() + 1e-5 * float(want.abs().max())
        n_mismatch = int((err > tol).sum())
    else:
        n_mismatch = n_bits
    require(n_mismatch == 0, f"adc splits={splits}: {n_mismatch} scores differ")
    return {"n_mismatch": n_mismatch, "n_bits_differ": n_bits, "max_abs_err": float(err.max())}


def compare_stats(codebooks, x, compute_dtype):
    """Kernel against plain version, and the kernel against itself.  Two
    launches must give the same bits.  The counts sum to n*m exactly; they
    may differ from the plain version's only where f32 summation order flips
    a near-tie: per subquantizer at most n/1000 (f32) or n/100 (bf16) rows
    moved.  On cells whose counts agree the sums are within rtol 1e-5 plus
    atol 1e-4 * max|sums| (f32 sums taken in another order)."""
    n = x.shape[0]
    sums, counts = ops.pq_assign_stats(codebooks, x, compute_dtype=compute_dtype)
    sums2, counts2 = ops.pq_assign_stats(codebooks, x, compute_dtype=compute_dtype)
    want_sums, want_counts = ops.pq_assign_stats_reference(codebooks, x, compute_dtype=compute_dtype)
    torch.cuda.synchronize()
    name = f"stats {compute_dtype}"
    require(sums.shape == want_sums.shape and counts.shape == want_counts.shape, f"{name}: shape")
    require(bool(torch.equal(sums, sums2)) and bool(torch.equal(counts, counts2)),
            f"{name}: two launches on the same inputs differ")
    require(float(counts.double().sum()) == n * codebooks.shape[0], f"{name}: counts do not sum to n*m")
    moved = (counts - want_counts).abs().sum(dim=1) / 2
    limit = n * (1e-3 if compute_dtype == torch.float32 else 1e-2)
    require(float(moved.max()) <= limit, f"{name}: {float(moved.max())} rows of a subquantizer moved")
    same = counts == want_counts
    err = (sums - want_sums).abs()
    tol = 1e-5 * want_sums.abs() + 1e-4 * float(want_sums.abs().max())
    n_bad = int(((err > tol) & same[:, :, None]).sum())
    require(n_bad == 0, f"{name}: {n_bad} sums beyond tolerance")
    return {"n_mismatch": int(moved.sum()), "max_abs_err": float(err[same].max()),
            "bit_equal_launches": True}


def compare_cell_stats(codebooks, x, compute_dtype):
    """The wide statistics' accumulation alone (``cell_stats``) on the codes
    the assignment gives in ``compute_dtype``, against its plain version, which
    adds in the kernels' order: bit for bit, and two launches bit-equal.  Also
    the largest cell's share of the rows (the skew the chunks spread)."""
    k = codebooks.shape[1]
    bf16 = compute_dtype == torch.bfloat16
    codes = ops.pq_encode(codebooks, x, dtype=torch.int32, compute_dtype=compute_dtype)
    got = cell_stats(codes, x, k, round_bf16=bf16)
    again = cell_stats(codes, x, k, round_bf16=bf16)
    want = cell_stats_reference(codes, x, k, round_bf16=bf16)
    torch.cuda.synchronize()
    name = f"cell_stats {compute_dtype}"
    require(all(a.shape == b.shape for a, b in zip(got, want)), f"{name}: shape")
    require(bits_differ(got[0], again[0]) == 0 and bool(torch.equal(got[1], again[1])),
            f"{name}: two launches on the same inputs differ")
    n_bits = bits_differ(got[0], want[0]) + bits_differ(got[1], want[1])
    require(n_bits == 0, f"{name}: {n_bits} sums or counts differ from the plain version in a bit")
    require(float(got[1].double().sum()) == x.shape[0] * codebooks.shape[0], f"{name}: counts")
    return {"n_mismatch": n_bits, "max_abs_err": float((got[0] - want[0]).abs().max()),
            "bit_equal_launches": True,
            "largest_cell_share": float(got[1].max()) / x.shape[0]}


def stress_inputs(gen, dev):
    """Inputs that stress the statistics kernels' accumulation, as ``(name,
    codebooks, x)``: a corpus whose rows all fall in one cell per subquantizer
    (one thread adds a whole tile), codebooks with cells no row reaches, one
    centroid, more centroids than one staged tile (k = 260, 1024), and row
    counts of 1 and either side of a power of two."""
    def data(n, m, k, ds):
        return (torch.randn((m, k, ds), generator=gen, device=dev),
                torch.randn((n, m * ds), generator=gen, device=dev))

    cb, x = data(20_000, M, K, DS)
    yield "skewed", cb, (cb[:, K // 2].reshape(1, D) + 1e-3 * x).contiguous()
    far = cb.clone()
    far[:, K // 2:] += 1e3
    yield "unreached", far, x
    for k in (1, 260, 1024):
        yield f"k={k}", *data(20_000, 4, k, DS)
    for n in (1, 1023, 1025):
        yield f"n={n}", *data(n, M, K, DS)


def compare_encode_verify(codebooks, x):
    """Verify kernel against plain version and against the exact path.  A
    flag may differ from the plain version's where a margin sits on the
    limit (at most one row in a thousand); a code may differ only on a row
    the kernel flagged; the wrapper's codes equal the exact path's."""
    codes, flags = pq_encode_verify_flags(codebooks, x, dtype=torch.int32)
    want_codes, want_flags = ops.pq_encode_verify_reference(codebooks, x, dtype=torch.int32)
    oracle = primitives.quantize_batch(codebooks, x, dtype=torch.int32)
    fixed = ops.pq_encode_verified(codebooks, x, dtype=torch.int32)
    torch.cuda.synchronize()
    n = x.shape[0]
    differ = (codes != want_codes).any(dim=1)
    n_codes, n_flags = int((codes != want_codes).sum()), int((flags != want_flags).sum())
    require(not bool((differ & (flags == 0)).any()), "encode_verify: a code differs on an unflagged row")
    require(n_flags <= max(2, n // 1000), f"encode_verify: {n_flags} of {n} flags differ")
    n_wrong = int((fixed != oracle).sum())
    require(n_wrong == 0, f"encode_verify: {n_wrong} codes differ from the exact path")
    return {"n_mismatch": n_codes, "n_mismatch_flags": n_flags, "flagged": int(flags.sum()),
            "n_mismatch_exact": n_wrong, "max_abs_err": 0.0}


def compare_stats_verify(codebooks, x):
    """Verify kernel against plain version, against itself and against the
    exact path.  Two launches give the same bits; codes and flags as for the
    encode; the kernel's counts are those of its codes; the wrapper's counts
    equal the exact path's in every cell and its sums are within rtol 1e-5
    plus atol 1e-4 * max|sums| (f32 sums taken in another order)."""
    n = x.shape[0]
    k = codebooks.shape[1]
    sums, counts, codes, flags = pq_assign_stats_verify_flags(codebooks, x)
    again = pq_assign_stats_verify_flags(codebooks, x)
    _, _, want_codes, want_flags = ops.pq_assign_stats_verify_reference(codebooks, x)
    got_sums, got_counts = ops.pq_assign_stats_verified(codebooks, x)
    oracle = primitives.quantize_batch(codebooks, x, dtype=torch.int32)
    want_sums, want_counts = stats_from_codes(oracle, x, k)
    torch.cuda.synchronize()
    require(all(bool(torch.equal(a, b)) for a, b in zip((sums, counts, codes, flags), again)),
            "stats_verify: two launches on the same inputs differ")
    differ = (codes != want_codes).any(dim=1)
    n_codes, n_flags = int((codes != want_codes).sum()), int((flags != want_flags).sum())
    require(not bool((differ & (flags == 0)).any()), "stats_verify: a code differs on an unflagged row")
    require(n_flags <= max(2, n // 1000), f"stats_verify: {n_flags} of {n} flags differ")
    require(bool(torch.equal(stats_from_codes(codes, x, k)[1], counts)),
            "stats_verify: the kernel's counts are not those of its codes")
    require(bool(torch.equal(got_counts, want_counts)), "stats_verify: counts differ from the exact path's")
    err = (got_sums - want_sums).abs()
    tol = 1e-5 * want_sums.abs() + 1e-4 * float(want_sums.abs().max())
    n_bad = int((err > tol).sum())
    require(n_bad == 0, f"stats_verify: {n_bad} sums beyond tolerance")
    return {"n_mismatch": n_codes, "n_mismatch_flags": n_flags, "flagged": int(flags.sum()),
            "rows_moved": int((codes != oracle).any(dim=1).sum()),
            "max_abs_err": float(err.max()), "bit_equal_launches": True}


def compare_shared_assignment(codebooks, x):
    """The f32 encode and the f32 statistics kernels run one assignment
    routine: the encode's codes equal the verified statistics kernel's, its
    per-cell counts equal the f32 statistics kernel's, and the two verify
    kernels' codes and flags are equal, all bit for bit.  The bf16 encode and
    the bf16 statistics kernel run one routine too: the encode's codes
    counted per cell are the statistics kernel's counts."""
    m, k = codebooks.shape[:2]
    b_codes = ops.pq_encode(codebooks, x, dtype=torch.int32, compute_dtype=torch.bfloat16)
    b_by_code = torch.stack([torch.bincount(b_codes[:, j].long(), minlength=k) for j in range(m)])
    del b_codes
    _, b_counts = ops.pq_assign_stats(codebooks, x, compute_dtype=torch.bfloat16)
    cells_bf16 = int((b_by_code.to(torch.float32) != b_counts).sum())
    require(cells_bf16 == 0,
            f"shared assignment: encode_bf16's counts differ from stats_bf16's in {cells_bf16} cells")
    codes = ops.pq_encode(codebooks, x, dtype=torch.int32, compute_dtype=torch.float32)
    _, s_counts, s_codes, s_flags = pq_assign_stats_verify_flags(codebooks, x)
    n_codes = int((codes != s_codes).sum())
    require(n_codes == 0, f"shared assignment: {n_codes} encode_f32 codes differ from stats_verify's")
    by_code = torch.stack([torch.bincount(codes[:, j].long(), minlength=k) for j in range(m)])
    del codes
    _, counts = ops.pq_assign_stats(codebooks, x, compute_dtype=torch.float32)
    cells_f32 = int((by_code.to(torch.float32) != counts).sum())
    cells_verify = int((by_code.to(torch.float32) != s_counts).sum())
    require(cells_f32 == 0 and cells_verify == 0,
            f"shared assignment: encode_f32's counts differ from stats_f32's in {cells_f32} cells "
            f"and from stats_verify's in {cells_verify}")
    e_codes, e_flags = pq_encode_verify_flags(codebooks, x, dtype=torch.int32)
    n_vcodes = int((e_codes != s_codes).sum())
    n_flags = int((e_flags != s_flags).sum())
    require(n_vcodes == 0 and n_flags == 0,
            f"shared assignment: encode_verify and stats_verify differ in {n_vcodes} codes "
            f"and {n_flags} flags")
    torch.cuda.synchronize()
    return {"shape": f"n={x.shape[0]} d={x.shape[1]} m={m} k={k}", "codes_compared": s_codes.numel(),
            "encode_f32_codes_off_stats_verify": n_codes, "count_cells_off_stats_f32": cells_f32,
            "encode_verify_codes_off": n_vcodes, "encode_verify_flags_off": n_flags,
            "flagged_rows": int(s_flags.sum()), "encode_bf16_count_cells_off_stats_bf16": cells_bf16}


def compare_packed_decode(codebooks, codes, packed, splits):
    """Packed kernel bit-equal to its plain version (unpack, then gather) and
    to the unpacked kernel on the unpacked codes."""
    got = ops.pq_decode(codebooks, packed, splits=splits, packed=True)
    want = ops.pq_decode_reference(codebooks, packed, splits=splits, packed=True)
    unpacked = ops.pq_decode(codebooks, codes, splits=splits)
    torch.cuda.synchronize()
    n_mismatch = int((got != want).sum()) + int((got != unpacked).sum())
    require(n_mismatch == 0, f"packed decode splits={splits}: {n_mismatch} elements differ")
    return {"n_mismatch": n_mismatch, "max_abs_err": float((got - want).abs().max())}


def compare_packed_adc(tables, codes, packed, splits):
    """Packed kernel bit-equal to its plain version and to the unpacked
    kernel on the unpacked codes (all add the m entries in the order j)."""
    got = ops.adc_scores_kernel(tables, packed, splits=splits, packed=True)
    want = ops.adc_scores_reference(tables, packed, splits=splits, packed=True)
    unpacked = ops.adc_scores_kernel(tables, codes, splits=splits)
    torch.cuda.synchronize()
    n_mismatch = bits_differ(got, want) + bits_differ(got, unpacked)
    require(n_mismatch == 0, f"packed adc splits={splits}: {n_mismatch} scores differ")
    return {"n_mismatch": n_mismatch, "max_abs_err": float((got - want).abs().max())}


def compare_packed(codebooks, x, queries, shape):
    """The four packed kernels at one width; rows for the kernels line."""
    pq4 = Pq(codebooks=codebooks)
    codes = pq4.quantize_batch(x, method="kernel-f32")
    packed = ops.pack_u4_codes(codes)
    tables = adc_tables(pq4, queries)
    return [
        {"kernel": name, "shape": shape, **res} for name, res in (
            ("decode_u4_splits1", compare_packed_decode(codebooks, codes, packed, 1)),
            ("decode_u4_splits3", compare_packed_decode(codebooks, codes, packed, 3)),
            ("decode_int8_u4", compare_packed_decode(codebooks, codes, packed, "int8")),
            ("adc_u4_splits2", compare_packed_adc(tables, codes, packed, 2)),
            ("adc_int8_u4", compare_packed_adc(tables, codes, packed, "int8")),
        )
    ]


def phase_kernels(pq, corpus, gen):
    """Each kernel against its plain version at n = 65,536 and one ragged n,
    at the flagship width and, for ADC / decode / encode / stats, at d=768,
    m=24 (k=256; k=16 for the packed kernels at both widths); the statistics
    kernels also on the inputs of ``stress_inputs``; the encode and the
    statistics kernels' shared assignment on the whole corpus."""
    dev = corpus.device
    shared = compare_shared_assignment(pq.codebooks, corpus)
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
            ("adc_splits1", compare_adc(tables, codes, 1)),
            ("adc_splits2", compare_adc(tables, codes, 2)),
            ("adc_splits3", compare_adc(tables, codes, 3)),
            ("adc_int8", compare_adc(tables, codes, "int8")),
            ("stats_f32", compare_stats(pq.codebooks, x, torch.float32)),
            ("stats_bf16", compare_stats(pq.codebooks, x, torch.bfloat16)),
            ("encode_verify", compare_encode_verify(pq.codebooks, x)),
            ("stats_verify", compare_stats_verify(pq.codebooks, x)),
        ):
            rows.append({"kernel": name, "shape": f"n={n} d={D} m={M} k={K}", **res})
        rows += compare_packed(pq.codebooks[:, :K4].contiguous(), x, corpus[:16],
                               f"n={n} d={D} m={M} k={K4}")

    for name, cb_s, x_s in stress_inputs(gen, dev):
        shape = f"{name}: n={x_s.shape[0]} m={cb_s.shape[0]} k={cb_s.shape[1]} ds={cb_s.shape[2]}"
        rows.append({"kernel": "stats_f32", "shape": shape, **compare_stats(cb_s, x_s, torch.float32)})
        rows.append({"kernel": "stats_bf16", "shape": shape, **compare_stats(cb_s, x_s, torch.bfloat16)})
        rows.append({"kernel": "stats_verify", "shape": shape, **compare_stats_verify(cb_s, x_s)})
        if name == "skewed":
            counts = ops.pq_assign_stats(cb_s, x_s)[1]
            require(int((counts > 0).sum()) == M and float(counts[:, K // 2].min()) == x_s.shape[0],
                    "stats: the skewed rows did not all fall in one cell")

    m2, k2, ds2 = 24, 256, 32
    cb2 = torch.randn((m2, k2, ds2), generator=gen, device=dev)
    pq2 = Pq(codebooks=cb2)
    x2 = torch.randn((N_KERNELS, m2 * ds2), generator=gen, device=dev)
    codes2 = pq2.quantize_batch(x2, method="kernel-f32")
    shape2 = f"n={N_KERNELS} d={m2 * ds2} m={m2} k={k2}"
    rows.append({"kernel": "encode_f32", "shape": shape2,
                 **compare_encode(cb2, x2, torch.float32)})
    rows.append({"kernel": "decode_splits3", "shape": shape2, **compare_decode(cb2, codes2, 3)})
    rows.append({"kernel": "stats_f32", "shape": shape2, **compare_stats(cb2, x2, torch.float32)})
    rows.append({"kernel": "stats_bf16", "shape": shape2, **compare_stats(cb2, x2, torch.bfloat16)})
    rows.append({"kernel": "encode_verify", "shape": shape2, **compare_encode_verify(cb2, x2)})
    rows.append({"kernel": "stats_verify", "shape": shape2, **compare_stats_verify(cb2, x2)})
    rows += compare_packed(cb2[:, :K4].contiguous(), x2, x2[:16],
                           f"n={N_KERNELS} d={m2 * ds2} m={m2} k={K4}")
    for nq in (16, 128):
        tables2 = adc_tables(pq2, x2[:nq])
        for splits in (2, "int8"):
            res = compare_adc(tables2, codes2, splits)
            ms = time_ms(lambda: ops.adc_scores_kernel(tables2, codes2, splits=splits))
            plain_ms = time_ms(lambda: ops.adc_scores_reference(tables2, codes2, splits=splits), 3)
            rows.append({"kernel": "adc_int8" if splits == "int8" else "adc_splits2",
                         "shape": f"{shape2} nq={nq}", **res,
                         "kernel_ms": ms, "plain_ms": plain_ms})
    emit("kernels", compared=rows, shared_assignment=shared)


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


def host_ms(fn, reps: int = 20) -> float:
    """Milliseconds a call on the host clock, each call followed by a
    synchronisation, mean of ``reps`` after a warm-up."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
        torch.cuda.synchronize()
    return (time.perf_counter() - t0) / reps * 1e3


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
    for name in SERVE_KERNELS:
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
        "selection_ms": time_ms(lambda: search_module._smallest(scores, None, TOP_K)),
    }
    del scores
    ties = tie_check(pq, codes, q16, q128)

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
        index_agreement_with_einsum=overlaps, tie_check=ties,
        peak_memory_bytes=peak, launches=launches,
    )
    return codes, launches


def tie_check(pq, codes, q16, q128):
    """Search over a corpus of 4,000 distinct codes, each held by about 1,000
    rows spread over it, so that every query's k-th place is a tie: the ids
    must be a stable sort's first ``TOP_K`` of the same scores (lowest ids
    among equal scores, as the JAX package's ``top_k`` keeps them), dense at
    16 queries and streamed at 128.  Also reports whether ``torch.topk``
    alone keeps the lowest ids here (the property the selection no longer
    relies on)."""
    n = codes.shape[0]
    gen = torch.Generator(device=codes.device).manual_seed(SEED + 1)
    tied = codes[:4000][torch.randint(0, 4000, (n,), generator=gen, device=codes.device)]
    out = {"rows": n, "distinct_codes": 4000}
    for name, q in (("16q", q16), ("128q", q128)):
        _, ids = search(pq, q, tied, TOP_K)
        same, topk_same = True, True
        for i in range(0, q.shape[0], 16):
            scores = ops.adc_scores_kernel(adc_tables(pq, q[i:i + 16]), tied, splits=2)
            want = torch.sort(scores, dim=1, stable=True).indices[:, :TOP_K]
            same &= bool(torch.equal(ids[i:i + 16], want))
            got = torch.topk(scores, TOP_K, dim=1, largest=False).indices
            topk_same &= bool(torch.equal(torch.sort(got, dim=1).values, torch.sort(want, dim=1).values))
            del scores
        require(same, f"serve: with ties at the k-th place the {name} search ids are not a stable sort's")
        out[f"ids_equal_stable_sort_{name}"] = same
        out[f"torch_topk_keeps_lowest_ids_{name}"] = topk_same
    return out


# -- the training path ---------------------------------------------------------


class LossLog(logging.Handler):
    """Collects the per-iteration losses the trainers log at INFO."""

    def __init__(self):
        super().__init__(level=logging.INFO)
        self.losses = []

    def emit(self, record):
        if isinstance(record.msg, str) and "iteration %d" in record.msg:
            self.losses.append(float(record.args[1]))


def logged_losses(train):
    """Runs ``train()`` with the trainers' logger at INFO and returns its
    result and the per-iteration losses it logged."""
    log = LossLog()
    logger = logging.getLogger("reductive_tpu")
    level = logger.level
    logger.addHandler(log)
    logger.setLevel(logging.INFO)
    try:
        out = train()
    finally:
        logger.removeHandler(log)
        logger.setLevel(level)
    return out, log.losses


def reconstruction_mse(pq, corpus):
    codes = pq.quantize_batch(corpus, method="kernel-f32")
    return float((pq.reconstruct_batch(codes, method="kernel") - corpus).pow(2).mean())


def require_trained(name, pq, initial, corpus):
    """Finite codebooks of the flagship shape, and a lower reconstruction
    error on the corpus than the codebooks training began from."""
    require(tuple(pq.codebooks.shape) == (M, K, DS), f"train: {name} codebooks shape")
    require(bool(torch.isfinite(pq.codebooks).all()), f"train: {name} codebooks not finite")
    mse, mse0 = reconstruction_mse(pq, corpus), reconstruction_mse(initial, corpus)
    require(mse == mse and mse < mse0, f"train: {name} mse {mse} not below its initial {mse0}")
    return {"mse": mse, "mse_initial": mse0}


def phase_train(corpus):
    """The trainers through their entry points: the chunked PQ trainer over
    the whole corpus in both modes, with a checkpoint and a resume; chunked
    OPQ; and the in-memory PQ trainer and k-means on a prefix."""
    n = corpus.shape[0]
    dev = corpus.device
    f32, bf16 = torch.float32, torch.bfloat16
    gen = torch.Generator(device=dev).manual_seed(SEED)
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    expected = collections.Counter()
    out = {}

    # Chunked PQ, 4 Lloyd's iterations, each one launch of the stats kernel.
    n_it = 4
    for name, cd in (("f32", f32), ("bf16", bf16)):
        state = gen.get_state()
        pq, seconds = timed(lambda: train_pq_chunked(gen, corpus, M, BITS, n_it, compute_dtype=cd))
        expected[f"stats_{name}"] += 2 * n_it
        # Where that training began: the second call's draw, made again.
        gen.set_state(state)
        init_codebooks_random(corpus, gen, K, DS)
        initial = Pq(codebooks=init_codebooks_random(corpus, gen, K, DS))
        out[f"pq_chunked_{name}"] = {
            **require_trained(f"pq_chunked_{name}", pq, initial, corpus),
            "seconds_per_iteration": seconds / n_it, "rows_per_s": n_it * n / seconds,
        }

    # The loss of every iteration (read from the trainer's log, which makes it
    # wait for the card), a checkpoint, and a resume from the reloaded file.
    def checkpoint_and_resume():
        with tempfile.TemporaryDirectory() as tmp:
            path = os.path.join(tmp, "pq.npz")
            saved = train_pq_chunked(gen, corpus, M, BITS, n_it, checkpoint_every=2,
                                     checkpoint_path=path)
            loaded = io.load(path)
            require(bool(torch.equal(loaded.codebooks, saved.codebooks)),
                    "train: the checkpoint does not hold the trained codebooks")
            return train_pq_chunked(gen, corpus, M, BITS, 1, initial_model=loaded)

    resumed, losses = logged_losses(checkpoint_and_resume)
    expected["stats_f32"] += n_it + 1
    require(len(losses) == n_it + 1, f"train: {len(losses)} losses logged")
    require(all(b <= a * (1 + 1e-6) for a, b in zip(losses, losses[1:])),
            f"train: the f32 loss rose: {losses}")
    require(bool(torch.isfinite(resumed.codebooks).all()), "train: resumed codebooks not finite")
    out["pq_chunked_f32"]["losses_then_resumed"] = losses

    # Chunked OPQ, 2 alternations: per chunk one stats, one encode, one decode.
    n_alt, chunk = 2, 32768
    state = gen.get_state()
    opq, seconds = timed(lambda: train_opq_chunked(gen, corpus, M, BITS, n_alt, chunk=chunk))
    per_pass = -(-n // chunk)
    for name in ("stats_f32", "encode_f32", "decode"):
        expected[name] += 2 * n_alt * per_pass
    gen.set_state(state)
    projection0 = create_projection_matrix(corpus, M)
    init_codebooks_random(corpus, gen, K, DS, projection0)
    initial = Pq(codebooks=init_codebooks_random(corpus, gen, K, DS, projection0),
                 projection=projection0)
    gram = opq.projection.T @ opq.projection
    ortho_err = float((gram - torch.eye(D, device=dev)).abs().max())
    require(ortho_err <= 1e-4, f"train: OPQ projection is {ortho_err} off orthonormal")
    out["opq_chunked_f32"] = {
        **require_trained("opq_chunked_f32", opq, initial, corpus),
        "seconds_per_iteration": seconds / n_alt, "rows_per_s": n_alt * n / seconds,
        "orthonormal_err": ortho_err,
    }
    launches = ops.launch_counts()
    # The quality checks above encode and decode the corpus through the
    # kernels too: 2 launches of each per require_trained.
    expected["encode_f32"] += 2 * 3
    expected["decode"] += 2 * 3
    for name, want in expected.items():
        require(launches.get(name, 0) == want,
                f"train: {launches.get(name, 0)} launches of {name}, expected {want}")

    # In memory, on a prefix: PQ, and k-means until the loss converges.
    prefix = corpus[:N_IN_MEMORY]
    state = gen.get_state()
    pq_mem, seconds = timed(lambda: train_pq(gen, prefix, M, BITS, n_it))
    gen.set_state(state)
    init_codebooks_random(prefix, gen, K, DS)
    initial = Pq(codebooks=init_codebooks_random(prefix, gen, K, DS))
    out["pq_in_memory"] = {**require_trained("pq_in_memory", pq_mem, initial, prefix),
                           "rows": N_IN_MEMORY, "seconds_per_iteration": seconds / n_it}
    stop = kmeans.LossConvergence(max_iterations=25, rel_tol=1e-3)
    (centroids, loss), seconds = timed(lambda: kmeans.kmeans(gen, prefix, K, stop))
    loss1 = float(kmeans.kmeans_with_centroids(prefix, centroids, 1)[1])
    require(tuple(centroids.shape) == (K, D) and bool(torch.isfinite(centroids).all()),
            "train: k-means centroids")
    require(loss1 <= float(loss) * (1 + 1e-6), f"train: k-means loss rose from {float(loss)} to {loss1}")
    out["kmeans"] = {"rows": N_IN_MEMORY, "k": K, "loss": float(loss), "seconds": seconds}

    emit("train", n=n, d=D, m=M, k=K, **out, launches=launches,
         peak_memory_bytes=torch.cuda.max_memory_allocated())
    return launches, out


# -- the exact path --------------------------------------------------------------


def adversarial_corpus(codebooks, n, gen):
    """Codebooks whose last centroid repeats the first, and ``n`` rows made on
    the card in five blocks: exactly on the repeated centroid (an exact tie),
    on the midpoint of a centroid pair (a tie up to rounding), zero, Gaussian
    scaled by 1e-6, Gaussian scaled by 1e6."""
    m, k, ds = codebooks.shape
    cb = codebooks.clone()
    cb[:, k - 1] = cb[:, 0]
    fifth = n // 5
    x = torch.randn((n, m, ds), generator=gen, device=cb.device)
    sub = torch.arange(m, device=cb.device)[None, :]
    x[:fifth] = cb[:, 0][None]
    pick = torch.randint(0, k, (fifth, m), generator=gen, device=cb.device)
    x[fifth:2 * fifth] = 0.5 * (cb[sub, pick] + cb[sub, (pick + 1) % k])
    x[2 * fifth:3 * fifth] = 0.0
    x[3 * fifth:4 * fifth] *= 1e-6
    x[4 * fifth:] *= 1e6
    return cb, x.reshape(n, m * ds)


def tier_names() -> dict[str, int]:
    """The verified wrappers' tiers taken since the last reset, as
    ``{"encode_cap": calls, "stats_cap2": calls, ...}``: ``cap`` and ``cap2``
    re-encode the flagged rows only, ``exact`` the whole batch."""
    return {f"{wrapper}_{tier}": count for (wrapper, tier), count in sorted(verify_tiers().items())}


def exact_checks(name, codebooks, x, cap_frac=1 / 16):
    """``pq_encode_verified`` against the exact path on every code, and
    ``pq_assign_stats_verified`` against the exact path's counts in every
    cell (sums: rtol 1e-5 plus atol 1e-4 * max|sums|) and against itself
    (two calls, the same bits: the corrections add in a fixed order); the
    flag rates and what the kernel alone would have got wrong."""
    n = x.shape[0]
    k = codebooks.shape[1]
    oracle = primitives.quantize_batch(codebooks, x, dtype=torch.int32)
    reset_verify_tiers()
    got = ops.pq_encode_verified(codebooks, x, dtype=torch.int32, cap_frac=cap_frac)
    n_wrong = int((got != oracle).sum())
    require(n_wrong == 0, f"exact: {name}: {n_wrong} of {got.numel()} codes differ from the exact path")
    del got
    want_sums, want_counts = stats_from_codes(oracle, x, k)
    sums, counts = ops.pq_assign_stats_verified(codebooks, x, cap_frac=cap_frac)
    again = ops.pq_assign_stats_verified(codebooks, x, cap_frac=cap_frac)
    require(bool(torch.equal(sums, again[0])) and bool(torch.equal(counts, again[1])),
            f"exact: {name}: two calls of pq_assign_stats_verified differ")
    del again
    tiers = tier_names()
    cells_off = int((counts != want_counts).sum())
    require(cells_off == 0, f"exact: {name}: counts differ from the exact path's in {cells_off} cells")
    err = (sums - want_sums).abs()
    tol = 1e-5 * want_sums.abs() + 1e-4 * float(want_sums.abs().max())
    require(not bool((err > tol).any()), f"exact: {name}: sums beyond tolerance")
    codes, flags = pq_encode_verify_flags(codebooks, x, dtype=torch.int32)
    _, wide = pq_encode_verify_flags(codebooks, x, dtype=torch.int32, rho=0.0,
                                     escale=verify_scale(codebooks, 2.0 ** -14))
    wrong_rows = (codes != oracle).any(dim=1)
    require(not bool((wrong_rows & (flags == 0)).any()),
            f"exact: {name}: the kernel's code differs from the exact path's on an unflagged row")
    del codes
    # The statistics kernel takes its products on the tensor cores (3xTF32) and
    # flags with the wider limit derived for that: held to the same contract.
    _, _, s_codes, s_flags = pq_assign_stats_verify_flags(codebooks, x)
    s_wrong = (s_codes != oracle).any(dim=1)
    require(not bool((s_wrong & (s_flags == 0)).any()),
            f"exact: {name}: the statistics kernel's code differs from the exact path's on an "
            f"unflagged row")
    return {
        "rows": n, "codes_compared": oracle.numel(), "code_mismatches": n_wrong,
        "count_cells_off": cells_off, "max_abs_err_sums": float(err.max()),
        "stats_verified_bit_equal_calls": True,
        "cap_frac": cap_frac, "tiers": tiers,
        "caps": {"encode": verify_caps(n, cap_frac, VERIFY_ENCODE_CHUNK),
                 "stats": verify_caps(n, cap_frac, min(16384, max(256, n)))},
        "flag_rate": float(flags.float().mean()),
        "flag_rate_at_2^-14": float(wide.float().mean()),
        "rows_the_kernel_alone_got_wrong": int(wrong_rows.sum()),
        "stats_flag_rate": float(s_flags.float().mean()),
        "rows_the_stats_kernel_alone_got_wrong": int(s_wrong.sum()),
    }


def phase_exact(pq, corpus, train_out):
    """The verified modes at full width: encode and statistics against the
    exact f32 einsum path on the whole corpus and on an adversarial one, then
    the chunked PQ and OPQ trainers with ``compute_dtype="verified"``."""
    n = corpus.shape[0]
    dev = corpus.device
    gen = torch.Generator(device=dev).manual_seed(SEED + 1)
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    out = {"gaussian": exact_checks("gaussian", pq.codebooks, corpus)}
    cb_adv, x_adv = adversarial_corpus(pq.codebooks, N_PREFIX, gen)
    # Most of these rows are flagged: cap_frac=1.0 keeps the gather-and-move
    # route (its cap is every row); at cap_frac=1e-9 the cap is one chunk of
    # 16,384 rows and the second tier 65,536, below the flagged count, so the
    # whole batch takes the exact path.
    out["adversarial"] = exact_checks("adversarial", cb_adv, x_adv, 1.0)
    out["adversarial_cap_1e-9"] = exact_checks("adversarial cap_frac=1e-9", cb_adv, x_adv, 1e-9)
    del cb_adv, x_adv

    n_it = 4
    state = gen.get_state()
    reset_verify_tiers()
    trained, seconds = timed(
        lambda: train_pq_chunked(gen, corpus, M, BITS, n_it, compute_dtype="verified"))
    pq_tiers = tier_names()
    gen.set_state(state)
    init_codebooks_random(corpus, gen, K, DS)
    initial = Pq(codebooks=init_codebooks_random(corpus, gen, K, DS))
    _, losses = logged_losses(
        lambda: train_pq_chunked(gen, corpus, M, BITS, n_it, compute_dtype="verified"))
    require(len(losses) == n_it and all(b <= a * (1 + 1e-6) for a, b in zip(losses, losses[1:])),
            f"exact: the verified loss rose: {losses}")
    out["pq_chunked_verified"] = {
        **require_trained("pq_chunked_verified", trained, initial, corpus),
        "seconds_per_iteration": seconds / n_it, "rows_per_s": n_it * n / seconds,
        "seconds_per_iteration_f32": train_out["pq_chunked_f32"]["seconds_per_iteration"],
        "losses": losses, "tiers": pq_tiers,
    }

    state = gen.get_state()
    reset_verify_tiers()
    opq, seconds = timed(
        lambda: train_opq_chunked(gen, corpus, M, BITS, 1, compute_dtype="verified"))
    opq_tiers = tier_names()
    gen.set_state(state)
    projection0 = create_projection_matrix(corpus, M)
    init_codebooks_random(corpus, gen, K, DS, projection0)
    initial = Pq(codebooks=init_codebooks_random(corpus, gen, K, DS, projection0),
                 projection=projection0)
    ortho_err = float((opq.projection.T @ opq.projection - torch.eye(D, device=dev)).abs().max())
    require(ortho_err <= 1e-4, f"exact: OPQ projection is {ortho_err} off orthonormal")
    out["opq_chunked_verified"] = {
        **require_trained("opq_chunked_verified", opq, initial, corpus),
        "seconds_per_iteration": seconds, "rows_per_s": n / seconds,
        "seconds_per_iteration_f32": train_out["opq_chunked_f32"]["seconds_per_iteration"],
        "orthonormal_err": ortho_err, "tiers": opq_tiers,
    }
    launches = ops.launch_counts()
    require(launches.get("stats_verify", 0) > 0 and launches.get("encode_verify", 0) > 0,
            f"exact: the verified kernels were not launched: {launches}")

    # What one chunk of the OPQ loop pays for the exact mode: the wrappers wait
    # for the card (``nonzero``) and run a dozen small tensor operations on the
    # flagged rows, where the f32 calls only launch.  Host clock, synchronised.
    part = corpus[:32768]
    out["opq_chunk_32768_host_ms"] = {
        "stats_verified": host_ms(lambda: ops.pq_assign_stats_verified(pq.codebooks, part)),
        "stats_verify_kernel_alone": host_ms(lambda: pq_assign_stats_verify_flags(pq.codebooks, part)),
        "stats_f32": host_ms(lambda: ops.pq_assign_stats(pq.codebooks, part)),
        "encode_verified": host_ms(lambda: ops.pq_encode_verified(pq.codebooks, part, dtype=torch.int32)),
        "encode_verify_kernel_alone": host_ms(
            lambda: pq_encode_verify_flags(pq.codebooks, part, dtype=torch.int32)),
        "encode_f32": host_ms(
            lambda: ops.pq_encode(pq.codebooks, part, dtype=torch.int32, compute_dtype=torch.float32)),
        "flagged_rows": int(pq_encode_verify_flags(pq.codebooks, part)[1].sum()),
    }
    emit("exact", n=n, d=D, m=M, k=K, **out, launches=launches,
         peak_memory_bytes=torch.cuda.max_memory_allocated())
    return launches, out


# -- the packed path --------------------------------------------------------------


def phase_packed(corpus, gen):
    """4-bit codes at d=128, m=16, k=16, ds=8: encode with the kernel, pack two
    codes a byte, decode and search the packed corpus, and hold every result
    against the unpacked one: bit-equal reconstructions, equal indices and
    scores."""
    n = corpus.shape[0]
    pq4 = Pq(codebooks=torch.randn((M, K4, DS), generator=gen, device=corpus.device))
    q16, q128 = corpus[:16], corpus[1000:1128]
    ops.reset_launch_counts()
    codes, t_enc = timed(lambda: pq4.quantize_batch(corpus, method="kernel"))
    packed, t_pack = timed(lambda: ops.pack_u4_codes(codes))
    require(packed.shape == (n, M // 2) and packed.dtype == torch.uint8, "packed: shape/dtype")
    require(bool(torch.equal(ops.unpack_u4_codes(packed), codes)), "packed: unpack(pack) differs")

    times = {}
    for splits, name in ((3, "decode"), (1, "decode_fast"), ("int8", "decode_int8")):
        rec_u, t_u = timed(lambda: ops.pq_decode(pq4.codebooks, codes, splits=splits))
        rec_p, t_p = timed(lambda: ops.pq_decode(pq4.codebooks, packed, splits=splits, packed=True))
        require(bool(torch.equal(rec_p, rec_u)), f"packed: {name} is not bit-equal to the unpacked decode")
        times[f"{name}_rows_per_s"] = {"packed": n / t_p, "unpacked": n / t_u}
        if splits == 3:
            mse = float((rec_p - corpus).pow(2).mean())
            require(mse == mse and mse < 2.0, f"packed: reconstruction error {mse}")
        del rec_u, rec_p

    searches = {}
    peak = {}
    for label, q, kwargs in (
        ("16q", q16, {}), ("16q_streamed", q16, {"stream_chunk": 1 << 20}), ("128q", q128, {}),
        ("16q_int8", q16, {"splits": "int8"}), ("128q_int8", q128, {"splits": "int8"}),
        ("16q_refine", q16, {"refine_with": corpus}),
    ):
        torch.cuda.reset_peak_memory_stats()
        (du, iu), t_u = timed(lambda: search(pq4, q, codes, TOP_K, method="kernel", **kwargs))
        peak_u = torch.cuda.max_memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        (dp, ip), t_p = timed(lambda: search(pq4, q, packed, TOP_K, packed=True, **kwargs))
        peak_p = torch.cuda.max_memory_allocated()
        require(bool(torch.equal(ip, iu)) and bool(torch.equal(dp, du)),
                f"packed: search {label} differs from the unpacked search")
        require(dp.shape == (q.shape[0], TOP_K) and bool(torch.isfinite(dp).all())
                and bool(((ip >= 0) & (ip < n)).all()), f"packed: search {label} result")
        searches[label] = {"packed_s": t_p, "unpacked_s": t_u,
                           "packed_pairs_per_s": q.shape[0] * n / t_p,
                           "unpacked_pairs_per_s": q.shape[0] * n / t_u}
        peak[label] = {"packed": peak_p, "unpacked": peak_u}
    launches = ops.launch_counts()
    for name in PACKED_KERNELS:
        require(launches.get(name, 0) > 0, f"packed: kernel {name} was never launched")
    emit("packed", n=n, d=D, m=M, k=K4, bytes_per_row={"packed": M // 2, "unpacked": M},
         encode_rows_per_s=n / t_enc, pack_rows_per_s=n / t_pack, mse=mse, **times,
         search=searches, peak_memory_bytes=peak, launches=launches)
    return pq4, codes, packed, launches


# -- the wide phase: every subvector width -------------------------------------------


def require_no_shallow(phase, launches):
    """No route takes the shallow wide kernel (``csrc/assign_wide.cuh``,
    counters ``*_shallow``): only tests and tools force it."""
    shallow = sorted(name for name in launches if name.endswith("_shallow"))
    require(not shallow, f"{phase}: the shallow wide kernel was launched: {shallow}")


def library_assign(codebooks, x, compute_dtype=torch.float32):
    """The yardstick of the encode kernels: per chunk of rows one PyTorch
    product, ``baddbmm(|c|^2, x_j, (2c_j)^T, alpha=-1)`` (``addmm`` at m = 1;
    f32 with TF32 off, or in bf16), then ``argmin``."""
    m, k, ds = codebooks.shape
    c_sqn = torch.einsum("mkd,mkd->mk", codebooks, codebooks)[:, None, :]
    w = (codebooks + codebooks).transpose(1, 2)
    if compute_dtype == torch.bfloat16:
        c_sqn, w = c_sqn.to(torch.bfloat16), w.to(torch.bfloat16)
    out = torch.empty((x.shape[0], m), dtype=torch.int64, device=x.device)
    step = max(1, (1 << 26) // (m * k))
    for i in range(0, x.shape[0], step):
        xs = x[i:i + step].reshape(-1, m, ds).transpose(0, 1).to(w.dtype)
        out[i:i + step] = torch.baddbmm(c_sqn, xs, w, alpha=-1).argmin(dim=2).T
    return out


def library_assign_stats(codebooks, x, compute_dtype=torch.float32):
    """The yardstick of the statistics kernels: ``library_assign``, then
    ``index_add_`` of the rows (float atomics) and ``bincount``."""
    m, k, ds = codebooks.shape
    cells = (library_assign(codebooks, x, compute_dtype)
             + torch.arange(m, device=x.device)[None, :] * k).reshape(-1)
    rows = x if compute_dtype == torch.float32 else x.to(torch.bfloat16).to(torch.float32)
    sums = torch.zeros((m * k, ds), device=x.device).index_add_(0, cells, rows.reshape(-1, ds))
    return sums, torch.bincount(cells, minlength=m * k)


def library_decode_int8(codebooks, codes):
    """``F.embedding`` over the int8 codebook dequantized once (outside the
    call): the int8 decode's function up to the one rounded multiply."""
    m, k, ds = codebooks.shape
    w8, scale = quantize_codebook_int8(codebooks)
    table = (w8.to(torch.float32) * scale.reshape(m, 1, ds)).reshape(m * k, ds)
    idx = codes.to(torch.int64) + torch.arange(m, device=codes.device)[None, :] * k
    return lambda: torch.nn.functional.embedding(idx, table)


def exact_line(name, codebooks, x):
    """``exact_checks`` with its rates under their own names."""
    res = exact_checks(name, codebooks, x)
    return {key: res[key] for key in ("rows", "codes_compared", "code_mismatches",
                                      "count_cells_off", "flag_rate", "stats_flag_rate", "tiers",
                                      "caps", "rows_the_kernel_alone_got_wrong", "max_abs_err_sums")}


def train_quantizer(gen, x, m, bits):
    """One Lloyd's iteration of the chunked PQ trainer in each mode (bf16,
    then f32 and verified from the model before), and the model."""
    pq = train_pq_chunked(gen, x, m, bits, 1, compute_dtype=torch.bfloat16)
    pq = train_pq_chunked(gen, x, m, bits, 1, initial_model=pq)
    return train_pq_chunked(gen, x, m, bits, 1, compute_dtype="verified", initial_model=pq)


def phase_wide(corpus, gen):
    """Every subvector width on the card: the probe of the tensor cores'
    accumulation; then, with every count at 0, k-means at IVF's two coarse
    shapes and at GloVe-50's (the deep kernel, TMA and cp.async rows), a ds = 2
    quantizer (the narrow kernels' padded instances) and a ds = 50 one (the
    deep kernel) through their entry points; then each kernel of those paths
    against its plain version, encode against statistics, two statistics
    launches bit-equal, the verified paths against the exact one, the
    accumulation from the codes (``cell_stats``) bit for bit its plain
    version on the f32 and bf16 codes at every deep shape, and the times,
    with the padded kernels also at the 300-d widths m = 150 (ds = 2) and
    m = 30 (ds = 10) and the deep ones at m = 4 and 2 (ds = 75 and 150).
    Returns the probe, the path's launches and the rows of the kernels line."""
    dev = corpus.device
    f32, bf16 = torch.float32, torch.bfloat16
    # The TF32 instructions of the narrow route (N = 64) and of the deep
    # kernel (N = 128, A from registers, B swizzled).
    probe = {f"m64n{n}k8": probe_wgmma_tf32(dev, n=n) for n in (64, 128)}
    for name, report in probe.items():
        require(report["ok"], f"wide: the tensor cores do not accumulate as the verify bound assumes "
                              f"in {name}: {report}")

    n_a, d_a, k_a = IVF10M
    n_b, d_b, k_b = IVF100M
    xa = torch.randn((n_a, d_a), generator=gen, device=dev)
    xb = torch.randn((n_b, d_b), generator=gen, device=dev)
    n_g, d_g, k_g = GLOVE50
    xg = torch.randn((n_g, d_g), generator=gen, device=dev)
    x20 = corpus[:, :20].contiguous()
    x300 = torch.randn((N_D300, 300), generator=gen, device=dev)
    ca = xa[kmeans.random_distinct_indices(gen, n_a, k_a)]
    cb0 = xb[kmeans.random_distinct_indices(gen, n_b, k_b)]
    cg = xg[kmeans.random_distinct_indices(gen, n_g, k_g)]
    torch.cuda.synchronize()

    ops.reset_launch_counts()
    reset_verify_tiers()
    t0 = time.perf_counter()
    losses_a = []
    for cd in (f32, f32, "verified"):  # one Lloyd's iteration a call, to read every loss
        ca, loss = kmeans.kmeans_with_centroids_chunked(xa, ca, 1, compute_dtype=cd)
        losses_a.append(float(loss))
    torch.cuda.synchronize()
    t_a = time.perf_counter() - t0
    t0 = time.perf_counter()
    start_b = ops.assign_nearest(cb0, xb, compute_dtype=f32)
    cb1, loss_b = kmeans.kmeans_with_centroids_chunked(xb, cb0, 1)
    near_bf16 = ops.assign_nearest(cb1, xb, compute_dtype=bf16)
    near_f32 = ops.assign_nearest(cb1, xb, compute_dtype=f32)
    verified_b = ops.pq_encode_verified(cb1[None], xb, dtype=torch.int32)
    torch.cuda.synchronize()
    t_b = time.perf_counter() - t0
    t0 = time.perf_counter()
    losses_g = []
    for cd in (f32, "verified"):
        cg, loss = kmeans.kmeans_with_centroids_chunked(xg, cg, 1, compute_dtype=cd)
        losses_g.append(float(loss))
    near_g = ops.assign_nearest(cg, xg, compute_dtype=bf16)
    torch.cuda.synchronize()
    t_g = time.perf_counter() - t0
    t0 = time.perf_counter()
    pq20 = train_quantizer(gen, x20, GATE_M, GATE_BITS)
    codes20_bf16 = pq20.quantize_batch(x20, method="kernel")
    codes20 = pq20.quantize_batch(x20, method="kernel-f32")
    verified20 = ops.pq_encode_verified(pq20.codebooks, x20)
    rec20 = pq20.reconstruct_batch(codes20, method="kernel")
    rec20_int8 = pq20.reconstruct_batch(codes20, method="kernel-int8")
    torch.cuda.synchronize()
    t_c = time.perf_counter() - t0
    t0 = time.perf_counter()
    pq300 = train_quantizer(gen, x300, D300_M, 8)
    codes300_bf16 = pq300.quantize_batch(x300, method="kernel")
    codes300 = pq300.quantize_batch(x300, method="kernel-f32")
    verified300 = ops.pq_encode_verified(pq300.codebooks, x300)
    torch.cuda.synchronize()
    t_d = time.perf_counter() - t0
    launches = ops.launch_counts()
    path_tiers = tier_names()
    for name in WIDE_KERNELS:
        require(launches.get(name, 0) > 0, f"wide: kernel {name} was never launched")
    require_no_shallow("wide", launches)

    # What came out: finite centroids, falling losses, codes in range.
    loss_b0 = float((xb - cb0[start_b.long()]).pow(2).mean())
    require(all(b <= a * (1 + 1e-6) for a, b in zip(losses_a, losses_a[1:])),
            f"wide: the d={d_a} k-means loss rose: {losses_a}")
    require(float(loss_b) < loss_b0, f"wide: the d={d_b} loss {float(loss_b)} is not below {loss_b0}")
    require(losses_g[1] <= losses_g[0] * (1 + 1e-6), f"wide: the d={d_g} k-means loss rose: {losses_g}")
    require(bool(torch.isfinite(ca).all()) and bool(torch.isfinite(cb1).all())
            and bool(torch.isfinite(cg).all()), "wide: centroids")
    for codes, k in ((near_bf16, k_b), (near_f32, k_b), (verified_b, k_b), (near_g, k_g),
                     (codes300_bf16, 256),
                     (codes300, 256), (verified300, 256), (verified20, 1 << GATE_BITS)):
        require(int(codes.long().min()) >= 0 and int(codes.long().max()) < k,
                "wide: a code out of range")
    require(bool(torch.isfinite(pq20.codebooks).all()) and bool(torch.isfinite(pq300.codebooks).all()),
            "wide: a trained codebook is not finite")
    mse20 = float((rec20 - x20).pow(2).mean())
    mse20_int8 = float((rec20_int8 - x20).pow(2).mean())
    require(mse20 < 0.1 and mse20_int8 < 0.1, f"wide: ds=2 reconstruction error {mse20} {mse20_int8}")
    require(bool(torch.equal(rec20, primitives.reconstruct_batch(pq20.codebooks, codes20))),
            "wide: the ds=2 decode is not bit-equal to the gather")
    agree20 = float((codes20_bf16 == codes20).float().mean())
    agree300 = float((codes300_bf16 == codes300).float().mean())
    del rec20, rec20_int8, start_b, codes300_bf16, codes300, verified300, near_g

    # Each kernel against its plain version, shape by shape; encode against
    # statistics; the verified paths against the exact one.
    shapes = {
        "ivf10m": (ca[None].contiguous(), xa),
        "ivf100m": (cb1[None].contiguous(), xb),
        "glove50": (cg[None].contiguous(), xg),
        "gate_ds2": (pq20.codebooks, x20),
        "d300_m6": (pq300.codebooks, x300),
    }
    routes = {label: assign_route(cb.shape[2], x.data_ptr() % 16 == 0)
              for label, (cb, x) in shapes.items()}
    require(routes == {"ivf10m": "deep", "ivf100m": "deep", "glove50": "deep", "gate_ds2": "narrow",
                       "d300_m6": "deep"}, f"wide: the shapes take other routes: {routes}")
    producers = {label: deep_producer(cb.shape[0], cb.shape[2])
                 for label, (cb, _) in shapes.items() if routes[label] == "deep"}
    require(producers == {"ivf10m": "tma", "ivf100m": "tma", "glove50": "cp.async", "d300_m6": "tma"},
            f"wide: the deep kernel's rows come otherwise: {producers}")
    suffix = {label: "_pad" if route == "narrow" else "_wide" for label, route in routes.items()}
    compared, exact, shared = [], {}, {}
    for label, (cb, x) in shapes.items():
        shape = f"n={x.shape[0]} d={x.shape[1]} m={cb.shape[0]} k={cb.shape[1]}"
        sfx = suffix[label]
        for name, res in (
            ("encode_f32", compare_encode(cb, x, f32, scale_gap=True)),
            ("encode_bf16", compare_encode(cb, x, bf16, scale_gap=True)),
            ("stats_f32", compare_stats(cb, x, f32)),
            ("encode_verify", compare_encode_verify(cb, x)),
            ("stats_verify", compare_stats_verify(cb, x)),
        ) + ((("stats_bf16", compare_stats(cb, x, bf16)),)
             if label.startswith(("gate", "d300", "glove")) else ()):
            compared.append({"kernel": name + sfx, "shape": shape, **res})
        if label == "gate_ds2":
            for name, res in (("decode_scalar", compare_decode(cb, codes20, 3)),
                              ("decode_int8_scalar", compare_decode(cb, codes20, "int8"))):
                compared.append({"kernel": name, "shape": shape, **res})
        if routes[label] == "deep":
            for cd in (f32, bf16):
                compared.append({"kernel": "cell_stats", "shape": shape,
                                 "codes": str(cd).removeprefix("torch."),
                                 **compare_cell_stats(cb, x, cd)})
        shared[label] = compare_shared_assignment(cb, x)
        exact[label] = exact_line(label, cb, x)
        torch.cuda.empty_cache()

    # Times at every shape; the kernels line takes each kernel at the largest
    # shape its path gives it.
    cb_a, _ = shapes["ivf10m"]
    cb_b, _ = shapes["ivf100m"]
    cb_c = pq20.codebooks

    def row(name, cb, x, kernel, plain, library, nbytes, nops, op_type, alone=None):
        bound_ms, bound_by = bound(nbytes, nops, op_type)
        m, k, ds = cb.shape
        reset_verify_tiers()
        out = {"name": name, "shape": f"n={x.shape[0]} d={m * ds} m={m} k={k} ds={ds}",
               "ms": time_ms(kernel, 3)}
        if verify_tiers():  # the verified wrapper: the tier its timed calls took
            out["tiers"] = tier_names()
        out.update({"plain_ms": time_ms(plain, 1), "library_ms": time_ms(library, 1),
                    "bound_ms": bound_ms, "bound_by": bound_by})
        if alone is not None:
            out["kernel_ms"] = time_ms(alone, 3)
        torch.cuda.empty_cache()
        return out

    def assign_rows(cb, x, sfx="_wide", with_bf16=True):
        n, d = x.shape
        m, k, ds = cb.shape
        nbytes = 4 * n * d + 4 * m * k * ds + 4 * n * m
        ops_ = 2 * n * m * k * ds
        rows = [
            row("encode_f32" + sfx, cb, x,
                lambda: ops.pq_encode(cb, x, dtype=torch.int32, compute_dtype=f32),
                lambda: ops.pq_encode_reference(cb, x, dtype=torch.int32, compute_dtype=f32),
                lambda: library_assign(cb, x, f32), nbytes, 3 * ops_, "tf32"),
            row("encode_verify" + sfx, cb, x,
                lambda: ops.pq_encode_verified(cb, x, dtype=torch.int32),
                lambda: ops.pq_encode_verify_reference(cb, x, dtype=torch.int32),
                lambda: primitives.quantize_batch(cb, x, dtype=torch.int32),
                nbytes + 4 * n, 3 * ops_, "tf32",
                alone=lambda: pq_encode_verify_flags(cb, x, dtype=torch.int32)),
        ]
        if with_bf16:
            rows.append(row("encode_bf16" + sfx, cb, x,
                            lambda: ops.pq_encode(cb, x, dtype=torch.int32, compute_dtype=bf16),
                            lambda: ops.pq_encode_reference(cb, x, dtype=torch.int32,
                                                            compute_dtype=bf16),
                            lambda: library_assign(cb, x, bf16), nbytes, ops_, "bf16"))
        return rows

    def stats_rows(cb, x, modes, sfx="_wide"):
        n, d = x.shape
        m, k, ds = cb.shape
        nbytes = 4 * n * d + 4 * m * k * ds + 4 * m * k * (ds + 1)
        ops_ = 2 * n * m * k * ds
        rows = []
        for mode in modes:
            if mode == "verify":
                rows.append(row("stats_verify" + sfx, cb, x,
                                lambda: ops.pq_assign_stats_verified(cb, x),
                                lambda: ops.pq_assign_stats_verify_reference(cb, x),
                                lambda: stats_from_codes(primitives.quantize_batch(
                                    cb, x, dtype=torch.int32), x, k),
                                nbytes + 4 * n + 4 * n * m, 3 * ops_, "tf32",
                                alone=lambda: pq_assign_stats_verify_flags(cb, x)))
            else:
                cd = f32 if mode == "f32" else bf16
                rows.append(row(f"stats_{mode}{sfx}", cb, x,
                                lambda: ops.pq_assign_stats(cb, x, compute_dtype=cd),
                                lambda: ops.pq_assign_stats_reference(cb, x, compute_dtype=cd),
                                lambda: library_assign_stats(cb, x, cd), nbytes,
                                3 * ops_ if mode == "f32" else ops_,
                                "tf32" if mode == "f32" else "bf16"))
        return rows

    def cell_rows(cb, x):
        """The accumulation alone (``cell_stats``, the wrapper) on the
        assignment's f32 codes (``cell_stats``) and bf16 codes
        (``cell_stats_bf16``, the rows rounded): its plain version, and the
        library's ``index_add_`` (float atomics) and ``bincount`` on the same
        cells.  Its bound: the codes and x read, the sums and counts written."""
        n, d = x.shape
        m, k, ds = cb.shape
        nbytes = 4 * n * m + 4 * n * d + 4 * m * k * (ds + 1)
        out = []
        for cd in (f32, bf16):
            rb = cd == bf16
            codes = ops.pq_encode(cb, x, dtype=torch.int32, compute_dtype=cd).T.contiguous().T
            cells = (codes.to(torch.int64) + torch.arange(m, device=dev)[None, :] * k).reshape(-1)
            xr = (x.to(bf16).to(f32) if rb else x).reshape(-1, ds)

            def library():
                sums = torch.zeros((m * k, ds), device=dev).index_add_(0, cells, xr)
                return sums, torch.bincount(cells, minlength=m * k)

            r = row("cell_stats" + ("_bf16" if rb else ""), cb, x,
                    lambda: cell_stats(codes, x, k, round_bf16=rb),
                    lambda: cell_stats_reference(codes, x, k, round_bf16=rb), library,
                    nbytes, 0, "f32")
            r["largest_cell_share"] = float(torch.bincount(cells, minlength=m * k).max()) / n
            out.append(r)
            del codes, cells, xr
        return out

    def decode_rows(cb, codes):
        """The two any-width decode kernels: wrapper, C entry alone (the table
        built outside the timed call), plain version, ``F.embedding``."""
        n, m = codes.shape
        _, k, ds = cb.shape
        nbytes = n * m + 4 * m * k * ds + 4 * n * m * ds  # codes, codebook, output once each
        idx = codes.to(torch.int64) + torch.arange(m, device=dev)[None, :] * k
        out = torch.empty((n, m * ds), device=dev)
        rows = []
        for name, splits in (("decode_scalar", 3), ("decode_int8_scalar", "int8")):
            table = decode_table(cb, splits)
            library = (library_decode_int8(cb, codes) if splits == "int8" else
                       lambda: torch.nn.functional.embedding(idx, table[0].reshape(-1, ds)))
            rows.append(row(name, cb, codes, lambda: ops.pq_decode(cb, codes, splits=splits),
                            lambda: ops.pq_decode_reference(cb, codes, splits=splits), library,
                            nbytes, n * m * ds if splits == "int8" else 0, "f32",
                            alone=lambda: launch_decode(table, codes, out)))
        del idx, out
        return rows

    cb_d, _ = shapes["d300_m6"]
    times = {
        "ivf10m": stats_rows(cb_a, xa, ("f32", "verify")) + cell_rows(cb_a, xa),
        "ivf100m": assign_rows(cb_b, xb) + stats_rows(cb_b, xb, ("f32",)),
        "gate_ds2": assign_rows(cb_c, x20, "_pad") + stats_rows(cb_c, x20, ("bf16", "f32", "verify"), "_pad")
        + decode_rows(cb_c, codes20),
        "d300_m6": assign_rows(cb_d, x300) + stats_rows(cb_d, x300, ("bf16", "f32", "verify"))
        + cell_rows(cb_d, x300),
        "glove50": assign_rows(shapes["glove50"][0], xg)
        + stats_rows(shapes["glove50"][0], xg, ("bf16", "f32", "verify"))
        + cell_rows(shapes["glove50"][0], xg),
    }
    # 300-d embeddings (fastText, word2vec and GloVe publish 300-d vectors), k=256,
    # at m = 150 (ds = 2) and m = 30 (ds = 10): the decode kernels (the f32 table,
    # 307 KB, does not fit a block's shared memory, the int8 one, 78 KB, would) and
    # the padded encode and statistics kernels, each held to its plain version;
    # timed only.
    for m_w in (150, 30):
        shape = f"n={N_D300} d=300 m={m_w} k=256"
        cb_w = torch.randn((m_w, 256, 300 // m_w), generator=gen, device=dev)
        for name, res in (("encode_f32_pad", compare_encode(cb_w, x300, f32, scale_gap=True)),
                          ("encode_bf16_pad", compare_encode(cb_w, x300, bf16, scale_gap=True)),
                          ("stats_f32_pad", compare_stats(cb_w, x300, f32)),
                          ("stats_bf16_pad", compare_stats(cb_w, x300, bf16))):
            compared.append({"kernel": name, "shape": shape, **res})
        codes_w = torch.randint(0, 256, (N_D300, m_w), generator=gen, device=dev, dtype=torch.uint8)
        for name, splits in (("decode_scalar", 3), ("decode_int8_scalar", "int8")):
            compared.append({"kernel": name, "shape": shape, **compare_decode(cb_w, codes_w, splits)})
        times[f"d300_m{m_w}"] = (decode_rows(cb_w, codes_w)
                                 + assign_rows(cb_w, x300, "_pad")
                                 + stats_rows(cb_w, x300, ("bf16", "f32"), "_pad"))
        del cb_w, codes_w
        torch.cuda.empty_cache()
    # The same vectors at m = 4 and 2 (ds = 75 and 150): the deep kernel, its
    # rows by TMA; each kernel held to its plain version, timed only.
    for m_w in D300_TIMED_DEEP_M:
        shape = f"n={N_D300} d=300 m={m_w} k=256"
        cb_w = torch.randn((m_w, 256, 300 // m_w), generator=gen, device=dev)
        ops.reset_launch_counts()
        for name, res in (("encode_f32_wide", compare_encode(cb_w, x300, f32, scale_gap=True)),
                          ("encode_bf16_wide", compare_encode(cb_w, x300, bf16, scale_gap=True)),
                          ("stats_f32_wide", compare_stats(cb_w, x300, f32)),
                          ("stats_bf16_wide", compare_stats(cb_w, x300, bf16))):
            compared.append({"kernel": name, "shape": shape, **res})
        for cd in (f32, bf16):
            compared.append({"kernel": "cell_stats", "shape": shape,
                             "codes": str(cd).removeprefix("torch."),
                             **compare_cell_stats(cb_w, x300, cd)})
        require_no_shallow(f"d300_m{m_w}", ops.launch_counts())
        times[f"d300_m{m_w}"] = (assign_rows(cb_w, x300)
                                 + stats_rows(cb_w, x300, ("bf16", "f32", "verify"))
                                 + cell_rows(cb_w, x300))
        del cb_w
        torch.cuda.empty_cache()
    largest = {"encode_f32_wide": "ivf100m", "encode_bf16_wide": "ivf100m",
               "encode_verify_wide": "ivf100m", "stats_f32_wide": "ivf100m",
               "stats_verify_wide": "ivf10m", "stats_bf16_wide": "d300_m6",
               "decode_scalar": "gate_ds2", "decode_int8_scalar": "gate_ds2", "cell_stats": "d300_m6",
               **{name: "gate_ds2" for name in KERNELS if name.endswith("_pad")}}
    errors = collections.defaultdict(float)
    for c in compared:
        errors[c["kernel"]] = max(errors[c["kernel"]], c["max_abs_err"])
    table = []
    for name, label in largest.items():
        found = next(r for r in times[label] if r["name"] == name)
        source, replaces = KERNELS[name]
        table.append({"name": name, "route": "cuda", "source": source, "replaces": replaces,
                      "launches": launches[name], "max_abs_err": errors[name], **found})

    emit("wide", probe=probe, seconds={"ivf10m_3_iterations": t_a, "ivf100m_path": t_b,
                                       "glove50_2_iterations": t_g, "gate_ds2_path": t_c,
                                       "d300_m6_path": t_d},
         ivf10m_losses=losses_a, ivf100m_loss={"initial": loss_b0, "after_1": float(loss_b)},
         glove50_losses=losses_g,
         gate_ds2={"mse": mse20, "mse_int8": mse20_int8, "bf16_agrees_with_f32": agree20},
         d300_m6={"bf16_agrees_with_f32": agree300},
         exact=exact, shared_assignment=shared, compared=compared, times=times,
         tiers=path_tiers,
         routes=routes, producers=producers,
         launches=launches)
    del xa, xb, xg, x20, x300
    torch.cuda.empty_cache()
    return probe, launches, table


def bf16_entries(cb, x):
    """The C entries of the bf16 encode (uint8 codes) and statistics kernels
    alone, as two callables, the operands prepared outside (``_prepare``'s
    rounded ``2c`` and ``|c|^2``, the plans, the outputs); nothing counted."""
    n = x.shape[0]
    m, k, ds = cb.shape
    cb2, c_sqn = _prepare(cb, x, torch.uint8, torch.bfloat16)
    sms = torch.cuda.get_device_properties(x.device).multi_processor_count
    enc, st = bf16_tile_plan(n, m, k, ds, sms=sms), bf16_tile_plan(n, m, k, ds)
    codes = torch.empty((n, m), dtype=torch.uint8, device=x.device)
    partial = torch.empty((st.blocks, m, k, ds + 1), device=x.device)
    sums, counts = torch.empty((m, k, ds), device=x.device), torch.empty((m, k), device=x.device)
    stream = torch.cuda.current_stream().cuda_stream
    ptrs = (x.data_ptr(), cb2.data_ptr(), c_sqn.data_ptr())
    return (
        lambda: _build.launch("rt_encode_bf16", None, *ptrs, codes.data_ptr(), n, m, k, ds, 1,
                              enc.rows, enc.blocks, enc.smem_bytes, stream),
        lambda: _build.launch("rt_assign_stats_bf16", None, *ptrs, partial.data_ptr(),
                              sums.data_ptr(), counts.data_ptr(), n, m, k, ds, st.rows, st.blocks,
                              st.smem_bytes, stream),
    )


def kernel_table(pq, corpus, codes, launches, pq4, codes4, packed4):
    """Each kernel at the shape the main paths give it (n = 4,000,000 rows;
    ADC with 16 queries, the dense search; k=16 for the packed kernels): time,
    plain version's time, one library call's time, and the bound.  For the
    verified kernels ``ms`` is the whole wrapper (kernel, ``nonzero``, exact
    re-encode of the flagged rows) and ``kernel_ms`` the kernel alone; their
    library call is the exact path itself.  The bf16 encode and statistics
    rows carry ``kernel_ms`` too: their C entries alone."""
    cb = pq.codebooks
    encode_bf16_alone, stats_bf16_alone = bf16_entries(cb, corpus)
    n = corpus.shape[0]
    nq = 16
    tables = adc_tables(pq, corpus[:nq])
    idx_flat = codes.to(torch.int64) + torch.arange(M, device=codes.device)[None, :] * K
    cb_bytes = 4 * M * K * DS

    def library_decode():
        return torch.nn.functional.embedding(idx_flat, cb.reshape(M * K, DS))

    tables_t = tables.reshape(nq, M * K).T.contiguous()

    def library_adc():
        return torch.nn.functional.embedding_bag(idx_flat, tables_t, mode="sum")

    def library_exact_stats():
        return stats_from_codes(primitives.quantize_batch(cb, corpus, dtype=torch.int32), corpus, K)

    def library_adc_int8(tab, idx):
        """``F.embedding_bag`` over the int8 tables dequantized once (outside
        the call), each entry carrying 1/m of the query's offset."""
        nq_, m_, k_ = tab.shape
        t8, scale, offset = quantize_tables_int8(tab)
        deq = t8.to(torch.float32) * scale[:, None, None] + (offset / m_)[:, None, None]
        deq_t = deq.reshape(nq_, m_ * k_).T.contiguous()
        return lambda: torch.nn.functional.embedding_bag(idx, deq_t, mode="sum")

    cb4 = pq4.codebooks
    tables4 = adc_tables(pq4, corpus[:nq])
    cb4_bytes = 4 * M * K4 * DS
    dec4_bytes = n * M // 2 + cb4_bytes + 4 * n * D
    adc4_bytes = 4 * nq * M * K4 + n * M // 2 + 4 * nq * n
    idx4_flat = codes4.to(torch.int64) + torch.arange(M, device=codes.device)[None, :] * K4
    tables4_t = tables4.reshape(nq, M * K4).T.contiguous()

    f32, bf16 = torch.float32, torch.bfloat16
    stats_bytes = 4 * n * D + cb_bytes + 4 * M * K * (DS + 1)
    enc_bytes = 4 * n * D + cb_bytes + n * M
    enc_ops = 2 * n * M * K * DS
    adc_bytes = 4 * nq * M * K + n * M + 4 * nq * n
    # The f32 and verified encode and statistics kernels: the least over the
    # routes that meet the contract is three TF32 passes of the product on the
    # tensor cores.
    split = {"bound_route": "3xTF32 on the tensor cores",
             "bound_ms_fp32_pipes": enc_ops / PEAK_OPS["f32"] * 1e3}
    split_names = ("encode_f32", "encode_verify", "stats_f32", "stats_verify")
    specs = [
        ("encode_f32", lambda: ops.pq_encode(cb, corpus, compute_dtype=f32),
         lambda: ops.pq_encode_reference(cb, corpus, compute_dtype=f32),
         lambda: library_assign(cb, corpus, f32),
         lambda: compare_encode(cb, corpus, f32), bound(enc_bytes, 3 * enc_ops, "tf32")),
        ("encode_bf16", lambda: ops.pq_encode(cb, corpus, compute_dtype=bf16),
         lambda: ops.pq_encode_reference(cb, corpus, compute_dtype=bf16),
         lambda: library_assign(cb, corpus, bf16),
         lambda: compare_encode(cb, corpus, bf16), bound(enc_bytes, enc_ops, "bf16"),
         encode_bf16_alone),
        ("decode", lambda: ops.pq_decode(cb, codes, splits=3),
         lambda: ops.pq_decode_reference(cb, codes, splits=3), library_decode,
         lambda: compare_decode(cb, codes, 3), bound(n * M + cb_bytes + 4 * n * D, 0, "f32")),
        ("decode_int8", lambda: ops.pq_decode(cb, codes, splits="int8"),
         lambda: ops.pq_decode_reference(cb, codes, splits="int8"),
         library_decode_int8(cb, codes),
         lambda: compare_decode(cb, codes, "int8"),
         bound(n * M + cb_bytes + 4 * n * D, n * D, "f32")),
        ("adc", lambda: ops.adc_scores_kernel(tables, codes, splits=2),
         lambda: ops.adc_scores_reference(tables, codes, splits=2), library_adc,
         lambda: compare_adc(tables, codes, 2), bound(adc_bytes, nq * n * M, "f32")),
        ("adc_int8", lambda: ops.adc_scores_kernel(tables, codes, splits="int8"),
         lambda: ops.adc_scores_reference(tables, codes, splits="int8"),
         library_adc_int8(tables, idx_flat),
         lambda: compare_adc(tables, codes, "int8"), bound(adc_bytes, nq * n * M, "int8")),
        ("stats_f32", lambda: ops.pq_assign_stats(cb, corpus, compute_dtype=f32),
         lambda: ops.pq_assign_stats_reference(cb, corpus, compute_dtype=f32),
         lambda: library_assign_stats(cb, corpus, f32),
         lambda: compare_stats(cb, corpus, f32), bound(stats_bytes, 3 * enc_ops, "tf32")),
        ("stats_bf16", lambda: ops.pq_assign_stats(cb, corpus, compute_dtype=bf16),
         lambda: ops.pq_assign_stats_reference(cb, corpus, compute_dtype=bf16),
         lambda: library_assign_stats(cb, corpus, bf16),
         lambda: compare_stats(cb, corpus, bf16), bound(stats_bytes, enc_ops, "bf16"),
         stats_bf16_alone),
        ("encode_verify", lambda: ops.pq_encode_verified(cb, corpus),
         lambda: ops.pq_encode_verify_reference(cb, corpus),
         lambda: primitives.quantize_batch(cb, corpus),
         lambda: compare_encode_verify(cb, corpus), bound(enc_bytes + 4 * n, 3 * enc_ops, "tf32"),
         lambda: pq_encode_verify_flags(cb, corpus)),
        ("stats_verify", lambda: ops.pq_assign_stats_verified(cb, corpus),
         lambda: ops.pq_assign_stats_verify_reference(cb, corpus), library_exact_stats,
         lambda: compare_stats_verify(cb, corpus),
         bound(stats_bytes + 4 * n + 4 * n * M, 3 * enc_ops, "tf32"),
         lambda: pq_assign_stats_verify_flags(cb, corpus)),
        ("decode_u4", lambda: ops.pq_decode(cb4, packed4, splits=3, packed=True),
         lambda: ops.pq_decode_reference(cb4, packed4, splits=3, packed=True),
         lambda: torch.nn.functional.embedding(idx4_flat, cb4.reshape(M * K4, DS)),
         lambda: compare_packed_decode(cb4, codes4, packed4, 3), bound(dec4_bytes, 0, "f32")),
        ("decode_int8_u4", lambda: ops.pq_decode(cb4, packed4, splits="int8", packed=True),
         lambda: ops.pq_decode_reference(cb4, packed4, splits="int8", packed=True),
         library_decode_int8(cb4, codes4),
         lambda: compare_packed_decode(cb4, codes4, packed4, "int8"),
         bound(dec4_bytes, n * D, "f32")),
        ("adc_u4", lambda: ops.adc_scores_kernel(tables4, packed4, splits=2, packed=True),
         lambda: ops.adc_scores_reference(tables4, packed4, splits=2, packed=True),
         lambda: torch.nn.functional.embedding_bag(idx4_flat, tables4_t, mode="sum"),
         lambda: compare_packed_adc(tables4, codes4, packed4, 2),
         bound(adc4_bytes, nq * n * M, "f32")),
        ("adc_int8_u4", lambda: ops.adc_scores_kernel(tables4, packed4, splits="int8", packed=True),
         lambda: ops.adc_scores_reference(tables4, packed4, splits="int8", packed=True),
         library_adc_int8(tables4, idx4_flat),
         lambda: compare_packed_adc(tables4, codes4, packed4, "int8"),
         bound(adc4_bytes, nq * n * M, "int8")),
    ]
    rows = []
    for name, kernel, plain, library, compare, (bound_ms, bound_by), *alone in specs:
        res = compare()
        source, replaces = KERNELS[name]
        k_here = K4 if name.endswith("_u4") else K
        rows.append({
            "name": name, "route": "cuda", "source": source, "replaces": replaces,
            "launches": launches[name], "max_abs_err": res["max_abs_err"],
            "n_mismatch": res["n_mismatch"],
            "ms": time_ms(kernel), "plain_ms": time_ms(plain, 3),
            "bound_ms": bound_ms, "bound_by": bound_by,
            "library_ms": None if library is None else time_ms(library, 3),
            "shape": f"n={n} d={D} m={M} k={k_here}" + (f" nq={nq}" if name.startswith("adc") else ""),
            **({"kernel_ms": time_ms(alone[0])} if alone else {}),
            **(split if name in split_names else {}),
            **{key: res[key] for key in ("n_mismatch_flags", "flagged", "rows_moved") if key in res},
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
                 if "spill" in ln and "0 bytes spill stores, 0 bytes spill loads" not in ln],
         wgmma_serialized=[ln.strip() for out in ptxas.values() for ln in out.splitlines()
                           if "Performance Loss" in ln])

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(SEED)
    pq = Pq(codebooks=torch.randn((M, K, DS), generator=gen, device=dev))
    corpus = torch.randn((N_CORPUS, D), generator=gen, device=dev)

    phase_kernels(pq, corpus, gen)
    codes, serve_launches = phase_serve(pq, corpus)
    train_launches, train_out = phase_train(corpus)
    for name in ("stats_f32", "stats_bf16", "encode_f32", "decode"):
        require(train_launches.get(name, 0) > 0, f"train: kernel {name} was never launched")
    exact_launches, exact_out = phase_exact(pq, corpus, train_out)
    pq4, codes4, packed4, packed_launches = phase_packed(corpus, gen)
    probe, wide_launches, wide_rows = phase_wide(corpus, gen)
    # Launches of each kernel on the main paths together; every count was set
    # to 0 just before its path was driven and read just after.
    launches = collections.Counter()
    for counts in (serve_launches, train_launches, exact_launches, packed_launches, wide_launches):
        launches.update(counts)
    for name in KERNELS:
        require(launches[name] > 0, f"kernel {name} was launched on no path")
    require_no_shallow("main paths", launches)
    rows = kernel_table(pq, corpus, codes, launches, pq4, codes4, packed4)
    for row in wide_rows:
        row["launches"] = launches[row["name"]]
    rows += wide_rows
    torch.cuda.synchronize()

    by_name = {row["name"]: row for row in rows}
    ms = {name: by_name[name]["ms"] for name in BEFORE_MS if name in by_name}
    ms.update({f"{name}_kernel": by_name[name]["kernel_ms"]
               for name in ("stats_verify", "encode_verify", "stats_bf16", "encode_bf16")})
    emit("redesigned", shape=by_name["stats_f32"]["shape"], before_ms=BEFORE_MS, ms=ms,
         stats_verify_flag_rate={name: exact_out[name]["stats_flag_rate"]
                                 for name in ("gaussian", "adversarial")},
         encode_verify_flag_rate={name: exact_out[name]["flag_rate"]
                                  for name in ("gaussian", "adversarial")})
    require(sorted(row["name"] for row in rows) == sorted(KERNELS), "the kernels line lacks a kernel")
    print(json.dumps({"kernels": rows}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
