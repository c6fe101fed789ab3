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
bf16 codes at every deep shape.  The ivf phase serves IVF-PQ at
benches/ivf10m.py's shape (10,000,000 clustered rows of d=128, 4,096 cells,
a residual PQ of m=16 at 8 bits): ``train_ivf_pq``, ``build_ivf`` on the
host path and ``ivf_search`` at nprobe 8 and 32 by both probes, every row
placed once, the planted rows found, the probes held to each other, to the
plain route and packed cells to unpacked; its ``ivf_update`` line is the
index's life on the card there: ``build_ivf(placement="device")`` over the
10M rows with its respill, the device build bit for bit the host build on a
2^20-row prefix (packed too), and churn (``ivf_remove`` of 100,000 ids,
``ivf_add`` of their vectors under new ids by the fast path and the host
path).  The sharded phase runs ``parallel/`` on ``torch.distributed``, its
ranks child processes of this script on the one card: a one-rank NCCL group
(the flagship chunked PQ and IVF10M's coarse k-means bit for bit the
single-card trainers') and two ranks over gloo (every sharded entry against
its single-card counterpart, the same bits on both ranks).  The examples phase, last,
runs the port's two user programs end to end through their ``main(argv)``
over 1,000,000 rows at the flagship width: the pipeline (train, persist,
stream-encode from disk, search; IVF, disk and virtual lifecycles; OPQ with
packed 4-bit codes) and the serving program (IVF-PQ L2 and MIPS queries,
updates, the sharded scan over a one-rank NCCL group).  The serving phase also searches
a corpus whose k-th place is always tied and holds the ids to a stable sort's.
Every ADC kernel, the int8 ones included, is held to its plain version bit
for bit, and so are the ADC tables the wrappers build on the card (the int8
tables, scales and offsets, and the f32 tables of the bf16 splits).
The selection kernel (``ops.select``: the k smallest of long score rows) is
held to its plain version bit for bit on ADC scores of a streamed chunk (128
queries over 524,288 codes, top 100) and of 130 rows of an odd length, alone
and merged with a prior list, and the serving path must launch it.
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
import hashlib
import json
import logging
import os
import shutil
import socket
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

from reductive_tpu_torch import (
    Pq, conformance, io, ivf, kmeans, linalg, native, ops, stream_encode, stream_encode_resumable,
    train_gaussian_opq_streamed, train_opq_chunked, train_opq_streamed, train_pq,
    train_pq_chunked, train_pq_streamed,
)
from reductive_tpu_torch.data import _device_batches, _reader_batches
from reductive_tpu_torch.pq.streamed import streamed_covariance
from reductive_tpu_torch.ops import _build
from reductive_tpu_torch.ops.adc import adc_launcher, adc_table_int8, quantize_tables_int8
from reductive_tpu_torch.ops.assign import (
    VERIFY_ENCODE_CHUNK, _prepare, bf16_tile_plan, pq_encode_verify_flags, reset_verify_tiers,
    assign_route, deep_producer, verify_caps, verify_scale, verify_tiers,
)
from reductive_tpu_torch.ops.decode import (
    decode_table, effective_codebook, launch_decode, quantize_codebook_int8,
)
from reductive_tpu_torch.ops.probe import probe_wgmma_tf32
from reductive_tpu_torch.ops.select import select_smallest_kernel, select_smallest_reference
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
             "adc_u4": 0.557, "adc_int8": 0.921, "adc_int8_u4": 0.604}

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
    # No TPU kernel: the JAX package selects with jax.lax.top_k.
    "select": ("reductive_tpu_torch/csrc/select.cu", "none (jax.lax.top_k)"),
}
SERVE_KERNELS = ("encode_f32", "encode_bf16", "decode", "decode_int8", "adc", "adc_int8", "select",
                 "select_merge")
# The selection kernel's shape on the main path: a streamed chunk of 128
# queries' scores over 524,288 codes, top 100 (the flat search cell's).
SELECT_NQ, SELECT_N, SELECT_K = 128, 524_288, 100
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
# The ivf phase: benches/ivf10m.py's shape (10,000,000 clustered rows of
# d=128 around 4,096 centres x 3.0 plus 0.3 noise; 4,096 cells, a residual PQ
# of m=16 at 8 bits; 16 queries, each a corpus row plus 0.05 noise), its 8
# coarse and PQ iterations cut to 4; the probes held to each other on a
# 2^20-row prefix index, and the packed cells at 4 bits there.
IVF_N, IVF_D, IVF_C, IVF_M, IVF_BITS = 10_000_000, 128, 4096, 16, 8
IVF_ITERATIONS = 4
IVF_PREFIX = 1 << 20
IVF_NPROBE = (8, 32)
# The stream phase.  Corpus S: the 768-d transformer-embedding width of
# BASELINE.json's configs #4 and #5 (benches/streaming_train.py's run of it):
# 256 centres from N(0, 2^2) plus unit noise, m=24, k=256 (ds=32), written to
# disk in 2^20-row blocks; its rows cut from config #5's 100M to 2^22 (12.9 GB
# as fvecs), width, m and k not cut.  Corpus I: the ivf phase's corpus and
# model, written to a second file.  The conformance gate: the reference's
# tests' 256 x 20 instances, m=10, 7 bits, 10 iterations, at the goldens'
# seeds (tests/goldens/rng_reference.json, read as data).
STREAM_N, STREAM_D, STREAM_M, STREAM_BITS = 1 << 22, 768, 24, 8
STREAM_BATCH = 1 << 18
STREAM_BLOCK = 1 << 20
STREAM_ITERATIONS = 4
STREAM_PEAK_LIMIT = 4e9         # bytes a streamed training may add on the card
GOLDENS = os.path.join(os.path.dirname(os.path.abspath(__file__)), "tests", "goldens",
                       "rng_reference.json")
GATE_BANDS = {"pq": 0.08, "opq": 0.10, "gaussian_opq": 0.12}
IVF_KERNELS = ("stats_f32_wide", "encode_bf16_wide", "stats_f32", "encode_bf16", "adc", "adc_u4",
               "decode")
IVF_SAVED = ("ivf10m.npz", "ivf10m_queries.npz")  # the ivf phase's index for the sharded ranks
# The sharded phase: its ranks are child processes of this script on the one
# card, a one-rank NCCL group and two ranks over gloo; the flagship trainers'
# iterations, IVF10M's coarse k-means (its iterations cut to 2), OPQ on the
# N_PREFIX rows, and corpus S's mixture at the streaming width cut to 2^20
# rows on disk.
SHARDED_RANK_FLAG = "--sharded-rank"
SHARDED_TIMEOUT = 300           # seconds the ranks of one group may take
SHARDED_ITERATIONS = 8
SHARDED_KMEANS_ITERATIONS = 2
SHARDED_OPQ_ITERATIONS = 2
SHARDED_STREAM_N = 1 << 20
SHARDED_STREAM_ITERATIONS = 2
SHARDED_STREAM_FILE = "sharded_stream.fvecs"
SHARDED_KERNELS = ("stats_f32", "stats_f32_wide", "encode_bf16", "encode_f32", "decode", "adc")
# The examples phase: the port's two user programs through their main(argv)
# at the flagship width (d=128, m=16; k=256, and k=16 packed), the rows cut to
# SIFT1M's 1,000,000 (examples/pipeline.py's corpus stands for SIFT/Deep1B-style
# data) and the iterations from the programs' 10 to 4; the serving program's
# sharded scan over a one-rank NCCL group in this process.  The bars are
# tests/test_examples.py's.
EXAMPLES_N, EXAMPLES_D = 1_000_000, 128
EXAMPLES_SHAPE = ["--n", str(EXAMPLES_N), "--d", str(EXAMPLES_D), "--m", "16", "--queries", "16"]
EXAMPLES_RUNS = {
    "pipeline_pq8": ("pipeline", EXAMPLES_SHAPE + ["--bits", "8", "--iters", "4", "--ivf", "1024",
                                                   "--disk", "--virtual"]),
    "pipeline_opq4": ("pipeline", EXAMPLES_SHAPE + ["--bits", "4", "--iters", "4", "--opq"]),
    "serving": ("serving", EXAMPLES_SHAPE + ["--bits", "8", "--cells", "1024"]),
}
EXAMPLES_KERNELS = ("adc", "adc_u4", "decode")
PIPELINE_RECALL_BAR, SERVING_BAR = 0.75, 0.9
LAUNCHER_ENV = ("WORLD_SIZE", "RANK", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT",
                "TORCHELASTIC_RUN_ID", "SLURM_NTASKS", "OMPI_COMM_WORLD_SIZE")


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
    """Kernel against plain version, bit for bit: for splits 1 to 3 both add
    the m entries in the order j = 0..m-1; for ``"int8"`` both take the exact
    int32 sum (the kernel's order does not change it), then one rounded
    multiply and one rounded add."""
    got = ops.adc_scores_kernel(tables, codes, splits=splits)
    want = ops.adc_scores_reference(tables, codes, splits=splits)
    torch.cuda.synchronize()
    require(got.shape == want.shape, "adc: shape")
    n_bits = bits_differ(got, want)
    require(n_bits == 0, f"adc splits={splits}: {n_bits} scores differ in some bit")
    return {"n_mismatch": n_bits, "n_bits_differ": n_bits,
            "max_abs_err": float((got - want).abs().max())}


def compare_select(scores, k):
    """The selection kernel against its plain version (``torch.topk`` and the
    tie repair), bit for bit: alone, and merged with a prior list at an offset
    as the streamed search's step does."""
    n = scores.shape[1]
    prior = select_smallest_reference(torch.flip(scores, dims=(1,)), k)
    pairs = [(select_smallest_kernel(scores, k), select_smallest_reference(scores, k)),
             (select_smallest_kernel(scores, k, prior=prior, offset=n),
              select_smallest_reference(scores, k, prior=prior, offset=n))]
    torch.cuda.synchronize()
    n_bits = sum(bits_differ(got[0], want[0]) for got, want in pairs)
    n_ids = sum(int((got[1] != want[1]).sum()) for got, want in pairs)
    require(n_bits == 0 and n_ids == 0,
            f"select: {n_bits} values differ in some bit, {n_ids} ids differ")
    return {"n_mismatch": n_ids, "n_bits_differ": n_bits,
            "max_abs_err": max(float((got[0] - want[0]).abs().max()) for got, want in pairs)}


def compare_adc_tables(tables):
    """The tables the ADC wrappers build on the card in one launch each
    against their plain versions, bit for bit: ``adc_table_int8`` against
    ``quantize_tables_int8`` (int8 entries, scales, offsets) and the f32
    kernel's table (``decode_table``'s one launch) against
    ``effective_codebook`` at splits 1, 2, 3."""
    nq, m, k = tables.shape
    got, want = adc_table_int8(tables), quantize_tables_int8(tables)
    torch.cuda.synchronize()
    n_int8 = int((got[0] != want[0]).sum()) + bits_differ(got[1], want[1]) + \
        bits_differ(got[2], want[2])
    n_f32 = 0
    for splits in (1, 2, 3):
        table = decode_table(tables.reshape(nq, m * k, 1), splits)[0].view(nq, m, k)
        n_f32 += bits_differ(table, effective_codebook(tables, splits))
    require(n_int8 == 0, f"adc_table_int8: {n_int8} entries, scales or offsets differ")
    require(n_f32 == 0, f"the f32 ADC table: {n_f32} entries differ from effective_codebook")
    return {"int8_bits_differ": n_int8, "f32_bits_differ": n_f32,
            "int8_prep_ms": time_ms(lambda: adc_table_int8(tables)),
            "int8_prep_plain_ms": time_ms(lambda: quantize_tables_int8(tables), 3)}


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

    # The ADC tables built on the card, at the serving shape (16 and 128
    # queries, k=256) and the packed one (k=16).
    pq4 = Pq(codebooks=pq.codebooks[:, :K4].contiguous())
    tables_rows = [
        {"shape": f"d={D} m={M} k={K} nq={nq}", **compare_adc_tables(adc_tables(pq, corpus[:nq]))}
        for nq in (16, 128)]
    tables_rows += [
        {"shape": f"d={D} m={M} k={K4} nq={nq}", **compare_adc_tables(adc_tables(pq4, corpus[:nq]))}
        for nq in (16, 128)]

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
    # The selection kernel on ADC scores: a streamed chunk of the flat search
    # cell's shape, and 130 rows of an odd length (rows off 16 bytes).
    codes_s = pq.quantize_batch(corpus[:SELECT_N], method="kernel-f32")
    for nq_s, n_s in ((SELECT_NQ, SELECT_N), (SELECT_NQ + 2, SELECT_N - 61)):
        scores_s = ops.adc_scores_kernel(adc_tables(pq, corpus[1000:1000 + nq_s]), codes_s[:n_s])
        rows.append({"kernel": "select", "shape": f"nq={nq_s} n={n_s} k={SELECT_K}",
                     **compare_select(scores_s, SELECT_K)})
    del codes_s, scores_s
    emit("kernels", compared=rows, adc_tables=tables_rows, shared_assignment=shared)


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


class SyncedLog(logging.Handler):
    """Collects the package's INFO records, each with the host clock read
    after waiting for the card, so that a record marks where the device work
    queued before it ended."""

    def __init__(self):
        super().__init__(level=logging.INFO)
        self.records = []

    def emit(self, record):
        torch.cuda.synchronize()
        self.records.append((record.msg, record.args, time.perf_counter()))

    def find(self, text):
        return [(args, t) for msg, args, t in self.records if isinstance(msg, str) and text in msg]


def with_log(fn):
    """``fn()`` with the package's logger at INFO into a :class:`SyncedLog`;
    returns its result and the log."""
    log = SyncedLog()
    logger = logging.getLogger("reductive_tpu")
    level = logger.level
    logger.addHandler(log)
    logger.setLevel(logging.INFO)
    try:
        return fn(), log
    finally:
        logger.removeHandler(log)
        logger.setLevel(level)


def logged_losses(train):
    """Runs ``train()`` with the trainers' logger at INFO and returns its
    result and the per-iteration losses it logged."""
    out, log = with_log(train)
    return out, [float(args[1]) for args, _ in log.find("iteration %d")]


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


# -- the IVF-PQ serving path ---------------------------------------------------------


def clustered_corpus(gen, n, d, centres):
    """``n`` rows around ``centres`` random centres x 3.0 plus 0.3 Gaussian
    noise, made on the card (benches/ivf10m.py's corpus), in place."""
    dev = gen.device
    c = 3.0 * torch.randn((centres, d), generator=gen, device=dev)
    x = c[torch.randint(0, centres, (n,), generator=gen, device=dev)]
    for off in range(0, n, 1 << 22):
        rows = x[off:off + (1 << 22)]
        rows.add_(torch.randn(rows.shape, generator=gen, device=dev), alpha=0.3)
    return x


def apart_ids_equal(d_ref, i_ref, i_got, tol, top_k=TOP_K):
    """Whether ``i_got`` equals ``i_ref`` at every rank (of ``top_k``) whose
    reference score lies more than ``tol`` from its neighbours' (``d_ref``
    holds ``top_k + 1`` columns), and how many ranks that held."""
    gap = torch.diff(d_ref, dim=1)
    apart = torch.ones_like(i_ref[:, :top_k], dtype=torch.bool)
    apart[:, 1:] &= gap[:, :top_k - 1] > tol
    apart &= gap[:, :top_k] > tol
    same = torch.equal(i_got[:, :top_k][apart], i_ref[:, :top_k][apart])
    return same, int(apart.sum())


def phase_ivf(gen, work):
    """IVF-PQ serving at benches/ivf10m.py's shape through the entry points,
    every count at 0 before: ``train_ivf_pq`` (k-means++ and the coarse
    Lloyd's steps on the deep statistics kernel, the residual assignment on
    the deep bf16 encode, the residual PQ on the narrow statistics kernel),
    ``build_ivf(capacity="auto")`` on the host path (the residual encode on
    the narrow bf16 kernel), and ``ivf_search`` at nprobe 8 and 32 (the
    ADC-table probe on the ADC kernel); the decode probe with the decode
    kernel; an exhaustive search over a flat PQ of the same corpus; on a
    2^20-row prefix, the ADC-table probe against the decode probe and a
    4-bit index packed against unpacked (``adc_u4``).  Requires every row
    placed once, 1-recall@10 of the planted rows >= 0.9 at nprobe 8, the two
    probes' ids equal and distances within 2e-5 (relative, and absolute of
    the largest ``|q|^2``: the terms ``|q|^2 + g - 2 q.c - 2 q.rec`` cancel
    into a near row's distance), the kernel route's ids the plain route's
    wherever the plain scores lie more than 1e-5 of that size apart, packed
    scores bit for bit the unpacked ones, and each of ``IVF_KERNELS``
    launched with no ``*_shallow`` launch.  Returns the launches of this
    phase and of ``ivf_update``, and the corpus, its coarse centroids,
    residual PQ and queries, for the stream phase's corpus I.  The index, its
    queries and planted rows are saved into ``work`` (``IVF_SAVED``) for the
    sharded phase's ranks."""
    dev = gen.device
    n, d, C = IVF_N, IVF_D, IVF_C
    x = clustered_corpus(gen, n, d, C)
    planted = torch.arange(0, n, n // 16, device=dev)[:16]
    q = x[planted] + 0.05 * torch.randn((16, d), generator=gen, device=dev)
    scale = float((q * q).sum(1).max())  # the size of the IVFADC terms
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()

    ops.reset_launch_counts()
    t0 = time.perf_counter()
    (coarse, rpq), log = with_log(lambda: ivf.train_ivf_pq(
        gen, x, C, IVF_M, IVF_BITS, coarse_iterations=IVF_ITERATIONS,
        pq_iterations=IVF_ITERATIONS))
    torch.cuda.synchronize()
    t_train = time.perf_counter() - t0
    residual_start = log.find("PQ subquantizers chunked")[0][1]
    train = {"coarse": residual_start - t0, "residual": t0 + t_train - residual_start,
             "total": t_train}

    t0 = time.perf_counter()
    index, log = with_log(lambda: ivf.build_ivf(coarse, rpq, x, capacity="auto"))
    torch.cuda.synchronize()
    build = {args[0]: args[1] for args, _ in log.find("IVF build pass")}
    build["total"] = time.perf_counter() - t0
    spilled = sum(args[0] for args, _ in log.find("spilled to the nearest cell"))
    moved = log.find("rows in secondary cells")[0][0][-1]
    ids = index.cell_ids[index.cell_ids >= 0].long()
    require(ids.numel() == n and bool((torch.bincount(ids, minlength=n) == 1).all())
            and index.dropped_ids.size == 0, "ivf: a corpus row is not in exactly one slot")
    require(index.cell_codes.shape == (C, index.capacity, IVF_M)
            and index.capacity == -(-5 * n // (4 * C)), "ivf: cells shape")
    del ids

    # Search: the kernel route (the ADC-table probe) at nprobe 8 and 32, the
    # decode probe with the decode kernel, and the plain route.
    recall, search_ms = {}, {}
    args = (index.coarse_centroids, index.cell_codes, index.cell_ids, index.cell_norms, rpq)
    for nprobe in IVF_NPROBE:
        _, i_lut = ivf.ivf_search(index, q, TOP_K, nprobe=nprobe)
        _, i_dec = ivf._padded_topk(*ivf._probe_and_score(q, *args, nprobe, True, 2), TOP_K)
        recall[f"lut_nprobe{nprobe}"] = float((i_lut == planted[:, None]).any(1).float().mean())
        recall[f"decode_nprobe{nprobe}"] = float(
            (i_dec.long() == planted[:, None]).any(1).float().mean())
        search_ms[f"lut_nprobe{nprobe}"] = time_ms(lambda: ivf.ivf_search(index, q, TOP_K,
                                                                          nprobe=nprobe))
        search_ms[f"decode_nprobe{nprobe}"] = time_ms(lambda: ivf._padded_topk(
            *ivf._probe_and_score(q, *args, nprobe, True, 2), TOP_K))
    require(recall["lut_nprobe8"] >= 0.9, f"ivf: 1-recall@10 at nprobe 8 is {recall['lut_nprobe8']}")
    d_k, i_k = ivf.ivf_search(index, q, TOP_K + 1, nprobe=8)
    d_p, i_p = ivf.ivf_search(index, q, TOP_K + 1, nprobe=8, use_kernel=False)
    same, ranks = apart_ids_equal(d_p, i_p, i_k, 1e-5 * scale)
    require(same, "ivf: the kernel route's ids differ from the plain route's on well-separated ranks")
    kernel_vs_plain = {"ranks_compared": ranks, "ids_equal_share": float((i_k == i_p).float().mean()),
                       "max_abs_diff": float((d_k - d_p).abs().max())}
    search_ms["plain_nprobe8"] = time_ms(lambda: ivf.ivf_search(index, q, TOP_K, nprobe=8,
                                                                use_kernel=False))
    # An exhaustive search over a flat PQ of the same corpus, for scale.
    flat = train_pq_chunked(gen, x[:N_PREFIX], IVF_M, IVF_BITS, IVF_ITERATIONS)
    codes = flat.quantize_batch(x, method="kernel")
    _, i_ex = search(flat, q, codes, TOP_K)
    recall["exhaustive"] = float((i_ex == planted[:, None]).any(1).float().mean())
    search_ms["exhaustive"] = time_ms(lambda: search(flat, q, codes, TOP_K))
    del codes, flat

    # On a 2^20-row prefix: the ADC-table probe (splits=3) against the decode
    # probe with the kernel, and a 4-bit index packed against unpacked.
    xp = x[:IVF_PREFIX]
    sub = ivf.build_ivf(coarse, rpq, xp, capacity="auto")
    pargs = (sub.coarse_centroids, sub.cell_codes, sub.cell_ids, sub.cell_norms, rpq, 8)
    d_l, i_l = ivf._probe_and_score_lut(q, *pargs, TOP_K + 1, 3)
    d_d, i_d = ivf._padded_topk(*ivf._probe_and_score(q, *pargs, True, 3), TOP_K + 1)
    tol = 2e-5 * scale
    same, ranks = apart_ids_equal(d_d, i_d, i_l, tol)
    require(same and bool(torch.allclose(d_l, d_d, rtol=2e-5, atol=tol)),
            "ivf: the ADC-table probe and the decode probe disagree")
    lut_vs_decode = {"ranks_compared": ranks, "ids_equal_share": float((i_l == i_d).float().mean()),
                     "max_abs_diff": float((d_l - d_d).abs().max()), "tol": tol}
    coarse4, pq4 = ivf.train_ivf_pq(gen, xp, C, IVF_M, 4, coarse_iterations=IVF_ITERATIONS,
                                    pq_iterations=IVF_ITERATIONS)
    unpacked = ivf.build_ivf(coarse4, pq4, xp, capacity="auto")
    packed = ivf.build_ivf(coarse4, pq4, xp, capacity="auto", packed=True)
    differ = 0
    for use_kernel in (True, False):
        a = ivf.ivf_search(unpacked, q, TOP_K, nprobe=8, use_kernel=use_kernel)
        b = ivf.ivf_search(packed, q, TOP_K, nprobe=8, use_kernel=use_kernel)
        differ += bits_differ(a[0], b[0]) + int((a[1] != b[1]).sum())
    require(differ == 0, f"ivf: packed cells score otherwise than unpacked ({differ} differ)")
    search_ms["lut_nprobe8_packed"] = time_ms(lambda: ivf.ivf_search(packed, q, TOP_K, nprobe=8))
    del sub, unpacked, packed

    launches = ops.launch_counts()
    for name in IVF_KERNELS:
        require(launches.get(name, 0) > 0, f"ivf: kernel {name} was never launched")
    require_no_shallow("ivf", launches)
    peak = torch.cuda.max_memory_allocated()
    io.save(os.path.join(work, IVF_SAVED[0]), index)
    np.savez(os.path.join(work, IVF_SAVED[1]), q=q.cpu().numpy(), planted=planted.cpu().numpy())
    del index
    torch.cuda.empty_cache()
    update_launches = ivf_update(x, coarse, rpq, q, planted, scale, build, coarse4, pq4)
    emit("ivf", n=n, d=d, n_cells=C, m=IVF_M, bits=IVF_BITS, iterations=IVF_ITERATIONS,
         queries=16, train_s=train, build_s=build, capacity=-(-5 * n // (4 * C)),
         rows_outside_nearest_cell=moved, rows_spilled=spilled, dropped=0,
         search_ms=search_ms, recall_at_10=recall,
         kernel_vs_plain=kernel_vs_plain, lut_vs_decode_prefix=lut_vs_decode,
         packed_bits_differ=differ, peak_memory_bytes=peak, launches=launches)
    torch.cuda.empty_cache()
    return launches, update_launches, (x, coarse, rpq, q)


def ivf_update(x, coarse, rpq, q, planted, scale, host_build, coarse4, pq4):
    """The IVF index's life on the card at IVF10M, every count at 0 before:
    ``build_ivf(capacity="auto", placement="device")`` over the whole corpus
    (the stages from its INFO log; the respill's rows from its record), the
    device build against the host build bit for bit on the 2^20-row prefix
    at ``capacity=None`` (8 bits, and 4 bits packed), then churn on the
    device-built index: ``ivf_remove`` of the ids ``1, 101, 201, ...``
    (100,000 rows; the planted rows stay) and ``ivf_add`` of their vectors
    under the ids ``n + j`` in two batches, (a) the rows the build stored in
    their nearest cell, which must take the device fast path, and (b) the
    rest, which must take the host path.  Requires: every row in one slot,
    none dropped, a row within its nearest cell's capacity stored there,
    1-recall@10 >= 0.9 at nprobe 8 and the kernel route's ids the plain
    route's on well-separated ranks, as the ``ivf`` line; after the churn
    every live id in one slot, no removed id found, 1-recall@10 >= 0.9 for
    16 re-added rows of each batch under their new ids, the planted rows'
    recall unchanged, each added row's code the encode kernel's of its
    residual against its storage cell, and ``donate=True`` bit for bit the
    copy-on-write add; ``encode_bf16`` and ``adc`` launched and no
    ``*_shallow`` launch.  Prints the ``ivf_update`` line and returns the
    launches."""
    dev = x.device
    n, d = x.shape
    C = coarse.shape[0]
    gen = torch.Generator(device=dev).manual_seed(SEED + 17)
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    t_start = time.perf_counter()

    t0 = time.perf_counter()
    index, log = with_log(lambda: ivf.build_ivf(coarse, rpq, x, capacity="auto",
                                                placement="device"))
    torch.cuda.synchronize()
    build = {args[0]: args[1] for args, _ in log.find("IVF build pass")}
    build["total"] = time.perf_counter() - t0
    respill = log.find("IVF respill")
    placed, n_over, rounds, redraws, left = respill[0][0] if respill else (0, 0, 0, 0, 0)
    L = index.capacity
    occ = index.cell_ids >= 0
    cells = torch.full((n,), -1, dtype=torch.long, device=dev)  # each row's storage cell
    cells[index.cell_ids[occ].long()] = occ.nonzero()[:, 0]
    del occ
    require(bool((cells >= 0).all()) and int((index.cell_ids >= 0).sum()) == n
            and index.dropped_ids.size == 0, "ivf_update: a corpus row is not in exactly one slot")
    require(index.cell_codes.shape == (C, -(-5 * n // (4 * C)), IVF_M), "ivf_update: cells shape")
    # A row ranked within its nearest cell's capacity (corpus order) is stored there.
    nearest = ivf._assign_block(x, coarse, 262_144).long()
    counts = torch.bincount(nearest, minlength=C)
    by_cell, order = torch.sort(nearest, stable=True)
    rank = torch.empty_like(nearest)
    rank[order] = torch.arange(n, device=dev) - (torch.cumsum(counts, 0) - counts)[by_cell]
    over = rank >= L
    require(int(over.sum()) == n_over and bool(((cells == nearest) | over).all()),
            "ivf_update: a row within its nearest cell's capacity is stored elsewhere")
    del by_cell, order, rank, over
    _, i_k = ivf.ivf_search(index, q, TOP_K, nprobe=8)
    recall = {"planted_before": float((i_k == planted[:, None]).any(1).float().mean())}
    require(recall["planted_before"] >= 0.9,
            f"ivf_update: 1-recall@10 at nprobe 8 is {recall['planted_before']}")
    d_k, i_k = ivf.ivf_search(index, q, TOP_K + 1, nprobe=8)
    d_p, i_p = ivf.ivf_search(index, q, TOP_K + 1, nprobe=8, use_kernel=False)
    same, ranks = apart_ids_equal(d_p, i_p, i_k, 1e-5 * scale)
    require(same, "ivf_update: the kernel route's ids differ from the plain route's on "
                  "well-separated ranks")
    kernel_vs_plain = {"ranks_compared": ranks,
                       "ids_equal_share": float((i_k == i_p).float().mean()),
                       "max_abs_diff": float((d_k - d_p).abs().max())}

    # The device build is the host build bit for bit at capacity=None.
    xp = x[:IVF_PREFIX]
    identity, prefix_s = {}, {}
    for name, cq, pq_, packed in (("bits8", coarse, rpq, False), ("bits4_packed", coarse4, pq4, True)):
        built = {}
        for where in ("device", "host"):
            t0 = time.perf_counter()
            built[where] = ivf.build_ivf(cq, pq_, xp, placement=where, packed=packed)
            torch.cuda.synchronize()
            prefix_s.setdefault(name, {})[where] = time.perf_counter() - t0
        a, b = built["device"], built["host"]
        identity[name] = (torch.equal(a.cell_ids, b.cell_ids) and torch.equal(a.cell_codes, b.cell_codes)
                          and bits_differ(a.cell_norms, b.cell_norms) == 0)
        require(identity[name], f"ivf_update: the device build is not the host build ({name})")
        del a, b, built

    # Churn: remove 100,000 ids, add their vectors back under new ids.
    gone = np.arange(1, n, 100)
    gone_t = torch.from_numpy(gone).to(dev)
    removed = ivf.ivf_remove(index, gone)
    remove_ms = host_ms(lambda: ivf.ivf_remove(index, gone), 5)
    require(int((removed.cell_ids >= 0).sum()) == n - gone.size, "ivf_update: remove count")
    home = cells[gone_t] == nearest[gone_t]
    ja, jb = torch.nonzero(home)[:, 0], torch.nonzero(~home)[:, 0]
    xa, xb = x[gone_t[ja]], x[gone_t[jb]]
    ids_a, ids_b = (n + ja).cpu().numpy(), (n + jb).cpu().numpy()
    # 16 queries near rows of each batch, and their recall under the old ids
    # before the churn.
    queries = {}
    for name, j in (("batch_a", ja), ("batch_b", jb)):
        j = j[:16]
        queries[name] = (x[gone_t[j]] + 0.05 * torch.randn((j.numel(), d), generator=gen, device=dev),
                         j)
        _, i_o = ivf.ivf_search(index, queries[name][0], TOP_K, nprobe=8)
        recall[f"{name}_before"] = float((i_o == gone_t[j][:, None]).any(1).float().mean())
    idx_a, log_a = with_log(lambda: ivf.ivf_add(removed, xa, ids_a))
    require(bool(log_a.find("IVF add (device fast path)")),
            "ivf_update: batch (a) did not take the device fast path")
    add_a_ms = host_ms(lambda: ivf.ivf_add(removed, xa, ids_a), 3)
    idx_b, log_b = with_log(lambda: ivf.ivf_add(idx_a, xb, ids_b))
    require(bool(log_b.find("IVF add: ")) and not log_b.find("IVF add (device fast path)"),
            "ivf_update: batch (b) did not take the host path")
    add_b_ms = host_ms(lambda: ivf.ivf_add(idx_a, xb, ids_b), 3)
    # The donated add writes into removed's cells (and so index's): both unused after.
    donated = ivf.ivf_add(removed, xa, ids_a, donate=True)
    require(donated.cell_codes is removed.cell_codes and torch.equal(donated.cell_ids, idx_a.cell_ids)
            and torch.equal(donated.cell_codes, idx_a.cell_codes)
            and bits_differ(donated.cell_norms, idx_a.cell_norms) == 0,
            "ivf_update: the donated add differs from the copy-on-write add")
    del index, removed, donated, idx_a

    g = gone.size
    live = idx_b.cell_ids[idx_b.cell_ids >= 0].long()
    want = torch.ones((n + g,), dtype=torch.long, device=dev)
    want[gone_t] = 0
    require(torch.equal(torch.bincount(live, minlength=n + g), want),
            "ivf_update: a live id is not in exactly one slot after the churn")
    del live, want
    cc, ss = (idx_b.cell_ids >= n).nonzero().unbind(1)
    j = idx_b.cell_ids[cc, ss].long() - n
    res = x[gone_t[j]] - coarse[cc]
    require(j.numel() == g and torch.equal(idx_b.cell_codes[cc, ss], ops.pq_encode(rpq.codebooks, res)),
            "ivf_update: an added row's code is not the encode of its residual")
    del cc, ss, j, res
    # A re-added row is found under its new id: at 0.9 or more, or, for the
    # rows the build stored outside their nearest cell, as often as the build
    # found them (their residuals against a far cell lie outside the PQ's
    # training residuals, so the build's own index may find them less).
    for name, (qn, j) in queries.items():
        _, i_n = ivf.ivf_search(idx_b, qn, TOP_K, nprobe=8)
        recall[name] = float((i_n == (n + j)[:, None]).any(1).float().mean())
        floor = min(0.9, recall[f"{name}_before"]) if name == "batch_b" else 0.9
        require(recall[name] >= floor, f"ivf_update: 1-recall@10 of {name} is {recall[name]}")
        require(not bool(torch.isin(i_n, gone_t).any()), "ivf_update: a removed id was found")
    _, i_c = ivf.ivf_search(idx_b, q, TOP_K, nprobe=8)
    recall["planted_after"] = float((i_c == planted[:, None]).any(1).float().mean())
    require(recall["planted_after"] == recall["planted_before"] and not bool(torch.isin(i_c, gone_t).any()),
            "ivf_update: the churn changed the planted rows' recall")
    search_ms = time_ms(lambda: ivf.ivf_search(idx_b, q, TOP_K, nprobe=8))

    launches = ops.launch_counts()
    for name in ("encode_bf16", "adc"):
        require(launches.get(name, 0) > 0, f"ivf_update: kernel {name} was never launched")
    require_no_shallow("ivf_update", launches)
    emit("ivf_update", seconds=time.perf_counter() - t_start, n=n, capacity=L, build_s=build, host_build_s=host_build, n_over=n_over,
         respill={"placed_on_device": placed, "rounds": rounds, "redraws": redraws,
                  "left_to_host_spill": left},
         recall_at_10=recall, kernel_vs_plain=kernel_vs_plain, prefix_identity=identity,
         prefix_build_s=prefix_s,
         churn={"removed": g, "batch_a_rows": int(ja.numel()), "batch_b_rows": int(jb.numel()),
                "remove_ms": remove_ms, "add_a_ms": add_a_ms, "add_b_ms": add_b_ms,
                "add_a_rows_per_s": ja.numel() / add_a_ms * 1e3,
                "add_b_rows_per_s": jb.numel() / add_b_ms * 1e3,
                "search_ms_nprobe8_after": search_ms},
         peak_memory_bytes=torch.cuda.max_memory_allocated(), launches=launches)
    del idx_b, xa, xb, cells, nearest
    torch.cuda.empty_cache()
    return launches


# -- corpora on disk -------------------------------------------------------------


def once(fn):
    """Result and seconds (host clock, synchronised before and after) of one
    call: a streamed pass is too long to run twice for a warm-up."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def progress(step: str, fields) -> None:
    """One line on stderr as a stream step ends, so that a run stopped later
    still shows what came before."""
    print(json.dumps({"stream_step": step, **fields}), file=sys.stderr, flush=True)


def counted(fn, total):
    """``fn()`` with every launch count at 0 before; returns its result and
    the launches it made, which are added to ``total``."""
    ops.reset_launch_counts()
    out = fn()
    counts = ops.launch_counts()
    total.update(counts)
    return out, counts


def peak_over(base: int) -> int:
    """Bytes of device memory allocated at the peak since the last reset
    beyond ``base`` (what was allocated before the run)."""
    return torch.cuda.max_memory_allocated() - base


def require_free_disk(where: str, nbytes: int) -> int:
    free = shutil.disk_usage(where).free
    require(free >= 2 * nbytes,
            f"{free} bytes free in {where}; a corpus of {nbytes} bytes needs twice that")
    return free


def open_native(path):
    reader = native.VecsReader(path)
    require(reader._handle is not None, f"stream: {path} was opened without the native library")
    return reader


class Interrupted(RuntimeError):
    pass


class Interrupting:
    """A reader over the same file whose prefetched batches stop with an
    exception after ``after`` batches: an encode job killed mid-stream."""

    def __init__(self, reader, after):
        self.reader, self.after = reader, after
        self.n, self.dim, self.path = reader.n, reader.dim, reader.path

    def prefetch_batches(self, *args, **kwargs):
        for i, item in enumerate(self.reader.prefetch_batches(*args, **kwargs)):
            if i == self.after:
                raise Interrupted("stopped")
            yield item


def write_stream_corpus(path, gen, n=STREAM_N):
    """Corpus S (``n`` rows), made on the card in 2^20-row blocks and
    appended to ``path``: benches/streaming_train.py's mixture at the
    streaming width."""
    dev = gen.device
    centres = 2.0 * torch.randn((256, STREAM_D), generator=gen, device=dev)
    for off in range(0, n, STREAM_BLOCK):
        rows = centres[torch.randint(0, 256, (STREAM_BLOCK,), generator=gen, device=dev)]
        rows += torch.randn((STREAM_BLOCK, STREAM_D), generator=gen, device=dev)
        native.write_fvecs(path, rows, append=off > 0)


def stream_corpus_s(reader, out_dir, total, dev):
    """Corpus S through the out-of-core path; see :func:`phase_stream`."""
    n, d, B = STREAM_N, STREAM_D, STREAM_BATCH
    batches = -(-n // B)
    payload = n * d * 4
    out = {}

    # The time split of a pass: the read alone, the read and the copy to the
    # card, then the streamed training's passes (read, copy, kernel).
    _, seconds = once(lambda: sum(b.shape[0] for _, b in reader.prefetch_batches(B, copy=False)))
    out["read_pass_s"], out["read_gb_per_s"] = seconds, payload / seconds / 1e9
    _, seconds = once(lambda: sum(xb.shape[0] for _, xb in _device_batches(
        _reader_batches(reader, B, 0, n, copy=False), dev)))
    out["read_copy_pass_s"], out["read_copy_gb_per_s"] = seconds, payload / seconds / 1e9
    progress("read", out)

    # Streamed PQ, f32, against the chunked trainer over the resident corpus.
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    gen = torch.Generator(device=dev).manual_seed(SEED)
    ((pq_s, losses), seconds), counts = counted(lambda: once(lambda: logged_losses(
        lambda: train_pq_streamed(gen, reader, STREAM_M, STREAM_BITS, STREAM_ITERATIONS,
                                  batch_size=B, device=dev))), total)
    peak = peak_over(base)
    require(peak < STREAM_PEAK_LIMIT,
            f"stream: the streamed training added {peak} bytes on the card, over {STREAM_PEAK_LIMIT}")
    require(counts.get("stats_f32", 0) == STREAM_ITERATIONS * batches
            and sum(v for k, v in counts.items() if k.startswith("stats")) == counts["stats_f32"],
            f"stream: the streamed PQ launched {counts}, expected {STREAM_ITERATIONS * batches} "
            "stats_f32 (every batch through the kernel)")
    require(len(losses) == STREAM_ITERATIONS and all(b <= a * (1 + 1e-6)
                                                     for a, b in zip(losses, losses[1:])),
            f"stream: the streamed PQ's losses {losses}")
    out["pq_streamed_f32"] = {
        "seconds_per_iteration": seconds / STREAM_ITERATIONS,
        "rows_per_s": STREAM_ITERATIONS * n / seconds, "peak_bytes_added": peak,
        "resident_bytes_before": base, "losses": losses, "launches": counts}
    progress("pq_streamed_f32", out["pq_streamed_f32"])

    # One iteration each of a bf16 transfer and the verified mode, from there.
    for name, kw, kernel in (("pq_streamed_bf16_transfer", dict(transfer_dtype=torch.bfloat16),
                              "stats_f32"),
                             ("pq_streamed_verified", dict(compute_dtype="verified"),
                              "stats_verify")):
        torch.cuda.reset_peak_memory_stats()
        (pq_1, seconds), counts = counted(lambda: once(lambda: train_pq_streamed(
            None, reader, STREAM_M, STREAM_BITS, 1, batch_size=B, initial_model=pq_s, device=dev,
            **kw)),
            total)
        require(counts.get(kernel, 0) == batches, f"stream: {name} launched {counts}")
        require(bool(torch.isfinite(pq_1.codebooks).all()), f"stream: {name} not finite")
        out[name] = {"seconds_per_iteration": seconds, "rows_per_s": n / seconds,
                     "peak_bytes_added": peak_over(base), "launches": counts}
        progress(name, out[name])

    # The corpus on the card, then the chunked trainer from the same seed.
    x = torch.empty((n, d), device=dev)
    for off, b in reader.prefetch_batches(B, copy=False):
        x[off:off + b.shape[0]].copy_(torch.from_numpy(b))
    gen = torch.Generator(device=dev).manual_seed(SEED)
    (pq_c, seconds), counts = counted(lambda: once(lambda: train_pq_chunked(
        gen, x, STREAM_M, STREAM_BITS, STREAM_ITERATIONS, chunk=B)), total)
    require(bool(torch.equal(pq_s.codebooks, pq_c.codebooks)),
            "stream: the streamed PQ differs from the resident chunked PQ at batch_size == chunk")
    out["pq_chunked_resident"] = {"seconds_per_iteration": seconds / STREAM_ITERATIONS,
                                  "rows_per_s": STREAM_ITERATIONS * n / seconds,
                                  "codebooks_equal": True, "launches": counts}
    progress("pq_chunked_resident", out["pq_chunked_resident"])

    # The streamed covariance against the resident one; the OPQ trainers.
    cov, seconds = once(lambda: streamed_covariance(reader, batch_size=B, device=dev))
    want = linalg.covariance(x, 0)
    cov_err = float((cov - want).abs().max() / want.abs().max())
    require(cov_err < 1e-4, f"stream: the streamed covariance is {cov_err} off the resident one")
    out["covariance"] = {"seconds": seconds, "max_rel_err": cov_err}
    progress("covariance", out["covariance"])
    for name, trainer, n_it, passes in (
            ("gaussian_opq_streamed", train_gaussian_opq_streamed, 2, 1 + 2),
            ("opq_streamed", train_opq_streamed, 2, 1 + 2 * 2)):
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()  # the resident corpus included
        torch.cuda.reset_peak_memory_stats()
        gen = torch.Generator(device=dev).manual_seed(SEED)
        ((model, losses), seconds), counts = counted(lambda: once(lambda: logged_losses(
            lambda: trainer(gen, reader, STREAM_M, STREAM_BITS, n_it, batch_size=B,
                            device=dev))), total)
        gram = model.projection.T @ model.projection
        ortho = float((gram - torch.eye(d, device=dev)).abs().max())
        require(ortho < 1e-5 and bool(torch.isfinite(model.codebooks).all()),
                f"stream: {name}'s projection is {ortho} off orthonormal")
        out[name] = {"iterations": n_it, "passes": passes, "seconds": seconds,
                     "seconds_per_pass": seconds / passes, "peak_bytes_added": peak_over(base),
                     "losses": losses, "orthonormal_err": ortho, "launches": counts}
        progress(name, out[name])

    # The streaming encode (the default encode, uint8), f32 and bf16 on the wire.
    want = pq_s.quantize_batch(x, method="kernel").cpu().numpy()
    codes, seconds = once(lambda: stream_encode(pq_s, reader, batch_size=B))
    require(bool((codes == want).all()), "stream: stream_encode's codes differ from quantize_batch's")
    codes_bf16, seconds_bf16 = once(lambda: stream_encode(pq_s, reader, batch_size=B,
                                                          transfer_dtype=torch.bfloat16))
    require(bool((codes_bf16 == want).all()),
            "stream: stream_encode's codes with a bf16 transfer differ from quantize_batch's")
    out["stream_encode"] = {"seconds": seconds, "rows_per_s": n / seconds,
                            "bf16_transfer_seconds": seconds_bf16,
                            "bf16_transfer_rows_per_s": n / seconds_bf16,
                            "codes_equal": True, "bf16_codes_equal": True}
    progress("stream_encode", out["stream_encode"])
    del x

    # Resumable: interrupted after 5 batches, resumed, then called again.
    path = os.path.join(out_dir, "codes.u8")
    try:
        stream_encode_resumable(pq_s, Interrupting(reader, 5), path, batch_size=B, flush_every=1)
        require(False, "stream: the interrupted encode ran to its end")
    except Interrupted:
        pass
    with open(path + ".progress.json") as f:
        done = json.load(f)["completed_rows"]
    require(0 < done < n, f"stream: the interrupted encode recorded {done} rows done")
    resumed, seconds = once(lambda: stream_encode_resumable(pq_s, reader, path, batch_size=B))
    require(bool((np.asarray(resumed) == want).all()),
            "stream: the resumed encode differs from the uninterrupted one")
    (again, seconds_again), counts = counted(lambda: once(lambda: stream_encode_resumable(
        pq_s, reader, path, batch_size=B)), total)
    require(not counts and bool((np.asarray(again) == want).all()),
            f"stream: the third call encoded again ({counts})")
    out["stream_encode_resumable"] = {"rows_done_when_stopped": done,
                                      "resume_seconds": seconds,
                                      "third_call_seconds": seconds_again, "equal": True}
    progress("stream_encode_resumable", out["stream_encode_resumable"])
    return out


def conformance_on_card(dev):
    """The three conformant trainers at the gate, on the card, against the
    goldens' objectives (1e-3) and the reference's bands."""
    with open(GOLDENS) as f:
        golden = json.load(f)
    shape, m = tuple(golden["gate"]["shape"]), golden["gate"]["m"]
    trainers = {"pq": conformance.train_pq_conformant, "opq": conformance.train_opq_conformant,
                "gaussian_opq": conformance.train_gaussian_opq_conformant}
    out = {}
    for name, trainer in trainers.items():
        for seed, g in golden["seeds"].items():
            x, master = conformance.reference_test_instances(int(seed), shape)
            model = trainer(x, m, GATE_BITS, 10, 1, master=master, device=dev)
            xt = torch.from_numpy(x).to(dev)
            loss = float((xt - model.reconstruct_batch(model.quantize_batch(xt)))
                         .pow(2).sum(1).sqrt().mean())
            recorded = g[f"{name}_objective"]
            rel = abs(loss - recorded) / recorded
            require(rel <= 1e-3 and loss < GATE_BANDS[name],
                    f"stream: conformant {name} at seed {seed}: {loss} against {recorded}")
            out[f"{name}_{seed}"] = {"objective": loss, "golden": recorded, "rel": rel}
    return out


def build_stages(log):
    return {args[0]: args[1] for args, _ in log.find("IVF build pass")}


def stream_corpus_i(gen, ivf_data, out_dir, total):
    """Corpus I (the ivf phase's corpus and model) from a file: training,
    both builds and the refine, against the same over the tensor."""
    x, coarse, rpq, q = ivf_data
    dev = x.device
    n = x.shape[0]
    path = os.path.join(out_dir, "ivf.fvecs")
    file_bytes = n * (x.shape[1] + 1) * 4
    free = require_free_disk(out_dir, file_bytes)
    _, seconds = once(lambda: [native.write_fvecs(path, x[off:off + STREAM_BLOCK], append=off > 0)
                               for off in range(0, n, STREAM_BLOCK)])
    out = {"rows": n, "file_bytes": os.path.getsize(path), "free_bytes": free,
           "write_s": seconds}
    reader = open_native(path)
    require(reader.n == n, "stream: corpus I's file has another row count")

    (trained, seconds), counts = counted(lambda: once(lambda: ivf.train_ivf_pq(
        torch.Generator(device=dev).manual_seed(SEED), reader, IVF_C, IVF_M, IVF_BITS,
        coarse_iterations=IVF_ITERATIONS, pq_iterations=IVF_ITERATIONS)), total)
    require(bool(torch.isfinite(trained[0]).all() and torch.isfinite(trained[1].codebooks).all()),
            "stream: train_ivf_pq over the reader gave non-finite centroids")
    out["train_ivf_pq_s"] = seconds
    out["train_launches"] = counts

    builds = {}
    for placement in ("host", "device"):
        row = {}
        for source, corpus in (("tensor", x), ("reader", reader)):
            torch.cuda.synchronize()
            base = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            ((index, log), seconds), counts = counted(lambda: once(lambda: with_log(
                lambda: ivf.build_ivf(coarse, rpq, corpus, capacity="auto", placement=placement))),
                total)
            row[source] = {"seconds": seconds, "stages_s": build_stages(log),
                           "peak_bytes_added": peak_over(base), "launches": counts}
            builds[source] = index
        for name in ("cell_codes", "cell_ids", "cell_norms"):
            require(bool(torch.equal(getattr(builds["reader"], name), getattr(builds["tensor"], name))),
                    f"stream: the {placement} build from the reader differs in {name}")
        row["cells_equal"] = True
        out[f"build_{placement}"] = row
        if placement == "host":
            del builds["reader"]
    index = builds["tensor"]
    del builds

    # Refine by the reader against refine by the tensor, IVF and flat.
    got = ivf.ivf_search(index, q, TOP_K, nprobe=8, refine_with=reader)
    want = ivf.ivf_search(index, q, TOP_K, nprobe=8, refine_with=x)
    require(bool(torch.equal(got[1], want[1]) and torch.equal(got[0], want[0])),
            "stream: ivf_search refined by the reader differs from refined by the tensor")
    out["ivf_search_refine_ms"] = {
        "reader": time_ms(lambda: ivf.ivf_search(index, q, TOP_K, nprobe=8, refine_with=reader)),
        "tensor": time_ms(lambda: ivf.ivf_search(index, q, TOP_K, nprobe=8, refine_with=x))}
    progress("ivf_search_refine_ms", out["ivf_search_refine_ms"])
    del index
    flat = train_pq_chunked(gen, x[:N_PREFIX], IVF_M, IVF_BITS, IVF_ITERATIONS)
    codes = flat.quantize_batch(x, method="kernel")
    got = search(flat, q, codes, TOP_K, refine_with=reader)
    want = search(flat, q, codes, TOP_K, refine_with=x)
    require(bool(torch.equal(got[1], want[1]) and torch.equal(got[0], want[0])),
            "stream: search refined by the reader differs from refined by the tensor")
    out["search_refine_ms"] = {
        "reader": time_ms(lambda: search(flat, q, codes, TOP_K, refine_with=reader)),
        "tensor": time_ms(lambda: search(flat, q, codes, TOP_K, refine_with=x))}
    progress("search_refine_ms", out["search_refine_ms"])
    reader.close()
    return out


def phase_stream(gen, ivf_data):
    """Corpora on disk, every count at 0 before each step: corpus S (the
    768-d streaming width, 2^22 rows, 12.9 GB as fvecs) written, read by the
    native reader (required: its handle on every reader opened), the
    streamed PQ trainer (4 iterations, f32, batches of 2^18 rows: the added
    device memory under 4 GB, exactly 4 x 16 statistics launches, then bit
    for bit the chunked trainer over the corpus on the card at chunk=2^18),
    one iteration of a bf16 transfer and of the verified mode, the streamed
    covariance against the resident one, Gaussian OPQ and OPQ streamed, the
    streaming encode (codes bit for bit ``quantize_batch(method="kernel")``'s
    on the resident corpus, f32 and bf16 on the wire) and the resumable
    encode (interrupted, resumed bit for bit, a third call encoding
    nothing); the conformant trainers at the gate against the goldens; and
    corpus I (the ivf phase's 10M rows, 5.1 GB) read back for
    ``train_ivf_pq``, both builds (cells bit for bit the tensor builds') and
    the refine of ``ivf_search`` and ``search`` (equal to the tensor's).
    Returns the launches."""
    require(native.NATIVE_AVAILABLE, "stream: the native reader library did not build")
    total = collections.Counter()
    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        file_bytes = STREAM_N * (STREAM_D + 1) * 4
        free = require_free_disk(tmp, file_bytes)
        path = os.path.join(tmp, "stream.fvecs")
        _, seconds = once(lambda: write_stream_corpus(path, gen))
        out["corpus_s"] = {"rows": STREAM_N, "d": STREAM_D, "m": STREAM_M, "k": 2 ** STREAM_BITS,
                           "batch": STREAM_BATCH, "file_bytes": os.path.getsize(path),
                           "free_bytes": free, "write_s": seconds}
        with open_native(path) as reader:
            require(reader.n == STREAM_N and reader.dim == STREAM_D,
                    "stream: corpus S's file has another shape")
            out["corpus_s"].update(stream_corpus_s(reader, tmp, total, gen.device))
        os.remove(path)
        out["conformance"] = conformance_on_card(gen.device)
        out["corpus_i"] = stream_corpus_i(gen, ivf_data, tmp, total)
    require_no_shallow("stream", total)
    emit("stream", **out, launches=dict(total))
    return total


# -- the sharded phase: parallel/ on torch.distributed ---------------------------


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def digest(*tensors) -> str:
    """sha256 of the tensors' bytes: two ranks' results compared bit for bit."""
    h = hashlib.sha256()
    for t in tensors:
        h.update(t.detach().contiguous().cpu().numpy().tobytes())
    return h.hexdigest()


def bits_equal(a, b) -> bool:
    return a.shape == b.shape and a.dtype == b.dtype and digest(a) == digest(b)


def kmeans_inputs(dev):
    """IVF10M's coarse k-means shape: 2^20 clustered rows of d=128 and the
    first 4,096 of them as the initial centroids, from SEED + 2."""
    n, d, c = IVF10M
    x = clustered_corpus(torch.Generator(device=dev).manual_seed(SEED + 2), n, d, c)
    return x, x[:c].clone()


def train_generator(dev):
    return torch.Generator(device=dev).manual_seed(SEED + 1)


def per_iteration(train, it):
    """``train(it)``'s result and the seconds of one Lloyd's iteration: the
    difference of a run of ``it`` iterations and a run of one (each
    synchronised, after a warm-up run of one), so that the set-up (sums of
    squares, initial draws) drops out."""
    train(1)
    _, t1 = once(lambda: train(1))
    out, t = once(lambda: train(it))
    return out, (t - t1) / (it - 1)


def time_all_reduce(mesh, dev):
    """The all-reduce of one flagship iteration's sums and counts (147,456
    bytes) over the data axis's group: CUDA events around it, median of 50."""
    from reductive_tpu_torch._collectives import all_reduce

    sums, counts = torch.randn((M, K, DS), device=dev), torch.randn((M, K), device=dev)
    group = mesh.get_group("data")
    return {"bytes": 4 * (sums.numel() + counts.numel()),
            "ms": time_ms(lambda: all_reduce(group, sums, counts), reps=50)}


def sharded_nccl_rank(work, out, total):
    """The one-rank NCCL group: ``train_pq_chunked_sharded`` at the flagship
    width against ``train_pq_chunked``, ``sharded_kmeans`` at IVF10M's
    coarse shape against ``kmeans_with_centroids_chunked`` (each bit for bit:
    one rank sweeps all the rows in the single-card trainer's launches), and
    the all-reduce of one iteration's statistics timed."""
    from reductive_tpu_torch import parallel

    dev = torch.device("cuda", torch.cuda.current_device())
    mesh = parallel.make_mesh()
    _, _, corpus = flagship(dev)
    it = SHARDED_ITERATIONS
    single, t_single = per_iteration(
        lambda n: train_pq_chunked(train_generator(dev), corpus, M, BITS, n), it)
    sharded, t_sharded = per_iteration(lambda n: counted(
        lambda: parallel.train_pq_chunked_sharded(train_generator(dev), corpus, M, BITS, n,
                                                  mesh=mesh), total)[0], it)
    require(bits_equal(sharded.codebooks, single.codebooks),
            "sharded: one-rank NCCL train_pq_chunked_sharded differs from train_pq_chunked")
    np.save(os.path.join(work, "pq_single.npy"), single.codebooks.cpu().numpy())
    out["pq"] = {"iterations": it, "s_per_iteration": t_sharded,
                 "single_card_s_per_iteration": t_single, "bit_equal": True,
                 "mse": reconstruction_mse(single, corpus)}
    out["all_reduce"] = time_all_reduce(mesh, dev)
    del corpus
    x, c0 = kmeans_inputs(dev)
    it = SHARDED_KMEANS_ITERATIONS
    (c1, l1), t_single = per_iteration(
        lambda n: kmeans.kmeans_with_centroids_chunked(x, c0, n), it)
    (c2, l2), t_sharded = per_iteration(lambda n: counted(
        lambda: parallel.sharded_kmeans(mesh, x, c0, n), total)[0], it)
    require(bits_equal(c1, c2) and bits_equal(l1, l2),
            "sharded: one-rank NCCL sharded_kmeans differs from kmeans_with_centroids_chunked")
    np.save(os.path.join(work, "kmeans_single.npy"), c1.cpu().numpy())
    out["kmeans"] = {"shape": list(IVF10M), "iterations": it, "s_per_iteration": t_sharded,
                     "single_card_s_per_iteration": t_single, "bit_equal": True,
                     "loss": float(l2)}


def sharded_gloo_rank(work, out, total, digests):
    """One of two gloo ranks on the one card: each sharded entry in turn,
    its result held to the single-card entry's; the digests of what must be
    the same bits on both ranks go to the parent."""
    from reductive_tpu_torch import parallel
    from reductive_tpu_torch.pq.train import _streamed_sumsq, lloyd_iteration_chunked

    dev = torch.device("cuda", torch.cuda.current_device())
    mesh = parallel.make_mesh()
    _, pq, corpus = flagship(dev)
    seconds = out["seconds"] = {}

    # Chunked PQ over the flagship corpus, 2,000,000 rows a rank.
    it = SHARDED_ITERATIONS
    (got, _), seconds["train_pq_chunked_sharded"] = once(lambda: counted(
        lambda: parallel.train_pq_chunked_sharded(train_generator(dev), corpus, M, BITS, it,
                                                  mesh=mesh), total))
    digests["train_pq_chunked_sharded"] = digest(got.codebooks)
    single = Pq(codebooks=torch.from_numpy(np.load(os.path.join(work, "pq_single.npy"))).to(dev))
    mse, mse_single = reconstruction_mse(got, corpus), reconstruction_mse(single, corpus)
    require(abs(mse - mse_single) <= 1e-4 * mse_single,
            f"sharded: two-rank PQ mse {mse} against the single card's {mse_single}")
    codes_a = got.quantize_batch(corpus, method="kernel")
    codes_b = single.quantize_batch(corpus, method="kernel")
    out["pq"] = {"iterations": it, "mse": mse, "single_card_mse": mse_single,
                 "max_abs_diff_vs_single_card": float((got.codebooks - single.codebooks).abs().max()),
                 "codes_differ_share": float((codes_a != codes_b).float().mean())}
    del codes_a, codes_b
    out["all_reduce"] = time_all_reduce(mesh, dev)

    # The data x model step: a (1, 2) mesh, each rank 8 of the 16
    # subquantizers over every row, bit for bit the single-card step.
    mesh2 = parallel.make_mesh((1, 2), ("data", "model"))
    j = mesh2.get_local_rank("model")
    half = M // 2
    block = corpus[:, j * half * DS:(j + 1) * half * DS].contiguous()
    cb = pq.codebooks[j * half:(j + 1) * half].contiguous()
    ((new, loss), _), seconds["sharded_pq_train_step"] = once(lambda: counted(
        lambda: parallel.sharded_pq_train_step(block.view(N_CORPUS, half, DS), cb, mesh=mesh2),
        total))
    want, _ = lloyd_iteration_chunked(block, cb, _streamed_sumsq(block, half, chunk=32768))
    require(bits_equal(new, want), "sharded: the model-axis step differs from the single-card step")
    digests["sharded_pq_train_step_loss"] = digest(loss)
    out["pq_train_step"] = {"mesh": [1, 2], "loss": float(loss)}
    del block

    # OPQ on the prefix.
    (opq, _), seconds["train_opq_chunked_sharded"] = once(lambda: counted(
        lambda: parallel.train_opq_chunked_sharded(train_generator(dev), corpus[:N_PREFIX], M,
                                                   BITS, SHARDED_OPQ_ITERATIONS, mesh=mesh),
        total))
    eye = torch.eye(D, device=dev)
    ortho = float((opq.projection.T @ opq.projection - eye).abs().max())
    require(ortho <= 1e-5, f"sharded: the OPQ projection is {ortho} off orthonormal")
    digests["train_opq_chunked_sharded"] = digest(opq.projection, opq.codebooks)
    out["opq"] = {"rows": N_PREFIX, "iterations": SHARDED_OPQ_ITERATIONS, "ortho_err": ortho,
                  "mse": reconstruction_mse(opq, corpus[:N_PREFIX])}

    # Encode and exhaustive search over the flagship codes.
    (codes, _), seconds["encode_sharded"] = once(lambda: counted(
        lambda: parallel.encode_sharded(pq, corpus, mesh=mesh), total))
    require(torch.equal(codes, ops.pq_encode(pq.codebooks, corpus)),
            "sharded: encode_sharded differs from the single-card encode")
    digests["encode_sharded"] = digest(codes)
    gq = torch.Generator(device=dev).manual_seed(SEED + 3)
    for nq in (16, 128):
        q = torch.randn((nq, D), generator=gq, device=dev)
        for metric in ("l2", "dot"):
            name = f"search_sharded_{nq}_{metric}"
            (res, _), seconds[name] = once(lambda: counted(
                lambda: search_module.search_sharded(pq, q, codes, TOP_K, mesh=mesh,
                                                     metric=metric), total))
            want = search(pq, q, codes, TOP_K, metric=metric)
            require(bits_equal(res[0], want[0]) and torch.equal(res[1], want[1]),
                    f"sharded: {name} differs from search")
            digests[name] = digest(*res)
    del corpus, codes

    # Sharded k-means at IVF10M's coarse shape.
    x, c0 = kmeans_inputs(dev)
    it = SHARDED_KMEANS_ITERATIONS
    ((c, loss), _), seconds["sharded_kmeans"] = once(lambda: counted(
        lambda: parallel.sharded_kmeans(mesh, x, c0, it), total))
    digests["sharded_kmeans"] = digest(c, loss)
    single_c = torch.from_numpy(np.load(os.path.join(work, "kmeans_single.npy"))).to(dev)
    out["kmeans"] = {"iterations": it, "loss": float(loss),
                     "max_abs_diff_vs_single_card": float((c - single_c).abs().max())}
    del x, c0

    # IVF search over the ivf phase's index, its cells split over the ranks.
    index = io.load(os.path.join(work, IVF_SAVED[0]))
    saved = np.load(os.path.join(work, IVF_SAVED[1]))
    q, planted = torch.from_numpy(saved["q"]).to(dev), torch.from_numpy(saved["planted"]).to(dev)
    half_cells = index.n_cells // 2
    (d8, i8), seconds["ivf_search_sharded_nprobe8"] = once(lambda: counted(
        lambda: ivf.ivf_search_sharded(index, q, TOP_K, nprobe=8, mesh=mesh), total)[0])
    sd8, si8 = ivf.ivf_search(index, q, TOP_K, nprobe=8)
    recall = float((i8 == planted[:, None]).any(1).float().mean())
    recall_single = float((si8 == planted[:, None]).any(1).float().mean())
    require(recall >= recall_single, f"sharded: recall {recall} below the single card's")
    require(bool((d8[:, -1] <= sd8[:, -1]).all()), "sharded: a k-th score worse than ivf_search's")
    (dfull, ifull), seconds["ivf_search_sharded_full"] = once(lambda: counted(
        lambda: ivf.ivf_search_sharded(index, q, TOP_K, nprobe=half_cells, mesh=mesh),
        total)[0])
    sdf, sif = ivf.ivf_search(index, q, TOP_K, nprobe=index.n_cells)
    require(bits_equal(dfull, sdf) and torch.equal(ifull, sif),
            "sharded: ivf_search_sharded over every cell differs from ivf_search")
    digests["ivf_search_sharded"] = digest(d8, i8, dfull, ifull)
    out["ivf"] = {"recall_at_10_nprobe8": recall, "single_card_recall_at_10_nprobe8": recall_single,
                  "kth_score_no_worse": True, "full_coverage_nprobe_a_rank": half_cells,
                  "full_coverage_bit_equal": True}
    del index

    # A 768-d corpus on disk, each rank reading its half through its own reader.
    require(native.NATIVE_AVAILABLE, "sharded: the native reader library did not build")
    with open_native(os.path.join(work, SHARDED_STREAM_FILE)) as reader:
        (spq, _), seconds["train_pq_streamed_sharded"] = once(lambda: counted(
            lambda: parallel.train_pq_streamed_sharded(
                train_generator(dev), reader, STREAM_M, STREAM_BITS,
                SHARDED_STREAM_ITERATIONS, mesh=mesh, batch_size=STREAM_BATCH), total))
        digests["train_pq_streamed_sharded"] = digest(spq.codebooks)
        (scodes, _), seconds["stream_encode_sharded"] = once(lambda: counted(
            lambda: parallel.stream_encode_sharded(spq, reader, mesh=mesh,
                                                   batch_size=STREAM_BATCH), total))
        require(np.array_equal(scodes, stream_encode(spq, reader, batch_size=STREAM_BATCH)),
                "sharded: stream_encode_sharded differs from stream_encode")
        digests["stream_encode_sharded"] = hashlib.sha256(scodes.tobytes()).hexdigest()
    out["stream"] = {"rows": SHARDED_STREAM_N, "d": STREAM_D, "m": STREAM_M,
                     "iterations": SHARDED_STREAM_ITERATIONS, "codes_bit_equal": True}


def sharded_rank(role: str, rank: str, world: str, port: str, work: str) -> int:
    """A rank of the sharded phase, started by :func:`phase_sharded` as
    ``chip_smoke.py --sharded-rank ROLE RANK WORLD PORT WORK``: ``nccl``,
    the one-rank NCCL group (``initialize_distributed()`` with no launcher),
    or ``gloo``, one of two ranks over gloo on the one card.  Writes its
    result to ``WORK/ROLE_RANK.json``."""
    import torch.distributed as dist

    from reductive_tpu_torch import parallel

    rank_, world_ = int(rank), int(world)
    if role == "nccl":
        parallel.initialize_distributed()
    else:
        parallel.initialize_distributed(f"127.0.0.1:{port}", world_, rank_, backend="gloo")
    out = {"role": role, "rank": rank_, "world_size": dist.get_world_size(),
           "backend": dist.get_backend(), "device": str(torch.cuda.current_device())}
    total, digests = collections.Counter(), {}
    t0 = time.perf_counter()
    if role == "nccl":
        sharded_nccl_rank(work, out, total)
    else:
        sharded_gloo_rank(work, out, total, digests)
    out.update(seconds_total=time.perf_counter() - t0, launches=dict(total), digests=digests)
    with open(os.path.join(work, f"{role}_{rank_}.json"), "w") as f:
        json.dump(out, f)
    dist.destroy_process_group()
    return 0


def run_sharded_ranks(work, role, world):
    """Start ``world`` ranks of ``role`` as child processes of this script
    and wait for them; one that fails, or outlives SHARDED_TIMEOUT, stops
    the others and fails the run (its log's end on stderr)."""
    port = str(free_port())
    env = {k: v for k, v in os.environ.items() if k not in LAUNCHER_ENV}
    logs = [open(os.path.join(work, f"{role}_{r}.log"), "w") for r in range(world)]
    procs = [subprocess.Popen([sys.executable, os.path.abspath(__file__), SHARDED_RANK_FLAG, role,
                               str(r), str(world), port, work],
                              stdout=logs[r], stderr=subprocess.STDOUT, env=env)
             for r in range(world)]
    deadline = time.monotonic() + SHARDED_TIMEOUT
    try:
        while any(p.poll() is None for p in procs):
            failed = [p for p in procs if p.poll() not in (None, 0)]
            if failed or time.monotonic() > deadline:
                break
            time.sleep(0.2)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
            p.wait()
        for log in logs:
            log.close()
    bad = [r for r, p in enumerate(procs) if p.returncode != 0]
    for r in bad:
        with open(os.path.join(work, f"{role}_{r}.log")) as f:
            print(f"--- sharded {role} rank {r} (exit {procs[r].returncode}):\n{f.read()[-6000:]}",
                  file=sys.stderr, flush=True)
    require(not bad, f"sharded: {role} ranks {bad} failed or did not finish")
    results = []
    for r in range(world):
        with open(os.path.join(work, f"{role}_{r}.json")) as f:
            results.append(json.load(f))
    return results


def phase_sharded(gen, work):
    """``parallel/`` on ``torch.distributed``, each rank a child process of
    this script on the one card, every count at 0 before each sharded call
    in each rank: a one-rank NCCL group (the flagship chunked PQ and IVF10M's
    coarse k-means bit for bit the single-card trainers', the all-reduce of
    an iteration's 147,456 bytes timed), then two ranks over gloo (chunked
    PQ, the data x model step, OPQ, encode and exhaustive search, k-means,
    IVF search over the ivf phase's index, the streamed PQ trainer and
    encode over a 768-d corpus on disk), each against its single-card entry,
    every result the same bits on both ranks.  Two processes on one card,
    with gloo through the host: the times measure no scaling.  Returns the
    launches, summed over the ranks."""
    path = os.path.join(work, SHARDED_STREAM_FILE)
    require_free_disk(work, SHARDED_STREAM_N * (STREAM_D + 1) * 4)
    _, write_s = once(lambda: write_stream_corpus(path, gen, SHARDED_STREAM_N))
    t0 = time.perf_counter()
    nccl = run_sharded_ranks(work, "nccl", 1)
    gloo = run_sharded_ranks(work, "gloo", 2)
    seconds = time.perf_counter() - t0
    differ = [key for key in gloo[0]["digests"] if gloo[0]["digests"][key] != gloo[1]["digests"][key]]
    require(gloo[0]["digests"].keys() == gloo[1]["digests"].keys() and not differ,
            f"sharded: the two ranks' results differ: {differ}")
    launches = collections.Counter()
    for result in nccl + gloo:
        launches.update(result["launches"])
    for name in SHARDED_KERNELS:
        require(launches[name] > 0, f"sharded: kernel {name} was launched in no rank")
    require_no_shallow("sharded", launches)
    same_bits = sorted(gloo[0]["digests"])
    for result in nccl + gloo:
        del result["digests"]
    emit("sharded", world_sizes={"nccl": nccl[0]["world_size"], "gloo": gloo[0]["world_size"]},
         backends={"nccl": nccl[0]["backend"], "gloo": gloo[0]["backend"]},
         note="the gloo ranks are two processes on one card, gloo through the host: "
              "their times measure no scaling",
         nccl=nccl[0], gloo=gloo, ranks_same_bits=same_bits,
         launches_by_rank=[r["launches"] for r in nccl + gloo], launches=dict(launches),
         corpus_write_s=write_s, seconds=seconds)
    os.remove(path)
    return launches


# -- the examples phase: the user programs end to end ------------------------


def phase_examples(work):
    """The port's user programs (``reductive_tpu_torch.examples``) through
    their ``main(argv)``, each run with every count at 0 before it (their
    printed lines go to stderr): the pipeline at 8 bits with the IVF, disk
    and virtual lifecycles, the pipeline's OPQ at 4 bits (packed codes), and
    the serving program (its sharded scan over a one-rank NCCL group that
    the program sets up and tears down; this phase runs last).  Fails when a
    recall or agreement is below its bar, the sharded scan disagrees with
    ``search``, or a statistics kernel, an encode kernel, ``adc``,
    ``adc_u4`` or ``decode`` was launched in no run.  Returns the
    launches."""
    import contextlib

    from reductive_tpu_torch.examples import pipeline, serving

    programs = {"pipeline": pipeline, "serving": serving}
    total = collections.Counter()
    runs = {}
    for name, (program, argv) in EXAMPLES_RUNS.items():
        if program == "pipeline":
            # The corpus goes to the default temporary directory, on the
            # filesystem of ``work``.
            require_free_disk(work, EXAMPLES_N * (EXAMPLES_D + 1) * 4)
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(sys.stderr):
            result, counts = counted(lambda: programs[program].main(argv), total)
        runs[name] = {"argv": argv, "result": result, "seconds": time.perf_counter() - t0,
                      "max_memory_allocated": torch.cuda.max_memory_allocated(),
                      "launches": counts}
        progress(f"examples_{name}", {"seconds": runs[name]["seconds"]})
        if program == "pipeline":
            recalls = {"recall": result["recall"]}
            recalls.update({key: result[key]["recall"] for key in ("ivf", "disk", "virtual")
                            if key in result})
            low = {key: r for key, r in recalls.items() if r < PIPELINE_RECALL_BAR}
            require(not low, f"examples: {name} recalls below {PIPELINE_RECALL_BAR}: {low}")
        else:
            lines = {key: result[key] for key in ("self_hit", "mips_agreement", "retrievable")}
            low = {key: v for key, v in lines.items() if v < SERVING_BAR}
            require(not low, f"examples: {name} below {SERVING_BAR}: {low}")
            require(result["sharded_agreement"] == 1.0,
                    f"examples: the sharded scan agrees {result['sharded_agreement']} "
                    "with search, not 1.00")
    for prefix in ("stats_", "encode_"):
        require(any(n > 0 for key, n in total.items() if key.startswith(prefix)),
                f"examples: no {prefix}* kernel was launched")
    for name in EXAMPLES_KERNELS:
        require(total[name] > 0, f"examples: kernel {name} was launched in no run")
    require_no_shallow("examples", total)
    emit("examples", runs=runs, launches=dict(total))
    return total


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


def adc_entry(tables, codes, splits, packed=False):
    """The C entry of the f32 or the int8 ADC kernel alone (not counted), its
    table built once outside the call, under the wrapper's plan."""
    nq, m, k = tables.shape
    out = torch.empty((nq, codes.shape[0]), device=codes.device)
    if splits == "int8":
        held = adc_table_int8(tables)
    else:
        held = (decode_table(tables.reshape(nq, m * k, 1), splits)[0].view(nq, m, k),)
    return adc_launcher(held, codes, out, packed=packed, counted=False)


def kernel_table(pq, corpus, codes, launches, pq4, codes4, packed4):
    """Each kernel at the shape the main paths give it (n = 4,000,000 rows;
    ADC with 16 queries, the dense search; k=16 for the packed kernels): time,
    plain version's time, one library call's time, and the bound.  For the
    verified kernels ``ms`` is the whole wrapper (kernel, ``nonzero``, exact
    re-encode of the flagged rows) and ``kernel_ms`` the kernel alone; their
    library call is the exact path itself.  The bf16 encode and statistics
    rows and the ADC rows carry ``kernel_ms`` too: their C entries alone (ADC:
    the table built outside the call)."""
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
    # The selection kernel's: 128 queries' ADC scores over a chunk of 524,288 codes.
    sel_scores = ops.adc_scores_kernel(adc_tables(pq, corpus[1000:1000 + SELECT_NQ]),
                                       codes[:SELECT_N])

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
         lambda: compare_adc(tables, codes, 2), bound(adc_bytes, nq * n * M, "f32"),
         adc_entry(tables, codes, 2)),
        ("adc_int8", lambda: ops.adc_scores_kernel(tables, codes, splits="int8"),
         lambda: ops.adc_scores_reference(tables, codes, splits="int8"),
         library_adc_int8(tables, idx_flat),
         lambda: compare_adc(tables, codes, "int8"),
         bound(adc_bytes, nq * n * M, "int8"), adc_entry(tables, codes, "int8")),
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
         bound(adc4_bytes, nq * n * M, "f32"), adc_entry(tables4, packed4, 2, True)),
        ("adc_int8_u4", lambda: ops.adc_scores_kernel(tables4, packed4, splits="int8", packed=True),
         lambda: ops.adc_scores_reference(tables4, packed4, splits="int8", packed=True),
         library_adc_int8(tables4, idx4_flat),
         lambda: compare_packed_adc(tables4, codes4, packed4, "int8"),
         bound(adc4_bytes, nq * n * M, "int8"), adc_entry(tables4, packed4, "int8", True)),
        ("select", lambda: select_smallest_kernel(sel_scores, SELECT_K),
         lambda: select_smallest_reference(sel_scores, SELECT_K),
         lambda: torch.topk(sel_scores, SELECT_K, dim=1, largest=False),
         lambda: compare_select(sel_scores, SELECT_K),
         bound(4 * SELECT_NQ * SELECT_N, 0, "f32")),
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
            "shape": f"nq={SELECT_NQ} n={SELECT_N} k={SELECT_K}" if name == "select" else
                     f"n={n} d={D} m={M} k={k_here}" + (f" nq={nq}" if name.startswith("adc") else ""),
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

    work = tempfile.mkdtemp(prefix="chip_smoke_")
    try:
        return run_phases(card, work)
    finally:
        shutil.rmtree(work, ignore_errors=True)


def flagship(dev):
    """The generator after the flagship model and corpus, the model (random
    codebooks) and the 4,000,000-row corpus, made on the card from SEED."""
    gen = torch.Generator(device=dev).manual_seed(SEED)
    pq = Pq(codebooks=torch.randn((M, K, DS), generator=gen, device=dev))
    corpus = torch.randn((N_CORPUS, D), generator=gen, device=dev)
    return gen, pq, corpus


def run_phases(card: str, work: str) -> int:
    """Every phase in turn, then the kernels line and the result line;
    ``work`` holds the files the phases share."""
    gen, pq, corpus = flagship(torch.device("cuda"))

    phase_kernels(pq, corpus, gen)
    codes, serve_launches = phase_serve(pq, corpus)
    train_launches, train_out = phase_train(corpus)
    for name in ("stats_f32", "stats_bf16", "encode_f32", "decode"):
        require(train_launches.get(name, 0) > 0, f"train: kernel {name} was never launched")
    exact_launches, exact_out = phase_exact(pq, corpus, train_out)
    pq4, codes4, packed4, packed_launches = phase_packed(corpus, gen)
    probe, wide_launches, wide_rows = phase_wide(corpus, gen)
    ivf_launches, ivf_update_launches, ivf_data = phase_ivf(gen, work)
    stream_launches = phase_stream(gen, ivf_data)
    del ivf_data
    torch.cuda.empty_cache()
    # Launches of each kernel on the main paths together; every count was set
    # to 0 just before its path was driven and read just after.
    launches = collections.Counter()
    for counts in (serve_launches, train_launches, exact_launches, packed_launches, wide_launches,
                   ivf_launches, ivf_update_launches, stream_launches):
        launches.update(counts)
    for name in KERNELS:
        require(launches[name] > 0, f"kernel {name} was launched on no path")
    require_no_shallow("main paths", launches)
    rows = kernel_table(pq, corpus, codes, launches, pq4, codes4, packed4) + wide_rows
    # The sharded phase's ranks make their own corpora: this process's large
    # tensors go first.
    del pq, corpus, codes, pq4, codes4, packed4
    torch.cuda.empty_cache()
    launches.update(phase_sharded(gen, work))
    launches.update(phase_examples(work))
    for row in rows:
        row["launches"] = launches[row["name"]]
    torch.cuda.synchronize()

    by_name = {row["name"]: row for row in rows}
    ms = {name: by_name[name]["ms"] for name in BEFORE_MS if name in by_name}
    ms.update({f"{name}_kernel": by_name[name]["kernel_ms"]
               for name in ("stats_verify", "encode_verify", "stats_bf16", "encode_bf16", "adc",
                            "adc_u4", "adc_int8", "adc_int8_u4")})
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
    if sys.argv[1:2] == [SHARDED_RANK_FLAG]:
        sys.exit(sharded_rank(*sys.argv[2:]))
    sys.exit(main())
