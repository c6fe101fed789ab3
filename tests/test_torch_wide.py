"""The port at every subvector width, against the JAX package on the CPU.

The JAX kernels take any ``ds``; the port's narrow kernels take 4, 8, 16 and
32, and every other ``ds`` takes the wide route (``csrc/assign_wide.cuh`` for
the assignment, the radix sort and segment sums of ``csrc/stats.cu`` for the
statistics, the scalar decode of ``csrc/decode.cu``).  Those kernels run only
on the card (``tests/test_torch_cuda_kernels.py``, ``chip_smoke.py``); here
the wrappers take their plain versions, held against the JAX kernels in the
Pallas interpreter at the odd and wide widths: ``ds`` 2 (the reference's own
quality-gate width, d = 20, m = 10), 3, 12, 48, and k-means' ``m = 1`` at
``ds`` 64 and 128.  Tolerances as in the narrow parity tests: f32 codes 99.9%
equal and a differing code within 2^-13 of the best distance (the JAX kernel's
split product and packed key), bf16 99% and 2^-7; decode bit-equal (int8
within one ulp).  Also here: the wide route's verify bound against its
formula, the one-hot sums that replaced ``index_add_``, and the probe's
reading of the tensor cores on simulated accumulators.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from reductive_tpu import kmeans as jk
from reductive_tpu.ops import pq_assign_stats_verified as j_pq_assign_stats_verified
from reductive_tpu.ops import pq_encode as j_pq_encode
from reductive_tpu.ops import pq_encode_verified as j_pq_encode_verified
from reductive_tpu.ops.decode import pq_decode as j_pq_decode
from reductive_tpu.ops.stats import pq_assign_stats as j_pq_assign_stats
from reductive_tpu_torch import kmeans as tk
from reductive_tpu_torch.linalg import one_hot_sums
from reductive_tpu_torch.ops import (
    pack_u4_codes, pq_assign_stats, pq_assign_stats_verified, pq_decode, pq_encode,
    pq_encode_reference, pq_encode_verified,
)
from reductive_tpu_torch.ops import assign as tassign
from reductive_tpu_torch.ops import probe as tprobe
from reductive_tpu_torch.ops import stats as tstats
from reductive_tpu_torch.pq import primitives as tprim

from torch_port_util import all_distances, assert_codes_near_optimal, j, make_pq_data, t

# (n, m, k, ds): odd and wide widths; m = 1 at k-means' widths.
F32_SHAPES = [(700, 10, 16, 2), (500, 3, 20, 3), (400, 4, 37, 12), (300, 2, 16, 48),
              (300, 1, 40, 64), (257, 1, 24, 128)]
# bf16 in the interpreter needs m*k >= 1024 (ROADMAP, queue 3).
BF16_SHAPES = [(500, 8, 128, 2), (300, 4, 256, 12), (200, 1, 1024, 64)]


@pytest.mark.parametrize("n,m,k,ds", F32_SHAPES)
def test_pq_encode_at_wide_widths_matches_jax(n, m, k, ds):
    cb, x = make_pq_data(60 + ds, n, m, k, ds)
    got = pq_encode(t(cb), t(x), dtype=torch.int32, compute_dtype=torch.float32).numpy()
    want = np.asarray(j_pq_encode(j(cb), j(x), dtype=jnp.int32, compute_dtype=jnp.float32,
                                  interpret=True))
    exact = tprim.quantize_batch(t(cb), t(x), dtype=torch.int32).numpy()
    assert_codes_near_optimal(cb, x, got, want, min_equal=0.999, rel_tol=2.0 ** -13)
    assert_codes_near_optimal(cb, x, got, exact, min_equal=0.999, rel_tol=2.0 ** -13)


@pytest.mark.parametrize("n,m,k,ds", BF16_SHAPES)
def test_pq_encode_bf16_at_wide_widths_matches_jax(n, m, k, ds):
    cb, x = make_pq_data(70 + ds, n, m, k, ds)
    got = pq_encode(t(cb), t(x), dtype=torch.int32).numpy()
    want = np.asarray(j_pq_encode(j(cb), j(x), dtype=jnp.int32, interpret=True))
    assert_codes_near_optimal(cb, x, got, want, min_equal=0.99, rel_tol=2.0 ** -7)


def _near_tie_rows(cb, x, a, b, rel):
    """Rows where codes ``a`` and ``b`` differ, each checked to be a near-tie:
    the two distances within ``rel`` of ``|x_j| max|2c_j| + max|c_j|^2``, the
    scale of a split product's error (at ds = 2 with many centroids the
    distances themselves are far smaller)."""
    differ = np.flatnonzero((a != b).any(axis=1))
    if len(differ):
        m, k, ds = cb.shape
        dist = all_distances(cb, x)
        da = np.take_along_axis(dist, a[:, :, None].astype(np.int64), axis=2)[:, :, 0]
        db = np.take_along_axis(dist, b[:, :, None].astype(np.int64), axis=2)[:, :, 0]
        cn = np.sqrt((cb.astype(np.float64) ** 2).sum(axis=2)).max(axis=1)
        xn = np.sqrt((x.reshape(-1, m, ds).astype(np.float64) ** 2).sum(axis=2))
        scale = 2 * xn * cn[None] + cn[None] ** 2
        assert (np.abs(da - db) / scale)[differ].max() <= rel
    return differ


@pytest.mark.parametrize("compute", ["f32", "bf16"])
@pytest.mark.parametrize("shape", F32_SHAPES[:4] + BF16_SHAPES[:1], ids=str)
def test_pq_assign_stats_at_wide_widths_matches_jax(shape, compute):
    n, m, k, ds = shape
    if compute == "bf16" and m * k < 1024:
        shape = (n, m, 1024 // m, ds)  # the interpreter's bf16 product needs m*k >= 1024
        n, m, k, ds = shape
    tcd, jcd, rel = {"f32": (torch.float32, jnp.float32, 2.0 ** -13),
                     "bf16": (torch.bfloat16, jnp.bfloat16, 2.0 ** -7)}[compute]
    cb, x = make_pq_data(80 + ds, n, m, k, ds)
    sums, counts = pq_assign_stats(t(cb), t(x), compute_dtype=tcd)
    jsums, jcounts = map(np.asarray, j_pq_assign_stats(j(cb), j(x), compute_dtype=jcd,
                                                       interpret=True))
    got_codes = pq_encode_reference(t(cb), t(x), dtype=torch.int32, compute_dtype=tcd).numpy()
    want_codes = np.asarray(j_pq_encode(j(cb), j(x), dtype=jnp.int32, compute_dtype=jcd,
                                        interpret=True))
    differ = _near_tie_rows(cb, x, got_codes, want_codes, rel)
    assert len(differ) <= max(1, n // 100)
    # Both sides sum the rows as the mode rounds them; take the differing rows
    # out of both, then counts equal and sums within rtol 1e-5, atol 1e-4.
    xr = t(x).to(tcd).to(torch.float32).numpy().reshape(n, m, ds).astype(np.float64)
    gs, ws = sums.numpy().astype(np.float64), jsums.astype(np.float64)
    gc, wc = counts.numpy().copy(), jcounts.copy()
    for i in differ:
        for jq in range(m):
            gs[jq, got_codes[i, jq]] -= xr[i, jq]
            ws[jq, want_codes[i, jq]] -= xr[i, jq]
            gc[jq, got_codes[i, jq]] -= 1
            wc[jq, want_codes[i, jq]] -= 1
    np.testing.assert_array_equal(gc, wc)
    np.testing.assert_allclose(gs, ws, rtol=1e-5, atol=1e-4)


DECODE_SHAPES = [(300, 10, 128, 2), (257, 3, 7, 3), (200, 4, 16, 12), (100, 2, 16, 48),
                 (100, 1, 40, 5)]


@pytest.mark.parametrize("splits", [1, 2, 3, "int8"])
@pytest.mark.parametrize("n,m,k,ds", DECODE_SHAPES)
def test_pq_decode_at_any_width_matches_jax(n, m, k, ds, splits):
    cb, _ = make_pq_data(90 + ds, n, m, k, ds)
    codes = np.random.default_rng(ds).integers(0, k, (n, m)).astype(np.uint8)
    got = pq_decode(t(cb), t(codes), splits=splits).numpy()
    want = np.asarray(j_pq_decode(j(cb), j(codes), splits=splits, interpret=True))
    if splits == "int8":  # within 1 ulp: XLA may contract acc * scale + offset
        assert np.all(np.abs(got - want) <= np.spacing(np.abs(want).astype(np.float32)))
    else:  # every element is one nonzero product: bit-equal
        np.testing.assert_array_equal(got, want)
    if k <= 16 and m % 2 == 0:
        packed = pq_decode(t(cb), pack_u4_codes(t(codes)), splits=splits, packed=True).numpy()
        np.testing.assert_array_equal(packed, got)


def test_kmeans_chunked_at_d128_matches_jax():
    # IVF's coarse stage is this call at m = 1, ds = d: the wide route on the card.
    rng = np.random.default_rng(95)
    x = rng.uniform(size=(600, 128)).astype(np.float32)
    init = x[:16].copy()
    for cd in (torch.float32, "verified"):
        got_c, got_l = tk.kmeans_with_centroids_chunked(t(x), t(init), 4, chunk=256,
                                                        use_kernel=True, compute_dtype=cd)
        want_c, want_l = jk.kmeans_with_centroids_chunked(
            j(x), j(init), 4, chunk=256, use_kernel=False,
            compute_dtype=jnp.float32 if cd is torch.float32 else cd)
        np.testing.assert_allclose(got_c.numpy(), np.asarray(want_c), atol=1e-5)
        np.testing.assert_allclose(float(got_l), float(want_l), rtol=1e-4)


@pytest.mark.parametrize("n,m,k,ds", [(600, 10, 16, 2), (300, 3, 20, 3), (257, 1, 24, 128)])
def test_verified_modes_at_wide_widths_match_jax_and_the_exact_path(n, m, k, ds):
    cb, x = make_pq_data(98 + ds, n, m, k, ds)
    cb[:, k - 1] = cb[:, 0]  # exact ties: flagged, re-encoded, first index kept
    x[:20] = np.tile(cb[:, 0].reshape(-1), (20, 1))
    exact = tprim.quantize_batch(t(cb), t(x), dtype=torch.int32).numpy()
    got = pq_encode_verified(t(cb), t(x), dtype=torch.int32).numpy()
    want = np.asarray(j_pq_encode_verified(j(cb), j(x), dtype=jnp.int32, interpret=True))
    np.testing.assert_array_equal(got, exact)
    np.testing.assert_array_equal(got, want)
    # The encode and the statistics flag alike (the wide route's limit, by default).
    e_codes, e_flags = tassign.pq_encode_verify_reference(t(cb), t(x), dtype=torch.int32)
    _, _, s_codes, s_flags = tstats.pq_assign_stats_verify_reference(t(cb), t(x))
    np.testing.assert_array_equal(e_codes.numpy(), s_codes.numpy())
    np.testing.assert_array_equal(e_flags.numpy(), s_flags.numpy())
    assert int(e_flags[:20].min()) == 1
    sums, counts = pq_assign_stats_verified(t(cb), t(x))
    jsums, jcounts = j_pq_assign_stats_verified(j(cb), j(x), interpret=True)
    want_sums, want_counts = tstats.stats_from_codes(t(exact), t(x), k)
    np.testing.assert_array_equal(counts.numpy(), want_counts.numpy())
    np.testing.assert_array_equal(counts.numpy(), np.asarray(jcounts))
    np.testing.assert_allclose(sums.numpy(), want_sums.numpy(), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(sums.numpy(), np.asarray(jsums), rtol=1e-5, atol=1e-5)


# -- the wide route's verify bound ---------------------------------------------------


@pytest.mark.parametrize("ds", [1, 2, 3, 12, 20, 33, 48, 64, 128, 768])
def test_verify_scale_of_the_wide_route_is_the_docstrings(ds):
    cb, _ = make_pq_data(96, 1, 2, 5, ds)
    cn = np.sqrt((cb.astype(np.float64) ** 2).sum(axis=2)).max(axis=1)
    steps = -(-ds // 8)
    kc = min(4, steps)  # instructions of depth 8 in a chunk; the last is zero-padded
    chunks = -(-steps // kc)
    assert tassign.wide_chunking(ds) == (kc, chunks)
    formula = 2 * ((3.5 + (5 + 2.0 ** -6) * kc + 0.26 * chunks) * 2.0 ** -22 + ds * 2.0 ** -24)
    e = tassign.verify_scale(t(cb), route="tf32x3_wide")
    np.testing.assert_allclose(e.numpy(), formula * 2 * cn, rtol=1e-6)
    # The default is the route the kernels take at this width.
    narrow = ds in (4, 8, 16, 32)
    assert tassign.f32_route(ds) == ("tf32x3" if narrow else "tf32x3_wide")
    np.testing.assert_array_equal(tassign.verify_scale(t(cb)).numpy(),
                                  tassign.verify_scale(t(cb), route=tassign.f32_route(ds)).numpy())
    # In one chunk, wider than the narrow route's by the reserve and the
    # addition; over many, narrower than any bound that grows with the depth.
    tile = tassign.verify_scale(t(cb), route="tf32x3")
    assert bool((e > tile).all()) if chunks == 1 else bool((e < tile).all())


def test_every_chunk_of_the_wide_bound_covers_its_terms():
    # Per instruction of depth 8 in a chunk: x_hi.w_hi (5 (1 + 2^-10)) and two
    # small-product instructions (10 * 2^-10 (1 + 2^-11)), in units of
    # 2^-22 P_c; per chunk addition 2^-24 (1 + 2^-8) |w| |x|, in units of 2^-22.
    per_step = 5 * (1 + 2.0 ** -10) + 10 * 2.0 ** -10 * (1 + 2.0 ** -11)
    assert per_step <= 5 + 2.0 ** -6
    assert 0.25 * (1 + 2.0 ** -8) <= 0.26
    # Sum over chunks of |x_c| |w_c| is at most |x| |w| (Cauchy-Schwarz).
    rng = np.random.default_rng(99)
    x, w = rng.standard_normal((2, 768))
    parts = sum(np.linalg.norm(x[i:i + 32]) * np.linalg.norm(w[i:i + 32]) for i in range(0, 768, 32))
    assert parts <= np.linalg.norm(x) * np.linalg.norm(w)


# -- one-hot sums ---------------------------------------------------------------------


def test_one_hot_sums_against_a_numpy_oracle():
    rng = np.random.default_rng(97)
    n, m, k, ds = 3000, 3, 11, 5
    xs = rng.standard_normal((n, m, ds)).astype(np.float32)
    new = rng.integers(0, k, (n, m))
    old = rng.integers(0, k, (n, m))
    w = (new != old).astype(np.float32)
    sums, counts = one_hot_sums(t(new), t(xs), k)
    dsum, dcount = one_hot_sums(t(new), t(xs), k, minus=t(old), weight=t(w))
    want = np.zeros((m, k, ds))
    want_d = np.zeros((m, k, ds))
    want_dc = np.zeros((m, k))
    for i in range(n):
        for jq in range(m):
            want[jq, new[i, jq]] += xs[i, jq]
            if w[i, jq]:
                want_d[jq, new[i, jq]] += xs[i, jq]
                want_d[jq, old[i, jq]] -= xs[i, jq]
                want_dc[jq, new[i, jq]] += 1
                want_dc[jq, old[i, jq]] -= 1
    np.testing.assert_allclose(sums.numpy(), want, rtol=1e-5, atol=1e-4)
    np.testing.assert_array_equal(counts.numpy(), np.stack([np.bincount(new[:, jq], minlength=k)
                                                           for jq in range(m)]))
    np.testing.assert_allclose(dsum.numpy(), want_d, rtol=1e-5, atol=1e-4)
    np.testing.assert_array_equal(dcount.numpy(), want_dc)
    # Chunk after chunk in a fixed order: the same bits again.
    again = one_hot_sums(t(new), t(xs), k)
    assert torch.equal(again[0], sums) and torch.equal(again[1], counts)


# -- the probe's reading of the tensor cores -----------------------------------------


def _simulated_instruction(A, B, C, bits=24, rounding=False):
    """What an instruction that aligns its nine addends to the largest
    exponent, keeps ``bits`` bits of each and of the sum, and truncates (or
    rounds to nearest) would return, in f64 (exact for these magnitudes)."""
    prods = A.astype(np.float64)[:, :, None, :] * B.astype(np.float64)[:, None, :, :]
    addends = np.concatenate([prods, C.astype(np.float64)[..., None]], axis=-1)
    top = np.abs(addends).max(axis=-1, keepdims=True)
    top = np.where(top > 0, top, 1.0)
    lsb = 2.0 ** (np.floor(np.log2(top)) - (bits - 1))
    cut = np.round if rounding else np.trunc
    total = (cut(addends / lsb) * lsb).sum(axis=-1)
    mag = np.where(total != 0, np.abs(total), 1.0)
    lsb_t = 2.0 ** (np.floor(np.log2(mag)) - (bits - 1))
    return (cut(total / lsb_t) * lsb_t).astype(np.float32)


@pytest.mark.parametrize("model,expect", [
    ({}, {"kept_bits": 24, "mode": "truncate", "ok": True}),
    ({"rounding": True}, {"kept_bits": 24, "mode": "round", "ok": False}),
    ({"bits": 22}, {"kept_bits": 22, "ok": False}),
], ids=["truncate-24", "round-24", "truncate-22"])
def test_the_probe_tells_the_accumulators_apart(model, expect):
    A, B, C, index = tprobe.probe_cases()
    assert A.shape == B.shape == (len(A), 64, 8) and C.shape == (len(A), 64, 64)
    # The inputs are TF32 values, as the instruction reads them.
    assert np.array_equal(tprobe._tf32(A), A) and np.array_equal(tprobe._tf32(B), B)
    report = tprobe.read_probe(A, B, C, _simulated_instruction(A, B, C, **model), index)
    for key, value in expect.items():
        assert report[key] == value, report
    if not model:
        assert 0 < report["max_err_ulps"] <= tprobe.MODEL_ULPS
