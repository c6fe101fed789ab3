"""The port at every subvector width, against the JAX package on the CPU.

The JAX kernels take any ``ds``; the port's narrow kernels are compiled for
4, 8, 16 and 32 and take every other ``ds`` up to 32 through their padded
instances, and every wider ``ds`` takes the wide route
(``csrc/assign_deep.cuh`` for the assignment, the accumulation from the codes
of ``csrc/stats.cu``, ``ops.stats.cell_stats``, for the statistics); decode at a ``ds`` that is no
multiple of 4 takes the scalar decode of ``csrc/decode.cu``.  Those kernels run only
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

from torch_port_util import assert_codes_near_optimal, j, make_pq_data, near_tie_rows, t

# (n, m, k, ds): odd and wide widths; m = 1 at k-means' widths.
F32_SHAPES = [(700, 10, 16, 2), (500, 3, 20, 3), (400, 4, 37, 12), (300, 2, 16, 48),
              (300, 1, 40, 64), (257, 1, 24, 128), (300, 3, 16, 50), (257, 1, 24, 75)]
# bf16 in the interpreter needs m*k >= 1024 (ROADMAP, queue 3).
BF16_SHAPES = [(500, 8, 128, 2), (300, 4, 256, 12), (200, 1, 1024, 64), (200, 4, 256, 50),
               (200, 2, 512, 75)]
# ds = 50 and 75: 300-d vectors at m = 6 and 4, GloVe-50 at m = 1 (the deep
# kernel on the card, its rows by cp.async where m ds is not a multiple of 4).
DEEP_ODD = [(300, 3, 16, 50), (257, 1, 24, 75)]


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


@pytest.mark.parametrize("compute", ["f32", "bf16"])
@pytest.mark.parametrize("shape", F32_SHAPES[:4] + BF16_SHAPES[:1] + DEEP_ODD, ids=str)
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
    differ = near_tie_rows(cb, x, got_codes, want_codes, rel)
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


@pytest.mark.parametrize("n,m,k,ds", [(600, 10, 16, 2), (300, 3, 20, 3), (257, 1, 24, 128)]
                         + DEEP_ODD)
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
    # The default is the route the kernels take at this width: the padded
    # narrow instance's own limit at 17 to 24 (a fourth step of zeros).
    narrow = ds in (4, 8, 16, 32)
    assert tassign.f32_route(ds) == ("tf32x3" if narrow else "tf32x3_pad" if 17 <= ds <= 24
                                     else "tf32x3_wide")
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


@pytest.mark.parametrize("model,expect", [
    ({}, {"kept_bits": 24, "mode": "truncate", "ok": True}),
    ({"rounding": True}, {"kept_bits": 24, "mode": "round", "ok": False}),
    ({"bits": 22}, {"kept_bits": 22, "ok": False}),
], ids=["truncate-24", "round-24", "truncate-22"])
def test_the_probe_reads_the_deep_kernels_instruction(model, expect):
    # N = 128: wgmma.m64n128k8, the deep kernel's; B (cases, 128, 8), C and D
    # (cases, 64, 128).
    A, B, C, index = tprobe.probe_cases(n=128)
    assert A.shape == (len(A), 64, 8) and B.shape == (len(A), 128, 8)
    assert C.shape == (len(A), 64, 128)
    assert np.array_equal(tprobe._tf32(B), B)
    report = tprobe.read_probe(A, B, C, _simulated_instruction(A, B, C, **model), index)
    for key, value in expect.items():
        assert report[key] == value, report
    with pytest.raises(ValueError, match="64 or 128"):
        tprobe.probe_wgmma_tf32("cpu", n=96)


# -- the deep kernel's operands and its dispatch ---------------------------------------


def _rna_tf32_oracle(v: np.ndarray) -> np.ndarray:
    """Round to 11 significant bits, nearest, ties away from zero, in f64
    arithmetic on the value (not on its bits)."""
    v = v.astype(np.float64)
    out = np.zeros_like(v)
    nz = v != 0
    e = np.floor(np.log2(np.abs(v[nz])))
    ulp = 2.0 ** (e - 10)
    out[nz] = np.sign(v[nz]) * np.floor(np.abs(v[nz]) / ulp + 0.5) * ulp
    return out


def test_split_tf32_is_cvt_rna_against_a_value_oracle():
    rng = np.random.default_rng(98)
    v = (rng.standard_normal(20000) * 2.0 ** rng.integers(-20, 21, 20000)).astype(np.float32)
    # Exact ties (bit 12 set, below it zero), both signs; mantissas that round
    # up into the next binade; zeros.
    tie = (rng.integers(0, 1 << 10, 500).astype(np.uint32) << 13 | 0x1000 | 0x3F800000).view(np.float32)
    top = np.full(8, np.float32(1.0) - np.float32(2.0 ** -24))
    v = np.concatenate([v, tie, -tie, top, -top, np.zeros(2, np.float32)]).astype(np.float32)
    hi, lo = tassign.split_tf32(t(v))
    hi, lo = hi.numpy(), lo.numpy()
    assert hi.dtype == lo.dtype == np.float32
    assert not (hi.view(np.uint32) & 0x1FFF).any() and not (lo.view(np.uint32) & 0x1FFF).any()
    np.testing.assert_array_equal(hi.astype(np.float64), _rna_tf32_oracle(v))
    # The same on the bits: add half a unit of the 13 dropped bits to the
    # magnitude (sign and magnitude are apart in f32), then clear them.
    bits = v.view(np.uint32).astype(np.uint64)
    np.testing.assert_array_equal(hi.view(np.uint32),
                                  ((bits + 0x1000) & 0xFFFFE000).astype(np.uint32))
    rest = v.astype(np.float64) - hi.astype(np.float64)  # exact in f32, so in f64
    assert np.array_equal(rest.astype(np.float32).astype(np.float64), rest)
    np.testing.assert_array_equal(lo.astype(np.float64), _rna_tf32_oracle(rest))
    # Ties went away from zero.
    assert (np.abs(hi[20000:21000]) > np.abs(np.concatenate([tie, -tie]))).all()
    # x = hi + lo + r with |r| <= 2^-22 |x|; exact where x has two 11-bit parts.
    assert (np.abs(v - (hi.astype(np.float64) + lo)) <= 2.0 ** -22 * np.abs(v)).all()
    a = _rna_tf32_oracle(rng.standard_normal(1000))
    # |b| in [2^-13, 2^-12) |a|: below half a's last unit, and a + b within 24 bits.
    b = _rna_tf32_oracle(a * 2.0 ** -12 * rng.uniform(0.5, 1, 1000) * rng.choice([-1, 1], 1000))
    x2 = (a + b).astype(np.float32)
    assert np.array_equal(x2.astype(np.float64), a + b)
    h2, l2 = tassign.split_tf32(t(x2))
    np.testing.assert_array_equal(h2.numpy().astype(np.float64) + l2.numpy(), a + b)


def _bf16_oracle(v: np.ndarray) -> np.ndarray:
    """Round f32 to bfloat16, nearest, ties to even, on the bits."""
    u = v.astype(np.float32).view(np.uint32).astype(np.uint64)
    u = (u + 0x7FFF + ((u >> 16) & 1)) >> 16 << 16
    return u.astype(np.uint32).view(np.float32)


@pytest.mark.parametrize("compute", ["f32", "bf16"])
@pytest.mark.parametrize("m,k,ds", [(1, 300, 128), (3, 129, 36), (2, 257, 100), (1, 5, 768),
                                   # every width above 32 takes the deep kernel
                                   (4, 7, 33), (2, 129, 37), (6, 256, 50), (1, 300, 50),
                                   (3, 257, 75), (2, 40, 150), (1, 9, 151)])
def test_deep_operands_are_the_layout_the_deep_kernel_loads(compute, m, k, ds):
    rng = np.random.default_rng(97)
    cb = rng.standard_normal((m, k, ds)).astype(np.float32)
    cb[0, 0, :4] = (np.array([0x3F808000, 0x3F818000, 0xBF808000, 0x40004000], np.uint32)
                    .view(np.float32) / 2)  # 2c on a bf16 tie, both ways and negative
    cd = torch.float32 if compute == "f32" else torch.bfloat16
    x = t(np.zeros((2, m * ds), np.float32))
    cb2, c_sqn = tassign._prepare(t(cb), x, torch.int32, cd)
    w, norms = tassign.deep_operands(cb2, c_sqn, cd)
    cols, depth = tassign.DEEP_STEP[cd]
    dsp = -(-ds // depth) * depth
    kp = -(-k // cols) * cols
    two_c = 2 * cb
    if compute == "bf16":
        assert w.dtype == torch.bfloat16 and tuple(w.shape) == (m, k, dsp)
        got = w.to(torch.float32).numpy()
        np.testing.assert_array_equal(got[..., :ds], _bf16_oracle(two_c))
    else:
        assert w.dtype == torch.float32 and tuple(w.shape) == (2, m, k, dsp)
        got = w.numpy()
        np.testing.assert_array_equal(got[0, ..., :ds], _rna_tf32_oracle(two_c))
        np.testing.assert_array_equal(got[1, ..., :ds],
                                      _rna_tf32_oracle(two_c.astype(np.float64) - got[0, ..., :ds]))
    assert not got[..., ds:].any()  # zeros past ds
    assert tuple(norms.shape) == (m, kp)
    np.testing.assert_array_equal(norms[:, :k].numpy(), c_sqn.numpy())
    assert bool(torch.isinf(norms[:, k:]).all()) and bool((norms[:, k:] > 0).all())


def test_the_wide_route_is_a_pure_function_of_the_width_and_the_alignment():
    # Every width up to 32 on the narrow kernels (padded where need be), every
    # wider one on the deep kernel at either alignment; its rows by TMA where
    # a row of m ds floats is a multiple of 16 bytes, else by cp.async.
    for ds in range(1, 800):
        for aligned in (False, True):
            assert tassign.assign_route(ds, aligned) == ("narrow" if ds <= 32 else "deep")
        for m in (1, 2, 3, 4, 6):
            assert tassign.deep_producer(m, ds) == ("tma" if m * ds % 4 == 0 else "cp.async")
    # What the wrappers hand the C entries: the converted operands wherever the
    # route is deep, whatever x's address.
    for ds, route in ((128, "deep"), (36, "deep"), (33, "deep"), (50, "deep"),
                      (12, "narrow"), (2, "narrow")):
        cb = torch.randn((2, 7, ds), generator=torch.Generator().manual_seed(ds))
        cb2, c_sqn = cb + cb, (cb * cb).sum(2)
        buf = torch.zeros((5 * 2 * ds + 1,))
        for x in (buf[:-1].view(5, 2 * ds), buf[1:].view(5, 2 * ds)):
            assert x.data_ptr() % 16 == (0 if x.storage_offset() == 0 else 4)
            got = tassign._route_operands(cb2, c_sqn, x, torch.float32)
            assert got[2] == route
            if route == "deep":
                assert tuple(got[0].shape) == (2, 2, 7, -(-ds // 32) * 32)
            else:
                assert got[0] is cb2 and got[1] is c_sqn


@pytest.mark.parametrize("m,ds", [(1, 36), (6, 50), (4, 75), (2, 150), (1, 128), (3, 68), (1, 768),
                                  (4, 33), (1, 50), (3, 37), (10, 2)])
def test_the_deep_row_map_reads_x_and_nothing_else(m, ds):
    # Over addresses at every 4-byte offset from 16: the map's base is on 16
    # bytes and off floats before x; every box the kernel asks for (subvector
    # j, chunks of 32 values from 0, 128 rows from 0) starts on 16 bytes and
    # holds its chunk at the shift (0 in the swizzled boxes of 32 values,
    # where every chunk starts on 16 bytes); each of its elements lies in x, is
    # zero-filled (past d + off, past n) or is one of the up to 3 floats
    # before x at row 0, which the chunk never covers; column c < ds of
    # subvector j's chunk is x[row, j ds + c].  Where d is no multiple of 4
    # the cp.async producer takes the rows and no map is made.
    d = m * ds
    for n in (1, 129, 300):
        for address in (1 << 20, (1 << 20) + 4, (1 << 20) + 8, (1 << 20) + 12, (1 << 32) + 4 * 1001):
            if tassign.deep_producer(m, ds) == "cp.async":
                with pytest.raises(ValueError, match="multiples of 4"):
                    tassign.deep_row_map(address, n, m, ds)
                continue
            rm = tassign.deep_row_map(address, n, m, ds)
            assert rm.base % 16 == 0 and rm.base + 4 * rm.off == address and 0 <= rm.off < 4
            assert rm.dims == (d + rm.off, n) and rm.stride == 4 * d and rm.stride % 16 == 0
            width, height = rm.box
            assert height == 128 and width == (32 if rm.off == 0 and ds % 4 == 0 else 36)
            for j in range(m):
                sh = rm.shift(j)
                for c0 in range(0, ds, 32):
                    col0 = rm.column(j, c0)
                    assert (4 * col0) % 16 == 0 and col0 + sh == rm.off + j * ds + c0
                    assert sh + 32 <= width  # the chunk fits its box
                    cols = np.arange(col0, col0 + width)[None, :]
                    rows = np.arange(0, min(n, height))[:, None]
                    inside = cols < rm.dims[0]  # else TMA fills zeros
                    at = rm.base + rows * rm.stride + 4 * cols
                    in_x = (at >= address) & (at < address + 4 * n * d)
                    before = (rows == 0) & (at >= address - 12) & (at < address)
                    assert (in_x | before | ~inside).all()
                    c = np.arange(width)[None, :] - sh  # the chunk's column of each box column
                    real = (c >= 0) & (c < 32) & (c0 + c < ds)
                    assert not (real & before).any()  # never read
                    want = address + 4 * (rows * d + j * ds + c0 + c)
                    used = np.broadcast_to(real & inside, at.shape)
                    assert (at[used] == want[used]).all()
                    assert (real <= inside).all()  # never zero-filled
