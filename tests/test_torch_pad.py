"""The narrow kernels' padded instances, on the CPU.

Every subvector width up to 32 runs the narrow row-tile kernels of
``csrc/assign_tile.cuh``: the ones compiled for 4, 8, 16 and 32 take the
other widths zero-padded to the next of those (``ops.assign.padded_ds``).
The kernels run only on the card (``tests/test_torch_cuda_kernels.py``: the
padded instances against the shallow kernel bit for bit, rows off 16 bytes,
k from 1 to 257; ``chip_smoke.py``).  Here: the route chooser and the
counters it names, the padded width, the launch plans and the statistics'
scratch within an H100's limits at every width and k, the verify limit of
the widths where padding adds a depth step, and the wrappers (their plain
versions on the CPU) against the JAX package at ds 2, 3, 10 and 20, with the
Pallas kernels in the interpreter.  Tolerances as in the other parity tests:
f32 codes 99.9% equal and a differing code within 2^-13 of the best
distance, bf16 99% and 2^-7; statistics counts equal once the near-tie rows
are taken out, sums within rtol 1e-5, atol 1e-4; the verified wrappers equal
to the exact path.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from reductive_tpu.ops import pq_assign_stats_verified as j_pq_assign_stats_verified
from reductive_tpu.ops import pq_encode as j_pq_encode
from reductive_tpu.ops import pq_encode_verified as j_pq_encode_verified
from reductive_tpu.ops.stats import pq_assign_stats as j_pq_assign_stats
from reductive_tpu_torch.ops import (
    pq_assign_stats, pq_assign_stats_verified, pq_encode, pq_encode_reference, pq_encode_verified,
)
from reductive_tpu_torch.ops import assign as tassign
from reductive_tpu_torch.ops import stats as tstats
from reductive_tpu_torch.ops.assign import _blocks_per_subquantizer, bf16_tile_plan, padded_ds
from reductive_tpu_torch.pq import primitives as tprim

from torch_port_util import assert_codes_near_optimal, j, make_pq_data, near_tie_rows, t

H100_SMS = 132
SM_SHARED = 233_472     # bytes of shared memory an H100 SM gives its blocks
BLOCK_SHARED = 232_448  # the most one block may take
BLOCK_RESERVED = 1024   # reserved by CUDA for each resident block
PARTIAL_ELEMS = 1 << 26  # the statistics' slots: 256 MB of f32 at most


# -- the route -----------------------------------------------------------------------


def test_the_route_is_a_pure_function_of_the_width_and_the_alignment():
    for ds in range(1, 41):
        for aligned in (False, True):
            assert tassign.assign_route(ds, aligned) == ("narrow" if ds <= 32 else "deep")
    # The counter a launch adds to, from x's own address: the narrow kernels'
    # own name at 4, 8, 16, 32 on 16 bytes, their padded instance ("_pad") at
    # every other width up to 32 and off 16 bytes, the deep kernel ("_wide")
    # above; the shallow kernel, which only a forced route takes, "_shallow".
    for ds in range(1, 41):
        buf = torch.zeros((3 * 2 * ds + 3,))
        for off in range(4):
            x = buf[off:off + 3 * 2 * ds].view(3, 2 * ds)
            route = tassign._route_of(ds, x)
            got = tassign._counter("encode_f32", route, ds, x)
            if ds > 32:
                want = "encode_f32_wide"
            elif ds in (4, 8, 16, 32) and off == 0:
                want = "encode_f32"
            else:
                want = "encode_f32_pad"
            assert got == want, (ds, off)
            assert tassign._counter("encode_f32", "shallow", ds, x) == "encode_f32_shallow"


@pytest.mark.parametrize("ds", range(1, 33))
def test_the_padded_width(ds):
    dsp = padded_ds(ds)
    assert dsp in (4, 8, 16, 32) and dsp >= ds
    assert dsp == 4 or dsp // 2 < ds  # the least that holds ds
    assert padded_ds(dsp) == dsp
    # The same depth steps as the shallow kernel's one chunk, except at 17..24.
    assert (dsp // 8 or 1) == (-(-ds // 8) if not 17 <= ds <= 24 else 4)
    assert tassign.wide_chunking(ds)[1] == 1


def test_the_padded_width_refuses_the_wide_route():
    for ds in (0, 33, 50, 768):
        with pytest.raises(ValueError, match="from 1 to 32"):
            padded_ds(ds)


# -- the plans -------------------------------------------------------------------------


def _f32_shared_bytes(dsp: int, stats: bool) -> int:
    """The f32 and verified kernels' shared memory, from their layout
    (``csrc/encode.cu`` / ``csrc/stats.cu`` ``F32Shape``): 256 staged
    centroids, both TF32 parts at a depth padded to 8 per step, and their
    |c|^2; two f32 buffers of the tile's rows (1,024 rows at a width of 4,
    512 at 8, 256 at 16, 128 at 32); a code, a distance and a runner-up a
    row; the statistics add the counting sort."""
    steps = -(-dsp // 8)
    rows = 2 * (8 if dsp <= 4 else 4 if dsp <= 8 else 32 // dsp) * 64
    staged = 4 * (2 * steps * 256 * 8 + 256)
    tile = 4 * (2 * rows * dsp + 3 * rows)
    sort = 4 * (8 * 256 + 256 + 8) + 2 * rows if stats else 0
    return staged + tile + sort


@pytest.mark.parametrize("k", [1, 8, 128, 256, 257, 4096, 65536])
@pytest.mark.parametrize("ds", range(1, 33))
def test_the_padded_plans_fit_the_card(ds, k):
    m = 10
    dsp = padded_ds(ds)
    for stats in (False, True):
        f32 = _f32_shared_bytes(dsp, stats)
        assert f32 <= BLOCK_SHARED
        assert (2 if dsp <= 8 else 1) * (f32 + BLOCK_RESERVED) <= SM_SHARED
        for n in (1, 4097, 4_000_000):
            sms = None if stats else H100_SMS
            plan = bf16_tile_plan(n, m, k, ds, sms=sms)
            # Planned at its padded width: the instance that runs it.
            assert plan == bf16_tile_plan(n, m, k, dsp, sms=sms)
            assert plan.smem_bytes <= BLOCK_SHARED
            assert plan.blocks_per_sm * (plan.smem_bytes + BLOCK_RESERVED) <= SM_SHARED
            assert plan.blocks >= 1 and plan.blocks * m < 2 ** 31
            if stats:
                assert plan.blocks * m * k * (dsp + 1) <= max(PARTIAL_ELEMS, m * k * (dsp + 1))
                blocks = _blocks_per_subquantizer(n, m, k, dsp)
                assert blocks * m * k * (dsp + 1) <= max(PARTIAL_ELEMS, m * k * (dsp + 1))


# -- the verify limit -------------------------------------------------------------------


@pytest.mark.parametrize("ds", range(17, 25))
def test_verify_scale_at_the_padded_widths_is_the_docstrings_larger_bound(ds):
    cb, _ = make_pq_data(120 + ds, 1, 3, 5, ds)
    cn = np.sqrt((cb.astype(np.float64) ** 2).sum(axis=2)).max(axis=1)
    tile = 3.25 + 5 * 4                       # four depth steps, the fourth of zeros
    wide = 3.5 + (5 + 2.0 ** -6) * 3 + 0.26   # the shallow kernel's one chunk of three
    assert tile > wide
    formula = 2 * (max(tile, wide) * 2.0 ** -22 + ds * 2.0 ** -24)
    assert tassign.f32_route(ds) == "tf32x3_pad"
    e = tassign.verify_scale(t(cb))
    np.testing.assert_allclose(e.numpy(), formula * 2 * cn, rtol=1e-6)
    np.testing.assert_array_equal(e.numpy(), tassign.verify_scale(t(cb), route="tf32x3_pad").numpy())
    # Wider than either kernel's own bound: sound for the padded and the shallow one.
    for route in ("tf32x3_wide", "tf32x3"):
        assert bool((e > tassign.verify_scale(t(cb), route=route)).all())


# -- the wrappers against the JAX package ---------------------------------------------------

# (n, m, k, ds): the widths of 300-d vectors at m = 150 and 30, an odd one,
# and one whose padded width takes a fourth depth step.
F32_SHAPES = [(600, 10, 16, 2), (500, 3, 20, 3), (400, 4, 37, 10), (300, 2, 24, 20)]
# bf16 in the interpreter needs m*k >= 1024 (ROADMAP, queue 3).
BF16_SHAPES = [(400, 8, 128, 2), (300, 4, 256, 3), (300, 4, 256, 10), (200, 2, 512, 20)]


@pytest.mark.parametrize("n,m,k,ds", F32_SHAPES)
def test_pq_encode_at_padded_widths_matches_jax(n, m, k, ds):
    cb, x = make_pq_data(130 + ds, n, m, k, ds)
    got = pq_encode(t(cb), t(x), dtype=torch.int32, compute_dtype=torch.float32).numpy()
    want = np.asarray(j_pq_encode(j(cb), j(x), dtype=jnp.int32, compute_dtype=jnp.float32,
                                  interpret=True))
    exact = tprim.quantize_batch(t(cb), t(x), dtype=torch.int32).numpy()
    assert_codes_near_optimal(cb, x, got, want, min_equal=0.999, rel_tol=2.0 ** -13)
    assert_codes_near_optimal(cb, x, got, exact, min_equal=0.999, rel_tol=2.0 ** -13)


@pytest.mark.parametrize("n,m,k,ds", BF16_SHAPES)
def test_pq_encode_bf16_at_padded_widths_matches_jax(n, m, k, ds):
    cb, x = make_pq_data(140 + ds, n, m, k, ds)
    got = pq_encode(t(cb), t(x), dtype=torch.int32).numpy()
    want = np.asarray(j_pq_encode(j(cb), j(x), dtype=jnp.int32, interpret=True))
    assert_codes_near_optimal(cb, x, got, want, min_equal=0.99, rel_tol=2.0 ** -7)


@pytest.mark.parametrize("compute", ["f32", "bf16"])
@pytest.mark.parametrize("ds", [2, 3, 10, 20])
def test_pq_assign_stats_at_padded_widths_matches_jax(ds, compute):
    n, m, k, _ = (F32_SHAPES if compute == "f32" else BF16_SHAPES)[[2, 3, 10, 20].index(ds)]
    tcd, jcd, rel = {"f32": (torch.float32, jnp.float32, 2.0 ** -13),
                     "bf16": (torch.bfloat16, jnp.bfloat16, 2.0 ** -7)}[compute]
    cb, x = make_pq_data(150 + ds, n, m, k, ds)
    sums, counts = pq_assign_stats(t(cb), t(x), compute_dtype=tcd)
    assert tuple(sums.shape) == (m, k, ds) and tuple(counts.shape) == (m, k)
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


@pytest.mark.parametrize("n,m,k,ds", F32_SHAPES)
def test_verified_modes_at_padded_widths_match_jax_and_the_exact_path(n, m, k, ds):
    cb, x = make_pq_data(160 + ds, n, m, k, ds)
    cb[:, k - 1] = cb[:, 0]  # exact ties: flagged, re-encoded, first index kept
    x[:20] = np.tile(cb[:, 0].reshape(-1), (20, 1))
    exact = tprim.quantize_batch(t(cb), t(x), dtype=torch.int32).numpy()
    got = pq_encode_verified(t(cb), t(x), dtype=torch.int32).numpy()
    want = np.asarray(j_pq_encode_verified(j(cb), j(x), dtype=jnp.int32, interpret=True))
    np.testing.assert_array_equal(got, exact)
    np.testing.assert_array_equal(got, want)
    # The encode and the statistics flag alike, with the limit of the width's route.
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
