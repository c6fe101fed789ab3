"""reductive_tpu_torch.ops.stats against the JAX package's fused
assign+statistics kernel (Pallas interpreter) on the CPU.

The CUDA kernel cannot run here: on CPU tensors the wrapper takes its plain
version, which is what these tests hold against JAX.  ``chip_smoke.py`` and
``tests/test_torch_cuda_kernels.py`` hold the kernel against the plain
version on the card.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from reductive_tpu.ops import pq_encode as j_pq_encode
from reductive_tpu.ops.stats import pq_assign_stats as j_pq_assign_stats
from reductive_tpu_torch.ops import pq_assign_stats, pq_assign_stats_reference, pq_encode_reference

from torch_port_util import all_distances, j, make_pq_data, t


def _stats_of(x, codes, k, rows):
    """f64 sums and counts of the given rows of ``x`` under ``codes``."""
    n, m = codes.shape
    ds = x.shape[1] // m
    sums = np.zeros((m, k, ds))
    counts = np.zeros((m, k))
    xs = x.reshape(n, m, ds).astype(np.float64)
    for i in rows:
        for jq in range(m):
            sums[jq, codes[i, jq]] += xs[i, jq]
            counts[jq, codes[i, jq]] += 1
    return sums, counts


def _assert_stats_agree(cb, x, got, want, got_codes, want_codes, near_tie):
    """Counts equal and sums within rtol 1e-5 / atol 1e-4 over the rows on
    which both sides chose the same codes.  Rows on which they differ are
    taken out of both sides, and each must be a near-tie: the two chosen
    centroids within ``near_tie`` relative of each other in exact distance."""
    k = cb.shape[1]
    differ = np.flatnonzero((got_codes != want_codes).any(axis=1))
    assert len(differ) <= max(1, got_codes.shape[0] // 100), f"rows that differ: {differ.tolist()}"
    if len(differ):
        dist = all_distances(cb, x)
        dg = np.take_along_axis(dist, got_codes[:, :, None].astype(np.int64), axis=2)[:, :, 0]
        dw = np.take_along_axis(dist, want_codes[:, :, None].astype(np.int64), axis=2)[:, :, 0]
        rel = np.abs(dg - dw)[differ] / np.minimum(dg, dw)[differ]
        assert rel.max() <= near_tie, f"rows {differ.tolist()} differ by {rel.max():.3e} relative"
    gs, gc = _stats_of(x, got_codes, k, differ)
    ws, wc = _stats_of(x, want_codes, k, differ)
    np.testing.assert_array_equal(got[1] - gc, want[1] - wc)
    np.testing.assert_allclose(got[0] - gs, want[0] - ws, rtol=1e-5, atol=1e-4)


# (n, m, k, ds): ragged last blocks (1000, 257 and 2000 are no multiples of
# the JAX kernel's row block), k = 3 no multiple of 8, ds = 5 no power of two.
F32_SHAPES = [(1000, 4, 8, 4), (257, 2, 3, 5), (2000, 8, 64, 4)]


@pytest.mark.parametrize("n,m,k,ds", F32_SHAPES)
def test_pq_assign_stats_f32_matches_jax(n, m, k, ds):
    cb, x = make_pq_data(5 + n, n, m, k, ds)
    sums, counts = pq_assign_stats(t(cb), t(x))
    assert sums.dtype == counts.dtype == torch.float32
    assert tuple(sums.shape) == (m, k, ds) and tuple(counts.shape) == (m, k)
    assert float(counts.sum()) == n * m
    jsums, jcounts = j_pq_assign_stats(j(cb), j(x), interpret=True)
    got_codes = pq_encode_reference(t(cb), t(x), dtype=torch.int32, compute_dtype=torch.float32)
    want_codes = j_pq_encode(j(cb), j(x), dtype=jnp.int32, compute_dtype=jnp.float32, interpret=True)
    # The JAX exact mode carries 2^-17 split error and 2^-15 key coarsening,
    # the port is true fp32: a near-tie within 2^-13 may go either way.
    _assert_stats_agree(
        cb, x, (sums.numpy(), counts.numpy()), (np.asarray(jsums), np.asarray(jcounts)),
        got_codes.numpy(), np.asarray(want_codes), near_tie=2.0 ** -13)


# The interpreter runs the bf16 mode on the CPU at these widths.
BF16_SHAPES = [(600, 16, 64, 8), (333, 4, 256, 8), (300, 1, 256, 8)]


@pytest.mark.parametrize("n,m,k,ds", BF16_SHAPES)
def test_pq_assign_stats_bf16_matches_jax(n, m, k, ds):
    cb, x = make_pq_data(17 + n, n, m, k, ds)
    sums, counts = pq_assign_stats(t(cb), t(x), compute_dtype=torch.bfloat16)
    jsums, jcounts = j_pq_assign_stats(j(cb), j(x), compute_dtype=jnp.bfloat16, interpret=True)
    got_codes = pq_encode_reference(t(cb), t(x), dtype=torch.int32, compute_dtype=torch.bfloat16)
    want_codes = j_pq_encode(j(cb), j(x), dtype=jnp.int32, interpret=True)
    # Both sides sum the bf16-rounded x; bf16 products: a near-tie within 2^-7.
    xr = t(x).to(torch.bfloat16).to(torch.float32).numpy()
    _assert_stats_agree(
        cb, xr, (sums.numpy(), counts.numpy()), (np.asarray(jsums), np.asarray(jcounts)),
        got_codes.numpy(), np.asarray(want_codes), near_tie=2.0 ** -7)


def test_bf16_mode_sums_the_rounded_instances():
    # 1 + 2^-9 rounds to 1 in bfloat16: the bf16 mode's sum shows it, the
    # f32 mode's sum does not.
    cb = np.zeros((1, 2, 4), dtype=np.float32)
    cb[0, 1] = 100.0
    x = np.full((3, 4), 1.0 + 2.0 ** -9, dtype=np.float32)
    s32, c32 = pq_assign_stats(t(cb), t(x))
    s16, c16 = pq_assign_stats(t(cb), t(x), compute_dtype=torch.bfloat16)
    np.testing.assert_array_equal(c32.numpy(), [[3.0, 0.0]])
    np.testing.assert_array_equal(c16.numpy(), [[3.0, 0.0]])
    np.testing.assert_array_equal(s32.numpy()[0, 0], np.float32(3.0) * x[0])
    np.testing.assert_array_equal(s16.numpy()[0, 0], [3.0] * 4)


@pytest.mark.parametrize("compute_dtype", [torch.float32, torch.bfloat16])
def test_stats_against_a_numpy_oracle(compute_dtype):
    # Inputs rounded as the mode rounds them, f64 sums under the plain
    # version's own codes: the sums are f32 sums of at most 500 terms.
    cb, x = make_pq_data(29, 500, 3, 7, 4)
    sums, counts = pq_assign_stats_reference(t(cb), t(x), compute_dtype=compute_dtype)
    codes = pq_encode_reference(t(cb), t(x), dtype=torch.int32, compute_dtype=compute_dtype).numpy()
    xr = t(x).to(compute_dtype).to(torch.float32).numpy()
    want_sums, want_counts = _stats_of(xr, codes, 7, range(500))
    np.testing.assert_array_equal(counts.numpy(), want_counts)
    np.testing.assert_allclose(sums.numpy(), want_sums, rtol=1e-5, atol=1e-4)


def test_ties_take_the_first_index_and_empty_cells_stay_zero():
    cb = np.tile(np.array([[0.5, -1.0, 2.0, 0.25]], dtype=np.float32), (1, 5, 1))
    x = np.random.default_rng(0).standard_normal((9, 4), dtype=np.float32)
    sums, counts = pq_assign_stats(t(cb), t(x))
    np.testing.assert_array_equal(counts.numpy(), [[9.0, 0.0, 0.0, 0.0, 0.0]])
    np.testing.assert_array_equal(sums.numpy()[0, 1:], 0.0)
    np.testing.assert_allclose(sums.numpy()[0, 0], x.sum(axis=0), rtol=1e-5, atol=1e-6)


def test_plain_version_walks_chunks(monkeypatch):
    from reductive_tpu_torch.ops import stats as tstats

    cb, x = make_pq_data(31, 700, 2, 9, 4)
    whole = pq_assign_stats_reference(t(cb), t(x))
    monkeypatch.setattr(tstats, "_REFERENCE_CHUNK", 128)  # 700 = 5 * 128 + 60
    parts = pq_assign_stats_reference(t(cb), t(x))
    np.testing.assert_array_equal(parts[1].numpy(), whole[1].numpy())
    np.testing.assert_allclose(parts[0].numpy(), whole[0].numpy(), rtol=1e-5, atol=1e-5)


def test_grid_is_a_function_of_the_shapes():
    from reductive_tpu_torch.ops.stats import _blocks_per_subquantizer as blocks

    assert blocks(4_000_000, 16, 256, 8) == 66          # fills the card
    assert blocks(1, 16, 256, 8) == 1                   # never more blocks than 256-row tiles
    assert blocks(1000, 16, 256, 8) == 4
    assert blocks(4_000_000, 1, 256, 8) == 1056
    assert blocks(10_000_000, 1, 65536, 32) == 31       # 256 MB of scratch at most
    assert blocks(10_000_000, 64, 65536, 32) == 1


def test_pq_assign_stats_errors():
    cb, x = make_pq_data(43, 10, 2, 4, 4)
    with pytest.raises(ValueError) as jerr:
        j_pq_assign_stats(j(cb), j(x[:, :6]), interpret=True)
    with pytest.raises(ValueError) as terr:
        pq_assign_stats(t(cb), t(x[:, :6]))
    assert str(terr.value) == str(jerr.value)
    with pytest.raises(TypeError):
        pq_assign_stats(t(cb), t(x).double())
    with pytest.raises(ValueError, match="compute_dtype"):
        pq_assign_stats(t(cb), t(x), compute_dtype=torch.float16)
    with pytest.raises(ValueError, match="compute_dtype"):
        pq_assign_stats(t(cb), t(x), compute_dtype="verified")
