"""The verified exact modes, ``pq_encode_verified`` and
``pq_assign_stats_verified``, against the JAX package's (Pallas interpreter)
and against the exact f32 path, on the CPU.

Held to: codes equal on every entry; counts equal in every cell; sums within
``rtol=1e-5, atol=1e-5`` (f32 accumulation order).  The CUDA kernels cannot
run here: on CPU tensors the wrappers take the verify kernels' plain
versions, which agree with the exact path by themselves, so the wrappers'
correction (re-encode the flagged rows, move a changed row between cells) is
driven separately, from deliberately wrong first-stage results, and the flag
bound is held to its own derivation by perturbing the distances within it.
``tests/test_torch_cuda_kernels.py`` and ``chip_smoke.py`` hold the kernels
against these plain versions on the card.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from reductive_tpu.ops import pq_assign_stats_verified as j_pq_assign_stats_verified
from reductive_tpu.ops import pq_encode_verified as j_pq_encode_verified
from reductive_tpu.ops.stats import _einsum_stats_chunked as j_einsum_stats_chunked
from reductive_tpu.pq import primitives as jprim
from reductive_tpu_torch.ops import (
    pq_assign_stats_verified, pq_assign_stats_verify_reference, pq_encode_verified,
    pq_encode_verify_reference,
)
from reductive_tpu_torch.ops import assign as tassign
from reductive_tpu_torch.ops import stats as tstats
from reductive_tpu_torch.pq import primitives as tprim

from torch_port_util import j, make_pq_data, t


def _duplicated(seed, n, m, k, ds):
    """Codebooks with centroids 5 and 7 repeating 2 and 0, and rows exactly
    on centroids: every row sits on an exact tie for some subquantizer."""
    cb, _ = make_pq_data(seed, 1, m, k, ds)
    cb[:, 5] = cb[:, 2]
    cb[:, 7] = cb[:, 0]
    x = np.concatenate([cb[jq, np.arange(n) % k] for jq in range(m)], axis=1)
    return cb, x


def _near_coincident(seed, n, m, k, ds):
    """Rows within 1e-6 of a centroid pair's concatenation: a high flag rate."""
    cb, _ = make_pq_data(seed, 1, m, k, ds)
    x = np.tile(cb[0, :m].reshape(-1), (n, 1))
    x = x + 1e-6 * np.random.default_rng(seed + 1).standard_normal(x.shape)
    return cb, x.astype(np.float32)


def _adversarial(seed, n, m, k, ds):
    """Codebooks whose last centroid repeats the first, and rows in five
    blocks: on the repeated centroid (an exact tie), on the midpoint of a
    centroid pair (a tie up to rounding), zero, and Gaussian scaled by 1e-6
    and by 1e6."""
    cb, x = make_pq_data(seed, n, m, k, ds)
    cb[:, k - 1] = cb[:, 0]
    x = x.reshape(n, m, ds)
    fifth = n // 5
    pick = np.random.default_rng(seed + 1).integers(0, k, (fifth, m))
    sub = np.arange(m)[None, :]
    x[:fifth] = cb[:, 0][None]
    x[fifth:2 * fifth] = 0.5 * (cb[sub, pick] + cb[sub, (pick + 1) % k])
    x[2 * fifth:3 * fifth] = 0.0
    x[3 * fifth:4 * fifth] *= 1e-6
    x[4 * fifth:] *= 1e6
    return cb, x.reshape(n, m * ds).astype(np.float32)


def _half_integer_grid(seed, n, m, k, ds):
    """Codebooks and rows rounded to halves: many exact and near ties."""
    cb, x = make_pq_data(seed, n, m, k, ds)
    return np.round(2 * cb) / 2, np.round(2 * x) / 2


def _oracle_stats(cb, x):
    """The exact path's codes, and f64 sums and counts under them."""
    m, k, ds = cb.shape
    codes = tprim.quantize_batch(t(cb), t(x), dtype=torch.int32).numpy()
    xs = x.astype(np.float64).reshape(len(x), m, ds)
    sums, counts = np.zeros((m, k, ds)), np.zeros((m, k))
    for jq in range(m):
        np.add.at(sums[jq], codes[:, jq], xs[:, jq])
        np.add.at(counts[jq], codes[:, jq], 1.0)
    return codes, sums, counts


# -- the encode -------------------------------------------------------------------

# name -> (maker, (n, m, k, ds), JAX block_n, cap_frac): the shapes of the JAX
# package's own verified-encode tests.
ENCODE_CASES = {
    "gaussian": (make_pq_data, (3000, 4, 16, 4), 256, 1 / 16),
    "exact_ties": (_duplicated, (500, 2, 8, 4), 128, 1 / 16),
    "over_the_cap": (_near_coincident, (400, 2, 8, 4), 128, 1e-9),
    # Most of these rows are flagged: cap_frac=1.0 gathers and re-encodes
    # them, 1e-9 encodes everything by the exact path.
    "adversarial": (_adversarial, (1000, 4, 16, 8), 256, 1.0),
    "adversarial_over_the_cap": (_adversarial, (1000, 4, 16, 8), 256, 1e-9),
}


@pytest.mark.parametrize("case", list(ENCODE_CASES))
def test_pq_encode_verified_equals_jax_and_the_exact_path(case):
    make, (n, m, k, ds), block_n, cap_frac = ENCODE_CASES[case]
    cb, x = make(31, n, m, k, ds)
    got = pq_encode_verified(t(cb), t(x), cap_frac=cap_frac)
    assert got.dtype == torch.uint8 and tuple(got.shape) == (n, m)
    want = np.asarray(j_pq_encode_verified(
        j(cb), j(x), block_n=block_n, cap_frac=cap_frac, interpret=True))
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(got.numpy(), tprim.quantize_batch(t(cb), t(x)).numpy())
    np.testing.assert_array_equal(
        got.numpy(), np.asarray(jprim.quantize_batch(j(cb), j(x), dtype=jnp.uint8)))
    if case == "exact_ties":  # first index wins: the repeats are never chosen
        assert not np.isin(got.numpy(), (5, 7)).any()


@pytest.mark.parametrize("dtype", [torch.uint8, torch.int16, torch.int32, torch.int64])
def test_pq_encode_verified_code_dtypes(dtype):
    cb, x = make_pq_data(33, 200, 3, 300 if dtype != torch.uint8 else 200, 4)
    got = pq_encode_verified(t(cb), t(x), dtype=dtype)
    assert got.dtype == dtype
    np.testing.assert_array_equal(
        got.numpy(), tprim.quantize_batch(t(cb), t(x), dtype=dtype).numpy())


def test_pq_encode_verified_errors():
    cb, x = make_pq_data(34, 20, 2, 300, 4)
    with pytest.raises(OverflowError, match="k=300 exceeds uint8"):
        pq_encode_verified(t(cb), t(x))
    with pytest.raises(TypeError, match="integer type"):
        pq_encode_verified(t(cb), t(x), dtype=torch.float32)
    with pytest.raises(ValueError, match="Quantizer and vector length mismatch"):
        pq_encode_verified(t(cb), t(x[:, :7]), dtype=torch.int32)
    with pytest.raises(TypeError, match="float32 codebooks and vectors"):
        pq_encode_verified(t(cb), t(x).double(), dtype=torch.int32)


def test_verify_reference_second_best_counts_a_duplicate_of_the_best():
    # Row 0 sits on centroid 0, which centroid 2 repeats: margin 0, flagged,
    # first index chosen.  Row 1 is far from any tie.
    cb = np.array([[[0, 0, 0, 0], [10, 0, 0, 0], [0, 0, 0, 0]]], dtype=np.float32)
    x = np.array([[0, 0, 0, 0.5], [10, 0, 0, 0]], dtype=np.float32)
    codes, flags = pq_encode_verify_reference(t(cb), t(x), dtype=torch.int32)
    np.testing.assert_array_equal(codes.numpy(), [[0], [1]])
    np.testing.assert_array_equal(flags.numpy(), [1, 0])
    assert flags.dtype == torch.int32


def test_verify_reference_flags_a_row_when_any_subquantizer_is_close():
    cb, x = make_pq_data(35, 50, 3, 8, 4)
    # Subquantizer 1 of row 7: midway between centroid 2 and the one nearest to it.
    gap = ((cb[1] - cb[1, 2]) ** 2).sum(axis=1)
    gap[2] = np.inf
    x[7, 4:8] = 0.5 * (cb[1, 2] + cb[1, gap.argmin()])
    _, flags = pq_encode_verify_reference(t(cb), t(x))
    assert int(flags[7]) == 1
    # One centroid: no second best, margin +inf, nothing flagged.
    _, flags1 = pq_encode_verify_reference(t(cb[:, :1]), t(x))
    assert int(flags1.sum()) == 0


def test_verify_scale_is_the_docstrings_and_wider_scales_flag_more():
    cb, x = make_pq_data(36, 4000, 4, 16, 8)
    e = tassign.verify_scale(t(cb), route="fma")
    cn = np.sqrt((cb.astype(np.float64) ** 2).sum(axis=2)).max(axis=1)
    np.testing.assert_allclose(e.numpy(), 4 * 8 * 2.0 ** -24 * 2 * cn, rtol=1e-6)
    assert e.dtype == torch.float32 and tuple(e.shape) == (4,)
    rates = []
    for scale in (None, 2.0 ** -14, 2.0 ** -8):
        _, flags = pq_encode_verify_reference(
            t(cb), t(x), escale=tassign.verify_scale(t(cb), scale))
        rates.append(float(flags.float().mean()))
    assert rates[0] <= rates[1] < rates[2] and rates[0] < 0.01


@pytest.mark.parametrize("ds", [4, 8, 16, 32])
def test_verify_scale_of_the_split_product_is_the_docstrings_and_wider(ds):
    cb, x = make_pq_data(38, 4000, 3, 16, ds)
    cn = np.sqrt((cb.astype(np.float64) ** 2).sum(axis=2)).max(axis=1)
    steps = -(-ds // 8)  # tensor-core instructions of depth 8 in x_hi.w_hi
    formula = 2 * ((3.25 + 5 * steps) * 2.0 ** -22 + ds * 2.0 ** -24)
    e = tassign.verify_scale(t(cb), route="tf32x3")
    np.testing.assert_allclose(e.numpy(), formula * 2 * cn, rtol=1e-6)
    assert e.dtype == torch.float32 and tuple(e.shape) == (3,)
    fma = tassign.verify_scale(t(cb), route="fma")
    np.testing.assert_array_equal(e.numpy(), tassign.verify_scale(t(cb)).numpy())  # the default
    assert bool((e > fma).all()) and bool((e < 8 * fma).all())
    # An explicit scale wins over the route; an unknown route raises.
    np.testing.assert_array_equal(
        tassign.verify_scale(t(cb), 2.0 ** -14, route="tf32x3").numpy(),
        tassign.verify_scale(t(cb), 2.0 ** -14).numpy())
    with pytest.raises(ValueError, match="route"):
        tassign.verify_scale(t(cb), route="wgmma")
    # Both plain versions flag with the kernels' scale: more rows than the
    # f32 chain of FMAs would need, all of those among them.
    assert tstats.STATS_ROUTE == tassign.F32_ROUTE == "tf32x3"
    _, _, _, stats_flags = pq_assign_stats_verify_reference(t(cb), t(x))
    _, enc_flags = pq_encode_verify_reference(t(cb), t(x))
    _, fma_flags = pq_encode_verify_reference(t(cb), t(x), escale=fma)
    np.testing.assert_array_equal(stats_flags.numpy(), enc_flags.numpy())
    assert bool((stats_flags >= fma_flags).all()) and float(stats_flags.float().mean()) < 0.03


@pytest.mark.parametrize("make", [make_pq_data, _half_integer_grid, _duplicated, _adversarial],
                         ids=["gaussian", "half_integer_grid", "exact_ties", "adversarial"])
def test_the_encode_and_the_statistics_flag_alike_by_default(make):
    # One assignment routine in both f32 kernels, so one limit for both plain
    # versions: verify_scale(route="tf32x3"), the same rows flagged, the same codes.
    cb, x = make(39, 2000, 4, 16, 8)
    e = tassign.verify_scale(t(cb), route="tf32x3")
    _, _, s_codes, s_flags = pq_assign_stats_verify_reference(t(cb), t(x))
    e_codes, e_flags = pq_encode_verify_reference(t(cb), t(x), dtype=torch.int32)
    np.testing.assert_array_equal(e_codes.numpy(), s_codes.numpy())
    np.testing.assert_array_equal(e_flags.numpy(), s_flags.numpy())
    for got in (pq_encode_verify_reference(t(cb), t(x), dtype=torch.int32, escale=e),
                tassign.pq_encode_verify_flags(t(cb), t(x), dtype=torch.int32),
                tstats.pq_assign_stats_verify_reference(t(cb), t(x), escale=e)[2:],
                tstats.pq_assign_stats_verify_flags(t(cb), t(x))[2:]):
        np.testing.assert_array_equal(got[0].numpy(), e_codes.numpy())
        np.testing.assert_array_equal(got[1].numpy(), e_flags.numpy())
    assert int(e_flags.sum()) > 0 or make is make_pq_data  # the ties are flagged


def test_flagged_rows_and_the_cap():
    flags = torch.tensor([0, 1, 0, 1, 1, 0, 0, 0], dtype=torch.int32)
    np.testing.assert_array_equal(tassign.flagged_rows(flags, 0.5).numpy(), [1, 3, 4])
    assert tassign.flagged_rows(flags, 0.25) is None  # 3 of 8 are more than a quarter
    assert tassign.flagged_rows(torch.zeros(8, dtype=torch.int32), 1e-9).numel() == 0


def test_encode_wrapper_corrects_what_the_first_stage_got_wrong(monkeypatch):
    # A first stage whose flagged rows all carry wrong codes, as a kernel
    # that rounds otherwise might: the wrapper's result is the exact path's.
    cb, x = make_pq_data(37, 300, 3, 8, 4)
    oracle = tprim.quantize_batch(t(cb), t(x), dtype=torch.int32)
    flags = (torch.arange(300) % 7 == 0).to(torch.int32)

    def first_stage(codebooks, rows, *, dtype, **kwargs):
        wrong = torch.where(flags[:, None] == 1, (oracle + 1) % 8, oracle)
        return wrong.to(dtype), flags.clone()

    monkeypatch.setattr(tassign, "pq_encode_verify_flags", first_stage)
    for cap_frac in (1 / 2, 1e-9):  # gather-and-rewrite, then everything by the exact path
        got = pq_encode_verified(t(cb), t(x), dtype=torch.int32, cap_frac=cap_frac)
        np.testing.assert_array_equal(got.numpy(), oracle.numpy())


# -- the bound behind the flags ----------------------------------------------------


@pytest.mark.parametrize("route", ["fma", "tf32x3"])
@pytest.mark.parametrize("seed", range(6))
@pytest.mark.parametrize("ds", [4, 8, 32])
def test_every_row_whose_argmin_a_rounding_could_change_is_flagged(ds, seed, route):
    """Soundness of the flag limit against its own derivation: move every
    distance by up to what the kernel's and the exact path's evaluations may
    differ by (``B_k + B`` from the products, plus ``2^-23 |d|`` from the two
    rounded subtractions), in f64, and take the argmin again.  ``B = g max|2c|
    |x|``, ``g = ds u / (1 - ds u)``, is any f32 summation order; ``B_k`` is
    ``B`` too for a chain of FMAs (``"fma"``) and ``(3.25 + 5 ceil(ds/8)) 2^-22
    max|2c| |x|`` for the split product on the tensor cores (``"tf32x3"``).
    Wherever the argmin changes, the row must have been flagged; with a
    quarter of the scale some such row is not.  The rows sit near midpoints of
    centroid pairs at distances that straddle the limit, beside zero rows,
    tiny rows and exact ties."""
    rng = np.random.default_rng(100 * ds + seed)
    m, k, n = 3, 12, 4000
    cb = rng.standard_normal((m, k, ds)).astype(np.float32)
    cb[:, k - 1] = cb[:, 1]
    pick = rng.integers(0, k, (n, m))
    mid = 0.5 * (cb[np.arange(m)[None], pick] + cb[np.arange(m)[None], (pick + 1) % k])
    offset = rng.standard_normal((n, m, ds)) * 10.0 ** rng.uniform(-9, -1, (n, 1, 1))
    x = (mid + offset).astype(np.float32)
    x[:200] = 0.0
    x[200:400] *= 1e-6
    x[400:600] = cb[:, 1][None]
    x = x.reshape(n, m * ds)

    tcb, tx = t(cb), t(x)
    cb2, c_sqn = tassign._prepare(tcb, tx, torch.int32, torch.float32)
    xs = tx.reshape(n, m, ds)
    dist = c_sqn[None] - torch.einsum("nmd,mkd->nmk", xs, cb2)
    escale = tassign.verify_scale(tcb, route=route)
    codes, flagged = tassign._verify_flags(dist, xs, escale, tassign.VERIFY_RHO)

    u = 2.0 ** -24
    g = ds * u / (1 - ds * u)
    g_kernel = g if route == "fma" else (3.25 + 5 * -(-ds // 8)) * 2.0 ** -22
    wmax = np.sqrt((cb2.double().numpy() ** 2).sum(axis=2)).max(axis=1)       # (m,)
    xn = np.sqrt((xs.double().numpy() ** 2).sum(axis=2))                     # (n, m)
    d64 = dist.double().numpy()
    room = (g_kernel + g) * wmax[None, :, None] * xn[:, :, None] + 2.0 ** -23 * np.abs(d64)
    changed_any = np.zeros((n, m), dtype=bool)
    for trial in range(4):
        # The worst case for a tie: the chosen one up, the others down; then random signs.
        sign = -np.ones_like(d64) if trial == 0 else rng.choice([-1.0, 1.0], d64.shape)
        if trial == 0:
            np.put_along_axis(sign, codes.numpy()[:, :, None], 1.0, axis=2)
        moved = d64 + sign * room * (1.0 if trial < 2 else rng.random(d64.shape))
        changed_any |= moved.argmin(axis=2) != codes.numpy()
    assert changed_any.any(), "the data reaches no near-tie: the property tests nothing"
    assert not (changed_any & ~flagged.numpy()).any()
    # The limit has less than a factor of four to spare: at a quarter of the
    # scale a row whose argmin can change goes unflagged.
    _, too_few = tassign._verify_flags(dist, xs, escale / 4, tassign.VERIFY_RHO)
    assert (changed_any & ~too_few.numpy()).any()
    # And the flags are not vacuous: far from its midpoint a row stays unflagged
    # (unless it chose the repeated centroid: an exact tie with its twin).
    far = (np.abs(offset).min(axis=2) > 1e-3) & (np.arange(n) >= 600)[:, None]
    far &= codes.numpy() != 1
    assert far.sum() > 100 and flagged.numpy()[far].mean() < 0.05


# -- the statistics -----------------------------------------------------------------

# The shapes of the JAX package's own verified-statistics tests.
STATS_CASES = {
    "gaussian": (make_pq_data, (3000, 4, 16, 4)),
    "exact_ties": (_duplicated, (640, 2, 8, 4)),
    "half_integer_grid": (_half_integer_grid, (1500, 2, 8, 4)),
    "wide_codebook": (make_pq_data, (700, 2, 300, 4)),
}


@pytest.mark.parametrize("cap_frac", [1 / 16, 1e-9])
@pytest.mark.parametrize("case", list(STATS_CASES))
def test_pq_assign_stats_verified_equals_jax_and_the_exact_path(case, cap_frac):
    make, (n, m, k, ds) = STATS_CASES[case]
    cb, x = make(41, n, m, k, ds)
    sums, counts = pq_assign_stats_verified(t(cb), t(x), cap_frac=cap_frac)
    assert sums.dtype == counts.dtype == torch.float32
    assert tuple(sums.shape) == (m, k, ds) and tuple(counts.shape) == (m, k)
    _, osums, ocounts = _oracle_stats(cb, x)
    np.testing.assert_array_equal(counts.numpy(), ocounts)
    np.testing.assert_allclose(sums.numpy(), osums, rtol=1e-5, atol=1e-5)
    jsums, jcounts = j_pq_assign_stats_verified(j(cb), j(x), cap_frac=cap_frac, interpret=True)
    np.testing.assert_array_equal(counts.numpy(), np.asarray(jcounts))
    np.testing.assert_allclose(sums.numpy(), np.asarray(jsums), rtol=1e-5, atol=1e-5)
    if case == "exact_ties":  # the repeats' cells stay empty
        assert float(counts[:, 5].sum()) == 0 and float(counts[:, 7].sum()) == 0


def test_exact_stats_chunked_matches_jax_on_ragged_chunks():
    cb, x = make_pq_data(45, 777, 3, 9, 2)
    sums, counts = tstats.exact_stats_chunked(t(cb), t(x), chunk=256)
    _, osums, ocounts = _oracle_stats(cb, x)
    np.testing.assert_array_equal(counts.numpy(), ocounts)
    np.testing.assert_allclose(sums.numpy(), osums, rtol=1e-5, atol=1e-5)
    jsums, jcounts = j_einsum_stats_chunked(j(cb), j(x), chunk=256)
    np.testing.assert_array_equal(counts.numpy(), np.asarray(jcounts))
    np.testing.assert_allclose(sums.numpy(), np.asarray(jsums), rtol=1e-5, atol=1e-5)


def test_stats_verify_reference_returns_the_encodes_codes_and_flags():
    cb, x = _half_integer_grid(46, 500, 2, 8, 4)
    sums, counts, codes, flags = pq_assign_stats_verify_reference(t(cb), t(x))
    want_codes, want_flags = pq_encode_verify_reference(t(cb), t(x), dtype=torch.int32)
    assert codes.dtype == flags.dtype == torch.int32
    np.testing.assert_array_equal(codes.numpy(), want_codes.numpy())
    np.testing.assert_array_equal(flags.numpy(), want_flags.numpy())
    assert 0 < int(flags.sum()) < 500
    s2, c2 = tstats.stats_from_codes(codes, t(x), 8)
    np.testing.assert_array_equal(sums.numpy(), s2.numpy())
    np.testing.assert_array_equal(counts.numpy(), c2.numpy())
    assert float(counts.sum()) == 500 * 2


def test_stats_verified_casts_other_dtypes_to_f32():
    cb, x = make_pq_data(47, 300, 2, 8, 4)
    want = pq_assign_stats_verified(t(cb), t(x))
    got = pq_assign_stats_verified(t(cb), t(x).double())
    np.testing.assert_array_equal(got[1].numpy(), want[1].numpy())
    np.testing.assert_array_equal(got[0].numpy(), want[0].numpy())


@pytest.mark.parametrize("n_wrong", [1, 40, 200])
def test_move_between_cells_repairs_statistics_of_wrong_codes(n_wrong):
    # Statistics taken under deliberately wrong "old" codes, then moved to the
    # right ones: counts equal, sums to f32 accumulation order.
    n, m, k, ds = 200, 3, 8, 4
    cb, x = make_pq_data(48, n, m, k, ds)
    right = tprim.quantize_batch(t(cb), t(x), dtype=torch.int32)
    rng = np.random.default_rng(n_wrong)
    rows = np.sort(rng.choice(n, n_wrong, replace=False))
    old = right.clone()
    shift = torch.from_numpy(rng.integers(0, k, (n_wrong, m)).astype(np.int32))  # 0: unchanged
    old[rows] = (old[rows] + shift) % k
    sums, counts = tstats.stats_from_codes(old, t(x), k)
    idx = torch.from_numpy(rows)
    got_sums, got_counts = tstats.move_between_cells(
        sums, counts, t(x)[idx], old[idx], right[idx])
    assert got_sums is sums and got_counts is counts  # in place
    want_sums, want_counts = tstats.stats_from_codes(right, t(x), k)
    np.testing.assert_array_equal(counts.numpy(), want_counts.numpy())
    np.testing.assert_allclose(sums.numpy(), want_sums.numpy(), rtol=1e-5, atol=1e-5)


def test_stats_wrapper_corrects_what_the_first_stage_got_wrong(monkeypatch):
    # A first stage whose flagged rows sit in wrong cells: the wrapper
    # re-encodes them by the exact path and moves them.
    n, m, k, ds = 400, 2, 8, 4
    cb, x = make_pq_data(49, n, m, k, ds)
    oracle, osums, ocounts = _oracle_stats(cb, x)
    flags = (torch.arange(n) % 5 == 0).to(torch.int32)
    wrong = torch.where(flags[:, None] == 1, (t(oracle) + 3) % k, t(oracle)).to(torch.int32)

    def first_stage(codebooks, rows, **kwargs):
        sums, counts = tstats.stats_from_codes(wrong, rows, k)
        return sums, counts, wrong.clone(), flags.clone()

    monkeypatch.setattr(tstats, "pq_assign_stats_verify_flags", first_stage)
    for cap_frac in (1 / 2, 1e-9):
        sums, counts = pq_assign_stats_verified(t(cb), t(x), cap_frac=cap_frac)
        np.testing.assert_array_equal(counts.numpy(), ocounts)
        np.testing.assert_allclose(sums.numpy(), osums, rtol=1e-5, atol=1e-5)


def test_verified_wrappers_take_any_subvector_length_on_the_cpu():
    # ds = 5 is no width of the CUDA kernels; CPU tensors take the plain version.
    cb, x = make_pq_data(50, 257, 2, 3, 5)
    codes = pq_encode_verified(t(cb), t(x))
    np.testing.assert_array_equal(codes.numpy(), tprim.quantize_batch(t(cb), t(x)).numpy())
    _, osums, ocounts = _oracle_stats(cb, x)
    sums, counts = pq_assign_stats_verified(t(cb), t(x))
    np.testing.assert_array_equal(counts.numpy(), ocounts)
    np.testing.assert_allclose(sums.numpy(), osums, rtol=1e-5, atol=1e-5)
