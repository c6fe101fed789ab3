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
    # Most of these rows are flagged.  At these n the cap (a whole chunk, cut
    # to n) takes every flagged row at any cap_frac, in the JAX package and
    # here: both gather and re-encode them (the exact path above the second
    # tier: test_the_wrappers_follow_the_tiers).
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


def _reference_caps(n, cap_frac, chunk):
    """The JAX package's tiers, as written there
    (reductive_tpu/ops/assign.py:465-471, reductive_tpu/ops/stats.py:495-497)."""
    cap = min(max(chunk, -(-int(n * cap_frac) // chunk) * chunk), n)
    cap2 = min(4 * cap, n)
    return cap, cap2


@pytest.mark.parametrize("cap_frac", [1e-9, 1 / 64, 1 / 16, 0.0629, 0.25, 1.0])
@pytest.mark.parametrize("n", [0, 1, 8, 255, 256, 300, 16383, 16384, 16385, 32768, 65536,
                               65537, 262144, 524288, 1_000_000, 4_000_000])
def test_verify_caps_are_the_references(n, cap_frac):
    for chunk in (tassign.VERIFY_ENCODE_CHUNK, min(16384, max(256, n))):
        cap, cap2 = tassign.verify_caps(n, cap_frac, chunk)
        assert (cap, cap2) == _reference_caps(n, cap_frac, chunk)
        assert cap <= cap2 <= n and (cap == n or cap % chunk == 0)
    assert tassign.VERIFY_ENCODE_CHUNK == 16384


def test_flagged_rows_and_the_cap():
    # The reference's tiers: at n = 8 the cap is a whole chunk, cut to n, so
    # every flag count gathers; nothing falls to the exact path.
    flags = torch.tensor([0, 1, 0, 1, 1, 0, 0, 0], dtype=torch.int32)
    tassign.reset_verify_tiers()
    np.testing.assert_array_equal(tassign.flagged_rows(flags, 0.5, 256, "stats").numpy(), [1, 3, 4])
    np.testing.assert_array_equal(tassign.flagged_rows(flags, 0.25, 256, "stats").numpy(), [1, 3, 4])
    np.testing.assert_array_equal(
        tassign.flagged_rows(torch.ones(8, dtype=torch.int32), 1e-9, 16384, "encode").numpy(),
        np.arange(8))
    assert tassign.flagged_rows(torch.zeros(8, dtype=torch.int32), 1e-9, 16384, "encode").numel() == 0
    assert tassign.verify_tiers() == {("stats", "cap"): 2, ("encode", "cap"): 2}
    tassign.reset_verify_tiers()
    assert tassign.verify_tiers() == {}


@pytest.mark.parametrize("n,cap_frac,chunk", [(100_000, 1 / 16, 16384), (70_000, 1e-9, 16384),
                                              (2000, 0.01, 256), (200_000, 0.1, 16384)])
def test_flagged_rows_at_the_tiers_edges(n, cap_frac, chunk):
    cap, cap2 = tassign.verify_caps(n, cap_frac, chunk)
    assert cap < cap2 < n  # both tiers exist at these shapes
    rng = np.random.default_rng(n)
    tassign.reset_verify_tiers()
    for count, tier in ((cap, "cap"), (cap + 1, "cap2"), (cap2, "cap2"), (cap2 + 1, "exact")):
        rows = np.sort(rng.choice(n, count, replace=False))
        flags = torch.zeros(n, dtype=torch.int32)
        flags[torch.from_numpy(rows)] = 1
        got = tassign.flagged_rows(flags, cap_frac, chunk, "encode")
        if tier == "exact":
            assert got is None
        else:
            np.testing.assert_array_equal(got.numpy(), rows)
        assert tassign.verify_tiers()[("encode", tier)] >= 1
    assert tassign.verify_tiers() == {("encode", "cap"): 1, ("encode", "cap2"): 2,
                                      ("encode", "exact"): 1}


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
    # At 300 rows the cap is the whole batch: both gather and rewrite the
    # flagged rows (above the second tier: test_the_wrappers_follow_the_tiers).
    for cap_frac in (1 / 2, 1e-9):
        got = pq_encode_verified(t(cb), t(x), dtype=torch.int32, cap_frac=cap_frac)
        np.testing.assert_array_equal(got.numpy(), oracle.numpy())


def _flags_of_count(n, count, seed):
    rows = np.sort(np.random.default_rng(seed).choice(n, count, replace=False))
    flags = torch.zeros(n, dtype=torch.int32)
    flags[torch.from_numpy(rows)] = 1
    return flags


@pytest.mark.parametrize("tier", ["cap", "cap2", "exact"])
def test_the_wrappers_follow_the_tiers(monkeypatch, tier):
    """Rows flagged beyond ``cap_frac * n`` but within ``cap2`` are the only
    ones given to the exact path; beyond ``cap2`` the whole batch is.  The
    first stage (monkeypatched) carries wrong codes on every flagged row, so
    the result is the oracle's only if the right rows were recomputed."""
    n, m, k, ds = 70_000, 3, 8, 2
    cb, x = make_pq_data(51, n, m, k, ds)
    oracle, osums, ocounts = _oracle_stats(cb, x)
    oracle = t(oracle)
    cap_frac = 1 / 16  # cap_frac * n = 4,375; cap 16,384, cap2 65,536 for both wrappers
    cap, cap2 = tassign.verify_caps(n, cap_frac, 16384)
    assert (cap, cap2) == (16384, 65536) and tassign.verify_caps(n, cap_frac, 16384) == \
        _reference_caps(n, cap_frac, min(16384, max(256, n)))
    count = {"cap": 4376, "cap2": cap2, "exact": cap2 + 1}[tier]
    flags = _flags_of_count(n, count, 52)
    wrong = torch.where(flags[:, None] == 1, (oracle + 1) % k, oracle).to(torch.int32)
    seen = []

    def exact_path(codebooks, rows, dtype=torch.uint8, batch=None):
        # The flagged rows are coded as the whole batch codes them.
        assert batch == n or (batch is None and rows.shape[0] == n)
        seen.append(rows.shape[0])
        return tprim.quantize_batch(codebooks, rows, dtype=dtype, batch=batch)

    monkeypatch.setattr(tassign, "pq_encode_verify_flags",
                        lambda codebooks, rows, *, dtype, **kw: (wrong.to(dtype), flags.clone()))
    monkeypatch.setattr(tassign, "quantize_batch", exact_path)
    tassign.reset_verify_tiers()
    got = pq_encode_verified(t(cb), t(x), dtype=torch.int32, cap_frac=cap_frac)
    np.testing.assert_array_equal(got.numpy(), oracle.numpy())
    assert seen == [n if tier == "exact" else count]
    assert tassign.verify_tiers() == {("encode", tier): 1}

    seen.clear()
    monkeypatch.setattr(tstats, "pq_assign_stats_verify_flags", lambda codebooks, rows, **kw: (
        *tstats.stats_from_codes(wrong, rows, k), wrong.clone(), flags.clone()))
    monkeypatch.setattr(tstats, "quantize_batch", exact_path)
    monkeypatch.setattr(tstats, "exact_stats_chunked", _recording(tstats.exact_stats_chunked, seen))
    sums, counts = pq_assign_stats_verified(t(cb), t(x), cap_frac=cap_frac)
    np.testing.assert_array_equal(counts.numpy(), ocounts)
    np.testing.assert_allclose(sums.numpy(), osums, rtol=1e-5, atol=1e-5)
    if tier == "exact":  # the whole pass, which walks the batch in chunks
        assert seen[0] == ("whole pass", n) and sum(seen[1:]) == n
    else:
        assert seen == [count]
    assert tassign.verify_tiers() == {("encode", tier): 1, ("stats", tier): 1}


@pytest.mark.parametrize("n,batch,min_rows", [(1000, None, 2048), (1000, 5000, 2048),
                                              (300, 5000, 2048), (37, 37, 2048),
                                              (1000, None, 16), (300, 1000, 16)])
def test_the_exact_path_takes_every_row_in_a_product_of_one_shape(monkeypatch, n, batch, min_rows):
    """``nearest_centroids`` walks the rows in chunks of ``min(batch, s,
    max(min_rows, batch / 16))`` rows (``s`` the rows within ``_DIST_ELEMS``),
    the last one padded: every row's products are taken at one shape,
    whatever the batch, so that a subset coded with its batch's size gets the
    whole batch's codes even where the product's rounding depends on its
    shape (on the card, at a wide ds)."""
    m, k, ds = 2, 16, 3
    cb, x = make_pq_data(53, max(n, batch or 0), m, k, ds)
    monkeypatch.setattr(tprim, "_DIST_ELEMS", 128 * m * k)  # s = 128 rows
    monkeypatch.setattr(tprim, "_MIN_CHUNK_ROWS", min_rows)
    shapes = []
    einsum = torch.einsum

    def recording(eq, a, b):
        shapes.append(tuple(a.shape))
        return einsum(eq, a, b)

    monkeypatch.setattr(torch, "einsum", recording)
    got = tprim.quantize_batch(t(cb), t(x[:n]), dtype=torch.int32, batch=batch)
    monkeypatch.setattr(torch, "einsum", einsum)
    b = n if batch is None else batch
    rows = min(b, 128, max(min_rows, -(-b // 16)))
    assert shapes[1:] and set(shapes[1:]) == {(rows, m, ds)}  # shapes[0]: the norms
    assert len(shapes) - 1 == -(-n // rows)
    monkeypatch.undo()
    np.testing.assert_array_equal(
        got.numpy(), tprim.quantize_batch(t(cb), t(x), dtype=torch.int32).numpy()[:n])


def _recording(fn, seen):
    def wrapped(codebooks, rows, *args, **kwargs):
        seen.append(("whole pass", rows.shape[0]))
        return fn(codebooks, rows, *args, **kwargs)
    return wrapped


# -- the bound behind the flags ----------------------------------------------------


def _perturbed(ds, seed, route, g_kernel):
    """The rows of the soundness tests and what perturbing their distances
    within the two routes' difference does: ``(changed_any, flagged,
    too_few, offset, codes)``, ``too_few`` the flags at a quarter of the
    scale.  The rows sit near midpoints of centroid pairs at distances that
    straddle the limit, beside zero rows, tiny rows and exact ties."""
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
    _, too_few = tassign._verify_flags(dist, xs, escale / 4, tassign.VERIFY_RHO)
    return changed_any, flagged.numpy(), too_few.numpy(), offset, codes.numpy()


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
    u = 2.0 ** -24
    g = ds * u / (1 - ds * u)
    g_kernel = g if route == "fma" else (3.25 + 5 * -(-ds // 8)) * 2.0 ** -22
    changed_any, flagged, too_few, offset, codes = _perturbed(ds, seed, route, g_kernel)
    n = flagged.shape[0]
    assert changed_any.any(), "the data reaches no near-tie: the property tests nothing"
    assert not (changed_any & ~flagged).any()
    # The limit has less than a factor of four to spare: at a quarter of the
    # scale a row whose argmin can change goes unflagged.
    assert (changed_any & ~too_few).any()
    # And the flags are not vacuous: far from its midpoint a row stays unflagged
    # (unless it chose the repeated centroid: an exact tie with its twin).
    far = (np.abs(offset).min(axis=2) > 1e-3) & (np.arange(n) >= 600)[:, None]
    far &= codes != 1
    assert far.sum() > 100 and flagged[far].mean() < 0.05


@pytest.mark.parametrize("seed", range(3))
@pytest.mark.parametrize("ds", [1, 2, 3, 12, 20, 24, 48, 128])
def test_every_row_the_wide_route_could_change_is_flagged(ds, seed):
    """The same soundness at the odd and wide widths, for the wide route's
    evaluation (``"tf32x3_wide"``): ``B_w = (3.5 + (5 + 2^-6) kc + 0.26
    chunks) 2^-22 max|2c| |x|`` for the kernel's chunks of ``kc``
    instructions; at ds = 20 and 24, where the narrow kernels' padded
    instance takes a fourth step of zeros (``"tf32x3_pad"``), the larger of
    that and the narrow route's ``(3.25 + 5 * 4) 2^-22``.  At ds = 128 the
    limit is wide enough that rows 1e-3 from a midpoint are flagged too, so
    the flags are held not to be vacuous by the rows no perturbation can
    change."""
    kc, chunks = tassign.wide_chunking(ds)
    g_kernel = (3.5 + (5 + 2.0 ** -6) * kc + 0.26 * chunks) * 2.0 ** -22
    route = tassign.f32_route(ds)
    assert route == ("tf32x3_pad" if ds in (20, 24) else "tf32x3_wide")
    if route == "tf32x3_pad":
        g_kernel = max(g_kernel, (3.25 + 5 * 4) * 2.0 ** -22)
    changed_any, flagged, too_few, _, _ = _perturbed(ds, seed, route, g_kernel)
    assert changed_any.any(), "the data reaches no near-tie: the property tests nothing"
    assert not (changed_any & ~flagged).any()
    assert (changed_any & ~too_few).any()
    stable = ~changed_any
    stable[:600] = False  # zero rows, tiny rows and exact ties
    assert stable.sum() > 100 and flagged[stable].mean() < 0.5


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
