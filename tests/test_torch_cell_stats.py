"""The wide route's accumulation from the codes (``ops.stats.cell_stats``), on
the CPU.

On the card the wide statistics sort each subquantizer's rows by code, cut
each cell's rows into chunks of ``cell_chunk_rows(ds)`` sorted rows, add
each chunk's rows in row order and then each cell's chunks in order
(``csrc/stats.cu``, ``cells``); the kernels equal their plain version,
``cell_stats_reference``, bit for bit (``tests/test_torch_cuda_kernels.py``,
``chip_smoke.py``).  Here: the chunk layout against its definition at every
edge, the plain version against a float32 transcription of that order (bit
for bit), against a float64 oracle (counts exact, sums within the
recursive-summation bound ``count * 2^-24 * sum|x|``) and against
``stats_from_codes`` (rtol 1e-5, atol 1e-4 of the largest sum), on random
codes, every row in one cell, half the cells empty and k = 1; and the wide
statistics through the plain route against the JAX package's Pallas kernel
in interpreter mode at ds 36 and 50 and on skewed rows.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from reductive_tpu.ops import pq_encode as j_pq_encode
from reductive_tpu.ops.stats import pq_assign_stats as j_pq_assign_stats
from reductive_tpu_torch.ops import pq_assign_stats, pq_encode_reference
from reductive_tpu_torch.ops import stats as tstats

from torch_port_util import j, make_pq_data, near_tie_rows, t


@pytest.mark.parametrize("ds", [1, 3, 32, 33, 36, 50, 64, 75, 100, 128, 150, 300, 768, 20000])
def test_cell_chunk_rows_is_a_power_of_two_within_its_range(ds):
    r = tstats.cell_chunk_rows(ds)
    assert r & (r - 1) == 0 and 32 <= r <= 256
    # the largest power of two with r * ds <= 16384, within [32, 256]
    assert r == 256 or r == 32 or r * ds <= 16384 < 2 * r * ds
    assert {50: 256, 75: 128, 150: 64, 128: 128, 768: 32}.get(ds, r) == r


R = 32
CHUNK_CASES = {
    "empty_cell": [0],
    "r_minus_1": [R - 1],
    "r": [R],
    "r_plus_1": [R + 1],
    "every_row_in_one_cell": [0, 0, 5 * R + 3, 0],
    "k_1": [3 * R],
    "an_empty_subquantizer_segment": [2, 0, 1, 0, 0, 0, 0, R + 7, 0],  # m = 3, k = 3
    "mixed_edges": [R - 1, R, R + 1, 0, 2 * R, 1, 0],
    "no_rows": [0, 0, 0],
}


@pytest.mark.parametrize("counts", CHUNK_CASES.values(), ids=CHUNK_CASES.keys())
def test_cell_chunks_cover_every_sorted_row_once_in_order(counts):
    counts = torch.tensor(counts, dtype=torch.int64)
    chunk_start, cell, first, length = tstats.cell_chunks(counts, R)
    total = int(counts.sum())
    # the chunks, in order, are the sorted rows 0 .. total-1 once each
    covered = [p for f, n in zip(first.tolist(), length.tolist()) for p in range(f, f + n)]
    assert covered == list(range(total))
    assert bool((length >= 1).all()) and bool((length <= R).all())
    # each cell's chunks: ceil(count / R) of them, all full but its last
    assert chunk_start[0] == 0 and int(chunk_start[-1]) == cell.shape[0]
    ends = torch.cumsum(counts, 0)
    for c, n in enumerate(counts.tolist()):
        q0, q1 = int(chunk_start[c]), int(chunk_start[c + 1])
        assert q1 - q0 == -(-n // R)
        assert bool((cell[q0:q1] == c).all())
        assert int(length[q0:q1].sum()) == n
        if n:
            assert int(first[q0]) == int(ends[c]) - n and bool((length[q0:q1 - 1] == R).all())


def _codes(kind, n, m, k, seed):
    rng = np.random.default_rng(seed)
    if kind == "one_cell":
        return np.full((n, m), k // 2, dtype=np.int64)
    codes = rng.integers(0, k, (n, m))
    return codes - codes % 2 if kind == "half_empty" else codes


def _round_bf16(x):
    """Round-to-nearest-even to bfloat16, on the bits (finite inputs)."""
    u = x.astype(np.float32).view(np.uint32).astype(np.uint64)
    u = (u + 0x7FFF + ((u >> 16) & 1)) & 0xFFFF0000
    return u.astype(np.uint32).view(np.float32)


def _in_order(codes, x, k, round_bf16):
    """The kernels' order of addition, in float32 numpy: per cell its rows in
    row order, cut into chunks of cell_chunk_rows(ds); each chunk summed
    from zero, then the chunks from zero."""
    n, m = codes.shape
    ds = x.shape[1] // m
    r = tstats.cell_chunk_rows(ds)
    xs = (_round_bf16(x) if round_bf16 else x).reshape(n, m, ds)
    sums = np.zeros((m, k, ds), dtype=np.float32)
    counts = np.zeros((m, k), dtype=np.float32)
    for jq in range(m):
        for c in range(k):
            rows = np.flatnonzero(codes[:, jq] == c)
            counts[jq, c] = len(rows)
            total = np.zeros(ds, dtype=np.float32)
            for s in range(0, len(rows), r):
                part = np.zeros(ds, dtype=np.float32)
                for i in rows[s:s + r]:
                    part = part + xs[i, jq]
                total = total + part
            sums[jq, c] = total
    return sums, counts


SHAPES = [(300, 3, 7, 50), (700, 2, 5, 75), (200, 1, 1, 150), (513, 4, 30, 36), (1000, 1, 3, 2)]


@pytest.mark.parametrize("round_bf16", [False, True], ids=["f32", "bf16"])
@pytest.mark.parametrize("kind", ["random", "one_cell", "half_empty"])
@pytest.mark.parametrize("n,m,k,ds", SHAPES)
def test_the_plain_version_adds_in_the_kernels_order(n, m, k, ds, kind, round_bf16):
    codes = _codes(kind, n, m, k, seed=ds)
    _, x = make_pq_data(100 + ds, n, m, 1, ds)
    sums, counts = tstats.cell_stats_reference(t(codes), t(x), k, round_bf16=round_bf16)
    want_sums, want_counts = _in_order(codes, x, k, round_bf16)
    np.testing.assert_array_equal(sums.numpy().view(np.uint32), want_sums.view(np.uint32))
    np.testing.assert_array_equal(counts.numpy(), want_counts)


@pytest.mark.parametrize("round_bf16", [False, True], ids=["f32", "bf16"])
@pytest.mark.parametrize("kind", ["random", "one_cell", "half_empty"])
@pytest.mark.parametrize("n,m,k,ds", SHAPES + [(3000, 2, 4, 40)])
def test_the_plain_version_against_a_float64_oracle(n, m, k, ds, kind, round_bf16):
    codes = _codes(kind, n, m, k, seed=ds + 1)
    _, x = make_pq_data(110 + ds, n, m, 1, ds)
    sums, counts = tstats.cell_stats_reference(t(codes), t(x), k, round_bf16=round_bf16)
    xs = (_round_bf16(x) if round_bf16 else x).reshape(n, m, ds).astype(np.float64)
    want = np.zeros((m, k, ds))
    absum = np.zeros((m, k, ds))
    want_counts = np.zeros((m, k))
    for jq in range(m):
        np.add.at(want[jq], codes[:, jq], xs[:, jq])
        np.add.at(absum[jq], codes[:, jq], np.abs(xs[:, jq]))
        want_counts[jq] = np.bincount(codes[:, jq], minlength=k)
    np.testing.assert_array_equal(counts.numpy(), want_counts)  # exact integers
    # f32 recursive summation of `count` terms: within count * 2^-24 * sum|x|.
    bound = 1.01 * want_counts[:, :, None] * 2.0 ** -24 * absum
    assert np.all(np.abs(sums.numpy().astype(np.float64) - want) <= bound)
    empty = want_counts == 0
    assert not np.any(sums.numpy()[empty])  # an empty cell: a zero sum
    if kind == "one_cell":
        assert np.all(counts.numpy()[:, k // 2] == n)


@pytest.mark.parametrize("kind", ["random", "one_cell", "half_empty"])
@pytest.mark.parametrize("n,m,k,ds", SHAPES)
def test_the_plain_version_against_stats_from_codes(n, m, k, ds, kind):
    codes = t(_codes(kind, n, m, k, seed=ds + 2))
    _, x = make_pq_data(120 + ds, n, m, 1, ds)
    sums, counts = tstats.cell_stats_reference(codes, t(x), k)
    want_sums, want_counts = tstats.stats_from_codes(codes, t(x), k)
    assert torch.equal(counts, want_counts)
    # the one-hot product adds in another order: rtol 1e-5, atol 1e-4 of the largest
    tol = 1e-5 * want_sums.abs() + 1e-4 * float(want_sums.abs().max())
    assert bool(((sums - want_sums).abs() <= tol).all())


def test_cell_stats_takes_the_plain_version_on_the_cpu():
    n, m, k, ds = 400, 3, 9, 50
    codes = t(_codes("random", n, m, k, seed=5))
    _, x = make_pq_data(130, n, m, 1, ds)
    want = tstats.cell_stats_reference(codes, t(x), k, round_bf16=True)
    # codes as the transposed view of an (m, n) tensor, as the verify kernel writes them
    got = tstats.cell_stats(codes.T.contiguous().T, t(x), k, round_bf16=True)
    assert all(torch.equal(a, b) for a, b in zip(got, want))


def _skewed(cb, x, k):
    """Every row within 1e-3 of centroid k // 2 in every subquantizer."""
    m, _, ds = cb.shape
    return (cb[:, k // 2].reshape(1, m * ds) + 1e-3 * x).astype(np.float32)


@pytest.mark.parametrize("skewed", [False, True], ids=["gaussian", "skewed"])
@pytest.mark.parametrize("n,m,k,ds", [(257, 2, 16, 36), (300, 3, 16, 50)])
def test_the_wide_statistics_through_the_plain_route_match_jax(n, m, k, ds, skewed):
    cb, x = make_pq_data(140 + ds, n, m, k, ds)
    if skewed:
        x = _skewed(cb, x, k)
    jsums, jcounts = map(np.asarray, j_pq_assign_stats(j(cb), j(x), compute_dtype=jnp.float32,
                                                       interpret=True))
    want_codes = np.asarray(j_pq_encode(j(cb), j(x), dtype=jnp.int32, compute_dtype=jnp.float32,
                                        interpret=True))
    got_codes = pq_encode_reference(t(cb), t(x), dtype=torch.int32,
                                    compute_dtype=torch.float32).numpy()
    differ = near_tie_rows(cb, x, got_codes, want_codes, 2.0 ** -13)
    assert len(differ) <= (0 if skewed else max(1, n // 100))
    # The plain route of pq_assign_stats and the accumulation of the plain
    # codes, the near-tie rows taken out of both sides.
    for sums, counts in (pq_assign_stats(t(cb), t(x)),
                         tstats.cell_stats_reference(t(got_codes), t(x), k)):
        gs, gc = sums.numpy().astype(np.float64), counts.numpy().copy()
        ws, wc = jsums.astype(np.float64), jcounts.copy()
        xs = x.reshape(n, m, ds).astype(np.float64)
        for i in differ:
            for jq in range(m):
                gs[jq, got_codes[i, jq]] -= xs[i, jq]
                ws[jq, want_codes[i, jq]] -= xs[i, jq]
                gc[jq, got_codes[i, jq]] -= 1
                wc[jq, want_codes[i, jq]] -= 1
        np.testing.assert_array_equal(gc, wc)
        np.testing.assert_allclose(gs, ws, rtol=1e-5, atol=1e-4)
        if skewed:
            assert np.all(counts.numpy()[:, k // 2] == n)
