"""reductive_tpu_torch.search against reductive_tpu.search on the same codes
(CPU).  Distances agree to rtol 1e-5; indices agree wherever neighbouring
scores differ by more than that tolerance."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from reductive_tpu.pq.model import Pq as JPq
from reductive_tpu.search import _resolve_stream_chunk as j_resolve
from reductive_tpu.search import adc_scores as j_adc_scores
from reductive_tpu.search import adc_scores_decode as j_adc_scores_decode
from reductive_tpu.search import adc_tables as j_adc_tables
from reductive_tpu.search import search as j_search
from reductive_tpu_torch import Pq
from reductive_tpu_torch.ops import pack_u4_codes
from reductive_tpu_torch.search import (
    _resolve_stream_chunk, adc_scores, adc_scores_decode, adc_tables, search,
)

from torch_port_util import j, make_pq_data, orthonormal, t

RTOL = 1e-5


def _setup(n=600, m=4, k=16, ds=8, nq=6, seed=71, projection=False):
    cb, x = make_pq_data(seed, n + nq, m, k, ds)
    proj = orthonormal(seed + 1, m * ds) if projection else None
    jpq = JPq(codebooks=j(cb), projection=None if proj is None else j(proj))
    tpq = Pq.from_numpy(cb, proj, device="cpu")
    codes = np.asarray(jpq.quantize_batch(j(x[:n])))  # one set of codes for both
    return jpq, tpq, x[:n], x[n:], codes


def assert_same_neighbours(got, want, top_k=None):
    """``(distances, indices)`` pairs: distances to RTOL, indices equal in
    every row whose neighbouring reference scores are further apart than
    the tolerance (the reference holds one more neighbour than compared, so
    the k-th against the (k+1)-th is covered too)."""
    gd, gi = got[0].numpy(), got[1].numpy()
    wd, wi = np.asarray(want[0]), np.asarray(want[1])
    top_k = gd.shape[1] if top_k is None else top_k
    scale = np.abs(wd).max()
    np.testing.assert_allclose(gd[:, :top_k], wd[:, :top_k], rtol=RTOL, atol=RTOL * scale)
    clear = np.all(np.diff(wd, axis=1) > 4 * RTOL * scale, axis=1)
    assert clear.mean() > 0.5
    np.testing.assert_array_equal(gi[clear, :top_k], wi[clear, :top_k])


@pytest.mark.parametrize("projection", [False, True])
@pytest.mark.parametrize("metric", ["l2", "dot"])
def test_adc_tables_and_scores_match_jax(metric, projection):
    jpq, tpq, _, q, codes = _setup(projection=projection)
    jt = j_adc_tables(jpq, j(q), metric=metric)
    tt = adc_tables(tpq, t(q), metric=metric)
    np.testing.assert_allclose(tt.numpy(), np.asarray(jt), rtol=1e-5, atol=1e-5)
    # The same tables through both scorers: the m entries are added in the
    # same order, so the scores are equal, for every chunking.
    want = np.asarray(j_adc_scores(jt, j(codes), chunk_size=256))
    for chunk_size in (16384, 256, 100):
        got = adc_scores(t(np.asarray(jt)), t(codes), chunk_size=chunk_size)
        np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("metric", ["l2", "dot"])
def test_adc_scores_decode_matches_jax(metric):
    jpq, tpq, _, q, codes = _setup(projection=True)
    want = np.asarray(j_adc_scores_decode(jpq, j(q), j(codes), use_kernel=False, metric=metric))
    for use_kernel in (False, True):  # on the CPU the decode wrapper takes its plain version
        got = adc_scores_decode(tpq, t(q), t(codes), splits=3, use_kernel=use_kernel, metric=metric)
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5 * np.abs(want).max())


@pytest.mark.parametrize("stream_chunk", [None, 128, 7])
@pytest.mark.parametrize("metric", ["l2", "dot"])
@pytest.mark.parametrize("method", ["auto", "einsum", "kernel", "decode"])
def test_search_matches_jax(method, metric, stream_chunk):
    jpq, tpq, _, q, codes = _setup()
    # On the CPU the JAX package's "auto" is its einsum scorer, and so is the
    # port's; the port's "kernel" is the ADC wrapper's plain version.
    want = j_search(jpq, j(q), j(codes), 6, method="einsum" if method != "decode" else "decode",
                    metric=metric)
    got = search(tpq, t(q), t(codes), 5, method=method, splits=3, metric=metric,
                 stream_chunk=stream_chunk)
    assert got[0].dtype == torch.float32 and got[1].dtype == torch.int64
    assert tuple(got[0].shape) == tuple(got[1].shape) == (6, 5)
    assert_same_neighbours(got, want, top_k=5)


def test_search_streamed_equals_jax_streamed():
    jpq, tpq, _, q, codes = _setup(n=1000)
    want = j_search(jpq, j(q), j(codes), 10, stream_chunk=300, method="einsum")
    got = search(tpq, t(q), t(codes), 10, stream_chunk=300, method="einsum")
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]), rtol=RTOL)
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))


@pytest.mark.parametrize("splits", [1, 2, "int8"])
def test_search_kernel_splits(splits):
    _, tpq, _, q, codes = _setup()
    exact = search(tpq, t(q), t(codes), 5, method="einsum")
    got = search(tpq, t(q), t(codes), 5, method="kernel", splits=splits)
    # Rounded tables: the same best neighbour on this well-separated data,
    # distances to the rounding of the mode.
    np.testing.assert_array_equal(got[1][:, 0].numpy(), exact[1][:, 0].numpy())
    rtol = {1: 2e-2, 2: 1e-4, "int8": 5e-2}[splits]
    np.testing.assert_allclose(got[0].numpy(), exact[0].numpy(), rtol=rtol)


@pytest.mark.parametrize("projection", [False, True])
@pytest.mark.parametrize("metric", ["l2", "dot"])
def test_search_refine_matches_jax(metric, projection):
    jpq, tpq, x, q, codes = _setup(projection=projection)
    want = j_search(jpq, j(q), j(codes), 5, refine_with=j(x), refine_factor=8, metric=metric)
    got = search(tpq, t(q), t(codes), 5, refine_with=t(x), refine_factor=8, metric=metric)
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]), rtol=1e-5, atol=1e-5)
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
    if metric == "l2":  # a corpus row finds itself, at distance 0
        d, i = search(tpq, t(x[:4]), t(codes), 3, refine_with=t(x))
        np.testing.assert_array_equal(i[:, 0].numpy(), np.arange(4))
        assert float(d[:, 0].abs().max()) == 0.0


def test_search_ties_lower_index_first():
    # Rows 0..3 carry the same code: four equal scores; lower index first,
    # as the JAX package's top_k orders them.
    jpq, tpq, _, q, codes = _setup()
    codes = codes.copy()
    codes[1:4] = codes[0]
    want = j_search(jpq, j(q[:1]), j(codes[:4]), 4, method="einsum")
    for stream_chunk in (None, 2):
        got = search(tpq, t(q[:1]), t(codes[:4]), 4, method="einsum", stream_chunk=stream_chunk)
        np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
        np.testing.assert_array_equal(got[1].numpy(), [[0, 1, 2, 3]])


def _lexsort_ids(scores, top_k):
    """The numpy oracle: the ``top_k`` smallest of each row by (score, position)."""
    return np.stack([np.lexsort((np.arange(row.shape[0]), row))[:top_k] for row in scores])


@pytest.mark.parametrize("stream_chunk", [None, 256, 1000])
@pytest.mark.parametrize("n,top_k", [(600, 10), (3000, 10), (3000, 100)])
def test_search_keeps_the_lowest_ids_among_ties_at_the_kth_place(n, top_k, stream_chunk):
    # A corpus of 40 distinct codes, each held by n/40 rows spread over it: the
    # k-th place is a tie between dozens of rows, the first rows by position
    # belong to the result (3000 rows: past the one-sort length, so the
    # topk-and-repair route; 100 ids cut through a second tied code).
    jpq, tpq, _, q, codes = _setup(n=n)
    codes = codes[np.random.default_rng(n).integers(0, 40, n)]
    scores = adc_scores(adc_tables(tpq, t(q)), t(codes)).numpy()
    want = _lexsort_ids(scores, top_k)
    got = search(tpq, t(q), t(codes), top_k, method="einsum", stream_chunk=stream_chunk)
    np.testing.assert_array_equal(got[1].numpy(), want)
    np.testing.assert_array_equal(got[0].numpy(), np.take_along_axis(scores, want, axis=1))
    jwant = j_search(jpq, j(q), j(codes), top_k, method="einsum", stream_chunk=stream_chunk)
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(jwant[1]))


@pytest.mark.parametrize("sort_row,block", [(2048, 1024), (0, 1024), (0, 7), (0, 1)])
def test_smallest_is_the_lexsort_oracle(sort_row, block, monkeypatch):
    # Rows with few distinct values (ties everywhere), +inf among them, k from
    # 1 to the whole row, blocks that do not divide the row; with ids given
    # (the streamed merge) the ids follow the positions.
    from reductive_tpu_torch import search as tsearch
    from reductive_tpu_torch.ops import select
    monkeypatch.setattr(tsearch, "_SORT_ROW", sort_row)
    monkeypatch.setattr(select, "_TIE_BLOCK", block)
    rng = np.random.default_rng(block)
    for trial in range(40):
        nq, n = int(rng.integers(1, 4)), int(rng.integers(1, 3000))
        k = int(rng.integers(1, min(n, 50) + 1))
        scores = rng.integers(0, int(rng.integers(1, 20)), (nq, n)).astype(np.float32)
        if trial % 4 == 0:
            scores[:, ::3] = np.inf
        vals, ids = tsearch._smallest(t(scores), None, k)
        want = _lexsort_ids(scores, k)
        np.testing.assert_array_equal(ids.numpy(), want)
        np.testing.assert_array_equal(vals.numpy(), np.take_along_axis(scores, want, axis=1))
        idx = rng.permutation(10 * n)[:n].astype(np.int64)[None].repeat(nq, axis=0)
        _, ids = tsearch._smallest(t(scores), t(idx), k)
        np.testing.assert_array_equal(ids.numpy(), np.take_along_axis(idx, want, axis=1))


def test_refine_keeps_candidate_order_among_duplicate_rows():
    # Duplicated corpus rows give equal exact distances; the refine keeps the
    # earlier candidates, as the JAX package's top_k over the candidate list.
    jpq, tpq, x, q, codes = _setup(n=600)
    pick = np.random.default_rng(3).integers(0, 30, 600)
    x, codes = x[pick], codes[pick]
    for top_k, factor in ((5, 8), (10, 30)):
        want = j_search(jpq, j(q), j(codes), top_k, refine_with=j(x), refine_factor=factor,
                        method="einsum")
        got = search(tpq, t(q), t(codes), top_k, refine_with=t(x), refine_factor=factor,
                     method="einsum")
        np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
        np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]), rtol=1e-5)


def test_refine_keeps_candidate_order_among_equal_exact_scores():
    # Rows 0 and 1 are v and -v: at exactly the same distance from a zero
    # query, and the nearest rows of all.  Their codes put row 1 first in the
    # ADC candidate list (its reconstruction has the smaller norm), against
    # their id order; the re-scored ties keep the candidate order, as the JAX
    # package's top_k does.
    jpq, tpq, x, _, codes = _setup()
    cb = np.asarray(jpq.codebooks)
    norms = (cb.astype(np.float64) ** 2).sum(axis=2)
    x, codes = x.copy(), codes.copy()
    x[0] = 0.01 * x[5]
    x[1] = -x[0]
    codes[0] = norms.argmax(axis=1)
    codes[1] = norms.argmin(axis=1)
    q0 = np.zeros((1, x.shape[1]), np.float32)
    for top_k in (1, 2, 3):
        want = j_search(jpq, j(q0), j(codes), top_k, refine_with=j(x), refine_factor=x.shape[0],
                        method="einsum")
        got = search(tpq, t(q0), t(codes), top_k, refine_with=t(x), refine_factor=x.shape[0],
                     method="einsum")
        np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
        # f32 sums of d squares, in the two frameworks' orders (the tied pair's
        # are equal bit for bit: the same squares).
        np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]), rtol=1e-5)
        assert got[0][0, 0] == got[0][0, min(1, top_k - 1)]
        np.testing.assert_array_equal(got[1][0, :2].numpy(), [1, 0][:top_k])


def test_resolve_stream_chunk_equals_jax():
    for nq in (1, 16, 128, 1000, 5000):
        for n in (10, 1 << 16, 1 << 20, 4_000_000, 100_000_000):
            for method in ("einsum", "kernel", "decode"):
                for d in (0, 128, 768):
                    for explicit in (None, 4096):
                        assert _resolve_stream_chunk(nq, n, explicit, method, d) == \
                            j_resolve(nq, n, explicit, method, d)
    assert _resolve_stream_chunk(128, 4_000_000, None, "kernel", 128) == 524288
    assert _resolve_stream_chunk(16, 4_000_000, None, "kernel", 128) is None


def _message(fn, exc=ValueError):
    with pytest.raises(exc) as err:
        fn()
    return str(err.value)


def test_search_errors_match_jax():
    jpq, tpq, x, q, codes = _setup(n=40)
    jq, jc, tq, tc = j(q), j(codes), t(q), t(codes)
    pairs = [
        (lambda: j_search(jpq, jq, jc, top_k=0), lambda: search(tpq, tq, tc, top_k=0)),
        (lambda: j_search(jpq, jq, jc, top_k=41), lambda: search(tpq, tq, tc, top_k=41)),
        (lambda: j_search(jpq, jq, jc, method="nope"), lambda: search(tpq, tq, tc, method="nope")),
        (lambda: j_search(jpq, jq, jc, metric="cos"), lambda: search(tpq, tq, tc, metric="cos")),
        (lambda: j_search(jpq, jq, jc, refine_with=j(x), refine_factor=0),
         lambda: search(tpq, tq, tc, refine_with=t(x), refine_factor=0)),
        (lambda: j_search(jpq, jq, jc, refine_with=j(x[:7])),
         lambda: search(tpq, tq, tc, refine_with=t(x[:7]))),
        (lambda: j_adc_tables(jpq, jnp.zeros((1, 8))), lambda: adc_tables(tpq, torch.zeros((1, 8)))),
        (lambda: j_adc_tables(jpq, jq[0]), lambda: adc_tables(tpq, tq[0])),
        (lambda: j_adc_tables(jpq, jq, metric="cos"), lambda: adc_tables(tpq, tq, metric="cos")),
        (lambda: j_adc_scores(j_adc_tables(jpq, jq), jc[:, :3]),
         lambda: adc_scores(adc_tables(tpq, tq), tc[:, :3])),
    ]
    for jax_call, torch_call in pairs:
        assert _message(torch_call) == _message(jax_call)


@pytest.mark.parametrize("splits", [2, 3, "int8"])
@pytest.mark.parametrize("stream_chunk", [None, 256, 7])
def test_search_packed_equals_the_unpacked_search(stream_chunk, splits):
    # The shape of the JAX package's packed search test.
    _, tpq, _, q, codes = _setup(n=1200, m=8, k=16, ds=4, nq=4, seed=73)
    packed = pack_u4_codes(t(codes))
    assert tuple(packed.shape) == (1200, 4)
    want = search(tpq, t(q), t(codes), 7, method="kernel", splits=splits, stream_chunk=stream_chunk)
    got = search(tpq, t(q), packed, 7, method="kernel", splits=splits, stream_chunk=stream_chunk,
                 packed=True)
    np.testing.assert_array_equal(got[1].numpy(), want[1].numpy())
    np.testing.assert_array_equal(got[0].numpy(), want[0].numpy())


def test_search_packed_matches_jax():
    import unittest.mock as mock

    from reductive_tpu.ops import pack_u4_codes as j_pack_u4_codes
    from reductive_tpu.ops.adc import adc_scores_kernel as j_adc_scores_kernel
    from reductive_tpu.search import _search_jit, _search_streamed_jit

    jpq, tpq, _, q, codes = _setup(n=1200, m=8, k=16, ds=4, nq=4, seed=74)
    jpacked = j_pack_u4_codes(j(codes))
    # The JAX package's kernels in interpreter mode, as its own test runs them.
    try:
        with mock.patch(
            "reductive_tpu.ops.adc.adc_scores_kernel",
            lambda tb, c, splits, packed=False: j_adc_scores_kernel(
                tb, c, splits=splits, packed=packed, interpret=True),
        ):
            want = j_search(jpq, j(q), jpacked, top_k=8, method="kernel", packed=True, splits=3)
            want_st = j_search(jpq, j(q), jpacked, top_k=8, method="kernel", packed=True,
                               splits=3, stream_chunk=256)
    finally:
        _search_jit.clear_cache()
        _search_streamed_jit.clear_cache()
    packed = t(np.asarray(jpacked))
    got = search(tpq, t(q), packed, 7, method="kernel", packed=True, splits=3)
    assert_same_neighbours(got, want, top_k=7)
    got = search(tpq, t(q), packed, 7, method="kernel", packed=True, splits=3, stream_chunk=256)
    assert_same_neighbours(got, want_st, top_k=7)


def test_slice_train_verified_encode_pack_search_matches_jax():
    """The exact-and-compact path end to end in both packages: the chunked
    trainer in the verified mode from the same initial codebooks (k = 16), the
    verified encode, the packing, and the packed search.  Codebooks to 1e-5
    (f32 statistics summed in another order); with the port's codebooks handed
    to both sides, codes and packed bytes equal; distances to rtol 1e-4, and
    the same neighbours wherever neighbouring scores are further apart."""
    import unittest.mock as mock

    import jax

    import reductive_tpu as jrt
    import reductive_tpu_torch as trt
    from reductive_tpu.ops import pack_u4_codes as j_pack_u4_codes
    from reductive_tpu.ops import pq_encode_verified as j_pq_encode_verified
    from reductive_tpu.ops.adc import adc_scores_kernel as j_adc_scores_kernel
    from reductive_tpu.search import _search_jit, _search_streamed_jit
    from reductive_tpu_torch.ops import pq_encode_verified

    n, m, bits, ds, nq = 1500, 4, 4, 4, 5
    x = np.random.default_rng(76).random((n + nq, m * ds), dtype=np.float32)
    x, q = x[:n], x[n:]
    init = np.stack([x[20 * jq:20 * jq + 2 ** bits, jq * ds:(jq + 1) * ds] for jq in range(m)])
    tpq = trt.train_pq_chunked(None, t(x), m, bits, 4, chunk=512, compute_dtype="verified",
                               use_kernel=True, initial_model=trt.Pq(codebooks=t(init)))
    jpq = jrt.train_pq_chunked(jax.random.PRNGKey(0), j(x), m, bits, 4, chunk=512,
                               compute_dtype="verified", use_kernel=False,
                               initial_model=jrt.Pq(codebooks=j(init)))
    np.testing.assert_allclose(tpq.codebooks.numpy(), np.asarray(jpq.codebooks), atol=1e-5)

    # From here on the same codebooks on both sides, so that codes can be equal.
    jpq = JPq(codebooks=j(tpq.codebooks.numpy()))
    codes = pq_encode_verified(tpq.codebooks, t(x))
    jcodes = j_pq_encode_verified(jpq.codebooks, j(x), block_n=256, interpret=True)
    np.testing.assert_array_equal(codes.numpy(), np.asarray(jcodes))
    packed = pack_u4_codes(codes)
    jpacked = j_pack_u4_codes(jcodes)
    np.testing.assert_array_equal(packed.numpy(), np.asarray(jpacked))
    assert tuple(packed.shape) == (n, m // 2)

    try:
        with mock.patch(
            "reductive_tpu.ops.adc.adc_scores_kernel",
            lambda tb, c, splits, packed=False: j_adc_scores_kernel(
                tb, c, splits=splits, packed=packed, interpret=True),
        ):
            want = j_search(jpq, j(q), jpacked, top_k=9, method="kernel", packed=True, splits=3)
    finally:
        _search_jit.clear_cache()
        _search_streamed_jit.clear_cache()
    got = search(tpq, t(q), packed, 8, method="kernel", packed=True, splits=3)
    wd, wi = np.asarray(want[0]), np.asarray(want[1])
    np.testing.assert_allclose(got[0].numpy(), wd[:, :8], rtol=1e-4, atol=1e-6)
    clear = np.diff(wd, axis=1) > 4e-4 * wd[:, 1:]
    prefix = np.cumprod(clear, axis=1).astype(bool)  # ranks before the first unclear gap
    assert prefix.mean() > 0.5
    np.testing.assert_array_equal(got[1].numpy()[prefix[:, :8]], wi[:, :8][prefix[:, :8]])


def test_search_packed_rules_match_jax():
    jpq, tpq, x, q, codes = _setup(n=200, m=8, k=16, ds=4, nq=4, seed=75)
    packed = pack_u4_codes(t(codes))
    for method in ("einsum", "decode"):
        assert _message(lambda: search(tpq, t(q), packed, 3, packed=True, method=method)) == \
            _message(lambda: j_search(jpq, j(q), j(packed.numpy()), 3, packed=True, method=method))
    # On CPU tensors "auto" is the einsum scorer, which does not take packed codes.
    assert 'require method="kernel"' in _message(lambda: search(tpq, t(q), packed, 3, packed=True))
    # refine_with an array: candidates from the packed search, exact re-scoring.
    got = search(tpq, t(q), packed, 5, packed=True, method="kernel", refine_with=t(x),
                 refine_factor=8)
    want = search(tpq, t(q), t(codes), 5, method="kernel", refine_with=t(x), refine_factor=8)
    np.testing.assert_array_equal(got[1].numpy(), want[1].numpy())
    np.testing.assert_array_equal(got[0].numpy(), want[0].numpy())
    with pytest.raises(ValueError, match="packed codes have shape"):
        search(tpq, t(q), t(codes), 3, packed=True, method="kernel")


def test_search_waiting_parameters_raise():
    _, tpq, x, q, codes = _setup(n=40)

    class Reader:
        """A corpus on disk seen through ``read`` alone."""

        n = 40

        def read(self, start, count):
            return x[start:start + count]

    # Packed codes are served (the name dates from when they waited too); the
    # einsum scorer still refuses them, in the JAX package's words.
    packed = pack_u4_codes(t(codes))
    d, i = search(tpq, t(q), packed, 3, packed=True, method="kernel")
    d0, i0 = search(tpq, t(q), t(codes), 3, method="kernel")
    np.testing.assert_array_equal(i.numpy(), i0.numpy())
    np.testing.assert_array_equal(d.numpy(), d0.numpy())
    # A reader in place of refine_with's tensor is served: the candidates'
    # rows are read from it, and the refine equals the tensor's.
    got = search(tpq, t(q), t(codes), 3, refine_with=Reader())
    want = search(tpq, t(q), t(codes), 3, refine_with=t(x))
    np.testing.assert_array_equal(got[1].numpy(), want[1].numpy())
    np.testing.assert_array_equal(got[0].numpy(), want[0].numpy())
    assert "refine_with has 40 rows, codes have 39" == _message(
        lambda: search(tpq, t(q), t(codes[:39]), 3, refine_with=Reader()))
