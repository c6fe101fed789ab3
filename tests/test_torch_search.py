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


def test_search_waiting_parameters_raise():
    _, tpq, x, q, codes = _setup(n=40)

    class Reader:
        n = 40

    msg = _message(lambda: search(tpq, t(q), t(codes), 3, packed=True), NotImplementedError)
    assert "ROADMAP" in msg and "Packed u4" in msg
    msg = _message(lambda: search(tpq, t(q), t(codes), 3, refine_with=Reader()), NotImplementedError)
    assert "ROADMAP" in msg and "reader" in msg
