"""reductive_tpu_torch.ivf against reductive_tpu.ivf on the same arrays (CPU),
and the JAX package's IVF invariants on the port alone.

Build: from the same coarse centroids and codebooks both packages give equal
cell codes and ids and cell norms within 1e-6 relative, under every capacity
and overflow mode and packed; the data keeps every row more than 1e-4
relative from a tie (asserted).  Search: the decode probe gives the JAX
package's ids with distances within 1e-5, the ADC-table probe the ids of the
JAX package's (its Pallas kernel in interpret mode).  Training: each stage
from the same start gives the same centroids and codebooks within 1e-5.
"""

import logging

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from reductive_tpu import io as jio
from reductive_tpu import ivf as jivf
from reductive_tpu.kmeans import kmeans_with_centroids_chunked as j_kmeans_chunked
from reductive_tpu.pq.model import Pq as JPq
from reductive_tpu.pq.train import train_pq_chunked as j_train_pq_chunked
from reductive_tpu_torch import Pq, convert, ivf
from reductive_tpu_torch import io as tio

from torch_port_util import t

D, C, M, K = 8, 8, 2, 16
TIE_MARGIN = 1e-4


def clustered(seed, n_clusters=C, n=400, d=D, spread=0.3):
    """Rows around ``n_clusters`` centres (x 3.0), each row's centre drawn at
    random (so the clusters are uneven), and the centres themselves."""
    rng = np.random.default_rng(seed)
    centers = (rng.standard_normal((n_clusters, d)) * 3.0).astype(np.float32)
    member = rng.integers(0, n_clusters, n)
    x = centers[member] + spread * rng.standard_normal((n, d)).astype(np.float32)
    return x.astype(np.float32), centers


def model(seed, k=K, m=M, d=D):
    """Coarse centroids near the centres and random residual codebooks."""
    rng = np.random.default_rng(seed + 1000)
    x, centers = clustered(seed, d=d)
    coarse = (centers + 0.05 * rng.standard_normal(centers.shape)).astype(np.float32)
    cb = (0.3 * rng.standard_normal((m, k, d // m))).astype(np.float32)
    return x, coarse, cb


def rel_gaps(dist, first=None):
    """Least relative gap between neighbouring values among the ``first``
    smallest of each row (all where None)."""
    s = np.sort(dist, axis=-1)[..., :first]
    return ((s[..., 1:] - s[..., :-1]) / np.maximum(np.abs(s[..., 1:]), 1e-30)).min()


def assert_no_near_ties(x, coarse, cb, cells, A):
    """The decisions a build made lie more than TIE_MARGIN (relative, in
    float64) from a tie: each row's A + 1 nearest coarse cells (the
    candidates and the first one past them), for a row stored outside its A
    nearest (spilled) the order of all cells, and the best two centroids of
    each subvector of its residual against the cell it is stored in."""
    x64, c64, cb64 = x.astype(np.float64), coarse.astype(np.float64), cb.astype(np.float64)
    d2 = ((x64[:, None, :] - c64[None]) ** 2).sum(-1)
    assert rel_gaps(d2, A + 1) > TIE_MARGIN
    spilled = ~(np.argsort(d2, axis=1)[:, :A] == cells[:, None]).any(axis=1)
    if spilled.any():
        assert rel_gaps(d2[spilled]) > TIE_MARGIN
    m, k, ds = cb.shape
    res = (x64 - c64[cells]).reshape(-1, m, 1, ds)
    assert rel_gaps(((res - cb64[None]) ** 2).sum(-1), 2) > TIE_MARGIN


def stored(index):
    """(cells, slots, rows) of the occupied slots, as numpy."""
    ids = index.cell_ids.numpy()
    cells, slots = np.nonzero(ids >= 0)
    return cells, slots, ids[cells, slots]


def j_index(index):
    """The port's index as a ``reductive_tpu.ivf.IvfPq`` (through convert)."""
    coarse, cb, proj, codes, ids, norms, dropped = convert.ivf_to_numpy(index)
    out = jivf.IvfPq(coarse_centroids=jnp.asarray(coarse),
                     pq=JPq(codebooks=jnp.asarray(cb),
                            projection=None if proj is None else jnp.asarray(proj)),
                     cell_codes=jnp.asarray(codes), cell_ids=jnp.asarray(ids),
                     cell_norms=jnp.asarray(norms))
    out.dropped_ids = dropped
    return out


def t_index(seed=5, capacity="auto", packed=False, **kw):
    x, coarse, cb = model(seed)
    index = ivf.build_ivf(t(coarse), Pq(codebooks=t(cb)), t(x), capacity=capacity, packed=packed,
                          **kw)
    return x, coarse, cb, index


def dist_atol(q):
    """Absolute tolerance of an IVFADC distance: 1e-5 of the largest
    ``|q|^2``, the size of the terms ``|q|^2 + g - 2 q.c - 2 q.rec`` that
    cancel into it (a query near a row gets a distance far below them)."""
    return 1e-5 * float((q.astype(np.float64) ** 2).sum(1).max())


def queries(x, nq=7, seed=9):
    rng = np.random.default_rng(seed)
    q = x[:: x.shape[0] // nq][:nq]
    return (q + 0.05 * rng.standard_normal(q.shape)).astype(np.float32)


# ---------------------------------------------------------------------------
# Build parity
# ---------------------------------------------------------------------------

# model(21) holds every build's decisions TIE_MARGIN from a tie (asserted in
# the test), and its bounded builds move rows out of their nearest cell, the
# spill build out of their two nearest.
BUILD_SEED = 21
BUILDS = {
    "none": dict(capacity=None),
    "auto": dict(capacity="auto"),
    "int_spill": dict(capacity=50, overflow_candidates=2, on_overflow="spill"),
    "int_drop": dict(capacity=40, on_overflow="drop"),
    "auto_packed": dict(capacity="auto", packed=True),
}


@pytest.mark.parametrize("case", list(BUILDS))
def test_build_matches_jax(case):
    x, coarse, cb = model(BUILD_SEED)
    kw = BUILDS[case]
    t_idx = ivf.build_ivf(t(coarse), Pq(codebooks=t(cb)), t(x), **kw)
    j_idx = jivf.build_ivf(jnp.asarray(coarse), JPq(codebooks=jnp.asarray(cb)), jnp.asarray(x),
                           use_kernel=False, placement="host", **kw)
    np.testing.assert_array_equal(t_idx.cell_ids.numpy(), np.asarray(j_idx.cell_ids))
    cells, _, rows = stored(t_idx)
    A = 1 if kw["capacity"] is None else kw.get("overflow_candidates", 4)
    assert_no_near_ties(x[rows], coarse, cb, cells, A)
    assert t_idx.packed == j_idx.packed == kw.get("packed", False)
    assert t_idx.cell_codes.dtype == torch.uint8
    np.testing.assert_array_equal(t_idx.cell_codes.numpy(), np.asarray(j_idx.cell_codes))
    np.testing.assert_allclose(t_idx.cell_norms.numpy(), np.asarray(j_idx.cell_norms), rtol=1e-6)
    np.testing.assert_array_equal(t_idx.dropped_ids, j_idx.dropped_ids)
    if case == "int_drop":
        assert t_idx.dropped_ids.size > 0
    if case in ("auto", "int_spill"):  # rows placed outside their nearest cell(s)
        near = np.argsort(((x[rows, None, :] - coarse[None]) ** 2).sum(-1), axis=1)
        assert (near[:, 0] != cells).any()
        if case == "int_spill":
            assert (~(near[:, :2] == cells[:, None]).any(axis=1)).any()


def test_build_error_mode_matches_jax():
    x, coarse, cb = model(BUILD_SEED)
    kw = dict(capacity=40, on_overflow="error")
    with pytest.raises(ValueError, match="candidate cells") as t_err:
        ivf.build_ivf(t(coarse), Pq(codebooks=t(cb)), t(x), **kw)
    with pytest.raises(ValueError, match="candidate cells") as j_err:
        jivf.build_ivf(jnp.asarray(coarse), JPq(codebooks=jnp.asarray(cb)), jnp.asarray(x),
                       use_kernel=False, **kw)
    assert str(t_err.value) == str(j_err.value)


# ---------------------------------------------------------------------------
# Search parity
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("metric", ["l2", "dot"])
@pytest.mark.parametrize("nprobe,top_k", [(1, 5), (3, 5), (C, 10), (1, 80)])
def test_decode_probe_matches_jax(metric, nprobe, top_k):
    x, _, _, index = t_index()
    q = queries(x)
    d, i = ivf.ivf_search(index, t(q), top_k, nprobe=nprobe, metric=metric)
    jd, ji = jivf.ivf_search(j_index(index), jnp.asarray(q), top_k, nprobe=nprobe,
                             use_kernel=False, metric=metric)
    assert d.dtype == torch.float32 and i.dtype == torch.int64 and i.shape == (len(q), top_k)
    np.testing.assert_array_equal(i.numpy(), np.asarray(ji))
    np.testing.assert_allclose(d.numpy(), np.asarray(jd), rtol=1e-5,
                               atol=1e-5 if metric == "dot" else dist_atol(q))
    if top_k > index.capacity:  # past the probed candidates: padding
        assert (i == -1).any() and torch.isinf(d[i == -1]).all()


@pytest.mark.parametrize("packed", [False, True])
@pytest.mark.parametrize("metric", ["l2", "dot"])
@pytest.mark.parametrize("splits", [2, 3])
def test_lut_probe_matches_jax(monkeypatch, packed, metric, splits):
    monkeypatch.setattr(jivf, "_PROBE_LUT_INTERPRET", True)
    x, _, _, index = t_index(packed=packed)
    q = queries(x)
    args = (index.coarse_centroids, index.cell_codes, index.cell_ids, index.cell_norms, index.pq,
            3, 6, splits, metric)
    d, i = ivf._probe_and_score_lut(t(q), *args)
    ji_ = j_index(index)
    jd, ji = jivf._probe_and_score_lut(
        jnp.asarray(q), ji_.coarse_centroids, ji_.cell_codes, ji_.cell_ids, ji_.cell_norms,
        ji_.pq, 3, 6, splits, metric)
    np.testing.assert_array_equal(i.numpy(), np.asarray(ji))
    np.testing.assert_allclose(d.numpy(), np.asarray(jd), rtol=2e-5, atol=2e-5)
    # The kernel route of ivf_search is this probe.
    dk, ik = ivf.ivf_search(index, t(q), 6, nprobe=3, use_kernel=True, splits=splits,
                            metric=metric)
    np.testing.assert_array_equal(ik.numpy(), i.numpy().astype(np.int64))
    np.testing.assert_array_equal(dk.numpy(), d.numpy())


def test_lut_probe_chunked_union_matches_one_chunk(monkeypatch):
    x, _, _, index = t_index()
    q = queries(x, nq=9)
    args = (t(q), index.coarse_centroids, index.cell_codes, index.cell_ids, index.cell_norms,
            index.pq, 6, 8, 3, "l2")
    one = ivf._probe_and_score_lut(*args)
    monkeypatch.setattr(ivf, "_PROBE_LUT_BUDGET", 4 * q.shape[0] * index.capacity)  # a cell a chunk
    many = ivf._probe_and_score_lut(*args)
    np.testing.assert_array_equal(one[1].numpy(), many[1].numpy())
    np.testing.assert_array_equal(one[0].numpy(), many[0].numpy())
    # top_k past the probed candidates pads with +inf / -1.
    small = ivf.build_ivf(index.coarse_centroids, index.pq, t(x[:24]), capacity=4,
                          on_overflow="drop")
    d, i = ivf._probe_and_score_lut(t(q[:3]), small.coarse_centroids, small.cell_codes,
                                    small.cell_ids, small.cell_norms, small.pq, 1, 10, 3, "l2")
    assert d.shape == (3, 10) and i.shape == (3, 10)
    pad = ~torch.isfinite(d)
    assert pad.any() and (i[pad] == -1).all()


def test_decode_probe_chunking_matches_unchunked(monkeypatch):
    x, _, _, index = t_index()
    q = t(queries(x, nq=5))
    d_ref, i_ref = ivf.ivf_search(index, q, 5, nprobe=4)
    nq, L, d = 5, index.capacity, D
    for budget in (nq * L * d * 4, max(1, nq * (L // 3) * d * 4)):  # probes, then cell rows
        monkeypatch.setattr(ivf, "_PROBE_RECON_BUDGET", budget)
        dc, ic = ivf.ivf_search(index, q, 5, nprobe=4)
        np.testing.assert_array_equal(ic.numpy(), i_ref.numpy())
        np.testing.assert_allclose(dc.numpy(), d_ref.numpy(), rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("metric", ["l2", "dot"])
def test_refine_matches_jax(metric):
    x, _, _, index = t_index()
    q = queries(x)
    d, i = ivf.ivf_search(index, t(q), 5, nprobe=3, refine_with=t(x), refine_factor=8,
                          metric=metric)
    jd, ji = jivf.ivf_search(j_index(index), jnp.asarray(q), 5, nprobe=3, use_kernel=False,
                             refine_with=jnp.asarray(x), refine_factor=8, metric=metric)
    np.testing.assert_array_equal(i.numpy(), np.asarray(ji))
    np.testing.assert_allclose(d.numpy(), np.asarray(jd), rtol=1e-5, atol=1e-5)


def test_packed_cells_score_bit_for_bit_as_unpacked():
    x, _, _, unpacked = t_index()
    _, _, _, packed = t_index(packed=True)
    assert packed.packed and not unpacked.packed
    assert packed.cell_codes.shape[2] == unpacked.cell_codes.shape[2] // 2
    q = t(queries(x))
    for use_kernel in (False, True):
        for metric in ("l2", "dot"):
            a = ivf.ivf_search(unpacked, q, 5, nprobe=4, use_kernel=use_kernel, metric=metric)
            b = ivf.ivf_search(packed, q, 5, nprobe=4, use_kernel=use_kernel, metric=metric)
            assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])


# ---------------------------------------------------------------------------
# Training by stage
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("coarse_metric", ["l2", "spherical"])
def test_coarse_stage_matches_jax(coarse_metric):
    x, centers = clustered(21, n=600, d=16, spread=0.4)
    if coarse_metric == "spherical":
        x = x / np.linalg.norm(x, axis=1, keepdims=True)
    init = x[np.random.default_rng(22).choice(len(x), C, replace=False)]
    got = ivf._coarse_stage(t(x), t(init), 3, coarse_metric=coarse_metric).numpy()
    xj = jnp.asarray(x)
    if coarse_metric == "l2":
        want, _ = j_kmeans_chunked(xj, jnp.asarray(init), 3, use_kernel=False)
    else:  # the JAX package's loop (reductive_tpu/ivf.py, train_ivf_pq)
        want = jnp.asarray(init) / jnp.maximum(jnp.linalg.norm(init, axis=1, keepdims=True), 1e-30)
        for _ in range(3):
            want, _ = j_kmeans_chunked(xj, want, 1, use_kernel=False)
            norm = jnp.linalg.norm(want, axis=1, keepdims=True)
            want = jnp.where(norm > 0, want / jnp.maximum(norm, 1e-30), want)
        norms = np.linalg.norm(got, axis=1)
        np.testing.assert_allclose(norms[norms > 0], 1.0, rtol=1e-5)
    np.testing.assert_allclose(got, np.asarray(want), rtol=1e-5, atol=1e-5)


def test_residual_stage_matches_jax():
    x, coarse, _ = model(23)
    cb0 = (0.3 * np.random.default_rng(24).standard_normal((M, K, D // M))).astype(np.float32)
    got = ivf._residual_stage(torch.Generator().manual_seed(0), t(x), t(coarse), M, 4, 3,
                              initial_model=Pq(codebooks=t(cb0)))
    xj, cj = jnp.asarray(x), jnp.asarray(coarse)
    residuals = xj - cj[jivf._assign_coarse(cj, xj, False)]
    want = j_train_pq_chunked(jax.random.PRNGKey(0), residuals, M, 4, 3, use_kernel=False,
                              initial_model=JPq(codebooks=jnp.asarray(cb0)))
    np.testing.assert_allclose(got.codebooks.numpy(), np.asarray(want.codebooks),
                               rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("residual_quantizer", ["pq", "gaussian_opq"])
def test_train_ivf_pq_trains_both_stages(residual_quantizer):
    x, _ = clustered(25, n=800, d=16)
    gen = torch.Generator().manual_seed(1)
    coarse, pq = ivf.train_ivf_pq(gen, t(x), C, 4, 4, coarse_iterations=3, pq_iterations=3,
                                  train_sample=512, residual_quantizer=residual_quantizer)
    assert coarse.shape == (C, 16) and pq.codebooks.shape == (4, 16, 4)
    assert (pq.projection is not None) == (residual_quantizer == "gaussian_opq")
    assert bool(torch.isfinite(coarse).all()) and bool(torch.isfinite(pq.codebooks).all())
    # The same generator state gives the same model.
    again = ivf.train_ivf_pq(torch.Generator().manual_seed(1), t(x), C, 4, 4, coarse_iterations=3,
                             pq_iterations=3, train_sample=512,
                             residual_quantizer=residual_quantizer)
    assert torch.equal(coarse, again[0]) and torch.equal(pq.codebooks, again[1].codebooks)


# ---------------------------------------------------------------------------
# The JAX package's invariants, on the port alone
# ---------------------------------------------------------------------------


def trained_index(seed, n_clusters=8, per=100, d=16, cells=8, capacity=None, **kw):
    rng = np.random.default_rng(seed)
    centers = rng.standard_normal((n_clusters, d)).astype(np.float32) * 3.0
    x = (centers[:, None, :] + 0.15 * rng.standard_normal((n_clusters, per, d))).reshape(-1, d)
    x = t(x.astype(np.float32))
    coarse, pq = ivf.train_ivf_pq(torch.Generator().manual_seed(seed), x, cells, 4, 4,
                                  train_sample=None, **kw)
    return x, coarse, pq, ivf.build_ivf(coarse, pq, x, capacity=capacity)


def expected_codes(x, coarse, pq, index):
    cells, slots, rows = stored(index)
    return (index.cell_codes.numpy()[cells, slots],
            pq.quantize_batch(x[rows] - coarse[torch.from_numpy(cells)]).numpy())


@pytest.mark.parametrize("capacity", [None, "auto"])
def test_build_invariants(capacity):
    x, coarse, pq, index = trained_index(0, capacity=capacity)
    _, _, rows = stored(index)
    assert sorted(rows.tolist()) == list(range(x.shape[0]))  # every row exactly once
    got, want = expected_codes(x, coarse, pq, index)
    np.testing.assert_array_equal(got, want)  # residuals of the storage cell's centroid
    if capacity == "auto":
        assert index.capacity == int(np.ceil(1.25 * x.shape[0] / 8))
    assert index.n_cells == 8 and index.dropped_ids.size == 0


@pytest.mark.parametrize("metric", ["l2", "dot"])
def test_full_probe_matches_brute_force(metric):
    x, coarse, pq, index = trained_index(1)
    q = x[::97][:9] + 0.05 * torch.randn((9, 16), generator=torch.Generator().manual_seed(2))
    d, i = ivf.ivf_search(index, q, 5, nprobe=8, metric=metric)
    cells, slots, rows = stored(index)
    rec = torch.zeros_like(x)
    rec[torch.from_numpy(rows)] = coarse[torch.from_numpy(cells)] + pq.reconstruct_batch(
        index.cell_codes[torch.from_numpy(cells), torch.from_numpy(slots)])
    score = -(q @ rec.T) if metric == "dot" else ((q[:, None, :] - rec[None]) ** 2).sum(-1)
    want_d, want_i = torch.sort(score, dim=1, stable=True)
    np.testing.assert_array_equal(i.numpy(), want_i[:, :5].numpy())
    np.testing.assert_allclose(d.numpy(), want_d[:, :5].numpy(), rtol=1e-3, atol=1e-3)


@pytest.mark.parametrize("use_kernel", [False, True])
def test_recall_with_few_probes(use_kernel):
    x, _, _, index = trained_index(3, n_clusters=32, per=100, cells=32)
    planted = np.arange(0, 3200, 100)
    q = x[planted] + 0.02 * torch.randn((32, 16), generator=torch.Generator().manual_seed(4))
    _, idx = ivf.ivf_search(index, q, 10, nprobe=4, use_kernel=use_kernel)
    recall = np.mean([planted[r] in idx[r].tolist() for r in range(32)])
    assert recall > 0.9, recall


def test_underfull_cells_pad_with_minus_one():
    rng = np.random.default_rng(5)
    x = t(rng.standard_normal((20, 8)).astype(np.float32))
    pq = Pq(codebooks=t(rng.standard_normal((2, 4, 4)).astype(np.float32)))
    index = ivf.build_ivf(x[:4].clone(), pq, x)  # 4 cells, about 5 rows each
    d, i = ivf.ivf_search(index, x[:2], 15, nprobe=1)
    assert (i == -1).any() and torch.isinf(d[i == -1]).all()
    for row_d, row_i in zip(d, i):
        nv = int((row_i >= 0).sum())
        assert (torch.diff(row_d[:nv]) >= -1e-6).all()


def test_overflow_modes(caplog):
    x, coarse, pq, _ = trained_index(6, n_clusters=4, per=50, d=8, cells=4)
    with caplog.at_level(logging.WARNING, logger="reductive_tpu"):
        index = ivf.build_ivf(coarse, pq, x, capacity=10, on_overflow="drop")
    assert index.capacity == 10 and any("dropped" in r.message for r in caplog.records)
    _, _, placed = stored(index)
    assert index.dropped_ids.size == x.shape[0] - len(placed) > 0
    assert sorted(placed.tolist() + index.dropped_ids.tolist()) == list(range(x.shape[0]))
    with pytest.raises(ValueError, match="candidate cells"):
        ivf.build_ivf(coarse, pq, x, capacity=10, on_overflow="error")
    with pytest.raises(ValueError, match="no spill placement"):
        ivf.build_ivf(coarse, pq, x, capacity=10, on_overflow="spill")
    with pytest.raises(ValueError, match="on_overflow"):
        ivf.build_ivf(coarse, pq, x, capacity=10, on_overflow="panic")


def test_spill_places_every_row():
    rng = np.random.default_rng(60)
    centers = rng.standard_normal((4, 8)).astype(np.float32) * 3.0
    x = t((centers[:, None, :] + 0.3 * rng.standard_normal((4, 50, 8))).reshape(-1, 8)
          .astype(np.float32))
    coarse, pq = ivf.train_ivf_pq(torch.Generator().manual_seed(60), x, 4, 2, 3,
                                  train_sample=None)
    index = ivf.build_ivf(coarse, pq, x, capacity=50, overflow_candidates=2)
    assert index.dropped_ids.size == 0
    _, _, rows = stored(index)
    assert sorted(rows.tolist()) == list(range(200))
    got, want = expected_codes(x, coarse, pq, index)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("writer,reader", [("torch", "torch"), ("jax", "torch"), ("torch", "jax")])
@pytest.mark.parametrize("packed", [False, True])
def test_artifact_round_trip(tmp_path, writer, reader, packed):
    _, _, _, index = t_index(capacity=40, on_overflow="drop", packed=packed)
    assert index.dropped_ids.size > 0
    path = tmp_path / "ivf.npz"
    if writer == "torch":
        tio.save(path, index)
    else:
        jio.save(str(path), j_index(index))
    loaded = tio.load(path, device="cpu") if reader == "torch" else jio.load(str(path))
    if reader == "torch":
        assert isinstance(loaded, ivf.IvfPq) and loaded.packed == packed
        arrays = convert.ivf_to_numpy(loaded)
    else:
        assert isinstance(loaded, jivf.IvfPq) and loaded.packed == packed
        arrays = (loaded.coarse_centroids, loaded.pq.codebooks, loaded.pq.projection,
                  loaded.cell_codes, loaded.cell_ids, loaded.cell_norms, loaded.dropped_ids)
    for got, want in zip(arrays, convert.ivf_to_numpy(index)):
        if want is None:
            assert got is None
        else:
            np.testing.assert_array_equal(np.asarray(got), want)
            assert np.asarray(got).dtype == want.dtype


class Reader:
    """A reader over the rows of ``x`` (``read`` only: no ``read_rows``)."""

    def __init__(self, x):
        self.x = x.numpy()
        self.n, self.dim = self.x.shape

    def read(self, start, count):
        return self.x[start:start + count].copy()


def test_validation_errors():
    x, coarse, pq, index = trained_index(27, n_clusters=4, per=50, d=8, cells=4)
    gen = torch.Generator().manual_seed(0)
    cases = [
        (ValueError, "unknown metric", lambda: ivf.ivf_search(index, x[:2], 3, nprobe=2,
                                                              metric="cosine")),
        (ValueError, "refine_factor", lambda: ivf.ivf_search(index, x[:2], 3, nprobe=2,
                                                             refine_with=x, refine_factor=0)),
        (ValueError, "nprobe", lambda: ivf.ivf_search(index, x[:2], 3, nprobe=5)),
        (ValueError, "top_k", lambda: ivf.ivf_search(index, x[:2], 0, nprobe=2)),
        (ValueError, "placement", lambda: ivf.build_ivf(coarse, pq, x, placement="gpu")),
        (ValueError, "on_overflow", lambda: ivf.build_ivf(coarse, pq, x, on_overflow="panic")),
        (ValueError, "coarse_metric", lambda: ivf.train_ivf_pq(gen, x, 4, 2, 3,
                                                               coarse_metric="cosine")),
        (ValueError, "residual_quantizer", lambda: ivf.train_ivf_pq(gen, x, 4, 2, 3,
                                                                    residual_quantizer="opq2")),
        (ValueError, "k <= 16", lambda: ivf.build_ivf(
            coarse, Pq(codebooks=torch.zeros((2, 32, 4))), x, packed=True)),
        (ValueError, "even m", lambda: ivf.build_ivf(
            coarse, Pq(codebooks=torch.zeros((1, 16, 8))), x, packed=True)),
        (ValueError, "dtype=uint8", lambda: ivf.build_ivf(coarse, pq, x, packed=True,
                                                          dtype=torch.int32)),
        (ValueError, "on_overflow", lambda: ivf.ivf_add(index, x[:2], on_overflow="panic")),
        (ValueError, "int32", lambda: ivf.ivf_add(index, x[:2], ids=np.array([7, 2 ** 32]))),
        (ValueError, "instances lie on meta", lambda: ivf.ivf_add(
            index, torch.empty((2, 8), device="meta"))),
        (TypeError, r"build_ivf\(reader\)", lambda: ivf.ivf_add(index, Reader(x))),
        (TypeError, "torch.Generator", lambda: ivf.train_ivf_pq(object(), x, 4, 2, 3)),
    ]
    for exc, match, call in cases:
        with pytest.raises(exc, match=match):
            call()
    # A reader in place of a tensor, refused before the port read corpora
    # from disk, is served: the build, training and refine over it equal
    # those over the same rows as a tensor.
    built = ivf.build_ivf(coarse, pq, Reader(x))
    for name in ("cell_codes", "cell_ids", "cell_norms"):
        assert torch.equal(getattr(built, name), getattr(index, name))
    c_r, pq_r = ivf.train_ivf_pq(torch.Generator().manual_seed(3), Reader(x), 4, 2, 3)
    assert tuple(c_r.shape) == (4, 8) and tuple(pq_r.codebooks.shape) == (2, 8, 4)
    got = ivf.ivf_search(index, x[:2], 3, nprobe=2, refine_with=Reader(x))
    want = ivf.ivf_search(index, x[:2], 3, nprobe=2, refine_with=x)
    assert torch.equal(got[1], want[1]) and torch.equal(got[0], want[0])
