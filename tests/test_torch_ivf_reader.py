"""IVF-PQ and search over a corpus on disk: a reader in place of the tensor.

The corpus is written by the JAX package's ``write_fvecs``.  ``build_ivf``
over a reader, host and device placement, under every capacity and overflow
mode and packed, gives cells equal bit for bit to the build from the same
rows as a tensor, and (host placement, from the same coarse centroids and
codebooks) the JAX package's reader build's cells: codes and ids equal,
norms within 1e-6 relative (model(21) of tests/test_torch_ivf.py keeps the
decisions 1e-4 from a tie there).  ``train_ivf_pq`` over a reader equals the
tensor path over the same sorted sample; ``refine_with=`` a reader equals
``refine_with=`` the tensor in ``search`` and ``ivf_search``."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from reductive_tpu import ivf as jivf
from reductive_tpu.native import VecsReader as JReader
from reductive_tpu.native import write_fvecs
from reductive_tpu.pq.model import Pq as JPq
from reductive_tpu_torch import Pq, SyntheticReader, ivf, kmeans, search
from reductive_tpu_torch.native import VecsReader

D, C, M, K = 8, 8, 2, 16


def model(seed, n=400):
    """Rows around C uneven clusters, coarse centroids near their centres
    and random residual codebooks (tests/test_torch_ivf.py's model)."""
    rng = np.random.default_rng(seed)
    centers = (rng.standard_normal((C, D)) * 3.0).astype(np.float32)
    x = centers[rng.integers(0, C, n)] + 0.3 * rng.standard_normal((n, D)).astype(np.float32)
    rng = np.random.default_rng(seed + 1000)
    coarse = (centers + 0.05 * rng.standard_normal(centers.shape)).astype(np.float32)
    cb = (0.3 * rng.standard_normal((M, K, D // M))).astype(np.float32)
    return x.astype(np.float32), coarse, cb


@pytest.fixture
def corpus(tmp_path):
    x, coarse, cb = model(21)
    path = str(tmp_path / "corpus.fvecs")
    write_fvecs(path, x)
    return x, coarse, cb, path


BUILDS = {
    "none": dict(capacity=None),
    "auto": dict(capacity="auto"),
    "int_spill": dict(capacity=50, overflow_candidates=2, on_overflow="spill"),
    "int_drop": dict(capacity=40, on_overflow="drop"),
    "auto_packed": dict(capacity="auto", packed=True),
}


def assert_same_cells(got, want):
    for name in ("cell_codes", "cell_ids", "cell_norms", "coarse_centroids"):
        assert torch.equal(getattr(got, name), getattr(want, name)), name
    np.testing.assert_array_equal(got.dropped_ids, want.dropped_ids)


@pytest.mark.parametrize("placement", ["host", "device"])
@pytest.mark.parametrize("case", list(BUILDS))
def test_reader_build_equals_the_tensor_build(corpus, placement, case):
    x, coarse, cb, path = corpus
    pq = Pq(codebooks=torch.from_numpy(cb))
    kw = dict(BUILDS[case], placement=placement, batch=96)  # several pass-2 batches
    want = ivf.build_ivf(torch.from_numpy(coarse), pq, torch.from_numpy(x), **kw)
    with VecsReader(path) as r:
        got = ivf.build_ivf(torch.from_numpy(coarse), pq, r, **kw)
    assert_same_cells(got, want)
    if case == "int_drop":
        assert got.dropped_ids.size > 0


@pytest.mark.parametrize("case", ["none", "auto", "int_spill", "int_drop", "auto_packed"])
def test_reader_build_equals_the_jax_packages(corpus, case):
    x, coarse, cb, path = corpus
    kw = BUILDS[case]
    with VecsReader(path) as r, JReader(path) as jr:
        got = ivf.build_ivf(torch.from_numpy(coarse), Pq(codebooks=torch.from_numpy(cb)), r,
                            placement="host", **kw)
        want = jivf.build_ivf(jnp.asarray(coarse), JPq(codebooks=jnp.asarray(cb)), jr,
                              use_kernel=False, placement="host", **kw)
    np.testing.assert_array_equal(got.cell_ids.numpy(), np.asarray(want.cell_ids))
    np.testing.assert_array_equal(got.cell_codes.numpy(), np.asarray(want.cell_codes))
    np.testing.assert_allclose(got.cell_norms.numpy(), np.asarray(want.cell_norms), rtol=1e-6)
    np.testing.assert_array_equal(got.dropped_ids, want.dropped_ids)


def test_reader_build_with_a_projection_and_read_alone(corpus):
    """A reader with ``read`` only (rows fetched one by one where the
    overflow needs them), and a residual quantizer with a projection."""
    x, coarse, cb, _ = corpus
    q, _ = np.linalg.qr(np.random.default_rng(3).standard_normal((D, D)))
    pq = Pq(codebooks=torch.from_numpy(cb), projection=torch.from_numpy(q.astype(np.float32)))

    class ReadOnly:
        n, dim = x.shape

        def read(self, start, count):
            return x[start:start + count]

    for placement in ("host", "device"):
        kw = dict(capacity=50, overflow_candidates=2, placement=placement)
        want = ivf.build_ivf(torch.from_numpy(coarse), pq, torch.from_numpy(x), **kw)
        assert_same_cells(ivf.build_ivf(torch.from_numpy(coarse), pq, ReadOnly(), **kw), want)


@pytest.mark.parametrize("train_sample", [None, 150, 10_000])
def test_train_ivf_pq_over_a_reader_is_the_tensor_path_over_its_sample(corpus, train_sample):
    """With a reader the sample is always drawn (``min(train_sample or
    262,144, n - 1)`` rows) and read in ascending order; the tensor path
    over those rows, drawing no sample of its own, from the generator as the
    draw left it, gives the same centroids and codebooks bit for bit."""
    x, _, _, path = corpus
    with VecsReader(path) as r:
        got_c, got_pq = ivf.train_ivf_pq(torch.Generator().manual_seed(7), r, C, M, 4,
                                         coarse_iterations=3, pq_iterations=3,
                                         train_sample=train_sample)
    gen = torch.Generator().manual_seed(7)
    cap = min(train_sample or 262_144, x.shape[0] - 1)
    idx = np.sort(kmeans.random_distinct_indices(gen, x.shape[0], cap).numpy())
    want_c, want_pq = ivf.train_ivf_pq(gen, torch.from_numpy(x[idx]), C, M, 4,
                                       coarse_iterations=3, pq_iterations=3, train_sample=None)
    assert torch.equal(got_c, want_c) and torch.equal(got_pq.codebooks, want_pq.codebooks)


def test_train_ivf_pq_over_a_reader_trains_on_the_generators_device(corpus):
    _, _, _, path = corpus
    with VecsReader(path) as r:
        coarse, pq = ivf.train_ivf_pq(torch.Generator().manual_seed(1), r, C, M, 4,
                                      coarse_iterations=2, pq_iterations=2,
                                      residual_quantizer="gaussian_opq")
    assert coarse.device.type == "cpu" and tuple(coarse.shape) == (C, D)
    assert pq.projection is not None and tuple(pq.codebooks.shape) == (M, K, D // M)


@pytest.mark.parametrize("metric", ["l2", "dot"])
def test_refine_by_a_reader_equals_refine_by_the_tensor(corpus, metric):
    x, coarse, cb, path = corpus
    xt = torch.from_numpy(x)
    pq = Pq(codebooks=torch.from_numpy(cb))
    index = ivf.build_ivf(torch.from_numpy(coarse), pq, xt, capacity="auto")
    q = xt[::57][:7] + 0.05
    flat = Pq(codebooks=torch.from_numpy(
        np.random.default_rng(4).standard_normal((2, 16, 4)).astype(np.float32)))
    codes = flat.quantize_batch(xt)
    with VecsReader(path) as r:
        for top_k in (1, 5):
            got = ivf.ivf_search(index, q, top_k, nprobe=3, refine_with=r, metric=metric)
            want = ivf.ivf_search(index, q, top_k, nprobe=3, refine_with=xt, metric=metric)
            assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
            got = search.search(flat, q, codes, top_k, refine_with=r, metric=metric)
            want = search.search(flat, q, codes, top_k, refine_with=xt, metric=metric)
            assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
        with pytest.raises(ValueError, match="refine_with has 400 rows, codes have 399"):
            search.search(flat, q, codes[:399], 3, refine_with=r)


def test_refine_pads_and_clips_ids_from_a_reader():
    """Fewer candidates than ``top_k * refine_factor`` in the probed cells:
    the padding ids (-1) are clipped to row 0 for the read and score +inf,
    as with a tensor."""
    x, coarse, cb = model(5, n=60)
    xt = torch.from_numpy(x)
    index = ivf.build_ivf(torch.from_numpy(coarse), Pq(codebooks=torch.from_numpy(cb)), xt)
    reader = SyntheticReader(60, D, device="cpu")
    reader.read_rows = lambda idx: x[np.asarray(idx)]
    got = ivf.ivf_search(index, xt[:3], 20, nprobe=1, refine_with=reader, refine_factor=4)
    want = ivf.ivf_search(index, xt[:3], 20, nprobe=1, refine_with=xt, refine_factor=4)
    assert torch.equal(got[1], want[1]) and torch.equal(got[0], want[0])
    assert bool((got[1] == -1).any()) and bool(torch.isinf(got[0]).any())
