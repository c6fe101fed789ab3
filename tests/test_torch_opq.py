"""reductive_tpu_torch.pq.opq against reductive_tpu.pq.opq on the CPU.

Eigenvectors are defined up to sign, so projections made by the two
eigensolvers are compared column by column up to sign; the alternation is
compared from a projection and codebooks handed to both packages.  The JAX
package takes the Procrustes rotation by a polar iteration, the port by an
SVD: for a full-rank cross matrix (``m * k >= d``) the rotation is unique and
the two agree to float tolerance; for a deficient one only orthonormality is
common to both.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import reductive_tpu as jrt
import reductive_tpu_torch as trt
from reductive_tpu.pq import opq as jopq
from reductive_tpu_torch.pq import opq as topq
from reductive_tpu_torch.pq.train import init_codebooks_random

from torch_port_util import j, orthonormal, t


def _gen(seed):
    return torch.Generator().manual_seed(seed)


def _uniform(seed, n, d):
    return np.random.default_rng(seed).random((n, d), dtype=np.float32)


def _correlated(seed, n, d):
    """Data whose covariance has well-separated eigenvalues."""
    rng = np.random.default_rng(seed)
    scales = np.linspace(0.3, 3.0, d).astype(np.float32)
    return (rng.standard_normal((n, d), dtype=np.float32) * scales) @ orthonormal(seed + 1, d)


def _gate_loss(pq, x):
    rec = pq.reconstruct_batch(pq.quantize_batch(x))
    return float((x - rec).pow(2).sum(dim=1).sqrt().mean())


def _orthonormal_err(r):
    r = r.numpy() if isinstance(r, torch.Tensor) else np.asarray(r)
    return float(np.abs(r.T @ r - np.eye(r.shape[0])).max())


# -- the projection ---------------------------------------------------------------


@pytest.mark.parametrize("n_values,n_buckets", [(8, 2), (12, 4), (6, 6), (20, 10)])
def test_bucket_eigenvalues_is_the_references(n_values, n_buckets):
    values = np.random.default_rng(n_values).random(n_values).astype(np.float32) * 5
    assert topq.bucket_eigenvalues(values, n_buckets) == jopq.bucket_eigenvalues(values, n_buckets)


@pytest.mark.parametrize(
    "values,n_buckets",
    [([1.0, 2.0], 0), ([1.0], 2), ([1.0, 2.0, 3.0], 2), ([-1.0, 2.0], 2)],
    ids=["zero_buckets", "too_few", "no_multiple", "negative"],
)
def test_bucket_eigenvalues_error_texts(values, n_buckets):
    with pytest.raises(ValueError) as terr:
        topq.bucket_eigenvalues(np.array(values, dtype=np.float32), n_buckets)
    with pytest.raises(ValueError) as jerr:
        jopq.bucket_eigenvalues(np.array(values, dtype=np.float32), n_buckets)
    assert str(terr.value) == str(jerr.value)


def test_create_projection_matrix_matches_jax_up_to_column_sign():
    x = _correlated(0, 500, 8)
    got = topq.create_projection_matrix(t(x), 4).numpy()
    want = np.asarray(jopq.create_projection_matrix(j(x), 4))
    assert _orthonormal_err(got) < 1e-5
    # The same eigenvector in the same column: |cosine| = 1 to 1e-4 (f32 eigh
    # of a covariance whose eigenvalues are 10% apart at least).
    cos = np.abs(np.sum(got * want, axis=0))
    np.testing.assert_allclose(cos, 1.0, atol=1e-4)
    from_cov = topq.projection_from_covariance(trt.linalg.covariance(t(x)), 4).numpy()
    np.testing.assert_array_equal(from_cov, got)


# -- the alternation, from a given projection -------------------------------------


def _opq_inputs(seed, n, m, k, ds):
    x = _correlated(seed, n, m * ds)
    proj = np.asarray(jopq.create_projection_matrix(j(x), m))
    cb = init_codebooks_random(t(x), _gen(seed), k, ds, t(proj)).numpy()
    return x, proj, cb


def test_one_opq_alternation_matches_jax():
    x, proj, cb = _opq_inputs(1, 400, 2, 8, 4)  # m * k = 16 >= d = 8
    got_r, got_cb = topq._alternate(t(x), t(proj), t(cb), 1)
    want_r, want_cb = jopq._alternate(j(x), j(proj), j(cb), 1)
    np.testing.assert_allclose(got_cb.numpy(), np.asarray(want_cb), atol=1e-5)
    # U V^T by SVD against 40 polar steps, both f32, on an 8 x 8 matrix.
    np.testing.assert_allclose(got_r.numpy(), np.asarray(want_r), atol=1e-4)
    assert _orthonormal_err(got_r) < 1e-5


@pytest.mark.parametrize("use_kernel", [False, True])
def test_opq_iteration_chunked_matches_jax(use_kernel):
    # use_kernel=True on CPU tensors takes the three kernels' plain versions.
    x, proj, cb = _opq_inputs(2, 500, 2, 8, 4)
    got_r, got_cb, got_e = topq._opq_iteration_chunked(
        t(x), t(proj), t(cb), chunk=128, use_kernel=use_kernel, compute_dtype=torch.float32)
    want_r, want_cb, want_e = jopq._opq_iteration_chunked(
        j(x), j(proj), j(cb), chunk=128, use_kernel=False, compute_dtype=jnp.float32)
    np.testing.assert_allclose(got_cb.numpy(), np.asarray(want_cb), atol=1e-5)
    np.testing.assert_allclose(got_r.numpy(), np.asarray(want_r), atol=1e-4)
    np.testing.assert_allclose(float(got_e), float(want_e), rtol=1e-4)
    # The chunked step is the in-memory step.
    mem_r, mem_cb = topq._alternate(t(x), t(proj), t(cb), 1)
    np.testing.assert_allclose(got_cb.numpy(), mem_cb.numpy(), atol=1e-5)
    np.testing.assert_allclose(got_r.numpy(), mem_r.numpy(), atol=1e-4)


def test_train_opq_chunked_from_initial_model_matches_jax():
    x, proj, cb = _opq_inputs(3, 500, 2, 8, 4)
    got = trt.train_opq_chunked(
        None, t(x), 2, 3, 2, chunk=200, initial_model=trt.Pq(codebooks=t(cb), projection=t(proj)))
    want = jrt.train_opq_chunked(
        jax.random.PRNGKey(0), j(x), 2, 3, 2, chunk=200, use_kernel=False,
        initial_model=jrt.Pq(codebooks=j(cb), projection=j(proj)))
    # Two alternations: the second starts from rotations 1e-6 apart.
    np.testing.assert_allclose(got.codebooks.numpy(), np.asarray(want.codebooks), atol=1e-4)
    np.testing.assert_allclose(got.projection.numpy(), np.asarray(want.projection), atol=1e-3)


def test_rank_deficient_cross_matrix_still_gives_a_rotation():
    # m * k = 4 < d = 8: X^T X_hat has rank 4 at most, the completion is free.
    x = _uniform(4, 200, 8)
    pq = trt.train_opq(_gen(0), t(x), 2, 1, 3)
    assert _orthonormal_err(pq.projection) < 1e-5
    chunked = trt.train_opq_chunked(_gen(0), t(x), 2, 1, 3, chunk=64)
    assert _orthonormal_err(chunked.projection) < 1e-5
    assert bool(torch.isfinite(chunked.codebooks).all())


# -- from a draw: the slice as a whole -------------------------------------------------


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_train_opq_encode_reconstruct_meets_the_gate(seed):
    x = t(_uniform(300 + seed, 256, 20))
    pq = trt.train_opq(_gen(seed), x, 10, 7, 10)
    assert tuple(pq.codebooks.shape) == (10, 128, 2) and tuple(pq.projection.shape) == (20, 20)
    assert _orthonormal_err(pq.projection) < 1e-5
    assert _gate_loss(pq, x) < 0.10


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_train_gaussian_opq_encode_reconstruct_meets_the_gate(seed):
    x = t(_uniform(400 + seed, 256, 20))
    pq = trt.train_gaussian_opq(_gen(seed), x, 10, 7, 10, 1)
    assert _orthonormal_err(pq.projection) < 1e-5
    assert _gate_loss(pq, x) < 0.12


@pytest.mark.parametrize("seed", [0, 1])
def test_chunked_opq_trainers_meet_the_gates(seed):
    x = t(_uniform(500 + seed, 256, 20))
    opq = trt.train_opq_chunked(_gen(seed), x, 10, 7, 10, chunk=64)
    assert _gate_loss(opq, x) < 0.10
    gauss = trt.train_gaussian_opq_chunked(_gen(seed), x, 10, 7, 10, chunk=64)
    assert _gate_loss(gauss, x) < 0.12
    assert _orthonormal_err(opq.projection) < 1e-5 and _orthonormal_err(gauss.projection) < 1e-5


def test_gaussian_opq_chunked_is_the_in_memory_trainer_in_chunks():
    x = t(_correlated(5, 400, 8))
    a = trt.train_gaussian_opq(_gen(7), x, 2, 3, 4)
    b = trt.train_gaussian_opq_chunked(_gen(7), x, 2, 3, 4, chunk=128)
    np.testing.assert_array_equal(a.projection.numpy(), b.projection.numpy())
    # The same draws; sums taken per chunk instead of at once.
    np.testing.assert_allclose(a.codebooks.numpy(), b.codebooks.numpy(), atol=1e-5)


def test_opq_checkpoint_and_resume(tmp_path):
    x, proj, cb = _opq_inputs(6, 300, 2, 8, 4)
    init = trt.Pq(codebooks=t(cb), projection=t(proj))
    path = tmp_path / "opq.npz"
    whole = trt.train_opq_chunked(None, t(x), 2, 3, 3, chunk=100, initial_model=init)
    trt.train_opq_chunked(None, t(x), 2, 3, 2, chunk=100, initial_model=init,
                          checkpoint_every=1, checkpoint_path=str(path))
    loaded = trt.io.load(path, device="cpu")
    resumed = trt.train_opq_chunked(None, t(x), 2, 3, 1, chunk=100, initial_model=loaded)
    np.testing.assert_array_equal(resumed.codebooks.numpy(), whole.codebooks.numpy())
    np.testing.assert_array_equal(resumed.projection.numpy(), whole.projection.numpy())
    # The JAX package loads the trained model and encodes the same codes.
    jpq = jrt.io.load(path)
    np.testing.assert_array_equal(
        np.asarray(jpq.quantize_batch(j(x))), loaded.quantize_batch(t(x)).numpy())


def test_opq_argument_errors_match_jax(tmp_path):
    x = _uniform(7, 64, 8)
    key = jax.random.PRNGKey(0)
    cb_ok, cb_wrong = np.zeros((2, 8, 4), np.float32), np.zeros((2, 4, 4), np.float32)
    proj = orthonormal(8, 8)
    cases = [
        dict(checkpoint_every=2),
        dict(checkpoint_every=0, checkpoint_path=str(tmp_path / "c.npz")),
        dict(initial=(cb_ok, None)),
        dict(initial=(cb_wrong, proj)),
    ]
    for case in cases:
        case = dict(case)
        initial = case.pop("initial", None)
        tinit = jinit = None
        if initial is not None:
            cb, pr = initial
            tinit = trt.Pq(codebooks=t(cb), projection=None if pr is None else t(pr))
            jinit = jrt.Pq(codebooks=j(cb), projection=None if pr is None else j(pr))
        with pytest.raises(ValueError) as terr:
            trt.train_opq_chunked(_gen(0), t(x), 2, 3, 2, initial_model=tinit, **case)
        with pytest.raises(ValueError) as jerr:
            jrt.train_opq_chunked(key, j(x), 2, 3, 2, use_kernel=False, initial_model=jinit, **case)
        assert str(terr.value) == str(jerr.value)
    for trainer in ("train_opq", "train_opq_chunked", "train_gaussian_opq", "train_gaussian_opq_chunked"):
        with pytest.raises(trt.errors.ReductiveError) as terr:
            getattr(trt, trainer)(_gen(0), t(x), 3, 3, 2)
        with pytest.raises(jrt.errors.ReductiveError) as jerr:
            getattr(jrt, trainer)(key, j(x), 3, 3, 2)
        assert str(terr.value) == str(jerr.value)


def test_verified_is_not_ported_and_says_so():
    """``compute_dtype="verified"`` is ported (the name dates from when it
    raised): both chunked OPQ trainers take it, on both routes, and train to
    what the f32 mode trains to from the same draw."""
    x = t(_uniform(9, 64, 8))
    for trainer in (trt.train_opq_chunked, trt.train_gaussian_opq_chunked):
        want = trainer(_gen(0), x, 2, 3, 2, use_kernel=False)
        for use_kernel in (False, True):
            got = trainer(_gen(0), x, 2, 3, 2, compute_dtype="verified", use_kernel=use_kernel)
            np.testing.assert_allclose(got.codebooks.numpy(), want.codebooks.numpy(), atol=1e-5)
            np.testing.assert_allclose(got.projection.numpy(), want.projection.numpy(), atol=1e-4)
    with pytest.raises(ValueError, match='or "verified", got exact'):
        trt.train_opq_chunked(_gen(0), x, 2, 3, 2, compute_dtype="exact")


@pytest.mark.parametrize("use_kernel", [False, True])
def test_opq_iteration_chunked_verified_matches_jax(use_kernel):
    # The JAX package runs the verified mode on the CPU with its kernels off;
    # use_kernel=True here is the verified wrappers over their plain versions.
    x, proj, cb = _opq_inputs(12, 500, 2, 8, 4)
    got_r, got_cb, got_e = topq._opq_iteration_chunked(
        t(x), t(proj), t(cb), chunk=128, use_kernel=use_kernel, compute_dtype="verified")
    want_r, want_cb, want_e = jopq._opq_iteration_chunked(
        j(x), j(proj), j(cb), chunk=128, use_kernel=False, compute_dtype="verified")
    np.testing.assert_allclose(got_cb.numpy(), np.asarray(want_cb), atol=1e-5)
    np.testing.assert_allclose(got_r.numpy(), np.asarray(want_r), atol=1e-4)
    np.testing.assert_allclose(float(got_e), float(want_e), rtol=1e-4)
    # An exact mode: the f32 step's result.
    f32_r, f32_cb, _ = topq._opq_iteration_chunked(
        t(x), t(proj), t(cb), chunk=128, use_kernel=False, compute_dtype=torch.float32)
    np.testing.assert_allclose(got_cb.numpy(), f32_cb.numpy(), atol=1e-6)
    np.testing.assert_allclose(got_r.numpy(), f32_r.numpy(), atol=1e-5)


@pytest.mark.parametrize("use_kernel", [False, True])
def test_train_opq_chunked_verified_matches_jax(use_kernel):
    x, proj, cb = _opq_inputs(13, 500, 2, 8, 4)
    got = trt.train_opq_chunked(
        None, t(x), 2, 3, 2, chunk=200, initial_model=trt.Pq(codebooks=t(cb), projection=t(proj)),
        compute_dtype="verified", use_kernel=use_kernel)
    want = jrt.train_opq_chunked(
        jax.random.PRNGKey(0), j(x), 2, 3, 2, chunk=200, use_kernel=False,
        initial_model=jrt.Pq(codebooks=j(cb), projection=j(proj)), compute_dtype="verified")
    # Two alternations: the second starts from rotations 1e-6 apart.
    np.testing.assert_allclose(got.codebooks.numpy(), np.asarray(want.codebooks), atol=1e-4)
    np.testing.assert_allclose(got.projection.numpy(), np.asarray(want.projection), atol=1e-3)


def test_verified_opq_step_encodes_with_the_verified_encode(monkeypatch):
    from reductive_tpu_torch.ops import assign as tassign

    calls = []
    real = tassign.pq_encode_verified

    def spy(codebooks, x, **kwargs):
        calls.append(tuple(x.shape))
        return real(codebooks, x, **kwargs)

    monkeypatch.setattr(tassign, "pq_encode_verified", spy)
    x, proj, cb = _opq_inputs(14, 300, 2, 8, 4)
    topq._opq_iteration_chunked(
        t(x), t(proj), t(cb), chunk=128, use_kernel=True, compute_dtype="verified")
    assert calls == [(128, 8), (128, 8), (44, 8)]
    calls.clear()
    topq._opq_iteration_chunked(
        t(x), t(proj), t(cb), chunk=128, use_kernel=True, compute_dtype=torch.float32)
    assert calls == []


def test_opq_traits():
    x = t(_uniform(10, 256, 20))
    a = trt.Opq.train_pq_using(10, 7, 5, 1, x, _gen(3))
    b = trt.train_opq(_gen(3), x, 10, 7, 5)
    np.testing.assert_array_equal(a.codebooks.numpy(), b.codebooks.numpy())
    np.testing.assert_array_equal(a.projection.numpy(), b.projection.numpy())
    g = trt.GaussianOpq.train_pq(10, 7, 10, 1, x)  # seeded from entropy
    assert _gate_loss(g, x) < 0.12
