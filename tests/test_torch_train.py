"""reductive_tpu_torch.pq.train (and pq.traits) against reductive_tpu.pq.train
on the CPU.

torch cannot replay JAX's random streams: parity tests hand both packages
the same initial centroids (``train_pq_subspace_with_centroids``,
``initial_model=``) and the same projection; what starts from a draw is held
to the reference's quality gate under several seeds.
"""

import logging

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import reductive_tpu as jrt
import reductive_tpu_torch as trt
from reductive_tpu.pq import train as jtrain
from reductive_tpu_torch import errors as terrors
from reductive_tpu_torch.pq import train as ttrain

from torch_port_util import j, make_pq_data, orthonormal, t


def _gen(seed):
    return torch.Generator().manual_seed(seed)


def _uniform(seed, n, d):
    return np.random.default_rng(seed).random((n, d), dtype=np.float32)


def _gate_loss(pq, x):
    """The reference's quality measure: mean Euclidean reconstruction error."""
    rec = pq.reconstruct_batch(pq.quantize_batch(x))
    return float((x - rec).pow(2).sum(dim=1).sqrt().mean())


# -- the same inputs through both packages --------------------------------------


def test_train_pq_subspace_with_centroids_matches_jax():
    n, m, k, ds, attempts = 300, 3, 8, 4, 2
    rng = np.random.default_rng(0)
    xs = rng.random((n, m, ds), dtype=np.float32)
    initial = np.stack([
        np.stack([xs[rng.choice(n, k, replace=False), jq] for jq in range(m)])
        for _ in range(attempts)])
    cb, losses = ttrain.train_pq_subspace_with_centroids(t(xs), t(initial), 6)
    jcb, jlosses = jtrain.train_pq_subspace_with_centroids(j(xs), j(initial), 6)
    assert tuple(cb.shape) == (m, k, ds) and tuple(losses.shape) == (m,)
    # Means of f32 sums in another order, six iterations on values in [0, 1].
    np.testing.assert_allclose(cb.numpy(), np.asarray(jcb), atol=1e-5)
    np.testing.assert_allclose(losses.numpy(), np.asarray(jlosses), rtol=1e-4)


def test_best_of_attempts_keeps_the_first_minimum():
    codebooks = torch.arange(3 * 2 * 1 * 1, dtype=torch.float32).reshape(3, 2, 1, 1)
    losses = torch.tensor([[0.5, 0.2], [0.1, 0.2], [0.1, 0.3]])
    cb, best = ttrain._best_of_attempts(codebooks, losses)
    jcb, jbest = jtrain._best_of_attempts(j(codebooks.numpy()), j(losses.numpy()))
    np.testing.assert_array_equal(cb.numpy(), np.asarray(jcb))
    np.testing.assert_array_equal(best.numpy(), np.asarray(jbest))
    np.testing.assert_array_equal(cb.numpy()[:, 0, 0], [2.0, 1.0])  # attempts 1 and 0


@pytest.mark.parametrize("chunk", [256, 1000, 4096])
@pytest.mark.parametrize("use_kernel", [False, True])
def test_lloyd_iteration_chunked_matches_jax_and_in_memory(chunk, use_kernel):
    # use_kernel=True on CPU tensors takes the kernel's plain version.
    n, m, k, ds = 1000, 4, 8, 4
    x = _uniform(0, n, m * ds)
    cb = np.random.default_rng(1).standard_normal((m, k, ds), dtype=np.float32)
    sumsq = (x.reshape(n, m, ds) ** 2).sum(axis=(0, 2))
    new, losses = ttrain.lloyd_iteration_chunked(
        t(x), t(cb), t(sumsq), chunk=chunk, use_kernel=use_kernel)
    jnew, jlosses = jtrain.lloyd_iteration_chunked(j(x), j(cb), j(sumsq), chunk=chunk, use_kernel=False)
    np.testing.assert_allclose(new.numpy(), np.asarray(jnew), atol=1e-5)
    np.testing.assert_allclose(losses.numpy(), np.asarray(jlosses), rtol=1e-4)
    ref, ref_losses = trt.kmeans.lloyd_iteration_batched(
        t(x).reshape(n, m, ds).transpose(0, 1).contiguous(), t(cb))
    np.testing.assert_allclose(new.numpy(), ref.numpy(), atol=1e-5)
    np.testing.assert_allclose(losses.numpy(), ref_losses.numpy(), rtol=1e-4)
    np.testing.assert_allclose(
        ttrain._streamed_sumsq(t(x), m, chunk=chunk).numpy(), sumsq, rtol=1e-5)


def test_lloyd_iteration_chunked_empty_cluster_zero_vector():
    x = torch.ones((16, 4))
    one = torch.stack([torch.ones(2), torch.full((2,), 100.0)])
    cb = torch.stack([one, one])  # (m=2, k=2, ds=2): the far centroid is never assigned
    sumsq = (x.reshape(16, 2, 2) ** 2).sum(dim=(0, 2))
    new, loss = ttrain.lloyd_iteration_chunked(x, cb, sumsq, chunk=8, use_kernel=False)
    np.testing.assert_array_equal(new[:, 1, :].numpy(), 0.0)
    np.testing.assert_array_equal(new[:, 0, :].numpy(), 1.0)
    np.testing.assert_allclose(loss.numpy(), 0.0, atol=1e-6)


def test_statistics_formulas_match_jax():
    rng = np.random.default_rng(2)
    sums = rng.standard_normal((3, 5, 4), dtype=np.float32) * 7
    counts = rng.integers(0, 4, (3, 5)).astype(np.float32)  # some cells empty
    sumsq = np.float32(500.0) + rng.random(3, dtype=np.float32)
    np.testing.assert_allclose(
        ttrain.centroids_from_stats(t(sums), t(counts), torch.float32).numpy(),
        np.asarray(jtrain.centroids_from_stats(j(sums), j(counts), jnp.float32)), rtol=1e-6)
    np.testing.assert_allclose(
        ttrain.losses_from_stats(t(sums), t(counts), t(sumsq), 120).numpy(),
        np.asarray(jtrain.losses_from_stats(j(sums), j(counts), j(sumsq), 120)), rtol=1e-5)
    assert (ttrain.centroids_from_stats(t(sums), t(counts), torch.float32).numpy()[counts == 0] == 0).all()


@pytest.mark.parametrize("compute", ["f32", "bf16"])
def test_assign_stats_streamed_with_projection_matches_jax(compute):
    cb, x = make_pq_data(3, 700, 4, 8, 4)
    proj = orthonormal(4, 16)
    tcd, jcd = {"f32": (torch.float32, jnp.float32), "bf16": (torch.bfloat16, jnp.bfloat16)}[compute]
    sums, counts = ttrain.assign_stats_streamed(
        t(x), t(cb), chunk=256, use_kernel=False, compute_dtype=tcd, projection=t(proj))
    jsums, jcounts = jtrain.assign_stats_streamed(
        j(x), j(cb), chunk=256, use_kernel=False, compute_dtype=jcd, projection=j(proj))
    # Both assign with the exact f32 path on this route; the rotation's f32
    # rounding may flip a near-tie, which moves one row: none does at this seed.
    np.testing.assert_array_equal(counts.numpy(), np.asarray(jcounts))
    np.testing.assert_allclose(sums.numpy(), np.asarray(jsums), rtol=1e-5, atol=1e-4)


@pytest.mark.parametrize("with_projection", [False, True])
def test_train_pq_chunked_from_initial_model_matches_jax(with_projection):
    n, m, bits, ds = 600, 4, 3, 4
    x = _uniform(5, n, m * ds)
    proj = orthonormal(6, m * ds) if with_projection else None
    rows = x @ proj if with_projection else x
    init = np.stack([rows[10 * jq:10 * jq + 2 ** bits, jq * ds:(jq + 1) * ds] for jq in range(m)])
    got = trt.train_pq_chunked(
        None, t(x), m, bits, 5, chunk=256, projection=None if proj is None else t(proj),
        initial_model=trt.Pq(codebooks=t(init)))
    want = jrt.train_pq_chunked(
        jax.random.PRNGKey(0), j(x), m, bits, 5, chunk=256, use_kernel=False,
        projection=None if proj is None else j(proj), initial_model=jrt.Pq(codebooks=j(init)))
    np.testing.assert_allclose(got.codebooks.numpy(), np.asarray(want.codebooks), atol=1e-5)
    if with_projection:
        np.testing.assert_array_equal(got.projection.numpy(), proj)
    else:
        assert got.projection is None


def test_use_kernel_none_on_the_cpu_is_the_plain_tensor_route(monkeypatch):
    from reductive_tpu_torch.ops import stats as tstats

    def no_kernel(*args, **kwargs):
        raise AssertionError("the kernel route was taken on a CPU tensor")

    monkeypatch.setattr(tstats, "pq_assign_stats", no_kernel)
    x = t(_uniform(7, 200, 8))
    pq = trt.train_pq_chunked(_gen(0), x, 2, 3, 2, chunk=64)
    assert tuple(pq.codebooks.shape) == (2, 8, 4)
    with pytest.raises(AssertionError, match="kernel route"):
        trt.train_pq_chunked(_gen(0), x, 2, 3, 2, chunk=64, use_kernel=True)


def test_kernel_route_and_plain_route_agree():
    x = t(_uniform(8, 500, 16))
    init = trt.Pq(codebooks=ttrain.init_codebooks_random(x, _gen(1), 8, 4))
    a = trt.train_pq_chunked(None, x, 4, 3, 4, chunk=128, use_kernel=True, initial_model=init)
    b = trt.train_pq_chunked(None, x, 4, 3, 4, chunk=128, use_kernel=False, initial_model=init)
    np.testing.assert_allclose(a.codebooks.numpy(), b.codebooks.numpy(), atol=1e-5)


# -- attempts, checkpoints, resume ----------------------------------------------


def test_train_pq_chunked_keeps_the_best_attempt_per_subquantizer(monkeypatch):
    n, m, k, ds = 400, 3, 8, 4
    x = t(_uniform(9, n, m * ds))
    inits = [ttrain.init_codebooks_random(x, _gen(s), k, ds) for s in (1, 2, 3)]
    alone = []
    for init in inits:
        sumsq = ttrain._streamed_sumsq(x, m, chunk=128)
        cb, loss = init, None
        for _ in range(3):
            cb, loss = ttrain.lloyd_iteration_chunked(x, cb, sumsq, chunk=128, use_kernel=False)
        alone.append((cb, loss))
    queue = list(inits)
    monkeypatch.setattr(ttrain, "init_codebooks_random", lambda *a, **kw: queue.pop(0))
    pq = trt.train_pq_chunked(_gen(0), x, m, 3, 3, 3, chunk=128)
    losses = torch.stack([loss for _, loss in alone])
    best = torch.argmin(losses, dim=0)  # the first minimum: ties keep the earlier attempt
    assert len(set(best.tolist())) > 1  # the subquantizers do not all take one attempt
    for jq in range(m):
        np.testing.assert_array_equal(pq.codebooks[jq].numpy(), alone[int(best[jq])][0][jq].numpy())


def test_checkpoint_resume_and_cross_loading(tmp_path):
    x = t(_uniform(10, 300, 8))
    init = trt.Pq(codebooks=ttrain.init_codebooks_random(x, _gen(4), 8, 4))
    path = tmp_path / "ckpt.npz"
    whole = trt.train_pq_chunked(None, x, 2, 3, 5, chunk=100, initial_model=init)
    first = trt.train_pq_chunked(None, x, 2, 3, 3, chunk=100, initial_model=init,
                                 checkpoint_every=2, checkpoint_path=str(path))
    # Written after iterations 2 and 3: the file holds the final state.
    loaded = trt.io.load(path, device="cpu")
    np.testing.assert_array_equal(loaded.codebooks.numpy(), first.codebooks.numpy())
    resumed = trt.train_pq_chunked(None, x, 2, 3, 2, chunk=100, initial_model=loaded)
    np.testing.assert_array_equal(resumed.codebooks.numpy(), whole.codebooks.numpy())

    # A model trained here loads in the JAX package and encodes the same codes there.
    trt.io.save(path, whole)
    jpq = jrt.io.load(path)
    np.testing.assert_array_equal(np.asarray(jpq.codebooks), whole.codebooks.numpy())
    np.testing.assert_array_equal(
        np.asarray(jpq.quantize_batch(j(x.numpy()))), whole.quantize_batch(x).numpy())
    cb, proj = trt.convert.to_numpy(whole)
    assert proj is None
    np.testing.assert_array_equal(
        np.asarray(jrt.Pq(codebooks=j(cb)).quantize_batch(j(x.numpy()))),
        whole.quantize_batch(x).numpy())


def test_train_pq_chunked_argument_errors_match_jax(tmp_path):
    x = _uniform(11, 64, 8)
    key = jax.random.PRNGKey(0)
    wrong = np.zeros((2, 4, 4), dtype=np.float32)
    ok = np.zeros((2, 8, 4), dtype=np.float32)
    cases = [
        dict(checkpoint_every=2),
        dict(checkpoint_every=0, checkpoint_path=str(tmp_path / "c.npz")),
        dict(n_attempts=2, initial=ok),
        dict(initial=wrong),
    ]
    for case in cases:
        case = dict(case)
        attempts = case.pop("n_attempts", 1)
        initial = case.pop("initial", None)
        with pytest.raises(ValueError) as terr:
            trt.train_pq_chunked(
                _gen(0), t(x), 2, 3, 2, attempts,
                initial_model=None if initial is None else trt.Pq(codebooks=t(initial)), **case)
        with pytest.raises(ValueError) as jerr:
            jrt.train_pq_chunked(
                key, j(x), 2, 3, 2, attempts, use_kernel=False,
                initial_model=None if initial is None else jrt.Pq(codebooks=j(initial)), **case)
        assert str(terr.value) == str(jerr.value)


@pytest.mark.parametrize(
    "args,error",
    [((0, 3, 2, 1), "NSubquantizersOutsideRange"), ((3, 3, 2, 1), "IncorrectNumberSubquantizers"),
     ((2, 0, 2, 1), "IncorrectNSubquantizerBits"), ((2, 7, 2, 1), "IncorrectNSubquantizerBits"),
     ((2, 3, 0, 1), "IncorrectNIterations"), ((2, 3, 2, 0), "IncorrectNAttempts")],
)
@pytest.mark.parametrize("trainer", ["train_pq", "train_pq_chunked"])
def test_hyperparameter_errors_match_jax(trainer, args, error):
    x = _uniform(12, 64, 8)
    with pytest.raises(terrors.ReductiveError) as terr:
        getattr(trt, trainer)(_gen(0), t(x), *args)
    with pytest.raises(jrt.errors.ReductiveError) as jerr:
        getattr(jrt, trainer)(jax.random.PRNGKey(0), j(x), *args)
    assert type(terr.value).__name__ == type(jerr.value).__name__ == error
    assert str(terr.value) == str(jerr.value)


def test_verified_is_not_ported_and_says_so():
    """``compute_dtype="verified"`` is ported (the name dates from when it
    raised): every entry that once refused it takes it, on both routes, and
    gives the f32 route's statistics; what is no mode still raises."""
    x = t(_uniform(13, 64, 8))
    cb = t(make_pq_data(14, 1, 2, 8, 4)[0])
    sumsq = ttrain._streamed_sumsq(x, 2, chunk=64)
    for use_kernel in (False, True):
        a = trt.train_pq_chunked(_gen(0), x, 2, 3, 2, compute_dtype="verified", use_kernel=use_kernel)
        b = trt.train_pq_chunked(_gen(0), x, 2, 3, 2, use_kernel=False)
        np.testing.assert_allclose(a.codebooks.numpy(), b.codebooks.numpy(), atol=1e-6)
        new, loss = ttrain.lloyd_iteration_chunked(
            x, cb, sumsq, compute_dtype="verified", use_kernel=use_kernel)
        want_new, want_loss = ttrain.lloyd_iteration_chunked(x, cb, sumsq, use_kernel=False)
        np.testing.assert_allclose(new.numpy(), want_new.numpy(), atol=1e-6)
        np.testing.assert_allclose(loss.numpy(), want_loss.numpy(), rtol=1e-5)
        sums, counts = ttrain.assign_stats_streamed(
            x, cb, compute_dtype="verified", use_kernel=use_kernel)
        want_sums, want_counts = ttrain.assign_stats_streamed(x, cb, use_kernel=False)
        np.testing.assert_array_equal(counts.numpy(), want_counts.numpy())
        np.testing.assert_allclose(sums.numpy(), want_sums.numpy(), rtol=1e-5, atol=1e-5)
    assert ttrain.is_verified("verified") and not ttrain.is_verified(torch.float32)
    with pytest.raises(ValueError, match="compute_dtype must be"):
        trt.train_pq_chunked(_gen(0), x, 2, 3, 2, compute_dtype=torch.float16)
    with pytest.raises(ValueError, match='or "verified", got exact'):
        trt.train_pq_chunked(_gen(0), x, 2, 3, 2, compute_dtype="exact")


@pytest.mark.parametrize("use_kernel", [False, True])
@pytest.mark.parametrize("with_projection", [False, True])
def test_train_pq_chunked_verified_matches_jax(with_projection, use_kernel):
    # The slice as a whole: the same initial codebooks through both packages'
    # chunked trainer in the verified mode.  The JAX package runs it on the CPU
    # with its kernels off (the exact einsum statistics); use_kernel=True here
    # is the verify kernel's plain version plus the wrapper's correction.
    n, m, bits, ds = 600, 4, 3, 4
    x = _uniform(15, n, m * ds)
    proj = orthonormal(16, m * ds) if with_projection else None
    rows = x @ proj if with_projection else x
    init = np.stack([rows[10 * jq:10 * jq + 2 ** bits, jq * ds:(jq + 1) * ds] for jq in range(m)])
    got = trt.train_pq_chunked(
        None, t(x), m, bits, 5, chunk=256, projection=None if proj is None else t(proj),
        initial_model=trt.Pq(codebooks=t(init)), compute_dtype="verified", use_kernel=use_kernel)
    want = jrt.train_pq_chunked(
        jax.random.PRNGKey(0), j(x), m, bits, 5, chunk=256, use_kernel=False,
        projection=None if proj is None else j(proj), initial_model=jrt.Pq(codebooks=j(init)),
        compute_dtype="verified")
    np.testing.assert_allclose(got.codebooks.numpy(), np.asarray(want.codebooks), atol=1e-5)


def test_verified_kernel_route_calls_the_verified_statistics(monkeypatch):
    from reductive_tpu_torch.ops import stats as tstats

    calls = []
    real = tstats.pq_assign_stats_verified

    def spy(codebooks, x, **kwargs):
        calls.append(tuple(x.shape))
        return real(codebooks, x, **kwargs)

    def not_this(*args, **kwargs):
        raise AssertionError("the unverified kernel route was taken")

    monkeypatch.setattr(tstats, "pq_assign_stats_verified", spy)
    monkeypatch.setattr(tstats, "pq_assign_stats", not_this)
    x = t(_uniform(17, 300, 8))
    trt.train_pq_chunked(_gen(0), x, 2, 3, 3, chunk=128, compute_dtype="verified", use_kernel=True)
    assert calls == [(300, 8)] * 3  # no projection: one call over all rows per iteration
    calls.clear()
    cb = t(make_pq_data(18, 1, 2, 8, 4)[0])
    ttrain.assign_stats_streamed(x, cb, chunk=128, use_kernel=True, compute_dtype="verified",
                                 projection=t(orthonormal(19, 8)))
    assert calls == [(128, 8), (128, 8), (44, 8)]


def test_verified_checkpoint_and_resume(tmp_path):
    x = t(_uniform(20, 400, 8))
    path = tmp_path / "pq.npz"
    saved = trt.train_pq_chunked(_gen(1), x, 2, 3, 4, chunk=128, compute_dtype="verified",
                                 checkpoint_every=2, checkpoint_path=str(path))
    loaded = trt.io.load(path, device="cpu")
    np.testing.assert_array_equal(loaded.codebooks.numpy(), saved.codebooks.numpy())
    resumed = trt.train_pq_chunked(None, x, 2, 3, 1, chunk=128, compute_dtype="verified",
                                   initial_model=loaded)
    one_more = trt.train_pq_chunked(None, x, 2, 3, 1, chunk=128, initial_model=loaded)
    np.testing.assert_allclose(resumed.codebooks.numpy(), one_more.codebooks.numpy(), atol=1e-6)


# -- from a draw: the slice as a whole -------------------------------------------


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_train_pq_encode_reconstruct_meets_the_gate(seed):
    # The reference's gate scenario: 256 uniform vectors of 20, m=10, 7 bits.
    x = t(_uniform(100 + seed, 256, 20))
    pq = trt.train_pq(_gen(seed), x, 10, 7, 10, 1)
    assert tuple(pq.codebooks.shape) == (10, 128, 2) and pq.projection is None
    assert _gate_loss(pq, x) < 0.08
    codes = pq.quantize_batch(x)
    assert codes.dtype == torch.uint8 and tuple(codes.shape) == (256, 10)


@pytest.mark.parametrize("seed", [0, 1])
def test_train_pq_chunked_quality_and_attempts(seed):
    x = t(_uniform(200 + seed, 256, 20))
    chunked = _gate_loss(trt.train_pq_chunked(_gen(seed), x, 10, 7, 10, 2, chunk=64), x)
    in_memory = _gate_loss(trt.train_pq(_gen(seed), x, 10, 7, 10, 2), x)
    assert chunked < 0.08
    assert abs(chunked - in_memory) < 0.01
    bf16 = trt.train_pq_chunked(_gen(seed), x, 10, 7, 10, chunk=64, use_kernel=True,
                                compute_dtype=torch.bfloat16)
    # bf16 products put about 2^-8 of |c||x| on every distance, which at two
    # points a cluster is of the order of the clusters' spacing squared: some
    # rows go to a neighbouring centroid.  Looser than the f32 gate, and finite.
    assert _gate_loss(bf16, x) < 0.11


def test_init_codebooks_random_rotates_only_the_drawn_rows():
    x = t(_uniform(14, 100, 8))
    proj = t(orthonormal(15, 8))
    plain = ttrain.init_codebooks_random(x, _gen(3), 4, 4)
    rotated = ttrain.init_codebooks_random(x, _gen(3), 4, 4, proj)
    assert tuple(plain.shape) == tuple(rotated.shape) == (2, 4, 4)
    rows = {tuple(r) for r in np.round(x.numpy().reshape(100, 2, 4)[:, 0], 5).tolist()}
    assert all(tuple(r) in rows for r in np.round(plain[0].numpy(), 5).tolist())
    # The same draws (same seed), rotated: rows of x @ proj, column-sliced.
    rx = torch.matmul(x, proj).numpy().reshape(100, 2, 4)
    for jq in range(2):
        pool = {tuple(r) for r in np.round(rx[:, jq], 4).tolist()}
        assert all(tuple(r) in pool for r in np.round(rotated[jq].numpy(), 4).tolist())
    assert len({tuple(r) for r in plain[1].tolist()}) == 4  # distinct instances


def test_traits_take_the_reference_argument_order():
    x = t(_uniform(16, 256, 20))
    a = trt.PqTrainer.train_pq_using(10, 7, 10, 1, x, _gen(5))
    b = trt.train_pq(_gen(5), x, 10, 7, 10, 1)
    np.testing.assert_array_equal(a.codebooks.numpy(), b.codebooks.numpy())
    c = trt.PqTrainer.train_pq(10, 7, 10, 1, x)  # seeded from entropy
    assert _gate_loss(c, x) < 0.08
    from reductive_tpu_torch.pq import entropy_generator

    assert entropy_generator("cpu").initial_seed() != entropy_generator("cpu").initial_seed()
    assert trt.pq.Opq is trt.Opq and trt.pq.GaussianOpq is trt.GaussianOpq


def test_iterations_are_logged_under_the_reference_logger(caplog):
    x = t(_uniform(17, 128, 8))
    with caplog.at_level(logging.INFO, logger="reductive_tpu"):
        trt.train_pq_chunked(_gen(0), x, 2, 3, 3, chunk=64)
    lines = [r.getMessage() for r in caplog.records if r.name == "reductive_tpu"]
    assert lines[0].startswith("Training 2 PQ subquantizers chunked (k=8, 3 iterations")
    assert [ln.split(":")[0] for ln in lines[1:]] == [f"Lloyd's iteration {i}" for i in range(3)]
