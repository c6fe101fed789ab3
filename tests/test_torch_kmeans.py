"""reductive_tpu_torch.kmeans against reductive_tpu.kmeans on the CPU.

torch cannot replay JAX's random streams, so the parity tests feed both
packages the same initial centroids; what depends on a draw is tested as a
distribution or on data where every draw leads to the same answer.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from reductive_tpu import kmeans as jk
from reductive_tpu_torch import kmeans as tk

from torch_port_util import j, t


def _gen(seed):
    return torch.Generator().manual_seed(seed)


def _uniform(seed, n, d):
    return np.random.default_rng(seed).random((n, d), dtype=np.float32)


def gaussian_spheres(seed, centers, n_samples=11, sigma=0.01):
    centers = np.asarray(centers, dtype=np.float32)
    noise = sigma * np.random.default_rng(seed).standard_normal(
        (centers.shape[0], n_samples, centers.shape[1])).astype(np.float32)
    return (centers[:, None, :] + noise).reshape(-1, centers.shape[1])


# -- goldens of the reference's unit tests ------------------------------------


def test_correct_cluster_assignments():
    centroids = t(np.array(
        [[0.5, 0.0, 0.0], [0.0, -1.0, 0.0], [0.0, 0.0, 1.0], [0.0, 1.0, 1.0]], dtype=np.float32))
    instances = t(np.array(
        [[0.0, 0.5, 0.0], [0.0, 0.0, 2.0], [1.0, 0.0, 0.0], [0.0, 0.0, 1.0],
         [0.0, -2.0, 0.0], [0.0, 0.7, 0.7], [0.0, 0.0, 0.0]], dtype=np.float32))
    want = [0, 2, 0, 2, 1, 3, 0]
    got = tk.cluster_assignments(centroids, instances)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    for i, expected in enumerate(want):
        assert int(tk.cluster_assignment(centroids, instances[i])) == expected


def test_correct_update_centroids():
    instances = t(np.array(
        [[-1.0, -1.0, 0.0], [1.0, 1.0, 0.0], [-2.0, -1.0, 0.0],
         [0.0, 0.0, 0.0], [0.0, 0.0, 1.0], [0.0, 0.0, 2.0]], dtype=np.float32))
    updated = tk.update_centroids(instances, torch.tensor([1, 0, 1, 0, 2, 2]), 3)
    np.testing.assert_array_equal(
        updated.numpy(), [[0.5, 0.5, 0.0], [-1.5, -1.0, 0.0], [0.0, 0.0, 1.5]])


def test_empty_cluster_becomes_zero_vector():
    instances = t(np.array([[1.0, 1.0], [3.0, 3.0]], dtype=np.float32))
    updated = tk.update_centroids(instances, torch.tensor([0, 0], dtype=torch.int32), 3)
    np.testing.assert_array_equal(updated.numpy(), [[2.0, 2.0], [0.0, 0.0], [0.0, 0.0]])
    # Through a whole iteration too: the far centroid gets no instance.
    new, loss = tk.kmeans_iteration(instances, t(np.array([[2.0, 2.0], [99.0, 99.0]], np.float32)))
    np.testing.assert_array_equal(new.numpy(), [[2.0, 2.0], [0.0, 0.0]])
    assert float(loss) == 1.0


def test_correct_mean_squared_error():
    centroids = t(np.array([[-1.0, 2.0, 0.0], [0.0, -1.0, 1.0]], dtype=np.float32))
    instances = t(np.array([[-1.0, 1.0, 1.0], [0.0, 1.0, 0.0]], dtype=np.float32))
    mse = tk.mean_squared_error(centroids, instances, torch.tensor([1, 0]))
    assert float(mse) == pytest.approx(7.0 / 6.0)  # divided by n * d, not by n


# -- the same inputs through both packages --------------------------------------


def test_one_lloyd_step_matches_jax():
    x = _uniform(0, 300, 6)
    init = x[:9].copy()
    new, loss = tk.kmeans_iteration(t(x), t(init))
    jnew, jloss = jk.kmeans_iteration(j(x), j(init))
    # Means of f32 sums taken in another order: 1e-5 absolute on values in [0, 1].
    np.testing.assert_allclose(new.numpy(), np.asarray(jnew), atol=1e-5)
    np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-4)
    # The loss is against the UPDATED centroids under the OLD assignments.
    a = tk.cluster_assignments(t(init), t(x))
    assert float(tk.mean_squared_error(new, t(x), a)) == pytest.approx(float(loss), rel=1e-5)
    np.testing.assert_array_equal(
        a.numpy(), np.asarray(jk.cluster_assignments(j(init), j(x))))
    np.testing.assert_allclose(
        tk.update_centroids(t(x), a, 9).numpy(),
        np.asarray(jk.update_centroids(j(x), jnp.asarray(a.numpy()), 9)), atol=1e-5)


@pytest.mark.parametrize("n_iterations", [1, 5])
def test_kmeans_with_centroids_n_iterations_matches_jax(n_iterations):
    x = _uniform(1, 400, 8)
    init = x[:7].copy()
    got_c, got_l = tk.kmeans_with_centroids(t(x), t(init), tk.NIterations(n_iterations))
    want_c, want_l = jk.kmeans_with_centroids(j(x), j(init), jk.NIterations(n_iterations))
    np.testing.assert_allclose(got_c.numpy(), np.asarray(want_c), atol=1e-5)
    np.testing.assert_allclose(float(got_l), float(want_l), rtol=1e-4)
    as_int = tk.kmeans_with_centroids(t(x), t(init), n_iterations)
    np.testing.assert_array_equal(as_int[0].numpy(), got_c.numpy())


def test_kmeans_with_centroids_loss_convergence():
    """The port compares two losses from the second iteration on.  The JAX
    loop compares the first loss with an infinite one, which never counts as
    an improvement, and ends after one iteration (ROADMAP.md, queue 3): so
    the port is held against JAX's fixed-count loop, run for as many
    iterations as the rule takes when applied on the host."""
    x = _uniform(2, 300, 6)
    init = x[:8].copy()
    stop = dict(max_iterations=100, rel_tol=1e-3)
    want_c, want_l = jk.kmeans_with_centroids(j(x), j(init), jk.LossConvergence(**stop))
    one_c, _ = jk.kmeans_with_centroids(j(x), j(init), jk.NIterations(1))
    np.testing.assert_array_equal(np.asarray(want_c), np.asarray(one_c))

    losses, c = [], j(init)
    while True:
        c, loss = jk.kmeans_iteration(j(x), c)
        losses.append(float(loss))
        if len(losses) >= 2 and not (losses[-2] - losses[-1]) > 1e-3 * losses[-2]:
            break
    assert 2 < len(losses) < 100
    got_c, got_l = tk.kmeans_with_centroids(t(x), t(init), tk.LossConvergence(**stop))
    np.testing.assert_allclose(got_c.numpy(), np.asarray(c), atol=1e-5)
    np.testing.assert_allclose(float(got_l), losses[-1], rtol=1e-4)
    # max_iterations caps the loop.
    capped, _ = tk.kmeans_with_centroids(t(x), t(init), tk.LossConvergence(3, rel_tol=0.0))
    three, _ = tk.kmeans_with_centroids(t(x), t(init), 3)
    np.testing.assert_array_equal(capped.numpy(), three.numpy())


def test_instance_axis_1():
    x = _uniform(3, 100, 6)
    init = x[:5].copy()
    c0, l0 = tk.kmeans_iteration(t(x), t(init))
    c1, l1 = tk.kmeans_iteration(t(x).T, t(init), instance_axis=1)
    np.testing.assert_array_equal(c0.numpy(), c1.numpy())
    assert float(l0) == float(l1)
    c0, l0 = tk.kmeans_with_centroids(t(x), t(init), 4)
    c1, l1 = tk.kmeans_with_centroids(t(x).T, t(init), 4, instance_axis=1)
    np.testing.assert_array_equal(c0.numpy(), c1.numpy())
    with pytest.raises(ValueError, match="instance_axis must be 0 or 1"):
        tk.kmeans_iteration(t(x), t(init), instance_axis=2)


@pytest.mark.parametrize("use_kernel", [False, True])
def test_kmeans_with_centroids_chunked_matches_in_memory_and_jax(use_kernel):
    # use_kernel=True on CPU tensors takes the kernel's plain version.
    x = _uniform(4, 500, 8)
    init = x[:7].copy()
    got_c, got_l = tk.kmeans_with_centroids_chunked(t(x), t(init), 5, chunk=128, use_kernel=use_kernel)
    ref_c, ref_l = tk.kmeans_with_centroids(t(x), t(init), 5)
    want_c, want_l = jk.kmeans_with_centroids_chunked(j(x), j(init), 5, chunk=128, use_kernel=False)
    np.testing.assert_allclose(got_c.numpy(), ref_c.numpy(), atol=1e-5)
    np.testing.assert_allclose(got_c.numpy(), np.asarray(want_c), atol=1e-5)
    # sumsq - explained cancels in f32: 1e-4 relative.
    np.testing.assert_allclose(float(got_l), float(want_l), rtol=1e-4)
    np.testing.assert_allclose(float(got_l), float(ref_l), rtol=1e-4)


@pytest.mark.parametrize("use_kernel", [False, True])
def test_kmeans_with_centroids_chunked_verified_matches_jax(use_kernel):
    # The verified mode has the exact path's cell memberships: on the CPU it is
    # the f32 result, here and in the JAX package (whose kernels are off).
    x = _uniform(14, 500, 8)
    init = x[:7].copy()
    got_c, got_l = tk.kmeans_with_centroids_chunked(
        t(x), t(init), 5, chunk=128, use_kernel=use_kernel, compute_dtype="verified")
    f32_c, _ = tk.kmeans_with_centroids_chunked(t(x), t(init), 5, chunk=128, use_kernel=False)
    want_c, want_l = jk.kmeans_with_centroids_chunked(
        j(x), j(init), 5, chunk=128, use_kernel=False, compute_dtype="verified")
    np.testing.assert_allclose(got_c.numpy(), f32_c.numpy(), atol=1e-6)
    np.testing.assert_allclose(got_c.numpy(), np.asarray(want_c), atol=1e-5)
    np.testing.assert_allclose(float(got_l), float(want_l), rtol=1e-4)


# -- draws: distributions and seeded gates --------------------------------------------


def test_random_distinct_indices():
    idx = tk.random_distinct_indices(_gen(0), 1_000_000, 64)  # the rejection path
    assert idx.dtype == torch.int64 and len(set(idx.tolist())) == 64
    assert int(idx.min()) >= 0 and int(idx.max()) < 1_000_000
    np.testing.assert_array_equal(idx.numpy(), tk.random_distinct_indices(_gen(0), 1_000_000, 64).numpy())
    assert len(set(tk.random_distinct_indices(_gen(1), 10, 9).tolist())) == 9  # the permutation path
    counts = np.zeros(50)
    g = _gen(2)
    for _ in range(200):
        counts[tk.random_distinct_indices(g, 100_000, 8).numpy() // 2000] += 1
    assert counts.min() > 0  # every bucket of 2% hit at least once in 1600 draws
    big = tk.random_distinct_indices(_gen(3), 10_000_000, 8192)
    assert len(set(big.tolist())) == 8192


def test_random_distinct_indices_keeps_first_draw_order():
    # n > 16k but small, so that duplicates occur among the 4k draws.
    n, k = 5_000, 256
    cand = torch.randint(0, n, (4 * k,), generator=_gen(7)).tolist()
    expected = list(dict.fromkeys(cand))[:k]
    np.testing.assert_array_equal(tk.random_distinct_indices(_gen(7), n, k).numpy(), expected)


def test_random_instance_centroids():
    x = torch.arange(20.0).reshape(10, 2)
    centroids = tk.RandomInstanceCentroids()(_gen(0), x, 8)
    assert len({tuple(r.tolist()) for r in centroids}) == 8
    for k, text in ((0, "Cannot pick 0 random centroids"),
                    (10, "Cannot pick more centroids than instances: 10 instances, 10 centroids")):
        with pytest.raises(ValueError) as terr:
            tk.RandomInstanceCentroids()(_gen(0), x, k)
        assert str(terr.value) == text
        with pytest.raises(ValueError) as jerr:
            import jax

            jk.RandomInstanceCentroids()(jax.random.PRNGKey(0), jnp.asarray(x.numpy()), k)
        assert str(jerr.value) == text
    with pytest.raises(ValueError, match="zero-length instances"):
        tk.RandomInstanceCentroids()(_gen(0), torch.zeros((10, 0)), 3)


@pytest.mark.parametrize("seed", range(5))
@pytest.mark.parametrize("axis", [0, 1])
def test_k_means_3_recovers_the_spheres(seed, axis):
    # Three tight spheres; k-means++ seeds one centroid in each for any draw
    # (a second centroid in a sphere already hit has weight ~1e-4 of the rest).
    data = gaussian_spheres(seed, [[0.0, 0.0], [1.0, 0.0], [1.0, 1.0]])
    x = t(data) if axis == 0 else t(data).T
    centroids, _ = tk.kmeans(_gen(seed), x, 3, tk.NIterations(10), init=tk.KMeansPlusPlusCentroids(),
                             instance_axis=axis, device="cpu")
    assert sorted(torch.round(centroids).to(torch.int64).tolist()) == [[0, 0], [1, 0], [1, 1]]


def test_loss_convergence_with_kmeans_plus_plus():
    data = gaussian_spheres(3, [[0.0, 0.0], [5.0, 0.0], [5.0, 5.0]])
    centroids, loss = tk.kmeans(
        _gen(3), t(data), 3, tk.LossConvergence(max_iterations=100, rel_tol=1e-9),
        init=tk.KMeansPlusPlusCentroids())
    assert sorted(torch.round(centroids).to(torch.int64).tolist()) == [[0, 0], [5, 0], [5, 5]]
    assert float(loss) < 1e-3


@pytest.mark.parametrize("batch", [None, 1, 4])
def test_kmeans_plus_plus_rounds(batch):
    x = t(_uniform(5, 200, 3))
    c = tk.KMeansPlusPlusCentroids()(_gen(5), x, 10, batch=batch)
    assert tuple(c.shape) == (10, 3)
    rows = {tuple(r.tolist()) for r in x}
    assert all(tuple(r.tolist()) in rows for r in c)          # centroids are instances
    assert len({tuple(r.tolist()) for r in c}) == 10            # and distinct
    # All points identical: the uniform fallback still returns k rows.
    same = torch.ones((20, 2))
    assert tuple(tk.KMeansPlusPlusCentroids()(_gen(0), same, 5).shape) == (5, 2)


def test_kmeans_plus_plus_spreads_by_squared_distance():
    # 99 points at 0, one at 10: the far point has all the D^2 weight, so it
    # is always the second centroid, whichever point is drawn first.
    x = torch.zeros((100, 1))
    x[37] = 10.0
    for seed in range(10):
        c = tk.KMeansPlusPlusCentroids()(_gen(seed), x, 2)
        assert sorted(c[:, 0].tolist()) == [0.0, 10.0]


def test_random_seeding_loss_decreases():
    x = t(np.random.default_rng(0).standard_normal((200, 8), dtype=np.float32))
    centroids = tk.RandomInstanceCentroids()(_gen(1), x, 16)
    losses = []
    for _ in range(5):
        centroids, loss = tk.kmeans_iteration(x, centroids)
        losses.append(float(loss))
    assert all(b <= a + 1e-12 for a, b in zip(losses, losses[1:]))


def test_kmeans_validation_texts_match_jax():
    import jax

    x = np.zeros((5, 2), dtype=np.float32)
    cases = [
        (lambda: tk.kmeans(_gen(0), t(x), 0, 1), lambda: jk.kmeans(jax.random.PRNGKey(0), j(x), 0, 1)),
        (lambda: tk.kmeans(_gen(0), t(x), 6, 1), lambda: jk.kmeans(jax.random.PRNGKey(0), j(x), 6, 1)),
        (lambda: tk.kmeans_with_centroids(t(x), torch.zeros((2, 3)), 1),
         lambda: jk.kmeans_with_centroids(j(x), jnp.zeros((2, 3)), 1)),
        (lambda: tk.kmeans_with_centroids(t(x), torch.zeros((0, 2)), 1),
         lambda: jk.kmeans_with_centroids(j(x), jnp.zeros((0, 2)), 1)),
        (lambda: tk.kmeans_with_centroids(t(x), torch.zeros((2, 2)), 0),
         lambda: jk.kmeans_with_centroids(j(x), jnp.zeros((2, 2)), 0)),
        (lambda: tk.kmeans_with_centroids_chunked(t(x), torch.zeros((2, 3)), 1),
         lambda: jk.kmeans_with_centroids_chunked(j(x), jnp.zeros((2, 3)), 1, use_kernel=False)),
        (lambda: tk.kmeans_with_centroids_chunked(t(x), torch.zeros((2, 2)), 0),
         lambda: jk.kmeans_with_centroids_chunked(j(x), jnp.zeros((2, 2)), 0, use_kernel=False)),
    ]
    for tcall, jcall in cases:
        with pytest.raises(ValueError) as terr:
            tcall()
        with pytest.raises(ValueError) as jerr:
            jcall()
        assert str(terr.value) == str(jerr.value)
    with pytest.raises(TypeError, match="Unsupported stop condition"):
        tk.kmeans_with_centroids(t(x), torch.zeros((2, 2)), "soon")
    with pytest.raises(ValueError, match='torch.float32, torch.bfloat16 or "verified"'):
        tk.kmeans_with_centroids_chunked(t(x), torch.zeros((2, 2)), 1, compute_dtype="exact")


def test_generator_must_be_a_generator_on_the_datas_device():
    x = t(_uniform(6, 20, 2))
    with pytest.raises(TypeError, match="torch.Generator"):
        tk.kmeans(0, x, 3, 1)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        if torch.cuda.is_available():
            raise RuntimeError("no CUDA device to miss on this machine")
        tk.kmeans(_gen(0), x.numpy(), 3, 1)  # a host array with device=None means cuda
    c, _ = tk.kmeans(_gen(0), x.numpy(), 3, 1, device="cpu")
    assert c.device.type == "cpu"
