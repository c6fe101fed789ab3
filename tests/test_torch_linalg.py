"""reductive_tpu_torch.linalg against reductive_tpu.linalg on the CPU: the
reference's golden values, the same seeded inputs through both packages, and
the same error texts."""

import math

import numpy as np
import pytest
import torch

from reductive_tpu import linalg as jlinalg
from reductive_tpu_torch import linalg as tlinalg

from torch_port_util import j, t

A = np.array([1.0, 2.0, 3.0], dtype=np.float32)
B = np.array([0.0, 2.0, 0.0], dtype=np.float32)
AM = np.array([[1.0, 2.0, 3.0], [3.0, 2.0, 1.0]], dtype=np.float32)
BM = np.array([[2.0, 0.0, 0.0], [0.0, 2.0, 0.0], [0.0, 0.0, 2.0]], dtype=np.float32)


def test_covariance_golden():
    x = np.array([[0.0, 2.0], [1.0, 1.0], [2.0, 0.0]], dtype=np.float32)
    want = [[1.0, -1.0], [-1.0, 1.0]]
    np.testing.assert_array_equal(tlinalg.covariance(t(x), 0).numpy(), want)
    np.testing.assert_array_equal(tlinalg.covariance(t(x.T.copy()), 1).numpy(), want)


@pytest.mark.parametrize(
    "u,v,want",
    [(A, B, 10.0), (A, BM, [14.0, 10.0, 6.0]), (AM, BM, [[14.0, 10.0, 6.0], [6.0, 10.0, 14.0]])],
    ids=["vec_vec", "vec_mat", "mat_mat"],
)
def test_distance_goldens(u, v, want):
    # Small integers: exact in float32.
    np.testing.assert_array_equal(tlinalg.squared_euclidean_distance(t(u), t(v)).numpy(), want)
    np.testing.assert_allclose(
        tlinalg.euclidean_distance(t(u), t(v)).numpy(), np.sqrt(want), atol=1e-6)


@pytest.mark.parametrize("shape_u,shape_v", [((12,), (12,)), ((12,), (7, 12)), ((33, 12), (7, 12))])
def test_distances_match_jax(shape_u, shape_v):
    rng = np.random.default_rng(3)
    u = rng.standard_normal(shape_u, dtype=np.float32)
    v = rng.standard_normal(shape_v, dtype=np.float32)
    got = tlinalg.squared_euclidean_distance(t(u), t(v))
    want = np.asarray(jlinalg.squared_euclidean_distance(j(u), j(v)))
    assert tuple(got.shape) == want.shape and got.dtype == torch.float32
    # The same expansion in f32; only the order inside the products differs.
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(
        tlinalg.euclidean_distance(t(u), t(v)).numpy(),
        np.asarray(jlinalg.euclidean_distance(j(u), j(v))), rtol=1e-5, atol=1e-5)


def test_distance_is_not_clamped_at_zero():
    # |u|^2 + |v|^2 - 2u.v cancels to a tiny value of either sign, as in the reference.
    rng = np.random.default_rng(5)
    u = (rng.standard_normal((200, 16)) * 100).astype(np.float32)
    d = tlinalg.squared_euclidean_distance(t(u), t(u)).diagonal().numpy()
    assert d.min() < 0
    assert np.abs(d).max() < 1.0  # |u|^2 is about 1.6e5: an ulp of it is 2^-6


@pytest.mark.parametrize("axis", [0, 1])
def test_covariance_matches_jax(axis):
    rng = np.random.default_rng(7)
    x = rng.standard_normal((40, 6), dtype=np.float32)
    if axis == 1:
        x = np.ascontiguousarray(x.T)
    got = tlinalg.covariance(t(x), axis).numpy()
    # f32 products of 40 terms: 1e-5 covers the order of summation.
    np.testing.assert_allclose(got, np.asarray(jlinalg.covariance(j(x), axis)), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got, np.cov(x, rowvar=axis == 1), rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize(
    "call",
    [
        lambda m, z: m.squared_euclidean_distance(z(3), z(4)),
        lambda m, z: m.squared_euclidean_distance(z(3), z((2, 4))),
        lambda m, z: m.squared_euclidean_distance(z((2, 3)), z((2, 4))),
        lambda m, z: m.squared_euclidean_distance(z((2, 3)), z(3)),
        lambda m, z: m.covariance(z((0, 3)), 0),
        lambda m, z: m.covariance(z(3), 0),
        lambda m, z: m.covariance(z((2, 3)), 2),
    ],
    ids=["lengths", "vec_mat", "mat_mat", "ranks", "zero_observations", "cov_rank", "cov_axis"],
)
def test_error_texts_match_jax(call):
    import jax.numpy as jnp

    with pytest.raises(ValueError) as jerr:
        call(jlinalg, lambda s: jnp.zeros(s, jnp.float32))
    with pytest.raises(ValueError) as terr:
        call(tlinalg, lambda s: torch.zeros(s))
    assert str(terr.value) == str(jerr.value)


def test_sqrt_of_golden():
    assert float(tlinalg.euclidean_distance(t(A), t(B))) == pytest.approx(math.sqrt(10.0))
