"""reductive_tpu_torch.conformance against reductive_tpu.conformance, the
pinned goldens (tests/goldens/rng_reference.json) and the independent numpy
reference (tests/reference_numpy.py): every RNG output equal; the three
conformant trainers' codebooks and projections within 1e-5 relative of the
numpy reference's and of the JAX package's (where those two agree); their
objectives within 1e-5 relative of the numpy reference's (the BASELINE.md
gate) and within 1e-3 of the goldens."""

import hashlib
import json
from pathlib import Path

import numpy as np
import pytest
import torch

import reference_numpy as R
from reductive_tpu import conformance as JC
from reductive_tpu_torch import conformance as TC

GOLDEN = json.loads((Path(__file__).parent / "goldens" / "rng_reference.json").read_text())
SEEDS = [int(s) for s in GOLDEN["seeds"]]


def _loss(model, x) -> float:
    """The reference tests' metric: mean Euclidean distance between rows and
    their quantize -> reconstruct roundtrip, on the port's model."""
    xt = torch.from_numpy(x)
    rec = model.reconstruct_batch(model.quantize_batch(xt))
    return float((xt - rec).pow(2).sum(1).sqrt().mean())


def _rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30))


def test_the_rng_stack_is_a_copy_not_an_import():
    assert TC.ChaCha8Rng is not JC.ChaCha8Rng and TC.XorShiftRng is not JC.XorShiftRng
    assert TC.__all__ == JC.__all__


@pytest.mark.parametrize("seed", [0, 42, 1, 7, 2**63 + 5])
def test_words_and_forks_equal_the_jax_packages(seed):
    assert TC._seed_from_u64(seed, 32) == JC._seed_from_u64(seed, 32)
    t, j = TC.ChaCha8Rng.seed_from_u64(seed), JC.ChaCha8Rng.seed_from_u64(seed)
    np.testing.assert_array_equal(t.next_words(1000), j.next_words(1000))
    assert [t.next_u64() for _ in range(5)] == [j.next_u64() for _ in range(5)]
    assert t.fill_bytes(13) == j.fill_bytes(13)
    tf, jf = TC.XorShiftRng.from_rng(t), JC.XorShiftRng.from_rng(j)
    assert [tf.next_u32() for _ in range(64)] == [jf.next_u32() for _ in range(64)]
    assert [tf.next_u64() for _ in range(8)] == [jf.next_u64() for _ in range(8)]
    zero_t, zero_j = TC.XorShiftRng.from_seed(bytes(16)), JC.XorShiftRng.from_seed(bytes(16))
    assert (zero_t.x, zero_t.w) == (zero_j.x, zero_j.w) == (0xBAD5EED, 0xBAD5EED)
    np.testing.assert_array_equal(
        TC.chacha_blocks(t._key, 5, 9, 3, 20), JC.chacha_blocks(j._key, 5, 9, 3, 20))


@pytest.mark.parametrize("seed", [42, 3])
def test_uniform_arrays_and_draws_equal_the_jax_packages(seed):
    t, j = TC.ChaCha8Rng.seed_from_u64(seed), JC.ChaCha8Rng.seed_from_u64(seed)
    a, b = TC.uniform_array_f32(t, (37, 11)), JC.uniform_array_f32(j, (37, 11))
    assert a.dtype == np.float32 and a.tobytes() == b.tobytes()
    for n in (1, 7, 256, 1000, 2**40 + 3):
        assert TC.sample_uniform_int(t, n) == JC.sample_uniform_int(j, n)
    np.testing.assert_array_equal(TC.distinct_indices(t, 300, 128), JC.distinct_indices(j, 300, 128))
    tx, jx = TC.XorShiftRng.from_rng(t), JC.XorShiftRng.from_rng(j)
    assert TC.uniform_array_f32(tx, (5, 3)).tobytes() == JC.uniform_array_f32(jx, (5, 3)).tobytes()
    np.testing.assert_array_equal(TC._pq_initial_indices(t, 500, 4, 16, 2),
                                  JC._pq_initial_indices(j, 500, 4, 16, 2))
    xt, _ = TC.reference_test_instances(seed, (64, 8))
    xj, _ = JC.reference_test_instances(seed, (64, 8))
    assert xt.tobytes() == xj.tobytes()


@pytest.mark.parametrize("seed", SEEDS)
def test_rng_streams_equal_the_goldens(seed):
    g = GOLDEN["seeds"][str(seed)]
    shape = tuple(GOLDEN["gate"]["shape"])
    m, k = GOLDEN["gate"]["m"], GOLDEN["gate"]["k"]
    assert TC._seed_from_u64(seed, 32).hex() == g["seed_bytes"]
    np.testing.assert_array_equal(TC.ChaCha8Rng.seed_from_u64(seed).next_words(64),
                                  np.asarray(g["chacha8_words"], dtype=np.uint32))
    master = TC.ChaCha8Rng.seed_from_u64(seed)
    forks = [TC.XorShiftRng.from_rng(master) for _ in range(m)]
    assert [b"".join(int(v).to_bytes(4, "little") for v in (f.x, f.y, f.z, f.w)).hex()
            for f in forks] == g["xorshift_seeds"]
    assert [forks[0].next_u32() for _ in range(16)] == g["xorshift_words"]
    x, master = TC.reference_test_instances(seed, shape)
    assert hashlib.sha256(x.tobytes()).hexdigest() == g["uniform_sha256"]
    np.testing.assert_array_equal(x.ravel()[:8].astype(np.float64), g["uniform_head"])
    idx = TC._pq_initial_indices(master, shape[0], m, k, 1)
    assert [int(v) for v in idx.ravel()[:16]] == g["pq_indices_head"]
    assert hashlib.sha256(idx.astype(np.int64).tobytes()).hexdigest() == g["pq_indices_sha256"]
    _, master = TC.reference_test_instances(seed, shape)
    opq_idx = np.stack([TC.distinct_indices(master, shape[0], k) for _ in range(m)])
    assert hashlib.sha256(opq_idx.astype(np.int64).tobytes()).hexdigest() == g["opq_indices_sha256"]


TRAINERS = {
    "pq": (TC.train_pq_conformant, JC.train_pq_conformant),
    "opq": (TC.train_opq_conformant, JC.train_opq_conformant),
    "gaussian_opq": (TC.train_gaussian_opq_conformant, JC.train_gaussian_opq_conformant),
}


def _numpy_reference(name, x, m, master):
    """``(codebooks, projection or None)`` of tests/reference_numpy.py."""
    if name == "pq":
        return R.train_pq(x, m, 7, 10, 1, master), None
    if name == "opq":
        proj, cb = R.train_opq(x, m, 7, 10, master)
    else:
        proj, cb = R.train_gaussian_opq(x, m, 7, 10, 1, master)
    return cb, proj


@pytest.mark.parametrize("name", list(TRAINERS))
@pytest.mark.parametrize("seed", SEEDS)
def test_conformant_trainers_equal_the_jax_packages(name, seed):
    """Codebooks and projection within 1e-5 relative of the independent
    numpy reference's from the same master stream, and of the JAX
    package's wherever the JAX package's are themselves within 1e-5 of the
    numpy reference's.  (At seed 7 the JAX package's OPQ takes one near-tie
    the other way, 2.3e-4 from the numpy reference; the port's codebooks
    equal the numpy reference's there.)"""
    shape, m = tuple(GOLDEN["gate"]["shape"]), GOLDEN["gate"]["m"]
    tfn, jfn = TRAINERS[name]
    x, master = TC.reference_test_instances(seed, shape)
    got = tfn(x, m, 7, 10, 1, master=master, device="cpu")
    x, master = JC.reference_test_instances(seed, shape)
    want = jfn(x, m, 7, 10, 1, master=master)
    _, master = JC.reference_test_instances(seed, shape)
    np_cb, np_proj = _numpy_reference(name, x, m, master)
    assert got.codebooks.device.type == "cpu"
    assert _rel(got.codebooks.numpy(), np_cb) <= 1e-5
    jax_agrees = _rel(np.asarray(want.codebooks), np_cb) <= 1e-5
    if jax_agrees:
        assert _rel(got.codebooks.numpy(), want.codebooks) <= 1e-5
    if name == "pq":
        assert got.projection is None and want.projection is None
    else:
        assert _rel(got.projection.numpy(), np_proj) <= 1e-5
        if jax_agrees:
            assert _rel(got.projection.numpy(), want.projection) <= 1e-5


PQ_SCENARIOS = [((256, 20), 10, 7, 10, 1, 42), ((2048, 32), 8, 5, 8, 2, 9),
                ((512, 64), 16, 6, 6, 1, 123)]


@pytest.mark.parametrize("shape,m,bits,iters,attempts,seed", PQ_SCENARIOS)
def test_pq_objective_matches_independent_numpy(shape, m, bits, iters, attempts, seed):
    x, master = TC.reference_test_instances(seed, shape)
    _, master_np = JC.reference_test_instances(seed, shape)
    loss_np = R.avg_euclidean_loss(x, R.train_pq(x, m, bits, iters, attempts, master_np))
    loss = _loss(TC.train_pq_conformant(x, m, bits, iters, attempts, master=master,
                                        device="cpu"), x)
    assert abs(loss - loss_np) <= 1e-5 * loss_np, (loss, loss_np)


OPQ_SCENARIOS = [((256, 20), 10, 7, 10, 42), ((256, 20), 10, 7, 10, 7),
                 ((512, 32), 8, 4, 5, 11), ((1024, 16), 4, 5, 6, 5)]


@pytest.mark.parametrize("shape,m,bits,iters,seed", OPQ_SCENARIOS)
def test_opq_objective_matches_independent_numpy(shape, m, bits, iters, seed):
    x, master = TC.reference_test_instances(seed, shape)
    _, master_np = JC.reference_test_instances(seed, shape)
    proj, cb = R.train_opq(x, m, bits, iters, master_np)
    loss_np = R.avg_euclidean_loss(x, cb, proj)
    loss = _loss(TC.train_opq_conformant(x, m, bits, iters, master=master, device="cpu"), x)
    assert abs(loss - loss_np) <= 1e-5 * loss_np, (loss, loss_np)


@pytest.mark.parametrize("seed", SEEDS)
def test_gaussian_opq_objective_matches_independent_numpy(seed):
    shape, m = tuple(GOLDEN["gate"]["shape"]), GOLDEN["gate"]["m"]
    x, master = TC.reference_test_instances(seed, shape)
    _, master_np = JC.reference_test_instances(seed, shape)
    proj, cb = R.train_gaussian_opq(x, m, 7, 10, 1, master_np)
    loss_np = R.avg_euclidean_loss(x, cb, proj)
    loss = _loss(TC.train_gaussian_opq_conformant(x, m, 7, 10, 1, master=master,
                                                  device="cpu"), x)
    assert abs(loss - loss_np) <= 1e-5 * loss_np, (loss, loss_np)


@pytest.mark.parametrize("name", list(TRAINERS))
def test_golden_gate_objectives(name):
    shape, m = tuple(GOLDEN["gate"]["shape"]), GOLDEN["gate"]["m"]
    band = {"pq": 0.08, "opq": 0.10, "gaussian_opq": 0.12}[name]
    for seed_str, g in GOLDEN["seeds"].items():
        x, master = TC.reference_test_instances(int(seed_str), shape)
        loss = _loss(TRAINERS[name][0](x, m, 7, 10, 1, master=master, device="cpu"), x)
        recorded = g[f"{name}_objective"]
        assert abs(loss - recorded) <= 1e-3 * recorded, (seed_str, loss, recorded)
        assert loss < band


def test_conformant_trainers_validate_as_the_jax_packages():
    x, _ = TC.reference_test_instances(42, (64, 8))
    with pytest.raises(ValueError, match="Provide either seed= or master="):
        TC.train_pq_conformant(x, 4, 2, 3, device="cpu")
    with pytest.raises(ValueError, match="Provide either seed= or master="):
        TC.train_opq_conformant(x, 4, 2, 3, device="cpu")
    from reductive_tpu_torch.errors import ReductiveError

    with pytest.raises(ReductiveError):
        TC.train_pq_conformant(x, 3, 2, 3, seed=1, device="cpu")
    seeded = TC.train_pq_conformant(x, 4, 2, 3, seed=5, device="cpu")
    _, master = TC.reference_test_instances(5, (0, 8))
    from_master = TC.train_pq_conformant(x, 4, 2, 3, master=TC.ChaCha8Rng.seed_from_u64(5),
                                         device="cpu")
    assert torch.equal(seeded.codebooks, from_master.codebooks)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            TC.train_pq_conformant(x, 4, 2, 3, seed=1)
