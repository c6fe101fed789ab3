"""reductive_tpu_torch.parallel against reductive_tpu.parallel (CPU).

The port's ranks run in child processes, one gloo process group
(``torch.distributed``) of two ranks, and of four for the data x model step;
the JAX side runs in this process on the virtual device mesh of
tests/conftest.py, on the same numpy inputs.  Entries that take no random
draws are held to the JAX package's sharded functions at its tests'
tolerances (tests/test_parallel.py); the trainers, whose draws differ
between the packages, to the port's single-process trainers from the same
generator (within f32 partial-sum grouping, the JAX tests' 1e-5) and to the
JAX tests' quality gates.  Every rank returns the same bits.  In this process
a one-process group (``initialize_distributed()`` with no launcher) runs
every sharded trainer bit for bit its single-process counterpart.
"""

import numpy as np
import pytest
import torch
import torch.distributed as dist

import jax
import jax.numpy as jnp
from jax.sharding import PartitionSpec as P

from reductive_tpu import Pq as JPq
from reductive_tpu import kmeans as jkmeans
from reductive_tpu import parallel as jpar
from reductive_tpu.native import VecsReader as JReader
from reductive_tpu.native import write_fvecs
import reductive_tpu_torch as trt
from reductive_tpu_torch import Pq
from reductive_tpu_torch import parallel as tpar
from reductive_tpu_torch.kmeans import kmeans_with_centroids_chunked
from reductive_tpu_torch.native import VecsReader
from reductive_tpu_torch.ops.assign import pq_encode
from reductive_tpu_torch.parallel import launch
from reductive_tpu_torch.parallel.mesh import mesh_shape
from reductive_tpu_torch.pq.streamed import train_pq_streamed
from torch_port_util import orthonormal, run_ranks


def gen(seed=42):
    return torch.Generator().manual_seed(seed)


def jmesh(shape=(2,), names=("data",)):
    return jpar.make_mesh(shape, names, devices=jax.devices()[:int(np.prod(shape))])


def avg_loss(pq, x) -> float:
    """The JAX tests' gate metric: the mean reconstruction distance."""
    xt = torch.from_numpy(x)
    rec = pq.reconstruct_batch(pq.quantize_batch(xt))
    return float(torch.sqrt(((xt - rec) ** 2).sum(1)).mean())


def same_on_every_rank(outs, key):
    for out in outs[1:]:
        np.testing.assert_array_equal(out[key], outs[0][key])
    return outs[0][key]


# ---------------------------------------------------------------------------
# Two ranks
# ---------------------------------------------------------------------------

TWO_RANKS = """
from reductive_tpu_torch import Pq
from reductive_tpu_torch.native import VecsReader
from reductive_tpu_torch.parallel import (
    encode_sharded, sharded_kmeans, stream_encode_sharded, train_opq_chunked_sharded,
    train_pq_chunked_sharded, train_pq_sharded, train_pq_streamed_sharded)

mesh = make_mesh(devices="cpu")
gen = lambda: torch.Generator().manual_seed(42)
c, loss = sharded_kmeans(mesh, inputs["x_km"], torch.from_numpy(inputs["c_km"]), 5)
out["km_c"], out["km_loss"] = c.numpy(), loss.numpy()
x = inputs["x"]
out["pqc"] = train_pq_chunked_sharded(gen(), x, 10, 7, 10, 2, mesh=mesh, chunk=16).codebooks.numpy()
out["pqc_rot"] = train_pq_chunked_sharded(
    gen(), x, 10, 7, 10, 1, mesh=mesh, chunk=16,
    projection=torch.from_numpy(inputs["r20"])).codebooks.numpy()
opq = train_opq_chunked_sharded(gen(), x, 10, 7, 10, mesh=mesh, chunk=16)
out["opq_cb"], out["opq_r"] = opq.codebooks.numpy(), opq.projection.numpy()
out["pq_mem"] = train_pq_sharded(gen(), x, 10, 7, 10, 1, mesh=mesh).codebooks.numpy()
pq20 = Pq(codebooks=torch.from_numpy(inputs["cb20"]))
with VecsReader(str(inputs["path"])) as reader:
    out["pqs"] = train_pq_streamed_sharded(
        gen(), reader, 10, 7, 10, 2, mesh=mesh, batch_size=16).codebooks.numpy()
    out["se"] = stream_encode_sharded(pq20, reader, mesh=mesh, batch_size=48)
    out["se_kernel"] = stream_encode_sharded(pq20, reader, mesh=mesh, batch_size=48,
                                             use_kernel=True)
pq32 = Pq(codebooks=torch.from_numpy(inputs["cb32"]))
pq32r = Pq(codebooks=pq32.codebooks, projection=torch.from_numpy(inputs["r32"]))
out["enc"] = encode_sharded(pq32, inputs["x32"], mesh=mesh).numpy()
out["enc_rot"] = encode_sharded(pq32r, inputs["x32"], mesh=mesh).numpy()
out["enc_kernel"] = encode_sharded(pq32, inputs["x32"], mesh=mesh, use_kernel=True).numpy()
try:
    train_pq_chunked_sharded(gen(), x[:255], 5, 7, 2, mesh=mesh)
except ValueError as e:
    out["err_divide"] = np.array(str(e))
"""


@pytest.fixture(scope="module")
def two(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("two_ranks")
    rng = np.random.default_rng(0)
    x = rng.random((256, 20), dtype=np.float32)
    path = str(tmp / "corpus.fvecs")
    write_fvecs(path, x)
    inputs = dict(
        x_km=rng.standard_normal((256, 16), dtype=np.float32),
        c_km=rng.standard_normal((8, 16), dtype=np.float32),
        x=x, path=np.array(path), r20=orthonormal(1, 20),
        cb20=rng.standard_normal((4, 16, 5), dtype=np.float32),
        cb32=rng.standard_normal((4, 16, 8), dtype=np.float32),
        x32=rng.standard_normal((256, 32), dtype=np.float32), r32=orthonormal(2, 32),
    )
    return inputs, run_ranks(TWO_RANKS, 2, tmp, inputs)


def test_sharded_kmeans_matches_jax(two):
    inputs, outs = two
    c = same_on_every_rank(outs, "km_c")
    loss = same_on_every_rank(outs, "km_loss")
    ref_c, ref_loss = jpar.sharded_kmeans(jmesh(), jnp.asarray(inputs["x_km"]),
                                          jnp.asarray(inputs["c_km"]), 5)
    np.testing.assert_allclose(c, np.asarray(ref_c), atol=1e-5)
    assert float(loss) == pytest.approx(float(ref_loss), rel=1e-5)
    single, _ = jkmeans.kmeans_with_centroids(jnp.asarray(inputs["x_km"]),
                                              jnp.asarray(inputs["c_km"]), 5)
    np.testing.assert_allclose(c, np.asarray(single), atol=1e-5)


def test_train_pq_chunked_sharded_matches_single_process(two):
    inputs, outs = two
    x = inputs["x"]
    cb = same_on_every_rank(outs, "pqc")
    ref = trt.train_pq_chunked(gen(), x, 10, 7, 10, 2, chunk=16, device="cpu")
    np.testing.assert_allclose(cb, ref.codebooks.numpy(), atol=1e-5)
    assert avg_loss(Pq(codebooks=torch.from_numpy(cb)), x) < 0.08
    jax_pq = jpar.train_pq_chunked_sharded(jax.random.PRNGKey(42), jnp.asarray(x), 10, 7, 10, 2,
                                           mesh=jmesh(), chunk=16, use_kernel=False)
    jrec = jax_pq.reconstruct_batch(jax_pq.quantize_batch(jnp.asarray(x)))
    assert float(jnp.mean(jnp.sqrt(jnp.sum((x - jrec) ** 2, axis=1)))) < 0.08


def test_sharded_gaussian_opq_composition_matches_single_process(two):
    inputs, outs = two
    x, r = inputs["x"], torch.from_numpy(inputs["r20"])
    cb = same_on_every_rank(outs, "pqc_rot")
    ref = trt.train_pq_chunked(gen(), x, 10, 7, 10, 1, chunk=16, projection=r, device="cpu")
    np.testing.assert_allclose(cb, ref.codebooks.numpy(), atol=1e-5)
    assert avg_loss(Pq(codebooks=torch.from_numpy(cb), projection=r), x) < 0.12


def test_train_opq_chunked_sharded_quality(two):
    inputs, outs = two
    x = inputs["x"]
    cb, r = same_on_every_rank(outs, "opq_cb"), same_on_every_rank(outs, "opq_r")
    np.testing.assert_allclose(r.T @ r, np.eye(20), atol=1e-4)
    loss = avg_loss(Pq(codebooks=torch.from_numpy(cb), projection=torch.from_numpy(r)), x)
    assert loss < 0.1  # the reference Opq gate
    single = trt.train_opq_chunked(gen(), x, 10, 7, 10, chunk=16, device="cpu")
    assert abs(loss - avg_loss(single, x)) < 5e-3


def test_train_pq_streamed_sharded_matches_single_process(two):
    inputs, outs = two
    cb = same_on_every_rank(outs, "pqs")
    with VecsReader(str(inputs["path"])) as reader:
        ref = train_pq_streamed(gen(), reader, 10, 7, 10, 2, batch_size=16, device="cpu")
    np.testing.assert_allclose(cb, ref.codebooks.numpy(), atol=1e-5)
    assert avg_loss(Pq(codebooks=torch.from_numpy(cb)), inputs["x"]) < 0.08


def test_stream_encode_sharded_matches_jax(two):
    inputs, outs = two
    codes = same_on_every_rank(outs, "se")
    with JReader(str(inputs["path"])) as reader:
        want = jpar.stream_encode_sharded(JPq(codebooks=jnp.asarray(inputs["cb20"])), reader,
                                          mesh=jmesh(), batch_size=48, use_kernel=False)
    np.testing.assert_array_equal(codes, want)
    # The kernel route on the CPU: the plain version at f32 products, as the
    # JAX package interprets its kernel there.
    kernel = same_on_every_rank(outs, "se_kernel")
    np.testing.assert_array_equal(kernel, pq_encode(
        torch.from_numpy(inputs["cb20"]), torch.from_numpy(inputs["x"]),
        compute_dtype=torch.float32).numpy())


def test_encode_sharded_matches_jax(two):
    inputs, outs = two
    x, cb, r = (jnp.asarray(inputs[k]) for k in ("x32", "cb32", "r32"))
    mesh = jmesh()
    np.testing.assert_array_equal(same_on_every_rank(outs, "enc"),
                                  np.asarray(jpar.encode_sharded(JPq(codebooks=cb), x, mesh=mesh)))
    np.testing.assert_array_equal(
        same_on_every_rank(outs, "enc_rot"),
        np.asarray(jpar.encode_sharded(JPq(codebooks=cb, projection=r), x, mesh=mesh)))
    kernel = same_on_every_rank(outs, "enc_kernel")
    np.testing.assert_array_equal(kernel, pq_encode(
        torch.from_numpy(inputs["cb32"]), torch.from_numpy(inputs["x32"]),
        compute_dtype=torch.float32).numpy())
    jax_kernel = np.asarray(jpar.encode_sharded(JPq(codebooks=cb), x, mesh=mesh, use_kernel=True))
    assert np.mean(kernel == jax_kernel) > 0.99


def test_train_pq_sharded_matches_single_process(two):
    inputs, outs = two
    x = inputs["x"]
    cb = same_on_every_rank(outs, "pq_mem")
    ref = trt.train_pq(gen(), x, 10, 7, 10, 1, device="cpu")
    np.testing.assert_allclose(cb, ref.codebooks.numpy(), atol=1e-5)
    assert avg_loss(Pq(codebooks=torch.from_numpy(cb)), x) < 0.08


def test_divisibility_error_is_the_jax_packages(two):
    inputs, outs = two
    with pytest.raises(ValueError) as e:
        jpar.train_pq_chunked_sharded(jax.random.PRNGKey(0), jnp.asarray(inputs["x"][:255]), 5, 7,
                                      2, mesh=jmesh(), use_kernel=False)
    assert str(same_on_every_rank(outs, "err_divide")) == str(e.value)


# ---------------------------------------------------------------------------
# Four ranks: the data x model step, and a 1-D mesh of four
# ---------------------------------------------------------------------------

FOUR_RANKS = """
from reductive_tpu_torch.parallel import sharded_kmeans, sharded_pq_train_step

mesh = make_mesh((-1, 2), ("data", "model"), devices="cpu")
i, j = mesh.get_local_rank("data"), mesh.get_local_rank("model")
xs, cb = inputs["xs"], inputs["cb"]
n, m = xs.shape[0] // 2, xs.shape[1] // 2
new, loss = sharded_pq_train_step(torch.from_numpy(xs[i * n:(i + 1) * n, j * m:(j + 1) * m].copy()),
                                  torch.from_numpy(cb[j * m:(j + 1) * m].copy()), mesh=mesh)
out["cb"], out["loss"], out["ij"] = new.numpy(), loss.numpy(), np.array([i, j])
out["shape"] = np.array(tuple(mesh.shape))
c, loss = sharded_kmeans(make_mesh(devices="cpu"), inputs["x_km"], inputs["c_km"], 5)
out["km_c"], out["km_loss"] = c.numpy(), loss.numpy()
"""


@pytest.fixture(scope="module")
def four(tmp_path_factory):
    rng = np.random.default_rng(1)
    inputs = dict(xs=rng.standard_normal((128, 4, 4), dtype=np.float32),
                  cb=rng.standard_normal((4, 8, 4), dtype=np.float32),
                  x_km=rng.standard_normal((256, 16), dtype=np.float32),
                  c_km=rng.standard_normal((8, 16), dtype=np.float32))
    return inputs, run_ranks(FOUR_RANKS, 4, tmp_path_factory.mktemp("four_ranks"), inputs)


def test_sharded_pq_train_step_2d_mesh_matches_jax(two, four):
    inputs, outs = four
    xs, cb = jnp.asarray(inputs["xs"]), jnp.asarray(inputs["cb"])
    run = jax.jit(jax.shard_map(
        jpar.sharded_pq_train_step, mesh=jmesh((2, 2), ("data", "model")),
        in_specs=(P("data", "model", None), P("model", None, None)),
        out_specs=(P("model", None, None), P()),
    ))
    want_cb, want_loss = (np.asarray(a) for a in run(xs, cb))
    for out in outs:
        np.testing.assert_array_equal(out["shape"], [2, 2])
        i, j = out["ij"]
        np.testing.assert_allclose(out["cb"], want_cb[2 * j:2 * j + 2], atol=1e-5)
        assert float(out["loss"]) == pytest.approx(float(want_loss), rel=1e-5)
    same_on_every_rank(outs, "loss")
    # Ranks that share a model block share its codebooks bit for bit.
    by_j = {}
    for out in outs:
        by_j.setdefault(int(out["ij"][1]), []).append(out)
    for group in by_j.values():
        same_on_every_rank(group, "cb")


def test_sharded_kmeans_four_ranks_matches_jax(four):
    inputs, outs = four
    c = same_on_every_rank(outs, "km_c")
    ref_c, ref_loss = jpar.sharded_kmeans(jmesh((4,)), jnp.asarray(inputs["x_km"]),
                                          jnp.asarray(inputs["c_km"]), 5)
    np.testing.assert_allclose(c, np.asarray(ref_c), atol=1e-5)
    assert float(same_on_every_rank(outs, "km_loss")) == pytest.approx(float(ref_loss), rel=1e-5)


# ---------------------------------------------------------------------------
# One rank, in this process: bit for bit the single-process entries
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def mesh1():
    """``initialize_distributed()`` with no arguments and no launcher: a
    one-process group; the mesh over it, and the group torn down after."""
    with pytest.MonkeyPatch.context() as mp:
        for name in launch._MULTIPROCESS_ENV_SIGNALS + ("RANK", "LOCAL_RANK", "MASTER_PORT"):
            mp.delenv(name, raising=False)
        assert not dist.is_initialized()
        launch.initialize_distributed()
        assert dist.get_world_size() == 1 and dist.get_backend() == "gloo"
        try:
            yield tpar.make_mesh(devices="cpu")
        finally:
            dist.destroy_process_group()


def data(seed=3, n=256, d=20):
    return np.random.default_rng(seed).random((n, d), dtype=np.float32)


def test_one_rank_kmeans_is_the_chunked_kmeans(mesh1):
    x = data()
    c0 = torch.from_numpy(x[:8].copy())
    got = tpar.sharded_kmeans(mesh1, x, c0, 4, chunk=64)
    want = kmeans_with_centroids_chunked(torch.from_numpy(x), c0, 4, chunk=64)
    assert all(torch.equal(a, b) for a, b in zip(got, want))


@pytest.mark.parametrize("rotated", [False, True])
def test_one_rank_chunked_pq_is_train_pq_chunked(mesh1, rotated):
    x = data()
    r = torch.from_numpy(orthonormal(4, 20)) if rotated else None
    got = tpar.train_pq_chunked_sharded(gen(), x, 5, 4, 3, 2, mesh=mesh1, chunk=64, projection=r)
    want = trt.train_pq_chunked(gen(), x, 5, 4, 3, 2, chunk=64, projection=r, device="cpu")
    assert torch.equal(got.codebooks, want.codebooks)


@pytest.mark.parametrize("compute_dtype", [torch.float32, torch.bfloat16])
def test_one_rank_chunked_opq_is_train_opq_chunked(mesh1, compute_dtype):
    x = data()
    got = tpar.train_opq_chunked_sharded(gen(), x, 5, 4, 3, mesh=mesh1, chunk=64,
                                         compute_dtype=compute_dtype)
    want = trt.train_opq_chunked(gen(), x, 5, 4, 3, chunk=64, compute_dtype=compute_dtype,
                                 device="cpu")
    assert torch.equal(got.projection, want.projection)
    assert torch.equal(got.codebooks, want.codebooks)


def test_one_rank_in_memory_pq_is_train_pq(mesh1):
    x = data()
    got = tpar.train_pq_sharded(gen(), x, 5, 4, 3, 2, mesh=mesh1)
    want = trt.train_pq(gen(), x, 5, 4, 3, 2, device="cpu")
    assert torch.equal(got.codebooks, want.codebooks)


def test_one_rank_streamed_pq_and_encode_are_the_single_process_ones(mesh1, tmp_path):
    x = data()
    path = str(tmp_path / "x.fvecs")
    write_fvecs(path, x)
    pq = Pq(codebooks=torch.from_numpy(np.random.default_rng(5).standard_normal(
        (5, 16, 4), dtype=np.float32)), projection=torch.from_numpy(orthonormal(6, 20)))
    with VecsReader(path) as reader:
        got = tpar.train_pq_streamed_sharded(gen(), reader, 5, 4, 3, 2, mesh=mesh1, batch_size=48,
                                             start=16)
        want = train_pq_streamed(gen(), reader, 5, 4, 3, 2, batch_size=48, start=16, device="cpu")
        assert torch.equal(got.codebooks, want.codebooks)
        np.testing.assert_array_equal(
            tpar.stream_encode_sharded(pq, reader, mesh=mesh1, batch_size=48),
            trt.stream_encode(pq, reader, batch_size=48))
    np.testing.assert_array_equal(tpar.encode_sharded(pq, x, mesh=mesh1).numpy(),
                                  pq.quantize_batch(torch.from_numpy(x)).numpy())


def test_one_rank_pq_train_step_is_the_chunked_lloyd_step(mesh1):
    from reductive_tpu_torch.pq.train import _streamed_sumsq, lloyd_iteration_chunked

    m2 = tpar.make_mesh((1, 1), ("data", "model"), devices="cpu")
    x = data()
    cb = torch.from_numpy(x[:16].reshape(16, 5, 4).transpose(1, 0, 2).copy())
    got_cb, got_loss = tpar.sharded_pq_train_step(torch.from_numpy(x).reshape(-1, 5, 4), cb,
                                                  mesh=m2)
    want_cb, want_losses = lloyd_iteration_chunked(
        torch.from_numpy(x), cb, _streamed_sumsq(torch.from_numpy(x), 5, chunk=32768),
        use_kernel=False)
    assert torch.equal(got_cb, want_cb)
    assert float(got_loss) == pytest.approx(float(want_losses.mean()), rel=1e-6)


def test_one_rank_errors(mesh1):
    x = data()
    with pytest.raises(ValueError, match="the mesh has no axis 'model'"):
        tpar.train_pq_chunked_sharded(gen(), x, 5, 4, 3, mesh=mesh1, data_axis="model")
    with pytest.raises(trt.errors.ReductiveError):
        tpar.train_pq_chunked_sharded(gen(), x, 3, 4, 3, mesh=mesh1)
    with pytest.raises(TypeError, match="expected a torch.Generator"):
        tpar.train_pq_sharded(None, x, 5, 4, 3, mesh=mesh1)
    with pytest.raises(ValueError, match="The number of iterations must be >= 1"):
        tpar.sharded_kmeans(mesh1, x, x[:4], 0)


# ---------------------------------------------------------------------------
# The mesh's shape rules, against the JAX package's make_mesh
# ---------------------------------------------------------------------------

SHAPES = [
    (None, ("data",), 8), ((4, 2), ("data", "model"), 8), ((-1, 2), ("data", "model"), 8),
    ((2, -1), ("data", "model"), 4), ((3, 2), ("data", "model"), 8),
    ((-1, -1), ("data", "model"), 8), ((-1, 3), ("data", "model"), 8),
    (None, ("data", "model"), 8), ((8,), ("data", "model"), 8), ((2, 2, 2), ("a", "b"), 8),
]


@pytest.mark.parametrize("shape,names,n", SHAPES)
def test_mesh_shape_rules_are_the_jax_packages(shape, names, n):
    try:
        want = tuple(jpar.make_mesh(shape, names, devices=jax.devices()[:n]).devices.shape)
    except ValueError as e:
        with pytest.raises(ValueError) as got:
            mesh_shape(shape, names, n)
        assert str(got.value) == str(e)
    else:
        assert mesh_shape(shape, names, n) == want
