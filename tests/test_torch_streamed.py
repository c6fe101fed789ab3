"""reductive_tpu_torch.pq.streamed: the trainers over a corpus on disk.

The corpus is written by the JAX package's ``write_fvecs``.  Held bit for bit
to the port's own chunked trainers at ``batch_size == chunk`` (the same
draws, batches and order of addition), with and without a projection and
with several attempts; to the JAX package's streamed trainers from the same
``initial_model`` (PQ within 1e-5, OPQ at the chunked OPQ's tolerance of
tests/test_torch_opq.py, since the JAX package takes a Newton–Schulz polar
step where the port takes an SVD); the streamed covariance to the JAX
package's within 1e-5; checkpoint and resume; the validation errors; and the
bf16 wire transfer."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import reductive_tpu as jrt
from reductive_tpu.native import VecsReader as JReader
from reductive_tpu.native import write_fvecs
from reductive_tpu.pq.streamed import streamed_covariance as j_streamed_covariance
import reductive_tpu_torch as trt
from reductive_tpu_torch import io as tio
from reductive_tpu_torch.native import VecsReader
from reductive_tpu_torch.pq import streamed as tstreamed
from reductive_tpu_torch.pq.opq import create_projection_matrix
from torch_port_util import orthonormal


def make_corpus(tmp_path, seed=0, n=2000, d=16):
    rng = np.random.default_rng(seed)
    centres = 2.0 * rng.standard_normal((12, d), dtype=np.float32)
    x = (centres[rng.integers(0, 12, n)] + rng.standard_normal((n, d), dtype=np.float32))
    x = x.astype(np.float32)
    path = str(tmp_path / "corpus.fvecs")
    write_fvecs(path, x)
    return x, path


def gen(seed):
    return torch.Generator().manual_seed(seed)


def avg_loss(pq, x) -> float:
    xt = torch.from_numpy(x)
    rec = pq.reconstruct_batch(pq.quantize_batch(xt))
    return float((xt - rec).pow(2).sum(1).mean())


@pytest.mark.parametrize("attempts", [1, 3])
@pytest.mark.parametrize("compute_dtype", [torch.float32, torch.bfloat16, "verified"])
def test_streamed_equals_chunked_bit_for_bit(tmp_path, attempts, compute_dtype):
    x, path = make_corpus(tmp_path)
    want = trt.train_pq_chunked(gen(3), torch.from_numpy(x), 4, 3, 4, attempts, chunk=512,
                                compute_dtype=compute_dtype)
    with VecsReader(path) as r:
        got = trt.train_pq_streamed(gen(3), r, 4, 3, 4, attempts, batch_size=512,
                                    compute_dtype=compute_dtype, device="cpu")
    assert got.projection is None and got.codebooks.device.type == "cpu"
    assert torch.equal(got.codebooks, want.codebooks)


@pytest.mark.parametrize("use_kernel", [False, True])
def test_streamed_with_a_projection_equals_chunked_bit_for_bit(tmp_path, use_kernel):
    # use_kernel=True on CPU tensors takes the statistics kernel's plain version.
    x, path = make_corpus(tmp_path, seed=1, n=1500)
    proj = torch.from_numpy(orthonormal(4, 16))
    want = trt.train_pq_chunked(gen(5), torch.from_numpy(x), 4, 3, 3, 2, chunk=400,
                                projection=proj, use_kernel=use_kernel)
    with VecsReader(path) as r:
        got = trt.train_pq_streamed(gen(5), r, 4, 3, 3, 2, batch_size=400, projection=proj,
                                    use_kernel=use_kernel, device="cpu")
    assert torch.equal(got.codebooks, want.codebooks) and got.projection is proj


def test_streamed_window_equals_chunked_on_the_slice(tmp_path):
    x, path = make_corpus(tmp_path, seed=2, n=1800)
    want = trt.train_pq_chunked(gen(1), torch.from_numpy(x[300:1500]), 4, 3, 3, chunk=256)
    with VecsReader(path) as r:
        got = trt.train_pq_streamed(gen(1), r, 4, 3, 3, batch_size=256, start=300, stop=1500,
                                    device="cpu")
    assert torch.equal(got.codebooks, want.codebooks)


def test_streamed_pq_equals_the_jax_packages_from_one_initial_model(tmp_path):
    x, path = make_corpus(tmp_path, seed=3, n=1600)
    cb = x[:8].reshape(8, 4, 4).transpose(1, 0, 2).copy()  # (m, k, ds) from data rows
    with VecsReader(path) as r, JReader(path) as jr:
        got = trt.train_pq_streamed(None, r, 4, 3, 5, batch_size=300, device="cpu",
                                    initial_model=trt.Pq(codebooks=torch.from_numpy(cb)))
        want = jrt.train_pq_streamed(jax.random.PRNGKey(0), jr, 4, 3, 5, batch_size=300,
                                     use_kernel=False, initial_model=jrt.Pq(codebooks=jnp.asarray(cb)))
    np.testing.assert_allclose(got.codebooks.numpy(), np.asarray(want.codebooks),
                               rtol=1e-5, atol=1e-5)


def test_streamed_gaussian_opq_equals_the_jax_packages_from_one_initial_model(tmp_path):
    x, path = make_corpus(tmp_path, seed=4, n=1200)
    proj = orthonormal(5, 16)
    cb = (x[:8] @ proj).reshape(8, 4, 4).transpose(1, 0, 2).copy()
    with VecsReader(path) as r, JReader(path) as jr:
        got = trt.train_gaussian_opq_streamed(
            None, r, 4, 3, 4, batch_size=400, device="cpu",
            initial_model=trt.Pq(codebooks=torch.from_numpy(cb), projection=torch.from_numpy(proj)))
        want = jrt.train_gaussian_opq_streamed(
            jax.random.PRNGKey(0), jr, 4, 3, 4, batch_size=400, use_kernel=False,
            initial_model=jrt.Pq(codebooks=jnp.asarray(cb), projection=jnp.asarray(proj)))
    np.testing.assert_allclose(got.codebooks.numpy(), np.asarray(want.codebooks),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_array_equal(got.projection.numpy(), proj)


def test_streamed_opq_equals_the_jax_packages_from_one_initial_model(tmp_path):
    """Two alternations: the JAX package's projection update is 40 polar
    steps, the port's ``U V^T`` from an SVD; tolerances as the chunked OPQ's
    (tests/test_torch_opq.py)."""
    x, path = make_corpus(tmp_path, seed=5, n=1000)
    proj = orthonormal(6, 16)
    cb = (x[:8] @ proj).reshape(8, 4, 4).transpose(1, 0, 2).copy()
    with VecsReader(path) as r, JReader(path) as jr:
        got = trt.train_opq_streamed(
            None, r, 4, 3, 2, batch_size=250, device="cpu",
            initial_model=trt.Pq(codebooks=torch.from_numpy(cb), projection=torch.from_numpy(proj)))
        want = jrt.train_opq_streamed(
            jax.random.PRNGKey(0), jr, 4, 3, 2, batch_size=250, use_kernel=False,
            initial_model=jrt.Pq(codebooks=jnp.asarray(cb), projection=jnp.asarray(proj)))
    np.testing.assert_allclose(got.codebooks.numpy(), np.asarray(want.codebooks), atol=1e-4)
    np.testing.assert_allclose(got.projection.numpy(), np.asarray(want.projection), atol=1e-3)
    r_ = got.projection.numpy().astype(np.float64)
    assert np.abs(r_.T @ r_ - np.eye(16)).max() < 1e-5


def test_streamed_opq_equals_the_chunked_alternation(tmp_path):
    """The streamed alternation is the chunked one (same statistics, same
    cross matrix, same SVD) from the same start: equal to f32 summation
    order, the projection and codebooks of the chunked trainer."""
    x, path = make_corpus(tmp_path, seed=6, n=1200)
    xt = torch.from_numpy(x)
    with VecsReader(path) as r:
        got = trt.train_opq_streamed(gen(2), r, 4, 3, 3, batch_size=300, device="cpu")
    want = trt.train_opq_chunked(gen(2), xt, 4, 3, 3, chunk=300)
    np.testing.assert_allclose(got.codebooks.numpy(), want.codebooks.numpy(), atol=1e-4)
    np.testing.assert_allclose(got.projection.numpy(), want.projection.numpy(), atol=1e-4)
    assert abs(avg_loss(got, x) - avg_loss(want, x)) <= 1e-4 * avg_loss(want, x)


@pytest.mark.parametrize("batch", [256, 800, 5000])
def test_streamed_covariance_equals_the_jax_packages(tmp_path, batch):
    x, path = make_corpus(tmp_path, seed=7, n=800, d=12)
    with VecsReader(path) as r, JReader(path) as jr:
        got = tstreamed.streamed_covariance(r, batch_size=batch, device="cpu")
        want = j_streamed_covariance(jr, batch_size=batch)
        part = tstreamed.streamed_covariance(r, batch_size=batch, start=100, stop=700,
                                             device="cpu")
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)
    xt = torch.from_numpy(x)
    np.testing.assert_allclose(got.numpy(), trt.linalg.covariance(xt, 0).numpy(),
                               rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(part.numpy(), trt.linalg.covariance(xt[100:700], 0).numpy(),
                               rtol=1e-4, atol=1e-5)


def test_streamed_gaussian_opq_takes_the_covariance_pass(tmp_path):
    x, path = make_corpus(tmp_path, seed=8, n=1200)
    with VecsReader(path) as r:
        got = trt.train_gaussian_opq_streamed(gen(11), r, 4, 3, 4, batch_size=400, device="cpu")
        proj = got.projection.numpy().astype(np.float64)
        assert np.abs(proj.T @ proj - np.eye(16)).max() < 1e-5
        # The projection from the streamed covariance, then the streamed PQ.
        cov = tstreamed.streamed_covariance(r, batch_size=400, device="cpu")
        assert torch.equal(got.projection,
                           trt.pq.opq.projection_from_covariance(cov, 4))
        again = trt.train_pq_streamed(gen(11), r, 4, 3, 4, batch_size=400, device="cpu",
                                      projection=got.projection)
    assert torch.equal(got.codebooks, again.codebooks)
    want = trt.train_gaussian_opq_chunked(gen(11), torch.from_numpy(x), 4, 3, 4, chunk=400)
    assert abs(avg_loss(got, x) - avg_loss(want, x)) <= 0.05 * avg_loss(want, x)
    assert torch.allclose(create_projection_matrix(torch.from_numpy(x), 4).abs(),
                          got.projection.abs(), atol=1e-3)


def test_streamed_checkpoint_resume(tmp_path):
    """Checkpoint after 2 of 4 iterations, resume from the artifact: the
    final model equals the uninterrupted 4-iteration run bit for bit."""
    x, path = make_corpus(tmp_path, seed=9, n=1000)
    ckpt = str(tmp_path / "ckpt.npz")
    with VecsReader(path) as r:
        full = trt.train_pq_streamed(gen(17), r, 4, 3, 4, batch_size=300, device="cpu")
        trt.train_pq_streamed(gen(17), r, 4, 3, 2, batch_size=300, device="cpu",
                              checkpoint_every=2, checkpoint_path=ckpt)
        resumed = trt.train_pq_streamed(None, r, 4, 3, 2, batch_size=300, device="cpu",
                                        initial_model=tio.load(ckpt, device="cpu"))
        assert torch.equal(resumed.codebooks, full.codebooks)
        opq_ckpt = str(tmp_path / "opq.npz")
        opq_full = trt.train_opq_streamed(gen(3), r, 4, 3, 2, batch_size=300, device="cpu")
        trt.train_opq_streamed(gen(3), r, 4, 3, 1, batch_size=300, device="cpu",
                               checkpoint_every=1, checkpoint_path=opq_ckpt)
        opq_resumed = trt.train_opq_streamed(None, r, 4, 3, 1, batch_size=300, device="cpu",
                                             initial_model=tio.load(opq_ckpt, device="cpu"))
        assert torch.equal(opq_resumed.codebooks, opq_full.codebooks)
        assert torch.equal(opq_resumed.projection, opq_full.projection)


def test_streamed_validation_errors(tmp_path):
    x, path = make_corpus(tmp_path, seed=10, n=100)
    one = trt.train_pq_chunked(gen(0), torch.from_numpy(x), 4, 3, 1)
    with VecsReader(path) as r, JReader(path) as jr:
        cases = [
            (Exception, "[Ss]ubquantizer",
             lambda: trt.train_pq_streamed(gen(0), r, 3, 3, 2, device="cpu"),
             lambda: jrt.train_pq_streamed(jax.random.PRNGKey(0), jr, 3, 3, 2, use_kernel=False)),
            (ValueError, "checkpoint_path",
             lambda: trt.train_pq_streamed(gen(0), r, 4, 3, 2, device="cpu", checkpoint_every=1),
             lambda: jrt.train_pq_streamed(jax.random.PRNGKey(0), jr, 4, 3, 2, use_kernel=False,
                                           checkpoint_every=1)),
            (ValueError, "n_attempts=1",
             lambda: trt.train_pq_streamed(gen(0), r, 4, 3, 2, 2, device="cpu", initial_model=one),
             lambda: jrt.train_pq_streamed(
                 jax.random.PRNGKey(0), jr, 4, 3, 2, 2, use_kernel=False,
                 initial_model=jrt.Pq(codebooks=jnp.asarray(one.codebooks.numpy())))),
            (ValueError, r"expected \(2, 8, 8\)",
             lambda: trt.train_pq_streamed(gen(0), r, 2, 3, 2, device="cpu", initial_model=one),
             lambda: jrt.train_pq_streamed(
                 jax.random.PRNGKey(0), jr, 2, 3, 2, use_kernel=False,
                 initial_model=jrt.Pq(codebooks=jnp.asarray(one.codebooks.numpy())))),
            (ValueError, "must carry a projection",
             lambda: trt.train_opq_streamed(gen(0), r, 4, 3, 2, device="cpu", initial_model=one),
             lambda: jrt.train_opq_streamed(
                 jax.random.PRNGKey(0), jr, 4, 3, 2, use_kernel=False,
                 initial_model=jrt.Pq(codebooks=jnp.asarray(one.codebooks.numpy())))),
            (ValueError, "checkpoint_path",
             lambda: trt.train_opq_streamed(gen(0), r, 4, 3, 2, device="cpu", checkpoint_every=1),
             lambda: jrt.train_opq_streamed(jax.random.PRNGKey(0), jr, 4, 3, 2, use_kernel=False,
                                            checkpoint_every=1)),
        ]
        for exc, match, port, reference in cases:
            with pytest.raises(exc, match=match) as got:
                port()
            with pytest.raises(exc, match=match) as want:
                reference()
            assert str(got.value) == str(want.value)
            assert type(got.value).__name__ == type(want.value).__name__
        with pytest.raises(ValueError, match="compute_dtype"):
            trt.train_pq_streamed(gen(0), r, 4, 3, 2, device="cpu", compute_dtype=torch.float16)
        with pytest.raises(ValueError, match="the generator lives on cpu"):
            trt.train_pq_streamed(gen(0), r, 4, 3, 2, device="meta")
        if not torch.cuda.is_available():
            with pytest.raises(RuntimeError, match="no CUDA device"):
                trt.train_pq_streamed(gen(0), r, 4, 3, 2)


def test_streamed_transfer_dtype_bf16(tmp_path):
    """bf16 on the wire: the batches are rounded on the host, assignments and
    statistics use the rounded rows, so the result is the streamed trainer
    over the rounded corpus, bit for bit, and its objective stays near the
    f32 one's."""
    x, path = make_corpus(tmp_path, seed=11, n=1000)
    rounded = torch.from_numpy(x).to(torch.bfloat16).to(torch.float32)
    rpath = str(tmp_path / "rounded.fvecs")
    write_fvecs(rpath, rounded.numpy())
    with VecsReader(path) as r, VecsReader(rpath) as rr:
        pq32 = trt.train_pq_streamed(gen(19), r, 4, 3, 4, batch_size=300, device="cpu")
        pqbf = trt.train_pq_streamed(gen(19), r, 4, 3, 4, batch_size=300, device="cpu",
                                     transfer_dtype=torch.bfloat16)
        on_rounded = trt.train_pq_streamed(gen(19), rr, 4, 3, 4, batch_size=300, device="cpu")
    assert torch.equal(pqbf.codebooks, on_rounded.codebooks)
    l32, lbf = avg_loss(pq32, x), avg_loss(pqbf, x)
    assert abs(l32 - lbf) <= 0.05 * l32, (l32, lbf)


def test_streamed_from_a_synthetic_reader_equals_chunked(tmp_path):
    r = trt.SyntheticReader(1500, 16, seed=4, n_centers=12, device="cpu")
    want = trt.train_pq_chunked(gen(8), r.read(0, 1500), 4, 3, 3, chunk=500)
    got = trt.train_pq_streamed(gen(8), r, 4, 3, 3, batch_size=500, device="cpu")
    assert torch.equal(got.codebooks, want.codebooks)
