"""The port's user programs (``reductive_tpu_torch.examples``) on the CPU.

(a) The four cases of tests/test_examples.py, at its sizes, through
    ``main(argv + ["--device", "cpu"])``, with its bars (recall >= 0.75,
    serving's three lines >= 0.9).
(b) The pipeline's steps against the JAX package: the corpus the same bytes
    as the JAX program's; a PQ or OPQ trained and saved by ``reductive_tpu``,
    carried through ``persist_and_reload``; the codes of ``encode_from_disk``
    equal to ``reductive_tpu.data.stream_encode``'s except on near-tie
    entries (at least 99.9% equal, a differing code within 1e-5 relative of
    the best distance) and its MSE within 1e-5 relative; the ids of
    ``search_planted`` equal to JAX ``search(method="einsum")``'s on the same
    codes and queries (4-bit codes searched packed).
(c) The serving steps against the JAX package on an index that
    ``reductive_tpu.ivf`` built and ``reductive_tpu.io`` saved: ``serve_l2``,
    ``serve_mips`` and ``update`` give the ids of JAX ``ivf_search`` /
    ``ivf_remove`` / ``ivf_add`` exactly, the refined distances within 1e-5
    and the IVFADC distances within 1e-5 of the largest ``|q|^2``.
(d) ``sharded_scan`` on two gloo ranks: both ranks' ids bit for bit the
    single-process ``search``.
(e) Without CUDA and without ``--device``, ``main`` raises
    ``resolve_device``'s error.
"""

import filecmp

import numpy as np
import pytest
import torch
import torch.distributed as dist

import jax
import jax.numpy as jnp

from reductive_tpu import data as jdata
from reductive_tpu import io as jio
from reductive_tpu import ivf as jivf
from reductive_tpu import native as jnative
from reductive_tpu import search as jsearch
from reductive_tpu import train_opq_chunked as j_train_opq_chunked
from reductive_tpu import train_pq_chunked as j_train_pq_chunked
from reductive_tpu_torch import io as tio
from reductive_tpu_torch import search as tsearch
from reductive_tpu_torch import train_pq_chunked
from reductive_tpu_torch.examples import pipeline, serving
from reductive_tpu_torch.parallel import launch
from torch_port_util import assert_codes_near_optimal, run_ranks, t

PROGRAMS = {"pipeline": pipeline, "serving": serving}


@pytest.fixture
def no_group(monkeypatch):
    """No launcher environment and no process group before; ``serving.main``
    must leave none after."""
    for name in launch._MULTIPROCESS_ENV_SIGNALS + ("RANK", "LOCAL_RANK", "MASTER_PORT"):
        monkeypatch.delenv(name, raising=False)
    assert not dist.is_initialized()
    yield
    assert not dist.is_initialized()


# ---------------------------------------------------------------------------
# (a) the smoke cases of tests/test_examples.py
# ---------------------------------------------------------------------------

PIPELINE_BASE = ["--n", "4000", "--d", "32", "--m", "8", "--bits", "4", "--iters", "3",
                 "--queries", "4"]
SMOKE = {
    "pipeline_ivf_virtual": ("pipeline", PIPELINE_BASE + ["--ivf", "16", "--virtual"]),
    "pipeline_disk": ("pipeline", PIPELINE_BASE + ["--ivf", "16", "--disk"]),
    "pipeline_opq": ("pipeline", ["--n", "3000"] + PIPELINE_BASE[2:] + ["--opq"]),
    "serving": ("serving", ["--n", "8000", "--d", "32", "--m", "8", "--bits", "4",
                            "--cells", "32", "--queries", "8"]),
}
SMOKE_LINES = {
    "pipeline_ivf_virtual": ("recall@10 of the planted nearest neighbor:",
                             "IVF recall@10 of the planted neighbor:",
                             "virtual: search + exact-refine recall@10:"),
    "pipeline_disk": ("disk: streamed PQ training in", "disk: IVF build from reader in",
                      "disk: IVF + disk-refine recall@10:"),
    "pipeline_opq": ("trained OPQ", "recall@10 of the planted nearest neighbor:"),
    "serving": ("MIPS IVF+refine", "sharded exhaustive scan"),
}


def line_value(line, marker):
    """The number after ``marker`` in ``line``, as tests/test_examples.py reads it."""
    return float(line.split(marker)[1].strip(" :").rstrip(")").split()[0])


@pytest.mark.parametrize("case", sorted(SMOKE))
def test_example_runs_on_the_cpu(case, capsys, tmp_path, no_group):
    program, argv = SMOKE[case]
    result = PROGRAMS[program].main(argv + ["--device", "cpu"])
    out = capsys.readouterr().out
    lines = out.splitlines()
    assert lines[0] == "device: cpu" and result["device"] == "cpu"
    for marker in SMOKE_LINES[case]:
        assert any(marker in line for line in lines), marker + " missing:\n" + out
    if program == "pipeline":
        recalls = [float(line.rsplit(" ", 1)[1]) for line in lines if "recall@10" in line]
        assert recalls and min(recalls) >= 0.75, out
        printed = [result["recall"]] + [result[k]["recall"] for k in ("ivf", "disk", "virtual")
                                        if k in result]
        assert [f"{r:.2f}" for r in printed] == [f"{r:.2f}" for r in recalls]
        assert set(result["seconds"]) >= {"write_corpus", "train_quantizer",
                                          "persist_and_reload", "encode_from_disk",
                                          "search_planted"}
        assert result["packed"] and result["searched_code_bytes"] * 2 == result["code_bytes"]
    else:
        for marker, key in (("top-1 self-hit", "self_hit"),
                            ("new rows retrievable", "retrievable"),
                            ("agreement with single-device", "sharded_agreement")):
            line = next(line for line in lines if marker in line)
            assert line_value(line, marker) >= 0.9, line
            assert f"{result[key]:.2f}" == f"{line_value(line, marker):.2f}"
        assert result["mips_agreement"] >= 0.9
        assert result["sharded_agreement"] == 1.0 and result["ranks"] == 1
        assert result["live"] == 8000


def test_serving_twice_in_one_process_leaves_no_group(capsys, no_group):
    """Each ``serving.main`` sets up its one-rank group and tears it down, so
    a second call, and then a user's own ``initialize_distributed``, each
    get a group of their own."""
    argv = ["--n", "2000", "--d", "16", "--m", "4", "--bits", "4", "--cells", "16",
            "--queries", "4", "--device", "cpu"]
    first = serving.main(argv)
    assert not dist.is_initialized()
    second = serving.main(argv)
    assert not dist.is_initialized()
    for key in ("self_hit", "mips_agreement", "retrievable", "sharded_agreement", "ranks"):
        assert second[key] == first[key], key
    assert second["sharded_agreement"] == 1.0
    capsys.readouterr()
    launch.initialize_distributed()
    try:
        assert dist.get_world_size() == 1 and dist.get_rank() == 0
    finally:
        dist.destroy_process_group()


# ---------------------------------------------------------------------------
# (b) the pipeline's steps against the JAX package
# ---------------------------------------------------------------------------

N, D, M = 3000, 32, 8


@pytest.mark.parametrize("bits,opq", [(8, False), (4, False), (4, True)],
                         ids=["pq8", "pq4_packed", "opq4_packed"])
def test_pipeline_steps_match_jax(tmp_path, bits, opq):
    path = str(tmp_path / "corpus.fvecs")
    rng = np.random.default_rng(0)
    data = pipeline.write_corpus(path, N, D, rng)
    jax_path = str(tmp_path / "jax_corpus.fvecs")
    jnative.write_fvecs(jax_path, np.random.default_rng(0).standard_normal((N, D)).astype(np.float32))
    assert filecmp.cmp(path, jax_path, shallow=False)

    j_train = j_train_opq_chunked if opq else j_train_pq_chunked
    jpq = j_train(jax.random.PRNGKey(42), jnp.asarray(data), M, bits, 3, use_kernel=False)
    jio.save(tmp_path / "jax_model.npz", jpq)
    pq = pipeline.persist_and_reload(tio.load(tmp_path / "jax_model.npz", device="cpu"),
                                     str(tmp_path / "model.npz"), "cpu")
    cb = np.asarray(jpq.codebooks)
    np.testing.assert_array_equal(pq.codebooks.numpy(), cb)
    assert (pq.projection is None) == (not opq)
    x = data
    if opq:
        np.testing.assert_array_equal(pq.projection.numpy(), np.asarray(jpq.projection))
        x = (torch.from_numpy(data) @ pq.projection).numpy()

    sample = data[:pipeline.MSE_ROWS]
    enc = pipeline.encode_from_disk(pq, path, t(sample))
    with jnative.VecsReader(path) as reader:
        j_codes = jdata.stream_encode(jpq, reader, batch_size=pipeline.BATCH)
    assert enc["codes"].dtype == np.uint8 and enc["codes"].shape == (N, M)
    assert_codes_near_optimal(cb, x, enc["codes"], j_codes, min_equal=0.999, rel_tol=1e-5)
    j_sample = jnp.asarray(sample)
    j_mse = float(jnp.mean((j_sample - jpq.reconstruct_batch(jpq.quantize_batch(j_sample))) ** 2))
    assert enc["mse"] == pytest.approx(j_mse, rel=1e-5)

    found = pipeline.search_planted(pq, data, enc["codes"], rng, 8)
    assert found["packed"] == (bits == 4)
    # The JAX program's draws: the rows after the corpus, then their noise.
    rng_j = np.random.default_rng(0)
    rng_j.standard_normal((N, D))
    planted = rng_j.integers(0, N, size=8)
    np.testing.assert_array_equal(found["planted"], planted)
    queries = data[planted] + 0.1 * rng_j.standard_normal((8, D)).astype(np.float32)
    np.testing.assert_array_equal(found["queries"].numpy(), queries)
    _, j_ids = jsearch.search(jpq, jnp.asarray(queries), jnp.asarray(enc["codes"]), top_k=10,
                              method="einsum")
    np.testing.assert_array_equal(found["ids"].numpy(), np.asarray(j_ids))
    assert pipeline.recall(planted, found["ids"]) >= 0.75


# ---------------------------------------------------------------------------
# (c) the serving steps against the JAX package
# ---------------------------------------------------------------------------

S_N, S_D, S_M, S_BITS, S_CELLS, S_Q = 4000, 16, 4, 4, 16, 8


def sphere(seed, n, d):
    x = np.random.default_rng(seed).standard_normal((n, d)).astype(np.float32)
    return x / np.linalg.norm(x, axis=1, keepdims=True)


@pytest.fixture(scope="module")
def served(tmp_path_factory):
    """An index ``reductive_tpu.ivf`` trained and built on unit rows, saved
    by ``reductive_tpu.io`` and loaded by the port; the rows and queries."""
    x = sphere(3, S_N, S_D)
    coarse, rpq = jivf.train_ivf_pq(jax.random.PRNGKey(1), jnp.asarray(x), S_CELLS, S_M, S_BITS,
                                    use_kernel=False)
    j_index = jivf.build_ivf(coarse, rpq, jnp.asarray(x), capacity="auto", use_kernel=False)
    path = tmp_path_factory.mktemp("served") / "index.npz"
    jio.save(path, j_index)
    query_rows = np.arange(0, S_N, S_N // S_Q)[:S_Q]
    return x, x[query_rows], query_rows, j_index, tio.load(path, device="cpu")


def test_serve_l2_matches_jax(served):
    x, q, rows, j_index, index = served
    got = serving.serve_l2(index, t(x), t(q), rows)
    jd, ji = jivf.ivf_search(j_index, jnp.asarray(q), top_k=serving.TOP_K, nprobe=serving.NPROBE,
                             use_kernel=False, refine_with=jnp.asarray(x))
    np.testing.assert_array_equal(got["ids"].numpy(), np.asarray(ji))
    np.testing.assert_allclose(got["dists"].numpy(), np.asarray(jd), rtol=1e-5, atol=1e-5)
    assert got["self_hit"] == 1.0


def test_serve_mips_matches_jax(served):
    x, q, rows, j_index, index = served
    l2 = serving.serve_l2(index, t(x), t(q), rows)
    got = serving.serve_mips(index, t(x), t(q), l2["ids"])
    jd, ji = jivf.ivf_search(j_index, jnp.asarray(q), top_k=serving.TOP_K, nprobe=serving.NPROBE,
                             metric="dot", use_kernel=False, refine_with=jnp.asarray(x))
    np.testing.assert_array_equal(got["ids"].numpy(), np.asarray(ji))
    np.testing.assert_allclose(got["dists"].numpy(), np.asarray(jd), rtol=1e-5, atol=1e-5)
    assert got["agreement"] == 1.0


def test_update_matches_jax(served):
    x, _, _, j_index, index = served
    x_new = sphere(4, serving.UPDATE_ROWS, S_D)
    got = serving.update(index, t(x_new), S_N)
    j_new = jivf.ivf_add(jivf.ivf_remove(j_index, np.arange(serving.UPDATE_ROWS)),
                         jnp.asarray(x_new), use_kernel=False)
    np.testing.assert_array_equal(got["index"].cell_ids.numpy(), np.asarray(j_new.cell_ids))
    np.testing.assert_array_equal(got["index"].cell_codes.numpy(), np.asarray(j_new.cell_codes))
    jd, ji = jivf.ivf_search(j_new, jnp.asarray(x_new[:4]), top_k=3, nprobe=serving.NPROBE,
                             use_kernel=False)
    np.testing.assert_array_equal(got["ids"].numpy(), np.asarray(ji))
    np.testing.assert_allclose(got["dists"].numpy(), np.asarray(jd), rtol=0, atol=1e-5)
    assert got["live"] == S_N and got["retrievable"] == 1.0


# ---------------------------------------------------------------------------
# (d) the sharded scan on two gloo ranks
# ---------------------------------------------------------------------------

SCAN_RANKS = """
from reductive_tpu_torch.examples.serving import sharded_scan

res = sharded_scan(torch.from_numpy(inputs["x"]), torch.from_numpy(inputs["q"]), 4, 4)
for key in ("ids_sharded", "ids_single"):
    out[key] = res[key].numpy()
out["agreement"], out["ranks"] = np.array(res["agreement"]), np.array(res["ranks"])
"""


def test_sharded_scan_on_two_ranks_is_search(tmp_path):
    x = sphere(5, 3001, S_D)  # an odd row count: the second rank's shard is padded
    q = x[::375][:S_Q]
    outs = run_ranks(SCAN_RANKS, 2, tmp_path, {"x": x, "q": q})
    gen = torch.Generator().manual_seed(serving.SEED_FLAT)
    flat = train_pq_chunked(gen, t(x), 4, 4, serving.FLAT_ITERATIONS)
    _, want = tsearch.search(flat, t(q), flat.quantize_batch(t(x)), top_k=serving.TOP_K,
                             metric="dot")
    for out in outs:
        np.testing.assert_array_equal(out["ids_sharded"], want.numpy())
        np.testing.assert_array_equal(out["ids_single"], want.numpy())
        assert float(out["agreement"]) == 1.0 and int(out["ranks"]) == 2


# ---------------------------------------------------------------------------
# (e) no quiet fallback to the CPU
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("program", sorted(PROGRAMS))
def test_main_without_a_device_needs_cuda(program, tmp_path, no_group):
    if torch.cuda.is_available():
        pytest.skip("this check is for a machine without a CUDA device")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        PROGRAMS[program].main(["--n", "1000"])
