"""search_sharded and ivf_search_sharded against the JAX package's (CPU).

Two ranks of one gloo process group run in child processes; the JAX side
runs on two devices of the virtual mesh of tests/conftest.py, on the same
arrays.  Exhaustive search: a corpus that does not divide evenly (301 rows),
both metrics, the streamed scorer, the decode scorer and packed-u4 codes;
ids equal to the JAX package's and scores within 1e-5, and bit for bit the
port's single-process ``search``.  IVF: nine cells over two ranks (one empty
cell padded in), full coverage bit for bit the port's ``ivf_search`` at
every cell, partial probing at least as good as it (the superset property of
tests/test_ivf.py), both metrics, packed cells; ids equal to the JAX
package's and distances within its tolerance.  The errors are the JAX
package's, word for word.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from reductive_tpu import ivf as jivf
from reductive_tpu import parallel as jpar
from reductive_tpu import search as jsearch
from reductive_tpu.pq.model import Pq as JPq
from reductive_tpu_torch import Pq, convert, ivf, search
from reductive_tpu_torch import io as tio
from reductive_tpu_torch.ops.packing import pack_u4_codes
from torch_port_util import orthonormal, run_ranks

TOP_K = 7
SEARCHES = {
    "l2": {},
    "dot": dict(metric="dot"),
    "streamed": dict(stream_chunk=64),
    "decode": dict(method="decode"),
    "packed": dict(packed=True, method="kernel"),
}
NPROBES = {"full": 5, "partial": 2}
ERRORS = {
    "top_k": dict(top_k=152),
    "top_k_zero": dict(top_k=0),
    "method": dict(method="nope"),
    "metric": dict(metric="cosine"),
}

RANKS = """
from reductive_tpu_torch import Pq, io
from reductive_tpu_torch.ivf import ivf_search_sharded
from reductive_tpu_torch.search import search_sharded

SEARCHES = {searches!r}
NPROBES = {nprobes!r}
ERRORS = {errors!r}
mesh = make_mesh(devices="cpu")
pq = Pq(codebooks=torch.from_numpy(inputs["cb"]), projection=torch.from_numpy(inputs["r"]))
q = torch.from_numpy(inputs["q"])
for name, kw in SEARCHES.items():
    codes = inputs["packed" if kw.get("packed") else "codes"]
    d, i = search_sharded(pq, q, codes, {top_k}, mesh=mesh, **kw)
    out[f"search_{{name}}_d"], out[f"search_{{name}}_i"] = d.numpy(), i.numpy()
for name, kw in ERRORS.items():
    kw = dict(kw)
    try:
        search_sharded(pq, q, inputs["codes"], kw.pop("top_k", {top_k}), mesh=mesh, **kw)
    except ValueError as e:
        out[f"error_{{name}}"] = np.array(str(e))
iq = torch.from_numpy(inputs["iq"])
for packed in ("", "_packed"):
    index = io.load(str(inputs["index" + packed]), device="cpu")
    for metric in ("l2", "dot"):
        for name, nprobe in NPROBES.items():
            d, i = ivf_search_sharded(index, iq, 5, nprobe=nprobe, mesh=mesh, metric=metric)
            out[f"ivf{{packed}}_{{metric}}_{{name}}_d"] = d.numpy()
            out[f"ivf{{packed}}_{{metric}}_{{name}}_i"] = i.numpy()
    try:
        ivf_search_sharded(index, iq, 5, nprobe=6, mesh=mesh)
    except ValueError as e:
        out[f"error_nprobe{{packed}}"] = np.array(str(e))
try:
    ivf_search_sharded(index, iq, 5, mesh=mesh, metric="cosine")
except ValueError as e:
    out["error_ivf_metric"] = np.array(str(e))
"""


def clustered(seed=11, n=400, d=8, cells=9):
    rng = np.random.default_rng(seed)
    centres = (3.0 * rng.standard_normal((cells, d))).astype(np.float32)
    x = centres[rng.integers(0, cells, n)] + 0.3 * rng.standard_normal((n, d))
    coarse = centres + 0.05 * rng.standard_normal(centres.shape)
    return x.astype(np.float32), coarse.astype(np.float32)


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("search_ranks")
    rng = np.random.default_rng(7)
    cb = rng.standard_normal((4, 16, 8), dtype=np.float32)
    codes = rng.integers(0, 16, (301, 4)).astype(np.uint8)
    x, coarse = clustered()
    rpq = Pq(codebooks=torch.from_numpy((0.3 * rng.standard_normal((2, 16, 4))).astype(np.float32)))
    paths = {}
    for packed in (False, True):
        index = ivf.build_ivf(torch.from_numpy(coarse), rpq, torch.from_numpy(x),
                              capacity="auto", packed=packed)
        paths[packed] = str(tmp / f"index{int(packed)}.npz")
        tio.save(paths[packed], index)
    iq = (x[::57][:7] + 0.05 * rng.standard_normal((7, 8))).astype(np.float32)
    inputs = dict(cb=cb, r=orthonormal(3, 32), q=rng.standard_normal((5, 32), dtype=np.float32),
                  codes=codes, packed=pack_u4_codes(torch.from_numpy(codes)).numpy(), iq=iq,
                  index=np.array(paths[False]), index_packed=np.array(paths[True]))
    body = RANKS.format(searches=SEARCHES, nprobes=NPROBES, errors=ERRORS, top_k=TOP_K)
    outs = run_ranks(body, 2, tmp, inputs)
    for out in outs[1:]:
        assert out.keys() == outs[0].keys()
        for key in out:
            np.testing.assert_array_equal(out[key], outs[0][key])
    return inputs, outs[0]


def jmesh():
    return jpar.make_mesh((2,), ("data",), devices=jax.devices()[:2])


@pytest.mark.parametrize("name", SEARCHES)
def test_search_sharded_matches_jax_and_the_single_process_search(ranks, name):
    inputs, out = ranks
    kw = SEARCHES[name]
    codes = inputs["packed" if kw.get("packed") else "codes"]
    d, i = out[f"search_{name}_d"], out[f"search_{name}_i"]
    pq = Pq(codebooks=torch.from_numpy(inputs["cb"]), projection=torch.from_numpy(inputs["r"]))
    want_d, want_i = search.search(pq, torch.from_numpy(inputs["q"]), torch.from_numpy(codes),
                                   TOP_K, **kw)
    np.testing.assert_array_equal(d, want_d.numpy())
    np.testing.assert_array_equal(i, want_i.numpy())
    jpq = JPq(codebooks=jnp.asarray(inputs["cb"]), projection=jnp.asarray(inputs["r"]))
    # The JAX package runs its ADC kernel on a TPU only: packed codes are
    # held to its plain scorer on the unpacked codes, at the kernel's
    # default table precision (splits=2, about 2^-16 relative).
    tol = 1e-4 if kw.get("packed") else 1e-5
    if kw.get("packed"):
        codes, kw = inputs["codes"], {}
    jd, ji = jsearch.search_sharded(jpq, jnp.asarray(inputs["q"]), jnp.asarray(codes), TOP_K,
                                    mesh=jmesh(), **kw)
    np.testing.assert_array_equal(i, np.asarray(ji))
    np.testing.assert_allclose(d, np.asarray(jd), rtol=tol, atol=tol)


@pytest.mark.parametrize("name", ERRORS)
def test_search_sharded_errors_are_the_jax_packages(ranks, name):
    inputs, out = ranks
    kw = dict(ERRORS[name])
    jpq = JPq(codebooks=jnp.asarray(inputs["cb"]))
    with pytest.raises(ValueError) as e:
        jsearch.search_sharded(jpq, jnp.asarray(inputs["q"]), jnp.asarray(inputs["codes"]),
                               kw.pop("top_k", TOP_K), mesh=jmesh(), **kw)
    assert str(out[f"error_{name}"]) == str(e.value)


def j_index(path):
    coarse, cb, proj, codes, ids, norms, _ = convert.ivf_to_numpy(tio.load(path, device="cpu"))
    return jivf.IvfPq(coarse_centroids=jnp.asarray(coarse), pq=JPq(codebooks=jnp.asarray(cb)),
                      cell_codes=jnp.asarray(codes), cell_ids=jnp.asarray(ids),
                      cell_norms=jnp.asarray(norms))


@pytest.mark.parametrize("packed", ["", "_packed"])
@pytest.mark.parametrize("metric", ["l2", "dot"])
@pytest.mark.parametrize("name", NPROBES)
def test_ivf_search_sharded_matches_jax(ranks, packed, metric, name):
    inputs, out = ranks
    d, i = out[f"ivf{packed}_{metric}_{name}_d"], out[f"ivf{packed}_{metric}_{name}_i"]
    iq = inputs["iq"]
    jd, ji = jivf.ivf_search_sharded(j_index(str(inputs["index" + packed])), jnp.asarray(iq), 5,
                                     nprobe=NPROBES[name], mesh=jmesh(), metric=metric)
    np.testing.assert_array_equal(i, np.asarray(ji))
    atol = 1e-5 * float((iq.astype(np.float64) ** 2).sum(1).max())
    np.testing.assert_allclose(d, np.asarray(jd), rtol=1e-5, atol=atol)


@pytest.mark.parametrize("packed", ["", "_packed"])
@pytest.mark.parametrize("metric", ["l2", "dot"])
def test_ivf_search_sharded_against_the_single_process_search(ranks, packed, metric):
    inputs, out = ranks
    index = tio.load(str(inputs["index" + packed]), device="cpu")
    iq = torch.from_numpy(inputs["iq"])
    # Every cell probed: ivf_search's result, bit for bit.
    want_d, want_i = ivf.ivf_search(index, iq, 5, nprobe=index.n_cells, metric=metric)
    np.testing.assert_array_equal(out[f"ivf{packed}_{metric}_full_d"], want_d.numpy())
    np.testing.assert_array_equal(out[f"ivf{packed}_{metric}_full_i"], want_i.numpy())
    # Two cells a rank: a superset of ivf_search's two probes, so the j-th
    # best score is no worse at every j.
    d = out[f"ivf{packed}_{metric}_partial_d"]
    single_d, _ = ivf.ivf_search(index, iq, 5, nprobe=2, metric=metric)
    assert (d <= single_d.numpy()).all()


@pytest.mark.parametrize("packed", ["", "_packed"])
def test_ivf_search_sharded_errors_are_the_jax_packages(ranks, packed):
    inputs, out = ranks
    index = j_index(str(inputs["index" + packed]))
    with pytest.raises(ValueError) as e:
        jivf.ivf_search_sharded(index, jnp.asarray(inputs["iq"]), 5, nprobe=6, mesh=jmesh())
    assert str(out[f"error_nprobe{packed}"]) == str(e.value)
    with pytest.raises(ValueError) as e:
        jivf.ivf_search_sharded(index, jnp.asarray(inputs["iq"]), 5, mesh=jmesh(), metric="cosine")
    assert str(out["error_ivf_metric"]) == str(e.value)
