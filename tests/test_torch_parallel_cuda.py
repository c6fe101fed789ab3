"""The sharded entries on a GPU: a one-rank NCCL group and two gloo ranks on
``cuda:0``, each rank a child process.

These tests need an NVIDIA GPU and ``nvcc``; elsewhere they skip.  Run them
on the card with

    python -m pytest tests/test_torch_parallel_cuda.py -q --noconftest

One rank over NCCL: the chunked PQ trainer, k-means at d=64 (the deep
statistics kernel), the in-memory trainer, encode and search bit for bit the
single-card entries.  Two ranks over gloo on the one card: every result the
same bits on both ranks, the trainers within f32 partial-sum grouping of the
single-card ones, encode, search at both metrics and IVF search over every
cell bit for bit the single-card entries.
"""

import os
import socket
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

pytestmark = pytest.mark.cuda

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

RANK = """
import os, sys
sys.path.insert(0, {root!r})
import numpy as np
import torch
import torch.distributed as dist
import reductive_tpu_torch as trt
from reductive_tpu_torch import Pq, ivf, kmeans, ops, parallel, search

rank, world, port, workdir = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4]
if world == 1:
    parallel.initialize_distributed()  # no launcher: one process, NCCL
else:
    parallel.initialize_distributed(f"127.0.0.1:{{port}}", world, rank, backend="gloo")
dev = torch.device("cuda", torch.cuda.current_device())
mesh = parallel.make_mesh()
out = {{"backend": np.array(dist.get_backend())}}
gen = lambda: torch.Generator(device=dev).manual_seed(7)
g = torch.Generator(device=dev).manual_seed(0)
x = torch.randn((1 << 16, 32), generator=g, device=dev)
pq = Pq(codebooks=torch.randn((8, 64, 4), generator=g, device=dev))
q = torch.randn((16, 32), generator=g, device=dev)

out["pqc"] = parallel.train_pq_chunked_sharded(gen(), x, 8, 6, 4, mesh=mesh).codebooks
out["pqc_single"] = trt.train_pq_chunked(gen(), x, 8, 6, 4).codebooks
out["pq"] = parallel.train_pq_sharded(gen(), x[:4096], 8, 6, 3, mesh=mesh).codebooks
out["pq_single"] = trt.train_pq(gen(), x[:4096], 8, 6, 3).codebooks
xk = torch.randn((1 << 15, 64), generator=g, device=dev)
out["km"], out["km_loss"] = parallel.sharded_kmeans(mesh, xk, xk[:256].clone(), 2)
out["km_single"], out["km_loss_single"] = kmeans.kmeans_with_centroids_chunked(
    xk, xk[:256].clone(), 2)
codes = parallel.encode_sharded(pq, x, mesh=mesh)
out["codes"], out["codes_single"] = codes, ops.pq_encode(pq.codebooks, x)
for metric in ("l2", "dot"):
    out[f"search_{{metric}}"] = torch.stack([
        t.double() for t in search.search_sharded(pq, q, codes, 10, mesh=mesh, metric=metric)])
    out[f"search_{{metric}}_single"] = torch.stack([
        t.double() for t in search.search(pq, q, codes, 10, metric=metric)])
for key in ("pqc", "pq"):
    for name in (key, f"{{key}}_single"):
        model = Pq(codebooks=out[name])
        out[f"{{name}}_mse"] = (model.reconstruct_batch(model.quantize_batch(x)) - x).pow(2).mean()
coarse = x[:16].clone()
index = ivf.build_ivf(coarse, Pq(codebooks=0.3 * pq.codebooks), x, capacity="auto")
out["ivf"] = torch.cat([t.double() for t in ivf.ivf_search_sharded(
    index, q, 10, nprobe=16 // world, mesh=mesh)])
out["ivf_single"] = torch.cat([t.double() for t in ivf.ivf_search(index, q, 10, nprobe=16)])
np.savez(os.path.join(workdir, f"out_{{rank}}.npz"),
         **{{k: v.cpu().numpy() if isinstance(v, torch.Tensor) else v for k, v in out.items()}})
dist.destroy_process_group()
"""


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def run_ranks(world, tmp_path):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    script = tmp_path / "rank.py"
    script.write_text(textwrap.dedent(RANK.format(root=ROOT)))
    env = {k: v for k, v in os.environ.items()
           if k not in ("WORLD_SIZE", "RANK", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT")}
    port = str(_free_port())
    procs = [subprocess.Popen([sys.executable, str(script), str(r), str(world), port,
                               str(tmp_path)], env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT) for r in range(world)]
    try:
        texts = [p.communicate(timeout=600)[0].decode(errors="replace") for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    for r, (p, text) in enumerate(zip(procs, texts)):
        assert p.returncode == 0, f"rank {r} exited {p.returncode}:\n{text[-3000:]}"
    return [dict(np.load(tmp_path / f"out_{r}.npz")) for r in range(world)]


def test_one_rank_nccl_is_the_single_card_entries(tmp_path):
    (out,) = run_ranks(1, tmp_path)
    assert str(out["backend"]) == "nccl"
    for key in ("pqc", "pq", "km", "km_loss", "codes", "search_l2", "search_dot", "ivf"):
        np.testing.assert_array_equal(out[key], out[f"{key}_single"], err_msg=key)


def test_two_gloo_ranks_on_one_card(tmp_path):
    outs = run_ranks(2, tmp_path)
    assert str(outs[0]["backend"]) == "gloo"
    for key in outs[0]:
        np.testing.assert_array_equal(outs[1][key], outs[0][key], err_msg=key)
    out = outs[0]
    for key in ("codes", "search_l2", "search_dot", "ivf"):
        np.testing.assert_array_equal(out[key], out[f"{key}_single"], err_msg=key)
    # The trainers: the same model up to the grouping of the f32 sums.
    for key, single in (("pqc_mse", "pqc_single_mse"), ("pq_mse", "pq_single_mse"),
                        ("km_loss", "km_loss_single")):
        np.testing.assert_allclose(out[key], out[single], rtol=1e-4, err_msg=key)
