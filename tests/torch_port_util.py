"""Shared helpers of the ``test_torch_*`` files: seeded float32 inputs that
go through both packages, distance bookkeeping for near-tie codes, and the
ranks of a process group run in child processes (:func:`run_ranks`)."""

import os
import socket
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

import jax.numpy as jnp


def make_pq_data(seed, n, m, k, ds):
    """``(codebooks (m, k, ds), x (n, m*ds))`` as float32 numpy arrays."""
    rng = np.random.default_rng(seed)
    cb = rng.standard_normal((m, k, ds), dtype=np.float32)
    x = rng.standard_normal((n, m * ds), dtype=np.float32)
    return cb, x


def orthonormal(seed, d):
    """A random orthonormal ``(d, d)`` float32 matrix."""
    rng = np.random.default_rng(seed)
    q, _ = np.linalg.qr(rng.standard_normal((d, d)))
    return q.astype(np.float32)


def t(a):
    """numpy -> CPU tensor."""
    return torch.from_numpy(np.array(a))


def j(a):
    """numpy -> JAX array of the same dtype."""
    return jnp.asarray(a)


def all_distances(cb, x):
    """Exact squared distances ``(n, m, k)`` in float64."""
    m, k, ds = cb.shape
    xs = x.reshape(x.shape[0], m, ds).astype(np.float64)
    diff = xs[:, :, None, :] - cb.astype(np.float64)[None]
    return np.sum(diff * diff, axis=3)


def assert_codes_near_optimal(cb, x, codes, other, min_equal, rel_tol):
    """``codes`` equal ``other`` on at least ``min_equal`` of the entries,
    and wherever they differ the centroid ``codes`` chose is within
    ``rel_tol`` relative of the best distance."""
    codes = np.asarray(codes).astype(np.int64)
    other = np.asarray(other).astype(np.int64)
    assert codes.shape == other.shape
    equal = np.mean(codes == other)
    assert equal >= min_equal, f"only {equal:.5f} of codes agree"
    dist = all_distances(cb, x)
    chosen = np.take_along_axis(dist, codes[:, :, None], axis=2)[:, :, 0]
    best = dist.min(axis=2)
    differ = codes != other
    if differ.any():
        rel = (chosen[differ] - best[differ]) / best[differ]
        assert rel.max() <= rel_tol, f"a differing code is {rel.max():.3e} relative off the best"


def near_tie_rows(cb, x, a, b, rel):
    """Rows where codes ``a`` and ``b`` differ, each checked to be a near-tie:
    the two distances within ``rel`` of ``|x_j| max|2c_j| + max|c_j|^2``, the
    scale of a split product's error (at ds = 2 with many centroids the
    distances themselves are far smaller)."""
    differ = np.flatnonzero((a != b).any(axis=1))
    if len(differ):
        m, k, ds = cb.shape
        dist = all_distances(cb, x)
        da = np.take_along_axis(dist, a[:, :, None].astype(np.int64), axis=2)[:, :, 0]
        db = np.take_along_axis(dist, b[:, :, None].astype(np.int64), axis=2)[:, :, 0]
        cn = np.sqrt((cb.astype(np.float64) ** 2).sum(axis=2)).max(axis=1)
        xn = np.sqrt((x.reshape(-1, m, ds).astype(np.float64) ** 2).sum(axis=2))
        scale = 2 * xn * cn[None] + cn[None] ** 2
        assert (np.abs(da - db) / scale)[differ].max() <= rel
    return differ


# ---------------------------------------------------------------------------
# Ranks of a process group in child processes
# ---------------------------------------------------------------------------

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_RANK_HEAD = """\
import os, sys
sys.path.insert(0, {root!r})
import numpy as np
import torch
import torch.distributed as dist

torch.set_num_threads(1)
from reductive_tpu_torch.parallel import initialize_distributed, make_mesh

rank, world, port, workdir = int(sys.argv[1]), int(sys.argv[2]), int(sys.argv[3]), sys.argv[4]
initialize_distributed(f"127.0.0.1:{{port}}", world, rank, backend="gloo")
inputs = dict(np.load(os.path.join(workdir, "inputs.npz")))
out = {{}}
"""

_RANK_TAIL = """
np.savez(os.path.join(workdir, f"out_{rank}.npz"), **out)
dist.destroy_process_group()
"""


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def run_ranks(body: str, world: int, workdir, inputs: dict, timeout: float = 240) -> list:
    """Run ``body`` in ``world`` child processes, the ranks of one gloo
    process group on the CPU (``torch.distributed``), and return each
    rank's ``out`` dict of arrays.  The children import the port and numpy
    only, never a test module (so no JAX); ``body`` sees ``rank``,
    ``world``, ``workdir``, ``inputs`` (the arrays given here) and fills
    ``out``.  A child that fails or outlives ``timeout`` fails the test."""
    workdir = str(workdir)
    np.savez(os.path.join(workdir, "inputs.npz"), **inputs)
    script = os.path.join(workdir, "ranks.py")
    with open(script, "w") as f:
        f.write(_RANK_HEAD.format(root=_ROOT) + textwrap.dedent(body) + _RANK_TAIL)
    port = str(free_port())
    env = {k: v for k, v in os.environ.items()
           if k not in ("WORLD_SIZE", "RANK", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT")}
    procs = [subprocess.Popen([sys.executable, script, str(r), str(world), port, workdir],
                              cwd=_ROOT, env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT)
             for r in range(world)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=timeout)[0].decode(errors="replace"))
    except subprocess.TimeoutExpired:
        for p in procs:
            p.kill()
            p.communicate()
        pytest.fail("the ranks timed out")
    for r, (p, text) in enumerate(zip(procs, outs)):
        if p.returncode != 0:
            pytest.fail(f"rank {r} exited {p.returncode}:\n{text[-3000:]}")
    return [dict(np.load(os.path.join(workdir, f"out_{r}.npz"))) for r in range(world)]
