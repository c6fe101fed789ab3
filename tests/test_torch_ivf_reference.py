"""The port's IVF-PQ deployment of the benchmark's BIGANN-10M search cell, at
the CPU size of its files, held to the benchmark's plain float64 reference
(``benchmark/reference/ivf.py``, which imports neither JAX nor the port):
``train_ivf_pq``, ``build_ivf`` and ``ivf_search`` on the cell's Zipf-weighted
mixture, the index and the answers judged by the cell's limits, some queries
at a near-tie of the probe, and the cell's control (bfloat16 tables) judged
not correct."""

import pytest
import torch

from benchmark import data
from benchmark.reference import ivf as ref_ivf
from benchmark.tests import cells
from reductive_tpu_torch import ivf

CELL = "bigann10m-ivf16384-pq16.search-b128-np32"
INDEX = ("ids_lost", "place_gap", "code_gap", "norm_err")
ANSWERS = ("dist_err", "rank_gap", "dup_ids", "probe_miss")


def _deployment(seed):
    """The cell's corpus, index and queries at its CPU size, from ``seed``."""
    workload, cfg = cells.tiny(CELL)
    x = data.corpus(cfg["data"], data.generator("cpu", seed, "corpus"), cfg["rows"], cfg["dim"])
    q = data.queries_near_rows(data.generator("cpu", seed, "queries"), x, cfg["queries"],
                               cfg["query_noise"])
    coarse, pq = ivf.train_ivf_pq(data.generator("cpu", seed, "train"), x, cfg["n_cells"],
                                  cfg["pq_m"], cfg["pq_bits"],
                                  coarse_iterations=cfg["coarse_iterations"],
                                  pq_iterations=cfg["pq_iterations"],
                                  train_sample=cfg["train_sample"])
    index = ivf.build_ivf(coarse, pq, x, capacity=cfg["capacity"],
                          on_overflow=cfg["on_overflow"], placement=cfg["placement"])
    return workload, x, index, q


def _near_ties(q, coarse, nprobe):
    """Each query moved onto the plane halfway between its ``nprobe``-th
    and next nearest cells, so that the probe may take either."""
    d = torch.cdist(q.double(), coarse.double())
    order = torch.argsort(d, dim=1)
    a, b = coarse[order[:, nprobe - 1]].double(), coarse[order[:, nprobe]].double()
    w = b - a
    off = (2.0 * (q.double() * w).sum(1) - (b * b).sum(1) + (a * a).sum(1)) / (2.0 * (w * w).sum(1))
    return (q.double() - off[:, None] * w).float()


def _numbers(workload, x, index, q, **kwargs):
    p = workload["params"]
    d, ids = ivf.ivf_search(index, q, p["top_k"], nprobe=p["nprobe"], **kwargs)
    numbers, notes = ref_ivf.search_numbers(q, index.coarse_centroids, index.pq.codebooks,
                                            index.cell_codes, index.cell_ids, x.shape[0],
                                            p["nprobe"], p["top_k"], d, ids)
    return numbers, notes


@pytest.mark.parametrize("seed", [0, 2**31 + 3, 4_000_000_007])
def test_the_cells_deployment_at_its_cpu_size_meets_the_reference(seed):
    workload, x, index, q = _deployment(seed)
    limits, nprobe = workload["limits"], workload["params"]["nprobe"]
    checked, _ = ref_ivf.check_index(x, index.coarse_centroids, index.pq.codebooks,
                                     index.cell_codes, index.cell_ids, index.cell_norms)
    assert checked["ids_lost"] == 0
    for name in INDEX:
        assert checked[name] <= limits[name], (name, checked[name])
    q = torch.cat([q[:48], _near_ties(q[48:64], index.coarse_centroids, nprobe)])
    numbers, notes = _numbers(workload, x, index, q, use_kernel=False)
    assert notes["edge_queries"] >= 1, notes
    assert numbers["probe_miss"] == 0
    for name in ANSWERS:
        assert numbers[name] <= limits[name], (name, numbers[name])
    # the cell's own path on the CPU: the ADC-table probe's plain version
    numbers, _ = _numbers(workload, x, index, q, use_kernel=True, splits=2)
    assert all(numbers[name] <= limits[name] for name in ANSWERS), numbers
    # its control, bfloat16 tables, fails a limit
    assert workload["control"] == "splits1"
    numbers, _ = _numbers(workload, x, index, q, use_kernel=True, splits=1)
    assert any(numbers[name] > limits[name] for name in ANSWERS), numbers
