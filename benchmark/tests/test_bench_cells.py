"""Each traffic driver, through the harness at a CPU size: the result line's
keys, its metrics, and ``correct`` that a broken timed path or a control
turns false."""

from __future__ import annotations

import json
import subprocess
import sys

import pytest
import torch

from benchmark import run
from benchmark.tests import cells

BENCHMARK = cells.benchmark_with_ivf()
CELLS = cells.ready(BENCHMARK)
KEYS = ["correct", "attempted", "failed", "metrics", "device", "setup_phases", "checks"]


def check_contract(cell, benchmark):
    """A run prints the contract's keys, the cell's end-to-end metrics and
    its numbers, and comes out correct."""
    result = cells.run_tiny(cell)
    assert list(result) == KEYS
    assert result["correct"] is True, result["checks"]
    assert result["attempted"] >= 1 and result["failed"] == 0
    e2e, _ = run.metrics_of(cell, benchmark)
    assert set(result["metrics"]) == {e["name"] for e in e2e}
    for entry in e2e:
        m = result["metrics"][entry["name"]]
        assert m["unit"] == entry["unit"] and m["value"] > 0
    assert set(result["device"]) == {"platform", "kind", "count", "memory_peak_bytes"}
    assert set(result["checks"]) == set(cells.tiny(cell)[0]["limits"])
    assert result["setup_phases"]["start"] >= 0
    assert list(result["setup_phases"])[-2:] == ["setup", "warmup"]
    json.dumps(result)


def check_traced(cell, benchmark):
    """A traced run reports per-layer metrics only, and a breakdown."""
    result = cells.run_tiny(cell, trace=True)
    assert list(result) == KEYS[:5] + ["breakdown"] + KEYS[5:]
    _, layer = run.metrics_of(cell, benchmark)
    assert set(result["metrics"]) <= {e["name"] for e in layer}
    assert set(result["breakdown"]) == {"device_ops", "idle_gaps"}
    assert len(result["breakdown"]["idle_gaps"]) <= 10


def check_control(cell):
    """The cell's control (its path one precision lower) fails a limit."""
    result = cells.run_tiny(cell, control=cells.tiny(cell)[0]["control"])
    assert result["correct"] is False, result["checks"]


@pytest.mark.parametrize("cell", CELLS)
def test_a_run_prints_the_contract_keys(cell):
    check_contract(cell, BENCHMARK)


@pytest.mark.parametrize("cell", CELLS)
def test_a_traced_run_reports_per_layer_metrics_only(cell):
    check_traced(cell, BENCHMARK)


def test_the_search_index_is_the_deployment_seeds():
    """With a deployment seed the search cell's data and index come from it,
    whatever the run's seed, which orders the requests; without one, from
    the run's seed."""
    cell = cells.IVF_SEARCH
    index = ("place_gap", "code_gap", "norm_err")

    def numbers(seed, deployment_seed=0):
        workload, config = cells.tiny(cell)
        if deployment_seed is None:
            del workload["params"]["deployment_seed"]
        else:
            workload["params"]["deployment_seed"] = deployment_seed
        result = run.run_cell(cell, workload, config, BENCHMARK, seed=seed, seconds=0.1,
                              trace=False, device="cpu")
        assert result["correct"] is True, result["checks"]
        return [result["checks"][n] for n in index]

    assert numbers(2**31 + 5) == numbers(2**31 + 6)
    assert numbers(2**31 + 5) != numbers(2**31 + 5, deployment_seed=1)
    assert numbers(2**31 + 5, None) != numbers(2**31 + 6, None)


@pytest.mark.parametrize("cell", CELLS)
def test_the_control_is_not_correct(cell):
    check_control(cell)


def test_fp8_codes_in_the_ivf_search_cell_are_not_correct():
    """The IVF search cell's other control: its index's codes by the
    reference's float8 encode."""
    assert cells.run_tiny(cells.IVF_SEARCH, control="fp8")["correct"] is False


def _alter_answer(monkeypatch, module, name):
    real = getattr(module, name)

    def altered(*args, **kwargs):
        d, ids = real(*args, **kwargs)
        ids = ids.clone()
        ids[0, 0] = ids[0, -1]  # a row named twice, the nearest one lost
        return d, ids

    monkeypatch.setattr(module, name, altered)


def test_an_altered_ivf_answer_is_not_correct(monkeypatch):
    from reductive_tpu_torch import ivf

    _alter_answer(monkeypatch, ivf, "ivf_search")
    result = cells.run_tiny(cells.IVF_SEARCH)
    assert result["correct"] is False


def test_an_altered_flat_answer_is_not_correct(monkeypatch):
    from reductive_tpu_torch import search

    _alter_answer(monkeypatch, search, "search")
    result = cells.run_tiny("msmarco768-opq24.flat-search-b128")
    assert result["correct"] is False


def test_an_altered_code_is_not_correct(monkeypatch):
    from reductive_tpu_torch.pq.model import Pq

    real = Pq.quantize_batch

    def altered(self, x, *args, **kwargs):
        codes = real(self, x, *args, **kwargs).clone()
        k = self.codebooks.shape[1]
        codes[::7, 0] = ((codes[::7, 0].to(torch.int64) + 1) % k).to(codes.dtype)
        return codes

    monkeypatch.setattr(Pq, "quantize_batch", altered)
    assert cells.run_tiny("msmarco768-opq24.ingest-1m")["correct"] is False


@pytest.mark.parametrize("cell", list(cells.IVF_CELLS))
def test_lloyd_steps_that_leave_the_centres_unchanged_are_not_correct(monkeypatch, cell):
    from reductive_tpu_torch import ivf
    from reductive_tpu_torch.pq import train

    # the fault is planted by patching the program; restore it after the test
    monkeypatch.setattr(ivf, "_coarse_stage", ivf._coarse_stage)
    monkeypatch.setattr(train, "train_pq_chunked", train.train_pq_chunked)
    result = cells.run_tiny(cell, control="frozen")
    assert result["correct"] is False
    for name in ("coarse_shift", "codebook_shift"):
        assert result["checks"][name]["value"] > result["checks"][name]["limit"]


def test_a_probe_that_skips_a_must_cell_is_not_correct(monkeypatch):
    """Each query's nearest cell scored as the farthest, so never probed:
    it lies far inside the probe, so every valid probe holds it."""
    from reductive_tpu_torch import ivf

    real = ivf._coarse_scores

    def skipping(queries, coarse, metric):
        qc, score, q_sqn = real(queries, coarse, metric)
        score = score.scatter(1, score.argmax(dim=1, keepdim=True), float("-inf"))
        return qc, score, q_sqn

    monkeypatch.setattr(ivf, "_coarse_scores", skipping)
    result = cells.run_tiny(cells.IVF_SEARCH)
    assert result["correct"] is False
    assert any(result["checks"][n]["value"] > result["checks"][n]["limit"]
               for n in ("probe_miss", "rank_gap"))


def test_a_row_stored_in_the_wrong_cell_is_not_correct(monkeypatch):
    from reductive_tpu_torch import ivf

    real = ivf.build_ivf

    def misplaced(*args, **kwargs):
        index = real(*args, **kwargs)
        ids = index.cell_ids
        dst = int(torch.nonzero((ids < 0).any(dim=1))[0, 0])
        src = 1 if dst == 0 else 0
        occ = torch.nonzero(ids[src] >= 0)[:, 0]
        free = torch.nonzero(ids[dst] < 0)[:, 0]
        ids[dst, free[0]] = ids[src, occ[0]]
        ids[src, occ[0]] = -1
        return index

    monkeypatch.setattr(ivf, "build_ivf", misplaced)
    assert cells.run_tiny(cells.IVF_BUILD)["correct"] is False


@pytest.mark.cuda
def test_the_controls_are_not_correct_on_the_card():
    """On the card, at the CPU size: each cell's control fails a limit and
    the program passes (the full-size readings are in PERF.md)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    for cell in CELLS:
        workload, config = cells.tiny(cell)
        for control, want in ((None, True), (workload["control"], False)):
            result = run.run_cell(cell, workload, config, BENCHMARK, seed=11, seconds=0.5,
                                  trace=False, device="cuda:0", control=control)
            assert result["correct"] is want, (cell, control, result["checks"])


def test_zipf_centres_draw_a_few_large_clusters():
    from benchmark import data

    x = data.mixture(torch.Generator().manual_seed(3), 40000, 4, centres=50, centre_scale=10.0,
                     noise=0.01, zipf=1.0, centres_gen=torch.Generator().manual_seed(4))
    centres = 10.0 * torch.randn((50, 4), generator=torch.Generator().manual_seed(4))
    member = torch.cdist(x, centres).argmin(dim=1)
    sizes = torch.bincount(member, minlength=50).sort(descending=True).values.double()
    share = sizes / sizes.sum()
    harmonic = sum(1 / i for i in range(1, 51))
    assert bool((sizes > 0).all())
    assert abs(float(share[0]) - 1 / harmonic) < 0.02
    assert float(share[0] / share[9]) > 5


def test_the_command_refuses_to_run_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    proc = subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload", CELLS[0], "--seed", "1",
         "--seconds", "1", "--trace", "0"], cwd=run.ROOT, capture_output=True, text=True,
        timeout=120)
    assert proc.returncode != 0 and proc.stdout == ""
