"""A cell of a new configuration added as files alone, in a copy of the
benchmark: its configuration file, its workload file (each with its
``cpu`` cut, the workload with its ``control``), its entries in
``BENCHMARK.json`` and its name in the lists of the metrics it reports.
The checks that the tests hold every cell to then take it with no edit to
any file of the benchmark."""

from __future__ import annotations

import pytest

from benchmark import run
from benchmark.tests import cells, test_bench_cells, test_bench_files, test_bench_imports

CONFIG = "ivf-files"
CELL = f"{CONFIG}.search-b32-np4"


@pytest.fixture
def added(tmp_path, monkeypatch):
    """The copy, with the IVF test deployment written out as a
    configuration of twice the CPU rows and a search cell of 32 queries a
    request; the flat search cell's metrics list the new cell too."""
    cells.copy_benchmark(tmp_path, monkeypatch)
    search = cells.IVF_CELLS[cells.IVF_SEARCH]
    source = "the IVF-PQ deployment of the benchmark's CPU tests"
    config = {**cells.IVF_CONFIG, "name": CONFIG, "source": source,
              "rows": 2 * cells.IVF_CONFIG["rows"], "reduced": [],
              "assumed": ["a Zipf-weighted mixture of 24 centres"],
              "guarantees": ["search probes the nprobe nearest cells by float32 scores"],
              "cpu": {"rows": cells.IVF_CONFIG["rows"]}}
    workload = {**search, "name": CELL, "config": CONFIG, "traffic": "search-b32-np4",
                "params": {**search["params"], "batch": 32},
                "cpu": {"batch": search["params"]["batch"]}, "control": "splits1",
                "why": "IVF-PQ search at the CPU size, added as files"}
    cells.write_json(run.BENCH / "configs" / f"{CONFIG}.json", config)
    cells.write_json(run.BENCH / "workloads" / f"{CELL}.json", workload)
    benchmark = run.load_json(run.ROOT / "BENCHMARK.json")
    benchmark["configs"].append({"name": CONFIG, "source": source,
                                 "file": f"benchmark/configs/{CONFIG}.json", "reduced": [],
                                 "why": "IVF-PQ at the CPU size"})
    benchmark["workloads"].append({"name": CELL, "config": CONFIG, "traffic": "search-b32-np4",
                                   "chips": 1, "why": workload["why"]})
    flat = "msmarco768-opq24.flat-search-b128"
    for entry in benchmark["end_to_end"] + benchmark["per_layer"]:
        if flat in entry.get("workloads", ()):
            entry["workloads"].append(CELL)
    cells.write_json(run.ROOT / "BENCHMARK.json", benchmark)
    return benchmark


def test_an_added_cell_passes_the_file_checks(added):
    test_bench_files.check_config(added["configs"][-1], added)
    test_bench_files.check_cell(CELL, added)
    test_bench_files.check_chips(added)
    assert cells.ready(added) == [w["name"] for w in added["workloads"]]


def test_an_added_cell_is_cut_by_its_own_files(added):
    workload, config = cells.tiny(CELL)
    assert config["rows"] == cells.IVF_CONFIG["rows"] and "cpu" not in config
    assert workload["params"]["batch"] == 16 and workload["control"] == "splits1"


def test_an_added_cell_prints_the_contract_keys(added):
    test_bench_cells.check_contract(CELL, cells.benchmark_with_ivf())


def test_an_added_cell_reports_per_layer_metrics_traced(added):
    test_bench_cells.check_traced(CELL, cells.benchmark_with_ivf())


def test_an_added_cells_control_is_not_correct(added):
    test_bench_cells.check_control(CELL)


def test_an_added_cell_loads_no_jax(added):
    test_bench_imports.check_no_jax(run.ROOT)
