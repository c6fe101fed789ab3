"""The benchmark's cells cut to a size the CPU runs in seconds, for the tests.

Only sizes change: counts of rows, queries, cells and alternations, widths
and codebook sizes; every other setting is the cell's own.  Each cell's cut
is in its own files: the configuration file's ``cpu`` object holds sizes
(:data:`CPU_CONFIG`; its ``data`` object, the mixture's ``centres``), the
workload file's ``cpu`` object the driver's counts (:data:`CPU_PARAMS`), and
the workload file's ``control`` names the control that must come out not
correct.  So a cell, or a configuration, is added to the tests by adding
its files.

The IVF-PQ drivers (``traffic/ivf_search.py``, ``traffic/ivf_build.py``)
have no cell in ``BENCHMARK.json`` yet; ``IVF_CELLS`` gives each a cell of
an IVF-PQ deployment at the CPU size, and :func:`benchmark_with_ivf` the
benchmark with those cells added, so that the tests drive them as a later
cell of theirs would be driven.
"""

from __future__ import annotations

import copy
import json
import shutil

from benchmark import run

CPU_CONFIG = {"rows", "dim", "queries", "pq_m", "pq_bits", "n_cells", "train_sample",
              "opq_iterations", "coarse_iterations", "pq_iterations", "encode_batch", "data"}
CPU_DATA = {"centres"}
CPU_PARAMS = {"batch", "top_k", "nprobe", "warmup_requests", "warmup_batches", "check_samples",
              "check_rows"}

IVF_CONFIG = {
    "name": "ivf-tiny", "kind": "ivf_pq", "rows": 20000, "dim": 32, "queries": 200,
    "query_noise": 0.05, "n_cells": 16, "pq_m": 8, "pq_bits": 4, "capacity": "auto",
    "on_overflow": "spill", "placement": "device", "train_sample": 16384,
    "coarse_iterations": 10, "pq_iterations": 10, "table_splits": 2,
    "data": {"kind": "mixture", "centres": 24, "centre_scale": 3.0, "noise": 0.3, "zipf": 1.0,
             "centres_seed": 0},
    "cpu": {},
}
IVF_INDEX_LIMITS = {"ids_lost": 0, "place_gap": 3e-05, "code_gap": 0.07, "norm_err": 0.001,
                    "coarse_shift": 0.35, "codebook_shift": 0.1}
IVF_CELLS = {
    "ivf-tiny.search-b16-np4": {
        "name": "ivf-tiny.search-b16-np4", "config": "ivf-tiny", "traffic": "search-b16-np4",
        "driver": "ivf_search",
        "params": {"batch": 16, "nprobe": 4, "top_k": 5, "warmup_requests": 1,
                   "check_samples": 3, "check_rows": 2000, "deployment_seed": 0},
        "cpu": {}, "control": "splits1",
        "why": "IVF-PQ search at the CPU size",
        "limits": {**IVF_INDEX_LIMITS, "dist_err": 3e-05, "rank_gap": 1e-05, "dup_ids": 0,
                   "probe_miss": 0},
    },
    "ivf-tiny.build": {
        "name": "ivf-tiny.build", "config": "ivf-tiny", "traffic": "build", "driver": "ivf_build",
        "params": {"check_samples": 1, "check_rows": 2000},
        "cpu": {}, "control": "fp8",
        "why": "IVF-PQ training and build at the CPU size",
        "limits": IVF_INDEX_LIMITS,
    },
}
IVF_SEARCH, IVF_BUILD = IVF_CELLS


def benchmark_with_ivf() -> dict:
    """``BENCHMARK.json`` with the IVF cells: the search cell reports what
    the flat search cell reports, the build cell ``build_s`` and its device's
    idle share."""
    benchmark = copy.deepcopy(run.load_json(run.ROOT / "BENCHMARK.json"))
    for cell in IVF_CELLS.values():
        benchmark["workloads"].append({k: cell[k] for k in ("name", "config", "traffic", "why")}
                                      | {"chips": 1})
    flat = "msmarco768-opq24.flat-search-b128"
    for entry in benchmark["end_to_end"] + benchmark["per_layer"]:
        if flat in entry.get("workloads", ()):
            entry["workloads"].append(IVF_SEARCH)
    benchmark["end_to_end"].insert(-1, {"name": "build_s", "unit": "s", "better": "lower",
                                        "bound": 0.05, "source": "host_clock",
                                        "workloads": [IVF_BUILD]})
    benchmark["per_layer"].append({"name": "device_idle_pct.build", "unit": "%",
                                   "better": "lower", "source": "device_trace",
                                   "layer": "device", "moves": "build_s",
                                   "workloads": [IVF_BUILD]})
    return benchmark


def _files(cell: str) -> tuple[dict, dict]:
    if cell in IVF_CELLS:
        return copy.deepcopy(IVF_CELLS[cell]), copy.deepcopy(IVF_CONFIG)
    workload, config = run.cell_files(cell)
    return copy.deepcopy(workload), copy.deepcopy(config)


def missing(cell: str) -> list[str]:
    """``"<file>: <key>"`` for each key of the CPU cut that the cell's
    files lack (``cpu`` in both, ``control`` in the workload file)."""
    workload, config = _files(cell)
    where = {"workload": f"benchmark/workloads/{cell}.json",
             "config": f"benchmark/configs/{workload['config']}.json"}
    need = [("workload", workload, "cpu"), ("workload", workload, "control"),
            ("config", config, "cpu")]
    return [f"{where[kind]}: {key}" for kind, obj, key in need if key not in obj]


def ready(benchmark: dict) -> list[str]:
    """The benchmark's cells whose files carry their CPU cut."""
    return [w["name"] for w in benchmark["workloads"] if not missing(w["name"])]


def tiny(cell: str) -> tuple[dict, dict]:
    """The cell's workload and configuration files, cut to the CPU size by
    their ``cpu`` objects."""
    lacking = missing(cell)
    if lacking:
        raise ValueError(f"no CPU cut for {cell}: {', '.join(lacking)}")
    workload, config = _files(cell)
    cut = config.pop("cpu")
    config.update({k: v for k, v in cut.items() if k != "data"})
    config["data"] = {**config["data"], **cut.get("data", {})}
    workload["params"].update(workload.pop("cpu"))
    return workload, config


def run_tiny(cell: str, *, seed: int = 7, seconds: float = 0.2, trace: bool = False,
             control=None) -> dict:
    workload, config = tiny(cell)
    return run.run_cell(cell, workload, config, benchmark_with_ivf(), seed=seed,
                        seconds=seconds, trace=trace, device="cpu", control=control)


def copy_benchmark(dest, monkeypatch):
    """``BENCHMARK.json`` and ``benchmark/`` copied into ``dest``, and
    :mod:`run`'s paths pointed at the copy for the rest of the test: a
    cell or a configuration is then added by writing files there."""
    import shutil

    shutil.copy(run.ROOT / "BENCHMARK.json", dest / "BENCHMARK.json")
    shutil.copytree(run.BENCH, dest / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__", "*.pyc"))
    monkeypatch.setattr(run, "ROOT", dest)
    monkeypatch.setattr(run, "BENCH", dest / "benchmark")
    return dest


def write_json(path, obj) -> None:
    path.write_text(json.dumps(obj, indent=2) + "\n")
