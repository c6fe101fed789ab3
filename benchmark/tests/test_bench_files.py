"""Every file that ``BENCHMARK.json`` names is found by name, and the file keeps
to the benchmark's contract: names, units, keys, bounds and the window."""

from __future__ import annotations

import ast
import copy
import json
import re

import pytest

from benchmark import run
from benchmark.tests import cells

BENCHMARK = run.load_json(run.ROOT / "BENCHMARK.json")
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}
CELLS = [w["name"] for w in BENCHMARK["workloads"]]
METRICS = BENCHMARK["end_to_end"] + BENCHMARK["per_layer"]
# A configuration's shapes are never cut: the rows' width, the codes' and
# the data's distribution.
SHAPES = {"dim", "pq_m", "pq_bits", "data"}


def one_line(text: str, most: int = 200) -> bool:
    return 1 <= len(text) <= most and "\n" not in text and "\t" not in text


def test_top_level_keys_and_window():
    assert set(BENCHMARK) == {"command", "paths", "run_seconds", "configs", "workloads",
                              "end_to_end", "per_layer"}
    assert BENCHMARK["paths"] == ["benchmark"]
    assert BENCHMARK["command"] == ["python3", "benchmark/run.py"]
    assert isinstance(BENCHMARK["run_seconds"], int) and 1 <= BENCHMARK["run_seconds"] <= 51
    assert len(json.dumps(BENCHMARK)) < 64 * 1024


def test_the_full_check_fits_its_time_with_24_cells():
    runs = 2 + 14 * 24
    assert runs * (BENCHMARK["run_seconds"] + 60) + 24 * 2 * 90 + 1200 <= 43200


def check_config(entry, benchmark):
    """A configuration's entry and its file: the file is found by name and
    agrees with the entry; ``reduced``, the keys cut from the source, is
    the same list in both, each a key of the file and none a shape."""
    assert set(entry) == {"name", "source", "file", "reduced", "why"}
    assert NAME.match(entry["name"]) and one_line(entry["source"]) and one_line(entry["why"])
    path = run.ROOT / entry["file"]
    assert path == run.BENCH / "configs" / f"{entry['name']}.json"
    config = run.load_json(path)
    assert config["name"] == entry["name"] and config["source"] == entry["source"]
    assert isinstance(entry["reduced"], list) and config["reduced"] == entry["reduced"]
    assert len(entry["reduced"]) <= 16
    for key in entry["reduced"]:
        assert isinstance(key, str) and NAME.match(key), key
        assert key in config and key not in SHAPES, key
    assert config["assumed"] and config["guarantees"]
    assert any(w["config"] == entry["name"] for w in benchmark["workloads"])


def check_cell(cell, benchmark):
    """A cell's entry and its files: found by name, with a driver, the
    metrics it reports and their readers."""
    entry = next(w for w in benchmark["workloads"] if w["name"] == cell)
    assert set(entry) == {"name", "config", "traffic", "chips", "why"}
    assert entry["chips"] in (1, 4) and one_line(entry["why"])
    assert cell == f"{entry['config']}.{entry['traffic']}"
    workload, config = run.cell_files(cell)
    assert workload["name"] == cell and workload["config"] == entry["config"]
    assert workload["traffic"] == entry["traffic"] and workload["why"] == entry["why"]
    assert config["name"] == entry["config"]
    assert (run.BENCH / "traffic" / f"{workload['driver']}.py").is_file()
    e2e, layer = run.metrics_of(cell, benchmark)
    names = {e["name"] for e in e2e}
    assert "setup_s" in names and len(names) >= 2 and layer
    for entry in layer:
        assert entry["moves"] in names
        assert run.reader_path(entry["name"]).is_file()


def check_chips(benchmark):
    """At most a quarter of the cells, rounded down, ask for four chips;
    one always may."""
    four = sum(w["chips"] == 4 for w in benchmark["workloads"])
    assert four <= max(1, len(benchmark["workloads"]) // 4), four


@pytest.mark.parametrize("entry", BENCHMARK["configs"], ids=lambda e: e["name"])
def test_config_file_is_found_and_matches(entry):
    check_config(entry, BENCHMARK)


@pytest.mark.parametrize("cell", CELLS)
def test_cell_files_are_found_by_name(cell):
    check_cell(cell, BENCHMARK)


def test_few_cells_ask_for_four_chips():
    check_chips(BENCHMARK)


@pytest.mark.parametrize("cell", CELLS)
def test_cell_files_carry_their_cpu_cut(cell):
    lacking = cells.missing(cell)
    assert not lacking, f"missing: {', '.join(lacking)}"


@pytest.mark.parametrize("cell", CELLS)
def test_a_cpu_cut_changes_only_sizes(cell):
    workload, config = run.cell_files(cell)
    cut = config.get("cpu", {})
    assert set(cut) <= cells.CPU_CONFIG and set(cut.get("data", {})) <= cells.CPU_DATA
    assert set(workload.get("cpu", {})) <= cells.CPU_PARAMS
    sizes = [v for k, v in cut.items() if k != "data"]
    sizes += list(cut.get("data", {}).values()) + list(workload.get("cpu", {}).values())
    assert all(type(v) is int and v > 0 for v in sizes), sizes


def _cut(tmp_path, monkeypatch, reduced):
    """The benchmark copied, its first configuration cut: ``rows`` halved
    in the file, and ``reduced`` in the file and the entry."""
    cells.copy_benchmark(tmp_path, monkeypatch)
    benchmark = run.load_json(run.ROOT / "BENCHMARK.json")
    entry = benchmark["configs"][0]
    entry["reduced"] = reduced
    path = run.ROOT / entry["file"]
    config = run.load_json(path)
    config["rows"] //= 2
    config["reduced"] = reduced
    cells.write_json(path, config)
    return entry, benchmark


def test_a_cut_configuration_that_names_its_keys_passes(tmp_path, monkeypatch):
    check_config(*_cut(tmp_path, monkeypatch, ["rows", "queries"]))


@pytest.mark.parametrize("reduced", [["rows", "no_such_key"], ["dim"], ["rows", 3], "rows"],
                         ids=["a-key-the-file-lacks", "a-shape", "not-a-name", "not-a-list"])
def test_a_cut_configuration_that_names_a_wrong_key_fails(tmp_path, monkeypatch, reduced):
    with pytest.raises(AssertionError):
        check_config(*_cut(tmp_path, monkeypatch, reduced))


def test_a_cut_configuration_whose_file_and_entry_differ_fails(tmp_path, monkeypatch):
    entry, benchmark = _cut(tmp_path, monkeypatch, ["rows"])
    entry["reduced"] = []
    with pytest.raises(AssertionError):
        check_config(entry, benchmark)


@pytest.mark.parametrize("count, four, admitted", [(2, 1, True), (2, 2, False), (7, 1, True),
                                                    (8, 2, True), (8, 3, False), (24, 6, True),
                                                    (24, 7, False)])
def test_four_chip_cells_are_admitted_up_to_a_quarter(count, four, admitted):
    benchmark = {"workloads": [{"name": f"c{i}", "chips": 4 if i < four else 1}
                               for i in range(count)]}
    if admitted:
        check_chips(benchmark)
    else:
        with pytest.raises(AssertionError):
            check_chips(benchmark)


def test_a_four_chip_cell_passes_the_cell_check():
    benchmark = copy.deepcopy(BENCHMARK)
    benchmark["workloads"][0]["chips"] = 4
    check_cell(CELLS[0], benchmark)
    benchmark["workloads"][0]["chips"] = 2
    with pytest.raises(AssertionError):
        check_cell(CELLS[0], benchmark)


def test_cells_are_distinct_pairs():
    pairs = [(w["config"], w["traffic"]) for w in BENCHMARK["workloads"]]
    assert len(set(pairs)) == len(pairs) == len(set(CELLS))


@pytest.mark.parametrize("entry", METRICS, ids=lambda e: e["name"])
def test_metric_entry(entry):
    assert NAME.match(entry["name"]) and UNIT.match(entry["unit"])
    assert entry["better"] in ("lower", "higher") and entry["source"] in SOURCES
    for cell in entry.get("workloads", []):
        assert cell in CELLS
    if entry in BENCHMARK["end_to_end"]:
        assert set(entry) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
        assert 0.01 <= entry["bound"] <= 0.25
        assert entry["source"] in ("host_clock", "device_trace")
    else:
        assert set(entry) - {"workloads"} == {"name", "unit", "better", "source", "layer",
                                             "moves"}
        assert one_line(entry["layer"])
        assert entry["name"].endswith("_roofline") or "roofline" not in entry["name"]


def test_metric_names_are_unique():
    names = [m["name"] for m in METRICS]
    assert len(set(names)) == len(names)


@pytest.mark.parametrize("path", sorted((run.BENCH / "metrics").glob("*.py")),
                         ids=lambda p: p.name)
def test_every_reader_reads_a_metric_of_the_benchmark(path):
    assert path in {run.reader_path(m["name"]) for m in BENCHMARK["per_layer"]}
    tree = ast.parse(path.read_text())
    read = [n for n in tree.body if isinstance(n, ast.FunctionDef) and n.name == "read"]
    assert [a.arg for a in read[0].args.args] == ["trace", "metric"]


def test_a_metric_falls_back_to_the_reader_of_its_family():
    metrics = run.BENCH / "metrics"
    assert run.reader_path("aten_pct.search") == metrics / "aten_pct.search.py"
    assert run.reader_path("device_idle_pct.build") == metrics / "device_idle_pct.py"
    assert run.reader_path("adc_roofline") == metrics / "roofline.py"
    with pytest.raises(FileNotFoundError):
        run.reader_path("no_such_metric.search")


def test_every_file_under_paths_is_named_from_name_characters():
    for path in run.BENCH.rglob("*"):
        if "__pycache__" in path.parts or path.is_dir():
            continue
        rel = path.relative_to(run.ROOT).as_posix()
        assert re.match(r"^[A-Za-z0-9_./-]{1,200}$", rel), rel
