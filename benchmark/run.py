"""The benchmark of ``reductive_tpu_torch`` on one card.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

A cell ``<config>.<traffic>`` is the file ``benchmark/workloads/<cell>.json``:
its configuration (``benchmark/configs/<config>.json``), the traffic driver
that runs it (``benchmark/traffic/<driver>.py``), the driver's parameters,
and the limits of the numbers that decide ``correct``.  For the CPU tests
(``benchmark/tests/cells.py``) the workload file also carries ``cpu``, its
parameters cut to a size the CPU runs in seconds, and ``control``, the
control that must come out not correct; the configuration file carries
``cpu``, its sizes cut alike.  A run reads neither.  ``BENCHMARK.json``
names the metrics each cell reports; a per-layer metric is read by
``benchmark/metrics/<metric>.py`` or, where there is no such file, by the
reader of its family (:func:`reader_path`).  So a cell, a configuration, a
traffic kind or a metric is added by adding a file.

A run makes its data on the card from ``--seed``, sets the cell up, warms up
its shapes (all of that is ``setup_s``; its phases are a line of standard
error), then drives the cell's entry, one request or job after another,
until ``--seconds`` have passed and the last one has ended.  With ``--trace 1`` the window runs under ``torch.profiler``
and the line carries the per-layer metrics instead of the end-to-end ones.
After the window the outputs of a sample of the requests, drawn from the
seed, are compared with the plain reference under ``benchmark/reference/``.
The last line of standard output is one JSON object; the numbers compared,
each beside its limit, are the last lines of standard error and the last key
of that object.

``--control <name>`` runs the cell with the driver's control in place of the
program's path (a lower precision); it is for calibrating the limits and must
come out not correct.
"""

from __future__ import annotations

import sys
import time
from pathlib import Path

T_PROCESS = time.perf_counter()
BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent
# Run as a script, the benchmark's own folder would come first on the path;
# its modules are imported as the package ``benchmark`` from the root.
if sys.path and Path(sys.path[0] or ".").resolve() == BENCH:
    sys.path[0] = str(ROOT)

import argparse  # noqa: E402
import dataclasses  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import random  # noqa: E402

FORBIDDEN = frozenset({"jax", "jaxlib", "flax", "reductive_tpu"})


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def load_module(path: Path):
    """A file of the benchmark as a module, by its path (names may hold dots)."""
    if not path.is_file():
        raise FileNotFoundError(f"no such file: {path.relative_to(ROOT)}")
    rel = path.relative_to(BENCH).with_suffix("").as_posix()
    name = "benchmark._by_name." + rel.replace("/", ".")
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def cell_files(cell: str) -> tuple[dict, dict]:
    """The cell's workload file and its configuration file."""
    workload = load_json(BENCH / "workloads" / f"{cell}.json")
    config = load_json(BENCH / "configs" / f"{workload['config']}.json")
    return workload, config


def reader_path(metric: str) -> Path:
    """The reader of a per-layer metric: ``metrics/<metric>.py`` where it
    exists; else that of the metric's family, ``metrics/<name>.py`` for
    ``<name>.<suffix>`` (``device_idle_pct.search``), or
    ``metrics/roofline.py`` for ``<kernel>_roofline``.  A reader's
    ``read(trace, metric)`` is given the metric's whole name."""
    candidates = [metric, metric.split(".")[0]]
    if metric.endswith("_roofline"):
        candidates.append("roofline")
    for name in candidates:
        path = BENCH / "metrics" / f"{name}.py"
        if path.is_file():
            return path
    raise FileNotFoundError(f"no reader for {metric!r} under benchmark/metrics")


def metrics_of(cell: str, benchmark: dict) -> tuple[list, list]:
    """The end-to-end and per-layer entries of ``BENCHMARK.json`` that the
    cell reports."""
    def has(entry):
        return "workloads" not in entry or cell in entry["workloads"]

    return ([e for e in benchmark["end_to_end"] if has(e)],
            [e for e in benchmark["per_layer"] if has(e)])


def forbidden_modules() -> list:
    """Loaded modules whose top-level name is JAX's or the JAX package's."""
    return sorted({name.split(".")[0] for name in sys.modules} & FORBIDDEN)


@dataclasses.dataclass
class Context:
    """What a traffic driver is given: the cell's configuration and
    parameters, the seed, the device, whether the window is traced, the
    control to run in place of the program (``None``: the program), the
    benchmark's own spans (name -> list of seconds) and the set-up's phases
    (``(name, seconds)``, each ended by :meth:`mark`)."""

    config: dict
    params: dict
    seed: int
    device: object
    trace: bool = False
    control: str | None = None
    spans: dict = dataclasses.field(default_factory=dict)
    phases: list = dataclasses.field(default_factory=list)
    last_mark: float = dataclasses.field(default_factory=time.perf_counter)

    def span(self, name: str, seconds: float) -> None:
        self.spans.setdefault(name, []).append(seconds)

    def mark(self, phase: str) -> None:
        """Ends the set-up phase ``phase`` once the device has caught up."""
        synchronize(self.device)
        now = time.perf_counter()
        self.phases.append((phase, now - self.last_mark))
        self.last_mark = now


class Reservoir:
    """A uniform sample of ``size`` of the outputs offered, drawn by the
    seed's own stream (reservoir sampling), so that only the sample is
    kept."""

    def __init__(self, size: int, rng: random.Random):
        self.size, self.rng, self.items, self.seen = size, rng, [], 0

    def offer(self, i: int, out) -> None:
        self.seen += 1
        if len(self.items) < self.size:
            self.items.append((i, out))
        else:
            j = self.rng.randrange(self.seen)
            if j < self.size:
                self.items[j] = (i, out)


def synchronize(device) -> None:
    import torch

    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def device_info(device, count: int) -> dict:
    import torch

    dev = torch.device(device)
    if dev.type != "cuda":
        return {"platform": "cpu", "kind": "cpu", "count": count, "memory_peak_bytes": 0}
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(dev), "count": count,
            "memory_peak_bytes": max(torch.cuda.max_memory_allocated(i)
                                     for i in range(torch.cuda.device_count()))}


def run_cell(cell: str, workload: dict, config: dict, benchmark: dict, *, seed: int,
             seconds: float, trace: bool, device, control: str | None = None,
             t_start: float | None = None) -> dict:
    """One run of a cell; returns the result line's object."""
    from benchmark import data
    from benchmark import tracing

    t_start = time.perf_counter() if t_start is None else t_start
    e2e_entries, layer_entries = metrics_of(cell, benchmark)
    driver = load_module(BENCH / "traffic" / f"{workload['driver']}.py")
    readers = {e["name"]: load_module(reader_path(e["name"]))
               for e in layer_entries} if trace else {}
    ctx = Context(config=config, params=workload["params"], seed=seed, device=device,
                  trace=trace, control=control)
    ctx.phases.append(("start", ctx.last_mark - t_start))
    state = driver.setup(ctx)
    ctx.mark("setup")
    driver.warmup(state)
    ctx.mark("warmup")
    ctx.spans.clear()
    setup_s = ctx.last_mark - t_start

    sample = Reservoir(workload["params"]["check_samples"],
                       random.Random(data.sub_seed(seed, "sample")))
    latencies = []
    with tracing.profiled(trace) as holder:
        t0 = time.perf_counter()
        i = 0
        while True:
            s = time.perf_counter()
            out = driver.step(state, i)
            e = time.perf_counter()
            latencies.append(e - s)
            sample.offer(i, out)
            i += 1
            if e - t0 >= seconds:
                break
    elapsed = e - t0
    steps = i
    chips = next(w["chips"] for w in benchmark["workloads"] if w["name"] == cell)
    dev_info = device_info(device, chips)

    metrics, breakdown = {}, None
    if trace:
        tr = tracing.collect(holder.prof, elapsed, steps, latencies, dict(ctx.spans),
                             driver.work(state, steps))
        holder.prof = None
        for entry in layer_entries:
            value = readers[entry["name"]].read(tr, entry["name"])
            if value is not None:
                metrics[entry["name"]] = {"value": value, "unit": entry["unit"]}
        if dev_info["platform"] == "gpu":
            dev_info["busy_s"] = tr.busy_s()
            dev_info["window_s"] = tr.window_s
        breakdown = tracing.breakdown(tr)
        del tr
    else:
        values = dict(driver.end_to_end(state, steps, elapsed, latencies))
        values["setup_s"] = setup_s
        for entry in e2e_entries:
            metrics[entry["name"]] = {"value": values[entry["name"]], "unit": entry["unit"]}

    checks = []
    for name, value in driver.check(state, sorted(sample.items, key=lambda t: t[0])):
        limit = workload["limits"][name]
        ok = value is not None and not math.isnan(value) and value <= limit
        checks.append((name, value, limit, ok))
    result = {"correct": all(ok for *_, ok in checks), "attempted": steps, "failed": 0,
              "metrics": metrics, "device": dev_info}
    if breakdown is not None:
        result["breakdown"] = breakdown
    result["setup_phases"] = dict(ctx.phases)
    result["checks"] = {name: {"value": _json_number(value), "limit": limit}
                        for name, value, limit, _ in checks}
    return result


def _json_number(value):
    """A compared number as JSON can hold it: ``inf`` and ``nan`` (an answer
    the reference cannot match at all) as their names."""
    return value if value is None or math.isfinite(value) else str(value)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="Benchmark of reductive_tpu_torch on one card.")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--control", default=None)
    args = ap.parse_args(argv)

    benchmark = load_json(ROOT / "BENCHMARK.json")
    workload, config = cell_files(args.workload)
    cache = ROOT / ".bench_cache"
    os.environ.setdefault("TRITON_CACHE_DIR", str(cache / "triton"))
    os.environ.setdefault("TORCH_EXTENSIONS_DIR", str(cache / "torch_extensions"))
    import torch

    chips = next(w["chips"] for w in benchmark["workloads"] if w["name"] == args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"benchmark: the cell needs {chips} CUDA device(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    torch.set_num_threads(min(4, os.cpu_count() or 1))
    result = run_cell(args.workload, workload, config, benchmark, seed=args.seed,
                      seconds=args.seconds, trace=bool(args.trace), device="cuda:0",
                      control=args.control, t_start=T_PROCESS)
    found = forbidden_modules()
    if found:
        print(f"benchmark: JAX or the JAX package was loaded: {', '.join(found)}",
              file=sys.stderr)
        return 3
    print(json.dumps(result, allow_nan=False), flush=True)
    print("set-up: " + ", ".join(f"{name} {seconds:.3f} s"
                                 for name, seconds in result["setup_phases"].items()),
          file=sys.stderr)
    for name, c in result["checks"].items():
        ok = isinstance(c["value"], (int, float)) and c["value"] <= c["limit"]
        verdict = "ok" if ok else "FAILS"
        print(f"check {name} {c['value']!r} limit {c['limit']!r} {verdict}", file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
