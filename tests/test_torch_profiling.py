"""reductive_tpu_torch.utils.profiling on the CPU: ``trace`` writes a Chrome
trace of the block, ``device_sync`` walks results of any nesting, and
``benchmark`` returns a positive mean by the host clock, after its warm-up."""

import json
import os

import torch

from reductive_tpu_torch import Pq, utils
from reductive_tpu_torch.utils import profiling


def test_trace_writes_a_chrome_trace(tmp_path):
    log_dir = tmp_path / "trace"
    with utils.trace(str(log_dir)):
        torch.matmul(torch.ones(64, 64), torch.ones(64, 64))
    (name,) = os.listdir(log_dir)
    assert name.startswith(f"trace_{os.getpid()}_") and name.endswith(".json")
    events = json.loads((log_dir / name).read_text())["traceEvents"]
    assert any("matmul" in str(e.get("name", "")) for e in events)


def test_benchmark_is_a_positive_mean_after_the_warm_up():
    calls = []

    def fn(a):
        calls.append(1)
        return a * 2

    seconds = utils.benchmark(fn, torch.ones(8), iters=3, warmup=0)
    assert seconds > 0
    assert len(calls) == 1 + 3  # at least one warm-up call


def test_device_sync_walks_any_nesting():
    pq = Pq(codebooks=torch.zeros(2, 4, 3))
    tree = {"a": [pq, (torch.ones(2), 3)], "b": None}
    assert [t.shape for t in profiling._leaves(tree)] == [(2, 4, 3), (2,)]
    assert profiling._cuda_devices(tree) == []
    utils.device_sync(tree)  # nothing to wait for on the CPU
