"""Profiling and timing helpers.

Counterpart of ``reductive_tpu.utils.profiling``: a ``torch.profiler``
trace of a block (a Chrome trace, viewable in Perfetto or
``chrome://tracing``), a wait for every card a result lies on, and a
benchmark that times by CUDA events on a GPU (the launches return before the
card is done) and by the host clock on the CPU.
"""

from __future__ import annotations

import contextlib
import dataclasses
import os
import time
from typing import Any, Callable, List

import torch

__all__ = ["trace", "device_sync", "benchmark"]


@contextlib.contextmanager
def trace(log_dir: str):
    """Capture a ``torch.profiler`` trace (host and, where there is one,
    CUDA activity) of the enclosed block and write it into ``log_dir`` as a
    Chrome trace, ``trace_<pid>_<ns>.json``.  Usage::

        with trace("/tmp/torch-trace"):
            pq = train_pq(gen, x, 16, 8, 25)
    """
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with torch.profiler.profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(
        os.path.join(log_dir, f"trace_{os.getpid()}_{time.time_ns()}.json"))


def _leaves(tree: Any) -> List[torch.Tensor]:
    """The tensors in ``tree``: nested tuples, lists, dicts and dataclasses
    (``Pq``, ``IvfPq``)."""
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, dict):
        tree = list(tree.values())
    elif dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        tree = [getattr(tree, f.name) for f in dataclasses.fields(tree)]
    if isinstance(tree, (list, tuple)):
        return [leaf for item in tree for leaf in _leaves(item)]
    return []


def _cuda_devices(tree: Any) -> List[torch.device]:
    return sorted({t.device for t in _leaves(tree) if t.is_cuda}, key=lambda d: d.index)


def device_sync(tree: Any) -> None:
    """Wait until every card a tensor of ``tree`` lies on has finished its
    work (``torch.cuda.synchronize`` of each).  Tensors on the CPU are done
    when they are returned."""
    for device in _cuda_devices(tree):
        torch.cuda.synchronize(device)


def benchmark(fn: Callable, *args, iters: int = 5, warmup: int = 1) -> float:
    """Mean seconds a call of ``fn(*args)`` over ``iters`` calls, after
    ``warmup`` calls (at least one: builds and caches).  Where the result
    lies on a card the calls are timed by CUDA events on its current stream,
    else by the host clock."""
    for _ in range(max(warmup, 1)):
        out = fn(*args)
    devices = _cuda_devices(out)
    device_sync(out)
    if devices:
        with torch.cuda.device(devices[0]):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(iters):
                out = fn(*args)
            end.record()
            end.synchronize()
        device_sync(out)
        return start.elapsed_time(end) / 1e3 / iters
    t0 = time.perf_counter()
    for _ in range(iters):
        out = fn(*args)
    return (time.perf_counter() - t0) / iters
