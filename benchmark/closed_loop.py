"""What the closed-loop search drivers share: one client sends the next
``batch`` queries of a fixed query set, wrapping around, and waits for the
answers on the host."""

from __future__ import annotations

import math

import torch


def query_ring(q: torch.Tensor, batch: int) -> torch.Tensor:
    """The query set with its first ``batch`` rows appended, so that every
    request is one slice."""
    return torch.cat([q, q[:batch]])


def request(ring: torch.Tensor, n_queries: int, batch: int, i: int) -> torch.Tensor:
    """The queries of request ``i``."""
    s = (i * batch) % n_queries
    return ring[s:s + batch]


def nearest_rank(values, p: float) -> float:
    """The ``p``-th percentile of ``values`` by nearest rank: of all of them,
    none interpolated."""
    v = sorted(values)
    return v[max(0, math.ceil(p / 100 * len(v)) - 1)]


def search_metrics(steps: int, batch: int, elapsed: float, latencies) -> dict:
    """``search_qps``: every query answered in the window over the window's
    seconds; ``search_p95_ms``: the 95th percentile of every request's
    seconds, call to answers on the host."""
    return {"search_qps": steps * batch / elapsed,
            "search_p95_ms": nearest_rank(latencies, 95) * 1e3}
