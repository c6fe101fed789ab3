"""Inputs made from ``--seed``: corpora, queries and the streams that draw them.

Every draw takes a ``torch.Generator`` of its own, seeded from the run's seed
and a tag, on the device the data lives on, so the same seed gives the same
inputs and no draw depends on how many another took.
"""

from __future__ import annotations

import hashlib

import torch
from torch import Tensor


def sub_seed(seed: int, tag: str) -> int:
    """A 63-bit seed for the stream ``tag`` of the run seeded ``seed``."""
    digest = hashlib.sha256(f"{seed}:{tag}".encode()).digest()
    return int.from_bytes(digest[:8], "little") & ((1 << 63) - 1)


def generator(device, seed: int, tag: str) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(sub_seed(seed, tag))


def mixture(gen: torch.Generator, n: int, d: int, *, centres: int, centre_scale: float,
            noise: float, zipf: float | None = None, centres_gen: torch.Generator | None = None,
            chunk: int = 1 << 20) -> Tensor:
    """``(n, d)`` f32 rows on the generator's device: ``centres`` centres
    drawn from ``N(0, centre_scale^2)`` (by ``centres_gen`` where given),
    each row a drawn centre plus ``N(0, noise^2)`` noise; made ``chunk``
    rows at a time so that the corpus is the only large tensor.  The centres
    are drawn uniformly, or with ``zipf`` the ``i``-th (from 1) with weight
    ``i^-zipf``: a few large clusters and many small ones."""
    dev = gen.device
    c = centre_scale * torch.randn((centres, d), generator=centres_gen or gen, device=dev)
    weights = None
    if zipf is not None:
        weights = torch.arange(1, centres + 1, dtype=torch.float64, device=dev) ** -zipf
        weights = (weights / weights.sum()).float()
    x = torch.empty((n, d), dtype=torch.float32, device=dev)
    for off in range(0, n, chunk):
        b = min(chunk, n - off)
        if weights is None:
            member = torch.randint(0, centres, (b,), generator=gen, device=dev)
        else:
            member = torch.multinomial(weights, b, replacement=True, generator=gen)
        rows = x[off:off + b]
        torch.randn((b, d), generator=gen, device=dev, out=rows)
        rows.mul_(noise).add_(c[member])
    return x


def corpus(spec: dict, gen: torch.Generator, n: int, d: int) -> Tensor:
    """The corpus a configuration's ``data`` block describes (``zipf``: the
    centres' weights, see :func:`mixture`).  With ``centres_seed`` the mixture's centres are the deployment's, the same
    for every run seed; the rows, their noise and all else still come from
    the run's seed."""
    if spec["kind"] != "mixture":
        raise ValueError(f"unknown corpus kind {spec['kind']!r}")
    fixed = spec.get("centres_seed")
    centres_gen = None if fixed is None else generator(gen.device, fixed, "centres")
    return mixture(gen, n, d, centres=spec["centres"], centre_scale=spec["centre_scale"],
                   noise=spec["noise"], zipf=spec.get("zipf"), centres_gen=centres_gen)


def queries_near_rows(gen: torch.Generator, x: Tensor, count: int, noise: float) -> Tensor:
    """``count`` queries: distinct corpus rows drawn uniformly, each plus
    ``N(0, noise^2)`` noise."""
    rows = torch.randperm(x.shape[0], generator=gen, device=gen.device)[:count]
    q = x[rows.to(x.device)].clone()
    q.add_(torch.randn(q.shape, generator=gen, device=gen.device), alpha=noise)
    return q


def distinct_rows(gen: torch.Generator, n: int, count: int) -> Tensor:
    """``count`` distinct row indices below ``n``, ascending."""
    return torch.sort(torch.randperm(n, generator=gen, device=gen.device)[:count]).values
