"""A probe of the tensor cores' accumulation, on which the verify bound rests.

:mod:`reductive_tpu_torch.ops.assign` bounds the error of the 3xTF32 split
product on the assumption that one ``wgmma.m64n64k8.f32.tf32.tf32``
instruction aligns its nine addends (eight exact products of TF32 values and
the accumulator) to the largest exponent, keeps at least 24 bits of each and
truncates: at most ``10 * 2^-23 * M`` an instruction, ``M`` the largest
magnitude among the addends and the exact sum.  :func:`probe_wgmma_tf32`
runs that instruction (``csrc/probe.cu``) on cases built to measure this:

* **kept bits**: ``1 + 2^-e`` as accumulator plus product, product plus
  accumulator, and two products, for ``e = 1 .. 30``: the largest ``e`` kept
  exactly in all three, plus one, is the number of bits kept below the
  leading one (24 is all an f32 result can show);
* **truncation or rounding**: ``+-1`` plus a product of ``+-3 * 2^-25``,
  exactly ``+-(1 + 0.75 * 2^-23)``: truncation gives ``+-1``, rounding to
  nearest ``+-(1 + 2^-23)``;
* **random addends** over a spread of magnitudes: the largest error against
  the exact sum (in f64, where it is exact), in units of ``2^-23 M``; the model
  allows 10.

:func:`read_probe` turns the instruction's results into that report; it is
plain code, so the CPU tests feed it the results of simulated accumulators.
"""

from __future__ import annotations

import numpy as np
import torch

from . import _build

__all__ = ["probe_cases", "read_probe", "probe_wgmma_tf32", "MODEL_ULPS"]

# What the bound of ops/assign.py allows one instruction: 10 units of 2^-23 M.
MODEL_ULPS = 10.0
_E_MAX = 30
_RANDOM = 24


def _tf32(a: np.ndarray) -> np.ndarray:
    """Round f32 values to TF32 (10 explicit mantissa bits), nearest, ties
    away from zero (``cvt.rna``)."""
    bits = np.asarray(a, dtype=np.float32).view(np.uint32).astype(np.uint64)
    bits = (bits + 0x1000) & 0xFFFFE000
    return bits.astype(np.uint32).view(np.float32)


def probe_cases(seed: int = 0) -> tuple[np.ndarray, np.ndarray, np.ndarray, dict]:
    """``(A (cases, 64, 8), B (cases, 64, 8), C (cases, 64, 64), index)`` as
    f32 arrays of TF32 values; ``index`` names the cases by kind.  In the
    structured cases every row of A and of B is the same, so every output
    is the same sum."""
    A, B, C = [], [], []
    index = {"kept": [], "round": [], "random": []}

    def case(kind, a8, b8, c):
        index[kind].append(len(A))
        A.append(np.broadcast_to(np.asarray(a8, np.float32), (64, 8)))
        B.append(np.broadcast_to(np.asarray(b8, np.float32), (64, 8)))
        C.append(np.broadcast_to(np.asarray(c, np.float32), (64, 64)))

    one = [1.0] + [0.0] * 7
    for e in range(1, _E_MAX + 1):
        small = 2.0 ** -e
        case("kept", [small] + [0.0] * 7, one, 1.0)           # a product below the accumulator
        case("kept", one, one, small)                          # the accumulator below a product
        case("kept", [1.0, small] + [0.0] * 6, [1.0, 1.0] + [0.0] * 6, 0.0)  # two products
    for sign in (1.0, -1.0):
        case("round", [sign * 3.0 * 2.0 ** -25] + [0.0] * 7, one, sign)
        case("round", one, [sign * 3.0 * 2.0 ** -25] + [0.0] * 7, sign)
    rng = np.random.default_rng(seed)
    for _ in range(_RANDOM):
        def draw(shape):
            mag = 2.0 ** rng.integers(-10, 11, shape)
            return _tf32(rng.standard_normal(shape) * mag)
        index["random"].append(len(A))
        A.append(draw((64, 8)))
        B.append(draw((64, 8)))
        C.append(draw((64, 64)))
    stack = lambda xs: np.ascontiguousarray(np.stack(xs), dtype=np.float32)  # noqa: E731
    return stack(A), stack(B), stack(C), index


def read_probe(A: np.ndarray, B: np.ndarray, C: np.ndarray, D: np.ndarray, index: dict) -> dict:
    """The report of one probe run from its inputs and the instruction's
    results ``D``: ``kept_bits``, ``mode`` ("truncate", "round" or "other"),
    ``max_err_ulps`` (random cases, units of ``2^-23 M``) and ``ok`` (at
    least 24 bits kept, truncation, and the random errors within
    :data:`MODEL_ULPS`), as the bound of ops/assign.py assumes."""
    D = np.asarray(D, dtype=np.float32)
    kept = 1
    uniform = True
    for e in range(1, _E_MAX + 1):
        got = [D[i] for i in index["kept"][3 * (e - 1):3 * e]]
        uniform &= all(bool((g == g.flat[0]).all()) for g in got)
        if e <= 23 and all(float(g.flat[0]) == 1.0 + 2.0 ** -e for g in got) and kept == e:
            kept = e + 1
    trunc = all(abs(float(D[i].flat[0])) == 1.0 for i in index["round"])
    near = all(abs(float(D[i].flat[0])) == 1.0 + 2.0 ** -23 for i in index["round"])
    mode = "truncate" if trunc else "round" if near else "other"
    worst = 0.0
    for i in index["random"]:
        a, b, c = (np.asarray(v, np.float64) for v in (A[i], B[i], C[i]))
        prods = a[:, None, :] * b[None, :, :]                   # (64, 64, 8), exact in f64
        exact = c + prods.sum(axis=2)
        m = np.maximum(np.abs(prods).max(axis=2), np.maximum(np.abs(c), np.abs(exact)))
        err = np.abs(D[i].astype(np.float64) - exact) / (2.0 ** -23 * m)
        worst = max(worst, float(err.max()))
    ok = kept >= 24 and mode == "truncate" and worst <= MODEL_ULPS and uniform
    return {"kept_bits": kept, "mode": mode, "max_err_ulps": worst,
            "uniform_outputs": uniform, "ok": bool(ok)}


def probe_wgmma_tf32(device=None, seed: int = 0) -> dict:
    """Run the probe on the card (``device``: a CUDA device, the current one
    by default) and return :func:`read_probe`'s report."""
    A, B, C, index = probe_cases(seed)
    dev = torch.device("cuda") if device is None else torch.device(device)
    tA, tB, tC = (torch.from_numpy(v).to(dev) for v in (A, B, C))
    tD = torch.empty_like(tC)
    with torch.cuda.device(dev):
        _build.launch("rt_probe_wgmma_tf32", None, tA.data_ptr(), tB.data_ptr(), tC.data_ptr(),
                      tD.data_ptr(), A.shape[0], torch.cuda.current_stream().cuda_stream)
    return read_probe(A, B, C, tD.cpu().numpy(), index)
