"""Peaks of one NVIDIA H100 SXM and the work that each roofline metric counts.

``PEAK_BYTES``, ``PEAK_OPS`` and :func:`bound` are the published dense rates
of NVIDIA's H100 SXM data sheet at the card's 700 W limit and the larger of
the two least times, as ``chip_smoke.py`` keeps them (there in
milliseconds, here in seconds).

The work functions count from a request's inputs, never from a launch's
arguments: each input byte read once, each output byte written once, and the
operations the answer needs.  So the count is the same whatever computes the
answer, and a change that does less work shows as a higher share.
"""

from __future__ import annotations

PEAK_BYTES = 3.35e12
PEAK_OPS = {"f32": 67e12, "tf32": 495e12, "bf16": 989e12, "int8": 1979e12}

F32 = 4
RESULT_BYTES = 4 + 8  # one f32 distance and one int64 id


def bound(nbytes: float, nops: float, op_type: str) -> tuple[float, str]:
    """The least seconds the card could take, and which of bytes or
    operations sets them."""
    t_bytes = nbytes / PEAK_BYTES
    t_ops = nops / PEAK_OPS[op_type]
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def adc_flat_work(n: int, nq: int, m: int, k: int, top_k: int) -> tuple[int, int]:
    """Bytes and f32 additions of one exhaustive ADC search: every one-byte
    code read once, the queries' ``(nq, m, k)`` f32 tables, the ``(nq,
    top_k)`` results; ``m`` table entries added for every (query, row)
    pair."""
    nbytes = n * m + nq * m * k * F32 + nq * top_k * RESULT_BYTES
    return nbytes, nq * n * m


def adc_ivf_work(union_rows: int, pairs: int, nq: int, m: int, k: int,
                 top_k: int) -> tuple[int, int]:
    """Bytes and f32 additions of one IVF-PQ request: the codes of the
    stored rows in the union of the cells its queries probe, each read once,
    the queries' tables and results; ``m`` additions for each (query, row)
    pair that a query's own probed cells hold (``pairs``)."""
    nbytes = union_rows * m + nq * m * k * F32 + nq * top_k * RESULT_BYTES
    return nbytes, pairs * m


def encode_work(rows: int, d: int, m: int, k: int) -> tuple[int, int]:
    """Bytes and bf16 operations of encoding ``rows`` projected f32 rows of
    width ``d`` into ``m`` one-byte codes: the rows read once, the codes
    written once, the ``(m, k, d/m)`` codebook read once; a product of every
    subvector with every centroid, two operations a multiply-add."""
    nbytes = rows * d * F32 + rows * m + k * d * F32
    return nbytes, 2 * rows * k * d
