"""Hand-written CUDA kernels for the hot paths, each beside its plain
PyTorch version.

* :mod:`~reductive_tpu_torch.ops.assign`: fused distance + argmin encode.
* :mod:`~reductive_tpu_torch.ops.decode`: decode (codes -> reconstructions),
  f32 and weight-only int8 tables.
* :mod:`~reductive_tpu_torch.ops.adc`: ADC scoring (lookup tables x codes),
  f32 and int8 tables.
* :mod:`~reductive_tpu_torch.ops.stats`: fused assign + per-centroid sums
  and counts, the Lloyd's iteration of the trainers.
* :mod:`~reductive_tpu_torch.ops.packing`: two u4 codes a byte.
* :mod:`~reductive_tpu_torch.ops.select`: the k smallest of long f32 rows,
  ties by position, merged with a prior list (the streamed search's).

``pq_encode_verified`` and ``pq_assign_stats_verified`` are the exact modes:
results equal to the f32 einsum path on every code and cell.

The kernels are compiled at first use (:mod:`~reductive_tpu_torch.ops._build`).
"""

from ._build import build_all, launch_counts, reset_launch_counts
from .adc import adc_scores_kernel, adc_scores_reference, max_query_batch
from .assign import (
    assign_nearest, pq_encode, pq_encode_reference, pq_encode_verified,
    pq_encode_verify_reference,
)
from .decode import pq_decode, pq_decode_reference, split_bf16
from .packing import pack_u4_codes, unpack_u4_codes
from .stats import (
    pq_assign_stats, pq_assign_stats_reference, pq_assign_stats_verified,
    pq_assign_stats_verify_reference,
)

__all__ = [
    "pq_encode",
    "pq_encode_reference",
    "pq_encode_verified",
    "pq_encode_verify_reference",
    "assign_nearest",
    "pq_decode",
    "pq_decode_reference",
    "split_bf16",
    "adc_scores_kernel",
    "adc_scores_reference",
    "max_query_batch",
    "pq_assign_stats",
    "pq_assign_stats_reference",
    "pq_assign_stats_verified",
    "pq_assign_stats_verify_reference",
    "pack_u4_codes",
    "unpack_u4_codes",
    "build_all",
    "launch_counts",
    "reset_launch_counts",
]
