"""``gemm_pct.ingest``: the share of the window's kernel time (overlaps
merged) in cuBLAS's matrix products, which the OPQ projection of
``Pq.quantize_batch`` (``pq/model.py``) runs: a kernel whose name holds
``gemm``, ``gemv``, ``xmma`` or ``cutlass``."""

WORDS = ("gemm", "gemv", "xmma", "cutlass")


def read(trace, metric):
    total = trace.kernel_total_s()
    if total <= 0:
        return None
    return 100.0 * trace.kernel_seconds(lambda n: any(w in n.lower() for w in WORDS)) / total
