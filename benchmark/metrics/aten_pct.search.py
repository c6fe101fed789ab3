"""``aten_pct.search``: the share of the window's kernel time (overlaps
merged) in PyTorch's other kernels: elementwise, reductions, indexing and
gathers, concatenation, copies between types (a kernel of ATen or CUB that
is not a sort or top-k): exhaustive search's tables, block minima and
merge, and ``ivf._probe_and_score_lut``'s masking and scores."""

WORDS = ("sort", "topk", "radix", "kth")
LIBS = ("at::", "at_cuda_detail", "cub::", "thrust::")


def is_aten(name):
    low = name.lower()
    return any(lib in name for lib in LIBS) and not any(w in low for w in WORDS)


def read(trace, metric):
    total = trace.kernel_total_s()
    if total <= 0:
        return None
    return 100.0 * trace.kernel_seconds(is_aten) / total
