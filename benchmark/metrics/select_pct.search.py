"""``select_pct.search``: the share of the window's kernel time (overlaps
merged) in PyTorch's sort and top-k kernels, which ``search._smallest`` and
``torch.unique`` run: a kernel of ATen or CUB whose name holds ``sort``,
``topk``, ``radix`` or ``kth``."""

WORDS = ("sort", "topk", "radix", "kth")
LIBS = ("at::", "at_cuda_detail", "cub::")


def is_select(name):
    low = name.lower()
    return any(w in low for w in WORDS) and any(lib in name for lib in LIBS)


def read(trace, metric):
    total = trace.kernel_total_s()
    if total <= 0:
        return None
    return 100.0 * trace.kernel_seconds(is_select) / total
