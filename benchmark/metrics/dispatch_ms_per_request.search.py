"""``dispatch_ms_per_request.search``: the median, over the program's
``search`` spans, of the host time inside the span outside every CUDA
runtime or driver call and the profiler's own buffer handling, in ms: the
host's own work for a request (Python, ATen's dispatch, the allocator).  A
host that waits, in a full launch queue or for the card, waits inside a
runtime call, so kernels that run faster do not move it; the spans' own
Python does."""

import bisect
import statistics

from benchmark import spans


PROFILER_OWN = ("Activity Buffer Request", "Buffer Flush")


def is_runtime(name: str) -> bool:
    return name.startswith("cu") or name in PROFILER_OWN


def covered_ns(calls: list, starts: list, lo: int, hi: int) -> int:
    """The length of ``[lo, hi)`` inside the merged intervals ``calls``."""
    total = 0
    for s, e in calls[max(bisect.bisect_right(starts, lo) - 1, 0):bisect.bisect_left(starts, hi)]:
        total += max(0, min(e, hi) - max(s, lo))
    return total


def read(trace, metric):
    roots = [s for s in spans.in_window(trace) if s.name == "search"]
    if not roots:
        return None
    calls = spans.merged((s, e) for name, s, e in trace.host if is_runtime(name))
    starts = [s for s, _ in calls]
    own = [(r.end_ns - r.start_ns) - covered_ns(calls, starts, r.start_ns, r.end_ns)
           for r in roots]
    return statistics.median(own) / 1e6
