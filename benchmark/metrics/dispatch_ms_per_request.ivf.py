"""``dispatch_ms_per_request.ivf``: ``dispatch_ms_per_request.search`` over the
program's ``ivf.search`` spans: the median of the host time inside one
outside every CUDA runtime or driver call and the profiler's own buffer
handling, in ms."""

import statistics
from pathlib import Path

from benchmark import run, spans

SEARCH = run.load_module(Path(__file__).with_name("dispatch_ms_per_request.search.py"))


def read(trace, metric):
    roots = [s for s in spans.in_window(trace) if s.name == "ivf.search"]
    if not roots:
        return None
    calls = spans.merged((s, e) for name, s, e in trace.host if SEARCH.is_runtime(name))
    starts = [s for s, _ in calls]
    own = [(r.end_ns - r.start_ns) - SEARCH.covered_ns(calls, starts, r.start_ns, r.end_ns)
           for r in roots]
    return statistics.median(own) / 1e6
