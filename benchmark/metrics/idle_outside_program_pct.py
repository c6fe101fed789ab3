"""``idle_outside_program_pct.<cell kind>``: of the window's device-idle
time (the window less the union of its kernels, copies and fills, as
``device_idle_pct`` counts it), the share in which no outermost span of the
program (``search``, ``pq.quantize_batch``) was open on the host, in %: idle
the caller's own work causes, between the program's calls.  One reader for
every cell kind; the suffix only names the end-to-end metric it moves."""

from benchmark import spans


def overlap_ns(a: list, b: list) -> int:
    """The length of the intersection of two lists of merged intervals."""
    total, i, j = 0, 0, 0
    while i < len(a) and j < len(b):
        total += max(0, min(a[i][1], b[j][1]) - max(a[i][0], b[j][0]))
        if a[i][1] < b[j][1]:
            i += 1
        else:
            j += 1
    return total


def idle_gaps(trace) -> list:
    """The window's device-idle intervals: the window less the union of its
    kernels, copies and fills."""
    lo, hi = trace.window_ns
    gaps, end = [], lo
    busy = spans.merged((max(s, lo), min(e, hi)) for _, s, e in trace.device if e > lo and s < hi)
    for s, e in busy:
        if s > end:
            gaps.append([end, s])
        end = max(end, e)
    if hi > end:
        gaps.append([end, hi])
    return gaps


def read(trace, metric):
    if not trace.device or trace.window_s <= 0:
        return None
    roots = spans.merged((s.start_ns, s.end_ns) for s in spans.in_window(trace)
                         if s.parent is None)
    gaps = idle_gaps(trace)
    idle = sum(e - s for s, e in gaps)
    if not roots or idle <= 0:
        return None
    return 100.0 * (idle - overlap_ns(gaps, roots)) / idle
