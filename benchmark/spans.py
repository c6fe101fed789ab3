"""The program's own spans (``reductive_tpu_torch.utils.profiling.span``) as
the per-layer readers take them: recorded while the traced window's profiler
ran (a span records only then), on the clock of the profiler's events, and
kept where they overlap the window.  A program without spans gives none, and
its readers ``None``; so does a window whose earliest spans the program's
recorder dropped (it keeps the newest, with ids consecutive from 0).

A span's device seconds run on the stream from its start to its end, so they
count the stream's idle time inside the span too.  The program times one
request in eight; the others' spans have none, and the shares are taken over
the timed requests."""

from __future__ import annotations


def in_window(trace) -> list:
    """The closed spans that overlap ``trace.window_ns``; none where spans
    of the window were dropped."""
    try:
        from reductive_tpu_torch.utils.profiling import recorded_spans
    except ImportError:
        return []
    lo, hi = trace.window_ns
    found = recorded_spans()
    if found and found[0].id > 0 and found[0].start_ns > lo:
        return []
    return [s for s in found if s.start_ns < hi and s.end_ns > lo]


def device_pct(trace, parts: tuple, whole: str) -> float | None:
    """Device seconds of the spans named in ``parts`` over those of the
    outermost spans named ``whole``, in the requests that were timed, in %;
    ``None`` without device seconds."""
    spans = in_window(trace)
    timed = {s.id for s in spans if s.name == whole and s.device_s is not None}
    total = [s.device_s for s in spans if s.id in timed]
    part = [s.device_s for s in spans if s.name in parts and s.request in timed]
    if not total or None in part or sum(total) <= 0:
        return None
    return 100.0 * sum(part) / sum(total)


def merged(intervals) -> list:
    """``(start, end)`` intervals with overlaps merged, in order."""
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out
