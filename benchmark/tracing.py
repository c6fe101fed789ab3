"""The traced run: ``torch.profiler`` over the measured window, and what the
per-layer readers take from it.

On a card the profiler records the device's activity and the CUDA runtime
calls only (no operator events: their cost would slow the host-paced
requests it measures); the profile spans the window and nothing else, the
warm-up having been waited for.  Device time is the union of the intervals
in which a kernel, copy or fill ran (overlapping intervals merged); the
window is the host clock's, from the first recorded event.
"""

from __future__ import annotations

import bisect
import contextlib
import dataclasses
from collections import defaultdict

@dataclasses.dataclass
class Trace:
    """What a per-layer metric reader may read.

    ``kernels``: ``(name, start_ns, end_ns)`` of every device kernel in the
    window; ``device``: the same for every device activity (kernels, copies,
    fills); ``host``: host-side operations and runtime calls; ``window_ns``:
    the window's bounds; ``steps``: requests or jobs the window completed;
    ``latencies_s``: each one's host-clock seconds; ``spans_s``: seconds of
    the benchmark's own named spans; ``work``: counts the traffic driver
    worked out from the requests' inputs."""

    kernels: list
    device: list
    host: list
    window_ns: tuple
    steps: int
    latencies_s: list
    spans_s: dict
    work: dict

    @property
    def window_s(self) -> float:
        return (self.window_ns[1] - self.window_ns[0]) / 1e9

    def busy_s(self) -> float:
        return merged_seconds([(s, e) for _, s, e in self.device])

    def kernel_seconds(self, match) -> float:
        """Device seconds of the kernels whose name ``match`` accepts,
        overlaps merged."""
        return merged_seconds([(s, e) for name, s, e in self.kernels if match(name)])

    def kernel_total_s(self) -> float:
        return self.kernel_seconds(lambda name: True)


def merged_seconds(intervals) -> float:
    total, end = 0, None
    for s, e in sorted(intervals):
        if end is None or s > end:
            total += e - s
            end = e
        elif e > end:
            total += e - end
            end = e
    return total / 1e9


@contextlib.contextmanager
def profiled(enabled: bool):
    """Yields a holder whose ``prof`` is the stopped profiler afterwards
    (``None`` when not ``enabled``)."""
    holder = type("Holder", (), {"prof": None})()
    if not enabled:
        yield holder
        return
    import torch
    from torch.profiler import ProfilerActivity, profile

    cuda = torch.cuda.is_available()
    with profile(activities=[ProfilerActivity.CUDA if cuda else ProfilerActivity.CPU]) as prof:
        yield holder
    holder.prof = prof


def _is_annotation(ev) -> bool:
    """A ``record_function`` range as the profiler also shows it on the
    device's track, not device work."""
    flag = getattr(ev, "is_user_annotation", None)
    return bool(flag()) if flag is not None else False


def collect(prof, elapsed_s: float, steps: int, latencies_s: list, spans_s: dict,
            work: dict) -> Trace:
    """The :class:`Trace` of a stopped profiler that spanned a window of
    ``elapsed_s`` host seconds."""
    kernels, device, host = [], [], []
    lo = None
    for ev in prof.profiler.kineto_results.events():
        s, e = ev.start_ns(), ev.end_ns()
        lo = s if lo is None else min(lo, s)
        if ev.device_type().name == "CUDA":
            if _is_annotation(ev):
                continue
            device.append((ev.name(), s, e))
            if not ev.name().startswith(("Memcpy", "Memset")):
                kernels.append((ev.name(), s, e))
        else:
            host.append((ev.name(), s, e))
    lo = lo or 0
    return Trace(kernels=kernels, device=device, host=host,
                 window_ns=(lo, lo + int(elapsed_s * 1e9)), steps=steps,
                 latencies_s=latencies_s, spans_s=spans_s, work=work)


def breakdown(trace: Trace, top: int = 10) -> dict:
    """The device operations that took most time, and the longest idle gaps
    by the host operation that was running through most of each (the
    shortest such operation: the innermost), as ``[name, seconds]`` lists."""
    by_name = defaultdict(int)
    for name, s, e in trace.device:
        by_name[name[:120]] += e - s
    ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
    gaps, end = [], trace.window_ns[0]
    for _, s, e in sorted(trace.device, key=lambda t: t[1]):
        if s > end:
            gaps.append((end, s))
        end = max(end, e)
    if trace.window_ns[1] > end:
        gaps.append((end, trace.window_ns[1]))
    gaps.sort(key=lambda g: g[0] - g[1])
    host = sorted(trace.host, key=lambda t: t[1])
    starts = [s for _, s, _ in host]
    longest = max((e - s for _, s, e in host), default=0)
    idle = []
    for g0, g1 in gaps[:top]:
        label, best = "host outside any traced operation", None
        for name, s, e in host[bisect.bisect_left(starts, g0 - longest):
                                bisect.bisect_right(starts, g1)]:
            cover = min(e, g1) - max(s, g0)
            if cover > (g1 - g0) // 2 and (best is None or e - s < best):
                label, best = name[:120], e - s
        idle.append([label, (g1 - g0) / 1e9])
    return {"device_ops": [[n, t / 1e9] for n, t in ops], "idle_gaps": idle}
