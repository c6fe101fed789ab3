"""Profiling and timing helpers.

Counterpart of ``reductive_tpu.utils.profiling``: a ``torch.profiler``
trace of a block (a Chrome trace, viewable in Perfetto or
``chrome://tracing``), a wait for every card a result lies on, and a
benchmark that times by CUDA events on a GPU (the launches return before the
card is done) and by the host clock on the CPU.

The package's own spans (:func:`span`) mark the stages of its entry points.
They record only while a ``torch.profiler`` session runs, on the clock the
profiler stamps its events with, and :func:`recorded_spans` returns them.
"""

from __future__ import annotations

import collections
import contextlib
import dataclasses
import itertools
import os
import threading
import time
from typing import Any, Callable, List, Optional

import torch
from torch.autograd import profiler as _autograd_profiler

__all__ = ["trace", "device_sync", "benchmark", "span", "recorded_spans", "Span"]

# Spans held at most: the newest are kept (a traced 30 s window of exhaustive
# search records about 60,000).
SPAN_CAPACITY = 1 << 17

# One request in this many (the first, then every eighth; a request is an
# outermost span and everything inside it) records CUDA events.  An event
# pair costs two runtime calls and their host time, which a traced run would
# otherwise count many times a request; a stage's share of a request's
# device time differs little from one request to the next.
TIMED_EVERY = 8


@dataclasses.dataclass(eq=False)
class Span:
    """One recorded span: its ``name``; its ``id`` (consecutive from 0 in a
    process, so the oldest span kept has an id above 0 once older ones were
    dropped); its ``parent``'s id (``None`` for an outermost span); the
    ``request`` it belongs to, the id of the outermost span around it; its
    host interval in ns on ``time.time_ns()`` (the clock of the profiler's
    events); and the seconds the current CUDA stream took from its start to
    its end (``device_s``, idle time on the stream included; ``None`` where
    CUDA was not in use or its request was not timed, :data:`TIMED_EVERY`)."""

    name: str
    id: int
    parent: Optional[int]
    request: int
    start_ns: int
    end_ns: Optional[int] = None
    device_s: Optional[float] = None
    _events: Any = dataclasses.field(default=None, repr=False)


class _Off:
    """What :func:`span` returns while no profiler runs: does nothing."""

    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return False


_OFF = _Off()

# The profiler's range of a span, as ``torch.profiler.record_function`` opens
# it but without its operator call (a fifth of the cost; the same event).
_RANGE = getattr(torch._C._profiler, "_RecordFunctionFast", torch.profiler.record_function)


class _Recorder:
    """The spans recorded in this process: the newest :data:`SPAN_CAPACITY`,
    each timed one with a pair of CUDA events from a pool of as many pairs
    (slot ``id`` modulo the capacity), resolved when the spans are read; and
    whether this thread's open request is timed."""

    def __init__(self, capacity: int = SPAN_CAPACITY):
        self.capacity = capacity
        self.spans: collections.deque = collections.deque(maxlen=capacity)
        self.ids = itertools.count()
        self.requests = itertools.count()
        self.last_id = -1
        self.pool: List[Any] = [None] * capacity
        self.local = threading.local()

    def stack(self) -> list:
        stack = getattr(self.local, "stack", None)
        if stack is None:
            stack = self.local.stack = []
        return stack

    def events(self, sid: int):
        slot = sid % self.capacity
        pair = self.pool[slot]
        if pair is None:
            pair = self.pool[slot] = (torch.cuda.Event(enable_timing=True),
                                      torch.cuda.Event(enable_timing=True))
        return pair

    def live(self, rec: Span) -> bool:
        """Whether ``rec``'s events are still its own (not lent to a newer
        span)."""
        return rec.id > self.last_id - self.capacity


_RECORDER = _Recorder()


class _On:
    """An open span (:func:`span` while a profiler runs)."""

    __slots__ = ("name", "rec", "annotation", "stream")

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        recorder = _RECORDER
        stack = recorder.stack()
        sid = recorder.last_id = next(recorder.ids)
        rec = self.rec = Span(self.name, sid, stack[-1].id if stack else None,
                              stack[0].request if stack else sid, 0)
        if not stack:
            recorder.local.timed = next(recorder.requests) % TIMED_EVERY == 0
        stack.append(rec)
        recorder.spans.append(rec)
        self.annotation = _RANGE(self.name)
        self.annotation.__enter__()
        if recorder.local.timed and torch.cuda.is_initialized():
            self.stream = torch.cuda.current_stream()
            rec._events = recorder.events(sid)
            rec._events[0].record(self.stream)
        rec.start_ns = time.time_ns()
        return rec

    def __exit__(self, *exc):
        rec = self.rec
        rec.end_ns = time.time_ns()
        if rec._events is not None and _RECORDER.live(rec):
            rec._events[1].record(self.stream)
        self.annotation.__exit__(*exc)
        _RECORDER.stack().pop()
        return False


def span(name: str):
    """A context manager that marks a stage of the package's work as the
    span ``name``.

    While no ``torch.profiler`` session runs it does nothing (one flag
    check).  While one runs it records a :class:`Span` (read by
    :func:`recorded_spans`) and opens a ``record_function`` range of the same
    name (so that the Chrome trace of :func:`trace` shows it).  Where CUDA
    is in use and the span's request is timed (one in :data:`TIMED_EVERY`),
    it also records a CUDA event on the current stream at each end.  Nothing
    waits for the card."""
    if not _autograd_profiler._is_profiler_enabled:
        return _OFF
    return _On(name)


def recorded_spans() -> List[Span]:
    """The closed spans recorded so far (the newest :data:`SPAN_CAPACITY`),
    in the order they opened, each with its device seconds: this waits for
    the card once, where a span recorded CUDA events."""
    done = [rec for rec in _RECORDER.spans if rec.end_ns is not None]
    pending = [rec for rec in done if rec._events is not None and _RECORDER.live(rec)]
    if pending:
        torch.cuda.synchronize()
    for rec in pending:
        start, end = rec._events
        rec.device_s = start.elapsed_time(end) / 1e3
        rec._events = None
    return done


@contextlib.contextmanager
def trace(log_dir: str):
    """Capture a ``torch.profiler`` trace (host and, where there is one,
    CUDA activity) of the enclosed block and write it into ``log_dir`` as a
    Chrome trace, ``trace_<pid>_<ns>.json``.  Usage::

        with trace("/tmp/torch-trace"):
            pq = train_pq(gen, x, 16, 8, 25)
    """
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with torch.profiler.profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(
        os.path.join(log_dir, f"trace_{os.getpid()}_{time.time_ns()}.json"))


def _leaves(tree: Any) -> List[torch.Tensor]:
    """The tensors in ``tree``: nested tuples, lists, dicts and dataclasses
    (``Pq``, ``IvfPq``)."""
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, dict):
        tree = list(tree.values())
    elif dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        tree = [getattr(tree, f.name) for f in dataclasses.fields(tree)]
    if isinstance(tree, (list, tuple)):
        return [leaf for item in tree for leaf in _leaves(item)]
    return []


def _cuda_devices(tree: Any) -> List[torch.device]:
    return sorted({t.device for t in _leaves(tree) if t.is_cuda}, key=lambda d: d.index)


def device_sync(tree: Any) -> None:
    """Wait until every card a tensor of ``tree`` lies on has finished its
    work (``torch.cuda.synchronize`` of each).  Tensors on the CPU are done
    when they are returned."""
    for device in _cuda_devices(tree):
        torch.cuda.synchronize(device)


def benchmark(fn: Callable, *args, iters: int = 5, warmup: int = 1) -> float:
    """Mean seconds a call of ``fn(*args)`` over ``iters`` calls, after
    ``warmup`` calls (at least one: builds and caches).  Where the result
    lies on a card the calls are timed by CUDA events on its current stream,
    else by the host clock."""
    for _ in range(max(warmup, 1)):
        out = fn(*args)
    devices = _cuda_devices(out)
    device_sync(out)
    if devices:
        with torch.cuda.device(devices[0]):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(iters):
                out = fn(*args)
            end.record()
            end.synchronize()
        device_sync(out)
        return start.elapsed_time(end) / 1e3 / iters
    t0 = time.perf_counter()
    for _ in range(iters):
        out = fn(*args)
    return (time.perf_counter() - t0) / iters
