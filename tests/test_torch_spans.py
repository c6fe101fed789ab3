"""The package's spans (``reductive_tpu_torch.utils.span``): nothing recorded
while no profiler runs; under one, the stages of ``search.search`` and
``Pq.quantize_batch`` as a tree of spans of one request, on the clock of the
profiler's own events and in the Chrome trace of ``utils.trace``.  On a card:
the CUDA-only profile turns them on, and a span encloses the launches made
inside it."""

import json
import math
import os
import time

import pytest
import torch

from reductive_tpu_torch import Pq, search, utils
from reductive_tpu_torch.utils import profiling

# Each span of exhaustive search and its parent's name.
SEARCH_TREE = {
    "search": None, "search.tables": "search", "search.adc": "search",
    "adc.table": "search.adc", "search.select": "search", "select.repair": "search.select",
    "search.merge": "search",
}
QUANTIZE_TREE = {"pq.quantize_batch": None, "pq.project": "pq.quantize_batch",
                 "assign.encode": "pq.quantize_batch"}


@pytest.fixture(autouse=True)
def fresh_recorder(monkeypatch):
    """A recorder of this test's spans alone, its ids from 0."""
    monkeypatch.setattr(profiling, "_RECORDER", profiling._Recorder())


def _pq(d=16, m=4, k=16, projection=True, seed=0):
    g = torch.Generator().manual_seed(seed)
    proj = torch.linalg.qr(torch.randn(d, d, generator=g))[0] if projection else None
    return Pq(codebooks=torch.randn(m, k, d // m, generator=g), projection=proj), g


def _corpus(n, nq=3, seed=0):
    pq, g = _pq(seed=seed)
    codes = torch.randint(0, 16, (n, 4), generator=g, dtype=torch.int64).to(torch.uint8)
    return pq, torch.randn(nq, 16, generator=g), codes


def _profiled(fn):
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        out = fn()
    return out, prof


@pytest.mark.parametrize("name", ["search", "pq.project", "no.such.span"])
def test_without_a_profiler_a_span_is_the_shared_noop(name):
    s = utils.span(name)
    assert s is utils.span("other") is profiling._OFF
    with s as rec:
        assert rec is None
    assert utils.recorded_spans() == []


@pytest.mark.parametrize("n,chunk,long", [(5000, 2500, 1), (1000, 300, 0)])
def test_a_streamed_search_is_one_request_of_spans(n, chunk, long):
    pq, q, codes = _corpus(n)
    (d, i), prof = _profiled(
        lambda: search.search(pq, q, codes, 10, method="kernel", stream_chunk=chunk))
    d0, i0 = search.search(pq, q, codes, 10, method="kernel", stream_chunk=chunk)
    assert torch.equal(i, i0) and torch.equal(d, d0)
    spans = utils.recorded_spans()
    assert [s.id for s in spans] == list(range(len(spans)))  # none dropped
    by_id = {s.id: s for s in spans}
    (root,) = [s for s in spans if s.parent is None]
    assert root.name == "search" and {s.request for s in spans} == {root.id}
    for s in spans:
        assert SEARCH_TREE[s.name] == (by_id[s.parent].name if s.parent is not None else None)
        assert root.start_ns <= s.start_ns <= s.end_ns <= root.end_ns
        assert s.device_s is None and s._events is None
    chunks = math.ceil(n / chunk)
    names = [s.name for s in spans]
    assert names.count("search.adc") == names.count("adc.table") == chunks
    assert names.count("search.select") == chunks and names.count("search.tables") == 1
    assert names.count("search.merge") == chunks - 1
    assert names.count("select.repair") == long * chunks


class _FakeEvent:
    """A CUDA event as the recorder uses it, on the host clock."""

    def record(self, stream):
        self.ns = time.perf_counter_ns()

    def elapsed_time(self, end):
        return (end.ns - self.ns) / 1e6


def test_one_request_in_eight_is_timed_whole(monkeypatch):
    """With CUDA in use (faked), the first request and every eighth after it
    record events on every span, the others none; reading them waits once."""
    waits = []
    monkeypatch.setattr(torch.cuda, "is_initialized", lambda: True)
    monkeypatch.setattr(torch.cuda, "current_stream", lambda: None)
    monkeypatch.setattr(torch.cuda, "Event", lambda enable_timing: _FakeEvent())
    monkeypatch.setattr(torch.cuda, "synchronize", lambda: waits.append(1))
    pq, q, codes = _corpus(1000)

    def nine():
        for _ in range(9):
            search.search(pq, q, codes, 5, method="kernel", stream_chunk=500)

    _profiled(nine)
    spans = utils.recorded_spans()
    assert waits == [1]
    roots = [s for s in spans if s.parent is None]
    timed = [r.device_s is not None for r in roots]
    assert timed == [True] + [False] * 7 + [True]
    by_request = dict(zip([r.id for r in roots], timed))
    for s in spans:
        assert (s.device_s is not None) == by_request[s.request]
        assert s.device_s is None or s.device_s >= 0


def test_the_spans_share_the_profilers_clock():
    """The host interval of ``search.tables`` encloses the profiler's events
    of its matrix products (the projection and the einsum)."""
    pq, q, codes = _corpus(1000)
    _, prof = _profiled(lambda: search.search(pq, q, codes, 5, method="kernel", stream_chunk=500))
    (tables,) = [s for s in utils.recorded_spans() if s.name == "search.tables"]
    products = [ev for ev in prof.profiler.kineto_results.events()
                if ev.name() in ("aten::matmul", "aten::einsum")]
    assert len(products) >= 2
    for ev in products:
        assert tables.start_ns <= ev.start_ns() <= ev.end_ns() <= tables.end_ns


def test_a_refined_search_is_one_search_span():
    pq, q, codes = _corpus(600)
    corpus = torch.randn(600, 16)
    _profiled(lambda: search.search(pq, q, codes, 5, method="kernel", stream_chunk=200,
                                    refine_with=corpus))
    spans = utils.recorded_spans()
    assert [s.name for s in spans].count("search") == 1
    assert {s.request for s in spans} == {spans[0].id}


@pytest.mark.parametrize("projection", [True, False])
def test_quantize_batch_holds_the_projection_and_the_encode(projection):
    pq, g = _pq(projection=projection)
    x = torch.randn(50, 16, generator=g)
    codes, _ = _profiled(lambda: pq.quantize_batch(x, method="kernel"))
    assert torch.equal(codes, pq.quantize_batch(x, method="kernel"))
    spans = utils.recorded_spans()
    by_id = {s.id: s for s in spans}
    want = set(QUANTIZE_TREE) - (set() if projection else {"pq.project"})
    assert {s.name for s in spans} == want
    for s in spans:
        assert QUANTIZE_TREE[s.name] == (by_id[s.parent].name if s.parent is not None else None)
    (root,) = [s for s in spans if s.parent is None]
    assert root.name == "pq.quantize_batch" and {s.request for s in spans} == {root.id}


def test_the_chrome_trace_names_the_spans(tmp_path):
    pq, q, codes = _corpus(5000)
    with utils.trace(str(tmp_path)):
        search.search(pq, q, codes, 10, method="kernel", stream_chunk=2500)
        pq.quantize_batch(torch.randn(20, 16), method="kernel")
    (name,) = os.listdir(tmp_path)
    events = json.loads((tmp_path / name).read_text())["traceEvents"]
    assert set(SEARCH_TREE) | set(QUANTIZE_TREE) <= {e.get("name") for e in events}


def test_the_recorder_keeps_the_newest_spans(monkeypatch):
    """The oldest are dropped, and the oldest kept has an id above 0."""
    monkeypatch.setattr(profiling, "_RECORDER", profiling._Recorder(capacity=4))

    def six():
        for j in range(6):
            with utils.span(f"s{j}"):
                pass

    _profiled(six)
    kept = utils.recorded_spans()
    assert [s.name for s in kept] == ["s2", "s3", "s4", "s5"]
    assert [s.id for s in kept] == [2, 3, 4, 5]


@pytest.mark.cuda
def test_on_the_card_the_cuda_profile_records_spans_around_the_launches():
    """Under the benchmark's profile (CUDA activity only) spans record; a span
    around an ADC launch encloses the launch's runtime call, and the kernel
    starts no earlier than the span (to a few microseconds).  The first
    request is timed, its table's span too; the next is not."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from torch.autograd import profiler as autograd_profiler

    from reductive_tpu_torch.ops.adc import adc_scores_kernel

    g = torch.Generator(device="cuda").manual_seed(0)
    tables = torch.randn(8, 24, 256, device="cuda", generator=g)
    codes = torch.randint(0, 256, (1 << 20, 24), device="cuda", generator=g).to(torch.uint8)
    adc_scores_kernel(tables, codes)
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        assert autograd_profiler._is_profiler_enabled
        with utils.span("search.adc") as rec:
            adc_scores_kernel(tables, codes)
        torch.cuda.synchronize()
        with utils.span("search.adc") as untimed:
            adc_scores_kernel(tables, codes)
        torch.cuda.synchronize()
    spans = utils.recorded_spans()
    assert rec in spans and untimed in spans
    assert rec.device_s is not None and rec.device_s > 0 and untimed.device_s is None
    (table,) = [t for t in spans if t.name == "adc.table" and t.parent == rec.id]
    assert table.device_s is not None and 0 < table.device_s <= rec.device_s
    events = list(prof.profiler.kineto_results.events())
    kernel = min((ev for ev in events if "adc_f32_kernel" in ev.name()),
                 key=lambda ev: ev.start_ns())
    launch = [ev for ev in events if ev.device_type().name == "CPU"
              and "LaunchKernel" in ev.name() and ev.correlation_id() == kernel.correlation_id()]
    assert launch, [(ev.name(), ev.correlation_id()) for ev in events]
    assert rec.start_ns <= launch[0].start_ns() <= launch[0].end_ns() <= rec.end_ns
    assert kernel.start_ns() >= rec.start_ns - 5_000
