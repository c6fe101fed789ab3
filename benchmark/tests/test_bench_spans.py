"""The readers of the program's spans, on a hand-built trace and hand-built
spans: the device shares, the requests' tables and host dispatch time, the
idle split by outermost span, and ``None`` where there is nothing to read or
the window's earliest spans were dropped."""

from __future__ import annotations

import pytest

from benchmark import run
from benchmark.tracing import Trace
from reductive_tpu_torch.utils import profiling

WINDOW = (1_000, 11_000)


def _reader(metric):
    return run.load_module(run.reader_path(metric))


def _trace(device=(), host=()):
    return Trace(kernels=list(device), device=list(device), host=list(host), window_ns=WINDOW,
                 steps=2, latencies_s=[], spans_s={}, work={})


def _request(first_id, start, end, device=True, chunks=2):
    """One ``search`` request of ``chunks`` chunks: the root 10 ms on the
    device, its tables 1, each chunk's scores 1 (of it 0.5 the table), its
    selection 2 (of it 1 the repair), each merge 0.5; ``device`` false: a
    request that was not timed."""
    ids = iter(range(first_id, first_id + 100))
    root = next(ids)
    out = []

    def add(name, parent, seconds):
        out.append(profiling.Span(name, next(ids) if out else root, parent, root, start + len(out),
                                  end - len(out), seconds if device else None))
        return out[-1].id

    add("search", None, 0.010)
    add("search.tables", root, 0.001)
    for c in range(chunks):
        adc = add("search.adc", root, 0.001)
        add("adc.table", adc, 0.0005)
        select = add("search.select", root, 0.002)
        add("select.repair", select, 0.001)
        if c:
            add("search.merge", root, 0.0005)
    return out


def _ingest(first_id, start, end, device=True):
    """One ``pq.quantize_batch`` of 20 ms on the device, 18 of them the
    projection's, 1.5 the encode's."""
    def one(j, name, parent, seconds):
        return profiling.Span(name, first_id + j, parent, first_id, start + j, end - j,
                              seconds if device else None)

    return [one(0, "pq.quantize_batch", None, 0.020),
            one(1, "pq.project", first_id, 0.018), one(2, "assign.encode", first_id, 0.0015)]


@pytest.fixture
def recorded(monkeypatch):
    found = []
    monkeypatch.setattr(profiling, "recorded_spans", lambda: list(found))
    return found


@pytest.mark.parametrize("metric,want", [
    ("select_device_pct.search", 100 * (2 * 0.002 + 0.0005) / 0.010),
    ("repair_device_pct.search", 100 * 2 * 0.001 / 0.010),
    ("adc_device_pct.search", 100 * (0.001 + 2 * 0.001) / 0.010),
    ("tables_per_request.search", 2.0),
])
def test_the_search_readers(recorded, metric, want):
    # a request that ended before the window is not read
    recorded += _request(0, 0, 900, chunks=5)
    recorded += _request(100, 2_000, 5_000) + _request(200, 6_000, 9_000)
    assert _reader(metric).read(_trace(), metric) == pytest.approx(want)


def test_dispatch_time_leaves_out_the_runtime_calls(recorded):
    """Requests of 3,000 ns: the first holds runtime calls over 800 ns (one
    begun before it, two that overlap), the second the profiler's buffer
    handling over 1,000; a range named like a span is no runtime call."""
    recorded += _request(0, 2_000, 5_000) + _request(100, 6_000, 9_000)
    host = [("cudaMemcpyAsync", 1_900, 2_100), ("cudaLaunchKernel", 2_500, 3_000),
            ("cuLaunchKernel", 2_800, 3_200), ("search.adc", 2_000, 5_000),
            ("Activity Buffer Request", 6_000, 6_600), ("Buffer Flush", 6_500, 7_000),
            ("cudaLaunchKernel", 9_500, 9_900)]
    metric = "dispatch_ms_per_request.search"
    assert _reader(metric).read(_trace(host=host), metric) == pytest.approx((2_200 + 2_000) / 2e6)


@pytest.mark.parametrize("metric,want", [("project_device_pct.ingest", 90.0),
                                         ("encode_device_pct.ingest", 7.5)])
def test_the_shares_of_a_batch(recorded, metric, want):
    recorded += _ingest(0, 2_000, 4_000) + _ingest(10, 5_000, 7_000)
    assert _reader(metric).read(_trace(), metric) == pytest.approx(want)


@pytest.mark.parametrize("first_id,start,reads", [
    (0, 2_000, True),    # nothing dropped
    (7, 500, True),      # dropped spans, all older than the window
    (7, 2_000, False),   # dropped spans may lie inside the window
])
def test_a_window_that_lost_its_first_spans_reads_none(recorded, first_id, start, reads):
    recorded += _request(first_id, start, 5_000) + _request(first_id + 100, 6_000, 9_000)
    for metric in ("tables_per_request.search", "select_device_pct.search",
                   "idle_outside_program_pct.search"):
        device = [("k", 1_000, 3_000), ("k", 4_000, 11_000)]
        assert (_reader(metric).read(_trace(device), metric) is not None) == reads


@pytest.mark.parametrize("metric,want", [
    ("select_device_pct.search", 100 * (3 * 0.002 + 2 * 0.0005) / 0.010),
    ("project_device_pct.ingest", 90.0),
])
def test_the_shares_are_taken_over_the_timed_requests(recorded, metric, want):
    """A request that was not timed adds nothing, its parts neither."""
    recorded += _request(0, 2_000, 3_000, chunks=3) + _request(100, 3_500, 5_000, device=False)
    recorded += _ingest(200, 5_500, 6_000) + _ingest(300, 6_500, 7_000, device=False)
    assert _reader(metric).read(_trace(), metric) == pytest.approx(want)


@pytest.mark.parametrize("metric", ["select_device_pct.search", "repair_device_pct.search",
                                    "adc_device_pct.search", "project_device_pct.ingest",
                                    "encode_device_pct.ingest"])
def test_a_device_share_is_none_without_device_seconds(recorded, metric):
    recorded += _request(0, 2_000, 5_000, device=False) + _ingest(50, 6_000, 7_000, device=False)
    assert _reader(metric).read(_trace(), metric) is None


@pytest.mark.parametrize("metric", ["select_device_pct.search", "adc_device_pct.search",
                                    "tables_per_request.search", "dispatch_ms_per_request.search",
                                    "project_device_pct.ingest", "encode_device_pct.ingest",
                                    "idle_outside_program_pct.search"])
def test_nothing_to_read_is_none(recorded, metric):
    device = [("k", 1_000, 3_000), ("k", 4_000, 11_000)]
    assert _reader(metric).read(_trace(device), metric) is None


@pytest.mark.parametrize("metric", ["idle_outside_program_pct.search",
                                    "idle_outside_program_pct.ingest"])
def test_the_idle_outside_the_programs_spans(recorded, metric):
    """Idle gaps 3,000 to 4,000 and 6,000 to 7,000 (the window's ends busy);
    the one outermost span, 3,500 to 6,500, covers half of each: half the
    idle is outside the program.  Its child adds nothing."""
    device = [("k", 1_000, 3_000), ("c", 2_500, 3_000), ("k", 4_000, 6_000),
              ("k", 7_000, 11_000)]
    root = _ingest(0, 3_500, 6_500) if metric.endswith("ingest") else _request(0, 3_500, 6_500)
    recorded += root
    assert run.reader_path(metric) == run.BENCH / "metrics" / "idle_outside_program_pct.py"
    assert _reader(metric).read(_trace(device), metric) == pytest.approx(50.0)


def test_idle_before_the_first_and_after_the_last_kernel_counts(recorded):
    metric = "idle_outside_program_pct.search"
    recorded += _request(0, 1_000, 2_000)
    device = [("k", 2_000, 10_000)]
    # 1,000 ns idle at each end of the window, the first inside the request
    assert _reader(metric).read(_trace(device), metric) == pytest.approx(50.0)


def test_a_program_without_spans_reads_none(monkeypatch):
    monkeypatch.delattr(profiling, "recorded_spans")
    device = [("k", 1_000, 3_000), ("k", 4_000, 11_000)]
    for metric in ("tables_per_request.search", "idle_outside_program_pct.ingest",
                   "select_device_pct.search"):
        assert _reader(metric).read(_trace(device), metric) is None
