"""The readers of the IVF search's spans and counters, on a hand-built trace
and hand-built spans: the device shares of the probe, the ADC, the mask and
the selection, the pairs scored over those probed, the host dispatch time;
``None`` where the program recorded no ``ivf.search`` (a program without
these spans, or an exhaustive search)."""

from __future__ import annotations

import types

import pytest

from benchmark import run
from benchmark.tracing import Trace
from reductive_tpu_torch.utils import profiling

WINDOW = (1_000, 11_000)
SHARES = ("probe_device_pct.ivf", "adc_device_pct.ivf", "mask_device_pct.ivf",
          "select_device_pct.ivf")
METRICS = SHARES + ("scored_over_probed.ivf", "dispatch_ms_per_request.ivf")


def _reader(metric):
    return run.load_module(run.reader_path(metric))


def _trace(host=()):
    device = [("k", 1_000, 3_000), ("k", 4_000, 11_000)]
    return Trace(kernels=device, device=device, host=list(host), window_ns=WINDOW, steps=2,
                 latencies_s=[], spans_s={}, work={})


def _request(first_id, start, end, device=True, chunks=2, scored=40, probed=10):
    """One ``ivf.search`` request of ``chunks`` chunks: the root 10 ms on the
    device, the probe 1, the tables 0.5, each chunk's ADC 2 (of it 0.25 the
    table), its mask 0.5 and its selection 1; the request's counts
    ``scored`` and ``probed``; ``device`` false: a request not timed."""
    ids = iter(range(first_id, first_id + 100))
    root = next(ids)
    out = []

    def add(name, parent, seconds):
        out.append(profiling.Span(name, next(ids) if out else root, parent, root, start + len(out),
                                  end - len(out), seconds if device else None))
        return out[-1].id

    add("ivf.search", None, 0.010)
    out[0].counts.update({"ivf.slots_scored": scored, "ivf.slots_probed": probed})
    add("ivf.probe", root, 0.001)
    add("ivf.tables", root, 0.0005)
    for _ in range(chunks):
        adc = add("ivf.adc", root, 0.002)
        add("adc.table", adc, 0.00025)
        add("ivf.mask", root, 0.0005)
        add("ivf.select", root, 0.001)
    return out


@pytest.fixture
def recorded(monkeypatch):
    found = []
    monkeypatch.setattr(profiling, "recorded_spans", lambda: list(found))
    return found


@pytest.mark.parametrize("metric,want", [
    ("probe_device_pct.ivf", 10.0),
    ("adc_device_pct.ivf", 100 * (0.0005 + 2 * 0.002) / 0.010),
    ("mask_device_pct.ivf", 100 * 2 * 0.0005 / 0.010),
    ("select_device_pct.ivf", 100 * 2 * 0.001 / 0.010),
])
def test_the_device_shares_of_an_ivf_request(recorded, metric, want):
    # a request that ended before the window is not read
    recorded += _request(0, 0, 900, chunks=5)
    recorded += _request(100, 2_000, 5_000) + _request(200, 6_000, 9_000)
    assert _reader(metric).read(_trace(), metric) == pytest.approx(want)


def test_the_shares_are_taken_over_the_timed_requests(recorded):
    recorded += _request(0, 2_000, 3_000, chunks=3) + _request(100, 3_500, 5_000, device=False)
    metric = "select_device_pct.ivf"
    assert _reader(metric).read(_trace(), metric) == pytest.approx(30.0)


def test_scored_over_probed_adds_up_the_windows_requests(recorded):
    """Counts of every request in the window, timed or not, summed before
    the ratio; a request before the window adds nothing."""
    recorded += _request(0, 0, 900, scored=1_000, probed=1)
    recorded += _request(100, 2_000, 5_000, scored=40, probed=10)
    recorded += _request(200, 6_000, 9_000, device=False, scored=20, probed=10)
    metric = "scored_over_probed.ivf"
    assert _reader(metric).read(_trace(), metric) == pytest.approx(3.0)


def test_scored_over_probed_reads_one_where_each_query_scores_its_own_cells(recorded):
    recorded += _request(0, 2_000, 5_000, scored=640, probed=640)
    metric = "scored_over_probed.ivf"
    assert _reader(metric).read(_trace(), metric) == 1.0


def test_dispatch_time_leaves_out_the_runtime_calls(recorded):
    """Requests of 3,000 ns: the first holds runtime calls over 800 ns, the
    second the profiler's buffer handling over 1,000; a range named like a
    span is no runtime call."""
    recorded += _request(0, 2_000, 5_000) + _request(100, 6_000, 9_000)
    host = [("cudaMemcpyAsync", 1_900, 2_100), ("cudaLaunchKernel", 2_500, 3_000),
            ("cuLaunchKernel", 2_800, 3_200), ("ivf.adc", 2_000, 5_000),
            ("Activity Buffer Request", 6_000, 6_600), ("Buffer Flush", 6_500, 7_000)]
    metric = "dispatch_ms_per_request.ivf"
    assert _reader(metric).read(_trace(host), metric) == pytest.approx((2_200 + 2_000) / 2e6)


@pytest.mark.parametrize("metric", METRICS)
def test_nothing_to_read_is_none(recorded, metric):
    assert _reader(metric).read(_trace(), metric) is None


@pytest.mark.parametrize("metric", METRICS)
def test_an_exhaustive_search_is_not_read_as_ivf(recorded, metric):
    recorded.append(profiling.Span("search", 0, None, 0, 2_000, 5_000, 0.01))
    recorded.append(profiling.Span("search.adc", 1, 0, 0, 2_100, 4_000, 0.005))
    assert _reader(metric).read(_trace(), metric) is None


@pytest.mark.parametrize("metric", METRICS)
def test_a_program_without_spans_reads_none(monkeypatch, metric):
    monkeypatch.delattr(profiling, "recorded_spans")
    assert _reader(metric).read(_trace(), metric) is None


@pytest.mark.parametrize("metric", SHARES)
def test_a_device_share_is_none_without_device_seconds(recorded, metric):
    recorded += _request(0, 2_000, 5_000, device=False)
    assert _reader(metric).read(_trace(), metric) is None


@pytest.mark.parametrize("metric", ["scored_over_probed.ivf", "dispatch_ms_per_request.ivf"])
def test_counts_and_host_times_need_no_device_seconds(recorded, metric):
    recorded += _request(0, 2_000, 5_000, device=False)
    assert _reader(metric).read(_trace(), metric) is not None


def test_spans_without_counters_read_no_ratio(recorded):
    """A program whose spans carry no counts (no ``counts`` at all)."""
    recorded.append(types.SimpleNamespace(name="ivf.search", id=0, parent=None, request=0,
                                          start_ns=2_000, end_ns=5_000, device_s=0.01))
    metric = "scored_over_probed.ivf"
    assert _reader(metric).read(_trace(), metric) is None
