"""The spans and counters of ``ivf.ivf_search``: nothing recorded while no
profiler runs; under one, a call is one request whose outermost span is
``ivf.search``, with the probe's stages under it and, on that span, the
counts of the (query, slot) pairs scored and of those each query probed.
On a card: the CUDA-only profile records them with device seconds."""

import pytest
import torch

from reductive_tpu_torch import Pq, ivf, utils
from reductive_tpu_torch.utils import profiling

D, C, M, K = 16, 16, 4, 16

# Each span of the ADC-table probe and its parent's name.
LUT_TREE = {
    "ivf.search": None, "ivf.probe": "ivf.search", "ivf.tables": "ivf.search",
    "ivf.adc": "ivf.search", "adc.table": "ivf.adc", "ivf.mask": "ivf.search",
    "ivf.select": "ivf.search",
}
DECODE_TREE = {"ivf.search": None, "ivf.probe": "ivf.search", "ivf.mask": "ivf.search",
               "ivf.select": "ivf.search"}


@pytest.fixture(autouse=True)
def fresh_recorder(monkeypatch):
    """A recorder of this test's spans alone, its ids from 0."""
    monkeypatch.setattr(profiling, "_RECORDER", profiling._Recorder())


def _index(device="cpu", n=800, seed=0):
    """An index of ``C`` uneven cells over clustered rows, and 7 queries
    near its rows."""
    g = torch.Generator().manual_seed(seed)
    centres = 3.0 * torch.randn(C, D, generator=g)
    x = centres[torch.randint(0, C, (n,), generator=g)] + 0.3 * torch.randn(n, D, generator=g)
    coarse = centres + 0.05 * torch.randn(C, D, generator=g)
    pq = Pq(codebooks=0.3 * torch.randn(M, K, D // M, generator=g).to(device))
    index = ivf.build_ivf(coarse.to(device), pq, x.to(device), capacity="auto")
    q = x[::n // 7][:7] + 0.05 * torch.randn(7, D, generator=g)
    return index, q.to(device)


def _profiled(fn, activity=torch.profiler.ProfilerActivity.CPU):
    with torch.profiler.profile(activities=[activity]):
        return fn()


def _tree(spans, want):
    """The one request's root, after checking each span's parent by name."""
    by_id = {s.id: s for s in spans}
    (root,) = [s for s in spans if s.parent is None]
    assert root.name == "ivf.search" and {s.request for s in spans} == {root.id}
    for s in spans:
        assert want[s.name] == (by_id[s.parent].name if s.parent is not None else None)
        assert root.start_ns <= s.start_ns <= s.end_ns <= root.end_ns
    return root


def _union(q, coarse, nprobe, metric="l2"):
    """How many cells the queries' ``nprobe`` nearest cover, by float64
    distances (``"dot"``: the largest inner products)."""
    q, coarse = q.double(), coarse.double()
    d = torch.cdist(q, coarse) if metric == "l2" else -(q @ coarse.T)
    return int(torch.unique(torch.argsort(d, dim=1)[:, :nprobe]).numel())


@pytest.mark.parametrize("one_cell_a_chunk", [False, True])
@pytest.mark.parametrize("metric", ["l2", "dot"])
def test_a_search_by_the_adc_table_probe_is_one_request(monkeypatch, one_cell_a_chunk, metric):
    """The probe's stages under one ``ivf.search``, a chunk of cells each
    (one chunk, or one a cell where the budget holds one cell's scores);
    the counts by hand; the answers those of a call without a profiler."""
    index, q = _index()
    nq, L = q.shape[0], index.cell_ids.shape[1]
    if one_cell_a_chunk:
        monkeypatch.setattr(ivf, "_PROBE_LUT_BUDGET", 4 * nq * L)
    nprobe = 3
    run = lambda: ivf.ivf_search(index, q, 10, nprobe=nprobe, use_kernel=True, metric=metric)  # noqa: E731
    d, i = _profiled(run)
    d0, i0 = run()
    assert torch.equal(d, d0) and torch.equal(i, i0)
    spans = utils.recorded_spans()
    assert [s.id for s in spans] == list(range(len(spans)))
    root = _tree(spans, LUT_TREE)
    names = [s.name for s in spans]
    union = _union(q, index.coarse_centroids, nprobe, metric)
    assert union > nprobe
    assert names.count("ivf.probe") == names.count("ivf.tables") == 1
    for name in ("ivf.adc", "adc.table", "ivf.mask", "ivf.select"):
        assert names.count(name) == (union if one_cell_a_chunk else 1), name
    assert root.counts == {"ivf.slots_probed": nq * nprobe * L,
                           "ivf.slots_scored": nq * union * L}
    assert all(s.counts == {} for s in spans if s is not root)


def test_each_query_batch_adds_its_own_union(monkeypatch):
    """Queries in batches of 3 (a kernel's batch cut down): the probe runs a
    batch at a time, and each adds the pairs of its own union."""
    index, q = _index()
    L = index.cell_ids.shape[1]
    monkeypatch.setattr(ivf, "max_query_batch", lambda m, k, splits: 3)
    nprobe = 4
    _profiled(lambda: ivf.ivf_search(index, q, 5, nprobe=nprobe, use_kernel=True))
    spans = utils.recorded_spans()
    root = _tree(spans, LUT_TREE)
    assert [s.name for s in spans].count("ivf.probe") == 3
    unions = [_union(q[b:b + 3], index.coarse_centroids, nprobe) for b in range(0, 7, 3)]
    assert root.counts == {"ivf.slots_probed": 7 * nprobe * L,
                           "ivf.slots_scored": sum(u * len(q[b:b + 3]) * L
                                                   for u, b in zip(unions, range(0, 7, 3)))}


@pytest.mark.parametrize("metric", ["l2", "dot"])
def test_the_decode_probe_records_its_probe(metric):
    """Without the kernels the decode probe: its probe, scores and top-k,
    and every pair it scores is a probed one."""
    index, q = _index()
    L = index.cell_ids.shape[1]
    run = lambda: ivf.ivf_search(index, q, 10, nprobe=5, use_kernel=False, metric=metric)  # noqa: E731
    d, i = _profiled(run)
    d0, i0 = run()
    assert torch.equal(d, d0) and torch.equal(i, i0)
    spans = utils.recorded_spans()
    root = _tree(spans, DECODE_TREE)
    assert sorted(s.name for s in spans) == sorted(DECODE_TREE)
    pairs = q.shape[0] * 5 * L
    assert root.counts == {"ivf.slots_probed": pairs, "ivf.slots_scored": pairs}


def test_a_refined_search_is_one_ivf_search_span():
    index, q = _index()
    corpus = torch.randn(800, D)
    _profiled(lambda: ivf.ivf_search(index, q, 5, nprobe=3, use_kernel=True,
                                     refine_with=corpus))
    spans = utils.recorded_spans()
    assert [s.name for s in spans].count("ivf.search") == 1
    _tree(spans, LUT_TREE)


def test_without_a_profiler_nothing_is_recorded():
    index, q = _index()
    ivf.ivf_search(index, q, 5, nprobe=3, use_kernel=True)
    ivf.ivf_search(index, q, 5, nprobe=3, use_kernel=False)
    utils.count("ivf.slots_scored", 5)
    assert utils.recorded_spans() == []


def test_a_count_adds_to_the_outermost_open_span_only():
    """Counts go to the request (the outermost span), whichever span is
    innermost; outside every span they go nowhere."""
    def counted():
        utils.count("a", 1)
        with utils.span("outer"):
            utils.count("a", 2)
            with utils.span("inner"):
                utils.count("a", 3)
                utils.count("b", 4)
        with utils.span("next"):
            pass

    _profiled(counted)
    outer, inner, nxt = utils.recorded_spans()
    assert outer.counts == {"a": 5, "b": 4}
    assert inner.counts == {} and nxt.counts == {}


@pytest.mark.cuda
def test_on_the_card_the_cuda_profile_records_the_ivf_spans_and_counts():
    """Under the benchmark's profile (CUDA activity only) an ``ivf_search``
    on the card records every span of the ADC-table probe with device
    seconds (the first request is timed) and both counts."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    index, q = _index("cuda", n=20000)
    L = index.cell_ids.shape[1]
    ivf.ivf_search(index, q, 10, nprobe=4)
    torch.cuda.synchronize()

    def run():
        out = ivf.ivf_search(index, q, 10, nprobe=4)
        torch.cuda.synchronize()
        return out

    d, i = _profiled(run, torch.profiler.ProfilerActivity.CUDA)
    d0, i0 = run()
    assert torch.equal(d, d0) and torch.equal(i, i0)
    spans = utils.recorded_spans()
    root = _tree(spans, LUT_TREE)
    assert set(s.name for s in spans) == set(LUT_TREE)
    for s in spans:
        assert s.device_s is not None and s.device_s >= 0, s.name
    assert root.device_s > 0
    assert root.counts["ivf.slots_probed"] == q.shape[0] * 4 * L
    assert root.counts["ivf.slots_probed"] <= root.counts["ivf.slots_scored"]
