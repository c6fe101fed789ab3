"""The IVF search check where a query's probe has near-ties: the rounding
bound of the program's probe score, the cells every valid probe holds, and
answers judged against the cells the program was entitled to probe."""

from __future__ import annotations

import pytest
import torch

from benchmark import run
from benchmark.reference import answers, ivf as ref_ivf, vq
from benchmark.tests import cells

D, NPROBE, TOP_K, L = 8, 3, 10, 4


def _program_scores(q, coarse):
    """The program's probe score, as ``ivf._coarse_scores`` computes it."""
    qc = q @ coarse.T
    return -((q * q).sum(dim=1)[:, None] + (coarse * coarse).sum(dim=1)[None, :] - 2.0 * qc)


@pytest.mark.parametrize("scale", [1e-3, 1.0, 3e2])
@pytest.mark.parametrize("d", [4, 32, 128])
def test_the_probe_score_lies_within_its_bound(scale, d):
    gen = torch.Generator().manual_seed(d)
    q = scale * torch.randn((64, d), generator=gen)
    coarse = q[:32] + scale * 1e-3 * torch.randn((32, d), generator=gen)
    coarse = torch.cat([coarse, scale * torch.randn((96, d), generator=gen)])
    exact = vq.sq_norms(q.double()[:, None, :] - coarse.double()[None, :, :])
    err = (_program_scores(q, coarse).double() + exact).abs()
    eps = ref_ivf.probe_eps(q, coarse)
    assert bool((err <= eps[:, None]).all())
    assert bool(((ref_ivf.cell_dists(q, coarse) - exact).abs() <= eps[:, None]).all())


def _index(second_edge: float):
    """One query and six cells: two nearer than the rest (must), two at
    distance 1 and ``1 + second_edge`` (the ``NPROBE``-th place and the
    next), two far; each cell holds ``L`` rows close to its centre."""
    q = torch.zeros((1, D))
    q[0, :2] = 1.0
    steps = [(2, 0.1), (3, 0.2), (4, 1.0), (5, (1.0 + second_edge) ** 0.5), (6, 3.0), (7, 5.0)]
    coarse = q.repeat(len(steps), 1)
    for c, (axis, length) in enumerate(steps):
        coarse[c, axis] += length
    gen = torch.Generator().manual_seed(0)
    codebooks = 1e-2 * torch.randn((2, 4, D // 2), generator=gen)
    cell_codes = torch.randint(0, 4, (len(steps), L, 2), generator=gen, dtype=torch.uint8)
    cell_ids = torch.arange(len(steps) * L).reshape(len(steps), L)
    return q, coarse, codebooks, cell_codes, cell_ids


def _answer(q, coarse, codebooks, cell_codes, cell_ids, probed):
    """A program that probes the cells ``probed``: its top ``TOP_K`` rows
    among them, by exact distances rounded to float32."""
    p = torch.tensor(probed)
    full = vq.decode(codebooks, cell_codes[p]) + coarse.double()[p][:, None, :]
    d = vq.sq_norms(q.double()[0] - full).reshape(-1)
    best = torch.topk(d, TOP_K, largest=False)
    return best.values[None].float(), cell_ids[p].reshape(-1)[best.indices][None]


def _numbers(index, probed):
    q, coarse, codebooks, cell_codes, cell_ids = index
    d, ids = _answer(*index, probed)
    return ref_ivf.search_numbers(q, coarse, codebooks, cell_codes, cell_ids,
                                  cell_ids.numel(), NPROBE, TOP_K, d, ids)


@pytest.mark.parametrize("second_edge", [0.0, 1e-6])
@pytest.mark.parametrize("edge_cell", [2, 3])
def test_a_query_at_the_probes_edge_is_correct_whichever_cell_it_probes(second_edge, edge_cell):
    index = _index(second_edge)
    must, edge = ref_ivf.probe_kinds(index[0], index[1], NPROBE)
    assert must[0].tolist() == [True, True, False, False, False, False]
    assert edge[0].tolist() == [False, False, True, True, False, False]
    numbers, notes = _numbers(index, [0, 1, edge_cell])
    assert notes["edge_queries"] == 1
    assert numbers["probe_miss"] == 0 and numbers["dup_ids"] == 0
    assert numbers["rank_gap"] <= 1e-12 and numbers["dist_err"] <= 1e-7


def test_cells_apart_by_more_than_the_bound_are_no_edge():
    index = _index(1e-2)
    _, edge = ref_ivf.probe_kinds(index[0], index[1], NPROBE)
    assert edge[0].tolist() == [False, False, True, False, False, False]
    numbers, notes = _numbers(index, [0, 1, 2])
    assert notes["edge_queries"] == 0 and numbers["probe_miss"] == 0
    assert _numbers(index, [0, 1, 3])[0]["rank_gap"] > 1e-3


@pytest.mark.parametrize("probed, miss", [([0, 1, 4], True), ([0, 1, 2, 3], True),
                                          ([1, 2, 3], False)],
                         ids=["a-far-cell", "more-cells-than-nprobe", "a-must-cell-skipped"])
def test_a_wrong_probe_at_the_edge_is_not_correct(probed, miss):
    numbers, _ = _numbers(_index(0.0), probed)
    assert (numbers["probe_miss"] > 0) is miss
    if not miss:
        assert numbers["rank_gap"] > 1e-3


def _search_before(q, coarse, codebooks, cell_codes, cell_ids, nprobe, top_k, qblock=8):
    """The reference's search as it stood before near-ties were allowed
    for, kept verbatim to hold today's numbers to it."""
    L = cell_codes.shape[1]
    c64 = coarse.double()
    q64 = q.double()
    d = vq.sq_norms(q64)[:, None] + vq.sq_norms(c64)[None, :] - 2.0 * (q64 @ c64.T)
    probed = torch.sort(d, dim=1, stable=True).indices[:, :nprobe]
    out = torch.full((q.shape[0], top_k), float("inf"), dtype=torch.float64, device=q.device)
    for a in range(0, q.shape[0], qblock):
        p = probed[a:a + qblock]
        full = vq.decode(codebooks, cell_codes[p]) + c64[p][:, :, None, :]
        d = vq.sq_norms(q[a:a + qblock].double()[:, None, None, :] - full)
        d = torch.where(cell_ids[p] >= 0, d, torch.full_like(d, float("inf")))
        kk = min(top_k, nprobe * L)
        out[a:a + qblock, :kk] = torch.topk(d.reshape(d.shape[0], -1), kk, dim=1,
                                            largest=False).values
    return out


def test_without_edge_cells_the_numbers_are_as_before(capsys):
    workload, config = cells.tiny(cells.IVF_SEARCH)
    driver = run.load_module(run.BENCH / "traffic" / "ivf_search.py")
    ctx = run.Context(config=config, params=workload["params"], seed=2**31 + 9, device="cpu")
    state = driver.setup(ctx)
    sampled = [(i, driver.step(state, i)) for i in range(4)]
    numbers = dict(driver.check(state, sampled))
    assert "probe edge: queries 64, edge_queries 0," in capsys.readouterr().err

    p, index, x = workload["params"], state["index"], state["x"]
    q = torch.cat([driver._queries(state, i) for i, _ in sampled])
    d_prog = torch.cat([out[0] for _, out in sampled])
    ids_prog = torch.cat([out[1] for _, out in sampled])
    cb, coarse = index.pq.codebooks, index.coarse_centroids
    assert not bool(ref_ivf.probe_kinds(q, coarse, p["nprobe"])[1].sum(dim=1).gt(1).any())
    d_ref = _search_before(q, coarse, cb, index.cell_codes, index.cell_ids, p["nprobe"],
                           p["top_k"])
    slot = ref_ivf.slot_of_id(index.cell_ids, x.shape[0])
    d_of = ref_ivf.dist_of(q, coarse, cb, index.cell_codes, slot, ids_prog)
    before = answers.answer_numbers(d_prog, ids_prog, d_ref, d_of, vq.sq_norms(q.double()))
    assert {k: numbers[k] for k in before} == before
    assert numbers["probe_miss"] == 0
