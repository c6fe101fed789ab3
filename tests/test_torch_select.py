"""The selection kernel's side that runs without a card (``ops/select.py``):
the order of its keys against a stable sort, its launch plan against an
H100's limits, the routing of ``search._smallest``, and the plain version it
is held to.  The kernel itself is held to the plain version bit for bit in
``tests/test_torch_cuda_kernels.py`` on the card."""

import types

import numpy as np
import pytest
import torch

from reductive_tpu_torch import Pq
from reductive_tpu_torch import search as tsearch
from reductive_tpu_torch.ops import select

# An H100 SXM: SMs, threads a block, shared memory a block without the opt-in,
# the grid's x extent.
SMS = 132
MAX_THREADS = 1024
SMEM_DEFAULT = 48 * 1024
GRID_X = (1 << 31) - 1


def _adversarial(seed, n=4000):
    """Signed zeros, infinities, NaN of several payloads and signs,
    subnormals, the extreme finite values, and values repeated at many
    positions."""
    rng = np.random.default_rng(seed)
    special = np.array([0.0, -0.0, np.inf, -np.inf, 1e-45, -1e-45, 1e-40, -1e-40,
                        np.finfo(np.float32).max, -np.finfo(np.float32).max,
                        np.finfo(np.float32).tiny, -np.finfo(np.float32).tiny, 1.0, -1.0],
                       dtype=np.float32)
    nan_bits = np.array([0x7FC00000, 0xFFC00000, 0x7F800001, 0xFFFFFFFF, 0x7FFFFFFF],
                        dtype=np.uint32).view(np.float32)
    pool = np.concatenate([special, nan_bits, rng.standard_normal(8).astype(np.float32)])
    return pool[rng.integers(0, pool.shape[0], n)]


def _order_bits(x: np.ndarray) -> np.ndarray:
    """A transcription of ``order_bits`` in ``csrc/select.cu``, the high
    half of the kernel's keys, as int64: f32 values mapped to unsigned ints
    in their order, ``-0.0`` as ``+0.0`` and every NaN to ``2^32 - 1``."""
    u = np.asarray(x, dtype=np.float32).view(np.uint32).astype(np.int64)
    u = np.where(u == 0x80000000, 0, u)
    mapped = np.where(u >= 0x80000000, 0xFFFFFFFF - u, u | 0x80000000)
    return np.where(np.isnan(x), 0xFFFFFFFF, mapped)


@pytest.mark.parametrize("seed", range(6))
def test_the_key_order_is_the_stable_sort(seed):
    x = _adversarial(seed)
    keys = _order_bits(x)
    assert keys.min() >= 0 and keys.max() <= 0xFFFFFFFF
    order = np.lexsort((np.arange(x.shape[0]), keys))
    want = torch.sort(torch.from_numpy(x), stable=True).indices.numpy()
    np.testing.assert_array_equal(order, want)


def test_the_keys_tie_signed_zeros_and_every_nan():
    x = np.array([0.0, -0.0, np.nan, -np.nan, np.inf], dtype=np.float32)
    x = np.concatenate([x, np.array([0x7F800001, 0xFFFFFFFF], dtype=np.uint32).view(np.float32)])
    keys = _order_bits(x).tolist()
    assert keys[0] == keys[1] == 0x80000000
    assert keys[2] == keys[3] == keys[5] == keys[6] == 0xFFFFFFFF
    assert keys[4] == 0xFF800000 < keys[2]


def test_the_keys_keep_the_order_of_every_finite_value():
    # Every 2^16-th bit pattern, both signs, sorted as floats: keys strictly
    # increase except between -0.0 and +0.0.
    bits = np.arange(0, 0x7F800000, 1 << 16, dtype=np.uint32)
    pos = bits.view(np.float32)
    vals = np.sort(np.concatenate([pos, -pos]))
    keys = _order_bits(vals)
    steps = np.diff(keys)
    assert (steps >= 0).all() and (steps == 0).sum() == 1


@pytest.mark.parametrize("nq,n", [(128, 524_288), (128, 453_215), (1, 8_841_823), (130, 524_288),
                                  (130, 2049), (16, 16_384), (1, 2049), (70_000, 4096)])
@pytest.mark.parametrize("k", [1, 7, 100, 101, 1024])
def test_the_plan_fits_the_card(nq, n, k):
    plan = select.select_plan(nq, n, k, SMS)
    assert plan.kp >= k and plan.kp & (plan.kp - 1) == 0 and plan.kp < 2 * k + 1
    assert 1 <= plan.slices <= -(-n // 4)  # every slice holds a 16-byte group
    assert nq * plan.slices <= GRID_X and nq <= GRID_X
    assert select._THREADS <= MAX_THREADS
    assert plan.pass_smem <= SMEM_DEFAULT and plan.merge_smem <= SMEM_DEFAULT
    assert plan.slices == 1 or n // plan.slices >= select._MIN_SLICE
    # One wave of four blocks an SM at most.
    assert nq * plan.slices <= 4 * SMS or plan.slices == 1


def test_the_plan_at_the_flat_search_cell():
    # 128 queries over chunks of 524,288 codes: 4 slices, one wave.
    plan = select.select_plan(128, 524_288, 100, SMS)
    assert plan.slices == 4 and plan.kp == 128
    assert select.select_plan(1, 8_841_823, 100, SMS).slices == select._MAX_SLICES


@pytest.mark.parametrize("k", [0, select.MAX_K + 1])
def test_the_plan_refuses_k_out_of_range(k):
    with pytest.raises(ValueError, match="k must be"):
        select.select_plan(4, 10_000, k)


def _fake(n, k, device="cuda", dtype=torch.float32, offset=0):
    return types.SimpleNamespace(shape=(4, n), is_cuda=device == "cuda", dtype=dtype), k, offset


@pytest.mark.parametrize("fake,takes", [
    (_fake(2049, 100), True),
    (_fake(8_841_823, 1024), True),
    (_fake(2048, 100), False),
    (_fake(100_000, 1025), False),
    (_fake(100_000, 10, device="cpu"), False),
    (_fake(100_000, 10, dtype=torch.float64), False),
    (_fake(100_000, 10, dtype=torch.bfloat16), False),
    # A streamed chunk's ids are offset + column: the last id below 2^32 - 1.
    (_fake(524_288, 100, offset=select.ID_LIMIT - 524_288), True),
    (_fake(524_288, 100, offset=select.ID_LIMIT - 524_287), False),
    (_fake(524_288, 100, offset=1 << 32), False),
])
def test_smallest_routes_by_shape_type_and_device(fake, takes):
    assert tsearch._kernel_selects(*fake) is takes


def test_on_the_cpu_smallest_keeps_its_plain_route(monkeypatch):
    def refuse(*args, **kwargs):
        raise AssertionError("the kernel route was taken on the CPU")

    monkeypatch.setattr(tsearch, "select_smallest_kernel", refuse)
    taken = []
    plain = tsearch._smallest_long
    monkeypatch.setattr(tsearch, "_smallest_long", lambda s, k: taken.append(k) or plain(s, k))
    rng = np.random.default_rng(0)
    scores = torch.from_numpy(rng.integers(0, 9, (3, 5000)).astype(np.float32))
    vals, ids = tsearch._smallest(scores, None, 50)
    assert taken == [50]
    want = torch.sort(scores, dim=1, stable=True)
    assert torch.equal(ids, want.indices[:, :50]) and torch.equal(vals, want.values[:, :50])


def test_a_streamed_search_leaves_the_kernel_where_its_ids_end(monkeypatch):
    # The streamed loop hands a chunk to the kernel, with its offset, only
    # while offset + chunk stays within the kernel's ids; the chunks past that
    # stay on the plain route (top-k, repair, concatenated merge), with the
    # same answer.  On the CPU the wrapper is the plain version: the device is
    # faked in the routing, and the limit lowered to three chunks' ids.
    chunk, n, top_k = 4096, 5 * 4096 + 1000, 50
    monkeypatch.setattr(tsearch, "ID_LIMIT", 3 * chunk)
    route = tsearch._kernel_selects
    monkeypatch.setattr(tsearch, "_kernel_selects", lambda s, k, offset=0: route(
        types.SimpleNamespace(shape=s.shape, is_cuda=True, dtype=s.dtype), k, offset))
    offsets = []
    kernel = tsearch.select_smallest_kernel

    def record(scores, k, **kwargs):
        if "offset" in kwargs:
            offsets.append(kwargs["offset"])
        return kernel(scores, k, **kwargs)

    monkeypatch.setattr(tsearch, "select_smallest_kernel", record)
    rng = np.random.default_rng(3)
    pq = Pq(torch.from_numpy(rng.standard_normal((4, 16, 8), dtype=np.float32)))
    # 40 distinct codes: ties at every place, so the ids' order is checked.
    codes = torch.from_numpy(rng.integers(0, 16, (40, 4)).astype(np.int32))[
        torch.from_numpy(rng.integers(0, 40, n))]
    q = torch.from_numpy(rng.standard_normal((3, 32), dtype=np.float32))
    got = tsearch.search(pq, q, codes, top_k, method="einsum", stream_chunk=chunk)
    assert offsets == [0, chunk, 2 * chunk]
    monkeypatch.setattr(tsearch, "_kernel_selects", lambda s, k, offset=0: False)
    want = tsearch.search(pq, q, codes, top_k, method="einsum", stream_chunk=chunk)
    assert torch.equal(got[1], want[1]) and torch.equal(got[0], want[0])
    scores = tsearch.adc_scores(tsearch.adc_tables(pq, q), codes)
    order = torch.sort(scores, dim=1, stable=True).indices[:, :top_k]
    assert torch.equal(got[1], order)


@pytest.mark.parametrize("n,k", [(5000, 10), (5000, 1024), (300, 100), (1024, 1024)])
def test_the_plain_version_is_the_stable_sort_of_prior_and_row(n, k):
    # On the CPU the wrapper is the plain version: the k smallest of the prior
    # list and the row by (score, id), the row's ids offset + column.
    rng = np.random.default_rng(n + k)
    earlier = torch.from_numpy(rng.integers(0, 5, (2, max(k, 4000))).astype(np.float32))
    prior = select.select_smallest_kernel(earlier, k)
    scores = torch.from_numpy(rng.integers(0, 5, (2, n)).astype(np.float32))
    scores[:, ::7] = -0.0
    offset = 10_000
    vals, ids = select.select_smallest_kernel(scores, k, prior=prior, offset=offset)
    all_vals = torch.cat([earlier, scores], dim=1)
    all_ids = torch.cat([torch.arange(earlier.shape[1]), offset + torch.arange(n)])
    order = torch.sort(all_vals, dim=1, stable=True).indices[:, :k]
    assert torch.equal(ids, all_ids[order])
    assert torch.equal(vals.view(torch.int32), torch.gather(all_vals, 1, order).view(torch.int32))


@pytest.mark.parametrize("call,match", [
    (lambda s: select.select_smallest_kernel(s, 0), "k must be"),
    (lambda s: select.select_smallest_kernel(s, 1025), "k must be"),
    (lambda s: select.select_smallest_kernel(s[:, :5], 10), "exceeds the row length"),
    (lambda s: select.select_smallest_kernel(s, 10, offset=select.ID_LIMIT - 100), "2\\^32 - 1"),
    (lambda s: select.select_smallest_kernel(s, 10, offset=-1), "2\\^32 - 1"),
    (lambda s: select.select_smallest_kernel(s.double(), 10), "float32"),
    (lambda s: select.select_smallest_kernel(s, 10, prior=(s[:, :9], s[:, :9].long())),
     "prior list must be"),
    (lambda s: select.select_smallest_kernel(s, 10, prior=(s[:, :10], s[:, :10].int())),
     "float32 and int64"),
])
def test_the_wrapper_refuses_what_the_kernel_does_not_take(call, match):
    scores = torch.randn(2, 1000)
    with pytest.raises(ValueError, match=match):
        call(scores)
