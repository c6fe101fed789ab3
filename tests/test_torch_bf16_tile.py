"""The narrow bf16 assignment of ``csrc/assign_tile.cuh`` on the CPU: its
launch plan (``ops.assign.bf16_tile_plan``) against the card's limits and an
independent count of the shared memory, and a transcription of its selection
(each thread's pairwise walk over its columns, the four lanes' shuffle, the
merge over centroid tiles) against ``torch.argmin``'s first index.

The kernels themselves run only on the card (``tests/test_torch_cuda_kernels.py``,
``chip_smoke.py``); these tests hold what they are given and how they choose.
"""

import pytest
import torch

from reductive_tpu_torch.ops.assign import TilePlan, _blocks_per_subquantizer, bf16_tile_plan

H100_SMS = 132
SM_SHARED = 233_472     # bytes of shared memory an H100 SM gives its blocks
BLOCK_SHARED = 232_448  # the most one block may take
BLOCK_RESERVED = 1024   # reserved by CUDA for each resident block
THREADS = 256


def _shared_bytes(rows: int, ds: int, stats: bool) -> int:
    """The kernels' shared memory, from their layout: 256 staged centroids
    of 2c in bf16 at a depth padded to 16 per step, their |c|^2 (f32), two
    f32 buffers of the tile's rows, a code and a distance a row; the
    statistics add the counting sort (eight warps' histograms over 256
    cells, 256 offsets, eight warp totals, a uint16 slot a row)."""
    steps = -(-ds // 16)
    staged = 256 * steps * 16 * 2 + 256 * 4
    rows_f32 = 2 * rows * ds * 4
    per_row = rows * (4 + 4)
    sort = (8 * 256 + 256 + 8) * 4 + rows * 2 if stats else 0
    return staged + rows_f32 + per_row + sort


# The code type (uint8 or int32) is the C entry's flag and never enters the
# plan; tests/test_torch_cuda_kernels.py runs both through the kernels.
@pytest.mark.parametrize("k", [1, 16, 256, 260, 4096])
@pytest.mark.parametrize("ds", [4, 8, 16, 32])
@pytest.mark.parametrize("stats", [False, True], ids=["encode", "stats"])
def test_the_bf16_tile_plan_fits_the_card(stats, ds, k):
    m = 16
    for n in (1, 1023, 1025, 4_000_000):
        plan = bf16_tile_plan(n, m, k, ds, sms=None if stats else H100_SMS)
        assert isinstance(plan, TilePlan)
        # 64-row subtiles, two warpgroups: a whole number of subtiles each.
        assert plan.rows % (2 * 64) == 0 and plan.rows in (256, 512)
        assert plan.smem_bytes == _shared_bytes(plan.rows, ds, stats)
        assert plan.smem_bytes <= BLOCK_SHARED
        assert plan.blocks_per_sm * (plan.smem_bytes + BLOCK_RESERVED) <= SM_SHARED
        # Registers: 256 threads a block, at most 255 a thread and 64K an SM;
        # three blocks leave 80 a thread (one accumulator set), two 128.
        assert plan.blocks_per_sm * THREADS * (80 if plan.blocks_per_sm == 3 else 128) <= 65_536
        assert plan.blocks >= 1 and plan.blocks * m < 2 ** 31
        if stats:
            # From the shapes alone, and the partial sums' scratch within 256 MB.
            target = 1056 * plan.blocks_per_sm // 2
            assert plan.blocks == _blocks_per_subquantizer(n, m, k, ds, target)
            assert plan.blocks * m * k * (ds + 1) <= 1 << 26
        else:
            # Four waves of the blocks the card holds, and no block without a tile.
            assert plan.blocks <= max(1, 4 * H100_SMS * plan.blocks_per_sm // m)
            assert plan.blocks <= -(-n // plan.rows)
        # k does not change what the kernel was compiled for.
        ref = bf16_tile_plan(n, m, 256, ds, sms=None if stats else H100_SMS)
        assert (plan.rows, plan.smem_bytes, plan.blocks_per_sm) == (
            ref.rows, ref.smem_bytes, ref.blocks_per_sm)


def test_the_bf16_tile_plan_at_the_flagship_shape():
    # n = 4,000,000, m = 16, k = 256, ds = 8: three blocks an SM.
    assert bf16_tile_plan(4_000_000, 16, 256, 8, sms=H100_SMS) == TilePlan(512, 99, 46_080, 3)
    assert bf16_tile_plan(4_000_000, 16, 256, 8) == TilePlan(512, 99, 56_352, 3)
    # ds = 16 and 32 hold two blocks an SM; the statistics keep the f32 grid.
    assert bf16_tile_plan(4_000_000, 16, 256, 32) == TilePlan(256, 66, 94_752, 2)
    assert bf16_tile_plan(4_000_000, 16, 256, 16).blocks == _blocks_per_subquantizer(
        4_000_000, 16, 256, 16)
    # Every ds up to 32 is planned at its padded width; a wider one is not.
    assert bf16_tile_plan(4_000_000, 16, 256, 12) == bf16_tile_plan(4_000_000, 16, 256, 16)
    with pytest.raises(ValueError, match="narrow bf16"):
        bf16_tile_plan(1000, 4, 256, 48)


# -- the selection ---------------------------------------------------------------

TILE, QUARTER = 256, 64


def _kernel_argmin(scores: torch.Tensor) -> torch.Tensor:
    """``assign_tile.cuh``'s choice for each row of ``scores`` (rows, k), in
    its order of operations: per 256-column tile and lane t (of the four
    that share a row), the columns 2t, 2t + 1 of each 8-column group in
    rising order, a pair's least value replacing the running best only when
    strictly smaller (``PickFma::take``, ``Pick::take`` in f32 mode), the
    column read back from the pair's first value; then the lanes by two xor
    shuffles, the smaller index on an equal value (``finish``); then the
    tiles, an earlier tile keeping a tie.  Columns past k count as +inf and groups wholly past it are skipped,
    as in the kernel."""
    rows, k = scores.shape
    out = []
    for r in range(rows):
        s = [float(v) for v in scores[r]]
        best_row = idx_row = None
        for k0 in range(0, k, TILE):
            kt = min(TILE, k - k0)
            cols_done = -(-kt // QUARTER) * QUARTER
            lanes = []
            for t in range(4):
                best, keep, base = float("inf"), float("inf"), 0
                for q in range(cols_done // QUARTER):
                    for i in range(QUARTER // 8):
                        last = q + 1 == cols_done // QUARTER
                        if last and 8 * i >= kt - q * QUARTER:
                            continue
                        col0 = k0 + q * QUARTER + 8 * i
                        d0, d1 = (s[c] if c < k0 + kt else float("inf")
                                  for c in (col0 + 2 * t, col0 + 2 * t + 1))
                        lo = min(d0, d1)
                        if lo < best:
                            best, keep, base = lo, d0, col0
                lanes.append([best, base + 2 * t + (0 if keep == best else 1)])
            for off in (1, 2):
                new = []
                for t in range(4):
                    v, i = lanes[t]
                    ov, oi = lanes[t ^ off]
                    new.append([ov, oi] if (ov < v or (ov == v and oi < i)) else [v, i])
                lanes = new
            best, idx = lanes[0]
            if k0 == 0 or best < best_row:
                best_row, idx_row = best, idx
        out.append(idx_row)
    return torch.tensor(out)


def _adversarial_scores(k: int, case: str) -> torch.Tensor:
    """Rows of scores built to catch a selection that does not keep the first
    index: the minimum repeated within a column pair, across pairs of one
    lane, across the lanes of a group, across quarters and across centroid
    tiles; rows of one value; signed zeros; infinities."""
    gen = torch.Generator().manual_seed(k)
    base = torch.randn((8, k), generator=gen).abs() + 1.0
    rows = []
    for r in range(base.shape[0]):
        s = base[r].clone()
        if case == "pair":
            lo = r % (k // 2) * 2
            s[lo] = s[lo + 1] = -1.0
        elif case == "lanes":  # columns 8i + 2t of one group, every lane
            g = 8 * (r % max(1, k // 8))
            s[g:g + 8] = -1.0
        elif case == "across":  # the minimum repeated far apart
            for c in (r, r + 64, r + 200, k - 1 - r):
                if 0 <= c < k:
                    s[c] = -2.0
        elif case == "equal":
            s[:] = 3.5
        elif case == "zeros":
            s[r % k] = 0.0
            s[(r * 7 + 3) % k] = -0.0
            s[(r * 13 + 5) % k] = 0.0
            s[s > 0] = 1.0
        elif case == "inf":
            s[:] = float("inf")
            if r % 2:
                s[(r * 11) % k] = float("-inf")
                s[(r * 11 + 64) % k] = float("-inf")
        rows.append(s)
    return torch.stack(rows)


@pytest.mark.parametrize("case", ["pair", "lanes", "across", "equal", "zeros", "inf"])
@pytest.mark.parametrize("k", [7, 16, 64, 200, 256, 260, 520])
def test_the_selection_keeps_the_first_index(k, case):
    scores = _adversarial_scores(k, case)
    assert torch.equal(_kernel_argmin(scores), torch.argmin(scores, dim=1))
