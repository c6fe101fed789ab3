"""The f32 ADC kernel of ``csrc/adc.cu`` (``adc_f32_kernel``) on the CPU: its
launch plan (``ops.adc.adc_plan``) against the card's limits at the shapes the
port drives, and a transcription of the kernel (its table fill, each lane's
rows and queries, the address of each lookup, the order of the sums, the
stores) against ``adc_scores_reference`` bit for bit, with the bank
conflicts of every load counted from the transcribed addresses.

The kernel itself runs only on the card (``tests/test_torch_cuda_kernels.py``,
``chip_smoke.py``); these tests hold what it is given and how it reads.
"""

import numpy as np
import pytest
import torch

from reductive_tpu_torch.ops.adc import AdcPlan, adc_plan, adc_scores_reference, query_tile
from reductive_tpu_torch.ops.packing import pack_u4_codes

H100_SMS = 132
SM_SHARED = 233_472     # bytes of shared memory an H100 SM gives its blocks
BLOCK_SHARED = 232_448  # the most one block may take
BLOCK_RESERVED = 1024   # reserved by CUDA for each resident block
ROWS_PER_LANE = 2       # rows a lane takes at a time in the plain walk (kRowsPerLane)
SKEW_STREAMS = 2        # streams of rows a lane walks in the skewed walk (kSkewStreams)


def _check_plan(plan, n, nq, m, k):
    qt, r = plan.queries, plan.replicas
    assert qt in (1, 2, 4, 8, 16, 32) and (r == 1 or r * qt == 32)
    # The lag of the skewed walk is below 4 codes, and the rows are whole words.
    assert plan.skew == (r == 1 and qt in (8, 16) and m % 4 == 0)
    assert plan.threads == (1024 if plan.blocks_per_sm == 1 else 512)
    assert plan.rows_per_load == 32 // (qt // min(qt, 4))
    assert plan.smem_bytes == r * qt * m * k * 4 <= BLOCK_SHARED
    assert plan.blocks_per_sm in (1, 2)
    assert plan.blocks_per_sm * (plan.smem_bytes + BLOCK_RESERVED) <= SM_SHARED
    assert plan.query_tiles == -(-nq // qt) <= 65535
    # Every row in one block's range, none of the blocks empty, ranges on 64 rows.
    assert plan.rows_per_block % 64 == 0 and plan.blocks * plan.rows_per_block >= n
    assert n == 0 or (plan.blocks - 1) * plan.rows_per_block < n
    # One wave: no more blocks than the card holds at once (or one per tile).
    assert plan.blocks * plan.query_tiles <= max(plan.query_tiles,
                                                 H100_SMS * plan.blocks_per_sm)
    # Replicas where 32 copies fit, and then the queries are the least power
    # of two that covers nq; elsewhere as many queries as fit, up to that cover.
    cover = min(32, 1 << max(0, (nq - 1).bit_length()))
    if 128 * m * k <= BLOCK_SHARED:
        assert (qt, r) == (cover, 32 // cover)
    else:
        assert r == 1 and qt <= cover and (qt == cover or 2 * qt * m * k * 4 > BLOCK_SHARED)


# (n, m, k, packed): the flagship (d=128, m=16, k=256), the 4-bit path (k=16,
# packed), the kernels phase's d=768, m=24, one query's tables near a block's
# limit (m=200), a ragged small shape.
PLAN_SHAPES = [(4_000_000, 16, 256, False), (524_288, 16, 256, False),
               (4_000_000, 16, 16, True), (65_536, 24, 256, False), (65_536, 24, 16, True),
               (999, 200, 256, False), (1000, 3, 7, False), (1, 2, 16, True), (0, 16, 256, False)]


@pytest.mark.parametrize("nq", [1, 16, 130])
@pytest.mark.parametrize("n,m,k,packed", PLAN_SHAPES)
def test_the_adc_plan_fits_the_card(n, m, k, packed, nq):
    plan = adc_plan(n, nq, m, k, packed)
    assert isinstance(plan, AdcPlan)
    _check_plan(plan, n, nq, m, k)
    assert plan.queries <= query_tile(m, k)
    # The same plan without the packed flag: it only checks the shape.
    assert adc_plan(n, nq, m, k) == plan


def test_the_adc_plan_at_the_shapes_the_main_paths_give_it():
    # Flagship, 16 queries: 8 a block (128 KB, one block an SM), 66 blocks a tile.
    # Flagship, 16 queries: 8 a block (128 KB, one block of 1,024 threads an SM),
    # skewed, 66 blocks a tile.
    assert adc_plan(4_000_000, 16, 16, 256, sms=H100_SMS) == AdcPlan(
        8, 1, True, 16, 2, 66, 60_608, 1024, 131_072, 1)
    # search's chunks at 128 queries: 16 tiles of 8 blocks, one fill each.
    assert adc_plan(524_288, 128, 16, 256) == AdcPlan(
        8, 1, True, 16, 16, 8, 65_536, 1024, 131_072, 1)
    # The 4-bit path: 16 queries and two copies of each entry (32 KB), two
    # blocks of 512 an SM.
    assert adc_plan(4_000_000, 16, 16, 16, True) == AdcPlan(
        16, 2, False, 8, 1, 264, 15_168, 512, 32_768, 2)
    # d=768, m=24: 192 KB, one block an SM.
    assert adc_plan(65_536, 16, 24, 256) == AdcPlan(
        8, 1, True, 16, 2, 64, 1024, 1024, 196_608, 1)
    # m not a multiple of 4: no skew; m=200: one query a block, 200 KB.
    assert not adc_plan(999, 16, 18, 256).skew
    assert adc_plan(999, 3, 200, 256)[:3] == (1, 1, False)
    # One query at k=16: 32 copies, a row a lane.
    assert adc_plan(1000, 1, 16, 16, True)[:4] == (1, 32, False, 32)
    with pytest.raises(ValueError, match="no shared-memory tiling"):
        adc_plan(10, 1, 24, 65536)
    with pytest.raises(ValueError, match="packed"):
        adc_plan(10, 1, 3, 16, True)
    with pytest.raises(ValueError, match="packed"):
        adc_plan(10, 1, 4, 17, True)


# -- a transcription of adc_f32_kernel ------------------------------------------


def _wavefronts(words, phase):
    """Wavefronts of one warp load: for each phase of ``phase`` lanes, the
    most distinct 4-byte words that fall in one bank."""
    out = []
    for p in range(0, 32, phase):
        uniq = np.unique(words[p:p + phase].ravel())
        out.append(np.bincount(uniq % 32).max())
    return out


def _fill(flat, nq, q0, plan, m, k):
    """A block's shared memory after the fill.  Plain layout: chunk ``e`` of
    ``V = min(QT, 4)`` floats is entry ``e // CPE`` (``CPE = R*QT/V``), queries
    ``((e % CPE) % (QT/V)) * V`` onward.  Skewed layout: entry (j, c) at
    ``(c*m + j) * QT``.  Zeros past ``nq``."""
    qt, r = plan.queries, plan.replicas
    v = min(qt, 4)
    cpe = r * qt // v
    smem = np.zeros(m * k * cpe * v, dtype=np.float32)
    e = np.arange(m * k * cpe)
    entry, qq = e // cpe, (e % cpe) % (qt // v)
    if plan.skew:
        j, c = entry // k, entry % k
        dest = ((c * m + j) * cpe + qq) * v
    else:
        dest = e * v
    for t in range(v):
        q = q0 + qq * v + t
        smem[dest + t] = np.where(q < nq, flat[np.minimum(q, nq - 1), entry], 0.0)
    return smem


def _walk_plain(smem, codes, plan, k, start, end, w, qa, out, writes, wavefronts):
    """One warp of the plain walk: at each step of ``kRowsPerLane * 32/L``
    rows, lane ``lane`` takes rows ``base + u*32/L + lane//L`` and queries
    ``(lane % L) * V`` onward from copy ``(lane // L) % R``; for
    ``j = 0..m-1`` it adds the V floats at ``(j*k + c)*R*QT + copy*QT +
    (lane % L)*V``."""
    n, m = codes.shape
    nq = out.shape[0]
    qt, r = plan.queries, plan.replicas
    v = min(qt, 4)
    lanes = qt // v
    rw = 32 // lanes
    lane = np.arange(32)
    row_in_load, h = lane // lanes, lane % lanes
    copy = row_in_load % r if r > 1 else np.zeros(32, dtype=np.int64)
    lane_off = copy * qt + h * v
    phase = 32 if v == 1 else (16 if v == 2 else 8)   # lanes a phase of a 4-, 8-, 16-byte load
    step = rw * ROWS_PER_LANE
    for base in range(start + w * step, end, (plan.threads // 32) * step):
        for u in range(ROWS_PER_LANE):
            rows = base + u * rw + row_in_load
            live = rows < end
            acc = np.zeros((32, v), dtype=np.float32)
            for jj in range(m):
                c = np.where(live, codes[np.minimum(rows, n - 1), jj], 0).astype(np.int64)
                words = ((jj * k + c) * (r * qt) + lane_off)[:, None] + np.arange(v)[None, :]
                acc = acc + smem[words]
                wavefronts += _wavefronts(words[live], phase) if live.all() else []
            for t in range(v):
                q = qa + t
                ok = live & (q < nq)
                out[q[ok], rows[ok]] = acc[ok, t]
                np.add.at(writes, (q[ok], rows[ok]), 1)


def _walk_skewed(smem, codes, plan, start, end, w, qa, out, writes, wavefronts):
    """One warp of the skewed walk: lane ``lane`` takes ``SKEW_STREAMS``
    streams of rows, stream ``u`` rows ``base + u*32/L + lane//L`` (``base``
    from ``start + w * 32/L * SKEW_STREAMS``, stepping by the block's warps
    times that), each as one stream of code bytes read four at a time lagged
    by ``lag = (lane//L) % S`` bytes; in the first word of a row the bytes
    below the lag are the previous row's last codes, after which that row's
    sums are stored; for code ``g`` of a row it adds the V floats at
    ``c*m*QT + (g - lag)*QT + (lane % L)*V`` (``g - lag + m`` for the previous
    row's)."""
    n, m = codes.shape
    nq = out.shape[0]
    qt = plan.queries
    v, lanes = 4, qt // 4
    rw, s = 32 // lanes, 32 // qt
    lane = np.arange(32)
    r, h = lane // lanes, lane % lanes
    lag = r % s
    step = (plan.threads // 32) * rw * SKEW_STREAMS
    state = [{"cur": np.zeros((32, v), dtype=np.float32), "prev": np.zeros((32, v), dtype=np.float32),
              "last": np.zeros((32, 4), dtype=np.int64), "prev_row": np.full(32, -1)}
             for _ in range(SKEW_STREAMS)]

    def add_word(st, word, j0, first):
        for b in range(4):
            c = word[:, b]
            is_prev = first & (b < lag)
            j = np.where(is_prev, m + b, j0 + b) - lag
            words = (c * m * qt + j * qt + h * v)[:, None] + np.arange(v)[None, :]
            vals = smem[words]
            st["prev"] = np.where(is_prev[:, None], st["prev"] + vals, st["prev"])
            st["cur"] = np.where(is_prev[:, None], st["cur"], st["cur"] + vals)
            wavefronts.extend(_wavefronts(words, 8))

    def store_prev(st):
        for t in range(v):
            q = qa + t
            ok = (st["prev_row"] >= 0) & (q < nq)
            out[q[ok], st["prev_row"][ok]] = st["prev"][ok, t]
            np.add.at(writes, (q[ok], st["prev_row"][ok]), 1)

    def lagged(st, new):
        stream = np.concatenate([st["last"], new], axis=1)  # the word before, then this one
        st["last"] = new
        return stream[lane[:, None], 4 - lag[:, None] + np.arange(4)[None, :]]

    for base in range(start + w * rw * SKEW_STREAMS, end, step):
        row_bytes = []
        for u, st in enumerate(state):
            rows = base + u * rw + r
            row_bytes.append(np.where((rows < end)[:, None], codes[np.minimum(rows, n - 1)],
                                      0).astype(np.int64))
            st["cur"] = np.zeros((32, v), dtype=np.float32)
        for i in range(m // 4):
            for u, st in enumerate(state):
                add_word(st, lagged(st, row_bytes[u][:, 4 * i:4 * i + 4]), 4 * i, i == 0)
            if i == 0:
                for st in state:
                    store_prev(st)
        for u, st in enumerate(state):
            rows = base + u * rw + r
            st["prev"], st["prev_row"] = st["cur"], np.where(rows < end, rows, -1)
    for st in state:
        add_word(st, lagged(st, np.zeros((32, 4), dtype=np.int64)), 0, True)
        store_prev(st)


def _transcribe(tables, codes, plan, packed=False):
    """Scores ``(nq, n)`` as the kernel computes them, how often each was
    written, and the wavefronts of every shared-memory load of the lookups
    (one entry a phase)."""
    nq, m, k = tables.shape
    n = codes.shape[0]
    if packed:
        lo, hi = codes & 0xF, codes >> 4
        codes = np.stack([lo, hi], axis=2).reshape(n, m)
    qt = plan.queries
    v = min(qt, 4)
    flat = tables.reshape(nq, m * k).astype(np.float32)
    out = np.full((nq, n), np.nan, dtype=np.float32)
    writes = np.zeros((nq, n), dtype=np.int64)
    wavefronts = []
    h = np.arange(32) % (qt // v)
    for by in range(plan.query_tiles):
        q0 = by * qt
        smem = _fill(flat, nq, q0, plan, m, k)
        for bx in range(plan.blocks):
            start = bx * plan.rows_per_block
            end = min(n, start + plan.rows_per_block)
            for w in range(plan.threads // 32):
                if plan.skew:
                    _walk_skewed(smem, codes, plan, start, end, w, q0 + h * v, out, writes,
                                 wavefronts)
                else:
                    _walk_plain(smem, codes, plan, k, start, end, w, q0 + h * v, out, writes,
                                wavefronts)
    return out, writes, np.array(wavefronts)


# (n, nq, m, k, packed): the flagship width (skewed, several rows a stream),
# QT = 16 skewed (m = 8),
# tiny tables with 32 copies, k = 16 packed, 130 queries, m not a multiple of
# 4 at k = 256 (no skew), one query a block (m = 200).
TRANSCRIBED = [(2600, 16, 16, 256, False), (1500, 16, 8, 256, False), (300, 3, 5, 7, False),
               (257, 16, 16, 16, True), (150, 130, 6, 16, False), (200, 1, 4, 16, True),
               (190, 9, 18, 256, False), (130, 2, 200, 256, False)]


@pytest.mark.parametrize("n,nq,m,k,packed", TRANSCRIBED)
def test_the_transcribed_kernel_is_the_plain_version_bit_for_bit(n, nq, m, k, packed):
    rng = np.random.default_rng(n + nq)
    tables = (rng.standard_normal((nq, m, k)) * 10).astype(np.float32)
    codes = rng.integers(0, k, (n, m)).astype(np.uint8)
    # A small grid, so that several blocks and warps each take a share.
    plan = adc_plan(n, nq, m, k, packed, sms=2)
    given = pack_u4_codes(torch.from_numpy(codes)).numpy() if packed else codes
    got, writes, wavefronts = _transcribe(tables, given, plan, packed)
    assert (writes == 1).all()  # every (query, row) pair once
    want = adc_scores_reference(torch.from_numpy(tables), torch.from_numpy(given), splits=3,
                                packed=packed).numpy()
    np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))
    if plan.replicas > 1 or plan.queries == 32 or plan.skew:
        assert (wavefronts == 1).all()  # no two rows of a phase in one bank
    else:
        assert wavefronts.max() > 1


@pytest.mark.parametrize("m,k,packed,skew,expected", [
    (16, 256, False, True, 1.0), (16, 16, True, False, 1.0), (18, 256, False, False, 544 / 256)])
def test_wavefronts_a_load(m, k, packed, skew, expected):
    """At the flagship width (k=256, each entry stored once: 32 copies would
    take 512 KB) the skewed walk puts the four rows of a phase in four slices:
    one wavefront.  Where it cannot (m not a multiple of 4) the four rows at
    QT=8 collide when two codes fall in one 8-word slice of a line: about 2.1
    wavefronts a phase on random codes (the expected largest of 4 draws over 4
    slices is 544/256).  At k=16 the copies make it 1."""
    rng = np.random.default_rng(7)
    tables = rng.standard_normal((16, m, k)).astype(np.float32)
    codes = rng.integers(0, k, (512, m)).astype(np.uint8)
    plan = adc_plan(512, 16, m, k, packed, sms=1)
    assert plan.skew == skew
    given = pack_u4_codes(torch.from_numpy(codes)).numpy() if packed else codes
    _, _, wavefronts = _transcribe(tables, given, plan, packed)
    assert abs(wavefronts.mean() - expected) < 0.05
