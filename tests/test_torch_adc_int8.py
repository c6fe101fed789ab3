"""The int8 ADC kernel of ``csrc/adc.cu`` (``adc_i8_kernel``) and its tables
(``int8_tables_kernel``) on the CPU: the launch plan (``ops.adc.adc_int8_plan``)
against the card's limits at the shapes the port drives, a transcription of
the kernel (the biased fill, each lane's rows, queries and code order, the
address of each lookup, the paired 16-bit sums and their flush, the final
``- 128 * valid`` and the dequantization) against ``adc_scores_reference``
bit for bit with the bank conflicts of every transcribed load counted, and a
transcription of the table kernel's order against ``quantize_tables_int8``
bit for bit.

The kernels themselves run only on the card (``tests/test_torch_cuda_kernels.py``,
``chip_smoke.py``); these tests hold what they are given and how they read.
"""

import numpy as np
import pytest
import torch

from reductive_tpu_torch.ops.adc import (
    AdcPlan, adc_int8_plan, adc_scores_reference, adc_table_int8, quantize_tables_int8,
    query_tile,
)
from reductive_tpu_torch.ops.packing import pack_u4_codes

H100_SMS = 132
SM_SHARED = 233_472     # bytes of shared memory an H100 SM gives its blocks
BLOCK_SHARED = 232_448  # the most one block may take
BLOCK_RESERVED = 1024   # reserved by CUDA for each resident block
FLUSH = 256             # codes a 16-bit half takes before it is flushed (kI8Flush)
TAIL = 256              # bytes of scales and offsets after the tables (kI8Tail)


def _table_bytes(qt, r, m, k):
    return -(-(r * qt * m * k) // 16) * 16


def _check_plan(plan, n, nq, m, k, packed):
    qt, r = plan.queries, plan.replicas
    assert qt in (1, 2, 4, 8, 16, 32) and (r == 1 or (qt >= 4 and r * qt == 128))
    assert not plan.skew  # the int8 kernel has no skewed walk
    assert plan.rows_per_load == 32 // max(1, qt // 16)
    assert plan.threads == (1024 if plan.blocks_per_sm == 1 else 512)
    assert plan.smem_bytes == _table_bytes(qt, r, m, k) + TAIL <= BLOCK_SHARED
    assert plan.blocks_per_sm in (1, 2)
    assert plan.blocks_per_sm * (plan.smem_bytes + BLOCK_RESERVED) <= SM_SHARED
    assert plan.query_tiles == -(-nq // qt) <= 65535
    assert plan.rows_per_block % 64 == 0 and plan.blocks * plan.rows_per_block >= n
    assert n == 0 or (plan.blocks - 1) * plan.rows_per_block < n
    assert plan.blocks * plan.query_tiles <= max(plan.query_tiles, H100_SMS * plan.blocks_per_sm)
    # Copies where 128 bytes of them an entry fit, and then the queries are
    # the least power of two that covers nq, 4 to 32; elsewhere as many as
    # fit, up to that cover.
    cover = min(32, max(4, 1 << max(0, (nq - 1).bit_length())))
    if 128 * m * k + TAIL <= BLOCK_SHARED:
        assert (qt, r) == (cover, 128 // cover)
    else:
        assert r == 1 and qt <= cover
        assert qt == cover or _table_bytes(2 * qt, 1, m, k) + TAIL > BLOCK_SHARED


# (n, m, k, packed): the flagship (d=128, m=16, k=256), search's 128-query
# chunk, the 4-bit path (k=16, packed), d=768 at m=24, m not a multiple of 8
# (one code a load), odd m, large tables (one and two queries a
# block), m past 256 (the flush), tiny shapes.
PLAN_SHAPES = [(4_000_000, 16, 256, False), (524_288, 16, 256, False), (4_000_000, 16, 16, True),
               (65_536, 24, 256, False), (65_536, 24, 16, True), (999, 18, 256, False),
               (999, 31, 256, False), (999, 200, 256, False), (100, 64, 2048, False),
               (100, 300, 4, False), (100, 300, 16, False), (1000, 3, 7, False), (1, 2, 16, True),
               (0, 16, 256, False)]


@pytest.mark.parametrize("nq", [1, 16, 130])
@pytest.mark.parametrize("n,m,k,packed", PLAN_SHAPES)
def test_the_int8_plan_fits_the_card(n, m, k, packed, nq):
    plan = adc_int8_plan(n, nq, m, k, packed)
    assert isinstance(plan, AdcPlan)
    _check_plan(plan, n, nq, m, k, packed)
    assert plan.queries <= max(4, query_tile(m, k, "int8"))


def test_the_int8_plan_at_the_shapes_the_main_paths_give_it():
    # Flagship, 16 queries: one tile of 16 (64 KB, two blocks of 512 an SM):
    # the codes are read once.
    flagship = adc_int8_plan(4_000_000, 16, 16, 256)
    assert flagship == AdcPlan(16, 1, False, 32, 1, 264, 15_168, 512, 65_792, 2)
    # search's chunks at 128 queries: four tiles of 32 (128 KB), codes read 4 times.
    assert adc_int8_plan(524_288, 128, 16, 256) == AdcPlan(
        32, 1, False, 16, 4, 33, 15_936, 1024, 131_328, 1)
    # The 4-bit path: 8 copies of each entry (32 KB).
    assert adc_int8_plan(4_000_000, 16, 16, 16, True) == AdcPlan(
        16, 8, False, 32, 1, 264, 15_168, 512, 33_024, 2)
    # d=768, m=24: 96 KB.
    assert adc_int8_plan(4_000_000, 16, 24, 256) == AdcPlan(
        16, 1, False, 32, 1, 264, 15_168, 512, 98_560, 2)
    # One query: four a block, each entry once (16 KB).
    assert adc_int8_plan(4_000_000, 1, 16, 256)[:3] == (4, 1, False)
    assert adc_int8_plan(999, 16, 5, 256)[:3] == (16, 8, False)
    # m = 18: each entry once, no rounding of m.
    assert adc_int8_plan(999, 16, 18, 256).smem_bytes == 16 * 18 * 256 + TAIL
    # Tables of 128 KB a query: one query a block.
    assert adc_int8_plan(10, 3, 64, 2048)[:3] == (1, 1, False)
    assert query_tile(16, 256, "int8") == 32 and query_tile(64, 2048, "int8") == 1
    assert query_tile(1, 232_192, "int8") == 1 and query_tile(1, 232_200, "int8") == 0
    with pytest.raises(ValueError, match="no shared-memory tiling"):
        adc_int8_plan(10, 1, 1, 232_200)
    with pytest.raises(ValueError, match="packed"):
        adc_int8_plan(10, 1, 3, 16, True)


# -- a transcription of adc_i8_kernel ----------------------------------------------


def _wavefronts(words, phase, active):
    """Wavefronts of one warp load: for each phase of ``phase`` lanes, the
    most distinct 4-byte words of its active lanes that fall in one bank."""
    out = []
    for p in range(0, words.shape[0], phase):
        uniq = np.unique(words[p:p + phase][active[p:p + phase]].ravel())
        if uniq.size:
            out.append(int(np.bincount(uniq % 32).max()))
    return out


def _fill(t8, scale, offset, nq, q0, plan, m, k):
    """A block's shared memory after the fill: entry (j, c) of query q0 + q,
    biased (``t8 ^ 0x80``), at byte ``slot * QT + q``, slot ``(j*k + c)*R +
    copy``; 0 past nq.  And the block's scales and offsets."""
    qt, r = plan.queries, plan.replicas
    smem = np.zeros(_table_bytes(qt, r, m, k), dtype=np.uint8)
    j, c = np.meshgrid(np.arange(m), np.arange(k), indexing="ij")
    for q in range(min(qt, nq - q0)):
        u = t8[q0 + q].view(np.uint8) ^ 0x80
        for copy in range(r):
            smem[((j * k + c) * r + copy) * qt + q] = u
    live = np.arange(qt) + q0 < nq
    sc = np.where(live, scale[np.minimum(q0 + np.arange(qt), nq - 1)], 0).astype(np.float32)
    of = np.where(live, offset[np.minimum(q0 + np.arange(qt), nq - 1)], 0).astype(np.float32)
    return smem, sc, of


def _entry_words(smem, addr, v):
    """The V bytes at each lane's address as little-endian 32-bit words
    (V < 4: zero-extended), and the 4-byte words of shared memory read."""
    nw = max(1, v // 4)
    b = smem[addr[:, None] + np.arange(v)[None, :]].astype(np.uint32)
    if v < 4:
        b = np.concatenate([b, np.zeros((b.shape[0], 4 - v), dtype=np.uint32)], axis=1)
    b = b.reshape(-1, nw, 4)
    w = b[:, :, 0] | (b[:, :, 1] << 8) | (b[:, :, 2] << 16) | (b[:, :, 3] << 24)
    touched = (addr[:, None] + np.arange(0, max(v, 1), 4)[None, :]) // 4
    return w, touched


class _Rows:
    """The lanes' sums of one row each: paired 16-bit halves, valid codes,
    and the flush of kernel's flush_row."""

    def __init__(self, v):
        self.v = v
        self.acc = np.zeros((32, 2 * max(1, v // 4)), dtype=np.uint32)
        self.valid = np.zeros(32, dtype=np.int64)

    def add(self, w, mask):
        lo = w & 0x00FF00FF
        hi = (w >> 8) & 0x00FF00FF
        self.acc[mask, 0::2] += lo[mask]
        self.acc[mask, 1::2] += hi[mask]
        self.valid[mask] += 1

    def flush(self, rows, live, qa, sc, of, first, last, out, part, writes, ql):
        nq = out.shape[0]
        for t in range(self.v):
            a = self.acc[:, 2 * (t // 4) + (t & 1)]
            half = (a >> 16) if t & 2 else (a & 0xFFFF)
            q = qa + t
            ok = live & (q < nq)
            s = half.astype(np.int64) - 128 * self.valid
            if not first:
                s = s + part[np.minimum(q, nq - 1), np.minimum(rows, out.shape[1] - 1)]
            if last:
                f = s.astype(np.float32) * sc[ql + t] + of[ql + t]
                out[q[ok], rows[ok]] = f[ok]
                np.add.at(writes, (q[ok], rows[ok]), 1)
            else:
                part[q[ok], rows[ok]] = s[ok]


def _code(codes, rows, j, live, packed):
    """Code j of each lane's row (0 for a lane past the block's rows)."""
    r = np.minimum(rows, codes.shape[0] - 1)
    if packed:
        b = codes[r, j // 2].astype(np.int64)
        c = (b >> 4) if j % 2 else (b & 0xF)
    else:
        c = codes[r, j].astype(np.int64)
    return np.where(live, c, 0)


def _walk_plain(smem, sc, of, codes, plan, m, k, packed, start, end, w, q0, out, part, writes,
                wf):
    """One warp of walk_plain_i8: lane takes rows base + lane//L (a row at a time),
    queries (lane % L)*V onward from copy (lane//L) % R; for j = 0..m-1 the V
    bytes at ((j*k + c)*R*QT + copy*QT + (lane % L)*V), a code not below k
    skipped; a flush every 256 codes."""
    qt, r_ = plan.queries, plan.replicas
    v = min(qt, 16)
    lanes = qt // v
    rw = 32 // lanes
    lane = np.arange(32)
    rl, h = lane // lanes, lane % lanes
    copy = rl % r_ if r_ > 1 else np.zeros(32, dtype=np.int64)
    s_lane = copy * qt + h * v
    phase = 8 if v == 16 else 16 if v == 8 else 32
    for base in range(start + w * rw, end, (plan.threads // 32) * rw):
        rows = base + rl
        live = rows < end
        for j1 in range(0, m, FLUSH):
            j2 = min(m, j1 + FLUSH)
            st = _Rows(v)
            for j in range(j1, j2):
                c = _code(codes, rows, j, live, packed)
                sel = c < k
                addr = s_lane + (j * k + np.where(sel, c, 0)) * (r_ * qt)
                words, touched = _entry_words(smem, addr, v)
                st.add(words, sel)
                if live.all():
                    wf += _wavefronts(touched, phase, sel)
            st.flush(rows, live, q0 + h * v, sc, of, j1 == 0, j2 == m, out, part, writes,
                     h * v)


def _transcribe(tables, codes, plan, packed=False):
    """Scores ``(nq, n)`` as the kernel computes them, how often each was
    written, and the wavefronts of every lookup of whole phases."""
    nq, m, k = tables.shape
    n = codes.shape[0]
    t8, scale, offset = (x.numpy() for x in quantize_tables_int8(torch.from_numpy(tables)))
    out = np.full((nq, n), np.nan, dtype=np.float32)
    part = np.zeros((nq, n), dtype=np.int64)
    writes = np.zeros((nq, n), dtype=np.int64)
    wf = []
    for by in range(plan.query_tiles):
        q0 = by * plan.queries
        smem, sc, of = _fill(t8, scale, offset, nq, q0, plan, m, k)
        for bx in range(plan.blocks):
            start = bx * plan.rows_per_block
            end = min(n, start + plan.rows_per_block)
            for w in range(plan.threads // 32):
                _walk_plain(smem, sc, of, codes, plan, m, k, packed, start, end, w, q0, out,
                            part, writes, wf)
    return out, writes, np.array(wf)


# (n, nq, m, k, packed, code dtype): the flagship width, m = 24 (d=768), 32
# queries a block (QT 32, two lanes a row), the 4-bit path (copies), an odd
# m, m = 18 and 12 (one code a load), m = 300 at k = 4 (copies, the flush)
# and at k = 16 (the flush), m = 300 at k = 256 (two queries a block: two
# bytes a lane, the flush), int32 codes, one and three queries (QT 4, four
# bytes a lane), one query a block (tables of 128 KB: one byte a lane), 130
# queries over a ragged last tile, codes below a k under 256.
TRANSCRIBED = [(700, 16, 16, 256, False, np.uint8), (300, 16, 24, 256, False, np.uint8),
               (200, 40, 16, 256, False, np.uint8), (300, 33, 24, 256, False, np.uint8),
               (600, 16, 16, 16, True, np.uint8), (600, 40, 12, 16, True, np.uint8),
               (257, 5, 7, 16, False, np.uint8), (300, 9, 18, 256, False, np.uint8),
               (300, 20, 12, 256, False, np.uint8), (130, 5, 300, 4, False, np.uint8),
               (130, 16, 300, 16, False, np.uint8), (70, 3, 300, 256, False, np.uint8),
               (300, 17, 16, 256, False, np.int32), (300, 40, 24, 256, False, np.int32),
               (300, 1, 16, 256, False, np.uint8), (300, 3, 16, 256, False, np.int32),
               (100, 2, 64, 2048, False, np.int32), (200, 130, 6, 200, False, np.int32)]


@pytest.mark.parametrize("n,nq,m,k,packed,dtype", TRANSCRIBED)
def test_the_transcribed_int8_kernel_is_the_plain_version_bit_for_bit(n, nq, m, k, packed, dtype):
    rng = np.random.default_rng(n + nq + m)
    tables = (rng.standard_normal((nq, m, k)) * 10).astype(np.float32)
    codes = rng.integers(0, k, (n, m)).astype(dtype)
    codes[::5, ::3] = k - 1
    plan = adc_int8_plan(n, nq, m, k, packed, sms=2)
    given = pack_u4_codes(torch.from_numpy(codes)).numpy() if packed else codes
    got, writes, wf = _transcribe(tables, given, plan, packed)
    assert (writes == 1).all()  # every (query, row) pair once
    want = adc_scores_reference(torch.from_numpy(tables), torch.from_numpy(given), splits="int8",
                                packed=packed).numpy()
    np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))
    if plan.replicas > 1:
        assert (wf == 1).all()  # no two rows of a phase in one bank
    elif plan.queries >= 4:
        assert wf.max() > 1


@pytest.mark.parametrize("n,nq,m,k,packed", [(640, 16, 16, 256, False), (640, 16, 16, 16, True),
                                             (320, 128, 16, 256, False), (320, 16, 24, 256, False)])
def test_wavefronts_a_phase_at_the_main_paths_plans(n, nq, m, k, packed):
    """The packed plan (copies) takes one wavefront a phase on every lookup.
    The plan at k = 256 (each entry once, the rows of a
    phase where their codes put them) takes the expected fullest of S slices
    under S rows: about 2.5 at QT = 16 (8 rows on 8 slices of 16 bytes) and 2.1
    at QT = 32 (4 rows on 4 slices of 32 bytes); one query a block (QT = 4) about
    3.5 (32 rows on 32 banks)."""
    rng = np.random.default_rng(3)
    tables = rng.standard_normal((nq, m, k)).astype(np.float32)
    codes = rng.integers(0, k, (n, m)).astype(np.uint8)
    given = pack_u4_codes(torch.from_numpy(codes)).numpy() if packed else codes
    plan = adc_int8_plan(n, nq, m, k, packed, sms=1)
    _, _, wf = _transcribe(tables, given, plan, packed)
    if packed:
        assert wf.size and (wf == 1).all()
        return
    expected = 2.5 if plan.queries == 16 else 2.1
    assert abs(wf.mean() - expected) < 0.15
    _, _, wf1 = _transcribe(tables[:1], codes, adc_int8_plan(n, 1, m, k, sms=1))
    assert 3.0 < wf1.mean() < 4.0


def test_a_half_holds_the_sums_of_256_codes():
    """256 codes of the largest biased entry (255) fill a half to 65,280:
    below 2^16, so the flush every 256 codes loses nothing; 258 would not."""
    assert FLUSH * 255 < 1 << 16 <= (FLUSH + 2) * 255


# -- a transcription of int8_tables_kernel -------------------------------------------


def _prepare_transcribed(tables):
    """int8_tables_kernel in f32 numpy: minima and maxima (exact in any
    order), scale = max(max_j (max_j - min_j) * f32(1/255), 1e-30), t8 =
    clamp(rint((t - min_j) / scale) - 128), offset = ((min_0 + min_1) + ...)
    + f32(128 m) * scale."""
    f = np.float32
    nq, m, _ = tables.shape
    lo = tables.min(axis=2)
    hi = tables.max(axis=2)
    s = ((hi - lo).max(axis=1) * (f(1) / f(255))).astype(f)
    s = np.where(s < f(1e-30), f(1e-30), s).astype(f)
    total = lo[:, 0].copy()
    for j in range(1, m):
        total = (total + lo[:, j]).astype(f)
    offset = (total + (f(128 * m) * s).astype(f)).astype(f)
    v = (np.rint((tables - lo[:, :, None]) / s[:, None, None]) - f(128)).astype(f)
    return np.clip(v, -128, 127).astype(np.int8), s, offset


def _kinds(kind, nq, m, k, seed):
    rng = np.random.default_rng(seed)
    if kind == "gauss":
        return (rng.standard_normal((nq, m, k)) * 10).astype(np.float32)
    if kind == "dot":  # negated inner products: negative, one sign
        return (-np.abs(rng.standard_normal((nq, m, k))) * 7 - 3).astype(np.float32)
    if kind == "constant":
        return np.full((nq, m, k), -2.5, dtype=np.float32)
    # Every table spans [0, 255] (scale 1) and the entries lie halfway
    # between two levels: round half to even.
    t = rng.integers(0, 255, (nq, m, k)).astype(np.float32) + np.float32(0.5)
    t[:, :, 0], t[:, :, -1] = 0.0, 255.0
    return t


@pytest.mark.parametrize("kind", ["gauss", "dot", "constant", "halfway"])
@pytest.mark.parametrize("nq,m,k", [(16, 16, 256), (3, 300, 4), (5, 7, 16), (2, 1, 2)])
def test_the_transcribed_table_kernel_is_the_quantizer_bit_for_bit(nq, m, k, kind):
    tables = _kinds(kind, nq, m, k, nq * m + k)
    t8, s, offset = _prepare_transcribed(tables)
    w8, ws, wo = (x.numpy() for x in quantize_tables_int8(torch.from_numpy(tables)))
    np.testing.assert_array_equal(t8, w8)
    np.testing.assert_array_equal(s.view(np.int32), ws.view(np.int32))
    np.testing.assert_array_equal(offset.view(np.int32), wo.view(np.int32))
    if kind == "halfway":
        assert (s == 1.0).all()
        x = tables[:, :, 1:-1]
        assert (x - np.floor(x) == 0.5).all()
        # Half to even: 0.5 -> 0, 1.5 -> 2, ..., so every level is even.
        assert ((t8[:, :, 1:-1].astype(np.int64) + 128) % 2 == 0).all()
    if kind == "constant":
        assert (s == np.float32(1e-30)).all() and (t8 == -128).all()
    # On the CPU the dispatcher takes the plain version.
    for a, b in zip(adc_table_int8(torch.from_numpy(tables)), (w8, ws, wo)):
        np.testing.assert_array_equal(a.numpy(), b)
