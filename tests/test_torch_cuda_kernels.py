"""The CUDA kernels against their plain PyTorch versions, on a GPU.

These tests need an NVIDIA GPU and ``nvcc``; elsewhere they skip.  Run them
on the card with

    python -m pytest tests/test_torch_cuda_kernels.py -q --noconftest

They cover the corners ``chip_smoke.py`` does not drive: k above one
centroid tile, k that is no power of two, every ds the encode kernel takes,
int32 codes, a number of subquantizers that is no multiple of four, tables
so large that fewer than eight queries share a block, and for the
assign+statistics kernel a single row, ragged row counts, more centroids
than one thread per centroid, rows that all fall in one cell and cells no
row reaches, at every ds; for the verified kernels the same shapes plus
duplicated centroids, rows on a centroid pair's midpoint, zero rows and rows
scaled far up and down; for the packed-u4 kernels m = 2, m no multiple of 8
and k below 16.  The f32 encode and the f32 statistics kernels run one
assignment routine: their codes, counts and flags are held equal bit for bit;
so do the bf16 ones (the encode's codes counted per cell are the statistics
kernel's counts), and where the bf16 products are exact the bf16 encode is
the plain version bit for bit, first index among duplicated centroids
included.
Every other width is held to the same: ds 1, 2, 3, 12 and 20 on the narrow
kernels' padded instances, ds 36, 37, 40, 48, 50, 64, 68, 75, 96, 100, 128 and
768 on the deep kernel (its rows by TMA where m ds is a multiple of 4, else
by cp.async): each kernel against its plain version, encode against
statistics, two launches bit-equal; the deep kernel against the shallow one
(forced) bit for bit at fifteen widths from 33 to 768, k from 1 to 4,096 and x
on 16 bytes or 1 to 3 floats off, with inf and NaN in the next subvector;
and the padded instances against the shallow kernel bit for bit at thirteen
widths up to 32, on rows off 16 bytes and at k from 1 to 257; decode at any ds, in
every table regime of the row-tile kernels (tiles of 1 to 64 rows), into an
``out`` off 16 bytes and from codes that start off a word, its tables bit for
bit the plain versions' on adversarial bit patterns, and at d=300, k=256.
Search keeps the lowest ids among scores tied at the k-th place.  The verified
statistics give the same bits twice on an adversarial corpus, narrow and
wide, and so does the plain route on the card.  The probe of the tensor
cores' accumulation must find what the verify bound assumes.  The wide
statistics' accumulation from the codes (``ops.stats.cell_stats``) equals its
plain version bit for bit, twice, on every row in one cell, on half the
cells empty and on random codes, at ds 3 to 768, k 1 to 65,536, on rows off
16 bytes and at d not a multiple of 4, and the wide statistics are the
accumulation of their own codes bit for bit.  The int8 ADC kernel equals its
plain version bit for bit on every plan (1 to 130 queries, copies, each
entry once, every query tile its C entry takes, m past 256, uint8, int32 and
packed codes, views off a word), and the ADC tables built on the card equal their
plain versions bit for bit.  The selection kernel (``ops.select``) equals its
plain version (``torch.topk`` and the tie repair, then the concatenated merge)
bit for bit on tie-heavy, signed-zero, infinite and random rows at k 1 to
1,024 and rows of 2,049 to 8,841,823, alone and with a prior list; NaN rows
rank as the CPU's stable sort; a streamed search through it equals the plain
route's.
"""

import pytest
import torch

from reductive_tpu_torch import ops
from reductive_tpu_torch.ops.assign import pq_encode_verify_flags
from reductive_tpu_torch.ops.stats import pq_assign_stats_verify_flags
from reductive_tpu_torch.pq import primitives

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.device("cuda")


def _data(dev, n, m, k, ds, seed=0):
    gen = torch.Generator(device=dev).manual_seed(seed)
    cb = torch.randn((m, k, ds), generator=gen, device=dev)
    x = torch.randn((n, m * ds), generator=gen, device=dev)
    return cb, x


@pytest.mark.parametrize("compute_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize(
    "n,m,k,ds", [(1000, 3, 7, 4), (4097, 16, 256, 8), (777, 2, 1000, 16), (513, 5, 300, 32)]
)
def test_encode_kernel_equals_plain(dev, n, m, k, ds, compute_dtype):
    cb, x = _data(dev, n, m, k, ds)
    got = ops.pq_encode(cb, x, dtype=torch.int32, compute_dtype=compute_dtype)
    want = ops.pq_encode_reference(cb, x, dtype=torch.int32, compute_dtype=compute_dtype)
    # f32 summation order may flip a near-tie: at most one code in a thousand.
    assert int((got != want).sum()) <= got.numel() // 1000
    narrow = ops.pq_encode(cb, x, dtype=torch.int16, compute_dtype=compute_dtype)
    assert narrow.dtype == torch.int16 and torch.equal(narrow.to(torch.int32), got)
    if k <= 256:
        u8 = ops.pq_encode(cb, x, compute_dtype=compute_dtype)
        assert u8.dtype == torch.uint8 and torch.equal(u8.to(torch.int32), got)


@pytest.mark.parametrize("splits", [1, 2, 3, "int8"])
@pytest.mark.parametrize("code_dtype", [torch.uint8, torch.int32, torch.int64])
@pytest.mark.parametrize("n,m,k,ds", [(1000, 3, 7, 4), (4097, 16, 256, 8), (513, 24, 256, 32),
                                      (1000, 10, 128, 2), (513, 3, 7, 3), (257, 1, 16, 1),
                                      (100, 2, 50, 5), (1, 10, 128, 2), (417, 10, 128, 2),
                                      (3000, 1, 300, 7), (999, 30, 256, 10), (50, 2, 256, 1023)])
def test_decode_kernel_equals_plain(dev, n, m, k, ds, code_dtype, splits):
    cb, _ = _data(dev, n, m, k, ds)
    codes = torch.randint(0, k, (n, m), device=dev).to(code_dtype)
    got = ops.pq_decode(cb, codes, splits=splits)
    assert torch.equal(got, ops.pq_decode_reference(cb, codes, splits=splits))
    out = torch.empty_like(got)
    assert ops.pq_decode(cb, codes, splits=splits, out=out) is out and torch.equal(out, got)


@pytest.mark.parametrize("splits", [1, 2, 3, "int8"])
@pytest.mark.parametrize("code_dtype", [torch.uint8, torch.int32])
@pytest.mark.parametrize(
    "n,m,k,nq", [(1000, 3, 7, 5), (4097, 16, 256, 16), (2000, 24, 256, 130), (999, 64, 256, 9),
                 (999, 200, 256, 3),
                 # The f32 plan's edges (ops.adc.adc_plan): one query, 130 (a ragged
                 # query tile), k = 16 and 17 (32 copies of every entry), m = 113 and
                 # 114 at k = 16 (the last shape with copies, the first without),
                 # odd m, rows that end mid-block and mid-load, three rows; the
                 # skewed walk at 16 queries a block (m = 8) and over three 16-byte
                 # loads a row (m = 48).
                 (1000, 16, 16, 1), (70001, 16, 256, 1), (1025, 17, 17, 130),
                 (65601, 31, 256, 20), (5000, 113, 16, 40), (5000, 114, 16, 40), (3, 5, 16, 33),
                 (5001, 8, 256, 16), (2500, 48, 128, 11)]
)
def test_adc_kernel_equals_plain(dev, n, m, k, nq, code_dtype, splits):
    gen = torch.Generator(device=dev).manual_seed(1)
    tables = torch.randn((nq, m, k), generator=gen, device=dev) * 10
    codes = torch.randint(0, k, (n, m), device=dev).to(code_dtype)
    got = ops.adc_scores_kernel(tables, codes, splits=splits)
    want = ops.adc_scores_reference(tables, codes, splits=splits)
    # Both add the m entries in the order j = 0..m-1.
    assert torch.equal(got, want)


@pytest.mark.parametrize("compute_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize(
    "n,m,k,ds",
    [(1, 3, 7, 4), (1000, 3, 7, 4), (4097, 16, 256, 8), (777, 2, 1000, 16), (513, 5, 300, 32),
     (70001, 1, 257, 8), (300000, 2, 16, 32)],
)
def test_stats_kernel_equals_plain_and_itself(dev, n, m, k, ds, compute_dtype):
    cb, x = _data(dev, n, m, k, ds)
    sums, counts = ops.pq_assign_stats(cb, x, compute_dtype=compute_dtype)
    again = ops.pq_assign_stats(cb, x, compute_dtype=compute_dtype)
    # No float atomics: the order of every sum is fixed by the shapes.
    assert torch.equal(sums, again[0]) and torch.equal(counts, again[1])
    want_sums, want_counts = ops.pq_assign_stats_reference(cb, x, compute_dtype=compute_dtype)
    assert float(counts.double().sum()) == n * m
    # f32 summation order may flip a near-tie: one row in a thousand at most.
    assert float((counts - want_counts).abs().sum()) / 2 <= max(1, n * m // 1000)
    same = (counts == want_counts)[:, :, None].expand_as(sums)
    # f32 sums of the same rows in another order.
    tol = 1e-5 * want_sums.abs() + 1e-4 * float(want_sums.abs().max())
    assert bool(((sums - want_sums).abs() <= tol)[same].all())
    # The codes behind the counts are the encode kernel's: the same arithmetic in
    # both modes (in f32 mode one routine, csrc/assign_tile.cuh).
    codes = ops.pq_encode(cb, x, dtype=torch.int32, compute_dtype=compute_dtype).to(torch.int64)
    by_code = torch.stack([torch.bincount(codes[:, jq], minlength=k) for jq in range(m)])
    assert torch.equal(by_code.to(torch.float32), counts)


def test_stats_kernel_feeds_the_trainers(dev):
    from reductive_tpu_torch import Pq, train_opq_chunked, train_pq_chunked
    from reductive_tpu_torch.pq.train import init_codebooks_random

    gen = torch.Generator(device=dev).manual_seed(0)
    x = torch.rand((20000, 32), generator=gen, device=dev)
    ops.reset_launch_counts()
    state = gen.get_state()
    a = train_pq_chunked(gen, x, 4, 6, 5)
    gen.set_state(state)
    b = train_pq_chunked(gen, x, 4, 6, 5)
    assert ops.launch_counts() == {"stats_f32": 10}
    assert torch.equal(a.codebooks, b.codebooks)  # training repeats bit for bit
    # The plain route from the same first codebooks, on the CPU.
    gen.set_state(state)
    first = init_codebooks_random(x, gen, 64, 8)
    plain = train_pq_chunked(None, x.cpu(), 4, 6, 5, initial_model=Pq(codebooks=first.cpu()))
    assert float((a.codebooks.cpu() - plain.codebooks).abs().max()) < 1e-3
    ops.reset_launch_counts()
    opq = train_opq_chunked(gen, x, 4, 6, 2, chunk=8192)
    assert ops.launch_counts() == {"stats_f32": 6, "encode_f32": 6, "decode": 6}
    eye = torch.eye(32, device=dev)
    assert float((opq.projection.T @ opq.projection - eye).abs().max()) < 1e-4
    ops.reset_launch_counts()
    wide = train_pq_chunked(gen, x[:, :24], 2, 6, 2)  # ds = 12: the padded instance of ds = 16
    assert ops.launch_counts() == {"stats_f32_pad": 2}
    assert bool(torch.isfinite(wide.codebooks).all())


def _skewed(dev, n, m, k, ds):
    """Every row within 1e-3 of centroid ``k // 2``: a tile's rows all fall in
    one cell (one thread adds them all), every other cell stays empty."""
    cb, x = _data(dev, n, m, k, ds, seed=2)
    x = cb[:, k // 2].reshape(1, m * ds) + 1e-3 * x
    return cb, x.contiguous()


def _unreached(dev, n, m, k, ds):
    """The upper half of each codebook moved 1e3 away: cells no row reaches."""
    cb, x = _data(dev, n, m, k, ds, seed=3)
    cb[:, (k + 1) // 2:] += 1e3
    return cb, x


STRESS_SHAPES = [
    # ragged n around one tile, k = 1, k just above and four times a centroid tile
    (1, 16, 256, 8), (1023, 16, 256, 8), (1025, 16, 256, 8), (3000, 4, 1, 8), (5000, 3, 260, 8),
    (5000, 2, 1024, 8),
    # every ds the kernel takes, k no multiple of 8, and above one centroid tile
    (2049, 5, 37, 4), (2049, 3, 300, 4), (2049, 5, 37, 16), (2049, 3, 300, 16), (2049, 5, 37, 32),
    (2049, 3, 300, 32),
    # the wide route (the deep assignment, then the accumulation from its codes:
    # radix sort by code, chunks of sorted rows) at ds 36, 50, 75 and 150, k = 1,
    # 256 and 4,096 (two sort passes)
    (2049, 3, 256, 36), (2049, 3, 256, 50), (2049, 3, 256, 75), (2049, 2, 256, 150),
    (3000, 2, 1, 50), (3000, 1, 1, 150), (5000, 2, 4096, 36), (5000, 1, 4096, 75),
]


@pytest.mark.parametrize("make", [_data, _skewed, _unreached], ids=["gaussian", "skewed", "unreached"])
@pytest.mark.parametrize("compute_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n,m,k,ds", STRESS_SHAPES)
def test_stats_kernel_accumulation_under_stress(dev, n, m, k, ds, compute_dtype, make):
    cb, x = make(dev, n, m, k, ds)
    sums, counts = ops.pq_assign_stats(cb, x, compute_dtype=compute_dtype)
    again = ops.pq_assign_stats(cb, x, compute_dtype=compute_dtype)
    assert torch.equal(sums, again[0]) and torch.equal(counts, again[1])  # bit-equal launches
    assert float(counts.double().sum()) == n * m
    # The accumulation against the kernel's own assignment is exact in the
    # counts; the sums are f32 sums of the same rows in another order.
    want_sums, want_counts = ops.pq_assign_stats_reference(cb, x, compute_dtype=compute_dtype)
    moved = float((counts - want_counts).abs().sum()) / 2
    # Skewed rows sit 1e-3 from a centroid: in f32 far from any tie.  Gaussian
    # rows may flip, and so may anything at bf16's eight bits.
    f32 = compute_dtype == torch.float32
    assert moved <= (0 if make is _skewed and f32 else max(1, n * m // (1000 if f32 else 100)))
    same = (counts == want_counts)[:, :, None].expand_as(sums)
    tol = 1e-5 * want_sums.abs() + 1e-4 * float(want_sums.abs().max())
    assert bool(((sums - want_sums).abs() <= tol)[same].all())
    if make is _skewed and f32:
        assert int((counts > 0).sum()) == m and float(counts[:, k // 2].min()) == n
    if make is _unreached and k > 1:
        assert float(counts[:, (k + 1) // 2:].sum()) == 0 and float(sums[:, (k + 1) // 2:].abs().sum()) == 0


@pytest.mark.parametrize("make", [_data, _skewed, _unreached], ids=["gaussian", "skewed", "unreached"])
@pytest.mark.parametrize("n,m,k,ds", STRESS_SHAPES)
def test_stats_verify_kernel_accumulation_under_stress(dev, n, m, k, ds, make):
    cb, x = make(dev, n, m, k, ds)
    sums, counts, codes, flags = pq_assign_stats_verify_flags(cb, x)
    again = pq_assign_stats_verify_flags(cb, x)
    assert all(torch.equal(a, b) for a, b in zip((sums, counts, codes, flags), again))
    assert tuple(codes.shape) == (n, m) and codes.dtype == torch.int32
    # The kernel's statistics are those of its own codes, exactly in the counts.
    code_sums, code_counts = ops.stats.stats_from_codes(codes, x, k)
    assert torch.equal(code_counts, counts)
    tol = 1e-5 * code_sums.abs() + 1e-4 * float(code_sums.abs().max())
    assert bool(((sums - code_sums).abs() <= tol).all())
    oracle = primitives.quantize_batch(cb, x, dtype=torch.int32)
    assert not bool(((codes != oracle).any(dim=1) & (flags == 0)).any())
    got_sums, got_counts = ops.pq_assign_stats_verified(cb, x)
    assert torch.equal(got_counts, ops.stats.stats_from_codes(oracle, x, k)[1])


VERIFY_SHAPES = [
    (1, 3, 7, 4), (1000, 3, 7, 4), (4097, 16, 256, 8), (777, 2, 1000, 16), (513, 5, 300, 32),
    (70001, 1, 257, 8), (3000, 4, 1, 8),
]


def _adversarial(cb, x):
    """Rows that sit on ties and at the ends of the range: on a centroid that
    appears twice, on the midpoint of a centroid pair, zero, and scaled by
    1e-6 and 1e6.  Returns the codebooks (centroid 0 duplicated as the last
    one where k > 1) and the rows."""
    m, k, ds = cb.shape
    cb = cb.clone()
    if k > 1:
        cb[:, k - 1] = cb[:, 0]
    n = x.shape[0]
    x = x.clone().reshape(n, m, ds)
    fifth = max(1, n // 5)
    sub = torch.arange(m, device=x.device)[None, :]
    x[:fifth] = cb[:, 0][None]
    mid = x[fifth:2 * fifth]
    pick = torch.randint(0, k, (mid.shape[0], m), device=x.device)
    x[fifth:2 * fifth] = 0.5 * (cb[sub, pick] + cb[sub, (pick + 1) % k])
    x[2 * fifth:2 * fifth + fifth // 2] = 0.0
    x[3 * fifth:4 * fifth] *= 1e-6
    x[4 * fifth:] *= 1e6
    return cb, x.reshape(n, m * ds).contiguous()


@pytest.mark.parametrize("adversarial", [False, True])
@pytest.mark.parametrize("n,m,k,ds", VERIFY_SHAPES)
def test_encode_verify_kernel(dev, n, m, k, ds, adversarial):
    cb, x = _data(dev, n, m, k, ds)
    if adversarial:
        cb, x = _adversarial(cb, x)
    oracle = primitives.quantize_batch(cb, x, dtype=torch.int32)
    codes, flags = pq_encode_verify_flags(cb, x, dtype=torch.int32)
    want_codes, want_flags = ops.pq_encode_verify_reference(cb, x, dtype=torch.int32)
    # The contract of the flags: an unflagged row has the exact path's codes.
    clean = flags == 0
    assert torch.equal(codes[clean], oracle[clean])
    assert torch.equal(want_codes[want_flags == 0], oracle[want_flags == 0])
    # A flag may differ from the plain version's where the margin sits on the limit.
    assert int((flags != want_flags).sum()) <= max(2, n // 100)
    if adversarial and k > 1:
        assert int(flags[:max(1, n // 5)].min()) == 1  # rows on a duplicated centroid's twin
    for dtype in (torch.int32, torch.int16) + ((torch.uint8,) if k <= 256 else ()):
        got = ops.pq_encode_verified(cb, x, dtype=dtype)
        assert got.dtype == dtype and torch.equal(got.to(torch.int32), oracle)
    assert torch.equal(ops.pq_encode_verified(cb, x, dtype=torch.int32, cap_frac=1e-9), oracle)


@pytest.mark.parametrize("adversarial", [False, True])
@pytest.mark.parametrize("n,m,k,ds", VERIFY_SHAPES + [(300000, 2, 16, 32)])
def test_stats_verify_kernel(dev, n, m, k, ds, adversarial):
    cb, x = _data(dev, n, m, k, ds)
    if adversarial:
        cb, x = _adversarial(cb, x)
    sums, counts, codes, flags = pq_assign_stats_verify_flags(cb, x)
    again = pq_assign_stats_verify_flags(cb, x)
    # No float atomics in the kernel: two launches give the same bits.
    assert all(torch.equal(a, b) for a, b in zip((sums, counts, codes, flags), again))
    # The encode's verify kernel runs the same assignment and flag test: the same
    # codes and flags bit for bit.  Against the plain version (the same limit):
    # a code differs only on a flagged row.
    enc_codes, enc_flags = pq_encode_verify_flags(cb, x, dtype=torch.int32)
    assert torch.equal(codes, enc_codes) and torch.equal(flags, enc_flags)
    _, _, want_codes, want_flags = ops.pq_assign_stats_verify_reference(cb, x)
    assert not bool(((codes != want_codes).any(dim=1) & (flags == 0)).any())
    assert int((flags != want_flags).sum()) <= max(2, n // 100)
    if adversarial and k > 1:
        assert int(flags[:max(1, n // 5)].min()) == 1  # rows on a duplicated centroid's twin
    by_code = torch.stack([torch.bincount(codes[:, jq].long(), minlength=k) for jq in range(m)])
    assert torch.equal(by_code.to(torch.float32), counts)

    oracle = primitives.quantize_batch(cb, x, dtype=torch.int32)
    want_sums, want_counts = ops.stats.stats_from_codes(oracle, x, k)
    for cap_frac in (1 / 16, 1e-9):
        got_sums, got_counts = ops.pq_assign_stats_verified(cb, x, cap_frac=cap_frac)
        assert torch.equal(got_counts, want_counts)
        # f32 sums of the same rows in another order (and, for a moved row, a
        # subtraction of what was added).
        tol = 1e-5 * want_sums.abs() + 1e-4 * float(want_sums.abs().max())
        assert bool(((got_sums - want_sums).abs() <= tol).all())


# Row counts around the 64-row subtile and the row tile (512 rows at ds <= 8,
# 256 at ds = 16, 128 at ds = 32), k around and far above one staged centroid
# tile, every ds.
ENCODE_F32_SHAPES = (
    [(n, 16, 256, 8) for n in (1, 63, 64, 65, 255, 257, 511, 512, 513, 1023, 1025)]
    + [(300, 3, k, 8) for k in (1, 7, 300, 1000)] + [(100, 2, 65536, 8)]
    + [(n, 5, 37, 4) for n in (511, 513)] + [(n, 3, 300, 16) for n in (255, 257)]
    + [(n, 4, 256, 32) for n in (127, 129, 2000)]
    # the wide route: rows around its 128-row tile, k around its 64-centroid tile
    + [(n, 3, 50, 12) for n in (127, 129)] + [(300, 1, 65, 128), (200, 10, 128, 2)]
    # its deep kernel: rows around the 128-row tile, k around the 128-centroid
    # tile of the f32 mode, depth past the last 32-value chunk
    + [(n, 3, 50, 36) for n in (127, 129)] + [(300, 1, 129, 128), (200, 2, 255, 100)]
)


@pytest.mark.parametrize("verify", [False, True], ids=["f32", "verify"])
@pytest.mark.parametrize("n,m,k,ds", ENCODE_F32_SHAPES)
def test_encode_f32_kernel_assigns_as_the_statistics_kernel(dev, n, m, k, ds, verify):
    cb, x = _data(dev, n, m, k, ds, seed=4)
    _, _, s_codes, s_flags = pq_assign_stats_verify_flags(cb, x)
    if verify:
        codes, flags = pq_encode_verify_flags(cb, x, dtype=torch.int32)
        assert torch.equal(flags, s_flags)
        want_codes, want_flags = ops.pq_encode_verify_reference(cb, x, dtype=torch.int32)
        assert int((flags != want_flags).sum()) <= max(2, n // 100)
    else:
        codes = ops.pq_encode(cb, x, dtype=torch.int32, compute_dtype=torch.float32)
    assert codes.dtype == torch.int32 and tuple(codes.shape) == (n, m)
    assert torch.equal(codes, s_codes)
    # Against the plain version (f32 tensor operations): a code differs only on
    # a row the verified mode flags, and then by a near-tie.
    want = ops.pq_encode_reference(cb, x, dtype=torch.int32, compute_dtype=torch.float32)
    differ = (codes != want).any(dim=1)
    assert not bool((differ & (s_flags == 0)).any())
    xs = x.reshape(n, m, ds).double()
    dist = [(xs - primitives.reconstruct_batch(cb, c).reshape(n, m, ds).double()).pow(2).sum(2)
            for c in (codes, want)]
    assert bool(((dist[0] - dist[1]).abs() <= 2.0 ** -13 * dist[1] + 1e-30).all())
    # Every code type, through one kernel launch or a cast, and out= whether
    # the kernel may write into it or not.
    encode = (lambda **kw: pq_encode_verify_flags(cb, x, **kw)[0]) if verify else \
        (lambda **kw: ops.pq_encode(cb, x, compute_dtype=torch.float32, **kw))
    for dtype in (torch.int32,) + ((torch.int16,) if k <= 32768 else ()) + (
            (torch.uint8,) if k <= 256 else ()):
        got = encode(dtype=dtype)
        assert got.dtype == dtype and torch.equal(got.to(torch.int32), codes)
        if not verify:
            for out in (torch.empty((n, m), dtype=dtype, device=dev),
                        torch.empty((m, n), dtype=dtype, device=dev).T):
                assert encode(dtype=dtype, out=out) is out and torch.equal(out.to(torch.int32), codes)


# The bf16 encode and the bf16 statistics kernel run one routine
# (assign_tile.cuh's assign_rows_bf16): the encode's codes counted per cell are
# the statistics kernel's counts, bit for bit.  Rows around the 512-row tile,
# k within, at and above one staged tile of 256, every narrow ds.
@pytest.mark.parametrize("n", [1, 1023, 1025])
@pytest.mark.parametrize("k", [1, 7, 16, 256, 260])
@pytest.mark.parametrize("ds", [4, 8, 16, 32])
def test_encode_bf16_kernel_assigns_as_the_statistics_kernel(dev, ds, k, n):
    m = 3
    bf16 = torch.bfloat16
    cb, x = _data(dev, n, m, k, ds, seed=6)
    ops.reset_launch_counts()
    codes = ops.pq_encode(cb, x, dtype=torch.int32, compute_dtype=bf16)
    _, counts = ops.pq_assign_stats(cb, x, compute_dtype=bf16)
    assert ops.launch_counts() == {"encode_bf16": 1, "stats_bf16": 1}
    by_code = torch.stack([torch.bincount(codes[:, jq].long(), minlength=k) for jq in range(m)])
    assert torch.equal(by_code.to(torch.float32), counts)
    if k <= 256:
        assert torch.equal(ops.pq_encode(cb, x, compute_dtype=bf16).to(torch.int32), codes)


@pytest.mark.parametrize("k", [7, 256, 260])
@pytest.mark.parametrize("ds", [4, 8, 16, 32])
def test_encode_bf16_kernel_is_the_plain_version_where_the_products_are_exact(dev, ds, k):
    # Codebooks of small integers, every centroid twice (c and c + ceil(k/2)),
    # and rows drawn from them plus halves: every value is exact in bf16 and
    # every product and sum exact in f32 in any order, so the kernel and the
    # plain version see the same distances, and a row on a centroid ties its
    # twin: the first index must win.
    m, n = 4, 3000
    bf16 = torch.bfloat16
    gen = torch.Generator(device=dev).manual_seed(7)
    half = torch.randint(-4, 5, (m, (k + 1) // 2, ds), generator=gen, device=dev).float()
    cb = torch.cat([half, half], dim=1)[:, :k].contiguous()
    pick = torch.randint(0, k, (n, m), generator=gen, device=dev)
    x = cb[torch.arange(m, device=dev)[None, :], pick]
    x = x + 0.5 * torch.randint(-1, 2, x.shape, generator=gen, device=dev).float()
    x = x.reshape(n, m * ds).contiguous()
    want = ops.pq_encode_reference(cb, x, dtype=torch.int32, compute_dtype=bf16)
    assert int((want >= (k + 1) // 2).sum()) == 0  # a twin never wins: its first copy does
    for dtype in (torch.int32,) + ((torch.uint8,) if k <= 256 else ()):
        got = ops.pq_encode(cb, x, dtype=dtype, compute_dtype=bf16)
        assert torch.equal(got.to(torch.int32), want)
    _, counts = ops.pq_assign_stats(cb, x, compute_dtype=bf16)
    by_code = torch.stack([torch.bincount(want[:, jq].long(), minlength=k) for jq in range(m)])
    assert torch.equal(by_code.to(torch.float32), counts)


def test_the_bf16_entries_refuse_another_plan(dev):
    from reductive_tpu_torch.ops import _build
    from reductive_tpu_torch.ops.assign import _prepare, bf16_tile_plan

    n, m, k, ds = 1000, 4, 256, 8
    cb, x = _data(dev, n, m, k, ds)
    cb2, c_sqn = _prepare(cb, x, torch.int32, torch.bfloat16)
    codes = torch.empty((n, m), dtype=torch.int32, device=dev)
    partial = torch.empty((64, m, k, ds + 1), device=dev)
    sums, counts = torch.empty((m, k, ds), device=dev), torch.empty((m, k), device=dev)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    enc, st = bf16_tile_plan(n, m, k, ds, sms=sms), bf16_tile_plan(n, m, k, ds)
    stream = torch.cuda.current_stream().cuda_stream
    ptrs = (x.data_ptr(), cb2.data_ptr(), c_sqn.data_ptr())
    for rows, extra in ((enc.rows // 2, 0), (enc.rows, 16)):
        with pytest.raises(RuntimeError, match="shape not taken"):
            _build.launch("rt_encode_bf16", None, *ptrs, codes.data_ptr(), n, m, k, ds, 0, rows,
                          enc.blocks, enc.smem_bytes + extra, stream)
        with pytest.raises(RuntimeError, match="shape not taken"):
            _build.launch("rt_assign_stats_bf16", None, *ptrs, partial.data_ptr(), sums.data_ptr(),
                          counts.data_ptr(), n, m, k, ds, rows, st.blocks, st.smem_bytes + extra,
                          stream)
    # The bf16 mode at a narrow ds goes through its own entry only.
    with pytest.raises(RuntimeError, match="shape not taken"):
        _build.launch("rt_encode", None, *ptrs, codes.data_ptr(), n, m, k, ds, 1, 0, 0, stream)
    _build.launch("rt_encode_bf16", None, *ptrs, codes.data_ptr(), n, m, k, ds, 0, enc.rows,
                  enc.blocks, enc.smem_bytes, stream)
    assert torch.equal(codes, ops.pq_encode(cb, x, dtype=torch.int32, compute_dtype=torch.bfloat16))


@pytest.mark.parametrize("n,k,ds", [(1, 7, 8), (1000, 256, 8), (777, 1000, 16), (3000, 300, 4),
                                    (513, 64, 32), (1000, 300, 128), (700, 2000, 768), (513, 64, 20)])
def test_assign_nearest_is_the_one_subquantizer_encode(dev, n, k, ds):
    cb, x = _data(dev, n, 1, k, ds, seed=5)
    got = ops.assign_nearest(cb[0], x, compute_dtype=torch.float32)
    assert got.dtype == torch.int32 and tuple(got.shape) == (n,)
    _, counts, s_codes, s_flags = pq_assign_stats_verify_flags(cb, x)
    assert torch.equal(got, s_codes[:, 0])
    assert torch.equal(torch.bincount(got.long(), minlength=k).to(torch.float32), counts[0])
    want = ops.pq_encode_reference(cb, x, dtype=torch.int32, compute_dtype=torch.float32)[:, 0]
    assert not bool(((got != want) & (s_flags == 0)).any())


@pytest.mark.parametrize("splits", [1, 2, 3, "int8"])
@pytest.mark.parametrize("n,m,k,ds", [(1000, 2, 16, 4), (4097, 16, 16, 8), (513, 6, 7, 32),
                                      (999, 24, 16, 32), (1000, 10, 16, 2), (333, 4, 7, 3)])
def test_packed_decode_kernel(dev, n, m, k, ds, splits):
    cb, _ = _data(dev, n, m, k, ds)
    codes = torch.randint(0, k, (n, m), device=dev, dtype=torch.uint8)
    packed = ops.pack_u4_codes(codes)
    got = ops.pq_decode(cb, packed, splits=splits, packed=True)
    assert torch.equal(got, ops.pq_decode(cb, codes, splits=splits))
    assert torch.equal(got, ops.pq_decode_reference(cb, packed, splits=splits, packed=True))
    assert torch.equal(ops.pq_decode(cb, packed.to(torch.int32), splits=splits, packed=True), got)
    out = torch.empty_like(got)
    assert ops.pq_decode(cb, packed, splits=splits, packed=True, out=out) is out
    assert torch.equal(out, got)


@pytest.mark.parametrize("splits", [1, 2, 3, "int8"])
@pytest.mark.parametrize("n,m,k,nq", [(1000, 2, 16, 5), (4097, 16, 16, 16), (999, 6, 7, 9),
                                      (2000, 24, 16, 130), (777, 10, 16, 3),
                                      # One query, 130, rows a 16-byte load (m = 32), an
                                      # odd number of bytes a row (m = 30), no copies (m = 114).
                                      (1025, 16, 16, 1), (70001, 16, 16, 130), (4000, 32, 16, 16),
                                      (3001, 30, 16, 33), (500, 114, 16, 20)])
def test_packed_adc_kernel(dev, n, m, k, nq, splits):
    gen = torch.Generator(device=dev).manual_seed(1)
    tables = torch.randn((nq, m, k), generator=gen, device=dev) * 10
    codes = torch.randint(0, k, (n, m), device=dev, dtype=torch.uint8)
    packed = ops.pack_u4_codes(codes)
    got = ops.adc_scores_kernel(tables, packed, splits=splits, packed=True)
    assert torch.equal(got, ops.adc_scores_kernel(tables, codes, splits=splits))
    assert torch.equal(got, ops.adc_scores_reference(tables, packed, splits=splits, packed=True))
    # A view that starts off a 4-byte boundary takes the scalar route.
    assert torch.equal(
        ops.adc_scores_kernel(tables, packed[1:], splits=splits, packed=True), got[:, 1:])


@pytest.mark.parametrize("offset", [1, 4, 8])
@pytest.mark.parametrize("m", [16, 24])
def test_adc_kernel_on_codes_off_a_word(dev, m, offset):
    # A view that starts off 16 bytes takes 4-byte loads (offset 4, 8) or
    # bytes (offset 1); the skewed walk only on whole words.
    n, nq, k = 3001, 16, 256
    gen = torch.Generator(device=dev).manual_seed(2)
    tables = torch.randn((nq, m, k), generator=gen, device=dev)
    flat = torch.randint(0, k, (n * m + offset,), generator=gen, device=dev).to(torch.uint8)
    codes = flat[offset:].view(n, m)
    for splits in (1, 2, 3):
        got = ops.adc_scores_kernel(tables, codes, splits=splits)
        assert torch.equal(got, ops.adc_scores_reference(tables, codes, splits=splits))
        assert torch.equal(got, ops.adc_scores_kernel(tables, codes.clone(), splits=splits))


@pytest.mark.parametrize("packed", [False, True])
def test_adc_kernel_takes_no_rows(dev, packed):
    tables = torch.randn((3, 4, 16), device=dev)
    codes = torch.zeros((0, 2 if packed else 4), dtype=torch.uint8, device=dev)
    got = ops.adc_scores_kernel(tables, codes, packed=packed)
    assert got.shape == (3, 0) and got.dtype == torch.float32


# -- the int8 ADC kernel (adc_i8_kernel) and the tables built on the card -----------


def _int8_tables(dev, nq, m, k, seed, kind="gauss"):
    """Tables of queries: Gaussian (l2-like, scaled), negative (dot-like),
    constant (every entry of a query equal: the 1e-30 scale), or halfway
    (entries on the midpoints of the int8 levels of their query)."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    t = torch.randn((nq, m, k), generator=gen, device=dev) * 10
    if kind == "negative":
        t = -t.abs() - 3.0
    elif kind == "constant":
        t = torch.full((nq, m, k), 2.5, device=dev)
    elif kind == "halfway":
        # Every table spans [0, 255]: the scale is 1 (255 * f32(1/255) rounds
        # to 1), and entries at i + 0.5 round half to even.
        levels = torch.randint(0, 255, (nq, m, k), generator=gen, device=dev).float()
        t = levels + 0.5
        t[:, :, 0], t[:, :, -1] = 0.0, 255.0
    return t


_INT8_SHAPES = [(4097, 16, 256, 1), (4097, 16, 256, 3), (4097, 16, 256, 17), (3001, 16, 256, 130),
                (70001, 16, 16, 16), (2500, 24, 256, 16), (2500, 12, 256, 33), (999, 18, 256, 9),
                (999, 31, 256, 20), (777, 7, 255, 5), (500, 300, 4, 5), (500, 300, 16, 16),
                (333, 10, 16, 130), (65, 36, 200, 32), (3, 5, 16, 33)]


@pytest.mark.parametrize("n,m,k,nq,codes_as", [
    (*shape, codes_as) for shape in _INT8_SHAPES for codes_as in ("uint8", "int32", "packed")
    if codes_as != "packed" or (shape[2] <= 16 and shape[1] % 2 == 0)])
def test_adc_int8_kernel_is_the_plain_version_bit_for_bit(dev, n, m, k, nq, codes_as):
    # Every plan of ops.adc.adc_int8_plan: four queries a block (one and three
    # queries) and 16 and 32 with each entry once (k = 256, 200), copies at 8
    # to 32 queries a block (k <= 16; k = 255 at m = 7), m past 256 (the
    # flush), k below 256 with codes at k - 1, rows that end mid-block; packed
    # codes where k <= 16 and m is even.
    tables = _int8_tables(dev, nq, m, k, n + m)
    gen = torch.Generator(device=dev).manual_seed(n)
    codes = torch.randint(0, k, (n, m), generator=gen, device=dev, dtype=torch.int32)
    codes[::7, ::3] = k - 1
    packed = codes_as == "packed"
    given = (ops.pack_u4_codes(codes.to(torch.uint8)) if packed
             else codes if codes_as == "int32" else codes.to(torch.uint8))
    ops.reset_launch_counts()
    got = ops.adc_scores_kernel(tables, given, splits="int8", packed=packed)
    assert ops.launch_counts() == {("adc_int8_u4" if packed else "adc_int8"): 1}
    want = ops.adc_scores_reference(tables, given, splits="int8", packed=packed)
    assert _same_bits(got, want)


@pytest.mark.parametrize("offset", [1, 4, 16])
@pytest.mark.parametrize("m,nq", [(16, 16), (24, 16), (16, 128), (8, 40)])
def test_adc_int8_kernel_on_codes_off_a_word(dev, m, nq, offset):
    n, k = 3001, 256
    tables = _int8_tables(dev, nq, m, k, m + nq)
    gen = torch.Generator(device=dev).manual_seed(offset)
    flat = torch.randint(0, k, (n * m + offset,), generator=gen, device=dev).to(torch.uint8)
    codes = flat[offset:].view(n, m)
    got = ops.adc_scores_kernel(tables, codes, splits="int8")
    assert _same_bits(got, ops.adc_scores_reference(tables, codes, splits="int8"))
    assert _same_bits(got, ops.adc_scores_kernel(tables, codes.clone(), splits="int8"))


@pytest.mark.parametrize("n,m,k,nq,codes_as", [
    (4097, 16, 256, 16, "uint8"), (2500, 24, 256, 16, "uint8"), (999, 18, 256, 9, "uint8"),
    (3001, 16, 256, 40, "uint8"), (3001, 12, 256, 33, "uint8"), (999, 16, 256, 17, "int32"),
    (500, 300, 16, 16, "uint8"), (777, 16, 200, 16, "off4"), (777, 16, 256, 16, "off1"),
    (4097, 16, 16, 16, "packed")])
def test_the_int8_kernel_under_every_plan_it_takes(dev, n, m, k, nq, codes_as):
    # The C entry under each plan it takes, not only the one adc_int8_plan
    # chooses: 1 to 32 queries a block, each entry once and (4 queries or
    # more) 128 / QT copies where they fit, 512 and 1,024 threads; views off
    # a word, int32 and packed codes, the flush past m = 256, codes at k - 1.
    from reductive_tpu_torch.ops import adc as adc_mod
    tables = _int8_tables(dev, nq, m, k, n + k)
    gen = torch.Generator(device=dev).manual_seed(m)
    off = {"off4": 4, "off1": 1}.get(codes_as, 0)
    flat = torch.randint(0, k, (n * m + off,), generator=gen, device=dev, dtype=torch.int32)
    flat[::11] = k - 1
    if codes_as == "int32":
        codes = flat.view(n, m)
    else:
        codes = flat.to(torch.uint8)[off:].view(n, m)
    packed = codes_as == "packed"
    given = ops.pack_u4_codes(codes) if packed else codes
    want = ops.adc_scores_reference(tables, given, splits="int8", packed=packed)
    held = adc_mod.adc_table_int8(tables)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    taken = 0
    for qt in (1, 2, 4, 8, 16, 32):
        for r in sorted({1, 128 // qt if qt >= 4 else 1}):
            smem = adc_mod._int8_smem(qt, r, m, k)
            if smem > adc_mod._SMEM_BYTES:
                continue
            plan = adc_mod._grid_plan(n, nq, qt, r, False, 32 // max(1, qt // 16), smem, sms)
            for threads in (512, 1024):
                out = torch.full((nq, n), float("nan"), device=dev)
                adc_mod.adc_launcher(held, given, out, packed=packed, counted=False,
                                     plan=plan._replace(threads=threads))()
                assert _same_bits(out, want), (qt, r, threads)
                taken += 1
    assert taken >= 12


@pytest.mark.parametrize("kind", ["gauss", "negative", "constant", "halfway"])
@pytest.mark.parametrize("nq,m,k", [(1, 16, 256), (17, 16, 16), (130, 24, 256), (3, 300, 4),
                                    (5, 7, 255), (2, 1, 1)])
def test_the_int8_adc_tables_are_the_quantizers_bit_for_bit(dev, nq, m, k, kind):
    from reductive_tpu_torch.ops.adc import adc_table_int8, quantize_tables_int8
    tables = _int8_tables(dev, nq, m, k, nq + m + k, kind)
    got = adc_table_int8(tables)
    want = quantize_tables_int8(tables)
    assert torch.equal(got[0], want[0]) and _same_bits(got[1], want[1]) and _same_bits(got[2], want[2])
    cpu = quantize_tables_int8(tables.cpu())
    assert torch.equal(got[0].cpu(), cpu[0]) and _same_bits(got[1].cpu(), cpu[1])
    assert _same_bits(got[2].cpu(), cpu[2])


@pytest.mark.parametrize("splits", [1, 2, 3])
@pytest.mark.parametrize("nq,m,k", [(16, 16, 256), (130, 24, 16), (1, 3, 7)])
def test_the_f32_adc_table_is_the_effective_codebook_bit_for_bit(dev, nq, m, k, splits):
    # The f32 ADC wrapper builds its table by decode's one launch.
    from reductive_tpu_torch.ops.decode import decode_table, effective_codebook
    tables = _float_patterns(dev, nq * m * k, nq + m, finite=True).reshape(nq, m, k)
    got = decode_table(tables.reshape(nq, m * k, 1), splits)[0].view(nq, m, k)
    assert _same_bits(got, effective_codebook(tables, splits))


@pytest.mark.parametrize("packed", [False, True])
def test_the_streamed_int8_search_is_the_dense_one(dev, packed):
    from reductive_tpu_torch import Pq
    from reductive_tpu_torch.search import search
    gen = torch.Generator(device=dev).manual_seed(9)
    m, k, ds, n = 16, 16 if packed else 256, 8, 200_000
    pq = Pq(codebooks=torch.randn((m, k, ds), generator=gen, device=dev))
    codes = torch.randint(0, k, (n, m), generator=gen, device=dev, dtype=torch.uint8)
    given = ops.pack_u4_codes(codes) if packed else codes
    q = torch.randn((20, m * ds), generator=gen, device=dev)
    d0, i0 = search(pq, q, given, 10, method="kernel", splits="int8", packed=packed)
    d1, i1 = search(pq, q, given, 10, method="kernel", splits="int8", packed=packed,
                    stream_chunk=30_000)
    assert torch.equal(i1, i0) and _same_bits(d1, d0)


# -- decode: the row-tile kernel, its tables, and views off 16 bytes ------------------


def _float_patterns(dev, size, seed, finite=False):
    """f32 values of every kind of bit pattern: random bits (subnormals, huge
    and tiny values, NaN and inf unless ``finite``), and +-0, +-FLT_MAX, the
    largest and smallest subnormals, values a bf16 rounding tie away from
    their neighbours."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    bits = torch.randint(-(1 << 31), 1 << 31, (size,), generator=gen, device=dev,
                         dtype=torch.int64).to(torch.int32)
    special = torch.tensor([0, -(1 << 31), 0x7F7FFFFF, -0x00800001, 0x007FFFFF, 1, -0x7FFFFFFF,
                            0x3F808000, 0x3F818000, -0x407F8000, 0x7F7F8000, 0x00008000],
                           dtype=torch.int32, device=dev)
    bits[:special.numel()] = special
    v = bits.view(torch.float32)
    if finite:
        v = torch.where(torch.isfinite(v), v, torch.zeros_like(v))
    return v


def _same_bits(a, b):
    """Equal bit for bit, NaN against NaN whatever its payload."""
    return bool(((a.view(torch.int32) == b.view(torch.int32)) | (a.isnan() & b.isnan())).all())


@pytest.mark.parametrize("splits", [1, 2, 3])
def test_the_decode_table_is_the_effective_codebook_bit_for_bit(dev, splits):
    from reductive_tpu_torch.ops.decode import decode_table, effective_codebook
    cb = _float_patterns(dev, 7 * 300 * 5, splits).reshape(7, 300, 5)
    (table,) = decode_table(cb, splits)
    assert _same_bits(table, effective_codebook(cb, splits))
    assert _same_bits(table.cpu(), effective_codebook(cb.cpu(), splits))


@pytest.mark.parametrize("m,k,ds", [(7, 300, 5), (1, 16384, 3), (2, 5, 70), (10, 128, 2)])
def test_the_int8_decode_table_is_the_quantizers_bit_for_bit(dev, m, k, ds):
    from reductive_tpu_torch.ops.decode import decode_table, quantize_codebook_int8
    cb = _float_patterns(dev, m * k * ds, m + ds, finite=True).reshape(m, k, ds)
    cb[0, :, 0] = 0.0  # a column of zeros: its scale is 0, its divisor 1e-30
    cb[-1, :, -1] *= 1e-38  # a column of subnormals and zeros
    w8, scale = decode_table(cb, "int8")
    w8_want, scale_want = quantize_codebook_int8(cb)
    assert torch.equal(w8, w8_want) and _same_bits(scale, scale_want)


@pytest.mark.parametrize("splits", [3, "int8"])
@pytest.mark.parametrize("ds", [2, 3, 8])
def test_decode_into_an_out_off_16_bytes(dev, ds, splits):
    from reductive_tpu_torch import Pq
    from reductive_tpu_torch.pq.model import reconstruct_batch_into
    n, m, k = 1001, 10, 128
    cb, _ = _data(dev, n, m, k, ds)
    codes = torch.randint(0, k, (n, m), device=dev, dtype=torch.uint8)
    want = ops.pq_decode(cb, codes, splits=splits)
    for off in (1, 2, 3):
        flat = torch.full((n * m * ds + 4,), -1.0, device=dev)
        out = flat[off:off + n * m * ds].view(n, m * ds)
        assert out.is_contiguous() and out.data_ptr() % 16 == 4 * off
        assert ops.pq_decode(cb, codes, splits=splits, out=out) is out
        assert torch.equal(out, want)
        assert bool((flat[:off] == -1).all()) and bool((flat[off + n * m * ds:] == -1).all())
    if splits == 3:
        out = torch.empty((n * m * ds + 1,), device=dev)[1:].view(n, m * ds)
        assert reconstruct_batch_into(Pq(codebooks=cb), codes, out, method="kernel") is out
        assert torch.equal(out, want)
    torch.cuda.synchronize()


@pytest.mark.parametrize("packed", [False, True])
@pytest.mark.parametrize("ds", [2, 3, 8])
def test_decode_codes_that_start_mid_tensor(dev, ds, packed):
    n, m, k = 3001, 10, 16
    cb, _ = _data(dev, n, m, k, ds)
    codes = torch.randint(0, k, (n + 7, m), device=dev, dtype=torch.uint8)
    if packed:
        codes = ops.pack_u4_codes(codes)
    for start in (1, 3, 4, 7):
        part = codes[start:start + n]
        want = ops.pq_decode_reference(cb, part, splits=3, packed=packed)
        assert torch.equal(ops.pq_decode(cb, part, splits=3, packed=packed), want)
        assert torch.equal(ops.pq_decode(cb, part, splits="int8", packed=packed),
                           ops.pq_decode_reference(cb, part, splits="int8", packed=packed))


@pytest.mark.parametrize("regime", ["plan", "wide_budget", "l2"])
@pytest.mark.parametrize("splits", [3, "int8"])
@pytest.mark.parametrize("code_dtype", [torch.uint8, torch.int32])
@pytest.mark.parametrize("m", [150, 30, 10])
def test_decode_at_300_dimensions_in_every_table_regime(dev, m, code_dtype, splits, regime,
                                                        monkeypatch):
    from reductive_tpu_torch.ops import decode
    if regime != "plan":
        budget = 0 if regime == "l2" else 200 * 1024
        monkeypatch.setattr(decode, "_TILE_SHARED_BYTES", {False: budget, True: budget})
    n, k, ds = 20001, 256, 300 // m
    cb, _ = _data(dev, n, m, k, ds)
    codes = torch.randint(0, k, (n, m), device=dev).to(code_dtype)
    codes[::97, 3] = k - 1
    _, group = decode.decode_tile_plan(m, k, ds, codes.element_size(), False, splits == "int8")
    if regime == "l2":
        assert group == 0
    elif regime == "wide_budget" and splits == "int8":
        assert group == m  # the whole table, 78 KB, in shared memory
    else:
        assert 0 < group < m  # a block stages a group of subquantizers
    ops.reset_launch_counts()
    got = ops.pq_decode(cb, codes, splits=splits)
    name = "decode_int8" if splits == "int8" else "decode"
    assert ops.launch_counts() == {name + ("" if ds % 4 == 0 else "_scalar"): 1}
    assert torch.equal(got, ops.pq_decode_reference(cb, codes, splits=splits))


@pytest.mark.parametrize("splits", [3, "int8"])
@pytest.mark.parametrize("codes_as", ["uint8", "int32", "packed"])
@pytest.mark.parametrize("n,m,k,ds", [(1000, 10, 16, 2), (513, 6, 7, 3), (257, 2, 16, 1),
                                      (2000, 4, 16, 5), (999, 30, 16, 10), (77, 2, 3, 7)])
def test_every_row_tile_plan_gives_the_same_bits(dev, n, m, k, ds, codes_as, splits):
    # Tiles of 1, 7, 16 and 64 rows (their codes start off 16 bytes unless the
    # row's bytes keep them on it), the table whole, a group of subquantizers a
    # block, or read from L2; into an out off 16 bytes.
    from reductive_tpu_torch.ops.decode import decode_table, launch_decode
    cb, _ = _data(dev, n, m, k, ds)
    codes = torch.randint(0, k, (n, m), device=dev, dtype=torch.uint8)
    want = ops.pq_decode_reference(cb, codes, splits=splits)
    if codes_as == "packed":
        codes = ops.pack_u4_codes(codes)
    elif codes_as == "int32":
        codes = codes.to(torch.int32)
    table = decode_table(cb, splits)
    flat = torch.empty((n * m * ds + 1,), device=dev)
    for rows in (1, 7, 16, 64):
        for group in (m, 1, max(1, m // 3), 0):
            for out in (flat[:-1].view(n, m * ds), flat[1:].view(n, m * ds)):
                out.fill_(-1.0)
                launch_decode(table, codes, out, packed=codes_as == "packed", plan=(rows, group))
                assert torch.equal(out, want), (rows, group, out.data_ptr() % 16)


def test_smallest_keeps_the_lowest_positions_among_ties_at_the_kth_place(dev):
    from reductive_tpu_torch import search as tsearch
    gen = torch.Generator(device=dev).manual_seed(5)
    for nq, n, levels, k in ((16, 4_000_000, 1000, 10), (4, 300_001, 3, 40), (3, 5000, 2, 7),
                             (2, 2048, 5, 10), (5, 1 << 20, 100_000, 100)):
        scores = torch.randint(0, levels, (nq, n), generator=gen, device=dev).to(torch.float32)
        vals, ids = tsearch._smallest(scores, None, k)
        want_vals, want_ids = torch.sort(scores, dim=1, stable=True)
        assert torch.equal(ids, want_ids[:, :k]) and torch.equal(vals, want_vals[:, :k])


@pytest.mark.parametrize("stream_chunk", [None, 1 << 16])
def test_search_keeps_the_lowest_ids_among_ties_at_the_kth_place(dev, stream_chunk):
    from reductive_tpu_torch import Pq
    from reductive_tpu_torch.search import adc_tables, search
    gen = torch.Generator(device=dev).manual_seed(6)
    m, k, ds, n = 16, 256, 8, 300_000
    pq = Pq(codebooks=torch.randn((m, k, ds), generator=gen, device=dev))
    distinct = torch.randint(0, k, (4096, m), generator=gen, device=dev, dtype=torch.uint8)
    # Every code is held by about 73 rows: a query's k-th place is a tie.
    codes = distinct[torch.randint(0, 4096, (n,), generator=gen, device=dev)]
    q = torch.randn((16, m * ds), generator=gen, device=dev)
    scores = ops.adc_scores_kernel(adc_tables(pq, q), codes, splits=2)
    want = torch.sort(scores, dim=1, stable=True).indices[:, :10]
    _, ids = search(pq, q, codes, 10, stream_chunk=stream_chunk)
    assert torch.equal(ids, want)


def test_verified_and_packed_feed_the_entry_points(dev):
    from reductive_tpu_torch import Pq, train_opq_chunked, train_pq_chunked
    from reductive_tpu_torch.search import search

    gen = torch.Generator(device=dev).manual_seed(0)
    x = torch.rand((20000, 32), generator=gen, device=dev)
    ops.reset_launch_counts()
    state = gen.get_state()
    a = train_pq_chunked(gen, x, 4, 4, 5, compute_dtype="verified")
    assert ops.launch_counts() == {"stats_verify": 5}
    gen.set_state(state)
    plain = train_pq_chunked(gen, x, 4, 4, 5, use_kernel=False)
    assert float((a.codebooks - plain.codebooks).abs().max()) < 1e-4
    ops.reset_launch_counts()
    train_opq_chunked(gen, x, 4, 4, 2, chunk=8192, compute_dtype="verified")
    assert ops.launch_counts() == {"stats_verify": 6, "encode_verify": 6, "decode": 6}

    pq = Pq(codebooks=a.codebooks)
    codes = pq.quantize_batch(x, method="kernel-f32")
    packed = ops.pack_u4_codes(codes)
    ops.reset_launch_counts()
    for kwargs in ({}, {"stream_chunk": 4096}, {"splits": "int8"}, {"refine_with": x}):
        d1, i1 = search(pq, x[:9], packed, 5, packed=True, **kwargs)
        d0, i0 = search(pq, x[:9], codes, 5, method="kernel", **kwargs)
        assert torch.equal(d1, d0) and torch.equal(i1, i0)
    counts = ops.launch_counts()
    assert counts["adc_u4"] == counts["adc"] == 7 and counts["adc_int8_u4"] == 1
    with pytest.raises(ValueError, match='require method="kernel"'):
        search(pq, x[:9], packed, 5, packed=True, method="einsum")


def test_kernels_refuse_what_they_do_not_take(dev):
    # Every ds is taken; k above 65,536 and codebooks of another dtype are not.
    cb, x = _data(dev, 10, 1, 70000, 5)
    with pytest.raises(ValueError, match="encode kernel takes"):
        ops.pq_encode(cb, x, dtype=torch.int32)
    with pytest.raises(ValueError, match="use_kernel=False"):
        ops.pq_assign_stats(cb, x)
    with pytest.raises(ValueError, match="encode kernel takes"):
        ops.pq_encode_verified(cb, x, dtype=torch.int32)
    with pytest.raises(ValueError, match="use_kernel=False"):
        ops.pq_assign_stats_verified(cb, x)
    with pytest.raises(ValueError, match="decode kernel takes"):
        ops.pq_decode(cb[:, :4].double(), torch.zeros((10, 1), dtype=torch.uint8, device=dev))
    with pytest.raises(ValueError, match="no shared-memory tiling"):
        ops.adc_scores_kernel(torch.zeros((1, 1, 70000), device=dev),
                              torch.zeros((4, 1), dtype=torch.int32, device=dev))


# -- the wide route ------------------------------------------------------------------

# One shape per width: ragged n, k around the 64-centroid tile and above it,
# m = 1 at the k-means widths.  From ds = 36 on the deep kernel: k around its
# 128- (f32) and 256-centroid (bf16) tiles and at 65,536, n around its
# 128-row tile, and depths whose last chunk TMA fills with zeros past ds
# with m > 1 (36, 40, 68, 100).
WIDE_SHAPES = [
    (3000, 5, 37, 1), (4097, 10, 128, 2), (1000, 3, 300, 3), (2049, 8, 256, 12), (1025, 2, 65, 20),
    (777, 16, 256, 48), (513, 1, 1000, 64), (3000, 1, 4096, 128), (700, 1, 2000, 768),
    (129, 3, 127, 36), (128, 2, 128, 40), (127, 4, 129, 100), (1000, 2, 255, 64),
    (300, 1, 256, 128), (257, 3, 257, 68), (200, 1, 65536, 96),
    # d = m ds not a multiple of 4: the deep kernel's rows by cp.async.
    (1000, 1, 4096, 50), (777, 3, 100, 37), (500, 3, 256, 50), (300, 1, 1000, 75),
]


def _with_cell_stats(counts):
    """``counts`` and the launches of ``cell_stats``: every wide statistics
    launch runs the accumulation from its codes in its C entry."""
    wide = sum(v for name, v in counts.items()
               if name.startswith("stats_") and name.endswith(("_wide", "_shallow")))
    return {**counts, "cell_stats": wide} if wide else counts


def _suffix(ds):
    """The counters' suffix at width ds: the narrow kernels' padded instance
    up to 32, the wide route above."""
    return "_pad" if ds <= 32 else "_wide"


def _chosen_dist(cb, x, codes):
    n = x.shape[0]
    m, _, ds = cb.shape
    xs = x.reshape(n, m, ds).double()
    return (xs - primitives.reconstruct_batch(cb, codes).reshape(n, m, ds).double()).pow(2).sum(2)


@pytest.mark.parametrize("compute_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n,m,k,ds", WIDE_SHAPES)
def test_wide_encode_kernel_equals_plain(dev, n, m, k, ds, compute_dtype):
    cb, x = _data(dev, n, m, k, ds, seed=6)
    f32 = compute_dtype == torch.float32
    ops.reset_launch_counts()
    got = ops.pq_encode(cb, x, dtype=torch.int32, compute_dtype=compute_dtype)
    assert ops.launch_counts() == {("encode_f32" if f32 else "encode_bf16") + _suffix(ds): 1}
    assert got.dtype == torch.int32 and tuple(got.shape) == (n, m)
    assert int(got.min()) >= 0 and int(got.max()) < k
    want = ops.pq_encode_reference(cb, x, dtype=torch.int32, compute_dtype=compute_dtype)
    differ = got != want
    if f32:
        # The statistics kernel's codes bit for bit; a code off the plain
        # version's only on a row the verified mode flags.
        _, _, s_codes, s_flags = pq_assign_stats_verify_flags(cb, x)
        assert torch.equal(got, s_codes)
        assert not bool((differ.any(dim=1) & (s_flags == 0)).any())
    else:
        assert int(differ.sum()) <= max(2, got.numel() // 100)
    # Where the codes differ, a near-tie: within 2^-13 (f32) or 2^-7 (bf16) of
    # |x_j| max|2c_j| + max|c_j|^2, the scale of the products' rounding (at
    # ds = 1 or 2 a distance is far smaller than that).
    dg, dw = _chosen_dist(cb, x, got), _chosen_dist(cb, x, want)
    cn = cb.double().pow(2).sum(dim=2).sqrt().amax(dim=1)
    xn = x.reshape(n, m, ds).double().pow(2).sum(dim=2).sqrt()
    rel = 2.0 ** -13 if f32 else 2.0 ** -7
    assert bool(((dg - dw).abs() <= rel * (2 * xn * cn[None] + cn[None] ** 2)).all())
    if k <= 256:
        u8 = ops.pq_encode(cb, x, compute_dtype=compute_dtype)
        assert u8.dtype == torch.uint8 and torch.equal(u8.to(torch.int32), got)


@pytest.mark.parametrize("compute_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n,m,k,ds", WIDE_SHAPES)
def test_wide_stats_kernel_equals_plain_and_itself(dev, n, m, k, ds, compute_dtype):
    cb, x = _data(dev, n, m, k, ds, seed=7)
    f32 = compute_dtype == torch.float32
    ops.reset_launch_counts()
    sums, counts = ops.pq_assign_stats(cb, x, compute_dtype=compute_dtype)
    again = ops.pq_assign_stats(cb, x, compute_dtype=compute_dtype)
    assert ops.launch_counts() == _with_cell_stats({("stats_f32" if f32 else "stats_bf16") + _suffix(ds): 2})
    # No float atomics: two launches give the same bits.
    assert torch.equal(sums, again[0]) and torch.equal(counts, again[1])
    assert float(counts.double().sum()) == n * m
    # The cells are the encode's (one routine), and the sums those of its codes
    # (of the bf16-rounded rows in bf16 mode), added in another order.
    codes = ops.pq_encode(cb, x, dtype=torch.int32, compute_dtype=compute_dtype)
    xr = x if f32 else x.to(torch.bfloat16).to(torch.float32)
    code_sums, code_counts = ops.stats.stats_from_codes(codes, xr, k)
    assert torch.equal(code_counts, counts)
    tol = 1e-5 * code_sums.abs() + 1e-4 * float(code_sums.abs().max())
    assert bool(((sums - code_sums).abs() <= tol).all())
    # Against the plain version: near-ties may move a row (one in a thousand,
    # f32; one in a hundred, bf16).
    want_sums, want_counts = ops.pq_assign_stats_reference(cb, x, compute_dtype=compute_dtype)
    moved = float((counts - want_counts).abs().sum()) / 2
    assert moved <= max(1, n * m // (1000 if f32 else 100))


@pytest.mark.parametrize("adversarial", [False, True])
@pytest.mark.parametrize("n,m,k,ds", WIDE_SHAPES)
def test_wide_verify_kernels(dev, n, m, k, ds, adversarial):
    cb, x = _data(dev, n, m, k, ds, seed=8)
    if adversarial:
        cb, x = _adversarial(cb, x)
    ops.reset_launch_counts()
    sums, counts, codes, flags = pq_assign_stats_verify_flags(cb, x)
    again = pq_assign_stats_verify_flags(cb, x)
    assert all(torch.equal(a, b) for a, b in zip((sums, counts, codes, flags), again))
    enc_codes, enc_flags = pq_encode_verify_flags(cb, x, dtype=torch.int32)
    assert ops.launch_counts() == _with_cell_stats({"stats_verify" + _suffix(ds): 2,
                                                    "encode_verify" + _suffix(ds): 1})
    assert torch.equal(codes, enc_codes) and torch.equal(flags, enc_flags)
    oracle = primitives.quantize_batch(cb, x, dtype=torch.int32)
    assert not bool(((codes != oracle).any(dim=1) & (flags == 0)).any())
    _, want_flags = ops.pq_encode_verify_reference(cb, x, dtype=torch.int32)
    assert int((flags != want_flags).sum()) <= max(2, n // 100)
    if adversarial and k > 1:
        assert int(flags[:max(1, n // 5)].min()) == 1  # rows on a duplicated centroid's twin
    assert torch.equal(ops.pq_encode_verified(cb, x, dtype=torch.int32), oracle)
    want_sums, want_counts = ops.stats.stats_from_codes(oracle, x, k)
    for cap_frac in (1 / 16, 1e-9):
        got_sums, got_counts = ops.pq_assign_stats_verified(cb, x, cap_frac=cap_frac)
        assert torch.equal(got_counts, want_counts)
        tol = 1e-5 * want_sums.abs() + 1e-4 * float(want_sums.abs().max())
        assert bool(((got_sums - want_sums).abs() <= tol).all())


# Widths above 32 with d = m ds a multiple of 4 (the deep kernel's TMA rows)
# and not (its cp.async rows: 33 at m = 1, 37 at m = 2, 50 at m = 3 and 1, ...).
DEEP_WIDTHS = [(33, 4), (33, 1), (36, 3), (37, 2), (50, 6), (50, 3), (50, 1), (75, 4), (75, 1),
               (128, 1), (150, 2), (150, 1), (301, 4), (301, 1), (768, 1)]


def _off(x, off):
    """A copy of ``x`` whose first element lies ``off`` floats past 16 bytes."""
    n, d = x.shape
    view = torch.empty((n * d + 4,), device=x.device)[off:off + n * d].view(n, d)
    view.copy_(x)
    assert view.is_contiguous() and view.data_ptr() % 16 == 4 * off
    return view


@pytest.mark.parametrize("off", [0, 1, 2, 3])
@pytest.mark.parametrize("k", [1, 8, 256, 1000, 4096])
@pytest.mark.parametrize("ds,m", DEEP_WIDTHS)
def test_the_deep_kernel_assigns_as_the_shallow_one(dev, ds, m, k, off, monkeypatch):
    # Every width above 32 and every x on 4 bytes take the deep kernel; the
    # shallow one, forced, runs the same arithmetic, so the codes, flags and
    # counts are the same bits in every mode, and so are the sums (the same
    # codes, sorted and added alike).
    n = 1500 if k < 4096 else 600
    cb, x = _data(dev, n, m, k, ds, seed=11)
    x = _off(x, off)
    ops.reset_launch_counts()
    deep = _all_modes(cb, x)
    assert ops.launch_counts() == _with_cell_stats({name + "_wide": 1 for name in deep})
    _forced_shallow(monkeypatch)
    ops.reset_launch_counts()
    shallow = _all_modes(cb, x)
    assert ops.launch_counts() == _with_cell_stats({name + "_shallow": 1 for name in shallow})
    for name in ("encode_f32", "encode_bf16"):
        assert torch.equal(deep[name], shallow[name]), (name, int((deep[name] != shallow[name]).sum()))
    for name in ("encode_verify", "stats_f32", "stats_bf16", "stats_verify"):
        for i, (a, b) in enumerate(zip(deep[name], shallow[name])):
            assert torch.equal(a, b), (name, i)
    if k == 1:
        assert int(deep["encode_f32"].max()) == 0


@pytest.mark.parametrize("off", [0, 1])
@pytest.mark.parametrize("ds,m", [(50, 3), (50, 2), (75, 4), (37, 2)])
def test_a_non_finite_neighbour_leaves_the_code_alone(dev, ds, m, off):
    # A box of the deep kernel's rows holds 32 (64 in bf16) values from its
    # chunk's start, so past ds it holds subvector j + 1's.  inf or NaN there
    # times the codebook's zero padding would be NaN and could move code j:
    # the kernel reads those columns as zero.  Subvector 1 holds inf, -inf and
    # NaN; every other subvector's code is the one the same rows get with
    # subvector 1 zeroed, bit for bit, in every mode, and that code is the
    # plain version's but on flagged rows (f32) and near-ties (bf16).
    n, k = 1200, 256
    cb, x = _data(dev, n, m, k, ds, seed=15)
    finite = x.clone().reshape(n, m, ds)
    finite[:, 1] = 0.0
    bad = x.clone().reshape(n, m, ds)
    bad[:n // 3, 1] = float("inf")
    bad[n // 3:2 * n // 3, 1] = float("nan")
    bad[2 * n // 3:, 1, ::3] = -float("inf")
    finite, bad = _off(finite.reshape(n, m * ds), off), _off(bad.reshape(n, m * ds), off)
    ops.reset_launch_counts()
    want, got = _all_modes(cb, finite), _all_modes(cb, bad)
    assert ops.launch_counts() == _with_cell_stats({name + "_wide": 2 for name in got})
    keep = [j for j in range(m) if j != 1]
    for name, codes in (("encode_f32", None), ("encode_bf16", None), ("encode_verify", 0),
                        ("stats_verify", 2)):
        a, b = (want[name], got[name]) if codes is None else (want[name][codes], got[name][codes])
        assert torch.equal(a[:, keep], b[:, keep]), name
    for name in ("stats_f32", "stats_bf16", "stats_verify"):
        assert torch.equal(want[name][1][keep], got[name][1][keep]), name
    flags = want["encode_verify"][1]
    plain = ops.pq_encode_reference(cb, finite, dtype=torch.int32, compute_dtype=torch.float32)
    assert not bool(((want["encode_f32"] != plain)[:, keep].any(dim=1) & (flags == 0)).any())
    plain = ops.pq_encode_reference(cb, finite, dtype=torch.int32, compute_dtype=torch.bfloat16)
    assert int((want["encode_bf16"] != plain)[:, keep].sum()) <= max(2, n * m // 100)


# -- the narrow kernels' padded instances -------------------------------------------

# The 300-d widths (m = 150, 100, 60, 50, 30, 25, 20, 15, 12, 10), d = 768 at
# m = 32, and the odd ones between.
PAD_WIDTHS = [1, 2, 3, 5, 6, 7, 10, 12, 15, 20, 24, 25, 30]


def _forced_shallow(monkeypatch):
    """Make the wrappers take the shallow kernel at every width (counters
    ``*_shallow``): no route of theirs does, but the deep kernel and the
    padded narrow instances are held to it."""
    from reductive_tpu_torch.ops import assign
    monkeypatch.setattr(assign, "assign_route", lambda ds, aligned: "shallow")


def _all_modes(cb, x):
    """Codes of the f32 and bf16 encode, the verify encode's codes and flags,
    and the f32, bf16 and verified statistics (sums, counts[, codes, flags])."""
    f32, bf16, i32 = torch.float32, torch.bfloat16, torch.int32
    return {
        "encode_f32": ops.pq_encode(cb, x, dtype=i32, compute_dtype=f32),
        "encode_bf16": ops.pq_encode(cb, x, dtype=i32, compute_dtype=bf16),
        "encode_verify": pq_encode_verify_flags(cb, x, dtype=i32),
        "stats_f32": ops.pq_assign_stats(cb, x, compute_dtype=f32),
        "stats_bf16": ops.pq_assign_stats(cb, x, compute_dtype=bf16),
        "stats_verify": pq_assign_stats_verify_flags(cb, x),
    }


@pytest.mark.parametrize("ds", PAD_WIDTHS)
def test_the_padded_kernels_assign_as_the_shallow_one(dev, ds, monkeypatch):
    # Up to ds = 32 the shallow kernel walks its depth in one chunk of
    # ceil(ds/8) steps from zero (16 in bf16), in the narrow kernels' order;
    # the padded instance adds steps of zeros only at 17 <= ds <= 24 (f32).
    # The codes must be the same bits in every mode.
    n, m, k = 3001, 3, 300
    cb, x = _data(dev, n, m, k, ds, seed=12)
    ops.reset_launch_counts()
    pad = _all_modes(cb, x)
    assert ops.launch_counts() == {name + "_pad": 1 for name in pad}
    _forced_shallow(monkeypatch)
    ops.reset_launch_counts()
    shallow = _all_modes(cb, x)
    assert ops.launch_counts() == _with_cell_stats({name + "_shallow": 1 for name in shallow})
    for name in ("encode_f32", "encode_bf16"):
        assert torch.equal(pad[name], shallow[name]), (name, int((pad[name] != shallow[name]).sum()))
    assert torch.equal(pad["encode_verify"][0], shallow["encode_verify"][0])
    assert torch.equal(pad["stats_verify"][2], shallow["stats_verify"][2])
    # The same codes, so the same cells; the sums in another order.
    for name in ("stats_f32", "stats_bf16", "stats_verify"):
        assert torch.equal(pad[name][1], shallow[name][1]), name
        want = shallow[name][0]
        tol = 1e-5 * want.abs() + 1e-4 * float(want.abs().max())
        assert bool(((pad[name][0] - want).abs() <= tol).all()), name
    # |x_j| is summed in another order: a flag may differ where a margin sits on
    # the limit, and each kernel's own encode and statistics flag alike.
    assert int((pad["encode_verify"][1] != shallow["encode_verify"][1]).sum()) <= max(2, n // 1000)
    assert torch.equal(pad["encode_verify"][1], pad["stats_verify"][3])
    assert torch.equal(shallow["encode_verify"][1], shallow["stats_verify"][3])


@pytest.mark.parametrize("off", [1, 2, 3])
@pytest.mark.parametrize("ds", [2, 3, 8, 10])
def test_the_padded_kernels_take_rows_off_16_bytes(dev, ds, off):
    # x one, two or three floats past 16 bytes (a view into a larger buffer):
    # 4- or 8-byte copies where the aligned rows take 8 or 16; at ds = 8 the
    # padded instance of the unpadded one.  The same bits in every mode.
    n, m, k = 1500, 4, 64
    cb, x = _data(dev, n, m, k, ds, seed=14)
    view = torch.empty((n * m * ds + off,), device=dev)[off:].view(n, m * ds)
    view.copy_(x)
    assert view.is_contiguous() and view.data_ptr() % 16 == 4 * off
    ops.reset_launch_counts()
    aligned = _all_modes(cb, x)
    names = {name + ("" if ds == 8 else "_pad"): 1 for name in aligned}
    assert ops.launch_counts() == names
    ops.reset_launch_counts()
    shifted = _all_modes(cb, view)
    assert ops.launch_counts() == {name + "_pad": 1 for name in aligned}
    for name in aligned:
        a, b = aligned[name], shifted[name]
        a, b = (a,) if torch.is_tensor(a) else a, (b,) if torch.is_tensor(b) else b
        assert all(torch.equal(u, v) for u, v in zip(a, b)), name


@pytest.mark.parametrize("k", [1, 8, 128, 257])
@pytest.mark.parametrize("ds", [2, 10, 20])
def test_the_padded_kernels_at_every_k(dev, ds, k):
    n, m = 2049, 5
    cb, x = _data(dev, n, m, k, ds, seed=13)
    ops.reset_launch_counts()
    got = _all_modes(cb, x)
    again = _all_modes(cb, x)
    assert ops.launch_counts() == {name + "_pad": 2 for name in got}
    for name in ("stats_f32", "stats_bf16", "stats_verify"):  # two launches, the same bits
        assert all(torch.equal(u, v) for u, v in zip(got[name], again[name])), name
    # Encode and statistics share their assignment: codes, cells and flags.
    codes, flags = got["encode_verify"]
    assert torch.equal(codes, got["encode_f32"]) and torch.equal(codes, got["stats_verify"][2])
    assert torch.equal(flags, got["stats_verify"][3])
    for name, enc in (("stats_f32", got["encode_f32"]), ("stats_bf16", got["encode_bf16"])):
        by_code = torch.stack([torch.bincount(enc[:, j].long(), minlength=k) for j in range(m)])
        assert torch.equal(by_code.to(torch.float32), got[name][1]), name
    # Against the plain versions: codes off only on flagged rows (f32), near
    # ties (bf16); the verified wrappers equal the exact path.
    want = ops.pq_encode_reference(cb, x, dtype=torch.int32, compute_dtype=torch.float32)
    assert not bool(((got["encode_f32"] != want).any(dim=1) & (flags == 0)).any())
    want_bf16 = ops.pq_encode_reference(cb, x, dtype=torch.int32, compute_dtype=torch.bfloat16)
    assert int((got["encode_bf16"] != want_bf16).sum()) <= max(2, n * m // 100)
    oracle = primitives.quantize_batch(cb, x, dtype=torch.int32)
    assert torch.equal(ops.pq_encode_verified(cb, x, dtype=torch.int32), oracle)
    want_sums, want_counts = ops.stats.stats_from_codes(oracle, x, k)
    got_sums, got_counts = ops.pq_assign_stats_verified(cb, x)
    assert torch.equal(got_counts, want_counts)
    tol = 1e-5 * want_sums.abs() + 1e-4 * float(want_sums.abs().max())
    assert bool(((got_sums - want_sums).abs() <= tol).all())
    if k == 1:
        assert int(got["encode_f32"].max()) == 0 and int(flags.sum()) == 0


@pytest.mark.parametrize("n,m,k,ds", [(50000, 16, 256, 8), (20000, 1, 1000, 128), (30000, 10, 128, 2)],
                         ids=["narrow", "wide", "ds2"])
def test_verified_statistics_and_the_plain_route_repeat_bit_for_bit(dev, n, m, k, ds):
    # The adversarial rows of this file (chip_smoke.py's five blocks: exact ties,
    # midpoints, zeros, tiny and huge rows): most are flagged and many move
    # between cells, where the correction once added with float atomics.
    cb, x = _adversarial(*_data(dev, n, m, k, ds, seed=9))
    first = ops.pq_assign_stats_verified(cb, x, cap_frac=1.0)
    second = ops.pq_assign_stats_verified(cb, x, cap_frac=1.0)
    assert torch.equal(first[0], second[0]) and torch.equal(first[1], second[1])
    for run in (lambda: ops.pq_assign_stats_reference(cb, x),
                lambda: ops.stats.exact_stats_chunked(cb, x)):
        a, b = run(), run()
        assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
    from reductive_tpu_torch import kmeans
    flat = x.reshape(-1, ds)[:20000]
    assign = torch.arange(flat.shape[0], device=dev) % 97
    assert torch.equal(kmeans.update_centroids(flat, assign, 97),
                       kmeans.update_centroids(flat, assign, 97))


@pytest.mark.parametrize("d,k", [(128, 512), (768, 300), (20, 128)])
def test_kmeans_chunked_takes_the_kernel_at_full_width(dev, d, k):
    from reductive_tpu_torch import kmeans
    gen = torch.Generator(device=dev).manual_seed(10)
    x = torch.randn((20000, d), generator=gen, device=dev)
    init = x[:k].clone()
    ops.reset_launch_counts()
    c_f32, loss_f32 = kmeans.kmeans_with_centroids_chunked(x, init, 2)
    c_ver, loss_ver = kmeans.kmeans_with_centroids_chunked(x, init, 2, compute_dtype="verified")
    assert ops.launch_counts() == _with_cell_stats({"stats_f32" + _suffix(d): 2,
                                                    "stats_verify" + _suffix(d): 2})
    # The verified memberships are the exact path's: the plain route on the CPU.
    c_cpu, loss_cpu = kmeans.kmeans_with_centroids_chunked(x.cpu(), init.cpu(), 2, use_kernel=False)
    assert float((c_ver.cpu() - c_cpu).abs().max()) < 1e-4
    assert abs(float(loss_ver) - float(loss_cpu)) <= 1e-5 * abs(float(loss_cpu))
    assert abs(float(loss_f32) - float(loss_cpu)) <= 1e-3 * abs(float(loss_cpu))
    codes = ops.assign_nearest(c_f32, x, compute_dtype=torch.float32)
    assert codes.dtype == torch.int32 and int(codes.max()) < k


def test_the_tensor_cores_accumulate_as_the_verify_bound_assumes(dev):
    from reductive_tpu_torch.ops.probe import MODEL_ULPS, probe_wgmma_tf32
    report = probe_wgmma_tf32(dev)
    assert report["uniform_outputs"], report
    assert report["kept_bits"] >= 24, report
    assert report["mode"] == "truncate", report
    assert report["max_err_ulps"] <= MODEL_ULPS, report


def test_the_deep_kernels_instruction_accumulates_as_the_verify_bound_assumes(dev):
    # wgmma.m64n128k8.f32.tf32.tf32, A from registers, B swizzled as TMA writes it.
    from reductive_tpu_torch.ops.probe import MODEL_ULPS, probe_wgmma_tf32
    report = probe_wgmma_tf32(dev, n=128)
    assert report["uniform_outputs"], report
    assert report["kept_bits"] >= 24, report
    assert report["mode"] == "truncate", report
    assert report["max_err_ulps"] <= MODEL_ULPS, report


# -- the wide route's accumulation from the codes, alone ---------------------------


def _chosen_codes(dev, kind, n, m, k, seed):
    """Codes (n, m) int32: every row in cell k // 2 (``one_cell``: a cell of
    many chunks), only even codes (``half_empty``: every odd cell empty), or
    uniform (``random``)."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    if kind == "one_cell":
        return torch.full((n, m), k // 2, dtype=torch.int32, device=dev)
    codes = torch.randint(0, k, (n, m), generator=gen, device=dev, dtype=torch.int32)
    return codes - codes % 2 if kind == "half_empty" else codes


# (n, m, k, ds): the smoke's widths (36 to 768), several sort tiles and scan
# blocks, k = 1, 4,096 and 65,536 (two sort passes), a narrow ds.
CELL_SHAPES = [
    (3000, 3, 256, 36), (20000, 6, 256, 50), (9000, 4, 256, 75), (9000, 2, 256, 150),
    (5000, 1, 4096, 128), (700, 1, 2000, 768), (4097, 2, 1, 50), (3001, 3, 65536, 40),
    (1000, 5, 37, 3),
]


@pytest.mark.parametrize("round_bf16", [False, True], ids=["f32", "bf16"])
@pytest.mark.parametrize("kind", ["one_cell", "half_empty", "random"])
@pytest.mark.parametrize("n,m,k,ds", CELL_SHAPES)
def test_cell_stats_kernel_is_the_plain_version_bit_for_bit(dev, n, m, k, ds, kind, round_bf16):
    # The kernels add in the plain version's order (each chunk's rows in row
    # order, then the chunks in order): the same bits, twice, and exact counts.
    codes = _chosen_codes(dev, kind, n, m, k, seed=16)
    _, x = _data(dev, n, m, 1, ds, seed=17)
    ops.reset_launch_counts()
    got = ops.stats.cell_stats(codes, x, k, round_bf16=round_bf16)
    again = ops.stats.cell_stats(codes, x, k, round_bf16=round_bf16)
    assert ops.launch_counts() == {"cell_stats": 2}
    want = ops.stats.cell_stats_reference(codes, x, k, round_bf16=round_bf16)
    for a, b, c in zip(got, again, want):
        assert a.shape == c.shape and _same_bits(a, b) and _same_bits(a, c)
    xr = x.to(torch.bfloat16).to(torch.float32) if round_bf16 else x
    one_hot = ops.stats.stats_from_codes(codes, xr, k)
    assert torch.equal(got[1], one_hot[1])
    tol = 1e-5 * one_hot[0].abs() + 1e-4 * float(one_hot[0].abs().max())
    assert bool(((got[0] - one_hot[0]).abs() <= tol).all())
    if kind == "one_cell":
        assert float(got[1][:, k // 2].min()) == n and float(got[1].sum()) == n * m
    if kind == "half_empty" and k > 1:
        assert float(got[1][:, 1::2].abs().sum()) == 0 and float(got[0][:, 1::2].abs().sum()) == 0


@pytest.mark.parametrize("off", [1, 2, 3])
@pytest.mark.parametrize("ds,m", [(36, 3), (50, 3), (50, 1), (75, 4), (150, 2), (37, 2)])
def test_cell_stats_kernel_on_rows_off_16_bytes(dev, ds, m, off):
    # x one to three floats past 16 bytes, and d = m ds not a multiple of 4:
    # narrower loads, the same order, so the same bits as the plain version and
    # as the aligned rows.
    n, k = 6000, 256
    codes = _chosen_codes(dev, "random", n, m, k, seed=18)
    _, x = _data(dev, n, m, 1, ds, seed=19)
    shifted = _off(x, off)
    for round_bf16 in (False, True):
        got = ops.stats.cell_stats(codes, shifted, k, round_bf16=round_bf16)
        aligned = ops.stats.cell_stats(codes, x, k, round_bf16=round_bf16)
        want = ops.stats.cell_stats_reference(codes, x, k, round_bf16=round_bf16)
        for a, b, c in zip(got, aligned, want):
            assert _same_bits(a, b) and _same_bits(a, c)


@pytest.mark.parametrize("compute_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n,m,k,ds", [(20000, 6, 256, 50), (5000, 1, 4096, 128), (3000, 2, 300, 75)])
def test_the_wide_statistics_are_the_accumulation_of_their_codes(dev, n, m, k, ds, compute_dtype):
    # The wide route runs the assignment and then the accumulation from its
    # codes in one C call: its sums are cell_stats of the encode's codes (the
    # same routine assigns both), bit for bit, in every mode.
    cb, x = _data(dev, n, m, k, ds, seed=20)
    bf16 = compute_dtype == torch.bfloat16
    sums, counts = ops.pq_assign_stats(cb, x, compute_dtype=compute_dtype)
    codes = ops.pq_encode(cb, x, dtype=torch.int32, compute_dtype=compute_dtype)
    want = ops.stats.cell_stats_reference(codes, x, k, round_bf16=bf16)
    assert _same_bits(sums, want[0]) and torch.equal(counts, want[1])
    if not bf16:
        v_sums, v_counts, v_codes, _ = pq_assign_stats_verify_flags(cb, x)
        want = ops.stats.cell_stats_reference(v_codes, x, k)
        assert _same_bits(v_sums, want[0]) and torch.equal(v_counts, want[1])


def _ivf_setup(dev, k, n_cells=64, per=300, d=64, m=16, seed=30):
    """A clustered corpus (rows around ``n_cells`` centres x 3.0, noise 0.3)
    and an IVF-PQ model trained on it on the card (k-means++, 3 Lloyd's
    steps each stage), with 16 queries near corpus rows."""
    from reductive_tpu_torch import ivf
    gen = torch.Generator(device=dev).manual_seed(seed)
    centers = 3.0 * torch.randn((n_cells, d), generator=gen, device=dev)
    member = torch.randint(0, n_cells, (n_cells * per,), generator=gen, device=dev)
    x = centers[member] + 0.3 * torch.randn((n_cells * per, d), generator=gen, device=dev)
    coarse, pq = ivf.train_ivf_pq(gen, x, n_cells, m, k.bit_length() - 1, coarse_iterations=3,
                                  pq_iterations=3)
    planted = torch.arange(0, x.shape[0], x.shape[0] // 16, device=dev)[:16]
    q = x[planted] + 0.05 * torch.randn((16, d), generator=gen, device=dev)
    return x, coarse, pq, q, planted


def _select_launches(*rows):
    """The selection kernel's launches for ``_smallest`` over rows of these
    lengths at k up to 1,024: one of each pass a row longer than 2,048
    (``search._SORT_ROW``); shorter rows take one stable sort."""
    n = sum(r > 2048 for r in rows)
    return {"select": n, "select_merge": n} if n else {}


def _lut_row(index, q, nprobe, metric):
    """The length of the ADC-table probe's scored rows: the cells the queries
    probe, once each, times a cell's slots (one chunk of cells at these
    shapes)."""
    from reductive_tpu_torch import ivf
    score_c = ivf._coarse_scores(q, index.coarse_centroids, metric)[1]
    cells = torch.topk(score_c, nprobe, dim=1).indices.unique().numel()
    return cells * index.cell_codes.shape[1]


def _ivf_atol(q):
    # 2e-5 of the terms |q|^2 + g - 2 q.c - 2 q.rec (or q.c + q.rec), which
    # cancel into a distance far below them for a query near a row.
    return 2e-5 * float((q * q).sum(1).max())


@pytest.mark.parametrize("capacity", [None, "auto"])
def test_ivf_build_kernel_route_against_the_plain_route(dev, capacity):
    from reductive_tpu_torch import ivf
    x, coarse, pq, _, _ = _ivf_setup(dev, 256)
    ops.reset_launch_counts()
    kern = ivf.build_ivf(coarse, pq, x, capacity=capacity, use_kernel=True)
    assert ops.launch_counts() == {"encode_bf16": 1}
    plain = ivf.build_ivf(coarse, pq, x, capacity=capacity, use_kernel=False)
    _check_ivf_build_routes(x, coarse, pq, kern, plain)


def _check_ivf_build_routes(x, coarse, pq, kern, plain):
    """The placement is the same plain product on both routes.  The kernel
    route's codes are the bf16 encode's (its plain version's but for at most
    1% of near-ties); where they differ from the plain route's exact codes,
    the centroid taken is within 2^-7 of the products' scale of the best,
    and the norms follow the codes."""
    dev = x.device
    assert torch.equal(kern.cell_ids, plain.cell_ids)
    occ = kern.cell_ids >= 0
    rows = kern.cell_ids[occ].long()
    assert torch.equal(torch.sort(rows).values, torch.arange(x.shape[0], device=dev))
    res = x[rows] - coarse[occ.nonzero()[:, 0]]
    cb = pq.codebooks
    got, exact = kern.cell_codes[occ].long(), plain.cell_codes[occ].long()
    want = ops.pq_encode_reference(cb, res, dtype=torch.int32, compute_dtype=torch.bfloat16)
    assert int((got != want).sum()) <= max(2, got.numel() // 100)
    m, _, ds = cb.shape
    dg, dw = _chosen_dist(cb, res, got), _chosen_dist(cb, res, exact)
    cn = cb.double().pow(2).sum(dim=2).sqrt().amax(dim=1)
    xn = res.reshape(-1, m, ds).double().pow(2).sum(dim=2).sqrt()
    assert bool(((dg - dw).abs() <= 2.0 ** -7 * (2 * xn * cn[None] + cn[None] ** 2)).all())
    same = (got == exact).all(dim=1)
    assert torch.equal(kern.cell_norms[occ][same], plain.cell_norms[occ][same])


@pytest.mark.parametrize("metric", ["l2", "dot"])
@pytest.mark.parametrize("nprobe", [1, 8])
def test_ivf_search_kernel_route_against_the_plain_route(dev, metric, nprobe):
    from reductive_tpu_torch import ivf
    x, coarse, pq, q, _ = _ivf_setup(dev, 256)
    index = ivf.build_ivf(coarse, pq, x, capacity="auto")
    _check_ivf_search_routes(index, q, nprobe, metric)


def _check_ivf_search_routes(index, q, nprobe, metric):
    """The kernel route's distances within 2e-5 of the plain route's, and
    its ids equal wherever the plain scores lie further apart than that."""
    from reductive_tpu_torch import ivf
    lut, plain = _lut_row(index, q, nprobe, metric), nprobe * index.cell_codes.shape[1]
    ops.reset_launch_counts()
    d_k, i_k = ivf.ivf_search(index, q, 11, nprobe=nprobe, splits=3, metric=metric)
    assert ops.launch_counts() == {"adc": 1, **_select_launches(lut)}
    d_p, i_p = ivf.ivf_search(index, q, 11, nprobe=nprobe, use_kernel=False, metric=metric)
    assert ops.launch_counts() == {"adc": 1, **_select_launches(lut, plain)}
    atol = _ivf_atol(q)
    assert torch.allclose(d_k, d_p, rtol=2e-5, atol=atol)
    # Ids equal wherever the plain scores are further apart than that.
    gap = torch.diff(d_p, dim=1)
    apart = torch.ones_like(i_p[:, :10], dtype=torch.bool)
    apart[:, 1:] &= gap[:, :9] > atol
    apart &= gap[:, :10] > atol
    assert torch.equal(i_k[:, :10][apart], i_p[:, :10][apart])


def _ivf_nearest(x, coarse):
    from reductive_tpu_torch import ivf
    return ivf._assign_block(x, coarse, 262_144).long()


def test_ivf_device_build_kernel_route_against_the_plain_route(dev):
    from reductive_tpu_torch import ivf
    x, coarse, pq, _, _ = _ivf_setup(dev, 256)
    L = -(-int(1.05 * x.shape[0]) // coarse.shape[0])
    ops.reset_launch_counts()
    kern = ivf.build_ivf(coarse, pq, x, capacity=L, placement="device", use_kernel=True)
    counts = torch.bincount(_ivf_nearest(x, coarse), minlength=coarse.shape[0])
    assert int((counts - L).clamp(min=0).sum()) > 0  # overflow: the respill re-encoded its rows
    assert ops.launch_counts() == {"encode_bf16": 2}
    plain = ivf.build_ivf(coarse, pq, x, capacity=L, placement="device", use_kernel=False)
    _check_ivf_build_routes(x, coarse, pq, kern, plain)


@pytest.mark.parametrize("k", [256, 16])
def test_ivf_unbounded_device_build_is_the_host_build(dev, k):
    from reductive_tpu_torch import ivf
    x, coarse, pq, _, _ = _ivf_setup(dev, k)
    for packed in (False, True) if k == 16 else (False,):
        for use_kernel in (True, False):
            a = ivf.build_ivf(coarse, pq, x, placement="device", packed=packed,
                              use_kernel=use_kernel, batch=5000)
            b = ivf.build_ivf(coarse, pq, x, placement="host", packed=packed,
                              use_kernel=use_kernel, batch=5000)
            assert torch.equal(a.cell_ids, b.cell_ids) and torch.equal(a.cell_codes, b.cell_codes)
            assert _same_bits(a.cell_norms, b.cell_norms)
    auto, device = ivf.build_ivf(coarse, pq, x), ivf.build_ivf(coarse, pq, x, placement="device")
    assert torch.equal(auto.cell_codes, device.cell_codes) and torch.equal(auto.cell_ids,
                                                                            device.cell_ids)


@pytest.mark.parametrize("share", [1.0, 1.05])
def test_ivf_bounded_device_build_invariants(dev, share):
    from reductive_tpu_torch import ivf
    x, coarse, pq, _, _ = _ivf_setup(dev, 256)
    n, C = x.shape[0], coarse.shape[0]
    L = -(-int(share * n) // C)
    index = ivf.build_ivf(coarse, pq, x, capacity=L, placement="device")
    assert index.capacity == L and index.dropped_ids.size == 0
    occ = index.cell_ids >= 0
    rows = index.cell_ids[occ].long()
    assert torch.equal(torch.sort(rows).values, torch.arange(n, device=dev))
    cells = occ.nonzero()[:, 0]
    nearest = _ivf_nearest(x, coarse)
    fits = torch.bincount(nearest, minlength=C)[nearest[rows]] <= L
    assert torch.equal(cells[fits], nearest[rows][fits]) and bool((~fits).any())
    # A stored code is the kernel's code of its residual against its storage cell.
    res = x[rows] - coarse[cells]
    assert torch.equal(index.cell_codes[occ], ops.pq_encode(pq.codebooks, res))


def _ivf_churn(dev, x, coarse, index, gen):
    """Removes every 7th row and adds rows near it under new ids in two
    batches; returns the new index and the added rows."""
    from reductive_tpu_torch import ivf
    n = x.shape[0]
    gone = torch.arange(0, n, 7, device=dev)
    index = ivf.ivf_remove(index, gone)
    new = x[gone] + 0.05 * torch.randn((gone.numel(), x.shape[1]), generator=gen, device=dev)
    half = gone.numel() // 2
    index = ivf.ivf_add(index, new[:half], ids=torch.arange(n, n + half))
    index = ivf.ivf_add(index, new[half:], ids=torch.arange(n + half, n + gone.numel()))
    return index, new


def test_ivf_add_fast_path_against_the_host_path(dev, monkeypatch):
    from reductive_tpu_torch import ivf
    x, coarse, pq, _, _ = _ivf_setup(dev, 256)
    index = ivf.ivf_remove(ivf.build_ivf(coarse, pq, x, capacity="auto"),
                           torch.arange(0, x.shape[0], 7, device=dev))
    gen = torch.Generator(device=dev).manual_seed(5)
    new = x[:300] + 0.05 * torch.randn((300, x.shape[1]), generator=gen, device=dev)
    ids = torch.arange(10 ** 6, 10 ** 6 + 300)
    ops.reset_launch_counts()
    fast = ivf.ivf_add(index, new, ids=ids)
    assert ops.launch_counts() == {"encode_bf16": 1}
    gate = ivf._add_fast_gate
    monkeypatch.setattr(ivf, "_add_fast_gate", lambda cell_ids, assign, L: (
        torch.tensor(True, device=dev), gate(cell_ids, assign, L)[1]))
    host = ivf.ivf_add(index, new, ids=ids)
    assert torch.equal(fast.cell_ids, host.cell_ids)
    assert torch.equal(fast.cell_codes, host.cell_codes)
    assert _same_bits(fast.cell_norms, host.cell_norms)
    donated = ivf.ivf_add(ivf.IvfPq(index.coarse_centroids, pq, index.cell_codes.clone(),
                                    index.cell_ids.clone(), index.cell_norms.clone()),
                          new, ids=ids, donate=True)
    assert torch.equal(donated.cell_codes, host.cell_codes) and _same_bits(donated.cell_norms,
                                                                          host.cell_norms)


@pytest.mark.parametrize("metric", ["l2", "dot"])
def test_ivf_search_after_churn_kernel_route_against_the_plain_route(dev, metric):
    from reductive_tpu_torch import ivf
    x, coarse, pq, q, _ = _ivf_setup(dev, 256)
    index = ivf.build_ivf(coarse, pq, x, capacity="auto", placement="device")
    index, new = _ivf_churn(dev, x, coarse, index, torch.Generator(device=dev).manual_seed(6))
    live = index.cell_ids[index.cell_ids >= 0].long()
    assert live.numel() == x.shape[0] and torch.equal(torch.unique(live), torch.sort(live).values)
    _check_ivf_search_routes(index, torch.cat([q, new[:16]]), 8, metric)


@pytest.mark.parametrize("metric", ["l2", "dot"])
def test_ivf_lut_probe_against_the_decode_probe(dev, metric):
    from reductive_tpu_torch import ivf
    x, coarse, pq, q, _ = _ivf_setup(dev, 256)
    index = ivf.build_ivf(coarse, pq, x, capacity="auto")
    args = (index.coarse_centroids, index.cell_codes, index.cell_ids, index.cell_norms, pq, 8)
    ops.reset_launch_counts()
    d_l, i_l = ivf._probe_and_score_lut(q, *args, 10, 3, metric)
    d_d, i_d = ivf._padded_topk(*ivf._probe_and_score(q, *args, True, 3, metric), 10)
    rows = (_lut_row(index, q, 8, metric), 8 * index.cell_codes.shape[1])
    assert ops.launch_counts() == {"adc": 1, "decode": 1, **_select_launches(*rows)}
    assert torch.equal(i_l.long(), i_d.long())
    assert torch.allclose(d_l, d_d, rtol=2e-5, atol=_ivf_atol(q))


@pytest.mark.parametrize("use_kernel", [True, False])
def test_ivf_packed_cells_score_as_the_unpacked(dev, use_kernel):
    from reductive_tpu_torch import ivf
    x, coarse, pq, q, _ = _ivf_setup(dev, 16)
    unpacked = ivf.build_ivf(coarse, pq, x, capacity="auto")
    packed = ivf.build_ivf(coarse, pq, x, capacity="auto", packed=True)
    assert packed.packed and torch.equal(ops.unpack_u4_codes(packed.cell_codes.reshape(-1, 8)),
                                         unpacked.cell_codes.reshape(-1, 16))
    ops.reset_launch_counts()
    rows = []
    for metric in ("l2", "dot"):
        a = ivf.ivf_search(unpacked, q, 10, nprobe=8, use_kernel=use_kernel, metric=metric)
        b = ivf.ivf_search(packed, q, 10, nprobe=8, use_kernel=use_kernel, metric=metric)
        assert _same_bits(a[0], b[0]) and torch.equal(a[1], b[1])
        rows += [_lut_row(i, q, 8, metric) if use_kernel else 8 * i.cell_codes.shape[1]
                 for i in (unpacked, packed)]
    scoring = {"adc": 2, "adc_u4": 2} if use_kernel else {}
    assert ops.launch_counts() == {**scoring, **_select_launches(*rows)}


def test_ivf_training_takes_the_kernels(dev):
    from reductive_tpu_torch import ivf
    x, _, _, _, _ = _ivf_setup(dev, 256, d=128, n_cells=256, per=100)
    ops.reset_launch_counts()
    gen = torch.Generator(device=dev).manual_seed(1)
    coarse, pq = ivf.train_ivf_pq(gen, x, 256, 16, 8, coarse_iterations=2, pq_iterations=2)
    counts = ops.launch_counts()
    assert coarse.shape == (256, 128) and pq.codebooks.shape == (16, 256, 8)
    assert bool(torch.isfinite(coarse).all()) and bool(torch.isfinite(pq.codebooks).all())
    assert counts["stats_f32_wide"] == 2 and counts["encode_bf16_wide"] == 1
    assert counts["stats_f32"] == 2
    assert not any(name.endswith("_shallow") for name in counts)


# -- corpora on disk: the streamed trainers, the streaming encode, readers ----


def _fvecs(dev, tmp_path, n, d, seed=0):
    """Clustered rows written as an fvecs file, and the rows on the card."""
    from reductive_tpu_torch.native import write_fvecs

    gen = torch.Generator(device=dev).manual_seed(seed)
    centres = 2.0 * torch.randn((64, d), generator=gen, device=dev)
    x = centres[torch.randint(0, 64, (n,), generator=gen, device=dev)]
    x += torch.randn((n, d), generator=gen, device=dev)
    path = str(tmp_path / "corpus.fvecs")
    write_fvecs(path, x)
    return path, x


@pytest.mark.parametrize("compute_dtype", [torch.float32, torch.bfloat16, "verified"])
@pytest.mark.parametrize("n,d,m,batch", [(20000, 64, 8, 8192), (9000, 96, 3, 4096)])
def test_streamed_pq_equals_chunked_on_the_card(dev, tmp_path, compute_dtype, n, d, m, batch):
    """At batch_size == chunk (a chunk of at least train.KERNEL_CHUNK_MIN
    rows splits the chunked trainer's kernel pass too): the same launches,
    the same bits.  ds = 8 takes the narrow kernel, ds = 32 its widest
    instance."""
    from reductive_tpu_torch import native, train_pq_chunked, train_pq_streamed
    from reductive_tpu_torch.pq import train as train_module

    path, x = _fvecs(dev, tmp_path, n, d)
    old = train_module.KERNEL_CHUNK_MIN
    train_module.KERNEL_CHUNK_MIN = batch  # small shapes: split at this test's batch
    try:
        with native.VecsReader(path) as r:
            ops.reset_launch_counts()
            got = train_pq_streamed(torch.Generator(device=dev).manual_seed(3), r, m, 8, 3,
                                    batch_size=batch, compute_dtype=compute_dtype)
            streamed = ops.launch_counts()
        ops.reset_launch_counts()
        want = train_pq_chunked(torch.Generator(device=dev).manual_seed(3), x, m, 8, 3,
                                chunk=batch, compute_dtype=compute_dtype)
        assert ops.launch_counts() == streamed
    finally:
        train_module.KERNEL_CHUNK_MIN = old
    name = {torch.float32: "stats_f32", torch.bfloat16: "stats_bf16"}.get(compute_dtype,
                                                                          "stats_verify")
    assert streamed[name] == 3 * -(-n // batch)
    assert torch.equal(got.codebooks, want.codebooks)


@pytest.mark.parametrize("rotated", [False, True])
def test_stream_encode_codes_are_quantize_batch_on_the_card(dev, tmp_path, rotated):
    """The default encode streamed from disk, f32 and bf16 on the wire, gives
    ``Pq.quantize_batch(method="kernel")``'s codes on the resident rows bit for
    bit (the kernel rounds the rows to bf16 as the host does), and the tail
    batch too; the resumable encode gives the same codes.  With a projection
    the rotation is a product whose rounding may follow its row count, so the
    codes are held to the quantizer's on each (padded) batch."""
    from reductive_tpu_torch import Pq, native
    from reductive_tpu_torch.data import stream_encode, stream_encode_resumable

    path, x = _fvecs(dev, tmp_path, 10007, 64)
    gen = torch.Generator(device=dev).manual_seed(5)
    proj = torch.linalg.qr(torch.randn((64, 64), generator=gen, device=dev))[0] if rotated else None
    pq = Pq(codebooks=torch.randn((8, 256, 8), generator=gen, device=dev), projection=proj)
    if rotated:
        pad = torch.nn.functional.pad
        want = torch.cat([pq.quantize_batch(pad(x[o:o + 4096], (0, 0, 0, 4096 - x[o:o + 4096].shape[0])),
                                            method="kernel")[:x[o:o + 4096].shape[0]]
                          for o in range(0, x.shape[0], 4096)]).cpu().numpy()
    else:
        want = pq.quantize_batch(x, method="kernel").cpu().numpy()
    with native.VecsReader(path) as r:
        ops.reset_launch_counts()
        got = stream_encode(pq, r, batch_size=4096)
        assert ops.launch_counts() == {"encode_bf16": 3}
        bf16 = stream_encode(pq, r, batch_size=4096, transfer_dtype=torch.bfloat16)
        resumed = stream_encode_resumable(pq, r, str(tmp_path / "codes.u8"), batch_size=4096)
    assert (got == want).all()
    assert (resumed == want).all()
    if not rotated:  # a projection sees the rounded rows
        assert (bf16 == want).all()


@pytest.mark.parametrize("placement", ["host", "device"])
def test_ivf_build_from_a_reader_equals_the_tensor_build(dev, tmp_path, placement):
    from reductive_tpu_torch import ivf, native

    x, coarse, pq, q, _ = _ivf_setup(dev, 256)
    from reductive_tpu_torch.native import write_fvecs

    path = str(tmp_path / "ivf.fvecs")
    write_fvecs(path, x)
    with native.VecsReader(path) as r:
        for capacity in (None, "auto"):
            want = ivf.build_ivf(coarse, pq, x, capacity=capacity, placement=placement)
            got = ivf.build_ivf(coarse, pq, r, capacity=capacity, placement=placement)
            for name in ("cell_codes", "cell_ids", "cell_norms"):
                assert torch.equal(getattr(got, name), getattr(want, name)), (capacity, name)
        a = ivf.ivf_search(want, q, 10, nprobe=8, refine_with=r)
        b = ivf.ivf_search(want, q, 10, nprobe=8, refine_with=x)
        assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])


# -- the selection kernel: the k smallest of long rows, ties by position -------


def _select_rows(dev, kind, nq, n, k, seed):
    """Rows of one kind: ``ties`` (seven integer levels), ``zeros`` (-0.0 and
    +0.0 with some ones), ``inf`` (+inf but for fewer finite entries than k,
    two of them -inf) or ``random``."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    if kind == "ties":
        return torch.randint(0, 7, (nq, n), generator=gen, device=dev).to(torch.float32)
    if kind == "zeros":
        r = torch.rand((nq, n), generator=gen, device=dev)
        return torch.where(r < 0.45, -0.0, torch.where(r < 0.9, 0.0, 1.0))
    if kind == "inf":
        x = torch.full((nq, n), float("inf"), device=dev)
        few = max(1, min(k // 2, n // 4))
        at = torch.randint(0, n, (nq, few), generator=gen, device=dev)
        x.scatter_(1, at, torch.randn((nq, few), generator=gen, device=dev))
        x.scatter_(1, at[:, :2], float("-inf"))
        return x
    return torch.randn((nq, n), generator=gen, device=dev)


def _assert_same_selection(got, want):
    assert got[0].shape == want[0].shape and torch.equal(got[1], want[1])
    assert torch.equal(got[0].view(torch.int32), want[0].view(torch.int32))


@pytest.mark.parametrize("kind", ["ties", "zeros", "inf", "random"])
@pytest.mark.parametrize("nq,n", [(1, 8_841_823), (128, 524_288), (130, 2049), (130, 100_003)])
@pytest.mark.parametrize("k", [1, 7, 100, 101, 1024])
def test_select_kernel_is_its_plain_version_bit_for_bit(dev, kind, nq, n, k):
    from reductive_tpu_torch.ops import select
    scores = _select_rows(dev, kind, nq, n, k, seed=k + n)
    ops.reset_launch_counts()
    got = select.select_smallest_kernel(scores, k)
    assert ops.launch_counts() == {"select": 1, "select_merge": 1}
    _assert_same_selection(got, select.select_smallest_reference(scores, k))
    # Merged with a prior list, as the streamed search does: ids offset + column.
    earlier = _select_rows(dev, kind, nq, 3000, k, seed=k + n + 1)
    prior = select.select_smallest_reference(earlier, k)
    offset = 3000 + 1_000_003
    got = select.select_smallest_kernel(scores, k, prior=prior, offset=offset)
    _assert_same_selection(got, select.select_smallest_reference(scores, k, prior=prior,
                                                                 offset=offset))


@pytest.mark.parametrize("nq,n", [(3, 5000), (2, 524_288)])
@pytest.mark.parametrize("k", [7, 100, 1024])
def test_select_kernel_ranks_nan_as_the_stable_sort(dev, nq, n, k):
    from reductive_tpu_torch.ops import select
    gen = torch.Generator(device=dev).manual_seed(n + k)
    scores = torch.randint(0, 5, (nq, n), generator=gen, device=dev).to(torch.float32)
    nan = torch.rand((nq, n), generator=gen, device=dev) < 0.5
    payloads = torch.tensor([0x7FC00000, 0xFFC00001 - (1 << 32), 0x7F800001], dtype=torch.int32,
                            device=dev)
    pick = payloads[torch.randint(0, 3, (nq, n), generator=gen, device=dev)].view(torch.float32)
    scores = torch.where(nan, pick, scores)
    scores[0, : n // 2] = pick[0, : n // 2]  # a row whose first half is all NaN
    vals, ids = select.select_smallest_kernel(scores, k)
    # torch.sort's rule, NaN above +inf whatever its sign, is the CPU's: on the
    # card its radix sort ranks a NaN with the sign bit below -inf.
    want_vals, want_ids = torch.sort(scores.cpu(), dim=1, stable=True)
    assert torch.equal(ids.cpu(), want_ids[:, :k])
    assert torch.equal(vals.cpu().view(torch.int32), want_vals[:, :k].view(torch.int32))


def test_smallest_takes_the_kernel_for_long_cuda_rows_only(dev):
    from reductive_tpu_torch import search as tsearch
    scores = torch.randn((4, 5000), device=dev)
    for k, n, launched in ((10, 5000, True), (1024, 5000, True), (1025, 5000, False),
                           (10, 2048, False)):
        ops.reset_launch_counts()
        tsearch._smallest(scores[:, :n].contiguous(), None, k)
        assert ops.launch_counts() == ({"select": 1, "select_merge": 1} if launched else {})
    ops.reset_launch_counts()
    tsearch._smallest(scores.double(), None, 10)
    assert ops.launch_counts() == {}


@pytest.mark.parametrize("top_k", [10, 100])
@pytest.mark.parametrize("metric", ["l2", "dot"])
def test_a_streamed_search_selects_in_the_kernel_as_the_plain_route(dev, monkeypatch, top_k,
                                                                    metric):
    from reductive_tpu_torch import Pq
    from reductive_tpu_torch import search as tsearch
    gen = torch.Generator(device=dev).manual_seed(7)
    m, k, ds, n = 16, 256, 8, 300_000
    pq = Pq(codebooks=torch.randn((m, k, ds), generator=gen, device=dev))
    distinct = torch.randint(0, k, (4096, m), generator=gen, device=dev, dtype=torch.uint8)
    codes = distinct[torch.randint(0, 4096, (n,), generator=gen, device=dev)]
    q = torch.randn((128, m * ds), generator=gen, device=dev)
    ops.reset_launch_counts()
    got = tsearch.search(pq, q, codes, top_k, stream_chunk=1 << 16, metric=metric)
    chunks = -(-n // (1 << 16))
    assert ops.launch_counts() == {"adc": chunks, "select": chunks, "select_merge": chunks}
    monkeypatch.setattr(tsearch, "_kernel_selects", lambda scores, k, offset=0: False)
    want = tsearch.search(pq, q, codes, top_k, stream_chunk=1 << 16, metric=metric)
    _assert_same_selection(got, want)


def test_a_streamed_search_past_the_kernels_ids_merges_on_the_plain_route(dev, monkeypatch):
    # With the kernel's id limit lowered to three chunks, the later chunks are
    # selected by position (still in the kernel, with no prior list) and merged
    # by the concatenation's stable sort; the answer is the same.
    from reductive_tpu_torch import Pq
    from reductive_tpu_torch import search as tsearch
    gen = torch.Generator(device=dev).manual_seed(8)
    m, k, ds, n, chunk = 16, 256, 8, 300_000, 1 << 16
    pq = Pq(codebooks=torch.randn((m, k, ds), generator=gen, device=dev))
    distinct = torch.randint(0, k, (4096, m), generator=gen, device=dev, dtype=torch.uint8)
    codes = distinct[torch.randint(0, 4096, (n,), generator=gen, device=dev)]
    q = torch.randn((128, m * ds), generator=gen, device=dev)
    want = tsearch.search(pq, q, codes, 100, stream_chunk=chunk)
    monkeypatch.setattr(tsearch, "ID_LIMIT", 3 * chunk)
    merges = []
    kernel = tsearch.select_smallest_kernel
    monkeypatch.setattr(tsearch, "select_smallest_kernel", lambda s, k, **kw: (
        merges.append(kw.get("offset")), kernel(s, k, **kw))[1])
    ops.reset_launch_counts()
    got = tsearch.search(pq, q, codes, 100, stream_chunk=chunk)
    chunks = -(-n // chunk)
    assert merges == [0, chunk, 2 * chunk] + [None] * (chunks - 3)
    assert ops.launch_counts() == {"adc": chunks, "select": chunks, "select_merge": chunks}
    _assert_same_selection(got, want)
