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
assignment routine: their codes, counts and flags are held equal bit for bit.
The wide route (every ds outside 4, 8, 16, 32: 1, 2, 3, 12, 20, 48, 64, 128
and 768 here, the last two at k = 4096 and 2000 with m = 1, k-means' shape)
is held to the same: each kernel against its plain version, encode against
statistics, two launches bit-equal; decode at any ds.  The verified
statistics give the same bits twice on an adversarial corpus, narrow and
wide, and so does the plain route on the card.  The probe of the tensor
cores' accumulation must find what the verify bound assumes.
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
                                      (100, 2, 50, 5)])
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
                 (999, 200, 256, 3)]
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
    wide = train_pq_chunked(gen, x[:, :24], 2, 6, 2)  # ds = 12: the wide route
    assert ops.launch_counts() == {"stats_f32_wide": 2}
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
                                      (2000, 24, 16, 130), (777, 10, 16, 3)])
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
# m = 1 at the k-means widths.
WIDE_SHAPES = [
    (3000, 5, 37, 1), (4097, 10, 128, 2), (1000, 3, 300, 3), (2049, 8, 256, 12), (1025, 2, 65, 20),
    (777, 16, 256, 48), (513, 1, 1000, 64), (3000, 1, 4096, 128), (700, 1, 2000, 768),
]


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
    assert ops.launch_counts() == {("encode_f32" if f32 else "encode_bf16") + "_wide": 1}
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
    assert ops.launch_counts() == {("stats_f32" if f32 else "stats_bf16") + "_wide": 2}
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
    assert ops.launch_counts() == {"stats_verify_wide": 2, "encode_verify_wide": 1}
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
    assert ops.launch_counts() == {"stats_f32_wide": 2, "stats_verify_wide": 2}
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
