"""PQ encode / nearest-centroid assignment: CUDA kernel and plain version.

For every row and subquantizer: ``argmin_c (|c|^2 - 2 c.x_j)``, the first
index on ties.  Counterpart of ``reductive_tpu.ops.assign.pq_encode`` (TPU
kernel ``_encode_kernel``); the kernel is ``csrc/encode.cu``.

Two modes, chosen by ``compute_dtype``:

* ``torch.float32``: fp32 accuracy from a split product on the tensor cores
  (``csrc/assign_tile.cuh``, route :data:`F32_ROUTE`): ``x`` and ``2c`` each
  split into two TF32 parts, three products summed in f32, then ``|c|^2``
  subtracted in f32.  Each cross term is within ``(3.25 + 5 ceil(ds/8))
  2^-22 |2c| |x|`` of the real one (derived below).  The f32 assign+statistics
  kernel (:mod:`reductive_tpu_torch.ops.stats`) runs the same routine, so the
  two give a row the same code bit for bit.  The JAX package's f32 mode is a
  split product too, in three bf16 passes, "used identically by the encode
  and assign+stats kernels"; the port keeps that property with TF32 parts.
  That is at every ``ds`` up to 32 (:func:`assign_route` ``"narrow"``): the
  kernels are compiled for 4, 8, 16 and 32, and another ``ds`` runs the
  instance of the padded width :func:`padded_ds` with zeros past ``ds``
  (counters ``*_pad``).  Every wider ``ds``, at any alignment of ``x``,
  takes the deep kernel (``csrc/assign_deep.cuh``, route :data:`WIDE_ROUTE`,
  counters ``*_wide``): the same split, walked over the depth in chunks of 32
  values, each chunk's products from zero and the chunks added in f32, on a
  codebook converted once a call (:func:`deep_operands`), shared by the
  encode and the statistics kernel in the same way.  Its rows come by TMA
  where ``m * ds`` is a multiple of 4, at any alignment of ``x``
  (:func:`deep_row_map`), else by ``cp.async`` (:func:`deep_producer`).  The shallow kernel of
  ``csrc/assign_wide.cuh`` has the same arithmetic and is no route of the
  wrappers: tests and tools force it (``assign_route`` patched to answer
  ``"shallow"``, counters ``*_shallow``) to hold the deep kernel to it.
* ``torch.bfloat16`` (default): ``x`` and ``2c`` each rounded to bfloat16
  (nearest even), products and sums in f32, ``|c|^2`` in f32 from the
  unrounded codebook.  Every kernel sums the products on the tensor cores from
  zero and subtracts the sum from ``|c|^2`` in f32, as the plain version does.
  At every ``ds`` up to 32 the encode and the statistics kernel run one bf16
  routine (``csrc/assign_tile.cuh``, padded as in f32 mode), so the two give
  a row the same code bit for bit, with the launch plan of
  :func:`bf16_tile_plan`.

The minimum is the true ``(distance, index)`` minimum; the JAX kernel's
packed sortable key, which coarsens ties, is not part of the contract.  The
kernel and the plain version (f32 tensor operations) agree except where
rounding (the split, f32 summation order) flips a near-tie.

:func:`pq_encode_verified` removes that exception: its result **equals**
:func:`reductive_tpu_torch.pq.primitives.quantize_batch` on every code.
Counterpart of ``reductive_tpu.ops.assign.pq_encode_verified`` (TPU kernel
``_encode_verify_kernel``).  The f32 kernel also reports, per row, whether
any subquantizer's top-2 margin is small enough for rounding to have changed
the argmin; those rows are encoded again by the exact path.  Its flags are
those of the statistics kernel's verified mode, bit for bit.

The bound behind the flags
--------------------------

First for two routes that both evaluate the product in f32 (route
``"fma"``, a chain of f32 FMAs, which no kernel of the port uses any more; it
is the first step of the derivation); the split product follows.  Fix a row's
subvector ``x`` (``ds`` long) and a subquantizer with doubled centroids
``w_c = 2c`` and squared norms ``n_c`` (the same f32 numbers on both routes).
Both a kernel and the exact path compute ``d_c = fl(n_c - s_c)`` where
``s_c`` is *some* f32 evaluation of the ``ds``-term product ``w_c . x`` (a
chain of FMAs; the exact path: whatever order the matrix product takes),
followed by one rounded subtraction.  With ``u = 2^-24``:

* any order of summation, fused or not, gives
  ``|s_c - w_c.x| <= g |w_c| |x|`` with ``g = ds u / (1 - ds u)``, so the two
  routes' ``s_c`` differ by at most ``2B``, ``B = g max_c|w_c| |x|``;
* the subtraction rounds each route's ``n_c - s_c`` by a relative ``u``.
  That error scales with ``|d_c|`` (so with ``|c|^2``), not with ``|x|``: for
  a tiny ``x`` it is far larger than ``B``, and it can turn distinct
  distances into a tie that the first-index rule then resolves otherwise.

Let ``a`` be the kernel's choice and ``D_c = dK_c - dK_a`` the kernel's gap to
another index ``c`` (``D_c >=`` the kernel's margin).  Writing the exact
path's distances ``dO`` through the kernel's:
``dO_c - dO_a >= D_c (1 - 2^-23) - 4B (1 + u) - 2^-22 |dK_a| (1 + 2^-22)``
(use ``|dK_c| <= |dK_a| + D_c``).  So whenever the kernel's margin exceeds
``4B + 2^-22 |dK_a|`` by a hair, the exact path has ``dO_c > dO_a`` strictly
for every other ``c`` and picks ``a`` too, ties included.  The kernel flags
with twice that: ``margin <= 2 e_j |x_j| + rho |best|`` where
``e_j = 4 ds 2^-24 max_c|2c_jc|`` and ``rho = 2^-21``; the factor two covers
the f32 evaluation of ``|x_j|``, ``max|2c|`` and the limit itself.  ``x = 0``
gives ``B = 0`` and both routes the same bits; an exact tie has margin 0 and
is always flagged.  Underflow to subnormals is not covered.

The JAX package's scale ``2^-14`` covers its three-pass bfloat16 split and its
packed sortable key, which this port has neither of; ``ds = 8`` gives
``2^-19`` on this route and ``20.5 * 2^-22`` (about ``2^-17.6``) on the split
product below, the port's.

The bound for a split product on the tensor cores (route ``"tf32x3"``)
-------------------------------------------------------------------------

The f32 encode and assign+statistics kernels (``csrc/assign_tile.cuh``)
evaluate ``s_c`` otherwise: ``x = x_hi + x_lo + r_x`` and
``w = w_hi + w_lo + r_w``, each part rounded to TF32 (11 significant bits,
nearest), so ``|x_lo| <= 2^-11 |x|`` and
``|r_x| <= 2^-22 |x|`` per element, and likewise for ``w``.  It sums
``x_lo.w_hi + x_hi.w_lo + x_hi.w_hi`` in that order in ``3 ceil(ds/8)``
tensor-core instructions of depth 8, the accumulator starting at zero, and
then takes ``d_c = fl(n_c - s_c)`` as before.  Against the real ``w.x``:

* the split drops ``x_lo.w_lo``, ``r_x.w`` and ``x.r_w``: at most
  ``3 * 2^-22 |w| |x|`` (second-order terms are below ``2^-32``);
* every product of two TF32 values is exact in f32.  One instruction adds
  eight of them and the accumulator.  The tensor core aligns its addends to
  the largest exponent, keeps at least f32's 24 bits of each and truncates,
  and truncates the sum once more: at most ``10 * 2^-23 M`` an instruction,
  ``M`` the largest magnitude among addends and sum.  For the ``ceil(ds/8)``
  instructions of ``x_hi.w_hi``, ``M <= (1 + 2^-9) |w| |x|``; for the small
  products ``M <= 2^-10 |w| |x|``, which adds less than ``2^-30``.  Together
  ``5 ceil(ds/8) * 2^-22 |w| |x|``, with ``0.25 * 2^-22`` set aside for all
  the lower-order terms.

So the kernel's ``s_c`` is within ``B_k = (3.25 + 5 ceil(ds/8)) 2^-22
max_c|w_c| |x|`` of the truth and the exact path's within ``B``; the two
routes differ by at most ``B_k + B`` where the first derivation has ``2B``,
and the rest of that argument stands (the subtraction and ``rho`` are the
same).  The flag limit's scale becomes ``2 (B_k + B) / |x|``:
``e_j = 2 ((3.25 + 5 ceil(ds/8)) 2^-22 + ds 2^-24) max_c|2c_jc|``, which is
``20.5 * 2^-22`` at ``ds = 8`` where the ``"fma"`` route has ``8 * 2^-22``.
The ``0.25`` set aside covers the lower-order terms while ``ceil(ds/8) <= 12``
(they grow by ``2^-6`` a depth step); the narrow kernels, the only ones on
this route, take ``ds <= 32``.

The padded widths (route ``"tf32x3_pad"``)
-----------------------------------------

A ``ds`` outside 4, 8, 16, 32 runs the narrow kernels' instance for
``dsp = padded_ds(ds)``, its rows and centroids padded with zeros.  A zero
column adds an exact zero product, so the evaluation is the one above with
``dsp / 8`` instructions of each product, each from zero in the same order.
At ``ds <= 16`` and ``25 <= ds <= 32`` that is ``ceil(ds/8)`` instructions:
the same count and order as the shallow wide kernel's one chunk
(``wide_chunking(ds) == (ceil(ds/8), 1)``), so those widths keep
:data:`WIDE_ROUTE`, whose bound is the larger (``3.5 + (5 + 2^-6) kc + 0.26``
against ``3.25 + 5 kc``).  At ``17 <= ds <= 24``, ``dsp = 32`` takes a fourth
instruction of each product whose addends are all zero.  Its alignment and
truncation are not assumed to leave the accumulator's bits alone: it meets
the same magnitudes as a real fourth step (the running sum, at most
``(1 + 2^-9) |w| |x|`` in ``x_hi.w_hi``), so the narrow route's count holds
with four instructions, ``(3.25 + 5 * 4) 2^-22``.  Those widths take the
larger of that and the wide route's three-step bound (``(3.5 + (5 + 2^-6) * 3
+ 0.26) 2^-22``, smaller): ``23.25 * 2^-22``, and the flag limit's scale is
``2 (23.25 * 2^-22 + ds 2^-24)``.  A wider limit flags more rows and stays
sound for either kernel.

The bound for the wide route (route ``"tf32x3_wide"``)
-----------------------------------------------------

Above ``ds = 32`` the f32 kernels run the deep kernel
(``csrc/assign_deep.cuh``), which walks the depth in ``chunks`` chunks of
``kc`` instructions (32 values: ``kc = 4``, which :func:`wide_chunking`
gives at every ``ds`` above 24; the last chunk is padded with zeros, and its
instructions are counted).  The shallow kernel of ``csrc/assign_wide.cuh``
walks the same chunks (``kc = min(4, ceil(ds/8))``, one chunk at ``ds <=
32``), so the bound below is either kernel's.  Each chunk's products start from zero in the
order above (``x_lo.w_hi``, ``x_hi.w_lo``, then ``x_hi.w_hi``) and the chunk's
sum is added to the running sum in one f32 addition.  With ``P_c =
sum_{i in c} |x_i| |w_i|``, every addend and partial sum of chunk ``c`` is at
most ``(1 + 2^-10) P_c``, and the small products' at most ``2^-10 (1 +
2^-11) P_c``:

* the dropped terms, as above: ``3 * 2^-22 |w| |x|`` and second-order terms;
* chunk ``c``'s ``kc`` large-product instructions: ``5 (1 + 2^-10) kc * 2^-22
  P_c``; its ``2 kc`` small-product ones: ``10 * 2^-10 (1 + 2^-11) kc * 2^-22
  P_c``; together below ``(5 + 2^-6) kc * 2^-22 P_c``;
* over the chunks, ``sum_c P_c <= |x| |w|`` (Cauchy-Schwarz), so the
  instructions add ``(5 + 2^-6) kc * 2^-22 |w| |x|`` however deep the row;
* ``chunks - 1`` additions rounded to nearest, each at most ``2^-24 (1 +
  2^-8) |w| |x|``: below ``0.26 chunks * 2^-22 |w| |x|``.

So ``B_w = (3.5 + (5 + 2^-6) kc + 0.26 chunks) 2^-22 max_c|w_c| |x|``, with
``0.5`` set aside for the second-order terms, and the flag limit's scale is
``2 (B_w + B) / |x|`` as before: ``e_j = 2 ((3.5 + (5 + 2^-6) kc + 0.26
chunks) 2^-22 + ds 2^-24) max_c|2c_jc|``.  At ``ds = 768`` that is ``(29.8 +
192) * 2^-22``: the exact path's own ``ds 2^-24`` now dominates.  (A single
accumulator over the whole depth would meet magnitudes near ``|w| |x|`` in
every one of its ``3 ceil(ds/8)`` instructions: ``15 ceil(ds/8) * 2^-22``.)
Both verify kernels take the route of their ``ds`` (:func:`f32_route`), and
so do the plain versions by default: :data:`F32_ROUTE` at 4, 8, 16, 32,
:data:`PAD_ROUTE` at 17 to 24, :data:`WIDE_ROUTE` at every other ``ds``.

What the derivations assume of the hardware (24 kept bits, truncation, at
most ``10 * 2^-23 M`` an instruction) is measured on the card by
:mod:`reductive_tpu_torch.ops.probe` (``chip_smoke.py`` fails without it),
and held to the exact path there: no unflagged row may differ.
"""

from __future__ import annotations

import collections
from typing import NamedTuple

import torch
from torch import Tensor

from ..pq.primitives import check_code_dtype, nearest_centroids, quantize_batch
from . import _build

__all__ = [
    "pq_encode", "pq_encode_reference", "assign_nearest",
    "pq_encode_verified", "pq_encode_verify_reference", "pq_encode_verify_flags",
    "verify_scale", "VERIFY_RHO", "F32_ROUTE", "WIDE_ROUTE", "f32_route", "wide_chunking",
    "flagged_rows", "verify_caps", "verify_tiers", "reset_verify_tiers", "VERIFY_ENCODE_CHUNK",
    "assign_route", "padded_ds", "PAD_ROUTE", "split_tf32", "deep_operands",
    "DEEP_STEP", "deep_producer", "RowMap", "deep_row_map", "TilePlan", "bf16_tile_plan",
]

# The widths the narrow kernels (csrc/assign_tile.cuh) are compiled for; every
# other ds up to 32 runs the instance of padded_ds(ds), every wider ds the
# wide route (csrc/assign_wide.cuh).
_NARROW_DS = (4, 8, 16, 32)
_KERNEL_MAX_K = 65536
# Share of |best| in the flag limit: four roundings of the final subtraction
# at 2^-24 relative each, twice over (see the module docstring).
VERIFY_RHO = 2.0 ** -21
# How the f32 kernels (encode and assign+statistics, one routine at each ds)
# evaluate the cross term: names the flag limit of the verified modes (see
# verify_scale): f32_route(ds).
F32_ROUTE = "tf32x3"
WIDE_ROUTE = "tf32x3_wide"
PAD_ROUTE = "tf32x3_pad"
_ROUTES = ("fma", F32_ROUTE, WIDE_ROUTE, PAD_ROUTE)


def f32_route(ds: int) -> str:
    """The route of the f32 kernels at subvector width ``ds`` (the name of
    their flag limit, :func:`verify_scale`)."""
    if ds in _NARROW_DS:
        return F32_ROUTE
    return PAD_ROUTE if 17 <= ds <= 24 else WIDE_ROUTE


def padded_ds(ds: int) -> int:
    """The width of the narrow instance that takes ``ds`` (1 to 32): the
    least of 4, 8, 16, 32 that is at least ``ds``."""
    if not 1 <= ds <= 32:
        raise ValueError(f"the narrow kernels take ds from 1 to 32, got {ds}")
    return next(w for w in _NARROW_DS if w >= ds)


def wide_chunking(ds: int) -> tuple[int, int]:
    """``(kc, chunks)``: how the wide route walks depth ``ds`` in f32 mode,
    ``chunks`` chunks of ``kc`` instructions of depth 8 (the last chunk
    padded with zeros): the shallow kernel's rule, ``kc = min(4,
    ceil(ds/8))``, which above ``ds = 24`` is the deep kernel's 32-value
    chunk."""
    steps = -(-ds // 8)
    kc = min(4, steps)
    return kc, -(-steps // kc)


# The deep kernel's step by mode: (centroids, values of depth) it takes at a
# time; its codebook is padded to these (csrc/assign_deep.cuh).
DEEP_STEP = {torch.float32: (128, 32), torch.bfloat16: (256, 64)}


def deep_producer(m: int, ds: int) -> str:
    """What brings the deep kernel's rows (``csrc/assign_deep.cuh``
    ``tma_rows``): ``"tma"`` where a row of ``d = m * ds`` f32 values is a
    multiple of 16 bytes (TMA's row stride; :func:`deep_row_map`), else
    ``"cp.async"``, 8-byte copies by the producer warpgroup into the same
    row boxes where every pair of values lies on 8 bytes, else 4-byte ones."""
    return "tma" if m * ds % 4 == 0 else "cp.async"


class RowMap(NamedTuple):
    """The deep kernel's TMA map of ``x`` (``csrc/assign_deep.cuh``
    ``row_map``), 2-D, innermost dimension first."""

    base: int              # x's address rounded down to 16 bytes
    off: int               # floats from base to x's first element
    dims: tuple[int, int]  # (d + off, n)
    stride: int            # bytes from a row to the next: 4 d
    box: tuple[int, int]   # (values, rows): 32 with the 128-byte swizzle, or 36 without
    ds: int

    def column(self, j: int, c: int) -> int:
        """The map's column where the box of subvector ``j``'s chunk ``c``
        (a multiple of 32) starts: rounded down to 4, so on 16 bytes."""
        return (self.off + j * self.ds + c) & ~3

    def shift(self, j: int) -> int:
        """Where subvector ``j``'s chunks start in their boxes (0 to 3; 0
        in boxes of 32)."""
        return (self.off + j * self.ds) & 3


def deep_row_map(address: int, n: int, m: int, ds: int) -> RowMap:
    """The map the deep kernel's TMA producer reads ``x`` through, ``x`` an
    ``(n, m * ds)`` f32 tensor at ``address`` (any multiple of 4): based at
    the address rounded down to 16 bytes, every column shifted by the floats
    in between, so that a row stride of ``4 d`` (a multiple of 16 bytes)
    describes ``x`` at any alignment.  On an H100 a TMA box must start on 16
    bytes, so the box of a chunk starts at the chunk's column rounded down to
    4: where that is every chunk's own column (``off = 0``, ``ds`` a
    multiple of 4) a box is 32 values with the 128-byte swizzle, else 36
    values (no swizzle) holding the chunk at :meth:`RowMap.shift`.  Past
    ``d + off`` and past ``n`` TMA fills zeros;
    the only values a box holds outside ``x`` are the up to 3 floats before
    ``x`` in its storage, at row 0, never read.  The kernel reads a box's
    columns past ``ds`` (the next subvector's) as zero.  Raises
    ``ValueError`` where :func:`deep_producer` is ``"cp.async"``."""
    if deep_producer(m, ds) != "tma" or address % 4:
        raise ValueError(f"TMA takes rows of m*ds = {m * ds} floats at address {address} only "
                         "where both are multiples of 4 (floats, bytes)")
    off = address % 16 // 4
    box = (32 if off == 0 and ds % 4 == 0 else 36, 128)
    return RowMap(address - 4 * off, off, (m * ds + off, n), 4 * m * ds, box, ds)


def assign_route(ds: int, aligned: bool) -> str:
    """The kernel family that assigns at width ``ds``, a pure function of
    ``ds``: ``"narrow"`` (``csrc/assign_tile.cuh``, the instance of
    :func:`padded_ds`) at every ``ds`` up to 32, ``"deep"``
    (``csrc/assign_deep.cuh``) above.  ``aligned`` (``x``'s first element
    on 16 bytes) does not change the answer: the deep kernel takes its rows
    at any alignment (:func:`deep_row_map`), and the C entries pick a narrow
    instance, padded or not, themselves (:func:`_counter` names it).  The
    encode, the statistics and the verified
    wrappers all follow it, so a row gets one code from all of them.  No
    answer is ``"shallow"``: that kernel is taken only where a caller patches
    this function (the tests and ``tools/time_wide_kernels.py``)."""
    return "narrow" if ds <= 32 else "deep"


# The C entries' route argument (csrc/assign_tile.cuh kRouteNarrow, ...).
_ROUTE_CODES = {"narrow": 0, "deep": 1, "shallow": 2}


def _route_of(ds: int, x: Tensor) -> str:
    """:func:`assign_route` for ``x`` (its own address gives ``aligned``)."""
    return assign_route(ds, x.data_ptr() % 16 == 0)


def _counter(name: str, route: str, ds: int, x: Tensor) -> str:
    """The launch count a kernel adds to: ``name`` for the narrow kernels,
    ``name_pad`` for their padded instance (the C entries' rule,
    ``assign_tile::needs_pad``: a ``ds`` outside 4, 8, 16, 32, or rows off
    16 bytes), ``name_wide`` for the deep kernel, ``name_shallow`` for the
    shallow one (a forced route)."""
    if route != "narrow":
        return name + ("_wide" if route == "deep" else "_shallow")
    padded = ds not in _NARROW_DS or x.data_ptr() % 16 != 0
    return name + ("_pad" if padded else "")


# The statistics kernels' grid is P blocks per subquantizer; P comes from the
# shapes alone (never from the card), so that the order of every sum, and with
# it the result's bits, is the same wherever the kernel runs.  The target is
# four waves of two blocks on each of an H100's 132 SMs.
_TARGET_BLOCKS = 1056
_MAX_PARTIAL_ELEMS = 1 << 26  # 256 MB of float32 scratch
_MIN_ROWS_PER_TILE = 256  # no more blocks than 256-row tiles (the kernels' hold 128 to 1,024)


def _blocks_per_subquantizer(n: int, m: int, k: int, ds: int, target: int = _TARGET_BLOCKS) -> int:
    """P for the statistics kernels; ``ds`` is the width of the instance
    (:func:`padded_ds`), whose slots of ``(m, k, ds + 1)`` the scratch holds."""
    tiles = -(-n // _MIN_ROWS_PER_TILE)  # a block without a tile only writes zeros
    by_fill = -(-target // m)
    by_scratch = _MAX_PARTIAL_ELEMS // (m * k * (ds + 1))
    return max(1, min(tiles, by_fill, by_scratch))


class TilePlan(NamedTuple):
    """How a narrow bf16 kernel is launched (:func:`bf16_tile_plan`)."""

    rows: int           # rows of a tile
    blocks: int         # P, blocks per subquantizer
    smem_bytes: int     # dynamic shared memory of a block
    blocks_per_sm: int  # blocks an SM holds (3: 256 threads at <= 80 registers; 2: <= 128)


_CENTROID_TILE = 256  # centroids a narrow kernel stages at a time
# The encode's grid: four waves of the blocks the card holds (a block that ends
# early takes another row tile).
_ENCODE_WAVES = 4


def bf16_tile_plan(n: int, m: int, k: int, ds: int, *, sms: int | None = None) -> TilePlan:
    """The launch plan of the narrow bf16 kernels (``csrc/encode.cu``
    ``encode_bf16_kernel``, ``csrc/stats.cu`` ``stats_bf16_kernel``; ``ds``
    from 1 to 32, planned at its padded width :func:`padded_ds`, the
    instance that runs it): tiles of 512 rows (256 at a width of 32); shared memory
    for the staged centroids (``2c`` in bf16, a depth of 16 per step, and
    ``|c|^2``), two f32 buffers of the rows, a code and a distance per row,
    and for the statistics (``sms=None``) the counting sort's scratch; three
    blocks an SM where their shared memory fits (ds <= 8, with one
    accumulator set a warpgroup), else two.  P: for the statistics a
    function of the shapes alone (:func:`_blocks_per_subquantizer`, its
    target scaled to the blocks an SM holds: the order of the partial sums
    depends on it); for the encode (``sms``, the card's multiprocessors) four
    waves of what the card holds, at most one block per tile.  The C entries
    refuse a plan whose rows or bytes are not the ones they were compiled
    for.  ``k`` and the data never change the rows or the bytes."""
    if not 1 <= ds <= 32:
        raise ValueError(f"the narrow bf16 kernels take ds from 1 to 32, got {ds}")
    ds = padded_ds(ds)
    rows = 256 if ds == 32 else 512
    steps = -(-ds // 16)
    smem = steps * _CENTROID_TILE * 32 + 4 * (_CENTROID_TILE + 2 * rows * ds + 2 * rows)
    per_sm = 3 if ds <= 8 else 2
    if sms is None:
        smem += 4 * (8 * _CENTROID_TILE + _CENTROID_TILE + 8) + 2 * rows  # the counting sort
        blocks = _blocks_per_subquantizer(n, m, k, ds, _TARGET_BLOCKS * per_sm // 2)
    else:
        blocks = max(1, min(-(-n // rows), _ENCODE_WAVES * sms * per_sm // m))
    return TilePlan(rows, blocks, smem, per_sm)


def split_tf32(w: Tensor) -> tuple[Tensor, Tensor]:
    """``(hi, lo)``: f32 tensors of TF32 values with ``w = hi + lo + r``.
    ``hi`` is ``w`` rounded to TF32 to nearest, ties away from zero (the rule
    of ``cvt.rna.tf32.f32``: the 13 low bits of the f32 pattern become zero),
    ``lo`` the rest ``w - hi`` (exact in f32) rounded the same way: the bits
    of ``assign_tile::split_tf32``, in tensor operations."""
    def rna(v: Tensor) -> Tensor:
        bits = v.contiguous().view(torch.int32)
        return ((bits + 0x1000) & -0x2000).view(torch.float32)

    hi = rna(w.to(torch.float32))
    return hi, rna(w - hi)


def deep_operands(cb2: Tensor, c_sqn: Tensor, compute_dtype) -> tuple[Tensor, Tensor]:
    """The deep kernel's codebook, converted once a call into the layout its
    TMA loads: ``(w, norms)``.  bf16 mode: ``w`` ``(m, k, dsp)`` bfloat16
    holding ``2c``; f32 mode: ``w`` ``(2, m, k, dsp)`` f32 holding the TF32
    parts of ``2c`` (:func:`split_tf32`), hi then lo.  The depth is padded
    with zeros to ``dsp``, a multiple of the step's depth (:data:`DEEP_STEP`);
    ``norms`` ``(m, kp)`` holds ``|c|^2`` and ``+inf`` past ``k`` up to a
    multiple of the step's centroids, so a padded centroid never wins.
    ``cb2``, ``c_sqn``: :func:`_prepare`'s (``cb2`` already rounded to
    bfloat16 values in bf16 mode, so the cast is exact)."""
    m, k, ds = cb2.shape
    cols, depth = DEEP_STEP[compute_dtype]
    dsp = -(-ds // depth) * depth
    if compute_dtype == torch.bfloat16:
        w = torch.zeros((m, k, dsp), dtype=torch.bfloat16, device=cb2.device)
        w[:, :, :ds] = cb2
    else:
        w = torch.zeros((2, m, k, dsp), dtype=torch.float32, device=cb2.device)
        w[0, :, :, :ds], w[1, :, :, :ds] = split_tf32(cb2)
    norms = torch.full((m, -(-k // cols) * cols), float("inf"), dtype=torch.float32,
                       device=cb2.device)
    norms[:, :k] = c_sqn
    return w, norms


def _route_operands(cb2: Tensor, c_sqn: Tensor, x: Tensor, compute_dtype):
    """``(cb2, c_sqn, route)`` as the C entries take them for ``x``:
    :func:`assign_route`'s answer, with the deep kernel's converted operands
    where it is ``"deep"``."""
    route = _route_of(cb2.shape[2], x)
    if route != "deep":
        return cb2, c_sqn, route
    return (*deep_operands(cb2, c_sqn, compute_dtype), route)


def _check_k(m: int, k: int, ds: int, what: str,
             hint: str = "use reductive_tpu_torch.pq.primitives.quantize_batch") -> None:
    if k > _KERNEL_MAX_K:
        raise ValueError(
            f"the {what} kernel takes k <= {_KERNEL_MAX_K}; got m={m}, k={k}, ds={ds} ({hint})"
        )


def _prepare(codebooks: Tensor, x: Tensor, dtype, compute_dtype):
    check_code_dtype(codebooks, dtype)
    if compute_dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"compute_dtype must be torch.float32 or torch.bfloat16, got {compute_dtype}")
    m, k, ds = codebooks.shape
    if x.ndim != 2 or x.shape[1] != m * ds:
        raise ValueError(
            f"Quantizer and vector length mismatch: input has {x.shape[-1]} columns, "
            f"quantizer reconstructs {m * ds}"
        )
    if codebooks.dtype != torch.float32 or x.dtype != torch.float32:
        raise TypeError(
            f"pq_encode takes float32 codebooks and vectors, got {codebooks.dtype} and {x.dtype}"
        )
    if codebooks.device != x.device:
        raise ValueError(f"codebooks on {codebooks.device}, x on {x.device}")
    c_sqn = torch.einsum("mkd,mkd->mk", codebooks, codebooks)
    cb2 = codebooks + codebooks
    if compute_dtype == torch.bfloat16:
        cb2 = cb2.to(torch.bfloat16).to(torch.float32)
    return cb2.contiguous(), c_sqn.contiguous()


def pq_encode_reference(
    codebooks: Tensor, x: Tensor, *, dtype: torch.dtype = torch.uint8,
    compute_dtype: torch.dtype = torch.bfloat16,
) -> Tensor:
    """Plain PyTorch version of :func:`pq_encode`: the same arithmetic in
    tensor operations, on whatever device the tensors lie."""
    cb2, c_sqn = _prepare(codebooks, x, dtype, compute_dtype)
    if compute_dtype == torch.bfloat16:
        x = x.to(torch.bfloat16).to(torch.float32)
    m, _, ds = codebooks.shape
    return nearest_centroids(cb2, c_sqn, x.reshape(x.shape[0], m, ds)).to(dtype)


def pq_encode(
    codebooks: Tensor, x: Tensor, *, dtype: torch.dtype = torch.uint8,
    compute_dtype: torch.dtype = torch.bfloat16, out: Tensor | None = None,
) -> Tensor:
    """Encode ``(n, d)`` vectors to ``(n, m)`` codes of ``dtype``.

    CUDA tensors go through the kernel (any ``ds``, ``k <= 65536``; a larger
    ``k`` raises) that :func:`assign_route` names: the narrow kernels at every
    ``ds`` up to 32, the deep kernel (``csrc/assign_deep.cuh``) above.  CPU
    tensors go
    through :func:`pq_encode_reference`.  The kernel writes ``uint8`` or ``int32``
    codes; other integer dtypes are cast from ``int32`` at the end.  ``out``,
    an ``(n, m)`` tensor of ``dtype`` on the same device, receives the codes
    and is returned.
    """
    cb2, c_sqn = _prepare(codebooks, x, dtype, compute_dtype)
    n = x.shape[0]
    m, k, ds = codebooks.shape
    if out is not None and (out.shape != (n, m) or out.dtype != dtype or out.device != x.device):
        raise ValueError(
            f"out must be a {(n, m)} tensor of {dtype} on {x.device}, "
            f"got {tuple(out.shape)} of {out.dtype} on {out.device}"
        )
    if not x.is_cuda:
        codes = pq_encode_reference(codebooks, x, dtype=dtype, compute_dtype=compute_dtype)
        return codes if out is None else out.copy_(codes)

    _check_k(m, k, ds, "encode")
    x = x.contiguous()
    direct = dtype in (torch.uint8, torch.int32)
    if direct and out is not None and out.is_contiguous():
        raw = out
    else:
        raw = torch.empty((n, m), dtype=dtype if direct else torch.int32, device=x.device)
    bf16 = compute_dtype == torch.bfloat16
    out_u8 = int(raw.dtype == torch.uint8)
    cb2, c_sqn, route = _route_operands(cb2, c_sqn, x, compute_dtype)
    counter = _counter("encode_bf16" if bf16 else "encode_f32", route, ds, x)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        if bf16 and route == "narrow":
            sms = torch.cuda.get_device_properties(x.device).multi_processor_count
            plan = bf16_tile_plan(n, m, k, ds, sms=sms)
            _build.launch(
                "rt_encode_bf16", counter,
                x.data_ptr(), cb2.data_ptr(), c_sqn.data_ptr(), raw.data_ptr(),
                n, m, k, ds, out_u8, plan.rows, plan.blocks, plan.smem_bytes, stream,
            )
        else:
            _build.launch(
                "rt_encode", counter,
                x.data_ptr(), cb2.data_ptr(), c_sqn.data_ptr(), raw.data_ptr(),
                n, m, k, ds, int(bf16), out_u8, _ROUTE_CODES[route], stream,
            )
    if out is None:
        return raw if direct else raw.to(dtype)
    return out if raw is out else out.copy_(raw)


def assign_nearest(
    centroids: Tensor, x: Tensor, *, compute_dtype: torch.dtype = torch.bfloat16
) -> Tensor:
    """Nearest-centroid assignment (the k-means assign step): PQ encode with
    a single subquantizer.  Returns ``(n,)`` int32."""
    return pq_encode(centroids[None, :, :], x, dtype=torch.int32, compute_dtype=compute_dtype)[:, 0]


def verify_scale(
    codebooks: Tensor, scale: float | None = None, *, route: str | None = None
) -> Tensor:
    """``e_j = scale * max_c |2 c_jc|`` as ``(m,)`` f32: the flag limit's
    share of ``|x_j|``.  ``scale=None`` is the sound choice for the route's
    arithmetic (see the module docstring):
    ``2 * ((3.25 + 5 * ceil(ds / 8)) * 2^-22 + ds * 2^-24)`` for
    ``route="tf32x3"`` (the narrow f32 kernels' split product,
    :data:`F32_ROUTE`),
    ``2 * ((3.5 + (5 + 2^-6) * kc + 0.26 * chunks) * 2^-22 + ds * 2^-24)``
    with ``kc, chunks = wide_chunking(ds)`` for ``route="tf32x3_wide"`` (the
    wide route's, :data:`WIDE_ROUTE`), the larger of the ``"tf32x3"`` count
    at ``padded_ds(ds) / 8`` instructions and the ``"tf32x3_wide"`` one for
    ``route="tf32x3_pad"`` (the padded narrow kernels at 17 to 24,
    :data:`PAD_ROUTE`; ``ds <= 32``),
    ``4 * ds * 2^-24`` for ``route="fma"`` (a chain of f32 FMAs, the first
    step of the derivation).  ``route=None`` is the route the f32 kernels
    take at this ``ds`` (:func:`f32_route`)."""
    ds = codebooks.shape[2]
    if route is None:
        route = f32_route(ds)
    if route not in _ROUTES:
        raise ValueError(f"route must be one of {_ROUTES}, got {route!r}")
    if scale is None:
        kc, chunks = wide_chunking(ds)
        wide = 3.5 + (5.0 + 2.0 ** -6) * kc + 0.26 * chunks
        if route == "fma":
            scale = 4.0 * ds * 2.0 ** -24
        elif route == F32_ROUTE:
            scale = 2.0 * ((3.25 + 5.0 * -(-ds // 8)) * 2.0 ** -22 + ds * 2.0 ** -24)
        elif route == PAD_ROUTE:
            tile = 3.25 + 5.0 * (padded_ds(ds) // 8)
            scale = 2.0 * (max(tile, wide) * 2.0 ** -22 + ds * 2.0 ** -24)
        else:
            scale = 2.0 * (wide * 2.0 ** -22 + ds * 2.0 ** -24)
    cn = torch.sqrt(torch.einsum("mkd,mkd->mk", codebooks, codebooks))
    return (scale * 2.0 * cn.amax(dim=1)).to(torch.float32).contiguous()


def _verify_flags(dist: Tensor, xs: Tensor, escale: Tensor, rho: float):
    """Codes ``(n, m)`` int64 and per-(row, subquantizer) flags from a
    distance tensor ``(n, m, k)``: the first minimum, the least distance over
    all other indices, and the margin test of the kernel."""
    idx = torch.argmin(dist, dim=2)  # the first minimum
    best = torch.gather(dist, 2, idx[:, :, None])[:, :, 0]
    others = dist.scatter(2, idx[:, :, None], float("inf"))
    margin = others.amin(dim=2) - best
    xn = torch.sqrt(torch.sum(xs * xs, dim=2))
    limit = 2.0 * escale[None, :] * xn + rho * best.abs()
    return idx, ~(margin > limit)


def pq_encode_verify_reference(
    codebooks: Tensor, x: Tensor, *, dtype: torch.dtype = torch.uint8,
    escale: Tensor | None = None, rho: float = VERIFY_RHO,
) -> tuple[Tensor, Tensor]:
    """Plain PyTorch version of the verify kernel: ``(codes (n, m) of dtype,
    flags (n,) int32)``.  The f32 distances of :func:`pq_encode_reference`,
    their first minimum, the least distance over all *other* indices (a
    duplicate of the best counts) and the margin test.  ``escale`` defaults to
    the kernel's, ``verify_scale(codebooks)`` (the route of the kernels at
    this ``ds``)."""
    cb2, c_sqn = _prepare(codebooks, x, dtype, torch.float32)
    m, k, ds = codebooks.shape
    if escale is None:
        escale = verify_scale(codebooks)
    n = x.shape[0]
    codes = torch.empty((n, m), dtype=dtype, device=x.device)
    flags = torch.empty((n,), dtype=torch.int32, device=x.device)
    step = max(1, (1 << 24) // (m * k))
    for i in range(0, n, step):
        xs = x[i:i + step].reshape(-1, m, ds)
        dist = c_sqn[None] - torch.einsum("nmd,mkd->nmk", xs, cb2)
        idx, flagged = _verify_flags(dist, xs, escale, rho)
        codes[i:i + step] = idx.to(dtype)
        flags[i:i + step] = flagged.any(dim=1).to(torch.int32)
    return codes, flags


# Rows a chunk of the verified encode's exact re-encode, as the JAX package
# walks them; its cap is rounded up to whole chunks of this size.
VERIFY_ENCODE_CHUNK = 16384

_tiers: collections.Counter = collections.Counter()


def verify_caps(n: int, cap_frac: float, chunk: int) -> tuple[int, int]:
    """``(cap, cap2)``: the JAX package's two tiers of flagged rows for a
    verified call over ``n`` rows.  ``cap`` is ``cap_frac`` of the rows
    rounded up to whole chunks (at least one chunk, at most ``n``), ``cap2``
    four times that (at most ``n``).  Up to ``cap2`` flagged rows only the
    flagged rows are computed again by the exact path; above it everything."""
    cap = min(max(chunk, -(-int(n * cap_frac) // chunk) * chunk), n)
    return cap, min(4 * cap, n)


def verify_tiers() -> dict[tuple[str, str], int]:
    """How often each verified wrapper (``"encode"``, ``"stats"``) took each
    tier (``"cap"``, ``"cap2"``, ``"exact"``) since the last reset."""
    return dict(_tiers)


def reset_verify_tiers() -> None:
    _tiers.clear()


def flagged_rows(flags: Tensor, cap_frac: float, chunk: int, wrapper: str) -> Tensor | None:
    """Indices of the flagged rows (``torch.nonzero``: the host waits for the
    device here), or ``None`` when more than ``cap2`` of :func:`verify_caps`
    are flagged and everything is to be computed by the exact path.  Counts
    the tier taken under ``wrapper`` (:func:`verify_tiers`).  The JAX package
    pads the flagged rows to ``cap`` or ``cap2`` rows for its static shapes;
    here they are taken as they are, at both tiers, with the same result."""
    idx = torch.nonzero(flags)[:, 0]
    cap, cap2 = verify_caps(flags.shape[0], cap_frac, chunk)
    count = idx.shape[0]
    tier = "cap" if count <= cap else "cap2" if count <= cap2 else "exact"
    _tiers[(wrapper, tier)] += 1
    return None if tier == "exact" else idx


def pq_encode_verify_flags(
    codebooks: Tensor, x: Tensor, *, dtype: torch.dtype = torch.uint8,
    escale: Tensor | None = None, rho: float = VERIFY_RHO,
) -> tuple[Tensor, Tensor]:
    """The first stage of :func:`pq_encode_verified`: ``(codes, flags)`` from
    the verify kernel (CUDA tensors; any ``ds``, ``k <= 65536``, a larger
    ``k`` raises) or from :func:`pq_encode_verify_reference` (CPU tensors).
    ``escale`` defaults to ``verify_scale(codebooks)``, the statistics
    kernel's at this ``ds``."""
    if not x.is_cuda:
        return pq_encode_verify_reference(codebooks, x, dtype=dtype, escale=escale, rho=rho)
    cb2, c_sqn = _prepare(codebooks, x, dtype, torch.float32)
    m, k, ds = codebooks.shape
    _check_k(m, k, ds, "encode")
    n = x.shape[0]
    x = x.contiguous()
    if escale is None:
        escale = verify_scale(codebooks)
    escale = escale.contiguous()
    direct = dtype in (torch.uint8, torch.int32)
    raw = torch.empty((n, m), dtype=dtype if direct else torch.int32, device=x.device)
    flags = torch.zeros((n,), dtype=torch.int32, device=x.device)  # the kernel ORs into it
    cb2, c_sqn, route = _route_operands(cb2, c_sqn, x, torch.float32)
    with torch.cuda.device(x.device):
        _build.launch(
            "rt_encode_verify", _counter("encode_verify", route, ds, x),
            x.data_ptr(), cb2.data_ptr(), c_sqn.data_ptr(), raw.data_ptr(),
            escale.data_ptr(), float(rho), flags.data_ptr(),
            n, m, k, ds, int(raw.dtype == torch.uint8), _ROUTE_CODES[route],
            torch.cuda.current_stream().cuda_stream,
        )
    return (raw if direct else raw.to(dtype)), flags


def pq_encode_verified(
    codebooks: Tensor, x: Tensor, *, dtype: torch.dtype = torch.uint8,
    cap_frac: float = 1 / 16,
) -> Tensor:
    """Encode ``(n, d)`` vectors to ``(n, m)`` codes that equal
    :func:`~reductive_tpu_torch.pq.primitives.quantize_batch` on every entry,
    first-index tie-breaks included, at near the f32 kernel's speed.

    The verify kernel encodes and flags every row where rounding could have
    changed an argmin (a sound bound for the split product, see the module
    docstring; the same flags as the statistics kernel's); the flagged
    rows are gathered, encoded again by the exact path (which walks them in
    chunks: 16,384 rows at m=16, k=256) and written back by index.  Finding
    them is a ``torch.nonzero``: the host waits for the device once per call.
    Above ``cap2`` flagged rows (:func:`verify_caps` with chunks of
    :data:`VERIFY_ENCODE_CHUNK` rows: ``cap_frac`` of the rows rounded up to
    whole chunks, times four; data full of near-ties) everything is encoded by
    the exact path instead of gathered, so the result is right at any flag rate.

    CUDA tensors go through the kernel (any ``ds``, ``k <= 65536``; a larger
    ``k`` raises); CPU tensors through :func:`pq_encode_verify_reference`.
    """
    codes, flags = pq_encode_verify_flags(codebooks, x, dtype=dtype)
    idx = flagged_rows(flags, cap_frac, VERIFY_ENCODE_CHUNK, "encode")
    if idx is None:
        return quantize_batch(codebooks, x, dtype=dtype)
    if idx.shape[0]:
        codes[idx] = quantize_batch(codebooks, x[idx], dtype=dtype, batch=x.shape[0])
    return codes
