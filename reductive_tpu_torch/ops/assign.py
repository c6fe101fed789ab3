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
  That is at ``ds`` in 4, 8, 16, 32; every other ``ds`` takes the wide route
  (``csrc/assign_wide.cuh``, route :data:`WIDE_ROUTE`): the same split,
  walked over the depth in chunks, each chunk's products from zero and the
  chunks added in f32, shared by the encode and the statistics kernel in the
  same way.
* ``torch.bfloat16`` (default): ``x`` and ``2c`` each rounded to bfloat16
  (nearest even), products and sums in f32, ``|c|^2`` in f32 from the
  unrounded codebook.  The narrow kernel runs this mode on the tensor cores
  and starts each sum at ``-|c|^2`` (it maximizes ``2c.x - |c|^2``), which is
  the same number up to f32 rounding; the wide route sums the products from
  zero and subtracts them from ``|c|^2``.

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

The bound for the wide route (route ``"tf32x3_wide"``)
-----------------------------------------------------

At every other ``ds`` the f32 kernels run ``csrc/assign_wide.cuh``, which
walks the depth in ``chunks`` chunks of ``kc`` instructions (``kc =
min(4, ceil(ds/8))``; the last chunk is padded with zeros, and its
instructions are counted).  Each chunk's products start from zero in the
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
so do the plain versions by default.

What the derivations assume of the hardware (24 kept bits, truncation, at
most ``10 * 2^-23 M`` an instruction) is measured on the card by
:mod:`reductive_tpu_torch.ops.probe` (``chip_smoke.py`` fails without it),
and held to the exact path there: no unflagged row may differ.
"""

from __future__ import annotations

import torch
from torch import Tensor

from ..pq.primitives import check_code_dtype, nearest_centroids, quantize_batch
from . import _build

__all__ = [
    "pq_encode", "pq_encode_reference", "assign_nearest",
    "pq_encode_verified", "pq_encode_verify_reference", "pq_encode_verify_flags",
    "verify_scale", "VERIFY_RHO", "F32_ROUTE", "WIDE_ROUTE", "f32_route", "wide_chunking",
    "flagged_rows",
]

# The widths of the narrow kernels (csrc/assign_tile.cuh); every other ds >= 1
# takes the wide route (csrc/assign_wide.cuh).
_NARROW_DS = (4, 8, 16, 32)
_KERNEL_MAX_K = 65536
# Share of |best| in the flag limit: four roundings of the final subtraction
# at 2^-24 relative each, twice over (see the module docstring).
VERIFY_RHO = 2.0 ** -21
# How the f32 kernels (encode and assign+statistics, one routine at each ds)
# evaluate the cross term: names the flag limit of the verified modes (see
# verify_scale).  F32_ROUTE at the narrow widths, WIDE_ROUTE at every other.
F32_ROUTE = "tf32x3"
WIDE_ROUTE = "tf32x3_wide"
_ROUTES = ("fma", F32_ROUTE, WIDE_ROUTE)


def f32_route(ds: int) -> str:
    """The route of the f32 kernels at subvector width ``ds``."""
    return F32_ROUTE if ds in _NARROW_DS else WIDE_ROUTE


def wide_chunking(ds: int) -> tuple[int, int]:
    """``(kc, chunks)``: how ``csrc/assign_wide.cuh`` walks depth ``ds`` in f32
    mode, ``chunks`` chunks of ``kc`` instructions of depth 8 (the last chunk
    padded with zeros)."""
    steps = -(-ds // 8)
    kc = min(4, steps)
    return kc, -(-steps // kc)


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
    ``k`` raises): the narrow kernels at ``ds`` in 4, 8, 16, 32, the wide
    route (``csrc/assign_wide.cuh``) at every other ``ds``.  CPU tensors go
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
    counter = ("encode_bf16" if bf16 else "encode_f32") + ("" if ds in _NARROW_DS else "_wide")
    with torch.cuda.device(x.device):
        _build.launch(
            "rt_encode", counter,
            x.data_ptr(), cb2.data_ptr(), c_sqn.data_ptr(), raw.data_ptr(),
            n, m, k, ds, int(bf16), int(raw.dtype == torch.uint8),
            torch.cuda.current_stream().cuda_stream,
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
    wide route's, :data:`WIDE_ROUTE`),
    ``4 * ds * 2^-24`` for ``route="fma"`` (a chain of f32 FMAs, the first
    step of the derivation).  ``route=None`` is the route the f32 kernels
    take at this ``ds`` (:func:`f32_route`)."""
    ds = codebooks.shape[2]
    if route is None:
        route = f32_route(ds)
    if route not in _ROUTES:
        raise ValueError(f"route must be one of {_ROUTES}, got {route!r}")
    if scale is None:
        if route == "fma":
            scale = 4.0 * ds * 2.0 ** -24
        elif route == F32_ROUTE:
            scale = 2.0 * ((3.25 + 5.0 * -(-ds // 8)) * 2.0 ** -22 + ds * 2.0 ** -24)
        else:
            kc, chunks = wide_chunking(ds)
            scale = 2.0 * ((3.5 + (5.0 + 2.0 ** -6) * kc + 0.26 * chunks) * 2.0 ** -22
                           + ds * 2.0 ** -24)
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


def flagged_rows(flags: Tensor, cap_frac: float) -> Tensor | None:
    """Indices of the flagged rows (``torch.nonzero``: the host waits for the
    device here), or ``None`` when more than ``cap_frac`` of the rows are
    flagged and everything is to be computed by the exact path."""
    idx = torch.nonzero(flags)[:, 0]
    if idx.shape[0] > cap_frac * flags.shape[0]:
        return None
    return idx


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
    with torch.cuda.device(x.device):
        _build.launch(
            "rt_encode_verify", "encode_verify" + ("" if ds in _NARROW_DS else "_wide"),
            x.data_ptr(), cb2.data_ptr(), c_sqn.data_ptr(), raw.data_ptr(),
            escale.data_ptr(), float(rho), flags.data_ptr(),
            n, m, k, ds, int(raw.dtype == torch.uint8),
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
    Above ``cap_frac`` of the rows
    flagged (data full of near-ties) everything is encoded by the exact path
    instead of gathered, so the result is right at any flag rate.

    CUDA tensors go through the kernel (any ``ds``, ``k <= 65536``; a larger
    ``k`` raises); CPU tensors through :func:`pq_encode_verify_reference`.
    """
    codes, flags = pq_encode_verify_flags(codebooks, x, dtype=dtype)
    idx = flagged_rows(flags, cap_frac)
    if idx is None:
        return quantize_batch(codebooks, x, dtype=dtype)
    if idx.shape[0]:
        codes[idx] = quantize_batch(codebooks, x[idx], dtype=dtype)
    return codes
