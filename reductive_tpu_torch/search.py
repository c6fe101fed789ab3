"""ADC (asymmetric distance computation) search over PQ-encoded corpora.

Counterpart of ``reductive_tpu.search``: distances from a query to millions
of compressed vectors are computed from per-subquantizer lookup tables
without reconstructing anything (Jégou et al., 2011, §IV).

All functions honor the quantizer's projection: queries are rotated into
codebook space first (codes were produced there too), and Euclidean
distances and inner products are preserved because the projection is
orthonormal.  Matrix products are float32.

Top-k order: results are sorted ascending by score, and among equal scores
by ascending index; of several rows tied exactly at the k-th score the lowest
indices are kept.  That is what the JAX package's ``top_k`` gives, and what
lets :func:`search_sharded` (the corpus sharded over the ranks of a device
mesh, one process a card) merge the ranks' results into :func:`search`'s.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch
from torch import Tensor

from ._collectives import all_gather_rows
from ._precision import check_precision
from .pq import primitives
from .pq.model import Pq, _on_device
from .utils.profiling import span

__all__ = ["adc_tables", "adc_scores", "adc_scores_decode", "search", "search_sharded"]

# search() switches to the streamed scorer when the full (nq, n) score
# matrix would exceed this many f32 elements (64M = 256 MB).
_STREAM_SCORE_ELEMS = 64 * (1 << 20)
_DEFAULT_STREAM_CHUNK = 1 << 20


def _resolve_stream_chunk(
    nq: int, n: int, stream_chunk: Optional[int], method: str = "einsum", d: int = 0,
) -> Optional[int]:
    """The effective streaming chunk: the caller's explicit choice, or the
    default chunk when the dense intermediates would be too large, or
    None (dense path) otherwise.  ``method="decode"`` additionally bounds
    the ``(n, d)`` f32 reconstruction it materializes."""
    if stream_chunk is not None:
        return stream_chunk
    # The per-chunk (nq, chunk) score transient is bounded by the same
    # budget that triggers streaming.
    chunk = min(_DEFAULT_STREAM_CHUNK, max(1 << 16, _STREAM_SCORE_ELEMS // max(nq, 1)))
    if nq * n > _STREAM_SCORE_ELEMS:
        return min(chunk, n)
    if method == "decode" and n * d > _STREAM_SCORE_ELEMS:
        return min(chunk, n)
    return None


def _check_metric(metric: str) -> None:
    if metric not in ("l2", "dot"):
        raise ValueError(f"unknown metric {metric!r} (expected 'l2' or 'dot')")


def adc_tables(pq: Pq, queries: Tensor, *, metric: str = "l2", precision="highest") -> Tensor:
    """Per-query lookup tables, ``(nq, m, k)``.

    With ``metric="l2"`` (default) entry ``[q, j, c]`` is the squared
    Euclidean distance between subvector ``j`` of (rotated) query ``q`` and
    centroid ``c`` of subquantizer ``j``; summed over ``j`` that is the
    exact squared distance to the reconstruction.  With ``metric="dot"`` the
    entry is the **negated** inner product, so ascending score order ranks
    by descending inner product and every top-k downstream works unchanged.
    ``precision`` takes ``"highest"`` only (the JAX package's keyword).
    """
    _check_metric(metric)
    check_precision(precision)
    if queries.ndim != 2:
        raise ValueError(f"queries must be (nq, d), got {tuple(queries.shape)}")
    codebooks = pq.codebooks
    m, k, ds = codebooks.shape
    if queries.shape[1] != m * ds:
        raise ValueError(
            f"query length {queries.shape[1]} does not match quantizer "
            f"reconstructed length {m * ds}"
        )
    if pq.projection is not None:
        queries = torch.matmul(queries, pq.projection)
    qs = queries.reshape(-1, m, ds)
    cross = torch.einsum("qmd,mkd->qmk", qs, codebooks)
    if metric == "dot":
        return -cross
    q_sqn = torch.einsum("qmd,qmd->qm", qs, qs)
    c_sqn = torch.einsum("mkd,mkd->mk", codebooks, codebooks)
    return q_sqn[:, :, None] + c_sqn[None, :, :] - (cross + cross)


def adc_scores(tables: Tensor, codes: Tensor, *, chunk_size: int = 16384) -> Tensor:
    """Approximate squared distances from each query to each encoded vector,
    in plain tensor code with f32 tables (the library's exact scorer; the
    JAX package calls it the einsum scorer).

    ``tables`` is ``(nq, m, k)`` from :func:`adc_tables`; ``codes`` is the
    ``(n, m)`` encoded corpus.  Returns ``(nq, n)``.  The JAX package
    multiplies each table with a one-hot matrix; that product has one
    nonzero term, so it is the table entry itself, and here it is looked up.
    The ``m`` entries are added in the same order, ``j = 0..m-1``.  The
    corpus is walked in ``chunk_size`` blocks to bound the index transient.
    """
    nq, m, k = tables.shape
    n = codes.shape[0]
    if codes.shape[1] != m:
        raise ValueError(f"codes have {codes.shape[1]} subquantizers, tables have {m}")
    scores = torch.empty((nq, n), dtype=tables.dtype, device=tables.device)
    for i in range(0, n, chunk_size):
        idx = codes[i:i + chunk_size].to(torch.int64)
        acc = torch.zeros((nq, idx.shape[0]), dtype=tables.dtype, device=tables.device)
        for j in range(m):
            acc = acc + tables[:, j, idx[:, j]]
        scores[:, i:i + chunk_size] = acc
    return scores


def adc_scores_decode(
    pq: Pq, queries: Tensor, codes: Tensor, *, splits=1, use_kernel: bool = True,
    metric: str = "l2",
) -> Tensor:
    """``(nq, n)`` approximate squared distances via decode + one dense
    product: ``|q - rec|^2 = |q|^2 + |rec|^2 - 2 q.rec``.

    It wins over the table scorer only when the query batch is large
    (``nq`` of the order of ``d``), where the decode amortizes.  ``splits``
    forwards to the decode kernel.  ``q.rec`` is an fp32 ``torch.matmul``
    (the JAX package leaves that product at its backend's default precision,
    which is f32 on the CPU).
    """
    cb = pq.codebooks
    qr = torch.matmul(queries, pq.projection) if pq.projection is not None else queries
    if use_kernel:
        from .ops.decode import pq_decode

        rec = pq_decode(cb, codes, splits=splits)  # rotated space
    else:
        rec = primitives.reconstruct_batch(cb, codes, method="gather")
    qrec = torch.matmul(qr.to(torch.float32), rec.to(torch.float32).T)
    if metric == "dot":
        return -qrec
    rec_sqn = torch.sum(rec.to(torch.float32) ** 2, dim=1)  # (n,)
    q_sqn = torch.sum(qr.to(torch.float32) ** 2, dim=1)     # (nq,)
    return q_sqn[:, None] + rec_sqn[None, :] - 2.0 * qrec


# _smallest takes rows up to this long by one stable sort; longer rows by
# torch.topk and a repair of the ties at the k-th place, found block by block.
_SORT_ROW = 2048
_TIE_BLOCK = 256


def _smallest(scores: Tensor, idx: Optional[Tensor], top_k: int) -> Tuple[Tensor, Tensor]:
    """The ``top_k`` smallest of each row of ``scores`` with their ids
    (column positions, or ``idx`` gathered at them where given), ascending by
    score and, among equal scores, by position: of the scores tied at the
    k-th place the lowest positions are kept, as ``jax.lax.top_k`` keeps them.
    No wait for the card, and the same result every time."""
    k = min(top_k, scores.shape[1])
    if scores.shape[1] <= _SORT_ROW:
        vals, pos = torch.sort(scores, dim=1, stable=True)
        vals, pos = vals[:, :k], pos[:, :k]
    else:
        vals, pos = _smallest_long(scores, k)
    return vals, pos if idx is None else torch.gather(idx, 1, pos)


def _smallest_long(scores: Tensor, k: int) -> Tuple[Tensor, Tensor]:
    """:func:`_smallest` of long rows.  ``torch.topk`` gives the k-th
    smallest score ``thr`` and every score below it; which of the scores
    equal to ``thr`` it keeps is its own choice.  The ``need`` of them that
    belong to the result are the first ones by position.  They lie in the
    first ``need`` blocks of ``_TIE_BLOCK`` columns that hold a tie, so among
    the first ``2k - 1`` blocks whose minimum is at most ``thr`` (at most
    ``k - 1`` more hold a score below it): those blocks are gathered and a
    running count over their ties keeps the first ``need``.  One pass over
    the scores (the blocks' minima) besides ``torch.topk``.  A block whose
    minimum is NaN is gathered too; a row where fewer than ``k`` are found
    (NaN blocks in the way, or a NaN ``thr``) keeps ``torch.topk``'s
    choice."""
    nq, n = scores.shape
    dev = scores.device
    b = _TIE_BLOCK
    vals, sel = torch.topk(scores, k, dim=1, largest=False)
    thr = vals[:, k - 1:]
    below = vals < thr
    need = k - below.sum(dim=1, keepdim=True)
    with span("select.repair"):
        main = n // b * b
        low = scores[:, :main].view(nq, main // b, b).amin(dim=2)
        if main < n:
            low = torch.cat([low, scores[:, main:].amin(dim=1, keepdim=True)], dim=1)
        nb = low.shape[1]
        blocks = torch.arange(nb, device=dev).masked_fill(low > thr, nb)
        first = torch.topk(blocks, min(2 * k - 1, nb), dim=1, largest=False).values
        # Positions of those blocks' columns; a missing block (nb) lies past n.
        at = (first[:, :, None] * b + torch.arange(b, device=dev)).reshape(nq, -1)
        tied = (torch.gather(scores, 1, at.clamp(max=n - 1)) == thr) & (at < n)
        take = tied & (torch.cumsum(tied, dim=1, dtype=torch.int32) <= need)
        keys = torch.cat([sel.masked_fill(~below, n), at.masked_fill(~take, n)], dim=1)
        pos = torch.topk(keys, k, dim=1, largest=False).values  # the k kept, by position
        pos = torch.where((pos < n).all(dim=1, keepdim=True), pos, torch.sort(sel, dim=1).values)
        vals, order = torch.sort(torch.gather(scores, 1, pos), dim=1, stable=True)
        return vals, torch.gather(pos, 1, order)


def _scores(pq, tables, queries, codes, chunk_size, method, splits, packed, metric) -> Tensor:
    with span("search.adc"):
        if method == "kernel":
            from .ops.adc import adc_scores_kernel

            return adc_scores_kernel(tables, codes, splits=splits, packed=packed)
        if method == "decode":
            return adc_scores_decode(
                pq, queries, codes, splits=splits, use_kernel=codes.is_cuda, metric=metric,
            )
        return adc_scores(tables, codes, chunk_size=chunk_size)


def _select(scores: Tensor, top_k: int) -> Tuple[Tensor, Tensor]:
    """:func:`_smallest` of one chunk's scores."""
    with span("search.select"):
        return _smallest(scores, None, top_k)


def _search_one(
    pq: Pq, queries: Tensor, codes: Tensor, top_k: int, chunk: Optional[int],
    chunk_size: int, method: str, splits, packed: bool, metric: str,
) -> Tuple[Tensor, Tensor]:
    """Dense search (``chunk`` None), or streamed: a loop over corpus chunks
    keeps only a running ``(nq, top_k)`` best-so-far, so memory is
    O(nq * (chunk + top_k)) whatever the corpus size."""
    tables = None
    if method != "decode":
        with span("search.tables"):
            tables = adc_tables(pq, queries, metric=metric)
    n = codes.shape[0]
    if chunk is None:
        scores = _scores(pq, tables, queries, codes, chunk_size, method, splits, packed, metric)
        return _select(scores, top_k)
    best_d = best_i = None
    for start in range(0, n, chunk):
        part = codes[start:start + chunk]
        d, i = _select(
            _scores(pq, tables, queries, part, chunk_size, method, splits, packed, metric), top_k
        )
        i = i + start
        if best_d is not None:
            with span("search.merge"):
                d, i = _smallest(torch.cat([best_d, d], dim=1), torch.cat([best_i, i], dim=1),
                                 top_k)
        best_d, best_i = d, i
    return best_d, best_i


def _is_reader(corpus) -> bool:
    """A corpus given as a reader (anything with ``read`` and no ``shape``,
    such as :class:`reductive_tpu_torch.native.VecsReader`) rather than an
    ``(n, d)`` tensor, as the JAX package defines it."""
    return not hasattr(corpus, "shape") and hasattr(corpus, "read")


def _reader_rows(reader, rows: np.ndarray):
    """Rows by index from a reader: ``read_rows`` where it has one."""
    if hasattr(reader, "read_rows"):
        return reader.read_rows(rows)
    return np.concatenate([np.asarray(reader.read(int(i), 1)) for i in rows])


def _n_rows(corpus) -> int:
    return corpus.n if _is_reader(corpus) else corpus.shape[0]


def _refine(
    queries: Tensor, corpus, cand_idx: Tensor, top_k: int, metric: str,
) -> Tuple[Tensor, Tensor]:
    """Exact re-scoring of ADC candidates against the original vectors:
    gather the candidate rows, compute true squared distances (or negated
    inner products), and keep the best ``top_k``; among equal scores the
    earlier candidate in the list first, as ``jax.lax.top_k`` keeps them in
    the JAX package.  O(nq * R * d).

    ``corpus`` is an ``(n, d)`` tensor, or a reader for a corpus larger than
    the card: only the candidate rows (``nq * R``, a few thousand) are read
    from disk and copied to the queries' device.  Ids are clipped to
    ``[0, n - 1]`` either way; padding candidates (``-1``) score ``+inf``."""
    safe = cand_idx.clamp(0, _n_rows(corpus) - 1)
    if _is_reader(corpus):
        rows = _reader_rows(corpus, safe.reshape(-1).cpu().numpy())
        cand = torch.as_tensor(rows).to(queries.device, torch.float32).reshape(*safe.shape, -1)
    else:
        cand = corpus[safe].to(torch.float32)  # (nq, R, d)
    q = queries.to(torch.float32)
    if metric == "dot":
        d2 = -torch.einsum("qrd,qd->qr", cand, q)
    else:
        diff = cand - q[:, None, :]
        d2 = torch.sum(diff * diff, dim=-1)
    d2 = torch.where(cand_idx >= 0, d2, torch.full_like(d2, float("inf")))
    vals, pos = _smallest(d2, None, top_k)
    return vals, torch.gather(cand_idx, 1, pos)


def search(
    pq: Pq,
    queries: Tensor,
    codes: Tensor,
    top_k: int = 10,
    *,
    chunk_size: int = 16384,
    method: str = "auto",
    splits=2,
    stream_chunk: Optional[int] = None,
    packed: bool = False,
    refine_with=None,
    refine_factor: int = 4,
    metric: str = "l2",
) -> Tuple[Tensor, Tensor]:
    """Top-``top_k`` best encoded vectors per query by ADC.

    Returns ``(distances, indices)`` of shape ``(nq, top_k)`` each (f32 and
    int64), sorted ascending by approximate squared distance.
    ``metric="dot"`` ranks by descending inner product instead (returned
    scores are the negated inner products, still ascending).

    ``method="auto"`` (default) scores through the fused ADC kernel
    (:func:`reductive_tpu_torch.ops.adc.adc_scores_kernel`) when ``codes`` is
    a CUDA tensor of ``uint8`` or packed-u4 codes, and through the plain scorer
    (:func:`adc_scores`) otherwise.  Force ``method="einsum"`` for rankings
    that do not depend on the device; ``splits`` sets the kernel's table
    precision (1, 2, 3 or ``"int8"``).
    ``method="decode"`` scores by decode + one dense product.

    ``packed=True`` searches a packed-u4 corpus (``(n, m/2)`` bytes from
    :func:`reductive_tpu_torch.ops.packing.pack_u4_codes`; ``k <= 16`` and
    ``method="kernel"``): half the code memory, twice the corpus on a card.
    On CPU tensors ``method="kernel"`` is the kernel's plain version.

    ``refine_with`` (an ``(n, d)`` tensor of the original vectors, or a
    reader such as :class:`reductive_tpu_torch.native.VecsReader` for a
    corpus larger than the card) enables the two-stage refine: ADC retrieves ``top_k * refine_factor``
    candidates, which are re-scored with exact distances and the best
    ``top_k`` returned.

    ``stream_chunk`` switches to the streamed search: the ``(nq, n)`` score
    matrix never materializes.  When it is not given and the score matrix
    would exceed 64M f32 elements (256 MB), streaming engages by itself.
    """
    if top_k <= 0:
        raise ValueError("top_k must be >= 1")
    if top_k > codes.shape[0]:
        raise ValueError(f"top_k={top_k} exceeds corpus size {codes.shape[0]}")
    method = _check_method(method, codes.is_cuda, codes.dtype, packed)
    _check_metric(metric)
    n = codes.shape[0]
    if refine_with is not None:
        if refine_factor < 1:
            raise ValueError("refine_factor must be >= 1")
        if _n_rows(refine_with) != n:
            raise ValueError(f"refine_with has {_n_rows(refine_with)} rows, codes have {n}")
    stream_chunk = _resolve_stream_chunk(
        queries.shape[0], n, stream_chunk, method, pq.reconstructed_len,
    )
    with span("search"):
        if refine_with is None:
            return _search_batched(pq, queries, codes, top_k, stream_chunk, chunk_size, method,
                                   splits, packed, metric)
        r = min(top_k * refine_factor, n)
        _, cand_idx = _search_batched(pq, queries, codes, r, stream_chunk, chunk_size, method,
                                      splits, packed, metric)
        return _refine(queries, refine_with, cand_idx, top_k, metric)


def _search_batched(
    pq: Pq, queries: Tensor, codes: Tensor, top_k: int, stream_chunk: Optional[int],
    chunk_size: int, method: str, splits, packed: bool, metric: str,
) -> Tuple[Tensor, Tensor]:
    """:func:`_search_one` over query batches the kernel takes."""
    def one(q: Tensor) -> Tuple[Tensor, Tensor]:
        return _search_one(
            pq, q, codes, top_k, stream_chunk, chunk_size, method, splits, packed, metric
        )

    # The ADC kernel tiles the queries itself, so its per-call cap is the
    # extent of its grid; queries are independent, so batch above it.
    if method == "kernel":
        from .ops.adc import max_query_batch

        qb = max_query_batch(pq.n_subquantizers, pq.n_quantizer_centroids, splits)
        if 0 < qb < queries.shape[0]:
            parts = [one(queries[i:i + qb]) for i in range(0, queries.shape[0], qb)]
            return torch.cat([p[0] for p in parts]), torch.cat([p[1] for p in parts])
    return one(queries)


def _check_method(method: str, on_cuda: bool, codes_dtype: torch.dtype, packed: bool) -> str:
    """``method``, with ``"auto"`` resolved: the ADC kernel for ``uint8`` or
    packed codes on a GPU, the plain scorer otherwise."""
    if method == "auto":
        method = "kernel" if on_cuda and (packed or codes_dtype == torch.uint8) else "einsum"
    if method not in ("einsum", "kernel", "decode"):
        raise ValueError(f"unknown search method {method!r}")
    if packed and method != "kernel":
        raise ValueError(
            'packed-u4 codes require method="kernel" (the einsum scorer '
            "consumes unpacked codes — see reductive_tpu.ops.unpack_u4_codes)"
        )
    return method


def search_sharded(
    pq: Pq,
    queries: Tensor,
    codes,
    top_k: int = 10,
    *,
    mesh,
    data_axis: str = "data",
    chunk_size: int = 16384,
    method: str = "auto",
    splits=2,
    packed: bool = False,
    metric: str = "l2",
    stream_chunk: Optional[int] = None,
) -> Tuple[Tensor, Tensor]:
    """Exhaustive ADC search over a corpus sharded over the ranks of
    ``data_axis`` of ``mesh`` (:func:`reductive_tpu_torch.parallel.make_mesh`),
    one process a rank, each making the same call.

    Every rank takes the same arguments: ``codes`` is the whole ``(n, m)``
    corpus (a tensor anywhere, or a host array), of which rank ``r`` of
    ``R`` moves rows ``[r n'/R, (r+1) n'/R)`` to its device and scores them
    with :func:`search`'s scorer (the ADC kernel on a GPU); ``n'`` is ``n``
    rounded up to a multiple of ``R``, the added rows zero codes scored
    ``+inf`` with id ``-1``.  The ``(nq, top_k)`` results of the ranks are
    gathered in rank order and merged by the same selection, so every rank
    returns what :func:`search` returns on the whole corpus, scores bit for
    bit: the global top ``top_k`` lies in the union of the ranks' (ties at
    the k-th place keep the lowest ids, which the rank order puts first).
    ``stream_chunk`` resolves at the per-rank corpus size; the other
    options are :func:`search`'s.  Returns ``(distances, indices)`` on the
    rank's device.
    """
    from .parallel.mesh import axis_group, mesh_device

    if top_k <= 0:
        raise ValueError("top_k must be >= 1")
    dev = mesh_device(mesh)
    codes = torch.as_tensor(codes)
    method = _check_method(method, dev.type == "cuda", codes.dtype, packed)
    _check_metric(metric)
    group, size, rank = axis_group(mesh, data_axis)
    n = codes.shape[0]
    per = -(-n // size)
    if top_k > per or top_k > n:
        raise ValueError(f"top_k={top_k} exceeds the per-shard corpus {per}")
    lo, hi = min(rank * per, n), min((rank + 1) * per, n)
    local = codes[lo:hi].to(dev)
    if hi - lo < per:
        local = torch.cat([local, local.new_zeros((per - (hi - lo),) + tuple(codes.shape[1:]))])
    queries = queries.to(dev)
    pq = _on_device(pq, dev)
    stream_chunk = _resolve_stream_chunk(
        queries.shape[0], per, stream_chunk, method, pq.reconstructed_len,
    )
    d, i = _search_batched(pq, queries, local, top_k, stream_chunk, chunk_size, method, splits,
                           packed, metric)
    i = i + rank * per
    if per * size != n:  # the padding rows never win
        pad = i >= n
        d = d.masked_fill(pad, float("inf"))
        i = i.masked_fill(pad, -1)
    return _merge_ranks(group, d, i, top_k)


def _merge_ranks(group, dists: Tensor, ids: Tensor, top_k: int) -> Tuple[Tensor, Tensor]:
    """Every rank's ``(nq, kk)`` results gathered in rank order and the best
    ``top_k`` of them kept, ties by that order: the same on every rank."""
    nq = dists.shape[0]
    d_all = all_gather_rows(group, dists).transpose(0, 1).reshape(nq, -1)
    i_all = all_gather_rows(group, ids).transpose(0, 1).reshape(nq, -1)
    return _smallest(d_all, i_all, top_k)
