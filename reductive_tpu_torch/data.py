"""Streaming encode pipeline: disk -> host batches -> device -> codes.

Counterpart of ``reductive_tpu.data``.  Production encode jobs process
corpora far larger than device memory (BASELINE.json config #5: 100M 768-d
vectors).  This pipeline streams the corpus in fixed-size batches through
the encode kernel:

* the native reader's producer thread reads and converts batch *i+1*
  (:meth:`reductive_tpu_torch.native.VecsReader.prefetch_batches`) while
  the device encodes batch *i*;
* each host batch is copied once, out of the reader's ring slot, into
  pinned host memory (cast there to ``transfer_dtype`` where given), and
  from there to the device with ``non_blocking=True`` on a copy stream of
  its own, so that the copy overlaps the kernels of the batch before; the
  compute stream waits for the copy's event.  At most ``depth`` batches are
  on the device at once: before a new batch is staged the host waits for
  the event recorded after the oldest one's work;
* codes come back the same way, into pinned memory, ``max_in_flight``
  batches behind.

The last partial batch is zero-padded to the batch's row count on the device
and its codes trimmed, so that one launch plan serves the whole stream.
:func:`stream_encode_resumable` writes the codes into an on-disk memmap and
resumes after an interruption.  :class:`SyntheticReader` is a virtual corpus
made on the device, for streaming consumers without a file.
"""

from __future__ import annotations

import collections
import hashlib
import json
import math
import os
from typing import Iterable, Iterator, Optional, Tuple

import numpy as np
import torch
from torch import Tensor

from ._device import resolve_device
from .pq.model import Pq

__all__ = [
    "stream_encode",
    "stream_encode_batches",
    "stream_encode_resumable",
    "SyntheticReader",
]

# Batches on the device at once in a streamed pass (the one being worked on
# and the one being copied).
_DEVICE_DEPTH = 2

_MASK64 = (1 << 64) - 1


def _signed64(v: int) -> int:
    """A 64-bit pattern as the int64 value with those bits."""
    v &= _MASK64
    return v - (1 << 64) if v >> 63 else v


_GAMMA = _signed64(0x9E3779B97F4A7C15)
_MIX1 = _signed64(0xBF58476D1CE4E5B9)
_MIX2 = _signed64(0x94D049BB133111EB)


def _shr(z: Tensor, s: int) -> Tensor:
    """Logical right shift of int64 bits (torch's ``>>`` is arithmetic)."""
    return (z >> s) & ((1 << (64 - s)) - 1)


def _mix64(z: Tensor) -> Tensor:
    """splitmix64's finalizer on int64 tensors (wrapping products)."""
    z = (z ^ _shr(z, 30)) * _MIX1
    z = (z ^ _shr(z, 27)) * _MIX2
    return z ^ _shr(z, 31)


def _uniform(base: int, counter: Tensor) -> Tensor:
    """float32 uniforms in (0, 1), a pure function of ``(base, counter)``:
    the top 24 bits of splitmix64's ``counter``-th output of stream
    ``base``."""
    h = _mix64(base + (counter + 1) * _GAMMA)
    return (_shr(h, 40).to(torch.float32) + 0.5) * (2.0 ** -24)


def _normal(base: int, rows: Tensor, dim: int) -> Tensor:
    """``(len(rows), dim)`` standard normals by Box–Muller, entry ``(r, c)``
    a pure function of ``(base, r, c)``."""
    c = rows[:, None] * (2 * dim) + 2 * torch.arange(dim, device=rows.device)[None, :]
    u1, u2 = _uniform(base, c), _uniform(base, c + 1)
    return torch.sqrt(-2.0 * torch.log(u1)) * torch.cos((2.0 * math.pi) * u2)


class SyntheticReader:
    """Device-resident synthetic corpus implementing the reader protocol.

    Every row is a pure function of ``(seed, row_index)``: a *virtual
    corpus* that is never materialized on disk, in host memory or on the
    device, each block made on the device on demand, so streaming
    consumers (:func:`stream_encode`,
    :func:`reductive_tpu_torch.pq.train_pq_streamed`, IVF builds from a
    reader) run their whole out-of-core path with no host-link traffic.

    Data is a mixture of ``n_centers`` Gaussians (centers
    ``N(0, center_scale²)``, isotropic noise of scale ``noise_scale``).
    Where the JAX package derives a key per row (``fold_in``), this one
    hashes ``(seed, stream, row, column)`` with splitmix64 in int64 tensor
    operations and takes Box–Muller normals, so its rows differ from the
    JAX package's by design; ``read``, ``read_rows`` and ``batches`` agree
    with each other in any order, like a file-backed reader.  Rows lie on
    ``device`` (``None`` means ``cuda``).
    """

    def __init__(
        self,
        n: int,
        dim: int,
        *,
        seed: int = 0,
        n_centers: int = 256,
        center_scale: float = 2.0,
        noise_scale: float = 1.0,
        device=None,
    ):
        self.n = int(n)
        self.dim = int(dim)
        self.path = None  # reader protocol: no backing file
        self.device = resolve_device(device)
        self._n_centers = int(n_centers)
        self._noise = float(noise_scale)
        # Three streams of one seed: the centers, each row's center, its noise.
        self._bases = [_signed64(hash_seed) for hash_seed in (
            (int(seed) * 3 + s) * 0x2545F4914F6CDD1D for s in range(3))]
        centers = torch.arange(self._n_centers, dtype=torch.int64, device=self.device)
        self._centers = _normal(self._bases[0], centers, self.dim) * float(center_scale)

    def rows(self, idx) -> Tensor:
        """The ``(len(idx), dim)`` float32 rows at the int indices ``idx``,
        made on the device."""
        if not isinstance(idx, Tensor):
            idx = torch.as_tensor(np.asarray(idx, dtype=np.int64))
        idx = idx.to(self.device, torch.int64).reshape(-1)
        which = _shr(_mix64(self._bases[1] + (idx + 1) * _GAMMA), 1) % self._n_centers
        return self._centers[which] + self._noise * _normal(self._bases[2], idx, self.dim)

    def read(self, start: int, count: int) -> Tensor:
        return self.rows(torch.arange(start, start + count, device=self.device))

    def read_rows(self, indices) -> Tensor:
        return self.rows(indices)

    def batches(self, batch_size: int, start: int = 0, stop: Optional[int] = None):
        stop = self.n if stop is None else min(stop, self.n)
        for off in range(start, stop, batch_size):
            yield off, self.read(off, min(batch_size, stop - off))

    def close(self) -> None:  # reader protocol
        pass

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def _reader_batches(reader, batch_size: int, start: int, stop: int, *, copy: bool = True):
    """The reader's batches over ``[start, stop)``, by the native prefetch
    executor where the reader has one.  ``copy=False`` yields views of the
    executor's ring slots, valid until the next step: for a consumer that
    copies each batch out (into pinned memory) before it advances."""
    if hasattr(reader, "prefetch_batches"):
        return reader.prefetch_batches(batch_size, start, stop, copy=copy)
    return reader.batches(batch_size, start, stop)


def _device_batches(
    batches: Iterable, device: torch.device, transfer_dtype=None, depth: int = _DEVICE_DEPTH,
) -> Iterator[Tuple[int, Tensor]]:
    """``(offset, batch)`` with each batch on ``device``, of
    ``transfer_dtype`` where given (the host casts before the copy: bfloat16
    rounds to nearest even, as ``ml_dtypes`` does) and float32 otherwise.

    On a GPU a host batch is copied into pinned memory, then to the device
    on a copy stream with ``non_blocking=True``; the current stream waits
    for that copy, and the pinned block is reused only once its copy has
    completed (the caching host allocator records the copy's event).  At
    most ``depth`` batches are on the device: before a new batch is staged
    the host waits for the event recorded on the current stream after the
    oldest one's work, which the consumer enqueued before it asked for the
    next batch.  Batches given as tensors (a device reader's) are moved and
    cast only."""
    cast = torch.float32 if transfer_dtype is None else transfer_dtype
    if device.type != "cuda":
        for off, batch in batches:
            yield off, torch.as_tensor(batch).to(device, cast)
        return
    compute = torch.cuda.current_stream(device)
    copier = torch.cuda.Stream(device)
    done: collections.deque = collections.deque()
    for off, batch in batches:
        while len(done) >= depth:
            done.popleft().synchronize()
        if isinstance(batch, Tensor):
            xb = batch.to(device, cast)
        else:
            src = torch.from_numpy(np.asarray(batch))
            pinned = torch.empty(src.shape, dtype=cast, pin_memory=True)
            pinned.copy_(src)
            with torch.cuda.stream(copier):
                xb = pinned.to(device, non_blocking=True)
            compute.wait_stream(copier)
            xb.record_stream(compute)
        yield off, xb
        event = torch.cuda.Event()
        event.record(compute)
        done.append(event)


def _np_dtype(dtype) -> np.dtype:
    """numpy's dtype for a torch or numpy integer dtype."""
    if isinstance(dtype, torch.dtype):
        return torch.empty((), dtype=dtype).numpy().dtype
    return np.dtype(dtype)


def _torch_dtype(dtype) -> torch.dtype:
    if isinstance(dtype, torch.dtype):
        return dtype
    return torch.from_numpy(np.empty((0,), dtype=np.dtype(dtype))).dtype


def _encode(
    pq: Pq, x: Tensor, dtype: torch.dtype, use_kernel: bool, compute_dtype=torch.bfloat16,
) -> Tensor:
    """Codes of one device batch: the projection (an f32 product) and the
    encode kernel (:func:`reductive_tpu_torch.ops.pq_encode`, bf16
    products: ``Pq.quantize_batch(method="kernel")``), or the exact f32
    path.  A reduced ``transfer_dtype`` is widened to f32 first, which is
    exact, so on the kernel path a bf16 transfer gives the codes of an f32
    one: the kernel rounds the rows to bf16 as the host did."""
    x = x.to(pq.codebooks.dtype)
    if pq.projection is not None:
        x = torch.matmul(x, pq.projection)
    if use_kernel:
        from .ops.assign import pq_encode

        return pq_encode(pq.codebooks, x, dtype=dtype, compute_dtype=compute_dtype)
    from .pq import primitives

    return primitives.quantize_batch(pq.codebooks, x, dtype=dtype)


def stream_encode_batches(
    pq: Pq,
    batches: Iterable[Tuple[int, np.ndarray]],
    *,
    batch_size: int,
    dtype=torch.uint8,
    use_kernel: Optional[bool] = None,
    max_in_flight: int = 2,
    transfer_dtype=None,
    compute_dtype=torch.bfloat16,
) -> Iterator[Tuple[int, np.ndarray]]:
    """Encode a stream of ``(offset, (b, d) float32)`` batches on the
    device of ``pq``.

    Yields ``(offset, (b, m) codes)`` as numpy arrays, in order.  Up to
    ``max_in_flight`` batches' codes stay queued, so host IO, the copies and
    the kernels overlap.  A batch smaller than ``batch_size`` (the tail) is
    zero-padded on the device and its codes trimmed.

    ``use_kernel=None`` means the encode kernel when ``pq`` lies on a GPU.
    ``transfer_dtype=torch.bfloat16`` casts each batch on the **host**
    before the copy to the device, halving the bytes on the wire; on the
    kernel path the codes are bit-identical to an f32 transfer (see
    :func:`_encode`), while the plain path and a projection see the
    reduced input.  ``compute_dtype`` sets the kernel's products
    (``torch.float32``: ``Pq.quantize_batch(method="kernel-f32")``'s).
    """
    dev = pq.codebooks.device
    if use_kernel is None:
        use_kernel = dev.type == "cuda"
    dtype = _torch_dtype(dtype)
    pending: collections.deque = collections.deque()

    def drain_one():
        off, valid, codes, event = pending.popleft()
        if event is not None:
            event.synchronize()
        return off, codes.numpy()[:valid]

    for off, xb in _device_batches(batches, dev, transfer_dtype):
        b = xb.shape[0]
        if b < batch_size:
            xb = torch.nn.functional.pad(xb, (0, 0, 0, batch_size - b))
        codes = _encode(pq, xb, dtype, use_kernel, compute_dtype)[:b]
        event = None
        if dev.type == "cuda":
            host = torch.empty(codes.shape, dtype=codes.dtype, pin_memory=True)
            host.copy_(codes, non_blocking=True)
            event = torch.cuda.Event()
            event.record(torch.cuda.current_stream(dev))
            codes = host
        pending.append((off, b, codes, event))
        if len(pending) > max_in_flight:
            yield drain_one()
    while pending:
        yield drain_one()


def stream_encode(
    pq: Pq,
    reader,
    *,
    batch_size: int = 1 << 18,
    dtype=torch.uint8,
    use_kernel: Optional[bool] = None,
    start: int = 0,
    stop: Optional[int] = None,
    transfer_dtype=None,
) -> np.ndarray:
    """Encode an entire on-disk dataset to a ``(n, m)`` host code matrix.

    ``reader`` is a :class:`reductive_tpu_torch.native.VecsReader` (or
    anything with ``n``/``batches()``).  Memory high-water: one output code
    matrix on the host, and two input batches on the device.
    """
    stop = reader.n if stop is None else min(stop, reader.n)
    n = stop - start
    out = np.empty((n, pq.quantized_len), dtype=_np_dtype(dtype))
    batches = _reader_batches(reader, batch_size, start, stop,
                              copy=pq.codebooks.device.type != "cuda")
    for off, codes in stream_encode_batches(
        pq,
        batches,
        batch_size=batch_size,
        dtype=dtype,
        use_kernel=use_kernel,
        transfer_dtype=transfer_dtype,
    ):
        out[off - start:off - start + codes.shape[0]] = codes
    return out


# ---------------------------------------------------------------------------
# Resumable encode: failure detection and restart for long-running jobs
# ---------------------------------------------------------------------------
#
# Codes are written straight into an on-disk memmap; a sidecar JSON tracks
# the contiguous completed prefix and a fingerprint of the model and corpus,
# updated atomically (write-tmp + rename) so a kill at any point leaves a
# consistent resume state.  Encode is deterministic given (model, corpus), so
# a restart continues bit-identically.  The fingerprint hashes the bytes the
# JAX package hashes, so a sidecar written by either package resumes in the
# other.


def _host_f32(a) -> np.ndarray:
    """A tensor (on any device) or an array as a C-contiguous float32 array."""
    if isinstance(a, Tensor):
        a = a.detach().cpu().numpy()
    return np.ascontiguousarray(a, dtype=np.float32)


def _model_fingerprint(pq: Pq, reader, batch_size: int, dtype) -> str:
    h = hashlib.sha256()
    h.update(_host_f32(pq.codebooks).tobytes())
    if pq.projection is not None:
        h.update(_host_f32(pq.projection).tobytes())
    h.update(f"{reader.n}:{batch_size}:{_np_dtype(dtype).name}".encode())
    # Corpus identity: a regenerated same-length corpus must not resume a
    # stale prefix.  Content-based only (no mtime, so a copy of an identical
    # file keeps its progress): size plus head, tail and 64 interior 1 KB
    # windows at pseudo-random offsets seeded from the size.
    path = getattr(reader, "path", None)
    if path is None and hasattr(reader, "read"):
        # No backing file (a SyntheticReader): a few probed rows' bytes.
        take = min(reader.n, 16)
        h.update(_host_f32(reader.read(0, take)).tobytes())
        if reader.n > take:
            mid = reader.n // 2
            h.update(_host_f32(reader.read(mid, min(16, reader.n - mid))).tobytes())
    if path is not None and os.path.exists(path):
        st = os.stat(path)
        h.update(f"{os.path.basename(path)}:{st.st_size}".encode())
        with open(path, "rb") as f:
            h.update(f.read(4096))
            interior = st.st_size - 8192
            if interior > 0:
                rs = np.random.RandomState(st.st_size % (2**32))
                offs = np.sort(rs.randint(0, max(1, interior), size=64))
                for off in offs:
                    f.seek(4096 + int(off))
                    h.update(f.read(1024))
            if st.st_size > 8192:
                f.seek(-4096, os.SEEK_END)
                h.update(f.read(4096))
    return h.hexdigest()


def stream_encode_resumable(
    pq: Pq,
    reader,
    out_path: str,
    *,
    batch_size: int = 1 << 18,
    dtype=torch.uint8,
    use_kernel: Optional[bool] = None,
    flush_every: int = 4,
    transfer_dtype=None,
) -> np.memmap:
    """Encode an on-disk dataset into an on-disk ``(n, m)`` code matrix,
    resuming after interruption.

    Progress is tracked in ``<out_path>.progress.json`` (atomic replace):
    if it exists and its fingerprint matches this (model, corpus, config),
    encoding continues from the recorded contiguous prefix.  The sidecar
    is kept with ``completed_rows == n`` after success, making the call
    idempotent: a supervisor that blindly re-runs the command gets the
    finished output back instead of re-encoding it.  Returns the completed
    read-only memmap.
    """
    n = reader.n
    m = pq.quantized_len
    np_dtype = _np_dtype(dtype)
    progress_path = out_path + ".progress.json"
    fingerprint = _model_fingerprint(pq, reader, batch_size, np_dtype)

    start = 0
    if os.path.exists(progress_path) and os.path.exists(out_path):
        try:
            with open(progress_path) as f:
                state = json.load(f)
            if (
                state.get("fingerprint") == fingerprint
                and state.get("n") == n
                and state.get("m") == m
            ):
                start = int(state["completed_rows"])
        except (ValueError, KeyError, OSError):
            start = 0  # unreadable sidecar: restart from scratch

    if start >= n:  # already complete: idempotent return
        return np.memmap(out_path, dtype=np_dtype, mode="r", shape=(n, m))

    mode = "r+" if (start > 0 and os.path.exists(out_path)) else "w+"
    out = np.memmap(out_path, dtype=np_dtype, mode=mode, shape=(n, m))

    def write_progress(rows: int) -> None:
        tmp = progress_path + ".tmp"
        with open(tmp, "w") as f:
            json.dump(
                {
                    "fingerprint": fingerprint,
                    "n": n,
                    "m": m,
                    "dtype": np_dtype.name,
                    "completed_rows": rows,
                },
                f,
            )
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, progress_path)

    batches = _reader_batches(reader, batch_size, start, n,
                              copy=pq.codebooks.device.type != "cuda")
    since_flush = 0
    for off, codes in stream_encode_batches(
        pq, batches, batch_size=batch_size, dtype=dtype,
        use_kernel=use_kernel, transfer_dtype=transfer_dtype,
    ):
        out[off : off + codes.shape[0]] = codes
        # Batches arrive in order, so the completed prefix is contiguous.
        since_flush += 1
        if since_flush >= flush_every:
            out.flush()
            write_progress(off + codes.shape[0])
            since_flush = 0

    out.flush()
    write_progress(n)  # completion marker, kept for idempotent re-runs
    return np.memmap(out_path, dtype=np_dtype, mode="r", shape=(n, m))
