"""Native (C++) runtime: dataset IO and code packing.

Counterpart of ``reductive_tpu.native``, with its own copy of ``vecio.cpp``.
The source is compiled by ``g++`` into a shared library at first use: the
first reader opened, the first :func:`pack_u4` / :func:`unpack_u4` call, or
the first read of ``NATIVE_AVAILABLE``, never when the package is imported.
The library is built into ``reductive_tpu_torch/_build/`` under a name that
hashes the source and the compiler's flags, through a temporary file named
after the building process and moved into place with ``os.replace``, so
processes that build at once each load a whole library.  Where ``g++``
fails, readers take a numpy memmap and packing takes numpy, with a warning;
``NATIVE_AVAILABLE`` says which path is active.
"""

from __future__ import annotations

import ctypes
import hashlib
import logging
import os
import subprocess
import threading
from pathlib import Path
from typing import Optional

import numpy as np

logger = logging.getLogger("reductive_tpu")

__all__ = [
    "NATIVE_AVAILABLE",
    "VecsReader",
    "pack_u4",
    "unpack_u4",
    "write_fvecs",
]

_KINDS = {"fvecs": 0, "bvecs": 1, "ivecs": 2}
_DTYPES = {0: np.float32, 1: np.uint8, 2: np.int32}

_SRC = Path(__file__).resolve().parent / "vecio.cpp"
_BUILD = Path(__file__).resolve().parent.parent / "_build"
_FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17")
_build_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_failed = False


def _library_path() -> Path:
    """Where the library of the current source is built: its name hashes
    ``vecio.cpp`` and the flags, so an edited source builds anew."""
    h = hashlib.sha256(_SRC.read_bytes())
    h.update(" ".join(_FLAGS).encode())
    return _BUILD / f"libvecio_{h.hexdigest()[:16]}.so"


def _bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    lib.vecs_open.restype = ctypes.c_void_p
    lib.vecs_open.argtypes = [ctypes.c_char_p, ctypes.c_int32]
    lib.vecs_close.argtypes = [ctypes.c_void_p]
    lib.vecs_count.restype = ctypes.c_int64
    lib.vecs_count.argtypes = [ctypes.c_void_p]
    lib.vecs_dim.restype = ctypes.c_int32
    lib.vecs_dim.argtypes = [ctypes.c_void_p]
    lib.vecs_read_f32.restype = ctypes.c_int32
    lib.vecs_read_f32.argtypes = [
        ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64,
        ctypes.POINTER(ctypes.c_float), ctypes.c_int32,
    ]
    lib.prefetch_create.restype = ctypes.c_void_p
    lib.prefetch_create.argtypes = [
        ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64,
        ctypes.c_int64, ctypes.c_int32, ctypes.c_int32,
    ]
    lib.prefetch_next.restype = ctypes.c_int32
    lib.prefetch_next.argtypes = [
        ctypes.c_void_p, ctypes.POINTER(ctypes.c_int64),
        ctypes.POINTER(ctypes.c_int64),
        ctypes.POINTER(ctypes.POINTER(ctypes.c_float)),
    ]
    lib.prefetch_release.argtypes = [ctypes.c_void_p, ctypes.c_int32]
    lib.prefetch_destroy.argtypes = [ctypes.c_void_p]
    for name in ("pack_u4", "unpack_u4"):
        getattr(lib, name).argtypes = [
            ctypes.POINTER(ctypes.c_uint8), ctypes.c_int64,
            ctypes.POINTER(ctypes.c_uint8),
        ]
    return lib


def _build() -> Optional[ctypes.CDLL]:
    """The bound library, compiled first if need be; ``None`` (once warned)
    where it cannot be built or loaded."""
    global _lib, _failed
    with _build_lock:
        if _lib is not None or _failed:
            return _lib
        path = _library_path()
        try:
            if not path.exists():
                path.parent.mkdir(parents=True, exist_ok=True)
                tmp = path.with_suffix(f".{os.getpid()}.tmp")
                cmd = ["g++", *_FLAGS, "-o", str(tmp), str(_SRC), "-lpthread"]
                try:
                    subprocess.run(cmd, check=True, capture_output=True, timeout=120)
                    os.replace(tmp, path)  # a concurrent loader sees a whole file or none
                finally:
                    tmp.unlink(missing_ok=True)
            _lib = _bind(ctypes.CDLL(str(path)))
        except (OSError, subprocess.SubprocessError) as e:
            logger.warning("native vecio unavailable (%s); using numpy fallback", e)
            _failed = True
        return _lib


def __getattr__(name: str):
    # NATIVE_AVAILABLE is computed on first read, which builds the library.
    if name == "NATIVE_AVAILABLE":
        return _build() is not None
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


class VecsReader:
    """Reader for fvecs/bvecs/ivecs datasets.

    Native path: mmap + multithreaded conversion to float32 batches.
    Fallback: numpy memmap with a strided view.  Usable as a context
    manager; ``read(start, count)`` returns a ``(count, dim)`` float32
    array ready for upload to the device.
    """

    def __init__(self, path: str, kind: Optional[str] = None, n_threads: int = 8):
        path = os.fspath(path)
        if kind is None:
            ext = os.path.splitext(path)[1].lstrip(".")
            kind = ext if ext in _KINDS else "fvecs"
        if kind not in _KINDS:
            raise ValueError(f"unknown dataset kind {kind!r}; expected one of {list(_KINDS)}")
        self.path = path
        self.kind = kind
        self.n_threads = n_threads
        self._handle = None
        self._mm = None

        lib = _build()
        if lib is not None:
            handle = lib.vecs_open(self.path.encode(), _KINDS[kind])
            if not handle:
                raise OSError(f"cannot open {path!r} as {kind}")
            self._handle = handle
            self.n = int(lib.vecs_count(handle))
            self.dim = int(lib.vecs_dim(handle))
        else:
            self._open_fallback()

    def _open_fallback(self) -> None:
        dtype = _DTYPES[_KINDS[self.kind]]
        raw = np.memmap(self.path, dtype=np.uint8, mode="r")
        if raw.size < 4:
            raise OSError(f"{self.path!r} is not a vecs file")
        dim = int(np.frombuffer(raw[:4].tobytes(), dtype=np.int32)[0])
        if dim <= 0:
            raise OSError(f"{self.path!r} has invalid dimension {dim}")
        row_bytes = 4 + dim * np.dtype(dtype).itemsize
        if raw.size % row_bytes != 0:
            raise OSError(f"{self.path!r} is truncated")
        self._mm = raw
        self._row_bytes = row_bytes
        self._dtype = dtype
        self.n = raw.size // row_bytes
        self.dim = dim

    def read(self, start: int, count: int) -> np.ndarray:
        """Rows ``[start, start+count)`` as a float32 ``(count, dim)`` array."""
        if start < 0 or count < 0 or start + count > self.n:
            raise IndexError(
                f"range [{start}, {start + count}) out of bounds for {self.n} rows"
            )
        out = np.empty((count, self.dim), dtype=np.float32)
        if self._handle is not None:
            rc = _lib.vecs_read_f32(
                self._handle, start, count,
                out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
                self.n_threads,
            )
            if rc != 0:
                raise OSError("native vecs_read_f32 failed")
        else:
            rows = self._mm[start * self._row_bytes:(start + count) * self._row_bytes]
            rows = rows.reshape(count, self._row_bytes)[:, 4:]
            out[:] = rows.view(self._dtype).reshape(count, self.dim)
        return out

    def read_rows(self, indices) -> np.ndarray:
        """Scattered rows by index as a float32 ``(len(indices), dim)``
        array: the initial-centroid fetch of the streamed trainers.  One
        native call a row, each on one thread (spawning a pool would cost
        more than a row's read); the page cache makes repeated draws cheap."""
        indices = np.asarray(indices, dtype=np.int64)
        if indices.size and (indices.min() < 0 or indices.max() >= self.n):
            raise IndexError(f"row index out of bounds for {self.n} rows")
        out = np.empty((len(indices), self.dim), dtype=np.float32)
        if self._handle is not None:
            row = np.empty((self.dim,), dtype=np.float32)
            p = row.ctypes.data_as(ctypes.POINTER(ctypes.c_float))
            for i, ix in enumerate(indices):
                if _lib.vecs_read_f32(self._handle, int(ix), 1, p, 1) != 0:
                    raise OSError("native vecs_read_f32 failed")
                out[i] = row
        else:
            rows = self._mm.reshape(self.n, self._row_bytes)[indices, 4:]
            out[:] = rows.view(self._dtype).reshape(len(indices), self.dim)
        return out

    def batches(self, batch_size: int, start: int = 0, stop: Optional[int] = None):
        """Yield ``(offset, float32 batch)`` pairs over ``[start, stop)``."""
        stop = self.n if stop is None else min(stop, self.n)
        for off in range(start, stop, batch_size):
            yield off, self.read(off, min(batch_size, stop - off))

    def prefetch_batches(
        self,
        batch_size: int,
        start: int = 0,
        stop: Optional[int] = None,
        *,
        depth: int = 3,
        copy: bool = True,
    ):
        """Like :meth:`batches`, but a **native producer thread** reads and
        converts up to ``depth`` batches ahead, so that the disk read and
        the f32 conversion overlap the consumer's work (the streaming
        encode and the streamed trainers: the copy to the device and the
        kernels).

        With ``copy=False`` the yielded array is a zero-copy view of a
        ring buffer, valid only until the next iteration step (the slot is
        recycled); use it only when the batch is consumed (e.g. copied to
        pinned memory) before advancing.  Falls back to the synchronous
        :meth:`batches` when the native library is unavailable.
        """
        stop = self.n if stop is None else min(stop, self.n)
        if not copy and depth < 2:
            raise ValueError(
                "copy=False needs depth >= 2 (one slot stays pinned at the "
                "consumer while the producer fills the next)"
            )
        if self._handle is None:
            yield from self.batches(batch_size, start, stop)
            return
        p = _lib.prefetch_create(
            self._handle, start, stop, batch_size, depth, self.n_threads
        )
        if not p:
            raise OSError("prefetch_create failed")
        try:
            pending_slot = -1
            while True:
                off = ctypes.c_int64()
                count = ctypes.c_int64()
                data = ctypes.POINTER(ctypes.c_float)()
                slot = _lib.prefetch_next(
                    p, ctypes.byref(off), ctypes.byref(count), ctypes.byref(data)
                )
                if pending_slot >= 0:
                    _lib.prefetch_release(p, pending_slot)
                    pending_slot = -1
                if slot < 0:
                    break
                view = np.ctypeslib.as_array(data, shape=(count.value, self.dim))
                if copy:
                    yield off.value, view.copy()
                    _lib.prefetch_release(p, slot)
                else:
                    yield off.value, view
                    pending_slot = slot  # released on the next step
        finally:
            _lib.prefetch_destroy(p)

    def close(self) -> None:
        if self._handle is not None:
            _lib.vecs_close(self._handle)
            self._handle = None
        self._mm = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def __len__(self) -> int:
        return self.n


def _u8_ptr(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8))


def pack_u4(codes: np.ndarray) -> np.ndarray:
    """Pack uint8 codes (< 16) two per byte, the low nibble first; an odd
    tail zero-pads the high nibble.  Shape-flattening: returns a 1-D array
    of ``ceil(n/2)`` bytes (the bytes of
    :func:`reductive_tpu_torch.ops.pack_u4_codes` on a flattened array)."""
    codes = np.ascontiguousarray(codes, dtype=np.uint8).ravel()
    n = codes.size
    out = np.empty((n + 1) // 2, dtype=np.uint8)
    if _build() is not None:
        _lib.pack_u4(_u8_ptr(codes), n, _u8_ptr(out))
    else:
        lo = codes[0::2] & 0x0F
        hi = np.zeros_like(lo)
        hi[: n // 2] = codes[1::2] & 0x0F
        out[:] = lo | (hi << 4)
    return out


def unpack_u4(packed: np.ndarray, n: int) -> np.ndarray:
    """Inverse of :func:`pack_u4`: recover ``n`` uint8 codes."""
    packed = np.ascontiguousarray(packed, dtype=np.uint8).ravel()
    if packed.size < (n + 1) // 2:
        raise ValueError(f"packed buffer too small for {n} codes")
    out = np.empty(n, dtype=np.uint8)
    if _build() is not None:
        _lib.unpack_u4(_u8_ptr(packed), n, _u8_ptr(out))
    else:
        out[0::2] = packed[: (n + 1) // 2] & 0x0F
        out[1::2] = (packed[: n // 2] >> 4) & 0x0F
    return out


def write_fvecs(path: str, data, *, append: bool = False) -> None:
    """Write a float32 ``(n, dim)`` array (or a tensor, on any device) in
    fvecs format.

    Vectorized: the per-row ``dim`` header is interleaved through an int32
    view of one ``(chunk, dim+1)`` buffer, so multi-GB corpora write at
    disk speed.  ``append=True`` extends an existing file (rows must share
    the same ``dim``): how a corpus larger than host memory is written
    block by block."""
    if hasattr(data, "detach"):  # a torch tensor
        data = data.detach().cpu().numpy()
    data = np.ascontiguousarray(data, dtype=np.float32)
    n, dim = data.shape
    chunk = max(1, (1 << 26) // (dim + 1))
    with open(path, "ab" if append else "wb") as f:
        for off in range(0, n, chunk):
            rows = data[off : off + chunk]
            buf = np.empty((rows.shape[0], dim + 1), np.float32)
            buf.view(np.int32)[:, 0] = dim
            buf[:, 1:] = rows
            buf.tofile(f)
