"""Conformance mode: bit-faithful replication of the reference's RNG streams.

Counterpart of ``reductive_tpu.conformance``; its numpy generator stack is
copied here unchanged.  The north-star parity gate (BASELINE.md) asks for
reconstruction MSE and k-means objective within 1e-5 *relative* of the
reference at matched ``(m, k, seed)``.  The reference's trained model is a
deterministic function of (a) its input data and (b) the instance-index
stream drawn from its RNGs: a ChaCha8 master (seeded via
``SeedableRng::seed_from_u64``, ``src/pq/traits.rs:36-44``) forking one
XorShift stream per subquantizer (``src/pq/pq.rs:221-224``), each feeding a
``Uniform`` integer distribution that picks initial-centroid instances
(``src/kmeans.rs:52-87``).  This module re-implements those exact generators
and the exact ``rand`` 0.8 sampling semantics on the host:

* :class:`ChaCha8Rng`: the ChaCha stream cipher with 8 rounds, 64-bit block
  counter + 64-bit stream id (the Bernstein variant used by ``rand_chacha``),
  including the PCG32-based ``seed_from_u64`` seed expansion from
  ``rand_core`` 0.6.
* :class:`XorShiftRng`: Marsaglia xorshift128 exactly as ``rand_xorshift``
  0.3 implements it (including the all-zero-seed escape and the
  ``next_u64 = lo | hi << 32`` word order of ``next_u64_via_u32``).
* :func:`sample_uniform_int`: ``rand`` 0.8's ``UniformInt<usize>``:
  widening-multiply (Lemire) rejection sampling on 64-bit draws.
* :func:`uniform_array_f32`: ``rand`` 0.8's ``UniformFloat<f32>`` over
  ``[0, 1)``: ``(next_u32 >> 9) * 2^-23``, filled in the row-major order of
  ``ndarray_rand``'s ``random_using`` (``src/ndarray_rand.rs:86-94`` ->
  ``from_shape_fn``).

With these, :func:`train_pq_conformant` (and the OPQ/GaussianOpq variants)
sees the *same instances sampled as initial centroids in the same order* as
a reference run with the same seed.  The draws are made on the host; the
Lloyd's iterations, the quantize/reconstruct roundtrip and the cross matrix
run in torch on ``device`` (``None`` means ``cuda``), while the OPQ
projection's eigendecomposition and SVD stay numpy/LAPACK on the host, the
arithmetic the reference calls.  From identical initial centroids Lloyd's
iterations are deterministic (argmin ties break to the first index), so the
objectives agree to float-summation order, inside the 1e-5 gate.

One deliberate delta, also noted in PARITY.md: the reference inserts drawn
indices into a ``std::collections::HashSet`` and reads them back in hash
order (``src/kmeans.rs:76-86``), which randomizes the *row order* of the
``k`` initial centroids per process (SipHash keys are drawn from the OS),
not the set itself, which is RNG-determined.  K-means is invariant under
centroid relabeling: assignments permute, the objective and the trained
codebook-as-a-set do not.  Conformance therefore uses first-draw order,
which is deterministic.
"""

from __future__ import annotations

from typing import List, Optional

import numpy as np

_MASK32 = 0xFFFFFFFF
_MASK64 = 0xFFFFFFFFFFFFFFFF

# "expand 32-byte k"
_CHACHA_CONSTANTS = np.array(
    [0x61707865, 0x3320646E, 0x79622D32, 0x6B206574], dtype=np.uint32
)

__all__ = [
    "ChaCha8Rng",
    "XorShiftRng",
    "sample_uniform_int",
    "uniform_array_f32",
    "distinct_indices",
    "reference_test_instances",
    "train_pq_conformant",
    "train_opq_conformant",
    "train_gaussian_opq_conformant",
]


def chacha_blocks(
    key_words: np.ndarray,
    counter: int,
    stream: int,
    n_blocks: int,
    rounds: int,
) -> np.ndarray:
    """Raw ChaCha keystream: ``n_blocks`` 16-word blocks starting at the
    given 64-bit block ``counter`` with the given 64-bit ``stream`` id
    (words 14-15).  Returns a flat ``(n_blocks * 16,)`` uint32 array in
    keystream word order.  Vectorized over blocks."""
    ctr = (counter + np.arange(n_blocks, dtype=np.uint64)) & np.uint64(_MASK64)
    x = np.empty((16, n_blocks), dtype=np.uint32)
    x[0:4] = _CHACHA_CONSTANTS[:, None]
    x[4:12] = np.asarray(key_words, dtype=np.uint32)[:, None]
    x[12] = (ctr & np.uint64(_MASK32)).astype(np.uint32)
    x[13] = (ctr >> np.uint64(32)).astype(np.uint32)
    x[14] = np.uint32(stream & _MASK32)
    x[15] = np.uint32((stream >> 32) & _MASK32)

    w = x.copy()

    def rotl(v: np.ndarray, r: int) -> np.ndarray:
        return (v << np.uint32(r)) | (v >> np.uint32(32 - r))

    def quarter(a: int, b: int, c: int, d: int) -> None:
        w[a] += w[b]
        w[d] = rotl(w[d] ^ w[a], 16)
        w[c] += w[d]
        w[b] = rotl(w[b] ^ w[c], 12)
        w[a] += w[b]
        w[d] = rotl(w[d] ^ w[a], 8)
        w[c] += w[d]
        w[b] = rotl(w[b] ^ w[c], 7)

    for _ in range(rounds // 2):
        quarter(0, 4, 8, 12)
        quarter(1, 5, 9, 13)
        quarter(2, 6, 10, 14)
        quarter(3, 7, 11, 15)
        quarter(0, 5, 10, 15)
        quarter(1, 6, 11, 12)
        quarter(2, 7, 8, 13)
        quarter(3, 4, 9, 14)

    return (w + x).T.ravel()


def _seed_from_u64(state: int, n_bytes: int) -> bytes:
    """``rand_core`` 0.6's default ``SeedableRng::seed_from_u64``: expand a
    u64 into seed bytes with PCG32 (multiplier/increment and XSH-RR output
    function as in the rand_core source), 4 bytes per step, little-endian."""
    mul = 6364136223846793005
    inc = 11634580027462260723
    out = bytearray()
    while len(out) < n_bytes:
        state = (state * mul + inc) & _MASK64
        xorshifted = (((state >> 18) ^ state) >> 27) & _MASK32
        rot = state >> 59
        x = ((xorshifted >> rot) | (xorshifted << ((32 - rot) & 31))) & _MASK32
        out += x.to_bytes(4, "little")
    return bytes(out[:n_bytes])


class ChaCha8Rng:
    """``rand_chacha``'s ``ChaCha8Rng`` as a sequential u32-word stream.

    All of ``rand``'s consumption patterns used by the reference reduce to
    whole little-endian u32 words pulled off the keystream in order:
    ``next_u32`` is one word, ``next_u64`` is two (low word first), and
    ``fill_bytes`` consumes ``ceil(n/4)`` words (``fill_via_u32_chunks``).
    """

    _CHUNK_BLOCKS = 256  # refill granularity; any multiple of 4 works

    def __init__(self, key_words: np.ndarray, counter: int = 0, stream: int = 0):
        self._key = np.asarray(key_words, dtype=np.uint32)
        assert self._key.shape == (8,)
        self._counter = counter
        self._stream = stream
        self._buf = np.empty((0,), dtype=np.uint32)
        self._idx = 0

    @classmethod
    def from_seed(cls, seed: bytes) -> "ChaCha8Rng":
        assert len(seed) == 32
        key = np.frombuffer(seed, dtype="<u4").astype(np.uint32)
        return cls(key)

    @classmethod
    def seed_from_u64(cls, state: int) -> "ChaCha8Rng":
        return cls.from_seed(_seed_from_u64(state, 32))

    def _refill(self) -> None:
        self._buf = chacha_blocks(
            self._key, self._counter, self._stream, self._CHUNK_BLOCKS, rounds=8
        )
        self._counter += self._CHUNK_BLOCKS
        self._idx = 0

    def next_words(self, n: int) -> np.ndarray:
        """The next ``n`` keystream words as a uint32 array."""
        out = np.empty((n,), dtype=np.uint32)
        filled = 0
        while filled < n:
            if self._idx >= len(self._buf):
                self._refill()
            take = min(n - filled, len(self._buf) - self._idx)
            out[filled : filled + take] = self._buf[self._idx : self._idx + take]
            self._idx += take
            filled += take
        return out

    def next_u32(self) -> int:
        return int(self.next_words(1)[0])

    def next_u64(self) -> int:
        lo, hi = self.next_words(2)
        return int(lo) | (int(hi) << 32)

    def fill_bytes(self, n: int) -> bytes:
        words = self.next_words((n + 3) // 4)
        return words.astype("<u4").tobytes()[:n]


class XorShiftRng:
    """``rand_xorshift`` 0.3's ``XorShiftRng`` (Marsaglia xorshift128)."""

    def __init__(self, x: int, y: int, z: int, w: int):
        self.x, self.y, self.z, self.w = x, y, z, w

    @classmethod
    def from_seed(cls, seed: bytes) -> "XorShiftRng":
        assert len(seed) == 16
        x, y, z, w = (
            int.from_bytes(seed[i : i + 4], "little") for i in (0, 4, 8, 12)
        )
        if x == y == z == w == 0:
            # rand_xorshift maps the (invalid) all-zero seed to 0xBAD_5EED.
            x = y = z = w = 0xBAD5EED
        return cls(x, y, z, w)

    @classmethod
    def from_rng(cls, master: ChaCha8Rng) -> "XorShiftRng":
        """``SeedableRng::from_rng``: fill the 16-byte seed from the master
        (consumes exactly 4 keystream words), then ``from_seed``."""
        return cls.from_seed(master.fill_bytes(16))

    @classmethod
    def seed_from_u64(cls, state: int) -> "XorShiftRng":
        return cls.from_seed(_seed_from_u64(state, 16))

    def next_u32(self) -> int:
        x = self.x
        t = (x ^ (x << 11)) & _MASK32
        self.x, self.y, self.z = self.y, self.z, self.w
        w = self.w
        self.w = w ^ (w >> 19) ^ t ^ (t >> 8)
        return self.w

    def next_u64(self) -> int:
        # rand_core's next_u64_via_u32: low word drawn first.
        lo = self.next_u32()
        hi = self.next_u32()
        return lo | (hi << 32)


def sample_uniform_int(rng, n: int) -> int:
    """One draw from ``rand`` 0.8's ``Uniform::new(0usize, n)``: Lemire
    widening-multiply rejection sampling over 64-bit draws (the reference
    runs on 64-bit, so ``usize = u64``)."""
    assert n > 0
    ints_to_reject = ((1 << 64) - n) % n  # (u64::MAX - range + 1) % range
    zone = _MASK64 - ints_to_reject
    while True:
        v = rng.next_u64()
        prod = v * n
        if (prod & _MASK64) <= zone:
            return prod >> 64


def uniform_array_f32(rng, shape: tuple) -> np.ndarray:
    """``rand`` 0.8's ``Uniform::new(0f32, 1f32)`` sampled element-wise in
    row-major order, as ``ndarray_rand``'s ``random_using`` does
    (``from_shape_fn`` fills standard-layout arrays in logical order).

    ``UniformFloat<f32>`` over [0, 1) draws one u32, keeps the top 23 bits
    as a mantissa in [1, 2), and subtracts 1 — i.e. ``(u >> 9) * 2^-23``,
    exact in f32."""
    count = int(np.prod(shape))
    if isinstance(rng, ChaCha8Rng):
        words = rng.next_words(count)
    else:
        words = np.array([rng.next_u32() for _ in range(count)], dtype=np.uint32)
    mantissa = (words >> np.uint32(9)).astype(np.float32)
    return (mantissa * np.float32(2.0 ** -23)).reshape(shape)


def distinct_indices(rng, n: int, k: int) -> np.ndarray:
    """The reference's ``RandomInstanceCentroids`` index draw
    (``src/kmeans.rs:73-79``): sample uniform indices in [0, n) until ``k``
    distinct ones have been seen.  Returned in first-draw order (see module
    docstring for why this is equivalent to the reference's hash order)."""
    seen = set()
    order: List[int] = []
    while len(order) != k:
        idx = sample_uniform_int(rng, n)
        if idx not in seen:
            seen.add(idx)
            order.append(idx)
    return np.asarray(order, dtype=np.int64)


def reference_test_instances(
    seed: int = 42, shape: tuple = (256, 20)
) -> tuple[np.ndarray, ChaCha8Rng]:
    """The exact instance matrix of the reference's quality-gate tests
    (``src/pq/pq.rs:431-436``): ``ChaCha8Rng::seed_from_u64(seed)`` feeding
    ``Uniform::new(0f32, 1f32)`` into a row-major fill.  Returns the matrix
    and the master RNG *in its post-generation state*, ready to be passed to
    a ``train_*_conformant`` function exactly as the test passes ``&mut rng``
    to ``train_pq_using``."""
    rng = ChaCha8Rng.seed_from_u64(seed)
    return uniform_array_f32(rng, shape), rng


# ---------------------------------------------------------------------------
# Conformant training entry points
# ---------------------------------------------------------------------------


def _pq_initial_indices(
    master: ChaCha8Rng, n: int, m: int, k: int, n_attempts: int
) -> np.ndarray:
    """Replicates ``Pq::train_pq_using``'s RNG fan-out
    (``src/pq/pq.rs:221-241``): fork one XorShift per subquantizer from the
    master (in subquantizer order), then within each subquantizer draw the
    initial-centroid indices attempt after attempt
    (``src/pq/pq.rs:168-176``).  Returns ``(n_attempts, m, k)`` indices."""
    rngs = [XorShiftRng.from_rng(master) for _ in range(m)]
    out = np.empty((n_attempts, m, k), dtype=np.int64)
    for sq, rng in enumerate(rngs):
        for attempt in range(n_attempts):
            out[attempt, sq] = distinct_indices(rng, n, k)
    return out


def _host_instances(instances) -> np.ndarray:
    """The instances as a host array (a tensor is copied from its device)."""
    if hasattr(instances, "detach"):
        return instances.detach().cpu().numpy()
    return np.asarray(instances)


def _master(seed: Optional[int], master: Optional[ChaCha8Rng]) -> ChaCha8Rng:
    if master is None:
        if seed is None:
            raise ValueError("Provide either seed= or master=")
        master = ChaCha8Rng.seed_from_u64(seed)
    return master


def train_pq_conformant(
    instances,
    n_subquantizers: int,
    n_subquantizer_bits: int,
    n_iterations: int,
    n_attempts: int = 1,
    *,
    seed: Optional[int] = None,
    master: Optional[ChaCha8Rng] = None,
    device=None,
):
    """Plain PQ training with the reference's exact initial-centroid
    selection (``TrainPq for Pq``, ``src/pq/pq.rs:196-250``).

    Pass either ``seed`` (mirrors ``ChaCha8Rng::seed_from_u64(seed)``) or a
    ``master`` RNG mid-stream (mirrors passing ``&mut rng`` after earlier
    draws, as the reference tests do).  The draws are made on the host; the
    k-means iterations run on ``device`` (``None`` means ``cuda``) through
    :func:`reductive_tpu_torch.pq.train.train_pq_subspace_with_centroids`.
    ``instances`` is a host array or a tensor (copied to the host for the
    draws).
    """
    import torch

    from ._device import resolve_device
    from .errors import check_quantizer_invariants
    from .pq.model import Pq
    from .pq.train import train_pq_subspace_with_centroids

    x = _host_instances(instances)
    n, d = x.shape
    check_quantizer_invariants(
        n_subquantizers, n_subquantizer_bits, n_iterations, n_attempts, n, d
    )
    master = _master(seed, master)
    dev = resolve_device(device)
    k = 2 ** n_subquantizer_bits
    ds = d // n_subquantizers

    indices = _pq_initial_indices(master, n, n_subquantizers, k, n_attempts)
    xs = x.reshape(n, n_subquantizers, ds)
    # initial[a, sq] = the sq-column slice of the instances drawn for (a, sq).
    initial = np.empty((n_attempts, n_subquantizers, k, ds), dtype=x.dtype)
    for a in range(n_attempts):
        for sq in range(n_subquantizers):
            initial[a, sq] = xs[indices[a, sq], sq, :]

    codebooks, _ = train_pq_subspace_with_centroids(
        torch.from_numpy(np.ascontiguousarray(xs)).to(dev), torch.from_numpy(initial).to(dev),
        n_iterations,
    )
    return Pq(codebooks=codebooks, projection=None)


def _create_projection_matrix_exact(x: np.ndarray, n_subquantizers: int):
    """Host-LAPACK initial OPQ projection for conformance mode
    (``src/pq/opq.rs:103-136``): numpy covariance (same centering/division
    order as ``src/linalg.rs:17-45``) and ``np.linalg.eigh``, the same
    LAPACK ``syevd`` the reference binds.  A device eigensolver differs from
    LAPACK at ~1e-4 in eigenvector entries for clustered eigenvalues, which
    is enough to move the initial centroids and break the 1e-5 objective
    gate before the alternation even starts."""
    from .pq.opq import bucket_eigenvalues

    centered = x - x.mean(axis=0, dtype=x.dtype)
    cov = centered.T @ (centered / x.dtype.type(x.shape[0] - 1))
    eigenvalues, eigenvectors = np.linalg.eigh(cov)
    buckets = bucket_eigenvalues(eigenvalues, n_subquantizers)
    flat = [i for bucket in buckets for i in bucket]
    return np.ascontiguousarray(eigenvectors[:, flat])


def _opq_alternate_exact(x, projection, codebooks, n_iterations: int):
    """Reference-arithmetic OPQ alternation for conformance mode.

    Per iteration the rotation, the batched Lloyd's step
    (:func:`reductive_tpu_torch.kmeans.lloyd_iteration_batched`), the
    quantize/reconstruct roundtrip and the cross matrix ``M = X^T X_hat``
    run in torch on the tensors' device; the rotation update is the LAPACK
    SVD the reference calls (``src/pq/opq.rs:184-188``, Ge et al., 2013,
    Eq. 7), by ``np.linalg.svd`` on the host.  ``x``, ``projection`` and
    ``codebooks`` are tensors on one device."""
    import torch

    from .kmeans import lloyd_iteration_batched
    from .pq import primitives

    n, d = x.shape
    m, k, ds = codebooks.shape
    for _ in range(int(n_iterations)):
        rx = torch.matmul(x, projection)
        rxs = rx.reshape(n, m, ds).transpose(0, 1).contiguous()
        codebooks, _ = lloyd_iteration_batched(rxs, codebooks)
        codes = primitives.quantize_batch(codebooks, rx, dtype=torch.int32)
        reconstructed = primitives.reconstruct_batch(codebooks, codes)
        M_host = torch.matmul(x.T, reconstructed).cpu().numpy()
        u, _, vt = np.linalg.svd(M_host)
        projection = torch.from_numpy((u @ vt).astype(M_host.dtype)).to(x.device)
    return projection, codebooks


def train_opq_conformant(
    instances,
    n_subquantizers: int,
    n_subquantizer_bits: int,
    n_iterations: int,
    n_attempts: int = 1,
    *,
    seed: Optional[int] = None,
    master: Optional[ChaCha8Rng] = None,
    device=None,
):
    """OPQ training with the reference's exact initial-centroid selection
    (``TrainPq for Opq``, ``src/pq/opq.rs:40-100``): the master RNG is used
    *directly* (no XorShift forks), one subquantizer after another
    (``src/pq/opq.rs:138-159``), on the **rotated** data.  ``n_attempts`` is
    ignored exactly as in the reference.  The alternation runs with the
    reference's exact LAPACK-SVD Procrustes update (see
    :func:`_opq_alternate_exact`) on ``device`` (``None`` means ``cuda``);
    the fast path stays on :func:`reductive_tpu_torch.pq.opq.train_opq`."""
    import torch

    from ._device import resolve_device
    from .errors import check_quantizer_invariants
    from .pq.model import Pq

    x = _host_instances(instances)
    n, d = x.shape
    check_quantizer_invariants(
        n_subquantizers, n_subquantizer_bits, n_iterations, 1, n, d
    )
    master = _master(seed, master)
    dev = resolve_device(device)
    k = 2 ** n_subquantizer_bits
    ds = d // n_subquantizers

    projection = _create_projection_matrix_exact(x, n_subquantizers).astype(x.dtype)
    rx = x @ projection
    rxs = rx.reshape(n, n_subquantizers, ds)
    initial = np.empty((n_subquantizers, k, ds), dtype=x.dtype)
    for sq in range(n_subquantizers):
        idx = distinct_indices(master, n, k)
        initial[sq] = rxs[idx, sq, :]

    projection, codebooks = _opq_alternate_exact(
        torch.from_numpy(np.ascontiguousarray(x)).to(dev), torch.from_numpy(projection).to(dev),
        torch.from_numpy(initial).to(dev), n_iterations,
    )
    return Pq(codebooks=codebooks, projection=projection)


def train_gaussian_opq_conformant(
    instances,
    n_subquantizers: int,
    n_subquantizer_bits: int,
    n_iterations: int,
    n_attempts: int = 1,
    *,
    seed: Optional[int] = None,
    master: Optional[ChaCha8Rng] = None,
    device=None,
):
    """GaussianOpq with the reference's exact RNG flow
    (``src/pq/gaussian_opq.rs:27-69``): closed-form projection on the host,
    then plain conformant PQ training on the rotated data with the same
    master, on ``device`` (``None`` means ``cuda``)."""
    import torch

    from ._device import resolve_device

    x = _host_instances(instances)
    projection = _create_projection_matrix_exact(x, n_subquantizers).astype(x.dtype)
    rx = x @ projection
    pq = train_pq_conformant(
        rx,
        n_subquantizers,
        n_subquantizer_bits,
        n_iterations,
        n_attempts,
        seed=seed,
        master=master,
        device=device,
    )
    return type(pq)(
        codebooks=pq.codebooks, projection=torch.from_numpy(projection).to(resolve_device(device))
    )
