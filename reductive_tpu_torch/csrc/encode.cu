// PQ encode: per row and subquantizer, argmin_c (|c|^2 - 2 c.x_j), first
// index on ties.
//
// Replaces the TPU kernel reductive_tpu/ops/assign.py::_encode_kernel.  That
// kernel packs all m codebooks into one block-diagonal matrix because its
// matrix unit contracts 128 deep; here each subquantizer is its own ds-deep
// product with no zero blocks, and the argmin is a true (distance, index)
// minimum (no packed sortable key).
//
// At every ds up to 32, two kernels, one for each mode (below); at every
// wider ds (33, 36, 50, 75, 128, 768, ...) and any x the deep kernel of
// csrc/assign_deep.cuh (through assign_wide.cuh), in f32, bf16 and verified
// mode, which csrc/stats.cu runs too.
//
// ds outside 4, 8, 16, 32 (and rows off 16 bytes) run the instance of the
// padded width (assign_tile.cuh padded_width: 4, 8, 16 or 32) with PAD set;
// counters "*_pad" in ops/assign.py.  Replaces the same TPU kernels
// (reductive_tpu/ops/assign.py:138 _encode_kernel, :298
// _encode_verify_kernel), which take any ds.  What bounds it on an H100 is
// what bounds the unpadded instance, the selection on the half-rate ALU
// pipe: it selects over k per row whatever ds is.  What padding costs: the
// row copies are 4 or 8 bytes where they were 16, and the products and the
// shared-memory reads of the rows take DSP / ds times the real values (the
// products are not the limit).  At ds = 2 the bytes of x fall by ds / 8 from
// the flagship width while the selection's work a row stays; the tile of 512
// rows a block (a few KB of x) and the codebook staged once a block keep the
// rows' prologue off the path, where the shallow wide kernel paid a whole
// launch's ring and codebook staging for every 128 rows.
//
// * f32 (encode_f32_kernel): the assignment of csrc/assign_tile.cuh, the one
//   the f32 assign+statistics kernel (csrc/stats.cu) runs: a 3xTF32 split
//   product on the tensor cores (wgmma, pipelined over quarters of 64
//   centroids) and a pairwise selection.  Both kernels walk their row tiles
//   with the same copy_rows / assign_rows / flag_row, so a row's code, and in
//   verified mode its flag, are the same bits in both.  What bounds it on an
//   H100: the three TF32 passes of the 2*n*m*k*ds operations (the bytes, x
//   read once and codes written once, take about a tenth of the fp32 pipes'
//   time at m=16, k=256, ds=8); what it waits for in practice is the
//   selection after each product, on the half-rate ALU pipe.  Design: P
//   blocks per subquantizer, four waves of what the card holds at once (P
//   from the card's occupancy: no sum depends on the grid); block (p, j)
//   walks the row tiles p, p + P, ..., the next tile's subvectors coming by
//   cp.async into a second buffer while this one is assigned; with k <= 256
//   the centroids are split and staged once per block.  The m blocks of a
//   row tile are neighbours in the grid, so the sectors of the rows and of
//   their codes (row-major (n, m): a block writes its column, m codes apart)
//   meet in L2: writing the codes costs 0.06 ms of 5.2 at the flagship shape.
//
// * bf16 (encode_bf16_kernel): x and 2c rounded to bfloat16, products and
//   sums in f32 on the tensor cores: assign_tile.cuh's bf16 routine
//   (assign_rows_bf16: wgmma m64n64k16, A from registers, over quarters of
//   64 centroids, then d = |c|^2 - s and the f32 mode's pairwise selection,
//   its updates on the FMA pipe), the one stats_bf16_kernel runs, so a row's
//   code is the same bits in both.  What bounds it: the bytes (x read once,
//   2 GB at the flagship shape, against 0.5 ms of bf16 products padded to a
//   depth of 16); what it waits for is the selection's compares and minima on
//   the half-rate ALU pipe, then the products.  Design: the f32 mode's loop
//   (P blocks per subquantizer, the next tile's rows by cp.async while this
//   one is assigned, the centroids converted once per block for k <= 256),
//   three blocks an SM at ds <= 8, with the launch plan (rows a tile, P,
//   shared memory) from ops/assign.py bf16_tile_plan.
//
// * verified (encode_f32_kernel with VERIFY; replaces the TPU kernel
//   reductive_tpu/ops/assign.py::_encode_verify_kernel): the f32 kernel, whose
//   selection also carries the best distance over all OTHER indices (a
//   duplicate of the best counts, so an exact tie has margin 0).  A (row,
//   subquantizer) is flagged when
//       second - best <= 2 * escale[j] * |x_j| + rho * |best|,
//   and a row's flag is the OR over its subquantizers, joined across the m
//   blocks that share the row by an integer atomicOr on a zeroed array (the
//   same bits on every launch).  The wrapper chooses escale and rho so that
//   every unflagged row provably has the exact path's code (see
//   ops/assign.py, route "tf32x3"); it re-encodes the flagged rows with the
//   exact path.  The bound is the f32 kernel's plus 4*n bytes of flags.

#include <cuda_runtime.h>
#include <stdint.h>

#include "assign_tile.cuh"
#include "assign_wide.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kCentroidTile = assign_tile::kCentroidTile;
constexpr int kWaves = 4;

// ---- f32 and verified modes: 3xTF32 on the tensor cores ------------------------

template <int DS, int SUB>
struct F32Shape {
  static constexpr int kTile = assign_tile::kTileRows<SUB, kThreads>;
  // The staged centroids, two buffers of the tile's subvectors, and per row
  // the code, the best and (VERIFY) the second distance.
  static constexpr int kBytes = assign_tile::Shape<DS>::kBytes + 4 * (2 * kTile * DS + 3 * kTile);
};

// PAD: the padded instance (x (n, m * ds), cb2 (m, k, ds), ds <= DS; vec
// from assign_tile::row_vector); else ds is DS and vec unused.
template <int DS, int SUB, typename OutT, bool VERIFY, bool PAD>
__global__ void __launch_bounds__(kThreads, assign_tile::kMinBlocks<DS>)
encode_f32_kernel(const float* __restrict__ x, const float* __restrict__ cb2,
                  const float* __restrict__ csqn, OutT* __restrict__ codes,
                  const float* __restrict__ escale, float rho, int* __restrict__ flags,
                  long long n, int m, int k, int P, int ds, int vec) {
  constexpr int kTile = F32Shape<DS, SUB>::kTile;
  extern __shared__ __align__(16) unsigned char smem[];
  uint32_t* s_w = reinterpret_cast<uint32_t*>(smem);               // split 2c, both parts
  float* s_n = reinterpret_cast<float*>(s_w) + 2 * assign_tile::Shape<DS>::kPartFloats;  // |c|^2
  float* s_x2 = s_n + kCentroidTile;                               // [2][kTile][DS]
  int* s_code = reinterpret_cast<int*>(s_x2 + 2 * kTile * DS);     // [kTile]
  float* s_best = reinterpret_cast<float*>(s_code + kTile);        // [kTile] chosen distance
  float* s_second = s_best + kTile;                                // [kTile] VERIFY: runner-up

  const int w = PAD ? ds : DS;  // values of a subvector in x and cb2
  const int j = blockIdx.x % m;
  const int p = blockIdx.x / m;
  const long long n_tiles = (n + kTile - 1) / kTile;
  const float* cbj = cb2 + (long long)j * k * w;
  const float* nj = csqn + (long long)j * k;

  if constexpr (PAD) assign_tile::zero_pad_columns<DS, kTile, kThreads>(s_x2, w);
  int buffer = 0;
  if (p < n_tiles) assign_tile::copy_rows<DS, kTile, kThreads, PAD>(x, n, m, j, p, s_x2, w, vec);

  int staged = -1;
  for (long long tile = p; tile < n_tiles; tile += P) {
    const long long row0 = tile * kTile;
    const float* s_x = s_x2 + buffer * (kTile * DS);
    assign_tile::wait_rows();
    __syncthreads();  // this tile has landed; the previous tile's codes are out
    buffer ^= 1;
    if (tile + P < n_tiles)
      assign_tile::copy_rows<DS, kTile, kThreads, PAD>(x, n, m, j, tile + P,
                                                       s_x2 + buffer * (kTile * DS), w, vec);

    assign_tile::assign_rows<DS, SUB, kThreads, VERIFY>(s_w, s_n, staged, cbj, nj, k, w, s_x,
                                                        s_code, s_best, s_second);
    __syncthreads();

    for (int e = threadIdx.x; e < kTile; e += kThreads) {
      const long long row = row0 + e;
      if (row < n) {
        codes[row * m + j] = (OutT)s_code[e];
        if constexpr (VERIFY)
          assign_tile::flag_row<DS>(s_x + e * DS, s_best[e], s_second[e], escale[j], rho,
                                    flags + row);
      }
    }
  }
}

// ---- bf16 mode: assign_tile.cuh's bf16 routine ------------------------------

template <int DS, int SUB, typename OutT, bool PAD>
__global__ void __launch_bounds__(kThreads, assign_tile::kBf16Blocks<DS>)
encode_bf16_kernel(const float* __restrict__ x, const float* __restrict__ cb2,
                   const float* __restrict__ csqn, OutT* __restrict__ codes, long long n, int m,
                   int k, int P, int ds, int vec) {
  using T = assign_tile::Bf16Tile<DS, SUB, kThreads>;
  constexpr int kTile = T::kRows;
  extern __shared__ __align__(16) unsigned char smem[];
  const T sm(smem);

  const int w = PAD ? ds : DS;
  const int j = blockIdx.x % m;
  const int p = blockIdx.x / m;
  const long long n_tiles = (n + kTile - 1) / kTile;
  const float* cbj = cb2 + (long long)j * k * w;
  const float* nj = csqn + (long long)j * k;

  if constexpr (PAD) assign_tile::zero_pad_columns<DS, kTile, kThreads>(sm.s_x2, w);
  int buffer = 0;
  if (p < n_tiles) assign_tile::copy_rows<DS, kTile, kThreads, PAD>(x, n, m, j, p, sm.s_x2, w, vec);

  int staged = -1;
  for (long long tile = p; tile < n_tiles; tile += P) {
    const long long row0 = tile * kTile;
    float* s_x = sm.s_x2 + buffer * (kTile * DS);
    assign_tile::wait_rows();
    __syncthreads();  // this tile has landed; the previous tile's codes are out
    buffer ^= 1;
    if (tile + P < n_tiles)
      assign_tile::copy_rows<DS, kTile, kThreads, PAD>(x, n, m, j, tile + P,
                                                       sm.s_x2 + buffer * (kTile * DS), w, vec);

    assign_tile::assign_rows_bf16<DS, SUB, kThreads, false>(sm, staged, cbj, nj, k, w, s_x);
    __syncthreads();

    for (int e = threadIdx.x; e < kTile; e += kThreads) {
      const long long row = row0 + e;
      if (row < n) codes[row * m + j] = (OutT)sm.s_code[e];
    }
  }
}

template <int DS, int SUB, typename OutT, bool VERIFY, bool PAD>
cudaError_t launch_f32_kernel(const float* x, const float* cb2, const float* csqn, OutT* codes,
                              const float* escale, float rho, int* flags, long long n, int m,
                              int k, int ds, cudaStream_t stream) {
  constexpr int kTile = F32Shape<DS, SUB>::kTile;
  constexpr int bytes = F32Shape<DS, SUB>::kBytes;
  auto kern = encode_f32_kernel<DS, SUB, OutT, VERIFY, PAD>;
  cudaError_t err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return err;
  // Four waves of the blocks the card holds at once, rounded down to a whole
  // number of blocks per subquantizer: a block that ends early takes the next
  // one, where with a single wave the SMs holding two blocks would set the
  // time (4.90 against 5.24 ms at n = 4,000,000, m=16, k=256, ds=8 on an H100).
  int dev = 0, sms = 0, per_sm = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return err;
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess)
    return err;
  if ((err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kern, kThreads, bytes)) !=
      cudaSuccess)
    return err;
  const long long n_tiles = (n + kTile - 1) / kTile;
  long long P = (long long)kWaves * sms * per_sm / m;
  P = P < 1 ? 1 : (P > n_tiles ? n_tiles : P);
  const long long blocks = P * m;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  kern<<<(unsigned)blocks, kThreads, bytes, stream>>>(x, cb2, csqn, codes, escale, rho, flags, n, m,
                                                     k, (int)P, ds, assign_tile::row_vector(x, ds));
  return cudaGetLastError();
}

template <int DS, bool VERIFY, bool PAD>
cudaError_t launch_f32_pad(const float* x, const float* cb2, const float* csqn, void* codes,
                           const float* escale, float rho, int* flags, long long n, int m, int k,
                           int ds, int out_u8, cudaStream_t stream) {
  constexpr int SUB = assign_tile::kSubtiles<DS>;
  if (out_u8)
    return launch_f32_kernel<DS, SUB, uint8_t, VERIFY, PAD>(x, cb2, csqn, (uint8_t*)codes, escale,
                                                            rho, flags, n, m, k, ds, stream);
  return launch_f32_kernel<DS, SUB, int32_t, VERIFY, PAD>(x, cb2, csqn, (int32_t*)codes, escale,
                                                          rho, flags, n, m, k, ds, stream);
}

// ds <= DS: the padded instance where assign_tile::needs_pad says.
template <int DS, bool VERIFY>
cudaError_t launch_f32(const float* x, const float* cb2, const float* csqn, void* codes,
                       const float* escale, float rho, int* flags, long long n, int m, int k,
                       int ds, int out_u8, cudaStream_t stream) {
  if (assign_tile::needs_pad(x, ds))
    return launch_f32_pad<DS, VERIFY, true>(x, cb2, csqn, codes, escale, rho, flags, n, m, k, ds,
                                            out_u8, stream);
  return launch_f32_pad<DS, VERIFY, false>(x, cb2, csqn, codes, escale, rho, flags, n, m, k, ds,
                                           out_u8, stream);
}

template <bool VERIFY>
int launch_narrow(const float* x, const float* cb2, const float* csqn, void* codes,
                  const float* escale, float rho, int* flags, long long n, int m, int k, int ds,
                  int out_u8, cudaStream_t s) {
  switch (assign_tile::padded_width(ds)) {
    case 4: return (int)launch_f32<4, VERIFY>(x, cb2, csqn, codes, escale, rho, flags, n, m, k, ds, out_u8, s);
    case 8: return (int)launch_f32<8, VERIFY>(x, cb2, csqn, codes, escale, rho, flags, n, m, k, ds, out_u8, s);
    case 16: return (int)launch_f32<16, VERIFY>(x, cb2, csqn, codes, escale, rho, flags, n, m, k, ds, out_u8, s);
    default: return (int)launch_f32<32, VERIFY>(x, cb2, csqn, codes, escale, rho, flags, n, m, k, ds, out_u8, s);
  }
}

// The plan (rows a tile, P, shared-memory bytes) is ops/assign.py
// bf16_tile_plan's; -1 for one this build does not hold.
template <int DS, bool PAD>
int launch_bf16_kernel(const float* x, const float* cb2, const float* csqn, void* codes,
                       long long n, int m, int k, int ds, int out_u8, int P, int bytes,
                       cudaStream_t stream) {
  constexpr int SUB = assign_tile::kBf16Subtiles<DS>;
  const long long blocks = (long long)P * m;
  auto kern = out_u8 ? (const void*)encode_bf16_kernel<DS, SUB, uint8_t, PAD>
                     : (const void*)encode_bf16_kernel<DS, SUB, int32_t, PAD>;
  cudaError_t err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return (int)err;
  const int vec = assign_tile::row_vector(x, ds);
  if (out_u8)
    encode_bf16_kernel<DS, SUB, uint8_t, PAD><<<(unsigned)blocks, kThreads, bytes, stream>>>(
        x, cb2, csqn, (uint8_t*)codes, n, m, k, P, ds, vec);
  else
    encode_bf16_kernel<DS, SUB, int32_t, PAD><<<(unsigned)blocks, kThreads, bytes, stream>>>(
        x, cb2, csqn, (int32_t*)codes, n, m, k, P, ds, vec);
  return (int)cudaGetLastError();
}

// ds <= DS; the plan is that of DS.
template <int DS>
int launch_bf16(const float* x, const float* cb2, const float* csqn, void* codes, long long n,
                int m, int k, int ds, int out_u8, int rows, int P, int bytes, cudaStream_t stream) {
  using T = assign_tile::Bf16Tile<DS, assign_tile::kBf16Subtiles<DS>, kThreads>;
  if (rows != T::kRows || bytes != T::kBytes || P <= 0 || (long long)P * m > 0x7fffffffLL) return -1;
  if (assign_tile::needs_pad(x, ds))
    return launch_bf16_kernel<DS, true>(x, cb2, csqn, codes, n, m, k, ds, out_u8, P, bytes, stream);
  return launch_bf16_kernel<DS, false>(x, cb2, csqn, codes, n, m, k, ds, out_u8, P, bytes, stream);
}

}  // namespace

// x (n, m*ds) f32, cb2 (m, k, ds) f32 holding 2c (already rounded to bf16
// values in bf16 mode), csqn (m, k) f32, codes (n, m) uint8 or int32.  route
// (ops/assign.py assign_route): kRouteNarrow at ds <= 32, f32 mode only (bf16
// there: rt_encode_bf16); kRouteDeep, either mode, the deep kernel (cb2 and
// csqn as ops/assign.py deep_operands writes them); kRouteShallow, the
// shallow kernel, which only a caller that forces it takes (the yardstick of
// the tests and tools).
// Returns cudaGetLastError() after the launch; -1 for a shape it does not take.
extern "C" int rt_encode(const void* x, const void* cb2, const void* csqn, void* codes,
                         long long n, int m, int k, int ds, int bf16, int out_u8, int route,
                         void* stream) {
  if (n <= 0) return 0;
  if (m <= 0 || k <= 0 || ds <= 0) return -1;
  cudaStream_t s = (cudaStream_t)stream;
  const float* xf = (const float*)x;
  const float* nf = (const float*)csqn;
  if (route == assign_tile::kRouteNarrow) {
    if (bf16 || ds > 32) return -1;
    return launch_narrow<false>(xf, (const float*)cb2, nf, codes, nullptr, 0.0f, nullptr, n, m, k,
                                ds, out_u8, s);
  }
  if (route != assign_tile::kRouteDeep && route != assign_tile::kRouteShallow) return -1;
  return (int)assign_wide::launch(xf, cb2, nf, {codes, m, 1, out_u8}, bf16 != 0, false, nullptr,
                                  0.0f, nullptr, n, m, k, ds, route == assign_tile::kRouteDeep, s);
}

// The bf16 mode at ds <= 32: arguments as rt_encode's, and the launch plan of
// ops/assign.py bf16_tile_plan (rows a tile, P blocks per subquantizer,
// dynamic shared memory in bytes) for the padded width.  -1 for a shape or a
// plan it does not take.
extern "C" int rt_encode_bf16(const void* x, const void* cb2, const void* csqn, void* codes,
                              long long n, int m, int k, int ds, int out_u8, int rows, int P,
                              int bytes, void* stream) {
  if (n <= 0) return 0;
  if (m <= 0 || k <= 0 || ds <= 0 || ds > 32) return -1;
  cudaStream_t s = (cudaStream_t)stream;
  const float* xf = (const float*)x;
  const float* cf = (const float*)cb2;
  const float* nf = (const float*)csqn;
  switch (assign_tile::padded_width(ds)) {
    case 4: return launch_bf16<4>(xf, cf, nf, codes, n, m, k, ds, out_u8, rows, P, bytes, s);
    case 8: return launch_bf16<8>(xf, cf, nf, codes, n, m, k, ds, out_u8, rows, P, bytes, s);
    case 16: return launch_bf16<16>(xf, cf, nf, codes, n, m, k, ds, out_u8, rows, P, bytes, s);
    default: return launch_bf16<32>(xf, cf, nf, codes, n, m, k, ds, out_u8, rows, P, bytes, s);
  }
}

// As rt_encode in f32 mode, with the verification flags: escale (m,) f32 and
// rho set the margin below which a (row, subquantizer) is flagged (see the
// head of this file); flags (n,) int32, zeroed by the caller, receives 1 for a
// row with any flagged subquantizer.  route as for rt_encode.
extern "C" int rt_encode_verify(const void* x, const void* cb2, const void* csqn, void* codes,
                                const void* escale, float rho, void* flags, long long n, int m,
                                int k, int ds, int out_u8, int route, void* stream) {
  if (n <= 0) return 0;
  if (m <= 0 || k <= 0 || ds <= 0) return -1;
  cudaStream_t s = (cudaStream_t)stream;
  const float* xf = (const float*)x;
  const float* nf = (const float*)csqn;
  const float* ef = (const float*)escale;
  int* fl = (int*)flags;
  if (route == assign_tile::kRouteNarrow) {
    if (ds > 32) return -1;
    return launch_narrow<true>(xf, (const float*)cb2, nf, codes, ef, rho, fl, n, m, k, ds, out_u8,
                               s);
  }
  if (route != assign_tile::kRouteDeep && route != assign_tile::kRouteShallow) return -1;
  return (int)assign_wide::launch(xf, cb2, nf, {codes, m, 1, out_u8}, false, true, ef, rho, fl, n,
                                  m, k, ds, route == assign_tile::kRouteDeep, s);
}
