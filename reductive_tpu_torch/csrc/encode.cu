// PQ encode: per row and subquantizer, argmin_c (|c|^2 - 2 c.x_j), first
// index on ties.
//
// Replaces the TPU kernel reductive_tpu/ops/assign.py::_encode_kernel.  That
// kernel packs all m codebooks into one block-diagonal matrix because its
// matrix unit contracts 128 deep; here each subquantizer is its own ds-deep
// product with no zero blocks, and the argmin is a true (distance, index)
// minimum (no packed sortable key).
//
// At ds in 4, 8, 16, 32, two kernels, one for each mode (below); at every
// other ds (1, 2, 3, 12, 128, 768, ...) the wide route of assign_wide.cuh,
// in f32, bf16 and verified mode, which csrc/stats.cu runs too.
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
//   sums in f32, on the tensor cores (mma.sync.m16n8k8).  What bounds it: the
//   bytes (the tensor cores make the operations cheap); what this kernel
//   really waits for is the compare-and-select after each 16x8 tile of
//   scores.  Design: a warp holds the A fragments of 64 rows in registers and
//   walks the centroids eight at a time; the accumulator starts at -|c|^2, so
//   a tile comes out as 2c.x - |c|^2 and the epilogue is an argmax: one
//   compare and two selects per score.  Each thread sees its columns in
//   rising order and keeps the first maximum; the four threads that share a
//   row then take the larger value and, on a tie, the lower index.
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

#include <cuda_bf16.h>
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

template <int DS, int SUB, typename OutT, bool VERIFY>
__global__ void __launch_bounds__(kThreads, assign_tile::kMinBlocks<DS>)
encode_f32_kernel(const float* __restrict__ x, const float* __restrict__ cb2,
                  const float* __restrict__ csqn, OutT* __restrict__ codes,
                  const float* __restrict__ escale, float rho, int* __restrict__ flags,
                  long long n, int m, int k, int P) {
  constexpr int kTile = F32Shape<DS, SUB>::kTile;
  extern __shared__ __align__(16) unsigned char smem[];
  uint32_t* s_w = reinterpret_cast<uint32_t*>(smem);               // split 2c, both parts
  float* s_n = reinterpret_cast<float*>(s_w) + 2 * assign_tile::Shape<DS>::kPartFloats;  // |c|^2
  float* s_x2 = s_n + kCentroidTile;                               // [2][kTile][DS]
  int* s_code = reinterpret_cast<int*>(s_x2 + 2 * kTile * DS);     // [kTile]
  float* s_best = reinterpret_cast<float*>(s_code + kTile);        // [kTile] chosen distance
  float* s_second = s_best + kTile;                                // [kTile] VERIFY: runner-up

  const int j = blockIdx.x % m;
  const int p = blockIdx.x / m;
  const long long n_tiles = (n + kTile - 1) / kTile;
  const float* cbj = cb2 + (long long)j * k * DS;
  const float* nj = csqn + (long long)j * k;

  int buffer = 0;
  if (p < n_tiles) assign_tile::copy_rows<DS, kTile, kThreads>(x, n, m, j, p, s_x2);

  int staged = -1;
  for (long long tile = p; tile < n_tiles; tile += P) {
    const long long row0 = tile * kTile;
    const float* s_x = s_x2 + buffer * (kTile * DS);
    assign_tile::wait_rows();
    __syncthreads();  // this tile has landed; the previous tile's codes are out
    buffer ^= 1;
    if (tile + P < n_tiles)
      assign_tile::copy_rows<DS, kTile, kThreads>(x, n, m, j, tile + P, s_x2 + buffer * (kTile * DS));

    assign_tile::assign_rows<DS, SUB, kThreads, VERIFY>(s_w, s_n, staged, cbj, nj, k, s_x, s_code,
                                                        s_best, s_second);
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

// ---- bf16 mode on the tensor cores ---------------------------------------

constexpr int kRowTiles = 4;                          // 16-row tiles a warp holds
constexpr int kWarps = kThreads / 32;
constexpr int kRowsPerBlock = kWarps * kRowTiles * 16;

__device__ __forceinline__ void mma_m16n8k8_bf16(float (&c)[4], uint32_t a0, uint32_t a1,
                                                 uint32_t b0) {
  asm(
      "mma.sync.aligned.m16n8k8.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, {%4,%5}, {%6}, "
      "{%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a0), "r"(a1), "r"(b0));
}

__device__ __forceinline__ uint32_t pack_bf16x2(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // .x (low half) = lo
  return *reinterpret_cast<uint32_t*>(&v);
}

template <int DS, typename OutT>
__global__ void __launch_bounds__(kThreads)
encode_bf16_kernel(const float* __restrict__ x, const float* __restrict__ cb2,
                   const float* __restrict__ csqn, OutT* __restrict__ codes,
                   long long n, int m, int k) {
  constexpr int KS = (DS + 7) / 8;  // k-steps of 8; ds = 4 is padded with zeros
  constexpr int DSP = KS * 8;
  __shared__ __align__(16) __nv_bfloat16 s_c[kCentroidTile * DSP];  // [c][t]
  __shared__ __align__(8) float s_n[kCentroidTile];                 // -|c|^2

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int g = lane >> 2;  // row of the fragment (and g + 8)
  const int t = lane & 3;   // column pair 2t, 2t + 1
  const int j = blockIdx.x % m;  // the m blocks of a row tile meet in L2
  const long long d = (long long)m * DS;
  const long long row0 = (long long)(blockIdx.x / m) * kRowsPerBlock + warp * (kRowTiles * 16);

  uint32_t a[kRowTiles][KS][2];
  float best[kRowTiles][2];
  int best_idx[kRowTiles][2];
#pragma unroll
  for (int rt = 0; rt < kRowTiles; ++rt) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const long long row = row0 + rt * 16 + g + 8 * h;
      best[rt][h] = __int_as_float(0xff800000);  // -inf
      best_idx[rt][h] = 0;
#pragma unroll
      for (int ks = 0; ks < KS; ++ks) {
        const int col = ks * 8 + 2 * t;
        float2 v = make_float2(0.f, 0.f);
        if (row < n && col < DS)
          v = *reinterpret_cast<const float2*>(x + row * d + (long long)j * DS + col);
        a[rt][ks][h] = pack_bf16x2(v.x, v.y);
      }
    }
  }

  const float* cbj = cb2 + (long long)j * k * DS;
  const float* nj = csqn + (long long)j * k;
  for (int k0 = 0; k0 < k; k0 += kCentroidTile) {
    const int kt = min(kCentroidTile, k - k0);
    const int kt8 = (kt + 7) & ~7;  // a ragged last tile is padded: zeros, -inf
    __syncthreads();
    for (int e = threadIdx.x; e < kt8 * DSP; e += kThreads) {
      const int c = e / DSP;
      const int tt = e - c * DSP;
      const float v = (c < kt && tt < DS) ? cbj[(long long)(k0 + c) * DS + tt] : 0.0f;
      s_c[e] = __float2bfloat16_rn(v);
    }
    for (int e = threadIdx.x; e < kt8; e += kThreads)
      s_n[e] = e < kt ? -nj[k0 + e] : __int_as_float(0xff800000);
    __syncthreads();

    for (int c8 = 0; c8 < kt8; c8 += 8) {
      uint32_t b[KS];
#pragma unroll
      for (int ks = 0; ks < KS; ++ks)
        b[ks] = *reinterpret_cast<const uint32_t*>(s_c + (c8 + g) * DSP + ks * 8 + 2 * t);
      const float2 nn = *reinterpret_cast<const float2*>(s_n + c8 + 2 * t);
      const int ci = k0 + c8 + 2 * t;
      float acc[kRowTiles][4];
#pragma unroll
      for (int rt = 0; rt < kRowTiles; ++rt) {  // all products first, then all selects
        acc[rt][0] = nn.x; acc[rt][1] = nn.y; acc[rt][2] = nn.x; acc[rt][3] = nn.y;
#pragma unroll
        for (int ks = 0; ks < KS; ++ks)
          mma_m16n8k8_bf16(acc[rt], a[rt][ks][0], a[rt][ks][1], b[ks]);
      }
#pragma unroll
      for (int rt = 0; rt < kRowTiles; ++rt) {
        if (acc[rt][0] > best[rt][0]) { best[rt][0] = acc[rt][0]; best_idx[rt][0] = ci; }
        if (acc[rt][1] > best[rt][0]) { best[rt][0] = acc[rt][1]; best_idx[rt][0] = ci + 1; }
        if (acc[rt][2] > best[rt][1]) { best[rt][1] = acc[rt][2]; best_idx[rt][1] = ci; }
        if (acc[rt][3] > best[rt][1]) { best[rt][1] = acc[rt][3]; best_idx[rt][1] = ci + 1; }
      }
    }
  }

#pragma unroll
  for (int rt = 0; rt < kRowTiles; ++rt) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float v = best[rt][h];
      int i = best_idx[rt][h];
#pragma unroll
      for (int off = 1; off <= 2; off <<= 1) {
        const float ov = __shfl_xor_sync(0xffffffffu, v, off);
        const int oi = __shfl_xor_sync(0xffffffffu, i, off);
        if (ov > v || (ov == v && oi < i)) { v = ov; i = oi; }
      }
      const long long row = row0 + rt * 16 + g + 8 * h;
      if (t == 0 && row < n) codes[row * m + j] = (OutT)i;
    }
  }
}

template <int DS, int SUB, typename OutT, bool VERIFY>
cudaError_t launch_f32_kernel(const float* x, const float* cb2, const float* csqn, OutT* codes,
                              const float* escale, float rho, int* flags, long long n, int m,
                              int k, cudaStream_t stream) {
  constexpr int kTile = F32Shape<DS, SUB>::kTile;
  constexpr int bytes = F32Shape<DS, SUB>::kBytes;
  auto kern = encode_f32_kernel<DS, SUB, OutT, VERIFY>;
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
                                                     k, (int)P);
  return cudaGetLastError();
}

template <int DS, bool VERIFY>
cudaError_t launch_f32(const float* x, const float* cb2, const float* csqn, void* codes,
                       const float* escale, float rho, int* flags, long long n, int m, int k,
                       int out_u8, cudaStream_t stream) {
  constexpr int SUB = assign_tile::kSubtiles<DS>;
  if (out_u8)
    return launch_f32_kernel<DS, SUB, uint8_t, VERIFY>(x, cb2, csqn, (uint8_t*)codes, escale, rho,
                                                       flags, n, m, k, stream);
  return launch_f32_kernel<DS, SUB, int32_t, VERIFY>(x, cb2, csqn, (int32_t*)codes, escale, rho,
                                                     flags, n, m, k, stream);
}

template <int DS>
cudaError_t launch_bf16(const float* x, const float* cb2, const float* csqn, void* codes,
                        long long n, int m, int k, int out_u8, cudaStream_t stream) {
  const long long blocks = (n + kRowsPerBlock - 1) / kRowsPerBlock * m;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  if (out_u8)
    encode_bf16_kernel<DS, uint8_t><<<(unsigned)blocks, kThreads, 0, stream>>>(
        x, cb2, csqn, (uint8_t*)codes, n, m, k);
  else
    encode_bf16_kernel<DS, int32_t><<<(unsigned)blocks, kThreads, 0, stream>>>(
        x, cb2, csqn, (int32_t*)codes, n, m, k);
  return cudaGetLastError();
}

template <int DS>
cudaError_t launch(const float* x, const float* cb2, const float* csqn, void* codes, long long n,
                   int m, int k, int bf16, int out_u8, cudaStream_t stream) {
  if (bf16) return launch_bf16<DS>(x, cb2, csqn, codes, n, m, k, out_u8, stream);
  return launch_f32<DS, false>(x, cb2, csqn, codes, nullptr, 0.0f, nullptr, n, m, k, out_u8,
                               stream);
}

}  // namespace

// x (n, m*ds) f32, cb2 (m, k, ds) f32 holding 2c (already rounded to bf16
// values in bf16 mode), csqn (m, k) f32, codes (n, m) uint8 or int32.
// Returns cudaGetLastError() after the launch; -1 for a shape it does not take.
extern "C" int rt_encode(const void* x, const void* cb2, const void* csqn, void* codes,
                         long long n, int m, int k, int ds, int bf16, int out_u8,
                         void* stream) {
  if (n <= 0) return 0;
  if (m <= 0 || k <= 0) return -1;
  cudaStream_t s = (cudaStream_t)stream;
  const float* xf = (const float*)x;
  const float* cf = (const float*)cb2;
  const float* nf = (const float*)csqn;
  switch (ds) {
    case 4: return (int)launch<4>(xf, cf, nf, codes, n, m, k, bf16, out_u8, s);
    case 8: return (int)launch<8>(xf, cf, nf, codes, n, m, k, bf16, out_u8, s);
    case 16: return (int)launch<16>(xf, cf, nf, codes, n, m, k, bf16, out_u8, s);
    case 32: return (int)launch<32>(xf, cf, nf, codes, n, m, k, bf16, out_u8, s);
    default:  // every other ds: the wide route of assign_wide.cuh
      return (int)assign_wide::launch(xf, cf, nf, {codes, m, 1, out_u8}, bf16 != 0, false,
                                      nullptr, 0.0f, nullptr, n, m, k, ds, s);
  }
}

// As rt_encode in f32 mode, with the verification flags: escale (m,) f32 and
// rho set the margin below which a (row, subquantizer) is flagged (see the
// head of this file); flags (n,) int32, zeroed by the caller, receives 1 for a
// row with any flagged subquantizer.
extern "C" int rt_encode_verify(const void* x, const void* cb2, const void* csqn, void* codes,
                                const void* escale, float rho, void* flags, long long n, int m,
                                int k, int ds, int out_u8, void* stream) {
  if (n <= 0) return 0;
  if (m <= 0 || k <= 0) return -1;
  cudaStream_t s = (cudaStream_t)stream;
  const float* xf = (const float*)x;
  const float* cf = (const float*)cb2;
  const float* nf = (const float*)csqn;
  const float* ef = (const float*)escale;
  int* fl = (int*)flags;
  switch (ds) {
    case 4: return (int)launch_f32<4, true>(xf, cf, nf, codes, ef, rho, fl, n, m, k, out_u8, s);
    case 8: return (int)launch_f32<8, true>(xf, cf, nf, codes, ef, rho, fl, n, m, k, out_u8, s);
    case 16: return (int)launch_f32<16, true>(xf, cf, nf, codes, ef, rho, fl, n, m, k, out_u8, s);
    case 32: return (int)launch_f32<32, true>(xf, cf, nf, codes, ef, rho, fl, n, m, k, out_u8, s);
    default:
      return (int)assign_wide::launch(xf, cf, nf, {codes, m, 1, out_u8}, false, true, ef, rho, fl,
                                      n, m, k, ds, s);
  }
}
