// PQ encode: per row and subquantizer, argmin_c (|c|^2 - 2 c.x_j), first
// index on ties.
//
// Replaces the TPU kernel reductive_tpu/ops/assign.py::_encode_kernel.  That
// kernel packs all m codebooks into one block-diagonal matrix because its
// matrix unit contracts 128 deep; here each subquantizer is its own ds-deep
// product with no zero blocks, and the argmin is a true (distance, index)
// minimum carried in registers (no packed sortable key).
//
// Two kernels, one for each mode:
//
// * f32 (encode_f32_kernel): real fp32 FMAs.  What bounds it on an H100: the
//   2*n*m*k*ds operations on the fp32 pipes (the bytes, x read once and codes
//   written once, take about a sixth of that time at m=16, k=256, ds=8).
//   Design: one block takes a tile of rows and one subquantizer, stages 256
//   centroids (holding 2c) and their |c|^2 in shared memory at a time, and
//   each thread keeps R rows' subvectors in registers so that every shared
//   memory read (a broadcast: all threads read the same centroid) feeds R*ds
//   FMAs.  A strict `<` over c = 0..k-1 gives the first index on ties.
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
//   reductive_tpu/ops/assign.py::_encode_verify_kernel): the f32 kernel, where
//   each thread also carries the best distance over all OTHER indices (a
//   duplicate of the best counts, so an exact tie has margin 0) and the squared
//   norm of its subvector.  A (row, subquantizer) is flagged when
//       second - best <= 2 * escale[j] * |x_j| + rho * |best|,
//   and a row's flag is the OR over its subquantizers, joined across the m
//   blocks that share the row by an integer atomicOr on a zeroed array (the
//   same bits on every launch).  The wrapper chooses escale and rho so that
//   every unflagged row provably has the exact path's code (see
//   ops/assign.py); it re-encodes the flagged rows with the exact path.  Two
//   more operations per score (a max and a min) beside the compare and the
//   selects; the bound is the f32 kernel's plus 4*n bytes of flags.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kCentroidTile = 256;

template <int DS, int R, typename OutT, bool VERIFY>
__global__ void __launch_bounds__(kThreads)
encode_f32_kernel(const float* __restrict__ x, const float* __restrict__ cb2,
                  const float* __restrict__ csqn, OutT* __restrict__ codes,
                  const float* __restrict__ escale, float rho, int* __restrict__ flags,
                  long long n, int m, int k) {
  __shared__ __align__(16) float s_c[kCentroidTile * DS];
  __shared__ float s_n[kCentroidTile];

  // Neighbouring blocks take the m subquantizers of the same rows, so that the
  // sectors of a row they share, and of its codes, meet in L2.
  const int j = blockIdx.x % m;
  const long long d = (long long)m * DS;
  const long long row_base = (long long)(blockIdx.x / m) * (kThreads * R) + threadIdx.x;

  float xr[R][DS];
  float best[R];
  float second[R];  // VERIFY: the least distance over all indices but best_idx
  int best_idx[R];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const long long row = row_base + (long long)r * kThreads;
    best[r] = __int_as_float(0x7f800000);  // +inf
    second[r] = __int_as_float(0x7f800000);
    best_idx[r] = 0;
    if (row < n) {
      const float4* p = reinterpret_cast<const float4*>(x + row * d + (long long)j * DS);
#pragma unroll
      for (int t = 0; t < DS / 4; ++t) {
        float4 v = p[t];
        xr[r][4 * t + 0] = v.x;
        xr[r][4 * t + 1] = v.y;
        xr[r][4 * t + 2] = v.z;
        xr[r][4 * t + 3] = v.w;
      }
    } else {
#pragma unroll
      for (int t = 0; t < DS; ++t) xr[r][t] = 0.0f;
    }
  }

  const float* cbj = cb2 + (long long)j * k * DS;
  const float* nj = csqn + (long long)j * k;
  for (int k0 = 0; k0 < k; k0 += kCentroidTile) {
    const int kt = min(kCentroidTile, k - k0);
    __syncthreads();
    for (int e = threadIdx.x; e < kt * DS; e += kThreads) s_c[e] = cbj[(long long)k0 * DS + e];
    for (int e = threadIdx.x; e < kt; e += kThreads) s_n[e] = nj[k0 + e];
    __syncthreads();
    for (int c = 0; c < kt; ++c) {
      float cv[DS];
#pragma unroll
      for (int t = 0; t < DS / 4; ++t) {
        float4 v = reinterpret_cast<const float4*>(s_c + c * DS)[t];
        cv[4 * t + 0] = v.x;
        cv[4 * t + 1] = v.y;
        cv[4 * t + 2] = v.z;
        cv[4 * t + 3] = v.w;
      }
      const float nn = s_n[c];
#pragma unroll
      for (int r = 0; r < R; ++r) {
        float s = 0.0f;
#pragma unroll
        for (int t = 0; t < DS; ++t) s = fmaf(xr[r][t], cv[t], s);
        const float dist = nn - s;  // cb2 holds 2c: s is the doubled cross term
        // The loser of (dist, best) is a candidate for second place.
        if constexpr (VERIFY) second[r] = fminf(second[r], fmaxf(dist, best[r]));
        if (dist < best[r]) {
          best[r] = dist;
          best_idx[r] = k0 + c;
        }
      }
    }
  }

#pragma unroll
  for (int r = 0; r < R; ++r) {
    const long long row = row_base + (long long)r * kThreads;
    if (row < n) {
      codes[row * m + j] = (OutT)best_idx[r];
      if constexpr (VERIFY) {
        float xn2 = 0.0f;
#pragma unroll
        for (int t = 0; t < DS; ++t) xn2 = fmaf(xr[r][t], xr[r][t], xn2);
        const float margin = second[r] - best[r];  // +inf with k = 1; NaN flags
        const float limit = 2.0f * escale[j] * sqrtf(xn2) + rho * fabsf(best[r]);
        if (!(margin > limit)) atomicOr(flags + row, 1);
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
  const int j = blockIdx.x % m;  // as in the f32 kernel
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

template <int DS, int R>
cudaError_t launch_verify(const float* x, const float* cb2, const float* csqn, void* codes,
                          const float* escale, float rho, int* flags, long long n, int m, int k,
                          int out_u8, cudaStream_t stream) {
  const long long rows_per_block = (long long)kThreads * R;
  const long long blocks = (n + rows_per_block - 1) / rows_per_block * m;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  if (out_u8)
    encode_f32_kernel<DS, R, uint8_t, true><<<(unsigned)blocks, kThreads, 0, stream>>>(
        x, cb2, csqn, (uint8_t*)codes, escale, rho, flags, n, m, k);
  else
    encode_f32_kernel<DS, R, int32_t, true><<<(unsigned)blocks, kThreads, 0, stream>>>(
        x, cb2, csqn, (int32_t*)codes, escale, rho, flags, n, m, k);
  return cudaGetLastError();
}

template <int DS, int R>
cudaError_t launch(const float* x, const float* cb2, const float* csqn, void* codes,
                   long long n, int m, int k, int bf16, int out_u8, cudaStream_t stream) {
  const long long rows_per_block = bf16 ? kRowsPerBlock : (long long)kThreads * R;
  const long long blocks = (n + rows_per_block - 1) / rows_per_block * m;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  dim3 grid((unsigned)blocks);
  dim3 block(kThreads);
  if (bf16) {
    if (out_u8)
      encode_bf16_kernel<DS, uint8_t><<<grid, block, 0, stream>>>(x, cb2, csqn, (uint8_t*)codes, n, m, k);
    else
      encode_bf16_kernel<DS, int32_t><<<grid, block, 0, stream>>>(x, cb2, csqn, (int32_t*)codes, n, m, k);
  } else {
    if (out_u8)
      encode_f32_kernel<DS, R, uint8_t, false><<<grid, block, 0, stream>>>(
          x, cb2, csqn, (uint8_t*)codes, nullptr, 0.0f, nullptr, n, m, k);
    else
      encode_f32_kernel<DS, R, int32_t, false><<<grid, block, 0, stream>>>(
          x, cb2, csqn, (int32_t*)codes, nullptr, 0.0f, nullptr, n, m, k);
  }
  return cudaGetLastError();
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
    case 4: return (int)launch<4, 4>(xf, cf, nf, codes, n, m, k, bf16, out_u8, s);
    case 8: return (int)launch<8, 4>(xf, cf, nf, codes, n, m, k, bf16, out_u8, s);
    case 16: return (int)launch<16, 2>(xf, cf, nf, codes, n, m, k, bf16, out_u8, s);
    case 32: return (int)launch<32, 1>(xf, cf, nf, codes, n, m, k, bf16, out_u8, s);
    default: return -1;
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
    case 4: return (int)launch_verify<4, 4>(xf, cf, nf, codes, ef, rho, fl, n, m, k, out_u8, s);
    case 8: return (int)launch_verify<8, 4>(xf, cf, nf, codes, ef, rho, fl, n, m, k, out_u8, s);
    case 16: return (int)launch_verify<16, 2>(xf, cf, nf, codes, ef, rho, fl, n, m, k, out_u8, s);
    case 32: return (int)launch_verify<32, 1>(xf, cf, nf, codes, ef, rho, fl, n, m, k, out_u8, s);
    default: return -1;
  }
}
