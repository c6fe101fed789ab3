// Fused Lloyd's step: nearest-centroid assignment and per-centroid statistics
// in one pass over the rows.
//
//   a[i,j]      = argmin_c (|c_jc|^2 - 2 c_jc.x_ij), first index on ties
//   sums[j,c,:] = sum of x_ij over the rows i with a[i,j] = c
//   counts[j,c] = number of such rows
//
// Replaces the TPU kernel reductive_tpu/ops/stats.py::_stats_kernel.  That
// kernel runs its grid in order and adds every row block into one resident
// accumulator through a one-hot matrix product; a CUDA grid runs in parallel,
// and float atomics would make the sums depend on the order of arrival.  The
// contract here: two launches on the same inputs give bit-equal results.
//
// Design.  P blocks per subquantizer (P is a launch argument, a function of
// the shapes alone).  Block (p, j) walks the row tiles p, p + P, p + 2P, ...
// in that order.  For each tile:
//   1. assignment, exactly the loops of csrc/encode.cu (f32: register-tiled
//      FMAs; bf16: mma.sync with the accumulator started at -|c|^2); the codes
//      go to shared memory, -1 for rows past n, and so do the tile's
//      subvectors as they are loaded (already rounded in bf16 mode);
//   2. accumulation without atomics: thread tid owns the centroids tid,
//      tid + 256, ...; it scans the tile's codes in row order and adds the
//      subvectors of its rows, read from shared memory, in registers.  (Read
//      from global memory instead, these few scattered rows per thread cost
//      as much as the whole assignment: they miss L1 inside a divergent
//      branch.)
// The block's result goes to its own slot of a (P, m, k, ds + 1) partial
// buffer (the last column holds the count, an integer); a second kernel adds
// the P slots in slot order.  Every sum is therefore taken in one fixed order.
// With k <= 256 a thread owns one centroid and keeps its sum in registers over
// all tiles; with more it adds each tile's sum into its own cells of the slot.
//
// In bf16 mode the sums are of the bf16-rounded x (accumulated in f32), as in
// the TPU kernel, where one rounded copy of x feeds both products.
//
// Verified mode (stats_f32_kernel with VERIFY; replaces the TPU kernel
// reductive_tpu/ops/stats.py::_stats_verify_kernel): the f32 mode, whose
// assignment also carries the best distance over all other indices and flags a
// (row, subquantizer) whose top-2 margin is within the bound the wrapper sets,
// exactly as csrc/encode.cu does; it writes the chosen codes (n, m) int32 and
// the rows' flags (integer atomicOr on a zeroed array) beside the statistics,
// so that the wrapper can re-encode the flagged rows with the exact path and
// move a changed row between cells.  The accumulation, the slots and the
// reduction are the f32 mode's: two launches still give the same bits.
//
// What bounds it on an H100: f32 mode, the 2*n*m*k*ds operations of the
// assignment on the fp32 pipes; bf16 mode, the bytes of x.  The accumulation
// adds, per tile and thread, one pass over the tile's codes in shared memory
// (broadcast reads, four codes a load).  Shared memory is dynamic: the tile's
// subvectors and the staged centroids exceed 48 KB above ds = 8.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kCentroidTile = 256;

// Adds to acc / cnt the subvectors of the tile's rows whose code is c, in row
// order.  xs holds the tile's subvectors [slot][DS], codes its `slots` codes
// (a multiple of 4), -1 where there is no row; both in shared memory.
template <int DS>
__device__ __forceinline__ void scan_tile(const float* xs, const int* codes, int slots, int c,
                                          float (&acc)[DS], unsigned int& cnt) {
  for (int i = 0; i < slots; i += 4) {
    const int4 cc = *reinterpret_cast<const int4*>(codes + i);
    const int e[4] = {cc.x, cc.y, cc.z, cc.w};
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      if (e[u] == c) {
        const float4* p = reinterpret_cast<const float4*>(xs + (i + u) * DS);
#pragma unroll
        for (int t = 0; t < DS / 4; ++t) {
          const float4 v = p[t];
          acc[4 * t + 0] += v.x;
          acc[4 * t + 1] += v.y;
          acc[4 * t + 2] += v.z;
          acc[4 * t + 3] += v.w;
        }
        ++cnt;
      }
    }
  }
}

// Step 2 for one tile whose codes and subvectors lie in shared memory (the
// caller has synchronised).  `one` (k <= kThreads): acc and cnt live on over
// the tiles.
template <int DS>
__device__ __forceinline__ void accumulate_tile(const float* xs, const int* codes, int slots,
                                                int k, bool one, float* __restrict__ slot,
                                                float (&acc)[DS], unsigned int& cnt) {
  for (int c = threadIdx.x; c < k; c += kThreads) {
    if (!one) {
#pragma unroll
      for (int t = 0; t < DS; ++t) acc[t] = 0.0f;
      cnt = 0;
    }
    scan_tile<DS>(xs, codes, slots, c, acc, cnt);
    if (!one && cnt != 0) {
      float* cell = slot + (long long)c * (DS + 1);
#pragma unroll
      for (int t = 0; t < DS; ++t) cell[t] += acc[t];
      cell[DS] = __uint_as_float(__float_as_uint(cell[DS]) + cnt);
    }
  }
}

// The block's own slot: zeroed at the start when the tiles add into it,
// written once at the end when the sums stayed in registers.
template <int DS>
__device__ __forceinline__ void zero_slot(float* __restrict__ slot, int k) {
  for (int c = threadIdx.x; c < k; c += kThreads) {
#pragma unroll
    for (int t = 0; t <= DS; ++t) slot[(long long)c * (DS + 1) + t] = 0.0f;  // 0.0f is integer 0
  }
}

template <int DS>
__device__ __forceinline__ void write_slot(float* __restrict__ slot, int k,
                                           const float (&acc)[DS], unsigned int cnt) {
  if (threadIdx.x < k) {
    float* cell = slot + (long long)threadIdx.x * (DS + 1);
#pragma unroll
    for (int t = 0; t < DS; ++t) cell[t] = acc[t];
    cell[DS] = __uint_as_float(cnt);
  }
}

// ---- f32 mode ---------------------------------------------------------------

template <int DS, int R, bool VERIFY>
__global__ void __launch_bounds__(kThreads)
stats_f32_kernel(const float* __restrict__ x, const float* __restrict__ cb2,
                 const float* __restrict__ csqn, float* __restrict__ partial,
                 const float* __restrict__ escale, float rho, int* __restrict__ codes_out,
                 int* __restrict__ flags, long long n, int m, int k, int P) {
  constexpr int kTile = kThreads * R;
  extern __shared__ __align__(16) unsigned char smem[];
  float* s_x = reinterpret_cast<float*>(smem);  // [kTile][DS]
  float* s_c = s_x + kTile * DS;                // [kCentroidTile][DS]
  float* s_n = s_c + kCentroidTile * DS;        // [kCentroidTile]
  int* s_code = reinterpret_cast<int*>(s_n + kCentroidTile);  // [kTile]

  // Neighbouring blocks take the m subquantizers of the same rows, so that the
  // sectors of a row they share meet in L2.
  const int j = blockIdx.x % m;
  const int p = blockIdx.x / m;
  const long long d = (long long)m * DS;
  const long long n_tiles = (n + kTile - 1) / kTile;
  const bool one = k <= kThreads;
  float* slot = partial + ((long long)p * m + j) * (long long)k * (DS + 1);
  const float* cbj = cb2 + (long long)j * k * DS;
  const float* nj = csqn + (long long)j * k;

  float acc[DS];
  unsigned int cnt = 0;
#pragma unroll
  for (int t = 0; t < DS; ++t) acc[t] = 0.0f;
  if (!one) zero_slot<DS>(slot, k);

  int staged = -1;
  for (long long tile = p; tile < n_tiles; tile += P) {
    const long long row_base = tile * kTile + threadIdx.x;
    float xr[R][DS];
    float best[R];
    float second[R];  // VERIFY: the least distance over all indices but best_idx
    int best_idx[R];
    __syncthreads();  // the previous tile's scan has ended: s_x and s_code are free
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const long long row = row_base + (long long)r * kThreads;
      best[r] = __int_as_float(0x7f800000);  // +inf
      second[r] = __int_as_float(0x7f800000);
      best_idx[r] = 0;
      float4* sx = reinterpret_cast<float4*>(s_x + (r * kThreads + threadIdx.x) * DS);
      const float4* q = reinterpret_cast<const float4*>(x + row * d + (long long)j * DS);
#pragma unroll
      for (int t = 0; t < DS / 4; ++t) {
        const float4 v = row < n ? q[t] : make_float4(0.f, 0.f, 0.f, 0.f);
        sx[t] = v;
        xr[r][4 * t + 0] = v.x;
        xr[r][4 * t + 1] = v.y;
        xr[r][4 * t + 2] = v.z;
        xr[r][4 * t + 3] = v.w;
      }
    }

    for (int k0 = 0; k0 < k; k0 += kCentroidTile) {
      const int kt = min(kCentroidTile, k - k0);
      if (staged != k0) {  // with k <= 256 the one centroid tile is staged once
        __syncthreads();
        for (int e = threadIdx.x; e < kt * DS; e += kThreads) s_c[e] = cbj[(long long)k0 * DS + e];
        for (int e = threadIdx.x; e < kt; e += kThreads) s_n[e] = nj[k0 + e];
        staged = k0;
        __syncthreads();
      }
      for (int c = 0; c < kt; ++c) {
        float cv[DS];
#pragma unroll
        for (int t = 0; t < DS / 4; ++t) {
          const float4 v = reinterpret_cast<const float4*>(s_c + c * DS)[t];
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
      s_code[r * kThreads + threadIdx.x] = row < n ? best_idx[r] : -1;
      if constexpr (VERIFY) {
        if (row < n) {
          codes_out[row * m + j] = best_idx[r];
          float xn2 = 0.0f;
#pragma unroll
          for (int t = 0; t < DS; ++t) xn2 = fmaf(xr[r][t], xr[r][t], xn2);
          const float margin = second[r] - best[r];  // +inf with k = 1; NaN flags
          const float limit = 2.0f * escale[j] * sqrtf(xn2) + rho * fabsf(best[r]);
          if (!(margin > limit)) atomicOr(flags + row, 1);
        }
      }
    }
    __syncthreads();
    accumulate_tile<DS>(s_x, s_code, kTile, k, one, slot, acc, cnt);
  }
  if (one) write_slot<DS>(slot, k, acc, cnt);
}

// ---- bf16 mode on the tensor cores -----------------------------------------

constexpr int kRowTiles = 4;  // 16-row tiles a warp holds
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

template <int DS>
__global__ void __launch_bounds__(kThreads)
stats_bf16_kernel(const float* __restrict__ x, const float* __restrict__ cb2,
                  const float* __restrict__ csqn, float* __restrict__ partial,
                  long long n, int m, int k, int P) {
  constexpr int KS = (DS + 7) / 8;  // k-steps of 8; ds = 4 is padded with zeros
  constexpr int DSP = KS * 8;
  constexpr int kTile = kRowsPerBlock;
  extern __shared__ __align__(16) unsigned char smem[];
  float* s_x = reinterpret_cast<float*>(smem);                 // [kTile][DS], bf16-rounded values
  float* s_n = s_x + kTile * DS;                               // [kCentroidTile], -|c|^2
  int* s_code = reinterpret_cast<int*>(s_n + kCentroidTile);   // [kTile]
  __nv_bfloat16* s_c = reinterpret_cast<__nv_bfloat16*>(s_code + kTile);  // [kCentroidTile][DSP]

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int g = lane >> 2;  // row of the fragment (and g + 8)
  const int t = lane & 3;   // column pair 2t, 2t + 1
  const int j = blockIdx.x % m;
  const int p = blockIdx.x / m;
  const long long d = (long long)m * DS;
  const long long n_tiles = (n + kTile - 1) / kTile;
  const bool one = k <= kThreads;
  float* slot = partial + ((long long)p * m + j) * (long long)k * (DS + 1);
  const float* cbj = cb2 + (long long)j * k * DS;
  const float* nj = csqn + (long long)j * k;

  float sum[DS];
  unsigned int cnt = 0;
#pragma unroll
  for (int e = 0; e < DS; ++e) sum[e] = 0.0f;
  if (!one) zero_slot<DS>(slot, k);

  int staged = -1;
  for (long long tile = p; tile < n_tiles; tile += P) {
    const int in_tile0 = warp * (kRowTiles * 16);
    const long long row0 = tile * kTile + in_tile0;

    uint32_t a[kRowTiles][KS][2];
    float best[kRowTiles][2];
    int best_idx[kRowTiles][2];
    __syncthreads();  // the previous tile's scan has ended: s_x and s_code are free
#pragma unroll
    for (int rt = 0; rt < kRowTiles; ++rt) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int in_tile = in_tile0 + rt * 16 + g + 8 * h;
        const long long row = row0 + rt * 16 + g + 8 * h;
        best[rt][h] = __int_as_float(0xff800000);  // -inf
        best_idx[rt][h] = 0;
#pragma unroll
        for (int ks = 0; ks < KS; ++ks) {
          const int col = ks * 8 + 2 * t;
          float2 v = make_float2(0.f, 0.f);
          if (row < n && col < DS)
            v = *reinterpret_cast<const float2*>(x + row * d + (long long)j * DS + col);
          const __nv_bfloat162 vb = __floats2bfloat162_rn(v.x, v.y);  // .x (low half) = v.x
          a[rt][ks][h] = *reinterpret_cast<const uint32_t*>(&vb);
          if (col < DS)
            *reinterpret_cast<float2*>(s_x + in_tile * DS + col) = __bfloat1622float2(vb);
        }
      }
    }

    for (int k0 = 0; k0 < k; k0 += kCentroidTile) {
      const int kt = min(kCentroidTile, k - k0);
      const int kt8 = (kt + 7) & ~7;  // a ragged last tile is padded: zeros, -inf
      if (staged != k0) {
        __syncthreads();
        for (int e = threadIdx.x; e < kt8 * DSP; e += kThreads) {
          const int c = e / DSP;
          const int tt = e - c * DSP;
          const float v = (c < kt && tt < DS) ? cbj[(long long)(k0 + c) * DS + tt] : 0.0f;
          s_c[e] = __float2bfloat16_rn(v);
        }
        for (int e = threadIdx.x; e < kt8; e += kThreads)
          s_n[e] = e < kt ? -nj[k0 + e] : __int_as_float(0xff800000);
        staged = k0;
        __syncthreads();
      }

      for (int c8 = 0; c8 < kt8; c8 += 8) {
        uint32_t b[KS];
#pragma unroll
        for (int ks = 0; ks < KS; ++ks)
          b[ks] = *reinterpret_cast<const uint32_t*>(s_c + (c8 + g) * DSP + ks * 8 + 2 * t);
        const float2 nn = *reinterpret_cast<const float2*>(s_n + c8 + 2 * t);
        const int ci = k0 + c8 + 2 * t;
        float sc[kRowTiles][4];
#pragma unroll
        for (int rt = 0; rt < kRowTiles; ++rt) {  // all products first, then all selects
          sc[rt][0] = nn.x; sc[rt][1] = nn.y; sc[rt][2] = nn.x; sc[rt][3] = nn.y;
#pragma unroll
          for (int ks = 0; ks < KS; ++ks)
            mma_m16n8k8_bf16(sc[rt], a[rt][ks][0], a[rt][ks][1], b[ks]);
        }
#pragma unroll
        for (int rt = 0; rt < kRowTiles; ++rt) {
          if (sc[rt][0] > best[rt][0]) { best[rt][0] = sc[rt][0]; best_idx[rt][0] = ci; }
          if (sc[rt][1] > best[rt][0]) { best[rt][0] = sc[rt][1]; best_idx[rt][0] = ci + 1; }
          if (sc[rt][2] > best[rt][1]) { best[rt][1] = sc[rt][2]; best_idx[rt][1] = ci; }
          if (sc[rt][3] > best[rt][1]) { best[rt][1] = sc[rt][3]; best_idx[rt][1] = ci + 1; }
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
        const int in_tile = in_tile0 + rt * 16 + g + 8 * h;
        if (t == 0) s_code[in_tile] = (tile * kTile + in_tile) < n ? i : -1;
      }
    }
    __syncthreads();
    accumulate_tile<DS>(s_x, s_code, kTile, k, one, slot, sum, cnt);
  }
  if (one) write_slot<DS>(slot, k, sum, cnt);
}

// ---- the P slots added in slot order ---------------------------------------

__global__ void __launch_bounds__(kThreads)
stats_reduce_kernel(const float* __restrict__ partial, float* __restrict__ sums,
                    float* __restrict__ counts, long long cells, int ds, int P) {
  const long long idx = (long long)blockIdx.x * kThreads + threadIdx.x;
  const int w = ds + 1;
  if (idx >= cells * w) return;
  const long long cell = idx / w;
  const int t = (int)(idx - cell * w);
  const long long stride = cells * w;
  if (t < ds) {
    float s = 0.0f;
    for (int p = 0; p < P; ++p) s += partial[p * stride + idx];
    sums[cell * ds + t] = s;
  } else {
    unsigned long long c = 0;
    for (int p = 0; p < P; ++p) c += __float_as_uint(partial[p * stride + idx]);
    counts[cell] = (float)c;
  }
}

// mode: 0 f32, 1 bf16, 2 verified (f32 with escale, rho, codes_out and flags).
template <int DS, int R>
cudaError_t launch(const float* x, const float* cb2, const float* csqn, float* partial,
                   float* sums, float* counts, const float* escale, float rho, int* codes_out,
                   int* flags, long long n, int m, int k, int mode, int P,
                   cudaStream_t stream) {
  const long long blocks = (long long)P * m;
  const long long cells = (long long)m * k;
  const long long reduce_blocks = (cells * (DS + 1) + kThreads - 1) / kThreads;
  if (blocks > 0x7fffffffLL || reduce_blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  cudaError_t err;
  if (mode == 1) {
    constexpr int DSP = (DS + 7) / 8 * 8;
    const int bytes = 4 * (kRowsPerBlock * DS + kCentroidTile + kRowsPerBlock) +
                      2 * kCentroidTile * DSP;
    err = cudaFuncSetAttribute(stats_bf16_kernel<DS>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               bytes);
    if (err != cudaSuccess) return err;
    stats_bf16_kernel<DS><<<(unsigned)blocks, kThreads, bytes, stream>>>(x, cb2, csqn, partial, n,
                                                                         m, k, P);
  } else {
    constexpr int kTile = kThreads * R;
    const int bytes = 4 * (kTile * DS + kCentroidTile * DS + kCentroidTile + kTile);
    auto kern = mode == 2 ? stats_f32_kernel<DS, R, true> : stats_f32_kernel<DS, R, false>;
    err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (err != cudaSuccess) return err;
    kern<<<(unsigned)blocks, kThreads, bytes, stream>>>(x, cb2, csqn, partial, escale, rho,
                                                        codes_out, flags, n, m, k, P);
  }
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  stats_reduce_kernel<<<(unsigned)reduce_blocks, kThreads, 0, stream>>>(partial, sums, counts, cells,
                                                                      DS, P);
  return cudaGetLastError();
}

int assign_stats(const void* x, const void* cb2, const void* csqn, void* partial, void* sums,
                 void* counts, const void* escale, float rho, void* codes, void* flags,
                 long long n, int m, int k, int ds, int mode, int P, void* stream) {
  if (n <= 0 || m <= 0 || k <= 0 || P <= 0) return -1;
  cudaStream_t s = (cudaStream_t)stream;
  const float* xf = (const float*)x;
  const float* cf = (const float*)cb2;
  const float* nf = (const float*)csqn;
  const float* ef = (const float*)escale;
  float* pf = (float*)partial;
  float* sf = (float*)sums;
  float* tf = (float*)counts;
  int* co = (int*)codes;
  int* fl = (int*)flags;
  switch (ds) {
    case 4: return (int)launch<4, 4>(xf, cf, nf, pf, sf, tf, ef, rho, co, fl, n, m, k, mode, P, s);
    case 8: return (int)launch<8, 4>(xf, cf, nf, pf, sf, tf, ef, rho, co, fl, n, m, k, mode, P, s);
    case 16: return (int)launch<16, 2>(xf, cf, nf, pf, sf, tf, ef, rho, co, fl, n, m, k, mode, P, s);
    case 32: return (int)launch<32, 1>(xf, cf, nf, pf, sf, tf, ef, rho, co, fl, n, m, k, mode, P, s);
    default: return -1;
  }
}

}  // namespace

// x (n, m*ds) f32, cb2 (m, k, ds) f32 holding 2c (already rounded to bf16
// values in bf16 mode), csqn (m, k) f32, partial (P, m, k, ds + 1) f32 scratch
// (need not be initialised), sums (m, k, ds) f32, counts (m, k) f32.
// Returns cudaGetLastError() after the launches; -1 for a shape it does not take.
extern "C" int rt_assign_stats(const void* x, const void* cb2, const void* csqn, void* partial,
                               void* sums, void* counts, long long n, int m, int k, int ds,
                               int bf16, int P, void* stream) {
  return assign_stats(x, cb2, csqn, partial, sums, counts, nullptr, 0.0f, nullptr, nullptr, n, m,
                      k, ds, bf16 ? 1 : 0, P, stream);
}

// As rt_assign_stats in f32 mode, with the verification outputs: escale (m,)
// f32 and rho set the margin below which a (row, subquantizer) is flagged (see
// csrc/encode.cu); codes (n, m) int32 receives the chosen codes; flags (n,)
// int32, zeroed by the caller, receives 1 for a row with any flagged
// subquantizer.
extern "C" int rt_assign_stats_verify(const void* x, const void* cb2, const void* csqn,
                                      void* partial, void* sums, void* counts,
                                      const void* escale, float rho, void* codes, void* flags,
                                      long long n, int m, int k, int ds, int P, void* stream) {
  if (escale == nullptr || codes == nullptr || flags == nullptr) return -1;
  return assign_stats(x, cb2, csqn, partial, sums, counts, escale, rho, codes, flags, n, m, k, ds,
                      2, P, stream);
}
