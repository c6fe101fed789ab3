// Nearest-centroid assignment at any subvector width ("the wide route"), as a
// kernel that csrc/encode.cu and csrc/stats.cu both instantiate from this one
// header, so that a row gets the same code, and in verified mode the same
// flag, from either.
//
//   a[i] = argmin_c (|c|^2 - 2c.x_i), first index on ties
//
// The narrow route (csrc/assign_tile.cuh) keeps a row tile's split
// subvectors in registers and stages 256 centroids at their whole depth; at
// ds = 128 that staging is 256 KB and at ds = 768 1.5 MB, past the 227 KB a
// block may hold.  This route walks the depth in chunks, as a GEMM main loop
// does: a block of two warpgroups takes 128 rows of one subquantizer, and for
// every tile of 64 centroids it stages the rows' and the centroids' next
// chunk of depth (32 values, zeros past ds) into shared memory while the
// tensor cores take the current one, with both operands read from shared
// memory (wgmma.mma_async m64n64, A and B by descriptor, the no-swizzle
// core-matrix layout of assign_tile.cuh).  The chunks come by cp.async, 4
// bytes at a time (any ds, any alignment), into a ring three steps ahead of
// the one being split.  The accumulators of a (64-row,
// 64-centroid) tile live across the chunks; after the last chunk the scores
// go through assign_tile::Pick, which carries a row's selection across the
// centroid tiles (columns only rise, and an equal distance never replaces
// the earlier index).
//
// f32 mode (3xTF32): x = x_hi + x_lo and 2c = w_hi + w_lo, each part a TF32
// value.  Each chunk's products start from zero in their own accumulators,
// in the narrow route's order (x_lo.w_hi and x_hi.w_lo over the chunk's
// depth, then x_hi.w_hi), and the chunk's sum is added to the running sum
// in one rounded fp32 addition; then d = |c|^2 - s.  An instruction's
// truncation is bounded by the largest magnitude it meets, which for a chunk
// from zero is the chunk's own |x_c| |w_c|, and these sum to at most
// |x| |w|: the bound does not grow with the number of chunks, only by the
// additions.  ops/assign.py derives it (route "tf32x3_wide"):
// (3.5 + (5 + 2^-6) kc + 0.26 chunks) 2^-22 |2c| |x|, kc the instructions of
// depth in a chunk (ceil(ds/8) up to 4; the last chunk is padded with
// zeros).
//
// bf16 mode: x and 2c rounded to bfloat16 (nearest even) as they are staged,
// one product (wgmma m64n64k16 bf16) into H from zero, d = |c|^2 - H.
//
// Verified mode (f32 with VERIFY): the selection also keeps the least
// distance over all other indices; a row whose margin is not above
// 2 escale[j] |x_j| + rho |best| gets flag 1 (integer atomicOr on an array the
// caller zeroed: m blocks share a row).  |x_j| is taken by the four lanes of
// the row in a fixed order.
//
// What bounds it on an H100: the products, 3 x 2 n k ds operations in TF32
// (2 n k ds in bf16).  What the design pays beyond that: every block streams
// its subquantizer's whole codebook through shared memory (n/128 passes over
// k ds values, from L2), splits each value as it is staged, and waits for
// each chunk's products before it overwrites the buffer they read.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "assign_tile.cuh"

namespace assign_wide {

constexpr int kThreads = 256;  // two warpgroups
constexpr int kRows = 128;     // rows of a block, 64 for each warpgroup
constexpr int kCols = 64;      // centroids of a tile: one instruction's N
constexpr int kStages = 4;     // steps of copies in flight: three ahead of the one split

// A 4-byte copy into shared memory that does not hold a register; zeros where
// !valid (src is then not read).
__device__ __forceinline__ void copy4(void* dst, const float* src, bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   (uint32_t)__cvta_generic_to_shared(dst)),
               "l"(src), "r"(valid ? 4 : 0)
               : "memory");
}
// The same, 16 bytes (both addresses 16-byte aligned).
__device__ __forceinline__ void copy16(void* dst, const float* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   (uint32_t)__cvta_generic_to_shared(dst)),
               "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void copy_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
// Waits until at most PENDING committed groups of this thread's copies are in flight.
template <int PENDING>
__device__ __forceinline__ void copy_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(PENDING) : "memory");
}

// Shape of the staged operands for a mode and a chunk of KC instructions of
// depth.  A k-step (one instruction's depth) is 32 bytes of a row: 8 f32 or
// 16 bf16 values.
template <bool BF16, int KC>
struct Shape {
  static constexpr int kStep = BF16 ? 16 : 8;
  static constexpr int W = KC * kStep;                 // values of depth in a chunk
  static constexpr int kParts = BF16 ? 1 : 2;          // hi, lo
  static constexpr int kPartA = KC * kRows * 32;       // bytes of one part of the rows
  static constexpr int kPartB = KC * kCols * 32;
  static constexpr int kBuffer = kParts * (kPartA + kPartB);
  static constexpr int kLoadA = kRows * W / kThreads;  // values a thread stages
  static constexpr int kLoadB = kCols * W / kThreads;
  // A stage of the ring the copies land in: the chunk's rows, centroids and
  // (first chunk of a tile) norms, as they are in global memory.
  static constexpr int kRawA = kRows * W * 4;
  static constexpr int kRawB = kCols * W * 4;
  static constexpr int kRawStage = kRawA + kRawB + kCols * 4;
  // Two buffers of split operands, two norm tiles, the ring.
  static constexpr int kBytes = 2 * kBuffer + 2 * kCols * 4 + kStages * kRawStage;
};

// Element e of an R x W chunk: 32 neighbouring e are 8 rows by 4 columns,
// which land in 32 different banks in the core-matrix layout below.
template <int W>
__device__ __forceinline__ void element(int e, int& r, int& cc) {
  constexpr int CG = W / 4;
  const int h = e >> 5;
  r = (h / CG) * 8 + (e & 7);
  cc = (h % CG) * 4 + ((e >> 3) & 3);
}

// Unit u of 4 neighbouring values (16 bytes) of an R x W chunk: 32
// neighbouring units are 8 rows by 4 units, 512 bytes that a warp stores in
// four passes of the banks.
template <int W>
__device__ __forceinline__ void unit(int u, int& r, int& cc) {
  constexpr int G = W / 4;
  const int rest = u >> 3;
  r = (rest / G) * 8 + (u & 7);
  cc = (rest % G) * 4;
}

// Byte offset of (row r, column cc of the chunk) in one part of R rows:
// [k-step][r / 8][half of the step's depth][r % 8][16 bytes].
template <bool BF16>
__device__ __forceinline__ int offset(int r, int cc, int R) {
  if constexpr (BF16)
    return (cc >> 4) * R * 32 + (r >> 3) * 256 + ((cc >> 3) & 1) * 128 + (r & 7) * 16 + (cc & 7) * 2;
  return (cc >> 3) * R * 32 + (r >> 3) * 256 + ((cc >> 2) & 1) * 128 + (r & 7) * 16 + (cc & 3) * 4;
}

template <bool BF16>
__device__ __forceinline__ void put(unsigned char* part, int part_bytes, int off, float v) {
  if constexpr (BF16) {
    *reinterpret_cast<__nv_bfloat16*>(part + off) = __float2bfloat16_rn(v);
  } else {
    uint32_t hi, lo;
    assign_tile::split_tf32(v, hi, lo);
    *reinterpret_cast<uint32_t*>(part + off) = hi;
    *reinterpret_cast<uint32_t*>(part + part_bytes + off) = lo;
  }
}

// Four values at columns cc .. cc + 3 (cc a multiple of 4): one 16-byte
// store a part in f32 mode, one 8-byte store in bf16 mode.
template <bool BF16>
__device__ __forceinline__ void put4(unsigned char* part, int part_bytes, int off, float4 v) {
  if constexpr (BF16) {
    const __nv_bfloat162 a = __floats2bfloat162_rn(v.x, v.y), b = __floats2bfloat162_rn(v.z, v.w);
    *reinterpret_cast<uint2*>(part + off) =
        make_uint2(*reinterpret_cast<const uint32_t*>(&a), *reinterpret_cast<const uint32_t*>(&b));
  } else {
    uint4 hi, lo;
    assign_tile::split_tf32(v.x, hi.x, lo.x);
    assign_tile::split_tf32(v.y, hi.y, lo.y);
    assign_tile::split_tf32(v.z, hi.z, lo.z);
    assign_tile::split_tf32(v.w, hi.w, lo.w);
    *reinterpret_cast<uint4*>(part + off) = hi;
    *reinterpret_cast<uint4*>(part + part_bytes + off) = lo;
  }
}

// Descriptor of a K-major operand in the no-swizzle layout: 128 bytes to the
// core matrix of the other half of the depth, 256 bytes to the next 8 rows.
__device__ __forceinline__ uint64_t descriptor(const unsigned char* p) {
  const uint32_t addr = (uint32_t)__cvta_generic_to_shared(p);
  return (uint64_t)((addr & 0x3ffffu) >> 4) | ((uint64_t)(128u >> 4) << 16) |
         ((uint64_t)(256u >> 4) << 32);
}

// d (+)= a . b^T, a 64 x 8 (tf32) or 64 x 16 (bf16) and b 64 x the same, both
// in shared memory behind their descriptors.
__device__ __forceinline__ void mma_tf32(float (&d)[32], uint64_t da, uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 {"
      "%0,%1,%2,%3,%4,%5,%6,%7,%8,%9,%10,%11,%12,%13,%14,%15,"
      "%16,%17,%18,%19,%20,%21,%22,%23,%24,%25,%26,%27,%28,%29,%30,%31}, "
      "%32, %33, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
        "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(accumulate));
}

__device__ __forceinline__ void mma_bf16(float (&d)[32], uint64_t da, uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0,%1,%2,%3,%4,%5,%6,%7,%8,%9,%10,%11,%12,%13,%14,%15,"
      "%16,%17,%18,%19,%20,%21,%22,%23,%24,%25,%26,%27,%28,%29,%30,%31}, "
      "%32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
        "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(accumulate));
}

// Where a block writes code (row, j): codes[row * code_row + j * code_col],
// uint8 when code_u8, else int32.
struct CodesOut {
  void* codes;
  long long code_row, code_col;
  int code_u8;
};

// Grid: (n / 128) * m blocks, block b taking rows (b / m) * 128 .. and
// subquantizer b % m (the m blocks of a row tile are neighbours, so the rows
// they share meet in L2).  chunks: depth chunks of KC instructions.
template <bool BF16, int KC, bool VERIFY>
__global__ void __launch_bounds__(kThreads, 1)
wide_assign_kernel(const float* __restrict__ x, const float* __restrict__ cb2,
                   const float* __restrict__ csqn, CodesOut out,
                   const float* __restrict__ escale, float rho, int* __restrict__ flags,
                   long long n, int m, int k, int ds, int chunks, int vec) {
  using S_ = Shape<BF16, KC>;
  constexpr int W = S_::W;
  extern __shared__ __align__(16) unsigned char wide_smem[];
  unsigned char* smem = wide_smem;
  float* s_norm = reinterpret_cast<float*>(smem + 2 * S_::kBuffer);  // [2][kCols]

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int wg = warp >> 2;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int j = blockIdx.x % m;
  const long long row0 = (long long)(blockIdx.x / m) * kRows;
  const long long d = (long long)m * ds;
  const float* xj = x + (long long)j * ds;
  const float* cbj = cb2 + (long long)j * k * ds;
  const float* nj = csqn + (long long)j * k;
  const int tiles = (k + kCols - 1) / kCols;
  const int steps = tiles * chunks;
  const bool rows_move = chunks > 1;  // else the rows' one chunk is staged once

  unsigned char* ring = smem + 2 * S_::kBuffer + 2 * kCols * 4;
  // Global memory -> stage s % kStages of the ring for step s (centroid tile
  // s / chunks, chunk s % chunks), by cp.async: each thread copies the values
  // it splits later, so no other thread's copies need be waited for.
  auto load = [&](int s, bool rows) {
    const int n0 = (s / chunks) * kCols;
    const int c0 = (s % chunks) * W;
    unsigned char* stage = ring + (s % kStages) * S_::kRawStage;
    float* raw_a = reinterpret_cast<float*>(stage);
    float* raw_b = reinterpret_cast<float*>(stage + S_::kRawA);
    if (vec) {  // ds a multiple of 4, rows 16-byte aligned: 16 bytes a copy
      if (rows) {
#pragma unroll
        for (int u = tid; u < kRows * W / 4; u += kThreads) {
          int r, cc;
          unit<W>(u, r, cc);
          const long long row = row0 + r;
          const bool ok = row < n && c0 + cc < ds;
          copy16(raw_a + 4 * u, ok ? xj + row * d + c0 + cc : x, ok);
        }
      }
#pragma unroll
      for (int u = tid; u < kCols * W / 4; u += kThreads) {
        int r, cc;
        unit<W>(u, r, cc);
        const bool ok = n0 + r < k && c0 + cc < ds;
        copy16(raw_b + 4 * u, ok ? cbj + (long long)(n0 + r) * ds + c0 + cc : cb2, ok);
      }
    } else {
      if (rows) {
#pragma unroll
        for (int i = 0; i < S_::kLoadA; ++i) {
          const int e = tid + kThreads * i;
          int r, cc;
          element<W>(e, r, cc);
          const long long row = row0 + r;
          const int col = c0 + cc;
          const bool ok = row < n && col < ds;
          copy4(raw_a + e, ok ? xj + row * d + col : x, ok);
        }
      }
#pragma unroll
      for (int i = 0; i < S_::kLoadB; ++i) {
        const int e = tid + kThreads * i;
        int r, cc;
        element<W>(e, r, cc);
        const int col = c0 + cc;
        const bool ok = n0 + r < k && col < ds;
        copy4(raw_b + e, ok ? cbj + (long long)(n0 + r) * ds + col : cb2, ok);
      }
    }
    if (c0 == 0 && tid < kCols)
      copy4(stage + S_::kRawA + S_::kRawB + 4 * tid, nj + (n0 + tid < k ? n0 + tid : 0), n0 + tid < k);
  };
  // Stage s % kStages -> split operands in buffer s & 1 (both buffers when
  // `both`), fenced for the tensor cores.  The caller has waited for the copies.
  auto store = [&](int s, bool rows, bool both) {
    const unsigned char* stage = ring + (s % kStages) * S_::kRawStage;
    const float* raw_a = reinterpret_cast<const float*>(stage);
    const float* raw_b = reinterpret_cast<const float*>(stage + S_::kRawA);
    for (int b = s & 1; b <= ((s & 1) | (both ? 1 : 0)); ++b) {
      unsigned char* buf = smem + b * S_::kBuffer;
      unsigned char* bb = buf + S_::kParts * S_::kPartA;
      if (vec) {
        if (rows) {
#pragma unroll
          for (int u = tid; u < kRows * W / 4; u += kThreads) {
            int r, cc;
            unit<W>(u, r, cc);
            put4<BF16>(buf, S_::kPartA, offset<BF16>(r, cc, kRows),
                       reinterpret_cast<const float4*>(raw_a)[u]);
          }
        }
#pragma unroll
        for (int u = tid; u < kCols * W / 4; u += kThreads) {
          int r, cc;
          unit<W>(u, r, cc);
          put4<BF16>(bb, S_::kPartB, offset<BF16>(r, cc, kCols),
                     reinterpret_cast<const float4*>(raw_b)[u]);
        }
        continue;
      }
      if (rows) {
#pragma unroll
        for (int i = 0; i < S_::kLoadA; ++i) {
          const int e = tid + kThreads * i;
          int r, cc;
          element<W>(e, r, cc);
          put<BF16>(buf, S_::kPartA, offset<BF16>(r, cc, kRows), raw_a[e]);
        }
      }
#pragma unroll
      for (int i = 0; i < S_::kLoadB; ++i) {
        const int e = tid + kThreads * i;
        int r, cc;
        element<W>(e, r, cc);
        put<BF16>(bb, S_::kPartB, offset<BF16>(r, cc, kCols), raw_b[e]);
      }
    }
    if (s % chunks == 0 && tid < kCols) {  // a padded column never wins
      const int n0 = (s / chunks) * kCols;
      const float nn = reinterpret_cast<const float*>(stage + S_::kRawA + S_::kRawB)[tid];
      s_norm[((s / chunks) & 1) * kCols + tid] = n0 + tid < k ? nn : __int_as_float(0x7f800000);
    }
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  };

  assign_tile::Pick<VERIFY> pick;
  pick.reset();
  // bf16: the products of all chunks.  f32: acc the chunk's products from
  // zero, run their sum over the chunks so far.
  float acc[32], run[32];

  // One group of copies a step (empty past the last), so that group g is step g.
#pragma unroll
  for (int p = 0; p < kStages - 1; ++p) {
    if (p < steps) load(p, p == 0 || rows_move);
    copy_commit();
  }
  copy_wait<kStages - 2>();
  store(0, true, !rows_move);
  __syncthreads();

#pragma unroll 1
  for (int s = 0; s < steps; ++s) {
    const int c = s % chunks;
    const unsigned char* buf = smem + (s & 1) * S_::kBuffer;
    const unsigned char* a_hi = buf + wg * (64 / 8) * 256;
    const unsigned char* b_hi = buf + S_::kParts * S_::kPartA;
    assign_tile::wgmma_fence();
    if constexpr (BF16) {
#pragma unroll
      for (int ks = 0; ks < KC; ++ks)  // from zero at the tile's first chunk
        mma_bf16(acc, descriptor(a_hi + ks * kRows * 32), descriptor(b_hi + ks * kCols * 32),
                 (c == 0 && ks == 0) ? 0 : 1);
    } else {
      // The chunk from zero: x_lo.w_hi and x_hi.w_lo over its depth, then
      // x_hi.w_hi, the narrow route's order.
#pragma unroll
      for (int ks = 0; ks < KC; ++ks)
        mma_tf32(acc, descriptor(a_hi + S_::kPartA + ks * kRows * 32),
                 descriptor(b_hi + ks * kCols * 32), ks > 0);
#pragma unroll
      for (int ks = 0; ks < KC; ++ks)
        mma_tf32(acc, descriptor(a_hi + ks * kRows * 32),
                 descriptor(b_hi + S_::kPartB + ks * kCols * 32), 1);
#pragma unroll
      for (int ks = 0; ks < KC; ++ks)
        mma_tf32(acc, descriptor(a_hi + ks * kRows * 32), descriptor(b_hi + ks * kCols * 32), 1);
    }
    assign_tile::wgmma_commit();
    // While the products run: split step s + 1 into the other buffer (its
    // products are done), and start the copies of step s + kStages - 1 into
    // the stage that step s - 1 left.
    if (s + 1 < steps) {
      copy_wait<kStages - 3>();
      store(s + 1, rows_move, false);
    }
    if (s + kStages - 1 < steps) load(s + kStages - 1, rows_move);
    copy_commit();
    assign_tile::wgmma_wait<0>();
    assign_tile::pin(acc);
    if constexpr (!BF16) {  // one rounded addition a chunk
#pragma unroll
      for (int i = 0; i < 32; ++i) run[i] = c == 0 ? acc[i] : run[i] + acc[i];
    }

    if (c == chunks - 1) {  // the tile's scores are complete: select
      const float(&p)[32] = BF16 ? acc : run;
      const int n0 = (s / chunks) * kCols;
      const float* nrm = s_norm + ((s / chunks) & 1) * kCols;
#pragma unroll
      for (int i = 0; i < kCols / 8; ++i) {
        const float2 nn = *reinterpret_cast<const float2*>(nrm + 8 * i + 2 * t);
        pick.take(0, nn.x - p[4 * i + 0], nn.y - p[4 * i + 1], n0 + 8 * i);
        pick.take(1, nn.x - p[4 * i + 2], nn.y - p[4 * i + 3], n0 + 8 * i);
      }
    }
    __syncthreads();  // the next buffer is written and fenced; this one is free
  }

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    int idx;
    float best, second;
    pick.finish(h, idx, best, second);
    const long long row = row0 + 64 * wg + 16 * (warp & 3) + g + 8 * h;
    if constexpr (VERIFY) {
      // |x_j|^2 by the row's four lanes, columns t, t + 4, ..., then joined
      // in a fixed order.
      float xn2 = 0.0f;
      if (row < n)
        for (int col = t; col < ds; col += 4) {
          const float v = xj[row * d + col];
          xn2 = fmaf(v, v, xn2);
        }
      xn2 += __shfl_xor_sync(0xffffffffu, xn2, 1);
      xn2 += __shfl_xor_sync(0xffffffffu, xn2, 2);
      if (t == 0 && row < n) {
        const float margin = second - best;
        const float limit = 2.0f * escale[j] * sqrtf(xn2) + rho * fabsf(best);
        if (!(margin > limit)) atomicOr(flags + row, 1);
      }
    }
    if (t == 0 && row < n) {
      const long long at = row * out.code_row + (long long)j * out.code_col;
      if (out.code_u8)
        static_cast<uint8_t*>(out.codes)[at] = (uint8_t)idx;
      else
        static_cast<int32_t*>(out.codes)[at] = idx;
    }
  }
}

// Depth steps of one instruction for the mode, and how they are chunked.
inline void chunking(bool bf16, int ds, int& kc, int& chunks) {
  const int step = bf16 ? 16 : 8;
  const int most = bf16 ? 2 : 4;
  const int ks = (ds + step - 1) / step;
  kc = ks < most ? ks : most;
  chunks = (ks + kc - 1) / kc;
}

template <bool BF16, int KC, bool VERIFY>
cudaError_t launch_kc(const float* x, const float* cb2, const float* csqn, CodesOut out,
                      const float* escale, float rho, int* flags, long long n, int m, int k,
                      int ds, int chunks, cudaStream_t stream) {
  constexpr int bytes = Shape<BF16, KC>::kBytes;
  // 16-byte copies where every row's chunk starts on 16 bytes.
  const int vec = ds % 4 == 0 && (reinterpret_cast<uintptr_t>(x) & 15) == 0 &&
                  (reinterpret_cast<uintptr_t>(cb2) & 15) == 0;
  auto kern = wide_assign_kernel<BF16, KC, VERIFY>;
  cudaError_t err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return err;
  const long long blocks = (n + kRows - 1) / kRows * m;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  kern<<<(unsigned)blocks, kThreads, bytes, stream>>>(x, cb2, csqn, out, escale, rho, flags, n, m,
                                                     k, ds, chunks, vec);
  return cudaGetLastError();
}

// The wide assignment of x (n, m*ds) f32 against cb2 (m, k, ds) f32 holding 2c
// (rounded to bf16 values by the caller in bf16 mode) and csqn (m, k) |c|^2.
// verify needs f32 mode, escale (m,) and a zeroed flags (n,).  Returns the
// launch's error; cudaErrorInvalidValue for a shape it does not take.
inline cudaError_t launch(const float* x, const float* cb2, const float* csqn, CodesOut out,
                          bool bf16, bool verify, const float* escale, float rho, int* flags,
                          long long n, int m, int k, int ds, cudaStream_t stream) {
  if (n <= 0) return cudaSuccess;
  if (m <= 0 || k <= 0 || ds <= 0 || (bf16 && verify)) return cudaErrorInvalidValue;
  int kc, chunks;
  chunking(bf16, ds, kc, chunks);
#define RT_WIDE(B, KC, V) \
  return launch_kc<B, KC, V>(x, cb2, csqn, out, escale, rho, flags, n, m, k, ds, chunks, stream)
  if (bf16) {
    if (kc == 1) RT_WIDE(true, 1, false);
    RT_WIDE(true, 2, false);
  }
  if (verify) {
    switch (kc) {
      case 1: RT_WIDE(false, 1, true);
      case 2: RT_WIDE(false, 2, true);
      case 3: RT_WIDE(false, 3, true);
      default: RT_WIDE(false, 4, true);
    }
  }
  switch (kc) {
    case 1: RT_WIDE(false, 1, false);
    case 2: RT_WIDE(false, 2, false);
    case 3: RT_WIDE(false, 3, false);
    default: RT_WIDE(false, 4, false);
  }
#undef RT_WIDE
}

}  // namespace assign_wide
