// Nearest-centroid assignment of a tile of rows on the tensor cores, as
// device functions a kernel includes.
//
//   a[i] = argmin_c (|c|^2 - 2c.x_i), first index on ties
//
// The cross term is a 3xTF32 split product: x = x_hi + x_lo and 2c = w_hi +
// w_lo, each part a TF32 value (cvt.rna, 11 significant bits), and
//   s = x_lo.w_hi + x_hi.w_lo + x_hi.w_hi
// in that order, the two small products first, in fp32 accumulators that start
// at zero.  The distance is then n_c - s in one rounded fp32 subtraction, as on
// the fp32-pipe route.  Error of s against the real 2c.x (derived in
// ops/assign.py): (3.25 + 5 ceil(ds/8)) 2^-22 |2c| |x|.
//
// The products are wgmma.mma_async.m64n64k8.tf32: a warpgroup (four warps)
// takes 64 rows against 64 staged centroids at a depth of 8, which is one
// ds = 8 subvector (ds = 4 is padded with zeros, ds = 16 / 32 take 2 / 4 depth
// steps).  A, the split rows, comes from registers; B, both parts of the
// staged 2c, from shared memory in the layout the instruction reads without a
// swizzle: 8 x 16-byte core matrices, [8 centroids][4 dims], 128 bytes on to
// the other half of the depth and 256 bytes on to the next 8 centroids.
// Measured first with mma.sync.m16n8k8 (twelve instructions per 64 x 8 scores
// of a warp, fragments of 2c read from shared memory by the threads): the
// same time as one unpipelined wgmma per 128 centroids; the pipeline below is
// what wgmma adds.
//
// What remains per score is the subtraction and the selection (compare,
// min/max and select run on the half-rate ALU pipe of this card), and that is
// what sets the time, not the products.  So the selection is cut:
//   * a thread sees, per row, the columns 2t, 2t+1 of every 8-column group in
//     rising order.  Per pair it takes m = min(d0, d1) and updates (best,
//     group, d0 of the winning pair) only when m < best: 5 ALU operations a
//     pair where the (value, index) loop needs 6.  The column is read back at
//     the end: d0 == best picks 2t, else 2t+1, on the very values the minimum
//     was taken from, so the first index wins exactly;
//   * VERIFY also keeps the least distance over all other indices: the pair's
//     larger value and the loser of (m, best) are the two candidates;
//   * the four lanes of a row settle (value, index) by two shuffles, smaller
//     index on equal values.
// Overlap: the staged tile is taken in quarters of 64 centroids with two
// accumulator sets of 32 registers; the three wgmma of quarter q + 1 are in
// flight while quarter q is selected.
//
// The kernels that include this header (csrc/encode.cu in f32 and verified
// mode, csrc/stats.cu in f32 and verified mode) walk their row tiles with
// copy_rows / wait_rows, assign each tile with assign_rows and flag a row with
// flag_row, so a row gets the same (code, best, second) bits and the same flag
// from every one of them.
//
// bf16 mode (assign_rows_bf16, at the end; encode_bf16_kernel and
// stats_bf16_kernel walk the same row-tile loop): x and 2c rounded to
// bfloat16 (nearest even), s = 2c.x one wgmma.mma_async.m64n64k16.bf16 a
// quarter and depth step of 16 (ds = 4 and 8 padded with zeros, ds = 32 two
// steps) into accumulators that start at zero, then d = |c|^2 - s in one
// rounded fp32 subtraction and the f32 mode's pairwise selection with its
// updates on the FMA pipe (PickFma).  A, the rounded rows, comes from
// registers, loaded from the f32 copy that copy_rows landed (the statistics
// kernel has that copy rounded in place by the same loads, so it sums the
// very values the products saw); B, the staged 2c in bf16, from shared memory
// in the no-swizzle layout above with 16 values a core-matrix pair, converted
// once per block (k <= 256) or per centroid tile.
//
// Every width from 1 to 32 runs here.  The kernels are compiled for DS in 4,
// 8, 16, 32; a ds outside those, or rows that do not start on 16 bytes, run
// the instance for the padded width DSP = padded_width(ds) with PAD set: the
// rows come at their own stride m*ds by 4- or 8-byte copies (16-byte ones
// where ds is a multiple of 4 and x is aligned; copy_rows below) into rows of
// DSP values whose columns ds .. DSP - 1 are zeros (zero_pad_columns, once a
// block), and the centroids are staged from (k, ds) with zeros past ds.  A
// zero column adds exact zeros to every product, norm and sum, so the padded
// instance assigns as a kernel compiled for ds would, in the same depth steps
// of 8 (16 in bf16) from zero as the wide route's shallow kernel takes at
// ds <= 32, except at 17 <= ds <= 24: there DSP = 32 takes a fourth step of
// zeros in f32 mode, which ops/assign.py's verify bound counts (route
// "tf32x3_pad").  Without PAD the kernels are the instructions they were.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace assign_tile {

constexpr int kCentroidTile = 256;  // centroids staged in shared memory at a time
constexpr int kQuarter = 64;        // centroids one wgmma takes
constexpr int kSubtile = 64;        // rows one wgmma takes

// The route argument of the C entries (ops/assign.py assign_route): this
// header's kernels at any ds <= 32, the deep kernel (assign_deep.cuh) above,
// or the shallow one (assign_wide.cuh), which only a forced route takes.
constexpr int kRouteNarrow = 0;
constexpr int kRouteDeep = 1;
constexpr int kRouteShallow = 2;

// The width of the instance that takes subvectors of ds <= 32 values: the
// least of 4, 8, 16, 32 that holds them (ops/assign.py padded_ds).
__host__ __device__ constexpr int padded_width(int ds) {
  return ds <= 4 ? 4 : ds <= 8 ? 8 : ds <= 16 ? 16 : 32;
}

// Whether x (n, m*ds) needs the padded instance: a ds outside 4, 8, 16, 32,
// or rows that do not start on 16 bytes.
inline bool needs_pad(const void* x, int ds) {
  return ds != padded_width(ds) || (reinterpret_cast<uintptr_t>(x) & 15) != 0;
}

// Values a copy of the padded instance moves: 4 where ds is a multiple of 4
// and x is on 16 bytes, 2 where ds is even and x is on 8 bytes, else 1.
inline int row_vector(const void* x, int ds) {
  const uintptr_t a = reinterpret_cast<uintptr_t>(x);
  return ds % 4 == 0 && (a & 15) == 0 ? 4 : ds % 2 == 0 && (a & 7) == 0 ? 2 : 1;
}

// x = hi + lo + r with hi, lo TF32 values and |r| <= 2^-22 |x|.
__device__ __forceinline__ void split_tf32(float v, uint32_t& hi, uint32_t& lo) {
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(hi) : "f"(v));
  const float rest = v - __uint_as_float(hi);  // exact
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(lo) : "f"(rest));
}

// d (+)= a . b^T: a, 64 x 8 in the warpgroup's registers; b, 64 x 8 in shared
// memory behind desc_b; d, 64 x 64 in the warpgroup's registers, overwritten
// unless `accumulate`.
__device__ __forceinline__ void wgmma_m64n64k8_tf32(float (&d)[32], const uint32_t (&a)[4],
                                                    uint64_t desc_b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 {"
      "%0,%1,%2,%3,%4,%5,%6,%7,%8,%9,%10,%11,%12,%13,%14,%15,"
      "%16,%17,%18,%19,%20,%21,%22,%23,%24,%25,%26,%27,%28,%29,%30,%31}, "
      "{%32,%33,%34,%35}, %36, p, 1, 1;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(accumulate));
}

// d (+)= a . b^T in bf16: a, 64 x 16 in the warpgroup's registers (mma.sync's
// m16n8k16 A layout a warp, load_rows_bf16); b, 64 x 16 in shared memory
// behind desc_b (K-major, no swizzle); d, 64 x 64 in f32.
__device__ __forceinline__ void wgmma_m64n64k16_bf16_rs(float (&d)[32], const uint32_t (&a)[4],
                                                        uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0,%1,%2,%3,%4,%5,%6,%7,%8,%9,%10,%11,%12,%13,%14,%15,"
      "%16,%17,%18,%19,%20,%21,%22,%23,%24,%25,%26,%27,%28,%29,%30,%31}, "
      "{%32,%33,%34,%35}, %36, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
        "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(accumulate));
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
// Waits until at most PENDING committed groups are in flight.
template <int PENDING>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(PENDING) : "memory");
}
// Keeps the compiler from reading the accumulators before the wait for the
// asynchronous product.
template <int N>
__device__ __forceinline__ void pin(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

template <int DS>
struct Shape {
  static constexpr int KS = (DS + 7) / 8;  // depth steps of 8; ds = 4 is padded with zeros
  static constexpr int DSP = KS * 8;
  // One part (hi or lo) of the staged centroid tile: [KS][32 groups of 8
  // centroids][2 halves of the depth][8 centroids][4 dims].
  static constexpr int kStepFloats = kCentroidTile * 8;
  static constexpr int kPartFloats = KS * kStepFloats;
  // Both parts, then |c|^2.
  static constexpr int kBytes = 4 * (2 * kPartFloats + kCentroidTile);
};

// Shared-memory descriptor of 64 centroids of one part and depth step, no
// swizzle: 128 bytes to the core matrix of the depth's other half, 256 bytes
// to that of the next 8 centroids.
__device__ __forceinline__ uint64_t b_descriptor(const uint32_t* part_step, int quarter) {
  const uint32_t addr =
      (uint32_t)__cvta_generic_to_shared(part_step) + (uint32_t)quarter * (kQuarter / 8) * 256u;
  return (uint64_t)((addr & 0x3ffffu) >> 4) | ((uint64_t)(128u >> 4) << 16) |
         ((uint64_t)(256u >> 4) << 32);
}

// Stage the centroids k0 .. k0 + kt - 1 of one subquantizer (cbj: (k, ds) f32
// holding 2c, ds <= DS; nj: (k,) f32 holding |c|^2): split 2c into s_w (hi
// part, then lo part) in the layout above, zeros past ds.  Columns from kt up
// to the next multiple of 64 get zeros and |c|^2 = +inf: they never win.  The
// caller synchronises around it; the fence makes the writes visible to the
// tensor cores' reads.
template <int DS, int THREADS>
__device__ __forceinline__ void stage_centroids(uint32_t* s_w, float* s_n,
                                                const float* __restrict__ cbj,
                                                const float* __restrict__ nj, int k0, int kt,
                                                int ds) {
  constexpr int DSP = Shape<DS>::DSP;
  const int padded = (kt + kQuarter - 1) / kQuarter * kQuarter;
  for (int e = threadIdx.x; e < padded * DSP; e += THREADS) {
    const int c = e / DSP;
    const int tt = e - c * DSP;
    const float v = (c < kt && tt < ds) ? cbj[(long long)(k0 + c) * ds + tt] : 0.0f;
    uint32_t hi, lo;
    split_tf32(v, hi, lo);
    const int at = (tt >> 3) * Shape<DS>::kStepFloats + (c >> 3) * 64 + ((tt >> 2) & 1) * 32 +
                   (c & 7) * 4 + (tt & 3);
    s_w[at] = hi;
    s_w[Shape<DS>::kPartFloats + at] = lo;
  }
  for (int e = threadIdx.x; e < padded; e += THREADS)
    s_n[e] = e < kt ? nj[k0 + e] : __int_as_float(0x7f800000);
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// The running selection of a thread's two rows of a 64-row subtile: rows
// 16 w + g and 16 w + g + 8 (w the warp within its warpgroup, g = lane / 4).
template <bool VERIFY>
struct Pick {
  float best[2];    // least distance so far
  float keep[2];    // d0 of the pair that holds it
  int base[2];      // first column of the 8-column group that holds it
  float second[2];  // VERIFY: least distance over all other indices

  __device__ __forceinline__ void reset() {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      best[h] = keep[h] = second[h] = __int_as_float(0x7f800000);  // +inf
      base[h] = 0;
    }
  }

  // Scores d0, d1 of the columns col0 + 2t, col0 + 2t + 1 for row h.
  __device__ __forceinline__ void take(int h, float d0, float d1, int col0) {
    const float lo = fminf(d0, d1);
    if constexpr (VERIFY) {
      // The pair's larger value lost to its smaller; the loser of (lo, best)
      // is the other candidate for second place.
      second[h] = fminf(fminf(second[h], fmaxf(d0, d1)), fmaxf(lo, best[h]));
    }
    if (lo < best[h]) {
      best[h] = lo;
      keep[h] = d0;
      base[h] = col0;
    }
  }

  // Settle row h over its four lanes.  On return every lane of the row holds
  // the chosen index, its distance and (VERIFY) the least distance over all
  // other indices.
  __device__ __forceinline__ void finish(int h, int& idx, float& dist, float& runner_up) const {
    const int t = threadIdx.x & 3;
    float v = best[h];
    float s = second[h];
    int i = base[h] + 2 * t + (keep[h] == v ? 0 : 1);
#pragma unroll
    for (int off = 1; off <= 2; off <<= 1) {
      const float ov = __shfl_xor_sync(0xffffffffu, v, off);
      const int oi = __shfl_xor_sync(0xffffffffu, i, off);
      if constexpr (VERIFY) {
        const float os = __shfl_xor_sync(0xffffffffu, s, off);
        s = fminf(fminf(s, os), fmaxf(v, ov));  // equal bests: margin 0
      }
      if (ov < v || (ov == v && oi < i)) {
        v = ov;
        i = oi;
      }
    }
    idx = i;
    dist = v;
    runner_up = s;
  }
};

// The thread's part of a 64-row subtile as split A fragments.  xs: the
// subtile's first row in shared memory, rows [DS] apart.
template <int DS>
__device__ __forceinline__ void load_rows(const float* xs, uint32_t (&ah)[Shape<DS>::KS][4],
                                          uint32_t (&al)[Shape<DS>::KS][4]) {
  const int lane = threadIdx.x & 31;
  const int row0 = 16 * ((threadIdx.x >> 5) & 3) + (lane >> 2);
  const int t = lane & 3;
#pragma unroll
  for (int ks = 0; ks < Shape<DS>::KS; ++ks) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {  // fragment register i: row + 8 (i % 2), column t + 4 (i / 2)
      const int col = ks * 8 + t + 4 * (i >> 1);
      const float v = col < DS ? xs[(row0 + 8 * (i & 1)) * DS + col] : 0.0f;
      split_tf32(v, ah[ks][i], al[ks][i]);
    }
  }
}

// Start the three products of one quarter of the staged centroid tile into d
// and commit them as one group.
template <int DS>
__device__ __forceinline__ void start_products(float (&d)[32], const uint32_t* s_w, int quarter,
                                               const uint32_t (&ah)[Shape<DS>::KS][4],
                                               const uint32_t (&al)[Shape<DS>::KS][4]) {
  constexpr int KS = Shape<DS>::KS;
  constexpr int kStep = Shape<DS>::kStepFloats;
  const uint32_t* s_hi = s_w;
  const uint32_t* s_lo = s_w + Shape<DS>::kPartFloats;
  wgmma_fence();  // the selection has read d; the split rows were just written
#pragma unroll
  for (int ks = 0; ks < KS; ++ks)
    wgmma_m64n64k8_tf32(d, al[ks], b_descriptor(s_hi + ks * kStep, quarter), ks > 0);
#pragma unroll
  for (int ks = 0; ks < KS; ++ks)
    wgmma_m64n64k8_tf32(d, ah[ks], b_descriptor(s_lo + ks * kStep, quarter), 1);
#pragma unroll
  for (int ks = 0; ks < KS; ++ks)
    wgmma_m64n64k8_tf32(d, ah[ks], b_descriptor(s_hi + ks * kStep, quarter), 1);
  wgmma_commit();
}

// Scan NQ quarters of the staged centroid tile (the last one holding
// `last_cols` columns) for one subtile.  The products of quarter q + 1 run
// while quarter q is selected; NQ is static so that the pipeline has no branch
// around a product.
template <int DS, bool VERIFY, int NQ>
__device__ __forceinline__ void scan_quarters(const uint32_t* s_w, const float* s_n, int k0,
                                              int last_cols,
                                              const uint32_t (&ah)[Shape<DS>::KS][4],
                                              const uint32_t (&al)[Shape<DS>::KS][4],
                                              Pick<VERIFY>& pick) {
  const int t = threadIdx.x & 3;
  float d[2][32];
  start_products<DS>(d[0], s_w, 0, ah, al);
#pragma unroll
  for (int q = 0; q < NQ; ++q) {
    if (q + 1 < NQ) {
      start_products<DS>(d[(q + 1) & 1], s_w, q + 1, ah, al);
      wgmma_wait<1>();
    } else {
      wgmma_wait<0>();
    }
    pin(d[q & 1]);
#pragma unroll
    for (int i = 0; i < kQuarter / 8; ++i) {
      if (q + 1 < NQ || 8 * i < last_cols) {  // the same for every thread
        const float2 nn = *reinterpret_cast<const float2*>(s_n + q * kQuarter + 8 * i + 2 * t);
        const int col0 = k0 + q * kQuarter + 8 * i;
        pick.take(0, nn.x - d[q & 1][4 * i + 0], nn.y - d[q & 1][4 * i + 1], col0);
        pick.take(1, nn.x - d[q & 1][4 * i + 2], nn.y - d[q & 1][4 * i + 3], col0);
      }
    }
  }
}

// Scan the staged centroid tile (kt columns, global columns k0 ..) for one
// subtile.  All four warps of the warpgroup call it together.
template <int DS, bool VERIFY>
__device__ __forceinline__ void scan(const uint32_t* s_w, const float* s_n, int k0, int kt,
                                     const uint32_t (&ah)[Shape<DS>::KS][4],
                                     const uint32_t (&al)[Shape<DS>::KS][4], Pick<VERIFY>& pick) {
  const int quarters = (kt + kQuarter - 1) / kQuarter;  // the same for every thread
  const int last_cols = kt - (quarters - 1) * kQuarter;
  switch (quarters) {
    case 1: scan_quarters<DS, VERIFY, 1>(s_w, s_n, k0, last_cols, ah, al, pick); break;
    case 2: scan_quarters<DS, VERIFY, 2>(s_w, s_n, k0, last_cols, ah, al, pick); break;
    case 3: scan_quarters<DS, VERIFY, 3>(s_w, s_n, k0, last_cols, ah, al, pick); break;
    default: scan_quarters<DS, VERIFY, 4>(s_w, s_n, k0, last_cols, ah, al, pick); break;
  }
}

// ---- a tile of rows -----------------------------------------------------------

// Rows of a tile: THREADS / 128 warpgroups, SUB 64-row subtiles each, which a
// warpgroup assigns one after the other.
template <int SUB, int THREADS>
constexpr int kTileRows = THREADS / 128 * SUB * kSubtile;

// Per ds, for blocks of 256 threads: the subtiles a warpgroup takes per tile
// (tiles of 1,024, 512, 256 and 128 rows), and the blocks an SM should hold.
// At ds = 4 (and the widths padded to it) a tile of 1,024 rows shares the
// statistics' counting sort, whose fixed work a tile does not shrink with
// ds, over twice the rows: 2.86 -> 2.54 ms (stats) and 1.92 -> 1.87 (encode)
// at d=20, m=10, k=128, n=4,000,000 on an H100 (C entry).  The two
// accumulator sets take 64 registers and the split rows 8 per depth step:
// above ds = 8 a thread needs more than the 128 registers that two resident
// blocks leave it.
template <int DS>
constexpr int kSubtiles = DS <= 4 ? 8 : DS <= 8 ? 4 : 32 / DS;
template <int DS>
constexpr int kMinBlocks = DS <= 8 ? 2 : 1;

// The padded instance: subquantizer j's ds values of the rows tile * ROWS ..
// (x: (n, m * ds) f32) into the first ds columns of dst ([ROWS][DS] in shared
// memory) by cp.async, V values (4 * V bytes) a copy; rows past n get zeros.
// Columns ds .. DS - 1 are not written: zero_pad_columns zeroed them.
template <int DS, int ROWS, int THREADS, int V>
__device__ __forceinline__ void copy_rows_padded(const float* __restrict__ x, long long n, int m,
                                                 int j, long long tile, float* dst, int ds) {
  constexpr int U = DS / V;  // copies a staged row holds
  const long long d = (long long)m * ds;
  for (int e = threadIdx.x; e < ROWS * U; e += THREADS) {
    const int r = e / U;
    const int c = V * (e - r * U);
    if (c >= ds) continue;  // a pad column
    const long long row = tile * ROWS + r;
    float* to = dst + r * DS + c;
    if (row < n) {
      const float* src = x + row * d + (long long)j * ds + c;
      asm volatile("cp.async.ca.shared.global [%0], [%1], %2;\n" ::"r"(
                       (uint32_t)__cvta_generic_to_shared(to)),
                   "l"(src), "n"(4 * V)
                   : "memory");
    } else {
#pragma unroll
      for (int v = 0; v < V; ++v) to[v] = 0.0f;
    }
  }
}

// Start the copy of subquantizer j's subvectors of the rows tile * ROWS ..
// into dst ([ROWS][DS] in shared memory); wait_rows() waits for it.  Without
// PAD (x: (n, m * DS) f32 on 16 bytes) by cp.async, 16 bytes a thread, rows
// past n zeros; with PAD (x: (n, m * ds) f32, ds <= DS, vec from row_vector)
// copy_rows_padded.
template <int DS, int ROWS, int THREADS, bool PAD>
__device__ __forceinline__ void copy_rows(const float* __restrict__ x, long long n, int m, int j,
                                          long long tile, float* dst, int ds, int vec) {
  if constexpr (PAD) {
    if (vec == 4)
      copy_rows_padded<DS, ROWS, THREADS, 4>(x, n, m, j, tile, dst, ds);
    else if (vec == 2)
      copy_rows_padded<DS, ROWS, THREADS, 2>(x, n, m, j, tile, dst, ds);
    else
      copy_rows_padded<DS, ROWS, THREADS, 1>(x, n, m, j, tile, dst, ds);
    return;
  }
  constexpr int V = DS / 4;  // 16-byte words of a subvector
  const long long d = (long long)m * DS;
  for (int e = threadIdx.x; e < ROWS * V; e += THREADS) {
    const long long row = tile * ROWS + e / V;
    if (row < n) {
      const float* src = x + row * d + (long long)j * DS + 4 * (e % V);
      asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                       (uint32_t)__cvta_generic_to_shared(dst + 4 * e)),
                   "l"(src)
                   : "memory");
    } else {
      reinterpret_cast<float4*>(dst)[e] = make_float4(0.f, 0.f, 0.f, 0.f);
    }
  }
}

// The padded instance's zero columns ds .. DS - 1 of both row buffers
// (s_x2: [2][ROWS][DS]), written once at a block's start: no copy writes
// them, and rounding a zero in place (bf16 statistics) leaves a zero.
template <int DS, int ROWS, int THREADS>
__device__ __forceinline__ void zero_pad_columns(float* s_x2, int ds) {
  for (int e = threadIdx.x; e < 2 * ROWS * DS; e += THREADS)
    if (e % DS >= ds) s_x2[e] = 0.0f;
}

__device__ __forceinline__ void wait_rows() { asm volatile("cp.async.wait_all;\n" ::: "memory"); }

// Assign the rows of a tile whose subvectors lie in shared memory (s_x,
// [kTileRows][DS]) to the k centroids of one subquantizer (cbj: (k, ds) f32
// holding 2c, ds <= DS; nj: (k,) f32 holding |c|^2).  Per row of the tile: the chosen
// index (s_code), its distance (s_best) and, VERIFY, the least distance over
// all other indices (s_second).  The centroids are staged 256 at a time into
// s_w / s_n whenever `staged` (the first centroid held there; -1 for none)
// differs, so with k <= 256 a block stages them once for all its row tiles.
// The result over the centroid tiles so far lives in shared memory; an earlier
// tile keeps a tie (its indices are smaller).  Every thread of the block calls
// it; the caller synchronises before the results are read.
template <int DS, int SUB, int THREADS, bool VERIFY>
__device__ __forceinline__ void assign_rows(uint32_t* s_w, float* s_n, int& staged,
                                            const float* __restrict__ cbj,
                                            const float* __restrict__ nj, int k, int ds,
                                            const float* s_x, int* s_code, float* s_best,
                                            float* s_second) {
  constexpr int KS = Shape<DS>::KS;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int g = lane >> 2;
  const int t = lane & 3;
  for (int k0 = 0; k0 < k; k0 += kCentroidTile) {
    const int kt = min(kCentroidTile, k - k0);
    if (staged != k0) {  // the same for every thread
      __syncthreads();
      stage_centroids<DS, THREADS>(s_w, s_n, cbj, nj, k0, kt, ds);
      staged = k0;
      __syncthreads();
    }
#pragma unroll 1
    for (int s = 0; s < SUB; ++s) {
      uint32_t ah[KS][4], al[KS][4];
      const int first = ((warp >> 2) * SUB + s) * kSubtile;
      load_rows<DS>(s_x + first * DS, ah, al);
      Pick<VERIFY> pick;
      pick.reset();
      scan<DS, VERIFY>(s_w, s_n, k0, kt, ah, al, pick);
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        int idx;
        float best, second;
        pick.finish(h, idx, best, second);
        const int in_tile = first + 16 * (warp & 3) + g + 8 * h;
        if (t == 0) {
          if (k0 > 0) {
            const float old = s_best[in_tile];
            if constexpr (VERIFY) second = fminf(fminf(second, s_second[in_tile]), fmaxf(best, old));
            if (!(best < old)) {
              best = old;
              idx = s_code[in_tile];
            }
          }
          s_code[in_tile] = idx;
          s_best[in_tile] = best;
          if constexpr (VERIFY) s_second[in_tile] = second;
        }
      }
    }
  }
}

// VERIFY: OR 1 into *flag when the row's margin (second - best) is not above
// 2 escale |x_j| + rho |best|, the limit ops/assign.py derives for this
// product.  xs: the row's subvector in shared memory.  The margin is +inf with
// k = 1; a NaN flags.
template <int DS>
__device__ __forceinline__ void flag_row(const float* xs, float best, float second, float escale,
                                         float rho, int* flag) {
  float xn2 = 0.0f;
#pragma unroll
  for (int c = 0; c < DS; ++c) xn2 = fmaf(xs[c], xs[c], xn2);
  const float margin = second - best;
  const float limit = 2.0f * escale * sqrtf(xn2) + rho * fabsf(best);
  if (!(margin > limit)) atomicOr(flag, 1);
}

// ---- bf16 mode ------------------------------------------------------------------

// Per ds, for blocks of 256 threads: the subtiles a warpgroup takes per tile
// (tiles of 512 rows, 256 at ds = 32, where the two f32 buffers of the rows
// would otherwise leave one block on an SM) and the blocks an SM holds:
// three where their shared memory fits (ds <= 8), with one accumulator set a
// warpgroup (80 registers a thread), else two, with two sets, the products of
// quarter q + 1 in flight while quarter q is selected.  Measured at ds = 8 on
// an H100 (C entry, encode / stats): two blocks with two sets 4.08 / 5.25 ms,
// three with one 3.86 / 4.59.  ops/assign.py bf16_tile_plan repeats this;
// the C entries refuse a plan that differs.
template <int DS>
constexpr int kBf16Subtiles = DS == 32 ? 2 : 4;
template <int DS>
constexpr int kBf16Blocks = DS <= 8 ? 3 : 2;

// Byte offset of (centroid c, depth column tt) in the staged bf16 centroids:
// [depth step of 16][c / 8][half of the step][c % 8][8 values], so that a
// quarter of a step is 2 KB and b_descriptor() addresses it.
__device__ __forceinline__ int bf16_offset(int c, int tt) {
  return (tt >> 4) * kCentroidTile * 32 + (c >> 3) * 256 + ((tt >> 3) & 1) * 128 + (c & 7) * 16 +
         (tt & 7) * 2;
}

// The shared memory of a bf16 block: the staged centroids (2c in bf16, then
// |c|^2 in f32), two f32 buffers of the rows for copy_rows, and per row the
// chosen code and distance.
template <int DS, int SUB, int THREADS>
struct Bf16Tile {
  static constexpr int KS = (DS + 15) / 16;  // depth steps of 16
  static constexpr int kRows = kTileRows<SUB, THREADS>;
  static constexpr int kCentroidBytes = KS * kCentroidTile * 32;
  static constexpr int kBytes = kCentroidBytes + 4 * (kCentroidTile + 2 * kRows * DS + 2 * kRows);
  unsigned char* s_c;  // 2c, bf16
  float* s_n;          // |c|^2 [kCentroidTile]
  float* s_x2;         // [2][kRows][DS]
  int* s_code;         // [kRows]
  float* s_best;       // [kRows]
  __device__ explicit Bf16Tile(unsigned char* base)
      : s_c(base),
        s_n(reinterpret_cast<float*>(base + kCentroidBytes)),
        s_x2(s_n + kCentroidTile),
        s_code(reinterpret_cast<int*>(s_x2 + 2 * kRows * DS)),
        s_best(reinterpret_cast<float*>(s_code + kRows)) {}
};

// Stage the centroids k0 .. k0 + kt - 1 of one subquantizer (cbj: (k, ds) f32
// holding 2c, already bf16 values, ds <= DS; nj: (k,) f32 holding |c|^2) into
// s_c / s_n, zeros past ds.  Columns from kt up to the next multiple of 64 get
// zeros and |c|^2 = +inf.  The caller synchronises around it.
template <int DS, int THREADS>
__device__ __forceinline__ void stage_centroids_bf16(unsigned char* s_c, float* s_n,
                                                     const float* __restrict__ cbj,
                                                     const float* __restrict__ nj, int k0, int kt,
                                                     int ds) {
  constexpr int kPairs = (DS + 15) / 16 * 8;  // pairs of values of a padded centroid
  const int padded = (kt + kQuarter - 1) / kQuarter * kQuarter;
  for (int e = threadIdx.x; e < padded * kPairs; e += THREADS) {
    const int c = e / kPairs;
    const int tt = 2 * (e - c * kPairs);
    float2 v = make_float2(0.0f, 0.0f);
    if (c < kt && tt < ds) {
      const float* at = cbj + (long long)(k0 + c) * ds + tt;
      if (ds % 2 == 0)  // a pair on 8 bytes
        v = *reinterpret_cast<const float2*>(at);
      else
        v = make_float2(at[0], tt + 1 < ds ? at[1] : 0.0f);
    }
    *reinterpret_cast<__nv_bfloat162*>(s_c + bf16_offset(c, tt)) =
        __floats2bfloat162_rn(v.x, v.y);
  }
  for (int e = threadIdx.x; e < padded; e += THREADS)
    s_n[e] = e < kt ? nj[k0 + e] : __int_as_float(0x7f800000);
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// The thread's part of a 64-row subtile as bf16 A fragments (mma.sync's
// m16n8k16 layout: row g or g + 8 of the warp's 16, columns 2t, 2t + 1, then
// the same 8 further), zeros past ds.  xs: the subtile's first row in shared
// memory, rows [DS] apart.  ROUND also writes the rounded values back there:
// each value of the subtile is loaded by exactly one thread of its warpgroup.
template <int DS, bool ROUND>
__device__ __forceinline__ void load_rows_bf16(float* xs, uint32_t (&a)[(DS + 15) / 16][4]) {
  const int lane = threadIdx.x & 31;
  const int row0 = 16 * ((threadIdx.x >> 5) & 3) + (lane >> 2);
  const int t = lane & 3;
#pragma unroll
  for (int ks = 0; ks < (DS + 15) / 16; ++ks) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int col = 16 * ks + 8 * (i >> 1) + 2 * t;
      float2* at = reinterpret_cast<float2*>(xs + (row0 + 8 * (i & 1)) * DS + col);
      const float2 v = col < DS ? *at : make_float2(0.0f, 0.0f);
      const __nv_bfloat162 b = __floats2bfloat162_rn(v.x, v.y);  // .x (low half) = v.x
      a[ks][i] = *reinterpret_cast<const uint32_t*>(&b);
      if constexpr (ROUND) {
        if (col < DS) *at = __bfloat1622float2(b);
      }
    }
  }
}

// Start the products of one quarter of the staged centroids into d (from
// zero) and commit them as one group.
template <int KS>
__device__ __forceinline__ void start_products_bf16(float (&d)[32], const unsigned char* s_c,
                                                    const uint32_t (&a)[KS][4], int quarter) {
  wgmma_fence();  // the selection has read d; the fragments were just written
#pragma unroll
  for (int ks = 0; ks < KS; ++ks)
    wgmma_m64n64k16_bf16_rs(
        d, a[ks], b_descriptor(reinterpret_cast<const uint32_t*>(s_c + ks * kCentroidTile * 32), quarter),
        ks > 0);
  wgmma_commit();
}

// The bf16 mode's selection: Pick's pairwise walk, state and compares, with
// its three updates as predicated FMAs (x * 1 + 0 is x; a zero of either sign
// compares equal to the other) on the FMA pipe, where Pick's selects take the
// half-rate ALU pipe that the selection waits for; the compare and the
// pair's minimum stay there.  The base is a float (columns below 2^24).
// Measured at ds = 8 on an H100 (C entry, encode / stats): 3.66 / 4.52 ms
// against 3.90 / 4.69 with Pick.
struct PickFma {
  float best[2];  // least distance so far
  float keep[2];  // d0 of the pair that holds it
  float base[2];  // first column of the 8-column group that holds it

  __device__ __forceinline__ void reset() {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      best[h] = keep[h] = __int_as_float(0x7f800000);  // +inf
      base[h] = 0.0f;
    }
  }

  // Scores d0, d1 of the columns col + off + 2t, col + off + 2t + 1 for row h.
  __device__ __forceinline__ void take(int h, float d0, float d1, float col, float off) {
    const float lo = fminf(d0, d1);
    asm("{\n.reg .pred p;\nsetp.lt.f32 p, %3, %0;\n"
        "@p fma.rn.f32 %0, %3, 0f3F800000, 0f00000000;\n"
        "@p fma.rn.f32 %1, %4, 0f3F800000, 0f00000000;\n"
        "@p add.rn.f32 %2, %5, %6;\n}\n"
        : "+f"(best[h]), "+f"(keep[h]), "+f"(base[h])
        : "f"(lo), "f"(d0), "f"(col), "f"(off));
  }

  // As Pick::finish: every lane of row h gets the chosen index and distance.
  __device__ __forceinline__ void finish(int h, int& idx, float& dist) const {
    const int t = threadIdx.x & 3;
    float v = best[h];
    int i = (int)base[h] + 2 * t + (keep[h] == v ? 0 : 1);
#pragma unroll
    for (int off = 1; off <= 2; off <<= 1) {
      const float ov = __shfl_xor_sync(0xffffffffu, v, off);
      const int oi = __shfl_xor_sync(0xffffffffu, i, off);
      if (ov < v || (ov == v && oi < i)) {
        v = ov;
        i = oi;
      }
    }
    idx = i;
    dist = v;
  }
};

// The selection of one quarter: scores |c|^2 - s of the columns col .., the
// first `cols` of them real.
__device__ __forceinline__ void select_quarter(PickFma& pick, const float (&d)[32],
                                               const float* s_nq, int col, int cols) {
  const int t = threadIdx.x & 3;
  const float colf = __int2float_rn(col);
#pragma unroll
  for (int i = 0; i < kQuarter / 8; ++i) {
    if (8 * i < cols) {  // the same for every thread
      const float2 nn = *reinterpret_cast<const float2*>(s_nq + 8 * i + 2 * t);
      pick.take(0, nn.x - d[4 * i + 0], nn.y - d[4 * i + 1], colf, 8.0f * i);
      pick.take(1, nn.x - d[4 * i + 2], nn.y - d[4 * i + 3], colf, 8.0f * i);
    }
  }
}

// scan_quarters of the f32 mode for the bf16 products, with SETS (1 or 2)
// accumulator sets: with two, the products of quarter q + 1 run while
// quarter q is selected; with one, each quarter's products are waited for
// (the other warpgroups of the SM select meanwhile).
template <int KS, int NQ, int SETS>
__device__ __forceinline__ void scan_quarters_bf16(const unsigned char* s_c, const float* s_n,
                                                   const uint32_t (&a)[KS][4], int k0,
                                                   int last_cols, PickFma& pick) {
  float d[SETS][32];
  if constexpr (SETS == 2) start_products_bf16<KS>(d[0], s_c, a, 0);
#pragma unroll
  for (int q = 0; q < NQ; ++q) {
    if constexpr (SETS == 1) {
      start_products_bf16<KS>(d[0], s_c, a, q);
      wgmma_wait<0>();
    } else if (q + 1 < NQ) {
      start_products_bf16<KS>(d[(q + 1) & 1], s_c, a, q + 1);
      wgmma_wait<1>();
    } else {
      wgmma_wait<0>();
    }
    pin(d[q % SETS]);
    select_quarter(pick, d[q % SETS], s_n + q * kQuarter, k0 + q * kQuarter,
                   q + 1 < NQ ? kQuarter : last_cols);
  }
}

// Scan the staged centroid tile (kt columns, global columns k0 ..) for one
// subtile.  All four warps of the warpgroup call it together.
template <int KS, int SETS>
__device__ __forceinline__ void scan_bf16(const unsigned char* s_c, const float* s_n,
                                          const uint32_t (&a)[KS][4], int k0, int kt,
                                          PickFma& pick) {
  const int quarters = (kt + kQuarter - 1) / kQuarter;  // the same for every thread
  const int last = kt - (quarters - 1) * kQuarter;
  switch (quarters) {
    case 1: scan_quarters_bf16<KS, 1, SETS>(s_c, s_n, a, k0, last, pick); break;
    case 2: scan_quarters_bf16<KS, 2, SETS>(s_c, s_n, a, k0, last, pick); break;
    case 3: scan_quarters_bf16<KS, 3, SETS>(s_c, s_n, a, k0, last, pick); break;
    default: scan_quarters_bf16<KS, 4, SETS>(s_c, s_n, a, k0, last, pick); break;
  }
}

// Assign the rows of a tile that copy_rows landed in s_x ([kRows][DS] f32) to
// the k centroids of one subquantizer (cbj: (k, ds) f32 holding 2c, already
// bf16 values, ds <= DS; nj: (k,) f32 holding |c|^2): the chosen index into s_code and
// its distance into s_best, per row (ROUND: s_x then holds the rounded rows).
// The centroids are staged as assign_rows stages them (`staged`: the first
// centroid held, -1 for none), once per block for k <= 256; an earlier
// centroid tile keeps a tie.  Every thread of the block calls it; the caller
// synchronises before the results are read.
template <int DS, int SUB, int THREADS, bool ROUND>
__device__ __forceinline__ void assign_rows_bf16(const Bf16Tile<DS, SUB, THREADS>& sm, int& staged,
                                                 const float* __restrict__ cbj,
                                                 const float* __restrict__ nj, int k, int ds,
                                                 float* s_x) {
  constexpr int KS = Bf16Tile<DS, SUB, THREADS>::KS;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int g = lane >> 2;
  const int t = lane & 3;
  for (int k0 = 0; k0 < k; k0 += kCentroidTile) {
    const int kt = min(kCentroidTile, k - k0);
    if (staged != k0) {  // the same for every thread
      __syncthreads();
      stage_centroids_bf16<DS, THREADS>(sm.s_c, sm.s_n, cbj, nj, k0, kt, ds);
      staged = k0;
      __syncthreads();
    }
#pragma unroll 1
    for (int s = 0; s < SUB; ++s) {
      const int first = ((warp >> 2) * SUB + s) * kSubtile;
      uint32_t a[KS][4];
      load_rows_bf16<DS, ROUND>(s_x + first * DS, a);
      PickFma pick;
      pick.reset();
      scan_bf16<KS, kBf16Blocks<DS> == 3 ? 1 : 2>(sm.s_c, sm.s_n, a, k0, kt, pick);
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        int idx;
        float best;
        pick.finish(h, idx, best);
        const int in_tile = first + 16 * (warp & 3) + g + 8 * h;
        if (t == 0) {
          if (k0 > 0 && !(best < sm.s_best[in_tile])) {
            best = sm.s_best[in_tile];
            idx = sm.s_code[in_tile];
          }
          sm.s_code[in_tile] = idx;
          sm.s_best[in_tile] = best;
        }
      }
    }
  }
}

}  // namespace assign_tile
