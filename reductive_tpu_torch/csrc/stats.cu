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
//   1. the tile's subvectors go to shared memory (already rounded in bf16
//      mode);
//   2. assignment on the tensor cores.  f32 mode: the 3xTF32 split product
//      (wgmma) and pairwise selection of csrc/assign_tile.cuh, whose row-tile
//      loop (copy_rows, assign_rows, flag_row) the f32 encode runs too, so
//      both give a row the same code and flag.  bf16 mode:
//      mma.sync with the accumulator started at -|c|^2, as csrc/encode.cu.  The
//      codes go to shared memory, -1 for rows past n;
//   3. accumulation without atomics, with work proportional to the rows.  Up
//      to 256 centroids: a counting sort of the tile's row slots by code
//      (per-warp histograms from __match_any_sync, a prefix over warps and
//      cells, a uint16 permutation), after which thread c walks its own
//      segment in row order and adds the subvectors, read from shared memory,
//      into registers that live on over the tiles.  More centroids: a bitonic
//      sort of the unique keys (code << 10 | slot); the thread at the head of
//      each run adds the run in row order and then adds the tile's sum into the
//      cell of the block's slot, so only cells that occur in the tile are
//      touched.  A tile whose rows all fall in one cell is one thread walking
//      all of them.
// The block's result goes to its own slot of a (P, m, k, ds + 1) partial
// buffer (the last column holds the count, an integer); a second kernel adds
// the P slots in slot order.  Every sum is therefore taken in one fixed order:
// per cell the tiles in the block's stride order, the rows of a tile in row
// order, the slots in slot order.
//
// In bf16 mode the sums are of the bf16-rounded x (accumulated in f32), as in
// the TPU kernel, where one rounded copy of x feeds both products.
//
// Verified mode (stats_f32_kernel with VERIFY; replaces the TPU kernel
// reductive_tpu/ops/stats.py::_stats_verify_kernel): the f32 mode, whose
// assignment also carries the best distance over all other indices and flags a
// (row, subquantizer) whose top-2 margin is within the bound the wrapper sets
// (ops/assign.py derives it for the split product).  It writes the chosen
// codes as (m, n) int32, neighbouring threads on neighbouring rows so that
// whole sectors go out, and the rows' flags (integer atomicOr on a zeroed
// array) beside the statistics, so that the wrapper can re-encode the flagged
// rows with the exact path and move a changed row between cells.  The
// accumulation, the slots and the reduction are the f32 mode's: two launches
// still give the same bits.
//
// What bounds it on an H100: f32 mode, the selection's compares and selects
// on the half-rate ALU pipe (the products, 3 x 2*n*m*k*ds operations in TF32,
// and the bytes of x are both below it); bf16 mode, likewise its selection.
// In f32 mode the next tile's subvectors are copied by cp.async into a second
// buffer while this tile is assigned and accumulated; no TMA ring: a tile is
// 16 KB and the staged centroids 16 to 64 KB.  Shared memory is dynamic: it
// exceeds 48 KB.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "assign_tile.cuh"
#include "assign_wide.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kCentroidTile = assign_tile::kCentroidTile;
static_assert(kCentroidTile == kThreads, "one thread per staged centroid");

// ---- accumulation -------------------------------------------------------------

// Shared scratch of the accumulation for a tile of TILE row slots.
template <int TILE>
struct Scratch {
  static_assert(TILE >= 32 && TILE <= 1024 && (TILE & (TILE - 1)) == 0, "tile of 32 to 1024 slots");
  static constexpr int kHist = kWarps * kCentroidTile;  // ints; also the TILE sort keys
  static constexpr int kBytes = 4 * (kHist + kCentroidTile + kWarps) + 2 * TILE;
  int* hist;             // [kWarps][kCentroidTile]
  int* off;              // [kCentroidTile]
  int* warp_total;       // [kWarps]
  unsigned short* perm;  // [TILE]
  __device__ explicit Scratch(unsigned char* base)
      : hist(reinterpret_cast<int*>(base)), off(hist + kHist), warp_total(off + kCentroidTile),
        perm(reinterpret_cast<unsigned short*>(warp_total + kWarps)) {}
};

template <int DS>
__device__ __forceinline__ void add_row(const float* xs, int slot, float (&acc)[DS]) {
  const float4* p = reinterpret_cast<const float4*>(xs + slot * DS);
#pragma unroll
  for (int t = 0; t < DS / 4; ++t) {
    const float4 v = p[t];
    acc[4 * t + 0] += v.x;
    acc[4 * t + 1] += v.y;
    acc[4 * t + 2] += v.z;
    acc[4 * t + 3] += v.w;
  }
}

// k <= 256: thread c adds the tile's rows of cell c to acc / cnt, in row order.
// Counting sort: warp w ranks the slots [w * CPW * 32, (w + 1) * CPW * 32), 32 at
// a time; a slot's rank among the tile's slots with its code is the count in
// the warps before it, plus the count in its warp's earlier chunks, plus the
// peers before it in its chunk.
template <int DS, int TILE>
__device__ __forceinline__ void accumulate_counting(const float* xs, const int* codes,
                                                    Scratch<TILE> s, float (&acc)[DS],
                                                    unsigned int& cnt) {
  constexpr int NCH = TILE / 32;                          // chunks of 32 slots
  constexpr int CPW = NCH >= kWarps ? NCH / kWarps : 1;   // chunks a warp ranks
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const bool ranks = warp * CPW < NCH;
  int* my_hist = s.hist + warp * kCentroidTile;

  for (int e = threadIdx.x; e < kWarps * kCentroidTile; e += kThreads) s.hist[e] = 0;
  __syncthreads();

  int rank[CPW];
  if (ranks) {
#pragma unroll
    for (int q = 0; q < CPW; ++q) {
      const int c = codes[(warp * CPW + q) * 32 + lane];
      const unsigned int peers = __match_any_sync(0xffffffffu, c);
      const int before = __popc(peers & ((1u << lane) - 1u));
      const int seen = c >= 0 ? my_hist[c] : 0;
      rank[q] = seen + before;
      __syncwarp();
      if (c >= 0 && before == 0) my_hist[c] = seen + __popc(peers);
      __syncwarp();
    }
  }
  __syncthreads();

  // Cell c = threadIdx.x: exclusive prefix over the warps, then over the cells.
  const int c = threadIdx.x;
  int total = 0;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) {
    const int here = s.hist[w * kCentroidTile + c];
    s.hist[w * kCentroidTile + c] = total;
    total += here;
  }
  int incl = total;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int v = __shfl_up_sync(0xffffffffu, incl, d);
    if (lane >= d) incl += v;
  }
  if (lane == 31) s.warp_total[warp] = incl;
  __syncthreads();
  int start = incl - total;
  for (int w = 0; w < warp; ++w) start += s.warp_total[w];
  s.off[c] = start;
  __syncthreads();

  if (ranks) {
#pragma unroll
    for (int q = 0; q < CPW; ++q) {
      const int slot = (warp * CPW + q) * 32 + lane;
      const int cc = codes[slot];
      if (cc >= 0) s.perm[s.off[cc] + my_hist[cc] + rank[q]] = (unsigned short)slot;
    }
  }
  __syncthreads();

  for (int i = start; i < start + total; ++i) add_row<DS>(xs, s.perm[i], acc);
  cnt += (unsigned int)total;
}

// k > 256: sort the unique keys code << 10 | slot (rows past n: all ones, at
// the end); the head of each run adds it in row order and adds the tile's sum
// into the cell of the block's slot.
template <int DS, int TILE>
__device__ __forceinline__ void accumulate_sorted(const float* xs, const int* codes,
                                                  Scratch<TILE> s, float* __restrict__ slot) {
  unsigned int* key = reinterpret_cast<unsigned int*>(s.hist);
  for (int e = threadIdx.x; e < TILE; e += kThreads) {
    const int c = codes[e];
    key[e] = c >= 0 ? ((unsigned int)c << 10) | (unsigned int)e : 0xffffffffu;
  }
  __syncthreads();
  for (int size = 2; size <= TILE; size <<= 1) {
    for (int stride = size >> 1; stride > 0; stride >>= 1) {
      for (int e = threadIdx.x; e < TILE / 2; e += kThreads) {
        const int i = 2 * e - (e & (stride - 1));
        const int j = i + stride;
        const unsigned int a = key[i], b = key[j];
        if ((a > b) == ((i & size) == 0)) {
          key[i] = b;
          key[j] = a;
        }
      }
      __syncthreads();
    }
  }
  for (int i = threadIdx.x; i < TILE; i += kThreads) {
    unsigned int kk = key[i];
    if (kk == 0xffffffffu) continue;
    const unsigned int c = kk >> 10;
    if (i > 0 && (key[i - 1] >> 10) == c) continue;  // not the head of its run
    float acc[DS];
#pragma unroll
    for (int t = 0; t < DS; ++t) acc[t] = 0.0f;
    unsigned int cnt = 0;
    int j = i;
    do {
      add_row<DS>(xs, (int)(kk & 1023u), acc);
      ++cnt;
      if (++j == TILE) break;
      kk = key[j];
    } while ((kk >> 10) == c);  // all ones >> 10 is no code
    float* cell = slot + (long long)c * (DS + 1);
#pragma unroll
    for (int t = 0; t < DS; ++t) cell[t] += acc[t];
    cell[DS] = __uint_as_float(__float_as_uint(cell[DS]) + cnt);
  }
}

// Step 3 for one tile whose codes and subvectors lie in shared memory (the
// caller has synchronised).  `one` (k <= kThreads): acc and cnt live on over
// the tiles; else the tile's sums go into `slot`.
template <int DS, int TILE>
__device__ __forceinline__ void accumulate_tile(const float* xs, const int* codes,
                                                Scratch<TILE> s, bool one,
                                                float* __restrict__ slot, float (&acc)[DS],
                                                unsigned int& cnt) {
  if (one)
    accumulate_counting<DS, TILE>(xs, codes, s, acc, cnt);
  else
    accumulate_sorted<DS, TILE>(xs, codes, s, slot);
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

// ---- f32 mode: 3xTF32 on the tensor cores ---------------------------------------

// SUB 64-row subtiles a warpgroup assigns per tile, one after the other.
template <int DS, int SUB>
struct F32Shape {
  static constexpr int kTile = assign_tile::kTileRows<SUB, kThreads>;
  static constexpr int kBytes =
      assign_tile::Shape<DS>::kBytes + 4 * (2 * kTile * DS + 3 * kTile) + Scratch<kTile>::kBytes;
};

template <int DS, int SUB, bool VERIFY>
__global__ void __launch_bounds__(kThreads, assign_tile::kMinBlocks<DS>)
stats_f32_kernel(const float* __restrict__ x, const float* __restrict__ cb2,
                 const float* __restrict__ csqn, float* __restrict__ partial,
                 const float* __restrict__ escale, float rho, int* __restrict__ codes_out,
                 int* __restrict__ flags, long long n, int m, int k, int P) {
  constexpr int kTile = F32Shape<DS, SUB>::kTile;
  extern __shared__ __align__(16) unsigned char smem[];
  uint32_t* s_w = reinterpret_cast<uint32_t*>(smem);               // split 2c, both parts
  float* s_n = reinterpret_cast<float*>(s_w) + 2 * assign_tile::Shape<DS>::kPartFloats;  // |c|^2
  float* s_x2 = s_n + kCentroidTile;                               // [2][kTile][DS]
  int* s_code = reinterpret_cast<int*>(s_x2 + 2 * kTile * DS);     // [kTile]
  float* s_best = reinterpret_cast<float*>(s_code + kTile);        // [kTile] chosen distance
  float* s_second = s_best + kTile;                                // [kTile] VERIFY: runner-up
  Scratch<kTile> scratch(reinterpret_cast<unsigned char*>(s_second + kTile));

  // Neighbouring blocks take the m subquantizers of the same rows, so that the
  // sectors of a row they share meet in L2.
  const int j = blockIdx.x % m;
  const int p = blockIdx.x / m;
  const long long n_tiles = (n + kTile - 1) / kTile;
  const bool one = k <= kThreads;
  float* slot = partial + ((long long)p * m + j) * (long long)k * (DS + 1);
  const float* cbj = cb2 + (long long)j * k * DS;
  const float* nj = csqn + (long long)j * k;

  float acc[DS];
  unsigned int cnt = 0;
#pragma unroll
  for (int e = 0; e < DS; ++e) acc[e] = 0.0f;
  if (!one) zero_slot<DS>(slot, k);

  // The tile's subvectors come by cp.async into the buffer the previous tile
  // does not use, while that tile is assigned and accumulated.
  int buffer = 0;
  if (p < n_tiles) assign_tile::copy_rows<DS, kTile, kThreads>(x, n, m, j, p, s_x2);

  int staged = -1;
  for (long long tile = p; tile < n_tiles; tile += P) {
    const long long row0 = tile * kTile;
    const float* s_x = s_x2 + buffer * (kTile * DS);
    assign_tile::wait_rows();
    __syncthreads();  // this tile has landed; the previous tile's accumulation has ended
    buffer ^= 1;
    if (tile + P < n_tiles)
      assign_tile::copy_rows<DS, kTile, kThreads>(x, n, m, j, tile + P, s_x2 + buffer * (kTile * DS));

    assign_tile::assign_rows<DS, SUB, kThreads, VERIFY>(s_w, s_n, staged, cbj, nj, k, s_x, s_code,
                                                        s_best, s_second);
    __syncthreads();

    // Rows past n take no part in the statistics; the verified mode writes its
    // codes, whole sectors at a time, and flags a row whose margin is small.
    for (int e = threadIdx.x; e < kTile; e += kThreads) {
      const long long row = row0 + e;
      if (row >= n) {
        s_code[e] = -1;
      } else if constexpr (VERIFY) {
        codes_out[(long long)j * n + row] = s_code[e];
        assign_tile::flag_row<DS>(s_x + e * DS, s_best[e], s_second[e], escale[j], rho,
                                  flags + row);
      }
    }
    __syncthreads();
    accumulate_tile<DS, kTile>(s_x, s_code, scratch, one, slot, acc, cnt);
  }
  if (one) write_slot<DS>(slot, k, acc, cnt);
}

// ---- bf16 mode on the tensor cores -----------------------------------------

constexpr int kRowTiles = 4;  // 16-row tiles a warp holds
constexpr int kRowsPerBlock = kWarps * kRowTiles * 16;

template <int DS>
struct Bf16Shape {
  static constexpr int DSP = (DS + 7) / 8 * 8;
  static constexpr int kBytes = 4 * (kRowsPerBlock * DS + kCentroidTile + kRowsPerBlock) +
                                Scratch<kRowsPerBlock>::kBytes + 2 * kCentroidTile * DSP;
};

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
  unsigned char* s_scratch = reinterpret_cast<unsigned char*>(s_code + kTile);
  Scratch<kTile> scratch(s_scratch);
  __nv_bfloat16* s_c =
      reinterpret_cast<__nv_bfloat16*>(s_scratch + Scratch<kTile>::kBytes);  // [kCentroidTile][DSP]

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
    __syncthreads();  // the previous tile's accumulation has ended: s_x and s_code are free
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
    accumulate_tile<DS, kTile>(s_x, s_code, scratch, one, slot, sum, cnt);
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
template <int DS>
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
    constexpr int bytes = Bf16Shape<DS>::kBytes;
    err = cudaFuncSetAttribute(stats_bf16_kernel<DS>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               bytes);
    if (err != cudaSuccess) return err;
    stats_bf16_kernel<DS><<<(unsigned)blocks, kThreads, bytes, stream>>>(x, cb2, csqn, partial, n,
                                                                         m, k, P);
  } else {
    constexpr int SUB = assign_tile::kSubtiles<DS>;
    constexpr int bytes = F32Shape<DS, SUB>::kBytes;
    auto kern = mode == 2 ? stats_f32_kernel<DS, SUB, true> : stats_f32_kernel<DS, SUB, false>;
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
    case 4: return (int)launch<4>(xf, cf, nf, pf, sf, tf, ef, rho, co, fl, n, m, k, mode, P, s);
    case 8: return (int)launch<8>(xf, cf, nf, pf, sf, tf, ef, rho, co, fl, n, m, k, mode, P, s);
    case 16: return (int)launch<16>(xf, cf, nf, pf, sf, tf, ef, rho, co, fl, n, m, k, mode, P, s);
    case 32: return (int)launch<32>(xf, cf, nf, pf, sf, tf, ef, rho, co, fl, n, m, k, mode, P, s);
    default: return -1;
  }
}

// ---- the wide route: statistics from the codes -----------------------------
//
// At every ds outside 4, 8, 16, 32 the assignment is assign_wide.cuh's (the
// wide encode's, bit for bit), written as codes (m, n) int32.  The statistics
// then come from the codes in an order fixed by the shapes and the codes
// alone, with scratch that grows with n*m and not with the number of blocks:
//   1. a stable LSD radix sort of the n*m cell ids j*k + code (8-bit digits;
//      per sort tile an integer histogram, an exclusive scan over (digit,
//      tile) in that order, a stable placement ranked by __match_any_sync),
//      carrying the row index, so each cell's rows come out in row order;
//   2. the cells' counts (integer atomics) and their exclusive scan, the
//      start of each cell's segment;
//   3. one block per cell adds its segment's subvectors: lanes across the
//      columns (and across rows where ds < 32), each a strided walk of the
//      rows in order, then the partials in a fixed order.
// No float atomics: two launches give the same bits.  In bf16 mode the sums
// are of the bf16-rounded x.

constexpr int kSortTile = 8192;  // keys a block ranks, 256 at a time

int radix_passes(long long cells) {
  int bits = 0;
  while ((1LL << bits) < cells) ++bits;
  return bits <= 8 ? 1 : (bits + 7) / 8;
}

// Key and row of key slot g: codes (m, n) in the first pass, else the last
// pass's output.
__device__ __forceinline__ void key_at(const int* __restrict__ codes, const int* __restrict__ keys,
                                       const int* __restrict__ rows, long long g, long long n, int k,
                                       int& key, int& row) {
  if (codes != nullptr) {
    const long long jj = g / n;
    key = (int)(jj * k) + codes[g];
    row = (int)(g - jj * n);
  } else {
    key = keys[g];
    row = rows[g];
  }
}

__global__ void __launch_bounds__(kThreads)
digit_hist_kernel(const int* __restrict__ codes, const int* __restrict__ keys, long long N,
                  long long n, int k, int shift, int T, int* __restrict__ hist) {
  __shared__ int h[256];
  h[threadIdx.x] = 0;
  __syncthreads();
  const long long base = (long long)blockIdx.x * kSortTile;
  for (int i = threadIdx.x; i < kSortTile; i += kThreads) {
    const long long g = base + i;
    if (g < N) {
      int key, row;
      key_at(codes, keys, keys, g, n, k, key, row);
      atomicAdd(&h[(key >> shift) & 255], 1);  // integers: the count is the same in any order
    }
  }
  __syncthreads();
  hist[(long long)threadIdx.x * T + blockIdx.x] = h[threadIdx.x];  // digit-major
}

// Exclusive scan of v[0 .. len) in place, by one block of 1024 threads, 8
// values a thread at a time.
__global__ void __launch_bounds__(1024) exclusive_scan_kernel(int* __restrict__ v, long long len) {
  constexpr int kItems = 8;
  __shared__ int warp_sum[32];
  __shared__ int carry;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  if (threadIdx.x == 0) carry = 0;
  __syncthreads();
  for (long long base = 0; base < len; base += 1024 * kItems) {
    const long long at = base + (long long)threadIdx.x * kItems;
    int item[kItems];
    int total = 0;
#pragma unroll
    for (int i = 0; i < kItems; ++i) {
      item[i] = at + i < len ? v[at + i] : 0;
      total += item[i];
    }
    int incl = total;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int u = __shfl_up_sync(0xffffffffu, incl, o);
      if (lane >= o) incl += u;
    }
    if (lane == 31) warp_sum[warp] = incl;
    __syncthreads();
    if (warp == 0) {
      int w = warp_sum[lane];
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const int u = __shfl_up_sync(0xffffffffu, w, o);
        if (lane >= o) w += u;
      }
      warp_sum[lane] = w;  // inclusive over the warps
    }
    __syncthreads();
    int run = carry + (warp > 0 ? warp_sum[warp - 1] : 0) + incl - total;
#pragma unroll
    for (int i = 0; i < kItems; ++i) {
      if (at + i < len) v[at + i] = run;
      run += item[i];
    }
    __syncthreads();
    if (threadIdx.x == 0) carry += warp_sum[31];
    __syncthreads();
  }
}

__global__ void __launch_bounds__(kThreads)
digit_scatter_kernel(const int* __restrict__ codes, const int* __restrict__ keys_in,
                     const int* __restrict__ rows_in, long long N, long long n, int k, int shift,
                     int T, const int* __restrict__ offsets, int* __restrict__ keys_out,
                     int* __restrict__ rows_out) {
  __shared__ int running[256];
  __shared__ int warp_cnt[kWarps][256];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  running[threadIdx.x] = offsets[(long long)threadIdx.x * T + blockIdx.x];
#pragma unroll
  for (int w = 0; w < kWarps; ++w) warp_cnt[w][threadIdx.x] = 0;
  __syncthreads();
  const long long base = (long long)blockIdx.x * kSortTile;
  for (int c0 = 0; c0 < kSortTile; c0 += kThreads) {
    const long long g = base + c0 + threadIdx.x;
    const bool valid = g < N;
    int key = 0, row = 0;
    if (valid) key_at(codes, keys_in, rows_in, g, n, k, key, row);
    const int digit = valid ? (key >> shift) & 255 : 256;
    const unsigned int peers = __match_any_sync(0xffffffffu, digit);
    const int before = __popc(peers & ((1u << lane) - 1u));
    if (valid && before == 0) warp_cnt[warp][digit] = __popc(peers);
    __syncthreads();
    if (valid) {
      int pos = running[digit] + before;
      for (int w = 0; w < warp; ++w) pos += warp_cnt[w][digit];
      keys_out[pos] = key;
      rows_out[pos] = row;
    }
    __syncthreads();
    int add = 0;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      add += warp_cnt[w][threadIdx.x];
      warp_cnt[w][threadIdx.x] = 0;
    }
    running[threadIdx.x] += add;
    __syncthreads();
  }
}

__global__ void __launch_bounds__(kThreads)
cell_count_kernel(const int* __restrict__ codes, long long N, long long n, int k,
                  int* __restrict__ count) {
  const long long stride = (long long)gridDim.x * kThreads;
  for (long long g = (long long)blockIdx.x * kThreads + threadIdx.x; g < N; g += stride) {
    const long long jj = g / n;
    atomicAdd(count + jj * k + codes[g], 1);
  }
}

// One block per cell: sums[cell, :] over the rows of its segment, in order.
__global__ void __launch_bounds__(kThreads)
segment_sums_kernel(const float* __restrict__ x, const int* __restrict__ rows,
                    const int* __restrict__ start, float* __restrict__ sums,
                    float* __restrict__ counts, int m, int k, int ds, int bf16) {
  __shared__ float part[kThreads];
  const long long cell = blockIdx.x;
  const int j = (int)(cell / k);
  const int s0 = start[cell], s1 = start[cell + 1];
  if (threadIdx.x == 0) counts[cell] = (float)(s1 - s0);
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int cw = ds < 32 ? ds : 32;  // columns a warp takes at once
  const int rpw = 32 / cw;           // rows a warp takes at once
  const int groups = kWarps * rpw;   // rows the block takes at once
  const bool active = lane < rpw * cw;
  const int col = lane % cw;
  const int rs = warp * rpw + lane / cw;
  const long long d = (long long)m * ds;
  const float* xj = x + (long long)j * ds;
  for (int t0 = 0; t0 < ds; t0 += cw) {
    if (active) {
      float acc = 0.0f;
      if (t0 + col < ds) {
        for (int p = s0 + rs; p < s1; p += groups) {
          float v = xj[(long long)rows[p] * d + t0 + col];
          if (bf16) v = __bfloat162float(__float2bfloat16_rn(v));
          acc += v;
        }
      }
      part[rs * cw + col] = acc;
    }
    __syncthreads();
    if (threadIdx.x < cw && t0 + threadIdx.x < ds) {
      float total = 0.0f;
      for (int r = 0; r < groups; ++r) total += part[r * cw + threadIdx.x];
      sums[cell * ds + t0 + threadIdx.x] = total;
    }
    __syncthreads();
  }
}

// int32 words of the scratch of rt_assign_stats_wide: two key and two row
// buffers of n*m, the digit histogram, the cells' starts.
long long wide_scratch_words(long long n, int m, int k) {
  const long long N = n * m;
  const long long T = (N + kSortTile - 1) / kSortTile;
  return 4 * N + 256 * T + (long long)m * k + 1;
}

int assign_stats_wide(const float* x, const float* cb2, const float* csqn, int* codes,
                      const float* escale, float rho, int* flags, int* scratch, float* sums,
                      float* counts, long long n, int m, int k, int ds, int mode,
                      cudaStream_t s) {
  if (n <= 0 || m <= 0 || k <= 0 || ds <= 0) return -1;
  const long long N = n * m, C = (long long)m * k;
  if (N > 0x7fffffffLL || C > 0x7fffffffLL) return -1;
  cudaError_t err = assign_wide::launch(x, cb2, csqn, {codes, 1, n, 0}, mode == 1, mode == 2,
                                        escale, rho, flags, n, m, k, ds, s);
  if (err != cudaSuccess) return (int)err;
  const long long T = (N + kSortTile - 1) / kSortTile;
  if (T > 0x7fffffffLL / 256) return -1;
  int* keys[2] = {scratch, scratch + N};
  int* rows[2] = {scratch + 2 * N, scratch + 3 * N};
  int* hist = scratch + 4 * N;
  int* start = hist + 256 * T;

  if ((err = cudaMemsetAsync(start, 0, (C + 1) * sizeof(int), s)) != cudaSuccess) return (int)err;
  const long long count_blocks = (N + kThreads - 1) / kThreads;
  cell_count_kernel<<<(unsigned)(count_blocks < 65536 ? count_blocks : 65536), kThreads, 0, s>>>(
      codes, N, n, k, start);
  exclusive_scan_kernel<<<1, 1024, 0, s>>>(start, C + 1);

  const int passes = radix_passes(C);
  for (int p = 0; p < passes; ++p) {
    const int* in_codes = p == 0 ? codes : nullptr;
    const int* in_keys = p == 0 ? nullptr : keys[(p - 1) & 1];
    const int* in_rows = p == 0 ? nullptr : rows[(p - 1) & 1];
    digit_hist_kernel<<<(unsigned)T, kThreads, 0, s>>>(in_codes, in_keys, N, n, k, 8 * p, (int)T,
                                                       hist);
    exclusive_scan_kernel<<<1, 1024, 0, s>>>(hist, 256 * T);
    digit_scatter_kernel<<<(unsigned)T, kThreads, 0, s>>>(in_codes, in_keys, in_rows, N, n, k,
                                                          8 * p, (int)T, hist, keys[p & 1],
                                                          rows[p & 1]);
  }
  segment_sums_kernel<<<(unsigned)C, kThreads, 0, s>>>(x, rows[(passes - 1) & 1], start, sums,
                                                       counts, m, k, ds, mode == 1);
  return (int)cudaGetLastError();
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
// ops/assign.py); codes (m, n) int32 receives the chosen codes, one row of it
// per subquantizer; flags (n,) int32, zeroed by the caller, receives 1 for a
// row with any flagged subquantizer.
extern "C" int rt_assign_stats_verify(const void* x, const void* cb2, const void* csqn,
                                      void* partial, void* sums, void* counts,
                                      const void* escale, float rho, void* codes, void* flags,
                                      long long n, int m, int k, int ds, int P, void* stream) {
  if (escale == nullptr || codes == nullptr || flags == nullptr) return -1;
  return assign_stats(x, cb2, csqn, partial, sums, counts, escale, rho, codes, flags, n, m, k, ds,
                      2, P, stream);
}

// Scratch of rt_assign_stats_wide, in int32 words.
extern "C" long long rt_assign_stats_wide_scratch(long long n, int m, int k) {
  return wide_scratch_words(n, m, k);
}

// The statistics at a ds the narrow kernels do not take (any ds >= 1): the
// wide assignment into codes (m, n) int32, then the statistics from the codes
// (see "the wide route" above).  mode: 0 f32, 1 bf16, 2 verified (escale (m,)
// f32, rho, and flags (n,) int32 zeroed by the caller).  scratch: the int32
// words rt_assign_stats_wide_scratch names; sums (m, k, ds), counts (m, k)
// f32.  Returns cudaGetLastError() after the launches; -1 for a shape it does
// not take.
extern "C" int rt_assign_stats_wide(const void* x, const void* cb2, const void* csqn, void* codes,
                                    const void* escale, float rho, void* flags, void* scratch,
                                    void* sums, void* counts, long long n, int m, int k, int ds,
                                    int mode, void* stream) {
  if (mode == 2 && (escale == nullptr || flags == nullptr)) return -1;
  return assign_stats_wide((const float*)x, (const float*)cb2, (const float*)csqn, (int*)codes,
                           (const float*)escale, rho, (int*)flags, (int*)scratch, (float*)sums,
                           (float*)counts, n, m, k, ds, mode, (cudaStream_t)stream);
}
