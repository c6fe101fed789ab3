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
