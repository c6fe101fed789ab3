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
//      both give a row the same code and flag.  bf16 mode: the same loop
//      with assign_tile.cuh's bf16 routine (assign_rows_bf16), which the bf16
//      encode runs too, so both give a row the same code.  The codes go to
//      shared memory, -1 for rows past n;
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
// the TPU kernel, where one rounded copy of x feeds both products: the pass
// that converts a tile for the products rounds its f32 copy in place.
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
// Every ds up to 32 runs these kernels: a ds outside 4, 8, 16, 32 (or rows
// off 16 bytes) runs the instance of the padded width DSP with PAD set
// (assign_tile.cuh: rows copied at their own stride into rows of DSP values
// whose extra columns are zeros, the codebook staged from (k, ds)); counters
// "*_pad" in ops/stats.py.  The accumulators, the slots (P, m, k, DSP + 1)
// and the counting sort are the DSP instance's: the zero columns add zeros,
// and the reduction writes sums (m, k, ds), the pad columns dropped.  Same TPU
// kernels replaced (reductive_tpu/ops/stats.py:50 _stats_kernel, :272
// _stats_verify_kernel); same bound on an H100 (the selection on the ALU
// pipe); padding costs DSP / ds more shared-memory traffic a row in the
// copies, the products and the accumulation.  Wider ds keep the wide route
// below.
//
// What bounds it on an H100: f32 mode, the selection's compares and selects
// on the half-rate ALU pipe (the products, 3 x 2*n*m*k*ds operations in TF32,
// and the bytes of x are both below it); bf16 mode, likewise its selection.
// In both modes the next tile's subvectors are copied by cp.async into a
// second buffer while this tile is assigned and accumulated; no TMA ring: a
// tile is 16 to 64 KB and the staged centroids 8 to 64 KB.  Shared memory is
// dynamic: it exceeds 48 KB.  The bf16 mode's launch plan (rows a tile, P,
// shared memory) is ops/assign.py bf16_tile_plan's.

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

// PAD: the padded instance (x (n, m * ds), cb2 (m, k, ds), ds <= DS; vec
// from assign_tile::row_vector); else ds is DS and vec unused.
template <int DS, int SUB, bool VERIFY, bool PAD>
__global__ void __launch_bounds__(kThreads, assign_tile::kMinBlocks<DS>)
stats_f32_kernel(const float* __restrict__ x, const float* __restrict__ cb2,
                 const float* __restrict__ csqn, float* __restrict__ partial,
                 const float* __restrict__ escale, float rho, int* __restrict__ codes_out,
                 int* __restrict__ flags, long long n, int m, int k, int P, int ds, int vec) {
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
  const int w = PAD ? ds : DS;  // values of a subvector in x and cb2
  const int j = blockIdx.x % m;
  const int p = blockIdx.x / m;
  const long long n_tiles = (n + kTile - 1) / kTile;
  const bool one = k <= kThreads;
  float* slot = partial + ((long long)p * m + j) * (long long)k * (DS + 1);
  const float* cbj = cb2 + (long long)j * k * w;
  const float* nj = csqn + (long long)j * k;

  float acc[DS];
  unsigned int cnt = 0;
#pragma unroll
  for (int e = 0; e < DS; ++e) acc[e] = 0.0f;
  if (!one) zero_slot<DS>(slot, k);

  // The tile's subvectors come by cp.async into the buffer the previous tile
  // does not use, while that tile is assigned and accumulated.
  if constexpr (PAD) assign_tile::zero_pad_columns<DS, kTile, kThreads>(s_x2, w);
  int buffer = 0;
  if (p < n_tiles) assign_tile::copy_rows<DS, kTile, kThreads, PAD>(x, n, m, j, p, s_x2, w, vec);

  int staged = -1;
  for (long long tile = p; tile < n_tiles; tile += P) {
    const long long row0 = tile * kTile;
    const float* s_x = s_x2 + buffer * (kTile * DS);
    assign_tile::wait_rows();
    __syncthreads();  // this tile has landed; the previous tile's accumulation has ended
    buffer ^= 1;
    if (tile + P < n_tiles)
      assign_tile::copy_rows<DS, kTile, kThreads, PAD>(x, n, m, j, tile + P,
                                                       s_x2 + buffer * (kTile * DS), w, vec);

    assign_tile::assign_rows<DS, SUB, kThreads, VERIFY>(s_w, s_n, staged, cbj, nj, k, w, s_x,
                                                        s_code, s_best, s_second);
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

// ---- bf16 mode: assign_tile.cuh's bf16 routine ------------------------------

template <int DS, int SUB, bool PAD>
__global__ void __launch_bounds__(kThreads, assign_tile::kBf16Blocks<DS>)
stats_bf16_kernel(const float* __restrict__ x, const float* __restrict__ cb2,
                  const float* __restrict__ csqn, float* __restrict__ partial, long long n, int m,
                  int k, int P, int ds, int vec) {
  using T = assign_tile::Bf16Tile<DS, SUB, kThreads>;
  constexpr int kTile = T::kRows;
  extern __shared__ __align__(16) unsigned char smem[];
  const T sm(smem);
  Scratch<kTile> scratch(smem + T::kBytes);

  const int w = PAD ? ds : DS;
  const int j = blockIdx.x % m;
  const int p = blockIdx.x / m;
  const long long n_tiles = (n + kTile - 1) / kTile;
  const bool one = k <= kThreads;
  float* slot = partial + ((long long)p * m + j) * (long long)k * (DS + 1);
  const float* cbj = cb2 + (long long)j * k * w;
  const float* nj = csqn + (long long)j * k;

  float acc[DS];
  unsigned int cnt = 0;
#pragma unroll
  for (int e = 0; e < DS; ++e) acc[e] = 0.0f;
  if (!one) zero_slot<DS>(slot, k);

  if constexpr (PAD) assign_tile::zero_pad_columns<DS, kTile, kThreads>(sm.s_x2, w);
  int buffer = 0;
  if (p < n_tiles) assign_tile::copy_rows<DS, kTile, kThreads, PAD>(x, n, m, j, p, sm.s_x2, w, vec);

  int staged = -1;
  for (long long tile = p; tile < n_tiles; tile += P) {
    const long long row0 = tile * kTile;
    float* s_x = sm.s_x2 + buffer * (kTile * DS);
    assign_tile::wait_rows();
    __syncthreads();  // this tile has landed; the previous tile's accumulation has ended
    buffer ^= 1;
    if (tile + P < n_tiles)
      assign_tile::copy_rows<DS, kTile, kThreads, PAD>(x, n, m, j, tile + P,
                                                       sm.s_x2 + buffer * (kTile * DS), w, vec);

    // Rounds s_x in place: the sums are of the rounded rows.
    assign_tile::assign_rows_bf16<DS, SUB, kThreads, true>(sm, staged, cbj, nj, k, w, s_x);
    __syncthreads();
    for (int e = threadIdx.x; e < kTile; e += kThreads)
      if (row0 + e >= n) sm.s_code[e] = -1;  // rows past n take no part
    __syncthreads();
    accumulate_tile<DS, kTile>(s_x, sm.s_code, scratch, one, slot, acc, cnt);
  }
  if (one) write_slot<DS>(slot, k, acc, cnt);
}

// ---- the P slots added in slot order ---------------------------------------

// partial (P, cells, dsp + 1), the count last; sums (cells, ds), ds <= dsp:
// the columns ds .. dsp - 1 of the padded instance are dropped.
__global__ void __launch_bounds__(kThreads)
stats_reduce_kernel(const float* __restrict__ partial, float* __restrict__ sums,
                    float* __restrict__ counts, long long cells, int ds, int dsp, int P) {
  const long long idx = (long long)blockIdx.x * kThreads + threadIdx.x;
  const int w = ds + 1;
  if (idx >= cells * w) return;
  const long long cell = idx / w;
  const int t = (int)(idx - cell * w);
  const long long stride = cells * (dsp + 1);
  const long long at = cell * (dsp + 1) + (t < ds ? t : dsp);
  if (t < ds) {
    float s = 0.0f;
    for (int p = 0; p < P; ++p) s += partial[p * stride + at];
    sums[cell * ds + t] = s;
  } else {
    unsigned long long c = 0;
    for (int p = 0; p < P; ++p) c += __float_as_uint(partial[p * stride + at]);
    counts[cell] = (float)c;
  }
}

cudaError_t reduce(const float* partial, float* sums, float* counts, long long n_cells, int ds,
                   int dsp, int P, cudaStream_t stream) {
  const long long blocks = (n_cells * (ds + 1) + kThreads - 1) / kThreads;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  stats_reduce_kernel<<<(unsigned)blocks, kThreads, 0, stream>>>(partial, sums, counts, n_cells, ds,
                                                                 dsp, P);
  return cudaGetLastError();
}

// verify: the verified mode (f32 with escale, rho, codes_out and flags).
template <int DS, bool PAD>
cudaError_t launch_f32(const float* x, const float* cb2, const float* csqn, float* partial,
                       float* sums, float* counts, const float* escale, float rho, int* codes_out,
                       int* flags, long long n, int m, int k, int ds, bool verify, int P,
                       cudaStream_t stream) {
  const long long blocks = (long long)P * m;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  constexpr int SUB = assign_tile::kSubtiles<DS>;
  constexpr int bytes = F32Shape<DS, SUB>::kBytes;
  auto kern = verify ? stats_f32_kernel<DS, SUB, true, PAD> : stats_f32_kernel<DS, SUB, false, PAD>;
  cudaError_t err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return err;
  kern<<<(unsigned)blocks, kThreads, bytes, stream>>>(x, cb2, csqn, partial, escale, rho, codes_out,
                                                      flags, n, m, k, P, ds,
                                                      assign_tile::row_vector(x, ds));
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  return reduce(partial, sums, counts, (long long)m * k, ds, DS, P, stream);
}

// ds <= DS: the padded instance where assign_tile::needs_pad says.
template <int DS>
cudaError_t launch(const float* x, const float* cb2, const float* csqn, float* partial,
                   float* sums, float* counts, const float* escale, float rho, int* codes_out,
                   int* flags, long long n, int m, int k, int ds, bool verify, int P,
                   cudaStream_t stream) {
  if (assign_tile::needs_pad(x, ds))
    return launch_f32<DS, true>(x, cb2, csqn, partial, sums, counts, escale, rho, codes_out, flags,
                                n, m, k, ds, verify, P, stream);
  return launch_f32<DS, false>(x, cb2, csqn, partial, sums, counts, escale, rho, codes_out, flags,
                               n, m, k, ds, verify, P, stream);
}

int assign_stats(const void* x, const void* cb2, const void* csqn, void* partial, void* sums,
                 void* counts, const void* escale, float rho, void* codes, void* flags,
                 long long n, int m, int k, int ds, bool verify, int P, void* stream) {
  if (n <= 0 || m <= 0 || k <= 0 || P <= 0 || ds <= 0 || ds > 32) return -1;
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
  switch (assign_tile::padded_width(ds)) {
    case 4: return (int)launch<4>(xf, cf, nf, pf, sf, tf, ef, rho, co, fl, n, m, k, ds, verify, P, s);
    case 8: return (int)launch<8>(xf, cf, nf, pf, sf, tf, ef, rho, co, fl, n, m, k, ds, verify, P, s);
    case 16: return (int)launch<16>(xf, cf, nf, pf, sf, tf, ef, rho, co, fl, n, m, k, ds, verify, P, s);
    default: return (int)launch<32>(xf, cf, nf, pf, sf, tf, ef, rho, co, fl, n, m, k, ds, verify, P, s);
  }
}

// The plan (rows a tile, P, shared-memory bytes) is ops/assign.py
// bf16_tile_plan's; -1 for one this build does not hold.
template <int DS, bool PAD>
int launch_bf16_kernel(const float* x, const float* cb2, const float* csqn, float* partial,
                       float* sums, float* counts, long long n, int m, int k, int ds, int P,
                       int bytes, cudaStream_t stream) {
  constexpr int SUB = assign_tile::kBf16Subtiles<DS>;
  const long long blocks = (long long)P * m;
  cudaError_t err = cudaFuncSetAttribute(stats_bf16_kernel<DS, SUB, PAD>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return (int)err;
  stats_bf16_kernel<DS, SUB, PAD><<<(unsigned)blocks, kThreads, bytes, stream>>>(
      x, cb2, csqn, partial, n, m, k, P, ds, assign_tile::row_vector(x, ds));
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  return (int)reduce(partial, sums, counts, (long long)m * k, ds, DS, P, stream);
}

// ds <= DS; the plan is that of DS.
template <int DS>
int launch_bf16(const float* x, const float* cb2, const float* csqn, float* partial, float* sums,
                float* counts, long long n, int m, int k, int ds, int rows, int P, int bytes,
                cudaStream_t stream) {
  using T = assign_tile::Bf16Tile<DS, assign_tile::kBf16Subtiles<DS>, kThreads>;
  constexpr int kBytes = T::kBytes + Scratch<T::kRows>::kBytes;
  if (rows != T::kRows || bytes != kBytes || P <= 0 || (long long)P * m > 0x7fffffffLL) return -1;
  if (assign_tile::needs_pad(x, ds))
    return launch_bf16_kernel<DS, true>(x, cb2, csqn, partial, sums, counts, n, m, k, ds, P, bytes,
                                        stream);
  return launch_bf16_kernel<DS, false>(x, cb2, csqn, partial, sums, counts, n, m, k, ds, P, bytes,
                                       stream);
}

// ---- the wide route: statistics from the codes -----------------------------
//
// At every ds above 32 the assignment is assign_wide.cuh's deep kernel
// (csrc/assign_deep.cuh, the wide encode's, bit for bit; the shallow kernel
// only where a caller forces route 2), written as codes (m, n) int32.  The
// statistics then come from the codes (cell_stats below, also a C entry of
// its own, rt_cell_stats): a segmented reduction whose time follows the bytes
// it reads, not the size of the largest cell.
//   1. A stable LSD radix sort of each subquantizer's codes, carrying the row.
//      The codes are laid out (m, n), already ordered by j, so sort tiles of
//      kSortTile keys never cross a j and the key is the code alone: one
//      8-bit pass at k <= 256, two at k <= 65,536.  A pass is a digit
//      histogram per tile (laid out (j, digit, tile)), its exclusive scan in
//      that order (reduce, scan of the block totals, scan again: any number
//      of blocks), and a placement: each tile ranks its keys in shared memory
//      (per-warp counts from __match_any_sync, warps in order), then writes
//      each digit's run to the place the scan gives it.  Each cell's rows come
//      out in row order.
//   2. The cells' starts and counts from the sort, not from atomics: with one
//      pass the scanned histogram at (j, code, tile 0); with two, a lower
//      bound of the code in j's sorted keys.  Each cell's segment is cut into
//      chunks of R sorted rows (R = cell_chunk_rows(ds), a function of ds
//      alone); the chunks' starts are the exclusive scan of ceil(count / R).
//   3. One warp a chunk (and a column block of at most 32 * L vectors): its
//      lanes cover the subvector's columns with the widest load the address
//      allows (float4, float2 or float); it reads ahead the chunk's row
//      indices, starts U rows' loads before their adds, and adds the rows in
//      row order from +0.  A cell of one chunk writes its sum directly; a
//      cell of more writes each chunk's partial to its slot, and a second
//      launch adds the slots in chunk order from +0 (a cell of no chunk gets
//      a zero sum).  The largest cell is spread over ceil(count / R) warps.
// The contract: no float atomics (the only atomics are integer ones in shared
// memory, one per digit group of a warp); every sum is taken in an order
// fixed by the shapes and the codes (per column the chunk's rows in row
// order, then the chunks in order: ops/stats.py cell_stats_reference follows
// it and the kernels equal it bit for bit), so two launches give the same
// bits; in bf16 mode the sums are of the bf16-rounded x (a template argument,
// not a branch in the loop), accumulated in f32; counts are exact integers;
// an empty cell gets a zero sum and a zero count.  The codes and flags are
// the assignment's, untouched.  What bounds it on an H100: the bytes of x,
// read once (each (row, j) subvector in one chunk), plus the codes; the sort
// moves 4 to 16 bytes a key.  Replaces, with the assignment, the TPU kernels
// reductive_tpu/ops/stats.py::_stats_kernel (:50) and _stats_verify_kernel
// (:272) on the wide route.

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

namespace cells {

constexpr int kSortTile = 4096;                     // keys a sort block ranks
constexpr int kWarpKeys = kSortTile / kWarps;       // of them, each warp's, in order
constexpr int kScanBlock = kThreads * 16;           // values a scan block takes
constexpr int kScatterBytes = 4 * (3 * kSortTile + kWarps * 256 + 2 * 256 + kWarps);

// Sorted rows a chunk holds: the largest power of two R with R * ds <= 16384,
// within [32, 256] (ops/stats.py cell_chunk_rows).
int chunk_rows(int ds) {
  int r = 1;
  while (r < 256 && 2LL * r * ds <= 16384) r *= 2;
  return r < 32 ? 32 : r;
}

// Keys N = n m, cells C = m k, sort tiles a subquantizer Tj, histogram
// entries H, chunks at most Q, scan blocks nb; rows a chunk R, sort passes.
struct Layout {
  long long N, C, Tj, H, Q, nb;
  int R, passes;
};

Layout layout(long long n, int m, int k, int ds) {
  Layout l;
  l.N = n * m;
  l.C = (long long)m * k;
  l.R = chunk_rows(ds);
  l.passes = k <= 256 ? 1 : 2;  // 8-bit digits of the code
  l.Tj = (n + kSortTile - 1) / kSortTile;
  l.H = (long long)m * 256 * l.Tj;
  l.Q = l.N / l.R + l.C;  // chunks at most: sum ceil(count / R) <= N / R + C
  const long long longest = l.H > l.C + 1 ? l.H : l.C + 1;
  l.nb = (longest + kScanBlock - 1) / kScanBlock;
  return l;
}

// int32 words of rt_cell_stats's scratch: the chunks' partial sums (Q, ds)
// f32, the sorted rows (and, with two passes, the keys, double-buffered), the
// digit histogram and its scan, the scan's block totals, the cells' starts
// and the chunks' starts.
long long scratch_words(long long n, int m, int k, int ds) {
  const Layout l = layout(n, m, k, ds);
  return l.Q * ds + (l.passes == 1 ? 1 : 4) * l.N + 2 * l.H + l.nb + 2 * (l.C + 1);
}

// ---- scans of int32 over any number of blocks ----

__device__ __forceinline__ int block_reduce(int v, int* warp_sum) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  if (lane == 0) warp_sum[warp] = v;
  __syncthreads();
  int total = 0;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) total += warp_sum[w];
  return total;
}

// Exclusive scan of v over the block's threads (in thread order); total out.
__device__ __forceinline__ int block_exclusive(int v, int* warp_sum, int& total) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int incl = v;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int u = __shfl_up_sync(0xffffffffu, incl, o);
    if (lane >= o) incl += u;
  }
  if (lane == 31) warp_sum[warp] = incl;
  __syncthreads();
  int before = 0;
  total = 0;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) {
    before += w < warp ? warp_sum[w] : 0;
    total += warp_sum[w];
  }
  return before + incl - v;
}

__global__ void __launch_bounds__(kThreads)
scan_reduce_kernel(const int* __restrict__ in, long long len, int* __restrict__ parts) {
  __shared__ int warp_sum[kWarps];
  const long long base = (long long)blockIdx.x * kScanBlock;
  int v = 0;
  for (int i = threadIdx.x; i < kScanBlock; i += kThreads)
    if (base + i < len) v += in[base + i];
  const int total = block_reduce(v, warp_sum);
  if (threadIdx.x == 0) parts[blockIdx.x] = total;
}

// out = exclusive scan of in (out may be in), given parts = the exclusive
// scan of the blocks' totals.
__global__ void __launch_bounds__(kThreads)
scan_down_kernel(const int* in, int* out, long long len, const int* __restrict__ parts) {
  constexpr int kItems = kScanBlock / kThreads;
  __shared__ int warp_sum[kWarps];
  const long long at = (long long)blockIdx.x * kScanBlock + (long long)threadIdx.x * kItems;
  int item[kItems];
  int own = 0;
#pragma unroll
  for (int i = 0; i < kItems; ++i) {
    item[i] = at + i < len ? in[at + i] : 0;
    own += item[i];
  }
  int total;
  int run = parts[blockIdx.x] + block_exclusive(own, warp_sum, total);
#pragma unroll
  for (int i = 0; i < kItems; ++i) {
    if (at + i < len) out[at + i] = run;
    run += item[i];
  }
}

cudaError_t scan(const int* in, int* out, long long len, int* parts, cudaStream_t s) {
  const long long nb = (len + kScanBlock - 1) / kScanBlock;
  scan_reduce_kernel<<<(unsigned)nb, kThreads, 0, s>>>(in, len, parts);
  exclusive_scan_kernel<<<1, 1024, 0, s>>>(parts, nb);
  scan_down_kernel<<<(unsigned)nb, kThreads, 0, s>>>(in, out, len, parts);
  return cudaGetLastError();
}

// ---- the radix sort by code within each subquantizer ----

// Block b = j * Tj + t: the digit counts of tile t of subquantizer j's keys,
// written at hist[(j * 256 + digit) * Tj + t].
__global__ void __launch_bounds__(kThreads)
sort_hist_kernel(const int* __restrict__ keys, long long n, int shift, int Tj,
                 int* __restrict__ hist) {
  __shared__ int h[256];
  const int j = blockIdx.x / Tj, t = blockIdx.x - j * Tj;
  const int lane = threadIdx.x & 31;
  const int* seg = keys + (long long)j * n + (long long)t * kSortTile;
  const int len = (int)min((long long)kSortTile, n - (long long)t * kSortTile);
  h[threadIdx.x] = 0;
  __syncthreads();
  for (int i = threadIdx.x; i < kSortTile; i += kThreads) {
    const int digit = i < len ? (seg[i] >> shift) & 255 : 256;
    const unsigned int peers = __match_any_sync(0xffffffffu, digit);
    // integers, one add a digit group of a warp: the count is the same in any order
    if (digit < 256 && lane == __ffs(peers) - 1) atomicAdd(&h[digit], __popc(peers));
  }
  __syncthreads();
  hist[((long long)j * 256 + threadIdx.x) * Tj + t] = h[threadIdx.x];
}

// Block b = j * Tj + t places tile t of subquantizer j: ranks its keys in
// shared memory (stable: warps in order, each its keys in order), then writes
// each digit's run from offs[(j * 256 + digit) * Tj + t], the scanned
// histogram.  FIRST: the keys are the codes and the row of key i is its index;
// else the rows come from rows_in.  KEYS_OUT: the keys are written too.
template <bool FIRST, bool KEYS_OUT>
__global__ void __launch_bounds__(kThreads)
sort_scatter_kernel(const int* __restrict__ keys_in, const int* __restrict__ rows_in, long long n,
                    int shift, int Tj, const int* __restrict__ offs, int* __restrict__ keys_out,
                    int* __restrict__ rows_out) {
  extern __shared__ __align__(16) unsigned char smem[];
  int* s_keys = reinterpret_cast<int*>(smem);  // [kSortTile] in tile order
  int* s_rows = s_keys + kSortTile;            // [kSortTile] in sorted order
  int* s_out = s_rows + kSortTile;             // [kSortTile] keys (KEYS_OUT) or digits, sorted
  int* wpos = s_out + kSortTile;               // [kWarps][256]
  int* lstart = wpos + kWarps * 256;           // [256] each digit's start in the tile
  int* gbase = lstart + 256;                   // [256] and in the output
  int* warp_sum = gbase + 256;                 // [kWarps]
  const int j = blockIdx.x / Tj, t = blockIdx.x - j * Tj;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const long long at = (long long)j * n + (long long)t * kSortTile;
  const int len = (int)min((long long)kSortTile, n - (long long)t * kSortTile);
  for (int i = threadIdx.x; i < len; i += kThreads) s_keys[i] = keys_in[at + i];
#pragma unroll
  for (int w = 0; w < kWarps; ++w) wpos[w * 256 + threadIdx.x] = 0;
  __syncthreads();
  const int w0 = warp * kWarpKeys;
  for (int r = 0; r < kWarpKeys; r += 32) {
    const int i = w0 + r + lane;
    const int digit = i < len ? (s_keys[i] >> shift) & 255 : 256;
    const unsigned int peers = __match_any_sync(0xffffffffu, digit);
    if (digit < 256 && lane == __ffs(peers) - 1) wpos[warp * 256 + digit] += __popc(peers);
    __syncwarp();
  }
  __syncthreads();
  {  // thread d: digit d's start in the tile, and each warp's start within it
    const int d = threadIdx.x;
    int count = 0;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const int c = wpos[w * 256 + d];
      wpos[w * 256 + d] = count;
      count += c;
    }
    int total;
    const int start = block_exclusive(count, warp_sum, total);
    lstart[d] = start;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) wpos[w * 256 + d] += start;
    gbase[d] = offs[((long long)j * 256 + d) * Tj + t];
  }
  __syncthreads();
  for (int r = 0; r < kWarpKeys; r += 32) {
    const int i = w0 + r + lane;
    const bool valid = i < len;
    const int key = valid ? s_keys[i] : 0;
    const int digit = valid ? (key >> shift) & 255 : 256;
    const unsigned int peers = __match_any_sync(0xffffffffu, digit);
    const int rank = __popc(peers & ((1u << lane) - 1u));
    const int pos = valid ? wpos[warp * 256 + digit] + rank : 0;
    __syncwarp();
    if (valid) {
      if (rank == 0) wpos[warp * 256 + digit] += __popc(peers);
      s_rows[pos] = FIRST ? t * kSortTile + i : rows_in[at + i];
      s_out[pos] = KEYS_OUT ? key : digit;
    }
    __syncwarp();
  }
  __syncthreads();
  for (int i = threadIdx.x; i < len; i += kThreads) {
    const int v = s_out[i];
    const int digit = KEYS_OUT ? (v >> shift) & 255 : v;
    const long long to = gbase[digit] + (i - lstart[digit]);
    rows_out[to] = s_rows[i];
    if constexpr (KEYS_OUT) keys_out[to] = v;
  }
}

template <bool FIRST, bool KEYS_OUT>
cudaError_t place(const int* keys_in, const int* rows_in, long long n, int m, int shift, int Tj,
                  const int* offs, int* keys_out, int* rows_out, cudaStream_t s) {
  cudaError_t err = cudaFuncSetAttribute(sort_scatter_kernel<FIRST, KEYS_OUT>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, kScatterBytes);
  if (err != cudaSuccess) return err;
  sort_scatter_kernel<FIRST, KEYS_OUT><<<(unsigned)((long long)m * Tj), kThreads, kScatterBytes, s>>>(
      keys_in, rows_in, n, shift, Tj, offs, keys_out, rows_out);
  return cudaGetLastError();
}

// ---- cells and chunks ----

// First position p in [0, len) with keys[p] >= v (len if none).
__device__ __forceinline__ long long lower_bound(const int* keys, long long len, int v) {
  long long lo = 0, hi = len;
  while (lo < hi) {
    const long long mid = (lo + hi) >> 1;
    if (keys[mid] < v) lo = mid + 1;
    else hi = mid;
  }
  return lo;
}

// Thread per cell (j, c), and one for the end: the cell's first sorted
// position, its count (as f32) and its number of chunks (0 at index C).
// keys == nullptr: one pass, the starts read off the scanned histogram; else
// the sorted keys of the last pass.
__global__ void __launch_bounds__(kThreads)
cell_bounds_kernel(const int* __restrict__ offs, const int* __restrict__ keys, long long n, int k,
                   int Tj, long long C, int R, int* __restrict__ cell_start,
                   int* __restrict__ nchunks, float* __restrict__ counts) {
  const long long cell = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (cell > C) return;
  if (cell == C) {
    cell_start[C] = (int)(C / k * n);
    nchunks[C] = 0;
    return;
  }
  const long long j = cell / k;
  const int c = (int)(cell - j * k);
  long long start, end;
  if (keys == nullptr) {
    start = offs[(j * 256 + c) * Tj];
    end = c + 1 < 256 ? offs[(j * 256 + c + 1) * Tj] : (j + 1) * n;
  } else {
    start = j * n + lower_bound(keys + j * n, n, c);
    end = j * n + lower_bound(keys + j * n, n, c + 1);
  }
  const long long count = end - start;
  cell_start[cell] = (int)start;
  nchunks[cell] = (int)((count + R - 1) / R);
  counts[cell] = (float)count;
}

template <int V>
__device__ __forceinline__ void load_vec(const float* p, float (&v)[V]) {
  if constexpr (V == 4) {
    const float4 t = __ldg(reinterpret_cast<const float4*>(p));
    v[0] = t.x, v[1] = t.y, v[2] = t.z, v[3] = t.w;
  } else if constexpr (V == 2) {
    const float2 t = __ldg(reinterpret_cast<const float2*>(p));
    v[0] = t.x, v[1] = t.y;
  } else {
    v[0] = __ldg(p);
  }
}

template <int V>
__device__ __forceinline__ void store_vec(float* p, const float (&v)[V]) {
  if constexpr (V == 4) *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  else if constexpr (V == 2) *reinterpret_cast<float2*>(p) = make_float2(v[0], v[1]);
  else *p = v[0];
}

// Warp q: chunk q, columns (vectors of V floats) blockIdx.y * 32 L + lane +
// 32 i, i < L.  Its rows are added in row order from +0, U rows' loads started
// before their adds.  A cell of one chunk writes its sums; else the chunk's
// partial goes to partial[q].
template <int V, int L, bool BF16>
__global__ void __launch_bounds__(kThreads)
chunk_sums_kernel(const float* __restrict__ x, const int* __restrict__ rows,
                  const int* __restrict__ cell_start, const int* __restrict__ chunk_start,
                  float* __restrict__ partial, float* __restrict__ sums, long long C, int k, int ds,
                  long long d, int R) {
  constexpr int U = L == 1 ? 8 : (L == 2 ? 4 : (L == 3 ? 3 : 2));
  const int lane = threadIdx.x & 31;
  const long long q = (long long)blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (q >= chunk_start[C]) return;
  long long lo = 0, hi = C;  // chunk_start[lo] <= q < chunk_start[hi]
  while (hi - lo > 1) {
    const long long mid = (lo + hi) >> 1;
    if (chunk_start[mid] <= q) lo = mid;
    else hi = mid;
  }
  const long long cell = lo;
  const int first = chunk_start[cell];
  const bool alone = chunk_start[cell + 1] - first == 1;
  const int p0 = cell_start[cell] + ((int)q - first) * R;
  const int p1 = min(p0 + R, cell_start[cell + 1]);
  const int W = ds / V;
  const int v0 = blockIdx.y * 32 * L + lane;
  const float* xj = x + (cell / k) * ds;
  float acc[L][V];
#pragma unroll
  for (int i = 0; i < L; ++i)
#pragma unroll
    for (int e = 0; e < V; ++e) acc[i][e] = 0.0f;
  int idx = p0 + lane < p1 ? rows[p0 + lane] : 0;
  for (int base = p0; base < p1; base += 32) {
    const int cnt = min(32, p1 - base);
    const int ahead = base + 32 + lane < p1 ? rows[base + 32 + lane] : 0;  // the next 32 rows
    for (int u0 = 0; u0 < cnt; u0 += U) {
      float v[U][L][V];
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const int r = __shfl_sync(0xffffffffu, idx, (u0 + u) & 31);
        const float* xr = xj + (long long)r * d;
#pragma unroll
        for (int i = 0; i < L; ++i) {
          if (u0 + u < cnt && v0 + 32 * i < W) {
            load_vec<V>(xr + (v0 + 32 * i) * V, v[u][i]);
          } else {
#pragma unroll
            for (int e = 0; e < V; ++e) v[u][i][e] = 0.0f;
          }
        }
      }
#pragma unroll
      for (int u = 0; u < U; ++u) {
        if (u0 + u < cnt) {
#pragma unroll
          for (int i = 0; i < L; ++i)
#pragma unroll
            for (int e = 0; e < V; ++e) {
              float t = v[u][i][e];
              if constexpr (BF16) t = __bfloat162float(__float2bfloat16_rn(t));
              acc[i][e] += t;
            }
        }
      }
    }
    idx = ahead;
  }
  float* out = alone ? sums + cell * ds : partial + q * ds;
#pragma unroll
  for (int i = 0; i < L; ++i)
    if (v0 + 32 * i < W) store_vec<V>(out + (v0 + 32 * i) * V, acc[i]);
}

// Thread per (cell, column) of a cell of no chunk or of several: the chunks'
// partials added in chunk order from +0.
__global__ void __launch_bounds__(kThreads)
cell_sums_kernel(const float* __restrict__ partial, const int* __restrict__ chunk_start,
                 float* __restrict__ sums, long long total, int ds) {
  constexpr int kAhead = 16;
  const long long g = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (g >= total) return;
  const long long cell = g / ds;
  const int col = (int)(g - cell * ds);
  const int q0 = chunk_start[cell], q1 = chunk_start[cell + 1];
  if (q1 - q0 == 1) return;  // the chunk kernel wrote it
  float acc = 0.0f;
  for (int q = q0; q < q1; q += kAhead) {
    float v[kAhead];
#pragma unroll
    for (int i = 0; i < kAhead; ++i) v[i] = q + i < q1 ? partial[(long long)(q + i) * ds + col] : 0.0f;
#pragma unroll
    for (int i = 0; i < kAhead; ++i)
      if (q + i < q1) acc += v[i];
  }
  sums[g] = acc;
}

template <int V, int L>
cudaError_t launch_chunks(bool bf16, dim3 grid, const float* x, const int* rows,
                          const int* cell_start, const int* chunk_start, float* partial,
                          float* sums, long long C, int k, int ds, long long d, int R,
                          cudaStream_t s) {
  if (bf16)
    chunk_sums_kernel<V, L, true><<<grid, kThreads, 0, s>>>(x, rows, cell_start, chunk_start,
                                                            partial, sums, C, k, ds, d, R);
  else
    chunk_sums_kernel<V, L, false><<<grid, kThreads, 0, s>>>(x, rows, cell_start, chunk_start,
                                                             partial, sums, C, k, ds, d, R);
  return cudaGetLastError();
}

template <int V>
cudaError_t launch_chunks_v(int L, bool bf16, dim3 grid, const float* x, const int* rows,
                            const int* cell_start, const int* chunk_start, float* partial,
                            float* sums, long long C, int k, int ds, long long d, int R,
                            cudaStream_t s) {
  switch (L) {
    case 1: return launch_chunks<V, 1>(bf16, grid, x, rows, cell_start, chunk_start, partial, sums, C, k, ds, d, R, s);
    case 2: return launch_chunks<V, 2>(bf16, grid, x, rows, cell_start, chunk_start, partial, sums, C, k, ds, d, R, s);
    case 3: return launch_chunks<V, 3>(bf16, grid, x, rows, cell_start, chunk_start, partial, sums, C, k, ds, d, R, s);
    default: return launch_chunks<V, 4>(bf16, grid, x, rows, cell_start, chunk_start, partial, sums, C, k, ds, d, R, s);
  }
}

// The statistics of codes (m, n) int32, each in [0, k), over x (n, m*ds) f32
// on 4 bytes: sums (m, k, ds) and counts (m, k) f32, on 16 bytes.  -1 for a
// shape it does not take.
int cell_stats(const int* codes, const float* x, int* scratch, float* sums, float* counts,
               long long n, int m, int k, int ds, bool bf16, cudaStream_t s) {
  if (n <= 0 || m <= 0 || k <= 0 || k > 65536 || ds <= 0) return -1;
  const Layout l = layout(n, m, k, ds);
  if (l.N > 0x7fffffffLL || l.C > 0x7fffffffLL || l.Q > 0x7fffffffLL || l.H > 0x7fffffffLL) return -1;
  float* partial = reinterpret_cast<float*>(scratch);
  int* rows[2] = {scratch + l.Q * ds, nullptr};
  int* keys[2] = {nullptr, nullptr};
  int* p = rows[0] + l.N;
  if (l.passes == 2) {
    rows[1] = p;
    keys[0] = p + l.N;
    keys[1] = p + 2 * l.N;
    p += 3 * l.N;
  }
  int* hist = p;
  int* offs = hist + l.H;
  int* parts = offs + l.H;
  int* cell_start = parts + l.nb;
  int* chunk_start = cell_start + l.C + 1;
  const int Tj = (int)l.Tj;
  cudaError_t err;

  for (int pass = 0; pass < l.passes; ++pass) {
    const int* kin = pass == 0 ? codes : keys[0];
    sort_hist_kernel<<<(unsigned)((long long)m * Tj), kThreads, 0, s>>>(kin, n, 8 * pass, Tj, hist);
    if ((err = scan(hist, offs, l.H, parts, s)) != cudaSuccess) return (int)err;
    if (l.passes == 1)
      err = place<true, false>(codes, nullptr, n, m, 0, Tj, offs, nullptr, rows[0], s);
    else if (pass == 0)
      err = place<true, true>(codes, nullptr, n, m, 0, Tj, offs, keys[0], rows[0], s);
    else
      err = place<false, true>(keys[0], rows[0], n, m, 8, Tj, offs, keys[1], rows[1], s);
    if (err != cudaSuccess) return (int)err;
  }
  const int* sorted = rows[l.passes - 1];
  cell_bounds_kernel<<<(unsigned)((l.C + kThreads) / kThreads), kThreads, 0, s>>>(
      offs, l.passes == 2 ? keys[1] : nullptr, n, k, Tj, l.C, l.R, cell_start, chunk_start, counts);
  if ((err = scan(chunk_start, chunk_start, l.C + 1, parts, s)) != cudaSuccess) return (int)err;

  const uintptr_t a = reinterpret_cast<uintptr_t>(x);
  const int V = ds % 4 == 0 && a % 16 == 0 ? 4 : (ds % 2 == 0 && a % 8 == 0 ? 2 : 1);
  const int W = ds / V;
  const int L = W > 96 ? 4 : (W + 31) / 32;
  const dim3 grid((unsigned)((l.Q + kWarps - 1) / kWarps), (unsigned)((W + 32 * L - 1) / (32 * L)));
  const long long d = (long long)m * ds;
  switch (V) {
    case 4: err = launch_chunks_v<4>(L, bf16, grid, x, sorted, cell_start, chunk_start, partial, sums, l.C, k, ds, d, l.R, s); break;
    case 2: err = launch_chunks_v<2>(L, bf16, grid, x, sorted, cell_start, chunk_start, partial, sums, l.C, k, ds, d, l.R, s); break;
    default: err = launch_chunks_v<1>(L, bf16, grid, x, sorted, cell_start, chunk_start, partial, sums, l.C, k, ds, d, l.R, s);
  }
  if (err != cudaSuccess) return (int)err;
  const long long total = l.C * ds;
  cell_sums_kernel<<<(unsigned)((total + kThreads - 1) / kThreads), kThreads, 0, s>>>(
      partial, chunk_start, sums, total, ds);
  return (int)cudaGetLastError();
}

}  // namespace cells

int assign_stats_wide(const float* x, const void* cb2, const float* csqn, int* codes,
                      const float* escale, float rho, int* flags, int* scratch, float* sums,
                      float* counts, long long n, int m, int k, int ds, int mode, bool deep,
                      cudaStream_t s) {
  if (n <= 0 || m <= 0 || k <= 0 || ds <= 0) return -1;
  if (n * m > 0x7fffffffLL || (long long)m * k > 0x7fffffffLL) return -1;
  const cudaError_t err = assign_wide::launch(x, cb2, csqn, {codes, 1, n, 0}, mode == 1, mode == 2,
                                              escale, rho, flags, n, m, k, ds, deep, s);
  if (err != cudaSuccess) return (int)err;
  return cells::cell_stats(codes, x, scratch, sums, counts, n, m, k, ds, mode == 1, s);
}

}  // namespace

// x (n, m*ds) f32, ds <= 32, cb2 (m, k, ds) f32 holding 2c, csqn (m, k) f32,
// partial (P, m, k, DSP + 1) f32 scratch (need not be initialised; DSP =
// ops/assign.py padded_ds(ds)), sums (m, k, ds) f32, counts (m, k) f32; the
// f32 mode.
// Returns cudaGetLastError() after the launches; -1 for a shape it does not take.
extern "C" int rt_assign_stats(const void* x, const void* cb2, const void* csqn, void* partial,
                               void* sums, void* counts, long long n, int m, int k, int ds, int P,
                               void* stream) {
  return assign_stats(x, cb2, csqn, partial, sums, counts, nullptr, 0.0f, nullptr, nullptr, n, m,
                      k, ds, false, P, stream);
}

// The bf16 mode: arguments as rt_assign_stats's (cb2 already rounded to bf16
// values), and the launch plan of ops/assign.py bf16_tile_plan (rows a tile,
// P, dynamic shared memory in bytes).  -1 for a shape or a plan it does not
// take.
extern "C" int rt_assign_stats_bf16(const void* x, const void* cb2, const void* csqn,
                                    void* partial, void* sums, void* counts, long long n, int m,
                                    int k, int ds, int rows, int P, int bytes, void* stream) {
  if (n <= 0 || m <= 0 || k <= 0) return -1;
  cudaStream_t s = (cudaStream_t)stream;
  const float* xf = (const float*)x;
  const float* cf = (const float*)cb2;
  const float* nf = (const float*)csqn;
  float* pf = (float*)partial;
  float* sf = (float*)sums;
  float* tf = (float*)counts;
  if (ds <= 0 || ds > 32) return -1;
  switch (assign_tile::padded_width(ds)) {
    case 4: return launch_bf16<4>(xf, cf, nf, pf, sf, tf, n, m, k, ds, rows, P, bytes, s);
    case 8: return launch_bf16<8>(xf, cf, nf, pf, sf, tf, n, m, k, ds, rows, P, bytes, s);
    case 16: return launch_bf16<16>(xf, cf, nf, pf, sf, tf, n, m, k, ds, rows, P, bytes, s);
    default: return launch_bf16<32>(xf, cf, nf, pf, sf, tf, n, m, k, ds, rows, P, bytes, s);
  }
}

// As rt_assign_stats, with the verification outputs: escale (m,)
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
                      true, P, stream);
}

// Scratch of rt_assign_stats_wide, in int32 words: rt_cell_stats's.
extern "C" long long rt_assign_stats_wide_scratch(long long n, int m, int k, int ds) {
  return cells::scratch_words(n, m, k, ds);
}

// The statistics on the wide route (any ds >= 1; the wrappers take it above
// ds = 32): the wide assignment into codes (m, n) int32, then the statistics
// from the codes (cells::cell_stats, see "the wide route" above).  mode: 0
// f32, 1 bf16, 2 verified (escale (m,) f32, rho, and flags (n,) int32 zeroed
// by the caller).  scratch: the int32 words rt_assign_stats_wide_scratch
// names; sums (m, k, ds), counts (m, k) f32.  route: kRouteDeep (cb2 and csqn
// as ops/assign.py deep_operands writes them), or kRouteShallow, which only a
// caller that forces it takes (the yardstick of the tests and tools).  Returns
// cudaGetLastError() after the launches; -1 for a shape it does not take.
extern "C" int rt_assign_stats_wide(const void* x, const void* cb2, const void* csqn, void* codes,
                                    const void* escale, float rho, void* flags, void* scratch,
                                    void* sums, void* counts, long long n, int m, int k, int ds,
                                    int mode, int route, void* stream) {
  if (mode == 2 && (escale == nullptr || flags == nullptr)) return -1;
  if (route != assign_tile::kRouteDeep && route != assign_tile::kRouteShallow) return -1;
  return assign_stats_wide((const float*)x, cb2, (const float*)csqn, (int*)codes,
                           (const float*)escale, rho, (int*)flags, (int*)scratch, (float*)sums,
                           (float*)counts, n, m, k, ds, mode, route == assign_tile::kRouteDeep,
                           (cudaStream_t)stream);
}

// Scratch of rt_cell_stats, in int32 words.
extern "C" long long rt_cell_stats_scratch(long long n, int m, int k, int ds) {
  return cells::scratch_words(n, m, k, ds);
}

// The wide route's statistics from given codes: codes (m, n) int32, each in
// [0, k), k <= 65536; x (n, m*ds) f32 (any address on 4 bytes); scratch the
// int32 words rt_cell_stats_scratch names; sums (m, k, ds) and counts (m, k)
// f32, on 16 bytes.  bf16: the sums are of the bf16-rounded x.  Returns
// cudaGetLastError() after the launches; -1 for a shape it does not take.
extern "C" int rt_cell_stats(const void* codes, const void* x, void* scratch, void* sums,
                             void* counts, long long n, int m, int k, int ds, int bf16,
                             void* stream) {
  return cells::cell_stats((const int*)codes, (const float*)x, (int*)scratch, (float*)sums,
                           (float*)counts, n, m, k, ds, bf16 != 0, (cudaStream_t)stream);
}
