// ADC scoring: score[q, i] = sum_j T[q, j, codes[i, j]], written (nq, n).
//
// Replaces the TPU kernels reductive_tpu/ops/adc.py::_adc_kernel (f32 tables:
// the wrapper has already summed the bf16 parts into one table) and
// reductive_tpu/ops/decode.py::_decode_kernel_int8 in its ADC use (int8
// tables, int32 sum, then score = float(sum) * scale[q] + offset[q]).  The TPU
// kernels restate the lookups as one multihot matrix product; here they are
// lookups in shared memory.  The sum over j is taken once, in the order
// j = 0..m-1.
//
// What bounds it on an H100: bytes, by the count the roofline uses (n*m bytes
// of codes read, 4*nq*n bytes of scores written, nq*n*m additions); what the
// kernel really waits for is shared memory, which serves nq*n*m table entries
// at addresses the codes choose.  A warp's shared-memory load is served 128
// bytes (32 banks) a cycle; lanes that read other words of one bank in the
// same phase are served one after the other.  Lookups free of such conflicts
// cost nq*n*m*4 bytes / (128 bytes a cycle an SM): 0.13 ms at the flagship
// shape (16 queries, 4,000,000 rows, m=16).
//
// f32 tables (adc_f32_kernel; ops/adc.py::adc_plan chooses its plan):
// * Lanes over queries.  A block holds the tables of QT queries and a row's
//   QT entries of one code are read by L = QT/V lanes, V = min(QT, 4)
//   consecutive floats each (one 16-byte load at QT >= 4): the code is the
//   same for those lanes, the entries of one row are consecutive words, and a
//   load serves 32/L rows.  Each lane keeps its own V sums a row, added in the
//   order j = 0..m-1.
// * No bank conflicts.  In one phase of a load (8 lanes for 16-byte loads, 16
//   for 8, 32 for 4) S = 32/QT rows read QT*4 bytes each: a 128-byte line
//   holds S slices of QT words, and two rows of a phase in one slice at two
//   addresses conflict.  Where 32 copies of the tables' floats fit (128*m*k
//   bytes: every k <= 16 shape, so every packed one), each entry is stored
//   R = S times, laid out [j][c][copy][q], and the s-th row of a phase reads
//   copy s.  Where they do not (the flagship k=256: 512 KB), each entry is
//   stored once, laid out [c][j][q], and the skewed walk (walk_skewed, at
//   QT = 8 or 16, m % 4 == 0) lags the s-th row of a phase by s codes, so the
//   rows of a phase read entries of distinct j mod S, in distinct slices.
//   Elsewhere (QT < 8 or m % 4 != 0) the rows of a phase land on random
//   slices: about 2.1 wavefronts a phase at QT=8, where a thread-a-row walk
//   takes about 3 (two 16-byte loads a thread, 8 threads a phase on 4
//   slices).
// * A persistent grid: P blocks per query tile (one wave of resident blocks,
//   1,024 threads at one block an SM, 512 at two), each over one contiguous
//   range of rows, so the tables are filled once a block.  The fill reads each
//   query's table along (j, c) (coalesced) and writes V-float chunks at
//   consecutive addresses (no conflicts in the [j][c] layouts), with the
//   chunk's entry, copy and query found by shifts.
// * Codes are loaded by each lane from global memory, a row's bytes 16, 8 or
//   4 at a time where the row is a whole number of aligned words (byte by
//   byte elsewhere): the lanes of one row load the same words, neighbouring
//   rows neighbouring words; the skewed walk loads each stream's next word
//   before it looks up the current one.  Scores are stored along n for each
//   query: a store instruction writes 32/L consecutive rows of L*V queries.
//
// Packed u4 codes (the packed=True variant of the same TPU kernels): a row is
// m/2 bytes and a lane takes both nibbles of each byte, low then high, so the
// sum keeps the order j = 0..m-1 and is bit-equal to the unpacked kernel's.
// The tables stay in natural order.  With k <= 16 the tables are small and
// always replicated; the code bytes read fall to n*m/2.
//
// int8 tables (adc_kernel<int8_t, int32_t>): a block holds the tables of QT
// queries laid out [j][c][q]; a thread takes one database row at a time,
// reads its codes four at a time where it can, keeps QT int32 sums in
// registers and writes them coalesced along n; the grid's y axis tiles the
// queries; blocks walk the rows with a stride.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

// ---------------------------------------------------------------------------
// f32 tables.

constexpr int kF32MaxThreads = 1024;  // 1,024 a block at one block an SM, else 512
constexpr int kRowsPerLane = 2;  // rows a lane takes at a time, for independent loads
constexpr int kRowAlign = 64;    // a block's rows start on a multiple of 64

template <int V> struct VecOf;
template <> struct VecOf<4> { using T = float4; };
template <> struct VecOf<2> { using T = float2; };
template <> struct VecOf<1> { using T = float; };

template <int V>
__device__ __forceinline__ float vget(const typename VecOf<V>::T& v, int t) {
  if constexpr (V == 4) return t == 0 ? v.x : t == 1 ? v.y : t == 2 ? v.z : v.w;
  else if constexpr (V == 2) return t == 0 ? v.x : v.y;
  else return v;
}

template <int V>
__device__ __forceinline__ void vset(typename VecOf<V>::T& v, int t, float x) {
  if constexpr (V == 4) {
    if (t == 0) v.x = x; else if (t == 1) v.y = x; else if (t == 2) v.z = x; else v.w = x;
  } else if constexpr (V == 2) {
    if (t == 0) v.x = x; else v.y = x;
  } else {
    v = x;
  }
}

// NB bytes of codes at p as 32-bit words (NB = 16, 8, 4 or 1).
template <int NB>
__device__ __forceinline__ void load_code_words(const unsigned char* p, uint32_t (&w)[(NB + 3) / 4]) {
  if constexpr (NB == 16) {
    const uint4 v = *reinterpret_cast<const uint4*>(p);
    w[0] = v.x; w[1] = v.y; w[2] = v.z; w[3] = v.w;
  } else if constexpr (NB == 8) {
    const uint2 v = *reinterpret_cast<const uint2*>(p);
    w[0] = v.x; w[1] = v.y;
  } else if constexpr (NB == 4) {
    w[0] = *reinterpret_cast<const uint32_t*>(p);
  } else {
    w[0] = *p;
  }
}

// The skewed walk, for QT = 8 or 16 queries a block with each entry stored
// once (R = 1) and uint8 codes whose rows are whole aligned NB-byte words
// (m % 4 == 0).  The tables are laid out [c][j][q], so entry (j, c) sits in
// the (j mod S)-th QT-word slice of its 128-byte line, S = 32 / QT being the
// rows of a phase (m % S == 0).  The lane of the s-th row of its phase lags
// its rows' codes by s: at step t it adds code t - s of its row, the codes of
// a phase's rows at one step are at distinct j mod S, so in distinct slices:
// no conflicts, whatever the codes.  Each lane walks kSkewStreams streams of
// rows (stream u: rows base + u*RW + r, base += warps * RW * kSkewStreams),
// each one stream of code bytes, and takes each 32-bit word of it
// funnel-shifted by s bytes: in the first word of a row, the bytes below s are
// the previous row's last codes and are added to its sums, which are then
// complete; every lane stores them there, at the same point, so the stores
// stay coalesced along n.  Each row's sum is still added in the order
// j = 0..m-1.  The next NB bytes of each stream are loaded before the current
// ones are looked up, so that two loads of a stream are in flight.  ALL: k is
// 256, every uint8 code selects an entry and none is tested.
constexpr int kSkewStreams = 2;

template <int QT, int NB, bool ALL>
__device__ __forceinline__ void walk_skewed(const float* s_tab, const uint8_t* __restrict__ codes,
                                            float* __restrict__ out, long long start,
                                            long long end, long long n, int nq, int m, int k,
                                            int q0) {
  constexpr int V = 4, L = QT / 4, RW = 32 / L, S = 32 / QT, NW = NB / 4, U = kSkewStreams;
  static_assert(QT == 8 || QT == 16, "a lag of at most three codes");
  const int lane = threadIdx.x & 31;
  const int r = lane / L;
  const int h = lane % L;
  const int lag = r % S;
  const unsigned shift = 8u * (4 - lag);  // funnel shift that lags the code stream by `lag` bytes
  const float* s_lane = s_tab + h * V - lag * QT;
  const int c_stride = m * QT;            // floats from (j, c) to (j, c + 1)
  const int qa = q0 + h * V;
  const unsigned ku = (unsigned)k;
  const long long step = (long long)(blockDim.x >> 5) * RW * U;
  float cur[U][V], prev[U][V];
  uint32_t last[U];        // the word of each stream before the one being read
  long long prev_row[U];   // the row whose sums are in prev; -1: none to store
  uint32_t nxt[U][NW];     // the next NB bytes of each stream
#pragma unroll
  for (int u = 0; u < U; ++u) {
    last[u] = 0;
    prev_row[u] = -1;
#pragma unroll
    for (int t = 0; t < V; ++t) prev[u][t] = 0.0f;
  }

  auto load = [&](int u, long long row, int e0) {
    if (row < end) {
      load_code_words<NB>(codes + row * m + e0, nxt[u]);
    } else {
#pragma unroll
      for (int i = 0; i < NW; ++i) nxt[u][i] = 0;
    }
  };
  auto store_prev = [&](int u) {
    if (prev_row[u] >= 0) {
#pragma unroll
      for (int t = 0; t < V; ++t)
        if (qa + t < nq) out[(long long)(qa + t) * n + prev_row[u]] = prev[u][t];
    }
  };
  // The four codes of one lagged word of stream u: code b is byte b.  first:
  // the row's first word, whose codes below the lag are the previous row's
  // last ones.
  auto add_word = [&](int u, uint32_t word, int j0, bool first) {
#pragma unroll
    for (int b = 0; b < 4; ++b) {
      const uint32_t c = (word >> (8 * b)) & 0xffu;
      if (ALL || c < ku) {
        if (first && b < lag) {
          const float4 t = *reinterpret_cast<const float4*>(s_lane + (int)c * c_stride + (m + b) * QT);
          prev[u][0] += t.x; prev[u][1] += t.y; prev[u][2] += t.z; prev[u][3] += t.w;
        } else {
          const float4 t = *reinterpret_cast<const float4*>(s_lane + (int)c * c_stride + (j0 + b) * QT);
          cur[u][0] += t.x; cur[u][1] += t.y; cur[u][2] += t.z; cur[u][3] += t.w;
        }
      }
    }
  };

  long long base = start + (long long)(threadIdx.x >> 5) * RW * U;
#pragma unroll
  for (int u = 0; u < U; ++u) load(u, base + u * RW + r, 0);
  for (; base < end; base += step) {
#pragma unroll
    for (int u = 0; u < U; ++u)
#pragma unroll
      for (int t = 0; t < V; ++t) cur[u][t] = 0.0f;
    for (int e0 = 0; e0 < m; e0 += NB) {
      uint32_t w[U][NW];
      const bool more = e0 + NB < m;  // else the next bytes are the next row's first
#pragma unroll
      for (int u = 0; u < U; ++u) {
#pragma unroll
        for (int i = 0; i < NW; ++i) w[u][i] = nxt[u][i];
        const long long row = base + u * RW + r;
        load(u, more ? row : row + step, more ? e0 + NB : 0);
      }
#pragma unroll
      for (int i = 0; i < NW; ++i) {
        const bool first = e0 == 0 && i == 0;
#pragma unroll
        for (int u = 0; u < U; ++u) {
          const uint32_t word = __funnelshift_rc(last[u], w[u][i], shift);
          last[u] = w[u][i];
          add_word(u, word, e0 + 4 * i, first);
        }
        if (first) {
#pragma unroll
          for (int u = 0; u < U; ++u) store_prev(u);
        }
      }
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const long long row = base + u * RW + r;
#pragma unroll
      for (int t = 0; t < V; ++t) prev[u][t] = cur[u][t];
      prev_row[u] = row < end ? row : -1;
    }
  }
  // The last rows' codes past the lag.
#pragma unroll
  for (int u = 0; u < U; ++u) {
    add_word(u, __funnelshift_rc(last[u], 0u, shift), 0, true);
    store_prev(u);
  }
}

// The plain walk: at each step of kRowsPerLane * RW rows a warp, lane takes
// rows base + u*RW + lane/L and queries (lane % L) * V onward from copy
// (lane/L) % R, and adds, for j = 0..m-1, the V floats of entry (j, c) there.
// ALL: every code of its type is below k (uint8 at k = 256, packed at k =
// 16), and none is tested.
template <int QT, int R, typename CodeT, bool PACKED, int NB, bool ALL>
__device__ __forceinline__ void walk_plain(const float* s_tab, const CodeT* __restrict__ codes,
                                           float* __restrict__ out, long long start,
                                           long long end, long long n, int nq, int m, int k,
                                           int q0) {
  constexpr int V = QT < 4 ? QT : 4;
  constexpr int L = QT / V;
  constexpr int RW = 32 / L;
  constexpr int EPL = NB / (int)sizeof(CodeT);
  constexpr int NW = (NB + 3) / 4;
  using Vec = typename VecOf<V>::T;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int r = lane / L;         // the lane's row among the RW of a load
  const int h = lane % L;         // the lane's V queries among the QT
  const int copy = R == 1 ? 0 : r % R;
  const float* s_lane = s_tab + copy * QT + h * V;
  const int qa = q0 + h * V;      // the lane's first query
  const int width = PACKED ? m / 2 : m;  // elements of CodeT a row
  const unsigned ku = (unsigned)k;

  constexpr int kStep = RW * kRowsPerLane;
  for (long long base = start + (long long)warp * kStep; base < end;
       base += (long long)(blockDim.x / 32) * kStep) {
    float acc[kRowsPerLane][V];
    bool live[kRowsPerLane];
    const unsigned char* cr[kRowsPerLane];
#pragma unroll
    for (int u = 0; u < kRowsPerLane; ++u) {
      const long long row = base + u * RW + r;
      live[u] = row < end;
      cr[u] = reinterpret_cast<const unsigned char*>(codes + (live[u] ? row : start) * width);
#pragma unroll
      for (int t = 0; t < V; ++t) acc[u][t] = 0.0f;
    }
    // Adds the V entries of code c of subquantizer j to row u's sums; a code
    // that is not below k selects nothing.
    auto add = [&](int u, int j, uint32_t c) {
      if (ALL || c < ku) {
        const Vec t = *reinterpret_cast<const Vec*>(s_lane + (j * k + (int)c) * (R * QT));
#pragma unroll
        for (int i = 0; i < V; ++i) acc[u][i] += vget<V>(t, i);
      }
    };
    for (int e0 = 0; e0 < width; e0 += EPL) {
      uint32_t w[kRowsPerLane][NW];
#pragma unroll
      for (int u = 0; u < kRowsPerLane; ++u) {
        if (live[u]) {
          load_code_words<NB>(cr[u] + (long long)e0 * sizeof(CodeT), w[u]);
        } else {
#pragma unroll
          for (int i = 0; i < NW; ++i) w[u][i] = 0;
        }
      }
#pragma unroll
      for (int b = 0; b < EPL; ++b) {
#pragma unroll
        for (int u = 0; u < kRowsPerLane; ++u) {
          uint32_t v;
          if constexpr (sizeof(CodeT) == 1) {
            v = (w[u][b / 4] >> (8 * (b % 4))) & 0xffu;
          } else {
            v = w[u][b];
          }
          if constexpr (PACKED) {
            add(u, 2 * (e0 + b), v & 0xFu);
            add(u, 2 * (e0 + b) + 1, v >> 4);
          } else {
            add(u, e0 + b, v);
          }
        }
      }
    }
#pragma unroll
    for (int u = 0; u < kRowsPerLane; ++u) {
      if (!live[u]) continue;
      const long long row = base + u * RW + r;
#pragma unroll
      for (int t = 0; t < V; ++t)
        if (qa + t < nq) out[(long long)(qa + t) * n + row] = acc[u][t];
    }
  }
}

// QT queries a block, R copies of each entry (1, or 32/QT: no conflicts),
// SKEW: the skewed walk (walk_skewed; R = 1), NB bytes of codes a load (16, 8
// or 4: whole aligned words; 1: bytes; int32 codes take 4, one code).  PACKED:
// CodeT is uint8_t and a row is m/2 bytes of two u4 codes, code 2b in the low
// nibble of byte b and code 2b+1 in the high one.
template <int QT, int R, bool SKEW, typename CodeT, bool PACKED, int NB>
__global__ void __launch_bounds__(kF32MaxThreads)
adc_f32_kernel(const float* __restrict__ tables, const CodeT* __restrict__ codes,
               float* __restrict__ out, long long n, int nq, int m, int k,
               long long rows_per_block) {
  constexpr int V = QT < 4 ? QT : 4;  // floats a lane loads at once
  constexpr int CPE = R * QT / V;     // V-float chunks an entry, over its copies
  using Vec = typename VecOf<V>::T;
  static_assert(R == 1 || R * QT == 32, "replicas: none, or one per row of a phase");
  static_assert(NB >= (int)sizeof(CodeT), "a load takes at least one code element");
  static_assert(!SKEW || (R == 1 && sizeof(CodeT) == 1 && !PACKED && NB >= 4), "skewed walk");

  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* s_tab = reinterpret_cast<float*>(smem_raw);  // [m*k][R][QT], skewed: [k][m][QT]

  // The fill: chunk e of the block's tables is entry e / CPE, copy
  // (e % CPE) / (QT / V), queries (e % (QT / V)) * V onward; CPE and QT / V
  // are powers of two, so these are shifts.  Neighbouring threads read
  // neighbouring entries of a query's table and write neighbouring chunks
  // (the skewed layout: one j at a time, neighbouring chunks of an entry
  // together, entries m*QT floats apart).
  const int q0 = blockIdx.y * QT;
  const int mk = m * k;
  const int threads = blockDim.x;
  if constexpr (SKEW) {
    for (int j = 0; j < m; ++j) {
      for (int e = threadIdx.x; e < k * CPE; e += threads) {
        const int c = e / CPE;
        const int qq = e % CPE;
        Vec v;
#pragma unroll
        for (int t = 0; t < V; ++t) {
          const int q = q0 + qq * V + t;
          vset<V>(v, t, q < nq ? tables[(long long)q * mk + j * k + c] : 0.0f);
        }
        reinterpret_cast<Vec*>(s_tab)[(c * m + j) * CPE + qq] = v;
      }
    }
  } else {
    for (int e = threadIdx.x; e < mk * CPE; e += threads) {
      const int entry = e / CPE;
      const int qq = (e % CPE) % (QT / V);
      Vec v;
#pragma unroll
      for (int t = 0; t < V; ++t) {
        const int q = q0 + qq * V + t;
        vset<V>(v, t, q < nq ? tables[(long long)q * mk + entry] : 0.0f);
      }
      reinterpret_cast<Vec*>(s_tab)[e] = v;
    }
  }
  __syncthreads();

  const long long start = (long long)blockIdx.x * rows_per_block;
  const long long end = start + rows_per_block < n ? start + rows_per_block : n;
  if constexpr (SKEW) {
    const uint8_t* c8 = reinterpret_cast<const uint8_t*>(codes);
    if (k >= 256)
      walk_skewed<QT, NB, true>(s_tab, c8, out, start, end, n, nq, m, k, q0);
    else
      walk_skewed<QT, NB, false>(s_tab, c8, out, start, end, n, nq, m, k, q0);
  } else {
    if constexpr (sizeof(CodeT) == 1) {
      if (k >= (PACKED ? 16 : 256)) {
        walk_plain<QT, R, CodeT, PACKED, NB, true>(s_tab, codes, out, start, end, n, nq, m, k, q0);
        return;
      }
    }
    walk_plain<QT, R, CodeT, PACKED, NB, false>(s_tab, codes, out, start, end, n, nq, m, k, q0);
  }
}

template <int QT, int R, bool SKEW, typename CodeT, bool PACKED, int NB>
cudaError_t launch_f32(const void* tables, const void* codes, void* out, long long n, int nq, int m,
                       int k, int blocks, long long rows_per_block, int threads, int smem,
                       cudaStream_t stream) {
  auto kern = adc_f32_kernel<QT, R, SKEW, CodeT, PACKED, NB>;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return e;
  }
  const dim3 grid((unsigned)blocks, (unsigned)((nq + QT - 1) / QT));
  kern<<<grid, threads, smem, stream>>>((const float*)tables, (const CodeT*)codes, (float*)out, n,
                                        nq, m, k, rows_per_block);
  return cudaGetLastError();
}

// The code loads a row takes: whole aligned 16-, 8- or 4-byte words where the
// row is made of them and the base is aligned, bytes elsewhere.  The skewed
// walk where the plan asks for it and the codes allow it (uint8, whole words).
template <int QT, int R>
cudaError_t launch_f32_codes(const void* tables, const void* codes, int code_bytes, int packed,
                             void* out, long long n, int nq, int m, int k, int blocks,
                             long long rows_per_block, int threads, int smem, bool skew,
                             cudaStream_t stream) {
#define RT_ADC_F32(SKEW, CodeT, PACKED, NB)                                                  \
  launch_f32<QT, R, SKEW, CodeT, PACKED, NB>(tables, codes, out, n, nq, m, k, blocks,         \
                                             rows_per_block, threads, smem, stream)
  if (code_bytes == 4) return RT_ADC_F32(false, int32_t, false, 4);
  const int width = packed ? m / 2 : m;
  const uintptr_t base = (uintptr_t)codes;
  int nb = 1;
  for (int b : {16, 8, 4})
    if (nb == 1 && width % b == 0 && base % b == 0) nb = b;
  if (packed) return nb == 16 ? RT_ADC_F32(false, uint8_t, true, 16)
                   : nb == 8 ? RT_ADC_F32(false, uint8_t, true, 8)
                   : nb == 4 ? RT_ADC_F32(false, uint8_t, true, 4)
                             : RT_ADC_F32(false, uint8_t, true, 1);
  if constexpr (R == 1 && (QT == 8 || QT == 16)) {
    if (skew && nb >= 4)
      return nb == 16 ? RT_ADC_F32(true, uint8_t, false, 16)
             : nb == 8 ? RT_ADC_F32(true, uint8_t, false, 8) : RT_ADC_F32(true, uint8_t, false, 4);
  }
  return nb == 16 ? RT_ADC_F32(false, uint8_t, false, 16)
         : nb == 8 ? RT_ADC_F32(false, uint8_t, false, 8)
         : nb == 4 ? RT_ADC_F32(false, uint8_t, false, 4) : RT_ADC_F32(false, uint8_t, false, 1);
#undef RT_ADC_F32
}

// ---------------------------------------------------------------------------
// int8 tables.

constexpr int kThreads = 1024;

// PACKED: CodeT is uint8_t and a row is m/2 bytes of two u4 codes each, code
// 2b in the low nibble of byte b and code 2b+1 in the high nibble.
template <typename TabT, typename AccT, int QT, typename CodeT, bool VEC4, bool PACKED>
__global__ void __launch_bounds__(kThreads)
adc_kernel(const TabT* __restrict__ tables, const CodeT* __restrict__ codes,
           float* __restrict__ out, const float* __restrict__ scale,
           const float* __restrict__ offset, long long n, int nq, int m, int k) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  TabT* s_t = reinterpret_cast<TabT*>(smem_raw);  // [m * k][QT]

  const int q0 = blockIdx.y * QT;
  const int mk = m * k;
  for (int e = threadIdx.x; e < QT * mk; e += kThreads) {
    const int q = e / mk;
    const int jc = e - q * mk;
    TabT v = (TabT)0;
    if (q0 + q < nq) v = tables[(long long)(q0 + q) * mk + jc];
    s_t[jc * QT + q] = v;
  }
  __syncthreads();

  const int width = PACKED ? m / 2 : m;  // elements of CodeT a row
  const long long stride = (long long)gridDim.x * kThreads;
  for (long long row = (long long)blockIdx.x * kThreads + threadIdx.x; row < n; row += stride) {
    AccT acc[QT];
#pragma unroll
    for (int q = 0; q < QT; ++q) acc[q] = (AccT)0;
    // Adds the QT entries of code c of subquantizer j; a code that is not
    // below k selects nothing.
    auto add = [&](int j, unsigned long long c) {
      if (c < (unsigned long long)k) {
        const TabT* p = s_t + (j * k + (int)c) * QT;
#pragma unroll
        for (int q = 0; q < QT; ++q) acc[q] += (AccT)p[q];
      }
    };
    // One element of the row: one code, or two packed ones, in the order j.
    auto element = [&](int e, unsigned long long v) {
      if constexpr (PACKED) {
        add(2 * e, v & 0xFu);
        add(2 * e + 1, v >> 4);
      } else {
        add(e, v);
      }
    };
    const CodeT* cr = codes + row * width;
    if constexpr (VEC4) {
      // CodeT is uint8_t, width % 4 == 0 and the base is 4-byte aligned.
      const uint32_t* cw = reinterpret_cast<const uint32_t*>(cr);
      for (int e4 = 0; e4 < width / 4; ++e4) {
        const uint32_t w = cw[e4];
#pragma unroll
        for (int b = 0; b < 4; ++b) element(e4 * 4 + b, (w >> (8 * b)) & 0xff);
      }
    } else {
      for (int e = 0; e < width; ++e) element(e, (unsigned long long)cr[e]);
    }
#pragma unroll
    for (int q = 0; q < QT; ++q) {
      if (q0 + q < nq) {
        float v = (float)acc[q];
        if (scale != nullptr) v = __fadd_rn(__fmul_rn(v, scale[q0 + q]), offset[q0 + q]);
        out[(long long)(q0 + q) * n + row] = v;
      }
    }
  }
}

template <typename TabT, typename AccT, int QT, typename CodeT, bool VEC4, bool PACKED>
cudaError_t launch_one(const void* tables, const void* codes, void* out, const void* scale,
                       const void* offset, long long n, int nq, int m, int k,
                       int row_blocks, cudaStream_t stream) {
  auto kern = adc_kernel<TabT, AccT, QT, CodeT, VEC4, PACKED>;
  const size_t smem = (size_t)QT * m * k * sizeof(TabT);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
  }
  dim3 grid((unsigned)row_blocks, (unsigned)((nq + QT - 1) / QT));
  kern<<<grid, kThreads, smem, stream>>>((const TabT*)tables, (const CodeT*)codes, (float*)out,
                                         (const float*)scale, (const float*)offset, n, nq, m, k);
  return cudaGetLastError();
}

template <typename TabT, typename AccT, int QT>
cudaError_t launch_codes(const void* tables, const void* codes, int code_bytes, int packed,
                         void* out, const void* scale, const void* offset, long long n, int nq,
                         int m, int k, int row_blocks, cudaStream_t stream) {
#define RT_ADC_LAUNCH(CodeT, VEC4, PACKED)                                                      \
  launch_one<TabT, AccT, QT, CodeT, VEC4, PACKED>(tables, codes, out, scale, offset, n, nq, m, \
                                                  k, row_blocks, stream)
  if (code_bytes == 1) {
    // Four bytes a load where a row is a whole number of aligned words.
    const int width = packed ? m / 2 : m;
    const bool vec4 = width % 4 == 0 && ((uintptr_t)codes & 3) == 0;
    if (packed) return vec4 ? RT_ADC_LAUNCH(uint8_t, true, true) : RT_ADC_LAUNCH(uint8_t, false, true);
    return vec4 ? RT_ADC_LAUNCH(uint8_t, true, false) : RT_ADC_LAUNCH(uint8_t, false, false);
  }
  return RT_ADC_LAUNCH(int32_t, false, false);
#undef RT_ADC_LAUNCH
}

template <typename TabT, typename AccT>
cudaError_t launch_qt(const void* tables, const void* codes, int code_bytes, int packed, void* out,
                      const void* scale, const void* offset, long long n, int nq, int m, int k,
                      int qt, int row_blocks, cudaStream_t stream) {
  switch (qt) {
    case 8: return launch_codes<TabT, AccT, 8>(tables, codes, code_bytes, packed, out, scale, offset, n, nq, m, k, row_blocks, stream);
    case 4: return launch_codes<TabT, AccT, 4>(tables, codes, code_bytes, packed, out, scale, offset, n, nq, m, k, row_blocks, stream);
    case 2: return launch_codes<TabT, AccT, 2>(tables, codes, code_bytes, packed, out, scale, offset, n, nq, m, k, row_blocks, stream);
    case 1: return launch_codes<TabT, AccT, 1>(tables, codes, code_bytes, packed, out, scale, offset, n, nq, m, k, row_blocks, stream);
    default: return cudaErrorInvalidValue;
  }
}

bool shape_ok(long long n, int nq, int m, int k, int code_bytes, int packed, int qt,
              int row_blocks) {
  if (packed && (code_bytes != 1 || m % 2 != 0 || k > 16)) return false;
  return nq > 0 && m > 0 && k > 0 && (code_bytes == 1 || code_bytes == 4) && row_blocks > 0 &&
         (long long)(nq + qt - 1) / qt <= 65535 && n >= 0;
}

}  // namespace

// tables (nq, m, k) f32, codes (n, m) uint8 (code_bytes 1) or int32 (4), or
// with packed != 0 (n, m/2) bytes of two u4 codes each (m even, k <= 16),
// out (nq, n) f32.  The plan is ops/adc.py::adc_plan's: qt queries a block
// (1, 2, 4, 8, 16 or 32), replicas copies of each entry (1, or 32 / qt),
// blocks per query tile, rows_per_block rows each (a multiple of 64; the
// blocks cover n and none is empty), smem_bytes = replicas*qt*m*k*4.  Returns
// -1 for a plan or shape it does not take, else cudaGetLastError() (or the
// error of the shared-memory opt-in).
extern "C" int rt_adc(const void* tables, const void* codes, int code_bytes, int packed,
                      void* out, long long n, int nq, int m, int k, int qt, int replicas,
                      int skew, int blocks, long long rows_per_block, int threads, int smem_bytes,
                      void* stream) {
  if (n == 0) return 0;
  if (n < 0 || nq <= 0 || m <= 0 || k <= 0 || (code_bytes != 1 && code_bytes != 4)) return -1;
  if (packed && (code_bytes != 1 || m % 2 != 0 || k > 16)) return -1;
  if (replicas != 1 && replicas * qt != 32) return -1;
  if (skew && (replicas != 1 || (qt != 8 && qt != 16) || m % 4 != 0 || packed)) return -1;
  if (threads != 512 && threads != kF32MaxThreads) return -1;
  if ((long long)replicas * qt * m * k * 4 != smem_bytes || smem_bytes > 227 * 1024) return -1;
  if (blocks <= 0 || rows_per_block <= 0 || rows_per_block % kRowAlign != 0 ||
      (long long)blocks * rows_per_block < n || (long long)(blocks - 1) * rows_per_block >= n)
    return -1;
  if ((nq + qt - 1) / qt > 65535) return -1;
  cudaStream_t s = (cudaStream_t)stream;
#define RT_ADC_F32_PLAN(QT, R)                                                                  \
  return (int)launch_f32_codes<QT, R>(tables, codes, code_bytes, packed, out, n, nq, m, k, blocks, \
                                       rows_per_block, threads, smem_bytes, skew != 0, s)
  const bool full = replicas != 1 || qt == 32;
  switch (qt) {
    case 32: RT_ADC_F32_PLAN(32, 1);
    case 16: if (full) RT_ADC_F32_PLAN(16, 2); RT_ADC_F32_PLAN(16, 1);
    case 8: if (full) RT_ADC_F32_PLAN(8, 4); RT_ADC_F32_PLAN(8, 1);
    case 4: if (full) RT_ADC_F32_PLAN(4, 8); RT_ADC_F32_PLAN(4, 1);
    case 2: if (full) RT_ADC_F32_PLAN(2, 16); RT_ADC_F32_PLAN(2, 1);
    case 1: if (full) RT_ADC_F32_PLAN(1, 32); RT_ADC_F32_PLAN(1, 1);
    default: return -1;
  }
#undef RT_ADC_F32_PLAN
}

// As rt_adc with int8 tables and an int32 sum:
// out[q, i] = float(sum) * scale[q] + offset[q], rounded after each step.
extern "C" int rt_adc_int8(const void* tables, const void* scale, const void* offset,
                           const void* codes, int code_bytes, int packed, void* out,
                           long long n, int nq, int m, int k, int qt, int row_blocks,
                           void* stream) {
  if (n == 0) return 0;
  if (!shape_ok(n, nq, m, k, code_bytes, packed, qt, row_blocks) || scale == nullptr ||
      offset == nullptr)
    return -1;
  return (int)launch_qt<int8_t, int32_t>(tables, codes, code_bytes, packed, out, scale, offset, n,
                                         nq, m, k, qt, row_blocks, (cudaStream_t)stream);
}
