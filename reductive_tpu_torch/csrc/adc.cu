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
// of codes read, 4*nq*n bytes of scores written, the tables read once,
// nq*n*m additions): 0.096 ms at the flagship shape (16 queries, 4,000,000
// rows, m=16, k=256), 0.086 with packed codes (k=16).  What the kernels
// really wait for is shared memory, which serves nq*n*m table entries at
// addresses the codes choose.  A warp's shared-memory load is served 128
// bytes (32 banks) a cycle; lanes that read other words of one bank in the
// same phase are served one after the other.  Lookups free of such conflicts
// cost nq*n*m*4 bytes / (128 bytes a cycle an SM) over f32 tables: 0.13 ms at
// the flagship shape, above the byte bound; over int8 tables nq*n*m bytes:
// about 0.031 ms, below it.
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
// int8 tables (adc_i8_kernel; ops/adc.py::adc_int8_plan chooses its plan;
// the ADC use of reductive_tpu/ops/decode.py::_decode_kernel_int8, called at
// reductive_tpu/ops/adc.py:172): the tables are built on the card by one
// launch (int8_tables_kernel, bit for bit ops/adc.py::quantize_tables_int8).
// * Lanes over queries, more queries a block: an entry is one byte, so a
//   lane's 16-byte load holds 16 queries' entries of one code (V = min(QT,
//   16) bytes a lane, L = QT/V lanes a row).  QT is the least power of two
//   that covers nq, from 4 to 32 (16 KB of tables a query at m=16, k=256 is
//   4 KB in int8: QT = 16 is 64 KB, 32 is 128 KB), so 16 queries read the
//   codes once, 128 four times.
// * Exact sums, four queries a word.  The fill stores each entry biased,
//   u = t8 ^ 0x80 = t8 + 128 in [0, 255]; each 32-bit word of entries adds
//   into two words of paired 16-bit halves (w & 0x00FF00FF, and bytes 1 and 3
//   by one byte permute): two logic operations and two additions for four
//   queries.  A half holds 256 codes' bytes (256 * 255 < 65,536); past that a
//   row's sums are flushed into out as int32 (m > 256 only).  At the end
//   sum(t8) = sum(u) - 128 * (codes that selected an entry): integer addition
//   is associative, so the sum equals the plain version's int32 sum in any
//   order, and the score, float(sum) * scale + offset rounded after each
//   step, is bit-equal to it.
// * Bank conflicts.  A phase of a load (8 lanes for 16-byte loads, 16 for 8,
//   32 for 4) holds S = 128/QT rows.  Where 128*m*k bytes fit (k <= 16, so
//   every packed shape) each entry is stored S times, laid out
//   [j][c][copy][q], and the s-th row of a phase reads copy s: no conflicts.
//   Where they do not (k = 256) each entry is stored once, laid out
//   [j][c][q], and the rows of a phase land where their codes put them
//   (about 2.5 wavefronts a phase at QT = 16).  On an H100 this kernel's
//   time follows its integer pipe (two logic operations and two additions a
//   word), not shared memory: a skewed walk free of those conflicts (each
//   group of S codes taken in an order turned by the row's place in its
//   phase) cost more in operations than the conflicts it removed, at the
//   flagship shape and at 128 queries (PERF.md), and is not built.
// * The rest as the f32 kernel: a persistent grid that fills each block's
//   tables once, code loads of 16, 8 or 4 bytes where the rows allow, bytes
//   elsewhere, int32 codes one at a time, packed rows both nibbles of a byte,
//   no test against k where every code of its type is below it, scores
//   stored along n for each query.

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

constexpr int kI8Flush = 256;  // codes a 16-bit half adds before it is flushed: 256*255 < 2^16
constexpr int kI8Tail = 256;   // bytes after the tables: QT scales, then QT offsets (QT <= 32)

__host__ __device__ constexpr long long i8_align16(long long b) { return (b + 15) & ~15LL; }

// Shared memory of adc_i8_kernel: the tables (QT bytes an entry, R copies),
// then the tail.
__host__ __device__ constexpr long long i8_smem(int qt, int replicas, int m, int k) {
  return i8_align16((long long)replicas * qt * m * k) + kI8Tail;
}

template <int V> struct I8Words { static constexpr int W = V >= 4 ? V / 4 : 1; };

// V bytes of biased entries at p as 32-bit words (V = 2 and 1: zero-extended).
template <int V>
__device__ __forceinline__ void load_entry(const unsigned char* p, uint32_t (&w)[I8Words<V>::W]) {
  if constexpr (V == 16) {
    const uint4 v = *reinterpret_cast<const uint4*>(p);
    w[0] = v.x; w[1] = v.y; w[2] = v.z; w[3] = v.w;
  } else if constexpr (V == 8) {
    const uint2 v = *reinterpret_cast<const uint2*>(p);
    w[0] = v.x; w[1] = v.y;
  } else if constexpr (V == 4) {
    w[0] = *reinterpret_cast<const uint32_t*>(p);
  } else if constexpr (V == 2) {
    w[0] = *reinterpret_cast<const uint16_t*>(p);
  } else {
    w[0] = *p;
  }
}

// Adds the V biased entries at p (one byte a query, u = t8 + 128) into paired
// 16-bit halves: acc[2i] holds queries 4i (low half) and 4i+2 (high half),
// acc[2i+1] queries 4i+1 and 4i+3.  Two logic operations and two additions
// for four queries; exact while a half has taken at most 257 bytes.
template <int V>
__device__ __forceinline__ void add_entry(const unsigned char* p, uint32_t (&acc)[2 * I8Words<V>::W]) {
  uint32_t w[I8Words<V>::W];
  load_entry<V>(p, w);
#pragma unroll
  for (int i = 0; i < I8Words<V>::W; ++i) {
    acc[2 * i] += w[i] & 0x00FF00FFu;
    acc[2 * i + 1] += __byte_perm(w[i], 0u, 0x4341);  // bytes 1 and 3, moved down to 0 and 2
  }
}

// The end of a chunk of at most kI8Flush codes of one row: for each of the
// lane's V queries the chunk's sum is its half less 128 for each code that
// selected an entry (`valid`), added to the earlier chunks' sum (kept in out
// as int32 until the last chunk).  After the last chunk the score is
// float(sum) * scale + offset, rounded after each step, as the plain version.
template <int V>
__device__ __forceinline__ void flush_row(const uint32_t (&acc)[2 * I8Words<V>::W], int valid,
                                          long long row, bool first, bool last,
                                          float* __restrict__ out, long long n, int nq, int qa,
                                          const float* s_scale, const float* s_offset) {
  // One running pointer along the lane's queries: n floats from a query's
  // score of this row to the next's.  (Addresses q * n + row for each q would
  // be hoisted out of the row loop, 2 V registers for the whole walk.)
  float* o = out + (long long)qa * n + row;
#pragma unroll
  for (int t0 = 0; t0 < V; t0 += 4) {
    float sc[4], of[4];  // the scales and offsets of queries t0..t0+3, 16 bytes a load
    if constexpr (V >= 4) {
      const float4 a = *reinterpret_cast<const float4*>(s_scale + t0);
      const float4 b = *reinterpret_cast<const float4*>(s_offset + t0);
      sc[0] = a.x; sc[1] = a.y; sc[2] = a.z; sc[3] = a.w;
      of[0] = b.x; of[1] = b.y; of[2] = b.z; of[3] = b.w;
    } else {
#pragma unroll
      for (int t = 0; t < V; ++t) { sc[t] = s_scale[t]; of[t] = s_offset[t]; }
    }
#pragma unroll
    for (int t = t0; t < t0 + 4 && t < V; ++t) {
      if (qa + t < nq) {
        const uint32_t a = acc[2 * (t / 4) + (t & 1)];
        int sum = (int)((t & 2) ? (a >> 16) : (a & 0xFFFFu)) - 128 * valid;
        if (!first) sum += *reinterpret_cast<const int*>(o);
        if (last)
          *o = __fadd_rn(__fmul_rn((float)sum, sc[t - t0]), of[t - t0]);
        else
          *reinterpret_cast<int*>(o) = sum;
      }
      o += n;
    }
  }
}

// The code words of one lane's rows, NB bytes at a time, one load ahead:
// take() hands out the word at (row, e0) that the previous call loaded and
// loads the one after it, (row, e0 + NB) or, past the row's end, the first of
// the lane's next row (row + stride), so that a load is in flight while the
// current word is looked up.  A row at or past `end` reads as zeros.
template <int NB>
struct CodeStream {
  uint32_t next[(NB + 3) / 4];
  const unsigned char* codes;
  long long end, stride;
  int width;  // bytes a row

  __device__ __forceinline__ void load(long long row, int e0) {
    if (row < end) {
      load_code_words<NB>(codes + row * width + e0, next);
    } else {
#pragma unroll
      for (int i = 0; i < (NB + 3) / 4; ++i) next[i] = 0;
    }
  }
  __device__ __forceinline__ void take(long long row, int e0, uint32_t (&w)[(NB + 3) / 4]) {
#pragma unroll
    for (int i = 0; i < (NB + 3) / 4; ++i) w[i] = next[i];
    const bool more = e0 + NB < width;
    load(more ? row : row + stride, more ? e0 + NB : 0);
  }
};

// The plain walk over int8 tables laid out [j][c][copy][q]: as walk_plain, a
// lane takes rows base + lane/L (one row at a time: two spilled at the
// 64-register cap, 200 bytes of stack at QT = 16) and queries
// (lane % L) * V onward from copy (lane/L) % R (R = 1, or 128 / QT: one copy
// for each row of a load's phase, no bank conflicts), and adds, for j =
// 0..m-1, the V bytes of entry (j, c) there.  Rows of whole aligned words
// (NB >= 4, uint8 or packed) come through a CodeStream.  ALL: every code of
// its type is below k.
template <int QT, int R, typename CodeT, bool PACKED, int NB, bool ALL>
__device__ __forceinline__ void walk_plain_i8(const unsigned char* s_tab, const float* s_scale,
                                              const float* s_offset,
                                              const CodeT* __restrict__ codes,
                                              float* __restrict__ out, long long start,
                                              long long end, long long n, int nq, int m, int k,
                                              int q0) {
  constexpr int V = QT < 16 ? QT : 16;
  constexpr int L = QT / V;
  constexpr int RW = 32 / L;
  constexpr int W = I8Words<V>::W;
  constexpr int EPL = NB / (int)sizeof(CodeT);
  constexpr int NW = (NB + 3) / 4;
  constexpr bool STREAM = sizeof(CodeT) == 1 && NB >= 4;
  const int lane = threadIdx.x & 31;
  const int r = lane / L;
  const int h = lane % L;
  const int copy = R == 1 ? 0 : r % R;
  const unsigned char* s_lane = s_tab + copy * QT + h * V;
  const int width = PACKED ? m / 2 : m;  // elements of CodeT a row
  const int chunk = PACKED ? kI8Flush / 2 : kI8Flush;
  const unsigned ku = (unsigned)k;
  const long long stride = (long long)(blockDim.x / 32) * RW;
  long long row = start + (long long)(threadIdx.x >> 5) * RW + r;
  CodeStream<NB> stream{{}, reinterpret_cast<const unsigned char*>(codes), end, stride,
                        width * (int)sizeof(CodeT)};
  if constexpr (STREAM) stream.load(row, 0);
  for (; row - r < end; row += stride) {
    const bool live = row < end;
    const unsigned char* cr =
        reinterpret_cast<const unsigned char*>(codes + (live ? row : start) * width);
    for (int e1 = 0; e1 < width;) {
      const int e2 = min(width, e1 + chunk);
      uint32_t acc[2 * W];
#pragma unroll
      for (int i = 0; i < 2 * W; ++i) acc[i] = 0u;
      int valid = 0;
      // A code that is not below k selects nothing.
      auto add = [&](int j, uint32_t c) {
        if (ALL || c < ku) {
          add_entry<V>(s_lane + (j * k + (int)c) * (R * QT), acc);
          if (!ALL) ++valid;
        }
      };
      for (int e0 = e1; e0 < e2; e0 += EPL) {
        uint32_t w[NW];
        if constexpr (STREAM) {
          stream.take(row, e0, w);
        } else if (live) {
          load_code_words<NB>(cr + (long long)e0 * sizeof(CodeT), w);
        } else {
#pragma unroll
          for (int i = 0; i < NW; ++i) w[i] = 0;
        }
#pragma unroll
        for (int b = 0; b < EPL; ++b) {
          uint32_t v;
          if constexpr (sizeof(CodeT) == 1) {
            v = (w[b / 4] >> (8 * (b % 4))) & 0xffu;
          } else {
            v = w[b];
          }
          if constexpr (PACKED) {
            add(2 * (e0 + b), v & 0xFu);
            add(2 * (e0 + b) + 1, v >> 4);
          } else {
            add(e0 + b, v);
          }
        }
      }
      if (live)
        flush_row<V>(acc, ALL ? (e2 - e1) * (PACKED ? 2 : 1) : valid, row, e1 == 0, e2 == width,
                     out, n, nq, q0 + h * V, s_scale + h * V, s_offset + h * V);
      e1 = e2;
    }
  }
}

// The fill of adc_i8_kernel, CB entries of a query's table a load.
template <int QT, int R, int CB>
__device__ __forceinline__ void fill_i8(unsigned char* s_tab, const signed char* __restrict__ t8,
                                        int nq, int m, int k, int q0) {
  const int qf = threadIdx.x % QT;
  const int groups = blockDim.x / QT;
  const bool qlive = q0 + qf < nq;
  const signed char* src = t8 + (long long)(qlive ? q0 + qf : 0) * m * k;
  const int kq = k / CB;
  const int total = R * m * kq;
#pragma unroll 4
  for (int idx = threadIdx.x / QT; idx < total; idx += groups) {
    const int copy = idx % R;
    const int rest = idx / R;
    const int j = rest / kq;
    const int c0 = (rest - j * kq) * CB;
    uint32_t w[(CB + 3) / 4];
    if constexpr (CB == 16) {
      uint4 v = make_uint4(0x80808080u, 0x80808080u, 0x80808080u, 0x80808080u);
      if (qlive) v = *reinterpret_cast<const uint4*>(src + j * k + c0);
      w[0] = v.x; w[1] = v.y; w[2] = v.z; w[3] = v.w;
    } else if constexpr (CB == 4) {
      w[0] = qlive ? *reinterpret_cast<const uint32_t*>(src + j * k + c0) : 0x80808080u;
    } else {
      w[0] = qlive ? (uint32_t)(unsigned char)src[j * k + c0] : 0x80u;
    }
#pragma unroll
    for (int b = 0; b < CB; ++b) {
      const int c = c0 + b;
      s_tab[((j * k + c) * R + copy) * QT + qf] = (unsigned char)((w[b / 4] >> (8 * (b % 4))) ^ 0x80u);
    }
  }
}

// QT queries a block (1, 2, 4, 8, 16 or 32), R copies of each entry (1, or
// 128 / QT: no bank conflicts), NB bytes of codes a load (16, 8 or 4: whole aligned words; 1: bytes; int32
// codes take 4, one code).  PACKED: CodeT is uint8_t and a row is m/2 bytes of
// two u4 codes, code 2b in the low nibble of byte b and code 2b+1 in the high.
template <int QT, int R, typename CodeT, bool PACKED, int NB>
__global__ void __launch_bounds__(kF32MaxThreads)
adc_i8_kernel(const signed char* __restrict__ t8, const float* __restrict__ scale,
              const float* __restrict__ offset, const CodeT* __restrict__ codes,
              float* __restrict__ out, long long n, int nq, int m, int k,
              long long rows_per_block) {
  static_assert(R == 1 || (QT >= 4 && R * QT == 128), "replicas: none, or one per row of a phase");
  static_assert(NB >= (int)sizeof(CodeT), "a load takes at least one code element");

  extern __shared__ __align__(16) unsigned char smem_raw[];
  unsigned char* s_tab = smem_raw;  // [j][c][copy][q]
  const int q0 = blockIdx.y * QT;
  const long long table_bytes = i8_smem(QT, R, m, k) - kI8Tail;
  float* s_scale = reinterpret_cast<float*>(smem_raw + table_bytes);
  float* s_offset = s_scale + 32;
  for (int i = threadIdx.x; i < QT; i += blockDim.x) {
    const bool ok = q0 + i < nq;
    s_scale[i] = ok ? scale[q0 + i] : 0.0f;
    s_offset[i] = ok ? offset[q0 + i] : 0.0f;
  }
  // The fill: thread t takes query t % QT and, with the block's other threads
  // of that query, the entries (j, c) sixteen at a time where a table row is
  // whole 16-byte words (four where it is whole words, else one), copy
  // fastest: neighbouring threads read neighbouring bytes of a query's table
  // and write neighbouring bytes, or neighbouring copies, of the block's;
  // four loads a thread in flight.  Each entry is stored biased, u = t8 ^
  // 0x80 = t8 + 128; queries past nq hold 0.
  if ((k & 15) == 0)
    fill_i8<QT, R, 16>(s_tab, t8, nq, m, k, q0);
  else if ((k & 3) == 0)
    fill_i8<QT, R, 4>(s_tab, t8, nq, m, k, q0);
  else
    fill_i8<QT, R, 1>(s_tab, t8, nq, m, k, q0);
  __syncthreads();

  const long long start = (long long)blockIdx.x * rows_per_block;
  const long long end = start + rows_per_block < n ? start + rows_per_block : n;
  if constexpr (sizeof(CodeT) == 1 && NB >= 4) {
    if (k >= (PACKED ? 16 : 256)) {
      walk_plain_i8<QT, R, CodeT, PACKED, NB, true>(s_tab, s_scale, s_offset, codes, out, start,
                                                    end, n, nq, m, k, q0);
      return;
    }
  }
  walk_plain_i8<QT, R, CodeT, PACKED, NB, false>(s_tab, s_scale, s_offset, codes, out, start, end,
                                                 n, nq, m, k, q0);
}

template <int QT, int R, typename CodeT, bool PACKED, int NB>
cudaError_t launch_i8(const void* t8, const void* scale, const void* offset, const void* codes,
                      void* out, long long n, int nq, int m, int k, int blocks,
                      long long rows_per_block, int threads, int smem, cudaStream_t stream) {
  auto kern = adc_i8_kernel<QT, R, CodeT, PACKED, NB>;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return e;
  }
  const dim3 grid((unsigned)blocks, (unsigned)((nq + QT - 1) / QT));
  kern<<<grid, threads, smem, stream>>>((const signed char*)t8, (const float*)scale,
                                        (const float*)offset, (const CodeT*)codes, (float*)out, n,
                                        nq, m, k, rows_per_block);
  return cudaGetLastError();
}

// The code loads, as launch_f32_codes chooses them.
template <int QT, int R>
cudaError_t launch_i8_codes(const void* t8, const void* scale, const void* offset,
                            const void* codes, int code_bytes, int packed, void* out, long long n,
                            int nq, int m, int k, int blocks, long long rows_per_block,
                            int threads, int smem, cudaStream_t stream) {
#define RT_ADC_I8(CodeT, PACKED, NB)                                                           \
  launch_i8<QT, R, CodeT, PACKED, NB>(t8, scale, offset, codes, out, n, nq, m, k, blocks,        \
                                      rows_per_block, threads, smem, stream)
  const int width = packed ? m / 2 : m;
  const uintptr_t base = (uintptr_t)codes;
  int nb = 1;
  for (int b : {16, 8, 4})
    if (nb == 1 && width % b == 0 && base % b == 0) nb = b;
  if (code_bytes == 4) return RT_ADC_I8(int32_t, false, 4);
  if (packed) return nb == 16 ? RT_ADC_I8(uint8_t, true, 16)
                   : nb == 8 ? RT_ADC_I8(uint8_t, true, 8)
                   : nb == 4 ? RT_ADC_I8(uint8_t, true, 4)
                             : RT_ADC_I8(uint8_t, true, 1);
  return nb == 16 ? RT_ADC_I8(uint8_t, false, 16)
         : nb == 8 ? RT_ADC_I8(uint8_t, false, 8)
         : nb == 4 ? RT_ADC_I8(uint8_t, false, 4) : RT_ADC_I8(uint8_t, false, 1);
#undef RT_ADC_I8
}

// -- the int8 tables, built once a call ----------------------------------------

constexpr int kPrepThreads = 256;
constexpr float kRecip255 = 1.0f / 255.0f;  // the f32 reciprocal, as XLA and ops/adc.py use

__device__ __forceinline__ float min_nan(float a, float b) { return (a < b || a != a) ? a : b; }
__device__ __forceinline__ float max_nan(float a, float b) { return (a > b || a != a) ? a : b; }

// One block a query, bit for bit ops/adc.py::quantize_tables_int8: the least
// and largest entry of each of its m tables (a warp a table; exact in any
// order, NaN kept as torch's amin and amax keep it), scale = max(max_j (max_j
// - min_j) * f32(1/255), 1e-30), t8 = clamp(rint((t - min_j) / scale) - 128,
// -128, 127) with IEEE division and half to even, and offset = ((min_0 +
// min_1) + ... + min_{m-1}) + f32(128 m) * scale, added in that order.
__global__ void __launch_bounds__(kPrepThreads)
int8_tables_kernel(const float* __restrict__ tables, signed char* __restrict__ t8,
                   float* __restrict__ scale, float* __restrict__ offset, int m, int k) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* s_min = reinterpret_cast<float*>(smem_raw);  // [m]
  __shared__ float s_range[kPrepThreads / 32];
  __shared__ float s_scale;
  const int q = blockIdx.x;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, warps = blockDim.x >> 5;
  const float* src = tables + (long long)q * m * k;
  signed char* dst = t8 + (long long)q * m * k;
  float range = 0.0f;  // every max_j - min_j is >= 0 or NaN
  for (int j = warp; j < m; j += warps) {
    float lo = __int_as_float(0x7f800000), hi = -__int_as_float(0x7f800000);
    for (int c = lane; c < k; c += 32) {
      const float v = src[(long long)j * k + c];
      lo = min_nan(lo, v);
      hi = max_nan(hi, v);
    }
#pragma unroll
    for (int d = 16; d > 0; d >>= 1) {
      lo = min_nan(lo, __shfl_xor_sync(0xffffffffu, lo, d));
      hi = max_nan(hi, __shfl_xor_sync(0xffffffffu, hi, d));
    }
    if (lane == 0) s_min[j] = lo;
    range = max_nan(range, __fsub_rn(hi, lo));
  }
  if (lane == 0) s_range[warp] = range;
  __syncthreads();
  if (threadIdx.x == 0) {
    float r = s_range[0];
    for (int w = 1; w < warps; ++w) r = max_nan(r, s_range[w]);
    float s = __fmul_rn(r, kRecip255);
    s = s < 1e-30f ? 1e-30f : s;  // torch.clamp(min=1e-30): NaN stays NaN
    float sum = s_min[0];
    for (int j = 1; j < m; ++j) sum = __fadd_rn(sum, s_min[j]);
    scale[q] = s;
    offset[q] = __fadd_rn(sum, __fmul_rn((float)(128 * m), s));
    s_scale = s;
  }
  __syncthreads();
  const float s = s_scale;
  for (int j = warp; j < m; j += warps) {
    const float lo = s_min[j];
    for (int c = lane; c < k; c += 32) {
      const float v = __fsub_rn(rintf(__fdiv_rn(__fsub_rn(src[(long long)j * k + c], lo), s)), 128.0f);
      dst[(long long)j * k + c] = (signed char)(int)fminf(fmaxf(v, -128.0f), 127.0f);
    }
  }
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
// As rt_adc with int8 tables: t8 (nq, m, k) int8, scale and offset (nq,) f32
// from rt_adc_prepare_int8 (or ops/adc.py::quantize_tables_int8), an int32
// sum, out[q, i] = float(sum) * scale[q] + offset[q], rounded after each step.
// The plan is ops/adc.py::adc_int8_plan's: qt queries a block (1, 2, 4, 8,
// 16 or 32), replicas copies of each entry (1, or 128 / qt), blocks per query tile of
// rows_per_block rows each (as rt_adc), threads 512 or 1,024, smem_bytes as
// i8_smem.  Returns -1 for a plan or shape it does not take, else
// cudaGetLastError() (or the error of the shared-memory opt-in).
extern "C" int rt_adc_i8(const void* t8, const void* scale, const void* offset, const void* codes,
                         int code_bytes, int packed, void* out, long long n, int nq, int m, int k,
                         int qt, int replicas, int blocks, long long rows_per_block,
                         int threads, int smem_bytes, void* stream) {
  if (n == 0) return 0;
  if (n < 0 || nq <= 0 || m <= 0 || k <= 0 || (code_bytes != 1 && code_bytes != 4)) return -1;
  if (t8 == nullptr || scale == nullptr || offset == nullptr) return -1;
  if (packed && (code_bytes != 1 || m % 2 != 0 || k > 16)) return -1;
  if (qt != 1 && qt != 2 && qt != 4 && qt != 8 && qt != 16 && qt != 32) return -1;
  if (replicas != 1 && (qt < 4 || replicas * qt != 128)) return -1;
  if (threads != 512 && threads != kF32MaxThreads) return -1;
  if (i8_smem(qt, replicas, m, k) != smem_bytes || smem_bytes > 227 * 1024) return -1;
  if (blocks <= 0 || rows_per_block <= 0 || rows_per_block % kRowAlign != 0 ||
      (long long)blocks * rows_per_block < n || (long long)(blocks - 1) * rows_per_block >= n)
    return -1;
  if ((nq + qt - 1) / qt > 65535) return -1;
  cudaStream_t s = (cudaStream_t)stream;
#define RT_ADC_I8_PLAN(QT, R)                                                                  \
  return (int)launch_i8_codes<QT, R>(t8, scale, offset, codes, code_bytes, packed, out, n, nq, m, \
                                      k, blocks, rows_per_block, threads, smem_bytes, s)
  const bool full = replicas != 1;
  switch (qt) {
    case 32: if (full) RT_ADC_I8_PLAN(32, 4); RT_ADC_I8_PLAN(32, 1);
    case 16: if (full) RT_ADC_I8_PLAN(16, 8); RT_ADC_I8_PLAN(16, 1);
    case 8: if (full) RT_ADC_I8_PLAN(8, 16); RT_ADC_I8_PLAN(8, 1);
    case 4: if (full) RT_ADC_I8_PLAN(4, 32); RT_ADC_I8_PLAN(4, 1);
    case 2: RT_ADC_I8_PLAN(2, 1);
    case 1: RT_ADC_I8_PLAN(1, 1);
    default: return -1;
  }
#undef RT_ADC_I8_PLAN
}

// tables (nq, m, k) f32 -> t8 (nq, m, k) int8, scale (nq,), offset (nq,):
// one launch, a block a query (int8_tables_kernel).  Returns -1 for a shape
// it does not take (m floats of minima above a block's shared memory).
extern "C" int rt_adc_prepare_int8(const void* tables, void* t8, void* scale, void* offset, int nq,
                                   int m, int k, void* stream) {
  if (nq <= 0 || m <= 0 || k <= 0) return -1;
  const int smem = 4 * m;
  if (smem > 227 * 1024) return -1;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(int8_tables_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return (int)e;
  }
  int8_tables_kernel<<<nq, kPrepThreads, smem, (cudaStream_t)stream>>>(
      (const float*)tables, (signed char*)t8, (float*)scale, (float*)offset, m, k);
  return (int)cudaGetLastError();
}
