// PQ decode: out[i, j*ds:(j+1)*ds] = C[j, codes[i, j], :].
//
// Replaces the TPU kernels reductive_tpu/ops/decode.py::_decode_kernel (the
// f32 table: the wrapper has already summed the bf16 parts into one effective
// codebook) and ::_decode_kernel_int8 in its decode use (int8 table, one f32
// scale per output column).  The TPU kernels restate the lookup as a multihot
// matrix product because gathers are slow there; on this card it is a gather.
// Every output element is one table entry, so the result is bit-equal to the
// matrix-product form.
//
// What bounds it on an H100: bytes.  n*d*4 bytes are written against n*m bytes
// of codes read; there is no arithmetic.  Where ds is a multiple of 4, one
// thread writes 16 bytes along d (neighbouring threads on neighbouring
// addresses), the table (128 KB at m=16, k=256, ds=8; 768 KB at m=24, k=256,
// ds=32) read through the read-only cache from L2.  At any other ds (2 at the
// reference's d = 20, m = 10; 2 to 30 for 300-d embeddings) a row of the table
// is not on 16 bytes, but a tile of rows is one contiguous run of output: the
// row-tile kernel (decode_tile_kernel) stages a tile's codes in shared memory
// and writes float4s along the run, carrying (row, subquantizer, column) from
// float to float instead of dividing for each, with the table in shared memory
// where it fits (ops/decode.py::decode_tile_plan) and read from L2 where it
// does not.  A code that is not below k selects nothing and the element is 0,
// as a multihot row without a match gives.
//
// The table is built on the card once a call by one launch
// (rt_decode_prepare): the effective codebook of the bf16 split, or the int8
// quantizer's matrix and scales, bit for bit what ops/decode.py's plain
// version computes.
//
// Packed u4 codes (the packed=True variants of the same TPU kernels, wired
// through lane_multihot_packed there): a row is m/2 bytes, byte j/2 holds code
// j in its low nibble for even j and in its high nibble for odd j.  The thread
// reads its byte and takes its nibble; the table stays in natural order (the
// TPU kernels permute its row blocks to suit their multihot, which has no
// meaning for a gather).  The bytes read fall to n*m/2.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kThreads = 256;

// Code j of a row: element j of an (n, m) matrix, or nibble j of an (n, m/2)
// matrix of bytes.
template <typename CodeT, bool PACKED>
__device__ __forceinline__ unsigned long long code_at(const CodeT* __restrict__ codes,
                                                      long long row, int m, int j) {
  if constexpr (PACKED) {
    const unsigned int b = codes[row * (m >> 1) + (j >> 1)];
    return (j & 1) ? (b >> 4) : (b & 0xFu);
  } else {
    return (unsigned long long)codes[row * m + j];
  }
}

template <typename CodeT, bool PACKED>
__global__ void __launch_bounds__(kThreads)
decode_kernel(const CodeT* __restrict__ codes, const float4* __restrict__ cb4,
              float4* __restrict__ out4, long long total4, int m, int k, int ds4) {
  const long long d4 = (long long)m * ds4;
  const long long stride = (long long)gridDim.x * kThreads;
  for (long long idx = (long long)blockIdx.x * kThreads + threadIdx.x; idx < total4; idx += stride) {
    const long long row = idx / d4;
    const int c4 = (int)(idx - row * d4);
    const int j = c4 / ds4;
    const int t4 = c4 - j * ds4;
    const unsigned long long code = code_at<CodeT, PACKED>(codes, row, m, j);
    float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
    if (code < (unsigned long long)k) v = __ldg(cb4 + ((long long)j * k + (long long)code) * ds4 + t4);
    out4[idx] = v;
  }
}

template <typename CodeT, bool PACKED>
__global__ void __launch_bounds__(kThreads)
decode_int8_kernel(const CodeT* __restrict__ codes, const char4* __restrict__ w4,
                   const float4* __restrict__ scale4, float4* __restrict__ out4,
                   long long total4, int m, int k, int ds4) {
  const long long d4 = (long long)m * ds4;
  const long long stride = (long long)gridDim.x * kThreads;
  for (long long idx = (long long)blockIdx.x * kThreads + threadIdx.x; idx < total4; idx += stride) {
    const long long row = idx / d4;
    const int c4 = (int)(idx - row * d4);
    const int j = c4 / ds4;
    const int t4 = c4 - j * ds4;
    const unsigned long long code = code_at<CodeT, PACKED>(codes, row, m, j);
    float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
    if (code < (unsigned long long)k) {
      const char4 w = __ldg(w4 + ((long long)j * k + (long long)code) * ds4 + t4);
      const float4 s = __ldg(scale4 + c4);
      v.x = __fmul_rn((float)w.x, s.x);
      v.y = __fmul_rn((float)w.y, s.y);
      v.z = __fmul_rn((float)w.z, s.z);
      v.w = __fmul_rn((float)w.w, s.w);
    }
    out4[idx] = v;
  }
}


// -- the tables, built once a call ------------------------------------------

constexpr float kRecip127 = 1.0f / 127.0f;  // the f32 reciprocal, as XLA and ops/decode.py use

// The effective codebook of a `splits`-part bf16 product form: each part is
// the running residual rounded to bf16 (nearest even), the parts added in f32
// first to last.  Bit for bit ops/decode.py::effective_codebook (torch rounds
// to bf16 with the same __float2bfloat16 on this card).
__global__ void __launch_bounds__(kThreads)
effective_table_kernel(const float* __restrict__ cb, float* __restrict__ table, long long total,
                       int splits) {
  const long long stride = (long long)gridDim.x * kThreads;
  for (long long i = (long long)blockIdx.x * kThreads + threadIdx.x; i < total; i += stride) {
    float residual = cb[i];
    float part = __bfloat162float(__float2bfloat16_rn(residual));
    float sum = part;
    for (int s = 1; s < splits; ++s) {
      residual = __fsub_rn(residual, part);
      part = __bfloat162float(__float2bfloat16_rn(residual));
      sum = __fadd_rn(sum, part);
    }
    table[i] = sum;
  }
}

// The symmetric per-column int8 quantizer of ops/decode.py::quantize_codebook_int8:
// scale[j*ds + t] = max_c |cb[j, c, t]| * (1/127), w8 = rint(cb / max(scale, 1e-30)).
// Block (x, j) takes up to 32 columns t of subquantizer j; the threads of a
// column split its k entries.  The maximum runs on the bits of |v| (NaN above
// inf, as torch's amax propagates it).
__global__ void __launch_bounds__(kThreads)
int8_table_kernel(const float* __restrict__ cb, signed char* __restrict__ w8,
                  float* __restrict__ scale, int k, int ds) {
  __shared__ unsigned int col_max[32];
  const int j = blockIdx.y;
  const int t0 = 32 * blockIdx.x;
  const int cols = min(32, ds - t0);
  const int lanes = kThreads / cols;
  const int col = threadIdx.x % cols, lane = threadIdx.x / cols;
  const bool active = lane < lanes;
  const int t = t0 + col;
  if (threadIdx.x < 32) col_max[threadIdx.x] = 0u;
  __syncthreads();
  const float* src = cb + (long long)j * k * ds + t;
  if (active) {
    unsigned int amax = 0u;
    for (int c = lane; c < k; c += lanes)
      amax = max(amax, __float_as_uint(src[(long long)c * ds]) & 0x7fffffffu);
    atomicMax(col_max + col, amax);
  }
  __syncthreads();
  if (!active) return;
  const float s = __fmul_rn(__uint_as_float(col_max[col]), kRecip127);
  if (lane == 0) scale[j * ds + t] = s;
  const float denom = s < 1e-30f ? 1e-30f : s;  // torch.clamp(min=1e-30): NaN stays NaN
  signed char* dst = w8 + (long long)j * k * ds + t;
  for (int c = lane; c < k; c += lanes)
    dst[(long long)c * ds] = (signed char)__float2int_rn(__fdiv_rn(src[(long long)c * ds], denom));
}

// -- any ds: a coalesced gather of row tiles ----------------------------------

// Copies `bytes` bytes from global `src` to shared `dst` (on 16 bytes) with the
// block's threads: 16 bytes a load where src is on 16 bytes, 4 where it is on
// 4 (a codes view that starts off a word), else one.
__device__ __forceinline__ void stage(unsigned char* dst, const unsigned char* src, int bytes) {
  const unsigned a = (unsigned)(uintptr_t)src;
  int done = 0;
  if ((a & 15u) == 0) {
    const int n16 = bytes >> 4;
    for (int i = threadIdx.x; i < n16; i += kThreads)
      reinterpret_cast<uint4*>(dst)[i] = __ldg(reinterpret_cast<const uint4*>(src) + i);
    done = n16 << 4;
  } else if ((a & 3u) == 0) {
    const int n4 = bytes >> 2;
    for (int i = threadIdx.x; i < n4; i += kThreads)
      reinterpret_cast<unsigned int*>(dst)[i] = __ldg(reinterpret_cast<const unsigned int*>(src) + i);
    done = n4 << 2;
  }
  for (int i = done + threadIdx.x; i < bytes; i += kThreads) dst[i] = src[i];
}

template <bool SHARED, typename T>
__device__ __forceinline__ T fetch(const T* p, int i) {
  if constexpr (SHARED) return p[i];
  else return __ldg(p + i);
}

__host__ __device__ constexpr int align16(long long b) { return (int)((b + 15) & ~15LL); }

// Shared memory of the row-tile kernels for `group` subquantizers a block:
// m, the whole table ([scale (int8, d floats)][table][codes tile]); 0, the
// codes tile alone (the table read from L2); else decode_group_kernel's
// [column map (and int8 scales)][the group's table][codes tile].
long long tile_smem(bool int8, int group, int m, int k, int ds, int row_bytes, int rows) {
  const long long codes = (long long)rows * row_bytes;
  const long long elt = int8 ? 1 : 4;
  if (group == 0) return codes;
  if (group >= m)
    return codes + (int8 ? align16(4LL * m * ds) : 0) + align16(elt * m * k * ds);
  const long long width = (long long)group * ds;
  return codes + align16(4 * width * (int8 ? 3 : 2)) + align16(elt * width * k);
}

// out[i, j*ds + t] = W[j, code(i, j), t] (f32), or float(W8[j, code, t]) *
// scale[j*ds + t] (int8); 0 for a code not below k.  A block walks row tiles
// of `rows` rows (grid-stride).  A tile's output is one contiguous run of
// rows*d floats whatever ds is: its codes (a contiguous span) are staged into
// shared memory, then every thread writes float4s along the run, neighbouring
// threads on neighbouring 16 bytes.  The floats before the run's first 16-byte
// boundary and after its last whole float4 (at most 3 each: ds or d odd, an
// `out` off 16 bytes) are written one at a time.  A thread finds the row,
// subquantizer and column of its first float once a tile (three divisions),
// then carries them along: +1 a float, +4*kThreads a step.  With SHARED the
// table (and the int8 scales) are staged once a block; else every entry is read
// through the read-only path from L2.
template <typename CodeT, bool PACKED, bool INT8, bool SHARED>
__global__ void __launch_bounds__(kThreads)
decode_tile_kernel(const CodeT* __restrict__ codes, const void* __restrict__ table_g,
                   const float* __restrict__ scale_g, float* __restrict__ out, long long n, int m,
                   int k, int ds, int rows_per_tile) {
  using W = typename std::conditional<INT8, signed char, float>::type;
  extern __shared__ __align__(16) unsigned char smem[];
  const int d = m * ds;
  const int row_bytes = PACKED ? (m >> 1) : m * (int)sizeof(CodeT);
  const W* table = static_cast<const W*>(table_g);
  const float* scale = scale_g;
  unsigned char* tile_codes = smem;
  if constexpr (SHARED) {
    unsigned char* p = smem;
    if constexpr (INT8) {
      stage(p, reinterpret_cast<const unsigned char*>(scale_g), 4 * d);
      scale = reinterpret_cast<const float*>(p);
      p += align16(4LL * d);
    }
    const int table_bytes = m * k * ds * (int)sizeof(W);
    stage(p, static_cast<const unsigned char*>(table_g), table_bytes);
    table = reinterpret_cast<const W*>(p);
    tile_codes = p + align16(table_bytes);
  }

  auto value = [&](int r, int j, int t) -> float {
    unsigned int code;
    if constexpr (PACKED) {
      const unsigned int b = tile_codes[r * row_bytes + (j >> 1)];
      code = (j & 1) ? (b >> 4) : (b & 0xFu);
    } else {
      code = (unsigned int)reinterpret_cast<const CodeT*>(tile_codes)[r * m + j];
    }
    if (code >= (unsigned int)k) return 0.0f;
    const int idx = (j * k + (int)code) * ds + t;
    if constexpr (INT8) return __fmul_rn((float)fetch<SHARED>(table, idx), fetch<SHARED>(scale, j * ds + t));
    else return fetch<SHARED>(table, idx);
  };

  // One step of a thread: 4*kThreads floats, as (rows, subquantizers, columns).
  constexpr int kStep = 4 * kThreads;
  const int step_r = kStep / d, step_c = kStep - step_r * d;
  const int step_j = step_c / ds, step_t = step_c - step_j * ds;
  const unsigned int out_word = (unsigned int)((uintptr_t)out >> 2);
  const long long tiles = (n + rows_per_tile - 1) / rows_per_tile;
  for (long long tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    const long long row0 = tile * rows_per_tile;
    const int rows = (int)min((long long)rows_per_tile, n - row0);
    stage(tile_codes, reinterpret_cast<const unsigned char*>(codes) + row0 * row_bytes,
          rows * row_bytes);
    __syncthreads();  // the codes (and, the first time, the table) are in

    const long long start = row0 * d;
    float* o = out + start;
    const int count = rows * d;
    const int head = min((int)((4u - ((out_word + (unsigned int)start) & 3u)) & 3u), count);
    const int nvec = (count - head) >> 2;
    const int tail = head + 4 * nvec;
    if ((int)threadIdx.x < count - tail + head) {  // the scalars: head, then tail
      const int l = (int)threadIdx.x < head ? (int)threadIdx.x : tail + (int)threadIdx.x - head;
      const int r = l / d, c = l - r * d, j = c / ds;
      o[l] = value(r, j, c - j * ds);
    }
    if ((int)threadIdx.x < nvec) {
      const int l = head + 4 * (int)threadIdx.x;
      int r = l / d;
      int j = (l - r * d) / ds;
      int t = l - r * d - j * ds;
      for (int q = threadIdx.x; q < nvec; q += kThreads) {
        float v[4];
        int rr = r, jj = j, tt = t;
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          v[e] = value(rr, jj, tt);
          if (++tt == ds) {
            tt = 0;
            if (++jj == m) { jj = 0; ++rr; }
          }
        }
        *reinterpret_cast<float4*>(o + head + 4 * q) = make_float4(v[0], v[1], v[2], v[3]);
        t += step_t;
        j += step_j;
        r += step_r;
        if (t >= ds) { t -= ds; ++j; }
        if (j >= m) { j -= m; ++r; }
      }
    }
    __syncthreads();  // every read of this tile's codes is done
  }
}

// Tables too large for one block's shared memory (f32 at d=300, k=256: 307
// KB) but whose subquantizers fit a few at a time: a block stages the table of
// `group` consecutive subquantizers (and a map of its columns: where each
// column's entries start in that table, and its subquantizer) once, and walks
// the items (row tile, that group), the grid a multiple of the groups so that
// a block's group never changes and the groups of one tile run side by side
// (its codes are read from memory once).  An item's output is `rows` runs of
// the group's width at the row stride d: neighbouring threads write
// neighbouring floats, carrying (row, column) from step to step.
template <typename CodeT, bool PACKED, bool INT8>
__global__ void __launch_bounds__(kThreads)
decode_group_kernel(const CodeT* __restrict__ codes, const void* __restrict__ table_g,
                    const float* __restrict__ scale_g, float* __restrict__ out, long long n, int m,
                    int k, int ds, int rows_per_tile, int group) {
  using W = typename std::conditional<INT8, signed char, float>::type;
  extern __shared__ __align__(16) unsigned char smem[];
  const int d = m * ds;
  const int row_bytes = PACKED ? (m >> 1) : m * (int)sizeof(CodeT);
  const int groups = (m + group - 1) / group;
  const int j0 = (int)(blockIdx.x % groups) * group;
  const int width = (min(m, j0 + group) - j0) * ds;
  int* col_off = reinterpret_cast<int*>(smem);
  int* col_j = col_off + width;
  float* scale = reinterpret_cast<float*>(col_j + width);
  unsigned char* p = smem + align16(4LL * width * (INT8 ? 3 : 2));
  const int slice_bytes = width * k * (int)sizeof(W);
  stage(p, static_cast<const unsigned char*>(table_g) + (long long)j0 * k * ds * sizeof(W),
        slice_bytes);
  const W* table = reinterpret_cast<const W*>(p);
  unsigned char* tile_codes = p + align16(slice_bytes);
  for (int c = threadIdx.x; c < width; c += kThreads) {
    const int jl = c / ds;
    col_off[c] = jl * k * ds + (c - jl * ds);
    col_j[c] = j0 + jl;
    if constexpr (INT8) scale[c] = scale_g[j0 * ds + c];
  }

  const int step_r = kThreads / width, step_c = kThreads - step_r * width;
  const long long items = (n + rows_per_tile - 1) / rows_per_tile * groups;
  for (long long item = blockIdx.x; item < items; item += gridDim.x) {
    const long long row0 = item / groups * rows_per_tile;
    const int rows = (int)min((long long)rows_per_tile, n - row0);
    stage(tile_codes, reinterpret_cast<const unsigned char*>(codes) + row0 * row_bytes,
          rows * row_bytes);
    __syncthreads();  // the codes (and, the first time, the table and the map) are in
    float* o = out + row0 * d + j0 * ds;
    const int count = rows * width;
    int r = (int)threadIdx.x / width, c = (int)threadIdx.x - r * width;
    for (int l = threadIdx.x; l < count; l += kThreads) {
      const int j = col_j[c];
      unsigned int code;
      if constexpr (PACKED) {
        const unsigned int b = tile_codes[r * row_bytes + (j >> 1)];
        code = (j & 1) ? (b >> 4) : (b & 0xFu);
      } else {
        code = (unsigned int)reinterpret_cast<const CodeT*>(tile_codes)[r * m + j];
      }
      float v = 0.0f;
      if (code < (unsigned int)k) {
        const int idx = col_off[c] + (int)code * ds;
        if constexpr (INT8) v = __fmul_rn((float)table[idx], scale[c]);
        else v = table[idx];
      }
      o[r * d + c] = v;
      r += step_r;
      c += step_c;
      if (c >= width) { c -= width; ++r; }
    }
    __syncthreads();  // every read of this item's codes is done
  }
}

// Blocks: as many as the card holds at once (each stages its table once),
// fewer where there is less work; a multiple of `groups`.
template <typename Kernel>
cudaError_t blocks_for(Kernel kern, int bytes, long long items, int groups, unsigned* blocks) {
  cudaError_t err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return err;
  int dev = 0, sms = 0, per_sm = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return err;
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess)
    return err;
  if ((err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kern, kThreads, bytes)) != cudaSuccess)
    return err;
  long long b = (long long)sms * (per_sm < 1 ? 1 : per_sm);
  b = b < items ? b : items;
  b = b / groups * groups;
  *blocks = (unsigned)(b < groups ? groups : b);
  return cudaSuccess;
}

template <typename CodeT, bool PACKED, bool INT8>
cudaError_t launch_tiles(const void* codes, const void* table, const float* scale, float* out,
                         long long n, int m, int k, int ds, int rows, int group, cudaStream_t s) {
  const int row_bytes = PACKED ? m / 2 : m * (int)sizeof(CodeT);
  const int bytes = (int)tile_smem(INT8, group, m, k, ds, row_bytes, rows);
  const long long tiles = (n + rows - 1) / rows;
  unsigned blocks = 0;
  cudaError_t err;
  if (group > 0 && group < m) {
    const int groups = (m + group - 1) / group;
    auto kern = decode_group_kernel<CodeT, PACKED, INT8>;
    if ((err = blocks_for(kern, bytes, tiles * groups, groups, &blocks)) != cudaSuccess) return err;
    kern<<<blocks, kThreads, bytes, s>>>((const CodeT*)codes, table, scale, out, n, m, k, ds, rows,
                                         group);
  } else if (group > 0) {
    auto kern = decode_tile_kernel<CodeT, PACKED, INT8, true>;
    if ((err = blocks_for(kern, bytes, tiles, 1, &blocks)) != cudaSuccess) return err;
    kern<<<blocks, kThreads, bytes, s>>>((const CodeT*)codes, table, scale, out, n, m, k, ds, rows);
  } else {
    auto kern = decode_tile_kernel<CodeT, PACKED, INT8, false>;
    if ((err = blocks_for(kern, bytes, tiles, 1, &blocks)) != cudaSuccess) return err;
    kern<<<blocks, kThreads, bytes, s>>>((const CodeT*)codes, table, scale, out, n, m, k, ds, rows);
  }
  return cudaGetLastError();
}

template <bool INT8>
int decode_tiles(const void* codes, int code_bytes, int packed, const void* table,
                 const float* scale, float* out, long long n, int m, int k, int ds, int rows,
                 int group, cudaStream_t s) {
  const int row_bytes = packed ? m / 2 : m * code_bytes;
  if (rows < 1 || group < 0 || (long long)rows * m * ds > 0x3fffffffLL ||
      tile_smem(INT8, group, m, k, ds, row_bytes, rows) > 232448)
    return -1;
  cudaError_t err;
  if (packed)
    err = launch_tiles<uint8_t, true, INT8>(codes, table, scale, out, n, m, k, ds, rows, group, s);
  else if (code_bytes == 1)
    err = launch_tiles<uint8_t, false, INT8>(codes, table, scale, out, n, m, k, ds, rows, group, s);
  else
    err = launch_tiles<int32_t, false, INT8>(codes, table, scale, out, n, m, k, ds, rows, group, s);
  return (int)err;
}

unsigned grid_for(long long total4) {
  long long blocks = (total4 + kThreads - 1) / kThreads;
  const long long cap = 1LL << 20;  // the loop in the kernel takes the rest
  return (unsigned)(blocks < cap ? blocks : cap);
}

bool shape_ok(int code_bytes, int packed, int m, int k, int ds) {
  if (ds <= 0 || m <= 0 || k <= 0) return false;
  if ((long long)m * k * ds > 0x7fffffffLL) return false;  // table offsets are 32-bit
  if (packed) return code_bytes == 1 && m % 2 == 0 && k <= 16;
  return code_bytes == 1 || code_bytes == 4;
}

}  // namespace

// The table of one call from the f32 codebook cb (m, k, ds): with splits 1, 2
// or 3 the effective codebook into `table` (m, k, ds) f32; with splits 0 the
// int8 quantizer into `w8` (m, k, ds) int8 and `scale` (m*ds) f32.  One launch.
extern "C" int rt_decode_prepare(const void* cb, int splits, void* table, void* w8, void* scale,
                                 int m, int k, int ds, void* stream) {
  if (m <= 0 || k <= 0 || ds <= 0 || splits < 0 || splits > 3) return -1;
  cudaStream_t s = (cudaStream_t)stream;
  if (splits == 0) {
    const dim3 grid((unsigned)((ds + 31) / 32), (unsigned)m);
    int8_table_kernel<<<grid, kThreads, 0, s>>>((const float*)cb, (signed char*)w8, (float*)scale, k, ds);
  } else {
    const long long total = (long long)m * k * ds;
    effective_table_kernel<<<grid_for(total), kThreads, 0, s>>>((const float*)cb, (float*)table, total,
                                                                splits);
  }
  return (int)cudaGetLastError();
}

// codes (n, m) uint8 (code_bytes 1) or int32 (code_bytes 4), or with packed
// != 0 (n, m/2) bytes of two u4 codes each (m even, k <= 16); cb (m, k, ds)
// f32, the table rt_decode_prepare built; out (n, m*ds) f32.  ds a multiple
// of 4 takes 16 bytes a thread along d and an `out` on 16 bytes; any other ds
// the row-tile kernels, `rows` rows a tile and the table staged `group`
// subquantizers a block (m: the whole table; 0: none, read from L2;
// ops/decode.py::decode_tile_plan chooses both), any `out` on 4 bytes.  Returns cudaGetLastError(); -1 for a shape it does not take.
extern "C" int rt_decode(const void* codes, int code_bytes, int packed, const void* cb, void* out,
                         long long n, int m, int k, int ds, int rows, int group, void* stream) {
  if (n <= 0) return 0;
  if (!shape_ok(code_bytes, packed, m, k, ds)) return -1;
  cudaStream_t s = (cudaStream_t)stream;
  if (ds % 4 != 0)
    return decode_tiles<false>(codes, code_bytes, packed, cb, nullptr, (float*)out, n, m, k, ds,
                               rows, group, s);
  if ((uintptr_t)out & 15u) return -1;
  const long long total4 = n * m * (ds / 4);
  if (packed)
    decode_kernel<uint8_t, true><<<grid_for(total4), kThreads, 0, s>>>(
        (const uint8_t*)codes, (const float4*)cb, (float4*)out, total4, m, k, ds / 4);
  else if (code_bytes == 1)
    decode_kernel<uint8_t, false><<<grid_for(total4), kThreads, 0, s>>>(
        (const uint8_t*)codes, (const float4*)cb, (float4*)out, total4, m, k, ds / 4);
  else
    decode_kernel<int32_t, false><<<grid_for(total4), kThreads, 0, s>>>(
        (const int32_t*)codes, (const float4*)cb, (float4*)out, total4, m, k, ds / 4);
  return (int)cudaGetLastError();
}

// As rt_decode with w (m, k, ds) int8 and scale (m*ds) f32:
// out = float(w[j, code, t]) * scale[j*ds + t].
extern "C" int rt_decode_int8(const void* codes, int code_bytes, int packed, const void* w,
                              const void* scale, void* out, long long n, int m, int k, int ds,
                              int rows, int group, void* stream) {
  if (n <= 0) return 0;
  if (!shape_ok(code_bytes, packed, m, k, ds)) return -1;
  cudaStream_t s = (cudaStream_t)stream;
  if (ds % 4 != 0)
    return decode_tiles<true>(codes, code_bytes, packed, w, (const float*)scale, (float*)out, n, m,
                              k, ds, rows, group, s);
  if ((uintptr_t)out & 15u) return -1;
  const long long total4 = n * m * (ds / 4);
  if (packed)
    decode_int8_kernel<uint8_t, true><<<grid_for(total4), kThreads, 0, s>>>(
        (const uint8_t*)codes, (const char4*)w, (const float4*)scale, (float4*)out, total4, m, k, ds / 4);
  else if (code_bytes == 1)
    decode_int8_kernel<uint8_t, false><<<grid_for(total4), kThreads, 0, s>>>(
        (const uint8_t*)codes, (const char4*)w, (const float4*)scale, (float4*)out, total4, m, k, ds / 4);
  else
    decode_int8_kernel<int32_t, false><<<grid_for(total4), kThreads, 0, s>>>(
        (const int32_t*)codes, (const char4*)w, (const float4*)scale, (float4*)out, total4, m, k, ds / 4);
  return (int)cudaGetLastError();
}
