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
// at random addresses.  Design: a block holds the tables of QT queries in
// shared memory, laid out [j][c][q] so that one thread reads the QT entries
// of its code with vector loads; a thread takes one database row at a time,
// reads its codes four at a time where it can, keeps QT sums in registers
// and writes them coalesced along n.  The grid's y axis tiles the queries, so
// any nq is taken in one launch; blocks walk the rows with a stride, so the
// cost of filling the tables is spread over many rows.
//
// Packed u4 codes (the packed=True variant of the same TPU kernels): a row is
// m/2 bytes and the thread takes both nibbles of each byte, low then high, so
// the sum keeps the order j = 0..m-1 and is bit-equal to the unpacked kernel's.
// The tables stay in natural order.  With k <= 16 the tables are small
// (m*k*QT entries) and the code bytes read fall to n*m/2.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

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
// out (nq, n) f32.  qt in {8, 4, 2, 1} queries share a block; the caller picks
// it so that qt*m*k*4 bytes fit in shared memory, and picks row_blocks.
// Returns cudaGetLastError() (or the error of the shared-memory opt-in).
extern "C" int rt_adc(const void* tables, const void* codes, int code_bytes, int packed,
                      void* out, long long n, int nq, int m, int k, int qt, int row_blocks,
                      void* stream) {
  if (n == 0) return 0;
  if (!shape_ok(n, nq, m, k, code_bytes, packed, qt, row_blocks)) return -1;
  return (int)launch_qt<float, float>(tables, codes, code_bytes, packed, out, nullptr, nullptr, n,
                                      nq, m, k, qt, row_blocks, (cudaStream_t)stream);
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
