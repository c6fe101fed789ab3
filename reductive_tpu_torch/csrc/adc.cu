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

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 1024;

template <typename TabT, typename AccT, int QT, typename CodeT, bool VEC4>
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

  const long long stride = (long long)gridDim.x * kThreads;
  for (long long row = (long long)blockIdx.x * kThreads + threadIdx.x; row < n; row += stride) {
    AccT acc[QT];
#pragma unroll
    for (int q = 0; q < QT; ++q) acc[q] = (AccT)0;
    const CodeT* cr = codes + row * m;
    if constexpr (VEC4) {
      // CodeT is uint8_t, m % 4 == 0 and the base is 4-byte aligned.
      const uint32_t* cw = reinterpret_cast<const uint32_t*>(cr);
      for (int j4 = 0; j4 < m / 4; ++j4) {
        const uint32_t w = cw[j4];
#pragma unroll
        for (int b = 0; b < 4; ++b) {
          const int c = (w >> (8 * b)) & 0xff;
          if (c < k) {
            const TabT* p = s_t + ((j4 * 4 + b) * k + c) * QT;
#pragma unroll
            for (int q = 0; q < QT; ++q) acc[q] += (AccT)p[q];
          }
        }
      }
    } else {
      for (int j = 0; j < m; ++j) {
        const unsigned long long c = (unsigned long long)cr[j];
        if (c < (unsigned long long)k) {
          const TabT* p = s_t + (j * k + (int)c) * QT;
#pragma unroll
          for (int q = 0; q < QT; ++q) acc[q] += (AccT)p[q];
        }
      }
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

template <typename TabT, typename AccT, int QT, typename CodeT, bool VEC4>
cudaError_t launch_one(const void* tables, const void* codes, void* out, const void* scale,
                       const void* offset, long long n, int nq, int m, int k,
                       int row_blocks, cudaStream_t stream) {
  auto kern = adc_kernel<TabT, AccT, QT, CodeT, VEC4>;
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
cudaError_t launch_codes(const void* tables, const void* codes, int code_bytes, void* out,
                         const void* scale, const void* offset, long long n, int nq, int m,
                         int k, int row_blocks, cudaStream_t stream) {
  if (code_bytes == 1) {
    if (m % 4 == 0 && ((uintptr_t)codes & 3) == 0)
      return launch_one<TabT, AccT, QT, uint8_t, true>(tables, codes, out, scale, offset, n, nq, m, k, row_blocks, stream);
    return launch_one<TabT, AccT, QT, uint8_t, false>(tables, codes, out, scale, offset, n, nq, m, k, row_blocks, stream);
  }
  return launch_one<TabT, AccT, QT, int32_t, false>(tables, codes, out, scale, offset, n, nq, m, k, row_blocks, stream);
}

template <typename TabT, typename AccT>
cudaError_t launch_qt(const void* tables, const void* codes, int code_bytes, void* out,
                      const void* scale, const void* offset, long long n, int nq, int m, int k,
                      int qt, int row_blocks, cudaStream_t stream) {
  switch (qt) {
    case 8: return launch_codes<TabT, AccT, 8>(tables, codes, code_bytes, out, scale, offset, n, nq, m, k, row_blocks, stream);
    case 4: return launch_codes<TabT, AccT, 4>(tables, codes, code_bytes, out, scale, offset, n, nq, m, k, row_blocks, stream);
    case 2: return launch_codes<TabT, AccT, 2>(tables, codes, code_bytes, out, scale, offset, n, nq, m, k, row_blocks, stream);
    case 1: return launch_codes<TabT, AccT, 1>(tables, codes, code_bytes, out, scale, offset, n, nq, m, k, row_blocks, stream);
    default: return cudaErrorInvalidValue;
  }
}

bool shape_ok(long long n, int nq, int m, int k, int code_bytes, int qt, int row_blocks) {
  return nq > 0 && m > 0 && k > 0 && (code_bytes == 1 || code_bytes == 4) && row_blocks > 0 &&
         (long long)(nq + qt - 1) / qt <= 65535 && n >= 0;
}

}  // namespace

// tables (nq, m, k) f32, codes (n, m) uint8 (code_bytes 1) or int32 (4),
// out (nq, n) f32.  qt in {8, 4, 2, 1} queries share a block; the caller picks
// it so that qt*m*k*4 bytes fit in shared memory, and picks row_blocks.
// Returns cudaGetLastError() (or the error of the shared-memory opt-in).
extern "C" int rt_adc(const void* tables, const void* codes, int code_bytes, void* out,
                      long long n, int nq, int m, int k, int qt, int row_blocks, void* stream) {
  if (n == 0) return 0;
  if (!shape_ok(n, nq, m, k, code_bytes, qt, row_blocks)) return -1;
  return (int)launch_qt<float, float>(tables, codes, code_bytes, out, nullptr, nullptr, n, nq, m,
                                      k, qt, row_blocks, (cudaStream_t)stream);
}

// As rt_adc with int8 tables and an int32 sum:
// out[q, i] = float(sum) * scale[q] + offset[q], rounded after each step.
extern "C" int rt_adc_int8(const void* tables, const void* scale, const void* offset,
                           const void* codes, int code_bytes, void* out, long long n, int nq,
                           int m, int k, int qt, int row_blocks, void* stream) {
  if (n == 0) return 0;
  if (!shape_ok(n, nq, m, k, code_bytes, qt, row_blocks) || scale == nullptr || offset == nullptr)
    return -1;
  return (int)launch_qt<int8_t, int32_t>(tables, codes, code_bytes, out, scale, offset, n, nq, m,
                                         k, qt, row_blocks, (cudaStream_t)stream);
}
