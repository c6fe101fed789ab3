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
// of codes read; there is no arithmetic.  Design: one thread writes 16 bytes
// along d (neighbouring threads on neighbouring addresses); the table (128 KB
// at m=16, k=256, ds=8; 768 KB at m=24, k=256, ds=32) is read through the
// read-only cache and stays in L2, which takes any size of table without
// tiling by subquantizer.  A code that is not below k selects nothing and the
// element is 0, as a multihot row without a match gives.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

template <typename CodeT>
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
    const unsigned long long code = (unsigned long long)codes[row * m + j];
    float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
    if (code < (unsigned long long)k) v = __ldg(cb4 + ((long long)j * k + (long long)code) * ds4 + t4);
    out4[idx] = v;
  }
}

template <typename CodeT>
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
    const unsigned long long code = (unsigned long long)codes[row * m + j];
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

unsigned grid_for(long long total4) {
  long long blocks = (total4 + kThreads - 1) / kThreads;
  const long long cap = 1LL << 20;  // the loop in the kernel takes the rest
  return (unsigned)(blocks < cap ? blocks : cap);
}

}  // namespace

// codes (n, m) uint8 (code_bytes 1) or int32 (code_bytes 4), cb (m, k, ds)
// f32, out (n, m*ds) f32; ds a multiple of 4.  Returns cudaGetLastError().
extern "C" int rt_decode(const void* codes, int code_bytes, const void* cb, void* out,
                         long long n, int m, int k, int ds, void* stream) {
  if (n <= 0) return 0;
  if (ds <= 0 || ds % 4 != 0 || m <= 0 || k <= 0) return -1;
  const long long total4 = n * m * (ds / 4);
  cudaStream_t s = (cudaStream_t)stream;
  if (code_bytes == 1)
    decode_kernel<uint8_t><<<grid_for(total4), kThreads, 0, s>>>(
        (const uint8_t*)codes, (const float4*)cb, (float4*)out, total4, m, k, ds / 4);
  else if (code_bytes == 4)
    decode_kernel<int32_t><<<grid_for(total4), kThreads, 0, s>>>(
        (const int32_t*)codes, (const float4*)cb, (float4*)out, total4, m, k, ds / 4);
  else
    return -1;
  return (int)cudaGetLastError();
}

// As rt_decode with w (m, k, ds) int8 and scale (m*ds) f32:
// out = float(w[j, code, t]) * scale[j*ds + t].
extern "C" int rt_decode_int8(const void* codes, int code_bytes, const void* w,
                              const void* scale, void* out, long long n, int m, int k,
                              int ds, void* stream) {
  if (n <= 0) return 0;
  if (ds <= 0 || ds % 4 != 0 || m <= 0 || k <= 0) return -1;
  const long long total4 = n * m * (ds / 4);
  cudaStream_t s = (cudaStream_t)stream;
  if (code_bytes == 1)
    decode_int8_kernel<uint8_t><<<grid_for(total4), kThreads, 0, s>>>(
        (const uint8_t*)codes, (const char4*)w, (const float4*)scale, (float4*)out, total4, m, k, ds / 4);
  else if (code_bytes == 4)
    decode_int8_kernel<int32_t><<<grid_for(total4), kThreads, 0, s>>>(
        (const int32_t*)codes, (const char4*)w, (const float4*)scale, (float4*)out, total4, m, k, ds / 4);
  else
    return -1;
  return (int)cudaGetLastError();
}
