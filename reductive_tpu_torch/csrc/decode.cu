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
// of codes read; there is no arithmetic.  Design: where ds is a multiple of 4,
// one thread writes 16 bytes along d (neighbouring threads on neighbouring
// addresses); at any other ds (2 at the reference's d = 20, m = 10) a row of
// the table is not 16-byte aligned and one thread writes one value (the
// *_scalar kernels), still neighbouring threads on neighbouring addresses; the table (128 KB
// at m=16, k=256, ds=8; 768 KB at m=24, k=256, ds=32) is read through the
// read-only cache and stays in L2, which takes any size of table without
// tiling by subquantizer.  A code that is not below k selects nothing and the
// element is 0, as a multihot row without a match gives.
//
// Packed u4 codes (the packed=True variants of the same TPU kernels, wired
// through lane_multihot_packed there): a row is m/2 bytes, byte j/2 holds code
// j in its low nibble for even j and in its high nibble for odd j.  The thread
// reads its byte and takes its nibble; the table stays in natural order (the
// TPU kernels permute its row blocks to suit their multihot, which has no
// meaning for a gather).  The bytes read fall to n*m/2.

#include <cuda_runtime.h>
#include <stdint.h>

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

// Any ds (the rows of a table are then not 16-byte aligned): one thread per
// output element, neighbouring threads on neighbouring addresses.
template <typename CodeT, bool PACKED>
__global__ void __launch_bounds__(kThreads)
decode_scalar_kernel(const CodeT* __restrict__ codes, const float* __restrict__ cb,
                     float* __restrict__ out, long long total, int m, int k, int ds) {
  const long long d = (long long)m * ds;
  const long long stride = (long long)gridDim.x * kThreads;
  for (long long idx = (long long)blockIdx.x * kThreads + threadIdx.x; idx < total; idx += stride) {
    const long long row = idx / d;
    const int c = (int)(idx - row * d);
    const int j = c / ds;
    const unsigned long long code = code_at<CodeT, PACKED>(codes, row, m, j);
    out[idx] = code < (unsigned long long)k ? __ldg(cb + ((long long)j * k + (long long)code) * ds + (c - j * ds)) : 0.0f;
  }
}

template <typename CodeT, bool PACKED>
__global__ void __launch_bounds__(kThreads)
decode_int8_scalar_kernel(const CodeT* __restrict__ codes, const signed char* __restrict__ w,
                          const float* __restrict__ scale, float* __restrict__ out, long long total,
                          int m, int k, int ds) {
  const long long d = (long long)m * ds;
  const long long stride = (long long)gridDim.x * kThreads;
  for (long long idx = (long long)blockIdx.x * kThreads + threadIdx.x; idx < total; idx += stride) {
    const long long row = idx / d;
    const int c = (int)(idx - row * d);
    const int j = c / ds;
    const unsigned long long code = code_at<CodeT, PACKED>(codes, row, m, j);
    float v = 0.0f;
    if (code < (unsigned long long)k)
      v = __fmul_rn((float)__ldg(w + ((long long)j * k + (long long)code) * ds + (c - j * ds)),
                    __ldg(scale + c));
    out[idx] = v;
  }
}

unsigned grid_for(long long total4) {
  long long blocks = (total4 + kThreads - 1) / kThreads;
  const long long cap = 1LL << 20;  // the loop in the kernel takes the rest
  return (unsigned)(blocks < cap ? blocks : cap);
}

bool shape_ok(int code_bytes, int packed, int m, int k, int ds) {
  if (ds <= 0 || m <= 0 || k <= 0) return false;
  if (packed) return code_bytes == 1 && m % 2 == 0 && k <= 16;
  return code_bytes == 1 || code_bytes == 4;
}

}  // namespace

// codes (n, m) uint8 (code_bytes 1) or int32 (code_bytes 4), or with packed
// != 0 (n, m/2) bytes of two u4 codes each (m even, k <= 16); cb (m, k, ds)
// f32, out (n, m*ds) f32; any ds (a multiple of 4 takes 16 bytes a thread,
// any other one value a thread).  Returns cudaGetLastError();
// -1 for a shape it does not take.
extern "C" int rt_decode(const void* codes, int code_bytes, int packed, const void* cb, void* out,
                         long long n, int m, int k, int ds, void* stream) {
  if (n <= 0) return 0;
  if (!shape_ok(code_bytes, packed, m, k, ds)) return -1;
  cudaStream_t s = (cudaStream_t)stream;
  if (ds % 4 != 0) {
    const long long total = n * m * ds;
    const float* cbf = (const float*)cb;
    float* o = (float*)out;
    if (packed)
      decode_scalar_kernel<uint8_t, true><<<grid_for(total), kThreads, 0, s>>>(
          (const uint8_t*)codes, cbf, o, total, m, k, ds);
    else if (code_bytes == 1)
      decode_scalar_kernel<uint8_t, false><<<grid_for(total), kThreads, 0, s>>>(
          (const uint8_t*)codes, cbf, o, total, m, k, ds);
    else
      decode_scalar_kernel<int32_t, false><<<grid_for(total), kThreads, 0, s>>>(
          (const int32_t*)codes, cbf, o, total, m, k, ds);
    return (int)cudaGetLastError();
  }
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
                              const void* scale, void* out, long long n, int m, int k,
                              int ds, void* stream) {
  if (n <= 0) return 0;
  if (!shape_ok(code_bytes, packed, m, k, ds)) return -1;
  cudaStream_t s = (cudaStream_t)stream;
  if (ds % 4 != 0) {
    const long long total = n * m * ds;
    const signed char* wc = (const signed char*)w;
    const float* sc = (const float*)scale;
    float* o = (float*)out;
    if (packed)
      decode_int8_scalar_kernel<uint8_t, true><<<grid_for(total), kThreads, 0, s>>>(
          (const uint8_t*)codes, wc, sc, o, total, m, k, ds);
    else if (code_bytes == 1)
      decode_int8_scalar_kernel<uint8_t, false><<<grid_for(total), kThreads, 0, s>>>(
          (const uint8_t*)codes, wc, sc, o, total, m, k, ds);
    else
      decode_int8_scalar_kernel<int32_t, false><<<grid_for(total), kThreads, 0, s>>>(
          (const int32_t*)codes, wc, sc, o, total, m, k, ds);
    return (int)cudaGetLastError();
  }
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
