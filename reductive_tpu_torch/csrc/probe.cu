// A probe of the tensor cores' accumulation in the TF32 instructions of the
// 3xTF32 assignment routes: wgmma.m64n64k8.f32.tf32.tf32 (csrc/assign_tile.cuh,
// csrc/assign_wide.cuh's shallow kernel) and wgmma.m64n128k8.f32.tf32.tf32 with
// A from registers and B in the 128-byte swizzled layout TMA writes
// (csrc/assign_deep.cuh).  ops/assign.py bounds their error on the assumption
// that one instruction aligns its nine addends (eight exact products and the
// accumulator) to the largest exponent, keeps at least 24 bits of each and
// truncates.  Each block runs one instruction, D = C + A . B^T with A (64 x 8),
// B (N x 8) and C (64 x N) as given; reductive_tpu_torch/ops/probe.py builds
// the cases (addends placed to count the kept bits and to tell truncation from
// rounding, and random ones) and reads the results.  Not a kernel of any path.

#include <cuda_runtime.h>
#include <stdint.h>

#include "assign_deep.cuh"
#include "assign_tile.cuh"

namespace {

template <int N>
__global__ void __launch_bounds__(128)
probe_wgmma_tf32_kernel(const float* __restrict__ A, const float* __restrict__ B,
                        const float* __restrict__ C, float* __restrict__ D) {
  // N = 64: B in the no-swizzle layout of assign_tile::stage_centroids for one
  // depth step.  N = 128: B as TMA writes a box of 32 f32 a row with the
  // 128-byte swizzle (columns 0 .. 7 used), as the deep kernel reads it.
  __shared__ __align__(1024) uint32_t s_b[N == 64 ? 64 * 8 : 128 * 32];
  const float* a_in = A + (long long)blockIdx.x * 64 * 8;
  const float* b_in = B + (long long)blockIdx.x * N * 8;
  const float* c_in = C + (long long)blockIdx.x * 64 * N;
  float* d_out = D + (long long)blockIdx.x * 64 * N;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int g = lane >> 2;
  const int t = lane & 3;
  for (int e = threadIdx.x; e < N * 8; e += 128) {
    const int c = e >> 3;
    const int kk = e & 7;
    if constexpr (N == 64)
      s_b[(c >> 3) * 64 + ((kk >> 2) & 1) * 32 + (c & 7) * 4 + (kk & 3)] = __float_as_uint(b_in[e]);
    else
      s_b[assign_deep::swizzled(c, kk) / 4] = __float_as_uint(b_in[e]);
  }
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  __syncthreads();
  uint32_t a[4];
#pragma unroll
  for (int i = 0; i < 4; ++i)  // row 16 warp + g + 8 (i % 2), column t + 4 (i / 2)
    a[i] = __float_as_uint(a_in[(16 * warp + g + 8 * (i & 1)) * 8 + t + 4 * (i >> 1)]);
  const int r0 = 16 * warp + g;
  float d[N / 2];
#pragma unroll
  for (int i = 0; i < N / 8; ++i) {
    d[4 * i + 0] = c_in[r0 * N + 8 * i + 2 * t];
    d[4 * i + 1] = c_in[r0 * N + 8 * i + 2 * t + 1];
    d[4 * i + 2] = c_in[(r0 + 8) * N + 8 * i + 2 * t];
    d[4 * i + 3] = c_in[(r0 + 8) * N + 8 * i + 2 * t + 1];
  }
  assign_tile::wgmma_fence();
  if constexpr (N == 64)
    assign_tile::wgmma_m64n64k8_tf32(d, a, assign_tile::b_descriptor(s_b, 0), 1);
  else
    assign_deep::mma_tf32_n128(d, a, assign_deep::sw128_descriptor(
                                         reinterpret_cast<const unsigned char*>(s_b)), 1);
  assign_tile::wgmma_commit();
  assign_tile::wgmma_wait<0>();
  assign_tile::pin(d);
#pragma unroll
  for (int i = 0; i < N / 8; ++i) {
    d_out[r0 * N + 8 * i + 2 * t] = d[4 * i + 0];
    d_out[r0 * N + 8 * i + 2 * t + 1] = d[4 * i + 1];
    d_out[(r0 + 8) * N + 8 * i + 2 * t] = d[4 * i + 2];
    d_out[(r0 + 8) * N + 8 * i + 2 * t + 1] = d[4 * i + 3];
  }
}

}  // namespace

// A (cases, 64, 8), B (cases, n, 8) f32 holding TF32 values; C, D (cases, 64,
// n) f32; n is 64 or 128, the instruction's N.  Returns cudaGetLastError()
// after the launch; -1 for what it does not take.
extern "C" int rt_probe_wgmma_tf32(const void* A, const void* B, const void* C, void* D, int cases,
                                   int n, void* stream) {
  if (cases <= 0 || (n != 64 && n != 128)) return -1;
  if (n == 64)
    probe_wgmma_tf32_kernel<64><<<cases, 128, 0, (cudaStream_t)stream>>>(
        (const float*)A, (const float*)B, (const float*)C, (float*)D);
  else
    probe_wgmma_tf32_kernel<128><<<cases, 128, 0, (cudaStream_t)stream>>>(
        (const float*)A, (const float*)B, (const float*)C, (float*)D);
  return (int)cudaGetLastError();
}
