// A probe of the tensor cores' accumulation in wgmma.m64n64k8.f32.tf32.tf32,
// the instruction of the 3xTF32 assignment routes (csrc/assign_tile.cuh,
// csrc/assign_wide.cuh).  ops/assign.py bounds their error on the assumption
// that one instruction aligns its nine addends (eight exact products and the
// accumulator) to the largest exponent, keeps at least 24 bits of each and
// truncates.  Each block runs one instruction, D = C + A . B^T with A (64 x 8),
// B (64 x 8) and C (64 x 64) as given; reductive_tpu_torch/ops/probe.py builds
// the cases (addends placed to count the kept bits and to tell truncation from
// rounding, and random ones) and reads the results.  Not a kernel of any path.

#include <cuda_runtime.h>
#include <stdint.h>

#include "assign_tile.cuh"

namespace {

__global__ void __launch_bounds__(128)
probe_wgmma_tf32_kernel(const float* __restrict__ A, const float* __restrict__ B,
                        const float* __restrict__ C, float* __restrict__ D) {
  __shared__ __align__(16) uint32_t s_b[64 * 8];
  const float* a_in = A + (long long)blockIdx.x * 64 * 8;
  const float* b_in = B + (long long)blockIdx.x * 64 * 8;
  const float* c_in = C + (long long)blockIdx.x * 64 * 64;
  float* d_out = D + (long long)blockIdx.x * 64 * 64;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int g = lane >> 2;
  const int t = lane & 3;
  // B in the layout of assign_tile::stage_centroids for one depth step.
  for (int e = threadIdx.x; e < 64 * 8; e += 128) {
    const int c = e >> 3;
    const int kk = e & 7;
    s_b[(c >> 3) * 64 + ((kk >> 2) & 1) * 32 + (c & 7) * 4 + (kk & 3)] = __float_as_uint(b_in[e]);
  }
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  __syncthreads();
  uint32_t a[4];
#pragma unroll
  for (int i = 0; i < 4; ++i)  // row 16 warp + g + 8 (i % 2), column t + 4 (i / 2)
    a[i] = __float_as_uint(a_in[(16 * warp + g + 8 * (i & 1)) * 8 + t + 4 * (i >> 1)]);
  const int r0 = 16 * warp + g;
  float d[32];
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    d[4 * i + 0] = c_in[r0 * 64 + 8 * i + 2 * t];
    d[4 * i + 1] = c_in[r0 * 64 + 8 * i + 2 * t + 1];
    d[4 * i + 2] = c_in[(r0 + 8) * 64 + 8 * i + 2 * t];
    d[4 * i + 3] = c_in[(r0 + 8) * 64 + 8 * i + 2 * t + 1];
  }
  assign_tile::wgmma_fence();
  assign_tile::wgmma_m64n64k8_tf32(d, a, assign_tile::b_descriptor(s_b, 0), 1);
  assign_tile::wgmma_commit();
  assign_tile::wgmma_wait<0>();
  assign_tile::pin(d);
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    d_out[r0 * 64 + 8 * i + 2 * t] = d[4 * i + 0];
    d_out[r0 * 64 + 8 * i + 2 * t + 1] = d[4 * i + 1];
    d_out[(r0 + 8) * 64 + 8 * i + 2 * t] = d[4 * i + 2];
    d_out[(r0 + 8) * 64 + 8 * i + 2 * t + 1] = d[4 * i + 3];
  }
}

}  // namespace

// A, B (cases, 64, 8) f32 holding TF32 values; C, D (cases, 64, 64) f32.
// Returns cudaGetLastError() after the launch.
extern "C" int rt_probe_wgmma_tf32(const void* A, const void* B, const void* C, void* D, int cases,
                                   void* stream) {
  if (cases <= 0) return -1;
  probe_wgmma_tf32_kernel<<<cases, 128, 0, (cudaStream_t)stream>>>(
      (const float*)A, (const float*)B, (const float*)C, (float*)D);
  return (int)cudaGetLastError();
}
