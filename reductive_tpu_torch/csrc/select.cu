// Exact selection of the k smallest entries of each long f32 row, ties by
// position, merged with a prior best-so-far list where one is given.
//
// Replaces no TPU kernel: the JAX package selects with jax.lax.top_k, and the
// port's plain route (reductive_tpu_torch/search.py::_smallest_long) is
// torch.topk plus a repair of the ties at the k-th place, which reads the
// scores several times and launches some twenty kernels a row block.  The
// order is that rule's, exactly: every entry is ranked by a 64-bit key whose
// high 32 bits are its value mapped to an order-preserving unsigned int
// (-0.0 taken as +0.0, every NaN above +inf) and whose low 32 bits are its
// position, or, with a prior list, its global id (offset + column).  The k
// smallest keys are the result, ascending; the original value bits are
// returned (a -0.0 stays -0.0).
//
// What bounds it on an H100: bytes.  One read of the (nq, L) scores, 4*nq*L
// bytes (0.080 ms for 128 x 524,288 at 3.35 TB/s); the lists written and read
// between the passes are nq * slices * kp * 12 bytes, under 1% of that.  The
// design reads the scores once and writes no (nq, L) intermediate:
// * Pass 1 (select_pass_kernel): one block of 256 threads a (row, slice).  A
//   row is cut into 16-byte groups (the first and last may hold fewer columns
//   when the row is off 16 bytes); a slice is a contiguous range of groups.
//   A thread takes one group an iteration, copied by cp.async into a ring of
//   four iterations in shared memory ahead of the one filtered.  The block's
//   threshold is its k-th key so far: an entry whose value is above the
//   threshold's is rejected by one float compare, and one barrier an
//   iteration (__syncthreads_or) tells that no thread holds a candidate.  The
//   candidates are tested by the whole key and appended to a buffer in shared
//   memory (one shared atomic a warp).  When it holds 256 (or kp) keys (an
//   iteration adds at most 1,024 to its 2,048 slots) it is sorted (bitonic)
//   and merged into the sorted best list of kp keys (kp the power of two at
//   or above k): min(best[i], buf[kp-1-i]) is a bitonic sequence of the kp
//   smallest, and one bitonic merge sorts it; the list's k-th key is the new
//   threshold.  Most of the cost beyond the read is that of the candidates
//   before the threshold is tight, so for k <= 256 the first threshold comes
//   from the ring before any entry is filtered: the k-th smallest of the
//   threads' smallest keys over the first four iterations (k threads hold an
//   entry at or below it).  Each block writes its kp keys and their value
//   bits.  This is the filter-and-merge selection of Johnson, Douze and
//   Jegou, "Billion-scale similarity search with GPUs" (2017), with the
//   queues of a block in shared memory.
// * Pass 2 (select_merge_kernel): one block a row merges the prior list (if
//   given; sorted first, so any order is taken) and the slices' sorted lists
//   two at a time by the same bitonic merge, keys and value bits together,
//   and writes the first k.
// Launched on the caller's stream; nothing allocated, nothing waited for.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

typedef unsigned long long Key;

constexpr int kThreads = 256;              // pass 1 and pass 2 blocks
constexpr int kStages = 4;                 // pass-1 iterations in shared memory
constexpr int kPerIter = 4 * kThreads;     // entries a pass-1 block reads an iteration
constexpr int kMaxKp = 1024;
constexpr int kFlushAt = 256;              // candidates that start a merge (kp if more)
// Candidate slots: a merge starts below kMaxKp + kPerIter, and sorts a power of two.
constexpr int kBuf = kMaxKp + kPerIter <= 2048 ? 2048 : kMaxKp + kPerIter <= 4096 ? 4096 : 8192;
constexpr Key kEmpty = ~0ull;              // an empty slot: above every key taken

extern __shared__ __align__(16) unsigned char smem_raw[];

__device__ __forceinline__ uint32_t order_bits(uint32_t u) {
  if ((u & 0x7fffffffu) > 0x7f800000u) return 0xffffffffu;  // every NaN, above +inf
  if (u == 0x80000000u) u = 0u;                              // -0.0 ties with +0.0
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

__device__ __forceinline__ Key make_key(uint32_t bits, uint32_t id) {
  return ((Key)order_bits(bits) << 32) | id;
}

// One compare-exchange stage over a[0, n) in shared memory (pairs stride
// apart, ascending inside blocks of size), by all threads of the block; v, if
// not null, moves with the keys.  Pair i is taken by thread i mod blockDim,
// so at stride <= 32 a warp's pairs lie in 64-element spans that no other
// warp touches and a warp barrier orders the stage: the block synchronises
// after a stage of stride >= 64 and after the last stage (stride 1) of each
// size, and the caller finds the block synchronised.
template <bool PAYLOAD>
__device__ __forceinline__ void cas_stage(Key* a, uint32_t* v, int n, int size, int stride) {
  for (int i = threadIdx.x; i < n / 2; i += blockDim.x) {
    const int lo = 2 * i - (i & (stride - 1));
    const int hi = lo + stride;
    const bool up = (lo & size) == 0;
    const Key x = a[lo], y = a[hi];
    if ((x > y) == up) {
      a[lo] = y;
      a[hi] = x;
      if (PAYLOAD) {
        const uint32_t t = v[lo];
        v[lo] = v[hi];
        v[hi] = t;
      }
    }
  }
  if (stride >= 64 || stride == 1)
    __syncthreads();
  else
    __syncwarp();
}

template <bool PAYLOAD>
__device__ void bitonic_sort(Key* a, uint32_t* v, int n) {
  for (int size = 2; size <= n; size <<= 1)
    for (int stride = size >> 1; stride > 0; stride >>= 1) cas_stage<PAYLOAD>(a, v, n, size, stride);
}

// Sorts a bitonic sequence a[0, n) ascending.
template <bool PAYLOAD>
__device__ void bitonic_merge(Key* a, uint32_t* v, int n) {
  for (int stride = n >> 1; stride > 0; stride >>= 1) cas_stage<PAYLOAD>(a, v, n, 2 * n, stride);
}

// best[0, kp) sorted ascending and in[0, >= kp) sorted ascending: best
// becomes the kp smallest of both, sorted.
template <bool PAYLOAD>
__device__ void merge_into(Key* best, uint32_t* best_v, const Key* in, const uint32_t* in_v,
                           int kp) {
  for (int i = threadIdx.x; i < kp; i += blockDim.x) {
    const Key y = in[kp - 1 - i];
    if (y < best[i]) {
      best[i] = y;
      if (PAYLOAD) best_v[i] = in_v[kp - 1 - i];
    }
  }
  __syncthreads();
  bitonic_merge<PAYLOAD>(best, best_v, kp);
}

__device__ __forceinline__ int pow2_at_least(int x) {
  int p = 1;
  while (p < x) p <<= 1;
  return p;
}

// The cnt candidates of buf sorted and merged into best, the count *fill
// set to 0; returns the new k-th key.  Ends with the block synchronised.
__device__ __noinline__ Key flush(Key* buf, int cnt, int* fill, Key* best, int kp, int k) {
  const int p = max(kp, pow2_at_least(cnt));
  for (int i = cnt + threadIdx.x; i < p; i += blockDim.x) buf[i] = kEmpty;
  __syncthreads();
  if (threadIdx.x == 0) *fill = 0;  // every thread read it before the call
  bitonic_sort<false>(buf, nullptr, p);
  merge_into<false>(best, nullptr, buf, nullptr, kp);
  return best[k - 1];
}

// The f32 value whose order bits are hi (hi below 0xffffffff, not NaN).
__device__ __forceinline__ float value_of(uint32_t hi) {
  return __uint_as_float((hi & 0x80000000u) ? (hi & 0x7fffffffu) : ~hi);
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const uint32_t at = (uint32_t)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(at), "l"(gmem) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__global__ void __launch_bounds__(kThreads, 4)
select_pass_kernel(const float* __restrict__ scores, uint32_t L, int k, int kp, int slices,
                   uint32_t offset, Key* __restrict__ cand_keys,
                   uint32_t* __restrict__ cand_vals) {
  float4* ring = reinterpret_cast<float4*>(smem_raw);  // kStages x kThreads groups
  Key* buf = reinterpret_cast<Key*>(ring + kStages * kThreads);  // kBuf candidates
  Key* best = buf + kBuf;                                // kp keys, ascending
  __shared__ int s_fill;
  const int q = blockIdx.x / slices;
  const int s = blockIdx.x % slices;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const float* row = scores + (unsigned long long)q * L;
  // Group g holds columns 4g - mis .. 4g - mis + 3; groups gf0 .. gf1 - 1 lie
  // whole inside the row (one 16-byte copy each), the others at its ends.
  const uint32_t mis = (uint32_t)((reinterpret_cast<uintptr_t>(row) >> 2) & 3);
  const float4* groups = reinterpret_cast<const float4*>(row - mis);
  const unsigned long long n_groups = ((unsigned long long)L + mis + 3) >> 2;
  const uint32_t g0 = (uint32_t)(n_groups * s / slices);
  const uint32_t g1 = (uint32_t)(n_groups * (s + 1) / slices);
  const uint32_t gf0 = mis > 0 ? 1u : 0u;
  const uint32_t gf1 = (uint32_t)(((unsigned long long)L + mis) >> 2);
  const uint32_t whole_end = min(g1, gf1);
  const uint32_t iters = (g1 - g0 + kThreads - 1) / kThreads;

  for (int i = tid; i < kp; i += kThreads) best[i] = kEmpty;
  if (tid == 0) s_fill = 0;
  __syncthreads();

  // The block's k-th key so far, and its value: an entry above the value is
  // rejected by one float compare, the rest by the whole key.  While the key
  // is empty or NaN every entry is tested by the whole key.
  Key thr = kEmpty;
  float thr_value = 0.f;
  bool exact = true;
  const int flush_at = max(kp, kFlushAt);
  auto set_threshold = [&](Key t) {
    thr = t;
    exact = (uint32_t)(t >> 32) == 0xffffffffu;
    if (!exact) thr_value = value_of((uint32_t)(t >> 32));
  };

  // Iteration it takes group g0 + it kThreads + tid in each thread; its
  // groups are whole and inside the slice for the whole block, or not.
  auto whole = [&](uint32_t it) {
    const uint32_t first = g0 + it * kThreads;
    return first >= gf0 && first + kThreads <= whole_end;
  };
  // A whole iteration is copied into the ring by cp.async, kStages - 1
  // iterations ahead of the one filtered; each thread reads back only its
  // own 16 bytes, so no barrier orders the ring.  One commit group an
  // iteration, empty where there is nothing to copy.
  auto fetch = [&](uint32_t it) {
    if (it < iters && whole(it))
      cp_async16(ring + (it % kStages) * kThreads + tid, groups + g0 + it * kThreads + tid);
    cp_async_commit();
  };
  auto edge = [&](uint32_t it) {
    const uint32_t g = g0 + it * kThreads + tid;
    float t[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const long long c = 4ll * g - mis + j;
      if (g < g1 && c >= 0 && c < L) t[j] = __ldg(row + c);
    }
    return make_float4(t[0], t[1], t[2], t[3]);
  };
  auto step = [&](uint32_t it, const float4& cur) {
    const bool inside = whole(it);
    const uint32_t g = g0 + it * kThreads + tid;
    const float x[4] = {cur.x, cur.y, cur.z, cur.w};
    bool cand[4];
    int ncand = 0;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const long long c = 4ll * g - mis + j;
      cand[j] = (inside || (g < g1 && c >= 0 && c < L)) && (exact || x[j] <= thr_value);
      ncand += cand[j];
    }
    // A warp with candidates tests them by the whole key and appends those
    // below thr at the block's fill; the warp that takes the fill to
    // flush_at asks for a merge, after this iteration's barrier.
    bool full = false;
    if (__any_sync(0xffffffffu, ncand)) {
      const uint32_t c0 = 4 * g - mis;  // wraps at a row's first group
      Key key[4];
      int npass = 0;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        if (cand[j]) {
          key[j] = make_key(__float_as_uint(x[j]), offset + c0 + j);
          cand[j] = key[j] < thr;
        }
        npass += cand[j];
      }
      int incl = npass;
#pragma unroll
      for (int d = 1; d < 32; d <<= 1) {
        const int t = __shfl_up_sync(0xffffffffu, incl, d);
        if (lane >= d) incl += t;
      }
      int at = 0;
      if (lane == 31 && incl > 0) {
        at = atomicAdd(&s_fill, incl);
        full = at + incl >= flush_at;
      }
      at = __shfl_sync(0xffffffffu, at, 31) + incl - npass;
#pragma unroll
      for (int j = 0; j < 4; ++j)
        if (cand[j]) buf[at++] = key[j];
    }
    if (__syncthreads_or(full)) set_threshold(min(thr, flush(buf, s_fill, &s_fill, best, kp, k)));
  };
  for (uint32_t it = 0; it < kStages; ++it) fetch(it);
  if (k <= kThreads) {
    // A first threshold from the ring: the k-th smallest of the threads'
    // smallest keys over their first kStages groups is at or above the k-th
    // smallest key of the block (k threads hold an entry at or below it), so
    // an entry above it is never taken.  On an H100 this takes pass 1 from
    // 0.202 to 0.193 ms at 128 x 524,288, k = 100, and from 0.040 to 0.030 ms
    // at 16 x 16,384, k = 8.
    cp_async_wait<0>();
    Key least = kEmpty;
    for (uint32_t it = 0; it < min(iters, (uint32_t)kStages); ++it) {
      const uint32_t g = g0 + it * kThreads + tid;
      const bool inside = whole(it);
      const float4 cur = inside ? ring[it * kThreads + tid] : edge(it);
      const float x[4] = {cur.x, cur.y, cur.z, cur.w};
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const long long c = 4ll * g - mis + j;
        if (inside || (g < g1 && c >= 0 && c < L))
          least = min(least, make_key(__float_as_uint(x[j]), offset + (uint32_t)c));
      }
    }
    buf[tid] = least;
    __syncthreads();
    bitonic_sort<false>(buf, nullptr, kThreads);
    const Key first = buf[k - 1];
    __syncthreads();  // buf holds candidates from here on
    if (first != kEmpty) set_threshold(first + 1);
  }
  for (uint32_t it = 0; it < iters; ++it) {
    cp_async_wait<kStages - 1>();
    step(it, whole(it) ? ring[(it % kStages) * kThreads + tid] : edge(it));
    fetch(it + kStages);  // into the slot this thread has just read
  }
  cp_async_wait<0>();
  // Every thread's appends came before the last iteration's barrier.
  const int fill = s_fill;
  if (fill > 0) flush(buf, fill, &s_fill, best, kp, k);

  const unsigned long long out = ((unsigned long long)q * slices + s) * kp;
  for (int i = tid; i < kp; i += kThreads) {
    const Key key = best[i];
    cand_keys[out + i] = key;
    cand_vals[out + i] = key == kEmpty ? 0u : __float_as_uint(row[(uint32_t)key - offset]);
  }
}

__global__ void __launch_bounds__(kThreads)
select_merge_kernel(const Key* __restrict__ cand_keys, const uint32_t* __restrict__ cand_vals,
                    int slices, int k, int kp, const float* __restrict__ prior_vals,
                    const long long* __restrict__ prior_ids, float* __restrict__ out_vals,
                    long long* __restrict__ out_ids) {
  Key* acc = reinterpret_cast<Key*>(smem_raw);
  Key* in = acc + kp;
  uint32_t* acc_v = reinterpret_cast<uint32_t*>(acc + 2 * kp);
  uint32_t* in_v = acc_v + kp;
  const int q = blockIdx.x;
  const Key* keys = cand_keys + (long long)q * slices * kp;
  const uint32_t* vals = cand_vals + (long long)q * slices * kp;
  int first = 0;
  if (prior_vals != nullptr) {
    for (int i = threadIdx.x; i < kp; i += blockDim.x) {
      if (i < k) {
        const uint32_t bits = __float_as_uint(prior_vals[(long long)q * k + i]);
        acc[i] = make_key(bits, (uint32_t)prior_ids[(long long)q * k + i]);
        acc_v[i] = bits;
      } else {
        acc[i] = kEmpty;
        acc_v[i] = 0u;
      }
    }
    __syncthreads();
    bitonic_sort<true>(acc, acc_v, kp);
  } else {
    for (int i = threadIdx.x; i < kp; i += blockDim.x) {
      acc[i] = keys[i];
      acc_v[i] = vals[i];
    }
    __syncthreads();
    first = 1;
  }
  for (int s = first; s < slices; ++s) {
    for (int i = threadIdx.x; i < kp; i += blockDim.x) {
      in[i] = keys[(long long)s * kp + i];
      in_v[i] = vals[(long long)s * kp + i];
    }
    __syncthreads();
    merge_into<true>(acc, acc_v, in, in_v, kp);
  }
  for (int i = threadIdx.x; i < k; i += blockDim.x) {
    out_vals[(long long)q * k + i] = __uint_as_float(acc_v[i]);
    out_ids[(long long)q * k + i] = (long long)(uint32_t)acc[i];
  }
}

// Shared memory of each pass, in bytes, for a list of kp keys
// (ops/select.py::select_plan gives the same).
int smem_bytes(int kp, int pass) {
  return pass == 1 ? kStages * kThreads * 16 + (kBuf + kp) * (int)sizeof(Key)
                   : kp * 2 * (int)(sizeof(Key) + 4);
}

}  // namespace

// scores (nq, L) f32, contiguous (a row's first column may lie at any
// 4-byte address); the k smallest of each row (1 <= k <= kp, kp a power of
// two up to 1,024, k at most L), merged with the (nq, k) prior list (f32 values, int64
// ids in [0, 2^32 - 1)) where prior_vals is not null; ids are offset +
// column and must stay below 2^32 - 1 (the all-ones key marks an empty slot).
// cand_keys (nq, slices, kp) u64 and cand_vals (nq, slices, kp) u32 are the
// scratch between the passes; out_vals (nq, k) f32, out_ids (nq, k) int64.
// pass_smem and merge_smem are the plan's shared memory, checked here.
// Launches both passes on stream; returns cudaGetLastError() after each, or
// -1 for what it does not take.
extern "C" int rt_select(const void* scores, int nq, long long L, int k, int kp,
                         int slices, long long offset, void* cand_keys, void* cand_vals,
                         const void* prior_vals, const void* prior_ids, void* out_vals,
                         void* out_ids, int pass_smem, int merge_smem, void* stream) {
  if (nq <= 0 || L <= 0 || k <= 0 || k > kp || kp > kMaxKp || (kp & (kp - 1)) != 0)
    return -1;
  if (slices <= 0 || (long long)nq * slices > 0x7fffffffLL || slices > (L + 3) / 4) return -1;
  if (offset < 0 || offset + L > 0xffffffffLL) return -1;
  if ((prior_vals == nullptr) != (prior_ids == nullptr) || k > L) return -1;
  if (pass_smem != smem_bytes(kp, 1) || merge_smem != smem_bytes(kp, 2)) return -1;
  cudaStream_t s = (cudaStream_t)stream;
  if (pass_smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        select_pass_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, pass_smem);
    if (e != cudaSuccess) return (int)e;
  }
  select_pass_kernel<<<nq * slices, kThreads, pass_smem, s>>>(
      (const float*)scores, (uint32_t)L, k, kp, slices, (uint32_t)offset, (Key*)cand_keys,
      (uint32_t*)cand_vals);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  select_merge_kernel<<<nq, kThreads, merge_smem, s>>>(
      (const Key*)cand_keys, (const uint32_t*)cand_vals, slices, k, kp,
      (const float*)prior_vals, (const long long*)prior_ids, (float*)out_vals,
      (long long*)out_ids);
  return (int)cudaGetLastError();
}
