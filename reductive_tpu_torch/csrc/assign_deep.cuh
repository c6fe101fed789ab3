// Nearest-centroid assignment above ds = 32 ("the deep route"), as a kernel
// that csrc/encode.cu and csrc/stats.cu both reach through assign_wide::launch,
// so that a row gets the same code, and in verified mode the same flag, from
// either.  Every ds above 32 and every x (any 4-byte alignment) runs here.
//
//   a[i] = argmin_c (|c|^2 - 2c.x_i), first index on ties
//
// Replaces, at these widths, the TPU kernels reductive_tpu/ops/assign.py
// _encode_kernel (138) and _encode_verify_kernel (298), and the assignment
// inside reductive_tpu/ops/stats.py _stats_kernel (50) and
// _stats_verify_kernel (272).  What bounds it on an H100: the products, 3 x
// 2 n k ds operations in TF32 (f32 mode) or 2 n k ds in bf16; the bytes of
// x and the codebook, read once, are far below (at n = 2^19, d = 768, k =
// 16,384: 80 ms of TF32 or 13.3 ms of bf16 against 0.5 ms of bytes).
//
// What the design does about the bytes.  A block takes 128 rows of one
// subquantizer (two consumer warpgroups of 64) against 128 (f32) or 256
// (bf16) centroids a step, so a row chunk is staged k/128 or k/256 times,
// not k/64: at n = 2^19, d = 768, k = 16,384, 103 GB of rows and 103 GB of
// codebook pass from L2 to the SMs in bf16, 206 GB and 412 GB (two parts) in
// f32.  A producer warpgroup fills a ring of stages with full / empty
// mbarriers; the consumers never copy.  The codebook is converted once a call
// by the wrapper (ops/assign.py deep_operands) into the layout TMA loads: 2c
// rounded to bf16, or its TF32 parts w_hi, w_lo (cvt.rna, as
// assign_tile::split_tf32), depth padded with zeros to the step; the norms
// padded with +inf past k; one thread issues its TMA loads (3-D map (2)m, k,
// depth; 128-byte swizzle).  No block splits a centroid.
//
// The rows come into row boxes of 128 rows, in one of three ways chosen at
// compile time (ROWS; ops/assign.py deep_producer and deep_row_map):
// * d = m ds a multiple of 4 (TMA): x is a 2-D map (n, d + off) with row
//   stride 4d, based at x's address rounded down to 16 bytes, off = (x % 16)
//   / 4 floats before x (row_map below).  On an H100 a TMA load whose box
//   starts off 16 bytes in its row stops the kernel (illegal instruction), so
//   the box of a chunk at column col = off + j ds + c0 starts at col rounded
//   down to 4.  Where every box starts there exactly (off = 0 and ds a
//   multiple of 4: kRowsTma) a box is 32 values wide with the 128-byte
//   swizzle; else (kRowsShifted: ds = 50, 75, 150, ... or x off 16 bytes) it
//   is kPitch = 36 values wide, unswizzled (a warp's fragment reads still
//   fall on 32 banks), and the chunk sits at a shift sh = (off + j ds) % 4 in
//   every row box of the block.  So x may sit anywhere on 4 bytes; past d +
//   off and past n TMA fills zeros, and the only values a box holds outside
//   x are the up to 3 floats before x in its storage, at row 0, never read.
// * otherwise (kRowsCopy; d = 50, 75, 111, ...): TMA cannot describe rows
//   whose stride is not a multiple of 16 bytes, so the producer warpgroup's
//   128 threads copy the chunk into the kRowsTma layout (zeros past ds and
//   past n), 8 bytes at a time where every pair of values lies on 8 bytes
//   (d even, x on 8 bytes, j ds even; GloVe-50), else 4, and each signals the
//   stage's full barrier with cp.async.mbarrier.arrive.noinc (the barrier
//   counts those 128 arrivals beside the codebook's TMA).  Lane 0 of each
//   producer warp alone waits for a stage to be free.
// A box holds 32 values from the chunk's start, so past ds it holds the next
// subquantizer's: every consumer reads such a column as zero (load_frags,
// before the split or the rounding and before |x_j|^2).  The zero-padded
// codebook alone would not do: an inf or NaN there times a zero centroid is
// NaN, and would change code j.
//
// The rows stay raw f32 in the ring; each consumer reads its fragments out of
// the stage's row boxes, rounds or splits them in registers and feeds wgmma with
// A from registers (m64n128k8 tf32, m64n256k16 bf16), B by descriptor
// straight from what TMA wrote.  setmaxnreg gives the producer warpgroup 40
// registers and the consumers 232.  A consumer reads the next step's rows
// into a second set of fragments while the current step's products run, then
// retires them and frees the stage.  (Keeping two steps' products in flight
// instead, bf16 on one accumulator, made ptxas serialise the wgmma, C7513,
// and measured no faster; f32 mode has no registers for it: the chunk's 64
// accumulators and the running sum's 64.)  A block walks the row tiles
// first, first + P, ... of its subquantizer (P = gridDim.x / m); the producer
// runs on into the next tile's loads while the consumers finish a tile.  No
// barrier of the whole block after the start.
//
// The arithmetic is the shallow kernel's (csrc/assign_wide.cuh), at every ds
// above 32: f32 mode takes each 32-value chunk from zero, x_lo.w_hi then
// x_hi.w_lo then x_hi.w_hi (four instructions of depth 8 each: the shallow
// kernel's kc = 4 chunks, ops/assign.py wide_chunking), and adds the chunk's
// sum to the running sum in one rounded addition (route "tf32x3_wide",
// ops/assign.py: its bound holds as it is); bf16 mode sums every product of
// the depth from zero in one accumulator, d = |c|^2 - H.  Selection is
// assign_tile::Pick (first index on ties; VERIFY also the least distance over
// all other indices), |x_j|^2 for the flag is taken by the row's four lanes
// in the shallow kernel's order, so the codes and flags are those of the
// shallow kernel on the same rows wherever the tensor cores evaluate an
// output element alike in both instruction shapes (ops/probe.py measures
// both; tests/test_torch_cuda_kernels.py holds the two to each other, the
// shallow one forced).

#pragma once

#include <cuda.h>  // CUtensorMap and its enums; the encoder is looked up at run time
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "assign_tile.cuh"

namespace assign_deep {

// Where a block writes code (row, j): codes[row * code_row + j * code_col],
// uint8 when code_u8, else int32.
struct CodesOut {
  void* codes;
  long long code_row, code_col;
  int code_u8;
};

constexpr int kConsumers = 2;                   // consumer warpgroups
constexpr int kThreads = 128 * (kConsumers + 1);  // and one producer warpgroup
constexpr int kRows = 64 * kConsumers;          // rows of a block
constexpr int kBoxBytes = 128;                  // a row of a swizzled box: 32 f32, 64 bf16
constexpr int kPitch = 36;                      // floats of a shifted row box's row: a chunk and its shift
constexpr int kProducerRegs = 40;
constexpr int kConsumerRegs = 232;

// How the rows reach the ring (see the head of this file).
enum : int { kRowsTma = 0, kRowsShifted = 1, kRowsCopy = 2 };

template <bool BF16>
struct Deep {
  static constexpr int kCols = BF16 ? 256 : 128;  // centroids of a step: one instruction's N
  static constexpr int kDepth = BF16 ? 64 : 32;   // values of depth a step
  static constexpr int kRowBoxes = kDepth / 32;
  static constexpr int kColBox = kCols * kBoxBytes;
  static constexpr int kColBoxes = BF16 ? 1 : 2;  // 2c in bf16, or its TF32 parts hi and lo
  static constexpr int kStages = BF16 ? 3 : 4;
  static constexpr int kAcc = kCols / 2;          // accumulators of a thread
};

// A stage of the ring: the codebook's boxes (1024-byte aligned for the
// swizzle), then the rows' (32-value chunks, 128 or 144 bytes a row).
template <bool BF16, int ROWS>
struct Ring {
  using D = Deep<BF16>;
  static constexpr int kPitchBytes = ROWS == kRowsShifted ? 4 * kPitch : kBoxBytes;
  static constexpr int kRowBox = kRows * kPitchBytes;  // 16 or 18 KB
  static constexpr int kStage = D::kColBoxes * D::kColBox + D::kRowBoxes * kRowBox;  // f32 48 or 50 KB
  // The ring (1024-byte aligned for the swizzle), then full[] and empty[].
  static constexpr int kBytes = 1024 + D::kStages * kStage + 2 * D::kStages * 8;
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void bar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_addr(bar)), "r"(count)
               : "memory");
}
// One arrival that also announces `bytes` of TMA writes to come.
__device__ __forceinline__ void bar_expect(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_addr(bar)),
               "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void bar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_addr(bar)) : "memory");
}
// Waits until the phase of parity `parity` has completed.
__device__ __forceinline__ void bar_wait(uint64_t* bar, uint32_t parity) {
  asm volatile(
      "{\n.reg .pred P1;\nWAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 P1, [%0], %1;\n"
      "@P1 bra DONE;\nbra WAIT;\nDONE:\n}\n" ::"r"(smem_addr(bar)),
      "r"(parity)
      : "memory");
}

// The box of `map` at (c0, c1, c2), innermost first, into dst; completion is
// reported to bar.
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map, uint64_t* bar, int c0,
                                         int c1, int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_addr(bar)), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}
// The same for a 2-D map.
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map, uint64_t* bar, int c0,
                                         int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4}], [%2];\n" ::"r"(smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_addr(bar)), "r"(c0), "r"(c1)
      : "memory");
}

// A 4-byte copy into shared memory; zeros where !valid (src is then not read).
__device__ __forceinline__ void copy4(void* dst, const float* src, bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_addr(dst)), "l"(src),
               "r"(valid ? 4 : 0)
               : "memory");
}
// An 8-byte copy (both addresses on 8 bytes) of its first `bytes` (0, 4 or
// 8), zeros after them.
__device__ __forceinline__ void copy8(void* dst, const float* src, int bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n" ::"r"(smem_addr(dst)), "l"(src),
               "r"(bytes)
               : "memory");
}
// One arrival on bar once this thread's cp.async copies so far have landed;
// the barrier's count includes it (.noinc).
__device__ __forceinline__ void copy_arrive(uint64_t* bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" ::"r"(smem_addr(bar))
               : "memory");
}

// Descriptor of a K-major operand that TMA wrote with the 128-byte swizzle:
// rows of 128 bytes, 1024 bytes to the next 8 rows.  A step of depth inside
// the 128 bytes adds its byte offset / 16 (the swizzle acts on the address).
__device__ __forceinline__ uint64_t sw128_descriptor(const unsigned char* p) {
  return (uint64_t)((smem_addr(p) & 0x3ffffu) >> 4) | ((uint64_t)1 << 16) |
         ((uint64_t)(1024u >> 4) << 32) | ((uint64_t)1 << 62);
}

// Byte offset of column c (f32) of row r in a box TMA wrote with the 128-byte
// swizzle: the 16-byte unit c / 4 lands at unit (c / 4) ^ (r % 8).
__device__ __forceinline__ int swizzled(int r, int c) {
  return r * kBoxBytes + ((((c >> 2) ^ r) & 7) << 4) + (c & 3) * 4;
}

// Values c and c + 1 (c even) of row r of a row box, c counted from the box's
// first column.
template <int ROWS>
__device__ __forceinline__ float2 row_pair(const unsigned char* box, int r, int c) {
  if constexpr (ROWS == kRowsShifted) {
    const float* p = reinterpret_cast<const float*>(box + (r * kPitch + c) * 4);
    return make_float2(p[0], p[1]);  // on 4 bytes only
  } else {
    return *reinterpret_cast<const float2*>(box + swizzled(r, c));
  }
}
template <int ROWS>
__device__ __forceinline__ float row_value(const unsigned char* box, int r, int c) {
  return *reinterpret_cast<const float*>(box + (ROWS == kRowsShifted ? (r * kPitch + c) * 4
                                                                      : swizzled(r, c)));
}

// d (+)= a . b^T: a, 64 x 8 TF32 values in the warpgroup's registers (the
// fragment layout of assign_tile::load_rows); b, 128 x 8 behind its descriptor.
__device__ __forceinline__ void mma_tf32_n128(float (&d)[64], const uint32_t (&a)[4], uint64_t db,
                                              int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 {"
      "%0,%1,%2,%3,%4,%5,%6,%7,%8,%9,%10,%11,%12,%13,%14,%15,"
      "%16,%17,%18,%19,%20,%21,%22,%23,%24,%25,%26,%27,%28,%29,%30,%31,"
      "%32,%33,%34,%35,%36,%37,%38,%39,%40,%41,%42,%43,%44,%45,%46,%47,"
      "%48,%49,%50,%51,%52,%53,%54,%55,%56,%57,%58,%59,%60,%61,%62,%63"
      "}, {%64,%65,%66,%67}, %68, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(accumulate));
}

// d (+)= a . b^T: a, 64 x 16 bf16 in registers (mma.sync's m16n8k16 A layout a
// warp); b, 256 x 16 behind its descriptor, K-major (no transpose).
__device__ __forceinline__ void mma_bf16_n256(float (&d)[128], const uint32_t (&a)[4], uint64_t db,
                                              int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %133, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
      "%0,%1,%2,%3,%4,%5,%6,%7,%8,%9,%10,%11,%12,%13,%14,%15,"
      "%16,%17,%18,%19,%20,%21,%22,%23,%24,%25,%26,%27,%28,%29,%30,%31,"
      "%32,%33,%34,%35,%36,%37,%38,%39,%40,%41,%42,%43,%44,%45,%46,%47,"
      "%48,%49,%50,%51,%52,%53,%54,%55,%56,%57,%58,%59,%60,%61,%62,%63,"
      "%64,%65,%66,%67,%68,%69,%70,%71,%72,%73,%74,%75,%76,%77,%78,%79,"
      "%80,%81,%82,%83,%84,%85,%86,%87,%88,%89,%90,%91,%92,%93,%94,%95,"
      "%96,%97,%98,%99,%100,%101,%102,%103,%104,%105,%106,%107,%108,%109,%110,%111,"
      "%112,%113,%114,%115,%116,%117,%118,%119,%120,%121,%122,%123,%124,%125,%126,%127"
      "}, {%128,%129,%130,%131}, %132, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
        "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),
        "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]),
        "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(accumulate));
}

__device__ __forceinline__ uint32_t pack_bf16(float2 v) {  // v.x in the low half, rounded to nearest even
  const __nv_bfloat162 b = __floats2bfloat162_rn(v.x, v.y);
  return *reinterpret_cast<const uint32_t*>(&b);
}

// The scores of one centroid tile (p: a thread's NC / 2 accumulators, columns
// n0 + 8i + 2t and + 1 for rows g and g + 8) into the running selection.
// nrm: the subquantizer's norms, padded with +inf past k.
template <int NC, bool VERIFY>
__device__ __forceinline__ void select_tile(assign_tile::Pick<VERIFY>& pick, const float (&p)[NC / 2],
                                            const float* __restrict__ nrm, int n0, int t) {
#pragma unroll
  for (int i = 0; i < NC / 8; ++i) {
    const float2 nn = __ldg(reinterpret_cast<const float2*>(nrm + n0 + 8 * i + 2 * t));
    pick.take(0, nn.x - p[4 * i + 0], nn.y - p[4 * i + 1], n0 + 8 * i);
    pick.take(1, nn.x - p[4 * i + 2], nn.y - p[4 * i + 3], n0 + 8 * i);
  }
}

// The thread's row fragments of one step, read out of the stage's row boxes:
// bf16 mode, rounded to bf16 (a[0], mma.sync's m16n8k16 A layout a warp);
// f32 mode, split into TF32 parts hi (a[0]) and lo (a[1]) (the layout of
// assign_tile::load_rows).
template <bool BF16>
struct Frags {
  uint32_t a[BF16 ? 1 : 2][4][4];
};

// Columns of a step at or past lim (= ds - c0, the step's first column c0)
// hold the next subquantizer's values, or zeros: read as zero.
__device__ __forceinline__ float masked(float v, int col, int lim) { return col < lim ? v : 0.0f; }
__device__ __forceinline__ float2 masked(float2 v, int col, int lim) {
  return make_float2(masked(v.x, col, lim), masked(v.y, col + 1, lim));
}

// VERIFY with `norm` (the first centroid tile): |x_j|^2 of the thread's two
// rows takes the step's columns t, t + 4, ... in order, the shallow kernel's
// order (the masked columns add nothing).  MASK: the step runs past ds.
template <bool BF16, bool VERIFY, int ROWS, bool MASK>
__device__ __forceinline__ void load_frags(Frags<BF16>& f, const unsigned char* stage, int rbase,
                                           int t, bool norm, int lim, int sh, float (&xn2)[2]) {
  using R_ = Ring<BF16, ROWS>;
  const unsigned char* rows = stage + Deep<BF16>::kColBoxes * Deep<BF16>::kColBox;
  if constexpr (BF16) {
#pragma unroll
    for (int ks = 0; ks < 4; ++ks) {  // depth 16 ks .. 16 ks + 15 of the step
      const unsigned char* box = rows + (ks >> 1) * R_::kRowBox;
      const int col = (ks & 1) * 16 + 2 * t;
      const int at = 32 * (ks >> 1) + col;  // the column in the step
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = rbase + 8 * h;
        const float2 lo = row_pair<ROWS>(box, r, sh + col), hi = row_pair<ROWS>(box, r, sh + col + 8);
        f.a[0][ks][h] = pack_bf16(MASK ? masked(lo, at, lim) : lo);
        f.a[0][ks][2 + h] = pack_bf16(MASK ? masked(hi, at + 8, lim) : hi);
      }
    }
  } else {
#pragma unroll
    for (int ks = 0; ks < 4; ++ks) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {  // row + 8 (i % 2), column 8 ks + t + 4 (i / 2)
        const int col = 8 * ks + t + 4 * (i >> 1);
        float v = row_value<ROWS>(rows, rbase + 8 * (i & 1), sh + col);
        if constexpr (MASK) v = masked(v, col, lim);
        if constexpr (VERIFY) {
          if (norm) xn2[i & 1] = fmaf(v, v, xn2[i & 1]);
        }
        assign_tile::split_tf32(v, f.a[0][ks][i], f.a[1][ks][i]);
      }
    }
  }
}

// The step's fragments, masked only where the step runs past ds (lim < its
// depth: the last chunk of a ds that is no multiple of the depth).
template <bool BF16, bool VERIFY, int ROWS>
__device__ __forceinline__ void load_step(Frags<BF16>& f, const unsigned char* stage, int rbase,
                                          int t, bool norm, int lim, int sh, float (&xn2)[2]) {
  if (lim < Deep<BF16>::kDepth)
    load_frags<BF16, VERIFY, ROWS, true>(f, stage, rbase, t, norm, lim, sh, xn2);
  else
    load_frags<BF16, VERIFY, ROWS, false>(f, stage, rbase, t, norm, lim, sh, xn2);
}

// Start one step's products on acc, committed as one group.  bf16: four k16
// instructions onto the tile's sum (from zero at its first chunk, c = 0).
// f32: the chunk from zero, x_lo.w_hi and x_hi.w_lo over its depth, then
// x_hi.w_hi, the narrow route's order.
template <bool BF16>
__device__ __forceinline__ void start_products(float (&acc)[Deep<BF16>::kAcc], const Frags<BF16>& f,
                                               const unsigned char* stage, int c) {
  const unsigned char* w = stage;  // the codebook's boxes
  assign_tile::wgmma_fence();
  if constexpr (BF16) {
    const uint64_t db = sw128_descriptor(w);
#pragma unroll
    for (int ks = 0; ks < 4; ++ks) mma_bf16_n256(acc, f.a[0][ks], db + 2 * ks, (c > 0 || ks > 0) ? 1 : 0);
  } else {
    const uint64_t dh = sw128_descriptor(w);
    const uint64_t dl = sw128_descriptor(w + Deep<false>::kColBox);
#pragma unroll
    for (int ks = 0; ks < 4; ++ks) mma_tf32_n128(acc, f.a[1][ks], dh + 2 * ks, ks > 0);
#pragma unroll
    for (int ks = 0; ks < 4; ++ks) mma_tf32_n128(acc, f.a[0][ks], dl + 2 * ks, 1);
#pragma unroll
    for (int ks = 0; ks < 4; ++ks) mma_tf32_n128(acc, f.a[0][ks], dh + 2 * ks, 1);
  }
  assign_tile::wgmma_commit();
}

// Where a consumer stands: the stage of its step and the parity of that
// stage's round, the chunk of depth, the centroid tile's first column.  All
// move by counting, no division on the consumers' path.
struct Cursor {
  int st;
  uint32_t phase;
  int c, n0;
};

// Step s of a row tile, its rows already in frags[P]: start the products,
// read step s + 1's rows into frags[1 - P] while they run, retire them and
// free the stage; f32 adds the chunk to the running sum in one rounded
// addition; after a centroid tile's last chunk its scores are selected.  P
// alternates, so the set the products read is never written under them.
template <bool BF16, bool VERIFY, int ROWS, int P>
__device__ __forceinline__ void consume_step(unsigned char* ring, uint64_t* full, uint64_t* empty,
                                             Cursor& at, int s, int steps, int chunks, int ds,
                                             int sh, int rbase, int t, int lane,
                                             Frags<BF16> (&frags)[2],
                                             float (&acc)[Deep<BF16>::kAcc],
                                             float (&run)[Deep<BF16>::kAcc], float (&xn2)[2],
                                             assign_tile::Pick<VERIFY>& pick, const float* nrm) {
  using S_ = Deep<BF16>;
  using R_ = Ring<BF16, ROWS>;
  const int st = at.st, c = at.c;
  const bool last = c == chunks - 1;  // the centroid tile's last chunk
  start_products<BF16>(acc, frags[P], ring + st * R_::kStage, c);
  if (++at.st == S_::kStages) {
    at.st = 0;
    at.phase ^= 1;
  }
  if (s + 1 < steps) {
    bar_wait(full + at.st, at.phase);
    load_step<BF16, VERIFY, ROWS>(frags[1 - P], ring + at.st * R_::kStage, rbase, t,
                                  at.n0 == 0 && !last, ds - (last ? 0 : c + 1) * S_::kDepth, sh,
                                  xn2);
  }
  assign_tile::wgmma_wait<0>();
  assign_tile::pin(acc);
  if (lane == 0) bar_arrive(empty + st);
  if constexpr (BF16) {
    if (last) select_tile<S_::kCols, VERIFY>(pick, acc, nrm, at.n0, t);
  } else {
#pragma unroll
    for (int i = 0; i < S_::kAcc; ++i) run[i] = c == 0 ? acc[i] : run[i] + acc[i];
    if (last) select_tile<S_::kCols, VERIFY>(pick, run, nrm, at.n0, t);
  }
  if (last) {
    at.c = 0;
    at.n0 += S_::kCols;
  } else {
    at.c = c + 1;
  }
}

// Grid: P * m blocks; block b takes subquantizer b % m and the row tiles
// (128 rows each) b / m, b / m + P, ....  Threads 0 .. 255 are the two
// consumer warpgroups, 256 .. 383 the producer's.  kRowsTma, kRowsShifted:
// the rows come through xmap (row_map: x as (n, d + off) f32, box (128, 32)
// swizzled or (128, 36) not, columns shifted by off); kRowsCopy: by cp.async
// from x.  wmap: the converted codebook (ops/assign.py
// deep_operands), box (1, kCols, kDepth); norms (m, tiles * kCols), +inf past k.
template <bool BF16, bool VERIFY, int ROWS>
__global__ void __launch_bounds__(kThreads, 1)
deep_assign_kernel(const __grid_constant__ CUtensorMap xmap, const __grid_constant__ CUtensorMap wmap,
                   const float* __restrict__ x, const float* __restrict__ norms, CodesOut out,
                   const float* __restrict__ escale, float rho, int* __restrict__ flags, long long n,
                   int m, int k, int ds, int off, int chunks) {
  using S_ = Deep<BF16>;
  using R_ = Ring<BF16, ROWS>;
  constexpr bool kTma = ROWS != kRowsCopy;
  extern __shared__ unsigned char deep_smem[];
  unsigned char* ring = deep_smem + ((1024u - (smem_addr(deep_smem) & 1023u)) & 1023u);
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + S_::kStages * R_::kStage);
  uint64_t* empty = full + S_::kStages;
  const int tiles = (k + S_::kCols - 1) / S_::kCols;
  const int steps = tiles * chunks;  // steps of a row tile
  const int j = blockIdx.x % m;
  const long long P = gridDim.x / m;
  const long long n_tiles = (n + kRows - 1) / kRows;
  const int wg = threadIdx.x >> 7;
  const int sh = ROWS == kRowsShifted ? (off + j * ds) & 3 : 0;  // a chunk's start in its row box
  constexpr int kCopiers = 128;  // cp.async: the producer warpgroup's threads
  if (threadIdx.x == 0) {
    for (int s = 0; s < S_::kStages; ++s) {
      bar_init(full + s, kTma ? 1 : 1 + kCopiers);  // the codebook's TMA (and the copies)
      bar_init(empty + s, 4 * kConsumers);         // one arrival a consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == kConsumers) {  // the producer keeps the ring full, tile after tile
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kProducerRegs));
    const int pt = threadIdx.x - 128 * kConsumers;
    if (kTma && pt != 0) return;
    const float* xj = x + (long long)j * ds;
    const long long d = (long long)m * ds;
    const bool pairs = d % 2 == 0 && (reinterpret_cast<uintptr_t>(x) & 7) == 0 && (j * ds) % 2 == 0;
    int st = 0;
    uint32_t phase = 0;  // of the stage's round
#pragma unroll 1
    for (long long tile = blockIdx.x / m; tile < n_tiles; tile += P) {
      const long long row0 = tile * kRows;
      int c = 0, n0 = 0;  // the chunk of depth, the centroid tile's first column
#pragma unroll 1
      for (int s = 0; s < steps; ++s) {
        if (kTma || (pt & 31) == 0) bar_wait(empty + st, phase ^ 1);  // the first round finds it free
        if constexpr (!kTma) __syncwarp();
        unsigned char* stage = ring + st * R_::kStage;
        const int c0 = c * S_::kDepth;
        unsigned char* rows = stage + S_::kColBoxes * S_::kColBox;
        if (pt == 0) {
          bar_expect(full + st, kTma ? R_::kStage : S_::kColBoxes * S_::kColBox);
          tma_load(stage, &wmap, full + st, c0, n0, j);
          if constexpr (!BF16) tma_load(stage + S_::kColBox, &wmap, full + st, c0, n0, m + j);
          if constexpr (kTma) {
#pragma unroll
            for (int b = 0; b < S_::kRowBoxes; ++b)
              tma_load(rows + b * R_::kRowBox, &xmap, full + st, (off + j * ds + c0 + 32 * b) & ~3,
                       (int)row0);
          }
        }
        if constexpr (!kTma) {
          if (pairs) {  // lane l: values 2 (l % 16), + 1 of rows 2 w + l / 16, + 8, ... (w the warp)
            const int v = 2 * (pt & 15);
#pragma unroll
            for (int b = 0; b < S_::kRowBoxes; ++b) {
              const int col = c0 + 32 * b + v;
              const int bytes = col + 1 < ds ? 8 : col < ds ? 4 : 0;
#pragma unroll 4
              for (int r = 2 * (pt >> 5) + ((pt >> 4) & 1); r < kRows; r += 8) {
                const int got = row0 + r < n ? bytes : 0;
                copy8(rows + b * R_::kRowBox + swizzled(r, v), got ? xj + (row0 + r) * d + col : x, got);
              }
            }
          } else {  // lane c of each warp takes column c of every fourth row
#pragma unroll
            for (int b = 0; b < S_::kRowBoxes; ++b) {
              const int col = c0 + 32 * b + (pt & 31);
#pragma unroll 4
              for (int r = pt >> 5; r < kRows; r += 4) {
                const bool ok = col < ds && row0 + r < n;
                copy4(rows + b * R_::kRowBox + swizzled(r, pt & 31),
                      ok ? xj + (row0 + r) * d + col : x, ok);
              }
            }
          }
          copy_arrive(full + st);
        }
        if (++c == chunks) {
          c = 0;
          n0 += S_::kCols;
        }
        if (++st == S_::kStages) {
          st = 0;
          phase ^= 1;
        }
      }
    }
    return;
  }

  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kConsumerRegs));
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int rbase = 64 * wg + 16 * ((threadIdx.x >> 5) & 3) + g;  // rows rbase, rbase + 8
  const float* nrm = norms + (long long)j * tiles * S_::kCols;
  float acc[S_::kAcc];
  float run[S_::kAcc];  // f32: the chunks' running sum
  Frags<BF16> frags[2];
  Cursor at = {0, 0u, 0, 0};
#pragma unroll 1
  for (long long tile = blockIdx.x / m; tile < n_tiles; tile += P) {
    assign_tile::Pick<VERIFY> pick;
    pick.reset();
    float xn2[2] = {0.0f, 0.0f};  // VERIFY: |x_j|^2, columns t, t + 4, ... in order
    at.c = at.n0 = 0;
    bar_wait(full + at.st, at.phase);
    load_step<BF16, VERIFY, ROWS>(frags[0], ring + at.st * R_::kStage, rbase, t, true, ds, sh, xn2);
#pragma unroll 1
    for (int s = 0; s < steps; s += 2) {
      consume_step<BF16, VERIFY, ROWS, 0>(ring, full, empty, at, s, steps, chunks, ds, sh, rbase, t,
                                          lane, frags, acc, run, xn2, pick, nrm);
      if (s + 1 < steps)
        consume_step<BF16, VERIFY, ROWS, 1>(ring, full, empty, at, s + 1, steps, chunks, ds, sh,
                                            rbase, t, lane, frags, acc, run, xn2, pick, nrm);
    }

#pragma unroll
    for (int h = 0; h < 2; ++h) {
      int idx;
      float best, second;
      pick.finish(h, idx, best, second);
      const long long row = tile * kRows + rbase + 8 * h;
      if constexpr (VERIFY) {
        float x2 = xn2[h];
        x2 += __shfl_xor_sync(0xffffffffu, x2, 1);
        x2 += __shfl_xor_sync(0xffffffffu, x2, 2);
        if (t == 0 && row < n) {
          const float margin = second - best;
          const float limit = 2.0f * escale[j] * sqrtf(x2) + rho * fabsf(best);
          if (!(margin > limit)) atomicOr(flags + row, 1);
        }
      }
      if (t == 0 && row < n) {
        const long long at = row * out.code_row + (long long)j * out.code_col;
        if (out.code_u8)
          static_cast<uint8_t*>(out.codes)[at] = (uint8_t)idx;
        else
          static_cast<int32_t*>(out.codes)[at] = idx;
      }
    }
  }
}

// ---- host side ------------------------------------------------------------------

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled from the driver, found through the runtime (the
// library links no libcuda); nullptr if the driver has none.
inline EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err =
        cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    if (err == cudaSuccess && found == cudaDriverEntryPointSuccess) fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// A map of rank R over base: dims innermost first, the byte strides of dims
// 1 .. R - 1, the box, the swizzle; zeros out of bounds.
template <int R>
inline bool make_map(CUtensorMap* map, CUtensorMapDataType type, const void* base,
                     const cuuint64_t (&dims)[R], const cuuint64_t (&strides)[R - 1],
                     const cuuint32_t (&box)[R], CUtensorMapSwizzle swizzle) {
  const EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return false;
  cuuint32_t unit[R];
  for (int i = 0; i < R; ++i) unit[i] = 1;
  return fn(map, type, R, const_cast<void*>(base), dims, strides, box, unit,
            CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle, CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// The rows' TMA map (ops/assign.py deep_row_map): based at x rounded down to
// 16 bytes, off floats before x; dims (d + off, n), row stride 4 d; the box of
// subvector j's chunk c0 starts at column (off + j ds + c0) rounded down to 4
// (kRowsTma where that is every box's own column: off = 0, ds % 4 = 0).
struct RowMap {
  const float* base;
  int off;
};
inline RowMap row_map(const float* x) {
  const int off = (int)((reinterpret_cast<uintptr_t>(x) & 15) >> 2);
  return {x - off, off};
}

// Which producer brings the rows (ops/assign.py deep_producer): TMA where the
// row stride 4 m ds is a multiple of 16 bytes, else cp.async.
inline bool tma_rows(int m, int ds) { return (long long)m * ds % 4 == 0; }

// Row tiles a subquantizer's blocks share: as many blocks as the card holds
// at once, so that each walks many tiles and its producer runs ahead across
// them (codes are per row: no result depends on the grid).
template <typename Kernel>
inline cudaError_t tile_blocks(Kernel kern, int bytes, int m, long long n_tiles, long long& P) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t err;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return err;
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess)
    return err;
  if ((err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kern, kThreads, bytes)) !=
      cudaSuccess)
    return err;
  P = (long long)sms * per_sm / m;
  P = P < 1 ? 1 : (P > n_tiles ? n_tiles : P);
  return cudaSuccess;
}

template <bool BF16, bool VERIFY, int ROWS>
cudaError_t launch_mode(const float* x, const void* w, const float* norms, CodesOut out,
                        const float* escale, float rho, int* flags, long long n, int m, int k,
                        int ds, cudaStream_t stream) {
  using S_ = Deep<BF16>;
  using R_ = Ring<BF16, ROWS>;
  constexpr bool kShifted = ROWS == kRowsShifted;
  const int chunks = (ds + S_::kDepth - 1) / S_::kDepth;
  const cuuint64_t d = (cuuint64_t)m * ds;
  const RowMap rows = row_map(x);
  CUtensorMap xmap{}, wmap;
  if (ROWS != kRowsCopy &&
      !make_map<2>(&xmap, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, rows.base, {d + rows.off, (cuuint64_t)n},
                   {4 * d}, {kShifted ? kPitch : 32, kRows},
                   kShifted ? CU_TENSOR_MAP_SWIZZLE_NONE : CU_TENSOR_MAP_SWIZZLE_128B))
    return cudaErrorInvalidValue;
  const cuuint64_t depth = (cuuint64_t)chunks * S_::kDepth, elem = BF16 ? 2 : 4;
  if (!make_map<3>(&wmap, BF16 ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16 : CU_TENSOR_MAP_DATA_TYPE_FLOAT32, w,
                   {depth, (cuuint64_t)k, (cuuint64_t)(BF16 ? m : 2 * m)},
                   {depth * elem, depth * k * elem}, {S_::kDepth, S_::kCols, 1},
                   CU_TENSOR_MAP_SWIZZLE_128B))
    return cudaErrorInvalidValue;
  auto kern = deep_assign_kernel<BF16, VERIFY, ROWS>;
  cudaError_t err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, R_::kBytes);
  if (err != cudaSuccess) return err;
  long long P;
  if ((err = tile_blocks(kern, R_::kBytes, m, (n + kRows - 1) / kRows, P)) != cudaSuccess) return err;
  const long long blocks = P * m;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  kern<<<(unsigned)blocks, kThreads, R_::kBytes, stream>>>(xmap, wmap, x, norms, out, escale, rho,
                                                           flags, n, m, k, ds, rows.off, chunks);
  return cudaGetLastError();
}

// The deep assignment of x (n, m*ds) f32, any ds and any x on 4 bytes,
// against w and norms as ops/assign.py deep_operands writes them: bf16 mode,
// w (m, k, ceil(ds/64)*64) bf16 holding 2c; f32 mode, w (2, m, k,
// ceil(ds/32)*32) f32 holding the TF32 parts hi then lo of 2c; norms (m,
// ceil(k/kCols)*kCols) f32, |c|^2 then +inf.  verify needs f32 mode, escale
// (m,) and a zeroed flags (n,).  Returns the launch's error;
// cudaErrorInvalidValue for what it does not take.
inline cudaError_t launch(const float* x, const void* w, const float* norms, CodesOut out, bool bf16,
                          bool verify, const float* escale, float rho, int* flags, long long n,
                          int m, int k, int ds, cudaStream_t stream) {
  if (n <= 0) return cudaSuccess;
  if (m <= 0 || k <= 0 || ds <= 0 || (bf16 && verify) || n > 0x7fffffffLL ||
      (reinterpret_cast<uintptr_t>(x) & 3) != 0)
    return cudaErrorInvalidValue;
  const int rows = !tma_rows(m, ds)                     ? kRowsCopy
                   : row_map(x).off == 0 && ds % 4 == 0 ? kRowsTma
                                                        : kRowsShifted;
#define RT_DEEP(B, V, R) \
  return launch_mode<B, V, R>(x, w, norms, out, escale, rho, flags, n, m, k, ds, stream)
#define RT_DEEP_MODES(R)               \
  if (bf16) RT_DEEP(true, false, R);   \
  if (verify) RT_DEEP(false, true, R); \
  RT_DEEP(false, false, R)
  if (rows == kRowsTma) {
    RT_DEEP_MODES(kRowsTma);
  }
  if (rows == kRowsShifted) {
    RT_DEEP_MODES(kRowsShifted);
  }
  RT_DEEP_MODES(kRowsCopy);
#undef RT_DEEP_MODES
#undef RT_DEEP
}

}  // namespace assign_deep
