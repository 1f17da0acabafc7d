// Device helpers shared by the GRU recurrence kernels (gru_fwd.cu, gru_bwd.cu,
// gru_fwd_blocked.cu):
// the bf16 to float conversion, the gate nonlinearities, and the Hopper
// tensor-core pieces of their bf16 and f32 forms.
//
// The bf16 products use mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32:
// A is a 16 x 16 tile, B a 16 x 8 tile, the sum a 16 x 8 f32 tile, all held
// across the 32 lanes of a warp.  With g = lane / 4 and c = 2 * (lane % 4)
// (frag_row, frag_col), lane `lane` holds
//   A: a[0] = (row g,   k c, c+1)    a[1] = (row g+8, k c, c+1)
//      a[2] = (row g,   k c+8, c+9)  a[3] = (row g+8, k c+8, c+9)
//   B: b[0] = (k c, c+1,   col g)    b[1] = (k c+8, c+9, col g)
//   D: d[0], d[1] = (row g, cols c, c+1)   d[2], d[3] = (row g+8, cols c, c+1)
// each register a pair of bf16 with the lower index in the lower half.
// ldmatrix.x4 loads four 8 x 8 bf16 matrices from shared memory: lanes
// 8i .. 8i+7 give the row addresses of matrix i, and register i of lane l
// receives (row l / 4, cols 2 (l % 4), +1) of matrix i, or with .trans the
// transposed pair (rows 2 (l % 4), +1 of column l / 4).
//
// The f32 products run 3xTF32 on mma.sync.aligned.m16n8k8.row.col.f32.tf32.
// tf32.f32: each f32 operand x is split into two TF32 values, big = x
// rounded to TF32 and small = x - big (exact in f32; split_tf32), and a . b
// is taken as a_big b_big + (a_big b_small + a_small b_big), dropping
// a_small b_small (below 2^-22 of |a b|).  The big product and the two
// corrections sum in separate f32 accumulators, so the big chain is a third
// as long and the corrections do not round against it.  With t = lane % 4
// (and g as above), lane `lane` holds
//   A: a[0] = (row g, k t)  a[1] = (row g+8, k t)  a[2] = (row g, k t+4)
//      a[3] = (row g+8, k t+4)
//   B: b[0] = (k t, col g)  b[1] = (k t+4, col g)
//   D: the m16n8k16 layout above,
// one f32 (read as TF32) a register, so the fragments are plain shared
// loads: with a tile's row stride ld at 4 mod 32 (A, or a B that lies
// N-major) or 8 mod 32 (a B that lies K-major) they hit 32 distinct banks.
// The D layout is the bf16 one, so the f32 forms keep the bf16 forms' gate
// layout and carry.  On an H100, K1 and K3 in this form stay within 1.16x
// of the FMA forms' distance from an f64 recurrence (about 2e-7 of scale,
// deeprest_tpu_torch/benchmarks/f32_kernels.py).

#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

namespace gru_mma {

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

__device__ __forceinline__ float sigmoid_f32(float x) { return 1.0f / (1.0f + expf(-x)); }

// ---------------------------------------------------------------------------
// bf16 pairs
// ---------------------------------------------------------------------------

// Two floats rounded to bf16 (round to nearest even) in one register.
__device__ __forceinline__ uint32_t pack_bf16x2(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ float2 unpack_bf16x2(uint32_t v) {
  return __bfloat1622float2(*reinterpret_cast<__nv_bfloat162*>(&v));
}

// Four bytes at a 4-byte aligned address: a pair of neighbouring bf16.
__device__ __forceinline__ uint32_t load_pair(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__device__ __forceinline__ void store_pair(__nv_bfloat16* p, uint32_t v) {
  *reinterpret_cast<uint32_t*>(p) = v;
}

// ---------------------------------------------------------------------------
// fragments
// ---------------------------------------------------------------------------

__device__ __forceinline__ int frag_row(int lane) { return lane >> 2; }
__device__ __forceinline__ int frag_col(int lane) { return 2 * (lane & 3); }

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p))
               : "memory");
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p))
               : "memory");
}

// d += a . b for one m16n8k16 tile, bf16 operands, f32 sum.
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Row-major A (K contiguous) at `tile`, `ld` elements a row: the A
// fragment of rows 0..15 and k 0..15 through one ldmatrix.x4.
__device__ __forceinline__ void load_a(uint32_t (&a)[4], const __nv_bfloat16* tile,
                                       int ld, int lane) {
  ldmatrix_x4(a, tile + (lane & 15) * ld + (lane >> 4) * 8);
}

// K-major A (M contiguous: tile[k][m]): the A fragment of m 0..15, k 0..15.
__device__ __forceinline__ void load_a_trans(uint32_t (&a)[4], const __nv_bfloat16* tile,
                                             int ld, int lane) {
  ldmatrix_x4_trans(a, tile + ((lane >> 4) * 8 + (lane & 7)) * ld + ((lane >> 3) & 1) * 8);
}

// K-major B (N contiguous: tile[k][n]): b[0], b[1] of n 0..7 and b[2], b[3]
// of n 8..15, k 0..15.
__device__ __forceinline__ void load_b_trans(uint32_t (&b)[4], const __nv_bfloat16* tile,
                                             int ld, int lane) {
  ldmatrix_x4_trans(b, tile + (lane & 15) * ld + (lane >> 4) * 8);
}

// N-major B (K contiguous: tile[n][k]): b[0], b[1] of n 0..7 and b[2], b[3]
// of n 8..15, k 0..15.
__device__ __forceinline__ void load_b(uint32_t (&b)[4], const __nv_bfloat16* tile,
                                       int ld, int lane) {
  ldmatrix_x4(b, tile + ((lane >> 4) * 8 + (lane & 7)) * ld + ((lane >> 3) & 1) * 8);
}

// ---------------------------------------------------------------------------
// asynchronous copies
// ---------------------------------------------------------------------------

// 16 bytes global -> shared without a register round trip; `full` false
// writes 16 zero bytes instead (src is then not read).
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool full) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(smem_addr(dst)), "l"(src), "r"(full ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Wait until at most N committed groups are still in flight.
template <int N> __device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

// ---------------------------------------------------------------------------
// 3xTF32
// ---------------------------------------------------------------------------

// x = big + small, big a TF32 value rounded to nearest (ties away: add half
// of TF32's last place, then clear the 13 bits TF32 drops) and small the
// exact f32 remainder, |small| <= 2^-11 |x|.  The tensor cores read small's
// top 19 bits (the 13 low bits are ignored), so it enters the product to
// about 2^-22 of |x|.  Two integer operations and one subtraction: a
// cvt.rna.tf32.f32 for each half made K1 slower on the card.
__device__ __forceinline__ void split_tf32(float x, uint32_t& big, uint32_t& small) {
  big = (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
  small = __float_as_uint(x - __uint_as_float(big));
}

// d += a . b for one m16n8k8 tile, TF32 operands, f32 sum.
__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// A split A or B fragment: big and small halves of each register.
template <int N> struct SplitFrag {
  uint32_t big[N], small[N];
};

// The A fragment of rows 0..15, k 0..7 of a row-major f32 tile, split.
__device__ __forceinline__ SplitFrag<4> load_a_tf32(const float* tile, int ld, int lane) {
  const int g = frag_row(lane), t = lane & 3;
  const float v[4] = {tile[g * ld + t], tile[(g + 8) * ld + t],
                      tile[g * ld + t + 4], tile[(g + 8) * ld + t + 4]};
  SplitFrag<4> a;
#pragma unroll
  for (int i = 0; i < 4; ++i) split_tf32(v[i], a.big[i], a.small[i]);
  return a;
}

// The B fragment of k 0..7, n 0..7 from two f32 values, split: lane
// (g, t) passes (k t, col g) and (k t+4, col g).
__device__ __forceinline__ SplitFrag<2> split_b_tf32(float b0, float b1) {
  SplitFrag<2> b;
  split_tf32(b0, b.big[0], b.small[0]);
  split_tf32(b1, b.big[1], b.small[1]);
  return b;
}

// 3xTF32: big += a_big b_big, cor += a_small b_big + a_big b_small.
__device__ __forceinline__ void mma_3xtf32(float (&big)[4], float (&cor)[4],
                                           const SplitFrag<4>& a,
                                           const SplitFrag<2>& b) {
  mma_tf32(cor, a.small, b.big[0], b.big[1]);
  mma_tf32(cor, a.big, b.small[0], b.small[1]);
  mma_tf32(big, a.big, b.big[0], b.big[1]);
}

}  // namespace gru_mma
