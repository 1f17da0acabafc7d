// GRU forward recurrence with a caller-chosen blocking, for the tuning sweep.
//
// Replaces benchmarks/kernel_tuning.py::make_fwd_call (its pallas_call): a
// standalone copy of the forward recurrence of ops/pallas_gru.py whose
// blocking the sweep chooses.  Per expert e and batch row b, as gru_fwd.cu:
//
//   g   = h . W_hh[e] + b_hh[e]                      (gate order r, z, n)
//   r   = sigmoid(x_r + g_r),  z = sigmoid(x_z + g_z)
//   n   = tanh(x_n + r * g_n)
//   h  <- (1 - z) * n + z * h                         written out every step
//
// Layout and types:
//   proj  [E, T, B, 3H]  io type (float or bf16)
//   w_hh  [E, H, 3H]     io type
//   b_hh  [E, 3H]        float
//   h0    [E, B, H]      float
//   out   [E, T, B, H]   float, whatever the io type (as the TPU kernel)
// The carry, b_hh and the gate math are float.  With bf16_dot the dot reads
// h and W_hh rounded to bf16, their exact products summed in float; without
// it the dot is float (bf16 inputs then give bf16-exact weights and an
// unrounded h).  There is no reverse form: the sweep runs forward only.
//
// Blocking, the TPU block's axes mapped onto a CTA:
//   e_blk  experts per CTA (1, 2 or 4), stepped time outer and expert inner
//          as the TPU kernel's loop does, so each step gives the SM e_blk
//          independent dependency chains; each expert's W_hh lives in
//          dynamic shared memory, which bounds e_blk; e_blk must divide E.
//   t_blk  steps of proj per CTA held in shared memory; t_blk must divide T.
//   rows   the batch tile, a Hopper axis the TPU block did not have (there a
//          block held every row).  Ragged rows are masked.
//
// The bf16 dot (gru_fwd_blocked_mma_kernel, f32 or bf16 io): tensor cores,
// the fragment code of gru_fwd.cu's gru_fwd_mma_kernel (gru_mma.cuh).  Warp
// w of the H/16 warps owns hidden units [16w, 16w+16) of r, z and n; per
// step and expert it runs mma.sync m16n8k16 over H/16 k-steps with A = the
// bf16 h tile [2][rows][H+8] through ldmatrix and B = W_hh [H][3H+8] (rows
// padded by 16 bytes against ldmatrix bank conflicts) through ldmatrix.trans,
// so a lane holds the r, z and n pre-activations of the same 8 (row, unit)
// elements and its float carry stays in registers in that layout.  rows is
// 16 or 32: one or two m16 tiles, run as independent chains that share
// each W_hh fragment; each expert of the block adds its own chains within
// the step.  8 rows are refused by the plan rather than run as a half-empty
// tile.  Ragged rows enter A as zeros and are never stored.  f32 io
// converts W_hh to bf16 while staging it.
//   Proj: at t_blk = 1 each lane loads its own proj elements from device
// memory into registers one step ahead (right after its expert's gate math
// of the step before), as gru_fwd_mma_kernel does: a 12 KiB shared slot
// would cost the (16 rows, 1 expert) blocking its second CTA per SM.  At
// t_blk > 1 the CTA's proj rows go through a ring of t_blk one-step slots
// with cp.async: the prologue issues steps 0..t_blk-1, and step s refills
// the slot of step s-1 with step s-1+t_blk right after the barrier that
// ends every read of it, so each copy has t_blk-1 steps of compute to land
// and each step waits only on its own slot.  The ring is single-buffered on
// purpose: a double buffer of two t_blk-step blocks would need twice the
// bytes and halve the t_blk that fits beside W_hh (9 steps at H=128 and
// 16 rows, against 4), for no more overlap than the ring already gives.
// Ring rows are padded by 16 bytes, as the other tiles.
//   Shared memory per expert: W_hh 2H(3H+8), the h tile 4 rows (H+8), and at
// t_blk > 1 the ring t_blk rows (3H io + 16) bytes.  At H=128, 16 rows and
// one expert: 100,352 + 8,704 = 109,056 bytes, as K1, two CTAs an SM.
//
// The float dot (gru_fwd_blocked_tf32_kernel, f32 or bf16 io): 3xTF32 on
// the tensor cores in the layout of gru_fwd.cu's float forms (K1, K2): warp
// w of the ceil(H/8) warps owns units [8w, 8w+8) of r, z and n, mma.sync
// m16n8k8 over round8(H)/8 k steps, each f32 operand split into a TF32
// big half and its remainder (gru_mma.cuh), since one TF32 product would
// break the 1e-5 tolerance.  Per expert W_hh stays in the io type in
// padded rows [H][3H+8] and is widened and split as each B fragment is
// loaded; a bf16 value is exact in TF32 (its small half is zero), so bf16
// io runs two products, a_big b + a_small b, for the same error.  The carry
// tile is f32 [2][rows][round8(H)+4] and is split at its A fragment load.
// rows is 8, 16 or 32: half an m16 tile (rows 8..15 zero in A, never
// loaded or stored), one or two.  Proj goes through registers at t_blk = 1
// and through the cp.async ring above at t_blk > 1 (with bf16 io that takes
// H % 8 == 0, 16-byte rows).  Every global load reads a row and unit that
// exist and is masked where used, and the out stores are predicated
// instructions, so no lane-dependent branch sits before a mma.sync.aligned
// (a warp that reaches one diverged never finishes it).  At H=128, f32 io,
// one expert: 200,704 + 8,448 = 209,152 bytes at 8 rows, 217,600 (K1's)
// at 16; a ring of even 2 steps of 8 rows (24,832) no longer fits beside
// the f32 W_hh, so f32 io takes t_blk = 1 there.
//
// The wrapper's plan (ops/cuda_gru.py block_plan) refuses a blocking above
// the opt-in limit, or one no instantiation takes, before launching.
//
// Bound at the sweep's shape (E=80, T=60, B=32, H=128), bf16 inputs:
//   bytes = proj 118.0 MB + out (float) 78.6 MB + W_hh 7.9 MB + h0, b_hh
//           1.4 MB = 205.9 MB  -> 0.061 ms at 3.35 TB/s
//   FLOPs = 2*80*60*32*128*384 = 15.1 GFLOP -> 0.015 ms at 989 TFLOP/s
// so bytes bound it; with float inputs 331.7 MB (0.099 ms) against three
// TF32 products of 15.1 GFLOP (0.092 ms at 495 TFLOP/s; 0.225 ms on FMA at
// 67).  At B=32 the 60 dependent steps set the latency: the design keeps
// each step to its mma chains, one barrier and proj loads issued ahead.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

#include "gru_mma.cuh"

namespace {

using namespace gru_mma;
using bf16 = __nv_bfloat16;

constexpr int kMmaRows = 16;          // rows of one m16 tile
constexpr int kMmaMaxThreads = 256;   // H/16 warps: H <= 128
// The float dot, as gru_fwd.cu's float forms: floats after each W_hh and
// carry tile row, hidden units a warp owns, and the threads of the largest
// H it takes (17 warps: H <= 136).
constexpr int kTf32WPad = 8;
constexpr int kTf32HPad = 4;
constexpr int kTf32Units = 8;
constexpr int kTf32MaxThreads = 544;

__host__ __device__ __forceinline__ int round_up(int n, int m) {
  return (n + m - 1) / m * m;
}

// Elements of one padded bf16 row (W_hh, the h tile): 16 bytes more.
__host__ __device__ __forceinline__ int padded(int n) { return n + 8; }

// Shared bytes of one expert of the tensor-core form.
__host__ __device__ __forceinline__ size_t mma_expert_bytes(int H, int rows, int t_blk,
                                                            int io_bytes) {
  size_t bytes = ((size_t)H * padded(3 * H) + 2 * (size_t)rows * padded(H)) * 2;
  if (t_blk > 1) bytes += (size_t)t_blk * rows * ((size_t)3 * H * io_bytes + 16);
  return bytes;
}

// Shared bytes of one expert of the float-dot form: W_hh [H][3H+8] in the
// io type, the f32 carry tile [2][rows][round8(H)+4], the ring as above.
__host__ __device__ __forceinline__ size_t tf32_expert_bytes(int H, int rows, int t_blk,
                                                             int io_bytes) {
  size_t bytes = (size_t)H * (3 * H + kTf32WPad) * io_bytes +
                 2 * (size_t)rows * (round_up(H, 8) + kTf32HPad) * sizeof(float);
  if (t_blk > 1) bytes += (size_t)t_blk * rows * ((size_t)3 * H * io_bytes + 16);
  return bytes;
}

size_t smem_bytes(int H, int rows, int e_blk, int t_blk, int io_bf16, int bf16_dot) {
  const int io_bytes = io_bf16 ? 2 : 4;
  return (size_t)e_blk * (bf16_dot ? mma_expert_bytes(H, rows, t_blk, io_bytes)
                                   : tf32_expert_bytes(H, rows, t_blk, io_bytes));
}

// ---------------------------------------------------------------------------
// the bf16 dot: tensor cores
// ---------------------------------------------------------------------------

// Two neighbouring io elements of proj held in registers as loaded (bf16:
// one 32-bit pair), so a load issued ahead is not waited on until used.
template <typename T> struct Raw2;
template <> struct Raw2<bf16> {
  uint32_t v;
  __device__ __forceinline__ void load(const bf16* p) { v = load_pair(p); }
  __device__ __forceinline__ void zero() { v = 0u; }
  __device__ __forceinline__ float2 get() const { return unpack_bf16x2(v); }
};
template <> struct Raw2<float> {
  float2 v;
  __device__ __forceinline__ void load(const float* p) {
    v = *reinterpret_cast<const float2*>(p);
  }
  __device__ __forceinline__ void zero() { v = make_float2(0.0f, 0.0f); }
  __device__ __forceinline__ float2 get() const { return v; }
};

// 8 io elements at src (16- or 32-byte aligned) as 8 bf16 at dst.
__device__ __forceinline__ void stage8(bf16* dst, const bf16* src) {
  *reinterpret_cast<uint4*>(dst) = *reinterpret_cast<const uint4*>(src);
}
__device__ __forceinline__ void stage8(bf16* dst, const float* src) {
  const float4 lo = *reinterpret_cast<const float4*>(src);
  const float4 hi = *reinterpret_cast<const float4*>(src + 4);
  *reinterpret_cast<uint4*>(dst) =
      make_uint4(pack_bf16x2(lo.x, lo.y), pack_bf16x2(lo.z, lo.w),
                 pack_bf16x2(hi.x, hi.y), pack_bf16x2(hi.z, hi.w));
}

// Wait until at most n committed cp.async groups are in flight; above 3 it
// waits for more than it must, which is safe.
__device__ __forceinline__ void cp_async_wait_upto(int n) {
  if (n <= 0)
    cp_async_wait<0>();
  else if (n == 1)
    cp_async_wait<1>();
  else if (n == 2)
    cp_async_wait<2>();
  else
    cp_async_wait<3>();
}

// One chain (expert, m tile) at a time needs few registers; the single-chain
// form is held to 128 a thread so two 256-thread CTAs share an SM.
template <typename TIO, int kEBlk, int kMTiles>
__global__ void __launch_bounds__(kMmaMaxThreads, kEBlk * kMTiles == 1 ? 2 : 1)
gru_fwd_blocked_mma_kernel(const TIO* __restrict__ proj, const TIO* __restrict__ w_hh,
                           const float* __restrict__ b_hh, const float* __restrict__ h0,
                           float* __restrict__ out, int n_t, int n_b, int H, int t_blk) {
  extern __shared__ __align__(16) unsigned char smem[];
  constexpr int kRows = kMTiles * kMmaRows;
  const int G3 = 3 * H;
  const int w_ld = padded(G3), h_ld = padded(H);
  const int x_ld = G3 + 16 / (int)sizeof(TIO);
  const bool staged = t_blk > 1;
  const size_t expert_bytes = mma_expert_bytes(H, kRows, t_blk, sizeof(TIO));
  // expert i: W_hh [H][w_ld], h tile [2][kRows][h_ld] (bf16), ring
  // [t_blk][kRows][x_ld] (io type)
  auto w_s = [&](int i) { return reinterpret_cast<bf16*>(smem + i * expert_bytes); };
  auto h_s = [&](int i) { return w_s(i) + (size_t)H * w_ld; };
  auto x_s = [&](int i) { return reinterpret_cast<TIO*>(h_s(i) + 2 * kRows * h_ld); };

  const int e0 = blockIdx.y * kEBlk;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = frag_row(lane);
  const int tile0 = blockIdx.x * kRows;

#pragma unroll
  for (int i = 0; i < kEBlk; ++i) {
    const TIO* w_e = w_hh + (size_t)(e0 + i) * H * G3;
    bf16* w_d = w_s(i);
    const int vec_per_row = G3 / 8;
    for (int idx = threadIdx.x; idx < H * vec_per_row; idx += blockDim.x) {
      const int r = idx / vec_per_row, c = (idx - r * vec_per_row) * 8;
      stage8(w_d + (size_t)r * w_ld + c, w_e + (size_t)r * G3 + c);
    }
  }

  // This lane's elements: rows g + 8 rr of each m tile, units u[hf], +1.
  int u[2];
  u[0] = 16 * warp + frag_col(lane);
  u[1] = u[0] + 8;
  int row[kMTiles][2];
  bool valid[kMTiles][2];
#pragma unroll
  for (int mt = 0; mt < kMTiles; ++mt)
#pragma unroll
    for (int rr = 0; rr < 2; ++rr) {
      row[mt][rr] = tile0 + kMmaRows * mt + g + 8 * rr;
      valid[mt][rr] = row[mt][rr] < n_b;
    }

  float bias[kEBlk][3][2][2];                    // [i][gate][hf][unit pair]
  float h[kEBlk][kMTiles][2][2][2];              // [i][mt][rr][hf][unit pair]
#pragma unroll
  for (int i = 0; i < kEBlk; ++i) {
    const float* b_e = b_hh + (size_t)(e0 + i) * G3;
#pragma unroll
    for (int gate = 0; gate < 3; ++gate)
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        bias[i][gate][hf][0] = b_e[gate * H + u[hf]];
        bias[i][gate][hf][1] = b_e[gate * H + u[hf] + 1];
      }
#pragma unroll
    for (int mt = 0; mt < kMTiles; ++mt)
#pragma unroll
      for (int rr = 0; rr < 2; ++rr)
#pragma unroll
        for (int hf = 0; hf < 2; ++hf) {
          float2 v = make_float2(0.0f, 0.0f);
          if (valid[mt][rr])
            v = *reinterpret_cast<const float2*>(
                h0 + ((size_t)(e0 + i) * n_b + row[mt][rr]) * H + u[hf]);
          h[i][mt][rr][hf][0] = v.x;
          h[i][mt][rr][hf][1] = v.y;
          store_pair(h_s(i) + (kMmaRows * mt + g + 8 * rr) * h_ld + u[hf],
                     pack_bf16x2(v.x, v.y));
        }
  }

  // t_blk > 1: step s's proj rows of every expert into ring slot s % t_blk,
  // 16 bytes a copy, zeros for ragged rows; one commit group per call.
  auto issue = [&](int s) {
    const int slot = s % t_blk;
    const int vec_per_row = G3 * (int)sizeof(TIO) / 16;
    const int per_vec = 16 / (int)sizeof(TIO);
#pragma unroll
    for (int i = 0; i < kEBlk; ++i) {
      const TIO* src = proj + (((size_t)(e0 + i) * n_t + s) * n_b + tile0) * G3;
      TIO* dst = x_s(i) + (size_t)slot * kRows * x_ld;
      for (int idx = threadIdx.x; idx < kRows * vec_per_row; idx += blockDim.x) {
        const int r = idx / vec_per_row, c = (idx - r * vec_per_row) * per_vec;
        const bool full = tile0 + r < n_b;
        cp_async16(dst + (size_t)r * x_ld + c, full ? src + (size_t)r * G3 + c : proj,
                   full);
      }
    }
    cp_async_commit();
  };

  // t_blk = 1: expert i's proj elements of step s into registers.
  Raw2<TIO> x[kEBlk][kMTiles][3][2][2];          // [i][mt][gate][rr][hf]
  auto load_x = [&](int i, int s) {
#pragma unroll
    for (int mt = 0; mt < kMTiles; ++mt)
#pragma unroll
      for (int rr = 0; rr < 2; ++rr) {
        const TIO* p = proj + (((size_t)(e0 + i) * n_t + s) * n_b + row[mt][rr]) * G3;
#pragma unroll
        for (int gate = 0; gate < 3; ++gate)
#pragma unroll
          for (int hf = 0; hf < 2; ++hf) {
            if (valid[mt][rr])
              x[i][mt][gate][rr][hf].load(p + gate * H + u[hf]);
            else
              x[i][mt][gate][rr][hf].zero();
          }
      }
  };

  if (staged) {
    for (int s = 0; s < t_blk; ++s) issue(s);
  } else {
#pragma unroll
    for (int i = 0; i < kEBlk; ++i) load_x(i, 0);
  }

  for (int s = 0; s < n_t; ++s) {
    // Groups committed so far carry steps 0 .. s+t_blk-2 in order, so step
    // s's own copies have landed once at most t_blk-2 remain in flight.
    if (staged) cp_async_wait_upto(t_blk - 2);
    // Every h tile of step s and every copy of slot s are visible, and every
    // read of step s-1 (its h tile, its ring slot) is done.
    __syncthreads();
    if (staged && s >= 1) {
      if (s - 1 + t_blk < n_t)
        issue(s - 1 + t_blk);
      else
        cp_async_commit();                       // keep one group a step
    }
    const int cur = s & 1;
#pragma unroll
    for (int i = 0; i < kEBlk; ++i) {            // time outer, experts inner
      const bf16* w_i = w_s(i);
      const bf16* h_cur = h_s(i) + cur * kRows * h_ld;
      bf16* h_nxt = h_s(i) + (cur ^ 1) * kRows * h_ld;

      // acc[mt][gate][hf] = columns gate*H + 16 warp + 8 hf .. +7 of h . W_hh
      float acc[kMTiles][3][2][4];
#pragma unroll
      for (int mt = 0; mt < kMTiles; ++mt)
#pragma unroll
        for (int gate = 0; gate < 3; ++gate)
#pragma unroll
          for (int hf = 0; hf < 2; ++hf)
#pragma unroll
            for (int c = 0; c < 4; ++c) acc[mt][gate][hf][c] = 0.0f;
#pragma unroll 2
      for (int k0 = 0; k0 < H; k0 += 16) {
        uint32_t a[kMTiles][4];
#pragma unroll
        for (int mt = 0; mt < kMTiles; ++mt)
          load_a(a[mt], h_cur + kMmaRows * mt * h_ld + k0, h_ld, lane);
#pragma unroll
        for (int gate = 0; gate < 3; ++gate) {
          uint32_t b[4];
          load_b_trans(b, w_i + (size_t)k0 * w_ld + gate * H + 16 * warp, w_ld, lane);
#pragma unroll
          for (int mt = 0; mt < kMTiles; ++mt) {
            mma_bf16(acc[mt][gate][0], a[mt], b[0], b[1]);
            mma_bf16(acc[mt][gate][1], a[mt], b[2], b[3]);
          }
        }
      }

      const TIO* xs = x_s(i) + (size_t)(s % t_blk) * kRows * x_ld;
      float* o_t = out + ((size_t)(e0 + i) * n_t + s) * n_b * H;
#pragma unroll
      for (int mt = 0; mt < kMTiles; ++mt)
#pragma unroll
        for (int rr = 0; rr < 2; ++rr) {
          const int local = kMmaRows * mt + g + 8 * rr;
#pragma unroll
          for (int hf = 0; hf < 2; ++hf) {
            float2 xv[3];
#pragma unroll
            for (int gate = 0; gate < 3; ++gate) {
              if (staged) {
                Raw2<TIO> r2;
                r2.load(xs + (size_t)local * x_ld + gate * H + u[hf]);
                xv[gate] = r2.get();
              } else {
                xv[gate] = x[i][mt][gate][rr][hf].get();
              }
            }
            const float xr[2] = {xv[0].x, xv[0].y}, xz[2] = {xv[1].x, xv[1].y};
            const float xn[2] = {xv[2].x, xv[2].y};
            float hv[2];
#pragma unroll
            for (int c = 0; c < 2; ++c) {
              const float g_r = acc[mt][0][hf][2 * rr + c] + bias[i][0][hf][c];
              const float g_z = acc[mt][1][hf][2 * rr + c] + bias[i][1][hf][c];
              const float g_n = acc[mt][2][hf][2 * rr + c] + bias[i][2][hf][c];
              const float r = sigmoid_f32(xr[c] + g_r);
              const float z = sigmoid_f32(xz[c] + g_z);
              const float n = tanhf(xn[c] + r * g_n);
              hv[c] = (1.0f - z) * n + z * h[i][mt][rr][hf][c];
              h[i][mt][rr][hf][c] = hv[c];
            }
            if (valid[mt][rr])
              *reinterpret_cast<float2*>(o_t + (size_t)row[mt][rr] * H + u[hf]) =
                  make_float2(hv[0], hv[1]);
            store_pair(h_nxt + local * h_ld + u[hf],
                       valid[mt][rr] ? pack_bf16x2(hv[0], hv[1]) : 0u);
          }
        }
      // this expert's next proj, in flight across the barrier and the next
      // step's products
      if (!staged && s + 1 < n_t) load_x(i, s + 1);
    }
  }
}

// ---------------------------------------------------------------------------
// the float dot: 3xTF32 on the tensor cores
// ---------------------------------------------------------------------------

// 4 io elements as they lie (float: 16 bytes, bf16: 8), to stage W_hh.
template <typename T> struct Vec4;
template <> struct Vec4<float> { using type = float4; };
template <> struct Vec4<bf16> { using type = uint2; };

// 16 bytes global -> shared on lanes where `pred` holds (cp_async16
// otherwise): a predicated instruction, so no branch parts the warp.
__device__ __forceinline__ void cp_async16_if(void* dst, const void* src, bool full,
                                              bool pred) {
  asm volatile("{\n .reg .pred p;\n setp.ne.b32 p, %3, 0;\n"
               " @p cp.async.cg.shared.global [%0], [%1], 16, %2;\n}\n"
               :: "r"(smem_addr(dst)), "l"(src), "r"(full ? 16 : 0), "r"((int)pred)
               : "memory");
}

// *p = v on lanes where `pred` holds, one predicated store: the next
// expert's mma.sync.aligned of the step finds the warp converged.
__device__ __forceinline__ void store_f2_if(float* p, float2 v, bool pred) {
  asm volatile("{\n .reg .pred p;\n setp.ne.b32 p, %3, 0;\n"
               " @p st.global.v2.f32 [%0], {%1, %2};\n}\n"
               :: "l"(p), "f"(v.x), "f"(v.y), "r"((int)pred)
               : "memory");
}

// The A fragment of one m16 tile of the carry; an 8-row tile gives zeros
// for rows 8..15, never loaded.
template <int kRows>
__device__ __forceinline__ SplitFrag<4> load_a_rows(const float* tile, int ld, int lane) {
  if constexpr (kRows < kMmaRows) {
    const int g = frag_row(lane), t = lane & 3;
    SplitFrag<4> a;
    split_tf32(tile[g * ld + t], a.big[0], a.small[0]);
    split_tf32(tile[g * ld + t + 4], a.big[2], a.small[2]);
    a.big[1] = a.small[1] = a.big[3] = a.small[3] = 0u;
    return a;
  } else {
    return load_a_tf32(tile, ld, lane);
  }
}

// kRows batch rows a CTA (8: half an m16 tile; 16, 32: one or two tiles).
template <typename TIO, int kEBlk, int kRows>
__global__ void __launch_bounds__(kTf32MaxThreads, 1)
gru_fwd_blocked_tf32_kernel(const TIO* __restrict__ proj, const TIO* __restrict__ w_hh,
                            const float* __restrict__ b_hh, const float* __restrict__ h0,
                            float* __restrict__ out, int n_t, int n_b, int H, int t_blk) {
  extern __shared__ __align__(16) unsigned char smem[];
  constexpr int kMTiles = kRows < kMmaRows ? 1 : kRows / kMmaRows;
  constexpr int kRR = kRows < kMmaRows ? 1 : 2;  // rows g + 8 rr of a tile
  constexpr bool kExactW = sizeof(TIO) == 2;     // bf16 W_hh is exact in TF32
  const int G3 = 3 * H;
  const int w_ld = G3 + kTf32WPad;
  const int h_ld = round_up(H, 8) + kTf32HPad;
  const int x_ld = G3 + 16 / (int)sizeof(TIO);
  const bool staged = t_blk > 1;
  const size_t expert_bytes = tf32_expert_bytes(H, kRows, t_blk, sizeof(TIO));
  // expert i: W_hh [H][w_ld] (io type), carry tile [2][kRows][h_ld] (float),
  // ring [t_blk][kRows][x_ld] (io type)
  auto w_s = [&](int i) { return reinterpret_cast<TIO*>(smem + i * expert_bytes); };
  auto h_s = [&](int i) {
    return reinterpret_cast<float*>(smem + i * expert_bytes + (size_t)H * w_ld * sizeof(TIO));
  };
  auto x_s = [&](int i) { return reinterpret_cast<TIO*>(h_s(i) + 2 * kRows * h_ld); };

  const int e0 = blockIdx.y * kEBlk;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = frag_row(lane), t = lane & 3;
  const int tile0 = blockIdx.x * kRows;

  // W_hh of every expert into padded rows, 4 elements a copy, the pads
  // zeroed; every carry tile zeroed (units H .. round8(H)-1 stay zero).
  using V4 = typename Vec4<TIO>::type;
  const int vec_per_row = w_ld / 4;
#pragma unroll
  for (int i = 0; i < kEBlk; ++i) {
    const TIO* w_e = w_hh + (size_t)(e0 + i) * H * G3;
    TIO* w_d = w_s(i);
    for (int idx = threadIdx.x; idx < H * vec_per_row; idx += blockDim.x) {
      const int r = idx / vec_per_row, c = (idx - r * vec_per_row) * 4;
      V4 v{};
      if (c < G3) v = *reinterpret_cast<const V4*>(w_e + (size_t)r * G3 + c);
      *reinterpret_cast<V4*>(w_d + (size_t)r * w_ld + c) = v;
    }
    float* h_i = h_s(i);
    for (int idx = threadIdx.x; idx < 2 * kRows * h_ld; idx += blockDim.x) h_i[idx] = 0.0f;
  }

  // This lane's elements: rows g + 8 rr of each m tile, units u and u + 1
  // (both below H or both not).  Every global load of the kernel reads a
  // row and unit that exist (row_in, u_in) and the value is masked where
  // used, so no load sits under a lane-dependent branch.
  const int u = kTf32Units * warp + frag_col(lane);
  const bool unit_ok = u < H;
  const int u_in = unit_ok ? u : 0;
  int row[kMTiles][kRR], row_in[kMTiles][kRR];
  bool keep[kMTiles][kRR];                        // a row and units that exist
#pragma unroll
  for (int mt = 0; mt < kMTiles; ++mt)
#pragma unroll
    for (int rr = 0; rr < kRR; ++rr) {
      row[mt][rr] = tile0 + kMmaRows * mt + g + 8 * rr;
      row_in[mt][rr] = min(row[mt][rr], n_b - 1);
      keep[mt][rr] = row[mt][rr] < n_b && unit_ok;
    }

  float bias[kEBlk][3][2];                        // [i][gate][unit pair]
  float h[kEBlk][kMTiles][kRR][2];                // [i][mt][rr][unit pair]
#pragma unroll
  for (int i = 0; i < kEBlk; ++i) {
    const float* b_e = b_hh + (size_t)(e0 + i) * G3;
#pragma unroll
    for (int gate = 0; gate < 3; ++gate) {
      bias[i][gate][0] = b_e[gate * H + u_in];
      bias[i][gate][1] = b_e[gate * H + u_in + 1];
    }
  }
  __syncthreads();                                // the tiles are zeroed
#pragma unroll
  for (int i = 0; i < kEBlk; ++i)
#pragma unroll
    for (int mt = 0; mt < kMTiles; ++mt)
#pragma unroll
      for (int rr = 0; rr < kRR; ++rr) {
        const float2 v = *reinterpret_cast<const float2*>(
            h0 + ((size_t)(e0 + i) * n_b + row_in[mt][rr]) * H + u_in);
        const float2 hv = keep[mt][rr] ? v : make_float2(0.0f, 0.0f);
        h[i][mt][rr][0] = hv.x;
        h[i][mt][rr][1] = hv.y;
        *reinterpret_cast<float2*>(h_s(i) + (kMmaRows * mt + g + 8 * rr) * h_ld + u) = hv;
      }

  // t_blk > 1: step s's proj rows of every expert into ring slot s % t_blk,
  // 16 bytes a copy, zeros for ragged rows; the loop's trip count is the
  // warp's, its last copies predicated off; one commit group per call.
  auto issue = [&](int s) {
    const int slot = s % t_blk;
    const int vec_row = G3 * (int)sizeof(TIO) / 16;
    const int per_vec = 16 / (int)sizeof(TIO);
    const int n_vec = kRows * vec_row;
#pragma unroll
    for (int i = 0; i < kEBlk; ++i) {
      const TIO* src = proj + (((size_t)(e0 + i) * n_t + s) * n_b + tile0) * G3;
      TIO* dst = x_s(i) + (size_t)slot * kRows * x_ld;
      for (int base = threadIdx.x - lane; base < n_vec; base += blockDim.x) {
        const int idx = base + lane;
        const int r = idx / vec_row, c = (idx - r * vec_row) * per_vec;
        const bool full = tile0 + r < n_b;
        cp_async16_if(dst + (size_t)r * x_ld + c, full ? src + (size_t)r * G3 + c : proj,
                      full, idx < n_vec);
      }
    }
    cp_async_commit();
  };

  // t_blk = 1: expert i's proj elements of step s into registers.
  Raw2<TIO> x[kEBlk][kMTiles][3][kRR];            // [i][mt][gate][rr]
  auto load_x = [&](int i, int s) {
#pragma unroll
    for (int mt = 0; mt < kMTiles; ++mt)
#pragma unroll
      for (int rr = 0; rr < kRR; ++rr) {
        const TIO* p = proj + (((size_t)(e0 + i) * n_t + s) * n_b + row_in[mt][rr]) * G3 + u_in;
#pragma unroll
        for (int gate = 0; gate < 3; ++gate) x[i][mt][gate][rr].load(p + gate * H);
      }
  };

  if (staged) {
    for (int s = 0; s < t_blk; ++s) issue(s);
  } else {
#pragma unroll
    for (int i = 0; i < kEBlk; ++i) load_x(i, 0);
  }

  for (int s = 0; s < n_t; ++s) {
    // the ring and the barrier as in gru_fwd_blocked_mma_kernel
    if (staged) cp_async_wait_upto(t_blk - 2);
    __syncthreads();
    if (staged && s >= 1) {
      if (s - 1 + t_blk < n_t)
        issue(s - 1 + t_blk);
      else
        cp_async_commit();
    }
    const int cur = s & 1;
#pragma unroll
    for (int i = 0; i < kEBlk; ++i) {             // time outer, experts inner
      const TIO* w_i = w_s(i);
      const float* h_cur = h_s(i) + cur * kRows * h_ld;
      float* h_nxt = h_s(i) + (cur ^ 1) * kRows * h_ld;

      // acc[mt][gate] + cor[mt][gate] = columns gate*H + 8 warp .. +7 of
      // h . W_hh for m tile mt
      float acc[kMTiles][3][4], cor[kMTiles][3][4];
#pragma unroll
      for (int mt = 0; mt < kMTiles; ++mt)
#pragma unroll
        for (int gate = 0; gate < 3; ++gate)
#pragma unroll
          for (int c = 0; c < 4; ++c) acc[mt][gate][c] = cor[mt][gate][c] = 0.0f;
      auto k_step = [&](int k0, const TIO* w0, const TIO* w1) {
        SplitFrag<4> a[kMTiles];
#pragma unroll
        for (int mt = 0; mt < kMTiles; ++mt)
          a[mt] = load_a_rows<kRows>(h_cur + kMmaRows * mt * h_ld + k0, h_ld, lane);
#pragma unroll
        for (int gate = 0; gate < 3; ++gate) {
          if constexpr (kExactW) {      // a_big b + a_small b: b's small half is 0
            const uint32_t b0 = __float_as_uint(to_f32(w0[gate * H]));
            const uint32_t b1 = __float_as_uint(to_f32(w1[gate * H]));
#pragma unroll
            for (int mt = 0; mt < kMTiles; ++mt) {
              mma_tf32(cor[mt][gate], a[mt].small, b0, b1);
              mma_tf32(acc[mt][gate], a[mt].big, b0, b1);
            }
          } else {
            const SplitFrag<2> b = split_b_tf32(w0[gate * H], w1[gate * H]);
#pragma unroll
            for (int mt = 0; mt < kMTiles; ++mt)
              mma_3xtf32(acc[mt][gate], cor[mt][gate], a[mt], b);
          }
        }
      };
      const TIO* w_col = w_i + (size_t)t * w_ld + kTf32Units * warp + g;
      const int k_full = H & ~7;
#pragma unroll 2
      for (int k0 = 0; k0 < k_full; k0 += 8)
        k_step(k0, w_col + (size_t)k0 * w_ld, w_col + (size_t)(k0 + 4) * w_ld);
      // H % 8 == 4: rows k_full + 4 .. +7 do not exist; their A columns are
      // zero, so B reads row k_full + t again
      if (k_full < H)
        k_step(k_full, w_col + (size_t)k_full * w_ld, w_col + (size_t)k_full * w_ld);

      const TIO* xs = x_s(i) + (size_t)(s % t_blk) * kRows * x_ld;
      float* o_t = out + ((size_t)(e0 + i) * n_t + s) * n_b * H;
#pragma unroll
      for (int mt = 0; mt < kMTiles; ++mt)
#pragma unroll
        for (int rr = 0; rr < kRR; ++rr) {
          const int local = kMmaRows * mt + g + 8 * rr;
          float2 xv[3];
#pragma unroll
          for (int gate = 0; gate < 3; ++gate) {
            if (staged) {
              Raw2<TIO> r2;
              r2.load(xs + (size_t)local * x_ld + gate * H + u);
              xv[gate] = r2.get();
            } else {
              xv[gate] = x[i][mt][gate][rr].get();
            }
          }
          const float xr[2] = {xv[0].x, xv[0].y}, xz[2] = {xv[1].x, xv[1].y};
          const float xn[2] = {xv[2].x, xv[2].y};
#pragma unroll
          for (int c = 0; c < 2; ++c) {
            const int d = 2 * rr + c;
            const float g_r = acc[mt][0][d] + cor[mt][0][d] + bias[i][0][c];
            const float g_z = acc[mt][1][d] + cor[mt][1][d] + bias[i][1][c];
            const float g_n = acc[mt][2][d] + cor[mt][2][d] + bias[i][2][c];
            const float r = sigmoid_f32(xr[c] + g_r);
            const float z = sigmoid_f32(xz[c] + g_z);
            const float n = tanhf(xn[c] + r * g_n);
            h[i][mt][rr][c] = (1.0f - z) * n + z * h[i][mt][rr][c];
          }
          const float2 hv = keep[mt][rr] ? make_float2(h[i][mt][rr][0], h[i][mt][rr][1])
                                         : make_float2(0.0f, 0.0f);
          store_f2_if(o_t + (size_t)row[mt][rr] * H + u, hv, keep[mt][rr]);
          *reinterpret_cast<float2*>(h_nxt + local * h_ld + u) = hv;
        }
      // this expert's next proj, in flight across the barrier and the next
      // step's products
      if (!staged && s + 1 < n_t) load_x(i, s + 1);
    }
  }
}

// ---------------------------------------------------------------------------
// launch
// ---------------------------------------------------------------------------

template <typename TIO, int kEBlk, int kMTiles>
int launch_mma(const void* proj, const void* w_hh, const void* b_hh, const void* h0,
               void* out, int E, int n_t, int n_b, int H, int t_blk,
               cudaStream_t stream) {
  constexpr int kRows = kMTiles * kMmaRows;
  const size_t smem = smem_bytes(H, kRows, kEBlk, t_blk, sizeof(TIO) == 2, 1);
  const auto kernel = gru_fwd_blocked_mma_kernel<TIO, kEBlk, kMTiles>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((n_b + kRows - 1) / kRows, E / kEBlk);
  const dim3 block((H / 16) * 32);
  kernel<<<grid, block, smem, stream>>>(
      static_cast<const TIO*>(proj), static_cast<const TIO*>(w_hh),
      static_cast<const float*>(b_hh), static_cast<const float*>(h0),
      static_cast<float*>(out), n_t, n_b, H, t_blk);
  return (int)cudaGetLastError();
}

template <typename TIO, int kEBlk, int kRows>
int launch_tf32(const void* proj, const void* w_hh, const void* b_hh, const void* h0,
                void* out, int E, int n_t, int n_b, int H, int t_blk,
                cudaStream_t stream) {
  const size_t smem = smem_bytes(H, kRows, kEBlk, t_blk, sizeof(TIO) == 2, 0);
  const auto kernel = gru_fwd_blocked_tf32_kernel<TIO, kEBlk, kRows>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((n_b + kRows - 1) / kRows, E / kEBlk);
  const dim3 block(32 * ((H + kTf32Units - 1) / kTf32Units));
  kernel<<<grid, block, smem, stream>>>(
      static_cast<const TIO*>(proj), static_cast<const TIO*>(w_hh),
      static_cast<const float*>(b_hh), static_cast<const float*>(h0),
      static_cast<float*>(out), n_t, n_b, H, t_blk);
  return (int)cudaGetLastError();
}

// The instantiation of one io type and e_blk at `rows`: the bf16 dot in
// one or two m16 tiles, the float dot in half a tile, one or two.
template <typename TIO, int kEBlk>
int launch_rows(int bf16_dot, int rows, const void* proj, const void* w_hh,
                const void* b_hh, const void* h0, void* out, int E, int n_t, int n_b,
                int H, int t_blk, cudaStream_t stream) {
  if (bf16_dot) {
    switch (rows) {
      case kMmaRows:
        return launch_mma<TIO, kEBlk, 1>(proj, w_hh, b_hh, h0, out, E, n_t, n_b, H,
                                         t_blk, stream);
      case 2 * kMmaRows:
        return launch_mma<TIO, kEBlk, 2>(proj, w_hh, b_hh, h0, out, E, n_t, n_b, H,
                                         t_blk, stream);
      default:
        return (int)cudaErrorInvalidValue;
    }
  }
  switch (rows) {
    case kMmaRows / 2:
      return launch_tf32<TIO, kEBlk, kMmaRows / 2>(proj, w_hh, b_hh, h0, out, E, n_t,
                                                   n_b, H, t_blk, stream);
    case kMmaRows:
      return launch_tf32<TIO, kEBlk, kMmaRows>(proj, w_hh, b_hh, h0, out, E, n_t, n_b,
                                               H, t_blk, stream);
    case 2 * kMmaRows:
      return launch_tf32<TIO, kEBlk, 2 * kMmaRows>(proj, w_hh, b_hh, h0, out, E, n_t,
                                                   n_b, H, t_blk, stream);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

template <typename TIO>
int launch_io(int e_blk, int bf16_dot, const void* proj, const void* w_hh,
              const void* b_hh, const void* h0, void* out, int E, int n_t, int n_b,
              int H, int rows, int t_blk, cudaStream_t stream) {
  switch (e_blk) {
    case 1:
      return launch_rows<TIO, 1>(bf16_dot, rows, proj, w_hh, b_hh, h0, out, E, n_t,
                                 n_b, H, t_blk, stream);
    case 2:
      return launch_rows<TIO, 2>(bf16_dot, rows, proj, w_hh, b_hh, h0, out, E, n_t,
                                 n_b, H, t_blk, stream);
    case 4:
      return launch_rows<TIO, 4>(bf16_dot, rows, proj, w_hh, b_hh, h0, out, E, n_t,
                                 n_b, H, t_blk, stream);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// Dynamic shared memory one CTA needs (the wrapper's plan refuses a blocking
// above the opt-in limit before launching).
size_t gru_fwd_blocked_smem_bytes(int H, int rows, int e_blk, int t_blk,
                                  int io_bf16, int bf16_dot) {
  return smem_bytes(H, rows, e_blk, t_blk, io_bf16, bf16_dot);
}

int gru_fwd_blocked_tf32_max_threads(void) { return kTf32MaxThreads; }

int gru_fwd_blocked_mma_max_threads(void) { return kMmaMaxThreads; }

// Launch on `stream`; returns cudaGetLastError() (0 on success).  The caller
// has checked e_blk | E and t_blk | T, and: with bf16_dot, H % 16 == 0,
// H <= 128 and rows in {16, 32}; without it, H % 4 == 0, H <= 136, rows in
// {8, 16, 32} and, with bf16 io and t_blk > 1, H % 8 == 0.
int gru_fwd_blocked(const void* proj, const void* w_hh, const void* b_hh,
                    const void* h0, void* out, int E, int n_t, int n_b, int H,
                    int rows, int e_blk, int t_blk, int bf16, int bf16_dot,
                    void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (bf16)
    return launch_io<__nv_bfloat16>(e_blk, bf16_dot, proj, w_hh, b_hh, h0, out, E,
                                    n_t, n_b, H, rows, t_blk, st);
  return launch_io<float>(e_blk, bf16_dot, proj, w_hh, b_hh, h0, out, E, n_t, n_b, H,
                          rows, t_blk, st);
}

}  // extern "C"
