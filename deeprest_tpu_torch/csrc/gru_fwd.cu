// GRU forward recurrence over pre-projected inputs, inference and training
// forms.
//
// Replaces deeprest_tpu/ops/pallas_gru.py::_fwd_kernel: gru_fwd is the
// inference form (_fwd_call with emit_prev=False), gru_fwd_train the
// training form (emit_prev=True with STASH_GATES, launched by _vjp_fwd).
// Per expert e and batch row b:
//
//   g   = h . W_hh[e] + b_hh[e]                      (gate order r, z, n)
//   r   = sigmoid(x_r + g_r),  z = sigmoid(x_z + g_z)
//   n   = tanh(x_n + r * g_n)
//   h  <- (1 - z) * n + z * h                         written out every step
//
// where x = proj[e, t, b] = x_t . W_ih + b_ih was computed outside (one large
// GEMM per direction, left to cuBLAS like XLA did on the TPU).
//
// Layout and types (the dtype contract of ops/gru.py):
//   proj  [E, T, B, 3H]  io type (float or bf16)
//   w_hh  [E, H, 3H]     io type
//   b_hh  [E, 3H]        float
//   h0    [E, B, H]      float
//   out   [E, T, B, H]   io type
// and, in the training form only, two more streamed outputs per step:
//   h_prev [E, T, B, H]  io type: the carry before step t in scan order (under
//                        `reverse` that is the state after step t+1)
//   gates  [E, T, B, 3H] io type: the pre-activation hidden gates
//                        h . W_hh + b_hh, which the backward (gru_bwd.cu)
//                        reads instead of recomputing its dot; a null
//                        pointer (the stash off) skips these stores
// The carry and all gate math are float.  For bf16 the dot consumes h rounded
// to bf16 and W_hh in bf16; their products are exact in float and accumulate
// in float (the TPU kernel's bf16 dot with preferred_element_type=f32), here
// on the tensor cores.  For float both forms' dot runs 3xTF32 on the
// tensor cores (gru_mma.cuh): a plain TF32 product keeps 10 mantissa bits
// and would break the 1e-5 float tolerance, the split keeps about 21 (on
// an H100 2.0e-7 of scale from an f64 recurrence at the serving shape, the
// FMA form's 2.0e-7).
//
// Every form: one CTA per (row tile of 16 batch rows, expert);
// the time loop runs inside the CTA and replaces the TPU's sequential grid
// axis, so no time, expert or batch padding exists: ragged rows are masked
// here.  W_hh[e] is staged into dynamic shared memory once per CTA and read
// from there at every step; one __syncthreads per step separates the writes
// of step s's dot operand (a double-buffered shared tile) from the reads of
// step s+1.  `reverse` walks t from T-1 down to 0 and writes h_t at its own
// t, which equals flip -> run -> flip without the two copies.
//
// bf16 (gru_fwd_mma_kernel): tensor cores.  Warp w owns hidden units
// [16w, 16w+16).  Per step it computes the six n8 tiles of h . W_hh that are
// columns 16w..16w+15 of the r, z and n blocks with mma.sync m16n8k16 (H/16
// k-steps), so each lane holds the r, z and n pre-activations of the same 8
// (row, unit) elements (gru_mma.cuh: rows g and g+8, units 16w+c, +1, +8,
// +9): the gate math needs no exchange and the f32 carry stays in registers
// in that layout.  A = the bf16 h tile [2][16][H+8] through ldmatrix; B =
// W_hh [H][3H] as it lies (K x N, N contiguous) through ldmatrix.trans, its
// shared rows padded by 16 bytes so the 8 rows of one ldmatrix matrix fall
// on distinct banks.  Rows >= B enter A as zeros and are never stored.  The
// proj loads of step s+1 are issued at the start of step s, so their
// latency hides behind a whole step.  At H=128: 100,352 + 8,704 = 109,056
// bytes, two CTAs an SM.
//
// float (gru_fwd_tf32_kernel<kEmitPrev>, K1 and K2): the bf16 form's
// layout and gate math with 3xTF32 products, but warp w owns the 8 units
// [8w, 8w+8) of all three gates (three n8 tiles, ceil(H/8) warps): W_hh in
// f32 allows one CTA an SM, and 8 warps of 16 units left a step's
// dependent chain of loads, splits and mma.sync to 2 warps a scheduler;
// 16 warps of 8 units halve each warp's chain and double the warps that
// hide it, for one more split of the A fragment per warp (faster on the
// card than warps of 16 units).  W_hh stays f32 in
// shared memory, [H][3H+8] (the pad puts the 4 k rows of a B fragment on
// distinct banks), and each B value is split as it is loaded: a split
// copy would need twice the bytes.  The carry tile is f32 [2][16][K+4]
// (K = H rounded up to the k8 step, zero beyond H; the pad spreads the A
// fragment's 8 rows over the banks) and is split at its A fragment load
// too: a split copy beside W_hh would need 234,496 bytes at H=128, above
// one CTA's 232,448.  When H % 8 == 4 the last k step reads its 4 rows
// again for the 4 past H, against A zeros.  Units past H (H % 8 != 0) are
// computed on junk and never stored; the pad reads stay inside the row.
// At H=128: 200,704 + 16,896 = 217,600 bytes, one CTA an SM, 16 warps, and
// __launch_bounds__ of the 544 threads the largest admitted H (132)
// launches, so a thread may keep up to 120 registers.
//
// The training form (K2) is the same kernel instantiated with kEmitPrev:
// after the step's last mma.sync each lane also stores its h_prev pair
// (the carry before the update) and the three pre-activations acc + cor +
// b_hh exactly as its gate math uses them, so K3's stash reads the values
// K2 used, under the mask of the out store.  No lane-dependent load or
// store sits before a mma.sync.aligned of its step: a warp that reaches
// one diverged never finishes it.
//
// Bound at the flagship serving shape, per launch (one direction,
// E=40, T=60, B=256, H=128, bf16):
//   bytes = proj 40*60*256*384*2 = 472 MB + h 40*60*256*128*2 = 157 MB
//         = 629 MB  -> 0.19 ms at 3.35 TB/s
//   FLOPs = 2*40*60*256*128*384 = 60.4 GFLOP -> 0.061 ms at 989 TFLOP/s
// so device memory bounds it, and the 60-step dependent chain sets its
// latency.  The training form at the flagship training shape (B=32) moves
// proj 59 MB + h_all 20 + h_prev 20 + gates 59 + W_hh 4 = 161 MB
// (0.048 ms) for 7.5 GFLOP (0.008 ms): bytes again, though at B=32 the
// 16-row tiles give only 2 x 40 = 80 CTAs for 132 SMs.  The extra streams
// are stores from values the inference form already holds in registers.
// In float at that shape it moves proj 118 MB + h_all, h_prev 39 MB each
// + gates 118 + W_hh 8 = 323 MB (0.096 ms) for three TF32 products of 7.5
// GFLOP (0.046 ms at 495 TFLOP/s; 0.113 ms on FMA at 67).
// The float inference form at the serving shape moves proj 944 MB + h 315 MB +
// W_hh 8 MB = 1,266 MB (0.378 ms at 3.35 TB/s); its 60.4 GFLOP take 0.902 ms
// on FMA at 67 TFLOP/s and, as three TF32 products, 0.366 ms at 495
// TFLOP/s.  640 CTAs at one an SM are 4.85 waves.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

#include "gru_mma.cuh"

namespace {

using namespace gru_mma;
using bf16 = __nv_bfloat16;

constexpr int kRowTile = 16;     // batch rows a CTA runs: one m16 tile
constexpr int kRowGroups = 2;    // bf16: 2H threads, one warp per 16 units
constexpr int kMaxThreads = 512;

// Elements of one padded shared row: W_hh rows (3H) and h tile rows (H)
// of the bf16 form carry 8 more (16 bytes) against ldmatrix bank conflicts.
__host__ __device__ __forceinline__ int padded(int n) { return n + 8; }

// The float forms (K1 and K2): floats after each W_hh and h tile row,
// hidden units a warp owns, and the threads of the largest H whose W_hh
// fits (H <= 132: 17 warps).
constexpr int kTf32WPad = 8;
constexpr int kTf32HPad = 4;
constexpr int kTf32Units = 8;
constexpr int kTf32MaxThreads = 544;

__host__ __device__ __forceinline__ int round_up(int n, int m) {
  return (n + m - 1) / m * m;
}

// One CTA's dynamic shared memory, the same in the inference and the
// training form.
size_t smem_bytes(int H, int bf16) {
  if (bf16)   // W_hh [H][3H+8] and the h tile [2][16][H+8], bf16
    return ((size_t)H * padded(3 * H) + 2 * (size_t)kRowTile * padded(H)) * 2;
  // W_hh [H][3H+8] and the h tile [2][16][K+4], float
  return ((size_t)H * (3 * H + kTf32WPad) +
          2 * (size_t)kRowTile * (round_up(H, 8) + kTf32HPad)) * sizeof(float);
}

// The bf16 form: tensor-core products (see the design note at the top).
template <bool kEmitPrev>
__global__ void __launch_bounds__(kMaxThreads)
gru_fwd_mma_kernel(const bf16* __restrict__ proj, const bf16* __restrict__ w_hh,
                   const float* __restrict__ b_hh, const float* __restrict__ h0,
                   bf16* __restrict__ out, bf16* __restrict__ h_prev,
                   bf16* __restrict__ gates, int n_t, int n_b, int H, int reverse) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int G3 = 3 * H;
  const int w_ld = padded(G3), h_ld = padded(H);
  bf16* w_s = reinterpret_cast<bf16*>(smem);
  bf16* h_s = w_s + (size_t)H * w_ld;            // [2][kRowTile][h_ld]

  const int e = blockIdx.y;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = frag_row(lane);
  const int row0 = blockIdx.x * kRowTile;

  // W_hh[e] into padded rows, 16 bytes at a time.
  const bf16* w_e = w_hh + (size_t)e * H * G3;
  const int vec_per_row = G3 / 8;
  for (int i = threadIdx.x; i < H * vec_per_row; i += blockDim.x) {
    const int r = i / vec_per_row, c = (i - r * vec_per_row) * 8;
    *reinterpret_cast<uint4*>(w_s + (size_t)r * w_ld + c) =
        *reinterpret_cast<const uint4*>(w_e + (size_t)r * G3 + c);
  }

  // This lane's elements: rows g + 8 rr, units u[hf] and u[hf] + 1.
  int u[2];
  u[0] = 16 * warp + frag_col(lane);
  u[1] = u[0] + 8;
  int row[2];
  bool valid[2];
  float h[2][2][2];                              // [rr][hf][unit pair]
  float bias[3][2][2];                           // [gate][hf][unit pair]
  const float* b_e = b_hh + (size_t)e * G3;
#pragma unroll
  for (int gate = 0; gate < 3; ++gate)
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      bias[gate][hf][0] = b_e[gate * H + u[hf]];
      bias[gate][hf][1] = b_e[gate * H + u[hf] + 1];
    }
#pragma unroll
  for (int rr = 0; rr < 2; ++rr) {
    row[rr] = row0 + g + 8 * rr;
    valid[rr] = row[rr] < n_b;
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      float2 v = make_float2(0.0f, 0.0f);
      if (valid[rr])
        v = *reinterpret_cast<const float2*>(h0 + ((size_t)e * n_b + row[rr]) * H + u[hf]);
      h[rr][hf][0] = v.x;
      h[rr][hf][1] = v.y;
      store_pair(h_s + (g + 8 * rr) * h_ld + u[hf], pack_bf16x2(v.x, v.y));
    }
  }
  __syncthreads();

  // A step's projections of this lane's elements: [gate][rr][hf] bf16 pairs.
  // They do not depend on the carry, so each step's are loaded one step
  // ahead and their latency hides behind the step before.
  auto load_x = [&](int s, uint32_t (&x)[3][2][2]) {
    const int t = reverse ? n_t - 1 - s : s;
#pragma unroll
    for (int rr = 0; rr < 2; ++rr) {
      const bf16* p = proj + (((size_t)e * n_t + t) * n_b + row[rr]) * G3;
#pragma unroll
      for (int gate = 0; gate < 3; ++gate)
#pragma unroll
        for (int hf = 0; hf < 2; ++hf)
          x[gate][rr][hf] = valid[rr] ? load_pair(p + gate * H + u[hf]) : 0u;
    }
  };
  uint32_t x_next[3][2][2];
  load_x(0, x_next);

  for (int s = 0; s < n_t; ++s) {
    const int t = reverse ? n_t - 1 - s : s;
    const bf16* h_cur = h_s + (s & 1) * kRowTile * h_ld;
    bf16* h_nxt = h_s + ((s + 1) & 1) * kRowTile * h_ld;
    const size_t step_row = ((size_t)e * n_t + t) * n_b;

    uint32_t x[3][2][2];
#pragma unroll
    for (int gate = 0; gate < 3; ++gate)
#pragma unroll
      for (int rr = 0; rr < 2; ++rr)
#pragma unroll
        for (int hf = 0; hf < 2; ++hf) x[gate][rr][hf] = x_next[gate][rr][hf];
    if (s + 1 < n_t) load_x(s + 1, x_next);

    // acc[gate][hf] = columns gate*H + 16 warp + 8 hf .. +7 of h . W_hh
    float acc[3][2][4];
#pragma unroll
    for (int gate = 0; gate < 3; ++gate)
#pragma unroll
      for (int hf = 0; hf < 2; ++hf)
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[gate][hf][i] = 0.0f;
#pragma unroll 2
    for (int k0 = 0; k0 < H; k0 += 16) {
      uint32_t a[4];
      load_a(a, h_cur + k0, h_ld, lane);
#pragma unroll
      for (int gate = 0; gate < 3; ++gate) {
        uint32_t b[4];
        load_b_trans(b, w_s + (size_t)k0 * w_ld + gate * H + 16 * warp, w_ld, lane);
        mma_bf16(acc[gate][0], a, b[0], b[1]);
        mma_bf16(acc[gate][1], a, b[2], b[3]);
      }
    }

#pragma unroll
    for (int rr = 0; rr < 2; ++rr) {
      const size_t orow = (step_row + row[rr]);
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        float gv[3][2];
#pragma unroll
        for (int gate = 0; gate < 3; ++gate)
#pragma unroll
          for (int c = 0; c < 2; ++c)
            gv[gate][c] = acc[gate][hf][2 * rr + c] + bias[gate][hf][c];
        if (kEmitPrev && valid[rr]) {
          store_pair(h_prev + orow * H + u[hf], pack_bf16x2(h[rr][hf][0], h[rr][hf][1]));
          if (gates != nullptr) {        // the gate stash (STASH_GATES)
#pragma unroll
            for (int gate = 0; gate < 3; ++gate)
              store_pair(gates + orow * G3 + gate * H + u[hf],
                         pack_bf16x2(gv[gate][0], gv[gate][1]));
          }
        }
        const float2 xr = unpack_bf16x2(x[0][rr][hf]);
        const float2 xz = unpack_bf16x2(x[1][rr][hf]);
        const float2 xn = unpack_bf16x2(x[2][rr][hf]);
        const float xrv[2] = {xr.x, xr.y}, xzv[2] = {xz.x, xz.y}, xnv[2] = {xn.x, xn.y};
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          const float r = sigmoid_f32(xrv[c] + gv[0][c]);
          const float z = sigmoid_f32(xzv[c] + gv[1][c]);
          const float n = tanhf(xnv[c] + r * gv[2][c]);
          h[rr][hf][c] = (1.0f - z) * n + z * h[rr][hf][c];
        }
        const uint32_t hv = pack_bf16x2(h[rr][hf][0], h[rr][hf][1]);
        if (valid[rr]) store_pair(out + orow * H + u[hf], hv);
        store_pair(h_nxt + (g + 8 * rr) * h_ld + u[hf], valid[rr] ? hv : 0u);
      }
    }
    __syncthreads();
  }
}

// The float forms: 3xTF32 products (see the design note at the top).
template <bool kEmitPrev>
__global__ void __launch_bounds__(kTf32MaxThreads, 1)
gru_fwd_tf32_kernel(const float* __restrict__ proj, const float* __restrict__ w_hh,
                    const float* __restrict__ b_hh, const float* __restrict__ h0,
                    float* __restrict__ out, float* __restrict__ h_prev,
                    float* __restrict__ gates, int n_t, int n_b, int H, int reverse) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int G3 = 3 * H;
  const int w_ld = G3 + kTf32WPad;
  const int k_pad = round_up(H, 8);
  const int h_ld = k_pad + kTf32HPad;
  float* w_s = reinterpret_cast<float*>(smem);
  float* h_s = w_s + (size_t)H * w_ld;           // [2][kRowTile][h_ld]

  const int e = blockIdx.y;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = frag_row(lane), t = lane & 3;
  const int row0 = blockIdx.x * kRowTile;

  // W_hh[e] into padded rows 16 bytes at a time, the pads zeroed; both h
  // tiles zeroed (units H .. k_pad-1 stay zero).
  const float* w_e = w_hh + (size_t)e * H * G3;
  const int vec_per_row = w_ld / 4;
  for (int i = threadIdx.x; i < H * vec_per_row; i += blockDim.x) {
    const int r = i / vec_per_row, c = (i - r * vec_per_row) * 4;
    float4 v = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    if (c < G3) v = *reinterpret_cast<const float4*>(w_e + (size_t)r * G3 + c);
    *reinterpret_cast<float4*>(w_s + (size_t)r * w_ld + c) = v;
  }
  for (int i = threadIdx.x; i < 2 * kRowTile * h_ld; i += blockDim.x) h_s[i] = 0.0f;

  // This lane's elements: rows g + 8 rr, units u and u + 1 (both below H or
  // both not, as H is even).
  const int u = kTf32Units * warp + frag_col(lane);
  const bool unit_ok = u < H;
  int row[2];
  bool valid[2];
  float h[2][2];                                 // [rr][unit pair]
  float bias[3][2];                              // [gate][unit pair]
  const float* b_e = b_hh + (size_t)e * G3;
#pragma unroll
  for (int gate = 0; gate < 3; ++gate) {
    bias[gate][0] = unit_ok ? b_e[gate * H + u] : 0.0f;
    bias[gate][1] = unit_ok ? b_e[gate * H + u + 1] : 0.0f;
  }
  __syncthreads();                               // the tiles are zeroed
#pragma unroll
  for (int rr = 0; rr < 2; ++rr) {
    row[rr] = row0 + g + 8 * rr;
    valid[rr] = row[rr] < n_b;
    float2 v = make_float2(0.0f, 0.0f);
    if (valid[rr] && unit_ok)
      v = *reinterpret_cast<const float2*>(h0 + ((size_t)e * n_b + row[rr]) * H + u);
    h[rr][0] = v.x;
    h[rr][1] = v.y;
    if (unit_ok) *reinterpret_cast<float2*>(h_s + (g + 8 * rr) * h_ld + u) = v;
  }
  __syncthreads();

  // A step's projections of this lane's elements, [gate][rr] pairs, loaded
  // one step ahead as in the bf16 form.
  auto load_x = [&](int s, float2 (&x)[3][2]) {
    const int tt = reverse ? n_t - 1 - s : s;
#pragma unroll
    for (int rr = 0; rr < 2; ++rr) {
      const float* p = proj + (((size_t)e * n_t + tt) * n_b + row[rr]) * G3 + u;
#pragma unroll
      for (int gate = 0; gate < 3; ++gate)
        x[gate][rr] = valid[rr] && unit_ok
                          ? *reinterpret_cast<const float2*>(p + gate * H)
                          : make_float2(0.0f, 0.0f);
    }
  };
  float2 x_next[3][2];
  load_x(0, x_next);

  for (int s = 0; s < n_t; ++s) {
    const int tt = reverse ? n_t - 1 - s : s;
    const float* h_cur = h_s + (s & 1) * kRowTile * h_ld;
    float* h_nxt = h_s + ((s + 1) & 1) * kRowTile * h_ld;
    const size_t step_row = ((size_t)e * n_t + tt) * n_b;

    float2 x[3][2];
#pragma unroll
    for (int gate = 0; gate < 3; ++gate)
#pragma unroll
      for (int rr = 0; rr < 2; ++rr) x[gate][rr] = x_next[gate][rr];
    if (s + 1 < n_t) load_x(s + 1, x_next);

    // acc[gate] + cor[gate] = columns gate*H + 8 warp .. +7 of h . W_hh
    float acc[3][4], cor[3][4];
#pragma unroll
    for (int gate = 0; gate < 3; ++gate)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[gate][i] = cor[gate][i] = 0.0f;
    auto k_step = [&](int k0, const float* w0, const float* w1) {
      const SplitFrag<4> a = load_a_tf32(h_cur + k0, h_ld, lane);
#pragma unroll
      for (int gate = 0; gate < 3; ++gate)
        mma_3xtf32(acc[gate], cor[gate], a, split_b_tf32(w0[gate * H], w1[gate * H]));
    };
    const float* w_col = w_s + (size_t)t * w_ld + kTf32Units * warp + g;
    const int k_full = H & ~7;
#pragma unroll 2
    for (int k0 = 0; k0 < k_full; k0 += 8)
      k_step(k0, w_col + (size_t)k0 * w_ld, w_col + (size_t)(k0 + 4) * w_ld);
    // H % 8 == 4: rows k_full + 4 .. +7 do not exist; their A columns are
    // zero, so B reads row k_full + t again
    if (k_full < H)
      k_step(k_full, w_col + (size_t)k_full * w_ld, w_col + (size_t)k_full * w_ld);

    // Every mma.sync of the step is behind: the stores below may branch
    // on the lane.
#pragma unroll
    for (int rr = 0; rr < 2; ++rr) {
      const float xr[2] = {x[0][rr].x, x[0][rr].y};
      const float xz[2] = {x[1][rr].x, x[1][rr].y};
      const float xn[2] = {x[2][rr].x, x[2][rr].y};
      const size_t orow = step_row + row[rr];
      if (kEmitPrev && valid[rr] && unit_ok)
        *reinterpret_cast<float2*>(h_prev + orow * H + u) =
            make_float2(h[rr][0], h[rr][1]);
      float gv[3][2];                            // [gate][unit pair]
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const int i = 2 * rr + c;
        const float g_r = acc[0][i] + cor[0][i] + bias[0][c];
        const float g_z = acc[1][i] + cor[1][i] + bias[1][c];
        const float g_n = acc[2][i] + cor[2][i] + bias[2][c];
        gv[0][c] = g_r;
        gv[1][c] = g_z;
        gv[2][c] = g_n;
        const float r = sigmoid_f32(xr[c] + g_r);
        const float z = sigmoid_f32(xz[c] + g_z);
        const float n = tanhf(xn[c] + r * g_n);
        h[rr][c] = (1.0f - z) * n + z * h[rr][c];
      }
      if (kEmitPrev && gates != nullptr && valid[rr] && unit_ok) {
#pragma unroll
        for (int gate = 0; gate < 3; ++gate)     // the gate stash (STASH_GATES)
          *reinterpret_cast<float2*>(gates + orow * G3 + gate * H + u) =
              make_float2(gv[gate][0], gv[gate][1]);
      }
      const float2 hv = valid[rr] ? make_float2(h[rr][0], h[rr][1])
                                  : make_float2(0.0f, 0.0f);
      if (unit_ok) {
        if (valid[rr])
          *reinterpret_cast<float2*>(out + orow * H + u) = hv;
        *reinterpret_cast<float2*>(h_nxt + (g + 8 * rr) * h_ld + u) = hv;
      }
    }
    __syncthreads();
  }
}

template <bool kEmitPrev>
int launch_mma(const void* proj, const void* w_hh, const void* b_hh, const void* h0,
               void* out, void* h_prev, void* gates, int E, int n_t, int n_b,
               int H, int reverse, cudaStream_t stream) {
  const size_t smem = smem_bytes(H, 1);
  const auto kernel = gru_fwd_mma_kernel<kEmitPrev>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((n_b + kRowTile - 1) / kRowTile, E);
  const dim3 block(kRowGroups * H);            // H / 16 warps
  kernel<<<grid, block, smem, stream>>>(
      static_cast<const bf16*>(proj), static_cast<const bf16*>(w_hh),
      static_cast<const float*>(b_hh), static_cast<const float*>(h0),
      static_cast<bf16*>(out), static_cast<bf16*>(h_prev),
      static_cast<bf16*>(gates), n_t, n_b, H, reverse);
  return (int)cudaGetLastError();
}

template <bool kEmitPrev>
int launch_tf32(const void* proj, const void* w_hh, const void* b_hh,
                const void* h0, void* out, void* h_prev, void* gates, int E,
                int n_t, int n_b, int H, int reverse, cudaStream_t stream) {
  const size_t smem = smem_bytes(H, 0);
  const auto kernel = gru_fwd_tf32_kernel<kEmitPrev>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((n_b + kRowTile - 1) / kRowTile, E);
  const dim3 block(32 * ((H + kTf32Units - 1) / kTf32Units));
  kernel<<<grid, block, smem, stream>>>(
      static_cast<const float*>(proj), static_cast<const float*>(w_hh),
      static_cast<const float*>(b_hh), static_cast<const float*>(h0),
      static_cast<float*>(out), static_cast<float*>(h_prev),
      static_cast<float*>(gates), n_t, n_b, H, reverse);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Dynamic shared memory one CTA needs at hidden size H, in either form
// (the wrapper refuses shapes above the device's opt-in limit before
// launching).
size_t gru_fwd_smem_bytes(int H, int bf16) { return smem_bytes(H, bf16); }

int gru_fwd_max_threads(void) { return kMaxThreads; }

int gru_fwd_tf32_max_threads(void) { return kTf32MaxThreads; }

int gru_fwd_row_groups(void) { return kRowGroups; }

// Inference form.  Launch on `stream`; returns cudaGetLastError() (0 on
// success).
int gru_fwd(const void* proj, const void* w_hh, const void* b_hh, const void* h0,
            void* out, int E, int n_t, int n_b, int H, int bf16, int reverse,
            void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (bf16)
    return launch_mma<false>(proj, w_hh, b_hh, h0, out, nullptr, nullptr, E,
                             n_t, n_b, H, reverse, st);
  return launch_tf32<false>(proj, w_hh, b_hh, h0, out, nullptr, nullptr, E,
                            n_t, n_b, H, reverse, st);
}

// Training form: also writes h_prev and, unless `gates` is null, the hidden
// gates.
int gru_fwd_train(const void* proj, const void* w_hh, const void* b_hh,
                  const void* h0, void* out, void* h_prev, void* gates, int E,
                  int n_t, int n_b, int H, int bf16, int reverse, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (bf16)
    return launch_mma<true>(proj, w_hh, b_hh, h0, out, h_prev, gates, E, n_t,
                            n_b, H, reverse, st);
  return launch_tf32<true>(proj, w_hh, b_hh, h0, out, h_prev, gates, E, n_t,
                           n_b, H, reverse, st);
}

}  // extern "C"
