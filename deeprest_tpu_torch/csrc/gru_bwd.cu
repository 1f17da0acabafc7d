// GRU backward recurrence over pre-projected inputs, and its weight gradient.
//
// Replaces deeprest_tpu/ops/pallas_gru.py::_bwd_kernel (launched by _bwd_call
// from _vjp_bwd).  The forward (gru_fwd.cu, training form) ran, per expert e
// and batch row b, g = h_prev . W_hh + b_hh, r = sigmoid(x_r + g_r),
// z = sigmoid(x_z + g_z), n = tanh(x_n + r g_n), h = (1 - z) n + z h_prev.
// Walking the steps in reverse scan order with the carry dh (zero at the
// start), each step computes
//
//   dh_total = dout_t + dh
//   dn = dh_total (1 - z),  dz = dh_total (h_prev - n),  dtanh = dn (1 - n^2)
//   da_r = dtanh g_n r (1 - r),  da_z = dz z (1 - z),  dhn = dtanh r
//   dproj_t = (da_r, da_z, dtanh)                       gate-sliced store
//   dgates  = (da_r, da_z, dhn) rounded to the dot type
//   dh      = dh_total z + dgates . W_hh^T
//   db_hh  += (da_r, da_z, dhn)                          in float, unrounded
//
// and after the loop dh0 = dh and dW_hh = sum over (t, b) of
// h_prev^T . dgates (the TPU kernel's block-batched dot, K = T*B).
//
// Layout and types (the dtype contract of ops/gru.py; io = proj's type):
//   proj, gates  [E, T, B, 3H]  io      gates optional (the forward's stash)
//   h_prev, dout [E, T, B, H]   io      dout already cast by the caller
//   w_hh         [E, H, 3H]     io
//   b_hh         [E, 3H]        float
//   dproj        [E, T, B, 3H]  io
//   dw           [E, H, 3H]     float
//   db           [E, 3H]        float
//   dh0          [E, B, H]      float
// plus two workspaces the wrapper allocates: dgates [E, T, B, 3H] io (the
// operand of the dW product, exactly the values the TPU kernel keeps in its
// dg scratch) and per-tile db partials [E, n_tiles, 3H] float.
//
// Design.  Two kernels, launched back to back on one stream:
//  1. The recurrence: one CTA per (row tile of 16 batch rows, expert), 2H
//     threads, the time loop inside it; W_hh[e] is staged once into dynamic
//     shared memory with each row padded by 16 bytes.  The step's rounded
//     dgates go through a shared tile that the transposed product reads; two
//     __syncthreads per step.
//     bf16 (gru_bwd_mma_kernel): tensor cores.  Warp w owns hidden units
//     [16w, 16w+16): the two n8 tiles of dgates . W_hh^T [16, H] for those
//     units, mma.sync m16n8k16 over K = 3H, one accumulator per gate block so
//     each dependent chain is H/16 long.  Each lane holds 8 (row, unit)
//     elements in the accumulator layout (gru_mma.cuh: rows g and g+8, units
//     16w+c, +1, +8, +9); there it keeps its f32 dh carry and does the whole
//     gate math; its global loads (h_prev, dout, proj, the stash) are
//     issued one step ahead.  A = the bf16 dgates tile [16][3H+8] through
//     ldmatrix; B = W_hh [H][3H] as it lies (its rows are the N axis)
//     through plain ldmatrix.  Without the stash the hidden gates are
//     recomputed with the forward's fragment code (B through
//     ldmatrix.trans), the A fragments of
//     h_prev loaded straight from global memory into registers: a shared
//     h_prev tile would add 4,352 bytes and leave one CTA an SM.  The tile's
//     db partial sums each lane's rows, then the 8 lanes of a unit pair by a
//     fixed shuffle tree; the warps own disjoint units, so nothing more is
//     summed.  At H=128: 100,352 + 12,544 = 112,896 bytes, two CTAs an SM.
//     float (gru_bwd_kernel<float>): plain FMA.  Thread (k, rg) owns hidden
//     unit k of 8 rows of row group rg; its product reads row k of W_hh 16
//     bytes at a time and a shared [16][3H] float dgates tile (broadcast
//     reads); without the stash the gates are recomputed from a shared
//     [16][H] h_prev tile.
//  2. dW and db: several row tiles share one expert's dW_hh, and float
//     atomics would make the sum, and so training, vary from run to run.
//     Instead kernel 1 writes dgates to the workspace and its db partials per
//     tile, and a tile GEMM gives each CTA one 64 x 64 tile of
//     dW[e] = h_prev[e]^T . dgates[e] over all K = T*B rows in a fixed order;
//     the CTAs of the first row tile also sum the db partials in tile order.
//     The result is the same bits on every run.  bf16 (gru_bwd_dw_mma_kernel):
//     4 warps of 32 x 32 mma.sync tiles; both operands lie K-major in global
//     memory and reach the fragments through ldmatrix.trans from 32-row K
//     stages that cp.async double-buffers.  float (gru_bwd_dw_kernel<float>):
//     a 64 x 64 FMA tile, 4 x 4 outputs a thread.
//
// Bound at the flagship training shape, per launch (one direction, E=40,
// T=60, B=32, H=128, bf16, stash on): the TPU kernel's own I/O is proj 59 MB
// + h_prev 20 + gates 59 + dout 20 + W_hh 4 in and dproj 59 out, about
// 220 MB -> 0.066 ms at 3.35 TB/s, for 15.1 GFLOP (the dgates . W_hh^T and
// dW products) -> 0.015 ms at 989 TFLOP/s, so bytes bound it.  The dgates
// workspace adds a round trip (59 MB each way), and at B=32 kernel 1 has
// only 2 x 40 = 80 CTAs for 132 SMs.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

#include "gru_mma.cuh"

namespace {

using namespace gru_mma;
using bf16 = __nv_bfloat16;

constexpr int kRowGroups = 2;
constexpr int kRowsPerThread = 8;
constexpr int kRowTile = kRowGroups * kRowsPerThread;
constexpr int kMaxThreads = 512;
// dW GEMM tiling: 64 x 64 output tile, K staged 32 rows at a time, 256
// threads with a 4 x 4 block of outputs each.
constexpr int kTileM = 64;
constexpr int kTileN = 64;
constexpr int kTileK = 32;
constexpr int kGemmThreads = 256;
// bf16 dW tiling: the same 64 x 64 output tile, 4 warps of 32 x 32, K staged
// 32 rows at a time into two buffers whose rows carry 8 elements of pad.
constexpr int kMmaGemmThreads = 128;
constexpr int kStageLd = kTileM + 8;

// 16 bytes of shared memory as floats.
__device__ __forceinline__ void load16(const float* p, float* out) {
  const float4 v = *reinterpret_cast<const float4*>(p);
  out[0] = v.x; out[1] = v.y; out[2] = v.z; out[3] = v.w;
}

// Bytes of one padded shared row of W_hh.
__host__ __device__ __forceinline__ size_t w_row_bytes(int H, int elt) {
  return (size_t)3 * H * elt + 16;
}

size_t smem_bytes(int H, int bf16, int stash) {
  if (bf16)   // W_hh [H][3H+8] and the dgates tile [16][3H+8], bf16
    return (size_t)H * w_row_bytes(H, 2) + (size_t)kRowTile * w_row_bytes(H, 2);
  size_t bytes = (size_t)H * w_row_bytes(H, 4)                // W_hh, padded
                 + (size_t)kRowTile * 3 * H * sizeof(float);  // dgates tile
  if (!stash) bytes += (size_t)kRowTile * H * sizeof(float);  // h_prev tile
  return bytes;
}

// The float form (instantiated for T = float only).
template <typename T, bool kStash>
__global__ void __launch_bounds__(kMaxThreads)
gru_bwd_kernel(const T* __restrict__ proj, const T* __restrict__ h_prev,
               const T* __restrict__ gates, const T* __restrict__ w_hh,
               const float* __restrict__ b_hh, const T* __restrict__ dout,
               T* __restrict__ dproj, T* __restrict__ dgates,
               float* __restrict__ db_part, float* __restrict__ dh0,
               int n_t, int n_b, int H, int reverse) {
  extern __shared__ __align__(16) unsigned char smem[];
  constexpr int kVec = 16 / sizeof(T);
  const int G3 = 3 * H;
  const size_t row_bytes = w_row_bytes(H, sizeof(T));
  unsigned char* w_s = smem;
  float* dg_s = reinterpret_cast<float*>(smem + (size_t)H * row_bytes);
  float* hp_s = dg_s + kRowTile * G3;

  const int e = blockIdx.y;
  const int k = threadIdx.x % H;
  const int rg = threadIdx.x / H;
  const int local0 = rg * kRowsPerThread;
  const int row0 = blockIdx.x * kRowTile + local0;

  const T* w_e = w_hh + (size_t)e * H * G3;
  for (int i = threadIdx.x; i < H * G3; i += blockDim.x) {
    const int r = i / G3, c = i - r * G3;
    reinterpret_cast<T*>(w_s + r * row_bytes)[c] = w_e[i];
  }
  const float* b_e = b_hh + (size_t)e * G3;
  const float b_r = b_e[k], b_z = b_e[H + k], b_n = b_e[2 * H + k];

  float dh[kRowsPerThread];
  bool valid[kRowsPerThread];
#pragma unroll
  for (int j = 0; j < kRowsPerThread; ++j) {
    dh[j] = 0.0f;
    valid[j] = row0 + j < n_b;
  }
  float db_r = 0.0f, db_z = 0.0f, db_n = 0.0f;

  for (int s = 0; s < n_t; ++s) {
    // reverse scan order of the forward: a reverse recurrence walks t up
    const int t = reverse ? s : n_t - 1 - s;
    const size_t step_row = ((size_t)e * n_t + t) * n_b + row0;

    float hp[kRowsPerThread];
#pragma unroll
    for (int j = 0; j < kRowsPerThread; ++j) {
      hp[j] = valid[j] ? to_f32(h_prev[(step_row + j) * H + k]) : 0.0f;
      if (!kStash) hp_s[(local0 + j) * H + k] = hp[j];
    }
    // (A) hp_s is written, and every read of dg_s in the previous step is done
    __syncthreads();

    float g_r[kRowsPerThread], g_z[kRowsPerThread], g_n[kRowsPerThread];
    if (kStash) {
#pragma unroll
      for (int j = 0; j < kRowsPerThread; ++j) {
        if (valid[j]) {
          const T* g = gates + (step_row + j) * G3;
          g_r[j] = to_f32(g[k]);
          g_z[j] = to_f32(g[H + k]);
          g_n[j] = to_f32(g[2 * H + k]);
        } else {
          g_r[j] = g_z[j] = g_n[j] = 0.0f;
        }
      }
    } else {
#pragma unroll
      for (int j = 0; j < kRowsPerThread; ++j) g_r[j] = g_z[j] = g_n[j] = 0.0f;
#pragma unroll 2
      for (int i = 0; i < H; i += 4) {
        float w_r[4], w_z[4], w_n[4];
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          const T* w_row = reinterpret_cast<const T*>(w_s + (i + u) * row_bytes);
          w_r[u] = to_f32(w_row[k]);
          w_z[u] = to_f32(w_row[H + k]);
          w_n[u] = to_f32(w_row[2 * H + k]);
        }
#pragma unroll
        for (int j = 0; j < kRowsPerThread; ++j) {
          const float4 hv = *reinterpret_cast<const float4*>(hp_s + (local0 + j) * H + i);
          const float hvs[4] = {hv.x, hv.y, hv.z, hv.w};
#pragma unroll
          for (int u = 0; u < 4; ++u) {
            g_r[j] = fmaf(hvs[u], w_r[u], g_r[j]);
            g_z[j] = fmaf(hvs[u], w_z[u], g_z[j]);
            g_n[j] = fmaf(hvs[u], w_n[u], g_n[j]);
          }
        }
      }
#pragma unroll
      for (int j = 0; j < kRowsPerThread; ++j) {
        g_r[j] += b_r;
        g_z[j] += b_z;
        g_n[j] += b_n;
      }
    }

    float dhz[kRowsPerThread];
#pragma unroll
    for (int j = 0; j < kRowsPerThread; ++j) {
      float q_r = 0.0f, q_z = 0.0f, q_n = 0.0f;
      dhz[j] = 0.0f;
      if (valid[j]) {
        const size_t row = step_row + j;
        const T* x = proj + row * G3;
        const float r = sigmoid_f32(to_f32(x[k]) + g_r[j]);
        const float z = sigmoid_f32(to_f32(x[H + k]) + g_z[j]);
        const float n = tanhf(to_f32(x[2 * H + k]) + r * g_n[j]);
        const float dht = to_f32(dout[row * H + k]) + dh[j];
        const float dn = dht * (1.0f - z);
        const float dz = dht * (hp[j] - n);
        const float dtanh = dn * (1.0f - n * n);
        const float da_r = dtanh * g_n[j] * r * (1.0f - r);
        const float da_z = dz * z * (1.0f - z);
        const float dhn = dtanh * r;
        T* dp = dproj + row * G3;
        dp[k] = from_f32<T>(da_r);
        dp[H + k] = from_f32<T>(da_z);
        dp[2 * H + k] = from_f32<T>(dtanh);
        q_r = dot_operand<T>(da_r);
        q_z = dot_operand<T>(da_z);
        q_n = dot_operand<T>(dhn);
        T* dg = dgates + row * G3;
        dg[k] = from_f32<T>(q_r);
        dg[H + k] = from_f32<T>(q_z);
        dg[2 * H + k] = from_f32<T>(q_n);
        db_r += da_r;
        db_z += da_z;
        db_n += dhn;
        dhz[j] = dht * z;
      }
      float* dgs = dg_s + (local0 + j) * G3;
      dgs[k] = q_r;
      dgs[H + k] = q_z;
      dgs[2 * H + k] = q_n;
    }
    // (B) the tile's dgates are in dg_s
    __syncthreads();

    // dh = dh_total z + dgates . W_hh^T: thread k contracts row k of W_hh
    float acc[kRowsPerThread];
#pragma unroll
    for (int j = 0; j < kRowsPerThread; ++j) acc[j] = 0.0f;
    const T* w_k = reinterpret_cast<const T*>(w_s + k * row_bytes);
    for (int c = 0; c < G3; c += kVec) {
      float wv[kVec];
      load16(w_k + c, wv);
#pragma unroll
      for (int j = 0; j < kRowsPerThread; ++j) {
        const float* dgs = dg_s + (local0 + j) * G3 + c;
#pragma unroll
        for (int u = 0; u < kVec; u += 4) {
          const float4 d = *reinterpret_cast<const float4*>(dgs + u);
          acc[j] = fmaf(d.x, wv[u], acc[j]);
          acc[j] = fmaf(d.y, wv[u + 1], acc[j]);
          acc[j] = fmaf(d.z, wv[u + 2], acc[j]);
          acc[j] = fmaf(d.w, wv[u + 3], acc[j]);
        }
      }
    }
#pragma unroll
    for (int j = 0; j < kRowsPerThread; ++j) dh[j] = dhz[j] + acc[j];
  }

#pragma unroll
  for (int j = 0; j < kRowsPerThread; ++j)
    if (valid[j]) dh0[((size_t)e * n_b + row0 + j) * H + k] = dh[j];

  // This tile's db partial: the row groups' sums added in a fixed order.
  __syncthreads();
  float* red = dg_s;          // free now: [kRowGroups][3H]
  red[rg * G3 + k] = db_r;
  red[rg * G3 + H + k] = db_z;
  red[rg * G3 + 2 * H + k] = db_n;
  __syncthreads();
  if (rg == 0) {
    float* out = db_part + ((size_t)e * gridDim.x + blockIdx.x) * G3;
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      float sum = 0.0f;
      for (int g = 0; g < kRowGroups; ++g) sum += red[g * G3 + c * H + k];
      out[c * H + k] = sum;
    }
  }
}

// dw[e] = h_prev[e]^T . dgates[e] over n_k = T*B rows, float accumulation;
// CTAs with blockIdx.y == 0 also write db[e] = sum over tiles of db_part.
// The float form (instantiated for T = float only).
template <typename T>
__global__ void __launch_bounds__(kGemmThreads)
gru_bwd_dw_kernel(const T* __restrict__ h_prev, const T* __restrict__ dgates,
                  const float* __restrict__ db_part, float* __restrict__ dw,
                  float* __restrict__ db, int n_k, int H, int n_tiles) {
  __shared__ __align__(16) float a_s[kTileK][kTileM + 4];
  __shared__ __align__(16) float b_s[kTileK][kTileN + 4];
  const int G3 = 3 * H;
  const int e = blockIdx.z;
  const int m0 = blockIdx.y * kTileM;
  const int n0 = blockIdx.x * kTileN;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const T* a_e = h_prev + (size_t)e * n_k * H;
  const T* b_e = dgates + (size_t)e * n_k * G3;

  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.0f;

  for (int k0 = 0; k0 < n_k; k0 += kTileK) {
    for (int i = threadIdx.x; i < kTileK * kTileM; i += kGemmThreads) {
      const int kk = i / kTileM, m = i - kk * kTileM;
      const bool in = k0 + kk < n_k && m0 + m < H;
      a_s[kk][m] = in ? to_f32(a_e[(size_t)(k0 + kk) * H + m0 + m]) : 0.0f;
    }
    for (int i = threadIdx.x; i < kTileK * kTileN; i += kGemmThreads) {
      const int kk = i / kTileN, n = i - kk * kTileN;
      const bool in = k0 + kk < n_k && n0 + n < G3;
      b_s[kk][n] = in ? to_f32(b_e[(size_t)(k0 + kk) * G3 + n0 + n]) : 0.0f;
    }
    __syncthreads();
#pragma unroll 8
    for (int kk = 0; kk < kTileK; ++kk) {
      const float4 a = *reinterpret_cast<const float4*>(&a_s[kk][ty * 4]);
      const float4 b = *reinterpret_cast<const float4*>(&b_s[kk][tx * 4]);
      const float av[4] = {a.x, a.y, a.z, a.w};
      const float bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int m = m0 + ty * 4 + i;
    if (m >= H) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int n = n0 + tx * 4 + j;
      if (n < G3) dw[((size_t)e * H + m) * G3 + n] = acc[i][j];
    }
  }

  if (blockIdx.y == 0 && threadIdx.x < kTileN) {
    const int n = n0 + threadIdx.x;
    if (n < G3) {
      float sum = 0.0f;
      for (int tile = 0; tile < n_tiles; ++tile)
        sum += db_part[((size_t)e * n_tiles + tile) * G3 + n];
      db[(size_t)e * G3 + n] = sum;
    }
  }
}

// The bf16 recurrence: tensor-core products (see the design note at the top).
template <bool kStash>
__global__ void __launch_bounds__(kMaxThreads)
gru_bwd_mma_kernel(const bf16* __restrict__ proj, const bf16* __restrict__ h_prev,
                   const bf16* __restrict__ gates, const bf16* __restrict__ w_hh,
                   const float* __restrict__ b_hh, const bf16* __restrict__ dout,
                   bf16* __restrict__ dproj, bf16* __restrict__ dgates,
                   float* __restrict__ db_part, float* __restrict__ dh0,
                   int n_t, int n_b, int H, int reverse) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int G3 = 3 * H;
  const int ld = G3 + 8;                         // W_hh and dgates rows
  bf16* w_s = reinterpret_cast<bf16*>(smem);
  bf16* dg_s = w_s + (size_t)H * ld;             // [kRowTile][ld]

  const int e = blockIdx.y;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = frag_row(lane), c0 = frag_col(lane);
  const int row0 = blockIdx.x * kRowTile;

  const bf16* w_e = w_hh + (size_t)e * H * G3;
  const int vec_per_row = G3 / 8;
  for (int i = threadIdx.x; i < H * vec_per_row; i += blockDim.x) {
    const int r = i / vec_per_row, c = (i - r * vec_per_row) * 8;
    *reinterpret_cast<uint4*>(w_s + (size_t)r * ld + c) =
        *reinterpret_cast<const uint4*>(w_e + (size_t)r * G3 + c);
  }

  // This lane's elements: rows g + 8 rr, units u[hf] and u[hf] + 1.
  int u[2];
  u[0] = 16 * warp + c0;
  u[1] = u[0] + 8;
  int row[2];
  bool valid[2];
#pragma unroll
  for (int rr = 0; rr < 2; ++rr) {
    row[rr] = row0 + g + 8 * rr;
    valid[rr] = row[rr] < n_b;
  }
  float bias[3][2][2];                           // [gate][hf][unit pair]
  if (!kStash) {
    const float* b_e = b_hh + (size_t)e * G3;
#pragma unroll
    for (int gate = 0; gate < 3; ++gate)
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        bias[gate][hf][0] = b_e[gate * H + u[hf]];
        bias[gate][hf][1] = b_e[gate * H + u[hf] + 1];
      }
  }
  float dh[2][2][2], db[3][2][2];                // [rr][hf][pair], [gate][hf][pair]
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        dh[i][j][c] = 0.0f;
        db[0][i][c] = db[1][i][c] = db[2][i][c] = 0.0f;
      }
  __syncthreads();                               // w_s staged

  // reverse scan order of the forward: a reverse recurrence walks t up
  auto step_row_of = [&](int s) {
    const int t = reverse ? s : n_t - 1 - s;
    return ((size_t)e * n_t + t) * n_b;
  };
  // A step's inputs of this lane's elements, bf16 pairs.  They do not
  // depend on the carry, so each step's are loaded one step ahead and their
  // latency hides behind the step before.
  struct StepIn {
    uint32_t hp[2][2], dy[2][2], x[3][2][2], gs[3][2][2];  // [gate][rr][hf]
  };
  auto load_in = [&](int s, StepIn& in) {
    const size_t step_row = step_row_of(s);
#pragma unroll
    for (int rr = 0; rr < 2; ++rr) {
      const size_t r = step_row + row[rr];
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        in.hp[rr][hf] = valid[rr] ? load_pair(h_prev + r * H + u[hf]) : 0u;
        in.dy[rr][hf] = valid[rr] ? load_pair(dout + r * H + u[hf]) : 0u;
#pragma unroll
        for (int gate = 0; gate < 3; ++gate) {
          in.x[gate][rr][hf] = valid[rr] ? load_pair(proj + r * G3 + gate * H + u[hf]) : 0u;
          in.gs[gate][rr][hf] =
              kStash && valid[rr] ? load_pair(gates + r * G3 + gate * H + u[hf]) : 0u;
        }
      }
    }
  };
  StepIn next;
  load_in(0, next);

  for (int s = 0; s < n_t; ++s) {
    const size_t step_row = step_row_of(s);
    const StepIn in = next;
    if (s + 1 < n_t) load_in(s + 1, next);
    const auto& hp = in.hp;
    const auto& dy = in.dy;
    const auto& x = in.x;
    const auto& gs = in.gs;

    // The hidden gates of this lane's elements: [gate][hf][2 rr + pair].
    float gv[3][2][4];
    if (kStash) {
#pragma unroll
      for (int gate = 0; gate < 3; ++gate)
#pragma unroll
        for (int rr = 0; rr < 2; ++rr)
#pragma unroll
          for (int hf = 0; hf < 2; ++hf) {
            const float2 v = unpack_bf16x2(gs[gate][rr][hf]);
            gv[gate][hf][2 * rr] = v.x;
            gv[gate][hf][2 * rr + 1] = v.y;
          }
    } else {
      // h_prev . W_hh + b_hh, the forward's product; A straight from global
#pragma unroll
      for (int gate = 0; gate < 3; ++gate)
#pragma unroll
        for (int hf = 0; hf < 2; ++hf)
#pragma unroll
          for (int i = 0; i < 4; ++i) gv[gate][hf][i] = bias[gate][hf][i & 1];
      const bf16* a_lo = h_prev + (step_row + row[0]) * H + c0;
      const bf16* a_hi = h_prev + (step_row + row[1]) * H + c0;
#pragma unroll 2
      for (int k0 = 0; k0 < H; k0 += 16) {
        uint32_t a[4];
        a[0] = valid[0] ? load_pair(a_lo + k0) : 0u;
        a[1] = valid[1] ? load_pair(a_hi + k0) : 0u;
        a[2] = valid[0] ? load_pair(a_lo + k0 + 8) : 0u;
        a[3] = valid[1] ? load_pair(a_hi + k0 + 8) : 0u;
#pragma unroll
        for (int gate = 0; gate < 3; ++gate) {
          uint32_t b[4];
          load_b_trans(b, w_s + (size_t)k0 * ld + gate * H + 16 * warp, ld, lane);
          mma_bf16(gv[gate][0], a, b[0], b[1]);
          mma_bf16(gv[gate][1], a, b[2], b[3]);
        }
      }
    }

    // The gate math; q holds the rounded dgates for the product.
    uint32_t q[3][2][2];                         // [gate][rr][hf] bf16 pairs
    float dhz[2][2][2];
#pragma unroll
    for (int rr = 0; rr < 2; ++rr) {
      const size_t r = step_row + row[rr];
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        const float2 hpv = unpack_bf16x2(hp[rr][hf]), dyv = unpack_bf16x2(dy[rr][hf]);
        const float2 xr = unpack_bf16x2(x[0][rr][hf]), xz = unpack_bf16x2(x[1][rr][hf]);
        const float2 xn = unpack_bf16x2(x[2][rr][hf]);
        const float hps[2] = {hpv.x, hpv.y}, dys[2] = {dyv.x, dyv.y};
        const float xrs[2] = {xr.x, xr.y}, xzs[2] = {xz.x, xz.y}, xns[2] = {xn.x, xn.y};
        float da_r[2], da_z[2], dtanh[2], dhn[2];
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          const float g_r = gv[0][hf][2 * rr + c], g_z = gv[1][hf][2 * rr + c];
          const float g_n = gv[2][hf][2 * rr + c];
          const float rg = sigmoid_f32(xrs[c] + g_r);
          const float z = sigmoid_f32(xzs[c] + g_z);
          const float n = tanhf(xns[c] + rg * g_n);
          const float dht = dys[c] + dh[rr][hf][c];
          const float dn = dht * (1.0f - z);
          const float dz = dht * (hps[c] - n);
          dtanh[c] = dn * (1.0f - n * n);
          da_r[c] = dtanh[c] * g_n * rg * (1.0f - rg);
          da_z[c] = dz * z * (1.0f - z);
          dhn[c] = dtanh[c] * rg;
          dhz[rr][hf][c] = valid[rr] ? dht * z : 0.0f;
          if (valid[rr]) {
            db[0][hf][c] += da_r[c];
            db[1][hf][c] += da_z[c];
            db[2][hf][c] += dhn[c];
          }
        }
        q[0][rr][hf] = valid[rr] ? pack_bf16x2(da_r[0], da_r[1]) : 0u;
        q[1][rr][hf] = valid[rr] ? pack_bf16x2(da_z[0], da_z[1]) : 0u;
        q[2][rr][hf] = valid[rr] ? pack_bf16x2(dhn[0], dhn[1]) : 0u;
        if (valid[rr]) {
          bf16* dp = dproj + r * G3 + u[hf];
          store_pair(dp, q[0][rr][hf]);
          store_pair(dp + H, q[1][rr][hf]);
          store_pair(dp + 2 * H, pack_bf16x2(dtanh[0], dtanh[1]));
          bf16* dg = dgates + r * G3 + u[hf];
#pragma unroll
          for (int gate = 0; gate < 3; ++gate) store_pair(dg + gate * H, q[gate][rr][hf]);
        }
      }
    }

    // (A) every read of dg_s in the previous step is done
    __syncthreads();
#pragma unroll
    for (int rr = 0; rr < 2; ++rr)
#pragma unroll
      for (int hf = 0; hf < 2; ++hf)
#pragma unroll
        for (int gate = 0; gate < 3; ++gate)
          store_pair(dg_s + (g + 8 * rr) * ld + gate * H + u[hf], q[gate][rr][hf]);
    // (B) the tile's dgates are in dg_s
    __syncthreads();

    // dh = dh_total z + dgates . W_hh^T, one accumulator per gate block
    float acc[3][2][4];
#pragma unroll
    for (int gate = 0; gate < 3; ++gate) {
#pragma unroll
      for (int hf = 0; hf < 2; ++hf)
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[gate][hf][i] = 0.0f;
#pragma unroll 2
      for (int k0 = gate * H; k0 < (gate + 1) * H; k0 += 16) {
        uint32_t a[4], b[4];
        load_a(a, dg_s + k0, ld, lane);
        load_b(b, w_s + (size_t)(16 * warp) * ld + k0, ld, lane);
        mma_bf16(acc[gate][0], a, b[0], b[1]);
        mma_bf16(acc[gate][1], a, b[2], b[3]);
      }
    }
#pragma unroll
    for (int rr = 0; rr < 2; ++rr)
#pragma unroll
      for (int hf = 0; hf < 2; ++hf)
#pragma unroll
        for (int c = 0; c < 2; ++c)
          dh[rr][hf][c] = dhz[rr][hf][c] + (acc[0][hf][2 * rr + c] + acc[1][hf][2 * rr + c] +
                                            acc[2][hf][2 * rr + c]);
  }

#pragma unroll
  for (int rr = 0; rr < 2; ++rr)
#pragma unroll
    for (int hf = 0; hf < 2; ++hf)
      if (valid[rr])
        *reinterpret_cast<float2*>(dh0 + ((size_t)e * n_b + row[rr]) * H + u[hf]) =
            make_float2(dh[rr][hf][0], dh[rr][hf][1]);

  // This tile's db partial: the 8 lanes of one unit pair (lanes that differ
  // in bits 2..4) summed by a fixed tree, written by the lanes with g == 0.
  float* out = db_part + ((size_t)e * gridDim.x + blockIdx.x) * G3;
#pragma unroll
  for (int gate = 0; gate < 3; ++gate)
#pragma unroll
    for (int hf = 0; hf < 2; ++hf)
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        float v = db[gate][hf][c];
        v += __shfl_xor_sync(0xffffffffu, v, 4);
        v += __shfl_xor_sync(0xffffffffu, v, 8);
        v += __shfl_xor_sync(0xffffffffu, v, 16);
        if (g == 0) out[gate * H + u[hf] + c] = v;
      }
}

// The bf16 dW/db kernel: dw[e] = h_prev[e]^T . dgates[e] over n_k = T*B rows
// on the tensor cores; CTAs with blockIdx.y == 0 also write db[e].
__global__ void __launch_bounds__(kMmaGemmThreads)
gru_bwd_dw_mma_kernel(const bf16* __restrict__ h_prev, const bf16* __restrict__ dgates,
                      const float* __restrict__ db_part, float* __restrict__ dw,
                      float* __restrict__ db, int n_k, int H, int n_tiles) {
  __shared__ __align__(16) bf16 a_s[2][kTileK][kStageLd];   // h_prev rows [k][m]
  __shared__ __align__(16) bf16 b_s[2][kTileK][kStageLd];   // dgates rows [k][n]
  const int G3 = 3 * H;
  const int e = blockIdx.z;
  const int m0 = blockIdx.y * kTileM;
  const int n0 = blockIdx.x * kTileN;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int wm = 32 * (warp / 2), wn = 32 * (warp % 2);
  const bf16* a_e = h_prev + (size_t)e * n_k * H;
  const bf16* b_e = dgates + (size_t)e * n_k * G3;

  // One K stage: 32 rows of 64 values of each operand, 16 bytes a copy;
  // rows past n_k and columns past H or 3H are zero-filled.
  auto stage = [&](int buf, int k0) {
    for (int i = threadIdx.x; i < kTileK * (kTileM / 8); i += kMmaGemmThreads) {
      const int kk = i / (kTileM / 8), c = (i % (kTileM / 8)) * 8;
      const int k = k0 + kk;
      const bool in_a = k < n_k && m0 + c < H;
      const bool in_b = k < n_k && n0 + c < G3;
      cp_async16(&a_s[buf][kk][c], in_a ? a_e + (size_t)k * H + m0 + c : a_e, in_a);
      cp_async16(&b_s[buf][kk][c], in_b ? b_e + (size_t)k * G3 + n0 + c : b_e, in_b);
    }
    cp_async_commit();
  };

  float acc[2][4][4];                            // [m16 tile][n8 tile][frag]
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int v = 0; v < 4; ++v) acc[i][j][v] = 0.0f;

  const int n_stages = (n_k + kTileK - 1) / kTileK;
  stage(0, 0);
  for (int st = 0; st < n_stages; ++st) {
    if (st + 1 < n_stages) {
      stage((st + 1) & 1, (st + 1) * kTileK);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const int buf = st & 1;
#pragma unroll
    for (int kk = 0; kk < kTileK; kk += 16) {
      uint32_t a[2][4];
#pragma unroll
      for (int mi = 0; mi < 2; ++mi)
        load_a_trans(a[mi], &a_s[buf][kk][wm + 16 * mi], kStageLd, lane);
#pragma unroll
      for (int p = 0; p < 2; ++p) {
        uint32_t b[4];
        load_b_trans(b, &b_s[buf][kk][wn + 16 * p], kStageLd, lane);
#pragma unroll
        for (int mi = 0; mi < 2; ++mi) {
          mma_bf16(acc[mi][2 * p], a[mi], b[0], b[1]);
          mma_bf16(acc[mi][2 * p + 1], a[mi], b[2], b[3]);
        }
      }
    }
    __syncthreads();                             // buf is refilled next
  }

  const int g = frag_row(lane), c0 = frag_col(lane);
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int nj = 0; nj < 4; ++nj) {
      const int n = n0 + wn + 8 * nj + c0;
#pragma unroll
      for (int rr = 0; rr < 2; ++rr) {
        const int m = m0 + wm + 16 * mi + g + 8 * rr;
        if (m < H && n < G3)
          *reinterpret_cast<float2*>(dw + ((size_t)e * H + m) * G3 + n) =
              make_float2(acc[mi][nj][2 * rr], acc[mi][nj][2 * rr + 1]);
      }
    }

  if (blockIdx.y == 0 && threadIdx.x < kTileN) {
    const int n = n0 + threadIdx.x;
    if (n < G3) {
      float sum = 0.0f;
      for (int tile = 0; tile < n_tiles; ++tile)
        sum += db_part[((size_t)e * n_tiles + tile) * G3 + n];
      db[(size_t)e * G3 + n] = sum;
    }
  }
}

// The kernels of each form: bf16 takes the tensor cores, float the FMA loops.
template <typename T, bool kStash>
constexpr auto bwd_kernel() {
  if constexpr (sizeof(T) == 2)
    return gru_bwd_mma_kernel<kStash>;
  else
    return gru_bwd_kernel<T, kStash>;
}

template <typename T>
constexpr auto dw_kernel() {
  if constexpr (sizeof(T) == 2)
    return gru_bwd_dw_mma_kernel;
  else
    return gru_bwd_dw_kernel<T>;
}

template <typename T, bool kStash>
int launch(const void* proj, const void* h_prev, const void* gates,
           const void* w_hh, const void* b_hh, const void* dout, void* dproj,
           void* dw, void* db, void* dh0, void* dgates, void* db_part, int E,
           int n_t, int n_b, int H, int reverse, cudaStream_t stream) {
  const size_t smem = smem_bytes(H, sizeof(T) == 2, kStash);
  const auto kernel = bwd_kernel<T, kStash>();
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int n_tiles = (n_b + kRowTile - 1) / kRowTile;
  // 2H threads: H / 16 warps in bf16
  kernel<<<dim3(n_tiles, E), dim3(kRowGroups * H), smem, stream>>>(
      static_cast<const T*>(proj), static_cast<const T*>(h_prev),
      static_cast<const T*>(gates), static_cast<const T*>(w_hh),
      static_cast<const float*>(b_hh), static_cast<const T*>(dout),
      static_cast<T*>(dproj), static_cast<T*>(dgates),
      static_cast<float*>(db_part), static_cast<float*>(dh0), n_t, n_b, H,
      reverse);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((3 * H + kTileN - 1) / kTileN, (H + kTileM - 1) / kTileM, E);
  const auto dw_fn = dw_kernel<T>();
  const int threads = sizeof(T) == 2 ? kMmaGemmThreads : kGemmThreads;
  dw_fn<<<grid, dim3(threads), 0, stream>>>(
      static_cast<const T*>(h_prev), static_cast<const T*>(dgates),
      static_cast<const float*>(db_part), static_cast<float*>(dw),
      static_cast<float*>(db), n_t * n_b, H, n_tiles);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Dynamic shared memory one recurrence CTA needs (the wrapper refuses shapes
// above the device's opt-in limit before launching).
size_t gru_bwd_smem_bytes(int H, int bf16, int stash) {
  return smem_bytes(H, bf16, stash);
}

int gru_bwd_max_threads(void) { return kMaxThreads; }

int gru_bwd_row_groups(void) { return kRowGroups; }

int gru_bwd_row_tile(void) { return kRowTile; }

// Launch both kernels on `stream`; `gates` may be null (no stash).  Returns
// cudaGetLastError() after each launch (0 on success).
int gru_bwd(const void* proj, const void* h_prev, const void* gates,
            const void* w_hh, const void* b_hh, const void* dout, void* dproj,
            void* dw, void* db, void* dh0, void* dgates, void* db_part, int E,
            int n_t, int n_b, int H, int bf16, int reverse, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (bf16) {
    if (gates)
      return launch<__nv_bfloat16, true>(proj, h_prev, gates, w_hh, b_hh, dout,
                                         dproj, dw, db, dh0, dgates, db_part, E,
                                         n_t, n_b, H, reverse, st);
    return launch<__nv_bfloat16, false>(proj, h_prev, gates, w_hh, b_hh, dout,
                                        dproj, dw, db, dh0, dgates, db_part, E,
                                        n_t, n_b, H, reverse, st);
  }
  if (gates)
    return launch<float, true>(proj, h_prev, gates, w_hh, b_hh, dout, dproj, dw,
                               db, dh0, dgates, db_part, E, n_t, n_b, H,
                               reverse, st);
  return launch<float, false>(proj, h_prev, gates, w_hh, b_hh, dout, dproj, dw,
                              db, dh0, dgates, db_part, E, n_t, n_b, H, reverse,
                              st);
}

}  // extern "C"
