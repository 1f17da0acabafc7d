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
//  1. The recurrence: one CTA per (row tile of 16 batch rows, expert), the
//     time loop inside it.  Thread (k, rg) owns hidden unit k of 8 rows of row
//     group rg, so the gate math of columns k, H+k, 2H+k is local and its dh
//     carry and db partial sums stay in registers.  W_hh[e] is staged once
//     into dynamic shared memory.  The transposed product has thread k read
//     row k of W_hh; rows of 3H values lie 3H*sizeof(T) bytes apart, a
//     multiple of 128 bytes at H = 128, so unpadded every thread of a warp
//     would hit one bank.  Each shared row is therefore padded by 16 bytes
//     and read 16 bytes at a time, which spreads a quarter-warp over all 32
//     banks.  The rounded dgates of the tile's rows go through a shared
//     [16][3H] float array that every thread of the CTA reads whole
//     (broadcast reads); two __syncthreads per step.  Without the stash the
//     hidden gates are recomputed from h_prev (staged in a shared [16][H]
//     array) and W_hh, as the forward computes them.
//  2. dW and db: several row tiles share one expert's dW_hh, and float
//     atomics would make the sum, and so training, vary from run to run.
//     Instead kernel 1 writes dgates to the workspace and its db partials per
//     tile, and a tiled shared-memory GEMM gives each CTA one 64 x 64 tile of
//     dW[e] = h_prev[e]^T . dgates[e] over all K = T*B rows in a fixed order;
//     the CTAs of the first row tile also sum the db partials in tile order.
//     The result is the same bits on every run.
//
// Bound at the flagship training shape, per launch (one direction, E=40,
// T=60, B=32, H=128, bf16, stash on): the TPU kernel's own I/O is proj 59 MB
// + h_prev 20 + gates 59 + dout 20 + W_hh 4 in and dproj 59 out, about
// 220 MB -> 0.066 ms at 3.35 TB/s, for 15.1 GFLOP (the dgates . W_hh^T and
// dW products) -> 0.015 ms at 989 TFLOP/s, so bytes bound it.  This first
// version does both products with float FMA from shared memory (about
// 2 x 7.5 GFLOP against 67 TFLOP/s) and adds the dgates workspace round trip
// (59 MB each way), so it runs well above that bound; at B=32 kernel 1 has
// only 2 x 40 = 80 CTAs for 132 SMs.  Tensor-core products and a wider row
// split are the way down.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stddef.h>

namespace {

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

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T> __device__ __forceinline__ T from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

// A value rounded to the dot type T and widened back.
template <typename T> __device__ __forceinline__ float dot_operand(float v) {
  return to_f32(from_f32<T>(v));
}

__device__ __forceinline__ float sigmoid_f32(float x) { return 1.0f / (1.0f + expf(-x)); }

// 16 bytes of shared memory as floats: 4 floats or 8 bf16 values.
__device__ __forceinline__ void load16(const float* p, float* out) {
  const float4 v = *reinterpret_cast<const float4*>(p);
  out[0] = v.x; out[1] = v.y; out[2] = v.z; out[3] = v.w;
}
__device__ __forceinline__ void load16(const __nv_bfloat16* p, float* out) {
  const uint4 v = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&v);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    out[2 * i] = f.x;
    out[2 * i + 1] = f.y;
  }
}

// Bytes of one padded shared row of W_hh.
__host__ __device__ __forceinline__ size_t w_row_bytes(int H, int elt) {
  return (size_t)3 * H * elt + 16;
}

size_t smem_bytes(int H, int bf16, int stash) {
  const int elt = bf16 ? 2 : 4;
  size_t bytes = (size_t)H * w_row_bytes(H, elt)              // W_hh, padded
                 + (size_t)kRowTile * 3 * H * sizeof(float);  // dgates tile
  if (!stash) bytes += (size_t)kRowTile * H * sizeof(float);  // h_prev tile
  return bytes;
}

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

template <typename T, bool kStash>
int launch(const void* proj, const void* h_prev, const void* gates,
           const void* w_hh, const void* b_hh, const void* dout, void* dproj,
           void* dw, void* db, void* dh0, void* dgates, void* db_part, int E,
           int n_t, int n_b, int H, int reverse, cudaStream_t stream) {
  const size_t smem = smem_bytes(H, sizeof(T) == 2, kStash);
  cudaError_t err = cudaFuncSetAttribute(
      gru_bwd_kernel<T, kStash>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int n_tiles = (n_b + kRowTile - 1) / kRowTile;
  gru_bwd_kernel<T, kStash><<<dim3(n_tiles, E), dim3(kRowGroups * H), smem, stream>>>(
      static_cast<const T*>(proj), static_cast<const T*>(h_prev),
      static_cast<const T*>(gates), static_cast<const T*>(w_hh),
      static_cast<const float*>(b_hh), static_cast<const T*>(dout),
      static_cast<T*>(dproj), static_cast<T*>(dgates),
      static_cast<float*>(db_part), static_cast<float*>(dh0), n_t, n_b, H,
      reverse);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((3 * H + kTileN - 1) / kTileN, (H + kTileM - 1) / kTileM, E);
  gru_bwd_dw_kernel<T><<<grid, dim3(kGemmThreads), 0, stream>>>(
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
