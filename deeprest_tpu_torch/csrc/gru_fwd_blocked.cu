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
// it the dot is float FMA (bf16 inputs then give bf16-exact weights and an
// unrounded h).  There is no reverse form: the sweep runs forward only.
//
// Blocking, the TPU block's axes mapped onto a CTA:
//   e_blk  experts per CTA (1, 2 or 4), stepped time outer and expert inner
//          as the TPU kernel's loop does, so each step gives the SM e_blk
//          independent dependency chains.  Each expert's W_hh lives in
//          dynamic shared memory (H = 128: 96 KiB in bf16, 192 KiB in
//          float), which bounds e_blk; e_blk must divide E.
//   t_blk  steps of proj for the CTA's rows staged in shared memory per load
//          (synchronous, coalesced copies); t_blk must divide T.
//   rows   the batch tile, a Hopper axis the TPU block did not have (there a
//          block held every row): rows / 8 row groups of H threads, each
//          thread one hidden unit of 8 rows, its rows' exact float carry in
//          registers, at most 512 threads.  Ragged rows are masked.
// Shared memory per CTA, per expert of the block: W_hh (bf16 when the inputs
// or the dot are bf16), a double-buffered [2][rows][H] float array of the
// values the next dot reads (one __syncthreads per step), and the staged
// [t_blk][rows][3H] proj tile.  The wrapper's plan (ops/cuda_gru.py
// block_plan) refuses a blocking above the opt-in limit before launching.
//
// Bound at the sweep's shape (E=80, T=60, B=32, H=128), bf16 inputs:
//   bytes = proj 118.0 MB + out (float) 78.6 MB + W_hh 7.9 MB + h0, b_hh
//           1.4 MB = 205.9 MB  -> 0.061 ms at 3.35 TB/s
//   FLOPs = 2*80*60*32*128*384 = 15.1 GFLOP -> 0.015 ms at 989 TFLOP/s
// so bytes bound it; with float inputs (331.7 MB, 0.099 ms) the 15.1 GFLOP
// against 67 TFLOP/s of float (0.225 ms) do.  This first version does the dot
// with plain float FMA from shared memory, as gru_fwd.cu does, and stages
// synchronously; tensor-core products and asynchronous copies (cp.async,
// TMA) are the way down to the bound.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stddef.h>

namespace {

constexpr int kRowsPerThread = 8;
constexpr int kMaxThreads = 512;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T> __device__ __forceinline__ T from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

// The value the dot reads: rounded to bf16 iff the dot is bf16.
__device__ __forceinline__ float dot_operand(float v, int bf16_dot) {
  return bf16_dot ? __bfloat162float(__float2bfloat16_rn(v)) : v;
}

__device__ __forceinline__ float sigmoid_f32(float x) { return 1.0f / (1.0f + expf(-x)); }

__host__ __device__ __forceinline__ size_t round16(size_t n) {
  return (n + 15) & ~(size_t)15;
}

__host__ __device__ __forceinline__ size_t weight_bytes(int H, int w_bf16) {
  return round16((size_t)H * 3 * H * (w_bf16 ? 2 : 4));
}

size_t smem_bytes(int H, int rows, int e_blk, int t_blk, int io_bf16, int w_bf16) {
  return (size_t)e_blk * (weight_bytes(H, w_bf16)
                          + 2 * (size_t)rows * H * sizeof(float)
                          + (size_t)t_blk * rows * 3 * H * (io_bf16 ? 2 : 4));
}

// TIO: proj and W_hh in device memory; TW: W_hh in shared memory.
template <typename TIO, typename TW, int kEBlk>
__global__ void __launch_bounds__(kMaxThreads)
gru_fwd_blocked_kernel(const TIO* __restrict__ proj, const TIO* __restrict__ w_hh,
                       const float* __restrict__ b_hh, const float* __restrict__ h0,
                       float* __restrict__ out, int n_t, int n_b, int H, int rows,
                       int t_blk, int bf16_dot) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int G3 = 3 * H;
  const size_t w_bytes = weight_bytes(H, sizeof(TW) == 2);
  // [kEBlk] W_hh, then [kEBlk][2][rows][H] float, then [kEBlk][t_blk][rows][3H]
  float* h_s = reinterpret_cast<float*>(smem + kEBlk * w_bytes);
  TIO* p_s = reinterpret_cast<TIO*>(smem + kEBlk * w_bytes
                                    + (size_t)kEBlk * 2 * rows * H * sizeof(float));

  const int e0 = blockIdx.y * kEBlk;
  const int k = threadIdx.x % H;
  const int local0 = (threadIdx.x / H) * kRowsPerThread;
  const int tile0 = blockIdx.x * rows;
  const int row0 = tile0 + local0;
  const int tile_rows = min(rows, n_b - tile0);
  const size_t stage = (size_t)rows * G3;   // elements per (expert, step)

#pragma unroll
  for (int i = 0; i < kEBlk; ++i) {
    const TIO* w_e = w_hh + (size_t)(e0 + i) * H * G3;
    TW* w_d = reinterpret_cast<TW*>(smem + i * w_bytes);
    for (int idx = threadIdx.x; idx < H * G3; idx += blockDim.x)
      w_d[idx] = from_f32<TW>(to_f32(w_e[idx]));
  }

  bool valid[kRowsPerThread];
#pragma unroll
  for (int j = 0; j < kRowsPerThread; ++j) valid[j] = row0 + j < n_b;

  float b_r[kEBlk], b_z[kEBlk], b_n[kEBlk];
  float h[kEBlk][kRowsPerThread];
#pragma unroll
  for (int i = 0; i < kEBlk; ++i) {
    const float* b_e = b_hh + (size_t)(e0 + i) * G3;
    b_r[i] = b_e[k];
    b_z[i] = b_e[H + k];
    b_n[i] = b_e[2 * H + k];
    float* h_i = h_s + (size_t)i * 2 * rows * H;
#pragma unroll
    for (int j = 0; j < kRowsPerThread; ++j) {
      h[i][j] = valid[j] ? h0[((size_t)(e0 + i) * n_b + row0 + j) * H + k] : 0.0f;
      h_i[(local0 + j) * H + k] = dot_operand(h[i][j], bf16_dot);
    }
  }

  for (int t0 = 0; t0 < n_t; t0 += t_blk) {
    // (A) every read of the previous block's staged proj is done, and the
    // carry tile written before the loop is visible
    __syncthreads();
    for (int i = 0; i < kEBlk; ++i) {
      for (int tt = 0; tt < t_blk; ++tt) {
        const TIO* src = proj + (((size_t)(e0 + i) * n_t + t0 + tt) * n_b + tile0) * G3;
        TIO* dst = p_s + ((size_t)i * t_blk + tt) * stage;
        for (int idx = threadIdx.x; idx < tile_rows * G3; idx += blockDim.x)
          dst[idx] = src[idx];
      }
    }
    // (B) this block's projections are staged
    __syncthreads();

    for (int tt = 0; tt < t_blk; ++tt) {
      const int s = t0 + tt;
#pragma unroll
      for (int i = 0; i < kEBlk; ++i) {       // time outer, experts inner
        const TW* w_i = reinterpret_cast<const TW*>(smem + i * w_bytes);
        const float* h_cur = h_s + ((size_t)i * 2 + (s & 1)) * rows * H + local0 * H;
        float* h_nxt = h_s + ((size_t)i * 2 + ((s + 1) & 1)) * rows * H + local0 * H;

        float a_r[kRowsPerThread], a_z[kRowsPerThread], a_n[kRowsPerThread];
#pragma unroll
        for (int j = 0; j < kRowsPerThread; ++j) a_r[j] = a_z[j] = a_n[j] = 0.0f;

#pragma unroll 2
        for (int c = 0; c < H; c += 4) {
          float w_r[4], w_z[4], w_n[4];
#pragma unroll
          for (int u = 0; u < 4; ++u) {
            const TW* w_row = w_i + (size_t)(c + u) * G3;
            w_r[u] = to_f32(w_row[k]);
            w_z[u] = to_f32(w_row[H + k]);
            w_n[u] = to_f32(w_row[2 * H + k]);
          }
#pragma unroll
          for (int j = 0; j < kRowsPerThread; ++j) {
            const float4 hv = *reinterpret_cast<const float4*>(h_cur + j * H + c);
            a_r[j] = fmaf(hv.x, w_r[0], a_r[j]);
            a_z[j] = fmaf(hv.x, w_z[0], a_z[j]);
            a_n[j] = fmaf(hv.x, w_n[0], a_n[j]);
            a_r[j] = fmaf(hv.y, w_r[1], a_r[j]);
            a_z[j] = fmaf(hv.y, w_z[1], a_z[j]);
            a_n[j] = fmaf(hv.y, w_n[1], a_n[j]);
            a_r[j] = fmaf(hv.z, w_r[2], a_r[j]);
            a_z[j] = fmaf(hv.z, w_z[2], a_z[j]);
            a_n[j] = fmaf(hv.z, w_n[2], a_n[j]);
            a_r[j] = fmaf(hv.w, w_r[3], a_r[j]);
            a_z[j] = fmaf(hv.w, w_z[3], a_z[j]);
            a_n[j] = fmaf(hv.w, w_n[3], a_n[j]);
          }
        }

        const TIO* x_s = p_s + ((size_t)i * t_blk + tt) * stage + (size_t)local0 * G3;
        float* o_t = out + ((size_t)(e0 + i) * n_t + s) * n_b * H;
#pragma unroll
        for (int j = 0; j < kRowsPerThread; ++j) {
          float x_r = 0.0f, x_z = 0.0f, x_n = 0.0f;
          if (valid[j]) {
            const TIO* x = x_s + (size_t)j * G3;
            x_r = to_f32(x[k]);
            x_z = to_f32(x[H + k]);
            x_n = to_f32(x[2 * H + k]);
          }
          const float g_r = a_r[j] + b_r[i], g_z = a_z[j] + b_z[i];
          const float g_n = a_n[j] + b_n[i];
          const float r = sigmoid_f32(x_r + g_r);
          const float z = sigmoid_f32(x_z + g_z);
          const float n = tanhf(x_n + r * g_n);
          h[i][j] = (1.0f - z) * n + z * h[i][j];
          if (valid[j]) o_t[(size_t)(row0 + j) * H + k] = h[i][j];
          h_nxt[j * H + k] = dot_operand(h[i][j], bf16_dot);
        }
      }
      // (C) step s's carry values are written before step s + 1 reads them
      __syncthreads();
    }
  }
}

template <typename TIO, typename TW, int kEBlk>
int launch(const void* proj, const void* w_hh, const void* b_hh, const void* h0,
           void* out, int E, int n_t, int n_b, int H, int rows, int t_blk,
           int bf16_dot, cudaStream_t stream) {
  const size_t smem = smem_bytes(H, rows, kEBlk, t_blk, sizeof(TIO) == 2,
                                 sizeof(TW) == 2);
  cudaError_t err = cudaFuncSetAttribute(
      gru_fwd_blocked_kernel<TIO, TW, kEBlk>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((n_b + rows - 1) / rows, E / kEBlk);
  const dim3 block((rows / kRowsPerThread) * H);
  gru_fwd_blocked_kernel<TIO, TW, kEBlk><<<grid, block, smem, stream>>>(
      static_cast<const TIO*>(proj), static_cast<const TIO*>(w_hh),
      static_cast<const float*>(b_hh), static_cast<const float*>(h0),
      static_cast<float*>(out), n_t, n_b, H, rows, t_blk, bf16_dot);
  return (int)cudaGetLastError();
}

template <typename TIO, typename TW>
int launch_e(int e_blk, const void* proj, const void* w_hh, const void* b_hh,
             const void* h0, void* out, int E, int n_t, int n_b, int H, int rows,
             int t_blk, int bf16_dot, cudaStream_t stream) {
  switch (e_blk) {
    case 1:
      return launch<TIO, TW, 1>(proj, w_hh, b_hh, h0, out, E, n_t, n_b, H, rows,
                                t_blk, bf16_dot, stream);
    case 2:
      return launch<TIO, TW, 2>(proj, w_hh, b_hh, h0, out, E, n_t, n_b, H, rows,
                                t_blk, bf16_dot, stream);
    case 4:
      return launch<TIO, TW, 4>(proj, w_hh, b_hh, h0, out, E, n_t, n_b, H, rows,
                                t_blk, bf16_dot, stream);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// Dynamic shared memory one CTA needs (the wrapper's plan refuses a blocking
// above the opt-in limit before launching).
size_t gru_fwd_blocked_smem_bytes(int H, int rows, int e_blk, int t_blk,
                                  int io_bf16, int w_bf16) {
  return smem_bytes(H, rows, e_blk, t_blk, io_bf16, w_bf16);
}

int gru_fwd_blocked_max_threads(void) { return kMaxThreads; }

// Launch on `stream`; returns cudaGetLastError() (0 on success).  The caller
// has checked e_blk | E, t_blk | T, rows % 8 == 0 and (rows / 8) * H <= 512.
int gru_fwd_blocked(const void* proj, const void* w_hh, const void* b_hh,
                    const void* h0, void* out, int E, int n_t, int n_b, int H,
                    int rows, int e_blk, int t_blk, int bf16, int bf16_dot,
                    void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (bf16)   // bf16 weights stay bf16 in shared memory, dot or not
    return launch_e<__nv_bfloat16, __nv_bfloat16>(e_blk, proj, w_hh, b_hh, h0,
                                                  out, E, n_t, n_b, H, rows,
                                                  t_blk, bf16_dot, st);
  if (bf16_dot)
    return launch_e<float, __nv_bfloat16>(e_blk, proj, w_hh, b_hh, h0, out, E,
                                          n_t, n_b, H, rows, t_blk, bf16_dot, st);
  return launch_e<float, float>(e_blk, proj, w_hh, b_hh, h0, out, E, n_t, n_b,
                                H, rows, t_blk, bf16_dot, st);
}

}  // extern "C"
