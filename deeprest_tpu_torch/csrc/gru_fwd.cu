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
// in float (the TPU kernel's bf16 dot with preferred_element_type=f32).  For
// float the dot is full-precision float FMA (no TF32).
//
// Design.  One CTA per (row tile of ROW_TILE batch rows, expert); the time
// loop runs inside the CTA and replaces the TPU's sequential grid axis, so no
// time, expert or batch padding exists: ragged rows are masked here.  W_hh[e]
// is staged into dynamic shared memory once per CTA (H=128: 96 KiB bf16,
// 192 KiB float) and read from there at every step.  Thread (k, rg) owns
// hidden unit k of ROWS_PER_THREAD rows of row group rg: it computes the
// three gate columns k, H+k, 2H+k of its rows, so the gate math needs no
// second pass, and it keeps its rows' exact float carry in registers.  The
// value the next step's dot reads goes to a double-buffered shared [2][ROW_TILE][H]
// float array; one __syncthreads per step separates the writes of step s from
// the reads of step s+1.  `reverse` walks t from T-1 down to 0 and writes h_t
// at its own t, which equals flip -> run -> flip without the two copies.
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
// are plain stores from values the inference form already holds in
// registers.  This first version does the dot with plain float FMA from shared
// memory (~2x60 GFLOP of FMA work against 67 TFLOP/s), so it runs well above
// that bound; tensor-core dots (mma/wgmma) and TMA streaming of proj are the
// way down to it.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stddef.h>

namespace {

constexpr int kRowGroups = 2;
constexpr int kRowsPerThread = 8;
constexpr int kRowTile = kRowGroups * kRowsPerThread;
constexpr int kMaxThreads = 512;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T> __device__ __forceinline__ T from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

// The value the recurrent dot consumes: bf16 models round h to bf16 first.
template <typename T> __device__ __forceinline__ float dot_operand(float v) {
  return to_f32(from_f32<T>(v));
}

__device__ __forceinline__ float sigmoid_f32(float x) { return 1.0f / (1.0f + expf(-x)); }

__host__ __device__ __forceinline__ size_t weight_bytes(int H, int bf16) {
  size_t bytes = (size_t)H * 3 * H * (bf16 ? 2 : 4);
  return (bytes + 15) & ~(size_t)15;
}

size_t smem_bytes(int H, int bf16) {
  return weight_bytes(H, bf16) + 2 * (size_t)kRowTile * H * sizeof(float);
}

template <typename T, bool kEmitPrev>
__global__ void __launch_bounds__(kMaxThreads)
gru_fwd_kernel(const T* __restrict__ proj, const T* __restrict__ w_hh,
               const float* __restrict__ b_hh, const float* __restrict__ h0,
               T* __restrict__ out, T* __restrict__ h_prev,
               T* __restrict__ gates, int n_t, int n_b, int H, int reverse) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int G3 = 3 * H;
  T* w_s = reinterpret_cast<T*>(smem);
  float* h_s = reinterpret_cast<float*>(smem + weight_bytes(H, sizeof(T) == 2));

  const int e = blockIdx.y;
  const int k = threadIdx.x % H;
  const int rg = threadIdx.x / H;
  const int row0 = blockIdx.x * kRowTile + rg * kRowsPerThread;

  const T* w_e = w_hh + (size_t)e * H * G3;
  for (int i = threadIdx.x; i < H * G3; i += blockDim.x) w_s[i] = w_e[i];

  const float* b_e = b_hh + (size_t)e * G3;
  const float b_r = b_e[k], b_z = b_e[H + k], b_n = b_e[2 * H + k];

  float h[kRowsPerThread];
  bool valid[kRowsPerThread];
#pragma unroll
  for (int j = 0; j < kRowsPerThread; ++j) {
    const int row = row0 + j;
    valid[j] = row < n_b;
    h[j] = valid[j] ? h0[((size_t)e * n_b + row) * H + k] : 0.0f;
    h_s[(rg * kRowsPerThread + j) * H + k] = dot_operand<T>(h[j]);
  }
  __syncthreads();

  for (int s = 0; s < n_t; ++s) {
    const int t = reverse ? n_t - 1 - s : s;
    const float* h_cur = h_s + (s & 1) * kRowTile * H + rg * kRowsPerThread * H;
    float* h_nxt = h_s + ((s + 1) & 1) * kRowTile * H + rg * kRowsPerThread * H;

    // This step's projections, issued before the dot so their latency hides
    // behind it.
    const T* p_t = proj + ((size_t)e * n_t + t) * n_b * G3;
    float x_r[kRowsPerThread], x_z[kRowsPerThread], x_n[kRowsPerThread];
#pragma unroll
    for (int j = 0; j < kRowsPerThread; ++j) {
      if (valid[j]) {
        const T* p = p_t + (size_t)(row0 + j) * G3;
        x_r[j] = to_f32(p[k]);
        x_z[j] = to_f32(p[H + k]);
        x_n[j] = to_f32(p[2 * H + k]);
      } else {
        x_r[j] = x_z[j] = x_n[j] = 0.0f;
      }
    }

    float a_r[kRowsPerThread], a_z[kRowsPerThread], a_n[kRowsPerThread];
#pragma unroll
    for (int j = 0; j < kRowsPerThread; ++j) a_r[j] = a_z[j] = a_n[j] = 0.0f;

#pragma unroll 2
    for (int i = 0; i < H; i += 4) {
      float w_r[4], w_z[4], w_n[4];
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const T* w_row = w_s + (size_t)(i + u) * G3;
        w_r[u] = to_f32(w_row[k]);
        w_z[u] = to_f32(w_row[H + k]);
        w_n[u] = to_f32(w_row[2 * H + k]);
      }
#pragma unroll
      for (int j = 0; j < kRowsPerThread; ++j) {
        const float4 hv = *reinterpret_cast<const float4*>(h_cur + j * H + i);
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

    T* o_t = out + ((size_t)e * n_t + t) * n_b * H;
#pragma unroll
    for (int j = 0; j < kRowsPerThread; ++j) {
      const float g_r = a_r[j] + b_r, g_z = a_z[j] + b_z, g_n = a_n[j] + b_n;
      if (kEmitPrev && valid[j]) {
        const size_t row = ((size_t)e * n_t + t) * n_b + row0 + j;
        h_prev[row * H + k] = from_f32<T>(h[j]);
        if (gates != nullptr) {          // the gate stash (STASH_GATES)
          T* g_row = gates + row * 3 * H;
          g_row[k] = from_f32<T>(g_r);
          g_row[H + k] = from_f32<T>(g_z);
          g_row[2 * H + k] = from_f32<T>(g_n);
        }
      }
      const float r = sigmoid_f32(x_r[j] + g_r);
      const float z = sigmoid_f32(x_z[j] + g_z);
      const float n = tanhf(x_n[j] + r * g_n);
      h[j] = (1.0f - z) * n + z * h[j];
      if (valid[j]) o_t[(size_t)(row0 + j) * H + k] = from_f32<T>(h[j]);
      h_nxt[j * H + k] = dot_operand<T>(h[j]);
    }
    __syncthreads();
  }
}

template <typename T, bool kEmitPrev>
int launch(const void* proj, const void* w_hh, const void* b_hh, const void* h0,
           void* out, void* h_prev, void* gates, int E, int n_t, int n_b,
           int H, int reverse, cudaStream_t stream) {
  const size_t smem = smem_bytes(H, sizeof(T) == 2);
  cudaError_t err = cudaFuncSetAttribute(
      gru_fwd_kernel<T, kEmitPrev>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((n_b + kRowTile - 1) / kRowTile, E);
  const dim3 block(kRowGroups * H);
  gru_fwd_kernel<T, kEmitPrev><<<grid, block, smem, stream>>>(
      static_cast<const T*>(proj), static_cast<const T*>(w_hh),
      static_cast<const float*>(b_hh), static_cast<const float*>(h0),
      static_cast<T*>(out), static_cast<T*>(h_prev), static_cast<T*>(gates),
      n_t, n_b, H, reverse);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Dynamic shared memory one CTA needs at hidden size H (the wrapper refuses
// shapes above the device's opt-in limit before launching).
size_t gru_fwd_smem_bytes(int H, int bf16) { return smem_bytes(H, bf16); }

int gru_fwd_max_threads(void) { return kMaxThreads; }

int gru_fwd_row_groups(void) { return kRowGroups; }

// Inference form.  Launch on `stream`; returns cudaGetLastError() (0 on
// success).
int gru_fwd(const void* proj, const void* w_hh, const void* b_hh, const void* h0,
            void* out, int E, int n_t, int n_b, int H, int bf16, int reverse,
            void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (bf16)
    return launch<__nv_bfloat16, false>(proj, w_hh, b_hh, h0, out, nullptr,
                                        nullptr, E, n_t, n_b, H, reverse, st);
  return launch<float, false>(proj, w_hh, b_hh, h0, out, nullptr, nullptr, E,
                              n_t, n_b, H, reverse, st);
}

// Training form: also writes h_prev and, unless `gates` is null, the hidden
// gates.
int gru_fwd_train(const void* proj, const void* w_hh, const void* b_hh,
                  const void* h0, void* out, void* h_prev, void* gates, int E,
                  int n_t, int n_b, int H, int bf16, int reverse, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (bf16)
    return launch<__nv_bfloat16, true>(proj, w_hh, b_hh, h0, out, h_prev, gates,
                                       E, n_t, n_b, H, reverse, st);
  return launch<float, true>(proj, w_hh, b_hh, h0, out, h_prev, gates, E, n_t,
                             n_b, H, reverse, st);
}

}  // extern "C"
