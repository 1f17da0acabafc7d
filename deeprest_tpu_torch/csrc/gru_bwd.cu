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
//  1. The recurrence: one CTA per (row tile of 16 batch rows, expert), one
//     warp per 16 hidden units, the time loop inside it; W_hh[e] is staged
//     once into dynamic shared memory with each row padded by 16 bytes.  The
//     step's rounded
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
//     float (gru_bwd_tf32_kernel): the bf16 form's warps of 16 units with
//     3xTF32 products (gru_mma.cuh), ceil(H/16) warps.  W_hh and the
//     dgates tile are f32 [H rounded up to 16][3H+4] and [16][3H+4] (the
//     pad puts the 8 rows of an A fragment, and of the N-major B fragment
//     of W_hh^T, on distinct banks), each value split into TF32 big and
//     small halves as its fragment is loaded; big and correction products
//     sum in separate accumulators, one pair per gate block.  W_hh's rows
//     are staged permuted (tf32_unit) so that lane t's accumulator columns
//     are the 4 consecutive units 16w + 4t .. +3: every global load and
//     store of a step, and the dgates tile write, is one float4 a row and
//     tensor (faster on the card than float2 pairs).  The step's
//     inputs for the next step are loaded once this step's gate math is
//     done, so their latency hides behind the product.  Without the stash
//     the recompute reads its h_prev A fragments from global memory, as
//     the bf16 form does, on every lane (masked ones read row 0 and are
//     zeroed): a load only some lanes take left the warp diverged at the
//     next mma.sync.aligned, which hung the card.  Units past H
//     (H % 16 != 0) run on junk and are never stored or summed.  At
//     H=128: 198,656 + 24,832 = 223,488 bytes with the stash or without,
//     one CTA an SM, 8 warps under __launch_bounds__(256), so a thread may
//     keep up to 255 registers.  On an H100 close to half of a step is
//     the product's loads, splits and mma.sync at 2 warps a scheduler
//     (clock64 stamps in a debug build).
//  2. dW and db: several row tiles share one expert's dW_hh, and float
//     atomics would make the sum, and so training, vary from run to run.
//     Instead kernel 1 writes dgates to the workspace and its db partials per
//     tile, and a tile GEMM gives each CTA one 64 x 64 tile of
//     dW[e] = h_prev[e]^T . dgates[e] over all K = T*B rows in a fixed order;
//     the CTAs of the first row tile also sum the db partials in tile order.
//     The result is the same bits on every run.  Both dtypes: 4 warps of
//     32 x 32 mma.sync tiles over 32-row K stages that cp.async
//     double-buffers; both operands lie K-major in global memory.  bf16
//     (gru_bwd_dw_mma_kernel) reaches the fragments through ldmatrix.trans;
//     float (gru_bwd_dw_tf32_kernel) loads them as plain shared loads from
//     stage rows of 64 + 8 floats and runs 3xTF32, each K stage into fresh
//     accumulators added to the running sum in f32: one tensor-core chain
//     over the 1,920 rows of T = 60, B = 32 was 3.3x as far from an
//     f64 dW as the FMA tile, the staged sum 0.2x.
//
// Bound at the flagship training shape, per launch (one direction, E=40,
// T=60, B=32, H=128, bf16, stash on): the TPU kernel's own I/O is proj 59 MB
// + h_prev 20 + gates 59 + dout 20 + W_hh 4 in and dproj 59 out, about
// 220 MB -> 0.066 ms at 3.35 TB/s, for 15.1 GFLOP (the dgates . W_hh^T and
// dW products) -> 0.015 ms at 989 TFLOP/s, so bytes bound it.  The dgates
// workspace adds a round trip (59 MB each way), and at B=32 kernel 1 has
// only 2 x 40 = 80 CTAs for 132 SMs.  In float the bytes double (about
// 0.13 ms) and the 15.1 GFLOP take 0.225 ms on FMA at 67 TFLOP/s or, as
// three TF32 products, 0.092 ms at 495 TFLOP/s; the stream's fine-tune
// shape (E=88, B=32) gives 176 CTAs, 1.33 waves at one an SM.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

#include "gru_mma.cuh"

namespace {

using namespace gru_mma;
using bf16 = __nv_bfloat16;

constexpr int kRowGroups = 2;
constexpr int kRowTile = 16;
constexpr int kMaxThreads = 512;
// dW tiling: a 64 x 64 output tile on 4 warps of 32 x 32, K staged 32 rows
// at a time into two buffers whose rows carry 8 elements of pad.
constexpr int kTileM = 64;
constexpr int kTileN = 64;
constexpr int kTileK = 32;
constexpr int kMmaGemmThreads = 128;
constexpr int kStageLd = kTileM + 8;
// The float recurrence: floats after each W_hh and dgates row, and the
// threads of the largest H whose W_hh fits (H <= 128: 8 warps).
constexpr int kTf32Pad = 4;
constexpr int kTf32MaxThreads = 256;

// The recomputes without the stash read h_prev from global memory, so the
// stash does not change the bytes.
size_t smem_bytes(int H, int bf16) {
  if (bf16)   // W_hh [H][3H+8] and the dgates tile [16][3H+8], bf16
    return (size_t)(H + kRowTile) * (3 * H * 2 + 16);
  // W_hh [H rounded up to 16][3H+4] and the dgates tile [16][3H+4], float
  return (size_t)(((H + 15) & ~15) + kRowTile) * (3 * H + kTf32Pad) * sizeof(float);
}

// The unit that shared W_hh row r holds in the float recurrence: rows
// 16w + 8hf + c (the n8 tile hf of warp w, column c) hold units 16w +
// 4(c/2) + 2hf + c%2, so lane t's accumulator columns 2t, 2t+1 of both
// tiles are the 4 consecutive units 16w + 4t .. +3.
__device__ __forceinline__ int tf32_unit(int r) {
  return (r & ~15) + 4 * ((r & 7) >> 1) + 2 * ((r >> 3) & 1) + (r & 1);
}

// The float recurrence: 3xTF32 products (see the design note at the top).
template <bool kStash>
__global__ void __launch_bounds__(kTf32MaxThreads, 1)
gru_bwd_tf32_kernel(const float* __restrict__ proj, const float* __restrict__ h_prev,
                    const float* __restrict__ gates, const float* __restrict__ w_hh,
                    const float* __restrict__ b_hh, const float* __restrict__ dout,
                    float* __restrict__ dproj, float* __restrict__ dgates,
                    float* __restrict__ db_part, float* __restrict__ dh0,
                    int n_t, int n_b, int H, int reverse) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int G3 = 3 * H;
  const int ld = G3 + kTf32Pad;                  // W_hh and dgates rows
  const int h_rows = (H + 15) & ~15;             // W_hh rows, in tf32_unit order
  float* w_s = reinterpret_cast<float*>(smem);
  float* dg_s = w_s + (size_t)h_rows * ld;       // [kRowTile][ld]

  const int e = blockIdx.y;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = frag_row(lane), t = lane & 3;
  const int row0 = blockIdx.x * kRowTile;

  // W_hh[e] into padded rows in tf32_unit order, 16 bytes at a time; the
  // rows of units past H, the pads and the dgates tile zeroed (the junk of
  // units past H reads them).
  const float* w_e = w_hh + (size_t)e * H * G3;
  const int vec_per_row = ld / 4;
  for (int i = threadIdx.x; i < (h_rows + kRowTile) * vec_per_row; i += blockDim.x) {
    const int r = i / vec_per_row, c = (i - r * vec_per_row) * 4;
    const int unit = tf32_unit(r);
    float4 v = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    if (r < h_rows && unit < H && c < G3)
      v = *reinterpret_cast<const float4*>(w_e + (size_t)unit * G3 + c);
    *reinterpret_cast<float4*>(w_s + (size_t)r * ld + c) = v;
  }

  // This lane's elements: rows g + 8 rr, units u .. u + 3 (all below H or
  // none, as H % 4 == 0); element j of a float4 sits in tile j / 2, column
  // 2t + j % 2.
  const int u = 16 * warp + 4 * t;
  const bool unit_ok = u < H;
  int row[2];
  bool valid[2];
#pragma unroll
  for (int rr = 0; rr < 2; ++rr) {
    row[rr] = row0 + g + 8 * rr;
    valid[rr] = row[rr] < n_b;
  }
  float bias[3][4];                              // [gate][unit]
  if (!kStash) {
    const float* b_e = b_hh + (size_t)e * G3;
#pragma unroll
    for (int gate = 0; gate < 3; ++gate)
#pragma unroll
      for (int j = 0; j < 4; ++j) bias[gate][j] = unit_ok ? b_e[gate * H + u + j] : 0.0f;
  }
  float dh[2][4], db[3][4];                      // [rr][unit], [gate][unit]
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    dh[0][j] = dh[1][j] = 0.0f;
    db[0][j] = db[1][j] = db[2][j] = 0.0f;
  }
  __syncthreads();                               // w_s staged

  // reverse scan order of the forward: a reverse recurrence walks t up
  auto step_row_of = [&](int s) {
    const int tt = reverse ? s : n_t - 1 - s;
    return ((size_t)e * n_t + tt) * n_b;
  };
  // A step's inputs of this lane's elements, 4 units a load.
  struct StepIn {
    float4 hp[2], dy[2], x[3][2], gs[3][2];      // [gate][rr]
  };
  auto load_in = [&](int s, StepIn& in) {
    const size_t step_row = step_row_of(s);
    const float4 zero = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
#pragma unroll
    for (int rr = 0; rr < 2; ++rr) {
      const size_t r = step_row + row[rr];
      const bool ok = valid[rr] && unit_ok;
      in.hp[rr] = ok ? *reinterpret_cast<const float4*>(h_prev + r * H + u) : zero;
      in.dy[rr] = ok ? *reinterpret_cast<const float4*>(dout + r * H + u) : zero;
#pragma unroll
      for (int gate = 0; gate < 3; ++gate) {
        in.x[gate][rr] =
            ok ? *reinterpret_cast<const float4*>(proj + r * G3 + gate * H + u) : zero;
        in.gs[gate][rr] =
            kStash && ok ? *reinterpret_cast<const float4*>(gates + r * G3 + gate * H + u)
                         : zero;
      }
    }
  };
  auto elem = [](const float4& v, int j) {
    return j == 0 ? v.x : j == 1 ? v.y : j == 2 ? v.z : v.w;
  };
  StepIn in;
  load_in(0, in);

  for (int s = 0; s < n_t; ++s) {
    const size_t step_row = step_row_of(s);

    // The hidden gates of this lane's elements: [gate][rr][unit].
    float gv[3][2][4];
    if (kStash) {
#pragma unroll
      for (int gate = 0; gate < 3; ++gate)
#pragma unroll
        for (int rr = 0; rr < 2; ++rr)
#pragma unroll
          for (int j = 0; j < 4; ++j) gv[gate][rr][j] = elem(in.gs[gate][rr], j);
    } else {
      // h_prev . W_hh + b_hh, the forward's product, its k axis in the
      // rows' tf32_unit order; A straight from global.  Every lane loads
      // (masked rows and units read unit 0 of row 0 and are zeroed by a
      // factor): a load that only some lanes take leaves the warp diverged
      // at the mma.sync.aligned that follows, which then never completes.
      float big[3][2][4], cor[3][2][4];
#pragma unroll
      for (int gate = 0; gate < 3; ++gate)
#pragma unroll
        for (int hf = 0; hf < 2; ++hf)
#pragma unroll
          for (int i = 0; i < 4; ++i) big[gate][hf][i] = cor[gate][hf][i] = 0.0f;
      const float* a_lo = h_prev + (step_row + (valid[0] ? row[0] : 0)) * H;
      const float* a_hi = h_prev + (step_row + (valid[1] ? row[1] : 0)) * H;
      const float m_lo = valid[0] ? 1.0f : 0.0f, m_hi = valid[1] ? 1.0f : 0.0f;
      // the B column of lane g in tile hf: unit tf32_unit(16 warp + 8 hf + g)
      const int col0 = tf32_unit(16 * warp + g), col1 = tf32_unit(16 * warp + 8 + g);
#pragma unroll 2
      for (int k0 = 0; k0 < h_rows; k0 += 8) {
        const int k_a = tf32_unit(k0 + t), k_b = tf32_unit(k0 + t + 4);
        const float f_a = k_a < H ? 1.0f : 0.0f, f_b = k_b < H ? 1.0f : 0.0f;
        const int i_a = k_a < H ? k_a : 0, i_b = k_b < H ? k_b : 0;
        SplitFrag<4> a;
        split_tf32(m_lo * f_a * a_lo[i_a], a.big[0], a.small[0]);
        split_tf32(m_hi * f_a * a_hi[i_a], a.big[1], a.small[1]);
        split_tf32(m_lo * f_b * a_lo[i_b], a.big[2], a.small[2]);
        split_tf32(m_hi * f_b * a_hi[i_b], a.big[3], a.small[3]);
        const float* w0 = w_s + (size_t)(k0 + t) * ld;
        const float* w1 = w0 + 4 * ld;
#pragma unroll
        for (int gate = 0; gate < 3; ++gate) {
          mma_3xtf32(big[gate][0], cor[gate][0], a,
                     split_b_tf32(w0[gate * H + col0], w1[gate * H + col0]));
          mma_3xtf32(big[gate][1], cor[gate][1], a,
                     split_b_tf32(w0[gate * H + col1], w1[gate * H + col1]));
        }
      }
#pragma unroll
      for (int gate = 0; gate < 3; ++gate)
#pragma unroll
        for (int rr = 0; rr < 2; ++rr)
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const int hf = j >> 1, i = 2 * rr + (j & 1);
            gv[gate][rr][j] = big[gate][hf][i] + cor[gate][hf][i] + bias[gate][j];
          }
    }

    // The gate math; q holds the dgates for the product.
    float4 q[3][2];                              // [gate][rr]
    float dhz[2][4];
#pragma unroll
    for (int rr = 0; rr < 2; ++rr) {
      const size_t r = step_row + row[rr];
      const bool ok = valid[rr] && unit_ok;
      float da_r[4], da_z[4], dtanh[4], dhn[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float g_r = gv[0][rr][j], g_z = gv[1][rr][j], g_n = gv[2][rr][j];
        const float rg = sigmoid_f32(elem(in.x[0][rr], j) + g_r);
        const float z = sigmoid_f32(elem(in.x[1][rr], j) + g_z);
        const float n = tanhf(elem(in.x[2][rr], j) + rg * g_n);
        const float dht = elem(in.dy[rr], j) + dh[rr][j];
        const float dn = dht * (1.0f - z);
        const float dz = dht * (elem(in.hp[rr], j) - n);
        dtanh[j] = dn * (1.0f - n * n);
        da_r[j] = dtanh[j] * g_n * rg * (1.0f - rg);
        da_z[j] = dz * z * (1.0f - z);
        dhn[j] = dtanh[j] * rg;
        dhz[rr][j] = ok ? dht * z : 0.0f;
        if (ok) {
          db[0][j] += da_r[j];
          db[1][j] += da_z[j];
          db[2][j] += dhn[j];
        }
      }
      const float4 zero = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      q[0][rr] = ok ? make_float4(da_r[0], da_r[1], da_r[2], da_r[3]) : zero;
      q[1][rr] = ok ? make_float4(da_z[0], da_z[1], da_z[2], da_z[3]) : zero;
      q[2][rr] = ok ? make_float4(dhn[0], dhn[1], dhn[2], dhn[3]) : zero;
      if (ok) {
        float* dp = dproj + r * G3 + u;
        *reinterpret_cast<float4*>(dp) = q[0][rr];
        *reinterpret_cast<float4*>(dp + H) = q[1][rr];
        *reinterpret_cast<float4*>(dp + 2 * H) =
            make_float4(dtanh[0], dtanh[1], dtanh[2], dtanh[3]);
        float* dg = dgates + r * G3 + u;
#pragma unroll
        for (int gate = 0; gate < 3; ++gate)
          *reinterpret_cast<float4*>(dg + gate * H) = q[gate][rr];
      }
    }
    // The next step's inputs: `in` is spent, and the loads fly during the
    // product below.
    if (s + 1 < n_t) load_in(s + 1, in);

    // (A) every read of dg_s in the previous step is done
    __syncthreads();
    if (unit_ok) {
#pragma unroll
      for (int rr = 0; rr < 2; ++rr)
#pragma unroll
        for (int gate = 0; gate < 3; ++gate)
          *reinterpret_cast<float4*>(dg_s + (g + 8 * rr) * ld + gate * H + u) = q[gate][rr];
    }
    // (B) the tile's dgates are in dg_s
    __syncthreads();

    // dh = dh_total z + dgates . W_hh^T, one accumulator pair per gate block
    float acc[3][2][4], cor[3][2][4];
#pragma unroll
    for (int gate = 0; gate < 3; ++gate) {
#pragma unroll
      for (int hf = 0; hf < 2; ++hf)
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[gate][hf][i] = cor[gate][hf][i] = 0.0f;
#pragma unroll 2
      for (int k0 = gate * H; k0 < (gate + 1) * H; k0 += 8) {
        const SplitFrag<4> a = load_a_tf32(dg_s + k0, ld, lane);
#pragma unroll
        for (int hf = 0; hf < 2; ++hf) {
          const float* w = w_s + (size_t)(16 * warp + 8 * hf + g) * ld + k0 + t;
          mma_3xtf32(acc[gate][hf], cor[gate][hf], a, split_b_tf32(w[0], w[4]));
        }
      }
    }
#pragma unroll
    for (int rr = 0; rr < 2; ++rr)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int hf = j >> 1, i = 2 * rr + (j & 1);
        dh[rr][j] = dhz[rr][j] + ((acc[0][hf][i] + cor[0][hf][i]) +
                                  (acc[1][hf][i] + cor[1][hf][i]) +
                                  (acc[2][hf][i] + cor[2][hf][i]));
      }
  }

#pragma unroll
  for (int rr = 0; rr < 2; ++rr)
    if (valid[rr] && unit_ok)
      *reinterpret_cast<float4*>(dh0 + ((size_t)e * n_b + row[rr]) * H + u) =
          make_float4(dh[rr][0], dh[rr][1], dh[rr][2], dh[rr][3]);

  // This tile's db partial: the 8 lanes of one unit quad (lanes that differ
  // in bits 2..4) summed by a fixed tree, written by the lanes with g == 0.
  float* out = db_part + ((size_t)e * gridDim.x + blockIdx.x) * G3;
#pragma unroll
  for (int gate = 0; gate < 3; ++gate)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      float v = db[gate][j];
      v += __shfl_xor_sync(0xffffffffu, v, 4);
      v += __shfl_xor_sync(0xffffffffu, v, 8);
      v += __shfl_xor_sync(0xffffffffu, v, 16);
      if (g == 0 && unit_ok) out[gate * H + u + j] = v;
    }
}

// The float dW/db kernel: dw[e] = h_prev[e]^T . dgates[e] over n_k = T*B
// rows in 3xTF32; CTAs with blockIdx.y == 0 also write db[e].
__global__ void __launch_bounds__(kMmaGemmThreads)
gru_bwd_dw_tf32_kernel(const float* __restrict__ h_prev, const float* __restrict__ dgates,
                       const float* __restrict__ db_part, float* __restrict__ dw,
                       float* __restrict__ db, int n_k, int H, int n_tiles) {
  __shared__ __align__(16) float a_s[2][kTileK][kStageLd];  // h_prev rows [k][m]
  __shared__ __align__(16) float b_s[2][kTileK][kStageLd];  // dgates rows [k][n]
  const int G3 = 3 * H;
  const int e = blockIdx.z;
  const int m0 = blockIdx.y * kTileM;
  const int n0 = blockIdx.x * kTileN;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = frag_row(lane), t = lane & 3, c0 = frag_col(lane);
  const int wm = 32 * (warp / 2), wn = 32 * (warp % 2);
  const float* a_e = h_prev + (size_t)e * n_k * H;
  const float* b_e = dgates + (size_t)e * n_k * G3;

  // One K stage: 32 rows of 64 values of each operand, 16 bytes a copy;
  // rows past n_k and columns past H or 3H are zero-filled.
  auto stage = [&](int buf, int k0) {
    for (int i = threadIdx.x; i < kTileK * (kTileM / 4); i += kMmaGemmThreads) {
      const int kk = i / (kTileM / 4), c = (i % (kTileM / 4)) * 4;
      const int k = k0 + kk;
      const bool in_a = k < n_k && m0 + c < H;
      const bool in_b = k < n_k && n0 + c < G3;
      cp_async16(&a_s[buf][kk][c], in_a ? a_e + (size_t)k * H + m0 + c : a_e, in_a);
      cp_async16(&b_s[buf][kk][c], in_b ? b_e + (size_t)k * G3 + n0 + c : b_e, in_b);
    }
    cp_async_commit();
  };

  // Each K stage's products sum on the tensor cores into fresh big and
  // correction accumulators, which are then added to the running f32 sum
  // (round to nearest): a chain over all T*B rows on the tensor cores would
  // truncate at every step against the growing sum.
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
    float big[2][4][4], cor[2][4][4];
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int v = 0; v < 4; ++v) big[i][j][v] = cor[i][j][v] = 0.0f;
#pragma unroll
    for (int kk = 0; kk < kTileK; kk += 8) {
      const float* a_lo = &a_s[buf][kk + t][wm + g];       // (row g, k t)
      const float* a_hi = &a_s[buf][kk + t + 4][wm + g];   // (row g, k t+4)
      SplitFrag<4> a[2];
#pragma unroll
      for (int mi = 0; mi < 2; ++mi) {
        split_tf32(a_lo[16 * mi], a[mi].big[0], a[mi].small[0]);
        split_tf32(a_lo[16 * mi + 8], a[mi].big[1], a[mi].small[1]);
        split_tf32(a_hi[16 * mi], a[mi].big[2], a[mi].small[2]);
        split_tf32(a_hi[16 * mi + 8], a[mi].big[3], a[mi].small[3]);
      }
#pragma unroll
      for (int nj = 0; nj < 4; ++nj) {
        const SplitFrag<2> b = split_b_tf32(b_s[buf][kk + t][wn + 8 * nj + g],
                                            b_s[buf][kk + t + 4][wn + 8 * nj + g]);
#pragma unroll
        for (int mi = 0; mi < 2; ++mi) mma_3xtf32(big[mi][nj], cor[mi][nj], a[mi], b);
      }
    }
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int v = 0; v < 4; ++v) acc[i][j][v] += big[i][j][v] + cor[i][j][v];
    __syncthreads();                             // buf is refilled next
  }

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

// The kernels of each form: bf16 on the tensor cores, float in 3xTF32.
template <typename T, bool kStash>
constexpr auto bwd_kernel() {
  if constexpr (sizeof(T) == 2)
    return gru_bwd_mma_kernel<kStash>;
  else
    return gru_bwd_tf32_kernel<kStash>;
}

template <typename T>
constexpr auto dw_kernel() {
  if constexpr (sizeof(T) == 2)
    return gru_bwd_dw_mma_kernel;
  else
    return gru_bwd_dw_tf32_kernel;
}

template <typename T, bool kStash>
int launch(const void* proj, const void* h_prev, const void* gates,
           const void* w_hh, const void* b_hh, const void* dout, void* dproj,
           void* dw, void* db, void* dh0, void* dgates, void* db_part, int E,
           int n_t, int n_b, int H, int reverse, cudaStream_t stream) {
  const size_t smem = smem_bytes(H, sizeof(T) == 2);
  const auto kernel = bwd_kernel<T, kStash>();
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int n_tiles = (n_b + kRowTile - 1) / kRowTile;
  // H / 16 warps in bf16 (2H threads), ceil(H / 16) in float
  const int threads = sizeof(T) == 2 ? kRowGroups * H : 32 * ((H + 15) / 16);
  kernel<<<dim3(n_tiles, E), dim3(threads), smem, stream>>>(
      static_cast<const T*>(proj), static_cast<const T*>(h_prev),
      static_cast<const T*>(gates), static_cast<const T*>(w_hh),
      static_cast<const float*>(b_hh), static_cast<const T*>(dout),
      static_cast<T*>(dproj), static_cast<T*>(dgates),
      static_cast<float*>(db_part), static_cast<float*>(dh0), n_t, n_b, H,
      reverse);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((3 * H + kTileN - 1) / kTileN, (H + kTileM - 1) / kTileM, E);
  dw_kernel<T>()<<<grid, dim3(kMmaGemmThreads), 0, stream>>>(
      static_cast<const T*>(h_prev), static_cast<const T*>(dgates),
      static_cast<const float*>(db_part), static_cast<float*>(dw),
      static_cast<float*>(db), n_t * n_b, H, n_tiles);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Dynamic shared memory one recurrence CTA needs (the wrapper refuses shapes
// above the device's opt-in limit before launching).
size_t gru_bwd_smem_bytes(int H, int bf16) { return smem_bytes(H, bf16); }

int gru_bwd_max_threads(void) { return kMaxThreads; }

int gru_bwd_tf32_max_threads(void) { return kTf32MaxThreads; }

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
