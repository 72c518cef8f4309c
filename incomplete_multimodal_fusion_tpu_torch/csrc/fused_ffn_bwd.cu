// K2b: the backward of fused_ffn (K2), in its two modes:
//   GEGLU: dx, dgamma, dW_in, dW_out of LN -> xn . W_in^T -> val * gelu(gate)
//          -> . W_out^T;
//   MLP:   dx, dW1, db1, dW2, db2 of x . W1^T + b1 -> gelu -> . W2^T + b2.
// Weights and their gradients are in nn.Linear layout ([out, in]).
//
// Replaces two Pallas TPU kernels of the JAX package:
//   * ops/pallas_ffn.py _bwd_kernel (pallas_call in _ffn_bwd): GEGLU;
//   * ops/pallas_ffn.py _mlp_bwd_kernel (pallas_call in _mlp_bwd): MLP.
// Cast points are those of the Pallas bodies: xn and the GEGLU product a
// (pallas_ffn.py:124, :134), du (:143), dh (:320); the weight, gamma and
// bias gradients are summed in f32 and cast to the parameter dtype at the
// end (:174-176, :344-347).
//
// What bounds it on an H100: five products of 2 * M * d * I flops each
// (GEGLU at M = 38,400, d = 192, I = 512: 3.8 GFLOP each) against about
// 3 * M * d * 2 bytes of x, dy and dx -- tensor-core work, not HBM traffic,
// if the [M, 2I] activation and its gradient stayed on chip. On the TPU the
// weight gradients were carried in VMEM across a sequential grid
// (pallas_ffn.py:160-176); on the card no block carries anything to another,
// so the design has three launches:
//   1. row pass, one block per 32 rows: recompute LN (f32) and
//      u = xn . W_in^T, da = dy . W_out and the GELU parts (exact erf) per
//      16 x 16 tile, form du (bf16) in shared memory, dxn = du . W_in and
//      the bias-less LN backward (pallas_ffn.py:152-158) for dx. It also
//      writes du (or dh), the bf16 activation a and xn to device-memory
//      workspaces, and per-block f32 partial sums of dgamma (or db1, db2);
//   2. weight-gradient pass (wgrad.cuh): a tiled product C = A^T . B over
//      the rows, dW_in = du^T . xn and dW_out = dy^T . a (MLP: dW1 = dh^T . x,
//      dW2 = dy^T . a), 64 x 64 output tiles with wmma bf16 fragments and
//      f32 accumulators, the rows split into a few ranges so that enough
//      blocks fill the card, each range's f32 partial tile written out;
//   3. reduction: each output element sums its partials (tiles, then the
//      row-block vector partials) in a fixed order and casts to bf16.
// No atomics, so the result does not depend on the schedule. The
// workspaces cost device memory (du alone is 78 MB at M = 38,400) and one
// write and read each; keeping them on chip is work for a later version.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

#include "wgrad.cuh"

using namespace nvcuda;
using bf16 = __nv_bfloat16;
using wgrad::WGrad;

namespace {

constexpr int BM = 32;  // rows per block of the row pass
constexpr int WARPS = 8;
constexpr int THREADS = WARPS * 32;
constexpr int SCR_LD = 20;                // f32 pitch of a warp's 16 x 16 scratch tiles
constexpr int SCR_FLOATS = 3 * 16 * SCR_LD;  // val, gate, da
constexpr float LN_EPS = 1e-5f;

enum { MODE_GEGLU = 0, MODE_MLP = 1 };

using Acc = wmma::fragment<wmma::accumulator, 16, 16, 16, float>;

__host__ __device__ inline size_t row_smem_bytes(int mode, int d, int hw, int d_out) {
  return size_t(BM) * (d + 8) * sizeof(bf16)         // xn (GEGLU) or x (MLP)
         + size_t(BM) * (d_out + 8) * sizeof(bf16)   // dy
         + size_t(BM) * (hw + 8) * sizeof(bf16)      // du or dh
         + (mode == MODE_GEGLU ? size_t(BM) * d * sizeof(float) : 0)  // z
         + size_t(BM) * (d + 4) * sizeof(float)      // dxn or dx
         + size_t(WARPS) * SCR_FLOATS * sizeof(float)
         + size_t(BM) * sizeof(float);               // rstd
}

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

template <int MODE>
__global__ void __launch_bounds__(THREADS)
ffn_bwd_rows_kernel(const bf16* __restrict__ x, const bf16* __restrict__ gamma,
                    const bf16* __restrict__ w_in, const bf16* __restrict__ b_in,
                    const bf16* __restrict__ w_out, const bf16* __restrict__ dy, bf16* __restrict__ dx,
                    bf16* __restrict__ ws_h, bf16* __restrict__ ws_a, bf16* __restrict__ ws_xn,
                    float* __restrict__ vec_part, int m, int d, int hid, int d_out) {
  const int hw = MODE == MODE_GEGLU ? 2 * hid : hid;  // width of du / dh
  const int ldx = d + 8, ldy = d_out + 8, ldh = hw + 8, ldd = d + 4;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* xs = reinterpret_cast<bf16*>(smem);
  bf16* dys = xs + BM * ldx;
  bf16* hs = dys + BM * ldy;
  float* zs = reinterpret_cast<float*>(hs + BM * ldh);
  float* dxs = zs + (MODE == MODE_GEGLU ? BM * d : 0);
  float* scratch = dxs + BM * ldd;
  float* rstd_s = scratch + WARPS * SCR_FLOATS;

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int m0 = blockIdx.x * BM;
  float* scr = scratch + warp * SCR_FLOATS;
  const bf16 zero = __float2bfloat16(0.0f);

  // phase 1: one warp per row -- dy, and LN (GEGLU) or a copy of x (MLP)
  for (int r = warp; r < BM; r += WARPS) {
    const bool in = m0 + r < m;
    const bf16* yrow = dy + (long long)(m0 + r) * d_out;
    const bf16* xrow = x + (long long)(m0 + r) * d;
    for (int c = lane; c < d_out; c += 32) dys[r * ldy + c] = in ? yrow[c] : zero;
    if (MODE == MODE_MLP) {
      for (int c = lane; c < d; c += 32) xs[r * ldx + c] = in ? xrow[c] : zero;
      continue;
    }
    if (!in) {
      for (int c = lane; c < d; c += 32) {
        xs[r * ldx + c] = zero;
        zs[r * d + c] = 0.0f;
      }
      if (lane == 0) rstd_s[r] = 0.0f;
      continue;
    }
    float sum = 0.0f;
    for (int c = lane; c < d; c += 32) sum += __bfloat162float(xrow[c]);
    const float mean = warp_sum(sum) / d;
    float sq = 0.0f;
    for (int c = lane; c < d; c += 32) {
      const float t = __bfloat162float(xrow[c]) - mean;
      sq += t * t;
    }
    const float rstd = 1.0f / sqrtf(warp_sum(sq) / d + LN_EPS);
    for (int c = lane; c < d; c += 32) {
      const float z = (__bfloat162float(xrow[c]) - mean) * rstd;
      const bf16 xn = __float2bfloat16(z * __bfloat162float(gamma[c]));
      zs[r * d + c] = z;
      xs[r * ldx + c] = xn;
      ws_xn[(long long)(m0 + r) * d + c] = xn;
    }
    if (lane == 0) rstd_s[r] = rstd;
  }
  __syncthreads();

  // phase 2: per 16 x 16 tile of the hidden width, u (val, gate) and da,
  // then du (or dh) and a
  const int col_tiles = hid / 16;
  for (int t = warp; t < 2 * col_tiles; t += WARPS) {
    const int rb = t % 2;
    const int c0 = (t / 2) * 16;
    Acc val, gate, da;
    wmma::fill_fragment(val, 0.0f);
    wmma::fill_fragment(gate, 0.0f);
    wmma::fill_fragment(da, 0.0f);
    for (int kk = 0; kk < d; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a;
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> bw;
      wmma::load_matrix_sync(a, xs + rb * 16 * ldx + kk, ldx);
      wmma::load_matrix_sync(bw, w_in + (long long)c0 * d + kk, d);
      wmma::mma_sync(val, a, bw, val);
      if (MODE == MODE_GEGLU) {
        wmma::load_matrix_sync(bw, w_in + (long long)(hid + c0) * d + kk, d);
        wmma::mma_sync(gate, a, bw, gate);
      }
    }
    for (int kk = 0; kk < d_out; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a;
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> bw;
      wmma::load_matrix_sync(a, dys + rb * 16 * ldy + kk, ldy);
      wmma::load_matrix_sync(bw, w_out + (long long)kk * hid + c0, hid);
      wmma::mma_sync(da, a, bw, da);
    }
    wmma::store_matrix_sync(scr, val, SCR_LD, wmma::mem_row_major);
    wmma::store_matrix_sync(scr + 16 * SCR_LD, gate, SCR_LD, wmma::mem_row_major);
    wmma::store_matrix_sync(scr + 32 * SCR_LD, da, SCR_LD, wmma::mem_row_major);
    __syncwarp();
    for (int i = lane; i < 256; i += 32) {
      const int r = i / 16;
      const int c = i % 16;
      const int row = rb * 16 + r;
      const long long grow = (long long)m0 + row;
      const float v = scr[r * SCR_LD + c];
      const float g_da = scr[32 * SCR_LD + r * SCR_LD + c];
      const float g = MODE == MODE_GEGLU ? scr[16 * SCR_LD + r * SCR_LD + c]
                                         : v + __bfloat162float(b_in[c0 + c]);
      const float cdf = 0.5f * (1.0f + erff(g * 0.70710678118654752f));
      const float pdf = 0.39894228040143268f * expf(-0.5f * g * g);
      const float gd = cdf + g * pdf;
      if (MODE == MODE_GEGLU) {
        const float gv = g * cdf;
        const bf16 dval = __float2bfloat16(g_da * gv);
        const bf16 dgate = __float2bfloat16(g_da * v * gd);
        hs[row * ldh + c0 + c] = dval;
        hs[row * ldh + hid + c0 + c] = dgate;
        if (grow < m) {
          ws_h[grow * hw + c0 + c] = dval;
          ws_h[grow * hw + hid + c0 + c] = dgate;
          ws_a[grow * hid + c0 + c] = __float2bfloat16(v * gv);
        }
      } else {
        const bf16 dh = __float2bfloat16(g_da * gd);
        hs[row * ldh + c0 + c] = dh;
        if (grow < m) {
          ws_h[grow * hw + c0 + c] = dh;
          ws_a[grow * hid + c0 + c] = __float2bfloat16(g * cdf);
        }
      }
    }
    __syncwarp();
  }
  __syncthreads();

  // phase 3: dxn (or dx) [BM, d] = du [BM, hw] . W_in [hw, d]
  const int d_tiles = d / 16;
  for (int t = warp; t < 2 * d_tiles; t += WARPS) {
    const int rb = t / d_tiles;
    const int n0 = (t % d_tiles) * 16;
    Acc acc;
    wmma::fill_fragment(acc, 0.0f);
    for (int kk = 0; kk < hw; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a;
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> bw;
      wmma::load_matrix_sync(a, hs + rb * 16 * ldh + kk, ldh);
      wmma::load_matrix_sync(bw, w_in + (long long)kk * d + n0, d);
      wmma::mma_sync(acc, a, bw, acc);
    }
    wmma::store_matrix_sync(dxs + rb * 16 * ldd + n0, acc, ldd, wmma::mem_row_major);
  }
  __syncthreads();

  // phase 4: dx, and this block's partial sums of the vector gradients
  if (MODE == MODE_GEGLU) {
    for (int r = warp; r < BM; r += WARPS) {
      if (m0 + r >= m) continue;
      float s1 = 0.0f, s2 = 0.0f;
      for (int c = lane; c < d; c += 32) {
        const float dz = dxs[r * ldd + c] * __bfloat162float(gamma[c]);
        s1 += dz;
        s2 += dz * zs[r * d + c];
      }
      s1 = warp_sum(s1) / d;
      s2 = warp_sum(s2) / d;
      for (int c = lane; c < d; c += 32) {
        const float dz = dxs[r * ldd + c] * __bfloat162float(gamma[c]);
        dx[(long long)(m0 + r) * d + c] = __float2bfloat16((dz - s1 - zs[r * d + c] * s2) * rstd_s[r]);
      }
    }
    for (int c = threadIdx.x; c < d; c += THREADS) {
      float acc = 0.0f;
      for (int r = 0; r < BM; ++r) acc += dxs[r * ldd + c] * zs[r * d + c];
      vec_part[(long long)blockIdx.x * d + c] = acc;  // dgamma
    }
  } else {
    for (int r = warp; r < BM; r += WARPS) {
      if (m0 + r >= m) continue;
      for (int c = lane; c < d; c += 32) dx[(long long)(m0 + r) * d + c] = __float2bfloat16(dxs[r * ldd + c]);
    }
    const int vw = hid + d_out;
    for (int c = threadIdx.x; c < hid; c += THREADS) {
      float acc = 0.0f;
      for (int r = 0; r < BM; ++r) acc += __bfloat162float(hs[r * ldh + c]);
      vec_part[(long long)blockIdx.x * vw + c] = acc;  // db1
    }
    for (int c = threadIdx.x; c < d_out; c += THREADS) {
      float acc = 0.0f;
      for (int r = 0; r < BM; ++r) acc += __bfloat162float(dys[r * ldy + c]);
      vec_part[(long long)blockIdx.x * vw + hid + c] = acc;  // db2
    }
  }
}

// The three launches of one backward. g0 / g1: the two weight gradients
// (their partials, summed into out0 / out1); v0 / v1: the widths of the
// vector gradients (vout0 / vout1).
template <int MODE>
cudaError_t run(const bf16* x, const bf16* gamma, const bf16* w_in, const bf16* b_in, const bf16* w_out,
                const bf16* dy, bf16* dx, bf16* ws_h, bf16* ws_a, bf16* ws_xn, float* vec, int m, int d,
                int hid, int d_out, int splits, WGrad g0, bf16* out0, WGrad g1, bf16* out1, int v0,
                bf16* vout0, int v1, bf16* vout1, cudaStream_t stream) {
  if (m < 1 || d % 16 || hid % 16 || d_out % 16 || splits < 1) return cudaErrorInvalidValue;
  const int hw = MODE == MODE_GEGLU ? 2 * hid : hid;
  auto rows = ffn_bwd_rows_kernel<MODE>;
  const size_t bytes = row_smem_bytes(MODE, d, hw, d_out);
  cudaError_t err = cudaFuncSetAttribute(rows, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return err;
  const int blocks = (m + BM - 1) / BM;
  rows<<<blocks, THREADS, bytes, stream>>>(x, gamma, w_in, b_in, w_out, dy, dx, ws_h, ws_a, ws_xn, vec, m, d,
                                           hid, d_out);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  return wgrad::launch(g0, out0, g1, out1, m, splits, vec, blocks, v0, vout0, v1, vout1, stream);
}

}  // namespace

// Rows per block of the row pass: the vector partials are [ceil(M / this), w].
extern "C" int ffn_bwd_row_block() { return BM; }

// GEGLU: x, dy, dx [M, d]; gamma, dgamma [d]; w_in, dw_in [2I, d]; w_out,
// dw_out [d, I]; workspaces du [M, 2I], a [M, I], xn [M, d] (bf16),
// part f32 [splits * 3 * I * d], vec f32 [ceil(M / BM) * d]. All contiguous.
extern "C" int geglu_ffn_bwd_bf16(const void* x, const void* gamma, const void* w_in, const void* w_out,
                                  const void* dy, void* dx, void* dgamma, void* dw_in, void* dw_out, void* ws_du,
                                  void* ws_a, void* ws_xn, void* part, void* vec, int m, int d, int inner,
                                  int splits, void* stream) {
  float* p = static_cast<float*>(part);
  const WGrad g0{static_cast<const bf16*>(ws_du), static_cast<const bf16*>(ws_xn), p, 2 * inner, d};
  const WGrad g1{static_cast<const bf16*>(dy), static_cast<const bf16*>(ws_a),
                 p + (long long)splits * 2 * inner * d, d, inner};
  return (int)run<MODE_GEGLU>(
      static_cast<const bf16*>(x), static_cast<const bf16*>(gamma), static_cast<const bf16*>(w_in), nullptr,
      static_cast<const bf16*>(w_out), static_cast<const bf16*>(dy), static_cast<bf16*>(dx),
      static_cast<bf16*>(ws_du), static_cast<bf16*>(ws_a), static_cast<bf16*>(ws_xn), static_cast<float*>(vec),
      m, d, inner, d, splits, g0, static_cast<bf16*>(dw_in), g1, static_cast<bf16*>(dw_out), d,
      static_cast<bf16*>(dgamma), 0, nullptr, static_cast<cudaStream_t>(stream));
}

// MLP: x, dx [M, d]; w1, dw1 [H, d]; b1, db1 [H]; w2, dw2 [O, H]; db2 [O];
// dy [M, O]; workspaces dh [M, H], a [M, H] (bf16), part f32
// [splits * H * (d + O)], vec f32 [ceil(M / BM) * (H + O)]. All contiguous.
extern "C" int mlp_ffn_bwd_bf16(const void* x, const void* w1, const void* b1, const void* w2, const void* dy,
                                void* dx, void* dw1, void* db1, void* dw2, void* db2, void* ws_dh, void* ws_a,
                                void* part, void* vec, int m, int d, int hidden, int d_out, int splits,
                                void* stream) {
  float* p = static_cast<float*>(part);
  const WGrad g0{static_cast<const bf16*>(ws_dh), static_cast<const bf16*>(x), p, hidden, d};
  const WGrad g1{static_cast<const bf16*>(dy), static_cast<const bf16*>(ws_a),
                 p + (long long)splits * hidden * d, d_out, hidden};
  return (int)run<MODE_MLP>(
      static_cast<const bf16*>(x), nullptr, static_cast<const bf16*>(w1), static_cast<const bf16*>(b1),
      static_cast<const bf16*>(w2), static_cast<const bf16*>(dy), static_cast<bf16*>(dx),
      static_cast<bf16*>(ws_dh), static_cast<bf16*>(ws_a), nullptr, static_cast<float*>(vec), m, d, hidden,
      d_out, splits, g0, static_cast<bf16*>(dw1), g1, static_cast<bf16*>(dw2), hidden, static_cast<bf16*>(db1),
      d_out, static_cast<bf16*>(db2), static_cast<cudaStream_t>(stream));
}
