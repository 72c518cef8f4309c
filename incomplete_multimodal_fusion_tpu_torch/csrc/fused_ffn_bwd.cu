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
// (GEGLU at M = 38,400, d = 192, I = 512: 3.8 GFLOP each, 0.019 ms at the
// bf16 tensor-core rate) against about 3 * M * d * 2 bytes of x, dy and dx
// -- tensor-core work, if the [M, 2I] activation and its gradient stayed on
// chip. On the TPU the weight gradients were carried in VMEM across a
// sequential grid (pallas_ffn.py:160-176); on the card no block carries
// anything to another, so the design has three launches:
//   1. row pass, one block per 128 rows, two consumer warpgroups of 64 rows
//      each: LN recomputed in f32 (GEGLU; x as it is for MLP) into a bf16 xn
//      tile and dy into a second tile, both in shared memory in the
//      hardware's 128-byte swizzle; then a loop over the hidden width in
//      chunks of 32, the chunk's W_in rows (val, and gate) and W_out columns
//      streamed into shared memory by cp.async, double-buffered, where both
//      warpgroups read them:
//        val, gate = xn . W_in[chunk]^T and da = dy . W_out[:, chunk] as
//        wgmma products with register accumulators (W_out's columns through
//        the transpose bit);
//        the exact-erf GELU parts and du (or dh) formed on the accumulator
//        fragments, cast to bf16, which are at once the A fragments of
//        dxn += du[chunk] . W_in[chunk] (wgmma, A from registers; the same
//        W_in tile read MN-major), accumulated in registers over the chunks;
//      so du never exists whole on chip. Then the bias-less LN backward
//      (pallas_ffn.py:152-158) for dx, with x re-read for z, and one f32
//      partial row of dgamma (or db1, db2) per block. The pass also writes
//      du (or dh), the bf16 activation a and xn to device-memory workspaces
//      for the weight gradients;
//   2. weight-gradient pass (wgrad.cuh, wgmma): dW_in = du^T . xn and
//      dW_out = (a^T . dy)^T (MLP: dW1 = dh^T . x, dW2 = (a^T . dy)^T), the
//      rows split into a few ranges, each range's f32 partial tile written
//      out;
//   3. reduction: each output element sums its partials (tiles, then the
//      row-block vector partials) in a fixed order and casts to bf16.
// The row pass holds d and d_out up to MAX_D (the dx accumulator is d / 2
// registers a thread, the row tiles sit in shared memory). Past that (the
// `base` and `large` widths) a wide path takes its place: a row pass that
// streams xn and dy in windows and forms du without dx, a product
// dxn = du . W_in over the hidden width, and the LN backward (see
// ffn_bwd_wide_rows_kernel). The weight gradients are the same.
// No atomics, so two calls are bitwise equal. The workspaces cost device
// memory (du alone is 78 MB at M = 38,400) and one write and read each: at
// 3.35 TB/s about 0.08 ms at that M (an estimate, not measured), against
// recomputing u and da per hidden slice in the weight-gradient pass
// (16 -> 22 M d I flops); which is faster is not measured.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>

#include "hopper.cuh"
#include "simt_f32.cuh"
#include "wgrad.cuh"

using bf16 = __nv_bfloat16;
using wgrad::WGrad;

namespace {

using namespace hopper;

constexpr int BM = 128;  // rows per block of the row pass: two warpgroups of 64
constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int HC = 32;   // hidden columns a chunk
constexpr int MAX_D = 256;  // the row pass's d and d_out: its dx accumulator is d / 2 registers a thread
constexpr int MAX_SMEM = 232448;  // a block's shared memory on sm_90 (227 KB)
constexpr float LN_EPS = 1e-5f;

enum { MODE_GEGLU = 0, MODE_MLP = 1 };

// Byte offsets in the row pass's shared memory (from its 1024-byte aligned
// start): the xn (or x) tile [BM, dp] and the dy tile [BM, dop] (dp, dop: d
// and d_out rounded up to 64, the padding zeros); per stage the chunk's W_in
// rows [HC, dp] (W1 rows in MLP), gate rows [HC, dp] (GEGLU) and W_out
// columns [d_out, HC] (64-byte swizzle); the rows' mean and rstd; the
// column sums of two chunks' dh (MLP db1) per warp.
struct RowSmem {
  uint32_t xs, dys, stages, wv, wg, wo, stage_bytes, stats, red, bytes;
};

__host__ __device__ inline RowSmem row_smem(int mode, int d, int d_out) {
  const uint32_t dp = (d + 63) / 64 * 64, dop = (d_out + 63) / 64 * 64;
  RowSmem L;
  L.xs = 0;
  L.dys = L.xs + BM * dp * 2;
  L.stages = L.dys + BM * dop * 2;
  L.wv = 0;
  L.wg = HC * dp * 2;
  L.wo = L.wg + (mode == MODE_GEGLU ? HC * dp * 2 : 0);
  L.stage_bytes = (L.wo + d_out * 64 + 1023) / 1024 * 1024;
  L.stats = L.stages + 2 * L.stage_bytes;
  L.red = L.stats + 2 * BM * 4;
  L.bytes = L.red + 2 * WARPS * HC * 4 + 1024;  // + the alignment slack
  return L;
}

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// the sum over the 8 row groups of a warp (lanes with the same lane % 4)
__device__ __forceinline__ float column_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 4);
  v += __shfl_xor_sync(0xffffffffu, v, 8);
  return v + __shfl_xor_sync(0xffffffffu, v, 16);
}

__device__ __forceinline__ uint32_t bits(__nv_bfloat162 v) { return *reinterpret_cast<uint32_t*>(&v); }

// element c of row r of a bf16 tile in the 128-byte swizzle
__device__ __forceinline__ float tile_at(const unsigned char* tile, int r, int c, int rows) {
  return __bfloat162float(*reinterpret_cast<const bf16*>(tile + Sw128::offset(r, c / 8, rows) + (c % 8) * 2));
}

// The GELU parts of hidden chunk c0 .. c0 + HC on the accumulator fragments
// of val, gate and da (this thread's rows row0 and row0 + 8; columns
// c0 + 8 j + 2 t4 and the next): du = [da gelu(gate), da val gelu'(gate)]
// (MLP: dh = da gelu'(h), h = val + b_in) and a = val gelu(gate) (MLP:
// gelu(h)), cast to bf16 and stored to their workspaces. The bf16 du pairs
// are also the A fragments of dxn += du . W_in (fa; fb for the gate half:
// the fragment of column pair 8 j + 2 t4 is that of k-step j / 2); csum
// (MLP): this thread's sums of the rounded dh over its two rows.
template <int MODE>
__device__ __forceinline__ void gelu_chunk(const float (&val)[16], const float (&gate)[16], const float (&da)[16],
                                           const bf16* __restrict__ b_in, bf16* __restrict__ ws_h,
                                           bf16* __restrict__ ws_a, int m, long long row0, int c0, int hid, int t4,
                                           uint32_t (&fa)[2][4], uint32_t (&fb)[2][4], float (&csum)[8]) {
  const int hw = MODE == MODE_GEGLU ? 2 * hid : hid;  // width of du / dh
#pragma unroll
  for (int j = 0; j < 4; ++j)
#pragma unroll
    for (int hi = 0; hi < 2; ++hi) {
      const int i = 4 * j + 2 * hi;
      const int col = c0 + 8 * j + 2 * t4;
      const long long grow = row0 + 8 * hi;
      float out0[2], out1[2], act[2];
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const float v = val[i + e], g_da = da[i + e];
        const float g = MODE == MODE_GEGLU ? gate[i + e]
                                           : v + (col + e < hid ? __bfloat162float(b_in[col + e]) : 0.0f);
        const float cdf = 0.5f * (1.0f + erff(g * 0.70710678118654752f));
        const float pdf = 0.39894228040143268f * expf(-0.5f * g * g);
        const float gd = cdf + g * pdf;
        if (MODE == MODE_GEGLU) {
          const float gv = g * cdf;
          out0[e] = g_da * gv;
          out1[e] = g_da * v * gd;
          act[e] = v * gv;
        } else {
          out0[e] = g_da * gd;
          act[e] = g * cdf;
        }
      }
      const __nv_bfloat162 h0 = __floats2bfloat162_rn(out0[0], out0[1]);
      fa[j / 2][2 * (j % 2) + hi] = bits(h0);
      const bool store = grow < m && col < hid;
      if (store) {
        *reinterpret_cast<__nv_bfloat162*>(ws_h + grow * hw + col) = h0;
        *reinterpret_cast<__nv_bfloat162*>(ws_a + grow * hid + col) = __floats2bfloat162_rn(act[0], act[1]);
      }
      if (MODE == MODE_GEGLU) {
        const __nv_bfloat162 h1 = __floats2bfloat162_rn(out1[0], out1[1]);
        fb[j / 2][2 * (j % 2) + hi] = bits(h1);
        if (store) *reinterpret_cast<__nv_bfloat162*>(ws_h + grow * hw + hid + col) = h1;
      } else {
        const float2 f = __bfloat1622float2(h0);  // db1 sums the rounded dh
        csum[2 * j] = (hi ? csum[2 * j] : 0.0f) + f.x;
        csum[2 * j + 1] = (hi ? csum[2 * j + 1] : 0.0f) + f.y;
      }
    }
}

// MLP: a warp's column sums of dh over its 16 rows into its slot of the
// chunk's db1 buffer (HC floats)
__device__ __forceinline__ void store_column_sums(float (&csum)[8], float* slot, int lane, int t4) {
#pragma unroll
  for (int k = 0; k < 8; ++k) csum[k] = column_sum(csum[k]);
  if (lane < 4) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      slot[8 * j + 2 * t4] = csum[2 * j];
      slot[8 * j + 2 * t4 + 1] = csum[2 * j + 1];
    }
  }
}

// MLP: the db1 partial of chunk c, the warps' slots (buffer c % 2 of `red`)
// summed in order, into the block's row of vec_part
__device__ __forceinline__ void flush_db1(const float* red, int c, int hid, int d_out, float* __restrict__ vec_part) {
  const int col = c * HC + threadIdx.x;
  if (threadIdx.x < HC && col < hid) {
    const float* rs = red + (c & 1) * WARPS * HC;
    float s = 0.0f;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) s += rs[w * HC + threadIdx.x];
    vec_part[(long long)blockIdx.x * (hid + d_out) + col] = s;
  }
}

// The row pass. DP: d rounded up to 64 (64 .. 256), the width of the dx
// accumulator. Block = BM rows; warpgroup wg owns rows [64 wg, 64 wg + 64).
template <int MODE, int DP>
__global__ void __launch_bounds__(THREADS, 1)
ffn_bwd_rows_kernel(const bf16* __restrict__ x, const bf16* __restrict__ gamma, const bf16* __restrict__ w_in,
                    const bf16* __restrict__ b_in, const bf16* __restrict__ w_out, const bf16* __restrict__ dy,
                    bf16* __restrict__ dx, bf16* __restrict__ ws_h, bf16* __restrict__ ws_a, bf16* __restrict__ ws_xn,
                    float* __restrict__ vec_part, int m, int d, int hid, int d_out) {
  constexpr int NB = DP / 64;
  const RowSmem L = row_smem(MODE, d, d_out);
  extern __shared__ unsigned char smem_raw[];
  unsigned char* sm;
  const uint32_t sa = aligned_smem(smem_raw, &sm);
  const int dop = (d_out + 63) / 64 * 64;
  const int m0 = blockIdx.x * BM;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int t4 = lane & 3;
  const int wg = threadIdx.x / 128;
  const int rb = wg * 64 + (warp % 4) * 16 + lane / 4;  // this thread's rows of the block: rb, rb + 8
  float* mean_s = reinterpret_cast<float*>(sm + L.stats);
  float* rstd_s = mean_s + BM;
  float* red = reinterpret_cast<float*>(sm + L.red);
  const int chunks = (hid + HC - 1) / HC;

  // the W_in rows and W_out columns of hidden chunk c into a stage; rows
  // past hid and columns past d are zeros
  auto load_w = [&](int c, int stage) {
    const uint32_t st = sa + L.stages + stage * L.stage_bytes;
    const int c0 = c * HC;
    for (int i = threadIdx.x; i < HC * (DP / 8); i += THREADS) {
      const int r = i / (DP / 8), cc = i % (DP / 8);
      const bool in = c0 + r < hid && 8 * cc < d;
      cp_async16(st + L.wv + Sw128::offset(r, cc, HC), w_in + (in ? (long long)(c0 + r) * d + 8 * cc : 0), in);
      if (MODE == MODE_GEGLU)
        cp_async16(st + L.wg + Sw128::offset(r, cc, HC), w_in + (in ? (long long)(hid + c0 + r) * d + 8 * cc : 0),
                   in);
    }
    for (int i = threadIdx.x; i < d_out * (HC / 8); i += THREADS) {
      const int r = i / (HC / 8), cc = i % (HC / 8);
      const bool in = c0 + 8 * cc < hid;
      cp_async16(st + L.wo + Sw64::offset(r, cc), w_out + (in ? (long long)r * hid + c0 + 8 * cc : 0), in);
    }
  };
  // rows [m0, m0 + BM) of a [m, width] operand into a tile of `padded`
  // columns; past m and width: zeros
  auto load_rows = [&](uint32_t dst, const bf16* src, int width, int padded) {
    for (int i = threadIdx.x; i < BM * (padded / 8); i += THREADS) {
      const int r = i / (padded / 8), cc = i % (padded / 8);
      const bool in = m0 + r < m && 8 * cc < width;
      cp_async16(dst + Sw128::offset(r, cc, BM), src + (in ? (long long)(m0 + r) * width + 8 * cc : 0), in);
    }
  };

  load_rows(sa + L.dys, dy, d_out, dop);
  if (MODE == MODE_MLP) load_rows(sa + L.xs, x, d, DP);
  load_w(0, 0);
  cp_async_commit();

  if (MODE == MODE_GEGLU) {
    // LayerNorm, a warp per row, 8 columns a lane (d <= 256): xn into its
    // tile (zeros past d and m) and its workspace, the statistics kept
    for (int r = warp; r < BM; r += WARPS) {
      const int grow = m0 + r;
      const int c = 8 * lane;
      const bool in = grow < m && c < d;
      float xv[8];
      if (in) {
        const uint4 u = *reinterpret_cast<const uint4*>(x + (long long)grow * d + c);
        const __nv_bfloat162* h2 = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          const float2 f = __bfloat1622float2(h2[k]);
          xv[2 * k] = f.x;
          xv[2 * k + 1] = f.y;
        }
      } else {
#pragma unroll
        for (int k = 0; k < 8; ++k) xv[k] = 0.0f;
      }
      float sum = 0.0f;
#pragma unroll
      for (int k = 0; k < 8; ++k) sum += xv[k];
      const float mean = warp_sum(sum) / d;
      float sq = 0.0f;
      if (in) {
#pragma unroll
        for (int k = 0; k < 8; ++k) sq += (xv[k] - mean) * (xv[k] - mean);
      }
      const float rstd = grow < m ? 1.0f / sqrtf(warp_sum(sq) / d + LN_EPS) : 0.0f;
      uint4 packed = make_uint4(0u, 0u, 0u, 0u);
      if (in) {
        const uint4 gu = *reinterpret_cast<const uint4*>(gamma + c);
        const __nv_bfloat162* g2 = reinterpret_cast<const __nv_bfloat162*>(&gu);
        uint32_t* p = reinterpret_cast<uint32_t*>(&packed);
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          const float2 gf = __bfloat1622float2(g2[k]);
          p[k] = bits(__floats2bfloat162_rn((xv[2 * k] - mean) * rstd * gf.x, (xv[2 * k + 1] - mean) * rstd * gf.y));
        }
        *reinterpret_cast<uint4*>(ws_xn + (long long)grow * d + c) = packed;
      }
      if (c < DP) *reinterpret_cast<uint4*>(sm + L.xs + Sw128::offset(r, lane, BM)) = packed;
      if (lane == 0) {
        mean_s[r] = grow < m ? mean : 0.0f;
        rstd_s[r] = rstd;
      }
    }
  } else {
    // db2: this block's column sums of dy
    cp_async_wait_all();
    __syncthreads();
    for (int c = threadIdx.x; c < d_out; c += THREADS) {
      float s = 0.0f;
      for (int r = 0; r < BM; ++r) s += tile_at(sm + L.dys, r, c, BM);
      vec_part[(long long)blockIdx.x * (hid + d_out) + hid + c] = s;
    }
  }

  float dxn[NB][32];
#pragma unroll
  for (int cb = 0; cb < NB; ++cb)
#pragma unroll
    for (int i = 0; i < 32; ++i) dxn[cb][i] = 0.0f;
  const uint32_t xa = sa + L.xs + wg * 64 * 128;  // this warpgroup's 64 rows of the xn and dy tiles
  const uint32_t ya = sa + L.dys + wg * 64 * 128;

  for (int c = 0; c < chunks; ++c) {
    const int stage = c & 1;
    cp_async_wait_all();
    fence_async_smem();
    __syncthreads();  // chunk c (and the tiles) have landed; the other stage is free
    if (MODE == MODE_MLP && c > 0) flush_db1(red, c - 1, hid, d_out, vec_part);
    if (c + 1 < chunks) {
      load_w(c + 1, stage ^ 1);
      cp_async_commit();
    }
    const uint32_t st = sa + L.stages + stage * L.stage_bytes;

    // val (h before its bias), gate = xn . W_in[chunk]^T; da = dy . W_out[:, chunk]
    float val[16], gate[16], da[16];
#pragma unroll
    for (int i = 0; i < 16; ++i) val[i] = gate[i] = da[i] = 0.0f;
    wgmma_fence();
    for (int kk = 0; kk < d / 16; ++kk) {
      wgmma_ss_n32<0, 0>(val, Sw128::kmajor(xa, BM, kk), Sw128::kmajor(st + L.wv, HC, kk));
      if (MODE == MODE_GEGLU) wgmma_ss_n32<0, 0>(gate, Sw128::kmajor(xa, BM, kk), Sw128::kmajor(st + L.wg, HC, kk));
    }
    for (int kk = 0; kk < d_out / 16; ++kk)
      wgmma_ss_n32<0, 1>(da, Sw128::kmajor(ya, BM, kk), Sw64::mnmajor(st + L.wo, kk));
    wgmma_commit();
    wgmma_wait_all();
    keep(val);
    if (MODE == MODE_GEGLU) keep(gate);
    keep(da);

    uint32_t fa[2][4], fb[2][4];
    float csum[8];
    gelu_chunk<MODE>(val, gate, da, b_in, ws_h, ws_a, m, (long long)m0 + rb, c * HC, hid, t4, fa, fb, csum);

    // dxn += du[chunk] . W_in[chunk]: A from registers, the W_in tile MN-major
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < HC / 16; ++kk)
#pragma unroll
      for (int cb = 0; cb < NB; ++cb) {
        wgmma_rs_n64(dxn[cb], fa[kk], Sw128::mnmajor(st + L.wv + cb * HC * 128, HC, kk));
        if (MODE == MODE_GEGLU) wgmma_rs_n64(dxn[cb], fb[kk], Sw128::mnmajor(st + L.wg + cb * HC * 128, HC, kk));
      }
    wgmma_commit();
    if (MODE == MODE_MLP)  // while the product runs: this warp's db1 column sums
      store_column_sums(csum, red + stage * WARPS * HC + warp * HC, lane, t4);
    wgmma_wait_all();
#pragma unroll
    for (int cb = 0; cb < NB; ++cb) keep(dxn[cb]);
    keep(fa);
    if (MODE == MODE_GEGLU) keep(fb);
  }
  __syncthreads();  // every product is done: the stages are free
  if (MODE == MODE_MLP) {
    flush_db1(red, chunks - 1, hid, d_out, vec_part);
#pragma unroll
    for (int hi = 0; hi < 2; ++hi) {
      const long long grow = (long long)m0 + rb + 8 * hi;
      if (grow >= m) continue;
#pragma unroll
      for (int cb = 0; cb < NB; ++cb)
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const int col = cb * 64 + 8 * j + 2 * t4;
          if (col < d)
            *reinterpret_cast<__nv_bfloat162*>(dx + grow * d + col) =
                __floats2bfloat162_rn(dxn[cb][4 * j + 2 * hi], dxn[cb][4 * j + 2 * hi + 1]);
        }
    }
    return;
  }

  // GEGLU: dgamma = sum over rows of dxn z, and the LN backward
  // dx = (dz - mean(dz) - z mean(dz z)) rstd with dz = dxn gamma; z again
  // from x and the kept statistics
  float* gred = reinterpret_cast<float*>(sm + L.stages);  // [WARPS][DP]
  float mean[2], rstd[2], s1[2] = {0.0f, 0.0f}, s2[2] = {0.0f, 0.0f};
  long long grow[2];
#pragma unroll
  for (int hi = 0; hi < 2; ++hi) {
    mean[hi] = mean_s[rb + 8 * hi];
    rstd[hi] = rstd_s[rb + 8 * hi];
    grow[hi] = (long long)m0 + rb + 8 * hi;
  }
  auto z_of = [&](int hi, int col, float* z) {
    if (grow[hi] < m && col < d) {
      const float2 xv = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(x + grow[hi] * d + col));
      z[0] = (xv.x - mean[hi]) * rstd[hi];
      z[1] = (xv.y - mean[hi]) * rstd[hi];
    } else {
      z[0] = z[1] = 0.0f;
    }
  };
#pragma unroll
  for (int cb = 0; cb < NB; ++cb)
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int col = cb * 64 + 8 * j + 2 * t4;
      float gp[2] = {0.0f, 0.0f};
      float gm[2] = {0.0f, 0.0f};
      if (col < d) {
        const float2 g2 = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(gamma + col));
        gm[0] = g2.x;
        gm[1] = g2.y;
      }
#pragma unroll
      for (int hi = 0; hi < 2; ++hi) {
        float z[2];
        z_of(hi, col, z);
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float v = dxn[cb][4 * j + 2 * hi + e];
          const float dz = v * gm[e];
          s1[hi] += dz;
          s2[hi] += dz * z[e];
          gp[e] += v * z[e];
        }
      }
      gp[0] = column_sum(gp[0]);
      gp[1] = column_sum(gp[1]);
      if (lane < 4) {
        gred[warp * DP + col] = gp[0];
        gred[warp * DP + col + 1] = gp[1];
      }
    }
#pragma unroll
  for (int hi = 0; hi < 2; ++hi) {
    s1[hi] += __shfl_xor_sync(0xffffffffu, s1[hi], 1);
    s1[hi] += __shfl_xor_sync(0xffffffffu, s1[hi], 2);
    s2[hi] += __shfl_xor_sync(0xffffffffu, s2[hi], 1);
    s2[hi] += __shfl_xor_sync(0xffffffffu, s2[hi], 2);
    s1[hi] /= d;
    s2[hi] /= d;
  }
#pragma unroll
  for (int cb = 0; cb < NB; ++cb)
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int col = cb * 64 + 8 * j + 2 * t4;
      if (col >= d) continue;
      const float2 g2 = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(gamma + col));
#pragma unroll
      for (int hi = 0; hi < 2; ++hi) {
        if (grow[hi] >= m) continue;
        float z[2];
        z_of(hi, col, z);
        const float dz0 = dxn[cb][4 * j + 2 * hi] * g2.x, dz1 = dxn[cb][4 * j + 2 * hi + 1] * g2.y;
        *reinterpret_cast<__nv_bfloat162*>(dx + grow[hi] * d + col) = __floats2bfloat162_rn(
            (dz0 - s1[hi] - z[0] * s2[hi]) * rstd[hi], (dz1 - s1[hi] - z[1] * s2[hi]) * rstd[hi]);
      }
    }
  __syncthreads();
  for (int c = threadIdx.x; c < d; c += THREADS) {
    float s = 0.0f;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) s += gred[w * DP + c];
    vec_part[(long long)blockIdx.x * d + c] = s;  // dgamma
  }
}

// The wide path, for d or d_out past MAX_D, whose dx accumulator and row
// tiles the row pass cannot hold: four launches in its place.
//   a. GEGLU: LayerNorm, a warp a row, into the xn workspace;
//   b. the wide row pass: blocks of BM rows and a slice of the hidden
//      chunks of HC columns (the slices fill the card at small M), xn (x)
//      and dy not resident: each chunk's products stream them in windows
//      of KW reduction columns beside the W_in and W_out tiles of the
//      window (cp.async, double-buffered). The GELU parts are the row
//      pass's (gelu_chunk); du, a and the vector partials go to the same
//      workspaces, and there is no dx;
//   c. dxn = du . W_in (MLP: dx = dh . W1), a product of 128-row by 64 NB
//      column tiles over the hidden width, f32 out for GEGLU;
//   d. GEGLU: the bias-less LN backward, a warp a row, and the block's
//      dgamma partial.
constexpr int KW = 64;  // reduction columns a window

// Byte offsets of one stage of the wide row pass: the xn (x) window
// [BM, KW], the chunk's W_in rows [HC, KW] (gate rows after them, GEGLU),
// the dy window [BM, KW] and W_out's window rows [KW, HC] (64-byte
// swizzle); two stages, then the db1 buffers.
struct WideSmem {
  static constexpr uint32_t XW = 0, WV = XW + BM * KW * 2, WG = WV + HC * KW * 2, DYW = WG + HC * KW * 2,
                            WO = DYW + BM * KW * 2, STAGE = WO + KW * HC * 2, RED = 2 * STAGE,
                            BYTES = RED + 2 * WARPS * HC * 4 + 1024;  // + the alignment slack
};
static_assert(WideSmem::STAGE % 1024 == 0 && WideSmem::DYW % 1024 == 0, "swizzled tiles start on 1 KB");

template <int MODE>
__global__ void __launch_bounds__(THREADS, 2)
ffn_bwd_wide_rows_kernel(const bf16* __restrict__ x, const bf16* __restrict__ w_in,
                         const bf16* __restrict__ b_in, const bf16* __restrict__ w_out, const bf16* __restrict__ dy,
                         bf16* __restrict__ ws_h, bf16* __restrict__ ws_a, bf16* __restrict__ ws_xn,
                         float* __restrict__ vec_part, int m, int d, int hid, int d_out, int cps) {
  using L = WideSmem;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* sm;
  const uint32_t sa = aligned_smem(smem_raw, &sm);
  const int m0 = blockIdx.x * BM;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int t4 = lane & 3;
  const int wg = threadIdx.x / 128;
  const int rb = wg * 64 + (warp % 4) * 16 + lane / 4;
  float* red = reinterpret_cast<float*>(sm + L::RED);
  const int chunks = (hid + HC - 1) / HC;
  const int c_begin = blockIdx.y * cps, c_end = min(chunks, c_begin + cps);  // this block's slice
  const int windows = ((d > d_out ? d : d_out) + KW - 1) / KW;
  const int steps = (c_end - c_begin) * windows;
  const bf16* xs = MODE == MODE_GEGLU ? ws_xn : x;

  if (MODE == MODE_MLP && blockIdx.y == 0) {
    // db2: this block's column sums of dy
    for (int c = threadIdx.x; c < d_out; c += THREADS) {
      float s = 0.0f;
      for (int r = 0; r < BM && m0 + r < m; ++r) s += __bfloat162float(dy[(long long)(m0 + r) * d_out + c]);
      vec_part[(long long)blockIdx.x * (hid + d_out) + hid + c] = s;
    }
  }

  // step s: chunk c_begin + s / windows, window s % windows, into a stage;
  // past m, d, d_out and hid: zeros
  auto load = [&](int s, int stage) {
    const int c0 = (c_begin + s / windows) * HC, k0 = (s % windows) * KW;
    const uint32_t st = sa + stage * L::STAGE;
    for (int i = threadIdx.x; i < BM * (KW / 8); i += THREADS) {
      const int r = i / (KW / 8), cc = i % (KW / 8);
      const long long grow = m0 + r;
      const int col = k0 + 8 * cc;
      const bool in_x = grow < m && col < d, in_y = grow < m && col < d_out;
      cp_async16(st + L::XW + Sw128::offset(r, cc, BM), xs + (in_x ? grow * d + col : 0), in_x);
      cp_async16(st + L::DYW + Sw128::offset(r, cc, BM), dy + (in_y ? grow * d_out + col : 0), in_y);
    }
    for (int i = threadIdx.x; i < HC * (KW / 8); i += THREADS) {
      const int r = i / (KW / 8), cc = i % (KW / 8);
      const bool in = c0 + r < hid && k0 + 8 * cc < d;
      cp_async16(st + L::WV + Sw128::offset(r, cc, HC), w_in + (in ? (long long)(c0 + r) * d + k0 + 8 * cc : 0), in);
      if (MODE == MODE_GEGLU)
        cp_async16(st + L::WG + Sw128::offset(r, cc, HC),
                   w_in + (in ? (long long)(hid + c0 + r) * d + k0 + 8 * cc : 0), in);
    }
    for (int i = threadIdx.x; i < KW * (HC / 8); i += THREADS) {
      const int r = i / (HC / 8), cc = i % (HC / 8);
      const bool in = k0 + r < d_out && c0 + 8 * cc < hid;
      cp_async16(st + L::WO + Sw64::offset(r, cc), w_out + (in ? (long long)(k0 + r) * hid + c0 + 8 * cc : 0), in);
    }
  };

  load(0, 0);
  cp_async_commit();
  float val[16], gate[16], da[16];
  for (int s = 0; s < steps; ++s) {
    const int stage = s & 1, c = c_begin + s / windows, k0 = (s % windows) * KW;
    cp_async_wait_all();
    fence_async_smem();
    __syncthreads();  // step s has landed; the other stage is free
    if (MODE == MODE_MLP && k0 == 0 && c > c_begin) flush_db1(red, c - 1, hid, d_out, vec_part);
    if (s + 1 < steps) {
      load(s + 1, stage ^ 1);
      cp_async_commit();
    }
    if (k0 == 0) {
#pragma unroll
      for (int i = 0; i < 16; ++i) val[i] = gate[i] = da[i] = 0.0f;
    }
    const uint32_t st = sa + stage * L::STAGE;
    const uint32_t xa = st + L::XW + wg * 64 * 128, ya = st + L::DYW + wg * 64 * 128;
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < KW / 16; ++kk) {
      if (k0 + 16 * kk < d) {
        wgmma_ss_n32<0, 0>(val, Sw128::kmajor(xa, BM, kk), Sw128::kmajor(st + L::WV, HC, kk));
        if (MODE == MODE_GEGLU) wgmma_ss_n32<0, 0>(gate, Sw128::kmajor(xa, BM, kk), Sw128::kmajor(st + L::WG, HC, kk));
      }
      if (k0 + 16 * kk < d_out) wgmma_ss_n32<0, 1>(da, Sw128::kmajor(ya, BM, kk), Sw64::mnmajor(st + L::WO, kk));
    }
    wgmma_commit();
    wgmma_wait_all();
    keep(val);
    if (MODE == MODE_GEGLU) keep(gate);
    keep(da);
    if (k0 + KW < (d > d_out ? d : d_out)) continue;  // the chunk's products are not complete yet
    uint32_t fa[2][4], fb[2][4];
    float csum[8];
    gelu_chunk<MODE>(val, gate, da, b_in, ws_h, ws_a, m, (long long)m0 + rb, c * HC, hid, t4, fa, fb, csum);
    if (MODE == MODE_MLP) store_column_sums(csum, red + (c & 1) * WARPS * HC + warp * HC, lane, t4);
  }
  if (MODE == MODE_MLP) {
    __syncthreads();
    flush_db1(red, c_end - 1, hid, d_out, vec_part);
  }
}

// The LayerNorm statistics of a row of d bf16 values (f32, eps 1e-5), a
// warp, two columns a lane at a time: the wide path's norm and backward
__device__ __forceinline__ void row_stats(const __nv_bfloat162* xr, int d, int lane, float& mean, float& rstd) {
  float sum = 0.0f;
  for (int c = lane; c < d / 2; c += 32) {
    const float2 f = __bfloat1622float2(xr[c]);
    sum += f.x + f.y;
  }
  mean = warp_sum(sum) / d;
  float sq = 0.0f;
  for (int c = lane; c < d / 2; c += 32) {
    const float2 f = __bfloat1622float2(xr[c]);
    sq += (f.x - mean) * (f.x - mean) + (f.y - mean) * (f.y - mean);
  }
  rstd = 1.0f / sqrtf(warp_sum(sq) / d + LN_EPS);
}

// GEGLU, wide path: the LayerNorm of the rows, cast to bf16 as the row
// pass does, into the xn workspace, a warp a row
__global__ void __launch_bounds__(THREADS)
ffn_bwd_wide_norm_kernel(const bf16* __restrict__ x, const bf16* __restrict__ gamma, bf16* __restrict__ ws_xn, int m,
                         int d) {
  const long long grow = (long long)blockIdx.x * WARPS + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (grow >= m) return;
  const __nv_bfloat162* xr = reinterpret_cast<const __nv_bfloat162*>(x + grow * d);
  float mean, rstd;
  row_stats(xr, d, lane, mean, rstd);
  const __nv_bfloat162* g2 = reinterpret_cast<const __nv_bfloat162*>(gamma);
  __nv_bfloat162* xn = reinterpret_cast<__nv_bfloat162*>(ws_xn + grow * d);
  for (int c = lane; c < d / 2; c += 32) {
    const float2 f = __bfloat1622float2(xr[c]), g = __bfloat1622float2(g2[c]);
    xn[c] = __floats2bfloat162_rn((f.x - mean) * rstd * g.x, (f.y - mean) * rstd * g.y);
  }
}

// dxn [M, d] = du [M, hw] . W_in [hw, d] over the hidden width (MLP: dx =
// dh . W1): block = BM rows (a warpgroup a 64) by 64 NB columns; per stage
// the du window [BM, KW] (K-major) and W_in's window rows [KW, 64 NB]
// (MN-major: W_in's rows are N-contiguous). GEGLU: f32 out, for the LN
// backward; MLP: bf16 dx.
template <int NB>
struct DxSmem {
  static constexpr uint32_t A = BM * KW * 2, STAGE = A + KW * 64 * NB * 2, BYTES = 2 * STAGE + 1024;
};

template <int MODE, int NB>
__global__ void __launch_bounds__(THREADS, 1)
ffn_bwd_wide_dx_kernel(const bf16* __restrict__ ws_h, const bf16* __restrict__ w_in, float* __restrict__ dxn,
                       bf16* __restrict__ dx, int m, int d, int hw) {
  using L = DxSmem<NB>;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* sm;
  const uint32_t sa = aligned_smem(smem_raw, &sm);
  const int m0 = blockIdx.x * BM, n0 = blockIdx.y * 64 * NB;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int t4 = lane & 3;
  const int wg = threadIdx.x / 128;
  const int rb = wg * 64 + (warp % 4) * 16 + lane / 4;

  auto load = [&](int k0, int stage) {
    const uint32_t at = sa + stage * L::STAGE, bt = at + L::A;
    for (int i = threadIdx.x; i < BM * (KW / 8); i += THREADS) {
      const int r = i / (KW / 8), cc = i % (KW / 8);
      const bool in = m0 + r < m && k0 + 8 * cc < hw;
      cp_async16(at + Sw128::offset(r, cc, BM), ws_h + (in ? (long long)(m0 + r) * hw + k0 + 8 * cc : 0), in);
    }
    for (int i = threadIdx.x; i < KW * 8 * NB; i += THREADS) {
      const int r = i / (8 * NB), cc = i % (8 * NB);
      const bool in = k0 + r < hw && n0 + 8 * cc < d;
      cp_async16(bt + Sw128::offset(r, cc, KW), w_in + (in ? (long long)(k0 + r) * d + n0 + 8 * cc : 0), in);
    }
  };

  float acc[NB][32];
#pragma unroll
  for (int cb = 0; cb < NB; ++cb)
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[cb][i] = 0.0f;
  load(0, 0);
  cp_async_commit();
  for (int k0 = 0, stage = 0; k0 < hw; k0 += KW, stage ^= 1) {
    cp_async_wait_all();
    fence_async_smem();
    __syncthreads();  // window k0 has landed; the other stage is free
    if (k0 + KW < hw) {
      load(k0 + KW, stage ^ 1);
      cp_async_commit();
    }
    const uint32_t at = sa + stage * L::STAGE, bt = at + L::A;
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < KW / 16; ++kk) {
      const uint64_t da = Sw128::kmajor(at + wg * 64 * 128, BM, kk);
#pragma unroll
      for (int cb = 0; cb < NB; ++cb) wgmma_ss_n64<0, 1>(acc[cb], da, Sw128::mnmajor(bt + cb * KW * 128, KW, kk));
    }
    wgmma_commit();
    wgmma_wait_all();
#pragma unroll
    for (int cb = 0; cb < NB; ++cb) keep(acc[cb]);
  }
#pragma unroll
  for (int hi = 0; hi < 2; ++hi) {
    const long long grow = (long long)m0 + rb + 8 * hi;
    if (grow >= m) continue;
#pragma unroll
    for (int cb = 0; cb < NB; ++cb)
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int col = n0 + cb * 64 + 8 * j + 2 * t4;
        if (col >= d) continue;  // d is a multiple of 16: col + 1 is inside too
        const float v0 = acc[cb][4 * j + 2 * hi], v1 = acc[cb][4 * j + 2 * hi + 1];
        if (MODE == MODE_GEGLU)
          *reinterpret_cast<float2*>(dxn + grow * d + col) = make_float2(v0, v1);
        else
          *reinterpret_cast<__nv_bfloat162*>(dx + grow * d + col) = __floats2bfloat162_rn(v0, v1);
      }
  }
}

// GEGLU, wide path: the bias-less LN backward (pallas_ffn.py:152-158), a
// warp a row, the statistics recomputed from x: dx = (dz - mean(dz) -
// z mean(dz z)) rstd with dz = dxn gamma; and the block's dgamma partial,
// the sums of dxn z over its BM rows, each warp's in its own row of `gsum`
// (a lane owns its columns), then summed over the warps in order.
__global__ void __launch_bounds__(THREADS)
ffn_bwd_wide_ln_kernel(const bf16* __restrict__ x, const bf16* __restrict__ gamma, const float* __restrict__ dxn,
                       bf16* __restrict__ dx, float* __restrict__ vec_part, int m, int d) {
  extern __shared__ float gsum[];  // [WARPS][d]
  const int m0 = blockIdx.x * BM;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  float* gw = gsum + warp * d;
  for (int c = lane; c < d / 2; c += 32) gw[2 * c] = gw[2 * c + 1] = 0.0f;
  const __nv_bfloat162* g2 = reinterpret_cast<const __nv_bfloat162*>(gamma);
  for (int r = warp; r < BM && m0 + r < m; r += WARPS) {
    const long long grow = m0 + r;
    const __nv_bfloat162* xr = reinterpret_cast<const __nv_bfloat162*>(x + grow * d);
    const float2* vr = reinterpret_cast<const float2*>(dxn + grow * d);
    float mean, rstd;
    row_stats(xr, d, lane, mean, rstd);
    float s1 = 0.0f, s2 = 0.0f;
    for (int c = lane; c < d / 2; c += 32) {
      const float2 f = __bfloat1622float2(xr[c]), g = __bfloat1622float2(g2[c]), v = vr[c];
      const float z0 = (f.x - mean) * rstd, z1 = (f.y - mean) * rstd;
      const float dz0 = v.x * g.x, dz1 = v.y * g.y;
      s1 += dz0 + dz1;
      s2 += dz0 * z0 + dz1 * z1;
      gw[2 * c] += v.x * z0;
      gw[2 * c + 1] += v.y * z1;
    }
    s1 = warp_sum(s1) / d;
    s2 = warp_sum(s2) / d;
    __nv_bfloat162* out = reinterpret_cast<__nv_bfloat162*>(dx + grow * d);
    for (int c = lane; c < d / 2; c += 32) {
      const float2 f = __bfloat1622float2(xr[c]), g = __bfloat1622float2(g2[c]), v = vr[c];
      const float z0 = (f.x - mean) * rstd, z1 = (f.y - mean) * rstd;
      out[c] = __floats2bfloat162_rn((v.x * g.x - s1 - z0 * s2) * rstd, (v.y * g.y - s1 - z1 * s2) * rstd);
    }
  }
  __syncthreads();
  for (int c = threadIdx.x; c < d; c += THREADS) {
    float s = 0.0f;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) s += gsum[w * d + c];
    vec_part[(long long)blockIdx.x * d + c] = s;
  }
}

// The wide path's launches (a-c); each kernel's shared-memory limit is set
// once per device, as launch_rows does.
template <int MODE, int NB>
static cudaError_t launch_wide_dx(const bf16* ws_h, const bf16* w_in, float* dxn, bf16* dx, int m, int d, int hw,
                                  cudaStream_t stream) {
  static std::atomic<unsigned> ready{0};
  auto kernel = ffn_bwd_wide_dx_kernel<MODE, NB>;
  cudaError_t err = allow_smem((const void*)kernel, DxSmem<NB>::BYTES, ready);
  if (err != cudaSuccess) return err;
  const dim3 grid((m + BM - 1) / BM, (d + 64 * NB - 1) / (64 * NB));
  kernel<<<grid, THREADS, DxSmem<NB>::BYTES, stream>>>(ws_h, w_in, dxn, dx, m, d, hw);
  return cudaGetLastError();
}

template <int MODE>
static cudaError_t launch_wide(const bf16* x, const bf16* gamma, const bf16* w_in, const bf16* b_in,
                               const bf16* w_out, const bf16* dy, bf16* dx, bf16* ws_h, bf16* ws_a, bf16* ws_xn,
                               float* vec, float* dxn, int m, int d, int hid, int d_out, cudaStream_t stream) {
  static std::atomic<unsigned> ready_rows{0}, ready_ln{0};
  const int blocks = (m + BM - 1) / BM;
  cudaError_t err;
  if (MODE == MODE_GEGLU) {
    ffn_bwd_wide_norm_kernel<<<(m + WARPS - 1) / WARPS, THREADS, 0, stream>>>(x, gamma, ws_xn, m, d);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
  }
  // the hidden chunks in slices, enough blocks for two an SM
  const int chunks = (hid + HC - 1) / HC;
  int cps = (chunks * blocks + 2 * sm_count() - 1) / (2 * sm_count());
  cps = cps < 1 ? 1 : cps;
  auto rows = ffn_bwd_wide_rows_kernel<MODE>;
  err = allow_smem((const void*)rows, WideSmem::BYTES, ready_rows);
  if (err != cudaSuccess) return err;
  rows<<<dim3(blocks, (chunks + cps - 1) / cps), THREADS, WideSmem::BYTES, stream>>>(
      x, w_in, b_in, w_out, dy, ws_h, ws_a, ws_xn, vec, m, d, hid, d_out, cps);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  const int hw = MODE == MODE_GEGLU ? 2 * hid : hid;
  switch (d >= 256 ? 4 : (d + 63) / 64) {
    case 1: err = launch_wide_dx<MODE, 1>(ws_h, w_in, dxn, dx, m, d, hw, stream); break;
    case 2: err = launch_wide_dx<MODE, 2>(ws_h, w_in, dxn, dx, m, d, hw, stream); break;
    case 3: err = launch_wide_dx<MODE, 3>(ws_h, w_in, dxn, dx, m, d, hw, stream); break;
    default: err = launch_wide_dx<MODE, 4>(ws_h, w_in, dxn, dx, m, d, hw, stream); break;
  }
  if (err != cudaSuccess || MODE == MODE_MLP) return err;
  err = allow_smem((const void*)ffn_bwd_wide_ln_kernel, MAX_SMEM, ready_ln);
  if (err != cudaSuccess) return err;
  ffn_bwd_wide_ln_kernel<<<blocks, THREADS, (size_t)WARPS * d * 4, stream>>>(x, gamma, dxn, dx, vec, m, d);
  return cudaGetLastError();
}

// The row pass for d rounded up to DP; the kernel's shared-memory limit is
// set once per device to the card's maximum (a static of this static
// function: one flag per instantiation and library).
template <int MODE, int DP>
static cudaError_t launch_rows(const bf16* x, const bf16* gamma, const bf16* w_in, const bf16* b_in,
                               const bf16* w_out, const bf16* dy, bf16* dx, bf16* ws_h, bf16* ws_a, bf16* ws_xn,
                               float* vec, int m, int d, int hid, int d_out, cudaStream_t stream) {
  static std::atomic<unsigned> ready{0};
  auto kernel = ffn_bwd_rows_kernel<MODE, DP>;
  cudaError_t err = allow_smem((const void*)kernel, MAX_SMEM, ready);
  if (err != cudaSuccess) return err;
  const size_t bytes = row_smem(MODE, d, d_out).bytes;
  kernel<<<(m + BM - 1) / BM, THREADS, bytes, stream>>>(x, gamma, w_in, b_in, w_out, dy, dx, ws_h, ws_a, ws_xn,
                                                        vec, m, d, hid, d_out);
  return cudaGetLastError();
}

// Whether the row pass holds a block's rows, chunks and dx accumulator;
// else the wide path
__host__ inline bool row_pass_fits(int mode, int d, int d_out) {
  return d <= MAX_D && d_out <= MAX_D && row_smem(mode, d, d_out).bytes <= (uint32_t)MAX_SMEM;
}

__host__ inline bool bad_shape(int m, int d, int hid, int d_out) {
  return m < 1 || d < 16 || d % 16 || hid < 16 || hid % 16 || d_out < 16 || d_out % 16 ||
         (long long)WARPS * 4 * d > MAX_SMEM;  // the wide LN backward's dgamma rows
}

// The f32 scratch of one backward, in floats: the weight-gradient products'
// row-range partials (their count `splits` chosen by wgrad::splits_for from
// the shapes and the card), the row blocks' vector partials and, on the
// wide path in GEGLU mode, dxn [M, d].
struct Scratch {
  int splits;
  long long part1, vec, dxn, floats;
};

__host__ inline Scratch scratch_of(int mode, int m, int d, int hid, int d_out) {
  const int p0 = mode == MODE_GEGLU ? 2 * hid : hid;
  Scratch s;
  s.splits = wgrad::splits_for(p0, d, hid, d_out, m);
  s.part1 = (long long)s.splits * p0 * d;
  s.vec = s.part1 + (long long)s.splits * hid * d_out;
  s.dxn = s.vec + (long long)((m + BM - 1) / BM) * (mode == MODE_GEGLU ? d : hid + d_out);
  s.floats = s.dxn + (mode == MODE_GEGLU && !row_pass_fits(mode, d, d_out) ? (long long)m * d : 0);
  return s;
}

// One backward: the row pass (or the wide path's three launches), then the
// weight-gradient product and the reduction. g0 / g1: the two weight
// gradients (their partials, summed into out0 / out1); v0 / v1: the widths
// of the vector gradients (vout0 / vout1).
template <int MODE>
cudaError_t run(const bf16* x, const bf16* gamma, const bf16* w_in, const bf16* b_in, const bf16* w_out,
                const bf16* dy, bf16* dx, bf16* ws_h, bf16* ws_a, bf16* ws_xn, const Scratch& sc, float* scratch,
                int m, int d, int hid, int d_out, WGrad g0, bf16* out0, WGrad g1, bf16* out1, int v0, bf16* vout0,
                int v1, bf16* vout1, cudaStream_t stream) {
  float* vec = scratch + sc.vec;
  cudaError_t err;
  if (!row_pass_fits(MODE, d, d_out)) {
    err = launch_wide<MODE>(x, gamma, w_in, b_in, w_out, dy, dx, ws_h, ws_a, ws_xn, vec, scratch + sc.dxn, m, d, hid,
                            d_out, stream);
  } else {
    switch ((d + 63) / 64) {
      case 1: err = launch_rows<MODE, 64>(x, gamma, w_in, b_in, w_out, dy, dx, ws_h, ws_a, ws_xn, vec, m, d, hid, d_out, stream); break;
      case 2: err = launch_rows<MODE, 128>(x, gamma, w_in, b_in, w_out, dy, dx, ws_h, ws_a, ws_xn, vec, m, d, hid, d_out, stream); break;
      case 3: err = launch_rows<MODE, 192>(x, gamma, w_in, b_in, w_out, dy, dx, ws_h, ws_a, ws_xn, vec, m, d, hid, d_out, stream); break;
      default: err = launch_rows<MODE, 256>(x, gamma, w_in, b_in, w_out, dy, dx, ws_h, ws_a, ws_xn, vec, m, d, hid, d_out, stream); break;
    }
  }
  if (err != cudaSuccess) return err;
  return wgrad::launch(g0, out0, g1, out1, m, sc.splits, vec, (m + BM - 1) / BM, v0, vout0, v1, vout1, stream);
}

}  // namespace

// The f32 scratch one backward needs, in floats (mode 0: GEGLU, 1: MLP;
// inner or hidden width `hid`); -1 for shapes the kernels do not take.
extern "C" long long ffn_bwd_scratch_floats(int mode, int m, int d, int hid, int d_out) {
  if (bad_shape(m, d, hid, d_out) || (mode != MODE_GEGLU && mode != MODE_MLP)) return -1;
  return scratch_of(mode, m, d, hid, d_out).floats;
}

// GEGLU: x, dy, dx [M, d]; gamma, dgamma [d]; w_in, dw_in [2I, d]; w_out,
// dw_out [d, I]; workspaces du [M, 2I], a [M, I], xn [M, d] (bf16) and
// the f32 scratch of ffn_bwd_scratch_floats(0, M, d, I, d) floats. All
// contiguous; d and I multiples of 16.
extern "C" int geglu_ffn_bwd_bf16(const void* x, const void* gamma, const void* w_in, const void* w_out,
                                  const void* dy, void* dx, void* dgamma, void* dw_in, void* dw_out, void* ws_du,
                                  void* ws_a, void* ws_xn, void* scratch, int m, int d, int inner, void* stream) {
  if (bad_shape(m, d, inner, d)) return (int)cudaErrorInvalidValue;
  const Scratch sc = scratch_of(MODE_GEGLU, m, d, inner, d);
  float* p = static_cast<float*>(scratch);
  const WGrad g0{static_cast<const bf16*>(ws_du), static_cast<const bf16*>(ws_xn), p, 2 * inner, d};
  // dW_out [d, I] = dy^T a, computed as (a^T dy)^T
  const WGrad g1{static_cast<const bf16*>(ws_a), static_cast<const bf16*>(dy), p + sc.part1, inner, d, 1};
  return (int)run<MODE_GEGLU>(
      static_cast<const bf16*>(x), static_cast<const bf16*>(gamma), static_cast<const bf16*>(w_in), nullptr,
      static_cast<const bf16*>(w_out), static_cast<const bf16*>(dy), static_cast<bf16*>(dx),
      static_cast<bf16*>(ws_du), static_cast<bf16*>(ws_a), static_cast<bf16*>(ws_xn), sc, p, m, d, inner, d, g0,
      static_cast<bf16*>(dw_in), g1, static_cast<bf16*>(dw_out), d, static_cast<bf16*>(dgamma), 0, nullptr,
      static_cast<cudaStream_t>(stream));
}

// MLP: x, dx [M, d]; w1, dw1 [H, d]; b1, db1 [H]; w2, dw2 [O, H]; db2 [O];
// dy [M, O]; workspaces dh [M, H], a [M, H] (bf16) and the f32 scratch of
// ffn_bwd_scratch_floats(1, M, d, H, O) floats. All contiguous; d, H and O
// multiples of 16.
extern "C" int mlp_ffn_bwd_bf16(const void* x, const void* w1, const void* b1, const void* w2, const void* dy,
                                void* dx, void* dw1, void* db1, void* dw2, void* db2, void* ws_dh, void* ws_a,
                                void* scratch, int m, int d, int hidden, int d_out, void* stream) {
  if (bad_shape(m, d, hidden, d_out)) return (int)cudaErrorInvalidValue;
  const Scratch sc = scratch_of(MODE_MLP, m, d, hidden, d_out);
  float* p = static_cast<float*>(scratch);
  const WGrad g0{static_cast<const bf16*>(ws_dh), static_cast<const bf16*>(x), p, hidden, d};
  // dW2 [O, H] = dy^T a, computed as (a^T dy)^T
  const WGrad g1{static_cast<const bf16*>(ws_a), static_cast<const bf16*>(dy), p + sc.part1, hidden, d_out, 1};
  return (int)run<MODE_MLP>(
      static_cast<const bf16*>(x), nullptr, static_cast<const bf16*>(w1), static_cast<const bf16*>(b1),
      static_cast<const bf16*>(w2), static_cast<const bf16*>(dy), static_cast<bf16*>(dx),
      static_cast<bf16*>(ws_dh), static_cast<bf16*>(ws_a), nullptr, sc, p, m, d, hidden, d_out, g0,
      static_cast<bf16*>(dw1), g1, static_cast<bf16*>(dw2), hidden, static_cast<bf16*>(db1), d_out,
      static_cast<bf16*>(db2), static_cast<cudaStream_t>(stream));
}

// (included here, after the bf16 kernels, so that their PTX is as it was:
// the labels of a kernel's blocks are numbered by its place in the file)
#include "ffn_tf32_wide.cuh"

// ---------------------------------------------------------------------------
// The f32 instance (geglu_ffn_bwd_f32, mlp_ffn_bwd_f32): the same gradients
// with every product in three TF32 parts on the tensor cores (3xTF32 wgmma)
// and every sum in f32, the weight and vector gradients as partials over
// ranges of rows summed in a fixed order (no atomics: bitwise the same run
// to run). Where d and d_out are at most 256, ffn_tf32.cuh's row kernels,
// four launches: the weights split into units, the row pass (dx, dgamma /
// db1 / db2 partials, du / dh, a, xn / x and dy transposed), the weight
// gradients, the reduction. Wider (`base`, `large`), ffn_tf32_wide.cuh's
// wide path: GEGLU six launches (the weights split into TF32 parts and
// transposed, the LayerNorm, u and da with du and a, dxn and both weight
// gradients, the LayerNorm backward, the reduction), MLP five (the weights,
// h and da with dh and a and db1, dx and both weight gradients, db2, the
// reduction).
// ---------------------------------------------------------------------------

// Floats of the f32 backward's scratch (mode 0 GEGLU, 1 MLP); -1 for a mode
// it does not know
extern "C" long long ffn_bwd_f32_scratch_floats(int mode, int m, int d, int hid, int d_out) {
  if (mode != 0 && mode != 1) return -1;
  if (ffn_tf32::wide(d, d_out)) return ffn_tf32::wide_bwd_plan(mode, m, d, hid, d_out).floats;
  return ffn_tf32::bwd_scratch(mode, m, d, hid, d_out).floats;
}

// The kernels one f32 backward launches (mode and widths as above)
extern "C" int ffn_bwd_f32_kernels(int mode, int m, int d, int hid, int d_out) {
  (void)m;
  (void)hid;
  if (mode != 0 && mode != 1) return -1;
  return ffn_tf32::wide(d, d_out) ? ffn_tf32::wide_bwd_kernels(mode) : 4;
}

// GEGLU in f32: x, dy, dx [M, d]; gamma, dgamma [d]; w_in, dw_in [2I, d];
// w_out, dw_out [d, I]; scratch: ffn_bwd_f32_scratch_floats(0, ...) floats
extern "C" int geglu_ffn_bwd_f32(const void* x, const void* gamma, const void* w_in, const void* w_out,
                                 const void* dy, void* dx, void* dgamma, void* dw_in, void* dw_out, void* scratch,
                                 int m, int d, int inner, void* stream) {
  const float* xp = static_cast<const float*>(x);
  const float* g = static_cast<const float*>(gamma);
  const float* wi = static_cast<const float*>(w_in);
  const float* wo = static_cast<const float*>(w_out);
  const float* dyp = static_cast<const float*>(dy);
  float* dxp = static_cast<float*>(dx);
  float* dgp = static_cast<float*>(dgamma);
  float* dwi = static_cast<float*>(dw_in);
  float* dwo = static_cast<float*>(dw_out);
  float* p = static_cast<float*>(scratch);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (ffn_tf32::wide(d, d))
    return (int)ffn_tf32::backward_wide<ffn_tf32::MODE_GEGLU>(xp, g, wi, nullptr, wo, dyp, dxp, dwi, dwo, dgp, nullptr,
                                                               p, m, d, inner, d, s);
  return (int)ffn_tf32::backward<ffn_tf32::MODE_GEGLU>(xp, g, wi, nullptr, wo, dyp, dxp, dwi, dwo, dgp, nullptr, p, m,
                                                        d, inner, d, s);
}

// MLP in f32: x, dx [M, d]; w1, dw1 [H, d]; b1, db1 [H]; w2, dw2 [O, H]; db2
// [O]; dy [M, O]; scratch: ffn_bwd_f32_scratch_floats(1, ...) floats
extern "C" int mlp_ffn_bwd_f32(const void* x, const void* w1, const void* b1, const void* w2, const void* dy,
                               void* dx, void* dw1, void* db1, void* dw2, void* db2, void* scratch, int m, int d,
                               int hidden, int d_out, void* stream) {
  const float* xp = static_cast<const float*>(x);
  const float* w1p = static_cast<const float*>(w1);
  const float* b1p = static_cast<const float*>(b1);
  const float* w2p = static_cast<const float*>(w2);
  const float* dyp = static_cast<const float*>(dy);
  float* dxp = static_cast<float*>(dx);
  float* dw1p = static_cast<float*>(dw1);
  float* db1p = static_cast<float*>(db1);
  float* dw2p = static_cast<float*>(dw2);
  float* db2p = static_cast<float*>(db2);
  float* p = static_cast<float*>(scratch);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (ffn_tf32::wide(d, d_out))
    return (int)ffn_tf32::backward_wide<ffn_tf32::MODE_MLP>(xp, nullptr, w1p, b1p, w2p, dyp, dxp, dw1p, dw2p, db1p,
                                                             db2p, p, m, d, hidden, d_out, s);
  return (int)ffn_tf32::backward<ffn_tf32::MODE_MLP>(xp, nullptr, w1p, b1p, w2p, dyp, dxp, dw1p, dw2p, db1p, db2p, p,
                                                      m, d, hidden, d_out, s);
}
