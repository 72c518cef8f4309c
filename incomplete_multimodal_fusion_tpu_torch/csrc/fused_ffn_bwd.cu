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
// `base` and `large` widths) a wide path takes its place, every product on
// ffn_wide.cuh's pipelined body (a cp.async ring of 64-column windows, wgmma
// with one group left in flight): a pass over blocks of 128 rows by 128
// hidden units that forms u and da = dy . W_out and from them du and a
// (reading xn and dy once for every 128 units, da stashed in shared memory
// while u is formed), then one launch of the two weight gradients over row
// ranges and dxn = du . W_in, the LN backward and the reduction (see
// ffn_bwd_wide_act_kernel). No atomics, so two calls are bitwise equal. The
// workspaces du, a and xn cost device memory (du alone is 67 MB at `base`,
// M = 8192, and 315 MB at M = 38,400) and one write and read each, against
// recomputing u and da in the weight-gradient pass.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>

#include "ffn_wide.cuh"
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
// tiles the row pass cannot hold: every product on ffn_wide.cuh's pipelined
// body, GEGLU in five launches, MLP in three:
//   a. GEGLU: LayerNorm, a warp a row, into the xn workspace;
//   b. the row pass's products (ffn_bwd_wide_act_kernel): a block of 128
//      rows by 128 hidden units forms u and da, reading xn (x) and dy once
//      for every 128 units, and stores du (dh) and a, with the MLP's db1 and
//      db2 partials;
//   c. one launch of three products: the two weight gradients over row
//      ranges (f32 partials), then dxn = du . W_in (MLP: dx = dh . W1; GEGLU
//      f32 out, for the LN backward);
//   d. GEGLU: the bias-less LN backward, a warp a row, and the row blocks'
//      dgamma partials;
//   e. wgrad.cuh's reduction: every partial summed in a fixed order, cast
//      once.

// The row pass's products: block = 128 rows (blockIdx.y) by UT = 128 hidden
// units (blockIdx.x). First da = dy . W_out[:, units] (W_out read MN-major),
// its f32 fragments stashed in shared memory, a thread's values where it
// reads them back; then u = xs . W_in[units]^T (GEGLU: val and gate, 256 B
// rows; MLP: h before b1, 128) on the same ring, so no thread holds more
// than one product's accumulators. The GELU parts on the fragments: du =
// [da gelu(gate), da val gelu'(gate)], a = val gelu(gate) (MLP: dh =
// da gelu'(h), h = u + b1, a = gelu(h)), cast to bf16 into the workspaces
// du [m, 2 hid] (dh [m, hid]) and a [m, hid]. MLP: the block's column sums
// of the rounded dh (db1) and, in the first units' blocks, of dy (db2) into
// its row of vec_part [row blocks, hid + d_out].
template <int MODE>
__global__ void __launch_bounds__(THREADS, 1)
ffn_bwd_wide_act_kernel(ffn_wide::Opnd xs, ffn_wide::Opnd w_in, ffn_wide::Opnd dy, ffn_wide::Opnd w_out,
                        const bf16* __restrict__ b_in, bf16* __restrict__ ws_h, bf16* __restrict__ ws_a,
                        float* __restrict__ vec_part, int m, int hid, int d_out) {
  constexpr int NU = MODE == MODE_GEGLU ? 256 : 128;  // u's columns
  constexpr int KW = ffn_wide::ACT_BWD_KW, S = ffn_wide::act_bwd_stages(MODE == MODE_GEGLU);
  extern __shared__ unsigned char smem_raw[];
  unsigned char* sm;
  const uint32_t sa = aligned_smem(smem_raw, &sm);
  float* stash = reinterpret_cast<float*>(sm + ffn_wide::ring_bytes<NU, KW, S>());  // [64][THREADS]
  const int c0 = blockIdx.x * ffn_wide::UT, m0 = blockIdx.y * BM;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  // MLP: the block's b1 slice, read before the products and handed to the
  // epilogue through the freed ring (past the column sums' rows)
  const float bias = MODE == MODE_MLP && tid < ffn_wide::UT && c0 + tid < hid ? __bfloat162float(b_in[c0 + tid]) : 0.0f;
  {
    float da[64];
#pragma unroll
    for (int i = 0; i < 64; ++i) da[i] = 0.0f;
    ffn_wide::product<128, 0, 1, KW, S>(da, dy, m0, w_out, c0, 0, ffn_wide::windows<KW>(dy.k), sa);
#pragma unroll
    for (int i = 0; i < 64; ++i) stash[i * THREADS + tid] = da[i];
  }
  float u[NU / 2];
#pragma unroll
  for (int i = 0; i < NU / 2; ++i) u[i] = 0.0f;
  ffn_wide::product<NU, 0, 0, KW, S>(u, xs, m0, w_in, c0, 0, ffn_wide::windows<KW>(xs.k), sa);
  float* bs = reinterpret_cast<float*>(sm) + WARPS * ffn_wide::UT;  // [UT]
  if constexpr (MODE == MODE_MLP) {
    if (tid < ffn_wide::UT) bs[tid] = bias;
    __syncthreads();
  }

  const int r0 = ffn_wide::frag_row(), t2 = ffn_wide::frag_col();
  const int hw = MODE == MODE_GEGLU ? 2 * hid : hid;  // width of du / dh
  float csum[32];  // MLP: this thread's sums of the rounded dh over its two rows, a column each
#pragma unroll
  for (int j = 0; j < 16; ++j) {
    const int col = c0 + 8 * j + t2;
    float2 bb = make_float2(0.0f, 0.0f);
    if (MODE == MODE_MLP) bb = *reinterpret_cast<const float2*>(bs + 8 * j + t2);
#pragma unroll
    for (int hi = 0; hi < 2; ++hi) {
      const int i = 4 * j + 2 * hi;
      float h0[2], h1[2] = {0.0f, 0.0f}, act[2];
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const float da = stash[(i + e) * THREADS + tid];
        if constexpr (MODE == MODE_GEGLU) {
          const float v = u[i + e], g = u[64 + i + e];
          const float cdf = ffn_wide::gelu_cdf(g), gd = cdf + g * ffn_wide::gelu_pdf(g), gv = g * cdf;
          h0[e] = da * gv;
          h1[e] = da * v * gd;
          act[e] = v * gv;
        } else {
          const float g = u[i + e] + (e ? bb.y : bb.x);
          const float cdf = ffn_wide::gelu_cdf(g);
          h0[e] = da * (cdf + g * ffn_wide::gelu_pdf(g));
          act[e] = g * cdf;
        }
      }
      const __nv_bfloat162 hv = __floats2bfloat162_rn(h0[0], h0[1]);
      const long long row = (long long)m0 + r0 + 8 * hi;
      if (row < m && col < hid) {  // hid is a multiple of 16: col + 1 is inside too
        *reinterpret_cast<__nv_bfloat162*>(ws_h + row * hw + col) = hv;
        *reinterpret_cast<__nv_bfloat162*>(ws_a + row * hid + col) = __floats2bfloat162_rn(act[0], act[1]);
        if (MODE == MODE_GEGLU)
          *reinterpret_cast<__nv_bfloat162*>(ws_h + row * hw + hid + col) = __floats2bfloat162_rn(h1[0], h1[1]);
      }
      if (MODE == MODE_MLP) {  // rows past m and units past hid have da = 0, so dh = 0
        const float2 f = __bfloat1622float2(hv);  // db1 sums the rounded dh
        csum[2 * j] = (hi ? csum[2 * j] : 0.0f) + f.x;
        csum[2 * j + 1] = (hi ? csum[2 * j + 1] : 0.0f) + f.y;
      }
    }
  }
  if constexpr (MODE == MODE_MLP) {
    // db1: the warps' column sums (over their 16 rows) in the free ring, then
    // summed over the warps in order
    float* red = reinterpret_cast<float*>(sm);  // [WARPS][UT]
#pragma unroll
    for (int k = 0; k < 32; ++k) csum[k] = column_sum(csum[k]);
    if (lane < 4) {
#pragma unroll
      for (int j = 0; j < 16; ++j) {
        red[warp * ffn_wide::UT + 8 * j + t2] = csum[2 * j];
        red[warp * ffn_wide::UT + 8 * j + t2 + 1] = csum[2 * j + 1];
      }
    }
    __syncthreads();
    float* vrow = vec_part + (long long)blockIdx.y * (hid + d_out);
    if (tid < ffn_wide::UT && c0 + tid < hid) {
      float s = 0.0f;
#pragma unroll
      for (int w = 0; w < WARPS; ++w) s += red[w * ffn_wide::UT + tid];
      vrow[c0 + tid] = s;
    }
    if (blockIdx.x == 0) {  // db2: this block's column sums of dy
      const bf16* dyp = dy.p;
      for (int c = tid; c < d_out; c += THREADS) {
        float s = 0.0f;
        for (int r = 0; r < BM && m0 + r < m; ++r) s += __bfloat162float(dyp[(long long)(m0 + r) * d_out + c]);
        vrow[hid + c] = s;
      }
    }
  }
}

// One product of the backward's product launch: C [rows, cols] = A B^T as
// 128 x 256 tiles over `splits` ranges of `wps` windows of the contraction
// (the weight gradients: the rows of the batch), C's element (p, q) of range
// z stored at c + z split_stride + p ldc + q, in f32 or bf16.
struct Job {
  ffn_wide::Opnd a, b;
  int ta;  // A MN-major (the weight gradients: du^T, dy^T) or K-major (du for dxn)
  int mtiles, ntiles, wps, windows;
  void* c;
  long long ldc, split_stride;
  int rows, cols, f32;
};

struct Jobs {
  Job j[3];
  int start[4];  // the jobs' first blocks, then the total
};

__host__ inline Job job(const ffn_wide::Opnd& a, const ffn_wide::Opnd& b, int ta, int rows, int cols, int splits,
                        void* c, long long ldc, int f32) {
  Job g{};
  g.a = a;
  g.b = b;
  g.ta = ta;
  g.mtiles = (rows + BM - 1) / BM;
  g.ntiles = (cols + ffn_wide::BN - 1) / ffn_wide::BN;
  g.windows = ffn_wide::windows<ffn_wide::PRODUCTS_KW>(a.k);
  g.wps = (g.windows + splits - 1) / splits;
  g.c = c;
  g.ldc = ldc;
  g.split_stride = (long long)rows * cols;
  g.rows = rows;
  g.cols = cols;
  g.f32 = f32;
  return g;
}

__host__ inline int job_blocks(const Job& g) {
  return g.mtiles * g.ntiles * ((g.windows + g.wps - 1) / g.wps);
}

// A block computes one tile of one job (the column tile fastest, the range
// slowest: the blocks of a wave share their rows of the operands in L2)
__global__ void __launch_bounds__(THREADS, 1) ffn_bwd_wide_products_kernel(Jobs js) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* sm;
  const uint32_t sa = aligned_smem(smem_raw, &sm);
  const int blk = blockIdx.x;
  const int q = blk >= js.start[2] ? 2 : (blk >= js.start[1] ? 1 : 0);
  const Job g = q == 0 ? js.j[0] : (q == 1 ? js.j[1] : js.j[2]);
  int t = blk - js.start[q];
  const int nt = t % g.ntiles;
  t /= g.ntiles;
  const int mt = t % g.mtiles, z = t / g.mtiles;
  const int m0 = mt * BM, n0 = nt * ffn_wide::BN, w0 = z * g.wps, w1 = min(g.windows, w0 + g.wps);
  float acc[128];
#pragma unroll
  for (int i = 0; i < 128; ++i) acc[i] = 0.0f;
  if (g.ta)
    ffn_wide::product<256, 1, 1, ffn_wide::PRODUCTS_KW, ffn_wide::PRODUCTS_STAGES>(acc, g.a, m0, g.b, n0, w0, w1, sa);
  else
    ffn_wide::product<256, 0, 1, ffn_wide::PRODUCTS_KW, ffn_wide::PRODUCTS_STAGES>(acc, g.a, m0, g.b, n0, w0, w1, sa);
  const int r0 = ffn_wide::frag_row(), t2 = ffn_wide::frag_col();
#pragma unroll
  for (int hi = 0; hi < 2; ++hi) {
    const long long p = (long long)m0 + r0 + 8 * hi;
    if (p >= g.rows) continue;
    const long long at = z * g.split_stride + p * g.ldc;
#pragma unroll
    for (int j = 0; j < 32; ++j) {
      const int col = n0 + 8 * j + t2;
      if (col >= g.cols) continue;  // cols is a multiple of 16: col + 1 is inside too
      const float v0 = acc[4 * j + 2 * hi], v1 = acc[4 * j + 2 * hi + 1];
      if (g.f32)
        *reinterpret_cast<float2*>(static_cast<float*>(g.c) + at + col) = make_float2(v0, v1);
      else
        *reinterpret_cast<__nv_bfloat162*>(static_cast<bf16*>(g.c) + at + col) = __floats2bfloat162_rn(v0, v1);
    }
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

// GEGLU, wide path: the bias-less LN backward (pallas_ffn.py:152-158), a
// warp a row, the statistics recomputed from x: dx = (dz - mean(dz) -
// z mean(dz z)) rstd with dz = dxn gamma; and the block's dgamma partial,
// the sums of dxn z over its LN_ROWS rows, each warp's in its own row of
// `gsum` (a lane owns its columns), then summed over the warps in order.
// Blocks of 32 rows: 256 at M = 8192, two an SM.
constexpr int LN_ROWS = 32;

__global__ void __launch_bounds__(THREADS)
ffn_bwd_wide_ln_kernel(const bf16* __restrict__ x, const bf16* __restrict__ gamma, const float* __restrict__ dxn,
                       bf16* __restrict__ dx, float* __restrict__ vec_part, int m, int d) {
  extern __shared__ float gsum[];  // [WARPS][d]
  const int m0 = blockIdx.x * LN_ROWS;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  float* gw = gsum + warp * d;
  for (int c = lane; c < d / 2; c += 32) gw[2 * c] = gw[2 * c + 1] = 0.0f;
  const __nv_bfloat162* g2 = reinterpret_cast<const __nv_bfloat162*>(gamma);
  for (int r = warp; r < LN_ROWS && m0 + r < m; r += WARPS) {
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
// row-range partials (their count `splits` chosen from the shapes and the
// card by wgrad::splits_for; on the wide path the ranges that its windows
// of 64 rows form, as job() cuts them), the row blocks' vector partials
// (the wide GEGLU's LN backward in blocks of LN_ROWS rows) and, on the wide
// path in GEGLU mode, dxn [M, d].
struct Scratch {
  int splits, vec_rows;
  long long part1, vec, dxn, floats;
};

__host__ inline Scratch scratch_of(int mode, int m, int d, int hid, int d_out) {
  const int p0 = mode == MODE_GEGLU ? 2 * hid : hid;
  const bool wide = !row_pass_fits(mode, d, d_out);
  Scratch s;
  s.splits = wgrad::splits_for(p0, d, hid, d_out, m);
  if (wide) {
    const int w = ffn_wide::windows<ffn_wide::PRODUCTS_KW>(m), wps = (w + s.splits - 1) / s.splits;
    s.splits = (w + wps - 1) / wps;
  }
  s.part1 = (long long)s.splits * p0 * d;
  s.vec = s.part1 + (long long)s.splits * hid * d_out;
  s.vec_rows = mode == MODE_GEGLU && wide ? (m + LN_ROWS - 1) / LN_ROWS : (m + BM - 1) / BM;
  s.dxn = s.vec + (long long)s.vec_rows * (mode == MODE_GEGLU ? d : hid + d_out);
  s.floats = s.dxn + (mode == MODE_GEGLU && wide ? (long long)m * d : 0);
  return s;
}

// The wide path's launches (a-e); each kernel's shared-memory limit is set
// once per device, as launch_rows does. GEGLU: dW_in = du^T xn, dW_out =
// dy^T a, dgamma; MLP: dW1 = dh^T x, dW2 = dy^T a, db1, db2 (v0 / v1: the
// vector gradients' widths, as wgrad::launch).
template <int MODE>
static cudaError_t launch_wide(const bf16* x, const bf16* gamma, const bf16* w_in, const bf16* b_in,
                               const bf16* w_out, const bf16* dy, bf16* dx, bf16* ws_h, bf16* ws_a, bf16* ws_xn,
                               const Scratch& sc, float* scratch, int m, int d, int hid, int d_out, bf16* dw_in,
                               bf16* dw_out, int v0, bf16* vout0, int v1, bf16* vout1, cudaStream_t stream) {
  using ffn_wide::opnd;
  constexpr bool GEGLU = MODE == MODE_GEGLU;
  constexpr int NU = GEGLU ? 256 : 128;
  constexpr uint32_t ACT_SMEM =
      ffn_wide::ring_bytes<NU, ffn_wide::ACT_BWD_KW, ffn_wide::act_bwd_stages(GEGLU)>() + ffn_wide::STASH_BYTES + 1024;
  constexpr uint32_t PROD_SMEM = ffn_wide::ring_bytes<256, ffn_wide::PRODUCTS_KW, ffn_wide::PRODUCTS_STAGES>() + 1024;
  static_assert(ACT_SMEM <= MAX_SMEM && PROD_SMEM <= MAX_SMEM, "a block's shared memory");
  static std::atomic<unsigned> ready_act{0}, ready_prod{0}, ready_ln{0};
  const int blocks = (m + BM - 1) / BM, hw = GEGLU ? 2 * hid : hid;
  float* vec = scratch + sc.vec;
  cudaError_t err;
  const bf16* xs = x;
  if (GEGLU) {
    ffn_bwd_wide_norm_kernel<<<(m + WARPS - 1) / WARPS, THREADS, 0, stream>>>(x, gamma, ws_xn, m, d);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
    xs = ws_xn;
  }
  auto act = ffn_bwd_wide_act_kernel<MODE>;
  if ((err = allow_smem((const void*)act, ACT_SMEM, ready_act)) != cudaSuccess) return err;
  act<<<dim3((hid + ffn_wide::UT - 1) / ffn_wide::UT, blocks), THREADS, ACT_SMEM, stream>>>(
      opnd(xs, d, m, d), GEGLU ? opnd(w_in, d, hid, d, ffn_wide::UT, hid) : opnd(w_in, d, hid, d),
      opnd(dy, d_out, m, d_out), opnd(w_out, hid, hid, d_out), b_in, ws_h, ws_a, vec, m, hid, d_out);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;

  // the weight gradients first (the longer blocks), then dxn (MLP dx)
  Jobs js{};
  // dW_in [hw, d] = du^T xs over the rows: du and xs read MN-major
  js.j[0] = job(opnd(ws_h, hw, hw, m), opnd(xs, d, d, m), 1, hw, d, sc.splits, scratch, d, 1);
  // dW_out [d_out, hid] = dy^T a
  js.j[1] = job(opnd(dy, d_out, d_out, m), opnd(ws_a, hid, hid, m), 1, d_out, hid, sc.splits, scratch + sc.part1,
                hid, 1);
  // dxn [m, d] = du W_in (MLP: dx = dh W1): W_in read MN-major
  js.j[2] = job(opnd(ws_h, hw, m, hw), opnd(w_in, d, d, hw), 0, m, d, 1,
                GEGLU ? static_cast<void*>(scratch + sc.dxn) : static_cast<void*>(dx), d, GEGLU ? 1 : 0);
  int total = 0;
  for (int i = 0; i < 3; ++i) {
    js.start[i] = total;
    total += job_blocks(js.j[i]);
  }
  js.start[3] = total;
  if ((err = allow_smem((const void*)ffn_bwd_wide_products_kernel, PROD_SMEM, ready_prod)) != cudaSuccess) return err;
  ffn_bwd_wide_products_kernel<<<total, THREADS, PROD_SMEM, stream>>>(js);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;

  if (GEGLU) {
    if ((err = allow_smem((const void*)ffn_bwd_wide_ln_kernel, MAX_SMEM, ready_ln)) != cudaSuccess) return err;
    ffn_bwd_wide_ln_kernel<<<sc.vec_rows, THREADS, (size_t)WARPS * d * 4, stream>>>(x, gamma, scratch + sc.dxn, dx,
                                                                                  vec, m, d);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
  }
  const long long n0 = (long long)hw * d, n1 = (long long)d_out * hid;
  const int matrix_blocks = (int)((n0 + n1 + wgrad::REDUCE_THREADS - 1) / wgrad::REDUCE_THREADS);
  const int vector_blocks = (v0 + v1 + wgrad::REDUCE_THREADS / 32 - 1) / (wgrad::REDUCE_THREADS / 32);
  wgrad::wgrad_reduce_kernel<<<matrix_blocks + vector_blocks, wgrad::REDUCE_THREADS, 0, stream>>>(
      scratch, dw_in, n0, scratch + sc.part1, dw_out, n1, sc.splits, matrix_blocks, vec, sc.vec_rows, v0, vout0, v1,
      vout1);
  return cudaGetLastError();
}


// One backward: the row pass, the weight-gradient product and the
// reduction, or the wide path's launches. g0 / g1: the two weight gradients
// (their partials, summed into out0 / out1); v0 / v1: the widths of the
// vector gradients (vout0 / vout1).
template <int MODE>
cudaError_t run(const bf16* x, const bf16* gamma, const bf16* w_in, const bf16* b_in, const bf16* w_out,
                const bf16* dy, bf16* dx, bf16* ws_h, bf16* ws_a, bf16* ws_xn, const Scratch& sc, float* scratch,
                int m, int d, int hid, int d_out, WGrad g0, bf16* out0, WGrad g1, bf16* out1, int v0, bf16* vout0,
                int v1, bf16* vout1, cudaStream_t stream) {
  if (!row_pass_fits(MODE, d, d_out))
    return launch_wide<MODE>(x, gamma, w_in, b_in, w_out, dy, dx, ws_h, ws_a, ws_xn, sc, scratch, m, d, hid, d_out,
                             out0, out1, v0, vout0, v1, vout1, stream);
  float* vec = scratch + sc.vec;
  cudaError_t err;
  switch ((d + 63) / 64) {
    case 1: err = launch_rows<MODE, 64>(x, gamma, w_in, b_in, w_out, dy, dx, ws_h, ws_a, ws_xn, vec, m, d, hid, d_out, stream); break;
    case 2: err = launch_rows<MODE, 128>(x, gamma, w_in, b_in, w_out, dy, dx, ws_h, ws_a, ws_xn, vec, m, d, hid, d_out, stream); break;
    case 3: err = launch_rows<MODE, 192>(x, gamma, w_in, b_in, w_out, dy, dx, ws_h, ws_a, ws_xn, vec, m, d, hid, d_out, stream); break;
    default: err = launch_rows<MODE, 256>(x, gamma, w_in, b_in, w_out, dy, dx, ws_h, ws_a, ws_xn, vec, m, d, hid, d_out, stream); break;
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

// The kernels one backward launches for these shapes (mode and widths as
// ffn_bwd_scratch_floats): the row pass, the weight-gradient product and the
// reduction; past the row pass's widths the wide path's (GEGLU: the norm,
// the activations' products, the weight gradients and dxn in one launch,
// the LN backward, the reduction; MLP: the three without the norm and the
// LN backward); -1 for shapes the kernels do not take.
extern "C" int ffn_bwd_kernels(int mode, int m, int d, int hid, int d_out) {
  if (bad_shape(m, d, hid, d_out) || (mode != MODE_GEGLU && mode != MODE_MLP)) return -1;
  if (!row_pass_fits(mode, d, d_out)) return mode == MODE_GEGLU ? 5 : 3;
  return 3;
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
