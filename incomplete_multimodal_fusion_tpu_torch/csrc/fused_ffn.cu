// K2: fused_ffn -- the two-product feed-forward with its hidden activation
// kept on chip, in two modes of one kernel family:
//   GEGLU: bias-less LayerNorm in f32 (eps 1e-5, weight gamma) -> cast to
//          bf16 -> u = xn . W_in^T ([M, 2I], f32 accumulation) ->
//          a = val * gelu(gate) (exact erf) -> cast to bf16 -> y = a . W_out^T
//   MLP:   h = x . W1^T + b1 -> gelu (exact erf) -> cast to bf16 ->
//          y = a . W2^T + b2
// Weights arrive in nn.Linear layout ([out, in]), so both products read
// their B operand K-contiguous (K-major).
//
// Replaces two Pallas TPU kernels of the JAX package:
//   * ops/pallas_ffn.py _fwd_kernel (pallas_call in _ffn_fwd_impl): the
//     LayerNorm+GEGLU FF of every EncoderBlock and FusionBlockFast;
//   * ops/pallas_ffn.py _mlp_fwd_kernel (pallas_call in _mlp_fwd_impl): the
//     decoder ViT blocks' MLP.
// The MLP also runs over a task axis (mlp_ffn_tasks_*: T MLPs with their own
// weights, x [T, M, d] -> y [T, M, O], the decoder trunks of T tasks): the
// task is one more grid coordinate of the row path, each block offsetting
// x, the weights, y and its partials by its task, which is what jax.vmap
// makes of the MLP kernel under multimae.py:285-289.
// Cast points are those of the Pallas bodies: LN output (pallas_ffn.py:106),
// the GEGLU product (:112), the MLP's gelu output (:298).
//
// What bounds it on an H100: per row the two products are 2 * 2 * d * I
// (+ 2 * I * d) flops (GEGLU d = 192, I = 512: 0.6 MFLOP a row) against
// 4 * d bytes in and out, so it is tensor-core work, if the [M, 2I] f32
// activation never goes to device memory. The design (row path):
//   * a block of two consumer warpgroups owns BM = 128 rows (64 each): the
//     LayerNorm in f32, a warp a row, into a bf16 xn tile in shared memory
//     in the hardware's 128-byte swizzle (the MLP copies x by cp.async);
//   * a loop over the hidden width in chunks of HC = 64 columns: the
//     chunk's W_in rows (val and gate stacked, 128 rows; W1's 64 for the
//     MLP) and W_out's columns (a [d_out, 64] K-major tile) stream into
//     shared memory by cp.async, double-buffered, both warpgroups reading
//     them;
//   * u = xn . W_in[chunk]^T as wgmma with register accumulators (one
//     m64n128 product a k-step gives val and gate side by side: the same
//     column sits at fragment index i and i + 32);
//   * the exact-erf GELU and the bf16 cast on the accumulator fragments,
//     which are at once the A fragments (from registers) of
//     y += a[chunk] . W_out[:, chunk]^T, so a never exists whole on chip;
//   * y stays in registers across the chunks (d_out / 2 floats a thread,
//     so d_out <= 256), b_out is added in f32 and y is stored once in bf16;
//   * where the row tiles fill less than half the card (M <= 8,448 on 132
//     SMs: serving, the fusion rows), a block's time is its chunk loop, so
//     the hidden chunks are split over blocks instead, each storing its
//     partial y in f32, and a second launch sums them in a fixed order.
// The 128-row tile leaves a tail at large M: M = 38,400 is 300 tiles, 2.27
// waves of one block an SM run as 3. Persistent blocks would not shorten
// it (the unit of work stays a tile); a 64-row tile at two blocks an SM
// would need half the shared memory, so chunks of 32 and twice the weight
// traffic from L2.
// The row path takes d, d_out <= 256 where its shared memory fits (GEGLU
// d = 192: 197,632 bytes, one block an SM; MLP d = O = 256 the same). Past
// that (the `base` and `large` widths, d = 768 and 1024) a wide path runs
// instead: (GEGLU) the LayerNorm into an xn workspace, then a = act(xn .
// W_in^T) as 128-row by 64-hidden-column wgmma tiles with xn and W_in
// streamed in 64-column windows into an [M, I] bf16 workspace, then
// y = a . W_out^T as 128 x 128 wgmma tiles over the hidden width. The
// workspaces cost one write and read of M (d + I) bf16 (about 0.03 ms at
// `base`, M = 8192) against recomputing u for every 256 columns of y.
// No atomics: two calls are bitwise equal.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>

#include "hopper.cuh"
#include "simt_f32.cuh"

using bf16 = __nv_bfloat16;

namespace {

using namespace hopper;

constexpr int BM = 128;  // rows a block: two consumer warpgroups of 64
constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int HC = 64;      // hidden columns a chunk
constexpr int MAX_D = 256;  // the row path's d (one LayerNorm pass a warp) and d_out (y in registers)
constexpr int KW = 64;      // reduction columns a window on the wide path
constexpr int MAX_SMEM = 232448;  // a block's shared memory on sm_90 (227 KB)
constexpr float LN_EPS = 1e-5f;

enum { MODE_GEGLU = 0, MODE_MLP = 1 };

// rows of a chunk's W_in tile: val and gate (GEGLU) or h (MLP)
__host__ __device__ constexpr int nu_of(int mode) { return mode == MODE_GEGLU ? 2 * HC : HC; }

// Byte offsets in the row path's shared memory (from its 1024-byte aligned
// start): the xn (or x) tile [BM, dp]; per stage the chunk's W_in rows
// [NU, dp] and W_out columns [dop, HC] (dp, dop: d and d_out rounded up to
// 64, the padding zeros).
struct RowSmem {
  uint32_t xs, stages, wi, wo, stage_bytes, bytes;
};

__host__ __device__ inline RowSmem row_smem(int mode, int d, int d_out) {
  const uint32_t dp = (d + 63) / 64 * 64, dop = (d_out + 63) / 64 * 64;
  RowSmem L;
  L.xs = 0;
  L.stages = BM * dp * 2;
  L.wi = 0;
  L.wo = nu_of(mode) * dp * 2;
  L.stage_bytes = L.wo + dop * HC * 2;  // multiples of 8 KB: every tile starts on 1 KB
  L.bytes = L.stages + 2 * L.stage_bytes + 1024;  // + the alignment slack
  return L;
}

__device__ __forceinline__ float gelu_erf(float g) {
  return g * (0.5f * (1.0f + erff(g * 0.70710678118654752f)));
}

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// The activation of hidden chunk c0 .. c0 + HC on the first product's
// accumulator fragment u (this thread's rows r and r + 8, columns
// c0 + 8 j + 2 t4 and the next): a = val gelu(gate) (GEGLU: val in
// u[0, 32), gate of the same column 32 on) or gelu(h + b_in) (MLP), cast to
// bf16 pairs. The pair of column block j and row half hi is register
// 2 (j % 2) + hi of k-step j / 2 of the A fragments of
// y += a . W_out[:, chunk]^T.
template <int MODE>
__device__ __forceinline__ void activate(const float (&u)[nu_of(MODE) / 2], const bf16* __restrict__ b_in, int c0,
                                         int hid, int t4, uint32_t (&fa)[HC / 16][4]) {
#pragma unroll
  for (int j = 0; j < HC / 8; ++j) {
    float b0 = 0.0f, b1 = 0.0f;
    const int col = c0 + 8 * j + 2 * t4;
    if (MODE == MODE_MLP && col < hid) {  // hid is a multiple of 16: col + 1 is inside too
      const float2 bb = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(b_in + col));
      b0 = bb.x;
      b1 = bb.y;
    }
#pragma unroll
    for (int hi = 0; hi < 2; ++hi) {
      const int i = 4 * j + 2 * hi;
      float a0, a1;
      if constexpr (MODE == MODE_GEGLU) {
        a0 = u[i] * gelu_erf(u[HC / 2 + i]);
        a1 = u[i + 1] * gelu_erf(u[HC / 2 + i + 1]);
      } else {
        a0 = gelu_erf(u[i] + b0);
        a1 = gelu_erf(u[i + 1] + b1);
      }
      fa[j / 2][2 * (j % 2) + hi] = pack_bf16(a0, a1);
    }
  }
}

// The row path. NBO: d_out rounded up to 64, in 64-column blocks (1 .. 4),
// the y accumulators. Block = BM rows; warpgroup wg owns rows
// [64 wg, 64 wg + 64). TASKS (the MLP's task axis): blockIdx.z is a task,
// whose rows x [m, d], weights, output y [m, d_out] and partials lie one
// task's extent apart.
template <int MODE, int NBO, bool TASKS = false>
__global__ void __launch_bounds__(THREADS, 1)
ffn_fwd_rows_kernel(const bf16* __restrict__ x, const bf16* __restrict__ gamma, const bf16* __restrict__ w_in,
                    const bf16* __restrict__ b_in, const bf16* __restrict__ w_out, const bf16* __restrict__ b_out,
                    bf16* __restrict__ y, float* __restrict__ part, int m, int d, int hid, int d_out, int cps) {
  constexpr int NU = nu_of(MODE);
  constexpr int DOP = NBO * 64;
  static_assert(!TASKS || MODE == MODE_MLP, "the task axis is the MLP's");
  if constexpr (TASKS) {
    const long long t = blockIdx.z;
    x += t * m * d;
    w_in += t * hid * d;
    b_in += t * hid;
    w_out += t * d_out * hid;
    b_out += t * d_out;
    y += t * m * d_out;
    if (part != nullptr) part += t * gridDim.y * m * d_out;
  }
  const RowSmem L = row_smem(MODE, d, d_out);
  extern __shared__ unsigned char smem_raw[];
  unsigned char* sm;
  const uint32_t sa = aligned_smem(smem_raw, &sm);
  const int dp = (d + 63) / 64 * 64;
  const int m0 = blockIdx.x * BM;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int t4 = lane & 3;
  const int wg = threadIdx.x / 128;
  const int rb = wg * 64 + (warp % 4) * 16 + lane / 4;  // this thread's rows of the block: rb, rb + 8
  // this block's hidden chunks: all of them, or a split's at small M
  const int c_begin = blockIdx.y * cps, c_end = min((hid + HC - 1) / HC, c_begin + cps);

  // the W_in rows (val, then gate) and W_out columns of hidden chunk c into
  // a stage; hidden units past hid and columns past d, d_out are zeros
  auto load_w = [&](int c, int stage) {
    const uint32_t st = sa + L.stages + stage * L.stage_bytes;
    const int c0 = c * HC;
    for (int i = threadIdx.x; i < NU * (dp / 8); i += THREADS) {
      const int r = i / (dp / 8), cc = i % (dp / 8);
      const int unit = c0 + r % HC;
      const bool in = unit < hid && 8 * cc < d;
      const long long src = (long long)(r < HC ? unit : hid + unit) * d + 8 * cc;
      cp_async16(st + L.wi + Sw128::offset(r, cc, NU), w_in + (in ? src : 0), in);
    }
    for (int i = threadIdx.x; i < DOP * (HC / 8); i += THREADS) {
      const int r = i / (HC / 8), cc = i % (HC / 8);
      const bool in = r < d_out && c0 + 8 * cc < hid;
      cp_async16(st + L.wo + Sw128::offset(r, cc, DOP), w_out + (in ? (long long)r * hid + c0 + 8 * cc : 0), in);
    }
  };

  if (MODE == MODE_MLP) {  // x as it is: rows past m and columns past d are zeros
    for (int i = threadIdx.x; i < BM * (dp / 8); i += THREADS) {
      const int r = i / (dp / 8), cc = i % (dp / 8);
      const bool in = m0 + r < m && 8 * cc < d;
      cp_async16(sa + L.xs + Sw128::offset(r, cc, BM), x + (in ? (long long)(m0 + r) * d + 8 * cc : 0), in);
    }
  }
  load_w(c_begin, 0);
  cp_async_commit();

  if (MODE == MODE_GEGLU) {
    // LayerNorm, a warp per row, 8 columns a lane (d <= 256), into the xn
    // tile (zeros past d and m)
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
      const float rstd = 1.0f / sqrtf(warp_sum(sq) / d + LN_EPS);
      uint4 packed = make_uint4(0u, 0u, 0u, 0u);
      if (in) {
        const uint4 gu = *reinterpret_cast<const uint4*>(gamma + c);
        const __nv_bfloat162* g2 = reinterpret_cast<const __nv_bfloat162*>(&gu);
        uint32_t* p = reinterpret_cast<uint32_t*>(&packed);
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          const float2 gf = __bfloat1622float2(g2[k]);
          p[k] = pack_bf16((xv[2 * k] - mean) * rstd * gf.x, (xv[2 * k + 1] - mean) * rstd * gf.y);
        }
      }
      if (c < dp) *reinterpret_cast<uint4*>(sm + L.xs + Sw128::offset(r, lane, BM)) = packed;
    }
  }

  float acc[NBO][32];
#pragma unroll
  for (int cb = 0; cb < NBO; ++cb)
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[cb][i] = 0.0f;
  const uint32_t xa = sa + L.xs + wg * 64 * 128;  // this warpgroup's 64 rows of the xn tile

  for (int c = c_begin; c < c_end; ++c) {
    const int stage = (c - c_begin) & 1;
    cp_async_wait_all();
    fence_async_smem();
    __syncthreads();  // chunk c (and the xn tile) have landed; the other stage is free
    if (c + 1 < c_end) {
      load_w(c + 1, stage ^ 1);
      cp_async_commit();
    }
    const uint32_t st = sa + L.stages + stage * L.stage_bytes;

    // u = xn . W_in[chunk]^T: [val | gate] (GEGLU) or h before its bias
    float u[NU / 2];
#pragma unroll
    for (int i = 0; i < NU / 2; ++i) u[i] = 0.0f;
    wgmma_fence();
    for (int kk = 0; kk < d / 16; ++kk) {
      if constexpr (MODE == MODE_GEGLU)
        wgmma_ss_n128<0, 0>(u, Sw128::kmajor(xa, BM, kk), Sw128::kmajor(st + L.wi, NU, kk));
      else
        wgmma_ss_n64<0, 0>(u, Sw128::kmajor(xa, BM, kk), Sw128::kmajor(st + L.wi, NU, kk));
    }
    wgmma_commit();
    wgmma_wait_all();
    keep(u);

    uint32_t fa[HC / 16][4];
    activate<MODE>(u, b_in, c * HC, hid, t4, fa);

    // y += a[chunk] . W_out[:, chunk]^T: A from registers, W_out K-major
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < HC / 16; ++kk)
#pragma unroll
      for (int cb = 0; cb < NBO; ++cb)
        wgmma_rs_n64<0>(acc[cb], fa[kk], Sw128::kmajor(st + L.wo + cb * 64 * 128, DOP, kk));
    wgmma_commit();
    wgmma_wait_all();
#pragma unroll
    for (int cb = 0; cb < NBO; ++cb) keep(acc[cb]);
    keep(fa);
  }

#pragma unroll
  for (int hi = 0; hi < 2; ++hi) {
    const long long grow = (long long)m0 + rb + 8 * hi;
    if (grow >= m) continue;
#pragma unroll
    for (int cb = 0; cb < NBO; ++cb)
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int col = cb * 64 + 8 * j + 2 * t4;
        if (col >= d_out) continue;  // d_out is a multiple of 16: col + 1 is inside too
        float v0 = acc[cb][4 * j + 2 * hi], v1 = acc[cb][4 * j + 2 * hi + 1];
        if (gridDim.y > 1) {  // a split's partial y, summed by ffn_fwd_split_reduce_kernel
          *reinterpret_cast<float2*>(part + ((long long)blockIdx.y * m + grow) * d_out + col) = make_float2(v0, v1);
          continue;
        }
        if (MODE == MODE_MLP) {
          const float2 bb = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(b_out + col));
          v0 += bb.x;
          v1 += bb.y;
        }
        *reinterpret_cast<__nv_bfloat162*>(y + grow * d_out + col) = __floats2bfloat162_rn(v0, v1);
      }
  }
}

// The row path's splits at small M: y = the splits' partials [splits, m,
// d_out] summed in order, + b_out (MLP), cast once; 4 columns a thread.
// TASKS: blockIdx.y is a task (its partials, b_out and y).
template <int MODE, bool TASKS = false>
__global__ void __launch_bounds__(THREADS)
ffn_fwd_split_reduce_kernel(const float* __restrict__ part, const bf16* __restrict__ b_out, bf16* __restrict__ y,
                            int m, int d_out, int splits) {
  const long long quads = (long long)m * d_out / 4;
  if constexpr (TASKS) {
    const long long t = blockIdx.y;
    part += t * splits * quads * 4;
    b_out += t * d_out;
    y += t * m * d_out;
  }
  for (long long i = (long long)blockIdx.x * THREADS + threadIdx.x; i < quads; i += (long long)gridDim.x * THREADS) {
    float4 acc = reinterpret_cast<const float4*>(part)[i];
    for (int k = 1; k < splits; ++k) {
      const float4 p = reinterpret_cast<const float4*>(part)[k * quads + i];
      acc.x += p.x;
      acc.y += p.y;
      acc.z += p.z;
      acc.w += p.w;
    }
    if (MODE == MODE_MLP) {
      const int col = (int)(i * 4 % d_out);
      const float2 b01 = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(b_out + col));
      const float2 b23 = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(b_out + col + 2));
      acc.x += b01.x;
      acc.y += b01.y;
      acc.z += b23.x;
      acc.w += b23.y;
    }
    __nv_bfloat162* out = reinterpret_cast<__nv_bfloat162*>(y + i * 4);
    out[0] = __floats2bfloat162_rn(acc.x, acc.y);
    out[1] = __floats2bfloat162_rn(acc.z, acc.w);
  }
}

// The wide path's stages: an A window [BM, KW] and a B window [NBR, KW],
// both K-major in the 128-byte swizzle; two stages.
template <int NBR>
struct WideSmem {
  static constexpr uint32_t A = 0, B = BM * KW * 2, STAGE = B + NBR * KW * 2, BYTES = 2 * STAGE + 1024;
};

// GEGLU, wide path: the LayerNorm of the rows, cast to bf16, into the xn
// workspace, a warp a row, two columns a lane at a time
__global__ void __launch_bounds__(THREADS)
ffn_fwd_wide_norm_kernel(const bf16* __restrict__ x, const bf16* __restrict__ gamma, bf16* __restrict__ ws_xn, int m,
                         int d) {
  const long long grow = (long long)blockIdx.x * WARPS + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (grow >= m) return;
  const __nv_bfloat162* xr = reinterpret_cast<const __nv_bfloat162*>(x + grow * d);
  float sum = 0.0f;
  for (int c = lane; c < d / 2; c += 32) {
    const float2 f = __bfloat1622float2(xr[c]);
    sum += f.x + f.y;
  }
  const float mean = warp_sum(sum) / d;
  float sq = 0.0f;
  for (int c = lane; c < d / 2; c += 32) {
    const float2 f = __bfloat1622float2(xr[c]);
    sq += (f.x - mean) * (f.x - mean) + (f.y - mean) * (f.y - mean);
  }
  const float rstd = 1.0f / sqrtf(warp_sum(sq) / d + LN_EPS);
  const __nv_bfloat162* g2 = reinterpret_cast<const __nv_bfloat162*>(gamma);
  __nv_bfloat162* xn = reinterpret_cast<__nv_bfloat162*>(ws_xn + grow * d);
  for (int c = lane; c < d / 2; c += 32) {
    const float2 f = __bfloat1622float2(xr[c]), g = __bfloat1622float2(g2[c]);
    xn[c] = __floats2bfloat162_rn((f.x - mean) * rstd * g.x, (f.y - mean) * rstd * g.y);
  }
}

// Wide path, the hidden activation: block = BM rows by HC hidden columns,
// u = xs . W_in[chunk]^T with xs (xn, or x for the MLP) and the chunk's W_in
// rows streamed in KW-column windows, double-buffered; then a (bf16, the
// row path's activation) into the workspace [m, hid].
template <int MODE>
__global__ void __launch_bounds__(THREADS, 2)
ffn_fwd_wide_hidden_kernel(const bf16* __restrict__ xs, const bf16* __restrict__ w_in, const bf16* __restrict__ b_in,
                           bf16* __restrict__ ws_a, int m, int d, int hid) {
  constexpr int NU = nu_of(MODE);
  using L = WideSmem<NU>;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* sm;
  const uint32_t sa = aligned_smem(smem_raw, &sm);
  const int m0 = blockIdx.x * BM, c0 = blockIdx.y * HC;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int t4 = lane & 3;
  const int wg = threadIdx.x / 128;
  const int rb = wg * 64 + (warp % 4) * 16 + lane / 4;

  auto load = [&](int k0, int stage) {
    const uint32_t st = sa + stage * L::STAGE;
    for (int i = threadIdx.x; i < BM * (KW / 8); i += THREADS) {
      const int r = i / (KW / 8), cc = i % (KW / 8);
      const bool in = m0 + r < m && k0 + 8 * cc < d;
      cp_async16(st + L::A + Sw128::offset(r, cc, BM), xs + (in ? (long long)(m0 + r) * d + k0 + 8 * cc : 0), in);
    }
    for (int i = threadIdx.x; i < NU * (KW / 8); i += THREADS) {
      const int r = i / (KW / 8), cc = i % (KW / 8);
      const int unit = c0 + r % HC;
      const bool in = unit < hid && k0 + 8 * cc < d;
      const long long src = (long long)(r < HC ? unit : hid + unit) * d + k0 + 8 * cc;
      cp_async16(st + L::B + Sw128::offset(r, cc, NU), w_in + (in ? src : 0), in);
    }
  };

  float u[NU / 2];
#pragma unroll
  for (int i = 0; i < NU / 2; ++i) u[i] = 0.0f;
  load(0, 0);
  cp_async_commit();
  for (int k0 = 0, stage = 0; k0 < d; k0 += KW, stage ^= 1) {
    cp_async_wait_all();
    fence_async_smem();
    __syncthreads();  // window k0 has landed; the other stage is free
    if (k0 + KW < d) {
      load(k0 + KW, stage ^ 1);
      cp_async_commit();
    }
    const uint32_t st = sa + stage * L::STAGE;
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < KW / 16; ++kk) {
      if (k0 + 16 * kk >= d) continue;
      const uint64_t da = Sw128::kmajor(st + L::A + wg * 64 * 128, BM, kk);
      if constexpr (MODE == MODE_GEGLU)
        wgmma_ss_n128<0, 0>(u, da, Sw128::kmajor(st + L::B, NU, kk));
      else
        wgmma_ss_n64<0, 0>(u, da, Sw128::kmajor(st + L::B, NU, kk));
    }
    wgmma_commit();
    wgmma_wait_all();
    keep(u);
  }
  uint32_t fa[HC / 16][4];
  activate<MODE>(u, b_in, c0, hid, t4, fa);
#pragma unroll
  for (int j = 0; j < HC / 8; ++j)
#pragma unroll
    for (int hi = 0; hi < 2; ++hi) {
      const long long grow = (long long)m0 + rb + 8 * hi;
      const int col = c0 + 8 * j + 2 * t4;
      if (grow < m && col < hid) *reinterpret_cast<uint32_t*>(ws_a + grow * hid + col) = fa[j / 2][2 * (j % 2) + hi];
    }
}

// Wide path, the output: y = a . W_out^T (+ b_out), block = BM rows by 128
// columns, the a rows and W_out rows streamed in KW-column windows of the
// hidden width, double-buffered.
template <int MODE>
__global__ void __launch_bounds__(THREADS, 2)
ffn_fwd_wide_out_kernel(const bf16* __restrict__ ws_a, const bf16* __restrict__ w_out,
                        const bf16* __restrict__ b_out, bf16* __restrict__ y, int m, int hid, int d_out) {
  using L = WideSmem<128>;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* sm;
  const uint32_t sa = aligned_smem(smem_raw, &sm);
  const int m0 = blockIdx.x * BM, n0 = blockIdx.y * 128;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int t4 = lane & 3;
  const int wg = threadIdx.x / 128;
  const int rb = wg * 64 + (warp % 4) * 16 + lane / 4;

  auto load = [&](int k0, int stage) {
    const uint32_t st = sa + stage * L::STAGE;
    for (int i = threadIdx.x; i < BM * (KW / 8); i += THREADS) {
      const int r = i / (KW / 8), cc = i % (KW / 8);
      const bool in_a = m0 + r < m && k0 + 8 * cc < hid;
      cp_async16(st + L::A + Sw128::offset(r, cc, BM), ws_a + (in_a ? (long long)(m0 + r) * hid + k0 + 8 * cc : 0),
                 in_a);
      const bool in_b = n0 + r < d_out && k0 + 8 * cc < hid;
      cp_async16(st + L::B + Sw128::offset(r, cc, 128),
                 w_out + (in_b ? (long long)(n0 + r) * hid + k0 + 8 * cc : 0), in_b);
    }
  };

  float acc[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] = 0.0f;
  load(0, 0);
  cp_async_commit();
  for (int k0 = 0, stage = 0; k0 < hid; k0 += KW, stage ^= 1) {
    cp_async_wait_all();
    fence_async_smem();
    __syncthreads();
    if (k0 + KW < hid) {
      load(k0 + KW, stage ^ 1);
      cp_async_commit();
    }
    const uint32_t st = sa + stage * L::STAGE;
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < KW / 16; ++kk) {
      if (k0 + 16 * kk >= hid) continue;
      wgmma_ss_n128<0, 0>(acc, Sw128::kmajor(st + L::A + wg * 64 * 128, BM, kk), Sw128::kmajor(st + L::B, 128, kk));
    }
    wgmma_commit();
    wgmma_wait_all();
    keep(acc);
  }
#pragma unroll
  for (int hi = 0; hi < 2; ++hi) {
    const long long grow = (long long)m0 + rb + 8 * hi;
    if (grow >= m) continue;
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      const int col = n0 + 8 * j + 2 * t4;
      if (col >= d_out) continue;
      float v0 = acc[4 * j + 2 * hi], v1 = acc[4 * j + 2 * hi + 1];
      if (MODE == MODE_MLP) {
        const float2 bb = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(b_out + col));
        v0 += bb.x;
        v1 += bb.y;
      }
      *reinterpret_cast<__nv_bfloat162*>(y + grow * d_out + col) = __floats2bfloat162_rn(v0, v1);
    }
  }
}

// Whether the row path holds a block's rows, chunks and y accumulator;
// else the wide path
__host__ inline bool rows_fit(int mode, int d, int d_out) {
  return d <= MAX_D && d_out <= MAX_D && row_smem(mode, d, d_out).bytes <= (uint32_t)MAX_SMEM;
}

__host__ inline bool bad_shape(int m, int d, int hid, int d_out) {
  return m < 1 || d < 16 || d % 16 || hid < 16 || hid % 16 || d_out < 16 || d_out % 16;
}

// The row path's hidden split: chunks a block (cps) and blocks a row tile.
// Where the row tiles cannot fill half the card (serving, M <= 8,448 on 132
// SMs), each tile's hidden chunks are split over blocks whose partial y
// (f32) a second launch sums in a fixed order; a block's time is its chunk
// loop, so this shortens it.
struct Split {
  int cps, splits;
};

__host__ inline Split row_split(int m, int hid, int tasks = 1) {
  const int tiles = (m + BM - 1) / BM * tasks, chunks = (hid + HC - 1) / HC, sms = sm_count();
  if (2 * tiles >= sms) return {chunks, 1};
  int want = sms / tiles;
  want = want < chunks ? want : chunks;
  const int cps = (chunks + want - 1) / want;
  return {cps, (chunks + cps - 1) / cps};
}

// Bytes of the workspace one forward needs: the wide path's xn [m, d]
// (GEGLU) and a [m, hid] in bf16, or the row path's partial y [splits, m,
// d_out] in f32 where it splits; 0 otherwise
__host__ inline long long workspace_bytes(int mode, int m, int d, int hid, int d_out) {
  if (!rows_fit(mode, d, d_out)) return 2 * ((mode == MODE_GEGLU ? (long long)m * d : 0) + (long long)m * hid);
  const Split sp = row_split(m, hid);
  return sp.splits > 1 ? 4LL * sp.splits * m * d_out : 0;
}

// The row path for d_out in NBO 64-column blocks (TASKS: `tasks` MLPs, a
// grid coordinate each); the kernel's shared-memory limit is set once per
// device to the card's maximum (a static of this static function: one flag
// per instantiation and library).
template <int MODE, int NBO, bool TASKS = false>
static cudaError_t launch_rows(const bf16* x, const bf16* gamma, const bf16* w_in, const bf16* b_in,
                               const bf16* w_out, const bf16* b_out, bf16* y, float* part, int m, int d, int hid,
                               int d_out, cudaStream_t stream, int tasks = 1) {
  static std::atomic<unsigned> ready{0};
  auto kernel = ffn_fwd_rows_kernel<MODE, NBO, TASKS>;
  cudaError_t err = allow_smem((const void*)kernel, MAX_SMEM, ready);
  if (err != cudaSuccess) return err;
  const Split sp = row_split(m, hid, tasks);
  if (sp.splits > 1 && part == nullptr) return cudaErrorInvalidValue;
  kernel<<<dim3((m + BM - 1) / BM, sp.splits, tasks), THREADS, row_smem(MODE, d, d_out).bytes, stream>>>(
      x, gamma, w_in, b_in, w_out, b_out, y, part, m, d, hid, d_out, sp.cps);
  if ((err = cudaGetLastError()) != cudaSuccess || sp.splits == 1) return err;
  const long long blocks = ((long long)m * d_out / 4 + THREADS - 1) / THREADS;
  ffn_fwd_split_reduce_kernel<MODE, TASKS><<<dim3((unsigned)(blocks < 1024 ? blocks : 1024), tasks), THREADS, 0,
                                            stream>>>(part, b_out, y, m, d_out, sp.splits);
  return cudaGetLastError();
}

template <int MODE>
static cudaError_t launch_wide(const bf16* x, const bf16* gamma, const bf16* w_in, const bf16* b_in,
                               const bf16* w_out, const bf16* b_out, bf16* y, bf16* ws, int m, int d, int hid,
                               int d_out, cudaStream_t stream) {
  static std::atomic<unsigned> ready_hidden{0}, ready_out{0};
  constexpr int NU = nu_of(MODE);
  cudaError_t err;
  const bf16* xs = x;
  bf16* ws_a = ws;
  if (MODE == MODE_GEGLU) {
    ffn_fwd_wide_norm_kernel<<<(m + WARPS - 1) / WARPS, THREADS, 0, stream>>>(x, gamma, ws, m, d);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
    xs = ws;
    ws_a = ws + (long long)m * d;
  }
  auto hidden = ffn_fwd_wide_hidden_kernel<MODE>;
  if ((err = allow_smem((const void*)hidden, WideSmem<NU>::BYTES, ready_hidden)) != cudaSuccess) return err;
  hidden<<<dim3((m + BM - 1) / BM, (hid + HC - 1) / HC), THREADS, WideSmem<NU>::BYTES, stream>>>(xs, w_in, b_in,
                                                                                                 ws_a, m, d, hid);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  auto out = ffn_fwd_wide_out_kernel<MODE>;
  if ((err = allow_smem((const void*)out, WideSmem<128>::BYTES, ready_out)) != cudaSuccess) return err;
  out<<<dim3((m + BM - 1) / BM, (d_out + 127) / 128), THREADS, WideSmem<128>::BYTES, stream>>>(ws_a, w_out, b_out,
                                                                                               y, m, hid, d_out);
  return cudaGetLastError();
}

template <int MODE>
cudaError_t run(const bf16* x, const bf16* gamma, const bf16* w_in, const bf16* b_in, const bf16* w_out,
                const bf16* b_out, bf16* y, void* ws, int m, int d, int hid, int d_out, cudaStream_t stream) {
  if (bad_shape(m, d, hid, d_out)) return cudaErrorInvalidValue;
  if (!rows_fit(MODE, d, d_out)) {
    if (ws == nullptr) return cudaErrorInvalidValue;
    return launch_wide<MODE>(x, gamma, w_in, b_in, w_out, b_out, y, static_cast<bf16*>(ws), m, d, hid, d_out,
                             stream);
  }
  float* part = static_cast<float*>(ws);
  switch ((d_out + 63) / 64) {
    case 1: return launch_rows<MODE, 1>(x, gamma, w_in, b_in, w_out, b_out, y, part, m, d, hid, d_out, stream);
    case 2: return launch_rows<MODE, 2>(x, gamma, w_in, b_in, w_out, b_out, y, part, m, d, hid, d_out, stream);
    case 3: return launch_rows<MODE, 3>(x, gamma, w_in, b_in, w_out, b_out, y, part, m, d, hid, d_out, stream);
    default: return launch_rows<MODE, 4>(x, gamma, w_in, b_in, w_out, b_out, y, part, m, d, hid, d_out, stream);
  }
}

// The MLP over `tasks` tasks (x [tasks, m, d], weights stacked over the
// tasks): the row path in one launch, its task a grid coordinate; past the
// row path's widths the wide path task by task, one workspace reused.
cudaError_t run_mlp_tasks(const bf16* x, const bf16* w1, const bf16* b1, const bf16* w2, const bf16* b2, bf16* y,
                          void* ws, int tasks, int m, int d, int hid, int d_out, cudaStream_t stream) {
  if (tasks < 1 || bad_shape(m, d, hid, d_out)) return cudaErrorInvalidValue;
  if (!rows_fit(MODE_MLP, d, d_out)) {
    if (ws == nullptr) return cudaErrorInvalidValue;
    for (long long t = 0; t < tasks; ++t) {
      const cudaError_t err =
          launch_wide<MODE_MLP>(x + t * m * d, nullptr, w1 + t * hid * d, b1 + t * hid, w2 + t * d_out * hid,
                                b2 + t * d_out, y + t * m * d_out, static_cast<bf16*>(ws), m, d, hid, d_out, stream);
      if (err != cudaSuccess) return err;
    }
    return cudaSuccess;
  }
  float* part = static_cast<float*>(ws);
  switch ((d_out + 63) / 64) {
    case 1: return launch_rows<MODE_MLP, 1, true>(x, nullptr, w1, b1, w2, b2, y, part, m, d, hid, d_out, stream, tasks);
    case 2: return launch_rows<MODE_MLP, 2, true>(x, nullptr, w1, b1, w2, b2, y, part, m, d, hid, d_out, stream, tasks);
    case 3: return launch_rows<MODE_MLP, 3, true>(x, nullptr, w1, b1, w2, b2, y, part, m, d, hid, d_out, stream, tasks);
    default:
      return launch_rows<MODE_MLP, 4, true>(x, nullptr, w1, b1, w2, b2, y, part, m, d, hid, d_out, stream, tasks);
  }
}

}  // namespace

// Bytes of the workspace one forward needs (mode 0: GEGLU, 1: MLP; inner or
// hidden width `hid`): the row path's partial y where it splits the hidden
// width, the wide path's xn and a past the row path's widths, else 0; -1
// for shapes the kernels do not take.
extern "C" long long ffn_fwd_workspace_bytes(int mode, int m, int d, int hid, int d_out) {
  if (bad_shape(m, d, hid, d_out) || (mode != MODE_GEGLU && mode != MODE_MLP)) return -1;
  return workspace_bytes(mode, m, d, hid, d_out);
}

// The kernels one forward launches for these shapes (mode and widths as
// ffn_fwd_workspace_bytes): the row kernel, and its split's reduction where
// it splits the hidden width; on the wide path (the GEGLU's norm,) the
// hidden activation and the output product; -1 for shapes the kernels do
// not take.
extern "C" int ffn_fwd_kernels(int mode, int m, int d, int hid, int d_out) {
  if (bad_shape(m, d, hid, d_out) || (mode != MODE_GEGLU && mode != MODE_MLP)) return -1;
  if (!rows_fit(mode, d, d_out)) return mode == MODE_GEGLU ? 3 : 2;
  return row_split(m, hid).splits > 1 ? 2 : 1;
}

// GEGLU: x [M, d], gamma [d], w_in [2I, d], w_out [d, I] -> y [M, d];
// ws: ffn_fwd_workspace_bytes(0, M, d, I, d) bytes (null when 0). All
// contiguous; d and I multiples of 16.
extern "C" int geglu_ffn_bf16(const void* x, const void* gamma, const void* w_in, const void* w_out, void* y,
                              void* ws, int m, int d, int inner, void* stream) {
  return (int)run<MODE_GEGLU>(static_cast<const bf16*>(x), static_cast<const bf16*>(gamma),
                              static_cast<const bf16*>(w_in), nullptr, static_cast<const bf16*>(w_out), nullptr,
                              static_cast<bf16*>(y), ws, m, d, inner, d,
                              static_cast<cudaStream_t>(stream));
}

// MLP: x [M, d], w1 [H, d], b1 [H], w2 [O, H], b2 [O] -> y [M, O]; ws:
// ffn_fwd_workspace_bytes(1, M, d, H, O) bytes (null when 0). All
// contiguous; d, H and O multiples of 16.
extern "C" int mlp_ffn_bf16(const void* x, const void* w1, const void* b1, const void* w2, const void* b2, void* y,
                            void* ws, int m, int d, int hidden, int d_out, void* stream) {
  return (int)run<MODE_MLP>(static_cast<const bf16*>(x), nullptr, static_cast<const bf16*>(w1),
                            static_cast<const bf16*>(b1), static_cast<const bf16*>(w2),
                            static_cast<const bf16*>(b2), static_cast<bf16*>(y), ws, m, d,
                            hidden, d_out, static_cast<cudaStream_t>(stream));
}

// The MLP's task axis: bytes of the workspace of one mlp_ffn_tasks_bf16 call
// (`tasks` MLPs of these shapes): the row path's partial y of every task
// where it splits the hidden width, one task's wide-path workspace past the
// row path's widths, else 0; -1 for shapes the kernels do not take.
extern "C" long long ffn_fwd_tasks_workspace_bytes(int tasks, int m, int d, int hid, int d_out) {
  if (tasks < 1 || bad_shape(m, d, hid, d_out)) return -1;
  if (!rows_fit(MODE_MLP, d, d_out)) return workspace_bytes(MODE_MLP, m, d, hid, d_out);
  const Split sp = row_split(m, hid, tasks);
  return sp.splits > 1 ? 4LL * sp.splits * m * d_out * tasks : 0;
}

// The kernels one mlp_ffn_tasks_bf16 call launches: the row kernel (and its
// split's reduction), or the wide path's two a task; -1 for shapes the
// kernels do not take.
extern "C" long long ffn_fwd_tasks_kernels(int tasks, int m, int d, int hid, int d_out) {
  if (tasks < 1 || bad_shape(m, d, hid, d_out)) return -1;
  if (!rows_fit(MODE_MLP, d, d_out)) return 2LL * tasks;
  return row_split(m, hid, tasks).splits > 1 ? 2 : 1;
}

// MLP with a task axis: x [T, M, d], w1 [T, H, d], b1 [T, H], w2 [T, O, H],
// b2 [T, O] -> y [T, M, O], one launch for all T (the row path); ws:
// ffn_fwd_tasks_workspace_bytes(T, M, d, H, O) bytes (null when 0).
extern "C" int mlp_ffn_tasks_bf16(const void* x, const void* w1, const void* b1, const void* w2, const void* b2,
                                  void* y, void* ws, int tasks, int m, int d, int hidden, int d_out, void* stream) {
  return (int)run_mlp_tasks(static_cast<const bf16*>(x), static_cast<const bf16*>(w1), static_cast<const bf16*>(b1),
                            static_cast<const bf16*>(w2), static_cast<const bf16*>(b2), static_cast<bf16*>(y), ws,
                            tasks, m, d, hidden, d_out, static_cast<cudaStream_t>(stream));
}

// (included here, after the bf16 kernels, so that their PTX is as it was:
// the labels of a kernel's blocks are numbered by its place in the file)
#include "ffn_tf32.cuh"

// ---------------------------------------------------------------------------
// The f32 instance (geglu_ffn_f32, mlp_ffn_f32, mlp_ffn_tasks_f32): the same
// functions with every product and sum in f32, for the f32 paths the TPU
// kernels also take. Where d and d_out are at most 256 (every model width of
// the default paths), ffn_tf32.cuh's tensor-core instance: each product in
// three TF32 parts (3xTF32 wgmma), u and a kept on chip; 2 launches (the
// weights split into units, the row kernel), 3 where the hidden chunks split
// over blocks at small M. Wider (`base`, `large`), by that shape rule alone,
// the FFMA chain of simt_f32.cuh: GEGLU four launches (the LayerNorm (xn),
// u = xn W_in^T, a = val gelu(gate), y = a W_out^T), MLP two (a = gelu(x
// W1^T + b1), y = a W2^T + b2), the activations through the workspace. Any
// hidden width: no padding of the GEGLU inner width is needed.
// ---------------------------------------------------------------------------

// Floats of the f32 forward's workspace (mode 0 GEGLU, 1 MLP); -1 for a mode
// it does not know
extern "C" long long ffn_fwd_f32_workspace_floats(int mode, int m, int d, int hid, int d_out) {
  if (mode != 0 && mode != 1) return -1;
  if (ffn_tf32::rows_fit(d, d_out)) return ffn_tf32::fwd_workspace_floats(mode, 1, m, d, hid, d_out);
  if (mode == 0) return (long long)m * (d + 3LL * hid);
  return (long long)m * hid;
}

// The kernels one f32 forward launches (mode and widths as above)
extern "C" int ffn_fwd_f32_kernels(int mode, int m, int d, int hid, int d_out) {
  if (mode != 0 && mode != 1) return -1;
  if (ffn_tf32::rows_fit(d, d_out)) return ffn_tf32::fwd_kernels(m, hid, 1);
  return mode == 0 ? 4 : 2;
}

// GEGLU in f32: x [M, d], gamma [d], w_in [2I, d], w_out [d, I] -> y [M, d]
extern "C" int geglu_ffn_f32(const void* x, const void* gamma, const void* w_in, const void* w_out, void* y,
                             void* ws, int m, int d, int inner, void* stream) {
  using namespace simt_f32;
  const float* xp = static_cast<const float*>(x);
  const float* wi = static_cast<const float*>(w_in);
  const float* wo = static_cast<const float*>(w_out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (ffn_tf32::rows_fit(d, d))
    return (int)ffn_tf32::forward<ffn_tf32::MODE_GEGLU>(xp, static_cast<const float*>(gamma), wi, nullptr, wo, nullptr,
                                                         static_cast<float*>(y), static_cast<float*>(ws), 1, m, d,
                                                         inner, d, s);
  float* xn = static_cast<float*>(ws);
  float* u = xn + (long long)m * d;
  float* a = u + 2LL * m * inner;
  cudaError_t err = ln_fwd(xp, static_cast<const float*>(gamma), xn, m, d, s);
  if (err == cudaSuccess)
    err = product_store(Mat{xn, d, 1}, Mat{wi, 1, d}, u, 2LL * inner, m, 2 * inner, d, nullptr, nullptr, 0, s);
  if (err == cudaSuccess) err = act(u, a, m, inner, true, s);
  if (err == cudaSuccess)
    err = product_store(Mat{a, inner, 1}, Mat{wo, 1, inner}, static_cast<float*>(y), d, m, d, inner, nullptr,
                        nullptr, 0, s);
  return (int)err;
}

// MLP in f32: x [M, d], w1 [H, d], b1 [H], w2 [O, H], b2 [O] -> y [M, O]
extern "C" int mlp_ffn_f32(const void* x, const void* w1, const void* b1, const void* w2, const void* b2, void* y,
                           void* ws, int m, int d, int hidden, int d_out, void* stream) {
  using namespace simt_f32;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (ffn_tf32::rows_fit(d, d_out))
    return (int)ffn_tf32::forward<ffn_tf32::MODE_MLP>(
        static_cast<const float*>(x), nullptr, static_cast<const float*>(w1), static_cast<const float*>(b1),
        static_cast<const float*>(w2), static_cast<const float*>(b2), static_cast<float*>(y), static_cast<float*>(ws),
        1, m, d, hidden, d_out, s);
  float* a = static_cast<float*>(ws);
  cudaError_t err = product<EPI_GELU>(Mat{static_cast<const float*>(x), d, 1},
                                      Mat{static_cast<const float*>(w1), 1, d},
                                      Out{a, hidden, static_cast<const float*>(b1), nullptr, 0, nullptr, 0, 0}, m,
                                      hidden, d, s);
  if (err == cudaSuccess)
    err = product_store(Mat{a, hidden, 1}, Mat{static_cast<const float*>(w2), 1, hidden}, static_cast<float*>(y),
                        d_out, m, d_out, hidden, static_cast<const float*>(b2), nullptr, 0, s);
  return (int)err;
}

// The f32 task axis: floats of one mlp_ffn_tasks_f32 call's workspace and
// the kernels it launches (T tasks of these shapes); -1 for no task
extern "C" long long ffn_fwd_tasks_f32_workspace_floats(int tasks, int m, int d, int hid, int d_out) {
  if (tasks < 1) return -1;
  if (ffn_tf32::rows_fit(d, d_out)) return ffn_tf32::fwd_workspace_floats(1, tasks, m, d, hid, d_out);
  return (long long)tasks * m * hid;
}

extern "C" int ffn_fwd_tasks_f32_kernels(int tasks, int m, int d, int hid, int d_out) {
  if (tasks < 1) return -1;
  return ffn_tf32::rows_fit(d, d_out) ? ffn_tf32::fwd_kernels(m, hid, tasks) : 2;
}

// MLP with a task axis in f32: x [T, M, d], w1 [T, H, d], b1 [T, H],
// w2 [T, O, H], b2 [T, O] -> y [T, M, O], the task a grid coordinate of
// each launch; ws: ffn_fwd_tasks_f32_workspace_floats(T, M, d, H, O) floats.
// Past the tensor-core instance's widths, the two products of the FFMA
// chain, each one launch for all T.
extern "C" int mlp_ffn_tasks_f32(const void* x, const void* w1, const void* b1, const void* w2, const void* b2,
                                 void* y, void* ws, int tasks, int m, int d, int hidden, int d_out, void* stream) {
  using namespace simt_f32;
  if (tasks < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (ffn_tf32::rows_fit(d, d_out))
    return (int)ffn_tf32::forward<ffn_tf32::MODE_MLP>(
        static_cast<const float*>(x), nullptr, static_cast<const float*>(w1), static_cast<const float*>(b1),
        static_cast<const float*>(w2), static_cast<const float*>(b2), static_cast<float*>(y), static_cast<float*>(ws),
        tasks, m, d, hidden, d_out, s);
  float* a = static_cast<float*>(ws);
  const long long mm = m;
  cudaError_t err = product_tasks<EPI_GELU>(
      Mat{static_cast<const float*>(x), d, 1}, Mat{static_cast<const float*>(w1), 1, d},
      Out{a, hidden, static_cast<const float*>(b1), nullptr, 0, nullptr, 0, 0}, m, hidden, d,
      Strides{mm * d, (long long)hidden * d, mm * hidden, hidden}, tasks, s);
  if (err == cudaSuccess)
    err = product_tasks<EPI_STORE>(
        Mat{a, hidden, 1}, Mat{static_cast<const float*>(w2), 1, hidden},
        Out{static_cast<float*>(y), d_out, static_cast<const float*>(b2), nullptr, 0, nullptr, 0, 0}, m, d_out,
        hidden, Strides{mm * hidden, (long long)d_out * hidden, mm * d_out, d_out}, tasks, s);
  return (int)err;
}
