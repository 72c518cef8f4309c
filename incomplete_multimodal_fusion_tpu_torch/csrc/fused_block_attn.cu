// K6: fused_block_attn -- the attention half of an encoder block,
//
//   y = x + round(out . Wo^T),   out = zorro_attn(q, k, v),
//   [q | k | v] = round(h . [Wq; Wkv]^T),   h = round(LN_g2(round(LN_g1(x)))),
//
// both LayerNorms bias-free (f32 statistics, eps 1e-5), and its backward
// K6b: dx, dg1, dg2, dWq, dWkv, dWo. Weights are in nn.Linear layout
// ([out, in]); the weight and gain gradients are summed in f32 over all
// B x N rows and cast once to bf16.
//
// Replaces ops/pallas_block_attn.py _fwd_kernel (pallas_call in _fwd_impl)
// and _bwd_kernel (pallas_call in _bwd_rule), with their cast points:
//   forward (pallas_block_attn.py:71-105): LN1 in f32 rounded; LN2 in f32
//   rounded (h); q and kv rounded; p rounded for P.V; each head's output
//   rounded; (out . Wo^T) rounded before the bf16 residual add;
//   backward (:108-202): dout = dy . Wo rounded; D = rowsum(dout * o) on the
//   unrounded f32 head output; dq and dk multiplied by the scale before
//   rounding, dv rounded; dhid = dq . Wq + dkv . Wkv in f32; both LayerNorm
//   backwards in f32 (da is not rounded); dx = round(dy + dx_ln).
//
// What bounds it on an H100: at the pretraining shape (B = 60, N = 640,
// D = I = 192, 3 heads x 64) the forward is about 20-30 GFLOP of tensor-core
// products (projections, attention, out projection) against about 30 MB of
// x, y and workspace traffic: operations, not bytes, if the products ran at
// the tensor cores' rate. The TPU kernel ran one program per batch row with
// the row's whole [N, D] slab, the three weights (295 KB in bf16) and every
// intermediate in VMEM. Neither the weights nor one row's slabs fit a
// block's 227 KB of shared memory, and 60 rows would fill fewer than half
// of the 132 SMs, so the work is cut into row tiles and launches:
//
// K6, two launches:
//   1. projection pass, one block per 64 of the B x N rows: both LayerNorms
//      (a warp per row) into a bf16 h tile in shared memory, then
//      qkv = round(h . [Wq; Wkv]^T) 64 columns at a time (wmma, the weights
//      read from device memory, where they stay in L2) into a bf16
//      [B, N, 3I] workspace;
//   2. attention pass, one block per (64-row query tile, batch row): for
//      each head a flash tile loop on wmma fragments (attend_tile_wmma,
//      below; it leaves the head's output in shared memory, where this
//      pass reads it, while K1's wgmma loop keeps it in registers) over the
//      workspace,
//      the head's output rounded into a [64, I] tile in shared memory; then
//      y = x + round(out . Wo^T) for the tile (Wo is 72 KB, read from L2).
// K6b, seven launches:
//   1. the projection pass again, also writing h (dWq's and dWkv's operand);
//   2. per (query tile, batch row): dout = round(dy . Wo), then the same
//      tile loop per head for the f32 output o, writing round(o) (dWo's operand),
//      the row lse and D = rowsum(dout * o);
//   3-4. K1b's dq and dk/dv kernels with that D (not rowsum over the rounded
//      o as in K1b), writing dq * scale, dk * scale and dv into a bf16
//      [B, N, 3I] workspace;
//   5. row pass, one block per 16 rows: dhid = dqkv . [Wq; Wkv] in f32, both
//      LayerNorm backwards (statistics recomputed from x), dx, and the
//      block's column sums of dg1 and dg2 (shared-memory atomics, f32);
//   6-7. the weight gradients dWqkv = dqkv^T . h and dWo = dy^T . round(o)
//      and the reduction of all partials (wgrad.cuh), cast to bf16 once.
// The workspaces cost device memory (about 135 MB at the pretraining shape)
// and a write and a read each; keeping them on chip is work for a later
// version. Simple and correct first: wmma, no TMA, no wgmma.
#include "wgrad.cuh"
#include "zorro_attention.cuh"

namespace {

using zorro::bf16;
using zorro::BQ;
using zorro::THREADS;
using zorro::WARPS;
using namespace nvcuda;
using Acc = wmma::fragment<wmma::accumulator, 16, 16, 16, float>;
using FragA = wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major>;
using FragBCol = wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major>;
using FragBRow = wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major>;

// K6's attention tile loop: wmma fragments, the scores, probabilities and
// output accumulator staged in shared memory per 64-key tile, synchronous
// tile loads. K6's attention pass and K6b's prep read the head output from
// shared memory (WmmaTile::so, ::l_row, ::m_row).
template <int DH>
struct WmmaLayout {
  static constexpr int LDH = DH + 8;         // bf16 pitch of the q/k/v tiles
  static constexpr int LDS = zorro::BK + 4;  // f32 pitch of the score tile
  static constexpr int LDP = zorro::BK + 8;  // bf16 pitch of the probability tile
  static constexpr int LDO = DH + 4;         // f32 pitch of the output accumulator
  static constexpr size_t Q = size_t(BQ) * LDH * sizeof(bf16);
  static constexpr size_t K = size_t(zorro::BK) * LDH * sizeof(bf16);
  static constexpr size_t S = size_t(BQ) * LDS * sizeof(float);
  static constexpr size_t P = size_t(BQ) * LDP * sizeof(bf16);
  static constexpr size_t O = size_t(BQ) * LDO * sizeof(float);
  static constexpr size_t ROWS = size_t(3) * BQ * sizeof(float);
  static constexpr size_t TYPES = size_t(BQ + zorro::BK) * sizeof(int);
  static constexpr size_t BYTES = Q + 2 * K + S + P + O + ROWS + TYPES;
};

// The forward's shared-memory tiles.
template <int DH>
struct WmmaTile {
  bf16* sq;
  bf16* sk;
  bf16* sv;
  float* ss;
  bf16* sp;
  float* so;
  float* m_row;
  float* l_row;
  float* c_row;
  int* tq;
  int* tk;

  __device__ explicit WmmaTile(unsigned char* smem) {
    using L = WmmaLayout<DH>;
    sq = reinterpret_cast<bf16*>(smem);
    sk = reinterpret_cast<bf16*>(smem + L::Q);
    sv = reinterpret_cast<bf16*>(smem + L::Q + L::K);
    ss = reinterpret_cast<float*>(smem + L::Q + 2 * L::K);
    sp = reinterpret_cast<bf16*>(smem + L::Q + 2 * L::K + L::S);
    so = reinterpret_cast<float*>(smem + L::Q + 2 * L::K + L::S + L::P);
    m_row = reinterpret_cast<float*>(smem + L::Q + 2 * L::K + L::S + L::P + L::O);
    l_row = m_row + BQ;
    c_row = l_row + BQ;
    tq = reinterpret_cast<int*>(c_row + BQ);
    tk = tq + BQ;
  }
};

// Copies rows [r0, r0 + 64) of a dh-wide column slice into shared memory,
// 8 bf16 (16 bytes) per thread per step; rows at or past n become zeros.
template <int DH>
__device__ __forceinline__ void load_tile_sync(bf16* dst, const bf16* src, int r0, int n, long long rstride) {
  constexpr int CHUNKS = DH / 8;
  for (int i = threadIdx.x; i < 64 * CHUNKS; i += THREADS) {
    const int r = i / CHUNKS;
    const int c = (i % CHUNKS) * 8;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (r0 + r < n) val = *reinterpret_cast<const uint4*>(src + (long long)(r0 + r) * rstride + c);
    *reinterpret_cast<uint4*>(dst + r * WmmaLayout<DH>::LDH + c) = val;
  }
}

__device__ __forceinline__ float warp_max(float v) {
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// One head's attention for the 64 query rows [q0, q0 + 64) of batch row b:
// leaves the f32 numerator of the output in t.so (pitch LDO), the row sums
// in t.l_row and the row maxima in t.m_row; each warp's 16 rows are its own.
// tg: batch row b's token types (MODE_ZORRO).
template <int DH, int MODE>
__device__ __forceinline__ void attend_tile_wmma(const WmmaTile<DH>& t, const zorro::Operands& in, const int32_t* tg,
                                            const int32_t* active, int nt, int b, int h, int q0, int n,
                                            float scale, int fusion_type) {
  using L = WmmaLayout<DH>;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int row0 = warp * 16;  // this warp's first query row in the tile
  const bf16* qg = in.q + (long long)b * in.bstride + h * DH;
  const bf16* kg = in.k + (long long)b * in.bstride + h * DH;
  const bf16* vg = in.v + (long long)b * in.bstride + h * DH;

  __syncthreads();  // every warp is done with the tiles' previous use
  load_tile_sync<DH>(t.sq, qg, q0, n, in.rstride);
  for (int i = threadIdx.x; i < BQ; i += THREADS)
    t.tq[i] = (MODE == zorro::MODE_ZORRO && q0 + i < n) ? tg[q0 + i] : zorro::PAD_TYPE;
  for (int i = lane; i < 16 * DH; i += 32) t.so[(row0 + i / DH) * L::LDO + i % DH] = 0.0f;
  if (lane < 16) {
    t.m_row[row0 + lane] = -CUDART_INF_F;  // no key seen yet
    t.l_row[row0 + lane] = 0.0f;
  }

  for (int k0 = 0; k0 < n; k0 += zorro::BK) {
    if (!zorro::pair_active(active, nt, b, q0, k0)) continue;  // the same for the whole block
    __syncthreads();  // every warp is done with the previous k/v tile
    load_tile_sync<DH>(t.sk, kg, k0, n, in.rstride);
    load_tile_sync<DH>(t.sv, vg, k0, n, in.rstride);
    for (int i = threadIdx.x; i < zorro::BK; i += THREADS)
      t.tk[i] = (MODE == zorro::MODE_ZORRO && k0 + i < n) ? tg[k0 + i] : zorro::PAD_TYPE;
    __syncthreads();

    // scores of this warp's 16 rows against the 64 keys: 4 fragments
    for (int j = 0; j < zorro::BK / 16; ++j) {
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
      wmma::fill_fragment(acc, 0.0f);
      for (int kk = 0; kk < DH / 16; ++kk) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a;
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> bt;
        wmma::load_matrix_sync(a, t.sq + row0 * L::LDH + kk * 16, L::LDH);
        wmma::load_matrix_sync(bt, t.sk + (j * 16) * L::LDH + kk * 16, L::LDH);
        wmma::mma_sync(acc, a, bt, acc);
      }
      wmma::store_matrix_sync(t.ss + row0 * L::LDS + j * 16, acc, L::LDS, wmma::mem_row_major);
    }
    __syncwarp();

    // online softmax, one row at a time; lane owns keys lane and lane + 32
    for (int rr = 0; rr < 16; ++rr) {
      const int r = row0 + rr;
      const int t_q = t.tq[r];
      float s[2];
      bool in_range[2];
      for (int u = 0; u < 2; ++u) {
        const int c = lane + 32 * u;
        in_range[u] = k0 + c < n;
        float v = t.ss[r * L::LDS + c] * scale;  // scale first, then mask
        if (MODE == zorro::MODE_ZORRO) {
          const int t_k = t.tk[c];
          const bool ok = (t_q == t_k) || (t_q == fusion_type && t_k != zorro::PAD_TYPE);
          v = ok ? v : zorro::NEG_INF;
        }
        s[u] = in_range[u] ? v : -CUDART_INF_F;
      }
      const float m_old = t.m_row[r];
      const float m_new = fmaxf(m_old, warp_max(fmaxf(s[0], s[1])));
      float p_sum = 0.0f;
      for (int u = 0; u < 2; ++u) {
        const float p = in_range[u] ? expf(s[u] - m_new) : 0.0f;
        p_sum += p;
        t.sp[r * L::LDP + lane + 32 * u] = __float2bfloat16(p);
      }
      p_sum = zorro::warp_sum(p_sum);
      if (lane == 0) {
        const float corr = expf(m_old - m_new);  // 0 on the first tile
        t.l_row[r] = t.l_row[r] * corr + p_sum;
        t.m_row[r] = m_new;
        t.c_row[r] = corr;
      }
    }
    __syncwarp();

    for (int i = lane; i < 16 * DH; i += 32) {
      const int r = row0 + i / DH;
      t.so[r * L::LDO + i % DH] *= t.c_row[r];
    }
    __syncwarp();

    // O[16 rows, DH] += P[16 rows, 64] . V[64, DH]
    for (int c = 0; c < DH / 16; ++c) {
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
      wmma::load_matrix_sync(acc, t.so + row0 * L::LDO + c * 16, L::LDO, wmma::mem_row_major);
      for (int kk = 0; kk < zorro::BK / 16; ++kk) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a;
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> bv;
        wmma::load_matrix_sync(a, t.sp + row0 * L::LDP + kk * 16, L::LDP);
        wmma::load_matrix_sync(bv, t.sv + (kk * 16) * L::LDH + c * 16, L::LDH);
        wmma::mma_sync(acc, a, bv, acc);
      }
      wmma::store_matrix_sync(t.so + row0 * L::LDO + c * 16, acc, L::LDO, wmma::mem_row_major);
    }
    __syncwarp();
  }
}

constexpr float LN_EPS = 1e-5f;
constexpr int PM = 64;    // rows per block of the projection pass
constexpr int RM = 16;    // rows per block of the LayerNorm-backward pass
constexpr int LDST = 68;  // f32 pitch of a warp's 16 x 64 staging rows

__host__ __device__ constexpr size_t align128(size_t bytes) { return (bytes + 127) / 128 * 128; }

// Mean and 1 / sqrt(var + eps) of the row f(0..d-1), one warp, two passes
// (jnp.var).
template <class F>
__device__ __forceinline__ float2 row_stats(const F& f, int d, int lane) {
  float s = 0.0f;
  for (int c = lane; c < d; c += 32) s += f(c);
  const float mean = zorro::warp_sum(s) / d;
  float sq = 0.0f;
  for (int c = lane; c < d; c += 32) {
    const float t = f(c) - mean;
    sq += t * t;
  }
  return make_float2(mean, 1.0f / sqrtf(zorro::warp_sum(sq) / d + LN_EPS));
}

// Rounds the warp's 16 staged rows (columns [0, w16), pitch LDST) to bf16:
// put(r, c, value) for each.
template <class Put>
__device__ __forceinline__ void drain(const float* stg, int w16, int lane, const Put& put) {
  __syncwarp();
  for (int i = lane; i < 16 * w16; i += 32)
    put(i / w16, i % w16, __float2bfloat16(stg[(i / w16) * LDST + i % w16]));
  __syncwarp();
}

size_t proj_bytes(int d) {
  return align128(size_t(PM) * (d + 8) * sizeof(bf16)) + size_t(WARPS) * 16 * LDST * sizeof(float);
}

// Projection pass: block of PM rows of the [M, D] input.
__global__ void __launch_bounds__(THREADS)
block_attn_proj_kernel(const bf16* __restrict__ x, const bf16* __restrict__ g1, const bf16* __restrict__ g2,
                       const bf16* __restrict__ wq, const bf16* __restrict__ wkv, bf16* __restrict__ qkv,
                       bf16* __restrict__ h_out, int m, int d, int inner) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int ldh = d + 8;
  bf16* hs = reinterpret_cast<bf16*>(smem);
  float* stage = reinterpret_cast<float*>(smem + align128(size_t(PM) * ldh * sizeof(bf16)));
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int row0 = warp * 16;
  const long long m0 = (long long)blockIdx.x * PM;
  const int width = 3 * inner;

  // h = round(LN_g2(round(LN_g1(x)))), a warp per row; rows past M are 0
  for (int r = warp; r < PM; r += WARPS) {
    bf16* hr = hs + r * ldh;
    const long long row = m0 + r;
    if (row >= m) {
      for (int c = lane; c < d; c += 32) hr[c] = __float2bfloat16(0.0f);
      continue;
    }
    const bf16* xr = x + row * d;
    const float2 s1 = row_stats([&](int c) { return __bfloat162float(xr[c]); }, d, lane);
    for (int c = lane; c < d; c += 32)
      hr[c] = __float2bfloat16((__bfloat162float(xr[c]) - s1.x) * s1.y * __bfloat162float(g1[c]));
    const float2 s2 = row_stats([&](int c) { return __bfloat162float(hr[c]); }, d, lane);
    for (int c = lane; c < d; c += 32) {
      const bf16 hv = __float2bfloat16((__bfloat162float(hr[c]) - s2.x) * s2.y * __bfloat162float(g2[c]));
      hr[c] = hv;
      if (h_out != nullptr) h_out[row * d + c] = hv;
    }
  }
  __syncthreads();

  // qkv [rows, 3I] = round(h . [Wq; Wkv]^T), the warp's 16 rows x 64 columns
  float* stg = stage + warp * 16 * LDST;
  for (int c0 = 0; c0 < width; c0 += 64) {
    const int nf = min(4, (width - c0) / 16);
    Acc acc[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) wmma::fill_fragment(acc[j], 0.0f);
    for (int kk = 0; kk < d; kk += 16) {
      FragA a;
      wmma::load_matrix_sync(a, hs + row0 * ldh + kk, ldh);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        if (j < nf) {
          const int col = c0 + j * 16;  // a 16-column group lies within Wq or within Wkv (I % 16 == 0)
          const bf16* w = col < inner ? wq + (long long)col * d : wkv + (long long)(col - inner) * d;
          FragBCol bw;
          wmma::load_matrix_sync(bw, w + kk, d);
          wmma::mma_sync(acc[j], a, bw, acc[j]);
        }
      }
    }
#pragma unroll
    for (int j = 0; j < 4; ++j)
      if (j < nf) wmma::store_matrix_sync(stg + j * 16, acc[j], LDST, wmma::mem_row_major);
    drain(stg, nf * 16, lane, [&](int r, int c, bf16 v) {
      if (m0 + row0 + r < m) qkv[(m0 + row0 + r) * width + c0 + c] = v;
    });
  }
}

template <int DH>
size_t fwd_bytes(int inner) {
  return align128(WmmaLayout<DH>::BYTES) + size_t(BQ) * (inner + 8) * sizeof(bf16);
}

// Attention pass of K6: block (64-row query tile, batch row).
template <int DH>
__global__ void __launch_bounds__(THREADS)
block_attn_fwd_kernel(const bf16* __restrict__ qkv, const int32_t* __restrict__ types, const bf16* __restrict__ x,
                      const bf16* __restrict__ wo, bf16* __restrict__ y, int n, int heads, int d, float scale,
                      int fusion_type) {
  using L = WmmaLayout<DH>;
  static_assert(L::LDS == LDST, "the out projection stages in the score tile's rows");
  extern __shared__ __align__(128) unsigned char smem[];
  const WmmaTile<DH> t(smem);
  const int inner = heads * DH;
  const int ldo = inner + 8;
  bf16* ot = reinterpret_cast<bf16*>(smem + align128(L::BYTES));  // [64, I] head outputs
  const int q0 = blockIdx.x * BQ;
  const int b = blockIdx.y;
  const int lane = threadIdx.x % 32;
  const int row0 = (threadIdx.x / 32) * 16;
  const zorro::Operands in{qkv, qkv + inner, qkv + 2 * inner, (long long)n * 3 * inner, 3LL * inner};

  for (int h = 0; h < heads; ++h) {
    attend_tile_wmma<DH, zorro::MODE_ZORRO>(t, in, types + (long long)b * n, nullptr, 0, b, h, q0, n, scale,
                                              fusion_type);
    for (int i = lane; i < 16 * DH; i += 32) {
      const int r = row0 + i / DH;
      const int c = i % DH;
      ot[r * ldo + h * DH + c] = __float2bfloat16(t.so[r * L::LDO + c] / t.l_row[r]);
    }
  }
  __syncwarp();

  // y = x + round(out . Wo^T), the warp's 16 rows x 64 columns at a time,
  // staged in the warp's own rows of the score tile
  float* stg = t.ss + row0 * L::LDS;
  for (int c0 = 0; c0 < d; c0 += 64) {
    const int nf = min(4, (d - c0) / 16);
    Acc acc[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) wmma::fill_fragment(acc[j], 0.0f);
    for (int kk = 0; kk < inner; kk += 16) {
      FragA a;
      wmma::load_matrix_sync(a, ot + row0 * ldo + kk, ldo);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        if (j < nf) {
          FragBCol bw;  // element (k, c) = Wo[c0 + 16 j + c, k]
          wmma::load_matrix_sync(bw, wo + (long long)(c0 + j * 16) * inner + kk, inner);
          wmma::mma_sync(acc[j], a, bw, acc[j]);
        }
      }
    }
#pragma unroll
    for (int j = 0; j < 4; ++j)
      if (j < nf) wmma::store_matrix_sync(stg + j * 16, acc[j], L::LDS, wmma::mem_row_major);
    drain(stg, nf * 16, lane, [&](int r, int c, bf16 v) {
      const int q = q0 + row0 + r;
      if (q < n) {
        const long long idx = ((long long)b * n + q) * d + c0 + c;
        y[idx] = __float2bfloat16(__bfloat162float(x[idx]) + __bfloat162float(v));
      }
    });
  }
}

template <int DH>
__host__ __device__ size_t prep_region(int d) {
  const size_t tiles = align128(WmmaLayout<DH>::BYTES);
  const size_t dy_tile = align128(size_t(BQ) * (d + 8) * sizeof(bf16));
  return tiles > dy_tile ? tiles : dy_tile;
}

template <int DH>
size_t prep_bytes(int d, int inner) {
  return prep_region<DH>(d) + align128(size_t(BQ) * (inner + 8) * sizeof(bf16)) +
         size_t(BQ) * LDST * sizeof(float);
}

// K6b launch 2: block (64-row query tile, batch row).
template <int DH>
__global__ void __launch_bounds__(THREADS)
block_attn_bwd_prep_kernel(const bf16* __restrict__ qkv, const int32_t* __restrict__ types,
                           const bf16* __restrict__ dy, const bf16* __restrict__ wo, bf16* __restrict__ out_ws,
                           bf16* __restrict__ dout_ws, float* __restrict__ lse, float* __restrict__ delta, int n,
                           int heads, int d, float scale, int fusion_type) {
  using L = WmmaLayout<DH>;
  extern __shared__ __align__(128) unsigned char smem[];
  const WmmaTile<DH> t(smem);
  bf16* dyt = reinterpret_cast<bf16*>(smem);  // the dy tile, in the tiles' space before the head loop
  const int inner = heads * DH;
  const int ldo = inner + 8;
  const int ldy = d + 8;
  const size_t region = prep_region<DH>(d);
  bf16* dt = reinterpret_cast<bf16*>(smem + region);  // [64, I] dout tile
  float* stage = reinterpret_cast<float*>(smem + region + align128(size_t(BQ) * ldo * sizeof(bf16)));
  const int q0 = blockIdx.x * BQ;
  const int b = blockIdx.y;
  const int lane = threadIdx.x % 32;
  const int row0 = (threadIdx.x / 32) * 16;

  for (int i = threadIdx.x; i < BQ * (d / 8); i += THREADS) {
    const int r = i / (d / 8);
    const int c = (i % (d / 8)) * 8;
    uint4 v = make_uint4(0u, 0u, 0u, 0u);
    if (q0 + r < n) v = *reinterpret_cast<const uint4*>(dy + ((long long)b * n + q0 + r) * d + c);
    *reinterpret_cast<uint4*>(dyt + r * ldy + c) = v;
  }
  __syncthreads();

  // dout [64, I] = round(dy . Wo), Wo [D, I] row-major
  float* stg = stage + row0 * LDST;
  for (int c0 = 0; c0 < inner; c0 += 64) {
    const int nf = min(4, (inner - c0) / 16);
    Acc acc[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) wmma::fill_fragment(acc[j], 0.0f);
    for (int kk = 0; kk < d; kk += 16) {
      FragA a;
      wmma::load_matrix_sync(a, dyt + row0 * ldy + kk, ldy);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        if (j < nf) {
          FragBRow bw;
          wmma::load_matrix_sync(bw, wo + (long long)kk * inner + c0 + j * 16, inner);
          wmma::mma_sync(acc[j], a, bw, acc[j]);
        }
      }
    }
#pragma unroll
    for (int j = 0; j < 4; ++j)
      if (j < nf) wmma::store_matrix_sync(stg + j * 16, acc[j], LDST, wmma::mem_row_major);
    drain(stg, nf * 16, lane, [&](int r, int c, bf16 v) {
      dt[(row0 + r) * ldo + c0 + c] = v;
      const int q = q0 + row0 + r;
      if (q < n) dout_ws[((long long)b * n + q) * inner + c0 + c] = v;
    });
  }

  // per head: the forward's tile loop (it starts with a block barrier, after
  // which the dy tile's space holds the attention tiles), then round(o), lse
  // and D = rowsum(dout * o) on the f32 o, the warp's 16 rows
  const zorro::Operands in{qkv, qkv + inner, qkv + 2 * inner, (long long)n * 3 * inner, 3LL * inner};
  for (int h = 0; h < heads; ++h) {
    attend_tile_wmma<DH, zorro::MODE_ZORRO>(t, in, types + (long long)b * n, nullptr, 0, b, h, q0, n, scale,
                                              fusion_type);
    for (int rr = 0; rr < 16; ++rr) {
      const int r = row0 + rr;
      const int q = q0 + r;
      float part = 0.0f;
      for (int c = lane; c < DH; c += 32) {
        const float o = t.so[r * L::LDO + c] / t.l_row[r];
        part += __bfloat162float(dt[r * ldo + h * DH + c]) * o;
        if (q < n) out_ws[((long long)b * n + q) * inner + h * DH + c] = __float2bfloat16(o);
      }
      part = zorro::warp_sum(part);
      if (lane == 0 && q < n) {
        const long long idx = ((long long)b * heads + h) * n + q;
        delta[idx] = part;
        lse[idx] = t.m_row[r] + logf(t.l_row[r]);
      }
    }
  }
}

size_t rows_bytes(int d, int inner) {
  return align128(size_t(RM) * (3 * inner + 8) * sizeof(bf16)) + size_t(RM) * (d + 4) * sizeof(float) +
         size_t(2) * d * sizeof(float);
}

// K6b launch 5: block of RM rows of [M, D].
__global__ void __launch_bounds__(THREADS)
block_attn_bwd_rows_kernel(const bf16* __restrict__ x, const bf16* __restrict__ g1, const bf16* __restrict__ g2,
                           const bf16* __restrict__ wq, const bf16* __restrict__ wkv,
                           const bf16* __restrict__ dqkv, const bf16* __restrict__ dy, bf16* __restrict__ dx,
                           float* __restrict__ vec_part, int m, int d, int inner) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int width = 3 * inner;
  const int ldq = width + 8;
  const int ldd = d + 4;
  bf16* dqt = reinterpret_cast<bf16*>(smem);
  float* dh = reinterpret_cast<float*>(smem + align128(size_t(RM) * ldq * sizeof(bf16)));
  float* col = dh + RM * ldd;  // this block's sums: dg1 [d], then dg2 [d]
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const long long m0 = (long long)blockIdx.x * RM;

  for (int i = threadIdx.x; i < RM * (width / 8); i += THREADS) {
    const int r = i / (width / 8);
    const int c = (i % (width / 8)) * 8;
    uint4 v = make_uint4(0u, 0u, 0u, 0u);
    if (m0 + r < m) v = *reinterpret_cast<const uint4*>(dqkv + (m0 + r) * width + c);
    *reinterpret_cast<uint4*>(dqt + r * ldq + c) = v;
  }
  for (int c = threadIdx.x; c < 2 * d; c += THREADS) col[c] = 0.0f;
  __syncthreads();

  // dhid [RM, d] = dqkv . [Wq; Wkv] in f32, 16 columns per warp step
  for (int n0 = warp * 16; n0 < d; n0 += WARPS * 16) {
    Acc acc;
    wmma::fill_fragment(acc, 0.0f);
    for (int kk = 0; kk < width; kk += 16) {
      FragA a;
      wmma::load_matrix_sync(a, dqt + kk, ldq);
      const bf16* w = kk < inner ? wq + (long long)kk * d : wkv + (long long)(kk - inner) * d;
      FragBRow bw;
      wmma::load_matrix_sync(bw, w + n0, d);
      wmma::mma_sync(acc, a, bw, acc);
    }
    wmma::store_matrix_sync(dh + n0, acc, ldd, wmma::mem_row_major);
  }
  __syncthreads();

  // a warp per row: both LayerNorm backwards (pallas_block_attn.py:56-62),
  // the statistics and z recomputed from x; dx; the gain gradients' sums
  for (int r = warp; r < RM; r += WARPS) {
    const long long row = m0 + r;
    if (row >= m) continue;
    const bf16* xr = x + row * d;
    float* dr = dh + r * ldd;
    const float2 s1 = row_stats([&](int c) { return __bfloat162float(xr[c]); }, d, lane);
    auto z1_of = [&](int c) { return (__bfloat162float(xr[c]) - s1.x) * s1.y; };
    auto a_of = [&](int c) { return __bfloat162float(__float2bfloat16(z1_of(c) * __bfloat162float(g1[c]))); };
    const float2 s2 = row_stats(a_of, d, lane);

    float p1 = 0.0f, p2 = 0.0f;  // LN2: mean(dz), mean(dz * z) with dz = dhid * g2
    for (int c = lane; c < d; c += 32) {
      const float dz = dr[c] * __bfloat162float(g2[c]);
      p1 += dz;
      p2 += dz * (a_of(c) - s2.x) * s2.y;
    }
    p1 = zorro::warp_sum(p1) / d;
    p2 = zorro::warp_sum(p2) / d;
    for (int c = lane; c < d; c += 32) {
      const float z2 = (a_of(c) - s2.x) * s2.y;
      atomicAdd(&col[d + c], dr[c] * z2);
      dr[c] = (dr[c] * __bfloat162float(g2[c]) - p1 - z2 * p2) * s2.y;  // da, f32
    }
    float t1 = 0.0f, t2 = 0.0f;  // LN1, the same with dz = da * g1
    for (int c = lane; c < d; c += 32) {
      const float dz = dr[c] * __bfloat162float(g1[c]);
      t1 += dz;
      t2 += dz * z1_of(c);
    }
    t1 = zorro::warp_sum(t1) / d;
    t2 = zorro::warp_sum(t2) / d;
    for (int c = lane; c < d; c += 32) {
      const float z1 = z1_of(c);
      atomicAdd(&col[c], dr[c] * z1);
      const float dxl = (dr[c] * __bfloat162float(g1[c]) - t1 - z1 * t2) * s1.y;
      dx[row * d + c] = __float2bfloat16(__bfloat162float(dy[row * d + c]) + dxl);
    }
  }
  __syncthreads();
  for (int c = threadIdx.x; c < 2 * d; c += THREADS) vec_part[(long long)blockIdx.x * 2 * d + c] = col[c];
}

cudaError_t set_smem(const void* kernel, size_t bytes) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

cudaError_t launch_proj(const bf16* x, const bf16* g1, const bf16* g2, const bf16* wq, const bf16* wkv, bf16* qkv,
                        bf16* h_out, int m, int d, int inner, cudaStream_t stream) {
  const size_t bytes = proj_bytes(d);
  cudaError_t err = set_smem((const void*)block_attn_proj_kernel, bytes);
  if (err != cudaSuccess) return err;
  block_attn_proj_kernel<<<(m + PM - 1) / PM, THREADS, bytes, stream>>>(x, g1, g2, wq, wkv, qkv, h_out, m, d,
                                                                         inner);
  return cudaGetLastError();
}

template <int DH>
cudaError_t run_fwd(const bf16* x, const int32_t* types, const bf16* g1, const bf16* g2, const bf16* wq,
                    const bf16* wkv, const bf16* wo, bf16* y, bf16* qkv_ws, int batch, int n, int d, int heads,
                    float scale, int fusion_type, cudaStream_t stream) {
  const int inner = heads * DH;
  cudaError_t err = launch_proj(x, g1, g2, wq, wkv, qkv_ws, nullptr, batch * n, d, inner, stream);
  if (err != cudaSuccess) return err;
  auto kernel = block_attn_fwd_kernel<DH>;
  const size_t bytes = fwd_bytes<DH>(inner);
  err = set_smem((const void*)kernel, bytes);
  if (err != cudaSuccess) return err;
  kernel<<<dim3((n + BQ - 1) / BQ, batch), THREADS, bytes, stream>>>(qkv_ws, types, x, wo, y, n, heads, d, scale,
                                                                     fusion_type);
  return cudaGetLastError();
}

struct BwdArgs {
  const bf16* x;
  const int32_t* types;
  const bf16* g1;
  const bf16* g2;
  const bf16* wq;
  const bf16* wkv;
  const bf16* wo;
  const bf16* dy;
  bf16* dx;
  bf16* dg1;
  bf16* dg2;
  bf16* dw_qkv;
  bf16* dwo;
  bf16* qkv_ws;
  bf16* h_ws;
  bf16* out_ws;
  bf16* dout_ws;
  float* lse;
  float* delta;
  bf16* dqkv_ws;
  float* part;
  float* vec;
};

template <int DH>
cudaError_t run_bwd(const BwdArgs& a, int batch, int n, int d, int heads, float scale, int fusion_type,
                    int splits, cudaStream_t stream) {
  const int inner = heads * DH;
  const int m = batch * n;
  cudaError_t err = launch_proj(a.x, a.g1, a.g2, a.wq, a.wkv, a.qkv_ws, a.h_ws, m, d, inner, stream);
  if (err != cudaSuccess) return err;

  auto prep = block_attn_bwd_prep_kernel<DH>;
  size_t bytes = prep_bytes<DH>(d, inner);
  err = set_smem((const void*)prep, bytes);
  if (err != cudaSuccess) return err;
  prep<<<dim3((n + BQ - 1) / BQ, batch), THREADS, bytes, stream>>>(a.qkv_ws, a.types, a.dy, a.wo, a.out_ws,
                                                                   a.dout_ws, a.lse, a.delta, n, heads, d, scale,
                                                                   fusion_type);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  const zorro::Operands in{a.qkv_ws, a.qkv_ws + inner, a.qkv_ws + 2 * inner, (long long)n * 3 * inner,
                           3LL * inner};
  const zorro::GradOperands grad{a.dqkv_ws, a.dqkv_ws + inner, a.dqkv_ws + 2 * inner, (long long)n * 3 * inner,
                                 3LL * inner};
  err = zorro::launch_bwd<DH, zorro::MODE_ZORRO>(in, a.types, nullptr, 0, a.out_ws, a.lse, a.dout_ws, grad,
                                                 a.delta, 1, batch, n, heads, n, scale, fusion_type, stream);
  if (err != cudaSuccess) return err;

  bytes = rows_bytes(d, inner);
  err = set_smem((const void*)block_attn_bwd_rows_kernel, bytes);
  if (err != cudaSuccess) return err;
  const int blocks = (m + RM - 1) / RM;
  block_attn_bwd_rows_kernel<<<blocks, THREADS, bytes, stream>>>(a.x, a.g1, a.g2, a.wq, a.wkv, a.dqkv_ws, a.dy,
                                                                 a.dx, a.vec, m, d, inner);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  const wgrad::WGrad g0{a.dqkv_ws, a.h_ws, a.part, 3 * inner, d};
  const wgrad::WGrad g1{a.dy, a.out_ws, a.part + (long long)splits * 3 * inner * d, d, inner};
  return wgrad::launch(g0, a.dw_qkv, g1, a.dwo, m, splits, a.vec, blocks, d, a.dg1, d, a.dg2, stream);
}

bool shape_ok(int batch, int n, int d, int heads) {
  return batch >= 1 && n >= 1 && heads >= 1 && d >= 16 && d % 16 == 0;
}

}  // namespace

// Rows per block of the backward's row pass: the gain partials are
// f32 [ceil(B * N / this), 2 * D].
extern "C" int fused_block_attn_row_block() { return RM; }

// Forward: x, y [B, N, D]; types int32 [B, N] (PAD_TYPE = padding); g1, g2
// [D]; wq [I, D]; wkv [2I, D]; wo [D, I]; workspace qkv [B, N, 3I]. All bf16
// but types, contiguous. D % 16 == 0, dh in {32, 64, 128}. Two launches;
// returns the first cudaError_t.
extern "C" int fused_block_attn_fwd_bf16(const void* x, const void* types, const void* g1, const void* g2,
                                         const void* wq, const void* wkv, const void* wo, void* y, void* qkv_ws,
                                         int batch, int n, int d, int heads, int dh, float scale, int fusion_type,
                                         void* stream) {
  if (!shape_ok(batch, n, d, heads)) return (int)cudaErrorInvalidValue;
  const bf16* xp = static_cast<const bf16*>(x);
  const int32_t* tp = static_cast<const int32_t*>(types);
  const bf16 *g1p = static_cast<const bf16*>(g1), *g2p = static_cast<const bf16*>(g2);
  const bf16 *wqp = static_cast<const bf16*>(wq), *wkvp = static_cast<const bf16*>(wkv);
  const bf16* wop = static_cast<const bf16*>(wo);
  bf16* yp = static_cast<bf16*>(y);
  bf16* ws = static_cast<bf16*>(qkv_ws);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dh) {
    case 32:
      return (int)run_fwd<32>(xp, tp, g1p, g2p, wqp, wkvp, wop, yp, ws, batch, n, d, heads, scale, fusion_type, s);
    case 64:
      return (int)run_fwd<64>(xp, tp, g1p, g2p, wqp, wkvp, wop, yp, ws, batch, n, d, heads, scale, fusion_type, s);
    case 128:
      return (int)run_fwd<128>(xp, tp, g1p, g2p, wqp, wkvp, wop, yp, ws, batch, n, d, heads, scale, fusion_type,
                               s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

// Backward: the forward's operands and dy [B, N, D]; outputs dx [B, N, D],
// dg1, dg2 [D], dw_qkv [3I, D] (dWq then dWkv), dwo [D, I]; bf16
// workspaces qkv and dqkv [B, N, 3I], h [B, N, D], out and dout [B, N, I];
// f32 workspaces lse and delta [B, H, N], part [splits * (3I * D + D * I)],
// vec [ceil(B * N / row_block), 2D]. Seven launches; returns the first
// cudaError_t.
extern "C" int fused_block_attn_bwd_bf16(const void* x, const void* types, const void* g1, const void* g2,
                                         const void* wq, const void* wkv, const void* wo, const void* dy, void* dx,
                                         void* dg1, void* dg2, void* dw_qkv, void* dwo, void* qkv_ws, void* h_ws,
                                         void* out_ws, void* dout_ws, void* lse, void* delta, void* dqkv_ws,
                                         void* part, void* vec, int batch, int n, int d, int heads, int dh,
                                         float scale, int fusion_type, int splits, void* stream) {
  if (!shape_ok(batch, n, d, heads) || splits < 1) return (int)cudaErrorInvalidValue;
  const BwdArgs a{static_cast<const bf16*>(x),  static_cast<const int32_t*>(types), static_cast<const bf16*>(g1),
                  static_cast<const bf16*>(g2), static_cast<const bf16*>(wq),       static_cast<const bf16*>(wkv),
                  static_cast<const bf16*>(wo), static_cast<const bf16*>(dy),       static_cast<bf16*>(dx),
                  static_cast<bf16*>(dg1),      static_cast<bf16*>(dg2),            static_cast<bf16*>(dw_qkv),
                  static_cast<bf16*>(dwo),      static_cast<bf16*>(qkv_ws),         static_cast<bf16*>(h_ws),
                  static_cast<bf16*>(out_ws),   static_cast<bf16*>(dout_ws),        static_cast<float*>(lse),
                  static_cast<float*>(delta),   static_cast<bf16*>(dqkv_ws),        static_cast<float*>(part),
                  static_cast<float*>(vec)};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dh) {
    case 32:
      return (int)run_bwd<32>(a, batch, n, d, heads, scale, fusion_type, splits, s);
    case 64:
      return (int)run_bwd<64>(a, batch, n, d, heads, scale, fusion_type, splits, s);
    case 128:
      return (int)run_bwd<128>(a, batch, n, d, heads, scale, fusion_type, splits, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
