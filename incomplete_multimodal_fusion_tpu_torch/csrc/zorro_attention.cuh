// The tile loops of K1 (zorro attention forward) and K1b (its backward),
// shared by zorro_attention.cu (K1 / K1b on the fused qkv slab, on separate
// q, k, v and with a tile-skip table) and fused_block_attn.cu (K6 / K6b, the
// fused attention half-block). The design notes are in zorro_attention.cu.
//
// An attention's operands are views: base pointers of q, k and v at (batch
// row 0, token 0, head 0) and the element strides between batch rows and
// between tokens; head h's columns start h * DH further. The fused slab is
// the view (qkv, qkv + I, qkv + 2I) with token stride 3I, separate tensors
// the view (q, k, v) with token stride I.
//
// Tile skipping: with an activity table `active` [B, nt * nt] (int32, one
// entry per pair of 128-token tiles, pallas_zorro_sparse.py TILE), a 64-row
// tile takes the entry of the 128-tile that holds it, and a dead pair of
// tiles is skipped: it adds nothing to the row max, the row sum or any
// product. A null table is the dense attention.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <float.h>
#include <math_constants.h>
#include <mma.h>
#include <stdint.h>

namespace zorro {

using namespace nvcuda;
using bf16 = __nv_bfloat16;

constexpr int BQ = 64;  // query rows per block
constexpr int BK = 64;  // keys per tile
constexpr int WARPS = 4;
constexpr int THREADS = WARPS * 32;
constexpr int PAD_TYPE = 255;
constexpr float NEG_INF = -0.7f * FLT_MAX;
constexpr int SKIP_TILE = 128;  // tokens per side of an activity-table tile

enum { MODE_ZORRO = 0, MODE_NONE = 1 };

struct Operands {
  const bf16* q;
  const bf16* k;
  const bf16* v;
  long long bstride;  // elements between batch rows
  long long rstride;  // elements between tokens
};

struct GradOperands {
  bf16* q;
  bf16* k;
  bf16* v;
  long long bstride;
  long long rstride;
};

template <int DH>
struct Layout {
  static constexpr int LDH = DH + 8;  // bf16 pitch of the q/k/v tiles
  static constexpr int LDS = BK + 4;  // f32 pitch of the score tile
  static constexpr int LDP = BK + 8;  // bf16 pitch of the probability tile
  static constexpr int LDO = DH + 4;  // f32 pitch of the output accumulator
  static constexpr size_t Q = size_t(BQ) * LDH * sizeof(bf16);
  static constexpr size_t K = size_t(BK) * LDH * sizeof(bf16);
  static constexpr size_t S = size_t(BQ) * LDS * sizeof(float);
  static constexpr size_t P = size_t(BQ) * LDP * sizeof(bf16);
  static constexpr size_t O = size_t(BQ) * LDO * sizeof(float);
  static constexpr size_t ROWS = size_t(3) * BQ * sizeof(float);
  static constexpr size_t TYPES = size_t(BQ + BK) * sizeof(int);
  static constexpr size_t BYTES = Q + 2 * K + S + P + O + ROWS + TYPES;
};

// The forward's shared-memory tiles.
template <int DH>
struct FwdTile {
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

  __device__ explicit FwdTile(unsigned char* smem) {
    using L = Layout<DH>;
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
__device__ __forceinline__ void load_tile(bf16* dst, const bf16* src, int r0, int n, long long rstride) {
  constexpr int CHUNKS = DH / 8;
  for (int i = threadIdx.x; i < 64 * CHUNKS; i += THREADS) {
    const int r = i / CHUNKS;
    const int c = (i % CHUNKS) * 8;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (r0 + r < n) val = *reinterpret_cast<const uint4*>(src + (long long)(r0 + r) * rstride + c);
    *reinterpret_cast<uint4*>(dst + r * Layout<DH>::LDH + c) = val;
  }
}

__device__ __forceinline__ float warp_max(float v) {
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// The entry of a (query tile, key tile) pair of 64s in the activity table,
// or 1 without one.
__device__ __forceinline__ bool pair_active(const int32_t* active, int nt, int b, int q0, int k0) {
  return active == nullptr || active[((long long)b * nt + q0 / SKIP_TILE) * nt + k0 / SKIP_TILE] != 0;
}

// One head's attention for the 64 query rows [q0, q0 + 64) of batch row b:
// leaves the f32 numerator of the output in t.so (pitch LDO), the row sums
// in t.l_row and the row maxima in t.m_row; each warp's 16 rows are its own.
// tg: batch row b's token types (MODE_ZORRO).
template <int DH, int MODE>
__device__ __forceinline__ void attend_tile(const FwdTile<DH>& t, const Operands& in, const int32_t* tg,
                                            const int32_t* active, int nt, int b, int h, int q0, int n,
                                            float scale, int fusion_type) {
  using L = Layout<DH>;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int row0 = warp * 16;  // this warp's first query row in the tile
  const bf16* qg = in.q + (long long)b * in.bstride + h * DH;
  const bf16* kg = in.k + (long long)b * in.bstride + h * DH;
  const bf16* vg = in.v + (long long)b * in.bstride + h * DH;

  __syncthreads();  // every warp is done with the tiles' previous use
  load_tile<DH>(t.sq, qg, q0, n, in.rstride);
  for (int i = threadIdx.x; i < BQ; i += THREADS)
    t.tq[i] = (MODE == MODE_ZORRO && q0 + i < n) ? tg[q0 + i] : PAD_TYPE;
  for (int i = lane; i < 16 * DH; i += 32) t.so[(row0 + i / DH) * L::LDO + i % DH] = 0.0f;
  if (lane < 16) {
    t.m_row[row0 + lane] = -CUDART_INF_F;  // no key seen yet
    t.l_row[row0 + lane] = 0.0f;
  }

  for (int k0 = 0; k0 < n; k0 += BK) {
    if (!pair_active(active, nt, b, q0, k0)) continue;  // the same for the whole block
    __syncthreads();  // every warp is done with the previous k/v tile
    load_tile<DH>(t.sk, kg, k0, n, in.rstride);
    load_tile<DH>(t.sv, vg, k0, n, in.rstride);
    for (int i = threadIdx.x; i < BK; i += THREADS)
      t.tk[i] = (MODE == MODE_ZORRO && k0 + i < n) ? tg[k0 + i] : PAD_TYPE;
    __syncthreads();

    // scores of this warp's 16 rows against the 64 keys: 4 fragments
    for (int j = 0; j < BK / 16; ++j) {
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
        if (MODE == MODE_ZORRO) {
          const int t_k = t.tk[c];
          const bool ok = (t_q == t_k) || (t_q == fusion_type && t_k != PAD_TYPE);
          v = ok ? v : NEG_INF;
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
      p_sum = warp_sum(p_sum);
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
      for (int kk = 0; kk < BK / 16; ++kk) {
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

// K1: block (query tile, head, batch row); out [B, N, H * DH] with the given
// strides, lse f32 [B, H, N] or null.
template <int DH, int MODE>
__global__ void __launch_bounds__(THREADS)
zorro_attention_kernel(Operands in, const int32_t* __restrict__ types, const int32_t* __restrict__ active,
                       int nt, bf16* __restrict__ out, float* __restrict__ lse, int n, long long out_bstride,
                       long long out_rstride, long long types_bstride, float scale, int fusion_type) {
  using L = Layout<DH>;
  extern __shared__ __align__(128) unsigned char smem[];
  const FwdTile<DH> t(smem);
  const int q0 = blockIdx.x * BQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int lane = threadIdx.x % 32;
  const int row0 = (threadIdx.x / 32) * 16;
  attend_tile<DH, MODE>(t, in, types + (long long)b * types_bstride, active, nt, b, h, q0, n, scale,
                        fusion_type);

  bf16* og = out + (long long)b * out_bstride + h * DH;
  for (int i = lane; i < 16 * DH; i += 32) {
    const int r = row0 + i / DH;
    const int c = i % DH;
    if (q0 + r < n) og[(long long)(q0 + r) * out_rstride + c] = __float2bfloat16(t.so[r * L::LDO + c] / t.l_row[r]);
  }
  if (lse != nullptr && lane < 16 && q0 + row0 + lane < n)
    lse[((long long)b * gridDim.y + h) * n + q0 + row0 + lane] = t.m_row[row0 + lane] + logf(t.l_row[row0 + lane]);
}

template <int DH, int MODE>
cudaError_t launch(const Operands& in, const int32_t* types, const int32_t* active, int nt, bf16* out,
                   float* lse, int batch, int n, int heads, long long out_bstride, long long out_rstride,
                   long long types_bstride, float scale, int fusion_type, cudaStream_t stream) {
  auto kernel = zorro_attention_kernel<DH, MODE>;
  const size_t bytes = Layout<DH>::BYTES;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return err;
  dim3 grid((n + BQ - 1) / BQ, heads, batch);
  kernel<<<grid, THREADS, bytes, stream>>>(in, types, active, nt, out, lse, n, out_bstride, out_rstride,
                                           types_bstride, scale, fusion_type);
  return cudaGetLastError();
}

template <int MODE>
cudaError_t dispatch(int dh, const Operands& in, const int32_t* types, const int32_t* active, int nt,
                     bf16* out, float* lse, int batch, int n, int heads, long long out_bstride,
                     long long out_rstride, long long types_bstride, float scale, int fusion_type,
                     cudaStream_t stream) {
  switch (dh) {
    case 32:
      return launch<32, MODE>(in, types, active, nt, out, lse, batch, n, heads, out_bstride, out_rstride,
                              types_bstride, scale, fusion_type, stream);
    case 64:
      return launch<64, MODE>(in, types, active, nt, out, lse, batch, n, heads, out_bstride, out_rstride,
                              types_bstride, scale, fusion_type, stream);
    case 128:
      return launch<128, MODE>(in, types, active, nt, out, lse, batch, n, heads, out_bstride, out_rstride,
                               types_bstride, scale, fusion_type, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

// ---------------------------------------------------------------------------
// Backward (K1b)
// ---------------------------------------------------------------------------

using Acc = wmma::fragment<wmma::accumulator, 16, 16, 16, float>;

template <int DH>
struct BwdLayout {
  static constexpr int LDH = DH + 8;  // bf16 pitch of the q/k/v/dO tiles
  static constexpr int LDS = BK + 4;  // f32 pitch of the 64 x 64 score tiles
  static constexpr int LDP = BK + 8;  // bf16 pitch of the 64 x 64 P / dS tiles
  static constexpr int LDA = DH + 4;  // f32 pitch of the accumulators' staging
  static constexpr size_t T = size_t(64) * LDH * sizeof(bf16);
  static constexpr size_t S = size_t(64) * LDS * sizeof(float);
  static constexpr size_t P = size_t(64) * LDP * sizeof(bf16);
  static constexpr size_t ROWS = size_t(4) * 64 * sizeof(float);  // lse, D, query and key types
  static constexpr size_t BYTES = 4 * T + 2 * S + 2 * P + ROWS;
  static_assert(size_t(64) * LDA * sizeof(float) <= 2 * S, "the staging fits the two score tiles");
};

template <int MODE>
__device__ __forceinline__ float masked_score(float s, int t_q, int t_k, int fusion_type) {
  if (MODE == MODE_ZORRO) {
    const bool ok = (t_q == t_k) || (t_q == fusion_type && t_k != PAD_TYPE);
    return ok ? s : NEG_INF;
  }
  return s;
}

// dst[16 rows, 64] (f32, pitch LDS) = A[16 rows, DH] . B[64 rows, DH]^T, all
// operands in shared memory; a and dst point at the warp's first row.
template <int DH>
__device__ __forceinline__ void rows_times_tile_t(float* dst, const bf16* a, const bf16* b) {
  using L = BwdLayout<DH>;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    Acc acc;
    wmma::fill_fragment(acc, 0.0f);
#pragma unroll
    for (int kk = 0; kk < DH / 16; ++kk) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> fa;
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> fb;
      wmma::load_matrix_sync(fa, a + kk * 16, L::LDH);
      wmma::load_matrix_sync(fb, b + (j * 16) * L::LDH + kk * 16, L::LDH);
      wmma::mma_sync(acc, fa, fb, acc);
    }
    wmma::store_matrix_sync(dst + j * 16, acc, L::LDS, wmma::mem_row_major);
  }
}

// acc (16 rows x DH in DH/16 fragments) += A[16 rows, 64] (bf16, pitch LDP)
// . B[64, DH] (bf16, pitch LDH).
template <int DH>
__device__ __forceinline__ void accumulate(Acc* acc, const bf16* a, const bf16* b) {
  using L = BwdLayout<DH>;
#pragma unroll
  for (int kk = 0; kk < BK / 16; ++kk) {
    wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> fa;
    wmma::load_matrix_sync(fa, a + kk * 16, L::LDP);
#pragma unroll
    for (int c = 0; c < DH / 16; ++c) {
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> fb;
      wmma::load_matrix_sync(fb, b + (kk * 16) * L::LDH + c * 16, L::LDH);
      wmma::mma_sync(acc[c], fa, fb, acc[c]);
    }
  }
}

// Writes acc * mul, the warp's 16 rows starting at global row r_first, into
// a dh-wide column slice (row stride rstride) as bf16, through the warp's
// f32 staging rows; rows at or past n are not written.
template <int DH>
__device__ __forceinline__ void store_rows(float* stage, const Acc* acc, bf16* dst, int r_first, int n,
                                           long long rstride, float mul, int lane) {
  using L = BwdLayout<DH>;
#pragma unroll
  for (int c = 0; c < DH / 16; ++c) wmma::store_matrix_sync(stage + c * 16, acc[c], L::LDA, wmma::mem_row_major);
  __syncwarp();
  for (int i = lane; i < 16 * DH; i += 32) {
    const int r = i / DH;
    const int c = i % DH;
    if (r_first + r < n) dst[(long long)(r_first + r) * rstride + c] = __float2bfloat16(stage[r * L::LDA + c] * mul);
  }
  __syncwarp();
}

// Block (query tile, head, batch row): D for its rows, then dQ over all key
// tiles. o and dout are contiguous [B, N, H * DH]. With delta_given, D is
// read from delta (and o is not read); else D = rowsum(dO * O) in f32
// (pallas_attn.py:552) is computed here and stored to delta for the dk/dv
// kernel.
template <int DH, int MODE>
__global__ void __launch_bounds__(THREADS)
zorro_attention_dq_kernel(Operands in, const int32_t* __restrict__ types, const int32_t* __restrict__ active,
                          int nt, const bf16* __restrict__ o, const float* __restrict__ lse,
                          const bf16* __restrict__ dout, GradOperands grad, float* __restrict__ delta,
                          int delta_given, int n, long long types_bstride, float scale, int fusion_type) {
  using L = BwdLayout<DH>;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* sq = reinterpret_cast<bf16*>(smem);
  bf16* sdo = sq + 64 * L::LDH;
  bf16* sk = sdo + 64 * L::LDH;
  bf16* sv = sk + 64 * L::LDH;
  float* ss = reinterpret_cast<float*>(smem + 4 * L::T);
  float* sdp = ss + 64 * L::LDS;
  bf16* sds = reinterpret_cast<bf16*>(smem + 4 * L::T + 2 * L::S);
  float* s_lse = reinterpret_cast<float*>(smem + 4 * L::T + 2 * L::S + 2 * L::P);
  float* s_d = s_lse + 64;
  int* tq = reinterpret_cast<int*>(s_d + 64);
  int* tk = tq + 64;

  const int q0 = blockIdx.x * BQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int row0 = warp * 16;
  const int inner = gridDim.y * DH;
  const bf16* kg = in.k + (long long)b * in.bstride + h * DH;
  const bf16* vg = in.v + (long long)b * in.bstride + h * DH;
  const bf16* og = o + (long long)b * n * inner + h * DH;
  const bf16* dog = dout + (long long)b * n * inner + h * DH;
  const int32_t* tg = types + (long long)b * types_bstride;
  const long long lse_row = ((long long)b * gridDim.y + h) * n;

  load_tile<DH>(sq, in.q + (long long)b * in.bstride + h * DH, q0, n, in.rstride);
  load_tile<DH>(sdo, dog, q0, n, inner);
  for (int i = threadIdx.x; i < BQ; i += THREADS)
    tq[i] = (MODE == MODE_ZORRO && q0 + i < n) ? tg[q0 + i] : PAD_TYPE;
  for (int rr = 0; rr < 16; ++rr) {
    const int q = q0 + row0 + rr;
    float part = 0.0f;
    if (q < n && !delta_given)
      for (int c = lane; c < DH; c += 32)
        part += __bfloat162float(dog[(long long)q * inner + c]) * __bfloat162float(og[(long long)q * inner + c]);
    part = warp_sum(part);
    if (lane == 0) {
      if (q < n && delta_given) part = delta[lse_row + q];
      s_d[row0 + rr] = q < n ? part : 0.0f;
      s_lse[row0 + rr] = q < n ? lse[lse_row + q] : 0.0f;
      if (q < n && !delta_given) delta[lse_row + q] = part;
    }
  }

  Acc acc[DH / 16];
#pragma unroll
  for (int c = 0; c < DH / 16; ++c) wmma::fill_fragment(acc[c], 0.0f);

  for (int k0 = 0; k0 < n; k0 += BK) {
    if (!pair_active(active, nt, b, q0, k0)) continue;  // the same for the whole block
    __syncthreads();  // every warp is done with the previous k/v tile
    load_tile<DH>(sk, kg, k0, n, in.rstride);
    load_tile<DH>(sv, vg, k0, n, in.rstride);
    for (int i = threadIdx.x; i < BK; i += THREADS)
      tk[i] = (MODE == MODE_ZORRO && k0 + i < n) ? tg[k0 + i] : PAD_TYPE;
    __syncthreads();

    rows_times_tile_t<DH>(ss + row0 * L::LDS, sq + row0 * L::LDH, sk);   // S = Q K^T
    rows_times_tile_t<DH>(sdp + row0 * L::LDS, sdo + row0 * L::LDH, sv);  // dP = dO V^T
    __syncwarp();
    for (int rr = 0; rr < 16; ++rr) {
      const int r = row0 + rr;
      const bool q_in = q0 + r < n;
      for (int u = 0; u < 2; ++u) {
        const int c = lane + 32 * u;
        const float s = masked_score<MODE>(ss[r * L::LDS + c] * scale, tq[r], tk[c], fusion_type);
        const float p = (q_in && k0 + c < n) ? expf(s - s_lse[r]) : 0.0f;
        sds[r * L::LDP + c] = __float2bfloat16(p * (sdp[r * L::LDS + c] - s_d[r]));
      }
    }
    __syncwarp();
    accumulate<DH>(acc, sds + row0 * L::LDP, sk);  // dQ += dS K
  }
  __syncthreads();  // the score tiles become the staging area
  store_rows<DH>(ss + row0 * L::LDA, acc, grad.q + (long long)b * grad.bstride + h * DH, q0 + row0, n,
                 grad.rstride, scale, lane);
}

// Block (key tile, head, batch row): dK and dV over all query tiles, with
// the D of the dq kernel.
template <int DH, int MODE>
__global__ void __launch_bounds__(THREADS)
zorro_attention_dkdv_kernel(Operands in, const int32_t* __restrict__ types, const int32_t* __restrict__ active,
                            int nt, const float* __restrict__ lse, const bf16* __restrict__ dout,
                            const float* __restrict__ delta, GradOperands grad, int n, long long types_bstride,
                            float scale, int fusion_type) {
  using L = BwdLayout<DH>;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* sk = reinterpret_cast<bf16*>(smem);
  bf16* sv = sk + 64 * L::LDH;
  bf16* sq = sv + 64 * L::LDH;
  bf16* sdo = sq + 64 * L::LDH;
  float* ss = reinterpret_cast<float*>(smem + 4 * L::T);
  float* sdp = ss + 64 * L::LDS;
  bf16* sp = reinterpret_cast<bf16*>(smem + 4 * L::T + 2 * L::S);
  bf16* sds = sp + 64 * L::LDP;
  float* s_lse = reinterpret_cast<float*>(smem + 4 * L::T + 2 * L::S + 2 * L::P);
  float* s_d = s_lse + 64;
  int* tq = reinterpret_cast<int*>(s_d + 64);
  int* tk = tq + 64;

  const int k0 = blockIdx.x * BK;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int row0 = warp * 16;  // this warp's first key row in the tile
  const int inner = gridDim.y * DH;
  const bf16* qg = in.q + (long long)b * in.bstride + h * DH;
  const bf16* dog = dout + (long long)b * n * inner + h * DH;
  const int32_t* tg = types + (long long)b * types_bstride;
  const long long lse_row = ((long long)b * gridDim.y + h) * n;

  load_tile<DH>(sk, in.k + (long long)b * in.bstride + h * DH, k0, n, in.rstride);
  load_tile<DH>(sv, in.v + (long long)b * in.bstride + h * DH, k0, n, in.rstride);
  for (int i = threadIdx.x; i < BK; i += THREADS)
    tk[i] = (MODE == MODE_ZORRO && k0 + i < n) ? tg[k0 + i] : PAD_TYPE;

  Acc dk[DH / 16], dv[DH / 16];
#pragma unroll
  for (int c = 0; c < DH / 16; ++c) {
    wmma::fill_fragment(dk[c], 0.0f);
    wmma::fill_fragment(dv[c], 0.0f);
  }

  for (int q0 = 0; q0 < n; q0 += BQ) {
    if (!pair_active(active, nt, b, q0, k0)) continue;  // the same for the whole block
    __syncthreads();  // every warp is done with the previous q/dO tile
    load_tile<DH>(sq, qg, q0, n, in.rstride);
    load_tile<DH>(sdo, dog, q0, n, inner);
    for (int i = threadIdx.x; i < BQ; i += THREADS) {
      const bool inside = q0 + i < n;
      tq[i] = (MODE == MODE_ZORRO && inside) ? tg[q0 + i] : PAD_TYPE;
      s_lse[i] = inside ? lse[lse_row + q0 + i] : 0.0f;
      s_d[i] = inside ? delta[lse_row + q0 + i] : 0.0f;
    }
    __syncthreads();

    rows_times_tile_t<DH>(ss + row0 * L::LDS, sk + row0 * L::LDH, sq);   // S^T = K Q^T
    rows_times_tile_t<DH>(sdp + row0 * L::LDS, sv + row0 * L::LDH, sdo);  // dP^T = V dO^T
    __syncwarp();
    for (int rr = 0; rr < 16; ++rr) {
      const int r = row0 + rr;
      const bool k_in = k0 + r < n;
      for (int u = 0; u < 2; ++u) {
        const int c = lane + 32 * u;
        const float s = masked_score<MODE>(ss[r * L::LDS + c] * scale, tq[c], tk[r], fusion_type);
        const float p = (k_in && q0 + c < n) ? expf(s - s_lse[c]) : 0.0f;
        sp[r * L::LDP + c] = __float2bfloat16(p);
        sds[r * L::LDP + c] = __float2bfloat16(p * (sdp[r * L::LDS + c] - s_d[c]));
      }
    }
    __syncwarp();
    accumulate<DH>(dv, sp + row0 * L::LDP, sdo);  // dV += P^T dO
    accumulate<DH>(dk, sds + row0 * L::LDP, sq);  // dK += dS^T Q
  }
  __syncthreads();  // the score tiles become the staging area
  store_rows<DH>(ss + row0 * L::LDA, dk, grad.k + (long long)b * grad.bstride + h * DH, k0 + row0, n,
                 grad.rstride, scale, lane);
  store_rows<DH>(ss + row0 * L::LDA, dv, grad.v + (long long)b * grad.bstride + h * DH, k0 + row0, n,
                 grad.rstride, 1.0f, lane);
}

template <int DH, int MODE>
cudaError_t launch_bwd(const Operands& in, const int32_t* types, const int32_t* active, int nt, const bf16* o,
                       const float* lse, const bf16* dout, const GradOperands& grad, float* delta,
                       int delta_given, int batch, int n, int heads, long long types_bstride, float scale,
                       int fusion_type, cudaStream_t stream) {
  auto dq_kernel = zorro_attention_dq_kernel<DH, MODE>;
  auto dkdv_kernel = zorro_attention_dkdv_kernel<DH, MODE>;
  const size_t bytes = BwdLayout<DH>::BYTES;
  cudaError_t err = cudaFuncSetAttribute(dq_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(dkdv_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return err;
  dim3 grid((n + BQ - 1) / BQ, heads, batch);
  dq_kernel<<<grid, THREADS, bytes, stream>>>(in, types, active, nt, o, lse, dout, grad, delta, delta_given, n,
                                              types_bstride, scale, fusion_type);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  dkdv_kernel<<<grid, THREADS, bytes, stream>>>(in, types, active, nt, lse, dout, delta, grad, n, types_bstride,
                                                scale, fusion_type);
  return cudaGetLastError();
}

template <int MODE>
cudaError_t dispatch_bwd(int dh, const Operands& in, const int32_t* types, const int32_t* active, int nt,
                         const bf16* o, const float* lse, const bf16* dout, const GradOperands& grad,
                         float* delta, int delta_given, int batch, int n, int heads, long long types_bstride,
                         float scale, int fusion_type, cudaStream_t stream) {
  switch (dh) {
    case 32:
      return launch_bwd<32, MODE>(in, types, active, nt, o, lse, dout, grad, delta, delta_given, batch, n,
                                  heads, types_bstride, scale, fusion_type, stream);
    case 64:
      return launch_bwd<64, MODE>(in, types, active, nt, o, lse, dout, grad, delta, delta_given, batch, n,
                                  heads, types_bstride, scale, fusion_type, stream);
    case 128:
      return launch_bwd<128, MODE>(in, types, active, nt, o, lse, dout, grad, delta, delta_given, batch, n,
                                   heads, types_bstride, scale, fusion_type, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace zorro
