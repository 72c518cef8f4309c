// K1: zorro_attention_qkv -- flash-style multi-head self-attention read
// straight off the fused [B, N, 3I] qkv projection, with the Zorro token-type
// mask built per tile (mode ZORRO) or no mask at all (mode NONE), and its
// backward (K1b).
//
// Replaces these Pallas TPU kernels of the JAX package:
//   forward
//   * ops/pallas_attn.py _fwd_kernel_packed_qkv (pallas_call in
//     _packed_qkv_fwd_impl): the encoder's zorro attention, whole-slab form;
//   * ops/pallas_attn.py _fwd_kernel / _fwd_kernel_tiled (pallas_call in
//     _zorro_attention_bhnd): the same attention on the [B*H, N, dh] layout,
//     q-tiled for N > 768. Here one kernel takes any N, so the split between
//     the two is gone;
//   * ops/pallas_small_attn.py _fwd_kernel_qkv (pallas_call in
//     _fwd_qkv_impl): the decoder's unmasked attention (mode NONE);
//   backward
//   * ops/pallas_attn.py _bwd_kernel_packed_qkv (pallas_call in
//     _packed_qkv_bwd): one dqkv of the packed form;
//   * ops/pallas_attn.py _bwd_kernel / _bwd_kernel_tiled (pallas_call in
//     _bwd): dq, dk, dv of the [B*H, N, dh] form, any N here;
//   * ops/pallas_small_attn.py _bwd_kernel_qkv (pallas_call in
//     _bwd_qkv_rule): the decoder's unmasked backward (mode NONE).
//
// What bounds it on an H100: at the shapes of the model (N = 256..1024,
// dh 32 or 64) the work is the products per (query tile, key tile) on the
// tensor cores -- two in the forward, five in the backward -- plus the
// softmax on the CUDA cores; the bytes are only q/k/v/out and their
// gradients (a few to a few tens of MB), so the kernels are bound by issue
// and latency, not by HBM. The [N, N] scores, the mask and the
// probabilities never leave the SM: they live in shared memory one 64 x 64
// tile at a time, which is what the Pallas kernels kept in VMEM.
//
// Forward design: one block per (64-row query tile, head, batch row), 4
// warps, each warp owning 16 query rows. Per key tile of 64: Q.K^T with bf16
// wmma fragments and f32 accumulators into shared memory, scale in f32, mask
// (finite NEG_INF = -0.7 * FLT_MAX, as pallas_attn.py:37), online softmax in
// f32 (running max m, running sum l, output rescaled by exp(m_old - m_new)),
// P cast to bf16 and P.V accumulated in f32 in shared memory. The output is
// divided by l at the end, and the row log-sum-exp m + log(l) is written
// when the caller asks for it (training; serving passes a null pointer).
// Keys past N (the ragged edge) get probability 0. A query row whose first
// key tiles are all masked starts from m = NEG_INF with exp(0) = 1 weights;
// the first real key makes the correction factor exp(NEG_INF - m_new) = 0,
// which clears them. Self-attention rows are never empty (a query always
// matches itself; a PAD query matches PAD keys). q, k and v are read as
// strided column slices of the fused slab, 16 bytes per thread per load.
//
// Backward design: no atomics, two kernels. The probabilities are recomputed
// tile by tile as P = exp(s * scale (masked) - lse), with the forward's lse.
//   * dq kernel, one block per (query tile, head, batch row): computes
//     D = rowsum(dO * O) in f32 for its rows (pallas_attn.py:552) and stores
//     it for the second kernel; then per key tile S = Q K^T, dP = dO V^T,
//     dS = P (dP - D) cast to bf16, dQ += dS K, kept in wmma accumulators;
//     dQ * scale is written at the end.
//   * dk/dv kernel, one block per (key tile, head, batch row), launched
//     after it on the same stream: per query tile S^T = K Q^T and
//     dP^T = V dO^T, P^T cast to bf16, dS^T = P^T (dP^T - D) cast to bf16,
//     dV += P^T dO and dK += dS^T Q in wmma accumulators; dK * scale and dV
//     are written at the end.
// Each block writes straight into its strided column slice of the one
// [B, N, 3I] dqkv. Simple and correct first: no TMA, no wgmma, no
// pipelining of the next tile.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <float.h>
#include <math_constants.h>
#include <mma.h>
#include <stdint.h>

using namespace nvcuda;
using bf16 = __nv_bfloat16;

namespace {

constexpr int BQ = 64;  // query rows per block
constexpr int BK = 64;  // keys per tile
constexpr int WARPS = 4;
constexpr int THREADS = WARPS * 32;
constexpr int PAD_TYPE = 255;
constexpr float NEG_INF = -0.7f * FLT_MAX;

enum { MODE_ZORRO = 0, MODE_NONE = 1 };

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

// Copies rows [r0, r0 + 64) of a dh-wide column slice into shared memory,
// 8 bf16 (16 bytes) per thread per step; rows at or past n become zeros.
template <int DH>
__device__ __forceinline__ void load_tile(bf16* dst, const bf16* src, int r0, int n,
                                          long long rstride) {
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

template <int DH, int MODE>
__global__ void __launch_bounds__(THREADS)
zorro_attention_kernel(const bf16* __restrict__ qkv, const int32_t* __restrict__ types,
                       bf16* __restrict__ out, float* __restrict__ lse, int n, int inner,
                       long long qkv_bstride,
                       long long qkv_rstride, long long out_bstride, long long out_rstride,
                       long long types_bstride, float scale, int fusion_type) {
  using L = Layout<DH>;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* sq = reinterpret_cast<bf16*>(smem);
  bf16* sk = reinterpret_cast<bf16*>(smem + L::Q);
  bf16* sv = reinterpret_cast<bf16*>(smem + L::Q + L::K);
  float* ss = reinterpret_cast<float*>(smem + L::Q + 2 * L::K);
  bf16* sp = reinterpret_cast<bf16*>(smem + L::Q + 2 * L::K + L::S);
  float* so = reinterpret_cast<float*>(smem + L::Q + 2 * L::K + L::S + L::P);
  float* m_row = reinterpret_cast<float*>(smem + L::Q + 2 * L::K + L::S + L::P + L::O);
  float* l_row = m_row + BQ;
  float* c_row = l_row + BQ;
  int* tq = reinterpret_cast<int*>(c_row + BQ);
  int* tk = tq + BQ;

  const int q0 = blockIdx.x * BQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int row0 = warp * 16;  // this warp's first query row in the tile

  const bf16* base = qkv + (long long)b * qkv_bstride;
  const bf16* qg = base + h * DH;
  const bf16* kg = base + inner + h * DH;
  const bf16* vg = base + 2 * inner + h * DH;
  const int32_t* tg = types + (long long)b * types_bstride;

  load_tile<DH>(sq, qg, q0, n, qkv_rstride);
  for (int i = threadIdx.x; i < BQ; i += THREADS)
    tq[i] = (MODE == MODE_ZORRO && q0 + i < n) ? tg[q0 + i] : PAD_TYPE;
  for (int i = lane; i < 16 * DH; i += 32) so[(row0 + i / DH) * L::LDO + i % DH] = 0.0f;
  if (lane < 16) {
    m_row[row0 + lane] = -CUDART_INF_F;  // no key seen yet
    l_row[row0 + lane] = 0.0f;
  }

  for (int k0 = 0; k0 < n; k0 += BK) {
    __syncthreads();  // every warp is done with the previous k/v tile
    load_tile<DH>(sk, kg, k0, n, qkv_rstride);
    load_tile<DH>(sv, vg, k0, n, qkv_rstride);
    for (int i = threadIdx.x; i < BK; i += THREADS)
      tk[i] = (MODE == MODE_ZORRO && k0 + i < n) ? tg[k0 + i] : PAD_TYPE;
    __syncthreads();

    // scores of this warp's 16 rows against the 64 keys: 4 fragments
    for (int j = 0; j < BK / 16; ++j) {
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
      wmma::fill_fragment(acc, 0.0f);
      for (int kk = 0; kk < DH / 16; ++kk) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a;
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> bt;
        wmma::load_matrix_sync(a, sq + row0 * L::LDH + kk * 16, L::LDH);
        wmma::load_matrix_sync(bt, sk + (j * 16) * L::LDH + kk * 16, L::LDH);
        wmma::mma_sync(acc, a, bt, acc);
      }
      wmma::store_matrix_sync(ss + row0 * L::LDS + j * 16, acc, L::LDS, wmma::mem_row_major);
    }
    __syncwarp();

    // online softmax, one row at a time; lane owns keys lane and lane + 32
    for (int rr = 0; rr < 16; ++rr) {
      const int r = row0 + rr;
      const int t_q = tq[r];
      float s[2];
      bool in_range[2];
      for (int u = 0; u < 2; ++u) {
        const int c = lane + 32 * u;
        in_range[u] = k0 + c < n;
        float v = ss[r * L::LDS + c] * scale;  // scale first, then mask
        if (MODE == MODE_ZORRO) {
          const int t_k = tk[c];
          const bool ok = (t_q == t_k) || (t_q == fusion_type && t_k != PAD_TYPE);
          v = ok ? v : NEG_INF;
        }
        s[u] = in_range[u] ? v : -CUDART_INF_F;
      }
      const float m_old = m_row[r];
      const float m_new = fmaxf(m_old, warp_max(fmaxf(s[0], s[1])));
      float p_sum = 0.0f;
      for (int u = 0; u < 2; ++u) {
        const float p = in_range[u] ? expf(s[u] - m_new) : 0.0f;
        p_sum += p;
        sp[r * L::LDP + lane + 32 * u] = __float2bfloat16(p);
      }
      p_sum = warp_sum(p_sum);
      if (lane == 0) {
        const float corr = expf(m_old - m_new);  // 0 on the first tile
        l_row[r] = l_row[r] * corr + p_sum;
        m_row[r] = m_new;
        c_row[r] = corr;
      }
    }
    __syncwarp();

    for (int i = lane; i < 16 * DH; i += 32) {
      const int r = row0 + i / DH;
      so[r * L::LDO + i % DH] *= c_row[r];
    }
    __syncwarp();

    // O[16 rows, DH] += P[16 rows, 64] . V[64, DH]
    for (int c = 0; c < DH / 16; ++c) {
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
      wmma::load_matrix_sync(acc, so + row0 * L::LDO + c * 16, L::LDO, wmma::mem_row_major);
      for (int kk = 0; kk < BK / 16; ++kk) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a;
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> bv;
        wmma::load_matrix_sync(a, sp + row0 * L::LDP + kk * 16, L::LDP);
        wmma::load_matrix_sync(bv, sv + (kk * 16) * L::LDH + c * 16, L::LDH);
        wmma::mma_sync(acc, a, bv, acc);
      }
      wmma::store_matrix_sync(so + row0 * L::LDO + c * 16, acc, L::LDO, wmma::mem_row_major);
    }
    __syncwarp();
  }

  bf16* og = out + (long long)b * out_bstride + h * DH;
  for (int i = lane; i < 16 * DH; i += 32) {
    const int r = row0 + i / DH;
    const int c = i % DH;
    if (q0 + r < n) og[(long long)(q0 + r) * out_rstride + c] = __float2bfloat16(so[r * L::LDO + c] / l_row[r]);
  }
  if (lse != nullptr && lane < 16 && q0 + row0 + lane < n)
    lse[((long long)b * gridDim.y + h) * n + q0 + row0 + lane] = m_row[row0 + lane] + logf(l_row[row0 + lane]);
}

template <int DH, int MODE>
cudaError_t launch(const bf16* qkv, const int32_t* types, bf16* out, float* lse, int batch, int n,
                   int heads,
                   long long qkv_bstride, long long qkv_rstride, long long out_bstride,
                   long long out_rstride, long long types_bstride, float scale, int fusion_type,
                   cudaStream_t stream) {
  auto kernel = zorro_attention_kernel<DH, MODE>;
  const size_t bytes = Layout<DH>::BYTES;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return err;
  dim3 grid((n + BQ - 1) / BQ, heads, batch);
  kernel<<<grid, THREADS, bytes, stream>>>(qkv, types, out, lse, n, heads * DH, qkv_bstride, qkv_rstride,
                                           out_bstride, out_rstride, types_bstride, scale, fusion_type);
  return cudaGetLastError();
}

template <int MODE>
cudaError_t dispatch(int dh, const bf16* qkv, const int32_t* types, bf16* out, float* lse, int batch, int n,
                     int heads, long long qkv_bstride, long long qkv_rstride, long long out_bstride,
                     long long out_rstride, long long types_bstride, float scale, int fusion_type,
                     cudaStream_t stream) {
  switch (dh) {
    case 32:
      return launch<32, MODE>(qkv, types, out, lse, batch, n, heads, qkv_bstride, qkv_rstride, out_bstride,
                              out_rstride, types_bstride, scale, fusion_type, stream);
    case 64:
      return launch<64, MODE>(qkv, types, out, lse, batch, n, heads, qkv_bstride, qkv_rstride, out_bstride,
                              out_rstride, types_bstride, scale, fusion_type, stream);
    case 128:
      return launch<128, MODE>(qkv, types, out, lse, batch, n, heads, qkv_bstride, qkv_rstride, out_bstride,
                               out_rstride, types_bstride, scale, fusion_type, stream);
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

// Block (query tile, head, batch row): D = rowsum(dO * O) for its rows (also
// stored to delta), then dQ over all key tiles.
template <int DH, int MODE>
__global__ void __launch_bounds__(THREADS)
zorro_attention_dq_kernel(const bf16* __restrict__ qkv, const int32_t* __restrict__ types,
                          const bf16* __restrict__ o, const float* __restrict__ lse,
                          const bf16* __restrict__ dout, bf16* __restrict__ dqkv, float* __restrict__ delta,
                          int n, int inner, long long types_bstride, float scale, int fusion_type) {
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
  const long long rstride = 3LL * inner;
  const bf16* base = qkv + (long long)b * n * rstride;
  const bf16* kg = base + inner + h * DH;
  const bf16* vg = base + 2 * inner + h * DH;
  const bf16* og = o + (long long)b * n * inner + h * DH;
  const bf16* dog = dout + (long long)b * n * inner + h * DH;
  const int32_t* tg = types + (long long)b * types_bstride;
  const long long lse_row = ((long long)b * gridDim.y + h) * n;

  load_tile<DH>(sq, base + h * DH, q0, n, rstride);
  load_tile<DH>(sdo, dog, q0, n, inner);
  for (int i = threadIdx.x; i < BQ; i += THREADS)
    tq[i] = (MODE == MODE_ZORRO && q0 + i < n) ? tg[q0 + i] : PAD_TYPE;
  for (int rr = 0; rr < 16; ++rr) {
    const int q = q0 + row0 + rr;
    float part = 0.0f;
    if (q < n)
      for (int c = lane; c < DH; c += 32)
        part += __bfloat162float(dog[(long long)q * inner + c]) * __bfloat162float(og[(long long)q * inner + c]);
    part = warp_sum(part);
    if (lane == 0) {
      s_d[row0 + rr] = q < n ? part : 0.0f;
      s_lse[row0 + rr] = q < n ? lse[lse_row + q] : 0.0f;
      if (q < n) delta[lse_row + q] = part;
    }
  }

  Acc acc[DH / 16];
#pragma unroll
  for (int c = 0; c < DH / 16; ++c) wmma::fill_fragment(acc[c], 0.0f);

  for (int k0 = 0; k0 < n; k0 += BK) {
    __syncthreads();  // every warp is done with the previous k/v tile
    load_tile<DH>(sk, kg, k0, n, rstride);
    load_tile<DH>(sv, vg, k0, n, rstride);
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
  store_rows<DH>(ss + row0 * L::LDA, acc, dqkv + (long long)b * n * rstride + h * DH, q0 + row0, n, rstride,
                 scale, lane);
}

// Block (key tile, head, batch row): dK and dV over all query tiles, with
// the D written by the dq kernel.
template <int DH, int MODE>
__global__ void __launch_bounds__(THREADS)
zorro_attention_dkdv_kernel(const bf16* __restrict__ qkv, const int32_t* __restrict__ types,
                            const float* __restrict__ lse, const bf16* __restrict__ dout,
                            const float* __restrict__ delta, bf16* __restrict__ dqkv, int n, int inner,
                            long long types_bstride, float scale, int fusion_type) {
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
  const long long rstride = 3LL * inner;
  const bf16* base = qkv + (long long)b * n * rstride;
  const bf16* qg = base + h * DH;
  const bf16* dog = dout + (long long)b * n * inner + h * DH;
  const int32_t* tg = types + (long long)b * types_bstride;
  const long long lse_row = ((long long)b * gridDim.y + h) * n;

  load_tile<DH>(sk, base + inner + h * DH, k0, n, rstride);
  load_tile<DH>(sv, base + 2 * inner + h * DH, k0, n, rstride);
  for (int i = threadIdx.x; i < BK; i += THREADS)
    tk[i] = (MODE == MODE_ZORRO && k0 + i < n) ? tg[k0 + i] : PAD_TYPE;

  Acc dk[DH / 16], dv[DH / 16];
#pragma unroll
  for (int c = 0; c < DH / 16; ++c) {
    wmma::fill_fragment(dk[c], 0.0f);
    wmma::fill_fragment(dv[c], 0.0f);
  }

  for (int q0 = 0; q0 < n; q0 += BQ) {
    __syncthreads();  // every warp is done with the previous q/dO tile
    load_tile<DH>(sq, qg, q0, n, rstride);
    load_tile<DH>(sdo, dog, q0, n, inner);
    for (int i = threadIdx.x; i < BQ; i += THREADS) {
      const bool in = q0 + i < n;
      tq[i] = (MODE == MODE_ZORRO && in) ? tg[q0 + i] : PAD_TYPE;
      s_lse[i] = in ? lse[lse_row + q0 + i] : 0.0f;
      s_d[i] = in ? delta[lse_row + q0 + i] : 0.0f;
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
  bf16* dst = dqkv + (long long)b * n * rstride;
  store_rows<DH>(ss + row0 * L::LDA, dk, dst + inner + h * DH, k0 + row0, n, rstride, scale, lane);
  store_rows<DH>(ss + row0 * L::LDA, dv, dst + 2 * inner + h * DH, k0 + row0, n, rstride, 1.0f, lane);
}

template <int DH, int MODE>
cudaError_t launch_bwd(const bf16* qkv, const int32_t* types, const bf16* o, const float* lse,
                       const bf16* dout, bf16* dqkv, float* delta, int batch, int n, int heads,
                       long long types_bstride, float scale, int fusion_type, cudaStream_t stream) {
  auto dq_kernel = zorro_attention_dq_kernel<DH, MODE>;
  auto dkdv_kernel = zorro_attention_dkdv_kernel<DH, MODE>;
  const size_t bytes = BwdLayout<DH>::BYTES;
  cudaError_t err = cudaFuncSetAttribute(dq_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(dkdv_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return err;
  dim3 grid((n + BQ - 1) / BQ, heads, batch);
  dq_kernel<<<grid, THREADS, bytes, stream>>>(qkv, types, o, lse, dout, dqkv, delta, n, heads * DH,
                                              types_bstride, scale, fusion_type);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  dkdv_kernel<<<grid, THREADS, bytes, stream>>>(qkv, types, lse, dout, delta, dqkv, n, heads * DH,
                                                types_bstride, scale, fusion_type);
  return cudaGetLastError();
}

template <int MODE>
cudaError_t dispatch_bwd(int dh, const bf16* qkv, const int32_t* types, const bf16* o, const float* lse,
                         const bf16* dout, bf16* dqkv, float* delta, int batch, int n, int heads,
                         long long types_bstride, float scale, int fusion_type, cudaStream_t stream) {
  switch (dh) {
    case 32:
      return launch_bwd<32, MODE>(qkv, types, o, lse, dout, dqkv, delta, batch, n, heads, types_bstride,
                                  scale, fusion_type, stream);
    case 64:
      return launch_bwd<64, MODE>(qkv, types, o, lse, dout, dqkv, delta, batch, n, heads, types_bstride,
                                  scale, fusion_type, stream);
    case 128:
      return launch_bwd<128, MODE>(qkv, types, o, lse, dout, dqkv, delta, batch, n, heads, types_bstride,
                                   scale, fusion_type, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// masked != 0: zorro mask from types (int32 [B, N]); masked == 0: no mask,
// types unused. lse: f32 [B, H, N] row log-sum-exp, or null. Returns the
// launch's cudaError_t (0 = launched).
extern "C" int zorro_attention_qkv_bf16(const void* qkv, const void* types, void* out, void* lse, int batch,
                                        int n, int heads, int dh, long long qkv_bstride,
                                        long long qkv_rstride, long long out_bstride, long long out_rstride,
                                        long long types_bstride, float scale, int fusion_type, int masked,
                                        void* stream) {
  const bf16* q = static_cast<const bf16*>(qkv);
  const int32_t* t = static_cast<const int32_t*>(types);
  bf16* o = static_cast<bf16*>(out);
  float* l = static_cast<float*>(lse);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (masked)
    return (int)dispatch<MODE_ZORRO>(dh, q, t, o, l, batch, n, heads, qkv_bstride, qkv_rstride, out_bstride,
                                     out_rstride, types_bstride, scale, fusion_type, s);
  return (int)dispatch<MODE_NONE>(dh, q, t, o, l, batch, n, heads, qkv_bstride, qkv_rstride, out_bstride,
                                  out_rstride, types_bstride, scale, fusion_type, s);
}

// Backward: qkv [B, N, 3I] and dqkv [B, N, 3I], o and dout [B, N, I], all
// contiguous bf16; lse f32 [B, H, N] from the forward; delta f32 [B, H, N]
// scratch. Two launches on the stream; returns the first error.
extern "C" int zorro_attention_qkv_bwd_bf16(const void* qkv, const void* types, const void* o,
                                            const void* lse, const void* dout, void* dqkv, void* delta,
                                            int batch, int n, int heads, int dh, long long types_bstride,
                                            float scale, int fusion_type, int masked, void* stream) {
  const bf16* q = static_cast<const bf16*>(qkv);
  const int32_t* t = static_cast<const int32_t*>(types);
  const bf16* op = static_cast<const bf16*>(o);
  const float* l = static_cast<const float*>(lse);
  const bf16* d = static_cast<const bf16*>(dout);
  bf16* dq = static_cast<bf16*>(dqkv);
  float* dl = static_cast<float*>(delta);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (masked)
    return (int)dispatch_bwd<MODE_ZORRO>(dh, q, t, op, l, d, dq, dl, batch, n, heads, types_bstride, scale,
                                         fusion_type, s);
  return (int)dispatch_bwd<MODE_NONE>(dh, q, t, op, l, d, dq, dl, batch, n, heads, types_bstride, scale,
                                      fusion_type, s);
}
