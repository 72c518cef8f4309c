// Weight gradients summed over the rows of a batch, shared by
// fused_ffn_bwd.cu (K2b) and fused_block_attn.cu (K6b): a tiled product
// C = A^T . B over M rows on wgmma, the rows split into as many ranges as
// fill the card, each range's f32 partial tile written out;
// then a reduction in which each output element sums its partials in a
// fixed order and is cast to bf16 once. No atomics, so the result does not
// depend on the schedule.
//
// Both operands are row-major [M, p] and [M, q]: along the reduction (the
// rows) neither is contiguous, so the block's tiles are copied as they lie
// (cp.async, 16 bytes a copy, in the 128-byte swizzle) and wgmma reads both
// through the descriptor's transpose bit (A and B MN-major), as K1b's dk/dv
// kernel reads dO and Q. A block is two warpgroups: 128 output rows (64
// each) by 64 NB output columns, 64 rows of the reduction a stage, two
// stages in flight.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>

#include "hopper.cuh"

namespace wgrad {

using namespace hopper;
using bf16 = __nv_bfloat16;

constexpr int KR = 64;    // rows of the reduction a stage
constexpr int TP = 128;   // output rows a block: two warpgroups of 64
constexpr int THREADS = 256;
constexpr int MAX_NB = 4;  // output columns a block: at most 4 blocks of 64

// One weight gradient C [p, q] = sum over rows of a[row, p] * b[row, q],
// a [M, p] and b [M, q] row-major bf16 (p, q multiples of 8); each row
// range's f32 partial goes to part[range][p][q], or with `transposed` to
// part[range][q][p] (C^T: the gradient of a weight laid out [q, p]).
struct WGrad {
  const bf16* a;
  const bf16* b;
  float* part;
  int p;
  int q;
  int transposed = 0;
};

// Shared memory: per stage the A tile (KR rows x TP columns) and the B tile
// (KR rows x 64 NB columns)
template <int NB>
struct GemmSmem {
  static constexpr uint32_t A = KR * TP * 2, B = KR * 64 * NB * 2, STAGE = A + B;
  static constexpr size_t BYTES = 2 * STAGE + 1024;  // + the alignment slack
};

// grid (output tiles, row ranges, 2 problems); block (128 x 64 NB) output
// tile of problem blockIdx.z over rows [range start, range end)
template <int NB>
__global__ void __launch_bounds__(THREADS)
wgrad_kernel(WGrad g0, WGrad g1, int m, int rows_per_split) {
  using L = GemmSmem<NB>;
  const WGrad g = blockIdx.z == 0 ? g0 : g1;
  const int tiles_q = (g.q + 64 * NB - 1) / (64 * NB);
  if ((int)blockIdx.x >= ((g.p + TP - 1) / TP) * tiles_q) return;
  const int p0 = (blockIdx.x / tiles_q) * TP;
  const int q0 = (blockIdx.x % tiles_q) * 64 * NB;
  const int m_begin = blockIdx.y * rows_per_split;
  const int m_end = min(m, m_begin + rows_per_split);
  extern __shared__ unsigned char smem_raw[];
  unsigned char* sm;
  const uint32_t sa = aligned_smem(smem_raw, &sm);
  const int wg = threadIdx.x / 128;
  const int lane = threadIdx.x % 32;
  const int t4 = lane & 3;
  const int row = ((threadIdx.x % 128) / 32) * 16 + lane / 4;  // within the warpgroup's 64

  // rows [k0, k0 + KR) of both operands into a stage; past m_end, p or q:
  // zeros
  auto load = [&](int k0, int stage) {
    const uint32_t at = sa + stage * L::STAGE, bt = at + L::A;
#pragma unroll
    for (int it = 0; it < KR * (TP / 8) / THREADS; ++it) {
      const int i = it * THREADS + threadIdx.x;
      const int r = i / (TP / 8), c = i % (TP / 8);
      const bool inside = k0 + r < m_end && p0 + 8 * c < g.p;
      cp_async16(at + Sw128::offset(r, c, KR), g.a + (long long)(inside ? k0 + r : 0) * g.p + (inside ? p0 + 8 * c : 0),
                 inside);
    }
#pragma unroll
    for (int it = 0; it < KR * 8 * NB / THREADS; ++it) {
      const int i = it * THREADS + threadIdx.x;
      const int r = i / (8 * NB), c = i % (8 * NB);
      const bool inside = k0 + r < m_end && q0 + 8 * c < g.q;
      cp_async16(bt + Sw128::offset(r, c, KR), g.b + (long long)(inside ? k0 + r : 0) * g.q + (inside ? q0 + 8 * c : 0),
                 inside);
    }
  };

  float acc[NB][32];
#pragma unroll
  for (int cb = 0; cb < NB; ++cb)
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[cb][i] = 0.0f;

  if (m_begin < m_end) {
    load(m_begin, 0);
    cp_async_commit();
  }
  for (int k0 = m_begin, stage = 0; k0 < m_end; k0 += KR, stage ^= 1) {
    cp_async_wait_all();
    fence_async_smem();
    __syncthreads();  // stage k0 has landed; everyone is done with the other stage
    if (k0 + KR < m_end) {
      load(k0 + KR, stage ^ 1);
      cp_async_commit();
    }
    const uint32_t at = sa + stage * L::STAGE, bt = at + L::A;
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < KR / 16; ++kk) {
      const uint64_t da = Sw128::mnmajor(at + wg * (KR * 128), KR, kk);
#pragma unroll
      for (int cb = 0; cb < NB; ++cb) wgmma_ss_n64<1, 1>(acc[cb], da, Sw128::mnmajor(bt + cb * (KR * 128), KR, kk));
    }
    wgmma_commit();
    wgmma_wait_all();
#pragma unroll
    for (int cb = 0; cb < NB; ++cb) keep(acc[cb]);
  }

  float* out = g.part + (long long)blockIdx.y * g.p * g.q;
#pragma unroll
  for (int hi = 0; hi < 2; ++hi) {
    const int pr = p0 + wg * 64 + row + 8 * hi;
    if (pr >= g.p) continue;
#pragma unroll
    for (int cb = 0; cb < NB; ++cb)
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int qc = q0 + cb * 64 + 8 * j + 2 * t4;
        if (qc >= g.q) continue;  // q is a multiple of 8: qc + 1 is inside too
        const float v0 = acc[cb][4 * j + 2 * hi], v1 = acc[cb][4 * j + 2 * hi + 1];
        if (g.transposed) {
          out[(long long)qc * g.p + pr] = v0;
          out[(long long)(qc + 1) * g.p + pr] = v1;
        } else {
          *reinterpret_cast<float2*>(out + (long long)pr * g.q + qc) = make_float2(v0, v1);
        }
      }
  }
}

constexpr int REDUCE_THREADS = 256;

// The first blocks: one thread per element of the two weight gradients
// (the sum of their row-range partials); the rest: one warp per element of
// the vector gradients (v0 entries to vout0, v1 to vout1), lane l summing
// the row blocks' partials l, l + 32, ... in order, then the lanes' sums in
// a fixed tree. Each sum is cast to bf16 once.
__global__ void __launch_bounds__(REDUCE_THREADS)
wgrad_reduce_kernel(const float* __restrict__ part0, bf16* __restrict__ out0, long long n0,
                    const float* __restrict__ part1, bf16* __restrict__ out1, long long n1, int splits,
                    int matrix_blocks, const float* __restrict__ vec_part, int blocks, int v0,
                    bf16* __restrict__ vout0, int v1, bf16* __restrict__ vout1) {
  if ((int)blockIdx.x < matrix_blocks) {
    long long i = (long long)blockIdx.x * REDUCE_THREADS + threadIdx.x;
    if (i < n0) {
      float s = 0.0f;
      for (int k = 0; k < splits; ++k) s += part0[k * n0 + i];
      out0[i] = __float2bfloat16(s);
      return;
    }
    i -= n0;
    if (i < n1) {
      float s = 0.0f;
      for (int k = 0; k < splits; ++k) s += part1[k * n1 + i];
      out1[i] = __float2bfloat16(s);
    }
    return;
  }
  const int i = ((int)blockIdx.x - matrix_blocks) * (REDUCE_THREADS / 32) + (int)threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int vw = v0 + v1;
  if (i >= vw) return;
  float s = 0.0f;
  for (int blk = lane; blk < blocks; blk += 32) s += vec_part[(long long)blk * vw + i];
  for (int o = 16; o > 0; o >>= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
  if (lane == 0) {
    if (i < v0)
      vout0[i] = __float2bfloat16(s);
    else
      vout1[i - v0] = __float2bfloat16(s);
  }
}

// The product launch for NB column blocks, `tiles` blocks a problem (the
// larger count); the attribute is set once per device (a static of this
// static function: one flag per library).
template <int NB>
static cudaError_t launch_gemm(const WGrad& g0, const WGrad& g1, int m, int splits, int rows_per_split, int tiles,
                               cudaStream_t stream) {
  static std::atomic<unsigned> ready{0};
  auto kernel = wgrad_kernel<NB>;
  const size_t bytes = GemmSmem<NB>::BYTES;
  cudaError_t err = allow_smem((const void*)kernel, bytes, ready);
  if (err != cudaSuccess) return err;
  kernel<<<dim3(tiles, splits, 2), THREADS, bytes, stream>>>(g0, g1, m, rows_per_split);
  return cudaGetLastError();
}

// The products' tiling: output tiles of 128 rows by 64 nb columns (nb from
// the wider q), t0 and t1 of them for the two problems
static void tiling(int p0, int q0, int p1, int q1, int* nb, int* t0, int* t1) {
  const int q = q0 > q1 ? q0 : q1;
  *nb = q >= 64 * MAX_NB ? MAX_NB : (q + 63) / 64;
  const int tq = 64 * *nb;
  *t0 = ((p0 + TP - 1) / TP) * ((q0 + tq - 1) / tq);
  *t1 = ((p1 + TP - 1) / TP) * ((q1 + tq - 1) / tq);
}

// The row ranges of the two products C0 [p0, q0] and C1 [p1, q1] over m
// rows: as many as fill the card with one block an SM (the output tiles
// times the ranges), at least 1024 rows a range and at most 16 ranges. It
// depends on the shapes and the card only, so two calls are bitwise equal;
// the caller sizes the partials by it and passes it to launch.
static int splits_for(int p0, int q0, int p1, int q1, int m) {
  int nb, t0, t1;
  tiling(p0, q0, p1, q1, &nb, &t0, &t1);
  int cap = (m + 1023) / 1024;
  cap = cap > 16 ? 16 : cap;
  const int splits = sm_count() / (t0 + t1);
  return splits < 1 ? 1 : splits > cap ? cap : splits;
}

// The two launches: both products over M rows in `splits` row ranges
// (splits_for), then the reduction into out0 / out1 and the vectors (the
// row blocks' partials vec [blocks, v0 + v1] into vout0 / vout1).
static cudaError_t launch(const WGrad& g0, bf16* out0, const WGrad& g1, bf16* out1, int m, int splits,
                          const float* vec, int blocks, int v0, bf16* vout0, int v1, bf16* vout1,
                          cudaStream_t stream) {
  if (g0.p % 8 || g0.q % 8 || g1.p % 8 || g1.q % 8 || splits < 1) return cudaErrorInvalidValue;
  int nb, t0, t1;
  tiling(g0.p, g0.q, g1.p, g1.q, &nb, &t0, &t1);
  const int per = (m + splits - 1) / splits;
  const int rows_per_split = (per + KR - 1) / KR * KR;
  const int tiles = t0 > t1 ? t0 : t1;
  cudaError_t err;
  switch (nb) {
    case 1: err = launch_gemm<1>(g0, g1, m, splits, rows_per_split, tiles, stream); break;
    case 2: err = launch_gemm<2>(g0, g1, m, splits, rows_per_split, tiles, stream); break;
    case 3: err = launch_gemm<3>(g0, g1, m, splits, rows_per_split, tiles, stream); break;
    default: err = launch_gemm<4>(g0, g1, m, splits, rows_per_split, tiles, stream); break;
  }
  if (err != cudaSuccess) return err;

  const long long n0 = (long long)g0.p * g0.q, n1 = (long long)g1.p * g1.q;
  const int matrix_blocks = (int)((n0 + n1 + REDUCE_THREADS - 1) / REDUCE_THREADS);
  const int vector_blocks = (v0 + v1 + REDUCE_THREADS / 32 - 1) / (REDUCE_THREADS / 32);
  wgrad_reduce_kernel<<<matrix_blocks + vector_blocks, REDUCE_THREADS, 0, stream>>>(
      g0.part, out0, n0, g1.part, out1, n1, splits, matrix_blocks, vec, blocks, v0, vout0, v1, vout1);
  return cudaGetLastError();
}

}  // namespace wgrad
