// Weight gradients summed over the rows of a batch, shared by
// fused_ffn_bwd.cu (K2b) and fused_block_attn.cu (K6b): a tiled product
// C = A^T . B over M rows with wmma bf16 fragments and f32 accumulators, the
// rows split into a few ranges so that enough blocks fill the card, each
// range's f32 partial tile written out; then a reduction in which each
// output element sums its partials in a fixed order and is cast to bf16
// once. No atomics, so the result does not depend on the schedule.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

namespace wgrad {

using namespace nvcuda;
using bf16 = __nv_bfloat16;

constexpr int TILE = 64;  // output tile
constexpr int KM = 32;    // rows per step of the loop over M
constexpr int GEMM_WARPS = 4;
constexpr int LDT = TILE + 8;  // bf16 pitch of the operand tiles

// One weight gradient C [p, q] = sum over rows of a[row, p] * b[row, q],
// a [M, p] and b [M, q] row-major bf16 (p, q multiples of 8); each row
// range's f32 partial goes to part[range][p][q].
struct WGrad {
  const bf16* a;
  const bf16* b;
  float* part;
  int p;
  int q;
};

// grid (output tiles, row ranges, 2 problems), GEMM_WARPS warps; warp w owns
// rows [16w, 16w + 16) of the 64 x 64 output tile.
__global__ void __launch_bounds__(GEMM_WARPS * 32)
wgrad_kernel(WGrad g0, WGrad g1, int m, int rows_per_split) {
  using Acc = wmma::fragment<wmma::accumulator, 16, 16, 16, float>;
  const WGrad g = blockIdx.z == 0 ? g0 : g1;
  const int tiles_q = (g.q + TILE - 1) / TILE;
  if ((int)blockIdx.x >= ((g.p + TILE - 1) / TILE) * tiles_q) return;
  const int p0 = (blockIdx.x / tiles_q) * TILE;
  const int q0 = (blockIdx.x % tiles_q) * TILE;
  const int m_begin = blockIdx.y * rows_per_split;
  const int m_end = min(m, m_begin + rows_per_split);
  __shared__ __align__(128) bf16 sa[KM * LDT];
  __shared__ __align__(128) bf16 sb[KM * LDT];
  const int warp = threadIdx.x / 32;

  Acc acc[TILE / 16];
#pragma unroll
  for (int j = 0; j < TILE / 16; ++j) wmma::fill_fragment(acc[j], 0.0f);

  for (int mk = m_begin; mk < m_end; mk += KM) {
    __syncthreads();  // every warp is done with the previous operand tiles
    for (int i = threadIdx.x; i < KM * TILE / 8; i += blockDim.x) {
      const int r = i / (TILE / 8);
      const int c = (i % (TILE / 8)) * 8;
      uint4 va = make_uint4(0u, 0u, 0u, 0u), vb = va;
      if (mk + r < m_end) {
        if (p0 + c < g.p) va = *reinterpret_cast<const uint4*>(g.a + (long long)(mk + r) * g.p + p0 + c);
        if (q0 + c < g.q) vb = *reinterpret_cast<const uint4*>(g.b + (long long)(mk + r) * g.q + q0 + c);
      }
      *reinterpret_cast<uint4*>(sa + r * LDT + c) = va;
      *reinterpret_cast<uint4*>(sb + r * LDT + c) = vb;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < KM; kk += 16) {
      // A^T: element (i, k) = sa[k][16 w + i], a column-major load
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::col_major> fa;
      wmma::load_matrix_sync(fa, sa + kk * LDT + warp * 16, LDT);
#pragma unroll
      for (int j = 0; j < TILE / 16; ++j) {
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> fb;
        wmma::load_matrix_sync(fb, sb + kk * LDT + j * 16, LDT);
        wmma::mma_sync(acc[j], fa, fb, acc[j]);
      }
    }
  }
  const int pr = p0 + warp * 16;
  if (pr >= g.p) return;
  float* out = g.part + (long long)blockIdx.y * g.p * g.q;
#pragma unroll
  for (int j = 0; j < TILE / 16; ++j)
    if (q0 + j * 16 < g.q)
      wmma::store_matrix_sync(out + (long long)pr * g.q + q0 + j * 16, acc[j], g.q, wmma::mem_row_major);
}

// One thread per output element: the two weight gradients (sum of their
// row-range partials), then the vector gradients (sum of the row blocks'
// partials, v0 entries to vout0 and v1 to vout1), each cast to bf16.
__global__ void wgrad_reduce_kernel(const float* __restrict__ part0, bf16* __restrict__ out0, long long n0,
                                    const float* __restrict__ part1, bf16* __restrict__ out1, long long n1,
                                    int splits, const float* __restrict__ vec_part, int blocks, int v0,
                                    bf16* __restrict__ vout0, int v1, bf16* __restrict__ vout1) {
  long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
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
    return;
  }
  i -= n1;
  const int vw = v0 + v1;
  if (i < vw) {
    float s = 0.0f;
    for (int blk = 0; blk < blocks; ++blk) s += vec_part[(long long)blk * vw + i];
    if (i < v0)
      vout0[i] = __float2bfloat16(s);
    else
      vout1[i - v0] = __float2bfloat16(s);
  }
}

// The two launches: both products over M rows in `splits` row ranges, then
// the reduction into out0 / out1 and the vectors (the row blocks' partials
// vec [blocks, v0 + v1] into vout0 / vout1).
inline cudaError_t launch(const WGrad& g0, bf16* out0, const WGrad& g1, bf16* out1, int m, int splits,
                          const float* vec, int blocks, int v0, bf16* vout0, int v1, bf16* vout1,
                          cudaStream_t stream) {
  const int per = (m + splits - 1) / splits;
  const int rows_per_split = (per + KM - 1) / KM * KM;
  const int t0 = ((g0.p + TILE - 1) / TILE) * ((g0.q + TILE - 1) / TILE);
  const int t1 = ((g1.p + TILE - 1) / TILE) * ((g1.q + TILE - 1) / TILE);
  wgrad_kernel<<<dim3(t0 > t1 ? t0 : t1, splits, 2), GEMM_WARPS * 32, 0, stream>>>(g0, g1, m, rows_per_split);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  const long long n0 = (long long)g0.p * g0.q, n1 = (long long)g1.p * g1.q;
  const long long total = n0 + n1 + v0 + v1;
  wgrad_reduce_kernel<<<(unsigned)((total + 255) / 256), 256, 0, stream>>>(
      g0.part, out0, n0, g1.part, out1, n1, splits, vec, blocks, v0, vout0, v1, vout1);
  return cudaGetLastError();
}

}  // namespace wgrad
