// Full-f32 building blocks on the CUDA cores, shared by the f32 instances of
// K2 / K2b (ffn_tf32.cuh, ffn_tf32_wide.cuh) and K6 / K6b
// (fused_block_attn.cu), whose products run on the tensor cores in three
// TF32 parts: the bias-free LayerNorm and its backward a warp a row, column
// sums and the fixed-order reduction of partial sums. Every sum is f32 (no
// TF32: the TPU kernels and the plain versions keep f32's digits), and
// nothing is summed by atomics, so two runs are bitwise equal. What bounds
// them is device memory: each reads its rows once (the LayerNorm backward
// twice, from L1) and writes its outputs once.
#pragma once

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace simt_f32 {

constexpr float LN_EPS = 1e-5f;
constexpr int LN_ROWS = 64;  // rows a LayerNorm-backward block (a gain partial each)

// Column sums of x [m, n] (ld) over ranges of k_range rows: part[range][n]
__global__ void __launch_bounds__(256)
simt_f32_colsum_kernel(const float* __restrict__ x, long long ld, int m, int n, int k_range,
                       float* __restrict__ part) {
  const int j = blockIdx.x * 256 + threadIdx.x;
  if (j >= n) return;
  const int r0 = blockIdx.y * k_range, r1 = min(m, r0 + k_range);
  float s = 0.0f;
  for (int r = r0; r < r1; ++r) s += x[(long long)r * ld + j];
  part[(long long)blockIdx.y * n + j] = s;
}

// Sums of partials in a fixed order: segment s adds its `splits` partials
// of `count` elements (part[z count + e]) into out[e]
struct Segment {
  const float* part;
  int splits;
  long long count;
  float* out;
};

struct Segments {
  Segment s[4];
  int n;
};

__global__ void __launch_bounds__(256) simt_f32_reduce_kernel(Segments segs) {
  long long e = (long long)blockIdx.x * 256 + threadIdx.x;
  for (int i = 0; i < segs.n; ++i) {
    const Segment& g = segs.s[i];
    if (e < g.count) {
      float s = 0.0f;
      for (int z = 0; z < g.splits; ++z) s += g.part[z * g.count + e];
      g.out[e] = s;
      return;
    }
    e -= g.count;
  }
}

static cudaError_t reduce(const Segments& segs, cudaStream_t stream) {
  long long total = 0;
  for (int i = 0; i < segs.n; ++i) total += segs.s[i].count;
  simt_f32_reduce_kernel<<<(unsigned)((total + 255) / 256), 256, 0, stream>>>(segs);
  return cudaGetLastError();
}

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// A row's mean and 1 / sqrt(var + eps) (two passes, as the plain version)
__device__ __forceinline__ void row_stats(const float* x, int d, float& mean, float& rstd) {
  const int lane = threadIdx.x % 32;
  float s = 0.0f;
  for (int c = lane; c < d; c += 32) s += x[c];
  mean = warp_sum(s) / d;
  float v = 0.0f;
  for (int c = lane; c < d; c += 32) {
    const float t = x[c] - mean;
    v = fmaf(t, t, v);
  }
  rstd = rsqrtf(warp_sum(v) / d + LN_EPS);
}

// out = ((x - mean) rstd) g, a warp a row, 8 rows a block
__global__ void __launch_bounds__(256)
simt_f32_ln_fwd_kernel(const float* __restrict__ x, const float* __restrict__ g, float* __restrict__ out, int m,
                       int d) {
  const long long row = (long long)blockIdx.x * 8 + threadIdx.x / 32;
  if (row >= m) return;
  const float* xr = x + row * d;
  float mean, rstd;
  row_stats(xr, d, mean, rstd);
  for (int c = threadIdx.x % 32; c < d; c += 32) out[row * d + c] = (xr[c] - mean) * rstd * g[c];
}

static cudaError_t ln_fwd(const float* x, const float* g, float* out, int m, int d, cudaStream_t stream) {
  simt_f32_ln_fwd_kernel<<<(m + 7) / 8, 256, 0, stream>>>(x, g, out, m, d);
  return cudaGetLastError();
}

// The backward of out = z g, z = (x - mean) rstd, from dout: dx = (dz -
// mean(dz) - z mean(dz z)) rstd with dz = dout g, plus `res` where given;
// the rows' dg = sum dout z as one partial a block (LN_ROWS rows, a warp
// every WARPS-th row; each warp adds to its own shared-memory row, the
// warps' rows are summed in warp order).
template <int WARPS>
__global__ void __launch_bounds__(WARPS * 32)
simt_f32_ln_bwd_kernel(const float* __restrict__ x, const float* __restrict__ g, const float* __restrict__ dout,
                       const float* __restrict__ res, float* __restrict__ dx, float* __restrict__ part, int m,
                       int d) {
  extern __shared__ float dg[];  // [WARPS][d]
  const int w = threadIdx.x / 32, lane = threadIdx.x % 32;
  for (int c = threadIdx.x; c < WARPS * d; c += WARPS * 32) dg[c] = 0.0f;
  __syncthreads();
  float* mine = dg + w * d;
  const long long r1 = min((long long)m, (long long)(blockIdx.x + 1) * LN_ROWS);
  for (long long row = (long long)blockIdx.x * LN_ROWS + w; row < r1; row += WARPS) {
    const float* xr = x + row * d;
    const float* dr = dout + row * d;
    float mean, rstd;
    row_stats(xr, d, mean, rstd);
    float s1 = 0.0f, s2 = 0.0f;
    for (int c = lane; c < d; c += 32) {
      const float z = (xr[c] - mean) * rstd, dz = dr[c] * g[c];
      s1 += dz;
      s2 = fmaf(dz, z, s2);
      mine[c] = fmaf(dr[c], z, mine[c]);
    }
    const float mdz = warp_sum(s1) / d, mdzz = warp_sum(s2) / d;
    for (int c = lane; c < d; c += 32) {
      const float z = (xr[c] - mean) * rstd;
      const float v = (dr[c] * g[c] - mdz - z * mdzz) * rstd;
      dx[row * d + c] = res != nullptr ? res[row * d + c] + v : v;
    }
  }
  __syncthreads();
  for (int c = threadIdx.x; c < d; c += WARPS * 32) {
    float s = 0.0f;
    for (int i = 0; i < WARPS; ++i) s += dg[i * d + c];
    part[(long long)blockIdx.x * d + c] = s;
  }
}

// The gain partials of ln_bwd over m rows
__host__ __device__ inline int ln_blocks(int m) { return (m + LN_ROWS - 1) / LN_ROWS; }

// dx and the gain's partials [ln_blocks(m), d] at `part`: 8 warps a block up
// to d = 1536, 4 past it (WARPS d floats of shared memory: at most 48 KB)
static cudaError_t ln_bwd(const float* x, const float* g, const float* dout, const float* res, float* dx, float* part,
                          int m, int d, cudaStream_t stream) {
  if (d <= 1536)
    simt_f32_ln_bwd_kernel<8><<<ln_blocks(m), 8 * 32, 8 * d * sizeof(float), stream>>>(x, g, dout, res, dx, part, m,
                                                                                      d);
  else
    simt_f32_ln_bwd_kernel<4><<<ln_blocks(m), 4 * 32, 4 * d * sizeof(float), stream>>>(x, g, dout, res, dx, part, m,
                                                                                      d);
  return cudaGetLastError();
}

}  // namespace simt_f32
