// Full-f32 building blocks on the CUDA cores (FFMA), shared by the f32
// instances of K6 / K6b (fused_block_attn.cu) and of K2 (fused_ffn.cu) and
// K2b (fused_ffn_bwd.cu) past d 256 (ffn_tf32.cuh takes them up to d 256,
// with this file's fixed-order reduction): a tiled matrix product with the
// epilogues those kernels need, the bias-free LayerNorm and its backward a
// warp a row, the GELU / GEGLU activation, column sums and the fixed-order
// reduction of partial sums. Every product and sum is f32 (no TF32: the TPU
// kernels and the plain versions keep f32's digits), and nothing is summed
// by atomics, so two runs are bitwise equal.
//
// The product: C [m, n] = A [m, k] . B [k, n] with any element strides
// (A(i, k) = a[i rs + k cs]), so one kernel reads row-major operands, the
// nn.Linear weights as their transposes and, for a weight gradient, the
// rows of a batch as the reduction. A block of 256 threads computes a
// 64 x 64 tile, 4 x 4 outputs a thread, over steps of 16 of the reduction
// staged in shared memory (each operand loaded along its contiguous axis).
// A weight gradient splits its reduction (the batch's rows) into ranges of
// at most SPLIT_ROWS rows, one f32 partial tile a range, which the
// reduction kernel then sums in range order. What bounds it is the CUDA
// cores' 67 TFLOP/s f32 rate (ffn_tf32.cuh: the same f32 products in three
// TF32 parts on the tensor cores).
#pragma once

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace simt_f32 {

constexpr float LN_EPS = 1e-5f;
constexpr int BM = 64, BN = 64, BK = 16, THREADS = 256;
constexpr int SPLIT_ROWS = 1024;  // rows of a weight gradient's reduction range
constexpr int MAX_SPLITS = 64;
constexpr int LN_WARPS = 4;     // warps a LayerNorm-backward block
constexpr int LN_ROWS = 256;    // rows a LayerNorm-backward block (its dg partial)

// Element (i, k) of a matrix operand at p[i rs + k cs]
struct Mat {
  const float* p;
  long long rs, cs;
};

enum Epi {
  EPI_STORE = 0,    // C = add + (acc + bias), add and bias optional
  EPI_GELU = 1,     // C = gelu(acc + bias)
  EPI_DGEGLU = 2,   // da = acc; with u = aux [m, 2n] (val | gate): C[:, j] = da gelu(gate),
                    // C[:, n + j] = da val gelu'(gate)
  EPI_DGELU = 3,    // C = acc gelu'(h), h = aux [m, n]
  EPI_PARTIAL = 4,  // C + z split_stride = acc of reduction range z
};

struct Out {
  float* c;
  long long ldc;
  const float* bias;  // [n] or null
  const float* add;   // [m, n] with ld_add, or null
  long long ld_add;
  const float* aux;  // EPI_DGEGLU, EPI_DGELU
  long long ld_aux;
  long long split_stride;  // EPI_PARTIAL
};

__device__ __forceinline__ float gelu_cdf(float g) { return 0.5f * (1.0f + erff(g * 0.70710678118654752f)); }
__device__ __forceinline__ float gelu_pdf(float g) { return expf(-0.5f * g * g) * 0.39894228040143268f; }

// One block's 64 x 64 tile of C over the reduction range [kb, ke);
// EPI_PARTIAL stores it as range z's partial
template <int EPI>
__device__ __forceinline__ void product_tile(const Mat& a, const Mat& b, const Out& o, int m, int n, int kb, int ke,
                                             int z) {
  __shared__ __align__(16) float as[BK][BM + 4];
  __shared__ __align__(16) float bs[BK][BN + 4];
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const int i0 = blockIdx.y * BM, j0 = blockIdx.x * BN;
  const bool a_along_k = a.cs == 1, b_along_n = b.cs == 1;
  float acc[4][4];
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[r][c] = 0.0f;

  for (int k0 = kb; k0 < ke; k0 += BK) {
#pragma unroll
    for (int it = 0; it < BM * BK / THREADS; ++it) {
      const int e = it * THREADS + threadIdx.x;
      const int ii = a_along_k ? e / BK : e % BM, kk = a_along_k ? e % BK : e / BM;
      const int gi = i0 + ii, gk = k0 + kk;
      as[kk][ii] = (gi < m && gk < ke) ? a.p[gi * a.rs + gk * a.cs] : 0.0f;
    }
#pragma unroll
    for (int it = 0; it < BN * BK / THREADS; ++it) {
      const int e = it * THREADS + threadIdx.x;
      const int jj = b_along_n ? e % BN : e / BK, kk = b_along_n ? e / BN : e % BK;
      const int gj = j0 + jj, gk = k0 + kk;
      bs[kk][jj] = (gj < n && gk < ke) ? b.p[gk * b.rs + gj * b.cs] : 0.0f;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < BK; ++kk) {
      const float4 av = *reinterpret_cast<const float4*>(&as[kk][ty * 4]);
      const float4 bv = *reinterpret_cast<const float4*>(&bs[kk][tx * 4]);
      const float ar[4] = {av.x, av.y, av.z, av.w}, br[4] = {bv.x, bv.y, bv.z, bv.w};
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int c = 0; c < 4; ++c) acc[r][c] = fmaf(ar[r], br[c], acc[r][c]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int i = i0 + ty * 4 + r;
    if (i >= m) continue;
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int j = j0 + tx * 4 + c;
      if (j >= n) continue;
      const float v = acc[r][c];
      if constexpr (EPI == EPI_STORE) {
        float y = o.bias != nullptr ? v + o.bias[j] : v;
        if (o.add != nullptr) y = o.add[i * o.ld_add + j] + y;
        o.c[i * o.ldc + j] = y;
      } else if constexpr (EPI == EPI_GELU) {
        const float h = v + o.bias[j];
        o.c[i * o.ldc + j] = h * gelu_cdf(h);
      } else if constexpr (EPI == EPI_DGEGLU) {
        const float val = o.aux[i * o.ld_aux + j], gate = o.aux[i * o.ld_aux + n + j];
        const float cdf = gelu_cdf(gate);
        o.c[i * o.ldc + j] = v * (gate * cdf);
        o.c[i * o.ldc + n + j] = v * val * (cdf + gate * gelu_pdf(gate));
      } else if constexpr (EPI == EPI_DGELU) {
        const float h = o.aux[i * o.ld_aux + j];
        o.c[i * o.ldc + j] = v * (gelu_cdf(h) + h * gelu_pdf(h));
      } else {
        o.c[z * o.split_stride + i * o.ldc + j] = v;
      }
    }
  }
}

template <int EPI>
__global__ void __launch_bounds__(THREADS)
simt_f32_product_kernel(Mat a, Mat b, Out o, int m, int n, int k, int k_range) {
  const int kb = blockIdx.z * k_range;
  product_tile<EPI>(a, b, o, m, n, kb, min(k, kb + k_range), blockIdx.z);
}

// Element offsets of one task's operands from the previous task's: A, B,
// C and the bias
struct Strides {
  long long a, b, c, bias;
};

// The product over a task axis (K2's MLP with its tasks): blockIdx.z is a
// task, whose operands lie `st` apart; the whole reduction a block
template <int EPI>
__global__ void __launch_bounds__(THREADS)
simt_f32_product_tasks_kernel(Mat a, Mat b, Out o, int m, int n, int k, Strides st) {
  const long long t = blockIdx.z;
  a.p += t * st.a;
  b.p += t * st.b;
  o.c += t * st.c;
  if (o.bias != nullptr) o.bias += t * st.bias;
  product_tile<EPI>(a, b, o, m, n, 0, k, 0);
}

// The reduction ranges of a weight gradient over m rows
__host__ __device__ inline int splits_for(int m) {
  const int s = (m + SPLIT_ROWS - 1) / SPLIT_ROWS;
  return s < 1 ? 1 : (s > MAX_SPLITS ? MAX_SPLITS : s);
}

template <int EPI>
static cudaError_t product(Mat a, Mat b, Out o, int m, int n, int k, cudaStream_t stream) {
  const int splits = EPI == EPI_PARTIAL ? splits_for(k) : 1;
  const int k_range = (k + splits - 1) / splits;
  dim3 grid((n + BN - 1) / BN, (m + BM - 1) / BM, splits);
  simt_f32_product_kernel<EPI><<<grid, THREADS, 0, stream>>>(a, b, o, m, n, k, k_range);
  return cudaGetLastError();
}

template <int EPI>
static cudaError_t product_tasks(Mat a, Mat b, Out o, int m, int n, int k, Strides st, int tasks,
                                 cudaStream_t stream) {
  dim3 grid((n + BN - 1) / BN, (m + BM - 1) / BM, tasks);
  simt_f32_product_tasks_kernel<EPI><<<grid, THREADS, 0, stream>>>(a, b, o, m, n, k, st);
  return cudaGetLastError();
}

// C [m, n] row-major (ldc) = A . B
static cudaError_t product_store(Mat a, Mat b, float* c, long long ldc, int m, int n, int k, const float* bias,
                                 const float* add, long long ld_add, cudaStream_t stream) {
  return product<EPI_STORE>(a, b, Out{c, ldc, bias, add, ld_add, nullptr, 0, 0}, m, n, k, stream);
}

// The weight gradient C [p, q] = sum over rows of x[row, p] y[row, q]
// (x [rows, p], y [rows, q] row-major with leading dimensions ldx, ldy),
// as splits_for(rows) partials [range][p][q] at part
static cudaError_t weight_grad_partials(const float* x, long long ldx, const float* y, long long ldy, int rows,
                                        int p, int q, float* part, cudaStream_t stream) {
  return product<EPI_PARTIAL>(Mat{x, 1, ldx}, Mat{y, ldy, 1}, Out{part, q, nullptr, nullptr, 0, nullptr, 0,
                                                                    (long long)p * q},
                              p, q, rows, stream);
}

// Column sums of x [m, n] (ld) over the same reduction ranges as
// weight_grad_partials: part[range][n]
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

static cudaError_t colsum_partials(const float* x, long long ld, int m, int n, float* part, cudaStream_t stream) {
  const int splits = splits_for(m);
  dim3 grid((n + 255) / 256, splits);
  simt_f32_colsum_kernel<<<grid, 256, 0, stream>>>(x, ld, m, n, (m + splits - 1) / splits, part);
  return cudaGetLastError();
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
// every LN_WARPS-th row; each warp adds to its own shared-memory row, the
// warps' rows are summed in warp order).
__global__ void __launch_bounds__(LN_WARPS * 32)
simt_f32_ln_bwd_kernel(const float* __restrict__ x, const float* __restrict__ g, const float* __restrict__ dout,
                       const float* __restrict__ res, float* __restrict__ dx, float* __restrict__ part, int m,
                       int d) {
  extern __shared__ float dg[];  // [LN_WARPS][d]
  const int w = threadIdx.x / 32, lane = threadIdx.x % 32;
  for (int c = threadIdx.x; c < LN_WARPS * d; c += LN_WARPS * 32) dg[c] = 0.0f;
  __syncthreads();
  float* mine = dg + w * d;
  const long long r1 = min((long long)m, (long long)(blockIdx.x + 1) * LN_ROWS);
  for (long long row = (long long)blockIdx.x * LN_ROWS + w; row < r1; row += LN_WARPS) {
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
  for (int c = threadIdx.x; c < d; c += LN_WARPS * 32) {
    float s = 0.0f;
    for (int i = 0; i < LN_WARPS; ++i) s += dg[i * d + c];
    part[(long long)blockIdx.x * d + c] = s;
  }
}

__host__ __device__ inline int ln_blocks(int m) { return (m + LN_ROWS - 1) / LN_ROWS; }

static cudaError_t ln_bwd(const float* x, const float* g, const float* dout, const float* res, float* dx, float* part,
                          int m, int d, cudaStream_t stream) {
  simt_f32_ln_bwd_kernel<<<ln_blocks(m), LN_WARPS * 32, LN_WARPS * d * sizeof(float), stream>>>(x, g, dout, res, dx,
                                                                                               part, m, d);
  return cudaGetLastError();
}

// dst [m, n] = src[:, :n] gelu(src[:, n:]) (geglu, src [m, 2n]) or gelu(src)
// (src [m, n])
__global__ void __launch_bounds__(256)
simt_f32_act_kernel(const float* __restrict__ src, float* __restrict__ dst, long long m, int n, int geglu) {
  const long long e = (long long)blockIdx.x * 256 + threadIdx.x;
  if (e >= m * n) return;
  const long long i = e / n;
  const int j = (int)(e % n);
  if (geglu) {
    const float gate = src[i * 2 * n + n + j];
    dst[e] = src[i * 2 * n + j] * (gate * gelu_cdf(gate));
  } else {
    const float h = src[e];
    dst[e] = h * gelu_cdf(h);
  }
}

static cudaError_t act(const float* src, float* dst, long long m, int n, bool geglu, cudaStream_t stream) {
  simt_f32_act_kernel<<<(unsigned)((m * n + 255) / 256), 256, 0, stream>>>(src, dst, m, n, geglu ? 1 : 0);
  return cudaGetLastError();
}

}  // namespace simt_f32
