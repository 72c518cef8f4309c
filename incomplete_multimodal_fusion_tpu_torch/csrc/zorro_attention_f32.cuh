// The f32 instance of K1 (zorro attention forward) and K1b (its backward),
// for the f32 paths the TPU kernels also take (pallas_attn.py and
// pallas_small_attn.py compute in the operands' dtype, so an f32 model runs
// them in f32). Included by zorro_attention.cu (K1 / K1b in f32 on the
// fused slab, on separate q, k, v and with a tile-skip table) and by
// fused_block_attn.cu (the f32 instance of K6 / K6b calls launch_f32 and
// launch_bwd_f32 as the bf16 one calls zorro::launch).
//
// The semantics are K1's (zorro_attention.cuh): the mask predicate
// masked_score, the finite NEG_INF for masked keys and -inf for keys past N,
// the online softmax in the log2 domain (a row whose first key tiles are
// all masked weighs them exp2(0) = 1 until its first allowed key clears
// them), the row lse = m ln 2 + ln l that the backward reads, the tile-skip
// table (a dead pair of tiles is never loaded), D = rowsum(dO * O) on the
// stored O, and no atomics: dq in one kernel, dk and dv in another, so two
// runs are bitwise equal. Without the bf16 casts, every product and sum is
// f32 on the CUDA cores (FFMA): no TF32, which would keep about three
// digits where the TPU kernel and the plain versions keep f32's.
//
// Design (simple first; its speed is later work): 64 rows (queries, or the
// dk/dv kernel's keys) a block, DH / 16 lanes a row, each lane holding 16 of
// the row's channels as four float4 chunks (chunk c of lane j is the row's
// chunk j + LANES c, so the lanes of a row read neighbouring 16 bytes of a
// shared-memory row: no bank conflicts). Tiles of 32 keys (or queries) and
// their types are staged in shared memory by 16-byte loads, and every dot
// product is a lane's 16 FFMAs and a shuffle sum over the row's lanes.
// What bounds it on an H100: the products, 4 (forward) and 10 (backward)
// flops a pair and channel, at the CUDA cores' 67 TFLOP/s f32 rate.
#pragma once

#include "zorro_attention.cuh"

namespace zorro {

constexpr int F32_ROWS = 64;  // rows a block
constexpr int F32_TILE = 32;  // keys (or queries) a staged tile

struct Operands32 {
  const float* q;
  const float* k;
  const float* v;
  long long bstride;  // elements between batch rows
  long long rstride;  // elements between tokens
};

struct GradOperands32 {
  float* q;
  float* k;
  float* v;
  long long bstride;
  long long rstride;
};

template <int DH>
struct F32Geo {
  static constexpr int LANES = DH / 16;           // lanes a row: 2, 4, 8
  static constexpr int THREADS = F32_ROWS * LANES;  // 128, 256, 512
  static constexpr int C4 = DH / 4;               // float4 chunks a row
};

// A lane's 16 channels of a row: chunks slot + LANES c, c = 0..3
template <int DH>
__device__ __forceinline__ void load_row16(float4 (&r)[4], const float* row, int slot) {
#pragma unroll
  for (int c = 0; c < 4; ++c) r[c] = reinterpret_cast<const float4*>(row)[slot + F32Geo<DH>::LANES * c];
}

template <int DH>
__device__ __forceinline__ void store_row16(float* row, const float4 (&r)[4], int slot, float mul) {
#pragma unroll
  for (int c = 0; c < 4; ++c)
    reinterpret_cast<float4*>(row)[slot + F32Geo<DH>::LANES * c] =
        make_float4(r[c].x * mul, r[c].y * mul, r[c].z * mul, r[c].w * mul);
}

// The lane's part of the dot product of its 16 channels with a staged row
template <int DH>
__device__ __forceinline__ float dot16(const float4 (&a)[4], const float4* row, int slot) {
  float s = 0.0f;
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    const float4 b = row[slot + F32Geo<DH>::LANES * c];
    s = fmaf(a[c].x, b.x, s);
    s = fmaf(a[c].y, b.y, s);
    s = fmaf(a[c].z, b.z, s);
    s = fmaf(a[c].w, b.w, s);
  }
  return s;
}

// acc += w * (the lane's 16 channels of a staged row)
template <int DH>
__device__ __forceinline__ void axpy16(float4 (&acc)[4], float w, const float4* row, int slot) {
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    const float4 b = row[slot + F32Geo<DH>::LANES * c];
    acc[c].x = fmaf(w, b.x, acc[c].x);
    acc[c].y = fmaf(w, b.y, acc[c].y);
    acc[c].z = fmaf(w, b.z, acc[c].z);
    acc[c].w = fmaf(w, b.w, acc[c].w);
  }
}

// The sum over a row's LANES lanes (neighbouring lanes of one warp)
template <int DH>
__device__ __forceinline__ float row_sum(float v) {
#pragma unroll
  for (int o = F32Geo<DH>::LANES / 2; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// Stages rows [r0, r0 + F32_TILE) of a DH-wide column slice into
// dst[F32_TILE][DH / 4] by 16-byte loads; rows at or past n become zeros.
template <int DH>
__device__ __forceinline__ void stage_rows(float4* dst, const float* src, int r0, int n, long long rstride) {
  constexpr int C4 = F32Geo<DH>::C4;
  for (int i = threadIdx.x; i < F32_TILE * C4; i += F32Geo<DH>::THREADS) {
    const int r = i / C4, c = i % C4;
    dst[i] = r0 + r < n ? reinterpret_cast<const float4*>(src + (long long)(r0 + r) * rstride)[c]
                        : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  }
}

// 32 four-byte values of a row (types, lse, D) from r0; past n `fill`
template <typename T>
__device__ __forceinline__ void stage_values(T* dst, const T* src, int r0, int n, T fill) {
  if (threadIdx.x < F32_TILE) dst[threadIdx.x] = r0 + (int)threadIdx.x < n ? src[r0 + threadIdx.x] : fill;
}

// ---------------------------------------------------------------------------
// Forward: a block per (64 query rows, head, batch row)
// ---------------------------------------------------------------------------

template <int DH, int MODE>
__global__ void __launch_bounds__(F32Geo<DH>::THREADS)
zorro_attention_f32_fwd_kernel(Operands32 in, const int32_t* __restrict__ types, const int32_t* __restrict__ active,
                               int nt, float* __restrict__ out, float* __restrict__ lse, int n,
                               long long out_bstride, long long out_rstride, long long types_bstride, float scale,
                               int fusion_type) {
  constexpr int L = F32Geo<DH>::LANES, C4 = F32Geo<DH>::C4;
  __shared__ float4 ks[F32_TILE * C4], vs[F32_TILE * C4];
  __shared__ int kt[F32_TILE];
  const int q0 = blockIdx.x * F32_ROWS, h = blockIdx.y, b = blockIdx.z;
  const int r = threadIdx.x / L, slot = threadIdx.x % L;
  const int qi = q0 + r;
  const bool q_in = qi < n;
  const float* kb = in.k + (long long)b * in.bstride + h * DH;
  const float* vb = in.v + (long long)b * in.bstride + h * DH;
  const int32_t* tb = types + (long long)b * types_bstride;

  float4 q4[4], o4[4];
  load_row16<DH>(q4, in.q + (long long)b * in.bstride + (long long)(q_in ? qi : q0) * in.rstride + h * DH, slot);
#pragma unroll
  for (int c = 0; c < 4; ++c) o4[c] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  const int t_q = (MODE == MODE_ZORRO && q_in) ? tb[qi] : 0;
  const float sl2 = scale * LOG2E;
  float m = -CUDART_INF_F, l = 0.0f;

  for (int k0 = 0; k0 < n; k0 += F32_TILE) {
    if (!pair_active(active, nt, b, q0, k0)) continue;  // the same for the whole block
    __syncthreads();
    stage_rows<DH>(ks, kb, k0, n, in.rstride);
    stage_rows<DH>(vs, vb, k0, n, in.rstride);
    if (MODE == MODE_ZORRO) stage_values<int>(kt, tb, k0, n, PAD_TYPE);
    __syncthreads();

    float s[F32_TILE];
    float mx = m;
#pragma unroll
    for (int j = 0; j < F32_TILE; ++j) {
      const float x = row_sum<DH>(dot16<DH>(q4, ks + j * C4, slot));
      s[j] = k0 + j < n ? masked_score<MODE>(x * sl2, t_q, MODE == MODE_ZORRO ? kt[j] : 0, fusion_type)
                        : -CUDART_INF_F;
      mx = fmaxf(mx, s[j]);
    }
    const float corr = exp2f(m - mx);  // 0 on the first tile (m = -inf)
    l *= corr;
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      o4[c].x *= corr;
      o4[c].y *= corr;
      o4[c].z *= corr;
      o4[c].w *= corr;
    }
#pragma unroll
    for (int j = 0; j < F32_TILE; ++j) {
      const float p = exp2f(s[j] - mx);
      l += p;
      axpy16<DH>(o4, p, vs + j * C4, slot);
    }
    m = mx;
  }
  if (q_in) {
    store_row16<DH>(out + (long long)b * out_bstride + (long long)qi * out_rstride + h * DH, o4, slot, 1.0f / l);
    if (lse != nullptr && slot == 0) lse[((long long)b * gridDim.y + h) * n + qi] = m * LN2 + logf(l);
  }
}

template <int DH, int MODE>
static cudaError_t launch_f32(const Operands32& in, const int32_t* types, const int32_t* active, int nt, float* out,
                              float* lse, int batch, int n, int heads, long long out_bstride, long long out_rstride,
                              long long types_bstride, float scale, int fusion_type, cudaStream_t stream) {
  dim3 grid((n + F32_ROWS - 1) / F32_ROWS, heads, batch);
  zorro_attention_f32_fwd_kernel<DH, MODE><<<grid, F32Geo<DH>::THREADS, 0, stream>>>(
      in, types, active, nt, out, lse, n, out_bstride, out_rstride, types_bstride, scale, fusion_type);
  return cudaGetLastError();
}

template <int MODE>
cudaError_t dispatch_f32(int dh, const Operands32& in, const int32_t* types, const int32_t* active, int nt,
                         float* out, float* lse, int batch, int n, int heads, long long out_bstride,
                         long long out_rstride, long long types_bstride, float scale, int fusion_type,
                         cudaStream_t stream) {
  switch (dh) {
    case 32:
      return launch_f32<32, MODE>(in, types, active, nt, out, lse, batch, n, heads, out_bstride, out_rstride,
                                  types_bstride, scale, fusion_type, stream);
    case 64:
      return launch_f32<64, MODE>(in, types, active, nt, out, lse, batch, n, heads, out_bstride, out_rstride,
                                  types_bstride, scale, fusion_type, stream);
    case 128:
      return launch_f32<128, MODE>(in, types, active, nt, out, lse, batch, n, heads, out_bstride, out_rstride,
                                   types_bstride, scale, fusion_type, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

// ---------------------------------------------------------------------------
// Backward: the dq kernel (a block per query rows), then the dk/dv kernel (a
// block per key rows); P = exp2(s * scale * log2(e) (masked) - lse log2(e))
// ---------------------------------------------------------------------------

template <int DH, int MODE>
__global__ void __launch_bounds__(F32Geo<DH>::THREADS)
zorro_attention_f32_dq_kernel(Operands32 in, const int32_t* __restrict__ types, const int32_t* __restrict__ active,
                              int nt, const float* __restrict__ o, const float* __restrict__ lse,
                              const float* __restrict__ dout, GradOperands32 grad, float* __restrict__ delta,
                              int n, long long types_bstride, float scale, int fusion_type) {
  constexpr int L = F32Geo<DH>::LANES, C4 = F32Geo<DH>::C4;
  __shared__ float4 ks[F32_TILE * C4], vs[F32_TILE * C4];
  __shared__ int kt[F32_TILE];
  const int q0 = blockIdx.x * F32_ROWS, h = blockIdx.y, b = blockIdx.z;
  const int r = threadIdx.x / L, slot = threadIdx.x % L;
  const int qi = q0 + r;
  const bool q_in = qi < n;
  const int qr = q_in ? qi : q0;
  const int inner = gridDim.y * DH;
  const float* kb = in.k + (long long)b * in.bstride + h * DH;
  const float* vb = in.v + (long long)b * in.bstride + h * DH;
  const int32_t* tb = types + (long long)b * types_bstride;
  const long long row = ((long long)b * gridDim.y + h) * n + qr;

  float4 q4[4], do4[4], o4[4], dq4[4];
  load_row16<DH>(q4, in.q + (long long)b * in.bstride + (long long)qr * in.rstride + h * DH, slot);
  load_row16<DH>(do4, dout + ((long long)b * n + qr) * inner + h * DH, slot);
  load_row16<DH>(o4, o + ((long long)b * n + qr) * inner + h * DH, slot);
  float d = 0.0f;
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    d = fmaf(do4[c].x, o4[c].x, d);
    d = fmaf(do4[c].y, o4[c].y, d);
    d = fmaf(do4[c].z, o4[c].z, d);
    d = fmaf(do4[c].w, o4[c].w, d);
    dq4[c] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  }
  d = row_sum<DH>(d);  // D = rowsum(dO * O), for the dk/dv kernel too
  if (q_in && slot == 0) delta[row] = d;
  const float l2 = lse[row] * LOG2E;
  const int t_q = (MODE == MODE_ZORRO && q_in) ? tb[qi] : 0;
  const float sl2 = scale * LOG2E;

  for (int k0 = 0; k0 < n; k0 += F32_TILE) {
    if (!pair_active(active, nt, b, q0, k0)) continue;
    __syncthreads();
    stage_rows<DH>(ks, kb, k0, n, in.rstride);
    stage_rows<DH>(vs, vb, k0, n, in.rstride);
    if (MODE == MODE_ZORRO) stage_values<int>(kt, tb, k0, n, PAD_TYPE);
    __syncthreads();
#pragma unroll 4
    for (int j = 0; j < F32_TILE; ++j) {
      const float s = row_sum<DH>(dot16<DH>(q4, ks + j * C4, slot));
      const float dp = row_sum<DH>(dot16<DH>(do4, vs + j * C4, slot));
      const float x = masked_score<MODE>(s * sl2, t_q, MODE == MODE_ZORRO ? kt[j] : 0, fusion_type);
      const float p = k0 + j < n ? exp2f(x - l2) : 0.0f;
      axpy16<DH>(dq4, p * (dp - d), ks + j * C4, slot);
    }
  }
  if (q_in) store_row16<DH>(grad.q + (long long)b * grad.bstride + (long long)qi * grad.rstride + h * DH, dq4, slot,
                            scale);
}

template <int DH, int MODE>
__global__ void __launch_bounds__(F32Geo<DH>::THREADS)
zorro_attention_f32_dkdv_kernel(Operands32 in, const int32_t* __restrict__ types,
                                const int32_t* __restrict__ active, int nt, const float* __restrict__ lse,
                                const float* __restrict__ dout, const float* __restrict__ delta, GradOperands32 grad,
                                int n, long long types_bstride, float scale, int fusion_type) {
  constexpr int L = F32Geo<DH>::LANES, C4 = F32Geo<DH>::C4;
  __shared__ float4 qs[F32_TILE * C4], dos[F32_TILE * C4];
  __shared__ int tq[F32_TILE];
  __shared__ float lq[F32_TILE], dq[F32_TILE];
  const int k0 = blockIdx.x * F32_ROWS, h = blockIdx.y, b = blockIdx.z;
  const int r = threadIdx.x / L, slot = threadIdx.x % L;
  const int ki = k0 + r;
  const bool k_in = ki < n;
  const int kr = k_in ? ki : k0;
  const int inner = gridDim.y * DH;
  const float* qb = in.q + (long long)b * in.bstride + h * DH;
  const float* dob = dout + (long long)b * n * inner + h * DH;
  const int32_t* tb = types + (long long)b * types_bstride;
  const long long rows = ((long long)b * gridDim.y + h) * n;

  float4 k4[4], v4[4], dk4[4], dv4[4];
  load_row16<DH>(k4, in.k + (long long)b * in.bstride + (long long)kr * in.rstride + h * DH, slot);
  load_row16<DH>(v4, in.v + (long long)b * in.bstride + (long long)kr * in.rstride + h * DH, slot);
#pragma unroll
  for (int c = 0; c < 4; ++c) dk4[c] = dv4[c] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  const int t_k = (MODE == MODE_ZORRO && k_in) ? tb[ki] : PAD_TYPE;
  const float sl2 = scale * LOG2E;

  for (int q0 = 0; q0 < n; q0 += F32_TILE) {
    if (!pair_active(active, nt, b, q0, k0)) continue;
    __syncthreads();
    stage_rows<DH>(qs, qb, q0, n, in.rstride);
    stage_rows<DH>(dos, dob, q0, n, inner);
    if (MODE == MODE_ZORRO) stage_values<int>(tq, tb, q0, n, PAD_TYPE);
    stage_values<float>(lq, lse + rows, q0, n, 0.0f);
    stage_values<float>(dq, delta + rows, q0, n, 0.0f);
    __syncthreads();
#pragma unroll 4
    for (int i = 0; i < F32_TILE; ++i) {
      const float s = row_sum<DH>(dot16<DH>(k4, qs + i * C4, slot));
      const float dp = row_sum<DH>(dot16<DH>(v4, dos + i * C4, slot));
      const float x = masked_score<MODE>(s * sl2, MODE == MODE_ZORRO ? tq[i] : 0, t_k, fusion_type);
      const float p = (k_in && q0 + i < n) ? exp2f(x - lq[i] * LOG2E) : 0.0f;
      axpy16<DH>(dv4, p, dos + i * C4, slot);
      axpy16<DH>(dk4, p * (dp - dq[i]), qs + i * C4, slot);
    }
  }
  if (k_in) {
    const long long at = (long long)b * grad.bstride + (long long)ki * grad.rstride + h * DH;
    store_row16<DH>(grad.k + at, dk4, slot, scale);
    store_row16<DH>(grad.v + at, dv4, slot, 1.0f);
  }
}

template <int DH, int MODE>
static cudaError_t launch_bwd_f32(const Operands32& in, const int32_t* types, const int32_t* active, int nt,
                                  const float* o, const float* lse, const float* dout, const GradOperands32& grad,
                                  float* delta, int batch, int n, int heads, long long types_bstride, float scale,
                                  int fusion_type, cudaStream_t stream) {
  dim3 grid((n + F32_ROWS - 1) / F32_ROWS, heads, batch);
  zorro_attention_f32_dq_kernel<DH, MODE><<<grid, F32Geo<DH>::THREADS, 0, stream>>>(
      in, types, active, nt, o, lse, dout, grad, delta, n, types_bstride, scale, fusion_type);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  zorro_attention_f32_dkdv_kernel<DH, MODE><<<grid, F32Geo<DH>::THREADS, 0, stream>>>(
      in, types, active, nt, lse, dout, delta, grad, n, types_bstride, scale, fusion_type);
  return cudaGetLastError();
}

template <int MODE>
cudaError_t dispatch_bwd_f32(int dh, const Operands32& in, const int32_t* types, const int32_t* active, int nt,
                             const float* o, const float* lse, const float* dout, const GradOperands32& grad,
                             float* delta, int batch, int n, int heads, long long types_bstride, float scale,
                             int fusion_type, cudaStream_t stream) {
  switch (dh) {
    case 32:
      return launch_bwd_f32<32, MODE>(in, types, active, nt, o, lse, dout, grad, delta, batch, n, heads,
                                      types_bstride, scale, fusion_type, stream);
    case 64:
      return launch_bwd_f32<64, MODE>(in, types, active, nt, o, lse, dout, grad, delta, batch, n, heads,
                                      types_bstride, scale, fusion_type, stream);
    case 128:
      return launch_bwd_f32<128, MODE>(in, types, active, nt, o, lse, dout, grad, delta, batch, n, heads,
                                       types_bstride, scale, fusion_type, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace zorro
