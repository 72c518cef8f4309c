// K3: fusion_row_attention -- each fusion position attends, per head, over
// its T modality slots of the t-major KV grid plus its own fusion-token
// key/value, with an f32 softmax over the T + 1 slots -- and its backward
// (K3b).
//
// Replaces the Pallas TPU kernels ops/pallas_fusion_attn.py _fwd_kernel
// (pallas_call in _fwd_impl) and _bwd_kernel (pallas_call in _bwd_rule) of
// the JAX package, used by every FusionBlockFast. Like them, these kernels
// read the untransposed operands as
// produced upstream -- q [B, F, I], kv_grid [B, T*F, 2I] with row t*F + f
// for slot t, kv_f [B, F, 2I] -- so no [B, T, F, h, dh] -> [B, F, T, h, dh]
// transposes are ever materialized. Rounding points are those of
// pallas_fusion_attn.py:47-62 and :85-92: q * scale rounded to bf16 then
// read as f32, keys in f32, the attention weight cast to bf16 before the
// mix, and the mix itself (product and running sum over slots) rounded to
// bf16 at each step, as the activation-dtype arithmetic there does.
//
// Written in CUDA C++ rather than Triton: it is a pure reduction pass, and
// keeping all three kernels on one build route (nvcc + ctypes) keeps the
// build to one tool and seconds per file.
//
// What bounds it on an H100: it does (T + 1) * 4 * dh flops per (position,
// head) on (1 + 2(T + 1)) * dh * 2 bytes, under one flop per byte, so it is
// bound by HBM bandwidth: the whole kv grid is read once. The design
// therefore reads every operand exactly once, coalesced: one warp per
// (batch, position, head), each lane holding dh / 32 contiguous elements of
// q, k and v in registers, warp shuffles for the dot products, and the
// T + 1 softmax weights kept in registers. No shared memory.
//
// The backward is bound the same way (it reads q, the grid, kv_f and dO once
// and writes dq, dkv_grid and dkv_f once, under two flops a byte) and has the
// same design: one warp per (batch, position, head) recomputes the slot
// sims and the softmax, forms dattn_t = dO . v_t in f32, ds_t = attn_t
// (dattn_t - sum_s attn_s dattn_s), and writes dq = sum_t ds_t k_t * scale,
// dk_t = ds_t * qh and dv_t = bf16(attn_t) * dO rounded to bf16, the cast
// points of pallas_fusion_attn.py:95-126. Every output element has one
// writer, so there are no atomics.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

using bf16 = __nv_bfloat16;

namespace {

constexpr int MAX_SLOTS = 9;  // T + 1 <= 9

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float round_bf16(float v) {
  return __bfloat162float(__float2bfloat16(v));
}

// grid (F, B), block heads * 32 threads: warp h of block (f, b) serves head h.
template <int DH>
__global__ void fusion_row_kernel(const bf16* __restrict__ q, const bf16* __restrict__ kv_grid,
                                  const bf16* __restrict__ kv_f, bf16* __restrict__ out, int f,
                                  int t_mod, int heads, float scale) {
  constexpr int PER = DH / 32;
  const int pos = blockIdx.x;
  const int b = blockIdx.y;
  const int h = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int inner = heads * DH;
  const int c0 = h * DH + lane * PER;

  const bf16* qrow = q + ((long long)b * f + pos) * inner;
  float qs[PER];
  for (int i = 0; i < PER; ++i) qs[i] = round_bf16(__bfloat162float(qrow[c0 + i]) * scale);

  const bf16* krows[MAX_SLOTS];
  for (int t = 0; t < t_mod; ++t)
    krows[t] = kv_grid + ((long long)b * t_mod * f + (long long)t * f + pos) * 2 * inner;
  krows[t_mod] = kv_f + ((long long)b * f + pos) * 2 * inner;

  float sim[MAX_SLOTS];
  float mx = -3.0e38f;
  for (int t = 0; t <= t_mod; ++t) {
    float part = 0.0f;
    for (int i = 0; i < PER; ++i) part += qs[i] * __bfloat162float(krows[t][c0 + i]);
    sim[t] = warp_sum(part);
    mx = fmaxf(mx, sim[t]);
  }
  float denom = 0.0f;
  for (int t = 0; t <= t_mod; ++t) {
    sim[t] = expf(sim[t] - mx);
    denom += sim[t];
  }

  float acc[PER];
  for (int t = 0; t <= t_mod; ++t) {
    const float a = round_bf16(sim[t] / denom);
    const bf16* vrow = krows[t] + inner;
    for (int i = 0; i < PER; ++i) {
      const float prod = round_bf16(a * __bfloat162float(vrow[c0 + i]));
      acc[i] = t == 0 ? prod : round_bf16(acc[i] + prod);
    }
  }
  bf16* orow = out + ((long long)b * f + pos) * inner;
  for (int i = 0; i < PER; ++i) orow[c0 + i] = __float2bfloat16(acc[i]);
}

template <int DH>
cudaError_t launch(const bf16* q, const bf16* kv_grid, const bf16* kv_f, bf16* out, int batch, int f,
                   int t_mod, int heads, float scale, cudaStream_t stream) {
  dim3 grid(f, batch);
  fusion_row_kernel<DH><<<grid, heads * 32, 0, stream>>>(q, kv_grid, kv_f, out, f, t_mod, heads, scale);
  return cudaGetLastError();
}

// grid (F, B), block heads * 32 threads, as the forward.
template <int DH>
__global__ void fusion_row_bwd_kernel(const bf16* __restrict__ q, const bf16* __restrict__ kv_grid,
                                      const bf16* __restrict__ kv_f, const bf16* __restrict__ dout,
                                      bf16* __restrict__ dq, bf16* __restrict__ dkv_grid,
                                      bf16* __restrict__ dkv_f, int f, int t_mod, int heads, float scale) {
  constexpr int PER = DH / 32;
  const int pos = blockIdx.x;
  const int b = blockIdx.y;
  const int h = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int inner = heads * DH;
  const int c0 = h * DH + lane * PER;

  const long long qoff = ((long long)b * f + pos) * inner;
  float qs[PER], dos[PER];
  for (int i = 0; i < PER; ++i) {
    qs[i] = round_bf16(__bfloat162float(q[qoff + c0 + i]) * scale);
    dos[i] = __bfloat162float(dout[qoff + c0 + i]);
  }

  long long rows[MAX_SLOTS];  // element offset of each slot's kv row
  for (int t = 0; t < t_mod; ++t) rows[t] = ((long long)b * t_mod * f + (long long)t * f + pos) * 2 * inner;
  rows[t_mod] = ((long long)b * f + pos) * 2 * inner;

  float attn[MAX_SLOTS], dattn[MAX_SLOTS];
  float mx = -3.0e38f;
  for (int t = 0; t <= t_mod; ++t) {
    const bf16* kv = t < t_mod ? kv_grid + rows[t] : kv_f + rows[t];
    float s = 0.0f, da = 0.0f;
    for (int i = 0; i < PER; ++i) {
      s += qs[i] * __bfloat162float(kv[c0 + i]);
      da += dos[i] * __bfloat162float(kv[inner + c0 + i]);
    }
    attn[t] = warp_sum(s);
    dattn[t] = warp_sum(da);
    mx = fmaxf(mx, attn[t]);
  }
  float denom = 0.0f;
  for (int t = 0; t <= t_mod; ++t) {
    attn[t] = expf(attn[t] - mx);
    denom += attn[t];
  }
  float mix = 0.0f;
  for (int t = 0; t <= t_mod; ++t) {
    attn[t] /= denom;
    mix += attn[t] * dattn[t];
  }

  float dqs[PER];
  for (int i = 0; i < PER; ++i) dqs[i] = 0.0f;
  for (int t = 0; t <= t_mod; ++t) {
    const float ds = attn[t] * (dattn[t] - mix);
    const float ab = round_bf16(attn[t]);
    const bf16* kv = t < t_mod ? kv_grid + rows[t] : kv_f + rows[t];
    bf16* dkv = t < t_mod ? dkv_grid + rows[t] : dkv_f + rows[t];
    for (int i = 0; i < PER; ++i) {
      dqs[i] += ds * __bfloat162float(kv[c0 + i]);
      dkv[c0 + i] = __float2bfloat16(ds * qs[i]);
      dkv[inner + c0 + i] = __float2bfloat16(ab * dos[i]);
    }
  }
  for (int i = 0; i < PER; ++i) dq[qoff + c0 + i] = __float2bfloat16(dqs[i] * scale);
}

template <int DH>
cudaError_t launch_bwd(const bf16* q, const bf16* kv_grid, const bf16* kv_f, const bf16* dout, bf16* dq,
                       bf16* dkv_grid, bf16* dkv_f, int batch, int f, int t_mod, int heads, float scale,
                       cudaStream_t stream) {
  dim3 grid(f, batch);
  fusion_row_bwd_kernel<DH><<<grid, heads * 32, 0, stream>>>(q, kv_grid, kv_f, dout, dq, dkv_grid, dkv_f, f,
                                                             t_mod, heads, scale);
  return cudaGetLastError();
}

}  // namespace

// q [B, F, I], kv_grid [B, T*F, 2I], kv_f [B, F, 2I] -> out [B, F, I], all
// contiguous bf16. Returns the launch's cudaError_t (0 = launched).
extern "C" int fusion_row_attention_bf16(const void* q, const void* kv_grid, const void* kv_f, void* out,
                                         int batch, int f, int t_mod, int heads, int dh, float scale,
                                         void* stream) {
  if (t_mod < 1 || t_mod + 1 > MAX_SLOTS || heads < 1 || heads > 32) return (int)cudaErrorInvalidValue;
  const bf16* qp = static_cast<const bf16*>(q);
  const bf16* gp = static_cast<const bf16*>(kv_grid);
  const bf16* fp = static_cast<const bf16*>(kv_f);
  bf16* op = static_cast<bf16*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dh) {
    case 32:
      return (int)launch<32>(qp, gp, fp, op, batch, f, t_mod, heads, scale, s);
    case 64:
      return (int)launch<64>(qp, gp, fp, op, batch, f, t_mod, heads, scale, s);
    case 128:
      return (int)launch<128>(qp, gp, fp, op, batch, f, t_mod, heads, scale, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

// Backward: dout [B, F, I] -> dq [B, F, I], dkv_grid [B, T*F, 2I],
// dkv_f [B, F, 2I], all contiguous bf16.
extern "C" int fusion_row_attention_bwd_bf16(const void* q, const void* kv_grid, const void* kv_f,
                                             const void* dout, void* dq, void* dkv_grid, void* dkv_f,
                                             int batch, int f, int t_mod, int heads, int dh, float scale,
                                             void* stream) {
  if (t_mod < 1 || t_mod + 1 > MAX_SLOTS || heads < 1 || heads > 32) return (int)cudaErrorInvalidValue;
  const bf16* qp = static_cast<const bf16*>(q);
  const bf16* gp = static_cast<const bf16*>(kv_grid);
  const bf16* fp = static_cast<const bf16*>(kv_f);
  const bf16* dp = static_cast<const bf16*>(dout);
  bf16* dqp = static_cast<bf16*>(dq);
  bf16* dgp = static_cast<bf16*>(dkv_grid);
  bf16* dfp = static_cast<bf16*>(dkv_f);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dh) {
    case 32:
      return (int)launch_bwd<32>(qp, gp, fp, dp, dqp, dgp, dfp, batch, f, t_mod, heads, scale, s);
    case 64:
      return (int)launch_bwd<64>(qp, gp, fp, dp, dqp, dgp, dfp, batch, f, t_mod, heads, scale, s);
    case 128:
      return (int)launch_bwd<128>(qp, gp, fp, dp, dqp, dgp, dfp, batch, f, t_mod, heads, scale, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
