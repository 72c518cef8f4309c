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
// What bounds it on an H100: the forward does (T + 1) * 4 * dh flops per
// (position, head) on (1 + 2(T + 1)) * dh * 2 bytes, under one flop per byte,
// so it is bound by HBM bandwidth: the whole kv grid is read once. The
// backward (K3b) is bound the same way: it reads q, the grid, kv_f and dO
// once and writes dq, dkv_grid and dkv_f once (112 MB at B = 60, F = 256,
// T = 3, 3 x 64), under two flops a byte. Per (batch, position, head) it
// recomputes the slot sims and the softmax, forms dattn_t = dO . v_t in f32,
// ds_t = attn_t (dattn_t - sum_s attn_s dattn_s), and writes
// dq = sum_t ds_t k_t * scale, dk_t = ds_t * qh and dv_t = bf16(attn_t) * dO
// rounded to bf16, the cast points of pallas_fusion_attn.py:95-126. Every
// output element has one writer, so there are no atomics.
//
// So both move every operand once, with many bytes in flight: a lane owns
// 8 contiguous channels and moves them by 16-byte loads and stores, DH / 8
// lanes serve one (position, head) and reduce over shuffles, every thread
// issues all of its loads (q, each slot's k and v, and the backward's dO)
// before its first reduction (T is a template parameter, so the rows stay
// in registers), and 256-thread blocks cover 256 x 8 / DH (position, head)
// pairs, whatever the head count. Where an operand does not start on 16
// bytes the same kernels move the channels 2 bytes at a time. (A warp a
// (position, head), 2-byte accesses and each slot's loads feeding two warp
// reductions before the next slot's were needed kept few bytes in flight:
// 41-43% of the HBM rate of an H100.)
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"

using bf16 = __nv_bfloat16;

namespace {

constexpr int MAX_SLOTS = 9;  // T + 1 <= 9
constexpr int THREADS = 256;

// 8 bf16 channels from p: one 16-byte load where VEC, else eight 2-byte loads
template <bool VEC>
__device__ __forceinline__ uint4 load8(const bf16* p) {
  if constexpr (VEC) {
    return *reinterpret_cast<const uint4*>(p);
  } else {
    const unsigned short* s = reinterpret_cast<const unsigned short*>(p);
    return make_uint4(s[0] | (unsigned)s[1] << 16, s[2] | (unsigned)s[3] << 16, s[4] | (unsigned)s[5] << 16,
                      s[6] | (unsigned)s[7] << 16);
  }
}

// 8 bf16 channels to p, as load8 reads them
template <bool VEC>
__device__ __forceinline__ void store8(bf16* p, uint4 v) {
  if constexpr (VEC) {
    *reinterpret_cast<uint4*>(p) = v;
  } else {
    unsigned short* s = reinterpret_cast<unsigned short*>(p);
    const unsigned w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      s[2 * i] = (unsigned short)(w[i] & 0xffffu);
      s[2 * i + 1] = (unsigned short)(w[i] >> 16);
    }
  }
}

// the 8 bf16 of v as floats, channel order
__device__ __forceinline__ void unpack8(uint4 v, float (&f)[8]) {
  const unsigned w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    f[2 * i] = __uint_as_float(w[i] << 16);
    f[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
  }
}

// 8 floats rounded to bf16, as unpack8 reads them
__device__ __forceinline__ uint4 pack8(const float (&f)[8]) {
  return make_uint4(hopper::pack_bf16(f[0], f[1]), hopper::pack_bf16(f[2], f[3]), hopper::pack_bf16(f[4], f[5]),
                    hopper::pack_bf16(f[6], f[7]));
}

// the 8 floats rounded to bf16 and read back, two a conversion
__device__ __forceinline__ void round8(float (&f)[8]) {
  unpack8(pack8(f), f);
}

// Thread i of the grid owns channels [8 i, 8 i + 8) of q and of out (or
// dO and dq), which are channels 8 (i % LP) .. of head h of row
// (b, pos), with (b * F + pos) * heads + h = i / LP, LP = DH / 8 lanes a
// head. A thread past the end takes the last thread's channels and writes
// nothing; the heads are whole, so its shuffles reach no live lane.
template <int DH, int T>
struct Lane {
  bool live;
  long long ti;  // the thread whose channels these are
  long long kv[T + 1];  // element offset of each slot's k in its row of 2I (slot T: kv_f's)

  __device__ __forceinline__ Lane(long long threads, int f, int heads) {
    const long long i = (long long)blockIdx.x * THREADS + threadIdx.x;
    live = i < threads;
    ti = live ? i : threads - 1;
    const long long unit = ti / (DH / 8), row = unit / heads;  // row = b * F + pos
    const int inner = heads * DH;
    const long long b = row / f, pos = row % f;
    const int c = (int)(unit % heads) * DH + (int)(ti % (DH / 8)) * 8;  // the first channel in a row of I
#pragma unroll
    for (int t = 0; t < T; ++t) kv[t] = (b * T * f + (long long)t * f + pos) * 2 * inner + c;
    kv[T] = row * 2 * inner + c;
  }
};

template <int DH, int T, bool VEC>
__device__ __forceinline__ void fusion_row_fwd(const bf16* __restrict__ q, const bf16* __restrict__ kv_grid,
                                               const bf16* __restrict__ kv_f, bf16* __restrict__ out,
                                               long long threads, int f, int heads, float scale) {
  constexpr int LP = DH / 8;
  const Lane<DH, T> lane(threads, f, heads);
  const int inner = heads * DH;

  // every load first: q, and each slot's k and v (slot T: the fusion token's own)
  const uint4 q8 = load8<VEC>(q + lane.ti * 8);
  uint4 k8[T + 1], v8[T + 1];
#pragma unroll
  for (int t = 0; t <= T; ++t) {
    const bf16* src = (t < T ? kv_grid : kv_f) + lane.kv[t];
    k8[t] = load8<VEC>(src);
    v8[t] = load8<VEC>(src + inner);
  }

  // q * scale rounded to bf16, read as f32; keys in f32
  float qs[8];
  unpack8(q8, qs);
#pragma unroll
  for (int j = 0; j < 8; ++j) qs[j] *= scale;
  round8(qs);
  float attn[T + 1];
#pragma unroll
  for (int t = 0; t <= T; ++t) {
    float kf[8];
    unpack8(k8[t], kf);
    float s = 0.0f;
#pragma unroll
    for (int j = 0; j < 8; ++j) s += qs[j] * kf[j];
    attn[t] = s;
  }
  // the sums over the head's LP lanes
#pragma unroll
  for (int o = LP / 2; o > 0; o >>= 1)
#pragma unroll
    for (int t = 0; t <= T; ++t) attn[t] += __shfl_xor_sync(0xffffffffu, attn[t], o);
  float mx = -3.0e38f;
#pragma unroll
  for (int t = 0; t <= T; ++t) mx = fmaxf(mx, attn[t]);
  float denom = 0.0f;
#pragma unroll
  for (int t = 0; t <= T; ++t) {
    attn[t] = expf(attn[t] - mx);
    denom += attn[t];
  }

  // the mix in bf16: each weight, each product a * v and the running sum
  // (from slot 0 on) rounded to bf16
  float acc[8];
#pragma unroll
  for (int t = 0; t <= T; ++t) {
    const float a = __bfloat162float(__float2bfloat16(attn[t] / denom));
    float prod[8];
    unpack8(v8[t], prod);
#pragma unroll
    for (int j = 0; j < 8; ++j) prod[j] *= a;
    round8(prod);
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[j] = t == 0 ? prod[j] : acc[j] + prod[j];
    if (t > 0) round8(acc);
  }
  if (lane.live) store8<VEC>(out + lane.ti * 8, pack8(acc));
}

template <int DH, int T>
__global__ void __launch_bounds__(THREADS)
fusion_row_kernel(const bf16* __restrict__ q, const bf16* __restrict__ kv_grid, const bf16* __restrict__ kv_f,
                  bf16* __restrict__ out, long long threads, int f, int heads, float scale, bool vec) {
  if (vec)
    fusion_row_fwd<DH, T, true>(q, kv_grid, kv_f, out, threads, f, heads, scale);
  else
    fusion_row_fwd<DH, T, false>(q, kv_grid, kv_f, out, threads, f, heads, scale);
}

template <int DH, int T>
cudaError_t launch_slots(const bf16* q, const bf16* kv_grid, const bf16* kv_f, bf16* out, int batch, int f,
                         int heads, float scale, cudaStream_t stream) {
  const long long threads = (long long)batch * f * heads * (DH / 8);
  // 16-byte accesses where every operand starts on 16 bytes (rows of I and
  // 2I bf16 keep that alignment: I is a multiple of 32)
  const bool vec = ((uintptr_t)q | (uintptr_t)kv_grid | (uintptr_t)kv_f | (uintptr_t)out) % 16 == 0;
  fusion_row_kernel<DH, T><<<(unsigned)((threads + THREADS - 1) / THREADS), THREADS, 0, stream>>>(
      q, kv_grid, kv_f, out, threads, f, heads, scale, vec);
  return cudaGetLastError();
}

template <int DH>
cudaError_t launch(const bf16* q, const bf16* kv_grid, const bf16* kv_f, bf16* out, int batch, int f, int t_mod,
                   int heads, float scale, cudaStream_t stream) {
  switch (t_mod) {
#define SLOTS(T) \
  case T:        \
    return launch_slots<DH, T>(q, kv_grid, kv_f, out, batch, f, heads, scale, stream);
    SLOTS(1) SLOTS(2) SLOTS(3) SLOTS(4) SLOTS(5) SLOTS(6) SLOTS(7) SLOTS(8)
#undef SLOTS
    default:
      return cudaErrorInvalidValue;
  }
}

template <int DH, int T, bool VEC>
__device__ __forceinline__ void fusion_row_bwd(const bf16* __restrict__ q, const bf16* __restrict__ kv_grid,
                                               const bf16* __restrict__ kv_f, const bf16* __restrict__ dout,
                                               bf16* __restrict__ dq, bf16* __restrict__ dkv_grid,
                                               bf16* __restrict__ dkv_f, long long threads, int f, int heads,
                                               float scale) {
  constexpr int LP = DH / 8;
  const Lane<DH, T> lane(threads, f, heads);
  const int inner = heads * DH;

  // every load first: q, dO, and each slot's k and v (slot T: the fusion token's own)
  const uint4 q8 = load8<VEC>(q + lane.ti * 8), do8 = load8<VEC>(dout + lane.ti * 8);
  uint4 k8[T + 1], v8[T + 1];
#pragma unroll
  for (int t = 0; t <= T; ++t) {
    const bf16* src = (t < T ? kv_grid : kv_f) + lane.kv[t];
    k8[t] = load8<VEC>(src);
    v8[t] = load8<VEC>(src + inner);
  }

  float qs[8], dos[8];
  unpack8(q8, qs);
  unpack8(do8, dos);
#pragma unroll
  for (int j = 0; j < 8; ++j) qs[j] = __bfloat162float(__float2bfloat16(qs[j] * scale));
  float attn[T + 1], dattn[T + 1];
#pragma unroll
  for (int t = 0; t <= T; ++t) {
    float kf[8], vf[8];
    unpack8(k8[t], kf);
    unpack8(v8[t], vf);
    float s = 0.0f, da = 0.0f;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      s += qs[j] * kf[j];
      da += dos[j] * vf[j];
    }
    attn[t] = s;
    dattn[t] = da;
  }
  // the sums over the head's LP lanes
#pragma unroll
  for (int o = LP / 2; o > 0; o >>= 1)
#pragma unroll
    for (int t = 0; t <= T; ++t) {
      attn[t] += __shfl_xor_sync(0xffffffffu, attn[t], o);
      dattn[t] += __shfl_xor_sync(0xffffffffu, dattn[t], o);
    }
  float mx = -3.0e38f;
#pragma unroll
  for (int t = 0; t <= T; ++t) mx = fmaxf(mx, attn[t]);
  float denom = 0.0f;
#pragma unroll
  for (int t = 0; t <= T; ++t) {
    attn[t] = expf(attn[t] - mx);
    denom += attn[t];
  }
  float mix = 0.0f;
#pragma unroll
  for (int t = 0; t <= T; ++t) {
    attn[t] /= denom;
    mix += attn[t] * dattn[t];
  }

  float dqs[8];
#pragma unroll
  for (int j = 0; j < 8; ++j) dqs[j] = 0.0f;
#pragma unroll
  for (int t = 0; t <= T; ++t) {
    const float ds = attn[t] * (dattn[t] - mix);
    const float ab = __bfloat162float(__float2bfloat16(attn[t]));
    float kf[8], dk[8], dv[8];
    unpack8(k8[t], kf);
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      dqs[j] += ds * kf[j];
      dk[j] = ds * qs[j];
      dv[j] = ab * dos[j];
    }
    if (lane.live) {
      bf16* dst = (t < T ? dkv_grid : dkv_f) + lane.kv[t];
      store8<VEC>(dst, pack8(dk));
      store8<VEC>(dst + inner, pack8(dv));
    }
  }
#pragma unroll
  for (int j = 0; j < 8; ++j) dqs[j] *= scale;
  if (lane.live) store8<VEC>(dq + lane.ti * 8, pack8(dqs));
}

template <int DH, int T>
__global__ void __launch_bounds__(THREADS)
fusion_row_bwd_kernel(const bf16* __restrict__ q, const bf16* __restrict__ kv_grid, const bf16* __restrict__ kv_f,
                      const bf16* __restrict__ dout, bf16* __restrict__ dq, bf16* __restrict__ dkv_grid,
                      bf16* __restrict__ dkv_f, long long threads, int f, int heads, float scale, bool vec) {
  if (vec)
    fusion_row_bwd<DH, T, true>(q, kv_grid, kv_f, dout, dq, dkv_grid, dkv_f, threads, f, heads, scale);
  else
    fusion_row_bwd<DH, T, false>(q, kv_grid, kv_f, dout, dq, dkv_grid, dkv_f, threads, f, heads, scale);
}

template <int DH, int T>
cudaError_t launch_bwd_slots(const bf16* q, const bf16* kv_grid, const bf16* kv_f, const bf16* dout, bf16* dq,
                             bf16* dkv_grid, bf16* dkv_f, int batch, int f, int heads, float scale,
                             cudaStream_t stream) {
  const long long threads = (long long)batch * f * heads * (DH / 8);
  // 16-byte accesses where every operand starts on 16 bytes (rows of I and
  // 2I bf16 keep that alignment: I is a multiple of 32)
  const bool vec = ((uintptr_t)q | (uintptr_t)kv_grid | (uintptr_t)kv_f | (uintptr_t)dout | (uintptr_t)dq |
                    (uintptr_t)dkv_grid | (uintptr_t)dkv_f) % 16 == 0;
  fusion_row_bwd_kernel<DH, T><<<(unsigned)((threads + THREADS - 1) / THREADS), THREADS, 0, stream>>>(
      q, kv_grid, kv_f, dout, dq, dkv_grid, dkv_f, threads, f, heads, scale, vec);
  return cudaGetLastError();
}

template <int DH>
cudaError_t launch_bwd(const bf16* q, const bf16* kv_grid, const bf16* kv_f, const bf16* dout, bf16* dq,
                       bf16* dkv_grid, bf16* dkv_f, int batch, int f, int t_mod, int heads, float scale,
                       cudaStream_t stream) {
  switch (t_mod) {
#define SLOTS(T) \
  case T:        \
    return launch_bwd_slots<DH, T>(q, kv_grid, kv_f, dout, dq, dkv_grid, dkv_f, batch, f, heads, scale, stream);
    SLOTS(1) SLOTS(2) SLOTS(3) SLOTS(4) SLOTS(5) SLOTS(6) SLOTS(7) SLOTS(8)
#undef SLOTS
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// q [B, F, I], kv_grid [B, T*F, 2I], kv_f [B, F, 2I] -> out [B, F, I], all
// contiguous bf16. Returns the launch's cudaError_t (0 = launched).
extern "C" int fusion_row_attention_bf16(const void* q, const void* kv_grid, const void* kv_f, void* out,
                                         int batch, int f, int t_mod, int heads, int dh, float scale,
                                         void* stream) {
  if (t_mod < 1 || t_mod + 1 > MAX_SLOTS || heads < 1) return (int)cudaErrorInvalidValue;
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
  if (t_mod < 1 || t_mod + 1 > MAX_SLOTS || heads < 1) return (int)cudaErrorInvalidValue;
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
