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
//
// The f32 instance (fusion_row_attention_f32, fusion_row_attention_bwd_f32)
// is the same kernels on float elements (Elem<float>: 4 channels a lane by
// 16-byte accesses, DH / 4 lanes a (position, head)), for the f32 paths the
// TPU kernel also takes; its rounding points are no-ops, so every product
// and sum is f32.
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

// The element type's channels a lane (CH, one 16-byte access where VEC),
// their conversions to and from f32, and the rounding to the element type
// at the cast points (none for float)
template <typename E>
struct Elem;

template <>
struct Elem<bf16> {
  static constexpr int CH = 8;
  using Vec = uint4;
  template <bool VEC>
  static __device__ __forceinline__ Vec load(const bf16* p) { return load8<VEC>(p); }
  template <bool VEC>
  static __device__ __forceinline__ void store(bf16* p, Vec v) { store8<VEC>(p, v); }
  static __device__ __forceinline__ void unpack(Vec v, float (&f)[CH]) { unpack8(v, f); }
  static __device__ __forceinline__ Vec pack(const float (&f)[CH]) { return pack8(f); }
  static __device__ __forceinline__ void round(float (&f)[CH]) { round8(f); }
  static __device__ __forceinline__ float round1(float x) { return __bfloat162float(__float2bfloat16(x)); }
};

template <>
struct Elem<float> {
  static constexpr int CH = 4;
  using Vec = float4;
  template <bool VEC>
  static __device__ __forceinline__ Vec load(const float* p) {
    if constexpr (VEC) return *reinterpret_cast<const float4*>(p);
    else return make_float4(p[0], p[1], p[2], p[3]);
  }
  template <bool VEC>
  static __device__ __forceinline__ void store(float* p, Vec v) {
    if constexpr (VEC) {
      *reinterpret_cast<float4*>(p) = v;
    } else {
      p[0] = v.x;
      p[1] = v.y;
      p[2] = v.z;
      p[3] = v.w;
    }
  }
  static __device__ __forceinline__ void unpack(Vec v, float (&f)[CH]) {
    f[0] = v.x;
    f[1] = v.y;
    f[2] = v.z;
    f[3] = v.w;
  }
  static __device__ __forceinline__ Vec pack(const float (&f)[CH]) { return make_float4(f[0], f[1], f[2], f[3]); }
  static __device__ __forceinline__ void round(float (&)[CH]) {}
  static __device__ __forceinline__ float round1(float x) { return x; }
};

// Thread i of the grid owns channels [CH i, CH i + CH) of q and of out (or
// dO and dq), which are channels CH (i % LP) .. of head h of row
// (b, pos), with (b * F + pos) * heads + h = i / LP, LP = DH / CH lanes a
// head (CH = 8 for bf16, 4 for f32). A thread past the end takes the last
// thread's channels and writes nothing; the heads are whole, so its
// shuffles reach no live lane.
template <int DH, int T, int CH>
struct Lane {
  bool live;
  long long ti;  // the thread whose channels these are
  long long kv[T + 1];  // element offset of each slot's k in its row of 2I (slot T: kv_f's)

  __device__ __forceinline__ Lane(long long threads, int f, int heads) {
    const long long i = (long long)blockIdx.x * THREADS + threadIdx.x;
    live = i < threads;
    ti = live ? i : threads - 1;
    const long long unit = ti / (DH / CH), row = unit / heads;  // row = b * F + pos
    const int inner = heads * DH;
    const long long b = row / f, pos = row % f;
    const int c = (int)(unit % heads) * DH + (int)(ti % (DH / CH)) * CH;  // the first channel in a row of I
#pragma unroll
    for (int t = 0; t < T; ++t) kv[t] = (b * T * f + (long long)t * f + pos) * 2 * inner + c;
    kv[T] = row * 2 * inner + c;
  }
};

template <typename E, int DH, int T, bool VEC>
__device__ __forceinline__ void fusion_row_fwd(const E* __restrict__ q, const E* __restrict__ kv_grid,
                                               const E* __restrict__ kv_f, E* __restrict__ out, long long threads,
                                               int f, int heads, float scale) {
  using X = Elem<E>;
  constexpr int CH = X::CH, LP = DH / CH;
  const Lane<DH, T, CH> lane(threads, f, heads);
  const int inner = heads * DH;

  // every load first: q, and each slot's k and v (slot T: the fusion token's own)
  const typename X::Vec q8 = X::template load<VEC>(q + lane.ti * CH);
  typename X::Vec k8[T + 1], v8[T + 1];
#pragma unroll
  for (int t = 0; t <= T; ++t) {
    const E* src = (t < T ? kv_grid : kv_f) + lane.kv[t];
    k8[t] = X::template load<VEC>(src);
    v8[t] = X::template load<VEC>(src + inner);
  }

  // q * scale rounded to the element type, read as f32; keys in f32
  float qs[CH];
  X::unpack(q8, qs);
#pragma unroll
  for (int j = 0; j < CH; ++j) qs[j] *= scale;
  X::round(qs);
  float attn[T + 1];
#pragma unroll
  for (int t = 0; t <= T; ++t) {
    float kf[CH];
    X::unpack(k8[t], kf);
    float s = 0.0f;
#pragma unroll
    for (int j = 0; j < CH; ++j) s += qs[j] * kf[j];
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

  // the mix in the element type: each weight, each product a * v and the
  // running sum (from slot 0 on) rounded to it
  float acc[CH];
#pragma unroll
  for (int t = 0; t <= T; ++t) {
    const float a = X::round1(attn[t] / denom);
    float prod[CH];
    X::unpack(v8[t], prod);
#pragma unroll
    for (int j = 0; j < CH; ++j) prod[j] *= a;
    X::round(prod);
#pragma unroll
    for (int j = 0; j < CH; ++j) acc[j] = t == 0 ? prod[j] : acc[j] + prod[j];
    if (t > 0) X::round(acc);
  }
  if (lane.live) X::template store<VEC>(out + lane.ti * CH, X::pack(acc));
}

template <typename E, int DH, int T>
__global__ void __launch_bounds__(THREADS)
fusion_row_kernel(const E* __restrict__ q, const E* __restrict__ kv_grid, const E* __restrict__ kv_f,
                  E* __restrict__ out, long long threads, int f, int heads, float scale, bool vec) {
  if (vec)
    fusion_row_fwd<E, DH, T, true>(q, kv_grid, kv_f, out, threads, f, heads, scale);
  else
    fusion_row_fwd<E, DH, T, false>(q, kv_grid, kv_f, out, threads, f, heads, scale);
}

template <typename E, int DH, int T>
cudaError_t launch_slots(const E* q, const E* kv_grid, const E* kv_f, E* out, int batch, int f, int heads,
                         float scale, cudaStream_t stream) {
  const long long threads = (long long)batch * f * heads * (DH / Elem<E>::CH);
  // 16-byte accesses where every operand starts on 16 bytes (rows of I and
  // 2I elements keep that alignment: I is a multiple of 32)
  const bool vec = ((uintptr_t)q | (uintptr_t)kv_grid | (uintptr_t)kv_f | (uintptr_t)out) % 16 == 0;
  fusion_row_kernel<E, DH, T><<<(unsigned)((threads + THREADS - 1) / THREADS), THREADS, 0, stream>>>(
      q, kv_grid, kv_f, out, threads, f, heads, scale, vec);
  return cudaGetLastError();
}

template <typename E, int DH>
cudaError_t launch(const E* q, const E* kv_grid, const E* kv_f, E* out, int batch, int f, int t_mod, int heads,
                   float scale, cudaStream_t stream) {
  switch (t_mod) {
#define SLOTS(T) \
  case T:        \
    return launch_slots<E, DH, T>(q, kv_grid, kv_f, out, batch, f, heads, scale, stream);
    SLOTS(1) SLOTS(2) SLOTS(3) SLOTS(4) SLOTS(5) SLOTS(6) SLOTS(7) SLOTS(8)
#undef SLOTS
    default:
      return cudaErrorInvalidValue;
  }
}

template <typename E, int DH, int T, bool VEC>
__device__ __forceinline__ void fusion_row_bwd(const E* __restrict__ q, const E* __restrict__ kv_grid,
                                               const E* __restrict__ kv_f, const E* __restrict__ dout,
                                               E* __restrict__ dq, E* __restrict__ dkv_grid, E* __restrict__ dkv_f,
                                               long long threads, int f, int heads, float scale) {
  using X = Elem<E>;
  constexpr int CH = X::CH, LP = DH / CH;
  const Lane<DH, T, CH> lane(threads, f, heads);
  const int inner = heads * DH;

  // every load first: q, dO, and each slot's k and v (slot T: the fusion token's own)
  const typename X::Vec q8 = X::template load<VEC>(q + lane.ti * CH),
                        do8 = X::template load<VEC>(dout + lane.ti * CH);
  typename X::Vec k8[T + 1], v8[T + 1];
#pragma unroll
  for (int t = 0; t <= T; ++t) {
    const E* src = (t < T ? kv_grid : kv_f) + lane.kv[t];
    k8[t] = X::template load<VEC>(src);
    v8[t] = X::template load<VEC>(src + inner);
  }

  float qs[CH], dos[CH];
  X::unpack(q8, qs);
  X::unpack(do8, dos);
#pragma unroll
  for (int j = 0; j < CH; ++j) qs[j] = X::round1(qs[j] * scale);
  float attn[T + 1], dattn[T + 1];
#pragma unroll
  for (int t = 0; t <= T; ++t) {
    float kf[CH], vf[CH];
    X::unpack(k8[t], kf);
    X::unpack(v8[t], vf);
    float s = 0.0f, da = 0.0f;
#pragma unroll
    for (int j = 0; j < CH; ++j) {
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

  float dqs[CH];
#pragma unroll
  for (int j = 0; j < CH; ++j) dqs[j] = 0.0f;
#pragma unroll
  for (int t = 0; t <= T; ++t) {
    const float ds = attn[t] * (dattn[t] - mix);
    const float ab = X::round1(attn[t]);
    float kf[CH], dk[CH], dv[CH];
    X::unpack(k8[t], kf);
#pragma unroll
    for (int j = 0; j < CH; ++j) {
      dqs[j] += ds * kf[j];
      dk[j] = ds * qs[j];
      dv[j] = ab * dos[j];
    }
    if (lane.live) {
      E* dst = (t < T ? dkv_grid : dkv_f) + lane.kv[t];
      X::template store<VEC>(dst, X::pack(dk));
      X::template store<VEC>(dst + inner, X::pack(dv));
    }
  }
#pragma unroll
  for (int j = 0; j < CH; ++j) dqs[j] *= scale;
  if (lane.live) X::template store<VEC>(dq + lane.ti * CH, X::pack(dqs));
}

template <typename E, int DH, int T>
__global__ void __launch_bounds__(THREADS)
fusion_row_bwd_kernel(const E* __restrict__ q, const E* __restrict__ kv_grid, const E* __restrict__ kv_f,
                      const E* __restrict__ dout, E* __restrict__ dq, E* __restrict__ dkv_grid,
                      E* __restrict__ dkv_f, long long threads, int f, int heads, float scale, bool vec) {
  if (vec)
    fusion_row_bwd<E, DH, T, true>(q, kv_grid, kv_f, dout, dq, dkv_grid, dkv_f, threads, f, heads, scale);
  else
    fusion_row_bwd<E, DH, T, false>(q, kv_grid, kv_f, dout, dq, dkv_grid, dkv_f, threads, f, heads, scale);
}

template <typename E, int DH, int T>
cudaError_t launch_bwd_slots(const E* q, const E* kv_grid, const E* kv_f, const E* dout, E* dq, E* dkv_grid,
                             E* dkv_f, int batch, int f, int heads, float scale, cudaStream_t stream) {
  const long long threads = (long long)batch * f * heads * (DH / Elem<E>::CH);
  // 16-byte accesses where every operand starts on 16 bytes (rows of I and
  // 2I elements keep that alignment: I is a multiple of 32)
  const bool vec = ((uintptr_t)q | (uintptr_t)kv_grid | (uintptr_t)kv_f | (uintptr_t)dout | (uintptr_t)dq |
                    (uintptr_t)dkv_grid | (uintptr_t)dkv_f) % 16 == 0;
  fusion_row_bwd_kernel<E, DH, T><<<(unsigned)((threads + THREADS - 1) / THREADS), THREADS, 0, stream>>>(
      q, kv_grid, kv_f, dout, dq, dkv_grid, dkv_f, threads, f, heads, scale, vec);
  return cudaGetLastError();
}

template <typename E, int DH>
cudaError_t launch_bwd(const E* q, const E* kv_grid, const E* kv_f, const E* dout, E* dq, E* dkv_grid, E* dkv_f,
                       int batch, int f, int t_mod, int heads, float scale, cudaStream_t stream) {
  switch (t_mod) {
#define SLOTS(T) \
  case T:        \
    return launch_bwd_slots<E, DH, T>(q, kv_grid, kv_f, dout, dq, dkv_grid, dkv_f, batch, f, heads, scale, stream);
    SLOTS(1) SLOTS(2) SLOTS(3) SLOTS(4) SLOTS(5) SLOTS(6) SLOTS(7) SLOTS(8)
#undef SLOTS
    default:
      return cudaErrorInvalidValue;
  }
}

// The entries of one element type: dh dispatch
template <typename E>
int forward(const void* q, const void* kv_grid, const void* kv_f, void* out, int batch, int f, int t_mod, int heads,
            int dh, float scale, void* stream) {
  if (t_mod < 1 || t_mod + 1 > MAX_SLOTS || heads < 1) return (int)cudaErrorInvalidValue;
  const E* qp = static_cast<const E*>(q);
  const E* gp = static_cast<const E*>(kv_grid);
  const E* fp = static_cast<const E*>(kv_f);
  E* op = static_cast<E*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dh) {
    case 32:
      return (int)launch<E, 32>(qp, gp, fp, op, batch, f, t_mod, heads, scale, s);
    case 64:
      return (int)launch<E, 64>(qp, gp, fp, op, batch, f, t_mod, heads, scale, s);
    case 128:
      return (int)launch<E, 128>(qp, gp, fp, op, batch, f, t_mod, heads, scale, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

template <typename E>
int backward(const void* q, const void* kv_grid, const void* kv_f, const void* dout, void* dq, void* dkv_grid,
             void* dkv_f, int batch, int f, int t_mod, int heads, int dh, float scale, void* stream) {
  if (t_mod < 1 || t_mod + 1 > MAX_SLOTS || heads < 1) return (int)cudaErrorInvalidValue;
  const E* qp = static_cast<const E*>(q);
  const E* gp = static_cast<const E*>(kv_grid);
  const E* fp = static_cast<const E*>(kv_f);
  const E* dp = static_cast<const E*>(dout);
  E* dqp = static_cast<E*>(dq);
  E* dgp = static_cast<E*>(dkv_grid);
  E* dfp = static_cast<E*>(dkv_f);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dh) {
    case 32:
      return (int)launch_bwd<E, 32>(qp, gp, fp, dp, dqp, dgp, dfp, batch, f, t_mod, heads, scale, s);
    case 64:
      return (int)launch_bwd<E, 64>(qp, gp, fp, dp, dqp, dgp, dfp, batch, f, t_mod, heads, scale, s);
    case 128:
      return (int)launch_bwd<E, 128>(qp, gp, fp, dp, dqp, dgp, dfp, batch, f, t_mod, heads, scale, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// q [B, F, I], kv_grid [B, T*F, 2I], kv_f [B, F, 2I] -> out [B, F, I], all
// contiguous bf16. Returns the launch's cudaError_t (0 = launched).
extern "C" int fusion_row_attention_bf16(const void* q, const void* kv_grid, const void* kv_f, void* out,
                                         int batch, int f, int t_mod, int heads, int dh, float scale,
                                         void* stream) {
  return forward<bf16>(q, kv_grid, kv_f, out, batch, f, t_mod, heads, dh, scale, stream);
}

// Backward: dout [B, F, I] -> dq [B, F, I], dkv_grid [B, T*F, 2I],
// dkv_f [B, F, 2I], all contiguous bf16.
extern "C" int fusion_row_attention_bwd_bf16(const void* q, const void* kv_grid, const void* kv_f,
                                             const void* dout, void* dq, void* dkv_grid, void* dkv_f,
                                             int batch, int f, int t_mod, int heads, int dh, float scale,
                                             void* stream) {
  return backward<bf16>(q, kv_grid, kv_f, dout, dq, dkv_grid, dkv_f, batch, f, t_mod, heads, dh, scale, stream);
}

// The f32 instances: the same operands, all contiguous f32.
extern "C" int fusion_row_attention_f32(const void* q, const void* kv_grid, const void* kv_f, void* out, int batch,
                                        int f, int t_mod, int heads, int dh, float scale, void* stream) {
  return forward<float>(q, kv_grid, kv_f, out, batch, f, t_mod, heads, dh, scale, stream);
}

extern "C" int fusion_row_attention_bwd_f32(const void* q, const void* kv_grid, const void* kv_f, const void* dout,
                                            void* dq, void* dkv_grid, void* dkv_f, int batch, int f, int t_mod,
                                            int heads, int dh, float scale, void* stream) {
  return backward<float>(q, kv_grid, kv_f, dout, dq, dkv_grid, dkv_f, batch, f, t_mod, heads, dh, scale, stream);
}
