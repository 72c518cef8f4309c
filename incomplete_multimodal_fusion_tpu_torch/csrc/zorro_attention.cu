// K1: zorro_attention -- flash-style multi-head self-attention with the
// Zorro token-type mask built per tile (mode ZORRO) or no mask at all (mode
// NONE), and its backward (K1b). The tile loops live in zorro_attention.cuh.
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
//   * ops/pallas_attn.py _fwd_kernel_packed (pallas_call in
//     _zorro_attention_packed): zorro attention on separate q, k, v
//     [B, N, H*dh] -- the same kernel on another operand view;
//   * ops/pallas_zorro_sparse.py _fwd_kernel (pallas_call in _fwd_impl):
//     block-sparse zorro attention that skips the 128 x 128 tiles its
//     activity table marks dead -- the same kernel with a tile-skip table;
//   backward
//   * ops/pallas_attn.py _bwd_kernel_packed_qkv (pallas_call in
//     _packed_qkv_bwd): one dqkv of the packed form;
//   * ops/pallas_attn.py _bwd_kernel / _bwd_kernel_tiled (pallas_call in
//     _bwd): dq, dk, dv of the [B*H, N, dh] form, any N here;
//   * ops/pallas_small_attn.py _bwd_kernel_qkv (pallas_call in
//     _bwd_qkv_rule): the decoder's unmasked backward (mode NONE);
//   * ops/pallas_attn.py _bwd_kernel_packed (pallas_call in _packed_bwd):
//     dq, dk, dv as three tensors;
//   * ops/pallas_zorro_sparse.py _bwd_kernel (pallas_call in _bwd_rule):
//     the block-sparse backward, with the same tile-skip table.
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
// strided column slices of their views, 16 bytes per thread per load.
//
// Tile-skip mode: the TPU kernel made two passes over the active tiles of a
// 128-row tile (max, then exp and P.V). Here the online softmax needs one:
// a skipped key tile is never loaded and adds nothing to the running max or
// sum, which a masked tile would not change either (exp(NEG_INF - m) = 0).
// The diagonal tile is always active, so no row is empty; a PAD query row
// sees only the PAD keys of the active tiles, as on the TPU.
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
// Each block writes straight into its strided column slice of the gradient
// view (one [B, N, 3I] dqkv, or three [B, N, I] tensors). Simple and correct
// first: no TMA, no wgmma, no pipelining of the next tile.
#include "zorro_attention.cuh"

using zorro::bf16;

// q, k, v: the operand view (base pointers, batch and token strides in
// elements); masked != 0: zorro mask from types (int32 [B, N]), masked == 0:
// no mask, types unused; active: int32 [B, nt * nt] activity table of the
// 128-token tiles, or null; out [B, N, H * dh] with the given strides; lse:
// f32 [B, H, N] row log-sum-exp, or null. Returns the launch's cudaError_t
// (0 = launched).
extern "C" int zorro_attention_bf16(const void* q, const void* k, const void* v, long long bstride,
                                    long long rstride, const void* types, const void* active, int nt, void* out,
                                    void* lse, int batch, int n, int heads, int dh, long long out_bstride,
                                    long long out_rstride, long long types_bstride, float scale, int fusion_type,
                                    int masked, void* stream) {
  const zorro::Operands in{static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
                           bstride, rstride};
  const int32_t* t = static_cast<const int32_t*>(types);
  const int32_t* a = static_cast<const int32_t*>(active);
  bf16* o = static_cast<bf16*>(out);
  float* l = static_cast<float*>(lse);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (masked)
    return (int)zorro::dispatch<zorro::MODE_ZORRO>(dh, in, t, a, nt, o, l, batch, n, heads, out_bstride,
                                                   out_rstride, types_bstride, scale, fusion_type, s);
  return (int)zorro::dispatch<zorro::MODE_NONE>(dh, in, t, a, nt, o, l, batch, n, heads, out_bstride,
                                                out_rstride, types_bstride, scale, fusion_type, s);
}

// Backward: q, k, v the forward's operand view; o and dout contiguous
// [B, N, H * dh] bf16; lse f32 [B, H, N] from the forward; dq, dk, dv the
// gradient view (base pointers, batch and token strides); delta f32
// [B, H, N] scratch; active as in the forward. Two launches on the stream;
// returns the first error.
extern "C" int zorro_attention_bwd_bf16(const void* q, const void* k, const void* v, long long bstride,
                                        long long rstride, const void* types, const void* active, int nt,
                                        const void* o, const void* lse, const void* dout, void* dq, void* dk,
                                        void* dv, long long g_bstride, long long g_rstride, void* delta, int batch,
                                        int n, int heads, int dh, long long types_bstride, float scale,
                                        int fusion_type, int masked, void* stream) {
  const zorro::Operands in{static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
                           bstride, rstride};
  const zorro::GradOperands grad{static_cast<bf16*>(dq), static_cast<bf16*>(dk), static_cast<bf16*>(dv),
                                 g_bstride, g_rstride};
  const int32_t* t = static_cast<const int32_t*>(types);
  const int32_t* a = static_cast<const int32_t*>(active);
  const bf16* op = static_cast<const bf16*>(o);
  const float* l = static_cast<const float*>(lse);
  const bf16* d = static_cast<const bf16*>(dout);
  float* dl = static_cast<float*>(delta);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (masked)
    return (int)zorro::dispatch_bwd<zorro::MODE_ZORRO>(dh, in, t, a, nt, op, l, d, grad, dl, 0, batch, n, heads,
                                                       types_bstride, scale, fusion_type, s);
  return (int)zorro::dispatch_bwd<zorro::MODE_NONE>(dh, in, t, a, nt, op, l, d, grad, dl, 0, batch, n, heads,
                                                    types_bstride, scale, fusion_type, s);
}
