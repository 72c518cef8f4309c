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
// tensor cores -- two in the forward, seven in the backward's two kernels
// -- plus the softmax on the CUDA cores; the bytes are only q/k/v/out and
// their gradients (a few to a few tens of MB). The [N, N] scores, the mask
// and the probabilities never leave the SM, which is what the Pallas kernels
// kept in VMEM. Since the tensor cores are far from their peak at these
// sizes, what bounds the kernels is issue and latency: the design keeps
// every accumulator in registers, feeds the tensor cores with wgmma, and
// overlaps each tile's loads with the previous tile's work.
//
// Forward design (zorro_attention.cuh): one warpgroup (4 warps) per
// (64-row query tile, head, batch row). Per active key tile of 64:
//   * S = Q K^T by wgmma m64n64k16 with Q and K in shared memory (both
//     K-major) and the f32 accumulator in registers: a thread holds 2 rows
//     x 16 keys;
//   * scale and mask on that fragment: s * scale * log2(e), then masked
//     keys to the finite NEG_INF = -0.7 * FLT_MAX (pallas_attn.py:37) and
//     keys past N to -inf, so no masked score can overflow to -inf and make
//     -inf - (-inf) = NaN; online softmax in f32 with the row max by two
//     quad shuffles, exp2f, and a thread-partial row sum reduced once at
//     the end;
//   * P = exp2(s - m) converted in registers to bf16 A fragments (the
//     accumulator layout of S is the A layout of the next product) and
//     O += P V by wgmma m64nDHk16 with A from registers and V MN-major in
//     shared memory (the transpose bit); O stays in registers and is
//     rescaled there by exp2(m_old - m_new).
// The epilogue divides by the row sum, stages O as bf16 in the Q tile and
// stores it 16 bytes a thread; lse = m ln 2 + ln l when asked for. A row
// whose first key tiles are all masked has m = NEG_INF with weights
// exp2(0) = 1 until its first real key, whose correction exp2(NEG_INF -
// m_new) = 0 clears them. Self-attention rows are never empty.
//
// Copies: cp.async (16 bytes a thread, zero-filled past N) into a ring of
// two stages: tile k + 1's K, V and key types load while tile k computes;
// cp.async.wait_group, fence.proxy.async (the copies are generic-proxy
// writes, wgmma reads through the async proxy) and one barrier of the
// warpgroup per tile. Not TMA: the operands are strided column slices of
// three views (slab, separate q/k/v, the gradient view) at any N; tensor
// maps would be encoded on the host per call and per view (the host work
// that phase 3 showed to matter), and a single warpgroup issues the copies
// of a 64-row tile in a few instructions a thread. The tiles are written
// in wgmma's swizzled layout (128-byte rows, 64-byte for dh 32; dh 128 as
// two 64-column blocks), so the loads, the products and the epilogue's
// staging are free of bank conflicts.
//
// Tile-skip mode: a skipped key tile is never loaded and adds nothing to
// the running max or sum, which a masked tile would not change either
// (exp2(NEG_INF - m) = 0). The diagonal tile is always active, so no row
// is empty; a PAD query row sees only the PAD keys of the active tiles, as
// on the TPU. The TPU kernel made two passes over the active tiles (max,
// then exp and P.V); the online softmax needs one.
//
// Backward design: no atomics, two kernels, so the gradients are bitwise
// the same from run to run. P is recomputed from the forward's lse as
// exp2(s * scale * log2(e) (masked) - lse * log2(e)).
//   * dq kernel, one warpgroup per (query tile, head, batch row): first
//     D = rowsum(dO * O) in f32 for its rows, two threads a row with
//     16-byte loads (pallas_attn.py:552), stored for the second kernel
//     (K6b passes its own D instead: delta_given); then per key tile S =
//     Q K^T and dP = dO V^T (wgmma, Q, dO, K, V in shared memory, two
//     groups: P is computed on the fragment while dP is in flight), dS =
//     P (dP - D) cast to bf16 A fragments, dQ += dS K by wgmma with K
//     MN-major; dQ * scale written at the end.
//   * dk/dv kernel, one warpgroup per (key tile, head, batch row), launched
//     after it on the same stream: per query tile S^T = K Q^T and dP^T =
//     V dO^T, so the keys are the rows of every fragment (P^T computed
//     while dP^T is in flight); P^T and dS^T = P^T (dP^T - D) are cast to
//     bf16 A fragments in registers, then dV += P^T dO and dK += dS^T Q by
//     wgmma with dO and Q MN-major. dK * scale and dV are written at the
//     end. At dh 64 the masked kernel is capped at 168 registers, three
//     blocks an SM (about 190 registers and two blocks uncapped), which
//     made it faster on an H100 (tools/ptxas_report.py and chip_smoke.py
//     phase 3).
//   Computing the transposed scores in the dk/dv kernel puts every B
//   operand in shared memory in a layout wgmma takes, so no product needs
//   mma.sync and nothing but the loaded tiles is staged in shared memory.
//   Each kernel double-buffers its streamed tiles (K, V and key types; or
//   Q, dO and the query types, lse and D) by cp.async as the forward does.
// The accumulators live in registers across the whole loop: O (forward),
// dQ (dq kernel), dK and dV (dk/dv kernel). Each block writes straight
// into its strided column slice of the gradient view (one [B, N, 3I] dqkv,
// or three [B, N, I] tensors), 16 bytes a thread, through the tile it no
// longer needs.
//
// Small batch: serving and segmentation at B = 1, N = 1024, 3 heads give
// 48 forward blocks for 132 SMs. The key range is not split across blocks:
// that would add a merge of the partial (m, l, O) -- a second launch or a
// last-block merge -- to a forward of about 16 key tiles per block, and
// those paths idle the card 70-87% of their time on the host's launch work
// (PERF.md section 5), which one more launch per layer would add to.
//
// cudaFuncSetAttribute runs once per kernel instantiation and device
// (allow_smem), not per launch.
//
// f32: zorro_attention_f32 and zorro_attention_bwd_f32 take the same views
// in f32 (zorro_attention_f32.cuh: the same mask, quirks and two-kernel
// backward, every product and sum in f32 on the CUDA cores).
#include "zorro_attention.cuh"
#include "zorro_attention_f32.cuh"

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

// The f32 instances: the same arguments as zorro_attention_bf16 and
// zorro_attention_bwd_bf16, every tensor but types and the table f32.
extern "C" int zorro_attention_f32(const void* q, const void* k, const void* v, long long bstride,
                                   long long rstride, const void* types, const void* active, int nt, void* out,
                                   void* lse, int batch, int n, int heads, int dh, long long out_bstride,
                                   long long out_rstride, long long types_bstride, float scale, int fusion_type,
                                   int masked, void* stream) {
  const zorro::Operands32 in{static_cast<const float*>(q), static_cast<const float*>(k),
                             static_cast<const float*>(v), bstride, rstride};
  const int32_t* t = static_cast<const int32_t*>(types);
  const int32_t* a = static_cast<const int32_t*>(active);
  float* o = static_cast<float*>(out);
  float* l = static_cast<float*>(lse);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (masked)
    return (int)zorro::dispatch_f32<zorro::MODE_ZORRO>(dh, in, t, a, nt, o, l, batch, n, heads, out_bstride,
                                                       out_rstride, types_bstride, scale, fusion_type, s);
  return (int)zorro::dispatch_f32<zorro::MODE_NONE>(dh, in, t, a, nt, o, l, batch, n, heads, out_bstride,
                                                    out_rstride, types_bstride, scale, fusion_type, s);
}

extern "C" int zorro_attention_bwd_f32(const void* q, const void* k, const void* v, long long bstride,
                                       long long rstride, const void* types, const void* active, int nt,
                                       const void* o, const void* lse, const void* dout, void* dq, void* dk,
                                       void* dv, long long g_bstride, long long g_rstride, void* delta, int batch,
                                       int n, int heads, int dh, long long types_bstride, float scale,
                                       int fusion_type, int masked, void* stream) {
  const zorro::Operands32 in{static_cast<const float*>(q), static_cast<const float*>(k),
                             static_cast<const float*>(v), bstride, rstride};
  const zorro::GradOperands32 grad{static_cast<float*>(dq), static_cast<float*>(dk), static_cast<float*>(dv),
                                   g_bstride, g_rstride};
  const int32_t* t = static_cast<const int32_t*>(types);
  const int32_t* a = static_cast<const int32_t*>(active);
  const float* op = static_cast<const float*>(o);
  const float* l = static_cast<const float*>(lse);
  const float* d = static_cast<const float*>(dout);
  float* dl = static_cast<float*>(delta);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (masked)
    return (int)zorro::dispatch_bwd_f32<zorro::MODE_ZORRO>(dh, in, t, a, nt, op, l, d, grad, dl, batch, n, heads,
                                                           types_bstride, scale, fusion_type, s);
  return (int)zorro::dispatch_bwd_f32<zorro::MODE_NONE>(dh, in, t, a, nt, op, l, d, grad, dl, batch, n, heads,
                                                        types_bstride, scale, fusion_type, s);
}

// Dynamic shared memory of one block, in bytes: kernel 0 the forward, 1 the
// dq kernel, 2 the dk/dv kernel; -1 for a dh it does not take.
extern "C" long long zorro_attention_smem_bytes(int kernel, int dh) {
  switch (dh * 4 + kernel) {
    case 32 * 4 + 0: return zorro::FwdSmem<32>::BYTES;
    case 32 * 4 + 1: return zorro::DqSmem<32>::BYTES;
    case 32 * 4 + 2: return zorro::DkdvSmem<32>::BYTES;
    case 64 * 4 + 0: return zorro::FwdSmem<64>::BYTES;
    case 64 * 4 + 1: return zorro::DqSmem<64>::BYTES;
    case 64 * 4 + 2: return zorro::DkdvSmem<64>::BYTES;
    case 128 * 4 + 0: return zorro::FwdSmem<128>::BYTES;
    case 128 * 4 + 1: return zorro::DqSmem<128>::BYTES;
    case 128 * 4 + 2: return zorro::DkdvSmem<128>::BYTES;
    default: return -1;
  }
}
