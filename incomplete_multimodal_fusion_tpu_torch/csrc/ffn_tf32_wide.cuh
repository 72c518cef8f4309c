// The wide path of K2 / K2b's f32 instance: d or d_out past 256 (the `base`
// and `large` widths, d = 768 and 1024), on the tensor cores with
// ffn_tf32.cuh's arithmetic. The same functions as ffn_tf32.cuh's row
// kernels (ops/pallas_ffn.py _ffn_fwd_impl, _mlp_fwd_impl, _ffn_bwd,
// _mlp_bwd with f32 operands), which keep y (or dx) [64 x d_out] in
// registers: 384 floats a thread at d_out = 768, more than a thread has. So
// here the products go through device memory, the shape of bf16 K2's wide
// path (fused_ffn.cu):
//   forward  GEGLU: xn = LN(x) (simt_f32's LayerNorm), a = val gelu(gate) of
//            u = xn W_in^T, y = a W_out^T; MLP: a = gelu(x W1^T + b1),
//            y = a W2^T + b2. The activation goes to an f32 [M, I]
//            workspace (one write and one read: about 0.04 ms at `base`, M =
//            8192, against a 0.47 ms bound);
//   backward the row pass's products, each on the tensor cores: u
//            recomputed and da = dy W_out in one kernel that forms du (dh)
//            and a and stores them transposed; then one launch of three
//            products, dxn = du W_in (MLP: dx = dh W1) and the two weight
//            gradients over ranges of rows as partials; the LayerNorm's
//            backward (simt_f32's); one fixed-order reduction.
//
// Every product is one kernel body, wide_product: a 128-row tile (two
// warpgroups of 64 rows) by N = 128 (or 64) columns of C = A B^T over
// windows of 32 of the contraction, A and B both raw f32 in device memory
// with the contraction contiguous in B's rows and in A's rows or columns:
//   * a ring of WS stages of raw windows by cp.async (A [128 x 32] in the
//     raw layout of ffn_tf32.cuh's row tiles, or, for an A stored with its
//     rows contiguous (dy, xn, x and the transposed workspaces, read as
//     their transposes), [32 x 128] with a padded stride; B [N x 32] in the
//     128-byte swizzle);
//   * TF32 wgmma reads B only K-major from shared memory. A weight is split
//     once a call into TF32 hi and lo parts in device memory (with the
//     transposes below, one launch), whose windows land in the stage as
//     they are read (one barrier a window); a B that is a workspace (the
//     weight gradients' du^T, a^T) comes raw and is split into hi and lo
//     tiles in shared memory (double-buffered: the next window's split runs
//     while this window's products do). A's fragments are read raw and split
//     in registers (A from registers);
//   * each window's 4 k-steps x 3 products (hi lo, lo hi, hi hi) go into a
//     fresh accumulator, added to the tile's in f32 (round to nearest): the
//     tensor core rounds each sum toward zero;
//   * W_out's split rows are padded to the hidden width hp (a multiple of
//     64, or 128 for the MLP), so they start on 16 bytes whatever the inner
//     width (`large`'s 2730).
// The weights that a backward product needs with the contraction along
// their columns (W_out^T for da, W_in^T for dxn) are transposed as they are
// split, zero-padded to hp: the padded hidden units give a = 0 and du = 0,
// so the padding is exact, and the inner width runs unpadded in the
// weights.
// Where the output product's tiles fill under half of the SMs (serving: at
// M = 1024 `base`'s y is 8 x 6 tiles) its hidden width is split over blocks,
// each storing an f32 partial, summed in order by ffn_tf32_fwd_reduce_kernel.
// No atomics: two calls are bitwise equal.
// What bounds it on an H100: the products, 6 (forward) and 16 (backward)
// flops a row, d and hidden unit for GEGLU, three times over at the dense
// TF32 rate (495 TFLOP/s, 165 in effect); then the windows' traffic from
// L2 (32 KB a window a block: about 1.6 GB at `base`'s forward hidden pass).
#pragma once

#include "ffn_tf32.cuh"

namespace ffn_tf32 {

constexpr int WB = 128;  // rows (and B rows) of a wide tile: two warpgroups of 64 rows
constexpr int WT = 256;  // threads of a wide block
constexpr int WS = 4;    // stages of the window ring
constexpr int TS = WB + 8;  // row stride (floats) of a transposed A window: conflict-free fragment reads
constexpr uint32_t B_TILE = WB * KU * 4;       // a B window, raw or one of its split halves (16 KB)
constexpr uint32_t SPLIT_BYTES = 2 * B_TILE;   // a split B window: hi, then lo
constexpr int WIDE_HW_GEGLU = 64;              // hidden units a GEGLU block (val and gate: 128 B rows)
constexpr int WIDE_HW_MLP = 128;               // hidden units an MLP forward block

// A: element (r, k) of a [rows x k] operand at p[r ld + k] (AT = 0) or
// p[k ld + r] (AT = 1: stored transposed); rows past `rows` and columns
// past `k` read as zeros (AT = 1: `rows` a multiple of 4)
struct WideA {
  const float* p;
  long long ld;
  int rows, k;
};

// B: row r of a tile at unit u0 + r (r < split) or u0 + r - split, read
// from row unit (+ off1 for the second half: GEGLU's gate rows) of p (ld);
// units past `limit` and columns past `k` read as zeros; ld and k are
// multiples of 4 (16-byte copies). lo: B pre-split (p its TF32 hi parts, lo
// its lo parts, one layout), or null: p raw f32.
struct WideB {
  const float* p;
  long long ld;
  int limit, split, off1, k;
  const float* lo;
};

template <int AT>
__host__ __device__ constexpr uint32_t wide_a_bytes() {
  return AT ? KU * TS * 4 : WB * KU * 4;
}

template <int AT>
__host__ __device__ constexpr uint32_t wide_stage() {
  return wide_a_bytes<AT>() + B_TILE;
}

// Shared memory of a wide block: the two split B buffers, then the ring (a
// pre-split B: the ring alone, a stage holding B's hi and lo tiles: the
// same bytes)
template <int AT>
__host__ __device__ constexpr uint32_t wide_smem() {
  return 2 * SPLIT_BYTES + WS * wide_stage<AT>() + 1024;
}

__host__ __device__ inline int wide_windows(int k) { return (k + KU - 1) / KU; }

template <int AT>
__device__ __forceinline__ void wide_load_a(uint32_t dst, const WideA& a, int m0, int k0) {
#pragma unroll
  for (int it = 0; it < WB * KU / 4 / WT; ++it) {
    const int i = it * WT + threadIdx.x;
    if constexpr (AT) {
      const int kk = i / (WB / 4), r = 4 * (i % (WB / 4)), k = k0 + kk;
      const bool in = k < a.k && m0 + r < a.rows;
      cp_async16(dst + 4 * (kk * TS + r), a.p + (in ? (long long)k * a.ld + m0 + r : 0), in);
    } else {
      const int r = i / (KU / 4), c = 4 * (i % (KU / 4)), k = k0 + c;
      const bool in = m0 + r < a.rows && k < a.k;
      cp_async16(dst + 4 * raw_index(r, c, KU), a.p + (in ? (long long)(m0 + r) * a.ld + k : 0), in);
    }
  }
}

template <int N>
__device__ __forceinline__ void wide_load_b(uint32_t dst, const WideB& b, int u0, int k0) {
#pragma unroll
  for (int it = 0; it < N * (KU / 4) / WT; ++it) {
    const int i = it * WT + threadIdx.x, r = i / (KU / 4), c = i % (KU / 4), k = k0 + 4 * c;
    const bool second = r >= b.split;
    const int unit = u0 + (second ? r - b.split : r);
    const long long row = unit + (second ? b.off1 : 0);
    const bool in = unit < b.limit && k < b.k;
    cp_async16(dst + unit_offset(r, c), b.p + (in ? row * b.ld + k : 0), in);
  }
}

// A pre-split B window: its hi and lo tiles straight into `dst` (hi) and
// dst + B_TILE (lo)
template <int N>
__device__ __forceinline__ void wide_load_b_split(uint32_t dst, const WideB& b, int u0, int k0) {
#pragma unroll
  for (int it = 0; it < N * (KU / 4) / WT; ++it) {
    const int i = it * WT + threadIdx.x, r = i / (KU / 4), c = i % (KU / 4), k = k0 + 4 * c;
    const bool second = r >= b.split;
    const int unit = u0 + (second ? r - b.split : r);
    const long long at = unit + (second ? b.off1 : 0), off = at * b.ld + k;
    const bool in = unit < b.limit && k < b.k;
    cp_async16(dst + unit_offset(r, c), b.p + (in ? off : 0), in);
    cp_async16(dst + B_TILE + unit_offset(r, c), b.lo + (in ? off : 0), in);
  }
}

// A raw B window (N rows) into its hi and lo tiles
template <int N>
__device__ __forceinline__ void wide_split_b(const unsigned char* raw, unsigned char* hi) {
#pragma unroll
  for (int it = 0; it < N * (KU / 4) / WT; ++it) {
    const int i = it * WT + threadIdx.x;
    const uint32_t off = unit_offset(i / (KU / 4), i % (KU / 4));
    uint4 h, l;
    split_tf32(*reinterpret_cast<const float4*>(raw + off), h, l);
    *reinterpret_cast<uint4*>(hi + off) = h;
    *reinterpret_cast<uint4*>(hi + B_TILE + off) = l;
  }
}

// The TF32 A fragments (hi, lo) of k-step ks of a transposed A window
// ([32 x 128], stride TS): rows (g, g + 8) of the warp's 16 by columns
// (t, t + 4) of the step
__device__ __forceinline__ void wide_t_fragments(const float* tile, int ks, uint32_t (&hi)[4], uint32_t (&lo)[4]) {
  const int lane = threadIdx.x % 32, r = (threadIdx.x / 32) * 16 + lane / 4, c = 8 * ks + (lane & 3);
  split_tf32(tile[c * TS + r], hi[0], lo[0]);
  split_tf32(tile[c * TS + r + 8], hi[1], lo[1]);
  split_tf32(tile[(c + 4) * TS + r], hi[2], lo[2]);
  split_tf32(tile[(c + 4) * TS + r + 8], hi[3], lo[3]);
}

// wide_product with B pre-split: a stage is A's window, then B's hi and lo
// tiles; one barrier a window
template <int AT, int N>
__device__ __forceinline__ void wide_product_presplit(float (&acc)[N / 2], const WideA& a, int m0, const WideB& b,
                                                      int u0, int w0, int w1, uint32_t sa, unsigned char* sm) {
  constexpr uint32_t AB = wide_a_bytes<AT>(), ST = AB + SPLIT_BYTES;
  const int nw = w1 - w0;
  auto load = [&](int j) {  // window w0 + j into stage j % WS (one commit group each, empty past the end)
    if (j < nw) {
      const uint32_t slot = sa + (j % WS) * ST;
      wide_load_a<AT>(slot, a, m0, (w0 + j) * KU);
      wide_load_b_split<N>(slot + AB, b, u0, (w0 + j) * KU);
    }
    cp_async_commit();
  };
  for (int j = 0; j < WS - 1; ++j) load(j);
  for (int j = 0; j < nw; ++j) {
    cp_async_wait<WS - 2>();  // this thread's copies of window j have landed
    fence_async_smem();
    __syncthreads();   // everyone's have; everyone is done with window j - 1's stage (its products were waited for)
    load(j + WS - 1);  // into window j - 1's stage
    const float* at = reinterpret_cast<const float*>(sm + (j % WS) * ST);
    uint32_t hi[4][4], lo[4][4];
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      if constexpr (AT)
        wide_t_fragments(at, kk, hi[kk], lo[kk]);
      else
        raw_fragments(at, KU, kk, hi[kk], lo[kk]);
    }
    float t[N / 2];
#pragma unroll
    for (int i = 0; i < N / 2; ++i) t[i] = 0.0f;
    const uint32_t bh = sa + (j % WS) * ST + AB;
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) mma3_rs<N>(t, hi[kk], lo[kk], unit_desc(bh, kk), unit_desc(bh + B_TILE, kk));
    wgmma_commit();
    wgmma_wait_all();
    keep(t);
    keep(hi);
    keep(lo);
#pragma unroll
    for (int i = 0; i < N / 2; ++i) acc[i] += t[i];
  }
  cp_async_wait_all();
  __syncthreads();
}

// acc += rows [m0, m0 + 128) of A times B's tile rows from unit u0, over
// the contraction's windows [w0, w1), in 3xTF32 with a fresh accumulator a
// window (B pre-split: wide_product_presplit; raw: split here). Warp w's
// accumulator holds rows 16 w + g (+ 8) of the tile. Ends with every copy
// landed and a block barrier: the shared memory is free.
template <int AT, int N>
__device__ __forceinline__ void wide_product(float (&acc)[N / 2], const WideA& a, int m0, const WideB& b, int u0,
                                             int w0, int w1, uint32_t sa, unsigned char* sm) {
  if (b.lo != nullptr) {
    wide_product_presplit<AT, N>(acc, a, m0, b, u0, w0, w1, sa, sm);
    return;
  }
  constexpr uint32_t ST = wide_stage<AT>(), AB = wide_a_bytes<AT>(), RING = 2 * SPLIT_BYTES;
  const int nw = w1 - w0;
  auto load = [&](int j) {  // window w0 + j into stage j % WS (one commit group each, empty past the end)
    if (j < nw) {
      const uint32_t slot = sa + RING + (j % WS) * ST;
      wide_load_a<AT>(slot, a, m0, (w0 + j) * KU);
      wide_load_b<N>(slot + AB, b, u0, (w0 + j) * KU);
    }
    cp_async_commit();
  };
  auto split = [&](int j) {
    wide_split_b<N>(sm + RING + (j % WS) * ST + AB, sm + (j & 1) * SPLIT_BYTES);
  };
  for (int j = 0; j < WS; ++j) load(j);
  cp_async_wait<WS - 1>();
  __syncthreads();  // window 0 has landed
  if (nw > 0) split(0);
  fence_async_smem();
  for (int j = 0; j < nw; ++j) {
    __syncthreads();  // window j's split tiles are ready
    const float* at = reinterpret_cast<const float*>(sm + RING + (j % WS) * ST);
    uint32_t hi[4][4], lo[4][4];
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      if constexpr (AT)
        wide_t_fragments(at, kk, hi[kk], lo[kk]);
      else
        raw_fragments(at, KU, kk, hi[kk], lo[kk]);
    }
    float t[N / 2];
#pragma unroll
    for (int i = 0; i < N / 2; ++i) t[i] = 0.0f;
    const uint32_t bh = sa + (j & 1) * SPLIT_BYTES;
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) mma3_rs<N>(t, hi[kk], lo[kk], unit_desc(bh, kk), unit_desc(bh + B_TILE, kk));
    wgmma_commit();
    cp_async_wait<WS - 2>();  // this thread's copies of window j + 1 have landed
    // everyone's have; everyone has read window j's A and is done with the
    // other split buffer (window j - 1's products were waited for)
    __syncthreads();
    if (j + 1 < nw) split(j + 1);  // (while window j's products run)
    fence_async_smem();
    load(j + WS);  // into window j's stage
    wgmma_wait_all();
    keep(t);
    keep(hi);
    keep(lo);
#pragma unroll
    for (int i = 0; i < N / 2; ++i) acc[i] += t[i];
  }
  cp_async_wait_all();
  __syncthreads();
}

// ---------------------------------------------------------------------------
// The kernels
// ---------------------------------------------------------------------------

// Forward, the hidden activation: block = 128 rows (blockIdx.x) by HW hidden
// units (blockIdx.y): u = xs W_in[units]^T (GEGLU: val and gate, 128 B
// rows; MLP: 128 h rows), then a = val gelu(gate) or gelu(h + b1) into
// out [rows, hp] (zeros past hid).
template <int MODE>
__global__ void __launch_bounds__(WT, 1)
ffn_tf32_wide_act_kernel(WideA xs, WideB w, const float* __restrict__ b_in, float* __restrict__ out, int hid,
                         int hp) {
  constexpr int HW = MODE == MODE_GEGLU ? WIDE_HW_GEGLU : WIDE_HW_MLP;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* sm;
  const uint32_t sa = aligned_smem(smem_raw, &sm);
  const int m0 = blockIdx.x * WB, c0 = blockIdx.y * HW;
  const int lane = threadIdx.x % 32, t4 = lane & 3, r0 = (threadIdx.x / 32) * 16 + lane / 4;
  float u[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) u[i] = 0.0f;
  wide_product<0, 128>(u, xs, m0, w, c0, 0, wide_windows(xs.k), sa, sm);
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const long long row = (long long)m0 + r0 + 8 * h;
    if (row >= xs.rows) continue;
#pragma unroll
    for (int j = 0; j < HW / 8; ++j) {
      float v[2];
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int i = 4 * j + 2 * h + e, col = c0 + 8 * j + 2 * t4 + e;
        if constexpr (MODE == MODE_GEGLU) {
          const float g = u[32 + i];
          v[e] = col < hid ? u[i] * (g * gelu_cdf(g)) : 0.0f;
        } else {
          const float g = u[i] + (col < hid ? b_in[col] : 0.0f);
          v[e] = col < hid ? g * gelu_cdf(g) : 0.0f;
        }
      }
      *reinterpret_cast<float2*>(out + row * hp + c0 + 8 * j + 2 * t4) = make_float2(v[0], v[1]);
    }
  }
}

// The sum over the 8 row groups of a warp (lanes with the same lane % 4)
__device__ __forceinline__ float wide_column_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 4);
  v += __shfl_xor_sync(0xffffffffu, v, 8);
  return v + __shfl_xor_sync(0xffffffffu, v, 16);
}

// Backward, the row pass's products: block = 128 rows (blockIdx.x, all of
// mp) by 64 hidden units (blockIdx.y): u = xs W_in[units]^T (GEGLU val and
// gate; MLP h before b1), da = dy W_out[:, units] (W_out^T's rows), then
// GEGLU du = [da gelu(gate), da val gelu'(gate)], a = val gelu(gate) (MLP dh
// = da gelu'(h), a = gelu(h)) stored transposed, duT [2hp (MLP hp), mp], aT
// [hp, mp], zeros past m and hid; MLP: the block's column sums of dh into
// db1 [blocks, hid].
template <int MODE>
__global__ void __launch_bounds__(WT, 1)
ffn_tf32_wide_act_bwd_kernel(WideA xs, WideB w_in, WideA dy, WideB w_outt, const float* __restrict__ b_in,
                             float* __restrict__ dut, float* __restrict__ at, float* __restrict__ db1, int m, int mp,
                             int hid, int hp) {
  constexpr int NU = MODE == MODE_GEGLU ? 128 : 64;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* sm;
  const uint32_t sa = aligned_smem(smem_raw, &sm);
  const int m0 = blockIdx.x * WB, c0 = blockIdx.y * 64;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, t4 = lane & 3, r0 = warp * 16 + lane / 4;
  float u[NU / 2], da[32];
#pragma unroll
  for (int i = 0; i < NU / 2; ++i) u[i] = 0.0f;
#pragma unroll
  for (int i = 0; i < 32; ++i) da[i] = 0.0f;
  wide_product<0, NU>(u, xs, m0, w_in, c0, 0, wide_windows(xs.k), sa, sm);
  wide_product<0, 64>(da, dy, m0, w_outt, c0, 0, wide_windows(dy.k), sa, sm);

  // (the store bases made opaque: the compiler would keep a pointer for
  // every element of every store live)
  float* hc = dut + (long long)c0 * mp + m0 + r0;
  float* ac = at + (long long)c0 * mp + m0 + r0;
  asm volatile("" : "+l"(hc), "+l"(ac));
  float csum[16];
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int col = c0 + 8 * j + 2 * t4 + e;
      const float b = MODE == MODE_MLP && col < hid ? b_in[col] : 0.0f;
      float s = 0.0f;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int i = 4 * j + 2 * h + e;
        const bool live = m0 + r0 + 8 * h < m && col < hid;
        float g;
        if constexpr (MODE == MODE_GEGLU)
          g = u[32 + i];
        else
          g = u[i] + b;
        const float cdf = gelu_cdf(g), gd = cdf + g * gelu_pdf(g);
        const long long off = (long long)(col - c0) * mp + 8 * h;
        if constexpr (MODE == MODE_GEGLU) {
          const float gv = g * cdf;
          hc[off] = live ? da[i] * gv : 0.0f;
          hc[off + (long long)hp * mp] = live ? da[i] * u[i] * gd : 0.0f;
          ac[off] = live ? u[i] * gv : 0.0f;
        } else {
          const float dh = live ? da[i] * gd : 0.0f;
          hc[off] = dh;
          ac[off] = live ? g * cdf : 0.0f;
          s += dh;
        }
      }
      csum[2 * j + e] = s;
    }
  if constexpr (MODE == MODE_MLP) {  // db1: the block's column sums, warps summed in order
    float* red = reinterpret_cast<float*>(sm);  // [8 warps][64]
#pragma unroll
    for (int k = 0; k < 16; ++k) csum[k] = wide_column_sum(csum[k]);
    if (lane < 4) {
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        red[warp * 64 + 8 * j + 2 * t4] = csum[2 * j];
        red[warp * 64 + 8 * j + 2 * t4 + 1] = csum[2 * j + 1];
      }
    }
    __syncthreads();
    if (threadIdx.x < 64 && c0 + threadIdx.x < hid) {
      float s = 0.0f;
      for (int k = 0; k < WT / 32; ++k) s += red[k * 64 + threadIdx.x];
      db1[(long long)blockIdx.x * hid + c0 + threadIdx.x] = s;
    }
  }
}

// One product C = A B^T of a wide launch, as 128 x 128 tiles over `splits`
// ranges of `wps` windows of the contraction. C's element (p, q) (p < rows,
// q < cols) goes to c [split z] at p ldc + q (trans: q ldc + p), + bias[q]
// where given; hp > 0: q maps to a GEGLU weight's rows, q < hid -> q, hp <=
// q < hp + hid -> hid + q - hp, the padding dropped.
struct WideGemm {
  WideA a;
  WideB b;
  int mtiles, ntiles, splits, wps, windows;
  float* c;
  long long ldc, split_stride;
  int rows, cols, trans, hid, hp;
  const float* bias;
};

struct WideGemms {
  WideGemm g[3];
  int n;
  int start[4];  // the jobs' first blocks, then the total
};

template <int AT>
__global__ void __launch_bounds__(WT, 1) ffn_tf32_wide_gemm_kernel(WideGemms gs) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* sm;
  const uint32_t sa = aligned_smem(smem_raw, &sm);
  const int blk = blockIdx.x;
  const int job = blk >= gs.start[2] && gs.n > 2 ? 2 : (blk >= gs.start[1] && gs.n > 1 ? 1 : 0);
  const WideGemm g = job == 0 ? gs.g[0] : (job == 1 ? gs.g[1] : gs.g[2]);
  int t = blk - gs.start[job];
  const int mt = t % g.mtiles;
  t /= g.mtiles;
  const int nt = t % g.ntiles, z = t / g.ntiles;
  const int m0 = mt * WB, n0 = nt * WB, w0 = z * g.wps, w1 = min(g.windows, w0 + g.wps);
  const int lane = threadIdx.x % 32, t4 = lane & 3, r0 = (threadIdx.x / 32) * 16 + lane / 4;
  float acc[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] = 0.0f;
  wide_product<AT, 128>(acc, g.a, m0, g.b, n0, w0, w1, sa, sm);

  float* c = g.c + (long long)z * g.split_stride;
  const bool pairs = !g.trans && g.hp == 0;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int p = m0 + r0 + 8 * h;
    if (p >= g.rows) continue;
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      const int q = n0 + 8 * j + 2 * t4;
      if (q >= g.cols) continue;
      float v0 = acc[4 * j + 2 * h], v1 = acc[4 * j + 2 * h + 1];
      if (pairs) {  // cols is even: q + 1 is inside too
        if (g.bias != nullptr) {
          v0 += g.bias[q];
          v1 += g.bias[q + 1];
        }
        *reinterpret_cast<float2*>(c + (long long)p * g.ldc + q) = make_float2(v0, v1);
        continue;
      }
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        int qm = q + e;
        if (g.hp > 0) qm = qm < g.hid ? qm : (qm >= g.hp && qm - g.hp < g.hid ? g.hid + qm - g.hp : -1);
        if (qm < 0) continue;
        const float v = (e ? v1 : v0) + (g.bias != nullptr ? g.bias[qm] : 0.0f);
        c[g.trans ? (long long)qm * g.ldc + p : (long long)p * g.ldc + qm] = v;
      }
    }
  }
}

// The weights of one call split into TF32 hi and lo parts (x = hi + lo,
// cvt.rna) into dst / lo [rows, cols], zeros where there is no source
// element: a copy (dst[i][j] = src[i][j], a row padded past src_cols) or,
// trans, a transpose (dst[i][j] = src[map(j)][i]; map(j) = j (hp = 0) or a
// GEGLU weight's val / gate row, as WideGemm's columns). blockIdx.z: the
// job; 32 x 32 tiles.
struct WideWeights {
  const float* src;
  float* dst;
  float* lo;
  int src_rows, src_cols, rows, cols, trans, hid, hp;
};

struct WideWeightJobs {
  WideWeights w[3];
};

__global__ void __launch_bounds__(256) ffn_tf32_wide_weights_kernel(WideWeightJobs jobs) {
  __shared__ float tile[32][33];
  const WideWeights t = blockIdx.z == 0 ? jobs.w[0] : (blockIdx.z == 1 ? jobs.w[1] : jobs.w[2]);
  const int i0 = blockIdx.y * 32, j0 = blockIdx.x * 32;
  if (i0 >= t.rows || j0 >= t.cols) return;
  auto store = [&](int i, int j, float v) {
    uint32_t h, l;
    split_tf32(v, h, l);
    t.dst[(long long)i * t.cols + j] = __uint_as_float(h);
    t.lo[(long long)i * t.cols + j] = __uint_as_float(l);
  };
  if (!t.trans) {
    for (int k = threadIdx.y; k < 32; k += 8) {
      const int i = i0 + k, j = j0 + threadIdx.x;
      if (i < t.rows && j < t.cols)
        store(i, j, i < t.src_rows && j < t.src_cols ? t.src[(long long)i * t.src_cols + j] : 0.0f);
    }
    return;
  }
  for (int k = threadIdx.y; k < 32; k += 8) {
    const int j = j0 + k, i = i0 + threadIdx.x;
    int s = j;
    if (t.hp > 0) s = j < t.hid ? j : (j >= t.hp && j - t.hp < t.hid ? t.hid + j - t.hp : -1);
    else if (j >= t.src_rows) s = -1;
    tile[k][threadIdx.x] = s >= 0 && i < t.src_cols ? t.src[(long long)s * t.src_cols + i] : 0.0f;
  }
  __syncthreads();
  for (int k = threadIdx.y; k < 32; k += 8) {
    const int i = i0 + k, j = j0 + threadIdx.x;
    if (i < t.rows && j < t.cols) store(i, j, tile[threadIdx.x][k]);
  }
}

static cudaError_t split_weights(const WideWeightJobs& jobs, int n, cudaStream_t stream) {
  int rows = 0, cols = 0;
  for (int i = 0; i < n; ++i) {
    rows = rows > jobs.w[i].rows ? rows : jobs.w[i].rows;
    cols = cols > jobs.w[i].cols ? cols : jobs.w[i].cols;
  }
  ffn_tf32_wide_weights_kernel<<<dim3((cols + 31) / 32, (rows + 31) / 32, n), dim3(32, 8), 0, stream>>>(jobs);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// Plans and launches
// ---------------------------------------------------------------------------

// Whether these widths take the wide path (else ffn_tf32.cuh's row kernels)
__host__ inline bool wide(int d, int d_out) { return !rows_fit(d, d_out); }

// The padded hidden width: whole blocks of the activation kernels
__host__ inline int wide_hp(int mode, int hid) {
  const int hw = mode == MODE_GEGLU ? WIDE_HW_GEGLU : WIDE_HW_MLP;
  return (hid + hw - 1) / hw * hw;
}

// (lo: the lo parts of a pre-split B at p, or null for a raw one)
__host__ inline WideB wide_b(const float* p, const float* lo, long long ld, int limit, int k, int split = WB,
                             int off1 = 0) {
  return WideB{p, ld, limit, split, off1, k, lo};
}

// One product of a launch with its tiles and ranges: `splits` ranges of
// the contraction at most (a multiple of whole windows)
__host__ inline WideGemm wide_gemm(WideA a, WideB b, int rows, int cols, int splits, float* c, long long ldc,
                                   int trans = 0, int hid = 0, int hp = 0, const float* bias = nullptr) {
  WideGemm g{};
  g.a = a;
  g.b = b;
  g.mtiles = (rows + WB - 1) / WB;
  g.ntiles = (cols + WB - 1) / WB;
  g.windows = wide_windows(a.k);
  splits = splits < 1 ? 1 : (splits > g.windows ? g.windows : splits);
  g.wps = (g.windows + splits - 1) / splits;
  g.splits = (g.windows + g.wps - 1) / g.wps;
  g.c = c;
  g.ldc = ldc;
  g.split_stride = g.splits > 1 ? (long long)rows * cols : 0;
  g.rows = rows;
  g.cols = cols;
  g.trans = trans;
  g.hid = hid;
  g.hp = hp;
  g.bias = bias;
  return g;
}

template <int AT>
static cudaError_t launch_wide_gemms(WideGemms gs, cudaStream_t stream) {
  static std::atomic<unsigned> ready{0};
  auto kernel = ffn_tf32_wide_gemm_kernel<AT>;
  cudaError_t err = allow_smem((const void*)kernel, wide_smem<AT>(), ready);
  if (err != cudaSuccess) return err;
  int total = 0;
  for (int i = 0; i < gs.n; ++i) {
    gs.start[i] = total;
    total += gs.g[i].mtiles * gs.g[i].ntiles * gs.g[i].splits;
  }
  for (int i = gs.n; i < 4; ++i) gs.start[i] = total;
  kernel<<<total, WT, wide_smem<AT>(), stream>>>(gs);
  return cudaGetLastError();
}

// The forward's plan: the hidden width hp, the output product's split of
// the hidden windows (over about one block an SM where its tiles fill under
// half of them), and the workspace in floats: W_in's hi and lo parts
// [(2) hid, d], W_out's [d_out, hp], xn [m, d] (GEGLU), a [m, hp], the
// partial y [splits, m, d_out] where it splits
struct WideFwd {
  int hp, splits;
  long long wih, wil, woh, wol, xn, a, part, floats;
};

__host__ inline WideFwd wide_fwd_plan(int mode, int m, int d, int hid, int d_out) {
  WideFwd f;
  f.hp = wide_hp(mode, hid);
  const int tiles = (m + WB - 1) / WB * ((d_out + WB - 1) / WB), windows = f.hp / KU, sms = sm_count();
  f.splits = 1;
  if (2 * tiles < sms) {
    const int want = sms / tiles < windows ? sms / tiles : windows;
    const int wps = (windows + want - 1) / want;
    f.splits = (windows + wps - 1) / wps;
  }
  const long long win = (long long)(mode == MODE_GEGLU ? 2 : 1) * hid * d, wout = (long long)d_out * f.hp;
  f.wih = 0;
  f.wil = f.wih + win;
  f.woh = f.wil + win;
  f.wol = f.woh + wout;
  f.xn = f.wol + wout;
  f.a = f.xn + (mode == MODE_GEGLU ? (long long)m * d : 0);
  f.part = f.a + (long long)m * f.hp;
  f.floats = f.part + (f.splits > 1 ? (long long)f.splits * m * d_out : 0);
  return f;
}

__host__ inline int wide_fwd_kernels(int mode, int m, int d, int hid, int d_out) {
  return (mode == MODE_GEGLU ? 4 : 3) + (wide_fwd_plan(mode, m, d, hid, d_out).splits > 1 ? 1 : 0);
}

template <int MODE>
static cudaError_t launch_wide_act(const WideA& xs, const WideB& w, const float* b_in, float* out, int hid, int hp,
                                   cudaStream_t stream) {
  static std::atomic<unsigned> ready{0};
  auto kernel = ffn_tf32_wide_act_kernel<MODE>;
  cudaError_t err = allow_smem((const void*)kernel, wide_smem<0>(), ready);
  if (err != cudaSuccess) return err;
  const int hw = MODE == MODE_GEGLU ? WIDE_HW_GEGLU : WIDE_HW_MLP;
  kernel<<<dim3((xs.rows + WB - 1) / WB, hp / hw), WT, wide_smem<0>(), stream>>>(xs, w, b_in, out, hid, hp);
  return cudaGetLastError();
}

// One wide forward: the weights split, (GEGLU) the LayerNorm, the
// activation, the output product (and the reduction of its split). ws:
// wide_fwd_plan(...).floats.
template <int MODE>
static cudaError_t forward_wide(const float* x, const float* gamma, const float* w_in, const float* b_in,
                                const float* w_out, const float* b_out, float* y, float* ws, int m, int d, int hid,
                                int d_out, cudaStream_t stream) {
  const WideFwd f = wide_fwd_plan(MODE, m, d, hid, d_out);
  const int rin = (MODE == MODE_GEGLU ? 2 : 1) * hid;
  WideWeightJobs jobs{};
  jobs.w[0] = WideWeights{w_in, ws + f.wih, ws + f.wil, rin, d, rin, d, 0, 0, 0};
  jobs.w[1] = WideWeights{w_out, ws + f.woh, ws + f.wol, d_out, hid, d_out, f.hp, 0, 0, 0};
  cudaError_t err = split_weights(jobs, 2, stream);
  if (err != cudaSuccess) return err;
  const float* xs = x;
  if (MODE == MODE_GEGLU) {
    err = simt_f32::ln_fwd(x, gamma, ws + f.xn, m, d, stream);
    if (err != cudaSuccess) return err;
    xs = ws + f.xn;
  }
  float* a = ws + f.a;
  const WideB w = MODE == MODE_GEGLU ? wide_b(ws + f.wih, ws + f.wil, d, hid, d, WIDE_HW_GEGLU, hid)
                                     : wide_b(ws + f.wih, ws + f.wil, d, hid, d);
  err = launch_wide_act<MODE>(WideA{xs, d, m, d}, w, b_in, a, hid, f.hp, stream);
  if (err != cudaSuccess) return err;
  const WideB wo = wide_b(ws + f.woh, ws + f.wol, f.hp, d_out, f.hp);
  const bool split = f.splits > 1;
  WideGemms gs{};
  gs.n = 1;
  gs.g[0] = wide_gemm(WideA{a, f.hp, m, f.hp}, wo, m, d_out, f.splits, split ? ws + f.part : y, d_out, 0, 0, 0,
                      MODE == MODE_MLP && !split ? b_out : nullptr);
  err = launch_wide_gemms<0>(gs, stream);
  if (err != cudaSuccess || !split) return err;
  const long long blocks = ((long long)m * d_out / 4 + 255) / 256;
  ffn_tf32_fwd_reduce_kernel<<<dim3((unsigned)(blocks < 1024 ? blocks : 1024), 1), 256, 0, stream>>>(
      ws + f.part, MODE == MODE_MLP ? b_out : nullptr, y, m, d_out, f.splits);
  return cudaGetLastError();
}

// The LayerNorm backward's blocks: 64 rows (a dgamma partial each), 8 warps
// (4 past d = 1536: WARPS d floats of shared memory)
constexpr int WIDE_LN_ROWS = 64;

// The backward's plan: hp, mp (m rounded up to the tile), the weight
// gradients' ranges, and the scratch in floats: the weights' hi and lo
// parts (W_in [(2) hid, d], W_in^T [d, (2) hp], W_out^T [hp, d_out]), xn
// [m, d] (GEGLU), du^T [2hp, mp] (MLP dh^T [hp, mp]), a^T [hp, mp], dxn
// [m, d] (GEGLU), the weight gradients' partials [splits, ...] in the
// weights' layouts, the vector partials (GEGLU dgamma [m / 64, d]; MLP db1
// and db2 [mp / 128, hid and d_out]).
struct WideBwd {
  int hp, mp, splits;
  long long wih, wil, wit, witl, wot, wotl, xn, dut, at, dxn, part0, part1, vec0, vec1, floats;
};

__host__ inline int wide_bwd_splits(int mode, int m, int d, int hid, int d_out) {
  const int hp = wide_hp(mode, hid), nh = (mode == MODE_GEGLU ? 2 : 1) * hp;
  const int tiles = (d + WB - 1) / WB * (nh / WB + (nh % WB ? 1 : 0)) + (d_out + WB - 1) / WB * ((hp + WB - 1) / WB);
  const int windows = wide_windows(m);
  int s = (windows + 127) / 128;  // about 128 windows (4096 rows) a block, as the dxn product's
  const int fill = (sm_count() + tiles - 1) / tiles;
  s = s > fill ? s : fill;
  s = s > MAX_SPLITS ? MAX_SPLITS : s;
  s = s > windows ? windows : s;
  const int wps = (windows + s - 1) / s;
  return (windows + wps - 1) / wps;
}

__host__ inline WideBwd wide_bwd_plan(int mode, int m, int d, int hid, int d_out) {
  WideBwd s;
  const bool geglu = mode == MODE_GEGLU;
  s.hp = wide_hp(mode, hid);
  s.mp = (m + WB - 1) / WB * WB;
  s.splits = wide_bwd_splits(mode, m, d, hid, d_out);
  const long long nh = (geglu ? 2LL : 1LL) * s.hp;
  const long long win = (geglu ? 2LL : 1LL) * hid * d;
  s.wih = 0;
  s.wil = s.wih + win;
  s.wit = s.wil + win;
  s.witl = s.wit + (long long)d * nh;
  s.wot = s.witl + (long long)d * nh;
  s.wotl = s.wot + (long long)s.hp * d_out;
  s.xn = s.wotl + (long long)s.hp * d_out;
  s.dut = s.xn + (geglu ? (long long)m * d : 0);
  s.at = s.dut + nh * s.mp;
  s.dxn = s.at + (long long)s.hp * s.mp;
  s.part0 = s.dxn + (geglu ? (long long)m * d : 0);
  s.part1 = s.part0 + (long long)s.splits * (geglu ? 2LL : 1LL) * hid * d;
  s.vec0 = s.part1 + (long long)s.splits * d_out * hid;
  s.vec1 = s.vec0 + (geglu ? (long long)simt_f32::ln_blocks<WIDE_LN_ROWS>(m) * d : (long long)(s.mp / WB) * hid);
  s.floats = s.vec1 + (geglu ? 0 : (long long)(s.mp / WB) * d_out);
  return s;
}

__host__ inline int wide_bwd_kernels(int mode) { return mode == MODE_GEGLU ? 6 : 5; }

template <int MODE>
static cudaError_t launch_wide_act_bwd(const WideA& xs, const WideB& w_in, const WideA& dy, const WideB& w_outt,
                                       const float* b_in, float* dut, float* at, float* db1, int m, int mp, int hid,
                                       int hp, cudaStream_t stream) {
  static std::atomic<unsigned> ready{0};
  auto kernel = ffn_tf32_wide_act_bwd_kernel<MODE>;
  cudaError_t err = allow_smem((const void*)kernel, wide_smem<0>(), ready);
  if (err != cudaSuccess) return err;
  kernel<<<dim3(mp / WB, hp / 64), WT, wide_smem<0>(), stream>>>(xs, w_in, dy, w_outt, b_in, dut, at, db1, m, mp,
                                                                  hid, hp);
  return cudaGetLastError();
}

// One wide backward: the weights split (and transposed), (GEGLU) the LayerNorm, the row
// pass's products (du / dh and a, transposed), dxn (MLP dx) and the two
// weight gradients in one launch, (GEGLU) the LayerNorm's backward, (MLP)
// db2's column sums, the fixed-order reduction. GEGLU: dW_in = du^T xn,
// dW_out = dy^T a, dgamma; MLP: dW1 = dh^T x, dW2 = dy^T a, db1, db2. sc:
// wide_bwd_plan(...).floats floats.
template <int MODE>
static cudaError_t backward_wide(const float* x, const float* gamma, const float* w_in, const float* b_in,
                                 const float* w_out, const float* dy, float* dx, float* dw_in, float* dw_out,
                                 float* dv0, float* dv1, float* sc, int m, int d, int hid, int d_out,
                                 cudaStream_t stream) {
  constexpr bool GEGLU = MODE == MODE_GEGLU;
  const WideBwd s = wide_bwd_plan(MODE, m, d, hid, d_out);
  const int hp = s.hp, mp = s.mp, nh = (GEGLU ? 2 : 1) * hp;
  float *dut = sc + s.dut, *at = sc + s.at;
  // W_in [rin, d]; W_in^T [d, nh] from W_in; W_out^T [hp, d_out] from W_out [d_out, hid]
  const int rin = (GEGLU ? 2 : 1) * hid;
  WideWeightJobs jobs{};
  jobs.w[0] = WideWeights{w_in, sc + s.wih, sc + s.wil, rin, d, rin, d, 0, 0, 0};
  jobs.w[1] = WideWeights{w_in, sc + s.wit, sc + s.witl, rin, d, d, nh, 1, GEGLU ? hid : 0, GEGLU ? hp : 0};
  jobs.w[2] = WideWeights{w_out, sc + s.wot, sc + s.wotl, d_out, hid, hp, d_out, 1, 0, 0};
  cudaError_t err = split_weights(jobs, 3, stream);
  if (err != cudaSuccess) return err;
  const float* xs = x;
  if (GEGLU) {
    err = simt_f32::ln_fwd(x, gamma, sc + s.xn, m, d, stream);
    if (err != cudaSuccess) return err;
    xs = sc + s.xn;
  }
  const WideB wb = GEGLU ? wide_b(sc + s.wih, sc + s.wil, d, hid, d, 64, hid)
                          : wide_b(sc + s.wih, sc + s.wil, d, hid, d);
  err = launch_wide_act_bwd<MODE>(WideA{xs, d, m, d}, wb, WideA{dy, d_out, m, d_out},
                                  wide_b(sc + s.wot, sc + s.wotl, d_out, hp, d_out), b_in, dut, at,
                                  GEGLU ? nullptr : sc + s.vec0, m, mp, hid, hp, stream);
  if (err != cudaSuccess) return err;
  // the wgrad products first (the longer blocks), then dxn (MLP dx)
  WideGemms gs{};
  gs.n = 3;
  // dW_in^T [d, nh] = xs^T du over the rows, stored as dW_in [(2) hid, d]
  gs.g[0] = wide_gemm(WideA{xs, d, d, m}, wide_b(dut, nullptr, mp, nh, mp), d, nh, s.splits, sc + s.part0, d, 1, hid,
                      hp);
  gs.g[0].split_stride = (GEGLU ? 2LL : 1LL) * hid * d;
  // dW_out [d_out, hp] = dy^T a over the rows, stored as [d_out, hid]
  gs.g[1] = wide_gemm(WideA{dy, d_out, d_out, m}, wide_b(at, nullptr, mp, hp, mp), d_out, hp, s.splits, sc + s.part1,
                      hid, 0, hid, hp);
  gs.g[1].split_stride = (long long)d_out * hid;
  // dxn [m, d] = du W_in (MLP: dx = dh W1)
  gs.g[2] = wide_gemm(WideA{dut, mp, mp, nh}, wide_b(sc + s.wit, sc + s.witl, nh, d, nh), m, d, 1,
                      GEGLU ? sc + s.dxn : dx, d);
  err = launch_wide_gemms<1>(gs, stream);
  if (err != cudaSuccess) return err;
  if (GEGLU) {
    err = d <= 1536 ? simt_f32::ln_bwd<8, WIDE_LN_ROWS>(x, gamma, sc + s.dxn, nullptr, dx, sc + s.vec0, m, d, stream)
                    : simt_f32::ln_bwd<4, WIDE_LN_ROWS>(x, gamma, sc + s.dxn, nullptr, dx, sc + s.vec0, m, d, stream);
  } else {  // db2: column sums of dy over the act kernel's 128-row blocks
    simt_f32::simt_f32_colsum_kernel<<<dim3((d_out + 255) / 256, mp / WB), 256, 0, stream>>>(dy, d_out, m, d_out, WB,
                                                                                             sc + s.vec1);
    err = cudaGetLastError();
  }
  if (err != cudaSuccess) return err;
  const int sp = gs.g[0].splits;  // (both weight gradients: the same rows, ranges and splits)
  simt_f32::Segments segs{{{sc + s.part0, sp, (GEGLU ? 2LL : 1LL) * hid * d, dw_in},
                           {sc + s.part1, sp, (long long)d_out * hid, dw_out},
                           {sc + s.vec0, GEGLU ? simt_f32::ln_blocks<WIDE_LN_ROWS>(m) : mp / WB, GEGLU ? d : hid, dv0},
                           {sc + s.vec1, mp / WB, d_out, dv1}},
                          GEGLU ? 3 : 4};
  return simt_f32::reduce(segs, stream);
}

}  // namespace ffn_tf32
