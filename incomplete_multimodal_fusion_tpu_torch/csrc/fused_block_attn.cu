// K6: fused_block_attn -- the attention half of an encoder block,
//
//   y = x + round(out . Wo^T),   out = zorro_attn(q, k, v),
//   [q | k | v] = round(h . [Wq; Wkv]^T),   h = round(LN_g2(round(LN_g1(x)))),
//
// both LayerNorms bias-free (f32 statistics, eps 1e-5), and its backward
// K6b: dx, dg1, dg2, dWq, dWkv, dWo. Weights are in nn.Linear layout
// ([out, in]); the weight and gain gradients are summed in f32 over all
// B x N rows and cast once to bf16.
//
// Replaces ops/pallas_block_attn.py _fwd_kernel (pallas_call in _fwd_impl)
// and _bwd_kernel (pallas_call in _bwd_rule). Cast points kept from the TPU
// kernel: forward (pallas_block_attn.py:71-105): LN1 in f32 rounded; LN2 in
// f32 rounded (h); q and kv rounded; each head's output rounded; (out .
// Wo^T) rounded before the bf16 residual add; backward (:108-202): dout =
// dy . Wo rounded; D = rowsum(dout * o) on the unrounded f32 head output;
// dq and dk multiplied by the scale before rounding, dv rounded; dhid =
// dq . Wq + dkv . Wkv in f32; both LayerNorm backwards in f32 (da is not
// rounded); dx = round(dy + dx_ln). Not kept: the attention is K1's, with
// K1's cast points -- P = exp(s - m) rounded for P . V against the running
// row maximum, the f32 sum rescaled and divided out after -- where the TPU
// kernel rounds the normalised p; on the card test's inputs the head
// outputs and D differ by about 1e-4 (relative) from a plain version that
// rounds the normalised p (fused_block_attn_reference).
//
// What bounds it on an H100: at the pretraining shape (B = 60, N = 640,
// D = I = 192, 3 heads x 64) the forward's products are about 22 GFLOP
// (projections 8.5, attention over the allowed pairs, out projection 2.8)
// against about 30 MB of x and y, and the workspaces' traffic besides. The
// TPU kernel ran one program per batch row with the row's [N, D] slab, the
// three weights and every intermediate in VMEM; a block's 227 KB of shared
// memory holds neither, and 60 rows would fill fewer than half the SMs, so
// the work is cut into row tiles and launches, each on wgmma:
//
// K6, three launches:
//   1. projection pass (block_attn_proj_kernel), 128 rows of B x N a block
//      (two warpgroups; 64 rows, one warpgroup, past D = 768): x's tile
//      copied by cp.async into shared memory, both LayerNorms in place
//      there (a warp two rows at a time, f32 statistics, each output
//      rounded), so the tile becomes h in the 128-byte swizzle; then qkv =
//      round(h . [Wq; Wkv]^T) 64 output columns at a time (the row
//      products, below) into a bf16 [B, N, 3I] workspace;
//   2. attention: K1's forward itself (zorro::launch, zorro_attention.cuh)
//      over the workspace's q, k, v view, each head's rounded output into a
//      bf16 [B, N, I] workspace;
//   3. out projection (block_attn_out_kernel), the same row products with
//      the out tile as A and Wo's rows as B: y = x + round(out . Wo^T).
// The row products: a chunk's weights (64 output columns by the whole
// reduction width where two such windows fit, else 64 by 64) stream
// through two window slots by cp.async, every warpgroup reading them; the
// f32 accumulator stays in registers; each chunk's output goes out rounded
// through a staging tile in 16-byte stores, 8 threads a 128-byte row (with
// 64-row tiles the staging tile is the window slot just read, which leaves
// room for a tile of D = 1664).
// K6b, eight launches:
//   1. the projection pass, also writing h (dWq's and dWkv's operand);
//   2. dout = round(dy . Wo) (block_attn_dout_kernel): the row products
//      with Wo's windows read MN-major (the same [D, I] bytes, the
//      descriptor's transpose bit);
//   3. K1's forward with its D epilogue (zorro_attention.cuh DeltaOut):
//      round(o) (dWo's operand), the row lse, and D = rowsum(dout * o) on
//      the normalised f32 o in registers (not K1b's rowsum over the rounded
//      o, which its dq kernel would form);
//   4-5. K1b's dq and dk/dv kernels with that D, writing dq * scale,
//      dk * scale and dv into a bf16 [B, N, 3I] workspace;
//   6. row pass (block_attn_bwd_rows_kernel), 128 rows a block: dhid =
//      dqkv . [Wq; Wkv] on wgmma, 256 columns at a time, with the f32
//      accumulator in registers, into shared memory where D fits one slab
//      (D <= 256), else into an f32 workspace; then both LayerNorm
//      backwards a warp two rows at a time (statistics recomputed from x),
//      dx; each warp adds its rows' dg1 / dg2 terms to its own columns of
//      shared memory, and the warps' sums are added in a fixed order, no
//      atomics, so two runs are bitwise equal. In one slab a row's x and
//      dhid are read once and each derived value formed once in registers;
//      wider, each of the seven passes over a row re-reads and re-derives
//      them, a slab at a time (the same code);
//   7-8. the weight gradients dWqkv = dqkv^T . h and dWo = dy^T . round(o)
//      and the reduction of all partials (wgrad.cuh), cast to bf16 once.
// The workspaces cost device memory (about 135 MB at the pretraining shape)
// and a write and a read each. Tried and measured slower on an H100
// (tools/bench_block_attn.py): the row products as persistent blocks with
// the next row tile's A in flight (one block an SM: projection 0.168 ms
// against 0.107), or with 64-wide windows and three blocks an SM (0.103,
// but the out projection 0.038 against 0.035).
//
// The f32 instance (fused_block_attn_fwd_f32, fused_block_attn_bwd_f32),
// for the f32 paths the TPU kernel also takes: the same function with no
// cast points, every product and sum to f32's accuracy, from the pieces of
// simt_f32.cuh (on the CUDA cores) and K1's f32 instance
// (zorro_attention_f32.cuh, on the tensor cores in three TF32 parts),
// through an f32 workspace (fused_block_attn_f32_scratch_floats). Forward,
// six launches: the two LayerNorms (a, then h), q = h Wq^T and kv = h
// Wkv^T into the slab, K1's f32 forward, y = x + out Wo^T. Backward,
// fifteen: a and h, the slab, dout = dy Wo, K1's f32 forward (out, lse),
// K1b's f32 dq and dk/dv kernels (D = rowsum(dout * out): without the bf16
// rounding of o, the stored o is the unrounded one), dhid = dq Wq + dkv
// Wkv, both LayerNorm backwards (da, then dx = dy + dx_ln, the gains'
// partials a row block), the dWqkv and dWo partials over ranges of rows,
// and one reduction of all partials in a fixed order: no atomics, bitwise
// the same run to run.
#include <type_traits>

#include "simt_f32.cuh"
#include "wgrad.cuh"
#include "zorro_attention.cuh"
#include "zorro_attention_f32.cuh"

namespace {

using zorro::bf16;
using namespace hopper;

constexpr float LN_EPS = 1e-5f;
// The widest D and I: a 64-row tile of that width and two 64 x 64 weight
// windows fill 225 KB of shared memory (the row products below). It holds
// every width the earlier wmma design took (D = I up to 832, I up to 1,248,
// D up to 1,632).
constexpr int MAX_D = 1664;

// ---------------------------------------------------------------------------
// Row products: C [R rows, n] = A [R, k] . B [k, n] on wgmma
// ---------------------------------------------------------------------------

constexpr int NC = 64;                      // output columns a chunk
constexpr uint32_t MAX_SMEM = 232448;       // a block's shared memory on sm_90 (227 KB)

__host__ __device__ constexpr int pad64(int v) { return (v + 63) / 64 * 64; }

// Rows a block of the row products at reduction width k: 128 (two
// warpgroups) while the A tile, two 64 x 64 windows and the staging tile
// fit (k up to 768), else 64 (one warpgroup).
__host__ __device__ constexpr int rows_for(int k) {
  return 128 * pad64(k) * 2 + 2 * NC * 64 * 2 + 128 * NC * 2 + 1024 <= (int)MAX_SMEM ? 128 : 64;
}
static_assert(rows_for(768) == 128 && rows_for(832) == 64, "128-row tiles up to D = 768");

// The widest reduction a block of R rows takes (its LayerNorm registers).
template <int R>
__host__ __device__ constexpr int widest() { return R == 128 ? 768 : MAX_D; }

// Shared memory of a row product of R rows over the reduction width k, from
// its 1024-byte aligned start: the A tile [R, kp] (kp = k rounded up to 64;
// a multiple of 8 KB), two weight windows of kw reduction columns by NC
// output columns (kw = kp where both fit beside A and the staging tile, so
// a chunk is one window: D up to 384; else 64), the staging tile of a
// chunk's output (R = 64: the window slot the chunk's last step has just
// read, as large as the staging tile), the alignment slack.
struct RpLayout {
  int kw;          // reduction columns a window
  uint32_t ring;   // the two windows
  uint32_t win;    // bytes of a window
  uint32_t stage;  // the staging tile; 0: the step's window slot
  uint32_t bytes;  // the block's dynamic shared memory
};

template <int R>
__host__ __device__ inline RpLayout rp_layout(int k) {
  const int kp = pad64(k);
  const uint32_t a = R * kp * 2, stage = R * NC * 2;
  RpLayout L;
  L.kw = a + 2u * NC * kp * 2 + stage + 1024 <= MAX_SMEM ? kp : 64;
  L.win = NC * L.kw * 2;
  L.ring = a;
  L.stage = R == 128 ? a + 2 * L.win : 0;
  L.bytes = a + 2 * L.win + (R == 128 ? stage : 0) + 1024;
  return L;
}

__device__ __forceinline__ float warp_sum(float v) { return zorro::warp_sum(v); }

// The row products of a block of R rows (2 R threads, a warpgroup a 64
// rows): A whole in shared memory at `sa` (R rows in the 128-byte swizzle,
// K-major), B in windows of L.kw reduction rows by NC output columns that
// load_win(step, dst, kw) copies (cp.async) into one of the two window
// slots: step s is chunk s / nwin, window s % nwin. TB: a window is MN-major
// (its rows are reduction rows, as a [k, n] matrix lies) rather than K-major
// (its rows are output columns, as an nn.Linear weight lies). Window 0 is
// issued first, its own commit group, after the caller's A copies; then
// prologue(); then per step: wait for the step's window, issue the next one
// into the other slot, the warpgroup's 64 rows times the window into the f32
// accumulator in registers, and after a chunk's last window its output
// rounded to bf16 through the staging tile, handed to emit(row of the block,
// column, 8 values as a uint4) 16 bytes at a time, 8 threads a 128-byte row.
template <int R, int TB, class LoadWin, class Prologue, class Emit>
__device__ __forceinline__ void row_products(uint32_t sa, unsigned char* sm, const RpLayout& L, int n, int k,
                                             const LoadWin& load_win, const Prologue& prologue, const Emit& emit) {
  constexpr int T = 2 * R;
  const int nwin = (k + L.kw - 1) / L.kw;
  const int steps = (n + NC - 1) / NC * nwin;
  load_win(0, sa + L.ring, L.kw);
  cp_async_commit();
  prologue();
  const uint32_t aw = sa + (threadIdx.x / 128) * 64 * 128;  // this warpgroup's rows of the A tile
  const int rb = (threadIdx.x / 128) * 64 + ((threadIdx.x / 32) % 4) * 16 + (threadIdx.x % 32) / 4;
  const int t4 = threadIdx.x % 4;
  float acc[32];
  for (int s = 0; s < steps; ++s) {
    cp_async_wait_all();  // window s (and the A tile) have landed (this thread's copies)
    fence_async_smem();
    __syncthreads();  // ... everyone's; everyone is done with window s - 1's slot
    if (s + 1 < steps) {
      load_win(s + 1, sa + L.ring + ((s + 1) & 1) * L.win, L.kw);
      cp_async_commit();
    }
    const int w = s % nwin;
    if (w == 0) {
#pragma unroll
      for (int i = 0; i < 32; ++i) acc[i] = 0.0f;
    }
    const uint32_t st = sa + L.ring + (s & 1) * L.win;
    wgmma_fence();
    for (int kk = 0; kk < L.kw / 16 && w * L.kw + 16 * kk < k; ++kk) {  // k is a multiple of 16
      const uint64_t da = Sw128::kmajor(aw, R, w * (L.kw / 16) + kk);
      if constexpr (TB)
        wgmma_ss_n64<0, 1>(acc, da, Sw128::mnmajor(st, L.kw, kk));
      else
        wgmma_ss_n64<0, 0>(acc, da, Sw128::kmajor(st, NC, kk));
    }
    wgmma_commit();
    wgmma_wait_all();
    keep(acc);
    if (w != nwin - 1) continue;
    // the chunk's output: the fragments rounded into the staging tile (rows
    // rb, rb + 8; columns 8 j + 2 t4, + 1), then 16 bytes a thread out
    const uint32_t stage = L.stage ? L.stage : L.ring + (s & 1) * L.win;
    if (!L.stage) __syncthreads();  // every warp's products have read the slot
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int hi = 0; hi < 2; ++hi)
        *reinterpret_cast<uint32_t*>(sm + stage + Sw128::offset(rb + 8 * hi, j, R) + 4 * t4) =
            pack_bf16(acc[4 * j + 2 * hi], acc[4 * j + 2 * hi + 1]);
    __syncthreads();
    for (int i = threadIdx.x; i < R * (NC / 8); i += T) {
      const int r = i / (NC / 8), cc = i % (NC / 8);
      emit(r, (s / nwin) * NC + 8 * cc, *reinterpret_cast<const uint4*>(sm + stage + Sw128::offset(r, cc, R)));
    }
  }
}

// Issues the copies of rows [m0, m0 + R) of a row-major [m, k] matrix into
// the A tile (zeros past m and k) and commits them.
template <int R>
__device__ __forceinline__ void load_a(uint32_t a, const bf16* src, long long m0, int m, int k) {
  const int chunks = pad64(k) / 8;
  for (int i = threadIdx.x; i < R * chunks; i += 2 * R) {
    const int r = i / chunks, c = i % chunks;
    const bool in = m0 + r < m && 8 * c < k;
    cp_async16(a + Sw128::offset(r, c, R), src + (in ? (m0 + r) * k + 8 * c : 0), in);
  }
  cp_async_commit();
}

// Issues the copies (2 R threads) of window w of chunk c of a weight read
// K-major: output column c NC + r is row(col) (a k-long row), reduction
// columns w kw .. w kw + kw - 1; zeros past n and k.
template <int R, class Row>
__device__ __forceinline__ void load_win_kmajor(uint32_t dst, int c, int w, int kw, int n, int k, const Row& row) {
  const int cpr = kw / 8;  // 16-byte chunks a window row
  for (int i = threadIdx.x; i < NC * cpr; i += 2 * R) {
    const int r = i / cpr, cc = i % cpr;
    const int col = c * NC + r, kc = w * kw + 8 * cc;
    const bool in = col < n && kc < k;
    cp_async16(dst + Sw128::offset(r, cc, NC), in ? row(col) + kc : row(0), in);
  }
}

// Stores 8 bf16 at (row, col) of the row-major [m, width] out, rows from m0
// (past m or width not written; width is a multiple of 8).
__device__ __forceinline__ void store8(bf16* out, long long m0, int m, int width, int r, int col, uint4 v) {
  if (m0 + r < m && col < width) *reinterpret_cast<uint4*>(out + (m0 + r) * width + col) = v;
}

// K6 launch 1 (and K6b launch 1): block of R rows of the [m, d] input.
template <int R>
__global__ void __launch_bounds__(2 * R, R == 128 ? 2 : 1)
block_attn_proj_kernel(const bf16* __restrict__ x, const bf16* __restrict__ g1, const bf16* __restrict__ g2,
                       const bf16* __restrict__ wq, const bf16* __restrict__ wkv, bf16* __restrict__ qkv,
                       bf16* __restrict__ h_out, int m, int d, int inner) {
  constexpr int PW = 2 * R / 32;  // warps a block
  extern __shared__ unsigned char smem_raw[];
  unsigned char* sm;
  const uint32_t sa = aligned_smem(smem_raw, &sm);
  const RpLayout L = rp_layout<R>(d);
  const long long m0 = (long long)blockIdx.x * R;
  const int width = 3 * inner;
  const int nwin = (d + L.kw - 1) / L.kw;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  load_a<R>(sa, x, m0, m, d);

  auto load_win = [&](int s, uint32_t dst, int kw) {
    load_win_kmajor<R>(dst, s / nwin, s % nwin, kw, width, d, [&](int col) {
      return col < inner ? wq + (long long)col * d : wkv + (long long)(col - inner) * d;
    });
  };

  // h = round(LN_g2(round(LN_g1(x)))) in place, a warp two rows at a time
  // (their reductions in flight together), the lane's 16-byte chunks lane,
  // lane + 32, ... of each in registers
  auto layer_norms = [&]() {
    cp_async_wait<1>();  // the x tile (this thread's copies); window 0 may be in flight
    __syncthreads();
    constexpr int CHUNKS = (widest<R>() / 8 + 31) / 32;  // chunks a lane at most
    for (int r0 = 2 * warp; r0 < R; r0 += 2 * PW) {
      float v[2][CHUNKS][8];
      float sum[2] = {0.0f, 0.0f};
#pragma unroll
      for (int u = 0; u < 2; ++u)
#pragma unroll
        for (int t = 0; t < CHUNKS; ++t) {
          const int c = lane + 32 * t;
          const uint4 q = 8 * c < d ? *reinterpret_cast<const uint4*>(sm + Sw128::offset(r0 + u, c, R))
                                    : make_uint4(0, 0, 0, 0);
          const __nv_bfloat162* p = reinterpret_cast<const __nv_bfloat162*>(&q);
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const float2 f = __bfloat1622float2(p[e]);
            v[u][t][2 * e] = f.x;
            v[u][t][2 * e + 1] = f.y;
            sum[u] += f.x + f.y;
          }
        }
#pragma unroll
      for (int pass = 0; pass < 2; ++pass) {  // LN1 on x, then LN2 on its rounded output
        const bf16* g = pass == 0 ? g1 : g2;
        float mean[2], sq[2] = {0.0f, 0.0f}, rstd[2];
#pragma unroll
        for (int u = 0; u < 2; ++u) mean[u] = warp_sum(sum[u]) / d;
#pragma unroll
        for (int u = 0; u < 2; ++u)
#pragma unroll
          for (int t = 0; t < CHUNKS; ++t)
            if (8 * (lane + 32 * t) < d)
#pragma unroll
              for (int e = 0; e < 8; ++e) sq[u] += (v[u][t][e] - mean[u]) * (v[u][t][e] - mean[u]);
#pragma unroll
        for (int u = 0; u < 2; ++u) {
          rstd[u] = 1.0f / sqrtf(warp_sum(sq[u]) / d + LN_EPS);
          sum[u] = 0.0f;
        }
#pragma unroll
        for (int t = 0; t < CHUNKS; ++t) {
          const int c = lane + 32 * t;
          if (8 * c >= d) continue;
          const uint4 gu = *reinterpret_cast<const uint4*>(g + 8 * c);
          const __nv_bfloat162* gp = reinterpret_cast<const __nv_bfloat162*>(&gu);
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const float2 gf = __bfloat1622float2(gp[e]);
#pragma unroll
            for (int u = 0; u < 2; ++u) {
              const float2 rounded = __bfloat1622float2(__floats2bfloat162_rn(
                  (v[u][t][2 * e] - mean[u]) * rstd[u] * gf.x, (v[u][t][2 * e + 1] - mean[u]) * rstd[u] * gf.y));
              v[u][t][2 * e] = rounded.x;
              v[u][t][2 * e + 1] = rounded.y;
              sum[u] += rounded.x + rounded.y;
            }
          }
        }
      }
#pragma unroll
      for (int u = 0; u < 2; ++u)
#pragma unroll
        for (int t = 0; t < CHUNKS; ++t) {
          const int c = lane + 32 * t;
          if (8 * c >= d) continue;
          uint4 q;
          uint32_t* p = reinterpret_cast<uint32_t*>(&q);
#pragma unroll
          for (int e = 0; e < 4; ++e) p[e] = pack_bf16(v[u][t][2 * e], v[u][t][2 * e + 1]);
          *reinterpret_cast<uint4*>(sm + Sw128::offset(r0 + u, c, R)) = q;
          if (h_out != nullptr && m0 + r0 + u < m) *reinterpret_cast<uint4*>(h_out + (m0 + r0 + u) * d + 8 * c) = q;
        }
    }
  };

  row_products<R, 0>(sa, sm, L, width, d, load_win, layer_norms,
                     [&](int r, int col, uint4 v) { store8(qkv, m0, m, width, r, col, v); });
}

// K6 launch 3: y = x + round(out . Wo^T), block of R rows; out [m, inner],
// Wo [d, inner].
template <int R>
__global__ void __launch_bounds__(2 * R, R == 128 ? 2 : 1)
block_attn_out_kernel(const bf16* __restrict__ out, const bf16* __restrict__ x, const bf16* __restrict__ wo,
                      bf16* __restrict__ y, int m, int d, int inner) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* sm;
  const uint32_t sa = aligned_smem(smem_raw, &sm);
  const RpLayout L = rp_layout<R>(inner);
  const long long m0 = (long long)blockIdx.x * R;
  const int nwin = (inner + L.kw - 1) / L.kw;
  load_a<R>(sa, out, m0, m, inner);
  row_products<R, 0>(
      sa, sm, L, d, inner,
      [&](int s, uint32_t dst, int kw) {
        load_win_kmajor<R>(dst, s / nwin, s % nwin, kw, d, inner, [&](int col) { return wo + (long long)col * inner; });
      },
      [] {},
      [&](int r, int col, uint4 v) {  // the bf16 residual add: x + the rounded product, rounded
        if (m0 + r >= m || col >= d) return;
        const long long at = (m0 + r) * d + col;
        const uint4 xv = *reinterpret_cast<const uint4*>(x + at);
        const __nv_bfloat162* xp = reinterpret_cast<const __nv_bfloat162*>(&xv);
        const __nv_bfloat162* pp = reinterpret_cast<const __nv_bfloat162*>(&v);
        uint4 yv;
        uint32_t* yp = reinterpret_cast<uint32_t*>(&yv);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float2 xf = __bfloat1622float2(xp[e]), pf = __bfloat1622float2(pp[e]);
          yp[e] = pack_bf16(xf.x + pf.x, xf.y + pf.y);
        }
        *reinterpret_cast<uint4*>(y + at) = yv;
      });
}

// K6b launch 2: dout = round(dy . Wo), block of R rows; dy [m, d], Wo [d,
// inner] read as the MN-major B of the product.
template <int R>
__global__ void __launch_bounds__(2 * R, R == 128 ? 2 : 1)
block_attn_dout_kernel(const bf16* __restrict__ dy, const bf16* __restrict__ wo, bf16* __restrict__ dout, int m,
                       int d, int inner) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* sm;
  const uint32_t sa = aligned_smem(smem_raw, &sm);
  const RpLayout L = rp_layout<R>(d);
  const long long m0 = (long long)blockIdx.x * R;
  const int nwin = (d + L.kw - 1) / L.kw;
  load_a<R>(sa, dy, m0, m, d);
  row_products<R, 1>(
      sa, sm, L, inner, d,
      [&](int s, uint32_t dst, int kw) {  // rows: Wo's rows w kw .., columns: chunk c's
        const int c = s / nwin, w = s % nwin;
        for (int i = threadIdx.x; i < kw * (NC / 8); i += 2 * R) {
          const int r = i / (NC / 8), cc = i % (NC / 8);
          const int kr = w * kw + r, col = c * NC + 8 * cc;
          const bool in = kr < d && col < inner;
          cp_async16(dst + Sw128::offset(r, cc, kw), wo + (in ? (long long)kr * inner + col : 0), in);
        }
      },
      [] {}, [&](int r, int col, uint4 v) { store8(dout, m0, m, inner, r, col, v); });
}

// ---------------------------------------------------------------------------
// K6b launch 6: the row pass
// ---------------------------------------------------------------------------

constexpr int BM = 128;       // rows a block of the row pass: two warpgroups of 64
constexpr int PT = 2 * BM;    // its threads
constexpr int PW = PT / 32;   // its warps

// Shared memory of the row pass at width D with slabs of NB x 64 columns,
// from its 1024-byte aligned start. Where D fits one slab ("whole"): x's
// tile [BM, dp] (dp = D rounded up to 64); then two stages, each dqkv's
// window [BM, 64] and [Wq; Wkv]'s rows [64, NB x 64] of the slab, which
// dhid in f32 [BM, dp + 8] overlays once the products are done (whole);
// g1 and g2 [dp]; each warp's column sums of dg1 and dg2, f32 [PW][2][dp];
// the alignment slack.
struct RowsLayout {
  bool whole;
  uint32_t stage, stage_bytes, dh_pitch, g, wsum, bytes;
};

__host__ __device__ inline RowsLayout rows_layout(int d, int nb) {
  const uint32_t dp = pad64(d);
  RowsLayout L;
  L.whole = d <= 64 * nb;
  L.stage = L.whole ? BM * dp * 2 : 0;
  L.stage_bytes = BM * 64 * 2 + 64 * nb * 64 * 2;
  L.dh_pitch = dp + 8;
  uint32_t region = 2 * L.stage_bytes;
  if (L.whole && BM * L.dh_pitch * 4 > region) region = BM * L.dh_pitch * 4;
  L.g = L.stage + (region + 1023) / 1024 * 1024;
  L.wsum = L.g + 2 * dp * 2;
  L.bytes = L.wsum + PW * 2 * dp * 4 + 1024;
  return L;
}

// The row pass's slab width in 64-column blocks at width D.
__host__ __device__ inline int rows_nb(int d) { return pad64(d) / 64 < 4 ? pad64(d) / 64 : 4; }

template <int V>
using Level = std::integral_constant<int, V>;

// Block of BM rows of [M, D], two warpgroups. dhid = dqkv . [Wq; Wkv] on
// wgmma, a slab of NB x 64 columns at a time (NB = 4 past D = 256): dqkv's
// columns and the weight rows streamed in windows of 64, two stages, the
// f32 accumulator in registers (a thread holds rows rb and rb + 8, columns
// 64 cb + 8 j + 2 t4 and the next); each slab's dhid goes to shared memory
// where D fits one slab, else to the f32 workspace dh [M, D]. Then both
// LayerNorm backwards a warp two rows at a time, their reductions in
// flight together: lane l takes the column pairs 2 l + 64 k (k < NB) of
// each slab. Where D fits one slab a row's x (from its tile) and dhid are
// read once and each derived value -- z1, a, z2, da -- formed once, in
// registers; past it each of the seven passes over a row re-reads x and
// dhid (global memory) and re-derives them. dx = round(dy + dx_ln); each
// warp adds its rows' dg1 / dg2 terms to its own columns of shared memory
// in row order, and the block's sums (vec_part[block] = dg1 [d], then dg2
// [d]) add the warps' in warp order: no atomics, the same bits from run to
// run.
template <int NB>
__global__ void __launch_bounds__(PT, 1)
block_attn_bwd_rows_kernel(const bf16* __restrict__ x, const bf16* __restrict__ g1, const bf16* __restrict__ g2,
                           const bf16* __restrict__ wq, const bf16* __restrict__ wkv,
                           const bf16* __restrict__ dqkv, const bf16* __restrict__ dy, bf16* __restrict__ dx,
                           float* __restrict__ dh, float* __restrict__ vec_part, int m, int d, int inner) {
  constexpr int SW = 64 * NB;  // columns a slab
  extern __shared__ unsigned char smem_raw[];
  unsigned char* sm;
  const uint32_t sa = aligned_smem(smem_raw, &sm);
  const RowsLayout L = rows_layout(d, NB);
  const int dp = pad64(d);
  const int width = 3 * inner;
  const int nslab = (d + SW - 1) / SW;
  const long long m0 = (long long)blockIdx.x * BM;
  const int wg = threadIdx.x / 128, warp = threadIdx.x / 32, lane = threadIdx.x % 32, t4 = lane & 3;
  const int rb = wg * 64 + (warp % 4) * 16 + lane / 4;
  float* dh_s = reinterpret_cast<float*>(sm + L.stage);  // dhid over the stages (whole)

  // x's tile (whole) and the gains (zeros past m and d), copied with the
  // first window; the warps' column sums start at 0
  if (L.whole)
    for (int i = threadIdx.x; i < BM * (dp / 8); i += PT) {
      const int r = i / (dp / 8), c = i % (dp / 8);
      const bool in = m0 + r < m && 8 * c < d;
      cp_async16(sa + Sw128::offset(r, c, BM), x + (in ? (m0 + r) * d + 8 * c : 0), in);
    }
  for (int i = threadIdx.x; i < 2 * (dp / 8); i += PT) {
    const int which = i / (dp / 8), c = i % (dp / 8);
    const bool in = 8 * c < d;
    cp_async16(sa + L.g + which * dp * 2 + 16 * c, (which ? g2 : g1) + (in ? 8 * c : 0), in);
  }
  float* wsum = reinterpret_cast<float*>(sm + L.wsum);
  for (int i = threadIdx.x; i < PW * 2 * dp; i += PT) wsum[i] = 0.0f;
  // window k0 of slab c0: dqkv's columns and [Wq; Wkv]'s rows [k0, k0 + 64),
  // the rows' columns [c0, c0 + SW)
  auto load = [&](int c0, int k0, int stage) {
    const uint32_t st = sa + L.stage + stage * L.stage_bytes;
    for (int i = threadIdx.x; i < BM * 8; i += PT) {
      const int r = i / 8, cc = i % 8;
      const bool in = m0 + r < m && k0 + 8 * cc < width;
      cp_async16(st + Sw128::offset(r, cc, BM), dqkv + (in ? (m0 + r) * width + k0 + 8 * cc : 0), in);
    }
    for (int i = threadIdx.x; i < 64 * (SW / 8); i += PT) {
      const int r = i / (SW / 8), cc = i % (SW / 8);
      const int j = k0 + r, col = c0 + 8 * cc;
      const bool in = j < width && col < d;
      const bf16* w = j < inner ? wq + (long long)j * d : wkv + (long long)(j - inner) * d;
      cp_async16(st + BM * 128 + Sw128::offset(r, cc, 64), in ? w + col : wq, in);
    }
  };

  for (int c0 = 0; c0 < d; c0 += SW) {
    if (c0) __syncthreads();  // every warpgroup is done with the stages
    load(c0, 0, 0);
    cp_async_commit();
    float acc[NB][32];
#pragma unroll
    for (int cb = 0; cb < NB; ++cb)
#pragma unroll
      for (int i = 0; i < 32; ++i) acc[cb][i] = 0.0f;
    for (int k0 = 0, stage = 0; k0 < width; k0 += 64, stage ^= 1) {
      cp_async_wait_all();
      fence_async_smem();
      __syncthreads();  // window k0 (and x, the gains) have landed; the other stage is free
      if (k0 + 64 < width) {
        load(c0, k0 + 64, stage ^ 1);
        cp_async_commit();
      }
      const uint32_t st = sa + L.stage + stage * L.stage_bytes;
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        if (k0 + 16 * kk >= width) continue;  // width is a multiple of 16
        const uint64_t da = Sw128::kmajor(st + wg * 64 * 128, BM, kk);
#pragma unroll
        for (int cb = 0; cb < NB; ++cb)
          wgmma_ss_n64<0, 1>(acc[cb], da, Sw128::mnmajor(st + BM * 128 + cb * 64 * 128, 64, kk));
      }
      wgmma_commit();
      wgmma_wait_all();
#pragma unroll
      for (int cb = 0; cb < NB; ++cb) keep(acc[cb]);
    }
    if (L.whole) __syncthreads();  // every warpgroup is done with the stages dhid overlays
#pragma unroll
    for (int cb = 0; cb < NB; ++cb)
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int hi = 0; hi < 2; ++hi) {
          const int r = rb + 8 * hi, col = c0 + 64 * cb + 8 * j + 2 * t4;
          const float2 v = make_float2(acc[cb][4 * j + 2 * hi], acc[cb][4 * j + 2 * hi + 1]);
          if (L.whole)
            *reinterpret_cast<float2*>(dh_s + r * L.dh_pitch + col) = v;
          else if (m0 + r < m && col < d)
            *reinterpret_cast<float2*>(dh + (m0 + r) * d + col) = v;
        }
  }
  __syncthreads();  // the block's rows of dhid are written; the warps' sums are 0

  // both LayerNorm backwards (pallas_block_attn.py:56-62). The registers of
  // a slab hold, by level: 0 x and dhid; 1 z1 (in place of x) and a =
  // round(z1 g1); 2 z2 in place of a; 3 da = (dhid g2 - p1 - z2 p2) rstd2 in
  // place of dhid. Past d (and m) x, dhid and the gains are 0.
  const __nv_bfloat162* gs1 = reinterpret_cast<const __nv_bfloat162*>(sm + L.g);
  const __nv_bfloat162* gs2 = reinterpret_cast<const __nv_bfloat162*>(sm + L.g + dp * 2);
  auto gain = [&](const __nv_bfloat162* g, int c) {  // (the last slab may reach past dp)
    return c < d ? __bfloat1622float2(g[c / 2]) : make_float2(0.0f, 0.0f);
  };
  for (int r0 = 2 * warp; r0 < BM; r0 += 2 * PW) {
    float2 xv[2][NB], hv[2][NB], av[2][NB];
    float mean1[2], rstd1[2], mean2[2], rstd2[2], p1[2], p2[2], t1[2], t2[2];
    int level = -1;
    auto col = [&](int sl, int k) { return sl * SW + 2 * lane + 64 * k; };
    // derives level V from level V - 1 in place
    auto derive = [&](int sl, auto v) {
      constexpr int V = decltype(v)::value;
#pragma unroll
      for (int u = 0; u < 2; ++u)
#pragma unroll
        for (int k = 0; k < NB; ++k) {
          const int c = col(sl, k);
          if constexpr (V == 1) {
            const float2 ga = gain(gs1, c);
            xv[u][k] = make_float2((xv[u][k].x - mean1[u]) * rstd1[u], (xv[u][k].y - mean1[u]) * rstd1[u]);
            av[u][k] = __bfloat1622float2(__floats2bfloat162_rn(xv[u][k].x * ga.x, xv[u][k].y * ga.y));
          } else if constexpr (V == 2) {
            av[u][k] = make_float2((av[u][k].x - mean2[u]) * rstd2[u], (av[u][k].y - mean2[u]) * rstd2[u]);
          } else {
            const float2 gb = gain(gs2, c);
            hv[u][k] = make_float2((hv[u][k].x * gb.x - p1[u] - av[u][k].x * p2[u]) * rstd2[u],
                                   (hv[u][k].y * gb.y - p1[u] - av[u][k].y * p2[u]) * rstd2[u]);
          }
        }
    };
    // the registers of slab sl at level W: where D takes several slabs,
    // loaded and derived up to W; where it takes one, loaded once and
    // derived one level further at each pass that asks for it (the passes
    // ask for 0, 0, 1, 1, 2, 3, 3)
    auto reach = [&](int sl, auto want) {
      constexpr int W = decltype(want)::value;
      if (!L.whole || level < 0) {
#pragma unroll
        for (int u = 0; u < 2; ++u) {
          const int r = r0 + u;
#pragma unroll
          for (int k = 0; k < NB; ++k) {
            const int c = col(sl, k);
            if (L.whole) {
              xv[u][k] = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(
                  sm + Sw128::offset(r, c / 8, BM) + 2 * (c % 8)));
              hv[u][k] = *reinterpret_cast<const float2*>(dh_s + r * L.dh_pitch + c);
            } else {
              const bool in = m0 + r < m && c < d;
              xv[u][k] = in ? __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(x + (m0 + r) * d + c))
                            : make_float2(0.0f, 0.0f);
              hv[u][k] = in ? *reinterpret_cast<const float2*>(dh + (m0 + r) * d + c) : make_float2(0.0f, 0.0f);
            }
          }
        }
        if constexpr (W >= 1) derive(sl, Level<1>{});
        if constexpr (W >= 2) derive(sl, Level<2>{});
        if constexpr (W >= 3) derive(sl, Level<3>{});
      } else if constexpr (W >= 1) {
        if (level < W) derive(sl, Level<W>{});
      }
      level = W;
    };
    // one pass over the row pair's slabs at level `want`: body(u, k,
    // column, a, b) for each column pair, then the two rows' means of a
    // (and of b)
    auto pass = [&](auto want, float (&a)[2], float (&b)[2], bool two, auto&& body) {
      a[0] = a[1] = b[0] = b[1] = 0.0f;
      for (int sl = 0; sl < nslab; ++sl) {
        reach(sl, want);
#pragma unroll
        for (int u = 0; u < 2; ++u)
#pragma unroll
          for (int k = 0; k < NB; ++k) body(u, k, col(sl, k), a[u], b[u]);
      }
#pragma unroll
      for (int u = 0; u < 2; ++u) a[u] = warp_sum(a[u]) / d;
      if (two)
#pragma unroll
        for (int u = 0; u < 2; ++u) b[u] = warp_sum(b[u]) / d;
    };
    float unused[2];
    // LN1's statistics: mean1, then rstd1 (two passes, as jnp.var)
    pass(Level<0>{}, mean1, unused, false, [&](int u, int k, int, float& a, float&) { a += xv[u][k].x + xv[u][k].y; });
    pass(Level<0>{}, rstd1, unused, false, [&](int u, int k, int c, float& a, float&) {
      const float2 t = make_float2(xv[u][k].x - mean1[u], xv[u][k].y - mean1[u]);
      if (c < d) a += t.x * t.x + t.y * t.y;
    });
#pragma unroll
    for (int u = 0; u < 2; ++u) rstd1[u] = 1.0f / sqrtf(rstd1[u] + LN_EPS);
    // LN2's, on a = round(z1 g1)
    pass(Level<1>{}, mean2, unused, false, [&](int u, int k, int, float& a, float&) { a += av[u][k].x + av[u][k].y; });
    pass(Level<1>{}, rstd2, unused, false, [&](int u, int k, int c, float& a, float&) {
      const float2 t = make_float2(av[u][k].x - mean2[u], av[u][k].y - mean2[u]);
      if (c < d) a += t.x * t.x + t.y * t.y;
    });
#pragma unroll
    for (int u = 0; u < 2; ++u) rstd2[u] = 1.0f / sqrtf(rstd2[u] + LN_EPS);
    float* dg1s = wsum + warp * 2 * dp;
    float* dg2s = dg1s + dp;
    // LN2's backward sums p1 = mean(dz), p2 = mean(dz z2), dz = dhid g2; dg2 += dhid z2
    pass(Level<2>{}, p1, p2, true, [&](int u, int k, int c, float& a, float& b) {
      const float2 gb = gain(gs2, c);
      const float2 dz = make_float2(hv[u][k].x * gb.x, hv[u][k].y * gb.y);
      a += dz.x + dz.y;
      b += dz.x * av[u][k].x + dz.y * av[u][k].y;
      if (c < d) {
        float2* s = reinterpret_cast<float2*>(dg2s + c);
        *s = make_float2(s->x + hv[u][k].x * av[u][k].x, s->y + hv[u][k].y * av[u][k].y);
      }
    });
    // LN1's: t1 = mean(dz), t2 = mean(dz z1), dz = da g1; dg1 += da z1
    pass(Level<3>{}, t1, t2, true, [&](int u, int k, int c, float& a, float& b) {
      const float2 ga = gain(gs1, c);
      const float2 dz = make_float2(hv[u][k].x * ga.x, hv[u][k].y * ga.y);
      a += dz.x + dz.y;
      b += dz.x * xv[u][k].x + dz.y * xv[u][k].y;
      if (c < d) {
        float2* s = reinterpret_cast<float2*>(dg1s + c);
        *s = make_float2(s->x + hv[u][k].x * xv[u][k].x, s->y + hv[u][k].y * xv[u][k].y);
      }
    });
    // dx = round(dy + (da g1 - t1 - z1 t2) rstd1)
    for (int sl = 0; sl < nslab; ++sl) {
      reach(sl, Level<3>{});
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        const long long row = m0 + r0 + u;
        if (row >= m) continue;
#pragma unroll
        for (int k = 0; k < NB; ++k) {
          const int c = col(sl, k);
          if (c >= d) continue;
          const float2 ga = gain(gs1, c);
          const long long at = row * d + c;
          const float2 dyf = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(dy + at));
          const float dx0 = (hv[u][k].x * ga.x - t1[u] - xv[u][k].x * t2[u]) * rstd1[u];
          const float dx1 = (hv[u][k].y * ga.y - t1[u] - xv[u][k].y * t2[u]) * rstd1[u];
          *reinterpret_cast<__nv_bfloat162*>(dx + at) = __floats2bfloat162_rn(dyf.x + dx0, dyf.y + dx1);
        }
      }
    }
  }
  __syncthreads();
  for (int c = threadIdx.x; c < 2 * d; c += PT) {
    const int which = c / d, col = c % d;
    float sum = 0.0f;
#pragma unroll
    for (int w = 0; w < PW; ++w) sum += wsum[(w * 2 + which) * dp + col];
    vec_part[(long long)blockIdx.x * 2 * d + c] = sum;
  }
}

// ---------------------------------------------------------------------------
// Launchers: each kernel's shared-memory limit is set once per device (a
// static flag of a static function: one per library, hopper::allow_smem)
// ---------------------------------------------------------------------------

template <int R>
cudaError_t launch_proj_r(const bf16* x, const bf16* g1, const bf16* g2, const bf16* wq, const bf16* wkv, bf16* qkv,
                          bf16* h_out, int m, int d, int inner, cudaStream_t stream) {
  static std::atomic<unsigned> ready{0};
  cudaError_t err = allow_smem((const void*)block_attn_proj_kernel<R>, MAX_SMEM, ready);
  if (err != cudaSuccess) return err;
  block_attn_proj_kernel<R><<<(m + R - 1) / R, 2 * R, rp_layout<R>(d).bytes, stream>>>(x, g1, g2, wq, wkv, qkv,
                                                                                     h_out, m, d, inner);
  return cudaGetLastError();
}

cudaError_t launch_proj(const bf16* x, const bf16* g1, const bf16* g2, const bf16* wq, const bf16* wkv, bf16* qkv,
                        bf16* h_out, int m, int d, int inner, cudaStream_t stream) {
  return rows_for(d) == 128 ? launch_proj_r<128>(x, g1, g2, wq, wkv, qkv, h_out, m, d, inner, stream)
                            : launch_proj_r<64>(x, g1, g2, wq, wkv, qkv, h_out, m, d, inner, stream);
}

template <int R>
cudaError_t launch_out_r(const bf16* out, const bf16* x, const bf16* wo, bf16* y, int m, int d, int inner,
                         cudaStream_t stream) {
  static std::atomic<unsigned> ready{0};
  cudaError_t err = allow_smem((const void*)block_attn_out_kernel<R>, MAX_SMEM, ready);
  if (err != cudaSuccess) return err;
  block_attn_out_kernel<R><<<(m + R - 1) / R, 2 * R, rp_layout<R>(inner).bytes, stream>>>(out, x, wo, y, m, d,
                                                                                        inner);
  return cudaGetLastError();
}

cudaError_t launch_out(const bf16* out, const bf16* x, const bf16* wo, bf16* y, int m, int d, int inner,
                       cudaStream_t stream) {
  return rows_for(inner) == 128 ? launch_out_r<128>(out, x, wo, y, m, d, inner, stream)
                                : launch_out_r<64>(out, x, wo, y, m, d, inner, stream);
}

template <int R>
cudaError_t launch_dout_r(const bf16* dy, const bf16* wo, bf16* dout, int m, int d, int inner, cudaStream_t stream) {
  static std::atomic<unsigned> ready{0};
  cudaError_t err = allow_smem((const void*)block_attn_dout_kernel<R>, MAX_SMEM, ready);
  if (err != cudaSuccess) return err;
  block_attn_dout_kernel<R><<<(m + R - 1) / R, 2 * R, rp_layout<R>(d).bytes, stream>>>(dy, wo, dout, m, d, inner);
  return cudaGetLastError();
}

cudaError_t launch_dout(const bf16* dy, const bf16* wo, bf16* dout, int m, int d, int inner, cudaStream_t stream) {
  return rows_for(d) == 128 ? launch_dout_r<128>(dy, wo, dout, m, d, inner, stream)
                            : launch_dout_r<64>(dy, wo, dout, m, d, inner, stream);
}

template <int NB>
cudaError_t launch_rows_nb(const bf16* x, const bf16* g1, const bf16* g2, const bf16* wq, const bf16* wkv,
                           const bf16* dqkv, const bf16* dy, bf16* dx, float* dh, float* vec, int m, int d, int inner,
                           cudaStream_t stream) {
  static std::atomic<unsigned> ready{0};
  cudaError_t err = allow_smem((const void*)block_attn_bwd_rows_kernel<NB>, MAX_SMEM, ready);
  if (err != cudaSuccess) return err;
  block_attn_bwd_rows_kernel<NB><<<(m + BM - 1) / BM, PT, rows_layout(d, NB).bytes, stream>>>(
      x, g1, g2, wq, wkv, dqkv, dy, dx, dh, vec, m, d, inner);
  return cudaGetLastError();
}

// The row pass at NB = rows_nb(d).
cudaError_t launch_rows(const bf16* x, const bf16* g1, const bf16* g2, const bf16* wq, const bf16* wkv,
                        const bf16* dqkv, const bf16* dy, bf16* dx, float* dh, float* vec, int m, int d, int inner,
                        cudaStream_t stream) {
  switch (rows_nb(d)) {
    case 1: return launch_rows_nb<1>(x, g1, g2, wq, wkv, dqkv, dy, dx, dh, vec, m, d, inner, stream);
    case 2: return launch_rows_nb<2>(x, g1, g2, wq, wkv, dqkv, dy, dx, dh, vec, m, d, inner, stream);
    case 3: return launch_rows_nb<3>(x, g1, g2, wq, wkv, dqkv, dy, dx, dh, vec, m, d, inner, stream);
    default: return launch_rows_nb<4>(x, g1, g2, wq, wkv, dqkv, dy, dx, dh, vec, m, d, inner, stream);
  }
}

// K1's view of the [B, N, 3I] workspace: q, k, v at 0, I, 2I
zorro::Operands slab(const bf16* qkv, int n, int inner) {
  return {qkv, qkv + inner, qkv + 2 * inner, (long long)n * 3 * inner, 3LL * inner};
}

template <int DH>
cudaError_t run_fwd(const bf16* x, const int32_t* types, const bf16* g1, const bf16* g2, const bf16* wq,
                    const bf16* wkv, const bf16* wo, bf16* y, bf16* qkv_ws, bf16* out_ws, int batch, int n, int d,
                    int heads, float scale, int fusion_type, cudaStream_t stream) {
  const int inner = heads * DH;
  const int m = batch * n;
  cudaError_t err = launch_proj(x, g1, g2, wq, wkv, qkv_ws, nullptr, m, d, inner, stream);
  if (err != cudaSuccess) return err;
  err = zorro::launch<DH, zorro::MODE_ZORRO>(slab(qkv_ws, n, inner), types, nullptr, 0, out_ws, nullptr, batch, n,
                                             heads, (long long)n * inner, inner, n, scale, fusion_type, stream);
  if (err != cudaSuccess) return err;
  return launch_out(out_ws, x, wo, y, m, d, inner, stream);
}

struct BwdArgs {
  const bf16* x;
  const int32_t* types;
  const bf16* g1;
  const bf16* g2;
  const bf16* wq;
  const bf16* wkv;
  const bf16* wo;
  const bf16* dy;
  bf16* dx;
  bf16* dg1;
  bf16* dg2;
  bf16* dw_qkv;
  bf16* dwo;
  bf16* qkv_ws;
  bf16* h_ws;
  bf16* out_ws;
  bf16* dout_ws;
  float* lse;
  float* delta;
  bf16* dqkv_ws;
  float* dh_ws;
  float* part;
  float* vec;
};

template <int DH>
cudaError_t run_bwd(const BwdArgs& a, int batch, int n, int d, int heads, float scale, int fusion_type,
                    int splits, cudaStream_t stream) {
  const int inner = heads * DH;
  const int m = batch * n;
  cudaError_t err = launch_proj(a.x, a.g1, a.g2, a.wq, a.wkv, a.qkv_ws, a.h_ws, m, d, inner, stream);
  if (err != cudaSuccess) return err;
  err = launch_dout(a.dy, a.wo, a.dout_ws, m, d, inner, stream);
  if (err != cudaSuccess) return err;
  const zorro::Operands in = slab(a.qkv_ws, n, inner);
  err = zorro::launch<DH, zorro::MODE_ZORRO, true>(in, a.types, nullptr, 0, a.out_ws, a.lse, batch, n, heads,
                                                   (long long)n * inner, inner, n, scale, fusion_type, stream,
                                                   {a.dout_ws, a.delta});
  if (err != cudaSuccess) return err;
  const zorro::GradOperands grad{a.dqkv_ws, a.dqkv_ws + inner, a.dqkv_ws + 2 * inner, (long long)n * 3 * inner,
                                 3LL * inner};
  err = zorro::launch_bwd<DH, zorro::MODE_ZORRO>(in, a.types, nullptr, 0, a.out_ws, a.lse, a.dout_ws, grad,
                                                 a.delta, 1, batch, n, heads, n, scale, fusion_type, stream);
  if (err != cudaSuccess) return err;
  err = launch_rows(a.x, a.g1, a.g2, a.wq, a.wkv, a.dqkv_ws, a.dy, a.dx, a.dh_ws, a.vec, m, d, inner, stream);
  if (err != cudaSuccess) return err;
  const wgrad::WGrad g0{a.dqkv_ws, a.h_ws, a.part, 3 * inner, d};
  const wgrad::WGrad g1{a.dy, a.out_ws, a.part + (long long)splits * 3 * inner * d, d, inner};
  return wgrad::launch(g0, a.dw_qkv, g1, a.dwo, m, splits, a.vec, (m + BM - 1) / BM, d, a.dg1, d, a.dg2, stream);
}

bool shape_ok(int batch, int n, int d, int heads, int dh) {
  return batch >= 1 && n >= 1 && heads >= 1 && d >= 16 && d % 16 == 0 && d <= MAX_D && heads * dh <= MAX_D;
}

}  // namespace

// Rows per block of the backward's row pass: the gain partials are f32
// [ceil(B * N / this), 2 * D].
extern "C" int fused_block_attn_row_block() { return BM; }

// Floats of the backward's dhid workspace at M = B * N rows and width D: 0
// where the row pass keeps dhid in shared memory (D <= 256), else M * D.
extern "C" long long fused_block_attn_bwd_dh_floats(int m, int d) {
  return rows_layout(d, rows_nb(d)).whole ? 0 : (long long)m * d;
}

// The row ranges of the backward's weight-gradient products at M = B * N
// rows (wgrad::splits_for): the backward's `splits`, by which its caller
// sizes `part`.
extern "C" int fused_block_attn_bwd_splits(int m, int d, int inner) {
  return wgrad::splits_for(3 * inner, d, d, inner, m);
}

// Forward: x, y [B, N, D]; types int32 [B, N] (PAD_TYPE = padding); g1, g2
// [D]; wq [I, D]; wkv [2I, D]; wo [D, I]; workspaces qkv [B, N, 3I] and out
// [B, N, I]. All bf16 but types, contiguous. D % 16 == 0, D and I up to
// 1664, dh in {32, 64, 128}. Three launches; returns the first cudaError_t.
extern "C" int fused_block_attn_fwd_bf16(const void* x, const void* types, const void* g1, const void* g2,
                                         const void* wq, const void* wkv, const void* wo, void* y, void* qkv_ws,
                                         void* out_ws, int batch, int n, int d, int heads, int dh, float scale,
                                         int fusion_type, void* stream) {
  if (!shape_ok(batch, n, d, heads, dh)) return (int)cudaErrorInvalidValue;
  const bf16* xp = static_cast<const bf16*>(x);
  const int32_t* tp = static_cast<const int32_t*>(types);
  const bf16 *g1p = static_cast<const bf16*>(g1), *g2p = static_cast<const bf16*>(g2);
  const bf16 *wqp = static_cast<const bf16*>(wq), *wkvp = static_cast<const bf16*>(wkv);
  const bf16* wop = static_cast<const bf16*>(wo);
  bf16* yp = static_cast<bf16*>(y);
  bf16* ws = static_cast<bf16*>(qkv_ws);
  bf16* os = static_cast<bf16*>(out_ws);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dh) {
    case 32:
      return (int)run_fwd<32>(xp, tp, g1p, g2p, wqp, wkvp, wop, yp, ws, os, batch, n, d, heads, scale, fusion_type, s);
    case 64:
      return (int)run_fwd<64>(xp, tp, g1p, g2p, wqp, wkvp, wop, yp, ws, os, batch, n, d, heads, scale, fusion_type, s);
    case 128:
      return (int)run_fwd<128>(xp, tp, g1p, g2p, wqp, wkvp, wop, yp, ws, os, batch, n, d, heads, scale, fusion_type,
                               s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

// K6b's launch 3 alone, for testing it against K1: K1's forward with the D
// epilogue on the fused slab qkv [B, N, 3I] and types [B, N] (PAD_TYPE =
// padding), dout [B, N, I]; writes out [B, N, I] (bf16), lse and delta
// [B, H, N] (f32). One launch; returns its cudaError_t.
extern "C" int fused_block_attn_attend_bf16(const void* qkv, const void* types, const void* dout, void* out,
                                            void* lse, void* delta, int batch, int n, int heads, int dh,
                                            float scale, int fusion_type, void* stream) {
  if (batch < 1 || n < 1 || heads < 1) return (int)cudaErrorInvalidValue;
  const int inner = heads * dh;
  const zorro::Operands in = slab(static_cast<const bf16*>(qkv), n, inner);
  const int32_t* tp = static_cast<const int32_t*>(types);
  bf16* op = static_cast<bf16*>(out);
  float* lp = static_cast<float*>(lse);
  const zorro::DeltaOut dlt{static_cast<const bf16*>(dout), static_cast<float*>(delta)};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dh) {
    case 32:
      return (int)zorro::launch<32, zorro::MODE_ZORRO, true>(in, tp, nullptr, 0, op, lp, batch, n, heads,
                                                             (long long)n * inner, inner, n, scale, fusion_type, s,
                                                             dlt);
    case 64:
      return (int)zorro::launch<64, zorro::MODE_ZORRO, true>(in, tp, nullptr, 0, op, lp, batch, n, heads,
                                                             (long long)n * inner, inner, n, scale, fusion_type, s,
                                                             dlt);
    case 128:
      return (int)zorro::launch<128, zorro::MODE_ZORRO, true>(in, tp, nullptr, 0, op, lp, batch, n, heads,
                                                              (long long)n * inner, inner, n, scale, fusion_type, s,
                                                              dlt);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

// Backward: the forward's operands and dy [B, N, D]; outputs dx [B, N, D],
// dg1, dg2 [D], dw_qkv [3I, D] (dWq then dWkv), dwo [D, I]; bf16
// workspaces qkv and dqkv [B, N, 3I], h [B, N, D], out and dout [B, N, I];
// f32 workspaces lse and delta [B, H, N], dh (the row pass's dhid;
// floats: fused_block_attn_bwd_dh_floats), part [splits * (3I * D + D * I)] (splits:
// fused_block_attn_bwd_splits), vec [ceil(B * N / row_block), 2D]. Eight
// launches; returns the first cudaError_t.
extern "C" int fused_block_attn_bwd_bf16(const void* x, const void* types, const void* g1, const void* g2,
                                         const void* wq, const void* wkv, const void* wo, const void* dy, void* dx,
                                         void* dg1, void* dg2, void* dw_qkv, void* dwo, void* qkv_ws, void* h_ws,
                                         void* out_ws, void* dout_ws, void* lse, void* delta, void* dqkv_ws,
                                         void* dh_ws, void* part, void* vec, int batch, int n, int d, int heads, int dh,
                                         float scale, int fusion_type, int splits, void* stream) {
  if (!shape_ok(batch, n, d, heads, dh) || splits < 1) return (int)cudaErrorInvalidValue;
  const BwdArgs a{static_cast<const bf16*>(x),  static_cast<const int32_t*>(types), static_cast<const bf16*>(g1),
                  static_cast<const bf16*>(g2), static_cast<const bf16*>(wq),       static_cast<const bf16*>(wkv),
                  static_cast<const bf16*>(wo), static_cast<const bf16*>(dy),       static_cast<bf16*>(dx),
                  static_cast<bf16*>(dg1),      static_cast<bf16*>(dg2),            static_cast<bf16*>(dw_qkv),
                  static_cast<bf16*>(dwo),      static_cast<bf16*>(qkv_ws),         static_cast<bf16*>(h_ws),
                  static_cast<bf16*>(out_ws),   static_cast<bf16*>(dout_ws),        static_cast<float*>(lse),
                  static_cast<float*>(delta),   static_cast<bf16*>(dqkv_ws),        static_cast<float*>(dh_ws),
                  static_cast<float*>(part),    static_cast<float*>(vec)};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dh) {
    case 32:
      return (int)run_bwd<32>(a, batch, n, d, heads, scale, fusion_type, splits, s);
    case 64:
      return (int)run_bwd<64>(a, batch, n, d, heads, scale, fusion_type, splits, s);
    case 128:
      return (int)run_bwd<128>(a, batch, n, d, heads, scale, fusion_type, splits, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

// ---------------------------------------------------------------------------
// The f32 instance
// ---------------------------------------------------------------------------

namespace {

struct BlockF32Scratch {  // float offsets into the f32 workspace
  long long a, h, qkv, out, dout, lse, delta, dqkv, dhid, da, part_qkv, part_o, part_g2, part_g1, floats;
};

BlockF32Scratch block_f32_scratch(int backward, int batch, int n, int d, int inner, int heads) {
  const long long m = (long long)batch * n, sp = simt_f32::splits_for((int)m);
  BlockF32Scratch s{};
  s.a = 0;
  s.h = s.a + m * d;
  s.qkv = s.h + m * d;
  s.out = s.qkv + 3 * m * inner;
  s.floats = s.out + m * inner;
  if (backward) {
    s.dout = s.floats;
    s.lse = s.dout + m * inner;
    s.delta = s.lse + (long long)batch * heads * n;
    s.dqkv = s.delta + (long long)batch * heads * n;
    s.dhid = s.dqkv + 3 * m * inner;
    s.da = s.dhid + m * d;
    s.part_qkv = s.da + m * d;
    s.part_o = s.part_qkv + sp * 3 * inner * d;
    s.part_g2 = s.part_o + sp * d * inner;
    s.part_g1 = s.part_g2 + (long long)simt_f32::ln_blocks((int)m) * d;
    s.floats = s.part_g1 + (long long)simt_f32::ln_blocks((int)m) * d;
  }
  return s;
}

// a = LN_g1(x), h = LN_g2(a), then q = h Wq^T and kv = h Wkv^T into the slab
cudaError_t block_f32_project(const float* x, const float* g1, const float* g2, const float* wq, const float* wkv,
                              float* a, float* h, float* qkv, int m, int d, int inner, cudaStream_t s) {
  using namespace simt_f32;
  cudaError_t err = ln_fwd(x, g1, a, m, d, s);
  if (err == cudaSuccess) err = ln_fwd(a, g2, h, m, d, s);
  if (err == cudaSuccess)
    err = product_store(Mat{h, d, 1}, Mat{wq, 1, d}, qkv, 3LL * inner, m, inner, d, nullptr, nullptr, 0, s);
  if (err == cudaSuccess)
    err = product_store(Mat{h, d, 1}, Mat{wkv, 1, d}, qkv + inner, 3LL * inner, m, 2 * inner, d, nullptr, nullptr,
                        0, s);
  return err;
}

zorro::Operands32 slab32(const float* qkv, int n, int inner) {
  return zorro::Operands32{qkv, qkv + inner, qkv + 2 * inner, 3LL * n * inner, 3LL * inner};
}

}  // namespace

// Floats of the f32 instance's workspace (backward 0: the forward's, 1:
// the backward's) at these shapes
extern "C" long long fused_block_attn_f32_scratch_floats(int backward, int batch, int n, int d, int inner,
                                                         int heads) {
  return block_f32_scratch(backward, batch, n, d, inner, heads).floats;
}

// Forward in f32: the operands of fused_block_attn_fwd_bf16 in f32 (types
// int32), the workspace of fused_block_attn_f32_scratch_floats(0, ...)
// floats. Six launches; returns the first cudaError_t.
extern "C" int fused_block_attn_fwd_f32(const void* x, const void* types, const void* g1, const void* g2,
                                        const void* wq, const void* wkv, const void* wo, void* y, void* ws, int batch,
                                        int n, int d, int heads, int dh, float scale, int fusion_type, void* stream) {
  if (!shape_ok(batch, n, d, heads, dh)) return (int)cudaErrorInvalidValue;
  using namespace simt_f32;
  const int inner = heads * dh, m = batch * n;
  const BlockF32Scratch sc = block_f32_scratch(0, batch, n, d, inner, heads);
  float* p = static_cast<float*>(ws);
  const float* xp = static_cast<const float*>(x);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = block_f32_project(xp, static_cast<const float*>(g1), static_cast<const float*>(g2),
                                      static_cast<const float*>(wq), static_cast<const float*>(wkv), p + sc.a,
                                      p + sc.h, p + sc.qkv, m, d, inner, s);
  if (err == cudaSuccess)
    err = zorro::dispatch_f32<zorro::MODE_ZORRO>(dh, slab32(p + sc.qkv, n, inner), static_cast<const int32_t*>(types),
                                                 nullptr, 0, p + sc.out, nullptr, batch, n, heads,
                                                 (long long)n * inner, inner, n, scale, fusion_type, s);
  if (err == cudaSuccess)
    err = product_store(Mat{p + sc.out, inner, 1}, Mat{static_cast<const float*>(wo), 1, inner},
                        static_cast<float*>(y), d, m, d, inner, nullptr, xp, d, s);
  return (int)err;
}

// Backward in f32: the forward's operands and dy [B, N, D] (f32, types
// int32); outputs dx [B, N, D], dg1, dg2 [D], dw_qkv [3I, D] (dWq then
// dWkv), dwo [D, I]; the workspace of fused_block_attn_f32_scratch_floats(1,
// ...) floats. Fifteen launches; returns the first cudaError_t.
extern "C" int fused_block_attn_bwd_f32(const void* x, const void* types, const void* g1, const void* g2,
                                        const void* wq, const void* wkv, const void* wo, const void* dy, void* dx,
                                        void* dg1, void* dg2, void* dw_qkv, void* dwo, void* ws, int batch, int n,
                                        int d, int heads, int dh, float scale, int fusion_type, void* stream) {
  if (!shape_ok(batch, n, d, heads, dh)) return (int)cudaErrorInvalidValue;
  using namespace simt_f32;
  const int inner = heads * dh, m = batch * n;
  const BlockF32Scratch sc = block_f32_scratch(1, batch, n, d, inner, heads);
  float* p = static_cast<float*>(ws);
  const float* xp = static_cast<const float*>(x);
  const float* dyp = static_cast<const float*>(dy);
  const float *g1p = static_cast<const float*>(g1), *g2p = static_cast<const float*>(g2);
  const float *wqp = static_cast<const float*>(wq), *wkvp = static_cast<const float*>(wkv);
  const int32_t* tp = static_cast<const int32_t*>(types);
  float *qkv = p + sc.qkv, *dqkv = p + sc.dqkv, *out = p + sc.out, *dout = p + sc.dout;
  const long long i3 = 3LL * inner;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = block_f32_project(xp, g1p, g2p, wqp, wkvp, p + sc.a, p + sc.h, qkv, m, d, inner, s);
  if (err == cudaSuccess)  // dout = dy Wo
    err = product_store(Mat{dyp, d, 1}, Mat{static_cast<const float*>(wo), inner, 1}, dout, inner, m, inner, d,
                        nullptr, nullptr, 0, s);
  if (err == cudaSuccess)
    err = zorro::dispatch_f32<zorro::MODE_ZORRO>(dh, slab32(qkv, n, inner), tp, nullptr, 0, out, p + sc.lse, batch,
                                                 n, heads, (long long)n * inner, inner, n, scale, fusion_type, s);
  if (err == cudaSuccess) {
    const zorro::GradOperands32 grad{dqkv, dqkv + inner, dqkv + 2 * inner, (long long)n * i3, i3};
    err = zorro::dispatch_bwd_f32<zorro::MODE_ZORRO>(dh, slab32(qkv, n, inner), tp, nullptr, 0, out, p + sc.lse,
                                                     dout, grad, p + sc.delta, batch, n, heads, n, scale,
                                                     fusion_type, s);
  }
  if (err == cudaSuccess)  // dhid = dq Wq + dkv Wkv
    err = product_store(Mat{dqkv, i3, 1}, Mat{wqp, d, 1}, p + sc.dhid, d, m, d, inner, nullptr, nullptr, 0, s);
  if (err == cudaSuccess)
    err = product_store(Mat{dqkv + inner, i3, 1}, Mat{wkvp, d, 1}, p + sc.dhid, d, m, d, 2 * inner, nullptr,
                        p + sc.dhid, d, s);
  if (err == cudaSuccess) err = ln_bwd(p + sc.a, g2p, p + sc.dhid, nullptr, p + sc.da, p + sc.part_g2, m, d, s);
  if (err == cudaSuccess)
    err = ln_bwd(xp, g1p, p + sc.da, dyp, static_cast<float*>(dx), p + sc.part_g1, m, d, s);
  if (err == cudaSuccess) err = weight_grad_partials(dqkv, i3, p + sc.h, d, m, 3 * inner, d, p + sc.part_qkv, s);
  if (err == cudaSuccess) err = weight_grad_partials(dyp, d, out, inner, m, d, inner, p + sc.part_o, s);
  if (err == cudaSuccess) {
    const int sp = splits_for(m), lb = ln_blocks(m);
    Segments segs{{{p + sc.part_qkv, sp, i3 * d, static_cast<float*>(dw_qkv)},
                   {p + sc.part_o, sp, (long long)d * inner, static_cast<float*>(dwo)},
                   {p + sc.part_g1, lb, d, static_cast<float*>(dg1)},
                   {p + sc.part_g2, lb, d, static_cast<float*>(dg2)}},
                  4};
    err = reduce(segs, s);
  }
  return (int)err;
}
