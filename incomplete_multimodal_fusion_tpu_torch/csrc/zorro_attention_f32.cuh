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
// runs are bitwise equal. Without the bf16 casts: every product is f32 on
// the tensor cores in three TF32 parts (3xTF32, hopper.cuh: hi hi + hi lo +
// lo hi, each part rounded by cvt.rna), which keeps close to f32's digits
// where one TF32 product keeps about three; every sum is f32.
//
// Design, the bf16 kernels' (one warpgroup a block of 64 rows, the scores
// and accumulators in wgmma's register fragments) with what TF32 changes:
//   * Operands are split into hi and lo once, as they are staged. The
//     streamed tiles (K and V; Q and dO in the dk/dv kernel) come in raw by
//     cp.async, one tile ahead into a swizzled buffer (RawTile), so their
//     loads overlap the products of the tile before; at the top of a tile a
//     register pass splits them into hi and lo tiles in the 128-byte swizzle
//     (64-byte for 16 columns). The operands a block keeps (Q and dO; K and
//     V) are loaded and split once. Loading the streamed tiles in the
//     register pass itself, behind the barrier, cost the dk/dv kernel 0.87
//     of its 1.49 ms and the dq kernel 0.42 of 0.94 (N = 640, B = 60 on an
//     H100; tools/bench_zorro_f32.py on a build without those loads).
//   * TF32 wgmma reads B only K-major, so the B operands contracted over a
//     tile's rows are staged transposed: V^T for O = P V, K^T for dQ = dS K,
//     dO^T for dV = P^T dO and Q^T for dK = dS^T Q. A thread reads four rows
//     of four channels and writes four transposed 16-byte chunks.
//   * P and dS stay in registers as the A operand, split there. In a column
//     group of 8 a thread's accumulator holds columns (2t, 2t + 1), and the
//     TF32 A fragment columns (t, t + 4); so the transposed tiles hold the
//     rows of each group of 8 in the order (0, 2, 4, 6, 1, 3, 5, 7), and
//     the accumulator's values are the A fragment's as they stand (the sum
//     over the rows does not depend on their order).
//   * The products a tile adds to O, dQ, dK and dV are summed in a fresh
//     accumulator and added in f32 once done (add_product): the tensor
//     core rounds its sum toward zero at each wgmma, a bias that grows in
//     an accumulator running over all tiles. S and dP, one tile's sums,
//     stay in one accumulator.
//   * Blocks: the forward one warpgroup of 64 query rows, two blocks a SM
//     at dh 64 (32-key tiles; 64 at dh 32). The backward kernels two
//     warpgroups of 64 rows each (dh 128: one) on shared streamed tiles of
//     32 rows (64 at dh 32, 16 at dh 128): one warpgroup's softmax and
//     splits run beside the other's products, and a streamed tile is split
//     once for 128 rows (the backward 1.52-1.54 -> 1.12-1.14 ms at N = 640,
//     B = 60 on an H100, tools/bench_zorro_f32.py). Every kernel fits the
//     227 KB of shared memory (the dk/dv kernel: 215,552 bytes) and none
//     spills.
// What bounds it on an H100: the products, 4 (forward) and 10 (backward's
// recomputed S and dP, then dV, dK, dQ) flops a pair and channel, three
// times over at the tensor cores' dense TF32 rate (495 TFLOP/s, so 165 in
// effect), against the f32 CUDA cores' 67. A TF32 m64n64k8 wgmma runs at
// 440-490 TFLOP/s from one warpgroup a SM (tools/bench_tf32_wgmma.cu on an
// H100 at 700 W), so at the model's shapes the
// kernels sit below that bound on what runs between the products: the
// split, the softmax, the barriers.
#pragma once

#include "zorro_attention.cuh"

namespace zorro {

constexpr int F32_ROWS = 64;  // rows a block (queries, or the dk/dv kernel's keys)

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

// A tile's raw f32 rows as cp.async lands them in shared memory: R rows of
// DH floats, row r's 16-byte chunk c at r * 4 DH + ((c ^ key(r)) << 4),
// key(r) = 2 ((r >> 3) & 3) + (r & 1). The copies and the row-wise reads of
// a quarter warp (one row, neighbouring chunks) and the transposed reads
// (ColsTf32: rows 8 g + 2 i + e, g = 0..3, e = 0..1, one chunk) fall in
// distinct banks.
template <int R, int DH>
struct RawTile {
  static constexpr uint32_t BYTES = R * DH * 4;
  static __device__ __forceinline__ uint32_t offset(int r, int c) {
    return r * (DH * 4) + ((c ^ (((r >> 2) & 6) | (r & 1))) << 4);
  }
  // Issues the copies of rows [r0, r0 + R) of a DH-wide column slice (row
  // stride rstride) by NT threads; rows at or past n become zeros. r0 < n.
  template <int NT = THREADS>
  static __device__ __forceinline__ void copy(uint32_t dst, const float* src, int r0, int n, long long rstride) {
    constexpr int CHUNKS = DH / 4;
    static_assert(R * CHUNKS % NT == 0, "a whole number of chunks a thread");
#pragma unroll
    for (int it = 0; it < R * CHUNKS / NT; ++it) {
      const int i = it * NT + threadIdx.x;
      const int r = i / CHUNKS, c = i % CHUNKS;
      const bool inside = r0 + r < n;
      cp_async16(dst + offset(r, c), src + (long long)(inside ? r0 + r : r0) * rstride + 4 * c, inside);
    }
  }
};

// Issues the copies of R four-byte values [r0, r0 + R) of a row (types,
// lse, D); those at or past n become zeros.
template <int R>
__device__ __forceinline__ void copy_values(uint32_t dst, const void* src, int r0, int n) {
  const int i = threadIdx.x;
  if (i < R) {
    const bool inside = r0 + i < n;
    cp_async4(dst + 4 * i, static_cast<const char*>(src) + 4LL * (inside ? r0 + i : r0), inside);
  }
}

// R rows of a RawTile split into TF32 hi and lo tiles Tf32Tile<R, DH> by NT
// threads (K-major: the channels are the contraction): load() takes a
// thread's chunks, store() splits and writes them.
template <int R, int DH, int NT = THREADS>
struct RowsTf32 {
  static constexpr int CHUNKS = DH / 4, IT = R * CHUNKS / NT;
  static_assert(IT >= 1 && IT * NT == R * CHUNKS, "a whole number of chunks a thread");
  float4 x[IT];

  __device__ __forceinline__ void load(const unsigned char* raw) {
#pragma unroll
    for (int it = 0; it < IT; ++it) {
      const int i = it * NT + threadIdx.x;
      x[it] = *reinterpret_cast<const float4*>(raw + RawTile<R, DH>::offset(i / CHUNKS, i % CHUNKS));
    }
  }

  __device__ __forceinline__ void store(unsigned char* hi, unsigned char* lo) const {
#pragma unroll
    for (int it = 0; it < IT; ++it) {
      const int i = it * NT + threadIdx.x;
      const uint32_t at = Tf32Tile<R, DH>::offset(i / CHUNKS, i % CHUNKS);
      uint4 h, l;
      split_tf32(x[it], h, l);
      *reinterpret_cast<uint4*>(hi + at) = h;
      *reinterpret_cast<uint4*>(lo + at) = l;
    }
  }
};

// The same rows transposed, from a RawTile into Tf32Tile<DH, R> hi and lo:
// row d holds channel d of the R rows (K-major: the rows are the
// contraction), the rows of each group of 8 in the order (0, 2, 4, 6, 1, 3,
// 5, 7) -- the TF32 A fragment's column t is the accumulator's column 2t,
// its column t + 4 the accumulator's 2t + 1. A thread takes chunk q of a
// transposed row (rows 8 (q / 2) + 2 i + q % 2, i = 0..3) for four channels
// 4c .. 4c + 3; neighbouring threads take neighbouring chunks, so a quarter
// warp's 16-byte stores fall in distinct banks (dh 128's 16-column tiles:
// two-way).
template <int R, int DH, int NT = THREADS>
struct ColsTf32 {
  static constexpr int QC = R / 4, UNITS = QC * (DH / 4), IT = (UNITS + NT - 1) / NT;
  static_assert(UNITS % NT == 0 || UNITS < NT, "a whole number of 4 x 4 blocks a thread, or one");
  float4 x[IT][4];

  // whether this thread has unit u (where the units are fewer than the
  // threads, the first UNITS threads take one each)
  static __device__ __forceinline__ bool has(int u) { return UNITS >= NT || u < UNITS; }

  __device__ __forceinline__ void load(const unsigned char* raw) {
#pragma unroll
    for (int it = 0; it < IT; ++it) {
      const int u = it * NT + threadIdx.x;
      const int q = u % QC, c = u / QC;
      if (has(u))
#pragma unroll
        for (int i = 0; i < 4; ++i)
          x[it][i] = *reinterpret_cast<const float4*>(raw + RawTile<R, DH>::offset(8 * (q >> 1) + 2 * i + (q & 1), c));
    }
  }

  __device__ __forceinline__ void store(unsigned char* hi, unsigned char* lo) const {
#pragma unroll
    for (int it = 0; it < IT; ++it) {
      const int u = it * NT + threadIdx.x;
      const int q = u % QC, c = u / QC;
      if (!has(u)) continue;
      const float4 col[4] = {make_float4(x[it][0].x, x[it][1].x, x[it][2].x, x[it][3].x),
                             make_float4(x[it][0].y, x[it][1].y, x[it][2].y, x[it][3].y),
                             make_float4(x[it][0].z, x[it][1].z, x[it][2].z, x[it][3].z),
                             make_float4(x[it][0].w, x[it][1].w, x[it][2].w, x[it][3].w)};
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const uint32_t at = Tf32Tile<DH, R>::offset(4 * c + j, q);
        uint4 h, l;
        split_tf32(col[j], h, l);
        *reinterpret_cast<uint4*>(hi + at) = h;
        *reinterpret_cast<uint4*>(lo + at) = l;
      }
    }
  }
};

// Rows [r0, r0 + R) of a slice from device memory (zeros past n) into hi
// and lo tiles Tf32Tile<R, DH>: the operands a block stages once, at most
// 8 chunks a thread in flight, so that this takes fewer registers than the
// accumulators beside it (16 at dh 128 spilled the dk/dv kernel)
template <int R, int DH, int NT = THREADS>
__device__ __forceinline__ void stage_rows_tf32(unsigned char* hi, unsigned char* lo, const float* src, int r0,
                                                int n, long long rstride) {
  constexpr int CHUNKS = DH / 4, IT = R * CHUNKS / NT, GROUP = IT < 8 ? IT : 8;
  static_assert(IT >= 1 && IT % GROUP == 0 && IT * NT == R * CHUNKS, "whole groups of chunks a thread");
#pragma unroll 1
  for (int g = 0; g < IT; g += GROUP) {
    float4 x[GROUP];
#pragma unroll
    for (int k = 0; k < GROUP; ++k) {
      const int i = (g + k) * NT + threadIdx.x;
      const int r = i / CHUNKS;
      x[k] = r0 + r < n
                 ? *reinterpret_cast<const float4*>(src + (long long)(r0 + r) * rstride + 4 * (i % CHUNKS))
                 : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    }
#pragma unroll
    for (int k = 0; k < GROUP; ++k) {
      const int i = (g + k) * NT + threadIdx.x;
      const uint32_t at = Tf32Tile<R, DH>::offset(i / CHUNKS, i % CHUNKS);
      uint4 h, l;
      split_tf32(x[k], h, l);
      *reinterpret_cast<uint4*>(hi + at) = h;
      *reinterpret_cast<uint4*>(lo + at) = l;
    }
  }
}

// A RawTile split by NT threads into its rows' hi and lo tiles and, with
// t_hi, into its transposed ones as well
template <int R, int DH, int NT = THREADS>
__device__ __forceinline__ void split_raw(const unsigned char* raw, unsigned char* hi, unsigned char* lo,
                                          unsigned char* t_hi = nullptr, unsigned char* t_lo = nullptr) {
  if (hi != nullptr) {
    RowsTf32<R, DH, NT> rows;
    rows.load(raw);
    rows.store(hi, lo);
  }
  if (t_hi != nullptr) {
    ColsTf32<R, DH, NT> cols;
    cols.load(raw);
    cols.store(t_hi, t_lo);
  }
}

// The first tile of STEP rows at or after k0 that tile q0 attends, keys
// (next_key<STEP>) or queries (next_query<STEP>); n: none
template <int STEP>
__device__ __forceinline__ int next_key(const int32_t* active, int nt, int b, int q0, int k0, int n) {
  while (k0 < n && !pair_active(active, nt, b, q0, k0)) k0 += STEP;
  return k0;
}

template <int STEP>
__device__ __forceinline__ int next_query(const int32_t* active, int nt, int b, int q0, int k0, int n) {
  while (q0 < n && !pair_active(active, nt, b, q0, k0)) q0 += STEP;
  return q0;
}

// The A fragments (hi, lo) of k-step j of a product over an accumulator's
// columns, from its values x[4 j + 2 hi + e] (row g + 8 hi, column
// 8 j + 2 t + e); the transposed B tile holds the matching rows (above).
template <int J>
__device__ __forceinline__ void split_fragments(const float (&x)[4 * J], uint32_t (&hi)[J][4],
                                                uint32_t (&lo)[J][4]) {
#pragma unroll
  for (int j = 0; j < J; ++j)
#pragma unroll
    for (int e = 0; e < 2; ++e)
#pragma unroll
      for (int r = 0; r < 2; ++r) split_tf32(x[4 * j + 2 * r + e], hi[j][2 * e + r], lo[j][2 * e + r]);
}

// Writes a thread's part of a 64 x DH accumulator, times mul, to rows
// row0 + row and row0 + row + 8 (those below n) of a DH-wide slice
template <int DH>
__device__ __forceinline__ void store_fragment(float* dst, const float (&acc)[DH / 2], int row0, int row, int t4,
                                               int n, long long rstride, float mul0, float mul1) {
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int at = row0 + row + 8 * r;
    if (at >= n) continue;
    float* d = dst + (long long)at * rstride + 2 * t4;
    const float mul = r ? mul1 : mul0;
#pragma unroll
    for (int j = 0; j < DH / 8; ++j)
      *reinterpret_cast<float2*>(d + 8 * j) = make_float2(acc[4 * j + 2 * r] * mul, acc[4 * j + 2 * r + 1] * mul);
  }
}

// acc (64 rows x DH columns) = acc * corr + the 3xTF32 product of J k-steps
// of A fragments (hi, lo) with a B tile TT held transposed (its rows are
// acc's columns, at hi / lo from base); corr a factor of each of a thread's
// two rows. The product is summed in a fresh accumulator, a chunk of columns
// at a time, and added once it is done, in f32 with rounding to nearest: the
// tensor core rounds its f32 sum toward zero at each wgmma, and in one
// accumulator that ran over every tile that bias grew with the tiles (at
// N = 640 on the model's own activations dQ strayed from f64 ten times as
// far as an FFMA sum; tools/accuracy_zorro_f32.py). FRESH false: the
// products go into acc directly (corr 1), where the registers hold no fresh
// accumulator beside acc (the dk/dv kernel at dh 128, beside dK and dV).
template <int DH, int J, typename TT, bool FRESH = true>
__device__ __forceinline__ void add_product(float (&acc)[DH / 2], const uint32_t (&a_hi)[J][4],
                                            const uint32_t (&a_lo)[J][4], uint32_t base, uint32_t hi, uint32_t lo,
                                            const float (&corr)[2]) {
  if constexpr (!FRESH) {
    wgmma_fence();
#pragma unroll
    for (int j = 0; j < J; ++j)
      mma3_rs<DH>(acc, a_hi[j], a_lo[j], TT::kmajor(base + hi, j), TT::kmajor(base + lo, j));
    wgmma_commit();
    wgmma_wait_all();
    keep(acc);
    return;
  }
  constexpr int CH = DH == 128 ? 32 : DH;  // columns a chunk
#pragma unroll
  for (int c = 0; c < DH / CH; ++c) {
    float t[CH / 2];
#pragma unroll
    for (int i = 0; i < CH / 2; ++i) t[i] = 0.0f;
    wgmma_fence();
#pragma unroll
    for (int j = 0; j < J; ++j) {
      const uint32_t at = base + TT::rows(c * CH);
      mma3_rs<CH>(t, a_hi[j], a_lo[j], TT::kmajor(at + hi, j), TT::kmajor(at + lo, j));
    }
    wgmma_commit();
    wgmma_wait_all();
    keep(t);
#pragma unroll
    for (int i = 0; i < CH / 2; ++i)
      acc[c * (CH / 2) + i] = fmaf(acc[c * (CH / 2) + i], corr[(i >> 1) & 1], t[i]);
  }
}

// ---------------------------------------------------------------------------
// Forward: a block per (64 query rows, head, batch row)
// ---------------------------------------------------------------------------

// Shared memory of the forward: Q, K (hi, lo each) and V^T (hi, lo), the
// raw rows of the next K and V tiles, then two stages of key types
template <int DH>
struct F32FwdSmem {
  static constexpr int BK = DH == 32 ? 64 : 32;  // keys a tile: at dh 64 two blocks fit a SM
  using QT = Tf32Tile<F32_ROWS, DH>;
  using KT = Tf32Tile<BK, DH>;
  using VT = Tf32Tile<DH, BK>;
  using RAW = RawTile<BK, DH>;
  static constexpr uint32_t A = QT::BYTES, B = KT::BYTES;  // VT's and RAW's = KT's
  static constexpr uint32_t QH = 0, QL = A, KH = 2 * A, KL = KH + B, VH = KH + 2 * B, VL = KH + 3 * B,
                            RK = KH + 4 * B, RV = KH + 5 * B, TYPES = KH + 6 * B;
  static constexpr size_t BYTES = TYPES + 512 + 1024;  // + the alignment slack
};

template <int DH, int MODE>
__global__ void __launch_bounds__(THREADS, DH <= 64 ? 2 : 1)
zorro_attention_f32_fwd_kernel(Operands32 in, const int32_t* __restrict__ types, const int32_t* __restrict__ active,
                               int nt, float* __restrict__ out, float* __restrict__ lse, int n,
                               long long out_bstride, long long out_rstride, long long types_bstride, float scale,
                               int fusion_type) {
  using L = F32FwdSmem<DH>;
  constexpr int BK = L::BK;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* sm;
  const uint32_t sa = aligned_smem(smem_raw, &sm);
  const int q0 = blockIdx.x * F32_ROWS, h = blockIdx.y, b = blockIdx.z;
  const int lane = threadIdx.x % 32, t4 = lane & 3;
  const int row = (threadIdx.x / 32) * 16 + lane / 4;  // this thread's rows: row and row + 8
  const float* kg = in.k + (long long)b * in.bstride + h * DH;
  const float* vg = in.v + (long long)b * in.bstride + h * DH;
  const int32_t* tg = types + (long long)b * types_bstride;
  const float sl2 = scale * LOG2E;  // scores in log2 units: exp2 in place of exp

  auto copy_kv = [&](int k0, int stage) {
    L::RAW::copy(sa + L::RK, kg, k0, n, in.rstride);
    L::RAW::copy(sa + L::RV, vg, k0, n, in.rstride);
    if (MODE == MODE_ZORRO) copy_values<BK>(sa + L::TYPES + stage * 256, tg, k0, n);
  };

  int k0 = next_key<BK>(active, nt, b, q0, 0, n);  // the diagonal tile is always active
  copy_kv(k0, 0);
  cp_async_commit();
  stage_rows_tf32<F32_ROWS, DH>(sm + L::QH, sm + L::QL, in.q + (long long)b * in.bstride + h * DH, q0, n,
                                in.rstride);
  int tq[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int q = q0 + row + 8 * r;
    tq[r] = (MODE == MODE_ZORRO && q < n) ? tg[q] : PAD_TYPE;
  }
  float o[DH / 2];
#pragma unroll
  for (int i = 0; i < DH / 2; ++i) o[i] = 0.0f;
  float m[2] = {-CUDART_INF_F, -CUDART_INF_F};  // running row max (log2 units), no key seen yet
  float l[2] = {0.0f, 0.0f};                    // this thread's part of the running row sum

  for (int stage = 0; k0 < n; stage ^= 1) {
    cp_async_wait_all();
    __syncthreads();  // tile k0's raw rows have landed (everyone's); every warp is done with the last tile
    split_raw<BK, DH>(sm + L::RK, sm + L::KH, sm + L::KL);
    split_raw<BK, DH>(sm + L::RV, nullptr, nullptr, sm + L::VH, sm + L::VL);
    fence_async_smem();
    __syncthreads();  // the split tiles are ready and the raw buffers free
    const int k_next = next_key<BK>(active, nt, b, q0, k0 + BK, n);
    if (k_next < n) {  // the next tile's rows load while this one computes
      copy_kv(k_next, stage ^ 1);
      cp_async_commit();
    }
    const int* kt = reinterpret_cast<const int*>(sm + L::TYPES + stage * 256);

    // S = Q K^T in 3xTF32, f32 in registers
    float s[BK / 2];
#pragma unroll
    for (int i = 0; i < BK / 2; ++i) s[i] = 0.0f;
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < DH / 8; ++kk)
      mma3_ss<BK>(s, L::QT::kmajor(sa + L::QH, kk), L::QT::kmajor(sa + L::QL, kk),
                  L::KT::kmajor(sa + L::KH, kk), L::KT::kmajor(sa + L::KL, kk));
    wgmma_commit();
    wgmma_wait_all();
    keep(s);

    // scale, then mask to the finite NEG_INF (in log2 units), then keys
    // past n to -inf; row max over the quad that shares the row
    float mx[2] = {m[0], m[1]};
#pragma unroll
    for (int j = 0; j < BK / 8; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int c = 8 * j + 2 * t4 + e;
        const int t_k = MODE == MODE_ZORRO ? kt[c] : 0;
        const bool key_in = k0 + c < n;
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const float v = masked_score<MODE>(s[4 * j + 2 * r + e] * sl2, tq[r], t_k, fusion_type);
          s[4 * j + 2 * r + e] = key_in ? v : -CUDART_INF_F;
          mx[r] = fmaxf(mx[r], s[4 * j + 2 * r + e]);
        }
      }
    float corr[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      corr[r] = exp2f(m[r] - mx[r]);  // 0 on the first tile
      m[r] = mx[r];
      l[r] *= corr[r];
    }

    // P = exp2(s - m) in f32 for the row sum, split into the A fragments
    // of P V (k-step j: keys 8 j .. 8 j + 7)
#pragma unroll
    for (int i = 0; i < BK / 2; ++i) {
      s[i] = exp2f(s[i] - m[(i >> 1) & 1]);
      l[(i >> 1) & 1] += s[i];
    }
    uint32_t p_hi[BK / 8][4], p_lo[BK / 8][4];
    split_fragments<BK / 8>(s, p_hi, p_lo);

    // O = O corr + P V in 3xTF32, V^T in shared memory
    add_product<DH, BK / 8, typename L::VT>(o, p_hi, p_lo, sa, L::VH, L::VL, corr);
    keep(p_hi);
    keep(p_lo);
    k0 = k_next;
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
  }
  if (lse != nullptr && t4 == 0) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int q = q0 + row + 8 * r;
      if (q < n) lse[((long long)b * gridDim.y + h) * n + q] = m[r] * LN2 + logf(l[r]);
    }
  }
  store_fragment<DH>(out + (long long)b * out_bstride + h * DH, o, q0, row, t4, n, out_rstride, 1.0f / l[0],
                     1.0f / l[1]);
}

template <int DH, int MODE>
static cudaError_t launch_f32(const Operands32& in, const int32_t* types, const int32_t* active, int nt, float* out,
                              float* lse, int batch, int n, int heads, long long out_bstride, long long out_rstride,
                              long long types_bstride, float scale, int fusion_type, cudaStream_t stream) {
  static std::atomic<unsigned> ready{0};
  auto kernel = zorro_attention_f32_fwd_kernel<DH, MODE>;
  const size_t bytes = F32FwdSmem<DH>::BYTES;
  cudaError_t err = allow_smem((const void*)kernel, bytes, ready);
  if (err != cudaSuccess) return err;
  dim3 grid((n + F32_ROWS - 1) / F32_ROWS, heads, batch);
  kernel<<<grid, THREADS, bytes, stream>>>(in, types, active, nt, out, lse, n, out_bstride, out_rstride,
                                           types_bstride, scale, fusion_type);
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

// The backward kernels' warpgroups a block, each with its own 64 rows
// (queries in the dq kernel, keys in the dk/dv kernel) on the block's
// streamed tiles; at dh 128 two warpgroups' resident tiles would not fit
// shared memory.
template <int DH>
constexpr int bwd_warpgroups() { return DH == 128 ? 1 : 2; }

// Shared memory of the dq kernel: Q and dO (hi, lo each; each warpgroup's
// 64 rows a tile), then per key tile K, K^T and V (hi, lo each), the raw
// rows of the next K and V tiles, two stages of key types, and the rows' D
// and lse
template <int DH>
struct F32DqSmem {
  static constexpr int WGS = bwd_warpgroups<DH>(), NT = WGS * THREADS, ROWS = WGS * F32_ROWS;
  static constexpr int BK = DH == 32 ? 64 : DH == 64 ? 32 : 16;  // keys a tile
  using QT = Tf32Tile<F32_ROWS, DH>;
  using KT = Tf32Tile<BK, DH>;
  using KTT = Tf32Tile<DH, BK>;
  using RAW = RawTile<BK, DH>;
  static constexpr uint32_t A = QT::BYTES, B = KT::BYTES;  // KTT's and RAW's = KT's
  // warpgroup w's Q at QH + w A (hi) and QL + w A (lo), its dO likewise
  static constexpr uint32_t QH = 0, QL = WGS * A, DOH = 2 * WGS * A, DOL = 3 * WGS * A;
  static constexpr uint32_t KH = 4 * WGS * A, KL = KH + B, KTH = KH + 2 * B, KTL = KH + 3 * B, VH = KH + 4 * B,
                            VL = KH + 5 * B, RK = KH + 6 * B, RV = KH + 7 * B, TYPES = KH + 8 * B,
                            D = TYPES + 512, LSE = D + 4 * ROWS;
  static constexpr size_t BYTES = LSE + 4 * ROWS + 1024;
};

// Block (ROWS query rows, head, batch row): D = rowsum(dO * O) in f32 for
// its rows (two threads a row), stored for the dk/dv kernel; then dQ over
// all key tiles: S = Q K^T and dP = dO V^T, dS = P (dP - D), dQ += dS K.
// o and dout are contiguous [B, N, H * DH].
template <int DH, int MODE>
__global__ void __launch_bounds__(F32DqSmem<DH>::NT)
zorro_attention_f32_dq_kernel(Operands32 in, const int32_t* __restrict__ types, const int32_t* __restrict__ active,
                              int nt, const float* __restrict__ o, const float* __restrict__ lse,
                              const float* __restrict__ dout, GradOperands32 grad, float* __restrict__ delta,
                              int n, long long types_bstride, float scale, int fusion_type) {
  using L = F32DqSmem<DH>;
  constexpr int BK = L::BK, NT = L::NT;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* sm;
  const uint32_t sa = aligned_smem(smem_raw, &sm);
  const int q0 = blockIdx.x * L::ROWS, h = blockIdx.y, b = blockIdx.z;
  const int wg = threadIdx.x / THREADS, lane = threadIdx.x % 32, t4 = lane & 3;
  const int row = wg * F32_ROWS + (threadIdx.x % THREADS / 32) * 16 + lane / 4;  // of the block's rows
  const uint32_t own = wg * L::A;  // this warpgroup's Q and dO tiles
  const int inner = gridDim.y * DH;
  const float* kg = in.k + (long long)b * in.bstride + h * DH;
  const float* vg = in.v + (long long)b * in.bstride + h * DH;
  const float* dog = dout + (long long)b * n * inner + h * DH;
  const int32_t* tg = types + (long long)b * types_bstride;
  const long long lse_row = ((long long)b * gridDim.y + h) * n;
  const float sl2 = scale * LOG2E;
  const float one[2] = {1.0f, 1.0f};  // add_product's row factors

  auto copy_kv = [&](int k0, int stage) {
    L::RAW::template copy<NT>(sa + L::RK, kg, k0, n, in.rstride);
    L::RAW::template copy<NT>(sa + L::RV, vg, k0, n, in.rstride);
    if (MODE == MODE_ZORRO) copy_values<BK>(sa + L::TYPES + stage * 256, tg, k0, n);
  };

  int k0 = next_key<BK>(active, nt, b, q0, 0, n);
  copy_kv(k0, 0);
  cp_async_commit();
  {  // D and lse (in log2 units) of the block's rows, two threads a row
    const int r = threadIdx.x >> 1, half = threadIdx.x & 1;
    const int q = q0 + r;
    float part = 0.0f;
    if (q < n) {
      const float4* a = reinterpret_cast<const float4*>(dog + (long long)q * inner + half * (DH / 2));
      const float4* c = reinterpret_cast<const float4*>(o + (long long)b * n * inner + h * DH +
                                                        (long long)q * inner + half * (DH / 2));
#pragma unroll
      for (int u = 0; u < DH / 8; ++u) {
        const float4 x = a[u], y = c[u];
        part = fmaf(x.x, y.x, part);
        part = fmaf(x.y, y.y, part);
        part = fmaf(x.z, y.z, part);
        part = fmaf(x.w, y.w, part);
      }
    }
    part += __shfl_xor_sync(0xffffffffu, part, 1);
    if (half == 0) {
      if (q < n) delta[lse_row + q] = part;
      reinterpret_cast<float*>(sm + L::D)[r] = part;
      reinterpret_cast<float*>(sm + L::LSE)[r] = q < n ? lse[lse_row + q] * LOG2E : 0.0f;
    }
  }
#pragma unroll
  for (int w = 0; w < L::WGS; ++w) {
    stage_rows_tf32<F32_ROWS, DH, NT>(sm + L::QH + w * L::A, sm + L::QL + w * L::A,
                                      in.q + (long long)b * in.bstride + h * DH, q0 + w * F32_ROWS, n, in.rstride);
    stage_rows_tf32<F32_ROWS, DH, NT>(sm + L::DOH + w * L::A, sm + L::DOL + w * L::A, dog, q0 + w * F32_ROWS, n,
                                      inner);
  }
  __syncthreads();
  int tq[2];
  bool q_in[2];
  float d_row[2], lse2[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int q = q0 + row + 8 * r;
    q_in[r] = q < n;
    tq[r] = (MODE == MODE_ZORRO && q_in[r]) ? tg[q] : PAD_TYPE;
    d_row[r] = reinterpret_cast<const float*>(sm + L::D)[row + 8 * r];
    lse2[r] = reinterpret_cast<const float*>(sm + L::LSE)[row + 8 * r];
  }
  float dq[DH / 2];
#pragma unroll
  for (int i = 0; i < DH / 2; ++i) dq[i] = 0.0f;

  for (int stage = 0; k0 < n; stage ^= 1) {
    cp_async_wait_all();
    __syncthreads();
    split_raw<BK, DH, NT>(sm + L::RK, sm + L::KH, sm + L::KL, sm + L::KTH, sm + L::KTL);
    split_raw<BK, DH, NT>(sm + L::RV, sm + L::VH, sm + L::VL);
    fence_async_smem();
    __syncthreads();
    const int k_next = next_key<BK>(active, nt, b, q0, k0 + BK, n);
    if (k_next < n) {
      copy_kv(k_next, stage ^ 1);
      cp_async_commit();
    }
    const int* kt = reinterpret_cast<const int*>(sm + L::TYPES + stage * 256);

    // S = Q K^T and dP = dO V^T, two groups: P is computed while dP is
    // still in flight
    float s[BK / 2], dp[BK / 2];
#pragma unroll
    for (int i = 0; i < BK / 2; ++i) s[i] = dp[i] = 0.0f;
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < DH / 8; ++kk)
      mma3_ss<BK>(s, L::QT::kmajor(sa + L::QH + own, kk), L::QT::kmajor(sa + L::QL + own, kk),
                  L::KT::kmajor(sa + L::KH, kk), L::KT::kmajor(sa + L::KL, kk));
    wgmma_commit();
#pragma unroll
    for (int kk = 0; kk < DH / 8; ++kk)
      mma3_ss<BK>(dp, L::QT::kmajor(sa + L::DOH + own, kk), L::QT::kmajor(sa + L::DOL + own, kk),
                  L::KT::kmajor(sa + L::VH, kk), L::KT::kmajor(sa + L::VL, kk));
    wgmma_commit();
    wgmma_wait_one();
    keep(s);

    // P = exp2(s masked - lse) in place of s; column c is key k0 + c
#pragma unroll
    for (int j = 0; j < BK / 8; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int c = 8 * j + 2 * t4 + e;
        const int t_k = MODE == MODE_ZORRO ? kt[c] : 0;
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const int i = 4 * j + 2 * r + e;
          const float x = masked_score<MODE>(s[i] * sl2, tq[r], t_k, fusion_type);
          s[i] = (q_in[r] && k0 + c < n) ? exp2f(x - lse2[r]) : 0.0f;
        }
      }

    // dS = P (dP - D), split into the A fragments of dS K
    wgmma_wait_all();
    keep(dp);
#pragma unroll
    for (int i = 0; i < BK / 2; ++i) s[i] *= dp[i] - d_row[(i >> 1) & 1];
    uint32_t ds_hi[BK / 8][4], ds_lo[BK / 8][4];
    split_fragments<BK / 8>(s, ds_hi, ds_lo);

    // dQ += dS K in 3xTF32, K^T in shared memory
    add_product<DH, BK / 8, typename L::KTT>(dq, ds_hi, ds_lo, sa, L::KTH, L::KTL, one);
    keep(ds_hi);
    keep(ds_lo);
    k0 = k_next;
  }
  store_fragment<DH>(grad.q + (long long)b * grad.bstride + h * DH, dq, q0, row, t4, n, grad.rstride, scale, scale);
}

// Shared memory of the dk/dv kernel: K and V (hi, lo each; each
// warpgroup's 64 keys a tile), then per query tile Q, Q^T, dO and dO^T (hi,
// lo each), the raw rows of the next Q and dO tiles, and two stages of the
// queries' types, lse and D
template <int DH>
struct F32DkdvSmem {
  static constexpr int WGS = bwd_warpgroups<DH>(), NT = WGS * THREADS, ROWS = WGS * F32_ROWS;
  static constexpr int BQ = DH == 32 ? 64 : DH == 64 ? 32 : 16;  // queries a tile
  using KT = Tf32Tile<F32_ROWS, DH>;
  using QT = Tf32Tile<BQ, DH>;
  using QTT = Tf32Tile<DH, BQ>;
  using RAW = RawTile<BQ, DH>;
  static constexpr uint32_t A = KT::BYTES, B = QT::BYTES;  // QTT's and RAW's = QT's
  // warpgroup w's K at KH + w A (hi) and KL + w A (lo), its V likewise
  static constexpr uint32_t KH = 0, KL = WGS * A, VH = 2 * WGS * A, VL = 3 * WGS * A;
  static constexpr uint32_t QH = 4 * WGS * A, QL = QH + B, QTH = QH + 2 * B, QTL = QH + 3 * B, DOH = QH + 4 * B,
                            DOL = QH + 5 * B, DOTH = QH + 6 * B, DOTL = QH + 7 * B, RQ = QH + 8 * B,
                            RDO = QH + 9 * B;
  static constexpr uint32_t ROWS_AT = QH + 10 * B, ROWS_STAGE = 768;  // types +0, lse +256, D +512
  static constexpr size_t BYTES = ROWS_AT + 2 * ROWS_STAGE + 1024;
};

// Block (ROWS key rows, head, batch row): dK and dV over all query tiles,
// with the D of the dq kernel. The products run with the keys as rows: S^T
// = K Q^T and dP^T = V dO^T, then dV += P^T dO and dK += dS^T Q.
template <int DH, int MODE>
__global__ void __launch_bounds__(F32DkdvSmem<DH>::NT)
zorro_attention_f32_dkdv_kernel(Operands32 in, const int32_t* __restrict__ types,
                                const int32_t* __restrict__ active, int nt, const float* __restrict__ lse,
                                const float* __restrict__ dout, const float* __restrict__ delta, GradOperands32 grad,
                                int n, long long types_bstride, float scale, int fusion_type) {
  using L = F32DkdvSmem<DH>;
  constexpr int BQ = L::BQ, NT = L::NT;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* sm;
  const uint32_t sa = aligned_smem(smem_raw, &sm);
  const int k0 = blockIdx.x * L::ROWS, h = blockIdx.y, b = blockIdx.z;
  const int wg = threadIdx.x / THREADS, lane = threadIdx.x % 32, t4 = lane & 3;
  const int row = wg * F32_ROWS + (threadIdx.x % THREADS / 32) * 16 + lane / 4;  // keys k0 + row, k0 + row + 8
  const uint32_t own = wg * L::A;  // this warpgroup's K and V tiles
  const int inner = gridDim.y * DH;
  const float* qg = in.q + (long long)b * in.bstride + h * DH;
  const float* dog = dout + (long long)b * n * inner + h * DH;
  const int32_t* tg = types + (long long)b * types_bstride;
  const long long lse_row = ((long long)b * gridDim.y + h) * n;
  const float sl2 = scale * LOG2E;
  const float one[2] = {1.0f, 1.0f};  // add_product's row factors

  auto copy_q = [&](int q0, int stage) {
    L::RAW::template copy<NT>(sa + L::RQ, qg, q0, n, in.rstride);
    L::RAW::template copy<NT>(sa + L::RDO, dog, q0, n, inner);
    const uint32_t rows = sa + L::ROWS_AT + stage * L::ROWS_STAGE;
    if (MODE == MODE_ZORRO) copy_values<BQ>(rows, tg, q0, n);
    copy_values<BQ>(rows + 256, lse + lse_row, q0, n);
    copy_values<BQ>(rows + 512, delta + lse_row, q0, n);
  };

  int q0 = next_query<BQ>(active, nt, b, 0, k0, n);  // the diagonal tile is always active
  copy_q(q0, 0);
  cp_async_commit();
#pragma unroll
  for (int w = 0; w < L::WGS; ++w) {
    stage_rows_tf32<F32_ROWS, DH, NT>(sm + L::KH + w * L::A, sm + L::KL + w * L::A,
                                      in.k + (long long)b * in.bstride + h * DH, k0 + w * F32_ROWS, n, in.rstride);
    stage_rows_tf32<F32_ROWS, DH, NT>(sm + L::VH + w * L::A, sm + L::VL + w * L::A,
                                      in.v + (long long)b * in.bstride + h * DH, k0 + w * F32_ROWS, n, in.rstride);
  }
  int tk[2];
  bool k_in[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int k = k0 + row + 8 * r;
    k_in[r] = k < n;
    tk[r] = (MODE == MODE_ZORRO && k_in[r]) ? tg[k] : PAD_TYPE;
  }
  float dk[DH / 2], dv[DH / 2];
#pragma unroll
  for (int i = 0; i < DH / 2; ++i) dk[i] = dv[i] = 0.0f;

  for (int stage = 0; q0 < n; stage ^= 1) {
    cp_async_wait_all();
    __syncthreads();
    split_raw<BQ, DH, NT>(sm + L::RQ, sm + L::QH, sm + L::QL, sm + L::QTH, sm + L::QTL);
    split_raw<BQ, DH, NT>(sm + L::RDO, sm + L::DOH, sm + L::DOL, sm + L::DOTH, sm + L::DOTL);
    fence_async_smem();
    __syncthreads();
    const int q_next = next_query<BQ>(active, nt, b, q0 + BQ, k0, n);
    if (q_next < n) {
      copy_q(q_next, stage ^ 1);
      cp_async_commit();
    }
    const unsigned char* rows = sm + L::ROWS_AT + stage * L::ROWS_STAGE;
    const int* tq = reinterpret_cast<const int*>(rows);
    const float* lse_q = reinterpret_cast<const float*>(rows + 256);
    const float* d_q = reinterpret_cast<const float*>(rows + 512);

    // S^T = K Q^T and dP^T = V dO^T, two groups: P^T is computed while
    // dP^T is still in flight
    float s[BQ / 2], dp[BQ / 2];
#pragma unroll
    for (int i = 0; i < BQ / 2; ++i) s[i] = dp[i] = 0.0f;
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < DH / 8; ++kk)
      mma3_ss<BQ>(s, L::KT::kmajor(sa + L::KH + own, kk), L::KT::kmajor(sa + L::KL + own, kk),
                  L::QT::kmajor(sa + L::QH, kk), L::QT::kmajor(sa + L::QL, kk));
    wgmma_commit();
#pragma unroll
    for (int kk = 0; kk < DH / 8; ++kk)
      mma3_ss<BQ>(dp, L::KT::kmajor(sa + L::VH + own, kk), L::KT::kmajor(sa + L::VL + own, kk),
                  L::QT::kmajor(sa + L::DOH, kk), L::QT::kmajor(sa + L::DOL, kk));
    wgmma_commit();
    wgmma_wait_one();
    keep(s);

    // P^T = exp2(s masked - lse) in place of s; column c is query q0 + c
#pragma unroll
    for (int j = 0; j < BQ / 8; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int c = 8 * j + 2 * t4 + e;
        const int t_q = MODE == MODE_ZORRO ? tq[c] : 0;
        const float l2 = lse_q[c] * LOG2E;
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const int i = 4 * j + 2 * r + e;
          const float x = masked_score<MODE>(s[i] * sl2, t_q, tk[r], fusion_type);
          s[i] = (k_in[r] && q0 + c < n) ? exp2f(x - l2) : 0.0f;
        }
      }

    // dS^T = P^T (dP^T - D) in place of dP^T; then P^T split into the A
    // fragments of dV += P^T dO, and once those products are done (their
    // registers free) dS^T into those of dK += dS^T Q
    wgmma_wait_all();
    keep(dp);
#pragma unroll
    for (int i = 0; i < BQ / 2; ++i) dp[i] = s[i] * (dp[i] - d_q[8 * (i >> 2) + 2 * t4 + (i & 1)]);
    {
      uint32_t p_hi[BQ / 8][4], p_lo[BQ / 8][4];
      split_fragments<BQ / 8>(s, p_hi, p_lo);
      add_product<DH, BQ / 8, typename L::QTT, DH != 128>(dv, p_hi, p_lo, sa, L::DOTH, L::DOTL, one);
      keep(p_hi);
      keep(p_lo);
    }
    uint32_t ds_hi[BQ / 8][4], ds_lo[BQ / 8][4];
    split_fragments<BQ / 8>(dp, ds_hi, ds_lo);
    add_product<DH, BQ / 8, typename L::QTT, DH != 128>(dk, ds_hi, ds_lo, sa, L::QTH, L::QTL, one);
    keep(ds_hi);
    keep(ds_lo);
    q0 = q_next;
  }
  const long long at = (long long)b * grad.bstride + h * DH;
  store_fragment<DH>(grad.k + at, dk, k0, row, t4, n, grad.rstride, scale, scale);
  store_fragment<DH>(grad.v + at, dv, k0, row, t4, n, grad.rstride, 1.0f, 1.0f);
}

template <int DH, int MODE>
static cudaError_t launch_bwd_f32(const Operands32& in, const int32_t* types, const int32_t* active, int nt,
                                  const float* o, const float* lse, const float* dout, const GradOperands32& grad,
                                  float* delta, int batch, int n, int heads, long long types_bstride, float scale,
                                  int fusion_type, cudaStream_t stream) {
  using Dq = F32DqSmem<DH>;
  using Dkdv = F32DkdvSmem<DH>;
  static std::atomic<unsigned> dq_ready{0}, dkdv_ready{0};
  auto dq_kernel = zorro_attention_f32_dq_kernel<DH, MODE>;
  auto dkdv_kernel = zorro_attention_f32_dkdv_kernel<DH, MODE>;
  cudaError_t err = allow_smem((const void*)dq_kernel, Dq::BYTES, dq_ready);
  if (err != cudaSuccess) return err;
  err = allow_smem((const void*)dkdv_kernel, Dkdv::BYTES, dkdv_ready);
  if (err != cudaSuccess) return err;
  dq_kernel<<<dim3((n + Dq::ROWS - 1) / Dq::ROWS, heads, batch), Dq::NT, Dq::BYTES, stream>>>(
      in, types, active, nt, o, lse, dout, grad, delta, n, types_bstride, scale, fusion_type);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  dkdv_kernel<<<dim3((n + Dkdv::ROWS - 1) / Dkdv::ROWS, heads, batch), Dkdv::NT, Dkdv::BYTES, stream>>>(
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
