// The product body of K2 / K2b's bf16 wide path (fused_ffn.cu, fused_ffn_bwd.cu):
// d or d_out past 256 (`base`, d = 768, I = 2048; `large`, d = 1024), where
// the row kernels cannot keep y or dx in registers. Every product of the wide
// path, forward and backward, is one body: C [128 x N] += A [128 x K] B^T [K x N]
// for a tile of 128 rows (two consumer warpgroups of 64) by N = 128, 192 or
// 256 columns, over windows of KW = 64 (or 32) contraction columns:
//   * a ring of S stages filled by cp.async ahead of the consumers (S - 2
//     windows in flight while one is multiplied and the one before drains),
//     one commit group and one block barrier a window;
//   * A and B each K-major (a row of the operand runs along the contraction:
//     x, xn, dy, du, a and the weights read as W^T) or MN-major (a column
//     does: the weight gradients' du, a, xn and dy, and the weights read as
//     W), copied as they lie into the hardware's 128-byte (64-byte) swizzle and read
//     by wgmma through the descriptor's transpose bit;
//   * each window's 4 k-steps issued as one asynchronous group, at most one
//     group left in flight (wgmma.wait_group 1): the next window's products
//     are issued while this one's finish.
// The kernels form their epilogues (GEGLU's val gelu(gate), the MLP's
// gelu(h + b1), du / dh and a) on the accumulator fragments. What bounds the
// products on an H100: the tensor cores (6 M d I forward and 16 M d I
// backward flops for GEGLU, 989 TFLOP/s), if the windows arrive in time: a
// 128 x 256 window of 64 columns moves 48 KB from L2 for 4 MFLOP.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"

namespace ffn_wide {

using namespace hopper;
using bf16 = __nv_bfloat16;

constexpr int BM = 128;       // rows of a tile: two consumer warpgroups of 64
constexpr int THREADS = 256;
constexpr int BN = 256;       // columns of the output and weight-gradient tiles
constexpr int UT = 128;       // hidden units a tile of the activation kernels (GEGLU; MLP forward 256)
constexpr float LN_EPS = 1e-5f;

// Each kernel's ring: its windows' width KW (64 contraction columns, one
// 128-byte swizzle row of bf16, or 32 in the 64-byte swizzle) and its stages
// (S - 2 windows in flight). The backward activation keeps da's 64 KB stash
// beside its ring, so it takes windows of 32: 6 stages of 24 KB (GEGLU's 256
// B rows) or 8 of 16 KB (the MLP's 128).
constexpr int FWD_ACT_KW = 64, FWD_ACT_STAGES = 4;
constexpr int FWD_OUT_KW = 64, FWD_OUT_STAGES = 4;
constexpr int PRODUCTS_KW = 64, PRODUCTS_STAGES = 4;
constexpr int ACT_BWD_KW = 32;
__host__ __device__ constexpr int act_bwd_stages(bool geglu) { return geglu ? 6 : 8; }
constexpr uint32_t STASH_BYTES = 64 * THREADS * 4;  // da's fragments: 64 floats a thread

template <int N, int KW>
__host__ __device__ constexpr uint32_t stage_bytes() {
  return (BM + N) * KW * 2;
}

template <int N, int KW, int S>
__host__ __device__ constexpr uint32_t ring_bytes() {
  return S * stage_bytes<N, KW>();
}

template <int KW>
__host__ __device__ inline int windows(int k) { return (k + KW - 1) / KW; }

// An operand of C = A B^T in device memory (bf16, leading dimension ld):
// K-major, element (r, k) at p[r ld + k]; MN-major, at p[k ld + r]. Rows at
// or past `rows` and k at or past `k` read as zeros. A K-major B may stack
// two row ranges (GEGLU's val and gate rows of W_in): tile row t < split
// reads row r0 + t, t >= split row off1 + r0 + t - split, both as unit
// r0 + (t mod split) limited by `rows`.
struct Opnd {
  const bf16* p;
  long long ld;
  int rows, k, split, off1;
};

__host__ inline Opnd opnd(const bf16* p, long long ld, int rows, int k, int split = 1 << 30, int off1 = 0) {
  return Opnd{p, ld, rows, k, split, off1};
}

// A K-major tile of R rows by KW columns: the 128-byte swizzle (Sw128) for
// KW = 64, the 64-byte one (Sw64) for 32; its byte offset of chunk c (8
// columns) of row t, and the descriptor of k-step kk over 64 rows (A) or R
// (B) from `base`
template <int R, int KW>
__device__ __forceinline__ uint32_t kmajor_offset(int t, int c) {
  if constexpr (KW == 64) return Sw128::offset(t, c, R);
  else return Sw64::offset(t, c);
}

template <int R, int KW>
__device__ __forceinline__ uint64_t kmajor_desc(uint32_t base, int kk) {
  if constexpr (KW == 64) return Sw128::kmajor(base, R, kk);
  else return Sw64::kmajor(base, kk);
}

// rows [r0, r0 + R) by the window [k0, k0 + KW) of a K-major operand into a
// swizzled tile of R rows
template <int R, int KW>
__device__ __forceinline__ void load_kmajor(uint32_t dst, const Opnd& o, int r0, int k0) {
#pragma unroll
  for (int it = 0; it < R * (KW / 8) / THREADS; ++it) {
    const int i = it * THREADS + threadIdx.x, t = i / (KW / 8), c = i % (KW / 8);
    const bool second = t >= o.split;
    const int unit = r0 + (second ? t - o.split : t), k = k0 + 8 * c;
    const bool in = unit < o.rows && k < o.k;
    const long long row = unit + (second ? o.off1 : 0);
    cp_async16(dst + kmajor_offset<R, KW>(t, c), o.p + (in ? row * o.ld + k : 0), in);
  }
}

// the window's KW rows of an MN-major operand, columns [r0, r0 + R), into a
// 128-byte-swizzled tile of KW rows and R / 64 column blocks
template <int R, int KW>
__device__ __forceinline__ void load_mnmajor(uint32_t dst, const Opnd& o, int r0, int k0) {
#pragma unroll
  for (int it = 0; it < KW * (R / 8) / THREADS; ++it) {
    const int i = it * THREADS + threadIdx.x, kr = i / (R / 8), c = i % (R / 8);
    const int k = k0 + kr, col = r0 + 8 * c;
    const bool in = k < o.k && col < o.rows;
    cp_async16(dst + Sw128::offset(kr, c, KW), o.p + (in ? (long long)k * o.ld + col : 0), in);
  }
}

// D[64, 256] += A[64, 16] . B[16, 256], both from shared memory, K-major
// unless the transpose bits TA / TB say MN-major
template <int TA, int TB>
__device__ __forceinline__ void wgmma_ss_n256(float (&d)[128], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %132, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111, "
      "%112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127"
      "}, "
      "%128, %129, p, 1, 1, %130, %131;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
        "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),
        "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]),
        "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "l"(da), "l"(db), "n"(TA), "n"(TB), "r"(1));
}

// D[64, 192] += A[64, 16] . B[16, 192], as wgmma_ss_n256
template <int TA, int TB>
__device__ __forceinline__ void wgmma_ss_n192(float (&d)[96], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %100, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n192k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95"
      "}, "
      "%96, %97, p, 1, 1, %98, %99;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
        "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95])
      : "l"(da), "l"(db), "n"(TA), "n"(TB), "r"(1));
}

template <int N, int TA, int TB>
__device__ __forceinline__ void mma(float (&d)[N / 2], uint64_t da, uint64_t db) {
  if constexpr (N == 256)
    wgmma_ss_n256<TA, TB>(d, da, db);
  else if constexpr (N == 192)
    wgmma_ss_n192<TA, TB>(d, da, db);
  else
    wgmma_ss_n128<TA, TB>(d, da, db);
}

// acc += rows [m0, m0 + 128) of A times B's rows [n0, n0 + N), over the
// contraction's windows [w0, w1) of KW columns, through a ring of S stages
// at `ring` (stage_bytes<N, KW>() apart). Warp w's accumulator holds rows
// 16 (w % 4) + g (+ 8) of its warpgroup's 64 (g = lane / 4) and columns
// 8 j + 2 (lane % 4) (+ 1) at 4 j (+ 2 for the row + 8, + 1 for the column
// + 1). Ends with every copy landed and a block barrier: the ring is free.
template <int N, int TA, int TB, int KW, int S>
__device__ __forceinline__ void product(float (&acc)[N / 2], const Opnd& a, int m0, const Opnd& b, int n0, int w0,
                                        int w1, uint32_t ring) {
  static_assert(S >= 3, "a stage being loaded, one multiplied, one draining");
  static_assert(KW == 32 || KW == 64, "a window is one swizzle row");
  constexpr uint32_t ST = stage_bytes<N, KW>(), AB = BM * KW * 2;
  const int nw = w1 - w0, wg = threadIdx.x / 128;
  auto load = [&](int j) {  // window w0 + j into stage j % S (one commit group each, empty past the end)
    if (j < nw) {
      const uint32_t st = ring + (j % S) * ST;
      const int k0 = (w0 + j) * KW;
      if constexpr (TA)
        load_mnmajor<BM, KW>(st, a, m0, k0);
      else
        load_kmajor<BM, KW>(st, a, m0, k0);
      if constexpr (TB)
        load_mnmajor<N, KW>(st + AB, b, n0, k0);
      else
        load_kmajor<N, KW>(st + AB, b, n0, k0);
    }
    cp_async_commit();
  };
  for (int j = 0; j < S - 2; ++j) load(j);
  keep(acc);  // the accumulators' values are defined before the first product is issued
  for (int j = 0; j < nw; ++j) {
    cp_async_wait<S - 3>();  // this thread's copies of window j have landed
    fence_async_smem();
    // everyone's have; every warpgroup's products of window j - 2 are done
    // (each waited for them at window j - 1), so its stage is free
    __syncthreads();
    load(j + S - 2);
    const uint32_t st = ring + (j % S) * ST;
    keep(acc);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < KW / 16; ++kk) {
      const uint64_t da = TA ? Sw128::mnmajor(st + wg * (KW * 128), KW, kk)
                             : kmajor_desc<BM, KW>(st + wg * (64 * KW * 2), kk);
      const uint64_t db = TB ? Sw128::mnmajor(st + AB, KW, kk) : kmajor_desc<N, KW>(st + AB, kk);
      mma<N, TA, TB>(acc, da, db);
    }
    wgmma_commit();
    wgmma_wait_one();  // window j - 1's products are done; window j's may run on
    keep(acc);
  }
  wgmma_wait_all();
  keep(acc);
  cp_async_wait_all();
  __syncthreads();
}

__device__ __forceinline__ float gelu_cdf(float g) { return 0.5f * (1.0f + erff(g * 0.70710678118654752f)); }

__device__ __forceinline__ float gelu_pdf(float g) { return 0.39894228040143268f * expf(-0.5f * g * g); }

// this thread's first row of a tile (the other 8 on) and its column within
// an 8-column group
__device__ __forceinline__ int frag_row() { return (threadIdx.x / 128) * 64 + ((threadIdx.x / 32) % 4) * 16 + (threadIdx.x % 32) / 4; }

__device__ __forceinline__ int frag_col() { return 2 * (threadIdx.x % 4); }

// The columns of the forward's output tile: 256, or 192 where that leaves
// fewer waves of blocks (one an SM) on the card, a block's time taken as
// its columns plus 32 (the A window it loads whatever its width): `base`'s
// 768 columns at M = 8192 run 256 blocks of 192 (two waves) in the place of
// 192 of 256 (1.45, run as two). It picks 192 at `base`'s M = 8192, 1024
// and 256, where 192 beats 256 by 7-17% on an H100 (PERF.md §6), and 256
// at the step's 38,400 and 15,360.
static int out_columns(int m, int d_out) {
  const long long mtiles = (m + BM - 1) / BM, sms = sm_count();
  long long best = 0, cost[2];
  const int cols[2] = {256, 192};
  for (int i = 0; i < 2; ++i) {
    const long long tiles = mtiles * ((d_out + cols[i] - 1) / cols[i]);
    cost[i] = (tiles + sms - 1) / sms * (cols[i] + 32);
    if (cost[i] < cost[best]) best = i;
  }
  return cols[best];
}

}  // namespace ffn_wide
