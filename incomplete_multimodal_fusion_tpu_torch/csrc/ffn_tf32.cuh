// The f32 instance of K2 (fused_ffn.cu) and K2b (fused_ffn_bwd.cu) on the
// tensor cores: every product in three TF32 parts (3xTF32, hopper.cuh: each
// f32 operand split by cvt.rna into hi + lo, each product hi hi + hi lo +
// lo hi), every sum in f32. What it computes is the TPU kernels' f32 path
// (ops/pallas_ffn.py _ffn_fwd_impl, _mlp_fwd_impl, _ffn_bwd, _mlp_bwd with
// f32 operands: no casts, the bias-free LayerNorm with eps 1e-5, the exact
// erf GELU). Used for d, d_out <= 256; wider rows (`base`, `large`) take the
// FFMA chain of simt_f32.cuh, by the shape rule rows_fit().
//
// The design, the bf16 K2 / K2b's with what TF32 changes:
//   * A row tile is 64 rows, one warpgroup. Its operand rows (xn after the
//     LayerNorm, or x; dy in the backward) sit raw in shared memory, and the
//     A fragments of each k-step are read from there and split in registers
//     (wgmma with A from registers), so a tile costs 4 bytes a value, not
//     the 8 of split hi and lo tiles: the forward's tile and a ring of 4
//     weight units fit twice in a SM (113 KB at d = 192).
//   * TF32 wgmma reads B only K-major, and the weights are needed in four
//     arrangements (W_in's rows, W_out's rows, and both transposed). A first
//     launch splits them once a call into "units" in device memory: a unit
//     is a [64 x 32] (or [32 x 32]) K-major tile, hi then lo, each in the
//     128-byte swizzle, exactly as it will sit in shared memory; the row
//     kernels stream units through a ring by cp.async in the order they use
//     them. Per 32 hidden units (a chunk): the forward takes u = xn W_in^T
//     (val and gate stacked: m64n64, or h: m64n32) in windows of 32 of d,
//     then y += a W_out^T a 64-column block at a time; the backward u, then
//     da = dy W_out in windows of d_out (W_out^T units), then dxn += du W_in
//     (W_in^T units, val and gate).
//   * The activation a (forward) and du / dh (backward) are formed on the
//     accumulator fragments and are at once the A fragments of the next
//     product: in a column group of 8 a thread's accumulator holds columns
//     (2t, 2t + 1), the TF32 A fragment columns (t, t + 4), so the units
//     contracted over hidden units hold each group of 8 in the order (0, 2,
//     4, 6, 1, 3, 5, 7). u, a and du never reach device memory in the
//     forward; the backward writes du (dh), a, xn (x) and dy transposed, f32,
//     for the weight gradients, whose contraction runs over the rows.
//   * Every product of a unit (4 k-steps) goes into a fresh accumulator that
//     is added in f32 (round to nearest) once done: the tensor core rounds
//     each wgmma's sum toward zero, a bias that grows in an accumulator run
//     over many k-steps (K1 f32's dQ strayed 10x from f64 with one).
//   * Where the row tiles fill under half of the SMs (serving, the fusion
//     rows, the decoder's tasks), the hidden chunks are split over blocks,
//     each storing an f32 partial y, summed in a fixed order by a second
//     launch (bf16 K2's rule). The MLP's task axis is one more grid
//     coordinate.
//   * The weight gradients: a block of two warpgroups owns 128 rows of the
//     gradient (W_in's 2I or I, or W_out's transposed) by all of d (<= 256)
//     over one range of rows; both operands, stored transposed by the row
//     pass, come in raw by cp.async one stage ahead and each thread splits
//     its own copies; one f32 partial a range, summed with the vector
//     partials (dgamma, db1, db2) by simt_f32::reduce in a fixed order.
//   * No atomics anywhere: two calls are bitwise equal.
// What bounds it on an H100: the products, 6 (forward) and 16 (backward)
// flops a row, d and hidden unit for GEGLU, three times over at the tensor
// cores' dense TF32 rate (495 TFLOP/s, 165 in effect); the backward's
// transposed workspaces (about 300 MB at M = 38,400) come next.
#pragma once

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <atomic>

#include "hopper.cuh"
#include "simt_f32.cuh"

namespace ffn_tf32 {

using namespace hopper;

constexpr int ROWS = 64;       // rows a row tile: one warpgroup
constexpr int NT = 128;        // threads of a row block
constexpr int HC = 32;         // hidden units a chunk
constexpr int KU = 32;         // contraction columns a unit: 4 k-steps of 8
constexpr int UNIT_BYTES = 16384;  // a unit's slot: hi [64 x 32] f32, then lo
constexpr int LO = 8192;           // lo's offset in a slot
constexpr int UNIT_FLOATS = UNIT_BYTES / 4;
constexpr int MAX_D = 256;  // d and d_out of the row kernels (their accumulators are registers)
constexpr int MAX_SMEM = 232448;
constexpr int WG_THREADS = 256;  // threads of a weight-gradient block
constexpr int MAX_SPLITS = 64;
constexpr float LN_EPS = 1e-5f;

enum { MODE_GEGLU = 0, MODE_MLP = 1 };

// The unit plan of one call: a chunk's units are W (W_in's rows over the
// windows of d), then forward NBO (W_out's rows, a 64-column block of y
// each) or backward WO (W_out^T over the windows of d_out) and NB (W_in^T,
// a 64-column block of dxn each; GEGLU NB for val, then NB for gate).
struct Plan {
  int mode, bwd, d, hid, d_out;
  int W, WO, NB, NBO, chunks, upc;
};

__host__ __device__ inline Plan plan_of(int mode, bool bwd, int d, int hid, int d_out) {
  Plan p;
  p.mode = mode;
  p.bwd = bwd ? 1 : 0;
  p.d = d;
  p.hid = hid;
  p.d_out = d_out;
  p.W = (d + KU - 1) / KU;
  p.WO = (d_out + KU - 1) / KU;
  p.NB = (d + 63) / 64;
  p.NBO = (d_out + 63) / 64;
  p.chunks = (hid + HC - 1) / HC;
  p.upc = p.W + (bwd ? p.WO + p.NB * (mode == MODE_GEGLU ? 2 : 1) : p.NBO);
  return p;
}

__host__ __device__ inline long long unit_floats(const Plan& p) { return (long long)p.chunks * p.upc * UNIT_FLOATS; }

// Whether the tensor-core instance takes these widths; else the FFMA chain
__host__ inline bool rows_fit(int d, int d_out) { return d <= MAX_D && d_out <= MAX_D; }

__device__ __forceinline__ float gelu_cdf(float g) { return 0.5f * (1.0f + erff(g * 0.70710678118654752f)); }
__device__ __forceinline__ float gelu_pdf(float g) { return expf(-0.5f * g * g) * 0.39894228040143268f; }

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// Position p (0..7) of a group of 8 of a unit contracted over hidden units
// holds hidden unit perm(p) of the group
__device__ __forceinline__ int perm8(int p) { return p < 4 ? 2 * p : 2 * (p - 4) + 1; }

// Byte offset of chunk c (columns 4c .. 4c + 3) of row r of a [R x 32] f32
// tile in the 128-byte swizzle (Tf32Tile<R, 32>)
__device__ __forceinline__ uint32_t unit_offset(int r, int c) { return r * 128 + ((c ^ (r & 7)) << 4); }

// The K-major descriptor of k-step kk (0..3) of a [R x 32] tile at `base`
__device__ __forceinline__ uint64_t unit_desc(uint32_t base, int kk) { return gmma_desc(base + kk * 32, 16, 1024, 1); }

// ---------------------------------------------------------------------------
// The weights split into units, once a call
// ---------------------------------------------------------------------------

// Element (r, k) of unit j of chunk c; rows past the unit's are never read
__device__ __forceinline__ float unit_value(const Plan& p, int c, int j, int r, int k, const float* __restrict__ w_in,
                                            const float* __restrict__ w_out) {
  const bool geglu = p.mode == MODE_GEGLU;
  const int hk = c * HC + (k & ~7) + perm8(k & 7);  // the hidden unit at permuted position k
  if (j < p.W) {  // W_in's rows (GEGLU: 32 val rows, then their 32 gate rows), d-window j
    const int unit = c * HC + (r % HC), col = j * KU + k;
    if ((!geglu && r >= HC) || unit >= p.hid || col >= p.d) return 0.0f;
    return w_in[(long long)(geglu && r >= HC ? p.hid + unit : unit) * p.d + col];
  }
  j -= p.W;
  if (!p.bwd) {  // W_out's rows of y's column block j, the hidden units permuted
    const int o = j * 64 + r;
    return o < p.d_out && hk < p.hid ? w_out[(long long)o * p.hid + hk] : 0.0f;
  }
  if (j < p.WO) {  // W_out^T: rows the chunk's hidden units, d_out-window j
    const int h = c * HC + r, o = j * KU + k;
    return r < HC && h < p.hid && o < p.d_out ? w_out[(long long)o * p.hid + h] : 0.0f;
  }
  j -= p.WO;  // W_in^T: rows dxn's columns of block j % NB, val (j < NB) then gate, the hidden units permuted
  const int part = j / p.NB, cb = j % p.NB;
  const int dc = cb * 64 + r;
  return dc < p.d && hk < p.hid ? w_in[(long long)(part ? p.hid + hk : hk) * p.d + dc] : 0.0f;
}

// grid (chunks * upc, tasks), 256 threads: unit blockIdx.x of task
// blockIdx.y, 2 of its 512 16-byte chunks (64 rows x 8) a thread
__global__ void __launch_bounds__(256)
ffn_tf32_split_kernel(Plan p, const float* __restrict__ w_in, const float* __restrict__ w_out,
                      float* __restrict__ units, long long in_task, long long out_task, long long units_task) {
  const int u = blockIdx.x, c = u / p.upc, j = u % p.upc;
  w_in += blockIdx.y * in_task;
  w_out += blockIdx.y * out_task;
  unsigned char* slot = reinterpret_cast<unsigned char*>(units + blockIdx.y * units_task + (long long)u * UNIT_FLOATS);
#pragma unroll
  for (int it = 0; it < 2; ++it) {
    const int i = it * 256 + threadIdx.x, r = i / 8, c4 = i % 8;
    float4 v;
    v.x = unit_value(p, c, j, r, 4 * c4, w_in, w_out);
    v.y = unit_value(p, c, j, r, 4 * c4 + 1, w_in, w_out);
    v.z = unit_value(p, c, j, r, 4 * c4 + 2, w_in, w_out);
    v.w = unit_value(p, c, j, r, 4 * c4 + 3, w_in, w_out);
    uint4 hi, lo;
    split_tf32(v, hi, lo);
    *reinterpret_cast<uint4*>(slot + unit_offset(r, c4)) = hi;
    *reinterpret_cast<uint4*>(slot + LO + unit_offset(r, c4)) = lo;
  }
}

// ---------------------------------------------------------------------------
// Pieces of the row kernels
// ---------------------------------------------------------------------------

// A raw f32 row tile in shared memory, [64 x DP] (DP: the width rounded up
// to 32), element (r, c) at r DP + (c ^ 4 (r % 8)): the A fragment reads of a
// warp (8 rows by 4 columns) and the float4 writes of a row fall in
// distinct banks.
__device__ __forceinline__ int raw_index(int r, int c, int dp) { return r * dp + (c ^ ((r & 7) << 2)); }

// The TF32 A fragments (hi, lo) of k-step ks of this thread's rows of a raw
// tile: rows (g, g + 8) of its warp's 16 by columns (t, t + 4) of the step
__device__ __forceinline__ void raw_fragments(const float* tile, int dp, int ks, uint32_t (&hi)[4], uint32_t (&lo)[4]) {
  const int lane = threadIdx.x % 32, r = (threadIdx.x / 32) * 16 + lane / 4, c = 8 * ks + (lane & 3);
  split_tf32(tile[raw_index(r, c, dp)], hi[0], lo[0]);
  split_tf32(tile[raw_index(r + 8, c, dp)], hi[1], lo[1]);
  split_tf32(tile[raw_index(r, c + 4, dp)], hi[2], lo[2]);
  split_tf32(tile[raw_index(r + 8, c + 4, dp)], hi[3], lo[3]);
}

// The A fragments of J k-steps of a product over an accumulator's columns,
// from its values x[4 j + 2 h + e] (row g + 8 h, column 8 j + 2 t + e)
template <int J>
__device__ __forceinline__ void acc_fragments(const float (&x)[4 * J], uint32_t (&hi)[J][4], uint32_t (&lo)[J][4]) {
#pragma unroll
  for (int j = 0; j < J; ++j)
#pragma unroll
    for (int e = 0; e < 2; ++e)
#pragma unroll
      for (int h = 0; h < 2; ++h) split_tf32(x[4 * j + 2 * h + e], hi[j][2 * e + h], lo[j][2 * e + h]);
}

// t = the 3xTF32 product of a raw tile's window w (4 k-steps) with a unit at
// `slot` (N rows), into a fresh accumulator; then acc += t
template <int N>
__device__ __forceinline__ void add_window(float (&acc)[N / 2], const float* tile, int dp, int w, uint32_t slot) {
  uint32_t hi[4][4], lo[4][4];
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) raw_fragments(tile, dp, 4 * w + kk, hi[kk], lo[kk]);
  float t[N / 2];
#pragma unroll
  for (int i = 0; i < N / 2; ++i) t[i] = 0.0f;
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) mma3_rs<N>(t, hi[kk], lo[kk], unit_desc(slot, kk), unit_desc(slot + LO, kk));
  wgmma_commit();
  wgmma_wait_all();
  keep(t);
  keep(hi);
  keep(lo);
#pragma unroll
  for (int i = 0; i < N / 2; ++i) acc[i] += t[i];
}

// acc += the 3xTF32 product of 4 k-steps of register fragments with the
// 64-row unit at `slot`, through a fresh accumulator
__device__ __forceinline__ void add_fragments(float (&acc)[32], uint32_t (&hi)[4][4], uint32_t (&lo)[4][4],
                                              uint32_t slot) {
  float t[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) t[i] = 0.0f;
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) mma3_rs<64>(t, hi[kk], lo[kk], unit_desc(slot, kk), unit_desc(slot + LO, kk));
  wgmma_commit();
  wgmma_wait_all();
  keep(t);
  keep(hi);
  keep(lo);
#pragma unroll
  for (int i = 0; i < 32; ++i) acc[i] += t[i];
}

// The ring of weight units: S slots of UNIT_BYTES at `ring`; units
// [first, first + total) of the call's units stream through it in order.
// next() waits for the next unit, frees the slot of the one before (a block
// barrier) for the unit S - 1 ahead, and returns its slot.
struct Ring {
  uint32_t ring;
  const float* units;
  long long first;
  int total, s, i;

  __device__ __forceinline__ void load(int k) {
    const uint32_t dst = ring + (k % s) * UNIT_BYTES;
    const float* src = units + (first + k) * UNIT_FLOATS;
#pragma unroll
    for (int it = 0; it < UNIT_BYTES / 16 / NT; ++it) {
      const int q = it * NT + threadIdx.x;
      cp_async16(dst + 16 * q, src + 4 * q, true);
    }
  }

  __device__ __forceinline__ void start() {
    for (int k = 0; k < s - 1; ++k) {
      if (k < total) load(k);
      cp_async_commit();
    }
  }

  __device__ __forceinline__ uint32_t next() {
    if (s == 4)
      cp_async_wait<2>();
    else
      cp_async_wait<1>();
    fence_async_smem();
    __syncthreads();  // unit i has landed for everyone; every thread is done with unit i - 1
    if (i + s - 1 < total) load(i + s - 1);
    cp_async_commit();
    const uint32_t slot = ring + (i % s) * UNIT_BYTES;
    ++i;
    return slot;
  }
};

// Issues the cp.async copies of rows [m0, m0 + 64) of a [m, width] operand
// into the raw tile at shared address `tile` (zeros past m and width): all
// rows in flight at once
__device__ __forceinline__ void stage_rows(uint32_t tile, int dp, const float* __restrict__ src, int m0, int m,
                                           int width) {
  for (int i = threadIdx.x; i < ROWS * (dp / 4); i += NT) {
    const int r = i / (dp / 4), c = 4 * (i % (dp / 4));
    const bool in = m0 + r < m && c < width;
    cp_async16(tile + 4 * raw_index(r, c, dp), src + (in ? (long long)(m0 + r) * width + c : 0), in);
  }
}

// The bias-free LayerNorm of a staged raw tile's rows, in place, a warp a
// row, 8 columns a lane (d <= 256; zeros stay past d); each row's mean and
// 1 / sqrt(var + eps) into mean_s / rstd_s where given (zeros past m)
__device__ __forceinline__ void norm_tile(float* tile, int dp, const float* __restrict__ gamma, int m0, int m, int d,
                                          float* mean_s, float* rstd_s) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, c = 8 * lane;
  const bool in = c < d;
  float g[8];
#pragma unroll
  for (int k = 0; k < 8; ++k) g[k] = in ? gamma[c + k] : 0.0f;
  for (int r = warp; r < ROWS; r += NT / 32) {
    float v[8];
    if (in) {
      const float4 a = *reinterpret_cast<const float4*>(tile + raw_index(r, c, dp));
      const float4 b = *reinterpret_cast<const float4*>(tile + raw_index(r, c + 4, dp));
      v[0] = a.x, v[1] = a.y, v[2] = a.z, v[3] = a.w, v[4] = b.x, v[5] = b.y, v[6] = b.z, v[7] = b.w;
    } else {
#pragma unroll
      for (int k = 0; k < 8; ++k) v[k] = 0.0f;
    }
    float s = 0.0f;
#pragma unroll
    for (int k = 0; k < 8; ++k) s += v[k];
    const float mean = warp_sum(s) / d;
    float q = 0.0f;
    if (in) {
#pragma unroll
      for (int k = 0; k < 8; ++k) q = fmaf(v[k] - mean, v[k] - mean, q);
    }
    const float rstd = 1.0f / sqrtf(warp_sum(q) / d + LN_EPS);
    if (in) {
      const bool row_in = m0 + r < m;  // rows past m stay zero
      float o[8];
#pragma unroll
      for (int k = 0; k < 8; ++k) o[k] = row_in ? (v[k] - mean) * rstd * g[k] : 0.0f;
      *reinterpret_cast<float4*>(tile + raw_index(r, c, dp)) = make_float4(o[0], o[1], o[2], o[3]);
      *reinterpret_cast<float4*>(tile + raw_index(r, c + 4, dp)) = make_float4(o[4], o[5], o[6], o[7]);
    }
    if (mean_s != nullptr && lane == 0) {
      mean_s[r] = m0 + r < m ? mean : 0.0f;
      rstd_s[r] = m0 + r < m ? rstd : 0.0f;
    }
  }
}

// ---------------------------------------------------------------------------
// Forward: y = a(xn W_in^T) W_out^T (GEGLU) or gelu(x W1^T + b1) W2^T + b2
// ---------------------------------------------------------------------------

// Shared memory of the forward row kernel: the ring, then the raw row tile
__host__ __device__ inline uint32_t fwd_smem(int d, int slots) {
  return slots * UNIT_BYTES + ROWS * ((d + 31) / 32 * 32) * 4 + 1024;
}

// The ring's depth: 4 slots where two blocks still fit a SM, else 3
__host__ inline int fwd_slots(int d) { return 2 * (fwd_smem(d, 4) + 1024) <= 233472 ? 4 : 3; }

// Block = 64 rows (blockIdx.x) by a range of hidden chunks (blockIdx.y:
// cps chunks each) of task blockIdx.z (its x, biases, units, y and
// partials one task's extent apart). NBO: d_out's 64-column blocks, the y
// accumulators.
template <int MODE, int NBO>
__global__ void __launch_bounds__(NT, 2)
ffn_tf32_fwd_rows_kernel(Plan p, const float* __restrict__ x, const float* __restrict__ gamma,
                         const float* __restrict__ b_in, const float* __restrict__ b_out,
                         const float* __restrict__ units, float* __restrict__ y, float* __restrict__ part, int m,
                         int cps, int slots) {
  constexpr int NU = MODE == MODE_GEGLU ? 2 * HC : HC;  // u's columns a chunk
  const int d = p.d, hid = p.hid, d_out = p.d_out, dp = p.W * KU;
  const long long t = blockIdx.z;
  x += t * m * d;
  if (MODE == MODE_MLP) {
    b_in += t * hid;
    b_out += t * d_out;
  }
  units += t * unit_floats(p);
  y += t * m * d_out;
  if (part != nullptr) part += t * gridDim.y * (long long)m * d_out;

  extern __shared__ unsigned char smem_raw[];
  unsigned char* sm;
  const uint32_t sa = aligned_smem(smem_raw, &sm);
  float* xs = reinterpret_cast<float*>(sm + slots * UNIT_BYTES);
  const int m0 = blockIdx.x * ROWS;
  const int lane = threadIdx.x % 32, t4 = lane & 3;
  const int c_begin = blockIdx.y * cps, c_end = min(p.chunks, c_begin + cps);

  stage_rows(sa + slots * UNIT_BYTES, dp, x, m0, m, d);
  cp_async_commit();
  Ring ring{sa, units, (long long)c_begin * p.upc, (c_end - c_begin) * p.upc, slots, 0};
  ring.start();
  if (MODE == MODE_GEGLU) {
    if (slots == 4)
      cp_async_wait<3>();
    else
      cp_async_wait<2>();  // the rows have landed (the units may still be in flight)
    __syncthreads();
    norm_tile(xs, dp, gamma, m0, m, d, nullptr, nullptr);
  }
  // (the first next() waits for the rows too and is the barrier after the tile's writes)

  float acc[NBO][32];
#pragma unroll
  for (int cb = 0; cb < NBO; ++cb)
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[cb][i] = 0.0f;

  for (int c = c_begin; c < c_end; ++c) {
    float u[NU / 2];
#pragma unroll
    for (int i = 0; i < NU / 2; ++i) u[i] = 0.0f;
    for (int w = 0; w < p.W; ++w) add_window<NU>(u, xs, dp, w, ring.next());

    // the activation on the fragments: a = val gelu(gate) (val in u[0, 16),
    // the gate of the same column 16 on) or gelu(h + b1), zero past hid
    float a[16];
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int col = c * HC + 8 * j + 2 * t4 + e;
        const float b = MODE == MODE_MLP && col < hid ? b_in[col] : 0.0f;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int i = 4 * j + 2 * h + e;
          if constexpr (MODE == MODE_GEGLU) {
            const float g = u[i + 16];
            a[i] = u[i] * (g * gelu_cdf(g));
          } else {
            const float g = u[i] + b;
            a[i] = g * gelu_cdf(g);
          }
        }
      }
    uint32_t ahi[4][4], alo[4][4];
    acc_fragments<4>(a, ahi, alo);
#pragma unroll
    for (int cb = 0; cb < NBO; ++cb) add_fragments(acc[cb], ahi, alo, ring.next());
  }

  const int r0 = (threadIdx.x / 32) * 16 + lane / 4;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const long long row = (long long)m0 + r0 + 8 * h;
    if (row >= m) continue;
#pragma unroll
    for (int cb = 0; cb < NBO; ++cb)
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int col = cb * 64 + 8 * j + 2 * t4;
        if (col >= d_out) continue;  // d_out is even: col + 1 is inside too
        float v0 = acc[cb][4 * j + 2 * h], v1 = acc[cb][4 * j + 2 * h + 1];
        if (gridDim.y > 1) {  // a split's partial y, summed by ffn_tf32_fwd_reduce_kernel
          *reinterpret_cast<float2*>(part + ((long long)blockIdx.y * m + row) * d_out + col) = make_float2(v0, v1);
          continue;
        }
        if (MODE == MODE_MLP) {
          v0 += b_out[col];
          v1 += b_out[col + 1];
        }
        *reinterpret_cast<float2*>(y + row * d_out + col) = make_float2(v0, v1);
      }
  }
}

// y = the splits' partials [splits, m, d_out] summed in order (+ b_out);
// blockIdx.y a task
__global__ void __launch_bounds__(256)
ffn_tf32_fwd_reduce_kernel(const float* __restrict__ part, const float* __restrict__ b_out, float* __restrict__ y,
                           int m, int d_out, int splits) {
  const long long quads = (long long)m * d_out / 4, t = blockIdx.y;
  part += t * splits * quads * 4;
  y += t * quads * 4;
  if (b_out != nullptr) b_out += t * d_out;
  for (long long i = (long long)blockIdx.x * 256 + threadIdx.x; i < quads; i += (long long)gridDim.x * 256) {
    float4 s = reinterpret_cast<const float4*>(part)[i];
    for (int k = 1; k < splits; ++k) {
      const float4 v = reinterpret_cast<const float4*>(part)[k * quads + i];
      s.x += v.x;
      s.y += v.y;
      s.z += v.z;
      s.w += v.w;
    }
    if (b_out != nullptr) {
      const int col = (int)(i * 4 % d_out);
      s.x += b_out[col];
      s.y += b_out[col + 1];
      s.z += b_out[col + 2];
      s.w += b_out[col + 3];
    }
    reinterpret_cast<float4*>(y)[i] = s;
  }
}

// The hidden split of the forward: chunks a block and blocks a row tile.
// Where the row tiles (of all tasks) fill under half of the SMs, a tile's
// chunks are spread over about one block an SM.
struct Split {
  int cps, splits;
};

__host__ inline Split fwd_split(int m, int hid, int tasks) {
  const int tiles = (m + ROWS - 1) / ROWS * tasks, chunks = (hid + HC - 1) / HC, sms = sm_count();
  if (2 * tiles >= sms) return {chunks, 1};
  int want = sms / tiles;
  want = want < chunks ? want : chunks;
  const int cps = (chunks + want - 1) / want;
  return {cps, (chunks + cps - 1) / cps};
}

// Floats of a forward's workspace: the units of every task, then the
// partial y where the hidden chunks split
__host__ inline long long fwd_workspace_floats(int mode, int tasks, int m, int d, int hid, int d_out) {
  const Plan p = plan_of(mode, false, d, hid, d_out);
  const Split sp = fwd_split(m, hid, tasks);
  return tasks * (unit_floats(p) + (sp.splits > 1 ? (long long)sp.splits * m * d_out : 0));
}

__host__ inline int fwd_kernels(int m, int hid, int tasks) { return fwd_split(m, hid, tasks).splits > 1 ? 3 : 2; }

// The kernel's dynamic shared memory limit and the carveout (as much shared
// memory as the SM has, for two blocks), set once per device
inline cudaError_t allow_smem_shared(const void* kernel, size_t bytes, std::atomic<unsigned>& ready) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  const unsigned bit = 1u << (dev & 31);
  if (ready.load(std::memory_order_relaxed) & bit) return cudaSuccess;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err == cudaSuccess) err = cudaFuncSetAttribute(kernel, cudaFuncAttributePreferredSharedMemoryCarveout, 100);
  if (err == cudaSuccess) ready.fetch_or(bit);
  return err;
}

// The split of the weights into units (tasks sets of weights, one after the other)
static cudaError_t split_weights(const Plan& p, const float* w_in, const float* w_out, float* units, int tasks,
                                 cudaStream_t stream) {
  const long long in_task = (long long)(p.mode == MODE_GEGLU ? 2 * p.hid : p.hid) * p.d;
  ffn_tf32_split_kernel<<<dim3(p.chunks * p.upc, tasks), 256, 0, stream>>>(p, w_in, w_out, units, in_task,
                                                                             (long long)p.d_out * p.hid,
                                                                             unit_floats(p));
  return cudaGetLastError();
}

template <int MODE, int NBO>
static cudaError_t launch_fwd_rows(const Plan& p, const float* x, const float* gamma, const float* b_in,
                                   const float* b_out, const float* units, float* y, float* part, int m, int tasks,
                                   const Split& sp, cudaStream_t stream) {
  static std::atomic<unsigned> ready{0};
  auto kernel = ffn_tf32_fwd_rows_kernel<MODE, NBO>;
  cudaError_t err = allow_smem_shared((const void*)kernel, fwd_smem(MAX_D, 4), ready);
  if (err != cudaSuccess) return err;
  const int slots = fwd_slots(p.d);
  kernel<<<dim3((m + ROWS - 1) / ROWS, sp.splits, tasks), NT, fwd_smem(p.d, slots), stream>>>(
      p, x, gamma, b_in, b_out, units, y, part, m, sp.cps, slots);
  return cudaGetLastError();
}

// One forward (tasks sets of weights and rows; GEGLU has one): the split of
// the weights, the row kernel and, where the hidden chunks split, the
// reduction. ws: fwd_workspace_floats floats.
template <int MODE>
static cudaError_t forward(const float* x, const float* gamma, const float* w_in, const float* b_in,
                           const float* w_out, const float* b_out, float* y, float* ws, int tasks, int m, int d,
                           int hid, int d_out, cudaStream_t stream) {
  const Plan p = plan_of(MODE, false, d, hid, d_out);
  const Split sp = fwd_split(m, hid, tasks);
  float* part = sp.splits > 1 ? ws + tasks * unit_floats(p) : nullptr;
  cudaError_t err = split_weights(p, w_in, w_out, ws, tasks, stream);
  if (err != cudaSuccess) return err;
  switch (p.NBO) {
    case 1: err = launch_fwd_rows<MODE, 1>(p, x, gamma, b_in, b_out, ws, y, part, m, tasks, sp, stream); break;
    case 2: err = launch_fwd_rows<MODE, 2>(p, x, gamma, b_in, b_out, ws, y, part, m, tasks, sp, stream); break;
    case 3: err = launch_fwd_rows<MODE, 3>(p, x, gamma, b_in, b_out, ws, y, part, m, tasks, sp, stream); break;
    default: err = launch_fwd_rows<MODE, 4>(p, x, gamma, b_in, b_out, ws, y, part, m, tasks, sp, stream); break;
  }
  if (err != cudaSuccess || sp.splits == 1) return err;
  const long long blocks = ((long long)m * d_out / 4 + 255) / 256;
  ffn_tf32_fwd_reduce_kernel<<<dim3((unsigned)(blocks < 1024 ? blocks : 1024), tasks), 256, 0, stream>>>(
      part, MODE == MODE_MLP ? b_out : nullptr, y, m, d_out, sp.splits);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// Backward: the row pass (dx, the transposed workspaces, the vector
// partials), the weight gradients, the reduction
// ---------------------------------------------------------------------------

constexpr int BWD_SLOTS = 4;

// Shared memory of the backward row kernel: the ring, the raw x (xn) and dy
// tiles, the rows' LayerNorm statistics, the per-warp column sums of two
// chunks' dh (MLP db1)
struct BwdSmem {
  uint32_t xs, dys, stats, red, bytes;
};

__host__ __device__ inline BwdSmem bwd_smem(int d, int d_out) {
  BwdSmem L;
  L.xs = BWD_SLOTS * UNIT_BYTES;
  L.dys = L.xs + ROWS * ((d + 31) / 32 * 32) * 4;
  L.stats = L.dys + ROWS * ((d_out + 31) / 32 * 32) * 4;
  L.red = L.stats + 2 * ROWS * 4;
  L.bytes = L.red + 2 * 4 * HC * 4 + 1024;
  return L;
}

// The f32 workspaces of one backward, in floats from its start: the units,
// du (dh) [hw, mp], a [hid, mp], xn (x) [d, mp] and dy [d_out, mp], all
// transposed (mp: m rounded up to the row tile), the weight gradients'
// partials [splits, P, Q] (P the hidden side) and the row blocks' vector
// partials (GEGLU dgamma [blocks, d]; MLP db1 [blocks, hid], db2 [blocks,
// d_out]).
struct BwdScratch {
  int mp, blocks, splits, range, tiles0, tiles1;
  long long units, ht, at, xt, dyt, part0, part1, vec0, vec1, floats;
};

__host__ inline BwdScratch bwd_scratch(int mode, int m, int d, int hid, int d_out) {
  const Plan p = plan_of(mode, true, d, hid, d_out);
  BwdScratch s;
  s.blocks = (m + ROWS - 1) / ROWS;
  s.mp = s.blocks * ROWS;
  const int p0 = mode == MODE_GEGLU ? 2 * hid : hid;
  s.tiles0 = (p0 + 127) / 128;
  s.tiles1 = (hid + 127) / 128;
  const int stages = s.mp / 32, tiles = s.tiles0 + s.tiles1;
  int splits = (2 * sm_count() + tiles / 2) / tiles;
  splits = splits < 1 ? 1 : (splits > MAX_SPLITS ? MAX_SPLITS : splits);
  splits = splits > stages ? stages : splits;
  s.range = (stages + splits - 1) / splits * 32;
  s.splits = (s.mp + s.range - 1) / s.range;
  s.units = 0;
  s.ht = unit_floats(p);
  s.at = s.ht + (long long)p0 * s.mp;
  s.xt = s.at + (long long)hid * s.mp;
  s.dyt = s.xt + (long long)d * s.mp;
  s.part0 = s.dyt + (long long)d_out * s.mp;
  s.part1 = s.part0 + (long long)s.splits * p0 * d;
  s.vec0 = s.part1 + (long long)s.splits * hid * d_out;
  s.vec1 = s.vec0 + (long long)s.blocks * (mode == MODE_GEGLU ? d : hid);
  s.floats = s.vec1 + (mode == MODE_GEGLU ? 0 : (long long)s.blocks * d_out);
  return s;
}

// The sum over the 8 row groups of a warp (lanes with the same lane % 4)
__device__ __forceinline__ float column_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 4);
  v += __shfl_xor_sync(0xffffffffu, v, 8);
  return v + __shfl_xor_sync(0xffffffffu, v, 16);
}

// A raw tile's rows written transposed, dst[c mp + m0 + r] for c < width,
// 4 rows a float4
__device__ __forceinline__ void store_transposed(float* __restrict__ dst, const float* tile, int dp, int width,
                                                 int m0, int mp) {
  for (int i = threadIdx.x; i < width * (ROWS / 4); i += NT) {
    const int c = i / (ROWS / 4), q = i % (ROWS / 4);
    const float4 v = make_float4(tile[raw_index(4 * q, c, dp)], tile[raw_index(4 * q + 1, c, dp)],
                                 tile[raw_index(4 * q + 2, c, dp)], tile[raw_index(4 * q + 3, c, dp)]);
    *reinterpret_cast<float4*>(dst + (long long)c * mp + m0 + 4 * q) = v;
  }
}

// Block = 64 rows. NB: d's 64-column blocks, the dxn accumulators.
template <int MODE, int NB>
__global__ void __launch_bounds__(NT, 1)
ffn_tf32_bwd_rows_kernel(Plan p, const float* __restrict__ x, const float* __restrict__ gamma,
                         const float* __restrict__ b_in, const float* __restrict__ dy, const float* __restrict__ units,
                         float* __restrict__ dx, float* __restrict__ ht, float* __restrict__ at,
                         float* __restrict__ xt, float* __restrict__ dyt, float* __restrict__ vec0,
                         float* __restrict__ vec1, int m, int mp) {
  constexpr int NU = MODE == MODE_GEGLU ? 2 * HC : HC;
  const int d = p.d, hid = p.hid, d_out = p.d_out, dp = p.W * KU, dop = p.WO * KU;
  const BwdSmem L = bwd_smem(d, d_out);
  extern __shared__ unsigned char smem_raw[];
  unsigned char* sm;
  const uint32_t sa = aligned_smem(smem_raw, &sm);
  float* xs = reinterpret_cast<float*>(sm + L.xs);
  float* dys = reinterpret_cast<float*>(sm + L.dys);
  float* mean_s = reinterpret_cast<float*>(sm + L.stats);
  float* rstd_s = mean_s + ROWS;
  float* red = reinterpret_cast<float*>(sm + L.red);
  const int m0 = blockIdx.x * ROWS;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, t4 = lane & 3;
  const int r0 = warp * 16 + lane / 4;  // this thread's rows of the tile: r0, r0 + 8

  stage_rows(sa + L.dys, dop, dy, m0, m, d_out);
  stage_rows(sa + L.xs, dp, x, m0, m, d);
  cp_async_commit();
  Ring ring{sa, units, 0, p.chunks * p.upc, BWD_SLOTS, 0};
  ring.start();
  cp_async_wait<BWD_SLOTS - 1>();  // the rows have landed (the units may still be in flight)
  __syncthreads();
  if (MODE == MODE_GEGLU) {
    norm_tile(xs, dp, gamma, m0, m, d, mean_s, rstd_s);
    __syncthreads();
  }
  store_transposed(xt, xs, dp, d, m0, mp);
  store_transposed(dyt, dys, dop, d_out, m0, mp);
  if (MODE == MODE_MLP) {  // db2: this block's column sums of dy
    for (int c = threadIdx.x; c < d_out; c += NT) {
      float s = 0.0f;
      for (int r = 0; r < ROWS; ++r) s += dys[raw_index(r, c, dop)];
      vec1[(long long)blockIdx.x * d_out + c] = s;
    }
  }

  float dxn[NB][32];
#pragma unroll
  for (int cb = 0; cb < NB; ++cb)
#pragma unroll
    for (int i = 0; i < 32; ++i) dxn[cb][i] = 0.0f;

  for (int c = 0; c < p.chunks; ++c) {
    // u = xn W_in[chunk]^T ([val | gate], or h before its bias), da = dy W_out[:, chunk]
    float u[NU / 2], da[16];
#pragma unroll
    for (int i = 0; i < NU / 2; ++i) u[i] = 0.0f;
#pragma unroll
    for (int i = 0; i < 16; ++i) da[i] = 0.0f;
    for (int w = 0; w < p.W; ++w) add_window<NU>(u, xs, dp, w, ring.next());
    for (int w = 0; w < p.WO; ++w) add_window<32>(da, dys, dop, w, ring.next());

    // the GELU parts on the fragments: du = [da gelu(gate), da val
    // gelu'(gate)] (MLP: dh = da gelu'(h), h = u + b1) and a = val gelu(gate)
    // (MLP: gelu(h)), stored transposed; MLP: this thread's sums of dh over
    // its two rows
    float g0[16], g1[16], csum[8];
    // (the chunk's store bases made opaque: the compiler would keep a
    // pointer for every element of every store live across the loop)
    float* hc = ht + (long long)c * HC * mp + m0 + r0;
    float* ac = at + (long long)c * HC * mp + m0 + r0;
    asm volatile("" : "+l"(hc), "+l"(ac));
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int col = c * HC + 8 * j + 2 * t4 + e;
        const float b = MODE == MODE_MLP && col < hid ? b_in[col] : 0.0f;
        float s = 0.0f;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int i = 4 * j + 2 * h + e;
          const float g = MODE == MODE_GEGLU ? u[i + 16] : u[i] + b;
          const float cdf = gelu_cdf(g), gd = cdf + g * gelu_pdf(g);
          float act;
          if constexpr (MODE == MODE_GEGLU) {
            const float gv = g * cdf;
            g0[i] = da[i] * gv;
            g1[i] = da[i] * u[i] * gd;
            act = u[i] * gv;
          } else {
            g0[i] = da[i] * gd;
            g1[i] = 0.0f;
            act = g * cdf;
            s += g0[i];
          }
          if (col < hid) {
            const long long at_col = (long long)(col - c * HC) * mp + 8 * h;
            hc[at_col] = g0[i];
            if (MODE == MODE_GEGLU) hc[at_col + (long long)hid * mp] = g1[i];
            ac[at_col] = act;
          }
        }
        csum[2 * j + e] = s;
      }
    if (MODE == MODE_MLP) {  // db1: the chunk's column sums over the block's rows
      float* slot = red + (c & 1) * 4 * HC + warp * HC;
#pragma unroll
      for (int k = 0; k < 8; ++k) csum[k] = column_sum(csum[k]);
      if (lane < 4) {
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          slot[8 * j + 2 * t4] = csum[2 * j];
          slot[8 * j + 2 * t4 + 1] = csum[2 * j + 1];
        }
      }
    }

    // dxn += du[chunk] W_in[chunk] (dx for the MLP): A from registers; GEGLU
    // the val half, then the gate half (one half's fragments live at a time)
    uint32_t fhi[4][4], flo[4][4];
    acc_fragments<4>(g0, fhi, flo);
    if constexpr (MODE == MODE_GEGLU) {
#pragma unroll
      for (int cb = 0; cb < NB; ++cb) add_fragments(dxn[cb], fhi, flo, ring.next());
      acc_fragments<4>(g1, fhi, flo);
#pragma unroll
      for (int cb = 0; cb < NB; ++cb) add_fragments(dxn[cb], fhi, flo, ring.next());
    } else {
#pragma unroll
      for (int cb = 0; cb < NB; ++cb) {
        add_fragments(dxn[cb], fhi, flo, ring.next());
        // (the first next() was a barrier after every warp's db1 slots)
        if (cb == 0 && threadIdx.x < HC && c * HC + threadIdx.x < hid) {
          const float* rs = red + (c & 1) * 4 * HC;
          vec0[(long long)blockIdx.x * hid + c * HC + threadIdx.x] =
              rs[threadIdx.x] + rs[HC + threadIdx.x] + rs[2 * HC + threadIdx.x] + rs[3 * HC + threadIdx.x];
        }
      }
    }
  }

  if constexpr (MODE == MODE_MLP) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const long long row = (long long)m0 + r0 + 8 * h;
      if (row >= m) continue;
#pragma unroll
      for (int cb = 0; cb < NB; ++cb)
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const int col = cb * 64 + 8 * j + 2 * t4;
          if (col < d)
            *reinterpret_cast<float2*>(dx + row * d + col) =
                make_float2(dxn[cb][4 * j + 2 * h], dxn[cb][4 * j + 2 * h + 1]);
        }
    }
    return;
  }

  // GEGLU: dgamma = sum over rows of dxn z, and the LayerNorm backward
  // dx = (dz - mean(dz) - z mean(dz z)) rstd with dz = dxn gamma, z from x
  // and the kept statistics
  __syncthreads();  // every product is done: the ring is free
  float* gred = reinterpret_cast<float*>(sm);  // [4 warps][NB * 64]
  float mean[2], rstd[2], s1[2] = {0.0f, 0.0f}, s2[2] = {0.0f, 0.0f};
  long long row[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    mean[h] = mean_s[r0 + 8 * h];
    rstd[h] = rstd_s[r0 + 8 * h];
    row[h] = (long long)m0 + r0 + 8 * h;
  }
  auto z_of = [&](int h, int col, float* z) {
    if (row[h] < m && col < d) {
      const float2 xv = *reinterpret_cast<const float2*>(x + row[h] * d + col);
      z[0] = (xv.x - mean[h]) * rstd[h];
      z[1] = (xv.y - mean[h]) * rstd[h];
    } else {
      z[0] = z[1] = 0.0f;
    }
  };
#pragma unroll
  for (int cb = 0; cb < NB; ++cb)
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int col = cb * 64 + 8 * j + 2 * t4;
      const float gm[2] = {col < d ? gamma[col] : 0.0f, col < d ? gamma[col + 1] : 0.0f};
      float gp[2] = {0.0f, 0.0f};
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        float z[2];
        z_of(h, col, z);
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float v = dxn[cb][4 * j + 2 * h + e], dz = v * gm[e];
          s1[h] += dz;
          s2[h] = fmaf(dz, z[e], s2[h]);
          gp[e] = fmaf(v, z[e], gp[e]);
        }
      }
      gp[0] = column_sum(gp[0]);
      gp[1] = column_sum(gp[1]);
      if (lane < 4) {
        gred[warp * NB * 64 + col] = gp[0];
        gred[warp * NB * 64 + col + 1] = gp[1];
      }
    }
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    s1[h] += __shfl_xor_sync(0xffffffffu, s1[h], 1);
    s1[h] += __shfl_xor_sync(0xffffffffu, s1[h], 2);
    s2[h] += __shfl_xor_sync(0xffffffffu, s2[h], 1);
    s2[h] += __shfl_xor_sync(0xffffffffu, s2[h], 2);
    s1[h] /= d;
    s2[h] /= d;
  }
#pragma unroll
  for (int cb = 0; cb < NB; ++cb)
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int col = cb * 64 + 8 * j + 2 * t4;
      if (col >= d) continue;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        if (row[h] >= m) continue;
        float z[2];
        z_of(h, col, z);
        const float dz0 = dxn[cb][4 * j + 2 * h] * gamma[col], dz1 = dxn[cb][4 * j + 2 * h + 1] * gamma[col + 1];
        *reinterpret_cast<float2*>(dx + row[h] * d + col) =
            make_float2((dz0 - s1[h] - z[0] * s2[h]) * rstd[h], (dz1 - s1[h] - z[1] * s2[h]) * rstd[h]);
      }
    }
  __syncthreads();
  for (int col = threadIdx.x; col < d; col += NT) {
    const int w = NB * 64;
    vec0[(long long)blockIdx.x * d + col] = gred[col] + gred[w + col] + gred[2 * w + col] + gred[3 * w + col];
  }
}

// One weight gradient of the backward: C [P, Q] = X^T Y over the rows, from
// X^T [P, mp] and Y^T [Q, mp] (row pass workspaces), as partials [splits,
// P, Q] (trans: [splits, Q, P], C transposed)
struct WG {
  const float* xt;
  const float* yt;
  float* part;
  int p, q, trans;
};

// Shared memory of the weight-gradient kernel: per stage of 32 rows the raw
// X^T tile [128 x 32] and Y^T tile [64 NBQ x 32] (two stages), then their
// hi and lo tiles, all in the 128-byte swizzle
template <int NBQ>
struct WgSmem {
  static constexpr uint32_t A = 128 * 32 * 4, B = NBQ * 64 * 32 * 4, STAGE = A + B;
  static constexpr uint32_t AH = 2 * STAGE, AL = AH + A, BH = AL + A, BL = BH + B, BYTES = BL + B + 1024;
};

// Block = 128 rows of C (two warpgroups of 64) by all of Q (<= 64 NBQ), over
// rows range blockIdx.y of the contraction; blockIdx.x < tiles0: g0's tiles,
// then g1's.
template <int NBQ>
__global__ void __launch_bounds__(WG_THREADS, 1)
ffn_tf32_wgrad_kernel(WG g0, WG g1, int tiles0, int mp, int range) {
  using L = WgSmem<NBQ>;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* sm;
  const uint32_t sa = aligned_smem(smem_raw, &sm);
  const bool first = (int)blockIdx.x < tiles0;
  const WG g = first ? g0 : g1;
  const int p0 = (first ? blockIdx.x : blockIdx.x - tiles0) * 128;
  const int k_begin = blockIdx.y * range, k_end = min(mp, k_begin + range), stages = (k_end - k_begin) / 32;
  const int wg = threadIdx.x / 128, warp = threadIdx.x / 32, lane = threadIdx.x % 32, t4 = lane & 3;

  // this thread's own 16-byte chunks of a stage: A's rows (4), B's (2 NBQ)
  auto copy = [&](int s, int buf) {
    const int k0 = k_begin + 32 * s;
    const uint32_t st = sa + buf * L::STAGE;
#pragma unroll
    for (int it = 0; it < 4; ++it) {
      const int i = it * WG_THREADS + threadIdx.x, r = i / 8, c = i % 8;
      const bool in = p0 + r < g.p;
      cp_async16(st + unit_offset(r, c), g.xt + (in ? (long long)(p0 + r) * mp + k0 + 4 * c : 0), in);
    }
#pragma unroll
    for (int it = 0; it < 2 * NBQ; ++it) {
      const int i = it * WG_THREADS + threadIdx.x, r = i / 8, c = i % 8;
      const bool in = r < g.q;
      cp_async16(st + L::A + unit_offset(r, c), g.yt + (in ? (long long)r * mp + k0 + 4 * c : 0), in);
    }
  };
  auto split = [&](int buf) {  // (a few chunks in flight: the accumulators hold most registers)
    const unsigned char* st = sm + buf * L::STAGE;
#pragma unroll 2
    for (int it = 0; it < 4; ++it) {
      const int i = it * WG_THREADS + threadIdx.x;
      const uint32_t off = unit_offset(i / 8, i % 8);
      uint4 hi, lo;
      split_tf32(*reinterpret_cast<const float4*>(st + off), hi, lo);
      *reinterpret_cast<uint4*>(sm + L::AH + off) = hi;
      *reinterpret_cast<uint4*>(sm + L::AL + off) = lo;
    }
#pragma unroll 2
    for (int it = 0; it < 2 * NBQ; ++it) {
      const int i = it * WG_THREADS + threadIdx.x;
      const uint32_t off = unit_offset(i / 8, i % 8);
      uint4 hi, lo;
      split_tf32(*reinterpret_cast<const float4*>(st + L::A + off), hi, lo);
      *reinterpret_cast<uint4*>(sm + L::BH + off) = hi;
      *reinterpret_cast<uint4*>(sm + L::BL + off) = lo;
    }
  };

  float acc[NBQ][32];
#pragma unroll
  for (int cb = 0; cb < NBQ; ++cb)
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[cb][i] = 0.0f;

  if (stages > 0) copy(0, 0);
  cp_async_commit();
  if (stages > 1) copy(1, 1);
  cp_async_commit();
  for (int s = 0; s < stages; ++s) {
    cp_async_wait<1>();  // this thread's copies of stage s have landed
    __syncthreads();     // every warpgroup is done with the last stage's split tiles
    split(s & 1);
    if (s + 2 < stages) copy(s + 2, s & 1);
    cp_async_commit();
    fence_async_smem();
    __syncthreads();  // the split tiles are ready
    // (the tiles' addresses made opaque each stage: the compiler would keep
    // every descriptor of every column block live across the loop)
    uint32_t a = sa + L::AH + wg * 64 * 128, bt = sa + L::BH;
    asm volatile("" : "+r"(a), "+r"(bt));
#pragma unroll
    for (int cb = 0; cb < NBQ; ++cb) {
      float t[32];
#pragma unroll
      for (int i = 0; i < 32; ++i) t[i] = 0.0f;
      const uint32_t b = bt + cb * 64 * 128;
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        mma3_ss<64>(t, unit_desc(a, kk), unit_desc(a + (L::AL - L::AH), kk), unit_desc(b, kk),
                    unit_desc(b + (L::BL - L::BH), kk));
      wgmma_commit();
      wgmma_wait_all();
      keep(t);
#pragma unroll
      for (int i = 0; i < 32; ++i) acc[cb][i] += t[i];
    }
  }

  float* part = g.part + (long long)blockIdx.y * g.p * g.q;
  const int rr = p0 + wg * 64 + (warp % 4) * 16 + lane / 4;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = rr + 8 * h;
    if (r >= g.p) continue;
#pragma unroll
    for (int cb = 0; cb < NBQ; ++cb)
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int q = cb * 64 + 8 * j + 2 * t4 + e;
          if (q >= g.q) continue;
          part[g.trans ? (long long)q * g.p + r : (long long)r * g.q + q] = acc[cb][4 * j + 2 * h + e];
        }
  }
}

template <int MODE, int NB>
static cudaError_t launch_bwd_rows(const Plan& p, const float* x, const float* gamma, const float* b_in,
                                   const float* dy, float* dx, float* sc, const BwdScratch& s, int m,
                                   cudaStream_t stream) {
  static std::atomic<unsigned> ready{0};
  auto kernel = ffn_tf32_bwd_rows_kernel<MODE, NB>;
  cudaError_t err = allow_smem((const void*)kernel, MAX_SMEM, ready);
  if (err != cudaSuccess) return err;
  kernel<<<s.blocks, NT, bwd_smem(p.d, p.d_out).bytes, stream>>>(p, x, gamma, b_in, dy, sc + s.units, dx, sc + s.ht,
                                                                  sc + s.at, sc + s.xt, sc + s.dyt, sc + s.vec0,
                                                                  sc + s.vec1, m, s.mp);
  return cudaGetLastError();
}

template <int NBQ>
static cudaError_t launch_wgrad(const WG& g0, const WG& g1, const BwdScratch& s, cudaStream_t stream) {
  static std::atomic<unsigned> ready{0};
  auto kernel = ffn_tf32_wgrad_kernel<NBQ>;
  cudaError_t err = allow_smem((const void*)kernel, WgSmem<NBQ>::BYTES, ready);
  if (err != cudaSuccess) return err;
  kernel<<<dim3(s.tiles0 + s.tiles1, s.splits), WG_THREADS, WgSmem<NBQ>::BYTES, stream>>>(g0, g1, s.tiles0, s.mp,
                                                                                          s.range);
  return cudaGetLastError();
}

// One backward: the split of the weights, the row pass, the weight
// gradients, the reduction (4 launches). GEGLU: dW_in = du^T xn, dW_out =
// (a^T dy)^T, dgamma; MLP: dW1 = dh^T x, dW2 = (a^T dy)^T, db1, db2. sc:
// bwd_scratch(...).floats floats.
template <int MODE>
static cudaError_t backward(const float* x, const float* gamma, const float* w_in, const float* b_in,
                            const float* w_out, const float* dy, float* dx, float* dw_in, float* dw_out, float* dv0,
                            float* dv1, float* sc, int m, int d, int hid, int d_out, cudaStream_t stream) {
  const Plan p = plan_of(MODE, true, d, hid, d_out);
  const BwdScratch s = bwd_scratch(MODE, m, d, hid, d_out);
  cudaError_t err = split_weights(p, w_in, w_out, sc + s.units, 1, stream);
  if (err != cudaSuccess) return err;
  switch (p.NB) {
    case 1: err = launch_bwd_rows<MODE, 1>(p, x, gamma, b_in, dy, dx, sc, s, m, stream); break;
    case 2: err = launch_bwd_rows<MODE, 2>(p, x, gamma, b_in, dy, dx, sc, s, m, stream); break;
    case 3: err = launch_bwd_rows<MODE, 3>(p, x, gamma, b_in, dy, dx, sc, s, m, stream); break;
    default: err = launch_bwd_rows<MODE, 4>(p, x, gamma, b_in, dy, dx, sc, s, m, stream); break;
  }
  if (err != cudaSuccess) return err;
  const int p0 = MODE == MODE_GEGLU ? 2 * hid : hid;
  const WG g0{sc + s.ht, sc + s.xt, sc + s.part0, p0, d, 0};            // dW_in (dW1) [p0, d]
  const WG g1{sc + s.at, sc + s.dyt, sc + s.part1, hid, d_out, 1};      // dW_out (dW2) [d_out, hid]
  const int q = d > d_out ? d : d_out;
  switch ((q + 63) / 64) {
    case 1: err = launch_wgrad<1>(g0, g1, s, stream); break;
    case 2: err = launch_wgrad<2>(g0, g1, s, stream); break;
    case 3: err = launch_wgrad<3>(g0, g1, s, stream); break;
    default: err = launch_wgrad<4>(g0, g1, s, stream); break;
  }
  if (err != cudaSuccess) return err;
  simt_f32::Segments segs{{{sc + s.part0, s.splits, (long long)p0 * d, dw_in},
                           {sc + s.part1, s.splits, (long long)hid * d_out, dw_out},
                           {sc + s.vec0, s.blocks, MODE == MODE_GEGLU ? d : hid, dv0},
                           {sc + s.vec1, s.blocks, d_out, dv1}},
                          MODE == MODE_GEGLU ? 3 : 4};
  return simt_f32::reduce(segs, stream);
}

}  // namespace ffn_tf32
