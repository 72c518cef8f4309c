// K4 and K4b (below): ms_deform_attn forward and backward.
//
// K4, the forward -- multi-scale deformable attention: for each
// (batch, query, head), bilinear samples of the head's value maps at L * P
// locations (zero padding, align_corners=False: pixel x = loc_x * W - 0.5),
// weighted by the attention weights and summed over all levels and points.
//
// Replaces the Pallas TPU kernel ops/pallas_msda.py _fwd_kernel (pallas_call
// in _msda_level_fwd) of the JAX package, which the MSDeformAttn pixel
// decoder runs. The TPU design (a hat-weight matrix against the whole level
// on the MXU, one call per level, queries padded to a common tile) exists
// because the TPU has no gather. Hopper has one, so this kernel is the direct
// gather of the reference's CUDA extension (ms_deform_im2col): four corner
// taps per sample, all levels in one launch, with the level shapes and start
// offsets passed by value.
//
// Layouts are those the module produces, with no transposes:
//   value [B, S, M, D] f32 (straight from value_proj), S = sum_l H_l * W_l,
//         levels low -> high resolution;
//   loc   [B, Lq, M, L, P, 2] f32, (x, y) in [0, 1] for in-range samples;
//   aw    [B, Lq, M, L, P] f32;
//   out   [B, Lq, M * D] f32.
// Everything is f32 (the pixel decoder runs in f32, pixel_decoder.py:90),
// so kernel and plain version differ only in the order of the sums.
//
// What bounds it on an H100: per sample and channel it does about 10 flops
// on 4 gathered values, so it is bound by bytes. The operands (value, loc,
// aw and out, each moved once) are the floor, but the gathers move more:
// every value row is read by each query that samples near it, one 128-byte
// row per tap (D = 32), about 2 GB at B = 30 against 129 MB of operands.
// Gathered from L2, that traffic runs at about what L2 delivers (0.40 ms at
// B = 30 on an H100), so the gathers read shared memory instead:
//   * a block stages the value rows of one (batch, head) slice,
//     value[b, :, m, :], in shared memory by 16-byte cp.async copies: all
//     S x D x 4 = 172,032 bytes at the pixel decoder's levels 8^2, 16^2 and
//     32^2 (62 MB staged at B = 30, restaging included, instead of 2 GB
//     gathered from L2); where
//     a slice does not fit (a 512^2 input, D = 64), the positions that fit,
//     coarse levels first, are staged and the taps past them are gathered
//     from global memory;
//   * the grid is persistent, a block an SM: block i takes the i-th of
//     equal ranges of the (slice, query) items in that order, restaging
//     where its range enters a new slice, so the blocks finish together at
//     any B (B = 1: 8 slices, each staged by about 16 blocks);
//   * a warp works as CPL = 4 groups of 8 lanes, each group one query (four
//     queries in flight a warp), each lane 4 channels by 16-byte loads
//     (where dim is a multiple of 4 and value and out start on 16 bytes;
//     else a group of 32 lanes, a channel a lane): a tap is one 128-byte
//     row of shared memory read by one group, conflict-free;
//   * a group's lanes first prepare one sample each (its four taps'
//     positions and weights, the attention weight folded in, from one load
//     of its location and weight), then the group walks its query's
//     samples, taking each one's taps from the lane that prepared it by
//     shuffles: where the whole slice is staged, every position is under
//     2^16 and two positions share a shuffle, six shuffles a sample, and
//     the group's lanes do no arithmetic on a sample but its sum (passing
//     the base position, flags and offsets instead and rebuilding the taps
//     in every lane took twice the instructions). A tap outside its level
//     reads position 0 with weight 0, so every load is unconditional;
//   * each output element is written once, by the group of its query, its
//     sum taken in a fixed order: no atomics, and the output is bitwise the
//     same from run to run.
// The floor of this design is shared-memory bandwidth: the same 2 GB at
// 128 bytes a clock an SM, about 0.07 ms at B = 30. It does not bind yet:
// on an H100, builds without the shared-memory reads or without the
// shuffles (wrong outputs, timed by tools/bench_msda_bwd.py --forward) ran
// only 12% and 18% faster, and one that staged each block's first slice
// only, 9%.
#include <cuda_runtime.h>

#include <atomic>
#include <cstdint>

#include "hopper.cuh"

namespace {

constexpr int MAX_LEVELS = 16;
constexpr int MAX_SMEM = 232448;   // a block's shared memory on sm_90 (227 KB)
constexpr int FWD_THREADS = 1024;  // 32 warps: a block an SM, and its gathers' latency needs them
constexpr int MIN_BLOCK_QUERIES = 64;  // K4: the least (slice, query) items worth a block
constexpr unsigned FULL = 0xffffffffu;

struct Levels {
  int n;
  int h[MAX_LEVELS];
  int w[MAX_LEVELS];
  int start[MAX_LEVELS];
};

// the pixel coordinate of a location in [0, 1] on an axis of ``size``
// pixels, loc * size - 0.5, rounded step by step as the plain version
// computes it (((2 loc - 1 + 1) size - 1) / 2, ops/msda.py:76-79): at a
// pixel edge the bilinear derivative is one-sided, and the same rounding
// puts kernel and plain version on the same side
__device__ __forceinline__ float pixel_of(float loc, int size) {
  const float g = __fadd_rn(__fsub_rn(__fmul_rn(2.0f, loc), 1.0f), 1.0f);
  return __fmul_rn(__fsub_rn(__fmul_rn(g, (float)size), 1.0f), 0.5f);
}

// CPL channels of a row into registers (one 16-byte load for 4)
template <int CPL>
__device__ __forceinline__ void load_row(const float* p, float (&v)[CPL]) {
  if constexpr (CPL == 4) {
    const float4 t = *reinterpret_cast<const float4*>(p);
    v[0] = t.x;
    v[1] = t.y;
    v[2] = t.z;
    v[3] = t.w;
  } else {
    v[0] = *p;
  }
}

// The positions of a (batch, head) slice whose value rows K4 stages in
// shared memory: the first ones (the coarse levels), all where they fit
int staged_positions(int s, int dim) {
  const int fit = MAX_SMEM / (dim * (int)sizeof(float));
  return s < fit ? s : fit;
}

// K4. The items are the (slice, query) pairs, slice = b * heads + m, in that
// order; block i takes the i-th of gridDim.x equal ranges of them. For each
// slice its range enters, the block stages the slice's positions [0, s_v)
// (a row of dim floats each) and its warps then take the range's queries
// of the slice, CPL queries a warp: a group of LPG = 32 / CPL lanes a
// query, a lane CPL channels of each 32-channel pass. CPL: 4 for 16-byte
// loads, else 1. ALL: the whole slice is staged (s_v == s), so every tap
// reads shared memory.
template <int CPL, bool ALL>
__global__ void __launch_bounds__(FWD_THREADS, 1)
ms_deform_attn_fwd_kernel(const float* __restrict__ value, const float* __restrict__ loc,
                          const float* __restrict__ aw, float* __restrict__ out, long long items, int s, int lq,
                          int heads, int dim, int points, Levels lv, int s_v) {
  constexpr int LPG = 32 / CPL;  // lanes a group: LPG * CPL = 32 channels a pass
  constexpr int WARPS = FWD_THREADS / 32;
  extern __shared__ __align__(16) float sv[];  // [s_v][dim]: the slice's value rows
  // the warp index taken from lane 0 by a shuffle: the compiler then knows
  // it is the same across the warp, and so are the query loop's bounds, and
  // compiles the shuffles inside for a converged warp (3% faster at B = 30
  // on an H100)
  const int lane = threadIdx.x % 32, warp = __shfl_sync(FULL, (int)threadIdx.x / 32, 0);
  const int grp = lane / LPG, gl = lane % LPG;
  const int samples = lv.n * points;
  const int pos_stride = heads * dim;  // one spatial position of value
  const long long g1 = items * (blockIdx.x + 1) / gridDim.x;
  for (long long g = items * blockIdx.x / gridDim.x; g < g1;) {
    const int slice = (int)(g / lq);
    const int b = slice / heads, m = slice % heads;
    const int qa = (int)(g - (long long)slice * lq);
    const int qb = (int)min((long long)lq, qa + (g1 - g));
    const float* vs = value + (long long)b * s * pos_stride + (long long)m * dim;
    if (s_v > 0) {
      __syncthreads();  // every warp is done with the previous slice's rows
      if constexpr (CPL == 4) {
        const int chunks = dim / 4;  // 16-byte chunks a row
        for (int i = threadIdx.x; i < s_v * chunks; i += FWD_THREADS) {
          const int p = i / chunks, c = (i - p * chunks) * 4;
          hopper::cp_async16(hopper::smem_addr(sv + p * dim + c), vs + (long long)p * pos_stride + c, true);
        }
      } else {
        for (int i = threadIdx.x; i < s_v * dim; i += FWD_THREADS) {
          const int p = i / dim;
          hopper::cp_async4(hopper::smem_addr(sv + i), vs + (long long)p * pos_stride + (i - p * dim), true);
        }
      }
      hopper::cp_async_commit();
      hopper::cp_async_wait_all();
      __syncthreads();
    }
    for (int q0 = qa + warp * CPL; q0 < qb; q0 += WARPS * CPL) {
      const int q = q0 + grp;
      const bool live = q < qb;  // a group past the range computes q0's query and writes nothing
      const long long row = ((long long)b * lq + (live ? q : q0)) * heads + m;
      for (int d0 = 0; d0 < dim; d0 += 32) {
        const int d = d0 + gl * CPL;
        const bool in_dim = d < dim;  // dim is a multiple of CPL: a lane's channels are all in or all out
        float acc[CPL];
#pragma unroll
        for (int c = 0; c < CPL; ++c) acc[c] = 0.0f;
        for (int c0 = 0; c0 < samples; c0 += LPG) {
          // lane gl prepares sample c0 + gl of its group's query: its taps'
          // positions and weights, the attention weight folded in; a tap
          // outside its level reads position 0 with weight 0 (and a sample
          // with all four taps outside keeps zeros; the test also keeps the
          // integer conversions in range)
          int pos[4] = {0, 0, 0, 0};
          float wt[4] = {0.0f, 0.0f, 0.0f, 0.0f};
          const int i = c0 + gl;
          if (i < samples) {
            const int l = i / points, h = lv.h[l], w = lv.w[l];
            const float px = pixel_of(loc[(row * samples + i) * 2], w);
            const float py = pixel_of(loc[(row * samples + i) * 2 + 1], h);
            if (px >= -1.0f && py >= -1.0f && px < (float)w && py < (float)h) {
              const float a = aw[row * samples + i];
              const float x0f = floorf(px), y0f = floorf(py);
              const float dx = px - x0f, dy = py - y0f;
              const int x0 = (int)x0f, y0 = (int)y0f;
              const int base = lv.start[l] + y0 * w + x0;
              const bool xin0 = x0 >= 0, xin1 = x0 + 1 < w, yin0 = y0 >= 0, yin1 = y0 + 1 < h;
              if (yin0 && xin0) { pos[0] = base;         wt[0] = a * ((1.0f - dy) * (1.0f - dx)); }
              if (yin0 && xin1) { pos[1] = base + 1;     wt[1] = a * ((1.0f - dy) * dx); }
              if (yin1 && xin0) { pos[2] = base + w;     wt[2] = a * (dy * (1.0f - dx)); }
              if (yin1 && xin1) { pos[3] = base + w + 1; wt[3] = a * (dy * dx); }
            }
          }
          // with the whole slice staged every position is under 2^16
          // (MAX_SMEM / 4 bytes), so two shuffles carry the four positions
          const unsigned p01 = (unsigned)pos[0] | (unsigned)pos[1] << 16;
          const unsigned p23 = (unsigned)pos[2] | (unsigned)pos[3] << 16;
          const int n = min(LPG, samples - c0);
#pragma unroll 4
          for (int j = 0; j < n; ++j) {
            // sample c0 + j of the group's query, from the lane that prepared it
            const int src = grp * LPG + j;
            int tp[4];
            float tw[4];
            if constexpr (ALL) {
              const unsigned a = __shfl_sync(FULL, p01, src), b = __shfl_sync(FULL, p23, src);
              tp[0] = (int)(a & 0xffffu);
              tp[1] = (int)(a >> 16);
              tp[2] = (int)(b & 0xffffu);
              tp[3] = (int)(b >> 16);
            } else {
#pragma unroll
              for (int t = 0; t < 4; ++t) tp[t] = __shfl_sync(FULL, pos[t], src);
            }
#pragma unroll
            for (int t = 0; t < 4; ++t) tw[t] = __shfl_sync(FULL, wt[t], src);
            if (in_dim) {
              // the four taps first (independent loads), then their sum
              float v[4][CPL];
#pragma unroll
              for (int t = 0; t < 4; ++t) {
                if (ALL || tp[t] < s_v)
                  load_row<CPL>(sv + tp[t] * dim + d, v[t]);
                else
                  load_row<CPL>(vs + (long long)tp[t] * pos_stride + d, v[t]);
              }
#pragma unroll
              for (int c = 0; c < CPL; ++c) {
                float x = 0.0f;
#pragma unroll
                for (int t = 0; t < 4; ++t) x += tw[t] * v[t][c];
                acc[c] += x;
              }
            }
          }
        }
        if (live && in_dim) {
          if constexpr (CPL == 4)
            *reinterpret_cast<float4*>(out + row * dim + d) = make_float4(acc[0], acc[1], acc[2], acc[3]);
          else
            out[row * dim + d] = acc[0];
        }
      }
    }
    g += qb - qa;
  }
}

// K4b: the gradient of K4's function. Replaces the Pallas TPU kernel
// ops/pallas_msda.py _bwd_kernel (pallas_call in _msda_level_bwd), whose
// per-level hat matmuls exist only because the TPU has no gather; this is
// the reference's ms_deform_attn_col2im instead: per sample, the four taps
// gathered exactly as the forward gathers them, and from them
//   daw     = sum_t w_t <v_t, g>                       (g = dOut of the head)
//   dloc_x  = aw * W * sum_t dw_t/dpx <v_t, g>, dloc_y likewise with H,
//   dV[t]  += aw * w_t * g
// with w_t the bilinear weight of tap t (0 outside the level). The channel
// sums <., g> are reductions over the lanes that hold the sample's channels
// (a wider D strides them over 32-channel passes and sums the passes first).
//
// What bounds it on an H100: the operands (value, loc, aw, dOut read once;
// dV, dloc, daw written once, 217 MB at B = 30) set a 0.065 ms floor. The
// first design, a warp per (query, head) walking its samples one at a time
// with every lane on one channel, added every tap's 32 channels into dV in
// device memory (red.global.add.f32, about 495 M at B = 30, piled on the
// coarse rows: the 8^2 level takes 336 tap-adds per position and head,
// against about 21 on the 32^2 level) and took 1.16 ms. Here:
//   * a block owns one (batch, head) slice: dV of its positions [0, s_dv)
//     (whole levels, coarse first: all of S x D x 4 = 172,032 bytes at the
//     pixel decoder's levels 8^2, 16^2, 32^2) in shared memory, summed
//     there, then written once with coalesced rows, so no global atomics
//     and no zeroed dV;
//   * a warp still takes one query: lane j prepares sample j's taps, then
//     the lanes work as CPL = 4 groups of 8, each group one sample, each
//     lane 4 channels by 16-byte loads (where dim is a multiple of 4 and
//     value and dOut are 16-byte aligned): four samples in flight a warp,
//     the channel sums over 8 lanes (the first design's walk was bound by
//     its instructions and their latency, not by its atomics);
//   * the dV adds go one tap row at a time, lane c on channel c, the row
//     and aw * w_t broadcast from the sample's group: sm_90 has no
//     shared-memory f32 add instruction (atomicAdd becomes an
//     ATOMS.CAST.SPIN compare-and-swap loop), and such a loop costs more
//     the more rows one instruction touches, so each covers one row (on
//     an H100, builds without these adds or without the value gathers,
//     timed by tools/bench_msda_bwd.py, were only 10% and 5% faster: the
//     time is spread over each sample's whole chain of work);
//   * where the (batch, head) slices are fewer than the SMs (B = 1: 8
//     slices), a slice's queries are split over `splits` blocks, each
//     writing its partial slice to a scratch, and a second launch sums the
//     partials in a fixed order and writes dV;
//   * levels past the shared memory (never at the pixel decoder's shapes)
//     keep f32 atomics into dV, whose rows the launcher zeroes first.
// The order of the shared-memory adds varies from run to run, so dV's sums
// vary in the last bits with it.
constexpr int BWD_THREADS = 1024;  // 32 warps: the gathers' latency needs them, and one block fills an SM
constexpr int MIN_SPLIT_QUERIES = 32;  // a split's queries: at least one a warp

// How the backward runs for a shape: the positions of a slice whose dV
// sits in shared memory (s_dv), blocks per slice, the dynamic shared
// memory, and the partial slices' scratch in floats
struct BwdPlan {
  int s_dv, splits;
  size_t smem;
  long long scratch;
};

BwdPlan plan_bwd(const Levels& lv, int batch, int lq, int heads, int dim) {
  const size_t row = (size_t)dim * sizeof(float);
  BwdPlan p{0, 1, 0, 0};
  for (int l = 0; l < lv.n && (p.s_dv + lv.h[l] * lv.w[l]) * row <= (size_t)MAX_SMEM; ++l)
    p.s_dv += lv.h[l] * lv.w[l];
  p.smem = (size_t)p.s_dv * row;
  const int slices = batch * heads, sms = hopper::sm_count();
  if (slices < sms && p.s_dv > 0) {
    p.splits = sms / slices;
    const int by_queries = (lq + MIN_SPLIT_QUERIES - 1) / MIN_SPLIT_QUERIES;
    p.splits = p.splits < by_queries ? p.splits : by_queries;
    p.splits = p.splits < 1 ? 1 : p.splits;
  }
  p.scratch = p.splits > 1 ? (long long)p.splits * slices * p.s_dv * dim : 0;
  return p;
}

// block = (slice, split), slice = b * heads + m; queries [q0, q1) of the
// split, a warp a query. CPL: channels a lane (4 for 16-byte loads, else
// 1). Lane j first prepares sample j of the query (its taps, from one load
// of its location and weight), then the warp's lanes form CPL groups of
// LPG = 32 / CPL lanes, and each group takes one prepared sample at a time
// (CPL samples in flight a warp), a lane CPL channels of its 32-channel
// pass; the dV adds go a row at a time, a lane a channel.
template <int CPL>
__global__ void __launch_bounds__(BWD_THREADS, 1)
ms_deform_attn_bwd_kernel(const float* __restrict__ value, const float* __restrict__ loc,
                          const float* __restrict__ aw, const float* __restrict__ dout,
                          float* __restrict__ dvalue, float* __restrict__ dloc, float* __restrict__ daw,
                          float* __restrict__ partial, int s, int lq, int heads, int dim, int points, Levels lv,
                          int s_dv, int splits) {
  constexpr int LPG = 32 / CPL;  // lanes a group: LPG * CPL = 32 channels a pass
  extern __shared__ float sdv[];  // [s_dv][dim]: this slice's dV sums
  const int slice = blockIdx.x / splits, split = blockIdx.x % splits;
  const int b = slice / heads, m = slice % heads;
  const int qps = (lq + splits - 1) / splits;
  const int q0 = split * qps, q1 = min(lq, q0 + qps);
  const int pos_stride = heads * dim;
  const long long vbase = (long long)b * s * pos_stride + (long long)m * dim;
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  constexpr int WARPS = BWD_THREADS / 32;
  for (int i = threadIdx.x; i < s_dv * dim; i += BWD_THREADS) sdv[i] = 0.0f;
  __syncthreads();

  const int grp = lane / LPG, gl = lane % LPG;
  const int samples = lv.n * points;
  for (int q = q0 + warp; q < q1; q += WARPS) {
    const long long row = ((long long)b * lq + q) * heads + m;
    for (int c0 = 0; c0 < samples; c0 += 32) {
      // lane j prepares sample c0 + j: its first tap's position, its level's
      // width, the in-level flags of its four taps, its attention weight and
      // fractional pixel offsets; a sample with all four taps outside its
      // level keeps zeros (the test also keeps the integer conversions in range)
      int my_base = 0, my_w = 1, my_in = 0;
      float my_a = 0.0f, my_fx = 0.0f, my_fy = 0.0f;
      if (c0 + lane < samples) {
        const int smp = c0 + lane, l = smp / points;
        const int h = lv.h[l];
        my_w = lv.w[l];
        const float a = aw[row * samples + smp];
        const float px = pixel_of(loc[(row * samples + smp) * 2], my_w);
        const float py = pixel_of(loc[(row * samples + smp) * 2 + 1], h);
        if (px >= -1.0f && py >= -1.0f && px < (float)my_w && py < (float)h) {
          my_a = a;
          const float x0f = floorf(px), y0f = floorf(py);
          my_fx = px - x0f;
          my_fy = py - y0f;
          const int x0 = (int)x0f, y0 = (int)y0f;
          const bool xin0 = x0 >= 0, xin1 = x0 + 1 < my_w, yin0 = y0 >= 0, yin1 = y0 + 1 < h;
          my_in = (yin0 && xin0) | (yin0 && xin1) << 1 | (yin1 && xin0) << 2 | (yin1 && xin1) << 3;
          my_base = lv.start[l] + y0 * my_w + x0;
        }
      }
      const int n = min(32, samples - c0);
      for (int s0 = 0; s0 < n; s0 += CPL) {
        // this group's sample, from the lane that prepared it
        const int src = s0 + grp;
        const int base = __shfl_sync(FULL, my_base, src), w = __shfl_sync(FULL, my_w, src);
        const int inm = __shfl_sync(FULL, my_in, src);
        const float a = __shfl_sync(FULL, my_a, src), fx = __shfl_sync(FULL, my_fx, src);
        const float fy = __shfl_sync(FULL, my_fy, src);
        const bool in[4] = {(inm & 1) != 0, (inm & 2) != 0, (inm & 4) != 0, (inm & 8) != 0};
        const int pos[4] = {base, base + 1, base + w, base + w + 1};
        // the bilinear weights and their derivatives in px and py, per tap
        const float wt[4] = {(1.0f - fy) * (1.0f - fx), (1.0f - fy) * fx, fy * (1.0f - fx), fy * fx};
        const float gx[4] = {-(1.0f - fy), 1.0f - fy, -fy, fy};
        const float gy[4] = {-(1.0f - fx), -fx, 1.0f - fx, fx};
        float s_aw = 0.0f, s_x = 0.0f, s_y = 0.0f;
        for (int d0 = 0; d0 < dim; d0 += 32) {
          const int d = d0 + gl * CPL;
          if (d < dim) {  // dim is a multiple of CPL: the lane's channels are all in or all out
            float g[CPL], v[4][CPL];
            load_row<CPL>(dout + row * dim + d, g);
            // the four taps' values first (independent loads), then their sums
#pragma unroll
            for (int t = 0; t < 4; ++t) {
              if (in[t])
                load_row<CPL>(value + vbase + (long long)pos[t] * pos_stride + d, v[t]);
              else
#pragma unroll
                for (int c = 0; c < CPL; ++c) v[t][c] = 0.0f;
            }
#pragma unroll
            for (int t = 0; t < 4; ++t)
#pragma unroll
              for (int c = 0; c < CPL; ++c) {
                const float sv_t = v[t][c] * g[c];
                s_aw += wt[t] * sv_t;
                s_x += gx[t] * sv_t;
                s_y += gy[t] * sv_t;
              }
          }
          // dV: the CPL samples' taps one row at a time, lane c adding
          // aw * w_t * dOut[d0 + c] into channel d0 + c of the tap's row, so
          // every add instruction covers one contiguous row (shared-memory
          // float adds are compare-and-swap loops whose cost grows with the
          // rows an instruction touches)
          const int dc = d0 + lane;
          const float gc = dc < dim ? dout[row * dim + dc] : 0.0f;
#pragma unroll
          for (int i = 0; i < CPL; ++i)
#pragma unroll
            for (int t = 0; t < 4; ++t) {
              const float coef = __shfl_sync(FULL, a * wt[t], i * LPG);
              const int p = __shfl_sync(FULL, in[t] ? pos[t] : -1, i * LPG);
              if (p < 0 || dc >= dim) continue;
              if (p < s_dv)
                atomicAdd(sdv + p * dim + dc, coef * gc);
              else
                atomicAdd(dvalue + vbase + (long long)p * pos_stride + dc, coef * gc);
            }
        }
        // the channel sums over the group's lanes
#pragma unroll
        for (int o = LPG / 2; o > 0; o >>= 1) {
          s_aw += __shfl_xor_sync(FULL, s_aw, o);
          s_x += __shfl_xor_sync(FULL, s_x, o);
          s_y += __shfl_xor_sync(FULL, s_y, o);
        }
        const int smp = c0 + src;
        if (gl == 0 && src < n) {
          const int h = lv.h[smp / points];
          daw[row * samples + smp] = s_aw;
          dloc[(row * samples + smp) * 2] = a * (float)w * s_x;
          dloc[(row * samples + smp) * 2 + 1] = a * (float)h * s_y;
        }
      }
    }
  }
  __syncthreads();
  // the slice (or this split's partial of it) out, each element once: a
  // position's dim channels are one contiguous row in both layouts
  if (splits == 1) {
    for (int r = warp; r < s_dv; r += WARPS)
      for (int c = lane; c < dim; c += 32) dvalue[vbase + (long long)r * pos_stride + c] = sdv[r * dim + c];
  } else {
    const int slices = gridDim.x / splits;
    float* out = partial + ((long long)split * slices + slice) * s_dv * dim;
    for (int i = threadIdx.x; i < s_dv * dim; i += BWD_THREADS) out[i] = sdv[i];
  }
}

// dV of positions [0, s_dv), the splits' partial slices summed in order: a
// warp per row (b, p, m) of dvalue, a lane per channel
__global__ void ms_deform_attn_bwd_reduce_kernel(const float* __restrict__ partial, float* __restrict__ dvalue,
                                                 int batch, int s, int heads, int dim, int s_dv, int splits) {
  const long long rows = (long long)batch * s_dv * heads;
  const long long slice_floats = (long long)s_dv * dim, split_floats = (long long)batch * heads * slice_floats;
  const int lane = threadIdx.x % 32;
  for (long long r = ((long long)blockIdx.x * blockDim.x + threadIdx.x) / 32; r < rows;
       r += (long long)gridDim.x * blockDim.x / 32) {
    const int m = (int)(r % heads);
    const int p = (int)(r / heads % s_dv);
    const long long b = r / heads / s_dv;
    const float* src = partial + (b * heads + m) * slice_floats + (long long)p * dim;
    float* dst = dvalue + ((b * s + p) * heads + m) * dim;
    for (int c = lane; c < dim; c += 32) {
      float acc = 0.0f;
      for (int k = 0; k < splits; ++k) acc += src[k * split_floats + c];
      dst[c] = acc;
    }
  }
}

bool make_levels(int levels, const int* level_hw, int s, Levels* lv) {
  if (levels < 1 || levels > MAX_LEVELS) return false;
  lv->n = levels;
  int start = 0;
  for (int l = 0; l < levels; ++l) {
    lv->h[l] = level_hw[2 * l];
    lv->w[l] = level_hw[2 * l + 1];
    lv->start[l] = start;
    start += lv->h[l] * lv->w[l];
  }
  return start == s;
}

}  // namespace

// level_hw: host array [levels][2] of (H, W), low -> high resolution; the
// levels' start offsets are their running sums and must total s.
extern "C" int ms_deform_attn_fwd_f32(const float* value, const float* loc, const float* aw,
                                      float* out, int batch, int s, int lq, int heads, int dim,
                                      int levels, int points, const int* level_hw,
                                      cudaStream_t stream) {
  static std::atomic<unsigned> ready[4];  // per instantiation: [vec][all]
  Levels lv;
  if (batch < 1 || lq < 1 || heads < 1 || dim < 1 || points < 1 ||
      !make_levels(levels, level_hw, s, &lv))
    return (int)cudaErrorInvalidValue;
  // 16-byte copies, loads and stores where the channels and pointers allow them
  const bool vec = dim % 4 == 0 && (uintptr_t)value % 16 == 0 && (uintptr_t)out % 16 == 0;
  const int s_v = staged_positions(s, dim);
  const bool all = s_v == s;
  auto kernel = vec ? (all ? ms_deform_attn_fwd_kernel<4, true> : ms_deform_attn_fwd_kernel<4, false>)
                    : (all ? ms_deform_attn_fwd_kernel<1, true> : ms_deform_attn_fwd_kernel<1, false>);
  const cudaError_t err = hopper::allow_smem((const void*)kernel, MAX_SMEM, ready[vec * 2 + all]);
  if (err != cudaSuccess) return (int)err;
  // a persistent grid, a block an SM, or fewer where the items are few
  const long long items = (long long)batch * heads * lq, sms = hopper::sm_count();
  const long long wanted = (items + MIN_BLOCK_QUERIES - 1) / MIN_BLOCK_QUERIES;
  kernel<<<(unsigned)(wanted < sms ? wanted : sms), FWD_THREADS, (size_t)s_v * dim * sizeof(float), stream>>>(
      value, loc, aw, out, items, s, lq, heads, dim, points, lv, s_v);
  return (int)cudaGetLastError();
}

// The f32 scratch one backward needs for its partial slices, in floats (0
// where a block owns a whole slice); -1 for shapes the kernel does not take.
extern "C" long long ms_deform_attn_bwd_scratch_floats(int batch, int s, int lq, int heads, int dim, int levels,
                                                       int points, const int* level_hw) {
  Levels lv;
  if (batch < 1 || lq < 1 || heads < 1 || dim < 1 || points < 1 || !make_levels(levels, level_hw, s, &lv))
    return -1;
  return plan_bwd(lv, batch, lq, heads, dim).scratch;
}

// The gradients of ms_deform_attn_fwd_f32's output: dvalue [B, S, M, D]
// (written whole: nothing needs zeroing), dloc [B, Lq, M, L, P, 2] and daw
// [B, Lq, M, L, P], all f32; scratch: ms_deform_attn_bwd_scratch_floats
// floats (null when that is 0).
extern "C" int ms_deform_attn_bwd_f32(const float* value, const float* loc, const float* aw,
                                      const float* dout, float* dvalue, float* dloc, float* daw,
                                      float* scratch, int batch, int s, int lq, int heads, int dim,
                                      int levels, int points, const int* level_hw, cudaStream_t stream) {
  static std::atomic<unsigned> ready4{0}, ready1{0};
  Levels lv;
  if (batch < 1 || lq < 1 || heads < 1 || dim < 1 || points < 1 ||
      !make_levels(levels, level_hw, s, &lv))
    return (int)cudaErrorInvalidValue;
  const BwdPlan p = plan_bwd(lv, batch, lq, heads, dim);
  if (p.scratch > 0 && scratch == nullptr) return (int)cudaErrorInvalidValue;
  // 16-byte loads of value and dOut rows where their channels allow them
  const bool vec = dim % 4 == 0 && (uintptr_t)value % 16 == 0 && (uintptr_t)dout % 16 == 0;
  auto kernel = vec ? ms_deform_attn_bwd_kernel<4> : ms_deform_attn_bwd_kernel<1>;
  cudaError_t err = hopper::allow_smem((const void*)kernel, MAX_SMEM, vec ? ready4 : ready1);
  if (err != cudaSuccess) return (int)err;
  if (p.s_dv < s) {  // the levels past shared memory take atomics: zero their rows first
    const size_t row = (size_t)heads * dim * sizeof(float);
    err = cudaMemset2DAsync(dvalue + (long long)p.s_dv * heads * dim, s * row, 0, (s - p.s_dv) * row, batch,
                            stream);
    if (err != cudaSuccess) return (int)err;
  }
  kernel<<<batch * heads * p.splits, BWD_THREADS, p.smem, stream>>>(
      value, loc, aw, dout, dvalue, dloc, daw, scratch, s, lq, heads, dim, points, lv, p.s_dv, p.splits);
  err = cudaGetLastError();
  if (err != cudaSuccess || p.splits == 1) return (int)err;
  const long long blocks = ((long long)batch * p.s_dv * heads + 7) / 8;  // 8 warps a block, a warp a row
  ms_deform_attn_bwd_reduce_kernel<<<(unsigned)(blocks < 4096 ? blocks : 4096), 256, 0, stream>>>(
      scratch, dvalue, batch, s, heads, dim, p.s_dv, p.splits);
  return (int)cudaGetLastError();
}
