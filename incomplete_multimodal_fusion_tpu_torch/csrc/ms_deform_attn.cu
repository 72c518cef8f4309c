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
// row per tap (D = 32: lane d reads channel d; a wider D strides the lanes
// over channel chunks), about 2 GB between L2 and the SMs at B = 30 against
// 129 MB of operands. The design keeps everything else minimal: one warp per
// (b, q, m), the sum in a register, each output element written once. A
// sample's four gathers wait on its location, so the warp's lanes first
// prepare one sample each in parallel (lane j: sample j's tap positions and
// weights, the attention weight folded in, 0 for a tap outside its level,
// from one load per lane), then walk the samples, taking each one's taps
// from its lane by shuffles. A tap outside its level reads position 0 with
// weight 0, so every load is unconditional. No shared memory, no atomics.
#include <cuda_runtime.h>

namespace {

constexpr int MAX_LEVELS = 16;
constexpr int THREADS = 256;  // 8 warps a block
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

// one warp per (b, q, m): warp index = (b * Lq + q) * M + m
__global__ void ms_deform_attn_fwd_kernel(const float* __restrict__ value,
                                          const float* __restrict__ loc,
                                          const float* __restrict__ aw, float* __restrict__ out,
                                          long long rows, int s, int lq, int heads, int dim,
                                          int points, Levels lv) {
  const long long row = ((long long)blockIdx.x * blockDim.x + threadIdx.x) / 32;
  const int lane = threadIdx.x % 32;
  if (row >= rows) return;  // whole warps leave together
  const int m = (int)(row % heads);
  const long long b = row / heads / lq;
  const int samples = lv.n * points;
  const float* loc_row = loc + row * samples * 2;
  const float* aw_row = aw + row * samples;
  const int pos_stride = heads * dim;  // one spatial position of value
  const float* vbase = value + b * s * pos_stride + (long long)m * dim;
  float* orow = out + row * dim;

  for (int d0 = 0; d0 < dim; d0 += 32) {
    const int d = d0 + lane;
    const bool in_dim = d < dim;
    const float* vd = vbase + (in_dim ? d : 0);
    float acc = 0.0f;
    for (int c0 = 0; c0 < samples; c0 += 32) {
      // lane j prepares sample c0 + j: its taps' positions in the flattened
      // sequence and their weights
      int pos[4] = {0, 0, 0, 0};
      float wt[4] = {0.0f, 0.0f, 0.0f, 0.0f};
      const int i = c0 + lane;
      if (i < samples) {
        const int l = i / points;
        const int h = lv.h[l];
        const int w = lv.w[l];
        const float px = pixel_of(loc_row[2 * i], w);
        const float py = pixel_of(loc_row[2 * i + 1], h);
        // a sample with all four taps outside its level keeps weights 0
        // (the test also keeps the integer conversions in range; at
        // px = -1 exactly the tap at 0 is in, with weight 0 but a derivative)
        if (px >= -1.0f && py >= -1.0f && px < (float)w && py < (float)h) {
          const float a = aw_row[i];
          const float x0f = floorf(px);
          const float y0f = floorf(py);
          const float dx = px - x0f;
          const float dy = py - y0f;
          const int x0 = (int)x0f;
          const int y0 = (int)y0f;
          const int base = lv.start[l] + y0 * w + x0;
          const bool xin0 = x0 >= 0, xin1 = x0 + 1 < w;
          const bool yin0 = y0 >= 0, yin1 = y0 + 1 < h;
          if (yin0 && xin0) { pos[0] = base;         wt[0] = a * ((1.0f - dy) * (1.0f - dx)); }
          if (yin0 && xin1) { pos[1] = base + 1;     wt[1] = a * ((1.0f - dy) * dx); }
          if (yin1 && xin0) { pos[2] = base + w;     wt[2] = a * (dy * (1.0f - dx)); }
          if (yin1 && xin1) { pos[3] = base + w + 1; wt[3] = a * (dy * dx); }
        }
      }
      const int n = min(32, samples - c0);
#pragma unroll 4
      for (int j = 0; j < n; ++j) {
        float v = 0.0f;
#pragma unroll
        for (int t = 0; t < 4; ++t) {
          const int p = __shfl_sync(FULL, pos[t], j);
          const float c = __shfl_sync(FULL, wt[t], j);
          v += c * vd[(long long)p * pos_stride];
        }
        acc += v;
      }
    }
    if (in_dim) orow[d] = acc;
  }
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(FULL, v, o);
  return v;
}

// K4b: the gradient of K4's function. Replaces the Pallas TPU kernel
// ops/pallas_msda.py _bwd_kernel (pallas_call in _msda_level_bwd), whose
// per-level hat matmuls exist only because the TPU has no gather; this is
// the reference's ms_deform_attn_col2im instead: per sample, the four taps
// gathered exactly as the forward gathers them, and from them
//   daw     = sum_t w_t <v_t, g>                       (g = dOut of the head)
//   dloc_x  = aw * W * sum_t dw_t/dpx <v_t, g>, dloc_y likewise with H,
//   dV[t]  += aw * w_t * g                             (f32 atomics)
// with w_t the bilinear weight of tap t (0 outside the level). The channel
// sums <., g> are warp reductions (lane d holds channel d; a wider D strides
// the lanes over chunks and sums the chunks first).
//
// One warp per (b, q, m), as the forward. Lane j loads sample j's pixel
// position and attention weight (coalesced), the warp then walks the
// samples taking each one's from its lane by shuffles, every lane
// recomputing the taps, and lane j keeps sample j's three results for one
// coalesced write at the end.
//
// What bounds it on an H100: the operands (value, loc, aw, dOut read once;
// dV, dloc, daw written once, 217 MB at B = 30) set a 0.065 ms floor, but
// every tap of every sample adds its 32 channels into dV with a reduction
// (red.global.add.f32): 4 taps x 32 channels per sample, about 495 M at
// B = 30, many aimed at the same rows (the 8^2 level takes 336 samples per
// position and head), so the atomics' throughput in L2 sets its time. Their
// order varies from run to run; dV's sums vary in the last bits with it.
__global__ void ms_deform_attn_bwd_kernel(const float* __restrict__ value,
                                          const float* __restrict__ loc,
                                          const float* __restrict__ aw,
                                          const float* __restrict__ dout,
                                          float* __restrict__ dvalue, float* __restrict__ dloc,
                                          float* __restrict__ daw, long long rows, int s, int lq,
                                          int heads, int dim, int points, Levels lv) {
  const long long row = ((long long)blockIdx.x * blockDim.x + threadIdx.x) / 32;
  const int lane = threadIdx.x % 32;
  if (row >= rows) return;  // whole warps leave together
  const int m = (int)(row % heads);
  const long long b = row / heads / lq;
  const int samples = lv.n * points;
  const float* loc_row = loc + row * samples * 2;
  const float* aw_row = aw + row * samples;
  float* dloc_row = dloc + row * samples * 2;
  float* daw_row = daw + row * samples;
  const int pos_stride = heads * dim;
  const long long vbase = b * s * pos_stride + (long long)m * dim;
  const float* grow = dout + row * dim;

  for (int c0 = 0; c0 < samples; c0 += 32) {
    // lane j: sample c0 + j's pixel position and attention weight
    const int i = c0 + lane;
    float my_px = -2.0f, my_py = -2.0f, my_a = 0.0f;
    if (i < samples) {
      const int l = i / points;
      my_px = pixel_of(loc_row[2 * i], lv.w[l]);
      my_py = pixel_of(loc_row[2 * i + 1], lv.h[l]);
      my_a = aw_row[i];
    }
    float r_aw = 0.0f, r_x = 0.0f, r_y = 0.0f;  // lane j's sample's results
    const int n = min(32, samples - c0);
    for (int j = 0; j < n; ++j) {
      const float px = __shfl_sync(FULL, my_px, j);
      const float py = __shfl_sync(FULL, my_py, j);
      const float a = __shfl_sync(FULL, my_a, j);
      const int l = (c0 + j) / points;
      const int h = lv.h[l];
      const int w = lv.w[l];
      // a sample with all four taps outside its level has zero gradients
      // (the test also keeps the integer conversions in range)
      if (!(px >= -1.0f && py >= -1.0f && px < (float)w && py < (float)h)) continue;
      const float x0f = floorf(px);
      const float y0f = floorf(py);
      const float dx = px - x0f;
      const float dy = py - y0f;
      const int x0 = (int)x0f;
      const int y0 = (int)y0f;
      const bool xin0 = x0 >= 0, xin1 = x0 + 1 < w;
      const bool yin0 = y0 >= 0, yin1 = y0 + 1 < h;
      const bool in[4] = {yin0 && xin0, yin0 && xin1, yin1 && xin0, yin1 && xin1};
      const int base = lv.start[l] + y0 * w + x0;
      const int pos[4] = {base, base + 1, base + w, base + w + 1};
      // the bilinear weights and their derivatives in px and py, per tap
      const float wt[4] = {(1.0f - dy) * (1.0f - dx), (1.0f - dy) * dx, dy * (1.0f - dx), dy * dx};
      const float gx[4] = {-(1.0f - dy), 1.0f - dy, -dy, dy};
      const float gy[4] = {-(1.0f - dx), -dx, 1.0f - dx, dx};
      float s_aw = 0.0f, s_x = 0.0f, s_y = 0.0f;
      for (int d0 = 0; d0 < dim; d0 += 32) {
        const int d = d0 + lane;
        if (d >= dim) continue;
        const float g = grow[d];
#pragma unroll
        for (int t = 0; t < 4; ++t) {
          if (!in[t]) continue;
          const long long off = vbase + (long long)pos[t] * pos_stride + d;
          const float sv = value[off] * g;
          s_aw += wt[t] * sv;
          s_x += gx[t] * sv;
          s_y += gy[t] * sv;
          atomicAdd(dvalue + off, a * wt[t] * g);
        }
      }
      s_aw = warp_sum(s_aw);
      s_x = warp_sum(s_x);
      s_y = warp_sum(s_y);
      if (lane == j) {
        r_aw = s_aw;
        r_x = a * (float)w * s_x;
        r_y = a * (float)h * s_y;
      }
    }
    if (i < samples) {
      daw_row[i] = r_aw;
      dloc_row[2 * i] = r_x;
      dloc_row[2 * i + 1] = r_y;
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
  Levels lv;
  if (batch < 1 || lq < 1 || heads < 1 || dim < 1 || points < 1 ||
      !make_levels(levels, level_hw, s, &lv))
    return (int)cudaErrorInvalidValue;
  const long long rows = (long long)batch * lq * heads;
  const long long blocks = (rows * 32 + THREADS - 1) / THREADS;
  ms_deform_attn_fwd_kernel<<<(unsigned)blocks, THREADS, 0, stream>>>(
      value, loc, aw, out, rows, s, lq, heads, dim, points, lv);
  return (int)cudaGetLastError();
}

// The gradients of ms_deform_attn_fwd_f32's output: dvalue [B, S, M, D]
// (must be zeroed by the caller: the kernel adds into it), dloc
// [B, Lq, M, L, P, 2] and daw [B, Lq, M, L, P], all f32.
extern "C" int ms_deform_attn_bwd_f32(const float* value, const float* loc, const float* aw,
                                      const float* dout, float* dvalue, float* dloc, float* daw,
                                      int batch, int s, int lq, int heads, int dim, int levels,
                                      int points, const int* level_hw, cudaStream_t stream) {
  Levels lv;
  if (batch < 1 || lq < 1 || heads < 1 || dim < 1 || points < 1 ||
      !make_levels(levels, level_hw, s, &lv))
    return (int)cudaErrorInvalidValue;
  const long long rows = (long long)batch * lq * heads;
  const long long blocks = (rows * 32 + THREADS - 1) / THREADS;
  ms_deform_attn_bwd_kernel<<<(unsigned)blocks, THREADS, 0, stream>>>(
      value, loc, aw, dout, dvalue, dloc, daw, rows, s, lq, heads, dim, points, lv);
  return (int)cudaGetLastError();
}
