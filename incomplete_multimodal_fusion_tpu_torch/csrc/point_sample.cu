// K5 / K5b: PointRend point sampling -- bilinear samples of masks [N, H, W]
// at P points each (zero padding, align_corners=False: pixel
// x = coord_x * W - 0.5, y = coord_y * H - 0.5), the detectron2
// point_sample the Mask2Former criterion runs for its matcher and its mask
// losses, and its gradient.
//
// Replaces the Pallas TPU kernels ops/pallas_points.py _fwd_kernel
// (pallas_call in _sample_px_fwd) and _bwd_kernel (in _sample_px_bwd) of the
// JAX package. The TPU evaluates each sample as a separable hat-matrix
// product (M @ hat_x, then a weighted sum over rows), because the TPU has no
// gather; Hopper has one, so both kernels take the four taps directly.
//
// Layouts:
//   masks  [N, H, W] f32;
//   coords [N / group, P, 2] f32, (x, y): mask i reads coords row i / group,
//          so the matcher's 100 queries of one image share one row of points
//          and the [N, P, 2] broadcast is never materialized;
//   out    [N, P] f32;  dS [N, P] f32;  dmasks [N, H, W] f32;
//   dcoords [N, P, 2] f32 per mask (the wrapper sums each group).
//
// What bounds them on an H100: a sample is 4 loads and about 12 flops, so
// both are bound by bytes: coords, masks and the output moved once are
// 203 MB for the matcher's [3000, 64^2] at 12544 points (0.061 ms). K5 is
// one thread per (mask, point). The taps of a mask's points land all over
// its 16 KB, so a block of 256 points pulls nearly the whole mask from L2;
// with one block per 256 points that was 7 GB of L2 traffic for the
// matcher's shape (0.81 ms on an H100 at 700 W). So a mask that fits in 48 KB is
// staged once into shared memory by a block that then samples 2048 of its
// points from there (16 KB from L2 per 2048 points); a larger mask (the
// 256^2 targets) is read through L1/L2. Every load is unconditional: a tap
// outside the mask reads element 0 with weight 0.
//
// K5b scatters dS * w_tap into dmasks. A mask's gradient is small (64^2
// f32 = 16 KB on the loss path), so one block per mask holds it in shared
// memory, adds the taps there with shared-memory atomics and writes it once,
// plainly; coords and dS are read once (40 MB for [240, 64^2] at 12544
// points, 0.012 ms). Where [H, W] does not fit in a block's shared memory,
// blocks of points add straight into dmasks with global atomics (zeroed by
// the caller). dcoords, when asked for, comes from the same taps: the
// derivatives of the bilinear weights in x and y against the mask values.
#include <cuda_runtime.h>

namespace {

constexpr int FWD_THREADS = 256;
constexpr int FWD_CHUNK = 2048;            // points per block of the staged forward
constexpr int FWD_SMEM = 48 * 1024;        // the staged forward's mask bound
constexpr int BWD_THREADS = 512;
constexpr int MAX_SMEM = 232448;  // a block's shared memory on sm_90 (227 KB)

struct Taps {
  int idx[4];    // flattened pixel of each tap, 0 outside the mask
  float wt[4];   // bilinear weight, 0 outside
  float gx[4];   // d wt / d px, 0 outside
  float gy[4];   // d wt / d py, 0 outside
};

// the pixel coordinate of a coord in [0, 1] on an axis of ``size`` pixels,
// coord * size - 0.5, rounded step by step as the plain version computes it
// (((2 c - 1 + 1) size - 1) / 2, set_criterion.py:56-59): at a pixel edge the
// derivative in the coords is one-sided, and the same rounding puts kernel
// and plain version on the same side
__device__ __forceinline__ float pixel_of(float c, int size) {
  const float g = __fadd_rn(__fsub_rn(__fmul_rn(2.0f, c), 1.0f), 1.0f);
  return __fmul_rn(__fsub_rn(__fmul_rn(g, (float)size), 1.0f), 0.5f);
}

__device__ __forceinline__ Taps taps_of(float cx, float cy, int h, int w) {
  const float px = pixel_of(cx, w);
  const float py = pixel_of(cy, h);
  Taps t;
  // clamp before the integer conversion: a point far outside keeps its
  // taps outside (weight 0) and the conversion in range
  const float x0f = floorf(fminf(fmaxf(px, -2.0f), (float)w + 1.0f));
  const float y0f = floorf(fminf(fmaxf(py, -2.0f), (float)h + 1.0f));
  const float dx = px - x0f;
  const float dy = py - y0f;
  const int x0 = (int)x0f;
  const int y0 = (int)y0f;
  const bool xin0 = x0 >= 0 && x0 < w, xin1 = x0 + 1 >= 0 && x0 + 1 < w;
  const bool yin0 = y0 >= 0 && y0 < h, yin1 = y0 + 1 >= 0 && y0 + 1 < h;
  const bool in[4] = {yin0 && xin0, yin0 && xin1, yin1 && xin0, yin1 && xin1};
  const int idx[4] = {y0 * w + x0, y0 * w + x0 + 1, (y0 + 1) * w + x0, (y0 + 1) * w + x0 + 1};
  const float wt[4] = {(1.0f - dy) * (1.0f - dx), (1.0f - dy) * dx, dy * (1.0f - dx), dy * dx};
  const float gx[4] = {-(1.0f - dy), 1.0f - dy, -dy, dy};
  const float gy[4] = {-(1.0f - dx), -dx, 1.0f - dx, dx};
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    t.idx[k] = in[k] ? idx[k] : 0;
    t.wt[k] = in[k] ? wt[k] : 0.0f;
    t.gx[k] = in[k] ? gx[k] : 0.0f;
    t.gy[k] = in[k] ? gy[k] : 0.0f;
  }
  return t;
}

// grid (ceil(P / FWD_THREADS), N): thread = one point of one mask; the
// blocks of one mask run together, so its taps stay in L2 (240 masks of
// 256^2 f32 are 63 MB, more than the 50 MB of L2)
__global__ void point_sample_fwd_kernel(const float* __restrict__ masks,
                                        const float* __restrict__ coords,
                                        float* __restrict__ out, int p, int h, int w,
                                        int group) {
  const int n = blockIdx.y;
  const int j = blockIdx.x * blockDim.x + threadIdx.x;
  if (j >= p) return;
  const float* c = coords + ((long long)(n / group) * p + j) * 2;
  const Taps t = taps_of(c[0], c[1], h, w);
  const float* m = masks + (long long)n * h * w;
  float v = 0.0f;
#pragma unroll
  for (int k = 0; k < 4; ++k) v += t.wt[k] * m[t.idx[k]];
  out[(long long)n * p + j] = v;
}

// grid (N, ceil(P / FWD_CHUNK)): the mask staged in shared memory, then
// FWD_CHUNK of its points sampled from there
__global__ void point_sample_fwd_smem_kernel(const float* __restrict__ masks,
                                             const float* __restrict__ coords,
                                             float* __restrict__ out, int p, int h, int w,
                                             int group) {
  extern __shared__ float tile[];
  const int n = blockIdx.x;
  const int hw = h * w;
  const float* m = masks + (long long)n * hw;
  for (int i = threadIdx.x; i < hw; i += blockDim.x) tile[i] = m[i];
  __syncthreads();
  const float* crow = coords + (long long)(n / group) * p * 2;
  float* orow = out + (long long)n * p;
  const int start = (int)blockIdx.y * FWD_CHUNK;
  const int end = min(p, start + FWD_CHUNK);
  for (int j = start + (int)threadIdx.x; j < end; j += blockDim.x) {
    const Taps t = taps_of(crow[2 * j], crow[2 * j + 1], h, w);
    float v = 0.0f;
#pragma unroll
    for (int k = 0; k < 4; ++k) v += t.wt[k] * tile[t.idx[k]];
    orow[j] = v;
  }
}

// dcoords of one (mask, point): the weight derivatives against the taps
__device__ __forceinline__ void write_dcoords(const Taps& t, const float* m, float ds, int h,
                                              int w, float* dc) {
  float sx = 0.0f, sy = 0.0f;
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const float v = m[t.idx[k]];
    sx += t.gx[k] * v;
    sy += t.gy[k] * v;
  }
  dc[0] = ds * (float)w * sx;
  dc[1] = ds * (float)h * sy;
}

// grid (N): one block per mask, its gradient in shared memory
__global__ void point_sample_bwd_smem_kernel(const float* __restrict__ masks,
                                             const float* __restrict__ coords,
                                             const float* __restrict__ ds,
                                             float* __restrict__ dmasks,
                                             float* __restrict__ dcoords, int p, int h, int w,
                                             int group) {
  extern __shared__ float acc[];
  const int n = blockIdx.x;
  const int hw = h * w;
  for (int i = threadIdx.x; i < hw; i += blockDim.x) acc[i] = 0.0f;
  __syncthreads();
  const float* crow = coords + (long long)(n / group) * p * 2;
  const float* dsrow = ds + (long long)n * p;
  const float* m = masks + (long long)n * hw;
  for (int j = threadIdx.x; j < p; j += blockDim.x) {
    const Taps t = taps_of(crow[2 * j], crow[2 * j + 1], h, w);
    const float g = dsrow[j];
#pragma unroll
    for (int k = 0; k < 4; ++k)
      if (t.wt[k] != 0.0f) atomicAdd(acc + t.idx[k], g * t.wt[k]);
    if (dcoords != nullptr) write_dcoords(t, m, g, h, w, dcoords + ((long long)n * p + j) * 2);
  }
  __syncthreads();
  float* dm = dmasks + (long long)n * hw;
  for (int i = threadIdx.x; i < hw; i += blockDim.x) dm[i] = acc[i];
}

// grid (ceil(P / BWD_THREADS), N): masks too large for shared memory; adds
// into dmasks (zeroed by the caller) with global atomics, a mask's blocks
// together
__global__ void point_sample_bwd_global_kernel(const float* __restrict__ masks,
                                               const float* __restrict__ coords,
                                               const float* __restrict__ ds,
                                               float* __restrict__ dmasks,
                                               float* __restrict__ dcoords, int p, int h, int w,
                                               int group) {
  const int n = blockIdx.y;
  const int j = blockIdx.x * blockDim.x + threadIdx.x;
  if (j >= p) return;
  const long long hw = (long long)h * w;
  const float* c = coords + ((long long)(n / group) * p + j) * 2;
  const Taps t = taps_of(c[0], c[1], h, w);
  const float g = ds[(long long)n * p + j];
  float* dm = dmasks + n * hw;
#pragma unroll
  for (int k = 0; k < 4; ++k)
    if (t.wt[k] != 0.0f) atomicAdd(dm + t.idx[k], g * t.wt[k]);
  if (dcoords != nullptr)
    write_dcoords(t, masks + n * hw, g, h, w, dcoords + ((long long)n * p + j) * 2);
}

bool bad_args(int n, int p, int h, int w, int group) {
  return n < 1 || p < 1 || h < 1 || w < 1 || group < 1 || n % group != 0 ||
         (p + FWD_CHUNK - 1) / FWD_CHUNK > 65535 || n > 65535;
}

bool fits_smem(int h, int w) { return (long long)h * w * (long long)sizeof(float) <= MAX_SMEM; }

}  // namespace

extern "C" int point_sample_fwd_f32(const float* masks, const float* coords, float* out, int n,
                                    int p, int h, int w, int group, cudaStream_t stream) {
  if (bad_args(n, p, h, w, group)) return (int)cudaErrorInvalidValue;
  const long long bytes = (long long)h * w * (long long)sizeof(float);
  if (bytes <= FWD_SMEM) {
    const dim3 grid(n, (p + FWD_CHUNK - 1) / FWD_CHUNK);
    point_sample_fwd_smem_kernel<<<grid, FWD_THREADS, (size_t)bytes, stream>>>(masks, coords, out,
                                                                                p, h, w, group);
  } else {
    const dim3 grid((p + FWD_THREADS - 1) / FWD_THREADS, n);
    point_sample_fwd_kernel<<<grid, FWD_THREADS, 0, stream>>>(masks, coords, out, p, h, w, group);
  }
  return (int)cudaGetLastError();
}

// dcoords may be null (no coordinate gradient asked for). Where
// point_sample_bwd_uses_smem(h, w) is 0 the caller must have zeroed dmasks:
// the global path adds into it; the shared-memory path writes every element.
extern "C" int point_sample_bwd_f32(const float* masks, const float* coords, const float* ds,
                                    float* dmasks, float* dcoords, int n, int p, int h, int w,
                                    int group, cudaStream_t stream) {
  if (bad_args(n, p, h, w, group)) return (int)cudaErrorInvalidValue;
  const long long bytes = (long long)h * w * (long long)sizeof(float);
  if (fits_smem(h, w)) {
    if (bytes > 48 * 1024) {
      const cudaError_t e = cudaFuncSetAttribute(
          point_sample_bwd_smem_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
      if (e != cudaSuccess) return (int)e;
    }
    point_sample_bwd_smem_kernel<<<n, BWD_THREADS, (size_t)bytes, stream>>>(
        masks, coords, ds, dmasks, dcoords, p, h, w, group);
  } else {
    const dim3 grid((p + BWD_THREADS - 1) / BWD_THREADS, n);
    point_sample_bwd_global_kernel<<<grid, BWD_THREADS, 0, stream>>>(
        masks, coords, ds, dmasks, dcoords, p, h, w, group);
  }
  return (int)cudaGetLastError();
}

// whether point_sample_bwd_f32 takes the shared-memory path for [h, w]
extern "C" int point_sample_bwd_uses_smem(int h, int w) { return fits_smem(h, w) ? 1 : 0; }
