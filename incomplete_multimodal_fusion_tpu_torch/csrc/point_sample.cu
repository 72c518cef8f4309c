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
// 203 MB for the matcher's [3000, 64^2] at 12544 points (0.061 ms). What
// costs more than those bytes is the traffic between L2 and the SMs: the
// 100 query masks of an image share one row of points, and a kernel that
// takes a (mask, point) at a time re-reads the coordinates and recomputes
// the taps 100 times (301 MB of coordinate reads for 3 MB of coordinates).
// So where a group's masks fit in shared memory (the matcher's 64^2 query
// predictions, 16 KB), K5 gives a block a chunk of one coords row's points,
// computes their taps (4 indices, 4 weights) once in registers, and samples
// every mask of the row's group at them, each mask staged by cp.async (the
// next mask's copy in flight while this one is sampled) and its outputs
// written coalesced; the chunks are sized so that the grid is about one
// block per SM, so each mask crosses L2 about 132 / (coords rows) times (4
// for the matcher's 30 rows), not once per 2048 points. Two other cases:
//   * a group of 1 (the loss path) shares nothing: a small block per mask
//     and 2048 of its points stages the mask and takes each point's taps as
//     it samples, several blocks an SM hiding each other's latency;
//   * a mask past shared memory (the 256^2 targets, 256 KB; 240 of them are
//     63 MB, more than the 50 MB of L2) takes one block of 1024 threads per
//     mask and SM, with the SM's L1 at its largest: the taps of random
//     points cover the mask, so after its first touches it is read from L1
//     and crosses from L2 about once, where a block per chunk of points
//     pulled each mask through L2 once per block.
// Every load is unconditional: a tap outside the mask reads element 0 with
// weight 0.
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

#include <algorithm>
#include <atomic>

#include "hopper.cuh"

namespace {

constexpr int FWD_THREADS = 512;  // the shared-taps forward
constexpr int MAX_PPT = 8;  // points a thread of the shared-taps forward: its taps stay in registers
constexpr int MASK_THREADS = 256;  // the one-mask forward (a group of 1)
constexpr int MASK_CHUNK = 2048;   // its points per block
constexpr int CACHED_THREADS = 1024;  // the forward of masks past shared memory
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

// The taps of a block's points, once per point: point j0 + threadIdx.x +
// k * FWD_THREADS of coords row `crow` for k < ppt (<= MAX_PPT); a point
// past `end` gets weight 0 at index 0
struct PointTaps {
  int idx[MAX_PPT][4];
  float wt[MAX_PPT][4];
};

__device__ __forceinline__ void block_taps(PointTaps& pt, const float* __restrict__ crow, int j0, int end,
                                           int ppt, int h, int w) {
#pragma unroll
  for (int k = 0; k < MAX_PPT; ++k) {
    const int j = j0 + (int)threadIdx.x + k * FWD_THREADS;
    Taps t{};
    if (k < ppt && j < end) {
      const float2 c = *reinterpret_cast<const float2*>(crow + 2LL * j);
      t = taps_of(c.x, c.y, h, w);
    }
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      pt.idx[k][q] = t.idx[q];
      pt.wt[k][q] = t.wt[q];
    }
  }
}

// The samples of one mask at the block's points, read through `m` (shared
// or device memory), written to its output row
__device__ __forceinline__ void sample_points(const PointTaps& pt, const float* m, float* __restrict__ orow,
                                              int j0, int end, int ppt) {
#pragma unroll
  for (int k = 0; k < MAX_PPT; ++k) {
    const int j = j0 + (int)threadIdx.x + k * FWD_THREADS;
    if (k < ppt && j < end) {
      float v = 0.0f;
#pragma unroll
      for (int q = 0; q < 4; ++q) v += pt.wt[k][q] * m[pt.idx[k][q]];
      orow[j] = v;
    }
  }
}

// grid (point chunks, coords rows): block = `chunk` points of one coords
// row, their taps in registers, then every mask of the row's group in turn,
// each staged in shared memory (two buffers when two fit, the next mask's
// copy in flight while this one is sampled) and sampled there. VEC: the
// masks start on 16 bytes and their size is a multiple of 4 floats
// (16-byte copies).
template <bool VEC>
__global__ void __launch_bounds__(FWD_THREADS)
point_sample_fwd_staged_kernel(const float* __restrict__ masks, const float* __restrict__ coords,
                               float* __restrict__ out, int p, int h, int w, int group, int chunk, int ppt,
                               int nbuf) {
  extern __shared__ __align__(16) float tiles[];
  const int row = blockIdx.y;
  const int hw = h * w;
  const int j0 = blockIdx.x * chunk;
  const int end = min(p, j0 + chunk);
  const float* mrow = masks + (long long)row * group * hw;
  auto stage = [&](int g, int buf) {
    const float* src = mrow + (long long)g * hw;
    const uint32_t dst = hopper::smem_addr(tiles + (long long)buf * hw);
    if (VEC) {
      for (int i = threadIdx.x; i < hw / 4; i += FWD_THREADS) hopper::cp_async16(dst + 16 * i, src + 4 * i, true);
    } else {
      for (int i = threadIdx.x; i < hw; i += FWD_THREADS) hopper::cp_async4(dst + 4 * i, src + i, true);
    }
    hopper::cp_async_commit();
  };
  stage(0, 0);
  PointTaps pt;
  block_taps(pt, coords + (long long)row * p * 2, j0, end, ppt, h, w);
  for (int g = 0; g < group; ++g) {
    if (nbuf == 2 && g + 1 < group) {
      stage(g + 1, (g + 1) & 1);
      hopper::cp_async_wait<1>();
    } else {
      hopper::cp_async_wait<0>();
    }
    __syncthreads();  // mask g has landed
    sample_points(pt, tiles + (nbuf == 2 ? (long long)(g & 1) * hw : 0), out + ((long long)row * group + g) * p, j0,
                  end, ppt);
    __syncthreads();  // everyone is done with its buffer
    if (nbuf == 1 && g + 1 < group) stage(g + 1, 0);
  }
}

// grid (N, ceil(P / MASK_CHUNK)), for a group of 1, where no taps are
// shared: the mask staged in shared memory, then MASK_CHUNK of its points
// sampled from there, each point's taps computed as it is sampled; small
// blocks, several an SM
__global__ void __launch_bounds__(MASK_THREADS)
point_sample_fwd_mask_kernel(const float* __restrict__ masks, const float* __restrict__ coords,
                             float* __restrict__ out, int p, int h, int w) {
  extern __shared__ float tile[];
  const int n = blockIdx.x;
  const int hw = h * w;
  const float* m = masks + (long long)n * hw;
  for (int i = threadIdx.x; i < hw; i += MASK_THREADS) tile[i] = m[i];
  __syncthreads();
  const float* crow = coords + (long long)n * p * 2;
  float* orow = out + (long long)n * p;
  const int end = min(p, ((int)blockIdx.y + 1) * MASK_CHUNK);
  for (int j = blockIdx.y * MASK_CHUNK + (int)threadIdx.x; j < end; j += MASK_THREADS) {
    const float2 c = *reinterpret_cast<const float2*>(crow + 2LL * j);
    const Taps t = taps_of(c.x, c.y, h, w);
    float v = 0.0f;
#pragma unroll
    for (int q = 0; q < 4; ++q) v += t.wt[q] * tile[t.idx[q]];
    orow[j] = v;
  }
}

// grid (N), for masks too large for shared memory (the 256^2 targets,
// 256 KB): one block of CACHED_THREADS per mask and SM, the SM's L1 set to
// its largest, so that after its first touches the mask is read from L1
// and crosses from L2 about once; the coordinates are streamed past L1
__global__ void __launch_bounds__(CACHED_THREADS, 1)
point_sample_fwd_cached_kernel(const float* __restrict__ masks, const float* __restrict__ coords,
                               float* __restrict__ out, int p, int h, int w, int group) {
  const long long n = blockIdx.x;
  const float* m = masks + n * h * w;
  const float2* crow = reinterpret_cast<const float2*>(coords) + (n / group) * p;
  float* orow = out + n * p;
#pragma unroll 4
  for (int j = threadIdx.x; j < p; j += CACHED_THREADS) {
    const float2 c = __ldcs(crow + j);
    const Taps t = taps_of(c.x, c.y, h, w);
    float v = 0.0f;
#pragma unroll
    for (int q = 0; q < 4; ++q) v += t.wt[q] * __ldg(m + t.idx[q]);
    __stcs(orow + j, v);
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
  return n < 1 || p < 1 || h < 1 || w < 1 || group < 1 || n % group != 0 || n > 65535;
}

bool fits_smem(int h, int w) { return (long long)h * w * (long long)sizeof(float) <= MAX_SMEM; }

// The forward's point chunk for `rows` coords rows of p points: at most
// MAX_PPT points a thread, and about `target` blocks in all (at least one
// chunk a row), the points split evenly; a multiple of 32.
int fwd_chunk(int p, int rows, int target) {
  const int most = FWD_THREADS * MAX_PPT;
  const int chunks = std::max(std::max(target / rows, (p + most - 1) / most), 1);
  const int chunk = ((p + chunks - 1) / chunks + 31) / 32 * 32;
  return std::min(chunk, most);
}

template <bool VEC>
cudaError_t launch_staged(const float* masks, const float* coords, float* out, int rows, int p, int h, int w,
                          int group, int chunk, int nbuf, size_t bytes, cudaStream_t stream) {
  static std::atomic<unsigned> ready{0};
  auto kernel = point_sample_fwd_staged_kernel<VEC>;
  cudaError_t err = hopper::allow_smem((const void*)kernel, MAX_SMEM, ready);
  if (err != cudaSuccess) return err;
  const dim3 grid((p + chunk - 1) / chunk, rows);
  kernel<<<grid, FWD_THREADS, bytes, stream>>>(masks, coords, out, p, h, w, group, chunk,
                                               (chunk + FWD_THREADS - 1) / FWD_THREADS, nbuf);
  return cudaGetLastError();
}

}  // namespace

// Three forms: masks of a group that fit in shared memory are staged there
// (two at a time where two fit) and sampled by blocks of about one per SM
// over the coords rows, each point's taps computed once for all of them; a
// group of 1 takes a small block per mask and chunk of points; a mask past
// shared memory takes a block per mask that caches it in L1.
extern "C" int point_sample_fwd_f32(const float* masks, const float* coords, float* out, int n, int p, int h,
                                    int w, int group, cudaStream_t stream) {
  if (bad_args(n, p, h, w, group)) return (int)cudaErrorInvalidValue;
  const int rows = n / group;
  const long long bytes = (long long)h * w * (long long)sizeof(float);
  if (!fits_smem(h, w)) {
    static std::atomic<unsigned> ready{0};
    const cudaError_t err = hopper::allow_l1((const void*)point_sample_fwd_cached_kernel, ready);
    if (err != cudaSuccess) return (int)err;
    point_sample_fwd_cached_kernel<<<n, CACHED_THREADS, 0, stream>>>(masks, coords, out, p, h, w, group);
    return (int)cudaGetLastError();
  }
  if (group == 1) {
    static std::atomic<unsigned> ready{0};
    const cudaError_t err = hopper::allow_smem((const void*)point_sample_fwd_mask_kernel, MAX_SMEM, ready);
    if (err != cudaSuccess) return (int)err;
    const dim3 grid(n, (p + MASK_CHUNK - 1) / MASK_CHUNK);
    point_sample_fwd_mask_kernel<<<grid, MASK_THREADS, (size_t)bytes, stream>>>(masks, coords, out, p, h, w);
    return (int)cudaGetLastError();
  }
  const int nbuf = 2 * bytes <= MAX_SMEM ? 2 : 1;
  const int chunk = fwd_chunk(p, rows, hopper::sm_count());
  const size_t smem = (size_t)(nbuf * bytes);
  // 16-byte copies where every mask starts on 16 bytes
  const bool vec = (h * w) % 4 == 0 && reinterpret_cast<uintptr_t>(masks) % 16 == 0;
  return (int)(vec ? launch_staged<true>(masks, coords, out, rows, p, h, w, group, chunk, nbuf, smem, stream)
                                : launch_staged<false>(masks, coords, out, rows, p, h, w, group, chunk, nbuf, smem, stream));
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
    static std::atomic<unsigned> ready{0};
    const cudaError_t e = hopper::allow_smem((const void*)point_sample_bwd_smem_kernel, MAX_SMEM, ready);
    if (e != cudaSuccess) return (int)e;
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
