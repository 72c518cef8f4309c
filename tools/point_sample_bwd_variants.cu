// Other designs of kernel K5b (the point-sample backward's dmasks, csrc/
// point_sample.cu), timed against the repo's by tools/bench_points_bwd.py.
// Each build of this file takes one design, chosen by -DVARIANT=:
//   0 the design before the fixed-point one: a block per mask, float
//     atomicAdd (a compare-and-swap loop on sm_90) into a shared-memory
//     image, each point's coords as two 4-byte loads;
//   1 that with one 8-byte coords load and a 2-block cluster per mask: each
//     block adds half the points into its own image, and the two images are
//     summed through distributed shared memory;
//   2 red.global.add.f32 (atomicAdd whose result is unused) into dmasks,
//     zeroed first (3.9 MB at [240, 64^2], L2-resident);
//   3 bin, then gather, keeping (dS, dx, dy) of each point in shared memory:
//     each point with a tap inside the mask gets one cell, its top-left tap
//     (y0, x0) on an (H + 1) x (W + 1) grid that takes the -1 border row and
//     column; the cells are counted with shared-memory integer atomics, a
//     block-wide exclusive scan gives each cell its range, each point writes
//     its (dS, dx, dy) into its cell's range, and a thread then owns a run of
//     4 pixels of a row and sums, in registers, the entries of the cells whose
//     taps cover them (167 KB of shared memory at P = 12544, one block an SM);
//   4 the same, each point writing only its index (uint16) into its cell's
//     range, its coords and dS staged in shared memory first and its weights
//     recomputed in the gather (193 KB);
//   5-25 the fixed-point adds (dS w S split into int32 parts added by
//     shared-memory integer atomics) as first built (F: 512 threads a
//     block, a point at a time a thread, a branch past each tap outside,
//     the high part by floorf and a float-to-int conversion, 44 bits, a
//     pass over dS for the largest |dS| by 4-byte loads), with changes:
//   5 one int64 image and one 64-bit integer atomicAdd a tap;
//   6 (a diagnostic, wrong dmasks) plain load-add-store where F adds;
//   7 (a diagnostic, right while the sums fit) no pass over dS (S = 2^30);
//   8 1024 threads, each loading 8 points' coords and dS before it adds
//     their taps;  9 the same with 512 threads;
//   10 9's with three parts of 14 bits and more a tap, each rounded by
//     adding 1.5 * 2^23 (no float-to-int conversion, 50 bits, three adds);
//   11 9's with two such parts (36 bits);  12 9's without the pass over dS;
//   13 9's with 12 points a thread in flight;  14 13's with 10's parts;
//   15 10's with the pass over dS by 16-byte loads;  16 that with 11's
//     parts and 12 points a thread in flight;
//   17 9's adds, the mask's dS staged in shared memory and its coords
//     streamed through a 3-slot ring of 1024-point chunks by cp.async;
//   18 9's with its first 8 points a thread loaded before the pass over dS;
//   19 9's with 10 points a thread in flight (3 rounds at P = 12544, not 4);
//   20 9's without the branch: a tap outside adds 0 at pixel 0;
//   21 19's with 18's and 20's changes;  22 9's with the pass over dS by
//     16-byte loads;  23 9's with 768 threads and 6 points a thread;
//   24 9's without the branch: a tap outside adds its 0 to one of 32 slots
//     past the image, one a lane (the repo's design);  25 24's with 11's
//     parts.
// Each exports point_sample_bwd_f32 and point_sample_bwd_writes_all with the
// repo's signatures (the repo's own are renamed away below), for masks of up
// to 48 KB (design 0-2) or as shared memory allows (3, 4); dcoords as the
// repo's. Build (as the bench does):
//   nvcc <cuda_build.NVCC_FLAGS> -I incomplete_multimodal_fusion_tpu_torch/csrc -DVARIANT=3 \
//        -o build/bench_points/v3.so tools/point_sample_bwd_variants.cu
#define point_sample_fwd_f32 repo_point_sample_fwd_f32
#define point_sample_bwd_f32 repo_point_sample_bwd_f32
#define point_sample_bwd_writes_all repo_point_sample_bwd_writes_all
#include "point_sample.cu"
#undef point_sample_fwd_f32
#undef point_sample_bwd_f32
#undef point_sample_bwd_writes_all

#include <cooperative_groups.h>

#ifndef VARIANT
#define VARIANT 0
#endif

namespace {

namespace cg = cooperative_groups;

constexpr int SMALL_SMEM = 48 * 1024;
constexpr int BIN_THREADS = 1024;
constexpr int RUN = 4;  // pixels of a row a thread of the gather owns

// 0: the design before the fixed-point one
__global__ void parent_kernel(const float* __restrict__ masks, const float* __restrict__ coords,
                              const float* __restrict__ ds, float* __restrict__ dmasks, float* __restrict__ dcoords,
                              int p, int h, int w, int group) {
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

// 1: a 2-block cluster per mask, each block half the points, the two
// shared-memory images summed through distributed shared memory
__global__ void __cluster_dims__(2, 1, 1)
cluster_kernel(const float* __restrict__ masks, const float* __restrict__ coords, const float* __restrict__ ds,
               float* __restrict__ dmasks, float* __restrict__ dcoords, int p, int h, int w, int group) {
  extern __shared__ float acc[];
  cg::cluster_group cluster = cg::this_cluster();
  const unsigned rank = cluster.block_rank();
  const int n = blockIdx.x / 2;
  const int hw = h * w;
  for (int i = threadIdx.x; i < hw; i += blockDim.x) acc[i] = 0.0f;
  __syncthreads();
  const float2* crow = reinterpret_cast<const float2*>(coords) + (long long)(n / group) * p;
  const float* dsrow = ds + (long long)n * p;
  const float* m = masks + (long long)n * hw;
  for (int j = rank * blockDim.x + threadIdx.x; j < p; j += 2 * blockDim.x) {
    const float2 c = crow[j];
    const Taps t = taps_of(c.x, c.y, h, w);
    const float g = dsrow[j];
#pragma unroll
    for (int k = 0; k < 4; ++k)
      if (t.wt[k] != 0.0f) atomicAdd(acc + t.idx[k], g * t.wt[k]);
    if (dcoords != nullptr) write_dcoords(t, m, g, h, w, dcoords + ((long long)n * p + j) * 2);
  }
  cluster.sync();  // both images complete
  const float* other = cluster.map_shared_rank(acc, rank ^ 1);
  const int half = (hw + 1) / 2;
  const int end = min(hw, (int)(rank + 1) * half);
  float* dm = dmasks + (long long)n * hw;
  for (int i = rank * half + threadIdx.x; i < end; i += blockDim.x) dm[i] = acc[i] + other[i];
  cluster.sync();  // the other block has read this one's image
}

// 2: red.global.add.f32 into dmasks (zeroed by the caller)
__global__ void red_kernel(const float* __restrict__ masks, const float* __restrict__ coords,
                           const float* __restrict__ ds, float* __restrict__ dmasks, float* __restrict__ dcoords,
                           int p, int h, int w, int group) {
  const int n = blockIdx.y;
  const int j = blockIdx.x * blockDim.x + threadIdx.x;
  if (j >= p) return;
  const long long hw = (long long)h * w;
  const float2 c = reinterpret_cast<const float2*>(coords)[(long long)(n / group) * p + j];
  const Taps t = taps_of(c.x, c.y, h, w);
  const float g = ds[(long long)n * p + j];
  float* dm = dmasks + n * hw;
#pragma unroll
  for (int k = 0; k < 4; ++k)
    if (t.wt[k] != 0.0f) atomicAdd(dm + t.idx[k], g * t.wt[k]);
  if (dcoords != nullptr) write_dcoords(t, masks + n * hw, g, h, w, dcoords + ((long long)n * p + j) * 2);
}

// 5-12: the repo's fixed-point kernel, generalised: THREADS a block; U
// points a thread whose loads are all issued before their taps are added;
// SPLIT the tap's integer form: 2 the repo's (high part by floorf and a
// float-to-int conversion, 44 bits), 1 two parts rounded by adding
// 1.5 * 2^23 (36 bits), 3 three such parts (50 bits, three adds), 64 one
// int64 (a 64-bit atomicAdd), 0 the repo's parts added by plain
// load-add-store (a diagnostic: wrong where two adds meet); PRE the pass
// over dS for the largest |dS| (1: 4-byte loads, 2: 16-byte loads where
// aligned; 0: none, S = 2^30, right while the sums fit)
template <int THREADS, int U, int SPLIT, int PRE, int OPT>
__global__ void __launch_bounds__(THREADS)
fixed_variant_kernel(const float* __restrict__ masks, const float* __restrict__ coords,
                     const float* __restrict__ ds, float* __restrict__ dmasks, float* __restrict__ dcoords, int p,
                     int h, int w, int group) {
  constexpr int BITS = SPLIT == 1 ? 36 : SPLIT == 3 ? 50 : FIXED_BITS;
  extern __shared__ __align__(16) int vparts[];
  __shared__ float warp_max[THREADS / 32];
  const int n = blockIdx.x;
  const int hw = h * w;
  const int stride = OPT & 4 ? hw + 32 : hw;  // OPT 4: 32 slots past the image take a lane's taps outside
  int* part0 = vparts;
  int* part1 = vparts + stride;
  int* part2 = vparts + 2 * stride;
  unsigned long long* wide = reinterpret_cast<unsigned long long*>(vparts);
  for (int i = threadIdx.x; i < (SPLIT == 3 ? 3 : 2) * stride; i += THREADS) vparts[i] = 0;
  const float* dsrow = ds + (long long)n * p;
  const float2* crow = reinterpret_cast<const float2*>(coords) + (long long)(n / group) * p;
  float2 c[U];
  float g[U];
  auto load = [&](int j0) {
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int j = j0 + u * THREADS;
      c[u] = j < p ? crow[j] : make_float2(-4.0f, -4.0f);  // past P: no tap inside
      g[u] = j < p ? dsrow[j] : 0.0f;
    }
  };
  if (OPT & 1) load(threadIdx.x);  // the first points' loads in flight across the pass over dS
  int shift = 30;
  if (PRE) {
    float mx = 0.0f;
    if (PRE == 2 && p % 4 == 0 && reinterpret_cast<uintptr_t>(dsrow) % 16 == 0) {  // 16-byte loads
      const float4* d4 = reinterpret_cast<const float4*>(dsrow);
      for (int j0 = threadIdx.x; j0 < p / 4; j0 += U * THREADS) {
        float4 g[U];
#pragma unroll
        for (int u = 0; u < U; ++u) g[u] = j0 + u * THREADS < p / 4 ? d4[j0 + u * THREADS] : make_float4(0, 0, 0, 0);
#pragma unroll
        for (int u = 0; u < U; ++u) mx = fmaxf(mx, fmaxf(fmaxf(fabsf(g[u].x), fabsf(g[u].y)),
                                                         fmaxf(fabsf(g[u].z), fabsf(g[u].w))));
      }
    } else {
      for (int j0 = threadIdx.x; j0 < p; j0 += U * THREADS) {
        float g[U];
#pragma unroll
        for (int u = 0; u < U; ++u) g[u] = j0 + u * THREADS < p ? dsrow[j0 + u * THREADS] : 0.0f;
#pragma unroll
        for (int u = 0; u < U; ++u) mx = fmaxf(mx, fabsf(g[u]));
      }
    }
    for (int o = 16; o > 0; o >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
    if (threadIdx.x % 32 == 0) warp_max[threadIdx.x / 32] = mx;
    __syncthreads();
    mx = 0.0f;
#pragma unroll
    for (int i = 0; i < THREADS / 32; ++i) mx = fmaxf(mx, warp_max[i]);
    const int e = max((int)((__float_as_uint(mx * (float)p) >> 23) & 0xffu), 1) - 126;
    shift = min(BITS - e, 126);
  } else {
    __syncthreads();
  }
  const float scale = ldexpf(1.0f, shift), unscale = ldexpf(1.0f, -shift);
  const float* m = masks + (long long)n * hw;
  for (int j0 = threadIdx.x; j0 < p; j0 += U * THREADS) {
    if (!(OPT & 1) || j0 != (int)threadIdx.x) load(j0);
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const Taps t = taps_of(c[u].x, c[u].y, h, w);
      const float gs = g[u] * scale;
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        if (!(OPT & 6) && t.wt[k] == 0.0f) continue;  // OPT 2: a tap outside adds 0 at pixel 0
        const float v = gs * t.wt[k];
        const int at = OPT & 4 && t.wt[k] == 0.0f ? hw + (int)(threadIdx.x % 32) : t.idx[k];
        if (SPLIT == 64) {
          atomicAdd(wide + at, (unsigned long long)__float2ll_rn(v));
        } else if (SPLIT == 1 || SPLIT == 3) {
          const float t1 = fmaf(v, SPLIT == 3 ? 0x1p-28f : 0x1p-14f, ROUNDER);
          const float r1 = fmaf(-(t1 - ROUNDER), SPLIT == 3 ? 0x1p28f : 0x1p14f, v);
          atomicAdd(part0 + at, __float_as_int(t1) - __float_as_int(ROUNDER));
          if (SPLIT == 3) {
            const float t2 = fmaf(r1, 0x1p-14f, ROUNDER);
            const float r2 = fmaf(-(t2 - ROUNDER), 0x1p14f, r1);
            atomicAdd(part1 + at, __float_as_int(t2) - __float_as_int(ROUNDER));
            atomicAdd(part2 + at, __float_as_int(r2 + ROUNDER) - __float_as_int(ROUNDER));
          } else {
            atomicAdd(part1 + at, __float_as_int(r1 + ROUNDER) - __float_as_int(ROUNDER));
          }
        } else {
          const float high = floorf(v * (1.0f / LO_SPAN));
          const int low = __float_as_int(fmaf(-high, LO_SPAN, v) + ROUNDER) - __float_as_int(ROUNDER);
          if (SPLIT == 0) {
            part0[at] += (int)high;
            part1[at] += low;
          } else {
            atomicAdd(part0 + at, (int)high);
            atomicAdd(part1 + at, low);
          }
        }
      }
      if (dcoords != nullptr && j0 + u * THREADS < p)
        write_dcoords(t, m, g[u], h, w, dcoords + ((long long)n * p + j0 + u * THREADS) * 2);
    }
  }
  __syncthreads();
  float* dm = dmasks + (long long)n * hw;
  for (int i = threadIdx.x; i < hw; i += THREADS) {
    long long v;
    if (SPLIT == 64)
      v = (long long)wide[i];
    else if (SPLIT == 3)
      v = (long long)part0[i] * (1LL << 28) + (long long)part1[i] * (1LL << 14) + part2[i];
    else if (SPLIT == 1)
      v = (long long)part0[i] * (1LL << 14) + part1[i];
    else
      v = (long long)part0[i] * (1LL << LO_BITS) + (unsigned)part1[i];
    dm[i] = __ll2float_rn(v) * unscale;
  }
}

template <int THREADS, int U, int SPLIT, int PRE, int OPT>
cudaError_t launch_fixed_variant(const float* masks, const float* coords, const float* ds, float* dmasks,
                                 float* dcoords, int n, int p, int h, int w, int group, cudaStream_t stream) {
  const size_t bytes = ((size_t)h * w + (OPT & 4 ? 32 : 0)) * 4 * (SPLIT == 3 ? 3 : 2);
  if (bytes > (size_t)MAX_SMEM - 1024) return cudaErrorInvalidValue;
  static std::atomic<unsigned> ready{0};
  const cudaError_t e = hopper::allow_smem((const void*)fixed_variant_kernel<THREADS, U, SPLIT, PRE, OPT>,
                                           MAX_SMEM - 1024, ready);
  if (e != cudaSuccess) return e;
  fixed_variant_kernel<THREADS, U, SPLIT, PRE, OPT><<<n, THREADS, bytes, stream>>>(masks, coords, ds, dmasks,
                                                                                    dcoords, p, h, w, group);
  return cudaGetLastError();
}

// 17: 9's adds with the mask's dS staged in shared memory and its coords
// streamed through a ring of STAGES chunks of CHUNK points by cp.async, so
// no load waits in registers: the copies of dS and of the first chunks are
// issued first, the largest |dS| is taken from shared memory, and each chunk
// is added while the next ones land
constexpr int CHUNK = 1024;
constexpr int STAGES = 3;

__global__ void __launch_bounds__(BWD_THREADS)
staged_fixed_kernel(const float* __restrict__ masks, const float* __restrict__ coords, const float* __restrict__ ds,
                    float* __restrict__ dmasks, float* __restrict__ dcoords, int p, int h, int w, int group) {
  extern __shared__ __align__(16) int sparts[];
  __shared__ float warp_max[BWD_THREADS / 32];
  const int n = blockIdx.x;
  const int hw = h * w;
  int* hi = sparts;
  unsigned* lo = reinterpret_cast<unsigned*>(sparts + hw);
  float* sds = reinterpret_cast<float*>(sparts + 2 * hw);
  float2* ring = reinterpret_cast<float2*>(sds + ((p + 3) & ~3));
  const float* dsrow = ds + (long long)n * p;
  const float2* crow = reinterpret_cast<const float2*>(coords) + (long long)(n / group) * p;
  const bool vec_ds = p % 4 == 0 && reinterpret_cast<uintptr_t>(dsrow) % 16 == 0;
  const bool vec_c = p % 2 == 0 && reinterpret_cast<uintptr_t>(crow) % 16 == 0;
  if (vec_ds) {
    for (int i = threadIdx.x; i < p / 4; i += BWD_THREADS)
      hopper::cp_async16(hopper::smem_addr(sds + 4 * i), dsrow + 4 * i, true);
  } else {
    for (int i = threadIdx.x; i < p; i += BWD_THREADS) hopper::cp_async4(hopper::smem_addr(sds + i), dsrow + i, true);
  }
  hopper::cp_async_commit();
  const int chunks = (p + CHUNK - 1) / CHUNK;
  auto stage = [&](int c) {  // chunk c into its ring slot (an empty group past the last chunk)
    if (c < chunks) {
      const int j0 = c * CHUNK, len = min(CHUNK, p - j0);
      float2* dst = ring + (c % STAGES) * CHUNK;
      if (vec_c) {
        for (int i = threadIdx.x; i < len / 2; i += BWD_THREADS)
          hopper::cp_async16(hopper::smem_addr(dst + 2 * i), crow + j0 + 2 * i, true);
      } else {
        for (int i = threadIdx.x; i < len; i += BWD_THREADS) {
          hopper::cp_async4(hopper::smem_addr(dst + i), crow + j0 + i, true);
          hopper::cp_async4(hopper::smem_addr(dst + i) + 4, reinterpret_cast<const float*>(crow + j0 + i) + 1, true);
        }
      }
    }
    hopper::cp_async_commit();
  };
  for (int c = 0; c < STAGES - 1; ++c) stage(c);
  for (int i = threadIdx.x; i < 2 * hw; i += BWD_THREADS) sparts[i] = 0;
  hopper::cp_async_wait<STAGES - 1>();  // dS has landed
  __syncthreads();
  float mx = 0.0f;
  for (int j = threadIdx.x; j < p; j += BWD_THREADS) mx = fmaxf(mx, fabsf(sds[j]));
  for (int o = 16; o > 0; o >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
  if (threadIdx.x % 32 == 0) warp_max[threadIdx.x / 32] = mx;
  __syncthreads();
  mx = 0.0f;
#pragma unroll
  for (int i = 0; i < BWD_THREADS / 32; ++i) mx = fmaxf(mx, warp_max[i]);
  const int e = max((int)((__float_as_uint(mx * (float)p) >> 23) & 0xffu), 1) - 126;
  const int shift = min(FIXED_BITS - e, 126);
  const float scale = ldexpf(1.0f, shift), unscale = ldexpf(1.0f, -shift);
  const float* m = masks + (long long)n * hw;
  for (int c = 0; c < chunks; ++c) {
    stage(c + STAGES - 1);
    hopper::cp_async_wait<STAGES - 1>();  // chunk c has landed
    __syncthreads();
    const float2* pts = ring + (c % STAGES) * CHUNK;
    const int j0 = c * CHUNK, len = min(CHUNK, p - j0);
    for (int i = threadIdx.x; i < len; i += BWD_THREADS) {
      const float2 q = pts[i];
      const float g = sds[j0 + i];
      const Taps t = taps_of(q.x, q.y, h, w);
      const float gs = g * scale;
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        if (t.wt[k] == 0.0f) continue;
        const float v = gs * t.wt[k];
        const float high = floorf(v * (1.0f / LO_SPAN));
        atomicAdd(hi + t.idx[k], (int)high);
        atomicAdd(lo + t.idx[k], __float_as_uint(fmaf(-high, LO_SPAN, v) + ROUNDER) - __float_as_uint(ROUNDER));
      }
      if (dcoords != nullptr) write_dcoords(t, m, g, h, w, dcoords + ((long long)n * p + j0 + i) * 2);
    }
    __syncthreads();  // everyone is done with chunk c's slot
  }
  float* dm = dmasks + (long long)n * hw;
  for (int i = threadIdx.x; i < hw; i += BWD_THREADS)
    dm[i] = __ll2float_rn((long long)hi[i] * (1LL << LO_BITS) + lo[i]) * unscale;
}

// 3, 4: the cell of a point, (y0 + 1) * (w + 1) + x0 + 1 for its top-left tap
// (y0, x0), or -1 where no tap is inside; dx, dy as taps_of rounds them
__device__ __forceinline__ int cell_of(float cx, float cy, int h, int w, float& dx, float& dy) {
  const float px = pixel_of(cx, w);
  const float py = pixel_of(cy, h);
  const float x0f = floorf(fminf(fmaxf(px, -2.0f), (float)w + 1.0f));
  const float y0f = floorf(fminf(fmaxf(py, -2.0f), (float)h + 1.0f));
  dx = px - x0f;
  dy = py - y0f;
  const int x0 = (int)x0f, y0 = (int)y0f;
  return x0 >= -1 && x0 < w && y0 >= -1 && y0 < h ? (y0 + 1) * (w + 1) + x0 + 1 : -1;
}

// a[0 .. len) replaced by its exclusive prefix sums, by the whole block
__device__ void block_exclusive_scan(int* a, int len, int* warp_sums) {
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int per = (len + BIN_THREADS - 1) / BIN_THREADS;
  const int lo = min(len, (int)threadIdx.x * per), hi = min(len, lo + per);
  int own = 0;
  for (int i = lo; i < hi; ++i) own += a[i];
  int x = own;
  for (int o = 1; o < 32; o <<= 1) {
    const int y = __shfl_up_sync(0xffffffffu, x, o);
    if (lane >= o) x += y;
  }
  if (lane == 31) warp_sums[warp] = x;
  __syncthreads();
  if (warp == 0) {
    int v = warp_sums[lane];
    for (int o = 1; o < 32; o <<= 1) {
      const int y = __shfl_up_sync(0xffffffffu, v, o);
      if (lane >= o) v += y;
    }
    warp_sums[lane] = v;
  }
  __syncthreads();
  int base = (warp > 0 ? warp_sums[warp - 1] : 0) + x - own;
  for (int i = lo; i < hi; ++i) {
    const int c = a[i];
    a[i] = base;
    base += c;
  }
  __syncthreads();
}

// grid (N), BIN_THREADS threads: bin, scan, place, gather. IDX: the entries
// are point indices (coords and dS staged in shared memory), else (dS, dx, dy)
template <bool IDX>
__global__ void __launch_bounds__(BIN_THREADS)
bin_kernel(const float* __restrict__ masks, const float* __restrict__ coords, const float* __restrict__ ds,
           float* __restrict__ dmasks, float* __restrict__ dcoords, int p, int h, int w, int group) {
  extern __shared__ __align__(16) int cnt[];
  __shared__ int warp_sums[32];
  const int n = blockIdx.x;
  const int hw = h * w;
  const int cells = (h + 1) * (w + 1);
  const int cells_pad = (cells + 3) & ~3;
  float* rds = reinterpret_cast<float*>(cnt + cells_pad);  // IDX: the staged dS; else the entries' dS
  float* rdx = rds + p;
  float* rdy = rdx + p;
  float2* sc = reinterpret_cast<float2*>(rds + p + (p & 1));  // IDX: the staged coords
  unsigned short* idx = reinterpret_cast<unsigned short*>(sc + p);  // IDX: the entries
  const float2* crow = reinterpret_cast<const float2*>(coords) + (long long)(n / group) * p;
  const float* dsrow = ds + (long long)n * p;
  const float* m = masks + (long long)n * hw;
  for (int i = threadIdx.x; i < cells_pad; i += BIN_THREADS) cnt[i] = 0;
  if (IDX) {
    for (int j = threadIdx.x; j < p; j += BIN_THREADS) {
      hopper::cp_async4(hopper::smem_addr(rds + j), dsrow + j, true);
      hopper::cp_async4(hopper::smem_addr(sc + j), crow + j, true);
      hopper::cp_async4(hopper::smem_addr(sc + j) + 4, reinterpret_cast<const float*>(crow + j) + 1, true);
    }
    hopper::cp_async_commit();
    hopper::cp_async_wait<0>();
  }
  __syncthreads();
  auto point = [&](int j) { return IDX ? sc[j] : crow[j]; };
  for (int j = threadIdx.x; j < p; j += BIN_THREADS) {
    const float2 c = point(j);
    float dx, dy;
    const int cell = cell_of(c.x, c.y, h, w, dx, dy);
    if (cell >= 0) atomicAdd(cnt + cell, 1);
  }
  __syncthreads();
  block_exclusive_scan(cnt, cells, warp_sums);
  for (int j = threadIdx.x; j < p; j += BIN_THREADS) {
    const float2 c = point(j);
    float dx, dy;
    const int cell = cell_of(c.x, c.y, h, w, dx, dy);
    const float g = IDX ? rds[j] : dsrow[j];
    if (cell >= 0) {
      const int pos = atomicAdd(cnt + cell, 1);
      if (IDX) {
        idx[pos] = (unsigned short)j;
      } else {
        rds[pos] = g;
        rdx[pos] = dx;
        rdy[pos] = dy;
      }
    }
    if (dcoords != nullptr)
      write_dcoords(taps_of(c.x, c.y, h, w), m, g, h, w, dcoords + ((long long)n * p + j) * 2);
  }
  __syncthreads();  // cnt[c] is now the end of cell c's range
  const int runs = (w + RUN - 1) / RUN;
  float* dm = dmasks + (long long)n * hw;
  for (int run = threadIdx.x; run < h * runs; run += BIN_THREADS) {
    const int y = run / runs, xs = (run % runs) * RUN;
    float acc[RUN];
#pragma unroll
    for (int i = 0; i < RUN; ++i) acc[i] = 0.0f;
    for (int r = y - 1; r <= y; ++r) {  // the cells of row y - 1 reach row y with weight dy, row y's with 1 - dy
      const bool top = r == y;
      const int base = (r + 1) * (w + 1) + xs;  // the cell of x0 = xs - 1
#pragma unroll
      for (int i = 0; i <= RUN; ++i) {
        if (xs + i - 1 < w) {
          const int c = base + i;
          const int end = cnt[c];
          for (int e = c > 0 ? cnt[c - 1] : 0; e < end; ++e) {
            float g, dx, dy;
            if (IDX) {
              const int j = idx[e];
              const float2 q = sc[j];
              cell_of(q.x, q.y, h, w, dx, dy);
              g = rds[j];
            } else {
              g = rds[e];
              dx = rdx[e];
              dy = rdy[e];
            }
            const float wy = top ? 1.0f - dy : dy;
            if (i > 0) acc[i - 1] += g * (wy * (1.0f - dx));
            if (i < RUN) acc[i] += g * (wy * dx);
          }
        }
      }
    }
    if (w % RUN == 0 && reinterpret_cast<uintptr_t>(dmasks) % 16 == 0) {
      *reinterpret_cast<float4*>(dm + y * w + xs) = make_float4(acc[0], acc[1], acc[2], acc[3]);
    } else {
#pragma unroll
      for (int i = 0; i < RUN; ++i)
        if (xs + i < w) dm[y * w + xs + i] = acc[i];
    }
  }
}

size_t bin_bytes(int p, int h, int w, bool idx) {
  const size_t cells_pad = ((size_t)(h + 1) * (w + 1) + 3) & ~(size_t)3;
  return cells_pad * 4 + (idx ? (size_t)(p + (p & 1)) * 4 + (size_t)p * 8 + (size_t)p * 2 : (size_t)p * 12);
}

}  // namespace

extern "C" int point_sample_bwd_f32(const float* masks, const float* coords, const float* ds, float* dmasks,
                                    float* dcoords, int n, int p, int h, int w, int group, cudaStream_t stream) {
  if (bad_args(n, p, h, w, group)) return (int)cudaErrorInvalidValue;
  const size_t image = (size_t)h * w * sizeof(float);
#if VARIANT == 0
  if (image > SMALL_SMEM) return (int)cudaErrorInvalidValue;
  parent_kernel<<<n, BWD_THREADS, image, stream>>>(masks, coords, ds, dmasks, dcoords, p, h, w, group);
#elif VARIANT == 1
  if (image > SMALL_SMEM) return (int)cudaErrorInvalidValue;
  cluster_kernel<<<2 * n, BWD_THREADS, image, stream>>>(masks, coords, ds, dmasks, dcoords, p, h, w, group);
#elif VARIANT == 2
  (void)image;
  red_kernel<<<dim3((p + 255) / 256, n), 256, 0, stream>>>(masks, coords, ds, dmasks, dcoords, p, h, w, group);
#elif VARIANT == 17
  const size_t bytes = 2 * image + (size_t)((p + 3) & ~3) * 4 + (size_t)STAGES * CHUNK * 8;
  if (bytes > (size_t)MAX_SMEM - 1024) return (int)cudaErrorInvalidValue;
  static std::atomic<unsigned> ready{0};
  const cudaError_t e = hopper::allow_smem((const void*)staged_fixed_kernel, MAX_SMEM - 1024, ready);
  if (e != cudaSuccess) return (int)e;
  staged_fixed_kernel<<<n, BWD_THREADS, bytes, stream>>>(masks, coords, ds, dmasks, dcoords, p, h, w, group);
#elif VARIANT >= 5
  (void)image;
  // {threads, points a thread in flight, split, pass over dS (0 none, 1 4-byte, 2 16-byte loads), options (1 the
  // first points loaded before the pass, 2 no test for a tap outside, 4 a tap outside to a lane's slot)}
  static constexpr int CFG[][5] = {
      {512, 1, 64, 1, 0}, {512, 1, 0, 1, 0},  {512, 1, 2, 0, 0},  {1024, 8, 2, 1, 0}, {512, 8, 2, 1, 0},   // 5-9
      {512, 8, 3, 1, 0},  {512, 8, 1, 1, 0},  {512, 8, 2, 0, 0},  {512, 12, 2, 1, 0}, {512, 12, 3, 1, 0},  // 10-14
      {512, 8, 3, 2, 0},  {512, 12, 1, 2, 0}, {0, 0, 0, 0, 0},    {512, 8, 2, 1, 1},  {512, 10, 2, 1, 0},  // 15-19
      {512, 8, 2, 1, 2},  {512, 10, 2, 1, 3}, {512, 8, 2, 2, 0},  {768, 6, 2, 1, 0},                       // 20-23
      {512, 8, 2, 1, 4},  {512, 8, 1, 1, 4}};                                                              // 24-25
  constexpr auto& c = CFG[VARIANT - 5];
  return (int)launch_fixed_variant<c[0], c[1], c[2], c[3], c[4]>(masks, coords, ds, dmasks, dcoords, n, p, h, w, group,
                                                           stream);
#else
  (void)image;
  constexpr bool idx = VARIANT == 4;
  const size_t bytes = bin_bytes(p, h, w, idx);
  if (bytes > (size_t)MAX_SMEM - 1024 || p > 65536) return (int)cudaErrorInvalidValue;
  static std::atomic<unsigned> ready{0};
  const cudaError_t e = hopper::allow_smem((const void*)bin_kernel<idx>, MAX_SMEM - 1024, ready);
  if (e != cudaSuccess) return (int)e;
  bin_kernel<idx><<<n, BIN_THREADS, bytes, stream>>>(masks, coords, ds, dmasks, dcoords, p, h, w, group);
#endif
  return (int)cudaGetLastError();
}

extern "C" int point_sample_bwd_writes_all(int, int, int) { return VARIANT == 2 ? 0 : 1; }
