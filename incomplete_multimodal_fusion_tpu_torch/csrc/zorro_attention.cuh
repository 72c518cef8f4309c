// The tile loops of K1 (zorro attention forward) and K1b (its backward),
// shared by zorro_attention.cu (K1 / K1b on the fused qkv slab, on separate
// q, k, v and with a tile-skip table) and fused_block_attn.cu (K6b, the
// fused attention half-block's backward, calls launch_bwd). The design
// notes are in zorro_attention.cu.
//
// An attention's operands are views: base pointers of q, k and v at (batch
// row 0, token 0, head 0) and the element strides between batch rows and
// between tokens; head h's columns start h * DH further. The fused slab is
// the view (qkv, qkv + I, qkv + 2I) with token stride 3I, separate tensors
// the view (q, k, v) with token stride I.
//
// Tile skipping: with an activity table `active` [B, nt * nt] (int32, one
// entry per pair of 128-token tiles, pallas_zorro_sparse.py TILE), a 64-row
// tile takes the entry of the 128-tile that holds it, and a dead pair of
// tiles is skipped: it is never loaded and adds nothing to the row max, the
// row sum or any product. A null table is the dense attention.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <float.h>
#include <math_constants.h>
#include <stdint.h>

#include <atomic>

namespace zorro {

using bf16 = __nv_bfloat16;

constexpr int BQ = 64;  // query rows per block
constexpr int BK = 64;  // keys per tile
constexpr int WARPS = 4;
constexpr int THREADS = WARPS * 32;  // one warpgroup
constexpr int PAD_TYPE = 255;
constexpr float NEG_INF = -0.7f * FLT_MAX;
constexpr float LOG2E = 1.4426950408889634f;
constexpr float LN2 = 0.6931471805599453f;
constexpr int SKIP_TILE = 128;  // tokens per side of an activity-table tile

enum { MODE_ZORRO = 0, MODE_NONE = 1 };

struct Operands {
  const bf16* q;
  const bf16* k;
  const bf16* v;
  long long bstride;  // elements between batch rows
  long long rstride;  // elements between tokens
};

struct GradOperands {
  bf16* q;
  bf16* k;
  bf16* v;
  long long bstride;
  long long rstride;
};

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// The entry of a (query tile, key tile) pair of 64s in the activity table,
// or 1 without one.
__device__ __forceinline__ bool pair_active(const int32_t* active, int nt, int b, int q0, int k0) {
  return active == nullptr || active[((long long)b * nt + q0 / SKIP_TILE) * nt + k0 / SKIP_TILE] != 0;
}

// The first key tile at or after k0 that query tile q0 attends (n: none).
__device__ __forceinline__ int next_key_tile(const int32_t* active, int nt, int b, int q0, int k0, int n) {
  while (k0 < n && !pair_active(active, nt, b, q0, k0)) k0 += BK;
  return k0;
}

// The first query tile at or after q0 that attends key tile k0 (n: none).
__device__ __forceinline__ int next_query_tile(const int32_t* active, int nt, int b, int q0, int k0, int n) {
  while (q0 < n && !pair_active(active, nt, b, q0, k0)) q0 += BQ;
  return q0;
}

template <int MODE>
__device__ __forceinline__ float masked_score(float s, int t_q, int t_k, int fusion_type) {
  if (MODE == MODE_ZORRO) {
    const bool ok = (t_q == t_k) || (t_q == fusion_type && t_k != PAD_TYPE);
    return ok ? s : NEG_INF;
  }
  return s;
}

// ---------------------------------------------------------------------------
// PTX: asynchronous copies, wgmma and its shared-memory descriptors
// ---------------------------------------------------------------------------

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared; zeros when !inside (src is not read then)
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, bool inside) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src), "r"(inside ? 16 : 0)
               : "memory");
}

// 4 bytes global -> shared; zeros when !inside
__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src, bool inside) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst), "l"(src), "r"(inside ? 4 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }

__device__ __forceinline__ void cp_async_wait_all() { asm volatile("cp.async.wait_group 0;\n" ::: "memory"); }

// Makes this thread's completed shared-memory writes visible to wgmma's
// operand reads (the async proxy); a block barrier follows.
__device__ __forceinline__ void fence_async_smem() { asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory"); }

__device__ __forceinline__ void wgmma_fence() { asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory"); }

__device__ __forceinline__ void wgmma_commit() { asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory"); }

__device__ __forceinline__ void wgmma_wait_all() { asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory"); }

// Waits until at most one committed group of products is in flight (the
// groups finish in order).
__device__ __forceinline__ void wgmma_wait_one() { asm volatile("wgmma.wait_group.sync.aligned 1;\n" ::: "memory"); }

// Orders the registers of an asynchronous product after its wait: the
// compiler neither reads an accumulator early nor reuses an A fragment's
// registers while the product may still read them.
template <int R>
__device__ __forceinline__ void keep(float (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

__device__ __forceinline__ void keep(uint32_t (&a)[4][4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) asm volatile("" : "+r"(a[i][j])::"memory");
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// wgmma's shared-memory matrix descriptor: start address, leading and
// stride byte offsets (16-byte units), swizzle mode (1: 128 B, 2: 64 B).
__device__ __forceinline__ uint64_t gmma_desc(uint32_t addr, uint32_t lbo, uint32_t sbo, uint64_t layout) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)((lbo >> 4) & 0x3FFF) << 16) |
         ((uint64_t)((sbo >> 4) & 0x3FFF) << 32) | (layout << 62);
}

// D[64, 64] (+)= A[64, 16] . B[16, 64], A and B K-major in shared memory.
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[32], uint64_t da, uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, "
      "%32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(accumulate));
}

__device__ __forceinline__ void wgmma_rs_n32(float (&d)[16], const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15"
      "}, "
      "{%16, %17, %18, %19}, %20, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

__device__ __forceinline__ void wgmma_rs_n64(float (&d)[32], const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

__device__ __forceinline__ void wgmma_rs_n128(float (&d)[64], const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}


// D[64, N] += A[64, 16] . B[16, N], A (bf16 pairs) from registers, B
// MN-major in shared memory.
template <int N>
__device__ __forceinline__ void wgmma_rs(float (&d)[N / 2], const uint32_t (&a)[4], uint64_t db) {
  if constexpr (N == 32)
    wgmma_rs_n32(d, a, db);
  else if constexpr (N == 64)
    wgmma_rs_n64(d, a, db);
  else
    wgmma_rs_n128(d, a, db);
}

// A 64 x DH bf16 tile in shared memory, as wgmma reads it: rows of SW bytes
// (64 for dh 32, 128 otherwise; dh 128 is two 64-column blocks of 8 KB),
// the 16-byte chunks of row r xor-swizzled by (r & 7) (128 B) or
// ((r >> 1) & 3) (64 B), the hardware's swizzle of that width. Tiles start
// on 1024-byte boundaries. The same bytes serve as a K-major operand
// (rows = M or N, dh = K) and as an MN-major one (rows = K, dh = N).
template <int DH>
struct Tile {
  static constexpr int SW = DH == 32 ? 64 : 128;
  static constexpr int CPR = SW / 16;  // chunks per swizzled row
  static constexpr uint32_t BYTES = 64 * DH * 2;
  static constexpr uint64_t LAYOUT = SW == 128 ? 1 : 2;

  // byte offset of chunk c (columns 8c .. 8c + 7) of row r
  static __device__ __forceinline__ uint32_t offset(int r, int c) {
    const int swz = SW == 128 ? (r & 7) : ((r >> 1) & 3);
    return (c / CPR) * (64 * SW) + r * SW + (((c % CPR) ^ swz) << 4);
  }
  // K-major operand (64 rows x 16 columns at column 16 kk)
  static __device__ __forceinline__ uint64_t kmajor(uint32_t base, int kk) {
    const int byte = kk * 32;
    return gmma_desc(base + (byte / SW) * (64 * SW) + byte % SW, 16, 8 * SW, LAYOUT);
  }
  // MN-major operand (rows 16 kk .. 16 kk + 15 as K, all DH columns as N)
  static __device__ __forceinline__ uint64_t mnmajor(uint32_t base, int kk) {
    return gmma_desc(base + kk * 16 * SW, 64 * SW, 8 * SW, LAYOUT);
  }
};

// Issues the copies of rows [r0, r0 + 64) of a dh-wide column slice into a
// tile, 16 bytes per copy; rows at or past n become zeros. r0 < n.
template <int DH>
__device__ __forceinline__ void load_tile(uint32_t dst, const bf16* src, int r0, int n, long long rstride) {
  constexpr int CHUNKS = DH / 8;
#pragma unroll
  for (int it = 0; it < 64 * CHUNKS / THREADS; ++it) {
    const int i = it * THREADS + threadIdx.x;
    const int r = i / CHUNKS;
    const int c = i % CHUNKS;
    const bool inside = r0 + r < n;
    cp_async16(dst + Tile<DH>::offset(r, c), src + (long long)(inside ? r0 + r : r0) * rstride + c * 8, inside);
  }
}

// Issues the copies of 64 four-byte values [r0, r0 + 64) of a row (types,
// lse, D); those at or past n become zeros.
__device__ __forceinline__ void load_values(uint32_t dst, const void* src, int r0, int n) {
  const int i = threadIdx.x;
  if (i < 64) {
    const bool inside = r0 + i < n;
    cp_async4(dst + 4 * i, static_cast<const char*>(src) + 4LL * (inside ? r0 + i : r0), inside);
  }
}

// Writes a thread's part of a 64 x DH f32 accumulator fragment, times mul,
// as bf16 into a tile; row: the thread's first row (its second is row + 8).
template <int DH>
__device__ __forceinline__ void stage_fragment(unsigned char* tile, const float (&acc)[DH / 2], int row, int t4,
                                               float mul0, float mul1) {
#pragma unroll
  for (int j = 0; j < DH / 8; ++j) {
    *reinterpret_cast<__nv_bfloat162*>(tile + Tile<DH>::offset(row, j) + 4 * t4) =
        __floats2bfloat162_rn(acc[4 * j] * mul0, acc[4 * j + 1] * mul0);
    *reinterpret_cast<__nv_bfloat162*>(tile + Tile<DH>::offset(row + 8, j) + 4 * t4) =
        __floats2bfloat162_rn(acc[4 * j + 2] * mul1, acc[4 * j + 3] * mul1);
  }
}

// Stores rows [r0, r0 + 64) of a tile into a dh-wide column slice, 16 bytes
// per thread per step; rows at or past n are not written.
template <int DH>
__device__ __forceinline__ void store_tile(const unsigned char* tile, bf16* dst, int r0, int n, long long rstride) {
  constexpr int CHUNKS = DH / 8;
#pragma unroll
  for (int it = 0; it < 64 * CHUNKS / THREADS; ++it) {
    const int i = it * THREADS + threadIdx.x;
    const int r = i / CHUNKS;
    const int c = i % CHUNKS;
    if (r0 + r < n)
      *reinterpret_cast<uint4*>(dst + (long long)(r0 + r) * rstride + c * 8) =
          *reinterpret_cast<const uint4*>(tile + Tile<DH>::offset(r, c));
  }
}

// The dynamic shared memory, its start moved up to a 1024-byte boundary
// (the swizzle's period): the generic pointer and the shared address.
__device__ __forceinline__ uint32_t aligned_smem(unsigned char* raw, unsigned char** ptr) {
  const uint32_t base = smem_addr(raw);
  const uint32_t pad = (1024u - (base & 1023u)) & 1023u;
  *ptr = raw + pad;
  return base + pad;
}

// cudaFuncSetAttribute for the dynamic shared memory of `kernel` on the
// current device, the first time only: `ready` holds a bit per device, one
// flag per kernel instantiation (a static of its launcher). The launchers
// are static functions: each library that includes this header has its own
// kernels and so needs its own flags, where the static of an inline function
// would be one object shared by every loaded library.
inline cudaError_t allow_smem(const void* kernel, size_t bytes, std::atomic<unsigned>& ready) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  const unsigned bit = 1u << (dev & 31);
  if (ready.load(std::memory_order_relaxed) & bit) return cudaSuccess;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err == cudaSuccess) ready.fetch_or(bit);
  return err;
}

// ---------------------------------------------------------------------------
// Forward (K1)
// ---------------------------------------------------------------------------

// Shared memory of the forward: [Q][K0][V0][K1][V1][key types 0][key types 1]
template <int DH>
struct FwdSmem {
  static constexpr uint32_t T = Tile<DH>::BYTES;
  static constexpr uint32_t Q = 0, K = T, V = 2 * T, STAGE = 2 * T, TYPES = 5 * T;
  static constexpr size_t BYTES = 5 * T + 2 * 256 + 1024;  // + the alignment slack
};

// K1: block (query tile, head, batch row), one warpgroup; out [B, N, H * DH]
// with the given strides, lse f32 [B, H, N] or null.
template <int DH, int MODE>
__global__ void __launch_bounds__(THREADS)
zorro_attention_kernel(Operands in, const int32_t* __restrict__ types, const int32_t* __restrict__ active,
                       int nt, bf16* __restrict__ out, float* __restrict__ lse, int n, long long out_bstride,
                       long long out_rstride, long long types_bstride, float scale, int fusion_type) {
  using L = FwdSmem<DH>;
  using TL = Tile<DH>;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* sm;
  const uint32_t sa = aligned_smem(smem_raw, &sm);
  const int q0 = blockIdx.x * BQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int lane = threadIdx.x % 32;
  const int t4 = lane & 3;
  const int row = (threadIdx.x / 32) * 16 + lane / 4;  // this thread's rows: row and row + 8
  const bf16* kg = in.k + (long long)b * in.bstride + h * DH;
  const bf16* vg = in.v + (long long)b * in.bstride + h * DH;
  const int32_t* tg = types + (long long)b * types_bstride;
  const float sl2 = scale * LOG2E;  // scores in log2 units: exp2 in place of exp

  auto load_kv = [&](int k0, int stage) {
    load_tile<DH>(sa + L::K + stage * L::STAGE, kg, k0, n, in.rstride);
    load_tile<DH>(sa + L::V + stage * L::STAGE, vg, k0, n, in.rstride);
    if (MODE == MODE_ZORRO) load_values(sa + L::TYPES + stage * 256, tg, k0, n);
  };

  int k0 = next_key_tile(active, nt, b, q0, 0, n);  // the diagonal tile is always active
  load_tile<DH>(sa + L::Q, in.q + (long long)b * in.bstride + h * DH, q0, n, in.rstride);
  load_kv(k0, 0);
  cp_async_commit();

  int tq[2];
#pragma unroll
  for (int hi = 0; hi < 2; ++hi) {
    const int q = q0 + row + 8 * hi;
    tq[hi] = (MODE == MODE_ZORRO && q < n) ? tg[q] : PAD_TYPE;
  }
  float o[DH / 2];
#pragma unroll
  for (int i = 0; i < DH / 2; ++i) o[i] = 0.0f;
  float m[2] = {-CUDART_INF_F, -CUDART_INF_F};  // running row max (log2 units), no key seen yet
  float l[2] = {0.0f, 0.0f};                    // this thread's part of the running row sum

  for (int stage = 0; k0 < n; stage ^= 1) {
    cp_async_wait_all();  // tile k0 has landed (this thread's copies)
    fence_async_smem();
    __syncthreads();  // ... everyone's; and everyone is done with the other stage
    const int k_next = next_key_tile(active, nt, b, q0, k0 + BK, n);
    if (k_next < n) {  // the next tile loads while this one computes
      load_kv(k_next, stage ^ 1);
      cp_async_commit();
    }
    const uint32_t ks = sa + L::K + stage * L::STAGE;
    const uint32_t vs = sa + L::V + stage * L::STAGE;

    // S = Q K^T, f32 in registers
    float s[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) s[i] = 0.0f;
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < DH / 16; ++kk) wgmma_ss_n64(s, TL::kmajor(sa + L::Q, kk), TL::kmajor(ks, kk), 1);
    wgmma_commit();
    wgmma_wait_all();
    keep(s);

    // scale, then mask to the finite NEG_INF (in log2 units, so that no
    // masked score overflows to -inf), then keys past n to -inf; row max
    // over the quad that shares the row
    const int* tk = reinterpret_cast<const int*>(sm + L::TYPES + stage * 256);
    float mx[2] = {m[0], m[1]};
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int c = 8 * j + 2 * t4 + e;
        const int t_k = MODE == MODE_ZORRO ? tk[c] : 0;
        const bool key_in = k0 + c < n;
#pragma unroll
        for (int hi = 0; hi < 2; ++hi) {
          const float v = masked_score<MODE>(s[4 * j + 2 * hi + e] * sl2, tq[hi], t_k, fusion_type);
          s[4 * j + 2 * hi + e] = key_in ? v : -CUDART_INF_F;
          mx[hi] = fmaxf(mx[hi], s[4 * j + 2 * hi + e]);
        }
      }
    float corr[2];
#pragma unroll
    for (int hi = 0; hi < 2; ++hi) {
      mx[hi] = fmaxf(mx[hi], __shfl_xor_sync(0xffffffffu, mx[hi], 1));
      mx[hi] = fmaxf(mx[hi], __shfl_xor_sync(0xffffffffu, mx[hi], 2));
      corr[hi] = exp2f(m[hi] - mx[hi]);  // 0 on the first tile
      m[hi] = mx[hi];
      l[hi] *= corr[hi];
    }

    // P = exp2(s - m) in f32 for the row sum, bf16 in the A fragments of
    // P.V: k-step kk takes keys 16 kk .. 16 kk + 15
    uint32_t p[4][4];
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int half = 0; half < 2; ++half)
#pragma unroll
        for (int hi = 0; hi < 2; ++hi) {
          const int i = 4 * (2 * kk + half) + 2 * hi;
          const float p0 = exp2f(s[i] - m[hi]);
          const float p1 = exp2f(s[i + 1] - m[hi]);
          l[hi] += p0 + p1;
          p[kk][2 * half + hi] = pack_bf16(p0, p1);
        }
#pragma unroll
    for (int i = 0; i < DH / 2; ++i) o[i] *= corr[(i >> 1) & 1];

    // O += P V
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) wgmma_rs<DH>(o, p[kk], TL::mnmajor(vs, kk));
    wgmma_commit();
    wgmma_wait_all();
    keep(o);
    keep(p);
    k0 = k_next;
  }

#pragma unroll
  for (int hi = 0; hi < 2; ++hi) {
    l[hi] += __shfl_xor_sync(0xffffffffu, l[hi], 1);
    l[hi] += __shfl_xor_sync(0xffffffffu, l[hi], 2);
  }
  if (lse != nullptr && t4 == 0) {
#pragma unroll
    for (int hi = 0; hi < 2; ++hi) {
      const int q = q0 + row + 8 * hi;
      if (q < n) lse[((long long)b * gridDim.y + h) * n + q] = m[hi] * LN2 + logf(l[hi]);
    }
  }
  __syncthreads();  // every warp is done with the Q tile: it stages the output
  stage_fragment<DH>(sm + L::Q, o, row, t4, 1.0f / l[0], 1.0f / l[1]);
  __syncthreads();
  store_tile<DH>(sm + L::Q, out + (long long)b * out_bstride + h * DH, q0, n, out_rstride);
}

template <int DH, int MODE>
static cudaError_t launch(const Operands& in, const int32_t* types, const int32_t* active, int nt, bf16* out,
                          float* lse, int batch, int n, int heads, long long out_bstride, long long out_rstride,
                          long long types_bstride, float scale, int fusion_type, cudaStream_t stream) {
  static std::atomic<unsigned> ready{0};
  auto kernel = zorro_attention_kernel<DH, MODE>;
  const size_t bytes = FwdSmem<DH>::BYTES;
  cudaError_t err = allow_smem((const void*)kernel, bytes, ready);
  if (err != cudaSuccess) return err;
  dim3 grid((n + BQ - 1) / BQ, heads, batch);
  kernel<<<grid, THREADS, bytes, stream>>>(in, types, active, nt, out, lse, n, out_bstride, out_rstride,
                                           types_bstride, scale, fusion_type);
  return cudaGetLastError();
}

template <int MODE>
cudaError_t dispatch(int dh, const Operands& in, const int32_t* types, const int32_t* active, int nt,
                     bf16* out, float* lse, int batch, int n, int heads, long long out_bstride,
                     long long out_rstride, long long types_bstride, float scale, int fusion_type,
                     cudaStream_t stream) {
  switch (dh) {
    case 32:
      return launch<32, MODE>(in, types, active, nt, out, lse, batch, n, heads, out_bstride, out_rstride,
                              types_bstride, scale, fusion_type, stream);
    case 64:
      return launch<64, MODE>(in, types, active, nt, out, lse, batch, n, heads, out_bstride, out_rstride,
                              types_bstride, scale, fusion_type, stream);
    case 128:
      return launch<128, MODE>(in, types, active, nt, out, lse, batch, n, heads, out_bstride, out_rstride,
                               types_bstride, scale, fusion_type, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

// ---------------------------------------------------------------------------
// Backward (K1b)
// ---------------------------------------------------------------------------

// Shared memory of the dq kernel: [Q][dO][K0][V0][K1][V1][key types 0]
// [key types 1][D][lse]
template <int DH>
struct DqSmem {
  static constexpr uint32_t T = Tile<DH>::BYTES;
  static constexpr uint32_t Q = 0, DO = T, K = 2 * T, V = 3 * T, STAGE = 2 * T, TYPES = 6 * T;
  static constexpr uint32_t D = 6 * T + 512, LSE = 6 * T + 768;
  static constexpr size_t BYTES = 6 * T + 1024 + 1024;
};

// Block (query tile, head, batch row): D for its rows, then dQ over all key
// tiles. o and dout are contiguous [B, N, H * DH]. With delta_given, D is
// read from delta (and o is not read); else D = rowsum(dO * O) in f32
// (pallas_attn.py:552), two threads a row, is computed here and stored to
// delta for the dk/dv kernel.
template <int DH, int MODE>
__global__ void __launch_bounds__(THREADS)
zorro_attention_dq_kernel(Operands in, const int32_t* __restrict__ types, const int32_t* __restrict__ active,
                          int nt, const bf16* __restrict__ o, const float* __restrict__ lse,
                          const bf16* __restrict__ dout, GradOperands grad, float* __restrict__ delta,
                          int delta_given, int n, long long types_bstride, float scale, int fusion_type) {
  using L = DqSmem<DH>;
  using TL = Tile<DH>;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* sm;
  const uint32_t sa = aligned_smem(smem_raw, &sm);
  const int q0 = blockIdx.x * BQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int lane = threadIdx.x % 32;
  const int t4 = lane & 3;
  const int row = (threadIdx.x / 32) * 16 + lane / 4;
  const int inner = gridDim.y * DH;
  const bf16* kg = in.k + (long long)b * in.bstride + h * DH;
  const bf16* vg = in.v + (long long)b * in.bstride + h * DH;
  const bf16* dog = dout + (long long)b * n * inner + h * DH;
  const int32_t* tg = types + (long long)b * types_bstride;
  const long long lse_row = ((long long)b * gridDim.y + h) * n;
  const float sl2 = scale * LOG2E;

  auto load_kv = [&](int k0, int stage) {
    load_tile<DH>(sa + L::K + stage * L::STAGE, kg, k0, n, in.rstride);
    load_tile<DH>(sa + L::V + stage * L::STAGE, vg, k0, n, in.rstride);
    if (MODE == MODE_ZORRO) load_values(sa + L::TYPES + stage * 256, tg, k0, n);
  };

  int k0 = next_key_tile(active, nt, b, q0, 0, n);
  load_tile<DH>(sa + L::Q, in.q + (long long)b * in.bstride + h * DH, q0, n, in.rstride);
  load_tile<DH>(sa + L::DO, dog, q0, n, inner);
  load_kv(k0, 0);
  cp_async_commit();

  {  // D and lse (in log2 units) of the tile's rows, two threads a row
    const int r = threadIdx.x >> 1;
    const int half = threadIdx.x & 1;
    const int q = q0 + r;
    float part = 0.0f;
    if (q < n && !delta_given) {
      const uint4* a = reinterpret_cast<const uint4*>(dog + (long long)q * inner + half * (DH / 2));
      const uint4* c = reinterpret_cast<const uint4*>(o + (long long)b * n * inner + h * DH + (long long)q * inner +
                                                      half * (DH / 2));
#pragma unroll
      for (int u = 0; u < DH / 16; ++u) {
        const uint4 x = a[u], y = c[u];
        const __nv_bfloat162* xa = reinterpret_cast<const __nv_bfloat162*>(&x);
        const __nv_bfloat162* ya = reinterpret_cast<const __nv_bfloat162*>(&y);
#pragma unroll
        for (int w = 0; w < 4; ++w) {
          const float2 xf = __bfloat1622float2(xa[w]), yf = __bfloat1622float2(ya[w]);
          part += xf.x * yf.x + xf.y * yf.y;
        }
      }
    }
    part += __shfl_xor_sync(0xffffffffu, part, 1);
    if (half == 0) {
      float* s_d = reinterpret_cast<float*>(sm + L::D);
      float* s_lse = reinterpret_cast<float*>(sm + L::LSE);
      if (q < n && !delta_given) delta[lse_row + q] = part;
      s_d[r] = q < n ? (delta_given ? delta[lse_row + q] : part) : 0.0f;
      s_lse[r] = q < n ? lse[lse_row + q] * LOG2E : 0.0f;
    }
  }
  __syncthreads();
  int tq[2];
  bool q_in[2];
  float d_row[2], lse2[2];
#pragma unroll
  for (int hi = 0; hi < 2; ++hi) {
    const int q = q0 + row + 8 * hi;
    q_in[hi] = q < n;
    tq[hi] = (MODE == MODE_ZORRO && q_in[hi]) ? tg[q] : PAD_TYPE;
    d_row[hi] = reinterpret_cast<const float*>(sm + L::D)[row + 8 * hi];
    lse2[hi] = reinterpret_cast<const float*>(sm + L::LSE)[row + 8 * hi];
  }
  float dq[DH / 2];
#pragma unroll
  for (int i = 0; i < DH / 2; ++i) dq[i] = 0.0f;

  for (int stage = 0; k0 < n; stage ^= 1) {
    cp_async_wait_all();
    fence_async_smem();
    __syncthreads();
    const int k_next = next_key_tile(active, nt, b, q0, k0 + BK, n);
    if (k_next < n) {
      load_kv(k_next, stage ^ 1);
      cp_async_commit();
    }
    const uint32_t ks = sa + L::K + stage * L::STAGE;
    const uint32_t vs = sa + L::V + stage * L::STAGE;

    // S = Q K^T and dP = dO V^T, f32 in registers, two groups: P is
    // computed while dP is still in flight
    float s[32], dp[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) s[i] = dp[i] = 0.0f;
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < DH / 16; ++kk) wgmma_ss_n64(s, TL::kmajor(sa + L::Q, kk), TL::kmajor(ks, kk), 1);
    wgmma_commit();
#pragma unroll
    for (int kk = 0; kk < DH / 16; ++kk) wgmma_ss_n64(dp, TL::kmajor(sa + L::DO, kk), TL::kmajor(vs, kk), 1);
    wgmma_commit();
    wgmma_wait_one();
    keep(s);

    // P = exp2(s masked - lse) in place of s; column c is key k0 + c
    const int* tk = reinterpret_cast<const int*>(sm + L::TYPES + stage * 256);
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int c = 8 * j + 2 * t4 + e;
        const int t_k = MODE == MODE_ZORRO ? tk[c] : 0;
#pragma unroll
        for (int hi = 0; hi < 2; ++hi) {
          const int i = 4 * j + 2 * hi + e;
          const float x = masked_score<MODE>(s[i] * sl2, tq[hi], t_k, fusion_type);
          s[i] = (q_in[hi] && k0 + c < n) ? exp2f(x - lse2[hi]) : 0.0f;
        }
      }

    // dS = P (dP - D) cast to bf16, in the A fragments of dS.K
    wgmma_wait_all();
    keep(dp);
    uint32_t ds[4][4];
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int half = 0; half < 2; ++half)
#pragma unroll
        for (int hi = 0; hi < 2; ++hi) {
          const int i = 4 * (2 * kk + half) + 2 * hi;
          ds[kk][2 * half + hi] = pack_bf16(s[i] * (dp[i] - d_row[hi]), s[i + 1] * (dp[i + 1] - d_row[hi]));
        }

    // dQ += dS K
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) wgmma_rs<DH>(dq, ds[kk], TL::mnmajor(ks, kk));
    wgmma_commit();
    wgmma_wait_all();
    keep(dq);
    keep(ds);
    k0 = k_next;
  }
  __syncthreads();  // the Q tile stages dQ
  stage_fragment<DH>(sm + L::Q, dq, row, t4, scale, scale);
  __syncthreads();
  store_tile<DH>(sm + L::Q, grad.q + (long long)b * grad.bstride + h * DH, q0, n, grad.rstride);
}

// Shared memory of the dk/dv kernel: [K][V][Q0][dO0][Q1][dO1], then per
// stage the query types, lse and D of its query tile
template <int DH>
struct DkdvSmem {
  static constexpr uint32_t T = Tile<DH>::BYTES;
  static constexpr uint32_t K = 0, V = T, Q = 2 * T, DO = 3 * T, STAGE = 2 * T;
  static constexpr uint32_t ROWS = 6 * T, ROWS_STAGE = 768;  // types +0, lse +256, D +512
  static constexpr size_t BYTES = 6 * T + 2 * 768 + 1024;
};

// Blocks of the dk/dv kernel an SM is to hold at least: 3, which caps a
// thread at 168 registers, for the instantiations that fit in that many
// without spilling (dh 32; dh 64 with the mask, which takes about 190
// uncapped and so would hold 2); no cap for the others.
constexpr int dkdv_min_blocks(int dh, int mode) { return dh == 32 || (dh == 64 && mode == MODE_ZORRO) ? 3 : 1; }

// Block (key tile, head, batch row): dK and dV over all query tiles, with
// the D of the dq kernel. The products run with the keys as rows: S^T =
// K Q^T and dP^T = V dO^T, then dV += P^T dO and dK += dS^T Q.
template <int DH, int MODE>
__global__ void __launch_bounds__(THREADS, dkdv_min_blocks(DH, MODE))
zorro_attention_dkdv_kernel(Operands in, const int32_t* __restrict__ types, const int32_t* __restrict__ active,
                            int nt, const float* __restrict__ lse, const bf16* __restrict__ dout,
                            const float* __restrict__ delta, GradOperands grad, int n, long long types_bstride,
                            float scale, int fusion_type) {
  using L = DkdvSmem<DH>;
  using TL = Tile<DH>;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* sm;
  const uint32_t sa = aligned_smem(smem_raw, &sm);
  const int k0 = blockIdx.x * BK;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int lane = threadIdx.x % 32;
  const int t4 = lane & 3;
  const int row = (threadIdx.x / 32) * 16 + lane / 4;  // this thread's keys: k0 + row and k0 + row + 8
  const int inner = gridDim.y * DH;
  const bf16* qg = in.q + (long long)b * in.bstride + h * DH;
  const bf16* dog = dout + (long long)b * n * inner + h * DH;
  const int32_t* tg = types + (long long)b * types_bstride;
  const long long lse_row = ((long long)b * gridDim.y + h) * n;
  const float sl2 = scale * LOG2E;

  auto load_q = [&](int q0, int stage) {
    load_tile<DH>(sa + L::Q + stage * L::STAGE, qg, q0, n, in.rstride);
    load_tile<DH>(sa + L::DO + stage * L::STAGE, dog, q0, n, inner);
    const uint32_t rows = sa + L::ROWS + stage * L::ROWS_STAGE;
    if (MODE == MODE_ZORRO) load_values(rows, tg, q0, n);
    load_values(rows + 256, lse + lse_row, q0, n);
    load_values(rows + 512, delta + lse_row, q0, n);
  };

  int q0 = next_query_tile(active, nt, b, 0, k0, n);  // the diagonal tile is always active
  load_tile<DH>(sa + L::K, in.k + (long long)b * in.bstride + h * DH, k0, n, in.rstride);
  load_tile<DH>(sa + L::V, in.v + (long long)b * in.bstride + h * DH, k0, n, in.rstride);
  load_q(q0, 0);
  cp_async_commit();

  int tk[2];
  bool k_in[2];
#pragma unroll
  for (int hi = 0; hi < 2; ++hi) {
    const int k = k0 + row + 8 * hi;
    k_in[hi] = k < n;
    tk[hi] = (MODE == MODE_ZORRO && k_in[hi]) ? tg[k] : PAD_TYPE;
  }
  float dk[DH / 2], dv[DH / 2];
#pragma unroll
  for (int i = 0; i < DH / 2; ++i) dk[i] = dv[i] = 0.0f;

  for (int stage = 0; q0 < n; stage ^= 1) {
    cp_async_wait_all();
    fence_async_smem();
    __syncthreads();
    const int q_next = next_query_tile(active, nt, b, q0 + BQ, k0, n);
    if (q_next < n) {
      load_q(q_next, stage ^ 1);
      cp_async_commit();
    }
    const uint32_t qs = sa + L::Q + stage * L::STAGE;
    const uint32_t dos = sa + L::DO + stage * L::STAGE;

    // S^T = K Q^T and dP^T = V dO^T, f32 in registers, two groups: P^T
    // is computed while dP^T is still in flight
    float s[32], dp[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) s[i] = dp[i] = 0.0f;
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < DH / 16; ++kk) wgmma_ss_n64(s, TL::kmajor(sa + L::K, kk), TL::kmajor(qs, kk), 1);
    wgmma_commit();
#pragma unroll
    for (int kk = 0; kk < DH / 16; ++kk) wgmma_ss_n64(dp, TL::kmajor(sa + L::V, kk), TL::kmajor(dos, kk), 1);
    wgmma_commit();
    wgmma_wait_one();
    keep(s);

    // P^T = exp2(s masked - lse) in place of s; column c is query q0 + c
    const unsigned char* rows = sm + L::ROWS + stage * L::ROWS_STAGE;
    const int* tq = reinterpret_cast<const int*>(rows);
    const float* lse_q = reinterpret_cast<const float*>(rows + 256);
    const float* d_q = reinterpret_cast<const float*>(rows + 512);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int half = 0; half < 2; ++half)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int c = 16 * kk + 8 * half + 2 * t4 + e;
          const int t_q = MODE == MODE_ZORRO ? tq[c] : 0;
          const float l2 = lse_q[c] * LOG2E;
#pragma unroll
          for (int hi = 0; hi < 2; ++hi) {
            const int i = 4 * (2 * kk + half) + 2 * hi + e;
            const float x = masked_score<MODE>(s[i] * sl2, t_q, tk[hi], fusion_type);
            s[i] = (k_in[hi] && q0 + c < n) ? exp2f(x - l2) : 0.0f;
          }
        }

    // P^T and dS^T = P^T (dP^T - D), each cast to bf16 in the A fragments
    // of dV += P^T dO and dK += dS^T Q
    wgmma_wait_all();
    keep(dp);
    uint32_t pt[4][4], dst[4][4];
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int c = 16 * kk + 8 * half + 2 * t4;
        const float d0 = d_q[c], d1 = d_q[c + 1];
#pragma unroll
        for (int hi = 0; hi < 2; ++hi) {
          const int i = 4 * (2 * kk + half) + 2 * hi;
          pt[kk][2 * half + hi] = pack_bf16(s[i], s[i + 1]);
          dst[kk][2 * half + hi] = pack_bf16(s[i] * (dp[i] - d0), s[i + 1] * (dp[i + 1] - d1));
        }
      }
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) wgmma_rs<DH>(dv, pt[kk], TL::mnmajor(dos, kk));
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) wgmma_rs<DH>(dk, dst[kk], TL::mnmajor(qs, kk));
    wgmma_commit();
    wgmma_wait_all();
    keep(dv);
    keep(dk);
    keep(pt);
    keep(dst);
    q0 = q_next;
  }
  __syncthreads();  // the K and V tiles stage dK and dV
  stage_fragment<DH>(sm + L::K, dk, row, t4, scale, scale);
  stage_fragment<DH>(sm + L::V, dv, row, t4, 1.0f, 1.0f);
  __syncthreads();
  store_tile<DH>(sm + L::K, grad.k + (long long)b * grad.bstride + h * DH, k0, n, grad.rstride);
  store_tile<DH>(sm + L::V, grad.v + (long long)b * grad.bstride + h * DH, k0, n, grad.rstride);
}

template <int DH, int MODE>
static cudaError_t launch_bwd(const Operands& in, const int32_t* types, const int32_t* active, int nt,
                              const bf16* o, const float* lse, const bf16* dout, const GradOperands& grad,
                              float* delta, int delta_given, int batch, int n, int heads, long long types_bstride,
                              float scale, int fusion_type, cudaStream_t stream) {
  static std::atomic<unsigned> dq_ready{0}, dkdv_ready{0};
  auto dq_kernel = zorro_attention_dq_kernel<DH, MODE>;
  auto dkdv_kernel = zorro_attention_dkdv_kernel<DH, MODE>;
  const size_t dq_bytes = DqSmem<DH>::BYTES, dkdv_bytes = DkdvSmem<DH>::BYTES;
  cudaError_t err = allow_smem((const void*)dq_kernel, dq_bytes, dq_ready);
  if (err != cudaSuccess) return err;
  err = allow_smem((const void*)dkdv_kernel, dkdv_bytes, dkdv_ready);
  if (err != cudaSuccess) return err;
  dim3 grid((n + BQ - 1) / BQ, heads, batch);
  dq_kernel<<<grid, THREADS, dq_bytes, stream>>>(in, types, active, nt, o, lse, dout, grad, delta, delta_given,
                                                 n, types_bstride, scale, fusion_type);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  dkdv_kernel<<<grid, THREADS, dkdv_bytes, stream>>>(in, types, active, nt, lse, dout, delta, grad, n,
                                                     types_bstride, scale, fusion_type);
  return cudaGetLastError();
}

template <int MODE>
cudaError_t dispatch_bwd(int dh, const Operands& in, const int32_t* types, const int32_t* active, int nt,
                         const bf16* o, const float* lse, const bf16* dout, const GradOperands& grad,
                         float* delta, int delta_given, int batch, int n, int heads, long long types_bstride,
                         float scale, int fusion_type, cudaStream_t stream) {
  switch (dh) {
    case 32:
      return launch_bwd<32, MODE>(in, types, active, nt, o, lse, dout, grad, delta, delta_given, batch, n,
                                  heads, types_bstride, scale, fusion_type, stream);
    case 64:
      return launch_bwd<64, MODE>(in, types, active, nt, o, lse, dout, grad, delta, delta_given, batch, n,
                                  heads, types_bstride, scale, fusion_type, stream);
    case 128:
      return launch_bwd<128, MODE>(in, types, active, nt, o, lse, dout, grad, delta, delta_given, batch, n,
                                   heads, types_bstride, scale, fusion_type, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace zorro
