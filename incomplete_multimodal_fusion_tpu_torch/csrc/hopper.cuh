// PTX helpers for Hopper (sm_90a) shared by the hand-written kernels:
// asynchronous copies (cp.async), wgmma with its shared-memory descriptors
// (bf16, and TF32 with the 3xTF32 split of f32 operands), the hardware's
// 128- and 64-byte swizzled tile layouts, the kernel attributes set once per
// device, and the SM count. Used by zorro_attention.cuh (K1 / K1b),
// zorro_attention_f32.cuh (their f32 instance), fused_ffn.cu (K2), wgrad.cuh and
// fused_ffn_bwd.cu (K2b, and K6b through wgrad.cuh), ms_deform_attn.cu (K4b)
// and point_sample.cu (K5).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>

namespace hopper {

using bf16 = __nv_bfloat16;

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

template <int N>
__device__ __forceinline__ void keep(uint32_t (&a)[N][4]) {
#pragma unroll
  for (int i = 0; i < N; ++i)
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

// D[64, N] += A[64, 16] . B[16, N], A (bf16 pairs) from registers, B
// MN-major in shared memory; N = 32, 64, 128 (wgmma_rs<N> picks one).
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

// (wgmma_rs_n64<0>: B K-major instead)
template <int TB = 1>
__device__ __forceinline__ void wgmma_rs_n64(float (&d)[32], const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %38, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, %37;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "n"(TB), "r"(1));
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

// Waits until at most N committed groups of this thread's copies are in
// flight (the groups complete in order).
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// D[64, 32] += A[64, 16] . B[16, 32], both from shared memory; TA / TB:
// A / B MN-major (the descriptor's transpose bit) rather than K-major.
template <int TA, int TB>
__device__ __forceinline__ void wgmma_ss_n32(float (&d)[16], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %20, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15"
      "}, "
      "%16, %17, p, 1, 1, %18, %19;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "l"(da), "l"(db), "n"(TA), "n"(TB), "r"(1));
}

// D[64, 64] += A[64, 16] . B[16, 64], both from shared memory, K-major
// unless the transpose bits TA / TB say MN-major, as in wgmma_ss_n32.
template <int TA = 0, int TB = 0>
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[32], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %36, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, "
      "%32, %33, p, 1, 1, %34, %35;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "n"(TA), "n"(TB), "r"(1));
}

// D[64, 128] += A[64, 16] . B[16, 128], both from shared memory, K-major
// unless the transpose bits TA / TB say MN-major, as in wgmma_ss_n64.
template <int TA = 0, int TB = 0>
__device__ __forceinline__ void wgmma_ss_n128(float (&d)[64], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %68, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, "
      "%64, %65, p, 1, 1, %66, %67;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "n"(TA), "n"(TB), "r"(1));
}

// Tiles of `rows` rows of bf16 in the 128-byte swizzle: the columns in
// blocks of 64 (128 bytes a row), each block `rows` x 128 bytes, the 16-byte
// chunks of row r xor-swizzled by (r & 7). rows is a multiple of 8 and the
// tile starts on a 1024-byte boundary. The same bytes serve as a K-major
// operand (rows = M or N, columns = K) and as an MN-major one (rows = K,
// columns = M or N).
struct Sw128 {
  // byte offset of chunk c (columns 8c .. 8c + 7) of row r
  static __device__ __forceinline__ uint32_t offset(int r, int c, int rows) {
    return (c >> 3) * (rows * 128) + r * 128 + (((c & 7) ^ (r & 7)) << 4);
  }
  // K-major operand: 64 (A) or N (B) rows from `base`, columns 16 kk ..
  // 16 kk + 15
  static __device__ __forceinline__ uint64_t kmajor(uint32_t base, int rows, int kk) {
    return gmma_desc(base + (kk >> 2) * (rows * 128) + (kk & 3) * 32, 16, 1024, 1);
  }
  // MN-major operand: rows 16 kk .. 16 kk + 15 as K, the columns of the
  // 64-column block at `base` (and the next blocks, `rows` * 128 bytes on)
  // as M or N
  static __device__ __forceinline__ uint64_t mnmajor(uint32_t base, int rows, int kk) {
    return gmma_desc(base + kk * 16 * 128, rows * 128, 1024, 1);
  }
};

// Tiles of 32 bf16 columns (64 bytes a row) in the 64-byte swizzle: chunk c
// of row r at r * 64 + ((c ^ ((r >> 1) & 3)) << 4).
struct Sw64 {
  static __device__ __forceinline__ uint32_t offset(int r, int c) { return r * 64 + ((c ^ ((r >> 1) & 3)) << 4); }
  // K-major operand: 64 (A) or N (B) rows from `base`, columns 16 kk ..
  // 16 kk + 15 (kk < 2)
  static __device__ __forceinline__ uint64_t kmajor(uint32_t base, int kk) {
    return gmma_desc(base + kk * 32, 16, 512, 2);
  }
  // MN-major operand: rows 16 kk .. 16 kk + 15 as K, the 32 columns as N
  static __device__ __forceinline__ uint64_t mnmajor(uint32_t base, int kk) {
    return gmma_desc(base + kk * 16 * 64, 4096, 512, 2);
  }
};

// cudaFuncSetAttribute for the largest L1 (no shared memory carve-out) of
// `kernel` on the current device, once, as allow_smem.
inline cudaError_t allow_l1(const void* kernel, std::atomic<unsigned>& ready) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  const unsigned bit = 1u << (dev & 31);
  if (ready.load(std::memory_order_relaxed) & bit) return cudaSuccess;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributePreferredSharedMemoryCarveout, 0);
  if (err == cudaSuccess) ready.fetch_or(bit);
  return err;
}

// The SMs of the current device, read once (a static of this internal
// function: one per library).
static int sm_count() {
  static std::atomic<int> count{0};
  int c = count.load(std::memory_order_relaxed);
  if (c == 0) {
    int dev = 0;
    if (cudaGetDevice(&dev) != cudaSuccess ||
        cudaDeviceGetAttribute(&c, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess || c < 1)
      c = 132;
    count.store(c, std::memory_order_relaxed);
  }
  return c;
}


// ---------------------------------------------------------------------------
// f32 products on the tensor cores in three TF32 parts (3xTF32)
// ---------------------------------------------------------------------------
//
// An f32 operand x is split once into x = hi + lo, each a TF32 value (an
// f32 bit pattern with its low 13 mantissa bits zero): hi = rna(x), lo =
// rna(x - hi), both by cvt.rna (round to nearest, ties away; x - hi is exact
// in f32). A product A B is then Ahi Bhi + Ahi Blo + Alo Bhi into one f32
// accumulator: what it leaves out, Alo Blo and the rounding of lo, is about
// 2^-22 of each term, close to f32's own rounding, where one TF32 product
// keeps about three digits. wgmma reads TF32 operands only K-major from
// shared memory (its transpose bits exist for 16-bit types only), so a B
// operand whose contraction index is a tile's row index is staged
// transposed.

// x rounded to TF32 (cvt.rna), as f32 bits
__device__ __forceinline__ uint32_t to_tf32(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(x));
  return r;
}

// x = hi + lo, both TF32
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi, uint32_t& lo) {
  hi = to_tf32(x);
  lo = to_tf32(x - __uint_as_float(hi));
}

__device__ __forceinline__ void split_tf32(const float4& x, uint4& hi, uint4& lo) {
  split_tf32(x.x, hi.x, lo.x);
  split_tf32(x.y, hi.y, lo.y);
  split_tf32(x.z, hi.z, lo.z);
  split_tf32(x.w, hi.w, lo.w);
}

// D[64, N] += A[64, 8] . B[8, N] in TF32, A and B K-major in shared memory
// (wgmma_tf32_ss<N>); A from registers (wgmma_tf32_rs<N>): a thread's four
// values of A are rows (g, g + 8) x columns (t, t + 4) of its warp's 16
// rows, g = lane / 4, t = lane % 4, in the order (g, t), (g + 8, t),
// (g, t + 4), (g + 8, t + 4).

__device__ __forceinline__ void wgmma_tf32_ss_n16(float (&d)[8], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %10, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k8.f32.tf32.tf32 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7"
      "}, "
      "%8, %9, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
      : "l"(da), "l"(db), "r"(1));
}

__device__ __forceinline__ void wgmma_tf32_ss_n32(float (&d)[16], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15"
      "}, "
      "%16, %17, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "l"(da), "l"(db), "r"(1));
}

__device__ __forceinline__ void wgmma_tf32_ss_n64(float (&d)[32], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, "
      "%32, %33, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(1));
}

__device__ __forceinline__ void wgmma_tf32_rs_n32(float (&d)[16], const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15"
      "}, "
      "{%16, %17, %18, %19}, %20, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

__device__ __forceinline__ void wgmma_tf32_rs_n64(float (&d)[32], const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

__device__ __forceinline__ void wgmma_tf32_rs_n128(float (&d)[64], const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1;\n}\n"
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


template <int N>
__device__ __forceinline__ void wgmma_tf32_ss(float (&d)[N / 2], uint64_t da, uint64_t db) {
  if constexpr (N == 16)
    wgmma_tf32_ss_n16(d, da, db);
  else if constexpr (N == 32)
    wgmma_tf32_ss_n32(d, da, db);
  else
    wgmma_tf32_ss_n64(d, da, db);
}

template <int N>
__device__ __forceinline__ void wgmma_tf32_rs(float (&d)[N / 2], const uint32_t (&a)[4], uint64_t db) {
  if constexpr (N == 32)
    wgmma_tf32_rs_n32(d, a, db);
  else if constexpr (N == 64)
    wgmma_tf32_rs_n64(d, a, db);
  else
    wgmma_tf32_rs_n128(d, a, db);
}

// One k-step of 8 of D += A B in 3xTF32, A and B from shared memory as the
// descriptors of their hi and lo tiles: the two small products first
template <int N>
__device__ __forceinline__ void mma3_ss(float (&d)[N / 2], uint64_t a_hi, uint64_t a_lo, uint64_t b_hi,
                                        uint64_t b_lo) {
  wgmma_tf32_ss<N>(d, a_hi, b_lo);
  wgmma_tf32_ss<N>(d, a_lo, b_hi);
  wgmma_tf32_ss<N>(d, a_hi, b_hi);
}

// The same with A from registers (its hi and lo fragments)
template <int N>
__device__ __forceinline__ void mma3_rs(float (&d)[N / 2], const uint32_t (&a_hi)[4], const uint32_t (&a_lo)[4],
                                        uint64_t b_hi, uint64_t b_lo) {
  wgmma_tf32_rs<N>(d, a_hi, b_lo);
  wgmma_tf32_rs<N>(d, a_lo, b_hi);
  wgmma_tf32_rs<N>(d, a_hi, b_hi);
}

// An R x C f32 tile in shared memory as wgmma reads a TF32 K-major operand
// (rows = M or N, columns = K): the 128-byte swizzle (Sw128's layout,
// columns in blocks of 32), or for C = 16, where a row is 64 bytes, the
// 64-byte one (Sw64's). A k-step of 8 TF32 values is 32 bytes, as one of 16
// bf16, so the descriptors are the bf16 tiles'. Starts on a 1024-byte
// boundary. (The formulas are written out here: calling Sw128 / Sw64 from
// these kernels changed the PTX nvcc made of the bf16 kernels beside them.)
template <int R, int C>
struct Tf32Tile {
  static constexpr uint32_t BYTES = R * C * 4;
  // byte offset of chunk c (columns 4c .. 4c + 3) of row r
  static __device__ __forceinline__ uint32_t offset(int r, int c) {
    if constexpr (C == 16) return r * 64 + ((c ^ ((r >> 1) & 3)) << 4);
    else return (c >> 3) * (R * 128) + r * 128 + (((c & 7) ^ (r & 7)) << 4);
  }
  // the K-major operand of k-step kk (columns 8 kk .. 8 kk + 7)
  static __device__ __forceinline__ uint64_t kmajor(uint32_t base, int kk) {
    if constexpr (C == 16) return gmma_desc(base + kk * 32, 16, 512, 2);
    else return gmma_desc(base + (kk >> 2) * (R * 128) + (kk & 3) * 32, 16, 1024, 1);
  }
  // where rows r .. of a B operand start (r a multiple of 8): kmajor(base +
  // rows(r), kk) reads the N rows from row r
  static __host__ __device__ constexpr uint32_t rows(int r) { return r * (C == 16 ? 64 : 128); }
};

}  // namespace hopper
