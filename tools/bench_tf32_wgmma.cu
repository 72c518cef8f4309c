// The throughput of TF32 wgmma on one card, the product K1 / K1b's f32
// instance (csrc/zorro_attention_f32.cuh) is built on: CHAINS independent
// accumulators of m64nNk8, A and B from shared memory (SS) or A from
// registers (RS), issued round robin in batches of 24 and waited for after
// each batch, from 1, 2 or 4 one-warpgroup blocks a SM on every SM. Prints
// TFLOP/s and ns a wgmma a SM for each.
//
//     nvcc -gencode arch=compute_90a,code=sm_90a -O3 -std=c++17 \
//         -o build/bench_tf32_wgmma tools/bench_tf32_wgmma.cu && build/bench_tf32_wgmma
#include <cstdio>

#include "../incomplete_multimodal_fusion_tpu_torch/csrc/hopper.cuh"
using namespace hopper;

template <int N, int CHAINS, bool RS, int BATCH>
__global__ void __launch_bounds__(128) bench(float* out, int iters) {
  extern __shared__ unsigned char raw[];
  unsigned char* sm;
  const uint32_t sa = aligned_smem(raw, &sm);
  for (int i = threadIdx.x; i < (64 * 32 + N * 32); i += 128) reinterpret_cast<float*>(sm)[i] = 0.001f * (i % 7);
  fence_async_smem();
  __syncthreads();
  float acc[CHAINS][N / 2];
#pragma unroll
  for (int c = 0; c < CHAINS; ++c)
#pragma unroll
    for (int i = 0; i < N / 2; ++i) acc[c][i] = 0.0f;
  uint32_t a[4] = {threadIdx.x, threadIdx.x + 1, threadIdx.x + 2, threadIdx.x + 3};
  for (int it = 0; it < iters; ++it) {
    wgmma_fence();
#pragma unroll
    for (int k = 0; k < BATCH / CHAINS; ++k)
#pragma unroll
      for (int c = 0; c < CHAINS; ++c) {
        const uint64_t db = Tf32Tile<N, 32>::kmajor(sa + 64 * 32 * 4, k & 3);
        if constexpr (RS) wgmma_tf32_rs<N>(acc[c], a, db);
        else wgmma_tf32_ss<N>(acc[c], Tf32Tile<64, 32>::kmajor(sa, k & 3), db);
      }
    wgmma_commit();
    wgmma_wait_all();
#pragma unroll
    for (int c = 0; c < CHAINS; ++c) keep(acc[c]);
  }
  float s = 0.0f;
#pragma unroll
  for (int c = 0; c < CHAINS; ++c)
#pragma unroll
    for (int i = 0; i < N / 2; ++i) s += acc[c][i];
  out[blockIdx.x * 128 + threadIdx.x] = s;
}

template <int N, int CHAINS, bool RS>
void run(int per_sm, float* out) {
  const int iters = 2000, batch = 24;
  auto k = bench<N, CHAINS, RS, 24>;
  const int bytes = (64 * 32 + N * 32) * 4 + 1024;
  cudaFuncSetAttribute(k, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  const int blocks = 132 * per_sm;
  k<<<blocks, 128, bytes>>>(out, 10);
  cudaEvent_t a, b;
  cudaEventCreate(&a);
  cudaEventCreate(&b);
  cudaEventRecord(a);
  k<<<blocks, 128, bytes>>>(out, iters);
  cudaEventRecord(b);
  cudaEventSynchronize(b);
  float ms = 0;
  cudaEventElapsedTime(&ms, a, b);
  const double flops = 2.0 * 64 * N * 8 * batch * (double)iters * blocks;
  printf("[wgmma tf32] %s m64n%dk8, %d chain(s), %d block(s) an SM: %.1f TFLOP/s, %.1f ns a wgmma an SM (err %s)\n",
         RS ? "RS" : "SS", N, CHAINS, per_sm, flops / ms / 1e9, ms * 1e6 / ((double)iters * batch * per_sm),
         cudaGetErrorString(cudaGetLastError()));
}

int main() {
  float* out;
  cudaMalloc(&out, 132 * 8 * 128 * 4);
  for (int per_sm : {1, 2, 4}) {
    run<64, 1, false>(per_sm, out);
    run<64, 2, false>(per_sm, out);
    run<64, 4, false>(per_sm, out);
    run<64, 1, true>(per_sm, out);
    run<64, 2, true>(per_sm, out);
    run<32, 1, false>(per_sm, out);
    run<32, 2, false>(per_sm, out);
    run<128, 1, true>(per_sm, out);
  }
  return 0;
}
