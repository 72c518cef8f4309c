// K2: fused_ffn -- the two-product feed-forward with its hidden activation
// kept on chip, in two modes of one kernel family:
//   GEGLU: bias-less LayerNorm in f32 (eps 1e-5, weight gamma) -> cast to
//          bf16 -> u = xn . W_in^T ([M, 2I], f32 accumulation) ->
//          a = val * gelu(gate) (exact erf) -> cast to bf16 -> y = a . W_out^T
//   MLP:   h = x . W1^T + b1 -> gelu (exact erf) -> cast to bf16 ->
//          y = a . W2^T + b2
// Weights arrive in nn.Linear layout ([out, in]), so both products read
// their B operand K-contiguous (col_major fragments) straight from global
// memory, where the L2 cache holds them for every block.
//
// Replaces two Pallas TPU kernels of the JAX package:
//   * ops/pallas_ffn.py _fwd_kernel (pallas_call in _ffn_fwd_impl): the
//     LayerNorm+GEGLU FF of every EncoderBlock and FusionBlockFast;
//   * ops/pallas_ffn.py _mlp_fwd_kernel (pallas_call in _mlp_fwd_impl): the
//     decoder ViT blocks' MLP.
// Cast points are those of the Pallas bodies: LN output (pallas_ffn.py:106),
// the GEGLU product (:112), the MLP's gelu output (:298).
//
// What bounds it on an H100: per row the two products are 2 * 2 * d * I
// flops (GEGLU d = 192, I = 512: 0.8 MFLOP a row) against 4 * d bytes in and
// out, so at M = 1024..8192 rows it is tensor-core work, not HBM traffic.
// Unfused, the [M, 2I] f32 activation would go to device memory and back;
// here one block owns BM = 32 rows and keeps the normed rows and the
// [BM, I] bf16 activation in shared memory (GEGLU 86 KB, MLP at hidden 1024
// 123 KB of dynamic shared memory, set with cudaFuncSetAttribute).
//
// Design: 8 warps. Phase 1 normalizes (or copies) the row tile into shared
// memory. Phase 2: each warp takes 16-column chunks of the hidden width and
// computes the val and gate (or h) fragments for the 32 rows with bf16 wmma
// and f32 accumulators, applies the activation in f32 and stores bf16.
// Phase 3: each warp takes 16 x 16 output tiles of [BM, d_out], accumulates
// over the hidden width, adds the bias in f32 and writes bf16. Simple and
// correct first: weight fragments are not staged in shared memory, there is
// no wgmma and no pipelining.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

using namespace nvcuda;
using bf16 = __nv_bfloat16;

namespace {

constexpr int BM = 32;  // rows per block
constexpr int WARPS = 8;
constexpr int THREADS = WARPS * 32;
constexpr int SCR_LD = 20;                  // f32 pitch of a warp's 16-wide scratch
constexpr int SCR_FLOATS = 2 * BM * SCR_LD;  // two [BM, 16] tiles per warp
constexpr float LN_EPS = 1e-5f;

enum { MODE_GEGLU = 0, MODE_MLP = 1 };

__host__ __device__ inline size_t smem_bytes(int d, int hid) {
  return size_t(BM) * (d + 8) * sizeof(bf16) + size_t(BM) * (hid + 8) * sizeof(bf16) +
         size_t(WARPS) * SCR_FLOATS * sizeof(float);
}

__device__ __forceinline__ float gelu_erf(float g) {
  return g * (0.5f * (1.0f + erff(g * 0.70710678118654752f)));
}

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

template <int MODE>
__global__ void __launch_bounds__(THREADS)
fused_ffn_kernel(const bf16* __restrict__ x, const bf16* __restrict__ gamma,
                 const bf16* __restrict__ w_in, const bf16* __restrict__ b_in,
                 const bf16* __restrict__ w_out, const bf16* __restrict__ b_out,
                 bf16* __restrict__ y, int m, int d, int hid, int d_out) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int ldx = d + 8;
  const int ldh = hid + 8;
  bf16* xs = reinterpret_cast<bf16*>(smem);
  bf16* hs = xs + BM * ldx;
  float* scratch = reinterpret_cast<float*>(hs + BM * ldh);

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int m0 = blockIdx.x * BM;
  float* scr = scratch + warp * SCR_FLOATS;

  // phase 1: one warp per row -- LayerNorm (GEGLU) or a copy (MLP)
  for (int r = warp; r < BM; r += WARPS) {
    bf16* dst = xs + r * ldx;
    if (m0 + r >= m) {
      for (int c = lane; c < d; c += 32) dst[c] = __float2bfloat16(0.0f);
      continue;
    }
    const bf16* src = x + (long long)(m0 + r) * d;
    if (MODE == MODE_MLP) {
      for (int c = lane; c < d; c += 32) dst[c] = src[c];
      continue;
    }
    float sum = 0.0f;
    for (int c = lane; c < d; c += 32) sum += __bfloat162float(src[c]);
    const float mean = warp_sum(sum) / d;
    float sq = 0.0f;
    for (int c = lane; c < d; c += 32) {
      const float t = __bfloat162float(src[c]) - mean;
      sq += t * t;
    }
    const float rstd = 1.0f / sqrtf(warp_sum(sq) / d + LN_EPS);
    for (int c = lane; c < d; c += 32)
      dst[c] = __float2bfloat16((__bfloat162float(src[c]) - mean) * rstd * __bfloat162float(gamma[c]));
  }
  __syncthreads();

  // phase 2: hidden activation, 16 columns at a time
  for (int c0 = warp * 16; c0 < hid; c0 += WARPS * 16) {
    wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[2][2];  // [row block][val, gate]
    for (int i = 0; i < 2; ++i)
      for (int g = 0; g < 2; ++g) wmma::fill_fragment(acc[i][g], 0.0f);
    for (int kk = 0; kk < d; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a[2];
      wmma::load_matrix_sync(a[0], xs + kk, ldx);
      wmma::load_matrix_sync(a[1], xs + 16 * ldx + kk, ldx);
      for (int g = 0; g < (MODE == MODE_GEGLU ? 2 : 1); ++g) {
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> bw;
        wmma::load_matrix_sync(bw, w_in + (long long)(g * hid + c0) * d + kk, d);
        wmma::mma_sync(acc[0][g], a[0], bw, acc[0][g]);
        wmma::mma_sync(acc[1][g], a[1], bw, acc[1][g]);
      }
    }
    for (int i = 0; i < 2; ++i) {
      wmma::store_matrix_sync(scr + i * 16 * SCR_LD, acc[i][0], SCR_LD, wmma::mem_row_major);
      if (MODE == MODE_GEGLU)
        wmma::store_matrix_sync(scr + BM * SCR_LD + i * 16 * SCR_LD, acc[i][1], SCR_LD,
                                wmma::mem_row_major);
    }
    __syncwarp();
    for (int i = lane; i < BM * 16; i += 32) {
      const int r = i / 16;
      const int c = i % 16;
      float a;
      if (MODE == MODE_GEGLU) {
        a = scr[r * SCR_LD + c] * gelu_erf(scr[BM * SCR_LD + r * SCR_LD + c]);
      } else {
        a = gelu_erf(scr[r * SCR_LD + c] + __bfloat162float(b_in[c0 + c]));
      }
      hs[r * ldh + c0 + c] = __float2bfloat16(a);
    }
    __syncwarp();
  }
  __syncthreads();

  // phase 3: y[BM, d_out] = hidden . W_out^T (+ b_out), one 16 x 16 tile at a time
  const int col_tiles = d_out / 16;
  for (int t = warp; t < 2 * col_tiles; t += WARPS) {
    const int rb = t / col_tiles;
    const int n0 = (t % col_tiles) * 16;
    wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
    wmma::fill_fragment(acc, 0.0f);
    for (int kk = 0; kk < hid; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a;
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> bw;
      wmma::load_matrix_sync(a, hs + rb * 16 * ldh + kk, ldh);
      wmma::load_matrix_sync(bw, w_out + (long long)n0 * hid + kk, hid);
      wmma::mma_sync(acc, a, bw, acc);
    }
    wmma::store_matrix_sync(scr, acc, SCR_LD, wmma::mem_row_major);
    __syncwarp();
    for (int i = lane; i < 256; i += 32) {
      const int r = rb * 16 + i / 16;
      const int c = i % 16;
      if (m0 + r < m) {
        float v = scr[(i / 16) * SCR_LD + c];
        if (MODE == MODE_MLP) v += __bfloat162float(b_out[n0 + c]);
        y[(long long)(m0 + r) * d_out + n0 + c] = __float2bfloat16(v);
      }
    }
    __syncwarp();
  }
}

template <int MODE>
cudaError_t launch(const bf16* x, const bf16* gamma, const bf16* w_in, const bf16* b_in,
                   const bf16* w_out, const bf16* b_out, bf16* y, int m, int d, int hid, int d_out,
                   cudaStream_t stream) {
  if (d % 16 || hid % 16 || d_out % 16) return cudaErrorInvalidValue;
  auto kernel = fused_ffn_kernel<MODE>;
  const size_t bytes = smem_bytes(d, hid);
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return err;
  kernel<<<(m + BM - 1) / BM, THREADS, bytes, stream>>>(x, gamma, w_in, b_in, w_out, b_out, y, m, d,
                                                       hid, d_out);
  return cudaGetLastError();
}

}  // namespace

// GEGLU: x [M, d], gamma [d], w_in [2I, d], w_out [d, I] -> y [M, d].
extern "C" int geglu_ffn_bf16(const void* x, const void* gamma, const void* w_in, const void* w_out,
                              void* y, int m, int d, int inner, void* stream) {
  return (int)launch<MODE_GEGLU>(static_cast<const bf16*>(x), static_cast<const bf16*>(gamma),
                                 static_cast<const bf16*>(w_in), nullptr,
                                 static_cast<const bf16*>(w_out), nullptr, static_cast<bf16*>(y), m,
                                 d, inner, d, static_cast<cudaStream_t>(stream));
}

// MLP: x [M, d], w1 [H, d], b1 [H], w2 [O, H], b2 [O] -> y [M, O].
extern "C" int mlp_ffn_bf16(const void* x, const void* w1, const void* b1, const void* w2,
                            const void* b2, void* y, int m, int d, int hidden, int d_out,
                            void* stream) {
  return (int)launch<MODE_MLP>(static_cast<const bf16*>(x), nullptr, static_cast<const bf16*>(w1),
                               static_cast<const bf16*>(b1), static_cast<const bf16*>(w2),
                               static_cast<const bf16*>(b2), static_cast<bf16*>(y), m, d, hidden,
                               d_out, static_cast<cudaStream_t>(stream));
}
