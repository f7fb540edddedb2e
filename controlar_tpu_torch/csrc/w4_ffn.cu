// The whole SwiGLU FFN over W4 weights in one launch:
//   out = (silu(x @ w1) * (x @ w3)) @ w2,  w13 = [w1 | w3] fused along N.
//
// Replaces the Pallas kernel `_w4_ffn_kernel` of controlar_tpu/ops/w4_matmul.py
// (w4_ffn), with its numerics: the w13 accumulator is rounded to bf16, the
// gate silu(h1) * h3 is taken in fp32, and z is rounded to bf16 before the
// second product.
//
// Bound: memory. At GPT-3B (K = 3200, F = 8704, N = 3200) and 16 rows one
// call streams 27.9 MB of w13 carriers and 13.9 MB of w2 carriers plus
// 3.7 MB of scales against ~2 flops per carrier byte. On the TPU the (B, F)
// intermediate z never leaves VMEM; here one cooperative launch of a
// persistent grid runs both products, with z (278 KB at GPT-3B and 16 rows,
// written once, read from L2) in a scratch the caller allocates:
//   phase 1: a block takes a (64-column, 16-row) tile j of w1 and the
//            matching tile F + j of w3, so the gate is formed in the block,
//            and writes its z tile;
//   cooperative_groups::this_grid().sync();
//   phase 2: tiles of z @ w2, as in csrc/w4_matmul.cu.
// The grid is capped at the blocks that can be resident at once
// (cudaOccupancyMaxActiveBlocksPerMultiprocessor x SMs), as a grid-wide sync
// requires; blocks loop over the tiles. Phase 2 has N/64 = 50 column tiles at
// GPT-3B, so most SMs idle through it (split-K is later work). The products
// run on the CUDA cores in fp32 (csrc/w4_tile.cuh).
//
// Plain C interface, loaded with ctypes. The launch goes on the caller's
// stream; the function returns cudaGetLastError() after the launch.
#include <cooperative_groups.h>

#include "w4_tile.cuh"

namespace {

__device__ __forceinline__ void store_out(float* p, float x) { *p = x; }
__device__ __forceinline__ void store_out(__nv_bfloat16* p, float x) { *p = __float2bfloat16(x); }

__device__ __forceinline__ float round_bf16(float x) {
  return __bfloat162float(__float2bfloat16(x));
}

template <typename OutT>
__global__ void __launch_bounds__(w4::kThreads)
w4_ffn_kernel(const __nv_bfloat16* __restrict__ x,   // (B, K)
              const int8_t* __restrict__ q13,        // (K/2 padded, 2F)
              const float* __restrict__ s13,
              const int8_t* __restrict__ q2,         // (F/2 padded, N)
              const float* __restrict__ s2,
              __nv_bfloat16* z,                      // (B, F) scratch
              OutT* __restrict__ out,                // (B, N)
              int B, int K, int F, int N) {
  __shared__ w4::Smem sm;
  __shared__ float h1[w4::BM][w4::TN];
  const int m_tiles = (B + w4::BM - 1) / w4::BM;

  // phase 1: z = bf16(silu(h1) * h3), h = bf16(x @ w13)
  const int f_tiles = F / w4::TN;
  for (int item = blockIdx.x; item < f_tiles * m_tiles; item += gridDim.x) {
    const int n0 = (item % f_tiles) * w4::TN;
    const int m0 = (item / f_tiles) * w4::BM;
    w4::tile(x, B, K / w4::G, q13, s13, 2 * F, m0, n0, sm);
    for (int i = threadIdx.x; i < w4::BM * w4::TN; i += w4::kThreads) {
      h1[i / w4::TN][i % w4::TN] = sm.red[i / w4::TN][i % w4::TN];
    }
    w4::tile(x, B, K / w4::G, q13, s13, 2 * F, m0, F + n0, sm);
    for (int i = threadIdx.x; i < w4::BM * w4::TN; i += w4::kThreads) {
      const int r = i / w4::TN, c = i % w4::TN;
      if (m0 + r >= B) continue;
      const float a = round_bf16(h1[r][c]);
      const float g = round_bf16(sm.red[r][c]);
      const float sig = 1.f / (1.f + expf(-a));
      z[(size_t)(m0 + r) * F + n0 + c] = __float2bfloat16(a * sig * g);
    }
  }

  cooperative_groups::this_grid().sync();

  // phase 2: out = z @ w2
  const int n_tiles = (N + w4::TN - 1) / w4::TN;
  for (int item = blockIdx.x; item < n_tiles * m_tiles; item += gridDim.x) {
    const int n0 = (item % n_tiles) * w4::TN;
    const int m0 = (item / n_tiles) * w4::BM;
    w4::tile(z, B, F / w4::G, q2, s2, N, m0, n0, sm);
    for (int i = threadIdx.x; i < w4::BM * w4::TN; i += w4::kThreads) {
      const int r = i / w4::TN, c = i % w4::TN;
      if (m0 + r < B && n0 + c < N) store_out(out + (size_t)(m0 + r) * N + n0 + c, sm.red[r][c]);
    }
  }
}

template <typename OutT>
int launch(const void* x, const void* q13, const void* s13, const void* q2, const void* s2,
           void* z, void* out, int B, int K, int F, int N, cudaStream_t stream) {
  static int resident = 0;  // co-resident blocks on this card, computed once
  if (resident == 0) {
    int dev = 0, sms = 0, per_sm = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, w4_ffn_kernel<OutT>, w4::kThreads, 0);
    resident = sms * per_sm;
    if (resident == 0) return static_cast<int>(cudaErrorCooperativeLaunchTooLarge);
  }
  const int m_tiles = (B + w4::BM - 1) / w4::BM;
  const int items = max(F / w4::TN, (N + w4::TN - 1) / w4::TN) * m_tiles;
  const dim3 grid(min(items, resident));
  auto* xp = static_cast<const __nv_bfloat16*>(x);
  auto* q13p = static_cast<const int8_t*>(q13);
  auto* s13p = static_cast<const float*>(s13);
  auto* q2p = static_cast<const int8_t*>(q2);
  auto* s2p = static_cast<const float*>(s2);
  auto* zp = static_cast<__nv_bfloat16*>(z);
  auto* op = static_cast<OutT*>(out);
  void* args[] = {&xp, &q13p, &s13p, &q2p, &s2p, &zp, &op, &B, &K, &F, &N};
  return static_cast<int>(cudaLaunchCooperativeKernel(
      reinterpret_cast<void*>(w4_ffn_kernel<OutT>), grid, dim3(w4::kThreads), args, 0, stream));
}

}  // namespace

// x (B, K) bf16; q13 (Kp/2, 2F) int8 and s13 (Kp/G, 2F) f32, the fused
// [w1 | w3]; q2 (Fp/2, N) int8 and s2 (Fp/G, N) f32; z (B, F) bf16 scratch;
// out (B, N) f32 when out_f32, else bf16. K and F multiples of G = 128, N
// even. Returns a cudaError_t.
extern "C" int w4_ffn(const void* x, const void* q13, const void* s13, const void* q2,
                      const void* s2, void* z, void* out, int out_f32, int B, int K, int F,
                      int N, void* stream) {
  if (B < 1 || K < w4::G || K % w4::G || F < w4::G || F % w4::G || N < 2 || N % 2) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int err = out_f32 ? launch<float>(x, q13, s13, q2, s2, z, out, B, K, F, N, st)
                          : launch<__nv_bfloat16>(x, q13, s13, q2, s2, z, out, B, K, F, N, st);
  if (err != 0) return err;
  return static_cast<int>(cudaGetLastError());
}
