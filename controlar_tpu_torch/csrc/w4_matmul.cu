// x @ W4: bf16 activations times int4 group-quantized weights, fp32 sums.
//
// Replaces the Pallas kernel `_w4_kernel` of controlar_tpu/ops/w4_matmul.py
// (w4_matmul). out[b, n] = sum over planes P of s[P, n] * sum_{k in P}
// x[b, k] * q[k, n], q unpacked from the group-pair-plane carriers; the
// layout and the tile routine are in csrc/w4_tile.cuh.
//
// Bound: memory at the decode shapes. The product is skinny (16 rows on the
// main path, at most 256 routed here), so the carriers dominate the bytes:
// GPT-3B wqkv (3200 -> 9600) streams 15.4 MB of carriers and 0.6 MB of
// scales per call against 16 * 3200 * 9600 * 2 flops, ~1 flop per byte.
// The design streams every carrier once per 16-row tile, coalesced along N,
// and keeps x in shared memory. One block per (64-column tile, 16-row tile):
// 150 blocks for N = 9600 and 50 for N = 3200 on the card's 132 SMs, so the
// small products leave SMs idle (split-K is later work). The fp32 products
// run on the CUDA cores, whose 67 TFLOP/s are 1 flop per 50 bytes of HBM
// rate: at 16 rows the kernel is bound by the cores, not by the bytes.
//
// Plain C interface, loaded with ctypes. The launch goes on the caller's
// stream; the function returns cudaGetLastError() after the launch.
#include "w4_tile.cuh"

namespace {

__device__ __forceinline__ void store_out(float* p, float x) { *p = x; }
__device__ __forceinline__ void store_out(__nv_bfloat16* p, float x) { *p = __float2bfloat16(x); }

template <typename OutT>
__global__ void __launch_bounds__(w4::kThreads)
w4_matmul_kernel(const __nv_bfloat16* __restrict__ x,  // (B, nfull * G)
                 const int8_t* __restrict__ q4,        // (Kp/2, N)
                 const float* __restrict__ s,          // (Kp/G, N)
                 OutT* __restrict__ out,               // (B, N)
                 int B, int nfull, int N) {
  __shared__ w4::Smem sm;
  const int n0 = blockIdx.x * w4::TN;
  const int m0 = blockIdx.y * w4::BM;
  w4::tile(x, B, nfull, q4, s, N, m0, n0, sm);
  for (int i = threadIdx.x; i < w4::BM * w4::TN; i += w4::kThreads) {
    const int r = i / w4::TN, c = i % w4::TN;
    if (m0 + r < B && n0 + c < N) store_out(out + (size_t)(m0 + r) * N + n0 + c, sm.red[r][c]);
  }
}

}  // namespace

// x (B, nfull*G) bf16; q4 (Kp/2, N) int8; s (Kp/G, N) f32; out (B, N) f32
// when out_f32, else bf16. N even. Returns a cudaError_t.
extern "C" int w4_matmul(const void* x, const void* q4, const void* s, void* out, int out_f32,
                         int B, int nfull, int N, void* stream) {
  if (B < 1 || nfull < 1 || N < 2 || N % 2) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const dim3 grid((N + w4::TN - 1) / w4::TN, (B + w4::BM - 1) / w4::BM);
  const auto* xp = static_cast<const __nv_bfloat16*>(x);
  const auto* qp = static_cast<const int8_t*>(q4);
  const auto* sp = static_cast<const float*>(s);
  if (out_f32) {
    w4_matmul_kernel<float><<<grid, w4::kThreads, 0, st>>>(xp, qp, sp, static_cast<float*>(out),
                                                           B, nfull, N);
  } else {
    w4_matmul_kernel<__nv_bfloat16><<<grid, w4::kThreads, 0, st>>>(
        xp, qp, sp, static_cast<__nv_bfloat16*>(out), B, nfull, N);
  }
  return static_cast<int>(cudaGetLastError());
}
