// The whole SwiGLU FFN over W4 weights in one launch:
//   out = (silu(x @ w1) * (x @ w3)) @ w2,  w13 = [w1 | w3] fused along N.
//
// Replaces the Pallas kernel `_w4_ffn_kernel` of controlar_tpu/ops/w4_matmul.py
// (w4_ffn), with its numerics: the w13 accumulator is rounded to bf16, the
// gate silu(h1) * h3 is taken in fp32, and z is rounded to bf16 before the
// second product.
//
// Bound: bytes. At GPT-3B (K = 3200, F = 8704, N = 3200) and 16 rows one
// call streams 27.9 MB of w13 carriers and 13.9 MB of w2 carriers plus
// 3.7 MB of scales against ~64 flops per carrier byte (~256 at 64 rows).
// On the TPU the (B, F) intermediate z never leaves VMEM; here one
// cooperative launch of a persistent grid runs both products, with z
// (278 KB at GPT-3B and 16 rows, written once, read from L2) in a scratch
// the caller allocates. Both products are the tensor-core items of
// csrc/w4_tile.cuh (asynchronous ring, nibbles to bf16 in registers):
//   phase 1: items of 128 columns of [w1 | w3] over s1 slices of K; every
//            item writes its fp32 partial to ws1, and the last of the 2 * s1
//            items of column block j (w1's and w3's) sums each half in split
//            order, rounds it to bf16, gates it and writes z's columns;
//   cooperative_groups::this_grid().sync();
//   phase 2: z @ w2 over s2 slices of F (N = 3200 has 25 column tiles, so
//            the split fills the card), reduced as in csrc/w4_matmul.cu.
// The splits come from (K, N) and the card's SM count, never from B, so a
// row's result does not depend on the rows beside it, and the sums run in
// a fixed order, so launches agree bit for bit. The grid is capped at the
// blocks that can be resident at once (cudaOccupancyMaxActiveBlocksPer-
// Multiprocessor x SMs), as a grid-wide sync requires; blocks loop over
// the items. The counters are left zero for the next launch.
//
// Plain C interface, loaded with ctypes. The launch goes on the caller's
// stream; the function returns cudaGetLastError() after the launch.
#include <cooperative_groups.h>

#include "w4_tile.cuh"

namespace {

__device__ __forceinline__ float round_bf16(float x) {
  return __bfloat162float(__float2bfloat16(x));
}

template <int WN, typename OutT>
__global__ void __launch_bounds__(w4::kThreads, 3)
w4_ffn_kernel(w4::Operand p1,           // x (B, K) @ w13 (Kp/2, 2F)
              w4::Operand p2,           // z (B, F) @ w2 (Fp/2, N)
              __nv_bfloat16* z,         // (B, F) scratch, p2's x
              OutT* __restrict__ out,   // (B, N)
              float* ws1,               // (s1, B, 2F)
              float* ws2,               // (s2, B, N) when s2 > 1
              int* cnt1, int* cnt2, int s1, int s2) {
  extern __shared__ __align__(128) uint8_t smem[];
  constexpr int RT = w4::Cfg<WN>::RT;
  const int B = p1.B, F = p2.nfull * w4::G;
  const int row_tiles = (B + RT - 1) / RT;
  w4::Frags<WN> acc;

  // phase 1: z = bf16(silu(h1) * h3), h = bf16(x @ w13)
  const int ft = F / w4::TN;
  const int nch1 = w4::nchunk(p1);
  for (int item = blockIdx.x; item < 2 * ft * s1 * row_tiles; item += gridDim.x) {
    const int r = item % row_tiles, split = (item / row_tiles) % s1;
    const int ct = item / (row_tiles * s1), j = ct % ft;
    const int m0 = r * RT;
    w4::item<WN>(p1, ct * w4::TN, m0, w4::split_begin(nch1, split, s1),
                 w4::split_begin(nch1, split + 1, s1), smem, acc);
    w4::store<WN>(B, 2 * F, ct * w4::TN, m0, acc, ws1 + (size_t)split * B * 2 * F);
    if (!w4::arrive(cnt1 + j * row_tiles + r, 2 * s1)) continue;
    w4::Frags<WN> h3;
#pragma unroll
    for (int a = 0; a < w4::Cfg<WN>::F; ++a) {
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[a][e] = h3[a][e] = 0.f;
    }
    w4::add_splits<WN>(B, 2 * F, j * w4::TN, m0, ws1, s1, acc);
    w4::add_splits<WN>(B, 2 * F, F + j * w4::TN, m0, ws1, s1, h3);
#pragma unroll
    for (int a = 0; a < w4::Cfg<WN>::F; ++a) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float h1 = round_bf16(acc[a][e]);
        const float g = round_bf16(h3[a][e]);
        const float sig = 1.f / (1.f + expf(-h1));
        acc[a][e] = h1 * sig * g;
      }
    }
    w4::store<WN>(B, F, j * w4::TN, m0, acc, z);
  }

  cooperative_groups::this_grid().sync();

  // phase 2: out = z @ w2
  const int nt = (p2.N + w4::TN - 1) / w4::TN;
  const int nch2 = w4::nchunk(p2);
  for (int item = blockIdx.x; item < nt * s2 * row_tiles; item += gridDim.x) {
    const int r = item % row_tiles, split = (item / row_tiles) % s2;
    const int ct = item / (row_tiles * s2);
    const int n0 = ct * w4::TN, m0 = r * RT;
    w4::item<WN>(p2, n0, m0, w4::split_begin(nch2, split, s2),
                 w4::split_begin(nch2, split + 1, s2), smem, acc);
    if (w4::reduce<WN>(B, p2.N, n0, m0, split, s2, ws2, cnt2 + ct * row_tiles + r, acc)) {
      w4::store<WN>(B, p2.N, n0, m0, acc, out);
    }
  }
}

template <int WN, typename OutT>
int launch(w4::Operand p1, w4::Operand p2, __nv_bfloat16* z, void* out, float* ws1, float* ws2,
           int* cnt1, int* cnt2, int s1, int s2, cudaStream_t stream) {
  constexpr int RT = w4::Cfg<WN>::RT;
  int smem = w4::Cfg<WN>::kSmemBytes;
  auto* kernel = w4_ffn_kernel<WN, OutT>;
  static int resident = 0;  // co-resident blocks on this card, computed once
  if (resident == 0) {
    int dev = 0, sms = 0, per_sm = 0;
    cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err == cudaSuccess) err = cudaGetDevice(&dev);
    if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err == cudaSuccess) {
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, w4::kThreads, smem);
    }
    if (err != cudaSuccess) return static_cast<int>(err);
    if (per_sm == 0) return static_cast<int>(cudaErrorCooperativeLaunchTooLarge);
    resident = sms * per_sm;
  }
  const int row_tiles = (p1.B + RT - 1) / RT;
  const int ft = p2.nfull * w4::G / w4::TN;
  const int items = max(2 * ft * s1, (p2.N + w4::TN - 1) / w4::TN * s2) * row_tiles;
  const dim3 grid(min(items, resident));
  auto* op = static_cast<OutT*>(out);
  void* args[] = {&p1, &p2, &z, &op, &ws1, &ws2, &cnt1, &cnt2, &s1, &s2};
  return static_cast<int>(cudaLaunchCooperativeKernel(
      reinterpret_cast<void*>(kernel), grid, dim3(w4::kThreads), args, smem, stream));
}

template <typename OutT>
int dispatch(w4::Operand p1, w4::Operand p2, __nv_bfloat16* z, void* out, float* ws1,
             float* ws2, int* cnt1, int* cnt2, int s1, int s2, cudaStream_t stream) {
  return p1.B <= 16 ? launch<2, OutT>(p1, p2, z, out, ws1, ws2, cnt1, cnt2, s1, s2, stream)
                    : launch<4, OutT>(p1, p2, z, out, ws1, ws2, cnt1, cnt2, s1, s2, stream);
}

}  // namespace

// x (B, K) bf16; q13 (Kp/2, 2F) int8 and s13 (Kp/G, 2F) f32, the fused
// [w1 | w3]; q2 (Fp/2, N) int8 and s2 (Fp/G, N) f32; z (B, F) bf16 scratch;
// out (B, N) f32 when out_f32, else bf16. K and F multiples of G = 128, N a
// multiple of 16. K is cut into s1 chunk ranges, F into s2; ws1 is
// (s1, B, 2F) f32 scratch, ws2 (s2, B, N) f32 scratch when s2 > 1;
// counters holds (F / 128 + ceil(N / 128)) * ceil(B / 16) ints, zero on
// entry and left zero. Returns a cudaError_t.
extern "C" int w4_ffn(const void* x, const void* q13, const void* s13, const void* q2,
                      const void* s2, void* z, void* out, void* ws1, void* ws2, void* counters,
                      int out_f32, int B, int K, int F, int N, int splits1, int splits2,
                      void* stream) {
  if (B < 1 || K < w4::G || K % w4::G || F < w4::G || F % w4::G || N < 16 || N % 16 ||
      splits1 < 1 || splits1 > (K / w4::G + 1) / 2 || splits2 < 1 ||
      splits2 > (F / w4::G + 1) / 2 || (splits2 > 1 && ws2 == nullptr)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const w4::Operand p1{static_cast<const __nv_bfloat16*>(x), static_cast<const int8_t*>(q13),
                       static_cast<const float*>(s13), B, K / w4::G, 2 * F};
  auto* zp = static_cast<__nv_bfloat16*>(z);
  const w4::Operand p2{zp, static_cast<const int8_t*>(q2), static_cast<const float*>(s2), B,
                       F / w4::G, N};
  auto* cnt1 = static_cast<int*>(counters);
  int* cnt2 = cnt1 + F / w4::TN * ((B + 15) / 16);
  auto* w1 = static_cast<float*>(ws1);
  auto* w2 = static_cast<float*>(ws2);
  auto st = static_cast<cudaStream_t>(stream);
  const int err = out_f32 ? dispatch<float>(p1, p2, zp, out, w1, w2, cnt1, cnt2, splits1,
                                            splits2, st)
                          : dispatch<__nv_bfloat16>(p1, p2, zp, out, w1, w2, cnt1, cnt2, splits1,
                                                    splits2, st);
  if (err != 0) return err;
  return static_cast<int>(cudaGetLastError());
}
