// One output tile of a skinny product x @ W4, shared by csrc/w4_matmul.cu and
// csrc/w4_ffn.cu.
//
// W4 layout (controlar_tpu_torch/ops/w4_matmul.py): carriers q4 (Kp/2, N)
// int8, N contiguous; carrier row p*G + i holds row i of plane 2p in its low
// nibble and row i of plane 2p+1 in its high nibble; scales s (Kp/G, N) f32
// per (plane, column). x is (B, nfull*G) bf16: only the first nfull planes
// are read, so a trailing zero-quantized plane (K = 3200 has 25 planes) is
// skipped and x is never read past its own width.
//
// A block of 8 warps computes rows [m0, m0 + BM) x columns [n0, n0 + TN):
//   - each lane owns CPT = 2 adjacent columns, so a warp reads 64 contiguous
//     carrier bytes of a row (two 32-byte sectors);
//   - warp w owns carrier rows [w*16, w*16 + 16) of every G = 128-row chunk,
//     loads their 16 carriers at once, and unpacks each to two fp32 nibbles;
//   - the chunk's x planes (BM rows x 2G) are staged in shared memory as fp32,
//     laid out [plane][k][row] so one 16-byte read gives four rows of a k;
//   - per chunk the lane forms an fp32 partial sum per plane and row over its
//     16 k and adds partial * that plane's scale to its accumulator;
//   - the 8 warps' accumulators are summed in warp order in shared memory,
//     so the result does not depend on scheduling.
// The products run on the CUDA cores in fp32, not the tensor cores.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace w4 {

constexpr int G = 128;              // rows per plane (the quantization group)
constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int RPW = G / kWarps;     // carrier rows per warp per chunk
constexpr int BM = 16;              // rows of x per tile
constexpr int CPT = 2;              // columns per lane
constexpr int TN = 32 * CPT;        // columns per tile

struct Smem {
  float x[2][G][BM];   // the chunk's two x planes, [plane][k][row]
  float red[BM][TN];   // the tile's result, after the cross-warp sum
};

__device__ __forceinline__ float lo_nibble(uint32_t byte) {
  return static_cast<float>(static_cast<int>(byte << 28) >> 28);
}
__device__ __forceinline__ float hi_nibble(uint32_t byte) {
  return static_cast<float>(static_cast<int>(byte << 24) >> 28);
}

// Computes the tile and leaves it, scaled and summed, in sm.red[BM][TN]; rows
// past B and columns past N hold zeros. N must be even. Every thread of the
// block must call it. x is read with ld.global.cg (L2 only): w4_ffn writes
// its second product's x in the same launch.
__device__ void tile(const __nv_bfloat16* x, int B, int nfull, const int8_t* __restrict__ q4,
                     const float* __restrict__ s, int N, int m0, int n0, Smem& sm) {
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int col = n0 + lane * CPT;
  const bool col_ok = col < N;
  const int ldx = nfull * G;
  float acc[BM][CPT];
#pragma unroll
  for (int b = 0; b < BM; ++b) {
#pragma unroll
    for (int j = 0; j < CPT; ++j) acc[b][j] = 0.f;
  }

  const int nchunk = (nfull + 1) / 2;
  for (int p = 0; p < nchunk; ++p) {
    const bool has_hi = 2 * p + 1 < nfull;
    __syncthreads();  // the previous chunk's readers are done with sm.x
    // stage x[m0 .. m0+BM, 2pG .. 2pG + 2G) as fp32, 8 bf16 per 16-byte load
    for (int i = threadIdx.x; i < BM * (2 * G / 8); i += kThreads) {
      const int r = i % BM;
      const int c = (i / BM) * 8;  // within the chunk's two planes
      const int plane = c / G;
      float v[8];
      if (m0 + r < B && 2 * p + plane < nfull) {
        const uint4 raw = __ldcg(reinterpret_cast<const uint4*>(
            x + (size_t)(m0 + r) * ldx + (size_t)2 * p * G + c));
        const __nv_bfloat162* h2 = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float2 f = __bfloat1622float2(h2[e]);
          v[2 * e] = f.x;
          v[2 * e + 1] = f.y;
        }
      } else {
#pragma unroll
        for (int e = 0; e < 8; ++e) v[e] = 0.f;
      }
#pragma unroll
      for (int e = 0; e < 8; ++e) sm.x[plane][(c % G) + e][r] = v[e];
    }
    __syncthreads();
    if (!col_ok) continue;

    uint32_t cr[RPW];  // CPT = 2 carrier bytes per row, as one 16-bit load
    const int8_t* qrow = q4 + ((size_t)p * G + warp * RPW) * N + col;
#pragma unroll
    for (int r = 0; r < RPW; ++r) cr[r] = *reinterpret_cast<const uint16_t*>(qrow + (size_t)r * N);
    const float2 sl = *reinterpret_cast<const float2*>(s + (size_t)(2 * p) * N + col);
    const float2 sh = has_hi ? *reinterpret_cast<const float2*>(s + (size_t)(2 * p + 1) * N + col)
                             : make_float2(0.f, 0.f);

    float pl[BM][CPT], ph[BM][CPT];
#pragma unroll
    for (int b = 0; b < BM; ++b) {
#pragma unroll
      for (int j = 0; j < CPT; ++j) { pl[b][j] = 0.f; ph[b][j] = 0.f; }
    }
#pragma unroll
    for (int r = 0; r < RPW; ++r) {
      const uint32_t c0 = cr[r] & 0xffu, c1 = (cr[r] >> 8) & 0xffu;
      const float lo[CPT] = {lo_nibble(c0), lo_nibble(c1)};
      const float hi[CPT] = {hi_nibble(c0), hi_nibble(c1)};
      const float4* xl = reinterpret_cast<const float4*>(sm.x[0][warp * RPW + r]);
      const float4* xh = reinterpret_cast<const float4*>(sm.x[1][warp * RPW + r]);
#pragma unroll
      for (int q = 0; q < BM / 4; ++q) {
        const float4 a = xl[q];
        const float4 c = xh[q];
        const float av[4] = {a.x, a.y, a.z, a.w};
        const float cv[4] = {c.x, c.y, c.z, c.w};
#pragma unroll
        for (int e = 0; e < 4; ++e) {
#pragma unroll
          for (int j = 0; j < CPT; ++j) {
            pl[4 * q + e][j] = fmaf(av[e], lo[j], pl[4 * q + e][j]);
            ph[4 * q + e][j] = fmaf(cv[e], hi[j], ph[4 * q + e][j]);
          }
        }
      }
    }
#pragma unroll
    for (int b = 0; b < BM; ++b) {
      acc[b][0] += pl[b][0] * sl.x + ph[b][0] * sh.x;
      acc[b][1] += pl[b][1] * sl.y + ph[b][1] * sh.y;
    }
  }

  // sum the warps' partial tiles in warp order
  for (int w = 0; w < kWarps; ++w) {
    __syncthreads();
    if (warp == w) {
#pragma unroll
      for (int b = 0; b < BM; ++b) {
#pragma unroll
        for (int j = 0; j < CPT; ++j) {
          const float prev = w == 0 ? 0.f : sm.red[b][lane * CPT + j];
          sm.red[b][lane * CPT + j] = prev + acc[b][j];
        }
      }
    }
  }
  __syncthreads();
}

}  // namespace w4
