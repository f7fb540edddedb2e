// K-query chunk attention over a nibble-packed int4 [k|v] cache slab with
// per-row, per-head f32 scales.
//
// Replaces the Pallas kernel `_kernel_chunk_q4` of
// controlar_tpu/ops/flash_chunk.py (flash_chunk_attention_q4). A cache row
// holds H*D/2 k carriers, then H*D/2 v carriers; carrier j of head h holds
// the pair (even_j, odd_j) as low | high signed nibble: dims (2j, 2j+1) in
// the interleaved layout, or (j, D/2 + j) in the split-rope layout
// (split = 1). For batch row b, head h and chunk query j:
//   s_r = (q_even . klo + q_odd . khi) * ks[b,r,h] / sqrt(2 * (D/2))
//         + (r == pos[b]+j ? 0 : bias[b,r])
//   out[b,j,h] = sum_r softmax(s)_r * vs[b,r,h] * (vlo, vhi)
// over rows r <= pos[b] + j, the output pairs written back in q's layout.
// The bias is not added on a query's own row (the diagonal exception).
//
// Bound: memory. A verify call reads the live rows once for all K queries:
// H*D bytes of carriers and 2*H f32 scales per row, a quarter of the bf16
// slab; at the GPT-3B w4kv4 spec cell (16 batch rows, 32 heads x 100, 576
// live rows) ~29.5 MB of carriers and 2.4 MB of scales. The design is the
// bf16/int8 chunk kernel's (csrc/flash_chunk.cu) with the q4 decode kernel's
// loads (csrc/flash_decode_q4.cu): one block per (b, head, tile of NQ = 2,
// 4 or 8 queries), 8 warps, lanes grouped per cache row, each lane
// unpacking VEC carriers (2*VEC values) in registers (4-byte loads for
// D = 64 and 128; 2-byte loads for D = 100, whose 50-byte head rows are
// only 2-byte aligned) and scoring them against the tile's NQ queries;
// per-query online softmax in fp32, groups merged with shuffles, warps in
// shared memory. p * vs and alpha stay fp32, where the TPU kernel rounds
// them to bf16.
//
// Plain C interface, loaded with ctypes. The launch goes on the caller's
// stream; the function returns cudaGetLastError() after the launch.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;

// VEC: carriers (bytes) per lane; LPR: lanes per cache row (power of two)
template <int D> struct HeadCfg;
template <> struct HeadCfg<64> { static constexpr int VEC = 4; static constexpr int LPR = 8; };
template <> struct HeadCfg<100> { static constexpr int VEC = 2; static constexpr int LPR = 32; };
template <> struct HeadCfg<128> { static constexpr int VEC = 4; static constexpr int LPR = 16; };

// VEC carriers -> sign-extended (lo, hi) nibbles as fp32
template <int VEC>
__device__ __forceinline__ void load_q4(const int8_t* p, float* lo, float* hi) {
  uint32_t w;
  if constexpr (VEC == 4) {
    w = *reinterpret_cast<const uint32_t*>(p);
  } else {
    w = *reinterpret_cast<const uint16_t*>(p);
  }
#pragma unroll
  for (int i = 0; i < VEC; ++i) {
    const int c = static_cast<int8_t>((w >> (8 * i)) & 0xffu);
    lo[i] = static_cast<float>(static_cast<int>(static_cast<uint32_t>(c) << 28) >> 28);
    hi[i] = static_cast<float>(c >> 4);
  }
}

__device__ __forceinline__ void store_out(float* p, float x) { *p = x; }
__device__ __forceinline__ void store_out(__nv_bfloat16* p, float x) { *p = __float2bfloat16(x); }

// dim of head-local pair j, half 0 (even) or 1 (odd), in q's layout
__device__ __forceinline__ int pair_dim(int j, int half, int D, int split) {
  return split ? half * (D / 2) + j : 2 * j + half;
}

template <int D, int NQ, typename OutT>
__global__ void __launch_bounds__(kWarps * 32)
flash_chunk_q4_kernel(const __nv_bfloat16* __restrict__ q,  // (B, K, H*D)
                      const int8_t* __restrict__ kv,        // (B, S, H*D) carriers
                      const float* __restrict__ sc,         // (B, S, 2*H) [ks | vs]
                      const int* __restrict__ pos_ptr,      // (B,) or scalar, or null
                      int pos_stride, int pos_scalar,
                      const float* __restrict__ bias,       // (B, S) or null
                      OutT* __restrict__ out,               // (B, K, H*D)
                      int S, int H, int K, int split, float scale) {
  constexpr int VEC = HeadCfg<D>::VEC;
  constexpr int LPR = HeadCfg<D>::LPR;
  constexpr int HALF = D / 2;        // carriers per head
  constexpr int GPW = 32 / LPR;      // row groups per warp
  constexpr int G = kWarps * GPW;    // row groups per block

  // accumulators in pair order: [even_0 .. even_{D/2-1} | odd_0 .. odd_{D/2-1}]
  __shared__ float sm_acc[kWarps][NQ][D];
  __shared__ float sm_m[kWarps][NQ];
  __shared__ float sm_l[kWarps][NQ];

  const int b = blockIdx.x / H;
  const int h = blockIdx.x % H;
  const int q0 = blockIdx.y * NQ;    // the tile's first query
  const int hd = H * D;
  const int w = H * HALF;  // carriers of one of k|v
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int li = lane % LPR;
  const int sub = lane / LPR;
  const int j0 = li * VEC;
  const bool active = j0 < HALF;  // D = 100 leaves the last lanes of a group idle

  const int pos = pos_ptr ? pos_ptr[(size_t)b * pos_stride] : pos_scalar;
  const int nq = min(NQ, K - q0);    // the tile's queries that exist
  const int n_rows = min(pos + q0 + nq, S);

  float qe[NQ][VEC], qo[NQ][VEC], acc_e[NQ][VEC], acc_o[NQ][VEC], m[NQ], l[NQ];
#pragma unroll
  for (int t = 0; t < NQ; ++t) {
    const __nv_bfloat16* qh = q + ((size_t)b * K + q0 + t) * hd + (size_t)h * D;
    const bool load = active && t < nq;
#pragma unroll
    for (int i = 0; i < VEC; ++i) {
      acc_e[t][i] = 0.f;
      acc_o[t][i] = 0.f;
      qe[t][i] = load ? __bfloat162float(qh[pair_dim(j0 + i, 0, D, split)]) : 0.f;
      qo[t][i] = load ? __bfloat162float(qh[pair_dim(j0 + i, 1, D, split)]) : 0.f;
    }
    m[t] = -INFINITY;
    l[t] = 0.f;
  }

  const size_t row_stride = 2 * (size_t)w;
  const int8_t* kbase = kv + (size_t)b * S * row_stride + (size_t)h * HALF + j0;
  const float* sbase = sc + (size_t)b * S * 2 * H + h;
  const float* brow = bias ? bias + (size_t)b * S : nullptr;

  // every lane of a warp runs the same trip count, so the full-mask shuffles
  // below never see a diverged warp; rows past n_rows are skipped after them
  for (int base = warp * GPW; base < n_rows; base += G) {
    const int r = base + sub;
    const bool valid = r < n_rows;
    float klo[VEC], khi[VEC], vlo[VEC], vhi[VEC];
    if (valid && active) {
      const int8_t* rp = kbase + (size_t)r * row_stride;
      load_q4<VEC>(rp, klo, khi);
      load_q4<VEC>(rp + w, vlo, vhi);
    } else {
#pragma unroll
      for (int i = 0; i < VEC; ++i) { klo[i] = khi[i] = vlo[i] = vhi[i] = 0.f; }
    }
    float s[NQ];
#pragma unroll
    for (int t = 0; t < NQ; ++t) {
      float se = 0.f, so = 0.f;
#pragma unroll
      for (int i = 0; i < VEC; ++i) {
        se = fmaf(qe[t][i], klo[i], se);
        so = fmaf(qo[t][i], khi[i], so);
      }
      s[t] = se + so;
    }
#pragma unroll
    for (int off = LPR / 2; off > 0; off >>= 1) {
#pragma unroll
      for (int t = 0; t < NQ; ++t) s[t] += __shfl_xor_sync(0xffffffffu, s[t], off);
    }
    if (valid) {
      const float* srow = sbase + (size_t)r * 2 * H;
      const float ks = srow[0] * scale;
      const float vs = srow[H];
      const float br = brow ? brow[r] : 0.f;
#pragma unroll
      for (int t = 0; t < NQ; ++t) {
        const int own = pos + q0 + t;  // query t's own row, the last it sees
        if (t < nq && r <= own) {
          float st = s[t] * ks;
          if (r != own) st += br;  // the diagonal exception
          const float m_new = fmaxf(m[t], st);
          const float alpha = expf(m[t] - m_new);  // exp(-inf) = 0 on the first row
          const float p = expf(st - m_new);
          l[t] = l[t] * alpha + p;
          const float pv = p * vs;  // the v scale folded into p
#pragma unroll
          for (int i = 0; i < VEC; ++i) {
            acc_e[t][i] = fmaf(pv, vlo[i], acc_e[t][i] * alpha);
            acc_o[t][i] = fmaf(pv, vhi[i], acc_o[t][i] * alpha);
          }
          m[t] = m_new;
        }
      }
    }
  }

  // merge the row groups of a warp: lanes li of every group hold the same pairs
#pragma unroll
  for (int t = 0; t < NQ; ++t) {
    float mx = m[t];
#pragma unroll
    for (int off = LPR; off < 32; off <<= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
    // a group that saw no row has m = -inf, l = 0, acc = 0
    const float wt = m[t] == -INFINITY ? 0.f : expf(m[t] - mx);
    float lw = l[t] * wt;
#pragma unroll
    for (int off = LPR; off < 32; off <<= 1) lw += __shfl_xor_sync(0xffffffffu, lw, off);
#pragma unroll
    for (int i = 0; i < VEC; ++i) {
      float ae = acc_e[t][i] * wt, ao = acc_o[t][i] * wt;
#pragma unroll
      for (int off = LPR; off < 32; off <<= 1) {
        ae += __shfl_xor_sync(0xffffffffu, ae, off);
        ao += __shfl_xor_sync(0xffffffffu, ao, off);
      }
      acc_e[t][i] = ae;
      acc_o[t][i] = ao;
    }
    if (sub == 0) {
      if (active) {
#pragma unroll
        for (int i = 0; i < VEC; ++i) {
          sm_acc[warp][t][j0 + i] = acc_e[t][i];
          sm_acc[warp][t][HALF + j0 + i] = acc_o[t][i];
        }
      }
      if (li == 0) {
        sm_m[warp][t] = mx;
        sm_l[warp][t] = lw;
      }
    }
  }
  __syncthreads();

  for (int e = threadIdx.x; e < nq * D; e += blockDim.x) {
    const int t = e / D;
    const int c = e % D;  // pair order
    float mx = -INFINITY;
#pragma unroll
    for (int v = 0; v < kWarps; ++v) mx = fmaxf(mx, sm_m[v][t]);
    float den = 0.f, num = 0.f;
#pragma unroll
    for (int v = 0; v < kWarps; ++v) {
      const float wv = sm_m[v][t] == -INFINITY ? 0.f : expf(sm_m[v][t] - mx);
      den = fmaf(wv, sm_l[v][t], den);
      num = fmaf(wv, sm_acc[v][t][c], num);
    }
    const int dim = pair_dim(c % HALF, c / HALF, D, split);
    store_out(out + ((size_t)b * K + q0 + t) * hd + (size_t)h * D + dim, num / den);
  }
}

template <int D, int NQ>
void launch_nq(const void* q, const void* kv, const void* sc, const void* pos_ptr,
               int pos_stride, int pos_scalar, const void* bias, void* out, int out_f32,
               int B, int S, int H, int K, int split, cudaStream_t stream) {
  const dim3 grid(B * H, (K + NQ - 1) / NQ);
  const dim3 block(kWarps * 32);
  const float scale = 1.0f / sqrtf(static_cast<float>(2 * (D / 2)));
  const auto* qp = static_cast<const __nv_bfloat16*>(q);
  const auto* kvp = static_cast<const int8_t*>(kv);
  const auto* sp = static_cast<const float*>(sc);
  const auto* pp = static_cast<const int*>(pos_ptr);
  const auto* bp = static_cast<const float*>(bias);
  if (out_f32) {
    flash_chunk_q4_kernel<D, NQ, float><<<grid, block, 0, stream>>>(
        qp, kvp, sp, pp, pos_stride, pos_scalar, bp, static_cast<float*>(out), S, H, K, split,
        scale);
  } else {
    flash_chunk_q4_kernel<D, NQ, __nv_bfloat16><<<grid, block, 0, stream>>>(
        qp, kvp, sp, pp, pos_stride, pos_scalar, bp, static_cast<__nv_bfloat16*>(out), S, H, K,
        split, scale);
  }
}

// the query tile: the smallest of 2, 4 and 8 that holds K, at most 8
template <int D>
void launch(const void* q, const void* kv, const void* sc, const void* pos_ptr, int pos_stride,
            int pos_scalar, const void* bias, void* out, int out_f32, int B, int S, int H,
            int K, int split, cudaStream_t stream) {
  if (K <= 2) {
    launch_nq<D, 2>(q, kv, sc, pos_ptr, pos_stride, pos_scalar, bias, out, out_f32, B, S, H, K,
                    split, stream);
  } else if (K <= 4) {
    launch_nq<D, 4>(q, kv, sc, pos_ptr, pos_stride, pos_scalar, bias, out, out_f32, B, S, H, K,
                    split, stream);
  } else {
    launch_nq<D, 8>(q, kv, sc, pos_ptr, pos_stride, pos_scalar, bias, out, out_f32, B, S, H, K,
                    split, stream);
  }
}

}  // namespace

// q (B, K, H*D) bf16; kv (B, S, H*D) int8 carriers ([k | v], H*D/2 each);
// sc (B, S, 2*H) f32; pos: pos_ptr[b * pos_stride] int32 when pos_ptr is not
// null, else pos_scalar; bias (B, S) f32 or null; out (B, K, H*D) f32 when
// out_f32, else bf16; split selects the split-rope pair layout.
// Returns a cudaError_t.
extern "C" int flash_chunk_q4(const void* q, const void* kv, const void* sc, const void* pos_ptr,
                              int pos_stride, int pos_scalar, const void* bias, void* out,
                              int out_f32, int B, int S, int H, int D, int K, int split,
                              void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (B <= 0 || K <= 0) return 0;
  switch (D) {
    case 64:
      launch<64>(q, kv, sc, pos_ptr, pos_stride, pos_scalar, bias, out, out_f32, B, S, H, K,
                 split, st);
      break;
    case 100:
      launch<100>(q, kv, sc, pos_ptr, pos_stride, pos_scalar, bias, out, out_f32, B, S, H, K,
                  split, st);
      break;
    case 128:
      launch<128>(q, kv, sc, pos_ptr, pos_stride, pos_scalar, bias, out, out_f32, B, S, H, K,
                  split, st);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
