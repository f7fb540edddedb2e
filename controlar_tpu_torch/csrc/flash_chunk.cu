// K-query chunk attention over an interleaved [k|v] cache slab, bf16 or int8
// with per-row, per-head f32 scales.
//
// Replaces the Pallas kernel `_kernel` of controlar_tpu/ops/flash_chunk.py
// (`_call`, behind flash_chunk_attention and flash_chunk_attention_q8): the
// speculative verify and chunked-prefill attention. For batch row b, head h
// and chunk query j (the chunk's own rows are already in the cache):
//   s_r = q[b,j,h] . k[b,r,h] * ks[b,r,h] / sqrt(D) + (r == pos[b]+j ? 0 : bias[b,r])
//   out[b,j,h] = sum_r softmax(s)_r * vs[b,r,h] * v[b,r,h]
// over the rows r <= pos[b] + j (ks = vs = 1 for the bf16 slab). The bias is
// not added on a query's own row (the diagonal exception), so a fully
// masked left-padded caption row still has one finite score.
//
// Bound: memory. A verify call reads the live rows once for all K queries:
// at the GPT-3B spec cells (16 batch rows, 32 heads x 100, 576 live rows)
// that is ~118 MB of bf16 or ~61 MB of int8 values, against 4 flops per
// value pair per query, far below the card's ridge point for K <= 8. The
// design is that of the decode kernels (csrc/flash_decode.cu and
// flash_decode_q8.cu), with a tile of NQ queries per block so that every
// cache row a block loads is scored against all of them:
//   - one thread block per (b, head, tile of NQ = 2, 4 or 8 queries),
//     8 warps; the block stops at the last row its last query sees;
//   - a warp is cut into row groups of LPR lanes; each lane holds VEC
//     elements of the head (bf16: 16-byte loads for D = 64 and 128, 8-byte
//     for D = 100; int8: 8 and 4 bytes), and the NQ queries' elements in
//     registers;
//   - q.k is reduced with warp shuffles inside the row group; each group
//     keeps an fp32 running max, sum and accumulator per query;
//   - the groups of a warp are merged with shuffles, the 8 warps in shared
//     memory.
// q is read as bf16 (the JAX kernel casts q to bf16 too); p, p * vs and
// alpha stay fp32, where the TPU kernel rounds them to bf16.
//
// Plain C interface, loaded with ctypes. The launch goes on the caller's
// stream; the function returns cudaGetLastError() after the launch.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;

// VEC: elements per lane; LPR: lanes per cache row (power of two)
template <int D> struct HeadCfg;
template <> struct HeadCfg<64> { static constexpr int VEC = 8; static constexpr int LPR = 8; };
template <> struct HeadCfg<100> { static constexpr int VEC = 4; static constexpr int LPR = 32; };
template <> struct HeadCfg<128> { static constexpr int VEC = 8; static constexpr int LPR = 16; };

template <int VEC> struct BfVecT;
template <> struct BfVecT<8> { using T = uint4; };  // 16 bytes of bf16
template <> struct BfVecT<4> { using T = uint2; };  // 8 bytes of bf16

template <int VEC>
__device__ __forceinline__ void load_vec(const __nv_bfloat16* p, float* out) {
  using T = typename BfVecT<VEC>::T;
  T raw = *reinterpret_cast<const T*>(p);
  const __nv_bfloat162* h2 = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
  for (int i = 0; i < VEC / 2; ++i) {
    float2 f = __bfloat1622float2(h2[i]);
    out[2 * i] = f.x;
    out[2 * i + 1] = f.y;
  }
}

// VEC signed bytes -> fp32, one 4- or 8-byte load
template <int VEC>
__device__ __forceinline__ void load_vec(const int8_t* p, float* out) {
  uint32_t w[VEC / 4];
  if constexpr (VEC == 8) {
    const uint2 raw = *reinterpret_cast<const uint2*>(p);
    w[0] = raw.x;
    w[1] = raw.y;
  } else {
    w[0] = *reinterpret_cast<const uint32_t*>(p);
  }
#pragma unroll
  for (int i = 0; i < VEC; ++i) {
    out[i] = static_cast<float>(static_cast<int8_t>((w[i / 4] >> (8 * (i % 4))) & 0xffu));
  }
}

__device__ __forceinline__ void store_out(float* p, float x) { *p = x; }
__device__ __forceinline__ void store_out(__nv_bfloat16* p, float x) { *p = __float2bfloat16(x); }

template <int D, int NQ, typename KV, typename OutT>
__global__ void __launch_bounds__(kWarps * 32)
flash_chunk_kernel(const __nv_bfloat16* __restrict__ q,  // (B, K, H*D)
                   const KV* __restrict__ kv,            // (B, S, 2*H*D)
                   const float* __restrict__ sc,         // (B, S, 2*H) [ks | vs], or null (bf16)
                   const int* __restrict__ pos_ptr,      // (B,) or scalar, or null
                   int pos_stride, int pos_scalar,
                   const float* __restrict__ bias,       // (B, S) or null
                   OutT* __restrict__ out,               // (B, K, H*D)
                   int S, int H, int K, float scale) {
  constexpr int VEC = HeadCfg<D>::VEC;
  constexpr int LPR = HeadCfg<D>::LPR;
  constexpr int GPW = 32 / LPR;      // row groups per warp
  constexpr int G = kWarps * GPW;    // row groups per block

  __shared__ float sm_acc[kWarps][NQ][D];
  __shared__ float sm_m[kWarps][NQ];
  __shared__ float sm_l[kWarps][NQ];

  const int b = blockIdx.x / H;
  const int h = blockIdx.x % H;
  const int q0 = blockIdx.y * NQ;    // the tile's first query
  const int hd = H * D;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int li = lane % LPR;
  const int sub = lane / LPR;
  const int d0 = li * VEC;
  const bool active = d0 < D;  // D = 100 leaves the last lanes of a group idle

  const int pos = pos_ptr ? pos_ptr[(size_t)b * pos_stride] : pos_scalar;
  const int nq = min(NQ, K - q0);    // the tile's queries that exist
  const int n_rows = min(pos + q0 + nq, S);

  float qf[NQ][VEC], acc[NQ][VEC], m[NQ], l[NQ];
#pragma unroll
  for (int j = 0; j < NQ; ++j) {
#pragma unroll
    for (int i = 0; i < VEC; ++i) { qf[j][i] = 0.f; acc[j][i] = 0.f; }
    if (active && j < nq) {
      load_vec<VEC>(q + ((size_t)b * K + q0 + j) * hd + (size_t)h * D + d0, qf[j]);
    }
    m[j] = -INFINITY;
    l[j] = 0.f;
  }

  const size_t row_stride = 2 * (size_t)hd;
  const KV* kbase = kv + (size_t)b * S * row_stride + (size_t)h * D + d0;
  const float* sbase = sc ? sc + (size_t)b * S * 2 * H + h : nullptr;
  const float* brow = bias ? bias + (size_t)b * S : nullptr;

  // every lane of a warp runs the same trip count, so the full-mask shuffles
  // below never see a diverged warp; rows past n_rows are skipped after them
  for (int base = warp * GPW; base < n_rows; base += G) {
    const int r = base + sub;
    const bool valid = r < n_rows;
    float kf[VEC], vf[VEC];
    if (valid && active) {
      const KV* rp = kbase + (size_t)r * row_stride;
      load_vec<VEC>(rp, kf);
      load_vec<VEC>(rp + hd, vf);
    } else {
#pragma unroll
      for (int i = 0; i < VEC; ++i) { kf[i] = 0.f; vf[i] = 0.f; }
    }
    float s[NQ];
#pragma unroll
    for (int j = 0; j < NQ; ++j) {
      s[j] = 0.f;
#pragma unroll
      for (int i = 0; i < VEC; ++i) s[j] = fmaf(qf[j][i], kf[i], s[j]);
    }
#pragma unroll
    for (int off = LPR / 2; off > 0; off >>= 1) {
#pragma unroll
      for (int j = 0; j < NQ; ++j) s[j] += __shfl_xor_sync(0xffffffffu, s[j], off);
    }
    if (valid) {
      const float ks = sbase ? sbase[(size_t)r * 2 * H] * scale : scale;
      const float vs = sbase ? sbase[(size_t)r * 2 * H + H] : 1.f;
      const float br = brow ? brow[r] : 0.f;
#pragma unroll
      for (int j = 0; j < NQ; ++j) {
        const int own = pos + q0 + j;  // query j's own row, the last it sees
        if (j < nq && r <= own) {
          float sj = s[j] * ks;
          if (r != own) sj += br;  // the diagonal exception
          const float m_new = fmaxf(m[j], sj);
          const float alpha = expf(m[j] - m_new);  // exp(-inf) = 0 on the first row
          const float p = expf(sj - m_new);
          l[j] = l[j] * alpha + p;
          const float pv = p * vs;  // the v scale folded into p
#pragma unroll
          for (int i = 0; i < VEC; ++i) acc[j][i] = fmaf(pv, vf[i], acc[j][i] * alpha);
          m[j] = m_new;
        }
      }
    }
  }

  // merge the row groups of a warp: lanes li of every group hold the same dims
#pragma unroll
  for (int j = 0; j < NQ; ++j) {
    float mx = m[j];
#pragma unroll
    for (int off = LPR; off < 32; off <<= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
    // a group that saw no row has m = -inf, l = 0, acc = 0
    const float w = m[j] == -INFINITY ? 0.f : expf(m[j] - mx);
    float lw = l[j] * w;
#pragma unroll
    for (int off = LPR; off < 32; off <<= 1) lw += __shfl_xor_sync(0xffffffffu, lw, off);
#pragma unroll
    for (int i = 0; i < VEC; ++i) {
      float a = acc[j][i] * w;
#pragma unroll
      for (int off = LPR; off < 32; off <<= 1) a += __shfl_xor_sync(0xffffffffu, a, off);
      acc[j][i] = a;
    }
    if (sub == 0) {
      if (active) {
#pragma unroll
        for (int i = 0; i < VEC; ++i) sm_acc[warp][j][d0 + i] = acc[j][i];
      }
      if (li == 0) {
        sm_m[warp][j] = mx;
        sm_l[warp][j] = lw;
      }
    }
  }
  __syncthreads();

  for (int e = threadIdx.x; e < nq * D; e += blockDim.x) {
    const int j = e / D;
    const int d = e % D;
    float mx = -INFINITY;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) mx = fmaxf(mx, sm_m[w][j]);
    float den = 0.f, num = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const float wt = sm_m[w][j] == -INFINITY ? 0.f : expf(sm_m[w][j] - mx);
      den = fmaf(wt, sm_l[w][j], den);
      num = fmaf(wt, sm_acc[w][j][d], num);
    }
    store_out(out + ((size_t)b * K + q0 + j) * hd + (size_t)h * D + d, num / den);
  }
}

template <int D, int NQ, typename KV>
void launch_nq(const void* q, const void* kv, const void* sc, const void* pos_ptr,
               int pos_stride, int pos_scalar, const void* bias, void* out, int out_f32,
               int B, int S, int H, int K, cudaStream_t stream) {
  const dim3 grid(B * H, (K + NQ - 1) / NQ);
  const dim3 block(kWarps * 32);
  const float scale = 1.0f / sqrtf(static_cast<float>(D));
  const auto* qp = static_cast<const __nv_bfloat16*>(q);
  const auto* kvp = static_cast<const KV*>(kv);
  const auto* sp = static_cast<const float*>(sc);
  const auto* pp = static_cast<const int*>(pos_ptr);
  const auto* bp = static_cast<const float*>(bias);
  if (out_f32) {
    flash_chunk_kernel<D, NQ, KV, float><<<grid, block, 0, stream>>>(
        qp, kvp, sp, pp, pos_stride, pos_scalar, bp, static_cast<float*>(out), S, H, K, scale);
  } else {
    flash_chunk_kernel<D, NQ, KV, __nv_bfloat16><<<grid, block, 0, stream>>>(
        qp, kvp, sp, pp, pos_stride, pos_scalar, bp, static_cast<__nv_bfloat16*>(out), S, H, K,
        scale);
  }
}

// the query tile: the smallest of 2, 4 and 8 that holds K, at most 8
template <int D, typename KV>
void launch(const void* q, const void* kv, const void* sc, const void* pos_ptr, int pos_stride,
            int pos_scalar, const void* bias, void* out, int out_f32, int B, int S, int H,
            int K, cudaStream_t stream) {
  if (K <= 2) {
    launch_nq<D, 2, KV>(q, kv, sc, pos_ptr, pos_stride, pos_scalar, bias, out, out_f32, B, S, H,
                        K, stream);
  } else if (K <= 4) {
    launch_nq<D, 4, KV>(q, kv, sc, pos_ptr, pos_stride, pos_scalar, bias, out, out_f32, B, S, H,
                        K, stream);
  } else {
    launch_nq<D, 8, KV>(q, kv, sc, pos_ptr, pos_stride, pos_scalar, bias, out, out_f32, B, S, H,
                        K, stream);
  }
}

template <typename KV>
int dispatch(const void* q, const void* kv, const void* sc, const void* pos_ptr, int pos_stride,
             int pos_scalar, const void* bias, void* out, int out_f32, int B, int S, int H,
             int D, int K, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (B <= 0 || K <= 0) return 0;
  switch (D) {
    case 64:
      launch<64, KV>(q, kv, sc, pos_ptr, pos_stride, pos_scalar, bias, out, out_f32, B, S, H, K,
                     st);
      break;
    case 100:
      launch<100, KV>(q, kv, sc, pos_ptr, pos_stride, pos_scalar, bias, out, out_f32, B, S, H, K,
                      st);
      break;
    case 128:
      launch<128, KV>(q, kv, sc, pos_ptr, pos_stride, pos_scalar, bias, out, out_f32, B, S, H, K,
                      st);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// q (B, K, H*D) bf16; kv (B, S, 2*H*D) bf16; pos: pos_ptr[b * pos_stride]
// int32 when pos_ptr is not null, else pos_scalar; bias (B, S) f32 or null;
// out (B, K, H*D) f32 when out_f32, else bf16. Returns a cudaError_t.
extern "C" int flash_chunk_attention(const void* q, const void* kv, const void* pos_ptr,
                                     int pos_stride, int pos_scalar, const void* bias, void* out,
                                     int out_f32, int B, int S, int H, int D, int K,
                                     void* stream) {
  return dispatch<__nv_bfloat16>(q, kv, nullptr, pos_ptr, pos_stride, pos_scalar, bias, out,
                                 out_f32, B, S, H, D, K, stream);
}

// As flash_chunk_attention over an int8 kv slab with sc (B, S, 2*H) f32
// per-row, per-head scales [ks | vs].
extern "C" int flash_chunk_q8(const void* q, const void* kv, const void* sc, const void* pos_ptr,
                              int pos_stride, int pos_scalar, const void* bias, void* out,
                              int out_f32, int B, int S, int H, int D, int K, void* stream) {
  return dispatch<int8_t>(q, kv, sc, pos_ptr, pos_stride, pos_scalar, bias, out, out_f32, B, S,
                          H, D, K, stream);
}
