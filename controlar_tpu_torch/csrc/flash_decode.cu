// Single-query decode attention over an interleaved [k|v] bf16 cache slab.
//
// Replaces the Pallas kernel `_kernel` of controlar_tpu/ops/flash_decode2.py
// (flash_decode_attention2). For each batch row b and head h it computes
//   out[b, h] = softmax_r( q[b,h] . k[b,r,h] / sqrt(D) + bias[b,r] ) . v[b,r,h]
// over the cache rows r <= pos[b], with the softmax taken online in fp32.
//
// Bound: memory. Each call reads every live cache row once: at the GPT-B
// c2i main shapes (16 rows of batch, 12 heads, D=64) that is
// 16 * (pos+1) * 2*768 * 2 bytes, against ~4*16*12*64*(pos+1) flops, far
// below the card's ridge point. The design is one pass over the slab with no
// intermediate in device memory:
//   - one thread block per (b, head), 8 warps;
//   - a warp is cut into row groups of LPR lanes; each lane holds VEC
//     elements of the head (16-byte loads for D = 64 and 128, 8-byte loads
//     for D = 100), so a warp scores 32/LPR rows at a time;
//   - q.k is reduced with warp shuffles inside the row group; each group keeps
//     its own fp32 running max m, sum l and accumulator acc over its rows;
//   - at the end the groups' softmax states are merged in shared memory.
// q is read as bf16 (the JAX kernel casts q to bf16 as well); p and alpha
// stay in fp32 here, where the TPU kernel rounds them to bf16.
//
// The entry `flash_stacked` runs the same kernel over layer `layer` of a
// stacked (L, B, S, 2*H*D) cache; it replaces `_kernel_bf16s` of
// controlar_tpu/ops/flash_decode_stacked.py (flash_stacked). The layer is an
// offset on the slab pointer. Rows r < pos[b] come from the slab and row
// pos[b], the in-flight row of this step, from the operand new_kv (B, 2*H*D),
// without the bias (the caller's bias is 0 at decode positions). The TPU
// kernel's block-diagonal products, row selects and chained cross-slot DMA
// are artefacts of its layout and have no counterpart here.
//
// Plain C interface, loaded with ctypes. The launch goes on the caller's
// stream; the function returns cudaGetLastError() after the launch.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;

// VEC: bf16 elements per lane; LPR: lanes per cache row (power of two)
template <int D> struct HeadCfg;
template <> struct HeadCfg<64> { static constexpr int VEC = 8; static constexpr int LPR = 8; };
template <> struct HeadCfg<100> { static constexpr int VEC = 4; static constexpr int LPR = 32; };
template <> struct HeadCfg<128> { static constexpr int VEC = 8; static constexpr int LPR = 16; };

template <int VEC> struct VecT;
template <> struct VecT<8> { using T = uint4; };  // 16 bytes
template <> struct VecT<4> { using T = uint2; };  // 8 bytes

template <int VEC>
__device__ __forceinline__ void load_bf16(const __nv_bfloat16* p, float* out) {
  using T = typename VecT<VEC>::T;
  T raw = *reinterpret_cast<const T*>(p);
  const __nv_bfloat162* h2 = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
  for (int i = 0; i < VEC / 2; ++i) {
    float2 f = __bfloat1622float2(h2[i]);
    out[2 * i] = f.x;
    out[2 * i + 1] = f.y;
  }
}

__device__ __forceinline__ void store_out(float* p, float x) { *p = x; }
__device__ __forceinline__ void store_out(__nv_bfloat16* p, float x) { *p = __float2bfloat16(x); }

// STACKED: rows [0, pos) from kv, then the in-flight row from new_kv
template <int D, bool STACKED, typename OutT>
__global__ void __launch_bounds__(kWarps * 32)
flash_decode_kernel(const __nv_bfloat16* __restrict__ q,   // (B, H*D)
                    const __nv_bfloat16* __restrict__ kv,  // (B, S, 2*H*D)
                    const __nv_bfloat16* __restrict__ new_kv,  // (B, 2*H*D) or null
                    const int* __restrict__ pos_ptr,       // (B,) or scalar, or null
                    int pos_stride, int pos_scalar,
                    const float* __restrict__ bias,        // (B, S) or null
                    OutT* __restrict__ out,                // (B, H*D)
                    int S, int H, float scale) {
  constexpr int VEC = HeadCfg<D>::VEC;
  constexpr int LPR = HeadCfg<D>::LPR;
  constexpr int GPW = 32 / LPR;      // row groups per warp
  constexpr int G = kWarps * GPW;    // row groups per block

  __shared__ float sm_acc[G][D];
  __shared__ float sm_m[G];
  __shared__ float sm_l[G];

  const int b = blockIdx.x / H;
  const int h = blockIdx.x % H;
  const int hd = H * D;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int li = lane % LPR;
  const int sub = lane / LPR;
  const int group = warp * GPW + sub;
  const int d0 = li * VEC;
  const bool active = d0 < D;  // D = 100 leaves the last lanes of a group idle

  const int pos = pos_ptr ? pos_ptr[(size_t)b * pos_stride] : pos_scalar;
  // slab rows [0, n_live); a stacked call adds the in-flight row as row n_live
  const int n_live = STACKED ? max(0, min(pos, S)) : min(pos + 1, S);
  const int n_rows = n_live + (STACKED ? 1 : 0);

  float qf[VEC], acc[VEC];
#pragma unroll
  for (int i = 0; i < VEC; ++i) { qf[i] = 0.f; acc[i] = 0.f; }
  if (active) load_bf16<VEC>(q + (size_t)b * hd + (size_t)h * D + d0, qf);
  float m = -INFINITY;
  float l = 0.f;

  const size_t row_stride = 2 * (size_t)hd;
  const __nv_bfloat16* kbase = kv + (size_t)b * S * row_stride + (size_t)h * D + d0;
  const __nv_bfloat16* nbase =
      STACKED ? new_kv + (size_t)b * row_stride + (size_t)h * D + d0 : nullptr;
  const float* brow = bias ? bias + (size_t)b * S : nullptr;

  // every lane of a warp runs the same trip count, so the full-mask shuffles
  // below never see a diverged warp; rows past n_rows are skipped after them
#pragma unroll 2
  for (int base = warp * GPW; base < n_rows; base += G) {
    const int r = base + sub;
    const bool valid = r < n_rows;
    const bool inflight = STACKED && r == n_live;
    float kf[VEC], vf[VEC];
    if (valid && active) {
      const __nv_bfloat16* rp = inflight ? nbase : kbase + (size_t)r * row_stride;
      load_bf16<VEC>(rp, kf);
      load_bf16<VEC>(rp + hd, vf);
    } else {
#pragma unroll
      for (int i = 0; i < VEC; ++i) { kf[i] = 0.f; vf[i] = 0.f; }
    }
    float s = 0.f;
#pragma unroll
    for (int i = 0; i < VEC; ++i) s = fmaf(qf[i], kf[i], s);
#pragma unroll
    for (int off = LPR / 2; off > 0; off >>= 1) s += __shfl_xor_sync(0xffffffffu, s, off);
    if (valid) {
      s *= scale;
      if (brow && !inflight) s += brow[r];
      const float m_new = fmaxf(m, s);
      const float alpha = expf(m - m_new);  // exp(-inf) = 0 on the first row
      const float p = expf(s - m_new);
      l = l * alpha + p;
#pragma unroll
      for (int i = 0; i < VEC; ++i) acc[i] = fmaf(p, vf[i], acc[i] * alpha);
      m = m_new;
    }
  }

  if (active) {
#pragma unroll
    for (int i = 0; i < VEC; ++i) sm_acc[group][d0 + i] = acc[i];
  }
  if (li == 0) {
    sm_m[group] = m;
    sm_l[group] = l;
  }
  __syncthreads();

  for (int d = threadIdx.x; d < D; d += blockDim.x) {
    float mx = -INFINITY;
#pragma unroll
    for (int g = 0; g < G; ++g) mx = fmaxf(mx, sm_m[g]);
    float den = 0.f, num = 0.f;
#pragma unroll
    for (int g = 0; g < G; ++g) {
      // a group that saw no row has m = -inf, l = 0, acc = 0
      const float w = sm_m[g] == -INFINITY ? 0.f : expf(sm_m[g] - mx);
      den = fmaf(w, sm_l[g], den);
      num = fmaf(w, sm_acc[g][d], num);
    }
    store_out(out + (size_t)b * hd + (size_t)h * D + d, num / den);
  }
}

template <int D, bool STACKED>
void launch(const void* q, const void* kv, const void* new_kv, const void* pos_ptr,
            int pos_stride, int pos_scalar, const void* bias, void* out, int out_f32, int B,
            int S, int H, cudaStream_t stream) {
  const dim3 grid(B * H);
  const dim3 block(kWarps * 32);
  const float scale = 1.0f / sqrtf(static_cast<float>(D));
  const auto* qp = static_cast<const __nv_bfloat16*>(q);
  const auto* kvp = static_cast<const __nv_bfloat16*>(kv);
  const auto* np_ = static_cast<const __nv_bfloat16*>(new_kv);
  const auto* pp = static_cast<const int*>(pos_ptr);
  const auto* bp = static_cast<const float*>(bias);
  if (out_f32) {
    flash_decode_kernel<D, STACKED, float><<<grid, block, 0, stream>>>(
        qp, kvp, np_, pp, pos_stride, pos_scalar, bp, static_cast<float*>(out), S, H, scale);
  } else {
    flash_decode_kernel<D, STACKED, __nv_bfloat16><<<grid, block, 0, stream>>>(
        qp, kvp, np_, pp, pos_stride, pos_scalar, bp, static_cast<__nv_bfloat16*>(out), S, H,
        scale);
  }
}

template <bool STACKED>
int dispatch(const void* q, const void* kv, const void* new_kv, const void* pos_ptr,
             int pos_stride, int pos_scalar, const void* bias, void* out, int out_f32, int B,
             int S, int H, int D, cudaStream_t st) {
  switch (D) {
    case 64:
      launch<64, STACKED>(q, kv, new_kv, pos_ptr, pos_stride, pos_scalar, bias, out, out_f32,
                          B, S, H, st);
      break;
    case 100:
      launch<100, STACKED>(q, kv, new_kv, pos_ptr, pos_stride, pos_scalar, bias, out, out_f32,
                           B, S, H, st);
      break;
    case 128:
      launch<128, STACKED>(q, kv, new_kv, pos_ptr, pos_stride, pos_scalar, bias, out, out_f32,
                           B, S, H, st);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// q (B, H*D) bf16; kv (B, S, 2*H*D) bf16; pos: pos_ptr[b * pos_stride] int32
// when pos_ptr is not null, else pos_scalar; bias (B, S) f32 or null;
// out (B, H*D) f32 when out_f32, else bf16. Returns a cudaError_t.
extern "C" int flash_decode_attention(const void* q, const void* kv, const void* pos_ptr,
                                      int pos_stride, int pos_scalar, const void* bias,
                                      void* out, int out_f32, int B, int S, int H, int D,
                                      void* stream) {
  return dispatch<false>(q, kv, nullptr, pos_ptr, pos_stride, pos_scalar, bias, out, out_f32,
                         B, S, H, D, static_cast<cudaStream_t>(stream));
}

// q (B, H*D) bf16; new_kv (B, 2*H*D) bf16, the rows at position pos[b];
// stack (L, B, S, 2*H*D) bf16, of which layer `layer` is read (rows
// [0, pos[b])); pos, bias, out and out_f32 as for flash_decode_attention.
// Returns a cudaError_t.
extern "C" int flash_stacked(const void* q, const void* new_kv, const void* stack, int layer,
                             const void* pos_ptr, int pos_stride, int pos_scalar,
                             const void* bias, void* out, int out_f32, int B, int S, int H,
                             int D, void* stream) {
  const auto* slab = static_cast<const __nv_bfloat16*>(stack)
                     + (size_t)layer * B * S * 2 * (size_t)H * D;
  return dispatch<true>(q, slab, new_kv, pos_ptr, pos_stride, pos_scalar, bias, out, out_f32,
                        B, S, H, D, static_cast<cudaStream_t>(stream));
}
