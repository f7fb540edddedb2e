// Single-query decode attention over an int8 [k|v] cache slab with per-row,
// per-head f32 scales.
//
// Replaces the Pallas kernel `_kernel_q8` of controlar_tpu/ops/flash_decode2.py
// (flash_decode_attention2_q8). For each batch row b and head h:
//   s_r = (q[b,h] . kint[b,r,h]) * ks[b,r,h] / sqrt(D) + bias[b,r]
//   out[b,h] = sum_r softmax(s)_r * vs[b,r,h] * vint[b,r,h]
// over the cache rows r <= pos[b]; the softmax is taken online in fp32 and
// the v scale is folded into p, as the TPU kernel does.
//
// Bound: memory. Each call reads every live row once: 2*H*D int8 values and
// 2*H f32 scales per row, half the bytes of the bf16 slab. At the GPT-B c2i
// last step (16 batch rows, 12 heads, D=64, 576 live rows) that is ~14.2 MB
// of values and 0.9 MB of scales against ~2*H*D flops per byte pair, far
// below the card's ridge point. The design is the bf16 kernel's
// (csrc/flash_decode.cu), one pass with no intermediate in device memory:
//   - one thread block per (b, head), 8 warps;
//   - a warp is cut into row groups of LPR lanes; each lane converts VEC
//     int8 values of the head to fp32 in registers (8-byte loads for D = 64
//     and 128; 4-byte loads for D = 100, whose 100-byte head rows are only
//     4-byte aligned);
//   - q.k is reduced with warp shuffles inside the group; each group keeps
//     its own running max, sum and accumulator, merged in shared memory.
// q is read as bf16 (the JAX kernel casts it too); p * vs and alpha stay fp32
// here, where the TPU kernel rounds them to bf16.
//
// The entry `flash_stacked_q8` runs the same kernel over layer `layer` of a
// stacked (L, B, S, 2*H*D) int8 cache and its (L, B, S, 2*H) scales; it
// replaces `_kernel_q8s` of controlar_tpu/ops/flash_decode_stacked.py
// (flash_stacked_q8). The layer is an offset on both slab pointers; rows
// r < pos[b] come from the slabs and row pos[b], this step's in-flight row,
// from the operands new_kv (B, 2*H*D) int8 and new_sc (B, 2*H), without the
// bias (0 at decode positions by the caller's contract).
//
// The entry `flash_decode_q8_append` replaces `_kernel_q8a` of
// controlar_tpu/ops/flash_decode2.py (flash_decode_attention2_q8_append):
// the stacked path at layer 0 of a flat (B, S, 2*H*D) slab (rows [0, pos[b])
// from the slab, row pos[b] scored from new_kv and new_sc), plus an epilogue
// in which block (b, h) writes its head's D key bytes, D value bytes and two
// scales into row pos[b] of the slabs. One block per (b, h), so the writes
// do not overlap, and no block reads row pos[b] from the slab. Bound: bytes,
// as above, plus the written row (2*H*D + 8*H bytes per batch row); the
// epilogue adds no pass over the slab, where the TPU kernel read and wrote
// back a 32-row window around the row.
//
// Plain C interface, loaded with ctypes. The launch goes on the caller's
// stream; the function returns cudaGetLastError() after the launch.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;

// VEC: int8 elements per lane; LPR: lanes per cache row (power of two)
template <int D> struct HeadCfg;
template <> struct HeadCfg<64> { static constexpr int VEC = 8; static constexpr int LPR = 8; };
template <> struct HeadCfg<100> { static constexpr int VEC = 4; static constexpr int LPR = 32; };
template <> struct HeadCfg<128> { static constexpr int VEC = 8; static constexpr int LPR = 16; };

template <int VEC> struct BfVecT;
template <> struct BfVecT<8> { using T = uint4; };  // 16 bytes of bf16
template <> struct BfVecT<4> { using T = uint2; };  // 8 bytes of bf16

template <int VEC>
__device__ __forceinline__ void load_bf16(const __nv_bfloat16* p, float* out) {
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
__device__ __forceinline__ void load_i8(const int8_t* p, float* out) {
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

// STACKED: rows [0, pos) from kv and sc, then the in-flight row from new_kv
// and new_sc; APPEND (with STACKED): then write that row into kv_out and
// sc_out (the slabs kv and sc point into) at row pos
template <int D, bool STACKED, bool APPEND, typename OutT>
__global__ void __launch_bounds__(kWarps * 32)
flash_decode_q8_kernel(const __nv_bfloat16* __restrict__ q,  // (B, H*D)
                       const int8_t* __restrict__ kv,        // (B, S, 2*H*D)
                       const float* __restrict__ sc,         // (B, S, 2*H) [ks | vs]
                       const int8_t* __restrict__ new_kv,    // (B, 2*H*D) or null
                       const float* __restrict__ new_sc,     // (B, 2*H) or null
                       const int* __restrict__ pos_ptr,      // (B,) or scalar, or null
                       int pos_stride, int pos_scalar,
                       const float* __restrict__ bias,       // (B, S) or null
                       OutT* __restrict__ out,               // (B, H*D)
                       int8_t* kv_out, float* sc_out,        // kv, sc or null
                       int S, int H, float scale) {
  static_assert(STACKED || !APPEND, "the append reads its row from the operands");
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
  const int8_t* kbase = kv + (size_t)b * S * row_stride + (size_t)h * D + d0;
  const float* sbase = sc + (size_t)b * S * 2 * H + h;
  const int8_t* nbase =
      STACKED ? new_kv + (size_t)b * row_stride + (size_t)h * D + d0 : nullptr;
  const float* nsrow = STACKED ? new_sc + (size_t)b * 2 * H + h : nullptr;
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
      const int8_t* rp = inflight ? nbase : kbase + (size_t)r * row_stride;
      load_i8<VEC>(rp, kf);
      load_i8<VEC>(rp + hd, vf);
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
      const float* srow = inflight ? nsrow : sbase + (size_t)r * 2 * H;
      s = s * srow[0] * scale;
      if (brow && !inflight) s += brow[r];
      const float m_new = fmaxf(m, s);
      const float alpha = expf(m - m_new);  // exp(-inf) = 0 on the first row
      const float p = expf(s - m_new);
      l = l * alpha + p;
      const float pv = p * srow[H];  // the v scale folded into p
#pragma unroll
      for (int i = 0; i < VEC; ++i) acc[i] = fmaf(pv, vf[i], acc[i] * alpha);
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

  if constexpr (APPEND) {
    if (pos >= 0 && pos < S) {  // the wrapper checks a scalar pos; a per-slot one is trusted
      int8_t* dst = kv_out + ((size_t)b * S + pos) * row_stride + (size_t)h * D;
      const int8_t* src = new_kv + (size_t)b * row_stride + (size_t)h * D;
      for (int i = threadIdx.x; i < D; i += blockDim.x) {
        dst[i] = src[i];
        dst[hd + i] = src[hd + i];
      }
      if (threadIdx.x == 0) {
        float* srow = sc_out + ((size_t)b * S + pos) * 2 * H;
        srow[h] = nsrow[0];
        srow[H + h] = nsrow[H];
      }
    }
  }
}

template <int D, bool STACKED, bool APPEND>
void launch(const void* q, const void* kv, const void* sc, const void* new_kv,
            const void* new_sc, const void* pos_ptr, int pos_stride, int pos_scalar,
            const void* bias, void* out, int out_f32, int B, int S, int H,
            cudaStream_t stream) {
  auto* kv_out = APPEND ? static_cast<int8_t*>(const_cast<void*>(kv)) : nullptr;
  auto* sc_out = APPEND ? static_cast<float*>(const_cast<void*>(sc)) : nullptr;
  const dim3 grid(B * H);
  const dim3 block(kWarps * 32);
  const float scale = 1.0f / sqrtf(static_cast<float>(D));
  const auto* qp = static_cast<const __nv_bfloat16*>(q);
  const auto* kvp = static_cast<const int8_t*>(kv);
  const auto* sp = static_cast<const float*>(sc);
  const auto* nkp = static_cast<const int8_t*>(new_kv);
  const auto* nsp = static_cast<const float*>(new_sc);
  const auto* pp = static_cast<const int*>(pos_ptr);
  const auto* bp = static_cast<const float*>(bias);
  if (out_f32) {
    flash_decode_q8_kernel<D, STACKED, APPEND, float><<<grid, block, 0, stream>>>(
        qp, kvp, sp, nkp, nsp, pp, pos_stride, pos_scalar, bp, static_cast<float*>(out), kv_out,
        sc_out, S, H, scale);
  } else {
    flash_decode_q8_kernel<D, STACKED, APPEND, __nv_bfloat16><<<grid, block, 0, stream>>>(
        qp, kvp, sp, nkp, nsp, pp, pos_stride, pos_scalar, bp,
        static_cast<__nv_bfloat16*>(out), kv_out, sc_out, S, H, scale);
  }
}

template <bool STACKED, bool APPEND = false>
int dispatch(const void* q, const void* kv, const void* sc, const void* new_kv,
             const void* new_sc, const void* pos_ptr, int pos_stride, int pos_scalar,
             const void* bias, void* out, int out_f32, int B, int S, int H, int D,
             cudaStream_t st) {
  switch (D) {
    case 64:
      launch<64, STACKED, APPEND>(q, kv, sc, new_kv, new_sc, pos_ptr, pos_stride,
                                  pos_scalar, bias, out, out_f32, B, S, H, st);
      break;
    case 100:
      launch<100, STACKED, APPEND>(q, kv, sc, new_kv, new_sc, pos_ptr, pos_stride,
                                   pos_scalar, bias, out, out_f32, B, S, H, st);
      break;
    case 128:
      launch<128, STACKED, APPEND>(q, kv, sc, new_kv, new_sc, pos_ptr, pos_stride,
                                   pos_scalar, bias, out, out_f32, B, S, H, st);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// q (B, H*D) bf16; kv (B, S, 2*H*D) int8; sc (B, S, 2*H) f32; pos:
// pos_ptr[b * pos_stride] int32 when pos_ptr is not null, else pos_scalar;
// bias (B, S) f32 or null; out (B, H*D) f32 when out_f32, else bf16.
// Returns a cudaError_t.
extern "C" int flash_decode_q8(const void* q, const void* kv, const void* sc,
                               const void* pos_ptr, int pos_stride, int pos_scalar,
                               const void* bias, void* out, int out_f32, int B, int S, int H,
                               int D, void* stream) {
  return dispatch<false>(q, kv, sc, nullptr, nullptr, pos_ptr, pos_stride, pos_scalar, bias,
                         out, out_f32, B, S, H, D, static_cast<cudaStream_t>(stream));
}

// q (B, H*D) bf16; new_kv (B, 2*H*D) int8 and new_sc (B, 2*H) f32, the rows
// at position pos[b]; kv_stack (L, B, S, 2*H*D) int8 and sc_stack
// (L, B, S, 2*H) f32, of which layer `layer` is read (rows [0, pos[b]));
// pos, bias, out and out_f32 as for flash_decode_q8. Returns a cudaError_t.
extern "C" int flash_stacked_q8(const void* q, const void* new_kv, const void* new_sc,
                                const void* kv_stack, const void* sc_stack, int layer,
                                const void* pos_ptr, int pos_stride, int pos_scalar,
                                const void* bias, void* out, int out_f32, int B, int S, int H,
                                int D, void* stream) {
  const size_t rows = (size_t)layer * B * S;
  const auto* kv = static_cast<const int8_t*>(kv_stack) + rows * 2 * H * D;
  const auto* sc = static_cast<const float*>(sc_stack) + rows * 2 * H;
  return dispatch<true>(q, kv, sc, new_kv, new_sc, pos_ptr, pos_stride, pos_scalar, bias,
                        out, out_f32, B, S, H, D, static_cast<cudaStream_t>(stream));
}

// q (B, H*D) bf16; new_kv (B, 2*H*D) int8 and new_sc (B, 2*H) f32, the row
// at position pos[b]; kv (B, S, 2*H*D) int8 and sc (B, S, 2*H) f32, whose
// rows [0, pos[b]) are read and whose row pos[b] is written with new_kv and
// new_sc; pos, bias, out and out_f32 as for flash_decode_q8 (the bias is not
// added to row pos[b]). Returns a cudaError_t.
extern "C" int flash_decode_q8_append(const void* q, const void* new_kv, const void* new_sc,
                                      void* kv, void* sc, const void* pos_ptr, int pos_stride,
                                      int pos_scalar, const void* bias, void* out, int out_f32,
                                      int B, int S, int H, int D, void* stream) {
  return dispatch<true, true>(q, kv, sc, new_kv, new_sc, pos_ptr, pos_stride, pos_scalar, bias,
                              out, out_f32, B, S, H, D, static_cast<cudaStream_t>(stream));
}
