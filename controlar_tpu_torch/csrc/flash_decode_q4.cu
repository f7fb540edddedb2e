// Single-query decode attention over a nibble-packed int4 [k|v] cache slab
// with per-row, per-head f32 scales.
//
// Replaces the Pallas kernel `_kernel_q4` of controlar_tpu/ops/flash_decode2.py
// (flash_decode_attention2_q4). A cache row holds H*D/2 k carriers, then
// H*D/2 v carriers; carrier j of head h holds the pair (even_j, odd_j) as
// low | high signed nibble: dims (2j, 2j+1) in the interleaved layout, or
// (j, D/2 + j) in the split-rope layout (split = 1). For each (b, h):
//   s_r = (q_even . klo + q_odd . khi) * ks[b,r,h] / sqrt(2 * (D/2)) + bias[b,r]
//   out[b,h] = sum_r softmax(s)_r * vs[b,r,h] * (vlo, vhi)
// over rows r <= pos[b], online softmax in fp32, the output pairs written
// back in the layout of q.
//
// Bound: memory. Each call reads every live row once: H*D bytes of carriers
// and 2*H f32 scales per row, a quarter of the bf16 slab. At the GPT-3B c2i
// last step (16 batch rows, 32 heads, D=100, 576 live rows) that is ~29.5 MB
// of carriers and 2.4 MB of scales. The design is that of the bf16 and int8
// kernels (csrc/flash_decode.cu): one block per (b, head), 8 warps, lanes
// grouped per cache row, shuffles for q.k, per-group online softmax merged
// in shared memory. A lane unpacks VEC carriers (2*VEC values) in
// registers: 4-byte loads for D = 64 and 128; 2-byte loads for D = 100,
// whose 50-byte head rows are only 2-byte aligned. Nibbles are unpacked from
// the sign-extended byte: lo = (c << 28) >> 28, hi = c >> 4.
// p * vs and alpha stay fp32, where the TPU kernel rounds them to bf16.
//
// The entry `flash_stacked_q4` runs the same kernel over layer `layer` of a
// stacked (L, B, S, H*D) carrier cache and its (L, B, S, 2*H) scales; it
// replaces `_kernel_q4s` of controlar_tpu/ops/flash_decode_stacked.py
// (flash_stacked_q4). The layer is an offset on both slab pointers; rows
// r < pos[b] come from the slabs and row pos[b], this step's in-flight row,
// from the operands new_kv (B, H*D) carriers and new_sc (B, 2*H), without
// the bias (0 at decode positions by the caller's contract).
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

// STACKED: rows [0, pos) from kv and sc, then the in-flight row from new_kv
// and new_sc
template <int D, bool STACKED, typename OutT>
__global__ void __launch_bounds__(kWarps * 32)
flash_decode_q4_kernel(const __nv_bfloat16* __restrict__ q,  // (B, H*D)
                       const int8_t* __restrict__ kv,        // (B, S, H*D) carriers
                       const float* __restrict__ sc,         // (B, S, 2*H) [ks | vs]
                       const int8_t* __restrict__ new_kv,    // (B, H*D) carriers or null
                       const float* __restrict__ new_sc,     // (B, 2*H) or null
                       const int* __restrict__ pos_ptr,      // (B,) or scalar, or null
                       int pos_stride, int pos_scalar,
                       const float* __restrict__ bias,       // (B, S) or null
                       OutT* __restrict__ out,               // (B, H*D)
                       int S, int H, int split, float scale) {
  constexpr int VEC = HeadCfg<D>::VEC;
  constexpr int LPR = HeadCfg<D>::LPR;
  constexpr int HALF = D / 2;        // carriers per head
  constexpr int GPW = 32 / LPR;      // row groups per warp
  constexpr int G = kWarps * GPW;    // row groups per block

  // accumulators in pair order: [even_0 .. even_{D/2-1} | odd_0 .. odd_{D/2-1}]
  __shared__ float sm_acc[G][D];
  __shared__ float sm_m[G];
  __shared__ float sm_l[G];

  const int b = blockIdx.x / H;
  const int h = blockIdx.x % H;
  const int hd = H * D;
  const int w = H * HALF;  // carriers of one of k|v
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int li = lane % LPR;
  const int sub = lane / LPR;
  const int group = warp * GPW + sub;
  const int j0 = li * VEC;
  const bool active = j0 < HALF;  // D = 100 leaves the last lanes of a group idle

  const int pos = pos_ptr ? pos_ptr[(size_t)b * pos_stride] : pos_scalar;
  // slab rows [0, n_live); a stacked call adds the in-flight row as row n_live
  const int n_live = STACKED ? max(0, min(pos, S)) : min(pos + 1, S);
  const int n_rows = n_live + (STACKED ? 1 : 0);

  float qe[VEC], qo[VEC], acc_e[VEC], acc_o[VEC];
  const __nv_bfloat16* qh = q + (size_t)b * hd + (size_t)h * D;
#pragma unroll
  for (int i = 0; i < VEC; ++i) {
    acc_e[i] = 0.f;
    acc_o[i] = 0.f;
    qe[i] = active ? __bfloat162float(qh[pair_dim(j0 + i, 0, D, split)]) : 0.f;
    qo[i] = active ? __bfloat162float(qh[pair_dim(j0 + i, 1, D, split)]) : 0.f;
  }
  float m = -INFINITY;
  float l = 0.f;

  const size_t row_stride = 2 * (size_t)w;
  const int8_t* kbase = kv + (size_t)b * S * row_stride + (size_t)h * HALF + j0;
  const float* sbase = sc + (size_t)b * S * 2 * H + h;
  const int8_t* nbase =
      STACKED ? new_kv + (size_t)b * row_stride + (size_t)h * HALF + j0 : nullptr;
  const float* nsrow = STACKED ? new_sc + (size_t)b * 2 * H + h : nullptr;
  const float* brow = bias ? bias + (size_t)b * S : nullptr;

#pragma unroll 2
  for (int base = warp * GPW; base < n_rows; base += G) {
    const int r = base + sub;
    const bool valid = r < n_rows;
    const bool inflight = STACKED && r == n_live;
    float klo[VEC], khi[VEC], vlo[VEC], vhi[VEC];
    if (valid && active) {
      const int8_t* rp = inflight ? nbase : kbase + (size_t)r * row_stride;
      load_q4<VEC>(rp, klo, khi);
      load_q4<VEC>(rp + w, vlo, vhi);
    } else {
#pragma unroll
      for (int i = 0; i < VEC; ++i) { klo[i] = khi[i] = vlo[i] = vhi[i] = 0.f; }
    }
    float se = 0.f, so = 0.f;
#pragma unroll
    for (int i = 0; i < VEC; ++i) {
      se = fmaf(qe[i], klo[i], se);
      so = fmaf(qo[i], khi[i], so);
    }
    float s = se + so;
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
      for (int i = 0; i < VEC; ++i) {
        acc_e[i] = fmaf(pv, vlo[i], acc_e[i] * alpha);
        acc_o[i] = fmaf(pv, vhi[i], acc_o[i] * alpha);
      }
      m = m_new;
    }
  }

  if (active) {
#pragma unroll
    for (int i = 0; i < VEC; ++i) {
      sm_acc[group][j0 + i] = acc_e[i];
      sm_acc[group][HALF + j0 + i] = acc_o[i];
    }
  }
  if (li == 0) {
    sm_m[group] = m;
    sm_l[group] = l;
  }
  __syncthreads();

  for (int e = threadIdx.x; e < D; e += blockDim.x) {
    float mx = -INFINITY;
#pragma unroll
    for (int g = 0; g < G; ++g) mx = fmaxf(mx, sm_m[g]);
    float den = 0.f, num = 0.f;
#pragma unroll
    for (int g = 0; g < G; ++g) {
      // a group that saw no row has m = -inf, l = 0, acc = 0
      const float wg = sm_m[g] == -INFINITY ? 0.f : expf(sm_m[g] - mx);
      den = fmaf(wg, sm_l[g], den);
      num = fmaf(wg, sm_acc[g][e], num);
    }
    const int dim = pair_dim(e % HALF, e / HALF, D, split);
    store_out(out + (size_t)b * hd + (size_t)h * D + dim, num / den);
  }
}

template <int D, bool STACKED>
void launch(const void* q, const void* kv, const void* sc, const void* new_kv,
            const void* new_sc, const void* pos_ptr, int pos_stride, int pos_scalar,
            const void* bias, void* out, int out_f32, int B, int S, int H, int split,
            cudaStream_t stream) {
  const dim3 grid(B * H);
  const dim3 block(kWarps * 32);
  const float scale = 1.0f / sqrtf(static_cast<float>(2 * (D / 2)));
  const auto* qp = static_cast<const __nv_bfloat16*>(q);
  const auto* kvp = static_cast<const int8_t*>(kv);
  const auto* sp = static_cast<const float*>(sc);
  const auto* nkp = static_cast<const int8_t*>(new_kv);
  const auto* nsp = static_cast<const float*>(new_sc);
  const auto* pp = static_cast<const int*>(pos_ptr);
  const auto* bp = static_cast<const float*>(bias);
  if (out_f32) {
    flash_decode_q4_kernel<D, STACKED, float><<<grid, block, 0, stream>>>(
        qp, kvp, sp, nkp, nsp, pp, pos_stride, pos_scalar, bp, static_cast<float*>(out), S, H,
        split, scale);
  } else {
    flash_decode_q4_kernel<D, STACKED, __nv_bfloat16><<<grid, block, 0, stream>>>(
        qp, kvp, sp, nkp, nsp, pp, pos_stride, pos_scalar, bp,
        static_cast<__nv_bfloat16*>(out), S, H, split, scale);
  }
}

template <bool STACKED>
int dispatch(const void* q, const void* kv, const void* sc, const void* new_kv,
             const void* new_sc, const void* pos_ptr, int pos_stride, int pos_scalar,
             const void* bias, void* out, int out_f32, int B, int S, int H, int D, int split,
             cudaStream_t st) {
  switch (D) {
    case 64:
      launch<64, STACKED>(q, kv, sc, new_kv, new_sc, pos_ptr, pos_stride, pos_scalar, bias,
                          out, out_f32, B, S, H, split, st);
      break;
    case 100:
      launch<100, STACKED>(q, kv, sc, new_kv, new_sc, pos_ptr, pos_stride, pos_scalar, bias,
                           out, out_f32, B, S, H, split, st);
      break;
    case 128:
      launch<128, STACKED>(q, kv, sc, new_kv, new_sc, pos_ptr, pos_stride, pos_scalar, bias,
                           out, out_f32, B, S, H, split, st);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// q (B, H*D) bf16; kv (B, S, H*D) int8 carriers ([k | v], H*D/2 each);
// sc (B, S, 2*H) f32; pos: pos_ptr[b * pos_stride] int32 when pos_ptr is not
// null, else pos_scalar; bias (B, S) f32 or null; out (B, H*D) f32 when
// out_f32, else bf16; split selects the split-rope pair layout.
// Returns a cudaError_t.
extern "C" int flash_decode_q4(const void* q, const void* kv, const void* sc,
                               const void* pos_ptr, int pos_stride, int pos_scalar,
                               const void* bias, void* out, int out_f32, int B, int S, int H,
                               int D, int split, void* stream) {
  return dispatch<false>(q, kv, sc, nullptr, nullptr, pos_ptr, pos_stride, pos_scalar, bias,
                         out, out_f32, B, S, H, D, split, static_cast<cudaStream_t>(stream));
}

// q (B, H*D) bf16; new_kv (B, H*D) int8 carriers and new_sc (B, 2*H) f32, the
// rows at position pos[b]; kv_stack (L, B, S, H*D) carriers and sc_stack
// (L, B, S, 2*H) f32, of which layer `layer` is read (rows [0, pos[b])); pos,
// bias, out, out_f32 and split as for flash_decode_q4. Returns a cudaError_t.
extern "C" int flash_stacked_q4(const void* q, const void* new_kv, const void* new_sc,
                                const void* kv_stack, const void* sc_stack, int layer,
                                const void* pos_ptr, int pos_stride, int pos_scalar,
                                const void* bias, void* out, int out_f32, int B, int S, int H,
                                int D, int split, void* stream) {
  const size_t rows = (size_t)layer * B * S;
  const auto* kv = static_cast<const int8_t*>(kv_stack) + rows * H * D;
  const auto* sc = static_cast<const float*>(sc_stack) + rows * 2 * H;
  return dispatch<true>(q, kv, sc, new_kv, new_sc, pos_ptr, pos_stride, pos_scalar, bias,
                        out, out_f32, B, S, H, D, split, static_cast<cudaStream_t>(stream));
}
