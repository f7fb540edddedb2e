// Single-query decode attention over an interleaved [k|v] bf16 cache slab.
//
// Replaces the Pallas kernel `_kernel` of controlar_tpu/ops/flash_decode2.py
// (flash_decode_attention2). For each batch row b and head h it computes
//   out[b, h] = softmax_r( q[b,h] . k[b,r,h] / sqrt(D) + bias[b,r] ) . v[b,r,h]
// over the cache rows r <= pos[b], with the softmax taken in fp32. q is read
// as bf16 (the JAX kernel casts q to bf16 as well); p and alpha stay in fp32
// here, where the TPU kernel rounds them to bf16.
//
// Bound: bytes. A call reads every live row's head span once, 2*D bf16
// values, plus q and the bias row, and writes out; ~1 fp32 flop a byte, far
// below the card's ridge point. At the GPT-B c2i last step (16 batch rows,
// 12 heads, D = 64, 576 live rows) that is 28.4 MB: 8.5 us at 3.35 TB/s.
//
// The first design (one block of 8 warps per (b, head), each row group
// walking ~18 rows in a chain of online-softmax updates with two synchronous
// 16-byte loads a lane a row, merged through shared memory behind a block
// barrier) took 26.7 us there, 32% of the bound and slower than SDPA: 192
// blocks on 132 SMs, few bytes in flight. This design is the int8 kernel's
// (csrc/flash_decode_q8.cu) for twice the bytes a row:
//   - splits each batch row's live rows into chunks of CHUNK rows, a
//     constant of D (64 at D = 64, 32 at D = 100, 128 at D = 128), so a
//     row's partition depends on its own pos only and its output is the same
//     bit for bit alone or in any batch. A work item is one warp on (b, head,
//     chunk); a block holds 4 of them (the 4 heads of a (b, chunk), side by
//     side in memory). For a scalar pos the grid is the live chunks; for a
//     device pos vector it covers the cache and the warps past a row's live
//     chunks exit first;
//   - keeps bytes in flight: a warp copies its chunk in stages of 8 rows
//     (one cp.async commit group each: the head's D key and D value bf16 a
//     row, 256 B at D = 64, 400 B at D = 100, 512 B at D = 128; 16-byte
//     copies at D = 64 and 128, 8-byte ones at D = 100, whose head spans
//     h * 200 B are 8-byte aligned; each with an L2 prefetch of its 128-byte
//     line), AHEAD stages ahead of the one it computes (3 at D = 64, 1 for
//     the wider heads, whose stages are 1.6-2x larger), into a ring of
//     AHEAD + 1 stages (a whole chunk would take 32-128 KB a warp); q and the
//     bias are loaded before the first copies, which loads issued behind
//     them would wait for;
//   - scores from shared memory, 4 lanes a row, q in registers; bf16 becomes
//     fp32 by a 16-bit shift (or a mask for the high half); the softmax runs
//     online per stage in log2 units (exp2) inside the warp, shuffles only,
//     no block barrier anywhere; the running max moves only when a score
//     passes it by 2^8 (one warp vote a stage; the max and the rescale take
//     6 shuffles and an exp2 only then), and each lane sums its own row's p,
//     reduced once after the chunk: the chain of dependent steps a stage is
//     what bounds a warp at small positions; the value lanes (8 values each
//     at D = 64 and 128, 4 at D = 100) take each row's p by shuffle;
//   - merges in the same launch: each warp writes its partial (acc[D], m, l)
//     to an fp32 workspace and arrives at a per-(b, head) counter
//     (csrc/arrive.cuh); the last arrival stages the partials into its
//     shared memory (one round of L2 copies), weights them by
//     exp2(m_c - max m) (a chunk masked by the caption bias weighs ~0, one
//     that saw no row 0), sums them in chunk order, writes out and resets the
//     counter. A row with one live chunk writes out directly (the merge of
//     one partial gives the same bits). The workspace and counters are the
//     caller's per-stream scratch (ops/_scratch.py): no allocation in a call
//     besides out.
// Shared memory: a stage is 8 rows of k and v at a row pitch of 2 D + 16
// bytes (224 at D = 100), padded so the score lanes' reads of 2 rows
// (16-byte reads) or 4 rows (8-byte reads) hit distinct banks: 9216 B a warp
// at D = 64, 7168 at 100, 8704 at 128 (28-36 KB a block, under the 48 KB
// default; 72-96 registers a thread, no spills). Grids (132 SMs, 24 warps a
// SM at D = 64): at the c2i last step (B 16, H 12, pos 575) 16 x 9 x 12 =
// 1728 warps in 432 blocks, ~13 warps a SM, all resident at once; at t2i
// (H 20, S 1280, pos 1142) 16 x 18 x 20 = 5760 warps, ~44 a SM in ~1.8
// rounds; at pos 255 of c2i 768 warps, ~6 a SM; GPT-3B (H 32, D 100, pos
// 575) 9216 warps.
//
// The entry `flash_stacked` runs the same kernel over layer `layer` of a
// stacked (L, B, S, 2*H*D) cache; it replaces `_kernel_bf16s` of
// controlar_tpu/ops/flash_decode_stacked.py (flash_stacked). The layer is an
// offset on the slab pointer. Rows r < pos[b] come from the slab and row
// pos[b], the in-flight row of this step, from the operand new_kv (B, 2*H*D),
// staged into its chunk like a slab row, without the bias (the caller's bias
// is 0 at decode positions). The TPU kernel's block-diagonal products, row
// selects and chained cross-slot DMA are artefacts of its layout and have no
// counterpart here.
//
// Plain C interface, loaded with ctypes. The launch goes on the caller's
// stream; the function returns cudaGetLastError() after the launch.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "arrive.cuh"

namespace {

constexpr int kWarps = 4;                        // work items (warps) a block
constexpr int kStageRows = 8;                    // rows a cp.async commit group
constexpr int kLanesPerRow = 32 / kStageRows;    // lanes that score one row
constexpr unsigned kAll = 0xffffffffu;
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kSlack = 8.f;  // log2 units a score may pass the running max by

template <int D>
struct Cfg {
  // cache rows a work item, and stages in flight ahead of the computed one
  // (a ring of AHEAD + 1 stages): 64 rows 3 ahead at D = 64; 32 rows 1 ahead
  // at D = 100; 128 rows 1 ahead at D = 128
  static constexpr int CHUNK = D == 64 ? 64 : (D == 100 ? 32 : 128);
  static constexpr int AHEAD = D == 64 ? 3 : 1;
  static constexpr int RING = AHEAD + 1;
  static constexpr int UNIT = D % 8 == 0 ? 16 : 8;  // copy bytes
  static constexpr int UE = UNIT / 2;               // bf16 values a unit
  static constexpr int U = D / UE;                  // units of a head row: 8, 25, 16
  static constexpr int WPL = (U + kLanesPerRow - 1) / kLanesPerRow;  // of them a score lane
  // shared-memory row pitch in bytes: the score lanes of 2 (16-byte reads)
  // or 4 rows (8-byte reads) fall in distinct banks
  static constexpr int PITCH = D == 100 ? 224 : 2 * D + 16;
  static constexpr int STAGE_BYTES = kStageRows * 2 * PITCH;  // k rows, then v rows
  static constexpr int WARP_BYTES = RING * STAGE_BYTES;
  static constexpr int VPL = UE;                                 // values a value lane
  static constexpr int VG = D / VPL;                             // value lanes a row
  static constexpr int RH = 32 / VG >= 4 ? 4 : (32 / VG >= 2 ? 2 : 1);  // rows side by side
  // partials of D + 4 floats the merge stages at once
  static constexpr int MERGE_BATCH = WARP_BYTES / (4 * (D + 4)) < 32 ? WARP_BYTES / (4 * (D + 4)) : 32;
  static_assert(kStageRows % RH == 0, "a stage's rows split evenly over the row groups");
};

// the unit of a head row that score lane j reads in its w-th load: at
// 16-byte units lane j takes units 2j, 2j + 1, then 2j + 8, 2j + 9 (4 lanes
// of a row read 32-byte strides: with the pitch, two rows in distinct
// banks); at 8-byte units j, j + 4, j + 8, ... (a row's 4 lanes read 32
// contiguous bytes: four rows in distinct banks)
template <int D>
__device__ __forceinline__ int score_unit(int j, int w) {
  if constexpr (Cfg<D>::UNIT == 16) {
    return 2 * j + (w & 1) + 8 * (w >> 1);
  } else {
    return j + kLanesPerRow * w;
  }
}

template <int BYTES>
struct Raw;
template <>
struct Raw<16> { using T = uint4; };
template <>
struct Raw<8> { using T = uint2; };

// bf16 pairs -> fp32: the low value's bits shifted up 16, the high value's
// bits masked
template <int N>
__device__ __forceinline__ void bf16_unpack(const uint32_t* w, float* f) {
#pragma unroll
  for (int i = 0; i < N; ++i) {
    f[2 * i] = __uint_as_float(w[i] << 16);
    f[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
  }
}

template <int BYTES>
__device__ __forceinline__ void cp_async(void* dst, const void* src) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  if constexpr (BYTES == 16) {
    asm volatile("cp.async.cg.shared.global.L2::128B [%0], [%1], 16;\n" ::"r"(d), "l"(src)
                 : "memory");
  } else {
    asm volatile("cp.async.ca.shared.global.L2::128B [%0], [%1], %2;\n" ::"r"(d), "l"(src),
                 "n"(BYTES)
                 : "memory");
  }
}

__device__ __forceinline__ void cp_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }

template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void store_out(float* p, float x) { *p = x; }
__device__ __forceinline__ void store_out(__nv_bfloat16* p, float x) { *p = __float2bfloat16(x); }

// STACKED: rows [0, pos) from kv, then the in-flight row from new_kv. ws
// holds B * H * n_chunks partials of D + 4 floats; counters one int per
// (b, head), zero.
template <int D, bool STACKED, typename OutT>
__global__ void __launch_bounds__(kWarps * 32)
flash_decode_kernel(const __nv_bfloat16* __restrict__ q,       // (B, H*D)
                    const __nv_bfloat16* __restrict__ kv,      // (B, S, 2*H*D)
                    const __nv_bfloat16* __restrict__ new_kv,  // (B, 2*H*D) or null
                    const int* __restrict__ pos_ptr,           // (B,) or scalar, or null
                    int pos_stride, int pos_scalar,
                    const float* __restrict__ bias,            // (B, S) or null
                    OutT* __restrict__ out,                    // (B, H*D)
                    float* ws, int* counters, int B, int n_chunks, int S, int H, float scale) {
  using C = Cfg<D>;
  using RawT = typename Raw<C::UNIT>::T;
  constexpr int RW = C::UNIT / 4;  // 32-bit words a unit
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const long item = (long)blockIdx.x * kWarps + warp;  // (b, chunk, head), head fastest
  if (item >= (long)B * n_chunks * H) return;
  const int h = item % H;
  const int c = (item / H) % n_chunks;
  const int b = item / ((long)H * n_chunks);
  const int hd = H * D;
  const size_t rs = 2 * (size_t)hd;  // bf16 values a cache row
  const int pos = pos_ptr ? pos_ptr[(size_t)b * pos_stride] : pos_scalar;
  // slab rows [0, n_live); a stacked call adds the in-flight row as row n_live
  const int n_live = STACKED ? max(0, min(pos, S)) : max(0, min(pos + 1, S));
  const int n_rows = n_live + (STACKED ? 1 : 0);
  const int live_chunks = max(1, (n_rows + C::CHUNK - 1) / C::CHUNK);
  if (c >= live_chunks) return;
  const int r0 = c * C::CHUNK;
  const int rows = max(0, min(C::CHUNK, n_rows - r0));
  const int inflight = STACKED ? n_live - r0 : -1;  // its chunk row, if in [0, rows)

  extern __shared__ __align__(16) unsigned char smem[];
  unsigned char* ring = smem + warp * C::WARP_BYTES;  // C::RING stages of (k rows, v rows)

  // q and the bias are loaded before the chunk's copies are issued and
  // converted after. lane -> (stage row rr, units score_unit(j, w)) in the score
  const int rr = lane / kLanesPerRow;
  const int j = lane % kLanesPerRow;
  const __nv_bfloat16* qh = q + (size_t)b * hd + h * D;
  RawT qraw[C::WPL];
#pragma unroll
  for (int w = 0; w < C::WPL; ++w) {
    const int u = score_unit<D>(j, w);
    qraw[w] = u < C::U ? *reinterpret_cast<const RawT*>(qh + u * C::UE) : RawT{};  // bf16 zeros
  }
  // chunk row r's bias (none on the in-flight row) is lane r % 32's bias_r[r / 32]
  float bias_r[C::CHUNK / 32];
#pragma unroll
  for (int i = 0; i < C::CHUNK / 32; ++i) {
    const int r = 32 * i + lane;
    bias_r[i] = bias && r < rows && r != inflight ? bias[(size_t)b * S + r0 + r] : 0.f;
  }
  // stage st is chunk rows [8 st, 8 st + 8), one commit group (empty past
  // the chunk's end), in ring slot st % C::RING
  const __nv_bfloat16* kv_b = kv + (size_t)b * S * rs + h * D;
  auto issue = [&](int st) {
    unsigned char* slot = ring + (st % C::RING) * C::STAGE_BYTES;
    for (int i = lane; i < kStageRows * 2 * C::U; i += 32) {
      const int sr = i / (2 * C::U);  // stage row
      const int half = (i / C::U) % 2;  // 0: k, 1: v
      const int u = i % C::U;
      const int r = st * kStageRows + sr;
      if (r < rows) {
        const __nv_bfloat16* src = STACKED && r == inflight ? new_kv + (size_t)b * rs + h * D
                                                            : kv_b + (size_t)(r0 + r) * rs;
        cp_async<C::UNIT>(slot + (half * kStageRows + sr) * C::PITCH + u * C::UNIT,
                          src + half * hd + u * C::UE);
      }
    }
    cp_commit();
  };
#pragma unroll
  for (int st = 0; st < C::AHEAD; ++st) issue(st);

  float qf[2 * RW * C::WPL];
#pragma unroll
  for (int w = 0; w < C::WPL; ++w) {
    bf16_unpack<RW>(reinterpret_cast<const uint32_t*>(&qraw[w]), qf + 2 * RW * w);
  }
#pragma unroll
  for (int i = 0; i < C::CHUNK / 32; ++i) bias_r[i] *= kLog2e;  // log2 units
  // lane -> (value group vg: values [vg VPL, vg VPL + VPL) of the head, row
  // offset vrh) in the value pass
  const int vg = lane % C::VG;
  const int vrh = lane / C::VG;
  const bool v_on = vrh < C::RH;

  float m = -INFINITY, l = 0.f;
  float acc[C::VPL];
#pragma unroll
  for (int k = 0; k < C::VPL; ++k) acc[k] = 0.f;
#pragma unroll
  for (int st = 0; st < C::CHUNK / kStageRows; ++st) {
    if (st * kStageRows >= rows) break;  // uniform across the warp
    cp_wait<C::AHEAD - 1>();  // stage st has landed
    __syncwarp();           // and every lane is done with the slot issue() refills
    issue(st + C::AHEAD);
    const unsigned char* sk = ring + (st % C::RING) * C::STAGE_BYTES;
    const unsigned char* sv = sk + kStageRows * C::PITCH;
    const int r = st * kStageRows + rr;
    const bool valid = r < rows;
    // score row r: the lane's units of the head's key row against q (a row
    // past the chunk's end holds stale bytes: its score is replaced below)
    float s0 = 0.f, s1 = 0.f;
#pragma unroll
    for (int w = 0; w < C::WPL; ++w) {
      const int u = score_unit<D>(j, w);
      if (u < C::U) {
        const RawT raw = *reinterpret_cast<const RawT*>(sk + rr * C::PITCH + u * C::UNIT);
        float f[2 * RW];
        bf16_unpack<RW>(reinterpret_cast<const uint32_t*>(&raw), f);
        float& s = w % 2 ? s1 : s0;
#pragma unroll
        for (int e = 0; e < 2 * RW; ++e) s = fmaf(qf[2 * RW * w + e], f[e], s);
      }
    }
    float s = s0 + s1;
    s += __shfl_xor_sync(kAll, s, 1);
    s += __shfl_xor_sync(kAll, s, 2);
    const float bias_rr = __shfl_sync(kAll, bias_r[st * kStageRows / 32], r % 32);
    s = valid ? s * scale + bias_rr : -INFINITY;  // log2 units
    // the stage's online-softmax step: the running max m moves (and acc and
    // the lane's row sum l are rescaled) only when a score passes it by
    // kSlack, so p <= 2^kSlack; one vote tells the warp
    float alpha = 1.f;
    if (__any_sync(kAll, s > m + kSlack)) {  // always on the first stage (m = -inf)
      float mx = s;
#pragma unroll
      for (int off = kLanesPerRow; off < 32; off <<= 1) mx = fmaxf(mx, __shfl_xor_sync(kAll, mx, off));
      const float m_new = fmaxf(m, mx);
      alpha = exp2f(m - m_new);  // exp2(-inf) = 0 on the first stage
      m = m_new;
      l *= alpha;
    }
    const float p = valid ? exp2f(s - m) : 0.f;
    l += p;  // this lane's row; the rows are summed after the chunk
    // acc = acc * alpha + sum_r p_r * v_r over the stage's live rows
#pragma unroll
    for (int k = 0; k < C::VPL; ++k) acc[k] *= alpha;
#pragma unroll
    for (int i = 0; i < kStageRows / C::RH; ++i) {
      const int vr = vrh + C::RH * i;  // stage row
      const float pr = __shfl_sync(kAll, p, (vr % kStageRows) * kLanesPerRow);
      if (v_on && st * kStageRows + vr < rows) {
        const RawT raw = *reinterpret_cast<const RawT*>(sv + vr * C::PITCH + vg * C::UNIT);
        float v[C::VPL];
        bf16_unpack<RW>(reinterpret_cast<const uint32_t*>(&raw), v);
#pragma unroll
        for (int k = 0; k < C::VPL; ++k) acc[k] = fmaf(pr, v[k], acc[k]);
      }
    }
  }
#pragma unroll
  for (int off = C::VG; off < C::VG * C::RH; off <<= 1) {
#pragma unroll
    for (int k = 0; k < C::VPL; ++k) acc[k] += __shfl_xor_sync(kAll, acc[k], off);
  }
#pragma unroll
  for (int off = kLanesPerRow; off < 32; off <<= 1) l += __shfl_xor_sync(kAll, l, off);
  cp_wait<0>();  // the empty groups past the chunk's end

  OutT* o = out + (size_t)b * hd + h * D + vg * C::VPL;
  if (live_chunks == 1) {  // the merge of this one partial: acc / l
    if (vrh == 0) {
#pragma unroll
      for (int k = 0; k < C::VPL; ++k) store_out(o + k, l > 0.f ? acc[k] / l : 0.f);
    }
    return;
  }
  constexpr int PH = D + 4;  // floats of a partial: acc (D), m, l, padding
  float* pb = ws + ((size_t)b * H + h) * n_chunks * PH;  // the (b, head) partials
  if (vrh == 0) {
#pragma unroll
    for (int k = 0; k < C::VPL; k += 4) {
      __stcg(reinterpret_cast<float4*>(pb + (size_t)c * PH + vg * C::VPL + k),
             make_float4(acc[k], acc[k + 1], acc[k + 2], acc[k + 3]));
    }
  }
  if (lane == 0) {
    __stcg(pb + (size_t)c * PH + D, m);  // -inf with l = 0 when the chunk saw no row
    __stcg(pb + (size_t)c * PH + D + 1, l);
  }
  if (!split::arrive_warp(counters + (size_t)b * H + h, live_chunks)) return;

  // the last arrival merges the (b, head) partials in chunk order, staged
  // through the warp's shared memory MERGE_BATCH at a time (one round of
  // copies), with an online rescale between batches
  float* sm = reinterpret_cast<float*>(ring);
  float mx = -INFINITY, den = 0.f;
  float n[C::VPL];
#pragma unroll
  for (int k = 0; k < C::VPL; ++k) n[k] = 0.f;
  for (int base = 0; base < live_chunks; base += C::MERGE_BATCH) {
    const int cnt = min(C::MERGE_BATCH, live_chunks - base);
    __syncwarp();  // the previous batch is read
    for (int i = lane; i < cnt * PH / 4; i += 32) {
      cp_async<16>(sm + 4 * i, pb + (size_t)base * PH + 4 * i);
    }
    cp_commit();
    cp_wait<0>();
    __syncwarp();
    // lane i takes chunk base + i's weight; the sums run in chunk order
    const float mc = lane < cnt ? sm[lane * PH + D] : -INFINITY;
    float mb = mc;
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) mb = fmaxf(mb, __shfl_xor_sync(kAll, mb, off));
    const float m_new = fmaxf(mx, mb);
    const float rescale = mx == -INFINITY ? 0.f : exp2f(mx - m_new);
    const float w = mc == -INFINITY ? 0.f : exp2f(mc - m_new);  // 0: a chunk that saw no row
    const float wl = lane < cnt ? w * sm[lane * PH + D + 1] : 0.f;
    den *= rescale;
#pragma unroll
    for (int k = 0; k < C::VPL; ++k) n[k] *= rescale;
    for (int i = 0; i < cnt; ++i) {
      const float wi = __shfl_sync(kAll, w, i);
      den += __shfl_sync(kAll, wl, i);
      if (v_on) {
#pragma unroll
        for (int k = 0; k < C::VPL; k += 4) {
          const float4 a = *reinterpret_cast<const float4*>(sm + i * PH + vg * C::VPL + k);
          n[k] = fmaf(wi, a.x, n[k]);
          n[k + 1] = fmaf(wi, a.y, n[k + 1]);
          n[k + 2] = fmaf(wi, a.z, n[k + 2]);
          n[k + 3] = fmaf(wi, a.w, n[k + 3]);
        }
      }
    }
    mx = m_new;
  }
  if (vrh == 0) {
#pragma unroll
    for (int k = 0; k < C::VPL; ++k) store_out(o + k, den > 0.f ? n[k] / den : 0.f);  // 0: no live row
  }
}

template <int D, bool STACKED, typename OutT>
int launch_as(const __nv_bfloat16* q, const __nv_bfloat16* kv, const __nv_bfloat16* new_kv,
              const int* pos_ptr, int pos_stride, int pos_scalar, const float* bias, void* out,
              int B, int S, int H, float* ws, int* counters, int n_chunks, cudaStream_t stream) {
  const int smem = kWarps * Cfg<D>::WARP_BYTES;  // under the 48 KB default at every D
  const long items = (long)B * n_chunks * H;
  const dim3 grid(static_cast<unsigned>((items + kWarps - 1) / kWarps));
  // scores in log2 units, for exp2: 1 / sqrt(D) and the bias times log2(e)
  const float scale = kLog2e / sqrtf(static_cast<float>(D));
  flash_decode_kernel<D, STACKED, OutT><<<grid, kWarps * 32, smem, stream>>>(
      q, kv, new_kv, pos_ptr, pos_stride, pos_scalar, bias, static_cast<OutT*>(out), ws, counters,
      B, n_chunks, S, H, scale);
  return static_cast<int>(cudaGetLastError());
}

template <int D, bool STACKED>
int launch(const void* q, const void* kv, const void* new_kv, const void* pos_ptr,
           int pos_stride, int pos_scalar, const void* bias, void* out, int out_f32, int B,
           int S, int H, void* ws, void* counters, int chunk, int n_chunks,
           cudaStream_t stream) {
  // the grid must hold every live chunk: the whole cache for a device pos
  int need = S + (STACKED ? 1 : 0);
  if (!pos_ptr) {
    need = STACKED ? max(0, min(pos_scalar, S)) + 1 : max(0, min(pos_scalar + 1, S));
  }
  constexpr int CH = Cfg<D>::CHUNK;
  if (chunk != CH || n_chunks < max(1, (need + CH - 1) / CH) || B < 1 || H < 1 ||
      ws == nullptr || counters == nullptr) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  auto* qp = static_cast<const __nv_bfloat16*>(q);
  auto* kvp = static_cast<const __nv_bfloat16*>(kv);
  auto* nkp = static_cast<const __nv_bfloat16*>(new_kv);
  auto* pp = static_cast<const int*>(pos_ptr);
  auto* bp = static_cast<const float*>(bias);
  auto* wsp = static_cast<float*>(ws);
  auto* cp = static_cast<int*>(counters);
  if (out_f32) {
    return launch_as<D, STACKED, float>(qp, kvp, nkp, pp, pos_stride, pos_scalar, bp, out, B,
                                        S, H, wsp, cp, n_chunks, stream);
  }
  return launch_as<D, STACKED, __nv_bfloat16>(qp, kvp, nkp, pp, pos_stride, pos_scalar, bp, out,
                                              B, S, H, wsp, cp, n_chunks, stream);
}

template <bool STACKED>
int dispatch(const void* q, const void* kv, const void* new_kv, const void* pos_ptr,
             int pos_stride, int pos_scalar, const void* bias, void* out, int out_f32, int B,
             int S, int H, int D, void* ws, void* counters, int chunk, int n_chunks,
             cudaStream_t st) {
  switch (D) {
    case 64:
      return launch<64, STACKED>(q, kv, new_kv, pos_ptr, pos_stride, pos_scalar, bias, out,
                                 out_f32, B, S, H, ws, counters, chunk, n_chunks, st);
    case 100:
      return launch<100, STACKED>(q, kv, new_kv, pos_ptr, pos_stride, pos_scalar, bias, out,
                                  out_f32, B, S, H, ws, counters, chunk, n_chunks, st);
    case 128:
      return launch<128, STACKED>(q, kv, new_kv, pos_ptr, pos_stride, pos_scalar, bias, out,
                                  out_f32, B, S, H, ws, counters, chunk, n_chunks, st);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// q (B, H*D) bf16; kv (B, S, 2*H*D) bf16; pos: pos_ptr[b * pos_stride] int32
// when pos_ptr is not null, else pos_scalar; bias (B, S) f32 or null;
// out (B, H*D) f32 when out_f32, else bf16. The launch plan
// (ops/flash_decode.split_plan): chunk rows a work item (the kernel's
// constant), n_chunks work items a (batch row, head) (every live chunk: for a
// device pos, the whole cache), ws at least B * H * n_chunks partials of
// D + 4 floats, counters B * H zeroed ints, left zero. Returns a cudaError_t.
extern "C" int flash_decode_attention(const void* q, const void* kv, const void* pos_ptr,
                                      int pos_stride, int pos_scalar, const void* bias,
                                      void* out, int out_f32, int B, int S, int H, int D,
                                      void* ws, void* counters, int chunk, int n_chunks,
                                      void* stream) {
  return dispatch<false>(q, kv, nullptr, pos_ptr, pos_stride, pos_scalar, bias, out, out_f32,
                         B, S, H, D, ws, counters, chunk, n_chunks,
                         static_cast<cudaStream_t>(stream));
}

// q (B, H*D) bf16; new_kv (B, 2*H*D) bf16, the rows at position pos[b];
// stack (L, B, S, 2*H*D) bf16, of which layer `layer` is read (rows
// [0, pos[b])); pos, bias, out, out_f32 and the plan as for
// flash_decode_attention, over S + 1 rows. Returns a cudaError_t.
extern "C" int flash_stacked(const void* q, const void* new_kv, const void* stack, int layer,
                             const void* pos_ptr, int pos_stride, int pos_scalar,
                             const void* bias, void* out, int out_f32, int B, int S, int H,
                             int D, void* ws, void* counters, int chunk, int n_chunks,
                             void* stream) {
  const auto* slab = static_cast<const __nv_bfloat16*>(stack)
                     + (size_t)layer * B * S * 2 * (size_t)H * D;
  return dispatch<true>(q, slab, new_kv, pos_ptr, pos_stride, pos_scalar, bias, out, out_f32,
                        B, S, H, D, ws, counters, chunk, n_chunks,
                        static_cast<cudaStream_t>(stream));
}
