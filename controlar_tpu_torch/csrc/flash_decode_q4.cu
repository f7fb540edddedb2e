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
// over rows r <= pos[b], the softmax in fp32 with the v scale folded into p
// (p * vs and alpha stay fp32, where the TPU kernel rounds them to bf16),
// the output pairs written back in the layout of q.
//
// Bound: bytes. A call reads every live row once, H*D carrier bytes and 2*H
// f32 scales, plus q and the bias row, and writes out; ~2 fp32 flops a
// value. At the GPT-3B c2i last step (16 batch rows, 32 heads x 100, 576
// live rows) that is 31.85 MB: 9.5 us at 3.35 TB/s; at the w4kv4 spec
// draft's GPT-B step (12 heads x 64, interleaved, 576 rows) 7.96 MB: 2.4 us.
//
// The first design (one block of 8 warps per (b, head), each lane group
// walking its rows in a chain of dependent 2- or 4-byte loads and shuffle
// reductions) was latency-bound: 0.0839 ms at the 3B last step, 11% of the
// bound, and slower than SDPA at the draft. This design is that of the int8
// and bf16 decode kernels (csrc/flash_decode_q8.cu, csrc/flash_decode.cu):
//   - a work item is one warp on (b, head, chunk of CHUNK cache rows), CHUNK
//     64 at every D (chunk::kChunk; probe_q4_chunk.py times others),
//     so a row's partition, and its output bit for bit, depend on its own pos
//     only. A block holds 4 of them (the 4 heads of a (b, chunk), side by
//     side in memory). Grids (132 SMs): at the 3B last step 16 x 9 x 32 =
//     4608 warps in 1152 blocks (5 blocks a SM at ~100 registers a thread:
//     1.75 rounds); at the draft 16 x 9 x 12 = 1728 warps in 432 blocks, all
//     resident at once. For a scalar pos the grid is the live chunks; for a
//     device pos vector it covers the cache and the warps past a row's live
//     chunks exit first;
//   - copies: a stage is 8 rows' k and v carrier spans and their two scales,
//     one cp.async commit group, AHEAD (2) stages ahead of the one computed,
//     in a per-warp ring of 3. A head's span is D/2 bytes at h * D/2 of a
//     half row: at D = 64 and 128 (32 and 64 bytes) 16-byte aligned (the
//     wrapper checks 16-byte aligned slabs), copied in 2 or 4 16-byte
//     pieces; at D = 100 (50 bytes) only 2-byte aligned, copied as the
//     64-byte window that holds it in 4 pieces (the last zero-filled past the
//     span) and read from its offset there (chunk::copy_window, the helper
//     of the verify kernels' template csrc/flash_chunk.cuh). The in-flight
//     row of a stacked call has its own offset. q and the bias are loaded
//     before the first copies;
//   - scores on the tensor cores, as in the verify kernels: one mma.sync
//     m16n8k16 a 16 head dims, q (its even/odd pair halves in q's layout) in
//     all 8 rows of A and the stage's 8 rows as B, so lane (g, t) gets the
//     scores of rows 2t and 2t + 1; nibbles become bf16 exactly ((n ^ 8) |
//     0x4300 less 136). Softmax online per stage in fp32, log2 units; the
//     running max moves only when a score passes it by 2^8 (one warp vote a
//     stage);
//   - P.V in fp32: value lanes of 4 carriers (8 lanes a row at D = 64, 4
//     rows side by side; 16 at D = 128, 2 rows) or 2 carriers (25 lanes a
//     row at D = 100) take each row's p * vs by shuffle; a nibble becomes
//     fp32 by a byte permute into the bit pattern of 2^23 and one
//     subtraction, no integer conversion;
//   - merge in the same launch: each warp writes its partial (acc[D], m, l)
//     to the caller's per-stream fp32 workspace (ops/_scratch.py) and arrives
//     at a per-(b, head) counter (csrc/arrive.cuh); the last arrival copies
//     the partials into its shared memory in one round (9 at a time), weighs
//     them by exp2(m_c - max m) (0 for a chunk that saw no row), sums them
//     in chunk order, writes out and resets the counter. A row with one live
//     chunk writes out directly (a chain of L2 rounds per partial, as the
//     verify kernels merge, was the largest single cost of a 3B call).
// Shared memory: a stage is 8 k and 8 v windows at a row pitch of 48 bytes
// (D = 64) or 80 (D = 100, 128), whose score and value reads fall in
// distinct banks, and 16 scales: 832 or 1344 B; 3 stages a warp, 10.0 or
// 16.1 KB a block.
//
// The entry `flash_stacked_q4` runs the same kernel over layer `layer` of a
// stacked (L, B, S, H*D) carrier cache and its (L, B, S, 2*H) scales; it
// replaces `_kernel_q4s` of controlar_tpu/ops/flash_decode_stacked.py
// (flash_stacked_q4). The layer is an offset on both slab pointers; rows
// r < pos[b] come from the slabs and row pos[b], this step's in-flight row,
// from the operands new_kv (B, H*D) carriers and new_sc (B, 2*H), staged
// into its chunk like a slab row, without the bias (0 at decode positions
// by the caller's contract).
//
// Plain C interface, loaded with ctypes. The launch goes on the caller's
// stream; the function returns cudaGetLastError() after the launch.
#include "flash_chunk.cuh"

namespace {

using chunk::kAll;
using chunk::kLog2e;
using chunk::kSlack;
using chunk::kStageRows;
using F = chunk::Int4Kv;

constexpr int kWarps = 4;  // work items (warps) a block
constexpr int kAhead = 2;  // stages in flight ahead of the computed one

template <int D>
struct Cfg {
  using Win = chunk::Cfg<F, D>;  // the span's window: HB bytes in NP 16-byte pieces
  // cache rows a work item, at every D the verify kernels' length
  // (ops/flash_decode.CHUNK_ROWS["int4"] mirrors it)
  static constexpr int CHUNK = chunk::kChunk;
  static constexpr int HB = Win::HB;          // carriers (bytes) of a head: D / 2
  static constexpr int NP = Win::NP;          // 2, 4, 4
  static constexpr int QUADS = Win::QUADS;    // 2-carrier quads of a head
  static constexpr int KSTEPS = Win::KSTEPS;  // mma steps of 16 dims
  static constexpr int PITCH = Win::PITCH;    // 48 at D = 64, 80 at D = 100 and 128
  static constexpr bool ALIGNED = Win::ALIGN == 16;  // every span at byte 0 of its window
  static constexpr int RING = kAhead + 1;
  // a stage: k windows, v windows, then ks and vs of its 8 rows
  static constexpr int STAGE_BYTES = 2 * kStageRows * PITCH + 2 * kStageRows * 4;
  static constexpr int WARP_BYTES = RING * STAGE_BYTES;
  static constexpr int CPL = ALIGNED ? 4 : 2;  // carriers a value lane: one 4- or 2-byte load
  static constexpr int VG = HB / CPL;          // value lanes a row: 8, 25, 16
  static constexpr int RH = 32 / VG >= 4 ? 4 : (32 / VG >= 2 ? 2 : 1);  // rows side by side
  static constexpr int RPG = kStageRows / RH;  // stage rows a row group takes, 2, 8, 4
  static constexpr int PH = D + 4;             // floats of a partial: acc (D), m, l, padding
  // partials the merge stages at once (9: every live chunk at pos 575)
  static constexpr int MERGE_BATCH = WARP_BYTES / (4 * PH) < 32 ? WARP_BYTES / (4 * PH) : 32;
  static_assert(CHUNK % 32 == 0, "whole 32-row bias words");
  static_assert(HB % CPL == 0 && RPG % 2 == 0, "whole value lanes; row pairs");
  static_assert(kWarps * WARP_BYTES <= 48 * 1024, "under the default shared memory");
};

// CPL carriers (the low CPL bytes of w) -> their (lo, hi) nibbles as fp32:
// (n ^ 8) in the low byte of the bit pattern of 2^23 reads as 2^23 + n + 8
template <int CPL>
__device__ __forceinline__ void nibbles_f32(uint32_t w, float* lo, float* hi) {
  const uint32_t x = w ^ 0x88888888u;
  const uint32_t l = x & 0x0F0F0F0Fu;
  const uint32_t h = (x >> 4) & 0x0F0F0F0Fu;
#pragma unroll
  for (int i = 0; i < CPL; ++i) {
    lo[i] = __uint_as_float(__byte_perm(l, 0x4B000000u, 0x7440 + i)) - 8388616.0f;
    hi[i] = __uint_as_float(__byte_perm(h, 0x4B000000u, 0x7440 + i)) - 8388616.0f;
  }
}

// dim of head-local pair j, half 0 (even) or 1 (odd), in q's layout
__device__ __forceinline__ int pair_dim(int j, int half, int D, int split) {
  return split ? half * (D / 2) + j : 2 * j + half;
}

// STACKED: rows [0, pos) from kv and sc, then the in-flight row from new_kv
// and new_sc. ws holds B * H * n_chunks partials of D + 4 floats; counters
// one int per (b, head), zero.
template <int D, bool STACKED, typename OutT>
__global__ void __launch_bounds__(kWarps * 32)
flash_decode_q4_kernel(const __nv_bfloat16* __restrict__ q,     // (B, H*D)
                       const unsigned char* __restrict__ kv,    // (B, S, H*D) carriers
                       const float* __restrict__ sc,            // (B, S, 2*H) [ks | vs]
                       const unsigned char* __restrict__ new_kv,  // (B, H*D) or null
                       const float* __restrict__ new_sc,        // (B, 2*H) or null
                       const int* __restrict__ pos_ptr,         // (B,) or scalar, or null
                       int pos_stride, int pos_scalar,
                       const float* __restrict__ bias,          // (B, S) or null
                       OutT* __restrict__ out,                  // (B, H*D)
                       float* ws, int* counters, int B, int n_chunks, int S, int H,
                       int split, float scale) {
  using C = Cfg<D>;
  constexpr int PH = C::PH;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const long item = (long)blockIdx.x * kWarps + warp;  // (b, chunk, head), head fastest
  if (item >= (long)B * n_chunks * H) return;
  const int h = item % H;
  const int c = (item / H) % n_chunks;
  const int b = item / ((long)H * n_chunks);
  const int hd = H * D;
  const int g = lane / 4;
  const int t = lane % 4;

  // q as the mma's A rows 0-7 (the same in each), loaded with pos and the
  // bias before the copies
  uint32_t qa[C::KSTEPS][2];
  {
    const __nv_bfloat16* qh = q + (size_t)b * hd + (size_t)h * D;
#pragma unroll
    for (int w = 0; w < C::KSTEPS; ++w) {
      const int qd = 4 * w + t;
      qa[w][0] = qa[w][1] = 0u;
      if (qd < C::QUADS) chunk::q_pairs<F, D>(qh, qd, split, qa[w][0], qa[w][1]);
    }
  }
  const int pos = pos_ptr ? pos_ptr[(size_t)b * pos_stride] : pos_scalar;
  // slab rows [0, n_live); a stacked call adds the in-flight row as row n_live
  const int n_live = STACKED ? max(0, min(pos, S)) : max(0, min(pos + 1, S));
  const int n_rows = n_live + (STACKED ? 1 : 0);
  const int live_chunks = max(1, (n_rows + C::CHUNK - 1) / C::CHUNK);
  if (c >= live_chunks) return;
  const int r0 = c * C::CHUNK;
  const int rows = max(0, min(C::CHUNK, n_rows - r0));
  const int inflight = STACKED ? n_live - r0 : -1;  // its chunk row, if in [0, rows)
  // chunk row r's bias (none on the in-flight row) is lane r % 32's bias_r[r / 32]
  float bias_r[C::CHUNK / 32];
#pragma unroll
  for (int i = 0; i < C::CHUNK / 32; ++i) {
    const int r = 32 * i + lane;
    bias_r[i] = bias && r < rows && r != inflight ? bias[(size_t)b * S + r0 + r] : 0.f;
  }

  extern __shared__ __align__(16) unsigned char smem[];
  unsigned char* ring = smem + warp * C::WARP_BYTES;

  // stage st: chunk rows [8 st, 8 st + 8), one commit group (empty past the
  // chunk's end), in ring slot st % RING. Lanes 2 sp and 2 sp + 1 copy span
  // sp = 8 half + sr (half 0: k, 1: v; sr the stage row) from its window; a
  // slab span's offset o in its window is the same in every stage (8 rows
  // move it by 8 H D bytes, a multiple of 16). Lanes 0-15 copy ks, vs.
  const size_t rb = (size_t)hd;             // bytes of a cache row
  const size_t vspan = (size_t)H * C::HB;   // k span -> v span
  const unsigned char* kv_b = kv + ((size_t)b * S + r0) * rb + (size_t)h * C::HB;
  auto off16 = [](const void* p) { return static_cast<int>(reinterpret_cast<uintptr_t>(p) % 16); };
  const int cp_row = (lane / 2) % kStageRows;
  const int cp_half = lane / (2 * kStageRows);
  const unsigned char* cp_span = kv_b + cp_row * rb + cp_half * vspan;
  const int cp_o = off16(cp_span);
  const unsigned char* cp_src = cp_span - cp_o;  // stage 0's window
  const int cp_dst = (cp_half * kStageRows + cp_row) * C::PITCH;
  const unsigned char* nw_span =
      STACKED ? new_kv + (size_t)b * rb + cp_half * vspan + (size_t)h * C::HB : nullptr;
  const int nw_o = STACKED ? off16(nw_span) : 0;
  const int fs_row = lane % kStageRows;
  const int fs_half = lane / kStageRows;  // 0: ks, 1: vs (lanes 0-15)
  const float* fs_src = sc + ((size_t)b * S + r0 + fs_row) * 2 * H + h + fs_half * H;
  const float* fs_new = STACKED ? new_sc + (size_t)b * 2 * H + h + fs_half * H : nullptr;
  auto issue = [&](int st) {
    unsigned char* slot = ring + (st % C::RING) * C::STAGE_BYTES;
    const int r = st * kStageRows + cp_row;
    if (r < rows) {
      if (STACKED && r == inflight) {
        chunk::copy_window<C::HB, C::NP>(slot + cp_dst, nw_span - nw_o, nw_o, lane & 1);
      } else {
        chunk::copy_window<C::HB, C::NP>(slot + cp_dst, cp_src + (size_t)st * kStageRows * rb,
                                            cp_o, lane & 1);
      }
    }
    const int fr = st * kStageRows + fs_row;
    if (lane < 2 * kStageRows && fr < rows) {
      chunk::cp_async4(slot + 2 * kStageRows * C::PITCH + 4 * lane,
                       STACKED && fr == inflight ? fs_new
                                                 : fs_src + (size_t)st * kStageRows * 2 * H);
    }
    chunk::cp_commit();
  };
#pragma unroll
  for (int st = 0; st < kAhead; ++st) issue(st);

#pragma unroll
  for (int i = 0; i < C::CHUNK / 32; ++i) bias_r[i] *= kLog2e;  // log2 units
  // the offsets of the spans a lane reads (0 unless D = 100): score lane
  // (g, t) reads stage row g's k span, value lanes stage row vr's v span
  const int ok_g = C::ALIGNED ? 0 : off16(kv_b + g * rb);
  const int ov0 = C::ALIGNED ? 0 : off16(kv_b + vspan);
  const int rb16 = static_cast<int>(rb % 16);
  const int nk_o = STACKED && !C::ALIGNED ? off16(new_kv + (size_t)b * rb + (size_t)h * C::HB) : 0;
  const int nv_o = STACKED && !C::ALIGNED
                       ? off16(new_kv + (size_t)b * rb + vspan + (size_t)h * C::HB) : 0;
  // value lanes: carriers [CPL vl, CPL vl + CPL) of the head, stage rows
  // RPG vrh .. RPG vrh + RPG - 1 (lanes past the row groups: any, unstored)
  const int vl = lane % C::VG;
  const int vrh = lane / C::VG;
  const int vrow0 = min(vrh, C::RH - 1) * C::RPG;

  float m = -INFINITY, l = 0.f;  // the running max and this lane's rows' sum
  float acc_lo[C::CPL], acc_hi[C::CPL];
#pragma unroll
  for (int k = 0; k < C::CPL; ++k) acc_lo[k] = acc_hi[k] = 0.f;
  const int n_stages = (rows + kStageRows - 1) / kStageRows;
  for (int st = 0; st < n_stages; ++st) {
    chunk::cp_wait<kAhead - 1>();  // stage st has landed
    __syncwarp();                  // every lane is done with the slot issue() refills
    issue(st + kAhead);
    const unsigned char* slot = ring + (st % C::RING) * C::STAGE_BYTES;
    const float* fs = reinterpret_cast<const float*>(slot + 2 * kStageRows * C::PITCH);
    const int rs = st * kStageRows;
    // scores of stage rows g against q, the even and odd steps in two chains
    float d[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
    {
      const int ko = STACKED && rs + g == inflight ? nk_o : ok_g;
      const unsigned char* krow = slot + g * C::PITCH + ko;
#pragma unroll
      for (int w = 0; w < C::KSTEPS; ++w) {
        const int qd = 4 * w + t;
        uint32_t b0 = 0u, b1 = 0u;
        if (C::QUADS % 4 == 0 || qd < C::QUADS) chunk::quad_bf16<F>(krow, qd, b0, b1);
        chunk::mma(d[w % 2], qa[w][0], 0u, qa[w][1], 0u, b0, b1);
      }
    }
    // lane (g, t): rows 2t, 2t + 1 (a row past the chunk's end holds stale
    // bytes and scales: its score is replaced by -inf, its p * vs by 0)
    float bw = bias_r[0];  // the bias word of this stage's rows
#pragma unroll
    for (int i = 1; i < C::CHUNK / 32; ++i) bw = rs / 32 == i ? bias_r[i] : bw;
    float s[2];
    bool valid[2];
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int r = rs + 2 * t + e;
      valid[e] = r < rows;
      const float be = __shfl_sync(kAll, bw, r % 32);
      s[e] = valid[e] ? (d[0][e] + d[1][e]) * fs[2 * t + e] * scale + be : -INFINITY;
    }
    // the running max moves (acc and l rescaled) only when a score passes
    // it by kSlack, so p <= 2^kSlack; one vote tells the warp
    if (__any_sync(kAll, s[0] > m + kSlack || s[1] > m + kSlack)) {  // always on the first stage
      float mx = fmaxf(s[0], s[1]);
      mx = fmaxf(mx, __shfl_xor_sync(kAll, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(kAll, mx, 2));
      const float m_new = fmaxf(m, mx);  // finite: the stage has a live row
      const float alpha = exp2f(m - m_new);  // exp2(-inf) = 0 on the first stage
      m = m_new;
      l *= alpha;
#pragma unroll
      for (int k = 0; k < C::CPL; ++k) {
        acc_lo[k] *= alpha;
        acc_hi[k] *= alpha;
      }
    }
    float pv[2];
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const float p = valid[e] ? exp2f(s[e] - m) : 0.f;
      l += p;
      pv[e] = valid[e] ? p * fs[kStageRows + 2 * t + e] : 0.f;  // the v scale folded into p
    }
    // acc += p_r vs_r (vlo, vhi)_r over the stage's rows; row vr's p * vs
    // is lane vr / 2's pv[vr % 2] (vr % 2 = i % 2 in every lane: RPG is even)
#pragma unroll
    for (int i = 0; i < C::RPG; ++i) {
      const int vr = vrow0 + i;
      const float pr = __shfl_sync(kAll, pv[i % 2], vr / 2);
      const int vo = C::ALIGNED ? 0
                     : (STACKED && rs + vr == inflight ? nv_o : (ov0 + vr * rb16) & 15);
      const unsigned char* vp = slot + (kStageRows + vr) * C::PITCH + vo + C::CPL * vl;
      uint32_t raw;
      if constexpr (C::CPL == 4) {
        raw = *reinterpret_cast<const uint32_t*>(vp);
      } else {
        raw = *reinterpret_cast<const uint16_t*>(vp);
      }
      float lo[C::CPL], hi[C::CPL];
      nibbles_f32<C::CPL>(raw, lo, hi);
#pragma unroll
      for (int k = 0; k < C::CPL; ++k) {
        acc_lo[k] = fmaf(pr, lo[k], acc_lo[k]);
        acc_hi[k] = fmaf(pr, hi[k], acc_hi[k]);
      }
    }
  }
  chunk::cp_wait<0>();  // the empty groups past the chunk's end
#pragma unroll
  for (int off = C::VG; off < C::VG * C::RH; off <<= 1) {
#pragma unroll
    for (int k = 0; k < C::CPL; ++k) {
      acc_lo[k] += __shfl_xor_sync(kAll, acc_lo[k], off);
      acc_hi[k] += __shfl_xor_sync(kAll, acc_hi[k], off);
    }
  }
  l += __shfl_xor_sync(kAll, l, 1);  // the 8 rows of each stage: lanes t = 0-3
  l += __shfl_xor_sync(kAll, l, 2);
  const bool writer = vrh == 0;  // lanes vl < VG hold the sums
  auto store = [&](const float* lo, const float* hi, float den) {
    OutT* o = out + (size_t)b * hd + (size_t)h * D;
#pragma unroll
    for (int k = 0; k < C::CPL; ++k) {
      const int j = C::CPL * vl + k;
      chunk::store_out(o + pair_dim(j, 0, D, split), den > 0.f ? lo[k] / den : 0.f);  // 0: no row
      chunk::store_out(o + pair_dim(j, 1, D, split), den > 0.f ? hi[k] / den : 0.f);
    }
  };
  if (live_chunks == 1) {  // the merge of this one partial: acc / l
    if (writer) store(acc_lo, acc_hi, l);
    return;
  }
  // a partial: acc as [lo of the head's carriers | hi], then m, l
  float* parts = ws + ((size_t)b * H + h) * n_chunks * PH;  // the (b, head) partials
  {
    float* part = parts + (size_t)c * PH;
    if (writer) {
      if constexpr (C::CPL == 4) {
        __stcg(reinterpret_cast<float4*>(part) + vl,
               make_float4(acc_lo[0], acc_lo[1], acc_lo[2], acc_lo[3]));
        __stcg(reinterpret_cast<float4*>(part + C::HB) + vl,
               make_float4(acc_hi[0], acc_hi[1], acc_hi[2], acc_hi[3]));
      } else {
        __stcg(reinterpret_cast<float2*>(part) + vl, make_float2(acc_lo[0], acc_lo[1]));
        __stcg(reinterpret_cast<float2*>(part + C::HB) + vl, make_float2(acc_hi[0], acc_hi[1]));
      }
    }
    if (lane == 0) {
      __stcg(part + D, m);  // -inf with l = 0 when the chunk saw no row
      __stcg(part + D + 1, l);
    }
  }
  if (!split::arrive_warp(counters + (size_t)b * H + h, live_chunks)) return;

  // the last arrival merges the partials in chunk order, staged through its
  // shared memory MERGE_BATCH at a time (one round of L2 copies), with an
  // online rescale between batches: lane i takes chunk base + i's weight,
  // each weight and l goes to the value lanes by shuffle
  float* sm = reinterpret_cast<float*>(ring);
  float mx = -INFINITY, den = 0.f, num_lo[C::CPL], num_hi[C::CPL];
#pragma unroll
  for (int k = 0; k < C::CPL; ++k) num_lo[k] = num_hi[k] = 0.f;
  for (int base = 0; base < live_chunks; base += C::MERGE_BATCH) {
    const int cnt = min(C::MERGE_BATCH, live_chunks - base);
    __syncwarp();  // the previous batch is read
    for (int i = lane; i < cnt * PH / 4; i += 32) {
      chunk::cp_async16(sm + 4 * i, parts + (size_t)base * PH + 4 * i, 16);
    }
    chunk::cp_commit();
    chunk::cp_wait<0>();
    __syncwarp();
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
    for (int k = 0; k < C::CPL; ++k) {
      num_lo[k] *= rescale;
      num_hi[k] *= rescale;
    }
    for (int i = 0; i < cnt; ++i) {
      const float wi = __shfl_sync(kAll, w, i);
      den += __shfl_sync(kAll, wl, i);
      const float* part = sm + i * PH;
      float a[C::CPL], z[C::CPL];
      if constexpr (C::CPL == 4) {
        const float4 x = reinterpret_cast<const float4*>(part)[vl];
        const float4 y = reinterpret_cast<const float4*>(part + C::HB)[vl];
        a[0] = x.x; a[1] = x.y; a[2] = x.z; a[3] = x.w;
        z[0] = y.x; z[1] = y.y; z[2] = y.z; z[3] = y.w;
      } else {
        const float2 x = reinterpret_cast<const float2*>(part)[vl];
        const float2 y = reinterpret_cast<const float2*>(part + C::HB)[vl];
        a[0] = x.x; a[1] = x.y;
        z[0] = y.x; z[1] = y.y;
      }
#pragma unroll
      for (int k = 0; k < C::CPL; ++k) {
        num_lo[k] = fmaf(wi, a[k], num_lo[k]);
        num_hi[k] = fmaf(wi, z[k], num_hi[k]);
      }
    }
    mx = m_new;
  }
  if (writer) store(num_lo, num_hi, den);
}

template <int D, bool STACKED, typename OutT>
int launch_as(const void* q, const void* kv, const void* sc, const void* new_kv,
              const void* new_sc, const void* pos_ptr, int pos_stride, int pos_scalar,
              const void* bias, void* out, int B, int S, int H, int split, void* ws,
              void* counters, int n_chunks, cudaStream_t stream) {
  const long items = (long)B * n_chunks * H;
  const dim3 grid(static_cast<unsigned>((items + kWarps - 1) / kWarps));
  const int smem = kWarps * Cfg<D>::WARP_BYTES;  // under the 48 KB default at every D
  // scores in log2 units, for exp2: 1 / sqrt(2 * (D/2)) and the bias times log2(e)
  const float scale = kLog2e / sqrtf(static_cast<float>(2 * (D / 2)));
  flash_decode_q4_kernel<D, STACKED, OutT><<<grid, kWarps * 32, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const unsigned char*>(kv),
      static_cast<const float*>(sc), static_cast<const unsigned char*>(new_kv),
      static_cast<const float*>(new_sc), static_cast<const int*>(pos_ptr), pos_stride,
      pos_scalar, static_cast<const float*>(bias), static_cast<OutT*>(out),
      static_cast<float*>(ws), static_cast<int*>(counters), B, n_chunks, S, H, split, scale);
  return static_cast<int>(cudaGetLastError());
}

template <int D, bool STACKED>
int launch(const void* q, const void* kv, const void* sc, const void* new_kv,
           const void* new_sc, const void* pos_ptr, int pos_stride, int pos_scalar,
           const void* bias, void* out, int out_f32, int B, int S, int H, int split, void* ws,
           void* counters, int chunk, int n_chunks, cudaStream_t stream) {
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
  if (out_f32) {
    return launch_as<D, STACKED, float>(q, kv, sc, new_kv, new_sc, pos_ptr, pos_stride,
                                        pos_scalar, bias, out, B, S, H, split, ws, counters,
                                        n_chunks, stream);
  }
  return launch_as<D, STACKED, __nv_bfloat16>(q, kv, sc, new_kv, new_sc, pos_ptr, pos_stride,
                                              pos_scalar, bias, out, B, S, H, split, ws,
                                              counters, n_chunks, stream);
}

template <bool STACKED>
int dispatch(const void* q, const void* kv, const void* sc, const void* new_kv,
             const void* new_sc, const void* pos_ptr, int pos_stride, int pos_scalar,
             const void* bias, void* out, int out_f32, int B, int S, int H, int D, int split,
             void* ws, void* counters, int chunk, int n_chunks, cudaStream_t st) {
  switch (D) {
    case 64:
      return launch<64, STACKED>(q, kv, sc, new_kv, new_sc, pos_ptr, pos_stride, pos_scalar,
                                 bias, out, out_f32, B, S, H, split, ws, counters, chunk,
                                 n_chunks, st);
    case 100:
      return launch<100, STACKED>(q, kv, sc, new_kv, new_sc, pos_ptr, pos_stride, pos_scalar,
                                  bias, out, out_f32, B, S, H, split, ws, counters, chunk,
                                  n_chunks, st);
    case 128:
      return launch<128, STACKED>(q, kv, sc, new_kv, new_sc, pos_ptr, pos_stride, pos_scalar,
                                  bias, out, out_f32, B, S, H, split, ws, counters, chunk,
                                  n_chunks, st);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// q (B, H*D) bf16; kv (B, S, H*D) int8 carriers ([k | v], H*D/2 each);
// sc (B, S, 2*H) f32; pos: pos_ptr[b * pos_stride] int32 when pos_ptr is not
// null, else pos_scalar; bias (B, S) f32 or null; out (B, H*D) f32 when
// out_f32, else bf16; split selects the split-rope pair layout. The launch
// plan (ops/flash_decode.split_plan for the int4 cache): chunk rows a work
// item (the kernel's constant), n_chunks work items a (batch row, head)
// (every live chunk: for a device pos, the whole cache), ws at least
// B * H * n_chunks partials of D + 4 floats, counters B * H zeroed ints, left
// zero. Returns a cudaError_t.
extern "C" int flash_decode_q4(const void* q, const void* kv, const void* sc,
                               const void* pos_ptr, int pos_stride, int pos_scalar,
                               const void* bias, void* out, int out_f32, int B, int S, int H,
                               int D, int split, void* ws, void* counters, int chunk,
                               int n_chunks, void* stream) {
  return dispatch<false>(q, kv, sc, nullptr, nullptr, pos_ptr, pos_stride, pos_scalar, bias,
                         out, out_f32, B, S, H, D, split, ws, counters, chunk, n_chunks,
                         static_cast<cudaStream_t>(stream));
}

// q (B, H*D) bf16; new_kv (B, H*D) int8 carriers and new_sc (B, 2*H) f32, the
// rows at position pos[b]; kv_stack (L, B, S, H*D) carriers and sc_stack
// (L, B, S, 2*H) f32, of which layer `layer` is read (rows [0, pos[b])); pos,
// bias, out, out_f32, split and the plan as for flash_decode_q4, over S + 1
// rows. Returns a cudaError_t.
extern "C" int flash_stacked_q4(const void* q, const void* new_kv, const void* new_sc,
                                const void* kv_stack, const void* sc_stack, int layer,
                                const void* pos_ptr, int pos_stride, int pos_scalar,
                                const void* bias, void* out, int out_f32, int B, int S, int H,
                                int D, int split, void* ws, void* counters, int chunk,
                                int n_chunks, void* stream) {
  const size_t rows = (size_t)layer * B * S;
  const auto* kv = static_cast<const unsigned char*>(kv_stack) + rows * H * D;
  const auto* sc = static_cast<const float*>(sc_stack) + rows * 2 * H;
  return dispatch<true>(q, kv, sc, new_kv, new_sc, pos_ptr, pos_stride, pos_scalar, bias, out,
                        out_f32, B, S, H, D, split, ws, counters, chunk, n_chunks,
                        static_cast<cudaStream_t>(stream));
}
