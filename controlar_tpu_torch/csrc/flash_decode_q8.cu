// Single-query decode attention over an int8 [k|v] cache slab with per-row,
// per-head f32 scales.
//
// Replaces the Pallas kernel `_kernel_q8` of controlar_tpu/ops/flash_decode2.py
// (flash_decode_attention2_q8). For each batch row b and head h:
//   s_r = (q[b,h] . kint[b,r,h]) * ks[b,r,h] / sqrt(D) + bias[b,r]
//   out[b,h] = sum_r softmax(s)_r * vs[b,r,h] * vint[b,r,h]
// over the cache rows r <= pos[b]; the softmax is fp32 and the v scale is
// folded into p, as the TPU kernel does (which rounds p * vs to bf16; here
// it stays fp32). q is read as bf16.
//
// Bound: bytes. A call reads every live row once, 2*H*D int8 values and
// 2*H f32 scales, plus q and the bias row, and writes out; ~2 fp32 flops a
// byte, far below the card's ridge point. At the GPT-B c2i last step (16
// batch rows, 12 heads, D = 64, 576 live rows) that is 15.05 MB: 4.5 us at
// 3.35 TB/s.
//
// The first design (one block of 8 warps per (b, head), each row group
// walking ~18 rows in a chain of online-softmax updates, two 8-byte loads and
// two scattered 4-byte scale loads in flight a lane) took 30.6 us there, 15%
// of the bound, slower than the bf16 kernel on twice the bytes: 192 blocks
// on 132 SMs, latency-bound. This design:
//   - splits each batch row's live rows into chunks of CHUNK rows, a
//     constant of D (64 at D = 64, 32 at D = 100 and 128), so a row's
//     partition depends on its own pos only and its output is the same bit
//     for bit alone or in any batch. A work item is one warp on (b, head,
//     chunk); a block holds 4 of them (the 4 heads of a (b, chunk), side by
//     side in memory). Grids (132 SMs; 72 registers a thread allow 28 warps
//     a SM): at the c2i_w8kv8 last step (B 16, H 12, pos 575) 16 x 9 x 12 =
//     1728 warps in 432 blocks, ~13 warps a SM, all resident at once; at t2i
//     (H 20, S 1280, pos 1142) 16 x 18 x 20 = 5760 warps, ~44 a SM in ~1.6
//     rounds. For a scalar pos the grid is the live chunks; for a device pos
//     vector it covers the cache and the warps past a row's live chunks exit
//     first;
//   - keeps bytes in flight: a warp copies its chunk into shared memory in
//     stages of 8 rows (one cp.async commit group each: the head's D key
//     bytes, D value bytes and two scales a row; 16-byte copies at D = 64
//     and 128, 4-byte ones at D = 100, whose head spans are 4-byte aligned),
//     kAhead stages ahead of the one it computes (issuing the whole chunk at
//     once held a warp's compute back until its last copy was accepted, so
//     compute and copies did not overlap); q and the bias are loaded before
//     the first copies, which loads issued behind them would wait for;
//   - scores from shared memory, 4 lanes a row, q in registers; int8
//     becomes fp32 by a byte permute into the bit pattern of 2^23 and one
//     subtraction, no integer conversion; the softmax runs online per stage
//     in log2 units (exp2) inside the warp (shuffles only: no block barrier
//     anywhere), and the value lanes take each row's p * vs by shuffle;
//   - merges in the same launch: each warp writes its partial (acc[D], m, l)
//     to an fp32 workspace and arrives at a per-(b, head) counter
//     (csrc/arrive.cuh: a warp barrier, then one acquire-release atomic at
//     gpu scope); the last arrival stages the partials into its shared
//     memory (one round of L2 copies), weights them by exp2(m_c - max m) (a
//     chunk masked by the caption bias weighs ~0, one that saw no row 0),
//     sums them in chunk order, writes out and resets the counter. The
//     B x H merges run in parallel. The workspace and counters are the
//     caller's per-stream scratch (ops/_scratch.py): no allocation in a
//     call besides out.
//
// The entry `flash_stacked_q8` runs the same kernel over layer `layer` of a
// stacked (L, B, S, 2*H*D) int8 cache and its (L, B, S, 2*H) scales; it
// replaces `_kernel_q8s` of controlar_tpu/ops/flash_decode_stacked.py
// (flash_stacked_q8). The layer is an offset on both slab pointers; rows
// r < pos[b] come from the slabs and row pos[b], this step's in-flight row,
// from the operands new_kv (B, 2*H*D) int8 and new_sc (B, 2*H), staged into
// its chunk like a slab row, without the bias (0 at decode positions by the
// caller's contract).
//
// The entry `flash_decode_q8_append` replaces `_kernel_q8a` of
// controlar_tpu/ops/flash_decode2.py (flash_decode_attention2_q8_append):
// the stacked path at layer 0 of a flat (B, S, 2*H*D) slab, plus the write
// of the in-flight row's head span and scales into row pos[b] of the slabs,
// by the warp of chunk 0 of each (b, head). No warp reads row pos[b] from
// the slab, so the write races with no read. Bound: bytes, as above, plus
// the written row.
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
constexpr int kAhead = 2;                        // stages in flight ahead of the computed one
constexpr unsigned kAll = 0xffffffffu;
constexpr float kLog2e = 1.4426950408889634f;

template <int D>
struct Cfg {
  // cache rows a work item: 64 at D = 64, 32 for the wider heads
  static constexpr int CHUNK = D == 64 ? 64 : 32;
  static constexpr int STAGES = CHUNK / kStageRows;
  static constexpr int W = D / 4;                                      // int8 words of a head row
  static constexpr int WPL = (W + kLanesPerRow - 1) / kLanesPerRow;   // of them a scoring lane
  static constexpr int UNIT = D % 16 == 0 ? 16 : 4;                   // copy size
  // shared-memory row pitch: 16 bytes of padding at D = 128 keep the 16-byte
  // reads of two rows in distinct banks
  static constexpr int PITCH = D == 128 ? D + 16 : D;
  static constexpr int VG = D / 4;                 // value lanes: 4 values of the head each
  static constexpr int RH = 32 / VG >= 2 ? 2 : 1;  // rows of a stage taken side by side
  static constexpr int WARP_BYTES = 2 * CHUNK * PITCH + CHUNK * 8;
  // partials of D + 4 floats the merge stages at once (the t2i cells' 18
  // chunks of 64 rows merge in one round)
  static constexpr int MERGE_BATCH = WARP_BYTES / (4 * (D + 4)) < 32 ? WARP_BYTES / (4 * (D + 4)) : 32;
};

// four signed bytes -> fp32: (byte ^ 0x80) in the low byte of the bit
// pattern of 2^23 reads as 2^23 + byte + 128, so one byte permute and one
// subtraction a value
__device__ __forceinline__ void i8x4(uint32_t w, float* f) {
  const uint32_t u = w ^ 0x80808080u;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    f[i] = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7440 + i)) - 8388736.0f;
  }
}

template <int BYTES>
__device__ __forceinline__ void cp_async(void* dst, const void* src) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  if constexpr (BYTES == 16) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d), "l"(src) : "memory");
  } else {
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2;\n" ::"r"(d), "l"(src), "n"(BYTES)
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

// STACKED: rows [0, pos) from kv and sc, then the in-flight row from new_kv
// and new_sc; APPEND (with STACKED): then write that row into kv and sc at
// row pos. ws holds B * H * n_chunks partials of D + 4 floats; counters one
// int per (b, head), zero.
template <int D, bool STACKED, bool APPEND, typename OutT>
__global__ void __launch_bounds__(kWarps * 32)
flash_decode_q8_kernel(const __nv_bfloat16* __restrict__ q,  // (B, H*D)
                       int8_t* kv,                           // (B, S, 2*H*D)
                       float* sc,                            // (B, S, 2*H) [ks | vs]
                       const int8_t* __restrict__ new_kv,    // (B, 2*H*D) or null
                       const float* __restrict__ new_sc,     // (B, 2*H) or null
                       const int* __restrict__ pos_ptr,      // (B,) or scalar, or null
                       int pos_stride, int pos_scalar,
                       const float* __restrict__ bias,       // (B, S) or null
                       OutT* __restrict__ out,               // (B, H*D)
                       float* ws, int* counters, int B, int n_chunks, int S, int H,
                       float scale) {
  static_assert(STACKED || !APPEND, "the append reads its row from the operands");
  using C = Cfg<D>;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const long item = (long)blockIdx.x * kWarps + warp;  // (b, chunk, head), head fastest
  if (item >= (long)B * n_chunks * H) return;
  const int h = item % H;
  const int c = (item / H) % n_chunks;
  const int b = item / ((long)H * n_chunks);
  const int hd = H * D;
  const int rb = 2 * hd;  // bytes of a cache row
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
  int8_t* sk = reinterpret_cast<int8_t*>(smem + warp * C::WARP_BYTES);  // (C::CHUNK, PITCH)
  int8_t* sv = sk + C::CHUNK * C::PITCH;                                   // (C::CHUNK, PITCH)
  float* ssc = reinterpret_cast<float*>(sv + C::CHUNK * C::PITCH);         // (C::CHUNK, 2) ks, vs

  // q and the bias are loaded before the chunk's copies are issued (loads
  // issued behind them would wait for them) and converted after
  // lane -> (stage row rr, words [j WPL, j WPL + WPL) of it) in the score
  const int rr = lane / kLanesPerRow;
  const int j = lane % kLanesPerRow;
  uint2 qraw[C::WPL];
#pragma unroll
  for (int w = 0; w < C::WPL; ++w) {
    qraw[w] = j * C::WPL + w < C::W
                  ? *reinterpret_cast<const uint2*>(q + (size_t)b * hd + h * D + 4 * (j * C::WPL + w))
                  : make_uint2(0u, 0u);  // bf16 zeros
  }
  // chunk row r's bias (none on the in-flight row) is lane r % 32's bias_r[r / 32]
  float bias_r[C::CHUNK / 32];
#pragma unroll
  for (int i = 0; i < C::CHUNK / 32; ++i) {
    const int r = 32 * i + lane;
    bias_r[i] = bias && r < rows && r != inflight ? bias[(size_t)b * S + r0 + r] : 0.f;
  }
  // stage st is chunk rows [8 st, 8 st + 8), one commit group (empty past
  // the chunk's end); kAhead stages are in flight ahead of the one computed
  const int8_t* kv_b = kv + (size_t)b * S * rb + h * D;
  const float* sc_b = sc + (size_t)b * S * 2 * H + h;
  constexpr int PER = D / C::UNIT;  // copies a head span
  auto issue = [&](int st) {
    for (int i = lane; i < kStageRows * 2 * PER; i += 32) {
      const int r = st * kStageRows + i / (2 * PER);
      const int half = (i / PER) % 2;  // 0: k, 1: v
      const int u = i % PER;
      if (r < rows) {
        const int8_t* src = STACKED && r == inflight ? new_kv + (size_t)b * rb + h * D
                                                     : kv_b + (size_t)(r0 + r) * rb;
        cp_async<C::UNIT>((half ? sv : sk) + r * C::PITCH + u * C::UNIT,
                          src + half * hd + u * C::UNIT);
      }
    }
    if (lane < 2 * kStageRows) {
      const int r = st * kStageRows + lane / 2;
      if (r < rows) {
        const float* src = STACKED && r == inflight ? new_sc + (size_t)b * 2 * H + h
                                                    : sc_b + (size_t)(r0 + r) * 2 * H;
        cp_async<4>(ssc + r * 2 + lane % 2, src + (lane % 2) * H);
      }
    }
    cp_commit();
  };
#pragma unroll
  for (int st = 0; st < kAhead; ++st) issue(st);

  float qf[4 * C::WPL];
#pragma unroll
  for (int w = 0; w < C::WPL; ++w) {
    const float2 lo = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&qraw[w].x));
    const float2 hi = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&qraw[w].y));
    qf[4 * w] = lo.x;
    qf[4 * w + 1] = lo.y;
    qf[4 * w + 2] = hi.x;
    qf[4 * w + 3] = hi.y;
  }
#pragma unroll
  for (int i = 0; i < C::CHUNK / 32; ++i) bias_r[i] *= kLog2e;  // log2 units
  // lane -> (value group vg: 4 values of the head, row offset vrh) in the value pass
  const int vg = lane % C::VG;
  const int vrh = lane / C::VG;
  const bool v_on = vrh < C::RH;

  float m = -INFINITY, l = 0.f;
  float acc[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
  for (int st = 0; st < C::STAGES; ++st) {
    if (st * kStageRows >= rows) break;  // uniform across the warp
    cp_wait<kAhead - 1>();  // stage st has landed
    __syncwarp();
    issue(st + kAhead);
    const int r = st * kStageRows + rr;
    const bool valid = r < rows;
    // score row r: the lane's words of the head's key row against q
    uint32_t kw[C::WPL];
    if constexpr (C::WPL % 4 == 0 && C::PITCH % 16 == 0) {
#pragma unroll
      for (int w = 0; w < C::WPL; w += 4) {
        const uint4 v4 = *reinterpret_cast<const uint4*>(sk + r * C::PITCH + 4 * (j * C::WPL + w));
        kw[w] = v4.x;
        kw[w + 1] = v4.y;
        kw[w + 2] = v4.z;
        kw[w + 3] = v4.w;
      }
    } else {
#pragma unroll
      for (int w = 0; w < C::WPL; ++w) {
        kw[w] = j * C::WPL + w < C::W
                    ? *reinterpret_cast<const uint32_t*>(sk + r * C::PITCH + 4 * (j * C::WPL + w))
                    : 0u;
      }
    }
    float s0 = 0.f, s1 = 0.f;
#pragma unroll
    for (int w = 0; w < C::WPL; ++w) {
      float f[4];
      i8x4(kw[w], f);
      float& s = w % 2 ? s1 : s0;
      s = fmaf(qf[4 * w], f[0], s);
      s = fmaf(qf[4 * w + 1], f[1], s);
      s = fmaf(qf[4 * w + 2], f[2], s);
      s = fmaf(qf[4 * w + 3], f[3], s);
    }
    float s = s0 + s1;
    s += __shfl_xor_sync(kAll, s, 1);
    s += __shfl_xor_sync(kAll, s, 2);
    const float bias_rr = __shfl_sync(kAll, bias_r[st * kStageRows / 32], r % 32);
    s = valid ? s * ssc[r * 2] * scale + bias_rr : -INFINITY;  // log2 units
    // the stage's online-softmax step, the same in every lane
    float mx = s;
#pragma unroll
    for (int off = kLanesPerRow; off < 32; off <<= 1) mx = fmaxf(mx, __shfl_xor_sync(kAll, mx, off));
    const float m_new = fmaxf(m, mx);  // finite: the stage has a live row
    const float alpha = exp2f(m - m_new);  // exp2(-inf) = 0 on the first stage
    const float p = valid ? exp2f(s - m_new) : 0.f;
    float ps = p;
#pragma unroll
    for (int off = kLanesPerRow; off < 32; off <<= 1) ps += __shfl_xor_sync(kAll, ps, off);
    l = l * alpha + ps;
    m = m_new;
    const float pv = valid ? p * ssc[r * 2 + 1] : 0.f;  // the v scale folded into p
    // acc = acc * alpha + sum_r pv_r * v_r over the stage's rows
#pragma unroll
    for (int k = 0; k < 4; ++k) acc[k] *= alpha;
#pragma unroll
    for (int i = 0; i < kStageRows / C::RH; ++i) {
      const int vr = vrh + C::RH * i;  // stage row
      const float pr = __shfl_sync(kAll, pv, (vr % kStageRows) * kLanesPerRow);
      if (v_on) {
        float v[4];
        i8x4(*reinterpret_cast<const uint32_t*>(sv + (st * kStageRows + vr) * C::PITCH + 4 * vg), v);
#pragma unroll
        for (int k = 0; k < 4; ++k) acc[k] = fmaf(pr, v[k], acc[k]);
      }
    }
  }
  if constexpr (C::RH == 2) {
#pragma unroll
    for (int k = 0; k < 4; ++k) acc[k] += __shfl_xor_sync(kAll, acc[k], 16);
  }

  // the append, after the chunk (its loads would wait behind the copies)
  if constexpr (APPEND) {
    if (c == 0 && pos >= 0 && pos < S) {  // the wrapper checks a scalar pos; a per-slot one is trusted
      const uint32_t* src = reinterpret_cast<const uint32_t*>(new_kv + (size_t)b * rb + h * D);
      uint32_t* dst = reinterpret_cast<uint32_t*>(kv + ((size_t)b * S + pos) * rb + h * D);
      for (int i = lane; i < D / 4; i += 32) {
        dst[i] = src[i];
        dst[hd / 4 + i] = src[hd / 4 + i];
      }
      if (lane < 2) {
        const int off = lane * H + h;
        sc[((size_t)b * S + pos) * 2 * H + off] = new_sc[(size_t)b * 2 * H + off];
      }
    }
  }

  constexpr int PH = D + 4;  // floats of a partial: acc (D), m, l, padding
  float* pb = ws + ((size_t)b * H + h) * n_chunks * PH;  // the (b, head) partials
  if (vrh == 0) __stcg(reinterpret_cast<float4*>(pb + (size_t)c * PH) + vg,
                       make_float4(acc[0], acc[1], acc[2], acc[3]));
  if (lane == 0) {
    __stcg(pb + (size_t)c * PH + D, m);  // -inf with l = 0 when the chunk saw no row
    __stcg(pb + (size_t)c * PH + D + 1, l);
  }
  if (!split::arrive_warp(counters + (size_t)b * H + h, live_chunks)) return;

  // the last arrival merges the (b, head) partials in chunk order, staged
  // through the warp's shared memory MERGE_BATCH at a time (one round of
  // copies), with an online rescale between batches
  float* sm = reinterpret_cast<float*>(sk);
  float mx = -INFINITY, den = 0.f;
  float n[4] = {0.f, 0.f, 0.f, 0.f};
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
    for (int k = 0; k < 4; ++k) n[k] *= rescale;
    for (int i = 0; i < cnt; ++i) {
      const float wi = __shfl_sync(kAll, w, i);
      den += __shfl_sync(kAll, wl, i);
      const float4 a = reinterpret_cast<const float4*>(sm + i * PH)[vg];
      n[0] = fmaf(wi, a.x, n[0]);
      n[1] = fmaf(wi, a.y, n[1]);
      n[2] = fmaf(wi, a.z, n[2]);
      n[3] = fmaf(wi, a.w, n[3]);
    }
    mx = m_new;
  }
  if (vrh == 0) {
    OutT* o = out + (size_t)b * hd + h * D + 4 * vg;
#pragma unroll
    for (int k = 0; k < 4; ++k) store_out(o + k, den > 0.f ? n[k] / den : 0.f);  // 0: no live row
  }
}

template <int D, bool STACKED, bool APPEND>
int launch(const void* q, const void* kv, const void* sc, const void* new_kv,
           const void* new_sc, const void* pos_ptr, int pos_stride, int pos_scalar,
           const void* bias, void* out, int out_f32, int B, int S, int H, void* ws,
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
  const long items = (long)B * n_chunks * H;
  const dim3 grid(static_cast<unsigned>((items + kWarps - 1) / kWarps));
  const int smem = kWarps * Cfg<D>::WARP_BYTES;  // under the 48 KB default at every D
  // scores in log2 units, for exp2: 1 / sqrt(D) and the bias times log2(e)
  const float scale = kLog2e / sqrtf(static_cast<float>(D));
  auto* qp = static_cast<const __nv_bfloat16*>(q);
  auto* kvp = static_cast<int8_t*>(const_cast<void*>(kv));
  auto* sp = static_cast<float*>(const_cast<void*>(sc));
  auto* nkp = static_cast<const int8_t*>(new_kv);
  auto* nsp = static_cast<const float*>(new_sc);
  auto* pp = static_cast<const int*>(pos_ptr);
  auto* bp = static_cast<const float*>(bias);
  auto* wsp = static_cast<float*>(ws);
  auto* cp = static_cast<int*>(counters);
  if (out_f32) {
    flash_decode_q8_kernel<D, STACKED, APPEND, float><<<grid, kWarps * 32, smem, stream>>>(
        qp, kvp, sp, nkp, nsp, pp, pos_stride, pos_scalar, bp, static_cast<float*>(out), wsp, cp,
        B, n_chunks, S, H, scale);
  } else {
    flash_decode_q8_kernel<D, STACKED, APPEND, __nv_bfloat16><<<grid, kWarps * 32, smem, stream>>>(
        qp, kvp, sp, nkp, nsp, pp, pos_stride, pos_scalar, bp, static_cast<__nv_bfloat16*>(out),
        wsp, cp, B, n_chunks, S, H, scale);
  }
  return static_cast<int>(cudaGetLastError());
}

template <bool STACKED, bool APPEND = false>
int dispatch(const void* q, const void* kv, const void* sc, const void* new_kv,
             const void* new_sc, const void* pos_ptr, int pos_stride, int pos_scalar,
             const void* bias, void* out, int out_f32, int B, int S, int H, int D, void* ws,
             void* counters, int chunk, int n_chunks, cudaStream_t st) {
  switch (D) {
    case 64:
      return launch<64, STACKED, APPEND>(q, kv, sc, new_kv, new_sc, pos_ptr, pos_stride,
                                         pos_scalar, bias, out, out_f32, B, S, H, ws, counters,
                                         chunk, n_chunks, st);
    case 100:
      return launch<100, STACKED, APPEND>(q, kv, sc, new_kv, new_sc, pos_ptr, pos_stride,
                                          pos_scalar, bias, out, out_f32, B, S, H, ws, counters,
                                          chunk, n_chunks, st);
    case 128:
      return launch<128, STACKED, APPEND>(q, kv, sc, new_kv, new_sc, pos_ptr, pos_stride,
                                          pos_scalar, bias, out, out_f32, B, S, H, ws, counters,
                                          chunk, n_chunks, st);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// q (B, H*D) bf16; kv (B, S, 2*H*D) int8; sc (B, S, 2*H) f32; pos:
// pos_ptr[b * pos_stride] int32 when pos_ptr is not null, else pos_scalar;
// bias (B, S) f32 or null; out (B, H*D) f32 when out_f32, else bf16. The
// launch plan (ops/flash_decode.q8_plan): chunk rows a work item (32, the
// kernel's constant), n_chunks work items a (batch row, head) (every live
// chunk: for a device pos, the whole cache), ws at least B * H * n_chunks
// partials of D + 4 floats, counters B * H zeroed ints, left zero. Returns a
// cudaError_t.
extern "C" int flash_decode_q8(const void* q, const void* kv, const void* sc,
                               const void* pos_ptr, int pos_stride, int pos_scalar,
                               const void* bias, void* out, int out_f32, int B, int S, int H,
                               int D, void* ws, void* counters, int chunk, int n_chunks,
                               void* stream) {
  return dispatch<false>(q, kv, sc, nullptr, nullptr, pos_ptr, pos_stride, pos_scalar, bias,
                         out, out_f32, B, S, H, D, ws, counters, chunk, n_chunks,
                         static_cast<cudaStream_t>(stream));
}

// q (B, H*D) bf16; new_kv (B, 2*H*D) int8 and new_sc (B, 2*H) f32, the rows
// at position pos[b]; kv_stack (L, B, S, 2*H*D) int8 and sc_stack
// (L, B, S, 2*H) f32, of which layer `layer` is read (rows [0, pos[b]));
// pos, bias, out, out_f32 and the plan as for flash_decode_q8, over S + 1
// rows. Returns a cudaError_t.
extern "C" int flash_stacked_q8(const void* q, const void* new_kv, const void* new_sc,
                                const void* kv_stack, const void* sc_stack, int layer,
                                const void* pos_ptr, int pos_stride, int pos_scalar,
                                const void* bias, void* out, int out_f32, int B, int S, int H,
                                int D, void* ws, void* counters, int chunk, int n_chunks,
                                void* stream) {
  const size_t rows = (size_t)layer * B * S;
  const auto* kv = static_cast<const int8_t*>(kv_stack) + rows * 2 * H * D;
  const auto* sc = static_cast<const float*>(sc_stack) + rows * 2 * H;
  return dispatch<true>(q, kv, sc, new_kv, new_sc, pos_ptr, pos_stride, pos_scalar, bias, out,
                        out_f32, B, S, H, D, ws, counters, chunk, n_chunks,
                        static_cast<cudaStream_t>(stream));
}

// q (B, H*D) bf16; new_kv (B, 2*H*D) int8 and new_sc (B, 2*H) f32, the row
// at position pos[b]; kv (B, S, 2*H*D) int8 and sc (B, S, 2*H) f32, whose
// rows [0, pos[b]) are read and whose row pos[b] is written with new_kv and
// new_sc; pos, bias, out, out_f32 and the plan as for flash_stacked_q8 (the
// bias is not added to row pos[b]). Returns a cudaError_t.
extern "C" int flash_decode_q8_append(const void* q, const void* new_kv, const void* new_sc,
                                      void* kv, void* sc, const void* pos_ptr, int pos_stride,
                                      int pos_scalar, const void* bias, void* out, int out_f32,
                                      int B, int S, int H, int D, void* ws, void* counters,
                                      int chunk, int n_chunks, void* stream) {
  return dispatch<true, true>(q, kv, sc, new_kv, new_sc, pos_ptr, pos_stride, pos_scalar, bias,
                              out, out_f32, B, S, H, D, ws, counters, chunk, n_chunks,
                              static_cast<cudaStream_t>(stream));
}
