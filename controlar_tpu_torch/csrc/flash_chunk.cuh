// The split K-query chunk attention kernel shared by csrc/flash_chunk.cu
// (bf16 and int8 slabs) and csrc/flash_chunk_q4.cu (nibble-packed int4).
// The int4 decode kernel (csrc/flash_decode_q4.cu) takes its span copies,
// nibble conversions and mma from here.
//
// For batch row b, head h and chunk query j (the chunk's own rows are
// already in the cache):
//   s_r = q[b,j,h] . k[b,r,h] * ks[b,r,h] / sqrt(D) + (r == pos[b]+j ? 0 : bias[b,r])
//   out[b,j,h] = sum_r softmax(s)_r * vs[b,r,h] * v[b,r,h]
// over the rows r <= pos[b] + j (ks = vs = 1 for the bf16 slab). The bias
// is not added on a query's own row (the diagonal exception), so a fully
// masked left-padded caption row still has one finite score.
//
// Bound: bytes. A call reads the live rows once for all K queries (at the
// GPT-3B spec verify, 16 batch rows, 32 heads x 100, 576 live rows: 118 MB
// of bf16, 61 MB of int8, 32 MB of int4 with the scales) against 2
// tensor-core and 2 fp32 flops per value pair and query. Design:
//   - a work item is one warp on (b, head, tile of NQ <= 8 queries, chunk of
//     kChunk cache rows); a block holds 4 (the 4 heads of a (b, chunk)),
//     the query tiles run over blockIdx.y. The chunk length is one constant,
//     so a row's partition, and its output bit for bit, depend on its own
//     pos only. For a device pos vector the grid covers the whole cache and
//     the items past a tile's last visible row exit first;
//   - copies: a head span (2 D bytes bf16, D int8, D/2 int4) starts only
//     8-, 4- or 2-byte aligned at D = 100, so each row's span is copied as
//     the 16-byte-aligned window that holds it, in 16-byte cp.async pieces
//     (the last one zero-filled past the span), and read from the span's
//     offset in the window, an offset that is the same in every stage. A
//     stage is 8 rows of k and v windows (two lanes a span), their k and v
//     scales and bias, one commit group, AHEAD stages ahead of the one
//     computed, in a per-warp ring; each lane's copies are worked out once
//     per work item. q and pos are loaded before the first copies;
//   - scores on the tensor cores: one mma.sync m16n8k16 (bf16 in, fp32
//     sums) per 16 head dims, the tile's queries as A (rows 0-7, rows 8-15
//     zero) and the stage's 8 rows as B. Lane (g, t) holds element quad
//     4w + t of query g and of stage row g for step w, so both operands
//     are plain 8-, 4- or 2-byte loads (the dot product does not depend on
//     the order of the dims); int8 and int4 become bf16 exactly in
//     registers; D = 100 takes 7 steps, quads 25-27 zero. The ring's row
//     pitch keeps the 8 rows of a load in distinct banks;
//   - lane (g, t) gets the scores of query g against rows 2t and 2t + 1, so
//     a query's stage max takes 2 shuffles. Softmax online in fp32, in log2
//     units; the running max moves only when a score passes it by 2^8 (one
//     warp vote a stage). p (times the v scale) goes through an 8 x NQ tile
//     in shared memory to the value lanes, 4 dims of the head each for all
//     the tile's queries; p, alpha and P.V stay fp32, where the TPU kernel
//     rounds them to bf16;
//   - merge in the same launch: each warp writes its (acc, m, l) per query
//     to an fp32 workspace and arrives at the (b, head, tile) counter
//     (csrc/arrive.cuh); the last arrival weighs the parts by
//     exp2(m_c - max m) (0 for a part that saw no row), sums them in chunk
//     order and writes out, so the result does not depend on the finishing
//     order, the batch or the launch. A tile with one live chunk writes out
//     directly. Workspace and counters are the caller's per-stream scratch
//     (ops/_scratch.py).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "arrive.cuh"

namespace chunk {

constexpr int kWarps = 4;       // work items (warps) a block
// cache rows a work item, for every format and D (ops/flash_chunk.CHUNK_ROWS
// holds the same value): the fastest of 32, 64 and 128 at the GPT-3B verify
// (K 4, D 100) for the bf16 and int8 slabs
constexpr int kChunk = 64;
static_assert(kChunk % 8 == 0, "whole 8-row stages");
constexpr int kStageRows = 8;   // rows a cp.async commit group, the mma's n
constexpr unsigned kAll = 0xffffffffu;
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kSlack = 8.f;  // log2 units a score may pass the running max by

// Slab formats: QB bytes of a quad (4 elements, or 4 values of 2 carriers)
struct Bf16Kv { static constexpr int QB = 8; static constexpr bool SCALED = false; };
struct Int8Kv { static constexpr int QB = 4; static constexpr bool SCALED = true; };
struct Int4Kv { static constexpr int QB = 2; static constexpr bool SCALED = true; };

constexpr int round16(int x) { return (x + 15) / 16 * 16; }

// the least row pitch >= w, a multiple of 16, at which the quad loads of 8
// rows (slot bytes wide) fall in distinct banks: pitch / slot = 4 (mod 8)
constexpr int pitch_for(int w, int slot) {
  int p = round16(w);
  while ((p / slot) % 8 != 4) p += 16;
  return p;
}

template <class F, int D>
struct Cfg {
  static constexpr int QUADS = D / 4;                // quads of a head span
  static constexpr int KSTEPS = (QUADS + 3) / 4;     // mma steps of 16 dims
  static constexpr int HB = QUADS * F::QB;           // bytes of a head span
  static constexpr int ALIGN = (HB & -HB) < 16 ? (HB & -HB) : 16;  // of a span's address
  static constexpr int WINDOW = round16(16 - ALIGN + HB);  // the 16-byte window of a span
  static constexpr int NP = WINDOW / 16;             // copies a span
  static constexpr int PITCH = pitch_for(WINDOW, F::QB > 4 ? F::QB : 4);
  // stages in flight ahead of the computed one (a ring of AHEAD + 1): the
  // bf16 stages at D = 100 and 128 are 1.4-1.8x those at D = 64
  static constexpr int AHEAD = F::QB == 8 ? (D == 64 ? 3 : (D == 100 ? 2 : 1)) : 3;
  static constexpr int RING = AHEAD + 1;
  // a stage: k windows, v windows, then ks, vs and bias of its 8 rows
  static constexpr int STAGE_BYTES = 2 * kStageRows * PITCH + 3 * kStageRows * 4;
  static constexpr int PTILE_BYTES = kStageRows * 8 * 4;  // p of 8 rows x up to 8 queries
  static constexpr int WARP_BYTES = RING * STAGE_BYTES + PTILE_BYTES;
  static constexpr int VG = QUADS;                   // value lanes a row
  static constexpr int RH = 32 / VG >= 2 ? 2 : 1;    // rows side by side in P.V
  static_assert(D % 4 == 0 && VG <= 32, "a head is at most 32 quads");
  static_assert(kWarps * WARP_BYTES <= 48 * 1024, "under the default shared memory");
};

// 16 bytes, of which src_bytes are read and the rest zero-filled, with an L2
// prefetch of the 128-byte line (faster on the bf16 slab in a probe)
__device__ __forceinline__ void cp_async16(void* dst, const void* src, int src_bytes) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global.L2::128B [%0], [%1], 16, %2;\n" ::"r"(d), "l"(src),
               "r"(src_bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d), "l"(src) : "memory");
}

// One lane's half of the copy of a head span of HB bytes that starts at
// byte o of the 16-byte-aligned window at src (NP pieces of 16 bytes): the
// pieces 2 k + part, so that two lanes (part 0 and 1) copy a span; the last
// piece is zero-filled past the span. The span lands at byte o of dst.
template <int HB, int NP>
__device__ __forceinline__ void copy_window(unsigned char* dst, const unsigned char* src, int o,
                                            int part) {
#pragma unroll
  for (int k = 0; k < (NP + 1) / 2; ++k) {
    const int u = 2 * k + part;
    const int n = min(16, o + HB - 16 * u);  // 0 or less: past the span
    if (u < NP && n > 0) cp_async16(dst + 16 * u, src + 16 * u, n);
  }
}

__device__ __forceinline__ void cp_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }

template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// D += A (16 x 16, row-major) B (16 x 8, column-major), bf16 in, fp32 sums
__device__ __forceinline__ void mma(float* c, uint32_t a0, uint32_t a1, uint32_t a2,
                                    uint32_t a3, uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

// four signed bytes -> fp32: (byte ^ 0x80) in the low byte of the bit
// pattern of 2^23 reads as 2^23 + byte + 128
__device__ __forceinline__ void i8x4(uint32_t w, float* f) {
  const uint32_t u = w ^ 0x80808080u;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    f[i] = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7440 + i)) - 8388736.0f;
  }
}

// the 4-bit values at bits 0-3 and 16-19 of v as a bf16 pair, exactly:
// (n ^ 8) | 0x4300 reads as 136 + n
__device__ __forceinline__ uint32_t nibbles_bf16x2(uint32_t v) {
  uint32_t t;
  asm("lop3.b32 %0, %1, %2, %3, 0x6a;\n" : "=r"(t) : "r"(v), "r"(0x000F000Fu), "r"(0x43084308u));
  const uint32_t k136 = 0x43084308u;
  __nv_bfloat162 x = __hsub2(*reinterpret_cast<const __nv_bfloat162*>(&t),
                             *reinterpret_cast<const __nv_bfloat162*>(&k136));
  return *reinterpret_cast<uint32_t*>(&x);
}

// two carriers (lo | hi nibble each) -> the bf16 pairs (lo0, hi0), (lo1, hi1)
__device__ __forceinline__ void q4_pairs(uint32_t c, uint32_t& p0, uint32_t& p1) {
  const uint32_t c1 = (c >> 8) & 0xffu;
  p0 = nibbles_bf16x2(c | (c << 12));
  p1 = nibbles_bf16x2(c1 | (c1 << 12));
}

// quad qd of the span at s as the mma's two bf16 pairs (elements 0-1, 2-3)
template <class F>
__device__ __forceinline__ void quad_bf16(const unsigned char* s, int qd, uint32_t& b0,
                                          uint32_t& b1) {
  if constexpr (F::QB == 8) {
    const uint2 raw = *reinterpret_cast<const uint2*>(s + 8 * qd);
    b0 = raw.x;
    b1 = raw.y;
  } else if constexpr (F::QB == 4) {
    float f[4];
    i8x4(*reinterpret_cast<const uint32_t*>(s + 4 * qd), f);  // exact in bf16: the high halves
    b0 = __byte_perm(__float_as_uint(f[0]), __float_as_uint(f[1]), 0x7632);
    b1 = __byte_perm(__float_as_uint(f[2]), __float_as_uint(f[3]), 0x7632);
  } else {
    q4_pairs(*reinterpret_cast<const uint16_t*>(s + 2 * qd), b0, b1);
  }
}

// quad qd of the span at s as 4 fp32 values
template <class F>
__device__ __forceinline__ void quad_f32(const unsigned char* s, int qd, float* v) {
  if constexpr (F::QB == 4) {
    i8x4(*reinterpret_cast<const uint32_t*>(s + 4 * qd), v);
  } else {
    uint32_t w[2];
    if constexpr (F::QB == 8) {
      const uint2 raw = *reinterpret_cast<const uint2*>(s + 8 * qd);
      w[0] = raw.x;
      w[1] = raw.y;
    } else {
      q4_pairs(*reinterpret_cast<const uint16_t*>(s + 2 * qd), w[0], w[1]);
    }
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      v[2 * i] = __uint_as_float(w[i] << 16);
      v[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
    }
  }
}

__device__ __forceinline__ void store_out(float* p, float x) { *p = x; }
__device__ __forceinline__ void store_out(__nv_bfloat16* p, float x) { *p = __float2bfloat16(x); }

// The head dim of value i (0-3) of quad qd: contiguous for bf16, int8 and
// interleaved int4; split-rope int4 quads hold (lo, hi) of carriers 2 qd and
// 2 qd + 1, the dims (2 qd, D/2 + 2 qd, 2 qd + 1, D/2 + 2 qd + 1).
template <class F, int D>
__device__ __forceinline__ int quad_dim(int qd, int i, int split) {
  if (F::QB == 2 && split) return (i & 1) * (D / 2) + 2 * qd + (i >> 1);
  return 4 * qd + i;
}

// q's elements of quad qd of query row qrow (bf16) as the mma's two pairs
template <class F, int D>
__device__ __forceinline__ void q_pairs(const __nv_bfloat16* qrow, int qd, int split,
                                        uint32_t& a0, uint32_t& a1) {
  if (F::QB == 2 && split) {
    const uint32_t e = *reinterpret_cast<const uint32_t*>(qrow + 2 * qd);          // even dims
    const uint32_t o = *reinterpret_cast<const uint32_t*>(qrow + D / 2 + 2 * qd);  // odd dims
    a0 = __byte_perm(e, o, 0x5410);
    a1 = __byte_perm(e, o, 0x7632);
  } else {
    const uint2 raw = *reinterpret_cast<const uint2*>(qrow + 4 * qd);
    a0 = raw.x;
    a1 = raw.y;
  }
}

// The kernel. kv: the slab as bytes, rows of 2 * H spans ([k heads | v
// heads]); sc (B, S, 2*H) [ks | vs] for the scaled formats. ws holds
// B * H * n_tiles * n_chunks parts of NQ * (D + 4) floats; counters one int
// per (b, head, tile), zero.
template <class F, int D, int NQ, typename OutT>
__global__ void __launch_bounds__(kWarps * 32)
chunk_kernel(const __nv_bfloat16* __restrict__ q,  // (B, K, H*D)
             const unsigned char* __restrict__ kv,  // (B, S, 2*H*HB) bytes
             const float* __restrict__ sc,          // (B, S, 2*H) or null
             const int* __restrict__ pos_ptr,       // (B,) or scalar, or null
             int pos_stride, int pos_scalar,
             const float* __restrict__ bias,        // (B, S) or null
             OutT* __restrict__ out,                // (B, K, H*D)
             float* ws, int* counters, int B, int S, int H, int K, int n_chunks,
             int split_rope, float scale) {
  using C = Cfg<F, D>;
  constexpr int PH = D + 4;  // floats of a query's part: acc (D), m, l, padding
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int item = blockIdx.x * kWarps + warp;  // (b, chunk, head), head fastest
  if (item >= B * n_chunks * H) return;
  const int h = item % H;
  const int c = (item / H) % n_chunks;
  const int b = item / (H * n_chunks);
  const int qt = blockIdx.y;
  const int n_tiles = gridDim.y;
  const int q0 = qt * NQ;
  const int nq = min(NQ, K - q0);  // the tile's queries
  const int hd = H * D;
  const int g = lane / 4;
  const int t = lane % 4;

  // q as the mma's A rows 0-7 (query g), loaded with pos, before the copies
  uint32_t qa[C::KSTEPS][2];
  {
    const __nv_bfloat16* qrow = q + ((size_t)b * K + q0 + g) * hd + (size_t)h * D;
#pragma unroll
    for (int w = 0; w < C::KSTEPS; ++w) {
      const int qd = 4 * w + t;
      qa[w][0] = qa[w][1] = 0u;
      if (g < nq && qd < C::QUADS) q_pairs<F, D>(qrow, qd, split_rope, qa[w][0], qa[w][1]);
    }
  }
  const int pos = pos_ptr ? pos_ptr[(size_t)b * pos_stride] : pos_scalar;
  const int n_rows = max(0, min(pos + q0 + nq, S));  // rows the tile's last query sees
  const int live = max(1, (n_rows + kChunk - 1) / kChunk);
  if (c >= live) return;
  const int r0 = c * kChunk;
  const int rows = max(0, min(kChunk, n_rows - r0));
  const size_t rb = 2 * (size_t)H * C::HB;  // bytes of a cache row

  extern __shared__ __align__(16) unsigned char smem[];
  unsigned char* ring = smem + warp * C::WARP_BYTES;
  float* ptile = reinterpret_cast<float*>(ring + C::RING * C::STAGE_BYTES);  // [8][NQ]

  // stage st: chunk rows [8 st, 8 st + 8), one commit group (empty past the
  // chunk's end), in ring slot st % RING. The span of stage row sr, half
  // (0: k, 1: v) starts at byte o of its 16-byte window, the same o in
  // every stage (8 rows move it by 8 rb, a multiple of 16). Lanes 2 sp and
  // 2 sp + 1 copy span sp = 8 half + sr, alternate 16-byte pieces each.
  const unsigned char* kv_b = kv + ((size_t)b * S + r0) * rb + (size_t)h * C::HB;  // k span of row 0
  const size_t vspan = (size_t)H * C::HB;  // k span -> v span
  auto span_off = [&](int r, int half) {  // o of chunk row r's span
    return static_cast<int>(reinterpret_cast<uintptr_t>(kv_b + (size_t)r * rb + half * vspan) % 16);
  };
  const int cp_row = (lane / 2) % kStageRows;
  const int cp_half = lane / (2 * kStageRows);
  const int cp_o = span_off(cp_row, cp_half);
  const unsigned char* cp_src = kv_b + (size_t)cp_row * rb + cp_half * vspan - cp_o;  // stage 0's window
  const int cp_dst = (cp_half * kStageRows + cp_row) * C::PITCH;
  // ks, vs and bias of stage row lane % 8 from lanes 0-23
  const int fs_which = lane / kStageRows;  // 0: ks, 1: vs, 2: bias
  const float* fs_src = nullptr;
  if (fs_which < 2 && F::SCALED) fs_src = sc + ((size_t)b * S + r0 + lane % kStageRows) * 2 * H + h + fs_which * H;
  if (fs_which == 2 && bias) fs_src = bias + (size_t)b * S + r0 + lane % kStageRows;
  const size_t fs_step = fs_which < 2 ? (size_t)kStageRows * 2 * H : kStageRows;  // floats a stage
  auto issue = [&](int st) {
    unsigned char* slot = ring + (st % C::RING) * C::STAGE_BYTES;
    if (st * kStageRows + cp_row < rows) {
      copy_window<C::HB, C::NP>(slot + cp_dst, cp_src + (size_t)st * kStageRows * rb, cp_o,
                                lane & 1);
    }
    if (fs_src && st * kStageRows + lane % kStageRows < rows) {
      cp_async4(slot + 2 * kStageRows * C::PITCH + 4 * lane, fs_src + st * fs_step);
    }
    cp_commit();
  };
#pragma unroll
  for (int st = 0; st < C::AHEAD; ++st) issue(st);

  const int own = pos + q0 + g;  // query g's own row, the last it sees
  // value lanes: quad vl of the head, stage rows vrh, vrh + RH, ...
  const int vl = lane % C::VG;
  const int vrh = lane / C::VG;
  const int ok_g = span_off(g, 0);  // of stage row g's k span, every stage
  const int ov0 = span_off(0, 1);    // of stage row vr's v span: ov0 + vr rb (mod 16)
  const int rb16 = static_cast<int>(rb % 16);
  const bool has_bias = bias != nullptr;

  float m = -INFINITY, l = 0.f;  // query g's running max and this lane's rows' sum
  float acc[NQ][4];
#pragma unroll
  for (int j = 0; j < NQ; ++j) {
#pragma unroll
    for (int k = 0; k < 4; ++k) acc[j][k] = 0.f;
  }
  const int n_stages = (rows + kStageRows - 1) / kStageRows;
  for (int st = 0; st < n_stages; ++st) {
    cp_wait<C::AHEAD - 1>();  // stage st has landed
    __syncwarp();             // every lane is done with the slot issue() refills
    issue(st + C::AHEAD);
    const unsigned char* slot = ring + (st % C::RING) * C::STAGE_BYTES;
    const float* fs = reinterpret_cast<const float*>(slot + 2 * kStageRows * C::PITCH);
    const int rs = st * kStageRows;
    // scores of queries 0-7 against the stage's rows (B column g = row g),
    // the even and odd steps in two chains of mma
    float d[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
    {
      const unsigned char* krow = slot + g * C::PITCH + ok_g;
#pragma unroll
      for (int w = 0; w < C::KSTEPS; ++w) {
        const int qd = 4 * w + t;
        uint32_t b0 = 0u, b1 = 0u;
        if (C::QUADS % 4 == 0 || qd < C::QUADS) quad_bf16<F>(krow, qd, b0, b1);
        mma(d[w % 2], qa[w][0], 0u, qa[w][1], 0u, b0, b1);
      }
    }
    // lane (g, t): query g against stage rows 2t, 2t + 1 (a row past the
    // chunk's end holds stale bytes: its score is replaced by -inf, its p
    // and v scale by 0)
    float s[2], vsc[2];
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int r = rs + 2 * t + e;
      const int ar = r0 + r;
      float x = (d[0][e] + d[1][e]) * (F::SCALED ? fs[2 * t + e] * scale : scale);
      if (has_bias && ar != own) x = fmaf(fs[2 * kStageRows + 2 * t + e], kLog2e, x);
      s[e] = g < nq && r < rows && ar <= own ? x : -INFINITY;
      vsc[e] = r >= rows ? 0.f : (F::SCALED ? fs[kStageRows + 2 * t + e] : 1.f);
    }
    // the running max moves (acc and l rescaled) only when a score passes
    // it by kSlack, so p <= 2^kSlack; one vote tells the warp
    if (__any_sync(kAll, s[0] > m + kSlack || s[1] > m + kSlack)) {
      float mx = fmaxf(s[0], s[1]);
      mx = fmaxf(mx, __shfl_xor_sync(kAll, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(kAll, mx, 2));
      const float m_new = fmaxf(m, mx);
      const float alpha = m_new == -INFINITY ? 1.f : exp2f(m - m_new);  // 0 from m = -inf
      m = m_new;
      l *= alpha;
#pragma unroll
      for (int j = 0; j < NQ; ++j) {
        const float aj = __shfl_sync(kAll, alpha, 4 * j);
#pragma unroll
        for (int k = 0; k < 4; ++k) acc[j][k] *= aj;
      }
    }
    float p[2];
#pragma unroll
    for (int e = 0; e < 2; ++e) p[e] = s[e] == -INFINITY ? 0.f : exp2f(s[e] - m);
    l += p[0] + p[1];
    if (g < NQ) {
      ptile[(2 * t) * NQ + g] = p[0] * vsc[0];  // the v scale folded into p
      ptile[(2 * t + 1) * NQ + g] = p[1] * vsc[1];
    }
    __syncwarp();
    // acc[j] += p[r][j] * v[r] over the stage's rows, without a branch: a
    // row past the chunk's end has p = 0 and reads the stage's last live
    // row's v instead of stale bytes; the lanes past the head's quads
    // (D = 100) compute sums that are never stored
    const int last = rows - rs - 1;  // the stage's last live row
#pragma unroll
    for (int i = 0; i < kStageRows / C::RH; ++i) {
      const int vr = min(vrh, C::RH - 1) + C::RH * i;  // stage row (lanes past the quads: any)
      {
        const int rr = min(vr, last);
        float v[4];
        quad_f32<F>(slot + (kStageRows + rr) * C::PITCH + ((ov0 + rr * rb16) & 15), vl, v);
        float pr[NQ];
        if constexpr (NQ % 4 == 0) {
#pragma unroll
          for (int j = 0; j < NQ; j += 4) {
            const float4 x = *reinterpret_cast<const float4*>(ptile + vr * NQ + j);
            pr[j] = x.x;
            pr[j + 1] = x.y;
            pr[j + 2] = x.z;
            pr[j + 3] = x.w;
          }
        } else {
          const float2 x = *reinterpret_cast<const float2*>(ptile + vr * NQ);
          pr[0] = x.x;
          pr[1] = x.y;
        }
#pragma unroll
        for (int j = 0; j < NQ; ++j) {
#pragma unroll
          for (int k = 0; k < 4; ++k) acc[j][k] = fmaf(pr[j], v[k], acc[j][k]);
        }
      }
    }
  }
  cp_wait<0>();  // the empty groups past the chunk's end
  if constexpr (C::RH == 2) {
#pragma unroll
    for (int j = 0; j < NQ; ++j) {
#pragma unroll
      for (int k = 0; k < 4; ++k) acc[j][k] += __shfl_xor_sync(kAll, acc[j][k], C::VG);
    }
  }
  l += __shfl_xor_sync(kAll, l, 1);
  l += __shfl_xor_sync(kAll, l, 2);
  const bool writer = vrh == 0;  // lanes vl < VG hold the sums
  auto store = [&](int j, const float* x, float den) {
    OutT* o = out + ((size_t)b * K + q0 + j) * hd + (size_t)h * D;
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      store_out(o + quad_dim<F, D>(vl, k, split_rope), den > 0.f ? x[k] / den : 0.f);  // 0: no live row
    }
  };
  if (live == 1) {  // the merge of this one part: acc / l
#pragma unroll
    for (int j = 0; j < NQ; ++j) {
      const float lj = __shfl_sync(kAll, l, 4 * j);
      if (writer && j < nq) store(j, acc[j], lj);
    }
    return;
  }
  const size_t tile = ((size_t)b * H + h) * n_tiles + qt;
  float* parts = ws + tile * n_chunks * NQ * PH;  // the tile's parts, chunk-major
  {
    float* part = parts + (size_t)c * NQ * PH;
    const float mj = __shfl_sync(kAll, m, 4 * (lane % NQ));
    const float lj = __shfl_sync(kAll, l, 4 * (lane % NQ));
#pragma unroll
    for (int j = 0; j < NQ; ++j) {
      if (writer && j < nq) {
        __stcg(reinterpret_cast<float4*>(part + j * PH) + vl,
               make_float4(acc[j][0], acc[j][1], acc[j][2], acc[j][3]));
      }
    }
    if (lane < nq) {
      __stcg(part + lane * PH + D, mj);  // -inf with l = 0 when the query saw no row
      __stcg(part + lane * PH + D + 1, lj);
    }
  }
  if (!split::arrive_warp(counters + tile, live)) return;

  // the last arrival merges the tile's parts in chunk order: the max, then
  // the weights lane-parallel (lane i: chunk base + i, one round of loads),
  // then the sums, each weight and l by shuffle
  float mx[NQ];
#pragma unroll
  for (int j = 0; j < NQ; ++j) mx[j] = -INFINITY;
  for (int cc = lane; cc < live; cc += 32) {
#pragma unroll
    for (int j = 0; j < NQ; ++j) {
      if (j < nq) mx[j] = fmaxf(mx[j], __ldcg(parts + ((size_t)cc * NQ + j) * PH + D));
    }
  }
#pragma unroll
  for (int j = 0; j < NQ; ++j) {
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) mx[j] = fmaxf(mx[j], __shfl_xor_sync(kAll, mx[j], off));
  }
  float den[NQ], num[NQ][4];
#pragma unroll
  for (int j = 0; j < NQ; ++j) {
    den[j] = 0.f;
#pragma unroll
    for (int k = 0; k < 4; ++k) num[j][k] = 0.f;
  }
  for (int base = 0; base < live; base += 32) {
    const int cc = base + lane;
    float w[NQ], wl[NQ];
#pragma unroll
    for (int j = 0; j < NQ; ++j) {
      w[j] = wl[j] = 0.f;
      if (j < nq && cc < live) {
        const float* pp = parts + ((size_t)cc * NQ + j) * PH;
        const float mc = __ldcg(pp + D);
        w[j] = mc == -INFINITY ? 0.f : exp2f(mc - mx[j]);  // 0: a part that saw no row
        wl[j] = w[j] * __ldcg(pp + D + 1);
      }
    }
    const int cnt = min(32, live - base);
#pragma unroll 4
    for (int i = 0; i < cnt; ++i) {
#pragma unroll
      for (int j = 0; j < NQ; ++j) {
        const float wi = __shfl_sync(kAll, w[j], i);
        den[j] += __shfl_sync(kAll, wl[j], i);
        if (writer && j < nq) {
          const float4 a = __ldcg(reinterpret_cast<const float4*>(parts + ((size_t)(base + i) * NQ + j) * PH) + vl);
          num[j][0] = fmaf(wi, a.x, num[j][0]);
          num[j][1] = fmaf(wi, a.y, num[j][1]);
          num[j][2] = fmaf(wi, a.z, num[j][2]);
          num[j][3] = fmaf(wi, a.w, num[j][3]);
        }
      }
    }
  }
#pragma unroll
  for (int j = 0; j < NQ; ++j) {
    if (writer && j < nq) store(j, num[j], den[j]);
  }
}

// The launch plan (ops/flash_chunk.chunk_plan): NQ queries a tile (2, 4 or
// 8), ceil(K / NQ) tiles; n_chunks items a (b, head, tile), enough for every
// live chunk of kChunk rows (for a device pos, the whole cache); ws and
// counters as the kernel takes them.
template <class F, int D, int NQ>
int launch_nq(const void* q, const void* kv, const void* sc, const void* pos_ptr,
              int pos_stride, int pos_scalar, const void* bias, void* out, int out_f32, int B,
              int S, int H, int K, void* ws, void* counters, int n_chunks, int split_rope,
              cudaStream_t stream) {
  using C = Cfg<F, D>;
  const int n_tiles = (K + NQ - 1) / NQ;
  const long items = (long)B * n_chunks * H;
  const dim3 grid(static_cast<unsigned>((items + kWarps - 1) / kWarps), n_tiles);
  const int smem = kWarps * C::WARP_BYTES;
  // scores in log2 units, for exp2: 1 / sqrt(D) times log2(e)
  const float scale = kLog2e / sqrtf(static_cast<float>(D));
  const auto* qp = static_cast<const __nv_bfloat16*>(q);
  const auto* kvp = static_cast<const unsigned char*>(kv);
  const auto* sp = static_cast<const float*>(sc);
  const auto* pp = static_cast<const int*>(pos_ptr);
  const auto* bp = static_cast<const float*>(bias);
  auto* wsp = static_cast<float*>(ws);
  auto* cp = static_cast<int*>(counters);
  if (out_f32) {
    chunk_kernel<F, D, NQ, float><<<grid, kWarps * 32, smem, stream>>>(
        qp, kvp, sp, pp, pos_stride, pos_scalar, bp, static_cast<float*>(out), wsp, cp, B, S, H,
        K, n_chunks, split_rope, scale);
  } else {
    chunk_kernel<F, D, NQ, __nv_bfloat16><<<grid, kWarps * 32, smem, stream>>>(
        qp, kvp, sp, pp, pos_stride, pos_scalar, bp, static_cast<__nv_bfloat16*>(out), wsp, cp,
        B, S, H, K, n_chunks, split_rope, scale);
  }
  return static_cast<int>(cudaGetLastError());
}

template <class F, int D>
int launch_d(const void* q, const void* kv, const void* sc, const void* pos_ptr, int pos_stride,
             int pos_scalar, const void* bias, void* out, int out_f32, int B, int S, int H,
             int K, void* ws, void* counters, int nq, int n_chunks, int split,
             cudaStream_t st) {
  switch (nq) {
    case 2:
      return launch_nq<F, D, 2>(q, kv, sc, pos_ptr, pos_stride, pos_scalar, bias, out, out_f32,
                                B, S, H, K, ws, counters, n_chunks, split, st);
    case 4:
      return launch_nq<F, D, 4>(q, kv, sc, pos_ptr, pos_stride, pos_scalar, bias, out, out_f32,
                                B, S, H, K, ws, counters, n_chunks, split, st);
    case 8:
      return launch_nq<F, D, 8>(q, kv, sc, pos_ptr, pos_stride, pos_scalar, bias, out, out_f32,
                                B, S, H, K, ws, counters, n_chunks, split, st);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

// Checks the plan, then launches. Returns a cudaError_t.
template <class F>
int dispatch(const void* q, const void* kv, const void* sc, const void* pos_ptr, int pos_stride,
             int pos_scalar, const void* bias, void* out, int out_f32, int B, int S, int H,
             int D, int K, void* ws, void* counters, int nq, int n_chunks, int split,
             void* stream) {
  if (B <= 0 || K <= 0) return 0;
  // the grid must hold every live chunk: the whole cache for a device pos
  const int need = pos_ptr ? S : max(0, min(pos_scalar + K, S));
  if (n_chunks < max(1, (need + kChunk - 1) / kChunk) || H < 1 || ws == nullptr ||
      counters == nullptr) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 64:
      return launch_d<F, 64>(q, kv, sc, pos_ptr, pos_stride, pos_scalar, bias, out, out_f32, B,
                             S, H, K, ws, counters, nq, n_chunks, split, st);
    case 100:
      return launch_d<F, 100>(q, kv, sc, pos_ptr, pos_stride, pos_scalar, bias, out, out_f32, B,
                              S, H, K, ws, counters, nq, n_chunks, split, st);
    case 128:
      return launch_d<F, 128>(q, kv, sc, pos_ptr, pos_stride, pos_scalar, bias, out, out_f32, B,
                              S, H, K, ws, counters, nq, n_chunks, split, st);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace chunk
