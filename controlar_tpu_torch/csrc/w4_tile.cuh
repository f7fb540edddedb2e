// One work item of a skinny product x @ W4 on the tensor cores, shared by
// csrc/w4_matmul.cu and csrc/w4_ffn.cu.
//
// W4 layout (controlar_tpu_torch/ops/w4_matmul.py): carriers q4 (Kp/2, N)
// int8, N contiguous; carrier row p*G + i holds row i of plane 2p in its low
// nibble and row i of plane 2p+1 in its high nibble; scales s (Kp/G, N) f32
// per (plane, column). x is (B, nfull*G) bf16: only the first nfull planes
// are read, so a trailing zero-quantized plane (K = 3200 has 25 planes) is
// skipped and x is never read past its own width. A chunk is G carrier rows:
// planes 2p and 2p+1.
//
// An item is rows [m0, m0 + RT) x columns [n0, n0 + TN) over the chunks
// [c0, c1) (a slice of K when the product is split). A block of 4 warps:
//   - out^T = W^T x^T: the weight's columns are the M side of
//     mma.sync.m16n8k16 (bf16 in, fp32 sums) and the rows of x the N side,
//     so 16 rows are two n8 tiles (RT = 8 * WN rows, WN = 2 or 4); warp w
//     owns the 32 columns [n0 + 32w, n0 + 32w + 32), two m16 tiles that
//     share each x fragment;
//   - a ring of kRing stages in shared memory, each KC carrier rows x TN
//     columns and the matching KC values of both planes of x for the RT
//     rows, filled with 16-byte cp.async.cg copies (L2 only: w4_ffn writes
//     its second product's x in the same launch) kRing - 1 stages ahead of
//     the products; each thread's copies are worked out once per item;
//   - ldmatrix.trans of the carrier tile gives each lane, in one 32-bit
//     word, the bytes of columns 2g and 2g+1 at carrier rows 2t and 2t+1:
//     the A fragment's k pairs, with mma row g read as column 2g and row
//     g + 8 as column 2g + 1. The reordering happens in shared memory; the
//     layout in device memory stays the JAX package's;
//   - nibbles become bf16 in registers: (n ^ 8) | 0x4300 read as bf16 is
//     136 + n, minus 136 is n, exact for n in [-8, 7] (one lop3 and one
//     bf16 add a pair); one word gives both planes' fragments (low and high
//     nibbles). At 16 rows these conversions, not the bytes, are most of a
//     stage's instructions;
//   - per chunk an fp32 partial sum per plane, times that plane's f32 scale,
//     added to the item's accumulator, as the plain version does. The order
//     of sums for an output depends on (K, N) and the split only, never on
//     B or on which rows share the tile.
// Row pitches are padded by 16 bytes so that each ldmatrix phase reads 8
// rows from distinct bank groups.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "arrive.cuh"

namespace w4 {

constexpr int G = 128;                 // carrier rows per chunk (rows per plane)
constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int WM = 2;                  // m16 tiles (16 columns each) per warp
constexpr int TN = kWarps * 16 * WM;   // columns per item
constexpr int KC = 64;                 // carrier rows per stage
constexpr int kStagesPerChunk = G / KC;
constexpr int kRing = 3;               // stages in the ring
constexpr int CP = TN + 16;            // carrier row pitch in shared memory (bytes)
constexpr int XP = KC + 8;             // x row pitch in shared memory (bf16 values)

template <int WN>
struct Cfg {
  static constexpr int RT = 8 * WN;                      // rows per item
  static constexpr int F = WM * WN;                      // mma tiles per warp
  static constexpr int kCarrierBytes = KC * CP;
  static constexpr int kStageBytes = kCarrierBytes + 2 * RT * XP * 2;
  static constexpr int kSmemBytes = kRing * kStageBytes;
  static constexpr int kQCopies = KC * TN / 16 / kThreads;       // per thread and stage
  static constexpr int kXCopies = 2 * RT * (KC / 8) / kThreads;  // per thread and stage
  static_assert(kQCopies * kThreads * 16 == KC * TN && kXCopies * kThreads * 8 == 2 * RT * KC,
                "every thread issues the same copies");
};

// An item's fp32 fragments in one lane: tile f = mi * WN + j is m16 tile mi
// of the warp and n8 tile j of the rows.
template <int WN>
using Frags = float[Cfg<WN>::F][4];

// One product x @ W4.
struct Operand {
  const __nv_bfloat16* x;  // (B, nfull * G)
  const int8_t* q;         // (Kp/2, N)
  const float* s;          // (Kp/G, N)
  int B, nfull, N;
};

__device__ __forceinline__ int nchunk(const Operand& op) { return (op.nfull + 1) / 2; }

// chunk range of split `split` of `splits`: balanced, fixed by (K, splits)
__device__ __forceinline__ int split_begin(int nch, int split, int splits) {
  return static_cast<int>((long long)split * nch / splits);
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, bool valid) {
  const int n = valid ? 16 : 0;  // 0: fill the 16 bytes with zeros
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src), "r"(n));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ void ldsm_x4_trans(uint32_t* r, uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}
__device__ __forceinline__ void ldsm_x4(uint32_t* r, uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

__device__ __forceinline__ void mma(float* c, const uint32_t* a, uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// The 4-bit values at bits 0-3 and 16-19 of v as a bf16 pair, exactly.
__device__ __forceinline__ uint32_t nibbles_bf16x2(uint32_t v) {
  uint32_t t;  // (v & 0x000F000F) ^ 0x43084308: bf16 136 + n in each half
  asm("lop3.b32 %0, %1, %2, %3, 0x6a;\n" : "=r"(t) : "r"(v), "r"(0x000F000Fu), "r"(0x43084308u));
  const uint32_t k136 = 0x43084308u;
  __nv_bfloat162 h = __hsub2(*reinterpret_cast<const __nv_bfloat162*>(&t),
                             *reinterpret_cast<const __nv_bfloat162*>(&k136));
  return *reinterpret_cast<uint32_t*>(&h);
}

// The 16-byte copies one thread issues for every stage of an item, worked
// out once per item: sources at the item's first stage (a stage moves the
// carriers KC rows on, and x KC values within a plane or to the next chunk's
// planes) and destinations within a stage. Copies out of range fill zeros.
template <int WN>
struct Copies {
  static constexpr int kQ = Cfg<WN>::kQCopies, kX = Cfg<WN>::kXCopies;
  const int8_t* q[kQ];
  const __nv_bfloat16* x[kX];
  uint32_t q_dst[kQ], x_dst[kX];
  bool q_ok[kQ], x_ok[kX], x_hi[kX];

  __device__ __forceinline__ Copies(const Operand& op, int n0, int m0, int c0) {
    constexpr int RT = Cfg<WN>::RT;
#pragma unroll
    for (int j = 0; j < kQ; ++j) {
      const int i = threadIdx.x + j * kThreads;
      const int r = i / (TN / 16), c = (i % (TN / 16)) * 16;
      q_ok[j] = n0 + c < op.N;  // N is a multiple of 16
      q[j] = op.q + ((size_t)c0 * G + r) * op.N + n0 + c;
      q_dst[j] = r * CP + c;
    }
#pragma unroll
    for (int j = 0; j < kX; ++j) {
      const int i = threadIdx.x + j * kThreads;
      const int e = i % (KC / 8), row = (i / (KC / 8)) % RT, pl = i / (KC / 8 * RT);
      x_ok[j] = m0 + row < op.B;
      x_hi[j] = pl == 1;
      x[j] = op.x + (size_t)(m0 + row) * op.nfull * G + (2 * c0 + pl) * G + 8 * e;
      x_dst[j] = Cfg<WN>::kCarrierBytes + ((pl * RT + row) * XP + 8 * e) * 2;
    }
  }

  // stage t of the item into the ring slot at shared address `stage`
  __device__ __forceinline__ void issue(const Operand& op, int c0, int t, uint32_t stage) const {
    const size_t qo = (size_t)t * KC * op.N;  // the item's carrier rows are contiguous
    const int rel = t / kStagesPerChunk;
    const int xo = rel * 2 * G + (t % kStagesPerChunk) * KC;
    const bool hi_ok = 2 * (c0 + rel) + 1 < op.nfull;
#pragma unroll
    for (int j = 0; j < kQ; ++j) cp_async16(stage + q_dst[j], q_ok[j] ? q[j] + qo : op.q, q_ok[j]);
#pragma unroll
    for (int j = 0; j < kX; ++j) {
      const bool ok = x_ok[j] && (!x_hi[j] || hi_ok);
      cp_async16(stage + x_dst[j], ok ? x[j] + xo : op.x, ok);
    }
  }
};

// Shared-memory offsets of this lane's fragment loads within a stage.
__device__ __forceinline__ uint32_t carrier_lane_offset() {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  // x4 matrices: rows 0-7 and 8-15 of m16 tile 0, then of m16 tile 1
  return (lane & 15) * CP + warp * 16 * WM + (lane >> 4) * 16;
}
template <int WN>
__device__ __forceinline__ uint32_t x_lane_offset() {
  const int lane = threadIdx.x % 32;
  // x4 matrices: rows 0-7 k 0-7, rows 0-7 k 8-15, rows 8-15 k 0-7, rows 8-15 k 8-15
  return Cfg<WN>::kCarrierBytes +
         (((lane & 7) + ((lane >> 4) << 3)) * XP + ((lane >> 3) & 1) * 8) * 2;
}

// The products of one stage: KC / 16 k steps, the low plane and, with HI,
// the high one; WM m16 tiles x WN n8 tiles.
template <int WN, bool HI>
__device__ __forceinline__ void mma_stage(uint32_t cbase, uint32_t xbase, Frags<WN>& plo,
                                          Frags<WN>& phi) {
  constexpr int RT = Cfg<WN>::RT;
#pragma unroll
  for (int kk = 0; kk < KC / 16; ++kk) {
    uint32_t w[4];  // m16 tile mi: w[2mi] carrier rows 2t, 2t+1, w[2mi+1] rows 2t+8, 2t+9
    ldsm_x4_trans(w, cbase + kk * 16 * CP);
    uint32_t a[WM][4];
#pragma unroll
    for (int mi = 0; mi < WM; ++mi) {
      a[mi][0] = nibbles_bf16x2(w[2 * mi]);
      a[mi][1] = nibbles_bf16x2(w[2 * mi] >> 8);
      a[mi][2] = nibbles_bf16x2(w[2 * mi + 1]);
      a[mi][3] = nibbles_bf16x2(w[2 * mi + 1] >> 8);
    }
#pragma unroll
    for (int jj = 0; jj < WN / 2; ++jj) {
      uint32_t b[4];
      ldsm_x4(b, xbase + (jj * 16 * XP + kk * 16) * 2);
#pragma unroll
      for (int mi = 0; mi < WM; ++mi) {
        mma(plo[mi * WN + 2 * jj], a[mi], b[0], b[1]);
        mma(plo[mi * WN + 2 * jj + 1], a[mi], b[2], b[3]);
      }
    }
    if constexpr (HI) {
#pragma unroll
      for (int mi = 0; mi < WM; ++mi) {
        a[mi][0] = nibbles_bf16x2(w[2 * mi] >> 4);
        a[mi][1] = nibbles_bf16x2(w[2 * mi] >> 12);
        a[mi][2] = nibbles_bf16x2(w[2 * mi + 1] >> 4);
        a[mi][3] = nibbles_bf16x2(w[2 * mi + 1] >> 12);
      }
#pragma unroll
      for (int jj = 0; jj < WN / 2; ++jj) {
        uint32_t b[4];
        ldsm_x4(b, xbase + ((RT + jj * 16) * XP + kk * 16) * 2);
#pragma unroll
        for (int mi = 0; mi < WM; ++mi) {
          mma(phi[mi * WN + 2 * jj], a[mi], b[0], b[1]);
          mma(phi[mi * WN + 2 * jj + 1], a[mi], b[2], b[3]);
        }
      }
    }
  }
}

// This lane's elements of an item's fragments: frags[f][e], f = mi * WN + j,
// is row m0 + 8j + 2t + (e & 1) at column n0 + 32 warp + 16 mi + 2g + (e >> 1).
template <int WN>
__device__ __forceinline__ int frag_row(int m0, int f, int e) {
  return m0 + 8 * (f % WN) + 2 * (threadIdx.x % 4) + (e & 1);
}
template <int WN>
__device__ __forceinline__ int frag_col(int n0, int f) {
  return n0 + 16 * WM * (threadIdx.x / 32) + 16 * (f / WN) + 2 * ((threadIdx.x % 32) / 4);
}

// Computes an item into acc. Every thread of the block must call it; smem
// holds Cfg<WN>::kSmemBytes and is free again when it returns.
template <int WN>
__device__ void item(const Operand& op, int n0, int m0, int c0, int c1, uint8_t* smem,
                     Frags<WN>& acc) {
  constexpr int SB = Cfg<WN>::kStageBytes, F = Cfg<WN>::F;
  const int T = (c1 - c0) * kStagesPerChunk;
  const Copies<WN> copies(op, n0, m0, c0);
  const uint32_t ring = smem_u32(smem);
#pragma unroll
  for (int t = 0; t < kRing - 1; ++t) {
    if (t < T) copies.issue(op, c0, t, ring + t * SB);
    cp_async_commit();
  }
  Frags<WN> plo, phi;
#pragma unroll
  for (int f = 0; f < F; ++f) {
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[f][e] = plo[f][e] = phi[f][e] = 0.f;
  }
  const uint32_t coff = carrier_lane_offset(), xoff = x_lane_offset<WN>();
  float2 slo[WM], shi[WM];  // the chunk's scales at this lane's columns 2g, 2g + 1
  for (int t = 0; t < T; ++t) {
    const int chunk = c0 + t / kStagesPerChunk;
    const bool has_hi = 2 * chunk + 1 < op.nfull;
    if (t % kStagesPerChunk == 0) {  // read ahead of the chunk's sums
#pragma unroll
      for (int mi = 0; mi < WM; ++mi) {
        const int col = frag_col<WN>(n0, mi * WN);
        const float* sp = op.s + (size_t)(2 * chunk) * op.N + col;
        const bool ok = col < op.N;
        slo[mi] = ok ? __ldg(reinterpret_cast<const float2*>(sp)) : make_float2(0.f, 0.f);
        shi[mi] = ok && has_hi ? __ldg(reinterpret_cast<const float2*>(sp + op.N))
                               : make_float2(0.f, 0.f);
      }
    }
    cp_async_wait<kRing - 2>();
    __syncthreads();  // stage t has landed, and stage t - 1's readers are done with its slot
    if (t + kRing - 1 < T) {
      copies.issue(op, c0, t + kRing - 1, ring + (t + kRing - 1) % kRing * SB);
    }
    cp_async_commit();
    const uint32_t stage = ring + (t % kRing) * SB;
    if (has_hi) {
      mma_stage<WN, true>(stage + coff, stage + xoff, plo, phi);
    } else {
      mma_stage<WN, false>(stage + coff, stage + xoff, plo, phi);
    }
    if (t % kStagesPerChunk == kStagesPerChunk - 1) {
#pragma unroll
      for (int f = 0; f < F; ++f) {
        const float2 sl = slo[f / WN], sh = shi[f / WN];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          acc[f][e] += plo[f][e] * (e < 2 ? sl.x : sl.y) + phi[f][e] * (e < 2 ? sh.x : sh.y);
          plo[f][e] = phi[f][e] = 0.f;
        }
      }
    }
  }
  cp_async_wait<0>();
  __syncthreads();
}

__device__ __forceinline__ void store2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
__device__ __forceinline__ void store2(__nv_bfloat16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}

// Writes the fragments' rows < B and columns < N of acc into dst (B, N),
// two adjacent columns per store.
template <int WN, typename T>
__device__ __forceinline__ void store(int B, int N, int n0, int m0, const Frags<WN>& acc,
                                      T* dst) {
#pragma unroll
  for (int f = 0; f < Cfg<WN>::F; ++f) {
    const int col = frag_col<WN>(n0, f);
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int row = frag_row<WN>(m0, f, e);
      if (row < B && col < N) store2(dst + (size_t)row * N + col, acc[f][e], acc[f][e + 2]);
    }
  }
}

// Adds the fragments of splits [0, splits) of ws (splits, B, N) f32 into
// acc in split order, 0 first; reads through L2, where the other blocks'
// writes are, kBatch splits' loads in flight at a time.
template <int WN>
__device__ __forceinline__ void add_splits(int B, int N, int n0, int m0, const float* ws,
                                           int splits, Frags<WN>& acc) {
  constexpr int kBatch = 8 / WN, F = Cfg<WN>::F;  // 16 float2 loads in flight
  for (int s0 = 0; s0 < splits; s0 += kBatch) {
    float2 v[kBatch][F][2];
#pragma unroll
    for (int i = 0; i < kBatch; ++i) {
#pragma unroll
      for (int f = 0; f < F; ++f) {
        const int col = frag_col<WN>(n0, f);
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int row = frag_row<WN>(m0, f, e);
          v[i][f][e] = s0 + i < splits && row < B && col < N
                           ? __ldcg(reinterpret_cast<const float2*>(
                                 ws + ((size_t)(s0 + i) * B + row) * N + col))
                           : make_float2(0.f, 0.f);
        }
      }
    }
#pragma unroll
    for (int i = 0; i < kBatch; ++i) {
      if (s0 + i >= splits) break;
#pragma unroll
      for (int f = 0; f < F; ++f) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          acc[f][e] += v[i][f][e].x;
          acc[f][e + 2] += v[i][f][e].y;
        }
      }
    }
  }
}

using split::arrive;

// The split-K reduction of an item: with one split, acc is the result; with
// more, the partial goes to ws[split] and the last arrival of the tile sums
// the partials in split order, 0 first, into acc. Returns whether this
// block holds the tile's result in acc.
template <int WN>
__device__ __forceinline__ bool reduce(int B, int N, int n0, int m0, int split, int splits,
                                       float* ws, int* counter, Frags<WN>& acc) {
  if (splits == 1) return true;
  store<WN>(B, N, n0, m0, acc, ws + (size_t)split * B * N);
  if (!arrive(counter, splits)) return false;
#pragma unroll
  for (int f = 0; f < Cfg<WN>::F; ++f) {
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[f][e] = 0.f;
  }
  add_splits<WN>(B, N, n0, m0, ws, splits, acc);
  return true;
}

}  // namespace w4
