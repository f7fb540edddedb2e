// Causal flash attention for training, forward and backward: three kernels
// over q, k, v of shape (B, T, H, D) bf16 with an optional additive per-key
// column bias (B, T) f32 (0 or -1e9: left-padded caption columns).
//
// Replaces the Pallas kernels of controlar_tpu/ops/flash_train_pallas.py
// (flash_attention_train_pallas):
//   flash_train_fwd  <- _fwd_kernel  (out and lse = m + log l)
//   flash_train_dq   <- _dq_kernel   (dq = sum_j ds_j k_j)
//   flash_train_dkv  <- _dkv_kernel  (dk = sum_i ds_i q_i, dv = sum_i p_i do_i)
// and computes their function: s = q.k / sqrt(D), then s + bias on the
// columns a query may see (key <= query) and a finite -1e9 elsewhere, with
// no diagonal exception, so a fully masked row (a left-padded caption row)
// stays finite; its output reaches no kept logit and its cotangent is zero.
// The running max starts at -1e9, as in the TPU kernel. q, k and v are read
// as bf16; scores, the softmax statistics and every accumulator are fp32;
// p is rounded to bf16 before the p.v and p^T.do products, ds before the
// ds.k and ds^T.q products, as the TPU kernel rounds them for its MXU.
//
// Bound: operations. The forward does 4 B H T^2 D / 2 flops (causal): 27
// GFLOP a layer at the GPT-XL t2i 512 px training step (B 8, T 1143, H 20,
// D 64), 0.027 ms at the H100's 989 TFLOP/s of dense bf16, against 94 MB of
// q, k, v and out (0.028 ms at 3.35 TB/s): the two are close, and the
// backward's 2.5x the flops over about twice the bytes tips it to
// operations. Every product runs on the tensor cores and the score tile
// stays out of device memory:
//   - mma.sync m16n8k16 bf16 products with fp32 accumulation; a warp owns
//     16 rows (queries in fwd/dq, keys in dkv), four warps a block;
//   - the other operand streams through shared memory in tiles of 64 keys
//     (fwd, dq) or 64 queries (dkv), rows padded by 8 elements so that the
//     fragment loads of 8 rows hit 32 distinct banks; the score tile never
//     leaves the registers: the accumulator fragment of s is the A fragment
//     of p;
//   - tiles past the causal diagonal are skipped: the forward and dq stop at
//     the query tile's last key, dkv starts at the key tile's first query;
//   - no atomics: dq and dk/dv are separate kernels, each writing its own
//     rows once, so the backward is deterministic.
// The forward is the first, simple design: synchronous 8-byte loads into
// shared memory between two barriers a tile, fragments by 32- and 16-bit
// shared loads. The backward kernels (dq, dk/dv) took 0.377 and 0.447 ms in
// that design at the XL layer, 11-12% of their bound and 1.2x SDPA's
// backward; they now
//   - stream their tiles with cp.async into a ring of 3 stages at D <= 64
//     (2 above, for shared memory), one barrier a tile, the next tiles'
//     copies in flight under the current tile's products: K, V and the bias
//     row in dq; Q, dO, lse and delta in dk/dv. Rows past T and the columns
//     that pad D = 100 to 112 are zero-filled by the copy (src-size 0); a
//     query past T takes lse = +inf, so its p is 0 without a test;
//   - load every fragment with ldmatrix (x4: one instruction a 16 x 16 A
//     fragment or two 16 x 8 B fragments), .trans for the k-major operands
//     (K in ds.K, dO in p^T.dO, Q in ds^T.Q), which the first design
//     gathered with four 16-bit loads a register;
//   - apply the causal mask only on the diagonal tile; the bias comes from
//     the staged row (dq) or registers (dk/dv);
//   - take 64 queries a tile in dk/dv (half the barriers and reloads of the
//     first design's 32), computed in slices of 32 above D = 64 for
//     registers;
//   - issue the heaviest blocks first: blockIdx.y counts dq's query tiles
//     from the last (the most key tiles) and dk/dv's key tiles from the
//     first (the most query tiles), over all (b, head) before the next.
// wgmma and TMA are later work.
//
// D: any multiple of 4 up to 128 (64 for GPT-B/L/XL, 100 for GPT-3B),
// padded in shared memory to 64, 112 or 128 with zeros; T need not be a
// multiple of the tile (the ragged edge is masked and zero-filled).
//
// Plain C interface, loaded with ctypes. Launches go on the caller's
// stream; each entry returns cudaGetLastError() after its launch.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

typedef __nv_bfloat16 bf16;

constexpr float kNeg = -1e9f;
constexpr int kThreads = 128;  // four warps
constexpr int kRows = 64;      // rows a block owns (16 a warp)
constexpr int kKeyTile = 64;   // keys per shared tile (fwd, dq)
constexpr int kQueryTile = 64; // queries per shared tile (dkv)
static_assert(kRows == kKeyTile && kRows == kQueryTile, "tiles align with the diagonal");

// stages of the backward kernels' cp.async ring, by padded head dimension
template <int DP>
constexpr int kStages = DP <= 64 ? 3 : 2;

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ uint32_t pack_raw(bf16 lo, bf16 hi) {
  return (uint32_t)__bfloat16_as_ushort(lo) | ((uint32_t)__bfloat16_as_ushort(hi) << 16);
}

__device__ __forceinline__ void mma(float* c, const uint32_t* a, uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// A fragment (16 x 16) of a row-major shared tile M[row][col], rows r0..,
// cols c0..; g = lane / 4, t = lane % 4.
__device__ __forceinline__ void frag_a(const bf16* M, int ld, int r0, int c0, int g, int t,
                                       uint32_t* a) {
  const bf16* p = M + (r0 + g) * ld + c0 + 2 * t;
  a[0] = *reinterpret_cast<const uint32_t*>(p);
  a[1] = *reinterpret_cast<const uint32_t*>(p + 8 * ld);
  a[2] = *reinterpret_cast<const uint32_t*>(p + 8);
  a[3] = *reinterpret_cast<const uint32_t*>(p + 8 * ld + 8);
}

// B fragment (16 x 8, k x n) of a tile stored n-major, M[n][k] (k, q or v
// rows against the head dimension): two 32-bit loads.
__device__ __forceinline__ void frag_b_nk(const bf16* M, int ld, int n0, int k0, int g, int t,
                                          uint32_t& b0, uint32_t& b1) {
  const bf16* p = M + (n0 + g) * ld + k0 + 2 * t;
  b0 = *reinterpret_cast<const uint32_t*>(p);
  b1 = *reinterpret_cast<const uint32_t*>(p + 8);
}

// B fragment (16 x 8, k x n) of a tile stored k-major, M[k][n]: gathered
// from two rows per register.
__device__ __forceinline__ void frag_b_kn(const bf16* M, int ld, int k0, int n0, int g, int t,
                                          uint32_t& b0, uint32_t& b1) {
  const bf16* p = M + (k0 + 2 * t) * ld + n0 + g;
  b0 = pack_raw(p[0], p[ld]);
  b1 = pack_raw(p[8 * ld], p[9 * ld]);
}

// A fragments of a 16 x 16 slice of a 16 x N accumulator (columns of the
// n-tiles 2 ks and 2 ks + 1), rounded to bf16.
__device__ __forceinline__ void acc_to_a(float (*s)[4], int ks, uint32_t* a) {
  a[0] = pack_bf16(s[2 * ks][0], s[2 * ks][1]);
  a[1] = pack_bf16(s[2 * ks][2], s[2 * ks][3]);
  a[2] = pack_bf16(s[2 * ks + 1][0], s[2 * ks + 1][1]);
  a[3] = pack_bf16(s[2 * ks + 1][2], s[2 * ks + 1][3]);
}

// Copy `rows` rows (r0..) of one head of a (B, T, H, D) tensor into a
// shared tile [rows][LD]; rows past T and columns past D are zero.
template <int DP>
__device__ __forceinline__ void load_tile(bf16* sm, const bf16* __restrict__ src, int rows,
                                          int r0, int T, int HD, int D) {
  constexpr int LD = DP + 8;
  constexpr int CH = DP / 4;  // 8-byte chunks a row
  for (int i = threadIdx.x; i < rows * CH; i += kThreads) {
    const int r = i / CH, c = (i % CH) * 4;
    uint2 val = make_uint2(0u, 0u);
    if (r0 + r < T && c < D) {
      val = *reinterpret_cast<const uint2*>(src + (size_t)(r0 + r) * HD + c);
    }
    *reinterpret_cast<uint2*>(sm + r * LD + c) = val;
  }
}

__device__ __forceinline__ void store2(float* p, float x, float y) {
  *reinterpret_cast<float2*>(p) = make_float2(x, y);
}
__device__ __forceinline__ void store2(bf16* p, float x, float y) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(x, y);
}

// Store a warp's 16 x DP accumulator (rows r0.. of one head) scaled per row.
template <int DP, typename OutT>
__device__ __forceinline__ void store_rows(OutT* __restrict__ dst, float (*acc)[4],
                                           int r0, int g, int t, float s0, float s1,
                                           int T, int HD, int D) {
#pragma unroll
  for (int dn = 0; dn < DP / 8; ++dn) {
    const int c = dn * 8 + 2 * t;
    if (c >= D) continue;
    if (r0 + g < T) store2(dst + (size_t)(r0 + g) * HD + c, acc[dn][0] * s0, acc[dn][1] * s0);
    if (r0 + g + 8 < T) {
      store2(dst + (size_t)(r0 + g + 8) * HD + c, acc[dn][2] * s1, acc[dn][3] * s1);
    }
  }
}

// The scores of a warp's 16 rows against the 64 keys of a shared tile:
// s[nt][e] for key column nt * 8 + 2 t + (e & 1), row g + 8 * (e >> 1).
template <int DP>
__device__ __forceinline__ void scores_rows(const bf16* Qs, const bf16* Ks, int wrow, int g,
                                            int t, float (*s)[4]) {
  constexpr int LD = DP + 8;
#pragma unroll
  for (int nt = 0; nt < kKeyTile / 8; ++nt) {
    s[nt][0] = s[nt][1] = s[nt][2] = s[nt][3] = 0.f;
  }
#pragma unroll
  for (int kk = 0; kk < DP / 16; ++kk) {
    uint32_t a[4];
    frag_a(Qs, LD, wrow, kk * 16, g, t, a);
#pragma unroll
    for (int nt = 0; nt < kKeyTile / 8; ++nt) {
      uint32_t b0, b1;
      frag_b_nk(Ks, LD, nt * 8, kk * 16, g, t, b0, b1);
      mma(s[nt], a, b0, b1);
    }
  }
}

// The masked, scaled score of query `row` against key `col`.
__device__ __forceinline__ float masked(float s, int row, int col, int T, float scale,
                                        const float* __restrict__ brow) {
  if (col > row || col >= T) return kNeg;
  return s * scale + (brow ? brow[col] : 0.f);
}

// ---- the backward kernels' copies and fragments ----

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// cp.async of BYTES (16, 8 or 4); src_bytes 0 zero-fills the destination
template <int BYTES>
__device__ __forceinline__ void cp_async_zfill(void* dst, const void* src, int src_bytes) {
  if constexpr (BYTES == 16) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_u32(dst)),
                 "l"(src), "r"(src_bytes)
                 : "memory");
  } else {
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;\n" ::"r"(smem_u32(dst)),
                 "l"(src), "n"(BYTES), "r"(src_bytes)
                 : "memory");
  }
}

__device__ __forceinline__ void cp_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }

template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Copy rows [r0, r0 + kRows) of one head of a (B, T, H, D) tensor into the
// shared tile [kRows][DP + 8]; rows past T and columns past D are zero.
// 16-byte copies where D % 8 == 0, else 8-byte ones (D = 100: a head starts
// at a multiple of 200 bytes).
template <int DP>
__device__ __forceinline__ void copy_tile(bf16* sm, const bf16* __restrict__ src, int r0, int T,
                                          int HD, int D) {
  constexpr int LD = DP + 8;
  if (D % 8 == 0) {
    constexpr int CH = DP / 8;
    for (int i = threadIdx.x; i < kRows * CH; i += kThreads) {
      const int r = i / CH, c = (i % CH) * 8;
      const bool ok = r0 + r < T && c < D;
      cp_async_zfill<16>(sm + r * LD + c, ok ? src + (size_t)(r0 + r) * HD + c : src, ok ? 16 : 0);
    }
  } else {
    constexpr int CH = DP / 4;
    for (int i = threadIdx.x; i < kRows * CH; i += kThreads) {
      const int r = i / CH, c = (i % CH) * 4;
      const bool ok = r0 + r < T && c < D;
      cp_async_zfill<8>(sm + r * LD + c, ok ? src + (size_t)(r0 + r) * HD + c : src, ok ? 8 : 0);
    }
  }
}

__device__ __forceinline__ void ldsm_x4(uint32_t* r, const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}

__device__ __forceinline__ void ldsm_x4_t(uint32_t* r, const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}

// ldmatrix x4 row addresses: lane l supplies row l % 8 of matrix l / 8.
// A fragment (16 x 16) of a row-major tile M[row][col] at (r0, c0):
// matrices (rows +0, cols +0), (+8, +0), (+0, +8), (+8, +8) = a[0..3].
__device__ __forceinline__ const bf16* a_rows(const bf16* M, int ld, int r0, int c0, int lane) {
  const int i = lane >> 3;
  return M + (r0 + (lane & 7) + 8 * (i & 1)) * ld + c0 + 8 * (i >> 1);
}

// B fragments (16 x 8, k x n) of the n-tiles n0 and n0 + 8 from a tile
// stored n-major, M[n][k] (ldmatrix): b[0], b[1] of n0, b[2], b[3] of n0 + 8.
__device__ __forceinline__ const bf16* b_rows_nk(const bf16* M, int ld, int n0, int k0, int lane) {
  const int i = lane >> 3;
  return M + (n0 + (lane & 7) + 8 * (i >> 1)) * ld + k0 + 8 * (i & 1);
}

// The same from a tile stored k-major, M[k][n] (ldmatrix.trans).
__device__ __forceinline__ const bf16* b_rows_kn(const bf16* M, int ld, int k0, int n0, int lane) {
  const int i = lane >> 3;
  return M + (k0 + (lane & 7) + 8 * (i & 1)) * ld + n0 + 8 * (i >> 1);
}

// acc[NT][4] (16 rows x 8 NT columns) += A (16 x 16 DK, by ldmatrix from
// the row-major tile A at row r0) . B, B's n-tiles from the n-major tile Bm
// (rows n0.., columns k): scores of 16 rows against NT * 8 rows of Bm.
template <int DK, int NT>
__device__ __forceinline__ void mma_rows_nk(float (*acc)[4], const bf16* A, int r0,
                                            const bf16* Bm, int n0, int ld, int lane) {
#pragma unroll
  for (int kk = 0; kk < DK / 16; ++kk) {
    uint32_t a[4];
    ldsm_x4(a, a_rows(A, ld, r0, kk * 16, lane));
#pragma unroll
    for (int np = 0; np < NT / 2; ++np) {
      uint32_t b[4];
      ldsm_x4(b, b_rows_nk(Bm, ld, n0 + np * 16, kk * 16, lane));
      mma(acc[2 * np], a, b[0], b[1]);
      mma(acc[2 * np + 1], a, b[2], b[3]);
    }
  }
}

// acc[DP / 8][4] (16 rows x DP) += P . Bm[k0 : k0 + 16 KS][:], P the bf16
// rounding of the accumulator p[2 KS][4] (16 rows x 16 KS columns), Bm
// k-major (ldmatrix.trans).
template <int DP, int KS>
__device__ __forceinline__ void mma_acc_kn(float (*acc)[4], float (*p)[4], const bf16* Bm,
                                           int k0, int ld, int lane) {
#pragma unroll
  for (int ks = 0; ks < KS; ++ks) {
    uint32_t a[4];
    acc_to_a(p, ks, a);
#pragma unroll
    for (int dn = 0; dn < DP / 16; ++dn) {
      uint32_t b[4];
      ldsm_x4_t(b, b_rows_kn(Bm, ld, k0 + ks * 16, dn * 16, lane));
      mma(acc[2 * dn], a, b[0], b[1]);
      mma(acc[2 * dn + 1], a, b[2], b[3]);
    }
  }
}

template <int DP, typename OutT>
__global__ void __launch_bounds__(kThreads)
flash_train_fwd_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                       const bf16* __restrict__ v, const float* __restrict__ kbias,
                       OutT* __restrict__ out, float* __restrict__ lse, int T, int H, int D,
                       float scale) {
  constexpr int LD = DP + 8;
  constexpr int NT = kKeyTile / 8;
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* Qs = reinterpret_cast<bf16*>(smem);
  bf16* Ks = Qs + kRows * LD;
  bf16* Vs = Ks + kKeyTile * LD;

  const int q0 = blockIdx.x * kRows, h = blockIdx.y, b = blockIdx.z;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, g = lane / 4, t = lane % 4;
  const int HD = H * D;
  const size_t base = (size_t)b * T * HD + (size_t)h * D;
  const float* brow = kbias ? kbias + (size_t)b * T : nullptr;
  const int wrow = warp * 16;
  const int r0 = q0 + wrow + g, r1 = r0 + 8;

  load_tile<DP>(Qs, q + base, kRows, q0, T, HD, D);

  float o[DP / 8][4];
#pragma unroll
  for (int dn = 0; dn < DP / 8; ++dn) o[dn][0] = o[dn][1] = o[dn][2] = o[dn][3] = 0.f;
  float m0 = kNeg, m1 = kNeg, l0 = 0.f, l1 = 0.f;

  const int nk = (T + kKeyTile - 1) / kKeyTile;
  const int hi = min((q0 + kRows + kKeyTile - 1) / kKeyTile, nk);
  for (int j = 0; j < hi; ++j) {
    const int k0 = j * kKeyTile;
    __syncthreads();
    load_tile<DP>(Ks, k + base, kKeyTile, k0, T, HD, D);
    load_tile<DP>(Vs, v + base, kKeyTile, k0, T, HD, D);
    __syncthreads();

    float s[NT][4];
    scores_rows<DP>(Qs, Ks, wrow, g, t, s);
    float mx0 = m0, mx1 = m1;
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      const int c = k0 + nt * 8 + 2 * t;
      s[nt][0] = masked(s[nt][0], r0, c, T, scale, brow);
      s[nt][1] = masked(s[nt][1], r0, c + 1, T, scale, brow);
      s[nt][2] = masked(s[nt][2], r1, c, T, scale, brow);
      s[nt][3] = masked(s[nt][3], r1, c + 1, T, scale, brow);
      mx0 = fmaxf(mx0, fmaxf(s[nt][0], s[nt][1]));
      mx1 = fmaxf(mx1, fmaxf(s[nt][2], s[nt][3]));
    }
    // the four lanes of a quad hold one row's columns
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 1));
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 2));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 1));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 2));
    const float a0 = expf(m0 - mx0), a1 = expf(m1 - mx1);
    m0 = mx0;
    m1 = mx1;
    float sum0 = 0.f, sum1 = 0.f;
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      s[nt][0] = expf(s[nt][0] - m0);
      s[nt][1] = expf(s[nt][1] - m0);
      s[nt][2] = expf(s[nt][2] - m1);
      s[nt][3] = expf(s[nt][3] - m1);
      sum0 += s[nt][0] + s[nt][1];
      sum1 += s[nt][2] + s[nt][3];
    }
    // per-lane partial sums; every lane of a quad rescales by the same alpha
    l0 = l0 * a0 + sum0;
    l1 = l1 * a1 + sum1;
#pragma unroll
    for (int dn = 0; dn < DP / 8; ++dn) {
      o[dn][0] *= a0;
      o[dn][1] *= a0;
      o[dn][2] *= a1;
      o[dn][3] *= a1;
    }
#pragma unroll
    for (int ks = 0; ks < kKeyTile / 16; ++ks) {
      uint32_t a[4];
      acc_to_a(s, ks, a);
#pragma unroll
      for (int dn = 0; dn < DP / 8; ++dn) {
        uint32_t b0, b1;
        frag_b_kn(Vs, LD, ks * 16, dn * 8, g, t, b0, b1);
        mma(o[dn], a, b0, b1);
      }
    }
  }
  l0 += __shfl_xor_sync(0xffffffffu, l0, 1);
  l0 += __shfl_xor_sync(0xffffffffu, l0, 2);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 1);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 2);
  store_rows<DP>(out + base, o, q0 + wrow, g, t, 1.f / l0, 1.f / l1, T, HD, D);
  if (t == 0) {
    float* lrow = lse + ((size_t)b * H + h) * T;
    if (r0 < T) lrow[r0] = m0 + logf(l0);
    if (r1 < T) lrow[r1] = m1 + logf(l1);
  }
}

// Shared memory of the dq kernel: Q and dO tiles, then kStages stages of
// the K tile, the V tile and the bias row.
template <int DP>
constexpr size_t dq_smem() {
  return (size_t)2 * kRows * (DP + 8) * sizeof(bf16)
         + (size_t)kStages<DP> * (2 * kKeyTile * (DP + 8) * sizeof(bf16) + kKeyTile * sizeof(float));
}

template <int DP, typename OutT>
__global__ void __launch_bounds__(kThreads)
flash_train_dq_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                      const bf16* __restrict__ v, const float* __restrict__ kbias,
                      const bf16* __restrict__ dout, const float* __restrict__ lse,
                      const float* __restrict__ delta, OutT* __restrict__ dq, int T, int H,
                      int D, float scale) {
  constexpr int LD = DP + 8;
  constexpr int NT = kKeyTile / 8;
  constexpr int NS = kStages<DP>;
  constexpr int TILE = kKeyTile * LD;
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* Qs = reinterpret_cast<bf16*>(smem);
  bf16* Os = Qs + kRows * LD;  // dout
  bf16* KVs = Os + kRows * LD;  // NS x (K tile, V tile)
  float* Bs = reinterpret_cast<float*>(KVs + NS * 2 * TILE);  // NS x bias row

  // heaviest first: the last query tile (the most key tiles) of every (b, head)
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kRows;
  const int h = blockIdx.x % H, b = blockIdx.x / H;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, g = lane / 4, t = lane % 4;
  const int HD = H * D;
  const size_t base = (size_t)b * T * HD + (size_t)h * D;
  const float* brow = kbias ? kbias + (size_t)b * T : nullptr;
  const int wrow = warp * 16;
  const int r0 = q0 + wrow + g, r1 = r0 + 8;
  const int n_tiles = q0 / kKeyTile + 1;  // key tiles up to the diagonal one

  // stage j: key tile j's K and V rows and bias row, one commit group
  auto issue = [&](int j) {
    const int k0 = j * kKeyTile;
    bf16* Ks = KVs + (j % NS) * 2 * TILE;
    copy_tile<DP>(Ks, k + base, k0, T, HD, D);
    copy_tile<DP>(Ks + TILE, v + base, k0, T, HD, D);
    if (brow && threadIdx.x < kKeyTile) {
      const int c = k0 + threadIdx.x;
      cp_async_zfill<4>(Bs + (j % NS) * kKeyTile + threadIdx.x, c < T ? brow + c : brow,
                        c < T ? 4 : 0);
    }
    cp_commit();
  };
  copy_tile<DP>(Qs, q + base, q0, T, HD, D);  // with stage 0's group
  copy_tile<DP>(Os, dout + base, q0, T, HD, D);
#pragma unroll
  for (int j = 0; j < NS - 1; ++j) {
    if (j < n_tiles) {
      issue(j);
    } else {
      cp_commit();
    }
  }
  const float* lrow = lse + ((size_t)b * H + h) * T;
  const float* drow = delta + ((size_t)b * H + h) * T;
  const float lse0 = r0 < T ? lrow[r0] : 0.f, lse1 = r1 < T ? lrow[r1] : 0.f;
  const float dl0 = r0 < T ? drow[r0] : 0.f, dl1 = r1 < T ? drow[r1] : 0.f;

  float acc[DP / 8][4];
#pragma unroll
  for (int dn = 0; dn < DP / 8; ++dn) acc[dn][0] = acc[dn][1] = acc[dn][2] = acc[dn][3] = 0.f;

  for (int j = 0; j < n_tiles; ++j) {
    cp_wait<NS - 2>();  // stage j has landed in this thread's copies
    __syncthreads();    // in every thread's; and every warp is done with stage j - 1
    if (j + NS - 1 < n_tiles) {
      issue(j + NS - 1);
    } else {
      cp_commit();
    }
    const bf16* Ks = KVs + (j % NS) * 2 * TILE;
    const bf16* Vs = Ks + TILE;
    const float* bs = Bs + (j % NS) * kKeyTile;
    const int k0 = j * kKeyTile;

    float s[NT][4], dp[NT][4];
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      s[nt][0] = s[nt][1] = s[nt][2] = s[nt][3] = 0.f;
      dp[nt][0] = dp[nt][1] = dp[nt][2] = dp[nt][3] = 0.f;
    }
    mma_rows_nk<DP, NT>(s, Qs, wrow, Ks, 0, LD, lane);
    mma_rows_nk<DP, NT>(dp, Os, wrow, Vs, 0, LD, lane);  // dO . v^T
    const bool diag = j == n_tiles - 1;  // the only tile with keys past a row (or past T)
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      const int cl = nt * 8 + 2 * t;
      const float2 bb = brow ? *reinterpret_cast<const float2*>(bs + cl) : make_float2(0.f, 0.f);
      float x[4] = {fmaf(s[nt][0], scale, bb.x), fmaf(s[nt][1], scale, bb.y),
                    fmaf(s[nt][2], scale, bb.x), fmaf(s[nt][3], scale, bb.y)};
      if (diag) {
        const int c = k0 + cl;
        if (c > r0) x[0] = kNeg;
        if (c + 1 > r0) x[1] = kNeg;
        if (c > r1) x[2] = kNeg;
        if (c + 1 > r1) x[3] = kNeg;
      }
      s[nt][0] = __expf(x[0] - lse0) * (dp[nt][0] - dl0) * scale;
      s[nt][1] = __expf(x[1] - lse0) * (dp[nt][1] - dl0) * scale;
      s[nt][2] = __expf(x[2] - lse1) * (dp[nt][2] - dl1) * scale;
      s[nt][3] = __expf(x[3] - lse1) * (dp[nt][3] - dl1) * scale;
    }
    mma_acc_kn<DP, kKeyTile / 16>(acc, s, Ks, 0, LD, lane);  // ds . K
  }
  store_rows<DP>(dq + base, acc, q0 + wrow, g, t, 1.f, 1.f, T, HD, D);
}

// Shared memory of the dk/dv kernel: K and V tiles, then kStages stages of
// the Q tile, the dO tile, lse and delta.
template <int DP>
constexpr size_t dkv_smem() {
  return (size_t)2 * kRows * (DP + 8) * sizeof(bf16)
         + (size_t)kStages<DP> * (2 * kQueryTile * (DP + 8) * sizeof(bf16)
                                   + 2 * kQueryTile * sizeof(float));
}

// three blocks a SM at D <= 64, as the shared memory allows (168 registers)
template <int DP, typename OutT>
__global__ void __launch_bounds__(kThreads, DP <= 64 ? 3 : 1)
flash_train_dkv_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                       const bf16* __restrict__ v, const float* __restrict__ kbias,
                       const bf16* __restrict__ dout, const float* __restrict__ lse,
                       const float* __restrict__ delta, OutT* __restrict__ dk,
                       OutT* __restrict__ dv, int T, int H, int D, float scale) {
  constexpr int LD = DP + 8;
  constexpr int NS = kStages<DP>;
  constexpr int TILE = kQueryTile * LD;
  constexpr int QS = DP <= 64 ? kQueryTile : kQueryTile / 2;  // queries a slice (registers)
  constexpr int NT = QS / 8;
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* Ks = reinterpret_cast<bf16*>(smem);
  bf16* Vs = Ks + kRows * LD;
  bf16* QOs = Vs + kRows * LD;  // NS x (Q tile, dO tile)
  float* LDs = reinterpret_cast<float*>(QOs + NS * 2 * TILE);  // NS x (lse, delta)

  // heaviest first: the first key tile (the most query tiles) of every (b, head)
  const int k0 = blockIdx.y * kRows;
  const int h = blockIdx.x % H, b = blockIdx.x / H;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, g = lane / 4, t = lane % 4;
  const int HD = H * D;
  const size_t base = (size_t)b * T * HD + (size_t)h * D;
  const int wrow = warp * 16;
  const int r0 = k0 + wrow + g, r1 = r0 + 8;  // this lane's two key rows
  const float* brow = kbias ? kbias + (size_t)b * T : nullptr;
  const float* lrow = lse + ((size_t)b * H + h) * T;
  const float* drow = delta + ((size_t)b * H + h) * T;
  const int i0 = k0 / kQueryTile;  // the diagonal query tile
  const int n_tiles = (T + kQueryTile - 1) / kQueryTile - i0;

  // stage it: query tile i0 + it's Q and dO rows, lse and delta, one
  // commit group; a query past T takes lse = +inf (p = 0) and delta 0
  auto issue = [&](int it) {
    const int c0 = (i0 + it) * kQueryTile;
    bf16* Qs = QOs + (it % NS) * 2 * TILE;
    copy_tile<DP>(Qs, q + base, c0, T, HD, D);
    copy_tile<DP>(Qs + TILE, dout + base, c0, T, HD, D);
    float* ls = LDs + (it % NS) * 2 * kQueryTile;
    const int i = threadIdx.x % kQueryTile, c = c0 + i;
    const bool is_lse = threadIdx.x < kQueryTile;
    if (c < T) {
      cp_async_zfill<4>(ls + threadIdx.x, (is_lse ? lrow : drow) + c, 4);
    } else {
      ls[threadIdx.x] = is_lse ? INFINITY : 0.f;
    }
    cp_commit();
  };
  copy_tile<DP>(Ks, k + base, k0, T, HD, D);  // with stage 0's group
  copy_tile<DP>(Vs, v + base, k0, T, HD, D);
#pragma unroll
  for (int it = 0; it < NS - 1; ++it) {
    if (it < n_tiles) {
      issue(it);
    } else {
      cp_commit();
    }
  }
  const float bias0 = (brow && r0 < T) ? brow[r0] : 0.f;
  const float bias1 = (brow && r1 < T) ? brow[r1] : 0.f;

  float dka[DP / 8][4], dva[DP / 8][4];
#pragma unroll
  for (int dn = 0; dn < DP / 8; ++dn) {
    dka[dn][0] = dka[dn][1] = dka[dn][2] = dka[dn][3] = 0.f;
    dva[dn][0] = dva[dn][1] = dva[dn][2] = dva[dn][3] = 0.f;
  }

  for (int it = 0; it < n_tiles; ++it) {
    cp_wait<NS - 2>();
    __syncthreads();
    if (it + NS - 1 < n_tiles) {
      issue(it + NS - 1);
    } else {
      cp_commit();
    }
    const bf16* Qs = QOs + (it % NS) * 2 * TILE;
    const bf16* Os = Qs + TILE;
    const float* Ls = LDs + (it % NS) * 2 * kQueryTile;
    const float* Dl = Ls + kQueryTile;
    const int c0 = (i0 + it) * kQueryTile;
#pragma unroll 1  // unrolled, the two slices above D = 64 spill
    for (int q_lo = 0; q_lo < kQueryTile; q_lo += QS) {
      // transposed scores: rows are this warp's 16 keys, columns the slice's queries
      float s[NT][4], dp[NT][4];
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        s[nt][0] = s[nt][1] = s[nt][2] = s[nt][3] = 0.f;
        dp[nt][0] = dp[nt][1] = dp[nt][2] = dp[nt][3] = 0.f;
      }
      mma_rows_nk<DP, NT>(s, Ks, wrow, Qs, q_lo, LD, lane);
      mma_rows_nk<DP, NT>(dp, Vs, wrow, Os, q_lo, LD, lane);  // v . dO^T
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int cl = q_lo + nt * 8 + 2 * t + (e & 1);  // query within the tile
          const int r = e < 2 ? r0 : r1;
          float x = fmaf(s[nt][e], scale, e < 2 ? bias0 : bias1);
          if (it == 0 && c0 + cl < r) x = kNeg;  // the diagonal tile
          const float p = __expf(x - Ls[cl]);
          s[nt][e] = p;
          dp[nt][e] = p * (dp[nt][e] - Dl[cl]) * scale;
        }
      }
      mma_acc_kn<DP, QS / 16>(dva, s, Os, q_lo, LD, lane);   // p^T . dO
      mma_acc_kn<DP, QS / 16>(dka, dp, Qs, q_lo, LD, lane);  // ds^T . q
    }
  }
  store_rows<DP>(dk + base, dka, k0 + wrow, g, t, 1.f, 1.f, T, HD, D);
  store_rows<DP>(dv + base, dva, k0 + wrow, g, t, 1.f, 1.f, T, HD, D);
}

template <typename K>
cudaError_t prepare(K kernel, size_t smem) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

template <int DP, typename OutT>
cudaError_t fwd(const void* q, const void* k, const void* v, const float* kbias, void* out,
                float* lse, int B, int T, int H, int D, cudaStream_t stream) {
  const size_t smem = (size_t)(2 * kRows + kKeyTile) * (DP + 8) * sizeof(bf16);
  auto kern = flash_train_fwd_kernel<DP, OutT>;
  cudaError_t err = prepare(kern, smem);
  if (err != cudaSuccess) return err;
  dim3 grid((T + kRows - 1) / kRows, H, B);
  kern<<<grid, kThreads, smem, stream>>>(
      (const bf16*)q, (const bf16*)k, (const bf16*)v, kbias, (OutT*)out, lse, T, H, D,
      1.f / sqrtf((float)D));
  return cudaGetLastError();
}

template <int DP, typename OutT>
cudaError_t dq(const void* q, const void* k, const void* v, const float* kbias,
               const void* dout, const float* lse, const float* delta, void* dqp, int B, int T,
               int H, int D, cudaStream_t stream) {
  const size_t smem = dq_smem<DP>();
  auto kern = flash_train_dq_kernel<DP, OutT>;
  cudaError_t err = prepare(kern, smem);
  if (err != cudaSuccess) return err;
  dim3 grid(B * H, (T + kRows - 1) / kRows);  // blockIdx.y: query tiles, heaviest first
  kern<<<grid, kThreads, smem, stream>>>(
      (const bf16*)q, (const bf16*)k, (const bf16*)v, kbias, (const bf16*)dout, lse, delta,
      (OutT*)dqp, T, H, D, 1.f / sqrtf((float)D));
  return cudaGetLastError();
}

template <int DP, typename OutT>
cudaError_t dkv(const void* q, const void* k, const void* v, const float* kbias,
                const void* dout, const float* lse, const float* delta, void* dkp, void* dvp,
                int B, int T, int H, int D, cudaStream_t stream) {
  const size_t smem = dkv_smem<DP>();
  auto kern = flash_train_dkv_kernel<DP, OutT>;
  cudaError_t err = prepare(kern, smem);
  if (err != cudaSuccess) return err;
  dim3 grid(B * H, (T + kRows - 1) / kRows);  // blockIdx.y: key tiles, heaviest first
  kern<<<grid, kThreads, smem, stream>>>(
      (const bf16*)q, (const bf16*)k, (const bf16*)v, kbias, (const bf16*)dout, lse, delta,
      (OutT*)dkp, (OutT*)dvp, T, H, D, 1.f / sqrtf((float)D));
  return cudaGetLastError();
}

// DP (the padded head dimension) for D, or 0 when D is not taken.
int padded(int D) {
  if (D <= 0 || D % 4 != 0 || D > 128) return 0;
  return D <= 64 ? 64 : (D <= 112 ? 112 : 128);
}

}  // namespace

#define DISPATCH(DP_, F32, CALL)                                        \
  switch (DP_) {                                                        \
    case 64: return F32 ? CALL(64, float) : CALL(64, bf16);             \
    case 112: return F32 ? CALL(112, float) : CALL(112, bf16);          \
    case 128: return F32 ? CALL(128, float) : CALL(128, bf16);          \
    default: return (int)cudaErrorInvalidValue;                         \
  }

// q, k, v: (B, T, H, D) bf16; kbias: (B, T) f32 or null; out: (B, T, H, D)
// bf16 (out_f32 = 0) or f32; lse: (B, H, T) f32.
extern "C" int flash_train_fwd(const void* q, const void* k, const void* v, const float* kbias,
                               void* out, float* lse, int out_f32, int B, int T, int H, int D,
                               cudaStream_t stream) {
#define CALL(DP, OT) (int)fwd<DP, OT>(q, k, v, kbias, out, lse, B, T, H, D, stream)
  DISPATCH(padded(D), out_f32, CALL)
#undef CALL
}

// dout: (B, T, H, D) bf16; lse, delta: (B, H, T) f32; dq like out.
extern "C" int flash_train_dq(const void* q, const void* k, const void* v, const float* kbias,
                              const void* dout, const float* lse, const float* delta, void* dqp,
                              int out_f32, int B, int T, int H, int D, cudaStream_t stream) {
#define CALL(DP, OT) (int)dq<DP, OT>(q, k, v, kbias, dout, lse, delta, dqp, B, T, H, D, stream)
  DISPATCH(padded(D), out_f32, CALL)
#undef CALL
}

// dk, dv: (B, T, H, D) like out.
extern "C" int flash_train_dkv(const void* q, const void* k, const void* v, const float* kbias,
                               const void* dout, const float* lse, const float* delta,
                               void* dkp, void* dvp, int out_f32, int B, int T, int H, int D,
                               cudaStream_t stream) {
#define CALL(DP, OT) \
  (int)dkv<DP, OT>(q, k, v, kbias, dout, lse, delta, dkp, dvp, B, T, H, D, stream)
  DISPATCH(padded(D), out_f32, CALL)
#undef CALL
}
