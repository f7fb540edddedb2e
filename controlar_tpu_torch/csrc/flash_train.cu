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
// Bound: the forward does 4 B H T^2 D / 2 flops (causal): 27 GFLOP a layer
// at the GPT-XL t2i 512 px training step (B 8, T 1143, H 20, D 64), 0.027
// ms at the H100's 989 TFLOP/s of dense bf16, against 94 MB of q, k, v and
// out (0.028 ms at 3.35 TB/s): the two are close, and the backward's 2.5x
// the flops over about twice the bytes tips it to operations. Every product
// runs on the tensor cores and the score tile stays out of device memory:
//   - bf16 products with fp32 accumulation; the score accumulator of a warp's
//     16 rows is, rounded, the A fragment of p (a wgmma accumulator row lives
//     in the four lanes of a quad, as an mma.sync fragment's);
//   - the other operand streams through shared memory in tiles of 64 keys
//     (fwd, dq) or 64 queries (dkv);
//   - tiles past the causal diagonal are skipped: the forward and dq stop at
//     the query tile's last key, dkv starts at the key tile's first query,
//     and only the diagonal tile is masked (it is also the only one with
//     keys past T, which the copies fill with zeros and the causal test
//     hides from every row < T); the bias is added on every tile;
//   - the heaviest blocks go first: blockIdx.y counts the forward's and dq's
//     query tiles from the last (the most key tiles) and dk/dv's key tiles
//     from the first (the most query tiles), over all (b, head) before the
//     next;
//   - no atomics: dq and dk/dv are separate kernels, each writing its own
//     rows once, so every kernel is deterministic.
// The forward works in log2 units: x = s scale log2(e) + bias log2(e), the
// mask and the running max's start -1e9 log2(e), p = exp2(x - m), lse = m
// ln 2 + log l. Two variants, chosen by D alone:
//   - D 64 and 128 (GPT-B/L/XL heads; their 128- and 256-byte head strides
//     are what a TMA tensor map takes): flash_train_fwd_tma_kernel. A
//     block is one warpgroup of 64 query rows; its thread 0 issues TMA
//     loads of the Q tile and of the K and V tiles into a ring of
//     kTmaStages stages of 128-byte-swizzled shared memory, one box per 64
//     columns (D 128: two), completing on full mbarriers, and refills a
//     stage once the warpgroup's empty mbarrier says every thread is done
//     with it. Per tile S = Q.K^T is D / 16 wgmma m64n64k16 with both
//     operands in shared memory, and P.V four wgmma m64nDk16 with p in
//     registers and V a transposed (N-major) shared-memory operand. Four
//     blocks a SM at D 64 hide each other's latencies; a producer warp of
//     its own (a fifth of a block's threads and registers) held a SM to
//     three and was 12% slower at the XL layer. The bias comes from device
//     memory (L1) while the S product runs. The tensor maps are encoded on
//     the host for every call (activations move), through the driver's
//     cuTensorMapEncodeTiled found with cudaGetDriverEntryPoint: the
//     library links no driver library;
//   - every other D (GPT-3B's 100, whose heads sit at 200-byte offsets):
//     flash_train_fwd_kernel, the backward's design below on mma.sync, with
//     K, V and the bias row in the cp.async ring.
// The first forward (synchronous loads between two barriers a tile) took
// 0.348 ms at the XL layer, 8% of its bound. The backward kernels (dq,
// dk/dv) took 0.377 and 0.447 ms in that design; they and the cp.async
// forward
//   - stream their tiles with cp.async into a ring of 3 stages at D <= 64
//     (2 above, for shared memory), one barrier a tile, the next tiles'
//     copies in flight under the current tile's products: K, V and the bias
//     row in the forward and dq; Q, dO, lse and delta in dk/dv. Rows past T
//     and the columns that pad D = 100 to 112 are zero-filled by the copy
//     (src-size 0); a query past T takes lse = +inf in dk/dv, so its p is 0
//     without a test; rows padded by 8 elements so that the fragment loads
//     of 8 rows hit 32 distinct banks;
//   - load every fragment with ldmatrix (x4: one instruction a 16 x 16 A
//     fragment or two 16 x 8 B fragments), .trans for the k-major operands
//     (V in p.V, K in ds.K, dO in p^T.dO, Q in ds^T.Q);
//   - take 64 queries a tile in dk/dv, computed in slices of 32 above D = 64
//     for registers; a warp owns 16 rows (queries in fwd/dq, keys in dkv),
//     four warps a block.
//
// D: any multiple of 4 up to 128 (64 for GPT-B/L/XL, 100 for GPT-3B),
// padded in shared memory to 64, 112 or 128 with zeros; T need not be a
// multiple of the tile (the ragged edge is masked and zero-filled).
//
// Plain C interface, loaded with ctypes. Launches go on the caller's
// stream; each entry returns cudaGetLastError() after its launch.
#include <cuda.h>  // CUtensorMap and the tensor-map enums; the encoder is found at run time
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

typedef __nv_bfloat16 bf16;

constexpr float kNeg = -1e9f;
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;
constexpr float kNegLog2 = kNeg * kLog2e;  // the mask and the running max's start, log2 units
constexpr int kThreads = 128;  // four warps
constexpr int kRows = 64;      // rows a block owns (16 a warp)
constexpr int kKeyTile = 64;   // keys per shared tile (fwd, dq)
constexpr int kQueryTile = 64; // queries per shared tile (dkv)
static_assert(kRows == kKeyTile && kRows == kQueryTile, "tiles align with the diagonal");

// stages of the kernels' K / V rings (cp.async, TMA), by padded head dimension
template <int DP>
constexpr int kStages = DP <= 64 ? 3 : 2;

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ void mma(float* c, const uint32_t* a, uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// A fragments of a 16 x 16 slice of a 16 x N accumulator (columns of the
// n-tiles 2 ks and 2 ks + 1), rounded to bf16.
__device__ __forceinline__ void acc_to_a(float (*s)[4], int ks, uint32_t* a) {
  a[0] = pack_bf16(s[2 * ks][0], s[2 * ks][1]);
  a[1] = pack_bf16(s[2 * ks][2], s[2 * ks][3]);
  a[2] = pack_bf16(s[2 * ks + 1][0], s[2 * ks + 1][1]);
  a[3] = pack_bf16(s[2 * ks + 1][2], s[2 * ks + 1][3]);
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

// ---- copies and fragments of the cp.async kernels ----

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

// Shared memory of the cp.async forward: the Q tile, then kStages stages
// of the K tile, the V tile and the bias row (the dq kernel's ring).
template <int DP>
constexpr size_t fwd_smem() {
  return (size_t)kRows * (DP + 8) * sizeof(bf16)
         + (size_t)kStages<DP> * (2 * kKeyTile * (DP + 8) * sizeof(bf16) + kKeyTile * sizeof(float));
}

// The online softmax of a warp's 16 rows over one key tile, in log2 units:
// s[nt][e] (q.k of row r0 + 8 (e >> 1) and key column nt * 8 + 2 t + (e & 1)
// of the tile) becomes x = s scale log2(e) + bias log2(e), the causal mask
// -1e9 log2(e) past the row on the diagonal tile (diag_k0: the tile's first
// key, or -1 off the diagonal), and then p = exp2(x - m) with the running
// max m; alpha rescales l and the output of the tiles before. bias[nt]: the
// bias of the lane's two columns of n-tile nt (zeros without a bias).
// 2^x by the special function unit (ex2.approx, subnormal results 0): p and
// alpha are rounded far coarser after it (p to bf16)
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

template <int NT>
__device__ __forceinline__ void softmax_tile(float (*s)[4], const float2 (&bias)[NT], int t,
                                             float scale_log2, int diag_k0, int r0, int r1,
                                             float& m0, float& m1, float& l0, float& l1,
                                             float& a0, float& a1) {
  static_assert(NT % 4 == 0, "four partial maxima and sums a row");
  float mx0[4], mx1[4];  // partial maxima: short chains, reduced in a fixed order
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) {
    const int cl = nt * 8 + 2 * t;
    const float b0 = bias[nt].x * kLog2e, b1 = bias[nt].y * kLog2e;
    float x[4] = {fmaf(s[nt][0], scale_log2, b0), fmaf(s[nt][1], scale_log2, b1),
                  fmaf(s[nt][2], scale_log2, b0), fmaf(s[nt][3], scale_log2, b1)};
    if (diag_k0 >= 0) {  // the only tile with keys past a row (or past T)
      const int c = diag_k0 + cl;
      if (c > r0) x[0] = kNegLog2;
      if (c + 1 > r0) x[1] = kNegLog2;
      if (c > r1) x[2] = kNegLog2;
      if (c + 1 > r1) x[3] = kNegLog2;
    }
#pragma unroll
    for (int e = 0; e < 4; ++e) s[nt][e] = x[e];
    const float y0 = fmaxf(x[0], x[1]), y1 = fmaxf(x[2], x[3]);
    mx0[nt % 4] = nt < 4 ? y0 : fmaxf(mx0[nt % 4], y0);
    mx1[nt % 4] = nt < 4 ? y1 : fmaxf(mx1[nt % 4], y1);
  }
  float n0 = fmaxf(fmaxf(m0, fmaxf(mx0[0], mx0[1])), fmaxf(mx0[2], mx0[3]));
  float n1 = fmaxf(fmaxf(m1, fmaxf(mx1[0], mx1[1])), fmaxf(mx1[2], mx1[3]));
  // the four lanes of a quad hold one row's columns
  n0 = fmaxf(n0, __shfl_xor_sync(0xffffffffu, n0, 1));
  n0 = fmaxf(n0, __shfl_xor_sync(0xffffffffu, n0, 2));
  n1 = fmaxf(n1, __shfl_xor_sync(0xffffffffu, n1, 1));
  n1 = fmaxf(n1, __shfl_xor_sync(0xffffffffu, n1, 2));
  a0 = ex2(m0 - n0);
  a1 = ex2(m1 - n1);
  m0 = n0;
  m1 = n1;
  float sum0[4], sum1[4];
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) {
    s[nt][0] = ex2(s[nt][0] - m0);
    s[nt][1] = ex2(s[nt][1] - m0);
    s[nt][2] = ex2(s[nt][2] - m1);
    s[nt][3] = ex2(s[nt][3] - m1);
    const float y0 = s[nt][0] + s[nt][1], y1 = s[nt][2] + s[nt][3];
    sum0[nt % 4] = nt < 4 ? y0 : sum0[nt % 4] + y0;
    sum1[nt % 4] = nt < 4 ? y1 : sum1[nt % 4] + y1;
  }
  // per-lane partial sums; every lane of a quad rescales by the same alpha
  l0 = l0 * a0 + ((sum0[0] + sum0[1]) + (sum0[2] + sum0[3]));
  l1 = l1 * a1 + ((sum1[0] + sum1[1]) + (sum1[2] + sum1[3]));
}

// The epilogue of a warp's 16 rows: out = o / l (rows < T), lse = m ln 2 +
// log l in natural units.
template <int DP, typename OutT>
__device__ __forceinline__ void store_fwd(OutT* __restrict__ out, float* __restrict__ lse,
                                          float (*o)[4], int b, int h, int row0, int g, int t,
                                          float m0, float m1, float l0, float l1, int T, int H,
                                          int D) {
  l0 += __shfl_xor_sync(0xffffffffu, l0, 1);
  l0 += __shfl_xor_sync(0xffffffffu, l0, 2);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 1);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 2);
  const int HD = H * D;
  store_rows<DP>(out + (size_t)b * T * HD + (size_t)h * D, o, row0, g, t, 1.f / l0, 1.f / l1,
                 T, HD, D);
  if (t == 0) {
    float* lrow = lse + ((size_t)b * H + h) * T;
    const int r0 = row0 + g, r1 = r0 + 8;
    if (r0 < T) lrow[r0] = m0 * kLn2 + logf(l0);
    if (r1 < T) lrow[r1] = m1 * kLn2 + logf(l1);
  }
}

template <int DP, typename OutT>
__global__ void __launch_bounds__(kThreads)
flash_train_fwd_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                       const bf16* __restrict__ v, const float* __restrict__ kbias,
                       OutT* __restrict__ out, float* __restrict__ lse, int T, int H, int D,
                       float scale_log2) {
  constexpr int LD = DP + 8;
  constexpr int NT = kKeyTile / 8;
  constexpr int NS = kStages<DP>;
  constexpr int TILE = kKeyTile * LD;
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* Qs = reinterpret_cast<bf16*>(smem);
  bf16* KVs = Qs + kRows * LD;  // NS x (K tile, V tile)
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
#pragma unroll
  for (int j = 0; j < NS - 1; ++j) {
    if (j < n_tiles) {
      issue(j);
    } else {
      cp_commit();
    }
  }

  float o[DP / 8][4];
#pragma unroll
  for (int dn = 0; dn < DP / 8; ++dn) o[dn][0] = o[dn][1] = o[dn][2] = o[dn][3] = 0.f;
  float m0 = kNegLog2, m1 = kNegLog2, l0 = 0.f, l1 = 0.f;

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

    float s[NT][4];
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) s[nt][0] = s[nt][1] = s[nt][2] = s[nt][3] = 0.f;
    mma_rows_nk<DP, NT>(s, Qs, wrow, Ks, 0, LD, lane);
    float2 bias[NT];
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      bias[nt] = brow ? *reinterpret_cast<const float2*>(Bs + (j % NS) * kKeyTile + nt * 8 + 2 * t)
                      : make_float2(0.f, 0.f);
    }
    float a0, a1;
    softmax_tile<NT>(s, bias, t, scale_log2, j == n_tiles - 1 ? j * kKeyTile : -1, r0, r1, m0,
                     m1, l0, l1, a0, a1);
#pragma unroll
    for (int dn = 0; dn < DP / 8; ++dn) {
      o[dn][0] *= a0;
      o[dn][1] *= a0;
      o[dn][2] *= a1;
      o[dn][3] *= a1;
    }
    mma_acc_kn<DP, kKeyTile / 16>(o, s, Vs, 0, LD, lane);  // p . V
  }
  store_fwd<DP>(out, lse, o, b, h, q0 + wrow, g, t, m0, m1, l0, l1, T, H, D);
}

// ---- the forward at D 64 and 128: TMA copies, wgmma products ----

constexpr int kTmaThreads = 128;                    // one warpgroup: the 64 query rows
constexpr int kTmaStages = 2;                       // 42 KB a block at D 64 (four a SM), 83 at 128
constexpr int kBoxCols = 64;                        // 64 bf16 = 128 bytes, the swizzle's span
constexpr int kBoxBytes = kKeyTile * kBoxCols * 2;  // one box: 64 rows of 128 bytes
static_assert(kRows == kKeyTile, "a box holds a query tile or a key tile");

// Shared memory of the TMA forward: 1024 bytes of slack to align the tiles
// (128-byte swizzle), the Q tile, kTmaStages stages of the K and V tiles,
// each DP / 64 boxes, then the mbarriers (Q, full and empty per stage).
template <int DP>
constexpr size_t tma_smem() {
  return 1024 + (size_t)(1 + 2 * kTmaStages) * (DP / kBoxCols) * kBoxBytes
         + (size_t)(1 + 2 * kTmaStages) * sizeof(uint64_t);
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_u32(bar)) : "memory");
}

// wait for the completion of the barrier's phase of this parity; a wait
// still open after ~2^35 cycles (about 20 s) traps, so that a broken ring
// ends the launch with an error instead of holding the card
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done = 0;
  long long t0 = 0;
  while (true) {
    asm volatile(
        "{\n.reg .pred p;\nmbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_u32(bar)), "r"(parity)
        : "memory");
    if (done) return;
    if (t0 == 0) {
      t0 = clock64();
    } else if (clock64() - t0 > (1LL << 35)) {
      __trap();
    }
  }
}

// one box of a (B, T, H, D) tensor's map at (column c, head h, row r, batch
// b) into shared memory, completing on bar
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map, uint64_t* bar, int c,
                                         int h, int r, int b) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c), "r"(h), "r"(r), "r"(b)
      : "memory");
}

// A wgmma shared-memory descriptor of a 128-byte-swizzled tile at p: lbo and
// sbo in bytes (the stride between 64-column boxes of an N-major operand,
// and between groups of 8 rows)
__device__ __forceinline__ uint64_t wg_desc(const void* p, uint32_t lbo, uint32_t sbo) {
  return (uint64_t)((smem_u32(p) & 0x3FFFF) >> 4) | (uint64_t)((lbo >> 4) & 0x3FFF) << 16
         | (uint64_t)((sbo >> 4) & 0x3FFF) << 32 | (uint64_t)1 << 62;
}

__device__ __forceinline__ void wg_fence() { asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wg_wait() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// keeps the compiler from moving accesses of an accumulator across wgmma
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N][4]) {
#pragma unroll
  for (int i = 0; i < N; ++i) {
    asm volatile("" : "+f"(r[i][0]), "+f"(r[i][1]), "+f"(r[i][2]), "+f"(r[i][3])::"memory");
  }
}

// S (64 x 64, fp32) += A (64 x 16) . B (64 x 16)^T: the Q and K tiles, both
// K-major in 128-byte-swizzled shared memory (descriptors da, db)
// (scale_d 0: S = A . B^T, the accumulator's contents ignored)
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[8][4], uint64_t da, uint64_t db,
                                             int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]),
        "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]),
        "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]),
        "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3]),
        "+f"(d[4][0]), "+f"(d[4][1]), "+f"(d[4][2]), "+f"(d[4][3]),
        "+f"(d[5][0]), "+f"(d[5][1]), "+f"(d[5][2]), "+f"(d[5][3]),
        "+f"(d[6][0]), "+f"(d[6][1]), "+f"(d[6][2]), "+f"(d[6][3]),
        "+f"(d[7][0]), "+f"(d[7][1]), "+f"(d[7][2]), "+f"(d[7][3])
      : "l"(da), "l"(db), "r"(scale_d));
}

// O (64 x 64, fp32) += P (64 x 16, bf16 A fragments in registers) . V
// (16 x 64), V N-major in 128-byte-swizzled shared memory (transposed B)
__device__ __forceinline__ void wgmma_rs_n64(float (&d)[8][4], const uint32_t (&a)[4],
                                              uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]),
        "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]),
        "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]),
        "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3]),
        "+f"(d[4][0]), "+f"(d[4][1]), "+f"(d[4][2]), "+f"(d[4][3]),
        "+f"(d[5][0]), "+f"(d[5][1]), "+f"(d[5][2]), "+f"(d[5][3]),
        "+f"(d[6][0]), "+f"(d[6][1]), "+f"(d[6][2]), "+f"(d[6][3]),
        "+f"(d[7][0]), "+f"(d[7][1]), "+f"(d[7][2]), "+f"(d[7][3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// O (64 x 128, fp32) += P (64 x 16, bf16 A fragments in registers) . V
// (16 x 128), V N-major in 128-byte-swizzled shared memory (transposed B)
__device__ __forceinline__ void wgmma_rs_n128(float (&d)[16][4], const uint32_t (&a)[4],
                                              uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]),
        "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]),
        "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]),
        "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3]),
        "+f"(d[4][0]), "+f"(d[4][1]), "+f"(d[4][2]), "+f"(d[4][3]),
        "+f"(d[5][0]), "+f"(d[5][1]), "+f"(d[5][2]), "+f"(d[5][3]),
        "+f"(d[6][0]), "+f"(d[6][1]), "+f"(d[6][2]), "+f"(d[6][3]),
        "+f"(d[7][0]), "+f"(d[7][1]), "+f"(d[7][2]), "+f"(d[7][3]),
        "+f"(d[8][0]), "+f"(d[8][1]), "+f"(d[8][2]), "+f"(d[8][3]),
        "+f"(d[9][0]), "+f"(d[9][1]), "+f"(d[9][2]), "+f"(d[9][3]),
        "+f"(d[10][0]), "+f"(d[10][1]), "+f"(d[10][2]), "+f"(d[10][3]),
        "+f"(d[11][0]), "+f"(d[11][1]), "+f"(d[11][2]), "+f"(d[11][3]),
        "+f"(d[12][0]), "+f"(d[12][1]), "+f"(d[12][2]), "+f"(d[12][3]),
        "+f"(d[13][0]), "+f"(d[13][1]), "+f"(d[13][2]), "+f"(d[13][3]),
        "+f"(d[14][0]), "+f"(d[14][1]), "+f"(d[14][2]), "+f"(d[14][3]),
        "+f"(d[15][0]), "+f"(d[15][1]), "+f"(d[15][2]), "+f"(d[15][3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// The forward at D 64 and 128: the block's warpgroup owns its 64 query rows,
// warp w rows 16 w .. 16 w + 15; thread 0 keeps TMA loads of the K and V
// tiles in flight into a ring of kTmaStages stages (full / empty
// mbarriers), and per key tile the warpgroup runs S = Q.K^T as DP / 16 wgmma
// m64n64k16 from shared memory, the online softmax in registers (a wgmma
// accumulator row lives in the four lanes of a quad, as an mma.sync
// fragment's), and P.V as four wgmma m64nDPk16 with the bf16 p as A
// fragments in registers and V a transposed shared-memory B operand. TMA
// zero-fills the rows past T of the Q and the last K / V tile.
template <int DP, typename OutT>
__global__ void __launch_bounds__(kTmaThreads, DP <= 64 ? 4 : 2)
flash_train_fwd_tma_kernel(const __grid_constant__ CUtensorMap tq,
                           const __grid_constant__ CUtensorMap tk,
                           const __grid_constant__ CUtensorMap tv,
                           const float* __restrict__ kbias, OutT* __restrict__ out,
                           float* __restrict__ lse, int T, int H, int D, float scale_log2) {
  constexpr int NT = kKeyTile / 8;
  constexpr int NS = kTmaStages;
  constexpr int BOXES = DP / kBoxCols;     // boxes a tile
  constexpr int TILE = BOXES * kBoxBytes;  // bytes a tile
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  unsigned char* sm = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  unsigned char* Qs = sm;
  unsigned char* KVs = sm + TILE;  // stage i: K at KVs + 2 i TILE, V after it
  uint64_t* bars = reinterpret_cast<uint64_t*>(KVs + 2 * NS * TILE);
  uint64_t* q_full = bars;
  uint64_t* full = bars + 1;
  uint64_t* empty = bars + 1 + NS;

  // heaviest first: the last query tile (the most key tiles) of every (b, head)
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kRows;
  const int h = blockIdx.x % H, b = blockIdx.x / H;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int n_tiles = q0 / kKeyTile + 1;  // key tiles up to the diagonal one

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int i = 0; i < NS; ++i) {
      mbar_init(full + i, 1);
      mbar_init(empty + i, kTmaThreads);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  // key tile j's K and V into stage j % NS (thread 0)
  auto load_tile = [&](int j) {
    const int st = j % NS;
    mbar_expect_tx(full + st, 2 * TILE);
    unsigned char* Ks = KVs + 2 * st * TILE;
#pragma unroll
    for (int c = 0; c < BOXES; ++c) {
      tma_load(Ks + c * kBoxBytes, &tk, full + st, c * kBoxCols, h, j * kKeyTile, b);
      tma_load(Ks + TILE + c * kBoxBytes, &tv, full + st, c * kBoxCols, h, j * kKeyTile, b);
    }
  };
  if (threadIdx.x == 0) {
    mbar_expect_tx(q_full, TILE);
#pragma unroll
    for (int c = 0; c < BOXES; ++c) tma_load(Qs + c * kBoxBytes, &tq, q_full, c * kBoxCols, h, q0, b);
    for (int j = 0; j < NS && j < n_tiles; ++j) load_tile(j);
  }

  const int g = lane / 4, t = lane % 4;
  const int r0 = q0 + warp * 16 + g, r1 = r0 + 8;
  const float* brow = kbias ? kbias + (size_t)b * T : nullptr;
  float o[DP / 8][4];
#pragma unroll
  for (int dn = 0; dn < DP / 8; ++dn) o[dn][0] = o[dn][1] = o[dn][2] = o[dn][3] = 0.f;
  float m0 = kNegLog2, m1 = kNegLog2, l0 = 0.f, l1 = 0.f;
  float s[NT][4];  // each tile's first product overwrites it
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) s[nt][0] = s[nt][1] = s[nt][2] = s[nt][3] = 0.f;

  mbar_wait(q_full, 0);
  for (int j = 0; j < n_tiles; ++j) {
    const int st = j % NS, k0 = j * kKeyTile;
    const unsigned char* Ks = KVs + 2 * st * TILE;
    const unsigned char* Vs = Ks + TILE;
    mbar_wait(full + st, (j / NS) & 1);

    fence_regs(s);
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < DP / 16; ++kk) {  // 16 columns a step: 32 bytes into a box's rows
      const int off = (kk / 4) * kBoxBytes + (kk % 4) * 32;
      wgmma_ss_n64(s, wg_desc(Qs + off, 16, 1024), wg_desc(Ks + off, 16, 1024), kk > 0);
    }
    wg_commit();
    float2 bias[NT];  // loaded while the product runs
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      const int c = k0 + nt * 8 + 2 * t;
      bias[nt] = make_float2(brow && c < T ? __ldg(brow + c) : 0.f,
                             brow && c + 1 < T ? __ldg(brow + c + 1) : 0.f);
    }
    wg_wait();
    fence_regs(s);

    float a0, a1;
    softmax_tile<NT>(s, bias, t, scale_log2, j == n_tiles - 1 ? k0 : -1, r0, r1, m0, m1, l0,
                     l1, a0, a1);
#pragma unroll
    for (int dn = 0; dn < DP / 8; ++dn) {
      o[dn][0] *= a0;
      o[dn][1] *= a0;
      o[dn][2] *= a1;
      o[dn][3] *= a1;
    }
    uint32_t p[kKeyTile / 16][4];
#pragma unroll
    for (int ks = 0; ks < kKeyTile / 16; ++ks) acc_to_a(s, ks, p[ks]);
    fence_regs(o);
    wg_fence();
#pragma unroll
    for (int ks = 0; ks < kKeyTile / 16; ++ks) {  // 16 keys a step: two groups of 8 rows
      const uint64_t dv = wg_desc(Vs + ks * 16 * 128, kBoxBytes, 1024);
      if constexpr (DP == 64) {
        wgmma_rs_n64(o, p[ks], dv);
      } else {
        wgmma_rs_n128(o, p[ks], dv);
      }
    }
    wg_commit();
    wg_wait();
    fence_regs(o);
    mbar_arrive(empty + st);  // this thread is done with stage st
    if (threadIdx.x == 0 && j + NS < n_tiles) {  // refill it once every thread is
      mbar_wait(empty + st, (j / NS) & 1);
      load_tile(j + NS);
    }
    __syncwarp();
  }
  store_fwd<DP>(out, lse, o, b, h, q0 + warp * 16, g, t, m0, m1, l0, l1, T, H, D);
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

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// The driver's cuTensorMapEncodeTiled, found through the runtime
// (cudaGetDriverEntryPoint): the library links no driver library.
EncodeTiled encode_tiled() {
  static const EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found = cudaDriverEntryPointSymbolNotFound;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                                             cudaEnableDefault, &found);
#else
    const cudaError_t err =
        cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    return err == cudaSuccess && found == cudaDriverEntryPointSuccess
               ? reinterpret_cast<EncodeTiled>(p)
               : nullptr;
  }();
  return fn;
}

// The tensor map of a (B, T, H, D) bf16 tensor: dims innermost first (D, H,
// T, B), boxes of 64 columns x 64 rows of one head and batch row, 128-byte
// swizzle, zeros past T. The strides must be multiples of 16 bytes: D 64
// and 128 (128- and 256-byte heads), not D 100 (200 bytes).
bool encode_bthd(CUtensorMap* map, const void* x, int B, int T, int H, int D) {
  const EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return false;
  const cuuint64_t dims[4] = {(cuuint64_t)D, (cuuint64_t)H, (cuuint64_t)T, (cuuint64_t)B};
  const cuuint64_t strides[3] = {(cuuint64_t)D * 2, (cuuint64_t)H * D * 2,
                                 (cuuint64_t)T * H * D * 2};
  const cuuint32_t box[4] = {kBoxCols, 1, kKeyTile, 1};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(x), dims, strides, box,
            elem, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
            CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

constexpr int kEncodeFailed = -1;  // flash_train_fwd's return when a tensor map cannot be encoded

// The forward: the TMA / wgmma kernel at D 64 and 128, the cp.async kernel
// at every other D (the variant is a function of D alone).
template <int DP, typename OutT>
int fwd(const void* q, const void* k, const void* v, const float* kbias, void* out, float* lse,
        int B, int T, int H, int D, cudaStream_t stream) {
  const dim3 grid(B * H, (T + kRows - 1) / kRows);  // blockIdx.y: query tiles, heaviest first
  const float scale_log2 = kLog2e / sqrtf((float)D);
  if constexpr (DP == 64 || DP == 128) {
    if (D == DP) {
      CUtensorMap tq, tk, tv;
      if (!encode_bthd(&tq, q, B, T, H, D) || !encode_bthd(&tk, k, B, T, H, D)
          || !encode_bthd(&tv, v, B, T, H, D)) {
        return kEncodeFailed;
      }
      auto kern = flash_train_fwd_tma_kernel<DP, OutT>;
      cudaError_t err = prepare(kern, tma_smem<DP>());
      if (err != cudaSuccess) return (int)err;
      kern<<<grid, kTmaThreads, tma_smem<DP>(), stream>>>(tq, tk, tv, kbias, (OutT*)out, lse, T,
                                                          H, D, scale_log2);
      return (int)cudaGetLastError();
    }
  }
  auto kern = flash_train_fwd_kernel<DP, OutT>;
  cudaError_t err = prepare(kern, fwd_smem<DP>());
  if (err != cudaSuccess) return (int)err;
  kern<<<grid, kThreads, fwd_smem<DP>(), stream>>>(
      (const bf16*)q, (const bf16*)k, (const bf16*)v, kbias, (OutT*)out, lse, T, H, D,
      scale_log2);
  return (int)cudaGetLastError();
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

// q, k, v: (B, T, H, D) bf16, 16-byte aligned; kbias: (B, T) f32 or null;
// out: (B, T, H, D) bf16 (out_f32 = 0) or f32; lse: (B, H, T) f32. Returns
// a cudaError_t, or -1 when a tensor map could not be encoded (D 64, 128).
extern "C" int flash_train_fwd(const void* q, const void* k, const void* v, const float* kbias,
                               void* out, float* lse, int out_f32, int B, int T, int H, int D,
                               cudaStream_t stream) {
#define CALL(DP, OT) fwd<DP, OT>(q, k, v, kbias, out, lse, B, T, H, D, stream)
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
