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
// operations. The design puts every product on the tensor cores and keeps
// the score tile out of device memory:
//   - mma.sync m16n8k16 bf16 products with fp32 accumulation; a warp owns
//     16 rows (queries in fwd/dq, keys in dkv), four warps a block;
//   - the other operand streams through shared memory in tiles of 64 keys
//     (fwd, dq) or 32 queries (dkv), padded by 8 elements a row so that the
//     fragment loads hit 32 distinct banks; the score tile never leaves the
//     registers: the accumulator fragment of s is the A fragment of p;
//   - tiles past the causal diagonal are skipped: the forward and dq stop at
//     the query tile's last key, dkv starts at the key tile's first query;
//   - no atomics: dq and dk/dv are separate kernels, each writing its own
//     rows once, so the backward is deterministic.
// Simple on purpose: synchronous loads into shared memory, no cp.async or
// TMA pipeline and no wgmma (later work).
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
constexpr int kQueryTile = 32; // queries per shared tile (dkv)

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

template <int DP, typename OutT>
__global__ void __launch_bounds__(kThreads)
flash_train_dq_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                      const bf16* __restrict__ v, const float* __restrict__ kbias,
                      const bf16* __restrict__ dout, const float* __restrict__ lse,
                      const float* __restrict__ delta, OutT* __restrict__ dq, int T, int H,
                      int D, float scale) {
  constexpr int LD = DP + 8;
  constexpr int NT = kKeyTile / 8;
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* Qs = reinterpret_cast<bf16*>(smem);
  bf16* Os = Qs + kRows * LD;  // dout
  bf16* Ks = Os + kRows * LD;
  bf16* Vs = Ks + kKeyTile * LD;

  const int q0 = blockIdx.x * kRows, h = blockIdx.y, b = blockIdx.z;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, g = lane / 4, t = lane % 4;
  const int HD = H * D;
  const size_t base = (size_t)b * T * HD + (size_t)h * D;
  const float* brow = kbias ? kbias + (size_t)b * T : nullptr;
  const int wrow = warp * 16;
  const int r0 = q0 + wrow + g, r1 = r0 + 8;
  const float* lrow = lse + ((size_t)b * H + h) * T;
  const float* drow = delta + ((size_t)b * H + h) * T;
  const float lse0 = r0 < T ? lrow[r0] : 0.f, lse1 = r1 < T ? lrow[r1] : 0.f;
  const float dl0 = r0 < T ? drow[r0] : 0.f, dl1 = r1 < T ? drow[r1] : 0.f;

  load_tile<DP>(Qs, q + base, kRows, q0, T, HD, D);
  load_tile<DP>(Os, dout + base, kRows, q0, T, HD, D);

  float acc[DP / 8][4];
#pragma unroll
  for (int dn = 0; dn < DP / 8; ++dn) acc[dn][0] = acc[dn][1] = acc[dn][2] = acc[dn][3] = 0.f;

  const int nk = (T + kKeyTile - 1) / kKeyTile;
  const int hi = min((q0 + kRows + kKeyTile - 1) / kKeyTile, nk);
  for (int j = 0; j < hi; ++j) {
    const int k0 = j * kKeyTile;
    __syncthreads();
    load_tile<DP>(Ks, k + base, kKeyTile, k0, T, HD, D);
    load_tile<DP>(Vs, v + base, kKeyTile, k0, T, HD, D);
    __syncthreads();

    float s[NT][4], dp[NT][4];
    scores_rows<DP>(Qs, Ks, wrow, g, t, s);
    scores_rows<DP>(Os, Vs, wrow, g, t, dp);  // dO . v^T
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      const int c = k0 + nt * 8 + 2 * t;
      const float p0 = expf(masked(s[nt][0], r0, c, T, scale, brow) - lse0);
      const float p1 = expf(masked(s[nt][1], r0, c + 1, T, scale, brow) - lse0);
      const float p2 = expf(masked(s[nt][2], r1, c, T, scale, brow) - lse1);
      const float p3 = expf(masked(s[nt][3], r1, c + 1, T, scale, brow) - lse1);
      s[nt][0] = p0 * (dp[nt][0] - dl0) * scale;
      s[nt][1] = p1 * (dp[nt][1] - dl0) * scale;
      s[nt][2] = p2 * (dp[nt][2] - dl1) * scale;
      s[nt][3] = p3 * (dp[nt][3] - dl1) * scale;
    }
#pragma unroll
    for (int ks = 0; ks < kKeyTile / 16; ++ks) {
      uint32_t a[4];
      acc_to_a(s, ks, a);
#pragma unroll
      for (int dn = 0; dn < DP / 8; ++dn) {
        uint32_t b0, b1;
        frag_b_kn(Ks, LD, ks * 16, dn * 8, g, t, b0, b1);
        mma(acc[dn], a, b0, b1);
      }
    }
  }
  store_rows<DP>(dq + base, acc, q0 + wrow, g, t, 1.f, 1.f, T, HD, D);
}

template <int DP, typename OutT>
__global__ void __launch_bounds__(kThreads)
flash_train_dkv_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                       const bf16* __restrict__ v, const float* __restrict__ kbias,
                       const bf16* __restrict__ dout, const float* __restrict__ lse,
                       const float* __restrict__ delta, OutT* __restrict__ dk,
                       OutT* __restrict__ dv, int T, int H, int D, float scale) {
  constexpr int LD = DP + 8;
  constexpr int NT = kQueryTile / 8;
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* Ks = reinterpret_cast<bf16*>(smem);
  bf16* Vs = Ks + kRows * LD;
  bf16* Qs = Vs + kRows * LD;
  bf16* Os = Qs + kQueryTile * LD;  // dout
  float* Ls = reinterpret_cast<float*>(Os + kQueryTile * LD);
  float* Dl = Ls + kQueryTile;

  const int k0 = blockIdx.x * kRows, h = blockIdx.y, b = blockIdx.z;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, g = lane / 4, t = lane % 4;
  const int HD = H * D;
  const size_t base = (size_t)b * T * HD + (size_t)h * D;
  const int wrow = warp * 16;
  const int r0 = k0 + wrow + g, r1 = r0 + 8;  // this lane's two key rows
  const float* brow = kbias ? kbias + (size_t)b * T : nullptr;
  const float bias0 = (brow && r0 < T) ? brow[r0] : 0.f;
  const float bias1 = (brow && r1 < T) ? brow[r1] : 0.f;
  const float* lrow = lse + ((size_t)b * H + h) * T;
  const float* drow = delta + ((size_t)b * H + h) * T;

  load_tile<DP>(Ks, k + base, kRows, k0, T, HD, D);
  load_tile<DP>(Vs, v + base, kRows, k0, T, HD, D);

  float dka[DP / 8][4], dva[DP / 8][4];
#pragma unroll
  for (int dn = 0; dn < DP / 8; ++dn) {
    dka[dn][0] = dka[dn][1] = dka[dn][2] = dka[dn][3] = 0.f;
    dva[dn][0] = dva[dn][1] = dva[dn][2] = dva[dn][3] = 0.f;
  }

  const int nq = (T + kQueryTile - 1) / kQueryTile;
  for (int i = k0 / kQueryTile; i < nq; ++i) {
    const int c0 = i * kQueryTile;
    __syncthreads();
    load_tile<DP>(Qs, q + base, kQueryTile, c0, T, HD, D);
    load_tile<DP>(Os, dout + base, kQueryTile, c0, T, HD, D);
    if (threadIdx.x < kQueryTile) {
      const int c = c0 + threadIdx.x;
      Ls[threadIdx.x] = c < T ? lrow[c] : 0.f;
      Dl[threadIdx.x] = c < T ? drow[c] : 0.f;
    }
    __syncthreads();

    // transposed scores: rows are this warp's 16 keys, columns the tile's queries
    float s[NT][4], dp[NT][4];
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      s[nt][0] = s[nt][1] = s[nt][2] = s[nt][3] = 0.f;
      dp[nt][0] = dp[nt][1] = dp[nt][2] = dp[nt][3] = 0.f;
    }
#pragma unroll
    for (int kk = 0; kk < DP / 16; ++kk) {
      uint32_t ak[4], av[4];
      frag_a(Ks, LD, wrow, kk * 16, g, t, ak);
      frag_a(Vs, LD, wrow, kk * 16, g, t, av);
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        uint32_t b0, b1;
        frag_b_nk(Qs, LD, nt * 8, kk * 16, g, t, b0, b1);
        mma(s[nt], ak, b0, b1);
        frag_b_nk(Os, LD, nt * 8, kk * 16, g, t, b0, b1);
        mma(dp[nt], av, b0, b1);  // v . dO^T
      }
    }
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int cl = nt * 8 + 2 * t + (e & 1);  // query within the tile
        const int c = c0 + cl;
        const int r = (e < 2) ? r0 : r1;
        const float x = (c >= r && c < T && r < T) ? s[nt][e] * scale + (e < 2 ? bias0 : bias1)
                                                   : kNeg;
        const float p = expf(x - Ls[cl]);
        s[nt][e] = p;
        dp[nt][e] = p * (dp[nt][e] - Dl[cl]) * scale;
      }
    }
#pragma unroll
    for (int ks = 0; ks < kQueryTile / 16; ++ks) {
      uint32_t ap[4], ads[4];
      acc_to_a(s, ks, ap);
      acc_to_a(dp, ks, ads);
#pragma unroll
      for (int dn = 0; dn < DP / 8; ++dn) {
        uint32_t b0, b1;
        frag_b_kn(Os, LD, ks * 16, dn * 8, g, t, b0, b1);
        mma(dva[dn], ap, b0, b1);  // p^T . dO
        frag_b_kn(Qs, LD, ks * 16, dn * 8, g, t, b0, b1);
        mma(dka[dn], ads, b0, b1);  // ds^T . q
      }
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
  const size_t smem = (size_t)(2 * kRows + 2 * kKeyTile) * (DP + 8) * sizeof(bf16);
  auto kern = flash_train_dq_kernel<DP, OutT>;
  cudaError_t err = prepare(kern, smem);
  if (err != cudaSuccess) return err;
  dim3 grid((T + kRows - 1) / kRows, H, B);
  kern<<<grid, kThreads, smem, stream>>>(
      (const bf16*)q, (const bf16*)k, (const bf16*)v, kbias, (const bf16*)dout, lse, delta,
      (OutT*)dqp, T, H, D, 1.f / sqrtf((float)D));
  return cudaGetLastError();
}

template <int DP, typename OutT>
cudaError_t dkv(const void* q, const void* k, const void* v, const float* kbias,
                const void* dout, const float* lse, const float* delta, void* dkp, void* dvp,
                int B, int T, int H, int D, cudaStream_t stream) {
  const size_t smem = (size_t)(2 * kRows + 2 * kQueryTile) * (DP + 8) * sizeof(bf16)
                      + 2 * kQueryTile * sizeof(float);
  auto kern = flash_train_dkv_kernel<DP, OutT>;
  cudaError_t err = prepare(kern, smem);
  if (err != cudaSuccess) return err;
  dim3 grid((T + kRows - 1) / kRows, H, B);
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
