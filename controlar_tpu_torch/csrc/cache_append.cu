// KV-cache writes, in place:
//   - the fused write (`kv_write`): a layer's new k and v rows, (B, T, KV*D)
//     each, quantized to the cache's format and written at rows pos[b] + t
//     of every stream of the layer's cache: the [k|v] row of a floating
//     cache; the per-head int8 rows and f32 scales of an int8 cache; the
//     nibble-packed int4 carriers (pairs interleaved or split-rope) and the
//     scales of an int4 cache. T = 1 is a decode step, T = K a verify chunk;
//   - the stacked cache's end-of-step write (`kv_write_stacked`): every
//     layer's in-flight rows of a decode step, (L, B, W) per stream, which
//     the fused write quantized into them a layer at a time, written into
//     every stream of the (L, B, S, W) cache at row pos[b] in one launch;
//   - the single-stream copies: the per-slot row append, cache[b, pos[b], :]
//     = rows[b, :], its K-row block form, cache[b, pos[b] + j, :] = rows[b,
//     j, :] for j < K, and its stacked form over all layers of a (L, B, S,
//     W) cache, cache[l, b, pos[b], :] = rows[l, b, :].
//
// Replaces the Pallas kernels `_kernel` (cache_append_rows), `_block_kernel`
// (cache_append_block) and `_stacked_kernel` (cache_append_rows_stacked) of
// controlar_tpu/ops/cache_append.py. The decode steps and the verify chunk
// of the JAX package quantize the new rows in XLA (`decode._quantize_rows_for`)
// and then append each stream with the Pallas kernel; the fused write does
// both in one launch. A stacked cache is L * B elements of S rows each,
// element l * B + b taking its position from pos[b]: the stacked write
// stores every layer's row of every stream of a decode step in one launch,
// where the TPU kernel runs a grid (L, B) of read-modify-write windows for
// each stream, and the JAX package's step stacks and quantizes the rows in
// XLA first.
//
// The TPU kernels read and rewrite the aligned 8- or 32-row window around
// pos[b], because their DMA offsets must follow the (8, 128) tiling (the
// block form also needs a window of slack past the chunk); on this card the
// rows are addressed directly.
//
// Bound: launch latency. A layer's new rows are at most 16 x 4 rows of
// 12800 bytes (GPT-3B bf16, a verify chunk: 1.6 MB in and out, 0.5 us at
// 3.35 TB/s); a decode step's are 16 rows: all far less than the few
// microseconds a launch takes. What the fused write saves is the launches
// around the copy: the concatenation of k and v, the quantizer's
// elementwise kernels (9 for int8, 14 for int4) and one append per stream.
//
// The fused write: one warp per (element b * T + t, cache head hh), hh in
// [k heads | v heads]; blocks of kWarps warps over a grid (B * T, 2KV /
// kWarps). Each warp reads pos[b] (or the position passed by value) and
// skips its element when rows pos .. pos + T - 1 are not all inside [0, S),
// as the copies do. A lane holds value pairs j = lane + 32 m of its head: (2j,
// 2j + 1), or (j, D/2 + j) for split-rope carriers. The quantized forms take
// the head's amax from a __shfl_xor_sync reduction and compute what the
// port's quantizer (`quant.quantize_kv_rows`, `_4`) computes on this card,
// bit for bit:
//   s = max(amax * f32(1 / QMAX), 1e-8)   PyTorch divides by a Python scalar
//                                         on CUDA as a product with its f32
//                                         reciprocal; a NaN amax stays NaN,
//                                         as torch.clamp keeps it;
//   q = clamp(rint(x / s), -QMAX, QMAX)   IEEE division, round half to even;
//                                         a NaN quotient stores 0, as the
//                                         card's float-to-integer cast does.
// Lane 0 writes the head's scale; int4 carriers are (q0 & 15) | (q1 & 15) << 4.
// Loads and stores are element-wise at the elements' own alignment (k and v
// are strided views of the projection; D = 100 heads sit at 2-byte offsets
// in an int4 row), coalesced across the warp. No shared memory: a warp's
// values stay in registers.
//
// The stacked write: one block per element l * B + b copies the element's
// in-flight row of each stream (one or two: the rows, and a quantized
// cache's scales) to row pos[b], at the widest vector of 16, 8, 4, 2 or 1
// bytes that divides the stream's row, its layer stride and both pointers;
// a row whose position lies outside [0, S) is skipped.
//
// The copies: the K rows of element b are one contiguous span of K *
// row_bytes bytes at row pos[b], and the kernel copies that span and nothing
// else:
//   - blockIdx.x is the element e (the batch row b, or l * B + b for a
//     stacked cache) and p = pos[e % B] its row; a long span is cut over
//     blockIdx.y (one block per 512 vectors), a single row stays one block;
//     every block reads p itself and skips the span when rows p .. p + K - 1
//     are not all inside [0, S), so it never writes outside the cache;
//   - the kernel is byte-generic (bf16 rows, int8 rows, nibble-packed int4
//     carriers and f32 scales all go through one kernel); the caller picks
//     the widest vector of 16, 8, 4, 2 or 1 bytes that divides the row's
//     byte width and both base pointers' alignment, so every access of the
//     row is aligned;
//   - threads stride over the span's vectors: neighbouring threads copy
//     neighbouring addresses.
//
// Plain C interface, loaded with ctypes. The launch goes on the caller's
// stream; each function returns cudaGetLastError() after the launch.
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kThreads = 128;

constexpr int kVecsPerThread = 4;  // vectors a thread copies before the span is cut

template <typename V>
__global__ void __launch_bounds__(kThreads)
cache_append_kernel(char* __restrict__ cache,       // (E, S, row_bytes), E = L * n_pos
                    const char* __restrict__ rows,  // (E, K, row_bytes)
                    const int* __restrict__ pos,    // (n_pos,)
                    int n_pos, int S, int K, long long row_bytes) {
  const int b = blockIdx.x;  // the element
  const int p = pos[b % n_pos];
  if (p < 0 || p > S - K) return;  // out of range: the span is skipped
  const long long span = (long long)K * row_bytes;
  V* dst = reinterpret_cast<V*>(cache + ((long long)b * S + p) * row_bytes);
  const V* src = reinterpret_cast<const V*>(rows + (long long)b * span);
  const long long n = span / (long long)sizeof(V);
  const long long stride = (long long)gridDim.y * kThreads;
  for (long long i = (long long)blockIdx.y * kThreads + threadIdx.x; i < n; i += stride) {
    dst[i] = src[i];
  }
}

template <typename V>
void launch(void* cache, const void* rows, const void* pos, int L, int B, int S, int K,
            long long row_bytes, cudaStream_t stream) {
  const long long n = (long long)K * row_bytes / (long long)sizeof(V);
  const long long per_block = (long long)kThreads * kVecsPerThread;
  const dim3 grid(L * B, static_cast<unsigned>((n + per_block - 1) / per_block));
  cache_append_kernel<V><<<grid, kThreads, 0, stream>>>(
      static_cast<char*>(cache), static_cast<const char*>(rows), static_cast<const int*>(pos),
      B, S, K, row_bytes);
}

int dispatch(void* cache, const void* rows, const void* pos, int L, int B, int S, int K,
             long long row_bytes, int vec_bytes, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (L <= 0 || B <= 0 || K <= 0 || row_bytes <= 0) return 0;
  switch (vec_bytes) {
    case 16: launch<uint4>(cache, rows, pos, L, B, S, K, row_bytes, st); break;
    case 8: launch<uint2>(cache, rows, pos, L, B, S, K, row_bytes, st); break;
    case 4: launch<uint32_t>(cache, rows, pos, L, B, S, K, row_bytes, st); break;
    case 2: launch<uint16_t>(cache, rows, pos, L, B, S, K, row_bytes, st); break;
    case 1: launch<uint8_t>(cache, rows, pos, L, B, S, K, row_bytes, st); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}


// ---- the fused write ---------------------------------------------------------

constexpr int kWarps = 8;     // cache heads (warps) a block
constexpr int kMaxPairs = 4;  // value pairs a lane holds: D <= 256

// cache formats, as ops/cache_append.py passes them
enum Kind { kFloat = 0, kInt8 = 1, kInt4 = 2, kInt4Split = 3 };

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ float to_f32(__half x) { return __half2float(x); }

// a floating value in the cache's dtype: a bit copy for the same dtype,
// else through f32 with round to nearest even (PyTorch's casts)
template <typename Out, typename In>
__device__ __forceinline__ Out cast(In x) {
  if constexpr (std::is_same_v<Out, In>) {
    return x;
  } else if constexpr (std::is_same_v<Out, float>) {
    return to_f32(x);
  } else if constexpr (std::is_same_v<Out, __nv_bfloat16>) {
    return __float2bfloat16_rn(to_f32(x));
  } else {
    return __float2half_rn(to_f32(x));
  }
}

// max that keeps a NaN from either side, as torch.amax does
__device__ __forceinline__ float nan_max(float a, float b) { return (a > b || a != a) ? a : b; }

template <int QMAX>
__device__ __forceinline__ int quantize(float x, float s) {
  const float r = rintf(__fdiv_rn(x, s));
  return r != r ? 0 : static_cast<int>(fminf(fmaxf(r, -QMAX), QMAX));
}

template <typename In, typename Out, int KIND>
__global__ void __launch_bounds__(kWarps * 32)
kv_write_kernel(Out* __restrict__ rows,        // (B, S, 2KV*D) values or int8; (B, S, KV*D) carriers
                float* __restrict__ scales,    // (B, S, 2KV) f32; unused for a floating cache
                const In* __restrict__ k,      // (B, T, KV*D), element strides k_b, k_t, 1
                const In* __restrict__ v,      // (B, T, KV*D), element strides v_b, v_t, 1
                long long k_b, long long k_t, long long v_b, long long v_t,
                const int* __restrict__ pos,   // (B,) int32, or null: every row at pos0
                int pos0, int T, int S, int KV, int D) {
  const int lane = threadIdx.x & 31;
  const int hh = blockIdx.y * kWarps + (threadIdx.x >> 5);  // [k heads | v heads]
  if (hh >= 2 * KV) return;
  const int b = blockIdx.x / T;
  const int t = blockIdx.x - b * T;
  const int p = pos == nullptr ? pos0 : pos[b];
  if (p < 0 || p > S - T) return;  // out of range: the element is skipped
  const bool is_v = hh >= KV;
  const In* src = (is_v ? v + b * v_b + t * v_t : k + b * k_b + t * k_t)
                  + (long long)(is_v ? hh - KV : hh) * D;
  const long long row = (long long)b * S + p + t;

  if constexpr (KIND == kFloat) {
    Out* dst = rows + row * 2 * KV * D + (long long)hh * D;
    for (int i = lane; i < D; i += 32) dst[i] = cast<Out>(src[i]);
    return;
  } else {
    constexpr int QMAX = KIND == kInt8 ? 127 : 7;
    const int P = D / 2;
    float x0[kMaxPairs], x1[kMaxPairs];
    float amax = 0.f;
#pragma unroll
    for (int m = 0; m < kMaxPairs; ++m) {
      const int j = lane + 32 * m;
      x0[m] = x1[m] = 0.f;
      if (j < P) {
        x0[m] = to_f32(src[KIND == kInt4Split ? j : 2 * j]);
        x1[m] = to_f32(src[KIND == kInt4Split ? P + j : 2 * j + 1]);
        amax = nan_max(amax, nan_max(fabsf(x0[m]), fabsf(x1[m])));
      }
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) amax = nan_max(amax, __shfl_xor_sync(0xffffffffu, amax, off));
    float s = __fmul_rn(amax, 1.0f / QMAX);
    s = s != s ? s : fmaxf(s, 1e-8f);
    if (lane == 0) scales[row * 2 * KV + hh] = s;
#pragma unroll
    for (int m = 0; m < kMaxPairs; ++m) {
      const int j = lane + 32 * m;
      if (j >= P) break;
      const int q0 = quantize<QMAX>(x0[m], s), q1 = quantize<QMAX>(x1[m], s);
      if constexpr (KIND == kInt8) {
        Out* dst = rows + row * 2 * KV * D + (long long)hh * D;
        dst[2 * j] = static_cast<Out>(q0);
        dst[2 * j + 1] = static_cast<Out>(q1);
      } else {
        rows[row * KV * D + (long long)hh * P + j] = static_cast<Out>((q0 & 0xF) | ((q1 & 0xF) << 4));
      }
    }
  }
}

template <typename In, typename Out, int KIND>
int launch_kv(void* rows, void* scales, const void* k, const void* v, long long k_b,
              long long k_t, long long v_b, long long v_t, const void* pos, int pos0, int B,
              int T, int S, int KV, int D, cudaStream_t stream) {
  const dim3 grid(B * T, (2 * KV + kWarps - 1) / kWarps);
  kv_write_kernel<In, Out, KIND><<<grid, kWarps * 32, 0, stream>>>(
      static_cast<Out*>(rows), static_cast<float*>(scales), static_cast<const In*>(k),
      static_cast<const In*>(v), k_b, k_t, v_b, v_t, static_cast<const int*>(pos), pos0, T, S,
      KV, D);
  return static_cast<int>(cudaGetLastError());
}

// dtype codes: 0 f32, 1 bf16, 2 f16
template <typename In>
int dispatch_kv(int kind, int out_dtype, void* rows, void* scales, const void* k, const void* v,
                long long k_b, long long k_t, long long v_b, long long v_t, const void* pos,
                int pos0, int B, int T, int S, int KV, int D, cudaStream_t st) {
#define KV_ARGS rows, scales, k, v, k_b, k_t, v_b, v_t, pos, pos0, B, T, S, KV, D, st
  switch (kind) {
    case kFloat:
      switch (out_dtype) {
        case 0: return launch_kv<In, float, kFloat>(KV_ARGS);
        case 1: return launch_kv<In, __nv_bfloat16, kFloat>(KV_ARGS);
        case 2: return launch_kv<In, __half, kFloat>(KV_ARGS);
        default: return static_cast<int>(cudaErrorInvalidValue);
      }
    case kInt8: return launch_kv<In, int8_t, kInt8>(KV_ARGS);
    case kInt4: return launch_kv<In, int8_t, kInt4>(KV_ARGS);
    case kInt4Split: return launch_kv<In, int8_t, kInt4Split>(KV_ARGS);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
#undef KV_ARGS
}


// ---- the stacked cache's end-of-step write ---------------------------------

constexpr int kMaxStreams = 2;  // the rows (values, int8 or int4 carriers) and the scales

// One stream of a stacked cache and its in-flight rows: the cache (L, B, S,
// row_bytes); the rows (L, B, row_bytes), layer l at l * layer_bytes; vec:
// the bytes a vector (16, 8, 4, 2 or 1) dividing the row and every address.
struct StackedStream {
  char* cache;
  const char* rows;
  long long row_bytes;
  long long layer_bytes;
  int vec;
};

template <typename V>
__device__ __forceinline__ void copy_row(char* dst, const char* src, long long bytes) {
  V* d = reinterpret_cast<V*>(dst);
  const V* r = reinterpret_cast<const V*>(src);
  const long long n = bytes / (long long)sizeof(V);
  for (long long i = threadIdx.x; i < n; i += kThreads) d[i] = r[i];
}

// row (l, b) of stream x to row p of element e = l * B + b
__device__ __forceinline__ void write_row(StackedStream x, long long e, long long l, int b, int S,
                                          int p) {
  char* dst = x.cache + (e * S + p) * x.row_bytes;
  const char* src = x.rows + l * x.layer_bytes + (long long)b * x.row_bytes;
  switch (x.vec) {
    case 16: copy_row<uint4>(dst, src, x.row_bytes); break;
    case 8: copy_row<uint2>(dst, src, x.row_bytes); break;
    case 4: copy_row<uint32_t>(dst, src, x.row_bytes); break;
    case 2: copy_row<uint16_t>(dst, src, x.row_bytes); break;
    default: copy_row<uint8_t>(dst, src, x.row_bytes); break;
  }
}

// a block per element e = l * B + b: every stream's row (l, b) to row p of
// element e, p = pos[b] (or pos0 for every row); skipped when p is outside
// [0, S), as the other copies skip
__global__ void __launch_bounds__(kThreads)
kv_write_stacked_kernel(StackedStream s0, StackedStream s1, int n_streams,
                        const int* __restrict__ pos, int pos0, int B, int S) {
  const int e = blockIdx.x;
  const int b = e % B;
  const int p = pos == nullptr ? pos0 : pos[b];
  if (p < 0 || p >= S) return;
  write_row(s0, e, e / B, b, S, p);
  if (n_streams > 1) write_row(s1, e, e / B, b, S, p);
}

}  // namespace

// cache (B, S, row_bytes) bytes; rows (B, row_bytes) bytes; pos (B,) int32 on
// the device; vec_bytes in {16, 8, 4, 2, 1} divides row_bytes and both
// pointers' alignment. Returns a cudaError_t.
extern "C" int cache_append_rows(void* cache, const void* rows, const void* pos, int B, int S,
                                 long long row_bytes, int vec_bytes, void* stream) {
  return dispatch(cache, rows, pos, 1, B, S, 1, row_bytes, vec_bytes, stream);
}

// cache (B, S, row_bytes) bytes; rows (B, K, row_bytes) bytes, element b's K
// rows landing at rows pos[b] .. pos[b] + K - 1; pos and vec_bytes as for
// cache_append_rows. Returns a cudaError_t.
extern "C" int cache_append_block(void* cache, const void* rows, const void* pos, int B, int S,
                                  int K, long long row_bytes, int vec_bytes, void* stream) {
  return dispatch(cache, rows, pos, 1, B, S, K, row_bytes, vec_bytes, stream);
}

// cache (L, B, S, row_bytes) bytes; rows (L, B, row_bytes) bytes, row (l, b)
// landing at row pos[b] of layer l; pos and vec_bytes as for
// cache_append_rows. Returns a cudaError_t.
extern "C" int cache_append_rows_stacked(void* cache, const void* rows, const void* pos, int L,
                                         int B, int S, long long row_bytes, int vec_bytes,
                                         void* stream) {
  return dispatch(cache, rows, pos, L, B, S, 1, row_bytes, vec_bytes, stream);
}

// The fused write of a layer's new rows k, v (B, T, KV*D) of dtype in_dtype
// (0 f32, 1 bf16, 2 f16; element strides k_b, k_t / v_b, v_t, the last dim
// contiguous) at rows pos[b] + t: kind 0 a floating cache `rows` (B, S,
// 2KV*D) of dtype out_dtype; kind 1 int8 rows (B, S, 2KV*D) and f32 `scales`
// (B, S, 2KV); kinds 2 and 3 int4 carriers (B, S, KV*D), pairs (2j, 2j + 1)
// or split (j, D/2 + j), and scales. pos: (B,) int32 on the device, or null
// for every row at pos0. D even and at most 256 for kinds 1-3. Returns a
// cudaError_t.
extern "C" int kv_write(int kind, int in_dtype, int out_dtype, void* rows, void* scales,
                        const void* k, const void* v, long long k_b, long long k_t,
                        long long v_b, long long v_t, const void* pos, int pos0, int B, int T,
                        int S, int KV, int D, void* stream) {
  if (B <= 0 || T <= 0 || KV <= 0 || D <= 0) return 0;
  if (kind != kFloat && (D % 2 != 0 || D > 64 * kMaxPairs)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (in_dtype) {
    case 0: return dispatch_kv<float>(kind, out_dtype, rows, scales, k, v, k_b, k_t, v_b, v_t,
                                      pos, pos0, B, T, S, KV, D, st);
    case 1: return dispatch_kv<__nv_bfloat16>(kind, out_dtype, rows, scales, k, v, k_b, k_t,
                                              v_b, v_t, pos, pos0, B, T, S, KV, D, st);
    case 2: return dispatch_kv<__half>(kind, out_dtype, rows, scales, k, v, k_b, k_t, v_b,
                                       v_t, pos, pos0, B, T, S, KV, D, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// The stacked cache's end-of-step write: for each of n_streams (1 or 2)
// streams, cache (L, B, S, row_bytes) and in-flight rows (L, B, row_bytes)
// whose layer l starts at l * layer_bytes, rows[l, b] lands at row pos[b] of
// layer l (pos (B,) int32 on the device, or null for every row at pos0):
// the values of a floating cache, or an int8 / int4 cache's rows and its
// scales, in one launch. vec: the bytes a vector of each stream (16, 8, 4,
// 2 or 1), dividing its row_bytes, layer_bytes and both pointers. The second
// stream's arguments are ignored when n_streams is 1. Returns a cudaError_t.
extern "C" int kv_write_stacked(int n_streams, void* cache0, const void* rows0,
                                long long row_bytes0, long long layer_bytes0, int vec0,
                                void* cache1, const void* rows1, long long row_bytes1,
                                long long layer_bytes1, int vec1, const void* pos, int pos0,
                                int L, int B, int S, void* stream) {
  if (n_streams < 1 || n_streams > kMaxStreams) return static_cast<int>(cudaErrorInvalidValue);
  if (L <= 0 || B <= 0) return 0;
  const StackedStream s0{static_cast<char*>(cache0), static_cast<const char*>(rows0), row_bytes0,
                         layer_bytes0, vec0};
  const StackedStream s1{static_cast<char*>(cache1), static_cast<const char*>(rows1), row_bytes1,
                         layer_bytes1, vec1};
  for (const int v : {vec0, vec1}) {
    if (v != 16 && v != 8 && v != 4 && v != 2 && v != 1) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
  }
  kv_write_stacked_kernel<<<L * B, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      s0, s1, n_streams, static_cast<const int*>(pos), pos0, B, S);
  return static_cast<int>(cudaGetLastError());
}
