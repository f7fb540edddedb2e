// Per-slot KV-cache row append, cache[b, pos[b], :] = rows[b, :], its K-row
// block form, cache[b, pos[b] + j, :] = rows[b, j, :] for j < K, and its
// stacked form over all layers of a (L, B, S, W) cache,
// cache[l, b, pos[b], :] = rows[l, b, :]; in place.
//
// Replaces the Pallas kernels `_kernel` (cache_append_rows), `_block_kernel`
// (cache_append_block) and `_stacked_kernel` (cache_append_rows_stacked) of
// controlar_tpu/ops/cache_append.py. A stacked cache is L * B elements of
// S rows each, element l * B + b taking its position from pos[b]: one launch
// writes every layer's row of a decode step, where the TPU kernel runs a
// grid (L, B) of read-modify-write windows.
//
// The TPU kernels read and rewrite the aligned 8- or 32-row window around
// pos[b], because their DMA offsets must follow the (8, 128) tiling (the
// block form also needs a window of slack past the chunk); on this card the
// K rows of element b are one contiguous span of K * row_bytes bytes at row
// pos[b], so the kernel copies that span and nothing else.
//
// Bound: launch latency. At the serving shapes one call moves 16 rows of at
// most 3200 bytes in and out (about 0.1 MB, some 0.03 us at 3.35 TB/s); a
// speculative verify at GPT-3B moves 16 spans of 4 bf16 rows of 12800 bytes
// (1.6 MB in and out, 0.5 us); the stacked form at serve_c2i moves 12 layers
// of those 16 rows (1.2 MB, 0.35 us): all far less than the few
// microseconds a launch takes. The design keeps the copy at the widest
// aligned access and does no other work:
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
// stream; the function returns cudaGetLastError() after the launch.
#include <cuda_runtime.h>
#include <stdint.h>

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
