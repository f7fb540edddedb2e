// Per-slot KV-cache row append: cache[b, pos[b], :] = rows[b, :], in place.
//
// Replaces the Pallas kernel `_kernel` of controlar_tpu/ops/cache_append.py
// (cache_append_rows). The TPU kernel reads and rewrites the 8- or 32-row
// window around pos[b], because its DMA offsets must follow the (8, 128)
// tiling; on this card one row can be addressed directly, so the kernel
// copies the row's bytes and nothing else.
//
// Bound: launch latency. At the serving shapes one call moves 16 rows of at
// most 3200 bytes in and out (about 0.1 MB, some 0.03 us at 3.35 TB/s), far
// less than the few microseconds a launch takes. The design keeps the copy
// at the widest aligned access and does no other work:
//   - one thread block per batch row b; the block reads pos[b] itself and
//     skips the row when pos[b] is outside [0, S), so it never writes
//     outside the cache;
//   - the kernel is byte-generic (bf16 rows, int8 rows, nibble-packed int4
//     carriers and f32 scales all go through one entry); the caller picks
//     the widest vector of 16, 8, 4, 2 or 1 bytes that divides the row's
//     byte width and both base pointers' alignment, so every access of the
//     row is aligned;
//   - threads stride over the row's vectors: neighbouring threads copy
//     neighbouring addresses.
//
// Plain C interface, loaded with ctypes. The launch goes on the caller's
// stream; the function returns cudaGetLastError() after the launch.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;

template <typename V>
__global__ void __launch_bounds__(kThreads)
cache_append_kernel(char* __restrict__ cache,       // (B, S, row_bytes)
                    const char* __restrict__ rows,  // (B, row_bytes)
                    const int* __restrict__ pos,    // (B,)
                    int S, long long row_bytes) {
  const int b = blockIdx.x;
  const int p = pos[b];
  if (p < 0 || p >= S) return;  // out of range: the row is skipped
  V* dst = reinterpret_cast<V*>(cache + ((long long)b * S + p) * row_bytes);
  const V* src = reinterpret_cast<const V*>(rows + (long long)b * row_bytes);
  const long long n = row_bytes / (long long)sizeof(V);
  for (long long i = threadIdx.x; i < n; i += kThreads) dst[i] = src[i];
}

template <typename V>
void launch(void* cache, const void* rows, const void* pos, int B, int S, long long row_bytes,
            cudaStream_t stream) {
  cache_append_kernel<V><<<B, kThreads, 0, stream>>>(
      static_cast<char*>(cache), static_cast<const char*>(rows), static_cast<const int*>(pos),
      S, row_bytes);
}

}  // namespace

// cache (B, S, row_bytes) bytes; rows (B, row_bytes) bytes; pos (B,) int32 on
// the device; vec_bytes in {16, 8, 4, 2, 1} divides row_bytes and both
// pointers' alignment. Returns a cudaError_t.
extern "C" int cache_append_rows(void* cache, const void* rows, const void* pos, int B, int S,
                                 long long row_bytes, int vec_bytes, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (B <= 0) return 0;
  switch (vec_bytes) {
    case 16: launch<uint4>(cache, rows, pos, B, S, row_bytes, st); break;
    case 8: launch<uint2>(cache, rows, pos, B, S, row_bytes, st); break;
    case 4: launch<uint32_t>(cache, rows, pos, B, S, row_bytes, st); break;
    case 2: launch<uint16_t>(cache, rows, pos, B, S, row_bytes, st); break;
    case 1: launch<uint8_t>(cache, rows, pos, B, S, row_bytes, st); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
