// K-query chunk attention over an interleaved [k|v] cache slab, bf16 or int8
// with per-row, per-head f32 scales.
//
// Replaces the Pallas kernel `_kernel` of controlar_tpu/ops/flash_chunk.py
// (`_call`, behind flash_chunk_attention and flash_chunk_attention_q8): the
// speculative verify and chunked-prefill attention. The function, the bound
// and the design are in csrc/flash_chunk.cuh, shared with the int4 kernel
// (csrc/flash_chunk_q4.cu): a warp per (batch row, head, tile of up to 8
// queries, chunk of cache rows), cp.async-staged copies, q.k on the tensor
// cores, online softmax and P.V in fp32, the chunks merged in order in the
// last arriving warp.
//
// The first design (one block of 8 warps per (b, head, tile), a warp
// scoring one row at a time with synchronous loads, a 5-step shuffle chain
// and the softmax updates waiting on each load) took 0.169 ms (bf16) and
// 0.245 ms (int8) at the GPT-3B verify, 21% and 7.6% of the bound.
//
// Plain C interface, loaded with ctypes. The launch goes on the caller's
// stream; the functions return cudaGetLastError() after the launch.
#include "flash_chunk.cuh"

// q (B, K, H*D) bf16; kv (B, S, 2*H*D) bf16; pos: pos_ptr[b * pos_stride]
// int32 when pos_ptr is not null, else pos_scalar; bias (B, S) f32 or null;
// out (B, K, H*D) f32 when out_f32, else bf16. The launch plan
// (ops/flash_chunk.chunk_plan): nq queries a tile, n_chunks work items of
// chunk::kChunk rows a (batch row, head, tile), ws at least B * H *
// ceil(K / nq) * n_chunks parts of nq * (D + 4) floats, counters B * H *
// ceil(K / nq) zeroed ints, left zero. Returns a cudaError_t.
extern "C" int flash_chunk_attention(const void* q, const void* kv, const void* pos_ptr,
                                     int pos_stride, int pos_scalar, const void* bias, void* out,
                                     int out_f32, int B, int S, int H, int D, int K, void* ws,
                                     void* counters, int nq, int n_chunks, void* stream) {
  return chunk::dispatch<chunk::Bf16Kv>(q, kv, nullptr, pos_ptr, pos_stride, pos_scalar, bias,
                                        out, out_f32, B, S, H, D, K, ws, counters, nq, n_chunks,
                                        0, stream);
}

// As flash_chunk_attention over an int8 kv slab with sc (B, S, 2*H) f32
// per-row, per-head scales [ks | vs].
extern "C" int flash_chunk_q8(const void* q, const void* kv, const void* sc, const void* pos_ptr,
                              int pos_stride, int pos_scalar, const void* bias, void* out,
                              int out_f32, int B, int S, int H, int D, int K, void* ws,
                              void* counters, int nq, int n_chunks, void* stream) {
  return chunk::dispatch<chunk::Int8Kv>(q, kv, sc, pos_ptr, pos_stride, pos_scalar, bias, out,
                                        out_f32, B, S, H, D, K, ws, counters, nq, n_chunks, 0,
                                        stream);
}
