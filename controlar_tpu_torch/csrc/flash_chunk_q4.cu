// K-query chunk attention over a nibble-packed int4 [k|v] cache slab with
// per-row, per-head f32 scales.
//
// Replaces the Pallas kernel `_kernel_chunk_q4` of
// controlar_tpu/ops/flash_chunk.py (flash_chunk_attention_q4). A cache row
// holds H*D/2 k carriers, then H*D/2 v carriers; carrier j of head h holds
// the pair (even_j, odd_j) as low | high signed nibble: dims (2j, 2j+1) in
// the interleaved layout, or (j, D/2 + j) in the split-rope layout
// (split = 1). For batch row b, head h and chunk query j:
//   s_r = (q_even . klo + q_odd . khi) * ks[b,r,h] / sqrt(2 * (D/2))
//         + (r == pos[b]+j ? 0 : bias[b,r])
//   out[b,j,h] = sum_r softmax(s)_r * vs[b,r,h] * (vlo, vhi)
// over rows r <= pos[b] + j, the output pairs written back in q's layout.
//
// The design is the bf16/int8 chunk kernel's (csrc/flash_chunk.cuh) on
// quads of two carriers: a head's D/2 carriers (50 bytes at D = 100, only
// 2-byte aligned) are copied as the 16-byte-aligned 64-byte window that
// holds them; a quad's four nibbles become two bf16 pairs (lo, hi) for the
// mma, q's elements gathered to match (q_even, q_odd of each carrier), and
// fp32 values for P.V. The first design (one block of 8 warps per (b, head,
// tile), 2-byte synchronous loads a lane) took 0.142 ms at the GPT-3B
// verify, 6.9% of the bound.
//
// Plain C interface, loaded with ctypes. The launch goes on the caller's
// stream; the function returns cudaGetLastError() after the launch.
#include "flash_chunk.cuh"

// q (B, K, H*D) bf16; kv (B, S, H*D) int8 carriers ([k | v], H*D/2 each);
// sc (B, S, 2*H) f32; pos, bias, out, out_f32 and the plan as for
// flash_chunk_attention (csrc/flash_chunk.cu); split selects the split-rope
// pair layout. Returns a cudaError_t.
extern "C" int flash_chunk_q4(const void* q, const void* kv, const void* sc, const void* pos_ptr,
                              int pos_stride, int pos_scalar, const void* bias, void* out,
                              int out_f32, int B, int S, int H, int D, int K, int split, void* ws,
                              void* counters, int nq, int n_chunks, void* stream) {
  return chunk::dispatch<chunk::Int4Kv>(q, kv, sc, pos_ptr, pos_stride, pos_scalar, bias, out,
                                        out_f32, B, S, H, D, K, ws, counters, nq, n_chunks, split,
                                        stream);
}
