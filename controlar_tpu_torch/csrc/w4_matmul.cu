// x @ W4: bf16 activations times int4 group-quantized weights, fp32 sums.
//
// Replaces the Pallas kernel `_w4_kernel` of controlar_tpu/ops/w4_matmul.py
// (w4_matmul). out[b, n] = sum over planes P of s[P, n] * sum_{k in P}
// x[b, k] * q[k, n], q unpacked from the group-pair-plane carriers.
//
// Bound: bytes at the decode shapes. The product is skinny (16 rows on the
// decode path, 64 in the speculative verify, at most 256 routed here), so
// the carriers dominate: GPT-3B wqkv (3200 -> 9600) streams 15.4 MB of
// carriers and 0.6 MB of scales per call against 2 * 16 * 3200 * 9600
// flops, ~64 flops per carrier byte at 16 rows and ~256 at 64, under the
// card's ~295 bf16 flops a byte.
//
// The design (the tile routine is csrc/w4_tile.cuh): the products run on
// the tensor cores (mma.sync, nibbles dequantized to bf16 in registers) over
// an asynchronous ring of carrier and x tiles, so the bytes of the next
// stages stay in flight while a stage is multiplied. An item is 128 columns
// x 16 rows (32 past 16 rows) over a slice of K: the wrapper splits K into
// `splits` balanced chunk ranges, chosen from (K, N) and the card's SM count
// so that the narrow products (N = 3200: 25 column tiles) fill the card,
// never from B. Each split's block writes its fp32 partial to a workspace
// and arrives at a per-tile counter; the last arrival sums the partials in
// split order and writes the tile, so the result is the same bit for bit
// from launch to launch and for a row whatever rows share the call. The
// last arrival also resets the counter, which the wrapper keeps zeroed.
// One launch per call.
//
// Plain C interface, loaded with ctypes. The launch goes on the caller's
// stream; the function returns cudaGetLastError() after the launch.
#include "w4_tile.cuh"

namespace {

template <int WN, typename OutT>
__global__ void __launch_bounds__(w4::kThreads, 3)
w4_matmul_kernel(w4::Operand op, OutT* __restrict__ out, float* ws, int* counters, int splits) {
  extern __shared__ __align__(128) uint8_t smem[];
  constexpr int RT = w4::Cfg<WN>::RT;
  const int row_tiles = (op.B + RT - 1) / RT;
  // row tile fastest, then split, then column tile: the row tiles of a
  // column tile run side by side and share its carriers in L2
  const int r = blockIdx.x % row_tiles;
  const int split = (blockIdx.x / row_tiles) % splits;
  const int ct = blockIdx.x / (row_tiles * splits);
  const int n0 = ct * w4::TN, m0 = r * RT;
  const int nch = w4::nchunk(op);
  w4::Frags<WN> acc;
  w4::item<WN>(op, n0, m0, w4::split_begin(nch, split, splits),
               w4::split_begin(nch, split + 1, splits), smem, acc);
  if (w4::reduce<WN>(op.B, op.N, n0, m0, split, splits, ws, counters + ct * row_tiles + r, acc)) {
    w4::store<WN>(op.B, op.N, n0, m0, acc, out);
  }
}

template <int WN, typename OutT>
int launch(const w4::Operand& op, void* out, float* ws, int* counters, int splits,
           cudaStream_t stream) {
  constexpr int RT = w4::Cfg<WN>::RT;
  constexpr int smem = w4::Cfg<WN>::kSmemBytes;
  auto* kernel = w4_matmul_kernel<WN, OutT>;
  static const cudaError_t attr =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  const int blocks = (op.N + w4::TN - 1) / w4::TN * splits * ((op.B + RT - 1) / RT);
  kernel<<<blocks, w4::kThreads, smem, stream>>>(op, static_cast<OutT*>(out), ws, counters,
                                                 splits);
  return static_cast<int>(cudaGetLastError());
}

template <typename OutT>
int dispatch(const w4::Operand& op, void* out, float* ws, int* counters, int splits,
             cudaStream_t stream) {
  // two n8 tiles up to 16 rows (the decode path), four past it
  return op.B <= 16 ? launch<2, OutT>(op, out, ws, counters, splits, stream)
                    : launch<4, OutT>(op, out, ws, counters, splits, stream);
}

}  // namespace

// x (B, nfull*G) bf16; q4 (Kp/2, N) int8; s (Kp/G, N) f32; out (B, N) f32
// when out_f32, else bf16; N a multiple of 16. K is cut into `splits`
// chunk ranges (1 <= splits <= ceil(nfull / 2)); with more than one, ws is
// (splits, B, N) f32 scratch and counters holds ceil(N / 128) * ceil(B / 16)
// ints, zero on entry and left zero. Returns a cudaError_t.
extern "C" int w4_matmul(const void* x, const void* q4, const void* s, void* out, void* ws,
                         void* counters, int out_f32, int B, int nfull, int N, int splits,
                         void* stream) {
  if (B < 1 || nfull < 1 || N < 16 || N % 16 || splits < 1 || splits > (nfull + 1) / 2 ||
      (splits > 1 && (ws == nullptr || counters == nullptr))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const w4::Operand op{static_cast<const __nv_bfloat16*>(x), static_cast<const int8_t*>(q4),
                       static_cast<const float*>(s), B, nfull, N};
  auto* wsp = static_cast<float*>(ws);
  auto* cp = static_cast<int*>(counters);
  auto st = static_cast<cudaStream_t>(stream);
  return out_f32 ? dispatch<float>(op, out, wsp, cp, splits, st)
                 : dispatch<__nv_bfloat16>(op, out, wsp, cp, splits, st);
}
