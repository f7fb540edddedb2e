"""K-query chunk attention over the interleaved [k|v] cache slab.

The speculative verify and chunked-prefill primitive, with the signatures
and semantics of the JAX package's `ops/flash_chunk.py`: q (B, K, H*D), pos
(B,) int32 base positions (a scalar is taken too), an optional (B, S) f32
additive column bias, output (B, K, H*D) in q's dtype. Query j of row b
attends to the cache rows r <= pos[b] + j (the chunk's own rows are written
before the call), with the bias added everywhere except on the query's own
row r == pos[b] + j (the diagonal exception: a fully masked left-padded
caption row keeps one finite score); online softmax in fp32.

- `flash_chunk_attention`: kv (B, S, 2*H*D) bf16 (`csrc/flash_chunk.cu`);
- `flash_chunk_attention_q8`: kv int8 with the per-row, per-head f32 scales
  `scale` (B, S, 2*H) = [k scales | v scales], unpadded (the same source);
- `flash_chunk_attention_q4`: nibble-packed rows of 2 * H*D/2 carriers,
  interleaved or, with split=True, split-rope pairs, as
  `flash_decode_attention_q4` takes them (`csrc/flash_chunk_q4.cu`).

On a CUDA tensor each launches its kernel; on a CPU tensor it computes the
same function with its plain version (`*_ref`), a masked einsum over the
(dequantized) slab with the kernels' numerics: q rounded to bf16, scores
scaled by the k scale after the dot product, the v scale folded into p.

The kernels (`csrc/flash_chunk.cuh`) split each (batch row, head, tile of
up to 8 queries) into chunks of `CHUNK_ROWS` cache rows, one warp each,
and merge the parts in chunk order in the same launch; `chunk_plan` gives
the grid, and the workspace and arrival counters come from the stream's
scratch (`ops/_scratch.py`), so a call allocates only its output.
"""
from __future__ import annotations

import ctypes
import functools
import math
from typing import NamedTuple, Optional

import torch

from controlar_tpu_torch import _build
from controlar_tpu_torch.ops._scratch import _scratch_for
from controlar_tpu_torch.ops.flash_decode import Pos, _check, _check_scale, _pos_args
from controlar_tpu_torch.ops.w4_matmul import unpack_nibbles


def _chunk_probs(scores: torch.Tensor, pos: Pos, col_bias: Optional[torch.Tensor]):
    """scores (B, H, K, S) fp32 -> probabilities of query j over the rows
    <= pos[b] + j, with the additive column bias off the query's own row."""
    k, s = scores.shape[-2:]
    dev = scores.device
    own = (torch.as_tensor(pos, device=dev).reshape(-1, 1, 1)
           + torch.arange(k, device=dev)[None, :, None])  # (B|1, K, 1)
    cols = torch.arange(s, device=dev)[None, None, :]
    if col_bias is not None:
        bias = torch.where(cols == own, 0.0, col_bias.float()[:, None, :])  # (B, K, S)
        scores = scores + bias[:, None]
    allowed = (cols <= own)[:, None]
    return torch.softmax(scores.masked_fill(~allowed, float("-inf")), dim=-1)


def _heads(q: torch.Tensor, n_head: int) -> torch.Tensor:
    """q (B, K, H*D) -> bf16-rounded fp32 (B, K, H, D), as the kernels read it."""
    b, k, hd = q.shape
    return q.to(torch.bfloat16).float().reshape(b, k, n_head, hd // n_head)


def _kv_scales(scale: torch.Tensor, n_head: int):
    """(B, S, 2H) -> k and v scales, each (B, H, 1, S) fp32."""
    ks = scale[..., :n_head].float().transpose(1, 2)[:, :, None, :]
    vs = scale[..., n_head:2 * n_head].float().transpose(1, 2)[:, :, None, :]
    return ks, vs


def flash_chunk_attention_ref(
    q: torch.Tensor,
    kv: torch.Tensor,
    pos: Pos,
    col_bias: Optional[torch.Tensor] = None,
    *,
    n_head: int,
) -> torch.Tensor:
    """Plain version of the bf16 chunk kernel."""
    b, s, hd2 = kv.shape
    hd = hd2 // 2
    d = hd // n_head
    k = kv[..., :hd].float().reshape(b, s, n_head, d)
    v = kv[..., hd:].float().reshape(b, s, n_head, d)
    scores = torch.einsum("bjhd,bshd->bhjs", _heads(q, n_head), k) * (1.0 / math.sqrt(d))
    out = torch.einsum("bhjs,bshd->bjhd", _chunk_probs(scores, pos, col_bias), v)
    return out.reshape(q.shape).to(q.dtype)


def flash_chunk_attention_q8_ref(
    q: torch.Tensor,
    kv: torch.Tensor,
    scale: torch.Tensor,
    pos: Pos,
    col_bias: Optional[torch.Tensor] = None,
    *,
    n_head: int,
) -> torch.Tensor:
    """Plain version of the int8 chunk kernel."""
    b, s, hd2 = kv.shape
    hd = hd2 // 2
    d = hd // n_head
    k = kv[..., :hd].float().reshape(b, s, n_head, d)
    v = kv[..., hd:].float().reshape(b, s, n_head, d)
    ks, vs = _kv_scales(scale, n_head)
    scores = torch.einsum("bjhd,bshd->bhjs", _heads(q, n_head), k) * ks * (1.0 / math.sqrt(d))
    out = torch.einsum("bhjs,bshd->bjhd", _chunk_probs(scores, pos, col_bias) * vs, v)
    return out.reshape(q.shape).to(q.dtype)


def flash_chunk_attention_q4_ref(
    q: torch.Tensor,
    kv: torch.Tensor,
    scale: torch.Tensor,
    pos: Pos,
    col_bias: Optional[torch.Tensor] = None,
    *,
    n_head: int,
    head_dim: int,
    split: bool = False,
) -> torch.Tensor:
    """Plain version of the int4 chunk kernel: scores (lo . q_even + hi .
    q_odd) * ks / sqrt(2 * (D/2)), the output pairs put back in q's layout."""
    b, s, _ = kv.shape
    half_d = head_dim // 2
    lo, hi = (t.float() for t in unpack_nibbles(kv.reshape(b, s, 2, n_head, half_d)))
    qh = _heads(q, n_head)
    qe, qo = (qh[..., :half_d], qh[..., half_d:]) if split else (qh[..., 0::2], qh[..., 1::2])
    ks, vs = _kv_scales(scale, n_head)
    scores = (torch.einsum("bjhi,bshi->bhjs", qe, lo[:, :, 0])
              + torch.einsum("bjhi,bshi->bhjs", qo, hi[:, :, 0]))
    pv = _chunk_probs(scores * ks * (1.0 / math.sqrt(2 * half_d)), pos, col_bias) * vs
    o_even = torch.einsum("bhjs,bshi->bjhi", pv, lo[:, :, 1])
    o_odd = torch.einsum("bhjs,bshi->bjhi", pv, hi[:, :, 1])
    out = torch.cat([o_even, o_odd], -1) if split else torch.stack([o_even, o_odd], -1)
    return out.reshape(q.shape).to(q.dtype)


# The chunk kernels cut the rows a query tile sees into chunks of this many
# rows, one work item per (batch row, head, tile, chunk): one constant for
# every slab and D, the kernels' `chunk::kChunk` (csrc/flash_chunk.cuh), so
# that a row's partition, and its output bit for bit, depend on its own pos
# only.
CHUNK_ROWS = 64


class ChunkPlan(NamedTuple):
    nq: int         # queries a tile (2, 4 or 8)
    n_tiles: int    # tiles, ceil(K / nq)
    n_chunks: int   # work items of CHUNK_ROWS rows a (batch row, head, tile)
    ws_floats: int  # fp32 workspace: a part of nq x (acc[D], m, l, 2 spare) a work item
    counters: int   # int32 arrival counters, one a (batch row, head, tile)


def chunk_tile(k: int) -> int:
    """Queries a tile: the smallest of 2, 4 and 8 that holds K, at most 8."""
    return 2 if k <= 2 else (4 if k <= 4 else 8)


def chunk_plan(b: int, s: int, n_head: int, d: int, k: int, pos: Pos) -> ChunkPlan:
    """The launch plan of the chunk kernels over a slab of S = s rows for
    B = b rows and K = k queries. The last query of a row sees rows
    [0, pos + K): for an int pos the grid holds those rows' chunks; for a
    pos tensor, whose values stay on the device, it covers the whole cache
    and the work items past a tile's rows exit. It reads no SM count."""
    rows = s if isinstance(pos, torch.Tensor) else min(max(pos + k, 0), s)
    return _chunk_plan(b, n_head, d, k, rows)


@functools.lru_cache(maxsize=4096)
def _chunk_plan(b: int, n_head: int, d: int, k: int, rows: int) -> ChunkPlan:
    nq = chunk_tile(k)
    n_tiles = -(-k // nq)
    n_chunks = max(1, -(-rows // CHUNK_ROWS))
    tiles = b * n_head * n_tiles
    return ChunkPlan(nq, n_tiles, n_chunks, tiles * n_chunks * nq * (d + 4), tiles)


@functools.lru_cache(maxsize=None)
def _entry(src: str, fn: str, scaled: bool, split: bool):
    """The C entry fn of csrc/<src>.cu: q, kv, [scale,] pos, pos_stride,
    pos_scalar, bias, out, out_f32, B, S, H, D, K, [split,] ws, counters, nq,
    n_chunks, stream."""
    f = getattr(_build.load(src), fn)
    p, i = ctypes.c_void_p, ctypes.c_int
    f.argtypes = ([p, p] + [p] * scaled + [p, i, i, p, p, i, i, i, i, i, i] + [i] * split
                  + [p, p, i, i, p])
    f.restype = ctypes.c_int
    return f


def _launch(wrapper: str, f, q, kv, scale, pos, col_bias, n_head, d, split=()):
    """Allocate the output and launch the C entry f (`_entry`) with the
    stream's scratch; raise on a launch error."""
    if kv.data_ptr() % 16:
        raise ValueError(f"{wrapper}: kv must be 16-byte aligned")
    b, k = q.shape[:2]
    s = kv.shape[1]
    plan = chunk_plan(b, s, n_head, d, k, pos)
    stream = torch.cuda.current_stream(kv.device).cuda_stream
    counters, ws = _scratch_for(kv.device, stream, plan.counters, plan.ws_floats)
    qb = q if q.dtype == torch.bfloat16 else q.to(torch.bfloat16)
    out = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    err = f(qb.data_ptr(), kv.data_ptr(), *scale, *_pos_args(pos, b),
            None if col_bias is None else col_bias.data_ptr(), out.data_ptr(),
            int(out.dtype == torch.float32), b, s, n_head, d, k, *split, ws.data_ptr(),
            counters.data_ptr(), plan.nq, plan.n_chunks, stream)
    if err != 0:
        raise RuntimeError(f"{wrapper} launch failed: cudaError {err}")
    return out


def flash_chunk_attention(
    q: torch.Tensor,
    kv: torch.Tensor,
    pos: Pos,
    col_bias: Optional[torch.Tensor] = None,
    *,
    n_head: int,
) -> torch.Tensor:
    """Chunk attention over the bf16 cache; see the module docstring."""
    if kv.device.type == "cpu":
        return flash_chunk_attention_ref(q, kv, pos, col_bias, n_head=n_head)
    if kv.device.type != "cuda":
        raise ValueError(f"unsupported device {kv.device}")
    _, _, d = _check(q, kv, pos, col_bias, n_head, chunk=True)
    f = _entry("flash_chunk", "flash_chunk_attention", False, False)
    out = _launch("flash_chunk_attention", f, q, kv, (), pos, col_bias, n_head, d)
    flash_chunk_attention.launches += 1
    return out


flash_chunk_attention.launches = 0


def flash_chunk_attention_q8(
    q: torch.Tensor,
    kv: torch.Tensor,
    scale: torch.Tensor,
    pos: Pos,
    col_bias: Optional[torch.Tensor] = None,
    *,
    n_head: int,
) -> torch.Tensor:
    """Chunk attention over the int8 cache; see the module docstring."""
    if kv.device.type == "cpu":
        return flash_chunk_attention_q8_ref(q, kv, scale, pos, col_bias, n_head=n_head)
    if kv.device.type != "cuda":
        raise ValueError(f"unsupported device {kv.device}")
    _, _, d = _check(q, kv, pos, col_bias, n_head, kv_dtype=torch.int8, chunk=True)
    _check_scale(scale, kv, n_head)
    f = _entry("flash_chunk", "flash_chunk_q8", True, False)
    out = _launch("flash_chunk_attention_q8", f, q, kv, (scale.data_ptr(),), pos, col_bias,
                  n_head, d)
    flash_chunk_attention_q8.launches += 1
    return out


flash_chunk_attention_q8.launches = 0


def flash_chunk_attention_q4(
    q: torch.Tensor,
    kv: torch.Tensor,
    scale: torch.Tensor,
    pos: Pos,
    col_bias: Optional[torch.Tensor] = None,
    *,
    n_head: int,
    head_dim: int,
    split: bool = False,
) -> torch.Tensor:
    """Chunk attention over the int4 cache; see the module docstring."""
    if kv.device.type == "cpu":
        return flash_chunk_attention_q4_ref(q, kv, scale, pos, col_bias, n_head=n_head,
                                            head_dim=head_dim, split=split)
    if kv.device.type != "cuda":
        raise ValueError(f"unsupported device {kv.device}")
    _, _, d = _check(q, kv, pos, col_bias, n_head, kv_dtype=torch.int8, int4_head_dim=head_dim,
                     chunk=True)
    _check_scale(scale, kv, n_head)
    f = _entry("flash_chunk_q4", "flash_chunk_q4", True, True)
    out = _launch("flash_chunk_attention_q4", f, q, kv, (scale.data_ptr(),), pos, col_bias,
                  n_head, d, (int(split),))
    flash_chunk_attention_q4.launches += 1
    return out


flash_chunk_attention_q4.launches = 0
