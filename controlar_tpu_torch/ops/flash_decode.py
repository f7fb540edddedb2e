"""Single-query decode attention over the interleaved [k|v] cache slab.

`flash_decode_attention` has the signature and semantics of the JAX
package's `flash_decode_attention2`: q (B, H*D), kv (B, S, 2*H*D) bf16 with
rows [k | v], pos a scalar or (B,) int32, an optional (B, S) f32 additive
column bias, rows > pos[b] excluded, online softmax in fp32, output (B, H*D)
in q's dtype. On a CUDA tensor it launches the hand-written kernel in
`csrc/flash_decode.cu`, which splits each (batch row, head) into chunks of
`CHUNK_ROWS[torch.bfloat16][D]` rows and merges their partials in chunk
order in the same launch (`split_plan`; workspace and counters from
`ops/_scratch.py`); on a CPU tensor it computes the same function with
`flash_decode_attention_ref`.

The quantized caches have their own kernels, with the same arguments plus
the per-row, per-head f32 scales `scale` (B, S, 2*H) = [k scales | v scales]
(unpadded: the JAX package pads this stream to 128 lanes for the TPU's DMA):

- `flash_decode_attention_q8` (`csrc/flash_decode_q8.cu`): int8 rows,
  split as the bf16 kernel is, in chunks of `Q8_CHUNK_ROWS[D]` rows;
- `flash_decode_attention_q8_append` (`csrc/flash_decode_q8.cu`, entry
  `flash_decode_q8_append`): the same over rows [0, pos[b]), plus row
  pos[b] scored from the operands new_kv (B, 2*H*D) int8 and new_s (B, 2*H)
  f32, which it also writes into the slabs at row pos[b];
- `flash_decode_attention_q4` (`csrc/flash_decode_q4.cu`): nibble-packed
  rows of 2 * H*D/2 carriers (unpadded: the JAX package pads each half to a
  multiple of 128 bytes), carrier j of a head holding the pair (2j, 2j+1)
  or, with split=True, the split-rope pair (j, D/2 + j); split as the bf16
  kernel is, in chunks of `CHUNK_ROWS[INT4][D]` rows.
"""
from __future__ import annotations

import ctypes
import functools
import math
from typing import NamedTuple, Optional, Union

import torch

from controlar_tpu_torch import _build
from controlar_tpu_torch.ops._scratch import _scratch_for
from controlar_tpu_torch.ops.w4_matmul import unpack_nibbles

HEAD_DIMS = (64, 100, 128)
INT4 = "int4"  # the nibble-packed cache's cache_dtype (its carriers are torch.int8)

Pos = Union[int, torch.Tensor]


def flash_decode_attention_ref(
    q: torch.Tensor,
    kv: torch.Tensor,
    pos: Pos,
    col_bias: Optional[torch.Tensor] = None,
    *,
    n_head: int,
) -> torch.Tensor:
    """Plain version: masked fp32 softmax over the whole slab. q is rounded to
    bf16 first, as the kernel reads it."""
    b, s, hd2 = kv.shape
    hd = hd2 // 2
    d = hd // n_head
    qf = q.to(torch.bfloat16).float().reshape(b, n_head, d)
    k = kv[..., :hd].float().reshape(b, s, n_head, d)
    v = kv[..., hd:].float().reshape(b, s, n_head, d)
    scores = torch.einsum("bhd,bshd->bhs", qf, k) * (1.0 / math.sqrt(d))
    out = torch.einsum("bhs,bshd->bhd", _softmax_rows(scores, pos, col_bias), v)
    return out.reshape(b, hd).to(q.dtype)


def _softmax_rows(scores: torch.Tensor, pos: Pos, col_bias: Optional[torch.Tensor]):
    """scores (B, H, S) fp32 -> probabilities over the rows <= pos[b], with
    the additive column bias."""
    if col_bias is not None:
        scores = scores + col_bias.float()[:, None, :]
    s = scores.shape[-1]
    pos_t = torch.as_tensor(pos, device=scores.device).reshape(-1, 1)
    allowed = torch.arange(s, device=scores.device)[None, :] <= pos_t
    return torch.softmax(scores.masked_fill(~allowed[:, None, :], float("-inf")), dim=-1)


def flash_decode_attention_q8_ref(
    q: torch.Tensor,
    kv: torch.Tensor,
    scale: torch.Tensor,
    pos: Pos,
    col_bias: Optional[torch.Tensor] = None,
    *,
    n_head: int,
) -> torch.Tensor:
    """Plain version of the int8-cache kernel, with the Pallas kernel's
    numerics: scores (k_int . q_bf16) * ks / sqrt(D), the v scale folded
    into p; p stays fp32 (the TPU kernel rounds p * vs to bf16)."""
    b, s, hd2 = kv.shape
    hd = hd2 // 2
    d = hd // n_head
    qf = q.to(torch.bfloat16).float().reshape(b, n_head, d)
    k = kv[..., :hd].float().reshape(b, s, n_head, d)
    v = kv[..., hd:].float().reshape(b, s, n_head, d)
    ks = scale[..., :n_head].float().transpose(1, 2)  # (B, H, S)
    vs = scale[..., n_head:2 * n_head].float().transpose(1, 2)
    scores = torch.einsum("bhd,bshd->bhs", qf, k) * ks * (1.0 / math.sqrt(d))
    probs = _softmax_rows(scores, pos, col_bias)
    out = torch.einsum("bhs,bshd->bhd", probs * vs, v)
    return out.reshape(b, hd).to(q.dtype)


def _q_halves(q: torch.Tensor, n_head: int, d: int, split: bool):
    """q (B, H*D) -> (even, odd) halves (B, H, D/2) of each head's pairs."""
    qh = q.to(torch.bfloat16).float().reshape(q.shape[0], n_head, d)
    if split:
        return qh[..., : d // 2], qh[..., d // 2:]
    return qh[..., 0::2], qh[..., 1::2]


def flash_decode_attention_q4_ref(
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
    """Plain version of the int4-cache kernel, with the Pallas kernel's
    numerics: scores (lo . q_even + hi . q_odd) * ks / sqrt(2 * (D/2)), the
    v scale folded into p (fp32 here, bf16 on the TPU), the output pairs put
    back in the layout of q."""
    b, s, _ = kv.shape
    half_d = head_dim // 2
    c = kv.reshape(b, s, 2, n_head, half_d)
    lo, hi = (t.float() for t in unpack_nibbles(c))
    qe, qo = _q_halves(q, n_head, head_dim, split)
    ks = scale[..., :n_head].float().transpose(1, 2)
    vs = scale[..., n_head:2 * n_head].float().transpose(1, 2)
    scores = (torch.einsum("bhj,bshj->bhs", qe, lo[:, :, 0])
              + torch.einsum("bhj,bshj->bhs", qo, hi[:, :, 0]))
    scores = scores * ks * (1.0 / math.sqrt(2 * half_d))
    pv = _softmax_rows(scores, pos, col_bias) * vs
    o_even = torch.einsum("bhs,bshj->bhj", pv, lo[:, :, 1])
    o_odd = torch.einsum("bhs,bshj->bhj", pv, hi[:, :, 1])
    if split:
        out = torch.cat([o_even, o_odd], dim=-1)
    else:
        out = torch.stack([o_even, o_odd], dim=-1)
    return out.reshape(b, n_head * 2 * half_d).to(q.dtype)


def _check(q, kv, pos, col_bias, n_head, kv_dtype=torch.bfloat16, int4_head_dim=None,
           chunk=False):
    """Checks shared by the decode and chunk kernels; returns (B, S, D). The
    int4 slab has rows of H*D bytes (2 * H * D/2 carriers), the others 2*H*D
    values. q is (B, H*D), or with chunk=True (B, K, H*D)."""
    if kv.dim() != 3 or kv.dtype != kv_dtype:
        raise ValueError(f"kv must be 3-D {kv_dtype}, got {tuple(kv.shape)} {kv.dtype}")
    b, s, width = kv.shape
    if int4_head_dim is not None:  # the int4 row width does not give D
        d = int4_head_dim
        if width != n_head * d or d % 2:
            raise ValueError(f"int4 kv rows must hold {n_head} x {d} nibbles, got width {width}")
        hd = n_head * d
    else:
        hd = width // 2
        if width % 2 or hd % n_head:
            raise ValueError(f"kv row width {width} does not split into 2 x {n_head} heads")
        d = hd // n_head
    if d not in HEAD_DIMS:
        raise ValueError(f"head_dim {d} not supported by the kernel (takes {HEAD_DIMS})")
    q_ok = (q.dim() == 3 and q.shape[0] == b and q.shape[2] == hd) if chunk else q.shape == (b, hd)
    if not q_ok or q.dtype not in (torch.bfloat16, torch.float32):
        want = f"({b}, K, {hd})" if chunk else f"({b}, {hd})"
        raise ValueError(f"q must be {want} bf16/f32, got {tuple(q.shape)} {q.dtype}")
    tensors = [q, kv]
    if isinstance(pos, torch.Tensor):
        if pos.dtype != torch.int32 or pos.numel() not in (1, b) or pos.dim() > 1:
            raise ValueError(f"pos must be int32 scalar or ({b},), got {tuple(pos.shape)} {pos.dtype}")
        tensors.append(pos)
    if col_bias is not None:
        if col_bias.shape != (b, s) or col_bias.dtype != torch.float32:
            raise ValueError(f"col_bias must be ({b}, {s}) float32, got "
                             f"{tuple(col_bias.shape)} {col_bias.dtype}")
        tensors.append(col_bias)
    for t in tensors:
        if t.device != kv.device:
            raise ValueError(f"all operands must be on {kv.device}, got {t.device}")
        if not t.is_contiguous():
            raise ValueError("operands must be contiguous")
    if kv.device.index != torch.cuda.current_device():
        raise ValueError(f"kv is on {kv.device}, the current device is cuda:"
                         f"{torch.cuda.current_device()}")
    align = 16 if d % 8 == 0 else 8
    if kv.data_ptr() % align or q.data_ptr() % align:
        raise ValueError(f"q and kv must be {align}-byte aligned")
    return b, s, d


def _check_scale(scale, kv, n_head):
    b, s = kv.shape[:2]
    if scale.shape != (b, s, 2 * n_head) or scale.dtype != torch.float32:
        raise ValueError(f"scale must be ({b}, {s}, {2 * n_head}) float32, got "
                         f"{tuple(scale.shape)} {scale.dtype}")
    if scale.device != kv.device or not scale.is_contiguous():
        raise ValueError(f"scale must be contiguous on {kv.device}")


def _pos_args(pos: Pos, b: int):
    """-> (pointer or None, stride, scalar) as the kernels take pos."""
    if isinstance(pos, torch.Tensor):
        return pos.data_ptr(), int(pos.numel() == b and pos.dim() == 1), 0
    return None, 0, int(pos)


# The split decode kernels (csrc/flash_decode.cu for the bf16 cache,
# csrc/flash_decode_q8.cu for int8, csrc/flash_decode_q4.cu for int4) cut
# each batch row's live cache rows into chunks of this many rows, one work
# item per (row, head, chunk): a constant of D, so that a row's partition,
# and its output bit for bit, depend on its own pos only. Each kernel checks
# that it was built with the same value. The int4 cache has its own key: its
# carriers are torch.int8, whose lengths are the int8 kernel's. Its length is
# the same at every D, the verify kernels' `chunk::kChunk`
# (csrc/flash_chunk.cuh), which the int4 kernel takes.
CHUNK_ROWS = {
    torch.bfloat16: {64: 64, 100: 32, 128: 128},
    torch.int8: {64: 64, 100: 32, 128: 32},
    INT4: {64: 64, 100: 64, 128: 64},
}
Q8_CHUNK_ROWS = CHUNK_ROWS[torch.int8]


class SplitPlan(NamedTuple):
    chunk: int      # cache rows per work item
    n_chunks: int   # work items per (batch row, head)
    ws_floats: int  # fp32 workspace: a partial (acc[D], m, l, 2 spare) per work item
    counters: int   # int32 arrival counters, one per (batch row, head)


def split_plan(b: int, s: int, n_head: int, d: int, pos: Pos, stacked: bool,
               cache) -> SplitPlan:
    """The launch plan of the split decode kernels over a cache of the
    `CHUNK_ROWS` key `cache` (torch.bfloat16, torch.int8 or INT4) for B = b
    rows over S = s cache rows. A stacked call (and the fused append)
    attends over rows [0, pos[b]) of the slab plus the in-flight row, a flat
    one over rows [0, pos[b]]. For an int pos the grid
    holds the live chunks; for a pos tensor, whose values stay on the device,
    it covers the whole cache and the work items past a row's live chunks
    exit. It reads no SM count: the chunk length is fixed by D."""
    if isinstance(pos, torch.Tensor):
        rows = s + int(stacked)
    elif stacked:
        rows = min(max(pos, 0), s) + 1
    else:
        rows = min(max(pos + 1, 0), s)
    return _split_plan(b, n_head, d, rows, cache)


def q8_plan(b: int, s: int, n_head: int, d: int, pos: Pos, stacked: bool) -> SplitPlan:
    """`split_plan` of the int8 kernels."""
    return split_plan(b, s, n_head, d, pos, stacked, torch.int8)


@functools.lru_cache(maxsize=4096)
def _split_plan(b: int, n_head: int, d: int, rows: int, cache) -> SplitPlan:
    chunk = CHUNK_ROWS[cache][d]
    n_chunks = max(1, -(-rows // chunk))
    return SplitPlan(chunk, n_chunks, b * n_head * n_chunks * (d + 4), b * n_head)


def _split_args(cache, kv: torch.Tensor, b: int, s: int, n_head: int, d: int, pos: Pos,
                stacked: bool) -> tuple:
    """-> the trailing arguments of a split kernel's C entry: workspace,
    counters, chunk, n_chunks and the stream, with the workspace and
    counters taken from the stream's scratch (no allocation once it has
    grown to the call's size). cache: the `CHUNK_ROWS` key of the kernel
    (never read from kv's dtype: int4 carriers are int8); kv: the slab or
    stack."""
    plan = split_plan(b, s, n_head, d, pos, stacked, cache)
    stream = torch.cuda.current_stream(kv.device).cuda_stream
    counters, ws = _scratch_for(kv.device, stream, plan.counters, plan.ws_floats)
    return ws.data_ptr(), counters.data_ptr(), plan.chunk, plan.n_chunks, stream


def _split_lib(source: str, fn: str, n_ptr: int, layer: bool = False, split: bool = False):
    """The C entry `fn` of a split kernel's csrc/<source>.cu: n_ptr pointers
    (q, the slab or the in-flight row and the stack, scales), [layer,] pos,
    pos_stride, pos_scalar, bias, out, out_f32, B, S, H, D, [split,] ws,
    counters, chunk, n_chunks, stream."""
    return _bind(getattr(_build.load(source), fn), n_ptr, layer, split)


def _bind(f, n_ptr: int, layer: bool, split: bool):
    """f with the split kernels' argument types set (see `_split_lib`)."""
    if f.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        f.argtypes = ([p] * n_ptr + [i] * layer + [p, i, i, p, p, i, i, i, i, i] + [i] * split
                      + [p, p, i, i, p])
        f.restype = ctypes.c_int
    return f


def flash_decode_attention(
    q: torch.Tensor,
    kv: torch.Tensor,
    pos: Pos,
    col_bias: Optional[torch.Tensor] = None,
    *,
    n_head: int,
) -> torch.Tensor:
    """Decode attention for one query per row; see the module docstring."""
    if kv.device.type == "cpu":
        return flash_decode_attention_ref(q, kv, pos, col_bias, n_head=n_head)
    if kv.device.type != "cuda":
        raise ValueError(f"unsupported device {kv.device}")
    b, s, d = _check(q, kv, pos, col_bias, n_head)
    qb = q if q.dtype == torch.bfloat16 else q.to(torch.bfloat16)
    out = torch.empty((b, n_head * d), dtype=q.dtype, device=q.device)
    err = _split_lib("flash_decode", "flash_decode_attention", 2)(
        qb.data_ptr(), kv.data_ptr(), *_pos_args(pos, b),
        None if col_bias is None else col_bias.data_ptr(), out.data_ptr(),
        int(out.dtype == torch.float32), b, s, n_head, d,
        *_split_args(torch.bfloat16, kv, b, s, n_head, d, pos, stacked=False),
    )
    if err != 0:
        raise RuntimeError(f"flash_decode_attention launch failed: cudaError {err}")
    flash_decode_attention.launches += 1
    return out


flash_decode_attention.launches = 0


def flash_decode_attention_q8(
    q: torch.Tensor,
    kv: torch.Tensor,
    scale: torch.Tensor,
    pos: Pos,
    col_bias: Optional[torch.Tensor] = None,
    *,
    n_head: int,
) -> torch.Tensor:
    """Decode attention over the int8 cache; see the module docstring."""
    if kv.device.type == "cpu":
        return flash_decode_attention_q8_ref(q, kv, scale, pos, col_bias, n_head=n_head)
    if kv.device.type != "cuda":
        raise ValueError(f"unsupported device {kv.device}")
    b, s, d = _check(q, kv, pos, col_bias, n_head, kv_dtype=torch.int8)
    _check_scale(scale, kv, n_head)
    qb = q if q.dtype == torch.bfloat16 else q.to(torch.bfloat16)
    out = torch.empty((b, n_head * d), dtype=q.dtype, device=q.device)
    err = _split_lib("flash_decode_q8", "flash_decode_q8", 3)(
        qb.data_ptr(), kv.data_ptr(), scale.data_ptr(), *_pos_args(pos, b),
        None if col_bias is None else col_bias.data_ptr(), out.data_ptr(),
        int(out.dtype == torch.float32), b, s, n_head, d,
        *_split_args(torch.int8, kv, b, s, n_head, d, pos, stacked=False),
    )
    if err != 0:
        raise RuntimeError(f"flash_decode_attention_q8 launch failed: cudaError {err}")
    flash_decode_attention_q8.launches += 1
    return out


flash_decode_attention_q8.launches = 0


def _write_row(slab: torch.Tensor, row: torch.Tensor, pos: Pos) -> None:
    """Writes row (B, W) into slab (B, S, W) at row pos[b], in place."""
    if isinstance(pos, torch.Tensor):
        b = slab.shape[0]
        p = pos.to(slab.device).long().reshape(-1).expand(b)
        slab[torch.arange(b, device=slab.device), p] = row.to(slab.dtype)
    else:
        slab[:, pos] = row.to(slab.dtype)


def flash_decode_attention_q8_append_ref(
    q: torch.Tensor,
    new_kv: torch.Tensor,
    new_s: torch.Tensor,
    kv_cache: torch.Tensor,
    kv_scale: torch.Tensor,
    pos: Pos,
    col_bias: Optional[torch.Tensor] = None,
    *,
    n_head: int,
):
    """Plain version of `flash_decode_attention_q8_append`: writes the row
    and its scales at row pos[b] of the slabs (in place), then runs
    `flash_decode_attention_q8_ref` over rows [0, pos[b]]. Returns
    (out, kv_cache, kv_scale)."""
    _write_row(kv_cache, new_kv, pos)
    _write_row(kv_scale, new_s, pos)
    out = flash_decode_attention_q8_ref(q, kv_cache, kv_scale, pos, col_bias, n_head=n_head)
    return out, kv_cache, kv_scale


def _check_new_row(new_kv, new_s, kv, n_head, d):
    b, _, width = kv.shape
    if new_kv.shape != (b, width) or new_kv.dtype != torch.int8:
        raise ValueError(f"new_kv must be ({b}, {width}) int8, got {tuple(new_kv.shape)} "
                         f"{new_kv.dtype}")
    if new_s.shape != (b, 2 * n_head) or new_s.dtype != torch.float32:
        raise ValueError(f"new_s must be ({b}, {2 * n_head}) float32, got "
                         f"{tuple(new_s.shape)} {new_s.dtype}")
    for t in (new_kv, new_s):
        if t.device != kv.device or not t.is_contiguous():
            raise ValueError(f"new_kv and new_s must be contiguous on {kv.device}")
    if new_kv.data_ptr() % (16 if d % 8 == 0 else 8):
        raise ValueError("new_kv is not aligned")


def flash_decode_attention_q8_append(
    q: torch.Tensor,
    new_kv: torch.Tensor,
    new_s: torch.Tensor,
    kv_cache: torch.Tensor,
    kv_scale: torch.Tensor,
    pos: Pos,
    col_bias: Optional[torch.Tensor] = None,
    *,
    n_head: int,
):
    """Decode attention over the int8 cache with this step's row in flight.

    Attends over rows [0, pos[b]) of kv_cache (B, S, 2*H*D) int8 and
    kv_scale (B, S, 2*H) f32, and over row pos[b] taken from the operands
    new_kv (B, 2*H*D) int8 and new_s (B, 2*H) f32; writes that row and its
    scales into kv_cache and kv_scale at row pos[b], in place (the JAX
    kernel donates and aliases the slabs for the same effect). Returns
    (out (B, H*D) in q's dtype, kv_cache, kv_scale).

    pos is an int or a (B,) int32 tensor and must be >= 1, as in decode,
    where a prefill precedes the step: an int below 1 or past the cache
    raises. A tensor is not read back: on the card a slot whose pos[b] lies
    outside [0, S) leaves the slabs unwritten and still returns an output
    (rows [0, min(pos[b], S)) and the operand row), where the plain version
    raises; callers keep per-slot positions in [1, S). col_bias (B, S) f32,
    when given, must be 0 at column pos[b] (prefix masks only): the kernel
    adds no bias to the in-flight row and does not check it.
    """
    if isinstance(pos, int) and not 1 <= pos < kv_cache.shape[1]:
        raise ValueError(f"pos must lie in [1, {kv_cache.shape[1]}), got {pos}")
    if kv_cache.device.type == "cpu":
        return flash_decode_attention_q8_append_ref(q, new_kv, new_s, kv_cache, kv_scale, pos,
                                                    col_bias, n_head=n_head)
    if kv_cache.device.type != "cuda":
        raise ValueError(f"unsupported device {kv_cache.device}")
    b, s, d = _check(q, kv_cache, pos, col_bias, n_head, kv_dtype=torch.int8)
    _check_scale(kv_scale, kv_cache, n_head)
    _check_new_row(new_kv, new_s, kv_cache, n_head, d)
    qb = q if q.dtype == torch.bfloat16 else q.to(torch.bfloat16)
    out = torch.empty((b, n_head * d), dtype=q.dtype, device=q.device)
    err = _split_lib("flash_decode_q8", "flash_decode_q8_append", 5)(
        qb.data_ptr(), new_kv.data_ptr(), new_s.data_ptr(), kv_cache.data_ptr(),
        kv_scale.data_ptr(), *_pos_args(pos, b),
        None if col_bias is None else col_bias.data_ptr(), out.data_ptr(),
        int(out.dtype == torch.float32), b, s, n_head, d,
        *_split_args(torch.int8, kv_cache, b, s, n_head, d, pos, stacked=True))
    if err != 0:
        raise RuntimeError(f"flash_decode_attention_q8_append launch failed: cudaError {err}")
    flash_decode_attention_q8_append.launches += 1
    return out, kv_cache, kv_scale


flash_decode_attention_q8_append.launches = 0


def flash_decode_attention_q4(
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
    """Decode attention over the int4 cache; see the module docstring."""
    if kv.device.type == "cpu":
        return flash_decode_attention_q4_ref(q, kv, scale, pos, col_bias, n_head=n_head,
                                             head_dim=head_dim, split=split)
    if kv.device.type != "cuda":
        raise ValueError(f"unsupported device {kv.device}")
    b, s, d = _check(q, kv, pos, col_bias, n_head, kv_dtype=torch.int8,
                     int4_head_dim=head_dim)
    _check_scale(scale, kv, n_head)
    qb = q if q.dtype == torch.bfloat16 else q.to(torch.bfloat16)
    out = torch.empty((b, n_head * d), dtype=q.dtype, device=q.device)
    err = _split_lib("flash_decode_q4", "flash_decode_q4", 3, split=True)(
        qb.data_ptr(), kv.data_ptr(), scale.data_ptr(), *_pos_args(pos, b),
        None if col_bias is None else col_bias.data_ptr(), out.data_ptr(),
        int(out.dtype == torch.float32), b, s, n_head, d, int(split),
        *_split_args(INT4, kv, b, s, n_head, d, pos, stacked=False),
    )
    if err != 0:
        raise RuntimeError(f"flash_decode_attention_q4 launch failed: cudaError {err}")
    flash_decode_attention_q4.launches += 1
    return out


flash_decode_attention_q4.launches = 0
