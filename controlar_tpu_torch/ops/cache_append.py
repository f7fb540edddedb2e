"""KV-cache writes: the fused write of a layer's new k/v rows, the stacked
cache's end-of-step write, and the per-slot row and block appends of one
stream.

`append_kv(cache, k, v, pos, kv_heads=..., split=...)` writes a layer's new
rows k, v (B, T, KV*D) at rows pos[b] + t of every stream of the layer's
cache, quantized to the cache's format: the `[k|v]` row of a floating
(B, S, 2*KV*D) cache; the per-head int8 rows and f32 scales of an int8
cache {"kv", "s"}; the nibble-packed int4 carriers (pairs (2j, 2j+1), or
(j, D/2 + j) with split=True, which other caches ignore) and the scales
of an int4 cache {"kv4", "s"}.
pos is a (B,) int32 tensor on the cache's device, or one Python int for
every row (the flat decode step). T = 1 is a decode step, T = K a verify
chunk. k and v may be strided views of the projection (any row strides,
the last dim contiguous). This is what the decode steps and the verify
chunk call, once a layer; it computes what the JAX package's
`decode._quantize_rows_for` followed by the Pallas `cache_append_rows` /
`cache_append_block` of each stream computes, on unpadded rows and scales.

The stacked cache's decode step writes each layer's rows with the same
`append_kv` into the step's in-flight rows (`stacked_inflight`: per stream
an (L, B, W) tensor, layer l seen as a (B, 1, W) cache by `inflight_layer`
and written at row 0), and at the end of the step `append_stacked(cache,
inflight, pos)` sets `cache[l, b, pos[b]] = inflight[l, b]` for every layer
and stream (pos an int: every row at pos).

`cache_append_rows(cache, rows, pos)` sets `cache[b, pos[b]] = rows[b]` in
place for cache (B, S, W), rows (B, W) (cast to the cache's dtype, as the JAX
package's `cache_append_rows` does) and pos (B,) int32, and returns `cache`.
`cache_append_block(cache, rows, pos)` sets `cache[b, pos[b] + j] = rows[b,
j]` for j < K, rows (B, K, W): the K rows of a speculative verify chunk.
`cache_append_rows_stacked(cache, rows, pos)` sets `cache[l, b, pos[b]] =
rows[l, b]` for every layer of a stacked cache (L, B, S, W), rows (L, B, W):
the single-stream form of the end-of-step write, on no path since
`append_stacked`. All three take any stream: bf16 `[k|v]` rows, int8 rows,
nibble-packed int4 carriers and the unpadded f32 scales.

On a CUDA tensor they launch `csrc/cache_append.cu`: `append_kv` one fused
launch (`kv_write`) that quantizes and writes every stream,
`append_stacked` one launch (`kv_write_stacked`) that copies every stream's
rows, the others a copy of each element's contiguous K * W span at the
widest aligned vector width. On a CPU tensor they take the plain versions: for `append_kv` the
concatenation, the port's quantizer (`quant.quantize_kv_rows`, `_4`) and an
indexed or slice assignment per stream; for the others one indexed
assignment. Rows pos[b] .. pos[b] + T - 1 must lie in [0, S): the kernels
skip an element whose rows do not (they never write outside the cache),
while the plain versions of the block and stacked appends raise on it.

The JAX package's kernels rewrite the aligned 8- or 32-row window around
pos[b], and the block form needs a window of slack past the chunk: both are
requirements of the TPU's DMA tiling only; the rows are addressed directly
here.
"""
from __future__ import annotations

import ctypes
from typing import Dict, Union

import torch

from controlar_tpu_torch import _build
from controlar_tpu_torch.quant import quantize_kv_rows, quantize_kv_rows_4

Cache = Union[torch.Tensor, Dict[str, torch.Tensor]]


def cache_append_rows_ref(cache: torch.Tensor, rows: torch.Tensor,
                          pos: torch.Tensor) -> torch.Tensor:
    """Plain version: one indexed assignment, in place; returns cache."""
    b = cache.shape[0]
    cache[torch.arange(b, device=cache.device), pos.long()] = rows.to(cache.dtype)
    return cache


def _vec_bytes(row_bytes: int, *ptrs: int) -> int:
    """The widest of 16, 8, 4, 2, 1 bytes dividing the row width and every
    pointer."""
    for v in (16, 8, 4, 2):
        if row_bytes % v == 0 and all(p % v == 0 for p in ptrs):
            return v
    return 1


def cache_append_block_ref(cache: torch.Tensor, rows: torch.Tensor,
                           pos: torch.Tensor) -> torch.Tensor:
    """Plain version of the block append: one indexed assignment, in place;
    returns cache. Raises when a block does not fit in the cache."""
    b, s, _ = cache.shape
    k = rows.shape[1]
    p = pos.long()
    if bool(((p < 0) | (p + k > s)).any()):
        raise IndexError(f"rows pos[b] .. pos[b] + {k - 1} must lie in [0, {s}), pos = "
                         f"{pos.tolist()}")
    span = p[:, None] + torch.arange(k, device=cache.device)[None, :]
    cache[torch.arange(b, device=cache.device)[:, None], span] = rows.to(cache.dtype)
    return cache


def cache_append_rows_stacked_ref(cache: torch.Tensor, rows: torch.Tensor,
                                  pos: torch.Tensor) -> torch.Tensor:
    """Plain version of the stacked append: one indexed assignment, in
    place; returns cache. Raises when a position lies outside the cache."""
    _, b, s, _ = cache.shape
    p = pos.long()
    if bool(((p < 0) | (p >= s)).any()):
        raise IndexError(f"positions must lie in [0, {s}), pos = {pos.tolist()}")
    cache[:, torch.arange(b, device=cache.device), p] = rows.to(cache.dtype)
    return cache


def _check(cache: torch.Tensor, rows: torch.Tensor, pos: torch.Tensor, block: bool = False,
           stacked: bool = False):
    if cache.dim() != 3 + stacked:
        want = "(L, B, S, W)" if stacked else "(B, S, W)"
        raise ValueError(f"cache must be {want}, got {tuple(cache.shape)}")
    *lead, s, w = cache.shape
    b = lead[-1]
    if block and (rows.dim() != 3 or rows.shape[0] != b or rows.shape[2] != w):
        raise ValueError(f"rows must be ({b}, K, {w}), got {tuple(rows.shape)}")
    if not block and rows.shape != (*lead, w):
        raise ValueError(f"rows must be {(*lead, w)}, got {tuple(rows.shape)}")
    if pos.shape != (b,) or pos.dtype != torch.int32:
        raise ValueError(f"pos must be ({b},) int32, got {tuple(pos.shape)} {pos.dtype}")
    for t in (rows, pos):
        if t.device != cache.device:
            raise ValueError(f"all operands must be on {cache.device}, got {t.device}")
    if not (cache.is_contiguous() and pos.is_contiguous()):
        raise ValueError("cache and pos must be contiguous")
    if cache.device.index != torch.cuda.current_device():
        raise ValueError(f"cache is on {cache.device}, the current device is cuda:"
                         f"{torch.cuda.current_device()}")


def _lib(block: bool = False, stacked: bool = False):
    """The C entry: cache, rows, pos, [L,] B, S, [K,] row_bytes, vec_bytes,
    stream."""
    lib = _build.load("cache_append")
    f = (lib.cache_append_block if block else
         lib.cache_append_rows_stacked if stacked else lib.cache_append_rows)
    if f.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        f.argtypes = ([p, p, p] + [i] * stacked + [i, i] + [i] * block
                      + [ctypes.c_longlong, i, p])
        f.restype = ctypes.c_int
    return f


def cache_append_rows(cache: torch.Tensor, rows: torch.Tensor,
                      pos: torch.Tensor) -> torch.Tensor:
    """cache[b, pos[b]] = rows[b], in place; see the module docstring."""
    if cache.device.type == "cpu":
        return cache_append_rows_ref(cache, rows, pos)
    if cache.device.type != "cuda":
        raise ValueError(f"unsupported device {cache.device}")
    _check(cache, rows, pos)
    b, s, w = cache.shape
    if b == 0 or w == 0:
        return cache
    src = rows.to(cache.dtype).contiguous()
    row_bytes = w * cache.element_size()
    err = _lib()(cache.data_ptr(), src.data_ptr(), pos.data_ptr(), b, s, row_bytes,
                 _vec_bytes(row_bytes, cache.data_ptr(), src.data_ptr()),
                 torch.cuda.current_stream(cache.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"cache_append_rows launch failed: cudaError {err}")
    cache_append_rows.launches += 1
    return cache


cache_append_rows.launches = 0


def cache_append_block(cache: torch.Tensor, rows: torch.Tensor,
                       pos: torch.Tensor) -> torch.Tensor:
    """cache[b, pos[b] + j] = rows[b, j] for j < K, in place; see the module
    docstring."""
    if cache.device.type == "cpu":
        return cache_append_block_ref(cache, rows, pos)
    if cache.device.type != "cuda":
        raise ValueError(f"unsupported device {cache.device}")
    _check(cache, rows, pos, block=True)
    b, s, w = cache.shape
    k = rows.shape[1]
    if b == 0 or w == 0 or k == 0:
        return cache
    src = rows.to(cache.dtype).contiguous()
    row_bytes = w * cache.element_size()
    err = _lib(block=True)(cache.data_ptr(), src.data_ptr(), pos.data_ptr(), b, s, k, row_bytes,
                           _vec_bytes(row_bytes, cache.data_ptr(), src.data_ptr()),
                           torch.cuda.current_stream(cache.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"cache_append_block launch failed: cudaError {err}")
    cache_append_block.launches += 1
    return cache


cache_append_block.launches = 0


def cache_append_rows_stacked(cache: torch.Tensor, rows: torch.Tensor,
                              pos: torch.Tensor) -> torch.Tensor:
    """cache[l, b, pos[b]] = rows[l, b] for every layer l, in place; see the
    module docstring."""
    if cache.device.type == "cpu":
        return cache_append_rows_stacked_ref(cache, rows, pos)
    if cache.device.type != "cuda":
        raise ValueError(f"unsupported device {cache.device}")
    _check(cache, rows, pos, stacked=True)
    n_layer, b, s, w = cache.shape
    if n_layer == 0 or b == 0 or w == 0:
        return cache
    src = rows.to(cache.dtype).contiguous()
    row_bytes = w * cache.element_size()
    err = _lib(stacked=True)(cache.data_ptr(), src.data_ptr(), pos.data_ptr(), n_layer, b, s,
                             row_bytes, _vec_bytes(row_bytes, cache.data_ptr(), src.data_ptr()),
                             torch.cuda.current_stream(cache.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"cache_append_rows_stacked launch failed: cudaError {err}")
    cache_append_rows_stacked.launches += 1
    return cache


cache_append_rows_stacked.launches = 0


# ---- the fused write ---------------------------------------------------------

# dtype codes of csrc/cache_append.cu's kv_write, for k / v and a floating cache
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
# cache kinds: floating, int8, int4 pairs (2j, 2j + 1), int4 split (j, D/2 + j)
_FLOAT, _INT8, _INT4, _INT4_SPLIT = 0, 1, 2, 3
_MAX_QUANT_HEAD_DIM = 256  # 4 value pairs a lane


def cache_streams(cache: Cache, kv_rows: torch.Tensor, kv_heads: int, split: bool):
    """(destination, source) pairs that store new rows kv_rows (..., 2*KV*D):
    the slab and the rows, or a quantized cache's rows and scales, quantized
    by the port's quantizer."""
    if not isinstance(cache, dict):
        return ((cache, kv_rows),)
    if "kv4" in cache:
        rows, scales = quantize_kv_rows_4(kv_rows, kv_heads, split=split)
        return ((cache["kv4"], rows), (cache["s"], scales))
    rows, scales = quantize_kv_rows(kv_rows, kv_heads)
    return ((cache["kv"], rows), (cache["s"], scales))


def append_kv_ref(cache: Cache, k: torch.Tensor, v: torch.Tensor, pos: Union[int, torch.Tensor],
                  *, kv_heads: int, split: bool = False) -> Cache:
    """Plain version of the fused write: concatenate, quantize, then one
    slice assignment per stream for an int pos, `cache_append_rows_ref`
    (T = 1) or `cache_append_block_ref` per stream for a position tensor; in
    place, returns cache."""
    kv_rows = torch.cat([k, v], dim=-1)
    t = kv_rows.shape[1]
    for dst, src in cache_streams(cache, kv_rows, kv_heads, split):
        if isinstance(pos, int):
            dst[:, pos:pos + t] = src
        elif t == 1:
            cache_append_rows_ref(dst, src[:, 0], pos)
        else:
            cache_append_block_ref(dst, src, pos)
    return cache


def _kv_kind(cache: Cache, split: bool) -> int:
    if not isinstance(cache, dict):
        return _FLOAT
    if "kv4" in cache:
        return _INT4_SPLIT if split else _INT4
    return _INT8


def _check_kv(cache: Cache, k: torch.Tensor, v: torch.Tensor, pos, kv_heads: int):
    """Raise ValueError unless the operands are a cache, rows and a position
    the fused write takes; returns (rows, scales | None, head_dim)."""
    if isinstance(cache, dict):
        key = "kv4" if "kv4" in cache else "kv"
        if set(cache) != {key, "s"}:
            raise ValueError(f"a quantized cache is {{'kv' | 'kv4', 's'}}, got {sorted(cache)}")
        rows, scales = cache[key], cache["s"]
        if rows.dtype != torch.int8 or scales.dtype != torch.float32:
            raise ValueError(f"cache[{key!r}] must be int8 and cache['s'] float32, got "
                             f"{rows.dtype} and {scales.dtype}")
    else:
        rows, scales = cache, None
        if rows.dtype not in _DTYPE_CODE:
            raise ValueError(f"a floating cache must be one of {list(_DTYPE_CODE)}, got "
                             f"{rows.dtype}")
    if k.dim() != 3 or k.shape != v.shape:
        raise ValueError(f"k and v must be (B, T, KV*D) of one shape, got {tuple(k.shape)} and "
                         f"{tuple(v.shape)}")
    if k.dtype != v.dtype or k.dtype not in _DTYPE_CODE:
        raise ValueError(f"k and v must share a dtype of {list(_DTYPE_CODE)}, got {k.dtype} and "
                         f"{v.dtype}")
    b, t, kvd = k.shape
    if kv_heads <= 0 or kvd % kv_heads != 0 or (kvd // kv_heads) % 2 != 0:
        raise ValueError(f"the row width {kvd} must be kv_heads ({kv_heads}) heads of an even "
                         f"head_dim")
    d = kvd // kv_heads
    if scales is not None and d > _MAX_QUANT_HEAD_DIM:
        raise ValueError(f"a quantized cache takes head_dim <= {_MAX_QUANT_HEAD_DIM}, got {d}")
    width = kvd if isinstance(cache, dict) and "kv4" in cache else 2 * kvd
    if rows.dim() != 3 or rows.shape[0] != b or rows.shape[2] != width:
        raise ValueError(f"the cache rows must be ({b}, S, {width}), got {tuple(rows.shape)}")
    if scales is not None and scales.shape != (b, rows.shape[1], 2 * kv_heads):
        raise ValueError(f"the scales must be ({b}, {rows.shape[1]}, {2 * kv_heads}), got "
                         f"{tuple(scales.shape)}")
    if isinstance(pos, torch.Tensor):
        if pos.shape != (b,) or pos.dtype != torch.int32 or not pos.is_contiguous():
            raise ValueError(f"pos must be a contiguous ({b},) int32 tensor, got "
                             f"{tuple(pos.shape)} {pos.dtype}")
    elif not isinstance(pos, int) or isinstance(pos, bool):
        raise ValueError(f"pos must be an int or a (B,) int32 tensor, got {type(pos).__name__}")
    operands = [k, v, *([] if scales is None else [scales])]
    operands += [pos] if isinstance(pos, torch.Tensor) else []
    for x in operands:
        if x.device != rows.device:
            raise ValueError(f"all operands must be on {rows.device}, got {x.device}")
    if k.stride(-1) != 1 or v.stride(-1) != 1:
        raise ValueError("k and v must be contiguous in their last dim")
    if not rows.is_contiguous() or (scales is not None and not scales.is_contiguous()):
        raise ValueError("the cache streams must be contiguous")
    return rows, scales, d


def _kv_lib():
    """The C entry: kind, in_dtype, out_dtype, rows, scales, k, v, k_b, k_t,
    v_b, v_t, pos, pos0, B, T, S, KV, D, stream."""
    f = _build.load("cache_append").kv_write
    if f.argtypes is None:
        p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        f.argtypes = [i, i, i, p, p, p, p, ll, ll, ll, ll, p, i, i, i, i, i, i, p]
        f.restype = ctypes.c_int
    return f


def append_kv(cache: Cache, k: torch.Tensor, v: torch.Tensor, pos: Union[int, torch.Tensor],
              *, kv_heads: int, split: bool = False) -> Cache:
    """Write a layer's new rows k, v (B, T, KV*D) at rows pos[b] + t of every
    stream of cache, quantized to its format, in place; returns cache. See
    the module docstring."""
    rows, scales, d = _check_kv(cache, k, v, pos, kv_heads)
    if rows.device.type == "cpu":
        return append_kv_ref(cache, k, v, pos, kv_heads=kv_heads, split=split)
    if rows.device.type != "cuda":
        raise ValueError(f"unsupported device {rows.device}")
    if rows.device.index != torch.cuda.current_device():
        raise ValueError(f"cache is on {rows.device}, the current device is cuda:"
                         f"{torch.cuda.current_device()}")
    b, t, _ = k.shape
    if b == 0 or t == 0:
        return cache
    tensor_pos = isinstance(pos, torch.Tensor)
    err = _kv_lib()(_kv_kind(cache, split), _DTYPE_CODE[k.dtype],
                    _DTYPE_CODE.get(rows.dtype, 0), rows.data_ptr(),
                    0 if scales is None else scales.data_ptr(), k.data_ptr(), v.data_ptr(),
                    k.stride(0), k.stride(1), v.stride(0), v.stride(1),
                    pos.data_ptr() if tensor_pos else 0, 0 if tensor_pos else pos, b, t,
                    rows.shape[1], kv_heads, d,
                    torch.cuda.current_stream(rows.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"append_kv launch failed: cudaError {err}")
    append_kv.launches += 1
    return cache


append_kv.launches = 0


# ---- the stacked cache's in-flight rows and end-of-step write ---------------


def stream_list(cache: Cache):
    """A cache's streams in the order the kernels take them: the floating
    slab, or a quantized cache's rows (int8 values or int4 carriers) and then
    its scales."""
    if not isinstance(cache, dict):
        return [cache]
    return [cache["kv4" if "kv4" in cache else "kv"], cache["s"]]


def stacked_inflight(cache: Cache, batch: int) -> Cache:
    """Uninitialised in-flight rows for one decode step of a stacked cache:
    for each stream (L, B, S, W) an (L, batch, W) tensor of its dtype on its
    device, with the same keys. Layer l's rows, `[l]`, are a contiguous
    (batch, W) tensor starting at a multiple of 16 bytes, as the stacked
    attention kernels take their in-flight row."""
    def rows(x: torch.Tensor) -> torch.Tensor:
        n_layer, w, size = x.shape[0], x.shape[-1], x.element_size()
        per_layer = -(-batch * w * size // 16) * 16 // size
        flat = torch.empty((n_layer, per_layer), dtype=x.dtype, device=x.device)
        return flat[:, :batch * w].view(n_layer, batch, w)

    if isinstance(cache, dict):
        return {k: rows(v) for k, v in cache.items()}
    return rows(cache)


def inflight_layer(inflight: Cache, layer: int) -> Cache:
    """Layer `layer` of in-flight rows (L, B, W per stream) as a (B, 1, W)
    cache, which `append_kv` writes at row 0."""
    if isinstance(inflight, dict):
        return {k: v[layer][:, None] for k, v in inflight.items()}
    return inflight[layer][:, None]


def append_stacked_ref(cache: Cache, inflight: Cache, pos: Union[int, torch.Tensor]) -> Cache:
    """Plain version of the end-of-step write: per stream one slice
    assignment at an int pos, `cache_append_rows_stacked_ref` at a position
    tensor; in place, returns cache."""
    for dst, src in zip(stream_list(cache), stream_list(inflight)):
        if isinstance(pos, int):
            dst[:, :, pos] = src
        else:
            cache_append_rows_stacked_ref(dst, src, pos)
    return cache


def _check_stacked(cache: Cache, inflight: Cache, pos):
    """Raise ValueError unless cache is a stacked cache, inflight its rows
    (as `stacked_inflight` makes them) and pos an int or a (B,) int32
    tensor; returns the (cache, rows) stream pairs."""
    if isinstance(cache, dict) != isinstance(inflight, dict) or (
            isinstance(cache, dict) and set(cache) != set(inflight)):
        raise ValueError("the in-flight rows must have the cache's streams")
    pairs = list(zip(stream_list(cache), stream_list(inflight)))
    n_layer, b = pairs[0][0].shape[:2]
    for dst, src in pairs:
        if dst.dim() != 4 or dst.shape[:2] != (n_layer, b):
            raise ValueError(f"a stacked cache's streams are ({n_layer}, {b}, S, W), got "
                             f"{tuple(dst.shape)}")
        if src.shape != (n_layer, b, dst.shape[3]) or src.dtype != dst.dtype:
            raise ValueError(f"in-flight rows must be {(n_layer, b, dst.shape[3])} {dst.dtype}, "
                             f"got {tuple(src.shape)} {src.dtype}")
        if src.stride(2) != 1 or src.stride(1) != dst.shape[3]:
            raise ValueError("each layer of the in-flight rows must be contiguous")
        if not dst.is_contiguous():
            raise ValueError("the cache streams must be contiguous")
        if src.device != dst.device or dst.device != pairs[0][0].device:
            raise ValueError("all operands must be on one device")
    if isinstance(pos, torch.Tensor):
        if pos.shape != (b,) or pos.dtype != torch.int32 or not pos.is_contiguous():
            raise ValueError(f"pos must be a contiguous ({b},) int32 tensor, got "
                             f"{tuple(pos.shape)} {pos.dtype}")
        if pos.device != pairs[0][0].device:
            raise ValueError(f"pos is on {pos.device}, the cache on {pairs[0][0].device}")
    elif not isinstance(pos, int) or isinstance(pos, bool):
        raise ValueError(f"pos must be an int or a (B,) int32 tensor, got {type(pos).__name__}")
    return pairs


def _stacked_lib():
    """The C entry: n_streams, then (cache, rows, row_bytes, layer_bytes,
    vec) of two streams, pos, pos0, L, B, S, stream."""
    f = _build.load("cache_append").kv_write_stacked
    if f.argtypes is None:
        p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        f.argtypes = [i] + [p, p, ll, ll, i] * 2 + [p, i, i, i, i, p]
        f.restype = ctypes.c_int
    return f


def append_stacked(cache: Cache, inflight: Cache, pos: Union[int, torch.Tensor]) -> Cache:
    """Write a decode step's in-flight rows (L, B, W) of every stream into
    the stacked cache: `cache[l, b, pos[b]] = inflight[l, b]` (pos an int:
    every row at pos), in place; returns cache. On a CUDA tensor one launch
    writes every stream; it skips a row whose position lies outside [0, S),
    where the plain version raises."""
    pairs = _check_stacked(cache, inflight, pos)
    dev = pairs[0][0].device
    if dev.type == "cpu":
        return append_stacked_ref(cache, inflight, pos)
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    if dev.index != torch.cuda.current_device():
        raise ValueError(f"cache is on {dev}, the current device is cuda:"
                         f"{torch.cuda.current_device()}")
    n_layer, b, s, _ = pairs[0][0].shape
    args = []
    for dst, src in pairs + pairs[-1:] * (2 - len(pairs)):
        size = dst.element_size()
        row_bytes, layer_bytes = dst.shape[3] * size, src.stride(0) * size
        args += [dst.data_ptr(), src.data_ptr(), row_bytes, layer_bytes,
                 _vec_bytes(row_bytes, layer_bytes, dst.data_ptr(), src.data_ptr())]
    tensor_pos = isinstance(pos, torch.Tensor)
    err = _stacked_lib()(len(pairs), *args, pos.data_ptr() if tensor_pos else 0,
                         0 if tensor_pos else pos, n_layer, b, s,
                         torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"append_stacked launch failed: cudaError {err}")
    append_stacked.launches += 1
    return cache


append_stacked.launches = 0
