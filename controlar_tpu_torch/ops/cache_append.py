"""Per-slot KV-cache row and block append.

`cache_append_rows(cache, rows, pos)` sets `cache[b, pos[b]] = rows[b]` in
place for cache (B, S, W), rows (B, W) (cast to the cache's dtype, as the JAX
package's `cache_append_rows` does) and pos (B,) int32, and returns `cache`.
`cache_append_block(cache, rows, pos)` sets `cache[b, pos[b] + j] = rows[b,
j]` for j < K, rows (B, K, W): the K rows of a speculative verify chunk.
`cache_append_rows_stacked(cache, rows, pos)` sets `cache[l, b, pos[b]] =
rows[l, b]` for every layer of a stacked cache (L, B, S, W), rows (L, B, W):
all layers' rows of a per-slot decode step in one call.
All take every stream the decode steps write: bf16 `[k|v]` rows, int8
rows, nibble-packed int4 carriers and the unpadded f32 scales.

On a CUDA tensor they launch `csrc/cache_append.cu`, which copies each
element's contiguous K * W span at the widest aligned vector width; on a
CPU tensor they take the plain versions, one indexed assignment. Rows
pos[b] .. pos[b] + K - 1 must lie in [0, S): the kernel skips an element
whose rows do not (it never writes outside the cache), while the plain
versions of the block and stacked appends raise on it.

The JAX package's kernels rewrite the aligned 8- or 32-row window around
pos[b], and the block form needs a window of slack past the chunk: both are
requirements of the TPU's DMA tiling only; the rows are addressed directly
here.
"""
from __future__ import annotations

import ctypes

import torch

from controlar_tpu_torch import _build


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
