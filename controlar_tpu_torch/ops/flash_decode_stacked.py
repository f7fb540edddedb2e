"""Decode attention over one layer of a stacked (L, B, S, R) KV cache.

The counterpart of the JAX package's `ops/flash_decode_stacked.py`. A
stacked cache holds every layer's rows in one tensor per stream. The step
that uses it (`decode._decode_layers` on a stacked cache) scores the row of
the current position, the in-flight row, from an operand and writes all L
layers' rows once at the end of the step; attention reads the stack's rows
[0, pos[b]) of layer `layer`, plus the in-flight row.

- `flash_stacked(q, new_kv, kv_stack, layer, pos, col_bias, n_head=)`: q
  (B, H*D), new_kv (B, 2*H*D) and kv_stack (L, B, S, 2*H*D) bf16 [k | v]
  rows (`csrc/flash_decode.cu`, entry `flash_stacked`);
- `flash_stacked_q8(q, new_kv, new_s, kv_stack, sc_stack, layer, pos, ...)`:
  int8 rows with f32 per-head scales new_s (B, 2*H), sc_stack (L, B, S, 2*H)
  (`csrc/flash_decode_q8.cu`, entry `flash_stacked_q8`);
- `flash_stacked_q4(q, new_c, new_s, kv_stack, sc_stack, layer, pos, ...,
  head_dim=, split=)`: nibble-packed int4 carriers, rows of H*D bytes, in
  split or interleaved pair layout (`csrc/flash_decode_q4.cu`, entry
  `flash_stacked_q4`).

layer is a Python int (an offset on the slab pointer); pos is an int or a
(B,) int32 tensor, and pos = 0 attends to the in-flight row alone. col_bias
(B, S) f32 is added to the stack's rows; the in-flight row takes none (the
JAX contract: the bias is 0 at decode positions). Scales and int4 rows are
unpadded, as everywhere in the port. On a CUDA tensor a wrapper launches its
kernel; on a CPU tensor it takes the plain version, which writes the
in-flight row into a copy of the layer's slab and runs the flat plain
version of `ops/flash_decode.py` over it (so it needs pos[b] < S, where the
kernel reads only the stack's rows < S).
"""
from __future__ import annotations

from typing import Optional

import torch

from controlar_tpu_torch.ops import flash_decode as fd

Pos = fd.Pos


def layer_with_row(stack: torch.Tensor, new_row: torch.Tensor, layer: int, pos: Pos):
    """A copy of layer `layer` of the stack (L, B, S, W) with the in-flight
    row (B, W) written at row pos[b]; positions must lie in [0, S)."""
    _, b, s, _ = stack.shape
    p = torch.as_tensor(pos, device=stack.device).long().reshape(-1).expand(b)
    if bool(((p < 0) | (p >= s)).any()):
        raise IndexError(f"positions must lie in [0, {s}), pos = {p.tolist()}")
    slab = stack[layer].clone()
    slab[torch.arange(b, device=stack.device), p] = new_row.to(slab.dtype)
    return slab


def _bias(col_bias: Optional[torch.Tensor], pos: Pos) -> Optional[torch.Tensor]:
    """col_bias with column pos[b] set to 0: the in-flight row takes none."""
    if col_bias is None:
        return None
    b = col_bias.shape[0]
    p = torch.as_tensor(pos, device=col_bias.device).long().reshape(-1).expand(b)
    bias = col_bias.float().clone()
    bias[torch.arange(b, device=bias.device), p] = 0.0
    return bias


def flash_stacked_ref(q, new_kv, kv_stack, layer: int, pos: Pos,
                      col_bias: Optional[torch.Tensor] = None, *, n_head: int):
    """Plain version of `flash_stacked`: the flat plain version over the
    layer's slab with the in-flight row written."""
    return fd.flash_decode_attention_ref(q, layer_with_row(kv_stack, new_kv, layer, pos), pos,
                                         _bias(col_bias, pos), n_head=n_head)


def flash_stacked_q8_ref(q, new_kv, new_s, kv_stack, sc_stack, layer: int, pos: Pos,
                         col_bias: Optional[torch.Tensor] = None, *, n_head: int):
    """Plain version of `flash_stacked_q8`, as `flash_stacked_ref`."""
    kv = layer_with_row(kv_stack, new_kv, layer, pos)
    scale = layer_with_row(sc_stack, new_s, layer, pos)
    return fd.flash_decode_attention_q8_ref(q, kv, scale, pos, _bias(col_bias, pos),
                                            n_head=n_head)


def flash_stacked_q4_ref(q, new_c, new_s, kv_stack, sc_stack, layer: int, pos: Pos,
                         col_bias: Optional[torch.Tensor] = None, *, n_head: int,
                         head_dim: int, split: bool = False):
    """Plain version of `flash_stacked_q4`, as `flash_stacked_ref`."""
    kv = layer_with_row(kv_stack, new_c, layer, pos)
    scale = layer_with_row(sc_stack, new_s, layer, pos)
    return fd.flash_decode_attention_q4_ref(q, kv, scale, pos, _bias(col_bias, pos),
                                            n_head=n_head, head_dim=head_dim, split=split)


def _check(q, new_row, stack, layer, pos, col_bias, n_head, kv_dtype, int4_head_dim=None):
    """The flat kernels' checks on layer `layer`'s slab, and the in-flight
    row's; returns (B, S, D)."""
    if stack.dim() != 4 or not 0 <= layer < stack.shape[0]:
        raise ValueError(f"kv_stack must be (L, B, S, W) with layer in [0, L), got "
                         f"{tuple(stack.shape)} and layer {layer}")
    if not stack.is_contiguous():
        raise ValueError("kv_stack must be contiguous")
    b, s, d = fd._check(q, stack[layer], pos, col_bias, n_head, kv_dtype=kv_dtype,
                        int4_head_dim=int4_head_dim)
    width = stack.shape[3]
    if new_row.shape != (b, width) or new_row.dtype != kv_dtype:
        raise ValueError(f"the in-flight row must be ({b}, {width}) {kv_dtype}, got "
                         f"{tuple(new_row.shape)} {new_row.dtype}")
    if new_row.device != stack.device or not new_row.is_contiguous():
        raise ValueError(f"the in-flight row must be contiguous on {stack.device}")
    if new_row.data_ptr() % (16 if d % 8 == 0 else 8):
        raise ValueError("the in-flight row is not aligned")
    return b, s, d


def _check_scales(new_s, sc_stack, stack, n_head):
    fd._check_scale(sc_stack[0], stack[0], n_head)
    if sc_stack.shape[0] != stack.shape[0] or not sc_stack.is_contiguous():
        raise ValueError(f"sc_stack must be contiguous ({stack.shape[0]}, ...), got "
                         f"{tuple(sc_stack.shape)}")
    b = stack.shape[1]
    if (new_s.shape != (b, 2 * n_head) or new_s.dtype != torch.float32
            or new_s.device != stack.device or not new_s.is_contiguous()):
        raise ValueError(f"new_s must be contiguous ({b}, {2 * n_head}) float32 on "
                         f"{stack.device}, got {tuple(new_s.shape)} {new_s.dtype}")


def _run(f, name, q, ptrs, layer, pos, col_bias, b, s, n_head, d, tail):
    """Launches entry f; tail: its arguments after D (the stream last)."""
    qb = q if q.dtype == torch.bfloat16 else q.to(torch.bfloat16)
    out = torch.empty((b, n_head * d), dtype=q.dtype, device=q.device)
    err = f(qb.data_ptr(), *ptrs, layer, *fd._pos_args(pos, b),
            None if col_bias is None else col_bias.data_ptr(), out.data_ptr(),
            int(out.dtype == torch.float32), b, s, n_head, d, *tail)
    if err != 0:
        raise RuntimeError(f"{name} launch failed: cudaError {err}")
    return out


def flash_stacked(
    q: torch.Tensor,
    new_kv: torch.Tensor,
    kv_stack: torch.Tensor,
    layer: int,
    pos: Pos,
    col_bias: Optional[torch.Tensor] = None,
    *,
    n_head: int,
) -> torch.Tensor:
    """bf16 stacked decode attention; see the module docstring."""
    if kv_stack.device.type == "cpu":
        return flash_stacked_ref(q, new_kv, kv_stack, layer, pos, col_bias, n_head=n_head)
    if kv_stack.device.type != "cuda":
        raise ValueError(f"unsupported device {kv_stack.device}")
    b, s, d = _check(q, new_kv, kv_stack, layer, pos, col_bias, n_head, torch.bfloat16)
    f = fd._split_lib("flash_decode", "flash_stacked", 3, layer=True)
    out = _run(f, "flash_stacked", q,
               (new_kv.data_ptr(), kv_stack.data_ptr()), layer, pos, col_bias, b, s, n_head, d,
               fd._split_args(torch.bfloat16, kv_stack, b, s, n_head, d, pos, stacked=True))
    flash_stacked.launches += 1
    return out


flash_stacked.launches = 0


def flash_stacked_q8(
    q: torch.Tensor,
    new_kv: torch.Tensor,
    new_s: torch.Tensor,
    kv_stack: torch.Tensor,
    sc_stack: torch.Tensor,
    layer: int,
    pos: Pos,
    col_bias: Optional[torch.Tensor] = None,
    *,
    n_head: int,
) -> torch.Tensor:
    """int8 stacked decode attention; see the module docstring."""
    if kv_stack.device.type == "cpu":
        return flash_stacked_q8_ref(q, new_kv, new_s, kv_stack, sc_stack, layer, pos, col_bias,
                                    n_head=n_head)
    if kv_stack.device.type != "cuda":
        raise ValueError(f"unsupported device {kv_stack.device}")
    b, s, d = _check(q, new_kv, kv_stack, layer, pos, col_bias, n_head, torch.int8)
    _check_scales(new_s, sc_stack, kv_stack, n_head)
    f = fd._split_lib("flash_decode_q8", "flash_stacked_q8", 5, layer=True)
    out = _run(f, "flash_stacked_q8", q,
               (new_kv.data_ptr(), new_s.data_ptr(), kv_stack.data_ptr(), sc_stack.data_ptr()),
               layer, pos, col_bias, b, s, n_head, d,
               fd._split_args(torch.int8, kv_stack, b, s, n_head, d, pos, stacked=True))
    flash_stacked_q8.launches += 1
    return out


flash_stacked_q8.launches = 0


def flash_stacked_q4(
    q: torch.Tensor,
    new_c: torch.Tensor,
    new_s: torch.Tensor,
    kv_stack: torch.Tensor,
    sc_stack: torch.Tensor,
    layer: int,
    pos: Pos,
    col_bias: Optional[torch.Tensor] = None,
    *,
    n_head: int,
    head_dim: int,
    split: bool = False,
) -> torch.Tensor:
    """int4 stacked decode attention; see the module docstring."""
    if kv_stack.device.type == "cpu":
        return flash_stacked_q4_ref(q, new_c, new_s, kv_stack, sc_stack, layer, pos, col_bias,
                                    n_head=n_head, head_dim=head_dim, split=split)
    if kv_stack.device.type != "cuda":
        raise ValueError(f"unsupported device {kv_stack.device}")
    b, s, d = _check(q, new_c, kv_stack, layer, pos, col_bias, n_head, torch.int8,
                     int4_head_dim=head_dim)
    _check_scales(new_s, sc_stack, kv_stack, n_head)
    f = fd._split_lib("flash_decode_q4", "flash_stacked_q4", 5, layer=True, split=True)
    out = _run(f, "flash_stacked_q4", q,
               (new_c.data_ptr(), new_s.data_ptr(), kv_stack.data_ptr(), sc_stack.data_ptr()),
               layer, pos, col_bias, b, s, n_head, d,
               (int(split), *fd._split_args(fd.INT4, kv_stack, b, s, n_head, d, pos,
                                            stacked=True)))
    flash_stacked_q4.launches += 1
    return out


flash_stacked_q4.launches = 0
