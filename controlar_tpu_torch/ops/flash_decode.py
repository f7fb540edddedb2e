"""Single-query decode attention over the interleaved [k|v] cache slab.

`flash_decode_attention` has the signature and semantics of the JAX
package's `flash_decode_attention2`: q (B, H*D), kv (B, S, 2*H*D) bf16 with
rows [k | v], pos a scalar or (B,) int32, an optional (B, S) f32 additive
column bias, rows > pos[b] excluded, online softmax in fp32, output (B, H*D)
in q's dtype. On a CUDA tensor it launches the hand-written kernel in
`csrc/flash_decode.cu`; on a CPU tensor it computes the same function with
`flash_decode_attention_ref`.
"""
from __future__ import annotations

import ctypes
import math
from typing import Optional, Union

import torch

from controlar_tpu_torch import _build

HEAD_DIMS = (64, 100, 128)

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
    if col_bias is not None:
        scores = scores + col_bias.float()[:, None, :]
    pos_t = torch.as_tensor(pos, device=kv.device).reshape(-1, 1)
    rows = torch.arange(s, device=kv.device)[None, :]
    scores = scores.masked_fill(~(rows <= pos_t)[:, None, :], float("-inf"))
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("bhs,bshd->bhd", probs, v)
    return out.reshape(b, hd).to(q.dtype)


def _check(q, kv, pos, col_bias, n_head):
    if kv.dim() != 3 or kv.dtype != torch.bfloat16:
        raise ValueError(f"kv must be (B, S, 2*H*D) bfloat16, got {tuple(kv.shape)} {kv.dtype}")
    b, s, hd2 = kv.shape
    hd = hd2 // 2
    if hd2 % 2 or hd % n_head:
        raise ValueError(f"kv row width {hd2} does not split into 2 x {n_head} heads")
    d = hd // n_head
    if d not in HEAD_DIMS:
        raise ValueError(f"head_dim {d} not supported by the kernel (takes {HEAD_DIMS})")
    if q.shape != (b, hd) or q.dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"q must be ({b}, {hd}) bf16/f32, got {tuple(q.shape)} {q.dtype}")
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


def _lib():
    fn = _build.load("flash_decode").flash_decode_attention
    if fn.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [p, p, p, i, i, p, p, i, i, i, i, i, p]
        fn.restype = ctypes.c_int
    return fn


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
    if isinstance(pos, torch.Tensor):
        pos_ptr, pos_stride, pos_scalar = pos.data_ptr(), int(pos.numel() == b and pos.dim() == 1), 0
    else:
        pos_ptr, pos_stride, pos_scalar = None, 0, int(pos)
    err = _lib()(
        qb.data_ptr(), kv.data_ptr(), pos_ptr, pos_stride, pos_scalar,
        None if col_bias is None else col_bias.data_ptr(), out.data_ptr(),
        int(out.dtype == torch.float32), b, s, n_head, d,
        torch.cuda.current_stream(kv.device).cuda_stream,
    )
    if err != 0:
        raise RuntimeError(f"flash_decode_attention launch failed: cudaError {err}")
    flash_decode_attention.launches += 1
    return out


flash_decode_attention.launches = 0
