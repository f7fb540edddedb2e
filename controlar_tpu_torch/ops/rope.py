"""2D rotary position embeddings over the token grid.

- head_dim is split in half: the first half rotates with the row coordinate,
  the second half with the column coordinate;
- the first `cls_token_num` positions (class or caption prefix) get an
  all-zero cos/sin table, which zeroes the rotated q/k of prefix tokens;
- rotation acts on interleaved (even, odd) channel pairs, in fp32.
"""
from __future__ import annotations

import numpy as np
import torch


def _freqs(head_dim: int, base: float) -> np.ndarray:
    half_dim = head_dim // 2
    exponents = np.arange(0, half_dim, 2)[: half_dim // 2].astype(np.float32) / half_dim
    return 1.0 / (base ** exponents)  # (head_dim // 4,)


def precompute_rope_2d_rect(
    grid_h: int,
    grid_w: int,
    head_dim: int,
    base: float = 10000.0,
    cls_token_num: int = 120,
) -> torch.Tensor:
    """(cls_token_num + grid_h * grid_w, head_dim // 2, 2) fp32 cos/sin table
    for a grid_h x grid_w token grid."""
    half_dim = head_dim // 2
    freqs = _freqs(head_dim, base)
    ang_h = np.outer(np.arange(grid_h, dtype=np.float32), freqs)
    ang_w = np.outer(np.arange(grid_w, dtype=np.float32), freqs)
    grid_angles = np.concatenate(
        [
            np.broadcast_to(ang_h[:, None, :], (grid_h, grid_w, ang_h.shape[-1])),
            np.broadcast_to(ang_w[None, :, :], (grid_h, grid_w, ang_w.shape[-1])),
        ],
        axis=-1,
    )
    table = np.stack([np.cos(grid_angles), np.sin(grid_angles)], axis=-1)
    table = table.reshape(grid_h * grid_w, half_dim, 2)
    prefix = np.zeros((cls_token_num, half_dim, 2), dtype=np.float32)
    return torch.from_numpy(np.concatenate([prefix, table.astype(np.float32)], axis=0))


def precompute_rope_2d(
    grid_size: int,
    head_dim: int,
    base: float = 10000.0,
    cls_token_num: int = 120,
) -> torch.Tensor:
    """Square-grid table, (cls_token_num + grid_size**2, head_dim // 2, 2)."""
    return precompute_rope_2d_rect(grid_size, grid_size, head_dim, base, cls_token_num)


def apply_rope(x: torch.Tensor, rope: torch.Tensor) -> torch.Tensor:
    """Rotate q or k. x: (B, T, H, D); rope: (T, D//2, 2) fp32, or
    (B, T, D//2, 2) for per-sequence positions. fp32 math, cast back."""
    b, t, h, d = x.shape
    xf = x.float().reshape(b, t, h, d // 2, 2)
    if rope.dim() == 4:
        cos = rope[:, :, None, :, 0]
        sin = rope[:, :, None, :, 1]
    else:
        cos = rope[None, :, None, :, 0]
        sin = rope[None, :, None, :, 1]
    even = xf[..., 0] * cos - xf[..., 1] * sin
    odd = xf[..., 1] * cos + xf[..., 0] * sin
    return torch.stack([even, odd], dim=-1).reshape(b, t, h, d).to(x.dtype)


def make_split_rope_tables(table: torch.Tensor, n_head: int, kv_heads: int, head_dim: int):
    """Full-width cos/sin rows for split-layout RoPE over a fused [q|k] block.

    Split layout stores each head's dims as [evens | odds], so pair j lies
    at lanes (j, D/2 + j) and the rotation is elementwise. table: (T, D/2, 2)
    from precompute_rope_2d_rect. Returns (cos, sin), each (T, (H + KV) * D):
    per head [c | c] and [-s | s], over the q heads then the k heads."""
    c, s = table[..., 0], table[..., 1]
    n = n_head + kv_heads
    return (torch.cat([c, c], dim=-1).repeat(1, n),
            torch.cat([-s, s], dim=-1).repeat(1, n))


def apply_rope_split(qk: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor,
                     head_dim: int) -> torch.Tensor:
    """Rotate a fused [q|k] block (..., (H + KV) * D) in split layout:
    qk * cos + swap(qk) * sin, where swap exchanges the two halves of every
    head. cos/sin broadcast against qk. fp32 math, cast back."""
    half = head_dim // 2
    lanes = torch.arange(qk.shape[-1], device=qk.device) % head_dim
    swapped = torch.where(lanes < half, torch.roll(qk, -half, dims=-1),
                          torch.roll(qk, half, dims=-1))
    return (qk.float() * cos + swapped.float() * sin).to(qk.dtype)
