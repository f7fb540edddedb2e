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
