"""Canny edge detection with cv2.Canny's integer algorithm, bit-exact with
the JAX package's `controlar_tpu/ops/canny.py`:

- 3x3 Sobel with a replicated border, per channel; for multi-channel input
  the channel with the largest L1 magnitude wins (the first on ties);
- L1 gradient magnitude |dx| + |dy| in int32;
- non-maximum suppression with OpenCV's fixed-point direction split
  (CANNY_SHIFT = 15, TG22 = 13573) and its strict / non-strict comparisons;
- double threshold, then hysteresis: a weak edge is kept when 8-connected to
  a strong one, grown one ring per iteration until nothing changes or
  `max_iters` rings.

Output: uint8 {0, 255} edge map (B, H, W).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

_CANNY_SHIFT = 15
_TG22 = 13573  # tan(22.5 deg) * 2^15, rounded as in OpenCV


def _sobel_pair(img: torch.Tensor):
    """3x3 Sobel dx, dy with a replicated border. img: (B, H, W, C) int32."""
    c = F.pad(img.permute(0, 3, 1, 2).float(), (1, 1, 1, 1), mode="replicate")
    c = c.to(torch.int32).permute(0, 2, 3, 1)
    dx = (
        -c[:, :-2, :-2] + c[:, :-2, 2:]
        - 2 * c[:, 1:-1, :-2] + 2 * c[:, 1:-1, 2:]
        - c[:, 2:, :-2] + c[:, 2:, 2:]
    )
    dy = (
        -c[:, :-2, :-2] - 2 * c[:, :-2, 1:-1] - c[:, :-2, 2:]
        + c[:, 2:, :-2] + 2 * c[:, 2:, 1:-1] + c[:, 2:, 2:]
    )
    return dx, dy


def _shift(a: torch.Tensor, dy: int, dx: int) -> torch.Tensor:
    """out[:, i, j] = a[:, i + dy, j + dx], zero outside the image."""
    h, w = a.shape[1], a.shape[2]
    pad = F.pad(a, (1, 1, 1, 1))
    return pad[:, 1 + dy:1 + dy + h, 1 + dx:1 + dx + w]


def _grow(edges: torch.Tensor) -> torch.Tensor:
    grown = torch.zeros_like(edges)
    for dy in (-1, 0, 1):
        for dx in (-1, 0, 1):
            if dy or dx:
                grown |= _shift(edges, dy, dx)
    return grown


def canny(
    img: torch.Tensor,
    low_threshold: int = 100,
    high_threshold: int = 200,
    max_iters: int = 64,
) -> torch.Tensor:
    """img: (B, H, W, C) or (B, H, W), uint8-valued. Returns (B, H, W) uint8."""
    if img.dim() == 3:
        img = img[..., None]
    dx, dy = _sobel_pair(img.to(torch.int32))
    mag_c = dx.abs() + dy.abs()
    # first channel of maximal magnitude, as argmax picks it
    is_max = mag_c == mag_c.amax(-1, keepdim=True)
    sel = is_max & (torch.cumsum(is_max.to(torch.int32), dim=-1) == 1)
    zero = torch.zeros((), dtype=torch.int32, device=img.device)
    mag = torch.where(sel, mag_c, zero).sum(-1, dtype=torch.int32)
    dxs = torch.where(sel, dx, zero).sum(-1, dtype=torch.int32)
    dys = torch.where(sel, dy, zero).sum(-1, dtype=torch.int32)

    # int32 suffices: |sobel| <= 4*255, so y <= 1020 << 15 and
    # tg67x <= 1020*13573 + (2040 << 15), well inside int32
    x = dxs.abs()
    y = dys.abs() << _CANNY_SHIFT
    tg22x = x * _TG22
    tg67x = tg22x + ((2 * x) << _CANNY_SHIFT)

    m = mag
    left, right = _shift(m, 0, -1), _shift(m, 0, 1)
    up, down = _shift(m, -1, 0), _shift(m, 1, 0)
    ul, ur = _shift(m, -1, -1), _shift(m, -1, 1)
    dl, dr = _shift(m, 1, -1), _shift(m, 1, 1)

    horiz = (m > left) & (m >= right)
    vert = (m > up) & (m >= down)
    s_neg = (dxs ^ dys) < 0  # opposite signs -> anti-diagonal neighbours
    diag = torch.where(s_neg, (m > ur) & (m > dl), (m > ul) & (m > dr))
    is_local_max = torch.where(y < tg22x, horiz, torch.where(y > tg67x, vert, diag))
    candidate = (m > low_threshold) & is_local_max
    strong = candidate & (m > high_threshold)
    weak = candidate & ~strong

    edges = strong
    for _ in range(max_iters):
        new_edges = edges | (weak & _grow(edges))
        if torch.equal(new_edges, edges):
            break
        edges = new_edges
    return edges.to(torch.uint8) * 255
