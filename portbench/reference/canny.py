"""Canny edges as OpenCV's `cv2.Canny(image, low, high)` computes them
(aperture 3, L1 gradient), written from OpenCV's description:

- 3 x 3 Sobel derivatives with a replicated border, per colour channel; at
  each pixel the channel with the largest |dx| + |dy| is taken (the first on
  ties);
- non-maximum suppression along the gradient's direction, sorted into
  horizontal, vertical and the two diagonals by OpenCV's fixed-point tangent
  test (tan 22.5 deg = 13573 / 2**15); the neighbour before the pixel along
  the direction must be strictly smaller and the one after smaller or equal
  (both strictly on the diagonals); outside the image the magnitude is 0;
- a pixel above `low` that survives is a weak edge, above `high` a strong
  one; weak edges 8-connected to a strong one are kept, grown ring by ring
  up to `rings` rings (the configuration states the bound).

Returns a uint8 (B, H, W) map of 0 / 255.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

TG22 = 13573
SHIFT = 15


def _neighbour(m: torch.Tensor, dy: int, dx: int) -> torch.Tensor:
    """m at (i + dy, j + dx), 0 outside."""
    p = F.pad(m, (1, 1, 1, 1))
    h, w = m.shape[-2:]
    return p[..., 1 + dy: 1 + dy + h, 1 + dx: 1 + dx + w]


def canny(img: torch.Tensor, low: int, high: int, rings: int) -> torch.Tensor:
    """img (B, H, W, C) uint8 -> (B, H, W) uint8 edges."""
    x = img.permute(0, 3, 1, 2).to(torch.float64)
    b, c, h, w = x.shape
    kx = torch.tensor([[-1, 0, 1], [-2, 0, 2], [-1, 0, 1]], dtype=torch.float64, device=img.device)
    kernel = torch.stack([kx, kx.t()])[:, None].repeat(c, 1, 1, 1)  # (2C, 1, 3, 3)
    grad = F.conv2d(F.pad(x, (1, 1, 1, 1), mode="replicate"), kernel, groups=c)
    gx, gy = grad[:, 0::2].round().long(), grad[:, 1::2].round().long()
    mag_c = gx.abs() + gy.abs()
    best = mag_c.argmax(dim=1, keepdim=True)  # first maximum
    mag = mag_c.gather(1, best)[:, 0]
    gx, gy = gx.gather(1, best)[:, 0], gy.gather(1, best)[:, 0]

    ax, ay = gx.abs(), gy.abs() << SHIFT
    t22 = ax * TG22
    t67 = t22 + (ax << (SHIFT + 1))
    left, right = _neighbour(mag, 0, -1), _neighbour(mag, 0, 1)
    up, down = _neighbour(mag, -1, 0), _neighbour(mag, 1, 0)
    opposite = (gx < 0) != (gy < 0)
    d1 = torch.where(opposite, _neighbour(mag, -1, 1), _neighbour(mag, -1, -1))
    d2 = torch.where(opposite, _neighbour(mag, 1, -1), _neighbour(mag, 1, 1))
    keep = torch.where(ay < t22, (mag > left) & (mag >= right),
                       torch.where(ay > t67, (mag > up) & (mag >= down), (mag > d1) & (mag > d2)))
    weak = keep & (mag > low)
    edges = weak & (mag > high)
    for _ in range(rings):
        grown = F.max_pool2d(edges[:, None].float(), 3, stride=1, padding=1)[:, 0] > 0
        nxt = edges | (weak & grown)
        if torch.equal(nxt, edges):
            break
        edges = nxt
    return edges.to(torch.uint8) * 255
