"""Image resizing with torch.nn.functional.interpolate semantics, written as
separable matrix products: out = R_h @ x @ R_w^T, with the matrices built
once per shape on the host (the JAX package's formulation, so both packages
resize identically)."""
from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch


def _cubic_weight(t: np.ndarray, a: float = -0.75) -> np.ndarray:
    """Cubic convolution kernel (torch uses A = -0.75)."""
    t = np.abs(t)
    return np.where(
        t <= 1,
        (a + 2) * t ** 3 - (a + 3) * t ** 2 + 1,
        np.where(t < 2, a * t ** 3 - 5 * a * t ** 2 + 8 * a * t - 4 * a, 0.0),
    )


@lru_cache(maxsize=256)
def _resize_matrix(n_in: int, n_out: int, mode: str, align_corners: bool) -> np.ndarray:
    """(n_out, n_in) row-stochastic interpolation matrix, float32."""
    m = np.zeros((n_out, n_in), dtype=np.float64)
    if mode == "nearest":
        # torch 'nearest': src = floor(i * n_in / n_out)
        idx = np.minimum((np.arange(n_out) * n_in) // n_out, n_in - 1)
        m[np.arange(n_out), idx] = 1.0
        return m.astype(np.float32)

    if align_corners:
        src = (np.zeros(n_out) if n_out == 1
               else np.arange(n_out) * (n_in - 1) / (n_out - 1))
    else:
        src = (np.arange(n_out) + 0.5) * n_in / n_out - 0.5

    lo = np.floor(src).astype(int)
    frac = src - lo
    if mode == "bilinear":
        for i in range(n_out):
            m[i, min(max(lo[i], 0), n_in - 1)] += 1 - frac[i]
            m[i, min(max(lo[i] + 1, 0), n_in - 1)] += frac[i]
    elif mode == "bicubic":
        for i in range(n_out):
            for k in range(-1, 3):
                m[i, min(max(lo[i] + k, 0), n_in - 1)] += _cubic_weight(np.array(k - frac[i]))
    else:
        raise ValueError(mode)
    return m.astype(np.float32)


def resize2d(
    x: torch.Tensor,
    out_h: int,
    out_w: int,
    mode: str = "bilinear",
    align_corners: bool = False,
) -> torch.Tensor:
    """Resize NHWC (or HWC) images; fp32 math, cast back to x's dtype."""
    squeeze = x.dim() == 3
    if squeeze:
        x = x[None]
    _, h, w, _ = x.shape
    rh = torch.from_numpy(_resize_matrix(h, out_h, mode, align_corners)).to(x.device)
    rw = torch.from_numpy(_resize_matrix(w, out_w, mode, align_corners)).to(x.device)
    y = torch.einsum("oh,bhwc->bowc", rh, x.float())
    y = torch.einsum("pw,bowc->bopc", rw, y).to(x.dtype)
    return y[0] if squeeze else y


def to_patch14(x: torch.Tensor, condition_type: str) -> torch.Tensor:
    """Map a /16-grid image onto a /14 grid so that the DINOv2 token count
    equals the VQ token count: nearest for canny and seg maps, bicubic with
    align_corners for the others. x: (B, H, W, C), H and W multiples of 16."""
    _, h, w, _ = x.shape
    new_h, new_w = (h // 16) * 14, (w // 16) * 14
    if condition_type in ("canny", "seg"):
        return resize2d(x, new_h, new_w, mode="nearest")
    return resize2d(x, new_h, new_w, mode="bicubic", align_corners=True)
