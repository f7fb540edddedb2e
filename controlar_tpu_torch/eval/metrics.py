"""The controllability metrics of the consistency evaluation, with the JAX
package's definitions (`controlar_tpu/eval/metrics.py`):

- F1score: binarize at 128, binary F1 (canny);
- RMSE: per-image RMSE of the raw maps (depth);
- SSIM: multi-scale SSIM on uint8 maps / 255, torchmetrics' defaults
  (Gaussian window 11, sigma 1.5, betas (0.0448, 0.2856, 0.3001, 0.2363,
  0.1333), k1 0.01, k2 0.03), computed on a device (hed, lineart).

Each is streaming: update(true, pred) per image, calculate() the mean.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from controlar_tpu_torch import resolve_device


class F1score:
    def __init__(self, threshold: int = 128):
        self.threshold = threshold
        self.total = 0.0
        self.count = 0

    def update(self, img_true: np.ndarray, img_pred: np.ndarray):
        yt = (np.asarray(img_true) > self.threshold).astype(np.int64).ravel()
        yp = (np.asarray(img_pred) > self.threshold).astype(np.int64).ravel()
        tp = np.sum((yt == 1) & (yp == 1))
        fp = np.sum((yt == 0) & (yp == 1))
        fn = np.sum((yt == 1) & (yp == 0))
        denom = 2 * tp + fp + fn
        self.total += (2 * tp / denom) if denom > 0 else 0.0
        self.count += 1

    def calculate(self) -> float:
        return self.total / max(self.count, 1)


class RMSE:
    def __init__(self):
        self.total = 0.0
        self.count = 0

    def update(self, a: np.ndarray, b: np.ndarray):
        diff = np.asarray(a, np.float64) - np.asarray(b, np.float64)
        self.total += float(np.sqrt(np.mean(diff ** 2)))
        self.count += 1

    def calculate(self) -> float:
        return self.total / max(self.count, 1)


_MSSSIM_BETAS = (0.0448, 0.2856, 0.3001, 0.2363, 0.1333)


def _gaussian_kernel(size: int = 11, sigma: float = 1.5) -> np.ndarray:
    x = np.arange(size, dtype=np.float64) - (size - 1) / 2
    g = np.exp(-(x ** 2) / (2 * sigma ** 2))
    g /= g.sum()
    return np.outer(g, g).astype(np.float32)


def _ssim_pair(x: torch.Tensor, y: torch.Tensor, data_range: float = 1.0,
               k1: float = 0.01, k2: float = 0.03):
    """x, y: (B, C, H, W). -> (mean SSIM, mean contrast-structure) per image,
    the window VALID."""
    c = x.shape[1]
    kern = torch.from_numpy(_gaussian_kernel()).to(x.device)[None, None].repeat(c, 1, 1, 1)

    def filt(a):
        return F.conv2d(a, kern, groups=c)

    c1, c2 = (k1 * data_range) ** 2, (k2 * data_range) ** 2
    mu_x, mu_y = filt(x), filt(y)
    mu_x2, mu_y2, mu_xy = mu_x * mu_x, mu_y * mu_y, mu_x * mu_y
    sig_x = filt(x * x) - mu_x2
    sig_y = filt(y * y) - mu_y2
    sig_xy = filt(x * y) - mu_xy
    cs = (2 * sig_xy + c2) / (sig_x + sig_y + c2)
    ssim = ((2 * mu_xy + c1) / (mu_x2 + mu_y2 + c1)) * cs
    return ssim.mean(dim=(1, 2, 3)), cs.mean(dim=(1, 2, 3))


def ms_ssim(x: torch.Tensor, y: torch.Tensor, data_range: float = 1.0) -> torch.Tensor:
    """Multi-scale SSIM per image. x, y: (B, H, W, C) in [0, data_range];
    the 5 scales need H, W >= 176."""
    x = x.float().permute(0, 3, 1, 2)
    y = y.float().permute(0, 3, 1, 2)
    mcs = []
    for i in range(len(_MSSSIM_BETAS)):
        sim, cs = _ssim_pair(x, y, data_range)
        if i < len(_MSSSIM_BETAS) - 1:
            mcs.append(torch.clamp(cs, min=0.0))
            x, y = F.avg_pool2d(x, 2), F.avg_pool2d(y, 2)
    out = torch.clamp(sim, min=0.0) ** _MSSSIM_BETAS[-1]
    for beta, cs in zip(_MSSSIM_BETAS[:-1], mcs):
        out = out * cs ** beta
    return out


class SSIM:
    """Streaming MS-SSIM on uint8 maps (inputs / 255), computed on `device`
    (raises if a card is asked for and none is present)."""

    def __init__(self, device="cuda"):
        self.device = resolve_device(device)
        self.total = 0.0
        self.count = 0

    def update(self, a: np.ndarray, b: np.ndarray):
        a = torch.as_tensor(np.asarray(a, np.float32) / 255.0, device=self.device)
        b = torch.as_tensor(np.asarray(b, np.float32) / 255.0, device=self.device)
        if a.dim() == 2:
            a, b = a[None, :, :, None], b[None, :, :, None]
        elif a.dim() == 3:
            a, b = a[None], b[None]
        self.total += float(ms_ssim(a.clamp(0, 1), b.clamp(0, 1)).mean())
        self.count += 1

    def calculate(self) -> float:
        return self.total / max(self.count, 1)
