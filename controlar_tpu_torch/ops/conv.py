"""Convolution helpers with NHWC activations at the boundary and torch's
OIHW weights. The NHWC -> NCHW permute is a view: the convolution sees a
channels-last tensor and returns one, so no copy is made on either side."""
from __future__ import annotations

from typing import Optional, Tuple, Union

import torch
import torch.nn.functional as F


def conv2d(
    x: torch.Tensor,
    w: torch.Tensor,
    b: Optional[torch.Tensor] = None,
    stride: Union[int, Tuple[int, int]] = 1,
    padding: str = "SAME",
) -> torch.Tensor:
    """x: (B, H, W, C_in), w: (C_out, C_in, KH, KW). padding: 'SAME' (stride 1
    only) or 'VALID'."""
    y = F.conv2d(x.permute(0, 3, 1, 2), w, b, stride=stride, padding=padding.lower())
    return y.permute(0, 2, 3, 1)


def upsample_nearest2x(x: torch.Tensor) -> torch.Tensor:
    """Nearest-neighbour 2x upsample, NHWC."""
    b, h, w, c = x.shape
    return x[:, :, None, :, None, :].expand(b, h, 2, w, 2, c).reshape(b, h * 2, w * 2, c)
