"""Convolution helpers with NHWC activations at the boundary and torch's
weights: OIHW for a convolution, (C_in, C_out, KH, KW) for a transposed one.
The NHWC -> NCHW permute is a view: the convolution sees a channels-last
tensor and returns one, so no copy is made on either side unless a padding
has to be applied by hand (TF `SAME` at stride > 1, uneven pairs)."""
from __future__ import annotations

import math
from typing import Optional, Sequence, Tuple, Union

import torch
import torch.nn.functional as F
from torch import nn

Padding = Union[str, Sequence[Tuple[int, int]]]


class Conv(nn.Module):
    """A convolution's parameters: weight (C_out, C_in, KH, KW), or
    (C_in, C_out, KH, KW) when transposed, and an optional bias."""

    def __init__(self, c_in: int, c_out: int, k: int, bias: bool = True,
                 transposed: bool = False):
        super().__init__()
        shape = (c_in, c_out, k, k) if transposed else (c_out, c_in, k, k)
        self.weight = nn.Parameter(torch.empty(shape))
        self.bias = nn.Parameter(torch.empty(c_out)) if bias else None


def _same_pads(size: int, k: int, stride: int) -> Tuple[int, int]:
    """TF / XLA `SAME`: out = ceil(size / stride); the odd pixel goes last."""
    total = max((math.ceil(size / stride) - 1) * stride + k - size, 0)
    return total // 2, total - total // 2


def conv2d(
    x: torch.Tensor,
    w: torch.Tensor,
    b: Optional[torch.Tensor] = None,
    stride: Union[int, Tuple[int, int]] = 1,
    padding: Padding = "SAME",
) -> torch.Tensor:
    """x: (B, H, W, C_in), w: (C_out, C_in, KH, KW). padding: 'SAME' (XLA's:
    asymmetric at stride > 1 when the size is even), 'VALID', or explicit
    ((top, bottom), (left, right))."""
    sh, sw = (stride, stride) if isinstance(stride, int) else stride
    if isinstance(padding, str):
        if padding.upper() == "VALID":
            pads = ((0, 0), (0, 0))
        elif padding.upper() == "SAME":
            pads = (_same_pads(x.shape[1], w.shape[2], sh), _same_pads(x.shape[2], w.shape[3], sw))
        else:
            raise ValueError(f"padding must be 'SAME', 'VALID' or pairs, got {padding!r}")
    else:
        pads = tuple(tuple(p) for p in padding)
    xc = x.permute(0, 3, 1, 2)
    (top, bottom), (left, right) = pads
    if top == bottom and left == right:
        y = F.conv2d(xc, w, b, stride=(sh, sw), padding=(top, left))
    else:
        y = F.conv2d(F.pad(xc, (left, right, top, bottom)), w, b, stride=(sh, sw))
    return y.permute(0, 2, 3, 1)


def conv_transpose2d(
    x: torch.Tensor,
    w: torch.Tensor,
    b: Optional[torch.Tensor] = None,
    stride: int = 2,
    padding: int = 1,
    output_padding: int = 1,
) -> torch.Tensor:
    """torch's ConvTranspose2d on NHWC: x (B, H, W, C_in), w (C_in, C_out, KH,
    KW) as torch stores it. Output size (H - 1) * stride - 2 * padding + KH +
    output_padding."""
    y = F.conv_transpose2d(x.permute(0, 3, 1, 2), w, b, stride=stride, padding=padding,
                           output_padding=output_padding)
    return y.permute(0, 2, 3, 1)


def max_pool2d(x: torch.Tensor, window: int = 2, stride: int = 2) -> torch.Tensor:
    """VALID max pool, NHWC."""
    return F.max_pool2d(x.permute(0, 3, 1, 2), window, stride).permute(0, 2, 3, 1)


def max_pool2d_same(x: torch.Tensor, window: int = 3, stride: int = 2) -> torch.Tensor:
    """Max pool with XLA `SAME` padding, NHWC: the padded pixels are -inf,
    the odd one last (`F.max_pool2d` pads symmetrically)."""
    (top, bottom), (left, right) = (_same_pads(x.shape[1], window, stride),
                                    _same_pads(x.shape[2], window, stride))
    xp = F.pad(x.permute(0, 3, 1, 2), (left, right, top, bottom), value=float("-inf"))
    return F.max_pool2d(xp, window, stride).permute(0, 2, 3, 1)


def reflect_pad2d(x: torch.Tensor, pad: int) -> torch.Tensor:
    """Reflection padding without the edge pixel (numpy's 'reflect',
    OpenCV's REFLECT_101), NHWC."""
    return F.pad(x.permute(0, 3, 1, 2), (pad,) * 4, mode="reflect").permute(0, 2, 3, 1)


def upsample_nearest2x(x: torch.Tensor) -> torch.Tensor:
    """Nearest-neighbour 2x upsample, NHWC."""
    b, h, w, c = x.shape
    return x[:, :, None, :, None, :].expand(b, h, 2, w, 2, c).reshape(b, h * 2, w * 2, c)
