"""HED and lineart condition-map networks, NHWC, fp32.

- HED (ControlNet's annotator ControlNetHED_Apache2): a learned per-channel
  input shift, 5 blocks of [2, 2, 3, 3, 3] 3x3 convolutions (64 -> 512
  channels) with 2x2 max pools between them, a 1x1 side projection per
  block resized bilinearly to the input size, sigmoid of their mean x 255.
  Input (B, H, W, 3) raw 0..255 RGB floats; output (B, H, W) in 0..255.
- Lineart (a pix2pix generator): reflection pad + 7x7 conv, two stride-2
  3x3 convs, 3 residual blocks, two transposed convs, all with instance
  norm and ReLU, then reflection pad + 7x7 conv + sigmoid. Input raw RGB
  floats; output (B, H, W) in 0..1.
- `hed_nms`: Gaussian blur, 4-direction non-maximum suppression and a
  threshold over an edge map (scribble-style thinning), bit-exact uint8.
- `condition_map`: a raw image to the control map of any control type
  (Canny, HED, lineart, depth through DPT or MiDaS), the one rule the
  pipeline, the control train step and the consistency eval share.

Parameters follow the JAX package's trees (`blocks.i.convs.j`, `model0` ...
`model4`); `convert_ref` loads the published checkpoints' key layouts.
"""
from __future__ import annotations

from typing import Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from controlar_tpu_torch.models import dpt as dpt_model
from controlar_tpu_torch.models import midas as midas_model
from controlar_tpu_torch.models.init import init_random
from controlar_tpu_torch.ops.canny import canny
from controlar_tpu_torch.ops.conv import (
    Conv,
    conv2d,
    conv_transpose2d,
    max_pool2d,
    reflect_pad2d,
)
from controlar_tpu_torch.ops.norms import instance_norm
from controlar_tpu_torch.ops.resize import resize2d

HED_CHANNELS = (64, 128, 256, 512, 512)
HED_CONVS = (2, 2, 3, 3, 3)
LINEART_NGF = 64


# ---------------------------------------------------------------------------
# HED
# ---------------------------------------------------------------------------

class _DoubleBlock(nn.Module):
    def __init__(self, c_in: int, c_out: int, n_convs: int):
        super().__init__()
        self.convs = nn.ModuleList(Conv(c_in if j == 0 else c_out, c_out, 3)
                                   for j in range(n_convs))
        self.projection = Conv(c_out, 1, 1)


class HED(nn.Module):
    def __init__(self, channels: Sequence[int] = HED_CHANNELS):
        super().__init__()
        self.norm = nn.Parameter(torch.empty(3))
        ins = (3, *channels[:-1])
        self.blocks = nn.ModuleList(_DoubleBlock(i, o, n)
                                    for i, o, n in zip(ins, channels, HED_CONVS))


def init_hed(seed: int = 0, device="cuda", channels: Sequence[int] = HED_CHANNELS) -> HED:
    """A HED with random weights from `seed` (fan-in scaled)."""
    return init_random(lambda: HED(channels), seed, device)


def hed_forward(model: HED, x: torch.Tensor) -> torch.Tensor:
    """x: (B, H, W, 3) raw RGB floats -> (B, H, W) edge map in 0..255."""
    _, h, w, _ = x.shape
    y = x - model.norm
    ups = []
    for i, blk in enumerate(model.blocks):
        if i > 0:
            y = max_pool2d(y, 2, 2)
        for conv in blk.convs:
            y = F.relu(conv2d(y, conv.weight, conv.bias))
        proj = conv2d(y, blk.projection.weight, blk.projection.bias)
        ups.append(resize2d(proj, h, w, mode="bilinear", align_corners=False)[..., 0])
    edge = torch.sigmoid(torch.stack(ups, dim=1).mean(dim=1))
    return torch.clamp(edge * 255.0, 0, 255)


# ---------------------------------------------------------------------------
# Lineart
# ---------------------------------------------------------------------------

class _ResBlock(nn.Module):
    def __init__(self, c: int):
        super().__init__()
        self.conv1 = Conv(c, c, 3)
        self.conv2 = Conv(c, c, 3)


class Lineart(nn.Module):
    def __init__(self, ngf: int = LINEART_NGF, n_residual: int = 3):
        super().__init__()
        self.model0 = Conv(3, ngf, 7)
        self.model1 = nn.ModuleList([Conv(ngf, 2 * ngf, 3), Conv(2 * ngf, 4 * ngf, 3)])
        self.model2 = nn.ModuleList(_ResBlock(4 * ngf) for _ in range(n_residual))
        self.model3 = nn.ModuleList([Conv(4 * ngf, 2 * ngf, 3, transposed=True),
                                     Conv(2 * ngf, ngf, 3, transposed=True)])
        self.model4 = Conv(ngf, 1, 7)


def init_lineart(seed: int = 0, device="cuda", ngf: int = LINEART_NGF) -> Lineart:
    """A lineart generator with random weights from `seed` (fan-in scaled)."""
    return init_random(lambda: Lineart(ngf), seed, device)


def _in_relu(x: torch.Tensor) -> torch.Tensor:
    return F.relu(instance_norm(x))


def lineart_forward(model: Lineart, x: torch.Tensor) -> torch.Tensor:
    """x: (B, H, W, 3) raw RGB floats -> (B, H, W) line map in 0..1."""
    m0 = model.model0
    y = _in_relu(conv2d(reflect_pad2d(x, 3), m0.weight, m0.bias, padding="VALID"))
    for conv in model.model1:  # torch's padding 1 on both sides, not XLA SAME
        y = _in_relu(conv2d(y, conv.weight, conv.bias, stride=2, padding=((1, 1), (1, 1))))
    for blk in model.model2:
        r = conv2d(reflect_pad2d(y, 1), blk.conv1.weight, blk.conv1.bias, padding="VALID")
        r = conv2d(reflect_pad2d(_in_relu(r), 1), blk.conv2.weight, blk.conv2.bias,
                   padding="VALID")
        y = y + instance_norm(r)
    for conv in model.model3:
        y = _in_relu(conv_transpose2d(y, conv.weight, conv.bias, stride=2, padding=1,
                                      output_padding=1))
    m4 = model.model4
    y = conv2d(reflect_pad2d(y, 3), m4.weight, m4.bias, padding="VALID")
    return torch.sigmoid(y)[..., 0]


# ---------------------------------------------------------------------------
# HED edge NMS
# ---------------------------------------------------------------------------

def hed_nms(x: torch.Tensor, t: float, s: float) -> torch.Tensor:
    """Directional NMS over an edge map: Gaussian blur (sigma s, OpenCV's
    kernel size for float input, REFLECT_101 borders), keep the pixels equal
    to the 3-pixel dilation along any of the 4 line directions (borders
    -inf), then > t -> 255. x: (H, W) or (B, H, W); returns uint8 {0, 255}
    of the same shape."""
    squeeze = x.dim() == 2
    if squeeze:
        x = x[None]
    x = x.float()
    _, h, w = x.shape
    k = int(round(s * 8 + 1)) | 1  # cv2.GaussianBlur((0, 0), s) on CV_32F
    half = k // 2
    i = np.arange(k) - half
    g = np.exp(-(i.astype(np.float64) ** 2) / (2.0 * s * s))
    g = [float(v) for v in (g / g.sum()).astype(np.float32)]
    xp = F.pad(x[:, None], (0, 0, half, half), mode="reflect")[:, 0]
    x_blur = sum(g[j] * xp[:, j:j + h, :] for j in range(k))
    xp = F.pad(x_blur[:, None], (half, half, 0, 0), mode="reflect")[:, 0]
    x_blur = sum(g[j] * xp[:, :, j:j + w] for j in range(k))

    p = F.pad(x_blur[:, None], (1, 1, 1, 1), value=float("-inf"))[:, 0]
    c = p[:, 1:-1, 1:-1]
    horiz = torch.maximum(torch.maximum(p[:, 1:-1, :-2], c), p[:, 1:-1, 2:])
    vert = torch.maximum(torch.maximum(p[:, :-2, 1:-1], c), p[:, 2:, 1:-1])
    diag1 = torch.maximum(torch.maximum(p[:, :-2, :-2], c), p[:, 2:, 2:])
    diag2 = torch.maximum(torch.maximum(p[:, :-2, 2:], c), p[:, 2:, :-2])
    is_max = (c >= horiz) | (c >= vert) | (c >= diag1) | (c >= diag2)
    y = torch.where(is_max, x_blur, 0.0)
    z = torch.where(y > t, 255, 0).to(torch.uint8)
    return z[0] if squeeze else z


def condition_map(condition_type: str, x: torch.Tensor, *, hed=None, lineart=None,
                  depth_fn=None, midas=None, midas_cfg=None, dpt=None, dpt_cfg=None,
                  canny_low: int = 100, canny_high: int = 200) -> torch.Tensor:
    """RGB uint8 images (B, H, W, 3) on the device -> the control map (B, H,
    W) in 0..255: Canny (uint8), HED, lineart (x 255) or depth. Depth takes
    `depth_fn` ((B, H, W, 3) uint8 -> (B, H, W) 0..255) when given, else the
    MiDaS detector at the image's own size, else DPT on the image resized
    to H x H. The networks run in fp32."""
    if condition_type == "canny":
        return canny(x, canny_low, canny_high)
    if condition_type in ("hed", "lineart"):
        net = hed if condition_type == "hed" else lineart
        if net is None:
            raise ValueError(f"condition type {condition_type!r} needs its network")
        if condition_type == "hed":
            return hed_forward(net, x.float())
        return lineart_forward(net, x.float()) * 255.0
    if condition_type == "depth":
        if depth_fn is not None:
            return torch.as_tensor(np.asarray(depth_fn(x.cpu().numpy())), device=x.device)
        if midas is not None:
            return midas_model.midas_depth_condition(midas, midas_cfg or midas_model.MIDAS_HYBRID,
                                                     x)
        if dpt is None:
            raise ValueError("depth needs depth_fn, a MiDaS or a DPT model")
        pre = dpt_model.preprocess_depth_input(x, size=x.shape[1])
        depth = dpt_model.dpt_depth(dpt, dpt_cfg or dpt_model.DPT_LARGE, pre)
        return dpt_model.depth_to_condition(depth)
    raise ValueError(f"condition type {condition_type!r}")
