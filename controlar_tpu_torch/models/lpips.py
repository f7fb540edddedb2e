"""LPIPS perceptual distance: torchvision VGG16 feature slices and the learned
1x1 heads (the JAX package's `models/lpips.py`).

ScalingLayer -> the VGG16 slices ending at relu1_2, relu2_2, relu3_3, relu4_3
and relu5_3 (3x3 convolutions padded 1, 2x2 max pools between slices) ->
channel normalisation (eps 1e-10 added to the norm) -> squared difference ->
1x1 heads without bias -> spatial mean -> sum over the five slices. NHWC
activations, images in [-1, 1], OIHW weights.

The network is frozen in VQ training: its parameters take no gradient, the
gradient flows through it to the reconstruction.
"""
from __future__ import annotations

from typing import List, Sequence

import numpy as np
import torch
from torch import nn

from controlar_tpu_torch import resolve_device
from controlar_tpu_torch.ops.conv import Conv, conv2d, max_pool2d

# the reference's ScalingLayer constants
_SHIFT = np.array([-0.030, -0.088, -0.188], np.float32)
_SCALE = np.array([0.458, 0.448, 0.450], np.float32)

# torchvision vgg16.features convolution indices, one tuple a slice
VGG_SLICES = [(0, 2), (5, 7), (10, 12, 14), (17, 19, 21), (24, 26, 28)]
# each slice's width in VGG16
VGG16_WIDTHS = (64, 128, 256, 512, 512)


class LPIPS(nn.Module):
    """`vgg[str(i)]` the VGG convolution at features index i, `lins[k]` the
    1x1 head of slice k. `widths` are the slices' channels (VGG16's by
    default; tests use narrow ones)."""

    def __init__(self, widths: Sequence[int] = VGG16_WIDTHS):
        super().__init__()
        convs, cin = {}, 3
        for width, ids in zip(widths, VGG_SLICES):
            for i in ids:
                convs[str(i)] = Conv(cin, width, 3)
                cin = width
        self.vgg = nn.ModuleDict(convs)
        self.lins = nn.ModuleList(Conv(w, 1, 1, bias=False) for w in widths)


def init_lpips(seed: int = 0, widths: Sequence[int] = VGG16_WIDTHS, device="cuda") -> LPIPS:
    """Random weights from a seed, the JAX package's init distribution: VGG
    weights normal / sqrt(9 C_in), biases zero, heads |normal| x 0.01.
    Frozen: eval mode, no gradients."""
    device = resolve_device(device)
    with torch.device("meta"):
        model = LPIPS(widths)
    model = model.to_empty(device=device)
    gen = torch.Generator(device=device).manual_seed(seed)
    with torch.no_grad():
        for conv in model.vgg.values():
            cin = conv.weight.shape[1]
            conv.weight.copy_(torch.randn(conv.weight.shape, generator=gen, device=device)
                              / np.sqrt(9 * cin))
            conv.bias.zero_()
        for lin in model.lins:
            lin.weight.copy_(torch.randn(lin.weight.shape, generator=gen, device=device).abs()
                             * 0.01)
    return model.eval().requires_grad_(False)


def vgg16_features(model: LPIPS, x: torch.Tensor) -> List[torch.Tensor]:
    """x: (B, H, W, 3), already scaled -> the five slices' relu outputs."""
    feats, h = [], x
    for si, ids in enumerate(VGG_SLICES):
        if si > 0:
            h = max_pool2d(h, 2, 2)
        for i in ids:
            conv = model.vgg[str(i)]
            h = torch.relu(conv2d(h, conv.weight, conv.bias))
        feats.append(h)
    return feats


def _normalize(f: torch.Tensor, eps: float = 1e-10) -> torch.Tensor:
    return f / (torch.sqrt((f * f).sum(-1, keepdim=True)) + eps)


def lpips(model: LPIPS, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """x, y: (B, H, W, 3) in [-1, 1] -> LPIPS per sample (B,)."""
    shift = torch.from_numpy(_SHIFT).to(x.device)
    scale = torch.from_numpy(_SCALE).to(x.device)
    fx = vgg16_features(model, (x - shift) / scale)
    fy = vgg16_features(model, (y - shift) / scale)
    total = 0.0
    for lin, a, b in zip(model.lins, fx, fy):
        d = (_normalize(a) - _normalize(b)) ** 2
        total = total + conv2d(d, lin.weight).mean(dim=(1, 2, 3))
    return total
