"""Normalisation with the JAX package's mixed-precision rules."""
from __future__ import annotations

import torch
from torch import nn


class Affine(nn.Module):
    """The scale and bias of a layer or group norm."""

    def __init__(self, c: int):
        super().__init__()
        self.scale = nn.Parameter(torch.empty(c))
        self.bias = nn.Parameter(torch.empty(c))


def rms_norm(x: torch.Tensor, weight: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """RMSNorm: normalise in fp32, cast back to x's dtype, then scale.

    The cast back before the multiply by the weight matters for bit parity.
    """
    xf = x.float()
    normed = xf * torch.rsqrt(xf.pow(2).mean(-1, keepdim=True) + eps)
    return normed.to(x.dtype) * weight


def group_norm(
    x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
    num_groups: int = 32, eps: float = 1e-6,
) -> torch.Tensor:
    """GroupNorm over NHWC input (B, H, W, C); statistics in fp32 over
    (H, W, C/groups), biased variance."""
    b, h, w, c = x.shape
    num_groups = min(num_groups, c)  # tiny test configs; real models use c >= 128
    xf = x.float().reshape(b, h, w, num_groups, c // num_groups)
    mean = xf.mean(dim=(1, 2, 4), keepdim=True)
    var = (xf - mean).pow(2).mean(dim=(1, 2, 4), keepdim=True)
    xn = (xf - mean) * torch.rsqrt(var + eps)
    return xn.reshape(b, h, w, c).to(x.dtype) * scale + bias


def instance_norm(x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """InstanceNorm2d without affine parameters over NHWC input: per (B, C)
    statistics over (H, W) in fp32, biased variance, cast back."""
    xf = x.float()
    mean = xf.mean(dim=(1, 2), keepdim=True)
    var = (xf - mean).pow(2).mean(dim=(1, 2), keepdim=True)
    return ((xf - mean) * torch.rsqrt(var + eps)).to(x.dtype)
