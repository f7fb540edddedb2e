"""Random weights for the condition networks, made from a seed on the
device they will run on."""
from __future__ import annotations

from typing import Callable, Optional

import torch
from torch import nn

from controlar_tpu_torch import resolve_device


def init_random(make: Callable[[], nn.Module], seed: int, device,
                weight_std: Optional[float] = None) -> nn.Module:
    """Build `make()` in fp32 on the meta device and fill it on `device`: each
    `weight` normal with std `weight_std` (None: 1 / sqrt(fan_in), fan_in
    the weight's size over its first dimension), biases zero, norm scales
    one, every other parameter (class token, position table, input shift)
    normal(0, 0.02). Returns the module in eval mode without gradients.
    Raises if `device` is a card and none is present."""
    device = resolve_device(device)
    with torch.device("meta"):
        model = make().float()
    model = model.to_empty(device=device)
    gen = torch.Generator(device=device).manual_seed(seed)
    with torch.no_grad():
        for name, p in model.named_parameters():
            leaf = name.rsplit(".", 1)[-1]
            if leaf == "scale":
                p.fill_(1.0)
            elif leaf == "bias":
                p.zero_()
            else:
                std = 0.02
                if leaf == "weight":
                    std = weight_std or (p.numel() // p.shape[0]) ** -0.5
                p.copy_(torch.randn(p.shape, generator=gen, device=device) * std)
    return model.eval().requires_grad_(False)
