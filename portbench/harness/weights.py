"""Weights in the released checkpoints' layouts, made on the device from the
seed. Each tensor draws from its own generator, seeded by (seed, part, its
index), so the same seed gives the same tensors in any order, and the
reference can make them again after the program is gone."""
from __future__ import annotations

import hashlib
import math
from typing import Dict, Iterable, Tuple

import torch

Spec = Tuple[str, tuple, str]


def _seed(seed: int, part: str, index: int) -> int:
    h = hashlib.sha256(f"{seed}:{part}:{index}".encode()).digest()
    return int.from_bytes(h[:8], "little") >> 1


def make(specs: Iterable[Spec], seed: int, part: str, device, dtype=torch.float32,
         std: float = 0.02, caption_dim: int = 1) -> Dict[str, torch.Tensor]:
    """{key: tensor} of every spec. Inits: "normal" N(0, std); "scale"
    1 + N(0, 0.1) (a norm's or layer scale's weight); "bias" N(0, 0.02);
    "caption" N(0, 1 / caption_dim); "conv" uniform in +-1 / sqrt(fan in);
    "code" uniform in +-1 (the codebook, l2-normalised where it is used).
    Drawn in fp32, then cast to `dtype`."""
    specs = list(specs)
    fans = {k[: -len(".weight")] + ".bias": math.prod(shape[1:])
            for k, shape, init in specs if init == "conv" and k.endswith(".weight")}
    out = {}
    for i, (key, shape, init) in enumerate(specs):
        gen = torch.Generator(device=device).manual_seed(_seed(seed, part, i))
        if init in ("conv", "code"):
            # a convolution's bias draws with its weight's fan in
            fan = 1 if init == "code" else fans.get(key) or math.prod(shape[1:])
            t = (torch.rand(shape, generator=gen, device=device) * 2 - 1) / math.sqrt(fan)
        else:
            t = torch.randn(shape, generator=gen, device=device)
            if init == "normal":
                t = t * std
            elif init == "scale":
                t = 1.0 + 0.1 * t
            elif init == "bias":
                t = 0.02 * t
            elif init == "caption":
                t = t / math.sqrt(caption_dim)
            else:
                raise ValueError(init)
        out[key] = t.to(dtype)
    return out


def as_served(params: Dict[str, torch.Tensor], dtype: torch.dtype) -> Dict[str, torch.Tensor]:
    """The values as a checkpoint in `dtype` holds them, in fp32: what the
    reference computes with when the program is handed `dtype` weights."""
    return {k: v.to(dtype).float() for k, v in params.items()}
