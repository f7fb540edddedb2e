"""Taming-Transformers VQGAN, the reference's comparison tokenizers (the JAX
package's `models/taming_vqgan.py`). NHWC activations, images in [-1, 1].

Four released configs (`TAMING_CONFIGS`): ImageNet f16-1024 and f16-16384,
OpenImages f8-256 (a 16384-entry codebook remapped onto 256 used entries,
the table given at load time) and f8-16384. What differs from the VQ-16 of
`models/vq.py`, whose blocks (ResnetBlock, AttnBlock, up / downsample,
GroupNorm-swish) it reuses:
- attention blocks sit by RESOLUTION (`attn_resolutions`) in the encoder
  and the decoder, not only at the lowest level;
- each decoder level runs num_res_blocks + 1 resnet blocks;
- the quantizer takes raw L2 distances (no l2-normalised codebook) and
  can remap the full codebook onto a used subset; ids outside it go to
  `unknown_index`: "extra" (one id past the subset), an int, or "random"
  (drawn from a torch.Generator, so only the range agrees with the JAX
  package's draws);
- beta 0.25 and the legacy loss ordering (`legacy`).

Module names are the JAX tree's (`encoder.down.{i}.block.{j}`,
`decoder.up.{i}.attn.{j}`, `mid.block_1`, norms' `scale`, `embedding`),
which are taming's state-dict keys but for `.weight` of a norm and
`quantize.embedding.weight` (`convert_ref.TAMING_RULES`).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Optional, Tuple

import numpy as np
import torch
from torch import nn

from controlar_tpu_torch import check_on, resolve_device
from controlar_tpu_torch.models.vq import (AttnBlock, Conv, Resample, ResnetBlock, _conv, _norm,
                                           attn_block, downsample, resnet_block, swish, upsample)
from controlar_tpu_torch.ops.norms import Affine


@dataclasses.dataclass(frozen=True)
class TamingVQConfig:
    ch: int = 128
    out_ch: int = 3
    in_channels: int = 3
    ch_mult: Tuple[int, ...] = (1, 1, 2, 2, 4)
    num_res_blocks: int = 2
    attn_resolutions: Tuple[int, ...] = (16,)
    resolution: int = 256
    z_channels: int = 256
    n_embed: int = 1024
    embed_dim: int = 256
    beta: float = 0.25
    legacy: bool = True
    # remap: indices of the used codebook rows; unknown_index: "random" |
    # "extra" | int ("extra" appends one id)
    remap: Optional[Tuple[int, ...]] = None
    unknown_index: Any = "random"

    @property
    def num_resolutions(self) -> int:
        return len(self.ch_mult)

    @property
    def re_embed(self) -> int:
        if self.remap is None:
            return self.n_embed
        n = len(self.remap)
        return n + 1 if self.unknown_index == "extra" else n


# the reference's released comparison configs
TAMING_CONFIGS = {
    "vqgan_imagenet_f16_1024": TamingVQConfig(n_embed=1024, embed_dim=256),
    "vqgan_imagenet_f16_16384": TamingVQConfig(n_embed=16384, embed_dim=256),
    "vqgan_openimage_f8_256": TamingVQConfig(
        ch_mult=(1, 2, 2, 4), attn_resolutions=(32,), z_channels=4,
        n_embed=16384, embed_dim=4,
    ),  # released with a 256-entry remap table, given at load time
    "vqgan_openimage_f8_16384": TamingVQConfig(
        ch_mult=(1, 2, 2, 4), attn_resolutions=(32,), z_channels=4,
        n_embed=16384, embed_dim=4,
    ),
}


def _attn_gates(cfg: TamingVQConfig, decoder: bool):
    """Which levels carry attention, indexed as the levels are stored
    (high resolution first in both halves)."""
    gates = []
    if not decoder:
        curr = cfg.resolution
        for i in range(cfg.num_resolutions):
            gates.append(curr in cfg.attn_resolutions)
            if i != cfg.num_resolutions - 1:
                curr //= 2
    else:
        curr = cfg.resolution // 2 ** (cfg.num_resolutions - 1)
        rev = []
        for i_level in reversed(range(cfg.num_resolutions)):
            rev.append(curr in cfg.attn_resolutions)
            if i_level != 0:
                curr *= 2
        gates = rev[::-1]
    return gates


class Level(nn.Module):
    def __init__(self, block, attn, downsample=None, upsample=None):
        super().__init__()
        self.block = nn.ModuleList(block)
        self.attn = nn.ModuleList(attn)
        if downsample is not None:
            self.downsample = downsample
        if upsample is not None:
            self.upsample = upsample


class Mid(nn.Module):
    def __init__(self, c: int):
        super().__init__()
        self.block_1 = ResnetBlock(c, c)
        self.attn_1 = AttnBlock(c)
        self.block_2 = ResnetBlock(c, c)


class Encoder(nn.Module):
    def __init__(self, cfg: TamingVQConfig):
        super().__init__()
        gates = _attn_gates(cfg, decoder=False)
        in_mult = (1,) + tuple(cfg.ch_mult)
        self.conv_in = Conv(3, cfg.in_channels, cfg.ch)
        levels = []
        for i in range(cfg.num_resolutions):
            c, cout = cfg.ch * in_mult[i], cfg.ch * cfg.ch_mult[i]
            block, attn = [], []
            for _ in range(cfg.num_res_blocks):
                block.append(ResnetBlock(c, cout))
                c = cout
                if gates[i]:
                    attn.append(AttnBlock(c))
            last = i == cfg.num_resolutions - 1
            levels.append(Level(block, attn, downsample=None if last else Resample(c)))
        self.down = nn.ModuleList(levels)
        block_in = cfg.ch * cfg.ch_mult[-1]
        self.mid = Mid(block_in)
        self.norm_out = Affine(block_in)
        self.conv_out = Conv(3, block_in, cfg.z_channels)


class Decoder(nn.Module):
    def __init__(self, cfg: TamingVQConfig):
        super().__init__()
        gates = _attn_gates(cfg, decoder=True)
        c = cfg.ch * cfg.ch_mult[-1]
        self.conv_in = Conv(3, cfg.z_channels, c)
        self.mid = Mid(c)
        up = [None] * cfg.num_resolutions
        for i in reversed(range(cfg.num_resolutions)):
            cout = cfg.ch * cfg.ch_mult[i]
            block, attn = [], []
            for _ in range(cfg.num_res_blocks + 1):
                block.append(ResnetBlock(c, cout))
                c = cout
                if gates[i]:
                    attn.append(AttnBlock(c))
            up[i] = Level(block, attn, upsample=Resample(c) if i != 0 else None)
        self.up = nn.ModuleList(up)
        self.norm_out = Affine(c)
        self.conv_out = Conv(3, c, cfg.out_ch)


class TamingVQModel(nn.Module):
    def __init__(self, cfg: TamingVQConfig):
        super().__init__()
        self.encoder = Encoder(cfg)
        self.decoder = Decoder(cfg)
        self.quant_conv = Conv(1, cfg.z_channels, cfg.embed_dim)
        self.post_quant_conv = Conv(1, cfg.embed_dim, cfg.z_channels)
        self.embedding = nn.Parameter(torch.empty(cfg.n_embed, cfg.embed_dim))


def init_taming(cfg: TamingVQConfig, seed: int = 0, device="cuda",
                dtype: torch.dtype = torch.float32) -> TamingVQModel:
    """Random weights with the JAX package's init distribution, from a
    torch.Generator: conv weights normal * 0.05, biases 0, norms 1 and 0,
    the codebook uniform in +-1/n_embed. Raises if a card is asked for and
    none is present."""
    device = resolve_device(device)
    with torch.device("meta"):
        model = TamingVQModel(cfg)
    model = model.to_empty(device=device)
    gen = torch.Generator(device=device).manual_seed(seed)
    with torch.no_grad():
        for mod in model.modules():
            if isinstance(mod, Conv):
                mod.weight.copy_(torch.randn(mod.weight.shape, generator=gen,
                                             device=device) * 0.05)
                mod.bias.zero_()
            elif isinstance(mod, Affine):
                mod.scale.fill_(1.0)
                mod.bias.zero_()
        bound = 1.0 / cfg.n_embed
        model.embedding.copy_((torch.rand(model.embedding.shape, generator=gen, device=device)
                               * 2 - 1) * bound)
    return model.to(dtype).eval().requires_grad_(False)


def _mid(p: Mid, h: torch.Tensor) -> torch.Tensor:
    return resnet_block(p.block_2, attn_block(p.attn_1, resnet_block(p.block_1, h)))


def encoder_forward(p: Encoder, x: torch.Tensor) -> torch.Tensor:
    """x (B, H, W, 3) in [-1, 1] -> (B, h, w, z_channels)."""
    h = _conv(p.conv_in, x)
    for level in p.down:
        for j, rb in enumerate(level.block):
            h = resnet_block(rb, h)
            if len(level.attn):
                h = attn_block(level.attn[j], h)
        if hasattr(level, "downsample"):
            h = downsample(level.downsample, h)
    h = _mid(p.mid, h)
    return _conv(p.conv_out, swish(_norm(p.norm_out, h)))


def decoder_forward(p: Decoder, z: torch.Tensor) -> torch.Tensor:
    h = _mid(p.mid, _conv(p.conv_in, z))
    for level in reversed(p.up):
        for j, rb in enumerate(level.block):
            h = resnet_block(rb, h)
            if len(level.attn):
                h = attn_block(level.attn[j], h)
        if hasattr(level, "upsample"):
            h = upsample(level.upsample, h)
    return _conv(p.conv_out, swish(_norm(p.norm_out, h)))


def _used(cfg: TamingVQConfig, device) -> torch.Tensor:
    return torch.as_tensor(np.asarray(cfg.remap, np.int64), device=device)


def quantize(p: TamingVQModel, cfg: TamingVQConfig, z: torch.Tensor,
             generator: Optional[torch.Generator] = None):
    """z (B, h, w, embed_dim) -> (z_q straight-through, the codebook loss,
    indices (B, h, w) in remapped ids). Raw fp32 L2 distances; with a remap,
    a full-codebook argmin outside the used subset goes to unknown_index
    ("random" draws from `generator`, a fresh one seeded 0 when None)."""
    emb = p.embedding.float()
    b, h, w, d = z.shape
    flat = z.reshape(-1, d).float()
    dist = (flat * flat).sum(1, keepdim=True) + (emb * emb).sum(1) - 2.0 * flat @ emb.T
    idx = torch.argmin(dist, dim=1)
    z_q = emb[idx].reshape(z.shape).to(z.dtype)
    commit = torch.mean((z_q.detach() - z) ** 2)
    codebook = torch.mean((z_q - z.detach()) ** 2)
    loss = commit + cfg.beta * codebook if cfg.legacy else cfg.beta * commit + codebook
    z_q = z + (z_q - z).detach()
    if cfg.remap is not None:
        used = _used(cfg, idx.device)
        match = idx[:, None] == used[None, :]
        new = torch.argmax(match.int(), dim=1)
        unknown = ~match.any(dim=1)
        if cfg.unknown_index == "random":
            if generator is None:
                generator = torch.Generator(device=idx.device).manual_seed(0)
            rand = torch.randint(0, cfg.re_embed, new.shape, generator=generator,
                                 device=idx.device)
            new = torch.where(unknown, rand, new)
        elif cfg.unknown_index == "extra":
            new = torch.where(unknown, torch.full_like(new, cfg.re_embed - 1), new)
        else:
            new = torch.where(unknown, torch.full_like(new, int(cfg.unknown_index)), new)
        idx = new
    return z_q, loss, idx.reshape(b, h, w)


def codebook_entry(p: TamingVQModel, cfg: TamingVQConfig, indices: torch.Tensor,
                   shape_hw: Tuple[int, int]) -> torch.Tensor:
    """Remapped indices (B, h*w) or (B, h, w) -> z_q (B, h, w, embed_dim);
    the extra id maps to used row 0."""
    b = indices.shape[0]
    idx = indices.reshape(b, -1).long()
    if cfg.remap is not None:
        used = _used(cfg, idx.device)
        idx = used[torch.where(idx >= used.shape[0], torch.zeros_like(idx), idx)]
    h, w = shape_hw
    return p.embedding[idx.reshape(-1)].reshape(b, h, w, -1)


def encode(p: TamingVQModel, cfg: TamingVQConfig, x, generator=None, device="cuda"):
    """x (B, H, W, 3) in [-1, 1] -> (z_q, loss, indices). Runs on `device`
    ('cuda' unless the caller asks for 'cpu'); the model must be there."""
    dev = resolve_device(device)
    check_on(p, dev)
    x = torch.as_tensor(x, device=dev).to(p.embedding.dtype)
    h = _conv(p.quant_conv, encoder_forward(p.encoder, x))
    return quantize(p, cfg, h, generator)


def decode(p: TamingVQModel, cfg: TamingVQConfig, z_q: torch.Tensor) -> torch.Tensor:
    return decoder_forward(p.decoder, _conv(p.post_quant_conv, z_q))


def decode_code(p: TamingVQModel, cfg: TamingVQConfig, indices: torch.Tensor,
                shape_hw: Tuple[int, int]) -> torch.Tensor:
    return decode(p, cfg, codebook_entry(p, cfg, indices, shape_hw))


def reconstruct(p: TamingVQModel, cfg: TamingVQConfig, x, device="cuda") -> torch.Tensor:
    z_q, _, _ = encode(p, cfg, x, device=device)
    return decode(p, cfg, z_q)
