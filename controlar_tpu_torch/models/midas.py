"""MiDaS DPT-Hybrid depth estimator (BiT-R50 trunk + ViT-B/16), NHWC, fp32:
the detector the depth and multi-resolution checkpoints were trained
against (`dpt_hybrid-midas-501f0c75.pt`, timm `vit_base_resnet50_384`).

- BiT ResNetV2 trunk: weight-standardized convolutions (eps 1e-8, XLA
  `SAME` padding: asymmetric at stride 2), GroupNorm(32) + ReLU, non-preact
  bottlenecks, layers (3, 4, 9); stages 0 (256 ch, /4) and 1 (512 ch, /8)
  are the DPT's first two maps.
- ViT-B/16 over the /16 map (1x1 patch projection, CLS token, bilinearly
  resized position table, align_corners=False), 12 pre-LN blocks with a
  fused qkv and exact GELU; blocks 8 and 11 tapped before the final norm.
- Readout 'project' for the two taps, reassembled to /16 (1x1 conv) and /32
  (1x1 conv + 3x3 stride-2 conv).
- Bias-free 3x3 convs [256, 512, 768, 768] -> 256, four fusion blocks
  (pre-activation residual units, 2x bilinear align_corners=True, 1x1 out
  conv), head 256 -> 128 -> 2x -> 32 -> 1 with ReLU (the residual unit
  and head are DPT's, `models/dpt.py`).

Input NHWC in [-1, 1] at any size divisible by 32: the detector feeds the
raw image (`image / 127.5 - 1`) and min-max normalises the depth.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

import torch
import torch.nn.functional as F
from torch import nn

from controlar_tpu_torch.models.dpt import DepthHead, ResidualUnit, depth_head, residual_unit
from controlar_tpu_torch.models.init import init_random
from controlar_tpu_torch.models.vit import layer_norm
from controlar_tpu_torch.ops.conv import Conv, conv2d, max_pool2d_same
from controlar_tpu_torch.ops.norms import Affine, group_norm
from controlar_tpu_torch.ops.resize import resize2d


@dataclasses.dataclass(frozen=True)
class MidasHybridConfig:
    # ResNetV2 (BiT) trunk
    stem_width: int = 64
    layers: Tuple[int, ...] = (3, 4, 9)
    # ViT
    hidden_size: int = 768
    n_layer: int = 12
    n_head: int = 12
    mlp_dim: int = 3072
    pos_grid: int = 24              # 384 / 16 native
    vit_hooks: Tuple[int, int] = (8, 11)
    ln_eps: float = 1e-6
    gn_eps: float = 1e-5
    std_eps: float = 1e-8
    # DPT
    features: int = 256
    layer_channels: Tuple[int, ...] = (256, 512, 768, 768)

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.n_head

    @property
    def stage_channels(self) -> Tuple[int, ...]:
        return (256, 512, 1024)


MIDAS_HYBRID = MidasHybridConfig()


class _ConvNorm(nn.Module):
    def __init__(self, c_in: int, c_out: int, k: int):
        super().__init__()
        self.conv = Conv(c_in, c_out, k, bias=False)
        self.norm = Affine(c_out)


class _Bottleneck(nn.Module):
    def __init__(self, c_in: int, c_out: int, downsample: bool):
        super().__init__()
        mid = c_out // 4
        self.conv1, self.norm1 = Conv(c_in, mid, 1, bias=False), Affine(mid)
        self.conv2, self.norm2 = Conv(mid, mid, 3, bias=False), Affine(mid)
        self.conv3, self.norm3 = Conv(mid, c_out, 1, bias=False), Affine(c_out)
        if downsample:
            self.downsample = _ConvNorm(c_in, c_out, 1)


class _Trunk(nn.Module):
    def __init__(self, cfg: MidasHybridConfig):
        super().__init__()
        self.stem = _ConvNorm(3, cfg.stem_width, 7)
        ins = (cfg.stem_width, *cfg.stage_channels[:-1])
        self.stages = nn.ModuleList(
            nn.ModuleList(_Bottleneck(c_in if bi == 0 else c_out, c_out, bi == 0)
                          for bi in range(n))
            for n, c_in, c_out in zip(cfg.layers, ins, cfg.stage_channels))


class _Block(nn.Module):
    def __init__(self, cfg: MidasHybridConfig):
        super().__init__()
        d = cfg.hidden_size
        self.norm1, self.norm2 = Affine(d), Affine(d)
        self.qkv = nn.Linear(d, 3 * d)
        self.proj = nn.Linear(d, d)
        self.fc1 = nn.Linear(d, cfg.mlp_dim)
        self.fc2 = nn.Linear(cfg.mlp_dim, d)

    def forward(self, cfg: MidasHybridConfig, hs: torch.Tensor) -> torch.Tensor:
        b, t, c = hs.shape
        nh, dh = cfg.n_head, cfg.head_dim
        y = layer_norm(hs, self.norm1.scale, self.norm1.bias, cfg.ln_eps)
        q, k, v = (z.reshape(b, t, nh, dh) for z in self.qkv(y).chunk(3, dim=-1))
        s = torch.einsum("bthd,bshd->bhts", q.float(), k.float()) * dh ** -0.5
        a = torch.softmax(s, dim=-1).to(y.dtype)
        attn = torch.einsum("bhts,bshd->bthd", a.float(), v.float())
        hs = hs + self.proj(attn.to(y.dtype).reshape(b, t, c))
        y = layer_norm(hs, self.norm2.scale, self.norm2.bias, cfg.ln_eps)
        return hs + self.fc2(F.gelu(self.fc1(y)))


class _FusionBlock(nn.Module):
    def __init__(self, c: int):
        super().__init__()
        self.res1 = ResidualUnit(c)
        self.res2 = ResidualUnit(c)
        self.out = Conv(c, c, 1)


class MidasHybrid(nn.Module):
    def __init__(self, cfg: MidasHybridConfig = MIDAS_HYBRID):
        super().__init__()
        d, f, lc = cfg.hidden_size, cfg.features, cfg.layer_channels
        self.backbone = _Trunk(cfg)
        self.patch_proj = Conv(cfg.stage_channels[-1], d, 1)
        self.cls_token = nn.Parameter(torch.empty(1, d))
        self.pos_embed = nn.Parameter(torch.empty(1 + cfg.pos_grid ** 2, d))
        self.blocks = nn.ModuleList(_Block(cfg) for _ in range(cfg.n_layer))
        self.readout3 = nn.Linear(2 * d, d)
        self.readout4 = nn.Linear(2 * d, d)
        self.post3 = Conv(d, lc[2], 1)
        self.post4a = Conv(d, lc[3], 1)
        self.post4b = Conv(lc[3], lc[3], 3)
        self.layer_rn = nn.ModuleList(Conv(c, f, 3, bias=False) for c in lc)
        self.refinenet = nn.ModuleList(_FusionBlock(f) for _ in range(4))
        self.head = DepthHead(f)


def init_midas(cfg: MidasHybridConfig = MIDAS_HYBRID, seed: int = 0,
               device="cuda") -> MidasHybrid:
    """A MiDaS DPT-Hybrid with random weights from `seed`, with the JAX
    package's init distribution (`init_midas_params`): weights normal(0,
    0.05), zero biases, unit norms, CLS token and position table normal(0,
    0.02)."""
    return init_random(lambda: MidasHybrid(cfg), seed, device, weight_std=0.05)


def _std_conv(conv: Conv, x: torch.Tensor, stride: int, eps: float) -> torch.Tensor:
    """Weight-standardized conv (per output channel, biased variance), XLA
    `SAME` padding (timm StdConv2dSame)."""
    w = conv.weight.float()
    mean = w.mean(dim=(1, 2, 3), keepdim=True)
    var = (w - mean).pow(2).mean(dim=(1, 2, 3), keepdim=True)
    w = ((w - mean) * torch.rsqrt(var + eps)).to(x.dtype)
    return conv2d(x, w, conv.bias, stride=stride, padding="SAME")


def _gn(norm: Affine, x: torch.Tensor, eps: float, relu: bool = True) -> torch.Tensor:
    y = group_norm(x, norm.scale, norm.bias, num_groups=32, eps=eps)
    return F.relu(y) if relu else y


def _bottleneck(bp: _Bottleneck, cfg: MidasHybridConfig, x: torch.Tensor,
                stride: int) -> torch.Tensor:
    """Non-preact bottleneck: conv1-gn-relu, conv2 (stride)-gn-relu,
    conv3-gn, plus the (downsampled) shortcut, relu."""
    shortcut = x
    if hasattr(bp, "downsample"):
        shortcut = _gn(bp.downsample.norm,
                       _std_conv(bp.downsample.conv, x, stride, cfg.std_eps),
                       cfg.gn_eps, relu=False)
    h = _gn(bp.norm1, _std_conv(bp.conv1, x, 1, cfg.std_eps), cfg.gn_eps)
    h = _gn(bp.norm2, _std_conv(bp.conv2, h, stride, cfg.std_eps), cfg.gn_eps)
    h = _gn(bp.norm3, _std_conv(bp.conv3, h, 1, cfg.std_eps), cfg.gn_eps, relu=False)
    return F.relu(h + shortcut)


def _resnet_trunk(trunk: _Trunk, cfg: MidasHybridConfig, x: torch.Tensor):
    """x (B, H, W, 3) -> the stage maps at /4, /8 and /16."""
    h = _gn(trunk.stem.norm, _std_conv(trunk.stem.conv, x, 2, cfg.std_eps), cfg.gn_eps)
    h = max_pool2d_same(h, 3, 2)
    taps = []
    for si, blocks in enumerate(trunk.stages):
        for bi, bp in enumerate(blocks):
            h = _bottleneck(bp, cfg, h, 2 if (si > 0 and bi == 0) else 1)
        taps.append(h)
    return taps


def _resize_pos_embed(pos: torch.Tensor, g: int, gh: int, gw: int) -> torch.Tensor:
    """The grid part resized bilinearly (align_corners=False), CLS kept."""
    if (gh, gw) == (g, g):
        return pos
    grid = resize2d(pos[1:].reshape(g, g, -1).float(), gh, gw, mode="bilinear",
                    align_corners=False)
    return torch.cat([pos[:1], grid.reshape(gh * gw, -1).to(pos.dtype)])


def _project_readout(lin: nn.Linear, hs: torch.Tensor) -> torch.Tensor:
    """Tokens with the CLS token concatenated onto each -> Linear + GELU."""
    cls, tok = hs[:, :1], hs[:, 1:]
    return F.gelu(lin(torch.cat([tok, cls.expand_as(tok)], dim=-1)))


def _fusion_block(fb: _FusionBlock, x: torch.Tensor, skip=None) -> torch.Tensor:
    out = x if skip is None else x + residual_unit(fb.res1, skip)
    out = residual_unit(fb.res2, out)
    out = resize2d(out, out.shape[1] * 2, out.shape[2] * 2, mode="bilinear",
                   align_corners=True)
    return conv2d(out, fb.out.weight, fb.out.bias)


def midas_hybrid_depth(model: MidasHybrid, cfg: MidasHybridConfig,
                       x: torch.Tensor) -> torch.Tensor:
    """x: (B, H, W, 3) in [-1, 1], H and W multiples of 32 -> depth (B, H, W)."""
    b, h, w, _ = x.shape
    gh, gw, d = h // 16, w // 16, cfg.hidden_size
    s0, s1, s2 = _resnet_trunk(model.backbone, cfg, x)
    tokens = conv2d(s2, model.patch_proj.weight, model.patch_proj.bias, padding="VALID")
    hs = torch.cat([model.cls_token[None].expand(b, 1, d), tokens.reshape(b, gh * gw, d)],
                   dim=1)
    hs = hs + _resize_pos_embed(model.pos_embed, cfg.pos_grid, gh, gw)[None]
    taps = []
    for l in range(cfg.n_layer):
        hs = model.blocks[l](cfg, hs)
        if l in cfg.vit_hooks:
            taps.append(hs)
    t3, t4 = taps
    l3 = _project_readout(model.readout3, t3).reshape(b, gh, gw, -1)
    l3 = conv2d(l3, model.post3.weight, model.post3.bias, padding="VALID")
    l4 = _project_readout(model.readout4, t4).reshape(b, gh, gw, -1)
    l4 = conv2d(l4, model.post4a.weight, model.post4a.bias, padding="VALID")
    l4 = conv2d(l4, model.post4b.weight, model.post4b.bias, stride=2,
                padding=((1, 1), (1, 1)))
    rn = [conv2d(f, conv.weight, None, padding=((1, 1), (1, 1)))
          for conv, f in zip(model.layer_rn, (s0, s1, l3, l4))]
    path = _fusion_block(model.refinenet[3], rn[3])
    for i in (2, 1, 0):
        path = _fusion_block(model.refinenet[i], path, rn[i])
    return depth_head(model.head, path)


def midas_depth_condition(model: MidasHybrid, cfg: MidasHybridConfig,
                          images_u8: torch.Tensor) -> torch.Tensor:
    """The detector: raw image at its own resolution -> min-max normalised
    0..255 depth map (B, H, W)."""
    x = images_u8.float() / 127.5 - 1.0
    d = midas_hybrid_depth(model, cfg, x)
    mn = d.amin(dim=(1, 2), keepdim=True)
    mx = d.amax(dim=(1, 2), keepdim=True)
    return torch.clamp((d - mn) / torch.clamp(mx - mn, min=1e-9) * 255.0, 0, 255)
