"""DPT (dense prediction transformer) depth estimator, NHWC, fp32: the
depth condition's DPT-Large (HF `DPTForDepthEstimation`, `Intel/dpt-large`).

ViT-L/16 backbone (qkv bias, bilinearly resized position table, no final
layer norm on the tapped states), readout 'project' (CLS concatenated onto
every token, Linear + GELU), reassembly at scale factors (4, 2, 1, 0.5),
top-down feature fusion (pre-activation residual units, 2x bilinear
align_corners upsampling), 3-conv depth head.

Preprocessing (DPTImageProcessor): resize, scale 1/255, normalize
mean = std = 0.5.
"""
from __future__ import annotations

import dataclasses
from typing import List, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from controlar_tpu_torch.models import vit as vit_model
from controlar_tpu_torch.models.init import init_random
from controlar_tpu_torch.ops.conv import Conv, conv2d, conv_transpose2d
from controlar_tpu_torch.ops.resize import resize2d


@dataclasses.dataclass(frozen=True)
class DPTConfig:
    hidden_size: int = 1024
    n_layer: int = 24
    n_head: int = 16
    mlp_dim: int = 4096
    patch_size: int = 16
    pos_grid: int = 24                 # 384 / 16 native
    out_indices: Tuple[int, ...] = (5, 11, 17, 23)
    neck_hidden_sizes: Tuple[int, ...] = (256, 512, 1024, 1024)
    reassemble_factors: Tuple[float, ...] = (4, 2, 1, 0.5)
    fusion_hidden_size: int = 256
    layer_norm_eps: float = 1e-12

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.n_head

    @property
    def vit(self) -> vit_model.ViTConfig:
        """The encoder layers' configuration (no layer scale)."""
        return vit_model.ViTConfig(hidden_size=self.hidden_size, n_layer=self.n_layer,
                                   n_head=self.n_head,
                                   mlp_ratio=self.mlp_dim / self.hidden_size,
                                   patch_size=self.patch_size, pos_grid=self.pos_grid,
                                   layerscale=False, layer_norm_eps=self.layer_norm_eps)


DPT_LARGE = DPTConfig()


class _Reassemble(nn.Module):
    def __init__(self, cfg: DPTConfig, i: int):
        super().__init__()
        c, n, f = cfg.hidden_size, cfg.neck_hidden_sizes[i], cfg.reassemble_factors[i]
        self.readout = nn.Linear(2 * c, c)
        self.projection = Conv(c, n, 1)
        if f > 1:
            self.resize = Conv(n, n, int(f), transposed=True)
        elif f < 1:
            self.resize = Conv(n, n, 3)


class ResidualUnit(nn.Module):
    """A pre-activation residual conv unit (DPT's and MiDaS's fusion)."""

    def __init__(self, c: int):
        super().__init__()
        self.conv1 = Conv(c, c, 3)
        self.conv2 = Conv(c, c, 3)


class _Fusion(nn.Module):
    def __init__(self, c: int):
        super().__init__()
        self.projection = Conv(c, c, 1)
        self.res1 = ResidualUnit(c)
        self.res2 = ResidualUnit(c)


class DepthHead(nn.Module):
    """conv 3x3 c -> c/2, 2x upsample, conv 3x3 -> 32, ReLU, 1x1 -> 1, ReLU."""

    def __init__(self, c: int):
        super().__init__()
        self.conv1 = Conv(c, c // 2, 3)
        self.conv2 = Conv(c // 2, 32, 3)
        self.conv3 = Conv(32, 1, 1)


class DPT(nn.Module):
    def __init__(self, cfg: DPTConfig = DPT_LARGE):
        super().__init__()
        c, p, f = cfg.hidden_size, cfg.patch_size, cfg.fusion_hidden_size
        self.cls_token = nn.Parameter(torch.empty(c))
        self.pos_embed = nn.Parameter(torch.empty(cfg.pos_grid ** 2 + 1, c))
        self.patch_proj = Conv(3, c, p)
        self.layers = nn.ModuleList(vit_model.ViTLayer(cfg.vit) for _ in range(cfg.n_layer))
        self.reassemble = nn.ModuleList(_Reassemble(cfg, i)
                                        for i in range(len(cfg.neck_hidden_sizes)))
        self.neck_convs = nn.ModuleList(Conv(n, f, 3, bias=False)
                                        for n in cfg.neck_hidden_sizes)
        self.fusion = nn.ModuleList(_Fusion(f) for _ in cfg.neck_hidden_sizes)
        self.head = DepthHead(f)


def init_dpt(cfg: DPTConfig = DPT_LARGE, seed: int = 0, device="cuda") -> DPT:
    """A DPT with random weights from `seed` (fan-in scaled)."""
    return init_random(lambda: DPT(cfg), seed, device)


def _backbone(model: DPT, cfg: DPTConfig, x: torch.Tensor) -> List[torch.Tensor]:
    """Preprocessed x (B, H, W, 3) -> the tapped hidden states (CLS kept)."""
    b, h, w, _ = x.shape
    c, p = cfg.hidden_size, cfg.patch_size
    gh, gw = h // p, w // p
    patches = conv2d(x, model.patch_proj.weight, model.patch_proj.bias, stride=p,
                     padding="VALID")
    cls = model.cls_token[None, None, :].expand(b, 1, c)
    hs = torch.cat([cls, patches.reshape(b, gh * gw, c)], dim=1)
    pos, g = model.pos_embed, cfg.pos_grid
    if (gh, gw) != (g, g):  # bilinear, align_corners=False
        grid = resize2d(pos[1:].reshape(g, g, -1).float(), gh, gw, mode="bilinear",
                        align_corners=False)
        pos = torch.cat([pos[:1], grid.reshape(gh * gw, -1).to(pos.dtype)])
    hs = hs + pos[None]
    taps = []
    for l in range(max(cfg.out_indices) + 1):
        hs = model.layers[l](cfg.vit, hs)
        if l in cfg.out_indices:
            taps.append(hs)
    return taps


def _reassemble(model: DPT, cfg: DPTConfig, taps, gh: int, gw: int) -> List[torch.Tensor]:
    """Tokens -> 4 maps at (4, 2, 1, 0.5) x the patch grid."""
    outs = []
    for i, hs in enumerate(taps):
        rp = model.reassemble[i]
        cls, tok = hs[:, :1], hs[:, 1:]
        b, _, c = tok.shape
        t = F.gelu(rp.readout(torch.cat([tok, cls.expand_as(tok)], dim=-1)))
        fmap = conv2d(t.reshape(b, gh, gw, c), rp.projection.weight, rp.projection.bias)
        f = cfg.reassemble_factors[i]
        if f > 1:
            fmap = conv_transpose2d(fmap, rp.resize.weight, rp.resize.bias, stride=int(f),
                                    padding=0, output_padding=0)
        elif f < 1:
            fmap = conv2d(fmap, rp.resize.weight, rp.resize.bias, stride=int(1 / f),
                          padding=((1, 1), (1, 1)))
        outs.append(conv2d(fmap, model.neck_convs[i].weight, None))
    return outs


def residual_unit(ru: ResidualUnit, x: torch.Tensor) -> torch.Tensor:
    h = conv2d(F.relu(x), ru.conv1.weight, ru.conv1.bias)
    h = conv2d(F.relu(h), ru.conv2.weight, ru.conv2.bias)
    return x + h


def depth_head(hp: DepthHead, fused: torch.Tensor) -> torch.Tensor:
    """The fused map at half resolution -> depth (B, H, W), non-negative."""
    y = conv2d(fused, hp.conv1.weight, hp.conv1.bias)
    y = resize2d(y, y.shape[1] * 2, y.shape[2] * 2, mode="bilinear", align_corners=True)
    y = F.relu(conv2d(y, hp.conv2.weight, hp.conv2.bias))
    y = F.relu(conv2d(y, hp.conv3.weight, hp.conv3.bias))
    return y[..., 0]


def _fusion(model: DPT, feats) -> torch.Tensor:
    """Top-down fusion; returns the highest-resolution fused map."""
    fused = None
    for i, feat in enumerate(feats[::-1]):
        fp = model.fusion[i]
        if fused is None:
            fused = feat
        else:
            res = feat
            if res.shape[1:3] != fused.shape[1:3]:
                res = resize2d(res, *fused.shape[1:3], mode="bilinear", align_corners=False)
            fused = fused + residual_unit(fp.res1, res)
        fused = residual_unit(fp.res2, fused)
        fused = resize2d(fused, fused.shape[1] * 2, fused.shape[2] * 2, mode="bilinear",
                         align_corners=True)
        fused = conv2d(fused, fp.projection.weight, fp.projection.bias)
    return fused


def dpt_depth(model: DPT, cfg: DPTConfig, x: torch.Tensor) -> torch.Tensor:
    """Preprocessed x (B, H, W, 3), H and W multiples of the patch -> depth
    (B, H, W): the fused map is at H / 2, the head upsamples it 2x."""
    _, h, w, _ = x.shape
    taps = _backbone(model, cfg, x)
    fused = _fusion(model, _reassemble(model, cfg, taps, h // cfg.patch_size,
                                       w // cfg.patch_size))
    return depth_head(model.head, fused)


def preprocess_depth_input(images_u8: torch.Tensor, size: int = 512) -> torch.Tensor:
    """DPTImageProcessor: bilinear resize to size x size, scale 1/255,
    normalize mean = std = 0.5."""
    x = resize2d(images_u8.float(), size, size, mode="bilinear")
    return (x / 255.0 - 0.5) / 0.5


def depth_to_condition(depth: torch.Tensor) -> torch.Tensor:
    """Predicted depth -> a 0..255 map: depth * 255 / its per-image max."""
    mx = depth.amax(dim=(1, 2), keepdim=True)
    return depth * 255.0 / torch.clamp(mx, min=1e-6)
