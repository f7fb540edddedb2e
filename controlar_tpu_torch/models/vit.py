"""ViT encoder: the control-image adapter backbone (DINOv2 small / base).

`vit_forward(x)` returns the last hidden state without the CLS token, as the
ControlAR adapter uses it. The position table is interpolated bicubically
(align_corners=False, fp32) when the patch grid differs from the native one.
The adapter is trained with the GPT, so `vit_forward` keeps gradients (the
inference callers run it under `torch.inference_mode()`) and takes a remat
policy for its layers.
"""
from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F
from torch import nn

from controlar_tpu_torch.ops.conv import conv2d
from controlar_tpu_torch.ops.norms import Affine
from controlar_tpu_torch.ops.resize import resize2d
from controlar_tpu_torch.remat import checkpointed


@dataclasses.dataclass(frozen=True)
class ViTConfig:
    hidden_size: int = 384
    n_layer: int = 12
    n_head: int = 6
    mlp_ratio: float = 4.0
    patch_size: int = 14
    pos_grid: int = 37          # native pos-embed grid (518/14 for DINOv2)
    layerscale: bool = True
    layer_norm_eps: float = 1e-6

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.n_head

    @property
    def mlp_dim(self) -> int:
        return int(self.hidden_size * self.mlp_ratio)


DINOV2_SMALL = ViTConfig(hidden_size=384, n_layer=12, n_head=6, patch_size=14,
                         pos_grid=37, layerscale=True, layer_norm_eps=1e-6)
DINOV2_BASE = ViTConfig(hidden_size=768, n_layer=12, n_head=12, patch_size=14,
                        pos_grid=37, layerscale=True, layer_norm_eps=1e-6)


class ViTLayer(nn.Module):
    def __init__(self, cfg: ViTConfig):
        super().__init__()
        c, m = cfg.hidden_size, cfg.mlp_dim
        self.norm1 = Affine(c)
        self.q, self.k, self.v, self.out = (nn.Linear(c, c) for _ in range(4))
        self.norm2 = Affine(c)
        self.fc1 = nn.Linear(c, m)
        self.fc2 = nn.Linear(m, c)
        if cfg.layerscale:
            self.ls1 = nn.Parameter(torch.empty(c))
            self.ls2 = nn.Parameter(torch.empty(c))

    def forward(self, cfg: ViTConfig, hs: torch.Tensor) -> torch.Tensor:
        """One pre-norm encoder layer."""
        b, t, c = hs.shape
        nh, dh, eps = cfg.n_head, cfg.head_dim, cfg.layer_norm_eps
        y = layer_norm(hs, self.norm1.scale, self.norm1.bias, eps)
        q = self.q(y).reshape(b, t, nh, dh)
        k = self.k(y).reshape(b, t, nh, dh)
        v = self.v(y).reshape(b, t, nh, dh)
        scores = torch.einsum("bthd,bshd->bhts", q.float(), k.float()) * (dh ** -0.5)
        probs = torch.softmax(scores, dim=-1).to(y.dtype)
        attn = torch.einsum("bhts,bshd->bthd", probs.float(), v.float())
        attn = self.out(attn.to(y.dtype).reshape(b, t, c))
        if cfg.layerscale:
            attn = attn * self.ls1
        hs = hs + attn
        y = layer_norm(hs, self.norm2.scale, self.norm2.bias, eps)
        y = self.fc2(F.gelu(self.fc1(y)))
        if cfg.layerscale:
            y = y * self.ls2
        return hs + y


class PatchProj(nn.Module):
    def __init__(self, cfg: ViTConfig):
        super().__init__()
        p, c = cfg.patch_size, cfg.hidden_size
        self.weight = nn.Parameter(torch.empty(c, 3, p, p))
        self.bias = nn.Parameter(torch.empty(c))


class ViT(nn.Module):
    def __init__(self, cfg: ViTConfig):
        super().__init__()
        c = cfg.hidden_size
        self.cls_token = nn.Parameter(torch.empty(c))
        self.pos_embed = nn.Parameter(torch.empty(cfg.pos_grid ** 2 + 1, c))
        self.patch_proj = PatchProj(cfg)
        self.layers = nn.ModuleList(ViTLayer(cfg) for _ in range(cfg.n_layer))
        self.final_norm = Affine(c)


def init_vit(cfg: ViTConfig, seed: int = 0, dtype: torch.dtype = torch.float32,
             device="cpu") -> ViT:
    """Random weights with the JAX package's init distribution: normal(0, 0.02)
    for the weights, the CLS token and the position table; zero biases; norms
    one and zero; layer scales one."""
    device = torch.device(device)
    with torch.device("meta"):
        model = ViT(cfg).to(dtype)
    model = model.to_empty(device=device)
    gen = torch.Generator(device=device).manual_seed(seed)
    with torch.no_grad():
        for name, p in model.named_parameters():
            leaf = name.rsplit(".", 1)[-1]
            if leaf in ("scale", "ls1", "ls2"):
                p.fill_(1.0)
            elif leaf == "bias":
                p.zero_()
            else:
                p.copy_(torch.randn(p.shape, generator=gen, device=device) * 0.02)
    return model.eval().requires_grad_(False)


def layer_norm(x, scale, bias, eps):
    xf = x.float()
    mean = xf.mean(-1, keepdim=True)
    var = (xf - mean).pow(2).mean(-1, keepdim=True)
    y = (xf - mean) * torch.rsqrt(var + eps)
    return (y * scale + bias).to(x.dtype)


def _interp_pos_embed(model: ViT, cfg: ViTConfig, grid_h: int, grid_w: int) -> torch.Tensor:
    """The (1 + N, C) table on a (grid_h, grid_w) patch grid."""
    pos = model.pos_embed
    g = cfg.pos_grid
    if (grid_h, grid_w) == (g, g):
        return pos
    patch = resize2d(pos[1:].reshape(g, g, -1).float(), grid_h, grid_w,
                     mode="bicubic", align_corners=False)
    return torch.cat([pos[:1], patch.reshape(grid_h * grid_w, -1).to(pos.dtype)])


def vit_forward(model: ViT, cfg: ViTConfig, x: torch.Tensor, remat: "str | bool" = False
                ) -> torch.Tensor:
    """x: (B, H, W, 3) -> patch tokens (B, (H/P)*(W/P), C), CLS dropped.

    remat: recompute each layer in the backward, "dots" saving its matmul
    outputs and any other policy name recomputing the whole layer (the JAX
    package's rule); False or "none" saves everything."""
    b, h, w, _ = x.shape
    p, c = cfg.patch_size, cfg.hidden_size
    gh, gw = h // p, w // p
    patches = conv2d(x, model.patch_proj.weight, model.patch_proj.bias,
                     stride=p, padding="VALID")
    cls = model.cls_token[None, None, :].expand(b, 1, c)
    hs = torch.cat([cls, patches.reshape(b, gh * gw, c)], dim=1)
    hs = hs + _interp_pos_embed(model, cfg, gh, gw)[None].to(hs.dtype)
    policy = "none" if remat in (False, None, "none") else ("dots" if remat == "dots" else "full")
    for lp in model.layers:
        hs = checkpointed(lp, policy, cfg, hs)
    hs = layer_norm(hs, model.final_norm.scale, model.final_norm.bias, cfg.layer_norm_eps)
    return hs[:, 1:]
