"""DINOv2 (the ControlAR adapter's backbone) in fp32, under HF `Dinov2Model`
keys. `a` is the `adapter` group of a configuration file.

As published: 14 x 14 patches by a strided convolution, a CLS token, the
learned position table (a 37 x 37 grid plus CLS) resized bicubically
(align_corners False) to the image's patch grid, pre-norm blocks (LayerNorm,
multi-head softmax attention with biased q / k / v / output projections,
layer scale, an exact-GELU MLP, layer scale), a final LayerNorm; the adapter
keeps the patch tokens (CLS dropped).
"""
from __future__ import annotations

from typing import Dict, List, Tuple

import torch
import torch.nn.functional as F

Params = Dict[str, torch.Tensor]


def param_specs(a: dict) -> List[Tuple[str, tuple, str]]:
    """(key, shape, init): init "normal" (N(0, 0.02)), "scale" (near one) or
    "bias" (near zero)."""
    c, m, p, g = a["hidden_size"], a["mlp_dim"], a["patch_size"], a["pos_grid"]
    specs = [("embeddings.cls_token", (1, 1, c), "normal"),
             ("embeddings.position_embeddings", (1, g * g + 1, c), "normal"),
             ("embeddings.patch_embeddings.projection.weight", (c, 3, p, p), "normal"),
             ("embeddings.patch_embeddings.projection.bias", (c,), "bias")]
    for i in range(a["n_layer"]):
        pre = f"encoder.layer.{i}."
        specs += [(pre + "norm1.weight", (c,), "scale"), (pre + "norm1.bias", (c,), "bias")]
        for name in ("query", "key", "value"):
            specs += [(pre + f"attention.attention.{name}.weight", (c, c), "normal"),
                      (pre + f"attention.attention.{name}.bias", (c,), "bias")]
        specs += [(pre + "attention.output.dense.weight", (c, c), "normal"),
                  (pre + "attention.output.dense.bias", (c,), "bias"),
                  (pre + "layer_scale1.lambda1", (c,), "scale"),
                  (pre + "norm2.weight", (c,), "scale"), (pre + "norm2.bias", (c,), "bias"),
                  (pre + "mlp.fc1.weight", (m, c), "normal"), (pre + "mlp.fc1.bias", (m,), "bias"),
                  (pre + "mlp.fc2.weight", (c, m), "normal"), (pre + "mlp.fc2.bias", (c,), "bias"),
                  (pre + "layer_scale2.lambda1", (c,), "scale")]
    specs += [("layernorm.weight", (c,), "scale"), ("layernorm.bias", (c,), "bias")]
    return specs


def decayed(key: str) -> bool:
    """AdamW's weight decay over the adapter: every tensor of a layer (the
    JAX package stacks them on a layer axis, so each counts as two or more
    dimensions), the position table and the patch kernel; not the CLS token,
    the patch bias or the final LayerNorm."""
    return key.startswith("encoder.layer.") or key in (
        "embeddings.position_embeddings", "embeddings.patch_embeddings.projection.weight")


def forward(p: Params, a: dict, x: torch.Tensor) -> torch.Tensor:
    """x (B, H, W, 3) -> patch tokens (B, (H / 14) * (W / 14), hidden)."""
    b, h, w, _ = x.shape
    c, ps, nh, eps = a["hidden_size"], a["patch_size"], a["n_head"], a["layer_norm_eps"]
    dh = c // nh
    gh, gw = h // ps, w // ps
    patches = F.conv2d(x.permute(0, 3, 1, 2), p["embeddings.patch_embeddings.projection.weight"],
                       p["embeddings.patch_embeddings.projection.bias"], stride=ps)
    hs = torch.cat([p["embeddings.cls_token"].reshape(1, 1, c).expand(b, 1, c),
                    patches.flatten(2).transpose(1, 2)], dim=1)
    pos = p["embeddings.position_embeddings"].reshape(-1, c)
    g = a["pos_grid"]
    grid = pos[1:].reshape(1, g, g, c).permute(0, 3, 1, 2)
    if (gh, gw) != (g, g):
        grid = F.interpolate(grid, size=(gh, gw), mode="bicubic", align_corners=False)
    hs = hs + torch.cat([pos[:1], grid.flatten(2)[0].t()])[None]
    for i in range(a["n_layer"]):
        pre = f"encoder.layer.{i}."

        def lin(name, t):
            return F.linear(t, p[pre + name + ".weight"], p[pre + name + ".bias"])

        y = F.layer_norm(hs, (c,), p[pre + "norm1.weight"], p[pre + "norm1.bias"], eps)
        q, k, v = (lin(f"attention.attention.{n}", y).reshape(b, -1, nh, dh).transpose(1, 2)
                   for n in ("query", "key", "value"))
        att = torch.softmax((q @ k.transpose(-1, -2)) * dh ** -0.5, dim=-1) @ v
        att = lin("attention.output.dense", att.transpose(1, 2).reshape(b, -1, c))
        hs = hs + att * p[pre + "layer_scale1.lambda1"]
        y = F.layer_norm(hs, (c,), p[pre + "norm2.weight"], p[pre + "norm2.bias"], eps)
        y = lin("mlp.fc2", F.gelu(lin("mlp.fc1", y)))
        hs = hs + y * p[pre + "layer_scale2.lambda1"]
    hs = F.layer_norm(hs, (c,), p["layernorm.weight"], p["layernorm.bias"], eps)
    return hs[:, 1:]


def condition_input(edges: torch.Tensor) -> torch.Tensor:
    """A Canny map (B, H, W) in {0, 255} -> the adapter's input (B, H', W', 3)
    in [-1, 1], H' = H / 16 * 14, by nearest-neighbour sampling (source index
    floor(i * H / H'))."""
    b, h, w = edges.shape
    nh, nw = h // 16 * 14, w // 16 * 14
    rows = torch.arange(nh, device=edges.device) * h // nh
    cols = torch.arange(nw, device=edges.device) * w // nw
    m = edges.float()[:, rows][:, :, cols]
    return (2.0 * (m / 255.0 - 0.5))[..., None].expand(b, nh, nw, 3)
