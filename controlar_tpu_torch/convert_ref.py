"""Load the condition networks' published checkpoints into the port's
modules. Each takes a state dict in the checkpoint's own key layout (torch
tensors or numpy arrays) and keeps torch's weight layouts; keys the port
does not use are ignored, a key it needs and does not find raises.

- HED: ControlNet's annotator `ControlNetHED.pth` (ControlNetHED_Apache2);
- lineart: the annotator's `sk_model.pth` (a pix2pix generator);
- DPT: HF `DPTForDepthEstimation` (`Intel/dpt-large`);
- MiDaS: `dpt_hybrid-midas-501f0c75.pt` (DPTDepthModel over timm's
  `vit_base_resnet50_384`: the trunk under `pretrained.model.patch_embed.
  backbone`, the readouts under `pretrained.act_postprocess{3,4}`, the
  fusion and head under `scratch`).

Widths are read from the state dict (HED channels, lineart ngf); the DPT
and MiDaS configurations are given.
"""
from __future__ import annotations

import re
from typing import Callable, Mapping, Sequence, Tuple

import numpy as np
import torch

from controlar_tpu_torch import resolve_device
from controlar_tpu_torch.models import control_nets
from controlar_tpu_torch.models import dpt as dpt_model
from controlar_tpu_torch.models import midas as midas_model

Rules = Sequence[Tuple[str, str]]


def _load_renamed(make: Callable[[], torch.nn.Module], sd: Mapping, rules: Rules,
                  device) -> torch.nn.Module:
    """Build `make()` on `device` and fill each parameter from
    sd[its name rewritten by `rules`] (regex substitutions in order),
    reshaped to the parameter's shape (class tokens, position tables and
    the HED shift are stored with extra unit axes)."""
    device = resolve_device(device)
    with torch.device("meta"):
        model = make()
    out = {}
    for name, p in model.state_dict().items():
        key = name
        for pattern, repl in rules:
            key = re.sub(pattern, repl, key)
        out[name] = torch.from_numpy(np.array(sd[key], dtype=np.float32)).reshape(p.shape)
    model = model.to_empty(device=device)
    model.load_state_dict(out, strict=True)
    return model.float().eval().requires_grad_(False)


def hed_from_state_dict(sd: Mapping, device="cuda") -> control_nets.HED:
    device, sd = resolve_device(device), _numpy(sd)
    channels = [sd[f"block{i}.projection.weight"].shape[1] for i in range(1, 6)]
    return _load_renamed(lambda: control_nets.HED(channels), sd,
                         [(r"^blocks\.(\d)\.", lambda m: f"block{int(m[1]) + 1}.")], device)


_LINEART_RULES = [
    (r"^model0\.", "model0.1."),
    (r"^model1\.1\.", "model1.3."),
    (r"^model2\.(\d+)\.conv1\.", r"model2.\1.conv_block.1."),
    (r"^model2\.(\d+)\.conv2\.", r"model2.\1.conv_block.5."),
    (r"^model3\.1\.", "model3.3."),
    (r"^model4\.", "model4.1."),
]


def lineart_from_state_dict(sd: Mapping, device="cuda") -> control_nets.Lineart:
    device, sd = resolve_device(device), _numpy(sd)
    ngf = sd["model0.1.weight"].shape[0]
    n_res = len({k.split(".")[1] for k in sd if k.startswith("model2.")})
    return _load_renamed(lambda: control_nets.Lineart(ngf, n_res), sd, _LINEART_RULES, device)


_DPT_RULES = [
    (r"^cls_token$", "dpt.embeddings.cls_token"),
    (r"^pos_embed$", "dpt.embeddings.position_embeddings"),
    (r"^patch_proj\.", "dpt.embeddings.patch_embeddings.projection."),
    (r"^layers\.(\d+)\.", r"dpt.encoder.layer.\1."),
    (r"\.norm1\.scale$", ".layernorm_before.weight"),
    (r"\.norm1\.bias$", ".layernorm_before.bias"),
    (r"\.norm2\.scale$", ".layernorm_after.weight"),
    (r"\.norm2\.bias$", ".layernorm_after.bias"),
    (r"\.q\.", ".attention.attention.query."),
    (r"\.k\.", ".attention.attention.key."),
    (r"\.v\.", ".attention.attention.value."),
    (r"\.out\.", ".attention.output.dense."),
    (r"\.fc1\.", ".intermediate.dense."),
    (r"\.fc2\.", ".output.dense."),
    (r"^reassemble\.(\d)\.readout\.", r"neck.reassemble_stage.readout_projects.\1.0."),
    (r"^reassemble\.(\d)\.", r"neck.reassemble_stage.layers.\1."),
    (r"^neck_convs\.", "neck.convs."),
    (r"^fusion\.(\d)\.", r"neck.fusion_stage.layers.\1."),
    (r"\.res(\d)\.conv(\d)\.", r".residual_layer\1.convolution\2."),
    (r"^head\.conv1\.", "head.head.0."),
    (r"^head\.conv2\.", "head.head.2."),
    (r"^head\.conv3\.", "head.head.4."),
]


def dpt_from_state_dict(sd: Mapping, cfg: dpt_model.DPTConfig = dpt_model.DPT_LARGE,
                        device="cuda") -> dpt_model.DPT:
    return _load_renamed(lambda: dpt_model.DPT(cfg), _numpy(sd), _DPT_RULES, device)


_VM = "pretrained.model."
_MIDAS_RULES = [
    (r"^backbone\.stages\.(\d+)\.(\d+)\.", _VM + r"patch_embed.backbone.stages.\1.blocks.\2."),
    (r"^backbone\.", _VM + "patch_embed.backbone."),
    (r"^patch_proj\.", _VM + "patch_embed.proj."),
    (r"^(cls_token|pos_embed)$", _VM + r"\1"),
    (r"^blocks\.(\d+)\.(qkv|proj)\.", _VM + r"blocks.\1.attn.\2."),
    (r"^blocks\.(\d+)\.(fc\d)\.", _VM + r"blocks.\1.mlp.\2."),
    (r"^blocks\.", _VM + "blocks."),
    (r"\.scale$", ".weight"),
    (r"^readout(\d)\.", r"pretrained.act_postprocess\1.0.project.0."),
    (r"^post3\.", "pretrained.act_postprocess3.3."),
    (r"^post4a\.", "pretrained.act_postprocess4.3."),
    (r"^post4b\.", "pretrained.act_postprocess4.4."),
    (r"^layer_rn\.(\d)\.", lambda m: f"scratch.layer{int(m[1]) + 1}_rn."),
    (r"^refinenet\.(\d)\.res(\d)\.", lambda m: f"scratch.refinenet{int(m[1]) + 1}"
                                               f".resConfUnit{m[2]}."),
    (r"^refinenet\.(\d)\.out\.", lambda m: f"scratch.refinenet{int(m[1]) + 1}.out_conv."),
    (r"^head\.conv1\.", "scratch.output_conv.0."),
    (r"^head\.conv2\.", "scratch.output_conv.2."),
    (r"^head\.conv3\.", "scratch.output_conv.4."),
]


def midas_from_state_dict(sd: Mapping,
                          cfg: midas_model.MidasHybridConfig = midas_model.MIDAS_HYBRID,
                          device="cuda") -> midas_model.MidasHybrid:
    return _load_renamed(lambda: midas_model.MidasHybrid(cfg), _numpy(sd), _MIDAS_RULES,
                         device)


def load_midas_checkpoint(path: str,
                          cfg: midas_model.MidasHybridConfig = midas_model.MIDAS_HYBRID,
                          device="cuda") -> midas_model.MidasHybrid:
    """The released `.pt` (a state dict, or one under "model")."""
    sd = torch.load(path, map_location="cpu", weights_only=True)
    if isinstance(sd, dict) and "model" in sd and _VM + "cls_token" not in sd:
        sd = sd["model"]
    return midas_from_state_dict(sd, cfg, device)


def _numpy(sd: Mapping) -> dict:
    return {k: v.detach().cpu().numpy() if hasattr(v, "detach") else np.asarray(v)
            for k, v in sd.items()}
