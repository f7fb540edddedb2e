"""Carry the JAX package's parameter pytrees into the port's modules.

Each function takes the JAX parameters as nested dicts and lists of numpy
arrays or CPU tensors (`tools.import_params_npz`; per-layer weights stacked
on a leading (L, ...) axis, or a list of per-layer dicts) and returns the
port's module, loaded with `load_state_dict(strict=True)`. Linears stored
(in, out) become torch's (out, in); convolutions stored HWIO become OIHW,
and transposed ones (stored flipped, HWIO) torch's unflipped (C_in, C_out,
KH, KW).

`gpt_from_jax` also takes the JAX package's quantized trees (from
`quantize_gpt_params`, stacked or not, and `quantize_gpt_params_w4`): a
{"q", "s"} weight becomes a `quant.W8Linear` and a {"q4", "s"} weight a
`quant.W4Linear`, holding the same integer carriers and f32 scales in the
same (in, out) layout; a fused `w13` replaces w1 and w3, and the
`rope_split` marker marks the model as `quant.to_split_rope` does.
"""
from __future__ import annotations

from typing import Any, Dict, Optional

import numpy as np
import torch

from controlar_tpu_torch import quant
from controlar_tpu_torch.config import GPTConfig, VQConfig
from controlar_tpu_torch.models import control_nets
from controlar_tpu_torch.models import discriminators as disc_model
from controlar_tpu_torch.models import dpt as dpt_model
from controlar_tpu_torch.models import gpt as gpt_model
from controlar_tpu_torch.models import lpips as lpips_model
from controlar_tpu_torch.models import midas as midas_model
from controlar_tpu_torch.models import t5 as t5_model
from controlar_tpu_torch.models import vit as vit_model
from controlar_tpu_torch.models import vq as vq_model

Tree = Dict[str, Any]


def _t(a) -> torch.Tensor:
    if isinstance(a, torch.Tensor):  # a leaf of `tools.import_params_npz` (bf16 included)
        return a.detach().to("cpu", torch.float32)
    return torch.from_numpy(np.array(a, dtype=np.float32))


def _lin(a) -> torch.Tensor:
    """(in, out) -> (out, in)."""
    return _t(a).T.contiguous()


def _conv(a) -> torch.Tensor:
    """HWIO -> OIHW."""
    return _t(a).permute(3, 2, 0, 1).contiguous()


def _layer(layers, l: int) -> Tree:
    if isinstance(layers, (list, tuple)):
        return layers[l]
    return {k: (_layer(v, l) if isinstance(v, dict) else v[l]) for k, v in layers.items()}


def _load(model: torch.nn.Module, sd: Dict[str, torch.Tensor], dtype, device) -> torch.nn.Module:
    model = model.to_empty(device=device)
    model.load_state_dict(sd, strict=True)
    return model.to(dtype).eval().requires_grad_(False)


def _quantized(w) -> Optional[torch.nn.Module]:
    """A quantized JAX weight -> the port's module; None for a float one."""
    if not isinstance(w, dict):
        return None
    s = _t(w["s"])
    if "q4" in w:
        return quant.W4Linear(torch.as_tensor(np.asarray(w["q4"], dtype=np.int8)), s)
    return quant.W8Linear(torch.as_tensor(np.asarray(w["q"], dtype=np.int8)), s)


def gpt_from_jax(params: Tree, cfg: GPTConfig, dtype: torch.dtype = torch.float32,
                 device="cpu") -> gpt_model.GPT:
    device = torch.device(device)
    sd = {"tok_embeddings.weight": _t(params["tok_embeddings"]),
          "norm": _t(params["norm"])}
    qmods: Dict[str, torch.nn.Module] = {}  # module path -> quantized module

    def linear(path: str, w) -> None:
        m = _quantized(w)
        if m is None:
            sd[f"{path}.weight"] = _lin(w)
        else:
            qmods[path] = m

    linear("output", params["output"])
    ce = params["cls_embedding"]
    if cfg.model_type == "c2i":
        sd["cls_embedding.embedding.weight"] = _t(ce["embedding"])
    else:
        sd["cls_embedding.fc1.weight"] = _lin(ce["fc1"])
        sd["cls_embedding.fc2.weight"] = _lin(ce["fc2"])
        sd["cls_embedding.uncond_embedding"] = _t(ce["uncond_embedding"])
    for name in ("adapter_mlp", "condition_mlp"):
        for fc in ("fc1", "fc2"):
            sd[f"{name}.{fc}.weight"] = _lin(params[name][fc])
    for i in range(cfg.n_fusion_points):
        for fc in ("fc1", "fc2"):
            sd[f"condition_layers.{i}.{fc}.weight"] = _lin(params["condition_layers"][fc][i])
    fused = set()
    for l in range(cfg.n_layer):
        lp = _layer(params["layers"], l)
        sd[f"layers.{l}.attention_norm"] = _t(lp["attention_norm"])
        sd[f"layers.{l}.ffn_norm"] = _t(lp["ffn_norm"])
        for w in ("wqkv", "wo", "w1", "w3", "w2", "w13"):
            if w in lp:
                linear(f"layers.{l}.{w}", lp[w])
        if "w13" in lp:
            fused.add(l)
    with torch.device("meta"):
        model = gpt_model.GPT(cfg)
    for l in fused:
        del model.layers[l].w1, model.layers[l].w3
    for path in qmods:
        parent, _, name = path.rpartition(".")
        owner = model.get_submodule(parent) if parent else model
        if hasattr(owner, name):
            delattr(owner, name)
    model = _load(model, sd, dtype, device)
    for path, m in qmods.items():
        parent, _, name = path.rpartition(".")
        setattr(model.get_submodule(parent) if parent else model, name, m.to(device))
    if "rope_split" in params:
        quant.mark_split(model)
    return model


def vit_from_jax(params: Tree, cfg: vit_model.ViTConfig, dtype: torch.dtype = torch.float32,
                 device="cpu") -> vit_model.ViT:
    sd = {"cls_token": _t(params["cls_token"]),
          "pos_embed": _t(params["pos_embed"]),
          "patch_proj.weight": _conv(params["patch_proj"]["w"]),
          "patch_proj.bias": _t(params["patch_proj"]["b"]),
          "final_norm.scale": _t(params["final_norm"]["scale"]),
          "final_norm.bias": _t(params["final_norm"]["bias"])}
    for l in range(cfg.n_layer):
        lp = _layer(params["layers"], l)
        for norm in ("norm1", "norm2"):
            sd[f"layers.{l}.{norm}.scale"] = _t(lp[norm]["scale"])
            sd[f"layers.{l}.{norm}.bias"] = _t(lp[norm]["bias"])
        for lin in ("q", "k", "v", "out", "fc1", "fc2"):
            sd[f"layers.{l}.{lin}.weight"] = _lin(lp[lin]["w"])
            sd[f"layers.{l}.{lin}.bias"] = _t(lp[lin]["b"])
        if cfg.layerscale:
            sd[f"layers.{l}.ls1"] = _t(lp["ls1"])
            sd[f"layers.{l}.ls2"] = _t(lp["ls2"])
    with torch.device("meta"):
        model = vit_model.ViT(cfg)
    return _load(model, sd, dtype, torch.device(device))


def _flatten(tree, prefix: str, out: Dict[str, Any]) -> None:
    if isinstance(tree, dict):
        for k, v in tree.items():
            _flatten(v, f"{prefix}{k}.", out)
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            _flatten(v, f"{prefix}{i}.", out)
    else:
        out[prefix[:-1]] = tree


def _tree_sd(tree) -> Dict[str, torch.Tensor]:
    """A JAX tree -> a state dict: each {"w", "b"} pair becomes `.weight`
    (HWIO -> OIHW when 4-D, (in, out) -> (out, in) when 2-D) and `.bias`;
    other leaves (norm scale / bias, tables) keep their names and layouts."""
    flat: Dict[str, Any] = {}
    _flatten(tree, "", flat)
    sd = {}
    for key, a in flat.items():
        path, _, leaf = key.rpartition(".")
        if leaf == "w":
            sd[f"{path}.weight"] = _conv(a) if _t(a).dim() == 4 else _lin(a)
        elif leaf == "b":
            sd[f"{path}.bias"] = _t(a)
        else:
            sd[key] = _t(a)
    return sd


def _conv_t(a) -> torch.Tensor:
    """The JAX package's transposed-conv kernel (flipped HWIO) -> torch's
    ConvTranspose2d weight (C_in, C_out, KH, KW), unflipped."""
    return _t(a).permute(2, 3, 0, 1).flip(2, 3).contiguous()


def _build(make, sd, dtype, device) -> torch.nn.Module:
    with torch.device("meta"):
        model = make()
    return _load(model, sd, dtype, torch.device(device))


def vq_from_jax(params: Tree, cfg: VQConfig, dtype: torch.dtype = torch.float32,
                device="cpu") -> vq_model.VQModel:
    """The tokenizer: encoder, quant_conv, codebook, post_quant_conv and
    decoder."""
    keys = ("encoder", "quant_conv", "post_quant_conv", "codebook", "decoder")
    sd = _tree_sd({k: params[k] for k in keys})
    return _build(lambda: vq_model.VQModel(cfg), sd, dtype, device)


def hed_from_jax(params: Tree, device="cpu") -> control_nets.HED:
    sd = _tree_sd(params)
    sd["norm"] = sd["norm"].reshape(3)
    channels = [np.shape(b["projection"]["w"])[2] for b in params["blocks"]]
    return _build(lambda: control_nets.HED(channels), sd, torch.float32, device)


def lineart_from_jax(params: Tree, device="cpu") -> control_nets.Lineart:
    sd = _tree_sd(params)
    for i, blk in enumerate(params["model3"]):
        sd[f"model3.{i}.weight"] = _conv_t(blk["w"])
    ngf = np.shape(params["model0"]["w"])[3]
    return _build(lambda: control_nets.Lineart(ngf, len(params["model2"])), sd, torch.float32,
                  device)


def dpt_from_jax(params: Tree, cfg: dpt_model.DPTConfig, device="cpu") -> dpt_model.DPT:
    sd = _tree_sd({k: v for k, v in params.items() if k != "layers"})
    for l in range(cfg.n_layer):
        sd.update(_tree_sd({"layers": {str(l): _layer(params["layers"], l)}}))
    for i, f in enumerate(cfg.reassemble_factors):
        if f > 1:
            sd[f"reassemble.{i}.resize.weight"] = _conv_t(params["reassemble"][i]["resize"]["w"])
    return _build(lambda: dpt_model.DPT(cfg), sd, torch.float32, device)


def midas_from_jax(params: Tree, cfg: midas_model.MidasHybridConfig,
                   device="cpu") -> midas_model.MidasHybrid:
    sd = _tree_sd({k: v for k, v in params.items() if k != "layer_rn"})
    for i, w in enumerate(params["layer_rn"]):
        sd[f"layer_rn.{i}.weight"] = _conv(w)
    return _build(lambda: midas_model.MidasHybrid(cfg), sd, torch.float32, device)


def t5_from_jax(params: Tree, cfg: t5_model.T5Config, dtype: torch.dtype = torch.float32,
                device="cpu") -> t5_model.T5Encoder:
    """The text encoder: stacked (L, d, n) weights used as x @ W."""
    sd = {"embedding.weight": _t(params["embedding"]), "rel_bias": _t(params["rel_bias"]),
          "final_ln": _t(params["final_ln"])}
    for l in range(cfg.n_layer):
        lp = _layer(params["layers"], l)
        sd[f"layers.{l}.ln1"] = _t(lp["ln1"])
        sd[f"layers.{l}.ln2"] = _t(lp["ln2"])
        for w in ("q", "k", "v", "o", "wi0", "wi1", "wo"):
            sd[f"layers.{l}.{w}.weight"] = _lin(lp[w])
    return _build(lambda: t5_model.T5Encoder(cfg), sd, dtype, device)


def lpips_from_jax(params: Tree, device="cpu") -> lpips_model.LPIPS:
    """The LPIPS network (frozen); the slices' widths read from the tree."""
    widths = [np.shape(params["vgg"][str(ids[-1])]["w"])[3] for ids in lpips_model.VGG_SLICES]
    return _build(lambda: lpips_model.LPIPS(widths), _tree_sd(params), torch.float32, device)


def patchgan_from_jax(params: Tree, device="cpu") -> disc_model.PatchGAN:
    """The PatchGAN discriminator; input channels, ndf and depth read from
    the tree. Returned trainable."""
    cin, ndf = np.shape(params["conv_in"]["w"])[2:]
    model = _build(lambda: disc_model.PatchGAN(cin, ndf, len(params["blocks"])),
                   _tree_sd(params), torch.float32, device)
    return model.train().requires_grad_(True)


def stylegan_disc_from_jax(params: Tree, device="cpu") -> disc_model.StyleGANDisc:
    """The StyleGAN discriminator; the image size from its number of blocks
    (down to 4 x 4). Returned trainable."""
    cin = np.shape(params["conv_in"]["w"])[2]
    size = 2 ** (len(params["blocks"]) + 2)
    model = _build(lambda: disc_model.StyleGANDisc(cin, size), _tree_sd(params),
                   torch.float32, device)
    return model.train().requires_grad_(True)
