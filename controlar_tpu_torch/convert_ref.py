"""Load published checkpoints into the port's modules. Each loader takes a
state dict in the checkpoint's own key layout (torch tensors or numpy
arrays) and keeps torch's weight layouts; keys the port does not use are
ignored, a key it needs and does not find raises.

- GPT: the reference LlamaGen / ControlAR `.pt` / `.safetensors`
  (`layers.{i}.attention.wqkv`, `feed_forward.w1`, `cls_embedding.
  embedding_table`, `cap_proj.*`; `adapter.*`, `condition_embeddings` and
  `condition_norm` are not read). A base LlamaGen checkpoint has no
  `adapter_mlp`, `condition_mlp` or `condition_layers`: those come from the
  GPT given as `fill_from`, else from the port's own `init_gpt(cfg, 0)`;
- the DINOv2 / ViT adapter: HF `Dinov2Model` (`facebook/dinov2-small`) or
  `ViTModel`, the patch projection kept OIHW;
- VQ: the reference VQModel `.pt` (`{"model": sd}`), encoder included;
- HED: ControlNet's annotator `ControlNetHED.pth` (ControlNetHED_Apache2);
- lineart: the annotator's `sk_model.pth` (a pix2pix generator);
- DPT: HF `DPTForDepthEstimation` (`Intel/dpt-large`);
- MiDaS: `dpt_hybrid-midas-501f0c75.pt` (DPTDepthModel over timm's
  `vit_base_resnet50_384`: the trunk under `pretrained.model.patch_embed.
  backbone`, the readouts under `pretrained.act_postprocess{3,4}`, the
  fusion and head under `scratch`);
- T5: HF `T5EncoderModel` / `T5ForConditionalGeneration` (flan-t5-xl:
  `shared.weight` and `encoder.*`; the decoder is not read);
- LPIPS: torchvision's `vgg16` state dict (`features.{i}.*`) and the LPIPS
  heads' checkpoint (`lin{k}.model.1.weight`), two files;
- the FID InceptionV3: pytorch-fid's `pt_inception-2015-12-05-*.pth`
  (torchvision's module paths, read by identity; a missing `fc.bias` is
  zero);
- the taming VQGAN comparison tokenizers: the pytorch-lightning
  `state_dict` of taming's VQModel (`encoder.down.{i}.block.{j}.*`,
  `decoder.up.{i}.*`, `quantize.embedding.weight`);
- the discriminators of VQ training: the reference's PatchGAN
  (`NLayerDiscriminator`, `main.{i}.*`; batch-norm running statistics not
  read) and StyleGAN `Discriminator` (`blocks.{i}`, `final_conv.0`,
  `final_linear.{0,2}`; its first linear takes the (C, H, W) flattening,
  the port's the (H, W, C) one, so that weight's input axis is permuted).

Each layout is a table of regex rules that rewrite a port parameter's name
into the checkpoint's key (`_RULES` below); `reference_state_dict` reads the
same table the other way, from a port module to a state dict in the
checkpoint's layout. Widths are read from the state dict (HED channels,
lineart ngf); the other configurations are given.
"""
from __future__ import annotations

import re
from typing import Callable, Dict, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch

from controlar_tpu_torch import resolve_device
from controlar_tpu_torch.config import GPTConfig, VQConfig
from controlar_tpu_torch.eval import inception as inception_model
from controlar_tpu_torch.models import control_nets
from controlar_tpu_torch.models import discriminators as disc_model
from controlar_tpu_torch.models import dpt as dpt_model
from controlar_tpu_torch.models import gpt as gpt_model
from controlar_tpu_torch.models import lpips as lpips_model
from controlar_tpu_torch.models import midas as midas_model
from controlar_tpu_torch.models import t5 as t5_model
from controlar_tpu_torch.models import taming_vqgan as taming_model
from controlar_tpu_torch.models import vit as vit_model
from controlar_tpu_torch.models import vq as vq_model

Rules = Sequence[Tuple[str, str]]


def _ref_key(name: str, rules: Rules) -> str:
    for pattern, repl in rules:
        name = re.sub(pattern, repl, name)
    return name


def _tensor(v) -> torch.Tensor:
    return v.detach() if isinstance(v, torch.Tensor) else torch.from_numpy(np.array(v))


def _load_renamed(make: Callable[[], torch.nn.Module], sd: Mapping, rules: Rules,
                  device, dtype: torch.dtype = torch.float32,
                  fallback: Optional[Callable[[str], torch.Tensor]] = None) -> torch.nn.Module:
    """Build `make()` on `device` in `dtype` and fill each parameter from
    sd[its name rewritten by `rules`] (regex substitutions in order),
    reshaped to the parameter's shape (class tokens, position tables and
    the HED shift are stored with extra unit axes). A key that sd lacks is
    taken from fallback(parameter name) when given. The values are cast
    once, so a checkpoint loaded in its own dtype is copied bit for bit."""
    device = resolve_device(device)
    with torch.device("meta"):
        model = make()
    out = {}
    for name, p in model.state_dict().items():
        key = _ref_key(name, rules)
        v = fallback(name) if fallback is not None and key not in sd else sd[key]
        out[name] = _tensor(v).to(dtype).reshape(p.shape)
    model = model.to(dtype).to_empty(device=device)
    model.load_state_dict(out, strict=True)
    return model.eval().requires_grad_(False)


def reference_state_dict(model: torch.nn.Module, rules: Rules,
                         shapes: Optional[Dict[str, Tuple[int, ...]]] = None
                         ) -> Dict[str, torch.Tensor]:
    """The module's parameters under the checkpoint's keys (`rules` read
    from the module's side), reshaped to `shapes[key]` where the checkpoint
    stores extra unit axes; the tensors are the module's own (detached)."""
    shapes = shapes or {}
    out = {}
    for name, t in model.state_dict().items():
        key = _ref_key(name, rules)
        out[key] = t.detach().reshape(shapes.get(key, t.shape))
    return out


# ---------------------------------------------------------------------------
# GPT (reference `autoregressive/models/gpt*.py` layout)
# ---------------------------------------------------------------------------

GPT_RULES = [
    (r"^cls_embedding\.embedding\.", "cls_embedding.embedding_table."),
    (r"^cls_embedding\.(fc\d)\.", r"cls_embedding.cap_proj.\1."),
    (r"^condition_mlp\.", "condition_mlp.cap_proj."),
    (r"^layers\.(\d+)\.(attention_norm|ffn_norm)$", r"layers.\1.\2.weight"),
    (r"^layers\.(\d+)\.(wqkv|wo)\.", r"layers.\1.attention.\2."),
    (r"^layers\.(\d+)\.(w1|w2|w3)\.", r"layers.\1.feed_forward.\2."),
    (r"^norm$", "norm.weight"),
]
# the ControlAR modules a base LlamaGen checkpoint lacks
CONTROL_MODULES = ("adapter_mlp.", "condition_mlp.", "condition_layers.")


def gpt_from_state_dict(sd: Mapping, cfg: GPTConfig, dtype: torch.dtype = torch.float32,
                        device="cuda",
                        fill_from: Optional[gpt_model.GPT] = None) -> gpt_model.GPT:
    """A GPT from a reference state dict; the control modules it lacks (a
    base LlamaGen checkpoint) come from `fill_from` when given, else from
    `init_gpt(cfg, 0)`."""
    device = resolve_device(device)
    fresh = {}

    def fallback(name: str) -> torch.Tensor:
        if not name.startswith(CONTROL_MODULES):
            raise KeyError(f"{_ref_key(name, GPT_RULES)} (parameter {name}) is not in the "
                           "state dict")
        if not fresh:
            src = fill_from if fill_from is not None else gpt_model.init_gpt(cfg, seed=0)
            fresh.update(src.state_dict())
        return fresh[name]

    return _load_renamed(lambda: gpt_model.GPT(cfg), sd, GPT_RULES, device, dtype, fallback)


def gpt_reference_state_dict(model: gpt_model.GPT) -> Dict[str, torch.Tensor]:
    return reference_state_dict(model, GPT_RULES)


# ---------------------------------------------------------------------------
# DINOv2 / ViT adapter (HF `Dinov2Model` / `ViTModel` layout)
# ---------------------------------------------------------------------------

_QKV = {"q": "query", "k": "key", "v": "value"}
_VIT_COMMON = [
    (r"^cls_token$", "embeddings.cls_token"),
    (r"^pos_embed$", "embeddings.position_embeddings"),
    (r"^patch_proj\.", "embeddings.patch_embeddings.projection."),
    (r"^final_norm\.scale$", "layernorm.weight"),
    (r"^final_norm\.bias$", "layernorm.bias"),
    (r"^layers\.(\d+)\.([qkv])\.",
     lambda m: f"encoder.layer.{m[1]}.attention.attention.{_QKV[m[2]]}."),
    (r"^layers\.(\d+)\.out\.", r"encoder.layer.\1.attention.output.dense."),
]
VIT_RULES = {
    "dinov2": _VIT_COMMON + [
        (r"^layers\.(\d+)\.(norm\d)\.scale$", r"encoder.layer.\1.\2.weight"),
        (r"^layers\.(\d+)\.(norm\d)\.bias$", r"encoder.layer.\1.\2.bias"),
        (r"^layers\.(\d+)\.(fc\d)\.", r"encoder.layer.\1.mlp.\2."),
        (r"^layers\.(\d+)\.ls(\d)$", r"encoder.layer.\1.layer_scale\2.lambda1"),
    ],
    "vit": _VIT_COMMON + [
        (r"^layers\.(\d+)\.norm1\.scale$", r"encoder.layer.\1.layernorm_before.weight"),
        (r"^layers\.(\d+)\.norm1\.bias$", r"encoder.layer.\1.layernorm_before.bias"),
        (r"^layers\.(\d+)\.norm2\.scale$", r"encoder.layer.\1.layernorm_after.weight"),
        (r"^layers\.(\d+)\.norm2\.bias$", r"encoder.layer.\1.layernorm_after.bias"),
        (r"^layers\.(\d+)\.fc1\.", r"encoder.layer.\1.intermediate.dense."),
        (r"^layers\.(\d+)\.fc2\.", r"encoder.layer.\1.output.dense."),
    ],
}


def _vit_rules(flavor: str) -> Rules:
    if flavor not in VIT_RULES:
        raise ValueError(f"flavor must be 'dinov2' or 'vit', got {flavor!r}")
    return VIT_RULES[flavor]


def vit_from_hf_state_dict(sd: Mapping, cfg: vit_model.ViTConfig = vit_model.DINOV2_SMALL,
                           flavor: str = "dinov2", dtype: torch.dtype = torch.float32,
                           device="cuda") -> vit_model.ViT:
    """The adapter backbone from an HF state dict."""
    return _load_renamed(lambda: vit_model.ViT(cfg), sd, _vit_rules(flavor), device, dtype)


def vit_hf_state_dict(model: vit_model.ViT, cfg: vit_model.ViTConfig,
                      flavor: str = "dinov2") -> Dict[str, torch.Tensor]:
    c = cfg.hidden_size
    return reference_state_dict(model, _vit_rules(flavor), {
        "embeddings.cls_token": (1, 1, c),
        "embeddings.position_embeddings": (1, cfg.pos_grid ** 2 + 1, c)})


# ---------------------------------------------------------------------------
# VQ tokenizer (reference `tokenizer/tokenizer_image/vq_model.py` layout)
# ---------------------------------------------------------------------------

VQ_RULES = [
    (r"^(encoder|decoder)\.levels\.", r"\1.conv_blocks."),
    (r"\.scale$", ".weight"),
    (r"^codebook$", "quantize.embedding.weight"),
]


def vq_from_state_dict(sd: Mapping, cfg: VQConfig, dtype: torch.dtype = torch.float32,
                       device="cuda") -> vq_model.VQModel:
    """The tokenizer, encoder included, from a reference state dict."""
    return _load_renamed(lambda: vq_model.VQModel(cfg), sd, VQ_RULES, device, dtype)


def vq_reference_state_dict(model: vq_model.VQModel) -> Dict[str, torch.Tensor]:
    return reference_state_dict(model, VQ_RULES)


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


# ---------------------------------------------------------------------------
# T5 encoder (HF `T5EncoderModel` layout; the JAX package's
# `convert/torch_t5.convert_t5_state_dict`)
# ---------------------------------------------------------------------------

_T5_ATTN, _T5_FFN = r"encoder.block.\1.layer.0.", r"encoder.block.\1.layer.1."
T5_RULES = [
    (r"^embedding\.weight$", "shared.weight"),
    (r"^rel_bias$", "encoder.block.0.layer.0.SelfAttention.relative_attention_bias.weight"),
    (r"^final_ln$", "encoder.final_layer_norm.weight"),
    (r"^layers\.(\d+)\.ln1$", _T5_ATTN + "layer_norm.weight"),
    (r"^layers\.(\d+)\.([qkvo])\.", _T5_ATTN + r"SelfAttention.\2."),
    (r"^layers\.(\d+)\.ln2$", _T5_FFN + "layer_norm.weight"),
    (r"^layers\.(\d+)\.wi([01])\.", _T5_FFN + r"DenseReluDense.wi_\2."),
    (r"^layers\.(\d+)\.wo\.", _T5_FFN + "DenseReluDense.wo."),
]


def t5_from_state_dict(sd: Mapping, cfg: t5_model.T5Config = t5_model.T5_XL,
                       dtype: torch.dtype = torch.float32, device="cuda") -> t5_model.T5Encoder:
    """The text encoder from an HF T5 state dict (torch's (out, in) linears,
    as the port keeps them)."""
    return _load_renamed(lambda: t5_model.T5Encoder(cfg), sd, T5_RULES, device, dtype)


def t5_hf_state_dict(model: t5_model.T5Encoder) -> Dict[str, torch.Tensor]:
    return reference_state_dict(model, T5_RULES)


# ---------------------------------------------------------------------------
# LPIPS (torchvision vgg16 + the LPIPS heads; the JAX package's
# `convert/torch_lpips.convert_lpips_state_dicts`)
# ---------------------------------------------------------------------------

LPIPS_RULES = [
    (r"^vgg\.(\d+)\.", r"features.\1."),
    (r"^lins\.(\d)\.weight$", r"lin\1.model.1.weight"),
]


def lpips_from_state_dicts(vgg_sd: Mapping, lin_sd: Mapping,
                           device="cuda") -> lpips_model.LPIPS:
    """The frozen LPIPS network from torchvision's vgg16 state dict and the
    heads' checkpoint; the slices' widths read from the state dict."""
    sd = {**_numpy(vgg_sd), **_numpy(lin_sd)}
    widths = [sd[f"features.{ids[-1]}.weight"].shape[0] for ids in lpips_model.VGG_SLICES]
    return _load_renamed(lambda: lpips_model.LPIPS(widths), sd, LPIPS_RULES, device)


def lpips_reference_state_dicts(model: lpips_model.LPIPS):
    """-> (the vgg16 `features.*` state dict, the heads' `lin*` one)."""
    sd = reference_state_dict(model, LPIPS_RULES)
    return ({k: v for k, v in sd.items() if k.startswith("features.")},
            {k: v for k, v in sd.items() if k.startswith("lin")})


# ---------------------------------------------------------------------------
# Discriminators (the reference's `discriminator_patchgan.py` and
# `discriminator_stylegan.py`; the JAX package's `convert_*_state_dict`)
# ---------------------------------------------------------------------------

def _patchgan_rules(n_layers: int) -> Rules:
    """main.0 the first convolution, then per block a convolution, its batch
    norm and an activation (3 entries), then the last convolution."""
    return [
        (r"^conv_in\.", "main.0."),
        (r"^blocks\.(\d+)\.conv\.", lambda m: f"main.{2 + 3 * int(m[1])}."),
        (r"^blocks\.(\d+)\.bn\.scale$", lambda m: f"main.{3 + 3 * int(m[1])}.weight"),
        (r"^blocks\.(\d+)\.bn\.bias$", lambda m: f"main.{3 + 3 * int(m[1])}.bias"),
        (r"^conv_out\.", f"main.{2 + 3 * n_layers}."),
    ]


def patchgan_from_state_dict(sd: Mapping, n_layers: int = 3,
                             device="cuda") -> disc_model.PatchGAN:
    """The PatchGAN discriminator, trainable; input channels and ndf read
    from the state dict."""
    sd = _numpy(sd)
    ndf, cin = sd["main.0.weight"].shape[:2]
    model = _load_renamed(lambda: disc_model.PatchGAN(cin, ndf, n_layers), sd,
                          _patchgan_rules(n_layers), device)
    return model.train().requires_grad_(True)


def patchgan_reference_state_dict(model: disc_model.PatchGAN) -> Dict[str, torch.Tensor]:
    return reference_state_dict(model, _patchgan_rules(len(model.blocks)))


# blocks.1 of the reference is a parameter-free LeakyReLU: its residual
# blocks start at blocks.2
STYLEGAN_RULES = [
    (r"^conv_in\.", "blocks.0."),
    (r"^blocks\.(\d+)\.conv_res\.", lambda m: f"blocks.{int(m[1]) + 2}.conv_res."),
    (r"^blocks\.(\d+)\.conv1\.", lambda m: f"blocks.{int(m[1]) + 2}.net.0."),
    (r"^blocks\.(\d+)\.conv2\.", lambda m: f"blocks.{int(m[1]) + 2}.net.2."),
    (r"^blocks\.(\d+)\.down\.", lambda m: f"blocks.{int(m[1]) + 2}.downsample.1."),
    (r"^final_conv\.", "final_conv.0."),
    (r"^fc1\.", "final_linear.0."),
    (r"^fc2\.", "final_linear.2."),
]
_SG_FC1 = "final_linear.0.weight"


def _fc1_input(w: torch.Tensor, to_hwc: bool) -> torch.Tensor:
    """Permute the first linear's input axis between the (C, 4, 4) and the
    (4, 4, C) flattening."""
    n, k = w.shape
    c = k // 16
    if to_hwc:
        return w.reshape(n, c, 4, 4).permute(0, 2, 3, 1).reshape(n, k)
    return w.reshape(n, 4, 4, c).permute(0, 3, 1, 2).reshape(n, k)


def stylegan_disc_from_state_dict(sd: Mapping, device="cuda") -> disc_model.StyleGANDisc:
    """The StyleGAN discriminator, trainable; the image size from its number
    of residual blocks (down to 4 x 4)."""
    sd = _numpy(sd)
    sd[_SG_FC1] = _fc1_input(torch.from_numpy(sd[_SG_FC1]), to_hwc=True).numpy()
    last = max(int(k.split(".")[1]) for k in sd if k.startswith("blocks."))
    cin = sd["blocks.0.weight"].shape[1]
    model = _load_renamed(lambda: disc_model.StyleGANDisc(cin, 2 ** (last - 1 + 2)), sd,
                          STYLEGAN_RULES, device)
    return model.train().requires_grad_(True)


def stylegan_disc_reference_state_dict(model: disc_model.StyleGANDisc
                                       ) -> Dict[str, torch.Tensor]:
    sd = reference_state_dict(model, STYLEGAN_RULES)
    sd[_SG_FC1] = _fc1_input(sd[_SG_FC1], to_hwc=False)
    return sd


# ---------------------------------------------------------------------------
# FID InceptionV3 (pytorch-fid layout) and the taming VQGAN (lightning
# `state_dict` of taming's VQModel)
# ---------------------------------------------------------------------------

def inception_from_state_dict(sd: Mapping, device="cuda") -> inception_model.InceptionV3:
    """The FID InceptionV3 from pytorch-fid's state dict, by identity; keys
    it does not use (`num_batches_tracked`) are ignored, a missing fc.bias
    is zero (the logits use no bias)."""
    zero_bias = torch.zeros(inception_model.NUM_LOGITS)
    return _load_renamed(inception_model.InceptionV3, sd, [], device,
                         fallback=lambda name: zero_bias if name == "fc.bias" else sd[name])


def inception_state_dict(model: inception_model.InceptionV3) -> Dict[str, torch.Tensor]:
    return reference_state_dict(model, [])


TAMING_RULES = [
    (r"\.scale$", ".weight"),
    (r"^embedding$", "quantize.embedding.weight"),
]


def taming_from_state_dict(sd: Mapping, cfg: taming_model.TamingVQConfig,
                           dtype: torch.dtype = torch.float32,
                           device="cuda") -> taming_model.TamingVQModel:
    """A taming VQGAN from its lightning state dict (the discriminator and
    LPIPS of its loss are not read)."""
    return _load_renamed(lambda: taming_model.TamingVQModel(cfg), sd, TAMING_RULES, device,
                         dtype)


def taming_reference_state_dict(model: taming_model.TamingVQModel) -> Dict[str, torch.Tensor]:
    return reference_state_dict(model, TAMING_RULES)


def _numpy(sd: Mapping) -> dict:
    return {k: v.detach().cpu().numpy() if hasattr(v, "detach") else np.asarray(v)
            for k, v in sd.items()}
