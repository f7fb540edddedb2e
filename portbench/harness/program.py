"""The program under test, built from a configuration file and the
benchmark's weights through its own loaders (`convert_ref`), and the same
weights again for the reference. Only this module and the loops import
the program."""
from __future__ import annotations

from typing import Dict

import torch

from portbench.harness import weights
from portbench.reference import gpt as ref_gpt
from portbench.reference import vit as ref_vit
from portbench.reference import vq as ref_vq

DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def make_weights(cfg: dict, seed: int, device, parts=("gpt", "adapter", "vq")
                 ) -> Dict[str, Dict[str, torch.Tensor]]:
    """The configuration's weights in fp32 under the released keys."""
    g = cfg["gpt"]
    out = {}
    if "gpt" in parts:
        out["gpt"] = weights.make(ref_gpt.param_specs(g), seed, "gpt", device,
                                  std=g["initializer_range"], caption_dim=g["caption_dim"])
    if "adapter" in parts:
        out["adapter"] = weights.make(ref_vit.param_specs(cfg["adapter"]), seed, "adapter", device)
    if "vq" in parts:
        out["vq"] = weights.make(ref_vq.param_specs(cfg["vq"]), seed, "vq", device)
    return out


def reference_weights(cfg: dict, seed: int, device, parts=("gpt", "adapter", "vq")):
    """The same tensors as the program was handed, in fp32: the GPT's as its
    served dtype rounds them."""
    w = make_weights(cfg, seed, device, parts)
    if "gpt" in w:
        w["gpt"] = weights.as_served(w["gpt"], DTYPES[cfg["gpt"]["dtype"]])
    return w


def gpt_config(cfg: dict):
    """The port's GPTConfig of the configuration, checked against its sizes."""
    from controlar_tpu_torch.config import GPTConfig

    g, t = cfg["gpt"], cfg.get("train", {})
    drop = t.get("dropout", 0.0)
    c = GPTConfig(dim=g["dim"], n_layer=g["n_layer"], n_head=g["n_head"],
                  vocab_size=g["vocab_size"], num_classes=g["num_classes"],
                  caption_dim=g["caption_dim"], model_type=g["model_type"],
                  cls_token_num=g["cls_token_num"], block_size=g["block_size"],
                  adapter_size={384: "small", 768: "base"}[g["adapter_dim"]],
                  n_fusion_points=g["n_fusion_points"], norm_eps=g["norm_eps"],
                  rope_base=g["rope_base"], token_dropout_p=drop, resid_dropout_p=drop,
                  ffn_dropout_p=drop, class_dropout_prob=t.get("class_dropout", 0.0))
    check_gpt_config(c, cfg)
    return c


def check_gpt_config(c, cfg: dict) -> None:
    g = cfg["gpt"]
    got = (c.dim, c.n_layer, c.n_head, c.head_dim, c.ffn_hidden_dim, c.vocab_size,
           c.cls_token_num, c.block_size, tuple(c.grid), c.model_type, c.adapter_dim)
    want = (g["dim"], g["n_layer"], g["n_head"], g["head_dim"], g["ffn_dim"], g["vocab_size"],
            g["cls_token_num"], g["block_size"], tuple(g["grid"]), g["model_type"],
            g["adapter_dim"])
    if got != want:
        raise ValueError(f"the port's configuration {got} is not the file's {want}")


def adapter_config(cfg: dict):
    from controlar_tpu_torch.models import vit as vit_model

    a = cfg["adapter"]
    c = vit_model.ViTConfig(hidden_size=a["hidden_size"], n_layer=a["n_layer"],
                            n_head=a["n_head"], mlp_ratio=a["mlp_dim"] / a["hidden_size"],
                            patch_size=a["patch_size"], pos_grid=a["pos_grid"],
                            layerscale=True, layer_norm_eps=a["layer_norm_eps"])
    if c.mlp_dim != a["mlp_dim"]:
        raise ValueError(f"the port's adapter MLP {c.mlp_dim} is not the file's {a['mlp_dim']}")
    return c


def vq_config(cfg: dict):
    from controlar_tpu_torch.config import VQConfig

    v = cfg["vq"]
    return VQConfig(codebook_size=v["codebook_size"], codebook_embed_dim=v["embed_dim"],
                    encoder_ch_mult=tuple(v["ch_mult"]), decoder_ch_mult=tuple(v["ch_mult"]),
                    z_channels=v["z_channels"], ch=v["ch"], num_res_blocks=v["num_res_blocks"])


# the KV cache a configuration's "quant" group names -> generate's cache_dtype
CACHE_DTYPES = {"bfloat16": None, "int8": torch.int8, "int4": "int4"}


def build_pipeline(cfg: dict, seed: int, device):
    """ControlARPipeline of the configuration: the GPT in its served dtype,
    the adapter and tokenizer in their stated dtypes, from the benchmark's
    weights; with a "quant" group, the GPT's decode weights then quantized
    by the program as it says: {"weights": "int8" | "w4", "split_rope":
    bool, "cache": "bfloat16" | "int8" | "int4"}."""
    from controlar_tpu_torch import convert_ref
    from controlar_tpu_torch.pipeline import ControlARPipeline

    w = make_weights(cfg, seed, device)
    gcfg, acfg, vcfg = gpt_config(cfg), adapter_config(cfg), vq_config(cfg)
    gpt = convert_ref.gpt_from_state_dict(w.pop("gpt"), gcfg, DTYPES[cfg["gpt"]["dtype"]], device)
    adapter = convert_ref.vit_from_hf_state_dict(w.pop("adapter"), acfg,
                                                 dtype=DTYPES[cfg["adapter"]["dtype"]],
                                                 device=device)
    vq = convert_ref.vq_from_state_dict(w.pop("vq"), vcfg, DTYPES[cfg["vq"]["dtype"]], device)
    if "quant" in cfg:
        from controlar_tpu_torch.quant import quantize_gpt

        q = cfg["quant"]
        quantize_gpt(gpt, gcfg, mode=q["weights"], split_rope=q.get("split_rope", False))
    return ControlARPipeline(gpt_cfg=gcfg, gpt=gpt, vq_cfg=vcfg, vq=vq, adapter_cfg=acfg,
                             adapter=adapter, condition_type="canny", device=device)


def generate_options(cfg: dict) -> dict:
    """The generate arguments the configuration's "quant" group selects."""
    if "quant" not in cfg:
        return {}
    return {"cache_dtype": CACHE_DTYPES[cfg["quant"]["cache"]]}


def lower_precision(pipe, cfg: dict) -> dict:
    """The program's own lower-precision paths, for the control: W8A16
    weights and the int8 cache for the GPT, bf16 for the adapter and the
    tokenizer. -> the generate arguments that select them."""
    from controlar_tpu_torch.quant import quantize_gpt

    if "quant" in cfg:
        raise ValueError("the control of a quantized configuration is not defined here")
    quantize_gpt(pipe.gpt, pipe.gpt_cfg, mode="int8")
    pipe.adapter.to(torch.bfloat16)
    pipe.vq.to(torch.bfloat16)
    return {"cache_dtype": torch.int8}
