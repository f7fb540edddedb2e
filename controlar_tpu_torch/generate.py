"""CFG decode loop: prefill, then one decode step per token.

The conditional and unconditional branches ride one 2B batch; the logits are
split and mixed `uncond + (cond - uncond) * scale`. `cfg_interval` switches
the scale to 1 after decode step i == cfg_interval. The loop runs in Python
on the host and never waits for the device inside it.
"""
from __future__ import annotations

from typing import Callable, Optional, Union

import torch

from controlar_tpu_torch import decode as decode_engine
from controlar_tpu_torch import check_on, resolve_device
from controlar_tpu_torch.config import GPTConfig, find_multiple
from controlar_tpu_torch.models import gpt as gpt_model
from controlar_tpu_torch.ops.sampling import sample_from


def cfg_mix(logits: torch.Tensor, use_cfg: bool, scale: float) -> torch.Tensor:
    """[cond; uncond] logits -> uncond + (cond - uncond) * scale."""
    if not use_cfg:
        return logits
    cond, uncond = torch.chunk(logits, 2, dim=0)
    return uncond + (cond - uncond) * scale


@torch.inference_mode()
def generate_tokens(
    model: gpt_model.GPT,
    cfg: GPTConfig,
    prefix_emb: torch.Tensor,
    fused3: Optional[torch.Tensor],
    col_mask: Optional[torch.Tensor],
    generator: Optional[torch.Generator],
    control_strength=1.0,
    *,
    max_new_tokens: int,
    cfg_scale: float = 1.0,
    cfg_interval: int = -1,
    temperature: float = 1.0,
    top_k: int = 0,
    top_p: float = 1.0,
    sample_logits: bool = True,
    cache_dtype: Union[torch.dtype, str] = torch.bfloat16,
    use_flash: bool = False,
    kv_stacked: bool = False,
    on_step: Optional[Callable[[int], None]] = None,
) -> torch.Tensor:
    """Generate image tokens; the caller has done the CFG doubling
    (prefix_emb, fused3 and col_mask carry the [cond; uncond] batch when
    cfg_scale > 1).

    prefix_emb: (Bc, T_cls, dim); fused3: (3, Bc, block_size, dim) or None;
    col_mask: (Bc, T_cls) bool or None. The cache holds
    find_multiple(T_cls + max_new_tokens, 256 if use_flash else 8) rows;
    cache_dtype is a floating dtype, torch.int8 or "int4" (see
    `decode.init_flat_caches`); kv_stacked=True selects the stacked cache
    (`decode.init_stacked_caches`), whose decode step writes every layer's
    new row once at its end. `on_step(i)`, when given, is called after
    decode step i (i = 0 is the first step after the prefill).
    Returns (B, max_new_tokens) int64 tokens of the conditional half.
    """
    bc, t_cls, _ = prefix_emb.shape
    dev = prefix_emb.device
    use_cfg = cfg_scale > 1.0
    s_max = find_multiple(t_cls + max_new_tokens, 256 if use_flash else 8)
    init = decode_engine.init_stacked_caches if kv_stacked else decode_engine.init_flat_caches
    caches = init(cfg, bc, s_max, cache_dtype, dev)
    rope = decode_engine.rope_tables(model, cfg, dev)

    def sample(logits):
        return sample_from(logits, generator, temperature, top_k, top_p, sample_logits)

    logits, caches = decode_engine.prefill_flat(
        model, cfg, caches, prefix_emb, fused3, col_mask, control_strength, rope)
    cur = sample(cfg_mix(logits, use_cfg, cfg_scale))

    col_mask_full = None
    if col_mask is not None:
        col_mask_full = torch.cat(
            [col_mask, torch.ones((bc, s_max - t_cls), dtype=torch.bool, device=dev)], dim=1)

    tokens = [cur]
    for i in range(max_new_tokens - 1):
        cur_c = torch.cat([cur, cur]) if use_cfg else cur
        logits, caches = decode_engine.decode_step_flat(
            model, cfg, caches, cur_c, t_cls + i, fused3, col_mask_full,
            control_strength, use_flash=use_flash, rope_table=rope)
        scale = 1.0 if -1 < cfg_interval < i else cfg_scale
        cur = sample(cfg_mix(logits, use_cfg, scale))
        tokens.append(cur)
        if on_step is not None:
            on_step(i)
    return torch.stack(tokens, dim=1)


def prepare_inputs(model: gpt_model.GPT, cfg: GPTConfig, dev: torch.device, use_cfg: bool, *,
                   labels=None, caption_emb=None, emb_masks=None, adapter_features=None):
    """The model's inputs for a generate call, with the CFG doubling:
    -> (prefix_emb (Bc, T_cls, dim), col_mask (Bc, T_cls) bool or None,
    fused3 (3, Bc, block_size, dim) or None). adapter_features are the raw
    adapter outputs (B, block_size, adapter_dim); the adapter MLP is applied
    here, and the unconditional CFG half gets zero control."""
    dtype = gpt_model.param_dtype(model)
    col_mask = None
    if cfg.model_type == "c2i":
        if labels is None:
            raise ValueError("c2i generation needs labels")
        labels = torch.as_tensor(labels, device=dev).long()
        if use_cfg:
            labels = torch.cat([labels, torch.full_like(labels, cfg.num_classes)])
        prefix = gpt_model.embed_prefix_c2i(model, labels)
    else:
        if caption_emb is None:
            raise ValueError("t2i generation needs caption_emb")
        caption_emb = torch.as_tensor(caption_emb, device=dev).to(dtype)
        if use_cfg:
            uncond = model.cls_embedding.uncond_embedding[None].expand_as(caption_emb)
            caption_emb = torch.cat([caption_emb, uncond.to(caption_emb.dtype)])
        prefix = gpt_model.embed_prefix_t2i(model, caption_emb)
        if emb_masks is not None:
            col_mask = torch.as_tensor(emb_masks, device=dev).bool()
            if use_cfg:
                col_mask = torch.cat([col_mask, col_mask])
        prefix = prefix[:, : cfg.cls_token_num]

    fused3 = None
    if adapter_features is not None:
        feats = torch.as_tensor(adapter_features, device=dev).to(dtype)
        cond_tok = gpt_model.mlp_gelu(model.adapter_mlp, feats)
        if use_cfg:
            cond_tok = torch.cat([cond_tok, torch.zeros_like(cond_tok)])
        cond_tok = gpt_model.mlp_gelu(model.condition_mlp, cond_tok)
        fused3 = gpt_model.fusion_projections(model, cond_tok)
    return prefix, col_mask, fused3


@torch.inference_mode()
def generate(
    model: gpt_model.GPT,
    cfg: GPTConfig,
    *,
    labels: Optional[torch.Tensor] = None,
    caption_emb: Optional[torch.Tensor] = None,
    emb_masks: Optional[torch.Tensor] = None,
    adapter_features: Optional[torch.Tensor] = None,
    max_new_tokens: int,
    cfg_scale: float = 1.0,
    cfg_interval: int = -1,
    temperature: float = 1.0,
    top_k: int = 0,
    top_p: float = 1.0,
    sample_logits: bool = True,
    control_strength: float = 1.0,
    seed: int = 0,
    cache_dtype: Union[torch.dtype, str] = torch.bfloat16,
    use_flash: Optional[bool] = None,
    kv_stacked: bool = False,
    device="cuda",
    on_step: Optional[Callable[[int], None]] = None,
) -> torch.Tensor:
    """Class- or caption-conditioned, optionally controlled generation.

    adapter_features are the raw adapter outputs (B, block_size,
    adapter_dim); the adapter MLP is applied here, and the unconditional CFG
    half gets zero control. `use_flash=None` takes the kernel on the card
    when every head has its own K/V head. cache_dtype torch.int8 or "int4"
    selects a quantized KV cache; it pairs with a model quantized by
    `quant.quantize_gpt` (any mix is allowed, as in the JAX package).
    kv_stacked=True selects the stacked (L, B, S, R) KV cache, with every
    layer's new row written once at the end of a step. Runs on `device`
    ('cuda' unless the caller asks for 'cpu'); the model must already be
    there.
    """
    dev = resolve_device(device)
    check_on(model, dev)
    if use_flash is None:
        use_flash = dev.type == "cuda" and cfg.kv_heads == cfg.n_head
    prefix, col_mask, fused3 = prepare_inputs(
        model, cfg, dev, cfg_scale > 1.0, labels=labels, caption_emb=caption_emb,
        emb_masks=emb_masks, adapter_features=adapter_features)

    generator = torch.Generator(device=dev).manual_seed(seed)
    return generate_tokens(
        model, cfg, prefix, fused3, col_mask, generator, control_strength,
        max_new_tokens=max_new_tokens,
        cfg_scale=cfg_scale,
        cfg_interval=cfg_interval,
        temperature=temperature,
        top_k=top_k,
        top_p=top_p,
        sample_logits=sample_logits,
        cache_dtype=cache_dtype,
        use_flash=use_flash,
        kv_stacked=kv_stacked,
        on_step=on_step,
    )
