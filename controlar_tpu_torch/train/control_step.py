"""The full control-training step (the JAX package's `train/control_step.py`):
condition extraction on the device -> the trained DINOv2 adapter -> control
fusion -> CE loss.

- the condition map is computed on the device from the raw image by
  `control_nets.condition_map` (Canny; HED or lineart through the frozen
  networks `frozen["hed"]` / `frozen["lineart"]`, which take no gradient
  and no optimizer state) or read from a pre-extracted `control_map`;
- the adapter is among the optimized parameters;
- the t2i caption mask is the compact per-key column mask `t2i_key_valid`
  (the flash kernels' form); `build_t2i_attn_mask` is its materialised form
  for the einsum path;
- caption and condition CFG dropout share drop_ids;
- the condition map and the adapter (with `control_tokens`) are the
  profiler spans `train.condition` and `train.adapter` (`spans.span`),
  inside `apply_step`'s `train.forward`.
"""
from __future__ import annotations

from typing import Any, Dict, Optional

import torch
from torch import nn

from controlar_tpu_torch.config import GPTConfig
from controlar_tpu_torch.models import control_nets
from controlar_tpu_torch.models import gpt as gpt_model
from controlar_tpu_torch.models import vit as vit_model
from controlar_tpu_torch.ops.resize import to_patch14
from controlar_tpu_torch.spans import span
from controlar_tpu_torch.train.optimizer import AdamW
from controlar_tpu_torch.train.step import (
    TrainState,
    _Loss,
    apply_step,
    drop_ids,
    loss_weight,
    prefix_embedding,
    step_key,
)


class ControlModel(nn.Module):
    """The optimized modules of a control step: parameters `gpt.*` and
    `adapter.*`."""

    def __init__(self, gpt: gpt_model.GPT, adapter: vit_model.ViT):
        super().__init__()
        self.gpt = gpt
        self.adapter = adapter


# the entries of `frozen` each condition type's map reads; any other entry
# (the multiscale step's tokenizer, "vq") is not the condition's and is ignored
CONDITION_NETS = {"canny": (), "hed": ("hed",), "lineart": ("lineart",),
                  "depth": ("depth_fn", "midas", "midas_cfg", "dpt", "dpt_cfg")}


def extract_condition_on_device(batch: Dict[str, torch.Tensor], condition_type: str,
                                frozen: Optional[Dict[str, Any]] = None) -> torch.Tensor:
    """-> (B, H, W, 3) f32 in [-1, 1]. The map takes from `frozen` only the
    networks of `CONDITION_NETS[condition_type]`."""
    if "control_map" in batch:
        cm = batch["control_map"].float()
        cond = cm if cm.dim() == 4 else cm[..., None].expand(*cm.shape, 3)
        return 2.0 * (cond / 255.0 - 0.5)
    with torch.no_grad():
        nets = {k: v for k, v in (frozen or {}).items()
                if k in CONDITION_NETS.get(condition_type, ())}
        m = control_nets.condition_map(condition_type, batch["control_image"], **nets).float()
    cond = m[..., None].expand(*m.shape, 3)
    return 2.0 * (cond / 255.0 - 0.5)


def build_t2i_attn_mask(emb_mask: torch.Tensor, code_len: int) -> torch.Tensor:
    """(B, T_cls) bool -> (B, 1, T-1, T-1) bool, T = T_cls + code_len: causal,
    caption columns gated by emb_mask, the diagonal restored, then cut by
    one (the model input drops the last token). For the einsum path."""
    b, t_cls = emb_mask.shape
    t = t_cls + code_len
    dev = emb_mask.device
    causal = torch.ones(t, t, dtype=torch.bool, device=dev).tril()
    colmask = torch.cat([emb_mask.bool(), torch.ones(b, t - t_cls, dtype=torch.bool,
                                                     device=dev)], dim=1)
    eye = torch.eye(t, dtype=torch.bool, device=dev)
    m = causal[None] & (colmask[:, None, :] | eye[None])
    return m[:, None, : t - 1, : t - 1]


def t2i_key_valid(emb_mask: torch.Tensor, code_len: int) -> torch.Tensor:
    """The same semantics as a per-key column mask: (B, T-1) bool, caption
    columns gated by emb_mask, image columns always valid."""
    b = emb_mask.shape[0]
    return torch.cat([emb_mask.bool(), torch.ones(b, code_len - 1, dtype=torch.bool,
                                                  device=emb_mask.device)], dim=1)


def make_control_train_step(gpt_cfg: GPTConfig, adapter_cfg: vit_model.ViTConfig, tx: AdamW,
                            condition_type: str = "canny",
                            frozen: Optional[Dict[str, Any]] = None,
                            ema_decay: Optional[float] = None,
                            compute_dtype=torch.bfloat16, remat_policy: str = "full",
                            layout=None):
    """-> train_step(model: ControlModel, state, batch, seed) -> (state,
    metrics). The state's parameters are the ControlModel's, or with a
    `parallel.sharding.ShardLayout` this rank's pieces of them (the model
    split over tp as the layout says, gpt_cfg the rank's configuration).

    Batch: tokens (B, code_len) int; c2i labels (B,), t2i caption_emb (B,
    T_cls, caption_dim) and emb_mask (B, T_cls); control_image (B, H, W, 3)
    uint8 raw RGB or control_map (a uint8 map); valid (B,) float."""
    adapter_remat = remat_policy if remat_policy != "none" else False

    def loss_fn(model: ControlModel, batch, key):
        gpt, adapter = model.gpt, model.adapter
        tokens = batch["tokens"].long()
        dropped = drop_ids(gpt_cfg, tokens.shape[0], (*key, 0), tokens.device)
        with span("train.condition"):
            cond_img = extract_condition_on_device(batch, condition_type, frozen)
        with span("train.adapter"):
            feats = vit_model.vit_forward(adapter, adapter_cfg,
                                          to_patch14(cond_img, condition_type).to(compute_dtype),
                                          remat=adapter_remat)
            cond_tokens = gpt_model.control_tokens(gpt, gpt_cfg, feats, dropped)
        prefix = prefix_embedding(gpt, gpt_cfg, batch, dropped, compute_dtype)
        key_valid = None
        if gpt_cfg.model_type == "t2i":
            key_valid = t2i_key_valid(batch["emb_mask"], tokens.shape[1])
        _, loss = gpt_model.forward_train(
            gpt, gpt_cfg, prefix.to(compute_dtype), tokens[:, :-1], cond_tokens=cond_tokens,
            key_valid=key_valid, targets=tokens, valid=batch.get("valid"), rng=(*key, 1),
            deterministic=False, remat_policy=remat_policy)
        return loss

    def train_step(model: ControlModel, state: TrainState, batch: Dict[str, torch.Tensor],
                   seed: int):
        key = step_key(seed, state.step, layout)
        wrapper = _Loss(model, lambda: loss_fn(model, batch, key))
        return apply_step(wrapper, "model.", state, tx, compute_dtype, ema_decay, layout,
                          loss_weight(batch))

    train_step.loss_fn = loss_fn  # loss_fn(model, batch, key): the step's loss
    return train_step
