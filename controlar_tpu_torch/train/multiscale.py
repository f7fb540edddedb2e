"""Multiscale (arbitrary-resolution) control training (the JAX package's
`train/multiscale.py`).

Each step draws an (H, W) bucket under a token budget (`sample_bucket`),
encodes the batch's images with the frozen tokenizer (`frozen["vq"]`, no
gradient), extracts the condition from the images on the device, runs the
trained DINOv2 adapter at the bucket's size and `forward_train` on the
bucket's rectangular token grid (`GPTConfig.with_resolution`), with the
caption mask as the compact key mask, so attention takes the flash training
kernels on the card. A bucket is a new shape: the RoPE table is built per
call from the configuration, and nothing is cached by size.
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from controlar_tpu_torch import check_on, resolve_device
from controlar_tpu_torch.config import GPTConfig, VQConfig
from controlar_tpu_torch.models import gpt as gpt_model
from controlar_tpu_torch.models import vit as vit_model
from controlar_tpu_torch.models import vq as vq_model
from controlar_tpu_torch.ops.resize import to_patch14
from controlar_tpu_torch.train.control_step import (
    ControlModel,
    extract_condition_on_device,
    t2i_key_valid,
)
from controlar_tpu_torch.train.optimizer import AdamW
from controlar_tpu_torch.train.step import (
    TrainState,
    _Loss,
    apply_step,
    drop_ids,
    prefix_embedding,
)


def resolution_buckets(min_px: int = 384, max_px: int = 1024, step: int = 64,
                       max_tokens: int = 2304, downsample: int = 16) -> List[Tuple[int, int]]:
    """Every (H, W) on the grid whose token count is within the budget."""
    out = []
    for h in range(min_px, max_px + 1, step):
        for w in range(min_px, max_px + 1, step):
            if (h // downsample) * (w // downsample) <= max_tokens:
                out.append((h, w))
    return out


def sample_bucket(rng: np.random.Generator, buckets: List[Tuple[int, int]]) -> Tuple[int, int]:
    return buckets[int(rng.integers(0, len(buckets)))]


def encode_codes(vq: vq_model.VQModel, vq_cfg: VQConfig, images: torch.Tensor) -> torch.Tensor:
    """The frozen tokenizer's codes of images (B, H, W, 3) in [-1, 1] ->
    (B, H/f * W/f) int64, no gradient."""
    with torch.no_grad():
        _, codes = vq_model.encode(vq, vq_cfg, images, device=images.device)
    return codes.reshape(images.shape[0], -1)


def make_multiscale_train_step(gpt_cfg: GPTConfig, adapter_cfg: vit_model.ViTConfig,
                               vq_cfg: VQConfig, tx: AdamW, condition_type: str = "hed",
                               frozen: Optional[Dict[str, Any]] = None,
                               ema_decay: Optional[float] = None,
                               compute_dtype=torch.bfloat16, remat_policy: str = "full",
                               device="cuda"):
    """-> train_step(model: ControlModel, state, batch, seed) -> (state,
    metrics {loss, grad_norm}); t2i. Batch: images (B, H, W, 3) in [-1, 1]
    at the step's bucket size, caption_emb (B, T_cls, caption_dim),
    emb_mask (B, T_cls), valid (B,), moved to `device` ('cuda' unless the
    caller asks for 'cpu'), where the models must be. `frozen` holds the
    tokenizer under "vq" and the condition's network
    (`control_step.CONDITION_NETS`); none of them is optimized.
    `train_step.loss_fn(model, batch, key)` is the step's loss."""
    dev = resolve_device(device)
    adapter_remat = remat_policy if remat_policy != "none" else False

    def loss_fn(model: ControlModel, batch, key):
        gpt, adapter = model.gpt, model.adapter
        images = batch["images"]
        b, h, w, _ = images.shape
        f = vq_cfg.downsample_factor
        cfg = gpt_cfg.with_resolution(h // f, w // f)
        tokens = encode_codes(frozen["vq"], vq_cfg, images)
        dropped = drop_ids(cfg, b, (*key, 0), images.device)
        cond_batch = {"control_image": ((images + 1.0) * 127.5).to(torch.uint8)}
        cond_img = extract_condition_on_device(cond_batch, condition_type, frozen)
        feats = vit_model.vit_forward(adapter, adapter_cfg,
                                      to_patch14(cond_img, condition_type).to(compute_dtype),
                                      remat=adapter_remat)
        cond_tokens = gpt_model.control_tokens(gpt, cfg, feats, dropped)
        prefix = prefix_embedding(gpt, cfg, batch, dropped, compute_dtype)
        key_valid = t2i_key_valid(batch["emb_mask"], tokens.shape[1])
        _, loss = gpt_model.forward_train(
            gpt, cfg, prefix.to(compute_dtype), tokens[:, :-1], cond_tokens=cond_tokens,
            key_valid=key_valid, targets=tokens, valid=batch.get("valid"), rng=(*key, 1),
            deterministic=False, remat_policy=remat_policy)
        return loss

    def train_step(model: ControlModel, state: TrainState, batch: Dict[str, torch.Tensor],
                   seed: int):
        check_on(model, dev)
        check_on(frozen["vq"], dev)
        batch = {k: torch.as_tensor(v, device=dev) for k, v in batch.items()}
        key = (seed, state.step)
        wrapper = _Loss(model, lambda: loss_fn(model, batch, key))
        return apply_step(wrapper, "model.", state, tx, compute_dtype, ema_decay)

    train_step.loss_fn = loss_fn
    return train_step
