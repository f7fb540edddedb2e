"""The full-width configurations the port is run at on the card, with random
weights and inputs made from a seed. `chip_smoke.py` and `trace_decode` build
their pipelines here, so both drive the same configuration.

  c2i           GPT-B (12 layers, 12 heads, dim 768), 384 px = 576 tokens,
                CFG 4.0
  t2i           GPT-XL (36 layers, 20 heads, dim 1280), 512 px = 1024 tokens,
                CFG 7.5, 120-token random captions left-padded to CAPTION_LENS
  c2i_w8kv8     c2i with W8A16 weights (head included) and the int8 KV cache:
                the JAX package's CLI `--quant`
  c2i_3b_w4kv4  GPT-3B (24 layers, 32 heads x 100, dim 3200, FFN 8704), c2i
                384 px, CFG 4.0, W4A16 split-rope weights with fused w13, an
                int8 head and the int4 KV cache: the JAX package's
                `bench.py` extra_gpt3b_w4

All: batch 8 (16 rows with CFG), top_k 2000, Canny on synthetic images,
DINOv2-small adapter, VQ-16 decoder, bf16 GPT (quantized after it is made,
layer by layer, on the device), fp32 adapter and decoder.
"""
from __future__ import annotations

import numpy as np
import torch

from controlar_tpu_torch.config import gpt_config, vq_config
from controlar_tpu_torch.models import gpt as gpt_model
from controlar_tpu_torch.models import vit as vit_model
from controlar_tpu_torch.models import vq as vq_model
from controlar_tpu_torch.pipeline import ControlARPipeline
from controlar_tpu_torch.quant import quantize_gpt

_C2I = dict(model_type="c2i", cls_token_num=1, image_px=384, cfg_scale=4.0)
CELLS = {
    "c2i": dict(size="GPT-B", **_C2I),
    "t2i": dict(size="GPT-XL", model_type="t2i", cls_token_num=120, image_px=512,
                cfg_scale=7.5),
    "c2i_w8kv8": dict(size="GPT-B", **_C2I, quant="int8", cache_dtype=torch.int8),
    "c2i_3b_w4kv4": dict(size="GPT-3B", **_C2I, quant="w4", split_rope=True,
                         cache_dtype="int4"),
}
BATCH = 8
TOP_K = 2000
CAPTION_LENS = (17, 120, 64, 33, 90, 8, 51, 120)


def condition_images(n: int, size: int, seed: int) -> np.ndarray:
    """Blocky synthetic RGB images with real edges, uint8 (n, size, size, 3)."""
    rng = np.random.default_rng(seed)
    low = rng.integers(0, 256, (n, size // 32, size // 32, 3)).astype(np.uint8)
    img = low.repeat(32, axis=1).repeat(32, axis=2)
    noise = rng.integers(-8, 9, img.shape)
    return np.clip(img.astype(np.int32) + noise, 0, 255).astype(np.uint8)


def caption_mask(lens, width: int, device) -> torch.Tensor:
    """Left padding: (len(lens), width) int, 1 on the last lens[i] columns."""
    lens = torch.as_tensor(lens, device=device)
    return (torch.arange(width, device=device)[None, :] >= (width - lens)[:, None]).int()


def build_cell(name: str, seed: int = 0, device="cuda"):
    """-> (pipeline, keyword arguments of one `pipeline.generate` call)."""
    cell = CELLS[name]
    px = cell["image_px"]
    cfg = gpt_config(cell["size"], model_type=cell["model_type"],
                     cls_token_num=cell["cls_token_num"], block_size=(px // 16) ** 2,
                     vocab_size=16384, num_classes=1000)
    vcfg = vq_config("VQ-16")
    gpt = gpt_model.init_gpt(cfg, seed=seed, dtype=torch.bfloat16, device=device)
    if "quant" in cell:
        quantize_gpt(gpt, cfg, mode=cell["quant"], split_rope=cell.get("split_rope", False))
    pipe = ControlARPipeline(
        gpt_cfg=cfg,
        gpt=gpt,
        vq_cfg=vcfg, vq=vq_model.init_vq(vcfg, seed=seed + 1, device=device),
        adapter_cfg=vit_model.DINOV2_SMALL,
        adapter=vit_model.init_vit(vit_model.DINOV2_SMALL, seed=seed + 2, device=device),
        device=device)
    kw = dict(condition_images=condition_images(BATCH, px, seed + 7),
              cfg_scale=cell["cfg_scale"], top_k=TOP_K, cache_dtype=cell.get("cache_dtype"))
    if cell["model_type"] == "c2i":
        kw["labels"] = np.arange(BATCH) * 100
    else:
        gen = torch.Generator(device=device).manual_seed(seed + 3)
        masks = caption_mask(CAPTION_LENS, cfg.cls_token_num, device)
        caption = torch.randn(BATCH, cfg.cls_token_num, cfg.caption_dim, generator=gen,
                              device=device) * 0.1
        kw["caption_emb"] = caption.bfloat16() * masks[:, :, None]
        kw["emb_masks"] = masks
    return pipe, kw
