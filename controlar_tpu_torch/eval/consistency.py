"""Conditional consistency, the paper's controllability metric: generate
from a condition, re-extract the condition from the generated image with
the same detector, and score the two maps: F1 for canny, MS-SSIM for hed
and lineart, RMSE for depth."""
from __future__ import annotations

from typing import Dict, Iterable

import numpy as np
import torch

from controlar_tpu_torch import resolve_device
from controlar_tpu_torch.eval.metrics import RMSE, SSIM, F1score
from controlar_tpu_torch.models.control_nets import condition_map


def make_metric(condition_type: str, device="cuda"):
    """The metric of a condition type (SSIM computed on `device`)."""
    if condition_type == "canny":
        return F1score(threshold=128)
    if condition_type in ("hed", "lineart"):
        return SSIM(device)
    if condition_type == "depth":
        return RMSE()
    raise ValueError(condition_type)


@torch.inference_mode()
def reextract(condition_type: str, images_u8: np.ndarray, hed=None, lineart=None,
              depth_fn=None, device="cuda") -> np.ndarray:
    """RGB uint8 (B, H, W, 3) -> control map (B, H, W) in 0..255, the
    networks run on `device`; depth through `depth_fn`."""
    if condition_type == "depth":
        return np.asarray(depth_fn(images_u8))
    x = torch.as_tensor(np.asarray(images_u8), device=resolve_device(device))
    return condition_map(condition_type, x, hed=hed, lineart=lineart).cpu().numpy()


def consistency_eval(pipe, batches: Iterable[Dict[str, np.ndarray]], condition_type: str,
                     cfg_scale: float = 4.0, top_k: int = 2000, seed: int = 0,
                     device="cuda", **extract_kw) -> float:
    """Each batch: {'condition_images': uint8 RGB, and the generation
    inputs}; batch i is generated with seed + i. `extract_kw` (hed, lineart,
    depth_fn) are the re-extraction's detectors. The pipeline must be on
    `device`. Returns the mean metric."""
    device = resolve_device(device)
    if pipe.device.type != device.type:
        raise ValueError(f"the pipeline is on {pipe.device}, the evaluation on {device}")
    metric = make_metric(condition_type, device)
    for i, batch in enumerate(batches):
        cond_in = batch["condition_images"]
        out = pipe.generate(labels=batch.get("labels"), caption_emb=batch.get("caption_emb"),
                            emb_masks=batch.get("emb_masks"), condition_images=cond_in,
                            cfg_scale=cfg_scale, top_k=top_k, seed=seed + i)
        gt_map = reextract(condition_type, cond_in, device=device, **extract_kw)
        gen_map = reextract(condition_type, out, device=device, **extract_kw)
        for a, b in zip(gt_map, gen_map):
            metric.update(a, b)
    return metric.calculate()
