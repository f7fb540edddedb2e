"""Class-balanced c2i sampling for FID dumps (the JAX package's
`eval/sampler.py`, after the reference's sample_c2i_ddp.py).

Each process generates its shard of the image indices (rank r of w takes
r, r + w, ...) through `ControlARPipeline.generate`; the rank and world
size come from `torch.distributed` when it is initialised, else 0 of 1.
The images go to {out_dir}/images/{i}.png, and with one process to
{out_dir}/samples.npz under `arr_0`, the evaluator's format.
"""
from __future__ import annotations

import os
from typing import Optional

import numpy as np
import torch

from controlar_tpu_torch import resolve_device
from controlar_tpu_torch.pipeline import ControlARPipeline


def _shard() -> tuple:
    if torch.distributed.is_available() and torch.distributed.is_initialized():
        return torch.distributed.get_rank(), torch.distributed.get_world_size()
    return 0, 1


def sample_c2i_fid(pipe: ControlARPipeline, num_images: int, *, batch_size: int = 8,
                   num_classes: int = 1000, cfg_scale: float = 4.0, top_k: int = 2000,
                   out_dir: Optional[str] = None, seed: int = 0,
                   condition_images: Optional[np.ndarray] = None,
                   device="cuda") -> np.ndarray:
    """Generate this process's shard of `num_images` class-balanced samples
    (image i has label i % num_classes and condition image i % len), in
    batches of batch_size (the tail batch padded with its own first indices,
    the extras dropped), each with a seed drawn from
    np.random.default_rng(seed + rank). Returns the uint8 (N, H, W, 3)
    shard. `device` ('cuda' unless the caller asks for 'cpu') must be the
    pipeline's."""
    dev = resolve_device(device)
    if pipe.device.type != dev.type:
        raise ValueError(f"the pipeline is on {pipe.device}, expected {dev}")
    rank, world = _shard()
    shard = np.arange(num_images)[rank::world]
    rng = np.random.default_rng(seed + rank)
    outs = []
    for start in range(0, len(shard), batch_size):
        idx = shard[start: start + batch_size]
        keep = len(idx)
        if keep < batch_size:
            idx = np.concatenate([idx, idx[: batch_size - keep]])
        cond = None
        if condition_images is not None:
            cond = condition_images[idx % len(condition_images)]
        imgs = pipe.generate(labels=idx % num_classes, condition_images=cond,
                             cfg_scale=cfg_scale, top_k=top_k,
                             seed=int(rng.integers(0, 1 << 31)))
        outs.append(imgs[:keep])
    shard_imgs = np.concatenate(outs, axis=0) if outs else np.zeros((0,))
    if out_dir is not None:
        from PIL import Image

        img_dir = os.path.join(out_dir, "images")
        os.makedirs(img_dir, exist_ok=True)
        for i, img in zip(shard, shard_imgs):
            Image.fromarray(img).save(os.path.join(img_dir, f"{i}.png"))
        if world == 1:
            np.savez(os.path.join(out_dir, "samples.npz"), arr_0=shard_imgs)
    return shard_imgs
