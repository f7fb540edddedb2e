"""Task label transforms and grouped crops for the reward / consistency flows
(the JAX package's `data/label_transforms.py`, itself the reference's
dataset/utils.py:76-188): colour-palette seg-map decoding, the per-task
label transforms feeding reward losses, and group_random_crop.

- The transforms are torch ops on batches of the layouts the reference
  uses, on the tensors' device.
- Nearest resize keeps torch's F.interpolate(mode="nearest") index
  convention, src = floor(dst * src_size / dst_size), so resized label grids
  match the reference pixel for pixel; bilinear resize is antialiased (the
  triangle filter torchvision applies on tensors, as jax.image.resize with
  antialias does in the JAX package).
"""
from __future__ import annotations

from typing import List, Optional, Sequence, Tuple, Union

import numpy as np
import torch
import torch.nn.functional as F

ADE20K_DATASET = "limingcv/Captioned_ADE20K"
COCOSTUFF_DATASET = "limingcv/Captioned_COCOStuff"


def _size2d(size) -> Tuple[int, int]:
    if isinstance(size, int):
        return (size, size)
    h, w = size
    return (int(h), int(w))


def nearest_resize(labels: torch.Tensor, output_size) -> torch.Tensor:
    """torch F.interpolate(mode='nearest') on the trailing two dims, any dtype."""
    oh, ow = _size2d(output_size)
    h, w = labels.shape[-2], labels.shape[-1]
    rows = torch.as_tensor(np.arange(oh) * h // oh, device=labels.device)
    cols = torch.as_tensor(np.arange(ow) * w // ow, device=labels.device)
    return labels[..., rows[:, None], cols[None, :]]


def bilinear_resize(labels: torch.Tensor, output_size) -> torch.Tensor:
    """Antialiased bilinear resize on the trailing two dims, in fp32
    (torchvision F.resize(..., BILINEAR, antialias=True))."""
    oh, ow = _size2d(output_size)
    lead, (h, w) = labels.shape[:-2], labels.shape[-2:]
    x = labels.float().reshape(-1, 1, h, w)
    y = F.interpolate(x, size=(oh, ow), mode="bilinear", align_corners=False, antialias=True)
    return y.reshape(*lead, oh, ow)


def map_color_to_index(image: torch.Tensor,
                       palette: Union[np.ndarray, torch.Tensor]) -> torch.Tensor:
    """RGB seg maps -> palette indices by nearest colour (ref utils.py:76-101).

    image: (N, 3, H, W) float in [0, 1] (the reference multiplies by 255 and
    takes an L2 argmin against the palette rows); palette: (K, 3).
    """
    pal = torch.as_tensor(palette, dtype=torch.float32, device=image.device)
    flat = (image.float() * 255.0).movedim(1, -1)              # (N, H, W, 3)
    # argmin ||x - p||, expanded so no (NHW, K, 3) tensor is made
    x2 = (flat * flat).sum(-1, keepdim=True)                   # (N, H, W, 1)
    p2 = (pal * pal).sum(-1)                                   # (K,)
    xp = torch.einsum("nhwc,kc->nhwk", flat, pal)              # (N, H, W, K)
    return torch.argmin(x2 + p2 - 2.0 * xp, dim=-1)


def seg_label_transform(labels: torch.Tensor, dataset_name: str = ADE20K_DATASET,
                        output_size=(64, 64),
                        palette: Optional[np.ndarray] = None) -> torch.Tensor:
    """Seg maps for the loss (ref dataset/utils.py:103-140): decode RGB to
    indices (ADE20K), resize NEAREST to the model's output grid, and make
    the background 255 (ADE20K stores it as 0, so indices shift down by one
    and 0 becomes 255).

    labels: (N, 3, H, W) RGB in [0, 1] for ADE20K; (N, H, W) indices for
    COCO-Stuff. Returns int32.
    """
    if dataset_name == ADE20K_DATASET:
        if palette is None:
            raise ValueError("ADE20K seg_label_transform needs the (K,3) palette "
                             "(the reference loads ade20k_palette.npy)")
        labels = nearest_resize(map_color_to_index(labels, palette), output_size) - 1
        labels = torch.where(labels == -1, 255, labels)
    elif dataset_name == COCOSTUFF_DATASET:
        labels = nearest_resize(labels, output_size)
    else:
        raise NotImplementedError(f"unknown dataset {dataset_name!r}")
    return labels.to(torch.int32)


def depth_label_transform(labels: torch.Tensor, dataset_name: str = "",
                          output_size=None) -> torch.Tensor:
    """(ref dataset/utils.py:142-153): optional antialiased bilinear resize."""
    if output_size is not None:
        labels = bilinear_resize(labels, output_size)
    return labels


def edge_label_transform(labels: torch.Tensor, dataset_name: str = "") -> torch.Tensor:
    """(ref dataset/utils.py:156-157): identity."""
    return labels


def label_transform(labels, task: str, dataset_name: str = "", **kw):
    """Dispatcher (ref dataset/utils.py:160-168)."""
    if task == "segmentation":
        return seg_label_transform(labels, dataset_name, **kw)
    if task == "depth":
        return depth_label_transform(labels, dataset_name, **kw)
    if task in ("canny", "lineart", "hed"):
        return edge_label_transform(labels, dataset_name, **kw)
    raise NotImplementedError(f"unknown task {task!r}")


def reward_loss(predictions: torch.Tensor, labels: torch.Tensor, task: str,
                ignore_index: int = 255) -> torch.Tensor:
    """Per-task reward losses (ref dataset/utils.py:43-61).

    segmentation: CE over class logits (N, K, H, W) against index labels,
    ignore_index masked, averaged over the valid pixels; canny: per-pixel MSE
    reduced to (N,) by the reference's .mean(2).mean((-1, -2)); depth /
    lineart / hed: MSE per sample, (N,).
    """
    if task == "segmentation":
        logp = torch.log_softmax(predictions.float(), dim=1)
        valid = labels != ignore_index
        safe = torch.where(valid, labels, 0).long()
        nll = -torch.gather(logp, 1, safe[:, None])[:, 0]
        return (nll * valid).sum() / valid.sum().clamp(min=1)
    se = (predictions.float() - labels.float()) ** 2
    if task == "canny":
        return se.mean(dim=2).mean(dim=(-1, -2))
    if task in ("depth", "lineart", "hed"):
        return se.reshape(se.shape[0], -1).mean(dim=-1)
    raise NotImplementedError(f"unknown task {task!r}")


def group_random_crop(images: Sequence[np.ndarray], resolution,
                      rng: np.random.Generator) -> List[np.ndarray]:
    """Random-crop each HWC image in the list to `resolution` (ref
    dataset/utils.py:171-188; the reference draws the crop PER IMAGE despite
    the name, and so does this). Host-side numpy, in the loader's workers;
    images must be at least `resolution`."""
    oh, ow = _size2d(resolution)
    out = []
    for img in images:
        h, w = img.shape[0], img.shape[1]
        if h < oh or w < ow:
            raise ValueError(f"image {h}x{w} smaller than crop {oh}x{ow}")
        i = int(rng.integers(0, h - oh + 1))
        j = int(rng.integers(0, w - ow + 1))
        out.append(img[i:i + oh, j:j + ow])
    return out


def image_grid(imgs, rows: int, cols: int):
    """Paste PIL images into a rows x cols grid (ref dataset/utils.py:64-73)."""
    assert len(imgs) == rows * cols
    from PIL import Image

    w, h = imgs[0].size
    grid = Image.new("RGB", size=(cols * w, rows * h))
    for i, img in enumerate(imgs):
        grid.paste(img, box=(i % cols * w, i // cols * h))
    return grid
