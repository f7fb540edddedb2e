"""Offline dataset extraction: images + captions -> code trees (the JAX
package's `data/extract.py`).

Builds the trees the datasets read (`data/t2i_control.py`):
    out/code/{i}.npy, out/caption_emb/{i}.npz, out/image/{i}.png,
    out/control/{i}.png, out/label/{i}.png
and the ImageNet-style c2i tree (`extract_c2i_tree`).

VQ encoding, Canny and MiDaS depth run batched on the device (the card
unless the caller asks for the CPU); caption features come from a
`text.embedder.T5Embedder`. Several processes interleave their trees
through rank-strided file names (i = process_index, + process_count, ...),
as the reference's extractors do.
"""
from __future__ import annotations

import os
from typing import Iterable, Optional

import numpy as np
import torch
from PIL import Image

from controlar_tpu_torch import check_on, resolve_device
from controlar_tpu_torch.config import VQConfig
from controlar_tpu_torch.data.augmentation import center_crop_arr
from controlar_tpu_torch.models import midas as midas_model
from controlar_tpu_torch.models import vq as vq_model
from controlar_tpu_torch.ops.canny import canny as canny_op


@torch.inference_mode()
def _encode(vq, vq_cfg: VQConfig, u8: np.ndarray, device: torch.device) -> np.ndarray:
    """uint8 (B, S, S, 3) -> VQ indices (B, S/f, S/f) on the host."""
    x = torch.as_tensor(u8, device=device).float() / 127.5 - 1.0
    return vq_model.encode(vq, vq_cfg, x, device=device)[1].cpu().numpy()


def extract_tree(
    out_dir: str,
    samples: Iterable[dict],
    vq: vq_model.VQModel,
    vq_cfg: VQConfig,
    t5_embedder=None,
    image_size: int = 512,
    process_index: int = 0,
    process_count: int = 1,
    batch_images: int = 8,
    device="cuda",
) -> int:
    """samples: iterable of {'image': PIL/ndarray, 'caption': str,
    'control': optional ndarray, 'label': optional ndarray}. Returns the
    number written.

    `batch_images` center-cropped images go to the VQ encoder as one
    (B, S, S, 3) batch, and their captions to the T5 embedder as one padded
    batch; each caption's features are stored cut to its valid tokens,
    (1, valid, d)."""
    dev = resolve_device(device)
    check_on(vq, dev)
    for sub in ("code", "caption_emb", "image", "control", "label"):
        os.makedirs(os.path.join(out_dir, sub), exist_ok=True)
    idx = process_index
    count = 0
    buf = []

    def flush():
        nonlocal idx, count
        if not buf:
            return
        codes = _encode(vq, vq_cfg, np.stack([np.asarray(s["image"], np.uint8) for s in buf]),
                        dev)
        caps = [s.get("caption") for s in buf]
        embs = None
        if t5_embedder is not None and any(c is not None for c in caps):
            embs, masks = t5_embedder.get_text_embeddings([c or "" for c in caps])
            embs, masks = embs.cpu().numpy(), masks.cpu().numpy()
        for j, sample in enumerate(buf):
            np.save(os.path.join(out_dir, "code", f"{idx}.npy"), codes[j].astype(np.int32))
            sample["image"].save(os.path.join(out_dir, "image", f"{idx}.png"))
            if embs is not None and caps[j] is not None:
                valid = int(masks[j].sum())
                np.savez(os.path.join(out_dir, "caption_emb", f"{idx}.npz"),
                         caption_emb=embs[j:j + 1, :valid], prompt=np.asarray([caps[j]]))
            for key, sub in (("control", "control"), ("label", "label")):
                if sample.get(key) is not None:
                    Image.fromarray(np.asarray(sample[key], np.uint8)).save(
                        os.path.join(out_dir, sub, f"{idx}.png"))
            idx += process_count
            count += 1
        buf.clear()

    for sample in samples:
        img = sample["image"]
        if not isinstance(img, Image.Image):
            img = Image.fromarray(np.asarray(img))
        buf.append(dict(sample, image=center_crop_arr(img.convert("RGB"), image_size)))
        if len(buf) >= batch_images:
            flush()
    flush()
    return count


# --- ImageNet c2i extraction -------------------------------------------------


def ten_crop(arr: np.ndarray, size: int) -> np.ndarray:
    """torchvision TenCrop order on an HWC array: tl, tr, bl, br, center,
    then the same five from the horizontally flipped image (the transform
    stack in ref extract_codes_c2i.py:59-65)."""
    h, w = arr.shape[:2]
    if h < size or w < size:
        raise ValueError(f"image {h}x{w} smaller than crop {size}")

    def five(a):
        ct = (h - size) // 2, (w - size) // 2
        return [
            a[:size, :size], a[:size, w - size:], a[h - size:, :size],
            a[h - size:, w - size:],
            a[ct[0]:ct[0] + size, ct[1]:ct[1] + size],
        ]

    return np.stack(five(arr) + five(arr[:, ::-1]))


def c2i_crops(img, image_size: int, use_ten_crop: bool,
              crop_range: float = 1.1) -> np.ndarray:
    """One image -> (A, S, S, 3) uint8 crops. ten_crop: center-crop to
    S*crop_range then TenCrop(S) (A=10, ref extract_codes_c2i.py:58-65);
    else center-crop to S and add the horizontal flip (A=2, ref :96-101)."""
    if not isinstance(img, Image.Image):
        img = Image.fromarray(np.asarray(img))
    img = img.convert("RGB")
    if use_ten_crop:
        big = np.asarray(center_crop_arr(img, int(image_size * crop_range)), np.uint8)
        return ten_crop(big, image_size)
    base = np.asarray(center_crop_arr(img, image_size), np.uint8)
    return np.stack([base, base[:, ::-1]])


def extract_c2i_tree(
    out_root: str,
    samples: Iterable[dict],
    vq: vq_model.VQModel,
    vq_cfg: VQConfig,
    *,
    dataset: str = "imagenet",
    image_size: int = 256,
    use_ten_crop: bool = False,
    crop_range: float = 1.1,
    conditions: tuple = (),
    canny_low: int = 100,
    canny_high: int = 200,
    midas: Optional[midas_model.MidasHybrid] = None,
    midas_cfg: Optional[midas_model.MidasHybridConfig] = None,
    batch_images: int = 8,
    process_index: int = 0,
    process_count: int = 1,
    device="cuda",
) -> int:
    """ImageNet-style c2i extraction (ref extract_codes_c2i.py +
    extract_file_imagenet.py:100-146): per sample i (rank-strided), write
        {out}/{dataset}{S}_codes/{i}.npy        (1, A, (S/16)^2) int64
        {out}/{dataset}{S}_labels/{i}.npy       (1,) int64
        {out}/{dataset}{S}_{cond}_imagesnpy/{i}.npy   (A, 1, S, S) uint8
        {out}/{dataset}{S}_{cond}_images/{i}.png      (crop 0 preview)
    the tree C2ICodeDataset reads. A = 10 (ten-crop) or 2 (flip). The crops
    of `batch_images` samples go to the VQ encoder, Canny and MiDaS as one
    (B*A, S, S, 3) device batch.

    samples: iterable of {'image': PIL/ndarray, 'label': int}. Returns the
    number written.
    """
    dev = resolve_device(device)
    check_on(vq, dev)
    if "depth" in conditions:
        if midas is None:
            raise ValueError("depth extraction needs the MiDaS model "
                             "(ref extract_file_imagenet.py MidasDetector)")
        check_on(midas, dev)
        midas_cfg = midas_cfg or midas_model.MIDAS_HYBRID
    prefix = os.path.join(out_root, f"{dataset}{image_size}")
    os.makedirs(f"{prefix}_codes", exist_ok=True)
    os.makedirs(f"{prefix}_labels", exist_ok=True)
    for cond in conditions:
        os.makedirs(f"{prefix}_{cond}_imagesnpy", exist_ok=True)
        os.makedirs(f"{prefix}_{cond}_images", exist_ok=True)

    idx = process_index
    count = 0
    buf_crops, buf_labels = [], []

    @torch.inference_mode()
    def condition_maps(flat: np.ndarray, b: int, a: int) -> dict:
        u8 = torch.as_tensor(flat, device=dev)
        maps = {}
        if "canny" in conditions:
            maps["canny"] = canny_op(u8, canny_low, canny_high)
        if "depth" in conditions:
            maps["depth"] = midas_model.midas_depth_condition(midas, midas_cfg, u8).to(torch.uint8)
        s = image_size
        return {k: v.cpu().numpy().reshape(b, a, 1, s, s) for k, v in maps.items()}

    def flush():
        nonlocal idx, count
        if not buf_crops:
            return
        b, a = len(buf_crops), buf_crops[0].shape[0]
        flat = np.concatenate(buf_crops, 0)  # (B*A, S, S, 3)
        codes = _encode(vq, vq_cfg, flat, dev).reshape(b, a, -1)
        conds = condition_maps(flat, b, a)
        for j in range(b):
            np.save(f"{prefix}_codes/{idx}.npy", codes[j][None].astype(np.int64))
            np.save(f"{prefix}_labels/{idx}.npy", np.asarray([buf_labels[j]], np.int64))
            for cond, arr in conds.items():
                np.save(f"{prefix}_{cond}_imagesnpy/{idx}.npy", arr[j])
                Image.fromarray(arr[j][0, 0]).save(f"{prefix}_{cond}_images/{idx}.png")
            idx += process_count
            count += 1
        buf_crops.clear()
        buf_labels.clear()

    for sample in samples:
        buf_crops.append(c2i_crops(sample["image"], image_size, use_ten_crop, crop_range))
        buf_labels.append(int(sample["label"]))
        if len(buf_crops) >= batch_images:
            flush()
    flush()
    return count
