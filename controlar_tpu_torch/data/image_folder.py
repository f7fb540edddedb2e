"""Thin image-folder datasets (ref dataset/coco.py, openimage.py, pexels.py:
ImageFolder-ish builders over flat directories / nested class dirs), plus the
condition-utils contracts (ref condition/utils.py:6-38: HWC3 alpha-flatten
and resize to a x64 multiple). The port's copy of the JAX package's
`data/image_folder.py`.
"""
from __future__ import annotations

import os
from typing import Callable, Dict, List, Optional

import numpy as np
from PIL import Image

IMG_EXTS = (".png", ".jpg", ".jpeg", ".webp", ".bmp")


def hwc3(x: np.ndarray) -> np.ndarray:
    """Ensure HWC uint8 with 3 channels (ref HWC3, condition/utils.py:9-24):
    gray -> repeat; RGBA -> alpha-composite over white."""
    assert x.dtype == np.uint8
    if x.ndim == 2:
        x = x[:, :, None]
    c = x.shape[2]
    if c == 3:
        return x
    if c == 1:
        return np.repeat(x, 3, axis=2)
    if c == 4:
        color = x[:, :, :3].astype(np.float32)
        alpha = x[:, :, 3:4].astype(np.float32) / 255.0
        y = color * alpha + 255.0 * (1.0 - alpha)
        return y.clip(0, 255).astype(np.uint8)
    raise ValueError(f"unsupported channel count {c}")


def resize_to_multiple(
    img: np.ndarray, resolution: int, multiple: int = 64
) -> np.ndarray:
    """Scale the short side to `resolution` and round H, W to the nearest
    x`multiple` (ref resize_image, condition/utils.py:27-38; cv2 uses
    Lanczos up / area down — PIL LANCZOS covers both acceptably)."""
    h, w = img.shape[:2]
    k = resolution / min(h, w)
    new_h = int(np.round(h * k / multiple)) * multiple
    new_w = int(np.round(w * k / multiple)) * multiple
    pil = Image.fromarray(img).resize((new_w, new_h), Image.LANCZOS)
    return np.asarray(pil, np.uint8)


class ImageFolderDataset:
    """Flat or class-subdir folder of images -> {'image', 'label', 'path'}."""

    def __init__(self, root: str, transform: Optional[Callable] = None,
                 with_labels: bool = False):
        self.root = root
        self.transform = transform
        self.items: List = []
        self.class_names: List[str] = []
        if with_labels:
            for ci, cls in enumerate(sorted(os.listdir(root))):
                cdir = os.path.join(root, cls)
                if not os.path.isdir(cdir):
                    continue
                self.class_names.append(cls)
                for f in sorted(os.listdir(cdir)):
                    if f.lower().endswith(IMG_EXTS):
                        self.items.append((os.path.join(cdir, f), ci))
        else:
            for dirpath, _, files in sorted(os.walk(root)):
                for f in sorted(files):
                    if f.lower().endswith(IMG_EXTS):
                        self.items.append((os.path.join(dirpath, f), -1))

    def __len__(self):
        return len(self.items)

    def __getitem__(self, idx: int) -> Dict:
        path, label = self.items[idx]
        img = Image.open(path).convert("RGB")
        if self.transform is not None:
            img = self.transform(img)
        return {"image": np.asarray(img, np.uint8), "label": np.int32(label),
                "path": path}

    def make_batch(self, items):
        return {
            "image": np.stack([it["image"] for it in items]),
            "label": np.stack([it["label"] for it in items]),
            "path": [it["path"] for it in items],
        }


def build_coco(root, transform=None):
    return ImageFolderDataset(root, transform)


def build_openimage(root, transform=None):
    return ImageFolderDataset(root, transform)


def build_pexels(root, transform=None):
    return ImageFolderDataset(root, transform)


def build_imagenet(root, transform=None):
    return ImageFolderDataset(root, transform, with_labels=True)
