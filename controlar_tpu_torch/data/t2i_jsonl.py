"""LlamaGen-style jsonl image+T5-feature dataset (ref dataset/t2i.py:50-151,
Text2ImgDataset): jsonl lists of image paths, precomputed per-caption T5
features in parallel trees, 30% random swap to a short-caption tree, dummy
valid=0 fallback for unreadable/undersized images.

The port's copy of the JAX package's `data/t2i_jsonl.py`. Deviations from
the reference (same training semantics): returns the compact emb_mask
instead of a host-built (T, T) attention mask; images come back as uint8
NHWC arrays (crop/resize via data.augmentation at the caller's transform).
"""
from __future__ import annotations

import dataclasses
import json
import os
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
from PIL import Image


@dataclasses.dataclass
class T2IJsonlConfig:
    data_path: str                   # dir of *.jsonl with {'image_path': ...}
    t5_feat_path: str
    short_t5_feat_path: Optional[str] = None
    short_caption_prob: float = 0.3  # ref t2i.py:111
    image_size: int = 256
    downsample_size: int = 16
    t5_feature_max_len: int = 120
    t5_feature_dim: int = 2048


class Text2ImgJsonlDataset:
    def __init__(self, cfg: T2IJsonlConfig,
                 transform: Optional[Callable] = None, seed: int = 0):
        self.cfg = cfg
        self.transform = transform
        self.rng = np.random.default_rng(seed)
        self.items: List[Tuple[str, str, int]] = []
        for lst_name in sorted(os.listdir(cfg.data_path)):
            if not lst_name.endswith(".jsonl"):
                continue
            path = os.path.join(cfg.data_path, lst_name)
            code_dir = os.path.splitext(lst_name)[0]
            with open(path) as f:
                for line_idx, line in enumerate(f):
                    rec = json.loads(line)
                    self.items.append((rec["image_path"], code_dir, line_idx))

    def __len__(self):
        return len(self.items)

    def dummy_item(self) -> Dict[str, np.ndarray]:
        cfg = self.cfg
        return {
            "image": np.zeros((cfg.image_size, cfg.image_size, 3), np.uint8),
            "caption_emb": np.zeros(
                (cfg.t5_feature_max_len, cfg.t5_feature_dim), np.float32
            ),
            "emb_mask": np.ones((cfg.t5_feature_max_len,), np.bool_),
            "valid": np.float32(0.0),
        }

    def __getitem__(self, index: int) -> Dict[str, np.ndarray]:
        cfg = self.cfg
        img_path, code_dir, line_idx = self.items[index]
        try:
            img = Image.open(img_path).convert("RGB")
        except Exception:
            return self.dummy_item()
        if min(img.size) < cfg.image_size:
            return self.dummy_item()
        if self.transform is not None:
            img = self.transform(img)
        arr = np.asarray(img, np.uint8)

        t5_root = cfg.t5_feat_path
        if (cfg.short_t5_feat_path is not None
                and self.rng.random() < cfg.short_caption_prob):
            t5_root = cfg.short_t5_feat_path
        t5_file = os.path.join(t5_root, code_dir, f"{line_idx}.npy")
        if not os.path.isfile(t5_file):
            return self.dummy_item()
        try:
            t5_feat = np.load(t5_file)[0]  # (L, 2048)
        except Exception:
            return self.dummy_item()
        feat_len = min(cfg.t5_feature_max_len, t5_feat.shape[0])
        caption_emb = np.zeros((cfg.t5_feature_max_len, cfg.t5_feature_dim), np.float32)
        caption_emb[-feat_len:] = t5_feat[:feat_len]
        emb_mask = np.zeros((cfg.t5_feature_max_len,), np.bool_)
        emb_mask[-feat_len:] = True
        return {
            "image": arr,
            "caption_emb": caption_emb,
            "emb_mask": emb_mask,
            "valid": np.float32(1.0),
        }

    def make_batch(self, items):
        return {k: np.stack([it[k] for it in items]) for k in items[0]}
