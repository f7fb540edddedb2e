"""t2i control dataset over extracted trees (ref dataset/t2i_control.py:36-167).

Tree layout (produced by extraction, ref extract_file_multigen.py:176-197):
    root/code/{i}.npy          VQ token grid
    root/caption_emb/{i}.npz   {'caption_emb': (1, L, 2048), 'prompt': str}
    root/image/{i}.png         source RGB image
    root/control/{i}.png       rendered control map (seg)
    root/control_depth/{i}.png depth map (depth)
    root/label/{i}.png         semantic labels (seg eval)

The port's copy of the JAX package's `data/t2i_control.py`. Deviations from
the reference (same training semantics):
- returns the compact (120,) emb_mask instead of a per-sample
  (1, 1144, 1144) boolean attention mask — the train step builds the mask
  on the device (ref builds it on the host per item,
  t2i_control.py:134-139).
- returns raw uint8 images for canny/hed/lineart; the control map is
  extracted on the device in the train step (the reference runs cv2.Canny
  in dataloader workers, t2i_control.py:145, and frozen HED/Lineart nets in
  the trainer, train_t2i_hed.py).
- images are NHWC.
"""
from __future__ import annotations

import dataclasses
import os
from typing import Dict, List, Optional

import numpy as np
from PIL import Image


@dataclasses.dataclass
class T2IControlConfig:
    code_path: str
    condition_type: str = "canny"
    image_size: int = 512
    downsample_size: int = 16
    code_path2: Optional[str] = None
    t5_feature_max_len: int = 120
    t5_feature_dim: int = 2048
    get_image: bool = False
    get_prompt: bool = False
    get_label: bool = False


class T2IControlCodeDataset:
    def __init__(self, cfg: T2IControlConfig):
        self.cfg = cfg
        self.code_files: List[str] = []
        for root in [cfg.code_path, cfg.code_path2]:
            if root is None:
                continue
            code_dir = os.path.join(root, "code")
            n = len(os.listdir(code_dir))
            self.code_files += [os.path.join(code_dir, f"{i}.npy") for i in range(n)]
        latent = cfg.image_size // cfg.downsample_size
        self.code_len = latent * latent

    def __len__(self) -> int:
        return len(self.code_files)

    def dummy_item(self) -> Dict[str, np.ndarray]:
        """Zero sample with valid=0 (ref dataset/t2i.py:88-93 fallback)."""
        cfg = self.cfg
        return {
            "tokens": np.zeros((self.code_len,), np.int32),
            "caption_emb": np.zeros((cfg.t5_feature_max_len, cfg.t5_feature_dim), np.float32),
            "emb_mask": np.ones((cfg.t5_feature_max_len,), np.bool_),
            "control_image": np.zeros((cfg.image_size, cfg.image_size, 3), np.uint8),
            "valid": np.float32(0.0),
        }

    def __getitem__(self, index: int) -> Dict[str, np.ndarray]:
        cfg = self.cfg
        code_path = self.code_files[index]
        try:
            code = np.load(code_path).astype(np.int32).reshape(-1)

            cap = np.load(code_path.replace("code", "caption_emb").replace("npy", "npz"))
            t5_feat = cap["caption_emb"][0]  # (L, 2048)
            feat_len = min(cfg.t5_feature_max_len, t5_feat.shape[0])
            # left-pad (ref t2i_control.py:125-133)
            caption_emb = np.zeros((cfg.t5_feature_max_len, cfg.t5_feature_dim), np.float32)
            caption_emb[-feat_len:] = t5_feat[:feat_len]
            emb_mask = np.zeros((cfg.t5_feature_max_len,), np.bool_)
            emb_mask[-feat_len:] = True

            out = {
                "tokens": code,
                "caption_emb": caption_emb,
                "emb_mask": emb_mask,
                "valid": np.float32(1.0),
            }

            ct = cfg.condition_type
            if ct in ("canny", "hed", "lineart"):
                # raw image; control extracted on device
                img = np.asarray(
                    Image.open(code_path.replace("code", "image").replace("npy", "png"))
                )
                out["control_image"] = img.astype(np.uint8)
            elif ct == "seg":
                ctrl = np.asarray(
                    Image.open(code_path.replace("code", "control").replace("npy", "png"))
                )
                out["control_map"] = ctrl.astype(np.uint8)
            elif ct == "depth":
                ctrl = np.asarray(
                    Image.open(
                        code_path.replace("code", "control_depth").replace("npy", "png")
                    )
                )
                out["control_map"] = ctrl.astype(np.uint8)
            else:
                raise ValueError(ct)

            if cfg.get_image and "control_image" not in out:
                out["image"] = np.asarray(
                    Image.open(code_path.replace("code", "image").replace("npy", "png"))
                ).astype(np.uint8)
            if cfg.get_prompt:
                out["prompt"] = str(cap["prompt"][0])
            if cfg.get_label:
                out["label"] = np.asarray(
                    Image.open(code_path.replace("code", "label").replace("npy", "png"))
                )
            return out
        except Exception:
            return self.dummy_item()

    def make_batch(self, items: List[Dict[str, np.ndarray]]) -> Dict[str, np.ndarray]:
        keys = items[0].keys()
        out = {}
        for k in keys:
            if k == "prompt":
                out[k] = [it[k] for it in items]
            else:
                out[k] = np.stack([np.asarray(it[k]) for it in items])
        return out


class C2ICodeDataset:
    """ImageNet c2i codes + control images
    (ref dataset/imagenet.py:9-105 CustomDataset).

    Tree: {root}/imagenet{S}_codes/{i}.npy (flip-augmented, (1, A, 256)),
    ..._labels/{i}.npy, ..._{cond}_imagesnpy/{i}.npy (A, H, W[, C]).

    Aug-dir mixing (ref imagenet.py:16-27,53-61): when a sibling tree with
    'ten_crop' replaced by 'ten_crop_105' exists (105-crop augmentation), each
    item loads from it with p=0.5. The reference leaves `condition_dir`
    unbound on the aug branch (imagenet.py:53-60 would NameError); here the
    aug condition tree is used when present, else the base tree.
    """

    def __init__(self, code_dir: str, label_dir: str,
                 condition_imgs_dir: Optional[str] = None, flip_aug: bool = True,
                 seed: int = 0):
        self.code_dir = code_dir
        self.label_dir = label_dir
        self.condition_imgs_dir = condition_imgs_dir
        self.flip_aug = flip_aug

        def aug_of(d):
            if d is None or "ten_crop" not in d:
                return None
            a = d.replace("ten_crop", "ten_crop_105")
            return a if os.path.isdir(a) else None

        self.aug_code_dir = aug_of(code_dir)
        self.aug_label_dir = aug_of(label_dir)
        self.aug_condition_imgs_dir = aug_of(condition_imgs_dir)
        if self.aug_code_dir is None or self.aug_label_dir is None:
            self.aug_code_dir = self.aug_label_dir = None
        n = len(os.listdir(code_dir))
        self.files = [f"{i}.npy" for i in range(n)]
        self.rng = np.random.default_rng(seed)

    def __len__(self):
        return len(self.files)

    def __getitem__(self, idx: int) -> Dict[str, np.ndarray]:
        f = self.files[idx]
        code_dir, label_dir = self.code_dir, self.label_dir
        cond_dir = self.condition_imgs_dir
        if self.aug_code_dir is not None and self.rng.random() < 0.5:
            code_dir, label_dir = self.aug_code_dir, self.aug_label_dir
            if self.aug_condition_imgs_dir is not None:
                cond_dir = self.aug_condition_imgs_dir
        code = np.load(os.path.join(code_dir, f))
        aug_idx = 0
        # ref c2i trees store codes as (1, A, T) with A augmentation crops
        # (extract.py flush); pick a random crop under flip_aug, else crop 0.
        aug_tree = code.ndim >= 3 and code.shape[0] == 1
        if aug_tree:
            if self.flip_aug:
                aug_idx = int(self.rng.integers(0, code.shape[1]))
            code = code[0, aug_idx]
        else:
            code = code.reshape(-1)
        out = {
            "tokens": code.astype(np.int32).reshape(-1),
            "labels": np.load(os.path.join(label_dir, f)).reshape(-1)[0].astype(np.int32),
        }
        if cond_dir is not None:
            cond = np.load(os.path.join(cond_dir, f))
            if cond.ndim >= 3 and (aug_tree or self.flip_aug):
                cond = cond[aug_idx]
            # ref extractors store (A, 1, H, W) (extract_file_imagenet.py:120
            # appends [None, None]); drop the singleton channel
            if cond.ndim == 3 and cond.shape[0] == 1:
                cond = cond[0]
            # stored as uint8-range maps; normalized on device
            out["control_map"] = cond.astype(np.uint8)
        return out

    make_batch = T2IControlCodeDataset.make_batch
