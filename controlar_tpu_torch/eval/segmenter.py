"""Reward-model segmenters for the mIoU consistency evals (the JAX
package's `eval/segmenter.py`).

The reference scores generated images with mmseg reward models
(Mask2Former-SwinL for ADE20K-150, DeepLabV3-R101 for COCOStuff-171).
`make_segmenter` takes either such a `.pth` (`convert_mmseg.py`) or a LOCAL
transformers checkpoint directory:

  - Mask2Former (`facebook/mask2former-swin-large-ade-semantic`) via
    AutoModelForUniversalSegmentation + post_process_semantic_segmentation,
  - SegFormer / UperNet / any AutoModelForSemanticSegmentation checkpoint
    via the logits-argmax path.

Both return `segmenter(images_u8 (B,H,W,3)) -> (B,H,W) int labels`, the
callable contract of eval/miou.miou_eval. The transformers path imports
transformers inside `hf_semantic_segmenter` only.
"""
from __future__ import annotations

from typing import Callable, Optional

import numpy as np

from controlar_tpu_torch import resolve_device
from controlar_tpu_torch.convert_mmseg import load_mmseg_segmenter


def hf_semantic_segmenter(
    model_dir: str,
    device="cuda",
    label_offset: int = 0,
    batch_size: int = 4,
) -> Callable[[np.ndarray], np.ndarray]:
    """Load a local transformers semantic-segmentation checkpoint.

    label_offset is added to predictions (the ADE20K protocol compares
    1-based gt labels with ignore 0 against 0-based model classes, ref
    ade20k_mIoU.py:45-46 `pred ... + 1`). Runs on `device` ('cuda' unless
    the caller asks for 'cpu').
    """
    import torch
    from transformers import AutoConfig, AutoImageProcessor

    device = resolve_device(device)
    config = AutoConfig.from_pretrained(model_dir)
    arch = (config.architectures or [""])[0]
    processor = AutoImageProcessor.from_pretrained(model_dir)

    if "Mask2Former" in arch or "MaskFormer" in arch or "OneFormer" in arch:
        from transformers import AutoModelForUniversalSegmentation

        model = AutoModelForUniversalSegmentation.from_pretrained(model_dir)
        universal = True
    else:
        from transformers import AutoModelForSemanticSegmentation

        model = AutoModelForSemanticSegmentation.from_pretrained(model_dir)
        universal = False
    model = model.to(device).eval()

    def segment(images_u8: np.ndarray) -> np.ndarray:
        images_u8 = np.asarray(images_u8, np.uint8)
        h, w = images_u8.shape[1:3]
        outs = []
        for i in range(0, len(images_u8), batch_size):
            chunk = list(images_u8[i : i + batch_size])
            inputs = processor(images=chunk, return_tensors="pt").to(device)
            with torch.no_grad():
                out = model(**inputs)
            if universal:
                maps = processor.post_process_semantic_segmentation(
                    out, target_sizes=[(h, w)] * len(chunk)
                )
                outs.extend(m.cpu().numpy() for m in maps)
            else:
                logits = torch.nn.functional.interpolate(
                    out.logits, size=(h, w), mode="bilinear", align_corners=False
                )
                outs.extend(logits.argmax(1).cpu().numpy())
        return np.stack(outs).astype(np.int64) + label_offset

    return segment


def make_segmenter(
    spec: str, device="cuda", label_offset: Optional[int] = None
) -> Callable[[np.ndarray], np.ndarray]:
    """spec: a local transformers model directory, or an mmseg `.pth`
    checkpoint (the reference's exact reward models — Mask2Former-SwinL-ADE /
    DeepLabV3-R101-COCOStuff — load via convert/mmseg_seg.py). The ADE20K
    1-based label convention is applied automatically when the model has 150
    classes and no explicit offset is given."""
    import json
    import os

    device = resolve_device(device)
    if spec.endswith((".pth", ".pt")) and os.path.isfile(spec):
        return load_mmseg_segmenter(spec, device=device,
                                    label_offset=label_offset)

    offset = label_offset
    if offset is None:
        cfg_path = os.path.join(spec, "config.json")
        offset = 0
        if os.path.exists(cfg_path):
            with open(cfg_path) as f:
                n = len(json.load(f).get("id2label", {}))
            if n == 150:  # ADE20K convention (ref ade20k_mIoU.py:45-46)
                offset = 1
    return hf_semantic_segmenter(spec, device=device, label_offset=offset)
