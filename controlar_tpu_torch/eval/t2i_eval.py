"""t2i quality metrics: CLIP score and clean-FID (the JAX package's
`eval/t2i_eval.py`, after the reference's evaluations/t2i/evaluation.py and
evaluations/clean_fid.py).

CLIP score follows the GigaGAN protocol the reference copies: prompts are
prepended with "A photo depicts " (arXiv:2104.08718), image / text
embeddings come from a CLIP model, and the score is the mean cosine
similarity over the first `how_many` pairs. The model is a transformers
CLIP checkpoint loaded from a LOCAL directory (e.g.
openai/clip-vit-base-patch32, the ViT-B/32 weights of the reference's
`openai_clip.load`).

clean-FID is a thin wrapper over the `cleanfid` package, as the reference's
script is; without the package it raises an ImportError that points to
eval/evaluator.py. Both import their package inside the function.
"""
from __future__ import annotations

from typing import List, Sequence

import numpy as np

from controlar_tpu_torch import resolve_device

PREPEND = "A photo depicts "


def clip_score(
    images_u8: np.ndarray,
    texts: Sequence[str],
    model_dir: str,
    device="cuda",
    batch_size: int = 16,
    how_many: int | None = None,
) -> float:
    """images (N,H,W,3) uint8 + N prompts -> mean cosine similarity, on
    `device` ('cuda' unless the caller asks for 'cpu')."""
    import torch
    from transformers import CLIPModel, CLIPProcessor

    device = resolve_device(device)
    model = CLIPModel.from_pretrained(model_dir).to(device).eval()
    processor = CLIPProcessor.from_pretrained(model_dir)

    n = len(texts) if how_many is None else min(how_many, len(texts))
    sims: List[float] = []
    for i in range(0, n, batch_size):
        imgs = [np.asarray(im, np.uint8) for im in images_u8[i : i + batch_size]]
        txts = [PREPEND + t for t in texts[i : i + batch_size]]
        inputs = processor(text=txts, images=imgs, return_tensors="pt",
                           padding=True, truncation=True).to(device)
        with torch.no_grad():
            out = model(**inputs)
        sim = torch.nn.functional.cosine_similarity(
            out.image_embeds, out.text_embeds, dim=1
        )
        sims.extend(float(x) for x in sim)
    return float(np.mean(sims[:n]))


def clean_fid(generated_dir: str, reference_dir: str,
              feature_extractor: str = "inception") -> float:
    """The reference's clean-FID entry (clean_fid.py:4-8 / evaluation.py
    compute_fid). Requires the `cleanfid` package."""
    try:
        from cleanfid import fid
    except ImportError as e:
        raise ImportError(
            "clean-FID needs the `cleanfid` package, which is not installed; "
            "eval/evaluator.py's evaluate_all is the in-house "
            "FID/sFID/IS/Precision/Recall protocol"
        ) from e
    model_name = {"inception": "inception_v3", "clip": "clip_vit_b_32"}[
        feature_extractor
    ]
    return float(fid.compute_fid(reference_dir, generated_dir,
                                 model_name=model_name))
