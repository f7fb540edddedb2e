"""The one generator of inputs: every traffic mix is a data file of
parameters read here. The same seed gives the same inputs; different seeds
give the same sizes in another order, so a seed changes which inputs run,
not how much work they are."""
from __future__ import annotations

import hashlib

import numpy as np
import torch


def rng(seed: int, *tags) -> np.random.Generator:
    """A numpy generator for (seed, tags): large seeds are fine."""
    h = hashlib.sha256(":".join(map(str, (seed,) + tags)).encode()).digest()
    return np.random.default_rng(int.from_bytes(h[:16], "little"))


def torch_seed(seed: int, *tags) -> int:
    return int(rng(seed, "torch", *tags).integers(0, 2 ** 62))


def condition_images(n: int, size: int, seed: int, *tags) -> np.ndarray:
    """Blocky RGB images with real edges, uint8 (n, size, size, 3): 32-pixel
    blocks of random colours plus noise in [-8, 8] (the port's cell images)."""
    r = rng(seed, "images", *tags)
    low = r.integers(0, 256, (n, size // 32, size // 32, 3)).astype(np.uint8)
    img = low.repeat(32, axis=1).repeat(32, axis=2)
    noise = r.integers(-8, 9, img.shape)
    return np.clip(img.astype(np.int32) + noise, 0, 255).astype(np.uint8)


def spread(lo: int, hi: int, n: int, seed: int, *tags) -> np.ndarray:
    """n integers evenly spread over [lo, hi], in an order drawn from the seed."""
    vals = np.rint(np.linspace(lo, hi, n)).astype(np.int64)
    return rng(seed, "order", *tags).permutation(vals)


def caption_mask(lens, width: int) -> np.ndarray:
    """Left padding: (len(lens), width) bool, true on the last lens[i] columns."""
    lens = np.asarray(lens)
    return np.arange(width)[None, :] >= (width - lens)[:, None]


def captions(n: int, g: dict, lo: int, hi: int, seed: int, device, *tags):
    """Caption features as the text encoder's stand-in: N(0, 0.1), rounded to
    bf16 (the type the GPT takes them in), zero on the padding; lengths
    spread over [lo, hi]. -> (features (n, cls, caption_dim) bf16 on the
    device, mask (n, cls) bool numpy)."""
    mask = caption_mask(spread(lo, hi, n, seed, "caption", *tags), g["cls_token_num"])
    gen = torch.Generator(device=device).manual_seed(torch_seed(seed, "caption", *tags))
    emb = torch.randn(n, g["cls_token_num"], g["caption_dim"], generator=gen,
                      device=device) * 0.1
    emb = emb * torch.as_tensor(mask, device=device)[:, :, None]
    return emb.bfloat16(), mask


def labels(n: int, num_classes: int, seed: int, *tags) -> np.ndarray:
    return rng(seed, "labels", *tags).integers(0, num_classes, n)


def train_batch(g: dict, batch: int, image_px: int, cap_lo: int, cap_hi: int, seed: int,
                index: int) -> dict:
    """One host batch of the trainer's layout: random image tokens, caption
    features (N(0, 1) rounded to bf16, zero on the padding, left-padded to
    lengths spread over [cap_lo, cap_hi]), raw condition images, valid
    rows."""
    r = rng(seed, "train", index)
    out = {"tokens": r.integers(0, g["vocab_size"], (batch, g["block_size"])).astype(np.int32),
           "control_image": condition_images(batch, image_px, seed, "train", index),
           "valid": np.ones((batch,), np.float32)}
    if g["model_type"] == "c2i":
        out["labels"] = labels(batch, g["num_classes"], seed, "train", index)
    else:
        mask = caption_mask(spread(cap_lo, cap_hi, batch, seed, "train_caption", index),
                            g["cls_token_num"])
        emb = r.standard_normal((batch, g["cls_token_num"], g["caption_dim"])).astype(np.float32)
        emb = torch.from_numpy(emb * mask[:, :, None]).bfloat16().float().numpy()
        out.update(caption_emb=emb, emb_mask=mask.astype(np.int32))
    return out
