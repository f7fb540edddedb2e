"""The control fine-tuning step in fp32: Canny of the raw images, the DINOv2
adapter (trained), the GPT's teacher-forced cross entropy with control, the
gradients of both, a global-norm clip and AdamW with decoupled weight decay
(`decayed` keys only), bias-corrected:

  g <- g * min(1, max_norm / |g|)      (|g| over every gradient)
  m <- b1 m + (1 - b1) g;  v <- b2 v + (1 - b2) g^2
  p <- p - lr ((m / (1 - b1^t)) / (sqrt(v / (1 - b2^t)) + eps) + wd p [decayed])

The loss is the mean over every image token of every row. Rows run in blocks
of `rows_per_block`, each layer recomputed in the backward, so that the fp32
step fits on one card; the gradients add up to those of the whole batch.
`mm` replaces every matrix product (the precision control).

Dropout follows the program's documented keys, so that the reference drops
what the program dropped: with the trainer's step seed S, step k (from 0)
draws its CFG dropout as torch.rand(B) < class_dropout under key (S, k, 0),
and its token, attention-output and FFN-output dropout as torch.rand of the
whole batch's (B, T, dim) < 1 - dropout under (S, k, 1, 0), (S, k, 1, 1, l,
1) and (S, k, 1, 1, l, 2) for layer l, kept elements scaled by 1 / (1 -
dropout). A key seeds a generator on the device: numpy's SeedSequence of
the key gives two 32-bit words a, b, and the seed is a << 31 | b >> 1.
"""
from __future__ import annotations

from typing import Dict, Optional, Sequence

import numpy as np
import torch

from . import canny as ref_canny
from . import gpt as ref_gpt
from . import vit as ref_vit

Params = Dict[str, torch.Tensor]


def keyed_generator(key: Sequence[int], device) -> torch.Generator:
    state = np.random.SeedSequence([int(x) for x in key]).generate_state(2, np.uint32)
    return torch.Generator(device=device).manual_seed(int(state[0]) << 31 | int(state[1]) >> 1)


class Dropout:
    """One step's element dropout over a block of the batch's rows: each
    mask drawn for the whole batch, then the block's rows taken."""

    def __init__(self, seed: int, step: int, p: float, batch: int, rows: torch.Tensor):
        self.key, self.p, self.batch, self.rows = (seed, step, 1), p, batch, rows

    def __call__(self, tail: tuple, x: torch.Tensor) -> torch.Tensor:
        u = torch.rand((self.batch,) + tuple(x.shape[1:]), device=x.device,
                       generator=keyed_generator(self.key + tuple(tail), x.device))
        keep = u[self.rows] < 1.0 - self.p
        return torch.where(keep, x / (1.0 - self.p), torch.zeros_like(x))


class Step:
    """`drop_seed` is the trainer's step seed S (see above); None trains
    without dropout."""

    def __init__(self, gpt: Params, vit: Params, cfg: dict, mm=ref_gpt.plain_matmul,
                 rows_per_block: int = 4, drop_seed: Optional[int] = None):
        self.g, self.a, self.opt, self.cond = cfg["gpt"], cfg["adapter"], cfg["train"], cfg["canny"]
        self.params = {**{"gpt." + k: v for k, v in gpt.items()},
                       **{"adapter." + k: v for k, v in vit.items()}}
        for k, v in self.params.items():
            v.requires_grad_(k[len("gpt."):] not in ref_gpt.FROZEN)
        self.m = {k: torch.zeros_like(v) for k, v in self.params.items()}
        self.v = {k: torch.zeros_like(v) for k, v in self.params.items()}
        self.t = 0
        self.mm, self.rows, self.drop_seed = mm, rows_per_block, drop_seed

    def _decayed(self, key: str) -> bool:
        if key.startswith("gpt."):
            return ref_gpt.decayed(key[4:])
        return ref_vit.decayed(key[len("adapter."):])

    def loss_and_grads(self, batch: dict, rows=None):
        """-> (mean loss, gradients) over the batch's rows (all, or `rows`)."""
        tokens = batch["tokens"]
        idx = torch.arange(tokens.shape[0], device=tokens.device) if rows is None else rows
        count = idx.numel() * tokens.shape[1]
        gpt = {k[4:]: v for k, v in self.params.items() if k.startswith("gpt.")}
        vit = {k[8:]: v for k, v in self.params.items() if k.startswith("adapter.")}
        grads = {k: torch.zeros_like(v) for k, v in self.params.items()}
        dropped, b = None, tokens.shape[0]
        if self.drop_seed is not None:
            dropped = torch.rand(b, device=tokens.device, generator=keyed_generator(
                (self.drop_seed, self.t, 0), tokens.device)) < self.opt["class_dropout"]
        total = 0.0
        for blk in idx.split(self.rows):
            edges = ref_canny.canny(batch["control_image"][blk], self.cond["low"],
                                    self.cond["high"], self.cond["hysteresis_rings"])
            feats = ref_vit.forward(vit, self.a, ref_vit.condition_input(edges))
            kw = {}
            if self.g["model_type"] == "c2i":
                kw["labels"] = batch["labels"][blk]
            else:
                kw["caption"] = batch["caption_emb"][blk].float()
                kw["caption_mask"] = batch["emb_mask"][blk].bool()
            if dropped is not None:
                kw["dropped"] = dropped[blk]
                if self.opt["dropout"] > 0:
                    kw["drop"] = Dropout(self.drop_seed, self.t, self.opt["dropout"], b, blk)
            loss = ref_gpt.train_loss(gpt, self.g, tokens[blk], feats, mm=self.mm, **kw) / count
            trainable = [k for k, v in self.params.items() if v.requires_grad]
            got = torch.autograd.grad(loss, [self.params[k] for k in trainable], allow_unused=True)
            for k, gr in zip(trainable, got):
                if gr is not None:
                    grads[k] += gr
            total += float(loss.detach())
        return total, grads

    @torch.no_grad()
    def apply(self, grads: Params) -> Params:
        """One AdamW update in place; -> the clipped gradients."""
        o = self.opt
        norm = torch.sqrt(sum(gr.double().pow(2).sum() for gr in grads.values())).float()
        scale = torch.clamp(o["max_grad_norm"] / norm, max=1.0)
        self.t += 1
        bc1, bc2 = 1 - o["beta1"] ** self.t, 1 - o["beta2"] ** self.t
        clipped = {}
        for k, p in self.params.items():
            g = grads[k] * scale
            clipped[k] = g
            self.m[k].mul_(o["beta1"]).add_(g, alpha=1 - o["beta1"])
            self.v[k].mul_(o["beta2"]).addcmul_(g, g, value=1 - o["beta2"])
            u = (self.m[k] / bc1) / (torch.sqrt(self.v[k] / bc2) + o["eps"])
            if self._decayed(k):
                u = u + o["weight_decay"] * p
            p.sub_(o["lr"] * u)
        return clipped
