"""Token sampling: temperature, top-k, top-p, greedy or categorical.

- logits /= max(temperature, 1e-5);
- top-k keeps every logit >= the k-th largest (exact), others -> -inf;
- top-p sorts descending and keeps tokens until the cumulative softmax
  probability exceeds top_p; the first token that crosses it is kept (the
  shift-right rule);
- sampling draws from the softmax with the Gumbel-max trick on uniforms
  from an explicit `torch.Generator`, or takes the argmax when greedy.

`torch.Generator` and `jax.random` give different streams from one seed, so
sampled tokens differ from the JAX package's at equal seeds; greedy tokens
are comparable.
"""
from __future__ import annotations

from typing import Optional

import torch


def top_k_top_p_filter(
    logits: torch.Tensor, top_k: int = 0, top_p: float = 1.0
) -> torch.Tensor:
    """Mask logits outside top-k / nucleus top-p to -inf. logits: (..., V)."""
    if top_k > 0:
        k = min(max(top_k, 1), logits.shape[-1])
        kth = torch.topk(logits, k, dim=-1).values[..., -1:]
        logits = logits.masked_fill(logits < kth, float("-inf"))
    if top_p < 1.0:
        sorted_logits = torch.sort(logits, dim=-1, descending=True).values
        cdf = torch.cumsum(torch.softmax(sorted_logits, dim=-1), dim=-1)
        remove = cdf > top_p
        remove = torch.cat([torch.zeros_like(remove[..., :1]), remove[..., :-1]], dim=-1)
        min_keep = sorted_logits.masked_fill(remove, float("inf")).amin(-1, keepdim=True)
        logits = logits.masked_fill(logits < min_keep, float("-inf"))
    return logits


def sample_from(
    logits: torch.Tensor,
    generator: Optional[torch.Generator],
    temperature: float = 1.0,
    top_k: int = 0,
    top_p: float = 1.0,
    sample_logits: bool = True,
) -> torch.Tensor:
    """(B, V) logits -> (B,) int64 tokens."""
    logits = logits.float() / max(temperature, 1e-5)
    if top_k > 0 or top_p < 1.0:
        logits = top_k_top_p_filter(logits, top_k=top_k, top_p=top_p)
    if sample_logits:
        u = torch.rand(logits.shape, generator=generator, device=logits.device)
        # Gumbel-max: argmax(logits + G) with G = -log(-log(u)); u in [0, 1)
        return torch.argmax(logits - torch.log(-torch.log(u)), dim=-1)
    return torch.argmax(logits, dim=-1)
