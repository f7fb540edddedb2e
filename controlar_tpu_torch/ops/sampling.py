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

The serving engine draws through `sample_keyed` instead: its Gumbel noise is
a counter-based integer hash of (request seed, token index, vocab index), so
token k of a request does not depend on the batch or schedule it rides in.
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


_MASK32 = 0xFFFFFFFF


def _mul32(x: torch.Tensor, c: int) -> torch.Tensor:
    """(x * c) mod 2**32 for int64 x in [0, 2**32), in 16-bit halves of c so
    no intermediate leaves int64: x * c_lo < 2**48, x * c_hi < 2**48."""
    lo = x * (c & 0xFFFF)
    hi = ((x * (c >> 16)) & 0xFFFF) << 16
    return (lo + hi) & _MASK32


def _mix32(x: torch.Tensor) -> torch.Tensor:
    """A 32-bit integer hash (the two-multiply xorshift finaliser
    `lowbias32`) on int64 tensors holding values in [0, 2**32)."""
    x = x ^ (x >> 16)
    x = _mul32(x, 0x7FEB352D)
    x = x ^ (x >> 15)
    x = _mul32(x, 0x846CA68B)
    return x ^ (x >> 16)


def keyed_uniforms(seeds: torch.Tensor, tok_idx: torch.Tensor, vocab: int) -> torch.Tensor:
    """(K, vocab) float32 uniforms in (0, 1), a pure function of (seed[i],
    tok_idx[i], vocab index): counter-based, computed for all rows at once
    with int64 ops, so the CPU and the card give the same numbers."""
    dev = seeds.device
    row = _mix32(_mix32(seeds.long() & _MASK32) ^ (tok_idx.long() & _MASK32))[:, None]
    col = torch.arange(vocab, device=dev, dtype=torch.int64)[None, :]
    bits = _mix32(_mix32(row ^ col) ^ row)
    # 23 bits and a half-step offset: exact in float32, never 0 or 1
    return (((bits >> 9).double() + 0.5) / float(1 << 23)).float()


def sample_keyed(
    logits: torch.Tensor,
    seeds: torch.Tensor,
    tok_idx: torch.Tensor,
    temperature: float = 1.0,
    top_k: int = 0,
    top_p: float = 1.0,
    greedy: bool = False,
) -> torch.Tensor:
    """Per-request reproducible sampling: (K, V) logits, seeds (K,) and the
    index of the token being drawn (K,) -> (K,) int64 tokens. Token k of a
    request is always drawn from the same noise, so a request's tokens do
    not depend on which slot or batch it rides in (the JAX engine's
    fold_in(PRNGKey(seed), k)); the streams differ from the JAX package's.
    Temperature and top-k/top-p as in `sample_from`; greedy takes the
    argmax."""
    lg = logits.float() / max(temperature, 1e-5)
    if top_k > 0 or top_p < 1.0:
        lg = top_k_top_p_filter(lg, top_k=top_k, top_p=top_p)
    if greedy:
        return torch.argmax(lg, dim=-1)
    u = keyed_uniforms(seeds, tok_idx, lg.shape[-1])
    return torch.argmax(lg - torch.log(-torch.log(u)), dim=-1)
