"""T5 encoder (flan-t5-xl): the t2i text encoder, as the JAX package's
`models/t5.py` computes it (captions -> (B, 120, 2048) features).

- The layer norm is T5's RMS norm (no mean, no bias), computed in fp32 and
  cast to the input's dtype before the weight multiplies it; eps 1e-6.
- Attention has no 1/sqrt(d) scaling and no biases on q, k, v, o. Its
  relative position bias (32 buckets, max distance 128, bidirectional) is
  read from layer 0's table and shared by every layer.
- The padding mask is additive: -1e9 on masked columns, added in fp32 to
  the fp32 scores, so a row whose mask is all zeros stays finite.
- The residual stream keeps the parameters' dtype; the probabilities are
  cast to it before P.V, which accumulates in fp32.
- The FFN is flan's gated one: gelu_tanh(x Wi0) * (x Wi1) -> Wo.

Attention is a masked matmul and softmax, as in the JAX package (an einsum
there, outside any Pallas kernel).
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from controlar_tpu_torch import resolve_device
from controlar_tpu_torch.ops.norms import rms_norm


@dataclasses.dataclass(frozen=True)
class T5Config:
    vocab_size: int = 32128
    d_model: int = 2048
    d_kv: int = 64
    d_ff: int = 5120
    n_layer: int = 24
    n_head: int = 32
    rel_buckets: int = 32
    rel_max_distance: int = 128
    layer_norm_eps: float = 1e-6


T5_XL = T5Config()


def _linear(cin: int, cout: int) -> nn.Linear:
    return nn.Linear(cin, cout, bias=False)


class T5Layer(nn.Module):
    def __init__(self, cfg: T5Config):
        super().__init__()
        d, inner, dff = cfg.d_model, cfg.n_head * cfg.d_kv, cfg.d_ff
        self.ln1 = nn.Parameter(torch.empty(d))
        self.q, self.k, self.v = _linear(d, inner), _linear(d, inner), _linear(d, inner)
        self.o = _linear(inner, d)
        self.ln2 = nn.Parameter(torch.empty(d))
        self.wi0, self.wi1 = _linear(d, dff), _linear(d, dff)
        self.wo = _linear(dff, d)

    def forward(self, cfg: T5Config, h: torch.Tensor, bias: torch.Tensor) -> torch.Tensor:
        b, t, _ = h.shape
        nh, dk = cfg.n_head, cfg.d_kv
        x = rms_norm(h, self.ln1, cfg.layer_norm_eps)
        q = self.q(x).reshape(b, t, nh, dk).transpose(1, 2)
        k = self.k(x).reshape(b, t, nh, dk).transpose(1, 2)
        v = self.v(x).reshape(b, t, nh, dk).transpose(1, 2)
        scores = q.float() @ k.float().transpose(-1, -2) + bias  # no 1/sqrt(d) in T5
        probs = torch.softmax(scores, dim=-1).to(x.dtype)
        attn = (probs.float() @ v.float()).to(x.dtype)
        h = h + self.o(attn.transpose(1, 2).reshape(b, t, nh * dk))
        x = rms_norm(h, self.ln2, cfg.layer_norm_eps)
        g = F.gelu(self.wi0(x), approximate="tanh")
        return h + self.wo(g * self.wi1(x))


class T5Encoder(nn.Module):
    """The encoder stack; `forward(input_ids, attn_mask)` is `t5_encode`."""

    def __init__(self, cfg: T5Config = T5_XL):
        super().__init__()
        self.cfg = cfg
        self.embedding = nn.Embedding(cfg.vocab_size, cfg.d_model)
        self.rel_bias = nn.Parameter(torch.empty(cfg.rel_buckets, cfg.n_head))
        self.layers = nn.ModuleList(T5Layer(cfg) for _ in range(cfg.n_layer))
        self.final_ln = nn.Parameter(torch.empty(cfg.d_model))

    def forward(self, input_ids: torch.Tensor, attn_mask: torch.Tensor) -> torch.Tensor:
        return t5_encode(self, self.cfg, input_ids, attn_mask)


def relative_position_bucket(rel_pos: np.ndarray, num_buckets: int,
                             max_distance: int) -> np.ndarray:
    """HF T5's bidirectional bucketing, on the host as the JAX package
    computes it."""
    nb = num_buckets // 2
    ret = (rel_pos > 0).astype(np.int64) * nb
    n = np.abs(rel_pos)
    max_exact = nb // 2
    is_small = n < max_exact
    large = max_exact + (
        np.log(n.clip(1) / max_exact) / np.log(max_distance / max_exact) * (nb - max_exact)
    ).astype(np.int64)
    large = np.minimum(large, nb - 1)
    return ret + np.where(is_small, n, large)


def relative_bias(model: T5Encoder, cfg: T5Config, q_len: int, k_len: int) -> torch.Tensor:
    """(1, H, q_len, k_len) additive attention bias from layer 0's table."""
    buckets = relative_position_bucket(
        np.arange(k_len)[None, :] - np.arange(q_len)[:, None], cfg.rel_buckets,
        cfg.rel_max_distance)
    table = model.rel_bias  # (num_buckets, H)
    return table[torch.as_tensor(buckets, device=table.device)].permute(2, 0, 1)[None]


def t5_encode(model: T5Encoder, cfg: T5Config, input_ids: torch.Tensor,
              attn_mask: torch.Tensor) -> torch.Tensor:
    """input_ids (B, T) int, attn_mask (B, T) {0, 1} -> (B, T, d_model) in
    the parameters' dtype."""
    dev = model.rel_bias.device
    input_ids = torch.as_tensor(input_ids, device=dev).long()
    attn_mask = torch.as_tensor(attn_mask, device=dev)
    t = input_ids.shape[1]
    h = model.embedding(input_ids)
    mask_bias = torch.where(attn_mask[:, None, None, :] > 0, 0.0, -1e9).float()
    bias = relative_bias(model, cfg, t, t).float() + mask_bias
    for layer in model.layers:
        h = layer(cfg, h, bias)
    return rms_norm(h, model.final_ln, cfg.layer_norm_eps)


def init_t5(cfg: T5Config = T5_XL, seed: int = 0, dtype: torch.dtype = torch.float32,
            device="cuda") -> T5Encoder:
    """Random weights with the JAX package's init distribution: every matrix
    and the bias table normal(0, 0.02), the norms one. Drawn in fp32 from a
    torch.Generator seeded with `seed` on `device` (a seed gives other
    weights on the card than on the CPU), in module order, then cast."""
    device = resolve_device(device)
    with torch.device("meta"):
        model = T5Encoder(cfg)
    model = model.to(dtype).to_empty(device=device)
    gen = torch.Generator(device=device).manual_seed(seed)
    with torch.no_grad():
        for name, p in model.named_parameters():
            if name.rsplit(".", 1)[-1] in ("ln1", "ln2", "final_ln"):
                p.fill_(1.0)
            else:
                p.copy_(torch.randn(p.shape, generator=gen, device=device) * 0.02)
    return model.eval().requires_grad_(False)
