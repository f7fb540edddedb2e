"""LlamaGen-style decoder with ControlAR control fusion: the inference subset.

The modules hold the parameters under the JAX package's names (one `Block`
per layer where the JAX package stacks layers on a leading axis); linears are
`nn.Linear` with torch's (out, in) weights. The functions mirror
`controlar_tpu/models/gpt.py`:

- control tokens are projected once by three per-fusion-point MLPs
  (`fusion_projections`) and added to the hidden state at the layers where
  `l % (n_layer // 3) == 0` (`_fusion_gates`);
- generated position p receives control token p - cls_token_num + 1.
"""
from __future__ import annotations

import math
from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from controlar_tpu_torch.config import GPTConfig
from controlar_tpu_torch.ops.rope import apply_rope, precompute_rope_2d_rect


class MLP(nn.Module):
    """Bias-free two-layer MLP with tanh-GELU."""

    def __init__(self, d_in: int, d_hidden: int, d_out: int):
        super().__init__()
        self.fc1 = nn.Linear(d_in, d_hidden, bias=False)
        self.fc2 = nn.Linear(d_hidden, d_out, bias=False)


class LabelEmbedder(nn.Module):
    def __init__(self, num_classes: int, dim: int):
        super().__init__()
        # the extra row is the CFG null class
        self.embedding = nn.Embedding(num_classes + 1, dim)


class CaptionEmbedder(MLP):
    """Caption MLP plus the learned unconditional caption for CFG."""

    def __init__(self, caption_dim: int, dim: int, token_num: int):
        super().__init__(caption_dim, dim, dim)
        self.uncond_embedding = nn.Parameter(torch.empty(token_num, caption_dim))


class Block(nn.Module):
    def __init__(self, cfg: GPTConfig):
        super().__init__()
        d, hd = cfg.dim, cfg.head_dim
        self.attention_norm = nn.Parameter(torch.empty(d))
        self.ffn_norm = nn.Parameter(torch.empty(d))
        self.wqkv = nn.Linear(d, (cfg.n_head + 2 * cfg.kv_heads) * hd, bias=False)
        self.wo = nn.Linear(d, d, bias=False)
        self.w1 = nn.Linear(d, cfg.ffn_hidden_dim, bias=False)
        self.w3 = nn.Linear(d, cfg.ffn_hidden_dim, bias=False)
        self.w2 = nn.Linear(cfg.ffn_hidden_dim, d, bias=False)


class GPT(nn.Module):
    def __init__(self, cfg: GPTConfig):
        super().__init__()
        d = cfg.dim
        self.tok_embeddings = nn.Embedding(cfg.vocab_size, d)
        if cfg.model_type == "c2i":
            self.cls_embedding = LabelEmbedder(cfg.num_classes, d)
        else:
            self.cls_embedding = CaptionEmbedder(cfg.caption_dim, d, cfg.cls_token_num)
        self.adapter_mlp = MLP(cfg.adapter_dim, d, d)
        self.condition_mlp = MLP(d, d, d)
        self.condition_layers = nn.ModuleList(
            MLP(d, d, d) for _ in range(cfg.n_fusion_points))
        self.layers = nn.ModuleList(Block(cfg) for _ in range(cfg.n_layer))
        self.norm = nn.Parameter(torch.empty(d))
        self.output = nn.Linear(d, cfg.vocab_size, bias=False)


def param_dtype(module: nn.Module) -> torch.dtype:
    return next(module.parameters()).dtype


def init_gpt(cfg: GPTConfig, seed: int = 0, dtype: torch.dtype = torch.float32,
             device="cpu") -> GPT:
    """Random weights with the JAX package's init distribution: normal(0,
    initializer_range) for every linear and embedding (the control MLPs
    included), ones for the norms, the t2i output head zero and the c2i head
    normal, the unconditional caption randn / sqrt(caption_dim)."""
    device = torch.device(device)
    with torch.device("meta"):
        model = GPT(cfg).to(dtype)
    model = model.to_empty(device=device)
    gen = torch.Generator(device=device).manual_seed(seed)
    with torch.no_grad():
        for name, p in model.named_parameters():
            if name.endswith("_norm") or name == "norm":
                p.fill_(1.0)
            elif name == "output.weight" and cfg.model_type == "t2i":
                p.zero_()
            else:
                std = (cfg.caption_dim ** -0.5 if name.endswith("uncond_embedding")
                       else cfg.initializer_range)
                p.copy_(torch.randn(p.shape, generator=gen, device=device) * std)
    return model.eval().requires_grad_(False)


def make_rope_table(cfg: GPTConfig) -> torch.Tensor:
    """(cls_token_num + block_size, head_dim // 2, 2) fp32 cos/sin table for
    the configuration's token grid."""
    gh, gw = cfg.grid
    return precompute_rope_2d_rect(gh, gw, cfg.head_dim, cfg.rope_base, cfg.cls_token_num)


def mlp_gelu(p: MLP, x: torch.Tensor) -> torch.Tensor:
    """Bias-free MLP with tanh-GELU."""
    return p.fc2(F.gelu(p.fc1(x), approximate="tanh"))


def embed_prefix_c2i(model: GPT, labels: torch.Tensor) -> torch.Tensor:
    """Class labels (B,) -> (B, 1, dim)."""
    return model.cls_embedding.embedding(labels)[:, None, :]


def embed_prefix_t2i(model: GPT, caption_emb: torch.Tensor) -> torch.Tensor:
    """Caption features (B, T_cls, caption_dim) -> (B, T_cls, dim)."""
    return mlp_gelu(model.cls_embedding, caption_emb)


def control_tokens(
    model: GPT,
    cfg: GPTConfig,
    adapter_features: torch.Tensor,
    drop_ids: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Adapter features (B, T_img, adapter_dim) -> control tokens (B, T_img, dim).
    Dropped rows feed zeros to the condition MLP (the unconditional control)."""
    x = mlp_gelu(model.adapter_mlp, adapter_features)
    if drop_ids is not None:
        x = torch.where(drop_ids[:, None, None], torch.zeros_like(x), x)
    return mlp_gelu(model.condition_mlp, x)


def fusion_projections(model: GPT, cond_tokens: torch.Tensor) -> torch.Tensor:
    """The per-fusion-point MLPs -> (n_fusion_points, B, T, dim)."""
    return torch.stack([mlp_gelu(m, cond_tokens) for m in model.condition_layers])


def _fusion_gates(cfg: GPTConfig) -> Tuple[np.ndarray, np.ndarray]:
    """Per-layer (gate, projection index) for control fusion."""
    interval = cfg.layer_interval
    ids = np.arange(cfg.n_layer)
    gate = (ids % interval == 0).astype(np.float32)
    idx = np.minimum(ids // interval, cfg.n_fusion_points - 1).astype(np.int32)
    return gate, idx


def _qkv(lp: Block, cfg: GPTConfig, x: torch.Tensor, rope_slice: torch.Tensor):
    """Project and rotate. x: (B, T, dim) -> q (B,T,H,D), k/v (B,T,KV,D)."""
    b, t, _ = x.shape
    nh, nkv, hd = cfg.n_head, cfg.kv_heads, cfg.head_dim
    q, k, v = torch.split(lp.wqkv(x), [nh * hd, nkv * hd, nkv * hd], dim=-1)
    q = apply_rope(q.reshape(b, t, nh, hd), rope_slice)
    k = apply_rope(k.reshape(b, t, nkv, hd), rope_slice)
    return q, k, v.reshape(b, t, nkv, hd)


def attend_masked(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  mask: torch.Tensor) -> torch.Tensor:
    """Masked attention with materialised scores: q (B,T,H,D), k/v (B,S,H,D),
    boolean mask broadcastable to (B,H,T,S). fp32 scores and softmax; the
    probabilities are rounded to q's dtype before the value product, as in
    the JAX package. Returns (B, T, H*D) in q's dtype."""
    b, t, nh, hd = q.shape
    scores = torch.einsum("bthd,bshd->bhts", q.float(), k.float()) * (1.0 / math.sqrt(hd))
    scores = scores.masked_fill(~mask, float("-inf"))
    probs = torch.softmax(scores, dim=-1).to(q.dtype)
    out = torch.einsum("bhts,bshd->bthd", probs.float(), v.float())
    return out.to(q.dtype).reshape(b, t, nh * hd)
