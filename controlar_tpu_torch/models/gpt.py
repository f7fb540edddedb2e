"""LlamaGen-style decoder with ControlAR control fusion.

The modules hold the parameters under the JAX package's names (one `Block`
per layer where the JAX package stacks layers on a leading axis); linears are
`nn.Linear` with torch's (out, in) weights. The functions mirror
`controlar_tpu/models/gpt.py`:

- control tokens are projected once by three per-fusion-point MLPs
  (`fusion_projections`) and added to the hidden state at the layers where
  `l % (n_layer // 3) == 0` (`_fusion_gates`);
- generated position p receives control token p - cls_token_num + 1.

The training subset (`forward_train`, the teacher-forced forward with the CE
loss) runs the layer stack as a Python loop whose layers are checkpointed
under the JAX package's remat policies (`REMAT_POLICIES`, through
`torch.utils.checkpoint`), with attention through the flash training kernels
(`ops/flash_train.py`) or the masked einsum. Dropout draws from generators
seeded per (step, layer, site) from the caller's key, so a recomputed layer
draws the same masks.
"""
from __future__ import annotations

import math
from typing import Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from controlar_tpu_torch.config import GPTConfig
from controlar_tpu_torch.ops.flash_train import checkpoint_name, flash_attention_train
from controlar_tpu_torch.ops.norms import rms_norm
from controlar_tpu_torch.ops.rope import apply_rope, precompute_rope_2d_rect
from controlar_tpu_torch.remat import checkpointed


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

    def forward(self, *args, **kwargs):
        """The training layer, `block_forward(self, ...)`."""
        return block_forward(self, *args, **kwargs)


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


# ---------------------------------------------------------------------------
# Training: the teacher-forced forward (JAX models/gpt.py:231-558)
# ---------------------------------------------------------------------------

def generator(key: Sequence[int], device) -> torch.Generator:
    """A generator on `device` seeded from an integer key, e.g. (seed,
    step, layer, site): the same key gives the same draws."""
    state = np.random.SeedSequence([int(x) for x in key]).generate_state(2, np.uint32)
    return torch.Generator(device=device).manual_seed(int(state[0]) << 31 | int(state[1]) >> 1)


def _dropout(key: Sequence[int], p: float, x: torch.Tensor) -> torch.Tensor:
    """Keep each element with probability 1 - p, scaled by 1 / (1 - p)."""
    keep = torch.rand(x.shape, generator=generator(key, x.device), device=x.device) < 1.0 - p
    return torch.where(keep, x / (1.0 - p), torch.zeros_like(x))


def _drop_path(key: Sequence[int], p: float, branch: torch.Tensor) -> torch.Tensor:
    """Stochastic depth: zero a sample's whole residual branch with
    probability p, scale the survivors by 1 / (1 - p)."""
    shape = (branch.shape[0],) + (1,) * (branch.dim() - 1)
    keep = torch.rand(shape, generator=generator(key, branch.device),
                      device=branch.device) < 1.0 - p
    return torch.where(keep, branch / (1.0 - p), torch.zeros_like(branch))


def _repeat_kv(cfg: GPTConfig, k: torch.Tensor, v: torch.Tensor):
    if cfg.kv_heads != cfg.n_head:
        rep = cfg.n_head // cfg.kv_heads
        k, v = k.repeat_interleave(rep, dim=2), v.repeat_interleave(rep, dim=2)
    return k, v


def _attend_full(cfg: GPTConfig, q, k, v, mask: Optional[torch.Tensor]) -> torch.Tensor:
    """Materialised scores (the parity path): mask a boolean (B, 1, T, T),
    or None for causal."""
    k, v = _repeat_kv(cfg, k, v)
    if mask is None:
        t = q.shape[1]
        mask = torch.ones(t, t, dtype=torch.bool, device=q.device).tril()
    return attend_masked(q, k, v, mask)


def _attend_blockwise(cfg: GPTConfig, q, k, v, key_valid: Optional[torch.Tensor]) -> torch.Tensor:
    """Flash training attention: causal plus the key_valid column mask, no
    diagonal exception (`ops/flash_train.py`)."""
    b, t, nh, hd = q.shape
    k, v = _repeat_kv(cfg, k, v)
    if key_valid is not None:
        key_valid = key_valid[:, :t]  # callers may pass the unsliced column mask
    return flash_attention_train(q, k, v, key_valid).reshape(b, t, nh * hd)


def block_forward(
    lp: Block,
    cfg: GPTConfig,
    h: torch.Tensor,
    rope: torch.Tensor,
    mask: Optional[torch.Tensor] = None,
    key_valid: Optional[torch.Tensor] = None,
    attn_impl: str = "einsum",
    drop_key: Optional[Sequence[int]] = None,
    drop_path_p: float = 0.0,
    name_qkv: bool = False,
) -> torch.Tensor:
    """One pre-norm block in its training form. With drop_key, residual and
    FFN dropout at the config rates and stochastic depth at drop_path_p.
    name_qkv names the rotated q, k, v for the "qkv" remat policies."""
    x = rms_norm(h, lp.attention_norm, cfg.norm_eps)
    q, k, v = _qkv(lp, cfg, x, rope)
    if name_qkv:
        q, k, v = (checkpoint_name(t, "qkv") for t in (q, k, v))
    if attn_impl == "blockwise":
        attn = _attend_blockwise(cfg, q, k, v, key_valid)
    else:
        attn = _attend_full(cfg, q, k, v, mask)
    attn_out = lp.wo(attn)
    if drop_key is not None and cfg.resid_dropout_p > 0:
        attn_out = _dropout((*drop_key, 1), cfg.resid_dropout_p, attn_out)
    if drop_key is not None and cfg.drop_path_rate > 0:
        attn_out = _drop_path((*drop_key, 3), drop_path_p, attn_out)
    h = h + attn_out
    x = rms_norm(h, lp.ffn_norm, cfg.norm_eps)
    ffn = lp.w2(F.silu(lp.w1(x)) * lp.w3(x))
    if drop_key is not None and cfg.ffn_dropout_p > 0:
        ffn = _dropout((*drop_key, 2), cfg.ffn_dropout_p, ffn)
    if drop_key is not None and cfg.drop_path_rate > 0:
        ffn = _drop_path((*drop_key, 4), drop_path_p, ffn)
    return h + ffn


def _run_layers(model: GPT, cfg: GPTConfig, h: torch.Tensor, rope: torch.Tensor,
                mask: Optional[torch.Tensor], fused3: Optional[torch.Tensor], fuse_fn,
                drop_key: Optional[Sequence[int]], remat: str,
                key_valid: Optional[torch.Tensor], attn_impl: str) -> torch.Tensor:
    """The layer stack (the JAX package's `_scan_layers`): control fusion at
    the gated layers, then each block under the remat policy, with its
    dropout key (drop_key, layer) and the linear stochastic-depth rate."""
    gate, idx = _fusion_gates(cfg)
    name_qkv = remat in ("qkv", "qkv_attn")
    for l, lp in enumerate(model.layers):
        if fused3 is not None and gate[l] > 0:
            h = fuse_fn(h, fused3[int(idx[l])])
        key = None if drop_key is None else (*drop_key, l)
        dp = cfg.drop_path_rate * l / max(cfg.n_layer - 1, 1)
        h = checkpointed(lp, remat, cfg, h, rope, mask, key_valid, attn_impl, key, dp, name_qkv)
    return h


def _logits(model: GPT, cfg: GPTConfig, h: torch.Tensor) -> torch.Tensor:
    return model.output(rms_norm(h, model.norm, cfg.norm_eps)).float()


def forward_train(
    model: GPT,
    cfg: GPTConfig,
    prefix_emb: torch.Tensor,
    idx: torch.Tensor,
    cond_tokens: Optional[torch.Tensor] = None,
    mask: Optional[torch.Tensor] = None,
    targets: Optional[torch.Tensor] = None,
    valid: Optional[torch.Tensor] = None,
    rng: Optional[Sequence[int]] = None,
    deterministic: bool = True,
    remat_policy: str = "full",
    key_valid: Optional[torch.Tensor] = None,
    attn_impl: Optional[str] = None,
) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """Teacher-forced forward -> (logits (B, block_size, vocab) f32, loss).

    prefix_emb (B, cls_token_num, dim) embedded class or caption prefix; idx
    (B, block_size - 1) image tokens (tokens[:, :-1]); cond_tokens (B, T_img,
    dim) from `control_tokens`; mask an optional boolean (B, 1, T, T)
    attention mask (einsum only); key_valid an optional (B, T) column mask,
    causal & (key_valid | diagonal) on the einsum path and the flash
    kernels' mask on the blockwise path; attn_impl "blockwise", "einsum" or
    None (einsum with an explicit mask, else blockwise); targets (B,
    block_size) for the CE loss, valid (B,) a 0/1 sample weight. With
    deterministic=False and an integer key `rng`, token, residual and FFN
    dropout at the config rates, and the remat policy.
    """
    h = torch.cat([prefix_emb, model.tok_embeddings(idx)], dim=1)
    t = h.shape[1]
    if not deterministic and cfg.token_dropout_p > 0 and rng is not None:
        h = _dropout((*rng, 0), cfg.token_dropout_p, h)
    if attn_impl is None:
        attn_impl = "einsum" if mask is not None else "blockwise"
    if attn_impl == "blockwise" and mask is not None:
        raise ValueError("attn_impl='blockwise' expresses masks via key_valid (B, T); "
                         "pass key_valid instead of a materialized mask")
    if attn_impl == "einsum" and mask is None and key_valid is not None:
        causal = torch.ones(t, t, dtype=torch.bool, device=h.device).tril()
        eye = torch.eye(t, dtype=torch.bool, device=h.device)
        mask = (causal[None] & (key_valid[:, None, :t].bool() | eye[None]))[:, None]
    rope = make_rope_table(cfg)[:t].to(h.device)
    cls = cfg.cls_token_num

    def fuse_train(hh, fused_j):
        # control tokens on every position that predicts an image token
        body = hh[:, cls - 1:] + fused_j[:, : hh.shape[1] - (cls - 1)].to(hh.dtype)
        return torch.cat([hh[:, : cls - 1], body], dim=1)

    fused3 = fusion_projections(model, cond_tokens) if cond_tokens is not None else None
    training = not deterministic
    layer_key = (*rng, 1) if training and rng is not None else None
    h = _run_layers(model, cfg, h, rope, mask, fused3, fuse_train, layer_key,
                    remat_policy if training else "none", key_valid, attn_impl)
    logits = _logits(model, cfg, h)[:, cls - 1:]
    loss = None
    if targets is not None:
        nll = -torch.log_softmax(logits, dim=-1).gather(-1, targets[..., None].long())[..., 0]
        if valid is not None:
            w = valid[:, None].float() * torch.ones_like(nll)
            loss = (nll * w).sum() / torch.clamp(w.sum(), min=1.0)
        else:
            loss = nll.mean()
    return logits, loss
