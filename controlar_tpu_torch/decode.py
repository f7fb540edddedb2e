"""Decode engine: per-layer flat KV caches and the flash-decode kernel.

Each layer's cache is one (B, S, 2*H*D) tensor of interleaved [k | v] rows,
the JAX package's layout, so the kernel reads a row's k and v from one slab.
Unlike the JAX package, which returns new cache arrays, the port writes the
new rows into the cache tensors in place and returns the same list.

Decode attention runs `ops.flash_decode.flash_decode_attention` when
`use_flash` (on the card: the CUDA kernel, reading only rows <= pos), else a
masked einsum over the whole slab.
"""
from __future__ import annotations

from typing import List, Optional, Tuple

import torch

from controlar_tpu_torch.config import GPTConfig
from controlar_tpu_torch.models.gpt import (
    GPT,
    _fusion_gates,
    _qkv,
    attend_masked,
    make_rope_table,
)
from controlar_tpu_torch.ops.flash_decode import flash_decode_attention
from controlar_tpu_torch.ops.norms import rms_norm

Caches = List[torch.Tensor]


def init_flat_caches(cfg: GPTConfig, batch: int, max_seq: int,
                     dtype: torch.dtype = torch.bfloat16, device="cpu") -> Caches:
    """One zeroed (batch, max_seq, 2*KV*D) cache per layer. Only floating
    caches are ported; the int8 and int4 caches are not."""
    if not dtype.is_floating_point:
        raise NotImplementedError(f"quantized KV cache {dtype} is not ported")
    shape = (batch, max_seq, 2 * cfg.kv_heads * cfg.head_dim)
    return [torch.zeros(shape, dtype=dtype, device=device) for _ in range(cfg.n_layer)]


def ffn(lp, x: torch.Tensor) -> torch.Tensor:
    """SwiGLU FFN."""
    return lp.w2(torch.nn.functional.silu(lp.w1(x)) * lp.w3(x))


def _logits(model: GPT, cfg: GPTConfig, h: torch.Tensor) -> torch.Tensor:
    return model.output(rms_norm(h, model.norm, cfg.norm_eps)).float()


def _fuse(fused3_l: torch.Tensor, control_strength, dtype: torch.dtype) -> torch.Tensor:
    return (control_strength * fused3_l.float()).to(dtype)


def prefill_flat(
    model: GPT,
    cfg: GPTConfig,
    caches: Caches,
    prefix_emb: torch.Tensor,
    fused3: Optional[torch.Tensor],
    col_mask: Optional[torch.Tensor],
    control_strength=1.0,
    rope_table: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, Caches]:
    """Prefill the prefix; returns (last-position logits (B, V) f32, caches).

    Only the last prefix position receives control token 0. With a column
    mask, a position sees the columns that are causal AND (unmasked OR its
    own), so fully masked padding rows still attend to themselves."""
    b, t, _ = prefix_emb.shape
    dev = prefix_emb.device
    gate, fidx = _fusion_gates(cfg)
    if rope_table is None:
        rope_table = make_rope_table(cfg).to(dev)
    rope = rope_table[:t]
    rows = torch.arange(t, device=dev)[:, None]
    cols = torch.arange(t, device=dev)[None, :]
    causal = rows >= cols
    if col_mask is not None:
        m = causal[None] & (col_mask[:, None, :] | (rows == cols)[None])
    else:
        m = causal[None]
    mask = m[:, None]  # (B|1, 1, T, T)

    hd = cfg.n_head * cfg.head_dim
    h = prefix_emb
    for l, lp in enumerate(model.layers):
        if fused3 is not None and gate[l] > 0:
            add = _fuse(fused3[fidx[l]][:, 0:1], control_strength, h.dtype)
            h = torch.cat([h[:, :-1], h[:, -1:] + add], dim=1)
        x = rms_norm(h, lp.attention_norm, cfg.norm_eps)
        q, k, v = _qkv(lp, cfg, x, rope)
        caches[l][:, :t] = torch.cat([k.reshape(b, t, hd), v.reshape(b, t, hd)], dim=-1)
        h = h + lp.wo(attend_masked(q, k, v, mask))
        h = h + ffn(lp, rms_norm(h, lp.ffn_norm, cfg.norm_eps))
    return _logits(model, cfg, h[:, -1]), caches


def decode_step_flat(
    model: GPT,
    cfg: GPTConfig,
    caches: Caches,
    token: torch.Tensor,
    pos: int,
    fused3: Optional[torch.Tensor],
    col_mask_full: Optional[torch.Tensor],
    control_strength=1.0,
    use_flash: bool = True,
    rope_table: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, Caches]:
    """One decode step at position pos for token (B,); returns (logits (B, V)
    f32, caches). Position pos receives control token pos - cls_token_num + 1."""
    b = token.shape[0]
    dev = token.device
    hd = cfg.n_head * cfg.head_dim
    gate, fidx = _fusion_gates(cfg)
    if rope_table is None:
        rope_table = make_rope_table(cfg).to(dev)
    rope = rope_table[pos:pos + 1]
    fuse_pos = pos - cfg.cls_token_num + 1

    s_max = caches[0].shape[1]
    col_bias = None
    if use_flash:
        if col_mask_full is not None:
            col_bias = torch.where(col_mask_full, 0.0, -1e9).float()
    else:
        allowed = torch.arange(s_max, device=dev)[None, :] <= pos
        if col_mask_full is not None:
            allowed = allowed & col_mask_full
        mask = allowed[:, None, None, :]

    h = model.tok_embeddings(token)[:, None, :]
    for l, lp in enumerate(model.layers):
        if fused3 is not None and gate[l] > 0:
            h = h + _fuse(fused3[fidx[l]][:, fuse_pos:fuse_pos + 1], control_strength, h.dtype)
        x = rms_norm(h, lp.attention_norm, cfg.norm_eps)
        q, k, v = _qkv(lp, cfg, x, rope)  # (B, 1, H, D)
        cache = caches[l]
        cache[:, pos] = torch.cat([k.reshape(b, hd), v.reshape(b, hd)], dim=-1)
        if use_flash:
            attn = flash_decode_attention(
                q.reshape(b, hd), cache, pos, col_bias, n_head=cfg.n_head
            ).to(h.dtype)[:, None, :]
        else:
            kl = cache[:, :, :hd].reshape(b, s_max, cfg.kv_heads, cfg.head_dim)
            vl = cache[:, :, hd:].reshape(b, s_max, cfg.kv_heads, cfg.head_dim)
            attn = attend_masked(q, kl, vl, mask)
        h = h + lp.wo(attn)
        h = h + ffn(lp, rms_norm(h, lp.ffn_norm, cfg.norm_eps))
    return _logits(model, cfg, h[:, -1]), caches
