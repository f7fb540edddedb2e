"""Weight-only (W8A16, W4A16) and KV-cache (int8, int4) quantization.

The port's copy of the JAX package's `quant.py`. A quantized weight is a
module in place of the `nn.Linear` it replaces, so `lp.wqkv(x)` stays the
call site:

- `W8Linear`: q int8 (in, out) and s f32 (1, out), per output channel;
  x @ q runs in fp32 and the scale multiplies the fp32 product (plain
  PyTorch: the JAX package has no kernel for W8A16 either);
- `W4Linear`: int4 group-128 carriers q4 (Kp/2, N) and scales s (Kp/128, N)
  (`ops/w4_matmul.py` layout). On the card, at most 256 rows run the
  `w4_matmul` kernel; more rows, and every CPU call, take the JAX package's
  own fallback: dequantize to bf16, then one matmul.

Both keep the JAX package's (in, out) layout, so converted carriers are the
JAX package's bytes. `quantize_gpt` swaps a model's modules in place, layer
by layer, so no second full-precision copy is held. The split-rope layout
(`to_split_rope`) is recorded on the model as the `rope_split` buffer, the
counterpart of the JAX tree's marker leaf; decode branches on `is_split`.
Cast a model to its working dtype before quantizing it: `.to(dtype)` would
cast the f32 scales too.
"""
from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np
import torch
from torch import nn

from controlar_tpu_torch.config import GPTConfig
from controlar_tpu_torch.ops.w4_matmul import (
    MAX_ROWS,
    dequantize_weight_w4,
    pack_nibbles,
    quantize_weight_w4,
    unpack_nibbles,
    w4_matmul,
)

# the per-layer matmuls and the output head: nearly all of the bytes a
# decode step streams
LAYER_QUANT_KEYS = ("wqkv", "wo", "w1", "w3", "w2")
TOP_QUANT_KEYS = ("output",)


def quantize_weight(w: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Symmetric per-output-channel int8: w (..., in, out) -> (q int8,
    s (..., 1, out) f32) with s = max(amax / 127, 1e-12)."""
    w32 = w.float()
    s = torch.clamp(w32.abs().amax(dim=-2, keepdim=True) / 127.0, min=1e-12)
    q = torch.clamp(torch.round(w32 / s), -127, 127).to(torch.int8)
    return q.contiguous(), s.contiguous()


def dequantize_weight(q: torch.Tensor, s: torch.Tensor, dtype=torch.bfloat16) -> torch.Tensor:
    return (q.float() * s).to(dtype)


class W8Linear(nn.Module):
    """int8 weight (in, out) with per-output-channel f32 scales (1, out)."""

    def __init__(self, q: torch.Tensor, s: torch.Tensor):
        super().__init__()
        self.register_buffer("q", q)
        self.register_buffer("s", s)

    @classmethod
    def from_weight(cls, w_in_out: torch.Tensor) -> "W8Linear":
        return cls(*quantize_weight(w_in_out))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        # fp32 product (exact for bf16 x and int8 q), scaled, cast back
        return ((x.float() @ self.q.float()) * self.s).to(x.dtype)


class W4Linear(nn.Module):
    """int4 group-quantized weight: carriers q4 (Kp/2, N) int8, scales s
    (Kp/group, N) f32."""

    def __init__(self, q4: torch.Tensor, s: torch.Tensor):
        super().__init__()
        self.register_buffer("q4", q4)
        self.register_buffer("s", s)

    @classmethod
    def from_weight(cls, w_in_out: torch.Tensor) -> "W4Linear":
        return cls(*quantize_weight_w4(w_in_out))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        lead, k = x.shape[:-1], x.shape[-1]
        x2 = x.reshape(-1, k)
        if x2.is_cuda and x2.shape[0] <= MAX_ROWS:
            out = w4_matmul(x2, self.q4, self.s, out_dtype=x.dtype)
        else:
            wd = dequantize_weight_w4(self.q4, self.s, torch.bfloat16, k=k)
            out = (x2.float() @ wd.float()).to(x.dtype)
        return out.reshape(*lead, out.shape[-1])


def _in_out(m: nn.Module) -> torch.Tensor:
    """The (in, out) weight of a linear or W8 module (W8 dequantized to
    bf16, as the JAX package does before repacking to W4)."""
    if isinstance(m, W8Linear):
        return dequantize_weight(m.q, m.s)
    if isinstance(m, nn.Linear):
        return m.weight.T
    raise TypeError(f"cannot requantize {type(m).__name__}")


def split_head_perm(n_head: int, kv_heads: int, head_dim: int):
    """Column permutation taking interleaved head dims to split layout:
    within every head the dims reorder to [0, 2, .., D-2, 1, 3, .., D-1].
    Returns (qkv_perm over (H + 2 KV) * D columns, q_perm over H * D rows
    of wo). The permutation cancels in q.k and is undone by wo's permuted
    input rows, while RoPE becomes elementwise and the int4 pairs contiguous."""
    d = head_dim
    in_head = np.concatenate([np.arange(0, d, 2), np.arange(1, d, 2)])
    n = n_head + 2 * kv_heads
    qkv_perm = (np.arange(n)[:, None] * d + in_head[None, :]).reshape(-1)
    return qkv_perm, qkv_perm[: n_head * d]


def is_split(model: nn.Module) -> bool:
    """Whether the model's weights are in split-rope layout."""
    return hasattr(model, "rope_split")


def _permute_layer(lp: nn.Module, qkv_perm, q_perm) -> None:
    """wqkv output columns and wo input rows to split layout, in place."""
    for name, perm, out_axis in (("wqkv", qkv_perm, True), ("wo", q_perm, False)):
        m = getattr(lp, name)
        if isinstance(m, W4Linear):
            raise ValueError("to_split_rope must run before W4 packing")
        w8 = isinstance(m, W8Linear)
        idx = torch.as_tensor(perm, device=(m.q if w8 else m.weight).device)
        with torch.no_grad():
            if w8:  # q (in, out), s (1, out)
                if out_axis:
                    m.q, m.s = m.q[:, idx].contiguous(), m.s[:, idx].contiguous()
                else:
                    m.q = m.q[idx].contiguous()
            else:  # weight (out, in)
                m.weight.copy_(m.weight[idx] if out_axis else m.weight[:, idx])


def mark_split(model: nn.Module) -> None:
    """Record on the model that its weights are in split-rope layout."""
    model.register_buffer("rope_split", torch.zeros((), dtype=torch.int8,
                                                     device=model.norm.device))


def to_split_rope(model: nn.Module, cfg: GPTConfig) -> nn.Module:
    """Permute a float or W8 model to split-rope layout, in place, and mark
    it. A model already marked is returned as it is."""
    if is_split(model):
        return model
    perms = split_head_perm(cfg.n_head, cfg.kv_heads, cfg.head_dim)
    for lp in model.layers:
        _permute_layer(lp, *perms)
    mark_split(model)
    return model


def quantize_gpt(model: nn.Module, cfg: GPTConfig, mode: str = "int8",
                 keep: Sequence[str] = (), split_rope: bool = False) -> nn.Module:
    """Quantize a GPT's decode weights in place and return it.

    mode "int8" (the JAX package's `quantize_gpt_params`): wqkv, wo, w1, w3,
    w2 and the output head become W8Linear. mode "w4" (its
    `quantize_gpt_params_w4`): w1 and w3 fuse into one W4 `w13` = [w1 | w3],
    the other layer weights become W4Linear, the head W8Linear. `keep` names
    weights left as they are. split_rope first permutes the model to
    split-rope layout in place (`to_split_rope`; the JAX package does so
    when given cfg). Layers are converted one at a time and their float
    weights released, so no second full-precision copy is held."""
    if mode not in ("int8", "w4"):
        raise ValueError(f"mode must be 'int8' or 'w4', got {mode!r}")
    if split_rope:
        to_split_rope(model, cfg)
    for lp in model.layers:
        if mode == "int8":
            for k in LAYER_QUANT_KEYS:
                if hasattr(lp, k) and k not in keep and isinstance(getattr(lp, k), nn.Linear):
                    setattr(lp, k, W8Linear.from_weight(_in_out(getattr(lp, k))))
            continue
        if hasattr(lp, "w1") and hasattr(lp, "w3") and "w1" not in keep and "w3" not in keep:
            w13 = torch.cat([_in_out(lp.w1), _in_out(lp.w3)], dim=1)
            del lp.w1, lp.w3
            lp.w13 = W4Linear.from_weight(w13)
        for k in LAYER_QUANT_KEYS:
            if hasattr(lp, k) and k not in keep and not isinstance(getattr(lp, k), W4Linear):
                setattr(lp, k, W4Linear.from_weight(_in_out(getattr(lp, k))))
    for k in TOP_QUANT_KEYS:
        if k not in keep and isinstance(getattr(model, k), nn.Linear):
            setattr(model, k, W8Linear.from_weight(_in_out(getattr(model, k))))
    return model


# ---------------------------------------------------------------------------
# KV-cache rows. Scales are (..., 2H) f32 [k scales | v scales], unpadded
# (the JAX package pads them to 128 lanes for the TPU's DMA).
# ---------------------------------------------------------------------------

def quantize_kv_rows(kv_rows: torch.Tensor, n_head: int):
    """[k|v] rows (..., 2*H*D) -> per-head symmetric int8 (..., 2*H*D) and
    scales (..., 2*H) f32, s = max(amax / 127, 1e-8)."""
    *lead, hd2 = kv_rows.shape
    h2 = 2 * n_head
    kv = kv_rows.float().reshape(*lead, h2, hd2 // h2)
    s = torch.clamp(kv.abs().amax(dim=-1) / 127.0, min=1e-8)
    q = torch.clamp(torch.round(kv / s[..., None]), -127, 127).to(torch.int8)
    return q.reshape(*lead, hd2), s


def dequantize_kv_slab(kv_q: torch.Tensor, s: torch.Tensor, n_head: int,
                       dtype=torch.float32) -> torch.Tensor:
    """(B, S, 2*H*D) int8 + (B, S, >= 2*H) f32 -> (B, S, 2*H*D) dtype."""
    b, t, hd2 = kv_q.shape
    h2 = 2 * n_head
    kv = kv_q.float().reshape(b, t, h2, hd2 // h2) * s[..., :h2, None]
    return kv.reshape(b, t, hd2).to(dtype)


def quantize_kv_rows_4(kv_rows: torch.Tensor, n_head: int, split: bool = False):
    """[k|v] rows (..., 2*H*D) -> int4 carriers (..., 2 * H*D/2) int8 and
    scales (..., 2*H) f32.

    Per-head symmetric int4 (q in [-7, 7], s = max(amax / 7, 1e-8)).
    Carrier j of a head holds (even_j, odd_j) as low | high nibble: dims
    (2j, 2j+1), or with split=True the split-rope pair (j, D/2 + j). Rows are
    unpadded (the JAX package pads each half to a multiple of 128 bytes)."""
    *lead, hd2 = kv_rows.shape
    h2 = 2 * n_head
    d = hd2 // h2
    kv = kv_rows.float().reshape(*lead, h2, d)
    s = torch.clamp(kv.abs().amax(dim=-1) / 7.0, min=1e-8)
    q = torch.clamp(torch.round(kv / s[..., None]), -7, 7).to(torch.int32)
    if split:
        even, odd = q[..., : d // 2], q[..., d // 2:]
    else:
        even, odd = q[..., 0::2], q[..., 1::2]
    return pack_nibbles(even, odd).reshape(*lead, h2 * (d // 2)), s


def dequantize_kv4_slab(kv_c: torch.Tensor, s: torch.Tensor, n_head: int, head_dim: int,
                        dtype=torch.float32, split: bool = False) -> torch.Tensor:
    """(B, S, 2 * H*D/2) carriers + (B, S, >= 2H) scales -> (B, S, 2*H*D)
    dtype, in split layout with split=True."""
    b, t, _ = kv_c.shape
    d = head_dim
    lo, hi = unpack_nibbles(kv_c.reshape(b, t, 2, n_head, d // 2))
    if split:
        q = torch.cat([lo, hi], dim=-1)
    else:
        q = torch.stack([lo, hi], dim=-1).reshape(b, t, 2, n_head, d)
    kv = q.float() * s[..., : 2 * n_head].reshape(b, t, 2, n_head)[..., None]
    return kv.reshape(b, t, 2 * n_head * d).to(dtype)
