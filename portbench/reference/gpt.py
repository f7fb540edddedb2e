"""The LlamaGen GPT with ControlAR's control fusion, teacher-forced, in fp32.

Weights are a dict under the released checkpoint's keys (LlamaGen's
`autoregressive/models/gpt.py`: `tok_embeddings`, `cls_embedding.
embedding_table` or `cls_embedding.cap_proj` + `uncond_embedding`,
`layers.{i}.attention.wqkv` / `.wo`, `layers.{i}.feed_forward.w1` / `w2` /
`w3`, the RMS norms, `norm`, `output`; ControlAR's `adapter_mlp`,
`condition_mlp.cap_proj` and `condition_layers.{j}`). `g` is the `gpt` group
of a configuration file.

The model, as published:
- the prefix is the class embedding (c2i, one token) or the caption MLP of
  the caption features (t2i, `cls_token_num` tokens); image token t sits at
  position cls_token_num + t;
- pre-norm blocks: RMSNorm, one fused q/k/v projection, 2D rotary
  embeddings (the first half of each head's (even, odd) pairs turns with the
  token's grid row, the second half with its column; prefix positions get an
  all-zero table, so their rotated q and k are zero), causal softmax
  attention, a bias-free SwiGLU FFN;
- a caption mask hides padded caption columns from every other position
  (a position always sees itself);
- control: the adapter features go through `adapter_mlp` and `condition_mlp`
  (tanh-GELU, bias-free; the unconditional CFG rows get zero features), then
  one MLP per fusion point; at layer l with l % (n_layer // n_fusion_points)
  == 0 the hidden state at position p gains control token p - cls + 1 of
  fusion point min(l // interval, n - 1), for p >= cls - 1;
- logits = output(RMSNorm(h)); CFG mixes uncond + (cond - uncond) * scale.
"""
from __future__ import annotations

import math
from typing import Callable, Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

Params = Dict[str, torch.Tensor]
Matmul = Callable[[torch.Tensor, torch.Tensor], torch.Tensor]
# training dropout: (key tail, x) -> x with the mask of that key applied
# (`train.Dropout`); tails (0,) the token embeddings, (1, layer, 1) the
# attention output, (1, layer, 2) the FFN output
Dropout = Callable[[tuple, torch.Tensor], torch.Tensor]


def plain_matmul(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x (..., in) times a (out, in) weight."""
    return x @ w.t()


def ffn_dim(dim: int) -> int:
    """LlamaGen's SwiGLU width: 2/3 of 4 dim, rounded up to a multiple of 256."""
    hidden = int(2 * 4 * dim / 3)
    return -(-hidden // 256) * 256


def param_specs(g: dict) -> List[Tuple[str, tuple, str]]:
    """(key, shape, init) of every weight, init one of "normal" (N(0,
    initializer_range)), "scale" (near one: a norm's weight) or "caption"
    (N(0, 1 / caption_dim): the unconditional caption)."""
    d, hd, f = g["dim"], g["head_dim"], g["ffn_dim"]
    assert d == g["n_head"] * hd and f == ffn_dim(d), g
    specs = [("tok_embeddings.weight", (g["vocab_size"], d), "normal")]
    if g["model_type"] == "c2i":
        specs.append(("cls_embedding.embedding_table.weight", (g["num_classes"] + 1, d), "normal"))
    else:
        c = g["caption_dim"]
        specs += [("cls_embedding.cap_proj.fc1.weight", (d, c), "normal"),
                  ("cls_embedding.cap_proj.fc2.weight", (d, d), "normal"),
                  ("cls_embedding.uncond_embedding", (g["cls_token_num"], c), "caption")]
    specs += [("adapter_mlp.fc1.weight", (d, g["adapter_dim"]), "normal"),
              ("adapter_mlp.fc2.weight", (d, d), "normal"),
              ("condition_mlp.cap_proj.fc1.weight", (d, d), "normal"),
              ("condition_mlp.cap_proj.fc2.weight", (d, d), "normal")]
    for j in range(g["n_fusion_points"]):
        specs += [(f"condition_layers.{j}.fc1.weight", (d, d), "normal"),
                  (f"condition_layers.{j}.fc2.weight", (d, d), "normal")]
    for i in range(g["n_layer"]):
        p = f"layers.{i}."
        specs += [(p + "attention_norm.weight", (d,), "scale"),
                  (p + "attention.wqkv.weight", (3 * d, d), "normal"),
                  (p + "attention.wo.weight", (d, d), "normal"),
                  (p + "ffn_norm.weight", (d,), "scale"),
                  (p + "feed_forward.w1.weight", (f, d), "normal"),
                  (p + "feed_forward.w3.weight", (f, d), "normal"),
                  (p + "feed_forward.w2.weight", (d, f), "normal")]
    specs += [("norm.weight", (d,), "scale"), ("output.weight", (g["vocab_size"], d), "normal")]
    return specs


def decayed(key: str) -> bool:
    """AdamW's weight decay: the matrices, never a norm's weight or the
    (frozen) unconditional caption."""
    return key.endswith(".weight") and not key.endswith("norm.weight") and key != "norm.weight"


FROZEN = ("cls_embedding.uncond_embedding",)


def rms_norm(x: torch.Tensor, w: torch.Tensor, eps: float) -> torch.Tensor:
    return x * torch.rsqrt(x.pow(2).mean(-1, keepdim=True) + eps) * w


def mlp(p: Params, prefix: str, x: torch.Tensor, mm: Matmul = plain_matmul) -> torch.Tensor:
    """Bias-free fc1 -> tanh-GELU -> fc2."""
    return mm(F.gelu(mm(x, p[prefix + "fc1.weight"]), approximate="tanh"), p[prefix + "fc2.weight"])


def rope_angles(g: dict, device) -> Tuple[torch.Tensor, torch.Tensor]:
    """(cos, sin), each (cls + block, head_dim // 2): zero on the prefix."""
    gh, gw = g["grid"]
    hd = g["head_dim"]
    n = hd // 4  # pairs per grid axis
    freqs = 1.0 / (g["rope_base"] ** (torch.arange(n, dtype=torch.float64) * 2 / (hd // 2)))
    rows = torch.arange(gh, dtype=torch.float64)[:, None].expand(gh, gw).reshape(-1)
    cols = torch.arange(gw, dtype=torch.float64)[None, :].expand(gh, gw).reshape(-1)
    ang = torch.cat([rows[:, None] * freqs, cols[:, None] * freqs], dim=1).float()
    pre = torch.zeros(g["cls_token_num"], 2 * n)
    cos = torch.cat([pre, torch.cos(ang)]).to(device)
    sin = torch.cat([pre, torch.sin(ang)]).to(device)
    return cos, sin


def rotate(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """x (B, T, H, D): each (even, odd) pair turned by its angle."""
    b, t, h, d = x.shape
    pair = x.reshape(b, t, h, d // 2, 2)
    c, s = cos[None, :t, None, :], sin[None, :t, None, :]
    even = pair[..., 0] * c - pair[..., 1] * s
    odd = pair[..., 1] * c + pair[..., 0] * s
    return torch.stack([even, odd], dim=-1).reshape(b, t, h, d)


def prefix_embedding(p: Params, g: dict, labels=None, caption=None) -> torch.Tensor:
    """c2i labels (B,) or t2i caption features (B, cls, caption_dim) -> (B, cls, dim)."""
    if g["model_type"] == "c2i":
        return p["cls_embedding.embedding_table.weight"][labels.long()][:, None, :]
    return mlp(p, "cls_embedding.cap_proj.", caption)[:, : g["cls_token_num"]]


def control_tokens(p: Params, g: dict, feats: torch.Tensor,
                   zero: Optional[torch.Tensor] = None, mm: Matmul = plain_matmul) -> torch.Tensor:
    """Adapter features (B, block, adapter_dim) -> control tokens (B, block,
    dim); rows where `zero` is true get zero features after adapter_mlp."""
    x = mlp(p, "adapter_mlp.", feats, mm)
    if zero is not None:
        x = torch.where(zero[:, None, None], torch.zeros_like(x), x)
    return mlp(p, "condition_mlp.cap_proj.", x, mm)


def fusion(p: Params, g: dict, ct: torch.Tensor, mm: Matmul = plain_matmul) -> torch.Tensor:
    """-> (n_fusion_points, B, block, dim)."""
    return torch.stack([mlp(p, f"condition_layers.{j}.", ct, mm)
                        for j in range(g["n_fusion_points"])])


def attention_mask(g: dict, t: int, col_mask: Optional[torch.Tensor], device) -> torch.Tensor:
    """(B | 1, 1, T, T) bool: causal, padded caption columns hidden but for
    the diagonal."""
    causal = torch.ones(t, t, dtype=torch.bool, device=device).tril()
    if col_mask is None:
        return causal[None, None]
    cols = torch.ones(col_mask.shape[0], t, dtype=torch.bool, device=device)
    cols[:, : col_mask.shape[1]] = col_mask.bool()
    eye = torch.eye(t, dtype=torch.bool, device=device)
    return (causal[None] & (cols[:, None, :] | eye[None]))[:, None]


def block(p: Params, g: dict, i: int, h: torch.Tensor, cos, sin, mask,
          mm: Matmul = plain_matmul, drop: Optional[Dropout] = None) -> torch.Tensor:
    b, t, d = h.shape
    nh, hd, eps = g["n_head"], g["head_dim"], g["norm_eps"]
    pre = f"layers.{i}."
    x = rms_norm(h, p[pre + "attention_norm.weight"], eps)
    q, k, v = mm(x, p[pre + "attention.wqkv.weight"]).split(d, dim=-1)
    q = rotate(q.reshape(b, t, nh, hd), cos, sin).transpose(1, 2)
    k = rotate(k.reshape(b, t, nh, hd), cos, sin).transpose(1, 2)
    v = v.reshape(b, t, nh, hd).transpose(1, 2)
    scores = (q @ k.transpose(-1, -2)) / math.sqrt(hd)
    scores = scores.masked_fill(~mask, float("-inf"))
    attn = (torch.softmax(scores, dim=-1) @ v).transpose(1, 2).reshape(b, t, d)
    out = mm(attn, p[pre + "attention.wo.weight"])
    h = h + (out if drop is None else drop((1, i, 1), out))
    x = rms_norm(h, p[pre + "ffn_norm.weight"], eps)
    ff = F.silu(mm(x, p[pre + "feed_forward.w1.weight"])) * mm(x, p[pre + "feed_forward.w3.weight"])
    out = mm(ff, p[pre + "feed_forward.w2.weight"])
    return h + (out if drop is None else drop((1, i, 2), out))


def forward(p: Params, g: dict, prefix: torch.Tensor, tokens_in: torch.Tensor,
            fused3: Optional[torch.Tensor] = None, col_mask: Optional[torch.Tensor] = None,
            mm: Matmul = plain_matmul, remat: bool = False, drop: Optional[Dropout] = None
            ) -> torch.Tensor:
    """Teacher-forced logits: prefix (B, cls, dim), tokens_in (B, n) image
    tokens -> (B, n + 1, vocab), row j predicting image token j. remat
    recomputes each layer in the backward, drop applies training dropout
    (both for the training reference)."""
    cls = g["cls_token_num"]
    h = torch.cat([prefix, p["tok_embeddings.weight"][tokens_in.long()]], dim=1)
    if drop is not None:
        h = drop((0,), h)
    t = h.shape[1]
    cos, sin = rope_angles(g, h.device)
    mask = attention_mask(g, t, col_mask, h.device)
    interval = g["n_layer"] // g["n_fusion_points"]
    for i in range(g["n_layer"]):
        if fused3 is not None and i % interval == 0:
            j = min(i // interval, g["n_fusion_points"] - 1)
            h = torch.cat([h[:, : cls - 1], h[:, cls - 1:] + fused3[j][:, : t - cls + 1]], dim=1)
        if remat and torch.is_grad_enabled():
            h = checkpoint(block, p, g, i, h, cos, sin, mask, mm, drop, use_reentrant=False)
        else:
            h = block(p, g, i, h, cos, sin, mask, mm, drop)
    h = rms_norm(h[:, cls - 1:], p["norm.weight"], g["norm_eps"])
    return mm(h, p["output.weight"])


def cfg_logits(p: Params, g: dict, tokens: torch.Tensor, scale: float, *, labels=None,
               caption=None, caption_mask=None, feats=None, mm: Matmul = plain_matmul
               ) -> torch.Tensor:
    """CFG-mixed logits (B, block, vocab) of every image token given the ones
    before it: the conditional rows carry the labels or captions and the
    control features, the unconditional rows the null class (or the
    unconditional caption) and zero control."""
    b = tokens.shape[0]
    if g["model_type"] == "c2i":
        labels = torch.as_tensor(labels, device=tokens.device).long()
        prefix = prefix_embedding(p, g, labels=torch.cat(
            [labels, torch.full_like(labels, g["num_classes"])]))
        col = None
    else:
        unc = p["cls_embedding.uncond_embedding"][None].expand_as(caption)
        prefix = prefix_embedding(p, g, caption=torch.cat([caption, unc]))
        col = None if caption_mask is None else torch.cat([caption_mask, caption_mask]).bool()
    fused3 = None
    if feats is not None:
        zero = torch.arange(2 * b, device=tokens.device) >= b
        fused3 = fusion(p, g, control_tokens(p, g, torch.cat([feats, feats]), zero, mm), mm)
    logits = forward(p, g, prefix, torch.cat([tokens, tokens])[:, :-1], fused3, col, mm)
    cond, uncond = logits.chunk(2)
    return uncond + (cond - uncond) * scale


def train_loss(p: Params, g: dict, tokens: torch.Tensor, feats: torch.Tensor, *, labels=None,
               caption=None, caption_mask=None, mm: Matmul = plain_matmul,
               remat: bool = True, dropped: Optional[torch.Tensor] = None,
               drop: Optional[Dropout] = None) -> torch.Tensor:
    """The summed cross entropy of every image token of every row, teacher
    forced, with the rows' control. CFG dropout: rows where `dropped` is
    true take the null class (c2i) or the unconditional caption (t2i; the
    caption mask stays the row's) and zero control features."""
    if dropped is not None:
        if g["model_type"] == "c2i":
            labels = torch.where(dropped, g["num_classes"], labels.long())
        else:
            unc = p["cls_embedding.uncond_embedding"][None, : caption.shape[1]]
            caption = torch.where(dropped[:, None, None], unc, caption)
    prefix = prefix_embedding(p, g, labels=labels, caption=caption)
    fused3 = fusion(p, g, control_tokens(p, g, feats, dropped, mm), mm)
    logits = forward(p, g, prefix, tokens[:, :-1], fused3, caption_mask, mm, remat, drop)
    return F.cross_entropy(logits.reshape(-1, logits.shape[-1]), tokens.reshape(-1).long(),
                           reduction="sum")
