"""LlamaGen's VQ-16 tokenizer, decoding half, in fp32 NCHW, under the
released `tokenizer/tokenizer_image/vq_model.py` keys. `v` is the `vq` group
of a configuration file.

As published: codes look up the codebook (rows l2-normalised), a 1 x 1
`post_quant_conv`, then the decoder: `conv_in`, a middle of ResNet, attention
and ResNet blocks, one level per channel multiplier from the deepest (each
num_res_blocks + 1 ResNet blocks, attention after each at the deepest level,
a nearest 2x upsampling and a 3 x 3 convolution but at the last), GroupNorm
(32 groups, eps 1e-6), swish, `conv_out`. ResNet block: norm, swish, conv,
norm, swish, conv, plus the input (through a 1 x 1 `nin_shortcut` when the
width changes). Attention block: one head over all pixels of the GroupNorm'd
input, a 1 x 1 projection out, plus the input. The encoder's keys are listed
too: the tokenizer's loader takes a whole checkpoint.
"""
from __future__ import annotations

from typing import Dict, List, Tuple

import torch
import torch.nn.functional as F

Params = Dict[str, torch.Tensor]


def _conv(key: str, cin: int, cout: int, k: int):
    return [(key + ".weight", (cout, cin, k, k), "conv"), (key + ".bias", (cout,), "conv")]


def _norm(key: str, c: int):
    return [(key + ".weight", (c,), "scale"), (key + ".bias", (c,), "bias")]


def _res(key: str, cin: int, cout: int):
    s = _norm(key + ".norm1", cin) + _conv(key + ".conv1", cin, cout, 3)
    s += _norm(key + ".norm2", cout) + _conv(key + ".conv2", cout, cout, 3)
    return s + (_conv(key + ".nin_shortcut", cin, cout, 1) if cin != cout else [])


def _attn(key: str, c: int):
    s = _norm(key + ".norm", c)
    for n in ("q", "k", "v", "proj_out"):
        s += _conv(f"{key}.{n}", c, c, 1)
    return s


def param_specs(v: dict) -> List[Tuple[str, tuple, str]]:
    """(key, shape, init): "conv" (uniform in +-1 / sqrt(fan in)), "scale",
    "bias" or "code" (the codebook)."""
    ch, mult, nres, z = v["ch"], v["ch_mult"], v["num_res_blocks"], v["z_channels"]
    n = len(mult)
    s = _conv("encoder.conv_in", 3, ch, 3)
    block_in = ch
    for i in range(n):
        block_in, out = ch * ((1,) + tuple(mult))[i], ch * mult[i]
        for j in range(nres):
            s += _res(f"encoder.conv_blocks.{i}.res.{j}", block_in, out)
            block_in = out
            if i == n - 1:
                s += _attn(f"encoder.conv_blocks.{i}.attn.{j}", block_in)
        if i != n - 1:
            s += _conv(f"encoder.conv_blocks.{i}.downsample.conv", block_in, block_in, 3)
    s += _res("encoder.mid.0", block_in, block_in) + _attn("encoder.mid.1", block_in)
    s += _res("encoder.mid.2", block_in, block_in)
    s += _norm("encoder.norm_out", block_in) + _conv("encoder.conv_out", block_in, z, 3)
    s += _conv("quant_conv", z, v["embed_dim"], 1) + _conv("post_quant_conv", v["embed_dim"], z, 1)
    s.append(("quantize.embedding.weight", (v["codebook_size"], v["embed_dim"]), "code"))
    s += decoder_specs(v)
    return s


def decoder_specs(v: dict) -> List[Tuple[str, tuple, str]]:
    ch, mult, nres, z = v["ch"], v["ch_mult"], v["num_res_blocks"], v["z_channels"]
    n = len(mult)
    block_in = ch * mult[-1]
    s = _conv("decoder.conv_in", z, block_in, 3)
    s += _res("decoder.mid.0", block_in, block_in) + _attn("decoder.mid.1", block_in)
    s += _res("decoder.mid.2", block_in, block_in)
    for k, i in enumerate(reversed(range(n))):
        out = ch * mult[i]
        for j in range(nres + 1):
            s += _res(f"decoder.conv_blocks.{k}.res.{j}", block_in, out)
            block_in = out
            if i == n - 1:
                s += _attn(f"decoder.conv_blocks.{k}.attn.{j}", block_in)
        if i != 0:
            s += _conv(f"decoder.conv_blocks.{k}.upsample.conv", block_in, block_in, 3)
    return s + _norm("decoder.norm_out", block_in) + _conv("decoder.conv_out", block_in, 3, 3)


def _c(p: Params, key: str, x: torch.Tensor) -> torch.Tensor:
    w = p[key + ".weight"]
    return F.conv2d(x, w, p[key + ".bias"], padding=w.shape[-1] // 2)


def _gn(p: Params, key: str, x: torch.Tensor) -> torch.Tensor:
    return F.group_norm(x, 32, p[key + ".weight"], p[key + ".bias"], eps=1e-6)


def _swish(x):
    return x * torch.sigmoid(x)


def _resblock(p: Params, key: str, x: torch.Tensor) -> torch.Tensor:
    h = _c(p, key + ".conv1", _swish(_gn(p, key + ".norm1", x)))
    h = _c(p, key + ".conv2", _swish(_gn(p, key + ".norm2", h)))
    if key + ".nin_shortcut.weight" in p:
        x = _c(p, key + ".nin_shortcut", x)
    return x + h


def _attnblock(p: Params, key: str, x: torch.Tensor) -> torch.Tensor:
    b, c, h, w = x.shape
    hn = _gn(p, key + ".norm", x)
    q, k, v = (_c(p, f"{key}.{n}", hn).flatten(2) for n in ("q", "k", "v"))  # (B, C, N)
    att = torch.softmax(q.transpose(1, 2) @ k * c ** -0.5, dim=-1)        # (B, N, N)
    o = (v @ att.transpose(1, 2)).reshape(b, c, h, w)
    return x + _c(p, key + ".proj_out", o)


def decode_codes(p: Params, v: dict, codes: torch.Tensor) -> torch.Tensor:
    """codes (B, h, w) -> images (B, 16 h, 16 w, 3) in about [-1, 1]."""
    emb = p["quantize.embedding.weight"]
    emb = emb / emb.norm(dim=-1, keepdim=True)
    x = emb[codes.long()].permute(0, 3, 1, 2)
    x = _c(p, "decoder.conv_in", _c(p, "post_quant_conv", x))
    x = _resblock(p, "decoder.mid.0", x)
    x = _attnblock(p, "decoder.mid.1", x)
    x = _resblock(p, "decoder.mid.2", x)
    n = len(v["ch_mult"])
    for k, i in enumerate(reversed(range(n))):
        for j in range(v["num_res_blocks"] + 1):
            x = _resblock(p, f"decoder.conv_blocks.{k}.res.{j}", x)
            if i == n - 1:
                x = _attnblock(p, f"decoder.conv_blocks.{k}.attn.{j}", x)
        if i != 0:
            x = _c(p, f"decoder.conv_blocks.{k}.upsample.conv",
                   F.interpolate(x, scale_factor=2, mode="nearest"))
    x = _c(p, "decoder.conv_out", _swish(_gn(p, "decoder.norm_out", x)))
    return x.permute(0, 2, 3, 1)


def to_pixels(x: torch.Tensor) -> torch.Tensor:
    """Decoder output -> pixel values 0..255 before rounding: clamp to
    [-1, 1], then 255 (x + 1) / 2."""
    return 255.0 * (x.clamp(-1.0, 1.0) + 1.0) / 2.0
