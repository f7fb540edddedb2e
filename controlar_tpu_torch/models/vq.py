"""VQGAN tokenizer (LlamaGen VQ-16 / VQ-8): image -> codes -> image.

NHWC activations as in the JAX package, images in [-1, 1]. The modules hold
the parameters under the JAX package's names (convolutions as `Conv` with
OIHW weights, group norms as `Affine`); the functions below compute.
`encode(x)` -> (z_q, indices): the encoder, `quant_conv` and the nearest
codebook entry (straight-through); `decode_code(indices)` -> image.
"""
from __future__ import annotations

import math

import torch
from torch import nn

from controlar_tpu_torch import check_on, resolve_device
from controlar_tpu_torch.config import VQConfig
from controlar_tpu_torch.ops.conv import conv2d, upsample_nearest2x
from controlar_tpu_torch.ops.norms import Affine, group_norm


class Conv(nn.Module):
    def __init__(self, k: int, cin: int, cout: int):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(cout, cin, k, k))
        self.bias = nn.Parameter(torch.empty(cout))


class ResnetBlock(nn.Module):
    def __init__(self, cin: int, cout: int):
        super().__init__()
        self.norm1 = Affine(cin)
        self.conv1 = Conv(3, cin, cout)
        self.norm2 = Affine(cout)
        self.conv2 = Conv(3, cout, cout)
        self.nin_shortcut = Conv(1, cin, cout) if cin != cout else None


class AttnBlock(nn.Module):
    def __init__(self, c: int):
        super().__init__()
        self.norm = Affine(c)
        self.q, self.k, self.v, self.proj_out = (Conv(1, c, c) for _ in range(4))


class Resample(nn.Module):
    """The 3x3 convolution of an up- or downsampling step."""

    def __init__(self, c: int):
        super().__init__()
        self.conv = Conv(3, c, c)


class Level(nn.Module):
    def __init__(self, res, attn, upsample=None, downsample=None):
        super().__init__()
        self.res = nn.ModuleList(res)
        self.attn = nn.ModuleList(attn)
        self.upsample = upsample
        self.downsample = downsample


class Encoder(nn.Module):
    def __init__(self, cfg: VQConfig):
        super().__init__()
        ch, mult = cfg.ch, cfg.encoder_ch_mult
        n = len(mult)
        in_mult = (1,) + tuple(mult)
        self.conv_in = Conv(3, 3, ch)
        levels = []
        block_in = ch
        for i in range(n):
            block_in, block_out = ch * in_mult[i], ch * mult[i]
            res, attn = [], []
            for _ in range(cfg.num_res_blocks):
                res.append(ResnetBlock(block_in, block_out))
                block_in = block_out
                if i == n - 1:
                    attn.append(AttnBlock(block_in))
            levels.append(Level(res, attn, downsample=Resample(block_in) if i != n - 1 else None))
        self.levels = nn.ModuleList(levels)
        self.mid = nn.ModuleList(
            [ResnetBlock(block_in, block_in), AttnBlock(block_in), ResnetBlock(block_in, block_in)])
        self.norm_out = Affine(block_in)
        self.conv_out = Conv(3, block_in, cfg.z_channels)


class Decoder(nn.Module):
    def __init__(self, cfg: VQConfig):
        super().__init__()
        ch, mult = cfg.ch, cfg.decoder_ch_mult
        n = len(mult)
        block_in = ch * mult[n - 1]
        self.conv_in = Conv(3, cfg.z_channels, block_in)
        self.mid = nn.ModuleList(
            [ResnetBlock(block_in, block_in), AttnBlock(block_in), ResnetBlock(block_in, block_in)])
        levels = []
        for i in reversed(range(n)):  # stored low-res first
            block_out = ch * mult[i]
            res, attn = [], []
            for _ in range(cfg.num_res_blocks + 1):
                res.append(ResnetBlock(block_in, block_out))
                block_in = block_out
                if i == n - 1:
                    attn.append(AttnBlock(block_in))
            levels.append(Level(res, attn, upsample=Resample(block_in) if i != 0 else None))
        self.levels = nn.ModuleList(levels)
        self.norm_out = Affine(block_in)
        self.conv_out = Conv(3, block_in, 3)


class VQModel(nn.Module):
    def __init__(self, cfg: VQConfig):
        super().__init__()
        self.encoder = Encoder(cfg)
        self.quant_conv = Conv(1, cfg.z_channels, cfg.codebook_embed_dim)
        self.post_quant_conv = Conv(1, cfg.codebook_embed_dim, cfg.z_channels)
        self.codebook = nn.Parameter(torch.empty(cfg.codebook_size, cfg.codebook_embed_dim))
        self.decoder = Decoder(cfg)


def init_vq(cfg: VQConfig, seed: int = 0, dtype: torch.dtype = torch.float32,
            device="cpu") -> VQModel:
    """Random weights with the JAX package's init distribution: conv weights
    and biases uniform in +-1/sqrt(fan_in), norms one and zero, the codebook
    uniform in +-1/codebook_size and then L2-normalised. The decoding half
    is drawn first, then the encoder, so a seed gives the decoder it gave
    before the encoder was ported."""
    device = torch.device(device)
    with torch.device("meta"):
        model = VQModel(cfg).to(dtype)
    model = model.to_empty(device=device)
    gen = torch.Generator(device=device).manual_seed(seed)

    def uniform(shape, bound):
        return (torch.rand(shape, generator=gen, device=device) * 2 - 1) * bound

    def fill(modules):
        for mod in modules:
            if isinstance(mod, Conv):
                bound = 1.0 / math.sqrt(mod.weight[0].numel())
                mod.weight.copy_(uniform(mod.weight.shape, bound))
                mod.bias.copy_(uniform(mod.bias.shape, bound))
            elif isinstance(mod, Affine):
                mod.scale.fill_(1.0)
                mod.bias.zero_()

    with torch.no_grad():
        fill([*model.post_quant_conv.modules(), *model.decoder.modules()])
        cb = uniform(model.codebook.shape, 1.0 / cfg.codebook_size)
        model.codebook.copy_(cb / cb.norm(dim=-1, keepdim=True))
        fill([*model.encoder.modules(), *model.quant_conv.modules()])
    return model.eval().requires_grad_(False)


def swish(x: torch.Tensor) -> torch.Tensor:
    return x * torch.sigmoid(x)


def _conv(p: Conv, x: torch.Tensor) -> torch.Tensor:
    return conv2d(x, p.weight, p.bias)


def _norm(p: Affine, x: torch.Tensor) -> torch.Tensor:
    return group_norm(x, p.scale, p.bias)


def resnet_block(p: ResnetBlock, x: torch.Tensor) -> torch.Tensor:
    h = _conv(p.conv1, swish(_norm(p.norm1, x)))
    h = _conv(p.conv2, swish(_norm(p.norm2, h)))
    if p.nin_shortcut is not None:
        x = _conv(p.nin_shortcut, x)
    return x + h


def attn_block(p: AttnBlock, x: torch.Tensor) -> torch.Tensor:
    """Single-head spatial self-attention; fp32 scores and softmax."""
    b, h, w, c = x.shape
    hn = _norm(p.norm, x)
    q = _conv(p.q, hn).reshape(b, h * w, c)
    k = _conv(p.k, hn).reshape(b, h * w, c)
    v = _conv(p.v, hn).reshape(b, h * w, c)
    scores = torch.einsum("bqc,bkc->bqk", q.float(), k.float()) * (c ** -0.5)
    probs = torch.softmax(scores, dim=-1).to(x.dtype)
    o = torch.einsum("bqk,bkc->bqc", probs.float(), v.float()).to(x.dtype)
    return x + _conv(p.proj_out, o.reshape(b, h, w, c))


def upsample(p: Resample, x: torch.Tensor) -> torch.Tensor:
    return _conv(p.conv, upsample_nearest2x(x))


def downsample(p: Resample, x: torch.Tensor) -> torch.Tensor:
    """Pad right and bottom by one, then a stride-2 VALID convolution."""
    return conv2d(x, p.conv.weight, p.conv.bias, stride=2, padding=((0, 1), (0, 1)))


def encoder_forward(p: Encoder, cfg: VQConfig, x: torch.Tensor) -> torch.Tensor:
    """x: (B, H, W, 3) -> (B, H/f, W/f, z_channels)."""
    h = _conv(p.conv_in, x)
    for level in p.levels:
        for j, rb in enumerate(level.res):
            h = resnet_block(rb, h)
            if len(level.attn):
                h = attn_block(level.attn[j], h)
        if level.downsample is not None:
            h = downsample(level.downsample, h)
    h = resnet_block(p.mid[0], h)
    h = attn_block(p.mid[1], h)
    h = resnet_block(p.mid[2], h)
    return _conv(p.conv_out, swish(_norm(p.norm_out, h)))


def decoder_trunk(p: Decoder, cfg: VQConfig, z: torch.Tensor) -> torch.Tensor:
    """Decoder up to (and excluding) the final conv_out."""
    h = _conv(p.conv_in, z)
    h = resnet_block(p.mid[0], h)
    h = attn_block(p.mid[1], h)
    h = resnet_block(p.mid[2], h)
    for level in p.levels:
        for j, rb in enumerate(level.res):
            h = resnet_block(rb, h)
            if len(level.attn):
                h = attn_block(level.attn[j], h)
        if level.upsample is not None:
            h = upsample(level.upsample, h)
    return swish(_norm(p.norm_out, h))


def decoder_forward(p: Decoder, cfg: VQConfig, z: torch.Tensor) -> torch.Tensor:
    """z: (B, h, w, z_channels) -> (B, H, W, 3)."""
    return _conv(p.conv_out, decoder_trunk(p, cfg, z))


def _codebook(p: VQModel, cfg: VQConfig) -> torch.Tensor:
    emb = p.codebook
    if cfg.codebook_l2_norm:
        emb = emb / emb.norm(dim=-1, keepdim=True)
    return emb


def code_distances(p: VQModel, cfg: VQConfig, z: torch.Tensor):
    """-> (codebook (N, D), zn (B, h, w, D), distances (B, h, w, N)), fp32:
    |z|^2 + |e|^2 - 2 z.e on the l2-normalised z and codes when
    codebook_l2_norm, differentiable in both."""
    emb = _codebook(p, cfg).float()
    zf = z.float()
    zn = zf / zf.norm(dim=-1, keepdim=True) if cfg.codebook_l2_norm else zf
    d = ((zn * zn).sum(-1, keepdim=True) + (emb * emb).sum(-1)
         - 2.0 * torch.einsum("bhwd,nd->bhwn", zn, emb))
    return emb, zn, d


def quantize(p: VQModel, cfg: VQConfig, z: torch.Tensor):
    """Nearest codebook entry, straight-through: z (B, h, w, D) -> (z_q
    (B, h, w, D) in z's dtype, indices (B, h, w) int64), by
    `code_distances`; the gradient flows to the (normalised) z."""
    emb, zn, d = code_distances(p, cfg, z)
    indices = torch.argmin(d, dim=-1)
    z_q = emb[indices]
    z_q = zn + (z_q - zn).detach()
    return z_q.to(z.dtype), indices


def encode(p: VQModel, cfg: VQConfig, x: torch.Tensor, device="cuda"):
    """x (B, H, W, 3) in [-1, 1] -> (z_q, indices (B, H/f, W/f)). Runs on
    `device` ('cuda' unless the caller asks for 'cpu'); the model must
    already be there. Gradients flow (straight-through) unless the caller
    turns them off."""
    dev = resolve_device(device)
    check_on(p, dev)
    x = torch.as_tensor(x, device=dev)
    h = _conv(p.quant_conv, encoder_forward(p.encoder, cfg, x))
    return quantize(p, cfg, h)


def codebook_lookup(p: VQModel, cfg: VQConfig, indices: torch.Tensor) -> torch.Tensor:
    """indices (B, h, w) -> z_q (B, h, w, D)."""
    return _codebook(p, cfg)[indices.long()]


def decode(p: VQModel, cfg: VQConfig, z_q: torch.Tensor) -> torch.Tensor:
    return decoder_forward(p.decoder, cfg, _conv(p.post_quant_conv, z_q))


@torch.inference_mode()
def decode_code(p: VQModel, cfg: VQConfig, indices: torch.Tensor) -> torch.Tensor:
    """indices (B, h, w) -> image (B, h*f, w*f, 3) in [-1, 1]."""
    return decode(p, cfg, codebook_lookup(p, cfg, indices))
