"""GAN discriminators of VQ tokenizer training (the JAX package's
`models/discriminators.py`), NHWC activations, OIHW weights.

- PatchGAN: 4x4 convolutions padded 1, a stride-2 pyramid whose last
  convolution has stride 1, train-mode batch norm on the batch's own
  statistics (biased variance, eps 1e-5; no running statistics), LeakyReLU
  0.2 -> a map of logits (B, h, w, 1).
- StyleGAN: residual blocks (a 1x1 stride-2 shortcut; two 3x3 convolutions,
  the normalised [1, 2, 1] x [1, 2, 1] depthwise blur with a reflect border,
  a stride-2 3x3 convolution padded 1; the sum over sqrt 2) down to 4 x 4,
  a 3x3 convolution to 512 channels, then two linears on the (h, w, c)
  flattening -> logits (B, 1).

Every padding is the JAX package's: explicit pairs where it gives them, XLA
`SAME` (`ops/conv.conv2d`) where it does not; all are symmetric here.
"""
from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from controlar_tpu_torch import resolve_device
from controlar_tpu_torch.ops.conv import Conv, conv2d, reflect_pad2d
from controlar_tpu_torch.ops.norms import Affine

_PAD1 = ((1, 1), (1, 1))


class PatchBlock(nn.Module):
    def __init__(self, cin: int, cout: int):
        super().__init__()
        self.conv = Conv(cin, cout, 4, bias=False)
        self.bn = Affine(cout)


class PatchGAN(nn.Module):
    def __init__(self, input_nc: int = 3, ndf: int = 64, n_layers: int = 3):
        super().__init__()
        self.conv_in = Conv(input_nc, ndf, 4)
        widths = [ndf * min(2 ** n, 8) for n in range(n_layers + 1)]
        self.blocks = nn.ModuleList(PatchBlock(widths[n], widths[n + 1])
                                    for n in range(n_layers))
        self.conv_out = Conv(widths[-1], 1, 4)


def init_patchgan(seed: int = 0, input_nc: int = 3, ndf: int = 64, n_layers: int = 3,
                  device="cuda") -> PatchGAN:
    """The reference's init: convolutions normal(0, 0.02), biases zero, batch
    norm scales normal(1, 0.02) and biases zero. Trainable."""
    device = resolve_device(device)
    with torch.device("meta"):
        model = PatchGAN(input_nc, ndf, n_layers)
    model = model.to_empty(device=device)
    gen = torch.Generator(device=device).manual_seed(seed)
    with torch.no_grad():
        for name, p in model.named_parameters():
            if name.endswith(".bias"):
                p.zero_()
            else:
                mean = 1.0 if name.endswith(".scale") else 0.0
                p.copy_(mean + torch.randn(p.shape, generator=gen, device=device) * 0.02)
    return model.train()


def _batch_norm_train(x: torch.Tensor, bn: Affine, eps: float = 1e-5) -> torch.Tensor:
    mean = x.mean(dim=(0, 1, 2), keepdim=True)
    var = x.var(dim=(0, 1, 2), correction=0, keepdim=True)
    return (x - mean) * torch.rsqrt(var + eps) * bn.scale + bn.bias


def patchgan_forward(p: PatchGAN, x: torch.Tensor) -> torch.Tensor:
    """x: (B, H, W, 3) in [-1, 1] -> logits (B, h, w, 1)."""
    h = F.leaky_relu(conv2d(x, p.conv_in.weight, p.conv_in.bias, stride=2, padding=_PAD1), 0.2)
    for i, blk in enumerate(p.blocks):
        stride = 2 if i < len(p.blocks) - 1 else 1
        h = conv2d(h, blk.conv.weight, None, stride=stride, padding=_PAD1)
        h = F.leaky_relu(_batch_norm_train(h, blk.bn), 0.2)
    return conv2d(h, p.conv_out.weight, p.conv_out.bias, padding=_PAD1)


# channels at each resolution
_SG_CHANNELS = {4: 512, 8: 512, 16: 512, 32: 512, 64: 256, 128: 128,
                256: 64, 512: 32, 1024: 16}


class StyleBlock(nn.Module):
    def __init__(self, cin: int, cout: int):
        super().__init__()
        self.conv_res = Conv(cin, cout, 1)
        self.conv1 = Conv(cin, cout, 3)
        self.conv2 = Conv(cout, cout, 3)
        self.down = Conv(cout, cout, 3)


class StyleGANDisc(nn.Module):
    def __init__(self, input_nc: int = 3, image_size: int = 256):
        super().__init__()
        cin = _SG_CHANNELS[image_size]
        self.conv_in = Conv(input_nc, cin, 3)
        blocks = []
        for i in range(int(math.log2(image_size)), 2, -1):
            cout = _SG_CHANNELS[2 ** (i - 1)]
            blocks.append(StyleBlock(cin, cout))
            cin = cout
        self.blocks = nn.ModuleList(blocks)
        self.final_conv = Conv(cin, 512, 3)
        self.fc1 = nn.Linear(512 * 4 * 4, 512)
        self.fc2 = nn.Linear(512, 1)


def init_stylegan_disc(seed: int = 0, input_nc: int = 3, image_size: int = 256,
                       device="cuda") -> StyleGANDisc:
    """The JAX package's init: convolutions uniform in +-1/sqrt(fan_in), the
    linears normal / sqrt(fan_in), biases zero. Trainable."""
    device = resolve_device(device)
    with torch.device("meta"):
        model = StyleGANDisc(input_nc, image_size)
    model = model.to_empty(device=device)
    gen = torch.Generator(device=device).manual_seed(seed)
    with torch.no_grad():
        for mod in model.modules():
            if isinstance(mod, Conv):
                bound = 1.0 / np.sqrt(mod.weight[0].numel())
                mod.weight.copy_((torch.rand(mod.weight.shape, generator=gen, device=device)
                                  * 2 - 1) * bound)
            elif isinstance(mod, nn.Linear):
                mod.weight.copy_(torch.randn(mod.weight.shape, generator=gen, device=device)
                                 / np.sqrt(mod.weight.shape[1]))
            else:
                continue
            mod.bias.zero_()
    return model.train()


def _blur(x: torch.Tensor) -> torch.Tensor:
    """Normalised [1,2,1] x [1,2,1] depthwise blur with a reflect border
    (kornia's filter2d defaults, the reference's Blur)."""
    f = np.outer([1, 2, 1], [1, 2, 1]).astype(np.float32)
    c = x.shape[-1]
    k = torch.from_numpy(f / f.sum()).to(x.device, x.dtype)[None, None].expand(c, 1, 3, 3)
    y = F.conv2d(reflect_pad2d(x, 1).permute(0, 3, 1, 2), k, groups=c)
    return y.permute(0, 2, 3, 1)


def stylegan_disc_forward(p: StyleGANDisc, x: torch.Tensor) -> torch.Tensor:
    """x: (B, H, W, 3) in [-1, 1] -> logits (B, 1)."""
    h = F.leaky_relu(conv2d(x, p.conv_in.weight, p.conv_in.bias), 0.2)
    inv_sqrt2 = 1.0 / np.sqrt(2.0)
    for blk in p.blocks:
        res = conv2d(h, blk.conv_res.weight, blk.conv_res.bias, stride=2, padding="VALID")
        y = F.leaky_relu(conv2d(h, blk.conv1.weight, blk.conv1.bias), 0.2)
        y = F.leaky_relu(conv2d(y, blk.conv2.weight, blk.conv2.bias), 0.2)
        y = conv2d(_blur(y), blk.down.weight, blk.down.bias, stride=2, padding=_PAD1)
        h = (y + res) * inv_sqrt2
    h = F.leaky_relu(conv2d(h, p.final_conv.weight, p.final_conv.bias), 0.2)
    h = F.leaky_relu(p.fc1(h.reshape(h.shape[0], -1)), 0.2)
    return p.fc2(h)


def disc_forward(disc: nn.Module, disc_type: str, x: torch.Tensor) -> torch.Tensor:
    if disc_type == "stylegan":
        return stylegan_disc_forward(disc, x)
    if disc_type == "patchgan":
        return patchgan_forward(disc, x)
    raise ValueError(f"disc_type must be 'patchgan' or 'stylegan', got {disc_type!r}")
