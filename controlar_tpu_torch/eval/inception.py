"""The FID InceptionV3 feature extractor: the 2015 "TF-FID" graph as the
pytorch-fid port reproduces it (the JAX package's `eval/inception.py`).

`inception_features(model, images)` returns, in float32:
- pool3 (N, 2048): the FID / precision / recall embedding;
- spatial (N, 2023): Mixed_6d's branch1x1 (the TF graph's `mixed_6/conv`)
  after its ReLU, channels [:7], flattened in NHWC order, for sFID;
- logits (N, 1008): pool3 @ fc.weight.T with NO bias, for the Inception
  Score.

What differs from torchvision's InceptionV3: the batch norms' eps is 1e-3;
the average pools leave the zero padding out of the count; Mixed_7c's pool
branch is a max pool. The input is NHWC in [0, 255] (uint8 or float), any
size, resized to 299 x 299 by the LEGACY TF1 bilinear resize (src = dst *
in / out, no half-pixel shift, which `F.interpolate` does not do), then
(x - 128) / 128.

Parameter names are pytorch-fid's (`Mixed_5b.branch5x5_1.conv.weight`,
`...bn.running_var`, `fc.weight`), so its checkpoint loads by identity
(`convert_ref.inception_from_state_dict`). The convolutions run in
`compute_dtype` on channels-last tensors; a batch norm's scale and shift are
computed in fp32, then cast.
"""
from __future__ import annotations

from typing import Any, Dict, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from controlar_tpu_torch import resolve_device

# ---------------------------------------------------------------------------
# Architecture: every conv + bn leaf as (in_ch, out_ch, kh, kw), keyed by
# pytorch-fid's module paths.
# ---------------------------------------------------------------------------


def _a(in_ch, pf):
    return {
        "branch1x1": (in_ch, 64, 1, 1),
        "branch5x5_1": (in_ch, 48, 1, 1),
        "branch5x5_2": (48, 64, 5, 5),
        "branch3x3dbl_1": (in_ch, 64, 1, 1),
        "branch3x3dbl_2": (64, 96, 3, 3),
        "branch3x3dbl_3": (96, 96, 3, 3),
        "branch_pool": (in_ch, pf, 1, 1),
    }


def _b(in_ch):
    return {
        "branch3x3": (in_ch, 384, 3, 3),
        "branch3x3dbl_1": (in_ch, 64, 1, 1),
        "branch3x3dbl_2": (64, 96, 3, 3),
        "branch3x3dbl_3": (96, 96, 3, 3),
    }


def _c(in_ch, c7):
    return {
        "branch1x1": (in_ch, 192, 1, 1),
        "branch7x7_1": (in_ch, c7, 1, 1),
        "branch7x7_2": (c7, c7, 1, 7),
        "branch7x7_3": (c7, 192, 7, 1),
        "branch7x7dbl_1": (in_ch, c7, 1, 1),
        "branch7x7dbl_2": (c7, c7, 7, 1),
        "branch7x7dbl_3": (c7, c7, 1, 7),
        "branch7x7dbl_4": (c7, c7, 7, 1),
        "branch7x7dbl_5": (c7, 192, 1, 7),
        "branch_pool": (in_ch, 192, 1, 1),
    }


def _d(in_ch):
    return {
        "branch3x3_1": (in_ch, 192, 1, 1),
        "branch3x3_2": (192, 320, 3, 3),
        "branch7x7x3_1": (in_ch, 192, 1, 1),
        "branch7x7x3_2": (192, 192, 1, 7),
        "branch7x7x3_3": (192, 192, 7, 1),
        "branch7x7x3_4": (192, 192, 3, 3),
    }


def _e(in_ch):
    return {
        "branch1x1": (in_ch, 320, 1, 1),
        "branch3x3_1": (in_ch, 384, 1, 1),
        "branch3x3_2a": (384, 384, 1, 3),
        "branch3x3_2b": (384, 384, 3, 1),
        "branch3x3dbl_1": (in_ch, 448, 1, 1),
        "branch3x3dbl_2": (448, 384, 3, 3),
        "branch3x3dbl_3a": (384, 384, 1, 3),
        "branch3x3dbl_3b": (384, 384, 3, 1),
        "branch_pool": (in_ch, 192, 1, 1),
    }


SPEC: Dict[str, Any] = {
    "Conv2d_1a_3x3": (3, 32, 3, 3),
    "Conv2d_2a_3x3": (32, 32, 3, 3),
    "Conv2d_2b_3x3": (32, 64, 3, 3),
    "Conv2d_3b_1x1": (64, 80, 1, 1),
    "Conv2d_4a_3x3": (80, 192, 3, 3),
    "Mixed_5b": _a(192, 32),
    "Mixed_5c": _a(256, 64),
    "Mixed_5d": _a(288, 64),
    "Mixed_6a": _b(288),
    "Mixed_6b": _c(768, 128),
    "Mixed_6c": _c(768, 160),
    "Mixed_6d": _c(768, 160),
    "Mixed_6e": _c(768, 192),
    "Mixed_7a": _d(768),
    "Mixed_7b": _e(1280),
    "Mixed_7c": _e(2048),
}
NUM_LOGITS = 1008  # the 2015 graph's 1008-way softmax
POOL_DIM = 2048
SPATIAL_DIM = 7 * 17 * 17  # 2023
BN_EPS = 1e-3


def iter_conv_paths():
    """Yield (dotted module path, (cin, cout, kh, kw)) for every conv + bn."""
    def walk(prefix, spec):
        if isinstance(spec, tuple):
            yield prefix, spec
            return
        for k, v in spec.items():
            yield from walk(f"{prefix}.{k}" if prefix else k, v)

    yield from walk("", SPEC)


class _Conv(nn.Module):
    def __init__(self, cin: int, cout: int, kh: int, kw: int):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(cout, cin, kh, kw))


class _BN(nn.Module):
    """A frozen batch norm's four tensors under torch's names."""

    def __init__(self, c: int):
        super().__init__()
        for name in ("weight", "bias", "running_mean", "running_var"):
            setattr(self, name, nn.Parameter(torch.empty(c)))


class BasicConv2d(nn.Module):
    def __init__(self, cin: int, cout: int, kh: int, kw: int):
        super().__init__()
        self.conv = _Conv(cin, cout, kh, kw)
        self.bn = _BN(cout)


class _Node(nn.Module):
    """A block of the SPEC tree: its children by name."""

    def __init__(self, spec: dict):
        super().__init__()
        for k, v in spec.items():
            setattr(self, k, BasicConv2d(*v) if isinstance(v, tuple) else _Node(v))


class _FC(nn.Module):
    def __init__(self):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(NUM_LOGITS, POOL_DIM))
        self.bias = nn.Parameter(torch.empty(NUM_LOGITS))


class InceptionV3(_Node):
    def __init__(self):
        super().__init__(SPEC)
        self.fc = _FC()


def init_inception(seed: int = 0, device="cuda") -> InceptionV3:
    """Random weights with the JAX package's init distribution, from a
    torch.Generator: conv weights normal / sqrt(fan_in), batch norms the
    identity (scale 1, bias 0, mean 0, var 1), fc weights normal * 0.01 and
    bias 0. Raises if a card is asked for and none is present."""
    device = resolve_device(device)
    with torch.device("meta"):
        model = InceptionV3()
    model = model.to_empty(device=device)
    gen = torch.Generator(device=device).manual_seed(seed)
    with torch.no_grad():
        for path, (cin, _, kh, kw) in iter_conv_paths():
            mod = model.get_submodule(path)
            w = mod.conv.weight
            w.copy_(torch.randn(w.shape, generator=gen, device=device) / np.sqrt(cin * kh * kw))
            mod.bn.weight.fill_(1.0)
            mod.bn.bias.zero_()
            mod.bn.running_mean.zero_()
            mod.bn.running_var.fill_(1.0)
        model.fc.weight.copy_(torch.randn(model.fc.weight.shape, generator=gen,
                                          device=device) * 0.01)
        model.fc.bias.zero_()
    return model.eval().requires_grad_(False)


# ---------------------------------------------------------------------------
# Forward (NCHW, channels-last memory)
# ---------------------------------------------------------------------------

def _conv_bn(p: BasicConv2d, x: torch.Tensor, stride: int = 1, pad=(0, 0)) -> torch.Tensor:
    y = F.conv2d(x, p.conv.weight.to(x.dtype), stride=stride, padding=pad)
    inv = torch.rsqrt(p.bn.running_var.float() + BN_EPS)
    scale = (p.bn.weight.float() * inv).to(x.dtype)
    shift = (p.bn.bias.float() - p.bn.running_mean.float() * p.bn.weight.float() * inv
             ).to(x.dtype)
    return F.relu(y * scale[:, None, None] + shift[:, None, None])


def _same(kh: int, kw: int):
    return kh // 2, kw // 2


def _avg_pool_nopad(x: torch.Tensor) -> torch.Tensor:
    """3x3 stride-1 average pool, the zero padding left out of the count."""
    return F.avg_pool2d(x, 3, 1, padding=1, count_include_pad=False)


def _block_a(p, x):
    b1 = _conv_bn(p.branch1x1, x)
    b5 = _conv_bn(p.branch5x5_2, _conv_bn(p.branch5x5_1, x), pad=_same(5, 5))
    b3 = _conv_bn(p.branch3x3dbl_1, x)
    b3 = _conv_bn(p.branch3x3dbl_2, b3, pad=_same(3, 3))
    b3 = _conv_bn(p.branch3x3dbl_3, b3, pad=_same(3, 3))
    bp = _conv_bn(p.branch_pool, _avg_pool_nopad(x))
    return torch.cat([b1, b5, b3, bp], dim=1)


def _block_b(p, x):
    b3 = _conv_bn(p.branch3x3, x, stride=2)
    bd = _conv_bn(p.branch3x3dbl_1, x)
    bd = _conv_bn(p.branch3x3dbl_2, bd, pad=_same(3, 3))
    bd = _conv_bn(p.branch3x3dbl_3, bd, stride=2)
    return torch.cat([b3, bd, F.max_pool2d(x, 3, 2)], dim=1)


def _block_c(p, x):
    p17, p71 = _same(1, 7), _same(7, 1)
    b1 = _conv_bn(p.branch1x1, x)
    b7 = _conv_bn(p.branch7x7_1, x)
    b7 = _conv_bn(p.branch7x7_2, b7, pad=p17)
    b7 = _conv_bn(p.branch7x7_3, b7, pad=p71)
    bd = _conv_bn(p.branch7x7dbl_1, x)
    bd = _conv_bn(p.branch7x7dbl_2, bd, pad=p71)
    bd = _conv_bn(p.branch7x7dbl_3, bd, pad=p17)
    bd = _conv_bn(p.branch7x7dbl_4, bd, pad=p71)
    bd = _conv_bn(p.branch7x7dbl_5, bd, pad=p17)
    bp = _conv_bn(p.branch_pool, _avg_pool_nopad(x))
    return torch.cat([b1, b7, bd, bp], dim=1), b1


def _block_d(p, x):
    b3 = _conv_bn(p.branch3x3_2, _conv_bn(p.branch3x3_1, x), stride=2)
    b7 = _conv_bn(p.branch7x7x3_1, x)
    b7 = _conv_bn(p.branch7x7x3_2, b7, pad=_same(1, 7))
    b7 = _conv_bn(p.branch7x7x3_3, b7, pad=_same(7, 1))
    b7 = _conv_bn(p.branch7x7x3_4, b7, stride=2)
    return torch.cat([b3, b7, F.max_pool2d(x, 3, 2)], dim=1)


def _block_e(p, x, pool: str):
    b1 = _conv_bn(p.branch1x1, x)
    b3 = _conv_bn(p.branch3x3_1, x)
    b3 = torch.cat([_conv_bn(p.branch3x3_2a, b3, pad=_same(1, 3)),
                    _conv_bn(p.branch3x3_2b, b3, pad=_same(3, 1))], dim=1)
    bd = _conv_bn(p.branch3x3dbl_1, x)
    bd = _conv_bn(p.branch3x3dbl_2, bd, pad=_same(3, 3))
    bd = torch.cat([_conv_bn(p.branch3x3dbl_3a, bd, pad=_same(1, 3)),
                    _conv_bn(p.branch3x3dbl_3b, bd, pad=_same(3, 1))], dim=1)
    # Mixed_7c: a max pool here, as the TF graph has it
    pooled = F.max_pool2d(x, 3, 1, padding=1) if pool == "max" else _avg_pool_nopad(x)
    return torch.cat([b1, b3, bd, _conv_bn(p.branch_pool, pooled)], dim=1)


def resize_bilinear_tf1(x: torch.Tensor, out_h: int, out_w: int) -> torch.Tensor:
    """Legacy TF1 ResizeBilinear on NHWC float: src = dst * (in / out), no
    half-pixel shift, the upper neighbour clamped at the edge."""
    n, h, w, c = x.shape
    if (h, w) == (out_h, out_w):
        return x

    def axis_idx(in_size, out_size):
        src = torch.arange(out_size, dtype=torch.float32, device=x.device) * (in_size / out_size)
        i0 = torch.clamp(torch.floor(src).long(), 0, in_size - 1)
        i1 = torch.clamp(i0 + 1, max=in_size - 1)
        return i0, i1, src - i0.float()

    y0, y1, ty = axis_idx(h, out_h)
    x0, x1, tx = axis_idx(w, out_w)
    top, bot = x[:, y0], x[:, y1]
    rows = top + (bot - top) * ty[None, :, None, None]
    left, right = rows[:, :, x0], rows[:, :, x1]
    return left + (right - left) * tx[None, None, :, None]


def inception_features(model: InceptionV3, images, compute_dtype: torch.dtype = torch.float32
                       ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """images: NHWC in [0, 255] (uint8 or float; numpy or a tensor), any
    H x W, moved to the model's device. -> (pool3 (N, 2048), spatial
    (N, 2023), logits (N, 1008)), float32 on that device."""
    dev = model.fc.weight.device
    x = torch.as_tensor(images, device=dev).float()
    x = resize_bilinear_tf1(x, 299, 299)
    x = ((x - 128.0) / 128.0).to(compute_dtype)
    x = x.permute(0, 3, 1, 2).contiguous(memory_format=torch.channels_last)
    with torch.no_grad():
        x = _conv_bn(model.Conv2d_1a_3x3, x, stride=2)
        x = _conv_bn(model.Conv2d_2a_3x3, x)
        x = _conv_bn(model.Conv2d_2b_3x3, x, pad=(1, 1))
        x = F.max_pool2d(x, 3, 2)
        x = _conv_bn(model.Conv2d_3b_1x1, x)
        x = _conv_bn(model.Conv2d_4a_3x3, x)
        x = F.max_pool2d(x, 3, 2)
        x = _block_a(model.Mixed_5b, x)
        x = _block_a(model.Mixed_5c, x)
        x = _block_a(model.Mixed_5d, x)
        x = _block_b(model.Mixed_6a, x)
        x, _ = _block_c(model.Mixed_6b, x)
        x, _ = _block_c(model.Mixed_6c, x)
        x, b1_6d = _block_c(model.Mixed_6d, x)  # the TF graph's mixed_6/conv tower
        # NHWC order before the flattening, as the TF graph's tensor is laid out
        spatial = b1_6d[:, :7].permute(0, 2, 3, 1).float().reshape(len(x), -1)
        x, _ = _block_c(model.Mixed_6e, x)
        x = _block_d(model.Mixed_7a, x)
        x = _block_e(model.Mixed_7b, x, pool="avg")
        x = _block_e(model.Mixed_7c, x, pool="max")
        # the global average pool accumulates in fp32 and rounds to x's dtype
        pool3 = x.float().mean(dim=(2, 3)).to(x.dtype).float()
        logits = pool3 @ model.fc.weight.float().T  # no bias
    return pool3, spatial, logits


def _out_size(path: str) -> int:
    """A conv's output side at 299 px input."""
    block, leaf = path.split(".")[0], path.split(".")[-1]
    stem = {"Conv2d_1a_3x3": 149, "Conv2d_2a_3x3": 147, "Conv2d_2b_3x3": 147,
            "Conv2d_3b_1x1": 73, "Conv2d_4a_3x3": 71}
    if block in stem:
        return stem[block]
    if block == "Mixed_6a":
        return 17 if leaf in ("branch3x3", "branch3x3dbl_3") else 35
    if block == "Mixed_7a":
        return 8 if leaf in ("branch3x3_2", "branch7x7x3_4") else 17
    return {"Mixed_5": 35, "Mixed_6": 17, "Mixed_7": 8}[block[:7]]


def inception_flops(n: int) -> float:
    """Operations (2 x multiply-adds) of the convolutions and the fc for n
    images at 299 px."""
    convs = sum(2.0 * cin * cout * kh * kw * _out_size(path) ** 2
                for path, (cin, cout, kh, kw) in iter_conv_paths())
    return n * (convs + 2.0 * POOL_DIM * NUM_LOGITS)
