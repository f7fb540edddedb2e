"""DeepLabV3 (ResNetV1c-D8 + ASPP) in mmseg's key layout (the JAX package's
torch module `eval/deeplabv3.py`, kept as the port's own copy).

The reference scores COCOStuff-171 mIoU with mmseg's
`deeplabv3_r101-d8_512x512_4x4_320k_coco-stuff164k` checkpoint. This
module is the inference graph of that config with mmseg's module names
(ResNetV1c / ASPPHead), so the released `.pth` loads by identity
(`convert_mmseg.load_mmseg_deeplabv3`).

Structure (mmseg configs/_base_/models/deeplabv3_r50-d8.py + depth 101):
  backbone: ResNetV1c (deep 3x3 stem), strides (1,2,1,1), dilations
      (1,1,2,4), contract_dilation=True (the first block of a dilated stage
      uses dilation//2), BN frozen at eval.
  decode_head: ASPPHead, in 2048 -> 512 channels, dilations (1,12,24,36),
      global image pool branch, 3x3 bottleneck over the 5-way concat,
      dropout(0.1) [inert at eval], 1x1 conv_seg; logits bilinearly resized
      to the input, align_corners=False.
  auxiliary_head: training-only (FCNHead); its keys are ignored at load.

Test protocol (the config's test_pipeline): Resize(scale=(2048, 512),
keep_ratio=True) + ImageNet mean / std, mode='whole'
(`convert_mmseg.load_mmseg_segmenter`).
"""
from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F


class ConvModule(nn.Module):
    """mmcv ConvModule (conv + bn + relu) with mmseg's key names."""

    def __init__(self, cin, cout, k, dilation=1, padding=None):
        super().__init__()
        if padding is None:
            padding = dilation if k == 3 else 0
        self.conv = nn.Conv2d(cin, cout, k, padding=padding,
                              dilation=dilation, bias=False)
        self.bn = nn.BatchNorm2d(cout)

    def forward(self, x):
        return F.relu(self.bn(self.conv(x)), inplace=True)


class Bottleneck(nn.Module):
    expansion = 4

    def __init__(self, cin, planes, stride=1, dilation=1, downsample=None):
        super().__init__()
        self.conv1 = nn.Conv2d(cin, planes, 1, bias=False)
        self.bn1 = nn.BatchNorm2d(planes)
        # mmseg style='pytorch': stride on conv2
        self.conv2 = nn.Conv2d(planes, planes, 3, stride=stride,
                               padding=dilation, dilation=dilation, bias=False)
        self.bn2 = nn.BatchNorm2d(planes)
        self.conv3 = nn.Conv2d(planes, planes * 4, 1, bias=False)
        self.bn3 = nn.BatchNorm2d(planes * 4)
        self.downsample = downsample

    def forward(self, x):
        idn = x if self.downsample is None else self.downsample(x)
        out = F.relu(self.bn1(self.conv1(x)), inplace=True)
        out = F.relu(self.bn2(self.conv2(out)), inplace=True)
        out = self.bn3(self.conv3(out))
        return F.relu(out + idn, inplace=True)


class ResNetV1c(nn.Module):
    """mmseg ResNetV1c-D8: deep stem, output stride 8.

    depth 101 -> blocks (3, 4, 23, 3). `contract_dilation` per mmseg
    ResLayer: the first block of a stage with dilation > 1 uses dilation//2.
    """

    def __init__(self, depth=101, base_channels=64,
                 strides=(1, 2, 1, 1), dilations=(1, 1, 2, 4)):
        super().__init__()
        blocks = {50: (3, 4, 6, 3), 101: (3, 4, 23, 3)}[depth]
        c = base_channels
        self.stem = nn.Sequential(
            nn.Conv2d(3, c // 2, 3, stride=2, padding=1, bias=False),
            nn.BatchNorm2d(c // 2), nn.ReLU(inplace=True),
            nn.Conv2d(c // 2, c // 2, 3, padding=1, bias=False),
            nn.BatchNorm2d(c // 2), nn.ReLU(inplace=True),
            nn.Conv2d(c // 2, c, 3, padding=1, bias=False),
            nn.BatchNorm2d(c), nn.ReLU(inplace=True),
        )
        self.maxpool = nn.MaxPool2d(3, stride=2, padding=1)
        cin = c
        for i, (n, stride, dilation) in enumerate(
                zip(blocks, strides, dilations), start=1):
            planes = c * (2 ** (i - 1))
            layers = []
            for j in range(n):
                d = dilation
                if dilation > 1 and j == 0:
                    d = dilation // 2  # contract_dilation
                s = stride if j == 0 else 1
                down = None
                if j == 0 and (s != 1 or cin != planes * 4):
                    down = nn.Sequential(
                        nn.Conv2d(cin, planes * 4, 1, stride=s, bias=False),
                        nn.BatchNorm2d(planes * 4),
                    )
                layers.append(Bottleneck(cin, planes, s, d, down))
                cin = planes * 4
            setattr(self, f"layer{i}", nn.Sequential(*layers))
        self.out_channels = cin

    def forward(self, x):
        x = self.maxpool(self.stem(x))
        x = self.layer1(x)
        x = self.layer2(x)
        x = self.layer3(x)
        return self.layer4(x)


class ASPPHead(nn.Module):
    """mmseg ASPPHead with its exact key layout (image_pool.1 is the
    ConvModule; index 0 is the parameterless adaptive pool)."""

    def __init__(self, in_channels=2048, channels=512, num_classes=171,
                 dilations=(1, 12, 24, 36)):
        super().__init__()
        self.image_pool = nn.Sequential(
            nn.AdaptiveAvgPool2d(1), ConvModule(in_channels, channels, 1))
        self.aspp_modules = nn.ModuleList(
            ConvModule(in_channels, channels, 1 if d == 1 else 3, dilation=d)
            for d in dilations)
        self.bottleneck = ConvModule(
            channels * (len(dilations) + 1), channels, 3)
        self.conv_seg = nn.Conv2d(channels, num_classes, 1)

    def forward(self, x):
        size = x.shape[2:]
        pool = F.interpolate(self.image_pool(x), size=size, mode="bilinear",
                             align_corners=False)
        feats = [pool] + [m(x) for m in self.aspp_modules]
        out = self.bottleneck(torch.cat(feats, dim=1))
        return self.conv_seg(out)  # dropout(0.1) is inert at eval


class DeepLabV3(nn.Module):
    """backbone + decode_head, attribute names = mmseg checkpoint prefixes."""

    def __init__(self, depth=101, num_classes=171, base_channels=64,
                 head_channels=512):
        super().__init__()
        self.backbone = ResNetV1c(depth=depth, base_channels=base_channels)
        self.decode_head = ASPPHead(
            in_channels=self.backbone.out_channels, channels=head_channels,
            num_classes=num_classes)

    def forward(self, x):
        logits = self.decode_head(self.backbone(x))
        return F.interpolate(logits, size=x.shape[2:], mode="bilinear",
                             align_corners=False)
