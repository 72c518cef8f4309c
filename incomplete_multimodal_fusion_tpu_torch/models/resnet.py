"""ResNet backbone (JAX package models/resnet.py; reference backbone/
resnet.py:1-201, depths 18 / 34 / 50 / 101 / 152): the res2..res5 pyramid
of the CNN variant of the MaskFormer (MaskFormerModel.py:80-105).

NHWC in and out; the convolutions run on NCHW views. Batch norm is frozen
(``FrozenBatchNorm``: a learned per-channel ``scale`` and ``bias``, no
statistics). Every 3x3 convolution pads (1, 1) explicitly, as torch's
Conv2d(k=3, p=1) does at any stride (the JAX module's note at :27-29).
Submodules carry the flax names (``conv1``, ``bn1``, ``layer{s}_{b}``,
``downsample_conv``, ...). No TPU kernel computes any of it: plain PyTorch.
"""
from __future__ import annotations

from typing import List, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from .layers import Conv2d
from .vit_adapter import lecun_normal_


class FrozenBatchNorm(nn.Module):
    """x * scale + bias over the channel axis of an NCHW map
    (resnet.py:14-27); ``scale`` and ``bias`` are the flax leaves."""

    def __init__(self, channels: int):
        super().__init__()
        self.scale = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x * self.scale[:, None, None] + self.bias[:, None, None]


def _conv(cin: int, cout: int, k: int, stride: int = 1) -> Conv2d:
    return Conv2d(cin, cout, k, stride=stride, padding=k // 2, bias=False)


class BasicBlock(nn.Module):
    """Two 3x3 convolutions and the residual (resnet.py:30-50)."""

    expansion = 1

    def __init__(self, cin: int, features: int, stride: int = 1):
        super().__init__()
        self.conv1 = _conv(cin, features, 3, stride)
        self.bn1 = FrozenBatchNorm(features)
        self.conv2 = _conv(features, features, 3)
        self.bn2 = FrozenBatchNorm(features)
        if stride != 1 or cin != features:
            self.downsample_conv = _conv(cin, features, 1, stride)
            self.downsample_bn = FrozenBatchNorm(features)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.relu(self.bn1(self.conv1(x)))
        y = self.bn2(self.conv2(y))
        res = self.downsample_bn(self.downsample_conv(x)) if hasattr(self, "downsample_conv") else x
        return F.relu(y + res)


class Bottleneck(nn.Module):
    """1x1, 3x3 (strided), 1x1 to 4x the width, and the residual
    (resnet.py:52-76)."""

    expansion = 4

    def __init__(self, cin: int, features: int, stride: int = 1):
        super().__init__()
        out = features * self.expansion
        self.conv1 = _conv(cin, features, 1)
        self.bn1 = FrozenBatchNorm(features)
        self.conv2 = _conv(features, features, 3, stride)
        self.bn2 = FrozenBatchNorm(features)
        self.conv3 = _conv(features, out, 1)
        self.bn3 = FrozenBatchNorm(out)
        if stride != 1 or cin != out:
            self.downsample_conv = _conv(cin, out, 1, stride)
            self.downsample_bn = FrozenBatchNorm(out)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.relu(self.bn1(self.conv1(x)))
        y = F.relu(self.bn2(self.conv2(y)))
        y = self.bn3(self.conv3(y))
        res = self.downsample_bn(self.downsample_conv(x)) if hasattr(self, "downsample_conv") else x
        return F.relu(y + res)


RESNET_SPEC = {
    18: (BasicBlock, (2, 2, 2, 2)),
    34: (BasicBlock, (3, 4, 6, 3)),
    50: (Bottleneck, (3, 4, 6, 3)),
    101: (Bottleneck, (3, 4, 23, 3)),
    152: (Bottleneck, (3, 8, 36, 3)),
}
STAGE_WIDTHS = (64, 128, 256, 512)


class ResNet(nn.Module):
    """[res2, res3, res4, res5] NHWC at strides 4 / 8 / 16 / 32
    (resnet.py:87-108): a 7x7 / 2 stem, a 3x3 / 2 max-pool padded (1, 1),
    four stages."""

    def __init__(self, depth: int = 50, in_channels: int = 3):
        super().__init__()
        if depth not in RESNET_SPEC:
            raise ValueError(f"ResNet depth must be one of {sorted(RESNET_SPEC)}, got {depth}")
        block, layers = RESNET_SPEC[depth]
        self.layers = layers
        self.conv1 = Conv2d(in_channels, 64, 7, stride=2, padding=3, bias=False)
        self.bn1 = FrozenBatchNorm(64)
        cin = 64
        for stage, (n_blocks, feat) in enumerate(zip(layers, STAGE_WIDTHS)):
            for b in range(n_blocks):
                stride = 2 if (b == 0 and stage > 0) else 1
                self.add_module(f"layer{stage + 1}_{b}", block(cin, feat, stride))
                cin = feat * block.expansion
        self.out_channels: Tuple[int, ...] = tuple(w * block.expansion for w in STAGE_WIDTHS)

    def forward(self, x: torch.Tensor) -> List[torch.Tensor]:
        """x [B, H, W, C] -> 4 NHWC maps, high -> low resolution."""
        y = x.to(self.conv1.weight.dtype).permute(0, 3, 1, 2)
        y = F.relu(self.bn1(self.conv1(y)))
        y = F.max_pool2d(y, 3, 2, 1)
        feats = []
        for stage, n_blocks in enumerate(self.layers):
            for b in range(n_blocks):
                y = getattr(self, f"layer{stage + 1}_{b}")(y)
            feats.append(y.permute(0, 2, 3, 1))
        return feats

    def init_weights(self, generator: torch.Generator) -> None:
        """flax's defaults: lecun-normal kernels, unit scales, zero biases."""
        for m in self.modules():
            if isinstance(m, Conv2d):
                lecun_normal_(m.weight, generator)
            elif isinstance(m, FrozenBatchNorm):
                nn.init.ones_(m.scale)
                nn.init.zeros_(m.bias)
