"""ResNet-50 visual backbone of the AVSBench baseline (B2_ResNet): the stem,
layers 1 and 2, and the layer3_1 / layer4_1 branch (or layer3_2 /
layer4_2); returns the 4-level channels-last pyramid {56x56x256,
28x28x512, 14x14x1024, 7x7x2048} at 224 px.

Counterpart of `avmoe_tpu/backbones/resnet.py:18-78` (`Bottleneck`,
`ResNetStage`, `B2ResNet`), same module names. Maps stay channels-last and
the convs read them through a channels-last view (`heads/avs.py`
`Conv2d`); BatchNorm is the port's (`ops/norm.py`), flax's momentum 0.9 on
the running statistics (torch's 0.1 convention). The max pool pads with
-inf, as flax's does. The JAX module builds a branch when it is called with
it; `B2ResNet(branches=...)` names the branches to build.
"""

from __future__ import annotations

from typing import List, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from avmoe_tpu_torch.heads.avs import Conv2d
from avmoe_tpu_torch.ops.norm import BatchNorm


def max_pool_3x3_s2(x: torch.Tensor) -> torch.Tensor:
    """flax max_pool((3, 3), (2, 2), padding 1) on channels-last maps."""
    return F.max_pool2d(x.permute(0, 3, 1, 2), 3, 2, 1).permute(0, 2, 3, 1)


class Bottleneck(nn.Module):
    expansion = 4

    def __init__(self, in_channels: int, features: int, stride: int = 1):
        super().__init__()
        out = features * self.expansion
        self.conv1 = Conv2d(in_channels, features, 1, bias=False)
        self.bn1 = BatchNorm(features)
        self.conv2 = Conv2d(features, features, 3, stride=stride, padding=1, bias=False)
        self.bn2 = BatchNorm(features)
        self.conv3 = Conv2d(features, out, 1, bias=False)
        self.bn3 = BatchNorm(out)
        self.downsample = in_channels != out or stride != 1
        if self.downsample:
            self.downsample_conv = Conv2d(in_channels, out, 1, stride=stride, bias=False)
            self.downsample_bn = BatchNorm(out)

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        y = F.relu(self.bn1(self.conv1(x), train))
        y = F.relu(self.bn2(self.conv2(y), train))
        y = self.bn3(self.conv3(y), train)
        if self.downsample:
            x = self.downsample_bn(self.downsample_conv(x), train)
        return F.relu(y + x)


class ResNetStage(nn.Module):
    def __init__(self, in_channels: int, features: int, blocks: int, stride: int = 1):
        super().__init__()
        self.blocks = []
        for i in range(blocks):
            b = Bottleneck(in_channels if i == 0 else features * Bottleneck.expansion, features,
                           stride if i == 0 else 1)
            self.add_module(f"block_{i}", b)
            self.blocks.append(b)

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        for b in self.blocks:
            x = b(x, train)
        return x


class B2ResNet(nn.Module):
    """Stem + layer1/2 shared; (layer3_1, layer4_1) and (layer3_2, layer4_2)
    branches. (B, H, W, 3) -> [x1, x2, x3, x4] channels-last, of `widths`
    channels."""

    widths = (256, 512, 1024, 2048)

    def __init__(self, depths: Sequence[int] = (3, 4, 6, 3), branches: Sequence[int] = (1,)):
        super().__init__()
        self.conv1 = Conv2d(3, 64, 7, stride=2, padding=3, bias=False)
        self.bn1 = BatchNorm(64)
        self.layer1 = ResNetStage(64, 64, depths[0], 1)
        self.layer2 = ResNetStage(256, 128, depths[1], 2)
        for b in branches:
            self.add_module(f"layer3_{b}", ResNetStage(512, 256, depths[2], 2))
            self.add_module(f"layer4_{b}", ResNetStage(1024, 512, depths[3], 2))

    def forward(self, x: torch.Tensor, train: bool = False, branch: int = 1
                ) -> List[torch.Tensor]:
        x = max_pool_3x3_s2(F.relu(self.bn1(self.conv1(x), train)))
        x1 = self.layer1(x, train)
        x2 = self.layer2(x1, train)
        x3 = getattr(self, f"layer3_{branch}")(x2, train)
        x4 = getattr(self, f"layer4_{branch}")(x3, train)
        return [x1, x2, x3, x4]
