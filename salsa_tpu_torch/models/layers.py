"""Conv blocks and ResNet blocks (counterpart of `salsa_tpu.models.layers`), NCHW.

Module attribute names are the reference's torch names (`conv1`, `bn1`, ...,
`downsample`, `layer1`...), which are the keys `interop.flax_to_torch_state_dict`
emits (as `salsa_tpu.interop.torch_export` does), so flax weights load with
strict=True. The flax `ConvBnRelu` submodule therefore has no module of
its own here: the reference flattens it into `convN`/`bnN` pairs, applied by
`conv_bn_relu`.

Reference quirks kept: pre-conv 2x2 average pool in stride-2 blocks, dropout 0.1
inside every basic block, avgpool + 1x1 conv + BN shortcut. Flax
BatchNorm(momentum=0.9, epsilon=1e-5) is torch momentum=0.1, eps=1e-5.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn


def conv3x3(in_features: int, features: int) -> nn.Conv2d:
    """3x3 conv, flax 'SAME' padding, no bias."""
    return nn.Conv2d(in_features, features, 3, padding=1, bias=False)


def batch_norm(features: int) -> nn.BatchNorm2d:
    return nn.BatchNorm2d(features, eps=1e-5, momentum=0.1)


def conv_bn_relu(x: torch.Tensor, conv: nn.Conv2d, bn: nn.BatchNorm2d) -> torch.Tensor:
    """The flax `ConvBnRelu` block: relu(bn(conv(x)))."""
    return F.relu(bn(conv(x)))


class DoubleConvBlock(nn.Module):
    """Two 3x3 conv+BN+relu followed by 2x2 average pooling (reference ConvBlock
    as PannResNet22 uses it)."""

    def __init__(self, in_features: int, features: int):
        super().__init__()
        self.conv1 = conv3x3(in_features, features)
        self.bn1 = batch_norm(features)
        self.conv2 = conv3x3(features, features)
        self.bn2 = batch_norm(features)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = conv_bn_relu(x, self.conv1, self.bn1)
        return F.avg_pool2d(conv_bn_relu(x, self.conv2, self.bn2), 2)


class ResNetBasicBlock(nn.Module):
    def __init__(self, in_features: int, features: int, stride: int = 1,
                 use_shortcut_proj: bool = False):
        super().__init__()
        self.stride = stride
        self.conv1 = conv3x3(in_features, features)
        self.bn1 = batch_norm(features)
        self.dropout = nn.Dropout(0.1)
        self.conv2 = conv3x3(features, features)
        self.bn2 = batch_norm(features)  # zero-initialized scale in the flax module
        self.downsample = None
        if use_shortcut_proj:
            proj = [nn.Conv2d(in_features, features, 1, bias=False), batch_norm(features)]
            if stride == 2:
                proj.insert(0, nn.AvgPool2d(2))  # keys downsample.1 / downsample.2
            self.downsample = nn.Sequential(*proj)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out = F.avg_pool2d(x, 2) if self.stride == 2 else x
        out = self.dropout(conv_bn_relu(out, self.conv1, self.bn1))
        out = self.bn2(self.conv2(out))
        identity = x if self.downsample is None else self.downsample(x)
        return F.relu(out + identity)


class ResNetTrunk(nn.Module):
    """Four stages of two basic blocks, widths [64,128,256,512], first stage
    stride 1, the others stride 2 with a projected shortcut."""

    WIDTHS = (64, 128, 256, 512)

    def __init__(self, in_features: int = 64):
        super().__init__()
        for stage, width in enumerate(self.WIDTHS):
            stride = 1 if stage == 0 else 2
            first = ResNetBasicBlock(in_features, width, stride=stride,
                                     use_shortcut_proj=stride != 1 or in_features != width)
            setattr(self, f"layer{stage + 1}",
                    nn.Sequential(first, ResNetBasicBlock(width, width)))
            in_features = width

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for stage in range(len(self.WIDTHS)):
            x = getattr(self, f"layer{stage + 1}")(x)
        return x
