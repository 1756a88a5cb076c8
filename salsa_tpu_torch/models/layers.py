"""Conv blocks and ResNet blocks (counterpart of `salsa_tpu.models.layers`), NCHW.

Module attribute names are the reference's torch names (`conv1`, `bn1`, ...,
`downsample`, `layer1`...), which are the keys `interop.flax_to_torch_state_dict`
emits (as `salsa_tpu.interop.torch_export` does), so flax weights load with
strict=True. The flax `ConvBnRelu` submodule therefore has no module of
its own here: the reference flattens it into `convN`/`bnN` pairs, applied by
`conv_bn_relu`.

Reference quirks kept: pre-conv 2x2 average pool in stride-2 blocks, dropout 0.1
inside every basic block, avgpool + 1x1 conv + BN shortcut.

Training mode follows flax, not torch: `BatchNorm2d` moves its running statistics
as flax's BatchNorm(momentum=0.9, epsilon=1e-5) does, with the biased batch
variance mean(x^2) - mean(x)^2 (torch's own update takes the unbiased one), and
`Dropout` draws its keep mask from an explicit torch.Generator (`generator`, set
by the trainer; torch's default generator when unset).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn


def conv3x3(in_features: int, features: int) -> nn.Conv2d:
    """3x3 conv, flax 'SAME' padding, no bias."""
    return nn.Conv2d(in_features, features, 3, padding=1, bias=False)


FLAX_BN_MOMENTUM = 0.9


class BatchNorm2d(nn.BatchNorm2d):
    """nn.BatchNorm2d (same parameters, buffers and eval mode) whose training mode
    normalizes by the batch statistics and then moves the running statistics as
    flax does: ra = 0.9 ra + (1 - 0.9) batch, with the batch variance
    max(mean(x^2) - mean(x)^2, 0) over (N, H, W)."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training:
            return super().forward(x)
        y = F.batch_norm(x, None, None, self.weight, self.bias, True, 0.0, self.eps)
        with torch.no_grad():
            mean = x.mean(dim=(0, 2, 3))
            var = torch.clamp((x * x).mean(dim=(0, 2, 3)) - mean * mean, min=0.0)
            m = FLAX_BN_MOMENTUM
            self.running_mean.copy_(m * self.running_mean + (1.0 - m) * mean)
            self.running_var.copy_(m * self.running_var + (1.0 - m) * var)
            self.num_batches_tracked.add_(1)
        return y


def batch_norm(features: int) -> BatchNorm2d:
    return BatchNorm2d(features, eps=1e-5, momentum=0.1)


class Dropout(nn.Module):
    """Inverted dropout (survivors scaled by 1 / (1 - p)) in training mode only,
    its keep mask drawn from `generator` on the input's device."""

    def __init__(self, p: float):
        super().__init__()
        self.p = float(p)
        self.generator: torch.Generator | None = None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training or self.p == 0.0:
            return x
        keep = torch.rand(x.shape, generator=self.generator, device=x.device) >= self.p
        return torch.where(keep, x * (1.0 / (1.0 - self.p)), torch.zeros((), dtype=x.dtype,
                                                                          device=x.device))

    def extra_repr(self) -> str:
        return f"p={self.p}"


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
        self.dropout = Dropout(0.1)
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
