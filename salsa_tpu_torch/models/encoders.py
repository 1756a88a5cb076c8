"""CNN encoders (counterpart of `salsa_tpu.models.encoders`). `PannResNet22`:
ConvBlock(n_in -> 64, 2x2 avgpool), dropout p_dropout (training mode only), then a
[2,2,2,2] basic-block ResNet; output
stride 16 in time, 8 in frequency, 512 channels. Layout NCHW (B, C, T, F)."""
from __future__ import annotations

import torch
from torch import nn

from salsa_tpu_torch.models.layers import DoubleConvBlock, Dropout, ResNetTrunk


class PannResNet22(nn.Module):
    n_output_channels = 512
    time_downsample_ratio = 16
    freq_downsample_ratio = 8

    def __init__(self, n_input_channels: int = 7, p_dropout: float = 0.0,
                 compute_dtype: str | None = None):
        super().__init__()
        if compute_dtype is not None:
            raise NotImplementedError(
                "compute_dtype (bf16 autocast) is not ported yet: ROADMAP queue 1, slice 4")
        self.conv_block1 = DoubleConvBlock(n_input_channels, 64)
        self.dropout = Dropout(p_dropout)  # salsa_tpu's FastDropout after the stem
        self.resnet = ResNetTrunk()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """x: (B, C, T, F) -> (B, 512, T/16, F/8)."""
        return self.resnet(self.dropout(self.conv_block1(x)))


ENCODERS = {"PannResNet22": PannResNet22}
