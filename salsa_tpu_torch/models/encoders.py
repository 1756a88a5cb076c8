"""CNN encoders (counterpart of `salsa_tpu.models.encoders`), layout NCHW
(B, C, T, F); output stride 16 in time, 8 in frequency, 512 channels.

`PannResNet22`: ConvBlock(n_in -> 64, 2x2 avgpool), dropout p_dropout (training
mode only), then a [2,2,2,2] basic-block ResNet. `PannResNet22TPU`: the same
parameters under the same names, but the stem's 2x2 average pool moves before
its two convs (`DoubleConvBlock(pool_type='none')`), so they run at a quarter of
the resolution: another network on the same tree. A checkpoint of one loads
strictly into the other, so the encoder is always built from the experiment's
config, never guessed from the weights.

`compute_dtype` ('bfloat16'): the input is cast to it and every conv, BatchNorm,
pool and residual add runs flax's bf16 arithmetic (`models.layers`); the output
is in that dtype. None or 'float32': float32 throughout.
"""
from __future__ import annotations

import torch
from torch import nn

from salsa_tpu_torch.models.layers import (
    DoubleConvBlock,
    Dropout,
    ResNetTrunk,
    avg_pool_2x2,
    resolve_dtype,
)


class PannResNet22(nn.Module):
    n_output_channels = 512
    time_downsample_ratio = 16
    freq_downsample_ratio = 8
    pre_pool = False  # the stem pools after its convs

    def __init__(self, n_input_channels: int = 7, p_dropout: float = 0.0,
                 compute_dtype: str | None = None):
        super().__init__()
        self.compute_dtype = resolve_dtype(compute_dtype)
        self.conv_block1 = DoubleConvBlock(n_input_channels, 64,
                                           pool_type="none" if self.pre_pool else "avg",
                                           compute_dtype=self.compute_dtype)
        self.dropout = Dropout(p_dropout)  # salsa_tpu's FastDropout after the stem
        self.resnet = ResNetTrunk(compute_dtype=self.compute_dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """x: (B, C, T, F) -> (B, 512, T/16, F/8)."""
        if self.compute_dtype is not None:
            x = x.to(self.compute_dtype)
        if self.pre_pool:
            x = avg_pool_2x2(x)
        return self.resnet(self.dropout(self.conv_block1(x)))


class PannResNet22TPU(PannResNet22):
    """PannResNet22 with the stem's 2x2 average pool before its convs."""

    pre_pool = True


ENCODERS = {"PannResNet22": PannResNet22, "PannResNet22TPU": PannResNet22TPU}
