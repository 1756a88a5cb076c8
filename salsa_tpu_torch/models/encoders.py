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

`EINV2Encoder` (Cao et al., ICASSP 2021, arXiv:2010.13092; the port's own, with no
`salsa_tpu` counterpart): two branches of four `DoubleConvBlock`s, 64 / 128 /
256 / 512 wide and average-pooled (2,2), (2,2), (1,2), (1,2) over (time, freq),
the SED branch on the first `n_sed_channels` input channels, the DOA branch on
all of them, joined after each of the first three blocks by a cross-stitch unit.
It returns both branches' maps; float32 only.
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
from salsa_tpu_torch.utils.profiling import span


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


class CrossStitch(nn.Module):
    """A cross-stitch unit over two (B, C, T, F) maps: `alpha` (C, 2, 2), and
    sed' = alpha[:, 0, 0] sed + alpha[:, 0, 1] doa,
    doa' = alpha[:, 1, 0] sed + alpha[:, 1, 1] doa, a channel at a time, both from
    the unit's inputs."""

    def __init__(self, channels: int):
        super().__init__()
        self.alpha = nn.Parameter(torch.full((channels, 2, 2), 0.5))

    def forward(self, sed: torch.Tensor, doa: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        a = self.alpha[:, :, :, None, None]  # (C, 2, 2, 1, 1) against (B, C, T, F)
        return a[:, 0, 0] * sed + a[:, 0, 1] * doa, a[:, 1, 0] * sed + a[:, 1, 1] * doa


EINV2_WIDTHS = (64, 128, 256, 512)
EINV2_POOLS = ("avg", "avg", "avg_1x2", "avg_1x2")  # (2,2), (2,2), (1,2), (1,2)


class EINV2Encoder(nn.Module):
    """EINV2's two CNN branches: (B, C, T, F) -> (sed, doa), each
    (B, 512, T/4, F/16). Each cross-stitch unit runs inside a `model.stitch`
    span."""

    n_output_channels = EINV2_WIDTHS[-1]
    time_downsample_ratio = 4
    freq_downsample_ratio = 16
    flax_counterpart = False  # salsa_tpu has no EINV2

    def __init__(self, n_input_channels: int = 7, n_sed_channels: int = 4,
                 compute_dtype: str | None = None):
        super().__init__()
        if resolve_dtype(compute_dtype) is not None:
            raise ValueError(f"EINV2Encoder computes in float32 only, not '{compute_dtype}'")
        if not 0 < n_sed_channels <= n_input_channels:
            raise ValueError(f"n_sed_channels {n_sed_channels} is not within the "
                             f"{n_input_channels} input channels")
        self.n_sed_channels = n_sed_channels
        ins = (EINV2_WIDTHS[0], *EINV2_WIDTHS[:-1])
        self.sed_blocks = nn.ModuleList(
            DoubleConvBlock(n_sed_channels if i == 0 else c_in, c_out, pool)
            for i, (c_in, c_out, pool) in enumerate(zip(ins, EINV2_WIDTHS, EINV2_POOLS)))
        self.doa_blocks = nn.ModuleList(
            DoubleConvBlock(n_input_channels if i == 0 else c_in, c_out, pool)
            for i, (c_in, c_out, pool) in enumerate(zip(ins, EINV2_WIDTHS, EINV2_POOLS)))
        self.stitch = nn.ModuleList(CrossStitch(c) for c in EINV2_WIDTHS[:-1])

    def forward(self, x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        sed, doa = x[:, :self.n_sed_channels], x
        for i, (sed_block, doa_block) in enumerate(zip(self.sed_blocks, self.doa_blocks)):
            sed, doa = sed_block(sed), doa_block(doa)
            if i < len(self.stitch):
                with span("model.stitch"):
                    sed, doa = self.stitch[i](sed, doa)
        return sed, doa


ENCODERS = {"PannResNet22": PannResNet22, "PannResNet22TPU": PannResNet22TPU,
            "EINV2Encoder": EINV2Encoder}
