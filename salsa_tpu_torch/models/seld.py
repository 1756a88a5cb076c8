"""SeldNet: encoder + decoder as one module (counterpart of
`salsa_tpu.models.seld`), `build_model` from config dicts, the index-repeat time
interpolation to label rate, the training initializer `init_train_` and a seeded
random initialization for runs without a checkpoint."""
from __future__ import annotations

from typing import Any

import numpy as np
import torch
from torch import nn

from salsa_tpu_torch.models.decoders import DECODERS
from salsa_tpu_torch.models.encoders import ENCODERS, CrossStitch
from salsa_tpu_torch.models.layers import (
    BatchNorm2d,
    ResNetBasicBlock,
    ResNetBottleneckBlock,
    SelfAttention,
    TransformerEncoderLayer,
)
from salsa_tpu_torch.utils.profiling import span


def interpolate_index_repeat(x: torch.Tensor, ratio: float) -> torch.Tensor:
    """Resample (B, T, ...) along time: out[t] = in[floor(t / ratio)]."""
    n_in = x.shape[1]
    ratio = float(ratio)
    n_out = int(round(n_in * ratio))
    if ratio >= 1 and abs(ratio - round(ratio)) < 1e-9:
        return torch.repeat_interleave(x, int(round(ratio)), dim=1)
    inv = 1.0 / ratio
    if ratio < 1 and abs(inv - round(inv)) < 1e-9:
        return x[:, :: int(round(inv))]
    idx = np.floor(np.arange(n_out) / ratio).astype(np.int64)
    return x[:, torch.from_numpy(idx).to(x.device)]


class SeldNet(nn.Module):
    """CRNN for SELD. Input (B, C, T, F), the dataset layout (NCHW)."""

    def __init__(self, encoder: nn.Module, decoder: nn.Module):
        super().__init__()
        self.encoder = encoder
        self.decoder = decoder

    @property
    def time_downsample_ratio(self) -> int:
        return self.encoder.time_downsample_ratio

    @property
    def flax_counterpart(self) -> bool:
        """Whether `salsa_tpu` has this model, so that its checkpoint is written
        as a flax tree (`interop.torch_state_dict_to_flax`)."""
        return getattr(self.encoder, "flax_counterpart", True)

    def forward(self, x: torch.Tensor) -> dict[str, torch.Tensor]:
        h = self.encoder(x)
        with span("model.decoder"):  # pooling, the recurrent or attention stack, the heads
            return self.decoder(h)


def build_model(
    encoder: dict[str, Any],
    decoder: dict[str, Any],
    n_classes: int = 12,
    output_format: str = "reg_xyz",
) -> SeldNet:
    """Registry-based construction from config dicts, as `salsa_tpu.models.seld`."""
    enc = dict(encoder)
    dec = dict(decoder)
    enc_name = enc.pop("name", "PannResNet22")
    dec_name = dec.pop("name", "SeldDecoder")
    if enc_name not in ENCODERS:
        raise ValueError(f"unknown encoder '{enc_name}'")
    dec.setdefault("n_classes", n_classes)
    dec.setdefault("output_format", output_format)
    enc_mod = ENCODERS[enc_name](**enc)
    dec.setdefault("n_output_channels", enc_mod.n_output_channels)
    return SeldNet(enc_mod, DECODERS[dec_name](**dec))


def _rnn_gate_blocks(p: torch.Tensor, n_gates: int, orthogonal_last: bool,
                     generator: torch.Generator) -> torch.Tensor:
    """salsa_tpu's recurrent init of one torch weight (n_gates * H, fan_in): each
    gate's block uniform(+-sqrt(3 / fan_in)), the last one orthogonal where asked
    (`rnn.py:22-38`)."""
    h = p.shape[0] // n_gates
    lim = float(np.sqrt(3.0 / p.shape[1]))  # fan_in: the gate's inputs
    blocks = [torch.empty(h, p.shape[1]).uniform_(-lim, lim, generator=generator)
              for _ in range(n_gates)]
    if orthogonal_last:
        blocks[-1] = nn.init.orthogonal_(torch.empty(h, p.shape[1]), generator=generator)
    return torch.cat(blocks, dim=0)


def _lecun_normal(shape, fan_in: int, generator: torch.Generator) -> torch.Tensor:
    """flax's default kernel init: a normal truncated at +-2 sigma, scaled to
    variance 1 / fan_in."""
    std = float(np.sqrt(1.0 / fan_in)) / 0.87962566103423978
    return nn.init.trunc_normal_(torch.empty(shape), std=std, a=-2 * std, b=2 * std,
                                 generator=generator)


@torch.no_grad()
def init_train_(model: nn.Module, generator: torch.Generator) -> nn.Module:
    """A fresh model for training with `salsa_tpu`'s initializers: Xavier-uniform
    convs and head linears with zero biases (`layers.py:43`, `decoders.py:73-76`),
    BatchNorm scale 1 and shift 0 with running statistics (0, 1), the scale of each
    residual block's last BatchNorm zero (`layers.py:91-93`, `:135-136`), each GRU
    or LSTM gate's block uniform(+-sqrt(3 / fan_in)) but the recurrent weight's
    last block orthogonal, recurrent biases zero (`rnn.py:7-38`, `:51-54`); in the
    transformer flax's defaults: attention and feed-forward kernels lecun-normal
    with zero biases, LayerNorm scale 1 and shift 0. EINV2's cross-stitch
    parameters uniform on [0.1, 0.9) (the port's choice). Draws on CPU from
    `generator`, then copies in place."""
    def fill(t, draw):
        t.copy_(draw(torch.empty(t.shape, dtype=t.dtype)))

    transformer = {id(m) for layer in model.modules()
                   if isinstance(layer, TransformerEncoderLayer) for m in layer.modules()}
    for m in model.modules():
        if id(m) in transformer and isinstance(m, nn.Linear):
            m.weight.copy_(_lecun_normal(m.weight.shape, m.in_features, generator))
            m.bias.zero_()
        elif isinstance(m, SelfAttention):
            m.in_proj_weight.copy_(_lecun_normal(m.in_proj_weight.shape,
                                                 m.in_proj_weight.shape[1], generator))
            m.in_proj_bias.zero_()
        elif isinstance(m, (nn.Conv2d, nn.Linear)):
            fill(m.weight, lambda t: nn.init.xavier_uniform_(t, generator=generator))
            if m.bias is not None:
                m.bias.zero_()
        elif isinstance(m, (BatchNorm2d, nn.LayerNorm)):
            m.reset_parameters()
        elif isinstance(m, CrossStitch):
            fill(m.alpha, lambda t: t.uniform_(0.1, 0.9, generator=generator))
        elif isinstance(m, (nn.GRU, nn.LSTM)):
            n_gates = 3 if isinstance(m, nn.GRU) else 4
            for name, p in m.named_parameters():
                if name.startswith("bias"):
                    p.zero_()
                else:
                    p.copy_(_rnn_gate_blocks(p, n_gates, name.startswith("weight_hh"),
                                             generator))
    for m in model.modules():
        if isinstance(m, (ResNetBasicBlock, ResNetBottleneckBlock)):
            m.last_bn.weight.zero_()
    return model


@torch.no_grad()
def init_random_(model: nn.Module, generator: torch.Generator) -> nn.Module:
    """Seeded random weights with non-trivial BatchNorm statistics (for runs that
    have no trained checkpoint): Xavier-uniform convs, linears and attention
    projections, small biases, BN and LayerNorm scale/shift near (1, 0), BN
    running stats away from (0, 1), GRU and LSTM weights uniform(+-1/sqrt(H)),
    cross-stitch parameters uniform on [0.1, 0.9). Draws on CPU from
    `generator`, then copies in place."""
    def fill(t, draw):
        t.copy_(draw(torch.empty(t.shape, dtype=t.dtype)))

    def xavier(weight, bias):
        fan_in, fan_out = nn.init._calculate_fan_in_and_fan_out(weight)
        lim = float(np.sqrt(6.0 / (fan_in + fan_out)))
        fill(weight, lambda t: t.uniform_(-lim, lim, generator=generator))
        if bias is not None:
            fill(bias, lambda t: t.uniform_(-0.05, 0.05, generator=generator))

    for m in model.modules():
        if isinstance(m, (nn.Conv2d, nn.Linear)):
            xavier(m.weight, m.bias)
        elif isinstance(m, SelfAttention):
            xavier(m.in_proj_weight, m.in_proj_bias)
        elif isinstance(m, (nn.BatchNorm2d, nn.LayerNorm)):
            fill(m.weight, lambda t: t.uniform_(0.8, 1.2, generator=generator))
            fill(m.bias, lambda t: t.uniform_(-0.1, 0.1, generator=generator))
            if isinstance(m, nn.BatchNorm2d):
                fill(m.running_mean, lambda t: t.normal_(0.0, 0.1, generator=generator))
                fill(m.running_var, lambda t: t.uniform_(0.5, 1.5, generator=generator))
        elif isinstance(m, CrossStitch):
            fill(m.alpha, lambda t: t.uniform_(0.1, 0.9, generator=generator))
        elif isinstance(m, (nn.GRU, nn.LSTM)):
            lim = 1.0 / float(np.sqrt(m.hidden_size))
            for p in m.parameters():
                fill(p, lambda t: t.uniform_(-lim, lim, generator=generator))
    return model
