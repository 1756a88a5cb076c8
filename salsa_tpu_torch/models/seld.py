"""SeldNet: encoder + decoder as one module (counterpart of
`salsa_tpu.models.seld`), `build_model` from config dicts, the index-repeat time
interpolation to label rate, and a seeded random initialization."""
from __future__ import annotations

from typing import Any

import numpy as np
import torch
from torch import nn

from salsa_tpu_torch.models.decoders import DECODERS
from salsa_tpu_torch.models.encoders import ENCODERS


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

    def forward(self, x: torch.Tensor) -> dict[str, torch.Tensor]:
        return self.decoder(self.encoder(x))


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
        raise NotImplementedError(f"encoder '{enc_name}' is not ported yet "
                                  "(PannResNet22TPU: ROADMAP queue 1, slice 2)")
    dec.setdefault("n_classes", n_classes)
    dec.setdefault("output_format", output_format)
    enc_mod = ENCODERS[enc_name](**enc)
    dec.setdefault("n_output_channels", enc_mod.n_output_channels)
    return SeldNet(enc_mod, DECODERS[dec_name](**dec))


@torch.no_grad()
def init_random_(model: nn.Module, generator: torch.Generator) -> nn.Module:
    """Seeded random weights with non-trivial BatchNorm statistics (for runs that
    have no trained checkpoint): Xavier-uniform convs and linears, small biases,
    BN scale/shift near (1, 0) and running stats away from (0, 1), GRU weights
    uniform(+-1/sqrt(H)). Draws on CPU from `generator`, then copies in place."""
    def fill(t, draw):
        t.copy_(draw(torch.empty(t.shape, dtype=t.dtype)))

    for m in model.modules():
        if isinstance(m, (nn.Conv2d, nn.Linear)):
            fan_in, fan_out = nn.init._calculate_fan_in_and_fan_out(m.weight)
            lim = float(np.sqrt(6.0 / (fan_in + fan_out)))
            fill(m.weight, lambda t: t.uniform_(-lim, lim, generator=generator))
            if m.bias is not None:
                fill(m.bias, lambda t: t.uniform_(-0.05, 0.05, generator=generator))
        elif isinstance(m, nn.BatchNorm2d):
            fill(m.weight, lambda t: t.uniform_(0.8, 1.2, generator=generator))
            fill(m.bias, lambda t: t.uniform_(-0.1, 0.1, generator=generator))
            fill(m.running_mean, lambda t: t.normal_(0.0, 0.1, generator=generator))
            fill(m.running_var, lambda t: t.uniform_(0.5, 1.5, generator=generator))
        elif isinstance(m, nn.GRU):
            lim = 1.0 / float(np.sqrt(m.hidden_size))
            for p in m.parameters():
                fill(p, lambda t: t.uniform_(-lim, lim, generator=generator))
    return model
