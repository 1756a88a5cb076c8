"""Seeded inputs made on the device: synthetic FOA and MIC clips, the model's
weights and the feature scaler, each from a `torch.Generator` in a few large calls.

A clip is diffuse noise (0.02 rms on each channel) plus one directional source:
a broadband burst (0.2 rms) and a tone of 300-3000 Hz, on for the first 3-7 s of
every 10 s. FOA clips hear it through first-order ambisonic gains of a random
azimuth and elevation (channels W, Y, Z, X); MIC clips hear it at each of the 4
mics 0-4 samples late. Every clip of a seed draws the same amount of randomness,
so two seeds make the same work.
"""
from __future__ import annotations

import numpy as np
import torch
from torch import nn

NOISE, BURST = 0.02, 0.2


def sub_seed(seed: int, *path: int) -> int:
    """A 63-bit seed for one stream of a run's randomness, from the run's seed and
    the stream's path."""
    return int(np.random.SeedSequence([int(seed), *path]).generate_state(1, np.uint64)[0] >> 1)


@torch.no_grad()
def clips(g: torch.Generator, n_clips: int, n_samples: int, fs: int, audio_format: str,
          device) -> torch.Tensor:
    """(n_clips, 4, n_samples) float32 clips on `device`."""
    out = NOISE * torch.randn((n_clips, 4, n_samples), generator=g, device=device)
    src = BURST * torch.randn((n_clips, n_samples), generator=g, device=device)
    u = torch.rand((n_clips, 8), generator=g, device=device, dtype=torch.float64)
    t = torch.arange(n_samples, device=device, dtype=torch.float64) / fs
    on_s, freq = 3.0 + 4.0 * u[:, 0:1], 300.0 + 2700.0 * u[:, 1:2]
    tone = torch.sin(2 * np.pi * freq * t)
    src = ((src + tone.float()) * ((t % 10.0) < on_s).float())
    if audio_format == "foa":
        azi, ele = np.pi * (2 * u[:, 2] - 1), 0.6 * (2 * u[:, 3] - 1)
        gains = torch.stack([torch.ones_like(azi), torch.sin(azi) * torch.cos(ele),
                             torch.sin(ele), torch.cos(azi) * torch.cos(ele)], dim=1).float()
        out += gains[:, :, None] * src[:, None, :]
    elif audio_format == "mic":
        delays = (5 * u[:, 4:8]).long().clamp(max=4).cpu().numpy()
        for b in range(n_clips):
            for m in range(4):
                d = int(delays[b, m])
                out[b, m, d:] += src[b, :n_samples - d]
    else:
        raise ValueError(f"unknown audio format '{audio_format}'")
    return out


@torch.no_grad()
def weights(model: nn.Module, seed: int, device) -> dict[str, torch.Tensor]:
    """Seeded float32 weights for every entry of `model`'s state_dict, with
    non-trivial BatchNorm statistics, drawn in one call on `device`: convs and
    linears uniform within the Xavier limit with biases within 0.05, BatchNorm
    scales in [0.8, 1.2], shifts within 0.1, running means within 0.17 and
    variances in [0.5, 1.5], GRU weights and biases within 1 / sqrt(H)."""
    sd = model.state_dict()
    floats = [k for k, v in sd.items() if v.is_floating_point()]
    u = torch.rand(sum(sd[k].numel() for k in floats),
                   generator=torch.Generator(device=device).manual_seed(seed), device=device)
    out, offset = {}, 0
    for k, v in sd.items():
        if not v.is_floating_point():
            out[k] = torch.zeros_like(v, device=device)
            continue
        x = u[offset:offset + v.numel()].view(v.shape)
        offset += v.numel()
        out[k] = _affine(k, v, x, model)
    return out


def _affine(name: str, v: torch.Tensor, x: torch.Tensor, model: nn.Module) -> torch.Tensor:
    """Uniform [0, 1) draws `x` mapped onto the range of the entry `name`."""
    def span(lo, hi):
        return lo + (hi - lo) * x

    owner, leaf = name.rsplit(".", 1)
    module = model.get_submodule(owner)
    if isinstance(module, nn.RNNBase):
        lim = 1.0 / float(np.sqrt(module.hidden_size))
        return span(-lim, lim)
    if isinstance(module, nn.modules.batchnorm._BatchNorm):
        return {"weight": lambda: span(0.8, 1.2), "bias": lambda: span(-0.1, 0.1),
                "running_mean": lambda: span(-0.17, 0.17),
                "running_var": lambda: span(0.5, 1.5)}[leaf]()
    if leaf == "weight":  # a conv or linear weight
        receptive = v[0, 0].numel()
        lim = float(np.sqrt(6.0 / ((v.shape[1] + v.shape[0]) * receptive)))
        return span(-lim, lim)
    return span(-0.05, 0.05)


@torch.no_grad()
def scaler(seed: int, n_features: int, device) -> tuple[torch.Tensor, torch.Tensor]:
    """A feature scaler (mean, std), each (4, 1, n_features): means in [-7, -3]
    dB, deviations in [5, 8] dB."""
    g = torch.Generator(device=device).manual_seed(seed)
    u = torch.rand((2, 4, 1, n_features), generator=g, device=device)
    return -7.0 + 4.0 * u[0], 5.0 + 3.0 * u[1]
