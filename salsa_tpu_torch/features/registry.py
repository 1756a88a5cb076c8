"""Feature registry (counterpart of `salsa_tpu.features.registry`), salsa branch.

`make_extractor` returns a `FeatureExtractor` whose call maps a batch of waves
(B, n_ch, n_samples) to features (B, C, T, F) on the waves' device. The other
feature types of `salsa_tpu` raise NotImplementedError until they are ported.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from functools import partial
from typing import Callable

import torch

from salsa_tpu_torch.features.salsa import SalsaParams, extract_salsa

FEATURE_REGISTRY = (
    "salsa", "salsa_lite", "salsa_ipd",
    "linspeciv", "melspeciv", "linspecgcc", "melspecgcc", "melspec",
)


@dataclass
class FeatureExtractor:
    """A feature extractor with its metadata."""

    name: str
    audio_format: str
    n_channels: int          # channels in the produced feature map
    n_features: int          # freq dimension of the produced feature map
    n_spec_channels: int     # leading channels that are dB-spectrograms (scaler scope)
    description: str         # directory-naming string (parity with reference layout)
    fn: Callable[[torch.Tensor], torch.Tensor] = field(repr=False)

    def __call__(self, waves: torch.Tensor) -> torch.Tensor:
        return self.fn(waves)


def make_extractor(
    feature_type: str,
    audio_format: str,
    fs: int = 24000,
    n_fft: int = 512,
    hop_length: int = 300,
    win_length: int | None = None,
    fmin_doa: float = 50.0,
    fmax_doa: float | None = None,
    condition_number: float = 5.0,
    n_hopframes: int = 3,
    is_tracking: bool = True,
    compress_high_freq: bool = True,
) -> FeatureExtractor:
    if feature_type != "salsa":
        if feature_type in FEATURE_REGISTRY:
            raise NotImplementedError(
                f"feature type '{feature_type}' is not ported yet: ROADMAP queue 1, "
                "slice 5 (rest of the feature bank)")
        raise ValueError(f"unknown feature type '{feature_type}'")
    if not is_tracking:
        raise NotImplementedError(
            "is_tracking=False (no coherence test) is not ported yet: ROADMAP queue 1, "
            "slice 5 (rest of the feature bank)")
    if win_length is None:
        win_length = n_fft
    if fmax_doa is None:
        fmax_doa = 9000.0 if audio_format == "foa" else 4000.0
    p = SalsaParams(
        fs=fs, n_fft=n_fft, hop_length=hop_length, win_length=win_length,
        fmin_doa=fmin_doa, fmax_doa=fmax_doa, audio_format=audio_format,
        condition_number=condition_number, n_hopframes=n_hopframes,
        compress_high_freq=compress_high_freq,
    )
    desc = (f"{fs}fs_{n_fft}nfft_{hop_length}nhop_{int(condition_number)}cond_"
            f"{int(min(fmax_doa, fs // 2))}fmaxdoa")
    if not compress_high_freq:
        desc += "_nocompress"
    return FeatureExtractor(name=feature_type, audio_format=audio_format, n_channels=7,
                            n_features=p.freq_dim, n_spec_channels=4, description=desc,
                            fn=partial(extract_salsa, params=p))
