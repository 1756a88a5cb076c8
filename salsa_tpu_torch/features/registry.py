"""Feature registry (counterpart of `salsa_tpu.features.registry`): the whole
feature bank, feature_type x audio_format, each as a function of a batch of waves
(B, n_ch, n_samples) -> features (B, C, T, F) on the waves' device.

  salsa        log-linear compressed spec (4) + normalized eigenvector (3)  [foa|mic]
  salsa_lite   log-linear spec 9 kHz crop (4) + freq-normalized IPD (3)      [mic]
  salsa_ipd    log-linear spec 9 kHz crop (4) + IPD/pi (3)                   [mic]
  linspeciv    log-linear compressed spec (4) + intensity vector (3)         [foa]
  melspeciv    log-mel spec (4) + mel intensity vector (3)                   [foa]
  linspecgcc   log-linear compressed spec (4) + GCC-PHAT (6)                 [mic]
  melspecgcc   log-mel spec (4) + GCC-PHAT with the 4 kHz notch (6)          [mic]
  melspec      log-mel spec (n_ch)                                           [any]

Every type but salsa is frame-local (`FrameFeature`): each frame's features come
from that frame's STFTs alone, so the chunk and block extractors of
`features.chunked` compute the same function on their own frames.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from functools import partial
from typing import Callable

import numpy as np
import torch

from salsa_tpu_torch.dsp.filterbank import high_freq_compression_matrix, mel_filterbank
from salsa_tpu_torch.features.salsa import SalsaParams, extract_salsa
from salsa_tpu_torch.features.salsa_lite import SalsaLiteParams, salsa_lite_from_spectra
from salsa_tpu_torch.features.specs import (
    big_fft_len,
    gcc_features,
    gcc_phat_lowpass_filter,
    multichannel_spectra,
    projected_features,
)

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
    hop_length: int          # samples between frames
    fn: Callable[[torch.Tensor], torch.Tensor] = field(repr=False)

    def __call__(self, waves: torch.Tensor) -> torch.Tensor:
        return self.fn(waves)


@dataclass(frozen=True)
class FrameFeature:
    """A frame-local feature: from_spectra(*spectra) maps the frames' STFT at each
    FFT length of `n_ffts` (n_fft, and for the GCC types the double length after
    it), each an (re, im) pair of planes (B, C, T, bins), to the features (B, C',
    T, F) of the same frames. `params` are the SalsaLiteParams of
    salsa_lite/salsa_ipd, else None."""

    from_spectra: Callable[..., torch.Tensor]
    n_ffts: tuple[int, ...]
    hop_length: int
    win_length: int
    n_channels: int
    n_features: int
    n_spec_channels: int
    description: str
    params: SalsaLiteParams | None = None

    def __call__(self, waves: torch.Tensor) -> torch.Tensor:
        """(B, n_ch, n_samples) -> (B, C', T, F), each FFT centered (reflect pad)."""
        if waves.dim() != 3:
            raise ValueError(f"waves must be (B, n_channels, n_samples), got {tuple(waves.shape)}")
        return self.from_spectra(*(multichannel_spectra(waves, n, self.hop_length,
                                                        self.win_length)
                                   for n in self.n_ffts))


def _projection(proj: np.ndarray) -> Callable[[torch.device], torch.Tensor]:
    """The projection matrix as float32 on a device, made once per device."""
    cache: dict[torch.device, torch.Tensor] = {}

    def on(device: torch.device) -> torch.Tensor:
        if device not in cache:
            cache[device] = torch.from_numpy(proj).to(device)
        return cache[device]

    return on


def _lite(spec, *, params):
    return salsa_lite_from_spectra(*spec, params)


def _projected(spec, *, proj, with_iv):
    return projected_features(*spec, proj(spec[0].device), with_iv)


def _gcc(spec, big, *, proj, n_out, freq_filter):
    return gcc_features(spec, big, proj(spec[0].device), n_out, freq_filter)


def frame_feature(feature_type: str, audio_format: str, fs: int = 24000, n_fft: int = 512,
                  hop_length: int = 300, win_length: int | None = None, n_mels: int = 128,
                  fmin: float = 50.0, fmax: float | None = None, fmin_doa: float = 50.0,
                  fmax_doa: float | None = None,
                  compress_high_freq: bool = True) -> FrameFeature:
    """The frame-local feature types with `salsa_tpu`'s parameters and defaults:
    fmax_doa 2000 for salsa_lite/salsa_ipd, fmax clipped to fs // 2."""
    win = n_fft if win_length is None else win_length
    fmax = min(fs // 2 if fmax is None else fmax, fs // 2)
    geo = dict(hop_length=hop_length, win_length=win)
    if feature_type in ("salsa_lite", "salsa_ipd"):
        fmax_doa = 2000.0 if fmax_doa is None else fmax_doa
        p = SalsaLiteParams(fs=fs, n_fft=n_fft, hop_length=hop_length, win_length=win,
                            fmin_doa=fmin_doa, fmax_doa=fmax_doa,
                            normalize="lite" if feature_type == "salsa_lite" else "ipd")
        desc = f"{fs}fs_{n_fft}nfft_{hop_length}nhop_{int(min(fmax_doa, fs // 2))}fmaxdoa"
        return FrameFeature(partial(_lite, params=p), (n_fft,), n_channels=7,
                            n_features=p.n_features, n_spec_channels=4, description=desc,
                            params=p, **geo)
    if feature_type in ("melspec", "melspeciv", "melspecgcc"):
        proj = mel_filterbank(fs, n_fft, n_mels, fmin, fmax)
        desc = f"{fs}fs_{n_fft}nfft_{hop_length}nhop_{n_mels}nmels"
    elif feature_type in ("linspeciv", "linspecgcc"):
        proj = high_freq_compression_matrix(n_fft, compress_high_freq)
        desc = f"{fs}fs_{n_fft}nfft_{hop_length}nhop_{proj.shape[0]}nfreqs"
    else:
        raise ValueError(f"unknown feature type '{feature_type}'")
    n_out = proj.shape[0]
    if feature_type.endswith("gcc"):
        big = big_fft_len(n_fft)
        filt = gcc_phat_lowpass_filter(fs, big) if feature_type == "melspecgcc" else None
        fn = partial(_gcc, proj=_projection(proj), n_out=n_out, freq_filter=filt)
        n_ffts, n_channels = (n_fft, big), 10
    else:
        fn = partial(_projected, proj=_projection(proj), with_iv=feature_type != "melspec")
        n_ffts, n_channels = (n_fft,), 4 if feature_type == "melspec" else 7
    # classic features: the reference scaler fits and normalizes every channel
    return FrameFeature(fn, n_ffts, n_channels=n_channels, n_features=n_out,
                        n_spec_channels=n_channels, description=desc, **geo)


def salsa_params(audio_format: str, fs: int = 24000, n_fft: int = 512, hop_length: int = 300,
                 win_length: int | None = None, fmin_doa: float = 50.0,
                 fmax_doa: float | None = None, condition_number: float = 5.0,
                 n_hopframes: int = 3, is_tracking: bool = True,
                 compress_high_freq: bool = True, eig_method: str = "auto") -> SalsaParams:
    """SALSA's parameters with `salsa_tpu`'s defaults (fmax_doa 9000 FOA, 4000 MIC)."""
    if fmax_doa is None:
        fmax_doa = 9000.0 if audio_format == "foa" else 4000.0
    return SalsaParams(
        fs=fs, n_fft=n_fft, hop_length=hop_length,
        win_length=n_fft if win_length is None else win_length, fmin_doa=fmin_doa,
        fmax_doa=fmax_doa, audio_format=audio_format, condition_number=condition_number,
        n_hopframes=n_hopframes, is_tracking=is_tracking,
        compress_high_freq=compress_high_freq, eig_method=eig_method)


def make_extractor(
    feature_type: str,
    audio_format: str,
    fs: int = 24000,
    n_fft: int = 512,
    hop_length: int = 300,
    win_length: int | None = None,
    n_mels: int = 128,
    fmin: float = 50.0,
    fmax: float | None = None,
    fmin_doa: float = 50.0,
    fmax_doa: float | None = None,
    condition_number: float = 5.0,
    n_hopframes: int = 3,
    is_tracking: bool = True,
    compress_high_freq: bool = True,
    eig_method: str = "auto",
    n_mics: int = 4,
) -> FeatureExtractor:
    """`salsa_tpu.features.registry.make_extractor` with its defaults, except that
    eig_method 'auto' is K1 on every device (ROADMAP rule 5). SALSA takes any
    channel count C = `n_mics` >= 2 and reports its 2C - 1 output
    channels and C spectrogram channels; `salsa_tpu` reports 7 and 4 at every C
    (ROADMAP queue 3)."""
    meta = dict(name=feature_type, audio_format=audio_format, hop_length=hop_length)
    if feature_type == "salsa":
        p = salsa_params(audio_format, fs, n_fft, hop_length, win_length, fmin_doa, fmax_doa,
                         condition_number, n_hopframes, is_tracking, compress_high_freq,
                         eig_method)
        desc = (f"{fs}fs_{n_fft}nfft_{hop_length}nhop_{int(condition_number)}cond_"
                f"{int(min(p.fmax_doa, fs // 2))}fmaxdoa")
        if not is_tracking:
            desc += "_notracking"
        if not compress_high_freq:
            desc += "_nocompress"
        return FeatureExtractor(n_channels=2 * n_mics - 1, n_features=p.freq_dim,
                                n_spec_channels=n_mics, description=desc,
                                fn=partial(extract_salsa, params=p), **meta)
    ff = frame_feature(feature_type, audio_format, fs, n_fft, hop_length, win_length, n_mels,
                       fmin, fmax, fmin_doa, fmax_doa, compress_high_freq)
    return FeatureExtractor(n_channels=ff.n_channels, n_features=ff.n_features,
                            n_spec_channels=ff.n_spec_channels, description=ff.description,
                            fn=ff, **meta)


def feature_n_channels(feature_type: str) -> int:
    return {"salsa": 7, "salsa_lite": 7, "salsa_ipd": 7, "linspeciv": 7,
            "melspeciv": 7, "linspecgcc": 10, "melspecgcc": 10, "melspec": 4}[feature_type]


def feature_n_spec_channels(feature_type: str) -> int:
    """Channels covered by the normalization scaler: the SALSA family scales only
    the spectrogram channels, classic features scale every channel."""
    if feature_type in ("salsa", "salsa_lite", "salsa_ipd"):
        return 4
    return feature_n_channels(feature_type)
