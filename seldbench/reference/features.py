"""Plain SALSA (arXiv:2110.00275) and SALSA-Lite (arXiv:2111.08192) features in
float32 PyTorch, from raw multichannel waves, for the benchmark's comparison.

STFT: center=True (reflect pad n_fft / 2), periodic Hann window, as frames times a
windowed-DFT basis. SALSA: log-power spectrograms of the 4 channels, compressed
above 9 kHz to 200 bins, and in the DOA band the tracker-masked spatial features
of `spatial`, the band's context wrapped from the clip's other end. SALSA-Lite:
log-power spectrograms of bins [1, 9 kHz) and the phase of each mic against mic 0
over delta * bin below 2 kHz. Layout (B, 7, T, F)."""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch
import torch.nn.functional as F

from seldbench.reference import spatial


@dataclass(frozen=True)
class FeatureParams:
    kind: str            # 'salsa' | 'salsa_lite'
    audio_format: str    # 'foa' | 'mic'
    fs: int
    n_fft: int
    hop: int
    fmin_doa: float
    fmax_doa: float
    fmax_spec: float = 9000.0
    condition_number: float = 5.0
    n_hop: int = 3

    @property
    def lower_bin(self) -> int:
        return max(1, int(np.floor(self.fmin_doa * self.n_fft / self.fs)))

    @property
    def upper_bin(self) -> int:
        return int(np.floor(min(self.fmax_doa, self.fs // 2) * self.n_fft / self.fs))

    @property
    def cutoff_bin(self) -> int:
        return min(int(np.floor(self.fmax_spec * self.n_fft / self.fs)), self.n_fft // 2)

    @property
    def n_features(self) -> int:
        if self.kind == "salsa":
            return {512: 200, 256: 100}[self.n_fft]
        return self.cutoff_bin - self.lower_bin


def params_of(cfg: dict) -> FeatureParams:
    """The feature parameters an experiment config states, with the recipes'
    defaults: the DOA band ends at 9 kHz (SALSA FOA), 4 kHz (SALSA MIC) or 2 kHz
    (SALSA-Lite)."""
    d, kind = cfg["data"], cfg["feature_type"]
    if kind not in ("salsa", "salsa_lite"):
        raise ValueError(f"the reference has no feature type '{kind}'")
    default = {"salsa": 9000.0 if d["audio_format"] == "foa" else 4000.0,
               "salsa_lite": 2000.0}[kind]
    fmax_doa = d.get("fmax_doa")
    return FeatureParams(kind, d["audio_format"], d["fs"], d["n_fft"], d["hop_len"],
                         d.get("fmin_doa", 50.0), default if fmax_doa is None else fmax_doa)


def dft_bases(n_fft: int, device) -> tuple[torch.Tensor, torch.Tensor]:
    """(n_fft, n_fft // 2 + 1) float32 cosine and sine bases with the periodic Hann
    window folded in, made in float64."""
    n = np.arange(n_fft)
    window = 0.5 - 0.5 * np.cos(2.0 * np.pi * n / n_fft)
    angle = -2.0 * np.pi * n[:, None] * np.arange(n_fft // 2 + 1)[None, :] / n_fft
    return (torch.from_numpy((np.cos(angle) * window[:, None]).astype(np.float32)).to(device),
            torch.from_numpy((np.sin(angle) * window[:, None]).astype(np.float32)).to(device))


def stft_of_padded(padded: torch.Tensor, n_fft: int, hop: int):
    """(B, C, S) waves carrying n_fft / 2 of center pad a side -> re, im planes
    (B, C, 1 + (S - n_fft) // hop, bins)."""
    cos, sin = dft_bases(n_fft, padded.device)
    frames = padded.unfold(-1, n_fft, hop)
    return frames @ cos, frames @ sin


def center_pad(waves: torch.Tensor, n_fft: int) -> torch.Tensor:
    B, C, n = waves.shape
    return F.pad(waves.reshape(B * C, 1, n), (n_fft // 2, n_fft // 2), mode="reflect").reshape(
        B, C, n + 2 * (n_fft // 2))


def power_to_db(power: torch.Tensor) -> torch.Tensor:
    return 10.0 * torch.log10(torch.clamp(power, min=1e-10))


def compression_matrix(n_fft: int) -> np.ndarray:
    """SALSA's projection (n_out, bins): bins 1..k kept, the bins above 9 kHz
    averaged 8 at a time (the last row sums 7, the Nyquist bin left out)."""
    n_out, n_keep = {512: (200, 192), 256: (100, 96)}[n_fft]
    n_bins = n_fft // 2 + 1
    W = np.zeros((n_out, n_bins), np.float32)
    W[np.arange(n_keep), np.arange(1, n_keep + 1)] = 1.0
    for row in range(n_keep, n_out):
        start = n_keep + 1 + (row - n_keep) * 8
        W[row, start:min(start + 8, n_bins - 1)] = 1.0 / 8.0
    return W


def log_spectrogram(re: torch.Tensor, im: torch.Tensor, p: FeatureParams) -> torch.Tensor:
    """SALSA's compressed log-power spectrograms (B, 4, T, n_features)."""
    W = torch.from_numpy(compression_matrix(p.n_fft)).to(re.device)
    return power_to_db((re * re + im * im) @ W.T)


def band(re: torch.Tensor, im: torch.Tensor, p: FeatureParams):
    """The DOA band as (B, 4, bins, T + 2 n_hop) planes, the context frames
    wrapped from the clip's other end."""
    h = p.n_hop

    def one(x):
        x = x[..., p.lower_bin:p.upper_bin].transpose(-1, -2)
        return torch.cat([x[..., -h:], x, x[..., :h]], dim=-1).contiguous()

    return one(re), one(im)


def spatial_map(xr: torch.Tensor, xi: torch.Tensor, mask: torch.Tensor,
                p: FeatureParams) -> torch.Tensor:
    """Band planes and the tracker mask -> the 3 spatial channels (B, 3, T,
    n_features), zero above the band."""
    eig = spatial.spatial_features(
        xr, xi, mask, n_hop=p.n_hop, audio_format=p.audio_format,
        condition_number=p.condition_number, lower_bin=p.lower_bin, fs=p.fs, n_fft=p.n_fft)
    return F.pad(eig.transpose(-1, -2), (0, p.n_features - (p.upper_bin - p.lower_bin)))


def salsa_from_spectra(re: torch.Tensor, im: torch.Tensor, p: FeatureParams) -> torch.Tensor:
    """Whole clips' STFT planes (B, 4, T, bins) -> SALSA (B, 7, T, n_features)."""
    xr, xi = band(re, im, p)
    mask = spatial.tracker_mask(xr[:, 0], xi[:, 0], p.n_hop, re.shape[-2])
    return torch.cat([log_spectrogram(re, im, p), spatial_map(xr, xi, mask, p)], dim=1)


def salsa_lite_from_spectra(re: torch.Tensor, im: torch.Tensor, p: FeatureParams) -> torch.Tensor:
    """STFT planes (B, 4, T, bins) -> SALSA-Lite (B, 7, T, n_features)."""
    crop = slice(p.lower_bin, p.cutoff_bin)
    re, im = re[..., crop], im[..., crop]
    log_spec = power_to_db(re * re + im * im)
    r0, i0 = re[:, 0:1], im[:, 0:1]
    phase = torch.atan2(im[:, 1:] * r0 - re[:, 1:] * i0, re[:, 1:] * r0 + im[:, 1:] * i0)
    k = np.arange(p.lower_bin, p.cutoff_bin, dtype=np.float32)
    scale = (np.float32(spatial.mic_delta(p.fs, p.n_fft)) * k).astype(np.float32)
    keep = (k < p.upper_bin).astype(np.float32)
    phase = phase / torch.from_numpy(scale).to(re.device) * torch.from_numpy(keep).to(re.device)
    return torch.cat([log_spec, phase], dim=1)


def features_of_padded(padded: torch.Tensor, p: FeatureParams) -> torch.Tensor:
    """Whole clips (B, 4, S), center-padded, float32 -> features (B, 7, T, F)."""
    re, im = stft_of_padded(padded, p.n_fft, p.hop)
    if p.kind == "salsa":
        return salsa_from_spectra(re, im, p)
    return salsa_lite_from_spectra(re, im, p)


def features(waves: torch.Tensor, p: FeatureParams) -> torch.Tensor:
    """Whole clips (B, 4, n_samples) float32 -> features (B, 7, 1 + n // hop, F)."""
    return features_of_padded(center_pad(waves, p.n_fft), p)
