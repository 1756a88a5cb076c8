"""SALSA-Lite / SALSA-IPD features (counterpart of `salsa_tpu.features.salsa_lite`),
MIC format: log-linear spectrograms cropped to a 9 kHz cutoff and the normalised
interchannel phase differences against mic 0.

  * log specs: |STFT|^2 -> dB, bins [lower_bin, cutoff_bin);
  * phase: angle(X_m conj(X_0)), m = 1..3, as atan2 of the product's planes;
    salsa_ipd divides it by pi, salsa_lite by delta * bin with delta = 2 pi fs /
    (n_fft c) and bin 0 taken as 1;
  * the phase is zeroed at and above the spatial-aliasing bin (upper_bin).

Frame-local: no covariance window and no tracker, so neither K1 nor K2 runs.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from salsa_tpu_torch.dsp.stft import power_to_db, stft_planes

SPEED_OF_SOUND = 343.0


@dataclass(frozen=True)
class SalsaLiteParams:
    fs: int = 24000
    n_fft: int = 512
    hop_length: int = 300
    win_length: int | None = None
    fmin_doa: float = 50.0
    fmax_doa: float = 2000.0
    fmax_spec: float = 9000.0
    normalize: str = "lite"  # 'lite' (frequency-normalised) | 'ipd' (divided by pi)

    @property
    def lower_bin(self) -> int:
        return max(1, int(np.floor(self.fmin_doa * self.n_fft / self.fs)))

    @property
    def upper_bin(self) -> int:
        fmax_doa = min(self.fmax_doa, self.fs // 2)
        return int(np.floor(fmax_doa * self.n_fft / self.fs))

    @property
    def cutoff_bin(self) -> int:
        return min(int(np.floor(self.fmax_spec * self.n_fft / self.fs)), self.n_fft // 2)

    @property
    def n_features(self) -> int:
        return self.cutoff_bin - self.lower_bin


def phase_scale(p: SalsaLiteParams) -> np.ndarray:
    """The divisor of each bin's phase, float32 (n_fft//2 + 1,): pi for ipd, delta *
    bin (bin 0 as 1) for lite."""
    if p.normalize == "ipd":
        return np.full(p.n_fft // 2 + 1, np.pi, np.float32)
    if p.normalize == "lite":
        delta = 2.0 * np.pi * p.fs / (p.n_fft * SPEED_OF_SOUND)
        freq_vector = np.arange(p.n_fft // 2 + 1, dtype=np.float32)
        freq_vector[0] = 1.0
        return (delta * freq_vector).astype(np.float32)
    raise ValueError(f"unknown salsa_lite normalization '{p.normalize}'")


def salsa_lite_from_spectra(re: torch.Tensor, im: torch.Tensor,
                            params: SalsaLiteParams) -> torch.Tensor:
    """(..., 4, T, bins) STFT planes -> (..., 7, T, n_features) features."""
    p = params
    band = slice(p.lower_bin, p.cutoff_bin)
    re, im = re[..., band], im[..., band]
    log_specs = power_to_db(re * re + im * im)
    r0, i0 = re[..., 0:1, :, :], im[..., 0:1, :, :]
    rm, imm = re[..., 1:, :, :], im[..., 1:, :, :]
    phase = torch.atan2(imm * r0 - rm * i0, rm * r0 + imm * i0)
    scale = phase_scale(p)[band]
    keep = (np.arange(p.lower_bin, p.cutoff_bin) < p.upper_bin).astype(np.float32)
    phase = phase / torch.from_numpy(scale).to(re.device) * torch.from_numpy(keep).to(re.device)
    return torch.cat([log_specs, phase], dim=-3)


def extract_salsa_lite(waves: torch.Tensor, params: SalsaLiteParams) -> torch.Tensor:
    """(B, 4, n_samples) MIC waves -> (B, 7, n_frames, cutoff_bin - lower_bin)."""
    p = params
    re, im = stft_planes(waves, n_fft=p.n_fft, hop_length=p.hop_length, win_length=p.win_length)
    return salsa_lite_from_spectra(re, im, p)
