"""The streaming normalization scaler of `salsa_tpu.data.feature_store`, without
its HDF5 store: the GPU host has no h5py, and the fused raw-wav path keeps its
features in memory (`data.wav_database`). The h5 `FeatureStore` is not ported
(ROADMAP queue 1)."""
from __future__ import annotations

import numpy as np


class StreamingScaler:
    """Accumulates per-channel, per-frequency mean/std over (C, T, F) feature clips:
    the reference's compute_scaler (sklearn StandardScaler.partial_fit per
    channel) as exact streaming sums in float64."""

    def __init__(self, n_channels: int):
        self.n_channels = n_channels
        self.count = 0
        self._sum = None
        self._sumsq = None

    def update(self, feature: np.ndarray) -> None:
        x = feature[: self.n_channels].astype(np.float64)  # (C, T, F)
        if self._sum is None:
            self._sum = x.sum(axis=1)
            self._sumsq = (x**2).sum(axis=1)
        else:
            self._sum += x.sum(axis=1)
            self._sumsq += (x**2).sum(axis=1)
        self.count += x.shape[1]

    def finalize(self) -> tuple[np.ndarray, np.ndarray]:
        """Returns (mean, std) of shape (C, 1, F)."""
        mean = self._sum / self.count
        var = self._sumsq / self.count - mean**2
        std = np.sqrt(np.maximum(var, 0.0))
        return (
            mean[:, None, :].astype(np.float32),
            std[:, None, :].astype(np.float32),
        )
