"""Per-clip feature store and streaming normalization scaler (counterpart of
`salsa_tpu.data.feature_store`).

The directory layout is `salsa_tpu`'s, so that either package finds the other's
store from the same config: `<feature_dir>/<type>[/<fmt>]/<description>/` holding
`<fmt>_{dev,eval}/<clip>` and `<fmt>_feature_scaler`. The files differ: the port
writes each clip as `<clip>.npy` (float32 (C, T, F)) and the scaler as
`<fmt>_feature_scaler.npz` (`mean`, `std`, each (C, 1, F)), since the GPU host
has no h5py. A `.npy` clip, unlike a zipped `.npz`, can be memory-mapped, so a
lazy split reads one chunk window without reading the clip. The port always
writes that format; it reads it and `salsa_tpu`'s `.h5` files (through h5py,
imported only for an `.h5`, whose absence raises ImportError naming it). A clip
or scaler present in both formats is refused (ValueError): which one to read
would be a guess.
"""
from __future__ import annotations

import os

import numpy as np

CLIP_EXTS = (".npy", ".h5")


def _h5py(path: str):
    try:
        import h5py
    except ImportError as e:
        raise ImportError(f"{path} is an HDF5 feature file (salsa_tpu's store), which needs "
                          "h5py, and h5py is not installed; the port writes .npy clips and "
                          "an .npz scaler") from e
    return h5py


def open_clip(path: str):
    """(array, close) of a stored clip: an array-like (C, T, F) that reads only what
    is sliced from it (a memory map of a `.npy`, the `feature` dataset of an `.h5`)
    and the function that releases it."""
    if path.endswith(".h5"):
        hf = _h5py(path).File(path, "r")
        return hf["feature"], hf.close
    return np.load(path, mmap_mode="r"), lambda: None


def _one_of(stem: str, exts, what: str) -> str | None:
    """The one existing file `stem + ext` for ext in exts, None where there is none;
    two formats of one file raise ValueError."""
    found = [stem + ext for ext in exts if os.path.isfile(stem + ext)]
    if len(found) > 1:
        raise ValueError(f"{what} is stored in two formats ({', '.join(found)}); keep one")
    return found[0] if found else None


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


class FeatureStore:
    """Reads and writes per-clip features and the split-level scaler under
    `root_dir` (the feature directory `cli.extract` names)."""

    def __init__(self, root_dir: str, audio_format: str):
        self.root_dir = root_dir
        self.audio_format = audio_format

    def split_dir(self, split_kind: str) -> str:
        # split_kind: 'dev' | 'eval'
        return os.path.join(self.root_dir, f"{self.audio_format}_{split_kind}")

    def clip_path(self, split_kind: str, clip_name: str) -> str:
        """The clip's file: the stored `.npy` or `.h5`, else the `.npy` the port
        writes."""
        stem = os.path.join(self.split_dir(split_kind), clip_name)
        return _one_of(stem, CLIP_EXTS, f"clip {clip_name!r}") or stem + ".npy"

    def has_clip(self, split_kind: str, clip_name: str) -> bool:
        return os.path.isfile(self.clip_path(split_kind, clip_name))

    def clip_names(self, split_kind: str) -> list[str]:
        """Every stored clip of the split folder, in the sorted order of its file
        names (`salsa_tpu`'s scaler order)."""
        d = self.split_dir(split_kind)
        if not os.path.isdir(d):
            return []
        names = [os.path.splitext(f)[0] for f in sorted(os.listdir(d))
                 if os.path.splitext(f)[1] in CLIP_EXTS]
        return list(dict.fromkeys(names))

    def write_clip(self, split_kind: str, clip_name: str, feature: np.ndarray) -> None:
        os.makedirs(self.split_dir(split_kind), exist_ok=True)
        stem = os.path.join(self.split_dir(split_kind), clip_name)
        if os.path.isfile(stem + ".h5"):  # an earlier salsa_tpu extraction of this clip
            os.remove(stem + ".h5")
        np.save(stem + ".npy", np.asarray(feature, dtype=np.float32))

    def read_clip(self, split_kind: str, clip_name: str) -> np.ndarray:
        path = self.clip_path(split_kind, clip_name)
        if path.endswith(".h5"):
            with _h5py(path).File(path, "r") as hf:
                return hf["feature"][:]
        return np.load(path)

    def clip_shape(self, split_kind: str, clip_name: str) -> tuple[int, ...]:
        """The clip's (C, T, F), read from its header."""
        arr, close = open_clip(self.clip_path(split_kind, clip_name))
        try:
            return tuple(arr.shape)
        finally:
            close()

    @property
    def scaler_path(self) -> str:
        """The stored scaler (`.npz` or `.h5`), else the `.npz` the port writes."""
        stem = os.path.join(self.root_dir, f"{self.audio_format}_feature_scaler")
        return _one_of(stem, (".npz", ".h5"), "the feature scaler") or stem + ".npz"

    def write_scaler(self, mean: np.ndarray, std: np.ndarray) -> None:
        os.makedirs(self.root_dir, exist_ok=True)
        stem = os.path.join(self.root_dir, f"{self.audio_format}_feature_scaler")
        if os.path.isfile(stem + ".h5"):
            os.remove(stem + ".h5")
        np.savez(stem + ".npz", mean=np.asarray(mean, np.float32),
                 std=np.asarray(std, np.float32))

    def read_scaler(self) -> tuple[np.ndarray, np.ndarray]:
        path = self.scaler_path
        if path.endswith(".h5"):
            with _h5py(path).File(path, "r") as hf:
                return hf["mean"][:], hf["std"][:]
        with np.load(path) as blob:
            return blob["mean"], blob["std"]

    def has_scaler(self) -> bool:
        return os.path.isfile(self.scaler_path)
