"""In-memory chunked SELD database (the store-agnostic part of
`salsa_tpu.data.database`).

Builds frame-wise SED/DOA targets from DCASE metadata CSVs and overlapping chunk
indices at the two frame rates (feature rate, label rate), over features that a
store hands over per clip and that the train-split scaler normalizes:
  * two frame rates: feature fs/hop (80 fps) vs label 10 fps; upsample ratio 8;
  * clips trimmed to 60 s (4800 feature frames / 600 label frames);
  * train chunks 8 s with 0.5 s hop, test 60 s (single chunk per file);
  * a leftover chunk appended when the hop does not divide the remainder;
  * SALSA-family scalers cover only the spectrogram channels;
  * classwise targets: one-hot SED + unit-vector DOA at label rate; overlapping
    same-class events resolved by writing tracks in increasing-duration order so
    the longest track wins.

The store is injected (`data.wav_database.MemoryFeatureStore`): the HDF5
`FeatureStore` and the streaming `LazySplitData` need h5py, which the GPU host
does not have, and are not ported (ROADMAP queue 1).
"""
from __future__ import annotations

import copy
import os
from dataclasses import dataclass, field

import numpy as np

from salsa_tpu_torch.data.meta import split_filenames


def parse_gt_csv(path: str) -> np.ndarray:
    """Metadata CSV rows: frame, class, track, azimuth, elevation. Returns (N, 5)."""
    rows = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if line:
                rows.append([float(v) for v in line.split(",")])
    return np.asarray(rows, dtype=np.float64).reshape(-1, 5)


def classwise_targets(
    gt_rows: np.ndarray, n_label_frames: int, n_classes: int
) -> tuple[np.ndarray, np.ndarray]:
    """(sed, doa) targets at label rate from metadata rows.

    sed: (T, n_classes) one-hot; doa: (T, 3*n_classes) unit xyz, zero when inactive.
    """
    sed = np.zeros((n_label_frames, n_classes), dtype=np.float32)
    azi = np.zeros((n_label_frames, n_classes), dtype=np.float32)
    ele = np.zeros((n_label_frames, n_classes), dtype=np.float32)
    if gt_rows.size:
        frames = gt_rows[:, 0].astype(int)
        classes = gt_rows[:, 1].astype(int)
        tracks = gt_rows[:, 2].astype(int)
        # write shorter tracks first so longer tracks overwrite on conflicts
        durations = np.bincount(tracks)
        order = np.argsort(durations, kind="stable")
        for track_id in order:
            sel = tracks == track_id
            f, c = frames[sel], classes[sel]
            keep = f < n_label_frames
            f, c = f[keep], c[keep]
            sed[f, c] = 1.0
            azi[f, c] = np.deg2rad(gt_rows[sel, 3][keep])
            ele[f, c] = np.deg2rad(gt_rows[sel, 4][keep])
    x = np.cos(azi) * np.cos(ele)
    y = np.sin(azi) * np.cos(ele)
    z = np.sin(ele)
    active = sed >= 1
    x = np.where(active, x, 0.0)
    y = np.where(active, y, 0.0)
    z = np.where(active, z, 0.0)
    doa = np.concatenate([x, y, z], axis=-1).astype(np.float32)
    return sed, doa


def chunk_starts(n_units: int, chunk_len: int, hop_len: int, offset: int) -> list[int]:
    """Start indices of overlapping chunks inside a clip of n_units frames, global
    offset added; a trailing chunk is appended when the hop leaves a remainder."""
    starts = list(range(offset, offset + n_units - chunk_len + 1, hop_len))
    if (n_units - chunk_len) % hop_len != 0:
        starts.append(offset + n_units - chunk_len)
    return starts


@dataclass
class SplitData:
    """One split fully loaded: concatenated features/targets + chunk index tables."""

    features: np.ndarray          # (C, total_feature_frames, F)
    sed_targets: np.ndarray       # (total_label_frames, n_classes)
    doa_targets: np.ndarray       # (total_label_frames, 3*n_classes)
    feature_chunk_starts: np.ndarray
    label_chunk_starts: np.ndarray
    clip_names: list[str] = field(default_factory=list)  # one per chunk
    feature_chunk_len: int = 0
    feature_chunk_hop: int = 0
    label_chunk_len: int = 0
    label_chunk_hop: int = 0
    chunks_per_clip: int = 0      # max chunks of any clip (uniform for 60 s corpora)
    # per-clip bookkeeping (clip order == file order == chunk order): recombining
    # clips of differing lengths needs it
    unique_clip_names: list[str] = field(default_factory=list)
    clip_chunk_counts: np.ndarray | None = None   # (n_clips,)
    clip_label_frames: np.ndarray | None = None   # (n_clips,) true pre-pad lengths

    def __len__(self):
        return len(self.feature_chunk_starts)

    def get_feature_chunk(self, index: int) -> np.ndarray:
        f0 = self.feature_chunk_starts[index]
        return self.features[:, f0 : f0 + self.feature_chunk_len, :]


def truncate_clips(split: SplitData, n_clips: int) -> SplitData:
    """A shallow view of `split` restricted to its first n_clips clips (feature and
    target storage shared; only the chunk/clip index tables are sliced). Backs the
    data.val_fraction knob."""
    n_clips = max(1, min(n_clips, len(split.unique_clip_names)))
    n_chunks = int(np.sum(split.clip_chunk_counts[:n_clips]))
    out = copy.copy(split)
    out.feature_chunk_starts = split.feature_chunk_starts[:n_chunks]
    out.label_chunk_starts = split.label_chunk_starts[:n_chunks]
    out.clip_names = split.clip_names[:n_chunks]
    out.unique_clip_names = split.unique_clip_names[:n_clips]
    out.clip_chunk_counts = split.clip_chunk_counts[:n_clips]
    out.clip_label_frames = split.clip_label_frames[:n_clips]
    return out


class SeldDatabase:
    """Feature + ground-truth database for one (feature_type, audio_format) stream,
    over an injected feature store (`read_clip(split_kind, name)`,
    `read_scaler()`)."""

    def __init__(
        self,
        feature_root_dir: str | None = None,
        gt_meta_root_dir: str | None = None,
        audio_format: str = "foa",
        n_classes: int = 12,
        fs: int = 24000,
        hop_len: int = 300,
        label_rate: float = 10,
        train_chunk_len_s: float = 8.0,
        train_chunk_hop_len_s: float = 0.5,
        test_chunk_len_s: float = 60.0,
        test_chunk_hop_len_s: float = 60.1,
        scaler_channels: int | None = None,
        max_file_len_s: float = 60.0,
        store=None,
    ):
        if store is None:
            raise ValueError(
                "SeldDatabase needs a feature store: the HDF5 feature store at "
                f"feature_root_dir={feature_root_dir!r} needs h5py, which this package "
                "does not use (train with training.from_wav: true)")
        self.store = store
        self.gt_meta_root_dir = gt_meta_root_dir
        self.audio_format = audio_format
        self.n_classes = n_classes
        self.fs = fs
        self.hop_len = hop_len
        self.label_rate = label_rate
        self.feature_rate = fs / hop_len
        self.label_upsample = int(self.feature_rate / label_rate)
        self.train_chunk_len = self.seconds_to_frames(train_chunk_len_s)
        self.train_chunk_hop = self.seconds_to_frames(train_chunk_hop_len_s)
        self.test_chunk_len = self.seconds_to_frames(test_chunk_len_s)
        self.test_chunk_hop = self.seconds_to_frames(test_chunk_hop_len_s)
        self.max_label_frames = int(max_file_len_s * label_rate)
        self.scaler_channels = scaler_channels
        self._scaler = None

    def seconds_to_frames(self, seconds: float) -> int:
        return int(round(int(seconds * self.fs) / self.hop_len))

    @property
    def scaler(self) -> tuple[np.ndarray, np.ndarray]:
        if self._scaler is None:
            self._scaler = self.store.read_scaler()
        return self._scaler

    def normalize(self, feature: np.ndarray) -> np.ndarray:
        mean, std = self.scaler
        n_sc = mean.shape[0]
        feature = feature.astype(np.float32)
        if n_sc < feature.shape[0]:
            feature[:n_sc] = (feature[:n_sc] - mean) / std
        else:
            feature = (feature - mean) / std
        return feature

    def gt_meta_path(self, split: str, clip_name: str) -> str | None:
        if self.gt_meta_root_dir is None:
            return None
        sub = "metadata_eval" if split == "eval" else "metadata_dev"
        return os.path.join(self.gt_meta_root_dir, sub, clip_name + ".csv")

    def load_split(self, split: str, split_meta_dir: str | None = None,
                   stage: str = "fit") -> SplitData:
        """stage 'fit' -> train chunking; 'inference' -> test chunking. Every
        clip's features are read from the store and normalized into memory."""
        names = split_filenames(split, split_meta_dir)
        split_kind = "eval" if split == "eval" else "dev"
        if stage == "fit":
            chunk_len, chunk_hop = self.train_chunk_len, self.train_chunk_hop
        elif stage == "inference":
            chunk_len, chunk_hop = self.test_chunk_len, self.test_chunk_hop
        else:
            raise ValueError(f"unknown stage '{stage}'")
        label_chunk_len = chunk_len // self.label_upsample

        features, seds, doas, names_per_chunk = [], [], [], []
        f_starts, l_starts = [], []
        clip_chunk_counts, clip_label_frames = [], []
        f_ptr = l_ptr = 0
        chunks_per_clip = 0
        for name in names:
            feat = self.normalize(self.store.read_clip(split_kind, name))
            n_frames = min(feat.shape[1], self.max_label_frames * self.label_upsample)
            n_frames -= n_frames % self.label_upsample
            n_label_frames = n_frames // self.label_upsample
            true_label_frames = n_label_frames

            gt_path = self.gt_meta_path(split, name)
            if gt_path and os.path.isfile(gt_path):
                sed, doa = classwise_targets(parse_gt_csv(gt_path), n_label_frames,
                                             self.n_classes)
            else:
                sed = np.zeros((n_label_frames, self.n_classes), dtype=np.float32)
                doa = np.zeros((n_label_frames, 3 * self.n_classes), dtype=np.float32)

            if n_frames < chunk_len:
                # clip shorter than the chunk window: zero-pad to one full chunk
                # (the true length is recorded so CSV output stops at real frames)
                feat = np.pad(feat[:, :n_frames, :],
                              ((0, 0), (0, chunk_len - n_frames), (0, 0)))
                sed = np.pad(sed, ((0, label_chunk_len - n_label_frames), (0, 0)))
                doa = np.pad(doa, ((0, label_chunk_len - n_label_frames), (0, 0)))
                n_frames, n_label_frames = chunk_len, label_chunk_len

            starts_f = chunk_starts(n_frames, chunk_len, chunk_hop, f_ptr)
            starts_l = chunk_starts(
                n_label_frames, label_chunk_len, chunk_hop // self.label_upsample, l_ptr)
            if len(starts_f) != len(starts_l):
                raise ValueError(f"{name}: {len(starts_f)} feature chunks but "
                                 f"{len(starts_l)} label chunks")
            f_ptr += n_frames
            l_ptr += n_label_frames
            chunks_per_clip = max(chunks_per_clip, len(starts_f))
            clip_chunk_counts.append(len(starts_f))
            clip_label_frames.append(true_label_frames)
            features.append(feat[:, :n_frames, :])
            seds.append(sed)
            doas.append(doa)
            f_starts.extend(starts_f)
            l_starts.extend(starts_l)
            names_per_chunk.extend([name] * len(starts_f))

        return SplitData(
            features=np.concatenate(features, axis=1),
            sed_targets=np.concatenate(seds, axis=0),
            doa_targets=np.concatenate(doas, axis=0),
            feature_chunk_starts=np.asarray(f_starts, dtype=np.int64),
            label_chunk_starts=np.asarray(l_starts, dtype=np.int64),
            clip_names=names_per_chunk,
            feature_chunk_len=chunk_len,
            feature_chunk_hop=chunk_hop,
            label_chunk_len=label_chunk_len,
            label_chunk_hop=max(1, chunk_hop // self.label_upsample),
            chunks_per_clip=chunks_per_clip,
            unique_clip_names=list(names),
            clip_chunk_counts=np.asarray(clip_chunk_counts, dtype=np.int64),
            clip_label_frames=np.asarray(clip_label_frames, dtype=np.int64),
        )
