"""Chunked SELD database (counterpart of `salsa_tpu.data.database`).

Loads a split's per-clip features from a feature store, normalizes them with the
train-split scaler, builds frame-wise SED/DOA targets from DCASE metadata CSVs and
overlapping chunk indices at the two frame rates (feature rate, label rate):
  * two frame rates: feature fs/hop (80 fps) vs label 10 fps; upsample ratio 8;
  * clips trimmed to 60 s (4800 feature frames / 600 label frames);
  * train chunks 8 s with 0.5 s hop, test 60 s (single chunk per file);
  * a leftover chunk appended when the hop does not divide the remainder;
  * SALSA-family scalers cover only the spectrogram channels;
  * classwise targets: one-hot SED + unit-vector DOA at label rate; overlapping
    same-class events resolved by writing tracks in increasing-duration order so
    the longest track wins;
  * trackwise targets (`n_tracks`, the `tracks` output format): each frame's
    active events in tracks 0..n_tracks-1 (`trackwise_targets`), the label
    tables' rows laid out flat: SED (n_tracks * n_classes), track-major, and DOA
    (n_tracks * 3), a track's xyz together.

The store is the on-disk `data.feature_store.FeatureStore` under
`feature_root_dir`, or one injected (`data.wav_database.MemoryFeatureStore`, the
features a from-wav run extracts at startup). `load_split(preload=False)` leaves
the features on disk: its `LazySplitData` reads each chunk window on access.
"""
from __future__ import annotations

import copy
import os
import threading
from dataclasses import dataclass, field

import numpy as np

from salsa_tpu_torch.data.feature_store import FeatureStore, open_clip
from salsa_tpu_torch.data.meta import split_filenames
from salsa_tpu_torch.utils.experiments import logger


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


def trackwise_targets(
    gt_rows: np.ndarray, n_label_frames: int, n_classes: int, n_tracks: int = 3
) -> tuple[np.ndarray, np.ndarray, int]:
    """(sed, doa, dropped) track-wise targets at label rate from metadata rows:
    at each frame the active events fill tracks 0..n_tracks-1 in ascending order
    of their metadata track index (rows of one index in file order), so two
    events of one class stay apart. sed: (T, n_tracks, n_classes) one-hot; doa:
    (T, n_tracks, 3) unit xyz, zero where a track is empty. `dropped` counts the
    events past the n_tracks-th of a frame, which are left out."""
    sed = np.zeros((n_label_frames, n_tracks, n_classes), dtype=np.float32)
    doa = np.zeros((n_label_frames, n_tracks, 3), dtype=np.float32)
    rows = gt_rows[gt_rows[:, 0].astype(int) < n_label_frames] if gt_rows.size else gt_rows
    dropped = 0
    for f in np.unique(rows[:, 0].astype(int)) if rows.size else ():
        events = rows[rows[:, 0].astype(int) == f]
        events = events[np.argsort(events[:, 2], kind="stable")]
        dropped += max(0, len(events) - n_tracks)
        for k, (_, cls, _, azi, ele) in enumerate(events[:n_tracks]):
            a, e = np.deg2rad(azi), np.deg2rad(ele)
            sed[f, k, int(cls)] = 1.0
            doa[f, k] = (np.cos(a) * np.cos(e), np.sin(a) * np.cos(e), np.sin(e))
    return sed, doa, dropped


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
    if isinstance(split, LazySplitData):
        out.clip_of_chunk = split.clip_of_chunk[:n_chunks]
        out.within_clip_start = split.within_clip_start[:n_chunks]
        out.clip_feature_frames = split.clip_feature_frames[:n_clips]
    return out


@dataclass
class LazySplitData(SplitData):
    """A split whose features stay on disk: each access reads the requested chunk
    window (a memory-mapped `.npy` slice, or an `.h5` hyperslab) and normalizes it.
    Targets and index tables are the preloaded SplitData's, and so is every window,
    bit for bit; `features` is a placeholder of shape (C, 0, F).

    For corpora whose features exceed host memory (the whole TNSSE2021 dev split
    is ~16 GB of float32)."""

    clip_paths: list[str] = field(default_factory=list)      # one per clip (ordered)
    clip_of_chunk: np.ndarray | None = None                  # chunk -> clip index
    within_clip_start: np.ndarray | None = None              # chunk -> frame offset
    clip_feature_frames: np.ndarray | None = None            # clip -> trimmed length
    normalize_fn: object = None                              # feature -> feature
    _tls: object = field(default_factory=threading.local, repr=False)

    def _open(self, path: str):
        """The clip's array-like, one open handle per (thread, clip): h5py handles
        are not thread-safe."""
        handles = getattr(self._tls, "handles", None)
        if handles is None:
            handles = self._tls.handles = {}
        if path not in handles:
            if len(handles) >= 32:  # bound the open handles
                for _arr, close in handles.values():
                    close()
                handles.clear()
            handles[path] = open_clip(path)
        return handles[path][0]

    def get_feature_chunk(self, index: int) -> np.ndarray:
        clip = int(self.clip_of_chunk[index])
        f0 = int(self.within_clip_start[index])
        # only up to the clip's trimmed length: frames past it are the pad region
        n_read = min(self.feature_chunk_len, max(int(self.clip_feature_frames[clip]) - f0, 0))
        window = self.normalize_fn(np.asarray(self._open(self.clip_paths[clip])[
            :, f0:f0 + n_read, :]))
        if window.shape[1] < self.feature_chunk_len:
            # a clip shorter than the chunk: zero-padded after normalization, as the
            # preloaded split pads the normalized clip
            window = np.pad(window, ((0, 0), (0, self.feature_chunk_len - window.shape[1]),
                                     (0, 0)))
        return window


class SeldDatabase:
    """Feature + ground-truth database for one (feature_type, audio_format) stream,
    over the FeatureStore at `feature_root_dir` or an injected store
    (`read_clip(split_kind, name)`, `read_scaler()`)."""

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
        n_tracks: int | None = None,
    ):
        if store is None:
            if not feature_root_dir:
                raise ValueError("SeldDatabase needs a feature_root_dir or a store")
            store = FeatureStore(feature_root_dir, audio_format)
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
        self.n_tracks = n_tracks
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

    def targets(self, split: str, clip_name: str,
                n_label_frames: int) -> tuple[np.ndarray, np.ndarray]:
        """A clip's label-table rows (sed, doa): class-wise (T, n_classes) and
        (T, 3 n_classes), or with `n_tracks` track-wise (T, n_tracks n_classes) and
        (T, 3 n_tracks); zeros where the clip has no metadata."""
        k = self.n_tracks
        widths = (self.n_classes, 3 * self.n_classes) if k is None else (k * self.n_classes,
                                                                         3 * k)
        gt_path = self.gt_meta_path(split, clip_name)
        if not (gt_path and os.path.isfile(gt_path)):
            return tuple(np.zeros((n_label_frames, w), dtype=np.float32) for w in widths)
        rows = parse_gt_csv(gt_path)
        if k is None:
            return classwise_targets(rows, n_label_frames, self.n_classes)
        sed, doa, dropped = trackwise_targets(rows, n_label_frames, self.n_classes, k)
        if dropped:
            logger.warning("%s: %d events past the %d tracks of their frames left out of the "
                           "labels", clip_name, dropped, k)
        return sed.reshape(n_label_frames, -1), doa.reshape(n_label_frames, -1)

    def gt_meta_path(self, split: str, clip_name: str) -> str | None:
        if self.gt_meta_root_dir is None:
            return None
        sub = "metadata_eval" if split == "eval" else "metadata_dev"
        return os.path.join(self.gt_meta_root_dir, sub, clip_name + ".csv")

    def load_split(self, split: str, split_meta_dir: str | None = None,
                   stage: str = "fit", preload: bool = True) -> SplitData:
        """stage 'fit' -> train chunking; 'inference' -> test chunking. With
        `preload` every clip's features are read from the store and normalized into
        memory; without it (a FeatureStore on disk) they stay there and the
        returned LazySplitData reads each chunk window on access."""
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
        clip_of_chunk, within_clip_start, clip_paths, lazy_clip_frames = [], [], [], []
        clip_chunk_counts, clip_label_frames = [], []
        f_ptr = l_ptr = 0
        chunks_per_clip = 0
        feat_shape = None
        for clip_idx, name in enumerate(names):
            if preload:
                feat = self.normalize(self.store.read_clip(split_kind, name))
                n_feat_frames = feat.shape[1]
            else:
                clip_paths.append(self.store.clip_path(split_kind, name))
                feat_shape = self.store.clip_shape(split_kind, name)
                n_feat_frames = feat_shape[1]
            n_frames = min(n_feat_frames, self.max_label_frames * self.label_upsample)
            n_frames -= n_frames % self.label_upsample
            n_label_frames = n_frames // self.label_upsample
            true_label_frames = n_label_frames
            trimmed_feat_frames = n_frames  # before any short-clip padding

            sed, doa = self.targets(split, name, n_label_frames)

            if n_frames < chunk_len:
                # clip shorter than the chunk window: zero-pad to one full chunk
                # (the true length is recorded so CSV output stops at real frames)
                if preload:
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
            if not preload:
                clip_of_chunk.extend([clip_idx] * len(starts_f))
                within_clip_start.extend(s - f_ptr for s in starts_f)
                lazy_clip_frames.append(trimmed_feat_frames)
            f_ptr += n_frames
            l_ptr += n_label_frames
            chunks_per_clip = max(chunks_per_clip, len(starts_f))
            clip_chunk_counts.append(len(starts_f))
            clip_label_frames.append(true_label_frames)
            if preload:
                features.append(feat[:, :n_frames, :])
            seds.append(sed)
            doas.append(doa)
            f_starts.extend(starts_f)
            l_starts.extend(starts_l)
            names_per_chunk.extend([name] * len(starts_f))

        common = dict(
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
        if preload:
            return SplitData(features=np.concatenate(features, axis=1), **common)
        return LazySplitData(
            features=np.zeros((feat_shape[0], 0, feat_shape[2]), dtype=np.float32),
            clip_paths=clip_paths,
            clip_of_chunk=np.asarray(clip_of_chunk, dtype=np.int64),
            within_clip_start=np.asarray(within_clip_start, dtype=np.int64),
            clip_feature_frames=np.asarray(lazy_clip_frames, dtype=np.int64),
            normalize_fn=self.normalize,
            **common,
        )
