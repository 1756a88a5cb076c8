"""Raw-waveform split loading for fused training (counterpart of
`salsa_tpu.data.wav_database`).

`load_wav_split` reads a split's wavs once and builds the chunk and label tables
that `SeldDatabase.load_split` builds over extracted features (same shuffle order,
steps per epoch and loss traces); the trainer keeps the waveforms resident on the
card and extracts each chunk's features inside the train step
(`features.chunked`). The scaler and the validation features are extracted on the
card at startup (`fit_scaler_from_waves`, `extract_split_to_store`): no HDF5 is
written or read.
"""
from __future__ import annotations

import os
from dataclasses import dataclass, field

import numpy as np
import torch

from salsa_tpu_torch.data.database import SplitData, chunk_starts
from salsa_tpu_torch.data.feature_store import StreamingScaler
from salsa_tpu_torch.data.meta import split_filenames
from salsa_tpu_torch.features.chunked import n_full_frames, pad_waveform
from salsa_tpu_torch.utils.audio_io import read_wav


class MemoryFeatureStore:
    """An in-memory feature store (read side), so that SeldDatabase.load_split
    builds a SplitData from features extracted at startup."""

    def __init__(self, clips: dict[str, np.ndarray],
                 scaler: tuple[np.ndarray, np.ndarray]):
        self._clips = clips
        self._scaler = scaler

    def read_clip(self, split_kind: str, clip_name: str) -> np.ndarray:
        return self._clips[clip_name]

    def read_scaler(self) -> tuple[np.ndarray, np.ndarray]:
        return self._scaler


@dataclass
class WavSplitData(SplitData):
    """A train split held as raw waveforms. Every chunk and label table is
    SplitData's (built in the same order); `features` is a placeholder of shape
    (n_channels, 0, n_features).

    waves: (n_clips, n_ch, S_pad_max) center-padded waveforms, zero tail past each
    clip's true length; int16 (half the memory, dequantized by wav_scale) or
    float32.
    """

    waves: np.ndarray | None = None
    wav_scale: float = 1.0                 # dequantization factor (1/32768 for int16)
    wav_pad: int = 0                       # center-pad samples per side
    clip_of_chunk: np.ndarray | None = None      # chunk -> clip index
    within_clip_start: np.ndarray | None = None  # chunk -> clip-local frame start
    clip_full_frames: np.ndarray | None = None   # untrimmed STFT frames (wrap modulus)
    clip_trimmed_frames: np.ndarray | None = None  # frames used for chunking/labels
    clip_wavs: list[np.ndarray] = field(default_factory=list)  # per-clip float, unpadded


def load_clip_waves(names: list[str], audio_dir: str, fs: int) -> list[np.ndarray]:
    """Each clip's multichannel float waveform, resampled to fs where needed."""
    return [read_wav(os.path.join(audio_dir, name + ".wav"), target_fs=fs)[0]
            for name in names]


def load_wav_split(
    db,
    split: str,
    audio_dir: str,
    split_meta_dir: str | None = None,
    wav_dtype: str = "float32",
    n_channels: int = 7,
    n_features: int = 200,
    pad: int | None = None,
) -> WavSplitData:
    """A train-stage WavSplitData whose chunk and label tables equal
    db.load_split(split, stage='fit')'s; db carries the chunking geometry (fs,
    hop, chunk lengths, label rate, n_classes, n_tracks, and n_fft as an attribute)
    and builds the label tables (`db.targets`). `pad`
    is the center pad per side (chunked.required_pad; default n_fft//2)."""
    if wav_dtype not in ("float32", "int16"):
        raise ValueError(f"wav_dtype '{wav_dtype}': the port keeps float32 or int16 "
                         "resident waveforms")
    names = split_filenames(split, split_meta_dir)
    chunk_len, chunk_hop = db.train_chunk_len, db.train_chunk_hop
    label_chunk_len = chunk_len // db.label_upsample

    clip_wavs = load_clip_waves(names, audio_dir, db.fs)
    n_fft = getattr(db, "n_fft", 512)
    if pad is None:
        pad = n_fft // 2

    seds, doas, names_per_chunk = [], [], []
    f_starts, l_starts = [], []
    clip_of_chunk, within_clip_start = [], []
    clip_chunk_counts, clip_label_frames = [], []
    clip_full, clip_trimmed = [], []
    f_ptr = l_ptr = 0
    chunks_per_clip = 0
    for clip_idx, (name, wav) in enumerate(zip(names, clip_wavs)):
        n_feat_frames = n_full_frames(wav.shape[1], db.hop_len)
        n_frames = min(n_feat_frames, db.max_label_frames * db.label_upsample)
        n_frames -= n_frames % db.label_upsample
        n_label_frames = n_frames // db.label_upsample
        true_label_frames = n_label_frames
        clip_full.append(n_feat_frames)
        clip_trimmed.append(n_frames)

        sed, doa = db.targets(split, name, n_label_frames)

        if n_frames < chunk_len:  # short clip: single zero-padded chunk
            pad_l = label_chunk_len - n_label_frames
            sed = np.pad(sed, ((0, pad_l), (0, 0)))
            doa = np.pad(doa, ((0, pad_l), (0, 0)))
            n_frames, n_label_frames = chunk_len, label_chunk_len

        starts_f = chunk_starts(n_frames, chunk_len, chunk_hop, f_ptr)
        starts_l = chunk_starts(
            n_label_frames, label_chunk_len, chunk_hop // db.label_upsample, l_ptr)
        if len(starts_f) != len(starts_l):
            raise ValueError(f"{name}: {len(starts_f)} feature chunks but "
                             f"{len(starts_l)} label chunks")
        clip_of_chunk.extend([clip_idx] * len(starts_f))
        within_clip_start.extend(s - f_ptr for s in starts_f)
        f_ptr += n_frames
        l_ptr += n_label_frames
        chunks_per_clip = max(chunks_per_clip, len(starts_f))
        clip_chunk_counts.append(len(starts_f))
        clip_label_frames.append(true_label_frames)
        seds.append(sed)
        doas.append(doa)
        f_starts.extend(starts_f)
        l_starts.extend(starts_l)
        names_per_chunk.extend([name] * len(starts_f))

    # resident tensor: center-pad each clip, zero-pad to the longest
    padded = [pad_waveform(w, n_fft, pad) for w in clip_wavs]
    s_max = max(p.shape[1] for p in padded)
    n_ch = padded[0].shape[0]
    if wav_dtype == "int16":
        waves = np.zeros((len(names), n_ch, s_max), dtype=np.int16)
        for i, p in enumerate(padded):
            waves[i, :, : p.shape[1]] = np.clip(
                np.round(p * 32768.0), -32768, 32767).astype(np.int16)
        wav_scale = 1.0 / 32768.0
    else:
        waves = np.zeros((len(names), n_ch, s_max), dtype=np.float32)
        for i, p in enumerate(padded):
            waves[i, :, : p.shape[1]] = p
        wav_scale = 1.0

    return WavSplitData(
        features=np.zeros((n_channels, 0, n_features), dtype=np.float32),
        sed_targets=np.concatenate(seds, axis=0),
        doa_targets=np.concatenate(doas, axis=0),
        feature_chunk_starts=np.asarray(f_starts, dtype=np.int64),
        label_chunk_starts=np.asarray(l_starts, dtype=np.int64),
        clip_names=names_per_chunk,
        feature_chunk_len=chunk_len,
        feature_chunk_hop=chunk_hop,
        label_chunk_len=label_chunk_len,
        label_chunk_hop=max(1, chunk_hop // db.label_upsample),
        chunks_per_clip=chunks_per_clip,
        unique_clip_names=list(names),
        clip_chunk_counts=np.asarray(clip_chunk_counts, dtype=np.int64),
        clip_label_frames=np.asarray(clip_label_frames, dtype=np.int64),
        waves=waves,
        wav_scale=wav_scale,
        wav_pad=pad,
        clip_of_chunk=np.asarray(clip_of_chunk, dtype=np.int32),
        within_clip_start=np.asarray(within_clip_start, dtype=np.int32),
        clip_full_frames=np.asarray(clip_full, dtype=np.int32),
        clip_trimmed_frames=np.asarray(clip_trimmed, dtype=np.int32),
        clip_wavs=clip_wavs,
    )


def length_groups(items: list, length_of) -> list[list[int]]:
    """Indices grouped by equal length, in order within each group."""
    groups: dict[int, list[int]] = {}
    for i, it in enumerate(items):
        groups.setdefault(length_of(it), []).append(i)
    return list(groups.values())


def _batches(waves: list[np.ndarray], batch_size: int):
    """(indices, stacked waves) per batch of up to batch_size equal-length clips."""
    for group in length_groups(waves, lambda w: w.shape[1]):
        for start in range(0, len(group), batch_size):
            idx = group[start : start + batch_size]
            yield idx, np.stack([waves[i] for i in idx])


def fit_scaler_from_waves(extractor, clip_wavs: list[np.ndarray], n_spec_channels: int,
                          batch_size: int = 8,
                          device: torch.device | str = "cuda") -> tuple[np.ndarray, np.ndarray]:
    """Extract each train clip once on `device` (for SALSA K1 and K2 on the card)
    and fit the normalization scaler over the leading n_spec_channels (the feature
    type's scaler scope): the reference's compute_scaler without the HDF5 round
    trip. Clips of equal length batch per call; each batch's (C, F) sums over clips
    and frames are taken in float64 on the device and accumulated in float64, the
    frame count 1 + S // hop a clip."""
    scaler = StreamingScaler(n_spec_channels)
    hop = extractor.hop_length
    for idx, stacked in _batches(clip_wavs, batch_size):
        feats = extractor(torch.from_numpy(stacked).to(device))[:, :n_spec_channels]
        s = torch.sum(feats, dim=(0, 2), dtype=torch.float64).cpu().numpy()
        ss = torch.sum(feats.double() ** 2, dim=(0, 2)).cpu().numpy()
        scaler.count += (1 + stacked.shape[-1] // hop) * len(idx)
        if scaler._sum is None:
            scaler._sum, scaler._sumsq = s, ss
        else:
            scaler._sum += s
            scaler._sumsq += ss
    return scaler.finalize()


def extract_split_to_store(extractor, names: list[str], audio_dir: str, fs: int, scaler,
                           batch_size: int = 8,
                           device: torch.device | str = "cuda") -> MemoryFeatureStore:
    """Extract a (small) split's full-clip features on `device` into a
    MemoryFeatureStore, so that validation reuses the SplitData path with no disk
    I/O. Clips of equal length batch per call."""
    waves = load_clip_waves(names, audio_dir, fs)
    clips: dict[str, np.ndarray] = {}
    for idx, stacked in _batches(waves, batch_size):
        feats = extractor(torch.from_numpy(stacked).to(device)).cpu().numpy()
        for j, i in enumerate(idx):
            clips[names[i]] = feats[j]
    return MemoryFeatureStore(clips, scaler)
