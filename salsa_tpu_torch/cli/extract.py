"""Feature extraction CLI (counterpart of `salsa_tpu.cli.extract`): raw
multichannel wavs -> the per-clip feature store and its scaler, on the first CUDA
card:

    python -m salsa_tpu_torch.cli.extract --data-config configs/tnsse2021_salsa.yml \
        --feature-type salsa [--task feature_scaler] [--keep-existing]

Writes `<feature_dir>/<type>[/<fmt>]/<description>/<fmt>_{dev,eval}/<clip>.npy` and
`<fmt>_feature_scaler.npz` (`data.feature_store`), the directory `salsa_tpu`
writes, so that configs/seld.yml's `feature_root_dir` names it. Each split folder
is emptied first unless `--keep-existing` is given, which extracts only the
clips without a stored file. Input not at the config's rate is resampled. The
sorted wavs go in groups of `--batch-size`; a group of equal-length clips is one
batch on the card (for SALSA one K2 and one K1 launch), a group of mixed lengths
is extracted clip by clip. A short last group is not padded, so that no clip's
features depend on the clips batched with it. The scaler is fit over every clip
of the dev folder in sorted order (`StreamingScaler`). Each split's rate is
logged as x realtime on the host clock, the disk writes included. SALSA takes the
channel count of the first wav (2C - 1 feature channels, C of them scaled; any
C >= 2), 4-channel FOA or MIC arrays as configured.
"""
from __future__ import annotations

import argparse
import os
import shutil
import time

import numpy as np
import torch

from salsa_tpu_torch.cli._errors import cli_entry
from salsa_tpu_torch.data.feature_store import FeatureStore, StreamingScaler
from salsa_tpu_torch.features.registry import make_extractor
from salsa_tpu_torch.train.trainer import resolve_device
from salsa_tpu_torch.utils.audio_io import read_wav, wav_info
from salsa_tpu_torch.utils.config import load_config
from salsa_tpu_torch.utils.experiments import configure_logging, logger


def first_wav_channels(data_dir: str, splits: list[str]) -> int:
    """The channel count of the first wav (sorted) of the first split folder that
    has one; 4 where none has."""
    for split in splits:
        audio_dir = os.path.join(data_dir, split)
        wavs = sorted(f for f in os.listdir(audio_dir) if f.endswith(".wav")) if os.path.isdir(
            audio_dir) else []
        if wavs:
            return wav_info(os.path.join(audio_dir, wavs[0]))[0]
    return 4


def feature_dir_of(feature_dir: str, feature_type: str, audio_format: str,
                   description: str) -> str:
    """The store's directory under the data config's `feature_dir`."""
    if feature_type in ("salsa", "salsa_lite", "salsa_ipd"):
        return os.path.join(feature_dir, feature_type, audio_format, description)
    return os.path.join(feature_dir, feature_type, description)


def extract_features(
    data_config: str,
    feature_type: str = "salsa",
    task: str = "feature_scaler",
    cond_num: float = 5.0,
    n_hopframes: int = 3,
    is_tracking: bool = True,
    is_compress_high_freq: bool = True,
    eig_method: str = "auto",
    splits: list[str] | None = None,
    batch_size: int = 8,
    keep_existing: bool = False,
    device: torch.device | str = "cuda",
) -> str:
    """Extract `splits` (default `<fmt>_dev` and `<fmt>_eval`) of the data config's
    `data_dir` into the feature store and fit its scaler, on `device` (the first
    CUDA card unless the caller asks for the CPU). Returns the feature directory
    written."""
    device = resolve_device(device)
    cfg = load_config(data_config)
    d = cfg.data
    audio_format = d.get("format", "foa")
    fs = d.fs
    if splits is None:
        splits = [f"{audio_format}_dev", f"{audio_format}_eval"]
    extractor = make_extractor(
        feature_type, audio_format, fs=fs, n_fft=d.n_fft, hop_length=d.hop_len,
        win_length=d.get("win_len", d.n_fft), n_mels=d.get("n_mels", 128),
        fmin=d.get("fmin", 50), fmax=d.get("fmax", None), fmin_doa=d.get("fmin_doa", 50),
        fmax_doa=d.get("fmax_doa", None), condition_number=cond_num, n_hopframes=n_hopframes,
        is_tracking=is_tracking, compress_high_freq=is_compress_high_freq,
        eig_method=eig_method, n_mics=first_wav_channels(cfg.data_dir, splits))
    feature_dir = feature_dir_of(cfg.feature_dir, feature_type, audio_format,
                                 extractor.description)
    store = FeatureStore(feature_dir, audio_format)
    logger.info("Feature dir: %s", feature_dir)

    def extract(audios: list[np.ndarray]) -> np.ndarray:
        feats = extractor(torch.from_numpy(np.stack(audios)).to(device))
        return feats.cpu().numpy()

    if task in ("feature_scaler", "feature"):
        for split in splits:
            audio_dir = os.path.join(cfg.data_dir, split)
            if not os.path.isdir(audio_dir):
                logger.warning("skip split %s: %s not found", split, audio_dir)
                continue
            split_kind = "eval" if split.endswith("eval") else "dev"
            if not keep_existing:
                # the reference's semantics: the split's feature folder is emptied
                shutil.rmtree(store.split_dir(split_kind), ignore_errors=True)
            wavs = sorted(f for f in os.listdir(audio_dir) if f.endswith(".wav"))
            if keep_existing:
                wavs = [w for w in wavs if not store.has_clip(split_kind, w[:-4])]
                logger.info("[%s] resume: %d clips left to extract", split, len(wavs))
            t0 = time.time()
            audio_seconds = 0.0
            done = 0
            for start in range(0, len(wavs), batch_size):
                group = wavs[start:start + batch_size]
                audios = [read_wav(os.path.join(audio_dir, w), target_fs=fs)[0] for w in group]
                audio_seconds += sum(a.shape[1] for a in audios) / fs
                if len({a.shape[1] for a in audios}) > 1:
                    # mixed lengths: clip by clip (a batch must not change a clip's
                    # frame count)
                    feats = [extract([a])[0] for a in audios]
                else:
                    feats = extract(audios)
                for wav, feat in zip(group, feats):
                    store.write_clip(split_kind, wav[:-4], feat)
                done += len(group)
                logger.info("[%s] %d/%d (last: %s %s)", split, done, len(wavs), group[-1],
                            tuple(feats[-1].shape))
            dt = time.time() - t0
            if wavs:
                logger.info("[%s] %d clips, %.1f audio-s in %.1f s (%.1fx realtime)", split,
                            len(wavs), audio_seconds, dt, audio_seconds / max(dt, 1e-9))

    if task in ("feature_scaler", "scaler"):
        scaler = StreamingScaler(extractor.n_spec_channels)
        for name in store.clip_names("dev"):
            scaler.update(store.read_clip("dev", name))
        store.write_scaler(*scaler.finalize())
        logger.info("Scaler written: %s", store.scaler_path)
    return feature_dir


@cli_entry
def main(argv: list[str] | None = None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--data-config", required=True)
    p.add_argument("--feature-type", default="salsa")
    p.add_argument("--task", default="feature_scaler",
                   choices=["feature_scaler", "feature", "scaler"])
    p.add_argument("--cond-num", type=float, default=5.0)
    p.add_argument("--n-hopframes", type=int, default=3)
    p.add_argument("--no-tracking", action="store_true")
    p.add_argument("--no-compress-high-freq", action="store_true")
    p.add_argument("--eig-method", default="auto", choices=["auto", "power", "eigh", "pallas"])
    p.add_argument("--batch-size", type=int, default=8)
    p.add_argument("--keep-existing", action="store_true",
                   help="resume: skip clips whose feature file already exists "
                        "(by default the split's folder is emptied first)")
    a = p.parse_args(argv)
    configure_logging()
    return extract_features(
        a.data_config, feature_type=a.feature_type, task=a.task, cond_num=a.cond_num,
        n_hopframes=a.n_hopframes, is_tracking=not a.no_tracking,
        is_compress_high_freq=not a.no_compress_high_freq, eig_method=a.eig_method,
        batch_size=a.batch_size, keep_existing=a.keep_existing)


if __name__ == "__main__":
    main()
