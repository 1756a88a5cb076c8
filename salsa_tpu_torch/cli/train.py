"""Training CLI (counterpart of `salsa_tpu.cli.train`), on the first CUDA card:

    python -m salsa_tpu_torch.cli.train --exp-config configs/seld.yml \
        --exp-group-dir ./outputs [--exp-suffix _run1] [--resume] [--seed N] \
        [--set KEY=VALUE ...]

A config with `feature_root_dir` and no `training.from_wav` (configs/seld.yml as
written) trains from the feature store `cli.extract` wrote: the train and val
splits are read from it (`data.preload`, default true; false reads each chunk
window from disk), normalized with the store's scaler, and the host transforms of
`data.transforms` augment each train chunk on the host (`training.data_workers`
threads read the windows), each batch copied to the card while the next is built.
`training.device_data: true` keeps the train split on the card instead (float32,
or bfloat16 with `training.device_data_dtype`), and each step gathers its windows
there; the host transforms are then bypassed.

`training.from_wav: true` trains from raw wavs: it reads the train split's wavs,
fits the feature scaler on the card (for SALSA with K1 and K2; every feature type
of `salsa_tpu` is taken), saves it as `models/feature_scaler.npz`, extracts the
val split, and extracts the chunks inside every step. With `training.from_wav_mode:
precompute` the train split is extracted once on the card at startup into memory
and trained on the `device_data` path (K1 and K2 launch at startup only).

`training.device_augment: true | "feature"` augments every step's batch on the
device, in place of the host transforms. `training.remat: true` recomputes the
encoder's activations in the backward pass. `--resume` continues from the latest
checkpoint of the experiment's `models/checkpoint` (weights, BatchNorm statistics
and Adam's state) at the epoch after the one it recorded; each step's dropout and
augmentation draws are a function of (seed, step), so the resumed epochs are the
uninterrupted run's. Checkpoints are written as `epochNNN` and `best` in flax's
msgpack format (`.orbax` directories under `training.checkpoint_backend: orbax`);
the experiment is served by `salsa_tpu_torch.cli.predict` and by
`salsa_tpu.cli.predict`.

Data-parallel over N processes, one global batch of `train_batch_size` split by
rows (`train.trainer`), launched by torchrun or as `salsa_tpu`'s are:

    torchrun --nproc_per_node=N -m salsa_tpu_torch.cli.train --exp-config ...
    SALSA_COORDINATOR=host:port SALSA_NUM_PROCESSES=N SALSA_PROCESS_ID=i \
        python -m salsa_tpu_torch.cli.train --exp-config ...

The process group forms before anything touches a device
(`parallel.distributed.initialize`; NCCL with a card a rank, gloo where ranks
share a card); each rank trains on cuda:{LOCAL_RANK % device_count}. Rank 0
writes the scaler, the config snapshot, validation and the checkpoints;
`--resume` restores the checkpoint on every rank.
"""
from __future__ import annotations

import argparse
import os
import time

import numpy as np
import torch

from salsa_tpu_torch.cli._errors import cli_entry
from salsa_tpu_torch.data.database import SeldDatabase
from salsa_tpu_torch.data.meta import split_filenames
from salsa_tpu_torch.data.transforms import build_train_transforms
from salsa_tpu_torch.data.wav_database import (
    MemoryFeatureStore,
    extract_split_to_store,
    fit_scaler_from_waves,
    load_wav_split,
)
from salsa_tpu_torch.features.chunked import required_pad
from salsa_tpu_torch.features.registry import make_extractor
from salsa_tpu_torch.models.decoders import N_TRACKS
from salsa_tpu_torch.models.seld import build_model
from salsa_tpu_torch.train.checkpoint import check_backend, latest_checkpoint
from salsa_tpu_torch.parallel import distributed
from salsa_tpu_torch.train.trainer import SeldTrainer, resolve_device
from salsa_tpu_torch.utils.config import apply_overrides
from salsa_tpu_torch.utils.experiments import logger, manage_experiments


def build_database_from_cfg(cfg, store=None) -> SeldDatabase:
    """The config's database: over `store`, else the FeatureStore at
    `feature_root_dir`; track-wise label tables for the `tracks` output format, as
    many tracks as the decoder has."""
    return SeldDatabase(
        feature_root_dir=cfg.get("feature_root_dir"),
        store=store,
        gt_meta_root_dir=cfg.gt_meta_root_dir,
        audio_format=cfg.data.audio_format,
        n_classes=cfg.data.n_classes,
        fs=cfg.data.fs,
        hop_len=cfg.data.hop_len,
        label_rate=cfg.data.label_rate,
        train_chunk_len_s=cfg.data.train_chunk_len_s,
        train_chunk_hop_len_s=cfg.data.train_chunk_hop_len_s,
        test_chunk_len_s=cfg.data.test_chunk_len_s,
        test_chunk_hop_len_s=cfg.data.test_chunk_hop_len_s,
        scaler_channels=4 if cfg.feature_type.startswith("salsa") else None,
        max_file_len_s=cfg.data.get("max_file_len_s", 60.0),
        n_tracks=(cfg.model.decoder.get("n_tracks", N_TRACKS)
                  if cfg.data.get("output_format") == "tracks" else None),
    )


def build_trainer(exp_config: str, exp_group_dir: str = "./outputs", exp_suffix: str = "",
                  seed: int | None = None, overrides: list[str] | None = None,
                  device: torch.device | str = "cuda") -> SeldTrainer:
    """Everything `train` does before the first step, on `device` (the first CUDA
    card unless the caller asks for the CPU): returns the trainer, whose
    `setup_seconds` holds the host-clock seconds of reading the splits (from the
    store, or the wavs, the scaler fit, the train split's precompute, the tracker
    checkpoints and the val extraction). In a multi-process launch the process
    group forms first (`distributed.initialize`), and `device` 'cuda' is the
    rank's card."""
    distributed.initialize()
    device = resolve_device(device)
    cfg = manage_experiments(exp_config, exp_group_dir, exp_suffix,
                             is_train=distributed.is_primary())
    if overrides:
        apply_overrides(cfg, overrides)
    seed = seed if seed is not None else cfg.get("seed", 2021)
    check_backend(cfg.training.get("checkpoint_backend", "msgpack"))  # before any data

    mode = cfg.get("mode", "crossval")
    train_split = "train" if mode == "crossval" else "dev"
    # rank 0 validates: the other ranks read no val split
    val_split = "val" if mode == "crossval" and distributed.is_primary() else None
    if mode == "eval" and "best_epoch" in cfg.training:
        cfg.training.max_epochs = cfg.training.best_epoch
    split_meta_dir = cfg.get("split_meta_dir")
    d = cfg.data
    # built before any data is read: an unported model config refuses at once
    model = build_model(encoder=cfg.model.encoder.to_dict(), decoder=cfg.model.decoder.to_dict(),
                        n_classes=d.n_classes, output_format=d.get("output_format", "reg_xyz"))
    seconds = {}
    scaler = None
    if cfg.training.get("from_wav", False):
        train_data, val_data, scaler = _wav_splits(cfg, train_split, val_split, split_meta_dir,
                                                   device, seconds)
    else:
        if not cfg.get("feature_root_dir"):
            raise ValueError("the config names no feature store (feature_root_dir) and does "
                             "not train from wavs (training.from_wav): run cli.extract and "
                             "set feature_root_dir, or set training.from_wav: true")
        preload = cfg.data.get("preload", True)
        db = build_database_from_cfg(cfg)
        if not db.store.has_scaler():
            raise FileNotFoundError(f"{db.store.scaler_path} not found: run cli.extract for "
                                    "the config's feature store (feature_root_dir)")
        t0 = time.perf_counter()
        train_data = db.load_split(train_split, split_meta_dir=split_meta_dir, stage="fit",
                                   preload=preload)
        val_data = (db.load_split(val_split, split_meta_dir=split_meta_dir, stage="inference",
                                  preload=preload) if val_split else None)
        seconds["read"] = time.perf_counter() - t0
    logger.info("train chunks: %d, val chunks: %s", len(train_data),
                len(val_data) if val_data is not None else "-")
    joint_t, feat_t = build_train_transforms(
        cfg.feature_type, d.audio_format, d.n_classes, train_data.feature_chunk_len,
        train_data.features.shape[2], rng=np.random.default_rng(seed))
    if d.get("output_format") == "tracks":  # the channel swaps rewrite class-wise labels
        logger.info("output_format 'tracks': the host transforms' label-coupled channel "
                    "swaps are not applied")
        joint_t = None

    trainer = SeldTrainer(
        model=model, cfg=cfg, train_data=train_data, val_data=val_data,
        gt_meta_dir=os.path.join(cfg.gt_meta_root_dir, "metadata_dev"),
        submission_dir=cfg.dir.output_dir.submission, seed=seed, scaler=scaler,
        device=device, joint_transform=joint_t, feature_transform=feat_t)
    trainer.setup_seconds.update(seconds)
    return trainer


def _wav_splits(cfg, train_split: str, val_split: str | None, split_meta_dir, device,
                seconds: dict):
    """training.from_wav: (train split, val split, scaler). The train split's wavs
    are read and the scaler fit on `device` and saved beside the checkpoints; the
    val split is extracted on `device`. With from_wav_mode 'precompute' the train
    split is extracted on `device` too, into memory, and the config switched to
    the device_data path."""
    d = cfg.data
    audio_dir = cfg.get("audio_root_dir") or os.path.join(
        cfg.gt_meta_root_dir, f"{d.audio_format}_dev")
    extractor = make_extractor(
        cfg.feature_type, d.audio_format, fs=d.fs, n_fft=d.n_fft, hop_length=d.hop_len,
        win_length=d.get("win_len", d.n_fft), n_mels=d.get("n_mels", 128),
        fmin=d.get("fmin", 50), fmax=d.get("fmax", None), fmin_doa=d.get("fmin_doa", 50),
        fmax_doa=d.get("fmax_doa", None), eig_method=cfg.training.get("eig_method", "auto"))
    # the chunking geometry: no features are read through this database
    db = build_database_from_cfg(cfg, MemoryFeatureStore({}, None))
    db.n_fft = d.n_fft
    t0 = time.perf_counter()
    train_data = load_wav_split(
        db, train_split, audio_dir, split_meta_dir=split_meta_dir,
        wav_dtype=cfg.training.get("wav_dtype", "float32"), n_channels=extractor.n_channels,
        n_features=extractor.n_features, pad=required_pad(cfg.feature_type, d.n_fft))
    seconds["read"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    scaler = fit_scaler_from_waves(extractor, train_data.clip_wavs, extractor.n_spec_channels,
                                   device=device)
    seconds["scaler_fit"] = time.perf_counter() - t0
    # persisted for serving: a from-wav experiment has no feature store to carry it
    scaler_path = os.path.join(os.path.dirname(cfg.dir.model.best), "feature_scaler.npz")
    if distributed.is_primary():
        os.makedirs(os.path.dirname(scaler_path), exist_ok=True)
        np.savez(scaler_path, mean=scaler[0], std=scaler[1])
    if cfg.training.get("from_wav_mode", "fused") == "precompute":
        # the train split extracted once at startup into memory, then the
        # resident path: no extraction in the steps, no disk
        t0 = time.perf_counter()
        store = extract_split_to_store(extractor, split_filenames(train_split, split_meta_dir),
                                       audio_dir, d.fs, scaler, device=device)
        train_data = build_database_from_cfg(cfg, store).load_split(
            train_split, split_meta_dir=split_meta_dir, stage="fit")
        seconds["precompute"] = time.perf_counter() - t0
        cfg.training.from_wav = False
        cfg.training.device_data = True
        logger.info("from_wav precompute: %d train clips extracted on %s (%.2f GB features) "
                    "-> resident path", len(train_data.unique_clip_names), device,
                    train_data.features.nbytes / 1e9)
    else:
        logger.info("from_wav: %d train clips resident (%s, %.2f GB), scaler fit on %s -> %s",
                    len(train_data.clip_wavs), train_data.waves.dtype,
                    train_data.waves.nbytes / 1e9, device, scaler_path)
    val_data = None
    if val_split:
        t0 = time.perf_counter()
        val_store = extract_split_to_store(extractor, split_filenames(val_split, split_meta_dir),
                                           audio_dir, d.fs, scaler, device=device)
        val_data = build_database_from_cfg(cfg, val_store).load_split(
            val_split, split_meta_dir=split_meta_dir, stage="inference")
        seconds["val_extract"] = time.perf_counter() - t0
    return train_data, val_data, scaler


def train(exp_config: str, exp_group_dir: str = "./outputs", exp_suffix: str = "",
          seed: int | None = None, overrides: list[str] | None = None,
          device: torch.device | str = "cuda", resume: bool = False) -> SeldTrainer:
    """Train an experiment (from its feature store, or from raw wavs) on `device`
    (the first CUDA card unless the caller asks for the CPU); with `resume`, from
    the experiment's latest checkpoint where it has one. Returns the trainer after
    `fit`."""
    trainer = build_trainer(exp_config, exp_group_dir, exp_suffix, seed, overrides, device)
    resume_path = latest_checkpoint(trainer.cfg.dir.model.checkpoint) if resume else None
    trainer.fit(resume_from=resume_path)
    return trainer


@cli_entry
def main(argv: list[str] | None = None):
    p = argparse.ArgumentParser()
    p.add_argument("--exp-config", required=True)
    p.add_argument("--exp-group-dir", default="./outputs")
    p.add_argument("--exp-suffix", default="")
    p.add_argument("--resume", action="store_true",
                   help="continue from the experiment's latest checkpoint")
    p.add_argument("--seed", type=int, default=None)
    p.add_argument("--set", dest="overrides", action="append", default=[],
                   metavar="KEY=VALUE", help="dotted config overrides, repeatable")
    a = p.parse_args(argv)
    return train(a.exp_config, a.exp_group_dir, a.exp_suffix, a.seed, a.overrides,
                 resume=a.resume)


if __name__ == "__main__":
    main()
