"""Inference CLI (counterpart of `salsa_tpu.cli.infer`), on the first CUDA card:
restores the best (or latest) checkpoint, reads each split from the experiment's
feature store (`feature_root_dir`, normalized with the store's scaler; nothing is
extracted) or, for a `training.from_wav` experiment, extracts it from its wavs on
the card (for SALSA K2 and K1 on every extraction batch, with the scaler training
saved), predicts it, writes submission CSVs and prediction dumps, and scores them
where ground truth exists.

    python -m salsa_tpu_torch.cli.infer --exp-config configs/seld.yml \
        --exp-group-dir ./outputs --exp-suffix _run1 --splits val test \
        [--checkpoint last] [--tta] [--tune-threshold | --use-tuned-threshold]

`--tta` averages the predictions over the array's channel-swap symmetry variants
(`train.tta`, folded into the batch on the card). `--tune-threshold` infers val
first, sweeps sed_threshold over its dumps (`train.threshold`), persists the
argmin as `models/tuned_threshold.json`, rewrites val's CSVs at it and infers the
other splits at it; `--use-tuned-threshold` applies a persisted one. The dumps are
`outputs/predictions/<split>/<clip>.npz` (`salsa_tpu` writes `.h5`; this host has
no h5py), which `cli.ensemble` fuses.

For a from-wav experiment the extractor takes the keys the model was trained
with, `eig_method` included (`cli.predict.feature_kwargs`), which `salsa_tpu`'s
infer drops.
"""
from __future__ import annotations

import argparse
import os
import time

import numpy as np
import torch

from salsa_tpu_torch.cli._errors import cli_entry
from salsa_tpu_torch.cli.predict import feature_kwargs
from salsa_tpu_torch.cli.train import build_database_from_cfg
from salsa_tpu_torch.data.meta import split_filenames
from salsa_tpu_torch.data.wav_database import extract_split_to_store
from salsa_tpu_torch.features.registry import make_extractor
from salsa_tpu_torch.interop import load_flax_variables
from salsa_tpu_torch.metrics.scorer import evaluate_submissions
from salsa_tpu_torch.models.seld import build_model
from salsa_tpu_torch.train import checkpoint as ckpt
from salsa_tpu_torch.train.ensemble import ensemble_predictions, write_ensemble
from salsa_tpu_torch.train.threshold import (
    load_tuned_threshold,
    save_tuned_threshold,
    sweep_fused,
)
from salsa_tpu_torch.train.trainer import SeldPredictor, resolve_device
from salsa_tpu_torch.train.tta import ChannelSwapTTA, tta_kind
from salsa_tpu_torch.utils.experiments import logger, manage_experiments


def _audio_dir(cfg, split: str) -> str:
    """The split's wav directory: `audio_root_dir`, else <gt root>/<fmt>_eval for
    the eval split and <fmt>_dev otherwise, falling back to <fmt>_dev."""
    fmt = cfg.data.audio_format
    audio_dir = cfg.get("audio_root_dir") or os.path.join(
        cfg.gt_meta_root_dir, f"{fmt}_{'eval' if split == 'eval' else 'dev'}")
    if not os.path.isdir(audio_dir):
        audio_dir = os.path.join(cfg.gt_meta_root_dir, f"{fmt}_dev")
    return audio_dir


def inference(exp_config: str, exp_group_dir: str = "./outputs", exp_suffix: str = "",
              splits=("val", "test"), checkpoint_kind: str = "best",
              use_tta: bool = False, tune_threshold: bool = False,
              use_tuned_threshold: bool = False,
              device: torch.device | str = "cuda") -> dict:
    """Infer `splits` of a from-wav experiment on `device` (the first CUDA card
    unless the caller asks for the CPU); returns {split: scores} (where ground
    truth exists), with "tuned_threshold" and "threshold_sweep" under
    `tune_threshold`."""
    device = resolve_device(device)
    cfg = manage_experiments(exp_config, exp_group_dir, exp_suffix, is_train=False)
    from_wav = cfg.get("training", {}).get("from_wav", False)
    tuned: float | None = None
    if tune_threshold:
        # calibrate on val first, then apply the tuned operating point to the
        # remaining splits
        splits = ["val"] + [s for s in splits if s != "val"]
    elif use_tuned_threshold:
        tuned = load_tuned_threshold(cfg.dir.model.best)
        if tuned is None:
            raise FileNotFoundError(
                "--use-tuned-threshold: no tuned_threshold.json beside the "
                "checkpoints — run `cli.infer --tune-threshold` first")
        logger.info("using persisted tuned sed_threshold %.2f", tuned)
    d = cfg.data
    if d.get("output_format") == "tracks" and (use_tta or tune_threshold):
        raise ValueError("--tta and --tune-threshold work on class-wise outputs; output_format "
                         "'tracks' (EINV2) is inferred without them")
    # the encoder named by the experiment: a PannResNet22TPU tree loads strictly
    # into PannResNet22 and would serve another network
    model = build_model(encoder=cfg.model.encoder.to_dict(), decoder=cfg.model.decoder.to_dict(),
                        n_classes=d.n_classes, output_format=d.get("output_format", "reg_xyz"))
    tta = None
    if use_tta:  # a stream without the kind's channels is refused here
        tta = ChannelSwapTTA(tta_kind(cfg.feature_type, d.audio_format), d.n_classes,
                             n_input_channels=cfg.model.encoder.n_input_channels)
    if checkpoint_kind == "best":
        path = ckpt.best_checkpoint(cfg.dir.model.best) or ckpt.latest_checkpoint(
            cfg.dir.model.checkpoint)
    else:
        path = ckpt.latest_checkpoint(cfg.dir.model.checkpoint)
    if path is None:
        raise FileNotFoundError("no checkpoint found; train first")
    if from_wav:
        scaler_path = os.path.join(os.path.dirname(cfg.dir.model.best), "feature_scaler.npz")
        if not os.path.isfile(scaler_path):
            raise FileNotFoundError(f"{scaler_path} not found — was this experiment trained "
                                    "with training.from_wav?")
        blob = np.load(scaler_path)
        scaler = (blob["mean"], blob["std"])
        extractor = make_extractor(cfg.feature_type, d.audio_format, **feature_kwargs(cfg))
    else:
        db = build_database_from_cfg(cfg)  # the feature store and its scaler
        if not db.store.has_scaler():
            raise FileNotFoundError(f"{db.store.scaler_path} not found: run cli.extract for "
                                    "the experiment's feature store (feature_root_dir)")
    params, batch_stats, _step = ckpt.restore_variables(path)
    predictor = SeldPredictor(load_flax_variables(model, params, batch_stats), cfg, device)

    version = str(cfg.get("eval_version", "2021"))
    split_meta_dir = cfg.get("split_meta_dir")
    results: dict = {}
    for split in splits:
        t0 = time.perf_counter()
        if from_wav:
            # a from-wav experiment carries no feature store: extract the split on
            # the device with the scaler training persisted
            store = extract_split_to_store(extractor, split_filenames(split, split_meta_dir),
                                           _audio_dir(cfg, split), d.fs, scaler, device=device)
            data = build_database_from_cfg(cfg, store).load_split(
                split, split_meta_dir=split_meta_dir, stage="inference")
        else:
            data = db.load_split(split, split_meta_dir=split_meta_dir, stage="inference",
                                 preload=d.get("preload", True))
        extract_s = time.perf_counter() - t0
        logger.info("[%s] restored %s (meta: %s)", split, path, ckpt.load_metadata(path))
        if tta is not None:
            logger.info("[%s] TTA enabled: %d symmetry variants", split, len(tta))
        if tuned is not None:
            predictor.sed_threshold = tuned
        sub_dir = os.path.join(cfg.dir.output_dir.submission, split)
        pred_dir = os.path.join(cfg.dir.output_dir.prediction, split)
        t0 = time.perf_counter()
        written = predictor.predict_split(data, sub_dir, tta=tta, output_pred_dir=pred_dir)
        logger.info("[%s] wrote %d submissions to %s", split, len(written), sub_dir)
        logger.info("[%s] %s in %.2f s, predicted in %.2f s (host clock)", split,
                    "extracted" if from_wav else "read from the store", extract_s,
                    time.perf_counter() - t0)

        gt_dir = os.path.join(cfg.gt_meta_root_dir,
                              "metadata_eval" if split == "eval" else "metadata_dev")
        if tune_threshold and split == "val":
            if not os.path.isdir(gt_dir):
                raise FileNotFoundError(f"--tune-threshold needs val ground truth at {gt_dir}")
            fused = ensemble_predictions([pred_dir])
            sweep = sweep_fused(fused, gt_dir, d.n_classes, version=version,
                                doa_threshold=cfg.get("doa_threshold", 20),
                                label_rate=d.label_rate)
            tuned = sweep["best"]["threshold"]
            sidecar = save_tuned_threshold(cfg.dir.model.best, sweep)
            at_default = next((r for r in sweep["rows"]
                               if abs(r["threshold"] - predictor.sed_threshold) < 1e-9), None)
            logger.info("[val] tuned sed_threshold %.2f (SELD %.4f vs %.4f at the fixed "
                        "%.2f) -> %s", tuned, sweep["best"]["seld"],
                        at_default["seld"] if at_default else float("nan"),
                        predictor.sed_threshold, sidecar)
            # val's submissions rewritten at the tuned operating point, so that this
            # run's artifacts agree (a single-member fusion thresholds the dumps)
            written = write_ensemble(fused, sub_dir, d.n_classes, sed_threshold=tuned,
                                     version=version)
            results["tuned_threshold"] = tuned
            results["threshold_sweep"] = sweep
        if os.path.isdir(gt_dir) and split != "eval":
            scores = evaluate_submissions(sub_dir, gt_dir, version=version,
                                          n_classes=d.n_classes,
                                          doa_threshold=cfg.get("doa_threshold", 20),
                                          label_rate=d.label_rate, filenames=written)
            logger.info("[%s] SELD %.4f ER %.4f F1 %.4f LE %.2f LR %.4f", split,
                        scores["seld_error"], scores["ER"], scores["F1"], scores["LE"],
                        scores["LR"])
            results[split] = scores
    return results


@cli_entry
def main(argv: list[str] | None = None):
    p = argparse.ArgumentParser()
    p.add_argument("--exp-config", required=True)
    p.add_argument("--exp-group-dir", default="./outputs")
    p.add_argument("--exp-suffix", default="")
    p.add_argument("--splits", nargs="+", default=["val", "test"])
    p.add_argument("--checkpoint", default="best", choices=["best", "last"])
    p.add_argument("--tta", action="store_true",
                   help="average predictions over channel-swap symmetry variants")
    p.add_argument("--tune-threshold", action="store_true",
                   help="calibrate sed_threshold on the val split (host-side sweep over "
                        "the prediction dumps), persist the argmin beside the "
                        "checkpoints, and apply it to the other splits")
    p.add_argument("--use-tuned-threshold", action="store_true",
                   help="apply a previously tuned sed_threshold (tuned_threshold.json) "
                        "instead of the config value")
    a = p.parse_args(argv)
    return inference(a.exp_config, a.exp_group_dir, a.exp_suffix, a.splits, a.checkpoint,
                     use_tta=a.tta, tune_threshold=a.tune_threshold,
                     use_tuned_threshold=a.use_tuned_threshold)


if __name__ == "__main__":
    main()
