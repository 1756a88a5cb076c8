"""Ensemble-fusion CLI (counterpart of `salsa_tpu.cli.ensemble`): average the
per-clip prediction dumps of several trained models into one submission, or
average checkpoints in parameter space.

    # member predictions come from inference runs, which dump per clip:
    python -m salsa_tpu_torch.cli.infer --exp-config exp.yml --exp-suffix _seed1 --splits val
    python -m salsa_tpu_torch.cli.infer --exp-config exp.yml --exp-suffix _seed2 --splits val
    python -m salsa_tpu_torch.cli.ensemble \
        --pred-dirs outputs/.../exp_seed1/outputs/predictions/val \
                    outputs/.../exp_seed2/outputs/predictions/val \
        --out-dir ./ensemble_submissions/val --gt-meta-dir <data>/metadata_dev \
        [--weights 1 1] [--tune-threshold]
    python -m salsa_tpu_torch.cli.ensemble --ckpts a.msgpack b.msgpack --out-ckpt swa.msgpack

The dumps are the port's `.npz` or `salsa_tpu`'s `.h5` (the latter through h5py).
Host work only: no device is used.
"""
from __future__ import annotations

import argparse

from salsa_tpu_torch.cli._errors import cli_entry
from salsa_tpu_torch.metrics.scorer import evaluate_submissions
from salsa_tpu_torch.train.ensemble import (
    average_checkpoint_files,
    ensemble_predictions,
    write_ensemble,
)
from salsa_tpu_torch.train.threshold import sweep_fused
from salsa_tpu_torch.utils.experiments import configure_logging, logger


def ensemble(pred_dirs, out_dir: str, weights=None, n_classes: int = 12,
             sed_threshold: float = 0.3, version: str = "2021",
             gt_meta_dir: str | None = None, doa_threshold: float = 20.0,
             label_rate: int = 10, max_frames: int = 600,
             tune_threshold: bool = False) -> dict:
    """Fuse `pred_dirs` into `out_dir`'s CSVs; with `gt_meta_dir`, score them (and
    with `tune_threshold`, at the sweep's argmin). Returns the scores ({} without
    ground truth)."""
    fused = ensemble_predictions(list(pred_dirs), weights)
    # never score on fewer frames than the infer/evaluate default (600): dumps
    # shorter than the ground truth would truncate its events into misses, and a
    # single-member ensemble would no longer score as infer does
    max_frames = max(max_frames, *(ep.shape[0] for ep, _ in fused.values()))
    sweep = None
    if tune_threshold:
        # fusion flattens SED peaks (a mean of several [0, 1] curves), so the
        # single-model operating point is wrong for the fused dumps: re-tune on the
        # labelled split before writing the submission
        if gt_meta_dir is None:
            raise ValueError("--tune-threshold needs --gt-meta-dir (the labeled split to "
                             "calibrate on)")
        sweep = sweep_fused(fused, gt_meta_dir, n_classes, version=version,
                            doa_threshold=doa_threshold, label_rate=label_rate,
                            max_frames=max_frames)
        at_fixed = next((r for r in sweep["rows"]
                         if abs(r["threshold"] - sed_threshold) < 1e-9), None)
        logger.info("tuned sed_threshold %.2f (SELD %.4f vs %.4f at the fixed %.2f)",
                    sweep["best"]["threshold"], sweep["best"]["seld"],
                    at_fixed["seld"] if at_fixed else float("nan"), sed_threshold)
        sed_threshold = sweep["best"]["threshold"]
    written = write_ensemble(fused, out_dir, n_classes, sed_threshold=sed_threshold,
                             version=version)
    logger.info("ensemble of %d members: wrote %d submissions to %s", len(pred_dirs),
                len(written), out_dir)
    if gt_meta_dir is None:
        return {}
    scores = dict(evaluate_submissions(
        out_dir, gt_meta_dir, version=version, n_classes=n_classes,
        doa_threshold=doa_threshold, label_rate=label_rate, max_frames=max_frames,
        filenames=written))
    if sweep is not None:
        scores["tuned_threshold"] = sed_threshold
        scores["threshold_sweep"] = sweep
    logger.info("ensemble%s SELD %.4f ER %.4f F1 %.4f LE %.2f LR %.4f",
                " (tuned)" if sweep is not None else "", scores["seld_error"], scores["ER"],
                scores["F1"], scores["LE"], scores["LR"])
    return scores


@cli_entry
def main(argv: list[str] | None = None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--pred-dirs", nargs="+", default=None,
                   help="prediction dirs written by cli.infer (one per member)")
    p.add_argument("--out-dir", default=None,
                   help="directory for the fused submission CSVs")
    p.add_argument("--ckpts", nargs="+", default=None,
                   help="instead of output fusion: average these .msgpack checkpoints in "
                        "parameter space (SWA-style) into --out-ckpt; drop the result "
                        "into a models/best dir to infer with it")
    p.add_argument("--out-ckpt", default=None,
                   help="output path for the averaged checkpoint (.msgpack)")
    p.add_argument("--weights", nargs="+", type=float, default=None,
                   help="per-member fusion weights (default: uniform)")
    p.add_argument("--n-classes", type=int, default=12)
    p.add_argument("--sed-threshold", type=float, default=0.3)
    p.add_argument("--version", default="2021", choices=["2020", "2021"])
    p.add_argument("--gt-meta-dir", default=None,
                   help="ground-truth metadata dir; when given, score the fusion")
    p.add_argument("--doa-threshold", type=float, default=20.0)
    p.add_argument("--label-rate", type=int, default=10)
    p.add_argument("--max-frames", type=int, default=600,
                   help="minimum per-clip frame horizon for scoring (raised "
                        "automatically to the longest dump)")
    p.add_argument("--tune-threshold", action="store_true",
                   help="calibrate sed_threshold on the fused dumps against "
                        "--gt-meta-dir before writing the submission")
    a = p.parse_args(argv)
    configure_logging()
    if a.ckpts is not None:
        if a.out_ckpt is None:
            raise ValueError("--ckpts needs --out-ckpt")
        if a.pred_dirs is not None or a.out_dir is not None:
            raise ValueError("--ckpts (parameter-space SWA) and --pred-dirs/--out-dir "
                             "(output fusion) are separate modes; pass one set of "
                             "arguments only")
        out = average_checkpoint_files(a.ckpts, a.out_ckpt, a.weights)
        logger.info("averaged %d checkpoints -> %s", len(a.ckpts), out)
        return out
    if not a.pred_dirs or not a.out_dir:
        raise ValueError("need --pred-dirs and --out-dir (or --ckpts/--out-ckpt)")
    return ensemble(a.pred_dirs, a.out_dir, a.weights, a.n_classes, a.sed_threshold,
                    a.version, a.gt_meta_dir, a.doa_threshold, a.label_rate, a.max_frames,
                    tune_threshold=a.tune_threshold)


if __name__ == "__main__":
    main()
