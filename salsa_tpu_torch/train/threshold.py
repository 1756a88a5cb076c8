"""sed_threshold calibration on a validation split (counterpart of
`salsa_tpu.train.threshold`).

Averaging SED probabilities (over TTA variants, over ensemble members, or both)
flattens their peaks below the single-model operating point, so each fusion mode
has its own best threshold. The sweep scores prediction dumps at every threshold on
the host (no device work: the dumps already hold the per-frame probabilities),
picks the SELD-error argmin and persists it beside the experiment's checkpoints as
`tuned_threshold.json`, which `cli.infer --use-tuned-threshold` and
`cli.predict --use-tuned-threshold` read.

Used by `cli.infer --tune-threshold` and `cli.ensemble --tune-threshold`.
"""
from __future__ import annotations

import json
import os
import shutil
import tempfile

from salsa_tpu_torch.metrics.scorer import evaluate_submissions
from salsa_tpu_torch.train.ensemble import ensemble_predictions, write_ensemble

DEFAULT_THRESHOLDS = tuple(round(0.05 * k, 2) for k in range(2, 14))  # .10-.65


def sweep_fused(fused: dict, gt_meta_dir: str, n_classes: int,
                thresholds=DEFAULT_THRESHOLDS, version: str = "2021",
                doa_threshold: float = 20.0, label_rate: int = 10,
                max_frames: int = 600) -> dict:
    """Score `fused` clip predictions (name -> (event_prob, doa)) at every
    threshold; returns {"best": row, "rows": [...]} with rows sorted by
    threshold. Host work only: the CSVs go to a temporary directory, removed
    afterwards."""
    max_frames = max(max_frames, *(ep.shape[0] for ep, _ in fused.values()))
    tmp = tempfile.mkdtemp(prefix="salsa_thresh_")
    rows = []
    try:
        for t in thresholds:
            out_dir = os.path.join(tmp, f"t{t:.2f}")
            written = write_ensemble(fused, out_dir, n_classes, sed_threshold=t,
                                     version=version)
            s = evaluate_submissions(
                out_dir, gt_meta_dir, version=version, n_classes=n_classes,
                doa_threshold=doa_threshold, label_rate=label_rate,
                max_frames=max_frames, filenames=written)
            rows.append({"threshold": float(t),
                         "seld": round(float(s["seld_error"]), 6),
                         "ER": round(float(s["ER"]), 6),
                         "F1": round(float(s["F1"]), 6),
                         "LE": round(float(s["LE"]), 4),
                         "LR": round(float(s["LR"]), 6)})
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    best = min(rows, key=lambda r: r["seld"])
    return {"best": best, "rows": rows}


def sweep_pred_dirs(pred_dirs, gt_meta_dir: str, n_classes: int, weights=None, **kw) -> dict:
    """sweep_fused over the (possibly fused) prediction dumps in pred_dirs."""
    return sweep_fused(ensemble_predictions(list(pred_dirs), weights), gt_meta_dir,
                       n_classes, **kw)


def tuned_threshold_path(best_model_dir: str) -> str:
    """The sidecar carrying a tuned operating point, next to the checkpoints
    (like feature_scaler.npz) so serving finds it with the weights."""
    return os.path.join(os.path.dirname(best_model_dir), "tuned_threshold.json")


def save_tuned_threshold(best_model_dir: str, sweep: dict, tuned_on: str = "val") -> str:
    path = tuned_threshold_path(best_model_dir)
    with open(path, "w") as f:
        json.dump({"sed_threshold": sweep["best"]["threshold"], "tuned_on": tuned_on,
                   "best": sweep["best"], "rows": sweep["rows"]}, f, indent=1)
    return path


def load_tuned_threshold(best_model_dir: str) -> float | None:
    path = tuned_threshold_path(best_model_dir)
    if not os.path.isfile(path):
        return None
    with open(path) as f:
        return float(json.load(f)["sed_threshold"])
