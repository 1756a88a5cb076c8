"""File-level scoring: submission CSVs vs ground-truth metadata CSVs (a copy of
`salsa_tpu.metrics.scorer`, the standalone equivalent of reference
experiments/evaluate.py:16-87)."""
from __future__ import annotations

import os

from salsa_tpu_torch.metrics.dcase_io import load_output_csv, segment_events
from salsa_tpu_torch.metrics.seld_metrics import (
    SeldMetrics2021,
    SeldMetrics2020,
    seld_error_from_scores,
)


def evaluate_submissions(
    submission_dir: str,
    gt_meta_dir: str,
    version: str = "2021",
    n_classes: int = 12,
    doa_threshold: float = 20.0,
    label_rate: int = 10,
    max_frames: int = 600,
    filenames: list[str] | None = None,
) -> dict:
    """Score every CSV in submission_dir against same-named CSVs in gt_meta_dir.
    Returns dict with ER/F1/LE/LR/seld_error."""
    if filenames is None:
        filenames = sorted(
            f for f in os.listdir(submission_dir) if f.endswith(".csv")
        )
    scorer = (
        SeldMetrics2021(n_classes=n_classes, doa_threshold=doa_threshold)
        if version == "2021"
        else SeldMetrics2020(n_classes=n_classes, doa_threshold=doa_threshold)
    )
    for fn in filenames:
        pred = segment_events(
            load_output_csv(os.path.join(submission_dir, fn), version),
            max_frames=max_frames,
            frames_per_block=label_rate,
        )
        gt = segment_events(
            load_output_csv(os.path.join(gt_meta_dir, fn), version),
            max_frames=max_frames,
            frames_per_block=label_rate,
        )
        scorer.update(pred, gt)
    er, f1, le, lr = scorer.compute()
    return {
        "ER": float(er),
        "F1": float(f1),
        "LE": float(le),
        "LR": float(lr),
        "seld_error": float(seld_error_from_scores(er, f1, le, lr)),
    }
