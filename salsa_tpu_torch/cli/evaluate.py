"""Standalone scoring CLI (counterpart of `salsa_tpu.cli.evaluate`): score a
directory of submission CSVs against ground-truth metadata.

    python -m salsa_tpu_torch.cli.evaluate --output-dir ./preds \
        --gt-meta-root-dir /data/dcase2021/task3 [--eval-split]
"""
from __future__ import annotations

import argparse
import os

from salsa_tpu_torch.cli._errors import cli_entry
from salsa_tpu_torch.metrics.scorer import evaluate_submissions
from salsa_tpu_torch.utils.experiments import configure_logging, logger


def evaluate_seld(output_dir: str, gt_meta_root_dir: str, metric_version: str = "2021",
                  n_classes: int = 12, is_eval_split: bool = False,
                  label_rate: int = 10, doa_threshold: float = 20.0) -> dict:
    gt_dir = os.path.join(
        gt_meta_root_dir, "metadata_eval" if is_eval_split else "metadata_dev"
    )
    scores = evaluate_submissions(
        output_dir, gt_dir, version=metric_version, n_classes=n_classes,
        doa_threshold=doa_threshold, label_rate=label_rate,
    )
    logger.info(
        "SELD error: %.4f | ER: %.4f F1: %.4f LE: %.2f LR: %.4f",
        scores["seld_error"], scores["ER"], scores["F1"], scores["LE"], scores["LR"],
    )
    return scores


@cli_entry
def main(argv: list[str] | None = None):
    p = argparse.ArgumentParser()
    p.add_argument("--output-dir", required=True)
    p.add_argument("--gt-meta-root-dir", required=True)
    p.add_argument("--metric-version", default="2021", choices=["2020", "2021"])
    p.add_argument("--n-classes", type=int, default=12)
    p.add_argument("--eval-split", action="store_true")
    a = p.parse_args(argv)
    configure_logging()
    return evaluate_seld(a.output_dir, a.gt_meta_root_dir, a.metric_version, a.n_classes,
                         a.eval_split)


if __name__ == "__main__":
    main()
