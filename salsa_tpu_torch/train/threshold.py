"""The tuned SED operating point that `salsa-infer --tune-threshold` persists
beside an experiment's checkpoints (counterpart of the serving half of
`salsa_tpu.train.threshold`; the sweep needs the ensemble module, not ported)."""
from __future__ import annotations

import json
import os


def tuned_threshold_path(best_model_dir: str) -> str:
    """The sidecar carrying a tuned operating point, next to the checkpoints
    (like feature_scaler.npz) so serving finds it with the weights."""
    return os.path.join(os.path.dirname(best_model_dir), "tuned_threshold.json")


def load_tuned_threshold(best_model_dir: str) -> float | None:
    path = tuned_threshold_path(best_model_dir)
    if not os.path.isfile(path):
        return None
    with open(path) as f:
        return float(json.load(f)["sed_threshold"])
