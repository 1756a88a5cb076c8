"""SELD joint localization/detection metrics, DCASE 2020 and 2021 variants (a copy
of `salsa_tpu.metrics.seld_metrics`, numpy and scipy only).

Behavior-parity reimplementation of the official challenge scorers that the reference
vendors (metrics/SELD2021_evaluation_metrics.py, metrics/SELD2020_evaluation_metrics.py):
segment-based ER/F/LE/LR with Hungarian assignment of multi-track DOAs (2021) or
frame-aligned least-cost matching (2020). All matrices involved are tiny (<= a few
simultaneous tracks), so this stays on host in NumPy/SciPy.
"""
from __future__ import annotations

import numpy as np
from scipy.optimize import linear_sum_assignment

_EPS = np.finfo(float).eps


def great_circle_deg_xyz(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """Angular distance in degrees between two arrays of cartesian vectors.
    a: (..., 3), b: (..., 3); vectors are normalized first (eps-regularized)."""
    a = np.asarray(a, dtype=np.float64)
    b = np.asarray(b, dtype=np.float64)
    an = a / np.sqrt(np.sum(a * a, axis=-1, keepdims=True) + 1e-10)
    bn = b / np.sqrt(np.sum(b * b, axis=-1, keepdims=True) + 1e-10)
    cos = np.clip(np.sum(an * bn, axis=-1), -1.0, 1.0)
    return np.degrees(np.arccos(cos))


def great_circle_deg_polar_rad(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """Angular distance in degrees between (azi, ele) pairs given in radians."""
    a = np.asarray(a, dtype=np.float64)
    b = np.asarray(b, dtype=np.float64)
    cos = np.sin(a[..., 1]) * np.sin(b[..., 1]) + np.cos(a[..., 1]) * np.cos(
        b[..., 1]
    ) * np.cos(np.abs(a[..., 0] - b[..., 0]))
    return np.degrees(np.arccos(np.clip(cos, -1.0, 1.0)))


def _pairwise_cost(gt_doas: np.ndarray, pred_doas: np.ndarray) -> np.ndarray:
    """(n_gt, dims) x (n_pred, dims) -> (n_gt, n_pred) great-circle degrees.
    dims == 3 -> cartesian; dims == 2 -> polar radians."""
    if gt_doas.shape[-1] == 3:
        return great_circle_deg_xyz(gt_doas[:, None, :], pred_doas[None, :, :])
    return great_circle_deg_polar_rad(gt_doas[:, None, :], pred_doas[None, :, :])


def hungarian_match(gt_doas: np.ndarray, pred_doas: np.ndarray):
    """Least-cost assignment between gt and pred DOA sets.
    Returns (costs, gt_rows, pred_cols)."""
    cost = np.zeros((gt_doas.shape[0], pred_doas.shape[0]))
    if gt_doas.shape[0] and pred_doas.shape[0]:
        cost = _pairwise_cost(gt_doas, pred_doas)
    rows, cols = linear_sum_assignment(cost)
    return cost[rows, cols], rows, cols


def seld_error_from_scores(er: float, f1: float, le: float, lr: float) -> float:
    """Aggregate SELD error = (ER + (1-F) + LE/180 + (1-LR)) / 4
    (reference models/interfaces.py:179)."""
    return (er + (1.0 - f1) + le / 180.0 + (1.0 - lr)) / 4.0


class SeldMetrics2021:
    """DCASE2021 location-sensitive detection + class-sensitive localization scores
    with the multi-instance (track) extension."""

    def __init__(self, n_classes: int = 12, doa_threshold: float = 20.0):
        self.n_classes = n_classes
        self.doa_threshold = doa_threshold
        self.S = self.D = self.I = 0
        self.tp = self.fp = self.fn = 0
        self.n_ref = 0
        self.total_de = 0.0
        self.de_tp = self.de_fp = self.de_fn = 0

    def update(self, pred_blocks: dict, gt_blocks: dict) -> None:
        for block in range(len(gt_blocks)):
            gt_b = gt_blocks[block]
            pred_b = pred_blocks[block]
            block_fn = block_fp = 0
            for cls in range(self.n_classes):
                in_gt = cls in gt_b
                in_pred = cls in pred_b
                n_gt = (
                    max(len(v) for v in gt_b[cls][0][1]) if in_gt else None
                )
                n_pred = (
                    max(len(v) for v in pred_b[cls][0][1]) if in_pred else None
                )
                if in_gt:
                    self.n_ref += n_gt
                if in_gt and in_pred:
                    # Per gt "track" (positional index within a frame's event list),
                    # collect Hungarian-matched distances over frames where both gt
                    # and pred mark this class active.
                    track_dists: dict[int, list[float]] = {}
                    gt_frames, gt_coords = gt_b[cls][0]
                    pred_frames, pred_coords = pred_b[cls][0]
                    for gi, frame in enumerate(gt_frames):
                        if frame not in pred_frames:
                            continue
                        pi = pred_frames.index(frame)
                        gt_arr = np.array(gt_coords[gi], dtype=np.float64)
                        pred_arr = np.array(pred_coords[pi], dtype=np.float64)
                        gt_doas = gt_arr[:, :-1]
                        pred_doas = pred_arr[:, :-1]
                        if gt_doas.shape[-1] == 2:  # degrees -> radians
                            gt_doas = np.deg2rad(gt_doas)
                            pred_doas = np.deg2rad(pred_doas)
                        costs, rows, _ = hungarian_match(gt_doas, pred_doas)
                        for cost, row in zip(costs, rows):
                            track_dists.setdefault(int(row), []).append(float(cost))
                    if not track_dists:
                        # class predicted in the right block but never frame-aligned
                        block_fn += n_pred
                        self.fn += n_pred
                        self.de_fn += n_pred
                    else:
                        for dists in track_dists.values():
                            avg = sum(dists) / len(dists)
                            self.total_de += avg
                            self.de_tp += 1
                            if avg <= self.doa_threshold:
                                self.tp += 1
                            else:
                                block_fp += 1
                                self.fp += 1
                        if n_pred > n_gt:
                            extra = n_pred - n_gt
                            block_fp += extra
                            self.fp += extra
                            self.de_fp += extra
                        elif n_pred < n_gt:
                            missing = n_gt - n_pred
                            block_fn += missing
                            self.fn += missing
                            self.de_fn += missing
                elif in_gt:
                    block_fn += n_gt
                    self.fn += n_gt
                    self.de_fn += n_gt
                elif in_pred:
                    block_fp += n_pred
                    self.fp += n_pred
                    self.de_fp += n_pred
            self.S += min(block_fp, block_fn)
            self.D += max(0, block_fn - block_fp)
            self.I += max(0, block_fp - block_fn)

    def compute(self) -> tuple[float, float, float, float]:
        er = (self.S + self.D + self.I) / (self.n_ref + _EPS)
        f1 = self.tp / (_EPS + self.tp + 0.5 * (self.fp + self.fn))
        le = self.total_de / (self.de_tp + _EPS) if self.de_tp else 180.0
        lr = self.de_tp / (_EPS + self.de_tp + self.de_fn)
        return er, f1, le, lr


class SeldMetrics2020:
    """DCASE2020 scorer: classwise presence per block (no track counting); spatial
    error averaged over frame-aligned least-cost matches."""

    def __init__(self, n_classes: int = 14, doa_threshold: float = 20.0):
        self.n_classes = n_classes
        self.doa_threshold = doa_threshold
        self.S = self.D = self.I = 0
        self.tp = self.fp = self.fn = self.tn = 0
        self.n_ref = self.n_sys = 0
        self.total_de = 0.0
        self.de_tp = 0

    def update(self, pred_blocks: dict, gt_blocks: dict, coords: str = "polar_deg") -> None:
        """coords: 'polar_deg' (matches reference update_seld_scores) or 'xyz'."""
        for block in range(len(gt_blocks)):
            gt_b = gt_blocks[block]
            pred_b = pred_blocks[block]
            block_fn = block_fp = 0
            for cls in range(self.n_classes):
                in_gt = cls in gt_b
                in_pred = cls in pred_b
                if in_gt:
                    self.n_ref += 1
                if in_pred:
                    self.n_sys += 1
                if in_gt and in_pred:
                    total_dist = 0.0
                    n_matched = 0
                    gt_frames, gt_coords = gt_b[cls][0]
                    pred_frames, pred_coords = pred_b[cls][0]
                    for gi, frame in enumerate(gt_frames):
                        if frame not in pred_frames:
                            continue
                        pi = pred_frames.index(frame)
                        n_matched += 1
                        gt_arr = np.array(gt_coords[gi], dtype=np.float64)
                        pred_arr = np.array(pred_coords[pi], dtype=np.float64)
                        if coords == "polar_deg":
                            gt_arr = np.deg2rad(gt_arr)
                            pred_arr = np.deg2rad(pred_arr)
                        costs, _, _ = hungarian_match(gt_arr, pred_arr)
                        total_dist += float(costs.sum())
                    if total_dist == 0 and n_matched == 0:
                        block_fn += 1
                        self.fn += 1
                    else:
                        avg = total_dist / n_matched
                        self.total_de += avg
                        self.de_tp += 1
                        if avg <= self.doa_threshold:
                            self.tp += 1
                        else:
                            block_fn += 1
                            self.fn += 1
                elif in_gt:
                    block_fn += 1
                    self.fn += 1
                elif in_pred:
                    block_fp += 1
                    self.fp += 1
                else:
                    self.tn += 1
            self.S += min(block_fp, block_fn)
            self.D += max(0, block_fn - block_fp)
            self.I += max(0, block_fp - block_fn)

    def compute(self) -> tuple[float, float, float, float]:
        er = (self.S + self.D + self.I) / (self.n_ref + _EPS)
        prec = self.tp / (self.n_sys + _EPS)
        recall = self.tp / (self.n_ref + _EPS)
        f1 = 2 * prec * recall / (prec + recall + _EPS)
        le = self.total_de / (self.de_tp + _EPS) if self.de_tp else 180.0
        de_prec = self.de_tp / (self.n_sys + _EPS)
        de_recall = self.de_tp / (self.n_ref + _EPS)
        de_f = 2 * de_prec * de_recall / (de_prec + de_recall + _EPS)
        return er, f1, le, de_f
