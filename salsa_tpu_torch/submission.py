"""DCASE submission CSV writing (numpy copies of
`salsa_tpu.train.submission.write_classwise_csv` and
`salsa_tpu.metrics.dcase_io.xyz_to_polar_deg`; importing `salsa_tpu.train`
pulls in jax, which the GPU host does not have)."""
from __future__ import annotations

import numpy as np


def xyz_to_polar_deg(x, y, z):
    azi = np.rad2deg(np.arctan2(y, x))
    ele = np.rad2deg(np.arctan2(z, np.sqrt(np.asarray(x) ** 2 + np.asarray(y) ** 2)))
    return azi, ele


def write_classwise_csv(
    path: str,
    event_prob: np.ndarray,
    doa_xyz: np.ndarray,
    n_classes: int,
    sed_threshold: float = 0.3,
    max_frames: int = 600,
    version: str = "2021",
) -> None:
    """Threshold SED, convert xyz to rounded polar degrees, write DCASE rows
    (reference writer, including the azi==180 -> -180 wrap)."""
    active = event_prob >= sed_threshold
    x = doa_xyz[:, :n_classes]
    y = doa_xyz[:, n_classes : 2 * n_classes]
    z = doa_xyz[:, 2 * n_classes :]
    azi, ele = xyz_to_polar_deg(x, y, z)
    azi = np.around(azi)
    ele = np.around(ele)
    if event_prob.shape[0] < max_frames:
        raise ValueError("prediction shorter than one file")
    lines = []
    for frame in range(max_frames):
        for cls in np.nonzero(active[frame])[0]:
            a = int(azi[frame, cls])
            if a == 180:
                a = -180
            e = int(ele[frame, cls])
            if version == "2021":
                lines.append(f"{frame},{cls},0,{a},{e}")
            else:
                lines.append(f"{frame},{cls},{a},{e}")
    with open(path, "w") as f:
        f.write("\n".join(lines) + ("\n" if lines else ""))
