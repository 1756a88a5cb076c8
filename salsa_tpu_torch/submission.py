"""Prediction post-processing: overlapping-chunk recombination and DCASE
submission CSV writing (a numpy copy of `salsa_tpu.train.submission`; importing
`salsa_tpu.train` pulls in jax, which the GPU host does not have), and the
track-wise writer of the `tracks` output format (EINV2), the port's own."""
from __future__ import annotations

import numpy as np

from salsa_tpu_torch.metrics.dcase_io import xyz_to_polar_deg


def combine_chunks(
    chunk_preds: np.ndarray,
    chunk_len: int,
    chunk_hop: int,
    n_frames: int = 600,
    method: str = "mean",
) -> np.ndarray:
    """(n_chunks, chunk_len, ...) -> (n_frames, ...) by stitching overlapping chunks.

    The first chunk writes its full window; each later chunk blends the overlap
    with the running value ('mean': arithmetic, 'gmean': geometric) then
    overwrites the tail, as the reference recombines.
    """
    starts = list(range(0, n_frames - chunk_len + 1, chunk_hop))
    if (n_frames - chunk_len) % chunk_hop != 0:
        starts.append(n_frames - chunk_len)
    if abs(chunk_preds.shape[0] - len(starts)) >= 2:
        raise ValueError(f"{chunk_preds.shape[0]} chunks vs {len(starts)} expected")
    out = np.zeros((n_frames,) + chunk_preds.shape[2:], dtype=np.float32)
    overlap = chunk_len - chunk_hop
    for i, s in enumerate(starts):
        e = s + chunk_len
        if i == 0:
            out[s:e] = chunk_preds[i]
        else:
            if method == "mean":
                out[s:s + overlap] = (out[s:s + overlap] + chunk_preds[i, :overlap]) / 2
            elif method == "gmean":
                out[s:s + overlap] = np.sqrt(out[s:s + overlap] * chunk_preds[i, :overlap])
            else:
                raise ValueError(f"unknown combine method '{method}'")
            out[s + overlap:e] = chunk_preds[i, overlap:]
    return out


def sed_from_accdoa(doa, n_classes: int):
    """SED probability = norm of the ACCDOA vector per class, of a numpy array or a
    torch tensor (`** 0.5` is a correctly rounded square root in both)."""
    x = doa[..., :n_classes]
    y = doa[..., n_classes:2 * n_classes]
    z = doa[..., 2 * n_classes:]
    return (x**2 + y**2 + z**2) ** 0.5


def _polar(x, y, z) -> tuple[np.ndarray, np.ndarray]:
    """Rounded integer degrees, azimuth 180 wrapped to -180 (the reference writer's)."""
    azi, ele = xyz_to_polar_deg(x, y, z)
    azi = np.around(azi).astype(int)
    return np.where(azi == 180, -180, azi), np.around(ele).astype(int)


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
    (reference writer, including the azi==180 -> -180 wrap, `_polar`)."""
    active = event_prob >= sed_threshold
    azi, ele = _polar(doa_xyz[:, :n_classes], doa_xyz[:, n_classes:2 * n_classes],
                      doa_xyz[:, 2 * n_classes:])
    if event_prob.shape[0] < max_frames:
        raise ValueError("prediction shorter than one file")
    lines = []
    for frame in range(max_frames):
        for cls in np.nonzero(active[frame])[0]:
            a, e = azi[frame, cls], ele[frame, cls]
            if version == "2021":
                lines.append(f"{frame},{cls},0,{a},{e}")
            else:
                lines.append(f"{frame},{cls},{a},{e}")
    with open(path, "w") as f:
        f.write("\n".join(lines) + ("\n" if lines else ""))


def write_trackwise_csv(
    path: str,
    event_prob: np.ndarray,
    doa_xyz: np.ndarray,
    n_classes: int,
    sed_threshold: float = 0.3,
    max_frames: int = 600,
    version: str = "2021",
) -> None:
    """DCASE rows from track-wise predictions, event_prob (T, K, n_classes) and
    doa_xyz (T, K, 3): one row for each (frame, track, class) at or above
    `sed_threshold`, at that track's DOA in rounded polar degrees. Version 2021
    writes `frame,class,track,azimuth,elevation`, so two events of one class in a
    frame stay apart; 2020 drops the track."""
    if event_prob.shape[0] < max_frames:
        raise ValueError("prediction shorter than one file")
    if event_prob.shape[-1] != n_classes:
        raise ValueError(f"event_prob has {event_prob.shape[-1]} classes, not {n_classes}")
    azi, ele = _polar(doa_xyz[..., 0], doa_xyz[..., 1], doa_xyz[..., 2])  # (T, K)
    lines = []
    for frame, track, cls in zip(*np.nonzero(event_prob[:max_frames] >= sed_threshold)):
        a, e = azi[frame, track], ele[frame, track]
        lines.append(f"{frame},{cls},{track},{a},{e}" if version == "2021"
                     else f"{frame},{cls},{a},{e}")
    with open(path, "w") as f:
        f.write("\n".join(lines) + ("\n" if lines else ""))

