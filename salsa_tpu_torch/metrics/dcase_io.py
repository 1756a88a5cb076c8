"""DCASE SELD submission/metadata I/O and 1-second segment blocking (a numpy copy
of the scoring half of `salsa_tpu.metrics.dcase_io`, which the GPU host cannot
import):

  * `load_output_csv`  <- load_output_format_file (reference dcase_utils.py:8-57)
  * `segment_events`   <- segment_labels (dcase_utils.py:185-228)
  * `xyz_to_polar_deg` <- :60-109, used by the submission writer

`salsa_tpu`'s `polar_deg_to_xyz`, `sed_doa_to_event_dict` and
`classification_grid_labels` serve training and come with it.

Data model: a *frame event dict* maps frame_idx -> list of per-event rows
[class_idx, coord..., track]; a *block dict* maps block_idx -> {class_idx:
[[frame_offsets, per_frame_event_coord_lists]]} exactly as the scorers expect.
"""
from __future__ import annotations

import numpy as np

def load_output_csv(path: str, version: str = "2021") -> dict[int, list[list[float]]]:
    """Parse a DCASE-format CSV (submission or metadata) into a frame event dict.

    Supported row layouts (comma separated, no header):
      4 cols: frame, class, azi, ele                    (submission)
      5 cols: frame, class, track, azi, ele             (2021 metadata, polar)
      6 cols: frame, class, track, x, y, z              (cartesian metadata)
    Version '2021' keeps the track number as the trailing element of each event row;
    '2020' drops it.
    """
    events: dict[int, list[list[float]]] = {}
    with open(path, "r") as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            parts = line.split(",")
            frame = int(parts[0])
            cls = int(parts[1])
            row: list[float]
            if len(parts) == 4:
                coords = [float(parts[2]), float(parts[3])]
                track = 0
            elif len(parts) == 5:
                coords = [float(parts[3]), float(parts[4])]
                track = int(parts[2])
            elif len(parts) == 6:
                coords = [float(parts[3]), float(parts[4]), float(parts[5])]
                track = int(parts[2])
            else:
                raise ValueError(f"{path}: unparseable row '{line}'")
            if version == "2021":
                row = [cls, *coords, track]
            elif version == "2020":
                row = [cls, *coords]
            else:
                raise ValueError(f"unknown metric version '{version}'")
            events.setdefault(frame, []).append(row)
    return events


def segment_events(
    frame_events: dict[int, list[list[float]]],
    max_frames: int = 600,
    frames_per_block: int = 10,
) -> dict[int, dict[int, list]]:
    """Group frame-wise events into 1-second blocks, classwise.

    Returns blocks[block_idx][class_idx] = [[frame_offsets, coords_per_frame]] where
    frame_offsets are the within-block frame indices at which the class is active and
    coords_per_frame[i] is the list of coordinate rows (event row minus the class
    column) active at that frame.
    """
    n_blocks = int(np.ceil(max_frames / float(frames_per_block)))
    blocks: dict[int, dict[int, list]] = {b: {} for b in range(n_blocks)}
    for block in range(n_blocks):
        start = block * frames_per_block
        per_class: dict[int, dict[int, list]] = {}
        for offset in range(frames_per_block):
            frame = start + offset
            for row in frame_events.get(frame, ()):  # row: [class, coords..., (track)]
                cls = int(row[0])
                per_class.setdefault(cls, {}).setdefault(offset, []).append(row[1:])
        for cls, frames in per_class.items():
            offsets = list(frames.keys())
            coords = [frames[k] for k in offsets]
            blocks[block].setdefault(cls, []).append([offsets, coords])
    return blocks


def xyz_to_polar_deg(x, y, z):
    azi = np.rad2deg(np.arctan2(y, x))
    ele = np.rad2deg(np.arctan2(z, np.sqrt(np.asarray(x) ** 2 + np.asarray(y) ** 2)))
    return azi, ele
