"""Dataset split metadata for TAU-NIGENS Spatial Sound Events 2020/2021 (a copy of
`salsa_tpu.data.meta`).

The reference ships split CSVs (dataset/meta/dcase2021/...); their content is fully
regular, so the same lists are generated:
  dev split   = fold{1..6}_room{1,2}_mix{001..050}   (600 files)
  train       = folds 1-4 (400), val = fold 5 (100), test = fold 6 (100)
  eval split  = mix{001..200}                        (200 files)
Custom splits can still be supplied as CSV files with a `filename` column.
"""
from __future__ import annotations

import os

_FOLDS = {"train": (1, 2, 3, 4), "val": (5,), "test": (6,), "dev": (1, 2, 3, 4, 5, 6)}


def split_filenames(split: str, split_meta_dir: str | None = None) -> list[str]:
    """The ordered clip names (no extension) of a data split.

    If `split_meta_dir` holds `<split>.csv` (or `../eval.csv` for the eval split,
    as the reference lays its directory out), that file wins; otherwise the
    canonical TNSSE2021 split is generated.
    """
    if split_meta_dir:
        csv_path = (
            os.path.join(os.path.dirname(split_meta_dir.rstrip("/")), "eval.csv")
            if split == "eval"
            else os.path.join(split_meta_dir, f"{split}.csv")
        )
        if os.path.isfile(csv_path):
            with open(csv_path) as f:
                rows = [ln.strip() for ln in f if ln.strip()]
            if rows and rows[0].lower() == "filename":
                rows = rows[1:]
            return rows

    if split == "eval":
        return [f"mix{i:03d}" for i in range(1, 201)]
    if split not in _FOLDS:
        raise ValueError(f"unknown split '{split}'")
    return [
        f"fold{fold}_room{room}_mix{i:03d}"
        for fold in _FOLDS[split]
        for room in (1, 2)
        for i in range(1, 51)
    ]
