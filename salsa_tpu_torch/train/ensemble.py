"""Prediction-level ensemble fusion and checkpoint averaging (counterpart of
`salsa_tpu.train.ensemble`).

Output-space fusion: the weighted arithmetic mean of per-frame event probabilities
and of raw xyz DOA outputs across any number of prediction dumps (checkpoints,
seeds, feature types, TTA on or off: anything `cli.infer` wrote), then DCASE
submission writing through the same writer as single-model inference. DOA vectors
are not re-normalized, as the chunk recombination does not.

The dumps are the port's `<clip>.npz` or `salsa_tpu`'s `<clip>.h5` (read through
h5py, imported only where a directory holds them), with the same arrays under the
same names. Parameter-space fusion (`average_checkpoint_files`, SWA-style) reads and
writes flax msgpack through the port's codec, with no flax or jax.
"""
from __future__ import annotations

import json
import os
from glob import glob

import numpy as np

from salsa_tpu_torch.submission import write_classwise_csv
from salsa_tpu_torch.train.checkpoint import msgpack_restore, packb

__all__ = ["load_prediction_dir", "ensemble_predictions", "write_ensemble",
           "average_checkpoint_files"]


def _read_h5(path: str) -> tuple[np.ndarray, np.ndarray]:
    try:
        import h5py
    except ImportError as e:
        raise ImportError(f"{path} is a salsa_tpu prediction dump (.h5), which needs h5py, "
                          "and h5py is not installed; the port's dumps are .npz") from e
    with h5py.File(path, "r") as hf:
        return (np.asarray(hf["event_frame_pred"], dtype=np.float32),
                np.asarray(hf["doa_frame_pred"], dtype=np.float32))


def _read_npz(path: str) -> tuple[np.ndarray, np.ndarray]:
    with np.load(path) as blob:
        return (np.asarray(blob["event_frame_pred"], dtype=np.float32),
                np.asarray(blob["doa_frame_pred"], dtype=np.float32))


def load_prediction_dir(pred_dir: str) -> dict[str, tuple[np.ndarray, np.ndarray]]:
    """Read every per-clip prediction dump (`*.npz`, and `*.h5` through h5py) in
    `pred_dir`. Returns {clip_name: (event_prob (T, n_classes), doa_xyz (T,
    3*n_classes))}. A clip dumped in both formats is refused."""
    paths = {ext: sorted(glob(os.path.join(pred_dir, f"*.{ext}"))) for ext in ("npz", "h5")}
    if not paths["npz"] and not paths["h5"]:
        raise FileNotFoundError(f"no prediction dumps (*.npz, *.h5) in {pred_dir!r} — "
                                "run cli.infer with a prediction dir first")
    names = {ext: {os.path.splitext(os.path.basename(p))[0] for p in ps}
             for ext, ps in paths.items()}
    both = names["npz"] & names["h5"]
    if both:
        raise ValueError(f"{pred_dir}: clips dumped both as .npz and as .h5 (e.g. "
                         f"{sorted(both)[:3]}); keep one dump per clip")
    out = {}
    for p in sorted(paths["npz"] + paths["h5"]):
        ep, dp = (_read_npz if p.endswith(".npz") else _read_h5)(p)
        # dumps carry a leading singleton batch axis (reference layout)
        out[os.path.splitext(os.path.basename(p))[0]] = (ep[0], dp[0])
    return dict(sorted(out.items()))


def ensemble_predictions(
    pred_dirs: list[str], weights: list[float] | None = None
) -> dict[str, tuple[np.ndarray, np.ndarray]]:
    """Weighted mean of per-clip predictions across `pred_dirs`.

    Every directory must cover the same clip set with the same frame counts
    (they came from the same split); mismatches raise rather than silently
    fusing different data.
    """
    if weights is None:
        weights = [1.0] * len(pred_dirs)
    if len(weights) != len(pred_dirs):
        raise ValueError(f"{len(pred_dirs)} prediction dirs but {len(weights)} weights")
    wsum = float(sum(weights))
    if wsum <= 0:
        raise ValueError("ensemble weights must sum to a positive value")

    fused: dict[str, tuple[np.ndarray, np.ndarray]] = {}
    names: set[str] | None = None
    for d, w in zip(pred_dirs, weights):
        preds = load_prediction_dir(d)
        if names is None:
            names = set(preds)
        elif set(preds) != names:
            only_here = set(preds) ^ names
            raise ValueError(f"prediction dirs cover different clip sets (e.g. "
                             f"{sorted(only_here)[:3]}) — fuse dumps from the same split")
        for name, (ep, dp) in preds.items():
            if name in fused:
                fe, fd = fused[name]
                if fe.shape != ep.shape or fd.shape != dp.shape:
                    raise ValueError(f"{name}: prediction shapes differ across members "
                                     f"({fe.shape}/{fd.shape} vs {ep.shape}/{dp.shape})")
                fused[name] = (fe + w * ep, fd + w * dp)
            else:
                fused[name] = (w * ep, w * dp)
    return {n: (ep / wsum, dp / wsum) for n, (ep, dp) in fused.items()}


def _leaves(tree) -> list:
    """The leaves of a nested dict in sorted key order at every level, the order of
    `jax.tree.flatten`."""
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree) for leaf in _leaves(tree[k])]
    return [tree]


def _structure(tree):
    """The nested dict's keys, empty dicts included, with the leaves dropped: two
    trees flatten alike where their structures are equal."""
    return {k: _structure(v) for k, v in tree.items()} if isinstance(tree, dict) else None


def _sorted(tree, leaves=None):
    """`tree` with every dict's keys in sorted order (as flax serializes a copy of a
    pytree: `jax.tree.map` rebuilds dicts sorted, so the bytes are flax's), its
    leaves taken in that order from the iterator `leaves` where one is given."""
    if isinstance(tree, dict):
        return {k: _sorted(tree[k], leaves) for k in sorted(tree)}
    return tree if leaves is None else next(leaves)


def average_checkpoint_files(
    paths: list[str], out_path: str, weights: list[float] | None = None
) -> str:
    """Parameter-space fusion (SWA-style): weighted mean of several same-shape
    checkpoints into one checkpoint, so one inference pass instead of N.

    Float leaves of params and batch_stats are averaged in float64 in member order
    and cast back (averaging BN running stats across same-architecture members is
    the usual cheap SWA approximation); integer leaves, `step` and `opt_state` come
    from the first member, so a fused checkpoint is an inference artifact. The
    trees are walked in sorted key order, as `jax.tree.flatten` walks them, so the
    leaves, and the file's bytes, are `salsa_tpu`'s, and `salsa_tpu` restores the
    file. Writes the `.json` sidecar beside it.
    """
    if weights is None:
        weights = [1.0] * len(paths)
    if len(weights) != len(paths):
        raise ValueError(f"{len(paths)} checkpoints but {len(weights)} weights")
    wsum = float(sum(weights))
    if wsum <= 0:
        raise ValueError("ensemble weights must sum to a positive value")
    if not out_path.endswith(".msgpack"):
        raise ValueError("averaged checkpoint must be written as .msgpack")

    def load(p):
        with open(p, "rb") as f:
            return msgpack_restore(f.read())

    def floating(v) -> bool:
        return np.issubdtype(np.asarray(v).dtype, np.floating)

    base = load(paths[0])
    trees = {"params": base["params"], "batch_stats": base["batch_stats"]}
    flat_base = _leaves(trees)
    acc = [weights[0] * np.asarray(v, np.float64) if floating(v) else v for v in flat_base]
    for p, w in zip(paths[1:], weights[1:]):
        other = load(p)
        other = {"params": other["params"], "batch_stats": other["batch_stats"]}
        if _structure(other) != _structure(trees):
            raise ValueError(f"{p}: parameter tree differs from {paths[0]} — weight "
                             "averaging needs identical architectures")
        for i, v in enumerate(_leaves(other)):
            v = np.asarray(v)
            if np.issubdtype(v.dtype, np.floating):
                if v.shape != np.asarray(acc[i]).shape:
                    raise ValueError(f"{p}: leaf shape {v.shape} != {np.asarray(acc[i]).shape}")
                acc[i] = acc[i] + w * v.astype(np.float64)
    out = []
    for orig, a in zip(flat_base, acc):
        orig = np.asarray(orig)
        out.append((np.asarray(a) / wsum).astype(orig.dtype)
                   if np.issubdtype(orig.dtype, np.floating) else orig)
    fused = _sorted(trees, iter(out))
    payload = {"step": base.get("step", 0), "params": fused["params"],
               "batch_stats": fused["batch_stats"], "opt_state": base.get("opt_state", {})}
    os.makedirs(os.path.dirname(os.path.abspath(out_path)), exist_ok=True)
    with open(out_path, "wb") as f:
        f.write(packb(_sorted(payload)))
    with open(os.path.splitext(out_path)[0] + ".json", "w") as f:
        json.dump({"step": int(np.asarray(payload["step"])),
                   "averaged_from": [os.path.basename(p) for p in paths],
                   "weights": list(map(float, weights))}, f, indent=2)
    return out_path


def write_ensemble(
    fused: dict[str, tuple[np.ndarray, np.ndarray]],
    submission_dir: str,
    n_classes: int,
    sed_threshold: float = 0.3,
    version: str = "2021",
) -> list[str]:
    """Write one DCASE submission CSV per fused clip; returns filenames."""
    os.makedirs(submission_dir, exist_ok=True)
    written = []
    for name, (ep, dp) in sorted(fused.items()):
        fn = name + ".csv"
        write_classwise_csv(os.path.join(submission_dir, fn), ep, dp, n_classes,
                            sed_threshold=sed_threshold, max_frames=ep.shape[0],
                            version=version)
        written.append(fn)
    return written
