"""Direct wav -> submission CSV serving CLI (counterpart of the batch path of
`salsa_tpu.cli.predict`): serves a trained `salsa_tpu` experiment (YAML config,
flax msgpack checkpoint with its JSON sidecar, `feature_scaler.npz`) over a
directory of multichannel wavs through `SeldInferencePipeline`, on the first CUDA
card:

    python -m salsa_tpu_torch.cli.predict --exp-config configs/seld.yml \
        --exp-group-dir ./outputs --exp-suffix _run1 \
        --wav-dir /data/dcase2021/task3/foa_eval --out-dir ./preds

Streaming serving (`--streaming`, `--pool`, `--pcm16`, `--max-lag-ms`) is not ported
yet and raises NotImplementedError.
"""
from __future__ import annotations

import argparse
import os
import time

import numpy as np
import torch

from salsa_tpu_torch.cli._errors import cli_entry
from salsa_tpu_torch.features.registry import make_extractor
from salsa_tpu_torch.models.seld import build_model
from salsa_tpu_torch.pipeline import SeldInferencePipeline
from salsa_tpu_torch.submission import write_classwise_csv
from salsa_tpu_torch.train import checkpoint as ckpt
from salsa_tpu_torch.train.threshold import load_tuned_threshold
from salsa_tpu_torch.utils.audio_io import read_wav
from salsa_tpu_torch.utils.experiments import logger, manage_experiments


def _load_scaler(cfg, audio_format: str):
    """Train-split scaler for serving: `feature_scaler.npz` beside the checkpoints.
    `salsa_tpu` reads the feature store's h5 scaler first where the experiment has
    one; this package cannot read HDF5, and serving the npz instead could serve
    another scaler, so an h5 scaler is refused."""
    root = cfg.get("feature_root_dir")
    npz = os.path.join(os.path.dirname(cfg.dir.model.best), "feature_scaler.npz")
    h5 = os.path.join(root, f"{audio_format}_feature_scaler.h5") if root else None
    if h5 and os.path.isfile(h5):
        raise ValueError(
            f"the experiment's scaler is the feature store's {h5}, which this package "
            f"cannot read (no h5py); salsa_tpu serves with it ahead of {npz}, so that "
            f"file is not taken in its place. Write the h5's mean and std to {npz} and "
            "set feature_root_dir: null, or serve with salsa_tpu")
    if os.path.isfile(npz):
        blob = np.load(npz)
        return blob["mean"], blob["std"]
    raise FileNotFoundError(
        "no train-split scaler found: neither a feature-store scaler "
        f"({root or 'feature_root_dir unset'}) nor {npz} — train first")


def predict(exp_config: str, wav_dir: str, out_dir: str,
            exp_group_dir: str = "./outputs", exp_suffix: str = "",
            checkpoint_kind: str = "best", batch_size: int = 4,
            use_tuned_threshold: bool = False,
            device: torch.device | str = "cuda") -> str:
    """Serve every wav of `wav_dir` into `<out_dir>/<name>.csv`; returns out_dir.
    Runs on `device`, the first CUDA card unless the caller asks for the CPU."""
    cfg = manage_experiments(exp_config, exp_group_dir, exp_suffix)
    if use_tuned_threshold:
        tuned = load_tuned_threshold(cfg.dir.model.best)
        if tuned is None:
            raise FileNotFoundError(
                "--use-tuned-threshold: no tuned_threshold.json beside the "
                "checkpoints — run `salsa-infer --tune-threshold` first")
        # every CSV below reads cfg's sed_threshold, so serving applies the
        # val-calibrated operating point uniformly
        cfg.sed_threshold = tuned
        logger.info("serving with tuned sed_threshold %.2f", tuned)
    d = cfg.data
    extractor = make_extractor(
        cfg.feature_type, d.audio_format, fs=d.fs, n_fft=d.n_fft,
        hop_length=d.hop_len, win_length=d.get("win_len", d.n_fft),
        fmin_doa=d.get("fmin_doa", 50), fmax_doa=d.get("fmax_doa", None),
    )
    # the encoder named by the experiment: a PannResNet22TPU tree would load into
    # PannResNet22 and serve another network, so build_model refuses it
    model = build_model(
        encoder=cfg.model.encoder.to_dict(), decoder=cfg.model.decoder.to_dict(),
        n_classes=d.n_classes, output_format=d.get("output_format", "reg_xyz"),
    )

    path = (ckpt.best_checkpoint(cfg.dir.model.best) if checkpoint_kind == "best"
            else None) or ckpt.latest_checkpoint(cfg.dir.model.checkpoint)
    if path is None:
        raise FileNotFoundError("no checkpoint found; train first")
    wavs = sorted(f for f in os.listdir(wav_dir) if f.endswith(".wav"))
    if not wavs:
        raise FileNotFoundError(f"no wavs in {wav_dir}")
    params, batch_stats, _step = ckpt.restore_variables(path)
    logger.info("restored %s", path)

    scaler = _load_scaler(cfg, d.audio_format)
    interp_ratio = model.time_downsample_ratio * d.label_rate / (d.fs / d.hop_len)
    pipe = SeldInferencePipeline(
        extractor, model, {"params": params, "batch_stats": batch_stats},
        scaler, interp_ratio, d.n_classes, d.get("output_format", "reg_xyz"),
        device=device,
    )

    os.makedirs(out_dir, exist_ok=True)
    t0 = time.time()
    audio_seconds = 0.0
    done = 0

    def _flush(group):
        nonlocal done
        stacked = np.stack([a for _, a in group])
        ev, doa = pipe(stacked)
        for (w, _), e_row, d_row in zip(group, ev, doa):
            write_classwise_csv(
                os.path.join(out_dir, w[:-4] + ".csv"), e_row, d_row, d.n_classes,
                sed_threshold=cfg.get("sed_threshold", 0.3),
                max_frames=e_row.shape[0],
                version=str(cfg.get("eval_version", "2021")),
            )
        done += len(group)
        logger.info("%d/%d predicted", done, len(wavs))

    # batch clips by EXACT sample count: within a group, stacking is loss-free and
    # each clip's prediction equals its solo run (padding instead would feed pad
    # frames into the biGRU's backward pass; truncating drops tail predictions)
    buckets: dict[int, list[tuple[str, np.ndarray]]] = {}
    for w in wavs:
        a, _ = read_wav(os.path.join(wav_dir, w), target_fs=d.fs)
        audio_seconds += a.shape[1] / d.fs
        buckets.setdefault(a.shape[1], []).append((w, a))
        if len(buckets[a.shape[1]]) == batch_size:
            _flush(buckets.pop(a.shape[1]))
    for length in sorted(buckets):
        _flush(buckets.pop(length))
    dt = time.time() - t0
    logger.info("served %.0f audio-s in %.1f s (%.0fx realtime)", audio_seconds, dt,
                audio_seconds / max(dt, 1e-9))
    return out_dir


@cli_entry
def main(argv: list[str] | None = None):
    p = argparse.ArgumentParser()
    p.add_argument("--exp-config", required=True)
    p.add_argument("--wav-dir", required=True)
    p.add_argument("--out-dir", required=True)
    p.add_argument("--exp-group-dir", default="./outputs")
    p.add_argument("--exp-suffix", default="")
    p.add_argument("--checkpoint", default="best", choices=["best", "last"])
    p.add_argument("--batch-size", type=int, default=4)
    # salsa_tpu's streaming switches raise NotImplementedError (ROADMAP queue 1, item 9)
    p.add_argument("--streaming", action="store_true",
                   help="simulated-live serving (not ported yet)")
    p.add_argument("--pcm16", action="store_true",
                   help="streaming: push raw int16 PCM (not ported yet)")
    p.add_argument("--pool", action="store_true",
                   help="streaming: the dynamic stream pool (not ported yet)")
    p.add_argument("--max-lag-ms", type=float, default=None,
                   help="pool: bound head-of-line blocking (not ported yet)")
    p.add_argument("--use-tuned-threshold", action="store_true",
                   help="serve at the val-calibrated sed_threshold persisted "
                        "by `salsa-infer --tune-threshold` "
                        "(tuned_threshold.json beside the checkpoints) "
                        "instead of the config value")
    a = p.parse_args(argv)
    if a.streaming or a.pool or a.pcm16 or a.max_lag_ms is not None:
        raise NotImplementedError(
            "streaming serving (--streaming, --pool, --pcm16, --max-lag-ms) is not "
            "ported yet: ROADMAP queue 1, item 9")
    return predict(a.exp_config, a.wav_dir, a.out_dir, a.exp_group_dir, a.exp_suffix,
                   a.checkpoint, a.batch_size, use_tuned_threshold=a.use_tuned_threshold)


if __name__ == "__main__":
    main()
