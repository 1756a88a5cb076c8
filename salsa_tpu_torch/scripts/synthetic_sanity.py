"""Full-system sanity run on synthetic scenes, on the CUDA card (the port's copy of
`scripts/synthetic_sanity.py`).

Generates physically consistent first-order-ambisonic clips (SN3D: W=s, Y=s·y,
Z=s·z, X=s·x for a source at unit DOA (x,y,z)), or tetrahedral-array MIC clips
with per-capsule fractional delays, with class-dependent carriers and DCASE-format
ground truth; trains the CRNN from the raw wavs (`salsa_tpu_torch.cli.train`,
features extracted inside every step); and reports SELD 2021 scores on a held-out
split. A healthy build drives LE to a few degrees and F1 near 1.

The corpus is the same code as `scripts/synthetic_sanity.py`'s, so one seed gives
the same wavs and ground truth. The port always trains from wav (it has no
extract CLI; `--from-wav` is accepted for the original's command line), with the
original's model: `compute_dtype: bfloat16` on the encoder and the decoder, the
encoder from `--encoder` (PannResNet22 by default, as the original's). It prints
the same `{"synthetic_sanity": {...}}` line.

Usage: python -m salsa_tpu_torch.scripts.synthetic_sanity [--clips 24] [--epochs 20]
           [--workdir DIR] [--aug full|feature|off]
"""
from __future__ import annotations

import argparse
import json
import os
import tempfile
import time

import numpy as np

from salsa_tpu_torch.utils.audio_io import write_wav
from salsa_tpu_torch.utils.config import save_config

FS = 24000
N_CLASSES = 4
CLASS_CARRIERS = [330.0, 680.0, 1250.0, 2400.0]
CLIP_SECONDS = 16.0
LABEL_RATE = 10

# tetrahedral mic array (Eigenmike-like radius 4.2 cm), matching the channel-swap
# symmetry conventions used by the MIC augmentations
MIC_RADIUS = 0.042
SPEED_OF_SOUND = 343.0
MIC_DIRS = np.array([
    [+1, +1, +1],
    [+1, -1, -1],
    [-1, +1, -1],
    [-1, -1, +1],
]) / np.sqrt(3.0)


def fractional_delay(sig: np.ndarray, delay_samples: float) -> np.ndarray:
    """Apply a (possibly fractional) delay via an FFT phase ramp."""
    n = len(sig)
    spec = np.fft.rfft(sig)
    freqs = np.fft.rfftfreq(n)
    spec *= np.exp(-2j * np.pi * freqs * delay_samples)
    return np.fft.irfft(spec, n=n).astype(np.float32)


def synth_clip(rng, n_events=3, audio_format="foa"):
    """One CLIP_SECONDS clip (4, n) float32 and its DCASE metadata rows."""
    n = int(CLIP_SECONDS * FS)
    t = np.arange(n) / FS
    audio = 0.002 * rng.standard_normal((4, n)).astype(np.float32)
    rows = []
    n_label_frames = int(CLIP_SECONDS * LABEL_RATE)
    for _ in range(n_events):
        cls = int(rng.integers(0, N_CLASSES))
        azi = float(rng.integers(-180, 180))
        ele = float(rng.integers(-40, 41))
        a, e = np.deg2rad(azi), np.deg2rad(ele)
        x, y, z = np.cos(a) * np.cos(e), np.sin(a) * np.cos(e), np.sin(e)
        start = float(rng.uniform(0, CLIP_SECONDS - 4.0))
        dur = float(rng.uniform(2.0, 4.0))
        sl = slice(int(start * FS), int((start + dur) * FS))
        f0 = CLASS_CARRIERS[cls]
        sig = np.zeros(n, dtype=np.float32)
        tt = t[sl]
        # harmonic tone + band noise so energy spreads over several STFT bins
        carrier = (np.sin(2 * np.pi * f0 * tt)
                   + 0.5 * np.sin(2 * np.pi * 2 * f0 * tt)
                   + 0.25 * np.sin(2 * np.pi * 3 * f0 * tt))
        env = np.minimum(1.0, np.minimum((tt - tt[0]) * 8, (tt[-1] - tt) * 8))
        sig[sl] = 0.25 * carrier * env
        if audio_format == "foa":
            audio[0] += sig                     # W
            audio[1] += (y * sig).astype(np.float32)  # Y
            audio[2] += (z * sig).astype(np.float32)  # Z
            audio[3] += (x * sig).astype(np.float32)  # X
        else:  # mic: per-capsule fractional delays from a plane wave at (x, y, z)
            doa_vec = np.array([x, y, z])
            for mic in range(4):
                delay_s = -MIC_RADIUS / SPEED_OF_SOUND * float(MIC_DIRS[mic] @ doa_vec)
                audio[mic] += fractional_delay(sig, delay_s * FS)
        f_lo = int(np.floor(start * LABEL_RATE))
        f_hi = min(int(np.ceil((start + dur) * LABEL_RATE)), n_label_frames)
        for f in range(f_lo, f_hi):
            rows.append(f"{f},{cls},0,{int(azi)},{int(ele)}")
    return audio, "\n".join(rows)


def write_corpus(root: str, n_clips: int, seed: int, fmt: str) -> tuple[str, str]:
    """`n_clips` clips from `seed` as 16-bit wavs under <root>/task3/<fmt>_dev with
    their metadata CSVs, and the train/val split CSVs (the last max(2, n // 6)
    clips validate) under <root>/meta; existing wavs are kept. Returns (the
    ground-truth root, the split directory)."""
    rng = np.random.default_rng(seed)
    data_dir = os.path.join(root, "task3")
    os.makedirs(os.path.join(data_dir, f"{fmt}_dev"), exist_ok=True)
    os.makedirs(os.path.join(data_dir, "metadata_dev"), exist_ok=True)
    meta_dir = os.path.join(root, "meta")
    os.makedirs(meta_dir, exist_ok=True)
    names = [f"synth{i:03d}" for i in range(n_clips)]
    for name in names:
        wav_path = os.path.join(data_dir, f"{fmt}_dev", name + ".wav")
        if not os.path.isfile(wav_path):
            audio, gt = synth_clip(rng, audio_format=fmt)
            write_wav(wav_path, audio, FS, bits=16)
            with open(os.path.join(data_dir, "metadata_dev", name + ".csv"), "w") as f:
                f.write(gt)
    n_val = max(2, n_clips // 6)
    with open(os.path.join(meta_dir, "train.csv"), "w") as f:
        f.write("filename\n" + "\n".join(names[:-n_val]))
    with open(os.path.join(meta_dir, "val.csv"), "w") as f:
        f.write("filename\n" + "\n".join(names[-n_val:]))
    return data_dir, meta_dir


def experiment_config(data_dir: str, meta_dir: str, feature_type: str, fmt: str, seed: int,
                      epochs: int, aug: str = "full", output_format: str = "reg_xyz",
                      accdoa_silent_weight: float = 0.0,
                      encoder: str = "PannResNet22") -> dict:
    """The original script's experiment (bf16 compute), trained from wav."""
    fmax_doa = {("foa", "salsa"): 9000, ("mic", "salsa"): 4000}.get((fmt, feature_type), 2000)
    n_in = {"melspec": 4}.get(feature_type, 10 if feature_type.endswith("gcc") else 7)
    return {
        "name": "sanity", "feature_root_dir": None, "feature_type": feature_type,
        "gt_meta_root_dir": data_dir, "split_meta_dir": meta_dir, "seed": seed,
        "mode": "crossval",
        "data": {"fs": FS, "n_fft": 512, "hop_len": 300, "audio_format": fmt,
                 "fmin_doa": 50, "fmax_doa": fmax_doa,
                 "label_rate": LABEL_RATE, "train_chunk_len_s": 8,
                 "train_chunk_hop_len_s": 1.0, "test_chunk_len_s": CLIP_SECONDS,
                 "test_chunk_hop_len_s": CLIP_SECONDS + 0.1, "n_classes": N_CLASSES,
                 "output_format": output_format, "max_file_len_s": CLIP_SECONDS},
        "model": {
            "encoder": {"name": encoder, "n_input_channels": n_in,
                        "compute_dtype": "bfloat16"},
            "decoder": {"name": "SeldDecoder", "decoder_type": "bigru",
                        "decoder_size": 128, "freq_pool": "avg",
                        "compute_dtype": "bfloat16"},
        },
        "training": {"train_batch_size": 16, "optimizer": "adam",
                     "accdoa_silent_weight": accdoa_silent_weight,
                     "from_wav": True,
                     "device_augment": {"full": True, "feature": "feature",
                                        "off": False}[aug],
                     "lr_scheduler": {"milestones": [0.0, 0.1, 0.7, 1.0],
                                      "lrs": [3e-4, 3e-4, 3e-4, 1e-4],
                                      "moms": [0.9, 0.9, 0.9, 0.9]},
                     "loss_weight": [0.3, 0.7], "max_epochs": epochs,
                     "val_interval": max(1, epochs // 4)},
        "sed_threshold": 0.3, "doa_threshold": 20, "eval_version": "2021",
    }


def parse_args(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--clips", type=int, default=24)
    ap.add_argument("--epochs", type=int, default=20)
    ap.add_argument("--workdir", default=os.path.join(tempfile.gettempdir(),
                                                      "salsa_tpu_torch_sanity"))
    ap.add_argument("--seed", type=int, default=11)
    ap.add_argument("--format", dest="audio_format", default="foa", choices=["foa", "mic"])
    ap.add_argument("--feature-type", default=None,
                    help="default: salsa for foa, salsa_lite for mic")
    ap.add_argument("--output-format", default="reg_xyz", choices=["reg_xyz", "accdoa"])
    ap.add_argument("--accdoa-silent-weight", type=float, default=0.0)
    ap.add_argument("--from-wav", action="store_true",
                    help="accepted for the original's command line: the port always "
                         "trains from the raw wavs")
    ap.add_argument("--encoder", default="PannResNet22")
    ap.add_argument("--aug", default="full", choices=["full", "feature", "off"],
                    help="augmentation arm: full reference stack (channel swaps + "
                         "feature transforms), feature-only (no swaps), or off")
    return ap.parse_args(argv)


def run(args, device="cuda") -> dict:
    """Write the corpus and the experiment, train on `device`, and return the
    held-out split's scores."""
    from salsa_tpu_torch.cli.train import train

    fmt = args.audio_format
    feature_type = args.feature_type or ("salsa" if fmt == "foa" else "salsa_lite")
    root = args.workdir
    t0 = time.time()
    data_dir, meta_dir = write_corpus(root, args.clips, args.seed, fmt)
    print(f"generated {args.clips} clips in {time.time() - t0:.1f}s", flush=True)
    exp_path = os.path.join(root, "exp.yml")
    save_config(experiment_config(data_dir, meta_dir, feature_type, fmt, args.seed,
                                  args.epochs, args.aug, args.output_format,
                                  args.accdoa_silent_weight, args.encoder), exp_path)
    t0 = time.time()
    trainer = train(exp_path, exp_group_dir=os.path.join(root, "outputs"),
                    exp_suffix="_sanity", device=device)
    print(f"training: {time.time() - t0:.1f}s", flush=True)
    if device != "cpu":  # every time is the card's: its name and power limit beside it
        from salsa_tpu_torch.scripts.timing import smi

        print(f"card: {smi('name,power.limit')}", flush=True)
    return trainer.validate()


def main(argv=None) -> dict:
    scores = run(parse_args(argv))
    print(json.dumps({"synthetic_sanity": scores}), flush=True)
    return scores


if __name__ == "__main__":
    main()
