"""The augmentation ablation on the synthetic corpus, on the CUDA card (the port's
copy of `scripts/aug_ablation.py`).

The reference's central ablation has its augmentation stack worth SELD 0.352 ->
0.255 on TNSSE2021 FOA. This measures the port's on the synthetic corpus:

  arm "off"      — no augmentation at all;
  arm "feature"  — frequency shift + cutout family only (no channel swaps);
  arm "full"     — the reference stack (label-coupled channel swaps + the
                   feature-only transforms).

Each arm is one `salsa_tpu_torch.scripts.synthetic_sanity` run at an identical
config and seed (only training.device_augment differs), in this process, one
after another; rows print as the original's JSON.

  python -m salsa_tpu_torch.scripts.aug_ablation [--clips 48 --epochs 96 --seeds 33 34 35]
"""
from __future__ import annotations

import argparse
import json
import os
import tempfile

import numpy as np

from salsa_tpu_torch.scripts import synthetic_sanity


def run_arm(arm: str, clips: int, epochs: int, seed: int, encoder: str,
            workroot: str, device="cuda") -> dict:
    """One synthetic_sanity run of the arm; its held-out scores."""
    workdir = os.path.join(workroot, f"salsa_tpu_torch_augablate_s{seed}_{arm}")
    args = synthetic_sanity.parse_args(
        ["--clips", str(clips), "--epochs", str(epochs), "--seed", str(seed), "--aug", arm,
         "--encoder", encoder, "--workdir", workdir])
    print(f"+ arm {arm}, seed {seed}: synthetic_sanity in {workdir}", flush=True)
    scores = synthetic_sanity.run(args, device=device)
    print(json.dumps({"synthetic_sanity": scores}), flush=True)
    if device != "cpu":
        import torch

        torch.cuda.empty_cache()
    return scores


def main(argv=None, device="cuda") -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--clips", type=int, default=48)
    ap.add_argument("--epochs", type=int, default=96)
    ap.add_argument("--seeds", type=int, nargs="+", default=[33],
                    help="data+init seeds; several give mean±sd per arm")
    ap.add_argument("--encoder", default="PannResNet22TPU")
    ap.add_argument("--arms", nargs="+", default=["off", "feature", "full"])
    ap.add_argument("--workroot", default=tempfile.gettempdir())
    args = ap.parse_args(argv)

    table: dict[str, list[dict]] = {a: [] for a in args.arms}
    for seed in args.seeds:
        for arm in args.arms:
            s = run_arm(arm, args.clips, args.epochs, seed, args.encoder, args.workroot,
                        device)
            table[arm].append(s)
            print(json.dumps({"aug_ablation_row": {
                "arm": arm, "seed": seed,
                "seld": round(s["seld_error"], 4), "ER": round(s["ER"], 4),
                "F1": round(s["F1"], 4), "LE": round(s["LE"], 2),
                "LR": round(s["LR"], 4)}}), flush=True)

    summary = {}
    for arm, rows in table.items():
        v = np.array([r["seld_error"] for r in rows])
        le = np.array([r["LE"] for r in rows])
        summary[arm] = {"seld_mean": round(float(v.mean()), 4),
                        "seld_sd": round(float(v.std(ddof=min(1, len(v) - 1))
                                               if len(v) > 1 else 0.0), 4),
                        "le_mean": round(float(le.mean()), 2),
                        "n": len(rows)}
    out = {"clips": args.clips, "epochs": args.epochs, "seeds": args.seeds,
           "encoder": args.encoder, "summary": summary}
    print(json.dumps({"aug_ablation": out}), flush=True)
    return out


if __name__ == "__main__":
    main()
