"""The training step of the flagship CRNN broken down by ablation on the card: the
port's counterpart of `scripts/profile_step.py`.

    python -m salsa_tpu_torch.scripts.profile_step [--batch 32] [--iters 10]
        [--encoder PannResNet22] [--frames 640] [--matmul-size 8192] [--cpu]

As the original, in bf16 compute (`compute_dtype: bfloat16`, encoder and
decoder) on seeded (batch, 7, frames, 200) features with random targets:

  full_step_ms  the trainer's step (`bench_train.make_step`: forward, loss,
                backward, Adam);
  fwd_train_ms  the forward in training mode (BatchNorm statistics updated,
                dropout drawn), no gradients;
  fwd_eval_ms   the forward in eval mode;
  fwd_bwd_ms    the training forward of the outputs' sum and its backward, every
                parameter's gradient materialised;

each CUDA events around `--iters` calls back to back after a warm-up call. The
utilisation's denominator is a practical peak measured on the card: a bf16
`torch.matmul` of two `--matmul-size` square matrices (2 n^3 operations), timed
the same way; no TPU figure is used. `effective_tflops_fwd_bwd` counts the
original's convolution operations, ~1.4 TFLOP forward at batch 32 x 640 frames for
PannResNet22 and 1.149 for PannResNet22TPU, three times for forward and backward.
Runs on the first CUDA card; `--cpu` runs it on the CPU (a check of the script,
not a measurement). Prints one JSON object with the original's keys, the method
and the card.
"""
from __future__ import annotations

import argparse
import json

import numpy as np
import torch

from salsa_tpu_torch.scripts.bench_train import N_CLASSES, full_width_model, make_step
from salsa_tpu_torch.scripts.timing import card_name, device_ms, script_device
from salsa_tpu_torch.train.state import make_optimizer

FWD_GFLOP_AT_32 = {"PannResNet22": 1400.0, "PannResNet22TPU": 1149.0}


def output_sum(out: dict) -> torch.Tensor:
    return (out["event_frame_logit"].float().sum() + out["doa_frame_output"].float().sum())


def main(argv: list[str] | None = None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--batch", type=int, default=32)
    ap.add_argument("--iters", type=int, default=10)
    ap.add_argument("--encoder", default="PannResNet22", choices=sorted(FWD_GFLOP_AT_32))
    ap.add_argument("--frames", type=int, default=640, help="feature frames a chunk")
    ap.add_argument("--matmul-size", type=int, default=8192)
    ap.add_argument("--cpu", action="store_true", help="run on the CPU (a check, not a timing)")
    args = ap.parse_args(argv)
    dev = script_device("profile_step", args.cpu)
    B, T = args.batch, args.frames
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.standard_normal((B, 7, T, 200), dtype=np.float32)).to(dev)
    n_labels = T // 8
    sed = torch.from_numpy((rng.random((B, n_labels, N_CLASSES)) < 0.2).astype(np.float32)).to(dev)
    doa = torch.from_numpy((rng.standard_normal((B, n_labels, 3 * N_CLASSES)) * 0.5
                            ).astype(np.float32)).to(dev)
    model = full_width_model(args.encoder, True, dev)
    out = {"batch": B, "device": card_name(dev), "encoder": args.encoder, "frames": T}

    def timed(fn) -> float:
        ms, out["method"] = device_ms(fn, dev, calls=args.iters)
        return ms

    step = make_step(model, make_optimizer(model.parameters(), total_steps=1000))
    out["full_step_ms"] = timed(lambda: step(x, sed, doa))

    def forward(train: bool):
        model.train(train)
        with torch.no_grad():
            return output_sum(model(x))

    def fwd_bwd():
        model.train()
        model.zero_grad(set_to_none=True)
        output_sum(model(x)).backward()

    out["fwd_train_ms"] = timed(lambda: forward(True))
    out["fwd_eval_ms"] = timed(lambda: forward(False))
    out["fwd_bwd_ms"] = timed(fwd_bwd)
    n = args.matmul_size
    gen = torch.Generator(device="cpu").manual_seed(1)
    a = torch.randn((n, n), generator=gen).to(dev, torch.bfloat16)
    b = torch.randn((n, n), generator=gen).to(dev, torch.bfloat16)
    out["matmul_ms"] = timed(lambda: a @ b)
    out["peak_matmul_tflops"] = 2 * n ** 3 / 1e9 / out["matmul_ms"]
    fwd_gflop = FWD_GFLOP_AT_32[args.encoder] * B / 32 * T / 640
    out["effective_tflops_fwd_bwd"] = 3 * fwd_gflop / out["fwd_bwd_ms"]
    out["utilisation_fwd_bwd"] = out["effective_tflops_fwd_bwd"] / out["peak_matmul_tflops"]
    out["card"] = out["device"]
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main()
