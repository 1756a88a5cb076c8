"""Training-step throughput of the full-width SALSA-FOA CRNN at the reference's
training shape, batch 32 x (7, 640, 200): the port's counterpart of
`scripts/bench_train.py`.

    python -m salsa_tpu_torch.scripts.bench_train [--batch 32] [--iters 10] [--bf16]
        [--from-wav [--eig-method auto]] [--encoder PannResNet22] [--cpu]

A step is the trainer's: the model in training mode, `seld_loss` (reg_xyz,
weights 0.3 / 0.7, index-repeat to the label rate), backward, and the scheduled
Adam (`train.state.make_optimizer`, 1000 steps). The feature-fed step (default)
takes zero features and targets, as the original does. With `--from-wav` each
step first extracts its batch of 8 s chunks on the card from four resident 60 s
clips of seeded noise (`features.chunked`: the DFT matmul, K2 resumed from the
chunk's tracker checkpoint, then K1 at `--eig-method` 'auto'), normalises it and
steps on it. `--bf16` runs the encoder and decoder in bfloat16
(`compute_dtype`). The step time is CUDA events around `--iters` steps back to
back after a warm-up step; steps/s and audio-s/s (8 s a chunk) follow from it.
Runs on the first CUDA card; `--cpu` runs the same code on the CPU (a check of
the script, not a measurement). Prints one JSON object with the original's keys,
the step time, its method and the card.
"""
from __future__ import annotations

import argparse
import json

import numpy as np
import torch

from salsa_tpu_torch.features import chunked
from salsa_tpu_torch.models.seld import build_model, init_train_, interpolate_index_repeat
from salsa_tpu_torch.scripts.timing import card_name, device_ms, script_device
from salsa_tpu_torch.train.losses import seld_loss
from salsa_tpu_torch.train.state import make_optimizer

N_CLASSES, CHUNK_FRAMES, LABEL_FRAMES, CHUNK_SECONDS = 12, 640, 80, 8.0
FS, N_FFT, HOP = 24000, 512, 300
INTERP = 2.0  # encoder downsample 16 x label rate 10 / frame rate 80


def full_width_model(encoder: str, bf16: bool, dev: torch.device, seed: int = 0):
    """The flagship CRNN (the encoder named, 2-layer BiGRU-256, 12 classes) with
    `salsa_tpu`'s training initialisers, on `dev`."""
    dtype = {"compute_dtype": "bfloat16"} if bf16 else {}
    model = build_model(encoder={"name": encoder, "n_input_channels": 7, **dtype},
                        decoder={"name": "SeldDecoder", "decoder_type": "bigru",
                                 "decoder_size": 256, **dtype}, n_classes=N_CLASSES)
    return init_train_(model, torch.Generator().manual_seed(seed)).to(dev)


def make_step(model, optimizer):
    """One optimizer step on (x, sed, doa); returns the loss tensor."""
    def step(x, sed, doa):
        model.train()
        out = model(x)
        pred = {k: interpolate_index_repeat(out[k], INTERP)
                for k in ("event_frame_logit", "doa_frame_output")}
        total, _, _ = seld_loss(pred, {"event_frame_gt": sed, "doa_frame_gt": doa},
                                N_CLASSES, (0.3, 0.7))
        optimizer.zero_grad()
        total.backward()
        optimizer.step()
        return total
    return step


def wav_batches(dev: torch.device, batch: int, eig_method: str, n_clips: int = 4,
                seconds: float = 60.0):
    """The from-wav feed: returns (next_batch, params); next_batch() draws `batch`
    chunk starts and extracts them from the resident clips."""
    rng = np.random.default_rng(0)
    waves = (rng.standard_normal((n_clips, 4, int(FS * seconds))) * 0.1).astype(np.float32)
    padded = torch.from_numpy(np.stack([chunked.pad_waveform(w, N_FFT) for w in waves]))
    n_full = chunked.n_full_frames(waves.shape[-1], HOP)
    fn, p = chunked.make_chunk_extractor("salsa", "foa", CHUNK_FRAMES, FS, N_FFT, HOP,
                                         eig_method=eig_method)
    starts = np.arange(0, n_full - CHUNK_FRAMES - 8, 40)
    waves_dev = padded.to(dev)
    floors, cds = zip(*chunked.salsa_tracker_checkpoints_batch(waves_dev, [starts] * n_clips,
                                                               p))
    tables = {"clip": torch.from_numpy(np.repeat(np.arange(n_clips), len(starts))).to(dev),
              "start": torch.from_numpy(np.tile(starts, n_clips)).to(dev),
              "floor": torch.cat(floors).to(dev), "cd": torch.cat(cds).to(dev)}
    n_full_t = torch.full((batch,), n_full, device=dev)
    mean = torch.zeros((4, 1, p.freq_dim), device=dev)
    std = torch.ones((4, 1, p.freq_dim), device=dev)
    idx_rng = torch.Generator().manual_seed(1)
    n_chunks = len(tables["clip"])

    def next_batch():
        idx = torch.randint(0, n_chunks, (batch,), generator=idx_rng).to(dev)
        x = fn(waves_dev, tables["clip"][idx], tables["start"][idx], n_full_t,
               tables["floor"][idx], tables["cd"][idx])
        return torch.cat([(x[:, :4] - mean) / std, x[:, 4:]], dim=1)

    return next_batch, p


def main(argv: list[str] | None = None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--batch", type=int, default=32)
    ap.add_argument("--iters", type=int, default=10)
    ap.add_argument("--bf16", action="store_true")
    ap.add_argument("--from-wav", action="store_true",
                    help="extract each step's chunks on the card from resident waves (K2, K1)")
    ap.add_argument("--eig-method", default="auto")
    ap.add_argument("--encoder", default="PannResNet22")
    ap.add_argument("--cpu", action="store_true", help="run on the CPU (a check, not a timing)")
    args = ap.parse_args(argv)
    dev = script_device("bench_train", args.cpu)
    B = args.batch
    model = full_width_model(args.encoder, args.bf16, dev)
    step = make_step(model, make_optimizer(model.parameters(), total_steps=1000))
    sed = torch.zeros((B, LABEL_FRAMES, N_CLASSES), device=dev)
    doa = torch.zeros((B, LABEL_FRAMES, 3 * N_CLASSES), device=dev)
    if args.from_wav:
        next_batch, p = wav_batches(dev, B, args.eig_method)
    else:
        x = torch.zeros((B, 7, CHUNK_FRAMES, 200), device=dev)
        next_batch = lambda: x  # noqa: E731
    last = {}

    def one_step():
        last["loss"] = step(next_batch(), sed, doa).detach()

    ms, method = device_ms(one_step, dev, calls=args.iters)
    loss = float(last["loss"])
    if not np.isfinite(loss):
        raise AssertionError(f"bench_train: non-finite loss {loss}")
    steps_per_s = 1e3 / ms
    out = {"metric": "train_step_throughput_from_wav" if args.from_wav
           else "train_step_throughput",
           "steps_per_s": round(steps_per_s, 3),
           "audio_s_per_s": round(steps_per_s * B * CHUNK_SECONDS, 1),
           "batch": B, "bf16": args.bf16, "loss": loss, "encoder": args.encoder,
           "step_ms": ms, "method": method, "device": str(dev), "card": card_name(dev)}
    if args.from_wav:
        out["eig_method"] = p.eig_method
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main()
