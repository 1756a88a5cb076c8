"""Streaming SELD on the card: per-block latency and realtime factor at the flagship
geometry, the port's counterpart of `scripts/bench_streaming.py`.

    python -m salsa_tpu_torch.scripts.bench_streaming [--streams N] [--int16] [--pool]
        [--realtime] [--seconds 60] [--block 160] [--context 256] [--push-ms 100] [--cpu]

A live feed of a seeded 60 s FOA clip (noise plus a tone, one tone a stream) is
pushed in `--push-ms` packets through `streaming.StreamingExtractor` and
`StreamingSeldPipeline` (SALSA features through K2 and K1 once a block dispatch,
then the CRNN on its window), as phase 10 of `chip_smoke.py` drives them; the
model is the original's, `--encoder` (PannResNet22TPU) with the default decoder,
random weights from a seed. `--streams N` pushes N synchronized streams a
dispatch; `--int16` pushes int16 PCM; `--pool` attaches N streams to a
`stream_pool.SeldStreamPool` one block apart and detaches each at its end;
`--realtime` paces the packets at real time. After a warm-up feed and `reset()`,
the latency of a block is the host clock of each push that returned a prediction
(the pipeline fetches its outputs, so the card has finished it) and, in the pool,
of each round of pushes. Also the aggregate and per-stream x realtime on the host
clock and the algorithmic lookahead. Runs on the first CUDA card; `--cpu` runs it
on the CPU (a check of the script, not a measurement). Prints one JSON object
with the quantities the original prints.
"""
from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch

from salsa_tpu_torch.models.seld import build_model, init_random_
from salsa_tpu_torch.scripts.timing import card_name, script_device
from salsa_tpu_torch.stream_pool import SeldStreamPool
from salsa_tpu_torch.streaming import StreamingExtractor, StreamingSeldPipeline

FS, N_FFT, HOP = 24000, 512, 300


def feed(n_streams: int, seconds: float, int16: bool) -> np.ndarray:
    """(N, 4, n) or (4, n) at N = 1: seeded noise plus a tone a stream."""
    n = int(seconds * FS)
    rng = np.random.default_rng(0)
    t = np.arange(n) / FS
    wave = (0.05 * rng.standard_normal((n_streams, 4, n))).astype(np.float32)
    wave += (0.3 * np.sin(2 * np.pi * (440.0 + 30 * np.arange(n_streams))[:, None]
                          * t[None, :])).astype(np.float32)[:, None, :]
    if n_streams == 1:
        wave = wave[0]
    if int16:
        wave = np.clip(np.round(wave * 32768.0), -32768, 32767).astype(np.int16)
    return wave


def percentiles(lat_s) -> dict:
    ms = np.asarray(lat_s) * 1e3
    return {"p50_ms": float(np.percentile(ms, 50)), "p95_ms": float(np.percentile(ms, 95)),
            "max_ms": float(ms.max())}


def drive_pool(pipe, wave, n_streams: int, push: int, stagger: int, limit: int) -> list:
    """Attach the streams `stagger` pushes apart, push each until `limit`, detach;
    returns each round's host seconds."""
    pipe.reset()
    pool = SeldStreamPool(pipe)
    handles, pos = [None] * n_streams, [0] * n_streams
    done, lat, r = [False] * n_streams, [], 0
    while not all(done):
        t0 = time.perf_counter()
        for s in range(n_streams):
            if handles[s] is None and r >= s * stagger:
                handles[s] = pool.attach()
            if handles[s] is None or done[s]:
                continue
            seg = wave[s][..., pos[s]:pos[s] + push]
            if seg.shape[-1]:
                pool.push(handles[s], seg)
                pos[s] += push
            if pos[s] >= limit:
                pool.detach(handles[s])
                done[s] = True
        lat.append(time.perf_counter() - t0)
        r += 1
    return lat


def main(argv: list[str] | None = None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--block", type=int, default=160, help="feature frames (2 s)")
    ap.add_argument("--context", type=int, default=256, help="left/right context frames")
    ap.add_argument("--push-ms", type=float, default=100.0)
    ap.add_argument("--seconds", type=float, default=60.0)
    ap.add_argument("--encoder", default="PannResNet22TPU")
    ap.add_argument("--streams", type=int, default=1)
    ap.add_argument("--int16", action="store_true")
    ap.add_argument("--pool", action="store_true")
    ap.add_argument("--realtime", action="store_true")
    ap.add_argument("--cpu", action="store_true", help="run on the CPU (a check, not a timing)")
    args = ap.parse_args(argv)
    dev = script_device("bench_streaming", args.cpu)
    N = args.streams
    se = StreamingExtractor("salsa", "foa", fs=FS, n_fft=N_FFT, hop_length=HOP,
                            block_frames=args.block, n_streams=N, device=dev)
    model = init_random_(build_model(encoder={"name": args.encoder, "n_input_channels": 7},
                                     decoder={"name": "SeldDecoder"}, n_classes=12),
                         torch.Generator().manual_seed(0))
    F = se.params.freq_dim
    scaler = (np.zeros((4, 1, F), np.float32), np.ones((4, 1, F), np.float32))
    pipe = StreamingSeldPipeline(se, model, None, scaler, interp_ratio=2.0, n_classes=12,
                                 left_context=args.context, right_context=args.context)
    n = int(args.seconds * FS)
    wave = feed(N, args.seconds, args.int16)
    push = int(args.push_ms * FS / 1000)
    out = {"streams": N, "seconds": args.seconds, "block": args.block,
           "context": args.context, "push_ms": args.push_ms, "int16": args.int16,
           "pool": args.pool, "encoder": args.encoder}

    if args.pool:
        pwave = wave if wave.ndim == 3 else wave[None]
        stagger = max(1, int(round(args.block * HOP / push)))
        warm = min(n, (N * stagger + 6) * push + (args.block + 2 * args.context) * HOP)
        drive_pool(pipe, pwave, N, push, stagger, warm)
        t_start = time.perf_counter()
        lat = drive_pool(pipe, pwave, N, push, stagger, n)
        wall = time.perf_counter() - t_start
        out.update(stagger_pushes=stagger, wall_s=wall,
                   x_realtime_aggregate=N * args.seconds / wall, **percentiles(lat),
                   method="host clock of each round of pushes (every live stream, one "
                          "fused dispatch a block)", device=str(dev), card=card_name(dev))
        print(json.dumps({"bench_streaming": out}), flush=True)
        return out

    i = 0  # warm-up feed, then a fresh stream
    while i < 4 * push + (args.block + 2 * args.context) * HOP:
        pipe.push(wave[..., i:i + push])
        i += push
    pipe.reset()
    lat, i, n_out, busy = [], 0, 0, 0.0
    t_start = time.perf_counter()
    while i < n:
        if args.realtime:  # the packet's last sample has arrived
            due = t_start + (i + push) / FS
            now = time.perf_counter()
            if now < due:
                time.sleep(due - now)
        t0 = time.perf_counter()
        outs = pipe.push(wave[..., i:i + push])
        dt = time.perf_counter() - t0
        busy += dt
        if outs:
            lat.append(dt)
            n_out += sum(o[0].shape[-2] for o in outs)
        i += push
    t0 = time.perf_counter()
    outs = pipe.flush()
    lat.append(time.perf_counter() - t0)
    busy += lat[-1]
    n_out += sum(o[0].shape[-2] for o in outs)
    wall = time.perf_counter() - t_start
    out.update(label_frames=n_out, wall_s=wall, x_realtime_per_stream=args.seconds / wall,
               x_realtime_aggregate=N * args.seconds / wall, **percentiles(lat),
               lookahead_ms=(args.block + args.context + se.latency_frames) * HOP / FS * 1e3,
               method="host clock of each push that returned a prediction (its outputs "
                      "fetched from the card) and of the flush")
    if args.realtime:
        out.update(push_occupancy=busy / wall, headroom_streams=N * wall / max(busy, 1e-9))
    out.update(device=str(dev), card=card_name(dev))
    print(json.dumps({"bench_streaming": out}), flush=True)
    return out


if __name__ == "__main__":
    main()
