"""Direct wav -> submission CSV serving CLI (counterpart of the batch path of
`salsa_tpu.cli.predict`): serves a trained `salsa_tpu` experiment (YAML config,
flax msgpack or `.orbax` checkpoint with its JSON sidecar, the feature store's scaler or
`feature_scaler.npz`) over a
directory of multichannel wavs through `SeldInferencePipeline`, on the first CUDA
card:

    python -m salsa_tpu_torch.cli.predict --exp-config configs/seld.yml \
        --exp-group-dir ./outputs --exp-suffix _run1 \
        --wav-dir /data/dcase2021/task3/foa_eval --out-dir ./preds

Streaming serving (`salsa_tpu_torch.streaming`): `--streaming` feeds each wav in
`--push-ms` packets through `StreamingSeldPipeline`, `--streams N` serves N clips
of one length per block dispatch, `--pcm16` pushes int16 PCM decoded on the card,
and `--pool` serves every wav as an unsynchronized live stream of
`SeldStreamPool` (`--max-lag-ms` bounds head-of-line blocking). Where
`salsa_tpu`'s streaming paths fail, this one does not: a wav whose data is
shorter than its header declares is served alone at its decoded length, and a
`--max-lag-ms` below one push packet is raised to one packet.
"""
from __future__ import annotations

import argparse
import os
import time

import numpy as np
import torch

from salsa_tpu_torch.cli._errors import cli_entry
from salsa_tpu_torch.data.feature_store import FeatureStore
from salsa_tpu_torch.features.registry import make_extractor
from salsa_tpu_torch.models.seld import build_model
from salsa_tpu_torch.pipeline import SeldInferencePipeline
from salsa_tpu_torch.stream_pool import SeldStreamPool
from salsa_tpu_torch.streaming import StreamingExtractor, StreamingSeldPipeline
from salsa_tpu_torch.submission import write_classwise_csv, write_trackwise_csv
from salsa_tpu_torch.train import checkpoint as ckpt
from salsa_tpu_torch.train.threshold import load_tuned_threshold
from salsa_tpu_torch.utils.audio_io import read_wav, resampled_length, wav_info
from salsa_tpu_torch.utils.experiments import logger, manage_experiments


def _load_scaler(cfg, audio_format: str):
    """Train-split scaler for serving, as `salsa_tpu` reads it: the feature store's
    (`<feature_root_dir>/<fmt>_feature_scaler`, `.npz` or, through h5py, `.h5`)
    where the experiment has one, else the `feature_scaler.npz` a from-wav run
    saved beside the checkpoints."""
    root = cfg.get("feature_root_dir")
    if root:
        store = FeatureStore(root, audio_format)
        if store.has_scaler():
            return store.read_scaler()
    npz = os.path.join(os.path.dirname(cfg.dir.model.best), "feature_scaler.npz")
    if os.path.isfile(npz):
        blob = np.load(npz)
        return blob["mean"], blob["std"]
    raise FileNotFoundError(
        "no train-split scaler found: neither a feature-store scaler "
        f"({root or 'feature_root_dir unset'}) nor {npz} — train first")


def feature_kwargs(cfg) -> dict:
    """The extractor's keyword arguments from an experiment config, with
    `salsa_tpu`'s defaults; the batch and the streaming paths take the same. The
    eigensolver is the one the model was trained on (`training.eig_method`), as
    `cli.train` passes it to the scaler fit, the val split and every step."""
    d = cfg.data
    return dict(fs=d.fs, n_fft=d.n_fft, hop_length=d.hop_len,
                win_length=d.get("win_len", d.n_fft), n_mels=d.get("n_mels", 128),
                fmin=d.get("fmin", 50), fmax=d.get("fmax", None),
                fmin_doa=d.get("fmin_doa", 50), fmax_doa=d.get("fmax_doa", None),
                eig_method=cfg.get("training", {}).get("eig_method", "auto"))


def predict(exp_config: str, wav_dir: str, out_dir: str,
            exp_group_dir: str = "./outputs", exp_suffix: str = "",
            checkpoint_kind: str = "best", batch_size: int = 4,
            use_tuned_threshold: bool = False,
            device: torch.device | str = "cuda", *, streaming: bool = False,
            block_frames: int = 160, context_frames: int = 256, push_ms: float = 100.0,
            streams: int = 1, pcm16: bool = False, pool: bool = False,
            max_lag_ms: float | None = None) -> str:
    """Serve every wav of `wav_dir` into `<out_dir>/<name>.csv`; returns out_dir.
    Runs on `device`, the first CUDA card unless the caller asks for the CPU. With
    `streaming`, through the streaming pipeline (with `pool`, the stream pool)."""
    if (pool or pcm16 or max_lag_ms is not None) and not streaming:
        raise ValueError("--pool, --pcm16 and --max-lag-ms are options of --streaming")
    if max_lag_ms is not None and not pool:
        raise ValueError("--max-lag-ms is an option of --pool")
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
    extractor = make_extractor(cfg.feature_type, d.audio_format, **feature_kwargs(cfg))
    # the encoder named by the experiment: a PannResNet22TPU tree loads strictly
    # into PannResNet22 and would serve another network
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
    if streaming:
        variables = {"params": params, "batch_stats": batch_stats}
        serve = _predict_streaming_pool if pool else _predict_streaming
        return serve(cfg, d, model, variables, scaler, interp_ratio, wav_dir, out_dir, wavs,
                     block_frames, context_frames, push_ms, streams, pcm16, device,
                     **({"max_lag_ms": max_lag_ms} if pool else {}))
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
            _write_csv(cfg, d, out_dir, w, e_row, d_row)
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


def _streaming_pipeline(cfg, d, model, variables, scaler, interp_ratio, block_frames,
                        context_frames, n_streams, device):
    se = StreamingExtractor(cfg.feature_type, d.audio_format, block_frames=block_frames,
                            n_streams=n_streams, device=device, **feature_kwargs(cfg))
    return StreamingSeldPipeline(
        se, model, variables, scaler, interp_ratio, d.n_classes,
        d.get("output_format", "reg_xyz"), left_context=context_frames,
        right_context=context_frames)


def _to_pcm16(audio: np.ndarray) -> np.ndarray:
    """Float samples as int16 PCM: exact for 16-bit sources at the target rate,
    else quantized to 1/32768."""
    return np.clip(np.round(audio * 32768.0), -32768, 32767).astype(np.int16)


def _write_csv(cfg, d, out_dir, name, ev, doa):
    """`<out_dir>/<name without .wav>.csv`: track-wise rows for the `tracks` output
    format, class-wise otherwise."""
    write = write_trackwise_csv if d.get("output_format") == "tracks" else write_classwise_csv
    write(os.path.join(out_dir, name[:-4] + ".csv"), ev, doa, d.n_classes,
          sed_threshold=cfg.get("sed_threshold", 0.3), max_frames=ev.shape[0],
          version=str(cfg.get("eval_version", "2021")))


def _predict_streaming(cfg, d, model, variables, scaler, interp_ratio, wav_dir, out_dir,
                       wavs, block_frames, context_frames, push_ms, streams=1, pcm16=False,
                       device="cuda"):
    """Simulated-live serving: wavs are fed through the streaming pipeline in
    push_ms packets; predictions accumulate block by block into the batch path's
    CSVs. With --streams N, N clips of one length ride one dispatch per block;
    clips are grouped by their header's length (no decode pass) and a short group
    is padded with silent streams. A clip whose decoded length differs from its
    header's (a truncated file) is served alone at its decoded length. Logs the
    per-block compute latency on top of the algorithmic lookahead."""
    os.makedirs(out_dir, exist_ok=True)
    push = max(1, int(push_ms * d.fs / 1000))
    N = max(1, int(streams))
    pipe = _streaming_pipeline(cfg, d, model, variables, scaler, interp_ratio, block_frames,
                               context_frames, N, device)
    lat, audio_seconds = [], 0.0

    buckets: dict[int, list[str]] = {}
    for w in wavs:
        _, n_raw, fs_raw = wav_info(os.path.join(wav_dir, w))
        buckets.setdefault(resampled_length(n_raw, fs_raw, d.fs), []).append(w)
    groups = [(n, [(w, None) for w in names[i:i + N]]) for n, names in sorted(buckets.items())
              for i in range(0, len(names), N)]

    t_all = time.time()
    while groups:
        n_samples, group = groups.pop(0)
        clips = []
        for w, a in group:
            if a is None:
                a, _ = read_wav(os.path.join(wav_dir, w), target_fs=d.fs)
            if a.shape[1] != n_samples:
                logger.warning("%s: %d samples decoded where its header declares %d; served "
                               "alone at its decoded length", w, a.shape[1], n_samples)
                groups.append((a.shape[1], [(w, a)]))
                continue
            clips.append((w, a))
        if not clips:
            continue
        audio = np.zeros((N,) + clips[0][1].shape, np.float32)  # pad rows stay silent
        for i, (_, a) in enumerate(clips):
            audio[i] = a
        audio_seconds += len(clips) * n_samples / d.fs
        if N == 1:
            audio = audio[0]
        if pcm16:
            audio = _to_pcm16(audio)
        pipe.reset()
        outs, i = [], 0
        while i < n_samples:
            t0 = time.time()
            got = pipe.push(audio[..., i:i + push])
            if got:
                lat.append(time.time() - t0)
                outs += got
            i += push
        t0 = time.time()
        outs += pipe.flush()
        lat.append(time.time() - t0)
        ev = np.concatenate([o[0] for o in outs], axis=-2)
        doa = np.concatenate([o[1] for o in outs], axis=-2)
        for s, (w, _) in enumerate(clips):
            _write_csv(cfg, d, out_dir, w, ev[s] if N > 1 else ev, doa[s] if N > 1 else doa)
    dt = time.time() - t_all
    lat_ms = 1e3 * np.array(lat)
    algo_ms = (block_frames + context_frames + pipe.extractor.latency_frames) \
        * d.hop_len / d.fs * 1e3
    logger.info(
        "streamed %.0f audio-s in %.1f s (%.0fx realtime aggregate, %d "
        "stream(s)/dispatch); per-block compute latency p50 %.0f / p95 %.0f ms "
        "on top of the algorithmic %.0f ms lookahead (block %d + context %d + "
        "halo %d frames)",
        audio_seconds, dt, audio_seconds / max(dt, 1e-9), N,
        np.percentile(lat_ms, 50), np.percentile(lat_ms, 95), algo_ms,
        block_frames, context_frames, pipe.extractor.latency_frames)
    return out_dir


def _predict_streaming_pool(cfg, d, model, variables, scaler, interp_ratio, wav_dir,
                            out_dir, wavs, block_frames, context_frames, push_ms, streams=1,
                            pcm16=False, device="cuda", max_lag_ms=None):
    """Unsynchronized-live serving through the stream pool: every wav is a live
    stream that attaches to a free slot, streams in push_ms packets at its own
    length and detaches at its end. All live slots ride one dispatch per pool
    block, and each clip's predictions are a solo streaming run's, so the CSVs
    are the lockstep path's. A --max-lag-ms below one push packet would read each
    healthy stream's own next packet as lag and zero-fill it, so it is raised to
    one packet (with a warning). The latency percentiles time the calls that
    dispatched a block (a poll that only hands over buffered outputs is not a
    block's latency)."""
    os.makedirs(out_dir, exist_ok=True)
    push = max(1, int(push_ms * d.fs / 1000))
    N = max(1, int(streams))
    pipe = _streaming_pipeline(cfg, d, model, variables, scaler, interp_ratio, block_frames,
                               context_frames, N, device)
    max_lag = None if max_lag_ms is None else max(1, int(max_lag_ms * d.fs / 1000))
    if max_lag is not None and max_lag < push:
        logger.warning("--max-lag-ms %g is below one push packet (%g ms, %d samples): "
                       "max_lag raised to one packet", max_lag_ms, push_ms, push)
        max_lag = push
    pool = SeldStreamPool(pipe, max_lag=max_lag)

    def _read(name):
        a, _ = read_wav(os.path.join(wav_dir, name), target_fs=d.fs)
        return _to_pcm16(a) if pcm16 else a

    def _write(s):
        if not s["outs"]:
            logger.warning("%s: too short to go live; no predictions", s["name"])
            return
        if s.get("fills"):
            logger.warning("%s: stall policy zero-filled label frames %s — those "
                           "predictions are concealment output", s["name"], s["fills"])
        ev = np.concatenate([o[0] for o in s["outs"]], axis=0)
        doa = np.concatenate([o[1] for o in s["outs"]], axis=0)
        _write_csv(cfg, d, out_dir, s["name"], ev, doa)

    todo = list(wavs)
    active: dict[int, dict] = {}
    lat, audio_seconds, done = [], 0.0, 0
    held: tuple[str, np.ndarray] | None = None  # decoded, waiting for a free slot
    t_all = time.time()
    while todo or held or active:
        # fill freed slots with the next files; decode before attaching, so an
        # unreadable wav never holds a slot
        while todo or held:
            if held is None:
                name = todo.pop(0)
                try:
                    held = (name, _read(name))
                except Exception as e:
                    logger.error("%s: unreadable (%s); skipped", name, e)
                    done += 1
                    continue
            h = pool.attach()
            if h is None:
                break  # pool full: keep the decoded clip for the next round
            name, audio = held
            held = None
            audio_seconds += audio.shape[1] / d.fs
            active[h] = {"name": name, "audio": audio, "pos": 0, "outs": [], "ended": False}
        for h, s in list(active.items()):
            n0, t0 = StreamingSeldPipeline.dispatches, time.time()
            if not s["ended"]:
                got = pool.push(h, s["audio"][:, s["pos"]:s["pos"] + push])
                s["pos"] += push
                if s["pos"] >= s["audio"].shape[1]:
                    got += pool.detach(h)
                    s["fills"] = pool.fill_label_ranges(h)
                    s["ended"] = True
                    s["audio"] = None
            else:
                got = pool.poll(h)  # draining: the other streams advance the clock
            if StreamingSeldPipeline.dispatches > n0:
                lat.append(time.time() - t0)
            s["outs"] += got
            if s["ended"] and pool.finished(h):
                _write(s)
                del active[h]
                done += 1
                logger.info("%d/%d streamed", done, len(wavs))
    dt = time.time() - t_all
    lat_ms = 1e3 * np.array(lat) if lat else np.zeros(1)
    algo_ms = (block_frames + context_frames + pipe.extractor.latency_frames) \
        * d.hop_len / d.fs * 1e3
    logger.info(
        "pool-streamed %.0f audio-s in %.1f s (%.0fx realtime aggregate, "
        "%d slot(s)); per-block compute latency p50 %.0f / p95 %.0f ms on "
        "top of the algorithmic %.0f ms lookahead",
        audio_seconds, dt, audio_seconds / max(dt, 1e-9), N,
        np.percentile(lat_ms, 50), np.percentile(lat_ms, 95), algo_ms)
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
    p.add_argument("--streaming", action="store_true",
                   help="simulated-live serving through the streaming pipeline")
    p.add_argument("--block-frames", type=int, default=160,
                   help="streaming: feature frames per emitted block")
    p.add_argument("--context-frames", type=int, default=256,
                   help="streaming: model context each side of a block")
    p.add_argument("--push-ms", type=float, default=100.0,
                   help="streaming: sample packet size")
    p.add_argument("--streams", type=int, default=1,
                   help="streaming: serve N equal-length clips per block dispatch")
    p.add_argument("--pcm16", action="store_true",
                   help="streaming: push raw int16 PCM, decoded on the card (half the "
                        "sample upload; exact for 16-bit sources at the target rate)")
    p.add_argument("--pool", action="store_true",
                   help="streaming: serve clips as unsynchronized live streams through "
                        "the slot pool (--streams slots)")
    p.add_argument("--max-lag-ms", type=float, default=None,
                   help="pool: a live stream whose client stops pushing holds the others "
                        "back this long, then its slot is zero-filled and the concealed "
                        "label frames are reported (at least one push packet; default: "
                        "the exact lock-step clock)")
    p.add_argument("--use-tuned-threshold", action="store_true",
                   help="serve at the val-calibrated sed_threshold persisted "
                        "by `salsa-infer --tune-threshold` "
                        "(tuned_threshold.json beside the checkpoints) "
                        "instead of the config value")
    a = p.parse_args(argv)
    return predict(a.exp_config, a.wav_dir, a.out_dir, a.exp_group_dir, a.exp_suffix,
                   a.checkpoint, a.batch_size, use_tuned_threshold=a.use_tuned_threshold,
                   streaming=a.streaming, block_frames=a.block_frames,
                   context_frames=a.context_frames, push_ms=a.push_ms, streams=a.streams,
                   pcm16=a.pcm16, pool=a.pool, max_lag_ms=a.max_lag_ms)


if __name__ == "__main__":
    main()
