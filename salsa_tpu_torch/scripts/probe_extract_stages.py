"""Stage by stage timing of the SALSA-FOA extraction on the card: the port's
counterpart of `scripts/probe_extract_stages.py`.

    python -m salsa_tpu_torch.scripts.probe_extract_stages [--batch 4 32] [--iters 5] [--cpu]

As the original, cumulative prefixes of `features.salsa.extract_salsa`, each
ending in one scalar (a sum), so that a stage's cost is the difference of two
prefixes:

  stft       the framed windowed-DFT matmul (`dsp.stft.stft_planes`: re, im);
  stft_n256  the same with 256 DFT columns and the Nyquist bin as a separate
             matrix-vector product (the original's variant);
  +logspec   + power, the compression matmul, dB;
  +tracker   + the DOA band planes, their wrap padding and K2 on channel 0;
  full       + K1 (the whole extraction but the final concatenation).

Then K1 and K2 alone on the stage's own inputs. Input: seeded noise plus a
440 Hz tone, (batch, 4, seconds * 24 kHz) float32 on the card; each `--batch`
in turn (the serving request's 4 and the training batch's 32 clips). Times are
CUDA events around `--iters` calls back to back, the median of 3, after a
warm-up call. Runs on the first CUDA card; `--cpu` runs it on the CPU (a check of
the script, not a measurement). Prints one JSON object.
"""
from __future__ import annotations

import argparse
import json

import torch

from salsa_tpu_torch.dsp.stft import _windowed_dft_matrices, power_to_db, stft_planes
from salsa_tpu_torch.features.salsa import (
    SalsaParams,
    _compression_matrix,
    band_planes,
    eig_features_from_planes,
    noise_floor_mask,
    tracker_mask,
)
from salsa_tpu_torch.features.salsa_spatial import salsa_spatial
from salsa_tpu_torch.scripts.bench_extract import make_waves
from salsa_tpu_torch.scripts.timing import card_name, device_ms, script_device

FS, N_FFT, HOP = 24000, 512, 300
STAGES = ("stft", "stft_n256", "+logspec", "+tracker", "full")


def stft_planes_n256(x: torch.Tensor):
    """STFT planes from 256 DFT columns plus the Nyquist bin's own product (its
    sine column is zero), as the original's N=256 variant."""
    x = torch.nn.functional.pad(x.reshape(-1, 1, x.shape[-1]), (N_FFT // 2, N_FFT // 2),
                                mode="reflect").reshape(*x.shape[:-1], -1)
    frames = x.unfold(-1, N_FFT, HOP)
    cos_mat, sin_mat = _windowed_dft_matrices(N_FFT, N_FFT, x.device)
    re = frames @ cos_mat[:, :256]
    nyq = frames @ cos_mat[:, 256]
    im = frames @ sin_mat[:, :256]
    return (torch.cat([re, nyq[..., None]], -1),
            torch.nn.functional.pad(im, (0, 1)))


def stage_fns(p: SalsaParams) -> dict:
    """The cumulative prefixes, each (B, 4, n) waves -> a scalar."""
    def logspec(re, im):
        W = _compression_matrix(N_FFT, True, re.device)
        return power_to_db((re * re + im * im) @ W.T)

    def upto_stft(w, fn=stft_planes):
        re, im = fn(w)
        return re.sum() + im.sum()

    def upto_logspec(w):
        return logspec(*stft_planes(w, N_FFT, HOP)).sum()

    def upto_tracker(w):
        re, im = stft_planes(w, N_FFT, HOP)
        xr, xi = band_planes(re, im, p)
        mask, _ = tracker_mask(xr, xi, re.shape[-2], p)
        return logspec(re, im).sum() + mask.sum()

    def full(w):
        re, im = stft_planes(w, N_FFT, HOP)
        xr, xi = band_planes(re, im, p)
        mask, _ = tracker_mask(xr, xi, re.shape[-2], p)
        eig = eig_features_from_planes(xr, xi, mask, p)
        return logspec(re, im).sum() + eig.sum()

    return {"stft": upto_stft, "stft_n256": lambda w: upto_stft(w, stft_planes_n256),
            "+logspec": upto_logspec, "+tracker": upto_tracker, "full": full}


def kernel_inputs(w: torch.Tensor, p: SalsaParams):
    """K1's and K2's inputs at this batch: the padded band planes and the mask."""
    re, im = stft_planes(w, N_FFT, HOP)
    xr, xi = band_planes(re, im, p)
    mask, _ = tracker_mask(xr, xi, re.shape[-2], p)
    return xr, xi, mask, re.shape[-2]


def main(argv: list[str] | None = None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--batch", type=int, nargs="+", default=[4, 32])
    ap.add_argument("--seconds", type=float, default=60.0)
    ap.add_argument("--iters", type=int, default=5)
    ap.add_argument("--cpu", action="store_true", help="run on the CPU (a check, not a timing)")
    args = ap.parse_args(argv)
    dev = script_device("probe_extract_stages", args.cpu)
    p = SalsaParams(fs=FS, n_fft=N_FFT, hop_length=HOP, fmax_doa=9000.0, audio_format="foa")
    fns = stage_fns(p)
    rows, method = [], ""
    for batch in args.batch:
        w = torch.from_numpy(make_waves(batch, args.seconds)).to(dev)
        row = {"batch": batch, "seconds": args.seconds}
        for name in STAGES:
            value = float(fns[name](w))
            if value != value:
                raise AssertionError(f"{name} at batch {batch}: NaN checksum")
            row[name], method = device_ms(lambda: fns[name](w), dev, calls=args.iters,
                                          repeats=3)
        xr, xi, mask, n_t = kernel_inputs(w, p)
        xr0, xi0 = xr[:, 0].contiguous(), xi[:, 0].contiguous()
        row["k2"], _ = device_ms(lambda: noise_floor_mask(xr0, xi0, n_hop=p.n_hopframes,
                                                          n_frames=n_t), dev, calls=10, repeats=3)
        row["k1"], _ = device_ms(lambda: salsa_spatial(
            xr, xi, mask, n_hop=p.n_hopframes, audio_format="foa",
            condition_number=p.condition_number, lower_bin=p.lower_bin, fs=FS, n_fft=N_FFT),
            dev, calls=10, repeats=3)
        rows.append(row)
        del w, xr, xi, mask, xr0, xi0
        if dev.type == "cuda":
            torch.cuda.empty_cache()
    out = {"probe_extract_stages": rows, "method": method,
           "kernels_method": "K1 and K2 alone: CUDA events around 10 calls back to back, "
                             "median of 3" if dev.type == "cuda" else method,
           "device": str(dev), "card": card_name(dev)}
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main()
