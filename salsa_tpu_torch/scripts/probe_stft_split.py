"""Split-matmul STFT for the SALSA extraction against `dsp/stft.py`'s framed matmul,
on the card: the port's counterpart of `scripts/probe_stft_split.py`.

    python -m salsa_tpu_torch.scripts.probe_stft_split [--batch 32] [--iters 5] [--cpu]

At hop 300 and n_fft 512 frame t is row t of the padded wave (300 samples)
followed by the first 212 samples of row t + 1, so the DFT splits into two
matmuls over the contiguous rows, with no framed copy:

    re = rows[:T] @ C[:300] + rows[1:T+1, :212] @ C[300:512]

A second variant computes the DOA band's planes (C, bins_band, T) straight from
the band's columns of the DFT. Cases, as the original's (each ends in a sum):
stft_cur / stft_split (the planes), prep_cur / prep_split (dB spectrogram, the
padded band planes and K2's mask), full_cur / full_split (+ K1), and the full
chain at batch 64. Before any time is taken, both ways' features of one clip
must agree: the spectrograms on 99.99 % of cells within 2e-4 / 1e-4 and all
within 2e-2 / 1e-3, the spatial channels at K1's bound (masks disagree on
< 0.5 % of cells, atol 5e-3 where both are valid); the script raises otherwise.
Times are CUDA events around `--iters` calls back to back, the median of 3, after
a warm-up call. Runs on the first CUDA card; `--cpu` runs it on the CPU (a check
of the script, not a measurement). Prints one JSON object.
"""
from __future__ import annotations

import argparse
import json

import numpy as np
import torch
import torch.nn.functional as F

from salsa_tpu_torch.dsp.stft import _windowed_dft_matrices, power_to_db, stft_planes
from salsa_tpu_torch.features.salsa import (
    SalsaParams,
    _compression_matrix,
    band_planes,
    eig_features_from_planes,
    tracker_mask,
)
from salsa_tpu_torch.scripts.bench_extract import make_waves
from salsa_tpu_torch.scripts.timing import card_name, device_ms, script_device

FS, N_FFT, HOP = 24000, 512, 300
CASES = ("stft_cur", "stft_split", "prep_cur", "prep_split", "full_cur", "full_split",
         "full_cur_b64", "full_split_b64")


def rows_view(w: torch.Tensor):
    """(B, C, S) waves -> (B, C, T + 1, HOP) rows of the reflect-padded wave, T."""
    n = w.shape[-1]
    wp = F.pad(w.reshape(-1, 1, n), (N_FFT // 2, N_FFT // 2), mode="reflect")
    wp = wp.reshape(*w.shape[:-1], -1)
    n_frames = 1 + (wp.shape[-1] - N_FFT) // HOP
    need = (n_frames + 1) * HOP
    wp = F.pad(wp, (0, need - wp.shape[-1])) if need > wp.shape[-1] else wp[..., :need]
    return wp.reshape(*wp.shape[:-1], n_frames + 1, HOP), n_frames


def stft_planes_split(w: torch.Tensor):
    rows, T = rows_view(w)
    cos_mat, sin_mat = _windowed_dft_matrices(N_FFT, N_FFT, w.device)
    a, b = rows[..., :T, :], rows[..., 1:T + 1, :N_FFT - HOP]
    return (a @ cos_mat[:HOP] + b @ cos_mat[HOP:], a @ sin_mat[:HOP] + b @ sin_mat[HOP:])


def band_planes_split(w: torch.Tensor, p: SalsaParams):
    """(B, C, bins_band, T + 2h) band planes from the band's DFT columns."""
    rows, T = rows_view(w)
    cos_mat, sin_mat = _windowed_dft_matrices(N_FFT, N_FFT, w.device)
    lo, hi, h = p.lower_bin, p.upper_bin, p.n_hopframes
    a, b = rows[..., :T, :], rows[..., 1:T + 1, :N_FFT - HOP]

    def plane(m):
        x = (m[:HOP, lo:hi].T @ a.transpose(-1, -2)) + (m[HOP:, lo:hi].T @ b.transpose(-1, -2))
        return torch.cat([x[..., -h:], x, x[..., :h]], dim=-1).contiguous()

    return plane(cos_mat), plane(sin_mat), T


def logspec(re, im):
    return power_to_db((re * re + im * im) @ _compression_matrix(N_FFT, True, re.device).T)


def prep_cur(w, p):
    re, im = stft_planes(w, N_FFT, HOP)
    xr, xi = band_planes(re, im, p)
    mask, _ = tracker_mask(xr, xi, re.shape[-2], p)
    return logspec(re, im), xr, xi, mask


def prep_split(w, p):
    re, im = stft_planes_split(w)
    xr, xi, T = band_planes_split(w, p)
    mask, _ = tracker_mask(xr, xi, T, p)
    return logspec(re, im), xr, xi, mask


def features(w, p, prep):
    """(B, 7, T, 200) SALSA features through `prep`, as `extract_salsa` assembles them."""
    spec, xr, xi, mask = prep(w, p)
    eig = eig_features_from_planes(xr, xi, mask, p).transpose(-1, -2)
    return torch.cat([spec, F.pad(eig, (0, p.freq_dim - (p.upper_bin - p.lower_bin)))], dim=1)


def check_agree(cur: np.ndarray, split: np.ndarray, p: SalsaParams) -> dict:
    """The two ways' features of one clip at the bounds of the module docstring."""
    spec_c, spec_s = cur[:, :4], split[:, :4]
    close = np.isclose(spec_s, spec_c, atol=2e-4, rtol=1e-4).mean()
    if close < 0.9999 or not np.allclose(spec_s, spec_c, atol=2e-2, rtol=1e-3):
        raise AssertionError(f"split STFT spectrograms disagree: {1 - close:.2e} of cells "
                             f"off 2e-4, max {np.abs(spec_s - spec_c).max():.3e}")
    nb = p.upper_bin - p.lower_bin
    eig_c, eig_s = cur[:, 4:, :, :nb], split[:, 4:, :, :nb]
    m_c, m_s = np.any(eig_c != 0, axis=1), np.any(eig_s != 0, axis=1)
    disagree = float(np.mean(m_c != m_s))
    both = m_c & m_s
    err = float(np.abs(eig_s - eig_c).transpose(0, 2, 3, 1)[both].max()) if both.any() else 0.0
    if disagree >= 0.005 or err > 5e-3:
        raise AssertionError(f"split STFT spatial features disagree: masks {disagree:.3%}, "
                             f"max {err:.3e} where both are valid")
    return {"spec_max_abs_diff": float(np.abs(spec_s - spec_c).max()),
            "eig_max_abs_diff": err, "mask_disagreement": disagree}


def main(argv: list[str] | None = None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--batch", type=int, default=32)
    ap.add_argument("--seconds", type=float, default=60.0)
    ap.add_argument("--iters", type=int, default=5)
    ap.add_argument("--cpu", action="store_true", help="run on the CPU (a check, not a timing)")
    args = ap.parse_args(argv)
    dev = script_device("probe_stft_split", args.cpu)
    p = SalsaParams(fs=FS, n_fft=N_FFT, hop_length=HOP, fmax_doa=9000.0, audio_format="foa")
    x = torch.from_numpy(make_waves(args.batch, args.seconds)).to(dev)
    out = {"batch": args.batch, "seconds": args.seconds}
    re_c, im_c = stft_planes(x[:1], N_FFT, HOP)
    re_s, im_s = stft_planes_split(x[:1])
    out["stft_max_abs_diff"] = float(torch.maximum((re_s - re_c).abs().max(),
                                                   (im_s - im_c).abs().max()))
    cur, split = (features(x[:1], p, f).cpu().numpy() for f in (prep_cur, prep_split))
    out["features_max_abs_diff"] = float(np.abs(cur - split).max())
    out.update(check_agree(cur, split, p))

    def total(ts):
        return sum(t.sum() for t in ts)

    fns = {"stft_cur": lambda w: total(stft_planes(w, N_FFT, HOP)),
           "stft_split": lambda w: total(stft_planes_split(w)),
           "prep_cur": lambda w: total(prep_cur(w, p)[:3]),
           "prep_split": lambda w: total(prep_split(w, p)[:3]),
           "full_cur": lambda w: features(w, p, prep_cur).sum(),
           "full_split": lambda w: features(w, p, prep_split).sum()}
    x64, method = None, ""
    for name in CASES:
        if name.endswith("_b64") and x64 is None:
            x64 = torch.from_numpy(make_waves(64, args.seconds)).to(dev)
        data, fn = (x64, fns[name[:-4]]) if name.endswith("_b64") else (x, fns[name])
        ms, method = device_ms(lambda: fn(data), dev, calls=args.iters, repeats=3)
        out[name] = {"ms": ms, "x_realtime": args.seconds * data.shape[0] / (ms / 1e3)}
    out.update(method=method, device=str(dev), card=card_name(dev))
    print(json.dumps({"probe_stft_split": out}), flush=True)
    return out


if __name__ == "__main__":
    main()
