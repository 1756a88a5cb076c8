"""SALSA's spatial stage and noise-floor tracker in plain PyTorch, float32: a frozen
copy of the plain versions that the SALSA paper's recipe defines (arXiv:2110.00275,
section 3), kept here so that the reference imports nothing of the program.

Tracker: channel 0's 3-frame RMS magnitude, a floor that starts at half the mean
of the first 5 frames and moves up (slowly after 3 frames above it) or down each
frame; a cell is signal where its magnitude exceeds 1.5 times the floor.

Spatial stage: at each (clip, bin, frame) the 7-frame covariance of the 4
channels, R / tr(R) squared 3 times, the principal eigenvector and the top two
eigenvalues; a cell is valid where the tracker says signal and lambda0 >
condition_number * lambda1. FOA features are the eigenvector's components 1..3
against component 0, L2-normalised; MIC features the phase against channel 0
over delta * bin. Every sum runs in a fixed order, so the result does not depend
on the batch it is computed in.
"""
from __future__ import annotations

import numpy as np
import torch

C = 4
N_SQUARINGS = 3
N_SIG_FRAMES = 3
SPEED_OF_SOUND = 343.0
FLOOR_UP = float(np.float32(1.02))
FLOOR_UP_SLOW = float(np.float32(1.002))
FLOOR_DOWN = float(np.float32(0.98))
FLOOR_MIN = 1e-6
# the power iteration's start vectors: jax.random.normal(PRNGKey(20211021), (2, 2, 4))
# of the original implementation, as float32 literals
START_S0 = np.array([0.72769094 + 0.32384574j, -0.9307311 - 2.380504j,
                     1.1572573 - 1.076081j, 0.88554 + 0.3645283j], dtype=np.complex64)
START_S1 = np.array([-2.3784811 + 0.20879258j, -1.759696 + 1.0385665j,
                     0.7045168 + 0.97886115j, 0.38834825 + 0.60916615j], dtype=np.complex64)
UPPER = [(i, j) for i in range(C) for j in range(i + 1, C)]


def mic_delta(fs: int, n_fft: int) -> float:
    """Phase-to-DOA scale: 2 pi fs / (n_fft c)."""
    return 2.0 * np.pi * fs / (n_fft * SPEED_OF_SOUND)


# ---------------------------------------------------------------------------
# tracker
# ---------------------------------------------------------------------------

def sqrt_rn(q: torch.Tensor) -> torch.Tensor:
    """Correctly rounded float32 square root: torch's may be one ulp off on some
    CPUs, so the root moves to the neighbour whose rounding interval holds q."""
    y = torch.sqrt(q)
    up = torch.nextafter(y, torch.full_like(y, float("inf")))
    down = torch.nextafter(y, torch.zeros_like(y))
    qd, yd = q.double(), y.double()
    hi, lo = (yd + up.double()) * 0.5, (yd + down.double()) * 0.5
    return torch.where(qd > hi * hi, up, torch.where(qd < lo * lo, down, y))


def tracker_mask(xr0: torch.Tensor, xi0: torch.Tensor, n_hop: int, n_frames: int,
                 snr_ratio: float = 1.5) -> torch.Tensor:
    """Signal mask (B, bins, n_frames) of channel-0 band planes (B, bins, n_frames +
    2 n_hop), the tracker started at the clip's first frame."""
    mag = None
    for i in range(3):
        sl = slice(n_hop - i, n_hop - i + n_frames)
        p = xr0[..., sl] * xr0[..., sl] + xi0[..., sl] * xi0[..., sl]
        mag = p if mag is None else mag + p
    mag = sqrt_rn(mag / 3.0)
    s = mag[..., 0]
    for t in range(1, min(5, n_frames)):
        s = s + mag[..., t]
    floor = s / float(min(5, n_frames)) * 0.5
    countdown = torch.full(floor.shape, N_SIG_FRAMES, dtype=torch.int32, device=floor.device)
    up, up_slow, down = (torch.tensor(v, dtype=torch.float32, device=floor.device)
                         for v in (FLOOR_UP, FLOOR_UP_SLOW, FLOOR_DOWN))
    sig = []
    for xf in mag.movedim(-1, 0).contiguous():
        above = xf > floor
        countdown = torch.where(above, countdown - 1, N_SIG_FRAMES).to(torch.int32)
        factor = torch.where(above, torch.where(countdown < 0, up_slow, up), down)
        floor = torch.clamp(floor * factor, min=FLOOR_MIN)
        sig.append(xf > snr_ratio * floor)
    return torch.stack(sig, dim=-1)


# ---------------------------------------------------------------------------
# spatial stage
# ---------------------------------------------------------------------------

class _Cplx:
    __slots__ = ("re", "im")

    def __init__(self, re, im):
        self.re, self.im = re, im

    def __add__(self, o):
        return _Cplx(self.re + o.re, self.im + o.im)

    def __sub__(self, o):
        return _Cplx(self.re - o.re, self.im - o.im)

    def __mul__(self, o):
        return _Cplx(self.re * o.re - self.im * o.im, self.re * o.im + self.im * o.re)

    def conj(self):
        return _Cplx(self.re, -self.im)

    def scale(self, s):
        return _Cplx(self.re * s, self.im * s)


class _Herm:
    """A 4x4 Hermitian matrix: real diagonal d[i], upper entries o[(i, j)]."""

    __slots__ = ("d", "o")

    def __init__(self, d, o):
        self.d, self.o = list(d), dict(o)

    def entry(self, i, k):
        return self.o[(i, k)] if i < k else self.o[(k, i)].conj()

    def scale(self, s):
        return _Herm([d * s for d in self.d], {ij: h.scale(s) for ij, h in self.o.items()})


def _cmac(acc, a, b):
    re = acc.re + a.re * b.re
    re = re - a.im * b.im
    im = acc.im + a.re * b.im
    im = im + a.im * b.re
    return _Cplx(re, im)


def _matvec(H, v):
    out = []
    for i in range(C):
        acc = v[i].scale(H.d[i])
        for k in range(C):
            if k != i:
                acc = _cmac(acc, H.entry(i, k), v[k])
        out.append(acc)
    return out


def _trace(H):
    return ((H.d[0] + H.d[1]) + H.d[2]) + H.d[3]


def _square_renorm(H):
    d = []
    for i in range(C):
        acc = H.d[i] * H.d[i]
        for k in range(C):
            if k != i:
                h = H.o[(min(i, k), max(i, k))]
                acc = acc + h.re * h.re
                acc = acc + h.im * h.im
        d.append(acc)
    o = {}
    for i, j in UPPER:
        acc = H.o[(i, j)].scale(H.d[i] + H.d[j])
        for k in range(C):
            if k not in (i, j):
                acc = _cmac(acc, H.entry(i, k), H.entry(k, j))
        o[(i, j)] = acc
    out = _Herm(d, o)
    return out.scale(1.0 / (_trace(out) + 1e-30))


def _sum(terms):
    acc = terms[0]
    for t in terms[1:]:
        acc = acc + t
    return acc


def _normalize(v):
    inv = torch.rsqrt(_sum([v[c].re * v[c].re + v[c].im * v[c].im for c in range(C)]) + 1e-30)
    return [vc.scale(inv) for vc in v]


def _rayleigh(H, v):
    diag = _sum([H.d[i] * (v[i].re * v[i].re + v[i].im * v[i].im) for i in range(C)])
    cross = None
    for i, j in UPPER:
        w = H.o[(i, j)] * v[j]
        if cross is None:
            cross = v[i].re * w.re + v[i].im * w.im
        else:
            cross = cross + v[i].re * w.re
            cross = cross + v[i].im * w.im
    return diag + 2.0 * cross


def _orth(u, v):
    dr = _sum([v[c].re * u[c].re + v[c].im * u[c].im for c in range(C)])
    di = _sum([v[c].re * u[c].im - v[c].im * u[c].re for c in range(C)])
    return [u[c] - _Cplx(dr * v[c].re - di * v[c].im, dr * v[c].im + di * v[c].re)
            for c in range(C)]


def _const_vec(s, like):
    return [_Cplx(torch.full_like(like, float(s[c].real)), torch.full_like(like, float(s[c].imag)))
            for c in range(C)]


def _covariance(xr, xi, n_hop):
    n_frames = xr.shape[-1] - 2 * n_hop
    win = 2 * n_hop + 1
    re = [[xr[:, c, :, k:k + n_frames] for c in range(C)] for k in range(win)]
    im = [[xi[:, c, :, k:k + n_frames] for c in range(C)] for k in range(win)]
    d = [re[0][i] * re[0][i] + im[0][i] * im[0][i] for i in range(C)]
    o = {(i, j): _Cplx(re[0][i] * re[0][j] + im[0][i] * im[0][j],
                       im[0][i] * re[0][j] - re[0][i] * im[0][j]) for i, j in UPPER}
    for k in range(1, win):
        for i in range(C):
            d[i] = d[i] + re[k][i] * re[k][i]
            d[i] = d[i] + im[k][i] * im[k][i]
        for i, j in UPPER:
            h = o[(i, j)]
            hr = h.re + re[k][i] * re[k][j]
            hr = hr + im[k][i] * im[k][j]
            hi = h.im + im[k][i] * re[k][j]
            hi = hi - re[k][i] * im[k][j]
            o[(i, j)] = _Cplx(hr, hi)
    return _Herm(d, o).scale(float(np.float32(1.0 / win)))


def _top_eigs(R):
    Rn = R.scale(1.0 / (_trace(R) + 1e-30))
    P = Rn
    for _ in range(N_SQUARINGS):
        P = _square_renorm(P)
    like = R.d[0]
    v = _normalize(_matvec(P, _const_vec(START_S0, like)))
    v = _normalize(_matvec(P, v))
    lam0 = _rayleigh(R, v)
    u = _orth(_const_vec(START_S1, like), v)
    for _ in range(3):
        u = _normalize(_orth(_matvec(Rn, u), v))
    return v, lam0, _rayleigh(R, u)


def spatial_features(xr, xi, sig_mask, *, n_hop, audio_format, condition_number, lower_bin,
                     fs, n_fft):
    """(B, 4, bins, T + 2 n_hop) band planes and the tracker mask (B, bins, T) ->
    (B, 3, bins, T) spatial features, zero where a cell is not valid."""
    R = _covariance(xr, xi, n_hop)
    v, lam0, lam1 = _top_eigs(R)
    valid = sig_mask & (lam0 > lam1 * condition_number)
    if audio_format == "foa":
        inv_v0 = 1.0 / (v[0].re * v[0].re + v[0].im * v[0].im + 1e-30)
        comps = [(v[c].re * v[0].re + v[c].im * v[0].im) * inv_v0 for c in range(1, C)]
        nrm = torch.rsqrt(_sum([r * r for r in comps]) + 1e-30)
        out = torch.stack([r * nrm for r in comps], dim=1)
    else:
        abs_bin = torch.arange(lower_bin, lower_bin + xr.shape[2], dtype=torch.float32,
                               device=xr.device)[:, None]
        inv_bin = 1.0 / (float(np.float32(mic_delta(fs, n_fft))) * abs_bin)
        out = torch.stack([torch.atan2(v[c].im * v[0].re - v[c].re * v[0].im,
                                       v[c].re * v[0].re + v[c].im * v[0].im) * inv_bin
                           for c in range(1, C)], dim=1)
    return torch.where(valid[:, None], out, torch.zeros((), dtype=out.dtype, device=out.device))
