"""K1: the fused SALSA spatial stage (counterpart of
`salsa_tpu.features.salsa_pallas`).

`salsa_spatial` launches the CUDA kernel `csrc/salsa_spatial.cu` on CUDA tensors
and runs `salsa_spatial_plain`, the same arithmetic in vectorized PyTorch, on CPU
tensors. Per (clip, bin, frame): 7-frame covariance -> R/tr(R) squared 3 times ->
principal eigenvector and the top two eigenvalues -> coherence test AND tracker
mask -> FOA direction or MIC phase features, zero where invalid. The Hermitian
matrices are held as `csrc/hermitian4.cuh` holds them (`Herm`: a real diagonal and
the complex upper entries) and every sum runs in the kernel's order; the kernel's
FMAs and its approximate reciprocal for the trace renormalisations differ from it
in the last bits only. Both take n_hop = 3 alone (`N_HOPS`), the only value any
configuration uses.

The mirror follows the kernel (3 squarings, as `salsa_pallas.N_SQUARINGS`), not
`salsa_tpu.features.salsa.principal_eigs_power`, which squares 4 times at the
default 20 power iterations. MIC features use atan2 where the Pallas kernel uses a
polynomial (<= 1e-5 rad apart).
"""
from __future__ import annotations

import numpy as np
import torch

from salsa_tpu_torch.kernels.build import check_launch, load_library
from salsa_tpu_torch.utils import threefry

C = 4
N_SQUARINGS = 3
N_HOPS = (3,)  # the window half-widths the kernels are compiled for
SPEED_OF_SOUND = 343.0

# jax.random.normal(PRNGKey(20211021), (2, 2, 4)) as salsa_pallas._start_vectors
# returns it, frozen as float32 literals (also in csrc/hermitian4.cuh)
START_S0 = np.array([0.72769094 + 0.32384574j, -0.9307311 - 2.380504j,
                     1.1572573 - 1.076081j, 0.88554 + 0.3645283j], dtype=np.complex64)
START_S1 = np.array([-2.3784811 + 0.20879258j, -1.759696 + 1.0385665j,
                     0.7045168 + 0.97886115j, 0.38834825 + 0.60916615j], dtype=np.complex64)

START_SEED = 20211021  # salsa_tpu's PRNGKey for the power iteration's start vectors


def start_vectors(n_channels: int) -> tuple[np.ndarray, np.ndarray]:
    """The power iteration's start vectors (s0, s1), complex64 (C,), at C =
    `n_channels` >= 2: `salsa_tpu`'s jax.random.normal(PRNGKey(20211021), (2, 2, C))
    draws (`salsa_tpu.features.salsa.principal_eigs_power`), computed bit for bit by
    `utils.threefry`. C = 4 gives START_S0 / START_S1."""
    if n_channels < 2:
        raise ValueError(f"SALSA needs at least 2 channels, got {n_channels}")
    v = threefry.normal(START_SEED, (2, 2, n_channels))
    s0, s1 = v[0, 0] + 1j * v[0, 1], v[1, 0] + 1j * v[1, 1]
    return s0.astype(np.complex64), s1.astype(np.complex64)


def mic_delta(fs: int, n_fft: int) -> float:
    """Phase-to-DOA scale: 2*pi*fs / (n_fft * c)."""
    return 2.0 * np.pi * fs / (n_fft * SPEED_OF_SOUND)


class _Cplx:
    """(re, im) tensor pair with complex arithmetic, in the kernel's term order."""

    __slots__ = ("re", "im")

    def __init__(self, re, im):
        self.re = re
        self.im = im

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


class Herm:
    """A 4x4 Hermitian matrix as `csrc/hermitian4.cuh` holds it: the real
    diagonal `d[i]` and the upper entries `o[(i, j)]`, i < j, each a tensor
    (pair) of the cells' shape."""

    __slots__ = ("d", "o")

    def __init__(self, d, o):
        self.d = list(d)
        self.o = dict(o)

    def entry(self, i, k):
        """H[i][k] for i != k."""
        return self.o[(i, k)] if i < k else self.o[(k, i)].conj()

    def scale(self, s):
        return Herm([d * s for d in self.d], {ij: h.scale(s) for ij, h in self.o.items()})


UPPER = [(i, j) for i in range(C) for j in range(i + 1, C)]


def _cmac(acc, a, b):
    """acc + a * b as the kernel's two chains of two products each."""
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
    """H @ H / (tr(H @ H) + 1e-30): diagonal h_ii^2 + sum |h_ik|^2, upper entries
    (h_ii + h_jj) h_ij + the two other products."""
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
    out = Herm(d, o)
    return out.scale(1.0 / (_trace(out) + 1e-30))


def _dot_terms(terms):
    acc = terms[0]
    for t in terms[1:]:
        acc = acc + t
    return acc


def _normalize(v):
    nrm2 = _dot_terms([v[c].re * v[c].re + v[c].im * v[c].im for c in range(C)])
    inv = torch.rsqrt(nrm2 + 1e-30)
    return [vc.scale(inv) for vc in v]


def _rayleigh(H, v):
    """v^H H v = sum h_ii |v_i|^2 + 2 Re sum_{i<j} conj(v_i) h_ij v_j."""
    diag = _dot_terms([H.d[i] * (v[i].re * v[i].re + v[i].im * v[i].im) for i in range(C)])
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
    dr = _dot_terms([v[c].re * u[c].re + v[c].im * u[c].im for c in range(C)])
    di = _dot_terms([v[c].re * u[c].im - v[c].im * u[c].re for c in range(C)])
    return [u[c] - _Cplx(dr * v[c].re - di * v[c].im, dr * v[c].im + di * v[c].re)
            for c in range(C)]


def _const_vec(s, like):
    return [_Cplx(torch.full_like(like, float(s[c].real)),
                  torch.full_like(like, float(s[c].imag))) for c in range(C)]


def window_covariance(xr, xi, n_hop):
    """The (2*n_hop+1)-frame covariance R = mean_k x[t+k] x[t+k]^H as a `Herm`,
    each entry (B, n_bins, n_frames): every product added in frame order, the
    diagonal as |x_i|^2, then scaled by 1/win, as the kernel does."""
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
    return Herm(d, o).scale(np.float32(1.0 / win).item())


def top_eigs(R, n_squarings, *, second=True):
    """(v, lambda0, lambda1) from a `Herm` R: principal eigenvector from two
    matvecs with (R/tr R)^(2^n_squarings), lambda0 = v^H R v, and lambda1 from 3
    steps of orthogonalised iteration with R/tr R (0 where `second` is False)."""
    Rn = R.scale(1.0 / (_trace(R) + 1e-30))
    P = Rn
    for _ in range(n_squarings):
        P = _square_renorm(P)

    like = R.d[0]
    v = _normalize(_matvec(P, _const_vec(START_S0, like)))
    v = _normalize(_matvec(P, v))
    lam0 = _rayleigh(R, v)
    if not second:
        return v, lam0, torch.zeros_like(lam0)

    u = _orth(_const_vec(START_S1, like), v)
    for _ in range(3):
        u = _normalize(_orth(_matvec(Rn, u), v))
    return v, lam0, _rayleigh(R, u)


def foa_features(v):
    """Re(v_c conj(v_0)) / |v_0|^2 for c = 1..3, L2-normalised: (B, 3, ...)."""
    inv_v0 = 1.0 / (v[0].re * v[0].re + v[0].im * v[0].im + 1e-30)
    comps = [(v[c].re * v[0].re + v[c].im * v[0].im) * inv_v0 for c in range(1, C)]
    nrm = torch.rsqrt(_dot_terms([r * r for r in comps]) + 1e-30)
    return torch.stack([r * nrm for r in comps], dim=1)


def salsa_spatial_plain(xr, xi, sig_mask, *, n_hop, audio_format, condition_number,
                        lower_bin, fs, n_fft):
    """Plain PyTorch version of the K1 kernel; same signature and arithmetic order.

    xr, xi: (B, 4, n_bins, n_frames + 2*n_hop) float32 STFT planes carrying n_hop
    context frames per side; sig_mask: (B, n_bins, n_frames) bool.
    Returns (B, 3, n_bins, n_frames) float32, zero where invalid.
    """
    R = window_covariance(xr, xi, n_hop)
    v, lam0, lam1 = top_eigs(R, N_SQUARINGS)
    valid = sig_mask & (lam0 > lam1 * condition_number)

    if audio_format == "foa":
        out = foa_features(v)
    else:
        abs_bin = torch.arange(lower_bin, lower_bin + xr.shape[2], dtype=torch.float32,
                               device=xr.device)[:, None]
        inv_bin = 1.0 / (np.float32(mic_delta(fs, n_fft)).item() * abs_bin)
        feats = []
        for c in range(1, C):
            pr = v[c].re * v[0].re + v[c].im * v[0].im
            pi = v[c].im * v[0].re - v[c].re * v[0].im
            feats.append(torch.atan2(pi, pr) * inv_bin)
        out = torch.stack(feats, dim=1)
    return torch.where(valid[:, None], out, torch.zeros((), dtype=out.dtype, device=out.device))


def _check_inputs(xr, xi, sig_mask, n_hop, audio_format):
    if audio_format not in ("foa", "mic"):
        raise ValueError(f"unknown audio format '{audio_format}'")
    if n_hop not in N_HOPS:
        raise NotImplementedError(
            f"the spatial kernels are instantiated for n_hop in {N_HOPS}, got n_hop={n_hop}")
    if xr.dim() != 4 or xr.shape != xi.shape:
        raise ValueError(f"xr/xi must be matching (B, C, bins, T+2h) planes, got "
                         f"{tuple(xr.shape)} and {tuple(xi.shape)}")
    if xr.shape[1] != C:
        raise NotImplementedError(
            f"the spatial kernel takes {C} channels, got {xr.shape[1]} (other channel "
            "counts take the power iteration: features.salsa.eig_features_from_planes)")
    B, _, n_bins, n_padded = xr.shape
    n_frames = n_padded - 2 * n_hop
    if B < 1 or n_bins < 1 or n_frames < 1:
        raise ValueError(f"empty spatial input {tuple(xr.shape)} with n_hop={n_hop}")
    if sig_mask.shape != (B, n_bins, n_frames):
        raise ValueError(f"sig_mask must be {(B, n_bins, n_frames)}, got {tuple(sig_mask.shape)}")
    if xr.dtype != torch.float32 or xi.dtype != torch.float32 or sig_mask.dtype != torch.bool:
        raise TypeError("xr/xi must be float32 and sig_mask bool")
    if not (xr.device == xi.device == sig_mask.device):
        raise ValueError("xr, xi and sig_mask must be on one device")
    if xr.numel() >= 2**31:
        raise ValueError(f"planes {tuple(xr.shape)} hold {xr.numel()} elements; the spatial "
                         "kernels index them in 32 bits (< 2^31): split the batch")
    return B, n_bins, n_frames


def salsa_spatial(xr, xi, sig_mask, *, n_hop, audio_format, condition_number, lower_bin,
                  fs, n_fft):
    """K1 wrapper. CUDA tensors launch `csrc/salsa_spatial.cu` (one launch for the
    whole batch); CPU tensors run `salsa_spatial_plain`. Shapes as the plain
    version; any other device, dtype, shape or layout raises."""
    B, n_bins, n_frames = _check_inputs(xr, xi, sig_mask, n_hop, audio_format)
    kw = dict(n_hop=n_hop, audio_format=audio_format, condition_number=condition_number,
              lower_bin=lower_bin, fs=fs, n_fft=n_fft)
    if xr.device.type == "cpu":
        return salsa_spatial_plain(xr, xi, sig_mask, **kw)
    if xr.device.type != "cuda":
        raise ValueError(f"salsa_spatial runs on cuda or cpu tensors, not {xr.device}")
    if not (xr.is_contiguous() and xi.is_contiguous() and sig_mask.is_contiguous()):
        raise ValueError("salsa_spatial needs contiguous xr, xi and sig_mask")
    lib = load_library()
    out = torch.empty((B, C - 1, n_bins, n_frames), dtype=torch.float32, device=xr.device)
    with torch.cuda.device(xr.device):
        err = lib.salsa_spatial_launch(
            xr.data_ptr(), xi.data_ptr(), sig_mask.data_ptr(), out.data_ptr(), B, n_bins,
            n_frames, n_hop, int(audio_format == "mic"), float(condition_number),
            lower_bin, float(mic_delta(fs, n_fft)), torch.cuda.current_stream().cuda_stream)
    check_launch("salsa_spatial", err)
    salsa_spatial.launches += 1
    return out


salsa_spatial.launches = 0
