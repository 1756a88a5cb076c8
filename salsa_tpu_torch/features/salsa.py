"""SALSA feature (counterpart of `salsa_tpu.features.salsa`): multichannel
log-linear spectrogram + normalized principal eigenvector of the local spatial
covariance at each time-frequency bin of the DOA band.

The noise-floor tracker is K2 (`csrc/noise_floor.cu`: a block of 32 (clip, bin)
rows, producer warps staging tiles of frames in shared memory, one consumer warp
running the recurrence) and the spatial stage is K1 (`features/salsa_spatial.py`).
On CPU tensors both run their plain PyTorch versions. Layouts follow `salsa_tpu`
with its `vmap` written out as a leading batch dimension: waves (B, 4, n_samples),
band planes (B, C, bins, T + 2h), features (B, 7, T, F).

`eig_method` 'auto' (and 'pallas') is K1 on every device. An explicit 'power' or
'eigh', or is_tracking=False, takes `salsa_tpu`'s XLA branch instead, ported here
as plain tensor code (`eig_features_from_padded`): the windowed covariance as
complex outer products, then repeated-squaring power iteration or
`torch.linalg.eigh`. Without tracking there is no tracker and no coherence test:
every cell is valid, so K2 does not run.
"""
from __future__ import annotations

import functools
from dataclasses import dataclass

import numpy as np
import torch
import torch.nn.functional as F

from salsa_tpu_torch.dsp.filterbank import high_freq_compression_matrix
from salsa_tpu_torch.dsp.stft import power_to_db, stft_planes
from salsa_tpu_torch.features.salsa_spatial import (
    mic_delta,
    salsa_spatial,
    start_vectors,
)
from salsa_tpu_torch.kernels.build import check_launch, load_library

# tracker constants (reference salsa_feature_extraction.py:28-93): alpha 0.02,
# slow factor 0.1, 3-frame countdown; float32 as the kernel receives them
N_SIG_FRAMES = 3
_ALPHA = 0.02
FLOOR_UP = np.float32(1.0 + _ALPHA).item()
FLOOR_UP_SLOW = np.float32(1.0 + 0.1 * _ALPHA).item()
FLOOR_DOWN = np.float32(1.0 - _ALPHA).item()
FLOOR_MIN = 1e-6
EIG_METHODS = ("auto", "pallas", "power", "eigh")


@dataclass(frozen=True)
class SalsaParams:
    fs: int = 24000
    n_fft: int = 512
    hop_length: int = 300
    win_length: int | None = None
    fmin_doa: float = 50.0
    fmax_doa: float = 9000.0  # 9000 for FOA, 4000 for MIC
    audio_format: str = "foa"  # 'foa' | 'mic'
    condition_number: float = 5.0
    n_hopframes: int = 3
    is_tracking: bool = True
    compress_high_freq: bool = True
    eig_method: str = "auto"  # 'auto' | 'pallas' (K1) | 'power' | 'eigh'

    def __post_init__(self):
        if self.eig_method not in EIG_METHODS:
            raise ValueError(f"unknown eig_method '{self.eig_method}'; one of {EIG_METHODS}")

    @property
    def uses_k1(self) -> bool:
        """Whether the spatial stage is K1: 'auto'/'pallas' with tracking (at 4
        channels; `eig_features_from_planes` sends other counts to the power
        iteration, as salsa_tpu does). salsa_tpu sends everything else to its XLA
        branch."""
        return self.is_tracking and self.eig_method in ("auto", "pallas")

    @property
    def lower_bin(self) -> int:
        return max(1, int(np.floor(self.fmin_doa * self.n_fft / self.fs)))

    @property
    def upper_bin(self) -> int:
        fmax_doa = min(self.fmax_doa, self.fs // 2)
        return int(np.floor(fmax_doa * self.n_fft / self.fs))

    @property
    def freq_dim(self) -> int:
        if self.compress_high_freq:
            return {512: 200, 256: 100}[self.n_fft]
        return self.n_fft // 2


# ---------------------------------------------------------------------------
# Noise-floor tracker: plain versions
# ---------------------------------------------------------------------------

def sqrt_rn(q: torch.Tensor) -> torch.Tensor:
    """Correctly rounded square root of a non-negative float32 tensor, as CUDA's
    __fsqrt_rn. torch's float32 sqrt on the CPU can be one ulp off (with AVX512,
    about 1 root in 150 of random input); the root is moved to the neighbour whose
    rounding interval holds q, decided exactly in float64 (a midpoint between two
    float32 values has 25 bits, its square 50)."""
    y = torch.sqrt(q)
    up = torch.nextafter(y, torch.full_like(y, float("inf")))
    down = torch.nextafter(y, torch.zeros_like(y))
    qd, yd = q.double(), y.double()
    hi, lo = (yd + up.double()) * 0.5, (yd + down.double()) * 0.5
    return torch.where(qd > hi * hi, up, torch.where(qd < lo * lo, down, y))


def tracking_magspec_planes(xr0: torch.Tensor, xi0: torch.Tensor, n_hopframes: int,
                            n_frames: int) -> torch.Tensor:
    """3-frame RMS magnitude of channel 0 from re/im planes (..., bins, T + 2h):
    sqrt((|x[t]|^2 + |x[t-1]|^2 + |x[t-2]|^2) / 3), summed in that order, every
    operation correctly rounded in float32."""
    acc = None
    for i in range(3):
        sl = slice(n_hopframes - i, n_hopframes - i + n_frames)
        p = xr0[..., sl] * xr0[..., sl] + xi0[..., sl] * xi0[..., sl]
        acc = p if acc is None else acc + p
    return sqrt_rn(acc / 3.0)


def tracker_init_state(magspec: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Clip-start tracker state for magspec (..., bins, T), T >= 1: floor = 0.5 *
    mean of the first min(5, T) frames (summed in frame order, as K2 does),
    countdown = 3."""
    n = min(5, magspec.shape[-1])
    if n < 1:
        raise ValueError("the tracker's initial floor needs at least one frame")
    s = magspec[..., 0]
    for t in range(1, n):
        s = s + magspec[..., t]
    floor0 = s / float(n) * 0.5
    countdown0 = torch.full(magspec.shape[:-1], N_SIG_FRAMES, dtype=torch.int32,
                            device=magspec.device)
    return floor0, countdown0


def noise_floor_scan(magspec: torch.Tensor, state0: tuple[torch.Tensor, torch.Tensor],
                     snr_ratio: float = 1.5, collect_states: bool = False):
    """Up/down noise-floor tracker from an explicit entering state.

    magspec: (..., bins, T) tracking magnitudes; state0 = (floor f32, countdown
    int32), each (..., bins). Returns (final_state, mask) with mask (..., bins, T)
    bool; with collect_states also the state entering every frame, (floor,
    countdown) each (..., T, bins) (salsa_tpu's (T, bins) per clip). A Python loop
    over frames, vectorized over the leading dims.
    """
    floor, countdown = state0
    up = torch.tensor(FLOOR_UP, dtype=torch.float32, device=magspec.device)
    up_slow = torch.tensor(FLOOR_UP_SLOW, dtype=torch.float32, device=magspec.device)
    down = torch.tensor(FLOOR_DOWN, dtype=torch.float32, device=magspec.device)
    frames = magspec.movedim(-1, 0).contiguous()
    sig, floors, countdowns = [], [], []
    for xf in frames:
        if collect_states:
            floors.append(floor)
            countdowns.append(countdown)
        above = xf > floor
        countdown = torch.where(above, countdown - 1, N_SIG_FRAMES).to(torch.int32)
        factor = torch.where(above, torch.where(countdown < 0, up_slow, up), down)
        floor = torch.clamp(floor * factor, min=FLOOR_MIN)
        sig.append(xf > snr_ratio * floor)
    mask = torch.stack(sig, dim=-1)
    if collect_states:
        states = (torch.stack(floors, dim=-2), torch.stack(countdowns, dim=-2))
        return (floor, countdown), mask, states
    return (floor, countdown), mask


def noise_floor_mask_plain(xr0, xi0, *, n_hop, n_frames, snr_ratio=1.5, state0=None,
                           restart=None, collect_states=False):
    """Plain version of K2: tracking magnitude -> (initial state) -> tracker.
    Returns (mask, final state), and with collect_states the per-frame states."""
    mag = tracking_magspec_planes(xr0, xi0, n_hop, n_frames)
    if state0 is None:
        state0 = tracker_init_state(mag)
    elif restart is not None:
        start, sel = tracker_init_state(mag), restart[:, None]
        state0 = (torch.where(sel, start[0], state0[0]), torch.where(sel, start[1], state0[1]))
    final, mask, *states = noise_floor_scan(mag, state0, snr_ratio, collect_states)
    return (mask, final, *states)


# ---------------------------------------------------------------------------
# K2 wrapper
# ---------------------------------------------------------------------------

def noise_floor_mask(xr0: torch.Tensor, xi0: torch.Tensor, *, n_hop: int, n_frames: int,
                     snr_ratio: float = 1.5, state0=None, restart: torch.Tensor | None = None,
                     collect_states: bool = False):
    """Noise-tracker mask from channel-0 planes xr0/xi0 (B, bins, n_frames + 2*n_hop).

    Returns (mask (B, bins, n_frames) bool, (floor f32, countdown int32) (B, bins)),
    the state after the last frame. state0 resumes from a given entering state;
    None starts the clip (floor from the first min(5, n_frames) frames, countdown
    3). restart, a (B,) bool tensor beside state0, starts the flagged clips here
    while the others resume (a stream pool's new stream in one slot). With
    collect_states a third item holds the state entering every frame, (floor f32,
    countdown int32) each (B, n_frames, bins). CUDA tensors launch
    `csrc/noise_floor.cu` once for the batch (its collect_states instantiation
    when asked); CPU tensors run `noise_floor_mask_plain`. Anything else raises.
    """
    if xr0.dim() != 3 or xr0.shape != xi0.shape:
        raise ValueError(f"xr0/xi0 must be matching (B, bins, T+2h) planes, got "
                         f"{tuple(xr0.shape)} and {tuple(xi0.shape)}")
    B, n_bins, n_padded = xr0.shape
    if n_hop < 2 or n_padded != n_frames + 2 * n_hop:
        raise ValueError(f"planes of {n_padded} frames do not hold n_frames={n_frames} "
                         f"with n_hop={n_hop} (>= 2) context frames per side")
    if n_frames < 1:
        raise ValueError(f"n_frames must be >= 1, got {n_frames}")
    if xr0.dtype != torch.float32 or xi0.dtype != torch.float32 or xr0.device != xi0.device:
        raise TypeError("xr0/xi0 must be float32 tensors on one device")
    if state0 is not None:
        floor0, countdown0 = state0
        if (floor0.shape != (B, n_bins) or countdown0.shape != (B, n_bins)
                or floor0.dtype != torch.float32 or countdown0.dtype != torch.int32
                or floor0.device != xr0.device or countdown0.device != xr0.device):
            raise ValueError("state0 must be (floor f32, countdown int32), each "
                             f"{(B, n_bins)} on {xr0.device}")
    if restart is not None:
        if state0 is None or collect_states:
            raise ValueError("restart goes with state0, and not with collect_states")
        if restart.shape != (B,) or restart.dtype != torch.bool or restart.device != xr0.device:
            raise ValueError(f"restart must be a ({B},) bool tensor on {xr0.device}")
    if xr0.device.type == "cpu":
        return noise_floor_mask_plain(xr0, xi0, n_hop=n_hop, n_frames=n_frames,
                                      snr_ratio=snr_ratio, state0=state0, restart=restart,
                                      collect_states=collect_states)
    if xr0.device.type != "cuda":
        raise ValueError(f"noise_floor_mask runs on cuda or cpu tensors, not {xr0.device}")
    if not (xr0.is_contiguous() and xi0.is_contiguous()
            and (state0 is None or all(s.is_contiguous() for s in state0))
            and (restart is None or restart.is_contiguous())):
        raise ValueError("noise_floor_mask needs contiguous planes and state")
    lib = load_library()
    dev = xr0.device
    mask = torch.empty((B, n_bins, n_frames), dtype=torch.bool, device=dev)
    floor = torch.empty((B, n_bins), dtype=torch.float32, device=dev)
    countdown = torch.empty((B, n_bins), dtype=torch.int32, device=dev)
    f0, c0 = (None, None) if state0 is None else (state0[0].data_ptr(), state0[1].data_ptr())
    consts = (float(snr_ratio), FLOOR_UP, FLOOR_UP_SLOW, FLOOR_DOWN)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        if collect_states:
            floors = torch.empty((B, n_frames, n_bins), dtype=torch.float32, device=dev)
            countdowns = torch.empty((B, n_frames, n_bins), dtype=torch.int32, device=dev)
            err = lib.noise_floor_states_launch(
                xr0.data_ptr(), xi0.data_ptr(), f0, c0, mask.data_ptr(), floor.data_ptr(),
                countdown.data_ptr(), floors.data_ptr(), countdowns.data_ptr(), B * n_bins,
                n_frames, n_bins, n_hop, *consts, stream)
        else:
            err = lib.noise_floor_launch(
                xr0.data_ptr(), xi0.data_ptr(), f0, c0,
                None if restart is None else restart.data_ptr(), mask.data_ptr(),
                floor.data_ptr(), countdown.data_ptr(), B * n_bins, n_frames, n_bins, n_hop,
                *consts, stream)
    check_launch("noise_floor_mask", err)
    noise_floor_mask.launches += 1
    if collect_states:
        noise_floor_mask.collect_launches += 1
        return mask, (floor, countdown), (floors, countdowns)
    return mask, (floor, countdown)


noise_floor_mask.launches = 0  # every K2 launch
noise_floor_mask.collect_launches = 0  # those of them with collect_states


# ---------------------------------------------------------------------------
# Full SALSA feature
# ---------------------------------------------------------------------------

def windowed_covariance(Xpad: torch.Tensor, n_hopframes: int, n_frames: int) -> torch.Tensor:
    """Sliding (2 n_hopframes + 1)-frame covariance of complex Xpad (..., bins,
    n_frames + 2h, C): (..., bins, n_frames, C, C) with R[i, j] = mean_t X[t, i]
    conj(X[t, j]) over the window, the frames summed in order."""
    win = 2 * n_hopframes + 1
    acc = None
    for k in range(win):
        seg = Xpad[..., k:k + n_frames, :]
        outer = seg[..., :, None] * seg[..., None, :].conj()
        acc = outer if acc is None else acc + outer
    return acc / win


def principal_eigs_eigh(R: torch.Tensor):
    """Exact batched Hermitian eigendecomposition of R (..., C, C): the top two
    eigenvalues and the principal eigenvector, (lam0, lam1, v0)."""
    w, v = torch.linalg.eigh(R)  # ascending
    return w[..., -1], w[..., -2], v[..., :, -1]


def principal_eigs_power(R: torch.Tensor, n_iters: int = 20):
    """Top two eigenpairs of R (..., C, C) by repeated squaring, as
    `salsa_tpu.features.salsa.principal_eigs_power`: R / tr(R) squared
    clip(ceil(log2(n_iters)) - 1, 2, 4) times with a trace renormalisation each
    time, v = P s0 normalised and refined once with P, lam0 its Rayleigh quotient
    with R; then 3 un-squared steps of R / tr(R) from s1, orthogonalised against v
    each step, for lam1. Returns (lam0, lam1, v). The start vectors are
    `salsa_tpu`'s for C channels (`salsa_spatial.start_vectors`, any C >= 2).
    The squarings and the matrix-vector products are batched matmuls:
    `salsa_tpu`'s broadcast multiply-sums would hold C^3 (C^2) complex products a
    cell (103 GB (3.3 GB) for a 60 s clip at C = 32).
    """
    s0_np, s1_np = start_vectors(R.shape[-1])
    n_sq = int(np.clip(np.ceil(np.log2(max(n_iters, 2))) - 1, 2, 4))

    def matvec(A, b):
        return (A @ b[..., None])[..., 0]

    def trace(A):
        return torch.diagonal(A, dim1=-2, dim2=-1).sum(-1).real

    def unit(x):
        return x / (torch.linalg.vector_norm(x, dim=-1, keepdim=True) + 1e-30)

    def rayleigh(A, w):
        return torch.sum(w.conj() * matvec(A, w), dim=-1).real

    def orth(u, v):
        return u - torch.sum(v.conj() * u, dim=-1, keepdim=True) * v

    Rn = R / (trace(R)[..., None, None] + 1e-30).to(R.dtype)
    P = Rn
    for _ in range(n_sq):
        P = P @ P
        P = P / (trace(P)[..., None, None] + 1e-30).to(R.dtype)
    s0 = torch.from_numpy(s0_np).to(R.device)
    s1 = torch.from_numpy(s1_np).to(R.device)
    v = unit(matvec(P, s0.expand(P.shape[:-1])))
    v = unit(matvec(P, v))
    lam0 = rayleigh(R, v)
    u = orth(s1.expand(v.shape), v)
    for _ in range(3):
        u = unit(orth(matvec(Rn, u), v))
    return lam0, rayleigh(R, u), v


def eig_features_from_padded(Xpad: torch.Tensor, sig_mask: torch.Tensor,
                             params: SalsaParams) -> torch.Tensor:
    """`salsa_tpu`'s XLA spatial branch: masked principal-eigenvector features,
    (B, C-1, bins, T), from the complex band Xpad (B, bins, T + 2h, C) carrying
    its covariance context and the tracker mask (B, bins, T). eig_method 'eigh'
    solves exactly, anything else by `principal_eigs_power`. With tracking a
    cell is valid where the mask and the coherence test (lam0 > cond * lam1) hold;
    without, every cell of `sig_mask` (all ones) is."""
    p = params
    n_bins, n_frames = Xpad.shape[-3], Xpad.shape[-2] - 2 * p.n_hopframes
    R = windowed_covariance(Xpad, p.n_hopframes, n_frames)
    if p.eig_method == "eigh":
        lam0, lam1, v = principal_eigs_eigh(R)
    else:
        lam0, lam1, v = principal_eigs_power(R)
    valid = sig_mask & (lam0 > lam1 * p.condition_number) if p.is_tracking else sig_mask
    if p.audio_format == "foa":
        ratio = (v[..., 1:] / v[..., 0:1]).real
        norm = torch.sqrt(torch.sum(ratio * ratio, dim=-1, keepdim=True))
        feat = ratio / torch.clamp(norm, min=1e-30)
    elif p.audio_format == "mic":
        phase = torch.angle(v[..., 1:] * v[..., 0:1].conj())
        bins = np.arange(p.lower_bin, p.lower_bin + n_bins, dtype=np.float32)
        scale = torch.from_numpy(bins).to(phase.device) * np.float32(mic_delta(p.fs, p.n_fft))
        feat = phase / scale[:, None, None]
    else:
        raise ValueError(f"unknown audio format '{p.audio_format}'")
    feat = torch.where(valid[..., None], feat, torch.zeros((), device=feat.device))
    feat = torch.nan_to_num(feat, nan=0.0, posinf=0.0, neginf=0.0)
    return feat.movedim(-1, -3)


def eig_features_from_planes(xr: torch.Tensor, xi: torch.Tensor, sig_mask: torch.Tensor,
                             params: SalsaParams) -> torch.Tensor:
    """Masked principal-eigenvector features, (B, C-1, bins, T), from (B, C, bins,
    T + 2h) re/im planes carrying their covariance context: K1 where
    `params.uses_k1` and C = 4, else `eig_features_from_padded` (K1 is a 4-channel
    kernel: other channel counts take the power iteration, as `salsa_tpu` routes
    them off its Pallas kernel)."""
    p = params
    if p.uses_k1 and xr.shape[1] == 4:
        return salsa_spatial(
            xr, xi, sig_mask, n_hop=p.n_hopframes, audio_format=p.audio_format,
            condition_number=p.condition_number, lower_bin=p.lower_bin, fs=p.fs,
            n_fft=p.n_fft)
    return eig_features_from_padded(torch.complex(xr, xi).permute(0, 2, 3, 1), sig_mask, p)


def tracker_mask(xr: torch.Tensor, xi: torch.Tensor, n_frames: int, params: SalsaParams,
                 state0=None, restart=None):
    """The validity mask from the tracker and the tracker state after the last
    frame: K2 on channel 0 of the band planes (B, C, bins, T + 2h) with tracking;
    without, all ones and `state0` passed through, and no K2 launch."""
    if not params.is_tracking:
        return torch.ones((xr.shape[0], xr.shape[2], n_frames), dtype=torch.bool,
                          device=xr.device), state0
    return noise_floor_mask(xr[:, 0].contiguous(), xi[:, 0].contiguous(),
                            n_hop=params.n_hopframes, n_frames=n_frames, state0=state0,
                            restart=restart)


def band_planes(re: torch.Tensor, im: torch.Tensor, params: SalsaParams):
    """STFT planes (B, C, T, bins) -> the DOA band as contiguous (B, C, bins_band,
    T + 2h) planes, wrap-padded by h frames per side: the covariance context wraps
    from the clip's end and start."""
    p, h = params, params.n_hopframes

    def band(x):
        x = x[..., p.lower_bin:p.upper_bin].transpose(-1, -2)
        return torch.cat([x[..., -h:], x, x[..., :h]], dim=-1).contiguous()

    return band(re), band(im)


@functools.lru_cache(maxsize=8)
def _compression_matrix(n_fft: int, compress: bool, device: torch.device) -> torch.Tensor:
    """`high_freq_compression_matrix` as a float32 tensor on `device`, made once per
    (n_fft, compress, device)."""
    return torch.from_numpy(high_freq_compression_matrix(n_fft, compress)).to(device)


def extract_salsa(waves: torch.Tensor, params: SalsaParams) -> torch.Tensor:
    """(B, C, n_samples) -> (B, 2C - 1, n_frames, freq_dim) SALSA feature, 7
    channels at C = 4.

    Channels 0 to C-1: log-linear compressed spectrograms; channels C to 2C-2:
    normalized principal eigenvectors (zero-padded above upper_bin). K1 computes
    the eigenvectors at C = 4, the power iteration at any other C >= 2; K2
    tracks channel 0 at any C.
    """
    p = params
    if waves.dim() != 3:
        raise ValueError(f"waves must be (B, n_channels, n_samples), got {tuple(waves.shape)}")
    re, im = stft_planes(waves, n_fft=p.n_fft, hop_length=p.hop_length,
                         win_length=p.win_length)  # (B, 4, T, bins) each
    W = _compression_matrix(p.n_fft, p.compress_high_freq, waves.device)
    power = re * re + im * im
    log_spec = power_to_db(power @ W.T)

    n_t = re.shape[-2]
    xr_pad, xi_pad = band_planes(re, im, p)
    sig_mask, _ = tracker_mask(xr_pad, xi_pad, n_t, p)
    eig = eig_features_from_planes(xr_pad, xi_pad, sig_mask, p).transpose(-1, -2)
    eig_full = F.pad(eig, (0, p.freq_dim - (p.upper_bin - p.lower_bin)))
    return torch.cat([log_spec, eig_full], dim=1)
