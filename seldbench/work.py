"""The yardstick's arithmetic: the table of the card's peaks, the CRNN's operations
counted from its shapes, and the work and bytes of the two SALSA kernels.

The CRNN's count is the model's arithmetic whatever kernels run it: every
convolution (2 Cin Cout k^2 a output cell), each GRU step's gates (2 x 3H x (In +
H) a direction) and the head linears; BatchNorm, pooling and activations are left
out. At one 8 s chunk of 7 x 640 x 200 it is 44.97 GFLOP (convolutions 44.74,
BiGRU 0.19, linears 0.04).

K1 (the SALSA spatial stage) does 2,112 fp32 operations a (clip, bin, frame) cell
on FOA and 2,110 on MIC, counted from its definition on the Hermitian-real form
(covariance 448, trace normalisation 21, 3 squarings 561, principal pair 338,
runner-up 715, the test and the features 29); it reads its re/im planes and mask
once and writes 3 feature planes. K2 (the noise-floor tracker) does 12 a cell and
reads channel 0's planes once, writing a byte mask and its final state. A kernel's
least time is the larger of its operations over the fp32 peak and its bytes over
the memory rate.
"""
from __future__ import annotations

# NVIDIA H100 SXM, the data sheet's dense rates at the 700 W power limit
PEAKS = {
    "fp32_flops": 67e12,     # outside the tensor cores
    "tf32_flops": 495e12,
    "bf16_flops": 989e12,
    "hbm_bytes": 3.35e12,    # bytes a second
    "pcie_bytes": 64e9,      # PCIe 5.0 x16, one direction
}

K1_OPS_PER_CELL = {"foa": 2112, "mic": 2110}
K2_OPS_PER_CELL = 12
N_HOP = 3  # the tracker's and the covariance's context frames a side
STAGES = ((64, 1), (128, 2), (256, 2), (512, 2))  # (width, stride) of ResNet22's stages


def conv_flops(c_in: int, c_out: int, k: int, cells: int) -> float:
    return 2.0 * c_in * c_out * k * k * cells


def crnn_flops(batch: int, frames: int, freqs: int, n_in: int = 7, gru_hidden: int = 256,
               n_classes: int = 12) -> dict[str, float]:
    """Operations of one eval forward pass of the SALSA CRNN on (batch, n_in,
    frames, freqs), by part: conv, gru, linear, and their total."""
    t, f = frames, freqs
    conv = conv_flops(n_in, 64, 3, t * f) + conv_flops(64, 64, 3, t * f)
    t, f, width = t // 2, f // 2, 64
    for out, stride in STAGES:
        if stride == 2:
            t, f = t // 2, f // 2
        conv += conv_flops(width, out, 3, t * f) + 3 * conv_flops(out, out, 3, t * f)
        if stride != 1 or width != out:
            conv += conv_flops(width, out, 1, t * f)
        width = out
    steps = frames // 16
    gru = 2 * 2 * 2.0 * 3 * gru_hidden * (width + gru_hidden) * steps
    fc = 2 * gru_hidden
    linear = 4 * (2.0 * fc * (fc // 2)) * steps + 2.0 * (fc // 2) * n_classes * steps * 4
    parts = {"conv": conv * batch, "gru": gru * batch, "linear": linear * batch}
    parts["total"] = sum(parts.values())
    return parts


def least_ms(n_bytes: float, n_ops: float) -> tuple[float, str]:
    """The least time the card could take, in ms, and the bound that sets it."""
    t_bytes = n_bytes / PEAKS["hbm_bytes"] * 1e3
    t_ops = n_ops / PEAKS["fp32_flops"] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def k1_least_ms(clips: int, bins: int, frames: int, audio_format: str) -> tuple[float, str]:
    """K1 on planes (clips, 4, bins, frames + 2 N_HOP)."""
    cells = clips * bins * frames
    n_bytes = 2 * clips * 4 * bins * (frames + 2 * N_HOP) * 4 + cells + 3 * cells * 4
    return least_ms(n_bytes, cells * K1_OPS_PER_CELL[audio_format])


def k2_least_ms(clips: int, bins: int, frames: int) -> tuple[float, str]:
    """K2 on channel-0 planes (clips, bins, frames + 2 N_HOP), no per-frame states."""
    rows, cells = clips * bins, clips * bins * frames
    n_bytes = 2 * rows * (frames + 2 * N_HOP) * 4 + cells + rows * 8
    return least_ms(n_bytes, cells * K2_OPS_PER_CELL)


MFU_NOTE = "CRNN operations from shapes over the host clock and the fp32 peak 67e12 FLOP/s (H100 SXM)"


def mfu_percent(run) -> float | None:
    """The share of the fp32 peak, %: the CRNN operations of the timed calls over
    their seconds on the host clock, taken over the traced run's untraced rest of
    the window, where the profiler neither slows the host nor is read; None where
    that rest made no call."""
    flops = sum(u["flops"] for u in run.rest_units)
    return 100.0 * flops / run.rest_s / run.peaks["fp32_flops"] if flops else None
