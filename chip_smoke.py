#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (`salsa_tpu_torch`) once through its serving path
on one NVIDIA GPU and check every kernel on the way.

    python3 chip_smoke.py

Phases, each printing what it found; any failure raises and exits non-zero:
  0. require CUDA; print the card (nvidia-smi) and switch TF32 off;
  1. build the CUDA kernels (K1 spatial stage, K2 noise-floor tracker, K3, K4)
     with nvcc, one process per source; check ptxas registers and spills (K1 and
     K2 no spills), print K1's SASS instruction mix, and check that K4's bf16
     kernels run on the tensor cores (HMMA in their SASS);
  2. K1 against its plain PyTorch version at the serving shapes, a ragged shape
     and all-zero input; K2 bit-equal to its plain version at the serving shape,
     at (64, 191, 4807), at 33 rows for clips of 1-5 frames and around its frame
     tile, resumed off a tile boundary, resumed for 3 frames, and on all-zero
     planes;
  3. CUDA SALSA extraction against the committed reference golden;
  4. the full-width SALSA-FOA CRNN (configs/seld.yml) answering three requests
     through SeldInferencePipeline, with launch counts, batch-vs-solo and
     GPU-vs-CPU checks and DCASE CSVs written and read back;
  5. times (CUDA-synchronized medians) of a request and of each kernel against
     its plain version, kernels 10 calls back to back, K2 also at (64, 191,
     4807), and K1's issue-slot floor from its SASS count and the SM clock;
  6. K3, the SALSA-kernel ablation variants, against their plain versions at the
     serving shape, a ragged shape and all-zero input, `full` bit-equal to K1,
     then the probe `salsa_tpu_torch.scripts.probe_salsa_kernel` at B=32;
  7. K4, the 3x3 conv with 64 outputs, against its plain version in bf16 and f32
     at the stage-1 shape and two ragged shapes (7 and 80 channels), each at
     every rows-per-block, then the probe
     `salsa_tpu_torch.scripts.probe_pallas_conv` at B=32.
The second-to-last line is a JSON summary of the kernels, each with its time,
its plain version's, its bound (the larger of its bytes over the memory rate and
its operations over the peak rate of their type) and, where one PyTorch call
computes the same function, that call's time; the last line is
{"ok": true, "device": {...}}. Weights are random, from a fixed seed.
"""
from __future__ import annotations

import copy
import csv
import json
import os
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

from salsa_tpu_torch import configs
from salsa_tpu_torch.dsp.stft import stft_planes
from salsa_tpu_torch.features.registry import make_extractor
from salsa_tpu_torch.features.salsa import (
    SalsaParams,
    band_planes,
    noise_floor_mask,
    noise_floor_mask_plain,
)
from salsa_tpu_torch.features.salsa_spatial import (
    mic_delta,
    salsa_spatial,
    salsa_spatial_plain,
)
from salsa_tpu_torch.kernels.build import (
    build_library,
    library_sass,
    load_library,
    ptxas_usage,
    sass_opcode_counts,
)
from salsa_tpu_torch.models.seld import build_model, init_random_
from salsa_tpu_torch.pipeline import SeldInferencePipeline
from salsa_tpu_torch.scripts import probe_pallas_conv, probe_salsa_kernel
from salsa_tpu_torch.scripts.probe_pallas_conv import conv3x3_64, conv3x3_64_plain, rel_err
from salsa_tpu_torch.scripts.probe_salsa_kernel import (
    VARIANTS,
    check_variant,
    salsa_spatial_variant,
    salsa_spatial_variant_plain,
)
from salsa_tpu_torch.scripts.timing import cuda_ms, smi
from salsa_tpu_torch.submission import write_classwise_csv

REPO = os.path.dirname(os.path.abspath(__file__))
GOLDEN = os.path.join(REPO, "tests", "golden", "reference_features.npz")
SEED = 20261016
D = configs.DATA
FS, N_FFT, HOP = D["fs"], D["n_fft"], D["hop_len"]
N_CLASSES = D["n_classes"]
INTERP = 16 * D["label_rate"] / (FS / HOP)  # encoder rate -> label rate: 2.0
FOA = SalsaParams(fs=FS, n_fft=N_FFT, hop_length=HOP, fmax_doa=9000.0, audio_format="foa")
MIC = SalsaParams(fs=FS, n_fft=N_FFT, hop_length=HOP, fmax_doa=4000.0, audio_format="mic")
CARD = ""  # nvidia-smi name and power limit, set in phase 0
CALLS = 10  # kernel calls back to back between the events of one timing

# NVIDIA H100 SXM published peaks (dense): device memory, fp32 outside the tensor
# cores, bf16 on the tensor cores
HBM_BYTES_PER_S = 3.35e12
FP32_FLOPS = 67e12
BF16_FLOPS = 989e12
# K1 (and K3 `full`, n_sq 3) fp32 operations per (clip, bin, frame) cell, counted
# from csrc/salsa_spatial.cu and csrc/hermitian4.cuh, each +, -, *, /, rcp, rsqrt
# and atan2 one operation (an FFMA two), on the Hermitian-real form (a real
# diagonal and 6 complex upper entries):
# - covariance 448: frame 0 48 (4 x |x_i|^2 3, 6 x x_i conj(x_j) 6), 6 more
#   frames 64 each (4 x 4, 6 x 8), the 1/win scale 16;
# - trace normalisation 21: trace 3, guard 1, reciprocal 1, scale 16;
# - 3 squarings, 187 each, 561: diagonal 4 x 13 (h_ii^2, 3 x |h_ik|^2 with its
#   sums), upper 6 x 19 ((h_ii + h_jj) h_ij 3, two complex multiply-adds 8 each),
#   then the trace renormalisation 21;
# - principal pair 258 + 80: two matvecs 104 each (4 rows x (2 + 3 x 8)) and
#   normalisations 25 each; the Rayleigh quotient 80 (diagonal 19, 6 cross terms
#   59, 2 x and + 2);
# - runner-up 715: orth 62, 3 x (matvec 104 + orth 62 + normalise 25), Rayleigh
#   quotient 80;
# - the coherence test's product 1, then FOA directions 28 or MIC phases 26.
# Before the Hermitian-real form (complex pairs for every entry) it was 2,833.
# The work does not depend on the data: every cell runs all of it.
K1_FLOPS_PER_CELL = {"foa": 2112, "mic": 2110}
# K2 per cell: power 3, the 3-frame sum 2, divide and root 2, the step's compare,
# product, max, threshold product and compare 5
K2_FLOPS_PER_CELL = 12


# integer and address arithmetic in SASS
INT_OPS = {"IMAD", "IADD3", "LEA", "SHF", "LOP3", "ISETP", "IMNMX", "IABS", "SEL", "I2F",
           "F2I", "IMUL", "PRMT"}


def sass_mix(opcodes) -> dict[str, int]:
    """An instruction mix: fp32 FFMA/FMUL/FADD, MUFU, global loads and stores,
    integer, everything else, and the total."""
    mix = {k: opcodes.get(k, 0) for k in ("FFMA", "FMUL", "FADD", "MUFU", "LDG", "STG")}
    mix["integer"] = sum(v for k, v in opcodes.items() if k in INT_OPS)
    mix["other"] = sum(opcodes.values()) - sum(mix.values())
    mix["total"] = sum(opcodes.values())
    return mix


def log(phase: str, msg: str) -> None:
    print(f"[{phase}] {msg}", flush=True)


def foa_clips(rng: np.random.Generator, n_clips: int, seconds: float) -> np.ndarray:
    """(n_clips, 4, n) float32: diffuse noise plus one directional source per clip
    (broadband noise burst and a tone, first-order ambisonic gains)."""
    n = int(round(seconds * FS))
    t = np.arange(n) / FS
    out = 0.02 * rng.standard_normal((n_clips, 4, n))
    for b in range(n_clips):
        azi, ele = rng.uniform(-np.pi, np.pi), rng.uniform(-0.6, 0.6)
        gains = np.array([1.0, np.sin(azi) * np.cos(ele), np.sin(ele), np.cos(azi) * np.cos(ele)])
        on = (t % 10.0) < rng.uniform(3.0, 7.0)
        src = (0.2 * rng.standard_normal(n) + np.sin(2 * np.pi * rng.uniform(300, 3000) * t)) * on
        out[b] += gains[:, None] * src[None]
    return out.astype(np.float32)


def stft_band(waves: torch.Tensor, p: SalsaParams):
    """STFT -> wrap-padded DOA-band planes (B, 4, bins, T + 2h), as extract_salsa."""
    return band_planes(*stft_planes(waves, n_fft=p.n_fft, hop_length=p.hop_length), p)


def spatial_kw(p: SalsaParams) -> dict:
    return dict(n_hop=p.n_hopframes, audio_format=p.audio_format,
                condition_number=p.condition_number, lower_bin=p.lower_bin, fs=p.fs,
                n_fft=p.n_fft)


def roofline(n_bytes: float, n_ops: float, peak_ops: float) -> tuple[float, str]:
    """The least time the card could take, in ms, and what sets it: the bytes
    moved over the memory rate or the operations over their peak rate."""
    t_bytes, t_ops = n_bytes / HBM_BYTES_PER_S * 1e3, n_ops / peak_ops * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def k1_bound(shape, fmt: str = "foa") -> tuple[float, str]:
    """K1's bound on planes (B, 4, bins, T + 2h): read re/im once and the mask,
    write 3 feature planes."""
    B, C, n_bins, n_padded = shape
    cells = B * n_bins * (n_padded - 2 * FOA.n_hopframes)
    n_bytes = 2 * B * C * n_bins * n_padded * 4 + cells + 3 * cells * 4
    return roofline(n_bytes, cells * K1_FLOPS_PER_CELL[fmt], FP32_FLOPS)


def k2_bound(shape) -> tuple[float, str]:
    """K2's bound on channel-0 planes (B, bins, T + 2h): read re/im once, write the
    byte mask and the final state."""
    B, n_bins, n_padded = shape
    rows, cells = B * n_bins, B * n_bins * (n_padded - 2 * FOA.n_hopframes)
    return roofline(2 * rows * n_padded * 4 + cells + rows * 8, cells * K2_FLOPS_PER_CELL,
                    FP32_FLOPS)


def k2_chain_floor_ms(n_frames: int, clk_per_step: float, sm_hz: float = 1.98e9) -> float:
    """The recurrence's own floor: n_frames dependent steps of clk_per_step each."""
    return n_frames * clk_per_step / sm_hz * 1e3


def normal_planes(rng: np.random.Generator, shape, dev) -> tuple[torch.Tensor, torch.Tensor]:
    """Seeded standard-normal re/im planes, float32, on `dev`."""
    return tuple(torch.from_numpy(rng.standard_normal(shape, dtype=np.float32)).to(dev)
                 for _ in range(2))


def check_k2(xr0, xi0, n_frames: int, what: str, state0=None):
    """K2 against its plain version on CPU copies (the kernel is bit-exact IEEE):
    mask, floor and countdown must be equal. Returns the plain (mask, state)."""
    mask, (floor, cd) = noise_floor_mask(xr0, xi0, n_hop=3, n_frames=n_frames, state0=state0)
    cpu_state = None if state0 is None else tuple(s.cpu() for s in state0)
    p_mask, (p_floor, p_cd) = noise_floor_mask_plain(xr0.cpu(), xi0.cpu(), n_hop=3,
                                                     n_frames=n_frames, state0=cpu_state)
    if not (torch.equal(mask.cpu(), p_mask) and torch.equal(floor.cpu(), p_floor)
            and torch.equal(cd.cpu(), p_cd)):
        raise AssertionError(
            f"K2 {what} {tuple(xr0.shape)}: not bit-equal to the plain tracker (mask "
            f"mismatches {int((mask.cpu() != p_mask).sum())}, floor max diff "
            f"{float((floor.cpu() - p_floor).abs().max()):.3e}, countdown mismatches "
            f"{int((cd.cpu() != p_cd).sum())})")
    return p_mask, (p_floor, p_cd)


def mic_period(p: SalsaParams, n_bins: int) -> np.ndarray:
    """The period of a MIC feature, a phase over delta * absolute bin, in each bin:
    2 pi / (delta * bin). Values a period apart are one direction."""
    return 2 * np.pi / (mic_delta(p.fs, p.n_fft) * np.arange(p.lower_bin, p.lower_bin + n_bins))


def compare_spatial(got: torch.Tensor, want: torch.Tensor, what: str, phase: str = "2",
                    period: np.ndarray | None = None) -> float:
    """K1's bound (tests/test_salsa_pallas.py): validity masks disagree on < 0.5%
    of cells; features within atol/rtol 5e-3 where both are valid. With `period`
    (per bin) the features are MIC phases and each difference is taken on the
    circle: a phase at the branch cut, whose sine the two versions round to
    opposite signs, reads +pi in one and -pi in the other. Returns the max abs
    error over those cells."""
    got, want = got.cpu().numpy(), want.cpu().numpy()
    if got.shape != want.shape or not np.isfinite(got).all():
        raise AssertionError(f"{what}: shape {got.shape} vs {want.shape} or non-finite")
    m_got, m_want = np.any(got != 0, axis=1), np.any(want != 0, axis=1)
    disagree = float(np.mean(m_got != m_want))
    both = m_got & m_want
    g, w = np.moveaxis(got, 1, -1)[both], np.moveaxis(want, 1, -1)[both]
    if period is not None:
        per = np.broadcast_to(period[None, :, None], both.shape)[both][:, None]
        turns = np.round((g - w) / per)
        log(phase, f"{what}: {int(np.count_nonzero(turns))} phases a period apart (the "
                   "branch cut), compared on the circle")
        g = g - (turns * per).astype(g.dtype)
    err = float(np.abs(g - w).max()) if both.any() else 0.0
    log(phase, f"{what}: valid {m_want.mean():.4%}, mask disagreement {disagree:.4%}, "
             f"max abs err {err:.3e} on {int(both.sum())} cells")
    if disagree >= 0.005:
        raise AssertionError(f"{what}: validity masks disagree on {disagree:.3%}")
    np.testing.assert_allclose(g, w, atol=5e-3, rtol=5e-3, err_msg=what)
    return err


# ---------------------------------------------------------------------------

def phase0() -> str:
    global CARD
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is False; this script "
                         "needs an NVIDIA GPU and prints no result without one")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True, timeout=60).stdout.strip().splitlines()
    CARD = smi[0].strip()
    print(CARD, flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log("0", f"torch {torch.__version__} cuda {torch.version.cuda} device "
             f"{torch.cuda.get_device_name(0)} count {torch.cuda.device_count()}; "
             f"matmul.allow_tf32={torch.backends.cuda.matmul.allow_tf32} "
             f"cudnn.allow_tf32={torch.backends.cudnn.allow_tf32}")
    return CARD


def phase1() -> dict[str, dict[str, int]]:
    """Build and inspect the kernels; returns K1's SASS instruction mixes."""
    path, seconds = build_library()
    load_library()
    log("1", f"built {os.path.relpath(path, REPO)} in {seconds:.1f} s (0.0 = reused)")
    usage = ptxas_usage(path.with_suffix(".log").read_text())
    for name, (regs, st, ld) in sorted(usage.items()):
        log("1", f"ptxas: {regs:3d} registers, spill stores {st} B, loads {ld} B: {name}")
    k1 = [(name, u) for name, u in usage.items() if "20salsa_spatial_kernel" in name]
    if len(k1) != 1 or k1[0][1][1:] != (0, 0):
        raise AssertionError(f"K1 salsa_spatial_kernel: ptxas (registers, spill stores, spill "
                             f"loads) {k1}, expected one kernel without spills")
    log("1", f"K1 salsa_spatial_kernel: {k1[0][1][0]} registers, no spills")
    k2 = [(name, u) for name, u in usage.items() if "noise_floor_kernel" in name]
    if len(k2) != 1 or k2[0][1][1:] != (0, 0):
        raise AssertionError(f"K2 noise_floor_kernel: ptxas (registers, spill stores, spill "
                             f"loads) {k2}, expected one kernel without spills")
    log("1", f"K2 noise_floor_kernel: {k2[0][1][0]} registers, no spills, tile of "
             f"{load_library().noise_floor_tile_frames()} frames")

    ops = sass_opcode_counts(library_sass(path))
    # K1's machine code: every cell runs one straight-line path, FOA or MIC, so the
    # static counts bound what a thread issues; K3 `full` at n_sq 3 is K1's FOA
    # path alone (the same herm4::solve_cell), without the MIC branch
    mixes = {}
    for what, key in (("K1", "20salsa_spatial_kernel"),
                      ("K3 full n_sq 3", "salsa_spatial_probe_kernelILi0ELi3E")):
        name = [n for n in ops if key in n]
        if len(name) != 1:
            raise AssertionError(f"{what}: {len(name)} functions in the SASS match {key}")
        mixes[what] = sass_mix(ops[name[0]])
        log("1", f"SASS of {what}: " + ", ".join(f"{k} {v}" for k, v in mixes[what].items()))

    # K4: the bf16 kernels run on the tensor cores (HMMA in their machine code) and
    # do not spill; the f32 kernels stay on the CUDA cores (no HMMA)
    for kind, want_mma in (("conv3x3_64_mma_kernel", True), ("conv3x3_64_f32_kernel", False)):
        names = sorted(name for name in ops if kind in name)
        if len(names) != len(probe_pallas_conv.ROWS):
            raise AssertionError(f"K4 {kind}: {len(names)} instantiations in the SASS, expected "
                                 f"{len(probe_pallas_conv.ROWS)} (rows per block "
                                 f"{probe_pallas_conv.ROWS})")
        for name in names:
            hmma = ops[name].get("HMMA", 0)
            regs, st, ld = usage[name]
            log("1", f"SASS: {hmma:4d} HMMA of {sum(ops[name].values())} instructions, "
                     f"{regs} registers, spills {st}/{ld} B: {name}")
            if want_mma and not (hmma > 0 and st == 0 and ld == 0):
                raise AssertionError(f"K4 bf16 {name}: {hmma} HMMA, spill stores {st} B, "
                                     f"loads {ld} B; expected HMMA and no spills")
            if not want_mma and hmma:
                raise AssertionError(f"K4 f32 {name}: {hmma} HMMA, expected none")
    log("1", "K4: bf16 instantiations use the tensor cores (HMMA) without spills; f32 "
             "instantiations use none")
    return mixes


def phase2(dev) -> dict:
    rng = np.random.default_rng(SEED)
    waves = torch.from_numpy(foa_clips(rng, 4, 60.0)).to(dev)
    errs = {}
    # K1 at the main-path shapes: FOA (4, 4, 191, 4807), MIC (4, 4, 84, 4807)
    for p in (FOA, MIC):
        xr, xi = stft_band(waves, p)
        n_t = xr.shape[-1] - 2 * p.n_hopframes
        mask, _ = noise_floor_mask(xr[:, 0].contiguous(), xi[:, 0].contiguous(),
                                   n_hop=p.n_hopframes, n_frames=n_t)
        got = salsa_spatial(xr, xi, mask, **spatial_kw(p))
        torch.cuda.synchronize()
        want = salsa_spatial_plain(xr, xi, mask, **spatial_kw(p))
        period = mic_period(p, xr.shape[2]) if p.audio_format == "mic" else None
        errs[p.audio_format] = compare_spatial(got, want, f"K1 {p.audio_format} "
                                                          f"{tuple(xr.shape)}", period=period)
    # ragged shape and all-zero input
    xr = torch.from_numpy(rng.standard_normal((3, 4, 11, 333 + 6)).astype(np.float32)).to(dev)
    xr += xr[:, :1].clone()  # correlated channels: a coherent share of cells
    xi = torch.from_numpy(rng.standard_normal((3, 4, 11, 339)).astype(np.float32)).to(dev)
    xi += xi[:, :1].clone()
    m = torch.from_numpy(rng.random((3, 11, 333)) < 0.7).to(dev)
    compare_spatial(salsa_spatial(xr, xi, m, **spatial_kw(FOA)),
                    salsa_spatial_plain(xr, xi, m, **spatial_kw(FOA)), "K1 ragged (3,4,11,339)")
    z = torch.zeros(2, 4, 7, 106, device=dev)
    for p in (FOA, MIC):
        out = salsa_spatial(z, z, torch.ones(2, 7, 100, dtype=torch.bool, device=dev),
                            **spatial_kw(p))
        if not (torch.isfinite(out).all() and not out.any()):
            raise AssertionError(f"K1 {p.audio_format} all-zero input: output not all 0")
    log("2", "K1 all-zero input (FOA, MIC): output all 0 and finite")

    # K2 vs the plain tracker, bit-equal, on CPU copies
    xr, xi = stft_band(waves, FOA)
    xr0, xi0 = xr[:, 0].contiguous(), xi[:, 0].contiguous()
    n_t = xr0.shape[-1] - 6
    p_mask, p_state = check_k2(xr0, xi0, n_t, "serving")
    # resume mid-clip, off a tile boundary, from the plain tracker's state there
    tile = load_library().noise_floor_tile_frames()
    cut = n_t // 2
    if cut % tile == 0:
        raise AssertionError(f"resume frame {cut} is on a tile boundary ({tile} frames)")
    _, st = noise_floor_mask_plain(xr0[..., :cut + 6].cpu(), xi0[..., :cut + 6].cpu(),
                                   n_hop=3, n_frames=cut)
    r_mask, r_state = check_k2(xr0[..., cut:].contiguous(), xi0[..., cut:].contiguous(),
                               n_t - cut, f"resumed at frame {cut}",
                               state0=(st[0].to(dev), st[1].to(dev)))
    if not (torch.equal(r_mask, p_mask[..., cut:]) and torch.equal(r_state[0], p_state[0])
            and torch.equal(r_state[1], p_state[1])):
        raise AssertionError("K2 resumed from a mid-clip state differs from the whole clip")
    log("2", f"K2 {tuple(xr0.shape)}: mask ({p_mask.float().mean():.3%} set), floor and "
             f"countdown bit-equal to the plain tracker, also resumed at frame {cut} "
             f"({cut % tile} into a tile of {tile})")
    del xr, xi, xr0, xi0

    # bench.py's batch, seeded normal planes
    big = normal_planes(rng, (64, 191, n_t + 6), dev)
    b_mask, _ = check_k2(*big, n_t, "B=64")
    log("2", f"K2 (64, 191, {n_t + 6}): mask ({b_mask.float().mean():.3%} set), floor and "
             f"countdown bit-equal")
    del big, b_mask
    # 33 rows (one full block and one row) around the frame tile
    # clips of 1-5 frames: the clip-start floor from the first min(5, T) frames
    for t in (1, 2, 3, 4, 5, tile - 1, tile, tile + 1, 2 * tile + 3):
        check_k2(*normal_planes(rng, (3, 11, t + 6), dev), t, f"33 rows T={t}")
    log("2", f"K2 (3, 11, T + 6) for T in 1, 2, 3, 4, 5, {tile - 1}, {tile}, {tile + 1}, "
             f"{2 * tile + 3}: bit-equal")
    # 3 frames from a given state: countdowns on both sides of 0
    st = (torch.from_numpy(rng.uniform(0.5, 1.5, (3, 11)).astype(np.float32)).to(dev),
          torch.from_numpy(rng.integers(-3, 4, (3, 11), dtype=np.int32)).to(dev))
    check_k2(*normal_planes(rng, (3, 11, 3 + 6), dev), 3, "resumed for T=3", state0=st)
    log("2", "K2 (3, 11, 9) resumed for 3 frames from a given state: bit-equal")
    z = torch.zeros(2, 7, 100 + 6, device=dev)
    z_mask, (z_floor, _) = check_k2(z, z, 100, "all-zero")
    if z_mask.any() or not torch.equal(z_floor, torch.full_like(z_floor, 1e-6)):
        raise AssertionError("K2 all-zero planes: mask set or floor not clamped at 1e-6")
    log("2", "K2 all-zero planes: mask all false, floor 1e-6, bit-equal")
    errs["k2"] = 0.0  # every comparison above is exact
    return errs


def phase3(dev) -> None:
    golden = np.load(GOLDEN)
    audio = torch.from_numpy(golden["audio"])[None].to(dev)
    for fmt in ("foa", "mic"):
        ex = make_extractor("salsa", fmt, fs=int(golden["fs"]), n_fft=int(golden["n_fft"]),
                            hop_length=int(golden["hop"]))
        got = ex(audio)[0].cpu().numpy()
        want = golden[f"salsa_{fmt}"]
        if got.shape != want.shape:
            raise AssertionError(f"golden {fmt}: shape {got.shape} vs {want.shape}")
        # tests/test_golden_features.py:57-64
        np.testing.assert_allclose(got[:4], want[:4], atol=2e-2, rtol=1e-3)
        ref_mask, got_mask = np.any(want[4:] != 0, axis=0), np.any(got[4:] != 0, axis=0)
        disagree = float(np.mean(ref_mask != got_mask))
        if disagree >= 0.01:
            raise AssertionError(f"golden {fmt}: masks disagree on {disagree:.3%}")
        both = ref_mask & got_mask
        np.testing.assert_allclose(got[4:][:, both], want[4:][:, both], atol=5e-3, rtol=1e-2)
        log("3", f"golden salsa_{fmt} {got.shape}: spec max err "
                 f"{np.abs(got[:4] - want[:4]).max():.3e} dB, mask disagreement "
                 f"{disagree:.4%}, spatial max err "
                 f"{np.abs(got[4:][:, both] - want[4:][:, both]).max():.3e}")


def build_pipeline(dev):
    model = init_random_(build_model(**configs.SELD_FOA), torch.Generator().manual_seed(SEED))
    rng = np.random.default_rng(SEED + 1)
    scaler = (rng.normal(-5.0, 1.0, (4, 1, 200)).astype(np.float32),
              rng.uniform(5.0, 8.0, (4, 1, 200)).astype(np.float32))
    ex = make_extractor("salsa", D["audio_format"], fs=FS, n_fft=N_FFT, hop_length=HOP)
    return SeldInferencePipeline(ex, model, None, scaler, INTERP, N_CLASSES,
                                 D["output_format"], device=dev)


def check_outputs(ev, doa, n_clips, n_labels, what):
    if ev.shape != (n_clips, n_labels, N_CLASSES) or doa.shape != (n_clips, n_labels,
                                                                    3 * N_CLASSES):
        raise AssertionError(f"{what}: shapes {ev.shape} {doa.shape}")
    if not (np.isfinite(ev).all() and np.isfinite(doa).all()):
        raise AssertionError(f"{what}: non-finite outputs")
    if ev.min() < 0 or ev.max() > 1 or np.abs(doa).max() > 1:
        raise AssertionError(f"{what}: event_prob outside [0,1] or doa outside [-1,1]")


def phase4(dev, pipe, requests) -> dict:
    salsa_spatial.launches = 0
    noise_floor_mask.launches = 0
    outs = [pipe(w) for w in requests]
    torch.cuda.synchronize()
    launches = {"salsa_spatial": salsa_spatial.launches,
                "noise_floor": noise_floor_mask.launches}
    log("4", f"served {len(requests)} requests {[w.shape for w in requests]}; launches "
             f"{launches}")
    if launches != {"salsa_spatial": len(requests), "noise_floor": len(requests)}:
        raise AssertionError(f"expected one K1 and one K2 launch per request, got {launches}")

    for w, (ev, doa) in zip(requests, outs):
        n_labels = int(round(((1 + w.shape[-1] // HOP) // 16) * INTERP))
        check_outputs(ev, doa, w.shape[0], n_labels, f"request {w.shape}")
        for b in range(w.shape[0]):
            ev1, doa1 = pipe(w[b:b + 1])
            d = max(np.abs(ev1[0] - ev[b]).max(), np.abs(doa1[0] - doa[b]).max())
            if d > 1e-4:
                raise AssertionError(f"request {w.shape} clip {b}: solo run differs by {d:.3e}")
        log("4", f"request {w.shape}: outputs {ev.shape} {doa.shape} in range and finite; "
                 f"event_prob mean {ev.mean():.4f}, >=0.3 share {(ev >= 0.3).mean():.4f}; "
                 f"each clip equals its solo run within 1e-4")

    # one 60 s clip through the same port on the CPU (plain versions)
    clip = requests[0][:1]
    cpu_pipe = SeldInferencePipeline(pipe.extractor, copy.deepcopy(pipe.model).cpu(), None,
                                     (pipe.mean.cpu().numpy(), pipe.std.cpu().numpy()),
                                     INTERP, N_CLASSES, D["output_format"], device="cpu")
    t0 = time.perf_counter()
    ev_c, doa_c = cpu_pipe(clip)
    cpu_s = time.perf_counter() - t0
    ev_g, doa_g = outs[0][0][:1], outs[0][1][:1]
    f_g = pipe.extractor(torch.from_numpy(clip).to(dev)).cpu()
    f_c = pipe.extractor(torch.from_numpy(clip))
    mask_dis = float(((f_g[:, 4:] != 0).any(1) != (f_c[:, 4:] != 0).any(1)).float().mean())
    for name, g, c in (("event_prob", ev_g, ev_c), ("doa", doa_g, doa_c)):
        err = np.abs(g - c)
        share = float(np.mean(err <= 2e-3))
        log("4", f"GPU vs CPU {name}: max abs err {err.max():.3e}, share within 2e-3 "
                 f"{share:.5f} (spatial mask disagreement {mask_dis:.4%}; CPU took "
                 f"{cpu_s:.1f} s)")
        if share < 0.999 or err.max() > 2e-2:
            raise AssertionError(f"GPU vs CPU {name}: share {share}, max {err.max()}")

    with tempfile.TemporaryDirectory() as tmp:
        ev, doa = outs[0]
        n_rows = 0
        for b in range(ev.shape[0]):
            path = os.path.join(tmp, f"clip{b}.csv")
            write_classwise_csv(path, ev[b], doa[b], N_CLASSES, max_frames=ev.shape[1])
            with open(path) as f:
                rows = list(csv.reader(f))
            expect = int((ev[b] >= 0.3).sum())
            if len(rows) != expect or any(
                    len(r) != 5 or not 0 <= int(r[0]) < ev.shape[1]
                    or not 0 <= int(r[1]) < N_CLASSES or not -180 <= int(r[3]) < 180
                    or not -90 <= int(r[4]) <= 90 for r in rows):
                raise AssertionError(f"clip{b}.csv: {len(rows)} rows, expected {expect}")
            n_rows += len(rows)
        log("4", f"wrote and read back {ev.shape[0]} DCASE CSVs, {n_rows} event rows")
    return launches


def phase5(dev, pipe, request, sass_mixes) -> dict:
    secs = request.shape[0] * request.shape[-1] / FS

    def host_ms(fn, repeats=7):
        fn()
        times = []
        for _ in range(repeats):
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
        return statistics.median(times)

    req_ms = host_ms(lambda: pipe(request))
    log("5", f"request {request.shape} (4 x 60 s): {req_ms:.2f} ms median of 7, "
             f"{secs / (req_ms / 1e3):.1f}x realtime [{CARD}]")
    waves = torch.from_numpy(request).to(dev)
    with torch.inference_mode():
        feats = pipe._normalize(pipe.extractor(waves))
        ext_ms = cuda_ms(lambda: pipe.extractor(waves))
        model_ms = cuda_ms(lambda: pipe.model(feats))
    log("5", f"  of which SALSA extraction {ext_ms:.2f} ms, CRNN {model_ms:.2f} ms "
             f"(CUDA events, median of 7) [{CARD}]")

    xr, xi = stft_band(waves, FOA)
    n_t = xr.shape[-1] - 6
    xr0, xi0 = xr[:, 0].contiguous(), xi[:, 0].contiguous()
    mask, _ = noise_floor_mask(xr0, xi0, n_hop=3, n_frames=n_t)
    kw = spatial_kw(FOA)
    big = normal_planes(np.random.default_rng(SEED + 4), (64, 191, n_t + 6), dev)
    times = {
        "k1": cuda_ms(lambda: salsa_spatial(xr, xi, mask, **kw), calls=CALLS),
    }
    sm_clock = smi("clocks.sm").splitlines()[0]  # right after K1's run, e.g. "1980 MHz"
    times.update({
        "k1_plain": cuda_ms(lambda: salsa_spatial_plain(xr, xi, mask, **kw)),
        "k2": cuda_ms(lambda: noise_floor_mask(xr0, xi0, n_hop=3, n_frames=n_t),
                      calls=CALLS),
        "k2_b64": cuda_ms(lambda: noise_floor_mask(*big, n_hop=3, n_frames=n_t),
                          calls=CALLS),
        "k2_plain": cuda_ms(lambda: noise_floor_mask_plain(xr0, xi0, n_hop=3, n_frames=n_t),
                            repeats=5, warmup=1),
    })
    times["k1_bound"] = k1_bound(xr.shape)
    times["k2_bound"] = k2_bound(xr0.shape)
    log("5", f"K1 salsa_spatial {tuple(xr.shape)}, {CALLS} calls back to back: kernel "
             f"{times['k1']:.4f} ms, plain {times['k1_plain']:.3f} ms, bound "
             f"{times['k1_bound'][0]:.4f} ms ({times['k1_bound'][1]}; "
             f"{K1_FLOPS_PER_CELL['foa']} fp32 operations a cell), "
             f"{times['k1_bound'][0] / times['k1']:.1%} of it [{CARD}]")
    # issue slots: 132 SMs x 4 schedulers, one warp instruction each a clock
    cells = xr.shape[0] * xr.shape[2] * n_t
    mhz = float(sm_clock.split()[0])
    for what, mix in sass_mixes.items():
        slot_ms = cells / 32 * mix["total"] / (132 * 4 * mhz * 1e6) * 1e3
        log("5", f"K1 issue-slot floor from the SASS of {what} ({mix['total']} instructions "
                 f"a thread, {mix['FFMA'] + mix['FMUL'] + mix['FADD']} fp32) at {sm_clock}: "
                 f"{slot_ms:.4f} ms, {slot_ms / times['k1']:.1%} of the kernel's time")
    chain = "-".join(f"{k2_chain_floor_ms(n_t, clk):.3f}" for clk in (16, 24))
    for key, planes in (("k2", xr0), ("k2_b64", big[0])):
        b_ms, b_by = k2_bound(planes.shape)
        log("5", f"K2 noise_floor {tuple(planes.shape)}, {CALLS} calls back to back: "
                 f"kernel {times[key]:.4f} ms, bound {b_ms:.4f} ms ({b_by}), recurrence "
                 f"floor {chain} ms at 16-24 clk a step [{CARD}]")
    log("5", f"K2 plain {tuple(xr0.shape)}: {times['k2_plain']:.3f} ms [{CARD}]")
    del big

    # where a request's device time goes: kernel and copy activities only (op-level
    # rows repeat the time of the kernels they launch)
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        pipe(request)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3

    def dev_us(e):
        return getattr(e, "self_device_time_total", getattr(e, "self_cuda_time_total", 0))

    events = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA
              and dev_us(e) > 0 and not e.key.startswith("Activity Buffer")]
    busy_ms = sum(dev_us(e) for e in events) / 1e3
    if events:
        log("5", f"profile of one request: device busy {busy_ms:.2f} ms of {wall_ms:.2f} ms "
                 f"wall ({1 - busy_ms / wall_ms:.1%} idle, profiler on) [{CARD}]")
        for e in sorted(events, key=dev_us, reverse=True)[:12]:
            log("5", f"  {dev_us(e) / 1e3:9.3f} ms  x{e.count:<5d} {e.key[:90]}")
    else:
        log("5", "profile of one request: no device time recorded (not measured)")
    return times


def phase6(dev) -> dict:
    """K3 against its plain version; returns errors, times and the probe's launches."""
    rng = np.random.default_rng(SEED)
    waves = torch.from_numpy(foa_clips(rng, 4, 60.0)).to(dev)  # phase 2's clips
    xr, xi = stft_band(waves, FOA)
    n_t = xr.shape[-1] - 2 * FOA.n_hopframes
    mask, _ = noise_floor_mask(xr[:, 0].contiguous(), xi[:, 0].contiguous(),
                               n_hop=FOA.n_hopframes, n_frames=n_t)
    rxr = torch.from_numpy(rng.standard_normal((3, 4, 11, 339)).astype(np.float32)).to(dev)
    rxr += rxr[:, :1].clone()  # correlated channels: a coherent share of cells
    rxi = torch.from_numpy(rng.standard_normal((3, 4, 11, 339)).astype(np.float32)).to(dev)
    rxi += rxi[:, :1].clone()
    rm = torch.from_numpy(rng.random((3, 11, 333)) < 0.7).to(dev)
    z = torch.zeros(2, 4, 7, 106, device=dev)
    zm = torch.ones(2, 7, 100, dtype=torch.bool, device=dev)
    err = 0.0
    for variant, n_sq in [(v, 3) for v in VARIANTS] + [("full", q) for q in (1, 2, 4)]:
        kw = dict(variant=variant, n_sq=n_sq)
        for serving, what, (a, b, m) in ((True, f"{tuple(xr.shape)}", (xr, xi, mask)),
                                         (False, "ragged (3,4,11,339)", (rxr, rxi, rm))):
            got = salsa_spatial_variant(a, b, m, **kw)
            torch.cuda.synchronize()
            e, line = check_variant(got, salsa_spatial_variant_plain(a, b, m, **kw), variant,
                                    f"K3 {variant} n_sq={n_sq} {what}")
            log("6", line)
            err = max(err, e) if serving else err
        out = salsa_spatial_variant(z, z, zm, **kw)
        if not (torch.isfinite(out).all() and not out.any()):
            raise AssertionError(f"K3 {variant} n_sq={n_sq} all-zero input: output not all 0")
    log("6", "K3 all-zero input, every variant and n_sq: output all 0 and finite")

    # both run herm4::solve_cell<3, 3>: K3 `full` is K1's FOA path, bit for bit, at
    # K1's launch shape and every other
    k1 = salsa_spatial(xr, xi, mask, **spatial_kw(FOA))
    for block in probe_salsa_kernel.BLOCKS:
        fam = salsa_spatial_variant(xr, xi, mask, variant="full", n_sq=3, block=block)
        torch.cuda.synchronize()
        if not torch.equal(fam, k1):
            raise AssertionError(f"K3 full ({block} threads) is not bit-equal to K1: max abs "
                                 f"diff {float((fam - k1).abs().max()):.3e}, "
                                 f"{int((fam != k1).sum())} values differ")
    log("6", f"K3 full at {', '.join(map(str, probe_salsa_kernel.BLOCKS))} threads vs "
             "production K1: bit-equal")

    kw = dict(variant="full", n_sq=3)
    times = {"k3": cuda_ms(lambda: salsa_spatial_variant(xr, xi, mask, **kw), calls=CALLS),
             "k3_plain": cuda_ms(lambda: salsa_spatial_variant_plain(xr, xi, mask, **kw))}
    times["k3_bound"] = k1_bound(xr.shape)
    log("6", f"K3 full {tuple(xr.shape)}, {CALLS} calls back to back: kernel "
             f"{times['k3']:.4f} ms, plain {times['k3_plain']:.3f} ms, bound "
             f"{times['k3_bound'][0]:.4f} ms ({times['k3_bound'][1]}) [{CARD}]")
    del waves, xr, xi, mask, fam, k1

    log("6", f"probe_salsa_kernel --batch 32 [{CARD}]")
    salsa_spatial_variant.launches = 0
    probe_salsa_kernel.main(["--batch", "32"])
    torch.cuda.synchronize()
    launches = salsa_spatial_variant.launches
    log("6", f"the probe launched K3 {launches} times")
    if launches == 0:
        raise AssertionError("the K3 probe launched no K3 kernel")
    return {"err": err, "launches": launches, **times}


def phase7(dev) -> dict:
    """K4 against its plain version; returns the error, times and the probe's launches."""
    rng = np.random.default_rng(SEED + 3)

    def normal(shape, scale=1.0):
        return torch.from_numpy(rng.standard_normal(shape).astype(np.float32) * scale).to(dev)

    x, w = normal((32, 320, 100, 64)), normal((3, 3, 64, 64), 0.05)
    # ragged: C = 7 takes the element-load fills, C = 80 the 16-byte fills and a
    # second 64-channel chunk
    ragged = [(normal((3, 13, 37, c)), normal((3, 3, c, 64), s)) for c, s in ((7, 0.3), (80, 0.1))]
    # bf16: the kernel rounds its f32 sum once (<= 2^-8 relative), held against the
    # plain version's f32 sum and against its rounded output, both within 5e-3 of
    # max|plain|. Where the two roundings differ it is by one bf16 step, at most
    # 2^-7 of the value; on these fixed inputs a step in the top binade comes to
    # 4.6e-3 of the max.
    bounds = {torch.bfloat16: 5e-3, torch.float32: 1e-5}
    main_err = None
    for dtype, bound in bounds.items():
        for main_shape, (a, b) in [(True, (x, w))] + [(False, r) for r in ragged]:
            what = f"{'' if main_shape else 'ragged '}{tuple(a.shape)}"
            a, b = a.to(dtype), b.to(dtype)
            want = conv3x3_64_plain(a, b)
            want_f32 = conv3x3_64_plain(a.float(), b.float())
            for rows in probe_pallas_conv.ROWS:
                got = conv3x3_64(a, b, rows_per_block=rows)
                torch.cuda.synchronize()
                err, err_rounded = rel_err(got, want_f32), rel_err(got, want)
                if main_shape and dtype == torch.bfloat16 and rows == 8:
                    main_err = float((got.float() - want.float()).abs().max())
                log("7", f"K4 {what} {dtype} rows {rows}: max|kernel - plain| / max|plain| "
                         f"{err:.3e} against the f32 sum, {err_rounded:.3e} against the plain "
                         f"output in {dtype} (bound {bound:.0e} each)")
                if not (torch.isfinite(got.float()).all() and err <= bound
                        and err_rounded <= bound):
                    raise AssertionError(f"K4 {what} {dtype} rows {rows}: rel err {err}, "
                                         f"{err_rounded} against the rounded plain output")

    # the kernel's time is its time at 8 rows, the wrapper's default
    xb, wb = x.to(torch.bfloat16), w.to(torch.bfloat16)
    kw = dict(repeats=20, warmup=3, calls=probe_pallas_conv.K4_CALLS)
    rows_ms = {rows: cuda_ms(lambda: conv3x3_64(xb, wb, rows_per_block=rows), **kw)
               for rows in probe_pallas_conv.ROWS}
    times = {"k4": rows_ms[8], "k4_plain": cuda_ms(lambda: conv3x3_64_plain(xb, wb), **kw)}
    log("7", f"K4 {tuple(x.shape)} bf16, {kw['calls']} calls back to back: kernel "
             + ", ".join(f"{rows} rows {ms:.3f} ms" for rows, ms in rows_ms.items())
             + f"; plain (f32 cuDNN) {times['k4_plain']:.3f} ms [{CARD}]")
    # bf16 in and out: x and the output once each, the weights once
    B, H, W, C = x.shape
    times["k4_bound"] = roofline(2 * (B * H * W * C + 9 * C * 64 + B * H * W * 64),
                                 2 * B * H * W * 9 * C * 64, BF16_FLOPS)
    log("7", f"K4 bound at {tuple(x.shape)} bf16: {times['k4_bound'][0]:.4f} ms "
             f"({times['k4_bound'][1]})")
    del x, w, xb, wb, ragged

    log("7", f"probe_pallas_conv --batch 32 [{CARD}]")
    conv3x3_64.launches = 0
    probe = probe_pallas_conv.main(["--batch", "32"])
    torch.cuda.synchronize()
    launches = conv3x3_64.launches
    log("7", f"the probe launched K4 {launches} times")
    if launches == 0:
        raise AssertionError("the K4 probe launched no K4 kernel")
    return {"err": main_err, "launches": launches, "k4_cudnn_bf16": probe["cudnn_bf16_ms"],
            **times}


def main() -> None:
    card = phase0()
    dev = torch.device("cuda", 0)
    sass_mixes = phase1()
    errs = phase2(dev)
    phase3(dev)
    rng = np.random.default_rng(SEED + 2)
    requests = [foa_clips(rng, 4, 60.0), foa_clips(rng, 2, 60.0), foa_clips(rng, 1, 20.7)]
    pipe = build_pipeline(dev)
    launches = phase4(dev, pipe, requests)
    times = phase5(dev, pipe, requests[0], sass_mixes)
    del pipe
    k3 = phase6(dev)
    k4 = phase7(dev)
    # library_ms: one PyTorch call computing the same function, where there is one
    # (cuDNN bf16 for K4, timed by the probe); none exists for K1-K3
    kernels = [
        {"name": "salsa_spatial", "route": "cuda",
         "source": "salsa_tpu_torch/csrc/salsa_spatial.cu",
         "replaces": "salsa_tpu/features/salsa_pallas.py:138",
         "launches": launches["salsa_spatial"], "max_abs_err": errs["foa"],
         "ms": times["k1"], "plain_ms": times["k1_plain"], "bound_ms": times["k1_bound"][0],
         "bound_by": times["k1_bound"][1], "library_ms": None},
        {"name": "noise_floor", "route": "cuda",
         "source": "salsa_tpu_torch/csrc/noise_floor.cu",
         "replaces": "salsa_tpu/features/salsa.py:82",
         "launches": launches["noise_floor"], "max_abs_err": errs["k2"],
         "ms": times["k2"], "plain_ms": times["k2_plain"], "bound_ms": times["k2_bound"][0],
         "bound_by": times["k2_bound"][1], "library_ms": None},
        {"name": "salsa_spatial_probe", "route": "cuda",
         "source": "salsa_tpu_torch/csrc/salsa_spatial_probe.cu",
         "replaces": "scripts/probe_salsa_kernel.py:67",
         "launches": k3["launches"], "max_abs_err": k3["err"],
         "ms": k3["k3"], "plain_ms": k3["k3_plain"], "bound_ms": k3["k3_bound"][0],
         "bound_by": k3["k3_bound"][1], "library_ms": None},
        {"name": "conv3x3_64", "route": "cuda",
         "source": "salsa_tpu_torch/csrc/conv3x3_64.cu",
         "replaces": "scripts/probe_pallas_conv.py:90",
         "launches": k4["launches"], "max_abs_err": k4["err"],
         "ms": k4["k4"], "plain_ms": k4["k4_plain"], "bound_ms": k4["k4_bound"][0],
         "bound_by": k4["k4_bound"][1], "library_ms": k4["k4_cudnn_bf16"]},
    ]
    print(card, flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
    sys.exit(0)
