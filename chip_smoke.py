#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (`salsa_tpu_torch`) once through its serving path
on one NVIDIA GPU and check every kernel on the way.

    python3 chip_smoke.py

Phases, each printing what it found; any failure raises and exits non-zero:
  0. require CUDA; print the card (nvidia-smi) and switch TF32 off;
  1. build the CUDA kernels (K1 spatial stage, K2 noise-floor tracker, K3, K4)
     with nvcc, one process per source; check ptxas registers and spills (K1 and
     K2 no spills), print K1's SASS instruction mix, and check that K4's bf16
     kernel runs wgmma on TMA-loaded rows (HGMMA and UTMALDG in its SASS, no
     spills, no serialized wgmma pipeline) and its f32 kernel FFMA on TMA-loaded
     row chunks (UTMALDG and shared loads, no spills, no tensor-core instruction);
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
     at the stage-1 shape and two ragged shapes (7 and 80 channels), f32 also at
     the serving request's stage-1 shape and a row of 302 pixels; both timed
     against cuDNN in turns; then the probe
     `salsa_tpu_torch.scripts.probe_pallas_conv --check-only` at B=32;
  8. the serving CLI on a `salsa_tpu` experiment written to disk: configs/seld.yml,
     two seeded checkpoints (valSeld 0.4 and 0.6) in flax's msgpack format, the
     scaler and six FOA wavs (four 60 s, one 20.7 s, one 30 s at 48 kHz);
     `cli.predict` must pick the 0.4 checkpoint, launch K1 and K2 once per group
     and write CSVs byte-identical to the in-memory pipeline's; `cli.evaluate`
     scores them against ground truth written from each clip's source and scores
     the ground truth against itself as ER 0, F1 1, LE 0, LR 1; then the
     extraction bench `salsa_tpu_torch.scripts.bench_extract` (64 x 60 s);
  9. training from raw wavs at full width: an experiment written from seeds
     (configs/seld.yml with training.from_wav, four 60 s train and two 60 s val
     FOA wavs, two epochs of 6 steps at batch 32); K2's collect_states bit-equal
     to its plain version at (4, 191, 4801) and for clips of 1-5 frames; a batch
     of 4 chunks against the full-clip features sliced, at K1's bound; the first
     step's loss on the card against the CPU's plain versions within 1e-4; then
     `cli.train` with its launch counts (K1 and K2 in every step, K2 with
     collect_states at setup), setup times, the step split, steps/s, peak memory,
     K2 resumed (bit-equal) and K1 (K1's bound) against their plain versions at
     the step's shapes, their times and K2 collect_states's against their bounds,
     validation, and the trained `best` served through `cli.predict`;
 10. streaming serving at full width (blocks of 160 frames, 256 frames of context a
     side, 100 ms packets): seeded FOA streams at N = 1 and 4 in ragged packets
     against the CPU's plain versions (K1's bound), the tracker state leaving
     every block bit-equal to K2 collect_states over the whole stream, a slot's
     re-init bit-equal to a solo stream's start; then `cli.predict --streaming`
     on phase 8's experiment four ways (one stream, 4 a dispatch, int16 PCM, the
     pool with 4 slots and --max-lag-ms 400), one K1 and one K2 launch per block
     dispatch, the pool and the 4 streams within 1e-4 of the single stream,
     int16 bit-equal to floats, no zero-fill; a short clip against the CPU; the
     first block cold and warm, per-block latency (the pushes that ran the CRNN)
     and steady throughput on 160 s streams at N = 1, 4 and 16, the flush apart,
     and K1 and K2 at the block shapes;
 11. the rest of the feature bank: every feature type, SALSA without tracking and
     on the XLA power branch on seeded 4 x 60 s clips (FOA or a MIC array with
     inter-mic delays) against the CPU's run and, at the golden's 1 s, against the
     fixture (SALSA's exact eigensolver there only), K1 and K2 counted for each;
     then configs/seld_salsa_lite.yml at full width: three requests through
     SeldInferencePipeline (card vs CPU), `cli.predict` from disk (CSVs
     byte-identical to the in-memory pipeline's), `cli.predict --streaming
     --streams 4` and 4 streams' per-block latency, `cli.train` from wav (6 steps
     at batch 32 x 8 s, the first step's loss against the CPU's), with K1 and K2
     launching 0 times on every salsa_lite run; then the per-type extraction bench
     `salsa_tpu_torch.scripts.bench_features` (8 x 60 s);
 12. augmented and resumed training (training.device_augment): configs/seld.yml
     (the FOA channel swaps and frequency shift), its first step's loss on the
     card against the CPU's plain versions on the same draws (which must change
     the batch), then `cli.train` (2 epochs of 6 steps at batch 32) with K1 and K2
     counted in every step and the step split into extraction, augmentation,
     forward and backward and optimizer; `cli.train` for 2 epochs resumed to 4
     against a fresh 4-epoch run (constant lr; step losses within 1e-4);
     configs/seld_salsa_lite.yml augmented (the MIC swaps, shift and cutouts: the
     trailing 3 spatial channels 0 inside every cutout), K1 and K2 launching 0
     times;
 13. inference, TTA, the threshold sweep and the ensemble: phase 9's experiment
     trained twice (two seeds), then for reg_xyz and for accdoa on the same
     weights: `cli.infer --splits val` plain and `--tta` (16 FOA variants) with K1
     and K2 launching once per extraction batch and TTA adding none, the TTA
     dumps against the CPU's plain versions, fused against sequential TTA (one
     variant a dispatch) within 1e-4 with both times and the plain pass's; on
     reg_xyz `--tune-threshold` (the sidecar, val's CSVs at the tuned point) and
     `cli.predict --use-tuned-threshold`; `cli.ensemble` over one member (CSVs
     byte-identical to its infer's), both members with `--tune-threshold`, and
     `--ckpts` over member 0's epoch checkpoints inferred from a models/best
     directory;
 14. configs/seld_tpu.yml verbatim (PannResNet22TPU, bf16 compute, device_augment,
     from wav): three requests through SeldInferencePipeline (one K1 and one K2
     launch each; card against the CPU's run beside the card's bf16-versus-fp32
     distance; times beside the same weights in fp32), the first training step's
     loss against the CPU's on the same draws, `cli.train` (2 epochs of 6 steps at
     batch 32, one K1 and one K2 launch a step, the step split, peak memory), the
     trained `best` through `cli.predict` (CSVs byte-identical to the in-memory
     pipeline's), `--streaming --streams 4` and `--pool` (one K1 and one K2 launch a
     block dispatch), `cli.infer --tta`, and `--resume` from 2 to 3 epochs; then
     configs/seld.yml with the lstm, bilstm and transformer decoders in fp32: a
     4 x 60 s request each card against CPU at phase 4's gate, the first training
     step's loss against the CPU's within 1e-4;
 15. the feature-store workflow of configs/seld.yml as written (its three paths
     pointed at the temp tree, phase 9's step cut) on phase 9's clips:
     `cli.extract --feature-type salsa` (configs/tnsse2021_salsa.yml) with one K1
     and one K2 launch per equal-length batch, two stored clips against the CPU's
     plain extraction at K1's bound, the scaler bit-equal to StreamingScaler over
     the stored clips, a `--keep-existing` rerun extracting nothing; `cli.train`
     from the store with the host transforms (K1 = K2 = 0, the first step against
     the CPU's on the same draws, the step split into the prefetch wait, the copy,
     forward and backward and the optimizer, a profiled step, peak memory,
     checkpoints); training.device_data (its first batch bit-equal to the host
     path's, timed steps, bfloat16 storage), from_wav_mode precompute (K1 and K2 at
     startup only) and training.remat (a step within 1e-4 of the plain step,
     dropout on, both peaks); `cli.predict` of the trained best with the store's
     scaler (CSVs byte-identical to the in-memory pipeline's), `cli.infer --splits
     val` from the store (K1 = K2 = 0, against the same call on the CPU) and
     `cli.evaluate`;
 16. data-parallel training (`chip_smoke.py --rank <spec>` is one rank, spawned
     with torchrun's or salsa_tpu's variables and a timeout of its own):
     configs/seld.yml from phase 9's clips (3 steps at batch 32 x 8 s) (a) on one
     rank over NCCL against the same run without a process group (1e-6), (b) on
     two ranks sharing the card over gloo, 16 rows each, against (a) (1e-4 on the
     first step, 2e-3 after), K1 and K2 launched once a step in every rank; each
     rank's step time, time inside its collectives and peak memory; (c)
     training.device_data_shard on two ranks from a store of the clips against
     device_data on one rank in the same stratified order (1e-4); (d) that run cut
     after one epoch and resumed on two ranks (`--resume`; 1e-4); (e)
     `cli.export_ckpt` of (a)'s best and `cli.import_ckpt` into a new experiment,
     whose `cli.predict` CSVs are byte-identical to the original's; (f) SALSA of a
     6-mic array (K2 and the power iteration, no K1) against the CPU at phase 2's
     mask bound; (g) `utils.profiling`'s device_timer of K1 at the step's shape and
     its trace, which must hold K1's device row, taken in a process of its own
     (`chip_smoke.py --profile <spec>`: this long process's profiler loses device
     rows late in the run; phase 15's profiled step likewise, which must hold its
     upload's Memcpy HtoD row);
 17. SALSA at any channel count and the last modules: (a) SALSA of seeded 10 s
     MIC arrays of 17, 24 and 32 mics against the CPU's plain run at phase 2's
     mask bound (one K2 launch and no K1 a call); (b) a 60 s clip at 32 mics,
     timed, with its peak memory, its covariance and power iteration timed
     apart; (c) the measurement scripts bench_train (fp32,
     --from-wav, --bf16), bench_streaming (one stream of 60 s; --pool --int16),
     profile_step, probe_extract_stages (4 and 32 x 60 s), probe_stft_split and
     quality_seeds (2 seeds x 4 clips x 1 epoch), each JSON holding its
     original's keys with finite values; (d) a two-step `cli.train` whose
     TensorBoard event file holds train/ and val/ scalars at its step, or, without
     tensorboardX, whose log says nothing was written; (e) the same experiment
     with training.checkpoint_backend=orbax: `cli.train` writes `.orbax`
     checkpoints that restore bit-equal to the trainer's state, their restore
     timed against a msgpack twin of the same state, `cli.predict` serves the
     `.orbax` best (one K1 and one K2 launch a group) with CSVs byte-identical to
     the twin experiment's, `--resume` from `.orbax` bit-equal to `--resume` from
     the twin, tests/golden/orbax_small (salsa_tpu's orbax) restored equal to its
     msgpack with the C++ and plain zstd decoders byte-equal on its frames and
     both timed, and an unknown backend refused by cli.train.
The second-to-last line is a JSON summary of the kernels, each with its time,
its plain version's, its bound (the larger of its bytes over the memory rate and
its operations over the peak rate of their type) and, where one PyTorch call
computes the same function, that call's time; the last line is
{"ok": true, "device": {...}}. Weights are random, from a fixed seed.
"""
from __future__ import annotations

import contextlib
import copy
import importlib
import csv
import json
import logging
import os
import re
import shutil
import statistics
import struct
import subprocess
import sys
import tempfile
import time
import warnings

import numpy as np
import torch
import torch.nn.functional as F

from salsa_tpu_torch import configs
from salsa_tpu_torch.cli import ensemble as cli_ensemble
from salsa_tpu_torch.cli import export_ckpt as cli_export_ckpt
from salsa_tpu_torch.cli import extract as cli_extract
from salsa_tpu_torch.cli import evaluate as cli_evaluate
from salsa_tpu_torch.cli import import_ckpt as cli_import_ckpt
from salsa_tpu_torch.cli import infer as cli_infer
from salsa_tpu_torch.cli import predict as cli_predict
from salsa_tpu_torch.cli import train as cli_train
from salsa_tpu_torch.data.dataset import prefetch
from salsa_tpu_torch.data.feature_store import FeatureStore, StreamingScaler
from salsa_tpu_torch.data.wav_database import length_groups
from salsa_tpu_torch.features import chunked
from salsa_tpu_torch.dsp.stft import stft_planes
from salsa_tpu_torch.features.registry import make_extractor
from salsa_tpu_torch.features.salsa_lite import phase_scale
from salsa_tpu_torch.features.salsa import (
    SalsaParams,
    band_planes,
    extract_salsa,
    noise_floor_mask,
    noise_floor_mask_plain,
    principal_eigs_power,
    windowed_covariance,
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
    wgmma_serialized,
)
from salsa_tpu_torch.interop import torch_state_dict_to_flax
from salsa_tpu_torch.models.layers import Dropout
from salsa_tpu_torch.models.seld import build_model, init_random_
from salsa_tpu_torch.parallel import distributed, mesh
from salsa_tpu_torch.pipeline import SeldInferencePipeline
from salsa_tpu_torch.streaming import StreamingExtractor, StreamingSeldPipeline
from salsa_tpu_torch.scripts import (
    bench_extract,
    bench_features,
    probe_pallas_conv,
    probe_salsa_kernel,
)
from salsa_tpu_torch.scripts.probe_pallas_conv import conv3x3_64, conv3x3_64_plain, rel_err
from salsa_tpu_torch.scripts.probe_salsa_kernel import (
    VARIANTS,
    check_variant,
    salsa_spatial_variant,
    salsa_spatial_variant_plain,
)
from salsa_tpu_torch.scripts.timing import cuda_ms, smi
from salsa_tpu_torch.submission import write_classwise_csv
from salsa_tpu_torch.train import ocdbt, orbax_checkpoint, zstd
from salsa_tpu_torch.train.checkpoint import best_checkpoint as ckpt_best
from salsa_tpu_torch.train.checkpoint import latest_checkpoint as ckpt_latest
from salsa_tpu_torch.train.checkpoint import load_metadata as ckpt_load_metadata
from salsa_tpu_torch.train.checkpoint import msgpack_restore
from salsa_tpu_torch.train.checkpoint import restore_train_state as ckpt_restore_train_state
from salsa_tpu_torch.train.checkpoint import restore_variables as ckpt_restore_variables
from salsa_tpu_torch.train.checkpoint import save_checkpoint
from salsa_tpu_torch.train.ensemble import ensemble_predictions, write_ensemble
from salsa_tpu_torch.train.trainer import SeldPredictor, SeldTrainer, stratified_order
from salsa_tpu_torch.train.tta import tta_fold
from salsa_tpu_torch.utils.audio_io import read_wav, resample, wav_info, write_wav
from salsa_tpu_torch.utils import profiling
from salsa_tpu_torch.utils.config import apply_overrides, load_config, save_config
from salsa_tpu_torch.utils.experiments import configure_logging

REPO = os.path.dirname(os.path.abspath(__file__))
GOLDEN = os.path.join(REPO, "tests", "golden", "reference_features.npz")
SELD_YML = os.path.join(REPO, "configs", "seld.yml")
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


def k2_states_bound(shape) -> tuple[float, str]:
    """K2 with collect_states: k2_bound's bytes plus the per-frame state, a float
    floor and an int32 countdown written for every cell."""
    B, n_bins, n_padded = shape
    rows, cells = B * n_bins, B * n_bins * (n_padded - 2 * FOA.n_hopframes)
    return roofline(2 * rows * n_padded * 4 + cells + rows * 8 + cells * 8,
                    cells * K2_FLOPS_PER_CELL, FP32_FLOPS)


def k2_chain_floor_ms(n_frames: int, clk_per_step: float, sm_hz: float = 1.98e9) -> float:
    """The recurrence's own floor: n_frames dependent steps of clk_per_step each."""
    return n_frames * clk_per_step / sm_hz * 1e3


def normal_planes(rng: np.random.Generator, shape, dev) -> tuple[torch.Tensor, torch.Tensor]:
    """Seeded standard-normal re/im planes, float32, on `dev`."""
    return tuple(torch.from_numpy(rng.standard_normal(shape, dtype=np.float32)).to(dev)
                 for _ in range(2))


def check_k2(xr0, xi0, n_frames: int, what: str, state0=None, restart=None):
    """K2 against its plain version on CPU copies (the kernel is bit-exact IEEE):
    mask, floor and countdown must be equal. Returns the plain (mask, state)."""
    mask, (floor, cd) = noise_floor_mask(xr0, xi0, n_hop=3, n_frames=n_frames, state0=state0,
                                         restart=restart)
    cpu_state = None if state0 is None else tuple(s.cpu() for s in state0)
    p_mask, (p_floor, p_cd) = noise_floor_mask_plain(
        xr0.cpu(), xi0.cpu(), n_hop=3, n_frames=n_frames, state0=cpu_state,
        restart=None if restart is None else restart.cpu())
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
    build_log = path.with_suffix(".log").read_text()
    usage = ptxas_usage(build_log)
    for name, (regs, st, ld) in sorted(usage.items()):
        log("1", f"ptxas: {regs:3d} registers, spill stores {st} B, loads {ld} B: {name}")
    k1 = [(name, u) for name, u in usage.items() if "20salsa_spatial_kernel" in name]
    if len(k1) != 1 or k1[0][1][1:] != (0, 0):
        raise AssertionError(f"K1 salsa_spatial_kernel: ptxas (registers, spill stores, spill "
                             f"loads) {k1}, expected one kernel without spills")
    log("1", f"K1 salsa_spatial_kernel: {k1[0][1][0]} registers, no spills")
    # K2: the mask-only kernel and its collect_states instantiation
    k2 = sorted((name, u) for name, u in usage.items() if "noise_floor_kernel" in name)
    if len(k2) != 2 or any(u[1:] != (0, 0) for _, u in k2):
        raise AssertionError(f"K2 noise_floor_kernel: ptxas (registers, spill stores, spill "
                             f"loads) {k2}, expected two instantiations without spills")
    log("1", f"K2 noise_floor_kernel: {k2[0][1][0]} registers (mask only), {k2[1][1][0]} "
             f"(collect_states), no spills, tile of "
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

    # K4: the bf16 kernel runs wgmma (HGMMA) on rows that TMA loads (UTMALDG),
    # without spills and without ptxas serializing its wgmma pipeline; the f32
    # kernel stays on the CUDA cores (FFMA, no HMMA, no HGMMA), reads its ring with
    # shared-memory loads (LDS, no generic LD) that TMA fills, without spills. One
    # instantiation each.
    serialized = wgmma_serialized(build_log)
    for line in serialized.values():
        log("1", f"ptxas: {line}")
    for kind in ("conv3x3_64_wgmma_kernel", "conv3x3_64_f32_kernel"):
        names = sorted(name for name in ops if kind in name)
        if len(names) != 1:
            raise AssertionError(f"K4 {kind}: {len(names)} instantiations in the SASS, expected 1")
        name = names[0]
        op = ops[name]
        hgmma, hmma = op.get("HGMMA", 0), op.get("HMMA", 0)
        tma = op.get("UTMALDG", 0)
        regs, st, ld = usage[name]
        log("1", f"SASS: {hgmma:3d} HGMMA, {hmma} HMMA, {tma} TMA loads, {op.get('FFMA', 0)} "
                 f"FFMA, {op.get('LDS', 0)} LDS, {op.get('LD', 0)} LD of {sum(op.values())} "
                 f"instructions, {regs} registers, spills {st}/{ld} B: {name}")
        if kind.endswith("wgmma_kernel") and not (hgmma > 0 and tma > 0 and st == 0 and ld == 0
                                                  and name not in serialized):
            raise AssertionError(f"K4 bf16 {name}: {hgmma} HGMMA, {tma} TMA loads, spill "
                                 f"stores {st} B, loads {ld} B, serialized wgmma "
                                 f"{serialized.get(name)}; expected HGMMA, a TMA load, no "
                                 "spills and no serialization")
        if kind.endswith("f32_kernel") and (hmma or hgmma or not tma or st or ld
                                            or op.get("LD", 0) or not op.get("LDS", 0)):
            raise AssertionError(f"K4 f32 {name}: {hmma} HMMA, {hgmma} HGMMA, {tma} TMA loads, "
                                 f"spill stores {st} B, loads {ld} B, {op.get('LD', 0)} generic "
                                 f"and {op.get('LDS', 0)} shared loads; expected no tensor-core "
                                 "instruction, a TMA load, no spills, shared loads only")
    if serialized:
        raise AssertionError(f"ptxas serialized the wgmma pipeline of {sorted(serialized)}")
    log("1", "K4: the bf16 kernel runs wgmma on TMA-loaded rows without spills or "
             "serialization; the f32 kernel runs FFMA on TMA-loaded row chunks through shared "
             "loads, without spills or a tensor-core instruction")
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


def host_ms(fn, repeats=7) -> float:
    """Median host-clock ms of `repeats` calls of fn after one warm-up, the card
    synchronized after each."""
    fn()
    times = []
    for _ in range(repeats):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def phase5(dev, pipe, request, sass_mixes) -> dict:
    secs = request.shape[0] * request.shape[-1] / FS
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
    # the decoder's GRU a layer at a time (its training path with rnn dropout)
    # against nn.GRU's 2-layer call (its serving path) on the same weights
    dec = pipe.model.decoder
    with torch.inference_mode():
        h = pipe.model.encoder(feats).mean(dim=3).transpose(1, 2)
        gru_err = float((dec._per_layer(h) - dec.gru(h)[0]).abs().max())
        gru_ms = {"per layer": cuda_ms(lambda: dec._per_layer(h)),
                  "2-layer call": cuda_ms(lambda: dec.gru(h))}
    if gru_err > 1e-4:
        raise AssertionError(f"decoder GRU per layer vs nn.GRU's 2-layer call: {gru_err:.3e}")
    log("5", f"  decoder GRU on {tuple(h.shape)}, eval: per layer {gru_ms['per layer']:.3f} ms, "
             f"nn.GRU's 2-layer call {gru_ms['2-layer call']:.3f} ms (CUDA events, median of 7), "
             f"max abs difference {gru_err:.2e} [{CARD}]")

    xr, xi = stft_band(waves, FOA)
    n_t = xr.shape[-1] - 6
    xr0, xi0 = xr[:, 0].contiguous(), xi[:, 0].contiguous()
    mask, _ = noise_floor_mask(xr0, xi0, n_hop=3, n_frames=n_t)
    kw = spatial_kw(FOA)
    big = normal_planes(np.random.default_rng(SEED + 4), (64, 191, n_t + 6), dev)
    times = {
        "k1": cuda_ms(lambda: salsa_spatial(xr, xi, mask, **kw), calls=CALLS),
        "request_ms": req_ms, "crnn_ms": model_ms,
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

    # where a request's device time goes
    profile_table(lambda: pipe(request), "5", "one request", upload_bytes=request.nbytes)
    return times


PCIE_BYTES_PER_S = 64e9  # PCIe 5.0 x16, one direction: no host -> device copy is faster


def device_share(rows, wall_ms: float, upload_bytes: int) -> dict:
    """The device's busy time, host -> device copy and idle share of a profiled call
    from its device activities `rows`, (name, device us) pairs, and its host wall
    time. `copy_ms` is the `Memcpy HtoD` rows' sum. Where the call uploads
    `upload_bytes` and those rows add up to less than the link's least time for
    them, the profiler dropped the upload's row (small copies' rows may remain):
    the copy is then not measured (None), and so is the idle share (None). A
    dropped copy is never read as a short one."""
    busy_ms = sum(us for _, us in rows) / 1e3
    copy_ms = sum(us for name, us in rows if name.startswith("Memcpy HtoD")) / 1e3
    if copy_ms < upload_bytes / PCIE_BYTES_PER_S * 1e3:
        copy_ms = None
    idle = None if copy_ms is None or not rows else 1 - busy_ms / wall_ms
    return {"busy_ms": busy_ms, "copy_ms": copy_ms, "idle": idle}


def profile_table(fn, phase: str, what: str, top: int = 12, upload_bytes: int = 0) -> dict:
    """Profile one fn() on the card and print its device busy time against the host
    wall and the `top` kernels by device time; returns `device_share`'s reading.
    Kernel and copy activities only: op-level rows repeat the time of the kernels
    they launch. `upload_bytes`: what fn() copies from the host, so that a dropped
    copy row leaves the copy and the idle share not measured."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3

    def dev_us(e):
        return getattr(e, "self_device_time_total", getattr(e, "self_cuda_time_total", 0))

    events = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA
              and dev_us(e) > 0 and not e.key.startswith("Activity Buffer")]
    share = device_share([(e.key, dev_us(e)) for e in events], wall_ms, upload_bytes)
    share["device_events"] = profiling.device_event_count(prof)
    share["htod_rows"] = sum(e.count for e in events if e.key.startswith("Memcpy HtoD"))
    if not events:
        log(phase, f"profile of {what}: no device time recorded (not measured; "
                   f"{share['device_events']} device events)")
        return share
    copy = (f"copy of {upload_bytes / 1e6:.1f} MB: not measured (its Memcpy HtoD row is "
            "missing)" if share["copy_ms"] is None
            else f"copy {share['copy_ms']:.2f} ms")
    idle = "idle not measured" if share["idle"] is None else f"{share['idle']:.1%} idle"
    log(phase, f"profile of {what}: device busy {share['busy_ms']:.2f} ms of {wall_ms:.2f} ms "
               f"wall ({idle}, {copy}, profiler on; {share['device_events']} device events, "
               f"{share['htod_rows']} Memcpy HtoD rows) [{CARD}]")
    for e in sorted(events, key=dev_us, reverse=True)[:top]:
        log(phase, f"  {dev_us(e) / 1e3:9.3f} ms  x{e.count:<5d} {e.key[:90]}")
    return share


def kernel_device_ms(fn, kernel: str, calls: int = CALLS) -> float | None:
    """Mean device time per launch, in ms, of the kernels whose name holds `kernel`
    over `calls` calls of fn() under the profiler; None where the profiler records
    no device time. At shapes where a call's host work outlasts its kernel, this
    is the kernel's own time and CUDA events between back-to-back calls the
    wrapper's."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    hits = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA and kernel in e.key]
    dev_us = sum(getattr(e, "self_device_time_total", getattr(e, "self_cuda_time_total", 0))
                 for e in hits)
    launches = sum(e.count for e in hits)
    return dev_us / 1e3 / launches if launches and dev_us > 0 else None


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
    """K4 against its plain version; returns the error, times, the f32 plan and
    the probe's launches."""
    rng = np.random.default_rng(SEED + 3)

    def normal(shape, scale=1.0):
        return torch.from_numpy(rng.standard_normal(shape).astype(np.float32) * scale).to(dev)

    x, w = normal((32, 320, 100, 64)), normal((3, 3, 64, 64), 0.05)
    # ragged: in bf16, C = 7 (14-byte pixels, no TMA) takes the producer's
    # element-load fill, C = 80 TMA rows with a second 64-channel chunk (zero past
    # 80) and the weights refilled per chunk; in f32, C = 7 the element-load fill,
    # C = 80 five 16-channel chunks and the weights refilled per 64 channels. f32
    # also at the serving request's stage-1 shape (4 clips x 2400 frames) and at a
    # row of 302 pixels, two TMA boxes (bf16 refuses W + 2 > 256).
    ragged = [(normal((3, 13, 37, c)), normal((3, 3, c, 64), s)) for c, s in ((7, 0.3), (80, 0.1))]
    f32_only = [normal(shape) for shape in ((4, 2400, 100, 64), (2, 5, 300, 64))]
    # bf16: the kernel rounds its f32 sum once (<= 2^-8 relative), held against the
    # plain version's f32 sum and against its rounded output, both within 5e-3 of
    # max|plain|. Where the two roundings differ it is by one bf16 step, at most
    # 2^-7 of the value; on these fixed inputs a step in the top binade comes to
    # 4.6e-3 of the max. f32: the same sums in another order, 1e-5.
    bounds = {torch.bfloat16: 5e-3, torch.float32: 1e-5}
    main_err = None
    for dtype, bound in bounds.items():
        cases = [("", x, w)] + [("ragged ", a, b) for a, b in ragged]
        if dtype == torch.float32:
            cases += [("", a, w) for a in f32_only]
        for n, (label, a, b) in enumerate(cases):
            a, b = a.to(dtype), b.to(dtype)
            want = conv3x3_64_plain(a, b)
            want_f32 = conv3x3_64_plain(a.float(), b.float())
            what = f"{label}{tuple(a.shape)} {dtype}"
            got = conv3x3_64(a, b)
            torch.cuda.synchronize()
            err, err_rounded = rel_err(got, want_f32), rel_err(got, want)
            if n == 0 and dtype == torch.bfloat16:
                main_err = float((got.float() - want.float()).abs().max())
            log("7", f"K4 {what}: max|kernel - plain| / max|plain| "
                     f"{err:.3e} against the f32 sum, {err_rounded:.3e} against the plain "
                     f"output in {dtype} (bound {bound:.0e} each)")
            if not (torch.isfinite(got.float()).all() and err <= bound
                    and err_rounded <= bound):
                raise AssertionError(f"K4 {what}: rel err {err}, "
                                     f"{err_rounded} against the rounded plain output")
            del got, want, want_f32

    # times at the stage-1 shape, 10 calls back to back between CUDA events: each
    # kernel and its one PyTorch call (cuDNN on channels-last views, TF32 off) in
    # turns, kernel, cuDNN, cuDNN, kernel, so that their ratio comes from one card
    kw = dict(repeats=20, warmup=3, calls=probe_pallas_conv.K4_CALLS)
    B, H, W, C = x.shape
    flops = 2 * B * H * W * 9 * C * 64
    props = torch.cuda.get_device_properties(dev)
    plan = probe_pallas_conv.f32_plan(B, H, W, C, props.shared_memory_per_block_optin)
    times = {"k4_f32_ring_slots": plan.slots,
             "k4_f32_blocks": min(plan.tiles, props.multi_processor_count)}
    log("7", f"K4 f32 plan at {tuple(x.shape)}: {plan.tiles} tiles of "
             f"{probe_pallas_conv.F32_TILE} pixels on {times['k4_f32_blocks']} blocks, a ring of "
             f"{plan.slots} row chunks of {plan.boxes} x {plan.box_px} pixels, "
             f"{plan.smem_bytes} B of shared memory")
    for dtype, tag in ((torch.bfloat16, "k4"), (torch.float32, "k4_f32")):
        xd, wd = x.to(dtype), w.to(dtype)
        x_cl = xd.permute(0, 3, 1, 2)
        w_cl = wd.permute(3, 2, 0, 1).contiguous(memory_format=torch.channels_last)
        kernel = lambda: conv3x3_64(xd, wd)  # noqa: E731
        cudnn = lambda: F.conv2d(x_cl, w_cl, padding=1)  # noqa: E731
        turns = [cuda_ms(fn, **kw) for fn in (kernel, cudnn, cudnn, kernel)]
        times[f"{tag}_turns"] = turns
        times[tag] = (turns[0] + turns[3]) / 2
        times[f"{tag}_cudnn"] = (turns[1] + turns[2]) / 2
        # x and the output once each, the weights once, in the dtype
        n_bytes = xd.element_size() * (B * H * W * C + 9 * C * 64 + B * H * W * 64)
        times[f"{tag}_bound"] = roofline(n_bytes, flops, BF16_FLOPS if dtype == torch.bfloat16
                                         else FP32_FLOPS)
        log("7", f"K4 {tuple(x.shape)} {dtype}: in turns kernel / cuDNN / cuDNN / kernel "
                 + " / ".join(f"{ms:.4f}" for ms in turns)
                 + f" ms: kernel {times[tag]:.4f}, cuDNN {times[f'{tag}_cudnn']:.4f} "
                 f"(kernel {times[f'{tag}_cudnn'] / times[tag]:.3f}x cuDNN's speed); bound "
                 f"{times[f'{tag}_bound'][0]:.4f} ms ({times[f'{tag}_bound'][1]}), kernel at "
                 f"{100 * times[f'{tag}_bound'][0] / times[tag]:.1f} % of it [{CARD}]")
        del xd, wd, x_cl, w_cl
    xb, wb = x.to(torch.bfloat16), w.to(torch.bfloat16)
    times["k4_plain"] = cuda_ms(lambda: conv3x3_64_plain(xb, wb), **kw)
    log("7", f"K4 plain version (f32 cuDNN, TF32 off) on the bf16 inputs "
             f"{times['k4_plain']:.3f} ms [{CARD}]")
    del x, w, xb, wb, ragged, f32_only

    log("7", f"probe_pallas_conv --batch 32 --check-only [{CARD}]")
    conv3x3_64.launches = 0
    probe_pallas_conv.main(["--batch", "32", "--check-only"])
    torch.cuda.synchronize()
    launches = conv3x3_64.launches
    log("7", f"the probe launched K4 {launches} times")
    if launches == 0:
        raise AssertionError("the K4 probe launched no K4 kernel")
    return {"err": main_err, "launches": launches, **times}


# phase 8's wav directory: (name, seconds, sample rate); the four 60 s clips make
# one group of the CLI's batch size 4, and the 48 kHz clip is resampled to 24 kHz
SCENES = (("foa_a", 60.0, FS), ("foa_b", 60.0, FS), ("foa_c", 60.0, FS), ("foa_d", 60.0, FS),
          ("foa_short", 20.7, FS), ("foa_48k", 30.0, 48000))
CKPTS = (("epoch010", 10, 0.4), ("epoch020", 20, 0.6))  # (name, step, valSeld); 0.4 serves


def foa_scene(rng: np.random.Generator, seconds: float, fs: int, label_rate: int,
              audio_format: str = "foa") -> tuple[np.ndarray, list[str]]:
    """(4, n) float32 audio with one directional source of a random class that
    sounds for the first 3-7 s of every 10 s over diffuse noise, and its ground
    truth as DCASE 2021 metadata rows `frame,class,0,azi,ele`. FOA: first-order
    ambisonic gains; MIC: four mics that hear the source 0-4 samples apart."""
    n = int(round(seconds * fs))
    t = np.arange(n) / fs
    cls, azi, ele = int(rng.integers(N_CLASSES)), int(rng.integers(-180, 180)), int(
        rng.integers(-40, 41))
    on_s = rng.uniform(3.0, 7.0)
    a, e = np.deg2rad(azi), np.deg2rad(ele)
    gains = np.array([1.0, np.sin(a) * np.cos(e), np.sin(e), np.cos(a) * np.cos(e)])
    src = (0.1 * rng.standard_normal(n) + 0.3 * np.sin(2 * np.pi * rng.uniform(300, 3000) * t))
    src = src * (t % 10.0 < on_s)
    audio = 0.01 * rng.standard_normal((4, n))
    if audio_format == "mic":
        for m, d in enumerate(rng.integers(0, 5, 4)):
            audio[m, d:] += src[:n - d]
    else:
        audio += gains[:, None] * src
    rows = [f"{f},{cls},0,{azi},{ele}" for f in range(int(seconds * label_rate))
            if (f / label_rate) % 10.0 < on_s]
    return audio.astype(np.float32), rows


def write_experiment(root: str, scenes=SCENES, seed: int = SEED, config: str = SELD_YML) -> dict:
    """A `salsa_tpu` experiment as training leaves it, made from seeds: `config`
    (configs/seld.yml by default) copied verbatim, the CKPTS checkpoints of seeded
    random models written as flax msgpack with their sidecars, the scaler (the
    feature type's scaler channels and width), 16-bit wavs of the config's audio
    format and their ground truth. Returns its paths and the served checkpoint's
    torch weights."""
    name = os.path.splitext(os.path.basename(config))[0]
    config = shutil.copyfile(config, os.path.join(root, os.path.basename(config)))
    cfg = load_config(config)
    group = os.path.join(root, "outputs")
    models = os.path.join(group, cfg.mode, cfg.data.audio_format, cfg.feature_type, name,
                          "models")
    weights = {}
    for i, (ck, step, val_seld) in enumerate(CKPTS):
        model = init_random_(
            build_model(encoder=cfg.model.encoder.to_dict(), decoder=cfg.model.decoder.to_dict(),
                        n_classes=cfg.data.n_classes, output_format=cfg.data.output_format),
            torch.Generator().manual_seed(seed + i))
        weights[ck] = model.state_dict()
        save_checkpoint(os.path.join(models, "best"), ck,
                        *torch_state_dict_to_flax(weights[ck]), step,
                        {"epoch": step, "valSeld": val_seld})
    ex = make_extractor(cfg.feature_type, cfg.data.audio_format,
                        **cli_predict.feature_kwargs(cfg))
    rng = np.random.default_rng(seed)
    shape = (ex.n_spec_channels, 1, ex.n_features)
    np.savez(os.path.join(models, "feature_scaler.npz"),
             mean=rng.normal(-5.0, 1.0, shape).astype(np.float32),
             std=rng.uniform(5.0, 8.0, shape).astype(np.float32))
    wav_dir, gt_root = os.path.join(root, "wavs"), os.path.join(root, "task3")
    os.makedirs(wav_dir)
    os.makedirs(os.path.join(gt_root, "metadata_dev"))
    for wav, seconds, fs in scenes:
        audio, rows = foa_scene(rng, seconds, fs, cfg.data.label_rate, cfg.data.audio_format)
        write_wav(os.path.join(wav_dir, f"{wav}.wav"), audio, fs, bits=16)
        with open(os.path.join(gt_root, "metadata_dev", f"{wav}.csv"), "w") as f:
            f.write("\n".join(rows) + "\n")
    served = min(CKPTS, key=lambda c: c[2])[0]
    return {"config": config, "group": group, "wav_dir": wav_dir, "gt_root": gt_root,
            "log": os.path.join(os.path.dirname(models), "logs", "log.txt"), "cfg": cfg,
            "scaler": os.path.join(models, "feature_scaler.npz"),
            "served": os.path.join(models, "best", f"{served}.msgpack"),
            "weights": weights[served], "scenes": scenes}


class LogStamps(logging.Filter):
    """The host-clock time of each record of the CLI's logger. The CLI replaces
    its logger's handlers on every call but keeps its filters."""

    def __init__(self):
        super().__init__()
        self.marks: list[tuple[float, str]] = []

    def filter(self, record: logging.LogRecord) -> bool:
        self.marks.append((time.perf_counter(), record.getMessage()))
        return True

    def since(self, t0: float) -> str:
        """Each record's seconds since `t0`, by its first word (`n/m predicted`
        whole), and forget them."""
        marks = [(t - t0, m if m.endswith("predicted") else m.split()[0])
                 for t, m in self.marks]
        self.marks = []
        return ", ".join(f"{m} {t:.3f}" for t, m in marks)


def serve_cli(dev, exp: dict, out_dir: str, batch_size: int) -> float:
    """One `cli.predict` call on `exp` into `out_dir`; returns its host-clock s."""
    t0 = time.perf_counter()
    cli_predict.predict(exp["config"], exp["wav_dir"], out_dir, exp["group"],
                        batch_size=batch_size, device=dev)
    if dev.type == "cuda":
        torch.cuda.synchronize()
    return time.perf_counter() - t0


def phase8(dev, scenes=SCENES, batch_size: int = 4) -> dict:
    """The serving CLI on an experiment from disk (configs/seld.yml), held against
    the in-memory pipeline, then scored (`serve_from_disk`)."""
    with tempfile.TemporaryDirectory() as tmp:
        return serve_from_disk(dev, write_experiment(tmp, scenes), tmp, batch_size, "8")


def serve_from_disk(dev, exp: dict, tmp: str, batch_size: int = 4, tag: str = "8") -> dict:
    """The serving CLI on the experiment `exp` (written under `tmp`), held against
    the in-memory pipeline, then scored. The CLI runs twice: first as a user's
    first call, then again, warm, so the first call's extra time shows per log
    record. On the card a SALSA experiment launches K1 and K2 once per group and
    every other feature type neither. Returns the launches, the CLI's served line
    and the host-clock times."""
    scenes = exp["scenes"]
    cfg, d = exp["cfg"], exp["cfg"].data
    out_dir = os.path.join(tmp, "preds")
    stamps = LogStamps()
    cli_logger = logging.getLogger("salsa_tpu_torch")
    cli_logger.addFilter(stamps)
    try:
        salsa_spatial.launches = 0
        noise_floor_mask.launches = 0
        t0 = time.perf_counter()
        call_s = serve_cli(dev, exp, out_dir, batch_size)
        launches = {"salsa_spatial": salsa_spatial.launches,
                    "noise_floor": noise_floor_mask.launches}
        first_marks = stamps.since(t0)
        with open(exp["log"]) as f:
            log_text = f.read()
        t0 = time.perf_counter()
        warm_s = serve_cli(dev, exp, os.path.join(tmp, "preds_warm"), batch_size)
        warm_marks = stamps.since(t0)
    finally:
        cli_logger.removeFilter(stamps)
    restored = re.findall(r"restored (\S+)", log_text)
    served = re.findall(r"served .*realtime\)", log_text)
    if restored != [exp["served"]]:
        raise AssertionError(f"the CLI restored {restored}, expected {exp['served']}")

    # the in-memory pipeline on the same decoded audio, grouped as the CLI groups
    # (exact sample count, batch_size a group), from the served checkpoint's
    # torch weights
    model = build_model(encoder=cfg.model.encoder.to_dict(),
                        decoder=cfg.model.decoder.to_dict(), n_classes=d.n_classes)
    scaler = np.load(exp["scaler"])
    pipe = SeldInferencePipeline(
        make_extractor(cfg.feature_type, d.audio_format, **cli_predict.feature_kwargs(cfg)),
        model, exp["weights"], (scaler["mean"], scaler["std"]),
        model.time_downsample_ratio * d.label_rate / (d.fs / d.hop_len), d.n_classes,
        d.output_format, device=dev)
    groups, buckets = [], {}
    # host clock, seconds; the decode is read_wav(target_fs=d.fs) split into the
    # file's parse and conversion to float32 (what native/wavio.cpp does) and the
    # resampling of a clip at another rate
    spent = {"decode": 0.0, "parse": 0.0, "resample": 0.0, "requests": 0.0, "csv": 0.0}
    for name in sorted(os.listdir(exp["wav_dir"])):
        t0 = time.perf_counter()
        a, fs = read_wav(os.path.join(exp["wav_dir"], name))
        t1 = time.perf_counter()
        if fs != d.fs:
            a = resample(a, fs, d.fs)
        spent["parse"] += t1 - t0
        spent["resample"] += time.perf_counter() - t1
        spent["decode"] += time.perf_counter() - t0
        buckets.setdefault(a.shape[1], []).append((name, a))
        if len(buckets[a.shape[1]]) == batch_size:
            groups.append(buckets.pop(a.shape[1]))
    groups += [buckets[n] for n in sorted(buckets)]
    ref_dir = os.path.join(tmp, "ref")
    os.makedirs(ref_dir)
    for group in groups:
        t0 = time.perf_counter()
        ev, doa = pipe(np.stack([a for _, a in group]))  # numpy out: synchronized
        t1 = time.perf_counter()
        for (name, _), e_row, d_row in zip(group, ev, doa):
            write_classwise_csv(os.path.join(ref_dir, name[:-4] + ".csv"), e_row, d_row,
                                d.n_classes, sed_threshold=cfg.sed_threshold,
                                max_frames=e_row.shape[0], version=str(cfg.eval_version))
        spent["requests"] += t1 - t0
        spent["csv"] += time.perf_counter() - t1
    k = len(groups) if dev.type == "cuda" and cfg.feature_type == "salsa" else 0
    want = {"salsa_spatial": k, "noise_floor": k}
    log(tag, f"cli.predict served {len(scenes)} wavs in {len(groups)} groups "
             f"{[len(g) for g in groups]} from {os.path.basename(restored[0])}; launches "
             f"{launches} [{CARD}]")
    if launches != want:
        raise AssertionError(f"expected {want} K1 and K2 launches ({cfg.feature_type}, "
                             f"{len(groups)} groups), got {launches}")
    csvs = sorted(os.listdir(out_dir))
    warm_dir = os.path.join(tmp, "preds_warm")
    if csvs != sorted(f"{n}.csv" for n, _, _ in scenes) or csvs != sorted(
            os.listdir(ref_dir)) or csvs != sorted(os.listdir(warm_dir)):
        raise AssertionError(f"CSVs {csvs}, expected one per wav")
    n_rows = 0
    for name in csvs:
        with open(os.path.join(out_dir, name), "rb") as f, \
                open(os.path.join(ref_dir, name), "rb") as g, \
                open(os.path.join(warm_dir, name), "rb") as h:
            got, ref, again = f.read(), g.read(), h.read()
        if got != ref or again != got:
            raise AssertionError(f"{name}: the CLI's CSVs are not byte-identical to the "
                                 "in-memory pipeline's")
        n_rows += got.count(b"\n")
    log(tag, f"{len(csvs)} CSVs, {n_rows} event rows, byte-identical to the in-memory "
             "pipeline's and to the CLI's second call")
    log(tag, f"the CLI's log: {served[-1]} (host clock, wav decode included) [{CARD}]")
    log(tag, f"the CLI's first call, {call_s:.3f} s; seconds from its start to each "
             f"log record: {first_marks} [{CARD}]")
    log(tag, f"the CLI again, warm, {warm_s:.3f} s: {warm_marks} [{CARD}]")
    log(tag, "the same work again outside the CLI, host clock: wav decode "
             f"{spent['decode']:.3f} s (the 48 kHz clip's resampling included), "
             f"{len(groups)} pipeline calls {spent['requests']:.3f} s, CSV writing "
             f"{spent['csv']:.3f} s [{CARD}]")
    log(tag, f"  of the wav decode: parsing the files and converting to float32 "
             f"{spent['parse']:.3f} s, resampling the 48 kHz clip {spent['resample']:.3f} s "
             f"[{CARD}]")

    scores = cli_evaluate.main(["--output-dir", out_dir, "--gt-meta-root-dir",
                                exp["gt_root"], "--n-classes", str(d.n_classes)])
    if not all(np.isfinite(v) for v in scores.values()):
        raise AssertionError(f"non-finite scores {scores}")
    self_scores = cli_evaluate.main([
        "--output-dir", os.path.join(exp["gt_root"], "metadata_dev"),
        "--gt-meta-root-dir", exp["gt_root"], "--n-classes", str(d.n_classes)])
    # the same (azimuth, elevation) twice: arccos of a cosine rounded to 1 - 1 ulp
    # reads up to ~1e-6 degrees
    if not (self_scores["ER"] == 0 and abs(self_scores["F1"] - 1) < 1e-9
            and 0 <= self_scores["LE"] < 1e-4 and abs(self_scores["LR"] - 1) < 1e-9):
        raise AssertionError(f"ground truth against itself: {self_scores}, expected ER 0, "
                             "F1 1, LE 0, LR 1")
    log(tag, "cli.evaluate, random weights against the ground truth: " + ", ".join(
        f"{k} {v:.4f}" for k, v in scores.items()))
    log(tag, "cli.evaluate, the ground truth against itself: " + ", ".join(
        f"{k} {v:.3g}" for k, v in self_scores.items()))
    return {"launches": launches, "served": served[-1], "call_s": call_s, "warm_s": warm_s,
            **spent}


# phase 9's experiment: four train and two val clips, configs/seld.yml trained
# from raw wavs for two epochs; train_fraction 0.5 makes an epoch 6 steps of 32
# chunks (4 clips x 105 chunks of 8 s at a 0.5 s hop: 420 // 32 = 13, x 0.5)
TRAIN_CLIPS = ("tr_a", "tr_b", "tr_c", "tr_d")
VAL_CLIPS = ("va_a", "va_b")
TRAIN_OVERRIDES = ("training.from_wav=true", "feature_root_dir=null", "training.max_epochs=2",
                   "data.train_fraction=0.5")
TIMED_STEPS = 10  # steps timed after training; the median is of steps 3 onward


def write_train_experiment(root: str, seconds: float = 60.0, seed: int = SEED,
                           overrides=(), config: str = SELD_YML) -> dict:
    """A from-wav experiment made from seeds: `config` (configs/seld.yml by default)
    with TRAIN_OVERRIDES (and `overrides`), its ground-truth and split directories
    under `root`, 16-bit wavs of the config's audio format, one directional
    source each, with DCASE metadata."""
    cfg = load_config(config)
    task3, meta = os.path.join(root, "task3"), os.path.join(root, "meta")
    apply_overrides(cfg, [*TRAIN_OVERRIDES, f"gt_meta_root_dir={task3}",
                          f"split_meta_dir={meta}", *overrides])
    fmt = cfg.data.audio_format
    wav_dir, val_dir = os.path.join(task3, f"{fmt}_dev"), os.path.join(root, "val_wavs")
    for d in (wav_dir, val_dir, os.path.join(task3, "metadata_dev"), meta):
        os.makedirs(d)
    rng = np.random.default_rng(seed + 9)
    for split, names in (("train", TRAIN_CLIPS), ("val", VAL_CLIPS)):
        for name in names:
            audio, rows = foa_scene(rng, seconds, FS, cfg.data.label_rate, fmt)
            write_wav(os.path.join(wav_dir, f"{name}.wav"), audio, FS, bits=16)
            with open(os.path.join(task3, "metadata_dev", f"{name}.csv"), "w") as f:
                f.write("\n".join(rows) + "\n")
            if split == "val":
                shutil.copyfile(os.path.join(wav_dir, f"{name}.wav"),
                                os.path.join(val_dir, f"{name}.wav"))
        with open(os.path.join(meta, f"{split}.csv"), "w") as f:
            f.write("filename\n" + "\n".join(names) + "\n")
    path = os.path.join(root, os.path.basename(config))
    save_config(cfg, path)
    name = os.path.splitext(os.path.basename(config))[0]
    return {"config": path, "group": os.path.join(root, "outputs"), "cfg": cfg,
            "val_wav_dir": val_dir, "wav_dir": wav_dir,
            "exp_dir": os.path.join(root, "outputs", cfg.mode, fmt, cfg.feature_type, name)}


def first_step_loss(tr, dev, tag: str, bound: float = 1e-4) -> float:
    """The first step's loss with every dropout off: the device against the CPU's
    plain versions on copies of the same resident rows and weights; raises beyond
    `bound` relative (1e-4, fp32). With augmentation, both sides apply the step's
    draws (one draw on the CPU generator), which must change the batch. Returns
    the relative difference."""
    for m in tr.model.modules():
        if isinstance(m, Dropout):
            m.p, m.generator = 0.0, None
    model_cpu = copy.deepcopy(tr.model).cpu()
    ids = tr._epoch_order(0)[:tr.batch_size]
    i = torch.as_tensor(ids, device=dev)
    with torch.no_grad():
        x, sed, doa = tr.batch(ids)
        t0 = time.perf_counter()
        rows = [t[i].cpu() for t in (tr._clip, tr._f0, tr._n_full)]
        state = ((None, None) if tr._floor_ck is None
                 else (tr._floor_ck[i].cpu(), tr._cd_ck[i].cpu()))
        x_cpu = tr.normalize(tr.chunk_fn(tr._waves.cpu(), *rows, *state, tr.wav_scale),
                             tr._n_valid[i].cpu())
        sed_cpu, doa_cpu = sed.cpu(), doa.cpu()
        what = ""
        if tr.augment is not None:
            tr.seed_step()
            draws = tr.augment.draw(tr.batch_size, tr.augment_generator)
            x_aug, sed, doa_aug = tr.augment.apply(draws.to(dev), x, sed, doa)
            if torch.equal(x_aug, x) and torch.equal(doa_aug, doa):
                raise AssertionError("the augmentation's draws left the first batch unchanged")
            x_cpu, sed_cpu, doa_cpu = tr.augment.apply(draws, x_cpu, sed_cpu, doa_cpu)
            changed = float((x_aug != x).float().mean())
            x, doa = x_aug, doa_aug
            what = f", augmented ({changed:.1%} of the input's cells changed)"
        loss_cpu = float(tr.loss(model_cpu.train()(x_cpu), sed_cpu, doa_cpu)[0])
        cpu_s = time.perf_counter() - t0
        loss_dev = float(tr.loss(tr.model.train()(x), sed, doa)[0])
    rel = abs(loss_dev - loss_cpu) / abs(loss_cpu)
    log(tag, f"first step's loss (batch {tr.batch_size}, dropout off{what}): {dev.type} "
             f"{loss_dev:.7f}, CPU plain versions {loss_cpu:.7f} ({cpu_s:.1f} s), "
             f"relative difference {rel:.2e} (bound {bound:g})")
    if not rel < bound:
        raise AssertionError(f"first step's loss: {loss_dev} on {dev} vs {loss_cpu} on the CPU")
    return rel


def check_k2_states(xr0, xi0, n_frames: int, what: str, state0=None):
    """K2 with collect_states against its plain version on CPU copies: mask, final
    state and every per-frame state bit-equal."""
    got = noise_floor_mask(xr0, xi0, n_hop=3, n_frames=n_frames, state0=state0,
                           collect_states=True)
    cpu_state = None if state0 is None else tuple(s.cpu() for s in state0)
    want = noise_floor_mask_plain(xr0.cpu(), xi0.cpu(), n_hop=3, n_frames=n_frames,
                                  state0=cpu_state, collect_states=True)
    names = ("mask", "floor", "countdown", "floor states", "countdown states")
    flat = lambda r: (r[0], *r[1], *r[2])  # noqa: E731
    for name, g, w in zip(names, flat(got), flat(want)):
        if not torch.equal(g.cpu(), w):
            raise AssertionError(f"K2 collect_states {what} {tuple(xr0.shape)}: {name} not "
                                 f"bit-equal to the plain tracker ({int((g.cpu() != w).sum())} "
                                 "values differ)")
    return got


def stream_tracker_states(windows, p: SalsaParams, block_len: int):
    """K2 collect_states over a whole zero-led stream, from the planes of its
    block windows (N, 4, win_len) in order laid end to end (each block's own
    frames, the first block's left context and the last block's right context):
    (floors f32, countdowns i32), each (N, n_blocks * block_len, bins), the state
    entering every frame, from K2's own clip-start init."""
    h = p.n_hopframes

    def band0(window):
        re, im = chunked.block_spectra(window, p)
        return tuple(x[:, 0, :, p.lower_bin:p.upper_bin].transpose(-1, -2) for x in (re, im))

    planes = [band0(w) for w in windows]
    xr, xi = (torch.cat([planes[0][i][..., :h]] + [pl[i][..., h:h + block_len] for pl in planes]
                        + [planes[-1][i][..., h + block_len:]], dim=-1).contiguous()
              for i in (0, 1))
    _, _, states = noise_floor_mask(xr, xi, n_hop=h, n_frames=len(windows) * block_len,
                                    collect_states=True)
    return states


def check_chunks(tr, dev) -> float:
    """4 chunks extracted on the device (first, middle and last of clip 0, first of
    clip 1) against the device's full-clip features sliced: spectrograms within
    5e-3, spatial channels at K1's bound. Returns the spatial max abs error."""
    clip0 = np.flatnonzero(tr.train_data.clip_of_chunk == 0)
    ids = np.array([clip0[0], clip0[len(clip0) // 2], clip0[-1],
                    np.flatnonzero(tr.train_data.clip_of_chunk == 1)[0]])
    i = torch.as_tensor(ids, device=dev)
    got = tr.chunk_fn(tr._waves, tr._clip[i], tr._f0[i], tr._n_full[i], tr._floor_ck[i],
                      tr._cd_ck[i], tr.wav_scale)
    full = extract_salsa(torch.from_numpy(np.stack(tr.train_data.clip_wavs[:2])).to(dev),
                         tr.feature_params)
    L = tr.chunk_len
    want = torch.stack([full[int(tr._clip[c]), :, int(tr._f0[c]):int(tr._f0[c]) + L]
                        for c in ids])
    np.testing.assert_allclose(got[:, :4].cpu().numpy(), want[:, :4].cpu().numpy(), atol=5e-3,
                               rtol=5e-3, err_msg="chunk spectrograms")
    return compare_spatial(got[:, 4:], want[:, 4:], f"4 chunks {tuple(got.shape)} vs the "
                                                    "full-clip slices", phase="9")


def timed_steps(tr, dev, n_steps: int) -> dict:
    """n_steps train steps, each split into extraction, augmentation (0 without
    it), forward+backward and optimizer between CUDA events (host clock on the
    CPU); medians of steps 3 on."""
    order = tr._epoch_order(tr.max_epochs)
    parts = {"extract": [], "augment": [], "fwd_bwd": [], "optimizer": [], "step": []}
    for s in range(n_steps):
        ids = order[(s * tr.batch_size) % len(order):][:tr.batch_size]
        tr.seed_step()
        if dev.type == "cuda":
            ev = [torch.cuda.Event(enable_timing=True) for _ in range(5)]
            ev[0].record()
            batch = tr.batch(ids)
            ev[1].record()
            batch = tr.augment_batch(*batch)
            ev[2].record()
            tr.forward_backward(*batch)
            ev[3].record()
            tr.optimizer.step()
            ev[4].record()
            ev[4].synchronize()
            t = [ev[0].elapsed_time(ev[k]) for k in (1, 2, 3, 4)]
        else:
            t0 = time.perf_counter()
            batch = tr.batch(ids)
            t1 = time.perf_counter()
            batch = tr.augment_batch(*batch)
            t2 = time.perf_counter()
            tr.forward_backward(*batch)
            t3 = time.perf_counter()
            tr.optimizer.step()
            t = [(x - t0) * 1e3 for x in (t1, t2, t3, time.perf_counter())]
        for key, v in zip(parts, (t[0], t[1] - t[0], t[2] - t[1], t[3] - t[2], t[3])):
            parts[key].append(v)
    return {k: statistics.median(v[2:]) for k, v in parts.items()}


def step_planes(tr, dev):
    """A train step's inputs to K1 and K2: the band planes (B, 4, bins, L + 6) of its
    chunks and their tracker checkpoints."""
    ids = torch.as_tensor(tr._epoch_order(0)[:tr.batch_size], device=dev)
    p = tr.feature_params
    _, (re, im) = chunked.chunk_spectra(
        tr._waves, tr._clip[ids], tr._f0[ids], tr._n_full[ids], tr.chunk_len, p.n_hopframes,
        p.n_fft, p.hop_length, p.win_length or p.n_fft, tr.wav_scale)
    xr = re[..., p.lower_bin:p.upper_bin].transpose(-1, -2).contiguous()
    xi = im[..., p.lower_bin:p.upper_bin].transpose(-1, -2).contiguous()
    return xr, xi, (tr._floor_ck[ids], tr._cd_ck[ids])


def counted_train(dev, *args, **kwargs):
    """`cli_train.train(*args, device=dev, **kwargs)` with K1 and K2 counted from 0:
    (trainer, launches, host-clock seconds)."""
    salsa_spatial.launches = noise_floor_mask.launches = 0
    noise_floor_mask.collect_launches = 0
    t0 = time.perf_counter()
    tr = cli_train.train(*args, device=dev, **kwargs)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    launches = {"salsa_spatial": salsa_spatial.launches,
                "noise_floor": noise_floor_mask.launches,
                "noise_floor_collect": noise_floor_mask.collect_launches}
    return tr, launches, time.perf_counter() - t0


def check_train_launches(launches: dict, n_steps: int, what: str) -> None:
    """K1 and K2 in each of a SALSA run's n_steps steps and K2 with
    collect_states at its setup."""
    if not (launches["noise_floor_collect"] >= 1 and launches["salsa_spatial"] >= n_steps
            and launches["noise_floor"] >= n_steps + launches["noise_floor_collect"]):
        raise AssertionError(f"{what} launched {launches}: expected K1 and K2 in each of its "
                             f"{n_steps} steps and K2 with collect_states at setup")


def phase9(dev, seconds: float = 60.0, overrides=()) -> dict:
    """Training from raw wavs: checks on the device, then `cli.train` as a user
    runs it, its launches counted, then its times, validation and serving."""
    cuda = dev.type == "cuda"
    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        exp = write_train_experiment(tmp, seconds, overrides=overrides)
        cfg = exp["cfg"]

        # K2 collect_states on the card, bit-equal to its plain version
        waves = torch.from_numpy(np.stack([read_wav(os.path.join(exp["wav_dir"], f"{n}.wav"))[0]
                                           for n in TRAIN_CLIPS])).to(dev)
        xr, xi = stft_band(waves, FOA)
        xr0, xi0 = xr[:, 0].contiguous(), xi[:, 0].contiguous()
        n_t = xr0.shape[-1] - 6
        del waves, xr, xi
        if cuda:
            check_k2_states(xr0, xi0, n_t, "clip start")
            rng = np.random.default_rng(SEED + 11)
            for t in (1, 2, 3, 4, 5):
                check_k2_states(*normal_planes(rng, (3, 11, t + 6), dev), t, f"33 rows T={t}")
            st = (torch.from_numpy(rng.uniform(0.5, 1.5, (3, 11)).astype(np.float32)).to(dev),
                  torch.from_numpy(rng.integers(-3, 4, (3, 11), dtype=np.int32)).to(dev))
            check_k2_states(*normal_planes(rng, (3, 11, 3 + 6), dev), 3, "resumed", state0=st)
            log("9", f"K2 collect_states {tuple(xr0.shape)} and (3, 11, T + 6) for T in 1-5, "
                     "from the clip start and resumed: mask, final state and every per-frame "
                     "state bit-equal to the plain tracker")

        # a trainer built as cli.train builds it, for the checks
        tr = cli_train.build_trainer(exp["config"], exp["group"], exp_suffix="_check",
                                     device=dev)
        out["chunk_err"] = check_chunks(tr, dev)
        first_step_loss(tr, dev, "9")
        del tr
        if cuda:
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats(dev)

        # the main path: cli.train, as a user runs it
        tr, launches, wall = counted_train(dev, exp["config"], exp["group"])
        n_steps = tr.steps_per_epoch * tr.max_epochs
        peak = torch.cuda.max_memory_allocated(dev) / 2**30 if cuda else float("nan")
        log("9", f"cli.train: {len(TRAIN_CLIPS)} x {seconds:g} s train clips ({len(tr.train_data)} "
                 f"chunks of {tr.chunk_len} frames), {len(VAL_CLIPS)} val clips, {tr.max_epochs} "
                 f"epochs of {tr.steps_per_epoch} steps at batch {tr.batch_size}: {wall:.2f} s "
                 f"host clock; launches {launches}; peak memory {peak:.2f} GiB [{CARD}]")
        if cuda:
            check_train_launches(launches, n_steps, "cli.train")
        log("9", "setup, host clock: " + ", ".join(
            f"{k} {v:.3f} s" for k, v in tr.setup_seconds.items()) + f" [{CARD}]")
        exp_dir = exp["exp_dir"]
        ckpts = sorted(os.listdir(os.path.join(exp_dir, "models", "checkpoint")))
        want = [f"epoch{e:03d}.{x}" for e in range(tr.max_epochs) for x in ("json", "msgpack")]
        if ckpts != want:
            raise AssertionError(f"{exp_dir}/models/checkpoint: {ckpts}, expected {want}")

        times = timed_steps(tr, dev, TIMED_STEPS)
        chunk_s = tr.chunk_len * cfg.data.hop_len / cfg.data.fs
        log("9", f"train step, median of steps 3-{TIMED_STEPS}: {times['step']:.2f} ms = "
                 f"extraction {times['extract']:.2f} + forward and backward "
                 f"{times['fwd_bwd']:.2f} + optimizer {times['optimizer']:.2f} ms; "
                 f"{1e3 / times['step']:.2f} steps/s, {tr.batch_size} chunks x {chunk_s:g} s = "
                 f"{tr.batch_size * chunk_s * 1e3 / times['step']:.1f}x realtime [{CARD}]")
        out.update(launches=launches, step=times, peak_gib=peak, wall_s=wall,
                   setup=dict(tr.setup_seconds))
        if cuda:
            ids = tr._epoch_order(tr.max_epochs + 1)[:tr.batch_size]
            profile_table(lambda: tr.train_step(ids), "9", "one train step", top=16)

        if cuda:
            # K2 resumed and K1 at the step's shapes against their plain versions on
            # CPU copies, then timed on the same inputs
            xr, xi, state = step_planes(tr, dev)
            xs0, xs1 = xr[:, 0].contiguous(), xi[:, 0].contiguous()
            mask = check_k2(xs0, xs1, tr.chunk_len, "resumed at the step's chunk starts",
                            state0=state)[0].to(dev)
            kw = spatial_kw(FOA)
            out["k1_step_err"] = compare_spatial(
                salsa_spatial(xr, xi, mask, **kw),
                salsa_spatial_plain(xr.cpu(), xi.cpu(), mask.cpu(), **kw),
                f"K1 at the step's shape {tuple(xr.shape)}", phase="9")
            log("9", f"K2 resumed {tuple(xs0.shape)} from the step's tracker checkpoints: mask "
                     "and final state bit-equal to the plain tracker")
            out["k1_step"] = cuda_ms(lambda: salsa_spatial(xr, xi, mask, **kw), calls=CALLS)
            out["k2_step"] = cuda_ms(lambda: noise_floor_mask(
                xs0, xs1, n_hop=3, n_frames=tr.chunk_len, state0=state), calls=CALLS)
            out["k1_step_bound"], out["k2_step_bound"] = k1_bound(xr.shape), k2_bound(xs0.shape)
            out["k2_collect"] = cuda_ms(lambda: noise_floor_mask(
                xr0, xi0, n_hop=3, n_frames=n_t, collect_states=True), calls=CALLS)
            out["k2_collect_bound"] = k2_states_bound(xr0.shape)
            out["k2_mask_only"] = cuda_ms(lambda: noise_floor_mask(
                xr0, xi0, n_hop=3, n_frames=n_t), calls=CALLS)
            for what, key, shape in (("K1", "k1_step", xr.shape), ("K2 resumed", "k2_step",
                                                                     xs0.shape),
                                     ("K2 collect_states", "k2_collect", xr0.shape)):
                b_ms, b_by = out[f"{key}_bound"]
                log("9", f"{what} {tuple(shape)}, {CALLS} calls back to back: {out[key]:.4f} ms, "
                         f"bound {b_ms:.4f} ms ({b_by}), {b_ms / out[key]:.1%} of it [{CARD}]")
            log("9", f"K2 mask only {tuple(xr0.shape)} in the same call: "
                     f"{out['k2_mask_only']:.4f} ms [{CARD}]")
            del xr, xi, mask, xs0, xs1

        t0 = time.perf_counter()
        scores = tr.validate()
        out["val_s"] = time.perf_counter() - t0
        if not all(np.isfinite(v) for v in scores.values()):
            raise AssertionError(f"validation scores {scores}")
        log("9", f"validate() on {len(VAL_CLIPS)} x {seconds:g} s: {out['val_s']:.3f} s host "
                 "clock (val features extracted once at setup); " + ", ".join(
                     f"{k} {v:.4f}" for k, v in scores.items()) + f" [{CARD}]")
        out["scores"] = scores
        del tr

        preds = os.path.join(tmp, "preds")
        cli_predict.predict(exp["config"], exp["val_wav_dir"], preds, exp["group"], device=dev)
        csvs = sorted(os.listdir(preds))
        with open(os.path.join(exp_dir, "logs", "log.txt")) as f:
            restored = re.findall(r"restored (\S+)", f.read())
        best = os.path.join(exp_dir, "models", "best", "best.msgpack")
        if csvs != sorted(f"{n}.csv" for n in VAL_CLIPS) or restored[-1:] != [best]:
            raise AssertionError(f"cli.predict of the trained experiment: {csvs}, {restored}")
        log("9", f"cli.predict served the trained best.msgpack: {len(csvs)} CSVs, "
                 f"{sum(open(os.path.join(preds, c)).read().count(chr(10)) for c in csvs)} rows")
    return out


# phase 10: configs/seld.yml's fs and hop, blocks of 160 frames, 256 frames of
# context a side, 100 ms packets (salsa_tpu's streaming defaults); ragged packet
# sizes for the extraction check
STREAM = {"block_frames": 160, "context_frames": 256, "push_ms": 100.0}
RAGGED = (777, 1531, 4096, 50, 9000, 24000, 2400)


def push_ragged(se, waves, sizes=RAGGED) -> np.ndarray:
    """Push `waves` into a StreamingExtractor in irregular packets and flush; the
    frames concatenated."""
    blocks, i, k = [], 0, 0
    while i < waves.shape[-1]:
        m = sizes[k % len(sizes)]
        k += 1
        blocks += se.push(waves[..., i:i + m])
        i += m
    tail = se.flush()
    if tail.size:
        blocks.append(tail)
    return np.concatenate(blocks, axis=-2)


def record_blocks(se) -> list:
    """Wrap `se`'s block function: record each window and the tracker state the
    block leaves."""
    rec, fn = [], se._block_fn

    def recording(window, *args):
        feats, state = fn(window, *args)
        rec.append((window.clone(), state))
        return feats, state

    se._block_fn = recording
    return rec


def band0(window, p: SalsaParams = FOA):
    """Channel 0's DOA-band planes (N, bins, T) of block windows, K2's input."""
    re, im = chunked.block_spectra(window, p)
    return tuple(x[:, 0, :, p.lower_bin:p.upper_bin].transpose(-1, -2).contiguous()
                 for x in (re, im))


def check_stream_extraction(dev, n_streams: int, seconds: float, rng) -> float:
    """Streaming extraction on `dev` of n_streams seeded FOA streams in ragged
    packets against the plain versions on the CPU, then the tracker: the state
    leaving every block, chained through K2, bit-equal to K2 collect_states over
    the whole zero-led stream; K2 resumed at the block shape bit-equal to its plain
    version; a re-initialized row bit-equal to a solo stream's start and the rows
    it does not touch carried. Returns the spatial max abs error."""
    L = STREAM["block_frames"]
    waves = foa_clips(rng, n_streams, seconds)
    waves = waves[0] if n_streams == 1 else waves
    kw = dict(fs=FS, n_fft=N_FFT, hop_length=HOP, block_frames=L, n_streams=n_streams)
    se = StreamingExtractor("salsa", "foa", device=dev, **kw)
    rec = record_blocks(se)
    got = push_ragged(se, waves).reshape((-1, 7, 1 + waves.shape[-1] // HOP, FOA.freq_dim))
    want = push_ragged(StreamingExtractor("salsa", "foa", device="cpu", **kw), waves)
    want = want.reshape(got.shape)
    what = f"streamed features, {n_streams} x {seconds:g} s in {len(rec)} blocks"
    np.testing.assert_allclose(got[:, :4], want[:, :4], atol=2e-2, rtol=1e-3, err_msg=what)
    nb = FOA.upper_bin - FOA.lower_bin
    planes = lambda x: torch.from_numpy(  # noqa: E731
        np.ascontiguousarray(x[:, 4:, :, :nb].transpose(0, 1, 3, 2)))
    err = compare_spatial(planes(got), planes(want), what, phase="10")

    floors, countdowns = stream_tracker_states([w for w, _ in rec], FOA, L)
    for k, (_, (fl, cd)) in enumerate(rec[:-1]):
        if not (torch.equal(fl, floors[:, (k + 1) * L]) and torch.equal(cd, countdowns[:, (k + 1)
                                                                                       * L])):
            raise AssertionError(f"{what}: the tracker state leaving block {k} differs from K2 "
                                 "collect_states over the whole stream")
    xr0, xi0 = band0(rec[1][0])
    check_k2(xr0, xi0, L, f"resumed at the block shape {tuple(xr0.shape)}", state0=rec[0][1])
    # a slot starting its stream at block 1 (K2's restart flag) while the others
    # carry theirs: the block function's state, that of K2's restart launch held
    # against its plain version, and of a solo stream starting with that window
    row = n_streams - 1
    restart = torch.zeros(n_streams, dtype=torch.bool, device=xr0.device)
    restart[row] = True
    check_k2(xr0, xi0, L, f"restarting row {row} at the block shape", state0=rec[0][1],
             restart=restart)
    _, (fl, cd) = chunked.make_salsa_block_fn(FOA, L)(rec[1][0], rec[0][1], [row])
    _, (fl_solo, cd_solo) = noise_floor_mask(xr0[row:row + 1].contiguous(),
                                             xi0[row:row + 1].contiguous(), n_hop=3, n_frames=L)
    keep = [r for r in range(n_streams) if r != row]
    if not (torch.equal(fl[row], fl_solo[0]) and torch.equal(cd[row], cd_solo[0])
            and torch.equal(fl[keep], rec[1][1][0][keep])
            and torch.equal(cd[keep], rec[1][1][1][keep])):
        raise AssertionError(f"{what}: a re-initialized row is not a solo stream's start")
    log("10", f"{what}: the state leaving each block, chained through K2, bit-equal to K2 "
              f"collect_states over the whole stream; K2 resumed at {tuple(xr0.shape)} and K2 "
              f"restarting row {row} bit-equal to their plain versions; the restarted row "
              "bit-equal to a solo stream's start (K2's own init), the other rows carried")
    return err


def streaming_pipeline(dev, exp: dict, n_streams: int) -> StreamingSeldPipeline:
    """The served checkpoint's model and the experiment's feature type, as the CLI
    builds them, in a streaming pipeline at phase 10's geometry on `dev`."""
    cfg, d = exp["cfg"], exp["cfg"].data
    scaler = np.load(exp["scaler"])
    se = StreamingExtractor(cfg.feature_type, d.audio_format, block_frames=STREAM["block_frames"],
                            n_streams=n_streams, device=dev, **cli_predict.feature_kwargs(cfg))
    model = build_model(encoder=cfg.model.encoder.to_dict(), decoder=cfg.model.decoder.to_dict(),
                        n_classes=d.n_classes, output_format=d.output_format)
    return StreamingSeldPipeline(se, model, exp["weights"], (scaler["mean"], scaler["std"]),
                                 INTERP, d.n_classes, d.output_format,
                                 left_context=STREAM["context_frames"],
                                 right_context=STREAM["context_frames"])


def stream_push(pipe, waves, push: int):
    """Push waves in packets of `push` samples and flush; returns the outputs
    concatenated and the host-clock times, the card synchronized after every push
    that dispatched a block: `crnn`, the ms of each push that returned a
    prediction; `extract`, of each push that dispatched a block and predicted
    nothing (the blocks before the first window is complete); `ingest`, of each
    push that dispatched nothing (buffering and the mirror's upload);
    `steady_s` and `steady_samples`, the seconds and the samples a stream of the
    pushes after the first prediction; `flush_ms`."""
    sync = torch.cuda.synchronize if pipe.device.type == "cuda" else (lambda: None)
    outs, t = [], {"crnn": [], "extract": [], "ingest": [], "steady_samples": 0}
    t_first = None
    for i in range(0, waves.shape[-1], push):
        n0, t0 = StreamingSeldPipeline.dispatches, time.perf_counter()
        got = pipe.push(waves[..., i:i + push])
        dispatched = StreamingSeldPipeline.dispatches > n0
        if dispatched:
            sync()
        t["crnn" if got else "extract" if dispatched else "ingest"].append(
            (time.perf_counter() - t0) * 1e3)
        if t_first is not None:
            t["steady_samples"] += waves[..., i:i + push].shape[-1]
        elif got:
            t_first = time.perf_counter()
        outs += got
    sync()
    t["steady_s"] = 0.0 if t_first is None else time.perf_counter() - t_first
    t0 = time.perf_counter()
    outs += pipe.flush()
    sync()
    t["flush_ms"] = (time.perf_counter() - t0) * 1e3
    return (np.concatenate([o[0] for o in outs], axis=-2),
            np.concatenate([o[1] for o in outs], axis=-2)), t


def serve_stream_cli(dev, exp: dict, out_dir: str, **kw) -> dict:
    """One `cli.predict --streaming` call on `exp` with the kernels' launches and
    the block dispatches counted from 0, each CSV's arrays recorded; returns them,
    its host-clock seconds and its log line."""
    arrays, write = {}, cli_predict.write_classwise_csv

    def recording(path, ev, doa, *args, **kwargs):
        arrays[os.path.basename(path)[:-4]] = (ev, doa)
        return write(path, ev, doa, *args, **kwargs)

    cli_predict.write_classwise_csv = recording
    try:
        salsa_spatial.launches = noise_floor_mask.launches = 0
        StreamingSeldPipeline.dispatches = 0
        t0 = time.perf_counter()
        cli_predict.predict(exp["config"], exp["wav_dir"], out_dir, exp["group"], device=dev,
                            streaming=True, **STREAM, **kw)
        if dev.type == "cuda":
            torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        counts = {"salsa_spatial": salsa_spatial.launches, "noise_floor": noise_floor_mask.launches,
                  "dispatches": StreamingSeldPipeline.dispatches}
    finally:
        cli_predict.write_classwise_csv = write
    with open(exp["log"]) as f:
        line = re.findall(r"(?:pool-)?streamed .*", f.read())[-1]
    return {"arrays": arrays, "counts": counts, "secs": secs, "line": line}


def phase10(dev, scenes=SCENES, n_streams: int = 4, check_seconds: float = 9.7,
            timing=((1, 160.0), (4, 160.0), (16, 160.0)), cpu_clip_s: float = 4.0) -> dict:
    """Streaming serving: the extraction and tracker checks at N = 1 and
    n_streams, then `cli.predict --streaming` on phase 8's experiment four ways
    (one stream, n_streams streams a dispatch, int16 PCM, the pool with n_streams
    slots and --max-lag-ms 400) with the launches counted against the block
    dispatches, the outputs held against each other, a short clip on `dev`
    against the CPU's plain versions, then the per-block latencies, the first
    block cold and warm, and K1 and K2 at the block shapes."""
    cuda = dev.type == "cuda"
    L = STREAM["block_frames"]
    rng = np.random.default_rng(SEED + 10)
    out = {"k1_err": max(check_stream_extraction(dev, n, check_seconds, rng)
                         for n in sorted({1, n_streams}))}
    push = int(STREAM["push_ms"] * FS / 1000)
    with tempfile.TemporaryDirectory() as tmp:
        exp = write_experiment(tmp, scenes)

        # the first predicted block of a new pipeline (the first CRNN call at its
        # shapes in this process), then of the same pipeline reset: the blocks
        # before it are pushed first, the push that completes its window is timed
        pipe = streaming_pipeline(dev, exp, 1)
        first = foa_clips(rng, 1, (pipe._d * L + 8) * HOP / FS)[0]
        sync = torch.cuda.synchronize if cuda else (lambda: None)
        cold_warm = []
        for _ in range(2):
            pipe.reset()
            lead = pipe.push(first[..., :(pipe._d - 1) * L * HOP])
            sync()
            t0 = time.perf_counter()
            got = pipe.push(first[..., (pipe._d - 1) * L * HOP:])
            sync()
            cold_warm.append((time.perf_counter() - t0) * 1e3)
            if lead or len(got) != 1:
                raise AssertionError(f"expected the first prediction from the timed push, got "
                                     f"{len(lead)} before and {len(got)} from it")
        out["first_block_ms"] = cold_warm
        log("10", f"first predicted block of a new pipeline (the push completing its window), "
                  f"host clock: cold {cold_warm[0]:.2f} ms, after reset() {cold_warm[1]:.2f} ms "
                  f"[{CARD}]")

        # the main path: cli.predict --streaming, four ways
        runs = {}
        for name, kw in (("solo", {}), ("streams", {"streams": n_streams}),
                         ("pcm16", {"pcm16": True}),
                         ("pool", {"pool": True, "streams": n_streams, "max_lag_ms": 400.0})):
            runs[name] = serve_stream_cli(dev, exp, os.path.join(tmp, name), **kw)
            r = runs[name]
            csvs = sorted(os.listdir(os.path.join(tmp, name)))
            log("10", f"cli.predict --streaming {' '.join(f'--{k} {v}' for k, v in kw.items())}: "
                      f"{len(csvs)} CSVs in {r['secs']:.3f} s; launches {r['counts']} [{CARD}]")
            log("10", f"  its log: {r['line']} [{CARD}]")
            if csvs != sorted(f"{n}.csv" for n, _, _ in scenes):
                raise AssertionError(f"{name}: CSVs {csvs}, expected one per wav")
            c = r["counts"]
            want = c["dispatches"] if cuda else 0
            if not (c["dispatches"] > 0 and c["salsa_spatial"] == c["noise_floor"] == want):
                raise AssertionError(f"{name}: expected one K1 and one K2 launch per block "
                                     f"dispatch, got {c}")
        with open(exp["log"]) as f:
            if "zero-filled" in f.read():
                raise AssertionError("the pool zero-filled a stream on file replay")
        solo = runs["solo"]["arrays"]
        for name in ("streams", "pool"):
            d = max(float(np.abs(a - b).max()) for clip, pair in runs[name]["arrays"].items()
                    for a, b in zip(pair, solo[clip]))
            log("10", f"{name}: every clip's outputs within {d:.3e} of the single stream's "
                      "(bound 1e-4)")
            if d > 1e-4:
                raise AssertionError(f"{name}: a clip differs from its single stream by {d:.3e}")
        exact = [n for n, _, fs in scenes if fs == FS]
        if not all(np.array_equal(a, b) for n in exact
                   for a, b in zip(runs["pcm16"]["arrays"][n], solo[n])):
            raise AssertionError("--pcm16 is not bit-equal to the float push")
        log("10", f"--pcm16 bit-equal to the float push for the {len(exact)} 24 kHz 16-bit wavs; "
                  "the pool zero-filled nothing")
        out["launches"] = {k: sum(r["counts"][k] for r in runs.values())
                           for k in ("salsa_spatial", "noise_floor", "dispatches")}
        out["cli"] = {name: {"secs": r["secs"], "line": r["line"]} for name, r in runs.items()}

        # a short clip on the card against the CPU's plain versions (phase 4's bound)
        clip, _ = foa_scene(rng, cpu_clip_s, FS, exp["cfg"].data.label_rate)
        pipe.reset()
        (ev_g, doa_g), _ = stream_push(pipe, clip, push)
        t0 = time.perf_counter()
        (ev_c, doa_c), _ = stream_push(streaming_pipeline(torch.device("cpu"), exp, 1), clip, push)
        cpu_s = time.perf_counter() - t0
        for name, g, c in (("event_prob", ev_g, ev_c), ("doa", doa_g, doa_c)):
            err = np.abs(g - c)
            share = float(np.mean(err <= 2e-3))
            log("10", f"{cpu_clip_s:g} s clip streamed, {dev.type} vs CPU plain {name}: "
                      f"max abs err {err.max():.3e}, share within 2e-3 {share:.5f} "
                      f"(CPU {cpu_s:.1f} s)")
            if share < 0.999 or err.max() > 2e-2:
                raise AssertionError(f"streamed {name}, {dev.type} vs CPU: {share}, {err.max()}")

        # per-block latency and throughput, N synchronized streams in memory: the
        # pushes that ran the CRNN, the steady window after the first prediction
        # and the flush apart
        out["latency"] = {}
        for n, seconds in timing:
            pipe = streaming_pipeline(dev, exp, n)
            waves = foa_clips(rng, n, seconds)
            waves = waves[0] if n == 1 else waves
            stream_push(pipe, waves[..., :2 * L * HOP], push)  # warm-up
            pipe.reset()
            t0 = time.perf_counter()
            _, t = stream_push(pipe, waves, push)
            wall = time.perf_counter() - t0
            lat, ingest = t["crnn"], t["ingest"]
            p50, p95 = np.percentile(lat, 50), np.percentile(lat, 95)
            steady_x = n * t["steady_samples"] / FS / t["steady_s"]
            out["latency"][n] = {
                "p50_ms": float(p50), "p95_ms": float(p95), "max_ms": float(np.max(lat)),
                "blocks": len(lat), "extract_only_ms": t["extract"],
                "steady_x_realtime": steady_x, "x_realtime_with_flush": n * seconds / wall,
                "flush_ms": t["flush_ms"], "ingest_p50_ms": float(np.percentile(ingest, 50)),
                "ingest_ms_per_block": float(np.sum(ingest)) / len(lat)}
            log("10", f"{n} stream(s) x {seconds:g} s: per-block latency p50 {p50:.2f} / p95 "
                      f"{p95:.2f} / max {np.max(lat):.2f} ms over the {len(lat)} pushes that ran "
                      f"the CRNN; the {len(t['extract'])} that only extracted "
                      f"{', '.join(f'{x:.2f}' for x in t['extract'])} ms; steady "
                      f"{steady_x:.1f}x realtime aggregate over {t['steady_s']:.3f} s after the "
                      f"first prediction; flush {t['flush_ms']:.2f} ms; "
                      f"{n * seconds / wall:.1f}x realtime with the start and the flush (host "
                      f"clock, packets of {STREAM['push_ms']:g} ms); the {len(ingest)} pushes "
                      f"that only buffer: p50 {out['latency'][n]['ingest_p50_ms']:.3f} ms, "
                      f"{out['latency'][n]['ingest_ms_per_block']:.2f} ms a block [{CARD}]")
            if cuda and n == n_streams:
                pipe.reset()
                pipe.push(waves[..., :3 * L * HOP])
                packet = waves[..., 3 * L * HOP:4 * L * HOP]
                profile_table(lambda: pipe.push(packet), "10",
                              f"a push completing a block at N = {n}",
                              upload_bytes=packet.nbytes)
            del pipe

    # K1 and K2 at the block shapes, 10 calls back to back
    if cuda:
        out["kernels"] = {}
        win = chunked.block_window_len(L, 3, N_FFT, HOP)
        for n, _ in timing:
            window = torch.from_numpy(foa_clips(rng, n, win / FS + 0.01)[..., :win]).to(dev)
            re, im = chunked.block_spectra(window, FOA)
            xr, xi = (x[..., FOA.lower_bin:FOA.upper_bin].transpose(-1, -2).contiguous()
                      for x in (re, im))
            xr0, xi0 = xr[:, 0].contiguous(), xi[:, 0].contiguous()
            mask, state = noise_floor_mask(xr0, xi0, n_hop=3, n_frames=L)
            kw = spatial_kw(FOA)
            k1 = lambda: salsa_spatial(xr, xi, mask, **kw)  # noqa: E731
            k2 = lambda: noise_floor_mask(xr0, xi0, n_hop=3, n_frames=L, state0=state)  # noqa: E731
            t = {"k1_call": cuda_ms(k1, calls=CALLS), "k2_call": cuda_ms(k2, calls=CALLS),
                 "k1": kernel_device_ms(k1, "salsa_spatial_kernel"),
                 "k2": kernel_device_ms(k2, "noise_floor_kernel"),
                 "k1_bound": k1_bound(xr.shape), "k2_bound": k2_bound(xr0.shape)}
            out["kernels"][n] = t
            for k, shape in (("k1", xr.shape), ("k2", xr0.shape)):
                b_ms, b_by = t[f"{k}_bound"]
                dev_ms = "not measured" if t[k] is None else \
                    f"{t[k]:.4f} ms, {b_ms / t[k]:.1%} of the bound"
                log("10", f"{k.upper()} at the block shape {tuple(shape)}: {CALLS} wrapper calls "
                          f"back to back {t[k + '_call']:.4f} ms a call (CUDA events); the kernel "
                          f"alone {dev_ms} (profiler device time a launch); bound {b_ms:.4f} ms "
                          f"({b_by}) [{CARD}]")
    return out


# ---------------------------------------------------------------------------
# phase 11: the rest of the feature bank, and configs/seld_salsa_lite.yml

LITE_YML = os.path.join(REPO, "configs", "seld_salsa_lite.yml")
# (feature_type, audio_format, options) on seeded 4 x 60 s clips: the 7 frame-local
# types, SALSA through K1 and K2, SALSA without tracking and on the XLA power branch
BANK = (("salsa_lite", "mic", {}), ("salsa_ipd", "mic", {}), ("linspeciv", "foa", {}),
        ("melspeciv", "foa", {}), ("linspecgcc", "mic", {}), ("melspecgcc", "mic", {}),
        ("melspec", "foa", {}), ("salsa", "foa", {}), ("salsa", "mic", {"is_tracking": False}),
        ("salsa", "foa", {"eig_method": "power"}))
# tests/test_golden_features.py's cases and bounds: (golden key, type, format,
# options, spectrogram atol, other channels' atol); SALSA on the exact eigensolver,
# which runs at the golden's 1 s only
GOLDEN_BANK = (("melspec", "melspec", "foa", {"n_mels": 128}, None),
               ("melspeciv", "melspeciv", "foa", {"n_mels": 128}, 1e-3),
               ("melspecgcc", "melspecgcc", "mic", {"n_mels": 128}, 2e-3),
               ("linspeciv", "linspeciv", "foa", {}, 1e-3),
               ("linspecgcc", "linspecgcc", "mic", {}, 2e-3),
               ("salsa_foa", "salsa", "foa", {"eig_method": "eigh"}, None),
               ("salsa_mic", "salsa", "mic", {"eig_method": "eigh"}, None))
# against the CPU: at least 99.99 % of cells within atol 2e-4, rtol 1e-4, and every
# cell within (atol, rtol) of its group: the golden bounds of the spectrograms, IVs
# and GCCs, K1's spatial bound for the IPDs. In a bin near a spectral null the power
# is a small difference of large terms, so the two devices' DFT sums, taken in
# other orders, part there by more than the first bound (tests/test_torch_features.py)
ALL_CELLS = {"spec": (2e-2, 1e-3), "iv": (1e-3, 1e-2), "gcc": (2e-3, 1e-2), "ipd": (5e-3, 1e-2)}
LITE_SCENES = tuple((f"mic_{c}", 60.0, FS) for c in "abcd") + (
    ("mic_short", 20.7, FS), ("mic_48k", 30.0, 48000))


def mic_clips(rng: np.random.Generator, n_clips: int, seconds: float) -> np.ndarray:
    """(n_clips, 4, n) float32 MIC-array clips: diffuse noise and, per clip, a
    broadband burst plus a tone that four mics hear 0-4 samples apart."""
    n = int(round(seconds * FS))
    t = np.arange(n) / FS
    out = 0.02 * rng.standard_normal((n_clips, 4, n))
    for b in range(n_clips):
        on = (t % 10.0) < rng.uniform(3.0, 7.0)
        src = (0.2 * rng.standard_normal(n) + np.sin(2 * np.pi * rng.uniform(300, 3000) * t)) * on
        for m, d in enumerate(rng.integers(0, 5, 4)):
            out[b, m, d:] += src[:n - d]
    return out.astype(np.float32)


def close_cells(got: np.ndarray, want: np.ndarray, group: str, what: str) -> float:
    """ALL_CELLS's bound for one channel group; returns the max abs error."""
    share = float(np.isclose(got, want, atol=2e-4, rtol=1e-4).mean())
    if share < 0.9999:
        raise AssertionError(f"{what} {group}: {share:.6f} of cells within 2e-4 / 1e-4")
    atol, rtol = ALL_CELLS[group]
    np.testing.assert_allclose(got, want, atol=atol, rtol=rtol, err_msg=f"{what} {group}")
    return float(np.abs(got - want).max())


def compare_feature(got: torch.Tensor, want: torch.Tensor, ft: str, ex, what: str,
                    tag: str = "11") -> float:
    """A feature map (B, C, T, F) on one device against the same on another: the
    spectrograms, IVs, GCCs and the IPDs (on their circle) by `close_cells`,
    SALSA's spatial channels by `compare_spatial` (MIC phases on their circle).
    Returns the max abs error over the channels after the spectrograms."""
    got, want = got.cpu().numpy(), want.cpu().numpy()
    if got.shape != want.shape or not np.isfinite(got).all():
        raise AssertionError(f"{what}: shape {got.shape} vs {want.shape} or non-finite")
    spec = close_cells(got[:, :4], want[:, :4], "spec", what)
    if ft in ("salsa_lite", "salsa_ipd"):
        p = ex.fn.params
        period = (2 * np.pi / phase_scale(p).astype(np.float64))[p.lower_bin:p.cutoff_bin]
        g, w = got[:, 4:], want[:, 4:]
        rest = close_cells(g - np.round((g - w) / period) * period, w, "ipd", what)
    elif ft == "salsa":
        p = ex.fn.keywords["params"]
        nb = p.upper_bin - p.lower_bin
        if got[:, 4:, :, nb:].any():
            raise AssertionError(f"{what}: spatial features above the DOA band")
        rest = compare_spatial(*(torch.from_numpy(np.ascontiguousarray(
            x[:, 4:, :, :nb].transpose(0, 1, 3, 2))) for x in (got, want)), what, phase=tag,
            period=mic_period(p, nb) if p.audio_format == "mic" else None)
    elif got.shape[1] > 4:
        rest = close_cells(got[:, 4:], want[:, 4:], "gcc" if ft.endswith("gcc") else "iv", what)
    else:
        rest = 0.0
    log(tag, f"{what}: spectrogram max abs err {spec:.3e} dB, the other channels "
             f"{rest:.3e}")
    return rest


def bank_on_clips(dev, seconds: float, n_clips: int, rng) -> dict:
    """Every case of BANK on seeded clips (FOA clips for the FOA types, a MIC
    array for the MIC types) on `dev`, with K1's and K2's launches counted, held
    against the port's CPU run: of every clip for the frame-local types, of the
    first for SALSA (its plain tracker loops over frames on the CPU); timed."""
    cuda = dev.type == "cuda"
    clips = {"foa": foa_clips(rng, n_clips, seconds), "mic": mic_clips(rng, n_clips, seconds)}
    out = {}
    for ft, fmt, opts in BANK:
        ex = make_extractor(ft, fmt, fs=FS, n_fft=N_FFT, hop_length=HOP, **opts)
        name = "-".join([ft, fmt] + [f"{k}={v}" for k, v in opts.items()])
        waves = torch.from_numpy(clips[fmt]).to(dev)
        salsa_spatial.launches = noise_floor_mask.launches = 0
        with torch.inference_mode():
            got = ex(waves)
            if cuda:
                torch.cuda.synchronize()
            launches = {"salsa_spatial": salsa_spatial.launches,
                        "noise_floor": noise_floor_mask.launches}
            p = ex.fn.keywords["params"] if ft == "salsa" else None
            want = {"salsa_spatial": int(cuda and p is not None and p.uses_k1),
                    "noise_floor": int(cuda and p is not None and p.is_tracking)}
            if launches != want:
                raise AssertionError(f"{name}: launches {launches}, expected {want}")
            ms = cuda_ms(lambda: ex(waves)) if cuda else float("nan")
            n_cpu = 1 if ft == "salsa" else n_clips
            t0 = time.perf_counter()
            ref = ex(torch.from_numpy(clips[fmt][:n_cpu]))
            cpu_s = time.perf_counter() - t0
        err = compare_feature(got[:n_cpu], ref, ft, ex,
                              f"{name} {tuple(got.shape)} on {dev.type} vs the CPU's "
                              f"{n_cpu} clip(s)")
        out[name] = {"ms": ms, "launches": launches, "err": err, "cpu_s": cpu_s}
        log("11", f"{name}: {n_clips} x {seconds:g} s in {ms:.3f} ms (CUDA events, median of "
                  f"7), {ms / n_clips:.3f} ms a clip; launches {launches}; the CPU's "
                  f"{n_cpu} clip(s) {cpu_s:.2f} s [{CARD}]")
    return out


def bank_on_golden(dev) -> None:
    """GOLDEN_BANK on `dev` against tests/golden/reference_features.npz."""
    golden = np.load(GOLDEN)
    audio = torch.from_numpy(golden["audio"])[None].to(dev)
    for key, ft, fmt, opts, rest_atol in GOLDEN_BANK:
        ex = make_extractor(ft, fmt, fs=int(golden["fs"]), n_fft=int(golden["n_fft"]),
                            hop_length=int(golden["hop"]), **opts)
        with torch.inference_mode():
            got = ex(audio)[0].cpu().numpy()
        want = golden[key]
        if got.shape != want.shape:
            raise AssertionError(f"golden {key}: shape {got.shape} vs {want.shape}")
        np.testing.assert_allclose(got[:4], want[:4], atol=2e-2, rtol=1e-3, err_msg=key)
        msg = f"golden {key} ({ft} {fmt} {opts}) {got.shape}: spec max err " \
              f"{np.abs(got[:4] - want[:4]).max():.3e} dB"
        if ft == "salsa":
            ref_mask, got_mask = np.any(want[4:] != 0, axis=0), np.any(got[4:] != 0, axis=0)
            disagree = float(np.mean(ref_mask != got_mask))
            if disagree >= 0.01:
                raise AssertionError(f"golden {key}: masks disagree on {disagree:.3%}")
            both = ref_mask & got_mask
            np.testing.assert_allclose(got[4:][:, both], want[4:][:, both], atol=5e-3,
                                       rtol=1e-2, err_msg=key)
            msg += f", mask disagreement {disagree:.4%}"
        elif rest_atol is not None:
            np.testing.assert_allclose(got[4:], want[4:], atol=rest_atol, rtol=1e-2, err_msg=key)
            msg += f", other channels max err {np.abs(got[4:] - want[4:]).max():.3e}"
        log("11", msg + " (tests/test_golden_features.py's bounds)")


def lite_requests(dev, rng, request_seconds=(60.0, 60.0, 20.7)) -> dict:
    """configs/seld_salsa_lite.yml at full width, random seeded weights: three
    requests (4, 2 and 1 MIC clips) through SeldInferencePipeline with K1 and K2
    counted (0), each clip equal to its solo run, one clip on the device against
    the CPU's run, and the request's times."""
    cuda = dev.type == "cuda"
    cfg = load_config(LITE_YML)
    d = cfg.data
    model = init_random_(build_model(encoder=cfg.model.encoder.to_dict(),
                                     decoder=cfg.model.decoder.to_dict(), n_classes=d.n_classes,
                                     output_format=d.output_format),
                         torch.Generator().manual_seed(SEED + 30))
    ex = make_extractor(cfg.feature_type, d.audio_format, **cli_predict.feature_kwargs(cfg))
    scaler = (rng.normal(-5.0, 1.0, (4, 1, ex.n_features)).astype(np.float32),
              rng.uniform(5.0, 8.0, (4, 1, ex.n_features)).astype(np.float32))
    pipe = SeldInferencePipeline(ex, model, None, scaler, INTERP, d.n_classes, d.output_format,
                                 device=dev)
    requests = [mic_clips(rng, n, s) for n, s in zip((4, 2, 1), request_seconds)]
    salsa_spatial.launches = noise_floor_mask.launches = 0
    outs = [pipe(w) for w in requests]
    launches = {"salsa_spatial": salsa_spatial.launches, "noise_floor": noise_floor_mask.launches}
    log("11", f"seld_salsa_lite: served {len(requests)} requests {[w.shape for w in requests]}; "
              f"launches {launches}")
    if launches != {"salsa_spatial": 0, "noise_floor": 0}:
        raise AssertionError(f"seld_salsa_lite launched K1 or K2: {launches}")
    for w, (ev, doa) in zip(requests, outs):
        n_labels = int(round(((1 + w.shape[-1] // HOP) // 16) * INTERP))
        check_outputs(ev, doa, w.shape[0], n_labels, f"seld_salsa_lite request {w.shape}")
        for b in range(w.shape[0]):
            ev1, doa1 = pipe(w[b:b + 1])
            diff = max(np.abs(ev1[0] - ev[b]).max(), np.abs(doa1[0] - doa[b]).max())
            if diff > 1e-4:
                raise AssertionError(f"seld_salsa_lite {w.shape} clip {b}: solo differs by {diff}")
    clip = requests[0][:1]
    cpu_pipe = SeldInferencePipeline(ex, copy.deepcopy(pipe.model).cpu(), None, scaler, INTERP,
                                     d.n_classes, d.output_format, device="cpu")
    ev_c, doa_c = cpu_pipe(clip)
    out = {"launches": launches}
    for name, g, c in (("event_prob", outs[0][0][:1], ev_c), ("doa", outs[0][1][:1], doa_c)):
        err = np.abs(g - c)
        share = float(np.mean(err <= 2e-3))
        log("11", f"seld_salsa_lite {dev.type} vs CPU {name}: max abs err {err.max():.3e}, "
                  f"share within 2e-3 {share:.5f}")
        if share < 0.999 or err.max() > 2e-2:
            raise AssertionError(f"seld_salsa_lite {name}: share {share}, max {err.max()}")
        out[f"{name}_err"] = float(err.max())
    if cuda:
        req = requests[0]
        times = []
        for _ in range(8):
            t0 = time.perf_counter()
            pipe(req)
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
        out["request_ms"] = statistics.median(times[1:])
        waves = torch.from_numpy(req).to(dev)
        with torch.inference_mode():
            feats = pipe._normalize(ex(waves))
            out["extract_ms"] = cuda_ms(lambda: ex(waves))
            out["crnn_ms"] = cuda_ms(lambda: pipe.model(feats))
        secs = req.shape[0] * req.shape[-1] / FS
        log("11", f"seld_salsa_lite request {req.shape}: {out['request_ms']:.2f} ms median of 7 "
                  f"(host clock), {secs / out['request_ms'] * 1e3:.1f}x realtime; extraction "
                  f"{out['extract_ms']:.3f} ms, CRNN {out['crnn_ms']:.2f} ms (CUDA events) "
                  f"[{CARD}]")
        profile_table(lambda: pipe(req), "11", "one seld_salsa_lite request",
                      upload_bytes=req.nbytes)
    return out


def lite_train(dev, seconds: float = 60.0, overrides=()) -> dict:
    """configs/seld_salsa_lite.yml trained from raw wavs: 4 chunks on the device
    against the full-clip slices, the first step's loss against the CPU's, then
    `cli.train` for one epoch of 6 steps with K1 and K2 counted (0), the steps
    timed, validation and the trained experiment served."""
    cuda = dev.type == "cuda"
    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        exp = write_train_experiment(tmp, seconds, overrides=("training.max_epochs=1",
                                                              *overrides), config=LITE_YML)
        tr = cli_train.build_trainer(exp["config"], exp["group"], exp_suffix="_check",
                                     device=dev)
        clip0 = np.flatnonzero(tr.train_data.clip_of_chunk == 0)
        ids = np.array([clip0[0], clip0[len(clip0) // 2], clip0[-1],
                        np.flatnonzero(tr.train_data.clip_of_chunk == 1)[0]])
        i = torch.as_tensor(ids, device=dev)
        d = exp["cfg"].data
        ex = make_extractor(exp["cfg"].feature_type, d.audio_format,
                            **cli_predict.feature_kwargs(exp["cfg"]))
        with torch.inference_mode():
            got = tr.chunk_fn(tr._waves, tr._clip[i], tr._f0[i], tr._n_full[i], None, None,
                              tr.wav_scale)
            full = ex(torch.from_numpy(np.stack(tr.train_data.clip_wavs[:2])).to(dev))
            L = tr.chunk_len
            want = torch.stack([full[int(tr._clip[c]), :, int(tr._f0[c]):int(tr._f0[c]) + L]
                                for c in ids])
        out["chunk_err"] = compare_feature(got, want, "salsa_lite", ex,
                                           f"seld_salsa_lite: 4 chunks {tuple(got.shape)} vs "
                                           "the full-clip slices")
        out["first_step_rel"] = first_step_loss(tr, dev, "11")
        del tr
        if cuda:
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats(dev)
        tr, launches, wall = counted_train(dev, exp["config"], exp["group"])
        peak = torch.cuda.max_memory_allocated(dev) / 2**30 if cuda else float("nan")
        n_steps = tr.steps_per_epoch * tr.max_epochs
        log("11", f"seld_salsa_lite cli.train: {len(TRAIN_CLIPS)} x {seconds:g} s MIC train "
                  f"clips, {n_steps} steps at batch {tr.batch_size}: {wall:.2f} s host clock; "
                  f"launches {launches}; peak memory {peak:.2f} GiB; setup " + ", ".join(
                      f"{k} {v:.3f} s" for k, v in tr.setup_seconds.items()) + f" [{CARD}]")
        if any(launches.values()) or "tracker_checkpoints" in tr.setup_seconds:
            raise AssertionError(f"seld_salsa_lite training launched K1 or K2: {launches}")
        times = timed_steps(tr, dev, TIMED_STEPS)
        chunk_s = tr.chunk_len * d.hop_len / d.fs
        log("11", f"seld_salsa_lite train step, median of steps 3-{TIMED_STEPS}: "
                  f"{times['step']:.2f} ms = extraction {times['extract']:.2f} + forward and "
                  f"backward {times['fwd_bwd']:.2f} + optimizer {times['optimizer']:.2f} ms; "
                  f"{1e3 / times['step']:.2f} steps/s, "
                  f"{tr.batch_size * chunk_s * 1e3 / times['step']:.1f}x realtime [{CARD}]")
        scores = tr.validate()
        if not all(np.isfinite(v) for v in scores.values()):
            raise AssertionError(f"seld_salsa_lite validation scores {scores}")
        out.update(launches=launches, step=times, peak_gib=peak, wall_s=wall, scores=scores,
                   n_steps=n_steps)
    return out


def phase11(dev, seconds: float = 60.0, n_clips: int = 4, scenes=LITE_SCENES,
            request_seconds=(60.0, 60.0, 20.7), train_seconds: float = 60.0,
            train_overrides=(), stream_seconds: float = 60.0, n_streams: int = 4) -> dict:
    """The rest of the feature bank on `dev`: every type on seeded clips against
    its CPU run, at the golden's 1 s against the fixture; then
    configs/seld_salsa_lite.yml at full width served in memory, from disk by
    `cli.predict` (CSVs byte-identical to the in-memory pipeline's), trained from
    wav by `cli.train`, and streamed by `cli.predict --streaming --streams N`, with
    K1 and K2 counted on every salsa_lite run (0); then the per-type extraction
    bench on the card."""
    cuda = dev.type == "cuda"
    if cuda:  # a card that slows down mid-run shows here (SM clock, power, temperature)
        log("11", f"card: {smi('clocks.sm,power.draw,temperature.gpu')}")
    rng = np.random.default_rng(SEED + 20)
    out = {"bank": bank_on_clips(dev, seconds, n_clips, rng)}
    bank_on_golden(dev)
    out["requests"] = lite_requests(dev, rng, request_seconds)
    lite = [out["requests"]["launches"]]
    with tempfile.TemporaryDirectory() as tmp:
        exp = write_experiment(tmp, scenes, config=LITE_YML)
        out["disk"] = serve_from_disk(dev, exp, tmp, tag="11")
        lite.append(out["disk"]["launches"])
        r = serve_stream_cli(dev, exp, os.path.join(tmp, "streams"), streams=n_streams)
        csvs = sorted(os.listdir(os.path.join(tmp, "streams")))
        log("11", f"seld_salsa_lite cli.predict --streaming --streams {n_streams}: {len(csvs)} "
                  f"CSVs in {r['secs']:.3f} s; launches {r['counts']} [{CARD}]")
        log("11", f"  its log: {r['line']} [{CARD}]")
        if csvs != sorted(f"{n}.csv" for n, _, _ in scenes) or r["counts"]["dispatches"] < 1:
            raise AssertionError(f"seld_salsa_lite streaming: CSVs {csvs}, {r['counts']}")
        lite.append({k: r["counts"][k] for k in ("salsa_spatial", "noise_floor")})
        out["stream_cli"] = {"secs": r["secs"], "line": r["line"], "counts": r["counts"]}
        # per-block latency at N streams in memory, as phase 10 reads it
        pipe = streaming_pipeline(dev, exp, n_streams)
        waves = mic_clips(rng, n_streams, stream_seconds)
        push = int(STREAM["push_ms"] * FS / 1000)
        stream_push(pipe, waves[..., :2 * STREAM["block_frames"] * HOP], push)  # warm-up
        pipe.reset()
        salsa_spatial.launches = noise_floor_mask.launches = 0
        _, t = stream_push(pipe, waves, push)
        lite.append({"salsa_spatial": salsa_spatial.launches,
                     "noise_floor": noise_floor_mask.launches})
        lat = t["crnn"]
        out["stream"] = {"p50_ms": float(np.percentile(lat, 50)),
                         "p95_ms": float(np.percentile(lat, 95)), "blocks": len(lat),
                         "steady_x_realtime": n_streams * t["steady_samples"] / FS / t["steady_s"]}
        log("11", f"seld_salsa_lite {n_streams} streams x {stream_seconds:g} s: per-block "
                  f"latency p50 {out['stream']['p50_ms']:.2f} / p95 {out['stream']['p95_ms']:.2f} "
                  f"ms over the {len(lat)} pushes that ran the CRNN; steady "
                  f"{out['stream']['steady_x_realtime']:.1f}x realtime aggregate [{CARD}]")
        del pipe
    out["train"] = train = lite_train(dev, train_seconds, train_overrides)
    lite.append({k: train["launches"][k] for k in ("salsa_spatial", "noise_floor")})
    out["lite_launches"] = {k: sum(c[k] for c in lite) for k in ("salsa_spatial", "noise_floor")}
    log("11", f"K1 and K2 launches over every seld_salsa_lite run: {out['lite_launches']}")
    if any(out["lite_launches"].values()):
        raise AssertionError(f"seld_salsa_lite launched K1 or K2: {out['lite_launches']}")
    if cuda:
        torch.cuda.empty_cache()
        log("11", f"card: {smi('clocks.sm,power.draw,temperature.gpu')}")
        log("11", f"bench_features, 8 x 60 s clips a call, 5 calls [{CARD}]")
        out["bench"] = bench_features.main([])
    return out


# phase 12: configs/seld.yml and configs/seld_salsa_lite.yml with
# training.device_augment, and cli.train resumed; a constant lr (and beta1: the
# config's moms are constant) so that the total step count, which differs between
# a 2-epoch run and a 4-epoch one, does not enter the schedule
AUG_OVERRIDES = ("training.device_augment=true",)
CONSTANT_LR = "training.lr_scheduler.lrs=[3.0e-4,3.0e-4,3.0e-4,3.0e-4]"


@contextlib.contextmanager
def recorded_epochs():
    """[(epoch, its step losses)] of every epoch a SeldTrainer trains meanwhile, in
    order."""
    epochs, train_epoch = [], SeldTrainer.train_epoch

    def recording(self, epoch):
        metrics = train_epoch(self, epoch)
        epochs.append((epoch, list(self.step_losses)))
        return metrics

    SeldTrainer.train_epoch = recording
    try:
        yield epochs
    finally:
        SeldTrainer.train_epoch = train_epoch


@contextlib.contextmanager
def deterministic(dev):
    """cuDNN's deterministic algorithms and torch's deterministic mode, with a
    warning (recorded, each once) from every op that has no deterministic form,
    for the duration. Two runs of the same steps then take the same arithmetic,
    so the resume check reads the checkpoint, not the order of the card's
    atomic adds. Yields the warnings' messages."""
    if dev.type != "cuda":
        yield []
        return
    saved = (torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark,
             torch.are_deterministic_algorithms_enabled(),
             torch.is_deterministic_algorithms_warn_only_enabled())
    torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = True, False
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("default")
            messages = []
            yield messages
            messages.extend(sorted({str(w.message).split("\n")[0][:160] for w in caught
                                    if "deterministic" in str(w.message)}))
    finally:
        torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = saved[:2]
        torch.use_deterministic_algorithms(saved[2], warn_only=saved[3])


def check_cutouts(tr, dev) -> int:
    """One step's augmented batch on the device: inside every sample's cutout
    rectangles its trailing 3 spatial channels are 0. Returns the number of
    samples that drew a cutout."""
    tr.seed_step()
    x, sed, doa = tr.batch(tr._epoch_order(0)[:tr.batch_size])
    draws = tr.augment.draw(tr.batch_size, tr.augment_generator).to(dev)
    got = tr.augment.apply(draws, x, sed, doa)[0]
    t = torch.arange(tr.chunk_len, device=dev)[None, None, :, None]
    f = torch.arange(got.shape[-1], device=dev)[None, None, None, :]
    top, h, left, w = (draws.rects[..., k, None, None] for k in range(4))
    covered = ((t >= top) & (t < top + h) & (f >= left) & (f < left + w)).any(1)  # (B, T, F)
    n_cut = int(covered.flatten(1).any(1).sum())
    spatial = got[:, -3:].masked_select(covered[:, None].expand(-1, 3, -1, -1))
    if n_cut == 0 or bool((spatial != 0).any()):
        raise AssertionError(f"salsa_lite cutouts: {n_cut} samples cut, "
                             f"{int((spatial != 0).sum())} spatial cells inside them not 0")
    return n_cut


def phase12(dev, seconds: float = 60.0, overrides=(), timed: int = TIMED_STEPS) -> dict:
    """Augmented and resumed training from raw wavs: configs/seld.yml with
    training.device_augment (the FOA swaps and shift) checked on its first step
    against the CPU's plain versions on the same draws, then `cli.train` with K1
    and K2 counted in every step and the augmentation's time a step; `cli.train`
    for 2 epochs resumed to 4 against a fresh 4-epoch run; then
    configs/seld_salsa_lite.yml augmented (the MIC swaps, shift and cutouts) with
    K1 and K2 launching 0 times."""
    cuda = dev.type == "cuda"
    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        exp = write_train_experiment(tmp, seconds, overrides=(*AUG_OVERRIDES, *overrides))
        tr = cli_train.build_trainer(exp["config"], exp["group"], exp_suffix="_check",
                                     device=dev)
        out["first_step_rel"] = first_step_loss(tr, dev, "12")
        del tr
        if cuda:
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats(dev)

        # the main path: augmented cli.train, as a user runs it
        tr, launches, wall = counted_train(dev, exp["config"], exp["group"])
        n_steps = tr.steps_per_epoch * tr.max_epochs
        peak = torch.cuda.max_memory_allocated(dev) / 2**30 if cuda else float("nan")
        log("12", f"augmented cli.train (configs/seld.yml, device_augment true): "
                  f"{len(TRAIN_CLIPS)} x {seconds:g} s train clips, {tr.max_epochs} epochs of "
                  f"{tr.steps_per_epoch} steps at batch {tr.batch_size}: {wall:.2f} s host "
                  f"clock; launches {launches}; peak memory {peak:.2f} GiB [{CARD}]")
        if cuda:
            check_train_launches(launches, n_steps, "augmented cli.train")
        times = timed_steps(tr, dev, timed)
        chunk_s = tr.chunk_len * exp["cfg"].data.hop_len / exp["cfg"].data.fs
        log("12", f"augmented train step, median of steps 3-{timed}: {times['step']:.2f} ms = "
                  f"extraction {times['extract']:.2f} + augmentation {times['augment']:.3f} + "
                  f"forward and backward {times['fwd_bwd']:.2f} + optimizer "
                  f"{times['optimizer']:.2f} ms; {1e3 / times['step']:.2f} steps/s, "
                  f"{tr.batch_size * chunk_s * 1e3 / times['step']:.1f}x realtime [{CARD}]")
        if cuda:
            ids = tr._epoch_order(tr.max_epochs + 1)[:tr.batch_size]
            out["profile"] = profile_table(lambda: tr.train_step(ids), "12",
                                           "one augmented train step", top=16)
        out.update(launches=launches, step=times, peak_gib=peak, wall_s=wall, n_steps=n_steps)
        del tr

        # --resume: 2 epochs, then resumed to 4, against a fresh 4-epoch run, all
        # three in deterministic mode: with cuDNN's default algorithms two fresh
        # runs part by ~1e-2 over 24 steps (Adam turns the atomics' rounding into
        # whole-lr steps), which would hide what the resume does
        with deterministic(dev) as nondeterministic:
            with recorded_epochs() as run:
                counted_train(dev, exp["config"], exp["group"], exp_suffix="_resume",
                              overrides=[CONSTANT_LR])
                tr, launches, wall = counted_train(
                    dev, exp["config"], exp["group"], exp_suffix="_resume", resume=True,
                    overrides=[CONSTANT_LR, "training.max_epochs=4"])
            with recorded_epochs() as fresh:
                counted_train(dev, exp["config"], exp["group"], exp_suffix="_fresh",
                              overrides=[CONSTANT_LR, "training.max_epochs=4"])
        order = ([e for e, _ in run], [e for e, _ in fresh])
        if order != ([0, 1, 2, 3], [0, 1, 2, 3]):
            raise AssertionError(f"the runs trained epochs {order}: the resumed call must "
                                 "train epochs 2 and 3 only")
        got, want = (np.array([losses for _, losses in r[2:]]) for r in (run, fresh))
        rel = float(np.max(np.abs(got - want) / np.abs(want)))
        log("12", f"cli.train resumed from epoch001 at step {2 * tr.steps_per_epoch} to 4 "
                  f"epochs (augmented, constant lr; K1 {launches['salsa_spatial']}, K2 "
                  f"{launches['noise_floor']} launches in the resumed call): epochs 2-3's "
                  f"{got.size} step losses within {rel:.2e} relative of a fresh 4-epoch run's "
                  "(bound 1e-4; all three runs in deterministic mode; ops without a "
                  f"deterministic form: {nondeterministic or 'none'})")
        if not rel < 1e-4:
            raise AssertionError(f"resumed step losses {got} vs fresh {want}")
        out.update(resume_rel=rel, resume_launches=launches)
        del tr

        # configs/seld_salsa_lite.yml augmented: the MIC swaps, the shift, the cutouts
        lite = write_train_experiment(os.path.join(tmp, "lite"), seconds, overrides=(
            "training.max_epochs=1", *AUG_OVERRIDES, *overrides), config=LITE_YML)
        tr, launches, wall = counted_train(dev, lite["config"], lite["group"])
        n_cut = check_cutouts(tr, dev)
        times = timed_steps(tr, dev, timed)
        log("12", f"augmented seld_salsa_lite cli.train: {tr.steps_per_epoch * tr.max_epochs} "
                  f"steps at batch {tr.batch_size} in {wall:.2f} s host clock; launches "
                  f"{launches}; a step {times['step']:.2f} ms, augmentation "
                  f"{times['augment']:.3f} ms; {n_cut} of {tr.batch_size} samples cut, their "
                  f"trailing 3 spatial channels 0 inside every cutout [{CARD}]")
        if any(launches.values()):
            raise AssertionError(f"augmented seld_salsa_lite training launched K1 or K2: "
                                 f"{launches}")
        out["lite"] = {"launches": launches, "step": times, "wall_s": wall, "n_cut": n_cut}
    return out


# phase 13: cli.infer (plain, --tta, --tune-threshold) and cli.ensemble on phase 9's
# experiment, two members trained from seeds; accdoa reads the same weights
MEMBER_SEEDS = (SEED, SEED + 1)
FUSED_GATE = 1e-4  # fused against sequential TTA on the card


def extraction_batches(lengths, batch_size: int = 8) -> int:
    """The extractor calls `data.wav_database.extract_split_to_store` makes for clips
    of these sample counts: clips of equal length batch, batch_size a call."""
    return sum(-(-len(g) // batch_size) for g in length_groups(list(lengths), int))


def check_infer_launches(launches: dict, n_batches: int, what: str) -> None:
    """K1 and K2 once per extraction batch of the split, and nowhere else."""
    want = {"salsa_spatial": n_batches, "noise_floor": n_batches}
    if launches != want:
        raise AssertionError(f"{what} launched {launches}: expected {want}, one K1 and one "
                             "K2 launch per extraction batch of the split")


def differing_files(got_dir: str, want_dir: str) -> list[str]:
    """The names of the files whose bytes differ between two directories or that
    only one of them holds."""
    def read(d, name):
        path = os.path.join(d, name)
        return open(path, "rb").read() if os.path.isfile(path) else None

    names = sorted(set(os.listdir(got_dir)) | set(os.listdir(want_dir)))
    return [n for n in names if read(got_dir, n) is None or read(got_dir, n) != read(want_dir, n)]


@contextlib.contextmanager
def recorded_predictions(dev):
    """{"predict_s": host-clock seconds of every SeldPredictor.predict_split call
    (the card synchronized before and after), "batches": the batch size of every
    eval dispatch}, meanwhile."""
    rec = {"predict_s": [], "batches": []}
    predict, step = SeldPredictor.predict_split, SeldPredictor.eval_step

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    def timed(self, *args, **kwargs):
        sync()
        t0 = time.perf_counter()
        written = predict(self, *args, **kwargs)
        sync()
        rec["predict_s"].append(time.perf_counter() - t0)
        return written

    def counted(self, x):
        rec["batches"].append(int(x.shape[0]))
        return step(self, x)

    SeldPredictor.predict_split, SeldPredictor.eval_step = timed, counted
    try:
        yield rec
    finally:
        SeldPredictor.predict_split, SeldPredictor.eval_step = predict, step


def counted_infer(dev, exp: dict, config: str, suffix: str, out_dir: str, **kwargs):
    """`cli.infer --splits val` of the member `suffix` as a user runs it, with K1
    and K2 counted from 0; val's CSVs and dumps copied to <out_dir>/csv and
    <out_dir>/pred. Returns (results, launches, {"wall_s", "predict_s",
    "batches", "peak_gib"}), the last the peak of the card's allocated memory."""
    salsa_spatial.launches = noise_floor_mask.launches = 0
    cuda = dev.type == "cuda"
    if cuda:
        torch.cuda.reset_peak_memory_stats(dev)
    with recorded_predictions(dev) as rec:
        t0 = time.perf_counter()
        res = cli_infer.inference(config, exp["group"], suffix, splits=["val"], device=dev,
                                  **kwargs)
        if cuda:
            torch.cuda.synchronize(dev)
        wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated(dev) / 2**30 if cuda else float("nan")
    launches = {"salsa_spatial": salsa_spatial.launches, "noise_floor": noise_floor_mask.launches}
    outputs = os.path.join(exp["exp_dir"] + suffix, "outputs")
    for what, sub in (("csv", "submissions"), ("pred", "predictions")):
        shutil.copytree(os.path.join(outputs, sub, "val"), os.path.join(out_dir, what))
    return res, launches, {"wall_s": wall, "predict_s": rec["predict_s"][0],
                           "batches": rec["batches"], "peak_gib": peak}


def load_dumps(pred_dir: str) -> dict:
    """{clip: {array name: array}} of a directory of `.npz` prediction dumps."""
    out = {}
    for fn in sorted(os.listdir(pred_dir)):
        with np.load(os.path.join(pred_dir, fn)) as blob:
            out[fn[:-len(".npz")]] = dict(blob)
    return out


def variant_config(root: str, exp: dict, sub: str, overrides) -> str:
    """<root>/<sub>/<the experiment's config name> with `overrides`: the same
    experiment (its name is the file's), read another way."""
    cfg = copy.deepcopy(exp["cfg"])
    apply_overrides(cfg, list(overrides))
    path = os.path.join(root, sub, os.path.basename(exp["config"]))
    os.makedirs(os.path.dirname(path))
    save_config(cfg, path)
    return path


def infer_and_fuse(dev, exp: dict, config: str, fmt: str, n_batches: int, tmp: str) -> dict:
    """Phase 13 (a), (b) and (d) on one output format; (c) on reg_xyz."""
    cuda = dev.type == "cuda"
    cfg = load_config(config)
    n_classes, thr = cfg.data.n_classes, float(cfg.sed_threshold)
    gt = os.path.join(cfg.gt_meta_root_dir, "metadata_dev")
    base = os.path.join(tmp, fmt)
    out = {}

    # (a) plain and --tta, the kernels counted, the TTA dumps against the CPU's
    plain, out["launches"], t_plain = counted_infer(dev, exp, config, "_m0",
                                                     os.path.join(base, "plain"))
    tta, out["tta_launches"], t_tta = counted_infer(dev, exp, config, "_m0",
                                                    os.path.join(base, "tta"), use_tta=True)
    if cuda:
        check_infer_launches(out["launches"], n_batches, f"{fmt} cli.infer")
        check_infer_launches(out["tta_launches"], n_batches, f"{fmt} cli.infer --tta")
    for what, res, t, launches in (("plain", plain, t_plain, out["launches"]),
                                   ("--tta", tta, t_tta, out["tta_launches"])):
        s = res["val"]
        log("13", f"{fmt} cli.infer {what}: SELD {s['seld_error']:.4f} ER {s['ER']:.4f} F1 "
                  f"{s['F1']:.4f} LE {s['LE']:.2f} LR {s['LR']:.4f}; K1 "
                  f"{launches['salsa_spatial']}, K2 {launches['noise_floor']} launches "
                  f"({n_batches} extraction batch(es)); {t['wall_s']:.3f} s wall, predict "
                  f"{t['predict_s']:.3f} s, eval dispatches of {t['batches']} rows, peak "
                  f"memory {t['peak_gib']:.2f} GiB [{CARD}]")
    got = load_dumps(os.path.join(base, "tta", "pred"))
    if cuda:
        # the CPU infers the first val clip alone (a split of one clip): each clip's
        # predictions are its own, and the CPU's TTA pass costs a minute a clip
        one = os.path.join(tmp, f"{fmt}_one_clip_split")
        os.makedirs(one)
        for split, names in (("train", TRAIN_CLIPS), ("val", VAL_CLIPS[:1])):
            with open(os.path.join(one, f"{split}.csv"), "w") as f:
                f.write("filename\n" + "\n".join(names) + "\n")
        one_config = variant_config(tmp, exp, f"{fmt}_cpu", [f"data.output_format={fmt}",
                                                              f"split_meta_dir={one}"])
        shutil.rmtree(os.path.join(exp["exp_dir"] + "_m0", "outputs"))  # nothing stale
        cpu_res, _, t_cpu = counted_infer(torch.device("cpu"), exp, one_config, "_m0",
                                          os.path.join(base, "tta_cpu"), use_tta=True)
        want = load_dumps(os.path.join(base, "tta_cpu", "pred"))
        if sorted(want) != list(VAL_CLIPS[:1]):
            raise AssertionError(f"{fmt} --tta on the CPU dumped {sorted(want)}")
        for k in ("event_frame_pred", "doa_frame_pred"):
            err = np.concatenate([np.abs(got[n][k] - want[n][k]).ravel() for n in want])
            share = float(np.mean(err <= 2e-3))
            log("13", f"{fmt} --tta dumps, {dev.type} vs CPU plain versions, {k}: max abs err "
                      f"{err.max():.3e}, share within 2e-3 {share:.5f} (CPU "
                      f"{t_cpu['wall_s']:.1f} s, {len(want)} of {len(got)} val clips)")
            if share < 0.999 or err.max() > 2e-2:
                raise AssertionError(f"{fmt} --tta {k}, {dev.type} vs CPU: {share}, {err.max()}")
        out["cpu_s"] = t_cpu["wall_s"]

    # (b) fused against sequential TTA: every variant in fold-sized dispatches, then
    # one variant a dispatch (training.tta_elements_per_dispatch: 1)
    seq_config = variant_config(tmp, exp, f"{fmt}_fold1", [
        f"data.output_format={fmt}", "training.tta_elements_per_dispatch=1"])
    _, _, t_seq = counted_infer(dev, exp, seq_config, "_m0", os.path.join(base, "seq"),
                                use_tta=True)
    seq = load_dumps(os.path.join(base, "seq", "pred"))
    diff = max(float(np.abs(got[n][k] - seq[n][k]).max()) for n in seq
               for k in ("event_frame_pred", "doa_frame_pred"))
    rows = t_tta["batches"][0]
    log("13", f"{fmt} fused TTA ({len(t_tta['batches'])} dispatches of {rows} rows, fold "
              f"{rows // t_seq['batches'][0]}) against sequential ({len(t_seq['batches'])} "
              f"of {t_seq['batches'][0]}): max abs difference {diff:.3e} (bound "
              f"{FUSED_GATE:g}); predict {t_tta['predict_s']:.3f} s fused, "
              f"{t_seq['predict_s']:.3f} s sequential, {t_plain['predict_s']:.3f} s plain "
              f"({t_tta['predict_s'] / t_plain['predict_s']:.1f}x); wall {t_tta['wall_s']:.3f} / "
              f"{t_seq['wall_s']:.3f} / {t_plain['wall_s']:.3f} s [{CARD}]")
    if not diff <= FUSED_GATE:
        raise AssertionError(f"{fmt}: fused TTA against sequential: {diff}")
    out.update(fused_diff=diff, plain=t_plain, tta=t_tta, seq=t_seq)

    # (c) --tune-threshold: the sidecar, val's CSVs at the tuned point, and
    # cli.predict --use-tuned-threshold serving with it
    if fmt == "reg_xyz":
        tuned_res, _, _ = counted_infer(dev, exp, config, "_m0", os.path.join(base, "tuned"),
                                        use_tta=True, tune_threshold=True)
        tuned = tuned_res["tuned_threshold"]
        sidecar = os.path.join(exp["exp_dir"] + "_m0", "models", "tuned_threshold.json")
        if not os.path.isfile(sidecar) or json.load(open(sidecar))["sed_threshold"] != tuned:
            raise AssertionError(f"--tune-threshold: {sidecar} missing or not at {tuned}")
        rewritten = os.path.join(base, "tuned_rewritten")
        write_ensemble(ensemble_predictions([os.path.join(base, "tuned", "pred")]), rewritten,
                       n_classes, sed_threshold=tuned, version=str(cfg.eval_version))
        if differing_files(os.path.join(base, "tuned", "csv"), rewritten):
            raise AssertionError("--tune-threshold: val's CSVs are not the dumps at the tuned "
                                 "threshold")
        served = cli_predict.predict(config, exp["val_wav_dir"], os.path.join(base, "served"),
                                     exp["group"], "_m0", use_tuned_threshold=True, device=dev)
        with open(os.path.join(exp["exp_dir"] + "_m0", "logs", "log.txt")) as f:
            if f"serving with tuned sed_threshold {tuned:.2f}" not in f.read():
                raise AssertionError("cli.predict --use-tuned-threshold did not serve the "
                                     "tuned threshold")
        fixed = variant_config(tmp, exp, f"{fmt}_at_tuned", [f"sed_threshold={tuned}"])
        at_tuned = cli_predict.predict(fixed, exp["val_wav_dir"], os.path.join(base, "at_tuned"),
                                       exp["group"], "_m0", device=dev)
        bad = differing_files(served, at_tuned)
        if bad:
            raise AssertionError(f"cli.predict --use-tuned-threshold: {bad} differ from "
                                 f"serving a config at {tuned}")
        sweep = tuned_res["threshold_sweep"]
        at_thr = next(r["seld"] for r in sweep["rows"] if abs(r["threshold"] - thr) < 1e-9)
        log("13", f"{fmt} --tta --tune-threshold: tuned sed_threshold {tuned:.2f} (SELD "
                  f"{sweep['best']['seld']:.4f}; at {thr:.2f}: {at_thr:.4f}); "
                  f"val's CSVs the dumps at it; cli.predict --use-tuned-threshold served "
                  f"{len(os.listdir(served))} CSVs at it (byte-identical to a config at it)")
        out["tuned"] = tuned

    # (d) cli.ensemble: one member (byte-identical to its infer), both members
    # tuned, and the parameter-space average inferred from a models/best directory
    ens1 = os.path.join(base, "ens1")
    single = cli_ensemble.main(["--pred-dirs", os.path.join(base, "plain", "pred"), "--out-dir",
                                ens1, "--n-classes", str(n_classes), "--sed-threshold",
                                str(thr), "--gt-meta-dir", gt])
    bad = differing_files(ens1, os.path.join(base, "plain", "csv"))
    if bad or single != plain["val"]:
        raise AssertionError(f"{fmt} single-member ensemble: CSVs {bad} differ from its "
                             f"infer's, scores {single} vs {plain['val']}")
    counted_infer(dev, exp, config, "_m1", os.path.join(base, "m1"))
    both = cli_ensemble.main(["--pred-dirs", os.path.join(base, "plain", "pred"),
                              os.path.join(base, "m1", "pred"), "--out-dir",
                              os.path.join(base, "ens2"), "--n-classes", str(n_classes),
                              "--sed-threshold", str(thr), "--gt-meta-dir", gt,
                              "--tune-threshold"])
    if not all(np.isfinite(both[k]) for k in ("seld_error", "ER", "F1", "LE", "LR")):
        raise AssertionError(f"{fmt} two-member ensemble: {both}")
    ckpt_dir = os.path.join(exp["exp_dir"] + "_m0", "models", "checkpoint")
    members = sorted(os.path.join(ckpt_dir, f) for f in os.listdir(ckpt_dir)
                     if f.endswith(".msgpack"))
    swa_models = os.path.join(exp["exp_dir"] + "_swa", "models")
    os.makedirs(os.path.join(swa_models, "best"), exist_ok=True)
    shutil.copyfile(os.path.join(exp["exp_dir"] + "_m0", "models", "feature_scaler.npz"),
                    os.path.join(swa_models, "feature_scaler.npz"))
    swa_path = cli_ensemble.main(["--ckpts", *members, "--out-ckpt",
                                  os.path.join(swa_models, "best", "swa.msgpack")])
    swa, swa_launches, _ = counted_infer(dev, exp, config, "_swa", os.path.join(base, "swa"))
    with open(os.path.join(exp["exp_dir"] + "_swa", "logs", "log.txt")) as f:
        restored = re.findall(r"restored (\S+)", f.read())
    if restored[-1:] != [swa_path] or not np.isfinite(swa["val"]["seld_error"]):
        raise AssertionError(f"{fmt}: the averaged checkpoint was not inferred: {restored}, "
                             f"{swa['val']}")
    if cuda:
        check_infer_launches(swa_launches, n_batches, f"{fmt} cli.infer of the average")
    log("13", f"{fmt} cli.ensemble: one member's CSVs byte-identical to its infer's (SELD "
              f"{single['seld_error']:.4f}); both members tuned at "
              f"{both['tuned_threshold']:.2f}: SELD {both['seld_error']:.4f}; --ckpts over "
              f"{len(members)} epoch checkpoints of member 0, inferred from models/best: "
              f"SELD {swa['val']['seld_error']:.4f}")
    out["scores"] = {"plain": plain["val"], "tta": tta["val"], "ensemble": both,
                     "swa": swa["val"]}
    return out


def phase13(dev, seconds: float = 60.0, overrides=()) -> dict:
    """Inference, TTA, the threshold sweep and the ensemble on the card: phase 9's
    experiment trained twice (seeds MEMBER_SEEDS, phase 9's steps), then per
    output format (reg_xyz, and accdoa on the same weights) `cli.infer` plain and
    --tta with K1 and K2 counted (once per extraction batch, TTA adding none), the
    TTA dumps against the CPU's, fused against sequential TTA, `--tune-threshold`
    and `cli.predict --use-tuned-threshold` (reg_xyz), and `cli.ensemble` over one
    member, both members tuned, and --ckpts inferred from models/best."""
    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        exp = write_train_experiment(tmp, seconds, overrides=overrides)
        t0 = time.perf_counter()
        for m, seed in enumerate(MEMBER_SEEDS):
            tr = cli_train.train(exp["config"], exp["group"], exp_suffix=f"_m{m}", seed=seed,
                                 device=dev)
        log("13", f"trained {len(MEMBER_SEEDS)} members from seeds {MEMBER_SEEDS}, "
                  f"{tr.max_epochs} epochs of {tr.steps_per_epoch} steps at batch "
                  f"{tr.batch_size} each: {time.perf_counter() - t0:.2f} s host clock [{CARD}]")
        del tr
        lengths = [wav_info(os.path.join(exp["val_wav_dir"], f"{n}.wav"))[1]
                   for n in VAL_CLIPS]
        n_batches = extraction_batches(lengths)
        cfg = exp["cfg"]
        frames = int(round(cfg.data.test_chunk_len_s * cfg.data.fs / cfg.data.hop_len))
        ex = make_extractor(cfg.feature_type, cfg.data.audio_format,
                            **cli_predict.feature_kwargs(cfg))
        shape = (len(VAL_CLIPS), ex.n_channels, frames, ex.n_features)
        log("13", f"TTA fold at the {cfg.data.test_chunk_len_s:g} s test chunk: "
                  f"{tta_fold(16, shape)} of 16 FOA variants a dispatch at a batch {shape}, "
                  f"{tta_fold(16, (8, *shape[1:]))} at 8 clips a batch (budget 2e8 elements)")
        configs = {"reg_xyz": exp["config"],
                   "accdoa": variant_config(tmp, exp, "accdoa", ["data.output_format=accdoa"])}
        for fmt, config in configs.items():
            out[fmt] = infer_and_fuse(dev, exp, config, fmt, n_batches, tmp)
            if dev.type == "cuda":
                torch.cuda.empty_cache()
    return out


# phase 14: configs/seld_tpu.yml verbatim (PannResNet22TPU, bf16 compute on both
# parts, device_augment, from wav) served, trained, streamed and inferred, then the
# LSTM and transformer decoders at full width in fp32. The bf16 gates hold the card
# against the CPU's run of the same port (PERF.md section 3): bf16's roundings on
# the card's convolutions differ from the CPU's in a small share, and each later
# conv spreads a difference over all its outputs, so the two bf16 networks part
# about as far as either parts from fp32; the gates read that against the card's
# own bf16-versus-fp32 distance on the same weights and input.
TPU_YML = os.path.join(REPO, "configs", "seld_tpu.yml")
# (the first run, on an NVIDIA H100 80GB HBM3 at 700.00 W: ratio 0.75 / 0.73 and max
# 1.04e-3 / 6.03e-3 for event_prob / doa, a clip against its solo run 6.03e-3, the
# first step 3.9e-5; the CPU tests read the port against salsa_tpu at ratio 0.49-1.32
# and its first step at 6.6e-4)
BF16_RATIO = 2.0  # RMS(card - CPU) / RMS(card bf16 - card fp32), event_prob and doa
BF16_MAX = 3e-2  # max |card - CPU| of event_prob and doa; a clip against its solo run
BF16_STEP_REL = 1e-3  # the first step's loss, card against CPU, relative
NEW_DECODERS = ("lstm", "bilstm", "transformer")


def rms(a, b) -> float:
    return float(np.sqrt(np.mean((np.asarray(a, np.float64) - np.asarray(b, np.float64)) ** 2)))


def fp32_twin(model: torch.nn.Module, cfg) -> torch.nn.Module:
    """The config's network in fp32 (no compute_dtype) on `model`'s weights."""
    enc, dec = cfg.model.encoder.to_dict(), cfg.model.decoder.to_dict()
    enc.pop("compute_dtype", None)
    dec.pop("compute_dtype", None)
    twin = build_model(encoder=enc, decoder=dec, n_classes=cfg.data.n_classes,
                       output_format=cfg.data.output_format)
    twin.load_state_dict(model.state_dict())
    return twin


def tpu_requests(dev, rng, request_seconds, fp32: dict) -> dict:
    """configs/seld_tpu.yml at full width, seeded random weights: three requests
    through SeldInferencePipeline with K1 and K2 counted (one each a request), each
    clip against its solo run, one clip on the device against the CPU's run beside
    the device's bf16-versus-fp32 distance, and the request's times against the
    same weights in fp32 in this call and `fp32`'s (phase 5's configs/seld.yml)."""
    cuda = dev.type == "cuda"
    cfg = load_config(TPU_YML)
    d = cfg.data
    model = init_random_(build_model(encoder=cfg.model.encoder.to_dict(),
                                     decoder=cfg.model.decoder.to_dict(), n_classes=d.n_classes,
                                     output_format=d.output_format),
                         torch.Generator().manual_seed(SEED + 40))
    if model.encoder.compute_dtype != torch.bfloat16 or type(model.encoder).__name__ != \
            "PannResNet22TPU":
        raise AssertionError(f"seld_tpu.yml built {type(model.encoder).__name__} in "
                             f"{model.encoder.compute_dtype}")
    ex = make_extractor(cfg.feature_type, d.audio_format, **cli_predict.feature_kwargs(cfg))
    scaler = (rng.normal(-5.0, 1.0, (4, 1, ex.n_features)).astype(np.float32),
              rng.uniform(5.0, 8.0, (4, 1, ex.n_features)).astype(np.float32))
    interp = model.time_downsample_ratio * d.label_rate / (d.fs / d.hop_len)
    pipe = SeldInferencePipeline(ex, model, None, scaler, interp, d.n_classes, d.output_format,
                                 device=dev)
    requests = [foa_clips(rng, n, s) for n, s in zip((4, 2, 1), request_seconds)]
    salsa_spatial.launches = noise_floor_mask.launches = 0
    outs = [pipe(w) for w in requests]
    launches = {"salsa_spatial": salsa_spatial.launches, "noise_floor": noise_floor_mask.launches}
    log("14", f"seld_tpu.yml (PannResNet22TPU, bf16): served {len(requests)} requests "
              f"{[w.shape for w in requests]}; launches {launches}")
    k = len(requests) if cuda else 0
    if launches != {"salsa_spatial": k, "noise_floor": k}:
        raise AssertionError(f"seld_tpu.yml: expected one K1 and one K2 launch per request, "
                             f"got {launches}")
    solo = 0.0
    for w, (ev, doa) in zip(requests, outs):
        n_labels = int(round(((1 + w.shape[-1] // HOP) // 16) * interp))
        check_outputs(ev, doa, w.shape[0], n_labels, f"seld_tpu.yml request {w.shape}")
        for b in range(w.shape[0]):
            ev1, doa1 = pipe(w[b:b + 1])
            solo = max(solo, np.abs(ev1[0] - ev[b]).max(), np.abs(doa1[0] - doa[b]).max())
    log("14", f"each clip against its solo run: max abs difference {solo:.3e} (bound "
              f"{BF16_MAX:g}: the batch may take other convolution algorithms)")
    if solo > BF16_MAX:
        raise AssertionError(f"seld_tpu.yml: a clip differs from its solo run by {solo}")

    clip = requests[0][:1]
    cpu_pipe = SeldInferencePipeline(ex, copy.deepcopy(pipe.model).cpu(), None, scaler, interp,
                                     d.n_classes, d.output_format, device="cpu")
    t0 = time.perf_counter()
    ev_c, doa_c = cpu_pipe(clip)
    cpu_s = time.perf_counter() - t0
    pipe32 = SeldInferencePipeline(ex, fp32_twin(pipe.model, cfg), None, scaler, interp,
                                   d.n_classes, d.output_format, device=dev)
    ev32, doa32 = pipe32(clip)
    out = {"launches": launches, "solo_diff": float(solo), "cpu_s": cpu_s}
    for name, g, c, f in (("event_prob", outs[0][0][:1], ev_c, ev32),
                          ("doa", outs[0][1][:1], doa_c, doa32)):
        err, own = rms(g, c), rms(g, f)
        worst = float(np.abs(g - c).max())
        log("14", f"seld_tpu.yml {dev.type} vs CPU {name}: RMS {err:.3e}, max abs {worst:.3e}; "
                  f"the {dev.type}'s bf16 vs fp32 on the same weights: RMS {own:.3e}, max abs "
                  f"{float(np.abs(g - f).max()):.3e}; ratio {err / own:.3f} (bounds "
                  f"{BF16_RATIO:g} and {BF16_MAX:g}; the CPU took {cpu_s:.1f} s)")
        if not (err <= BF16_RATIO * own and worst <= BF16_MAX):
            raise AssertionError(f"seld_tpu.yml {name}: RMS {err} vs {own}, max {worst}")
        out[f"{name}_err"], out[f"{name}_rms_ratio"] = worst, err / own
    if cuda:
        req = requests[0]
        waves = torch.from_numpy(req).to(dev)
        secs = req.shape[0] * req.shape[-1] / FS
        with torch.inference_mode():
            feats = pipe._normalize(ex(waves))
            for tag, p in (("bf16", pipe), ("fp32", pipe32)):
                out[f"request_ms_{tag}"] = host_ms(lambda: p(req))
                out[f"crnn_ms_{tag}"] = cuda_ms(lambda: p.model(feats))
        log("14", f"seld_tpu.yml request {req.shape}: bf16 {out['request_ms_bf16']:.2f} ms "
                  f"median of 7 (host clock, {secs / out['request_ms_bf16'] * 1e3:.1f}x "
                  f"realtime), CRNN {out['crnn_ms_bf16']:.2f} ms (CUDA events, median of 7); "
                  f"the same network in fp32: {out['request_ms_fp32']:.2f} ms, CRNN "
                  f"{out['crnn_ms_fp32']:.2f} ms; phase 5's configs/seld.yml (fp32 "
                  f"PannResNet22): {fp32.get('request_ms', float('nan')):.2f} ms, CRNN "
                  f"{fp32.get('crnn_ms', float('nan')):.2f} ms [{CARD}]")
        profile_table(lambda: pipe(req), "14", "one seld_tpu.yml request",
                      upload_bytes=req.nbytes)
    return out


def trained_experiment(exp: dict, seconds: float) -> dict:
    """The trained from-wav experiment `exp` as `serve_from_disk` and the streaming
    helpers read an experiment: its val wavs, its `best` checkpoint and scaler."""
    models = os.path.join(exp["exp_dir"], "models")
    best = os.path.join(models, "best", "best.msgpack")
    params, stats, _ = ckpt_restore_variables(best)
    return {"config": exp["config"], "group": exp["group"], "wav_dir": exp["val_wav_dir"],
            "gt_root": os.path.dirname(exp["wav_dir"]), "cfg": exp["cfg"],
            "log": os.path.join(exp["exp_dir"], "logs", "log.txt"),
            "scaler": os.path.join(models, "feature_scaler.npz"), "served": best,
            "weights": {"params": params, "batch_stats": stats},
            "scenes": tuple((n, seconds, FS) for n in VAL_CLIPS)}


def tpu_train(dev, seconds: float, overrides, timed: int, n_streams: int, fp32: dict) -> dict:
    """configs/seld_tpu.yml trained from raw wavs as a user runs it: the first
    step's loss on the same draws against the CPU's, `cli.train` (2 epochs of 6
    steps) with K1 and K2 counted, the step split, one K1 and one K2 launch a
    step, beside `fp32`'s (phase 12's augmented configs/seld.yml step); the trained
    `best` served by `cli.predict` (CSVs byte-identical to the in-memory
    pipeline's), streamed (`--streams N`, `--pool`), inferred with `--tta`; then
    `--resume` from 2 to 3 epochs."""
    cuda = dev.type == "cuda"
    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        exp = write_train_experiment(tmp, seconds, overrides=overrides, config=TPU_YML)
        tr = cli_train.build_trainer(exp["config"], exp["group"], exp_suffix="_check",
                                     device=dev)
        if tr.augment is None or tr.model.encoder.compute_dtype != torch.bfloat16:
            raise AssertionError("seld_tpu.yml's trainer: no device_augment or not bf16")
        out["first_step_rel"] = first_step_loss(tr, dev, "14", bound=BF16_STEP_REL)
        del tr
        if cuda:
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats(dev)

        tr, launches, wall = counted_train(dev, exp["config"], exp["group"])
        n_steps = tr.steps_per_epoch * tr.max_epochs
        peak = torch.cuda.max_memory_allocated(dev) / 2**30 if cuda else float("nan")
        log("14", f"seld_tpu.yml cli.train (bf16, device_augment): {len(TRAIN_CLIPS)} x "
                  f"{seconds:g} s train clips, {tr.max_epochs} epochs of {tr.steps_per_epoch} "
                  f"steps at batch {tr.batch_size}: {wall:.2f} s host clock; launches "
                  f"{launches}; peak memory {peak:.2f} GiB [{CARD}]")
        if cuda:
            check_train_launches(launches, n_steps, "seld_tpu.yml cli.train")
        salsa_spatial.launches = noise_floor_mask.launches = 0
        times = timed_steps(tr, dev, timed)
        step_launches = {"salsa_spatial": salsa_spatial.launches,
                         "noise_floor": noise_floor_mask.launches}
        k = timed if cuda else 0
        if step_launches != {"salsa_spatial": k, "noise_floor": k}:
            raise AssertionError(f"{timed} seld_tpu.yml train steps launched {step_launches}: "
                                 "expected one K1 and one K2 launch a step")
        chunk_s = tr.chunk_len * exp["cfg"].data.hop_len / exp["cfg"].data.fs
        log("14", f"seld_tpu.yml train step, median of steps 3-{timed}: {times['step']:.2f} ms = "
                  f"extraction {times['extract']:.2f} + augmentation {times['augment']:.3f} + "
                  f"forward and backward {times['fwd_bwd']:.2f} + optimizer "
                  f"{times['optimizer']:.2f} ms; {1e3 / times['step']:.2f} steps/s, "
                  f"{tr.batch_size * chunk_s * 1e3 / times['step']:.1f}x realtime; "
                  f"{step_launches} launches in the {timed} steps; phase 12's augmented "
                  f"fp32 configs/seld.yml step {fp32.get('step_ms', float('nan')):.2f} ms, "
                  f"peak {fp32.get('peak_gib', float('nan')):.2f} GiB [{CARD}]")
        if cuda:
            ids = tr._epoch_order(tr.max_epochs + 1)[:tr.batch_size]
            out["profile"] = profile_table(lambda: tr.train_step(ids), "14",
                                           "one seld_tpu.yml train step", top=16)
        out.update(launches=launches, step=times, step_launches=step_launches, peak_gib=peak,
                   wall_s=wall, n_steps=n_steps)
        del tr
        if cuda:
            torch.cuda.empty_cache()

        sexp = trained_experiment(exp, seconds)
        out["disk"] = serve_from_disk(dev, sexp, os.path.join(tmp, "serve"), tag="14")
        for what, kw in (("streams", {"streams": n_streams}),
                         ("pool", {"streams": n_streams, "pool": True})):
            r = serve_stream_cli(dev, sexp, os.path.join(tmp, f"stream_{what}"), **kw)
            csvs = sorted(os.listdir(os.path.join(tmp, f"stream_{what}")))
            c = r["counts"]
            log("14", f"seld_tpu.yml cli.predict --streaming --streams {n_streams}"
                      f"{' --pool' if kw.get('pool') else ''}: {len(csvs)} CSVs in "
                      f"{r['secs']:.3f} s; launches {c}; its log: {r['line']} [{CARD}]")
            k = c["dispatches"] if cuda else 0
            if csvs != sorted(f"{n}.csv" for n in VAL_CLIPS) or c["dispatches"] < 1 or (
                    c["salsa_spatial"], c["noise_floor"]) != (k, k):
                raise AssertionError(f"seld_tpu.yml streaming {what}: CSVs {csvs}, counts {c}: "
                                     "expected one K1 and one K2 launch a block dispatch")
            if not all(np.isfinite(a).all() for pair in r["arrays"].values() for a in pair):
                raise AssertionError(f"seld_tpu.yml streaming {what}: non-finite outputs")
            out[f"stream_{what}"] = c

        lengths = [wav_info(os.path.join(exp["val_wav_dir"], f"{n}.wav"))[1] for n in VAL_CLIPS]
        n_batches = extraction_batches(lengths)
        res, launches, rec = counted_infer(dev, exp, exp["config"], "",
                                           os.path.join(tmp, "infer_tta"), use_tta=True)
        if cuda:
            check_infer_launches(launches, n_batches, "seld_tpu.yml cli.infer --tta")
        dumps = load_dumps(os.path.join(tmp, "infer_tta", "pred"))
        if sorted(dumps) != sorted(VAL_CLIPS) or not all(
                np.isfinite(a).all() for dump in dumps.values() for a in dump.values()):
            raise AssertionError(f"seld_tpu.yml cli.infer --tta dumps: {sorted(dumps)}")
        scores = res["val"]
        log("14", f"seld_tpu.yml cli.infer --splits val --tta: {rec['wall_s']:.2f} s host "
                  f"clock, predict {rec['predict_s']:.3f} s, eval batches {rec['batches']}; "
                  f"launches {launches}; " + ", ".join(f"{k} {v:.4f}" for k, v in
                                                       scores.items()) + f" [{CARD}]")
        out.update(infer_launches=launches, infer=rec)

        with recorded_epochs() as run:
            tr, launches, wall = counted_train(dev, exp["config"], exp["group"], resume=True,
                                               overrides=["training.max_epochs=3"])
        if [e for e, _ in run] != [2] or tr.optimizer.count != 3 * tr.steps_per_epoch:
            raise AssertionError(f"seld_tpu.yml --resume trained epochs {[e for e, _ in run]} "
                                 f"to step {tr.optimizer.count}: expected epoch 2 only")
        if cuda:
            check_train_launches(launches, tr.steps_per_epoch, "seld_tpu.yml --resume")
        log("14", f"seld_tpu.yml cli.train --resume from epoch001 to 3 epochs: epoch 2's "
                  f"{len(run[0][1])} steps, losses {[round(x, 4) for x in run[0][1]]}, in "
                  f"{wall:.2f} s host clock; launches {launches} [{CARD}]")
        out["resume_launches"] = launches
        del tr
    return out


def new_decoders(dev, rng, request_seconds: float, seconds: float, overrides,
                 request_clips: int = 4) -> dict:
    """configs/seld.yml with decoder_type lstm, bilstm and transformer at full width
    in fp32, seeded random weights: one request each, card against CPU at phase 4's
    gate, K1 and K2 once a request; the first training step's loss card against
    CPU within phase 9's 1e-4."""
    cuda = dev.type == "cuda"
    out = {}
    ex = make_extractor("salsa", D["audio_format"], fs=FS, n_fft=N_FFT, hop_length=HOP)
    scaler = (rng.normal(-5.0, 1.0, (4, 1, ex.n_features)).astype(np.float32),
              rng.uniform(5.0, 8.0, (4, 1, ex.n_features)).astype(np.float32))
    for i, dt in enumerate(NEW_DECODERS):
        cfg = load_config(SELD_YML)
        apply_overrides(cfg, [f"model.decoder.decoder_type={dt}", *overrides])
        model = init_random_(build_model(encoder=cfg.model.encoder.to_dict(),
                                         decoder=cfg.model.decoder.to_dict(),
                                         n_classes=cfg.data.n_classes),
                             torch.Generator().manual_seed(SEED + 50 + i))
        pipe = SeldInferencePipeline(ex, model, None, scaler, INTERP, cfg.data.n_classes,
                                     cfg.data.output_format, device=dev)
        req = foa_clips(rng, request_clips, request_seconds)
        salsa_spatial.launches = noise_floor_mask.launches = 0
        ev, doa = pipe(req)
        launches = {"salsa_spatial": salsa_spatial.launches,
                    "noise_floor": noise_floor_mask.launches}
        k = 1 if cuda else 0
        if launches != {"salsa_spatial": k, "noise_floor": k}:
            raise AssertionError(f"{dt}: expected one K1 and one K2 launch, got {launches}")
        n_labels = int(round(((1 + req.shape[-1] // HOP) // 16) * INTERP))
        check_outputs(ev, doa, req.shape[0], n_labels, f"{dt} request {req.shape}")
        cpu_pipe = SeldInferencePipeline(ex, copy.deepcopy(pipe.model).cpu(), None, scaler,
                                         INTERP, cfg.data.n_classes, cfg.data.output_format,
                                         device="cpu")
        # against the card, the CPU runs the request's first clip alone (each clip's
        # outputs are its own); a CPU run holds the whole request against itself
        n = 1 if cuda else len(req)
        t0 = time.perf_counter()
        ev_c, doa_c = cpu_pipe(req[:n])
        cpu_s = time.perf_counter() - t0
        res = {"launches": launches}
        for name, g, c in (("event_prob", ev[:n], ev_c), ("doa", doa[:n], doa_c)):
            err = np.abs(g - c)
            share = float(np.mean(err <= 2e-3))
            log("14", f"{dt} (configs/seld.yml, fp32) request {req.shape}: {dev.type} vs CPU "
                      f"{name} on {n} of its clips: max abs err {err.max():.3e}, share within "
                      f"2e-3 {share:.5f} (the CPU took {cpu_s:.1f} s)")
            if share < 0.999 or err.max() > 2e-2:
                raise AssertionError(f"{dt} {name}: share {share}, max {err.max()}")
            res[f"{name}_err"] = float(err.max())
        if cuda:
            waves = torch.from_numpy(req).to(dev)
            with torch.inference_mode():
                feats = pipe._normalize(ex(waves))
                res["crnn_ms"] = cuda_ms(lambda: pipe.model(feats))
            log("14", f"{dt} CRNN on {tuple(feats.shape)}: {res['crnn_ms']:.2f} ms (CUDA "
                      f"events, median of 7) [{CARD}]")
        del pipe, cpu_pipe
        with tempfile.TemporaryDirectory() as tmp:
            exp = write_train_experiment(tmp, seconds, overrides=(
                f"model.decoder.decoder_type={dt}", *overrides))
            tr = cli_train.build_trainer(exp["config"], exp["group"], device=dev)
            res["first_step_rel"] = first_step_loss(tr, dev, "14")
            del tr
        if cuda:
            torch.cuda.empty_cache()
        out[dt] = res
    return out


def phase14(dev, seconds: float = 60.0, request_seconds=(60.0, 60.0, 20.7), overrides=(),
            decoder_overrides=(), timed: int = TIMED_STEPS, n_streams: int = 4,
            request_clips: int = 4, fp32=None) -> dict:
    """configs/seld_tpu.yml verbatim on `dev`: served in memory, trained, served
    from disk, streamed, inferred with TTA and resumed (`tpu_requests`,
    `tpu_train`), its times beside `fp32`'s (configs/seld.yml's, phases 5 and 12);
    then the new decoders at full width (`new_decoders`)."""
    rng = np.random.default_rng(SEED + 40)
    fp32 = fp32 or {}
    out = {"requests": tpu_requests(dev, rng, request_seconds, fp32)}
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    out["train"] = tpu_train(dev, seconds, overrides, timed, n_streams, fp32)
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    out["decoders"] = new_decoders(dev, rng, request_seconds[0], seconds, decoder_overrides,
                                   request_clips)
    return out


# phase 15: the feature-store workflow of configs/seld.yml as written, its three
# paths pointed at the temp tree and phase 9's step cut: cli.extract writes the
# store of phase 9's seeded clips (configs/tnsse2021_salsa.yml), cli.train trains
# from it with the host transforms, then the resident, precompute and remat
# variants, and cli.predict, cli.infer and cli.evaluate from it
TNSSE_SALSA_YML = os.path.join(REPO, "configs", "tnsse2021_salsa.yml")
STORE_OVERRIDES = ("training.max_epochs=2", "data.train_fraction=0.5")
EXTRACT_BATCH = 4  # cli.extract --batch-size: the 6 clips go up in two batches, 4 and 2
DROPOUT_ON = ("model.encoder.p_dropout=0.2", "model.decoder.head_dropout=0.2",
              "model.decoder.rnn_dropout=0.2")


def counted(fn):
    """(fn(), {K1, K2 launches}) with both counts set to 0 just before fn()."""
    salsa_spatial.launches = noise_floor_mask.launches = 0
    out = fn()
    return out, {"salsa_spatial": salsa_spatial.launches,
                 "noise_floor": noise_floor_mask.launches}


def store_extract(dev, exp: dict, root: str, tag: str = "15") -> dict:
    """`cli.extract --feature-type salsa` of phase 9's six clips on `dev`, K1 and K2
    counted (one launch each per equal-length batch); two stored clips against the
    CPU's plain extraction at K1's bound; the scaler against StreamingScaler over
    the stored clips, bit-equal; a `--keep-existing` rerun that extracts nothing."""
    cuda = dev.type == "cuda"
    data = load_config(TNSSE_SALSA_YML)
    data.data_dir, data.feature_dir = os.path.dirname(exp["wav_dir"]), os.path.join(root,
                                                                                   "features")
    data_path = os.path.join(root, "tnsse2021_salsa.yml")
    save_config(data, data_path)
    wavs = sorted(os.listdir(exp["wav_dir"]))
    audio_s = sum(wav_info(os.path.join(exp["wav_dir"], w))[1] for w in wavs) / FS
    t0 = time.perf_counter()
    store_dir, launches = counted(lambda: cli_extract.extract_features(
        data_path, "salsa", batch_size=EXTRACT_BATCH, splits=["foa_dev"], device=dev))
    if cuda:
        torch.cuda.synchronize(dev)
    wall = time.perf_counter() - t0
    n_batches = sum(
        1 if len({wav_info(os.path.join(exp["wav_dir"], w))[1] for w in group}) == 1
        else len(group) for group in (wavs[i:i + EXTRACT_BATCH]
                                      for i in range(0, len(wavs), EXTRACT_BATCH)))
    log(tag, f"cli.extract --feature-type salsa --batch-size {EXTRACT_BATCH}: {len(wavs)} clips, "
             f"{audio_s:g} audio-s in {wall:.3f} s host clock, disk writes included "
             f"({audio_s / wall:.1f}x realtime); launches {launches} [{CARD}]")
    want = {"salsa_spatial": n_batches, "noise_floor": n_batches} if cuda else \
        {"salsa_spatial": 0, "noise_floor": 0}
    if launches != want:
        raise AssertionError(f"cli.extract launched {launches}, expected {want} (one K1 and one "
                             f"K2 launch per equal-length batch of {len(wavs)} clips)")
    store = FeatureStore(store_dir, "foa")
    if sorted(store.clip_names("dev")) != sorted(w[:-4] for w in wavs):
        raise AssertionError(f"{store_dir}: clips {store.clip_names('dev')}, expected {wavs}")
    ex = make_extractor("salsa", "foa", fs=FS, n_fft=N_FFT, hop_length=HOP, fmax_doa=9000.0)
    errs = []
    for w in (wavs[0], wavs[-1]):
        stored = torch.from_numpy(store.read_clip("dev", w[:-4]))[None]
        t0 = time.perf_counter()
        want_x = ex(torch.from_numpy(read_wav(os.path.join(exp["wav_dir"], w))[0])[None])
        cpu_s = time.perf_counter() - t0
        np.testing.assert_allclose(stored[:, :4].numpy(), want_x[:, :4].numpy(), atol=5e-3,
                                   rtol=5e-3, err_msg=f"{w}: stored spectrograms")
        errs.append(compare_spatial(stored[:, 4:], want_x[:, 4:],
                                    f"stored {w} {tuple(stored.shape)} vs the CPU's plain "
                                    f"extraction ({cpu_s:.1f} s)", phase=tag))
    scaler = StreamingScaler(ex.n_spec_channels)
    for name in store.clip_names("dev"):
        scaler.update(store.read_clip("dev", name))
    for got, want_s in zip(store.read_scaler(), scaler.finalize()):
        if not np.array_equal(got, want_s):
            raise AssertionError("the store's scaler differs from StreamingScaler over its clips")
    log(tag, f"{store.scaler_path}: bit-equal to StreamingScaler over the {len(wavs)} stored "
             "clips on the host")
    stamps = LogStamps()
    cli_logger = configure_logging()  # as cli.extract's main() logs
    cli_logger.addFilter(stamps)
    try:
        _, rerun = counted(lambda: cli_extract.extract_features(
            data_path, "salsa", splits=["foa_dev"], keep_existing=True, device=dev))
    finally:
        cli_logger.removeFilter(stamps)
    if rerun != {"salsa_spatial": 0, "noise_floor": 0} or not any(
            "resume: 0 clips left to extract" in m for _, m in stamps.marks):
        raise AssertionError(f"--keep-existing rerun: launches {rerun}, log {stamps.marks}")
    log(tag, f"--keep-existing rerun: 0 clips left to extract, launches {rerun}")
    return {"dir": store_dir, "launches": launches, "batches": n_batches, "wall_s": wall,
            "audio_s": audio_s, "realtime": audio_s / wall, "max_abs_err": max(errs),
            "data_config": data_path}


def store_first_step(tr, dev, tag: str = "15", bound: float = 1e-4) -> float:
    """The store-fed trainer's first step's loss with every dropout off: the card
    against the CPU on the same batch, whose host transforms drew once (they must
    change it). Returns the relative difference; raises beyond `bound`."""
    for m in tr.model.modules():
        if isinstance(m, Dropout):
            m.p, m.generator = 0.0, None
    model_cpu = copy.deepcopy(tr.model).cpu()
    ids = tr._epoch_order(0)[:tr.batch_size]
    raw = np.stack([tr.train_dataset.fetch_raw(int(i))[0] for i in ids])
    x, sed, doa = tr.batch(ids)
    changed = float((x.cpu().numpy() != raw).mean())
    if changed == 0:
        raise AssertionError("the host transforms left the first batch unchanged")
    with torch.no_grad():
        t0 = time.perf_counter()
        loss_cpu = float(tr.loss(model_cpu.train()(x.cpu()), sed.cpu(), doa.cpu())[0])
        cpu_s = time.perf_counter() - t0
        loss_dev = float(tr.loss(tr.model.train()(x), sed, doa)[0])
    rel = abs(loss_dev - loss_cpu) / abs(loss_cpu)
    log(tag, f"first step's loss (batch {tr.batch_size} from the store, host transforms "
             f"changed {changed:.1%} of the cells, dropout off): {dev.type} {loss_dev:.7f}, "
             f"CPU {loss_cpu:.7f} ({cpu_s:.1f} s), relative difference {rel:.2e} (bound "
             f"{bound:g})")
    if not rel < bound:
        raise AssertionError(f"first step's loss: {loss_dev} on {dev} vs {loss_cpu} on the CPU")
    return rel


def timed_store_steps(tr, dev, n_steps: int) -> dict:
    """n_steps host-fed steps as the epoch loop runs them, a prefetch thread building
    the next batch meanwhile, each split into the host's wait on the prefetch
    queue (host clock), the copy to the card, forward and backward, and the
    optimizer (CUDA events; host clock on the CPU); `step` is the host clock from
    the wait to the optimizer's end. Medians of steps 3 on."""
    def batches():
        epoch = tr.max_epochs
        while True:
            yield from tr.host_batches(epoch)
            epoch += 1

    parts = {"wait": [], "copy": [], "fwd_bwd": [], "optimizer": [], "step": []}
    it = prefetch(batches())
    try:
        for _ in range(n_steps):
            t0 = time.perf_counter()
            b = next(it)
            wait = (time.perf_counter() - t0) * 1e3
            tr.seed_step()
            if dev.type == "cuda":
                ev = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
                ev[0].record()
                batch = tr.to_device(b)
                ev[1].record()
                tr.forward_backward(*tr.augment_batch(*batch))
                ev[2].record()
                tr.optimizer.step()
                ev[3].record()
                ev[3].synchronize()
                t = [ev[k].elapsed_time(ev[k + 1]) for k in range(3)]
            else:
                marks = [time.perf_counter()]
                batch = tr.to_device(b)
                marks.append(time.perf_counter())
                tr.forward_backward(*tr.augment_batch(*batch))
                marks.append(time.perf_counter())
                tr.optimizer.step()
                marks.append(time.perf_counter())
                t = [(marks[k + 1] - marks[k]) * 1e3 for k in range(3)]
            for key, v in zip(parts, (wait, *t, (time.perf_counter() - t0) * 1e3)):
                parts[key].append(v)
    finally:
        it.close()
    return {k: statistics.median(v[2:]) for k, v in parts.items()}


def store_variants(dev, config: str, group: str, timed: int, tag: str = "15") -> dict:
    """training.device_data (its first batch against the host path's, transforms
    off; timed steps, resident bytes, peak memory; bfloat16 storage's one step),
    from_wav_mode: precompute (launches at setup and in the steps; timed steps) and
    training.remat (a step against the plain step on one batch, dropout on, with
    both peaks)."""
    cuda = dev.type == "cuda"
    out = {}

    def peak_gib():
        return torch.cuda.max_memory_allocated(dev) / 2**30 if cuda else float("nan")

    def reset():
        if cuda:
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats(dev)

    host = cli_train.build_trainer(config, group, "_host", device=dev)
    host.train_dataset.joint_transform = host.train_dataset.transform = None
    reset()
    dd = cli_train.build_trainer(config, group, "_dd", device=dev,
                                 overrides=["training.device_data=true"])
    ids = dd._epoch_order(0)[:dd.batch_size]
    same = all(torch.equal(a, b) for a, b in zip(host.batch(ids), dd.batch(ids)))
    if not same:
        raise AssertionError("device_data's first batch differs from the host path's")
    del host
    out["dd_step"] = timed_steps(dd, dev, timed)
    out["dd_resident_gb"] = dd.resident_bytes / 1e9
    out["dd_peak_gib"] = peak_gib()
    log(tag, f"device_data: first batch {tuple(dd.batch(ids)[0].shape)} bit-equal to the host "
             f"path's for the same chunks (transforms off); {dd.resident_bytes / 1e9:.3f} GB "
             f"resident; step, median of steps 3-{timed}: {out['dd_step']['step']:.2f} ms = "
             f"gather {out['dd_step']['extract']:.2f} + forward and backward "
             f"{out['dd_step']['fwd_bwd']:.2f} + optimizer {out['dd_step']['optimizer']:.2f} "
             f"ms; peak memory {out['dd_peak_gib']:.2f} GiB [{CARD}]")
    del dd
    reset()
    half = cli_train.build_trainer(config, group, "_dd16", device=dev, overrides=[
        "training.device_data=true", "training.device_data_dtype=bfloat16"])
    loss16 = float(half.train_step(half._epoch_order(0)[:half.batch_size])["loss"])
    if not np.isfinite(loss16):
        raise AssertionError(f"device_data_dtype bfloat16: loss {loss16}")
    log(tag, f"device_data_dtype bfloat16: {half.resident_bytes / 1e9:.3f} GB resident, one "
             f"step's loss {loss16:.5f}")
    del half
    reset()

    pre, launches = counted(lambda: cli_train.build_trainer(
        config, group, "_pre", device=dev,
        overrides=["training.from_wav=true", "training.from_wav_mode=precompute"]))
    tr_lens = [wav_info(os.path.join(pre.cfg.gt_meta_root_dir, "foa_dev", f"{n}.wav"))[1]
               for n in pre.train_data.unique_clip_names]
    va_lens = [wav_info(os.path.join(pre.cfg.gt_meta_root_dir, "foa_dev", f"{n}.wav"))[1]
               for n in VAL_CLIPS]
    n_setup = 2 * extraction_batches(tr_lens) + extraction_batches(va_lens)
    want = {"salsa_spatial": n_setup, "noise_floor": n_setup} if cuda else {
        "salsa_spatial": 0, "noise_floor": 0}
    if not (pre.device_data and launches == want):
        raise AssertionError(f"precompute: device_data {pre.device_data}, setup launches "
                             f"{launches}, expected {want} (the scaler fit, the train split "
                             "and the val split)")
    out["pre_step"], step_launches = counted(lambda: timed_steps(pre, dev, timed))
    if step_launches != {"salsa_spatial": 0, "noise_floor": 0}:
        raise AssertionError(f"precompute's steps launched {step_launches}")
    out["pre_launches"] = launches
    log(tag, f"from_wav_mode precompute: setup launches {launches} (the scaler fit, the train "
             f"split and the val split, {n_setup} batches), {timed} steps launched "
             f"{step_launches}; setup {', '.join(f'{k} {v:.3f} s' for k, v in pre.setup_seconds.items())}; "
             f"step {out['pre_step']['step']:.2f} ms = gather {out['pre_step']['extract']:.2f} + "
             f"forward and backward {out['pre_step']['fwd_bwd']:.2f} + optimizer "
             f"{out['pre_step']['optimizer']:.2f} ms [{CARD}]")
    del pre
    reset()

    runs = {}
    for remat in (False, True):
        tr = cli_train.build_trainer(config, group, f"_remat{int(remat)}", device=dev,
                                     overrides=[*DROPOUT_ON, f"training.remat={str(remat).lower()}"])
        batch = tr.batch(tr._epoch_order(0)[:tr.batch_size]) if not runs else runs[False][2]
        if cuda:
            torch.cuda.synchronize(dev)
            torch.cuda.reset_peak_memory_stats(dev)
            base = torch.cuda.memory_allocated(dev) / 2**30
        loss = float(tr.step_on(*batch)["loss"])
        peak = peak_gib() - base if cuda else float("nan")
        weights = {k: v.detach().clone() for k, v in tr.model.state_dict().items()}
        runs[remat] = (loss, peak, batch, weights, tr.remat_blocks)
        del tr
        reset()
    (l0, p0, _, w0, _), (l1, p1, _, w1, n_blocks) = runs[False], runs[True]
    rel = abs(l1 - l0) / abs(l0)
    w_err = max(float((w1[k].float() - w0[k].float()).abs().max()) for k in w0
                if not k.endswith("num_batches_tracked"))
    # the weights are read, not held: Adam's first step moves each by about lr times
    # the sign of its gradient, and cuDNN's weight gradients sum in no fixed order
    log(tag, f"remat ({n_blocks} encoder blocks recomputed), one step with dropout on, on the "
             f"plain step's batch: loss {l1:.7f} vs {l0:.7f} (relative {rel:.2e}, bound 1e-4), "
             f"weights after it within {w_err:.2e}; the step's peak above its start "
             f"{p1:.2f} GiB vs {p0:.2f} GiB plain [{CARD}]")
    if not rel < 1e-4:
        raise AssertionError(f"remat step's loss {l1} vs the plain step's {l0}")
    out.update(remat_rel=rel, remat_peak_gib=p1, plain_peak_gib=p0)
    return out


def phase15(dev, seconds: float = 60.0, overrides=(), timed: int = TIMED_STEPS) -> dict:
    """The feature-store workflow on `dev`: `cli.extract` (store_extract),
    `cli.train` of configs/seld.yml from the store with the host transforms (K1 =
    K2 = 0; the first step against the CPU's; the step split; a profiled step with
    its copy and idle share, in a process of its own; peak memory; checkpoints), the resident, precompute and remat
    variants (store_variants), then `cli.predict` of the trained best with the
    store's scaler (serve_from_disk: CSVs byte-identical to the in-memory
    pipeline's), `cli.infer --splits val` from the store (K1 = K2 = 0; scores
    against the same call on the CPU) and `cli.evaluate`."""
    cuda = dev.type == "cuda"
    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        exp = write_train_experiment(tmp, seconds, overrides=overrides)
        out["extract"] = store_extract(dev, exp, tmp)
        cfg = load_config(SELD_YML)
        apply_overrides(cfg, [f"feature_root_dir={out['extract']['dir']}",
                              f"gt_meta_root_dir={exp['cfg'].gt_meta_root_dir}",
                              f"split_meta_dir={exp['cfg'].split_meta_dir}", *STORE_OVERRIDES,
                              *overrides])
        os.makedirs(os.path.join(tmp, "store"))
        config = os.path.join(tmp, "store", os.path.basename(SELD_YML))
        save_config(cfg, config)
        group = os.path.join(tmp, "store_outputs")
        exp_dir = os.path.join(group, cfg.mode, cfg.data.audio_format, cfg.feature_type,
                               os.path.splitext(os.path.basename(config))[0])

        tr = cli_train.build_trainer(config, group, "_check", device=dev)
        out["first_step_rel"] = store_first_step(tr, dev)
        del tr
        if cuda:
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats(dev)
        t0 = time.perf_counter()
        tr, train_launches = counted(lambda: cli_train.train(config, group, device=dev))
        if cuda:
            torch.cuda.synchronize(dev)
        wall = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated(dev) / 2**30 if cuda else float("nan")
        n_steps = tr.steps_per_epoch * tr.max_epochs
        log("15", f"cli.train from the store: {len(tr.train_data)} chunks of {tr.chunk_len} "
                  f"frames, {tr.max_epochs} epochs of {tr.steps_per_epoch} steps at batch "
                  f"{tr.batch_size}, host transforms {type(tr.train_dataset.joint_transform).__name__}"
                  f" + {type(tr.train_dataset.transform).__name__}: {wall:.2f} s host clock; "
                  f"launches {train_launches}; read {tr.setup_seconds['read']:.3f} s; peak "
                  f"memory {peak:.2f} GiB [{CARD}]")
        if train_launches != {"salsa_spatial": 0, "noise_floor": 0}:
            raise AssertionError(f"cli.train from the store launched {train_launches}")
        ckpts = sorted(os.listdir(os.path.join(exp_dir, "models", "checkpoint")))
        want = [f"epoch{e:03d}.{x}" for e in range(tr.max_epochs) for x in ("json", "msgpack")]
        if ckpts != want or not os.path.isfile(os.path.join(exp_dir, "models", "best",
                                                            "best.msgpack")):
            raise AssertionError(f"{exp_dir}/models/checkpoint: {ckpts}, expected {want}")
        out["step"] = timed_store_steps(tr, dev, timed)
        st = out["step"]
        chunk_s = tr.chunk_len * cfg.data.hop_len / cfg.data.fs
        log("15", f"store-fed step, median of steps 3-{timed}: {st['step']:.2f} ms host clock = "
                  f"wait on the prefetch queue {st['wait']:.2f} + copy {st['copy']:.2f} + "
                  f"forward and backward {st['fwd_bwd']:.2f} + optimizer {st['optimizer']:.2f} "
                  f"ms; {1e3 / st['step']:.2f} steps/s, {tr.batch_size * chunk_s * 1e3 / st['step']:.1f}x "
                  f"realtime [{CARD}]")
        out.update(train_launches=train_launches, peak_gib=peak, n_steps=n_steps,
                   train_s=wall)
        if cuda:
            out["profile"] = profile_in_own_process(
                {"kind": "store_step", "config": config, "group": group}, tmp, "15")
            if out["profile"]["copy_ms"] is None:
                raise AssertionError("the store-fed step's profile has no Memcpy HtoD row "
                                     "for its upload")
        del tr
        if cuda:
            torch.cuda.empty_cache()
        out.update(store_variants(dev, config, group, timed))

        # serve the trained best with the store's scaler, byte-identical to the
        # in-memory pipeline (before infer, whose log records would read as restores)
        best = os.path.join(exp_dir, "models", "best", "best.msgpack")
        params, stats, _ = ckpt_restore_variables(best)
        served = {"config": config, "group": group, "wav_dir": exp["val_wav_dir"],
                  "gt_root": exp["cfg"].gt_meta_root_dir, "cfg": cfg,
                  "log": os.path.join(exp_dir, "logs", "log.txt"),
                  "scaler": FeatureStore(out["extract"]["dir"], "foa").scaler_path,
                  "served": best, "weights": {"params": params, "batch_stats": stats},
                  "scenes": tuple((n, seconds, FS) for n in VAL_CLIPS)}
        out["serve"] = serve_from_disk(dev, served, os.path.join(tmp, "serve"), tag="15")

        store_exp = {"group": group, "exp_dir": exp_dir}
        res, launches, rec = counted_infer(dev, store_exp, config, "", os.path.join(tmp, "inf"))
        if launches != {"salsa_spatial": 0, "noise_floor": 0}:
            raise AssertionError(f"cli.infer from the store launched {launches}")
        t0 = time.perf_counter()
        res_cpu = cli_infer.inference(config, group, splits=["val"], device="cpu")
        cpu_s = time.perf_counter() - t0
        got = load_dumps(os.path.join(tmp, "inf", "pred"))
        want_d = load_dumps(os.path.join(exp_dir, "outputs", "predictions", "val"))
        errs = [np.abs(got[n][k] - want_d[n][k]) for n in got
                for k in ("event_frame_pred", "doa_frame_pred")]
        share = min(float(np.mean(e <= 2e-3)) for e in errs)
        worst = max(float(e.max()) for e in errs)
        diffs = {k: abs(res["val"][k] - res_cpu["val"][k]) for k in res["val"]}
        log("15", f"cli.infer --splits val from the store: launches {launches}, "
                  f"{rec['wall_s']:.3f} s host clock (predict {rec['predict_s']:.3f} s), peak "
                  f"{rec['peak_gib']:.2f} GiB [{CARD}]; the same call on the CPU {cpu_s:.1f} s: "
                  f"dumps within 2e-3 on {share:.4%} of cells, max {worst:.2e}; scores "
                  + ", ".join(f"{k} {res['val'][k]:.4f}/{res_cpu['val'][k]:.4f}"
                              for k in res["val"]))
        if share < 0.999 or worst > 2e-2 or max(v for k, v in diffs.items()
                                                 if k != "LE") > 0.02 or diffs["LE"] > 1.0:
            raise AssertionError(f"cli.infer on {dev} vs the CPU: {share}, {worst}, {diffs}")
        scores = cli_evaluate.main(["--output-dir", os.path.join(tmp, "inf", "csv"),
                                    "--gt-meta-root-dir", exp["cfg"].gt_meta_root_dir,
                                    "--n-classes", str(cfg.data.n_classes)])
        if any(abs(scores[k] - res["val"][k]) > 1e-12 for k in scores):
            raise AssertionError(f"cli.evaluate {scores} vs cli.infer {res['val']}")
        log("15", "cli.evaluate of the infer's CSVs prints its scores: " + ", ".join(
            f"{k} {v:.4f}" for k, v in scores.items()))
        out.update(infer_launches=launches, scores=res["val"], scores_cpu=res_cpu["val"])
    return out



# ---------------------------------------------------------------------------
# phase 16: data-parallel training, the checkpoint interop CLIs, profiling and
# SALSA at 6 channels

# phase 9's clips and config, cut to one epoch of 3 steps at batch 32 (constant lr:
# a resumed run's schedule does not depend on its epoch count)
PARALLEL_OVERRIDES = ("training.max_epochs=1", "data.train_fraction=0.25", CONSTANT_LR)
# the store path: 2 epochs of 2 steps (420 chunks of the 4 train clips // 32 x 0.2)
STORE_PARALLEL_OVERRIDES = ("training.device_data=true", "training.device_data_shard=true",
                            "training.max_epochs=2", "data.train_fraction=0.2", CONSTANT_LR)
RANK_TIMEOUT_S = 480  # a rank that has not finished by then fails the phase
TIMED_RANK_STEPS = 4  # steps timed after a rank's run; the median is of steps 2 onward
SIX_MICS = 6


def free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def launch_ranks(spec: dict, n_ranks: int, tmp: str, launcher: str = "torchrun") -> list[dict]:
    """Run `chip_smoke.py --rank <spec>` as `n_ranks` processes, each with the
    environment of its launcher (torchrun's MASTER_ADDR / MASTER_PORT / RANK /
    WORLD_SIZE / LOCAL_RANK, or SALSA_COORDINATOR / SALSA_NUM_PROCESSES /
    SALSA_PROCESS_ID) and its own timeout; returns each rank's JSON result in rank
    order. Any rank that fails or times out fails the phase, with its stderr."""
    path = os.path.join(tmp, f"rank_spec_{free_port()}.json")
    with open(path, "w") as f:
        json.dump(spec, f)
    port, procs = free_port(), []
    drop = ("MASTER_ADDR", "MASTER_PORT", "RANK", "WORLD_SIZE", "LOCAL_RANK", "LOCAL_WORLD_SIZE",
            "SALSA_COORDINATOR", "SALSA_NUM_PROCESSES", "SALSA_PROCESS_ID")
    for r in range(n_ranks):
        env = {k: v for k, v in os.environ.items() if k not in drop}
        # the ranks share this process's cores: intra-op threads that outnumber
        # them spin (a CPU step ran 40x slower)
        env.update(PYTHONPATH=REPO,
                   OMP_NUM_THREADS=str(max(1, torch.get_num_threads() // n_ranks)))
        if launcher == "torchrun":
            env.update(MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port), RANK=str(r),
                       WORLD_SIZE=str(n_ranks), LOCAL_RANK=str(r))
        else:
            env.update(SALSA_COORDINATOR=f"127.0.0.1:{port}", SALSA_NUM_PROCESSES=str(n_ranks),
                       SALSA_PROCESS_ID=str(r))
        procs.append(subprocess.Popen([sys.executable, os.path.abspath(__file__), "--rank", path],
                                      cwd=REPO, env=env, stdout=subprocess.PIPE,
                                      stderr=subprocess.PIPE, text=True))
    outs, failed = [], []
    try:
        for r, p in enumerate(procs):
            try:
                out, err = p.communicate(timeout=RANK_TIMEOUT_S)
            except subprocess.TimeoutExpired:
                p.kill()
                out, err = p.communicate()
                failed.append(f"rank {r} of {n_ranks} timed out after {RANK_TIMEOUT_S} s:\n"
                              f"{err[-2000:]}")
                continue
            if p.returncode != 0:
                failed.append(f"rank {r} of {n_ranks} exited {p.returncode}:\n{err[-3000:]}")
            else:
                outs.append(json.loads(out.strip().splitlines()[-1]))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    if failed:
        raise AssertionError("\n".join(failed))
    return outs


def gloo_cuda_collectives(dev) -> dict[str, str]:
    """Which collectives the rank's process group takes on tensors of `dev`: each of
    all_reduce, broadcast and all_gather run once ('ok'), or its error. gloo copies
    CUDA tensors through the host inside the collective."""
    out = {}
    t = torch.full((4,), float(distributed.process_index() + 1), device=dev)
    tries = {"all_reduce": lambda: torch.distributed.all_reduce(t.clone()),
             "broadcast": lambda: torch.distributed.broadcast(t.clone(), 0),
             "all_gather": lambda: torch.distributed.all_gather(
                 [torch.empty_like(t) for _ in range(distributed.process_count())], t)}
    for name, fn in tries.items():
        try:
            fn()
            out[name] = "ok"
        except Exception as e:  # noqa: BLE001 - reported, and the phase checks the ones it uses
            out[name] = f"{type(e).__name__}: {str(e).splitlines()[0][:120]}"
    return out


def fit_instrumented(tr, dev, resume_from: str | None = None, timed: int = 0) -> dict:
    """`tr.fit(resume_from)` with K1 and K2 counted from 0 just before it and read just
    after, every epoch's step losses, the peak memory of the run, the time inside
    the collectives (CUDA events around every `distributed.all_reduce_sum`), then
    `timed` more steps each between CUDA events (host clock on the CPU)."""
    cuda = dev.type == "cuda"
    spans = []
    plain_sum = distributed.all_reduce_sum

    def timed_sum(t):
        if not cuda:
            spans.append(None)
            return plain_sum(t)
        ev = (torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
        ev[0].record()
        out = plain_sum(t)
        ev[1].record()
        spans.append(ev)
        return out

    if cuda:
        torch.cuda.synchronize(dev)
        torch.cuda.reset_peak_memory_stats(dev)
    distributed.all_reduce_sum = timed_sum
    try:
        with recorded_epochs() as epochs:
            (_, launches) = counted(lambda: tr.fit(resume_from=resume_from))
        if cuda:
            torch.cuda.synchronize(dev)
        peak = torch.cuda.max_memory_allocated(dev) / 2**30 if cuda else float("nan")
        steps, colls, n_colls = [], [], []
        order = tr._epoch_order(tr.max_epochs)
        for s in range(timed):
            ids = order[(s * tr.batch_size) % len(order):][:tr.batch_size]
            spans.clear()
            if cuda:
                ev = (torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
                ev[0].record()
                tr.train_step(ids)
                ev[1].record()
                ev[1].synchronize()
                steps.append(ev[0].elapsed_time(ev[1]))
                colls.append(sum(ev[0].elapsed_time(ev[1]) for ev in spans))
            else:
                t0 = time.perf_counter()
                tr.train_step(ids)
                steps.append((time.perf_counter() - t0) * 1e3)
                colls.append(0.0)
            n_colls.append(len(spans))
    finally:
        distributed.all_reduce_sum = plain_sum
    med = (lambda v: statistics.median(v[1:]) if len(v) > 1 else (v[0] if v else float("nan")))
    return {"rank": tr.rank, "n_ranks": tr.n_ranks, "device": str(tr.device),
            "rows": tr.batch_size // tr.n_ranks, "count": tr.optimizer.count - len(steps),
            "fit_steps": sum(len(ls) for _, ls in epochs),
            "steps_per_epoch": tr.steps_per_epoch, "launches": launches,
            "step_losses": [l for _, ls in epochs for l in ls], "peak_gib": peak,
            "step_ms": med(steps), "collective_ms": med(colls),
            "collectives_per_step": n_colls[-1] if n_colls else 0,
            "device_data_shard": bool(tr.device_data_shard),
            "backend": (torch.distributed.get_backend() if distributed.is_initialized()
                        else None)}


def stratify_like(tr, n_shards: int) -> None:
    """Give a one-rank store trainer the epoch order that `n_shards` ranks of
    device_data_shard take (`stratified_order` over the clips' shards), so that its
    steps see their global batches."""
    counts = np.asarray(tr.train_data.clip_chunk_counts)
    m, _ = mesh.shard_rows(len(counts), n_shards)
    shard = np.repeat(np.arange(len(counts)), counts) // m
    ids = [np.flatnonzero(shard == r) for r in range(n_shards)]
    tr._epoch_order = lambda epoch: stratified_order(ids, tr.batch_size, tr._shuffle_rng(epoch))


def rank_main(spec_path: str) -> None:
    """One rank of a phase-16 run (`chip_smoke.py --rank <spec.json>`): forms the
    process group from its launcher's environment, builds `cli.train`'s trainer on
    its card (cuda:{LOCAL_RANK % device_count}, or the spec's device), trains with
    `fit_instrumented` (resumed from the experiment's latest checkpoint with
    `resume`) in deterministic mode, and prints its result as one JSON line."""
    with open(spec_path) as f:
        spec = json.load(f)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    distributed.initialize(timeout_s=float(RANK_TIMEOUT_S))
    try:
        dev = cli_train.resolve_device(spec.get("device", "cuda"))
        probe = gloo_cuda_collectives(dev) if distributed.process_count() > 1 else {}
        with deterministic(dev):
            tr = cli_train.build_trainer(spec["config"], spec["group"], spec["suffix"],
                                         overrides=spec.get("overrides"), device=dev)
            resume = (ckpt_latest(tr.cfg.dir.model.checkpoint) if spec.get("resume") else None)
            out = fit_instrumented(tr, dev, resume, spec.get("timed", 0))
        out["collectives"] = probe
    finally:
        distributed.shutdown()
    print(json.dumps(out), flush=True)


def compare_losses(got: list[float], want: list[float], what: str, first: float,
                   rest: float | None = None, tag: str = "16") -> float:
    """Per-step losses of two runs: the first within `first` relative, every step
    within `rest` (default `first`); returns the largest relative difference."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    if got.shape != want.shape or not np.isfinite(got).all():
        raise AssertionError(f"{what}: {got} vs {want}")
    rel = np.abs(got - want) / np.abs(want)
    log(tag, f"{what}: {len(got)} steps, relative differences {np.array2string(rel, precision=2)}"
             f" (bounds {first:g} first step, {rest or first:g} every step)")
    if not (rel[0] <= first and np.all(rel <= (rest or first))):
        raise AssertionError(f"{what}: {got.tolist()} vs {want.tolist()}")
    return float(rel.max())


def trees_equal(a, b) -> bool:
    """Two nested dicts of arrays with the same keys and bit-equal arrays."""
    if isinstance(a, dict) or isinstance(b, dict):
        return (isinstance(a, dict) and isinstance(b, dict) and a.keys() == b.keys()
                and all(trees_equal(a[k], b[k]) for k in a))
    return np.array_equal(np.asarray(a), np.asarray(b))


def check_rank_launches(ranks: list[dict], dev, what: str) -> None:
    """Every rank of a from-wav run launched K1 and K2 once a step of its own rows
    (none on the CPU, whose plain versions count nothing)."""
    for r in ranks:
        n = r["fit_steps"]
        want = {"salsa_spatial": n, "noise_floor": n} if dev.type == "cuda" else \
            {"salsa_spatial": 0, "noise_floor": 0}
        if r["launches"] != want:
            raise AssertionError(f"{what}: rank {r['rank']} launched {r['launches']} in its "
                                 f"{n} steps, expected {want}")


def report_ranks(ranks: list[dict], what: str, tag: str = "16") -> None:
    for r in ranks:
        share = r["collective_ms"] / r["step_ms"] if r["step_ms"] else float("nan")
        log(tag, f"{what} rank {r['rank']}/{r['n_ranks']} ({r['backend']}, {r['device']}, "
                 f"{r['rows']} rows): launches {r['launches']}; step {r['step_ms']:.2f} ms, "
                 f"inside its {r['collectives_per_step']} collectives {r['collective_ms']:.2f} "
                 f"ms ({share:.1%}); peak memory {r['peak_gib']:.2f} GiB [{CARD}]")


def mic_array_clip(n_mics: int, seconds: float, seed: int) -> torch.Tensor:
    """(1, n_mics, seconds * FS) float32: a seeded MIC array's clip, diffuse noise
    plus a source (noise and an 1100 Hz tone, on 3 s of every 5) each mic hears
    0-4 samples late."""
    rng = np.random.default_rng(seed)
    n = int(round(seconds * FS))
    t = np.arange(n) / FS
    wave = 0.02 * rng.standard_normal((1, n_mics, n))
    src = (0.2 * rng.standard_normal(n) + np.sin(2 * np.pi * 1100.0 * t)) * ((t % 5.0) < 3.0)
    for m, d in enumerate(rng.integers(0, 5, n_mics)):
        wave[0, m, d:] += src[:n - d]
    return torch.from_numpy(wave.astype(np.float32))


def array_salsa(dev, n_mics: int, seconds: float, phase: str, seed: int) -> dict:
    """SALSA of a seeded `n_mics`-mic array on `dev` against the CPU's plain run: K2
    on channel 0 and the power iteration (K1 is a 4-channel kernel): one K2 launch,
    no K1; 2C - 1 channels; spectrograms within 5e-3, the spatial channels at
    phase 2's mask bound on the circle."""
    wave = mic_array_clip(n_mics, seconds, seed)
    ex = make_extractor("salsa", "mic", fs=FS, n_fft=N_FFT, hop_length=HOP, n_mics=n_mics)
    got, launches = counted(lambda: ex(wave.to(dev)))
    want = ex(wave)
    want_launches = ({"salsa_spatial": 0, "noise_floor": 1} if dev.type == "cuda"
                     else {"salsa_spatial": 0, "noise_floor": 0})
    if launches != want_launches or got.shape[1] != 2 * n_mics - 1 or (
            ex.n_channels != 2 * n_mics - 1):
        raise AssertionError(f"{n_mics}-channel SALSA: launches {launches}, shape "
                             f"{tuple(got.shape)}")
    np.testing.assert_allclose(got[:, :n_mics].cpu().numpy(), want[:, :n_mics].numpy(),
                               atol=5e-3, rtol=5e-3, err_msg=f"{n_mics}-channel spectrograms")
    nb = MIC.upper_bin - MIC.lower_bin
    err = compare_spatial(got[:, n_mics:, :, :nb].transpose(-1, -2),
                          want[:, n_mics:, :, :nb].transpose(-1, -2),
                          f"{n_mics}-channel SALSA {tuple(got.shape)} on {dev.type} vs the CPU",
                          phase=phase, period=mic_period(MIC, nb))
    log(phase, f"{n_mics}-channel SALSA ({n_mics} mics, {seconds:g} s): {ex.n_channels} "
               f"channels, launches {launches}")
    return {"launches": launches, "max_abs_err": err}


def six_channel_salsa(dev, seconds: float = 10.0) -> dict:
    """`array_salsa` of a 6-mic array (phase 16 (f))."""
    return array_salsa(dev, SIX_MICS, seconds, "16", SEED + 16)


def k1_trace(dev, log_dir: str, tr_shape=(32, 4, 191, 646)) -> dict:
    """`utils.profiling.trace` of one K1 call at the training step's shape inside a
    `record_function`: the traced call's bytes, whether the trace holds the
    call's range and K1's device row, and the device events that came back."""
    rng = np.random.default_rng(SEED + 17)
    xr, xi = normal_planes(rng, tr_shape, dev)
    mask = torch.ones((tr_shape[0], tr_shape[2], tr_shape[3] - 6), dtype=torch.bool, device=dev)
    salsa_spatial(xr, xi, mask, **spatial_kw(FOA))  # built and warm before the trace
    with profiling.trace(log_dir) as prof:
        with torch.profiler.record_function("K1 salsa_spatial"):
            salsa_spatial(xr, xi, mask, **spatial_kw(FOA))
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
    with open(os.path.join(log_dir, "trace.json")) as f:
        text = f.read()
    return {"trace_bytes": len(text), "record_row": "K1 salsa_spatial" in text,
            "kernel_row": "salsa_spatial_kernel" in text, "device_events": prof.device_events}


def profile_in_own_process(spec: dict, tmp: str, phase: str) -> dict:
    """Run one profiled measurement (`profile_main`) in a fresh process of its own
    and return its result: `chip_smoke.py --profile <spec.json>`."""
    path = os.path.join(tmp, f"profile_{spec['kind']}.json")
    with open(path, "w") as f:
        json.dump(spec, f)
    r = subprocess.run([sys.executable, os.path.abspath(__file__), "--profile", path],
                       capture_output=True, text=True, timeout=600, cwd=REPO)
    for line in r.stdout.splitlines()[:-1]:
        print(line, flush=True)
    if r.returncode != 0:
        raise AssertionError(f"the profiled {spec['kind']} in its own process exited "
                             f"{r.returncode}: {r.stderr[-3000:]}")
    out = json.loads(r.stdout.splitlines()[-1])
    log(phase, f"profiled {spec['kind']} in a process of its own: {out}")
    return out


PROFILE_SESSIONS = 3  # sessions a profiled measurement of its own process may take


def profile_main(spec_path: str) -> None:
    """One profiled measurement in a fresh process (`chip_smoke.py --profile
    <spec.json>`): 'k1_trace' (`k1_trace` into the spec's directory) or
    'store_step' (`cli.train`'s trainer of the spec's store experiment, two warm
    steps, then `profile_table` of one step with its upload). CUPTI drops rows now
    and then in a fresh process too (a copy's row in some short processes on the
    card), so up to PROFILE_SESSIONS sessions are taken until the row looked for
    is there; `sessions` says how many. Prints its result as the last line."""
    global CARD
    with open(spec_path) as f:
        spec = json.load(f)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device(spec.get("device", "cuda"))
    CARD = smi("name,power.limit") if dev.type == "cuda" else "cpu"
    if spec["kind"] == "k1_trace":
        def measure(i):
            return k1_trace(dev, os.path.join(spec["log_dir"], str(i)),
                            tuple(spec.get("shape", (32, 4, 191, 646))))

        def found(out):
            return out["kernel_row"]
    else:
        tr = cli_train.build_trainer(spec["config"], spec["group"], "_profile", device=dev)
        batches = iter(tr.host_batches(tr.max_epochs + 5))
        for _ in range(2):
            tr.step_on(*tr.to_device(next(batches)))
        b = next(batches)
        nbytes = sum(t.numel() * t.element_size() for t in b)

        def measure(i):
            return profile_table(lambda: tr.step_on(*tr.to_device(b)), "15",
                                 "one store-fed step (copy included), own process", top=12,
                                 upload_bytes=nbytes)

        def found(out):
            return out["copy_ms"] is not None
    for i in range(1, PROFILE_SESSIONS + 1):
        out = measure(i)
        if found(out):
            break
    out["sessions"] = i
    print(json.dumps(out), flush=True)


def profiling_check(dev, tmp: str, tr_shape=(32, 4, 191, 646)) -> dict:
    """`utils.profiling.device_timer` on K1 at the training step's shape, and
    `trace` of one call in a process of its own (CUPTI can hand a late session of
    this long process no device activity), whose Chrome trace must hold the traced
    call and, on the card, K1's device row."""
    rng = np.random.default_rng(SEED + 17)
    xr, xi = normal_planes(rng, tr_shape, dev)
    mask = torch.ones((tr_shape[0], tr_shape[2], tr_shape[3] - 6), dtype=torch.bool, device=dev)
    s = profiling.device_timer(lambda *a: salsa_spatial(*a, **spatial_kw(FOA)), xr, xi, mask,
                               iters=7)
    traced = profile_in_own_process({"kind": "k1_trace", "log_dir": os.path.join(tmp, "trace"),
                                     "device": dev.type, "shape": list(tr_shape)}, tmp, "16")
    if not traced["record_row"] or (dev.type == "cuda" and not traced["kernel_row"]):
        raise AssertionError(f"profiling.trace of K1 holds no row for it: {traced}")
    log("16", f"profiling.device_timer: K1 at {tr_shape} {s * 1e3:.4f} ms median of 7 "
              f"(bound {k1_bound(tr_shape)[0]:.4f} ms) [{CARD}]; profiling.trace in a process "
              f"of its own: {traced['trace_bytes']} bytes, {traced['device_events']} device "
              f"events, K1's device row {'present' if traced['kernel_row'] else 'missing'}, "
              f"{traced['sessions']} session(s)")
    return {"k1_ms": s * 1e3, "k1_bound": k1_bound(tr_shape), "trace": traced}


def phase16(dev, seconds: float = 60.0, overrides=(), timed: int = TIMED_RANK_STEPS,
            k1_shape=(32, 4, 191, 646)) -> dict:
    """Data-parallel training of configs/seld.yml from phase 9's clips: (a) one rank
    over NCCL (gloo on the CPU) against the same run without a process group; (b)
    two ranks sharing the card over gloo, batch 16 each, against (a), K1 and K2 once
    a step in every rank; (c) device_data_shard on two ranks from a store of the
    clips against device_data on one rank in the same order; (d) that run stopped
    after an epoch and resumed on two ranks; (e) export_ckpt and import_ckpt of
    (a)'s best, served by cli.predict byte-identically; (f) SALSA at 6 channels;
    (g) profiling: K1's device_timer and a trace holding K1's device row."""
    cuda = dev.type == "cuda"
    out = {}
    t_phase = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        exp = write_train_experiment(tmp, seconds, overrides=(*PARALLEL_OVERRIDES, *overrides))
        spec = {"config": exp["config"], "group": exp["group"], "device": dev.type,
                "timed": timed}
        with deterministic(dev):
            solo = fit_instrumented(cli_train.build_trainer(exp["config"], exp["group"], "_solo",
                                                            device=dev), dev, timed=timed)
        if cuda:
            torch.cuda.empty_cache()
        one = launch_ranks({**spec, "suffix": "_one"}, 1, tmp)
        want_backend = "nccl" if cuda else "gloo"
        if one[0]["n_ranks"] != 1 or one[0]["backend"] != want_backend:
            raise AssertionError(f"(a) ran {one[0]['n_ranks']} ranks on {one[0]['backend']}")
        out["one_rel"] = compare_losses(one[0]["step_losses"], solo["step_losses"],
                                        f"(a) one rank over {want_backend} vs no process group",
                                        1e-6)
        check_rank_launches(one, dev, "(a)")
        two = launch_ranks({**spec, "suffix": "_two"}, 2, tmp)
        if [r["rank"] for r in two] != [0, 1] or any(
                r["backend"] != "gloo" or r["rows"] * 2 != solo["rows"] for r in two):
            raise AssertionError(f"(b) ranks {[(r['rank'], r['backend'], r['rows']) for r in two]}")
        for name in ("all_reduce", "broadcast"):  # the collectives the trainer runs
            if two[0]["collectives"][name] != "ok":
                raise AssertionError(f"(b) gloo {name} on {dev.type} tensors: "
                                     f"{two[0]['collectives'][name]}")
        log("16", f"(b) gloo on {dev.type} tensors (host copies inside the collective): "
                  f"{two[0]['collectives']}")
        if two[0]["step_losses"] != two[1]["step_losses"]:
            raise AssertionError("(b) the ranks logged different global losses")
        out["two_rel"] = compare_losses(two[0]["step_losses"], one[0]["step_losses"],
                                        "(b) two ranks on one card vs one rank", 1e-4, 2e-3)
        check_rank_launches(two, dev, "(b)")
        report_ranks(one + two, "from wav")
        out.update(solo=solo, one=one[0], two=two)

        # (c) and (d): the store of the clips, device_data_shard on two ranks
        data = load_config(TNSSE_SALSA_YML)
        data.data_dir, data.feature_dir = os.path.dirname(exp["wav_dir"]), os.path.join(
            tmp, "features")
        data_path = os.path.join(tmp, "tnsse2021_salsa.yml")
        save_config(data, data_path)
        store = cli_extract.extract_features(data_path, "salsa", batch_size=EXTRACT_BATCH,
                                             splits=["foa_dev"], device=dev)
        os.makedirs(os.path.join(tmp, "store"))
        cfg = load_config(exp["config"])
        apply_overrides(cfg, [f"feature_root_dir={store}", "training.from_wav=false",
                              *STORE_PARALLEL_OVERRIDES])
        store_cfg = os.path.join(tmp, "store", os.path.basename(exp["config"]))
        save_config(cfg, store_cfg)
        sspec = {"config": store_cfg, "group": exp["group"], "device": dev.type}
        with deterministic(dev):
            tr = cli_train.build_trainer(store_cfg, exp["group"], "_dd", device=dev)
            stratify_like(tr, 2)
            dd = fit_instrumented(tr, dev)
        del tr
        shard = launch_ranks({**sspec, "suffix": "_shard"}, 2, tmp)
        if not all(r["device_data_shard"] for r in shard) or dd["device_data_shard"]:
            raise AssertionError("(c) device_data_shard did not shard on 2 ranks, or did on 1")
        out["shard_rel"] = compare_losses(shard[0]["step_losses"], dd["step_losses"],
                                          "(c) device_data_shard on two ranks vs device_data "
                                          "on one", 1e-4)
        first = launch_ranks({**sspec, "suffix": "_resume",
                              "overrides": ["training.max_epochs=1"]}, 2, tmp)
        resumed = launch_ranks({**sspec, "suffix": "_resume", "resume": True}, 2, tmp,
                               launcher="salsa")
        if resumed[0]["count"] != shard[0]["count"]:
            raise AssertionError(f"(d) resumed to step {resumed[0]['count']}, the uninterrupted "
                                 f"run to {shard[0]['count']}")
        out["resume_rel"] = compare_losses(first[0]["step_losses"] + resumed[0]["step_losses"],
                                           shard[0]["step_losses"],
                                           f"(d) {first[0]['count']} + "
                                           f"{resumed[0]['count'] - first[0]['count']} steps "
                                           "resumed on two ranks vs uninterrupted", 1e-4)

        # (e) export (a)'s best and import it into a new experiment; both served
        solo_dir = exp["exp_dir"] + "_solo"
        ckpt_out = os.path.join(tmp, "exported.ckpt")
        cli_export_ckpt.main(["--exp-config", exp["config"], "--exp-group-dir", exp["group"],
                              "--exp-suffix", "_solo", "--out", ckpt_out])
        imported = cli_import_ckpt.main(["--exp-config", exp["config"], "--torch-ckpt", ckpt_out,
                                         "--exp-group-dir", exp["group"],
                                         "--exp-suffix", "_imported"])
        shutil.copyfile(os.path.join(solo_dir, "models", "feature_scaler.npz"),
                        os.path.join(exp["exp_dir"] + "_imported", "models", "feature_scaler.npz"))
        original = ckpt_best(os.path.join(solo_dir, "models", "best"))
        for a, b in zip(ckpt_restore_variables(original)[:2], ckpt_restore_variables(imported)[:2]):
            if not trees_equal(a, b):
                raise AssertionError(f"(e) {imported} differs from {original}")
        csv_dirs = []
        for suffix in ("_solo", "_imported"):
            d = os.path.join(tmp, f"pred{suffix}")
            cli_predict.predict(exp["config"], exp["val_wav_dir"], d, exp["group"], suffix,
                                device=dev)
            csv_dirs.append(d)
        if differing_files(*csv_dirs):
            raise AssertionError(f"(e) the imported experiment's CSVs differ: "
                                 f"{differing_files(*csv_dirs)}")
        log("16", f"(e) export_ckpt -> import_ckpt of {original}: parameters bit-equal, "
                  f"cli.predict on {dev.type} writes byte-identical CSVs "
                  f"({len(os.listdir(csv_dirs[0]))} files)")
        out["six"] = six_channel_salsa(dev)
        out["profile"] = profiling_check(dev, tmp, k1_shape)
    out["seconds"] = time.perf_counter() - t_phase
    log("16", f"phase 16: {out['seconds']:.1f} s host clock [{CARD}]")
    return out


# the port's measurement scripts as phase 17 runs them on the card: argv, and the
# keys of the counterpart in scripts/ each JSON must hold (its JSON keys, or the
# names of its cases and printed figures)
SCRIPT_RUNS = {
    "bench_train": [["--iters", "5"], ["--iters", "5", "--from-wav"],
                    ["--iters", "5", "--bf16", "--encoder", "PannResNet22TPU"]],
    "bench_streaming": [["--encoder", "PannResNet22"],
                        ["--pool", "--streams", "2", "--int16", "--seconds", "10"]],
    "profile_step": [["--iters", "3"]],
    "probe_extract_stages": [["--batch", "4", "32", "--iters", "5"]],
    "probe_stft_split": [["--iters", "3"]],
    "quality_seeds": [["--seeds", "1", "2", "--clips", "4", "--epochs", "1", "--members", "1"]],
}
SCRIPT_KEYS = {
    "bench_train": {"metric", "steps_per_s", "audio_s_per_s", "batch", "bf16", "loss"},
    "bench_streaming": {"wall_s", "x_realtime_aggregate", "p50_ms", "p95_ms", "max_ms"},
    "profile_step": {"batch", "device", "full_step_ms", "fwd_train_ms", "fwd_eval_ms",
                     "fwd_bwd_ms", "peak_matmul_tflops", "effective_tflops_fwd_bwd"},
    "probe_extract_stages": {"stft", "stft_n256", "+logspec", "+tracker", "full"},
    "probe_stft_split": {"stft_cur", "stft_split", "prep_cur", "prep_split", "full_cur",
                         "full_split", "full_cur_b64", "full_split_b64"},
    "quality_seeds": {"seeds", "table"},
}
MANY_MICS = (17, 24, 32)


def finite_values(value) -> bool:
    """Every float in a nest of dicts and lists is finite."""
    if isinstance(value, dict):
        return all(finite_values(v) for v in value.values())
    if isinstance(value, (list, tuple)):
        return all(finite_values(v) for v in value)
    return not isinstance(value, float) or bool(np.isfinite(value))


def run_scripts(dev, runs: dict, tmp: str) -> dict:
    """Each script's `main(argv)` in this process (`--cpu` added off the card), its
    JSON checked for the counterpart's keys and finite values; returns the JSONs."""
    from salsa_tpu_torch import scripts

    out = {}
    for name, argvs in runs.items():
        mod = importlib.import_module(f"{scripts.__name__}.{name}")
        for argv in argvs:
            argv = list(argv) + (["--cpu"] if dev.type == "cpu" else [])
            if name == "quality_seeds":
                argv += ["--workdir", os.path.join(tmp, "quality_seeds")]
            t0 = time.perf_counter()
            res = mod.main(argv)
            secs = time.perf_counter() - t0
            rows = (res["probe_extract_stages"] if name == "probe_extract_stages"
                    else [res])
            missing = [SCRIPT_KEYS[name] - set(r) for r in rows]
            if any(missing) or not finite_values(res):
                raise AssertionError(f"{name} {argv}: keys missing {missing} or a value not "
                                     f"finite: {res}")
            log("17", f"(c) {name} {' '.join(argv)}: {secs:.1f} s host clock, its JSON has "
                      f"the original's keys, every value finite")
            out.setdefault(name, []).append(res)
            if dev.type == "cuda":
                torch.cuda.empty_cache()
    return out


TB_OVERRIDES = ("training.max_epochs=1", "training.train_batch_size=4",
                "data.train_fraction=0.25")
GOLDEN_ORBAX = os.path.join(REPO, "tests", "golden", "orbax_small", "orbax_small")


def tensorboard_check(dev, exp: dict) -> dict:
    """`cli.train` of two steps (configs/seld.yml from wav, batch 4, validated once)
    of `exp` on `dev`: with tensorboardX, the experiment's event file holds
    `train/<k>` and `val/<k>` at the step count; without it, the log says that no
    scalar was written."""
    tr, launches, wall = counted_train(dev, exp["config"], exp["group"])
    tb_dir = tr.cfg.dir.tb_dir
    out = {"steps": tr.optimizer.count, "launches": launches, "seconds": wall}
    try:
        import tensorboardX  # noqa: F401
    except ImportError:
        with open(os.path.join(exp["exp_dir"], "logs", "log.txt")) as f:
            said = "tensorboardX does not import: no TensorBoard scalars" in f.read()
        files = os.listdir(tb_dir) if os.path.isdir(tb_dir) else []
        if not said or files:
            raise AssertionError(f"(d) without tensorboardX: log line {said}, {tb_dir} holds "
                                 f"{files}")
        out["tensorboard"] = "tensorboardX does not import: nothing written, said once"
    else:
        scalars = read_event_scalars(tb_dir)
        want = {f"train/{k}" for k in ("loss", "sed_loss", "doa_loss", "lr", "momentum")} | {
            f"val/{k}" for k in ("val_loss", "seld_error", "ER", "F1", "LE", "LR")}
        steps = {s for v in scalars.values() for s, _ in v}
        if not want <= set(scalars) or steps != {tr.optimizer.count}:
            raise AssertionError(f"(d) event file tags {sorted(scalars)} at steps {steps}")
        out["tensorboard"] = f"{len(scalars)} tags at step {tr.optimizer.count}"
    log("17", f"(d) cli.train of {tr.optimizer.count} steps ({wall:.1f} s, launches {launches}):"
              f" {out['tensorboard']}")
    return out


def payload_diff(a, b, path: str = "") -> list[str]:
    """Where two checkpoint payloads differ: a key, a type, a dtype, a shape or a
    bit; [] when they are equal."""
    if isinstance(a, dict) or isinstance(b, dict):
        if not (isinstance(a, dict) and isinstance(b, dict)) or a.keys() != b.keys():
            return [f"{path or '/'}: keys"]
        return [d for k in a for d in payload_diff(a[k], b[k], f"{path}/{k}")]
    if type(a) is not type(b) or getattr(a, "dtype", None) != getattr(b, "dtype", None):
        return [f"{path}: {type(a).__name__} {getattr(a, 'dtype', '')} against "
                f"{type(b).__name__} {getattr(b, 'dtype', '')}"]
    return [] if np.array_equal(a, b) else [f"{path}: values"]


def read_payload(path: str) -> dict:
    """The payload of a `.msgpack` file or `.orbax` directory, as the port reads it."""
    if path.endswith(".orbax"):
        return orbax_checkpoint.restore(path)
    with open(path, "rb") as f:
        return msgpack_restore(f.read())


def tree_bytes(path: str) -> int:
    if os.path.isfile(path):
        return os.path.getsize(path)
    return sum(os.path.getsize(os.path.join(d, f)) for d, _, fs in os.walk(path) for f in fs)


def orbax_twin(tr, exp_dir: str, twin_dir: str) -> list[str]:
    """A copy of the experiment `exp_dir` with each `.orbax` checkpoint replaced by
    a `.msgpack` of the trainer's state, which every checkpoint of a one-epoch run
    holds; returns the twin's checkpoints."""
    shutil.copytree(exp_dir, twin_dir, ignore=shutil.ignore_patterns("*.orbax"))
    params, stats = torch_state_dict_to_flax(tr.model.state_dict())
    opt_state = tr.optimizer.optax_state(tr.model)
    written = []
    for d in (tr.cfg.dir.model.checkpoint, tr.cfg.dir.model.best):
        for fn in sorted(os.listdir(d)):
            if fn.endswith(".orbax"):
                name = fn[:-len(".orbax")]
                twin = os.path.join(twin_dir, os.path.relpath(d, exp_dir))
                meta = ckpt_load_metadata(os.path.join(d, fn))
                written.append(save_checkpoint(twin, name, params, stats, tr.optimizer.count,
                                               meta, opt_state=opt_state))
    return written


def orbax_check(dev, exp: dict, tmp: str, repeats: int = 3) -> dict:
    """(e) `training.checkpoint_backend: orbax` through the CLIs on `dev`, at
    `exp`'s width: `cli.train` writes `.orbax` checkpoints that restore bit-equal
    to the trainer's state (its msgpack twin); the restore's host-clock time
    against the twin's; `cli.predict` serves the `.orbax` experiment with one K1
    and one K2 launch a group, its CSVs byte-identical to the twin experiment's;
    `--resume` from `.orbax` bit-equal to `--resume` from the twin (deterministic
    mode); the committed fixture that salsa_tpu's orbax wrote restores through
    the C++ decoder equal to its msgpack twin, and the C++ and plain decoders
    agree byte for byte on its frames, both timed; an unknown backend refused."""
    cuda = dev.type == "cuda"
    out = {}
    tr, launches, wall = counted_train(dev, exp["config"], exp["group"], "_orbax",
                                       overrides=["training.checkpoint_backend=orbax"])
    if cuda:
        check_train_launches(launches, tr.optimizer.count, "(e) cli.train with orbax")
    exp_o, exp_t = exp["exp_dir"] + "_orbax", exp["exp_dir"] + "_twin"
    best = ckpt_best(tr.cfg.dir.model.best)
    saved = sorted(os.listdir(tr.cfg.dir.model.checkpoint))
    if not best.endswith("best.orbax") or saved != ["epoch000.json", "epoch000.orbax"]:
        raise AssertionError(f"(e) cli.train with orbax wrote {saved} and best {best}")
    twins = orbax_twin(tr, exp_o, exp_t)
    for twin in twins:
        rel = os.path.relpath(twin, exp_t)[:-len(".msgpack")] + ".orbax"
        diff = payload_diff(read_payload(os.path.join(exp_o, rel)), read_payload(twin))
        if diff:
            raise AssertionError(f"(e) {rel} against the trainer's state: {diff[:5]}")
    twin_best = os.path.join(exp_t, os.path.relpath(best, exp_o))[:-len(".orbax")] + ".msgpack"
    times = {}
    for kind, path in (("orbax", best), ("msgpack", twin_best)):
        runs = []
        for _ in range(repeats):
            t0 = time.perf_counter()
            ckpt_restore_train_state(path)
            runs.append(time.perf_counter() - t0)
        times[kind] = statistics.median(runs)
    out.update(train_s=wall, train_launches=launches, orbax_restore_s=times["orbax"],
               msgpack_restore_s=times["msgpack"], orbax_bytes=tree_bytes(best),
               msgpack_bytes=tree_bytes(twin_best))
    log("17", f"(e) cli.train with training.checkpoint_backend=orbax: {wall:.1f} s, launches "
              f"{launches}; models/checkpoint/epoch000.orbax and models/best/best.orbax "
              f"restore bit-equal to the trainer's state")
    log("17", f"(e) restore of the trained checkpoint (params, batch_stats, Adam's state): "
              f".orbax {times['orbax'] * 1e3:.1f} ms ({out['orbax_bytes'] / 1e6:.1f} MB), "
              f"msgpack {times['msgpack'] * 1e3:.1f} ms ({out['msgpack_bytes'] / 1e6:.1f} MB), "
              f"ratio {times['orbax'] / times['msgpack']:.2f} (host clock, median of "
              f"{repeats}) [{CARD}]")

    # cli.predict of both experiments: the .orbax best served, CSVs byte-identical
    csv_dirs = {}
    for suffix in ("_orbax", "_twin"):
        salsa_spatial.launches = noise_floor_mask.launches = 0
        csv_dirs[suffix] = os.path.join(tmp, f"preds{suffix}")
        cli_predict.predict(exp["config"], exp["val_wav_dir"], csv_dirs[suffix], exp["group"],
                            exp_suffix=suffix, device=dev)
        got = {"salsa_spatial": salsa_spatial.launches, "noise_floor": noise_floor_mask.launches}
        k = 1 if cuda else 0  # the val wavs are one group of 2
        if got != {"salsa_spatial": k, "noise_floor": k}:
            raise AssertionError(f"(e) cli.predict{suffix}: launches {got}")
        out[f"predict_launches{suffix}"] = got
    with open(os.path.join(exp_o, "logs", "log.txt")) as f:
        restored = re.findall(r"restored (\S+)", f.read())
    if restored[-1:] != [best]:
        raise AssertionError(f"(e) cli.predict restored {restored[-1:]}, expected {best}")
    differ = differing_files(csv_dirs["_orbax"], csv_dirs["_twin"])
    n_csv = len(os.listdir(csv_dirs["_orbax"]))
    if differ or not n_csv:
        raise AssertionError(f"(e) cli.predict CSVs of .orbax and msgpack differ: {differ}")
    log("17", f"(e) cli.predict served {os.path.basename(best)} with launches "
              f"{out['predict_launches_orbax']}: {n_csv} CSVs byte-identical to the msgpack "
              f"twin experiment's")

    # --resume from .orbax against --resume from the twin, one more epoch each
    resumed = {}
    with deterministic(dev) as nondeterministic:
        for suffix, extra in (("_orbax", ["training.checkpoint_backend=orbax"]), ("_twin", [])):
            resumed[suffix] = counted_train(dev, exp["config"], exp["group"], suffix,
                                            resume=True,
                                            overrides=[*extra, "training.max_epochs=2"])
    (tr_o, l_o, w_o), (tr_t, _, _) = resumed["_orbax"], resumed["_twin"]
    if cuda:
        check_train_launches(l_o, tr_o.optimizer.count - tr.optimizer.count,
                             "(e) cli.train --resume from .orbax")
    ck = tr_o.cfg.dir.model.checkpoint
    diff = payload_diff(read_payload(os.path.join(ck, "epoch001.orbax")),
                        read_payload(os.path.join(tr_t.cfg.dir.model.checkpoint,
                                                  "epoch001.msgpack")))
    steps = (tr_o.optimizer.count, 2 * tr.optimizer.count)
    if tr_o.step_losses != tr_t.step_losses or diff or steps[0] != steps[1]:
        raise AssertionError(f"(e) --resume from .orbax: losses {tr_o.step_losses} against "
                             f"{tr_t.step_losses}, checkpoints differ at {diff[:5]}")
    out.update(resume_losses=tr_o.step_losses, resume_launches=l_o)
    log("17", f"(e) cli.train --resume from epoch000.orbax to 2 epochs ({w_o:.1f} s, launches "
              f"{l_o}): step losses {[round(x, 4) for x in tr_o.step_losses]} and epoch001 "
              f"bit-equal to --resume from the msgpack twin (deterministic mode; ops without a "
              f"deterministic form: {', '.join(nondeterministic) or 'none'})")
    del tr, tr_o, tr_t, resumed

    # the committed fixture (salsa_tpu's orbax, real zstd) through both decoders
    t0 = time.perf_counter()
    fixture = read_payload(GOLDEN_ORBAX + ".orbax")
    fixture_s = time.perf_counter() - t0
    diff = payload_diff(fixture, read_payload(GOLDEN_ORBAX + ".msgpack"))
    if diff:
        raise AssertionError(f"(e) the orbax fixture against its msgpack: {diff[:5]}")
    store = ocdbt.OcdbtStore(GOLDEN_ORBAX + ".orbax")
    frames = [store.read(k) for k in store.keys() if not k.endswith(b"/.zarray")]
    decoded = {}
    for name, fn, passes in (("cpp", zstd.decompress, 20), ("plain", zstd.decompress_plain, 1)):
        t0 = time.perf_counter()
        for _ in range(passes):
            decoded[name] = [bytes(fn(f)) for f in frames]
        decoded[f"{name}_s"] = (time.perf_counter() - t0) / passes
    if decoded["cpp"] != decoded["plain"]:
        raise AssertionError("(e) the C++ and plain zstd decoders differ on the fixture")
    n_bytes = sum(map(len, decoded["cpp"]))
    out.update(fixture_restore_s=fixture_s, decoded_bytes=n_bytes,
               cpp_mb_s=n_bytes / decoded["cpp_s"] / 1e6,
               plain_mb_s=n_bytes / decoded["plain_s"] / 1e6)
    log("17", f"(e) tests/golden/orbax_small (salsa_tpu's orbax, zstd level 1): restored in "
              f"{fixture_s * 1e3:.1f} ms equal to its msgpack; its {len(frames)} chunk frames "
              f"({n_bytes / 1e6:.3f} MB decoded) byte-equal through the C++ decoder "
              f"({out['cpp_mb_s']:.1f} MB/s, mean of 20 passes) and the plain one "
              f"({out['plain_mb_s']:.2f} MB/s, one pass) (host clock) [{CARD}]")

    salsa_spatial.launches = noise_floor_mask.launches = 0
    try:
        cli_train.train(exp["config"], exp["group"], "_zarr", device=dev,
                        overrides=["training.checkpoint_backend=zarr"])
    except ValueError as e:
        if str(e) != "unknown checkpoint backend 'zarr'":
            raise
        log("17", f"(e) training.checkpoint_backend=zarr refused through cli.train before any "
                  f"data: {e}")
    else:
        raise AssertionError("(e) training.checkpoint_backend=zarr was not refused")
    if salsa_spatial.launches or noise_floor_mask.launches:
        raise AssertionError("(e) zarr: kernels launched before the refusal")
    return out


def phase17(dev, seconds: float = 10.0, counts=MANY_MICS, long_mics: int = 32,
            long_seconds: float = 60.0, runs=SCRIPT_RUNS, tb_seconds: float = 12.0,
            tb_overrides=()) -> dict:
    """SALSA at any channel count and the last modules of the port: (a) SALSA MIC at
    17, 24 and 32 mics on a seeded 10 s array clip against the CPU's plain run (K2
    once, K1 never, each call); (b) one 60 s clip at 32 mics, timed, with its peak
    memory and the time of its covariance and of its power iteration; (c) the six
    measurement scripts in this process at small sizes (`run_scripts`); (d)
    TensorBoard scalars of a two-step `cli.train`, or the log line without
    tensorboardX (`tensorboard_check`), and (e) `.orbax` checkpoints trained,
    restored, served and resumed from, and the committed fixture through both
    zstd decoders (`orbax_check`)."""
    cuda = dev.type == "cuda"
    out = {"many": {}}
    t_phase = time.perf_counter()
    for c in counts:
        out["many"][c] = array_salsa(dev, c, seconds, "17", SEED + c)
    wave = mic_array_clip(long_mics, long_seconds, SEED + 100).to(dev)
    ex = make_extractor("salsa", "mic", fs=FS, n_fft=N_FFT, hop_length=HOP, n_mics=long_mics)
    if cuda:
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(dev)
        base = torch.cuda.memory_allocated(dev)
    feats, launches = counted(lambda: ex(wave))
    if cuda:
        peak = (torch.cuda.max_memory_allocated(dev) - base) / 2**30
        ms = cuda_ms(lambda: ex(wave), repeats=3, warmup=0)
    else:
        t0 = time.perf_counter()
        ex(wave)
        peak, ms = float("nan"), (time.perf_counter() - t0) * 1e3
    if feats.shape[1] != 2 * long_mics - 1 or not torch.isfinite(feats).all():
        raise AssertionError(f"(b) {long_mics}-channel SALSA: {tuple(feats.shape)}, finite "
                             f"{bool(torch.isfinite(feats).all())}")
    out["long"] = {"mics": long_mics, "seconds": long_seconds, "ms": ms, "peak_gib": peak,
                   "launches": launches}
    method = "CUDA events, median of 3" if cuda else "host clock"
    log("17", f"(b) SALSA of one {long_seconds:g} s clip at {long_mics} mics "
              f"{tuple(feats.shape)}: {ms:.2f} ms ({method}), peak memory {peak:.2f} GiB "
              f"above the input, launches {launches} [{CARD}]")
    del feats
    if cuda:
        out["long"].update(power_path_split(wave))
        lg = out["long"]
        log("17", f"(b) of which the windowed covariance {lg['covariance_ms']:.2f} ms (peak "
                  f"{lg['covariance_peak_gib']:.2f} GiB) and the power iteration "
                  f"{lg['power_ms']:.2f} ms (peak {lg['power_peak_gib']:.2f} GiB above the "
                  f"covariance) (CUDA events, median of 3) [{CARD}]")
    del wave
    if cuda:
        torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as tmp:
        out["scripts"] = run_scripts(dev, runs, tmp)
        exp = write_train_experiment(os.path.join(tmp, "tb"), tb_seconds,
                                     overrides=(*TB_OVERRIDES, *tb_overrides))
        out["train"] = tensorboard_check(dev, exp)
        out["orbax"] = orbax_check(dev, exp, tmp)
    out["seconds"] = time.perf_counter() - t_phase
    log("17", f"phase 17: {out['seconds']:.1f} s host clock [{CARD}]")
    return out


def power_path_split(wave: torch.Tensor, p: SalsaParams = MIC) -> dict:
    """The two stages of SALSA's power path on `wave`'s DOA band (on the card):
    the windowed covariance and the power iteration on it, each its ms (CUDA
    events, median of 3) and its peak memory above what was allocated before it
    (GiB; the covariance's input, and the covariance for the power iteration)."""
    re, im = stft_planes(wave, n_fft=p.n_fft, hop_length=p.hop_length, win_length=p.win_length)
    n_t = re.shape[-2]
    xr, xi = band_planes(re, im, p)
    x = torch.complex(xr, xi).permute(0, 2, 3, 1)
    del re, im, xr, xi
    out = {}
    for name, fn in (("covariance", lambda: windowed_covariance(x, p.n_hopframes, n_t)),
                     ("power", lambda: principal_eigs_power(r))):
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(wave.device)
        base = torch.cuda.memory_allocated(wave.device)
        got = fn()
        out[f"{name}_peak_gib"] = (torch.cuda.max_memory_allocated(wave.device) - base) / 2**30
        out[f"{name}_ms"] = cuda_ms(fn, repeats=3, warmup=0)
        if name == "covariance":
            r = got
        del got
    return out


def read_event_scalars(tb_dir: str) -> dict[str, list[tuple[int, float]]]:
    """The scalars of the one tensorboardX event file in `tb_dir`, {tag: [(step,
    value), ...]} in the order written: TFRecord frames (length, its CRC, an
    `Event` protobuf, its CRC), read with tensorboardX's own `Event` class."""
    from tensorboardX.proto.event_pb2 import Event

    files = [f for f in os.listdir(tb_dir) if f.startswith("events.out.tfevents")]
    if len(files) != 1:
        raise AssertionError(f"{tb_dir}: {len(files)} event files, not one")
    with open(os.path.join(tb_dir, files[0]), "rb") as f:
        buf = f.read()
    out: dict[str, list[tuple[int, float]]] = {}
    pos = 0
    while pos < len(buf):
        (n,) = struct.unpack_from("<Q", buf, pos)
        event = Event.FromString(buf[pos + 12:pos + 12 + n])
        pos += 12 + n + 4
        for v in event.summary.value:
            out.setdefault(v.tag, []).append((event.step, v.simple_value))
    return out


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
    phase8(dev)
    torch.cuda.empty_cache()
    log("8", f"bench_extract, 64 x 60 s FOA clips [{CARD}]")
    bench_extract.main()
    torch.cuda.empty_cache()
    train = phase9(dev)
    torch.cuda.empty_cache()
    stream = phase10(dev)
    torch.cuda.empty_cache()
    bank = phase11(dev)
    torch.cuda.empty_cache()
    aug = phase12(dev)
    torch.cuda.empty_cache()
    infer = phase13(dev)
    torch.cuda.empty_cache()
    tpu = phase14(dev, fp32={"request_ms": times["request_ms"], "crnn_ms": times["crnn_ms"],
                             "step_ms": aug["step"]["step"], "peak_gib": aug["peak_gib"]})
    torch.cuda.empty_cache()
    store = phase15(dev)
    torch.cuda.empty_cache()
    par = phase16(dev)
    torch.cuda.empty_cache()
    many = phase17(dev)
    # library_ms: one PyTorch call computing the same function, where there is one
    # (cuDNN bf16 for K4, timed in turns with it in phase 7, and f32_library_ms
    # cuDNN f32 for its f32 kernel); none exists for K1-K3. `launches` is
    # phase 4's serving run; K1's and K2's train_* keys are phase 9's cli.train,
    # their stream_* keys phase 10's streaming CLI runs and the block shape at N = 4
    # (stream_block_ms the kernel's device time a launch, stream_block_call_ms a
    # wrapper call's, 10 back to back), salsa_lite_launches phase 11's
    # configs/seld_salsa_lite.yml runs (0), aug_* phase 12's: the augmented
    # cli.train of configs/seld.yml, its resumed call, the augmented
    # configs/seld_salsa_lite.yml run (0), infer_* phase 13's cli.infer of the val
    # split, plain and --tta (reg_xyz), tpu_recipe_* phase 14's configs/seld_tpu.yml
    # runs: its three requests and its cli.train, extract_* phase 15's cli.extract of
    # the store, precompute_* its from_wav_mode precompute setup (the steps launch
    # none) and store_train_* its cli.train from the store (0), parallel_* phase 16's
    # cli.train on one rank over NCCL and each of two ranks on the card (a count a
    # rank, K1 and K2 once a step of its rows), six_channel_* its 6-mic SALSA
    # extraction (K2 only), step_device_timer_ms utils.profiling's K1 time,
    # many_channel_* phase 17's SALSA at 17, 24 and 32 mics (K2 once a call, no K1)
    kernels = [
        {"name": "salsa_spatial", "route": "cuda",
         "source": "salsa_tpu_torch/csrc/salsa_spatial.cu",
         "replaces": "salsa_tpu/features/salsa_pallas.py:138",
         "launches": launches["salsa_spatial"], "max_abs_err": errs["foa"],
         "ms": times["k1"], "plain_ms": times["k1_plain"], "bound_ms": times["k1_bound"][0],
         "bound_by": times["k1_bound"][1], "library_ms": None,
         "train_launches": train["launches"]["salsa_spatial"], "train_step_ms": train["k1_step"],
         "train_step_bound_ms": train["k1_step_bound"][0],
         "train_step_max_abs_err": train["k1_step_err"],
         "stream_launches": stream["launches"]["salsa_spatial"],
         "stream_block_ms": stream["kernels"][4]["k1"],
         "stream_block_call_ms": stream["kernels"][4]["k1_call"],
         "stream_block_bound_ms": stream["kernels"][4]["k1_bound"][0],
         "stream_max_abs_err": stream["k1_err"],
         "salsa_lite_launches": bank["lite_launches"]["salsa_spatial"],
         "aug_train_launches": aug["launches"]["salsa_spatial"],
         "aug_resume_launches": aug["resume_launches"]["salsa_spatial"],
         "aug_salsa_lite_launches": aug["lite"]["launches"]["salsa_spatial"],
         "infer_launches": infer["reg_xyz"]["launches"]["salsa_spatial"],
         "infer_tta_launches": infer["reg_xyz"]["tta_launches"]["salsa_spatial"],
         "tpu_recipe_launches": tpu["requests"]["launches"]["salsa_spatial"],
         "tpu_recipe_train_launches": tpu["train"]["launches"]["salsa_spatial"],
         "extract_launches": store["extract"]["launches"]["salsa_spatial"],
         "extract_max_abs_err": store["extract"]["max_abs_err"],
         "precompute_launches": store["pre_launches"]["salsa_spatial"],
         "store_train_launches": store["train_launches"]["salsa_spatial"],
         "parallel_one_rank_launches": par["one"]["launches"]["salsa_spatial"],
         "parallel_rank_launches": [r["launches"]["salsa_spatial"] for r in par["two"]],
         "six_channel_launches": par["six"]["launches"]["salsa_spatial"],
         "step_device_timer_ms": par["profile"]["k1_ms"],
         "many_channel_launches": [m["launches"]["salsa_spatial"]
                                   for m in many["many"].values()]},
        {"name": "noise_floor", "route": "cuda",
         "source": "salsa_tpu_torch/csrc/noise_floor.cu",
         "replaces": "salsa_tpu/features/salsa.py:82",
         "launches": launches["noise_floor"], "max_abs_err": errs["k2"],
         "ms": times["k2"], "plain_ms": times["k2_plain"], "bound_ms": times["k2_bound"][0],
         "bound_by": times["k2_bound"][1], "library_ms": None,
         "train_launches": train["launches"]["noise_floor"],
         "train_collect_launches": train["launches"]["noise_floor_collect"],
         "train_step_ms": train["k2_step"], "train_step_bound_ms": train["k2_step_bound"][0],
         "collect_states_ms": train["k2_collect"],
         "collect_states_bound_ms": train["k2_collect_bound"][0],
         "stream_launches": stream["launches"]["noise_floor"],
         "stream_block_ms": stream["kernels"][4]["k2"],
         "stream_block_call_ms": stream["kernels"][4]["k2_call"],
         "stream_block_bound_ms": stream["kernels"][4]["k2_bound"][0],
         "salsa_lite_launches": bank["lite_launches"]["noise_floor"],
         "aug_train_launches": aug["launches"]["noise_floor"],
         "aug_train_collect_launches": aug["launches"]["noise_floor_collect"],
         "aug_resume_launches": aug["resume_launches"]["noise_floor"],
         "aug_salsa_lite_launches": aug["lite"]["launches"]["noise_floor"],
         "infer_launches": infer["reg_xyz"]["launches"]["noise_floor"],
         "infer_tta_launches": infer["reg_xyz"]["tta_launches"]["noise_floor"],
         "tpu_recipe_launches": tpu["requests"]["launches"]["noise_floor"],
         "tpu_recipe_train_launches": tpu["train"]["launches"]["noise_floor"],
         "extract_launches": store["extract"]["launches"]["noise_floor"],
         "precompute_launches": store["pre_launches"]["noise_floor"],
         "store_train_launches": store["train_launches"]["noise_floor"],
         "parallel_one_rank_launches": par["one"]["launches"]["noise_floor"],
         "parallel_rank_launches": [r["launches"]["noise_floor"] for r in par["two"]],
         "six_channel_launches": par["six"]["launches"]["noise_floor"],
         "many_channel_launches": [m["launches"]["noise_floor"] for m in many["many"].values()],
         "many_channel_max_abs_err": [m["max_abs_err"] for m in many["many"].values()]},
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
         "bound_by": k4["k4_bound"][1], "library_ms": k4["k4_cudnn"],
         "turns_ms": k4["k4_turns"],
         "f32_ms": k4["k4_f32"], "f32_bound_ms": k4["k4_f32_bound"][0],
         "f32_bound_by": k4["k4_f32_bound"][1], "f32_library_ms": k4["k4_f32_cudnn"],
         "f32_turns_ms": k4["k4_f32_turns"], "f32_ring_slots": k4["k4_f32_ring_slots"],
         "f32_blocks": k4["k4_f32_blocks"]},
    ]
    print(card, flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    if sys.argv[1:2] == ["--rank"]:  # one rank of phase 16, spawned by launch_ranks
        rank_main(sys.argv[2])
    elif sys.argv[1:2] == ["--profile"]:  # a profiled measurement in its own process
        profile_main(sys.argv[2])
    else:
        main()
    sys.exit(0)
