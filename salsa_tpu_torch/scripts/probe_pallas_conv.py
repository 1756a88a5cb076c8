"""K4: the stage-1 3x3 conv of the CRNN as a hand-written kernel (counterpart of
`scripts/probe_pallas_conv.py`), and the probe that holds it against cuDNN.

    python -m salsa_tpu_torch.scripts.probe_pallas_conv [--batch 32] [--bh 8]

`conv3x3_64` is an NHWC 3x3 SAME convolution with 64 output channels, f32
accumulation, output in the input's type: it launches `csrc/conv3x3_64.cu` on
CUDA tensors (bf16 on the tensor cores, f32 on the CUDA cores) and runs
`conv3x3_64_plain` on CPU tensors. x and w keep the JAX layouts, NHWC and HWIO
(3, 3, C, 64), in both types; `hwio_from_w_big` carries the JAX kernel's paired
weight matrix (`make_w_big`) back to HWIO.

The probe runs the JAX probe's shape, the stage-1 geometry of the from-wav
training step (B=32, 320 x 100, C=64, bf16, w * 0.05, seed 0), and prints the
max relative error against the plain version's f32 sum (raising above 5e-3),
then ms and effective TF/s of the
kernel, of the plain version (f32 cuDNN with TF32 switched off, as the probe
sets and prints it) and of cuDNN in bf16, and the kernel's speed relative to each.
Each time is a median over CUDA-event timings of K4_CALLS calls back to back.
"""
from __future__ import annotations

import argparse

import numpy as np
import torch
import torch.nn.functional as F

from salsa_tpu_torch.kernels.build import check_launch, load_library
from salsa_tpu_torch.scripts.timing import cuda_ms, require_cuda

N_OUT = 64
ROWS = (1, 2, 4, 8)
# calls back to back between the events of one timing, so the host's launch gap is hidden
K4_CALLS = 10
DTYPES = (torch.float32, torch.bfloat16)


def _pack_w_big(w: np.ndarray) -> np.ndarray:
    """The JAX probe's `make_w_big` in numpy: (3, 3, C, 64) -> (12C, 128)."""
    C = w.shape[2]
    blocks = []
    for dh in range(3):
        c = np.zeros((2 * C, 128), w.dtype)
        c[:C, :64], c[:C, 64:], c[C:, :64], c[C:, 64:] = w[dh, 1], w[dh, 0], w[dh, 2], w[dh, 1]
        blocks.append(c)
    for dh in range(3):
        n = np.zeros((2 * C, 128), w.dtype)
        n[:C, 64:], n[C:, :64] = w[dh, 2], w[dh, 0]
        blocks.append(n)
    return np.concatenate(blocks, axis=0)


def hwio_from_w_big(w_big) -> np.ndarray:
    """Inverse of the JAX probe's `make_w_big`: the paired (12C, 128) weight
    matrix -> HWIO (3, 3, C, 64), numpy in and numpy out. Raises if `w_big` is
    not such a matrix (its repeated blocks disagree or its structural zeros are
    not zero)."""
    w_big = np.asarray(w_big)
    if w_big.ndim != 2 or w_big.shape[1] != 2 * N_OUT or w_big.shape[0] % 12:
        raise ValueError(f"w_big must be (12*C, 128), got {w_big.shape}")
    C = w_big.shape[0] // 12
    w = np.empty((3, 3, C, N_OUT), w_big.dtype)
    for dh in range(3):
        center = w_big[2 * C * dh:2 * C * (dh + 1)]
        w[dh, 0], w[dh, 1], w[dh, 2] = center[:C, 64:], center[:C, :64], center[C:, :64]
    if not np.array_equal(_pack_w_big(w), w_big):
        raise ValueError("w_big is not a paired weight matrix of make_w_big")
    return w


def conv3x3_64_plain(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of K4: `F.conv2d` in float32 on the NCHW/OIHW views
    of NHWC x and HWIO w, padding 1, cast back to x's type. (B, H, W, 64)."""
    out = F.conv2d(x.float().permute(0, 3, 1, 2), w.float().permute(3, 2, 0, 1), padding=1)
    return out.permute(0, 2, 3, 1).contiguous().to(x.dtype)


def _check(x, w):
    if x.dim() != 4 or x.shape[0] < 1 or min(x.shape[1:]) < 1:
        raise ValueError(f"x must be a non-empty NHWC (B, H, W, C) tensor, got {tuple(x.shape)}")
    if tuple(w.shape) != (3, 3, x.shape[3], N_OUT):
        raise ValueError(f"w must be HWIO {(3, 3, x.shape[3], N_OUT)}, got {tuple(w.shape)}")
    if x.dtype not in DTYPES or w.dtype != x.dtype:
        raise TypeError(f"x and w must share one dtype of {DTYPES}, got {x.dtype} and {w.dtype}")
    if x.device != w.device:
        raise ValueError("x and w must be on one device")


def conv3x3_64(x: torch.Tensor, w: torch.Tensor, *, rows_per_block: int = 8) -> torch.Tensor:
    """K4 wrapper: NHWC x (B, H, W, C), HWIO w (3, 3, C, 64) in one dtype (f32 or
    bf16) -> (B, H, W, 64) in that dtype. CUDA tensors launch
    `csrc/conv3x3_64.cu`, a block per `rows_per_block` output rows x 32 columns;
    CPU tensors run `conv3x3_64_plain`. Anything else raises."""
    _check(x, w)
    if rows_per_block not in ROWS:
        raise ValueError(f"rows_per_block must be one of {ROWS}, got {rows_per_block}")
    if x.device.type == "cpu":
        return conv3x3_64_plain(x, w)
    if x.device.type != "cuda":
        raise ValueError(f"conv3x3_64 runs on cuda or cpu tensors, not {x.device}")
    if not (x.is_contiguous() and w.is_contiguous()):
        raise ValueError("conv3x3_64 needs contiguous x and w")
    B, H, W, C = x.shape
    lib = load_library()
    out = torch.empty((B, H, W, N_OUT), dtype=x.dtype, device=x.device)
    with torch.cuda.device(x.device):
        err = lib.conv3x3_64_launch(x.data_ptr(), w.data_ptr(), out.data_ptr(), B, H, W, C,
                                    int(x.dtype == torch.bfloat16), rows_per_block,
                                    torch.cuda.current_stream().cuda_stream)
    check_launch("conv3x3_64", err)
    conv3x3_64.launches += 1
    return out


conv3x3_64.launches = 0


def rel_err(got: torch.Tensor, want: torch.Tensor) -> float:
    """max|got - want| / max|want|, in float32."""
    got, want = got.float(), want.float()
    return float((got - want).abs().max() / want.abs().max().clamp_min(1e-6))


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--batch", type=int, default=32)
    ap.add_argument("--bh", type=int, default=8, choices=ROWS, help="rows per block")
    ap.add_argument("--iters", type=int, default=20)
    args = ap.parse_args(argv)
    dev = require_cuda("probe_pallas_conv")
    # the plain version is the f32 conv itself, not cuDNN's TF32 one
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    rng = np.random.default_rng(0)
    B, H, W, C = args.batch, 320, 100, 64
    dt = torch.bfloat16
    x = torch.from_numpy(rng.standard_normal((B, H, W, C)).astype(np.float32)).to(dev, dt)
    w = torch.from_numpy(rng.standard_normal((3, 3, C, N_OUT)).astype(np.float32) * 0.05
                         ).to(dev, dt)
    print(f"device: {torch.cuda.get_device_name(dev)}; x {tuple(x.shape)} {dt}, rows per "
          f"block {args.bh}; matmul.allow_tf32={torch.backends.cuda.matmul.allow_tf32} "
          f"cudnn.allow_tf32={torch.backends.cudnn.allow_tf32}", flush=True)

    # one bf16 rounding of the f32 sum: <= 2^-8 of max|plain|
    err = rel_err(conv3x3_64(x, w, rows_per_block=args.bh),
                  conv3x3_64_plain(x.float(), w.float()))
    print(f"max rel err vs plain conv (its f32 sum): {err:.2e}", flush=True)
    if not err <= 5e-3:
        raise AssertionError(f"conv3x3_64: max rel err {err} against the plain f32 sum above 5e-3")

    # cuDNN in the input's type, on channels-last views (no layout copies)
    w_cl = w.permute(3, 2, 0, 1).contiguous(memory_format=torch.channels_last)
    x_cl = x.permute(0, 3, 1, 2)

    def timed(fn):
        return cuda_ms(fn, repeats=args.iters, warmup=3, calls=K4_CALLS)

    t = {"kernel": timed(lambda: conv3x3_64(x, w, rows_per_block=args.bh)),
         "plain": timed(lambda: conv3x3_64_plain(x, w)),
         "cudnn_bf16": timed(lambda: F.conv2d(x_cl, w_cl, padding=1))}
    flops = 2 * B * H * W * 9 * C * N_OUT
    for name, label in (("kernel", "conv3x3_64 kernel"),
                        ("plain", "plain (f32 cuDNN, no TF32)"), ("cudnn_bf16", "cuDNN bf16")):
        print(f"{label:>26}: {t[name]:8.3f} ms  ({flops / (t[name] * 1e-3) / 1e12:6.1f} "
              "TF/s effective)", flush=True)
    print(f"kernel speed vs plain: {t['plain'] / t['kernel']:.3f}x, vs cuDNN bf16: "
          f"{t['cudnn_bf16'] / t['kernel']:.3f}x", flush=True)
    return {"max_rel_err": err, **{f"{k}_ms": v for k, v in t.items()}}


if __name__ == "__main__":
    main()
