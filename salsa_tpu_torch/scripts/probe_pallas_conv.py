"""K4: the stage-1 3x3 conv of the CRNN as a hand-written kernel (counterpart of
`scripts/probe_pallas_conv.py`), and the probe that holds it against cuDNN.

    python -m salsa_tpu_torch.scripts.probe_pallas_conv [--batch 32] [--check-only]

`conv3x3_64` is an NHWC 3x3 SAME convolution with 64 output channels, f32
accumulation, output in the input's type: it launches `csrc/conv3x3_64.cu` on
CUDA tensors (bf16 on the tensor cores with wgmma, f32 on the CUDA cores) and
runs `conv3x3_64_plain` on CPU tensors. x and w keep the JAX layouts, NHWC and
HWIO (3, 3, C, 64), in both types; `hwio_from_w_big` carries the JAX kernel's
paired weight matrix (`make_w_big`) back to HWIO. Both kernels are persistent: a
block per SM walks a contiguous range of tiles of consecutive pixels (bf16 64,
f32 128), reading image rows from a ring that a TMA producer fills, with the
weights resident in shared memory. bf16's two consumer warpgroups take two tiles
at a time each from a ring of whole rows; f32's two consumer groups take a tile
each a round from a ring of 16-channel row chunks. `tile_keys` and `ring_rows`
(the tile walk, shared) and `bf16_ring_slots` and `f32_plan` are their plans,
which the wrapper computes and checks and the kernels follow.

The probe runs the JAX probe's shape, the stage-1 geometry of the from-wav
training step (B=32, 320 x 100, C=64, bf16, w * 0.05, seed 0), and prints the
max relative error against the plain version's f32 sum (raising above 5e-3),
then (unless --check-only) ms and effective TF/s of the
kernel, of the plain version (f32 cuDNN with TF32 switched off, as the probe
sets and prints it) and of cuDNN in bf16, and the kernel's speed relative to each.
Each time is a median over CUDA-event timings of K4_CALLS calls back to back.
"""
from __future__ import annotations

import argparse
import functools
from typing import NamedTuple

import numpy as np
import torch
import torch.nn.functional as F

from salsa_tpu_torch.kernels.build import check_launch, load_library
from salsa_tpu_torch.scripts.timing import cuda_ms, require_cuda

N_OUT = 64
# calls back to back between the events of one timing, so the host's launch gap is hidden
K4_CALLS = 10
DTYPES = (torch.float32, torch.bfloat16)

# the bf16 kernel's geometry (csrc/conv3x3_64.cu): tiles of 64 pixels, taken TURN
# at a time by each of CONSUMERS warpgroups; a ring row is one 64-channel chunk of
# W + 2 pixels at 128 B each, aligned to 1024 B
TILE = 64
TURN = 2
CONSUMERS = 2
TMA_BOX = 256  # TMA's largest box side: W + 2 pixels a row
H100_SMEM_BYTES = 232_448  # shared memory a block may take on an H100 (opt-in): the CPU's plan
WEIGHT_BYTES = 9 * N_OUT * 128  # one 64-channel chunk of resident weights

# the f32 kernel's geometry: tiles of F32_TILE pixels, one a consumer group and
# F32_GROUPS a round; a ring slot is one F32_CHUNK-channel chunk of an image row,
# W + 2 pixels from column -1 at 64 B each, rounded up to whole TMA boxes of a
# multiple of 8 pixels (the 64-byte swizzle's 512-byte period), after the
# resident weights of 64 channels
F32_TILE = 128
F32_GROUPS = 2
F32_CHUNK = 16
F32_PIXEL_BYTES = 4 * F32_CHUNK
F32_ALIGN = 512
F32_WEIGHT_BYTES = 9 * 64 * N_OUT * 4


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


def tile_keys(t: int, H: int, W: int, tile: int = TILE) -> tuple[int, int]:
    """The first and last input row that tile t reads, as keys b * (H + 2) + h +
    1 (h = -1..H: the halo rows are keys too). A tile is `tile` consecutive
    pixels of one image, row-major (bf16 TILE, f32 F32_TILE); an image has
    ceil(H W / tile)."""
    per_image = -(-H * W // tile)
    b, q0 = t // per_image, t % per_image * tile
    q1 = min(q0 + tile, H * W) - 1
    return b * (H + 2) + q0 // W, b * (H + 2) + q1 // W + 2


def ring_rows(B: int, H: int, W: int, tiles: int, tile: int = TILE) -> int:
    """The most input rows that `tiles` consecutive tiles read together (bf16:
    the consumers' turns, CONSUMERS x TURN tiles, are the rows the ring holds
    while each consumer works on a turn), in one image or across several. The
    pattern repeats in every image, so the windows that start in the first image
    hold every case; they reach ceil(tiles / tiles an image) images further at
    most."""
    per_image = -(-H * W // tile)
    n = min(B, -(-tiles // per_image) + 1) * per_image
    keys = [tile_keys(t, H, W, tile) for t in range(n)]
    return max(keys[min(t + tiles, n) - 1][1] - keys[t][0] + 1 for t in range(n))


def bf16_smem_bytes(W: int, C: int, slots: int) -> int:
    """The bf16 kernel's dynamic shared memory (`wgmma_smem_bytes` in the source):
    1024 B of alignment slack, the weights, `slots` ring rows of every 64-channel
    chunk with a full and an empty mbarrier each."""
    row = -(-(W + 2) * 128 // 1024) * 1024
    return 1024 + WEIGHT_BYTES + slots * (-(-C // 64) * row + 16)


@functools.lru_cache(maxsize=64)
def bf16_ring_slots(B: int, H: int, W: int, C: int, smem_bytes: int = H100_SMEM_BYTES) -> int:
    """The ring depth the bf16 kernel runs with, for a block that may take
    `smem_bytes` of shared memory: the block is alone on its SM, so the ring
    takes all that the weights leave. Raises ValueError where a row is wider than
    TMA's box, or where the ring holds fewer rows than the consumers' turns read
    plus one in flight (the kernel would deadlock or lose its overlap). Cached:
    the wrapper asks at every call, and the plan is the same for a shape."""
    if W + 2 > TMA_BOX:
        raise ValueError(f"conv3x3_64 bf16: a row of W + 2 = {W + 2} pixels is wider than "
                         f"TMA's box of {TMA_BOX}")
    need = ring_rows(B, H, W, CONSUMERS * TURN) + 1
    slots = (smem_bytes - bf16_smem_bytes(W, C, 0)) // (bf16_smem_bytes(W, C, 1)
                                                        - bf16_smem_bytes(W, C, 0))
    if slots < need:
        raise ValueError(f"conv3x3_64 bf16: a ring of {need} rows of W = {W}, C = {C} needs "
                         f"{bf16_smem_bytes(W, C, need)} B of shared memory, over the "
                         f"{smem_bytes} B a block may take")
    return slots


def f32_row_boxes(W: int) -> tuple[int, int]:
    """(boxes, pixels a box) of one f32 ring row: W + 2 pixels from column -1 in
    as few TMA boxes as TMA_BOX allows, each a multiple of 8 pixels, so that
    every box starts on the swizzle's period (the last may reach past column W:
    TMA fills zeros)."""
    boxes = -(-(W + 2) // TMA_BOX)
    return boxes, (-(-(W + 2) // boxes) + 7) // 8 * 8


def f32_smem_bytes(W: int, slots: int) -> int:
    """The f32 kernel's dynamic shared memory (`f32_smem_bytes` in the source):
    F32_ALIGN B of alignment slack, `slots` ring rows with a full and an empty
    mbarrier each, the resident weights and their mbarrier."""
    boxes, box_px = f32_row_boxes(W)
    return F32_ALIGN + slots * (boxes * box_px * F32_PIXEL_BYTES + 16) + F32_WEIGHT_BYTES + 8


class F32Plan(NamedTuple):
    """What the f32 kernel runs with (besides its grid, min(tiles, SMs))."""
    tiles: int       # B ceil(H W / F32_TILE); an image's last is ragged where H W % F32_TILE
    box_px: int      # pixels a TMA box of a ring row
    boxes: int       # boxes a ring row
    slots: int       # ring entries: as many as the shared memory beside the weights holds
    smem_bytes: int  # the block's dynamic shared memory


@functools.lru_cache(maxsize=64)
def f32_plan(B: int, H: int, W: int, C: int, smem_bytes: int = H100_SMEM_BYTES) -> F32Plan:
    """The plan the f32 kernel runs with, for a block that may take `smem_bytes`
    of shared memory: the block is alone on its SM, so the ring takes all that the
    weights leave. A round's chunk needs the rows of its tiles in the ring at
    once: two tiles where they fit, else one (the kernel decides by the same
    rule). Raises ValueError where the ring holds fewer rows than one tile reads.
    The plan does not depend on C: 64 channels of weights are resident, C > 64
    refills them. Cached: the wrapper asks at every call."""
    boxes, box_px = f32_row_boxes(W)
    need = ring_rows(B, H, W, 1, F32_TILE)
    slots = (smem_bytes - f32_smem_bytes(W, 0)) // (f32_smem_bytes(W, 1) - f32_smem_bytes(W, 0))
    if slots < need:
        raise ValueError(f"conv3x3_64 f32: a tile of x {(B, H, W, C)} reads {need} ring rows of "
                         f"{boxes * box_px * F32_PIXEL_BYTES} B, which with the weights need "
                         f"{f32_smem_bytes(W, need)} B of shared memory, over the {smem_bytes} "
                         "B a block may take")
    return F32Plan(B * -(-H * W // F32_TILE), box_px, boxes, slots, f32_smem_bytes(W, slots))


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


@functools.lru_cache(maxsize=None)
def _device_limits(index: int) -> tuple[int, int]:
    """(SMs, shared memory a block may take) of card `index`."""
    props = torch.cuda.get_device_properties(index)
    return props.multi_processor_count, props.shared_memory_per_block_optin


def conv3x3_64(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """K4 wrapper: NHWC x (B, H, W, C), HWIO w (3, 3, C, 64) in one dtype (f32 or
    bf16) -> (B, H, W, 64) in that dtype. CUDA tensors launch
    `csrc/conv3x3_64.cu`, a persistent block per SM; neither kernel takes a
    parameter. bf16 needs 16-byte-aligned x and w, W + 2 <= 256 and a ring that
    fits the card's shared memory (bf16_ring_slots); f32 a ring that holds a
    tile's rows (f32_plan), and takes any x (the kernel loads an x that TMA
    cannot take, C % 4 != 0 or off 16 bytes, element by element) and a w off 16
    bytes as a copy (its bulk copies need the alignment). CPU tensors run
    `conv3x3_64_plain` after the same checks, against an H100's shared memory.
    Anything else raises."""
    _check(x, w)
    B, H, W, C = x.shape
    on_card = x.device.type == "cuda"
    sms, smem_bytes = _device_limits(x.device.index) if on_card else (None, H100_SMEM_BYTES)
    if x.dtype == torch.bfloat16:
        slots = bf16_ring_slots(B, H, W, C, smem_bytes)
    else:
        plan = f32_plan(B, H, W, C, smem_bytes)
    if not (x.is_contiguous() and w.is_contiguous()):
        raise ValueError("conv3x3_64 needs contiguous x and w")
    if x.dtype == torch.bfloat16 and (x.data_ptr() % 16 or w.data_ptr() % 16):
        raise ValueError("conv3x3_64 bf16 needs x and w at 16-byte-aligned addresses (TMA, "
                         "16-byte weight loads)")
    if x.device.type == "cpu":
        return conv3x3_64_plain(x, w)
    if not on_card:
        raise ValueError(f"conv3x3_64 runs on cuda or cpu tensors, not {x.device}")
    lib = load_library()
    out = torch.empty((B, H, W, N_OUT), dtype=x.dtype, device=x.device)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        if x.dtype == torch.bfloat16:
            blocks = min(B * -(-H * W // TILE), sms)
            err = lib.conv3x3_64_bf16_launch(x.data_ptr(), w.data_ptr(), out.data_ptr(), B, H, W,
                                             C, slots, blocks, stream)
        else:
            if w.data_ptr() % 16:
                w = w.clone()  # a new allocation is aligned
            err = lib.conv3x3_64_f32_launch(x.data_ptr(), w.data_ptr(), out.data_ptr(), B, H, W,
                                            C, plan.slots, plan.box_px, plan.boxes,
                                            min(plan.tiles, sms), stream)
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
    ap.add_argument("--check-only", action="store_true",
                    help="check the kernel against the plain version and time nothing")
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
    print(f"device: {torch.cuda.get_device_name(dev)}; x {tuple(x.shape)} {dt}; "
          f"matmul.allow_tf32={torch.backends.cuda.matmul.allow_tf32} "
          f"cudnn.allow_tf32={torch.backends.cudnn.allow_tf32}", flush=True)

    # one bf16 rounding of the f32 sum: <= 2^-8 of max|plain|
    err = rel_err(conv3x3_64(x, w), conv3x3_64_plain(x.float(), w.float()))
    print(f"max rel err vs plain conv (its f32 sum): {err:.2e}", flush=True)
    if not err <= 5e-3:
        raise AssertionError(f"conv3x3_64: max rel err {err} against the plain f32 sum above 5e-3")
    if args.check_only:
        return {"max_rel_err": err}

    # cuDNN in the input's type, on channels-last views (no layout copies)
    w_cl = w.permute(3, 2, 0, 1).contiguous(memory_format=torch.channels_last)
    x_cl = x.permute(0, 3, 1, 2)

    def timed(fn):
        return cuda_ms(fn, repeats=args.iters, warmup=3, calls=K4_CALLS)

    t = {"kernel": timed(lambda: conv3x3_64(x, w)),
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
