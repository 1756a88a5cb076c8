"""K3: ablation variants of the SALSA spatial stage (counterpart of
`scripts/probe_salsa_kernel.py`) and the probe that times them on the card.

    python -m salsa_tpu_torch.scripts.probe_salsa_kernel [--batch 32] [--iters 5]

Each variant is K1's FOA arithmetic (`features/salsa_spatial.py`) with a part
dropped or reordered, to show where K1's time goes:

  - full       : K1's numerics with `n_sq` squarings (n_sq = 3 is K1)
  - prep_only  : load and store only: the first 3 channels' real part at index t
                 of the padded planes (frame t - n_hop), where the mask is set
  - cov_only   : the windowed covariance only: Re R[0][c+1] where the mask is set
  - no_second  : no runner-up eigenvector (lambda1 = 0)
  - prodslide  : each frame's 10 products computed once, then 7 shifted sums
  - realdiag   : prodslide with the diagonal products kept real (|x_i|^2)

K1 holds every Hermitian matrix with a real diagonal, so prodslide and realdiag
differ from `full` only in how the covariance is formed: they time staging the
products in shared memory against K1's recomputation in registers. Like K1, the
variants take n_hop = 3 alone.

`salsa_spatial_variant` launches `csrc/salsa_spatial_probe.cu` on CUDA tensors
and runs `salsa_spatial_variant_plain` on CPU tensors. The probe prints, at the
JAX probe's shape (B clips x 191 bins x 4801 frames), CUDA-event ms per batch of
every variant and of `full` at n_sq 1, 2 and 4, each with `checksum_rel` against
`full` and the plain version's time; `full` at every block size; production K1;
and a memory floor, a plain read-and-sum of the planes. It raises where a
variant's output misses its plain version's bound (`check_variant`) or where
`full` at some block size is not bit-equal to `full` at 128 threads.
"""
from __future__ import annotations

import argparse

import numpy as np
import torch

from salsa_tpu_torch.features.salsa_spatial import (
    C,
    UPPER,
    Herm,
    _check_inputs,
    _Cplx,
    foa_features,
    salsa_spatial,
    top_eigs,
    window_covariance,
)
from salsa_tpu_torch.kernels.build import check_launch, load_library
from salsa_tpu_torch.scripts.timing import cuda_ms, require_cuda

# index = the variant code of csrc/salsa_spatial_probe.cu
VARIANTS = ("full", "prep_only", "cov_only", "no_second", "prodslide", "realdiag")
SQUARINGS = (1, 2, 3, 4)
BLOCKS = (64, 128, 256, 512)


def _slide_covariance(xr, xi, n_hop, realdiag):
    """The window covariance as a `Herm`, from per-frame products x_i conj(x_j)
    computed once over the padded planes and summed over the 2*n_hop+1 shifts in
    frame order; with `realdiag` the diagonal's products are |x_i|^2 (equal to
    the real part of x_i conj(x_i) in IEEE float32)."""
    n_frames = xr.shape[-1] - 2 * n_hop
    win = 2 * n_hop + 1
    inv_win = np.float32(1.0 / win).item()
    x = [_Cplx(xr[:, c], xi[:, c]) for c in range(C)]

    def window_sum(p):
        acc = p[..., 0:n_frames]
        for k in range(1, win):
            acc = acc + p[..., k:k + n_frames]
        return acc * inv_win

    d = [window_sum(x[i].re * x[i].re + x[i].im * x[i].im if realdiag
                    else (x[i] * x[i].conj()).re) for i in range(C)]
    o = {}
    for i, j in UPPER:
        p = x[i] * x[j].conj()
        o[(i, j)] = _Cplx(window_sum(p.re), window_sum(p.im))
    return Herm(d, o)


def salsa_spatial_variant_plain(xr, xi, sig_mask, *, variant, n_sq, n_hop=3,
                                condition_number=5.0):
    """Plain PyTorch version of the K3 kernel. Planes and mask as
    `salsa_spatial_plain`; returns (B, 3, n_bins, n_frames) float32. For
    variant "full" and n_sq 3 it is `salsa_spatial_plain(..., audio_format="foa")`."""
    n_frames = xr.shape[-1] - 2 * n_hop
    zero = torch.zeros((), dtype=xr.dtype, device=xr.device)
    if variant == "prep_only":
        return torch.where(sig_mask[:, None], xr[:, :C - 1, :, :n_frames], zero)
    if variant in ("prodslide", "realdiag"):
        R = _slide_covariance(xr, xi, n_hop, realdiag=variant == "realdiag")
    else:
        R = window_covariance(xr, xi, n_hop)
    if variant == "cov_only":
        cov = torch.stack([R.o[(0, c)].re for c in range(1, C)], dim=1)
        return torch.where(sig_mask[:, None], cov, zero)
    v, lam0, lam1 = top_eigs(R, n_sq, second=variant != "no_second")
    valid = sig_mask & (lam0 > lam1 * condition_number)
    return torch.where(valid[:, None], foa_features(v), zero)


def salsa_spatial_variant(xr, xi, sig_mask, *, variant, n_sq, n_hop=3,
                          condition_number=5.0, block=128):
    """K3 wrapper. CUDA tensors launch `csrc/salsa_spatial_probe.cu` with `block`
    threads per block (one launch for the whole batch); CPU tensors run
    `salsa_spatial_variant_plain`. Any other device, dtype, shape, layout,
    variant, n_sq or block size raises."""
    if variant not in VARIANTS:
        raise ValueError(f"unknown variant '{variant}', expected one of {VARIANTS}")
    if n_sq not in SQUARINGS:
        raise ValueError(f"n_sq must be one of {SQUARINGS}, got {n_sq}")
    if block not in BLOCKS:
        raise ValueError(f"block must be one of {BLOCKS}, got {block}")
    B, n_bins, n_frames = _check_inputs(xr, xi, sig_mask, n_hop, "foa")
    if xr.device.type == "cpu":
        return salsa_spatial_variant_plain(xr, xi, sig_mask, variant=variant, n_sq=n_sq,
                                           n_hop=n_hop, condition_number=condition_number)
    if xr.device.type != "cuda":
        raise ValueError(f"salsa_spatial_variant runs on cuda or cpu tensors, not {xr.device}")
    if not (xr.is_contiguous() and xi.is_contiguous() and sig_mask.is_contiguous()):
        raise ValueError("salsa_spatial_variant needs contiguous xr, xi and sig_mask")
    lib = load_library()
    out = torch.empty((B, C - 1, n_bins, n_frames), dtype=torch.float32, device=xr.device)
    with torch.cuda.device(xr.device):
        err = lib.salsa_spatial_probe_launch(
            xr.data_ptr(), xi.data_ptr(), sig_mask.data_ptr(), out.data_ptr(), B, n_bins,
            n_frames, n_hop, VARIANTS.index(variant), n_sq, float(condition_number), block,
            torch.cuda.current_stream().cuda_stream)
    check_launch("salsa_spatial_variant", err)
    salsa_spatial_variant.launches += 1
    return out


salsa_spatial_variant.launches = 0


def check_variant(got: torch.Tensor, want: torch.Tensor, variant: str, what: str):
    """Raise unless K3's output `got` agrees with its plain version `want` on the
    same input: `prep_only` bit-equal; `cov_only` within 1e-5 of max|plain|; the
    eigen variants within K1's bound (validity masks disagree on < 0.5 % of
    cells, features within atol/rtol 5e-3 where both are valid). Returns the max
    abs error (over cells valid in both, for the eigen variants) and a line that
    says what was found."""
    if got.shape != want.shape or not torch.isfinite(got).all():
        raise AssertionError(f"{what}: shape {tuple(got.shape)} vs {tuple(want.shape)} "
                             "or non-finite output")
    if variant == "prep_only":
        if not torch.equal(got, want):
            raise AssertionError(f"{what}: not bit-equal to the plain version")
        return 0.0, f"{what}: bit-equal to the plain version"
    if variant == "cov_only":
        err, scale = float((got - want).abs().max()), float(want.abs().max())
        if err > 1e-5 * scale:
            raise AssertionError(f"{what}: max abs err {err} above 1e-5 x max|plain| {scale}")
        return err, f"{what}: max abs err {err:.3e}, {err / max(scale, 1e-30):.3e} of max|plain|"
    m_got, m_want = (got != 0).any(1), (want != 0).any(1)
    disagree = float((m_got != m_want).float().mean())
    both = m_got & m_want
    g, w = got.movedim(1, -1)[both], want.movedim(1, -1)[both]
    err = float((g - w).abs().max()) if both.any() else 0.0
    line = (f"{what}: valid {float(m_want.float().mean()):.4%}, mask disagreement "
            f"{disagree:.4%}, max abs err {err:.3e} on {int(both.sum())} cells")
    if disagree >= 0.005 or not torch.allclose(g, w, atol=5e-3, rtol=5e-3):
        raise AssertionError(f"{line}: outside K1's bound (< 0.5 %, atol/rtol 5e-3)")
    return err, line


def probe_planes(batch: int, device, n_bins: int = 191, n_frames: int = 4801, n_hop: int = 3,
                 seed: int = 0):
    """The JAX probe's input: random normal re/im (batch, bins, frames, 4) and
    mask = normal > 0.2 from numpy's generator `seed`, drawn in its order, then
    wrap-padded by n_hop into (batch, 4, bins, frames + 2*n_hop) planes."""
    rng = np.random.default_rng(seed)
    shape = (batch, n_bins, n_frames, C)
    xre = torch.from_numpy(rng.standard_normal(shape).astype(np.float32)).to(device)
    xim = torch.from_numpy(rng.standard_normal(shape).astype(np.float32)).to(device)
    mask = torch.from_numpy(rng.standard_normal(shape[:3]) > 0.2).to(device)

    def planes(x):
        x = torch.cat([x[:, :, -n_hop:], x, x[:, :, :n_hop]], dim=2)
        return x.permute(0, 3, 1, 2).contiguous()

    return planes(xre), planes(xim), mask


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--batch", type=int, default=32)
    ap.add_argument("--iters", type=int, default=5)
    args = ap.parse_args(argv)
    dev = require_cuda("probe_salsa_kernel")
    xr, xi, mask = probe_planes(args.batch, dev)
    print(f"device: {torch.cuda.get_device_name(dev)}; planes {tuple(xr.shape)}, "
          f"{args.iters} timed runs after 1 warm-up, CUDA events, median", flush=True)

    def timed(fn):
        return cuda_ms(fn, repeats=args.iters, warmup=1)

    # every output is held against its plain version (check_variant) or, for the
    # block sweep, against `full` at 128 threads; any miss raises
    rows = {}
    full = full_sum = None
    for name, variant, n_sq in ([(v, v, 3) for v in VARIANTS]
                                + [(f"sq{q}", "full", q) for q in (1, 2, 4)]):
        kw = dict(variant=variant, n_sq=n_sq)
        ms = timed(lambda: salsa_spatial_variant(xr, xi, mask, **kw))
        got = salsa_spatial_variant(xr, xi, mask, **kw)
        err, line = check_variant(got, salsa_spatial_variant_plain(xr, xi, mask, **kw),
                                  variant, f"{name} vs plain")
        s = float(got.double().sum())
        if name == "full":
            full, full_sum = got, s
        rel = abs(s - full_sum) / (abs(full_sum) + 1e-30)
        plain_ms = cuda_ms(lambda: salsa_spatial_variant_plain(xr, xi, mask, **kw),
                           repeats=2, warmup=1)
        rows[name] = {"ms": ms, "checksum_rel": rel, "plain_ms": plain_ms, "max_abs_err": err}
        print(f"{name:>16}: {ms:8.3f} ms/batch  checksum_rel={rel:.2e}  (plain version "
              f"{plain_ms:.1f} ms)\n{'':>18}{line}", flush=True)

    for block in BLOCKS:
        kw = dict(variant="full", n_sq=3, block=block)
        ms = timed(lambda: salsa_spatial_variant(xr, xi, mask, **kw))
        if not torch.equal(salsa_spatial_variant(xr, xi, mask, **kw), full):
            raise AssertionError(f"full at {block} threads differs from full at 128 threads")
        rows[f"full_block{block}"] = {"ms": ms}
        print(f"{'full block ' + str(block):>16}: {ms:8.3f} ms/batch  (bit-equal to 128 "
              "threads)", flush=True)
    del full

    ms = timed(lambda: salsa_spatial(xr, xi, mask, n_hop=3, audio_format="foa",
                                     condition_number=5.0, lower_bin=1, fs=24000, n_fft=512))
    rows["k1"] = {"ms": ms}
    print(f"{'K1 production':>16}: {ms:8.3f} ms/batch", flush=True)

    ms = timed(lambda: xr.sum() + xi.sum())
    gbps = 2 * xr.numel() * 4 / (ms * 1e-3) / 1e9
    rows["planes_prep"] = {"ms": ms}
    print(f"{'planes_prep':>16}: {ms:8.3f} ms/batch  (read-and-sum of the planes, "
          f"{gbps:.1f} GB/s)", flush=True)
    return rows


if __name__ == "__main__":
    main()
