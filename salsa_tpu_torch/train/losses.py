"""SELD training losses (counterpart of `salsa_tpu.train.losses`), as functions of
torch tensors.

reg_xyz: loss = w_sed * BCE(event logits) + w_doa * (MAE_x + MAE_y + MAE_z), where
each axis MAE is masked by SED activity and normalized by the number of active
(frame, class) cells. accdoa: masked MSE on the DOA vector, plus, with
silent_weight > 0, the reference's silent-region norm penalty. tracks (EINV2):
the frame-level permutation-invariant loss `tpit_loss`.

Across ranks every loss keeps `salsa_tpu`'s global denominators (the mask mass,
the cell count, the weighted rows of the whole batch): with `global_sum` (the
trainer passes `parallel.distributed.all_reduce_sum`) each denominator is summed
over the ranks, so a rank's loss is its own numerator over the global
denominator, the ranks' losses add up to the global loss and their gradients to
its gradient. Each rank's mean over its own mask mass, averaged, would not be
the global masked mean wherever the ranks' masses differ.
"""
from __future__ import annotations

import itertools
from typing import Callable

import torch

GlobalSum = Callable[[torch.Tensor], torch.Tensor] | None


def _count(n: int, like: torch.Tensor, global_sum: GlobalSum) -> torch.Tensor:
    """The count `n` as a tensor beside `like`, summed over the ranks."""
    t = torch.full((), float(n), dtype=like.dtype, device=like.device)
    return t if global_sum is None else global_sum(t)


def bce_with_logits(logits: torch.Tensor, targets: torch.Tensor,
                    row_weights: torch.Tensor | None = None,
                    global_sum: GlobalSum = None) -> torch.Tensor:
    """Mean binary cross entropy with logits. With row_weights (leading-dim
    weights, e.g. a 0/1 mask over padded batch rows), the mean runs over weighted
    rows only. With `global_sum` the denominator is summed over the ranks."""
    loss = (torch.clamp(logits, min=0.0) - logits * targets
            + torch.log1p(torch.exp(-torch.abs(logits))))
    if row_weights is None:
        if global_sum is None:
            return loss.mean()
        return loss.sum() / _count(loss.numel(), loss, global_sum)
    w = row_weights.reshape((-1,) + (1,) * (loss.dim() - 1))
    per_row = loss.numel() // loss.shape[0]
    mass = row_weights.sum() * per_row
    if global_sum is not None:
        mass = global_sum(mass)
    return (loss * w).sum() / torch.clamp(mass, min=1e-8)


def masked_reg_loss(pred, target, mask, loss_type: str = "MAE", global_sum: GlobalSum = None):
    """Masked mean regression loss normalized by the mask mass (summed over the
    ranks with `global_sum`)."""
    n = min(pred.shape[1], target.shape[1])
    pred, target, mask = pred[:, :n], target[:, :n], mask[:, :n]
    mass = mask.sum()
    denom = torch.clamp(mass if global_sum is None else global_sum(mass), min=1e-8)
    if loss_type == "MAE":
        return (torch.abs(pred - target) * mask).sum() / denom
    if loss_type == "MSE":
        return ((pred - target) ** 2 * mask).sum() / denom
    raise ValueError(f"unknown reg loss '{loss_type}'")


def seld_loss(pred: dict, target: dict, n_classes: int, loss_weight=(0.3, 0.7),
              global_sum: GlobalSum = None):
    """reg_xyz loss. Returns (total, sed_loss, doa_loss)."""
    sed_l = bce_with_logits(pred["event_frame_logit"], target["event_frame_gt"],
                            global_sum=global_sum)
    doa_pred, doa_gt = pred["doa_frame_output"], target["doa_frame_gt"]
    mask = target["event_frame_gt"]
    doa_l = sum(
        masked_reg_loss(doa_pred[:, :, i * n_classes:(i + 1) * n_classes],
                        doa_gt[:, :, i * n_classes:(i + 1) * n_classes], mask,
                        global_sum=global_sum)
        for i in range(3)
    )
    total = loss_weight[0] * sed_l + loss_weight[1] * doa_l
    return total, sed_l, doa_l


def accdoa_mse(doa_pred, doa_gt, sed_mask, n_classes: int, n_cells):
    """Masked xyz MSE shared by the accdoa training and validation losses: the sum
    over active (frame, class) cells of |pred - gt|^2, over n_cells (a number, or
    a tensor already summed over the ranks)."""
    sq = (doa_pred - doa_gt) ** 2
    xyz = sq[..., :n_classes] + sq[..., n_classes:2 * n_classes] + sq[..., 2 * n_classes:]
    n_cells = torch.as_tensor(n_cells, dtype=xyz.dtype, device=xyz.device)
    return (xyz * sed_mask).sum() / torch.clamp(n_cells, min=1)


def accdoa_loss(pred: dict, target: dict, n_classes: int, silent_weight: float = 0.0,
                global_sum: GlobalSum = None):
    """ACCDOA loss. Returns (total, sed_loss, doa_loss). silent_weight=0 is the
    reference's effective recipe (it computes the silent-region penalty and zeroes
    it); silent_weight > 0 adds that penalty, same formula. With `global_sum` the
    cell count is the global batch's."""
    sed_gt = target["event_frame_gt"]
    n_cells = sed_gt.shape[0] * sed_gt.shape[1]
    if global_sum is not None:
        n_cells = _count(n_cells, sed_gt, global_sum)
    doa_pred, doa_gt = pred["doa_frame_output"], target["doa_frame_gt"]
    doa_l = accdoa_mse(doa_pred, doa_gt, sed_gt, n_classes, n_cells)
    if silent_weight > 0.0:
        sq = (doa_pred - doa_gt) ** 2
        x, y, z = sq[..., :n_classes], sq[..., n_classes:2 * n_classes], sq[..., 2 * n_classes:]
        # the reference's formula verbatim: "sed" = sqrt of the squared per-axis MSEs
        sed_hat = torch.sqrt(x**2 + y**2 + z**2 + 1e-12)
        sed_l = ((sed_hat - sed_gt) ** 2 * (1.0 - sed_gt)).sum() / n_cells
    else:
        sed_l = torch.zeros_like(doa_l)
    total = doa_l + silent_weight * sed_l
    return total, sed_l, doa_l


def tpit_loss(event_logit: torch.Tensor, doa_pred: torch.Tensor, sed_gt: torch.Tensor,
              doa_gt: torch.Tensor, loss_weight=(0.5, 0.5),
              row_weights: torch.Tensor | None = None, global_sum: GlobalSum = None):
    """EINV2's frame-level permutation-invariant (tPIT) loss over K tracks.
    event_logit and sed_gt (B, T, K, C), doa_pred and doa_gt (B, T, K, 3); the
    prediction frames are trimmed to the targets'. For each frame and each of the
    K! permutations p of the target tracks:

        L(p) = w_sed * mean_{k,c} BCE(logit[k, c], sed[p(k), c])
             + w_doa * mean_{k,xyz} active[p(k)] * (doa[k] - doa_gt[p(k)])^2,

    where a target track is active where any class is; the loss is the mean over
    frames of min_p L(p), its gradient that of the least permutation (the first
    of `itertools.permutations` on a tie). With `row_weights` (B,) the mean runs
    over the weighted rows' frames; with `global_sum` its denominator is summed
    over the ranks. Returns (total, sed_loss, doa_loss), the last two the terms of
    each frame's least permutation."""
    n = min(event_logit.shape[1], sed_gt.shape[1])
    logit, doa_pred = event_logit[:, :n], doa_pred[:, :n]
    sed_gt, doa_gt = sed_gt[:, :n], doa_gt[:, :n]
    active = sed_gt.amax(dim=-1)  # (B, T, K)
    sed_terms, doa_terms = [], []
    for perm in itertools.permutations(range(logit.shape[2])):
        p = list(perm)
        tgt = sed_gt[:, :, p]
        bce = (torch.clamp(logit, min=0.0) - logit * tgt
               + torch.log1p(torch.exp(-torch.abs(logit))))
        sed_terms.append(bce.mean(dim=(2, 3)))
        sq = ((doa_pred - doa_gt[:, :, p]) ** 2).mean(dim=-1)
        doa_terms.append((sq * active[:, :, p]).mean(dim=-1))
    sed_p, doa_p = torch.stack(sed_terms, dim=-1), torch.stack(doa_terms, dim=-1)  # (B, T, K!)
    best = (loss_weight[0] * sed_p + loss_weight[1] * doa_p).argmin(dim=-1, keepdim=True)
    sed_f, doa_f = sed_p.gather(-1, best)[..., 0], doa_p.gather(-1, best)[..., 0]  # (B, T)
    if row_weights is None:
        w = torch.ones((), dtype=sed_f.dtype, device=sed_f.device)
        mass = _count(sed_f.numel(), sed_f, global_sum)
    else:
        w = row_weights.to(sed_f.dtype)[:, None]
        mass = row_weights.sum() * n
        if global_sum is not None:
            mass = global_sum(mass)
    mass = torch.clamp(mass, min=1e-8)
    sed_l, doa_l = (sed_f * w).sum() / mass, (doa_f * w).sum() / mass
    return loss_weight[0] * sed_l + loss_weight[1] * doa_l, sed_l, doa_l
